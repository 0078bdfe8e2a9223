#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line with its seconds:

0. device and build: the card's name and power limit from ``nvidia-smi``,
   the matmul precision flags (TF32 and reduced-precision bf16 reductions
   off, stated in the line), the kernels compiled with ``nvcc`` from this
   checkout's sources (registers and spills, ptxas's performance
   advisories; the tensor-core instructions
   of each bf16 LM kernel in its SASS, which must not be 0), and the rate
   of a 4 GiB device-to-device copy;
1. every kernel (``composite``, ``grad_mag``, ``flash_attention``,
   ``ssd_scan``; the backwards ``flash_attention_bwd`` and
   ``ssd_scan_bwd``) against its plain PyTorch version on the card, at the main
   path's shapes and at ragged ones, with the tolerance stated (and, for
   attention and the SSD, a relative L2 limit as well); the main path's
   cases, and every attention and SSD case (among them one dbrx-132b
   attention layer, seamless-m4t-large-v2's encoder, decoder and
   cross-attention layers and a decode step's cross-attention, one
   internvl2-1b, one gemma-7b, one qwen1.5-4b and one qwen2-72b layer,
   qwen72_train's layer, one maverick_rank_train rank's heads and one
   jamba-v0.1-52b mamba sublayer; a decode step's cross-attention also
   split into 8 and 16 shards of its 512 frames, the kernel with its
   log-sum-exp on each and the combine, held against one launch and the
   plain version), are timed with CUDA events (median of 10; the
   prefill_32k attention and SSD layers, median of 3), beside their
   bound and, for bf16 attention where its mask is the kernel's
   (non-causal, or Sq == Sk), PyTorch's ``scaled_dot_product_attention``
   on the same inputs (no single PyTorch call computes the SSD); then
   ``flash_bwd``: the flash backward kernel against ``ref.attention_bwd``
   (dq, dk and dv each within BWD_TOL and BWD_REL_L2), f32 and bf16, at
   the llama_train layer ([2,32,4096,128], Hkv 8, causal), llama's serving
   layer, internvl2-1b's and gemma-7b's layers, seamless's
   cross-attention, qwen72_train's layer (64 query heads on 8), one
   maverick_rank_train rank's heads (5 on 1) and ragged shapes; the timed
   cases beside their bound (10·D operations per visible pair), the plain
   version and the backward of SDPA where its mask is the kernel's (f32:
   its memory-efficient backend); the main case run twice more, dk and dv
   bit-identical and dq's spread between the runs within
   BWD_DQ_RUN_SPREAD; then ``ssd_bwd``: the SSD backward kernel against
   ``ref.ssd_scan_bwd`` (dx, ddt, da, db, dc and dd each within
   SSD_BWD_TOL and SSD_BWD_REL_L2), at the mamba_train layer ([2,4096,80,
   64], N 128, one group of b and c, bf16 and f32), the jamba_train layer
   (N 16, 128 heads), mamba's serving layer, the small shapes in f32 and
   bf16, ragged lengths, b and c per head and a strongly decaying head;
   the timed cases beside their bound and the plain version; the main
   case twice more, all six gradients bit-identical;
2. one full-size composite tile (``DEFAULT``: 4096 px, 4 bands, T = 16)
   through ``apps.composite.composite_tile``, held against ``impl="ref"``;
3. the §V.C campaign: 4 tiles of 1024 px, T = 16, written by
   ``imagery.write_scene_stack`` and composited by ``run_composite_campaign``
   on 4 worker threads over a flaky store; each output must be
   byte-identical to the single-process path;
4. one full-size §V.B segmentation tile ([16, 6144, 6144, 4] f32, a mosaic
   of fields under clouds made on the card) through
   ``apps.segmentation.segment_tile``: its edges held against
   ``impl="ref"``, its labels and GeoJSON against the chain run step by
   step (each step timed), its fields against the ground truth;
5. the §V.B campaign over phase 3's four stacks: ``run_segmentation_campaign``
   on 4 worker threads, byte-identical to the single-process path;
6. one Landsat 8 OLI Level-1 frame at its real size (7800 x 7900 px, 4
   bands of uint16 DN, with nodata borders, made by
   ``apps.calibration.make_raw_scene`` from ``--seed``) through
   ``process_scene`` on the card in 512 px tiles: the stored tiles,
   reassembled, must be bit-identical to the port's CPU calibration of the
   same DN array; the stages' seconds (chunk read and decode, copy in,
   device ops, copy out, tile encode and put) and the peak device memory;
7. the §V.A campaign: 4 scenes of 1024 px (cut from the frame's size: host
   synthesis) on 4 worker threads over a flaky store, byte-identical to
   single-process ``process_scene`` on the card, with failures injected;
8. the serving tier: ``serve.TileFleet`` serves phase 3's first composite
   pyramid under the tile-server example's Zipf spike trace (all requests
   served; hit rate and p50/p99 in the DES's virtual time), and every tile
   of the trace's universe is byte-identical to a direct pyramid read;
9. the six port examples (``repro_torch.examples.global_composite``,
   ``field_segmentation``, ``tile_server``, ``serve_lm``, ``quickstart``,
   ``train_lm``), each in its own process on the card, all at once: exit
   code 0, the marker, and launches of the kernels each runs
   (``composite``; ``grad_mag``; ``composite``; none: ``serve_lm``'s smoke
   configs attend with ``attention_impl="ref"`` and it generates through
   the decode path; ``composite`` and ``grad_mag``; none: ``train_lm``'s
   llama-100m attends with ``attention_impl="ref"``, as the JAX
   example's), read in that phase's line only: they include the examples'
   own cross-checks;
10. llama3-8b prefill at full width and depth (bf16 weights drawn on the
   card from ``--seed``): ``make_prefill`` answers 4 requests of 2048
   tokens; 32 ``flash_attention`` launches; logits held against the same
   model with ``attention_impl="chunked"`` (the plain version); one more
   prefill that holds each layer's kernel output against
   ``ref.attention_chunked`` on that layer's own q, k and v
   (``flash_layers``); a profiler breakdown of one prefill by kernel; for
   the timed prefill and its two repeats, the host's CPU seconds and the
   caching allocator's retries, cudaMalloc and cudaFree calls;
11. llama3-8b generation: ``greedy_generate`` for 4 requests of 64 prompt
   tokens and 32 new ones, twice (the tokens must be identical), and the
   prompt's decode-path logits against ``make_prefill`` on the same prompt
   (tests/test_models.py:115-126's criterion); a profiler breakdown of one
   decode step;
12. mamba2-2.7b prefill at full width and depth, as phase 10: 64
   ``ssd_scan`` launches; logits held against the same model with the SSD's
   chunked plain version (``ssd_impl="chunked"``), and one more prefill
   that holds each layer's kernel output against the plain version on that
   layer's own inputs;
13. mamba2-2.7b generation, as phase 11, with the decode check in f32
   activations: no ``ssd_scan`` launch in decode (the decode path has no
   kernel), 64 in the check's prefill;
14. dbrx-132b prefill at full width, 8 of its 40 layers (16 experts top-4;
   27.31e9 parameters, 54.6 GB bf16), as phase 10: 8 ``flash_attention``
   launches, each layer's kernel held, the logits against the plain run,
   and the share of MoE routing assignments that differ between the two
   runs (``route_flips``: a bf16 near-tie sends a token to another expert),
   and the logits again with the plain run routed as the kernel run was;
   the MoE's steps (route, dispatch, the experts' batched matmuls and
   activation, combine) timed with CUDA events;
15. dbrx-132b generation, as phase 13, the decode check in f32
   activations and an f32 KV cache (with the bf16 cache its rounding alone
   flips routes), at capacity factor E so that its prefill drops nothing,
   one position of a router near-tie allowed (tests/test_models.py:117-124);
16. llama4-maverick prefill at full width, 1 of its 48 layers (128 experts
   top-1 and a shared one; one layer holds 32 GB), as phase 14;
17. llama4-maverick generation, as phase 15 (each decode step reads all
   128 experts of its layer);
18. jamba-v0.1-52b prefill at full width, 16 of its 32 layers (two
   super-blocks: 2 attention and 14 mamba sublayers, an MoE of 16 experts
   top-2 every other sublayer), as phase 14: 2 ``flash_attention`` and 14
   ``ssd_scan`` launches, each layer's kernels held;
19. jamba-v0.1-52b generation, as phase 15;
20. gemma-7b prefill at full width and depth (28 layers, head_dim 256:
   the flash kernel's D = 256 instantiation), as phase 10;
21. gemma-7b generation, as phase 11;
22. seamless-m4t-large-v2 prefill at full width and depth (24 encoder and
   24 decoder layers): 4 requests of 2048 decoder tokens on 512 frames of
   1024 features; 72 ``flash_attention`` launches (the encoder's
   bidirectional attention, the decoder's causal self-attention and its
   cross-attention, 2048 queries on 512 frames), each held, the logits
   against the plain run, as phase 10;
23. seamless-m4t-large-v2 generation, as phase 13 (the check in f32): the
   encoder once and the cross-attention in every decoder layer of every
   step launch the kernel (24 + 96 × 24 launches a run, one query row
   each);
24. internvl2-1b prefill at full width and depth (24 layers, 14 query
   heads on 2): 256 patch embeddings of 1024 features before 1792 tokens,
   24 launches, as phase 10;
25. internvl2-1b generation, as phase 13 (the check in f32), without the
   image prefix, as the JAX package's greedy_generate and its tests;
26. qwen1.5-4b prefill at full width and depth (40 layers, QKV biases, 20
   query heads on 20, a 151,936-row vocabulary), as phase 10;
27. qwen1.5-4b generation, as phase 11;
28. qwen2-72b prefill at full width, 16 of its 80 layers (64 query heads
   on 8, QKV biases, two 152,064-row vocabulary matrices; 33.1 GB), as
   phase 10;
29. qwen2-72b generation, as phase 11;
30. ``llama_32k``: prefill_32k at full width and depth, one of its 32 rows
    (1 request of 32,768 tokens; logits [1, 32768, 128256], 4.2e9 bf16
    values, checked finite 256 positions at a time), as phase 10 but for
    the per-layer hold, which covers the first two and the last two of the
    32 layers (the plain attention takes 0.85 s a layer at this length);
    32 ``flash_attention`` launches at [1,32,32768,128], Hkv 8; no
    generation (the prompt would be fed one token at a time);
31. ``mamba_32k``: mamba2-2.7b as phase 30, every layer held: 64
    ``ssd_scan`` launches at x [1,32768,80,64], N 128;
32. ``llama_train``: llama3-8b at full width, 2 of its 32 layers (f32
    masters and fp32 AdamW moments, 23.8 GB; bf16 activations; remat
    "full"), trained through ``launch.train.run`` on 2 x 4096 tokens a step
    from the token store over ``PrefetchLoader``, 10 steps at lr 3e-4:
    (a) the first step's loss and every gradient against the same step
    with ``attention_impl="chunked"`` (plain attention under autograd), and
    with SDPA in the kernel's place as a yardstick; (b) per step 4
    ``flash_attention`` launches (2 forward + 2 remat recomputes) and 2
    ``flash_attention_bwd``; (c) a falling nll; (d) the last step's
    checkpoint restored bit-identical, then ``--resume`` one step from it;
    (e) step time, tokens/s, peak memory, a profiler breakdown of one step
    and the optimizer's device time;
33. ``mamba_train``: mamba2-2.7b at full width, 32 of its 64 layers
    (1.42e9 parameters, 22.6 GB of f32 masters, gradients and moments;
    bf16 activations; remat "full"), trained through ``launch.train.run``
    on 2 x 4096 tokens a step, 10 steps at lr 3e-4, no checkpoint: (a) the
    first step's loss and every gradient in bf16 against the same step with
    the plain SSD under autograd chunked at 64 as the kernels chunk, within
    TRAIN_LOSS_RTOL and TRAIN_GRAD_REL_L2 where the plain SSD chunked at
    128 agrees with it within those gates at this depth, else within
    SPREAD_MULTIPLE times that spread and, in f32, where the plain versions
    agree, within the gates (the line gives each reading, spread and
    limit); (b) per step 64 ``ssd_scan`` launches (32
    forward + 32 remat recomputes) and 32 ``ssd_scan_bwd``, no flash; (c)
    a falling nll; (d) step time, tokens/s, each step's peak memory and a
    profiler breakdown of one step, with the SSD backward's share;
34. ``jamba_train``: jamba-v0.1-52b at full width, its first 2 layers
    ((mamba, FFN) and (mamba, MoE of 16 experts top-2), 3.73e9 parameters,
    59.7 GB), as phase 33, the MoE's routes held to the plain run's in
    (a): the SSD backward at N 16 and 128 heads, the first MoE training on
    the card;
35-41. the other families of ``TRAIN``, as phase 33 with every kernel of
    the path in (a) replaced by its plain version (attention by
    ``ref.attention_chunked``; the SSD's two chunkings give the spread
    only where the model has mamba layers, elsewhere the gates hold
    directly), the flash launches a step twice the attention calls and
    the backward's once: ``seamless_train`` (full depth; 1024 frames under
    4096 decoder tokens a row, the frontend drawn from ``--seed``, through
    ``run_with_frontend``: 144 + 72 flash launches a step, the full-mask
    cross-attention's backward at 4096 queries on 1024 frames),
    ``gemma_train`` (4 of 28 layers: D = 256 forward and backward),
    ``internvl_train`` (full depth; 256 patch embeddings before 3840
    tokens, the prefix dropped from the loss; 14 query heads on 2),
    ``dbrx_train`` (1 of 40 layers, int8 moments, routes held; the plain
    step's gradients wait on the host), ``jamba_attn_train`` (jamba's first
    super-block as (mamba, FFN), (attention, MoE): period 2, offset 1),
    ``qwen_train`` (16 of 40 layers: the QKV biases' backward) and
    ``qwen72_train`` (1 of 80 layers, int8 moments: 64 query heads on 8 in
    the backward, the QKV biases at d_model 8192, 152,064-row f32
    logits);
42. ``mesh_train``: llama3-8b at full width, 2 layers (int8 moments),
    through ``launch.train``'s mesh path (the tensor-parallel step, each
    model-axis collective over a group of one) on a 1 x 1 NCCL mesh (world size
    1, ``cuda``; the box has one card, and NCCL takes no two ranks on one
    device), driven by ``launch.elastic.ElasticTrainer`` in ranges of 2
    steps over a TaskQueue with a manual clock: trainer A completes
    [0, 2) and dies at step 3, the lease passes, trainer B restores step 2
    through ``restore(shardings=)`` and finishes [2, 4); (a) the first
    step's loss and gradients against the mesh-less step, (b) the restore
    bit-identical, (c) the flash launches per step as in phase 32, (d)
    each range completed once, (e) the step time against the mesh-less
    step's (the DTensor path's cost) and the save and restore seconds,
    (f) one more step's update memory, within ``update_bound``;
43. ``grad_compression``: ``train/grad_compression.py``'s
    ``compressed_psum_mean`` over a 1-rank NCCL group on mesh_train's
    first-step gradients (1.487·10⁹ f32 elements), bit-identical to the
    same arithmetic written out on one rank, the error-feedback
    invariant, its time, wire bytes against an f32 all-reduce's, and its
    rate against the copy's;
44. the rank phases of ``RANK_TRAIN``: rank 0 of a 1 x 8 tensor-parallel
    mesh in one process under torch's fake process group (the collectives
    do no work: the values are not checked), 2 x 4096 tokens, int8
    moments, through ``make_mesh_train_step``: ``tp_rank_train``
    (llama3-8b at full width, 8 layers; 4 query heads on 1 KV head) and
    ``maverick_rank_train`` (llama4-maverick at full width, 1 of 48 layers,
    expert parallel: 16 of the 128 experts; 5 query heads on 1 KV head; a
    vocabulary-parallel loss over 202,048 rows); the step time, each
    step's peak and the update's part of it (within ``update_bound``: the
    int8 moments updated in parts of rows), a profiled step's device time
    by group (an MoE's steps by CUDA events), and the flash launches a
    step at the per-rank shapes;
45. ``mesh_generate`` (run between phases 43 and 44): ``greedy_generate``
    on a ``launch/train.py:MeshModel`` over a 1 x 1 NCCL mesh, its caches
    split by sequence (split-K) and by KV head, and mesh-less on the same
    weights: llama3-8b at full width, 8 layers, bf16, 4 requests of 64
    prompt tokens and 32 new ones; tokens identical, each step's logits
    within PREFILL_REL_L2; each run's step time and a profiled step's idle
    share;
46. ``tp_rank_decode``: rank 0 of a 1 x 8 mesh under the fake process
    group (as phase 44; values not checked) decoding through
    ``make_mesh_decode_step`` on its shards of the bf16 weights and of
    caches split by sequence: llama3-8b at full depth, decode_32k with 32
    rows, and jamba-v0.1-52b at long_500k cut to 8 layers; the step time,
    each step's peak and a profiled step's idle share;
47. ``dryrun_check``: ``python -m repro_torch.launch.dryrun`` (fake
    tensors, the fake process group), each cell its own process, started
    before phase 32 and read here (they use the host, beside the training
    phases, pinned to the upper half of the cores): the cells of
    llama_train, mesh_train, the two rank phases, tp_rank_decode's two and
    the training phases of TRAIN whose cut is a depth (mamba, seamless,
    gemma, internvl, dbrx, qwen and qwen72), their predicted step peaks
    within DRYRUN_PEAK_BAND of the step peaks those phases measured
    (``step_peak_bytes``), predicted flops and roofline step beside the
    measured step; llama3-8b, mamba2-2.7b and jamba-v0.1-52b at train_4k on
    the 16 x 16 mesh, each ``ok``;
48. summary: the ``kernels`` line, the peak device memory, the
    ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.

Each LM is freed before the next is drawn.  The launch counts are set to
0 just before each main-path run (phases 2-7, 10-31, llama_train's run
and resumed step, the runs of phases 33-41, mesh_train's elastic run,
each of mesh_generate's three runs, the rank phases' and tp_rank_decode's
timed steps) and read just after it; the ``kernels`` line adds those
counts.  The training phases' first-step comparisons and profiled steps
verify: their launches stay in their lines.  The decode checks' prefills
(phases 11, 13, 15, 17, 19, 21, 23, 25, 27 and 29) verify: their launches
stay in their phase's line (``prefill_check_launches``).  Each example
process counts its own from 0, and phase 8 runs no device work.

``--only NAME[,NAME...]`` runs the named phases alone after phase 0
(``flash``, ``flash_bwd``, an LM of LM_PHASES by its key, ``llama_train``,
a training phase of TRAIN, ``mesh_train`` or a rank phase of RANK_TRAIN
by its line's name, e.g. ``--only llama_32k,qwen72_train,mesh_train``),
with the dry-run cells of those training phases, and prints no
``kernels`` line and no last line: a check of one path, not the run
above.

Any mismatch raises and the script exits nonzero.  Without CUDA, or run
from a directory that holds nothing else of the repository, it exits
nonzero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
TOL = {"float32": 3e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:45-47
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:122
#: flash attention's output against its plain version, relative L2 over the
#: whole case: in bf16 a few ulps of the output's rounding, in f32 a few
#: hundred f32 ulps.  The elementwise TOL alone is looser than a typical
#: output at long Sk (random scores spread the softmax over ~Sk/e keys)
FLASH_REL_L2 = {"float32": 1e-5, "bfloat16": 5e-3}
EDGE_AGREEMENT = 0.999  # examples/field_segmentation.py:37
MIN_PURITY = 0.8  # examples/field_segmentation.py:67
COPY_BYTES = 4 * 1024 ** 3
#: the TPU kernel each CUDA kernel replaces (its ``*_fwd`` entry point)
REPLACES = {"composite": "src/repro/kernels/composite.py:53",
            "grad_mag": "src/repro/kernels/grad_mag.py:63",
            "flash_attention": "src/repro/kernels/flash_attention.py:93",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:75",
            # no TPU kernel: off the TPU the JAX package differentiates its
            # plain attention (src/repro/kernels/ops.py:47-50) there
            "flash_attention_bwd": "src/repro/train/train_step.py:66",
            # the same for its plain SSD (src/repro/kernels/ops.py:86-102)
            "ssd_scan_bwd": "src/repro/train/train_step.py:66"}
TIMED_RUNS = 10
LLAMA = "llama3-8b"
MAMBA = "mamba2-2.7b"
DBRX = "dbrx-132b"
MAVERICK = "llama4-maverick-400b-a17b"
JAMBA = "jamba-v0.1-52b"
GEMMA = "gemma-7b"
SEAMLESS = "seamless-m4t-large-v2"
INTERNVL = "internvl2-1b"
QWEN = "qwen1.5-4b"
QWEN72 = "qwen2-72b"
PREFILL_BATCH, PREFILL_LEN = 4, 2048
#: SHAPES["prefill_32k"]'s length (configs/base.py:32); one card takes one
#: of its 32 rows
PREFILL_32K_LEN = 32768
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 64, 32
#: the kernel's logits against the plain run's, relative L2 over [4, 2048, V]
PREFILL_REL_L2 = 2e-2
#: the same for mamba2-2.7b's 64 bf16 layers, where the SSD's two plain
#: versions are themselves 5.6e-2 apart (PERF.md §6); its kernel is held
#: layer by layer to SSD_TOL and SSD_REL_L2 instead (ssd_layers)
MAMBA_PREFILL_REL_L2 = 1e-1
#: decode path against prefill: tests/test_models.py:115-126
DECODE_AGREEMENT, DECODE_RTOL, DECODE_ATOL = 0.9, 0.15, 0.3
#: an MoE model's positions whose decode and prefill logits may differ by
#: more than DECODE_ATOL, through a router near-tie
#: (tests/test_models.py:117-124)
MOE_NEAR_TIE_POSITIONS = 1
#: the flash backward's dq, dk and dv against ref.attention_bwd: max-abs
#: error within BWD_TOL times max(1, the largest |value|), and relative L2
#: (tests/test_torch_cuda.py).  bf16 rounds P and dS to bf16 as the
#: products' operands and each output once (2^-8 relative); f32 differs
#: from the plain version in its order of sums and in expf
BWD_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
BWD_REL_L2 = {"float32": 1e-5, "bfloat16": 1e-2}
#: llama_train: llama3-8b at full width cut to LLAMA_TRAIN_LAYERS of 32
#: layers, f32 masters and fp32 AdamW (1.49e9 parameters, 23.8 GB) with
#: remat "full", 2 x 4096 tokens a step (train_4k's length,
#: configs/base.py:31), the corpus' vocabulary as launch/train.py sizes it.
#: It ran 8 layers (44.7 GB) until the phases of the other families came:
#: its checkpoint's save and restore through the chunk store's Python
#: copies (~0.3 GB/s) took 130 s of its 142.5 (at 4 layers 113 of 126),
#: and 2 layers keep the script inside its time.  lr 3e-4,
#: Llama 3 8B's published peak; at 3e-3 the run diverged on the card (nll
#: 12.15 -> 6.59 at step 4, then up to 18.67 at step 9: PERF.md §6), each
#: step moving the 1/sqrt(4096)-scaled weights by a fifth of their spread.
#: TRAIN_LAYERS: llama3-8b's depth on tp_rank_train's rank and in
#: mesh_generate
LLAMA_TRAIN_LAYERS = 2
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 8, 2, 4096
TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP = 10, 3e-4, 5
#: the kernel step's first loss and gradients against the same step with
#: attention_impl="chunked" (plain attention under autograd): loss within
#: TRAIN_LOSS_RTOL relative, each leaf's gradient within TRAIN_GRAD_REL_L2
#: relative L2.  Both runs are bf16 through 2 layers; the kernel rounds P
#: to bf16 in its forward and P and dS in its backward, where the plain
#: version keeps f32, as the serving prefill's 2e-2 logits gate allows at
#: 32 layers (PREFILL_REL_L2).  The same step with PyTorch's SDPA in the
#: kernel's place is reported beside it (``library_vs_plain``)
TRAIN_LOSS_RTOL = 2e-2
TRAIN_GRAD_REL_L2 = 5e-2
#: an MoE or hybrid model's logits against the plain run, relative L2 over
#: [4, 2048, V], routing free.  A bf16 near-tie sends a token to another
#: expert in one run and not the other.  On one H100 (NVIDIA H100 80GB
#: HBM3, 700 W), over --seed 0-3: dbrx 3.45-4.08·10⁻² (0.94-1.26 % of the
#: assignments flipped), maverick 6.64-7.23·10⁻² (0.54-0.65 %), jamba
#: 7.70-7.92·10⁻² (2.37-2.55 %); each an average over 8192 tokens, it
#: moves little from seed to seed (PERF.md §6).  The JAX package's own
#: bf16 forward, compiled and run op by op, is 4.3·10⁻² (dbrx), 4.4·10⁻²
#: (maverick) and 1.1·10⁻¹ (jamba) apart at widths cut 8-fold
#: (tools/moe_spread.py --package jax).  The kernels are held tighter with
#: the plain run routed as the kernel run was (vs_plain_held_routes):
#: PREFILL_REL_L2 (2e-2; jamba MAMBA_PREFILL_REL_L2, its two plain SSD
#: versions being 2.5·10⁻² apart even so, tools/moe_spread.py on the
#: card), and layer by layer (LAYER_HOLDS)
MOE_PREFILL_REL_L2 = 1e-1


def check(ok: bool, what: str) -> None:
    """Raise on a failed check (unlike assert, kept under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(torch, fn, runs: int = TIMED_RUNS, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas_resources(log: str) -> dict:
    """nvcc's ``--resource-usage`` report: each kernel's (mangled) name ->
    its registers and spill lines."""
    out, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif name and ("registers" in line or "spill" in line):
            out.setdefault(name, []).append(
                line.replace("ptxas info    :", "").strip())
    return out


def kernel_label(mangled: str) -> str:
    """``..._flash_attention_kernel_bf16ILi128EEEv...`` ->
    ``flash_attention_kernel_bf16<Li128>``: enough to tell the
    instantiations apart."""
    pos = mangled.find("_ZN") + 3
    while 2 < pos < len(mangled):
        m = re.match(r"\d+", mangled[pos:])
        if not m:
            break
        start = pos + len(m[0])
        pos = start + int(m[0])
        name = mangled[start:pos]
        if "kernel" in name:
            args = re.match(r"I(.*?)EE", mangled[pos:])
            return f"{name}<{args[1]}>" if args else name
    return mangled


def tensor_core_instructions(build, source: str):
    """Each kernel of ``csrc/<source>.cu``'s library -> its count of
    tensor-core instructions (HMMA from ``mma.sync``, HGMMA from ``wgmma``)
    in the SASS, read with the toolkit's ``cuobjdump``; None where the
    toolkit has no ``cuobjdump``."""
    tool = Path(build.find_nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return None
    sass = subprocess.run([str(tool), "-sass", str(build.library_path(source))],
                          check=True, capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = kernel_label(line.split("Function :", 1)[1].strip())
            counts[name] = 0
        elif name and re.search(r"\bHG?MMA\.", line):
            counts[name] += 1
    return counts


def phase_device(torch, build) -> dict:
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    built = build.build()
    resources = {kernel_label(name): lines for info in built.values()
                 for name, lines in ptxas_resources(info["log"]).items()}
    for source, symbol in KERNEL_SYMBOLS.items():
        if source in built:  # the profiler groups every kernel of a source
            names = [n for n, lines in
                     ptxas_resources(built[source]["log"]).items()
                     if any("registers" in line for line in lines)]
            check(bool(names) and all(symbol in n for n in names),
                  f"{source}.cu: a kernel name lacks {symbol!r}: "
                  f"{sorted(names)}")
    # the SSD backward's kernels hold their products' operands and the
    # head tile's db and dc sums in registers: none may spill
    if "ssd_scan_bwd" in built:
        spills = {kernel_label(n): [line for line in lines
                                    if re.search(r"[1-9]\d* bytes spill",
                                                 line)]
                  for n, lines in
                  ptxas_resources(built["ssd_scan_bwd"]["log"]).items()}
        check(not any(spills.values()),
              f"ssd_scan_bwd.cu: kernels spill: "
              f"{ {n: s for n, s in spills.items() if s} }")
    # ptxas's advisories, e.g. wgmma instructions serialized for want of
    # registers (the backward's design note tells how it avoids them)
    advisories = {n: [line.split("Potential Performance Loss:", 1)[1]
                      .strip()[:160]
                      for line in i["log"].splitlines()
                      if "Potential Performance Loss" in line]
                  for n, i in built.items()}
    # every bf16 kernel of the LM sources runs its products on the tensor
    # cores (the SSD's c.b kernel is bf16 only)
    tensor_ops = {s: tensor_core_instructions(build, s)
                  for s in ("flash_attention", "flash_attention_bwd",
                            "ssd_scan", "ssd_scan_bwd")}
    for source, counts in tensor_ops.items():
        # the SSD backward's kernels are templated on the element type; its
        # fixed-order sums of the partials (reduce) have no products
        bf16 = {n: k for n, k in (counts or {}).items()
                if ("bf16" in n or "_cb" in n) or (
                    source == "ssd_scan_bwd" and "bfloat16" in n
                    and "reduce" not in n)}
        check(counts is None or (bool(bf16) and all(bf16.values())),
              f"{source}.cu: a bf16 kernel has no HMMA/HGMMA: {counts}")
    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = median_ms(torch, lambda: dst.copy_(src))
    del src, dst
    torch.cuda.empty_cache()
    copy_rate = 2 * COPY_BYTES / (copy_ms * 1e-3)  # read + write
    return {"phase": "device", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "bf16_reduced_precision_reduction":
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
            "built": {n: round(i["seconds"], 3) for n, i in built.items()},
            "ptxas": resources, "ptxas_advisories": advisories,
            "tensor_core_instructions": tensor_ops,
            "copy_gib": COPY_BYTES / 1024 ** 3,
            "copy_ms": copy_ms, "copy_bytes_per_s": copy_rate,
            "seconds": time.perf_counter() - t0}


# name, [T, H, W, C], images dtype, weights dtype, timed, zero weights,
# misaligned (vector loads off)
COMPOSITE_CASES = [
    ("main_path", (16, 4096, 4096, 4), "float32", "float32", True, False, False),
    ("paper_depth", (64, 4096, 4096, 4), "float32", "float32", True, False, False),
    ("bf16", (16, 4096, 4096, 4), "bfloat16", "bfloat16", True, False, False),
    ("bf16_f32_weights", (5, 64, 96, 4), "bfloat16", "float32", False, False, False),
    ("ragged_c3", (7, 37, 53, 3), "float32", "float32", False, False, False),
    ("thin_c1", (1, 8, 128, 1), "float32", "float32", False, False, False),
    ("c8", (3, 17, 33, 8), "float32", "float32", False, False, False),
    ("misaligned_c4", (4, 16, 24, 4), "float32", "float32", False, False, True),
    ("zero_weights", (3, 8, 8, 2), "float32", "float32", False, True, False),
]




def phase_kernels(torch, seed: int, copy_rate: float) -> dict:
    from repro_torch.kernels import composite as kcomposite
    from repro_torch.kernels import bounds, ref

    t0 = time.perf_counter()
    cases = []
    for i, (name, shape, xd, wd, timed, zero_w, misaligned) in enumerate(
            COMPOSITE_CASES):
        xdt, wdt = getattr(torch, xd), getattr(torch, wd)
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + i)
        T, H, W, C = shape
        if misaligned:  # a contiguous view 4 bytes past an aligned base
            base = torch.rand(T * H * W * C + 1, generator=g, device="cuda",
                              dtype=xdt)
            x = base[1:].view(shape)
            check(x.data_ptr() % 16 != 0, "view should be misaligned")
        else:
            x = torch.rand(shape, generator=g, device="cuda", dtype=xdt)
        w = (torch.zeros((T, H, W), device="cuda", dtype=wdt) if zero_w else
             torch.rand((T, H, W), generator=g, device="cuda", dtype=wdt))
        got = kcomposite.composite(x, w)
        want = ref.composite(x, w)
        torch.cuda.synchronize()
        check(got.shape == want.shape == (H, W, C) and got.dtype == xdt,
              f"{name}: shape or dtype")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        tol = TOL[xd]
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, msg=f"composite {name}")
        del got, want
        case = {"name": name, "shape": list(shape), "images": xd,
                "weights": wd, "max_abs_err": err, "tol": tol}
        if timed:
            nbytes, ops, bound_ms, bound_by = bounds.composite_bound(
                shape, x.element_size(), w.element_size())
            ms = median_ms(torch, lambda: kcomposite.composite(x, w))
            plain_ms = median_ms(torch, lambda: ref.composite(x, w))
            case.update({
                "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "bytes": nbytes, "operations": ops, "bound_ms": bound_ms,
                "bound_by": bound_by,
                "copy_bound_ms": nbytes / copy_rate * 1e3,
                "bytes_per_s": nbytes / (ms * 1e-3)})
        cases.append(case)
        emit({"phase": "kernels.case", **case})
        del x, w
        torch.cuda.empty_cache()
    return {"phase": "kernels", "cases": len(cases),
            "seconds": time.perf_counter() - t0, "results": cases}


# name, [T, H, W, C], images dtype, timed, valid ("random" ~70 % True,
# "none", "one" pixel), misaligned (vector loads off)
GRAD_MAG_CASES = [
    ("main_path", (16, 6144, 6144, 4), "float32", True, "random", False),
    ("bf16", (16, 6144, 6144, 4), "bfloat16", True, "random", False),
    ("ragged_c3", (7, 37, 53, 3), "float32", False, "random", False),
    ("thin_c1", (1, 8, 128, 1), "float32", False, "random", False),
    ("one_row", (3, 1, 40, 2), "float32", False, "random", False),
    ("one_column", (3, 40, 1, 2), "float32", False, "random", False),
    ("c8", (3, 17, 33, 8), "float32", False, "random", False),
    ("misaligned_c4", (4, 16, 24, 4), "float32", False, "random", True),
    ("all_invalid", (3, 8, 8, 2), "float32", False, "none", False),
    ("one_valid_pixel", (3, 8, 8, 4), "float32", False, "one", False),
]




def phase_grad_mag(torch, seed: int, copy_rate: float) -> dict:
    from repro_torch.kernels import grad_mag as kgrad
    from repro_torch.kernels import bounds, ref

    t0 = time.perf_counter()
    cases = []
    for i, (name, shape, xd, timed, valid_mode, misaligned) in enumerate(
            GRAD_MAG_CASES):
        xdt = getattr(torch, xd)
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + 500 + i)
        T, H, W, C = shape
        if misaligned:  # a contiguous view 4 bytes past an aligned base
            base = torch.rand(T * H * W * C + 1, generator=g, device="cuda",
                              dtype=xdt)
            x = base[1:].view(shape)
            check(x.data_ptr() % 16 != 0, "view should be misaligned")
        else:
            x = torch.rand(shape, generator=g, device="cuda", dtype=xdt)
        if valid_mode == "random":
            v = torch.rand((T, H, W), generator=g, device="cuda") < 0.7
        else:
            v = torch.zeros((T, H, W), dtype=torch.bool, device="cuda")
            if valid_mode == "one":
                v[T // 2, H // 2, W // 2] = True
        got_g, got_c = kgrad.grad_mag(x, v)
        want_g, want_c = ref.grad_mag(x, v)
        torch.cuda.synchronize()
        check(got_g.shape == got_c.shape == (H, W)
              and got_g.dtype == got_c.dtype == torch.float32,
              f"grad_mag {name}: shape or dtype")
        check(bool(torch.isfinite(got_g).all()), f"grad_mag {name}: non-finite")
        check(torch.equal(got_c, want_c), f"grad_mag {name}: count not exact")
        tol = GRAD_TOL[xd]
        err = float((got_g - want_g).abs().max())
        torch.testing.assert_close(got_g, want_g, rtol=tol, atol=tol,
                                   msg=f"grad_mag {name}")
        if valid_mode == "none":
            check(float(got_g.abs().max()) == 0.0
                  and float(got_c.abs().max()) == 0.0,
                  f"grad_mag {name}: outputs should be zero")
        if valid_mode == "one":
            sqrt_eps = float(torch.sqrt(torch.tensor(kgrad.EPS)))
            check(float(got_g[H // 2, W // 2]) == sqrt_eps
                  and float(got_g.sum()) == sqrt_eps
                  and float(got_c.sum()) == 1.0,
                  f"grad_mag {name}: want sqrt(eps) at the one pixel")
        del got_g, got_c, want_g, want_c
        case = {"name": name, "shape": list(shape), "images": xd,
                "valid": valid_mode,
                "valid_fraction": float(v.float().mean()),
                "max_abs_err": err, "tol": tol, "count_exact": True}
        if timed:
            nbytes, ops, bound_ms, bound_by = bounds.grad_mag_bound(
                shape, x.element_size())
            ms = median_ms(torch, lambda: kgrad.grad_mag(x, v))
            plain_ms = median_ms(torch, lambda: ref.grad_mag(x, v))
            case.update({
                "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "bytes": nbytes, "operations": ops, "bound_ms": bound_ms,
                "bound_by": bound_by,
                "copy_bound_ms": nbytes / copy_rate * 1e3,
                "bytes_per_s": nbytes / (ms * 1e-3)})
        cases.append(case)
        emit({"phase": "kernels.case", "kernel": "grad_mag", **case})
        del x, v
        torch.cuda.empty_cache()
    return {"phase": "kernels.grad_mag", "cases": len(cases),
            "seconds": time.perf_counter() - t0, "results": cases}


# name, (B, Hq, Hkv, Sq, Sk, D), causal, dtype, timed runs, q and k as
# transposed [B, S, H, D] views (v always is one).  The main path is one
# llama3-8b layer of the llama_prefill phase; the 32k layer is
# SHAPES["prefill_32k"] for one request; the dbrx layer one of dbrx-132b's
# (48 query heads); then tests/test_kernels.py:53-60
# in f32 and bf16, ragged lengths, and bf16 cases across the tensor-core
# kernel's tile edges (128 query rows; 128 keys, 64 at D = 256); last the
# seamless-m4t-large-v2 layers: its encoder (512 frames, full attention),
# decoder self-attention, cross-attention (2048 queries on 512 frames) and
# one decode step's cross-attention (one query row), q, k and v as the
# layers hand them over; one internvl2-1b layer (14 query heads on 2), one
# gemma-7b layer (head_dim 256), one qwen1.5-4b layer (20 query heads on 20)
# and one qwen2-72b layer (64 on 8).
FLASH_CASES = [
    ("main_path", (4, 32, 8, 2048, 2048, 128), True, "bfloat16", TIMED_RUNS,
     False),
    ("prefill_32k_layer", (1, 32, 8, 32768, 32768, 128), True, "bfloat16", 3,
     False),
    ("dbrx_layer", (4, 48, 8, 2048, 2048, 128), True, "bfloat16", TIMED_RUNS,
     False),
    *[(f"{name}_{dt}", shape, causal, dt, TIMED_RUNS, False)
      for dt in ("float32", "bfloat16")
      for name, shape, causal in [
          ("gqa2", (2, 4, 2, 128, 128, 64), True),
          ("mha_d128", (1, 8, 8, 256, 256, 128), True),
          ("gqa4_sk_gt_sq", (1, 4, 1, 128, 384, 64), True),
          ("bidirectional_d32", (2, 2, 2, 128, 128, 32), False),
          ("gemma_d256", (1, 16, 2, 64, 64, 256), True),
          ("ragged_1000", (1, 4, 2, 1000, 1000, 128), True),
          ("one_row_sk777", (3, 5, 5, 1, 777, 64), True),
          ("odd_heads", (3, 7, 7, 129, 129, 64), True)]],
    ("gemma_d256_ragged_1000", (1, 16, 2, 1000, 1000, 256), True, "bfloat16",
     TIMED_RUNS, False),
    ("sq_lt_sk_200_328", (2, 32, 8, 200, 328, 128), True, "bfloat16",
     TIMED_RUNS, False),
    *[(f"qk_transposed_{dt}", (2, 8, 2, 300, 300, 64), True, dt, TIMED_RUNS,
       True) for dt in ("float32", "bfloat16")],
    *[(name, shape, causal, "bfloat16", TIMED_RUNS, True)
      for name, shape, causal in [
          ("seamless_enc", (4, 16, 16, 512, 512, 64), False),
          ("seamless_dec_self", (4, 16, 16, 2048, 2048, 64), True),
          ("seamless_cross", (4, 16, 16, 2048, 512, 64), False),
          ("seamless_cross_decode", (4, 16, 16, 1, 512, 64), False),
          ("internvl_layer", (4, 14, 2, 2048, 2048, 64), True),
          ("gemma_layer", (4, 16, 16, 2048, 2048, 256), True),
          ("qwen4b_layer", (4, 20, 20, 2048, 2048, 128), True),
          ("qwen72b_layer", (4, 64, 8, 2048, 2048, 128), True)]],
    # one rank's heads of a llama_train layer on a tensor-parallel mesh:
    # a model axis of 8 (one KV head, its 4 query heads) and of 16 (two
    # query heads on the one KV head the rank shares with another)
    *[(name, shape, True, "bfloat16", TIMED_RUNS, False)
      for name, shape in [("tp8_llama_train", (2, 4, 1, 4096, 4096, 128)),
                          ("tp16_llama_train", (2, 2, 1, 4096, 4096, 128))]],
    # the two training layers that came last, as the attention layer hands
    # them over: qwen2-72b's (qwen72_train: 64 query heads on 8) and one
    # rank's heads of maverick's at a model axis of 8 (maverick_rank_train:
    # 5 query heads on 1 KV head)
    *[(name, shape, True, "bfloat16", TIMED_RUNS, True)
      for name, shape in [("qwen72_train", (2, 64, 8, 4096, 4096, 128)),
                          ("maverick_rank", (2, 5, 1, 4096, 4096, 128))]],
]




def sdpa_ms(torch, q, k, v, causal: bool, runs: int) -> float:
    """PyTorch's ``scaled_dot_product_attention(..., enable_gqa=True)`` on
    the same inputs, a yardstick only (the port never calls it), where its
    mask is the kernel's: non-causal, or causal at Sq == Sk (its causal
    mask is top-left aligned).  It may pick among PyTorch's fused backends
    (cuDNN, flash) as it does by default, but not fall back to one that
    materialises the [Sq, Sk] scores."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    with sdpa_kernel([SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.FLASH_ATTENTION]):
        return median_ms(
            torch, lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True),
            runs=runs, warmup=1)


def sdpa_attention(q, k, v, causal=True, impl="auto"):
    """``sdpa_ms``'s call as a stand-in for ``ops.flash_attention`` in
    ``library_prefill`` (``impl`` unused), where its mask is the kernel's."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    check(not causal or q.shape[2] == k.shape[2],
          f"sdpa: causal with Sq {q.shape[2]} != Sk {k.shape[2]}")
    with sdpa_kernel([SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.FLASH_ATTENTION]):
        return sdpa(q, k, v, is_causal=causal, enable_gqa=True)


def rel_l2(torch, got, want) -> float:
    """Relative L2 distance of two tensors, in f64 over f32 values."""
    diff = got.float() - want.float()
    return float(torch.linalg.vector_norm(diff, dtype=torch.float64)
                 / torch.linalg.vector_norm(want.float(), dtype=torch.float64))


def phase_flash(torch, seed: int, copy_rate: float) -> dict:
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import bounds, ref

    t0 = time.perf_counter()
    cases = []
    for i, (name, shape, causal, xd, runs, qk_t) in enumerate(FLASH_CASES):
        dtype = getattr(torch, xd)
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + 800 + i)
        B, Hq, Hkv, Sq, Sk, D = shape

        def draw(heads, seq, transposed):
            if transposed:  # as the attention layer hands it over
                return torch.randn((B, seq, heads, D), generator=g,
                                   device="cuda", dtype=dtype).transpose(1, 2)
            return torch.randn((B, heads, seq, D), generator=g,
                               device="cuda", dtype=dtype)

        q = draw(Hq, Sq, qk_t)
        k = draw(Hkv, Sk, qk_t)
        v = draw(Hkv, Sk, True)
        # the plain version ops.flash_attention takes on CPU tensors
        plain = ref.attention_chunked if Sq >= 1024 else ref.attention
        got = kflash.flash_attention(q, k, v, causal=causal)
        want = plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check(tuple(got.shape) == (B, Hq, Sq, D) and got.dtype == dtype
              and got.is_contiguous(), f"flash {name}: shape or dtype")
        check(bool(torch.isfinite(got).all()), f"flash {name}: non-finite")
        tol = TOL[xd]
        err = float((got.float() - want.float()).abs().max())
        l2 = rel_l2(torch, got, want)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, msg=f"flash_attention {name}")
        check(l2 < FLASH_REL_L2[xd],
              f"flash {name}: relative L2 {l2} >= {FLASH_REL_L2[xd]}")
        del got, want
        nbytes, ops, bound_ms, bound_by = bounds.flash_bound(
            shape, causal, q.element_size())
        ms = median_ms(torch, lambda: kflash.flash_attention(
            q, k, v, causal=causal), runs=runs, warmup=1)
        plain_ms = median_ms(torch, lambda: plain(q, k, v, causal=causal),
                             runs=runs, warmup=1)
        # SDPA's fused backends take bf16, and its causal mask is the
        # kernel's only at Sq == Sk
        library_ms = (sdpa_ms(torch, q, k, v, causal, runs)
                      if (Sq == Sk or not causal) and xd == "bfloat16"
                      else None)
        case = {"name": name, "shape": [B, Hq, Hkv, Sq, Sk, D],
                "causal": causal, "dtype": xd, "qk_transposed": qk_t,
                "max_abs_err": err,
                "tol": tol, "rel_l2": l2, "rel_l2_limit": FLASH_REL_L2[xd],
                "runs": runs, "ms": ms, "plain_ms": plain_ms,
                "plain": plain.__name__, "library_ms": library_ms,
                "bytes": nbytes, "operations": ops, "bound_ms": bound_ms,
                "bound_by": bound_by,
                "copy_bound_ms": nbytes / copy_rate * 1e3,
                "flop_per_s": ops / (ms * 1e-3)}
        cases.append(case)
        emit({"phase": "kernels.case", "kernel": "flash_attention", **case})
        del q, k, v
        torch.cuda.empty_cache()
    shard_cases = flash_shard_cases(torch, seed)
    return {"phase": "kernels.flash_attention", "cases": len(cases),
            "shard_cases": shard_cases,
            "seconds": time.perf_counter() - t0, "results": cases}


#: seamless_cross_decode's 512 frames split over a sequence-sharded
#: decode state's ranks (launch/train.py:make_mesh_decode_step): 64 and 32
#: keys a shard, under the kernel's 128-key tile
FLASH_SHARDS = (8, 16)


def flash_shard_cases(torch, seed: int) -> list:
    """The cross-attention of a decode step on a mesh whose encoder memory
    is split by sequence: ``seamless_cross_decode``'s inputs cut into
    FLASH_SHARDS shards of frames, the forward kernel with its log-sum-exp
    on each (``ops.flash_attention_lse``, ``impl="pallas"``), then the
    combine by log-sum-exp (``ops.combine_lse``).  Held under the bf16
    gates (TOL, FLASH_REL_L2) against one launch over the whole memory and
    against the plain version; each shard's log-sum-exp against
    ``ref.attention_lse`` on its keys, under TOL.  The shards and the
    combine timed against the whole launch, against the plain version of
    the same (``impl="ref"``) and against SDPA over the whole memory (one
    PyTorch call computing the same attention); the bound is the whole
    case's (the shards read the same bytes)."""
    from repro_torch.kernels import bounds, ops, ref
    from repro_torch.kernels import flash_attention as kflash

    name, shape, causal, _, runs, _ = next(
        c for c in FLASH_CASES if c[0] == "seamless_cross_decode")
    B, Hq, Hkv, Sq, Sk, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed * 1000 + 850)

    def draw(heads, seq):  # as the attention layer hands them over
        return torch.randn((B, seq, heads, D), generator=g, device="cuda",
                           dtype=torch.bfloat16).transpose(1, 2)

    q, k, v = draw(Hq, Sq), draw(Hkv, Sk), draw(Hkv, Sk)
    whole = kflash.flash_attention(q, k, v, causal=causal)
    plain = ref.attention(q, k, v, causal=causal)
    whole_ms = median_ms(torch, lambda: kflash.flash_attention(
        q, k, v, causal=causal), runs=runs, warmup=1)
    tol = TOL["bfloat16"]
    out = []
    for shards in FLASH_SHARDS:
        n = Sk // shards
        parts = [(k[:, :, r * n:(r + 1) * n], v[:, :, r * n:(r + 1) * n])
                 for r in range(shards)]

        def sharded(impl="pallas"):
            pieces = [ops.flash_attention_lse(q, pk, pv, causal=causal,
                                              impl=impl)
                      for pk, pv in parts]
            return ops.combine_lse(torch.stack([o for o, _ in pieces]),
                                   torch.stack([lse for _, lse in pieces]))


        before = kflash.launches.count
        got = sharded()
        torch.cuda.synchronize()
        launches = kflash.launches.count - before
        check(launches == shards, f"flash shards {shards}: {launches} "
              f"launches")
        lse_err = max(float((ops.flash_attention_lse(
            q, pk, pv, causal=causal, impl="pallas")[1]
            - ref.attention_lse(q, pk, causal=causal)).abs().max())
            for pk, pv in parts)
        check(lse_err < tol, f"flash shards {shards}: lse error {lse_err}")
        held = {}
        for against, want in (("whole_kernel", whole), ("plain", plain)):
            torch.testing.assert_close(
                got.float(), want.float(), rtol=tol, atol=tol,
                msg=f"flash {name} in {shards} shards against {against}")
            l2 = rel_l2(torch, got, want)
            check(l2 < FLASH_REL_L2["bfloat16"],
                  f"flash {name} in {shards} shards: relative L2 {l2} "
                  f"against {against}")
            held[against] = {
                "max_abs_err": float((got.float() - want.float()).abs()
                                     .max()), "rel_l2": l2}
        ms = median_ms(torch, sharded, runs=runs, warmup=1)
        plain_ms = median_ms(torch, lambda: sharded("ref"), runs=runs,
                             warmup=1)
        nbytes, ops_count, bound_ms, bound_by = bounds.flash_bound(
            shape, causal, 2)
        case = {"name": f"{name}_{shards}_shards", "shape": list(shape),
                "shards": shards, "keys_per_shard": n, "dtype": "bfloat16",
                "launches": launches, "lse_max_abs_err": lse_err,
                "tol": tol, "rel_l2_limit": FLASH_REL_L2["bfloat16"],
                "held": held, "ms": ms, "whole_ms": whole_ms,
                "vs_whole": ms / whole_ms, "plain_ms": plain_ms,
                "library_ms": sdpa_ms(torch, q, k, v, causal, runs),
                "bytes": nbytes, "operations": ops_count,
                "bound_ms": bound_ms, "bound_by": bound_by}
        emit({"phase": "kernels.case", "kernel": "flash_attention_lse",
              **case})
        out.append(case)
    del q, k, v, whole, plain
    torch.cuda.empty_cache()
    return out


# name, (B, Hq, Hkv, Sq, Sk, D), causal, dtypes, timed runs (0: held, not
# timed), q and k as transposed [B, S, H, D] views (v always is one, as
# the attention layer hands them over).  The main path is one layer of the
# llama_train phase (8192 tokens, causal); then llama's serving layer,
# internvl2-1b's (14 query heads on 2), gemma-7b's (D = 256: the bf16
# kernel's warpgroups split D), seamless's cross-attention (2048 queries on
# 512 frames, full); ragged causal Sq = Sk = 333 at D = 16 and, with GQA,
# at D = 256; full Sq 100 on Sk 300 at D = 32; causal Sq < Sk at D = 64
# and across the 128-key tile edge at D = 128
BWD_CASES = [
    ("main_path", (2, 32, 8, 4096, 4096, 128), True, ("bfloat16",),
     TIMED_RUNS, True),
    ("train_layer_f32", (2, 32, 8, 4096, 4096, 128), True, ("float32",), 3,
     True),
    ("llama_serving_layer", (4, 32, 8, 2048, 2048, 128), True,
     ("float32", "bfloat16"), TIMED_RUNS, True),
    ("internvl_layer", (4, 14, 2, 2048, 2048, 64), True,
     ("float32", "bfloat16"), TIMED_RUNS, True),
    ("gemma_layer", (1, 16, 16, 2048, 2048, 256), True,
     ("float32", "bfloat16"), TIMED_RUNS, True),
    ("seamless_cross", (4, 16, 16, 2048, 512, 64), False,
     ("float32", "bfloat16"), TIMED_RUNS, True),
    ("ragged_333_d16", (2, 8, 2, 333, 333, 16), True,
     ("float32", "bfloat16"), 0, False),
    ("gqa_ragged_333_d256", (1, 8, 2, 333, 333, 256), True,
     ("float32", "bfloat16"), 0, True),
    ("full_100_on_300_d32", (2, 8, 8, 100, 300, 32), False,
     ("float32", "bfloat16"), 0, False),
    ("sq_lt_sk_causal_d64", (1, 6, 2, 200, 328, 64), True,
     ("float32", "bfloat16"), 0, True),
    ("sq_lt_sk_190_on_260_d128", (1, 8, 2, 190, 260, 128), True,
     ("float32", "bfloat16"), 0, True),
    # one rank's heads of a llama_train layer at a model axis of 8 and 16
    ("tp8_llama_train", (2, 4, 1, 4096, 4096, 128), True, ("bfloat16",),
     TIMED_RUNS, False),
    ("tp16_llama_train", (2, 2, 1, 4096, 4096, 128), True, ("bfloat16",),
     TIMED_RUNS, False),
    # qwen72_train's layer (8 query heads a KV head) and maverick_rank_train's
    # rank (5 query heads on 1 KV head)
    ("qwen72_train", (2, 64, 8, 4096, 4096, 128), True, ("bfloat16",),
     TIMED_RUNS, True),
    ("maverick_rank", (2, 5, 1, 4096, 4096, 128), True, ("bfloat16",),
     TIMED_RUNS, True),
]
#: the main case's backward run twice: dk and dv must be bit-identical, dq
#: within BWD_DQ_RUN_SPREAD x max(1, max |dq|) of the other run (its f32
#: adds into dq_acc land in a varying order; rounded to bf16 once, a value
#: may land on a neighbouring bf16 number, 2^-8 relative apart)
BWD_DQ_RUN_SPREAD = 2 ** -7




def sdpa_bwd_ms(torch, q, k, v, do, causal: bool, runs: int):
    """The backward of PyTorch's ``scaled_dot_product_attention`` on the
    same inputs (its forward run once, outside the timing), a yardstick
    only, where its mask is the kernel's -> (ms, how it was called).  bf16:
    ``enable_gqa=True`` on its fused backends, as ``sdpa_ms``.  f32: the
    memory-efficient backend (the fused one that takes f32); where it
    refuses ``enable_gqa``, k and v expanded to the query heads outside the
    timing (its gradients are then per query head, not yet summed over the
    group)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    if q.dtype == torch.float32:
        backends, how = [SDPBackend.EFFICIENT_ATTENTION], "efficient"
    else:
        backends = [SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION]
        how = "cudnn or flash"
    inputs, gqa = (q, k, v), True
    with sdpa_kernel(backends):
        leaves = [t.detach().requires_grad_() for t in inputs]
        try:
            out = sdpa(*leaves, is_causal=causal, enable_gqa=True)
        except RuntimeError:
            group = q.shape[1] // k.shape[1]
            inputs = (q, k.repeat_interleave(group, dim=1),
                      v.repeat_interleave(group, dim=1))
            leaves = [t.detach().requires_grad_() for t in inputs]
            out = sdpa(*leaves, is_causal=causal)
            gqa = False
        ms = median_ms(torch, lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), runs=runs, warmup=1)
    return ms, (f"sdpa {how}, " + ("enable_gqa" if gqa
                                   else "k and v expanded to Hq"))


def phase_flash_bwd(torch, seed: int, copy_rate: float) -> dict:
    """The backward kernel against ``ref.attention_bwd`` on the card, each
    output (dq, dk, dv) held to BWD_TOL and BWD_REL_L2; the timed cases
    beside their bound, the plain version and SDPA's backward."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import bounds, ref

    t0 = time.perf_counter()
    cases = []
    i = 0
    for name, shape, causal, dtypes, runs, qk_t in BWD_CASES:
        for xd in dtypes:
            i += 1
            dtype = getattr(torch, xd)
            g = torch.Generator(device="cuda").manual_seed(seed * 1000 + 900
                                                           + i)
            B, Hq, Hkv, Sq, Sk, D = shape

            def draw(heads, seq, transposed):
                if transposed:
                    return torch.randn((B, seq, heads, D), generator=g,
                                       device="cuda",
                                       dtype=dtype).transpose(1, 2)
                return torch.randn((B, heads, seq, D), generator=g,
                                   device="cuda", dtype=dtype)

            q, k, v = draw(Hq, Sq, qk_t), draw(Hkv, Sk, qk_t), draw(Hkv, Sk,
                                                                   True)
            do = torch.randn((B, Hq, Sq, D), generator=g, device="cuda",
                             dtype=dtype)
            o, lse = kflash.flash_attention_with_lse(q, k, v, causal=causal)
            got = kflash.flash_attention_bwd(q, k, v, o, lse, do, causal)
            want = ref.attention_bwd(q, k, v, do, causal=causal)
            torch.cuda.synchronize()
            errs, limits, l2s = {}, {}, {}
            for out_name, a, w in zip(("dq", "dk", "dv"), got, want):
                check(a.shape == w.shape and a.dtype == dtype
                      and a.is_contiguous(), f"bwd {name} {out_name}: shape")
                check(bool(torch.isfinite(a).all()),
                      f"bwd {name} {out_name}: non-finite")
                limits[out_name] = BWD_TOL[xd] * max(
                    1.0, float(w.float().abs().max()))
                errs[out_name] = float((a.float() - w.float()).abs().max())
                l2s[out_name] = rel_l2(torch, a, w)
                check(errs[out_name] <= limits[out_name],
                      f"bwd {name} {xd} {out_name}: max abs error "
                      f"{errs[out_name]} > {limits[out_name]}")
                check(l2s[out_name] <= BWD_REL_L2[xd],
                      f"bwd {name} {xd} {out_name}: relative L2 "
                      f"{l2s[out_name]} > {BWD_REL_L2[xd]}")
            del got, want
            nbytes, ops, bound_ms, bound_by = bounds.bwd_bound(
                shape, causal, q.element_size())
            case = {"name": name, "shape": [B, Hq, Hkv, Sq, Sk, D], "causal": causal,
                    "dtype": xd, "qk_transposed": qk_t,
                    "max_abs_err": max(errs.values()), "max_abs_errs": errs,
                    # the limit the largest error was held to
                    "max_abs_limit": limits[max(errs, key=errs.get)],
                    "max_abs_limits": limits,
                    "tol": BWD_TOL[xd], "rel_l2": l2s,
                    "rel_l2_limit": BWD_REL_L2[xd], "runs": runs,
                    "bytes": nbytes, "operations": ops, "bound_ms": bound_ms,
                    "bound_by": bound_by}
            if name == "main_path":
                # twice more: dk, dv bit-identical, dq's spread stated
                first = kflash.flash_attention_bwd(q, k, v, o, lse, do,
                                                   causal)
                second = kflash.flash_attention_bwd(q, k, v, o, lse, do,
                                                    causal)
                torch.cuda.synchronize()
                spread = float((first[0].float() - second[0].float())
                               .abs().max())
                spread_limit = BWD_DQ_RUN_SPREAD * max(
                    1.0, float(first[0].float().abs().max()))
                identical = (torch.equal(first[1], second[1])
                             and torch.equal(first[2], second[2]))
                check(identical, f"bwd {name}: dk, dv differ between runs")
                check(spread <= spread_limit,
                      f"bwd {name}: dq differs by {spread} > {spread_limit} "
                      f"between runs")
                case.update({"dq_run_spread": spread,
                             "dq_run_spread_limit": spread_limit,
                             "dk_dv_identical_across_runs": identical})
                del first, second
            if runs:
                ms = median_ms(torch, lambda: kflash.flash_attention_bwd(
                    q, k, v, o, lse, do, causal), runs=runs, warmup=1)
                plain_ms = median_ms(torch, lambda: ref.attention_bwd(
                    q, k, v, do, causal=causal), runs=runs, warmup=1)
                library_ms, library = (
                    sdpa_bwd_ms(torch, q, k, v, do, causal, runs)
                    if Sq == Sk or not causal else (None, None))
                case.update({"ms": ms, "plain_ms": plain_ms,
                             "library_ms": library_ms, "library": library,
                             "copy_bound_ms": nbytes / copy_rate * 1e3,
                             "flop_per_s": ops / (ms * 1e-3)})
            cases.append(case)
            emit({"phase": "kernels.case", "kernel": "flash_attention_bwd",
                  **case})
            del q, k, v, o, lse, do
            torch.cuda.empty_cache()
    return {"phase": "kernels.flash_attention_bwd", "cases": len(cases),
            "seconds": time.perf_counter() - t0, "results": cases}


# name, (B, L, H, P, N), dtype, b and c one group expanded to every head
# (stride 0), D-skip, inputs ("model": a = -(1..H) and dt from the init's
# dt_bias, as in a mamba2 layer; "normal": tests/test_kernels.py:146-149;
# "strong": a = -e^3 and dt in [1, 5]), timed runs.  The main path is one
# mamba2-2.7b layer of the mamba_prefill phase; the 32k layer is
# SHAPES["prefill_32k"] for one request; the jamba layer one mamba sublayer
# of jamba-v0.1-52b's (128 heads, N 16); then tests/test_kernels.py:137-141
# in f32 and bf16, ragged lengths, contiguous b and c, a strongly decaying
# head.
SSD_CASES = [
    ("main_path", (4, 2048, 80, 64, 128), "bfloat16", True, True, "model",
     TIMED_RUNS),
    ("prefill_32k_layer", (1, 32768, 80, 64, 128), "bfloat16", True, True,
     "model", 3),
    ("jamba_layer", (4, 2048, 128, 64, 16), "bfloat16", True, True, "model",
     TIMED_RUNS),
    *[(f"{name}_{dt}", shape, dt, False, skip, "normal", TIMED_RUNS)
      for dt in ("float32", "bfloat16")
      for name, shape, skip in [
          ("p16_n8", (2, 128, 4, 16, 8), False),
          ("p32_n16", (1, 256, 8, 32, 16), True),
          ("p64_n128", (2, 64, 2, 64, 128), True)]],
    ("ragged_1", (1, 1, 3, 64, 128), "float32", True, True, "normal",
     TIMED_RUNS),
    ("ragged_63", (2, 63, 4, 32, 16), "float32", True, True, "normal",
     TIMED_RUNS),
    ("ragged_1000", (1, 1000, 2, 64, 128), "float32", True, True, "normal",
     TIMED_RUNS),
    ("contiguous_bc", (4, 512, 80, 64, 128), "bfloat16", False, True,
     "model", TIMED_RUNS),
    ("strong_decay", (1, 2048, 4, 64, 128), "float32", True, True, "strong",
     TIMED_RUNS),
    # one rank's heads of a training layer on a tensor-parallel mesh:
    # mamba2-2.7b's 80 heads at a model axis of 8, jamba's 128 at 16
    ("tp8_mamba_train", (2, 4096, 10, 64, 128), "bfloat16", True, True,
     "model", TIMED_RUNS),
    ("tp16_jamba_train", (2, 4096, 8, 64, 16), "bfloat16", True, True,
     "model", TIMED_RUNS),
]
#: the SSD kernel's output against its plain version, relative L2 over the
#: whole case: in bf16 the output's rounding on a few elements, in f32 the
#: sum orders and the cumulative sums' rounding inside exp()
SSD_REL_L2 = {"float32": 1e-4, "bfloat16": 5e-3}
#: the elementwise tolerances: tests/test_kernels.py:150 and bf16's
SSD_TOL = {"float32": 5e-4, "bfloat16": 2e-2}
#: the plain version chunked at the TPU kernel's chunk, where it divides L;
#: the operations are counted at the same chunk
SSD_CHUNK = 128


def ssd_inputs(torch, shape, dtype, grouped: bool, skip: bool, kind: str,
               g):
    """x, dt, a, b, c, d on the card (see SSD_CASES)."""
    import math

    B, L, H, P, N = shape
    F = torch.nn.functional
    x = torch.randn((B, L, H, P), generator=g, device="cuda", dtype=dtype)
    if kind == "model":
        a = -torch.arange(1, H + 1, device="cuda", dtype=torch.float32)
        u = torch.rand((H,), generator=g, device="cuda")
        dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
        dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
        dt = F.softplus(torch.randn((B, L, H), generator=g, device="cuda")
                        + dt_bias)
    else:
        dt = F.softplus(torch.randn((B, L, H), generator=g, device="cuda"))
        a = -torch.exp(torch.randn((H,), generator=g, device="cuda"))
        if kind == "strong":
            a = torch.full_like(a, -math.exp(3.0))
            dt = 1.0 + 4.0 * torch.rand((B, L, H), generator=g,
                                        device="cuda")
    heads = 1 if grouped else H
    b = torch.randn((B, L, heads, N), generator=g, device="cuda", dtype=dtype)
    c = torch.randn((B, L, heads, N), generator=g, device="cuda", dtype=dtype)
    d = (torch.randn((H,), generator=g, device="cuda") if kind == "normal"
         else torch.ones((H,), device="cuda")) if skip else None
    return x, dt, a, b.expand(B, L, H, N), c.expand(B, L, H, N), d




def phase_ssd(torch, seed: int, copy_rate: float) -> dict:
    from functools import partial

    from repro_torch.kernels import bounds, ref
    from repro_torch.kernels import ssd_scan as kssd

    t0 = time.perf_counter()
    cases = []
    for i, (name, shape, xd, grouped, skip, kind, runs) in enumerate(
            SSD_CASES):
        dtype = getattr(torch, xd)
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + 900 + i)
        x, dt, a, b, c, d = ssd_inputs(torch, shape, dtype, grouped, skip,
                                       kind, g)
        check(grouped == (b.stride(2) == 0), f"ssd {name}: b's head stride")
        B, L, H, P, N = shape
        # the sequential recurrence at small L, chunked at the long ones
        plain = (partial(ref.ssd_scan_chunked, chunk=SSD_CHUNK)
                 if L >= 2048 else ref.ssd_scan)
        got = kssd.ssd_scan(x, dt, a, b, c, d_skip=d)
        want = plain(x, dt, a, b, c, d_skip=d)
        torch.cuda.synchronize()
        check(tuple(got.shape) == (B, L, H, P) and got.dtype == dtype
              and got.is_contiguous(), f"ssd {name}: shape or dtype")
        check(bool(torch.isfinite(got).all()), f"ssd {name}: non-finite")
        tol = SSD_TOL[xd]
        err = float((got.float() - want.float()).abs().max())
        l2 = rel_l2(torch, got, want)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, msg=f"ssd_scan {name}")
        check(l2 < SSD_REL_L2[xd],
              f"ssd {name}: relative L2 {l2} >= {SSD_REL_L2[xd]}")
        del got, want
        nbytes, ops, bound_ms, bound_by = bounds.ssd_bound(
            shape, x.element_size(), grouped, chunk=SSD_CHUNK)
        ms = median_ms(torch, lambda: kssd.ssd_scan(x, dt, a, b, c, d_skip=d),
                       runs=runs, warmup=1)
        plain_ms = median_ms(torch, lambda: plain(x, dt, a, b, c, d_skip=d),
                             runs=runs, warmup=1)
        case = {"name": name, "shape": [B, L, H, P, N], "dtype": xd,
                "b_c_head_stride": b.stride(2), "d_skip": skip,
                "inputs": kind, "max_abs_err": err, "tol": tol,
                "rel_l2": l2, "rel_l2_limit": SSD_REL_L2[xd], "runs": runs,
                "ms": ms, "plain_ms": plain_ms,
                "plain": getattr(plain, "func", plain).__name__,
                "library_ms": None, "bytes": nbytes, "operations": ops,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "copy_bound_ms": nbytes / copy_rate * 1e3,
                "flop_per_s": ops / (ms * 1e-3)}
        cases.append(case)
        emit({"phase": "kernels.case", "kernel": "ssd_scan", **case})
        del x, dt, a, b, c, d
        torch.cuda.empty_cache()
    return {"phase": "kernels.ssd_scan", "cases": len(cases),
            "seconds": time.perf_counter() - t0, "results": cases}


# name, (B, L, H, P, N), dtype, b and c one group (G = 1, else one per
# head), D-skip, inputs (as SSD_CASES), timed runs.  The main path is one
# mamba2-2.7b layer of the mamba_train phase (2 x 4096 tokens), in bf16 and
# f32; then one jamba-v0.1-52b mamba sublayer of jamba_train (128 heads, N
# 16), the serving path's mamba layer (SSD_CASES' main path), the small
# shapes of tests/test_kernels.py:137-141 in f32 and bf16, ragged lengths,
# b and c per head, and a strongly decaying head
SSD_BWD_CASES = [
    ("main_path", (2, 4096, 80, 64, 128), "bfloat16", True, True, "model",
     TIMED_RUNS),
    ("train_layer_f32", (2, 4096, 80, 64, 128), "float32", True, True,
     "model", TIMED_RUNS),
    ("jamba_train_layer", (2, 4096, 128, 64, 16), "bfloat16", True, True,
     "model", TIMED_RUNS),
    ("serving_layer", (4, 2048, 80, 64, 128), "bfloat16", True, True,
     "model", TIMED_RUNS),
    *[(f"{name}_{dt}", shape, dt, grouped, skip, "normal", 0)
      for dt in ("float32", "bfloat16")
      for name, shape, grouped, skip in [
          ("p16_n8", (2, 128, 4, 16, 8), False, False),
          ("p32_n16", (1, 256, 8, 32, 16), True, True),
          ("p64_n128", (2, 64, 2, 64, 128), True, True),
          ("p128_n128", (1, 192, 2, 128, 128), True, True)]],
    ("ragged_1", (1, 1, 3, 64, 128), "float32", True, True, "normal", 0),
    ("ragged_63", (2, 63, 4, 32, 16), "bfloat16", True, True, "normal", 0),
    ("ragged_1000", (1, 1000, 2, 64, 128), "float32", True, True, "normal",
     0),
    ("per_head_bc", (4, 512, 80, 64, 128), "bfloat16", False, True, "model",
     0),
    ("strong_decay", (1, 2048, 4, 64, 128), "float32", True, True, "strong",
     0),
    ("strong_decay_bf16", (1, 2048, 4, 64, 128), "bfloat16", True, True,
     "strong", 0),
    # one rank's heads of a training layer, as in SSD_CASES
    ("tp8_mamba_train", (2, 4096, 10, 64, 128), "bfloat16", True, True,
     "model", TIMED_RUNS),
    ("tp16_jamba_train", (2, 4096, 8, 64, 16), "bfloat16", True, True,
     "model", TIMED_RUNS),
]
#: the backward's six gradients (dx, ddt, da, db, dc, dd) against
#: ref.ssd_scan_bwd: max-abs error within SSD_BWD_TOL x max(1, the largest
#: |value|) (the forward's SSD_TOL, scaled as BWD_TOL is for attention) and
#: relative L2 over max(1, |ref|) within SSD_BWD_REL_L2.  f32: the orders of
#: the sums, and of the cumulative sum whose f32 rounding enters exp() (it
#: reaches several hundred at a = -80): SSD_REL_L2's f32 limit.  bf16: each
#: gradient rounded to bf16 once on both sides and the kernel's operands
#: that are not inputs split hi + lo; the CPU model of that arithmetic
#: stays under a fifth of the limit, one rounding of those operands passes
#: it (tests/test_torch_ssd_bwd.py:
#: test_one_bf16_rounding_would_miss_the_relative_l2_gate)
SSD_BWD_TOL = {"float32": 5e-4, "bfloat16": 2e-2}
SSD_BWD_REL_L2 = {"float32": 1e-4, "bfloat16": 2e-3}
SSD_GRADS = ("dx", "ddt", "da", "db", "dc", "dd")




def hold_ssd_bwd(torch, got, want, xd: str, what: str):
    """Each gradient within SSD_BWD_TOL and SSD_BWD_REL_L2 -> (errors,
    limits, relative L2s), by gradient."""
    errs, limits, l2s = {}, {}, {}
    for name, a, w in zip(SSD_GRADS, got, want):
        if w is None:
            check(a is None, f"ssd_bwd {what} {name}: expected None")
            continue
        check(a.shape == w.shape and a.dtype == w.dtype
              and a.is_contiguous(), f"ssd_bwd {what} {name}: shape/dtype")
        check(bool(torch.isfinite(a).all()),
              f"ssd_bwd {what} {name}: non-finite")
        limits[name] = SSD_BWD_TOL[xd] * max(1.0,
                                             float(w.float().abs().max()))
        errs[name] = float((a.float() - w.float()).abs().max())
        l2s[name] = float((a.double() - w.double()).norm()) / max(
            1.0, float(w.double().norm()))
        check(errs[name] <= limits[name],
              f"ssd_bwd {what} {xd} {name}: max abs error {errs[name]} > "
              f"{limits[name]}")
        check(l2s[name] <= SSD_BWD_REL_L2[xd],
              f"ssd_bwd {what} {xd} {name}: relative L2 {l2s[name]} > "
              f"{SSD_BWD_REL_L2[xd]}")
    return errs, limits, l2s


def phase_ssd_bwd(torch, seed: int, copy_rate: float) -> dict:
    """The SSD backward kernel against ``ref.ssd_scan_bwd`` on the card,
    each of its six gradients held to SSD_BWD_TOL and SSD_BWD_REL_L2; the
    timed cases beside their bound and the plain version (no single
    PyTorch call computes it), each with its kernels' device times from a
    profiler trace; the main case twice more, all six gradients
    bit-identical."""
    from repro_torch.kernels import bounds, ref
    from repro_torch.kernels import ssd_scan as kssd

    t0 = time.perf_counter()
    cases = []
    for i, (name, shape, xd, grouped, skip, kind, runs) in enumerate(
            SSD_BWD_CASES):
        dtype = getattr(torch, xd)
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + 700 + i)
        x, dt, a, b, c, d = ssd_inputs(torch, shape, dtype, grouped, skip,
                                       kind, g)
        if grouped:  # unexpanded, as SsdScanFn takes them
            b, c = b[:, :, :1], c[:, :, :1]
        dy = torch.randn(x.shape, generator=g, device="cuda", dtype=dtype)
        got = kssd.ssd_scan_bwd(x, dt, a, b, c, dy, d)
        want = ref.ssd_scan_bwd(x, dt, a, b, c, dy, d)
        torch.cuda.synchronize()
        errs, limits, l2s = hold_ssd_bwd(torch, got, want, xd, name)
        del got, want
        B, L, H, P, N = shape
        nbytes, ops, bound_ms, bound_by = bounds.ssd_bwd_bound(
            shape, x.element_size(), grouped, skip, kssd.CHUNK)
        worst = max(errs, key=lambda k: errs[k] / limits[k])
        case = {"name": name, "shape": [B, L, H, P, N], "dtype": xd,
                "groups": b.shape[2], "d_skip": skip, "inputs": kind,
                "max_abs_err": errs[worst], "max_abs_limit": limits[worst],
                "max_abs_errs": errs, "max_abs_limits": limits,
                "tol": SSD_BWD_TOL[xd], "rel_l2": l2s,
                "rel_l2_limit": SSD_BWD_REL_L2[xd], "runs": runs,
                "bytes": nbytes, "operations": ops, "bound_ms": bound_ms,
                "bound_by": bound_by,
                "finite": True}
        if name == "main_path":
            first = kssd.ssd_scan_bwd(x, dt, a, b, c, dy, d)
            second = kssd.ssd_scan_bwd(x, dt, a, b, c, dy, d)
            torch.cuda.synchronize()
            identical = all(torch.equal(u, v) for u, v in zip(first, second))
            check(identical, f"ssd_bwd {name}: two runs differ")
            case["identical_across_runs"] = identical
            del first, second
        if runs:
            ms = median_ms(torch, lambda: kssd.ssd_scan_bwd(
                x, dt, a, b, c, dy, d), runs=runs, warmup=1)
            plain_ms = median_ms(torch, lambda: ref.ssd_scan_bwd(
                x, dt, a, b, c, dy, d), runs=runs, warmup=1)
            # the device time of each of the call's kernels (the local
            # states, the state pass, the per-chunk products, the sums)
            prof = profile_breakdown(torch, lambda: kssd.ssd_scan_bwd(
                x, dt, a, b, c, dy, d), runs=3)
            case.update({"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                         "library": "none: no single PyTorch call",
                         "copy_bound_ms": nbytes / copy_rate * 1e3,
                         "flop_per_s": ops / (ms * 1e-3),
                         "kernels_ms": prof.get("top_kernels_ms_per_run")})
        cases.append(case)
        emit({"phase": "kernels.case", "kernel": "ssd_scan_bwd", **case})
        del x, dt, a, b, c, d, dy
        torch.cuda.empty_cache()
    return {"phase": "kernels.ssd_scan_bwd", "cases": len(cases),
            "seconds": time.perf_counter() - t0, "results": cases}


#: kernel group (and source, csrc/<group>.cu) -> a substring of the name of
#: every CUDA kernel in that source (checked in phase 0): the SSD's c.b
#: kernel and scan both fall in the ssd_scan group
KERNEL_SYMBOLS = {"flash_attention": "flash_attention_kernel",
                  "flash_attention_bwd": "flash_bwd_",
                  "ssd_scan": "ssd_scan_kernel",
                  "ssd_scan_bwd": "ssd_bwd_"}


#: the MoE's steps (``repro_torch.models.moe``), timed one by one in a
#: prefill (moe_step_ms)
MOE_STEPS = ("route", "dispatch", "experts", "combine")


def moe_step_ms(torch, fn, runs: int = 3) -> dict:
    """Device milliseconds of each MoE step per call of ``fn``, summed over
    its MoE layers, from CUDA events recorded on the stream around each
    step.  In a prefill the device runs the kernels back to back (idle
    < 1 %, profile_breakdown), so the span between a step's two events is
    its kernels' time; in a train step the spans are the forward's and the
    remat recompute's, with the step's idle share in its breakdown."""
    from repro_torch.models import moe

    spans = {name: [] for name in MOE_STEPS}

    def timed(name):
        def wrap(step):
            def call(*args, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = step(*args, **kw)
                end.record()
                spans[name].append((start, end))
                return out
            return call
        return wrap

    fn()
    with contextlib.ExitStack() as stack:
        for name in MOE_STEPS:
            stack.enter_context(patched(moe, name, timed(name)))
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return {name: sum(s.elapsed_time(e) for s, e in pairs) / runs
            for name, pairs in spans.items()}


def kernel_group(name: str) -> str:
    """A device kernel's group: the port's kernel of that source, matmuls
    (cuBLAS), or the rest."""
    for kernel, symbol in KERNEL_SYMBOLS.items():
        if symbol in name:
            return kernel
    low = name.lower()
    if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul"
    return "other"


def profile_breakdown(torch, fn, runs: int = 3) -> dict:
    """Device time of ``runs`` calls of ``fn`` by kernel group, from a
    ``torch.profiler`` trace: each of the port's LM kernels, matmuls
    (cuBLAS), and the rest; the device's idle share between the window's
    first kernel start and last kernel end; the five kernels that take the
    most time.  A trace with no device events reports
    ``device_events: 0``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    groups = {k: 0.0 for k in (*KERNEL_SYMBOLS, "matmul", "other")}
    by_name: dict = {}
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        groups[kernel_group(e.name)] += us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        spans.append((e.time_range.start, e.time_range.end))
    out = {"runs": runs, "wall_ms_per_run": wall_s / runs * 1e3,
           "device_events": len(spans)}
    if not spans:
        return out
    spans.sort()
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = max(end for _, end in spans) - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    out.update({
        "kernels_per_run": len(spans) / runs,
        "device_ms_per_run": {k: v / runs / 1e3 for k, v in groups.items()},
        "busy_ms_per_run": busy / runs / 1e3,
        "idle_share": 1.0 - busy / window,
        "top_kernels_ms_per_run": {n[:80]: v / runs / 1e3 for n, v in top}})
    return out


def phase_tile(torch, seed: int, backend) -> dict:
    from repro_torch.apps.composite import composite_tile
    from repro_torch.configs.festivus_imagery import DEFAULT as cfg

    t0 = time.perf_counter()
    px, T = cfg.composite_tile_px, cfg.temporal_depth
    stack = np.random.default_rng(seed).random((T, px, px, cfg.bands),
                                               dtype=np.float32)
    gen_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    t1 = time.perf_counter()
    out = composite_tile(stack, cfg)
    tile_s = time.perf_counter() - t1
    launches = backend.launch_counts()
    want = composite_tile(stack, cfg, impl="ref")
    check(out.shape == (px, px, cfg.bands) and out.dtype == np.float32,
          "tile: shape or dtype")
    check(np.isfinite(out).all(), "tile: non-finite output")
    err = float(np.abs(out - want).max())
    np.testing.assert_allclose(out, want, rtol=TOL["float32"],
                               atol=TOL["float32"])
    check(launches["composite"] == 1, f"tile: launches {launches}")
    breakdown = tile_breakdown(torch, stack, cfg)
    check(breakdown.pop("out").tobytes() == out.tobytes(),
          "tile: breakdown output differs")
    return {"phase": "tile", "shape": [T, px, px, cfg.bands],
            "launches": launches, "max_abs_err": err, "tol": TOL["float32"],
            "stack_gen_s": gen_s, "composite_tile_s": tile_s,
            "breakdown_s": breakdown, "seconds": time.perf_counter() - t0}


def synced(torch, fn):
    """fn's result and its seconds on the host clock, from a synchronise to
    a synchronise."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t


class StepPeaks:
    """Each training step's peak device memory (the allocator's peak reset
    just before the step, read just after; what ``launch/dryrun.py``
    predicts for one step) and the memory allocated when it starts,
    keeping the phase's own peak across the resets."""

    def __init__(self, torch):
        self.torch = torch
        self.steps = []
        self.bases = []
        self._before = 0

    def __call__(self, fn):
        cuda = self.torch.cuda
        self._before = max(self._before, cuda.max_memory_allocated())
        cuda.reset_peak_memory_stats()
        self.bases.append(cuda.memory_allocated())
        out = fn()
        self.steps.append(cuda.max_memory_allocated())
        return out

    def phase_peak(self) -> int:
        return max([self._before, self.torch.cuda.max_memory_allocated()]
                   + self.steps)


#: the caching allocator's counters that a stall inside a call would move:
#: retries after a failed cudaMalloc (each frees the cache and
#: synchronises), cudaMalloc and cudaFree calls
ALLOCATOR_COUNTERS = ("num_alloc_retries", "num_device_alloc",
                      "num_device_free")


def watched(torch, fn):
    """synced(fn), and what its call did besides: the host process's CPU
    seconds and the moves of ALLOCATOR_COUNTERS."""
    before = torch.cuda.memory_stats()
    cpu = time.process_time()
    result, seconds = synced(torch, fn)
    cpu = time.process_time() - cpu
    after = torch.cuda.memory_stats()
    return result, seconds, {
        "cpu_s": cpu, **{k: after.get(k, 0) - before.get(k, 0)
                         for k in ALLOCATOR_COUNTERS},
        "reserved_bytes": torch.cuda.memory_reserved()}


def tile_breakdown(torch, stack, cfg) -> dict:
    """composite_tile's steps, each timed on the host clock up to a
    synchronise: where a tile's time goes."""
    from functools import partial

    from repro_torch.apps.composite import cloud_score
    from repro_torch.convert import stack_to_device
    from repro_torch.kernels import ops, ref

    timed = partial(synced, torch)
    (imgs, _), h2d_s = timed(lambda: stack_to_device(stack, None,
                                                     torch.device("cuda")))
    weights, weights_s = timed(lambda: ref.composite_weights(
        cloud_score(imgs, cfg), nir=imgs[..., 1], red=imgs[..., 0]))
    comp, kernel_s = timed(lambda: ops.composite(imgs, weights))
    out, d2h_s = timed(lambda: comp.cpu().numpy())
    return {"host_to_device": h2d_s, "cloud_score_and_weights": weights_s,
            "composite_kernel": kernel_s, "device_to_host": d2h_s, "out": out}


def phase_campaign(torch, seed: int, backend, tiles: int = 4,
                   px: int = 1024) -> dict:
    from repro_torch.apps.composite import (composite_tile,
                                            run_composite_campaign)
    from repro_torch.configs.festivus_imagery import DEFAULT
    from repro_torch.core import (ChunkStore, Festivus, FlakyObjectStore,
                                  InMemoryObjectStore)
    from repro_torch.data import imagery

    t0 = time.perf_counter()
    cfg = dataclasses.replace(DEFAULT, composite_tile_px=px, chunk_px=px)
    inner = InMemoryObjectStore()
    flaky = FlakyObjectStore(inner, failure_rate=0.02, seed=7)
    cs = ChunkStore(Festivus(flaky), "bucket")
    names = []
    for i in range(tiles):
        name = f"stacks/t{i}"
        imagery.write_scene_stack(
            cs, name, imagery.SceneSpec(tile_px=px, bands=cfg.bands,
                                        temporal_depth=cfg.temporal_depth,
                                        seed=seed * 100 + i),
            chunk_px=cfg.chunk_px)
        names.append(name)
    write_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    backend.reset_launch_counts()
    t1 = time.perf_counter()
    out = run_composite_campaign(cs, names, cfg, num_workers=4)
    campaign_s = time.perf_counter() - t1
    launches = backend.launch_counts()
    report = out["report"]
    check(report.all_done and out["tiles"] == tiles, "campaign incomplete")

    max_err = 0.0
    for n in names:
        imgs, _ = imagery.read_scene_stack(cs, n)
        single = composite_tile(imgs, cfg)
        got = cs.open(f"composite/{n}").read_all()
        check(got.dtype == single.dtype and got.shape == single.shape,
              f"campaign: {n} shape or dtype")
        check(got.tobytes() == single.tobytes(), f"campaign diverges on {n}")
        want = composite_tile(imgs, cfg, impl="ref")
        np.testing.assert_allclose(got, want, rtol=TOL["float32"],
                                   atol=TOL["float32"])
        max_err = max(max_err, float(np.abs(got - want).max()))
    overview = cs.open(f"composite/{names[0]}").read_level(2)
    check(overview.shape == (px // 4, px // 4, cfg.bands),
          f"pyramid level 2 shape {overview.shape}")
    check(np.isfinite(overview).all(), "pyramid: non-finite")
    return {"phase": "campaign", "tiles": tiles, "tile_px": px,
            "temporal_depth": cfg.temporal_depth, "workers": report.nodes,
            "launches": launches, "byte_identical": True,
            "max_abs_err": max_err, "tol": TOL["float32"],
            "queue": report.queue_stats,
            "injected_store_failures": flaky.injected_failures,
            "retried_ops": report.festivus_stats.retried_ops,
            "stack_write_s": write_s, "campaign_s": campaign_s,
            "seconds": time.perf_counter() - t0}, cs, names


CLOUD_BLOBS = 16  # per timestep: ~30 % of a tile under cloud


def field_scene(torch, seed: int, T: int, px: int, bands: int, dev):
    """A [T, px, px, bands] f32 stack made on ``dev`` from a seeded
    generator, with SceneSpec's structure (data/imagery.py) at a size its
    host-side synthesis cannot reach: a mosaic of fields, each with its own
    reflectance per band (rows of fields 64-384 px high, each row cut into
    fields 64-384 px wide), an NIR seasonal swing, sensor noise of sigma
    0.01, and elliptical cloud blobs at 0.7 reflectance, marked invalid.
    Returns (stack, valid [T, px, px] bool, ground-truth field map
    [px, px] int64)."""
    import math

    g = torch.Generator(device=dev).manual_seed(seed)
    n = px // 64 + 1
    row_edges = torch.randint(64, 385, (n,), generator=g, device=dev).cumsum(0)
    rows = torch.searchsorted(row_edges, torch.arange(px, device=dev),
                              right=True)
    col_edges = torch.randint(64, 385, (n, n), generator=g,
                              device=dev).cumsum(1)
    cols = torch.searchsorted(
        col_edges, torch.arange(px, device=dev).expand(n, px).contiguous(),
        right=True)
    truth = rows[:, None] * (n + 1) + cols[rows]
    base = 0.05 + 0.4 * torch.rand((n * (n + 1), bands), generator=g,
                                   device=dev)
    yy = torch.arange(px, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(px, device=dev, dtype=torch.float32)[None, :]
    stack = torch.empty((T, px, px, bands), device=dev)
    valid = torch.empty((T, px, px), dtype=torch.bool, device=dev)
    for t in range(T):
        img = base[truth]
        season = 0.5 + 0.5 * math.sin(2 * math.pi * t / max(2, T))
        img[..., 1] = (img[..., 1] * (0.6 + 0.8 * season)).clamp(0.0, 1.0)
        img += 0.01 * torch.randn(img.shape, generator=g, device=dev)
        cloudy = torch.zeros((px, px), dtype=torch.bool, device=dev)
        blobs = torch.rand((CLOUD_BLOBS, 4), generator=g, device=dev)
        for cy, cx, ry, rx in blobs.tolist():
            ry, rx = (px * (1 / 20 + r * (1 / 8 - 1 / 20)) for r in (ry, rx))
            cloudy |= ((yy - cy * px) / ry) ** 2 + ((xx - cx * px) / rx) ** 2 < 1
        cloud = 0.7 + 0.02 * torch.randn(img.shape, generator=g, device=dev)
        stack[t] = torch.where(cloudy[..., None], cloud, img).clamp_(0.0, 1.0)
        valid[t] = ~cloudy
    return stack, valid, truth


def field_purity(torch, labels, truth, geo) -> float:
    """Mean over the found fields of the share of their pixels that lie in
    their majority ground-truth field (examples/field_segmentation.py:57-67),
    from one joint histogram of (label, truth) on the device."""
    lab = torch.from_numpy(labels).to(truth.device).long()
    fg = lab > 0
    n_truth = int(truth.max()) + 1
    keys, counts = torch.unique(lab[fg] * n_truth + truth[fg],
                                return_counts=True)
    ids, inv = torch.unique(keys // n_truth, return_inverse=True)
    total = torch.zeros_like(ids).index_add_(0, inv, counts)
    best = torch.zeros_like(ids).scatter_reduce_(0, inv, counts, "amax")
    found = torch.tensor([f["properties"]["field_id"] for f in geo["features"]],
                         device=truth.device)
    sel = torch.isin(ids, found)
    check(int(sel.sum()) == len(geo["features"]), "purity: features missing")
    return float((best[sel].double() / total[sel]).mean())


def seg_breakdown(torch, stack, valid, cfg, dev) -> dict:
    """segment_tile's steps, each timed on the host clock up to a
    synchronise: where a segmentation tile's time goes."""
    from functools import partial

    from repro_torch.apps.composite import cloud_score
    from repro_torch.apps.segmentation import (clean_edges,
                                               connected_components,
                                               polygonize)
    from repro_torch.convert import stack_to_device
    from repro_torch.kernels import ops

    timed = partial(synced, torch)
    (imgs, v), h2d_s = timed(lambda: stack_to_device(stack, valid, dev))
    valid_eff, cloud_s = timed(lambda: v & (cloud_score(imgs, cfg) < 0.5))
    (gsum, count), kernel_s = timed(lambda: ops.grad_mag(imgs, valid_eff))
    del imgs, v, valid_eff
    edges, threshold_s = timed(
        lambda: gsum / count.clamp_min(1.0) > cfg.edge_threshold)
    cleaned, clean_s = timed(lambda: clean_edges(edges))
    (labels, iterations), cc_s = timed(lambda: connected_components(~cleaned))
    labels, d2h_s = timed(lambda: labels.cpu().numpy())
    geo, poly_s = timed(lambda: polygonize(labels))
    return {"steps_s": {
                "host_to_device": h2d_s, "cloud_score_and_valid": cloud_s,
                "grad_mag_kernel": kernel_s, "threshold": threshold_s,
                "clean_edges": clean_s, "connected_components": cc_s,
                "device_to_host": d2h_s, "polygonize": poly_s},
            "cc_iterations": iterations, "edges": edges.cpu().numpy(),
            "labels": labels, "geo": geo}


def phase_seg_tile(torch, seed: int, backend, dev, px: int = 0) -> dict:
    from repro_torch.apps.segmentation import segment_tile, temporal_edges
    from repro_torch.configs.festivus_imagery import DEFAULT as cfg

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    px, T = px or cfg.segmentation_tile_px, cfg.temporal_depth
    (stack_t, valid_t, truth), synth_s = synced(
        torch, lambda: field_scene(torch, seed, T, px, cfg.bands, dev))
    cloud_cover = float((~valid_t).float().mean())
    (stack, valid), to_host_s = synced(
        torch, lambda: (stack_t.cpu().numpy(), valid_t.cpu().numpy()))
    del stack_t, valid_t
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    backend.reset_launch_counts()
    t1 = time.perf_counter()
    labels, geo = segment_tile(stack, valid, cfg, device=dev)
    tile_s = time.perf_counter() - t1
    launches = backend.launch_counts()
    check(launches["grad_mag"] == 1, f"segmentation tile: launches {launches}")
    check(labels.dtype == np.int32 and labels.shape == (px, px),
          "segmentation tile: labels dtype or shape")
    check(len(geo["features"]) > 0, "segmentation tile: no fields")

    steps = seg_breakdown(torch, stack, valid, cfg, dev)
    check(steps.pop("labels").tobytes() == labels.tobytes(),
          "segmentation tile: labels differ from the step-by-step chain")
    check(json.dumps(steps.pop("geo")) == json.dumps(geo),
          "segmentation tile: GeoJSON differs from the step-by-step chain")
    edges = steps.pop("edges")
    ref_edges = temporal_edges(stack, valid, cfg, impl="ref", device=dev)
    agreement = float((edges == ref_edges).mean())
    check(agreement > EDGE_AGREEMENT,
          f"segmentation tile: edges agree with impl='ref' on {agreement}")
    purity = field_purity(torch, labels, truth, geo)
    check(purity > MIN_PURITY, f"segmentation tile: purity {purity}")
    return {"phase": "segmentation_tile", "shape": [T, px, px, cfg.bands],
            "launches": launches, "fields_found": len(geo["features"]),
            "fields_true": int(torch.unique(truth).numel()),
            "purity": purity, "edge_agreement": agreement,
            "edges_identical": bool((edges == ref_edges).all()),
            "edge_fraction": float(edges.mean()), "cloud_cover": cloud_cover,
            "synth_s": synth_s, "to_host_s": to_host_s,
            "segment_tile_s": tile_s, "breakdown_s": steps.pop("steps_s"),
            "cc_iterations": steps.pop("cc_iterations"),
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "seconds": time.perf_counter() - t0}


def phase_seg_campaign(torch, backend, cs, names, dev) -> dict:
    from repro_torch.apps.segmentation import (run_segmentation_campaign,
                                               segment_to_store)
    from repro_torch.configs.festivus_imagery import DEFAULT as cfg

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    out = run_segmentation_campaign(cs, names, cfg, num_workers=4, device=dev)
    campaign_s = time.perf_counter() - t0
    launches = backend.launch_counts()
    report = out["report"]
    check(report.all_done and out["tiles"] == len(names),
          "segmentation campaign incomplete")
    check(launches["grad_mag"] >= len(names),
          f"segmentation campaign launches {launches}")
    fields = {}
    for n in names:
        single = segment_to_store(cs, n, cfg, out_prefix="fields_single",
                                  device=dev)
        got = cs.open(f"fields/{n}/labels").read_all()
        want = cs.open(f"fields_single/{n}/labels").read_all()
        check(got.dtype == want.dtype == np.int32
              and got.tobytes() == want.tobytes(),
              f"segmentation campaign: labels diverge on {n}")
        check(cs.fs.read(f"{cs.root}/fields/{n}/fields.geojson")
              == cs.fs.read(f"{cs.root}/fields_single/{n}/fields.geojson"),
              f"segmentation campaign: GeoJSON diverges on {n}")
        fields[n] = single["fields"]
    return {"phase": "segmentation_campaign", "tiles": len(names),
            "workers": report.nodes, "launches": launches,
            "byte_identical": True, "fields": fields,
            "queue": report.queue_stats,
            "retried_ops": report.festivus_stats.retried_ops,
            "campaign_s": campaign_s, "seconds": time.perf_counter() - t0}


#: one Landsat 8 OLI Level-1 frame at 30 m, about 7,800 x 7,900 px (USGS
#: Landsat 8 Data Users Handbook), in ImageryConfig.bands bands of uint16 DN
FRAME_H, FRAME_W = 7800, 7900
#: 512 x 512 x 4 f32 = 4 MiB tiles, Table IV's block optimum
#: (configs/festivus_imagery.py:32,43)
CAL_TILE_PX = 512
#: the campaign's scenes, cut from the frame's size to keep host synthesis
#: short (4 of 1024 px instead of 7800 x 7900)
CAL_SCENES, CAL_SCENE_PX = 4, 1024
#: the flaky store's failure rate: about 10 of the campaign's ~104 store
#: operations fail for any --seed (none with probability 0.9**104, 2e-5),
#: each retried by Festivus
CAL_FAILURE_RATE = 0.1
#: the tile-server example's trace and fleet (examples/tile_server.py:60-70),
#: its 16 px tiles scaled with the tile (a quarter of it) and its cache
#: (2 MiB of 4 KiB tiles) kept at 512 tiles
SERVE_SPIKE = (1.0, 1.6, 6.0)
SERVE_CACHE_TILES = 512
#: each port example and the kernels it must launch on the card
EXAMPLES = {"global_composite": ("GLOBAL_COMPOSITE_OK", ("composite",)),
            "field_segmentation": ("FIELD_SEGMENTATION_OK", ("grad_mag",)),
            "tile_server": ("TILE_SERVER_OK", ("composite",)),
            # smoke configs at attention_impl="ref", and the decode path
            "serve_lm": ("SERVE_LM_OK", ()),
            # the imagery steps on the card, then a smoke LM trained with
            # attention_impl="ref", as the JAX example
            "quickstart": ("QUICKSTART_OK", ("composite", "grad_mag")),
            # llama-100m at attention_impl="ref", as the JAX example
            "train_lm": ("TRAIN_LM_OK", ())}
EXAMPLE_TIMEOUT_S = 300


def tile_index(name: str):
    """'<scene>/t<ty>_<tx>' -> (ty, tx)."""
    ty, tx = name.rsplit("/t", 1)[1].split("_")
    return int(ty), int(tx)


def phase_calibration_scene(torch, seed: int, backend, dev) -> dict:
    from repro_torch.apps import calibration as cal
    from repro_torch.configs.festivus_imagery import DEFAULT as cfg
    from repro_torch.core import ChunkStore, Festivus, InMemoryObjectStore

    t0 = time.perf_counter()
    store = InMemoryObjectStore()
    cs = ChunkStore(Festivus(store), "raw")
    meta = cal.make_raw_scene(cs, "scenes/frame", FRAME_H, FRAME_W,
                              cfg.bands, seed=seed)
    synth_s = time.perf_counter() - t0
    out_cs = ChunkStore(cs.fs, "calibrated")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    backend.reset_launch_counts()
    t1 = time.perf_counter()
    res = cal.process_scene(cs, out_cs, "scenes/frame", tile_px=CAL_TILE_PX,
                            device=dev, timings=timings)
    scene_s = time.perf_counter() - t1
    launches = backend.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    raw = cs.open("scenes/frame/dn").read_all()
    t2 = time.perf_counter()
    rect, want = cal.calibrate_scene(raw, meta, "cpu")
    cpu_s = time.perf_counter() - t2
    check(list(rect) == res["rect"], f"calibration: rect {res['rect']}")
    check(want.dtype == np.float32 and want.shape[2] == cfg.bands,
          "calibration: reflectance dtype or shape")
    got = np.zeros_like(want)
    names = out_cs.list_arrays()
    for name in names:
        ty, tx = tile_index(name)
        tile = out_cs.open(name).read_all()
        got[ty * CAL_TILE_PX:ty * CAL_TILE_PX + tile.shape[0],
            tx * CAL_TILE_PX:tx * CAL_TILE_PX + tile.shape[1]] = tile
    check(got.tobytes() == want.tobytes(),
          "calibration: the card's reflectance differs from the CPU's")
    h, w, _ = want.shape
    nonzero = sum(bool(want[y:y + CAL_TILE_PX, x:x + CAL_TILE_PX].any())
                  for y in range(0, h, CAL_TILE_PX)
                  for x in range(0, w, CAL_TILE_PX))
    check(res["tiles"] == len(names) == nonzero > 0,
          f"calibration: {res['tiles']} tiles written, {len(names)} stored, "
          f"{nonzero} expected")
    check(np.isfinite(want).all() and want.min() >= 0.0
          and want.max() <= 1.5, "calibration: reflectance out of [0, 1.5]")
    return {"phase": "calibration_scene", "frame": [FRAME_H, FRAME_W,
                                                    cfg.bands],
            "dn_bytes": raw.nbytes, "reflectance_bytes": want.nbytes,
            "rect": res["rect"], "tile_px": CAL_TILE_PX,
            "launches": launches,
            "tiles": res["tiles"], "bit_identical_to_cpu": True,
            "valid_fraction": float((want.any(axis=-1)).mean()),
            "synth_s": synth_s, "process_scene_s": scene_s,
            "breakdown_s": timings, "cpu_calibration_s": cpu_s,
            "peak_device_bytes": peak,
            "seconds": time.perf_counter() - t0}


def phase_calibration_campaign(torch, seed: int, backend, dev) -> dict:
    from repro_torch.apps import calibration as cal
    from repro_torch.configs.festivus_imagery import DEFAULT as cfg
    from repro_torch.core import (ChunkStore, Festivus, FlakyObjectStore,
                                  InMemoryObjectStore)

    t0 = time.perf_counter()
    inner = InMemoryObjectStore()
    cs_raw = ChunkStore(Festivus(inner), "raw")
    keys = [f"scenes/s{i}" for i in range(CAL_SCENES)]
    for i, k in enumerate(keys):
        cal.make_raw_scene(cs_raw, k, CAL_SCENE_PX, CAL_SCENE_PX, cfg.bands,
                           seed=seed * 100 + i)
    synth_s = time.perf_counter() - t0
    flaky = FlakyObjectStore(inner, failure_rate=CAL_FAILURE_RATE,
                             seed=seed)
    cs = ChunkStore(Festivus(flaky, meta=cs_raw.fs.meta), "raw")

    torch.cuda.synchronize()
    backend.reset_launch_counts()
    t1 = time.perf_counter()
    out = cal.run_campaign(cs, cs, keys, num_workers=4, tile_px=CAL_TILE_PX,
                           device=dev)
    campaign_s = time.perf_counter() - t1
    launches = backend.launch_counts()
    report = out["report"]
    check(report.all_done and out["scenes"] == CAL_SCENES,
          "calibration campaign incomplete")
    check(flaky.injected_failures > 0,
          "calibration campaign: no store failure was injected")

    single = ChunkStore(cs_raw.fs, "single")
    for k in keys:
        check(cal.process_scene(cs_raw, single, k, tile_px=CAL_TILE_PX,
                                device=dev) == out["results"][k],
              f"calibration campaign: result differs on {k}")
    got = [n for n in cs_raw.list_arrays() if "/t" in n]
    want = single.list_arrays()
    check(sorted(got) == sorted(want) and want,
          "calibration campaign: tiles differ from the single process")
    for name in want:
        check(cs_raw.open(name).read_all().tobytes()
              == single.open(name).read_all().tobytes(),
              f"calibration campaign diverges on {name}")
    return {"phase": "calibration_campaign", "scenes": CAL_SCENES,
            "scene_px": CAL_SCENE_PX, "tile_px": CAL_TILE_PX,
            "reduced": f"{CAL_SCENES} scenes of {CAL_SCENE_PX} px, not "
                       f"{FRAME_H} x {FRAME_W} frames: host synthesis",
            "workers": report.nodes, "launches": launches,
            "tiles": len(want), "byte_identical": True,
            "queue": report.queue_stats,
            "failure_rate": CAL_FAILURE_RATE,
            "injected_store_failures": flaky.injected_failures,
            "retried_ops": report.festivus_stats.retried_ops,
            "synth_s": synth_s, "campaign_s": campaign_s,
            "seconds": time.perf_counter() - t0}


def phase_tile_serving(cs, names) -> dict:
    from repro_torch.serve import (Spike, TileFleet, TileRequest, TileServer,
                                   tile_bounds, tile_universe,
                                   zipf_spike_trace)

    t0 = time.perf_counter()
    target = f"composite/{names[0]}"
    arr = cs.open(target)
    levels = arr.spec.pyramid_levels
    tile_px = arr.spec.shape[0] // 4
    tile_bytes = tile_px * tile_px * arr.spec.shape[2] * 4
    universe = tile_universe(arr.spec.shape, levels, tile_px, array=target)
    spike = Spike(*SERVE_SPIKE)
    trace = zipf_spike_trace(universe, duration_s=3.0, base_rps=60.0,
                             alpha=1.1, spikes=(spike,), seed=11)
    fleet = TileFleet(cs.fs.store.inner, cs.fs.meta, root=cs.root, servers=2,
                      tile_px=tile_px,
                      cache_bytes=SERVE_CACHE_TILES * tile_bytes)
    rep = fleet.run(trace)
    run_s = time.perf_counter() - t0
    check(rep.all_served and rep.requests == len(trace),
          f"tile serving: {rep.completed} of {rep.requests} served")

    srv = TileServer(cs, tile_px=tile_px, cache_bytes=tile_bytes)
    for _, level, x, y in universe:
        got = srv.serve(TileRequest(0.0, level, x, y, array=target)).data
        start, stop = tile_bounds(arr.level_shape(level), tile_px, x, y)
        check(got.tobytes() == arr.read(start, stop, level=level).tobytes(),
              f"tile serving: tile ({level}, {x}, {y}) differs")
    return {"phase": "tile_serving", "array": target,
            "shape": list(arr.spec.shape), "levels": levels,
            "tile_px": tile_px, "universe_tiles": len(universe),
            "requests": rep.requests, "servers": rep.servers,
            "all_served": True, "byte_identical_tiles": len(universe),
            "hit_rate": rep.hit_rate, "cache_evictions": rep.cache_evictions,
            "virtual_p50_s": rep.p50_s, "virtual_p99_s": rep.p99_s,
            "virtual_spike_p99_s": rep.window_percentile(
                99, spike.t0, spike.t1 + 0.2),
            "fleet_run_s": run_s, "seconds": time.perf_counter() - t0}


def phase_examples() -> dict:
    """Each port example in its own process on the card, all four at
    once; each prints its kernels' launch counts after its marker."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    try:
        for name in EXAMPLES:
            code = ("import json, runpy\n"
                    "from repro_torch.kernels import backend\n"
                    f"runpy.run_module('repro_torch.examples.{name}', "
                    "run_name='__main__')\n"
                    "print(json.dumps(backend.launch_counts()))\n")
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", code], cwd=ROOT, env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        results = {}
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
            check(proc.returncode == 0,
                  f"example {name} exited {proc.returncode}: {err[-2000:]}")
            lines = out.rstrip().splitlines()
            marker, kernels = EXAMPLES[name]
            check(len(lines) >= 2 and lines[-2] == marker,
                  f"example {name}: no {marker}")
            launches = json.loads(lines[-1])
            check(all(launches.get(k, 0) > 0 for k in kernels),
                  f"example {name}: launches {launches}")
            results[name] = {"marker": marker, "launches": launches,
                             "lines": len(lines)}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"phase": "examples", "examples": results,
            "seconds": time.perf_counter() - t0}


def param_leaves(params):
    if isinstance(params, dict):
        for v in params.values():
            yield from param_leaves(v)
    elif isinstance(params, list):
        for v in params:
            yield from param_leaves(v)
    else:
        yield params


def logits_diff(torch, got, want, rows: int = 256) -> dict:
    """Relative L2 error, max abs difference and argmax agreement of two
    [B, S, V] logits tensors, in f32 a slice of ``rows`` positions at a
    time (the full logits are 2.1 GB in bf16)."""
    num = den = max_abs = 0.0
    agree = 0
    B, S, _ = got.shape
    for b in range(B):
        for s0 in range(0, S, rows):
            a = got[b, s0:s0 + rows].float()
            w = want[b, s0:s0 + rows].float()
            d = a - w
            num += float((d * d).sum(dtype=torch.float64))
            den += float((w * w).sum(dtype=torch.float64))
            max_abs = max(max_abs, float(d.abs().max()))
            agree += int((a.argmax(-1) == w.argmax(-1)).sum())
    return {"rel_l2": (num / den) ** 0.5, "max_abs_diff": max_abs,
            "argmax_agreement": agree / (B * S)}


def all_finite(torch, logits, rows: int = 256) -> bool:
    """Whether every value of [B, S, V] ``logits`` is finite, ``rows``
    positions at a time (prefill_32k's logits hold 4.2e9 elements)."""
    B, S, _ = logits.shape
    return all(bool(torch.isfinite(logits[b, s0:s0 + rows]).all())
               for b in range(B) for s0 in range(0, S, rows))


def plain_prefill(model, params, inputs):
    """The same weights through both kernels' plain versions: attention
    with attention_impl="chunked", the SSD with ssd_impl="chunked"."""
    from repro_torch.models import build
    from repro_torch.train import make_prefill

    plain = make_prefill(build(dataclasses.replace(
        model.cfg, attention_impl="chunked")))
    return plain(params, **inputs, ssd_impl="chunked")


def library_prefill(model, params, inputs):
    """The same weights with ``sdpa_attention`` (PyTorch's fused attention,
    a yardstick) in place of the flash kernel; the SSD's kernel stays."""
    from repro_torch.kernels import ops
    from repro_torch.train import make_prefill

    with patched(ops, "flash_attention", lambda _: sdpa_attention):
        return make_prefill(model)(params, **inputs)


class LMPhase(NamedTuple):
    """One LM's serving phases: its arch, the depth it is cut to (None: the
    config's own), the prefill logits' relative L2 limit against the plain
    run, the same with the plain run routed as the kernel run was (MoE
    models; None otherwise), the activations' and KV cache's dtype of the
    decode-against-prefill check (None: the model's own), whether it
    runs the generate phase, the prefill's requests and positions each,
    and the layers its per-layer hold covers: each kernel's first and last
    ``held_ends`` calls (None: every one)."""

    arch: str
    layers: Optional[int]
    rel_l2_limit: float
    held_routes_rel_l2_limit: Optional[float]
    check_dtype: Optional[str]
    generate: bool
    requests: int = PREFILL_BATCH
    tokens_each: int = PREFILL_LEN
    held_ends: Optional[int] = None


# mamba2-2.7b's 64 bf16 layers amplify one-ulp differences past
# PREFILL_REL_L2 and the decode criterion, whatever the SSD's
# implementation: see PERF.md §6 for tools/depth_spread.py's readings and
# the chip's.  So its kernel is held layer by layer on the bf16 serving run
# (ssd_layers), its logits to MAMBA_PREFILL_REL_L2, and its decode check
# runs with f32 activations over the same bf16-stored weights.  Every
# kernel is held layer by layer (LAYER_HOLDS): the bf16 tensor-core flash
# kernel rounds P to bf16, so its depth error is read per layer as well as
# in the logits.  The MoE models are cut in depth to fit the card at full
# width (dbrx 8 of 40 layers, 54.6 GB; maverick 1 of 48, 36.7 GB; jamba 16
# of 32, two super-blocks, 52.0 GB); their logits are held as
# MOE_PREFILL_REL_L2 says, and their decode checks run at capacity factor
# E, as tests/test_models.py:84-85 does, in f32 activations and an f32 KV
# cache: with the bf16 cache (the JAX package's whatever the activations'
# dtype), its rounding alone flips routes between decode and prefill
# (tools/moe_spread.py's decode_vs_prefill).  qwen2-72b is cut to 16 of its
# 80 layers: 8.78e8 parameters a layer (attention 1.51e8, the FFN 7.27e8)
# and two untied vocabulary matrices of 1.25e9, 16.5e9 parameters, 33.1 GB
# in bf16.  The last two rows are prefill_32k at full width and depth, one
# of its 32 rows: [1, 32768] tokens, logits [1, 32768, V] (llama3-8b's 4.2e9
# elements, 8.4 GB in bf16).  They do not generate: greedy_generate feeds
# the prompt one token at a time (train/serve_step.py), so a 32k prompt
# would be 32,768 decode steps, none of which launches a kernel.  At this
# length the plain attention takes 0.85 s a layer, so llama's per-layer
# hold covers its first two and last two layers; the plain SSD takes 31 ms
# a layer, so mamba's covers all 64.
LM_PHASES = {
    "llama": LMPhase(LLAMA, None, PREFILL_REL_L2, None, None, True),
    "mamba": LMPhase(MAMBA, None, MAMBA_PREFILL_REL_L2, None, "float32",
                     True),
    "dbrx": LMPhase(DBRX, 8, MOE_PREFILL_REL_L2, PREFILL_REL_L2, "float32",
                    True),
    "maverick": LMPhase(MAVERICK, 1, MOE_PREFILL_REL_L2, PREFILL_REL_L2,
                        "float32", True),
    "jamba": LMPhase(JAMBA, 16, MOE_PREFILL_REL_L2, MAMBA_PREFILL_REL_L2,
                     "float32", True),
    "gemma": LMPhase(GEMMA, None, PREFILL_REL_L2, None, None, True),
    "seamless": LMPhase(SEAMLESS, None, PREFILL_REL_L2, None, "float32",
                        True),
    "internvl": LMPhase(INTERNVL, None, PREFILL_REL_L2, None, "float32",
                        True),
    "qwen": LMPhase(QWEN, None, PREFILL_REL_L2, None, None, True),
    "qwen72": LMPhase(QWEN72, 16, PREFILL_REL_L2, None, None, True),
    "llama_32k": LMPhase(LLAMA, None, PREFILL_REL_L2, None, None, False,
                         1, PREFILL_32K_LEN, held_ends=2),
    "mamba_32k": LMPhase(MAMBA, None, MAMBA_PREFILL_REL_L2, None, None,
                         False, 1, PREFILL_32K_LEN),
}


def lm_config(which: str):
    from repro_torch.configs import get_config

    phase = LM_PHASES[which]
    cfg = get_config(phase.arch)
    if phase.layers:
        cfg = dataclasses.replace(cfg, num_layers=phase.layers)
    return cfg


def expected_launches(cfg) -> dict:
    """Each LM kernel's launches in one prefill: flash once per attention
    layer (an enc-dec model: once per encoder layer, twice per decoder
    layer, self- and cross-attention), the SSD once per mamba layer."""
    from repro_torch.models.transformer import layer_plan

    if cfg.is_encdec:
        return {"flash_attention": cfg.enc_layers + 2 * cfg.num_layers,
                "ssd_scan": 0}
    plan = layer_plan(cfg)
    return {"flash_attention": sum(m == "attn" for m, _ in plan),
            "ssd_scan": sum(m == "mamba" for m, _ in plan)}


def expected_generate_launches(cfg, steps: int) -> dict:
    """Each LM kernel's launches in one greedy_generate of ``steps`` decode
    steps: an enc-dec model encodes once (flash once per encoder layer)
    and cross-attends through flash in every decoder layer of every step;
    any other decode path launches no kernel."""
    return {"flash_attention": (cfg.enc_layers + steps * cfg.num_layers
                                if cfg.is_encdec else 0),
            "ssd_scan": 0}


def lm_inputs(torch, cfg, g, batch: int, positions: int) -> dict:
    """A request batch of ``positions`` positions each, drawn from ``g``:
    tokens; an enc-dec model's decoder tokens and ``max(128, positions //
    4)`` frames, a VLM's ``frontend_tokens`` patch embeddings before
    ``positions - frontend_tokens`` tokens (bf16, as
    ``repro/models/model_zoo.py:input_specs`` gives them)."""
    text = positions - cfg.frontend_tokens
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, (batch, text),
                                      generator=g, device="cuda")}
    frames = (max(128, positions // 4) if cfg.is_encdec
              else cfg.frontend_tokens)
    if frames:
        inputs["frontend"] = torch.randn(
            (batch, frames, cfg.frontend_dim or cfg.d_model), generator=g,
            device="cuda", dtype=torch.bfloat16)
    return inputs


@contextlib.contextmanager
def patched(module, name: str, wrap):
    """Inside, ``module.<name>`` is ``wrap(<the original>)``; the original
    is put back on the way out."""
    original = getattr(module, name)
    setattr(module, name, wrap(original))
    try:
        yield
    finally:
        setattr(module, name, original)


@contextlib.contextmanager
def recorded_routes():
    """Record each MoE layer's top-k experts (``moe.route``) while inside;
    yields the list they are appended to, on the device."""
    from repro_torch.models import moe

    seen = []

    def wrap(route):
        def record(*args, **kw):
            r = route(*args, **kw)
            seen.append(r.topk_idx)
            return r
        return record

    with patched(moe, "route", wrap):
        yield seen


def held_routes(routes):
    """Inside, each MoE layer, in call order, routes to the experts
    ``routes`` holds (another run's top-k), with this run's own
    probabilities."""
    from repro_torch.models import moe

    given = iter(routes)

    def held(probs, k):
        idx = next(given)
        return probs.gather(-1, idx), idx

    return patched(moe, "top_k", lambda _: held)


def route_flips(torch, got, want) -> Optional[dict]:
    """The share of (token, k) assignments whose expert is not among the
    other run's top-k for that token, over every MoE layer; and the share
    of tokens with such an assignment in some layer."""
    if not got:
        return None
    check(len(got) == len(want), f"routes: {len(got)} against {len(want)}")
    flipped = assignments = 0
    token_flipped = None
    for a, b in zip(got, want):
        missing = ~(a[..., :, None] == b[..., None, :]).any(-1)  # [B,S,K]
        flipped += int(missing.sum())
        assignments += missing.numel()
        tok = missing.any(-1)
        token_flipped = tok if token_flipped is None else token_flipped | tok
    return {"moe_layers": len(got), "assignments": assignments,
            "flipped": flipped, "share": flipped / assignments,
            "tokens_flipped_share": float(token_flipped.float().mean())}


def make_held(torch, op: str, plain, tol, l2_limit, held: dict, kernel):
    """``kernel`` (``ops.<op>``) with its output held against ``plain`` on
    the same inputs, within ``tol`` elementwise and ``l2_limit`` relative
    L2, at the calls ``held["layers"]`` lists (None: every call); each call
    counts in ``held["calls"]``, each held one appends its errors."""
    def call(*args, impl="auto", chunk=None, **kw):
        check(impl == "auto" and args[0].is_cuda, f"{op} layers: impl {impl}")
        layer = held["calls"]
        held["calls"] += 1
        got = kernel(*args, **kw)
        if held["layers"] is not None and layer not in held["layers"]:
            return got
        want = plain(*args, **kw)
        xd = str(got.dtype).removeprefix("torch.")
        torch.testing.assert_close(got.float(), want.float(), rtol=tol[xd],
                                   atol=tol[xd], msg=f"{op}, layer {layer}")
        held["held"].append(layer)
        held["errs"].append(float((got.float() - want.float()).abs().max()))
        held["l2s"].append(rel_l2(torch, got, want))
        check(held["l2s"][-1] < l2_limit[xd], f"{op}, layer {layer}: "
              f"relative L2 {held['l2s'][-1]} >= {l2_limit[xd]}")
        return got

    return call


def held_calls(n: int, ends: Optional[int]) -> Optional[list]:
    """Which of a kernel's ``n`` calls in a prefill the per-layer hold
    covers: the first and the last ``ends``; None (every call) where
    ``ends`` is None or the two ends meet."""
    if ends is None or 2 * ends >= n:
        return None
    return [*range(ends), *range(n - ends, n)]


def held_layers(torch, model, params, inputs, expected: dict,
                ends: Optional[int] = None) -> dict:
    """One bf16 prefill with each layer's kernel held against its plain
    version on that layer's own inputs (LAYER_HOLDS), every kernel of the
    model at once: each kernel's first and last ``ends`` calls (None:
    every call).  Returns, per kernel, the layers held and the largest and
    median errors over them."""
    from repro_torch.kernels import ops
    from repro_torch.train import make_prefill

    holds = {}
    with contextlib.ExitStack() as stack:
        for kernel, n in expected.items():
            if not n:
                continue
            key, op, plain, tol, l2_limit = LAYER_HOLDS[kernel]
            held = {"layers": held_calls(n, ends), "calls": 0, "held": [],
                    "errs": [], "l2s": []}
            holds[key] = (held, tol, l2_limit, n, op)
            stack.enter_context(patched(ops, op, functools.partial(
                make_held, torch, op, plain, tol, l2_limit, held)))
        make_prefill(model)(params, **inputs)
    out = {}
    for key, (held, tol, l2_limit, n, op) in holds.items():
        errs, l2s = held["errs"], held["l2s"]
        want = list(range(n)) if held["layers"] is None else held["layers"]
        check(held["calls"] == n and held["held"] == want,
              f"{op} layers: {held['calls']} calls, {held['held']} held; "
              f"{n} calls and {want} expected")
        out[key] = {"layers": n, "held_layers": held["held"],
                    "max_abs_err": max(errs),
                    "median_abs_err": statistics.median(errs),
                    "max_rel_l2": max(l2s),
                    "median_rel_l2": statistics.median(l2s),
                    "tol": tol["bfloat16"],
                    "rel_l2_limit": l2_limit["bfloat16"]}
    return out


def plain_ssd(x, dt, a, b, c, *, d_skip=None):
    """The chunked plain version; b and c, one group [B, L, 1, N] as the
    model hands them to ops.ssd, expanded to every head."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import expand_heads

    H = x.shape[2]
    return ref.ssd_scan_chunked(x, dt, a, expand_heads(b, H),
                                expand_heads(c, H), chunk=SSD_CHUNK,
                                d_skip=d_skip)


def plain_attention(q, k, v, causal=True):
    from repro_torch.kernels import ref

    return ref.attention_chunked(q, k, v, causal=causal)


# kernel -> (its line's key, its ops entry point, the plain version, the
# elementwise and relative-L2 limits) for the per-layer hold
LAYER_HOLDS = {
    "flash_attention": ("flash_layers", "flash_attention", plain_attention,
                        TOL, FLASH_REL_L2),
    "ssd_scan": ("ssd_layers", "ssd", plain_ssd, SSD_TOL, SSD_REL_L2)}


def phase_prefill(torch, seed: int, backend, which: str):
    """An LM at full width (and depth, unless LM_PHASES cuts it): the
    row's requests of its positions each (4 of 2048 unless it says
    otherwise) through ``make_prefill`` (lm_inputs: an enc-dec model's 2048
    decoder tokens on 512 frames, a VLM's 256 patch embeddings and 1792
    tokens), each kernel launched once per layer of its kind, logits held
    against the plain run (with the share of MoE routing that differs
    between the two runs).  Returns (line, model, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models.model_zoo import padded_vocab
    from repro_torch.train import make_prefill

    phase = LM_PHASES[which]
    t0 = time.perf_counter()
    cfg = lm_config(which)
    check(cfg.dtype == "bfloat16" and cfg.attention_impl == "auto",
          f"{cfg.arch_id}: dtype {cfg.dtype}, attention_impl "
          f"{cfg.attention_impl}")
    expected = expected_launches(cfg)
    model = build(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, init_s = synced(torch, lambda: model.init(seed))
    leaves = list(param_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    check(all(t.is_cuda for t in leaves), f"{which}: params off the card")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    requests, tokens_each = phase.requests, phase.tokens_each
    inputs = lm_inputs(torch, cfg, g, requests, tokens_each)
    prefill = make_prefill(model)
    # the first prefill's logits are freed before the timed one, as a
    # server frees a response, so the timed run reuses the first one's
    # blocks (prefill_watch counts the cudaMalloc calls it still makes)
    first_s = synced(torch, lambda: prefill(params, **inputs))[1]
    backend.reset_launch_counts()
    with recorded_routes() as routes:
        logits, prefill_s, prefill_watch = watched(
            torch, lambda: prefill(params, **inputs))
    launches = backend.launch_counts()
    check(all(launches[k] == n for k, n in expected.items()),
          f"{which} prefill: launches {launches}, expected {expected}")
    check(tuple(logits.shape) == (requests, tokens_each, padded_vocab(cfg))
          and logits.dtype == torch.bfloat16, f"{which} prefill: logits shape")
    check(all_finite(torch, logits), f"{which} prefill: non-finite")
    # a prefill longer than the 4 x 2048 one (prefill_32k's 1.6 s) is
    # repeated and profiled once, not twice and thrice: the script's time
    long = requests * tokens_each > PREFILL_BATCH * PREFILL_LEN
    repeats = [watched(torch, lambda: prefill(params, **inputs))[1:]
               for _ in range(1 if long else 2)]

    with recorded_routes() as plain_routes:
        want, plain_s = synced(torch, lambda: plain_prefill(model, params,
                                                            inputs))
    flips = route_flips(torch, routes, plain_routes)
    diff = logits_diff(torch, logits, want)
    if not routes:  # nothing more to hold it against: freed before the next
        del logits
    # the same prefill with PyTorch's attention in place of the kernel,
    # against the same plain run: how far a library's bf16 attention (P
    # rounded to bf16 as well) moves these logits
    library, library_s = synced(torch, lambda: library_prefill(
        model, params, inputs))
    library_diff = logits_diff(torch, library, want)
    del want, plain_routes, library
    held_diff = None
    if routes:
        with held_routes(routes):
            want = plain_prefill(model, params, inputs)
        held_diff = logits_diff(torch, logits, want)
        del want, logits
    del routes
    torch.cuda.empty_cache()
    holds = held_layers(torch, model, params, inputs, expected,
                        phase.held_ends)
    breakdown = profile_breakdown(torch, lambda: prefill(params, **inputs),
                                  runs=1 if long else 3)
    moe_ms = (moe_step_ms(torch, lambda: prefill(params, **inputs))
              if cfg.is_moe else None)
    peak = torch.cuda.max_memory_allocated()
    line = {"phase": f"{which}_prefill", "arch": cfg.arch_id,
            "requests": requests, "tokens_each": tokens_each,
            "frontend_shape": (list(inputs["frontend"].shape)
                               if "frontend" in inputs else None),
            "layers": cfg.num_layers, "enc_layers": cfg.enc_layers,
            "full_layers": get_config(phase.arch).num_layers,
            "d_model": cfg.d_model, "params": n_params,
            "param_bytes": param_bytes, "init_s": init_s,
            "first_prefill_s": first_s, "prefill_s": prefill_s,
            "prefill_watch": prefill_watch,
            "repeat_prefill_s": [r[0] for r in repeats],
            "repeat_watch": [r[1] for r in repeats],
            "tokens_per_s": requests * tokens_each / prefill_s,
            "launches": launches, "expected_launches": expected,
            "plain_prefill_s": plain_s, "vs_plain": diff,
            "library_prefill_s": library_s, "library_vs_plain": library_diff,
            "rel_l2_limit": phase.rel_l2_limit, "route_flips": flips,
            "vs_plain_held_routes": held_diff,
            "held_routes_rel_l2_limit": phase.held_routes_rel_l2_limit,
            **holds, "peak_device_bytes": peak, "breakdown": breakdown,
            "moe_step_ms": moe_ms}
    check(diff["rel_l2"] < phase.rel_l2_limit, f"{which} prefill: relative "
          f"L2 {diff['rel_l2']} against the plain run (route flips {flips}; "
          f"SDPA in place of the kernel: {library_diff['rel_l2']})")
    check(held_diff is None
          or held_diff["rel_l2"] < phase.held_routes_rel_l2_limit,
          f"{which} prefill: relative L2 {held_diff} against the plain run "
          "routed as the kernel run")
    line["seconds"] = time.perf_counter() - t0
    return line, model, params


def phase_generate(torch, seed: int, backend, model, params,
                   which: str) -> dict:
    """greedy_generate twice on the same prompts, then the prompts' decode
    logits against make_prefill's.  The decode path launches no kernel (the
    JAX package has no decode kernel), except an enc-dec model's: its
    encoder and its cross-attention in every step and layer
    (expected_generate_launches); the check's prefill launches each one
    once per layer of its kind.  An enc-dec model decodes against the
    memory of 512 frames; a VLM generates from its prompt alone, without
    the image prefix, and its check runs without it, as the JAX package's
    greedy_generate and tests do (tests/test_models.py:100-101).  The
    check's KV cache takes the check's dtype.  An MoE model's check runs at
    capacity factor E, so that its prefill drops nothing, reports the
    tokens routed differently in the two runs, and allows one position
    whose logits differ through a router near-tie
    (tests/test_models.py:117-124)."""
    from repro_torch.models import build, encdec
    from repro_torch.models.model_zoo import _padded_cfg
    from repro_torch.models.transformer import init_block_caches
    from repro_torch.train import (greedy_generate, make_decode_step,
                                   make_prefill)

    phase = LM_PHASES[which]
    t0 = time.perf_counter()
    cfg = model.cfg
    expected = expected_launches(cfg)
    steps = GEN_PROMPT + GEN_NEW
    expected_gen = expected_generate_launches(cfg, steps)
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    prompt = torch.randint(0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT),
                           generator=g, device="cuda", dtype=torch.int32)
    # the frontend a request carries: an enc-dec model's frames (those of a
    # 2048-position prefill), a VLM's patch embeddings (which generation
    # ignores, as in the JAX package)
    frontend = lm_inputs(torch, cfg, g, GEN_BATCH, PREFILL_LEN).get(
        "frontend")
    max_len = GEN_PROMPT + GEN_NEW + 1

    def generate():
        return greedy_generate(model, params, prompt, GEN_NEW, max_len=max_len,
                               frontend=frontend)

    backend.reset_launch_counts()
    out, gen_s = synced(torch, generate)
    gen_launches = backend.launch_counts()
    again, again_s = synced(torch, generate)
    check(tuple(out.shape) == (GEN_BATCH, GEN_NEW) and out.dtype == torch.int32,
          "generate: tokens shape or dtype")
    check(0 <= int(out.min()) and int(out.max()) < cfg.vocab_size,
          "generate: token outside the vocabulary")
    check(torch.equal(out, again), "generate: two runs differ")
    check(all(gen_launches[k] == expected_gen.get(k, 0)
              for k in gen_launches),
          f"{which} generate: decode launched {gen_launches}, expected "
          f"{expected_gen}")

    def decode_state(m, batch, dtype):
        """A decode state for ``m`` (an enc-dec model's holds the memory's
        cross K/V) with its KV caches in ``dtype``."""
        if cfg.is_encdec:
            pcfg = _padded_cfg(m.cfg)
            return encdec.init_decode_state(
                params, pcfg, encdec.encode(params, pcfg, frontend), batch,
                max_len, dtype)
        return init_block_caches(m.cfg, batch, max_len, prompt.device, dtype)

    change = {}
    if phase.check_dtype:
        change["dtype"] = phase.check_dtype
    if cfg.is_moe:
        change["capacity_factor"] = float(cfg.num_experts)
    checked = build(dataclasses.replace(cfg, **change)) if change else model
    step = make_decode_step(checked)
    # the KV cache in the check's dtype (the served path's is bf16)
    state = decode_state(checked, GEN_BATCH,
                         getattr(torch, phase.check_dtype or "bfloat16"))
    outs = []
    with recorded_routes() as step_routes:
        for t in range(GEN_PROMPT):
            state, logits = step(params, state, prompt[:, t:t + 1])
            outs.append(logits)
    decoded = torch.cat(outs, dim=1)
    del state, outs
    backend.reset_launch_counts()
    with recorded_routes() as prefill_routes:
        full = make_prefill(checked)(
            params, tokens=prompt,
            **({"frontend": frontend} if cfg.is_encdec else {}))
    torch.cuda.synchronize()
    prefill_launches = backend.launch_counts()
    layers = len(prefill_routes)
    check_flips = route_flips(torch, [torch.cat(step_routes[i::layers], 1)
                                      for i in range(layers)],
                              prefill_routes)
    del step_routes, prefill_routes
    check(all(prefill_launches[k] == n for k, n in expected.items()),
          f"{which} generate: prefill launches {prefill_launches}")
    diff = logits_diff(torch, decoded, full)
    check(diff["argmax_agreement"] > DECODE_AGREEMENT,
          f"decode/prefill argmax agreement {diff['argmax_agreement']}")
    near_ties = None
    if cfg.is_moe:
        pos_diff = (decoded.float() - full.float()).abs().amax(dim=(0, 2))
        near_ties = int((pos_diff > DECODE_ATOL).sum())
        check(near_ties <= MOE_NEAR_TIE_POSITIONS,
              f"{which}: decode and prefill differ by more than "
              f"{DECODE_ATOL} at {near_ties} positions")
    else:
        torch.testing.assert_close(decoded.float(), full.float(),
                                   rtol=DECODE_RTOL, atol=DECODE_ATOL,
                                   msg="decode path against prefill")
    del decoded, full, checked
    torch.cuda.empty_cache()
    step = make_decode_step(model)
    state = decode_state(model, GEN_BATCH, torch.bfloat16)
    for t in range(GEN_PROMPT):
        state, _ = step(params, state, prompt[:, t:t + 1])
    token = prompt[:, -1:]
    breakdown = profile_breakdown(torch, lambda: step(params, state, token))
    return {"phase": f"{which}_generate", "arch": cfg.arch_id,
            "layers": cfg.num_layers, "requests": GEN_BATCH,
            "prompt_tokens": GEN_PROMPT, "new_tokens": GEN_NEW,
            "decode_steps": steps, "generate_s": gen_s,
            "repeat_generate_s": again_s, "step_ms": gen_s / steps * 1e3,
            "new_tokens_per_s": GEN_BATCH * GEN_NEW / gen_s,
            "decode_tokens_per_s": GEN_BATCH * steps / gen_s,
            "identical_twice": True, "generated": out[0].tolist(),
            "launches": gen_launches, "expected_launches": expected_gen,
            "frontend_shape": (list(frontend.shape) if frontend is not None
                               else None),
            "prefill_check_launches": prefill_launches,
            "decode_vs_prefill": diff,
            "criterion": {"argmax_agreement": DECODE_AGREEMENT,
                          "rtol": DECODE_RTOL, "atol": DECODE_ATOL,
                          "moe_near_tie_positions": MOE_NEAR_TIE_POSITIONS},
            "near_tie_positions": near_ties, "check_route_flips": check_flips,
            "checked_in": change.get("dtype", cfg.dtype),
            "checked_capacity_factor": change.get("capacity_factor"),
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "decode_step_breakdown": breakdown,
            "seconds": time.perf_counter() - t0}


def train_args(seed: int, arch: str = LLAMA, **change) -> argparse.Namespace:
    """launch.train's command line for a training phase: the corpus in
    memory, a checkpoint (raw chunks) at the last step, every step
    logged."""
    from repro_torch.launch import train as ptrain

    args = ptrain.parser().parse_args([
        "--arch", arch, "--variant", "full", "--steps", str(TRAIN_STEPS),
        "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
        "--lr", str(TRAIN_LR), "--warmup", str(TRAIN_WARMUP),
        "--seed", str(seed), "--ckpt-every", str(TRAIN_STEPS),
        "--ckpt-codec", "raw", "--log-every", "1"])
    return argparse.Namespace(**{**vars(args), **change})


def first_step_grads(torch, model, params, batch):
    """The loss and every parameter's gradient of one step (the train
    step's own loss and autograd call, without the update)."""
    from repro_torch.train import make_loss_fn
    from repro_torch.train import optimizer as opt_mod

    leaves = opt_mod.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = make_loss_fn(model)(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), grads


def grads_diff(torch, got, want, names) -> dict:
    """Each gradient leaf's relative L2 distance (``want`` may wait on the
    host: each leaf is copied to ``got``'s device in turn); the largest,
    and its leaf."""
    l2 = [rel_l2(torch, a, b.to(a.device)) for a, b in zip(got, want)]
    worst = max(range(len(l2)), key=l2.__getitem__)
    return {"max_rel_l2": l2[worst], "worst_leaf": names[worst],
            "median_rel_l2": statistics.median(l2)}


def leaf_names(params) -> list:
    """'/'-joined paths of the leaves in optimizer.tree_leaves' order."""
    if isinstance(params, dict):
        return [f"{k}/{n}" if n else k for k in sorted(params)
                for n in leaf_names(params[k])]
    if isinstance(params, list):
        return [f"{i}/{n}" if n else str(i) for i, v in enumerate(params)
                for n in leaf_names(v)]
    return [""]


def phase_llama_train(torch, seed: int, backend) -> dict:
    """llama3-8b at full width, 2 of 32 layers, trained through
    launch.train's code path on the card: (a) the first step's loss and
    gradients against the plain-attention step, (b) the flash kernels'
    launches per step, (c) a falling nll over TRAIN_STEPS steps, (d)
    --resume from the last step's checkpoint, the state it restores
    bit-identical to the saved one, (e) step time, tokens/s, peak memory
    and a profiler breakdown of one step."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset, write_corpus
    from repro_torch.kernels import ops
    from repro_torch.launch import train as ptrain
    from repro_torch.models import build
    from repro_torch.train import make_train_step
    from repro_torch.train import optimizer as opt_mod

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(LLAMA),
                              num_layers=LLAMA_TRAIN_LAYERS)
    check(cfg.dtype == "bfloat16" and cfg.attention_impl == "auto"
          and cfg.remat and cfg.remat_policy == "full",
          f"llama_train config {cfg}")
    L = cfg.num_layers
    per_step = {"flash_attention": 2 * L, "flash_attention_bwd": L}
    args = train_args(seed)
    cs = ptrain.make_store(None)
    spec = ptrain.corpus_spec(args, cfg)
    write_corpus(cs, spec)
    first = next(TokenDataset(cs, spec).batches(args.batch, args.seq))
    batch = {k: torch.as_tensor(first[k]).cuda() for k in ("tokens",
                                                          "labels")}
    torch.cuda.reset_peak_memory_stats()

    # (a) the first step, kernel against plain attention (and SDPA)
    model = build(cfg)
    params = model.init(seed, param_dtype=torch.float32)
    names = leaf_names(params)
    n_params = sum(t.numel() for t in opt_mod.tree_leaves(params))
    backend.reset_launch_counts()
    (loss_k, grads_k), grads_s = synced(
        torch, lambda: first_step_grads(torch, model, params, batch))
    check_launches = backend.launch_counts()
    check(all(check_launches[k] == n for k, n in per_step.items()),
          f"llama_train first step: launches {check_launches}, "
          f"expected {per_step}")
    plain = build(dataclasses.replace(cfg, attention_impl="chunked"))
    loss_p, grads_p = first_step_grads(torch, plain, params, batch)
    vs_plain = grads_diff(torch, grads_k, grads_p, names)
    del grads_k
    with patched(ops, "flash_attention", lambda _: sdpa_attention):
        loss_l, grads_l = first_step_grads(torch, model, params, batch)
    library_vs_plain = grads_diff(torch, grads_l, grads_p, names)
    del grads_p, grads_l, params, model, plain
    torch.cuda.empty_cache()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    check(loss_rel < TRAIN_LOSS_RTOL,
          f"llama_train: first loss {loss_k} against plain {loss_p}")
    check(vs_plain["max_rel_l2"] < TRAIN_GRAD_REL_L2,
          f"llama_train: gradients against plain {vs_plain}")

    # (b), (c): the run, each step timed from a synchronise to a
    # synchronise, with its peak memory
    step_s = []
    peaks = StepPeaks(torch)

    def timed(make):
        def make_timed(*a, **kw):
            step = make(*a, **kw)

            def call(*step_args):
                out, seconds = synced(torch, lambda: peaks(
                    lambda: step(*step_args)))
                step_s.append(seconds)
                return out
            return call
        return make_timed

    backend.reset_launch_counts()
    with patched(ptrain, "make_train_step", timed):
        out, run_s = synced(torch, lambda: ptrain.run(args, cfg, cs))
    launches = backend.launch_counts()
    check(all(launches[k] == n * TRAIN_STEPS for k, n in per_step.items()),
          f"llama_train run: launches {launches}")
    hist = out["history"]
    nll = [h["nll"] for h in hist]
    check(len(nll) == TRAIN_STEPS and all(np.isfinite(nll)),
          f"llama_train: nll {nll}")
    check(nll[-1] < nll[0], f"llama_train: nll did not fall: {nll}")
    check(out["checkpoints"] == [TRAIN_STEPS],
          f"llama_train: checkpoints {out['checkpoints']}")
    peak_train = peaks.phase_peak()
    step_memory = list(zip(peaks.bases, peaks.steps))

    # (d) --resume from the last step's checkpoint: the state it restores
    # is held against the live one (then freed), and it takes one step
    # before a pre-emption (no save)
    live = {"state": (out["params"], out["opt_state"])}
    del out
    torch.cuda.empty_cache()
    identical = []

    def held_restore(restore):
        def call(*a, **kw):
            restored = restore(*a, **kw)
            saved = live.pop("state")
            identical.append(all(
                x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(
                    opt_mod.tree_leaves(saved),
                    opt_mod.tree_leaves(restored))))
            del saved
            torch.cuda.empty_cache()
            return restored
        return call

    restore_s = []

    def timed_restore(restore):
        def call(*a, **kw):
            result, seconds = synced(torch, lambda: restore(*a, **kw))
            restore_s.append(seconds)
            return result
        return call

    backend.reset_launch_counts()
    with patched(ptrain, "restore_state", timed_restore), \
            patched(ptrain, "restore_state", held_restore):
        resumed, resume_s = synced(torch, lambda: ptrain.run(
            train_args(seed, resume=True, steps=TRAIN_STEPS + 2,
                       preempt_at=TRAIN_STEPS), cfg, cs))
    resume_launches = backend.launch_counts()
    check(identical == [True],
          "llama_train: the restored state differs from the saved one")
    check(resumed.get("preempted_at") == TRAIN_STEPS
          and resumed["resume_from"] == TRAIN_STEPS
          and int(resumed["opt_state"].step) == TRAIN_STEPS + 1,
          f"llama_train: resume {resumed.get('preempted_at')}")
    check(all(resume_launches[k] == n for k, n in per_step.items()),
          f"llama_train resume: launches {resume_launches}")
    check(all(bool(torch.isfinite(t).all())
              for t in opt_mod.tree_leaves(resumed["params"])),
          "llama_train: resumed params not finite")

    # (e) one more step of the resumed state under the profiler; the
    # optimizer's device time from CUDA events around its update
    params, state = resumed["params"], resumed["opt_state"]
    del resumed
    step = make_train_step(build(cfg), ptrain.optimizer_config(args))
    opt_spans = []

    def timed_update(update):
        def call(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = update(*a, **kw)
            end.record()
            opt_spans.append((start, end))
            return result
        return call

    def one_step():
        nonlocal params, state
        params, state, _ = step(params, state, batch)

    with patched(opt_mod, "update", timed_update):
        breakdown = profile_breakdown(torch, one_step, runs=1)
    torch.cuda.synchronize()
    optimizer_ms = opt_spans[-1][0].elapsed_time(opt_spans[-1][1])
    del params, state, step
    torch.cuda.empty_cache()

    steady = sorted(step_s[1:])
    step_ms = statistics.median(steady) * 1e3
    main_launches = {k: launches[k] + resume_launches[k] for k in launches}
    return {"phase": "llama_train", "arch": cfg.arch_id,
            "layers": L, "full_layers": get_config(LLAMA).num_layers,
            "parameters": n_params, "batch": [TRAIN_BATCH, TRAIN_SEQ],
            "steps": TRAIN_STEPS, "lr": TRAIN_LR, "warmup": TRAIN_WARMUP,
            "dtype": cfg.dtype, "masters": "float32", "moments": args.moments,
            "remat": cfg.remat_policy, "corpus_vocab": spec.vocab_size,
            "launches": main_launches, "launches_per_step": per_step,
            "first_step": {"loss": loss_k, "plain_loss": loss_p,
                           "library_loss": loss_l, "loss_rel": loss_rel,
                           "loss_rtol": TRAIN_LOSS_RTOL,
                           "grads_vs_plain": vs_plain,
                           "grads_library_vs_plain": library_vs_plain,
                           "grad_rel_l2_limit": TRAIN_GRAD_REL_L2,
                           "grads_s": grads_s,
                           "check_launches": check_launches},
            "nll": nll, "history": hist, "run_s": run_s,
            "step_s": step_s, "step_ms": step_ms,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms * 1e-3),
            "checkpoint": {"step": TRAIN_STEPS, "restored_identical":
                           identical[0], "restore_s": restore_s[0],
                           "resumed_to": TRAIN_STEPS + 1,
                           "resume_s": resume_s},
            "optimizer_ms": optimizer_ms, "step_breakdown": breakdown,
            "peak_train_bytes": peak_train,
            "step_peak_bytes": max(p for _, p in step_memory),
            "step_memory": step_memory,
            "peak_device_bytes": peaks.phase_peak(),
            "seconds": time.perf_counter() - t0}


class TrainPhase(NamedTuple):
    """One training phase of TRAIN: its arch, the config's changes that cut
    it (its depth; a hybrid's super-block), its moments' dtype, and
    whether the plain step's gradients wait on the host while the kernel
    step runs (the card then holds one step and its gradients beside the
    masters, not two sets)."""

    arch: str
    cut: dict
    moments: str = "fp32"
    grads_on_host: bool = False


#: the training phases after llama_train, each at full width with f32
#: masters and gradients, 2 x 4096 positions a step, remat "full"; the cut
#: from the state a step holds, 16 B a parameter (masters, gradients and
#: two f32 moments) or 10 B with int8 moments, and its activations:
#: - mamba2-2.7b cut to 32 of its 64 layers: 1.42e9 parameters, 22.6 GB
#:   (it ran all 64, 43.2 GB, 72 s of the script, until the other families
#:   came; at 32 its bf16 plain versions still disagree past the gates,
#:   9.8e-2 on the worst leaf, so its check still runs in f32 as well);
#: - jamba-v0.1-52b cut to the first 2 layers of its layer_plan, (mamba,
#:   FFN) and (mamba, MoE of 16 experts top-2): 3.73e9 parameters,
#:   59.7 GB.  A hybrid's depth is a whole number of super-blocks
#:   (transformer.num_blocks), so the cut is one super-block of period 2,
#:   whose attention offset (4) never comes;
#: - seamless-m4t-large-v2 at full depth (24 + 24 layers; 1024 frames of
#:   the encoder under 4096 decoder tokens): 1.37e9 parameters, 22 GB, and
#:   the tied 256,206-row vocabulary's f32 logits, 8.4 GB a copy;
#: - gemma-7b cut to 4 of its 28 layers (head_dim 256): 1.89e9, 30 GB, and
#:   its 256,000-row vocabulary's logits as seamless's;
#: - internvl2-1b at full depth (256 patch embeddings before 3840 tokens,
#:   the prefix dropped from the loss): 0.49e9;
#: - dbrx-132b cut to 1 of its 40 layers (16 experts top-4) with int8
#:   moments: 4.49e9 parameters, 45 GB, the dry run's step 75.8 GB; the
#:   check's two gradient sets would not fit beside it, so the plain one
#:   waits on the host;
#: - jamba-v0.1-52b's first super-block made (mamba, FFN), (attention, MoE)
#:   by attn_layer_period 2 and attn_layer_offset 1: its attention sublayer
#:   (norm_mix before it) beside the SSD in one step, 3.67e9 parameters;
#: - qwen1.5-4b cut to 16 of its 40 layers (the QKV biases; 20 query heads
#:   on 20): 1.66e9, 27 GB;
#: - qwen2-72b cut to 1 of its 80 layers with int8 moments: 3.37e9
#:   parameters, 8.78e8 in the layer (64 query heads on 8, QKV biases at
#:   d_model 8192) and 2.49e9 in the two untied 152,064-row vocabulary
#:   matrices, 33.7 GB of state; the dry run's step 43.4 GB, the f32 logits
#:   5.0 GB a copy.  The check's second gradient set (13.5 GB) fits beside
#:   it, so the plain gradients stay on the card.
TRAIN = {
    "mamba": TrainPhase(MAMBA, {"num_layers": 32}),
    "jamba": TrainPhase(JAMBA, {"num_layers": 2, "attn_layer_period": 2}),
    "seamless": TrainPhase(SEAMLESS, {}),
    "gemma": TrainPhase(GEMMA, {"num_layers": 4}),
    "internvl": TrainPhase(INTERNVL, {}),
    "dbrx": TrainPhase(DBRX, {"num_layers": 1}, "int8", grads_on_host=True),
    "jamba_attn": TrainPhase(JAMBA, {"num_layers": 2, "attn_layer_period": 2,
                                     "attn_layer_offset": 1}),
    "qwen": TrainPhase(QWEN, {"num_layers": 16}),
    "qwen72": TrainPhase(QWEN72, {"num_layers": 1}, "int8"),
}
#: where the bf16 plain SSD chunked at the kernels' chunk and at SSD_CHUNK
#: disagree past TRAIN_LOSS_RTOL or TRAIN_GRAD_REL_L2 at depth (mamba2's 64
#: layers: 0.159 on its worst leaf, PERF.md §6), the bf16 kernel step is
#: held to this multiple of their spread instead (loss, and each leaf's
#: worst and median relative L2), and the kernel to the gates in f32.  Two
#: plain versions that differ only in their chunking measure how far one
#: rounding's difference grows through the layers; a kernel step within
#: twice that of the plain one is as close as another plain version, where
#: a wrong term of the gradient moves its leaves by their own size
SPREAD_MULTIPLE = 2.0


def train_config(which: str):
    """TRAIN[which]'s config: the arch's own, cut."""
    from repro_torch.configs import get_config

    phase = TRAIN[which]
    return dataclasses.replace(get_config(phase.arch), **phase.cut)


def train_launches(cfg) -> dict:
    """Each LM kernel's launches in one train step with remat "full": the
    flash forward twice per attention call (the forward and the remat
    recompute) and its backward once, the same for the SSD in each mamba
    layer (expected_launches: an enc-dec model attends enc_layers +
    2 num_layers times)."""
    calls = expected_launches(cfg)
    return {"flash_attention": 2 * calls["flash_attention"],
            "flash_attention_bwd": calls["flash_attention"],
            "ssd_scan": 2 * calls["ssd_scan"],
            "ssd_scan_bwd": calls["ssd_scan"]}


def train_lengths(cfg) -> tuple:
    """(tokens, frontend positions) of a training row of TRAIN_SEQ
    positions, as lm_inputs and the dry run's input_specs give them: an
    enc-dec model's TRAIN_SEQ decoder tokens on TRAIN_SEQ // 4 frames, a
    VLM's frontend_tokens patch embeddings before the rest."""
    if cfg.is_encdec:
        return TRAIN_SEQ, max(128, TRAIN_SEQ // 4)
    return TRAIN_SEQ - cfg.frontend_tokens, cfg.frontend_tokens


def frontends(torch, cfg, seed: int, frames: int):
    """Each step's frontend [TRAIN_BATCH, frames, frontend_dim] in bf16,
    drawn on the card from ``seed`` (the first is the first step's)."""
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    while True:
        yield torch.randn((TRAIN_BATCH, frames,
                           cfg.frontend_dim or cfg.d_model), generator=g,
                          device="cuda", dtype=torch.bfloat16)


def run_with_frontend(torch, args, cfg, cs, spec, tokens: int,
                      frontend) -> dict:
    """launch.train.run's loop for a model whose batch carries a frontend
    (launch/train.py feeds tokens alone, as the JAX package's does): the
    state fresh from --seed, each step's tokens from the corpus over
    PrefetchLoader and its frontend from ``frontend``, through
    ``launch.train.make_train_step``, every step logged, no checkpoint."""
    from repro_torch import convert
    from repro_torch.data import PrefetchLoader, TokenDataset
    from repro_torch.launch import train as ptrain
    from repro_torch.models import build
    from repro_torch.train import optimizer as opt_mod

    model = build(cfg)
    opt_cfg = ptrain.optimizer_config(args)
    params = model.init(args.seed, param_dtype=torch.float32)
    state = opt_mod.init(params, opt_cfg, convert.reference_shapes(cfg))
    step = ptrain.make_train_step(model, opt_cfg)
    rows = ({"tokens": b["tokens"], "labels": b["labels"]}
            for b in TokenDataset(cs, spec).batches(args.batch, tokens))
    loader = PrefetchLoader(rows, depth=2, device="cuda")
    history = []
    for i in range(args.steps):
        batch = dict(next(loader), frontend=next(frontend))
        params, state, metrics = step(params, state, batch)
        history.append({**{k: float(v) for k, v in metrics.items()},
                        "step": i + 1})
    return {"history": history, "params": params, "opt_state": state}


@contextlib.contextmanager
def plain_ssd_at(chunk: int):
    """Inside, every ops.ssd call runs the plain chunked version at
    ``chunk`` (under autograd, autograd differentiates it)."""
    from repro_torch.kernels import ops

    def wrap(ssd):
        def plain(*args, impl="auto", **kw):
            return ssd(*args, **{**kw, "impl": "chunked", "chunk": chunk})
        return plain

    with patched(ops, "ssd", wrap):
        yield


class NoCheckpoints:
    """launch.train's checkpoint manager, saving nothing: the training
    phases after llama_train hold no checkpoint (llama_train holds save
    and restore; a 43 GB save would cost ~120 s of the run)."""

    def save_async(self, step, state):
        pass

    def wait(self):
        pass

    def latest_step(self):
        return None

    def steps(self):
        return []


def spread_limit(gate: float, spread: float) -> float:
    """The limit of a first-step reading whose two plain versions are
    ``spread`` apart: the gate where they agree within it, else
    SPREAD_MULTIPLE times their spread."""
    return gate if spread < gate else SPREAD_MULTIPLE * spread


def phase_train(torch, seed: int, backend, which: str) -> dict:
    """An LM of TRAIN trained on the card: (a) the first step's loss and
    every gradient in bf16 against the same step with every kernel on its
    path replaced by its plain version under autograd (attention by
    ``ref.attention_chunked``, the SSD by the plain chunked SSD at the
    kernels' chunk), within TRAIN_LOSS_RTOL and TRAIN_GRAD_REL_L2; where
    the model has mamba layers, the plain SSD chunked at SSD_CHUNK gives
    the plain versions' spread at this depth, and where that passes the
    gates the bf16 step is held within SPREAD_MULTIPLE times it and, in
    f32, where the plain versions agree, within the gates (an MoE's routes
    held to the first plain run's, as held_routes does for the prefill);
    (b) each kernel's launches per step (train_launches); (c) a falling
    nll over TRAIN_STEPS steps, through launch.train.run, or, with a
    frontend, run_with_frontend; (d) step time, tokens/s, each step's peak
    memory and a profiler breakdown of one step."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset, write_corpus
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.launch import train as ptrain
    from repro_torch.models import build
    from repro_torch.models.transformer import layer_plan
    from repro_torch.train import make_train_step
    from repro_torch.train import optimizer as opt_mod

    t0 = time.perf_counter()
    phase = TRAIN[which]
    cfg = train_config(which)
    check(cfg.dtype == "bfloat16" and cfg.attention_impl == "auto"
          and cfg.remat and cfg.remat_policy == "full",
          f"{which}_train config {cfg}")
    plan = (None if cfg.is_encdec else layer_plan(cfg))
    per_step = train_launches(cfg)
    mamba = per_step["ssd_scan_bwd"]
    attn = per_step["flash_attention_bwd"]
    moe = cfg.is_moe
    tokens, frames = train_lengths(cfg)
    args = train_args(seed, arch=phase.arch, moments=phase.moments)
    cs = ptrain.make_store(None)
    spec = ptrain.corpus_spec(args, cfg)
    write_corpus(cs, spec)
    first = next(TokenDataset(cs, spec).batches(args.batch, tokens))
    batch = {k: torch.as_tensor(first[k]).cuda() for k in ("tokens",
                                                          "labels")}
    if frames:
        batch["frontend"] = next(frontends(torch, cfg, seed, frames))
    torch.cuda.reset_peak_memory_stats()

    # (a) the first step: the kernels against their plain versions
    params = build(cfg).init(seed, param_dtype=torch.float32)
    names = leaf_names(params)
    n_params = sum(t.numel() for t in opt_mod.tree_leaves(params))

    def grads(dtype: str, chunk: Optional[int], routes=None):
        """(loss, gradients, launches, routes recorded, seconds) of one
        step in ``dtype`` activations; ``chunk``: every kernel's plain
        version, the SSD's at that chunk (None: the kernels); ``routes``:
        the MoE held to them."""
        model = build(dataclasses.replace(
            cfg, dtype=dtype, **({"attention_impl": "chunked"} if chunk
                                 else {})))
        with contextlib.ExitStack() as stack:
            if chunk:
                stack.enter_context(plain_ssd_at(chunk))
            seen = stack.enter_context(recorded_routes())
            if routes is not None:
                stack.enter_context(held_routes(routes))
            backend.reset_launch_counts()
            (loss, g), seconds = synced(torch, lambda: first_step_grads(
                torch, model, params, batch))
            launches = backend.launch_counts()
        return loss, g, launches, (seen if routes is None else routes), \
            seconds

    chunks = (kssd.CHUNK, SSD_CHUNK)

    def compare(dtype: str):
        """The plain step at the kernels' chunk, the kernel step against
        it (routes held to the first), the plain step at SSD_CHUNK too
        where the model has mamba layers, and each reading's limit
        (spread_limit)."""
        loss_p, g_p, _, routes, plain_s = grads(dtype, chunks[0])
        if phase.grads_on_host:
            g_p = [g.cpu() for g in g_p]
        loss_k, g_k, launches, _, kernel_s = grads(dtype, None, routes)
        kernel = grads_diff(torch, g_k, g_p, names)
        del g_k
        spread = None
        if mamba:
            loss_q, g_q, _, _, _ = grads(dtype, chunks[1], routes)
            grads_spread = grads_diff(torch, g_q, g_p, names)
            del g_q
            spread = {"chunks": list(chunks),
                      "loss_rel": abs(loss_q - loss_p) / abs(loss_p),
                      "grads": grads_spread}
        del g_p
        torch.cuda.empty_cache()
        return {"dtype": dtype, "loss": loss_k, "plain_loss": loss_p,
                "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
                "grads_vs_plain": kernel, "plain_spread": spread,
                "limits": {
                    "loss_rel": spread_limit(
                        TRAIN_LOSS_RTOL, spread["loss_rel"] if spread else 0),
                    **{k: spread_limit(TRAIN_GRAD_REL_L2,
                                       spread["grads"][k] if spread else 0)
                       for k in ("max_rel_l2", "median_rel_l2")}},
                "check_launches": launches, "kernel_step_s": kernel_s,
                "plain_step_s": plain_s,
                "routes_held": moe}

    def agree(c) -> bool:
        spread = c["plain_spread"]
        return spread is None or (
            spread["loss_rel"] < TRAIN_LOSS_RTOL
            and spread["grads"]["max_rel_l2"] < TRAIN_GRAD_REL_L2)

    checked = [compare("bfloat16")]
    if not agree(checked[0]):
        # the bf16 plain versions disagree past the gates at this depth:
        # the kernel is held to the gates in f32, where they agree
        checked.append(compare("float32"))
    held = checked[-1]
    check(agree(held), f"{which}_train: the plain versions disagree in "
          f"{held['dtype']}: {held['plain_spread']}")
    for c in checked:
        what = f"{which}_train first step, {c['dtype']}"
        check(all(c["check_launches"][k] == n for k, n in per_step.items()),
              f"{what}: launches {c['check_launches']}, expected {per_step}")
        check(c["loss_rel"] < c["limits"]["loss_rel"],
              f"{what}: loss {c['loss']} against plain {c['plain_loss']}, "
              f"limit {c['limits']['loss_rel']}")
        check(all(c["grads_vs_plain"][k] < c["limits"][k]
                  for k in ("max_rel_l2", "median_rel_l2")),
              f"{what}: gradients against plain {c['grads_vs_plain']}, "
              f"limits {c['limits']}")
    del params
    torch.cuda.empty_cache()
    peak_check = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # (b), (c): the run, each step timed from a synchronise to a
    # synchronise, with its peak memory
    step_s = []
    peaks = StepPeaks(torch)

    def timed(make):
        def make_timed(*a, **kw):
            step = make(*a, **kw)

            def call(*step_args):
                out, seconds = synced(torch, lambda: peaks(
                    lambda: step(*step_args)))
                step_s.append(seconds)
                return out
            return call
        return make_timed

    backend.reset_launch_counts()
    with patched(ptrain, "make_train_step", timed), \
            patched(ptrain, "checkpoints", lambda _: lambda *a: NoCheckpoints()), \
            patched(ptrain, "state_to_numpy", lambda _: lambda *a: None):
        if frames:
            out, run_s = synced(torch, lambda: run_with_frontend(
                torch, args, cfg, cs, spec, tokens,
                frontends(torch, cfg, seed, frames)))
        else:
            out, run_s = synced(torch, lambda: ptrain.run(args, cfg, cs))
    launches = backend.launch_counts()
    check(all(launches[k] == n * TRAIN_STEPS for k, n in per_step.items()),
          f"{which}_train run: launches {launches}")
    hist = out["history"]
    nll = [h["nll"] for h in hist]
    check(len(nll) == TRAIN_STEPS and all(np.isfinite(nll)),
          f"{which}_train: nll {nll}")
    check(nll[-1] < nll[0], f"{which}_train: nll did not fall: {nll}")
    peak_train = peaks.phase_peak()
    step_memory = list(zip(peaks.bases, peaks.steps))

    # (d) one more step under the profiler
    params, state = out["params"], out["opt_state"]
    del out
    step = make_train_step(build(cfg), ptrain.optimizer_config(args))

    def one_step():
        nonlocal params, state
        params, state, _ = step(params, state, batch)

    breakdown = profile_breakdown(torch, one_step, runs=1)
    del params, state, step, batch
    torch.cuda.empty_cache()
    device_ms = breakdown.get("device_ms_per_run", {})
    busy = breakdown.get("busy_ms_per_run")
    steady = sorted(step_s[1:])
    step_ms = statistics.median(steady) * 1e3
    full = get_config(phase.arch)
    return {"phase": f"{which}_train", "arch": cfg.arch_id,
            "layers": cfg.num_layers, "enc_layers": cfg.enc_layers,
            "full_layers": full.num_layers,
            "cut": phase.cut,
            "layer_plan": [list(p) for p in plan] if plan else None,
            "mamba_layers": mamba, "attention_layers": attn, "moe": moe,
            "parameters": n_params, "batch": [TRAIN_BATCH, TRAIN_SEQ],
            "tokens_each": tokens, "frontend_each": frames,
            "steps": TRAIN_STEPS, "lr": TRAIN_LR, "warmup": TRAIN_WARMUP,
            "dtype": cfg.dtype, "masters": "float32", "moments": args.moments,
            "remat": cfg.remat_policy, "corpus_vocab": spec.vocab_size,
            "launches": launches, "launches_per_step": per_step,
            "first_step": {"held_in": held["dtype"], "checked": checked,
                           "loss_rtol": TRAIN_LOSS_RTOL,
                           "grad_rel_l2_limit": TRAIN_GRAD_REL_L2,
                           "spread_multiple": SPREAD_MULTIPLE,
                           "plain_grads_on_host": phase.grads_on_host},
            "nll": nll, "history": hist, "run_s": run_s,
            "step_s": step_s, "step_ms": step_ms,
            "tokens_per_s": TRAIN_BATCH * tokens / (step_ms * 1e-3),
            "step_breakdown": breakdown,
            "flash_bwd_share_of_busy": (
                device_ms.get("flash_attention_bwd", 0.0) / busy
                if busy else None),
            "ssd_bwd_share_of_busy": (device_ms.get("ssd_scan_bwd", 0.0)
                                      / busy if busy else None),
            "peak_check_bytes": peak_check,
            "peak_train_bytes": peak_train,
            "step_peak_bytes": max(peaks.steps),
            "step_memory": step_memory,
            "peak_device_bytes": max(peak_check, peak_train,
                                     torch.cuda.max_memory_allocated()),
            "seconds": time.perf_counter() - t0}


#: the mesh phase: llama3-8b at full width, MESH_LAYERS of its 32 layers
#: (2.1e9 parameters with the vocabulary's two 0.53e9 matrices; f32
#: masters, int8 moments, so that each of its two checkpoints is ~10 GB of
#: the chunk store's Python copies rather than ~25 GB), trained through
#: launch.train's mesh path on a 1 x 1 NCCL mesh, MESH_STEPS steps in
#: elastic ranges of MESH_RANGE
MESH_LAYERS, MESH_STEPS, MESH_RANGE = 2, 4, 2
#: the elastic queue's lease: trainer A dies mid-range, the clock passes
#: the lease, trainer B claims the range again
MESH_LEASE_S = 30.0


class ManualClock:
    """The queue's clock, moved by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def phase_mesh_train(torch, seed: int, backend) -> dict:
    """llama3-8b at full width, MESH_LAYERS layers, through launch.train's
    mesh path on a 1 x 1 NCCL mesh (world size 1, cuda; no fallback: NCCL
    failing to start, or a mesh not on cuda, fails the phase), driven by
    launch.elastic.ElasticTrainer over a TaskQueue with a manual clock in
    ranges of MESH_RANGE steps: trainer A completes [0, 2), dies at step 3,
    the clock passes the lease, trainer B restores step 2 through
    ``restore(shardings=)`` and finishes [2, 4).  (a) The first step's loss
    and gradients under the mesh against the mesh-less step (the kernels
    both ways; dq's last bits vary run to run), under TRAIN_LOSS_RTOL and
    TRAIN_GRAD_REL_L2; (b) the restored state bit-identical to the saved
    one; (c) the flash launches per step as llama_train counts them; (d)
    every range completed once, steps re-run only from the last commit;
    (e) the step time against the mesh-less step's at the same depth (what
    the DTensor path costs), and the seconds spent saving and restoring;
    (f) after the run, one more step's update memory (``update_memory``,
    within ``update_bound``)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.convert import reference_shapes
    from repro_torch.core.taskqueue import TaskQueue
    from repro_torch.data import TokenDataset, write_corpus
    from repro_torch.launch import ElasticTrainer, submit_step_ranges
    from repro_torch.launch import mesh as pmesh
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import train as ptrain
    from repro_torch.models import build
    from repro_torch.train import make_train_step
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.checkpoint import flatten_with_path

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(LLAMA), num_layers=MESH_LAYERS)
    L = cfg.num_layers
    per_step = {"flash_attention": 2 * L, "flash_attention_bwd": L}
    args = train_args(seed, mesh=True, steps=MESH_STEPS, moments="int8",
                      ckpt_every=MESH_RANGE)
    cs = ptrain.make_store(None)
    spec = ptrain.corpus_spec(args, cfg)
    write_corpus(cs, spec)
    first = next(TokenDataset(cs, spec).batches(args.batch, args.seq))
    batch = {k: torch.as_tensor(first[k]).cuda() for k in ("tokens",
                                                          "labels")}
    torch.cuda.reset_peak_memory_stats()

    # the mesh-less step at the same depth: its first loss and gradients,
    # and its step time
    model = build(cfg)
    params = model.init(seed, param_dtype=torch.float32)
    names = leaf_names(params)
    n_params = sum(t.numel() for t in opt_mod.tree_leaves(params))
    loss_ref, grads_ref = first_step_grads(torch, model, params, batch)
    grads_ref = [g.detach() for g in grads_ref]
    opt_cfg = ptrain.optimizer_config(args)
    state = opt_mod.init(params, opt_cfg, reference_shapes(cfg))
    step = make_train_step(model, opt_cfg)
    plain_step_s = []
    for _ in range(3):
        (params, state, _), s = synced(torch, lambda: step(params, state,
                                                           batch))
        plain_step_s.append(s)
    del params, state, step, model
    torch.cuda.empty_cache()

    # trainer A on the 1 x 1 mesh; (a) its first step's gradients
    saved = {"saves": 0}

    def capture(to_numpy):
        def call(*a, **kw):
            tree = to_numpy(*a, **kw)
            if saved["saves"] == 0:
                saved["tree"] = tree  # the state saved at step MESH_RANGE
            saved["saves"] += 1
            return tree
        return call

    tr_a = ptrain.Trainer(args, cfg, cs)
    mesh = tr_a.mesh
    check(mesh is not None and mesh.device_type == "cuda"
          and dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"mesh_train: mesh {mesh}, backend {dist.get_backend()}")
    tr_a.fresh()
    wq = tr_a.params["blocks"][0]["attn"]["wq"]
    placements = [str(p) for p in wq.placements]
    backend.reset_launch_counts()
    (grads_m, metrics_m), grads_s = synced(
        torch, lambda: tr_a.step_fn.grads(tr_a.params, batch))
    check_launches = backend.launch_counts()
    check(all(check_launches[k] == n for k, n in per_step.items()),
          f"mesh_train first step: launches {check_launches}")
    loss_m = float(metrics_m["loss"])
    vs_plain = grads_diff(torch, opt_mod.tree_leaves(grads_m), grads_ref,
                          names)
    loss_rel = abs(loss_m - loss_ref) / abs(loss_ref)
    del grads_m, grads_ref
    torch.cuda.empty_cache()
    check(loss_rel < TRAIN_LOSS_RTOL,
          f"mesh_train: first loss {loss_m} against mesh-less {loss_ref}")
    check(vs_plain["max_rel_l2"] < TRAIN_GRAD_REL_L2,
          f"mesh_train: gradients against the mesh-less step {vs_plain}")

    # the elastic run: A completes [0, 2) and dies at step 3; B restores
    step_s, save_s, restore_s, ran, identical = [], [], [], [], []
    clock = ManualClock()
    queue = TaskQueue(clock=clock, default_lease_s=MESH_LEASE_S)
    ranges = submit_step_ranges(queue, MESH_STEPS, MESH_RANGE)

    peaks = StepPeaks(torch)

    def elastic(worker, tr):
        def step_fn(s):
            ran.append((worker, s))
            _, seconds = synced(torch, lambda: peaks(lambda: tr.run_step(s)))
            step_s.append((worker, s, seconds))

        def save_fn(s):
            _, seconds = synced(torch, lambda: (tr.save(s), tr.wait()))
            save_s.append(seconds)

        return ElasticTrainer(queue, worker, step_fn=step_fn,
                              save_fn=save_fn, restore_fn=tr.resume,
                              lease_s=MESH_LEASE_S)

    def held_restore(restore):
        def call(self, *a, **kw):
            _, seconds = synced(torch, lambda: restore(self, *a, **kw))
            restore_s.append(seconds)
            got = ptrain.state_to_numpy(
                opt_mod.tree_map(shd.gather, self.params),
                opt_mod.AdamState(
                    step=self.opt_state.step,
                    mu=ptrain._moment_map(shd.gather, self.opt_state.mu),
                    nu=ptrain._moment_map(shd.gather, self.opt_state.nu)),
                cfg)
            want = saved.pop("tree")
            identical.append(all(
                a.dtype == b.dtype and np.array_equal(a, b)
                for (_, a), (_, b) in zip(flatten_with_path(got),
                                          flatten_with_path(want))))
        return call

    backend.reset_launch_counts()
    with patched(ptrain, "state_to_numpy", capture), \
            patched(ptrain.Trainer, "restore", held_restore):
        a = elastic("a", tr_a)
        check(a.run_once() == "steps:0:2", "mesh_train: A's first range")
        a.run_once(die_at_step=MESH_RANGE + 1)  # vanishes at step 3
        del a, tr_a
        torch.cuda.empty_cache()
        clock.t += MESH_LEASE_S + 1.0
        tr_b = ptrain.Trainer(args, cfg, cs)
        b = elastic("b", tr_b)
        b.run()
    launches = backend.launch_counts()
    steps_run = len(ran)
    check(all(launches[k] == n * steps_run for k, n in per_step.items()),
          f"mesh_train run: launches {launches} for {steps_run} steps")
    check(identical == [True],
          f"mesh_train: the restored state differs from the saved: "
          f"{identical}")
    check(ran == [("a", 0), ("a", 1), ("a", 2), ("b", 2), ("b", 3)],
          f"mesh_train: steps run {ran}")
    check(queue.done() and queue.stats["completed"] == ranges
          and tr_b.ckpt.steps() == [MESH_RANGE, MESH_STEPS],
          f"mesh_train: queue {queue.stats}, checkpoints "
          f"{tr_b.ckpt.steps()}")
    check(int(tr_b.opt_state.step) == MESH_STEPS
          and all(bool(torch.isfinite(shd.gather(t)).all())
                  for t in opt_mod.tree_leaves(tr_b.params)),
          "mesh_train: the final state")
    read = dict(tr_b.ckpt.read_stats)
    peak = peaks.phase_peak()

    def one_step():  # past the run: what the update holds
        tr_b.params, tr_b.opt_state, _ = tr_b.step_fn(
            tr_b.params, tr_b.opt_state, batch)

    update = update_memory(torch, one_step)
    del tr_b, b
    pmesh.shutdown()
    torch.cuda.empty_cache()

    mesh_ms = statistics.median(s for w, i, s in step_s
                                if (w, i) not in (("a", 0), ("b", 2))) * 1e3
    plain_ms = statistics.median(plain_step_s[1:]) * 1e3
    return {"phase": "mesh_train", "arch": cfg.arch_id, "layers": L,
            "full_layers": get_config(LLAMA).num_layers,
            "parameters": n_params, "batch": [args.batch, args.seq],
            "dtype": cfg.dtype, "masters": "float32",
            "moments": args.moments, "backend": "nccl", "world_size": 1,
            "mesh": {"data": 1, "model": 1}, "device_type": "cuda",
            "wq_placements": placements,
            "launches": launches, "launches_per_step": per_step,
            "first_step": {"loss": loss_m, "mesh_less_loss": loss_ref,
                           "loss_rel": loss_rel,
                           "loss_rtol": TRAIN_LOSS_RTOL,
                           "grads_vs_mesh_less": vs_plain,
                           "grad_rel_l2_limit": TRAIN_GRAD_REL_L2,
                           "grads_s": grads_s,
                           "check_launches": check_launches},
            "elastic": {"ranges": ranges, "steps_run": ran,
                        "queue": dict(queue.stats),
                        "restored_identical": identical[0]},
            "step_s": step_s, "step_ms": mesh_ms,
            "mesh_less_step_s": plain_step_s, "mesh_less_step_ms": plain_ms,
            "dtensor_overhead_ms": mesh_ms - plain_ms,
            "save_s": save_s, "restore_s": restore_s,
            "restore_read": read, "step_peak_bytes": max(peaks.steps),
            "step_memory": list(zip(peaks.bases, peaks.steps)),
            "update_memory": update,
            "peak_device_bytes": max(peak, update["step_peak_bytes"]),
            "seconds": time.perf_counter() - t0}


def phase_grad_compression(torch, seed: int, copy_rate: float) -> dict:
    """train/grad_compression.py on the card: ``compressed_psum_mean`` over
    a one-rank NCCL group on mesh_train's first-step gradients (llama3-8b
    at full width, MESH_LAYERS layers, its corpus' first batch, f32),
    held bit for bit against the same arithmetic written out on one rank
    (dequant(requant(dequant(quant(g))))); the error-feedback invariant
    g_eff - residual == dequant(quant(g_eff)) on every leaf
    (tests/test_train.py:104-114); the call's time (median of 3), the bytes
    it would put on the wire (int8 both hops) against an f32 ring
    all-reduce's, and the rate at which it takes the f32 gradients in
    against the device-to-device copy's."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset, write_corpus
    from repro_torch.launch import mesh as pmesh
    from repro_torch.launch import train as ptrain
    from repro_torch.models import build
    from repro_torch.train import grad_compression as gc
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_step import make_grads_fn

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(LLAMA), num_layers=MESH_LAYERS)
    args = train_args(seed, mesh=True, steps=MESH_STEPS, moments="int8")
    cs = ptrain.make_store(None)
    spec = ptrain.corpus_spec(args, cfg)
    write_corpus(cs, spec)
    first = next(TokenDataset(cs, spec).batches(args.batch, args.seq))
    batch = {k: torch.as_tensor(first[k]).cuda() for k in ("tokens",
                                                          "labels")}
    model = build(cfg)
    params = model.init(seed, param_dtype=torch.float32)
    grads, _ = make_grads_fn(model)(params, batch)
    grads = opt_mod.tree_map(lambda g: g.detach(), grads)
    del params, model, batch
    torch.cuda.empty_cache()
    leaves = opt_mod.tree_leaves(grads)
    n_elem = sum(g.numel() for g in leaves)

    pmesh.init_distributed("cuda")
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"grad_compression: backend {dist.get_backend()}, world "
              f"{dist.get_world_size()}")
        seconds = []
        for _ in range(3):
            red, s = synced(torch, lambda: gc.compressed_psum_mean(
                grads, None, 1))
            seconds.append(s)
        got = torch.cat([g.reshape(-1) for g in opt_mod.tree_leaves(red)])
        del red
    finally:
        pmesh.shutdown()

    # the same arithmetic on one rank, written out
    cat = torch.cat([g.float().reshape(-1) for g in leaves])
    s1 = torch.clamp(cat.abs().max(), min=1e-12) / 127.0
    q1 = torch.clamp(torch.round(cat / s1), -127, 127).to(torch.int8)
    del cat
    p1 = q1.to(torch.float32) * s1
    del q1
    s2 = torch.clamp(p1.abs().max(), min=1e-12) / 127.0
    q2 = torch.clamp(torch.round(p1 / s2), -127, 127).to(torch.int8)
    del p1
    want = q2.to(torch.float32) * s2
    del q2
    identical = bool(torch.equal(got, want))
    max_diff = float((got - want).abs().max())
    del got, want
    check(identical, f"grad_compression: the one-rank result differs from "
                     f"dequant(requant(dequant(quant(g)))) by {max_diff}")

    # the error-feedback invariant, leaf by leaf
    g_eff, err = gc.with_error_feedback(grads, gc.init_error_state(grads))
    worst = float("-inf")
    for ge, e in zip(opt_mod.tree_leaves(g_eff), opt_mod.tree_leaves(err)):
        q, sc = gc.quantize_per_tensor(ge)
        recon = gc.dequantize_per_tensor(q, sc)
        excess = ((ge - e) - recon).abs() - (1e-6 + 1e-6 * recon.abs())
        worst = max(worst, float(excess.max()))
    del g_eff, err, grads, leaves
    torch.cuda.empty_cache()
    check(worst <= 0.0, f"grad_compression: error feedback off by {worst}")

    ms = statistics.median(seconds) * 1e3
    wire = 2 * n_elem + 2 * 4  # int8 both hops, one f32 scale each
    f32_wire = 2 * 4 * n_elem  # an f32 ring all-reduce, 2x its operand
    rate = 4 * n_elem / (ms * 1e-3)
    return {"phase": "grad_compression", "arch": cfg.arch_id,
            "layers": MESH_LAYERS, "elements": n_elem, "backend": "nccl",
            "world_size": 1, "identical_to_plain": identical,
            "error_feedback_excess": worst, "ms": ms, "seconds_runs": seconds,
            "wire_bytes": wire, "f32_wire_bytes": f32_wire,
            "wire_vs_f32": wire / f32_wire,
            "f32_in_bytes_per_s": rate,
            "vs_copy_bytes_per_s": rate / copy_rate,
            "seconds": time.perf_counter() - t0}


#: the rank phases: one rank of a (1, TP_RANKS) mesh, a node of 8 H100s
#: with the model axis across it, TRAIN_BATCH x TRAIN_SEQ tokens, int8
#: moments -> (arch, layers at full width):
#: - tp_rank_train: llama3-8b, TRAIN_LAYERS layers (4 query heads on 1 KV
#:   head, a rank's FFN and vocabulary columns);
#: - maverick_rank_train: llama4-maverick, 1 of its 48 layers, expert
#:   parallel: 16 of the 128 experts ([16, 5120, 8192] f32 stacks, 2.7 GB
#:   each), 5 query heads on 1 KV head, a vocabulary-parallel loss over
#:   202,048 rows; its dry run's step 42.5 GB
RANK_TRAIN = {"tp_rank_train": (LLAMA, TRAIN_LAYERS),
              "maverick_rank_train": (MAVERICK, 1)}
TP_RANKS, TP_STEPS = 8, 5


def rank_launches(cfg) -> dict:
    """The flash launches a rank's train step makes (train_launches):
    the forward twice an attention layer (remat), the backward once."""
    per_step = train_launches(cfg)
    return {k: per_step[k] for k in ("flash_attention",
                                     "flash_attention_bwd")}


def update_bound(state) -> dict:
    """The gate on what the optimizer's update may hold beyond its start
    (``update_extra_bytes``), from the int8 moments of the state it is
    given (a mesh step's local shards): L, the elements of the largest
    leaf with int8 moments, and P, those of the largest part such a leaf
    is updated in (``optimizer.part_rows``).  The update first takes the
    global norm, squaring one f32 gradient leaf at a time: at most L
    elements (no leaf is larger: every leaf of two or more dimensions and
    Q_MIN_SIZE elements has int8 moments).  It then updates each int8 leaf
    a part at a time, the new payloads and row scales written into the old
    ones: a part holds at most five f32 copies of itself at once (the
    dequantized moments, their update and the step's quotients, as
    tests/test_torch_train_families.py counts them on fake tensors), 5P;
    besides, a part's row maxima and scales, 1 / last of it.  So the
    update holds at most max(L, 5P) f32 elements, and the gate allows
    twice max(L, 3P): twice the f32 bytes of the largest leaf where its
    parts are small against it (mesh_train's embedding, 525M elements in
    parts of 67M; maverick's expert stacks, 671M in parts of 67M), six
    f32 copies of a part where the largest leaf is one part
    (tp_rank_train's 65.7M-element embedding shard).  Updated whole, a
    leaf would hold five f32 copies of itself."""
    from repro_torch.train import optimizer as opt_mod

    def local_shape(t):
        return tuple((t.to_local() if hasattr(t, "to_local") else t).shape)

    shapes = [local_shape(m.q) for m in opt_mod.tree_leaves(state.mu)
              if isinstance(m, opt_mod.QTensor)]
    check(bool(shapes), "update_bound: no leaf has int8 moments")
    largest = max(math.prod(s) for s in shapes)
    part = 0
    for s in shapes:
        rows, last, per_part = opt_mod.part_rows(s)
        part = max(part, min(rows, per_part) * last)
    return {"largest_int8_leaf": largest, "largest_part": part,
            "bound_bytes": 2 * 4 * max(largest, 3 * part)}


def update_memory(torch, step) -> dict:
    """One more call of ``step`` (a train step) with the optimizer's
    ``update`` watched: the step's peak before the update (forward and
    backward), the memory allocated when the update starts and the
    update's own peak; ``update_extra_bytes`` is what the update holds
    beyond its start, which must lie within ``update_bound`` of the state
    the update is given."""
    from repro_torch.train import optimizer as opt_mod

    cuda = torch.cuda
    seen = {}

    def wrap(update):
        def call(*args, **kw):
            seen["before_update_peak_bytes"] = cuda.max_memory_allocated()
            seen["update_base_bytes"] = cuda.memory_allocated()
            seen["update_bound"] = update_bound(args[1])
            cuda.reset_peak_memory_stats()
            out = update(*args, **kw)
            seen["update_peak_bytes"] = cuda.max_memory_allocated()
            return out
        return call

    cuda.reset_peak_memory_stats()
    with patched(opt_mod, "update", wrap):
        step()
    check(len(seen) == 4, f"update_memory: the step called update {seen}")
    seen["step_peak_bytes"] = max(seen["before_update_peak_bytes"],
                                  seen["update_peak_bytes"])
    seen["update_extra_bytes"] = (seen["update_peak_bytes"]
                                  - seen["update_base_bytes"])
    check(seen["update_extra_bytes"] <= seen["update_bound"]["bound_bytes"],
          f"update_memory: the update held {seen['update_extra_bytes']} "
          f"bytes beyond its start, over {seen['update_bound']}")
    return seen


def phase_tp_rank_train(torch, seed: int, backend,
                        which: str = "tp_rank_train") -> dict:
    """Rank 0 of a (1, TP_RANKS) tensor-parallel mesh on the card, in one
    process under torch's fake process group (the dry run's): its shards
    of RANK_TRAIN[which]'s model (full width, cut in depth, f32 masters
    drawn on the card, int8 moments), its heads, FFN columns, experts and
    vocabulary columns, through ``launch/train.py:make_mesh_train_step``.
    The collectives do no work, so the values are not meaningful and are
    not checked: the phase measures what one rank's step costs.  It
    reports the step time (median of TP_STEPS steps after one warm-up),
    each step's peak (``step_peak_bytes``, held by dryrun_check against
    the dry run's prediction of the same cell), how much of it the
    optimizer's update holds (one more step, the update's own peak), a
    profiled step's device time by group and idle share, an MoE's steps
    in the forward and the remat recompute (CUDA events), and the flash
    launches a step at the per-rank shapes (rank_heads)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as pmesh
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import train as ptrain
    from repro_torch.models import build
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.checkpoint import _unflatten, flatten_with_path

    t0 = time.perf_counter()
    arch, layers = RANK_TRAIN[which]
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    args = train_args(seed, arch=arch, moments="int8")
    opt_cfg = ptrain.optimizer_config(args)
    check(not dist.is_initialized(), f"{which}: a process group is up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=TP_RANKS)
    try:
        mesh = pmesh.make_local_mesh(1, TP_RANKS, device="cuda")
        check(mesh.device_type == "cuda" and dist.get_backend() == "fake",
              f"{which}: mesh {mesh}, backend {dist.get_backend()}")
        g = torch.Generator(device="cuda").manual_seed(seed)
        layout = ptrain.state_layout(cfg, opt_cfg)
        sh = ptrain.state_shardings(mesh, layout)

        def shard(leaf, s, draw):
            local = tuple(n // c for n, c in zip(leaf.shape, s.shard_counts))
            t = (torch.randn(local, generator=g, device="cuda") * 0.02
                 if draw else torch.zeros(local, dtype=leaf.dtype,
                                          device="cuda"))
            return shd.from_local(t, s, tuple(leaf.shape))

        def place(tree, shardings, draw):
            return _unflatten(tree, iter(
                shard(leaf, s, draw) for (_, leaf), (_, s) in zip(
                    flatten_with_path(tree), flatten_with_path(shardings))))

        opt = place(layout["opt"], sh["opt"], False)
        params = convert.split_layers(place(layout["params"], sh["params"],
                                            True), cfg, ptrain.take_layer)
        state = opt_mod.AdamState(
            step=opt.step.to_local(),
            mu=convert.split_layers(opt.mu, cfg, ptrain.take_layer),
            nu=convert.split_layers(opt.nu, cfg, ptrain.take_layer))
        del layout, opt
        local_params = sum(x.to_local().numel()
                           for x in opt_mod.tree_leaves(params))
        axes = ptrain.rows_axes(mesh, TRAIN_BATCH)
        tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                               generator=g, device="cuda")
        batch = {"tokens": tokens, "labels": tokens}
        model = build(cfg)
        step = ptrain.make_mesh_train_step(model, opt_cfg, mesh, axes)
        (params, state, _), warm_s = synced(
            torch, lambda: step(params, state, batch))
        peaks = StepPeaks(torch)
        step_s, counts = [], []
        for _ in range(TP_STEPS):
            backend.reset_launch_counts()
            (params, state, _), seconds = synced(torch, lambda: peaks(
                lambda: step(params, state, batch)))
            counts.append(backend.launch_counts())
            step_s.append(seconds)

        def one_step():
            nonlocal params, state
            params, state, _ = step(params, state, batch)

        update = update_memory(torch, one_step)
        breakdown = profile_breakdown(torch, one_step, runs=1)
        moe_ms = (moe_step_ms(torch, one_step, runs=1) if cfg.is_moe
                  else None)
        q_shape = [TRAIN_BATCH] + list(
            params["blocks"][0]["attn"]["wq"].to_local().shape[1:])
        experts_local = {name: list(t.to_local().shape) for name, t in
                         params["blocks"][0].get("moe", {}).items()
                         if name in ("w_gate", "w_up", "w_down")}
        del params, state, step, model
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    per_step = rank_launches(cfg)
    launches = {k: sum(c.get(k, 0) for c in counts) for k in per_step}
    check(all(c.get(k, 0) == n for c in counts for k, n in per_step.items()),
          f"{which}: launches a step {counts}")
    heads = rank_heads(cfg, TP_RANKS)
    step_ms = statistics.median(step_s) * 1e3
    return {"phase": which, "arch": cfg.arch_id, "layers": layers,
            "full_layers": get_config(arch).num_layers,
            "mesh": {"data": 1, "model": TP_RANKS}, "rank": 0,
            "backend": "fake", "device_type": "cuda",
            "batch": [TRAIN_BATCH, TRAIN_SEQ], "moments": args.moments,
            "local_parameters": local_params,
            "flash_shape": [TRAIN_BATCH, heads[0], heads[1], TRAIN_SEQ,
                            TRAIN_SEQ, cfg.head_dim],
            "wq_local": q_shape, "experts_local": experts_local or None,
            "launches": launches,
            "launches_per_step": per_step, "warmup_s": warm_s,
            "step_s": step_s, "step_ms": step_ms,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms * 1e-3),
            "step_breakdown": breakdown, "moe_step_ms": moe_ms,
            "step_peak_bytes": max(peaks.steps),
            "step_memory": list(zip(peaks.bases, peaks.steps)),
            "update_memory": update,
            "peak_device_bytes": max(peaks.phase_peak(),
                                     update["step_peak_bytes"]),
            "values_checked": False,
            "seconds": time.perf_counter() - t0}


class LoggedModel:
    """A model (or a ``MeshModel``) whose decode steps keep their logits:
    what ``greedy_generate`` calls, and nothing else, passed through."""

    def __init__(self, model):
        self.model, self.cfg, self.device = model, model.cfg, model.device
        self.logits = []

    def init_decode(self, *args, **kwargs):
        return self.model.init_decode(*args, **kwargs)

    def decode_step(self, params, state, token):
        state, logits = self.model.decode_step(params, state, token)
        self.logits.append(logits)
        return state, logits


#: decode on a mesh: the cache layouts of launch/train.py:MeshModel
CACHE_SHARDS = ("seq", "heads")


def phase_mesh_generate(torch, seed: int, backend) -> dict:
    """``greedy_generate`` on a ``launch/train.py:MeshModel`` over a 1 x 1
    NCCL mesh (no fallback: NCCL failing to start fails the phase), for
    each cache layout (CACHE_SHARDS: split-K over sequence shards, KV
    heads over ``model``), and mesh-less on the same weights: llama3-8b at
    full width, TRAIN_LAYERS layers, bf16 weights, GEN_BATCH requests of
    GEN_PROMPT prompt tokens and GEN_NEW new ones.  The tokens must be
    identical, and each step's logits within PREFILL_REL_L2 (relative L2
    over the run) of the mesh-less run's; the launches counted from zero
    over each run (the decode path launches no kernel); each run's step
    time, and a profiled step's device time and idle share."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as pmesh
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import train as ptrain
    from repro_torch.models import build
    from repro_torch.train import greedy_generate
    from repro_torch.train import optimizer as opt_mod

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(LLAMA), num_layers=TRAIN_LAYERS)
    model = build(cfg)
    params = model.init(seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    prompt = torch.randint(0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT),
                           generator=g, device="cuda", dtype=torch.int32)
    max_len = GEN_PROMPT + GEN_NEW + 1
    steps = GEN_PROMPT + GEN_NEW

    def run(m, p):
        logged = LoggedModel(m)
        backend.reset_launch_counts()
        tokens, seconds = synced(torch, lambda: greedy_generate(
            logged, p, prompt, GEN_NEW, max_len=max_len))
        return tokens, torch.cat(logged.logits, 1), seconds, \
            backend.launch_counts()

    def step_profile(m, p):
        state = m.init_decode(p, GEN_BATCH, max_len)
        for t in range(GEN_PROMPT):
            state, _ = m.decode_step(p, state, prompt[:, t:t + 1])
        token = prompt[:, -1:]
        with torch.no_grad():
            return profile_breakdown(torch, lambda: m.decode_step(
                p, state, token))

    want, want_logits, plain_s, plain_launches = run(model, params)
    runs = {"mesh_less": {"step_ms": plain_s / steps * 1e3,
                          "launches": plain_launches,
                          "step_breakdown": step_profile(model, params)}}
    check(not dist.is_initialized(), "mesh_generate: a process group is up")
    try:
        mesh = pmesh.make_local_mesh(1, 1, device="cuda")
        check(mesh.device_type == "cuda" and dist.get_backend() == "nccl"
              and dist.get_world_size() == 1,
              f"mesh_generate: mesh {mesh}, backend {dist.get_backend()}")
        dparams = opt_mod.tree_map(shd.distribute, params,
                                   shd.param_shardings(mesh, params))
        axes = ptrain.rows_axes(mesh, GEN_BATCH)
        for layout in CACHE_SHARDS:
            mm = ptrain.MeshModel(model, mesh, axes, cache_shard=layout)
            got, logits, seconds, launches = run(mm, dparams)
            check(torch.equal(got, want), f"mesh_generate {layout}: tokens "
                  f"differ from the mesh-less run's")
            l2 = rel_l2(torch, logits, want_logits)
            check(l2 < PREFILL_REL_L2, f"mesh_generate {layout}: logits "
                  f"relative L2 {l2} >= {PREFILL_REL_L2}")
            state = mm.init_decode(dparams, GEN_BATCH, max_len)
            placements = [str(p) for p in state[0].k.placements]
            runs[layout] = {"step_ms": seconds / steps * 1e3,
                            "launches": launches,
                            "max_abs_logit_diff": float(
                                (logits.float() - want_logits.float()).abs()
                                .max()),
                            "logits_rel_l2": l2, "tokens_identical": True,
                            "k_placements": placements,
                            "step_breakdown": step_profile(mm, dparams)}
            del state, logits
    finally:
        pmesh.shutdown()
    del params, model
    torch.cuda.empty_cache()
    launches = {k: sum(r["launches"].get(k, 0) for r in runs.values())
                for k in plain_launches}
    return {"phase": "mesh_generate", "arch": cfg.arch_id,
            "layers": cfg.num_layers, "dtype": cfg.dtype,
            "backend": "nccl", "mesh": {"data": 1, "model": 1},
            "requests": GEN_BATCH, "prompt_tokens": GEN_PROMPT,
            "new_tokens": GEN_NEW, "decode_steps": steps,
            "rel_l2_limit": PREFILL_REL_L2, "generated": want[0].tolist(),
            "runs": runs, "launches": launches,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "seconds": time.perf_counter() - t0}


#: tp_rank_decode's cells: rank 0 of a (1, TP_RANKS) mesh; (arch, shape,
#: layers (None: all), rows of the global batch)
TP_DECODE = {"llama": (LLAMA, "decode_32k", None, 32),
             "jamba": (JAMBA, "long_500k", 8, 1)}
TP_DECODE_STEPS = 5


def phase_tp_rank_decode(torch, seed: int, backend) -> dict:
    """Rank 0 of a (1, TP_RANKS) mesh decoding on the card, in one process
    under torch's fake process group (as tp_rank_train): its shards of the
    bf16 weights and of the caches (``decode_shardings``, split-K by
    sequence), through ``launch/train.py:make_mesh_decode_step``, every KV
    cache seq_len - 1 long (the dry run's cell).  The collectives do no
    work, so the values are not checked: the phase measures one rank's
    step.  Cells (TP_DECODE): llama3-8b at full depth, decode_32k with 32
    rows (the cache split over 8 ranks: 17.2 GB), and jamba-v0.1-52b at
    long_500k cut to 8 layers (one attention layer; batch 1, the positions
    over every rank).  Each reports the step time (median of
    TP_DECODE_STEPS after one warm-up), each step's peak (held by
    dryrun_check against the dry run's prediction of the same cell), a
    profiled step's device time and idle share, and the launches; one
    more step runs under ``torch.cuda.set_sync_debug_mode("error")``, so
    a synchronisation with the host inside the step fails the phase."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch import convert
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import mesh as pmesh
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import train as ptrain
    from repro_torch.launch.dryrun import at_length
    from repro_torch.models import build
    from repro_torch.train.checkpoint import _unflatten, flatten_with_path

    cells = {}
    for which, (arch, shape_name, layers, rows) in TP_DECODE.items():
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        S = SHAPES[shape_name].seq_len
        check(not dist.is_initialized(),
              "tp_rank_decode: a process group is up")
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=TP_RANKS)
        try:
            mesh = pmesh.make_local_mesh(1, TP_RANKS, device="cuda")
            check(mesh.device_type == "cuda"
                  and dist.get_backend() == "fake",
                  f"tp_rank_decode: mesh {mesh}, backend "
                  f"{dist.get_backend()}")
            g = torch.Generator(device="cuda").manual_seed(seed)
            layout = convert.jax_layout(cfg)
            meta = ptrain._map_layout(lambda s: torch.empty(
                s, device="meta"), layout)
            sh = shd.param_shardings(mesh, meta)

            def shard(leaf, s):
                local = tuple(n // c for n, c in zip(leaf.shape,
                                                     s.shard_counts))
                t = torch.randn(local, generator=g, device="cuda",
                                dtype=torch.bfloat16) * 0.02
                return shd.from_local(t, s, tuple(leaf.shape))

            params = convert.split_layers(_unflatten(meta, iter(
                shard(leaf, s) for (_, leaf), (_, s) in zip(
                    flatten_with_path(meta), flatten_with_path(sh)))),
                cfg, ptrain.take_layer)
            axes = ptrain.rows_axes(mesh, rows)
            local_rows = rows // max(1, math.prod(
                mesh.size(mesh.mesh_dim_names.index(a)) for a in axes))
            model = build(cfg)
            step = ptrain.make_mesh_decode_step(model, mesh, axes)
            with torch.no_grad():
                state = at_length(step.model.init_decode(
                    params, local_rows, S), S - 1)
            token = torch.randint(0, cfg.vocab_size, (local_rows, 1),
                                  generator=g, device="cuda",
                                  dtype=torch.int32)
            local_bytes = sum(x.to_local().numel() * x.element_size()
                              for x in tensor_leaves(params))
            (state, _), warm_s = synced(torch, lambda: step(params, state,
                                                            token))
            peaks = StepPeaks(torch)
            step_s, counts = [], []
            for _ in range(TP_DECODE_STEPS):
                state = at_length(state, S - 1)
                backend.reset_launch_counts()
                (state, _), seconds = synced(torch, lambda: peaks(
                    lambda: step(params, state, token)))
                counts.append(backend.launch_counts())
                step_s.append(seconds)
            # one more step with any synchronisation with the host raising
            torch.cuda.set_sync_debug_mode("error")
            try:
                state, _ = step(params, at_length(state, S - 1), token)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            breakdown = profile_breakdown(
                torch, lambda: step(params, at_length(state, S - 1), token),
                runs=1)
            cache_bytes = sum(
                t.to_local().numel() * t.element_size()
                for t in tensor_leaves(state))
            del params, state, step, model
        finally:
            dist.destroy_process_group()
            torch.cuda.empty_cache()
        launches = {k: sum(c.get(k, 0) for c in counts) for k in counts[0]}
        check(all(n == 0 for n in launches.values()),
              f"tp_rank_decode {which}: the decode path launched {launches}")
        step_ms = statistics.median(step_s) * 1e3
        cells[which] = {
            "phase": f"tp_rank_decode_{which}", "arch": cfg.arch_id,
            "shape": shape_name, "layers": cfg.num_layers,
            "mesh": {"data": 1, "model": TP_RANKS}, "rank": 0,
            "backend": "fake", "device_type": "cuda",
            "cache_shard": "seq", "rows": rows, "rank_rows": local_rows,
            "seq_len": S, "local_param_bytes": local_bytes,
            "local_cache_bytes": cache_bytes, "launches": launches,
            "host_syncs_in_a_step": 0,
            "warmup_s": warm_s, "step_s": step_s, "step_ms": step_ms,
            "tokens_per_s": rows / (step_ms * 1e-3),
            "step_breakdown": breakdown,
            "step_peak_bytes": max(peaks.steps),
            "step_memory": list(zip(peaks.bases, peaks.steps)),
            "peak_device_bytes": peaks.phase_peak(),
            "values_checked": False,
            "seconds": time.perf_counter() - t0}
    return cells


def tensor_leaves(tree) -> list:
    """The tensors of a parameter tree or a decode state (lists, dicts and
    NamedTuples)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return [tree] if hasattr(tree, "to_local") else []


def rank_heads(cfg, ranks: int) -> tuple:
    """Rank 0's query and KV heads on a model axis of ``ranks``."""
    from repro_torch.models.common import head_ranges

    q0, q1, k0, k1 = head_ranges(cfg.num_heads, cfg.num_kv_heads, ranks, 0)
    return q1 - q0, k1 - k0


#: the dry run's cells that chip_smoke itself runs (llama_train without a
#: mesh, mesh_train on its 1 x 1 mesh, the rank phases' (RANK_TRAIN) and
#: tp_rank_decode's rank of a 1 x 8 mesh, and the training phases of TRAIN
#: whose cut is a depth, which the dry run's --layers takes (not jamba's
#: period and offset): their shapes) and three train_4k cells on the 16 x
#: 16 production mesh
DRYRUN_TRAINED = {
    "llama_train": ["--arch", LLAMA, "--shape", "train_4k", "--mesh", "none",
                    "--layers", str(LLAMA_TRAIN_LAYERS), "--batch",
                    str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--moments",
                    "fp32"],
    "mesh_train": ["--arch", LLAMA, "--shape", "train_4k", "--mesh",
                   "local", "--layers", str(MESH_LAYERS), "--batch",
                   str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--moments",
                   "int8"],
    **{which: ["--arch", arch, "--shape", "train_4k", "--mesh", "local",
               "--mesh-data", "1", "--mesh-model", str(TP_RANKS),
               "--layers", str(layers), "--batch", str(TRAIN_BATCH),
               "--seq", str(TRAIN_SEQ), "--moments", "int8"]
       for which, (arch, layers) in RANK_TRAIN.items()},
    **{f"tp_rank_decode_{which}": [
        "--arch", arch, "--shape", shape, "--mesh", "local", "--mesh-data",
        "1", "--mesh-model", str(TP_RANKS), "--batch", str(rows),
        *(["--layers", str(layers)] if layers else [])]
       for which, (arch, shape, layers, rows) in TP_DECODE.items()},
    **{f"{which}_train": [
        "--arch", phase.arch, "--shape", "train_4k", "--mesh", "none",
        *(["--layers", str(phase.cut["num_layers"])]
          if "num_layers" in phase.cut else []),
        "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--moments",
        phase.moments]
       for which, phase in TRAIN.items() if set(phase.cut) <= {"num_layers"}}}
DRYRUN_PRODUCTION = (LLAMA, MAMBA, JAMBA)
#: a trained cell's predicted step peak against the measured one
DRYRUN_PEAK_BAND = (0.8, 1.25)
DRYRUN_TIMEOUT_S = 600


def dryrun_cores() -> set:
    """The cores the dry-run processes are pinned to: the upper half of
    this process's, so that the training phases they run beside keep the
    lower half to themselves."""
    cores = sorted(os.sched_getaffinity(0))
    return set(cores[len(cores) // 2:])


def start_dryruns(names=None) -> dict:
    """``python -m repro_torch.launch.dryrun``, each cell a process of its
    own, all started at once and pinned to ``dryrun_cores()`` (they use
    the host, not the card, and run beside the training phases, away from
    the cores this process drives the card from): the cells of
    DRYRUN_TRAINED, and llama3-8b, mamba2-2.7b and jamba-v0.1-52b at
    train_4k on the 16 x 16 mesh; with ``names``, those of its cells alone
    -> {cell: its process}."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cells = dict(DRYRUN_TRAINED)
    for arch in DRYRUN_PRODUCTION:
        cells[arch] = ["--arch", arch, "--shape", "train_4k", "--mesh",
                       "single"]
    if names is not None:
        cells = {k: v for k, v in cells.items() if k in names}
    cores = dryrun_cores()
    procs = {}
    for name, argv in cells.items():
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        with contextlib.suppress(ProcessLookupError):  # already ended
            os.sched_setaffinity(procs[name].pid, cores)
    return procs


def stop(procs: dict) -> None:
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def phase_dryrun_check(torch, procs: dict, trained: dict) -> dict:
    """The dry-run processes of ``start_dryruns``, read: each cell must
    end ``ok``; for each cell of a phase in ``trained`` (llama_train,
    mesh_train, the rank phases of a 1 x 8 mesh, TRAIN's depth cuts,
    tp_rank_decode's), the predicted step peak
    against the step peak the phase measured, within DRYRUN_PEAK_BAND, and
    the predicted flops and roofline step against the measured step time,
    as ratios with no gate."""
    t0 = time.perf_counter()
    records = {}
    try:
        for name, p in procs.items():
            out, err = p.communicate(timeout=DRYRUN_TIMEOUT_S)
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            check(p.returncode == 0 and lines,
                  f"dryrun {name}: exit {p.returncode}: {err[-2000:]}")
            records[name] = json.loads(lines[-1])
            check(records[name]["status"] == "ok",
                  f"dryrun {name}: {records[name]}")
    finally:
        stop(procs)
    held = {}
    for name, rec in records.items():
        if name not in trained:
            continue
        line = trained[name]
        peak = rec["bytes_per_device"]["peak_estimate"]
        ratio = peak / line["step_peak_bytes"]
        step_ms = line["step_ms"]
        held[name] = {
            "predicted_peak_bytes": peak,
            "measured_step_peak_bytes": line["step_peak_bytes"],
            "measured_phase_peak_bytes": line["peak_device_bytes"],
            "peak_ratio": ratio, "band": list(DRYRUN_PEAK_BAND),
            "predicted_flops": rec["flops_per_device"],
            "roofline_step_ms": rec["roofline"]["step_s"] * 1e3,
            "roofline_bottleneck": rec["roofline"]["bottleneck"],
            "measured_step_ms": step_ms,
            "roofline_vs_measured": rec["roofline"]["step_s"] * 1e3
            / step_ms,
            "achieved_flops_per_s": rec["flops_per_device"]
            / (step_ms * 1e-3),
            "kernel_calls": rec["kernel_calls"]}
        check(DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1],
              f"dryrun {name}: predicted peak {peak} against the measured "
              f"step peak {line['step_peak_bytes']} ({ratio:.3f})")
    production = {name: {k: records[name][k] for k in (
        "chips", "bytes_per_device", "hbm_ok", "params", "flops_per_device",
        "hbm_bytes_per_device", "collective_bytes_per_device",
        "collective_s_per_device", "roofline", "model_flops",
        "model_vs_hlo_flops", "kernel_calls", "trace_s")}
        for name in DRYRUN_PRODUCTION if name in records}
    return {"phase": "dryrun_check", "fake_device": next(iter(
        records.values()))["fake_device"], "trained": held,
            "train_4k_16x16": production,
            "trace_s": {name: rec["trace_s"] for name, rec in
                        records.items()},
            "seconds": time.perf_counter() - t0}


def kernel_line(name: str, results, tol, launches: int) -> dict:
    """One kernel's entry in the ``kernels`` line: its main-path case's
    times and bound, its f32 cases' largest error and the limit that case
    was held to (the flash backward's scales with the values)."""
    main_case = next(c for c in results if c["name"] == "main_path")
    worst = max((c for c in results
                 if c.get("images", c.get("dtype")) == "float32"),
                key=lambda c: c["max_abs_err"])
    return {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": REPLACES[name], "launches": launches,
        "max_abs_err": worst["max_abs_err"],
        "tol": worst.get("max_abs_limit", tol["float32"]),
        "shape": main_case["shape"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "copy_bound_ms": main_case["copy_bound_ms"],
        "library_ms": main_case["library_ms"]}


def only_names() -> list:
    """What ``--only`` takes: the flash forward's and backward's cases,
    each LM_PHASES key (its prefill, and its generation where it runs
    one), llama_train, each TRAIN phase, mesh_train and each rank phase of
    RANK_TRAIN."""
    return ["flash", "flash_bwd", *LM_PHASES, "llama_train",
            *(f"{which}_train" for which in TRAIN), "mesh_train",
            *RANK_TRAIN]


def run_only(torch, seed: int, backend, device: dict, names: set) -> int:
    """``--only``: the named phases alone, in the script's order, after the
    build; a training phase's dry-run cell (DRYRUN_TRAINED) is started
    beside it and held as in the whole run.  No ``kernels`` line and no
    last line: this is not the whole run."""
    if "flash" in names:
        flash = phase_flash(torch, seed, device["copy_bytes_per_s"])
        emit({k: v for k, v in flash.items() if k != "results"})
    if "flash_bwd" in names:
        flash_bwd = phase_flash_bwd(torch, seed, device["copy_bytes_per_s"])
        emit({k: v for k, v in flash_bwd.items() if k != "results"})
    for which, phase in LM_PHASES.items():
        if which not in names:
            continue
        line, model, params = phase_prefill(torch, seed, backend, which)
        emit(line)
        if phase.generate:
            emit(phase_generate(torch, seed, backend, model, params, which))
        del model, params
        torch.cuda.empty_cache()
    dryruns = start_dryruns(names)
    try:
        trained = {}
        if "llama_train" in names:
            trained["llama_train"] = phase_llama_train(torch, seed, backend)
            emit(trained["llama_train"])
        for which in TRAIN:
            if f"{which}_train" in names:
                trained[f"{which}_train"] = phase_train(torch, seed, backend,
                                                        which)
                emit(trained[f"{which}_train"])
        if "mesh_train" in names:
            trained["mesh_train"] = phase_mesh_train(torch, seed, backend)
            emit(trained["mesh_train"])
        for which in RANK_TRAIN:
            if which in names:
                trained[which] = phase_tp_rank_train(torch, seed, backend,
                                                     which)
                emit(trained[which])
        if dryruns:
            emit(phase_dryrun_check(torch, dryruns, trained))
    finally:
        stop(dryruns)
    print(device["nvidia_smi"], flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=None, metavar="NAME[,NAME...]",
                    help="run these phases alone after the build (a check "
                    "of one path, not the whole run): " + ", ".join(
                        only_names()))
    args = ap.parse_args()
    only = set(args.only.split(",")) if args.only else None
    if only is not None and not only <= set(only_names()):
        sys.exit(f"chip_smoke: --only takes {only_names()}, not "
                 f"{sorted(only - set(only_names()))}")

    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; nothing was run")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        sys.exit(f"chip_smoke: {ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import backend, build

    # full-precision matmuls: no TF32 for f32 (the plain versions are the
    # f32 references), no reduced-precision reductions inside bf16 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    device = phase_device(torch, build)
    emit(device)
    if only is not None:
        return run_only(torch, args.seed, backend, device, only)
    kernels = phase_kernels(torch, args.seed, device["copy_bytes_per_s"])
    emit({k: v for k, v in kernels.items() if k != "results"})
    grad = phase_grad_mag(torch, args.seed, device["copy_bytes_per_s"])
    emit({k: v for k, v in grad.items() if k != "results"})
    flash = phase_flash(torch, args.seed, device["copy_bytes_per_s"])
    emit({k: v for k, v in flash.items() if k != "results"})
    flash_bwd = phase_flash_bwd(torch, args.seed, device["copy_bytes_per_s"])
    emit({k: v for k, v in flash_bwd.items() if k != "results"})
    ssd = phase_ssd(torch, args.seed, device["copy_bytes_per_s"])
    emit({k: v for k, v in ssd.items() if k != "results"})
    ssd_bwd = phase_ssd_bwd(torch, args.seed, device["copy_bytes_per_s"])
    emit({k: v for k, v in ssd_bwd.items() if k != "results"})
    tile = phase_tile(torch, args.seed, backend)
    emit(tile)
    campaign, cs, names = phase_campaign(torch, args.seed, backend)
    emit(campaign)
    check(campaign["launches"]["composite"] >= campaign["tiles"],
          f"campaign launches {campaign['launches']}")
    cuda = torch.device("cuda")
    peak = torch.cuda.max_memory_allocated()  # the next phase resets it
    seg_tile = phase_seg_tile(torch, args.seed, backend, cuda)
    emit(seg_tile)
    seg_campaign = phase_seg_campaign(torch, backend, cs, names, cuda)
    emit(seg_campaign)
    peak = max(peak, torch.cuda.max_memory_allocated())  # reset next
    cal_scene = phase_calibration_scene(torch, args.seed, backend, cuda)
    emit(cal_scene)
    cal_campaign = phase_calibration_campaign(torch, args.seed, backend, cuda)
    emit(cal_campaign)
    serving = phase_tile_serving(cs, names)
    emit(serving)
    del cs
    examples = phase_examples()
    emit(examples)
    peak = max(peak, torch.cuda.max_memory_allocated())
    lm_lines = []
    for which, phase in LM_PHASES.items():
        line, model, params = phase_prefill(torch, args.seed, backend, which)
        emit(line)
        lm_lines.append(line)
        if phase.generate:
            line = phase_generate(torch, args.seed, backend, model, params,
                                  which)
            emit(line)
            lm_lines.append(line)
        del model, params
        torch.cuda.empty_cache()
        peak = max([peak] + [ln["peak_device_bytes"] for ln in lm_lines])
    dryruns = start_dryruns()
    try:
        llama_train = phase_llama_train(torch, args.seed, backend)
        emit(llama_train)
        lm_lines.append(llama_train)
        peak = max(peak, llama_train["peak_device_bytes"])
        trained = {}
        for which in TRAIN:
            train = phase_train(torch, args.seed, backend, which)
            emit(train)
            lm_lines.append(train)
            trained[train["phase"]] = train
            peak = max(peak, train["peak_device_bytes"])
        mesh_train = phase_mesh_train(torch, args.seed, backend)
        emit(mesh_train)
        lm_lines.append(mesh_train)
        peak = max(peak, mesh_train["peak_device_bytes"])
        compression = phase_grad_compression(torch, args.seed,
                                             device["copy_bytes_per_s"])
        emit(compression)
        mesh_generate = phase_mesh_generate(torch, args.seed, backend)
        emit(mesh_generate)
        lm_lines.append(mesh_generate)
        peak = max(peak, mesh_generate["peak_device_bytes"])
        for which in RANK_TRAIN:
            trained[which] = phase_tp_rank_train(torch, args.seed, backend,
                                                 which)
            emit(trained[which])
            lm_lines.append(trained[which])
            peak = max(peak, trained[which]["peak_device_bytes"])
        tp_decode = phase_tp_rank_decode(torch, args.seed, backend)
        for line in tp_decode.values():
            emit(line)
            lm_lines.append(line)
            peak = max(peak, line["peak_device_bytes"])
        emit(phase_dryrun_check(torch, dryruns, {
            "llama_train": llama_train, "mesh_train": mesh_train,
            **trained,
            **{f"tp_rank_decode_{k}": v for k, v in tp_decode.items()}}))
    finally:
        stop(dryruns)

    def lm_launches(kernel: str) -> int:
        """The main paths' launches: each served prefill and generate run
        and each training run; not the decode checks' prefills nor the
        first-step comparisons, which verify."""
        return sum(ln["launches"].get(kernel, 0) for ln in lm_lines)

    emit({"kernels": [
        kernel_line("composite", kernels["results"], TOL,
                    tile["launches"]["composite"]
                    + campaign["launches"]["composite"]),
        kernel_line("grad_mag", grad["results"], GRAD_TOL,
                    seg_tile["launches"]["grad_mag"]
                    + seg_campaign["launches"]["grad_mag"]),
        kernel_line("flash_attention", flash["results"], TOL,
                    lm_launches("flash_attention")),
        kernel_line("flash_attention_bwd", flash_bwd["results"], BWD_TOL,
                    lm_launches("flash_attention_bwd")),
        kernel_line("ssd_scan", ssd["results"], SSD_TOL,
                    lm_launches("ssd_scan")),
        kernel_line("ssd_scan_bwd", ssd_bwd["results"], SSD_BWD_TOL,
                    lm_launches("ssd_scan_bwd"))]})
    emit({"max_memory_allocated": max(peak,
                                      torch.cuda.max_memory_allocated())})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
