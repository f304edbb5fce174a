#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught):

1. Device: the card's name, and `nvidia-smi`'s name and power limit.
2. Build: all four kernel libraries (`binary_matvec.cu`, `fused_mlp.cu`,
   `ssd_scan.cu`, `quant_matmul.cu`) with nvcc, one per source, started
   together, into the git-ignored `build/` directory, timed, with nvcc's
   register and shared-memory report.
3. Kernels against their plain PyTorch versions on the card, at the
   main paths' shapes. The netgen kernels (the paper's 784-500-10 net,
   256 rows; seeded random words, bits, weights |w| <= 9 and images):
   `binary_matmul_planes` on the 1-bit tensor cores (4 bit-planes, in
   the `plane_mma_weights` layout the backend holds, and row-major at
   layer 1, copied per call); `binary_forward_planes` on the 1-bit
   tensor cores across a cluster (single and stacked in the backend's
   layout, stacked row-major, copied per call), and its scalar kernel
   called directly (stacked, row-major), the route the op takes only for
   nets too wide for the tensor-core route; `binary_matmul` and `binary_matmul_packed`
   on both routes: int8 weights in the layout the backend holds (the
   tensor-core route, also with weights at -128 and 127) and int32
   weights (the scalar route); `fused_mlp_predict` on both routes the
   same way (int8 weights on the int8 tensor cores, int32 on the scalar
   kernel); and `quant_matmul` (seeded int8 at the W8
   mamba2-2.7b `in_proj` and `out_proj` on the 128 x 128 tile and a
   decode step on the 64 x 64 tile, w_q in the `qmm_weights` layout, and
   `in_proj` once with w_q row-major) must be exactly equal; `ssd_scan`
   (mamba2-2.7b at batch 4 x 512 tokens, chunk 128) within 1e-4 in fp32
   (the scalar route), and in bf16 (which must take the tensor-core
   route) within one bf16 ulp on y (plus 1e-5 for fp32 summation order)
   and 1e-4 on the fp32 state; once more in bf16 at zamba2-2.7b's N = 64.
4. Main paths. (a) Three seeded 784-500-10 nets served by `NetServer` on
   `Session(device="cuda")`, once per target: `cuda[planes=true]` (one
   `predict` through the per-layer `binary_matmul_planes` chain, two
   `predict_many` calls over 3 versions with skewed request sizes through
   the `binary_forward_planes` megakernel), then `cuda`
   (`binary_matmul`), `cuda[packed=true]` (`binary_matmul_packed`) and
   `fused` (`fused_mlp_predict`), with the same requests; the megakernel
   and those three must take the tensor-core route on every launch; answers
   must equal `predict_quantized` and the `torch` oracle target. Then
   two 17-layer and two 40-layer width-16 nets through
   `cuda[fusednet=true]` (the megakernel at any depth), and a net whose
   accumulator wraps at 2**31 through every netgen target, equal to
   `predict_quantized` (which wraps as the reference does); both print
   the megakernel's route. The engine path: `ServingEngine` on a
   `Session` over a fresh `ArtifactStore` serves the three 784-500-10
   versions through `cuda[planes=true]` (slot capacity 256, 2 ms batch
   delay), registered from the memory tier after `compile_async`;
   requests keep arriving until a fourth version's background build has
   finished (at least 192), and some must be answered while it runs;
   then, on a second engine and with no compile running,
   eight producer threads submit 3 x 1200 single images, at most 64 of
   each one's own in flight; every answer must equal `predict_quantized`, B1 must
   launch on the tensor cores, every launch on the main thread's stream,
   a zero-deadline request must fail, shutdown must drain; it prints
   batches, rows per batch, queue wait and service latency p50/p99 and
   answers per second, of that cold load and of a 4 s warm window on a
   third engine whose stacked dispatch one untimed round built; a second session over the store must register
   with 0 compiles and 3 loads and answer the same; `lint_store`, the
   linter CLI and `benchmarks/check_trace.py` (a subprocess, stdlib
   only) must pass the store and the phase's trace. (b) The LM
   path: mamba2-2.7b at full width and depth (64 layers), weights from a
   `torch.Generator` seeded 0 on the card, compute dtype bf16, served by
   `Engine.generate` (batch 4 x prompt 512 and a ragged prompt of 200,
   then 32 new tokens) from the fp32 checkpoint and from its W8 form;
   `ssd` must launch once per layer of each prefill, every launch on the
   tensor cores (the bf16 route). The kernel route is
   held against `use_kernel=False`: per layer on the same input in bf16
   (4 bf16 ulps of the layer's scale), and end to end over the 64 layers
   in fp32 compute, where no cast separates the routes (logits and final
   SSM states within 1e-3 of their largest magnitude, equal greedy tokens
   wherever the margin allows). The bf16 end-to-end differences are
   reported beside two witnesses of their cause: the plain SSD fed the
   kernel route's bf16 dt, and the plain route in fp32 compute. `qlinear`
   runs on the W8 layer-0 `in_proj`/`out_proj` (weights made K-major by
   `qmm_weights` once) with that prefill's real activations and must
   equal plain `qlinear` exactly. (c) The paper's hardware output, run
   after (a) on its session, served v0 net and 1200 images: the `cost`
   and `verilog` targets under `zeros,prune,addends` (cells per pass
   beside the paper's Figure 7, the module's bytes, sha256 and header,
   the proof summary; no multiplier survives, cells never rise pass to
   pass, the widest declared accumulator is the proof's `max_width`,
   int32 proven safe); the same addend-form net through
   `cuda[fusednet=true]` and `cuda[planes=true]` (B1, all on the 1-bit
   tensor cores, and B2 must launch; the addend form lowers to the
   default pipeline's planes, `plan.verify()` clean; the answers equal
   the numpy interpreter's strict step on the circuit the Verilog came
   from and `predict_quantized`; the images the MSB step would change
   are counted); `cuda` under the named `hw` pipeline raising
   `IrregularCircuitError`; adder sharing on a 784-4-10 net under
   `zeros,cse[budget=8,bucketed=true]` (adders saved, the generic
   module's shared sub-sums, the shared DAG's answers equal
   `predict_quantized`); and each compile's host seconds. (d) The
   paper's whole pipeline, after (c): 784-500-10 trained on the card
   with `MLPConfig()` (1000 images, 60 epochs) and its wall time; L0-L3
   beside the paper's figures, within the reference test's band (L0 >
   0.85, the others within 0.10 of it); `run_ladder` with the `torch`,
   `cuda` and `fused` backends, and `cuda[tuned=true]`,
   `cuda[tuned=true,planes=true]` and `fused[tuned=true]` through a
   `Session(tune_store=...)`, every one bit-exact with `predict_l3` on
   the 1000 test images and launching its kernels; each search's whole
   surface (every candidate's microseconds and the winner); a second
   session over the tune store measuring nothing; `session.explore`
   (latency, budget 8, seed 0) over `default` and
   `zeros,prune,addends`, after which `cuda[explored=true]` resolves the
   winner with one `hit` and no measurement; a `NetServer` stacked round
   of the trained net and its `int_cast_weights(bound=5)` variant equal
   to `predict_quantized`; `benchmarks/check_trace.py` on the phase's
   trace; B1-B5 must launch. (e) The dense transformer family, after the
   LM path has freed the card: qwen1.5-4b at full width (3.95 B
   parameters, weights from a `torch.Generator` seeded 0 on the card,
   compute bf16) served by `Engine.generate` from fp32 and W8 at 4 x 512
   + 32 tokens and from fp32 at 1 x 2048 + 8, whose prefill must take the
   flash route in every layer; in fp32 compute, the engine's greedy
   tokens must equal a teacher-forced `api.forward` (4 x 64 + 16) wherever
   the top-2 margin decides them, `prefill` its last position within 2e-2,
   layer 0's `flash_attention` its dense oracle (2e-5 in fp32, 5e-2 in
   bf16 on the 2048 prompt), and the W8 loss the fp32 loss within 5 %;
   gemma-2b and llama3.2-3b served at 4 x 512 + 8 and teacher-forced;
   qwen2-72b counted abstractly; a profile of a qwen prefill and decode
   step. The dense path reaches no TPU kernel: every count must stay 0.
   (f) The hybrid family: zamba2-2.7b at full width (2.41 B parameters,
   54 Mamba2 layers with N = 64, the shared attention+MLP block at 9
   sites) served by `Engine` (`use_kernel=True`) from fp32 and W8 at
   4 x 512 + 32; each prefill must launch `ssd` 54 times, all on the
   tensor cores, and no other kernel; each checkpoint's kernel route is
   held to its plain route as mamba2's is (per layer 4 bf16 ulps, end to
   end in fp32 compute 1e-3); fp32 teacher forcing; a profile. (g) The
   MoE family: granite-moe-1b-a400m at full width (1.33 B parameters, 32
   experts of d_ff 512, top 8) served from fp32 at 4 x 512 + 32; its W8
   form must raise, as the reference's W8 MoE fails; prefill against
   forward (2e-2); one fp32 decode step on the card against the same step
   on the host from the same weights and cache (1e-3 of the largest
   |logit|, routings that differ counted); a bf16 step against fp32
   (0.15), and two bf16 prefills of one prompt against each other (0.15:
   the combine's bf16 `index_add_` adds in no fixed order); `loss_fn`'s
   aux losses; the share of routed pairs dropped at
   prefill and at decode (capacity 1 at 4 tokens); a profile;
   qwen3-moe-30b-a3b abstract (fp32, bf16 and W8 bytes). Every count must
   stay 0. (h) The vlm and audio modalities: qwen2-vl-2b (1.54 B
   parameters, M-RoPE, the first 128 positions of a 512-token prompt image
   patches) and musicgen-medium (1.37 B, LayerNorm, GELU, sinusoidal
   positions, frame embeddings) at full width, served from fp32 at
   4 x 512 + 32 by `Engine.generate(prompts, extras)` with `make_batch`'s
   numpy extras; fp32 teacher forcing with those extras (zero extras and a
   false mask over the generated positions, as `decode_step` supplies
   them), prefill against forward (2e-2), a bf16 decode step against fp32
   (0.05); a profile. Every count must stay 0. (i) The training stack:
   gemma-2b at full width (2.51 B parameters; 40.1 GB of fp32 parameters,
   gradients and AdamW moments) through `trainer.run`, 4 x 512 in two
   microbatches with remat, 6 steps: every loss and grad_norm finite, the
   first loss within 0.5 nat of ln 256,000, the last below the first, and
   the step-1 batch scored again after training below its first loss;
   step wall, tokens/s, model FLOP utilisation, peak memory and a profile
   of one step; remat against none on one 1 x 512 microbatch (the same
   loss, grad_norm within 1e-3); the card against the host at the smoke
   size for the dense, MoE, ssm, hybrid, vlm and audio configs (3 steps in
   fp32: losses within 1e-5 relative, step-1 gradients within 1e-5 of
   their largest |g|); a run killed at step 6 and resumed from its
   emergency checkpoint, bit-identical to an uninterrupted one under
   deterministic algorithms (in a subprocess, `chip_smoke.py --kill-resume
   DIR`, whose CUBLAS_WORKSPACE_CONFIG is set before CUDA starts; the
   default algorithms' result is reported); and the training launcher as
   a subprocess. Every count must stay 0. (j) Meshes, on a one-rank mesh
   (`launch.mesh.make_host_mesh()`: NCCL at world size 1, so every
   collective runs and sums one rank): the three 784-500-10 versions
   served in stacked rounds by `NetServer` on `cuda[fusednet=true]` under
   the mesh, through the sharded dispatch (`dispatch_counts["sharded"]`
   must move), equal to `predict_quantized` and to the unsharded
   dispatch, with B1 launching on the 1-bit tensor cores; granite-moe-
   1b-a400m's full-width prefill in fp32 through `moe_impl=shardmap`
   against the plain layer at capacity factor 4 (1e-4 of the largest
   |logit|); `compressed_psum` equal to `compress_decompress`; a smoke
   train state restored under the mesh, every leaf a `DTensor` placed by
   its spec and equal to the save; a layer recomputed by remat="full"
   (for CUDA tensors on autograd's device thread) seeing its forward's
   mesh, flags and reduction group; and two full-width granite-moe
   training steps at 1 x 512 under the mesh against the same steps
   without it, bitwise (a subprocess, `chip_smoke.py --mesh-train DIR`,
   under deterministic algorithms, run before this process opens its
   group). The phase destroys its process group. (k) The roofline, at
   world size 1 (`launch/cost.py`'s counting mode, `launch/roofline.py`):
   mamba2-2.7b's prefill at 4 x 512 and the train path's gemma-2b step,
   each counted on the card and again on `meta` tensors, FLOPs and bytes
   equal; the prefill's 64 `ssd_scan` launches all on the tensor cores
   and counted as 64 x `ssd_correction`'s per-layer forward; its wall
   beside t_compute, t_memory and the roofline fraction; the step's
   `model_flops`, counted matmul FLOPs and their ratio, counted peak
   against `max_memory_allocated`; one `qlinear` counted by B6's formula
   on the card and on `meta`; and `python -m repro_torch.launch.dryrun`
   on mamba2-2.7b `prefill_32k` over a fake 16 x 16 world on `meta`, in a
   subprocess that sees no card.
   Every launch count is set to 0 just before a path runs and read just
   after it; each of the path's kernels must have launched.
5. Times: CUDA events, median of 20 runs after warmup, per kernel (both
   routes of the dense and packed products, of `fused_mlp_predict` and
   of `ssd_scan`) beside its plain version, the one-call library
   yardsticks where they exist (fp32 `torch.matmul`, and `torch._int_mm`
   with B row-major and K-contiguous where the weights fit int8; the
   faster is `library_ms`), and its bound (for `ssd_scan` by the
   route's own rate, bf16 tensor cores or fp32 CUDA cores, with the
   CUDA-core bound beside it; for the megakernel's tensor-core route by
   bytes, with its popcounts' CUDA-core bound beside it); a block-shape
   sweep of the planes, dense and packed kernels (both routes) and the
   scalar fused kernel at layer-1 shape, and of the megakernel's tile
   rows and cluster size at its stacked shape; the served rounds'
   latency per target; the LM path's
   prefill and per-token decode wall times, and a
   `torch.profiler` trace of one prefill and one decode step (device busy
   time, kernel launches, the longest kernels).

The last two lines are the `{"kernels": [...]}` record (seven kernels;
B1, B3, B4, B5 and B7 headed by their tensor-core route, with `mma_launches`)
and `{"ok": true, "device": {...}}`. Without CUDA, or without the
repository's `src/` beside it, the script exits non-zero and prints no
result. Imports nothing of JAX or of the JAX package `repro`.
"""
from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
BMV_SOURCE = "src/repro_torch/kernels/binary_matvec/csrc/binary_matvec.cu"
FUSED_SOURCE = "src/repro_torch/kernels/fused_mlp/csrc/fused_mlp.cu"
SOURCES = {
    "binary_matmul_planes": BMV_SOURCE, "binary_forward_planes": BMV_SOURCE,
    "binary_matmul": BMV_SOURCE, "binary_matmul_packed": BMV_SOURCE,
    "fused_mlp_predict": FUSED_SOURCE,
    "quant_matmul": "src/repro_torch/kernels/quant_matmul/csrc/quant_matmul.cu",
    "ssd_scan": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
}
REPLACES = {
    "binary_matmul_planes": "src/repro/kernels/binary_matvec/binary_matvec.py:198",
    "binary_forward_planes": "src/repro/kernels/binary_matvec/binary_matvec.py:302",
    "binary_matmul": "src/repro/kernels/binary_matvec/binary_matvec.py:77",
    "binary_matmul_packed": "src/repro/kernels/binary_matvec/binary_matvec.py:134",
    "fused_mlp_predict": "src/repro/kernels/fused_mlp/fused_mlp.py:34",
    "quant_matmul": "src/repro/kernels/quant_matmul/quant_matmul.py:46",
    "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:73",
}
NETGEN = ("binary_matmul_planes", "binary_forward_planes", "binary_matmul",
          "binary_matmul_packed", "fused_mlp_predict")
# target -> the kernel whose every launch on its main path must take the
# tensor-core route (the served nets' weights fit int8; the 784-500-10
# megakernel's activations fit its shared memory)
MMA_PATHS = {"cuda[planes=true]": "binary_forward_planes", "cuda": "binary_matmul",
             "cuda[packed=true]": "binary_matmul_packed", "fused": "fused_mlp_predict"}
MMA_KIND = {"binary_forward_planes": "1-bit"}    # else int8
# target -> the kernels its main path must launch
PATHS = {
    "cuda[planes=true]": ("binary_matmul_planes", "binary_forward_planes"),
    "cuda": ("binary_matmul",),
    "cuda[packed=true]": ("binary_matmul_packed",),
    "fused": ("fused_mlp_predict",),
}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate (data sheet)
INT8_TC_OPS_PER_S = 1.979e15     # H100 SXM dense int8 tensor cores (data sheet)
BF16_TC_FLOP_PER_S = 9.89e14     # H100 SXM dense bf16 tensor cores (data sheet)
# CUDA C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0: results per clock per SM.
POPC_PER_CLOCK_PER_SM = 16       # row "population count" (__popc)
ADD_PER_CLOCK_PER_SM = 64        # row "32-bit integer add"
FMA_PER_CLOCK_PER_SM = 128       # row "32-bit floating-point add, multiply, multiply-add"
N_IN, N_HIDDEN, N_OUT, PLANES = 784, 500, 10, 4
BATCH, MODELS = 256, 3
SUSTAIN_S = 4.0                  # the engine's warm window, seconds of submissions
TIMING_RUNS, TIMING_INNER = 20, 5
SWEEP_BM, SWEEP_BN = (1, 2, 4, 8, 16, 32), (32, 64, 128, 256)
SWEEP_MMA_BM = (16, 32)          # the tensor-core tiles' rows (bm rounds up to 16)
SWEEP_CLUSTER = (1, 2, 4, 8)     # blocks of a megakernel cluster
LM_ARCH, LM_BATCH, LM_PROMPT, LM_RAGGED, LM_NEW = "mamba2-2.7b", 4, 512, 200, 32
LM_CHUNK = 128                   # the mixer's chunk
# The dense family (phase 4(e)): qwen1.5-4b served at 4 x 512 + 32 and
# through flash at 1 x 2048 + 8; gemma-2b and llama3.2-3b at 4 x 512 + 8;
# fp32 teacher forcing on 4 x 64 + 16; qwen2-72b abstract only.
DENSE_ARCH, DENSE_OTHERS, DENSE_ABSTRACT = "qwen1.5-4b", ("gemma-2b", "llama3.2-3b"), "qwen2-72b"
DENSE_PARAMS = {"qwen1.5-4b": 3_950_369_280, "gemma-2b": 2_506_172_416,
                "llama3.2-3b": 3_212_749_824, "qwen2-72b": 72_706_203_648}
DENSE_BATCH, DENSE_PROMPT, DENSE_NEW, DENSE_OTHER_NEW = 4, 512, 32, 8
DENSE_FLASH_PROMPT, DENSE_FLASH_NEW = 2048, 8
TF_PROMPT, TF_NEW = 64, 16
# fp32 compute with TF32 off: the KV-cache decode and the full forward
# differ by summation order, ~1e-6 of the logits' scale; a greedy token
# may differ only where the top-2 margin is below 1e-3 of the largest
# |logit|. Prefill against forward: the reference's 2e-2
# (tests/test_models_smoke.py). Flash against its dense oracle: 2e-5 in
# fp32, 5e-2 in bf16 (tests/test_flash.py). W8 loss within 5 % of fp32's
# (tests/test_serve_and_quant.py).
TF_MARGIN_RTOL, PREFILL_TOL, W8_LOSS_RTOL = 1e-3, 2e-2, 0.05
# The W8 checkpoint's logits against the fp32 checkpoint's, both in fp32
# compute on the make_batch batch, and one bf16 decode step's logits
# against the fp32 compute path's after the same prefill: max |diff| as a
# share of the fp32 logits' largest |value|. Read on an H100 80GB HBM3
# (700 W) at seed 0: 0.0323 (int8 rounding of every weight, ~0.8 % of a
# weight's scale, through 40 layers) and 0.0137 (bf16 rounding); the
# bounds are about three times those. A dequantization on the wrong
# axis or at the wrong magnitude moves the logits by their own size.
W8_LOGIT_RTOL, BF16_DECODE_RTOL = 0.1, 0.05
FLASH_TOL = {"float32": 2e-5, "bfloat16": 5e-2}
DEEP_DEPTHS, DEEP_WIDTH = (17, 40), 16     # deep planes-form nets for cuda[fusednet=true]
WRAP_TARGETS = ("torch", "cuda", "cuda[packed=true]", "cuda[planes=true]",
                "cuda[fusednet=true]", "fused")
HW_SPEC = "zeros,prune,addends"                  # the paper's L4 + L5 hardware path
CSE_SPEC = "zeros,cse[budget=8,bucketed=true]"   # adder sharing at 784 inputs
# W8 (M, K, N) of qlinear/quant_matmul: in_proj and out_proj over a 4 x 512
# prefill, and in_proj at one decode step of batch 4.
QMM_SHAPES = {"in_proj": (LM_BATCH * LM_PROMPT, 2560, 10576),
              "out_proj": (LM_BATCH * LM_PROMPT, 5120, 2560),
              "in_proj_decode": (LM_BATCH, 2560, 10576)}
# Kernel route against use_kernel=False, per layer on the same input: dt
# enters the kernel in bf16 (relative error <= 2^-9, which the chunk's
# cumulative decay sums over up to 128 rows), and the routes round y to
# bf16 at different values (one ulp each). Bound: 4 bf16 ulps (eps_bf16 =
# 2^-7) of the layer's largest output or state magnitude, elementwise.
ROUTE_ULPS = 4.0
# End to end in fp32 compute the kernel route casts nothing, and the routes
# differ by fp32 summation order: ~1e-6 of a layer's scale (phase 3). bf16
# runs show a stack of 64 random layers amplifying a per-layer difference
# about 65-fold (one bf16 ulp, 2^-8, grew to 26 % of the largest logit), so
# fp32 should land near 1e-4. Bound: 1e-3 of the plain route's largest
# |logit| and |state|, elementwise; greedy tokens must be equal wherever
# the plain route's top-2 margin exceeds twice the logit bound.
FP32_ROUTE_RTOL = 1e-3
# The hybrid family (phase 4(f)): zamba2-2.7b as published (54 Mamba2 layers,
# the shared attention+MLP block after every 6; N = 64), fp32 and W8 at
# 4 x 512 + 32 through `Engine(use_kernel=True)`, every mixer's SSD through
# ssd_scan; the kernel route held to the plain route with the bounds above;
# fp32 teacher forcing on 4 x 64 + 16, as the dense family's.
HYBRID_ARCH, HYBRID_PARAMS, HYBRID_SSM_STATE = "zamba2-2.7b", 2_409_563_040, 64
# The MoE family (phase 4(g)): granite-moe-1b-a400m as published (24 layers,
# 32 experts of d_ff 512, top 8), fp32 at 4 x 512 + 32; qwen3-moe-30b-a3b
# abstract only. A decode step's capacity (1 at T = 4) is not a prefill's,
# so teacher forcing does not hold; instead: prefill against forward at the
# same T (PREFILL_TOL); one fp32-compute decode step on the card against
# the same step on the host from the same weights and cache, within
# MOE_HOST_RTOL of the largest |logit| (fp32 summation order, TF32 off, as
# long as no routing flips; the routings that differ are counted); and one
# bf16 step against the fp32 one within MOE_BF16_RTOL. That bound was set
# before the first card reading, from the CPU: 0.008-0.011 at granite's
# width over 4 and 8 layers (2-6 of 16 routings changed at 4 layers),
# 0.008-0.050 at the smoke size over 9 seeds; 24 layers and capacity-1
# drops may flip more, so three times the worst CPU reading. The combine's
# bf16 `index_add_` is atomic on the card, in no fixed order, so two bf16
# prefills of one prompt may differ: a reordered bf16 sum is a bf16
# rounding, held to the same bound.
MOE_ARCH, MOE_ABSTRACT = "granite-moe-1b-a400m", "qwen3-moe-30b-a3b"
MOE_PARAMS = {"granite-moe-1b-a400m": 1_334_628_352, "qwen3-moe-30b-a3b": 30_532_110_336}
MOE_HOST_RTOL, MOE_BF16_RTOL = 1e-3, 0.15
# The vlm and audio modalities (phase 4(h)): qwen2-vl-2b and musicgen-medium
# as published, served from fp32 (bf16 compute) at 4 x 512 + 32 with the
# prompt extras of `data.pipeline.make_batch` (vlm: the first 128
# positions are image patches, M-RoPE positions (B, 3, S); audio: frame
# embeddings ~ N(0, 0.02) and sinusoidal positions); held as the dense
# family is: teacher forcing, prefill vs forward, a bf16 decode step.
# make_batch gives the three M-RoPE sections one arange, which reduces
# M-RoPE to RoPE; so the vlm checks run on distinct (t, h, w) positions
# over the image prefix (`_grid_positions`), and layer 0's M-RoPE is held
# to a plain per-section rotation in fp64 within MROPE_RTOL of max |q|
# (fp32 angles at positions < 100: ~1e-5 of a unit rotation), where the
# same positions with the sections' order reversed must miss it by 100x.
MODALITY_PARAMS = {"qwen2-vl-2b": 1_543_714_304, "musicgen-medium": 1_365_543_936}
MROPE_RTOL = 1e-4
# The LM training stack (phase 4(i)): gemma-2b as published through
# `trainer.run` at 4 x 512 (2 microbatches), remat, 6 steps of AdamW; the
# first loss within TRAIN_LOSS0_NAT of ln(vocab) (tied head, init std
# 1/sqrt(vocab): logits ~0.09 at random init), the last below the first,
# and the step-1 batch, scored again after the 6 steps, below its first
# loss. Each step sees a new batch of a bigram map over 256,000 tokens that
# 6 steps cannot learn, so the last loss moves by the batches' spread
# (~0.002 nat; 0.0005 below the first on an H100 80GB HBM3, 700 W, seed 0)
# and shows little; the rescored step-1 batch shows the optimizer fitting
# what it saw (0.098 nat lower on that card). Remat against none on one
# 1 x 512 microbatch: the same loss, grad_norm within REMAT_GNORM_RTOL.
# Card against host at the smoke size, fp32, TF32 off, for each family and
# modality: losses within HOST_LOSS_RTOL relative, step-1 gradients within
# HOST_GRAD_RTOL of their largest |g| (fp32 summation order; Adam turns a
# near-zero gradient's sign into +-lr, so parameters are not compared).
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS = "gemma-2b", 512, 4, 2, 6
TRAIN_LOSS0_NAT, REMAT_GNORM_RTOL = 0.5, 1e-3
HOST_ARCHS = {"dense": "gemma-2b", "moe": "granite-moe-1b-a400m", "ssm": "mamba2-2.7b",
              "hybrid": "zamba2-2.7b", "vlm": "qwen2-vl-2b", "audio": "musicgen-medium"}
HOST_LOSS_RTOL, HOST_GRAD_RTOL = 1e-5, 1e-5
# The mesh path (phase 4(j)): a one-rank mesh on the card (NCCL at world
# size 1), every collective of the port's mesh code run. granite-moe's
# full-width prefill in fp32 through moe_impl=shardmap against the plain
# layer, both at capacity factor MESH_MOE_CF, where neither drops a routed
# pair (the plain layer's capacity is then T; the shardmap one's per-expert
# 2T): the same products in other buffers and another order of the
# combine's adds, held to MESH_MOE_RTOL of the largest |logit|. Two
# full-width training steps at 1 x MESH_TRAIN_SEQ under the mesh and
# without, under deterministic algorithms (a subprocess, as the kill/resume
# run): at world size 1 every reduction of the data-parallel step is a sum
# of one, so losses and parameters must be bitwise equal.
MESH_MOE_CF, MESH_MOE_RTOL, MESH_PREFILL = 4.0, 1e-4, (2, 512)
MESH_TRAIN_SEQ, MESH_TRAIN_STEPS = 512, 2


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def _scalar_forward(planes):
    """The megakernel's scalar kernel (`bmv_forward_planes`) on row-major
    `planes`, called directly with a layer table built once: the op takes
    it only for nets whose activations the tensor-core route cannot hold."""
    import torch
    from repro_torch.kernels.binary_matvec import build, ops
    table = ops.ForwardTable(planes)
    words = [p.shape[-2] for p in planes[0::2]]

    def forward(x, *_, threshold, n_classes):
        out = torch.empty(x.shape[:-1], dtype=torch.int32, device=x.device)
        lib = build.load()
        err = lib.bmv_forward_planes(
            x.data_ptr(), x.shape[0] if x.dim() == 3 else 1, x.shape[-2], x.shape[-1],
            threshold, table.rows.data_ptr(), len(words), max(words), n_classes,
            out.data_ptr(), ops.FORWARD_BM, x.device.index,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"bmv_forward_planes: {lib.bmv_error_string(err).decode()}")
        return out
    return forward


def _words(rng, shape, dev):
    import numpy as np
    import torch
    w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(dev)


def _ints(rng, lo, hi, shape, dtype, dev):
    import torch
    return torch.from_numpy(rng.integers(lo, hi + 1, size=shape)).to(dtype).to(dev)


def _time_ms(fn, clock_hz: float) -> float:
    """Median device time of one call of `fn`, from CUDA events around
    TIMING_INNER back-to-back calls, after warmup. A spin kernel ahead of
    each run keeps the stream busy while the host enqueues the calls, so
    host overhead stays out of the measured interval."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMING_INNER):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int(max(2 * host_s, 1e-3) * clock_hz)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(TIMING_RUNS):
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(TIMING_INNER):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / TIMING_INNER)
    return statistics.median(runs)


def _bound(nbytes: int, ops: int, ops_per_s: float | None) -> tuple[float, str]:
    """The larger of the bytes' and the operations' times, in ms; by bytes
    alone where the card's rate for the operations is not published."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if ops_per_s is None:
        return t_bytes, "bytes"
    t_ops = ops / ops_per_s * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _work(name: str, args, kw, route: str = "tensor cores") -> tuple[int, str]:
    """(operations, kind) one call of kernel `name` does on `args`:
    1-bit tensor-core AND-popcount bit operations for `binary_matmul_planes`
    (2 x B x P x KW x 32 x N; NVIDIA publishes no rate for them, so its
    bound is by bytes) and for the megakernel's tensor-core route (2 x
    rows x P x W x 32 x N per layer, N the real class count on the last),
    popcounts for its scalar route (2 x rows x P x W x N per layer), int8 tensor-core
    operations for the dense and packed products and the fused net with
    int8 weights (2 x B x K x N per layer), adds for the others (B x K x N
    per layer; K = KW x 32 for packed words)."""
    import torch
    if name == "binary_matmul_planes":
        x, pos, _ = args
        return 2 * x.shape[0] * pos.shape[0] * pos.shape[1] * 32 * pos.shape[2], "b1_tc"
    if name == "binary_forward_planes":
        x, planes = args[0], args[1:]
        rows = x.numel() // x.shape[-1]
        popc = 0
        for li in range(len(planes) // 2):
            p, w, n = planes[2 * li].shape[-3:]
            if li == len(planes) // 2 - 1:
                n = kw["n_classes"]
            popc += 2 * rows * p * w * n
        return (32 * popc, "b1_tc") if route == "tensor cores" else (popc, "popc")
    if name in ("binary_matmul", "binary_matmul_packed"):
        x, w = args
        if w.dtype == torch.int8:
            return 2 * x.shape[0] * w.shape[0] * w.shape[1], "int8_tc"
        return x.shape[0] * w.shape[0] * w.shape[1], "add"
    x, w1, w2 = args
    macs = x.shape[0] * (w1.shape[0] * w1.shape[1] + w2.shape[0] * w2.shape[1])
    return (2 * macs, "int8_tc") if w1.dtype == torch.int8 else (macs, "add")


def _int_mm_layouts(xi, wi) -> dict:
    """`torch._int_mm` (cuBLASLt's s8 x s8 -> s32) on int8 A (M, K) and B
    (K, N) in both of B's layouts: row-major as given, and K-contiguous (the
    transposed view of an (N, K) tensor, cuBLASLt's TN layout)."""
    import torch
    wt = wi.T.contiguous().T
    return {"torch._int_mm": lambda: torch._int_mm(xi, wi),
            "torch._int_mm TN": lambda: torch._int_mm(xi, wt)}


def _library(name: str, args, out, clock_hz: float) -> dict:
    """The one-call PyTorch yardsticks computing the same product, each
    exact here: an fp32 `torch.matmul` without TF32 (every sum is an
    integer below 2**24) and, where the weights fit int8 (the dense and
    packed products' int8 weights, and the bit-planes recombined into
    w = sum_b 2^b (pos_b - neg_b)), cuBLASLt's s8 x s8 -> s32
    `torch._int_mm` in both of B's layouts on operands zero-padded to its
    shape rules (K and N multiples of 8; M > 16). Returns their times,
    their largest differences from `out` on the real columns, and the
    faster one as `library_ms`/`library` (None where no yardstick
    exists)."""
    import torch
    from repro_torch.kernels.binary_matvec import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    if name == "binary_matmul_planes":
        x, pos, neg = args
        k = x.shape[1] * 32
        xf = ref.unpack_bits(x, k).float()
        wf = sum((ref.unpack_bits(pos[b].T.contiguous(), k).T.float()
                  - ref.unpack_bits(neg[b].T.contiguous(), k).T.float())
                 * 2 ** b for b in range(pos.shape[0]))
    elif name == "binary_matmul":
        xf, wf = (args[0] != 0).float(), args[1].float()
    elif name == "binary_matmul_packed":
        xf = ref.unpack_bits(args[0], args[1].shape[0]).float()
        wf = args[1].float()
    else:
        return {"library_ms": None, "library": None, "library_max_abs_err": None}
    calls = {"fp32 torch.matmul": (lambda: torch.matmul(xf, wf), lambda y: y.long())}
    (m, k), n = xf.shape, wf.shape[1]
    if m > 16 and -128 <= int(wf.min()) and int(wf.max()) <= 127:
        kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
        xi = torch.zeros((m, kp), dtype=torch.int8, device=xf.device)
        xi[:, :k] = xf.to(torch.int8)
        wi = torch.zeros((kp, np_), dtype=torch.int8, device=xf.device)
        wi[:k, :n] = wf.to(torch.int8)
        for label, call in _int_mm_layouts(xi, wi).items():
            calls[label] = (call, lambda y: y[:, :n].long())
    res = {}
    for label, (call, real) in calls.items():
        err = int((real(call()) - out.long()).abs().max().item())
        res[label] = {"ms": _time_ms(call, clock_hz), "max_abs_err": err}
    best = min(res, key=lambda lb: res[lb]["ms"])
    return {"library_ms": res[best]["ms"], "library": best,
            "library_max_abs_err": res[best]["max_abs_err"], "yardsticks": res}


def _qmm_args(rng, m, k, n, dev):
    """Seeded int8 operands and fp32 scales of one W8A8 product."""
    import numpy as np
    import torch
    xq = torch.from_numpy(rng.integers(-127, 128, size=(m, k)).astype(np.int8)).to(dev)
    wq = torch.from_numpy(rng.integers(-127, 128, size=(k, n)).astype(np.int8)).to(dev)
    sx = torch.tensor(0.013, dtype=torch.float32, device=dev)
    sw = torch.from_numpy(rng.uniform(0.001, 0.1, size=(n,)).astype(np.float32)).to(dev)
    return xq, wq, sx, sw


def _ssd_args(rng, dev, dtype, n: int = 128):
    """Seeded SSD inputs at mamba2-2.7b's width (H=80, P=64, G=1, N=128;
    zamba2-2.7b's is the same with N=64), batch 4 x 512 tokens,
    distributed as the JAX package's kernel tests."""
    import numpy as np
    import torch
    b, l, h, p, g = LM_BATCH, LM_PROMPT, 80, 64, 1

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    x = t(rng.normal(size=(b, l, h, p))).to(dtype)
    dt = t(rng.uniform(0.001, 0.1, size=(b, l, h))).to(dtype)
    a = t(-rng.uniform(0.5, 2.0, size=(h,)))
    bb = (t(rng.normal(size=(b, l, g, n))) / np.sqrt(n)).to(dtype)
    cc = (t(rng.normal(size=(b, l, g, n))) / np.sqrt(n)).to(dtype)
    return x, dt, a, bb, cc


def _ssd_agrees(y, s, yp, sp) -> bool:
    """fp32: y and the state within 1e-4 (rtol and atol) of the plain
    version. bf16: y within one bf16 ulp of the larger magnitude (eps x
    |y|) plus 1e-5 for the fp32 sums' order, the state within 1e-4."""
    import torch
    ok = torch.allclose(s, sp, rtol=1e-4, atol=1e-4)
    if y.dtype == torch.float32:
        return ok and torch.allclose(y, yp, rtol=1e-4, atol=1e-4)
    g, w = y.float(), yp.float()
    ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(g.abs(), w.abs())
    return ok and bool(((g - w).abs() <= ulp + 1e-5).all())


def _ssd_flop(x, b, chunk: int) -> int:
    """BH (L/Q) (Q(Q+1) P + 4QNP) + B G (L/Q) Q(Q+1) N: the FLOP y and the
    state need. Per chunk and head, the causal Q(Q+1)/2 entries of the
    score tile each update a length-P row of y (scores times x), and 2QNP
    each go to the carried-state term and the state update. C B^T is the
    same for every head of a group, so its causal entries, each a length-N
    dot product, count once per (batch, chunk, group). The masked upper
    triangle is not work the function needs."""
    bsz, l, h, p = x.shape
    g, n, q = b.shape[-2], b.shape[-1], chunk
    per_head = q * (q + 1) * p + 4 * q * n * p
    return bsz * (l // q) * (h * per_head + g * q * (q + 1) * n)


def _int_mm_library(args, out, clock_hz: float) -> dict:
    """The one-call yardsticks of quant_matmul: `torch._int_mm` in both of
    B's layouts (`_int_mm_layouts`) and the same epilogue, where its shape
    rules admit the operands (M > 16, K and N multiples of 8). Returns
    their times and largest differences from `out`, and the faster one as
    `library_ms`/`library` (None when the shape rules refuse)."""
    xq, wq, sx, sw = args
    (m, k), n = xq.shape, wq.shape[1]
    if m <= 16 or k % 8 or n % 8:
        return {"library_ms": None, "library": None, "library_max_abs_err": None}
    res = {}
    for label, call in _int_mm_layouts(xq, wq.contiguous()).items():
        def full(call=call):
            return (call().float() * sx) * sw
        res[f"{label} + epilogue"] = {
            "ms": _time_ms(full, clock_hz),
            "max_abs_err": float((full() - out).abs().max().item()),
            "product_ms": _time_ms(call, clock_hz)}
    best = min(res, key=lambda lb: res[lb]["ms"])
    return {"library_ms": res[best]["ms"], "library": best,
            "library_max_abs_err": res[best]["max_abs_err"], "yardsticks": res}


def _deep_fusednet_path(session, oracle, dev, wrappers, reset_launches) -> int:
    """Phase 4(a), deep nets: two versions each of a 17-layer and a
    40-layer width-16 net (seeded weights in [-4, 6], 16-pixel images),
    served by `cuda[fusednet=true]` (one stacked `predict_many` and one
    `predict`; one `binary_forward_planes` launch each, any depth); answers
    must equal `predict_quantized` and the `torch` target. Returns the
    megakernel's launches and those on the tensor-core route."""
    import numpy as np
    from repro_torch.core import quantize
    from repro_torch.kernels.binary_matvec import ops
    from repro_torch.netgen import NetServer

    reset_launches()
    answers = 0
    for depth in DEEP_DEPTHS:
        server = NetServer(session=session, target="cuda[fusednet=true]", slot_capacity=BATCH)
        nets = {}
        for v in range(2):
            r = np.random.default_rng(SEED + 100 * depth + v)
            sizes = (DEEP_WIDTH,) * depth + (N_OUT,)
            nets[f"d{depth}v{v}"] = quantize.QuantizedNet(weights=[
                r.integers(-4, 7, size=sz).astype(np.int32) for sz in zip(sizes, sizes[1:])])
        for name, net in nets.items():
            server.register(name, net)
            oracle.register(name, net)
        x = np.random.default_rng(SEED + depth).integers(
            0, 256, size=(300, DEEP_WIDTH)).astype(np.uint8)
        out = server.predict_many({name: x[:200 + 50 * i] for i, name in enumerate(nets)})
        out[f"single d{depth}v0"] = server.predict(f"d{depth}v0", x)
        for key, got in out.items():
            name = key.split()[-1]
            want = quantize.predict_quantized(nets[name], device=dev)(x[:got.shape[0]])
            if not np.array_equal(got, want.cpu().numpy()):
                raise AssertionError(f"fusednet {key}: answers != predict_quantized")
            if not np.array_equal(got, oracle.predict(name, x[:got.shape[0]])):
                raise AssertionError(f"fusednet {key}: answers != torch target")
            answers += got.shape[0]
    n = wrappers["binary_forward_planes"].launches
    mma = wrappers["binary_forward_planes"].mma_launches
    print(f"[4 main path] cuda[fusednet=true] deep nets {DEEP_DEPTHS} x width {DEEP_WIDTH}: "
          f"{answers} answers equal predict_quantized and the torch target, "
          f"binary_forward_planes launches {n}, {mma} of them on the 1-bit tensor-core "
          f"route (clusters of {ops.forward_cluster([1] * DEEP_DEPTHS[0])} block)")
    if n <= 0:
        raise AssertionError("the deep fusednet path never launched binary_forward_planes")
    return n, mma


def _wrapping_net_path(session, dev) -> None:
    """Phase 4(a), int32 wrap: the 4x2 / 2x2 net whose hidden unit 0 sums
    to 2**32 on four set pixels (w1 column 0 all 2**30), through every
    netgen target; each must give class 1, equal to `predict_quantized`,
    which wraps its accumulators to int32 as the reference does."""
    import numpy as np
    import torch
    from repro_torch.core import quantize
    w1 = np.ones((4, 2), np.int64)
    w1[:, 0] = 2 ** 30
    net = quantize.QuantizedNet(weights=[w1.astype(np.int32), np.array([[5, 0], [0, 1]],
                                                                       np.int32)],
                                input_threshold=127)
    from repro_torch.kernels.binary_matvec import ops
    x = np.full((3, 4), 255, np.uint8)
    want = quantize.predict_quantized(net, device=dev)(x)
    forward = ops.binary_forward_planes
    n, mma = forward.launches, forward.mma_launches
    got = {t: session.compile(net, target=t)(x).cpu().numpy() for t in WRAP_TARGETS}
    n, mma = forward.launches - n, forward.mma_launches - mma
    print(f"[4 main path] wrapping net: predict_quantized {want.tolist()} "
          f"({want.dtype}), targets {json.dumps({t: g.tolist() for t, g in got.items()})}; "
          f"binary_forward_planes {mma} of {n} launches on the 1-bit tensor-core route")
    if n <= 0:
        raise AssertionError("the wrapping net never launched binary_forward_planes")
    if want.dtype != torch.int32 or want.tolist() != [1, 1, 1]:
        raise AssertionError("predict_quantized does not wrap to int32")
    for t, g in got.items():
        if not np.array_equal(g, want.cpu().numpy()):
            raise AssertionError(f"{t} disagrees with predict_quantized on the wrapping net")


def _engine_path(nets, images, dev, wrappers, reset_launches, smi) -> dict:
    """Phase 4 engine path: the online front door on the card. A session
    over a fresh `ArtifactStore` compiles the three served versions in
    the background (`compile_async`), its `ServingEngine` over
    `cuda[planes=true]` (slot capacity 256, 2 ms batch delay) registers
    them from the memory tier, and serves requests from before a fourth
    version's background build starts until it has finished (at least
    192, some answered while it ran; answers and the fourth version
    equal to `predict_quantized`). Then, on a second engine registered
    from the memory tier and with no compile running, eight producer
    threads submit 3 x 1200 single images (request r: version r % 3,
    image r // 3), at most 64 of each producer's own outstanding. Every
    future must resolve within its bound, equal `predict_quantized`,
    and the engine must count 3600 completions; B1
    must launch, all on the 1-bit tensor cores, and every launch of the
    phase on the stream the main thread launches on; a request with a
    zero deadline must fail with `DeadlineExceededError`; shutdown must
    drain and leave no batcher thread. A second session over the same
    store must register the versions with zero compiles and three loads
    and answer as the first; `lint_store` and the linter CLI must pass
    the store, and `benchmarks/check_trace.py` the phase's trace. Prints
    batches, rows per batch, queue wait, service latency per version and
    answers per second, of that load and of a warm window on a third
    engine (`_engine_sustained`). Returns the B1/B2 launches of the
    served load."""
    import os
    import shutil
    import tempfile
    import threading
    import numpy as np
    import torch
    from repro_torch.core import quantize
    from repro_torch.kernels.binary_matvec import ops
    from repro_torch.kernels.fused_mlp import ops as fops
    from repro_torch.netgen import ArtifactStore, NetServer, Session, telemetry
    from repro_torch.netgen.analysis import lint_store
    from repro_torch.netgen.engine import DeadlineExceededError

    target = "cuda[planes=true]"
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="engine-", dir=ROOT / "build"))
    store_dir, trace_dir = work / "store", work / "trace"
    trace_dir.mkdir()
    want = {f"v{v}": quantize.predict_quantized(net, device=dev)(images).cpu().numpy()
            for v, net in enumerate(nets)}
    extra = quantize.QuantizedNet(  # a fourth version, compiled during the load
        w1=quantize.int_cast_weights(np.random.default_rng(SEED + 9).normal(
            0, N_IN ** -0.5, (N_IN, N_HIDDEN))),
        w2=quantize.int_cast_weights(np.random.default_rng(SEED + 10).normal(
            0, N_HIDDEN ** -0.5, (N_HIDDEN, N_OUT))))
    launched = []                    # (thread, stream) of every launch in the phase
    originals = {mod: mod.stream_args for mod in (ops, fops)}

    def recording(original):
        def stream_args(t):
            out = original(t)
            launched.append((threading.current_thread().name, out[1]))
            return out
        return stream_args

    telemetry.reset()
    telemetry.enable()
    for mod, original in originals.items():
        mod.stream_args = recording(original)
    try:
        session = Session(device="cuda", store=ArtifactStore(store_dir))
        t0 = time.perf_counter()
        compiles = [session.compile_async(net, target=target) for net in nets]
        reset_launches()
        engine = session.engine(target=target, slot_capacity=BATCH, max_batch_delay=0.002)
        for v, net in enumerate(nets):
            engine.register(f"v{v}", net)
        for f in compiles:
            f.result(timeout=600)
        register_s = time.perf_counter() - t0
        if session.stats().compiles != 3:
            raise AssertionError(f"engine registration compiled again: {session.stats()}")
        registered = session.stats().row()
        # The first requests arrive while a fourth version compiles in the
        # background: they are answered without waiting for the build, on
        # the main thread's stream. They keep arriving, 24 at a time, from
        # before a worker picks the build up until it has finished (at
        # least 192), so every stage of the build, its device work
        # included, overlaps serving; the phase fails unless some were
        # answered while the build ran. This engine serves only them; the
        # timed load runs on a second engine, with no compile holding the host.
        background = session.compile_async(extra, target=target)
        early, during_build, r = [], 0, 0
        t0 = time.perf_counter()
        while r < 3 * 64 or not background.done():
            if time.perf_counter() - t0 > 600:
                raise AssertionError("the fourth version's build ran past 600 s")
            batch = [(q, engine.submit(f"v{q % 3}", images[q // 3 % len(images)]))
                     for q in range(r, r + 24)]
            for q, fut in batch:
                early.append((q, fut.result(timeout=60)))
                during_build += not background.done()
            r += 24
        early_s = time.perf_counter() - t0
        if not during_build:
            raise AssertionError("no request was answered while the fourth version compiled")
        if any(a != int(want[f"v{q % 3}"][q // 3 % len(images)]) for q, a in early):
            raise AssertionError("answers served during a background compile are wrong")
        extra_art = background.result(timeout=600)
        x = images[:BATCH]
        if not np.array_equal(extra_art(x).cpu().numpy(),
                              quantize.predict_quantized(extra, device=dev)(x).cpu().numpy()):
            raise AssertionError("the version compiled during serving disagrees")
        engine.shutdown()
        engine = session.engine(target=target, slot_capacity=BATCH, max_batch_delay=0.002)
        for v, net in enumerate(nets):
            engine.register(f"v{v}", net)
        if session.stats().compiles != 4:
            raise AssertionError(f"the second engine compiled again: {session.stats()}")
        n_req, producers, window = 3 * len(images), 8, 64
        futures = [None] * n_req

        def producer(k: int) -> None:
            slots = threading.BoundedSemaphore(window)
            for r in range(k, n_req, producers):
                if not slots.acquire(timeout=60):
                    raise AssertionError(f"producer {k}: no request resolved in 60 s")
                fut = engine.submit(f"v{r % 3}", images[r // 3])
                fut.add_done_callback(lambda _: slots.release())
                futures[r] = fut

        threads = [threading.Thread(target=producer, args=(k,), name=f"producer-{k}")
                   for k in range(producers)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        if any(t.is_alive() for t in threads) or any(f is None for f in futures):
            raise AssertionError("a producer did not submit all its requests")
        got = {f"v{v}": np.full(len(images), -1, np.int64) for v in range(3)}
        for r, fut in enumerate(futures):
            got[f"v{r % 3}"][r // 3] = fut.result(timeout=60)
        load_s = time.perf_counter() - t0
        counts = {name: wrappers[name].launches for name in NETGEN}
        b1_mma = ops.binary_forward_planes.mma_launches
        try:
            engine.submit("v0", images[0], deadline=0).result(timeout=60)
        except DeadlineExceededError:
            pass
        else:
            raise AssertionError("a request with a zero deadline was answered")
        engine.shutdown()
        stats = engine.stats()
        if [t.name for t in threading.enumerate() if t.name.startswith("netgen-engine")]:
            raise AssertionError("a netgen-engine thread outlived shutdown")
        for v in want:
            if not np.array_equal(got[v], want[v]):
                raise AssertionError(f"engine {v}: answers != predict_quantized")
        if len({id(f) for f in futures}) != n_req or stats.completed != n_req:
            raise AssertionError(f"engine lost or duplicated futures: {stats}")
        if stats.rejected_deadline != 1:
            raise AssertionError(f"the zero-deadline request was not rejected: {stats}")
        b1 = counts["binary_forward_planes"]
        if not 0 < b1_mma == b1:
            raise AssertionError(f"engine: {b1_mma} of {b1} B1 launches on the tensor cores")
        main_stream = torch.cuda.current_stream(dev).cuda_stream
        streams = {s for _, s in launched}
        if streams != {main_stream}:
            raise AssertionError(f"engine launches on streams {streams}, not {main_stream}")
        threads_seen = sorted({name.rsplit("-", 1)[0] if name.startswith("netgen-engine")
                               else name for name, _ in launched})
        reg = telemetry.get_registry()
        rows = reg.histogram("netgen_engine_batch_rows", engine=engine.scope)
        wait = reg.histogram("netgen_engine_queue_wait_seconds", engine=engine.scope)
        service = {v: reg.histogram("netgen_predict_latency_seconds",
                                    server=engine.server._scope, version=v)
                   for v in want}
        # each batch's dispatch (its span) and rows, in order; their sum
        # over the load's wall time is the batcher's dispatch share
        batches = [(r.duration_s, r.attrs["rows"]) for r in reg.spans()
                   if r.name == "netgen.engine.batch" and r.attrs.get("engine") == engine.scope]
        dispatch_s = sum(d for d, _ in batches)
        print(f"[4 engine path] {target}: 3 versions registered from the memory tier "
              f"({registered}), {register_s:.2f} s with their background compiles")
        print(f"[4 engine path] {len(early)} requests served while a fourth version compiled "
              f"({during_build} answered before its build finished): all equal "
              f"predict_quantized, and so does the fourth version")
        print(f"[4 engine path] {n_req} single requests from {producers} producers "
              f"({window} in flight each): {stats.row()}; all equal predict_quantized")
        print(f"[4 engine path] launches {counts}; binary_forward_planes {b1_mma} of {b1} "
              f"on the 1-bit tensor cores, binary_matmul_planes {counts['binary_matmul_planes']}; "
              f"{len(launched)} launches from {threads_seen}, all on stream {main_stream}")
        print(f"[4 engine path] zero-deadline request: DeadlineExceededError; shutdown "
              f"drained, no netgen-engine thread left")
        numbers = {
            "batches": stats.batches, "answers_per_s": n_req / load_s, "load_s": load_s,
            "dispatch_share": dispatch_s / load_s,
            "batch_ms": [d * 1e3 for d, _ in batches], "batch_rows": [n for _, n in batches],
            "during_compile": {"requests": len(early), "answered_while_building": during_build,
                               "answers_per_s": len(early) / early_s},
            "rows_per_batch": {"p50": rows.p50, "p99": rows.p99, "mean": rows.mean},
            "queue_wait_ms": {"p50": wait.p50 * 1e3, "p99": wait.p99 * 1e3},
            "service_ms": {v: {"p50": h.p50 * 1e3, "p99": h.p99 * 1e3, "count": h.count}
                           for v, h in service.items()},
            "device": torch.cuda.get_device_name(0), "power": smi}
        numbers["sustained"] = _engine_sustained(
            session, target, nets, images, want, producers, window)
        print(json.dumps({"engine": numbers}))

        warm = Session(device="cuda", store=ArtifactStore(store_dir))
        server = NetServer(session=warm, target=target, slot_capacity=BATCH)
        for v, net in enumerate(nets):
            server.register(f"v{v}", net)
        if (warm.stats().compiles, warm.store_stats().loads) != (0, 3):
            raise AssertionError(f"second session: {warm.stats()}, {warm.store_stats()}")
        again = server.predict_many({v: images for v in want})
        for v in want:
            if not np.array_equal(again[v], got[v]):
                raise AssertionError(f"second session {v}: answers != the first session's")
        print(f"[4 engine path] second session over the store: {warm.stats().row()}; "
              f"{warm.store_stats().row()}; {3 * len(images)} answers equal the first's")
        failures = lint_store(store_dir)
        if failures:
            raise AssertionError(f"lint_store: {failures}")
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        cli = subprocess.run([sys.executable, "-m", "repro_torch.netgen.analysis", "-q",
                              str(store_dir)], env=env, capture_output=True, text=True,
                             timeout=600)
        if cli.returncode != 0:
            raise AssertionError(f"linter CLI exit {cli.returncode}: {cli.stdout}{cli.stderr}")
        print(f"[4 engine path] lint_store: clean; CLI: {cli.stdout.strip()}")
        n_spans = telemetry.export_jsonl(trace_dir / "trace.jsonl")
        (trace_dir / "metrics.prom").write_text(telemetry.prometheus())
        gate = subprocess.run([sys.executable, str(ROOT / "benchmarks" / "check_trace.py"),
                               str(trace_dir)], capture_output=True, text=True, timeout=600)
        if gate.returncode != 0:
            raise AssertionError(f"check_trace.py exit {gate.returncode}: {gate.stderr}")
        print(f"[4 engine path] check_trace.py: {gate.stdout.strip()} ({n_spans} spans)")
        session.shutdown()
    finally:
        for mod, original in originals.items():
            mod.stream_args = original
        telemetry.disable()
    shutil.rmtree(work, ignore_errors=True)
    return {"binary_forward_planes": b1, "binary_forward_planes mma": b1_mma,
            "binary_matmul_planes": counts["binary_matmul_planes"]}


def _engine_sustained(session, target, nets, images, want, producers, window) -> dict:
    """The engine's warm steady state: a third engine over the same
    session, its stacked dispatch built by one untimed multi-version
    round, then the same producers (request r: version r % 3, image
    r // 3 cycling over the images) submitting for SUSTAIN_S seconds.
    Every answer must equal `predict_quantized`. Returns the window's
    answers per second, rows per batch, queue wait and service latency."""
    import threading
    import numpy as np
    from repro_torch.netgen import telemetry

    engine = session.engine(target=target, slot_capacity=BATCH, max_batch_delay=0.002)
    try:
        for v, net in enumerate(nets):
            engine.register(f"v{v}", net)
        t0 = time.perf_counter()
        engine.server.predict_many({v: images[:1] for v in want})
        warm_round_ms = (time.perf_counter() - t0) * 1e3
        submitted, stalled = [[] for _ in range(producers)], []
        t_end = time.perf_counter() + SUSTAIN_S

        def producer(k: int) -> None:
            slots = threading.BoundedSemaphore(window)
            r = k
            while time.perf_counter() < t_end:
                if not slots.acquire(timeout=60):
                    stalled.append(k)
                    return
                fut = engine.submit(f"v{r % 3}", images[r // 3 % len(images)])
                fut.add_done_callback(lambda _: slots.release())
                submitted[k].append((r, fut))
                r += producers

        threads = [threading.Thread(target=producer, args=(k,), name=f"producer-{k}")
                   for k in range(producers)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(SUSTAIN_S + 120)
        if any(t.is_alive() for t in threads) or stalled:
            raise AssertionError(f"sustained window: producers {stalled} stalled")
        n = 0
        for requests in submitted:
            for r, fut in requests:
                if fut.result(timeout=60) != want[f"v{r % 3}"][r // 3 % len(images)]:
                    raise AssertionError(f"sustained window: request {r} != predict_quantized")
                n += 1
        seconds = time.perf_counter() - t0
    finally:
        engine.shutdown()
    stats = engine.stats()
    if stats.completed != n:
        raise AssertionError(f"sustained window: {stats.completed} completed of {n}")
    reg = telemetry.get_registry()
    rows = reg.histogram("netgen_engine_batch_rows", engine=engine.scope)
    wait = reg.histogram("netgen_engine_queue_wait_seconds", engine=engine.scope)
    service = reg.histogram("netgen_predict_latency_seconds",
                            server=engine.server._scope, version="v0")
    print(f"[4 engine path] sustained window on a warm engine: {n} requests in "
          f"{seconds:.3f} s, {n / seconds:.0f} answers/s, queue wait p99 "
          f"{wait.p99 * 1e3:.3f} ms; all equal predict_quantized")
    return {"requests": n, "seconds": seconds, "answers_per_s": n / seconds,
            "batches": stats.batches, "warm_round_ms": warm_round_ms,
            "rows_per_batch": {"p50": rows.p50, "p99": rows.p99, "mean": rows.mean},
            "queue_wait_ms": {"p50": wait.p50 * 1e3, "p99": wait.p99 * 1e3},
            "service_ms_v0": {"p50": service.p50 * 1e3, "p99": service.p99 * 1e3,
                              "count": service.count}}


def _hw_path(session, net, images, dev, wrappers, reset_launches, smi) -> dict:
    """Phase 4(c), the paper's hardware output on the served v0 net
    (784-500-10): (a) the `cost` and `verilog` targets under
    `zeros,prune,addends`; (b) the addend-form net on the card through
    `cuda[fusednet=true]` and `cuda[planes=true]`, equal to the numpy
    interpreter on the circuit the Verilog was emitted from and to
    `predict_quantized`, and `cuda` under the named `hw` pipeline raising
    `IrregularCircuitError`; (c) adder sharing at 784 inputs on the
    784-4-10 net; (d) each compile's host seconds. Returns the launches
    of B1 (with those on the tensor cores) and B2 in this phase."""
    import hashlib
    import re
    import numpy as np
    from repro_torch.core import quantize
    from repro_torch.netgen import IrregularCircuitError, PipelineSpec, evaluate
    from repro_torch.netgen.analysis import summary_row
    from repro_torch.netgen.plan import lower_circuit

    spec = HW_SPEC
    timings = {}
    # (a) the hardware path
    cost = session.compile(net, target="cost", pipeline=spec)
    verilog = session.compile(net, target="verilog", pipeline=spec)
    timings["cost"], timings["verilog"] = cost.timings, verilog.timings
    report = cost.artifact
    fig7 = dict(report.paper_fig7)
    paper = {"lowered": "naive", "zeros": "pruned", "addends": "addend"}
    cells = [(name, c.total) for name, c in report.per_pass]
    print("[4 hw path] v0 784-500-10 cells per pass: " + ", ".join(
        f"{name} {n}" + (f" (paper Fig. 7 {paper[name]} ~{fig7[paper[name]]})"
                         if name in paper else "") for name, n in cells))
    text = verilog.artifact
    header = text.splitlines()[1]
    print(f"[4 hw path] verilog: {len(text.encode())} bytes, sha256 "
          f"{hashlib.sha256(text.encode()).hexdigest()}, header '{header}'")
    print(f"[4 hw path] {summary_row(verilog.analysis)}")
    if [name for name, _ in cells] != ["lowered", "zeros", "prune", "addends"]:
        raise AssertionError(f"cost per-pass stages {[n for n, _ in cells]}")
    if cost.pass_stats[-1].after.mults != 0 or report.final.mult_cells != 0:
        raise AssertionError("multipliers survive the addend rewrite")
    totals = [n for _, n in cells]
    if any(b > a for a, b in zip(totals, totals[1:])) or not totals[-1] < totals[0]:
        raise AssertionError(f"cells do not fall pass by pass: {totals}")
    if "784-500-10" not in header:
        raise AssertionError(f"verilog header {header!r}")
    body = text.split(");", 1)[1].split("// prediction")[0]
    if "*" in body:
        raise AssertionError("the addend-form module multiplies")
    widest = max(int(w) + 1 for w in re.findall(r"wire signed \[(\d+):0\]", text))
    if widest != verilog.analysis["max_width"]:
        raise AssertionError(f"widest accumulator {widest} bits != proof "
                             f"{verilog.analysis['max_width']}")
    if not verilog.analysis["int32_safe"]:
        raise AssertionError("the proof does not hold int32 accumulation safe")

    # (b) the addend-form net on the card
    circuit = verilog.circuit
    strict = evaluate(circuit, images, step_semantics="strict")
    msb = evaluate(circuit, images, step_semantics="msb")
    want = quantize.predict_quantized(net, device=dev)(images).cpu().numpy()
    if not np.array_equal(strict, want):
        raise AssertionError("the interpreter disagrees with predict_quantized")
    default_plan = session.compile(net, target="cuda[planes=true]").plan()
    for form in ("dense", "packed", "planes"):
        diags = lower_circuit(circuit, form=form).verify(collect=True)
        if diags:
            raise AssertionError(f"{form} plan of the addend form: {diags}")
    for a, b in zip(lower_circuit(circuit, form="planes").layers, default_plan.layers):
        for x, y in ((a.weights, b.weights), (a.pos_planes, b.pos_planes),
                     (a.neg_planes, b.neg_planes)):
            if not np.array_equal(x, y):
                raise AssertionError("the addend form lowers to other planes")
    reset_launches()
    answers = {}
    for target in ("cuda[fusednet=true]", "cuda[planes=true]"):
        art = session.compile(net, target=target, pipeline=spec)
        timings[target] = art.timings
        answers[target] = art(images).cpu().numpy()
    b1, b2 = wrappers["binary_forward_planes"], wrappers["binary_matmul_planes"]
    counts = {"binary_forward_planes": b1.launches, "binary_matmul_planes": b2.launches,
              "binary_forward_planes mma": b1.mma_launches}
    print(f"[4 hw path] addend form on the card: launches {counts}; "
          f"{b1.mma_launches} of {b1.launches} binary_forward_planes launches on the "
          "1-bit tensor cores; plans equal the default pipeline's, verify() clean on "
          "dense, packed and planes")
    if not (b1.launches > 0 and b2.launches > 0 and b1.mma_launches == b1.launches):
        raise AssertionError(f"the addend-form path launched {counts}")
    for target, got in answers.items():
        if not (np.array_equal(got, strict) and np.array_equal(got, want)):
            raise AssertionError(f"{target} on the addend form != evaluate / "
                                 "predict_quantized")
    print(f"[4 hw path] {len(images)} answers of each target equal evaluate(strict) "
          f"and predict_quantized; the msb step would change "
          f"{int((msb != strict).sum())} of them")
    r = np.random.default_rng(SEED)
    tiny = quantize.QuantizedNet(weights=[r.integers(-2, 3, size=s).astype(np.int32)
                                          for s in ((16, 8), (8, N_OUT))])
    try:
        session.compile(tiny, target="cuda", pipeline="hw")
    except IrregularCircuitError as e:
        print(f"[4 hw path] cuda under hw ({PipelineSpec.named('hw')}) on a 16-8-10 net "
              f"raises IrregularCircuitError: {e}")
    else:
        raise AssertionError("cuda took a CSE-shared circuit")

    # (c) adder sharing at 784 inputs
    r = np.random.default_rng(0)
    wide = quantize.QuantizedNet(weights=[r.integers(-2, 3, size=s).astype(np.int32)
                                          for s in ((N_IN, 4), (4, N_OUT))])
    shared = session.compile(wide, target="verilog[style=generic]", pipeline=CSE_SPEC)
    timings["cse verilog"] = shared.timings
    stats = shared.pass_stats[-1]
    got = evaluate(shared.circuit, images)
    want = quantize.predict_quantized(wide, device=dev)(images).cpu().numpy()
    print(f"[4 hw path] 784-4-10 {stats.row()}, adds saved {stats.adds_saved}; "
          f"{len(images)} answers of evaluate equal predict_quantized")
    if stats.adds_saved <= 0 or "// shared sub-sums" not in shared.artifact:
        raise AssertionError("adder sharing found nothing at 784 inputs")
    if not np.array_equal(got, want):
        raise AssertionError("the shared DAG disagrees with predict_quantized")

    # (d) host seconds
    print(json.dumps({"hw_compile_s": timings, "power": smi}))
    return counts


PAPER_ACC = {"L0_baseline": 0.98, "L1_step_act": 0.95, "L2_binary_input": 0.94,
             "L3_int_weights": 0.92}          # the paper's §III figures
PAPER_TUNED = ("cuda[tuned=true]", "cuda[tuned=true,planes=true]", "fused[tuned=true]")
PAPER_EXPLORE = ("default", "zeros,prune,addends")   # the explorer's pipeline axis
PAPER_PHASE_S = 240.0                                # a run past this fails the phase


def _paper_band(acc: dict, label: str) -> None:
    """The reference test's band (`tests/test_core_ladder.py`): L0 > 0.85,
    and L1, L2 and L3 each within 0.10 of L0."""
    a0 = acc["L0_baseline"]
    if not a0 > 0.85 or any(acc[k] <= a0 - 0.10 for k in list(PAPER_ACC)[1:]):
        raise AssertionError(f"{label}: accuracies {acc} leave the reference band")


def _paper_path(dev, wrappers, reset_launches, smi) -> dict:
    """Phase 4(d), the paper's whole pipeline on the card: train 784-500-10
    with `MLPConfig()` (60 epochs, batches of 10, lr 2) on
    `dataset.train_test_split(1000, 1000, seed=0)`; L0-L3 beside the
    paper's figures, within the reference test's band; `run_ladder` with
    the `torch`, `cuda` and `fused` backends (its own training, seed 1),
    every backend bit-exact with `predict_l3`; through a
    `Session(tune_store=...)`, `cuda[tuned=true]`,
    `cuda[tuned=true,planes=true]` and `fused[tuned=true]`, each
    predictor's answers bit-exact with `predict_l3` and each call
    launching its CUDA kernels, each search's whole surface printed; a
    second session over the tune store compiling the same targets with 0
    measurements; `session.explore` (latency, budget 8, seed 0) over
    `default` and `zeros,prune,addends`, after which
    `cuda[explored=true]` resolves the winner (one `hit`, 0
    measurements); a `NetServer` stacked round of the trained net and
    its `int_cast_weights(bound=5)` variant equal to `predict_quantized`;
    and `benchmarks/check_trace.py` on the phase's trace. Returns the
    phase's launches of B1-B5 (with those on the tensor cores)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import dataset, mlp, quantize
    from repro_torch.core.ladder import run_ladder
    from repro_torch.netgen import NetServer, Session, telemetry
    from repro_torch.netgen.explore import SearchSpace

    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="paper-", dir=ROOT / "build"))
    tune_dir, trace_dir = work / "tune", work / "trace"
    trace_dir.mkdir()
    names = ("binary_forward_planes", "binary_matmul_planes", "binary_matmul",
             "binary_matmul_packed", "fused_mlp_predict")
    numbers = {"device": torch.cuda.get_device_name(0), "power": smi}
    telemetry.reset()
    telemetry.enable()
    try:
        t_phase = time.perf_counter()
        reset_launches()
        xtr, ytr, xte, yte = dataset.train_test_split(1000, 1000, seed=0)
        cfg = mlp.MLPConfig()
        t0 = time.perf_counter()
        params = mlp.train(cfg, xtr, ytr, device=dev)
        train_s = time.perf_counter() - t0
        print(f"[4 paper path] train {'-'.join(map(str, mlp.layer_sizes(cfg)))}, "
              f"{cfg.epochs} epochs x {len(xtr) // 10} batches of 10, lr {cfg.lr}, seed "
              f"{cfg.seed}: {train_s:.2f} s wall")
        fns = {"L0_baseline": mlp.predict_l0(params, dev),
               "L1_step_act": quantize.predict_l1(params, dev),
               "L2_binary_input": quantize.predict_l2(params, dev),
               "L3_int_weights": quantize.predict_l3(params, dev)}
        acc = {k: mlp.accuracy(f, xte, yte) for k, f in fns.items()}
        print("[4 paper path] ladder on 1000 test images: " + ", ".join(
            f"{k} {v:.3f} (paper {PAPER_ACC[k]:.2f})" for k, v in acc.items()))
        _paper_band(acc, "MLPConfig()")
        l3 = fns["L3_int_weights"](xte)

        t0 = time.perf_counter()
        ladder = run_ladder(n_train=1000, n_test=1000, epochs=60, seed=0,
                            backends=("torch", "cuda", "fused"), device=dev)
        ladder_s = time.perf_counter() - t0
        print(f"[4 paper path] run_ladder(seed=0, backends torch/cuda/fused) in "
              f"{ladder_s:.2f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in ladder.acc.items())
              + f"; exact_l4_l5={ladder.exact_l4_l5}, zero fraction "
              f"{ladder.stats.zero_fraction:.3f}")
        _paper_band(ladder.acc, "run_ladder")
        if not ladder.exact_l4_l5:
            raise AssertionError("run_ladder: an L4/L5 backend differs from predict_l3")

        qnet = quantize.quantize(params)
        session = Session(device=dev, tune_store=tune_dir)
        surfaces = {}
        for target in PAPER_TUNED:
            before = set(session.tuner.store.keys())
            t0 = time.perf_counter()
            art = session.compile(qnet, target=target)
            compile_s = time.perf_counter() - t0
            counts = {n: wrappers[n].launches for n in names}
            preds = art(xte)
            torch.cuda.synchronize()
            launched = sum(wrappers[n].launches - counts[n] for n in names)
            if launched != art.artifact.launches_per_call:
                raise AssertionError(f"{target}: {launched} kernel launches, want "
                                     f"{art.artifact.launches_per_call}")
            if not torch.equal(preds, l3):
                raise AssertionError(f"{target}: answers != predict_l3")
            (key,) = set(session.tuner.store.keys()) - before
            rec = session.tuner.store.get(key)
            surfaces[target] = {"winner": rec.best, "compile_s": compile_s,
                                "us": [[p, us] for p, us in rec.measurements]}
            print(f"[4 paper path] {target}: winner {rec.best} "
                  f"({art.artifact.datapath}, {launched} launches a call) of "
                  f"{len(rec.measurements)} measured in {compile_s:.2f} s; surface us: "
                  + ", ".join(f"{p.get('form', 'fused')} {p['bm']}x{p.get('bn', '-')} {us:.1f}"
                              for p, us in rec.measurements))
        stats = session.tune_stats()
        print(f"[4 paper path] first session: {stats.row()}; 1000 answers of each "
              "tuned target equal predict_l3")
        warm = Session(device=dev, tune_store=tune_dir)
        for target in PAPER_TUNED:
            if not torch.equal(warm.compile(qnet, target=target)(xte), l3):
                raise AssertionError(f"second session {target}: answers != predict_l3")
        ws = warm.tune_stats()
        if (ws.measurements, ws.tunes) != (0, 0):
            raise AssertionError(f"second session over the tune store measured: {ws.row()}")
        print(f"[4 paper path] second session over the tune store: {ws.row()}")

        t0 = time.perf_counter()
        report = session.explore(qnet, objective="latency", budget=8, seed=0,
                                 space=SearchSpace(pipelines=PAPER_EXPLORE))
        explore_s = time.perf_counter() - t0
        print(f"[4 paper path] {report.describe()} in {explore_s:.2f} s; evaluations us: "
              + ", ".join(f"{c['pipeline']}/{c['form']} {c['bm']}x{c['bn']} {v:.1f}"
                          for c, v in report.evaluations))
        hits = telemetry.get_registry().counter("netgen_explored_resolved_total",
                                                outcome="hit")
        measured = session.tune_stats().measurements
        explored = session.compile(qnet, target="cuda[explored=true]",
                                   pipeline=report.best.pipeline)
        if hits.value != 1 or session.tune_stats().measurements != measured:
            raise AssertionError(f"cuda[explored=true]: hits {hits.value}, measurements "
                                 f"{session.tune_stats().measurements - measured}")
        if not torch.equal(explored(xte), l3):
            raise AssertionError("cuda[explored=true]: answers != predict_l3")
        print(f"[4 paper path] cuda[explored=true] under '{report.best.pipeline}': "
              f"{explored.artifact.datapath} {explored.artifact.blocks}, "
              f"netgen_explored_resolved_total{{outcome=\"hit\"}} = {int(hits.value)}, "
              "0 measurements; 1000 answers equal predict_l3")

        variant = quantize.QuantizedNet(weights=[
            quantize.int_cast_weights(w, bound=5) for w in quantize.param_weights(params)])
        server = NetServer(session=session, target="cuda", slot_capacity=BATCH)
        server.register("paper", qnet)
        server.register("paper-b5", variant)
        before = int(hits.value)
        out = server.predict_many({"paper": xte, "paper-b5": xte})
        for name, net in (("paper", qnet), ("paper-b5", variant)):
            want = quantize.predict_quantized(net, device=dev)(xte).cpu().numpy()
            if not np.array_equal(out[name], want):
                raise AssertionError(f"stacked round {name}: answers != predict_quantized")
        if server.dispatch_counts["stacked"] < 1:
            raise AssertionError(f"no stacked dispatch: {server.dispatch_counts}")
        stacked = [f for f in server._multi.values() if f is not None]
        print(f"[4 paper path] NetServer stacked round (paper + int_cast_weights(bound=5)): "
              f"dispatch {server.dispatch_counts}, stacked datapath "
              f"{stacked[0].datapath if stacked else None}, explored record "
              f"{'hit' if hits.value > before else 'miss'}; 2000 answers equal "
              "predict_quantized")

        n_spans = telemetry.export_jsonl(trace_dir / "trace.jsonl")
        (trace_dir / "metrics.prom").write_text(telemetry.prometheus())
        gate = subprocess.run([sys.executable, str(ROOT / "benchmarks" / "check_trace.py"),
                               str(trace_dir)], capture_output=True, text=True, timeout=600)
        if gate.returncode != 0:
            raise AssertionError(f"check_trace.py exit {gate.returncode}: {gate.stderr}")
        print(f"[4 paper path] check_trace.py: {gate.stdout.strip()} ({n_spans} spans)")
        counts = {n: wrappers[n].launches for n in names}
        mma = {n: wrappers[n].mma_launches for n in names if hasattr(wrappers[n], "mma_launches")}
        phase_s = time.perf_counter() - t_phase
        print(f"[4 paper path] launches {counts}, on the tensor cores {mma}; phase "
              f"{phase_s:.1f} s")
        for n in names:
            if counts[n] <= 0:
                raise AssertionError(f"the paper path never launched {n}")
        if phase_s > PAPER_PHASE_S:
            raise AssertionError(f"the paper path took {phase_s:.1f} s")
        numbers.update(train_s=train_s, acc=acc, ladder_acc=ladder.acc, ladder_s=ladder_s,
                       tuned=surfaces, explore_s=explore_s, explore=report.as_dict(),
                       phase_s=phase_s)
        print(json.dumps({"paper": numbers}))
    finally:
        telemetry.disable()
    shutil.rmtree(work, ignore_errors=True)
    return {**counts, "mma": mma}


def _lm_main_path(dev, wrappers, reset_launches):
    """Phase 4(b): mamba2-2.7b at full width and depth, served by
    `Engine.generate` from the fp32 checkpoint and its W8 form, aligned
    and ragged prompts; then `qlinear` on the W8 weights. Returns
    ({kernel: launches on its main path}, {run: wall times})."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import api, base
    from repro_torch.quantized import apply as qapply
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = configs.get_config(LM_ARCH)
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = base.tree_init(api.abstract_params(cfg),
                                torch.Generator(device=dev).manual_seed(SEED), dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        w8 = qapply.quantize_params_for_serving(cfg, params, min_size=0)
        torch.cuda.synchronize()
    print(f"[4 lm path] {LM_ARCH}: {base.count_params(api.abstract_params(cfg))} parameters, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, compute {cfg.compute_dtype}; "
          f"init {init_s:.2f} s, W8 {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB allocated")
    rng = np.random.default_rng(SEED)
    prompts = {kind: rng.integers(0, cfg.vocab, size=(LM_BATCH, s)).astype(np.int32)
               for kind, s in (("aligned", LM_PROMPT), ("ragged", LM_RAGGED))}
    sc = ServeConfig(max_len=LM_PROMPT + LM_NEW + 8, max_new_tokens=LM_NEW)
    # one untimed generate first: the process's first prefill also pays
    # cuBLAS and module set-up (about 3x a warm prefill on an H100)
    Engine(cfg, params, ServeConfig(max_len=LM_PROMPT + 8, max_new_tokens=2),
           device=dev).generate(prompts["aligned"])
    launches, times = {}, {}
    for ckpt, p in (("fp32", params), ("w8", w8)):
        engine = Engine(cfg, p, sc, device=dev)
        for kind, pr in prompts.items():
            reset_launches()
            t0 = time.perf_counter()
            out = engine.generate(pr)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {name: w.launches for name, w in wrappers.items()}
            decode_ms = statistics.median(engine.stats["decode_s"]) * 1e3
            print(f"[4 lm path] {ckpt} {kind} {pr.shape[0]}x{pr.shape[1]}: {wall:.2f} s, "
                  f"prefill {engine.stats['prefill_s'] * 1e3:.1f} ms, decode "
                  f"{decode_ms:.2f} ms/token, launches {counts}")
            mma = wrappers["ssd_scan"].mma_launches
            print(f"[4 lm path] {ckpt} {kind}: {mma} of {counts['ssd_scan']} ssd_scan launches "
                  "on the tensor cores")
            if not counts["ssd_scan"] == mma == cfg.n_layers:
                raise AssertionError(f"{ckpt} {kind}: ssd launched {counts['ssd_scan']} times "
                                     f"({mma} on the tensor cores) in one prefill, want "
                                     f"{cfg.n_layers} on the tensor cores")
            if out.shape != (LM_BATCH, LM_NEW) or out.min() < 0 or out.max() >= cfg.vocab:
                raise AssertionError(f"{ckpt} {kind}: bad tokens, shape {out.shape}")
            launches["ssd_scan"] = counts["ssd_scan"]
            launches["ssd_scan mma"] = mma
            times[f"{ckpt} {kind}"] = {
                "prefill_ms": engine.stats["prefill_s"] * 1e3,
                "decode_ms_per_token": decode_ms, "generate_s": wall,
                "ssd_launches": counts["ssd_scan"],
                "routes": _check_routes(cfg, p, pr, out, dev, f"{ckpt} {kind}")}
    launches["quant_matmul"] = _qlinear_path(cfg, w8, prompts["aligned"], dev,
                                             reset_launches)
    trace = _lm_profile(cfg, params, prompts["aligned"], dev)
    del params, w8, engine
    torch.cuda.empty_cache()
    return launches, times, trace


def _profile_call(fn) -> dict:
    """Where one warm call's time goes: wall time from a run without the
    profiler (after one untimed run), then `torch.profiler` over another
    run for the device busy time (the sum of the kernels' spans on the one
    stream), the kernel launches, and the kernels that take longest,
    summed by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall_ms), "kernel_launches": len(kernels),
            "top_ms": [[n[:70], ms] for n, ms in top]}


def _print_profile(tag: str, name: str, rec: dict) -> None:
    print(f"[4 {tag}] profile {name}: wall {rec['wall_ms']:.1f} ms, device busy "
          f"{rec['device_busy_ms']:.1f} ms (idle {rec['idle_share']:.3f}), "
          f"{rec['kernel_launches']} kernel launches; longest: "
          + ", ".join(f"{n[:40]} {ms:.1f} ms" for n, ms in rec["top_ms"][:3]))


def _lm_profile(cfg, params, prompts, dev, tag: str = "lm path", extras=None) -> dict:
    """Where an LM path's time goes (`_profile_call`): one warm prefill
    (kernel route, where the family has one; with the prompt's modality
    `extras`) and one decode step of the fp32 checkpoint."""
    import torch
    from repro_torch.models import api, base

    out = {}
    with torch.inference_mode():
        B, P = prompts.shape
        batch = {"tokens": torch.as_tensor(prompts, device=dev).long(),
                 **_on(extras or {}, dev)}
        cache = base.tree_init(api.abstract_cache(cfg, B, P + 1),
                               torch.Generator(device=dev), dev)
        logits, state = api.prefill(cfg, params, batch, cache, use_kernel=True)
        nxt = logits.argmax(-1)[:, None]
        pos = torch.full((B,), P, dtype=torch.int32, device=dev)
        steps = {"prefill": lambda: api.prefill(cfg, params, batch, cache, use_kernel=True),
                 "decode_step": lambda: api.decode_step(cfg, params, nxt, pos, state)}
        for name, fn in steps.items():
            out[name] = _profile_call(fn)
            _print_profile(tag, name, out[name])
    return out


def _on(arrays: dict, dev) -> dict:
    """numpy arrays -> tensors on `dev`, their dtypes kept."""
    import torch
    return {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}


def _prefill(cfg, params, tokens, dev, use_kernel: bool):
    """(last-position logits in fp32, final SSM states) of `api.prefill`."""
    import torch
    from repro_torch.models import api, base
    cache = base.tree_init(api.abstract_cache(cfg, tokens.shape[0], tokens.shape[1]),
                           torch.Generator(device=dev), dev)
    logits, state = api.prefill(cfg, params, {"tokens": tokens}, cache, use_kernel=use_kernel)
    return logits.float(), state["ssm"]["ssm"] if cfg.family == "hybrid" else state["ssm"]


def _check_routes(cfg, params, prompts, out, dev, label: str, tag: str = "lm path") -> dict:
    """The kernel route against `use_kernel=False`; returns the readings.

    1. Per layer, in bf16 as served: both mixers take the same input (the
       plain route's residual stream, through zamba's shared block after
       every `attn_every` layers); each layer's output and final SSM
       state must lie within ROUTE_ULPS bf16 ulps (eps_bf16 x the plain
       value's largest magnitude) of the plain route's.
    2. End to end in fp32 compute (`compute_dtype="float32"`), where the
       kernel route casts nothing: logits and final states within
       FP32_ROUTE_RTOL of the plain route's largest magnitude, and equal
       greedy tokens wherever the plain route's top-2 margin exceeds twice
       the logit bound.
    3. End to end in bf16, reported, not bounded, with two witnesses of
       where the gap comes from: the plain SSD given the kernel route's
       inputs (dt rounded to bf16; `ssd` swapped for its plain version for
       this one prefill), and the plain route in fp32 compute. Each pair's
       largest difference is relative to its second member's largest
       magnitude.
    The engine's first token must be the greedy token of the kernel
    route's own prefill (the engine's consistency, not a route check)."""
    import dataclasses
    from unittest import mock
    import torch
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.layers import embedding, norms
    from repro_torch.layers import mamba2 as m2
    from repro_torch.models import mamba, zamba

    def rel(a, b) -> float:
        return ((a - b).abs().max() / b.abs().max()).item()

    eps = torch.finfo(torch.bfloat16).eps
    worst = {"out": 0.0, "ssm": 0.0}
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.inference_mode():
        tokens = torch.as_tensor(prompts, device=dev).long()
        h = emb0 = embedding.embed(cfg, params["embed"], tokens)
        positions = torch.arange(tokens.shape[1], device=dev)[None].expand(*tokens.shape)
        for i in range(cfg.n_layers):
            lp = mamba.layer(params["layers"], i)
            hn = norms.apply_norm(cfg.norm, lp["ln"], h, eps=cfg.norm_eps)
            ok, sk = m2.mamba_mixer(cfg, lp["mixer"], hn, use_kernel=True, return_state=True)
            op, sp = m2.mamba_mixer(cfg, lp["mixer"], hn, use_kernel=False, return_state=True)
            for key, k, p in (("out", ok.float(), op.float()), ("ssm", sk["ssm"], sp["ssm"])):
                ulps = ((k - p).abs().max() / (eps * p.abs().max())).item()
                worst[key] = max(worst[key], ulps)
            h = h + op
            if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
                h, _ = zamba._shared_block(cfg, params["shared"], h, emb0, positions, None, None)
        kern, plain = (_prefill(cfg, params, tokens, dev, uk) for uk in (True, False))
        with mock.patch.object(sops, "ssd", sref.ssd):
            dt_bf16 = _prefill(cfg, params, tokens, dev, True)
        kern32, plain32 = (_prefill(cfg32, params, tokens, dev, uk) for uk in (True, False))
    top2 = plain32[0].topk(2, dim=-1).values
    tol = FP32_ROUTE_RTOL * plain32[0].abs().max()
    decided = (top2[:, 0] - top2[:, 1]) > 2 * tol
    readings = {
        "layer_ulps": worst,
        "fp32_compute": {"logits": rel(kern32[0], plain32[0]),
                         "ssm": rel(kern32[1], plain32[1]),
                         "rows_decided": int(decided.sum()),
                         "greedy_equal": int((kern32[0].argmax(-1)
                                              == plain32[0].argmax(-1)).sum())},
        "bf16": {pair: {"logits": rel(a[0], b[0]), "ssm": rel(a[1], b[1])}
                 for pair, a, b in (("kernel~plain", kern, plain),
                                    ("kernel~plain_ssd_dt_bf16", kern, dt_bf16),
                                    ("plain_ssd_dt_bf16~plain", dt_bf16, plain),
                                    ("plain~plain_fp32_compute", plain, plain32))},
        "bf16_greedy_equal": int((kern[0].argmax(-1) == plain[0].argmax(-1)).sum()),
    }
    print(f"[4 {tag}] {label} kernel vs plain route: per layer (bf16) outputs within "
          f"{worst['out']:.3g} and states within {worst['ssm']:.3g} bf16 ulps of the "
          f"layer's scale (bound {ROUTE_ULPS}); end to end in fp32 compute "
          f"{json.dumps(readings['fp32_compute'])} (bound {FP32_ROUTE_RTOL}); "
          f"in bf16 {json.dumps(readings['bf16'])}, greedy equal on "
          f"{readings['bf16_greedy_equal']}/{prompts.shape[0]} rows")
    if max(worst.values()) > ROUTE_ULPS:
        raise AssertionError(f"{label}: a layer's kernel route leaves its bound")
    fp32 = readings["fp32_compute"]
    if max(fp32["logits"], fp32["ssm"]) > FP32_ROUTE_RTOL:
        raise AssertionError(f"{label}: fp32-compute routes differ beyond {FP32_ROUTE_RTOL}")
    if not torch.equal(kern32[0].argmax(-1)[decided], plain32[0].argmax(-1)[decided]):
        raise AssertionError(f"{label}: fp32-compute greedy tokens differ where decided")
    first = torch.as_tensor(out[:, 0], device=dev).long() == kern[0].argmax(-1)
    k2 = kern[0].topk(2, dim=-1).values
    if not all(torch.isfinite(t).all() for t in (*kern, *plain, *kern32, *plain32)) or \
            not bool(first[k2[:, 0] > k2[:, 1]].all()):
        raise AssertionError(f"{label}: the engine's first token is not its prefill's")
    return readings


def _qlinear_path(cfg, w8, prompts, dev, reset_launches) -> int:
    """`qlinear` on the W8 layer-0 `in_proj` and `out_proj` with that
    prefill's activations: the normed layer input, and the gated-norm
    output (read by running the mixer with `out_proj` set to the
    identity, exact in any dtype). Each must equal plain `qlinear`
    exactly. Returns the launches of `quant_matmul`."""
    import torch
    from repro_torch.kernels.quant_matmul import ops as qops
    from repro_torch.kernels.quant_matmul import ref as qref
    from repro_torch.layers import embedding, norms
    from repro_torch.layers import mamba2 as m2
    from repro_torch.models import mamba

    with torch.inference_mode():
        toks = torch.as_tensor(prompts, device=dev).long()
        lp0 = mamba.layer(w8["layers"], 0)
        h = embedding.embed(cfg, w8["embed"], toks)
        hn = norms.apply_norm(cfg.norm, lp0["ln"], h, eps=cfg.norm_eps)
        eye = {**lp0["mixer"], "out_proj": torch.eye(cfg.d_inner, device=dev)}
        yg = m2.mamba_mixer(cfg, eye, hn, use_kernel=True)
        acts = {"in_proj": (hn.reshape(-1, cfg.d_model), lp0["mixer"]["in_proj"]),
                "out_proj": (yg.reshape(-1, cfg.d_inner), lp0["mixer"]["out_proj"])}
        # the K-major weights the kernel reads, made once, as a caller would
        held = {name: qops.qmm_weights(w["q"]) for name, (_, w) in acts.items()}
        reset_launches()
        got = {name: qops.qlinear(a, held[name], w["s"]) for name, (a, w) in acts.items()}
        torch.cuda.synchronize()
        n = qops.quant_matmul.launches
        for name, (a, w) in acts.items():
            want = qref.qlinear_ref(a, w["q"], w["s"])
            err = (got[name].float() - want.float()).abs().max().item()
            print(f"[4 lm path] qlinear w8 layer 0 {name}: {tuple(a.shape)} {a.dtype} x "
                  f"{tuple(w['q'].shape)} int8, max_abs_err={err}, launches {n}")
            if not torch.equal(got[name], want):
                raise AssertionError(f"qlinear {name} disagrees with plain qlinear")
    if n <= 0:
        raise AssertionError("qlinear never launched quant_matmul")
    return n


def _cache_bytes(cfg, batch: int, max_len: int) -> int:
    """Bytes of `api.abstract_cache`: the KV cache, and zamba's SSM cache."""
    import math
    from repro_torch.models import api, base
    total = 0

    def add(info):
        nonlocal total
        total += math.prod(info.shape) * info.dtype.itemsize

    base.tree_map(add, api.abstract_cache(cfg, batch, max_len))
    return total


def _dense_generate(cfg, params, prompts, new: int, dev, label: str,
                    tag: str = "dense path", extras=None) -> dict:
    """`Engine.generate` of `new` tokens after `prompts` (and the prompt's
    modality `extras`, numpy); checks the tokens' shape and range and
    returns the run's times, cache bytes and first tokens."""
    import torch
    from repro_torch.serve.engine import Engine, ServeConfig

    B, P = prompts.shape
    sc = ServeConfig(max_len=P + new + 8, max_new_tokens=new)
    engine = Engine(cfg, params, sc, device=dev)
    t0 = time.perf_counter()
    out = engine.generate(prompts, extras)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if out.shape != (B, new) or out.min() < 0 or out.max() >= cfg.vocab:
        raise AssertionError(f"{cfg.name} {label}: bad tokens, shape {out.shape}")
    kv_bytes = _cache_bytes(cfg, B, sc.max_len)
    rec = {"prefill_ms": engine.stats["prefill_s"] * 1e3,
           "decode_ms_per_token": statistics.median(engine.stats["decode_s"]) * 1e3,
           "generate_s": wall, "kv_cache_bytes": kv_bytes, "first_tokens": out[:, 0].tolist()}
    what = "KV + SSM cache" if cfg.family == "hybrid" else "KV cache"
    print(f"[4 {tag}] {cfg.name} {label} {B}x{P} + {new} tokens: {wall:.2f} s, "
          f"prefill {rec['prefill_ms']:.1f} ms, decode {rec['decode_ms_per_token']:.2f} "
          f"ms/token, {what} {kv_bytes / 1e9:.3f} GB ({cfg.compute_dtype})")
    return rec


def _teacher_forcing(cfg, params, prompts, dev, tag: str = "dense path",
                     extras=None) -> dict:
    """In fp32 compute: the engine's greedy tokens against the argmax of a
    teacher-forced `api.forward` over prompt + generation (position P+i-1
    predicts token i). A token may differ only where the forward's top-2
    margin is below TF_MARGIN_RTOL of the largest |logit| (a near tie
    that fp32 summation order can flip); such positions are counted. The
    forward's position P-1 is the prefill's last position, so `prefill`'s
    logits are held to it within the reference's PREFILL_TOL. The prompt's
    modality `extras` reach the engine and the prefill; the forward gets
    them extended over the generated positions as `decode_step` supplies
    them (`_extend_extras`)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import api, base
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    B, P = prompts.shape
    extras = extras or {}
    gen = Engine(cfg32, params, ServeConfig(max_len=P + TF_NEW + 8, max_new_tokens=TF_NEW),
                 device=dev).generate(prompts, extras)
    with torch.inference_mode():
        seq = torch.as_tensor(np.concatenate([prompts, gen], axis=1), device=dev).long()
        logits = api.forward(cfg32, params, {"tokens": seq, **_on(
            _extend_extras(extras, P, TF_NEW), dev)})[0][:, P - 1:-1]          # (B, new, V)
        cache = base.tree_init(api.abstract_cache(cfg32, B, P), torch.Generator(device=dev), dev)
        last, _ = api.prefill(cfg32, params, {"tokens": seq[:, :P], **_on(extras, dev)}, cache)
    top2 = logits.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    bound = TF_MARGIN_RTOL * logits.abs().max()
    differ = logits.argmax(-1) != torch.as_tensor(gen, device=dev).long()
    excused = int((differ & (margin < bound)).sum())
    prefill_err = (last - logits[:, 0]).abs().max().item()
    rec = {"tokens": int(differ.numel()), "differ": int(differ.sum()), "excused": excused,
           "margin_bound": bound.item(), "prefill_vs_forward_max_abs": prefill_err}
    print(f"[4 {tag}] {cfg.name} fp32 teacher forcing {B}x{P} + {TF_NEW}: "
          f"{rec['tokens'] - rec['differ']} of {rec['tokens']} greedy tokens equal the forward's "
          f"argmax, {excused} excused (top-2 margin < {rec['margin_bound']:.3g}); prefill vs "
          f"forward max |diff| {prefill_err:.3g} (bound {PREFILL_TOL})")
    if rec["differ"] != excused:
        raise AssertionError(f"{cfg.name}: engine tokens differ from teacher forcing where "
                             "the margin decides them")
    if not torch.allclose(last, logits[:, 0], rtol=PREFILL_TOL, atol=PREFILL_TOL):
        raise AssertionError(f"{cfg.name}: prefill's last logits differ from forward's")
    return rec


def _extend_extras(extras: dict, P: int, new: int) -> dict:
    """A prompt's modality inputs (numpy, (B, P, ...)) extended over `new`
    generated positions with what `decode_step` supplies there: zero
    `pixel_embeds`/`frame_embeds`, a false `pixel_mask`, and M-RoPE
    `positions` (B, 3, P) continued with each position's index."""
    import numpy as np
    out = {}
    for k, v in extras.items():
        if k == "positions":
            tail = np.broadcast_to(np.arange(P, P + new, dtype=v.dtype), v.shape[:-1] + (new,))
            out[k] = np.concatenate([v, tail], axis=-1)
        else:
            out[k] = np.concatenate([v, np.zeros((v.shape[0], new) + v.shape[2:], v.dtype)],
                                    axis=1)
    return out


def _flash_check(cfg, params, tokens, dev) -> dict:
    """flash_attention against flash_attention_ref on layer 0's q/k/v of a
    prompt (after RoPE), in fp32 and in bf16 compute, within the
    reference test's bounds (FLASH_TOL)."""
    import dataclasses
    import torch
    from repro_torch.layers import attention, embedding, flash, norms, rotary
    from repro_torch.models import base

    out = {}
    with torch.inference_mode():
        lp = base.layer(params["layers"], 0)
        B, S = tokens.shape
        pos = torch.arange(S, device=dev)[None].expand(B, S)
        for dtype, tol in FLASH_TOL.items():
            c = dataclasses.replace(cfg, compute_dtype=dtype)
            h = embedding.embed(c, params["embed"], tokens)
            hn = norms.apply_norm(c.norm, lp["ln_attn"], h, eps=c.norm_eps,
                                  plus_one=c.norm_plus_one)
            q, k, v = (attention._project(hn, lp["attn"][w], lp["attn"].get(b))
                       for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
            q, k = (rotary.rope(t, pos, c.rope_theta) for t in (q, k))
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            got = flash.flash_attention(q, k, v).float()
            want = flash.flash_attention_ref(q, k, v).float()
            err = (got - want).abs().max().item()
            out[dtype] = err
            print(f"[4 dense path] {cfg.name} layer 0 flash_attention vs flash_attention_ref "
                  f"{tuple(q.shape)} {dtype}: max |diff| {err:.3g} (bound {tol})")
            if not torch.allclose(got, want, rtol=tol, atol=tol):
                raise AssertionError(f"flash_attention disagrees with its dense oracle in {dtype}")
    return out


def _rel_max(got, want) -> float:
    """max |got - want| as a share of want's largest |value|."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _bf16_decode_check(cfg, params, prompts, dev, tag: str = "dense path",
                       bound: float = BF16_DECODE_RTOL, extras=None) -> float:
    """One decode step in the configured bf16 compute against the same step
    in fp32 compute: both prefill `prompts` (with the prompt's modality
    `extras`), then decode the fp32 path's greedy token at position P.
    Returns the logits' `_rel_max`."""
    import dataclasses
    import torch
    from repro_torch.models import api, base

    B, P = prompts.shape
    toks = torch.as_tensor(prompts, device=dev).long()
    pos = torch.full((B,), P, dtype=torch.int32, device=dev)
    logits = {}
    with torch.inference_mode():
        for c in (dataclasses.replace(cfg, compute_dtype="float32"), cfg):
            cache = base.tree_init(api.abstract_cache(c, B, P + 1),
                                   torch.Generator(device=dev), dev)
            last, cache = api.prefill(c, params, {"tokens": toks, **_on(extras or {}, dev)},
                                      cache)
            if not logits:
                nxt = last.argmax(-1, keepdim=True)
            logits[c.compute_dtype] = api.decode_step(c, params, nxt, pos, cache)[0]
    err = _rel_max(logits["bfloat16"], logits["float32"])
    print(f"[4 {tag}] {cfg.name} one decode step {B}x1 at position {P}, bf16 compute vs "
          f"fp32: max |diff| {err:.4g} of the largest |logit| (bound {bound})")
    if not err < bound:
        raise AssertionError(f"{cfg.name}: the bf16 decode step is not within "
                             f"{bound} of the fp32 one")
    return err


def _dense_path(dev, wrappers, reset_launches, smi) -> dict:
    """Phase 4(e): the dense transformer family at full width. qwen1.5-4b
    served from fp32 and W8 (4 x 512 + 32) and through flash (1 x 2048 + 8);
    its fp32 checks (teacher forcing, prefill vs forward, flash vs dense,
    W8 loss); gemma-2b and llama3.2-3b served and teacher-forced;
    qwen2-72b abstract; a profile of qwen's prefill and decode step. The
    dense path reaches no TPU kernel, so every launch count stays 0."""
    import dataclasses
    import gc
    from unittest import mock
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import make_batch
    from repro_torch.layers import attention
    from repro_torch.models import api, base
    from repro_torch.quantized import apply as qapply

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    reset_launches()
    rng = np.random.default_rng(SEED)
    runs, checks = {}, {}

    def init(name):
        cfg = configs.get_config(name)
        n = base.count_params(api.abstract_params(cfg))
        if n != DENSE_PARAMS[name]:
            raise AssertionError(f"{name}: {n} parameters, want {DENSE_PARAMS[name]}")
        t0 = time.perf_counter()
        with torch.inference_mode():
            params = base.tree_init(api.abstract_params(cfg),
                                    torch.Generator(device=dev).manual_seed(SEED), dev)
        torch.cuda.synchronize()
        print(f"[4 dense path] {name}: {n} parameters, {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab}, compute {cfg.compute_dtype}; init "
              f"{time.perf_counter() - t0:.2f} s, "
              f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB allocated")
        return cfg, params

    # (a) qwen1.5-4b at full width: fp32 and W8 at 4 x 512, flash at 1 x 2048
    cfg, params = init(DENSE_ARCH)
    with torch.inference_mode():
        w8 = qapply.quantize_params_for_serving(cfg, params, min_size=0)
    torch.cuda.synchronize()
    print(f"[4 dense path] {DENSE_ARCH} W8 checkpoint: "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB allocated with the fp32 one")
    prompts = rng.integers(0, cfg.vocab, size=(DENSE_BATCH, DENSE_PROMPT)).astype(np.int32)
    long_prompt = rng.integers(0, cfg.vocab, size=(1, DENSE_FLASH_PROMPT)).astype(np.int32)
    # one untimed generate at each timed shape first: the first prefill
    # at a shape pays cuBLAS set-up for it
    for pr in (prompts, long_prompt):
        _dense_generate(cfg, params, pr, 2, dev, "warm-up")
    runs["fp32 4x512"] = _dense_generate(cfg, params, prompts, DENSE_NEW, dev, "fp32")
    runs["w8 4x512"] = _dense_generate(cfg, w8, prompts, DENSE_NEW, dev, "w8")
    with mock.patch.object(attention, "flash_attention",
                           wraps=attention.flash_attention) as flash_calls:
        runs["fp32 1x2048"] = _dense_generate(cfg, params, long_prompt, DENSE_FLASH_NEW, dev,
                                              "fp32 flash")
    print(f"[4 dense path] {DENSE_ARCH} 1x{DENSE_FLASH_PROMPT} prefill: flash_attention "
          f"called {flash_calls.call_count} times (one per layer)")
    if flash_calls.call_count != cfg.n_layers:
        raise AssertionError("the 2048-token prefill did not take the flash route per layer")

    # (b) correctness on the card, in fp32 compute (TF32 off)
    tf_prompts = rng.integers(0, cfg.vocab, size=(DENSE_BATCH, TF_PROMPT)).astype(np.int32)
    checks[DENSE_ARCH] = {"teacher_forcing": _teacher_forcing(cfg, params, tf_prompts, dev),
                          "flash_max_abs": _flash_check(
                              cfg, params, torch.as_tensor(long_prompt, device=dev).long(), dev)}
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in make_batch(
        cfg, base.ShapeConfig("eval", TF_PROMPT, DENSE_BATCH, "train"), 0, seed=3).items()}
    batch = {k: v.long() for k, v in batch.items()}
    with torch.inference_mode():
        loss_fp = api.loss_fn(cfg32, params, batch)[0].item()
        loss_q = api.loss_fn(cfg32, w8, batch)[0].item()
        logit_err = _rel_max(api.forward(cfg32, w8, batch)[0],
                             api.forward(cfg32, params, batch)[0])
    rel = abs(loss_q - loss_fp) / loss_fp
    checks[DENSE_ARCH]["w8_loss"] = {"fp32": loss_fp, "w8": loss_q, "rel": rel,
                                     "logits_rel_max": logit_err}
    print(f"[4 dense path] {DENSE_ARCH} loss on make_batch {DENSE_BATCH}x{TF_PROMPT} (fp32 "
          f"compute): fp32 {loss_fp:.4f}, W8 {loss_q:.4f}, relative {rel:.3%} "
          f"(bound {W8_LOSS_RTOL:.0%}); W8 logits vs fp32: max |diff| {logit_err:.4g} of the "
          f"largest |logit| (bound {W8_LOGIT_RTOL})")
    if not rel < W8_LOSS_RTOL:
        raise AssertionError("the W8 checkpoint's loss is not within 5 % of fp32's")
    if not logit_err < W8_LOGIT_RTOL:
        raise AssertionError(f"the W8 checkpoint's logits are not within {W8_LOGIT_RTOL} of "
                             "fp32's")
    checks[DENSE_ARCH]["bf16_decode_rel_max"] = _bf16_decode_check(cfg, params, tf_prompts, dev)
    trace = {DENSE_ARCH: _lm_profile(cfg, params, prompts, dev, tag="dense path")}
    del params, w8
    gc.collect()
    torch.cuda.empty_cache()

    # (c) gemma-2b and llama3.2-3b at full width, from fp32, bf16 compute
    for name in DENSE_OTHERS:
        cfg, params = init(name)
        pr = rng.integers(0, cfg.vocab, size=(DENSE_BATCH, DENSE_PROMPT)).astype(np.int32)
        _dense_generate(cfg, params, pr, 2, dev, "warm-up")
        runs[f"{name} fp32 4x512"] = _dense_generate(cfg, params, pr, DENSE_OTHER_NEW, dev, "fp32")
        tf = rng.integers(0, cfg.vocab, size=(DENSE_BATCH, TF_PROMPT)).astype(np.int32)
        checks[name] = {"teacher_forcing": _teacher_forcing(cfg, params, tf, dev)}
        del params
        gc.collect()
        torch.cuda.empty_cache()

    # (d) qwen2-72b, abstract only: it does not fit one card
    cfg = configs.get_config(DENSE_ABSTRACT)
    n = base.count_params(api.abstract_params(cfg))
    if n != DENSE_PARAMS[DENSE_ABSTRACT]:
        raise AssertionError(f"{DENSE_ABSTRACT}: {n} parameters")
    card = torch.cuda.get_device_properties(dev).total_memory
    print(f"[4 dense path] {DENSE_ABSTRACT} (abstract only): {n} parameters, fp32 "
          f"{4 * n / 1e9:.1f} GB, bf16 {2 * n / 1e9:.1f} GB, int8 {n / 1e9:.1f} GB of weights "
          f"against the card's {card / 1e9:.1f} GB")

    counts = {name: w.launches for name, w in wrappers.items()}
    print(f"[4 dense path] launches {counts} (the dense path reaches no TPU kernel)")
    if any(counts.values()):
        raise AssertionError("the dense path launched a kernel")
    seconds = time.perf_counter() - t_phase
    print(f"[4 dense path] phase {seconds:.1f} s")
    print(json.dumps({"dense_ms": runs, "dense_checks": checks, "dense_profile": trace,
                      "phase_s": seconds, "device": torch.cuda.get_device_name(dev),
                      "power": smi}))
    return runs


def _hybrid_path(dev, wrappers, reset_launches, smi) -> int:
    """Phase 4(f): zamba2-2.7b at full width. Served from fp32 and W8
    (4 x 512 + 32) by `Engine` with `use_kernel=True`: every prefill must
    launch ssd_scan once per Mamba2 layer, all on the tensor cores, and no
    other kernel; each checkpoint's kernel route held to its plain route
    (`_check_routes`); fp32 teacher forcing; a profile of a prefill and a
    decode step. Returns ssd_scan's launches in one served prefill."""
    import gc
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import api, base, zamba
    from repro_torch.quantized import apply as qapply

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = configs.get_config(HYBRID_ARCH)
    n = base.count_params(api.abstract_params(cfg))
    if n != HYBRID_PARAMS:
        raise AssertionError(f"{HYBRID_ARCH}: {n} parameters, want {HYBRID_PARAMS}")
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = base.tree_init(api.abstract_params(cfg),
                                torch.Generator(device=dev).manual_seed(SEED), dev)
        w8 = qapply.quantize_params_for_serving(cfg, params, min_size=0)
    torch.cuda.synchronize()
    print(f"[4 hybrid path] {HYBRID_ARCH}: {n} parameters, {cfg.n_layers} Mamba2 layers "
          f"(N {cfg.ssm_state}, {cfg.ssm_heads} heads of {cfg.ssm_headdim}) and the shared "
          f"block at {zamba.n_sites(cfg)} sites (heads {cfg.n_heads} x {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}), d_model {cfg.d_model}, vocab {cfg.vocab}, compute "
          f"{cfg.compute_dtype}; init and W8 {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB allocated")
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab, size=(DENSE_BATCH, DENSE_PROMPT)).astype(np.int32)
    _dense_generate(cfg, params, prompts, 2, dev, "warm-up", tag="hybrid path")
    runs, routes = {}, {}
    for ckpt, p in (("fp32", params), ("w8", w8)):
        reset_launches()
        rec = _dense_generate(cfg, p, prompts, DENSE_NEW, dev, ckpt, tag="hybrid path")
        counts = {name: w.launches for name, w in wrappers.items()}
        mma = wrappers["ssd_scan"].mma_launches
        print(f"[4 hybrid path] {ckpt}: {mma} of {counts['ssd_scan']} ssd_scan launches on the "
              f"tensor cores in one prefill; launches {counts}")
        if not counts.pop("ssd_scan") == mma == cfg.n_layers or any(counts.values()):
            raise AssertionError(f"{ckpt}: want {cfg.n_layers} ssd_scan launches, all on the "
                                 "tensor cores, and no other kernel in one generate")
        runs[f"{ckpt} 4x512"] = {**rec, "ssd_launches": mma}
        routes[ckpt] = _check_routes(cfg, p, prompts, np.array(rec["first_tokens"])[:, None],
                                     dev, ckpt, tag="hybrid path")
    tf = rng.integers(0, cfg.vocab, size=(DENSE_BATCH, TF_PROMPT)).astype(np.int32)
    checks = {"routes": routes,
              "teacher_forcing": _teacher_forcing(cfg, params, tf, dev, tag="hybrid path")}
    trace = _lm_profile(cfg, params, prompts, dev, tag="hybrid path")
    del params, w8
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[4 hybrid path] phase {seconds:.1f} s")
    print(json.dumps({"hybrid_ms": runs, "hybrid_checks": checks, "hybrid_profile": trace,
                      "phase_s": seconds, "device": torch.cuda.get_device_name(dev),
                      "power": smi}))
    return cfg.n_layers


def _moe_path(dev, wrappers, reset_launches, smi) -> None:
    """Phase 4(g): granite-moe-1b-a400m at full width, served from fp32 at
    4 x 512 + 32 (bf16 compute); its W8 form refused as the reference's
    fails; prefill against forward, a decode step on the card against the
    host's, a bf16 step against fp32; loss_fn's aux losses; the share of
    routed pairs dropped at prefill and at decode; a profile;
    qwen3-moe-30b-a3b counted abstractly. No TPU kernel: every count 0."""
    import dataclasses
    import gc
    import math
    from unittest import mock
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import make_batch
    from repro_torch.layers import moe
    from repro_torch.models import api, base
    from repro_torch.quantized import apply as qapply

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    reset_launches()
    cfg = configs.get_config(MOE_ARCH)
    n = base.count_params(api.abstract_params(cfg))
    if n != MOE_PARAMS[MOE_ARCH]:
        raise AssertionError(f"{MOE_ARCH}: {n} parameters, want {MOE_PARAMS[MOE_ARCH]}")
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = base.tree_init(api.abstract_params(cfg),
                                torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    print(f"[4 moe path] {MOE_ARCH}: {n} parameters, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_experts} experts of d_ff {cfg.d_ff}, top "
          f"{cfg.experts_per_token}, heads {cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, "
          f"vocab {cfg.vocab}, tied {cfg.tie_embeddings}, compute {cfg.compute_dtype}; init "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB allocated")
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab, size=(DENSE_BATCH, DENSE_PROMPT)).astype(np.int32)
    _dense_generate(cfg, params, prompts, 2, dev, "warm-up", tag="moe path")
    runs = {"fp32 4x512": _dense_generate(cfg, params, prompts, DENSE_NEW, dev, "fp32",
                                          tag="moe path")}
    toks = torch.as_tensor(prompts, device=dev).long()
    with torch.inference_mode():
        w8 = qapply.quantize_params_for_serving(cfg, params, min_size=0)
        try:
            api.forward(cfg, w8, {"tokens": toks[:1, :8]})
        except TypeError as e:
            print(f"[4 moe path] W8 checkpoint refused, as the reference fails: {e}")
        else:
            raise AssertionError("the W8 MoE checkpoint was served")
        del w8

    # routings and dispatch, recorded through the layer's two steps
    seen = {"route": [], "dispatch": []}

    def recorder(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            seen[name].append(out)
            return out
        return call

    def recorded(fn):
        for v in seen.values():
            v.clear()
        with mock.patch.object(moe, "route", recorder("route", moe.route)), \
                mock.patch.object(moe, "dispatch", recorder("dispatch", moe.dispatch)):
            out = fn()
        dropped = sum(int((~d[3]).sum()) for d in seen["dispatch"])
        pairs = sum(d[3].numel() for d in seen["dispatch"])
        return out, [torch.sort(r[3], dim=-1).values for r in seen["route"]], dropped / pairs

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    B, P = prompts.shape
    pos = torch.full((B,), P, dtype=torch.int32, device=dev)
    checks = {}
    with torch.inference_mode():
        # 1. prefill's last logits against forward's last position, same T
        cache = base.tree_init(api.abstract_cache(cfg32, B, P + 1), torch.Generator(device=dev),
                               dev)
        (last, cache), _, drop_prefill = recorded(
            lambda: api.prefill(cfg32, params, {"tokens": toks}, cache))
        full = api.forward(cfg32, params, {"tokens": toks})[0][:, -1]
        err = (last - full).abs().max().item()
        checks["prefill_vs_forward_max_abs"] = err
        print(f"[4 moe path] {MOE_ARCH} fp32 prefill {B}x{P} vs forward's last position: max "
              f"|diff| {err:.3g} (bound {PREFILL_TOL}); capacity "
              f"{moe.capacity(B * P, cfg.experts_per_token, cfg.n_experts)} pairs an expert, "
              f"{drop_prefill:.4f} of routed pairs dropped")
        if not torch.allclose(last, full, rtol=PREFILL_TOL, atol=PREFILL_TOL):
            raise AssertionError("MoE prefill's last logits differ from forward's")
        # 2. one fp32 decode step on the card against the host's, same weights and cache
        nxt = last.argmax(-1, keepdim=True)
        card, ids_card, drop_decode = recorded(
            lambda: api.decode_step(cfg32, params, nxt, pos, cache)[0])
        host_params = base.tree_map(lambda t: t.cpu(), params)
        host, ids_host, _ = recorded(lambda: api.decode_step(
            cfg32, host_params, nxt.cpu(), pos.cpu(), base.tree_map(lambda t: t.cpu(), cache))[0])
        del host_params
        err = _rel_max(card.cpu(), host)
        flips = sum(int((a.cpu() != b).any(-1).sum()) for a, b in zip(ids_card, ids_host))
        checks["decode_card_vs_host_rel_max"] = err
        checks["decode_routings_differ"] = flips
        print(f"[4 moe path] {MOE_ARCH} one fp32 decode step {B}x1 at position {P}, card vs "
              f"host: max |diff| {err:.3g} of the largest |logit| (bound {MOE_HOST_RTOL}); "
              f"{flips} of {B * cfg.n_layers} (token, layer) routings differ; capacity "
              f"{moe.capacity(B, cfg.experts_per_token, cfg.n_experts)}, {drop_decode:.4f} of "
              "routed pairs dropped")
        if not err < MOE_HOST_RTOL:
            raise AssertionError("the card's MoE decode step is not the host's")
        checks["drop_share"] = {"prefill": drop_prefill, "decode": drop_decode}
    # 3. the bf16 step against the fp32 one
    tf = rng.integers(0, cfg.vocab, size=(DENSE_BATCH, TF_PROMPT)).astype(np.int32)
    checks["bf16_decode_rel_max"] = _bf16_decode_check(cfg, params, tf, dev, tag="moe path",
                                                       bound=MOE_BF16_RTOL)
    # 4. the combine's bf16 `index_add_` adds atomically, in no fixed order:
    # two bf16 prefills of the same prompts may differ; bounded as a bf16 step
    with torch.inference_mode():
        runs2 = [api.prefill(cfg, params, {"tokens": toks}, base.tree_init(
            api.abstract_cache(cfg, B, P), torch.Generator(device=dev), dev))[0].float()
            for _ in range(2)]
    err = _rel_max(runs2[1], runs2[0])
    checks["bf16_prefill_rerun_rel_max"] = err
    print(f"[4 moe path] {MOE_ARCH} two bf16 prefills {B}x{P} of the same prompts: "
          f"{'bitwise equal' if torch.equal(*runs2) else 'not bitwise equal'}, max |diff| "
          f"{err:.3g} of the largest |logit| (bound {MOE_BF16_RTOL}, a bf16 rounding)")
    if not err < MOE_BF16_RTOL:
        raise AssertionError("two bf16 MoE prefills differ beyond a bf16 rounding")
    batch = {k: torch.as_tensor(v, device=dev).long() for k, v in make_batch(
        cfg, base.ShapeConfig("eval", TF_PROMPT, DENSE_BATCH, "train"), 0, seed=3).items()}
    with torch.inference_mode():
        loss, metrics = api.loss_fn(cfg32, params, batch)
    checks["loss_fn"] = {k: v.item() for k, v in metrics.items()}
    print(f"[4 moe path] {MOE_ARCH} loss_fn on make_batch {DENSE_BATCH}x{TF_PROMPT} (fp32 "
          f"compute): " + ", ".join(f"{k} {v:.4f}" for k, v in checks["loss_fn"].items()))
    if not all(math.isfinite(v) for v in checks["loss_fn"].values()):
        raise AssertionError("MoE loss_fn is not finite")
    trace = _lm_profile(cfg, params, prompts, dev, tag="moe path")
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()

    # qwen3-moe-30b-a3b, abstract only: fp32 fits no card
    big = configs.get_config(MOE_ABSTRACT)
    n = base.count_params(api.abstract_params(big))
    if n != MOE_PARAMS[MOE_ABSTRACT]:
        raise AssertionError(f"{MOE_ABSTRACT}: {n} parameters")
    w8_bytes = 0

    def add(info):
        nonlocal w8_bytes
        w8_bytes += math.prod(info.shape) * info.dtype.itemsize

    base.tree_map(add, qapply.abstract_quantized_params(big))
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    print(f"[4 moe path] {MOE_ABSTRACT} (abstract only): {n} parameters, fp32 {4 * n / 1e9:.1f} "
          f"GB, bf16 {2 * n / 1e9:.1f} GB, W8 tree {w8_bytes / 1e9:.2f} GB "
          f"(abstract_quantized_params) against the card's {card_bytes / 1e9:.1f} GB")
    counts = {name: w.launches for name, w in wrappers.items()}
    print(f"[4 moe path] launches {counts} (the MoE path reaches no TPU kernel)")
    if any(counts.values()):
        raise AssertionError("the MoE path launched a kernel")
    seconds = time.perf_counter() - t_phase
    print(f"[4 moe path] phase {seconds:.1f} s")
    print(json.dumps({"moe_ms": runs, "moe_checks": checks, "moe_profile": trace,
                      "abstract": {MOE_ABSTRACT: {"params": n, "w8_bytes": w8_bytes}},
                      "phase_s": seconds, "device": torch.cuda.get_device_name(dev),
                      "power": smi}))


def _modality_path(dev, wrappers, reset_launches, smi) -> None:
    """Phase 4(h): qwen2-vl-2b (vlm) and musicgen-medium (audio) at full
    width, served from fp32 (bf16 compute) at 4 x 512 + 32 with the prompt
    extras of `make_batch` passed to `Engine.generate` as numpy arrays;
    fp32 teacher forcing with those extras (zero extras and a false mask
    over the generated positions, as `decode_step` supplies them; for
    vlm on distinct M-RoPE positions, `_grid_positions`, with layer 0's
    M-RoPE held to its plain rotation), prefill vs forward, a bf16 decode
    step against fp32; a profile. No TPU kernel: each model's counts,
    read after its generate, checks and profile, stay 0."""
    import gc
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import api, base

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    reset_launches()
    runs, checks, trace = {}, {}, {}
    for name, want in MODALITY_PARAMS.items():
        tag = "modality path"
        cfg = configs.get_config(name)
        n = base.count_params(api.abstract_params(cfg))
        if n != want:
            raise AssertionError(f"{name}: {n} parameters, want {want}")
        t0 = time.perf_counter()
        with torch.inference_mode():
            params = base.tree_init(api.abstract_params(cfg),
                                    torch.Generator(device=dev).manual_seed(SEED), dev)
        torch.cuda.synchronize()
        print(f"[4 {tag}] {name} ({cfg.modality}): {n} parameters, {cfg.n_layers} layers, "
              f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, "
              f"d_ff {cfg.d_ff} ({cfg.act}, {cfg.norm}), positions {cfg.pos}, vocab "
              f"{cfg.vocab}, compute {cfg.compute_dtype}; init {time.perf_counter() - t0:.2f} s, "
              f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB allocated")

        def prompt(seq: int, step: int):
            b = make_batch(cfg, base.ShapeConfig("serve", seq, DENSE_BATCH, "prefill"), step,
                           seed=SEED)
            return b["tokens"], {k: v for k, v in b.items()
                                 if k not in ("tokens", "targets", "loss_mask")}

        prompts, extras = prompt(DENSE_PROMPT, 0)
        print(f"[4 {tag}] {name} prompt extras: " + ", ".join(
            f"{k} {v.shape} {v.dtype}" for k, v in extras.items())
            + (f"; {int(extras['pixel_mask'][0].sum())} image positions a prompt"
               if "pixel_mask" in extras else
               f"; frame_embeds std {float(extras['frame_embeds'].std()):.4f}"))
        _dense_generate(cfg, params, prompts, 2, dev, "warm-up", tag, extras)
        reset_launches()
        runs[name] = _dense_generate(cfg, params, prompts, DENSE_NEW, dev, "fp32", tag, extras)
        tf, tf_extras = prompt(TF_PROMPT, 1)
        checks[name] = {}
        if cfg.pos == "mrope":
            tf_extras["positions"] = _grid_positions(tf_extras["pixel_mask"])
            checks[name]["mrope_rel_max"] = _mrope_check(cfg, params, tf, tf_extras, dev)
        checks[name].update({
            "teacher_forcing": _teacher_forcing(cfg, params, tf, dev, tag, extras=tf_extras),
            "bf16_decode_rel_max": _bf16_decode_check(cfg, params, tf, dev, tag,
                                                      extras=tf_extras)})
        trace[name] = _lm_profile(cfg, params, prompts, dev, tag, extras)
        counts = {k: w.launches for k, w in wrappers.items()}
        print(f"[4 {tag}] {name} launches over its generate, checks and profile {counts} "
              f"(the {cfg.modality} path reaches no TPU kernel)")
        if any(counts.values()):
            raise AssertionError(f"the {cfg.modality} path of {name} launched a kernel")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[4 modality path] phase {seconds:.1f} s")
    print(json.dumps({"modality_ms": runs, "modality_checks": checks, "modality_profile": trace,
                      "phase_s": seconds, "device": torch.cuda.get_device_name(dev),
                      "power": smi}))


def _grid_positions(pixel_mask):
    """Distinct M-RoPE positions (B, 3, S) for a prompt whose first n
    positions are image patches (`pixel_mask`, the same prefix in every
    row): patch i of a W-wide grid (W = ceil(sqrt(n))) at (t, h, w) =
    (0, i // W, i % W); the text after it at one index in all three
    sections, from the grid's largest index + 1 on, as Qwen2-VL places
    text after an image."""
    import math
    import numpy as np
    B, S = pixel_mask.shape
    n = int(pixel_mask[0].sum())
    if not (pixel_mask[:, :n].all() and not pixel_mask[:, n:].any()):
        raise AssertionError("the image patches are not one prefix of every prompt")
    W = math.ceil(math.sqrt(n))
    i = np.arange(n)
    grid = np.stack([np.zeros(n, np.int64), i // W, i % W])                   # (3, n)
    text = np.broadcast_to(grid.max() + 1 + np.arange(S - n), (3, S - n))
    pos = np.concatenate([grid, text], axis=1).astype(np.int32)               # (3, S)
    return np.ascontiguousarray(np.broadcast_to(pos, (B, 3, S)))


def _mrope_check(cfg, params, tokens, extras, dev) -> float:
    """Layer 0's query, rotated by `rotary.mrope` (fp32) at the distinct
    positions of `extras`, against a plain per-section rotation in fp64:
    band j of the head's half-dim turns by position[section(j)] *
    theta^(-j / half). Returns max |diff| over max |q|; fails above
    MROPE_RTOL, or if the sections' reversed order lands within 100x of
    it (positions that would not show a wrong split)."""
    import dataclasses
    import torch
    from repro_torch.layers import attention, embedding, norms, rotary
    from repro_torch.models import base

    c = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.inference_mode():
        lp = base.layer(params["layers"], 0)
        batch = {"tokens": torch.as_tensor(tokens, device=dev).long(), **_on(extras, dev)}
        hn = norms.apply_norm(c.norm, lp["ln_attn"],
                              embedding.assemble_inputs(c, params["embed"], batch),
                              eps=c.norm_eps, plus_one=c.norm_plus_one)
        q = attention._project(hn, lp["attn"]["wq"], lp["attn"].get("bq"))   # (B, S, H, hd)
        pos = batch["positions"].transpose(0, 1)                               # (3, B, S)
        got = rotary.mrope(q, pos, c.rope_theta, c.mrope_sections)

        def plain(sections):
            half = q.shape[-1] // 2
            freqs = c.rope_theta ** (-torch.arange(half, dtype=torch.float64, device=dev) / half)
            bands, lo = [], 0
            for k, n in enumerate(sections):
                bands.append(pos[k].double()[..., None] * freqs[lo:lo + n])
                lo += n
            ang = torch.cat(bands, dim=-1)[:, :, None, :]                       # (B, S, 1, half)
            x1, x2 = q[..., :half].double(), q[..., half:].double()
            return torch.cat([x1 * ang.cos() - x2 * ang.sin(),
                              x2 * ang.cos() + x1 * ang.sin()], dim=-1)

        scale = q.abs().max().double()
        want = plain(c.mrope_sections)
        err = ((got.double() - want).abs().max() / scale).item()
        wrong = ((plain(c.mrope_sections[::-1]) - want).abs().max() / scale).item()
    print(f"[4 modality path] {cfg.name} layer 0 M-RoPE {tuple(q.shape)} at distinct (t, h, w) "
          f"positions vs a plain per-section rotation: max |diff| {err:.3g} of max |q| (bound "
          f"{MROPE_RTOL}); the sections reversed miss it by {wrong:.3g}")
    if not err < MROPE_RTOL:
        raise AssertionError(f"{cfg.name}: M-RoPE differs from its per-section rotation")
    if not wrong > 100 * MROPE_RTOL:
        raise AssertionError(f"{cfg.name}: the M-RoPE positions do not tell the sections apart")
    return err


def _train_path(dev, wrappers, reset_launches, smi) -> None:
    """Phase 4(i): the LM training stack. (a) gemma-2b as published through
    `trainer.run`: 4 x 512 in two microbatches, remat, AdamW, 6 steps; each
    step's loss, grad_norm and wall; tokens/s, model FLOP utilisation,
    peak memory; a profile of one step. (b) Remat against none on one
    1 x 512 microbatch at full width. (c) Card against host at the smoke
    size for each family and modality. (d) Kill and resume on the card
    (`_kill_resume_child`, in a subprocess). (e) The training launcher as
    a subprocess. No TPU kernel: every count stays 0."""
    import dataclasses
    import gc
    import math
    import os
    import shutil
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import roofline as rl
    from repro_torch.models import api, base
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib
    from repro_torch.train import trainer

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    reset_launches()
    tag = "train path"
    out, checks = {}, {}
    scratch = ROOT / "build" / "train_path"
    shutil.rmtree(scratch, ignore_errors=True)

    # (a) gemma-2b at full width through the trainer
    cfg = configs.get_config(TRAIN_ARCH)
    n = base.count_params(api.abstract_params(cfg))
    shape = base.ShapeConfig("chip", TRAIN_SEQ, TRAIN_BATCH, "train", accum=TRAIN_ACCUM)
    oc = adamw.OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    tc = trainer.TrainerConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS + 1,
                               ckpt_dir=str(scratch / "gemma"), seed=SEED, remat="full")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, hist = trainer.run(cfg, shape, oc, tc, device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    tokens = TRAIN_SEQ * TRAIN_BATCH
    step_s = statistics.median(hist["step_s"][1:])
    mfu = rl.model_flops(cfg, shape) / step_s / BF16_TC_FLOP_PER_S
    mfu_all = 6 * n * tokens / step_s / BF16_TC_FLOP_PER_S     # over all parameters
    for i, (loss, gn, dt) in enumerate(zip(hist["loss"], hist["grad_norm"], hist["step_s"])):
        print(f"[4 {tag}] {TRAIN_ARCH} step {i + 1}: loss {loss:.5f}, grad_norm {gn:.4f}, "
              f"{dt * 1e3:.1f} ms")
    ln_v = math.log(cfg.vocab)
    with torch.no_grad():
        batch0 = _on(make_batch(cfg, shape, 0, seed=tc.data_seed), dev)
        seen0 = api.loss_fn(cfg, state["params"], batch0)[0].item()
    print(f"[4 {tag}] {TRAIN_ARCH} ({n} parameters, state {16 * n / 1e9:.1f} GB fp32 params + "
          f"grads + m + v), {TRAIN_BATCH}x{TRAIN_SEQ} in {TRAIN_ACCUM} microbatches, remat "
          f"full: {TRAIN_STEPS} steps in {run_s:.1f} s; median step (2-{TRAIN_STEPS}) "
          f"{step_s * 1e3:.1f} ms, {tokens / step_s:.0f} tokens/s, model FLOP utilisation "
          f"{mfu:.3f} (roofline.model_flops: 6 x {rl.active_param_count(cfg):.0f} active "
          f"parameters x tokens / step s / {BF16_TC_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16; with "
          f"all {n} parameters {mfu_all:.3f}); "
          f"peak {peak / 1e9:.1f} GB allocated of the card's "
          f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.1f} GB")
    print(f"[4 {tag}] {TRAIN_ARCH} first loss {hist['loss'][0]:.5f} vs ln(vocab) {ln_v:.5f} "
          f"(bound {TRAIN_LOSS0_NAT} nat); last {hist['loss'][-1]:.5f}; the step-1 batch after "
          f"{TRAIN_STEPS} steps: {seen0:.5f}")
    out["gemma"] = {"params": n, "loss": hist["loss"], "grad_norm": hist["grad_norm"],
                    "step_s": hist["step_s"], "median_step_ms": step_s * 1e3,
                    "tokens_per_s": tokens / step_s, "mfu": mfu, "mfu_all_params": mfu_all,
                    "peak_bytes": peak,
                    "run_s": run_s, "step1_batch_loss_after": seen0,
                    "stragglers": len(hist["stragglers"])}
    if not all(math.isfinite(v) for v in hist["loss"] + hist["grad_norm"]):
        raise AssertionError("a training loss or grad_norm is not finite")
    if not abs(hist["loss"][0] - ln_v) < TRAIN_LOSS0_NAT:
        raise AssertionError(f"the first loss {hist['loss'][0]} is not within "
                             f"{TRAIN_LOSS0_NAT} of ln(vocab) {ln_v}")
    if not hist["loss"][-1] < hist["loss"][0]:
        raise AssertionError("the last training loss is not below the first")
    if not seen0 < hist["loss"][0]:
        raise AssertionError("the step-1 batch scores no better after training")
    train_step = step_lib.make_train_step(cfg, shape, oc, remat="full")
    batch = _on(make_batch(cfg, shape, TRAIN_STEPS, seed=tc.data_seed), dev)
    out["profile_step"] = _profile_call(lambda: train_step(state, batch))
    _print_profile(tag, f"{TRAIN_ARCH} train step", out["profile_step"])
    del train_step, batch, batch0
    gc.collect()
    torch.cuda.empty_cache()

    # (b) remat against none on one 1 x 512 microbatch at full width
    one = base.ShapeConfig("remat", TRAIN_SEQ, 1, "train")
    batch = _on(make_batch(cfg, one, 100, seed=tc.data_seed), dev)
    remat = {}
    for mode in ("full", "none"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base_bytes = torch.cuda.memory_allocated(dev)
        loss, _, grads = step_lib.make_grad_fn(cfg, one, remat=mode)(state["params"], batch)
        remat[mode] = {"loss": loss.item(), "grad_norm": adamw.global_norm(grads).item(),
                       "peak_above_state_bytes": torch.cuda.max_memory_allocated(dev)
                       - base_bytes}
        del grads
    rel = abs(remat["full"]["grad_norm"] - remat["none"]["grad_norm"]) / remat["none"]["grad_norm"]
    print(f"[4 {tag}] {TRAIN_ARCH} 1x{TRAIN_SEQ} remat full vs none: loss "
          f"{remat['full']['loss']:.6f} / {remat['none']['loss']:.6f} "
          f"({'equal' if remat['full']['loss'] == remat['none']['loss'] else 'NOT equal'}), "
          f"grad_norm {remat['full']['grad_norm']:.6f} / {remat['none']['grad_norm']:.6f} "
          f"(relative {rel:.3g}, bound {REMAT_GNORM_RTOL}); peak above the state "
          f"{remat['full']['peak_above_state_bytes'] / 1e9:.2f} / "
          f"{remat['none']['peak_above_state_bytes'] / 1e9:.2f} GB")
    checks["remat"] = {**remat, "grad_norm_rel": rel}
    if remat["full"]["loss"] != remat["none"]["loss"] or not rel < REMAT_GNORM_RTOL:
        raise AssertionError("remat changed the loss or the gradients")
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (c) card against host at the smoke size, fp32 (TF32 is off)
    host = torch.device("cpu")
    checks["card_vs_host"] = {}
    for kind, arch in HOST_ARCHS.items():
        c = dataclasses.replace(configs.smoke(arch), compute_dtype="float32")
        shp = base.ShapeConfig("smoke", 32, 4, "train", accum=2)
        o = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)
        where = {"host": host, "card": dev}
        states = {"host": base.tree_init(step_lib.abstract_state(c),
                                         torch.Generator().manual_seed(SEED), host)}
        states["card"] = base.tree_map(lambda t: t.to(dev, copy=True), states["host"])
        b0 = make_batch(c, shp, 0, seed=SEED)
        grads = {k: step_lib.make_grad_fn(c, shp)(states[k]["params"], _on(b0, d))[2]
                 for k, d in where.items()}
        gmax = max(g.abs().max().item() for _, g in base.tree_items(grads["host"]))
        gerr = max((a.cpu() - b).abs().max().item() for (_, a), (_, b) in
                   zip(base.tree_items(grads["card"]), base.tree_items(grads["host"])))
        losses = {k: [] for k in where}
        for k, d in where.items():
            fn = step_lib.make_train_step(c, shp, o)
            for i in range(3):
                losses[k].append(fn(states[k], _on(make_batch(c, shp, i, seed=SEED), d))[1]
                                 ["loss"].item())
        lrel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["host"]))
        checks["card_vs_host"][kind] = {"arch": c.name, "loss_rel_max": lrel,
                                        "grad_err_of_max": gerr / gmax, "losses": losses}
        print(f"[4 {tag}] card vs host, {kind} {c.name}, 3 steps of 4x32 (2 microbatches, "
              f"fp32): card losses {', '.join(f'{v:.6f}' for v in losses['card'])}, max relative "
              f"{lrel:.3g} (bound {HOST_LOSS_RTOL}); step-1 gradients max |diff| "
              f"{gerr / gmax:.3g} of the largest |g| (bound {HOST_GRAD_RTOL})")
        if not (lrel < HOST_LOSS_RTOL and gerr <= HOST_GRAD_RTOL * gmax):
            raise AssertionError(f"{kind}: the card's training step is not the host's")

    # (d) kill and resume on the card, in a subprocess (cuBLAS's workspace
    # setting must precede CUDA's start for deterministic algorithms)
    child = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--kill-resume", str(scratch / "kr")],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    print("\n".join(f"    {line}" for line in child.stdout.splitlines()))
    if child.returncode != 0:
        print(child.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"the kill/resume run failed (exit {child.returncode})")
    kr = json.loads(child.stdout.strip().splitlines()[-1])["kill_resume"]
    checks["kill_resume"] = kr
    if not kr["deterministic"]["bit_identical"]:
        raise AssertionError("kill and resume did not end bit-identical under deterministic "
                             "algorithms")

    # (e) the training launcher
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH, "--smoke",
         "--steps", "5", "--ckpt-dir", str(scratch / "cli")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    line = cli.stdout.strip().splitlines()[-1] if cli.stdout.strip() else ""
    print(f"[4 {tag}] python -m repro_torch.launch.train --arch {TRAIN_ARCH} --smoke --steps 5:"
          f" exit {cli.returncode}, '{line}'")
    if cli.returncode != 0 or not line.startswith("steps=5 loss "):
        print(cli.stderr[-4000:], file=sys.stderr)
        raise AssertionError("the training launcher did not print its summary line")
    checks["cli"] = line
    shutil.rmtree(scratch, ignore_errors=True)

    counts = {k: w.launches for k, w in wrappers.items()}
    print(f"[4 {tag}] launches {counts} (the training path reaches no TPU kernel)")
    if any(counts.values()):
        raise AssertionError("the training path launched a kernel")
    seconds = time.perf_counter() - t_phase
    print(f"[4 {tag}] phase {seconds:.1f} s")
    print(json.dumps({"train": out, "train_checks": checks, "phase_s": seconds,
                      "device": torch.cuda.get_device_name(dev), "power": smi}))


def _kill_resume_child(root: Path) -> int:
    """`chip_smoke.py --kill-resume DIR`, run by phase 4(i) in a process
    whose CUBLAS_WORKSPACE_CONFIG is set: llama3.2-3b at the smoke size,
    as tests/test_checkpoint.py runs it. An uninterrupted 10-step run
    against a run killed at step 6 and resumed from its emergency
    checkpoint, first with the default algorithms, then under
    `torch.use_deterministic_algorithms(True)`; and the two backward ops of
    the path that add into one element from many (the embedding gather's
    and the loss's `take_along_dim`'s), each run twice on the same inputs.
    Prints one JSON line."""
    import shutil
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.models import base
    from repro_torch.optim import adamw
    from repro_torch.train import trainer

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.smoke("llama3.2-3b")
    shape = base.ShapeConfig("smoke", 16, 4, "train")
    oc = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    result = {}
    for mode in ("default", "deterministic"):
        torch.use_deterministic_algorithms(mode == "deterministic")

        def tc(name, fail=-1):
            return trainer.TrainerConfig(total_steps=10, ckpt_every=4, seed=3, data_seed=11,
                                         ckpt_dir=str(root / mode / name), fail_at_step=fail)

        state_a, _ = trainer.run(cfg, shape, oc, tc("a"), device=dev)
        tc_b = tc("b", fail=6)
        try:
            trainer.run(cfg, shape, oc, tc_b, device=dev)
        except trainer.InjectedFailure:
            pass
        else:
            raise AssertionError("the injected failure did not fire")
        tc_b.fail_at_step = -1
        state_b, hist_b = trainer.run(cfg, shape, oc, tc_b, resume=True, device=dev)
        differ = [base.keystr(p) for (p, a), (_, b) in zip(base.tree_items(state_a["params"]),
                                                          base.tree_items(state_b["params"]))
                  if not torch.equal(a, b)]
        result[mode] = {"bit_identical": not differ, "leaves_differ": differ,
                        "resumed_at_step": hist_b["steps"][0]}
        print(f"[4 train path] kill at step 6 and resume, {mode} algorithms: resumed at step "
              f"{hist_b['steps'][0]}, {'bit-identical' if not differ else 'differ in '} "
              f"{', '.join(differ)}")
    torch.use_deterministic_algorithms(False)
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, 64, size=(4, 512)), device=dev)
    tok = torch.randn(64, 256, device=dev, requires_grad=True)
    up = torch.randn(4, 512, 256, device=dev)
    lf = torch.randn(4, 512, 512, device=dev, requires_grad=True)
    probes = {"embedding gather backward (index_put_ accumulate)":
              lambda: torch.autograd.grad((tok[tokens] * up).sum(), tok)[0],
              "take_along_dim backward (scatter_add)":
              lambda: torch.autograd.grad(torch.take_along_dim(
                  lf, tokens[..., None], dim=-1).sum(), lf)[0]}
    result["ops_repeatable"] = {k: bool(torch.equal(f(), f())) for k, f in probes.items()}
    print(f"[4 train path] the same backward twice on the same inputs, default algorithms: "
          + ", ".join(f"{k}: {'bitwise equal' if v else 'NOT equal'}"
                      for k, v in result["ops_repeatable"].items()))
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"kill_resume": result}))
    return 0


def _mesh_path(dev, wrappers, reset_launches, smi, session, nets, images, rounds) -> dict:
    """Phase 4(j): the port's mesh code on a one-rank mesh on the card.
    Returns the netgen kernels' launches under the mesh (and B1's on the
    tensor cores)."""
    import dataclasses
    import gc
    import os
    import shutil
    import threading
    from unittest import mock
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import quantize
    from repro_torch.kernels.binary_matvec import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.layers import moe as moe_lib
    from repro_torch.models import api, base, runtime
    from repro_torch.netgen import NetServer
    from repro_torch.optim import compression
    from repro_torch.parallel import data_parallel as dp
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import step as step_lib

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tag = "mesh path"
    out = {}
    scratch = ROOT / "build" / "mesh_path"
    shutil.rmtree(scratch, ignore_errors=True)

    # two full-width training steps under the mesh and without, first, in
    # a subprocess (before this process opens a process group)
    child = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-train", str(scratch / "train")],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    print("\n".join(f"    {line}" for line in child.stdout.splitlines()))
    if child.returncode != 0:
        print(child.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"the mesh training run failed (exit {child.returncode})")
    out["train"] = json.loads(child.stdout.strip().splitlines()[-1])["mesh_train"]
    if not out["train"]["bitwise"]:
        raise AssertionError("the training steps under the mesh differ from those without")

    mesh = make_host_mesh()
    print(f"[4 {tag}] make_host_mesh(): {mesh}, backend {dist.get_backend()}, world "
          f"{dist.get_world_size()}")

    # (a) the stacked rounds through the sharded dispatch
    server = NetServer(session=session, target="cuda[fusednet=true]", slot_capacity=BATCH)
    for v, net in enumerate(nets):
        server.register(f"v{v}", net)
    plain = [server.predict_many(req) for req in rounds]
    reset_launches()
    t0 = time.perf_counter()
    with shd.use_mesh(mesh):
        served = [server.predict_many(req) for req in rounds]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = {name: w.launches for name, w in wrappers.items()}
    b1, b1_mma = counts["binary_forward_planes"], ops.binary_forward_planes.mma_launches
    n_answers = 0
    for req, got, unsharded in zip(rounds, served, plain):
        for v, x in req.items():
            want = quantize.predict_quantized(nets[int(v[1:])], device=dev)(x).cpu().numpy()
            if not (np.array_equal(got[v], want) and np.array_equal(got[v], unsharded[v])):
                raise AssertionError(f"mesh {v}: answers != predict_quantized / unsharded")
            n_answers += x.shape[0]
    dispatch = server.dispatch_counts
    print(f"[4 {tag}] cuda[fusednet=true] stacked rounds under the mesh: {serve_s:.2f} s, "
          f"{n_answers} answers equal predict_quantized and the unsharded dispatch; dispatch "
          f"{dispatch}; launches {counts}")
    print(f"[4 {tag}] {b1_mma} of {b1} binary_forward_planes launches on the 1-bit tensor "
          "cores")
    if dispatch["sharded"] < 1 or not 0 < b1_mma == b1:
        raise AssertionError("the mesh rounds were not sharded, or B1 left its tensor cores")
    out["serve"] = {"answers": n_answers, "dispatch": dispatch, "launches": counts,
                    "s": serve_s}
    launched = {name: n for name, n in counts.items() if n}
    launched["binary_forward_planes mma"] = b1_mma
    del server

    # (b) granite-moe's full-width prefill through moe_impl=shardmap
    cfg = dataclasses.replace(configs.get_config(MOE_ARCH), compute_dtype="float32")
    with torch.inference_mode():
        params = base.tree_init(api.abstract_params(cfg),
                                torch.Generator(device=dev).manual_seed(SEED), dev)
        B, P = MESH_PREFILL
        toks = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab, (B, P)),
                               device=dev)

        def prefill():
            cache = base.tree_init(api.abstract_cache(cfg, B, P), torch.Generator(device=dev),
                                   dev)
            return api.prefill(cfg, params, {"tokens": toks}, cache)[0].float()

        def timed():                  # a warm-up call, then one timed
            prefill()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = prefill()
            torch.cuda.synchronize()
            return logits, time.perf_counter() - t0

        with mock.patch.object(moe_lib, "moe",
                               functools.partial(moe_lib.moe, capacity_factor=MESH_MOE_CF)):
            want, plain_s = timed()
            with shd.use_mesh(mesh), runtime.with_flags(moe_impl="shardmap"):
                got, shardmap_s = timed()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    print(f"[4 {tag}] {MOE_ARCH} fp32 prefill {B}x{P} at capacity factor {MESH_MOE_CF}, "
          f"moe_impl=shardmap ({shardmap_s * 1e3:.1f} ms) vs plain ({plain_s * 1e3:.1f} ms): "
          f"max |dlogit| / max |logit| = {rel:.3g} (bound {MESH_MOE_RTOL})")
    out["moe_prefill"] = {"rel": rel, "shardmap_ms": shardmap_s * 1e3,
                          "plain_ms": plain_s * 1e3}
    if not rel <= MESH_MOE_RTOL:
        raise AssertionError("moe_shardmap's prefill is not the plain layer's")
    del params, got, want
    gc.collect()
    torch.cuda.empty_cache()

    # (c) compressed_psum over the data axis
    g = torch.randn(1 << 24, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    err = torch.randn(g.shape, generator=torch.Generator(device=dev).manual_seed(SEED + 1),
                      device=dev) * 1e-3
    with shd.use_mesh(mesh):
        total, new_err = compression.compressed_psum(g, "data", err)
    want, want_err = compression.compress_decompress(g, err)
    same = bool(torch.equal(total, want) and torch.equal(new_err, want_err))
    print(f"[4 {tag}] compressed_psum over data of {g.numel()} fp32 values: "
          f"{'equal' if same else 'NOT equal'} to compress_decompress (sum and error buffer)")
    out["compressed_psum_equal"] = same
    if not same:
        raise AssertionError("compressed_psum is not compress_decompress at world size 1")
    del g, err, total, new_err, want, want_err

    # (d) a train state restored under the mesh
    small = configs.smoke(MOE_ARCH)
    abstract = step_lib.abstract_state(small)
    state = base.tree_init(abstract, torch.Generator(device=dev).manual_seed(SEED), dev)
    path = ckpt.save(str(scratch / "ckpt"), 1, state)
    rules = {"batch": ("data",)}
    with shd.use_mesh(mesh, rules):
        restored = ckpt.restore(path, abstract, device=dev)
        specs = {base.keystr(p): shd.named_sharding(tuple(i.shape), i.logical)
                 for p, i in base.tree_items(abstract)}
    n_shard, bad = 0, []
    for (p, got), (_, saved) in zip(base.tree_items(restored), base.tree_items(state)):
        key = base.keystr(p)
        if not (tuple(got.placements) == specs[key].placements
                and torch.equal(got.full_tensor(), saved)):
            bad.append(key)
        n_shard += any(type(pl).__name__ == "Shard" for pl in got.placements)
    tok = "['params']['embed']['tok']"
    print(f"[4 {tag}] restore of a {small.name} train state under the mesh: "
          f"{len(specs)} leaves as DTensors, {n_shard} of them sharded, placements as their "
          f"specs, full tensors equal to the save: {not bad} (e.g. {tok}: "
          f"{specs[tok].spec} -> {tuple(restored['params']['embed']['tok'].placements)})")
    out["restore"] = {"leaves": len(specs), "sharded": n_shard, "bad": bad}
    if bad:
        raise AssertionError(f"restored leaves off their specs: {bad}")
    del state, restored

    # (e) a layer that remat="full" recomputes runs where autograd runs the
    # backward, for CUDA tensors its device thread: it must see its
    # forward's mesh, flags and data-parallel reduction group there
    seen = []

    def body(x):
        seen.append((threading.get_ident(), shd.active_mesh() is mesh,
                     runtime.flag("moe_impl"), dp.group() is group))
        return torch.sin(x * 2)

    group = mesh.group(("data",))
    x = torch.ones(1024, device=dev, requires_grad=True)
    with shd.use_mesh(mesh), runtime.with_flags(moe_impl="shardmap"), dp.reducing(group):
        base.remat_call("full", body, x).sum().backward()
    same_state = len(seen) == 2 and seen[0][1:] == seen[1][1:] == (True, "shardmap", True)
    elsewhere = len(seen) == 2 and seen[0][0] != seen[1][0]
    print(f"[4 {tag}] remat recompute on "
          f"{'another thread than its forward' if elsewhere else 'its forward thread'}: "
          f"sees the forward's mesh, flags and reduction group: {same_state}")
    out["remat_recompute"] = {"other_thread": elsewhere, "same_state": same_state}
    if not same_state:
        raise AssertionError("a recomputed layer lost its forward's mesh, flags or group")
    dist.destroy_process_group()
    shutil.rmtree(scratch, ignore_errors=True)

    seconds = time.perf_counter() - t_phase
    print(f"[4 {tag}] phase {seconds:.1f} s")
    print(json.dumps({"mesh": out, "phase_s": seconds,
                      "device": torch.cuda.get_device_name(dev), "power": smi}))
    return launched


def _mesh_train_child(root: Path) -> int:
    """`chip_smoke.py --mesh-train DIR`, run by phase 4(j) in a process
    whose CUBLAS_WORKSPACE_CONFIG is set: granite-moe-1b-a400m at full
    width through `trainer.run`, 2 steps at 1 x 512 with remat, without a
    mesh and then under `make_host_mesh()`, under deterministic
    algorithms. Prints the losses, the peak memory and whether the two
    runs' parameters are bitwise equal; the last line is JSON."""
    import gc
    import shutil
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api, base
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import trainer

    dev = torch.device("cuda", 0)
    torch.cuda.init()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    cfg = configs.get_config(MOE_ARCH)
    n = base.count_params(api.abstract_params(cfg))
    shape = base.ShapeConfig("mesh", MESH_TRAIN_SEQ, 1, "train")
    oc = adamw.OptConfig(lr=3e-4, warmup_steps=2, total_steps=MESH_TRAIN_STEPS)
    runs = {}
    for label in ("no mesh", "mesh"):
        mesh = make_host_mesh() if label == "mesh" else None
        tc = trainer.TrainerConfig(total_steps=MESH_TRAIN_STEPS,
                                   ckpt_every=MESH_TRAIN_STEPS + 1,
                                   ckpt_dir=str(root / label.replace(" ", "_")), seed=SEED,
                                   remat="full")
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with shd.use_mesh(mesh, {"batch": ("data",)}):
            state, hist = trainer.run(cfg, shape, oc, tc, device=dev)
        torch.cuda.synchronize()
        runs[label] = {"loss": hist["loss"], "s": time.perf_counter() - t0,
                       "peak": torch.cuda.max_memory_allocated(dev),
                       "params": state["params"]}
        del state, hist
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[4 mesh path] {MOE_ARCH} ({n} parameters, fp32 state {16 * n / 1e9:.1f} GB) "
              f"{label}: {MESH_TRAIN_STEPS} steps of 1x{MESH_TRAIN_SEQ} in "
              f"{runs[label]['s']:.2f} s, losses "
              f"{', '.join(f'{v:.7f}' for v in runs[label]['loss'])}, peak "
              f"{runs[label]['peak'] / 1e9:.1f} GB allocated")
    a, b = runs["no mesh"], runs["mesh"]
    differ = [base.keystr(p) for (p, x), (_, y) in zip(base.tree_items(a["params"]),
                                                      base.tree_items(b["params"]))
              if not torch.equal(x, y)]
    scale = max(x.abs().max().item() for _, x in base.tree_items(a["params"]))
    diff = max((x - y).abs().max().item() for (_, x), (_, y) in
               zip(base.tree_items(a["params"]), base.tree_items(b["params"])))
    bitwise = a["loss"] == b["loss"] and not differ
    print(f"[4 mesh path] under the mesh vs without, deterministic algorithms: losses "
          f"{'equal' if a['loss'] == b['loss'] else 'differ'}, parameters "
          f"{'bitwise equal' if not differ else f'differ in {len(differ)} leaves'} "
          f"(max |diff| {diff:.3g} of the largest |p| {scale:.3g})")
    dist.destroy_process_group()
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"mesh_train": {
        "bitwise": bitwise, "leaves_differ": differ, "max_abs_diff": diff,
        **{k.replace(" ", "_"): {"loss": r["loss"], "s": r["s"], "peak_bytes": r["peak"]}
           for k, r in runs.items()}}}))
    return 0


ROOF_PREFILL = (4, 512)                  # mamba2-2.7b prefill through B7 (rows, tokens)
ROOF_WALL_RUNS = 3                       # uncounted prefills timed after one warm-up
DRYRUN_TIMEOUT_S = 300


def _roofline_path(dev, wrappers, reset_launches, smi) -> dict:
    """Phase 4(k): the counting mode (`launch/cost.py`) and the roofline
    (`launch/roofline.py`) on the card, at world size 1. (a) mamba2-2.7b
    prefill 4 x 512 through B7, counted on the card and the same step on
    `meta`: FLOPs and bytes equal, B7's counted FLOPs 64 x
    `ssd_correction`'s per-layer forward, its 64 launches all on the
    tensor cores; the uncounted prefill's wall beside t_compute, t_memory
    and the roofline fraction. (b) The gemma-2b train step of the train
    path, counted the same way: `model_flops` (active parameters, the
    embedding gather excluded), the counted matmul FLOPs with the remat
    recompute, their ratio, the counted peak against
    `max_memory_allocated`. (c) One `qlinear` at the W8 `in_proj` shape,
    B6 counted by its formula on the card and on `meta`. (d) The dry run
    in a subprocess with no card (`CUDA_VISIBLE_DEVICES=`): mamba2-2.7b
    `prefill_32k` on a fake 16 x 16 world on `meta`; its record. Returns
    the phase's launches."""
    import dataclasses
    import gc
    import os
    import torch
    from repro_torch import configs
    from repro_torch.kernels.quant_matmul import ops as qops
    from repro_torch.launch import cost, dryrun
    from repro_torch.launch import roofline as rl
    from repro_torch.models.base import ShapeConfig

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tag = "roofline path"
    out = {}

    def both(cfg, shape, remat="full"):
        """(card counter, meta counter, the card's built step)."""
        run = dryrun.build_step(cfg, shape, device=dev, remat=remat)
        torch.cuda.synchronize()
        card = dryrun.count_step(run)
        torch.cuda.synchronize()
        meta = dryrun.count_step(dryrun.build_step(cfg, shape, device="meta", remat=remat))
        if (card.flops, card.bytes) != (meta.flops, meta.bytes):
            raise AssertionError(f"{cfg.name} {shape.kind}: card counts {card.flops} FLOP, "
                                 f"{card.bytes} B; meta {meta.flops}, {meta.bytes}")
        return card, meta, run

    # (a) mamba2-2.7b prefill through B7
    cfg = configs.get_config(LM_ARCH)
    shape = ShapeConfig("chip", ROOF_PREFILL[1], ROOF_PREFILL[0], "prefill")
    reset_launches()
    card, meta, run = both(cfg, shape)
    n_ssd, n_mma = wrappers["ssd_scan"].launches, wrappers["ssd_scan"].mma_launches
    per_layer = rl.ssd_correction(dataclasses.replace(cfg, n_layers=1), batch=shape.global_batch,
                                  seq=shape.seq_len, kind="prefill")
    b7 = card.kernels.get("ssd_scan", {})
    if not (n_ssd == n_mma == cfg.n_layers == b7.get("calls")):
        raise AssertionError(f"ssd_scan: {n_ssd} launches, {n_mma} on the tensor cores, "
                             f"{b7.get('calls')} counted; want {cfg.n_layers} of each")
    if b7["flops"] != cfg.n_layers * per_layer["flops"] or b7 != meta.kernels["ssd_scan"]:
        raise AssertionError(f"ssd_scan counted {b7}; want {cfg.n_layers} x {per_layer}")
    run()                                                  # warm, uncounted
    torch.cuda.synchronize()
    walls = []
    for _ in range(ROOF_WALL_RUNS):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    roof = rl.Roofline(cfg.name, "prefill 4x512", "1", 1, card.flops, card.bytes, 0.0,
                       rl.collective_stats(card.collective_ops), rl.model_flops(cfg, shape),
                       float(card.peak_bytes))
    print(f"[4 {tag}] {cfg.name} prefill {shape.global_batch}x{shape.seq_len} (bf16 compute, "
          f"fp32 weights) counted on the card = on meta: {card.flops:.6e} FLOP, "
          f"{card.bytes:.6e} B ({card.n_ops} aten ops); ssd_scan {n_mma} of {n_ssd} launches on "
          f"the tensor cores, counted {b7['flops']:.0f} FLOP = {cfg.n_layers} x "
          f"ssd_correction's {per_layer['flops']:.0f}")
    print(f"[4 {tag}] {cfg.name} prefill: wall {wall * 1e3:.2f} ms (median of "
          f"{ROOF_WALL_RUNS}, host clock, uncounted); t_compute {roof.t_compute * 1e3:.3f} ms, "
          f"t_memory {roof.t_memory * 1e3:.3f} ms (unfused bytes), bottleneck {roof.bottleneck}, "
          f"roofline fraction {roof.roofline_fraction:.3f}, model_flops "
          f"{roof.model_flops:.6e}; wall / largest term "
          f"{wall / max(roof.t_compute, roof.t_memory):.2f} ({smi})")
    out["prefill"] = {**roof.as_dict(), "wall_s": wall, "walls_s": walls,
                      "ssd_launches": n_ssd, "ssd_mma_launches": n_mma, "ssd_scan": b7}
    del run, card, meta
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the gemma-2b train step of the train path
    cfg = configs.get_config(TRAIN_ARCH)
    shape = ShapeConfig("chip", TRAIN_SEQ, TRAIN_BATCH, "train", accum=TRAIN_ACCUM)
    torch.cuda.reset_peak_memory_stats(dev)
    card, meta, run = both(cfg, shape)
    peak = torch.cuda.max_memory_allocated(dev)
    mf = rl.model_flops(cfg, shape)
    print(f"[4 {tag}] {cfg.name} train step {TRAIN_BATCH}x{TRAIN_SEQ}, {TRAIN_ACCUM} "
          f"microbatches, remat full, counted on the card = on meta: matmul {card.flops:.6e} "
          f"FLOP (remat recompute included), {card.bytes:.6e} B ({card.n_ops} aten ops); "
          f"model_flops {mf:.6e} (6 x {rl.active_param_count(cfg):.0f} active x "
          f"{TRAIN_BATCH * TRAIN_SEQ} tokens); counted / model {card.flops / mf:.4f}; counted "
          f"peak {card.peak_bytes / 1e9:.2f} GB (arguments {card.arg_bytes / 1e9:.2f}) vs "
          f"max_memory_allocated {peak / 1e9:.2f} GB ({smi})")
    out["train"] = {"flops": card.flops, "bytes": card.bytes, "model_flops": mf,
                    "ratio": card.flops / mf, "peak_counted": card.peak_bytes,
                    "arg_bytes": card.arg_bytes, "max_memory_allocated": peak,
                    "aten_ops": card.n_ops}
    del run, card, meta
    gc.collect()
    torch.cuda.empty_cache()

    # (c) one qlinear at the W8 in_proj shape: B6 by its formula
    m, k, n = QMM_SHAPES["in_proj"]
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((m, k), generator=g, device=dev, dtype=torch.bfloat16)
    w_q = qops.qmm_weights(torch.randint(-127, 128, (k, n), generator=g, device=dev,
                                         dtype=torch.int8))
    sw = torch.rand((n,), generator=g, device=dev)
    reset_launches()
    counts = {}
    for where, args in (("card", (x, w_q, sw)), ("meta", tuple(t.to("meta") for t in
                                                             (x, w_q, sw)))):
        with cost.Counter() as c:
            qops.qlinear(*args)
        counts[where] = c.kernels.get("quant_matmul")
    torch.cuda.synchronize()
    n_qmm = wrappers["quant_matmul"].launches
    ops_, bytes_ = qops.work(m, k, n)
    want = {"calls": 1, "flops": float(ops_), "bytes": float(bytes_)}
    if counts["card"] != want or counts["meta"] != want or n_qmm != 1:
        raise AssertionError(f"qlinear counted {counts}, {n_qmm} launches; want {want}, 1")
    print(f"[4 {tag}] qlinear {m}x{k} x {k}x{n}: quant_matmul counted once on the card and on "
          f"meta, {ops_} operations (2MKN + 2MN), {bytes_} B; {n_qmm} launch")
    del x, w_q, sw

    # (d) the dry run on a fake 16 x 16 world, meta tensors, no card
    path = ROOT / "build" / "roofline" / "dryrun_mamba2_prefill_32k.json"
    path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "single_pod", "--arch",
         LM_ARCH, "--shape", "prefill_32k", "--out", str(path)],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""},
        cwd=ROOT, capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S)
    dry_s = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"dryrun exit {proc.returncode}: {proc.stderr[-2000:]}")
    (rec,) = json.loads(path.read_text())
    if not (rec["ok"] and rec["chips"] == 256 and rec["kernels"]["ssd_scan"]["calls"] == 64):
        raise AssertionError(f"dryrun record: {rec}")
    print(f"[4 {tag}] dryrun --mesh single_pod --arch {LM_ARCH} --shape prefill_32k ({dry_s:.1f} "
          f"s, fake 16x16 world, meta, no card): flops/device {rec['flops_per_device']:.6e}, "
          f"bytes/device {rec['bytes_per_device']:.6e}, peak {rec['peak_mem_per_device'] / 2**30:.3f} "
          f"GiB, t_compute {rec['t_compute'] * 1e3:.2f} ms, t_memory {rec['t_memory'] * 1e3:.2f} "
          f"ms, bottleneck {rec['bottleneck']}, useful_flops_ratio "
          f"{rec['useful_flops_ratio']:.4f}, roofline_fraction {rec['roofline_fraction']:.4f}")
    out["dryrun"] = {k: rec[k] for k in ("flops_per_device", "bytes_per_device",
                                         "peak_mem_per_device", "useful_flops_ratio",
                                         "roofline_fraction", "bottleneck")}
    out["dryrun"]["wall_s"] = dry_s
    seconds = time.perf_counter() - t_phase
    print(f"[4 {tag}] phase {seconds:.1f} s")
    print(json.dumps({"roofline": out, "phase_s": seconds, "power": smi}))
    return {"ssd_scan": n_ssd, "ssd_scan mma": n_mma, "quant_matmul": n_qmm}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import dataset, quantize
    from repro_torch.kernels.binary_matvec import build, ops, ref
    from repro_torch.kernels.fused_mlp import build as fbuild
    from repro_torch.kernels.fused_mlp import ops as fops
    from repro_torch.kernels.fused_mlp import ref as fref
    from repro_torch.kernels.quant_matmul import build as qbuild
    from repro_torch.kernels.quant_matmul import ops as qops
    from repro_torch.kernels.quant_matmul import ref as qref
    from repro_torch.kernels.ssd_scan import build as sbuild
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.netgen import NetServer, Session

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    wrappers = {"binary_matmul_planes": ops.binary_matmul_planes,
                "binary_forward_planes": ops.binary_forward_planes,
                "binary_matmul": ops.binary_matmul,
                "binary_matmul_packed": ops.binary_matmul_packed,
                "fused_mlp_predict": fops.fused_mlp_predict,
                "quant_matmul": qops.quant_matmul, "ssd_scan": sops.ssd}
    libraries = (build, fbuild, sbuild, qbuild)

    def reset_launches():
        for mod in (ops, fops, qops, sops):
            mod.reset_launches()

    # -- 1. device ------------------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = _smi("name,power.limit")
    clock_hz = float(_smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {"b1_tc": None, "popc": POPC_PER_CLOCK_PER_SM * sms * clock_hz,
             "add": ADD_PER_CLOCK_PER_SM * sms * clock_hz,
             "fp32": 2 * FMA_PER_CLOCK_PER_SM * sms * clock_hz,
             "int8_tc": INT8_TC_OPS_PER_S}
    print(f"[1 device] {kind}: {sms} SMs, max SM clock {clock_hz / 1e6:.0f} MHz; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    # -- 2. build: one nvcc per source, started together ---------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(libraries)) as pool:
        loads = [pool.submit(b.load) for b in libraries]
        for f in loads:
            f.result()
    wall = time.perf_counter() - t0
    for b in libraries:
        info = b.last_build()
        print(f"[2 build] {info.path.name} compiled={info.compiled} "
              f"nvcc {info.seconds:.1f} s")
        for line in info.log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("    " + line.strip())
    print(f"[2 build] {len(libraries)} libraries loaded in {wall:.1f} s")

    # -- 3. kernels against their plain versions -----------------------------
    rng = np.random.default_rng(SEED)
    hidden_pad = -(-N_HIDDEN // 32) * 32
    w1, w2 = -(-N_IN // 32), hidden_pad // 32
    thr = quantize.INPUT_THRESHOLD
    cases = {name: {} for name in NETGEN}
    # The planes in the layout the backend holds (`plane_mma_weights`), and
    # once row-major, which the op copies into that layout on every call.
    for label, (kw, n) in {"layer1": (w1, N_HIDDEN), "layer2": (w2, N_OUT)}.items():
        x, pos, neg = (_words(rng, (BATCH, kw), dev), _words(rng, (PLANES, kw, n), dev),
                       _words(rng, (PLANES, kw, n), dev))
        cases["binary_matmul_planes"][label] = (
            (x, ops.plane_mma_weights(pos), ops.plane_mma_weights(neg)), {},
            ops.binary_matmul_planes, ref.plane_matmul)
        if label == "layer1":
            cases["binary_matmul_planes"]["layer1_rowmajor"] = (
                (x, pos, neg), {}, ops.binary_matmul_planes, ref.plane_matmul)
    # The megakernel on planes in the layout the backend holds, with the
    # layer table built once, as the backend builds it; stacked once more
    # row-major (copied per call); and its scalar kernel, called directly.
    kw_args = {"threshold": thr, "n_classes": N_OUT}
    for label, lead in {"single": (), "stacked": (MODELS,)}.items():
        x = torch.from_numpy(rng.integers(
            0, 256, size=(*lead, BATCH, N_IN), dtype=np.uint8)).to(dev)
        planes = []
        for kw, n in ((w1, hidden_pad), (w2, N_OUT)):
            planes += [_words(rng, (*lead, PLANES, kw, n), dev) for _ in range(2)]
        held = [ops.plane_mma_weights(a) for a in planes]
        forward = functools.partial(ops.binary_forward_planes, table=ops.ForwardTable(held))
        cases["binary_forward_planes"][label] = (
            (x, *held), kw_args, forward, ref.forward_planes)
        if label == "stacked":
            cases["binary_forward_planes"]["stacked_rowmajor"] = (
                (x, *planes), kw_args, ops.binary_forward_planes, ref.forward_planes)
            cases["binary_forward_planes"]["stacked_scalar"] = (
                (x, *planes), kw_args, _scalar_forward(planes), ref.forward_planes)
    # Both routes of the dense and packed products: int8 weights in the
    # layout the backend holds (`mma_weights`; the tensor-core route, the
    # main path's, heading the kernel's record), at |w| <= 9 and over the
    # whole int8 range with a row at -128 and a row at 127; then int32
    # weights (the scalar route).
    def weights(k, n, wide, dtype):
        w = _ints(rng, -128 if wide else -9, 127 if wide else 9, (k, n), dtype, dev)
        if wide:
            w[0], w[-1] = -128, 127
        return ops.mma_weights(w) if dtype == torch.int8 else w

    routes = {"layer1_int8": (0, False, torch.int8), "layer2_int8": (1, False, torch.int8),
              "layer1_int8_extremes": (0, True, torch.int8),
              "layer2_int8_extremes": (1, True, torch.int8),
              "layer1": (0, False, torch.int32), "layer2": (1, False, torch.int32)}
    for label, (layer, wide, dtype) in routes.items():
        k, n = ((N_IN, N_HIDDEN), (N_HIDDEN, N_OUT))[layer]
        args = (_ints(rng, -2, 2, (BATCH, k), torch.int8, dev), weights(k, n, wide, dtype))
        cases["binary_matmul"][label] = (args, {}, ops.binary_matmul, ref.binary_matmul)
    for label, (layer, wide, dtype) in routes.items():
        kw, n = ((w1, N_HIDDEN), (w2, N_OUT))[layer]
        args = (_words(rng, (BATCH, kw), dev), weights(kw * 32, n, wide, dtype))
        cases["binary_matmul_packed"][label] = (
            args, {}, ops.binary_matmul_packed, ref.binary_matmul_packed)
    # Both routes of the fused net: int8 weights in the layout the backend
    # holds (the tensor-core route, heading the record), at |w| <= 9 and
    # over the whole int8 range; then int32 weights (the scalar route).
    x = torch.from_numpy(rng.integers(0, 256, size=(BATCH, N_IN), dtype=np.uint8)).to(dev)
    for label, (wide, dtype) in {"net_int8": (False, torch.int8),
                                 "net_int8_extremes": (True, torch.int8),
                                 "net": (False, torch.int32)}.items():
        args = (x, weights(N_IN, N_HIDDEN, wide, dtype), weights(N_HIDDEN, N_OUT, wide, dtype))
        cases["fused_mlp_predict"][label] = (
            args, {"threshold": thr}, fops.fused_mlp_predict, fref.fused_mlp_predict)
    errors, forward_routes = {}, {}
    for name, shapes in cases.items():
        for label, (args, kw, kernel, plain) in shapes.items():
            mma = ops.binary_forward_planes.mma_launches
            got, want = kernel(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max().item())
            errors[name, label] = err
            route = ""
            if name == "binary_forward_planes":
                tc = ops.binary_forward_planes.mma_launches > mma
                forward_routes[label] = "tensor cores" if tc else "scalar"
                route = f" on the {forward_routes[label]} route"
                if tc == (label == "stacked_scalar"):
                    raise AssertionError(f"{name}[{label}] took the {forward_routes[label]} route")
            print(f"[3 kernel] {name}[{label}] {tuple(got.shape)}{route} "
                  f"max_abs_err={err}")
            if not torch.equal(got, want):
                raise AssertionError(f"{name}[{label}] disagrees with its plain version")

    # w_q K-major as `qmm_weights` makes it once (the decode shape takes
    # the narrow tile), and in_proj once more with w_q row-major, which the
    # op copies into that layout on every call.
    lm_cases = {"quant_matmul": {}, "ssd_scan": {}}
    qmm_cases = []
    for label, (m, k, n) in QMM_SHAPES.items():
        xq, wq, sx, sw = _qmm_args(rng, m, k, n, dev)
        qmm_cases.append((label, (xq, qops.qmm_weights(wq), sx, sw)))
        if label == "in_proj":
            qmm_cases.append(("in_proj_rowmajor", (xq, wq, sx, sw)))
    for label, args in qmm_cases:
        m = args[0].shape[0]
        narrow = qops.quant_matmul.narrow_launches
        got, want = qops.quant_matmul(*args), qref.quant_matmul_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max().item())
        errors["quant_matmul", label] = err
        tile = "64x64" if qops.quant_matmul.narrow_launches > narrow else "128x128"
        print(f"[3 kernel] quant_matmul[{label}] {tuple(got.shape)} tile {tile} "
              f"max_abs_err={err}")
        if not torch.equal(got, want):
            raise AssertionError(f"quant_matmul[{label}] disagrees with its plain version")
        if (tile == "64x64") != (m <= qops.NARROW_M):
            raise AssertionError(f"quant_matmul[{label}] took the {tile} tile at M={m}")
        lm_cases["quant_matmul"][label] = args
    ssd_routes = {}
    # mamba2-2.7b's N = 128 on both routes, then zamba2-2.7b's N = 64 in bf16
    for label, dtype, n in (("bf16", torch.bfloat16, 128), ("fp32", torch.float32, 128),
                            ("bf16_zamba", torch.bfloat16, HYBRID_SSM_STATE)):
        args = _ssd_args(rng, dev, dtype, n)
        mma = sops.ssd.mma_launches
        (y, s), (yp, sp) = sops.ssd(*args, chunk=LM_CHUNK), sref.ssd(*args, chunk=LM_CHUNK)
        torch.cuda.synchronize()
        ssd_routes[label] = "tensor cores" if sops.ssd.mma_launches > mma else "scalar"
        err = float((y.float() - yp.float()).abs().max().item())
        s_err = float((s - sp).abs().max().item())
        errors["ssd_scan", label] = err
        print(f"[3 kernel] ssd_scan[{label}] {tuple(y.shape)} on the {ssd_routes[label]} "
              f"route max_abs_err={err:.3g} (|y| <= {yp.float().abs().max().item():.3g}), "
              f"state {s_err:.3g}")
        if not _ssd_agrees(y, s, yp, sp):
            raise AssertionError(f"ssd_scan[{label}] disagrees with its plain version")
        if dtype == torch.bfloat16 and ssd_routes[label] != "tensor cores":
            raise AssertionError(f"ssd_scan[{label}] did not take the tensor-core route")
        lm_cases["ssd_scan"][label] = args

    # -- 4. main paths --------------------------------------------------------
    nets = []
    for v in range(MODELS):
        r = np.random.default_rng(SEED + 1 + v)
        nets.append(quantize.QuantizedNet(
            w1=quantize.int_cast_weights(r.normal(0, N_IN ** -0.5, (N_IN, N_HIDDEN))),
            w2=quantize.int_cast_weights(r.normal(0, N_HIDDEN ** -0.5, (N_HIDDEN, N_OUT)))))
    images, _ = dataset.make_dataset(1200, seed=SEED)
    session = Session(device="cuda")
    rounds = [{"v0": images[:600], "v1": images[600:900], "v2": images[900:940]},
              {"v0": images[:256], "v1": images[256:512], "v2": images[512:768]}]
    oracle = NetServer(session=session, target="torch", slot_capacity=BATCH)
    for v, net in enumerate(nets):
        oracle.register(f"v{v}", net)

    servers, launches, mma_launches = {}, {}, {}
    for target, kernels in PATHS.items():
        reset_launches()
        t0 = time.perf_counter()
        server = NetServer(session=session, target=target, slot_capacity=BATCH)
        for v, net in enumerate(nets):
            server.register(f"v{v}", net)
        served = [({"v0": images[:300]}, {"v0": server.predict("v0", images[:300])})]
        served += [(req, server.predict_many(req)) for req in rounds]
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        counts = {name: wrappers[name].launches for name in wrappers}
        print(f"[4 main path] {target}: {main_s:.2f} s, dispatch "
              f"{server.dispatch_counts}, launches {counts}")
        for name in kernels:
            if counts[name] <= 0:
                raise AssertionError(f"the {target} path never launched {name}")
            launches[name] = counts[name]
        if target in MMA_PATHS:
            wrapper = wrappers[MMA_PATHS[target]]
            mma_launches[MMA_PATHS[target]] = wrapper.mma_launches
            print(f"[4 main path] {target}: {wrapper.mma_launches} of {wrapper.launches} "
                  f"{MMA_PATHS[target]} launches on the "
                  f"{MMA_KIND.get(MMA_PATHS[target], 'int8')} tensor cores")
            if not 0 < wrapper.mma_launches == wrapper.launches:
                raise AssertionError(f"{target}: not every launch took the tensor-core route")
        for req, out in served:
            for v, x in req.items():
                net = nets[int(v[1:])]
                got = out[v]
                if got.shape != (x.shape[0],) or got.min() < 0 or got.max() >= N_OUT:
                    raise AssertionError(f"{target} {v}: bad predictions {got.shape}")
                want = quantize.predict_quantized(net, device=dev)(x).cpu().numpy()
                if not np.array_equal(got, want):
                    raise AssertionError(f"{target} {v}: served answers != predict_quantized")
                if not np.array_equal(got, oracle.predict(v, x)):
                    raise AssertionError(f"{target} {v}: served answers != torch target")
        print(f"[4 main path] {target}: "
              f"{sum(x.shape[0] for req, _ in served for x in req.values())} "
              "answers equal predict_quantized and the torch target")
        servers[target] = server

    deep, deep_mma = _deep_fusednet_path(session, oracle, dev, wrappers, reset_launches)
    launches["binary_forward_planes"] += deep
    mma_launches["binary_forward_planes"] += deep_mma
    _wrapping_net_path(session, dev)
    served = _engine_path(nets, images, dev, wrappers, reset_launches, smi)
    mma_launches["binary_forward_planes"] += served.pop("binary_forward_planes mma")
    for name, n in served.items():
        launches[name] += n
    hw = _hw_path(session, nets[0], images, dev, wrappers, reset_launches, smi)
    mma_launches["binary_forward_planes"] += hw.pop("binary_forward_planes mma")
    for name, n in hw.items():
        launches[name] += n
    paper = _paper_path(dev, wrappers, reset_launches, smi)
    for name, n in paper.pop("mma").items():
        mma_launches[name] += n
    for name, n in paper.items():
        launches[name] += n

    lm_launches, lm_times, lm_trace = _lm_main_path(dev, wrappers, reset_launches)
    mma_launches["ssd_scan"] = lm_launches.pop("ssd_scan mma")
    launches.update(lm_launches)
    _dense_path(dev, wrappers, reset_launches, smi)
    # one prefill's launches of each family that runs ssd_scan
    ssd_per_prefill = {"bf16": launches["ssd_scan"],
                       "bf16_zamba": _hybrid_path(dev, wrappers, reset_launches, smi)}
    launches["ssd_scan"] += ssd_per_prefill["bf16_zamba"]
    mma_launches["ssd_scan"] += ssd_per_prefill["bf16_zamba"]
    _moe_path(dev, wrappers, reset_launches, smi)
    _modality_path(dev, wrappers, reset_launches, smi)
    _train_path(dev, wrappers, reset_launches, smi)
    meshed = _mesh_path(dev, wrappers, reset_launches, smi, session, nets, images, rounds)
    mma_launches["binary_forward_planes"] += meshed.pop("binary_forward_planes mma")
    for name, n in meshed.items():
        launches[name] += n
    roofed = _roofline_path(dev, wrappers, reset_launches, smi)
    mma_launches["ssd_scan"] += roofed.pop("ssd_scan mma")
    for name, n in roofed.items():
        launches[name] += n

    # -- 5. times -------------------------------------------------------------
    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    records = []
    for name, shapes in cases.items():
        per_shape = []
        for label, (args, kw, kernel, plain) in shapes.items():
            out = kernel(*args, **kw)
            moved = nbytes(args) + nbytes([out])
            work, op = _work(name, args, kw, forward_routes.get(label, "tensor cores"))
            bound_ms, bound_by = _bound(moved, work, rates[op])
            extra = {}
            if name == "binary_forward_planes":
                # the popcounts at the CUDA cores' __popc rate, beside the route's bound
                popc, _ = _work(name, args, kw, "scalar")
                extra = {"path": forward_routes[label],
                         "cuda_core_bound_ms": _bound(moved, popc, rates["popc"])[0]}
            rec = {
                "shape": label,
                "ms": _time_ms(lambda: kernel(*args, **kw), clock_hz),
                "plain_ms": _time_ms(lambda: plain(*args, **kw), clock_hz),
                **_library(name, args, out, clock_hz),
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved,
                {"b1_tc": "bit_ops", "popc": "popcounts", "add": "adds",
                 "int8_tc": "int8_ops"}[op]: work,
                **extra, "max_abs_err": errors[name, label],
            }
            per_shape.append(rec)
            print(json.dumps({"kernel": name, **rec}))
        head = per_shape[1] if name == "binary_forward_planes" else per_shape[0]
        records.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in per_shape),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "library": head["library"],
            "timed_shape": head["shape"], "shapes": per_shape,
        })
        if name in mma_launches:
            records[-1]["mma_launches"] = mma_launches[name]

    for name, shapes in lm_cases.items():
        per_shape = []
        for label, args in shapes.items():
            if name == "quant_matmul":
                def kernel():
                    return qops.quant_matmul(*args)

                def plain():
                    return qref.quant_matmul_ref(*args)
                out = [kernel()]
                (m, k), n = args[0].shape, args[1].shape[1]
                work, rate = 2 * m * k * n, rates["int8_tc"]
                library = _int_mm_library(args, out[0], clock_hz)
                extra = {"int8_ops": work, "tile": "64x64" if m <= qops.NARROW_M else "128x128"}
            else:
                def kernel():
                    return sops.ssd(*args, chunk=LM_CHUNK)

                def plain():
                    return sref.ssd(*args, chunk=LM_CHUNK)
                out = list(kernel())
                work = _ssd_flop(args[0], args[3], LM_CHUNK)
                # the route's own rate: bf16 tensor cores, or fp32 FMAs on
                # the CUDA cores for the scalar route
                tc = ssd_routes[label] == "tensor cores"
                rate = BF16_TC_FLOP_PER_S if tc else rates["fp32"]
                library = {"library_ms": None, "library": None, "library_max_abs_err": None}
                extra = {"flop": work, "path": ssd_routes[label],
                         "cuda_core_bound_ms": _bound(nbytes(args) + nbytes(out), work,
                                                      rates["fp32"])[0]}
            moved = nbytes(args) + nbytes(out)
            bound_ms, bound_by = _bound(moved, work, rate)
            if name == "ssd_scan" and label in ssd_per_prefill:
                extra["launches_per_prefill"] = ssd_per_prefill[label]
            rec = {
                "shape": label, "ms": _time_ms(kernel, clock_hz),
                "plain_ms": _time_ms(plain, clock_hz), **library,
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved, **extra,
                "max_abs_err": errors[name, label],
            }
            per_shape.append(rec)
            print(json.dumps({"kernel": name, **rec}))
        head = per_shape[0]
        records.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in per_shape),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "library": head["library"],
            "timed_shape": head["shape"], "shapes": per_shape,
        })
        if name in mma_launches:
            records[-1]["mma_launches"] = mma_launches[name]
    for label, run in lm_times.items():
        if label.endswith("aligned"):     # the shape ssd_scan was timed at, per layer
            run["ssd_scan_ms_per_prefill"] = run["ssd_launches"] * records[-1]["ms"]
    print(json.dumps({"lm_ms": lm_times, "lm_profile": lm_trace, "device": kind,
                      "power": smi}))

    sweep = {}
    # the megakernel's cluster: what the op picks per shape, and the
    # clusters of each size the card holds at once at its shared memory
    shape = ([PLANES, PLANES], [w1, w2])
    smem = ops.forward_mma_smem_bytes(*shape, ops.FORWARD_BM)
    forward_clusters = {
        "cluster_single": ops.launch_cluster(*shape, BATCH, 1, ops.FORWARD_BM, dev),
        "cluster_stacked": ops.launch_cluster(*shape, BATCH, MODELS, ops.FORWARD_BM, dev),
        "max_active_clusters": {c: build.load().bmv_forward_max_clusters(
            ops.FORWARD_BM, c, smem, 0) for c in SWEEP_CLUSTER},
        "smem_bytes": smem}
    args, kw, kernel, _ = cases["binary_forward_planes"]["stacked"]
    sweep["binary_forward_planes[stacked]"] = {f"tile={bm},cluster={cl}": _time_ms(
        lambda: kernel(*args, bm=bm, cluster=cl, **kw), clock_hz)
        for bm in SWEEP_MMA_BM for cl in SWEEP_CLUSTER}
    args, _, kernel, _ = cases["binary_matmul_planes"]["layer1"]
    sweep["binary_matmul_planes[layer1]"] = {f"bm={bm},bn={bn}": _time_ms(
        lambda: kernel(*args, bm=bm, bn=bn), clock_hz)
        for bm in SWEEP_MMA_BM for bn in SWEEP_BN}
    for name in ("binary_matmul", "binary_matmul_packed"):
        for label, bms in (("layer1_int8", SWEEP_MMA_BM), ("layer1", SWEEP_BM)):
            args, _, kernel, _ = cases[name][label]
            sweep[f"{name}[{label}]"] = {f"bm={bm},bn={bn}": _time_ms(
                lambda: kernel(*args, bm=bm, bn=bn), clock_hz)
                for bm in bms for bn in SWEEP_BN}
    args, kw, kernel, _ = cases["fused_mlp_predict"]["net"]
    sweep["fused_mlp_predict"] = {f"bm={bm}": _time_ms(
        lambda: kernel(*args, bm=bm, **kw), clock_hz) for bm in SWEEP_BM}
    print(json.dumps({"sweep_ms": sweep, "defaults": {
        "binary_matmul": [ops.DENSE_BM, ops.DENSE_BN],
        "binary_matmul_packed": [ops.PACKED_BM, ops.PACKED_BN],
        "tensor-core route": [ops.MMA_BM, ops.MMA_BN],
        "binary_matmul_planes": [ops.MATMUL_BM, ops.MATMUL_BN],
        "fused_mlp_predict": fops.FUSED_BM,
        "binary_forward_planes": {"bm": ops.FORWARD_BM, **forward_clusters}}}))

    latency = {}
    for target, server in servers.items():
        calls = {"stacked_round_3x256": lambda: server.predict_many(rounds[1]),
                 "single_round_256": lambda: server.predict("v0", images[:BATCH])}
        for label, call in calls.items():
            call()
            ts = []
            for _ in range(TIMING_RUNS):
                t0 = time.perf_counter()
                call()
                ts.append((time.perf_counter() - t0) * 1e3)
            latency[f"{target} {label}"] = statistics.median(ts)
    print(json.dumps({"served_round_ms": latency, "device": kind, "power": smi}))

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--kill-resume"]:
        sys.exit(_kill_resume_child(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--mesh-train"]:
        sys.exit(_mesh_train_child(Path(sys.argv[2])))
    sys.exit(main())
