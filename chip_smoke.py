#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught):

1. Device: the card's name, and `nvidia-smi`'s name and power limit.
2. Build: all five kernel libraries (`binary_matvec.cu`, `fused_mlp.cu`,
   `ssd_scan.cu`, `quant_matmul.cu`, `causal_conv.cu`) with nvcc, one per source, started
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
   The port-only `causal_conv` (the prefill conv, its bias and SiLU) on
   x|B|C read in place from a 10,576-wide bf16 in_proj product at 16 x
   4,096 and 64 x 512, on the vector route, within one bf16 ulp of its
   plain version at fp32 (plus 1e-6 for the sums' order).
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
   tensor cores (the bf16 route), and `causal_conv` once per layer of
   each prefill (its count set to 0 before each generate). The kernel route is
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
   prefill and at decode (capacity 1 at 4 tokens); a profile. Then
   qwen3-moe-30b-a3b at full width (30.5 B parameters, 48 layers, 128
   experts of d_ff 768, top 8) from the reference's bf16 serving copy
   (61.06 GB), drawn on the card a layer slice at a time
   (`base.tree_draw`): the init's peak within the tree's bytes plus its
   largest fp32 part plus 1 GB, beside the prefill's peak counted on
   `meta`; served in bf16 at 4 x 512 + 32 with the dropped shares; the
   fp32-compute prefill against forward (2e-2); the bf16 prefill against
   the fp32 one (MOE_BIG_BF16_RTOL of the largest |logit|, routings that
   differ counted); its W8 tree (30.6 GB) counted, not served. Every
   count must stay 0. (h) The vlm and audio modalities: qwen2-vl-2b (1.54 B
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
   subprocess that sees no card. (l) Dense serving split over a model
   axis of 2 (`parallel/tensor.py`): two `chip_smoke.py --tp-child`
   ranks on the one card in a gloo world (NCCL refuses two ranks on one
   GPU; the collectives go through host memory) under a (1, 2) mesh and
   the serving rules, each drawing the whole tree from the seed leaf by
   leaf and keeping its shards: qwen1.5-4b at full width through
   `Engine` at 4 x 512 + 32 in bf16 (heads and kv heads split, the cache
   by kv heads) and gemma-2b at 4 x 512 + 8 (one kv head: the cache by
   positions, the log-sum-exp decode, the tied head split by vocab),
   each rank's parameter and cache bytes, prefill and decode times and
   fallbacks; then this process runs the same weights unmeshed: the
   bf16 prefill's last logits within 0.05 of the largest |logit|, the
   split fp32 greedy tokens at 4 x 64 + 16 against a teacher-forced
   fp32 forward; and qwen1.5-4b at 4 layers in fp32 (TF32 off), prefill
   and 8 greedy steps split against unmeshed within 1e-5 of the largest
   |logit|, tokens equal. Every count, the ranks' too, must stay 0. (m)
   Dense training split over a (2, 2) (data, model) mesh
   (`parallel/{tensor,fsdp}.py`, `train/step.py`): four `chip_smoke.py
   --tp-train-child` ranks on the one card in a gloo world under the
   trainer's rules, each `trainer.run` drawing the whole state from the
   seed leaf by leaf and keeping its shards (heads, ffn and the tied
   vocab over "model", every fsdp dim over "data"; gemma's one kv head
   whole, its gradient summed over "model"): gemma-2b as published, 2
   steps of 4 x 512 in 2 microbatches with remat in bf16, and cut to 4
   layers in fp32 (TF32 off), each rank's state bytes, peak memory, step
   walls, losses, grad norms and fallbacks; then this process runs the
   same steps unmeshed: bf16 losses and grad norms within the stated
   relative bounds, fp32 losses and grad norms within 1e-5 relative and
   every rank's parameter shards within 1e-5 of the largest |p| of the
   spec's slice of the unmeshed result where |g| stayed above 1e-6.
   Every count, the ranks' too, must stay 0. (n) The ssm and hybrid
   families served split over a model axis of 2
   (`parallel/tensor.py`, `layers/mamba2.py`): two `chip_smoke.py
   --tp-ssm-child` ranks on the one card in a gloo world under a (1, 2)
   mesh and the serving rules, each drawing the whole tree from the seed
   leaf by leaf and keeping its shards (every Mamba2 mixer by heads, 40
   of 80 a rank; the vocab; zamba2's shared block as the dense layers,
   its KV cache by kv heads): mamba2-2.7b and zamba2-2.7b at full width
   cut to 8 and 12 layers, through `Engine` at 4 x 512 + 32 in bf16,
   each rank's measured generate launching `ssd_scan` once a mixer (8,
   12), all on the
   tensor cores, and no other kernel; each rank's parameter and cache
   bytes, prefill and decode times; then this process runs the same
   weights unmeshed: layer 0's split mixer within 4 bf16 ulps, the last
   prefill logits within the larger of 0.05 and 3 x the unmeshed kernel
   route's distance from the plain route (the stack of random layers
   grows one rounding a layer), the ranks' logits and tokens bitwise
   equal; mamba2 at 4 layers and zamba2 at 6 in fp32 (TF32 off),
   prefill and 8 greedy steps within 1e-5 of the largest |logit| of
   unmeshed, tokens equal; and `ssd_scan` at a rank's shape (40 heads)
   against its plain version, timed beside its bound. The ranks'
   launches join the `kernels` line's. (o) The ssm and hybrid families
   trained split over a (2, 2) (data, model) mesh: four `chip_smoke.py
   --tp-ssm-train-child` ranks, mamba2-2.7b at full width cut to 2
   layers and zamba2-2.7b to 6, 2 steps of 4 x 512 in bf16, and at 2
   and 6 layers in fp32, held to unmeshed and to witnesses of the
   split's roundings; the shared B, C and per-head copies bitwise equal.
   (p) The MoE family split over the model axis (expert
   parallelism, `layers/moe.py`): two `chip_smoke.py --tp-moe-child`
   ranks serve granite-moe-1b-a400m at full width cut to 12 of its 24
   layers (16 of its 32 experts a rank, heads and kv heads split, the
   vocab whole) at 4 x 512 + 32
   in bf16 through `Engine`, then the prefill and 8 greedy steps in
   bf16 and in fp32; four `chip_smoke.py --tp-moe-train-child` ranks
   train it on a (2, 2) mesh at full width (2 layers in bf16, 2 and 4 in
   fp32); this process runs the same weights unmeshed: fp32 logits
   within 1e-5 of the largest |logit| with the same routings and drops,
   bf16 within the larger of 0.05 and 3 x a witness of the split's
   roundings (the routings that differ counted), the training steps as
   in (o), and the router's copies on the model ranks bitwise equal
   after each step. Every count, the ranks' too, must stay 0. (q) W8
   checkpoints split over the model axis with the batch split over
   "data", last (`parallel/tensor.py`, `serve/engine.py`): four
   `chip_smoke.py --w8-dp-child` ranks under a (2, 2) (data, model) mesh
   and the serving rules, each quantizing the seeded tree whole leaf by
   leaf and keeping its shards of `q` and `s`, serve 4 x 512 + 32
   through `Engine`, 2 rows a rank, the tokens gathered over "data":
   qwen1.5-4b W8 at 6 layers in bf16 and 4 in fp32, mamba2-2.7b W8 at 8
   in bf16 (ssd_scan once a mixer on a rank's 40 heads, on the tensor
   cores) and 4 in fp32, granite-moe-1b-a400m at 4 in fp32; this
   process serves the same weights unmeshed: each rank's logits on its
   rows within the larger of 0.05 and 3 x a witness in bf16, within 1e-5
   in fp32 with the greedy tokens equal, granite's routings and dropped
   pairs equal, and every rank's tokens bitwise equal. The ranks'
   ssd_scan launches join the `kernels` line's. (r) Sequence parallelism
   between layers, last (`parallel/tensor.py` `gather_seq`,
   `scatter_seq`): three `chip_smoke.py --sp-child` ranks under a (1, 3)
   mesh, qwen1.5-4b at full width cut to 6 layers, whose 20 heads, 20 kv
   heads and 151,936-entry vocab stay whole under 3 and whose ffn
   splits: the hidden state holds a third of the positions between
   layers and attention splits the query sequence. bf16 through `Engine`
   at 4 x 510 + 32 and at 1 x 3,072 + 8 through flash (1,024 queries a
   rank), each rank's hidden bytes between layers, collectives by kind
   and peak bytes; fp32 at 4 layers, prefill and 8 greedy steps; fp32
   training at 2 layers, 2 steps of 4 x 510; this process runs the same
   unmeshed: bf16 logits within the larger of 0.05 and 3 x a witness of
   the split's roundings, fp32 within 1e-5 with the tokens equal, the
   training's losses, grad norms and parameters as in (m). Every count,
   the ranks' too, must stay 0.
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

import contextlib
import functools
import json
import math
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
    "causal_conv": "src/repro_torch/kernels/causal_conv/csrc/causal_conv.cu",
}
# the TPU kernel each kernel ports; None for a kernel of the port alone
REPLACES = {
    "binary_matmul_planes": "src/repro/kernels/binary_matvec/binary_matvec.py:198",
    "binary_forward_planes": "src/repro/kernels/binary_matvec/binary_matvec.py:302",
    "binary_matmul": "src/repro/kernels/binary_matvec/binary_matvec.py:77",
    "binary_matmul_packed": "src/repro/kernels/binary_matvec/binary_matvec.py:134",
    "fused_mlp_predict": "src/repro/kernels/fused_mlp/fused_mlp.py:34",
    "quant_matmul": "src/repro/kernels/quant_matmul/quant_matmul.py:46",
    "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:73",
    "causal_conv": None,
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
# The prefill conv's (rows, length): the benchmark's largest calls, the
# long cell's and the short cell's.
CONV_SHAPES = {"16x4096": (16, 4096), "64x512": (64, 512)}
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
# 32 experts of d_ff 512, top 8), fp32 at 4 x 512 + 32; then qwen3-moe-30b-a3b
# from its bf16 serving copy (below). A decode step's capacity (1 at T = 4) is not a prefill's,
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
MOE_ARCH, MOE_BIG = "granite-moe-1b-a400m", "qwen3-moe-30b-a3b"
MOE_PARAMS = {"granite-moe-1b-a400m": 1_334_628_352, "qwen3-moe-30b-a3b": 30_532_110_336}
MOE_HOST_RTOL, MOE_BF16_RTOL = 1e-3, 0.15
# qwen3-moe-30b-a3b (phase 4(g), part (b)): the reference's bf16 serving copy
# (`base.serving_copy`: fp32 leaves of two dims or more in bf16, 61.06 GB),
# drawn on the card by `base.tree_draw` a layer slice at a time, so the
# init's peak stays below the tree's bytes + its largest fp32 part (the
# 151,936 x 2,048 embedding, 1.245 GB) + MOE_BIG_INIT_SLACK. Served in bf16
# at 4 x 512 + 32; in fp32 compute on the same bf16 weights prefill is held
# against forward (PREFILL_TOL), and the bf16 prefill's last logits against
# the fp32 one's within MOE_BIG_BF16_RTOL of the largest |logit|. That bound
# was fixed before the first card reading from CPU readings of
# `scripts/moe_bf16_gap.py` at 4 x 512: 0.0075-0.0305 at the smoke size
# over 9 seeds; at the full width cut to 2 layers 0.0058 and 0.0268, to 4
# layers 0.0055-0.0122 over 3 seeds (~5% of the (token, layer) routings
# flipped). 48 layers may flip more, so the MoE family's bf16 bound,
# MOE_BF16_RTOL: five times the worst CPU reading.
MOE_BIG_INIT_SLACK, MOE_BIG_BF16_RTOL = 1e9, MOE_BF16_RTOL
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
# Phase 4(l), dense serving split over a model axis of 2 (`parallel/tensor.py`):
# two ranks on the one card, a gloo world (NCCL refuses two ranks on one GPU,
# so every collective goes through host memory) and a (1, 2) cuda mesh under
# the serving rules, each rank a `chip_smoke.py --tp-child` process that draws
# the whole tree from the seed leaf by leaf and keeps its shards. (a)
# qwen1.5-4b at full width, cut to TP_SERVED_LAYERS of its 40 layers (to
# keep the script inside its time once phases 4(o) and 4(p) joined it), 4 x 512 + 32
# in bf16 through `Engine`: heads and
# kv heads split, the cache by kv heads; (b) gemma-2b at full width, 4 x 512 +
# 8: its one kv head does not divide 2, so the cache goes by positions, decode
# combines the ranks' partial attention by log-sum-exp, and the tied head is
# vocab-split; each held to the same weights unmeshed on the card: the bf16
# prefill's last logits within TP_BF16_RTOL of the largest |logit| (each
# rank's partial sums are rounded to bf16 before the all-reduce, one rounding
# more per split product than one process makes), and the split path's fp32
# greedy tokens at 4 x 64 + 16 against a teacher-forced fp32 forward, as the
# dense path holds its own. (c) qwen1.5-4b at full width and 4 layers in fp32
# with TF32 off, prefill and TP_FP32_STEPS greedy steps: every step's logits
# within TP_FP32_RTOL of the largest |logit| of the unmeshed run's, the
# tokens equal.
TP_RANKS, TP_TIMEOUT_S = 2, 600
TP_SERVED = (("a", DENSE_ARCH, DENSE_NEW), ("b", "gemma-2b", DENSE_OTHER_NEW))
TP_SERVED_LAYERS = {DENSE_ARCH: 6}       # else as published
TP_FP32_LAYERS, TP_FP32_STEPS = 4, 8
TP_BF16_RTOL, TP_FP32_RTOL = 0.05, 1e-5
# Phase 4(m), dense training under a model axis above 1 with FSDP over
# "data" (`parallel/{tensor,fsdp}.py`, `train/step.py`): four ranks on the
# one card, a gloo world and a (2, 2) (data, model) cuda mesh under the
# trainer's rules, each rank a `chip_smoke.py --tp-train-child` process
# whose `trainer.run` draws the whole state from the seed leaf by leaf and
# keeps its shards. gemma-2b as published, the train path's shape (4 x 512
# in 2 microbatches, remat full, AdamW), 2 steps: under model 2 its 8 heads,
# ffn and tied vocab split and its one kv head stays whole (so the k and v
# gradients are summed over "model"); under data 2 every fsdp dim (2048)
# splits. After the ranks have exited this process runs the same steps
# unmeshed from the same seed on the same batches. (a) bf16 compute at
# TP_TRAIN_BF16_LAYERS of its 18 layers (the full width; the depth cut to
# keep the script inside its time once phase 4(o) joined it): losses
# within TP_TRAIN_LOSS_RTOL and grad norms within TP_TRAIN_GNORM_RTOL
# relative. Each rank rounds its partial sums to bf16 before the
# all-reduce, one rounding more per split product than one process makes,
# as for serving; read at full depth on an H100 80GB HBM3 (700 W) at seed
# 0: losses 2.2e-6 (the mean over 2,048 tokens averages the roundings out),
# grad norms 5.4e-4, about a quarter of a bf16 ulp (2**-9); the bounds are
# ~45x and two bf16 ulps. (b) TP_TRAIN_FP32_LAYERS layers in fp32
# with TF32 off: losses and grad norms within TP_TRAIN_FP32_RTOL relative,
# and every rank's parameter shards after the 2 steps within
# TP_TRAIN_FP32_RTOL of the largest |parameter| of the spec's slice of the
# unmeshed result wherever |g| stayed above EPS_REGIME (100 x AdamW's eps:
# below it an element's step follows the fp32 summation order of its
# gradient), within 2 lr elsewhere.
TP_TRAIN_SHAPE, TP_TRAIN_RANKS, TP_TRAIN_STEPS = (4, 512, 2), (2, 2), 2
TP_TRAIN_FP32_LAYERS, TP_TRAIN_FP32_RTOL, EPS_REGIME = 4, 1e-5, 1e-6
TP_TRAIN_BF16_LAYERS = 4
TP_TRAIN_LOSS_RTOL, TP_TRAIN_GNORM_RTOL, TP_TRAIN_LR = 1e-4, 2 ** -8, 3e-4
# Phase 4(n), the ssm and hybrid families served split over a model axis of
# 2 (`parallel/tensor.py`, `layers/mamba2.py`): two ranks on the one card in
# a gloo world under a (1, 2) cuda mesh and the serving rules, each a
# `chip_smoke.py --tp-ssm-child` process that draws the whole tree from the
# seed leaf by leaf and keeps its shards: every Mamba2 mixer by heads (40 of
# the 80 a rank; the one group's B and C columns on both), the vocab split
# (50,280 and 32,000 divide 2), zamba2's shared block as the dense layers
# (16 of its 32 heads and kv heads, half its ffn; the KV cache by kv heads).
# (a) mamba2-2.7b and (b) zamba2-2.7b at full width, cut to
# TP_SSM_SERVED_LAYERS (8 of 64 mixers; 12 of 54, two shared sites: the
# depth cut to keep the script inside its time once phases 4(o) and 4(r)
# joined it, since a decode step's collectives through gloo grow with the
# layers), 4 x
# 512 + 32 in bf16 through `Engine` (use_kernel=True): each rank's prefill
# launches ssd_scan
# once a mixer on its 40 heads, all on the tensor cores; held to the same
# weights unmeshed on the card: layer 0's split mixer on the prompt within
# ROUTE_ULPS bf16 ulps of the layer's scale (each rank rounds its partial
# sums to bf16 before the all-reduce: one rounding more), and the ranks'
# logits and tokens bitwise equal. End to end that one rounding a layer
# grows through the stack of random layers: a CPU rehearsal at d_model 256
# over 64 mamba2 layers read the split's last logits 0.31 of the largest
# |logit| from unmeshed, where the kernel route against the plain route,
# another rounding a layer, read 0.20 (54 zamba2 layers: 0.039 and 0.033).
# So the last prefill logits are held within the larger of TP_BF16_RTOL and
# TP_SSM_WITNESS times that witness, read on the card from the same
# weights unmeshed. (c) fp32 with TF32 off, mamba2 cut to 4 layers and zamba2
# to 6 (one shared site), through the kernel route (its fp32 scalar
# kernel): prefill and TP_FP32_STEPS greedy steps within TP_FP32_RTOL of
# the largest |logit| of unmeshed, the tokens equal. (d) ssd_scan at a
# rank's shape (TP_SSM_SSD_HEADS heads, bf16, N 128) against its plain
# version (`_ssd_agrees`), timed beside its bound.
TP_SSM_SERVED = (("a", "mamba2-2.7b"), ("b", HYBRID_ARCH))
TP_SSM_SERVED_LAYERS = {"mamba2-2.7b": 8, HYBRID_ARCH: 12}
TP_SSM_FP32_LAYERS = {"mamba2-2.7b": 4, HYBRID_ARCH: 6}
TP_SSM_SSD_HEADS = 40
TP_SSM_WITNESS = 3.0
# Phase 4(o), the ssm and hybrid families trained under a model axis above 1
# with FSDP over "data" (`layers/mamba2.py` `sum_partial_grads`,
# `parallel/{tensor,fsdp}.py`, `train/step.py`): four ranks on the one card,
# a gloo world and a (2, 2) (data, model) cuda mesh under the trainer's
# rules, each a `chip_smoke.py --tp-ssm-train-child` process whose
# `trainer.run` draws the whole state from the seed leaf by leaf and keeps
# its shards: every Mamba2 mixer by heads (40 of mamba2's 80 a rank, the one
# group's B and C on both model ranks, its gradient summed over them once a
# step, as are the whole per-head vectors'), in_proj's and out_proj's d
# rows, the embedding and head over "data", both vocabs (50,280, 32,000)
# and zamba2's shared block split over "model" as the dense layers. The
# train path's shape (4 x 512 in 2 microbatches, remat full, AdamW), 2
# steps; training takes the SSD's chunked plain route (no kernel has a
# backward, in either package), so every kernel count, the ranks' too,
# must stay 0. After the ranks have exited this process runs the same
# steps unmeshed from the same seed on the same batches. (a) mamba2-2.7b
# at full width cut to 2 of its 64 mixers and (b) zamba2-2.7b at full
# width cut to 6 mixers (1 shared site; the depths cut to keep the script
# inside its time once phases 4(p) and 4(r) joined it), bf16: losses and
# grad norms within the larger of TP_TRAIN_LOSS_RTOL / TP_TRAIN_GNORM_RTOL
# and TP_SSM_WITNESS x a witness,
# read in this run from the same weights unmeshed with the roundings the
# split adds (`_one_rounding_more`: out_proj's contraction, in_proj's
# columns and the head's vocab each in two halves, as the two model ranks
# take them: one rounding more a layer in the forward, one in xin's
# gradient, one in the head's), and every rank's losses equal. A CPU
# rehearsal at d_model 256 over 64 mamba2 layers (bf16, the same shape
# and steps) read the (2, 2) split 1.22e-3 of the loss and 2.08e-2 of the
# grad norm from unmeshed, at step 2 (above both bounds: Adam's first step
# is about lr x sign(g), so every element whose gradient a rounding moves
# across 0 moves by 2 lr), (1, 2) 1.14e-3 and (2, 1) 8.3e-5: the model
# split's roundings, not the data split's; the witness read 4.9e-4 and
# 1.7e-2, out_proj's halves alone 2.2e-4 and 1.5e-2. zamba2 at 12 layers
# read 3.0e-5 and 1.4e-3, inside the plain bounds. (c) fp32 with TF32 off,
# mamba2 at TP_SSM_TRAIN_CASES' depth and zamba2 at 6 (one shared site): as
# `[4 tp train path]` (b), losses and grad norms within
# TP_TRAIN_FP32_RTOL relative and every rank's parameter shards within the
# larger of TP_TRAIN_FP32_RTOL and TP_SSM_WITNESS x a witness of the largest
# |p| where |g| stayed above EPS_REGIME, within 2 lr elsewhere. The witness
# is the same steps unmeshed in the split's summation orders
# (`_one_rounding_more`, each microbatch's rows in two halves as the data
# ranks sum them): Adam's second step, where its first moment nearly
# cancels, turns the last bits of a gradient into 1e-5 of the largest
# parameter here. On an H100 80GB HBM3 (700 W) the split read 9.7e-6 and
# 1.05e-5 against the dense bound of 1e-5, unmeshed runs in other fp32
# summation orders 7.6e-6 to 1.2e-5 and 1.4e-5 to 2.0e-5 from the plain
# one, so that bound holds no split to fp32 here; the losses and grad
# norms stay within 1e-5. And the copies that ranks share bitwise equal:
# the B and C columns of in_proj and channels of the conv on the two
# model ranks of each data coordinate, the per-head vectors on all four.
TP_SSM_TRAIN_CASES = {"a": ("mamba2-2.7b", 2, "bfloat16"), "b": (HYBRID_ARCH, 6, "bfloat16"),
                      "ca": ("mamba2-2.7b", 2, "float32"), "cb": (HYBRID_ARCH, 6, "float32")}
TP_SSM_TRAIN_MEMORY = 0.225      # of the card a rank may take (4 x 17.8 GiB of 79.2)
# Phase 4(p), the MoE family served and trained under a model axis above 1:
# expert parallelism (`layers/moe.py`, `parallel/{tensor,fsdp}.py`). Every
# rank of a model group routes all of its data shard's tokens from the
# replicated input, so the capacity and the kept pairs are the unmeshed
# layer's; it runs its own experts' rows and the partial outputs are summed
# over the group. granite-moe-1b-a400m as published: 16 of its 32 experts a
# rank, its 16 heads and 8 kv heads split (the KV cache by kv heads), its
# 49,155-entry tied vocab whole (a recorded fallback). Serving: two
# `chip_smoke.py --tp-moe-child` ranks on the one card in a gloo world
# under a (1, 2) cuda mesh and the serving rules, each drawing the whole
# tree from the seed leaf by leaf and keeping its shards: (a)
# TP_MOE_SERVED_LAYERS of its 24 layers (the full width; the depth cut to
# keep the script inside its time once phase 4(r) joined it) in
# bf16 through `Engine` at 4 x 512 + 32, then the prefill and
# TP_MOE_STEPS greedy decode steps with their logits, routings and the
# share of routed pairs dropped (capacity 640 at prefill, 1 at decode); (b)
# the same in fp32 with TF32 off. This process then runs the same weights
# unmeshed, decoding the split's tokens: in fp32 every step's logits within
# TP_FP32_RTOL of the largest |logit|, the greedy tokens, the routings and
# the dropped shares equal (the dispatch is the same); in bf16 within the
# larger of TP_BF16_RTOL and TP_MOE_WITNESS times a witness, the same
# weights unmeshed with the roundings the split adds
# (`_moe_split_roundings`: attention's output contraction and the experts
# in two halves, each rounded and then added, as the two ranks take them),
# and the routings that differ counted (a near-tie in the router may flip
# under other roundings). Training: four `chip_smoke.py --tp-moe-train-child`
# ranks under a (2, 2) (data, model) cuda mesh and the trainer's rules,
# `trainer.run` at the train path's shape (4 x 512 in 2 microbatches,
# remat full, AdamW, 2 steps): the experts over "model", every d over
# "data" (the router's too). (a) bf16 at TP_MOE_TRAIN_CASES' depth (the
# full width; the depth cut to keep the script inside its time): losses
# and grad norms within the larger of the dense bounds and TP_MOE_WITNESS
# x the witness's distance from unmeshed; (ca), (cb) fp32 (TF32 off) at 2
# and 4 layers: losses and grad norms within TP_TRAIN_FP32_RTOL, every
# rank's shards within the larger of TP_TRAIN_FP32_RTOL and TP_MOE_WITNESS
# x the witness's distance of the largest |p| where |g| stayed above
# EPS_REGIME, within 2 lr elsewhere (the witness keeps the microbatches
# whole: a MoE layer's capacity is its global microbatch's, so halves
# would drop other pairs). The router, whole over "model", must be bitwise
# equal on the two model ranks of each data coordinate after each step.
# The MoE path reaches no kernel, as the reference's reaches no Pallas
# kernel: every count, the ranks' too, must stay 0.
TP_MOE_STEPS, TP_MOE_WITNESS = 8, 3.0
TP_MOE_SERVED_LAYERS = 12        # of 24, for the script's time
TP_MOE_TRAIN_CASES = {"a": (MOE_ARCH, 2, "bfloat16"), "ca": (MOE_ARCH, 2, "float32"),
                      "cb": (MOE_ARCH, 4, "float32")}
TP_MOE_TRAIN_MEMORY = 0.2        # of the card a rank may take
# Phase 4(q), last: W8 checkpoints served under a model axis above 1
# (`parallel/tensor.py`, ROADMAP.md A.7e) with the batch split over "data"
# (`serve/engine.py`): four ranks on the one card in a gloo world under a
# (2, 2) (data, model) cuda mesh and the serving rules, each a
# `chip_smoke.py --w8-dp-child` process that draws the whole tree from the
# seed leaf by leaf, quantizes each matmul leaf whole
# (`quantize_params_for_serving(..., min_size=0)`, as `launch.serve --w8`:
# the scales are the unmeshed quantization's, bit for bit) and keeps its
# shards of `q` and `s`. Every rank is handed the 4 x 512 prompts and
# serves its 2 rows (its data coordinate's) through `Engine` with 32 new
# tokens, gathered over "data". This process then serves the same weights
# unmeshed, and each rank's logits are held on its rows. (a) qwen1.5-4b W8
# at full width and TP_SERVED_LAYERS' depth in bf16: the prefill's last
# logits within the larger of TP_BF16_RTOL and W8_DP_WITNESS x a witness
# (the same W8 weights unmeshed with the split's roundings,
# `_dense_split_roundings`: attention's output contraction and the MLP's
# down projection in two halves, each rounded and then added, as the two
# model ranks take them); (af) the same at 4 layers in fp32 (TF32 off):
# the prefill and TP_FP32_STEPS steps within TP_FP32_RTOL of the largest
# |logit|, the greedy tokens equal. (b) mamba2-2.7b W8 at 8 layers in
# bf16, the segmented `in_proj`'s `q` and `s` by heads: each rank's
# prefill launches ssd_scan once a mixer on its 40 heads and 2 rows, all
# on the tensor cores, and no other kernel; the logits within the larger of
# TP_BF16_RTOL and W8_DP_WITNESS x the unmeshed kernel route's distance
# from the plain route (as 4(n)); (bf) at 4 layers in fp32 as (af). (c)
# granite-moe-1b-a400m fp32 at 4 layers (W8 MoE is refused): each MoE
# layer's routing of every token and the pairs each call drops, summed
# over the data ranks, equal to unmeshed (the capacity and the experts'
# queues are the global batch's), the greedy tokens equal. Every rank must
# return the same tokens, bitwise.
W8_DP_RANKS = (2, 2)
W8_DP_CASES = {"a": (DENSE_ARCH, TP_SERVED_LAYERS[DENSE_ARCH], "bfloat16", True),
               "af": (DENSE_ARCH, 4, "float32", True),
               "b": ("mamba2-2.7b", 8, "bfloat16", True),
               "bf": ("mamba2-2.7b", 4, "float32", True),
               "c": (MOE_ARCH, 4, "float32", False)}
W8_DP_WITNESS = 3.0
# Phase 4(r), last: sequence parallelism between layers (`parallel/tensor.py`
# `gather_seq`, `scatter_seq`, `seq_range`; ROADMAP.md A item 4): three ranks
# on the one card in a gloo world under a (1, 3) cuda mesh and the serving
# rules (training: the trainer's), each a `chip_smoke.py --sp-child` process
# that draws the whole tree from the seed leaf by leaf and keeps its shards.
# qwen1.5-4b at full width cut to SP_LAYERS of its 40 layers: its 20 heads,
# 20 kv heads and 151,936-entry vocab stay whole under 3 and its ffn of
# 6,912 splits, so the hidden state holds a rank's third of the positions
# between layers, attention projects q, k and v from them, gathers k and v
# and attends with its queries under an offset causal mask, the MLP gathers
# and reduce-scatters, and the whole vocab's head runs on a rank's
# positions: on one card, the path of the dry run's 16-way cells whose
# heads stay whole. (a) bf16 through `Engine` at 4 x 510 + 32 and (b) at
# 1 x 3,072 + 8, whose prefill takes flash on 1,024 queries a rank; each
# rank prints its hidden bytes between layers, its prefill's collectives
# by kind (counted by `launch.cost.Counter`) and its peak bytes. This
# process runs the same weights unmeshed: the prefill's last logits within
# the larger of TP_BF16_RTOL and SP_WITNESS x a witness (the same weights
# unmeshed with the MLP's down projection in three parts, each rounded and
# then added, as the three ranks take it), the ranks' logits and tokens
# bitwise equal. (c) fp32 (TF32 off) at TP_FP32_LAYERS: the prefill at
# 4 x 510 and TP_FP32_STEPS greedy steps within TP_FP32_RTOL of the
# largest |logit| of unmeshed, the tokens equal. (d) fp32 training at
# SP_TRAIN_LAYERS, TP_TRAIN_STEPS steps of SP_TRAIN_SHAPE: losses and grad
# norms within TP_TRAIN_FP32_RTOL relative of unmeshed, every rank's
# parameters within TP_TRAIN_FP32_RTOL of the largest |p| where |g|
# stayed above EPS_REGIME, within 2 lr elsewhere.
SP_RANKS, SP_LAYERS, SP_WITNESS = 3, 6, 3.0
SP_SERVED = {"a": (DENSE_BATCH, 510, 32), "b": (1, 3072, 8)}
SP_TRAIN_LAYERS, SP_TRAIN_SHAPE = 2, (4, 510, 2)


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


def _ssd_args(rng, dev, dtype, n: int = 128, h: int = 80, b: int = LM_BATCH):
    """Seeded SSD inputs at mamba2-2.7b's width (H=80, P=64, G=1, N=128;
    zamba2-2.7b's is the same with N=64; a rank of a model axis of 2 holds
    h=40 heads), batch b x 512 tokens (a rank of a data axis of 2 holds
    b=2 rows), distributed as the JAX package's kernel tests."""
    import numpy as np
    import torch
    l, p, g = LM_PROMPT, 64, 1

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


def _conv_args(dev, b: int, s: int):
    """Seeded causal-conv operands at mamba2-2.7b's widths: x|B|C (5,376
    channels) as the narrow view of a (b, s, 10,576) bf16 product at
    column 5,120, where the mixer reads it from in_proj's, and the conv's
    fp32 weight (4, 5,376) and bias."""
    import torch
    from repro_torch import configs
    cfg = configs.get_config(LM_ARCH)
    di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    g = torch.Generator(device=dev).manual_seed(SEED)
    zx = torch.randn((b, s, 2 * di + 2 * gn + cfg.ssm_heads), generator=g, device=dev)
    zx = zx.to(torch.bfloat16)
    w = torch.randn((cfg.conv_width, cfg.conv_dim), generator=g, device=dev) / 2
    bias = torch.rand((cfg.conv_dim,), generator=g, device=dev) - 0.5
    return zx.narrow(-1, di, cfg.conv_dim), w, bias


def _conv_agrees(got, want) -> bool:
    """bf16 within one bf16 ulp of the larger magnitude of the kernel's and
    the fp32 plain version's (the kernel rounds its fp32 sum once), plus
    1e-6 for the sums' order."""
    import torch
    g = got.float()
    ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(g.abs(), want.abs())
    return bool(((g - want).abs() <= ulp + 1e-6).all())


def _composed_conv(xbc, w, bias):
    """The prefill conv as the mixer composes it off the card: the cat of
    x|B|C (a packed copy of the view), then the plain version."""
    from repro_torch.kernels.causal_conv import ref
    return ref.causal_conv(xbc.contiguous(), w, bias)


def _conv_count_swap(cfg, rows: int, seq: int) -> tuple[float, float]:
    """What a counted mamba2 prefill on the card adds to the same step's
    count on `meta`, (FLOPs, bytes): on the card each layer's conv kernel
    records its formula (`causal_conv` `work`) where `meta` counts the
    composed conv's aten ops (the cat of x|B|C, then `ref.causal_conv`),
    counted here once at one layer's shapes."""
    import torch
    from repro_torch.kernels.causal_conv import ops as cops
    from repro_torch.kernels.causal_conv import ref as cref
    from repro_torch.launch import cost
    from repro_torch.models import api
    di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    zx = torch.empty((rows, seq, 2 * di + 2 * gn + cfg.ssm_heads), dtype=cfg.cdtype(),
                     device="meta")
    leaves = api.abstract_params(cfg)["layers"]["mixer"]
    w = torch.empty((cfg.conv_width, cfg.conv_dim), dtype=leaves["conv_w"].dtype, device="meta")
    bias = torch.empty((cfg.conv_dim,), dtype=leaves["conv_b"].dtype, device="meta")
    parts = torch.split(zx, [di, di, gn, gn, cfg.ssm_heads], dim=-1)
    with cost.Counter() as c:
        cref.causal_conv(torch.cat(parts[1:4], dim=-1), w, bias)
    flops, bytes_ = cops.work(rows, seq, cfg.conv_dim, cfg.conv_width, zx.element_size())
    return cfg.n_layers * (flops - c.flops), cfg.n_layers * (bytes_ - c.bytes)


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
            if counts["causal_conv"] != cfg.n_layers:
                raise AssertionError(f"{ckpt} {kind}: causal_conv launched "
                                     f"{counts['causal_conv']} times in one prefill, want "
                                     f"{cfg.n_layers}")
            launches["ssd_scan"] = counts["ssd_scan"]
            launches["ssd_scan mma"] = mma
            launches["causal_conv"] = counts["causal_conv"]
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
    teacher-forced `api.forward` over prompt + generation (`_forced`).
    The forward's position P-1 is the prefill's last position, so
    `prefill`'s logits are held to it within the reference's PREFILL_TOL.
    The prompt's modality `extras` reach the engine and the prefill."""
    import dataclasses
    import torch
    from repro_torch.models import api, base
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    B, P = prompts.shape
    extras = extras or {}
    gen = Engine(cfg32, params, ServeConfig(max_len=P + TF_NEW + 8, max_new_tokens=TF_NEW),
                 device=dev).generate(prompts, extras)
    rec, logits = _forced(cfg32, params, prompts, gen, dev, extras)
    with torch.inference_mode():
        cache = base.tree_init(api.abstract_cache(cfg32, B, P), torch.Generator(device=dev), dev)
        last, _ = api.prefill(cfg32, params, {"tokens": torch.as_tensor(
            prompts, device=dev).long(), **_on(extras, dev)}, cache)
    prefill_err = (last - logits[:, 0]).abs().max().item()
    rec["prefill_vs_forward_max_abs"] = prefill_err
    print(f"[4 {tag}] {cfg.name} fp32 teacher forcing {B}x{P} + {TF_NEW}: "
          f"{rec['tokens'] - rec['differ']} of {rec['tokens']} greedy tokens equal the forward's "
          f"argmax, {rec['excused']} excused (top-2 margin < {rec['margin_bound']:.3g}); "
          f"prefill vs forward max |diff| {prefill_err:.3g} (bound {PREFILL_TOL})")
    if rec["differ"] != rec["excused"]:
        raise AssertionError(f"{cfg.name}: engine tokens differ from teacher forcing where "
                             "the margin decides them")
    if not torch.allclose(last, logits[:, 0], rtol=PREFILL_TOL, atol=PREFILL_TOL):
        raise AssertionError(f"{cfg.name}: prefill's last logits differ from forward's")
    return rec


def _forced(cfg32, params, prompts, gen, dev, extras=None) -> tuple:
    """Greedy tokens `gen` (B, new) after `prompts` against the argmax of
    an fp32 teacher-forced `api.forward` over prompt + generation
    (position P+i-1 predicts token i). A token may differ only where the
    forward's top-2 margin is below TF_MARGIN_RTOL of the largest |logit|
    (a near tie that fp32 summation order can flip); such positions are
    counted. The forward gets the prompt's modality `extras` extended over
    the generated positions as `decode_step` supplies them
    (`_extend_extras`). Returns (record, the forward's (B, new, V) logits)."""
    import numpy as np
    import torch
    from repro_torch.models import api

    P, new = prompts.shape[1], gen.shape[1]
    with torch.inference_mode():
        seq = torch.as_tensor(np.concatenate([prompts, gen], axis=1), device=dev).long()
        logits = api.forward(cfg32, params, {"tokens": seq, **_on(
            _extend_extras(extras or {}, P, new), dev)})[0][:, P - 1:-1]      # (B, new, V)
    top2 = logits.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    bound = TF_MARGIN_RTOL * logits.abs().max()
    differ = logits.argmax(-1) != torch.as_tensor(gen, device=dev).long()
    excused = int((differ & (margin < bound)).sum())
    return ({"tokens": int(differ.numel()), "differ": int(differ.sum()), "excused": excused,
             "margin_bound": bound.item()}, logits)


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
        if (not counts.pop("ssd_scan") == mma == counts.pop("causal_conv") == cfg.n_layers
                or any(counts.values())):
            raise AssertionError(f"{ckpt}: want {cfg.n_layers} ssd_scan launches, all on the "
                                 f"tensor cores, {cfg.n_layers} of causal_conv and no other "
                                 "kernel in one generate")
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
    routed pairs dropped at prefill and at decode; a profile. Then (b)
    qwen3-moe-30b-a3b at full width from its bf16 serving copy
    (`_moe_big_path`). No TPU kernel: every count 0."""
    import dataclasses
    import gc
    import math
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
    def recorded(fn):
        with _moe_recorded() as seen:
            out = fn()
        return out, seen["ids"], float((~torch.cat(seen["keep"])).float().mean())

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

    big = _moe_big_path(dev, smi)
    counts = {name: w.launches for name, w in wrappers.items()}
    print(f"[4 moe path] launches {counts} (the MoE path reaches no TPU kernel)")
    if any(counts.values()):
        raise AssertionError("the MoE path launched a kernel")
    seconds = time.perf_counter() - t_phase
    print(f"[4 moe path] phase {seconds:.1f} s ({MOE_BIG} {big['phase_s']:.1f} s)")
    print(json.dumps({"moe_ms": runs, "moe_checks": checks, "moe_profile": trace,
                      MOE_BIG: big, "phase_s": seconds,
                      "device": torch.cuda.get_device_name(dev), "power": smi}))


def _tree_bytes_abstract(tree) -> int:
    """Bytes of an abstract tree's leaves."""
    from repro_torch.models import base
    return sum(math.prod(i.shape) * i.dtype.itemsize for _, i in base.tree_items(tree))


def _moe_big_counted(cfg, batch: int, prompt: int, new: int) -> dict:
    """The bf16 serving copy's bf16-compute prefill of batch x (prompt +
    new) tokens, a bound on the generate's step, and its fp32-compute
    forward of batch x prompt, counted on `meta` at world size 1
    (`launch/cost.py`): peak bytes (parameters included), FLOPs, bytes."""
    import dataclasses
    import torch
    from repro_torch.launch import cost, dryrun
    from repro_torch.models import api, base

    run = dryrun.build_step(cfg, base.ShapeConfig("chip", prompt + new, batch, "prefill"),
                            device="meta", variant={"serve_dtype": "bfloat16"})
    prefill = dryrun.count_step(run)
    params = base.tree_sds(base.serving_copy(api.abstract_params(cfg), torch.bfloat16))
    tokens = torch.empty((batch, prompt), dtype=torch.long, device="meta")
    with cost.Counter() as forward:
        api.forward(dataclasses.replace(cfg, compute_dtype="float32"), params,
                    {"tokens": tokens})
    return {k: {"peak_bytes": c.peak_bytes, "flops": c.flops, "bytes": c.bytes}
            for k, c in (("prefill_bf16", prefill), ("forward_fp32", forward))}


def _moe_bf16_gap(cfg, params, tokens, dev) -> dict:
    """Prefill `tokens` in fp32 and in bf16 compute on the same weights:
    the bf16 last logits' `_rel_max` against the fp32 ones, the (token,
    layer) routings that differ, each run's share of routed pairs dropped,
    and the fp32 last logits."""
    import dataclasses
    import torch
    from repro_torch.models import api, base

    B, P = tokens.shape
    last, ids, drop = {}, {}, {}
    with torch.inference_mode():
        for c in ("float32", "bfloat16"):
            cc = dataclasses.replace(cfg, compute_dtype=c)
            cache = base.tree_init(api.abstract_cache(cc, B, P), torch.Generator(device=dev), dev)
            with _moe_recorded() as seen:
                last[c] = api.prefill(cc, params, {"tokens": tokens}, cache)[0].float()
            del cache
            ids[c] = seen["ids"]
            drop[c] = float((~torch.cat(seen["keep"])).float().mean())
    flips = sum(int((a != b).any(-1).sum()) for a, b in zip(ids["bfloat16"], ids["float32"]))
    return {"rel_max": _rel_max(last["bfloat16"], last["float32"]), "routings_differ": flips,
            "routings": B * P * cfg.n_layers, "dropped": drop, "last_fp32": last["float32"]}


def _moe_big_path(dev, smi) -> dict:
    """Phase 4(g), part (b): qwen3-moe-30b-a3b at full width from the
    reference's bf16 serving copy, drawn on the card a layer slice at a
    time; served in bf16 at 4 x 512 + 32; the fp32-compute prefill
    against forward; the bf16 prefill against the fp32 one; its W8 tree
    counted (the reference's W8 MoE fails, so it is not served)."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.layers import moe
    from repro_torch.models import api, base
    from repro_torch.quantized import apply as qapply

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tag = "moe path"
    cfg = configs.get_config(MOE_BIG)
    abstract = api.abstract_params(cfg)
    n = base.count_params(abstract)
    if n != MOE_PARAMS[MOE_BIG]:
        raise AssertionError(f"{MOE_BIG}: {n} parameters, want {MOE_PARAMS[MOE_BIG]}")
    tree = base.serving_copy(abstract, torch.bfloat16)
    tree_bytes = _tree_bytes_abstract(tree)
    largest_part = max(4 * math.prod(i.shape[1:] if p[0] == base.STACKED else i.shape)
                       for p, i in base.tree_items(tree))
    B, P, new = DENSE_BATCH, DENSE_PROMPT, DENSE_NEW
    counted = _moe_big_counted(cfg, B, P, new)
    rec = {"params": n, "tree_bytes": tree_bytes, "largest_fp32_part": largest_part,
           "counted_meta": counted}
    print(f"[4 {tag}] (b) {MOE_BIG}: {n} parameters, {cfg.n_layers} layers, {cfg.n_experts} "
          f"experts of d_ff {cfg.d_ff}, top {cfg.experts_per_token}, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab}; bf16 serving copy {tree_bytes / 1e9:.3f} GB (fp32 "
          f"{4 * n / 1e9:.1f} GB fits no card), largest fp32 part {largest_part / 1e9:.3f} GB; "
          f"counted on meta (world size 1): bf16 prefill {B}x{P + new} peak "
          f"{counted['prefill_bf16']['peak_bytes'] / 1e9:.3f} GB, fp32-compute forward "
          f"{B}x{P} peak {counted['forward_fp32']['peak_bytes'] / 1e9:.3f} GB")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = base.tree_draw(tree, SEED, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated(dev) - before
    peak = torch.cuda.max_memory_allocated(dev) - before
    bound = tree_bytes + largest_part + MOE_BIG_INIT_SLACK
    rec.update(init_s=init_s, allocated=held, init_peak=peak, init_bound=bound)
    print(f"[4 {tag}] (b) {MOE_BIG} bf16 copy drawn a layer slice at a time: init "
          f"{init_s:.2f} s, {held / 1e9:.3f} GB allocated ({held} B; the tree {tree_bytes} B), "
          f"max_memory_allocated over the init {peak / 1e9:.3f} GB (bound {bound / 1e9:.3f}: "
          f"the tree + the largest fp32 part + {MOE_BIG_INIT_SLACK / 1e9:.0f} GB) ({smi})")
    if not tree_bytes <= held < tree_bytes + 1e8:
        raise AssertionError(f"{MOE_BIG}: {held} B allocated for a tree of {tree_bytes} B")
    if not peak <= bound:
        raise AssertionError(f"{MOE_BIG}: the init's peak {peak} B passed {bound} B")

    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab, size=(B, P)).astype(np.int32)
    with _moe_recorded() as seen:
        _dense_generate(cfg, params, prompts, 2, dev, "bf16 copy warm-up", tag=tag)
    prefill_keep = torch.cat(seen["keep"][:cfg.n_layers])
    decode_keep = torch.cat(seen["keep"][cfg.n_layers:])
    drops = {"prefill": float((~prefill_keep).float().mean()),
             "decode": float((~decode_keep).float().mean())}
    torch.cuda.reset_peak_memory_stats(dev)
    run = _dense_generate(cfg, params, prompts, new, dev, "bf16 copy", tag=tag)
    run["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    rec.update(generate=run, dropped=drops)
    print(f"[4 {tag}] (b) {MOE_BIG} bf16 generate {B}x{P} + {new}: prefill "
          f"{run['prefill_ms']:.1f} ms, decode {run['decode_ms_per_token']:.2f} ms/token (host "
          f"clock); max_memory_allocated {run['max_memory_allocated'] / 1e9:.3f} GB (counted "
          f"on meta {counted['prefill_bf16']['peak_bytes'] / 1e9:.3f}); routed pairs dropped: "
          f"{drops['prefill']:.4f} at prefill (capacity "
          f"{moe.capacity(B * P, cfg.experts_per_token, cfg.n_experts)}), {drops['decode']:.4f} "
          f"at decode (capacity {moe.capacity(B, cfg.experts_per_token, cfg.n_experts)})")

    toks = torch.as_tensor(prompts, device=dev).long()
    gap = _moe_bf16_gap(cfg, params, toks, dev)
    with torch.inference_mode():
        full = api.forward(dataclasses.replace(cfg, compute_dtype="float32"), params,
                           {"tokens": toks})[0][:, -1]
    err = (gap["last_fp32"] - full).abs().max().item()
    print(f"[4 {tag}] (b) {MOE_BIG} fp32-compute prefill {B}x{P} on the bf16 copy vs forward's "
          f"last position: max |diff| {err:.3g} (bound {PREFILL_TOL})")
    if not torch.allclose(gap["last_fp32"], full, rtol=PREFILL_TOL, atol=PREFILL_TOL):
        raise AssertionError(f"{MOE_BIG}: prefill's last logits differ from forward's")
    del full
    print(f"[4 {tag}] (b) {MOE_BIG} bf16 prefill vs fp32 prefill on the same weights: max |diff| "
          f"{gap['rel_max']:.4g} of the largest |logit| (bound {MOE_BIG_BF16_RTOL}); "
          f"{gap['routings_differ']} of {gap['routings']} (token, layer) routings differ; "
          f"dropped {gap['dropped']['float32']:.4f} (fp32) / {gap['dropped']['bfloat16']:.4f} "
          "(bf16)")
    if not gap["rel_max"] < MOE_BIG_BF16_RTOL:
        raise AssertionError(f"{MOE_BIG}: the bf16 prefill is not within {MOE_BIG_BF16_RTOL} "
                             "of the fp32 one")
    rec.update(prefill_vs_forward_max_abs=err,
               bf16_vs_fp32={k: v for k, v in gap.items() if k != "last_fp32"})
    del params, gap
    gc.collect()
    torch.cuda.empty_cache()
    w8_bytes = _tree_bytes_abstract(qapply.abstract_quantized_params(cfg))
    rec["w8_bytes"] = w8_bytes
    print(f"[4 {tag}] (b) {MOE_BIG} W8 tree {w8_bytes / 1e9:.2f} GB "
          "(abstract_quantized_params), not served: the reference's W8 MoE fails")
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


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


def _tp_prompts(vocab: int, batch: int, prompt: int):
    """The phase's prompts, the same in every process."""
    import numpy as np
    return np.random.default_rng(SEED + 1).integers(0, vocab, size=(batch, prompt)).astype(
        np.int32)


def _tp_config(arch: str, dtype: str, layers: int | None = None):
    import dataclasses
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get_config(arch), compute_dtype=dtype)
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def _device_name(dev) -> str:
    import torch
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def _tree_bytes(tree) -> int:
    from repro_torch.models import base
    return sum(t.numel() * t.element_size() for _, t in base.tree_items(tree))


def _tp_steps(cfg, params, cache, prompts, steps: int, dev, use_kernel: bool = False) -> dict:
    """Prefill and `steps` greedy decode steps: each step's logits and
    tokens (numpy)."""
    import numpy as np
    import torch
    from repro_torch.models import api
    B, P = prompts.shape
    logits, tokens = [], []
    with torch.inference_mode():
        out, cache = api.prefill(cfg, params, {"tokens": torch.as_tensor(
            prompts, device=dev).long()}, cache, use_kernel=use_kernel)
        pos = torch.full((B,), P, dtype=torch.int32, device=dev)
        for i in range(steps + 1):
            tok = torch.argmax(out, dim=-1)
            logits.append(out.float().cpu().numpy())
            tokens.append(tok.cpu().numpy())
            if i < steps:
                out, cache = api.decode_step(cfg, params, tok[:, None], pos, cache)
                pos = pos + 1
    return {"logits": np.stack(logits), "tokens": np.stack(tokens, axis=1)}


def _run_ranks(flag: str, n_ranks: int, root: Path, dev, what: str) -> list[dict]:
    """Run `chip_smoke.py FLAG RANK ROOT DEVICE` for every rank at once,
    each killed at TP_TIMEOUT_S; print rank 0's log indented; raise if a
    rank failed. Returns each rank's ROOT/rank<r>.json."""
    logs = [open(root / f"rank{r}.log", "w") for r in range(n_ranks)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), flag, str(r),
                               str(root), str(dev)], stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=TP_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    text = [(root / f"rank{r}.log").read_text() for r in range(n_ranks)]
    print("\n".join(f"    {line}" for line in text[0].splitlines()))
    if any(p.returncode for p in procs):
        for r in range(1, n_ranks):
            print(f"--- rank {r}:\n{text[r][-4000:]}", file=sys.stderr)
        raise AssertionError(f"the {what} ranks failed (exit codes "
                             f"{[p.returncode for p in procs]})")
    return [json.loads((root / f"rank{r}.json").read_text()) for r in range(n_ranks)]


def _tp_path(dev, wrappers, reset_launches, smi) -> None:
    """Phase 4(l): dense serving split over a model axis of 2 on the card
    (the constants' comment above `TP_RANKS`). Two `--tp-child` ranks run
    the split paths first, while this process holds nothing; then this
    process draws each model whole from the same seed, runs it unmeshed
    and holds the ranks' results to it. The dense path reaches no TPU
    kernel: every count, the ranks' too, must stay 0."""
    import gc
    import shutil
    import numpy as np
    import torch
    from repro_torch.models import api, base

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tag = "tp path"
    reset_launches()
    root = ROOT / "build" / "tp_path"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ranks = _run_ranks("--tp-child", TP_RANKS, root, dev, "tensor-parallel")
    arrays = [dict(np.load(root / f"rank{r}.npz")) for r in range(TP_RANKS)]
    for r, rec in enumerate(ranks):
        for label in rec["cases"]:
            c = rec["cases"][label]
            print(f"[4 {tag}] rank {r} ({label}) {c['arch']}: parameters "
                  f"{c['param_bytes'] / 1e9:.3f} GB, KV cache {c['cache_bytes'] / 1e9:.4f} GB "
                  f"({c['dtype']})")
    out = {"ranks": ranks}

    # (a), (b): the bf16 prefill's last logits; the fp32 greedy tokens
    # against a teacher-forced forward
    for label, arch, new in TP_SERVED:
        cfg = _tp_config(arch, "bfloat16", TP_SERVED_LAYERS.get(arch))
        prompts = _tp_prompts(cfg.vocab, DENSE_BATCH, DENSE_PROMPT)
        with torch.inference_mode():
            params = base.tree_init(api.abstract_params(cfg),
                                    torch.Generator(device=dev).manual_seed(SEED), dev)
            cache = base.tree_init(api.abstract_cache(cfg, DENSE_BATCH, DENSE_PROMPT),
                                   torch.Generator(device=dev), dev)
            want, _ = api.prefill(cfg, params, {"tokens": torch.as_tensor(
                prompts, device=dev).long()}, cache)
        want = want.float().cpu().numpy()
        scale = float(np.abs(want).max())
        errs = [float(np.abs(a[f"{label}/prefill"] - want).max()) for a in arrays]
        same = all(np.array_equal(a[f"{label}/prefill"], arrays[0][f"{label}/prefill"])
                   for a in arrays)
        print(f"[4 {tag}] ({label}) {arch} bf16 prefill {DENSE_BATCH}x{DENSE_PROMPT}, split "
              f"over 2 ranks vs unmeshed: last logits max |diff| "
              f"{', '.join(f'{e:.4g}' for e in errs)} (ranks 0, 1) of the largest |logit| "
              f"{scale:.4g}: {max(errs) / scale:.4g} (bound {TP_BF16_RTOL}); ranks bitwise "
              f"equal: {same}")
        if max(errs) > TP_BF16_RTOL * scale or not same:
            raise AssertionError(f"{arch}: the split prefill's logits differ from unmeshed")
        cfg32 = _tp_config(arch, "float32", TP_SERVED_LAYERS.get(arch))
        gen = arrays[0][f"{label}/tf_tokens"]
        if not all(np.array_equal(a[f"{label}/tf_tokens"], gen) for a in arrays):
            raise AssertionError(f"{arch}: the ranks' greedy tokens differ")
        rec, _ = _forced(cfg32, params, _tp_prompts(cfg.vocab, DENSE_BATCH, TF_PROMPT), gen,
                         dev)
        print(f"[4 {tag}] ({label}) {arch} split fp32 generate {DENSE_BATCH}x{TF_PROMPT} + "
              f"{TF_NEW}: {rec['tokens'] - rec['differ']} of {rec['tokens']} greedy tokens "
              f"equal the unmeshed teacher-forced forward's argmax, {rec['excused']} excused "
              f"(top-2 margin < {rec['margin_bound']:.3g})")
        if rec["differ"] != rec["excused"]:
            raise AssertionError(f"{arch}: split tokens differ from teacher forcing where "
                                 "the margin decides them")
        out[label] = {"prefill_max_abs": errs, "logit_scale": scale,
                      "teacher_forcing": rec}
        del params, cache
        gc.collect()
        torch.cuda.empty_cache()

    # (c) fp32, TF32 off, 4 layers: every step's logits
    cfg = _tp_config(DENSE_ARCH, "float32", TP_FP32_LAYERS)
    prompts = _tp_prompts(cfg.vocab, DENSE_BATCH, DENSE_PROMPT)
    with torch.inference_mode():
        params = base.tree_init(api.abstract_params(cfg),
                                torch.Generator(device=dev).manual_seed(SEED), dev)
        cache = base.tree_init(api.abstract_cache(cfg, DENSE_BATCH,
                                                  DENSE_PROMPT + TP_FP32_STEPS + 8),
                               torch.Generator(device=dev), dev)
    want = _tp_steps(cfg, params, cache, prompts, TP_FP32_STEPS, dev)
    scale = float(np.abs(want["logits"]).max())
    errs = [float(np.abs(a["c/logits"] - want["logits"]).max()) for a in arrays]
    equal = all(np.array_equal(a["c/tokens"], want["tokens"]) for a in arrays)
    print(f"[4 {tag}] (c) {DENSE_ARCH} {TP_FP32_LAYERS} layers fp32 (TF32 off) prefill "
          f"{DENSE_BATCH}x{DENSE_PROMPT} + {TP_FP32_STEPS} steps, split vs unmeshed: max |diff| "
          f"{', '.join(f'{e:.3g}' for e in errs)} (ranks 0, 1) of the largest |logit| "
          f"{scale:.4g}: {max(errs) / scale:.3g} (bound {TP_FP32_RTOL}); greedy tokens "
          f"{'equal' if equal else 'differ'}")
    if max(errs) > TP_FP32_RTOL * scale or not equal:
        raise AssertionError("the fp32 split path differs from the unmeshed path")
    out["c"] = {"max_abs": errs, "logit_scale": scale}
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()

    counts = {name: w.launches for name, w in wrappers.items()}
    children = [rec["launches"] for rec in ranks]
    print(f"[4 {tag}] launches {counts}, ranks {children} (the dense path reaches no TPU "
          f"kernel)")
    if any(counts.values()) or any(any(c.values()) for c in children):
        raise AssertionError("a kernel launched on the dense path")
    seconds = time.perf_counter() - t_phase
    shutil.rmtree(root, ignore_errors=True)
    print(f"[4 {tag}] phase {seconds:.1f} s")
    print(json.dumps({"tp": out, "phase_s": seconds, "device": _device_name(dev),
                      "power": smi}))


def _tp_shards(cfg, dev):
    """The whole tree drawn leaf by leaf from the seed, as `tree_init`
    draws it, each leaf cut to this rank's shard (under the active mesh)."""
    import torch
    from repro_torch.models import api, base
    from repro_torch.parallel import tensor
    gen = torch.Generator(device=dev).manual_seed(SEED)
    paths, leaves = [], []
    with torch.inference_mode():
        for path, info in base.tree_items(api.abstract_params(cfg)):
            whole = base.tree_init(base.tree_unflatten([path], [info]), gen, dev)
            (_, leaf), = base.tree_items(tensor.shard_params(cfg, whole))
            paths.append(path)
            leaves.append(leaf)
            del whole
    return base.tree_unflatten(paths, leaves)


def _tp_child(rank: int, root: Path, device: str) -> int:
    """`chip_smoke.py --tp-child RANK DIR DEVICE`, one of phase 4(l)'s two
    ranks, on the parent's DEVICE (both ranks on the one card): a gloo
    world over a `FileStore` in DIR, a (1, 2) mesh under the serving
    rules, the split paths of (a), (b) and (c) on this rank's shards;
    writes DIR/rank<RANK>.{json,npz}."""
    import gc
    import math
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import api, base
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tensor
    from repro_torch.serve.engine import Engine, ServeConfig

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lead = rank == 0
    dist.init_process_group("gloo", store=dist.FileStore(str(root / "store"), TP_RANKS),
                            rank=rank, world_size=TP_RANKS)
    rec, arrays = {"cases": {}}, {}
    try:
        mesh = make_mesh_compat((1, TP_RANKS), ("data", "model"), device=dev.type)
        group = mesh.group("model")
        probe = {}
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.full((3,), rank + 1.0, dtype=dtype, device=dev)
            probe[str(dtype)] = (tensor.all_reduce(x, group).tolist(),
                                 tensor.all_reduce(x, group, dist.ReduceOp.MAX).tolist(),
                                 tensor.all_gather(x, group).tolist())
        if lead:
            print(f"[4 tp path] {mesh}, backend {dist.get_backend()}, world "
                  f"{dist.get_world_size()}, both ranks on {_device_name(dev)}; "
                  f"gloo on cuda tensors (sum, max, gather of rank + 1): {probe}")

        for label, arch, new in TP_SERVED:
            cfg = _tp_config(arch, "bfloat16", TP_SERVED_LAYERS.get(arch))
            with shd.use_mesh(mesh, tensor.serving_rules()):
                t0 = time.perf_counter()
                params = _tp_shards(cfg, dev)
                fallbacks = shd.fallbacks()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                init_s = time.perf_counter() - t0
                prompts = _tp_prompts(cfg.vocab, DENSE_BATCH, DENSE_PROMPT)
                sc = ServeConfig(max_len=DENSE_PROMPT + new + 8, max_new_tokens=new)
                engine = Engine(cfg, params, sc, device=dev)
                engine.generate(prompts[:, :16])                 # warm-up
                t0 = time.perf_counter()
                gen = engine.generate(prompts)
                wall = time.perf_counter() - t0
                if gen.shape != (DENSE_BATCH, new) or gen.min() < 0 or gen.max() >= cfg.vocab:
                    raise AssertionError(f"{arch}: bad tokens, shape {gen.shape}")
                cache_info = tensor.local_tree(cfg, api.abstract_cache(
                    cfg, DENSE_BATCH, tensor.cache_len(cfg, sc.max_len)))
                with torch.inference_mode():
                    cache = base.tree_init(cache_info, torch.Generator(device=dev), dev)
                    last, _ = api.prefill(cfg, engine.params, {"tokens": torch.as_tensor(
                        prompts, device=dev).long()}, cache)
                arrays[f"{label}/prefill"] = last.float().cpu().numpy()
                del cache
                cfg32 = _tp_config(arch, "float32", TP_SERVED_LAYERS.get(arch))
                tf = Engine(cfg32, params, ServeConfig(max_len=TF_PROMPT + TF_NEW + 8,
                                                       max_new_tokens=TF_NEW), device=dev)
                arrays[f"{label}/tf_tokens"] = tf.generate(
                    _tp_prompts(cfg.vocab, DENSE_BATCH, TF_PROMPT))
                c = {"arch": arch, "dtype": cfg.compute_dtype, "init_s": init_s,
                     "param_bytes": _tree_bytes(params),
                     "cache_bytes": sum(i.dtype.itemsize * math.prod(i.shape)
                                        for _, i in base.tree_items(cache_info)),
                     "cache_shape": list(cache_info["k"].shape),
                     "generate_s": wall,
                     "prefill_ms": engine.stats["prefill_s"] * 1e3,
                     "decode_ms_per_token": statistics.median(engine.stats["decode_s"]) * 1e3,
                     "fallbacks": [list(f) for f in fallbacks],
                     "first_tokens": gen[:, 0].tolist()}
                rec["cases"][label] = c
                if lead:
                    print(f"[4 tp path] ({label}) {arch} split over 2 ranks: shards drawn in "
                          f"{init_s:.2f} s, cache {c['cache_shape']} a rank; bf16 "
                          f"{DENSE_BATCH}x{DENSE_PROMPT} + {new} tokens: {wall:.2f} s, prefill "
                          f"{c['prefill_ms']:.1f} ms, decode {c['decode_ms_per_token']:.2f} "
                          f"ms/token (gloo through host memory); fallbacks {c['fallbacks']}")
                del params, engine, tf
                gc.collect()
                torch.cuda.empty_cache()

        cfg = _tp_config(DENSE_ARCH, "float32", TP_FP32_LAYERS)
        with shd.use_mesh(mesh, tensor.serving_rules()):
            params = _tp_shards(cfg, dev)
            cache_info = tensor.local_tree(cfg, api.abstract_cache(
                cfg, DENSE_BATCH, tensor.cache_len(cfg, DENSE_PROMPT + TP_FP32_STEPS + 8)))
            with torch.inference_mode():
                cache = base.tree_init(cache_info, torch.Generator(device=dev), dev)
            got = _tp_steps(cfg, params, cache, _tp_prompts(cfg.vocab, DENSE_BATCH,
                                                            DENSE_PROMPT), TP_FP32_STEPS, dev)
        arrays["c/logits"], arrays["c/tokens"] = got["logits"], got["tokens"]
        rec["cases"]["c"] = {"arch": DENSE_ARCH, "dtype": "float32",
                             "param_bytes": _tree_bytes(params),
                             "cache_bytes": _tree_bytes(cache)}
        rec["launches"] = _rank_launches()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (root / f"rank{rank}.json").write_text(json.dumps(rec))
    np.savez(root / f"rank{rank}.npz", **arrays)
    return 0


def _tp_train_setup(fp32: bool):
    """(cfg, shape, OptConfig, TrainerConfig kwargs) of phase 4(m)'s runs."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import base
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH), n_layers=TP_TRAIN_BF16_LAYERS)
    if fp32:
        cfg = dataclasses.replace(cfg, n_layers=TP_TRAIN_FP32_LAYERS, compute_dtype="float32")
    B, S, accum = TP_TRAIN_SHAPE
    shape = base.ShapeConfig("tp_train", S, B, "train", accum=accum)
    oc = adamw.OptConfig(lr=TP_TRAIN_LR, warmup_steps=2, total_steps=TP_TRAIN_STEPS)
    return cfg, shape, oc, {"total_steps": TP_TRAIN_STEPS, "ckpt_every": TP_TRAIN_STEPS + 1,
                            "seed": SEED, "remat": "full"}


class _Coordinate:
    """A mesh's shape and one rank's coordinate on it, for `tensor.shard_leaf`
    outside the rank's world: the slice that rank holds."""

    def __init__(self, shape: dict, coord: dict):
        self.shape, self._coord = shape, coord

    def coordinate(self, axis: str) -> int:
        return self._coord[axis]

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes if a in self.shape)


def _tp_train_path(dev, wrappers, reset_launches, smi) -> None:
    """Phase 4(m): dense training split over a (2, 2) (data, model) mesh on
    the card (the constants' comment above `TP_TRAIN_SHAPE`). Four
    `--tp-train-child` ranks train first, while this process holds
    nothing; then this process runs the same steps unmeshed and holds the
    ranks' results to them. The dense path reaches no TPU kernel: every
    count, the ranks' too, must stay 0."""
    import gc
    import shutil
    import torch
    from repro_torch.models import base
    from repro_torch.train import trainer

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tag = "tp train path"
    reset_launches()
    root = ROOT / "build" / "tp_train_path"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    n_ranks = math.prod(TP_TRAIN_RANKS)
    ranks = _run_ranks("--tp-train-child", n_ranks, root, dev, "tensor-parallel training")
    for r, rec in enumerate(ranks):
        for label, c in rec["cases"].items():
            print(f"[4 {tag}] rank {r} {c['coordinate']} ({label}): state "
                  f"{c['state_bytes'] / 1e9:.3f} GB, peak {c['peak_bytes'] / 1e9:.2f} GB "
                  f"allocated, steps {', '.join(f'{v:.2f}' for v in c['step_s'])} s, losses "
                  f"{', '.join(f'{v:.6f}' for v in c['loss'])}, grad norms "
                  f"{', '.join(f'{v:.6f}' for v in c['grad_norm'])}")
    out = {"ranks": ranks}

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    # (a) bf16, TP_TRAIN_BF16_LAYERS layers: the unmeshed trainer from the same seed
    cfg, shape, oc, kw = _tp_train_setup(fp32=False)
    tc = trainer.TrainerConfig(ckpt_dir=str(root / "plain_a"), **kw)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    _, hist = trainer.run(cfg, shape, oc, tc, device=dev)
    run_s = time.perf_counter() - t0
    lrel = max(rel(rec["cases"]["a"]["loss"], hist["loss"]) for rec in ranks)
    grel = max(rel(rec["cases"]["a"]["grad_norm"], hist["grad_norm"]) for rec in ranks)
    same = all(rec["cases"]["a"]["loss"] == ranks[0]["cases"]["a"]["loss"] for rec in ranks)
    print(f"[4 {tag}] (a) {TRAIN_ARCH} {cfg.n_layers} layers bf16, {TP_TRAIN_STEPS} steps of "
          f"{shape.global_batch}x{shape.seq_len} in {shape.accum} microbatches unmeshed: "
          f"{run_s:.1f} s, losses {', '.join(f'{v:.6f}' for v in hist['loss'])}, grad norms "
          f"{', '.join(f'{v:.6f}' for v in hist['grad_norm'])}, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.1f} GB; split over 2x2 vs unmeshed: "
          f"losses within {lrel:.3g} relative (bound {TP_TRAIN_LOSS_RTOL}), grad norms within "
          f"{grel:.3g} (bound {TP_TRAIN_GNORM_RTOL}); ranks' losses equal: {same}")
    out["a"] = {"loss": hist["loss"], "grad_norm": hist["grad_norm"], "step_s": hist["step_s"],
                "loss_rel": lrel, "grad_norm_rel": grel}
    if not (lrel <= TP_TRAIN_LOSS_RTOL and grel <= TP_TRAIN_GNORM_RTOL and same):
        raise AssertionError("the split bf16 training steps differ from unmeshed")
    del hist
    gc.collect()
    torch.cuda.empty_cache()

    # (b) fp32, TF32 off, TP_TRAIN_FP32_LAYERS layers: the unmeshed steps with
    # each element's smallest |g|, then every rank's shards
    cfg, shape, oc, kw = _tp_train_setup(fp32=True)
    state, losses, norms, gmin = _fp32_steps(cfg, shape, oc, dev)
    lrel = max(rel(rec["cases"]["b"]["loss"], losses) for rec in ranks)
    grel = max(rel(rec["cases"]["b"]["grad_norm"], norms) for rec in ranks)
    scale = max(t.abs().max().item() for _, t in base.tree_items(state["params"]))
    shards = [torch.load(root / f"rank{r}_b.pt") for r in range(n_ranks)]
    worst, worst_any, n_sure, n_all = _shard_errors(
        cfg, state, gmin, shards, [rec["cases"]["b"]["coordinate"] for rec in ranks], dev)
    del shards
    print(f"[4 {tag}] (b) {TRAIN_ARCH} {TP_TRAIN_FP32_LAYERS} layers fp32 (TF32 off) unmeshed: "
          f"losses {', '.join(f'{v:.7f}' for v in losses)}, grad norms "
          f"{', '.join(f'{v:.7f}' for v in norms)}; split over 2x2 vs unmeshed: losses within "
          f"{lrel:.3g} relative, grad norms within {grel:.3g} (bound {TP_TRAIN_FP32_RTOL}); "
          f"every rank's parameter shards after {TP_TRAIN_STEPS} steps within "
          f"{worst / scale:.3g} of the largest |p| {scale:.4g} where |g| stayed above "
          f"{EPS_REGIME} ({n_sure / n_all:.4f} of the elements; bound {TP_TRAIN_FP32_RTOL}), "
          f"{worst_any:.3g} elsewhere (bound 2 lr {2 * oc.lr:.3g})")
    out["b"] = {"loss": losses, "grad_norm": norms, "loss_rel": lrel, "grad_norm_rel": grel,
                "param_err_of_max": worst / scale, "param_err_any": worst_any,
                "share_held": n_sure / n_all}
    if not (lrel <= TP_TRAIN_FP32_RTOL and grel <= TP_TRAIN_FP32_RTOL
            and worst <= TP_TRAIN_FP32_RTOL * scale and worst_any <= 2 * oc.lr):
        raise AssertionError("the split fp32 training steps differ from unmeshed")
    del state, gmin
    gc.collect()
    torch.cuda.empty_cache()

    counts = {name: w.launches for name, w in wrappers.items()}
    children = [rec["launches"] for rec in ranks]
    print(f"[4 {tag}] launches {counts}, ranks {children} (the dense path reaches no TPU "
          f"kernel)")
    if any(counts.values()) or any(any(c.values()) for c in children):
        raise AssertionError("a kernel launched on the dense training path")
    seconds = time.perf_counter() - t_phase
    shutil.rmtree(root, ignore_errors=True)
    print(f"[4 {tag}] phase {seconds:.1f} s")
    print(json.dumps({"tp_train": out, "phase_s": seconds, "device": _device_name(dev),
                      "power": smi}))


def _tp_train_child(rank: int, root: Path, device: str) -> int:
    """`chip_smoke.py --tp-train-child RANK DIR DEVICE`, one of phase 4(m)'s
    four ranks, on the parent's DEVICE (all on the one card): a gloo world
    over a `FileStore` in DIR, a (2, 2) (data, model) mesh under the
    trainer's rules, `trainer.run` of (a) and (b) on this rank's shards;
    writes DIR/rank<RANK>.json and (b)'s final parameter shards to
    DIR/rank<RANK>_b.pt."""
    import gc
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import api, base
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tensor
    from repro_torch.train import trainer

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_ranks = math.prod(TP_TRAIN_RANKS)
    lead = rank == 0
    dist.init_process_group("gloo", store=dist.FileStore(str(root / "store"), n_ranks),
                            rank=rank, world_size=n_ranks)
    rec = {"cases": {}}
    try:
        mesh = make_mesh_compat(TP_TRAIN_RANKS, ("data", "model"), device=dev.type)
        coordinate = {a: mesh.coordinate(a) for a in mesh.shape}
        if lead:
            print(f"[4 tp train path] {mesh}, backend {dist.get_backend()}, world "
                  f"{dist.get_world_size()}, all ranks on {_device_name(dev)}")
        for label, fp32 in (("a", False), ("b", True)):
            cfg, shape, oc, kw = _tp_train_setup(fp32)
            tc = trainer.TrainerConfig(ckpt_dir=str(root / f"ckpt_{label}_{rank}"), **kw)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            with shd.use_mesh(mesh, tensor.training_rules(mesh)):
                state, hist = trainer.run(cfg, shape, oc, tc, device=dev)
            torch.cuda.synchronize(dev)
            with shd.use_mesh(mesh, tensor.training_rules(mesh)):
                tensor.local_tree(cfg, api.abstract_params(cfg), tensor.TRAIN_AXES)
                fallbacks = shd.fallbacks()
            c = {"arch": cfg.name, "dtype": cfg.compute_dtype, "layers": cfg.n_layers,
                 "coordinate": coordinate, "run_s": time.perf_counter() - t0,
                 "state_bytes": _tree_bytes(state),
                 "peak_bytes": torch.cuda.max_memory_allocated(dev),
                 "loss": hist["loss"], "grad_norm": hist["grad_norm"],
                 "step_s": hist["step_s"], "fallbacks": [list(f) for f in fallbacks]}
            rec["cases"][label] = c
            if lead:
                print(f"[4 tp train path] ({label}) {cfg.name} {cfg.n_layers} layers "
                      f"{cfg.compute_dtype}, {TP_TRAIN_STEPS} steps of "
                      f"{shape.global_batch}x{shape.seq_len} in {shape.accum} microbatches, "
                      f"remat full, split over {mesh.shape}: {c['run_s']:.1f} s, steps "
                      f"{', '.join(f'{v:.2f}' for v in c['step_s'])} s (gloo through host "
                      f"memory); state {c['state_bytes'] / 1e9:.3f} GB a rank (whole "
                      f"{16 * base.count_params(api.abstract_params(cfg)) / 1e9:.1f} GB of "
                      f"parameters, m, v and gradient sums), peak "
                      f"{c['peak_bytes'] / 1e9:.2f} GB; fallbacks {c['fallbacks']}")
            if label == "b":
                torch.save({base.keystr(p): t.cpu() for p, t in
                            base.tree_items(state["params"])}, root / f"rank{rank}_b.pt")
            del state, hist
            gc.collect()
            torch.cuda.empty_cache()
        rec["launches"] = _rank_launches()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (root / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


def _rank_launches(reset: bool = False) -> dict:
    """This process's launch count of each kernel family (after setting
    every count to 0, with `reset`)."""
    from repro_torch.kernels.binary_matvec import ops
    from repro_torch.kernels.fused_mlp import ops as fops
    from repro_torch.kernels.quant_matmul import ops as qops
    from repro_torch.kernels.ssd_scan import ops as sops
    if reset:
        for mod in (ops, fops, qops, sops):
            mod.reset_launches()
    return {"binary_matvec": sum(f.launches for f in (
        ops.binary_matmul_planes, ops.binary_forward_planes, ops.binary_matmul,
        ops.binary_matmul_packed)), "fused_mlp_predict": fops.fused_mlp_predict.launches,
        "quant_matmul": qops.quant_matmul.launches, "ssd_scan": sops.ssd.launches,
        "ssd_scan mma": sops.ssd.mma_launches}


def _tp_ssm_path(dev, wrappers, reset_launches, smi, clock_hz: float) -> dict:
    """Phase 4(n): the ssm and hybrid families served split over a model
    axis of 2 on the card (the constants' comment above `TP_SSM_SERVED`).
    Two `--tp-ssm-child` ranks serve first, each counting its own kernel
    launches in its measured generate, while this process holds nothing;
    then this process draws each model whole from the same seed, runs it
    unmeshed, holds the ranks' results to it, and holds ssd_scan at a
    rank's shape to its plain version. Returns the ranks' ssd_scan
    launches (and tensor-core launches) in their measured generates, and
    the rank shape's kernel record."""
    import gc
    import shutil
    import numpy as np
    import torch
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.models import api, base

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tag = "tp ssm path"
    reset_launches()
    root = ROOT / "build" / "tp_ssm_path"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ranks = _run_ranks("--tp-ssm-child", TP_RANKS, root, dev, "ssm tensor-parallel")
    arrays = [dict(np.load(root / f"rank{r}.npz")) for r in range(TP_RANKS)]
    served = {"ssd_scan": 0, "ssd_scan mma": 0}
    for r, rec in enumerate(ranks):
        for label, arch in TP_SSM_SERVED:
            c = rec["cases"][label]
            n = TP_SSM_SERVED_LAYERS[arch]
            counts = dict(c["launches"])
            ssd, mma = counts.pop("ssd_scan"), counts.pop("ssd_scan mma")
            print(f"[4 {tag}] rank {r} ({label}) {arch}: parameters "
                  f"{c['param_bytes'] / 1e9:.3f} GB, cache {c['cache_bytes'] / 1e9:.4f} GB "
                  f"{c['cache_shapes']}; {mma} of {ssd} ssd_scan launches on the tensor cores "
                  f"in the measured generate (one prefill), other launches {counts}")
            if not ssd == mma == n or any(counts.values()):
                raise AssertionError(f"rank {r} {arch}: want {n} ssd_scan launches, all on "
                                     "the tensor cores, and no other kernel in one generate")
            served["ssd_scan"] += ssd
            served["ssd_scan mma"] += mma
    out = {"ranks": ranks}

    # (a), (b): layer 0 and the bf16 prefill's last logits; the ranks' tokens
    eps = torch.finfo(torch.bfloat16).eps
    for label, arch in TP_SSM_SERVED:
        cfg = _tp_config(arch, "bfloat16", TP_SSM_SERVED_LAYERS[arch])
        prompts = _tp_prompts(cfg.vocab, DENSE_BATCH, DENSE_PROMPT)
        with torch.inference_mode():
            params = base.tree_init(api.abstract_params(cfg),
                                    torch.Generator(device=dev).manual_seed(SEED), dev)
            want, witness = (_prefill(cfg, params, torch.as_tensor(prompts, device=dev).long(),
                                      dev, uk)[0].float().cpu().numpy() for uk in (True, False))
        layer0 = _layer0(cfg, params, prompts, dev, None)
        ulps = [float(np.abs(a[f"{label}/layer0"] - layer0).max() / (eps * np.abs(layer0).max()))
                for a in arrays]
        scale = float(np.abs(want).max())
        errs = [float(np.abs(a[f"{label}/prefill"] - want).max()) for a in arrays]
        route = float(np.abs(witness - want).max()) / scale
        bound = max(TP_BF16_RTOL, TP_SSM_WITNESS * route)
        same = all(np.array_equal(a[f"{label}/{k}"], arrays[0][f"{label}/{k}"])
                   for a in arrays for k in ("prefill", "tokens"))
        print(f"[4 {tag}] ({label}) {arch} bf16, split over 2 ranks vs unmeshed: layer 0's "
              f"mixer on the {DENSE_BATCH}x{DENSE_PROMPT} prompt within "
              f"{', '.join(f'{u:.3g}' for u in ulps)} bf16 ulps of its scale (ranks 0, 1; "
              f"bound {ROUTE_ULPS}); the prefill's last logits max |diff| "
              f"{', '.join(f'{e:.4g}' for e in errs)} of the largest |logit| {scale:.4g}: "
              f"{max(errs) / scale:.4g} (bound {bound:.4g}: the larger of {TP_BF16_RTOL} and "
              f"{TP_SSM_WITNESS:g} x the unmeshed kernel route against the plain route, "
              f"{route:.4g}); the ranks' logits and {DENSE_NEW} greedy tokens bitwise equal: "
              f"{same}")
        if max(ulps) > ROUTE_ULPS or max(errs) > bound * scale or not same:
            raise AssertionError(f"{arch}: the split prefill differs from unmeshed, or the "
                                 "ranks differ")
        out[label] = {"layer0_ulps": ulps, "prefill_max_abs": errs, "logit_scale": scale,
                      "witness_rel": route, "bound_rel": bound}
        del params
        gc.collect()
        torch.cuda.empty_cache()

    # (c) fp32, TF32 off, cut depth: every step's logits
    for label, arch in TP_SSM_SERVED:
        cfg = _tp_config(arch, "float32", TP_SSM_FP32_LAYERS[arch])
        prompts = _tp_prompts(cfg.vocab, DENSE_BATCH, DENSE_PROMPT)
        with torch.inference_mode():
            params = base.tree_init(api.abstract_params(cfg),
                                    torch.Generator(device=dev).manual_seed(SEED), dev)
            cache = base.tree_init(api.abstract_cache(cfg, DENSE_BATCH,
                                                      DENSE_PROMPT + TP_FP32_STEPS + 8),
                                   torch.Generator(device=dev), dev)
        want = _tp_steps(cfg, params, cache, prompts, TP_FP32_STEPS, dev, use_kernel=True)
        scale = float(np.abs(want["logits"]).max())
        errs = [float(np.abs(a[f"c{label}/logits"] - want["logits"]).max()) for a in arrays]
        equal = all(np.array_equal(a[f"c{label}/tokens"], want["tokens"]) for a in arrays)
        print(f"[4 {tag}] (c{label}) {arch} {cfg.n_layers} layers fp32 (TF32 off) prefill "
              f"{DENSE_BATCH}x{DENSE_PROMPT} + {TP_FP32_STEPS} steps, split vs unmeshed: max "
              f"|diff| {', '.join(f'{e:.3g}' for e in errs)} (ranks 0, 1) of the largest "
              f"|logit| {scale:.4g}: {max(errs) / scale:.3g} (bound {TP_FP32_RTOL}); greedy "
              f"tokens {'equal' if equal else 'differ'}")
        if max(errs) > TP_FP32_RTOL * scale or not equal:
            raise AssertionError(f"{arch}: the fp32 split path differs from unmeshed")
        out[f"c{label}"] = {"max_abs": errs, "logit_scale": scale}
        del params, cache
        gc.collect()
        torch.cuda.empty_cache()

    # (d) ssd_scan at a rank's shape against its plain version
    args = _ssd_args(np.random.default_rng(SEED + 2), dev, torch.bfloat16, 128,
                     TP_SSM_SSD_HEADS)
    mma = sops.ssd.mma_launches
    (y, s), (yp, sp) = sops.ssd(*args, chunk=LM_CHUNK), sref.ssd(*args, chunk=LM_CHUNK)
    torch.cuda.synchronize()
    route = "tensor cores" if sops.ssd.mma_launches > mma else "scalar"
    err = float((y.float() - yp.float()).abs().max().item())
    moved = sum(t.numel() * t.element_size() for t in (*args, y, s))
    flop = _ssd_flop(args[0], args[3], LM_CHUNK)
    bound_ms, bound_by = _bound(moved, flop, BF16_TC_FLOP_PER_S)
    record = {"shape": f"bf16_rank_of_2: H={TP_SSM_SSD_HEADS}",
              "ms": _time_ms(lambda: sops.ssd(*args, chunk=LM_CHUNK), clock_hz),
              "plain_ms": _time_ms(lambda: sref.ssd(*args, chunk=LM_CHUNK), clock_hz),
              "library_ms": None, "library": None, "bound_ms": bound_ms,
              "bound_by": bound_by, "bytes": moved, "flop": flop, "path": route,
              "cuda_core_bound_ms": _bound(moved, flop, 2 * FMA_PER_CLOCK_PER_SM * clock_hz
                                           * torch.cuda.get_device_properties(dev)
                                           .multi_processor_count)[0],
              "launches_per_prefill": TP_SSM_SERVED_LAYERS["mamba2-2.7b"],
              "max_abs_err": err}
    print(f"[4 {tag}] (d) ssd_scan {tuple(y.shape)} (a rank's {TP_SSM_SSD_HEADS} heads) on the "
          f"{route} route max_abs_err={err:.3g} (|y| <= {yp.float().abs().max().item():.3g}), "
          f"state {float((s - sp).abs().max().item()):.3g}; {record['ms']:.4f} ms, plain "
          f"{record['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if not _ssd_agrees(y, s, yp, sp) or route != "tensor cores":
        raise AssertionError("ssd_scan at a rank's shape disagrees with its plain version or "
                             "left the tensor cores")
    out["d"] = record
    del args, y, s, yp, sp
    gc.collect()
    torch.cuda.empty_cache()

    seconds = time.perf_counter() - t_phase
    shutil.rmtree(root, ignore_errors=True)
    print(f"[4 {tag}] the ranks' ssd_scan launches in their measured generates: "
          f"{served['ssd_scan']} ({served['ssd_scan mma']} on the tensor cores)")
    print(f"[4 {tag}] phase {seconds:.1f} s")
    print(json.dumps({"tp_ssm": out, "phase_s": seconds, "device": _device_name(dev),
                      "power": smi}))
    return {**served, "rank_shape": record}


def _layer0(cfg, params, prompts, dev, group):
    """Layer 0's mixer output (numpy, fp32) on the prompt's normed
    embedding, through the kernel route; split over `group` when params
    are shards."""
    import torch
    from repro_torch.layers import embedding, norms
    from repro_torch.layers import mamba2 as m2
    from repro_torch.models import base
    with torch.inference_mode():
        tokens = torch.as_tensor(prompts, device=dev).long()
        lp = base.layer(params["layers"], 0)
        h = embedding.embed(cfg, params["embed"], tokens, group)
        hn = norms.apply_norm(cfg.norm, lp["ln"], h, eps=cfg.norm_eps)
        y = m2.mamba_mixer(cfg, lp["mixer"], hn, use_kernel=True, group=group)
    return y.float().cpu().numpy()


def _tp_ssm_child(rank: int, root: Path, device: str) -> int:
    """`chip_smoke.py --tp-ssm-child RANK DIR DEVICE`, one of phase 4(n)'s
    two ranks, on the parent's DEVICE (both ranks on the one card): a gloo
    world over a `FileStore` in DIR, a (1, 2) mesh under the serving
    rules, the split paths of (a), (b) and (c) on this rank's shards;
    every launch count set to 0 just before each measured generate and
    read just after; writes DIR/rank<RANK>.{json,npz}."""
    import gc
    import math
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import api, base
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tensor
    from repro_torch.serve.engine import Engine, ServeConfig

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lead = rank == 0
    dist.init_process_group("gloo", store=dist.FileStore(str(root / "store"), TP_RANKS),
                            rank=rank, world_size=TP_RANKS)
    rec, arrays = {"cases": {}}, {}
    try:
        mesh = make_mesh_compat((1, TP_RANKS), ("data", "model"), device=dev.type)
        if lead:
            print(f"[4 tp ssm path] {mesh}, backend {dist.get_backend()}, world "
                  f"{dist.get_world_size()}, both ranks on {_device_name(dev)}")
        for label, arch in TP_SSM_SERVED:
            cfg = _tp_config(arch, "bfloat16", TP_SSM_SERVED_LAYERS[arch])
            with shd.use_mesh(mesh, tensor.serving_rules()):
                t0 = time.perf_counter()
                params = _tp_shards(cfg, dev)
                fallbacks = shd.fallbacks()
                torch.cuda.synchronize(dev)
                init_s = time.perf_counter() - t0
                prompts = _tp_prompts(cfg.vocab, DENSE_BATCH, DENSE_PROMPT)
                sc = ServeConfig(max_len=DENSE_PROMPT + DENSE_NEW + 8, max_new_tokens=DENSE_NEW)
                engine = Engine(cfg, params, sc, device=dev)
                engine.generate(prompts[:, :16])                 # warm-up
                _rank_launches(reset=True)
                t0 = time.perf_counter()
                gen = engine.generate(prompts)
                wall = time.perf_counter() - t0
                launches = _rank_launches()
                if gen.shape != (DENSE_BATCH, DENSE_NEW) or gen.min() < 0 or gen.max() >= cfg.vocab:
                    raise AssertionError(f"{arch}: bad tokens, shape {gen.shape}")
                cache_info = tensor.local_tree(cfg, api.abstract_cache(
                    cfg, DENSE_BATCH, tensor.cache_len(cfg, sc.max_len)))
                with torch.inference_mode():
                    cache = base.tree_init(cache_info, torch.Generator(device=dev), dev)
                    last, _ = api.prefill(cfg, engine.params, {"tokens": torch.as_tensor(
                        prompts, device=dev).long()}, cache, use_kernel=True)
                arrays[f"{label}/prefill"] = last.float().cpu().numpy()
                arrays[f"{label}/tokens"] = gen
                arrays[f"{label}/layer0"] = _layer0(cfg, engine.params, prompts, dev,
                                                    tensor.group_for(cfg))
                del cache
                c = {"arch": arch, "dtype": cfg.compute_dtype, "init_s": init_s,
                     "param_bytes": _tree_bytes(params),
                     "cache_bytes": sum(i.dtype.itemsize * math.prod(i.shape)
                                        for _, i in base.tree_items(cache_info)),
                     "cache_shapes": {base.keystr(p): list(i.shape)
                                      for p, i in base.tree_items(cache_info)},
                     "in_proj_shape": list(params["layers"]["mixer"]["in_proj"].shape),
                     "generate_s": wall,
                     "prefill_ms": engine.stats["prefill_s"] * 1e3,
                     "decode_ms_per_token": statistics.median(engine.stats["decode_s"]) * 1e3,
                     "fallbacks": [list(f) for f in fallbacks], "launches": launches}
                rec["cases"][label] = c
                if lead:
                    print(f"[4 tp ssm path] ({label}) {arch} split over 2 ranks: shards drawn "
                          f"in {init_s:.2f} s, in_proj {c['in_proj_shape']} a rank; bf16 "
                          f"{DENSE_BATCH}x{DENSE_PROMPT} + {DENSE_NEW} tokens: {wall:.2f} s, "
                          f"prefill {c['prefill_ms']:.1f} ms, decode "
                          f"{c['decode_ms_per_token']:.2f} ms/token (gloo through host "
                          f"memory); fallbacks {c['fallbacks']}")
                del params, engine
                gc.collect()
                torch.cuda.empty_cache()

        for label, arch in TP_SSM_SERVED:
            cfg = _tp_config(arch, "float32", TP_SSM_FP32_LAYERS[arch])
            with shd.use_mesh(mesh, tensor.serving_rules()):
                params = _tp_shards(cfg, dev)
                cache_info = tensor.local_tree(cfg, api.abstract_cache(
                    cfg, DENSE_BATCH, tensor.cache_len(cfg, DENSE_PROMPT + TP_FP32_STEPS + 8)))
                with torch.inference_mode():
                    cache = base.tree_init(cache_info, torch.Generator(device=dev), dev)
                got = _tp_steps(cfg, params, cache, _tp_prompts(cfg.vocab, DENSE_BATCH,
                                                                DENSE_PROMPT),
                                TP_FP32_STEPS, dev, use_kernel=True)
            arrays[f"c{label}/logits"], arrays[f"c{label}/tokens"] = got["logits"], got["tokens"]
            del params, cache
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (root / f"rank{rank}.json").write_text(json.dumps(rec))
    np.savez(root / f"rank{rank}.npz", **arrays)
    return 0


def _tp_ssm_train_setup(label: str):
    """(cfg, shape, OptConfig, TrainerConfig kwargs) of phase 4(o)'s run
    `label`."""
    from repro_torch.models import base
    from repro_torch.optim import adamw
    arch, layers, dtype = TP_SSM_TRAIN_CASES[label]
    B, S, accum = TP_TRAIN_SHAPE
    shape = base.ShapeConfig("tp_ssm_train", S, B, "train", accum=accum)
    oc = adamw.OptConfig(lr=TP_TRAIN_LR, warmup_steps=2, total_steps=TP_TRAIN_STEPS)
    return _tp_config(arch, dtype, layers), shape, oc, {
        "total_steps": TP_TRAIN_STEPS, "ckpt_every": TP_TRAIN_STEPS + 1, "seed": SEED,
        "remat": "full"}


@contextlib.contextmanager
def _one_rounding_more():
    """Within: every Mamba2 mixer takes out_proj's contraction in two
    halves, each rounded to the compute dtype and then added, and in_proj's
    columns in two halves, so that xin's gradient is the sum of two
    rounded partial products; the LM head takes its vocab in two halves,
    so that h's gradient is too: the roundings a split over two model
    ranks adds, unmeshed (phase 4(o)'s witness)."""
    import torch
    from repro_torch.layers import embedding as emb
    from repro_torch.layers import mamba2 as m2
    from repro_torch.layers.common import wx

    def column_halves(x, w):
        k = w.shape[-1] // 2
        return torch.cat([torch.matmul(x, w[..., :k]), torch.matmul(x, w[..., k:])], -1)

    def out(p, y, loc, seq=None):
        w, k = wx(p["out_proj"], y.dtype), y.shape[-1] // 2
        return torch.matmul(y[..., :k], w[:k]) + torch.matmul(y[..., k:], w[k:])

    def project(cfg, p, xin, loc, gathered=False):
        zxbcdt = column_halves(xin, wx(p["in_proj"], xin.dtype))
        N = cfg.ssm_state
        return (*torch.split(zxbcdt, [loc.di, loc.di, loc.G * N, loc.G * N, loc.H], dim=-1),
                zxbcdt)

    def head(cfg, p, h, group=None, *, gather=True, seq=None):
        return column_halves(h, (p["tok"].T if cfg.tie_embeddings else p["head"]).to(h.dtype))

    saved = m2._out, m2._project, emb.lm_head
    m2._out, m2._project, emb.lm_head = out, project, head
    try:
        yield
    finally:
        m2._out, m2._project, emb.lm_head = saved


def _fp32_steps(cfg, shape, oc, dev):
    """The unmeshed train steps (TP_TRAIN_STEPS of them, remat full) from
    the seed's state on the trainer's batches: (state, losses, grad norms,
    each parameter element's smallest |g| over the steps)."""
    import torch
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import base
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib
    from repro_torch.train import trainer
    state = base.tree_init(step_lib.abstract_state(cfg),
                           torch.Generator(device=dev).manual_seed(SEED), dev)
    grad_fn = step_lib.make_grad_fn(cfg, shape, remat="full")
    losses, norms, gmin = [], [], None
    for i in range(TP_TRAIN_STEPS):
        batch = _on(make_batch(cfg, shape, i, seed=trainer.TrainerConfig().data_seed), dev)
        loss, _, grads = grad_fn(state["params"], batch)
        g = [t.abs() for _, t in base.tree_items(grads)]
        gmin = g if gmin is None else [torch.minimum(a, b) for a, b in zip(gmin, g)]
        _, _, m = adamw.apply_updates(state["params"], grads, state["opt"], oc)
        losses.append(loss.item())
        norms.append(m["grad_norm"].item())
        del grads, g
    return state, losses, norms, gmin


def _held_rel(state, other, gmin) -> float:
    """The largest |difference| of two states' parameters where |g| stayed
    above EPS_REGIME."""
    from repro_torch.models import base
    return max(((a - b).abs()[gm > EPS_REGIME].max().item() if (gm > EPS_REGIME).any()
                else 0.0) for (_, a), (_, b), gm in zip(
        base.tree_items(state["params"]), base.tree_items(other["params"]), gmin))


def _shard_errors(cfg, state, gmin, shards: list, coordinates: list, dev,
                  ranks: tuple = TP_TRAIN_RANKS) -> tuple:
    """Every rank's parameter shards ({keystr: tensor}, at its (data,
    model) coordinate of `ranks`) against the slices of the whole
    `state` that the trainer's rules give it: (the largest |difference|
    where |g| stayed above EPS_REGIME, the largest anywhere, the elements
    held so, all elements)."""
    from repro_torch.models import base
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tensor
    from repro_torch.train import step as step_lib
    infos = dict(base.tree_items(step_lib.abstract_state(cfg)["params"]))
    worst, worst_any, n_sure, n_all = 0.0, 0.0, 0, 0
    for shard, coordinate in zip(shards, coordinates):
        mesh = _Coordinate(dict(zip(("data", "model"), ranks)), coordinate)
        with shd.use_mesh(mesh, tensor.training_rules(mesh)):
            for (path, whole), gm in zip(base.tree_items(state["params"]), gmin):
                want = tensor.shard_leaf(infos[path], whole, tensor.TRAIN_AXES)
                sure = tensor.shard_leaf(infos[path], gm, tensor.TRAIN_AXES) > EPS_REGIME
                d = (shard[base.keystr(path)].to(dev) - want).abs()
                worst = max(worst, d[sure].max().item() if sure.any() else 0.0)
                worst_any = max(worst_any, d.max().item())
                n_sure, n_all = n_sure + int(sure.sum()), n_all + sure.numel()
    return worst, worst_any, n_sure, n_all


def _tp_ssm_train_path(dev, wrappers, reset_launches, smi) -> None:
    """Phase 4(o): the ssm and hybrid families trained split over a (2, 2)
    (data, model) mesh on the card (the constants' comment above
    `TP_SSM_TRAIN_CASES`). Four `--tp-ssm-train-child` ranks train first,
    while this process holds nothing; then this process runs the same
    steps unmeshed, and the witness, and holds the ranks' results to them.
    Training reaches no TPU kernel: every count, the ranks' too, must stay
    0."""
    import dataclasses
    import gc
    import shutil
    import torch
    from repro_torch.models import base
    from repro_torch.train import trainer

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tag = "tp ssm train path"
    reset_launches()
    root = ROOT / "build" / "tp_ssm_train_path"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    print(f"[4 {tag}] this process holds {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
          f"allocated, {torch.cuda.memory_reserved(dev) / 1e9:.2f} GB reserved, while the ranks "
          "train")
    n_ranks = math.prod(TP_TRAIN_RANKS)
    ranks = _run_ranks("--tp-ssm-train-child", n_ranks, root, dev, "ssm tensor-parallel training")
    for r, rec in enumerate(ranks):
        for label, c in rec["cases"].items():
            print(f"[4 {tag}] rank {r} {c['coordinate']} ({label}): state "
                  f"{c['state_bytes'] / 1e9:.3f} GB, peak {c['peak_bytes'] / 1e9:.2f} GB "
                  f"allocated, steps {', '.join(f'{v:.2f}' for v in c['step_s'])} s, losses "
                  f"{', '.join(f'{v:.6f}' for v in c['loss'])}, grad norms "
                  f"{', '.join(f'{v:.6f}' for v in c['grad_norm'])}")
    out = {"ranks": ranks}

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    # (a), (b) bf16: the unmeshed trainer from the same seed, and the witness
    for label in ("a", "b"):
        cfg, shape, oc, kw = _tp_ssm_train_setup(label)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        hist = trainer.run(cfg, shape, oc, trainer.TrainerConfig(
            ckpt_dir=str(root / f"plain_{label}"), **kw), device=dev)[1]
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        gc.collect()
        torch.cuda.empty_cache()
        with _one_rounding_more():
            wit = trainer.run(cfg, shape, oc, trainer.TrainerConfig(
                ckpt_dir=str(root / f"witness_{label}"), **kw), device=dev)[1]
        gc.collect()
        torch.cuda.empty_cache()
        got = [rec["cases"][label] for rec in ranks]
        lrel = max(rel(c["loss"], hist["loss"]) for c in got)
        grel = max(rel(c["grad_norm"], hist["grad_norm"]) for c in got)
        wl, wg = rel(wit["loss"], hist["loss"]), rel(wit["grad_norm"], hist["grad_norm"])
        lbound = max(TP_TRAIN_LOSS_RTOL, TP_SSM_WITNESS * wl)
        gbound = max(TP_TRAIN_GNORM_RTOL, TP_SSM_WITNESS * wg)
        same = all(c["loss"] == got[0]["loss"] for c in got)
        finite = all(math.isfinite(v) for c in got for v in c["loss"] + c["grad_norm"])
        print(f"[4 {tag}] ({label}) {cfg.name} {cfg.n_layers} layers bf16, {TP_TRAIN_STEPS} "
              f"steps of {shape.global_batch}x{shape.seq_len} in {shape.accum} microbatches "
              f"unmeshed: {run_s:.1f} s, losses {', '.join(f'{v:.6f}' for v in hist['loss'])}, "
              f"grad norms {', '.join(f'{v:.6f}' for v in hist['grad_norm'])}, peak "
              f"{peak / 1e9:.1f} GB; the witness (the split's roundings): losses within "
              f"{wl:.3g}, grad norms within {wg:.3g}; split over 2x2 vs unmeshed: losses within "
              f"{lrel:.3g} relative (bound {lbound:.3g}: the larger of {TP_TRAIN_LOSS_RTOL} and "
              f"{TP_SSM_WITNESS:g} x the witness), grad norms within {grel:.3g} (bound "
              f"{gbound:.3g}); finite: {finite}; ranks' losses equal: {same}")
        out[label] = {"loss": hist["loss"], "grad_norm": hist["grad_norm"],
                      "step_s": hist["step_s"], "peak_bytes": peak, "loss_rel": lrel,
                      "grad_norm_rel": grel, "witness_loss_rel": wl, "witness_grad_norm_rel": wg,
                      "loss_bound": lbound, "grad_norm_bound": gbound}
        if not (finite and lrel <= lbound and grel <= gbound and same):
            raise AssertionError(f"{cfg.name}: the split bf16 training steps differ from "
                                 "unmeshed")
        del hist, wit

    # (c) fp32, TF32 off: the unmeshed steps with each element's smallest |g|,
    # and the witness's; then every rank's shards, and the copies that ranks
    # share
    for label in ("ca", "cb"):
        cfg, shape, oc, kw = _tp_ssm_train_setup(label)
        with _one_rounding_more():
            wstate = _fp32_steps(cfg, dataclasses.replace(shape, accum=2 * shape.accum), oc,
                                 dev)[0]
        state, losses, norms, gmin = _fp32_steps(cfg, shape, oc, dev)
        got = [rec["cases"][label] for rec in ranks]
        lrel = max(rel(c["loss"], losses) for c in got)
        grel = max(rel(c["grad_norm"], norms) for c in got)
        scale = max(t.abs().max().item() for _, t in base.tree_items(state["params"]))
        witness = _held_rel(state, wstate, gmin) / scale
        bound = max(TP_TRAIN_FP32_RTOL, TP_SSM_WITNESS * witness)
        del wstate
        shards = [torch.load(root / f"rank{r}_{label}.pt") for r in range(n_ranks)]
        worst, worst_any, n_sure, n_all = _shard_errors(
            cfg, state, gmin, shards, [rec["cases"][label]["coordinate"] for rec in ranks], dev)
        # the shared copies: B and C (the one group, G = 1) on both model
        # ranks of a data coordinate; the per-head vectors on every rank
        di, N = cfg.d_inner // TP_TRAIN_RANKS[1], cfg.ssm_state
        mixer = "['layers']['mixer']"
        copies = {f"{mixer}['in_proj']": (2 * di, 2 * N), f"{mixer}['conv_w']": (di, 2 * N),
                  f"{mixer}['conv_b']": (di, 2 * N)}
        by_data: dict = {}
        for r, rec in enumerate(ranks):
            by_data.setdefault(rec["cases"][label]["coordinate"]["data"], []).append(r)
        shared = all(torch.equal(shards[a][k].narrow(-1, at, n), shards[b][k].narrow(-1, at, n))
                     for k, (at, n) in copies.items() for a, b in by_data.values())
        shared &= all(torch.equal(sh[f"{mixer}['{k}']"], shards[0][f"{mixer}['{k}']"])
                      for sh in shards for k in ("a_log", "dt_bias", "d_skip", "norm_scale"))
        print(f"[4 {tag}] ({label}) {cfg.name} {cfg.n_layers} layers fp32 (TF32 off) unmeshed: "
              f"losses {', '.join(f'{v:.7f}' for v in losses)}, grad norms "
              f"{', '.join(f'{v:.7f}' for v in norms)}; split over 2x2 vs unmeshed: losses "
              f"within {lrel:.3g} relative, grad norms within {grel:.3g} (bound "
              f"{TP_TRAIN_FP32_RTOL}); every rank's parameter shards after {TP_TRAIN_STEPS} "
              f"steps within {worst / scale:.3g} of the largest |p| {scale:.4g} where |g| stayed "
              f"above {EPS_REGIME} ({n_sure / n_all:.4f} of the elements; bound {bound:.3g}: the "
              f"larger of {TP_TRAIN_FP32_RTOL} and {TP_SSM_WITNESS:g} x the witness's "
              f"{witness:.3g}), {worst_any:.3g} elsewhere (bound 2 lr {2 * oc.lr:.3g}); shared B, "
              f"C and per-head copies bitwise equal across the ranks: {shared}")
        out[label] = {"loss": losses, "grad_norm": norms, "loss_rel": lrel, "grad_norm_rel": grel,
                      "param_err_of_max": worst / scale, "param_err_any": worst_any,
                      "witness_param_err_of_max": witness, "param_bound": bound,
                      "share_held": n_sure / n_all, "shared_copies_equal": shared}
        if not (lrel <= TP_TRAIN_FP32_RTOL and grel <= TP_TRAIN_FP32_RTOL and shared
                and worst <= bound * scale and worst_any <= 2 * oc.lr):
            raise AssertionError(f"{cfg.name}: the split fp32 training steps differ from "
                                 "unmeshed, or the ranks' shared copies differ")
        del state, gmin, shards
        gc.collect()
        torch.cuda.empty_cache()

    counts = {name: w.launches for name, w in wrappers.items()}
    children = [rec["launches"] for rec in ranks]
    print(f"[4 {tag}] launches {counts}, ranks {children} (training takes the SSD's chunked "
          f"plain route: no TPU kernel)")
    if any(counts.values()) or any(any(c.values()) for c in children):
        raise AssertionError("a kernel launched on the ssm training path")
    seconds = time.perf_counter() - t_phase
    shutil.rmtree(root, ignore_errors=True)
    print(f"[4 {tag}] phase {seconds:.1f} s")
    print(json.dumps({"tp_ssm_train": out, "phase_s": seconds, "device": _device_name(dev),
                      "power": smi}))


def _tp_ssm_train_child(rank: int, root: Path, device: str) -> int:
    """`chip_smoke.py --tp-ssm-train-child RANK DIR DEVICE`, one of phase
    4(o)'s four ranks, on the parent's DEVICE (all on the one card): a gloo
    world over a `FileStore` in DIR, a (2, 2) (data, model) mesh under the
    trainer's rules, `trainer.run` of (a), (b), (ca) and (cb) on this rank's
    shards; writes DIR/rank<RANK>.json and (ca)'s and (cb)'s final parameter
    shards to DIR/rank<RANK>_<label>.pt."""
    import gc
    import os
    # four ranks of mamba2, each allocating up to ~16.8 GiB, share the card
    # with this script's parent: segments that grow in place keep what a
    # rank reserves near what it allocates, and a cap on each rank's share
    # makes its allocator free its cache before it takes more, which leaves
    # room for what cuBLAS allocates outside it
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import api, base
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tensor
    from repro_torch.train import trainer

    dev = torch.device(device)
    torch.cuda.set_per_process_memory_fraction(TP_SSM_TRAIN_MEMORY, dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_ranks = math.prod(TP_TRAIN_RANKS)
    lead = rank == 0
    dist.init_process_group("gloo", store=dist.FileStore(str(root / "store"), n_ranks),
                            rank=rank, world_size=n_ranks)
    rec = {"cases": {}}
    try:
        mesh = make_mesh_compat(TP_TRAIN_RANKS, ("data", "model"), device=dev.type)
        coordinate = {a: mesh.coordinate(a) for a in mesh.shape}
        if lead:
            print(f"[4 tp ssm train path] {mesh}, backend {dist.get_backend()}, world "
                  f"{dist.get_world_size()}, all ranks on {_device_name(dev)}")
        _rank_launches(reset=True)
        for label in TP_SSM_TRAIN_CASES:
            cfg, shape, oc, kw = _tp_ssm_train_setup(label)
            tc = trainer.TrainerConfig(ckpt_dir=str(root / f"ckpt_{label}_{rank}"), **kw)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            with shd.use_mesh(mesh, tensor.training_rules(mesh)):
                state, hist = trainer.run(cfg, shape, oc, tc, device=dev)
            torch.cuda.synchronize(dev)
            with shd.use_mesh(mesh, tensor.training_rules(mesh)):
                tensor.local_tree(cfg, api.abstract_params(cfg), tensor.TRAIN_AXES)
                fallbacks = shd.fallbacks()
            c = {"arch": cfg.name, "dtype": cfg.compute_dtype, "layers": cfg.n_layers,
                 "coordinate": coordinate, "run_s": time.perf_counter() - t0,
                 "state_bytes": _tree_bytes(state),
                 "peak_bytes": torch.cuda.max_memory_allocated(dev),
                 "peak_reserved": torch.cuda.max_memory_reserved(dev),
                 "in_proj_shape": list(state["params"]["layers"]["mixer"]["in_proj"].shape),
                 "loss": hist["loss"], "grad_norm": hist["grad_norm"],
                 "step_s": hist["step_s"], "fallbacks": [list(f) for f in fallbacks]}
            rec["cases"][label] = c
            if lead:
                print(f"[4 tp ssm train path] ({label}) {cfg.name} {cfg.n_layers} layers "
                      f"{cfg.compute_dtype}, {TP_TRAIN_STEPS} steps of "
                      f"{shape.global_batch}x{shape.seq_len} in {shape.accum} microbatches, "
                      f"remat full, split over {mesh.shape}: {c['run_s']:.1f} s, steps "
                      f"{', '.join(f'{v:.2f}' for v in c['step_s'])} s (gloo through host "
                      f"memory); in_proj {c['in_proj_shape']} a rank, state "
                      f"{c['state_bytes'] / 1e9:.3f} GB a rank (whole "
                      f"{12 * base.count_params(api.abstract_params(cfg)) / 1e9:.1f} GB of "
                      f"parameters, m and v), peak {c['peak_bytes'] / 1e9:.2f} GB allocated, "
                      f"{c['peak_reserved'] / 1e9:.2f} GB reserved; fallbacks "
                      f"{c['fallbacks']}")
            if label.startswith("c"):
                torch.save({base.keystr(p): t.cpu() for p, t in
                            base.tree_items(state["params"])}, root / f"rank{rank}_{label}.pt")
            del state, hist
            gc.collect()
            torch.cuda.empty_cache()
        rec["launches"] = _rank_launches()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (root / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


@contextlib.contextmanager
def _moe_recorded():
    """Within: each MoE layer's routing (every token's expert ids, sorted)
    and its dispatch's kept pairs, appended to the lists yielded."""
    from unittest import mock
    import torch
    from repro_torch.layers import moe
    seen = {"ids": [], "keep": []}
    route, dispatch = moe.route, moe.dispatch

    def routed(*args, **kw):
        out = route(*args, **kw)
        seen["ids"].append(torch.sort(out[3], dim=-1).values)
        return out

    def dispatched(*args, **kw):
        out = dispatch(*args, **kw)
        seen["keep"].append(out[3])
        return out

    with mock.patch.object(moe, "route", routed), mock.patch.object(moe, "dispatch", dispatched):
        yield seen


def _out_in_halves(p, ctx, x, group):
    """`layers/attention.py`'s `_out` with its contraction in two halves
    of the heads, each rounded to the compute dtype and then added, as two
    model ranks take it (the witnesses' attention half)."""
    import torch
    from repro_torch.layers.common import wx
    B, Hl, S, hd = ctx.shape
    ctx = ctx.transpose(1, 2).reshape(B, S, Hl * hd)
    w, k = wx(p["wo"], x.dtype).reshape(Hl * hd, x.shape[-1]), Hl * hd // 2
    return torch.matmul(ctx[..., :k], w[:k]) + torch.matmul(ctx[..., k:], w[k:])


@contextlib.contextmanager
def _moe_split_roundings():
    """Within: every attention layer takes its output contraction in two
    halves of its heads, each rounded to the compute dtype and then added,
    and every MoE block runs its two halves of the experts apart through
    the expert-parallel path of `layers/moe.py` (rank 0's, then rank 1's,
    the group's collectives left out) and adds their partial outputs, the
    aux losses taken once: the roundings and orders of sums that a split
    over two model ranks adds, unmeshed (phase 4(p)'s witness). granite's
    vocab does not divide 2, so its embedding and head stay whole, as in
    the split."""
    from unittest import mock
    from repro_torch.layers import attention as attn
    from repro_torch.layers import moe as moe_lib
    real = moe_lib.moe

    def moe(cfg, p, x, *, capacity_factor=1.25, group=None, seq=None):
        half, parts, aux = p["wi"].shape[-3] // 2, [], None
        for r in range(2):
            shard = dict(p, **{k: p[k][r * half:(r + 1) * half] for k in ("wi", "wg", "wo")})
            with mock.patch.object(moe_lib.dist, "get_rank", lambda group=None, r=r: r), \
                    mock.patch.object(moe_lib.tensor, "copy_to", lambda t, g: t), \
                    mock.patch.object(moe_lib.tensor, "reduce_from", lambda t, g: t):
                y, a = real(cfg, shard, x, capacity_factor=capacity_factor, group="witness")
            parts.append(y)
            aux = aux or a
        return parts[0] + parts[1], aux

    with mock.patch.object(attn, "_out", _out_in_halves), mock.patch.object(moe_lib, "moe", moe):
        yield


def _moe_steps(cfg, params, prompts, steps: int, dev, tokens=None) -> dict:
    """Prefill and `steps` decode steps on `params` (whole, or this rank's
    shards under the active mesh), each step fed the greedy token of the
    step before, or column i of `tokens` (B, steps + 1) at step i: every
    step's logits (fp32), the greedy tokens, each layer's routing (sorted
    expert ids) at prefill and at each step, and the share of routed pairs
    dropped at prefill and over the decode steps."""
    import numpy as np
    import torch
    from repro_torch.models import api, base
    from repro_torch.parallel import tensor
    B, P = prompts.shape
    cache = base.tree_init(tensor.local_tree(cfg, api.abstract_cache(
        cfg, B, tensor.cache_len(cfg, P + steps + 8))), torch.Generator(device=dev), dev)
    logits, greedy, ids, keep = [], [], [], []
    pos = torch.full((B,), P, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        with _moe_recorded() as seen:
            out, cache = api.prefill(cfg, params, {"tokens": torch.as_tensor(
                prompts, device=dev).long()}, cache)
        prefill = (torch.stack(seen["ids"]).cpu().numpy().astype(np.uint8),
                   torch.cat(seen["keep"]))
        for i in range(steps + 1):
            tok = torch.argmax(out, dim=-1)
            logits.append(out.float().cpu().numpy())
            greedy.append(tok.cpu().numpy())
            if i == steps:
                break
            feed = tok if tokens is None else torch.as_tensor(tokens[:, i], device=dev)
            with _moe_recorded() as seen:
                out, cache = api.decode_step(cfg, params, feed[:, None].long(), pos, cache)
            ids.append(torch.stack(seen["ids"]).cpu().numpy().astype(np.uint8))
            keep.append(torch.cat(seen["keep"]))
            pos = pos + 1
    keep = torch.cat(keep)
    return {"logits": np.stack(logits), "tokens": np.stack(greedy, axis=1),
            "ids_prefill": prefill[0], "ids_decode": np.stack(ids),
            "drop_prefill": float((~prefill[1]).float().mean()),
            "drop_decode": float((~keep).float().mean())}


def _tp_moe_path(dev, wrappers, reset_launches, smi) -> None:
    """Phase 4(p): granite-moe-1b-a400m served split over a model axis of 2
    and trained split over a (2, 2) (data, model) mesh on the card (the
    constants' comment above `TP_MOE_STEPS`). The ranks run first, while
    this process holds nothing; then this process runs the same weights
    and steps unmeshed, and the witnesses, and holds the ranks' results to
    them. The MoE path reaches no TPU kernel: every count, the ranks' too,
    must stay 0."""
    import gc
    import shutil
    import numpy as np
    import torch
    from repro_torch.layers import moe
    from repro_torch.models import api, base
    from repro_torch.train import trainer

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tag = "tp moe path"
    reset_launches()
    root = ROOT / "build" / "tp_moe_path"
    shutil.rmtree(root, ignore_errors=True)
    (root / "serve").mkdir(parents=True)
    (root / "train").mkdir()
    print(f"[4 {tag}] this process holds {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
          f"allocated, {torch.cuda.memory_reserved(dev) / 1e9:.2f} GB reserved, while the "
          "ranks run")
    served = _run_ranks("--tp-moe-child", TP_RANKS, root / "serve", dev,
                        "MoE expert-parallel serving")
    n_ranks = math.prod(TP_TRAIN_RANKS)
    trained = _run_ranks("--tp-moe-train-child", n_ranks, root / "train", dev,
                         "MoE expert-parallel training")
    arrays = [dict(np.load(root / "serve" / f"rank{r}.npz")) for r in range(TP_RANKS)]
    for r, rec in enumerate(served):
        for label, c in rec["cases"].items():
            print(f"[4 {tag}] serving rank {r} ({label}) {c['arch']} {c['dtype']}: parameters "
                  f"{c['param_bytes'] / 1e9:.3f} GB a rank (experts {c['experts']}), KV cache "
                  f"{c['cache_bytes'] / 1e9:.4f} GB; dropped shares: prefill "
                  f"{c['drop_prefill']:.4f}, decode {c['drop_decode']:.4f}")
    for r, rec in enumerate(trained):
        for label, c in rec["cases"].items():
            print(f"[4 {tag}] training rank {r} {c['coordinate']} ({label}): state "
                  f"{c['state_bytes'] / 1e9:.3f} GB, peak {c['peak_bytes'] / 1e9:.2f} GB "
                  f"allocated, steps {', '.join(f'{v:.2f}' for v in c['step_s'])} s, losses "
                  f"{', '.join(f'{v:.6f}' for v in c['loss'])}, grad norms "
                  f"{', '.join(f'{v:.6f}' for v in c['grad_norm'])}")
    out = {"serve": served, "train": trained}

    # serving: (a) bf16 and (b) fp32 unmeshed on the split's tokens
    for label, dtype in (("a", "bfloat16"), ("b", "float32")):
        cfg = _tp_config(MOE_ARCH, dtype, TP_MOE_SERVED_LAYERS)
        prompts = _tp_prompts(cfg.vocab, DENSE_BATCH, DENSE_PROMPT)
        split = {k[2:]: v for k, v in arrays[0].items() if k.startswith(f"{label}/")}
        with torch.inference_mode():
            params = base.tree_init(api.abstract_params(cfg),
                                    torch.Generator(device=dev).manual_seed(SEED), dev)
        want = _moe_steps(cfg, params, prompts, TP_MOE_STEPS, dev, tokens=split["tokens"])
        wit = None
        if dtype == "bfloat16":
            with _moe_split_roundings():
                wit = _moe_steps(cfg, params, prompts, TP_MOE_STEPS, dev, tokens=split["tokens"])
        del params
        gc.collect()
        torch.cuda.empty_cache()
        scale = float(np.abs(want["logits"]).max())
        errs = [float(np.abs(a[f"{label}/logits"] - want["logits"]).max()) for a in arrays]
        same = all(np.array_equal(a[f"{label}/{k}"], arrays[0][f"{label}/{k}"])
                   for a in arrays for k in ("logits", "tokens"))
        flips = sum(int((split[k] != want[k]).any(-1).sum()) for k in ("ids_prefill",
                                                                        "ids_decode"))
        routings = sum(want[k].size // cfg.experts_per_token for k in ("ids_prefill",
                                                                       "ids_decode"))
        tokens_equal = int((split["tokens"] == want["tokens"]).sum())
        caps = [moe.capacity(n, cfg.experts_per_token, cfg.n_experts)
                for n in (DENSE_BATCH * DENSE_PROMPT, DENSE_BATCH)]
        drops = {k: (served[0]["cases"][label][k], want[k]) for k in ("drop_prefill",
                                                                      "drop_decode")}
        if wit is None:
            bound, witness = TP_FP32_RTOL, None
            held = (max(errs) <= bound * scale and flips == 0
                    and tokens_equal == want["tokens"].size
                    and all(a == b for a, b in drops.values()))
        else:
            witness = float(np.abs(wit["logits"] - want["logits"]).max()) / scale
            bound = max(TP_BF16_RTOL, TP_MOE_WITNESS * witness)
            held = max(errs) <= bound * scale
        print(f"[4 {tag}] ({label}) {MOE_ARCH} {cfg.n_layers} layers {dtype}, prefill "
              f"{DENSE_BATCH}x{DENSE_PROMPT} + {TP_MOE_STEPS} decode steps split over 2 ranks "
              f"vs unmeshed (fed the split's tokens): logits max |diff| "
              f"{', '.join(f'{e:.4g}' for e in errs)} (ranks 0, 1) of the largest |logit| "
              f"{scale:.4g}: {max(errs) / scale:.4g} (bound {bound:.4g}"
              + ("" if witness is None else f": the larger of {TP_BF16_RTOL} and "
                 f"{TP_MOE_WITNESS:g} x the witness's {witness:.4g}")
              + f"); {flips} of {routings} (token, layer) routings differ; greedy tokens "
              f"{tokens_equal} of {want['tokens'].size} equal; dropped at prefill "
              f"{drops['drop_prefill'][0]:.4f} split, {drops['drop_prefill'][1]:.4f} unmeshed "
              f"(capacity {caps[0]}), at decode {drops['drop_decode'][0]:.4f} split, "
              f"{drops['drop_decode'][1]:.4f} unmeshed (capacity {caps[1]}); ranks' logits "
              f"and tokens bitwise equal: {same}")
        out[label] = {"max_abs": errs, "logit_scale": scale, "bound_rel": bound,
                      "witness_rel": witness, "routings_differ": flips,
                      "routings": routings, "tokens_equal": tokens_equal, "drops": drops}
        if not (held and same):
            raise AssertionError(f"{MOE_ARCH} {dtype}: the split serving differs from "
                                 "unmeshed, or the ranks differ")
        del want, wit

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    def routers_equal(label) -> bool:
        """The router's copies on the model ranks of each data coordinate,
        after each step, bitwise equal."""
        by_data: dict = {}
        for r, rec in enumerate(trained):
            copies = torch.load(root / "train" / f"rank{r}_{label}_router.pt")
            by_data.setdefault(rec["cases"][label]["coordinate"]["data"], []).append(copies)
        return all(len(c) == TP_TRAIN_STEPS and all(torch.equal(a, b) for a, b in zip(c, cs[0]))
                   for cs in by_data.values() for c in cs)

    # training: (a) bf16 unmeshed from the same seed, and the witness
    cfg, shape, oc, kw = _tp_moe_train_setup("a")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    hist = trainer.run(cfg, shape, oc, trainer.TrainerConfig(
        ckpt_dir=str(root / "plain_a"), **kw), device=dev)[1]
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    gc.collect()
    torch.cuda.empty_cache()
    with _moe_split_roundings():
        wit = trainer.run(cfg, shape, oc, trainer.TrainerConfig(
            ckpt_dir=str(root / "witness_a"), **kw), device=dev)[1]
    gc.collect()
    torch.cuda.empty_cache()
    got = [rec["cases"]["a"] for rec in trained]
    lrel = max(rel(c["loss"], hist["loss"]) for c in got)
    grel = max(rel(c["grad_norm"], hist["grad_norm"]) for c in got)
    wl, wg = rel(wit["loss"], hist["loss"]), rel(wit["grad_norm"], hist["grad_norm"])
    lbound = max(TP_TRAIN_LOSS_RTOL, TP_MOE_WITNESS * wl)
    gbound = max(TP_TRAIN_GNORM_RTOL, TP_MOE_WITNESS * wg)
    same = all(c["loss"] == got[0]["loss"] for c in got)
    finite = all(math.isfinite(v) for c in got for v in c["loss"] + c["grad_norm"])
    routers = routers_equal("a")
    print(f"[4 {tag}] (train a) {MOE_ARCH} {cfg.n_layers} layers bf16, {TP_TRAIN_STEPS} steps "
          f"of {shape.global_batch}x{shape.seq_len} in {shape.accum} microbatches unmeshed: "
          f"{run_s:.1f} s, losses {', '.join(f'{v:.6f}' for v in hist['loss'])}, grad norms "
          f"{', '.join(f'{v:.6f}' for v in hist['grad_norm'])}, peak {peak / 1e9:.1f} GB; the "
          f"witness (the split's roundings): losses within {wl:.3g}, grad norms within "
          f"{wg:.3g}; split over 2x2 vs unmeshed: losses within {lrel:.3g} relative (bound "
          f"{lbound:.3g}: the larger of {TP_TRAIN_LOSS_RTOL} and {TP_MOE_WITNESS:g} x the "
          f"witness), grad norms within {grel:.3g} (bound {gbound:.3g}); finite: {finite}; "
          f"ranks' losses equal: {same}; the router's copies on the model ranks bitwise "
          f"equal after each step: {routers}")
    out["train a"] = {"loss": hist["loss"], "grad_norm": hist["grad_norm"],
                      "step_s": hist["step_s"], "peak_bytes": peak, "loss_rel": lrel,
                      "grad_norm_rel": grel, "witness_loss_rel": wl,
                      "witness_grad_norm_rel": wg, "loss_bound": lbound,
                      "grad_norm_bound": gbound, "routers_equal": routers}
    if not (finite and lrel <= lbound and grel <= gbound and same and routers):
        raise AssertionError(f"{MOE_ARCH}: the split bf16 training steps differ from "
                             "unmeshed, or the router's copies differ")
    del hist, wit

    # (ca), (cb) fp32, TF32 off: the unmeshed steps and the witness's, then
    # every rank's shards
    for label in ("ca", "cb"):
        cfg, shape, oc, kw = _tp_moe_train_setup(label)
        # the same microbatches: a MoE layer's capacity is its microbatch's
        with _moe_split_roundings():
            wstate = _fp32_steps(cfg, shape, oc, dev)[0]
        state, losses, norms, gmin = _fp32_steps(cfg, shape, oc, dev)
        got = [rec["cases"][label] for rec in trained]
        lrel = max(rel(c["loss"], losses) for c in got)
        grel = max(rel(c["grad_norm"], norms) for c in got)
        scale = max(t.abs().max().item() for _, t in base.tree_items(state["params"]))
        witness = _held_rel(state, wstate, gmin) / scale
        bound = max(TP_TRAIN_FP32_RTOL, TP_MOE_WITNESS * witness)
        del wstate
        shards = [torch.load(root / "train" / f"rank{r}_{label}.pt") for r in range(n_ranks)]
        worst, worst_any, n_sure, n_all = _shard_errors(
            cfg, state, gmin, shards, [rec["cases"][label]["coordinate"] for rec in trained],
            dev)
        routers = routers_equal(label)
        print(f"[4 {tag}] (train {label}) {MOE_ARCH} {cfg.n_layers} layers fp32 (TF32 off) "
              f"unmeshed: losses {', '.join(f'{v:.7f}' for v in losses)}, grad norms "
              f"{', '.join(f'{v:.7f}' for v in norms)}; split over 2x2 vs unmeshed: losses "
              f"within {lrel:.3g} relative, grad norms within {grel:.3g} (bound "
              f"{TP_TRAIN_FP32_RTOL}); every rank's parameter shards after {TP_TRAIN_STEPS} "
              f"steps within {worst / scale:.3g} of the largest |p| {scale:.4g} where |g| "
              f"stayed above {EPS_REGIME} ({n_sure / n_all:.4f} of the elements; bound "
              f"{bound:.3g}: the larger of {TP_TRAIN_FP32_RTOL} and {TP_MOE_WITNESS:g} x the "
              f"witness's {witness:.3g}), {worst_any:.3g} elsewhere (bound 2 lr "
              f"{2 * oc.lr:.3g}); the router's copies on the model ranks bitwise equal after "
              f"each step: {routers}")
        out[f"train {label}"] = {"loss": losses, "grad_norm": norms, "loss_rel": lrel,
                                 "grad_norm_rel": grel, "param_err_of_max": worst / scale,
                                 "param_err_any": worst_any, "witness_param_err_of_max": witness,
                                 "param_bound": bound, "share_held": n_sure / n_all,
                                 "routers_equal": routers}
        if not (lrel <= TP_TRAIN_FP32_RTOL and grel <= TP_TRAIN_FP32_RTOL and routers
                and worst <= bound * scale and worst_any <= 2 * oc.lr):
            raise AssertionError(f"{MOE_ARCH}: the split fp32 training steps differ from "
                                 "unmeshed, or the router's copies differ")
        del state, gmin, shards
        gc.collect()
        torch.cuda.empty_cache()

    counts = {name: w.launches for name, w in wrappers.items()}
    children = [rec["launches"] for rec in served + trained]
    print(f"[4 {tag}] launches {counts}, ranks {children} (the MoE path reaches no TPU "
          f"kernel)")
    if any(counts.values()) or any(any(c.values()) for c in children):
        raise AssertionError("a kernel launched on the MoE expert-parallel path")
    seconds = time.perf_counter() - t_phase
    shutil.rmtree(root, ignore_errors=True)
    print(f"[4 {tag}] phase {seconds:.1f} s")
    print(json.dumps({"tp_moe": out, "phase_s": seconds, "device": _device_name(dev),
                      "power": smi}))


def _tp_moe_child(rank: int, root: Path, device: str) -> int:
    """`chip_smoke.py --tp-moe-child RANK DIR DEVICE`, one of phase 4(p)'s two
    serving ranks, on the parent's DEVICE (both on the one card): a gloo
    world over a `FileStore` in DIR, a (1, 2) mesh under the serving rules,
    (a) a bf16 generate through `Engine` and the bf16 steps, (b) the fp32
    steps, on this rank's shards; writes DIR/rank<RANK>.{json,npz}."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import api, base
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tensor
    from repro_torch.serve.engine import Engine, ServeConfig

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lead = rank == 0
    dist.init_process_group("gloo", store=dist.FileStore(str(root / "store"), TP_RANKS),
                            rank=rank, world_size=TP_RANKS)
    rec, arrays = {"cases": {}}, {}
    try:
        mesh = make_mesh_compat((1, TP_RANKS), ("data", "model"), device=dev.type)
        if lead:
            print(f"[4 tp moe path] {mesh}, backend {dist.get_backend()}, world "
                  f"{dist.get_world_size()}, both ranks on {_device_name(dev)}")
        _rank_launches(reset=True)
        for label, dtype in (("a", "bfloat16"), ("b", "float32")):
            cfg = _tp_config(MOE_ARCH, dtype, TP_MOE_SERVED_LAYERS)
            prompts = _tp_prompts(cfg.vocab, DENSE_BATCH, DENSE_PROMPT)
            with shd.use_mesh(mesh, tensor.serving_rules()):
                t0 = time.perf_counter()
                params = _tp_shards(cfg, dev)
                fallbacks = shd.fallbacks()
                torch.cuda.synchronize(dev)
                c = {"arch": cfg.name, "dtype": dtype, "init_s": time.perf_counter() - t0,
                     "param_bytes": _tree_bytes(params),
                     "experts": list(params["layers"]["moe"]["wi"].shape),
                     "fallbacks": [list(f) for f in fallbacks]}
                sc = ServeConfig(max_len=DENSE_PROMPT + DENSE_NEW + 8, max_new_tokens=DENSE_NEW)
                cache_info = tensor.local_tree(cfg, api.abstract_cache(
                    cfg, DENSE_BATCH, tensor.cache_len(cfg, sc.max_len)))
                c.update({"cache_bytes": sum(i.dtype.itemsize * math.prod(i.shape)
                                             for _, i in base.tree_items(cache_info)),
                          "cache_shape": list(cache_info["k"].shape)})
                if label == "a":
                    engine = Engine(cfg, params, sc, device=dev)
                    engine.generate(prompts[:, :16])                 # warm-up
                    t0 = time.perf_counter()
                    gen = engine.generate(prompts)
                    wall = time.perf_counter() - t0
                    if (gen.shape != (DENSE_BATCH, DENSE_NEW) or gen.min() < 0
                            or gen.max() >= cfg.vocab):
                        raise AssertionError(f"{cfg.name}: bad tokens, shape {gen.shape}")
                    c.update({"generate_s": wall, "prefill_ms": engine.stats["prefill_s"] * 1e3,
                              "decode_ms_per_token":
                                  statistics.median(engine.stats["decode_s"]) * 1e3})
                    del engine
                got = _moe_steps(cfg, params, prompts, TP_MOE_STEPS, dev)
            c.update({k: got.pop(k) for k in ("drop_prefill", "drop_decode")})
            arrays.update({f"{label}/{k}": v for k, v in got.items()})
            rec["cases"][label] = c
            if lead:
                print(f"[4 tp moe path] ({label}) {cfg.name} {cfg.n_layers} layers {dtype} "
                      f"split over 2 ranks: shards drawn in {c['init_s']:.2f} s, experts "
                      f"{c['experts']} a rank, parameters {c['param_bytes'] / 1e9:.3f} GB a "
                      f"rank, cache {c['cache_shape']} a rank; fallbacks {c['fallbacks']}"
                      + ("" if label != "a" else
                         f"; {DENSE_BATCH}x{DENSE_PROMPT} + "
                         f"{DENSE_NEW} tokens: {c['generate_s']:.2f} s, prefill "
                         f"{c['prefill_ms']:.1f} ms, decode {c['decode_ms_per_token']:.2f} "
                         "ms/token (gloo through host memory)"))
            del params
            gc.collect()
            torch.cuda.empty_cache()
        rec["launches"] = _rank_launches()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (root / f"rank{rank}.json").write_text(json.dumps(rec))
    np.savez(root / f"rank{rank}.npz", **arrays)
    return 0


def _tp_moe_train_setup(label: str):
    """(cfg, shape, OptConfig, TrainerConfig kwargs) of phase 4(p)'s
    training run `label`."""
    from repro_torch.models import base
    from repro_torch.optim import adamw
    arch, layers, dtype = TP_MOE_TRAIN_CASES[label]
    B, S, accum = TP_TRAIN_SHAPE
    shape = base.ShapeConfig("tp_moe_train", S, B, "train", accum=accum)
    oc = adamw.OptConfig(lr=TP_TRAIN_LR, warmup_steps=2, total_steps=TP_TRAIN_STEPS)
    return _tp_config(arch, dtype, layers), shape, oc, {
        "total_steps": TP_TRAIN_STEPS, "ckpt_every": TP_TRAIN_STEPS + 1, "seed": SEED,
        "remat": "full"}


def _tp_moe_train_child(rank: int, root: Path, device: str) -> int:
    """`chip_smoke.py --tp-moe-train-child RANK DIR DEVICE`, one of phase
    4(p)'s four training ranks, on the parent's DEVICE (all on the one
    card): a gloo world over a `FileStore` in DIR, a (2, 2) (data, model)
    mesh under the trainer's rules, `trainer.run` of (a), (ca) and (cb) on
    this rank's shards; writes DIR/rank<RANK>.json, the router after each
    step to DIR/rank<RANK>_<label>_router.pt and (ca)'s and (cb)'s final
    parameter shards to DIR/rank<RANK>_<label>.pt."""
    import gc
    import os
    from unittest import mock
    # four ranks share the card with this script's parent (see
    # `_tp_ssm_train_child`)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import api, base
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tensor
    from repro_torch.train import trainer

    dev = torch.device(device)
    torch.cuda.set_per_process_memory_fraction(TP_MOE_TRAIN_MEMORY, dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_ranks = math.prod(TP_TRAIN_RANKS)
    lead = rank == 0
    dist.init_process_group("gloo", store=dist.FileStore(str(root / "store"), n_ranks),
                            rank=rank, world_size=n_ranks)
    rec = {"cases": {}}
    routers: list = []
    make_train_step = trainer.step_lib.make_train_step

    def recording(*args, **kw):
        train_step = make_train_step(*args, **kw)

        def run(state, batch):
            state, metrics = train_step(state, batch)
            routers.append(state["params"]["layers"]["moe"]["router"].detach().cpu().clone())
            return state, metrics
        return run

    try:
        mesh = make_mesh_compat(TP_TRAIN_RANKS, ("data", "model"), device=dev.type)
        coordinate = {a: mesh.coordinate(a) for a in mesh.shape}
        if lead:
            print(f"[4 tp moe path] {mesh}, backend {dist.get_backend()}, world "
                  f"{dist.get_world_size()}, all ranks on {_device_name(dev)}")
        _rank_launches(reset=True)
        for label in TP_MOE_TRAIN_CASES:
            cfg, shape, oc, kw = _tp_moe_train_setup(label)
            tc = trainer.TrainerConfig(ckpt_dir=str(root / f"ckpt_{label}_{rank}"), **kw)
            torch.cuda.reset_peak_memory_stats(dev)
            routers.clear()
            t0 = time.perf_counter()
            with shd.use_mesh(mesh, tensor.training_rules(mesh)), \
                    mock.patch.object(trainer.step_lib, "make_train_step", recording):
                state, hist = trainer.run(cfg, shape, oc, tc, device=dev)
            torch.cuda.synchronize(dev)
            with shd.use_mesh(mesh, tensor.training_rules(mesh)):
                tensor.local_tree(cfg, api.abstract_params(cfg), tensor.TRAIN_AXES)
                fallbacks = shd.fallbacks()
            moe = state["params"]["layers"]["moe"]
            c = {"arch": cfg.name, "dtype": cfg.compute_dtype, "layers": cfg.n_layers,
                 "coordinate": coordinate, "run_s": time.perf_counter() - t0,
                 "state_bytes": _tree_bytes(state),
                 "peak_bytes": torch.cuda.max_memory_allocated(dev),
                 "peak_reserved": torch.cuda.max_memory_reserved(dev),
                 "shapes": {k: list(moe[k].shape) for k in ("router", "wi", "wo")},
                 "loss": hist["loss"], "grad_norm": hist["grad_norm"],
                 "step_s": hist["step_s"], "fallbacks": [list(f) for f in fallbacks]}
            rec["cases"][label] = c
            torch.save(list(routers), root / f"rank{rank}_{label}_router.pt")
            if lead:
                print(f"[4 tp moe path] (train {label}) {cfg.name} {cfg.n_layers} layers "
                      f"{cfg.compute_dtype}, {TP_TRAIN_STEPS} steps of "
                      f"{shape.global_batch}x{shape.seq_len} in {shape.accum} microbatches, "
                      f"remat full, split over {mesh.shape}: {c['run_s']:.1f} s, steps "
                      f"{', '.join(f'{v:.2f}' for v in c['step_s'])} s (gloo through host "
                      f"memory); a rank's router, wi, wo {c['shapes']}, state "
                      f"{c['state_bytes'] / 1e9:.3f} GB a rank (whole "
                      f"{12 * base.count_params(api.abstract_params(cfg)) / 1e9:.1f} GB of "
                      f"parameters, m and v), peak {c['peak_bytes'] / 1e9:.2f} GB allocated, "
                      f"{c['peak_reserved'] / 1e9:.2f} GB reserved; fallbacks "
                      f"{c['fallbacks']}")
            if label.startswith("c"):
                torch.save({base.keystr(p): t.cpu() for p, t in
                            base.tree_items(state["params"])}, root / f"rank{rank}_{label}.pt")
            del state, hist, moe
            gc.collect()
            torch.cuda.empty_cache()
        rec["launches"] = _rank_launches()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (root / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


def _w8_tree(cfg, dev, shard: bool):
    """The whole tree drawn leaf by leaf from the seed, as `tree_init`
    draws it, each matmul leaf quantized whole (`launch.serve --w8`'s
    `quantize_params_for_serving(..., min_size=0)`) and, with `shard`, cut
    to this rank's shards under the active mesh."""
    import torch
    from repro_torch.models import api, base
    from repro_torch.parallel import tensor
    from repro_torch.quantized import apply as qapply
    gen = torch.Generator(device=dev).manual_seed(SEED)
    paths, leaves = [], []
    with torch.inference_mode():
        for path, info in base.tree_items(api.abstract_params(cfg)):
            tree = base.tree_init(base.tree_unflatten([path], [info]), gen, dev)
            tree = qapply.quantize_params_for_serving(cfg, tree, min_size=0)
            if shard:
                tree = tensor.shard_params(cfg, tree)
            for p, leaf in base.tree_items(tree):
                paths.append(p)
                leaves.append(leaf)
            del tree
    return base.tree_unflatten(paths, leaves)


def _engine_record(engine, prompts, keep: int, moe: bool = False) -> dict:
    """`engine.generate(prompts)`, keeping the logits (fp32, numpy) that
    its first `keep` calls of prefill and decode return: the rows this
    rank serves. With `moe`, each MoE layer's routing (every token's
    expert ids, sorted) and the pairs each call drops."""
    from unittest import mock
    import numpy as np
    from repro_torch.models import api
    logits = []

    def kept(fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if len(logits) < keep:
                logits.append(out[0].float().cpu().numpy())
            return out
        return call

    with mock.patch.object(api, "prefill", kept(api.prefill)), \
            mock.patch.object(api, "decode_step", kept(api.decode_step)), \
            (_moe_recorded() if moe else contextlib.nullcontext()) as seen:
        t0 = time.perf_counter()
        tokens = engine.generate(prompts)
        wall = time.perf_counter() - t0
    rec = {"tokens": tokens, "logits": np.stack(logits), "wall": wall}
    if moe:
        rec["ids"] = [t.cpu().numpy().astype(np.uint8) for t in seen["ids"]]
        rec["dropped"] = [int((~k).sum()) for k in seen["keep"]]
    return rec


@contextlib.contextmanager
def _dense_split_roundings(parts: int = 2, heads: bool = True):
    """Within: every attention layer takes its output contraction (unless
    not `heads`), and every MLP its down projection, in `parts` parts (of
    the heads, of the ffn), each rounded to the compute dtype and then
    added: the roundings a split over `parts` model ranks adds, unmeshed
    (phase 4(q)'s witness for the dense family; 4(r)'s, whose heads stay
    whole, in three)."""
    from unittest import mock
    from repro_torch.layers import attention as attn
    from repro_torch.layers import mlp as mlp_lib
    real = mlp_lib.mlp

    def half(w, dim: int, r: int, last: bool):
        """Part r of a leaf along `dim`; a W8 leaf's scales with it where
        `dim` is the last (output) dim."""
        def cut(t):
            n = t.shape[dim] // parts
            return t.narrow(dim, r * n, n)
        if isinstance(w, dict):
            return {"q": cut(w["q"]), "s": cut(w["s"]) if last else w["s"]}
        return cut(w)

    def mlp(cfg, p, x, group=None, seq=None):
        outs = [real(cfg, {k: half(v, -1, r, True) if k in ("wi", "wg") else
                            half(v, -2, r, False) for k, v in p.items()}, x)
                 for r in range(parts)]
        return functools.reduce(lambda a, b: a + b, outs)

    with contextlib.ExitStack() as stack:
        if heads:
            stack.enter_context(mock.patch.object(attn, "_out", _out_in_halves))
        stack.enter_context(mock.patch.object(mlp_lib, "mlp", mlp))
        yield


def _w8_dp_path(dev, reset_launches, smi) -> dict:
    """Phase 4(q): W8 checkpoints served under a model axis of 2 with the
    batch over a data axis of 2 on the card (the constants' comment above
    `W8_DP_RANKS`). Four `--w8-dp-child` ranks serve first, each counting
    its own kernel launches in each measured generate, while this process
    holds nothing; then this process serves the same weights unmeshed
    through `Engine` and holds the ranks' results to it. Returns the ranks'
    ssd_scan launches (and tensor-core launches) in their measured
    generates."""
    import gc
    import shutil
    import numpy as np
    import torch
    from repro_torch.models import api, base
    from repro_torch.serve.engine import Engine, ServeConfig

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tag = "w8 dp path"
    reset_launches()
    root = ROOT / "build" / "w8_dp_path"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    n_ranks = math.prod(W8_DP_RANKS)
    ranks = _run_ranks("--w8-dp-child", n_ranks, root, dev, "W8 data-parallel serving")
    arrays = [dict(np.load(root / f"rank{r}.npz")) for r in range(n_ranks)]
    served = {"ssd_scan": 0, "ssd_scan mma": 0}
    for r, rec in enumerate(ranks):
        for label, c in rec["cases"].items():
            counts = dict(c["launches"])
            ssd, mma = counts.pop("ssd_scan"), counts.pop("ssd_scan mma")
            arch, layers, dtype, _ = W8_DP_CASES[label]
            want = (0 if arch != "mamba2-2.7b" else layers, layers if label == "b" else 0)
            print(f"[4 {tag}] rank {r} {c['coordinate']} ({label}) {arch} {layers} layers "
                  f"{dtype}{' W8' if c['w8'] else ''}: parameters {c['param_bytes'] / 1e9:.3f} "
                  f"GB a rank, rows {c['cache_rows']} a rank; generate {c['generate_s']:.2f} s "
                  f"(gloo through host memory); {mma} of {ssd} ssd_scan launches on the "
                  f"tensor cores in the measured generate (one prefill), other launches "
                  f"{counts}")
            if (ssd, mma) != want or any(counts.values()):
                raise AssertionError(f"rank {r} ({label}): want {want[0]} ssd_scan launches, "
                                     f"{want[1]} on the tensor cores, and no other kernel")
            if label.startswith("b"):
                served["ssd_scan"] += ssd
                served["ssd_scan mma"] += mma
    out = {"ranks": ranks}
    rows = [slice(c * DENSE_BATCH // W8_DP_RANKS[0], (c + 1) * DENSE_BATCH // W8_DP_RANKS[0])
            for c in (rec["coordinate"]["data"] for rec in ranks)]
    sc = ServeConfig(max_len=DENSE_PROMPT + DENSE_NEW + 8, max_new_tokens=DENSE_NEW)
    for label, (arch, layers, dtype, w8) in W8_DP_CASES.items():
        cfg = _tp_config(arch, dtype, layers)
        prompts = _tp_prompts(cfg.vocab, DENSE_BATCH, DENSE_PROMPT)
        if w8:
            params = _w8_tree(cfg, dev, shard=False)
        else:
            with torch.inference_mode():
                params = base.tree_init(api.abstract_params(cfg),
                                        torch.Generator(device=dev).manual_seed(SEED), dev)
        keep = 1 if dtype == "bfloat16" else TP_FP32_STEPS + 1
        want = _engine_record(Engine(cfg, params, sc, device=dev), prompts, keep,
                              moe=arch == MOE_ARCH)
        same = all(np.array_equal(a[f"{label}/tokens"], arrays[0][f"{label}/tokens"])
                   for a in arrays)
        equal = int((arrays[0][f"{label}/tokens"] == want["tokens"]).sum())
        scale = float(np.abs(want["logits"]).max())
        errs = [float(np.abs(a[f"{label}/logits"] - want["logits"][:, rows[r]]).max())
                for r, a in enumerate(arrays)]
        witness, flips, drops = None, None, None
        if dtype == "bfloat16":
            # the dense family's split roundings; the ssm family's plain route
            with torch.inference_mode(), (_dense_split_roundings() if arch == DENSE_ARCH
                                          else contextlib.nullcontext()):
                cache = base.tree_init(api.abstract_cache(cfg, DENSE_BATCH, sc.max_len),
                                       torch.Generator(device=dev), dev)
                wit, _ = api.prefill(cfg, params, {"tokens": torch.as_tensor(
                    prompts, device=dev).long()}, cache, use_kernel=arch == DENSE_ARCH)
            witness = float(np.abs(wit.float().cpu().numpy() - want["logits"][0]).max()) / scale
            del cache, wit
            bound = max(TP_BF16_RTOL, W8_DP_WITNESS * witness)
            held = max(errs) <= bound * scale
        else:
            bound = TP_FP32_RTOL
            held = max(errs) <= bound * scale and equal == want["tokens"].size
        if arch == MOE_ARCH:
            by_data = {rec["coordinate"]["data"]: a for rec, a in zip(ranks, arrays)
                       if rec["coordinate"]["model"] == 0}
            split = [by_data[c] for c in sorted(by_data)]
            calls = len(want["ids"])
            flips = sum(int((np.concatenate([a[f"{label}/ids{i}"] for a in split])
                             != want["ids"][i]).any(-1).sum()) for i in range(calls))
            drops = (int(sum(a[f"{label}/dropped"].sum() for a in split)),
                     int(sum(want["dropped"])))
            held = held and flips == 0 and np.array_equal(
                sum(a[f"{label}/dropped"] for a in split), np.array(want["dropped"]))
        print(f"[4 {tag}] ({label}) {arch} {layers} layers {dtype}{' W8' if w8 else ''}, "
              f"{DENSE_BATCH}x{DENSE_PROMPT} + {DENSE_NEW} over (data 2, model 2) vs unmeshed: "
              f"the logits of {keep} call(s) on each rank's rows max |diff| "
              f"{', '.join(f'{e:.4g}' for e in errs)} (ranks 0-3) of the largest |logit| "
              f"{scale:.4g}: {max(errs) / scale:.4g} (bound {bound:.4g}"
              + ("" if witness is None else f": the larger of {TP_BF16_RTOL} and "
                 f"{W8_DP_WITNESS:g} x the witness's {witness:.4g}")
              + f"); greedy tokens {equal} of {want['tokens'].size} equal unmeshed"
              + ("" if flips is None else f"; {flips} (token, layer) routings differ; "
                 f"dropped pairs {drops[0]} over the data ranks, {drops[1]} unmeshed")
              + f"; the four ranks' tokens bitwise equal: {same}")
        out[label] = {"max_abs": errs, "logit_scale": scale, "bound_rel": bound,
                      "witness_rel": witness, "tokens_equal": equal,
                      "routings_differ": flips, "dropped": drops,
                      "unmeshed_generate_s": want["wall"]}
        if not (held and same):
            raise AssertionError(f"{arch} ({label}): the split serving differs from unmeshed, "
                                 "or the ranks differ")
        del params, want
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    seconds = time.perf_counter() - t_phase
    shutil.rmtree(root, ignore_errors=True)
    print(f"[4 {tag}] the ranks' ssd_scan launches in their measured generates: "
          f"{served['ssd_scan']} ({served['ssd_scan mma']} on the tensor cores)")
    print(f"[4 {tag}] phase {seconds:.1f} s")
    print(json.dumps({"w8_dp": out, "phase_s": seconds, "device": _device_name(dev),
                      "power": smi}))
    return served


def _w8_dp_child(rank: int, root: Path, device: str) -> int:
    """`chip_smoke.py --w8-dp-child RANK DIR DEVICE`, one of phase 4(q)'s
    four ranks, on the parent's DEVICE (all on the one card): a gloo world
    over a `FileStore` in DIR, a (2, 2) (data, model) mesh under the
    serving rules, each case's `Engine.generate` on this rank's shards
    (W8 quantized whole, then cut) and rows, every launch count set to 0
    just before each measured generate and read just after; writes
    DIR/rank<RANK>.{json,npz}."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tensor
    from repro_torch.serve.engine import Engine, ServeConfig

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_ranks = math.prod(W8_DP_RANKS)
    lead = rank == 0
    dist.init_process_group("gloo", store=dist.FileStore(str(root / "store"), n_ranks),
                            rank=rank, world_size=n_ranks)
    rec, arrays = {"cases": {}}, {}
    try:
        mesh = make_mesh_compat(W8_DP_RANKS, ("data", "model"), device=dev.type)
        coordinate = rec["coordinate"] = {a: mesh.coordinate(a) for a in mesh.shape}
        if lead:
            print(f"[4 w8 dp path] {mesh}, backend {dist.get_backend()}, world "
                  f"{dist.get_world_size()}, all ranks on {_device_name(dev)}")
        sc = ServeConfig(max_len=DENSE_PROMPT + DENSE_NEW + 8, max_new_tokens=DENSE_NEW)
        for label, (arch, layers, dtype, w8) in W8_DP_CASES.items():
            cfg = _tp_config(arch, dtype, layers)
            prompts = _tp_prompts(cfg.vocab, DENSE_BATCH, DENSE_PROMPT)
            with shd.use_mesh(mesh, tensor.serving_rules(mesh)):
                t0 = time.perf_counter()
                params = _w8_tree(cfg, dev, shard=True) if w8 else _tp_shards(cfg, dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                init_s = time.perf_counter() - t0
                engine = Engine(cfg, params, sc, device=dev)
                _rank_launches(reset=True)
                got = _engine_record(engine, prompts,
                                     1 if dtype == "bfloat16" else TP_FP32_STEPS + 1,
                                     moe=arch == MOE_ARCH)
                launches = _rank_launches()
                fallbacks = shd.fallbacks()
            if got["tokens"].shape != (DENSE_BATCH, DENSE_NEW) or got["tokens"].min() < 0 \
                    or got["tokens"].max() >= cfg.vocab:
                raise AssertionError(f"{arch} ({label}): bad tokens, shape "
                                     f"{got['tokens'].shape}")
            arrays[f"{label}/tokens"], arrays[f"{label}/logits"] = got["tokens"], got["logits"]
            if "ids" in got:
                arrays.update({f"{label}/ids{i}": a for i, a in enumerate(got["ids"])})
                arrays[f"{label}/dropped"] = np.array(got["dropped"], dtype=np.int64)
            c = {"arch": arch, "dtype": dtype, "w8": w8, "layers": layers,
                 "coordinate": coordinate, "init_s": init_s,
                 "param_bytes": _tree_bytes(engine.params),
                 "cache_rows": int(got["logits"].shape[1]), "generate_s": got["wall"],
                 "prefill_ms": engine.stats["prefill_s"] * 1e3,
                 "decode_ms_per_token": statistics.median(engine.stats["decode_s"]) * 1e3,
                 "fallbacks": [list(f) for f in fallbacks], "launches": launches}
            rec["cases"][label] = c
            if lead:
                print(f"[4 w8 dp path] ({label}) {arch} {layers} layers {dtype}"
                      f"{' W8' if w8 else ''} over {mesh.shape}: shards drawn (and quantized "
                      f"whole) in {init_s:.2f} s, parameters {c['param_bytes'] / 1e9:.3f} GB "
                      f"a rank; {DENSE_BATCH}x{DENSE_PROMPT} + {DENSE_NEW} tokens, "
                      f"{c['cache_rows']} rows a rank: {c['generate_s']:.2f} s, prefill "
                      f"{c['prefill_ms']:.1f} ms, decode {c['decode_ms_per_token']:.2f} "
                      f"ms/token (gloo through host memory); fallbacks {c['fallbacks']}")
            del params, engine, got
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (root / f"rank{rank}.json").write_text(json.dumps(rec))
    np.savez(root / f"rank{rank}.npz", **arrays)
    return 0


def _sp_path(dev, wrappers, reset_launches, smi) -> None:
    """Phase 4(r): sequence parallelism between layers on a (1, 3) mesh on
    the card (the constants' comment above `SP_RANKS`). Three `--sp-child`
    ranks run the split paths first, while this process holds nothing;
    then this process runs the same weights unmeshed and holds the ranks'
    results to them. The dense path reaches no TPU kernel: every count,
    the ranks' too, must stay 0."""
    import gc
    import shutil
    import numpy as np
    import torch
    from repro_torch.layers.attention import FLASH_MIN_SEQ
    from repro_torch.models import api, base

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tag = "sp path"
    reset_launches()
    root = ROOT / "build" / "sp_path"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ranks = _run_ranks("--sp-child", SP_RANKS, root, dev, "sequence-parallel")
    arrays = [dict(np.load(root / f"rank{r}.npz")) for r in range(SP_RANKS)]
    for r, rec in enumerate(ranks):
        for label, c in rec["cases"].items():
            print(f"[4 {tag}] rank {r} ({label}) {c['shape']}: hidden between layers "
                  f"{c['hidden_bytes']} bytes of the whole {c['whole_hidden_bytes']}, "
                  f"collectives {c['collectives']}, peak {c['peak_bytes'] / 1e9:.3f} GB")
        d = rec["train"]
        print(f"[4 {tag}] rank {r} (d) training: state {d['state_bytes'] / 1e9:.3f} GB, peak "
              f"{d['peak_bytes'] / 1e9:.2f} GB, steps {', '.join(f'{v:.2f}' for v in d['step_s'])}"
              f" s, losses {', '.join(f'{v:.7f}' for v in d['loss'])}")
    out = {"ranks": ranks}
    for label, (B, P, _) in SP_SERVED.items():
        offsets = [rec["cases"][label]["q_offsets"] for rec in ranks]
        flash = P >= FLASH_MIN_SEQ
        if (any(rec["cases"][label]["hidden_bytes"] * SP_RANKS
                != rec["cases"][label]["whole_hidden_bytes"] for rec in ranks)
                or offsets != ([[r * P // SP_RANKS] for r in range(SP_RANKS)] if flash
                               else [[]] * SP_RANKS)):
            raise AssertionError(f"({label}): a rank's hidden state is not its third of the "
                                 f"positions, or flash did not take its queries: {offsets}")

    # (a), (b) bf16: the prefill's last logits against unmeshed and a witness
    cfg = _tp_config(DENSE_ARCH, "bfloat16", SP_LAYERS)
    with torch.inference_mode():
        params = base.tree_init(api.abstract_params(cfg),
                                torch.Generator(device=dev).manual_seed(SEED), dev)
    for label, (B, P, new) in SP_SERVED.items():
        tokens = torch.as_tensor(_tp_prompts(cfg.vocab, B, P), device=dev).long()
        runs = []
        for witness in (False, True):
            with torch.inference_mode(), (_dense_split_roundings(SP_RANKS, heads=False)
                                          if witness else contextlib.nullcontext()):
                cache = base.tree_init(api.abstract_cache(cfg, B, P), torch.Generator(
                    device=dev), dev)
                runs.append(api.prefill(cfg, params, {"tokens": tokens}, cache)[0]
                            .float().cpu().numpy())
                del cache
        want, wit = runs
        scale = float(np.abs(want).max())
        errs = [float(np.abs(a[f"{label}/prefill"] - want).max()) for a in arrays]
        wrel = float(np.abs(wit - want).max()) / scale
        bound = max(TP_BF16_RTOL, SP_WITNESS * wrel)
        same = all(np.array_equal(a[f"{label}/prefill"], arrays[0][f"{label}/prefill"])
                   and np.array_equal(a[f"{label}/tokens"], arrays[0][f"{label}/tokens"])
                   for a in arrays)
        c = ranks[0]["cases"][label]
        print(f"[4 {tag}] ({label}) {DENSE_ARCH} {SP_LAYERS} layers bf16 {B}x{P} + {new}, "
              f"split over {SP_RANKS} ranks by the sequence: generate {c['generate_s']:.2f} s, "
              f"prefill {c['prefill_ms']:.1f} ms, decode {c['decode_ms_per_token']:.2f} "
              f"ms/token (gloo through host memory); flash_attention calls a prefill "
              f"{c['flash_calls']} a rank, at query offsets "
              f"{[rec['cases'][label]['q_offsets'] for rec in ranks]}; last logits vs unmeshed "
              f"max |diff| {', '.join(f'{e:.4g}' for e in errs)} of the largest |logit| "
              f"{scale:.4g}: {max(errs) / scale:.4g} (bound {bound:.4g}: the larger of "
              f"{TP_BF16_RTOL} and {SP_WITNESS} x the witness's {wrel:.4g}); the ranks' "
              f"logits and tokens bitwise equal: {same}")
        out[label] = {"prefill_max_abs": errs, "logit_scale": scale, "witness_rel": wrel,
                      "bound": bound}
        if max(errs) > bound * scale or not same:
            raise AssertionError(f"({label}): the sequence-split prefill differs from unmeshed")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) fp32, TF32 off: the prefill and greedy steps
    cfg = _tp_config(DENSE_ARCH, "float32", TP_FP32_LAYERS)
    B, P, _ = SP_SERVED["a"]
    with torch.inference_mode():
        params = base.tree_init(api.abstract_params(cfg),
                                torch.Generator(device=dev).manual_seed(SEED), dev)
        cache = base.tree_init(api.abstract_cache(cfg, B, P + TP_FP32_STEPS + 8),
                               torch.Generator(device=dev), dev)
    want = _tp_steps(cfg, params, cache, _tp_prompts(cfg.vocab, B, P), TP_FP32_STEPS, dev)
    scale = float(np.abs(want["logits"]).max())
    errs = [float(np.abs(a["c/logits"] - want["logits"]).max()) for a in arrays]
    equal = all(np.array_equal(a["c/tokens"], want["tokens"]) for a in arrays)
    print(f"[4 {tag}] (c) {DENSE_ARCH} {TP_FP32_LAYERS} layers fp32 (TF32 off) prefill {B}x{P} "
          f"+ {TP_FP32_STEPS} steps, split vs unmeshed: max |diff| "
          f"{', '.join(f'{e:.3g}' for e in errs)} of the largest |logit| {scale:.4g}: "
          f"{max(errs) / scale:.3g} (bound {TP_FP32_RTOL}); greedy tokens "
          f"{'equal' if equal else 'differ'}")
    out["c"] = {"max_abs": errs, "logit_scale": scale}
    if max(errs) > TP_FP32_RTOL * scale or not equal:
        raise AssertionError("(c): the fp32 sequence-split path differs from unmeshed")
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()

    # (d) fp32 training: the unmeshed steps with each element's smallest |g|
    cfg, shape, oc = _sp_train_setup()
    state, losses, norms, gmin = _fp32_steps(cfg, shape, oc, dev)

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    lrel = max(rel(rec["train"]["loss"], losses) for rec in ranks)
    grel = max(rel(rec["train"]["grad_norm"], norms) for rec in ranks)
    scale = max(t.abs().max().item() for _, t in base.tree_items(state["params"]))
    shards = [torch.load(root / f"rank{r}_d.pt") for r in range(SP_RANKS)]
    worst, worst_any, n_sure, n_all = _shard_errors(
        cfg, state, gmin, shards, [rec["train"]["coordinate"] for rec in ranks], dev,
        (1, SP_RANKS))
    del shards
    print(f"[4 {tag}] (d) {DENSE_ARCH} {cfg.n_layers} layers fp32 (TF32 off), {TP_TRAIN_STEPS} "
          f"steps of {shape.global_batch}x{shape.seq_len} in {shape.accum} microbatches "
          f"unmeshed: losses {', '.join(f'{v:.7f}' for v in losses)}, grad norms "
          f"{', '.join(f'{v:.7f}' for v in norms)}; split over {SP_RANKS} by the sequence vs "
          f"unmeshed: losses within {lrel:.3g} relative, grad norms within {grel:.3g} (bound "
          f"{TP_TRAIN_FP32_RTOL}); every rank's parameters after {TP_TRAIN_STEPS} steps within "
          f"{worst / scale:.3g} of the largest |p| {scale:.4g} where |g| stayed above "
          f"{EPS_REGIME} ({n_sure / n_all:.4f} of the elements; bound {TP_TRAIN_FP32_RTOL}), "
          f"{worst_any:.3g} elsewhere (bound 2 lr {2 * oc.lr:.3g})")
    out["d"] = {"loss": losses, "grad_norm": norms, "loss_rel": lrel, "grad_norm_rel": grel,
                "param_err_of_max": worst / scale, "param_err_any": worst_any,
                "share_held": n_sure / n_all}
    if not (lrel <= TP_TRAIN_FP32_RTOL and grel <= TP_TRAIN_FP32_RTOL
            and worst <= TP_TRAIN_FP32_RTOL * scale and worst_any <= 2 * oc.lr):
        raise AssertionError("(d): the sequence-split training steps differ from unmeshed")
    del state, gmin
    gc.collect()
    torch.cuda.empty_cache()

    counts = {name: w.launches for name, w in wrappers.items()}
    children = [rec["launches"] for rec in ranks]
    print(f"[4 {tag}] launches {counts}, ranks {children} (the dense path reaches no TPU "
          f"kernel)")
    if any(counts.values()) or any(any(c.values()) for c in children):
        raise AssertionError("a kernel launched on the sequence-split path")
    seconds = time.perf_counter() - t_phase
    shutil.rmtree(root, ignore_errors=True)
    print(f"[4 {tag}] phase {seconds:.1f} s")
    print(json.dumps({"sp": out, "phase_s": seconds, "device": _device_name(dev),
                      "power": smi}))


def _sp_train_setup():
    """(cfg, shape, OptConfig) of phase 4(r)'s training (d)."""
    import dataclasses
    from repro_torch.models import base
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(_tp_config(DENSE_ARCH, "float32"), n_layers=SP_TRAIN_LAYERS)
    B, S, accum = SP_TRAIN_SHAPE
    return (cfg, base.ShapeConfig("sp_train", S, B, "train", accum=accum),
            adamw.OptConfig(lr=TP_TRAIN_LR, warmup_steps=2, total_steps=TP_TRAIN_STEPS))


@contextlib.contextmanager
def _seen_by_attention():
    """Within: each attention input's bytes and each flash_attention call's
    query offset, appended to the lists yielded."""
    from unittest import mock
    from repro_torch.layers import attention
    seen = {"bytes": [], "q_offsets": []}
    attn, flash = attention.attention, attention.flash_attention

    def attended(cfg, p, x, *args, **kw):
        seen["bytes"].append(x.numel() * x.element_size())
        return attn(cfg, p, x, *args, **kw)

    def flashed(*args, **kw):
        seen["q_offsets"].append(kw.get("q_offset", 0))
        return flash(*args, **kw)

    with mock.patch.object(attention, "attention", attended), \
            mock.patch.object(attention, "flash_attention", flashed):
        yield seen


def _sp_child(rank: int, root: Path, device: str) -> int:
    """`chip_smoke.py --sp-child RANK DIR DEVICE`, one of phase 4(r)'s three
    ranks, on the parent's DEVICE (all on the one card): a gloo world over
    a `FileStore` in DIR, a (1, 3) mesh under the serving rules for (a),
    (b) and (c) and the trainer's for (d), on this rank's shards; writes
    DIR/rank<RANK>.{json,npz} and (d)'s final parameters to
    DIR/rank<RANK>_d.pt."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import cost
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import api, base
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tensor
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.train import trainer

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lead = rank == 0
    dist.init_process_group("gloo", store=dist.FileStore(str(root / "store"), SP_RANKS),
                            rank=rank, world_size=SP_RANKS)
    rec, arrays = {"cases": {}}, {}
    try:
        mesh = make_mesh_compat((1, SP_RANKS), ("data", "model"), device=dev.type)
        if lead:
            print(f"[4 sp path] {mesh}, backend {dist.get_backend()}, world "
                  f"{dist.get_world_size()}, all ranks on {_device_name(dev)}")
        cfg = _tp_config(DENSE_ARCH, "bfloat16", SP_LAYERS)
        with shd.use_mesh(mesh, tensor.serving_rules()):
            params = _tp_shards(cfg, dev)
            fallbacks = [list(f) for f in shd.fallbacks()]
            for label, (B, P, new) in SP_SERVED.items():
                prompts = _tp_prompts(cfg.vocab, B, P)
                engine = Engine(cfg, params, ServeConfig(max_len=P + new + 8,
                                                         max_new_tokens=new), device=dev)
                engine.generate(prompts)                         # warm-up
                t0 = time.perf_counter()
                gen = engine.generate(prompts)
                wall = time.perf_counter() - t0
                cache = base.tree_init(tensor.local_tree(cfg, api.abstract_cache(
                    cfg, B, tensor.cache_len(cfg, P))), torch.Generator(device=dev), dev)
                torch.cuda.reset_peak_memory_stats(dev)
                with torch.inference_mode(), _seen_by_attention() as seen, \
                        cost.Counter() as counter:
                    last, _ = api.prefill(cfg, engine.params, {"tokens": torch.as_tensor(
                        prompts, device=dev).long()}, cache)
                arrays[f"{label}/prefill"] = last.float().cpu().numpy()
                arrays[f"{label}/tokens"] = gen
                c = {"shape": f"bf16 {B}x{P} + {new}", "generate_s": wall,
                     "prefill_ms": engine.stats["prefill_s"] * 1e3,
                     "decode_ms_per_token": statistics.median(engine.stats["decode_s"]) * 1e3,
                     "hidden_bytes": seen["bytes"][0],
                     "whole_hidden_bytes": B * P * cfg.d_model * 2,
                     "collectives": counter.summary()["breakdown"],
                     "peak_bytes": torch.cuda.max_memory_allocated(dev),
                     "flash_calls": len(seen["q_offsets"]),
                     "q_offsets": sorted(set(seen["q_offsets"])),
                     "fallbacks": fallbacks}
                rec["cases"][label] = c
                if lead:
                    print(f"[4 sp path] ({label}) {DENSE_ARCH} {SP_LAYERS} layers split over "
                          f"{SP_RANKS} ranks: bf16 {B}x{P} + {new} tokens {wall:.2f} s, "
                          f"fallbacks {fallbacks}")
                del engine, cache
                gc.collect()
                torch.cuda.empty_cache()
            del params
            cfg = _tp_config(DENSE_ARCH, "float32", TP_FP32_LAYERS)
            B, P, _ = SP_SERVED["a"]
            params = _tp_shards(cfg, dev)
            cache = base.tree_init(tensor.local_tree(cfg, api.abstract_cache(
                cfg, B, tensor.cache_len(cfg, P + TP_FP32_STEPS + 8))),
                torch.Generator(device=dev), dev)
            got = _tp_steps(cfg, params, cache, _tp_prompts(cfg.vocab, B, P), TP_FP32_STEPS,
                            dev)
            arrays["c/logits"], arrays["c/tokens"] = got["logits"], got["tokens"]
            del params, cache
        gc.collect()
        torch.cuda.empty_cache()

        cfg, shape, oc = _sp_train_setup()
        tc = trainer.TrainerConfig(ckpt_dir=str(root / f"ckpt_{rank}"), seed=SEED,
                                   total_steps=TP_TRAIN_STEPS, ckpt_every=TP_TRAIN_STEPS + 1,
                                   remat="full")
        torch.cuda.reset_peak_memory_stats(dev)
        with shd.use_mesh(mesh, tensor.training_rules(mesh)):
            state, hist = trainer.run(cfg, shape, oc, tc, device=dev)
        rec["train"] = {"coordinate": {a: mesh.coordinate(a) for a in mesh.shape},
                        "state_bytes": _tree_bytes(state),
                        "peak_bytes": torch.cuda.max_memory_allocated(dev),
                        "loss": hist["loss"], "grad_norm": hist["grad_norm"],
                        "step_s": hist["step_s"]}
        torch.save({base.keystr(p): t.cpu() for p, t in base.tree_items(state["params"])},
                   root / f"rank{rank}_d.pt")
        del state, hist
        rec["launches"] = _rank_launches()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (root / f"rank{rank}.json").write_text(json.dumps(rec))
    np.savez(root / f"rank{rank}.npz", **arrays)
    return 0


ROOF_PREFILL = (4, 512)                  # mamba2-2.7b prefill through B7 (rows, tokens)
ROOF_WALL_RUNS = 3                       # uncounted prefills timed after one warm-up
DRYRUN_TIMEOUT_S = 300


def _roofline_path(dev, wrappers, reset_launches, smi) -> dict:
    """Phase 4(k): the counting mode (`launch/cost.py`) and the roofline
    (`launch/roofline.py`) on the card, at world size 1. (a) mamba2-2.7b
    prefill 4 x 512 through B7, counted on the card and the same step on
    `meta`: FLOPs and bytes equal but for the conv kernel's formula in
    place of the composed conv (`_conv_count_swap`), the kernel counted
    once a layer on the card and never on `meta`, B7's counted FLOPs 64 x
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

    def both(cfg, shape, remat="full", swap=(0.0, 0.0)):
        """(card counter, meta counter, the card's built step); the card's
        FLOPs and bytes are meta's plus `swap`."""
        run = dryrun.build_step(cfg, shape, device=dev, remat=remat)
        torch.cuda.synchronize()
        card = dryrun.count_step(run)
        torch.cuda.synchronize()
        meta = dryrun.count_step(dryrun.build_step(cfg, shape, device="meta", remat=remat))
        if (card.flops, card.bytes) != (meta.flops + swap[0], meta.bytes + swap[1]):
            raise AssertionError(f"{cfg.name} {shape.kind}: card counts {card.flops} FLOP, "
                                 f"{card.bytes} B; meta {meta.flops}, {meta.bytes}, plus "
                                 f"{swap}")
        return card, meta, run

    # (a) mamba2-2.7b prefill through B7
    cfg = configs.get_config(LM_ARCH)
    shape = ShapeConfig("chip", ROOF_PREFILL[1], ROOF_PREFILL[0], "prefill")
    reset_launches()
    swap = _conv_count_swap(cfg, shape.global_batch, shape.seq_len)
    card, meta, run = both(cfg, shape, swap=swap)
    n_ssd, n_mma = wrappers["ssd_scan"].launches, wrappers["ssd_scan"].mma_launches
    conv = card.kernels.get("causal_conv", {})
    if (not wrappers["causal_conv"].launches == cfg.n_layers == conv.get("calls")
            or "causal_conv" in meta.kernels):
        raise AssertionError(f"causal_conv: {wrappers['causal_conv'].launches} launches, "
                             f"{conv.get('calls')} counted on the card, "
                             f"{meta.kernels.get('causal_conv')} on meta; want {cfg.n_layers}, "
                             f"{cfg.n_layers}, none")
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
    from repro_torch.kernels.causal_conv import build as cbuild
    from repro_torch.kernels.causal_conv import ops as cops
    from repro_torch.kernels.causal_conv import ref as cref
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
                "quant_matmul": qops.quant_matmul, "ssd_scan": sops.ssd,
                "causal_conv": cops.causal_conv}
    libraries = (build, fbuild, sbuild, qbuild, cbuild)

    def reset_launches():
        for mod in (ops, fops, qops, sops, cops):
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
    # mamba2-2.7b's N = 128 on both routes, then zamba2-2.7b's N = 64 in
    # bf16, then on both routes a rank's share under phase 4(q)'s (data 2,
    # model 2) mesh: its rows and its heads
    rows_2x2 = DENSE_BATCH // W8_DP_RANKS[0]
    for label, dtype, n, b, h in (
            ("bf16", torch.bfloat16, 128, LM_BATCH, 80),
            ("fp32", torch.float32, 128, LM_BATCH, 80),
            ("bf16_zamba", torch.bfloat16, HYBRID_SSM_STATE, LM_BATCH, 80),
            (f"bf16_rank_of_2x2: B={rows_2x2}, H={TP_SSM_SSD_HEADS}", torch.bfloat16, 128,
             rows_2x2, TP_SSM_SSD_HEADS),
            (f"fp32_rank_of_2x2: B={rows_2x2}, H={TP_SSM_SSD_HEADS}", torch.float32, 128,
             rows_2x2, TP_SSM_SSD_HEADS)):
        args = _ssd_args(rng, dev, dtype, n, h, b)
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
        if "rank_of_2x2" in label and dtype == torch.float32 and ssd_routes[label] != "scalar":
            raise AssertionError(f"ssd_scan[{label}] did not take the scalar route")
        lm_cases["ssd_scan"][label] = args
    # the prefill conv (port-only) on x|B|C read in place from in_proj's
    # product, mamba2-2.7b's widths at the benchmark's largest calls,
    # against its plain version at fp32: within one bf16 ulp
    conv_cases = {}
    for label, (b, s) in CONV_SHAPES.items():
        args = _conv_args(dev, b, s)
        vec = cops.causal_conv.vec_launches
        got, want = cops.causal_conv(*args), cref.causal_conv(args[0].float(), *args[1:])
        torch.cuda.synchronize()
        route = "vector" if cops.causal_conv.vec_launches > vec else "element"
        err = float((got.float() - want).abs().max().item())
        errors["causal_conv", label] = err
        print(f"[3 kernel] causal_conv[{label}] {tuple(got.shape)} from a "
              f"{args[0].stride(1)}-wide row on the {route} route max_abs_err={err:.3g} "
              f"(|y| <= {want.abs().max().item():.3g})")
        if not _conv_agrees(got, want):
            raise AssertionError(f"causal_conv[{label}] disagrees with its plain version")
        if route != "vector":
            raise AssertionError(f"causal_conv[{label}] did not take the vector route")
        conv_cases[label] = args

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
    _tp_path(dev, wrappers, reset_launches, smi)
    _tp_train_path(dev, wrappers, reset_launches, smi)
    tp_ssm = _tp_ssm_path(dev, wrappers, reset_launches, smi, clock_hz)
    launches["ssd_scan"] += tp_ssm["ssd_scan"]
    mma_launches["ssd_scan"] += tp_ssm["ssd_scan mma"]
    _tp_ssm_train_path(dev, wrappers, reset_launches, smi)
    _tp_moe_path(dev, wrappers, reset_launches, smi)
    w8_dp = _w8_dp_path(dev, reset_launches, smi)
    launches["ssd_scan"] += w8_dp["ssd_scan"]
    mma_launches["ssd_scan"] += w8_dp["ssd_scan mma"]
    _sp_path(dev, wrappers, reset_launches, smi)
    for label in lm_cases["ssd_scan"]:                # a rank's, in phase 4(q)
        if "rank_of_2x2" in label:
            ssd_per_prefill[label] = W8_DP_CASES["b" if label.startswith("bf16") else "bf"][1]

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
        if name == "ssd_scan":                    # a rank's shape (phase 4(n))
            per_shape.append(tp_ssm["rank_shape"])
            print(json.dumps({"kernel": name, **tp_ssm["rank_shape"]}))
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
    per_shape = []
    for label, args in conv_cases.items():
        out = cops.causal_conv(*args)
        (b, s, c), w = out.shape, args[1].shape[0]
        work, moved = cops.work(b, s, c, w, out.element_size())
        bound_ms, bound_by = _bound(moved, work, None)
        rec = {"shape": label, "ms": _time_ms(lambda: cops.causal_conv(*args), clock_hz),
               "plain_ms": _time_ms(lambda: _composed_conv(*args), clock_hz),
               "library_ms": None, "library": None, "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes": moved, "flop": work, "path": "vector",
               "max_abs_err": errors["causal_conv", label]}
        per_shape.append(rec)
        print(json.dumps({"kernel": "causal_conv", **rec}))
    head = per_shape[0]
    records.append({
        "name": "causal_conv", "route": "cuda", "source": SOURCES["causal_conv"],
        "replaces": REPLACES["causal_conv"], "port_only": True,
        "launches": launches["causal_conv"], "launches_per_prefill": launches["causal_conv"],
        "max_abs_err": max(r["max_abs_err"] for r in per_shape),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "library": None, "timed_shape": head["shape"], "shapes": per_shape,
    })
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
    if sys.argv[1:2] == ["--tp-child"]:
        sys.exit(_tp_child(int(sys.argv[2]), Path(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--tp-train-child"]:
        sys.exit(_tp_train_child(int(sys.argv[2]), Path(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--tp-ssm-child"]:
        sys.exit(_tp_ssm_child(int(sys.argv[2]), Path(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--tp-ssm-train-child"]:
        sys.exit(_tp_ssm_train_child(int(sys.argv[2]), Path(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--tp-moe-child"]:
        sys.exit(_tp_moe_child(int(sys.argv[2]), Path(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--tp-moe-train-child"]:
        sys.exit(_tp_moe_train_child(int(sys.argv[2]), Path(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--w8-dp-child"]:
        sys.exit(_w8_dp_child(int(sys.argv[2]), Path(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--sp-child"]:
        sys.exit(_sp_child(int(sys.argv[2]), Path(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
