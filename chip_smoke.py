#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and the
checkout around this file; exits non-zero, printing no result, without
either. Phases, each printing JSON lines:

1. device    — the card's name and power limit; build the CUDA kernels.
2. kernels   — every ALF kernel against its plain PyTorch version on the
               card: f32, bf16, a mixed {f32, bf16} tree and f64; n = 1,
               1500*128+37, the main path's 2048*64 and Backsolve's
               packed augmented state on it (2*2048*64 + 2*64*64 + 128
               = 270,464); eta in {1, 0.9}
               (sign in {+1, -1} for the midpoint and its VJP). The two
               VJP kernels run as the backward of alf_midpoint /
               alf_update under torch.autograd.grad. One op call (or one
               backward) must be exactly one launch. The three kernels
               that move 16-byte vectors (alf_midpoint, alf_update,
               alf_midpoint_vjp) also with each input 0-3 elements past a
               16-byte boundary, one input at a time and all together,
               and (through the C entry) the outputs 1-3 past one, f32,
               bf16 and f64 at n = 1, 1500*128+37 and 2048*64, and with
               a per-row h at 3 x 37 and 2048 x 64; the update's C entry
               must refuse outputs at two phases.
3. times     — CUDA-event times of each kernel, its plain version and
               (where one exists) one library call, beside the bound, at
               the main path's shape and at n = 2^25, the forward pair
               also at the LM paths' f32 ALF states (qwen3-1.7b 2^23,
               Jamba 2^24); a kernel with a library call is timed against
               it in turns (kernel, library, kernel, library); CUDA-graph
               times at 2048*64 and, for the forward pair and the kernels
               with a library call, at every size. The host's cost per
               call at 2048*64 (events minus graph) of the forward
               launchers and of their ops under no_grad and through
               their autograd.Function.
4. main path — the paper's Sec 4.2 model (D=64, HIDDEN=64, 3 classes,
               2048 images) trained 20 Adam steps with
               solve(ALF(eta=1, backend="cuda"), ConstantSteps(4), MALI())
               on the card; the loss must fall, every kernel must launch
               2*4 times forward and 2*4 times backward per step, and
               MALI's gradient must match Naive() on the reference backend.
5. adaptive  — AdaptiveController(1e-4, 1e-5, 128) over
               SaveAt(ts=linspace(0, 1, 5)): MALI (cuda) against Naive
               (reference) on the card.
6. direct   — direct backprop through the kernels at the Sec 4.2
   backprop    model's full width: Naive() x ALF(backend="cuda") trained
               20 steps (gradients against Naive on the reference backend
               and fused MALI on cuda, loss trace against phase 4's, 4+4
               forward and 4+4 VJP launches per step); MALI(fused_bwd=False)
               x cuda (the inverse kernels and the replay through the
               reverse rules) against fused MALI; Naive x cuda against
               MALI x cuda under AdaptiveController over
               SaveAt(ts=linspace(0, 1, 5)) (h's cotangent); SaveAt(steps)
               and SaveAt(dense) x cuda against the reference backend;
               Naive step time on cuda and on the reference backend.
7. memory    — peak device memory of a solve's forward + backward on a
               2^20-element state at ConstantSteps(8) and (64): flat
               (<= 1.05x) for MALI, growing for Naive on either backend.
8. profile   — torch.profiler over 20 training steps of phase 4 on the
               kernel and the reference backend: device busy/idle share
               and the top device operations.
9. lm_kernels — the RMSNorm, flash-attention and selective-scan kernels
               against their plain versions on the card. RMSNorm: f32 and
               bf16, rows in {1, 4, 65536, 4099}, d every config's d_model
               and q/k-norm d_head (128, 768, 2048, 2304, 4096, 6144,
               8192) and 16, 64, 100, 2050 (the scalar kernel's widths):
               88 cases. Flash: the seven FA_CASES of tests/test_kernels.py,
               ragged and d=16 / d=256 cases, one query over 1024 keys,
               129 rows (one past a 128-row tile), MQA H16/KV1 at d=128,
               S=1024 causal at d=256, a strided (transposed) operand, q
               off a 16-byte boundary (bf16 must raise: TMA) and
               qwen3-1.7b's prefill shape, f32 and bf16: 36 cases. Scan:
               the four MS_CASES of tests/test_kernels.py, S = 1, ragged
               DI (200, 8192 + 37), ST 1, 2, 4 and 32 at the lane groups'
               edges, a given h0, strided operands and Jamba's prefill
               shape, f32 and bf16 inputs: 28 cases; y within MS_TOL and
               h bit for bit.
10. lm_times  — each of the three kernels at its model's prefill shapes
               (qwen3-1.7b; the scan at jamba-v0.1-52b's): CUDA-event ms,
               ms in a CUDA graph, its bound, its plain version's ms and
               one library call's ms, also in a graph
               (torch.nn.functional.rms_norm, scaled_dot_product_attention;
               none for the scan), and flash's TFLOP/s from graph times.
               The scan's bound has three terms: bytes, f32 operations,
               and its expf on the MUFU unit (16 a clock per SM at the
               card's maximum SM clock).
11. lm_serve  — the port's serve() for qwen3-1.7b at full width (bf16,
               DEFAULT_ODE, seeded random weights): batch 4, prompt 1024,
               32 greedy decode steps through the decode graph (one eager
               warm-up step and one captured, then replays), with exact
               launch counts (per prefill 84 flash, 337 RMSNorm, 224 ALF;
               per decode step 0, 337, 224, counted at the eager step and
               at the capture; a replay calls no wrapper), no host sync
               inside prefill, a decode step, the capture or a replay,
               the graph's greedy tokens equal to an eager decode loop's
               and to serve()'s and its logits within LM_TOL, decode ms
               per step graphed (at most half the eager) and eager, the
               kernel path against backend="reference" (bf16 and f32,
               eager), prefill(p+1) against prefill(p) + decode, peak
               memory and device profiles of prefill, 4 eager decode steps
               and 4 replays.
12. ssm_serve — the port's serve() for jamba-v0.1-52b at full width, 2 of
               its 4 periods (16 of 32 layers, the only cut: 4 periods
               are ~104 GB of bf16 weights), bf16, DEFAULT_ODE, batch 4,
               prompt 1024, 16 greedy decode steps through the decode
               graph: exact launch counts (per prefill 42 scan, 6 flash,
               97 RMSNorm, 64 + 64 ALF; per decode step 0, 0, 97, 64 + 64,
               counted as in phase 11), no host sync, the graph against
               eager decode and serve() as in phase 11, init peak memory
               <= 1.25x the weights, the kernel path against
               backend="reference" (bf16 at 2 periods; f32 at 1 period,
               batch 2, prompt 256; eager, as these read the MoE routes)
               on the rows whose MoE routes agree, prefill(p+1) against
               prefill(p) + decode on the rows whose routes agree and
               whose decode step dropped none, peak memory and device
               profiles.
13. methods   — the rest of the solver surface, through the port's entry
               points: (a) Thm 2.1 — dL/da of -a*z (a=8, ALF(eta=0.9),
               ConstantSteps(128)): MALI on cuda within 1e-4 of Naive on
               the reference backend, Backsolve on cuda drifting (> 1e-3
               and > 100x MALI's error) and within 1e-5 of Backsolve on
               the reference backend; (b) the Sec 4.2 model trained 20
               Adam steps through odeint(method=...) with MALI (ALF cuda),
               ACA (heun_euler), Backsolve (ALF cuda; and dopri5 under
               AdaptiveController(1e-4, 1e-5, 128)) and Naive
               (heun_euler): the loss falls, exact launch counts (Backsolve
               on ALF cuda 4+4 alf_midpoint/alf_update forward and 4+4 in
               the reverse augmented solve per step, none of the others;
               the Runge-Kutta runs none), no host sync in a fixed-step
               forward + backward, ACA's first-step gradient within 1e-5
               of Naive's on the same tableau, Backsolve's on ALF cuda
               within 1e-5 of its own on the reference backend (the
               forward pair over the packed (z, a, g_params) state at
               full width), ms per step in turns and
               each method's device busy/idle share (torch.profiler);
               (c) peak memory on phase 7's 2^20-element state at
               ConstantSteps(8) and (64): MALI and Backsolve <= 1.05x,
               ACA > 2x and below Naive (heun_euler) at 64 steps, MALI
               below ACA; (d) diff_bounds: dL/dt0 and dL/dt1 of each
               method on the Sec 4.2 field against the analytic values
               (1e-5), methods on one discretization within 1e-5 of each
               other, across discretizations within 5e-3.
14. cnf       — the image CNF of examples/cnf_image.py (paper Sec 4.4)
               at its widths: DIM 784, mlp_vfield hidden 64 depth 2,
               Hutchinson (Rademacher), ALF(eta=1, cuda), ConstantSteps(8),
               MALI, cnf_loss(kinetic_reg=0.05), Lockstep, 20 Adam steps
               at 1e-3 on the port's dequantized make_image_batch, at
               batch 16 and 1024 (1,607,680 f32 packed into one buffer per
               ALF op): losses and bits/dim finite and the loss falling;
               exact launch counts (8 + 8 + 8 + 8 ALF per step, 8 + 8 per
               sample() call, 8 + 8 + 8 + 8 forward and VJP per Naive
               gradient); the first step's and the trained parameters'
               loss and gradient on the kernel backend within 1e-5 of the
               reference backend (same probe), Naive (ALF cuda) against
               MALI within rtol 2e-4 / atol 2e-5; no host sync in a
               training step; peak memory of grad(cnf_loss) at batch 1024
               from 8 to 64 steps, MALI <= 1.05x, Naive > 2x; sample() at
               batch 16 in reverse time, its flow path over a descending
               grid and the log_prob of the samples. Events: -a z (a = 8),
               Event(z[0] - 0.5, direction=-1): event_time within 1e-3 of
               ln 2 / a and its IFT gradient within 2e-2 of -t*/a for MALI
               and Naive (ALF cuda), ACA (heun_euler) and Backsolve
               (dopri5) under ConstantSteps(128) and AdaptiveController,
               ALF cuda within 1e-6 of the reference backend, and a
               detection pass whose bisection calls no dynamics and syncs
               no host. ms per step on each backend in turns and the
               device's busy share over 20 profiled steps at each batch.
15. per_sample — PerSample and Sharded batching on the card: (a)
               benchmarks/batched_throughput.py's stiffness mix (B 16,
               lam log-spaced over [0.5, 50], ALF(eta=0.9, cuda),
               AdaptiveController(1e-3, 1e-4, 512), MALI): per-row
               counters, values and gradients equal to 16 single-row
               solves, total f-evals against Lockstep, the reference
               backend, Naive and unfused MALI (the per-row VJP and
               inverse kernels); (b) the image CNF at phase 14's widths
               and trained weights under PerSample with
               AdaptiveController(1e-2, 1e-3, 256), batch 1024 and 16:
               kernel vs reference backend (loss, logp, gradients within
               1e-5, counters equal), four rows (the fastest and the
               slowest among them) against their own single-row solves,
               exactly one host read and one midpoint + one update launch
               per trial (PerSample and Lockstep), ms per step and the
               device's idle share, the spread of accepted steps; (c)
               MALI's peak memory at batch 1024 from the base tolerances
               to the first tighter pair with >= 4x the accepted steps a
               row (<= 1.05x, two readings each); (d) Sharded(inner=
               Lockstep()) and Sharded(inner=PerSample()) on a one-rank
               mesh bit-equal to their inner batching. The per-row
               launches of (a) and of (b)'s gradients are counted from 0
               (the kernels line's launches_per_sample).
16. serve     — the continuous-batching ODE serving engine
               (repro_torch.serve), its chunk lane on the per-row ALF
               kernels: (a) benchmarks/serve_load.py's protocol at its
               sizes (slots 8, chunk 16, D 16, 64 requests, lam
               log-uniform over [0.5, 200], max_steps 2048, ALF(eta=0.9),
               the tick clock at the measured round time, Poisson at 0.75
               of capacity, both engines) on the card and on the CPU: per
               request f-evals, accepted steps and completion equal, end
               states within 1e-6, rounds equal, both ratios > 1 and
               equal within 1e-6 relative, beside the JAX package's; (b)
               its 64 continuous-engine rows, and 8 of (d) (the 4 fastest
               and 4 slowest), against their own solve() on the card
               (scalar kernels, ReproducibleController; (d)'s f computed
               as a fleet row is: a 1024-row product), counters equal,
               within 1e-6 and 1e-5 relative; (c) the dense lane's hot
               trajectory (6 hits in 7 lookups, 0 f-evals a hit) and an
               event on -8 z against the same event solve() (1e-6), 2
               scalar ALF launches a trial; (d) launch/serve.py --mode ode
               at --batch 1024 --d-state 784 --requests 4096
               --chunk-steps 32 (its mlp_field), both engines all at
               once: p50/p99, solves/s, occupancy, rounds, ms a
               round, peak memory, the device's busy share over 4 rounds,
               host syncs over 4 rounds, and the CLI at its defaults; (e)
               exactly 2 x chunk_steps ALF launches a round, all per-row
               (the kernels line's launches_serve: (d)'s two serve_ode
               runs), no host sync inside a chunk
               (set_sync_debug_mode("error")). Its Poisson runs at full
               width and the same 8 rows against f's one-row products
               were cut to keep the script near 800 s.
17. lm_train  — continuous-depth LM training (repro_torch.train): (a)
               qwen3-1.7b at full width (28 layers, d 2048, vocab 151936,
               bf16, seeded weights), each residual branch a MALI solve on
               ALF(backend="cuda") with ConstantSteps(2), batch 2 x 4096
               (the FA2 attention path), 3 Trainer steps: losses finite,
               the loss on batch 0 falls, exactly 112 launches of each of
               alf_midpoint, alf_update, alf_bwd_pre and alf_bwd_post per
               step and none of the other seven kernels, no host sync in
               train_step, ms a step, peak memory, f-evals a step and the
               device's busy share and top ops over 2 profiled steps; (b)
               one step's loss and gradients with backend="cuda" against
               "reference": at full width in bf16 within max(3e-2, 3x the
               reference's own one-rounding floor), on 2 of the 28 layers
               at S 1024 in f32 within 1e-5, and MALI (cuda) against
               Naive (reference) within rtol 2e-4 / atol 2e-5; (c) the
               peak memory of one train_step from 2 to 8 ALF steps: MALI
               at (a)'s shape <= 1.05x, Naive (2 layers, S 1024, f32,
               batch 8) > 2x; (d) the gemma2 (S 2304: window, softcaps
               and the FA2 backward), jamba and deepseek smoke configs one
               step each, kernel against reference within 1e-5 in f32,
               and a Trainer run with a checkpoint every 2 steps and a
               failure injected at step 3 whose resumed loss trace is
               bit-equal to the clean one; (e) python -m
               repro_torch.launch.train --steps 4 prints final_step=4.

Phase 2 also holds the eight kernels with a per-row (B,) h, each row
its own (kernels_rows: B x D in ROW_CASES, f32, bf16, mixed, f64, one
launch of the per-row instantiation a call), and phase 3 times each
per-row instantiation beside its scalar one in turns at 2^25 (1024
rows) and 1024 x 1570 (times_rows).

Every phase runs on every call. The line before the last is the kernel
table; the last line is ``{"ok": true, "device": {...}}``. Any failed
check raises.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

D, HIDDEN, N_CLASS = 64, 64, 3          # examples/image_recognition.py
N_TRAIN, TRAIN_STEPS, LR, N_SUB = 2048, 20, 3e-3, 4
SLICE_N = N_TRAIN * D                   # the main path's state: 2048 x 64
BIG_N = 1 << 25
TAIL_N = 1500 * 128 + 37
# The f32 ALF state of the LM paths' prefill (batch 4 x 1024 tokens x
# d_model): qwen3-1.7b and jamba-v0.1-52b
QWEN_ALF_N, JAMBA_ALF_N = 4 * 1024 * 2048, 4 * 1024 * 4096
# Backsolve's augmented state (z, a, {w1, b1, w2, b2}) on the main path,
# packed into one buffer by the ALF ops: 270,464 f32
BACKSOLVE_AUG_N = 2 * SLICE_N + 2 * D * HIDDEN + HIDDEN + D
# The image CNF (phase 14; examples/cnf_image.py) at the example's
# default batch and at a real state; its augmented state (z, logdet,
# kinetic, probe), packed into one buffer: 25,120 and 1,607,680 f32
CNF_DIM, CNF_BATCHES = 28 * 28, (16, 1024)
CNF_ROW = 2 * CNF_DIM + 2
CNF_PACKED_N = tuple(b * CNF_ROW for b in CNF_BATCHES)
# Per-row h (PerSample batching): (B rows, D elements a row). D = 1, 2
# and 37 (odd) put row boundaries inside 16-byte vectors; the CNF's row
# (1570) at its two batches; the main path's 2048 x 64; the serve
# engine's fleets (phase 16), a row its (y, scale) or (y, lam): 8 x 32
# (serve_load), 64 x 64 (the CLI's defaults), 1024 x 1568 (full width).
ROW_CASES = ((1, CNF_ROW), (3, 1), (3, 2), (3, 37), (16, CNF_ROW),
             (16, 2), (1024, 1), (1024, 37), (1024, CNF_ROW), (N_TRAIN, D),
             (8, 2 * 16), (64, 2 * 32), (1024, 2 * 784))
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_core_gradients.py:76
KERNEL_ULPS = 2
TIME_PAIRS = 5
NAIVE_TIME_PAIRS = 3
UNFUSED_STEPS = 3

# Memory rate (bytes/s), f32 peak (FLOP/s, outside the tensor cores) and
# dense bf16 tensor-core peak by card name; NVIDIA data sheets.
CARDS = (("H200", 4.8e12, 67e12, 989e12), ("H100 NVL", 3.9e12, 60e12, 835e12),
         ("H100 PCIe", 2.0e12, 51e12, 756e12),
         ("H100", 3.35e12, 67e12, 989e12))

TPU_SRC = "src/repro/kernels/alf_step/alf_step.py"
KERNELS = {
    # name: (TPU kernel replaced, inputs, outputs, f32 ops per element)
    "alf_midpoint": (f"{TPU_SRC}:43", 2, 1, 3),
    "alf_update": (f"{TPU_SRC}:50", 3, 2, 5),
    "alf_bwd_pre": (f"{TPU_SRC}:107", 4, 2, 5),
    "alf_bwd_post": (f"{TPU_SRC}:118", 6, 4, 12),
    "alf_midpoint_vjp": (f"{TPU_SRC}:91", 1, 1, 2),
    "alf_update_vjp": (f"{TPU_SRC}:97", 2, 2, 4),
    "alf_inverse": (f"{TPU_SRC}:75", 3, 2, 7),
    "alf_inverse_update": (f"{TPU_SRC}:61", 3, 2, 5),
}
VJPS = ("alf_midpoint_vjp", "alf_update_vjp")
FORWARD = ("alf_midpoint", "alf_update")
# Why a kernel has no one-call PyTorch yardstick (library_ms null).
NO_LIBRARY = "none: no single PyTorch call writes its {} outputs"
SOURCE = "src/repro_torch/kernels/alf_step/csrc/alf_step.cu"

# The LM serving slice: qwen3-1.7b at full width.
LM_ARCH = "qwen3-1.7b"
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 1024, 32
LM_KERNELS = {
    # name: (TPU kernel replaced, CUDA source)
    "rmsnorm": ("src/repro/kernels/rmsnorm/rmsnorm.py:19",
                "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu"),
    "flash_attention": (
        "src/repro/kernels/flash_attention/flash_attention.py:31",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"),
    "selective_scan": (
        "src/repro/kernels/mamba_scan/mamba_scan.py:36",
        "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu"),
}
# Launches per prefill and per decode step of qwen3-1.7b under DEFAULT_ODE
# (n_steps=2: 3 f-evals per residual branch): 28 layers x 3 attention
# evals; 28 x (3 x (mixer norm + q-norm + k-norm) + 3 mlp norms) + the
# final norm; 28 layers x 2 branches x 2 steps, one midpoint and one
# update each.
LM_PER_PREFILL = {"flash_attention": 84, "rmsnorm": 337,
                  "alf_midpoint": 112, "alf_update": 112}
LM_PER_DECODE = {"flash_attention": 0, "rmsnorm": 337,
                 "alf_midpoint": 112, "alf_update": 112}
RN_ROWS = (1, 4, 4096 * 16, 4099)
# widths beside every config's own (d_model, and d_head where q/k are
# normed; _rn_dims): the smoke configs' d_model 64 and d_head 16, 100 (16
# bytes a vector in f32, not in bf16: the scalar kernel) and 2050 (no
# 16-byte vector in either dtype)
RN_EXTRA_DIMS = (16, 64, 100, 2050)
# elementwise |got - want| <= atol + rtol * |want|. f32: rsqrtf and the
# warp's summation order against torch's, ~1e-7 relative; bf16: one
# rounding of the f32 result may land one bf16 ulp (2^-7 relative) apart.
RN_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2.0 ** -7, 0.0)}
# (B, Sq, Sk, H, KV, d, causal, window, softcap): the seven FA_CASES of
# tests/test_kernels.py:260, then ragged lengths (not multiples of the
# kernel's 64-row tiles), d=16 (the smoke configs) and d=256 (gemma2),
# fewer queries than keys, and qwen3-1.7b's prefill.
FA_CASES = (
    (1, 128, 128, 4, 4, 64, True, 0, 0.0),      # MHA causal
    (2, 128, 128, 4, 2, 64, True, 0, 0.0),      # GQA 2:1
    (1, 256, 256, 8, 1, 64, True, 0, 0.0),      # MQA (granite kv=1)
    (1, 128, 128, 4, 4, 64, False, 0, 0.0),     # bidirectional
    (1, 256, 256, 4, 2, 64, True, 128, 0.0),    # sliding window (gemma2)
    (1, 128, 128, 4, 2, 64, True, 0, 50.0),     # softcap (gemma2)
    (2, 384, 384, 4, 2, 128, True, 256, 30.0),  # window+softcap, d=128
    (2, 200, 200, 4, 2, 64, True, 0, 0.0),      # ragged causal GQA
    (2, 37, 37, 4, 2, 16, True, 8, 50.0),       # smoke-config head size
    (1, 300, 300, 8, 4, 256, True, 100, 50.0),  # gemma2 head size, ragged
    (1, 100, 333, 4, 2, 128, False, 0, 0.0),    # Sq < Sk, KV tail masked
    (2, 1, 1024, 16, 8, 128, False, 0, 0.0),    # one query over 8 kv tiles
    (2, 129, 129, 4, 2, 128, True, 0, 0.0),     # one row past a 128-row tile
    (1, 512, 512, 16, 1, 128, True, 0, 0.0),    # MQA H16/KV1 at d=128
    (1, 1024, 1024, 8, 4, 256, True, 0, 0.0),   # gemma2 heads, S=1024, d=256
    (LM_BATCH, LM_PROMPT, LM_PROMPT, 16, 8, 128, True, 0, 0.0),  # qwen3
)
# elementwise |got - want| <= atol + rtol * |want|. f32: the Pallas bar
# of tests/test_kernels.py:287. bf16: the kernel and the plain version
# both compute in f32 and round once, so they may land one bf16 ulp
# (at most 2^-7 relative) apart; atol covers f32 summation order near 0.
# The bf16 kernel multiplies P.V on the tensor cores as P_hi + P_lo (two
# bf16 roundings: |P - P_hi - P_lo| <= 2^-16 P), so its output moves by
# at most 2^-16 max|v| from the f32 product and typically by far less
# (averaged over many keys): inside this atol on every case here, so the
# bar is unchanged (tests/test_torch_lm_kernels.py holds the split's
# arithmetic to it on the CPU).
FA_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2.0 ** -7, 1e-5)}
# The library yardstick multiplies P.V in bf16, as the Pallas kernel does:
# held to the Pallas bf16 bar of tests/test_kernels.py:287.
FA_LIB_TOL = (3e-2, 3e-2)
# Whole-model logit agreement, max |a - b| / max |b|: the kernel path
# against the plain path, and prefill(p+1) against prefill(p) + decode.
# f32: summation orders only; bf16: roundings of 28 layers x 3 f-evals.
LM_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# A graphed decode step must take less than the eager step and at most
# half of it or, where the device's own work per step comes near half the
# eager step (Jamba: its skinny GEMMs read the weights), at most this
# factor times that work
GRAPH_TO_BUSY = 1.5
# (Bt, S, DI, ST): the four MS_CASES of tests/test_kernels.py:337, one
# step, DI ragged against the kernel's blocks, Jamba's prefill (d_inner
# 8192, d_state 16, 4 x 1024 tokens), and the lane groups' edges: ST 1, 2
# and 4 (one lane per channel, 128 channels a block), ST 32 (4 lanes, 32
# channels a block), each with DI off its block and S off the 16-step
# chunk, ST 32 also with DI off a 4-channel vector.
MS_CASES = (
    (1, 16, 128, 16), (2, 33, 256, 16), (1, 8, 200, 8), (2, 64, 512, 4),
    (2, 1, 300, 16), (1, 50, 8192 + 37, 16), (4, 1024, 8192, 16),
    (2, 37, 130, 1), (1, 19, 70, 2), (1, 23, 132, 4), (2, 45, 100, 32),
    (1, 29, 8192 + 37, 32))
# elementwise |got - want| <= atol + rtol * |want|, f32 and bf16 inputs
# alike (both sides compute in f32): h is bit-equal (same operation order,
# --fmad=false); y's ST-term sum runs in another order (the kernel
# sequentially, torch by its reduction): on an H100 the largest difference
# is 1.9e-5 at |y| ~ 230, inside rtol 1e-5 at that magnitude.
MS_TOL = (1e-5, 1e-5)

# The Jamba/SSM serving slice: jamba-v0.1-52b at full width, 2 of its 4
# periods (16 of 32 layers).
SSM_ARCH = "jamba-v0.1-52b"
SSM_PERIODS = 2
SSM_BATCH, SSM_PROMPT, SSM_DECODE = 4, 1024, 16
# Launches per prefill and per decode step under DEFAULT_ODE (3 f-evals
# per residual branch): 14 Mamba layers x 3 scans; 2 attention layers x 3
# flash calls; 16 layers x 2 branches x 3 norms + the final norm; 16
# layers x 2 branches x 2 steps, one midpoint and one update each.
SSM_PER_PREFILL = {"selective_scan": 42, "flash_attention": 6,
                   "rmsnorm": 97, "alf_midpoint": 64, "alf_update": 64}
SSM_PER_DECODE = {"selective_scan": 0, "flash_attention": 0, "rmsnorm": 97,
                  "alf_midpoint": 64, "alf_update": 64}
# init must not hold a period twice (stacking finished periods would)
INIT_PEAK_RATIO = 1.25
# bf16 whole-model comparisons of the Jamba cut: at most this factor times
# the model's own noise floor (the plain path with the embedding moved by
# one bf16 rounding), since a router near-tie flips routes and the model
# carries a one-rounding change to O(1): on an H100 the plain path moved
# so differs from itself in ~59% of routes and by ~1.4 in its logits
FLOOR_FACTOR = 3.0
# layer by layer from the same input, each layer's kernel and plain
# outputs are compared on the tokens whose routes agree in the layer; at
# least this share of tokens must be compared
LAYER_TOKEN_SHARE = 0.9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_rates(name: str):
    """(memory bytes/s, f32 FLOP/s, bf16 tensor-core FLOP/s) of a card."""
    for key, *rates in CARDS:
        if key in name:
            return rates
    raise RuntimeError(f"no memory rate known for card {name!r}")


# ---------------------------------------------------------------------------
# The paper's Sec 4.2 model (examples/image_recognition.py)
# ---------------------------------------------------------------------------

def make_data(n: int, seed: int):
    """Three gaussian-blob classes with fixed means, exactly as the JAX
    example makes them."""
    protos = np.random.default_rng(12345).standard_normal((N_CLASS, D)) * 0.6
    rng = np.random.default_rng(seed)
    y = rng.integers(0, N_CLASS, n)
    x = protos[y] + rng.standard_normal((n, D)) * 0.8
    return x.astype(np.float32), y.astype(np.int64)


def init_params_numpy(seed: int):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "f": {"w1": (0.3 * rng.standard_normal((D, HIDDEN))).astype(f32),
              "b1": np.zeros((HIDDEN,), f32),
              "w2": (0.3 * rng.standard_normal((HIDDEN, D))).astype(f32),
              "b2": np.zeros((D,), f32)},
        "norm": np.ones((D,), f32),
        "head": (0.3 * rng.standard_normal((D, N_CLASS))).astype(f32),
        "bh": np.zeros((N_CLASS,), f32),
    }


def field(fp, z, t):
    import torch
    h = torch.tanh(z @ fp["w1"] + fp["b1"])
    return h @ fp["w2"] + fp["b2"]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _ulp(dtype):
    import torch
    return {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7,
            torch.float64: 2.0 ** -52}[dtype]


def _plain(name, ops, trees, h, param):
    """The plain PyTorch version of one op on the same packed buffer. For
    a VJP kernel ``trees`` are the forward inputs followed by the output
    cotangents, and the result is the cotangents of the inputs it
    writes."""
    import torch
    from repro_torch.kernels.alf_step import ref
    fn, ins, metas = {
        "alf_midpoint": (ref.midpoint_ref, (0, 1), (0,)),
        "alf_update": (ref.update_ref, (0, 1, 2), (0, 1)),
        "alf_bwd_pre": (ref.bwd_pre_ref, (0, 1, 2, 3), (0, 2)),
        "alf_bwd_post": (ref.bwd_post_ref, tuple(range(6)), (0, 1, 3, 4)),
        "alf_inverse": (ref.inverse_ref, (0, 1, 2), (0, 1)),
        "alf_inverse_update": (ref.inverse_update_ref, (0, 1, 2), (0, 1)),
        "alf_midpoint_vjp": (ref.midpoint_vjp_ref, (2,), (1,)),
        "alf_update_vjp": (ref.update_vjp_ref, (3, 4), (1, 2)),
    }[name]
    fwd = trees[:2] if name == "alf_midpoint_vjp" else trees[:3]
    _, cd = ops._trees(*(fwd if name in VJPS else trees))
    hh = h.to(torch.promote_types(cd, torch.float32))
    rows = h.shape[0] if h.dim() else 0     # a per-row (B,) h
    bufs = [ops._flatten(trees[i], cd, rows) for i in ins]
    out = ops._plain(fn, hh, *bufs, param=param)
    outs = out if isinstance(out, tuple) else (out,)
    return tuple(ops._Tree(trees[i]).unpack(o, rows)
                 for o, i in zip(outs, metas))


def _call(name, ops, trees, h, param):
    """One op call (for a VJP kernel: the forward op, then one backward
    through it with the given cotangents)."""
    import torch
    import torch.utils._pytree as pytree
    key = "sign" if name in ("alf_midpoint", "alf_midpoint_vjp") else "eta"
    if name not in VJPS:
        out = getattr(ops, name)(*trees, h, **{key: param})
        return out if isinstance(out, tuple) else (out,)
    fwd_name, n_fwd, wrt = {"alf_midpoint_vjp": ("alf_midpoint", 2, (1,)),
                            "alf_update_vjp": ("alf_update", 3, (1, 2))}[name]
    fwd = [pytree.tree_map(lambda x: x.detach().requires_grad_(True), t)
           for t in trees[:n_fwd]]
    out = getattr(ops, fwd_name)(*fwd, h, **{key: param})
    outs = out if isinstance(out, tuple) else (out,)
    inputs = [l for i in wrt for l in pytree.tree_leaves(fwd[i])]
    grads = torch.autograd.grad(
        [l for o in outs for l in pytree.tree_leaves(o)], inputs,
        grad_outputs=[l for t in trees[n_fwd:]
                      for l in pytree.tree_leaves(t)])
    res, at = [], 0
    for i in wrt:
        spec = pytree.tree_structure(fwd[i])
        k = spec.num_leaves
        res.append(pytree.tree_unflatten(list(grads[at:at + k]), spec))
        at += k
    return tuple(res)


def _make_trees(kind: str, n: int, n_in: int, gen):
    import torch
    dev = "cuda"

    def one():
        x = torch.randn(n, device=dev, generator=gen)
        if kind == "f32":
            return x
        if kind == "bf16":
            return x.to(torch.bfloat16)
        if kind == "f64":
            return x.double()
        cut = max(n // 3, 1)            # mixed tree: {f32, bf16}
        return {"a": x[:cut].clone(),
                "b": x[cut:].to(torch.bfloat16).view(1, -1)}

    return [one() for _ in range(n_in)]


def _make_row_trees(kind: str, b: int, d: int, n_in: int, gen):
    """Trees of B rows of d elements each (the batch axis in front of
    every leaf), for a per-row h."""
    import torch
    dev = "cuda"

    def one():
        x = torch.randn(b, d, device=dev, generator=gen)
        if kind == "f32":
            return x
        if kind == "bf16":
            return x.to(torch.bfloat16)
        if kind == "f64":
            return x.double()
        cut = max(d // 3, 1)            # mixed tree: {f32, bf16} per row
        return {"a": x[:, :cut].clone(),
                "b": x[:, cut:].to(torch.bfloat16).reshape(b, 1, -1)}

    return [one() for _ in range(n_in)]


def _leaves_within_ulps(got, want, what: str) -> float:
    import torch.utils._pytree as pytree
    worst = 0.0
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        require(g.dtype == w.dtype and g.shape == w.shape,
                f"{what}: leaf dtype/shape")
        err = float((g.double() - w.double()).abs().max())
        scale = max(1.0, float(w.double().abs().max()))
        tol = KERNEL_ULPS * _ulp(g.dtype) * scale
        require(err <= tol, f"{what}: max abs err {err} > {tol}")
        worst = max(worst, err)
    return worst


def phase_kernels_rows():
    """All eight ALF kernels with a per-row (B,) h against their plain
    versions, each row its own h (a row that read another row's h would
    be off by far more than the tolerance): f32, bf16, a mixed {f32,
    bf16} row and f64, over ROW_CASES; each call must be one launch of
    the per-row instantiation. Every launch holds steps of both signs and
    rows with h exactly 0 (an empty serve slot's). Returns (worst f32
    error at 1024 x 1570, checks) per kernel."""
    import torch
    from repro_torch.kernels.alf_step import alf_step, ops
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = {k: 0.0 for k in KERNELS}
    checks = {k: 0 for k in KERNELS}
    for name, (_, n_in, _, _) in KERNELS.items():
        params = ((1.0, -1.0) if name in ("alf_midpoint", "alf_midpoint_vjp")
                  else (1.0, 0.9))
        n_trees = {"alf_midpoint_vjp": 3, "alf_update_vjp": 5}.get(name,
                                                                   n_in)
        for kind in ("f32", "bf16", "mixed", "f64"):
            for b, d in ROW_CASES:
                if kind == "mixed" and d == 1:
                    continue
                trees = _make_row_trees(kind, b, d, n_trees, gen)
                h = torch.rand(b, device="cuda", generator=gen) * 0.4 + 0.01
                h[::2] *= -1.0          # both directions in one launch
                h[1::4] = 0.0           # an empty serve slot's h
                for p in params:
                    before = alf_step.LAUNCHES[name]
                    before_rows = alf_step.ROW_LAUNCHES[name]
                    got = _call(name, ops, trees, h, p)
                    require(alf_step.LAUNCHES[name] == before + 1
                            and alf_step.ROW_LAUNCHES[name]
                            == before_rows + 1,
                            f"{name} {kind} rows: one op call must be one "
                            "per-row launch")
                    want = _plain(name, ops, trees, h, p)
                    torch.cuda.synchronize()
                    err = _leaves_within_ulps(
                        got, want, f"{name} {kind} B={b} D={d} p={p} rows")
                    if kind == "f32" and (b, d) == (1024, CNF_ROW):
                        worst[name] = max(worst[name], err)
                    checks[name] += 1
    emit({"phase": "kernels_rows", "checks": checks,
          "cases": [list(c) for c in ROW_CASES],
          "max_abs_err_f32_1024x1570": worst})
    return worst, checks


def phase_kernels():
    import torch
    from repro_torch.kernels.alf_step import alf_step, ops, ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    h = torch.tensor(0.23, device="cuda")
    worst = {k: 0.0 for k in KERNELS}
    checks = {k: 0 for k in KERNELS}
    for name, (_, n_in, _, _) in KERNELS.items():
        params = ((1.0, -1.0) if name in ("alf_midpoint", "alf_midpoint_vjp")
                  else (1.0, 0.9))
        # a VJP kernel's trees: its forward op's inputs, then the
        # cotangents of that op's outputs
        n_trees = {"alf_midpoint_vjp": 3, "alf_update_vjp": 5}.get(name,
                                                                   n_in)
        for kind in ("f32", "bf16", "mixed", "f64"):
            for n in (1, TAIL_N, SLICE_N, BACKSOLVE_AUG_N, *CNF_PACKED_N):
                if kind == "mixed" and n == 1:
                    continue
                trees = _make_trees(kind, n, n_trees, gen)
                for p in params:
                    before = alf_step.LAUNCHES[name]
                    got = _call(name, ops, trees, h, p)
                    require(alf_step.LAUNCHES[name] == before + 1,
                            f"{name} {kind}: one op call must be one launch")
                    want = _plain(name, ops, trees, h, p)
                    torch.cuda.synchronize()
                    err = _leaves_within_ulps(got, want,
                                              f"{name} {kind} n={n} p={p}")
                    if kind == "f32" and n == SLICE_N:
                        worst[name] = max(worst[name], err)
                    checks[name] += 1
    # The three vector kernels (16-byte vectors): each input on a 16-byte
    # boundary and 1, 2 and 3 elements past one, one input at a time and
    # all together (an input off the outputs' phase is read element by
    # element, or by vectors again for f64 at 2); the outputs fresh (on a
    # boundary) and, through the library's C entry, 1-3 elements past one
    # (their head written element by element); f32, bf16 and f64 at n = 1,
    # TAIL_N (a tail of whole elements) and the main path's size, and with
    # a per-row h at 3 x 37 and 2048 x 64
    vec_kernels = {
        # name: (launcher, inputs, outputs, plain version, keyword, value)
        "alf_midpoint": (alf_step.midpoint_call, 2, 1, ref.midpoint_ref,
                         "sign", -1.0),
        "alf_update": (alf_step.update_call, 3, 2, ref.update_ref, "eta",
                       0.9),
        "alf_midpoint_vjp": (alf_step.midpoint_vjp_call, 1, 1,
                             ref.midpoint_vjp_ref, "sign", -1.0),
    }
    for name, (launcher, n_in, n_out, plain, key, p) in vec_kernels.items():
        patterns = [(0,) * n_in]
        for off in (1, 2, 3):
            patterns += [tuple(off if i == j else 0 for i in range(n_in))
                         for j in range(n_in)]
            if n_in > 1:
                patterns.append((off,) * n_in)
        for dtype in (torch.float32, torch.bfloat16, torch.float64):
            hd = h.to(torch.promote_types(dtype, torch.float32))
            # (n, h, row length): the scalar h at three sizes, and a
            # per-row h over 3 rows of 37 (rows end inside vectors) and
            # the main path's 2048 x 64, each row its own h
            cases = [(n, hd, 0) for n in (1, TAIL_N, SLICE_N)]
            for b, d in ((3, 37), (N_TRAIN, D)):
                h_rows = (torch.rand(b, device="cuda", generator=gen)
                          - 0.5) * 0.8
                cases.append((b * d, h_rows.to(hd.dtype), d))
            for n, hh, row in cases:
                for offs in patterns:
                    ins = [torch.randn(n + 3, device="cuda", generator=gen)
                           .to(dtype)[o:o + n] for o in offs]
                    want = ops._plain(plain, hh, *ins, param=p)
                    want = want if isinstance(want, tuple) else (want,)
                    for out_off in (None, 1, 2, 3):
                        before = alf_step.LAUNCHES[name]
                        if out_off is None:
                            got = launcher(*ins, hh, **{key: p})
                            got = got if isinstance(got, tuple) else (got,)
                            require(alf_step.LAUNCHES[name] == before + 1,
                                    f"{name}: one call must be one launch")
                        else:
                            got = tuple(
                                torch.empty(n + 3, device="cuda",
                                            dtype=dtype)[out_off:out_off + n]
                                for _ in range(n_out))
                            rc = alf_step._fn(name)(
                                alf_step._DTYPE_CODE[dtype], n,
                                *[x.data_ptr() for x in ins], hh.data_ptr(),
                                row, p, *[x.data_ptr() for x in got],
                                torch.cuda.current_stream().cuda_stream)
                            require(rc == 0, f"{name}: CUDA error {rc}")
                        torch.cuda.synchronize()
                        for g, w in zip(got, want):
                            err = float((g.double() - w.double()).abs()
                                        .max())
                            tol = KERNEL_ULPS * _ulp(dtype) * max(
                                1.0, float(w.double().abs().max()))
                            require(err <= tol, f"{name} {dtype} n={n} "
                                    f"row {row} input offsets {offs} output "
                                    f"offset {out_off}: max abs err {err} > "
                                    f"{tol}")
                        checks[name] += 1
    # alf_update's two outputs share one 16-byte phase: the C entry
    # refuses outputs at two phases (cudaErrorMisalignedAddress), before
    # any launch
    buf = torch.zeros(SLICE_N + 8, device="cuda")
    x = buf[:SLICE_N]
    rc = alf_step._fn("alf_update")(
        0, SLICE_N, x.data_ptr(), x.data_ptr(), x.data_ptr(), h.data_ptr(),
        0, 0.9, buf[4:].data_ptr(), buf[5:].data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    require(rc == 716, f"alf_update: outputs at two 16-byte phases gave "
            f"{rc}, expected 716 (cudaErrorMisalignedAddress)")
    checks["alf_update"] += 1
    emit({"phase": "kernels", "checks": checks,
          "tolerance": f"{KERNEL_ULPS} ulp of the storage dtype at the "
                       "output's largest magnitude (>= 1)",
          "max_abs_err_f32_slice": worst})
    return worst, checks


# ---------------------------------------------------------------------------
# Phase 3: times
# ---------------------------------------------------------------------------

def _time_ms(fn, reps: int) -> float:
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps: int) -> float:
    """Device time per call with the host taken out: ``reps`` calls
    captured into one CUDA graph, replayed and timed with CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def _alternate(kernel, plain, reps):
    """kernel, plain, kernel, plain — each time the mean of its two runs."""
    k1 = _time_ms(kernel, reps)
    p1 = _time_ms(plain, reps)
    k2 = _time_ms(kernel, reps)
    p2 = _time_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _op_host_cost(h):
    """Host cost per call of the forward ALF ops at SLICE_N, f32: CUDA
    events over back-to-back calls (host launch cost included) minus the
    same calls' device time in a CUDA graph, for the raw launcher, the op
    on its grad-free path (under no_grad) and the op through its
    autograd.Function (an input requiring a gradient)."""
    import torch
    from repro_torch.kernels.alf_step import alf_step, ops
    gen = torch.Generator(device="cuda").manual_seed(3)
    z, v, u = (torch.randn(SLICE_N, device="cuda", generator=gen)
               for _ in range(3))
    zg = z.clone().requires_grad_(True)
    calls = {
        "alf_midpoint": (lambda: alf_step.midpoint_call(z, v, h),
                         lambda: ops.alf_midpoint(z, v, h),
                         lambda: ops.alf_midpoint(zg, v, h)),
        "alf_update": (lambda: alf_step.update_call(z, v, u, h),
                       lambda: ops.alf_update(z, v, u, h),
                       lambda: ops.alf_update(zg, v, u, h)),
    }
    out = {}
    for name, fns in calls.items():
        for label, fn, grad in zip(("launcher", "op_no_grad", "op_function"),
                                   fns, (False, False, True)):
            with torch.set_grad_enabled(grad):
                ev, gr = _time_ms(fn, 500), _graph_ms(fn, 100)
            out[f"{name}_{label}"] = {"events_ms": ev, "graph_ms": gr,
                                      "host_ms": ev - gr}
    return out


def _kernel_calls(bufs, h):
    """(kernel, plain version) of each ALF kernel on flat buffers, with a
    0-d or a per-row (B,) h."""
    from repro_torch.kernels.alf_step import alf_step, ops, ref

    def plain(fn, k, param):
        return lambda: ops._plain(fn, h, *bufs[:k], param=param)

    return {
        "alf_midpoint": (lambda: alf_step.midpoint_call(*bufs[:2], h),
                         plain(ref.midpoint_ref, 2, 1.0)),
        "alf_update": (
            lambda: alf_step.update_call(*bufs[:3], h, eta=0.9),
            plain(ref.update_ref, 3, 0.9)),
        "alf_bwd_pre": (
            lambda: alf_step.bwd_pre_call(*bufs[:4], h, eta=0.9),
            plain(ref.bwd_pre_ref, 4, 0.9)),
        "alf_bwd_post": (
            lambda: alf_step.bwd_post_call(*bufs, h, eta=0.9),
            plain(ref.bwd_post_ref, 6, 0.9)),
        "alf_midpoint_vjp": (
            lambda: alf_step.midpoint_vjp_call(bufs[0], h, sign=-1.0),
            plain(ref.midpoint_vjp_ref, 1, -1.0)),
        "alf_update_vjp": (
            lambda: alf_step.update_vjp_call(*bufs[:2], h, eta=0.9),
            plain(ref.update_vjp_ref, 2, 0.9)),
        "alf_inverse": (
            lambda: alf_step.inverse_call(*bufs[:3], h, eta=0.9),
            plain(ref.inverse_ref, 3, 0.9)),
        "alf_inverse_update": (
            lambda: alf_step.inverse_update_call(*bufs[:3], h, eta=0.9),
            plain(ref.inverse_update_ref, 3, 0.9)),
    }


def _row_times(bw: float, peak: float):
    """Each ALF kernel's per-row instantiation beside its scalar one on
    the same buffers, in turns (scalar, per-row, scalar, per-row), at
    2^25 elements as 1024 rows and at the CNF's 1024 x 1570; CUDA-event
    and graph ms of both, and the per-row call's bound (its h adds B
    reads of 4 bytes)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(2)
    h = torch.tensor(0.23, device="cuda")
    out = {}
    for b, d, reps in ((1024, BIG_N // 1024, 20), (1024, CNF_ROW, 200)):
        n = b * d
        bufs = [torch.randn(n, device="cuda", generator=gen)
                for _ in range(6)]
        h_rows = 0.1 + 0.2 * torch.rand(b, device="cuda", generator=gen)
        scalar, per_row = _kernel_calls(bufs, h), _kernel_calls(bufs, h_rows)
        for name, (_, n_in, n_out, flops) in KERNELS.items():
            ms, row_ms = _alternate(scalar[name][0], per_row[name][0], reps)
            bytes_ms = ((n_in + n_out) * 4 * n + 4 * b) / bw * 1e3
            row = {"name": name, "rows": b, "row_len": d, "n": n,
                   "scalar_ms": ms, "per_row_ms": row_ms,
                   "per_row_to_scalar": row_ms / ms,
                   "scalar_graph_ms": _graph_ms(scalar[name][0], reps),
                   "per_row_graph_ms": _graph_ms(per_row[name][0], reps),
                   "per_row_bound_ms": max(bytes_ms,
                                           flops * n / peak * 1e3)}
            emit({"phase": "times_rows", **row})
            out[(name, n)] = row
        del bufs
        torch.cuda.empty_cache()
    return out


def phase_times(card: str):
    import torch
    bw, peak, _ = card_rates(card)
    gen = torch.Generator(device="cuda").manual_seed(1)
    h = torch.tensor(0.23, device="cuda")
    rows = {}
    # every kernel at the main path's size and at 2^25; the forward pair
    # also at the LM paths' ALF state sizes, with graph times at each
    sizes = ((SLICE_N, 500, tuple(KERNELS)),
             (QWEN_ALF_N, 40, FORWARD), (JAMBA_ALF_N, 30, FORWARD),
             (BIG_N, 20, tuple(KERNELS)))
    for n, reps, names in sizes:
        bufs = [torch.randn(n, device="cuda", generator=gen)
                for _ in range(6)]
        calls = _kernel_calls(bufs, h)
        # The one PyTorch call computing the same function, where one
        # exists (precomputed 0-d factors, as the kernels read h once).
        half_h, neg_half_h = h / 2, -h / 2
        library = {
            "alf_midpoint": ("torch.addcmul", lambda: torch.addcmul(
                bufs[0], bufs[1], half_h)),
            "alf_midpoint_vjp": ("torch.mul", lambda: torch.mul(
                bufs[0], neg_half_h)),
        }
        for name in names:
            kern, plain = calls[name]
            _, n_in, n_out, flops = KERNELS[name]
            ms, plain_ms = _alternate(kern, plain, reps)
            bytes_ms = (n_in + n_out) * 4 * n / bw * 1e3
            ops_ms = flops * n / peak * 1e3
            label, lib = library.get(name, (NO_LIBRARY.format(n_out), None))
            row = {"name": name, "n": n, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms
                   else "operations", "library_ms": None, "library": label}
            if lib is not None:
                # kernel, library, kernel, library: the two compared in
                # turns, in one run
                row["ms_beside_library"], row["library_ms"] = _alternate(
                    kern, lib, reps)
                row["to_library"] = (row["ms_beside_library"]
                                     / row["library_ms"])
            if n == SLICE_N:
                # At this size a call costs more on the host than on the
                # card; a CUDA graph of 100 calls shows the device's part,
                # and events minus graph the host's cost per call.
                row["graph_ms"] = _graph_ms(kern, 100)
                row["host_ms_per_call"] = ms - row["graph_ms"]
                row["plain_graph_ms"] = _graph_ms(plain, 100)
                if lib is not None:
                    row["library_graph_ms"] = _graph_ms(lib, 100)
            elif lib is not None or name in FORWARD:
                row["graph_ms"] = _graph_ms(kern, reps)
                if lib is not None:
                    row["library_graph_ms"] = _graph_ms(lib, reps)
            emit({"phase": "times", **row})
            rows[(name, n)] = row
        del bufs
        torch.cuda.empty_cache()
    emit({"phase": "times", "op_host_cost_slice": _op_host_cost(h)})
    return rows, _row_times(bw, peak)


# ---------------------------------------------------------------------------
# Phases 4-7: the port's solve() on the card
# ---------------------------------------------------------------------------

def _leaves_close(got, want, what: str):
    import torch.utils._pytree as pytree
    worst = 0.0
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        excess = ((g - w).abs() - GRAD_TOL["rtol"] * w.abs()).max()
        worst = max(worst, float((g - w).abs().max()))
        require(float(excess) <= GRAD_TOL["atol"],
                f"{what}: gradients differ beyond rtol "
                f"{GRAD_TOL['rtol']} / atol {GRAD_TOL['atol']}")
    return worst


def _counted(what: str, run, steps: int, per_step: dict):
    """Run ``run()`` with every launch and op-call count set to 0 just
    before and read just after; each kernel must have launched exactly
    ``per_step[name] * steps`` times (0 when not named), once per op call.
    Returns (launches, run's result)."""
    from repro_torch.kernels.alf_step import alf_step, ops
    alf_step.reset_launches()
    ops.reset_op_calls()
    out = run()
    launches = dict(alf_step.LAUNCHES)
    op_calls = dict(ops.OP_CALLS)
    for name in KERNELS:
        want = per_step.get(name, 0) * steps
        require(launches[name] == want,
                f"{what}: {name} launched {launches[name]} times in "
                f"{steps} steps, expected {want}")
        require(launches[name] == op_calls[name],
                f"{what}: {name} launches {launches[name]} != op calls "
                f"{op_calls[name]}")
    return launches, out


def _model_loss(params, x, y, solver, gradient, controller):
    import torch
    from repro_torch.core import solve
    sol = solve(field, params["f"], x, 0.0, 1.0, solver=solver,
                controller=controller, gradient=gradient)
    z = sol.ys * params["norm"]
    logits = z @ params["head"] + params["bh"]
    return torch.nn.functional.cross_entropy(logits, y), sol.stats


def _grads(params, x, y, solver, gradient, controller):
    import torch
    import torch.utils._pytree as pytree
    leaves = pytree.tree_leaves(params)
    loss, _ = _model_loss(params, x, y, solver, gradient, controller)
    return pytree.tree_unflatten(list(torch.autograd.grad(loss, leaves)),
                                 pytree.tree_flatten(params)[1])


def _train(x, y, solver, ctrl, gradient=None, steps=TRAIN_STEPS,
           loss_fn=None):
    """``steps`` Adam steps of the Sec 4.2 model from the seeded
    parameters (MALI unless another gradient is given, or
    ``loss_fn(params)`` in place of the solve); returns the losses and the
    wall seconds."""
    import torch
    import torch.utils._pytree as pytree
    from repro_torch import params_from_numpy
    from repro_torch.core import MALI
    gradient = MALI() if gradient is None else gradient
    if loss_fn is None:
        def loss_fn(params):
            return _model_loss(params, x, y, solver, gradient, ctrl)[0]
    params = params_from_numpy(init_params_numpy(0))
    for p in pytree.tree_leaves(params):
        p.requires_grad_(True)
    opt = torch.optim.Adam(pytree.tree_leaves(params), lr=LR)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [float(l) for l in losses], wall


def phase_main_path():
    import torch
    import torch.utils._pytree as pytree
    from repro_torch import params_from_numpy
    from repro_torch.core import ALF, MALI, ConstantSteps, Naive

    x_np, y_np = make_data(N_TRAIN, seed=0)
    x = torch.as_tensor(x_np, device="cuda")
    y = torch.as_tensor(y_np, device="cuda")
    params = params_from_numpy(init_params_numpy(0))
    for p in pytree.tree_leaves(params):
        p.requires_grad_(True)
    ctrl = ConstantSteps(N_SUB)
    cuda_alf, ref_alf = ALF(eta=1.0, backend="cuda"), ALF(eta=1.0)

    # MALI (kernels) vs Naive (reference backend) at the first step's
    # parameters, on the card.
    g_mali = _grads(params, x, y, cuda_alf, MALI(), ctrl)
    g_naive = _grads(params, x, y, ref_alf, Naive(), ctrl)
    grad_err = _leaves_close(g_mali, g_naive, "main path MALI vs Naive")

    launches, (losses, wall) = _counted(
        "main path", lambda: _train(x, y, cuda_alf, ctrl), TRAIN_STEPS,
        {"alf_midpoint": N_SUB, "alf_update": N_SUB, "alf_bwd_pre": N_SUB,
         "alf_bwd_post": N_SUB})
    require(all(np.isfinite(losses)), f"non-finite losses {losses}")
    require(losses[-1] < losses[0],
            f"loss did not fall: {losses[0]} -> {losses[-1]}")

    # The same training on the reference backend (plain tensor ops), in
    # turns with the kernel backend: the host clock is noisy here, so
    # TIME_PAIRS pairs, alternating which backend runs first.
    ref_losses, _ = _train(x, y, ref_alf, ctrl)
    loss_gap = max(abs(a - b) for a, b in zip(losses, ref_losses))
    require(loss_gap <= 1e-4, f"kernel and reference loss traces differ by "
            f"{loss_gap}")
    step_ms = _step_times(x, y, ctrl, MALI(), TIME_PAIRS)
    emit({"phase": "main_path", "model": "paper Sec 4.2 (D=64, HIDDEN=64, "
          "3 classes, 2048 images)", "steps": TRAIN_STEPS,
          "first_loss": losses[0], "last_loss": losses[-1],
          "launches": launches,
          "forward_launches_per_step": (launches["alf_midpoint"]
                                        + launches["alf_update"])
          // TRAIN_STEPS,
          "backward_launches_per_step": (launches["alf_bwd_pre"]
                                         + launches["alf_bwd_post"])
          // TRAIN_STEPS,
          "mali_vs_naive_max_abs_grad_diff": grad_err,
          "first_run_step_ms_cuda": wall / TRAIN_STEPS * 1e3,
          "step_ms_cuda": step_ms["cuda"],
          "step_ms_reference": step_ms["reference"],
          "median_step_ms_cuda": float(np.median(step_ms["cuda"])),
          "median_step_ms_reference": float(np.median(step_ms["reference"])),
          "max_loss_gap_cuda_vs_reference": loss_gap})
    return launches, losses


def _step_times(x, y, ctrl, gradient, pairs: int):
    """ms per training step on each ALF backend, ``pairs`` runs of
    TRAIN_STEPS steps each, alternating which backend runs first (the
    host clock is noisy here)."""
    from repro_torch.core import ALF
    step_ms = {"cuda": [], "reference": []}
    order = (("reference", ALF(eta=1.0)), ("cuda", ALF(eta=1.0,
                                                       backend="cuda")))
    for i in range(pairs):
        for name, solver in order[::1 if i % 2 == 0 else -1]:
            _, w = _train(x, y, solver, ctrl, gradient)
            step_ms[name].append(w / TRAIN_STEPS * 1e3)
    return step_ms


def phase_adaptive():
    import torch
    import torch.utils._pytree as pytree
    from repro_torch import params_from_numpy
    from repro_torch.core import (ALF, MALI, AdaptiveController, Naive,
                                  SaveAt, solve)
    x_np, _ = make_data(N_TRAIN, seed=0)
    fp = params_from_numpy(init_params_numpy(0)["f"])
    ctrl = AdaptiveController(1e-4, 1e-5, 128)
    saveat = SaveAt(ts=torch.linspace(0.0, 1.0, 5))
    out = {}
    for label, solver, gradient in (
            ("mali_cuda", ALF(eta=1.0, backend="cuda"), MALI()),
            ("naive_reference", ALF(eta=1.0), Naive())):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in fp.items()}
        z0 = torch.as_tensor(x_np, device="cuda").requires_grad_(True)
        sol = solve(field, p, z0, solver=solver, controller=ctrl,
                    gradient=gradient, saveat=saveat)
        loss = (sol.ys ** 2).mean()
        grads = torch.autograd.grad(loss, [*pytree.tree_leaves(p), z0])
        out[label] = (sol, grads)
    (s_m, g_m), (s_n, g_n) = out["mali_cuda"], out["naive_reference"]
    counts = [int(s_m.stats.n_accepted), int(s_m.stats.n_rejected)]
    require(counts == [int(s_n.stats.n_accepted),
                       int(s_n.stats.n_rejected)],
            "adaptive: MALI and Naive took different step sequences")
    require(tuple(s_m.ys.shape) == (5, N_TRAIN, D)
            and bool(torch.isfinite(s_m.ys).all()), "adaptive: ys")
    err = _leaves_close(g_m, g_n, "adaptive MALI vs Naive")
    emit({"phase": "adaptive", "controller": "AdaptiveController(1e-4, "
          "1e-5, 128)", "saveat": "linspace(0, 1, 5)",
          "n_accepted": counts[0], "n_rejected": counts[1],
          "mali_vs_naive_max_abs_grad_diff": err})


def _solve_grads(p, z0, solver, gradient, ctrl, saveat=None, t1=1.0,
                 readout=None):
    """A solve from fresh leaves of ``p`` and ``z0``; returns the solution
    and d(mean(readout(sol)^2))/d(params, z0)."""
    import torch
    import torch.utils._pytree as pytree
    from repro_torch.core import solve
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    z0 = z0.detach().clone().requires_grad_(True)
    sol = solve(field, p, z0, 0.0, t1, solver=solver, controller=ctrl,
                gradient=gradient, saveat=saveat)
    out = sol.ys if readout is None else readout(sol)
    grads = torch.autograd.grad((out ** 2).mean(),
                                [*pytree.tree_leaves(p), z0])
    return sol, grads


def phase_direct_backprop(mali_losses):
    """Direct backprop through the kernels on the Sec 4.2 model at full
    width: Naive and unfused MALI on the cuda backend, h's cotangent under
    adaptive control, the per-step and dense outputs, Naive's step time."""
    import torch
    import torch.utils._pytree as pytree
    from repro_torch import params_from_numpy
    from repro_torch.core import (ALF, MALI, AdaptiveController,
                                  ConstantSteps, Naive, SaveAt)
    x_np, y_np = make_data(N_TRAIN, seed=0)
    x = torch.as_tensor(x_np, device="cuda")
    y = torch.as_tensor(y_np, device="cuda")
    params = params_from_numpy(init_params_numpy(0))
    for p in pytree.tree_leaves(params):
        p.requires_grad_(True)
    ctrl = ConstantSteps(N_SUB)
    cuda_alf, ref_alf = ALF(eta=1.0, backend="cuda"), ALF(eta=1.0)
    out = {}

    # (a) Naive x cuda: gradients against Naive on the reference backend
    # and fused MALI on cuda; 20 Adam steps against phase 4's MALI trace.
    g_naive = _grads(params, x, y, cuda_alf, Naive(), ctrl)
    out["naive_cuda_vs_naive_reference"] = _leaves_close(
        g_naive, _grads(params, x, y, ref_alf, Naive(), ctrl),
        "Naive cuda vs Naive reference")
    g_mali = _grads(params, x, y, cuda_alf, MALI(), ctrl)
    out["naive_cuda_vs_mali_cuda"] = _leaves_close(
        g_naive, g_mali, "Naive cuda vs MALI cuda")
    naive_launches, (losses, _) = _counted(
        "Naive x cuda", lambda: _train(x, y, cuda_alf, ctrl, Naive()),
        TRAIN_STEPS, {"alf_midpoint": N_SUB, "alf_update": N_SUB,
                      "alf_midpoint_vjp": N_SUB, "alf_update_vjp": N_SUB})
    gap = max(abs(a - b) for a, b in zip(losses, mali_losses))
    require(gap <= 1e-4, f"Naive x cuda loss trace differs from MALI's by "
            f"{gap}")
    out.update(naive_first_loss=losses[0], naive_last_loss=losses[-1],
               naive_vs_mali_max_loss_gap=gap)

    # (b) MALI(fused_bwd=False) x cuda: psi^-1 through the inverse kernels
    # and the step replayed through the reverse rules.
    unfused = MALI(fused_bwd=False)
    out["unfused_mali_cuda_vs_mali_cuda"] = _leaves_close(
        _grads(params, x, y, cuda_alf, unfused, ctrl), g_mali,
        "unfused MALI cuda vs fused MALI cuda")
    unfused_launches, _ = _counted(
        "MALI(fused_bwd=False) x cuda",
        lambda: _train(x, y, cuda_alf, ctrl, unfused, steps=UNFUSED_STEPS),
        UNFUSED_STEPS,
        {"alf_midpoint": 3 * N_SUB, "alf_update": 2 * N_SUB,
         "alf_inverse": N_SUB, "alf_midpoint_vjp": N_SUB,
         "alf_update_vjp": N_SUB})

    # (c) adaptive control: Naive differentiates through the step sizes
    # (h's cotangent), MALI holds the step sequence fixed.
    fp = params_from_numpy(init_params_numpy(0)["f"])
    z0 = torch.as_tensor(x_np, device="cuda")
    adaptive = AdaptiveController(1e-4, 1e-5, 128)
    grid = SaveAt(ts=torch.linspace(0.0, 1.0, 5))
    s_n, g_n = _solve_grads(fp, z0, cuda_alf, Naive(), adaptive, grid)
    s_m, g_m = _solve_grads(fp, z0, cuda_alf, MALI(), adaptive, grid)
    counts = [int(s_n.stats.n_accepted), int(s_n.stats.n_rejected)]
    require(counts == [int(s_m.stats.n_accepted),
                       int(s_m.stats.n_rejected)],
            "adaptive: Naive and MALI took different step sequences")
    out.update(adaptive_n_accepted=counts[0], adaptive_n_rejected=counts[1],
               adaptive_naive_cuda_vs_mali_cuda=_leaves_close(
                   g_n, g_m, "adaptive Naive cuda vs MALI cuda"))

    # (d) per-step and dense output over the one span [0, 1], cuda against
    # the reference backend.
    span_ctrl = AdaptiveController(1e-3, 1e-4, 256)
    for mode, saveat, readout in (
            ("steps", SaveAt(steps=True), None),
            ("dense", SaveAt(dense=True), lambda sol: sol.evaluate(0.37))):
        s_c, g_c = _solve_grads(fp, z0, cuda_alf, Naive(), span_ctrl, saveat,
                                readout=readout)
        s_r, g_r = _solve_grads(fp, z0, ref_alf, Naive(), span_ctrl, saveat,
                                readout=readout)
        y_c = s_c.ys if readout is None else readout(s_c)
        y_r = s_r.ys if readout is None else readout(s_r)
        require(bool(torch.isfinite(y_c).all()), f"{mode}: non-finite ys")
        require(int(s_c.num_steps) == int(s_r.num_steps)
                and bool(s_c.stats.span_complete),
                f"{mode}: step counts differ or span incomplete")
        out[f"{mode}_num_steps"] = int(s_c.num_steps)
        out[f"{mode}_ys_cuda_vs_reference"] = _leaves_close(
            y_c.detach(), y_r.detach(), f"{mode} ys")
        out[f"{mode}_grad_cuda_vs_reference"] = _leaves_close(
            g_c, g_r, f"{mode} gradients")

    # (e) step time of (a) on each backend.
    step_ms = _step_times(x, y, ctrl, Naive(), NAIVE_TIME_PAIRS)
    emit({"phase": "direct_backprop", **out,
          "naive_launches": naive_launches,
          "unfused_mali_launches": unfused_launches,
          "unfused_mali_steps": UNFUSED_STEPS,
          "naive_step_ms_cuda": step_ms["cuda"],
          "naive_step_ms_reference": step_ms["reference"],
          "median_naive_step_ms_cuda": float(np.median(step_ms["cuda"])),
          "median_naive_step_ms_reference": float(
              np.median(step_ms["reference"]))})
    return {**naive_launches,
            "alf_inverse": unfused_launches["alf_inverse"]}


def phase_memory():
    import torch
    import torch.utils._pytree as pytree
    from repro_torch import params_from_numpy
    from repro_torch.core import ALF, MALI, ConstantSteps, Naive, solve
    x_np, _ = make_data((1 << 20) // D, seed=2)
    fp = params_from_numpy(init_params_numpy(0)["f"])
    peaks = {}
    for label, solver, gradient in (
            ("mali_cuda", ALF(eta=1.0, backend="cuda"), MALI()),
            ("naive_reference", ALF(eta=1.0), Naive()),
            ("naive_cuda", ALF(eta=1.0, backend="cuda"), Naive())):
        for n in (8, 64):
            p = {k: v.detach().clone().requires_grad_(True)
                 for k, v in fp.items()}
            z0 = torch.as_tensor(x_np, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            sol = solve(field, p, z0, 0.0, 1.0, solver=solver,
                        controller=ConstantSteps(n), gradient=gradient)
            loss = (sol.ys ** 2).mean()
            torch.autograd.grad(loss, pytree.tree_leaves(p))
            torch.cuda.synchronize()
            peaks[(label, n)] = torch.cuda.max_memory_allocated() - base
            del sol, loss
    growth = {k: peaks[(k, 64)] / peaks[(k, 8)]
              for k in ("mali_cuda", "naive_reference", "naive_cuda")}
    emit({"phase": "memory", "state_elements": 1 << 20,
          "peak_bytes": {f"{k}_n{n}": v for (k, n), v in peaks.items()},
          "mali_growth_8_to_64": growth["mali_cuda"],
          "naive_growth_8_to_64": growth["naive_reference"],
          "naive_cuda_growth_8_to_64": growth["naive_cuda"]})
    require(growth["mali_cuda"] <= 1.05, f"MALI peak memory grew "
            f"{growth['mali_cuda']}x from 8 to 64 steps")
    for k in ("naive_reference", "naive_cuda"):
        require(growth[k] > 2.0, f"{k} peak memory grew only {growth[k]}x")


def _busy_us(events) -> float:
    """Union length of the device events' time ranges (us)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for s0, e0 in spans[1:]:
        if s0 > hi:
            busy += hi - lo
            lo, hi = s0, e0
        else:
            hi = max(hi, e0)
    return busy + hi - lo


def _device_profile(run):
    """torch.profiler over ``run()``: device busy/idle share, the top
    device operations, and the host's wall time of ``run()`` beside the
    host self-time of its CPU events by op (PyTorch ops and CUDA runtime
    calls); what is left is Python between the ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if str(getattr(e, "device_type", "")).endswith("CUDA")
           and not getattr(e, "is_user_annotation", False)
           and "#" not in e.name]
    require(len(dev) > 0, "profile: no device events")
    window = (max(e.time_range.end for e in dev)
              - min(e.time_range.start for e in dev))
    busy = _busy_us(dev)
    by_name = {}
    for e in dev:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    host = [(a.key, a.self_cpu_time_total / 1e3, a.count)
            for a in prof.key_averages()
            if a.key != "cudaDeviceSynchronize"]
    in_ops = sum(ms for _, ms, _ in host)
    top_host = sorted(host, key=lambda r: -r[1])[:10]
    return {"device_busy_ms": busy / 1e3, "device_window_ms": window / 1e3,
            "idle_share": 1.0 - busy / window, "device_launches": len(dev),
            "top_device_ms": [[name[:60], ms, n] for name, (ms, n) in top],
            "host_ms": host_ms, "host_self_in_ops_ms": in_ops,
            "host_outside_ops_ms": host_ms - in_ops,
            "top_host_self_ms": [[k[:60], ms, n] for k, ms, n in top_host]}


def _host_profile(run, top: int = 12):
    """cProfile over ``run()`` (ended by a device sync): the host's self
    time by Python source file and by function, the costs that the
    profiler's op events cannot name (tree maps, argument marshalling,
    Python between launches)."""
    import cProfile
    import pstats
    import torch
    prof = cProfile.Profile()
    prof.enable()
    run()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats      # (file, line, fn) -> (cc, nc, tt, ..)
    by_file, by_fn = {}, []
    for (path, line, fn), (_cc, nc, tt, _ct, _callers) in stats.items():
        where = "/".join(Path(path).parts[-2:]) if path != "~" else "~"
        by_file[where] = by_file.get(where, 0.0) + tt * 1e3
        by_fn.append((f"{where}:{line}:{fn}"[:80], tt * 1e3, nc))
    return {"total_ms": sum(by_file.values()),
            "by_file_ms": sorted(([k, v] for k, v in by_file.items()),
                                 key=lambda r: -r[1])[:top],
            "by_function_ms": [list(r) for r in
                               sorted(by_fn, key=lambda r: -r[1])[:top]]}


def phase_profile():
    """torch.profiler over TRAIN_STEPS training steps of the main path on
    each backend: the device's busy and idle share and the top device
    operations."""
    import torch
    from repro_torch.core import ALF, ConstantSteps
    x_np, y_np = make_data(N_TRAIN, seed=0)
    x = torch.as_tensor(x_np, device="cuda")
    y = torch.as_tensor(y_np, device="cuda")
    out = {}
    for backend in ("cuda", "reference"):
        solver = ALF(eta=1.0, backend=backend)
        _train(x, y, solver, ConstantSteps(N_SUB))          # warm
        out[backend] = {"steps": TRAIN_STEPS, **_device_profile(
            lambda: _train(x, y, solver, ConstantSteps(N_SUB)))}
    emit({"phase": "profile", **out})


# ---------------------------------------------------------------------------
# Phases 9-11: the LM serving slice (qwen3-1.7b)
# ---------------------------------------------------------------------------

def _close(got, want, rtol: float, atol: float, what: str) -> float:
    """Require finite values with |got - want| <= atol + rtol * |want|
    elementwise; returns the max abs difference."""
    import torch
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{what}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
            f"{tuple(want.shape)} {want.dtype}")
    g, w = got.double(), want.double()
    require(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    diff = (g - w).abs()
    excess = float((diff - rtol * w.abs()).max())
    require(excess <= atol, f"{what}: differs beyond rtol {rtol} / atol "
            f"{atol} (max abs diff {float(diff.max())})")
    return float(diff.max())


def _scan_inputs(gen, bt, s, di, st, dtype, delta_dtype=None):
    """delta, u, A, B, C as tests/test_kernels.py makes them: delta =
    softplus(normal), A = -exp(0.3 normal) (f32), the rest normal."""
    import torch

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    delta = torch.nn.functional.softplus(randn(bt, s, di)).to(
        delta_dtype or dtype)
    a = -torch.exp(0.3 * randn(di, st))
    return (delta, randn(bt, s, di).to(dtype), a,
            randn(bt, s, st).to(dtype), randn(bt, s, st).to(dtype))


def _scan_checks(gen, worst, what):
    """The scan kernel against its plain version: MS_CASES, a given h0 and
    strided operands, f32 and bf16 inputs; one op call must be one
    launch. Returns the number of checks."""
    import torch
    from repro_torch.kernels.mamba_scan import mamba_scan as ms_k
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.mamba_scan import ref as ms_ref
    rtol, atol = MS_TOL
    n = 0

    def check(args, label, key):
        before = ms_k.LAUNCHES["selective_scan"]
        got = ms_ops.selective_scan(*args)
        require(ms_k.LAUNCHES["selective_scan"] == before + 1,
                "selective_scan: one op call must be one launch")
        want = ms_ref.selective_scan_ref(*args)
        torch.cuda.synchronize()
        for g, w, part in zip(got, want, ("y", "h")):
            err = _close(g, w, rtol, atol, f"selective_scan {label} {part}")
            worst[key] = max(worst.get(key, 0.0), err)
            worst[f"{key}_{part}"] = max(worst.get(f"{key}_{part}", 0.0),
                                         err)
        # h repeats the plain version's operations in its order
        require(worst[f"{key}_h"] == 0.0,
                f"selective_scan {label}: h differs from the plain version "
                f"by {worst[f'{key}_h']}, not bit for bit")

    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        for case in MS_CASES:
            check(_scan_inputs(gen, *case, dtype), f"{key} {case}", key)
            n += 1
        # the chunked-prefill invariant's input: a given state h0
        bt, s, di, st = 2, 40, 384, 16
        args = _scan_inputs(gen, bt, s, di, st, dtype)
        h0 = torch.randn(bt, di, st, generator=gen, device="cuda")
        check((*args, h0), f"{key} h0", key)
        # B, C as slices of one projection (the Mamba prefill's layout),
        # delta and u as transposed views
        delta, u, a, b, c = args
        proj = torch.cat([torch.randn(bt, s, 7, generator=gen,
                                      device="cuda").to(dtype), b, c], -1)
        strided = (delta.transpose(1, 2).contiguous().transpose(1, 2),
                   u.transpose(1, 2).contiguous().transpose(1, 2), a,
                   proj[..., 7:7 + st], proj[..., 7 + st:])
        require(not any(t.is_contiguous() for t in strided[:2]
                        + strided[3:]), f"{what}: strided operands")
        check(strided, f"{key} strided", key)
        n += 2
    return n


def _rn_dims():
    """Every config's d_model and q/k-norm d_head, and RN_EXTRA_DIMS."""
    from repro_torch.configs import ARCHS
    dims = set(RN_EXTRA_DIMS)
    for cfg in ARCHS.values():
        dims.add(cfg.d_model)
        if cfg.qk_norm:
            dims.add(cfg.d_head)
    return sorted(dims)


def phase_lm_kernels():
    """RMSNorm, flash attention and the selective scan against their plain
    versions."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa_k
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rmsnorm import ref as rn_ref
    from repro_torch.kernels.rmsnorm import rmsnorm as rn_k
    gen = torch.Generator(device="cuda").manual_seed(3)
    checks = {"rmsnorm": 0, "flash_attention": 0, "selective_scan": 0}
    worst = {"rmsnorm": {}, "flash_attention": {}, "selective_scan": {}}

    def randn(*shape, dtype, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen,
                                    device="cuda")).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        rtol, atol = RN_TOL[key]
        for rows in RN_ROWS:
            for d in _rn_dims():
                x = randn(rows, d, dtype=dtype, scale=3.0)
                scale = (1.0 + randn(d, dtype=torch.float32, scale=0.1)
                         ).to(dtype)
                before = rn_k.LAUNCHES["rmsnorm"]
                got = rn_ops.rmsnorm(x, scale)
                require(rn_k.LAUNCHES["rmsnorm"] == before + 1,
                        "rmsnorm: one op call must be one launch")
                want = rn_ref.rmsnorm_ref(x, scale)
                torch.cuda.synchronize()
                err = _close(got, want, rtol, atol,
                             f"rmsnorm {key} rows={rows} d={d}")
                worst["rmsnorm"][key] = max(worst["rmsnorm"].get(key, 0.0),
                                            err)
                checks["rmsnorm"] += 1
        del x, got, want
        rtol, atol = FA_TOL[key]
        for case in FA_CASES:
            b, sq, sk, h, kv, d, causal, window, cap = case
            q = randn(b, sq, h, d, dtype=dtype)
            k = randn(b, sk, kv, d, dtype=dtype)
            v = randn(b, sk, kv, d, dtype=dtype)
            kw = dict(causal=causal, window=window, softcap=cap)
            before = fa_k.LAUNCHES["flash_attention"]
            got = fa_ops.flash_attention(q, k, v, **kw)
            require(fa_k.LAUNCHES["flash_attention"] == before + 1,
                    "flash_attention: one op call must be one launch")
            want = fa_ref.attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err = _close(got, want, rtol, atol,
                         f"flash_attention {key} {case}")
            worst["flash_attention"][key] = max(
                worst["flash_attention"].get(key, 0.0), err)
            checks["flash_attention"] += 1
        # operands by strides: q, k, v as transposed views of
        # [B, H, S, d] buffers (the head dim still contiguous)
        b, s, h, kv, d = 2, 130, 4, 2, 64
        q = randn(b, h, s, d, dtype=dtype).transpose(1, 2)
        k = randn(b, kv, s, d, dtype=dtype).transpose(1, 2)
        v = randn(b, kv, s, d, dtype=dtype).transpose(1, 2)
        got = fa_ops.flash_attention(q, k, v, causal=True, window=0,
                                     softcap=0.0)
        want = fa_ref.attention_ref(q, k, v, causal=True)
        torch.cuda.synchronize()
        _close(got, want, rtol, atol, f"flash_attention {key} strided")
        checks["flash_attention"] += 1
        # q at a base 2 bytes past a 16-byte boundary: the f32 kernel reads
        # it; the bf16 kernel's TMA cannot, and its launcher must raise
        # (no copy is made)
        buf = randn(b * s * h * d + 1, dtype=dtype)
        q = buf[1:].view(b, s, h, d)
        k = randn(b, s, kv, d, dtype=dtype)
        v = randn(b, s, kv, d, dtype=dtype)
        before = fa_k.LAUNCHES["flash_attention"]
        if dtype == torch.bfloat16:
            try:
                fa_ops.flash_attention(q, k, v, causal=True)
                raised = False
            except ValueError as e:
                raised = "16-byte" in str(e)
            require(raised and fa_k.LAUNCHES["flash_attention"] == before,
                    "flash_attention: a bf16 q off a 16-byte boundary must "
                    "raise before launching")
        else:
            got = fa_ops.flash_attention(q, k, v, causal=True)
            want = fa_ref.attention_ref(q, k, v, causal=True)
            torch.cuda.synchronize()
            _close(got, want, rtol, atol, f"flash_attention {key} unaligned")
        checks["flash_attention"] += 1
    checks["selective_scan"] = _scan_checks(gen, worst["selective_scan"],
                                            "selective_scan")
    emit({"phase": "lm_kernels", "checks": checks,
          "max_abs_err": worst,
          "tolerance": {"rmsnorm": RN_TOL, "flash_attention": FA_TOL,
                        "selective_scan": MS_TOL,
                        "rule": "|got - want| <= atol + rtol * |want| "
                                "elementwise, want = the plain version"}})
    return worst, checks


def phase_lm_times(card: str):
    """The two kernels at qwen3-1.7b's prefill shapes against their bound,
    their plain versions and one library call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa_k
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rmsnorm import ref as rn_ref
    from repro_torch.kernels.rmsnorm import rmsnorm as rn_k
    bw, f32_peak, bf16_peak = card_rates(card)
    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16 = torch.bfloat16
    rows = {}

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(bf16)

    tokens = LM_BATCH * LM_PROMPT
    for label, (n, d) in (
            ("rmsnorm", (tokens, cfg.d_model)),                # d_model norm
            ("rmsnorm_qk", (tokens * cfg.n_heads, cfg.d_head))):  # q-norm
        x, scale = rand(n, d), rand(d)
        kern = lambda: rn_k.rmsnorm_call(x, scale)            # noqa: E731
        plain = lambda: rn_ref.rmsnorm_ref(x, scale)          # noqa: E731
        lib = lambda: F.rms_norm(x, (d,), scale, 1e-6)        # noqa: E731
        ms, plain_ms = _alternate(kern, plain, 200)
        bytes_ms = (2 * n * d + d) * 2 / bw * 1e3
        ops_ms = 4 * n * d / f32_peak * 1e3
        rows[label] = {
            "name": label, "shape": [n, d], "dtype": "bfloat16",
            "ms": ms, "plain_ms": plain_ms, "library_ms": _time_ms(lib, 200),
            "library": "torch.nn.functional.rms_norm",
            "graph_ms": _graph_ms(kern, 100),
            "plain_graph_ms": _graph_ms(plain, 100),
            "library_graph_ms": _graph_ms(lib, 100),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        emit({"phase": "lm_times", **rows[label]})
        del x
    b, s, h, kv, d = LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.n_kv_heads, \
        cfg.d_head
    q, k, v = rand(b, s, h, d), rand(b, s, kv, d), rand(b, s, kv, d)
    # the library's own [B, H, S, d] layout, made outside the timed call
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kern = lambda: fa_k.flash_attention_call(q, k, v, causal=True)  # noqa
    plain = lambda: fa_ref.attention_ref(q, k, v, causal=True)      # noqa
    lib = lambda: F.scaled_dot_product_attention(                   # noqa
        qt, kt, vt, is_causal=True, enable_gqa=True)
    # the yardstick computes the same function
    _close(lib().transpose(1, 2), plain(), *FA_LIB_TOL,
           "scaled_dot_product_attention against the plain version")
    ms, plain_ms = _alternate(kern, plain, 10)
    pairs = b * h * s * (s + 1) // 2          # unmasked (query, key) pairs
    ops_ms = 4 * pairs * d / bf16_peak * 1e3
    bytes_ms = (2 * b * s * h * d + 2 * b * s * kv * d) * 2 / bw * 1e3
    rows["flash_attention"] = {
        "name": "flash_attention", "shape": [b, s, h, kv, d],
        "dtype": "bfloat16", "ms": ms, "plain_ms": plain_ms,
        "library_ms": _time_ms(lib, 10),
        "library": "scaled_dot_product_attention(is_causal=True, "
                   "enable_gqa=True)",
        "graph_ms": _graph_ms(kern, 10),
        "plain_graph_ms": _graph_ms(plain, 5),
        "library_graph_ms": _graph_ms(lib, 10),
        "flops": 4 * pairs * d,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    fa = rows["flash_attention"]
    # useful operations (the masked half of the scores not counted) per
    # second of device time
    fa["tflops_per_s"] = fa["flops"] / fa["graph_ms"] / 1e9
    fa["library_tflops_per_s"] = fa["flops"] / fa["library_graph_ms"] / 1e9
    emit({"phase": "lm_times", **fa})
    del q, k, v, qt, kt, vt
    rows["selective_scan"] = _scan_times(gen, bw, f32_peak)
    emit({"phase": "lm_times", **rows["selective_scan"]})
    return rows


def _scan_times(gen, bw: float, f32_peak: float):
    """The scan kernel at Jamba's prefill shape with the model's dtypes
    (delta f32, u/B/C bf16, A and h0 f32) against its bound and its plain
    version (a Python loop over S)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_scan import mamba_scan as ms_k
    from repro_torch.kernels.mamba_scan import ref as ms_ref
    cfg = get_config(SSM_ARCH)
    bt, s = SSM_BATCH, SSM_PROMPT
    di, st = cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state
    delta, u, a, b, c = _scan_inputs(gen, bt, s, di, st, torch.bfloat16,
                                     torch.float32)
    h0 = torch.zeros(bt, di, st, device="cuda")
    kern = lambda: ms_k.selective_scan_call(delta, u, a, b, c, h0)  # noqa
    plain = lambda: ms_ref.selective_scan_ref(delta, u, a, b, c, h0)  # noqa
    ms, plain_ms = _alternate(kern, plain, 4)
    n = bt * s * di
    # each input read once, each output written once
    moved = (n * (delta.element_size() + u.element_size() + 4)
             + 2 * bt * s * st * b.element_size() + di * st * 4
             + 2 * bt * di * st * 4)
    # per (b, t, i, s): delta*A, exp, dA*h, du*B, +, h*C, + (exp counted
    # as one f32 operation); per (b, t, i): delta*u
    ops = 7 * n * st + n
    bytes_ms, ops_ms = moved / bw * 1e3, ops / f32_peak * 1e3
    # each expf is one MUFU ex2, and the MUFU unit retires 16 a clock per
    # SM: at the card's maximum SM clock that is a floor of its own
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    mufu_ms = n * st / (sms * 16 * mhz * 1e6) * 1e3
    terms = {"bytes": bytes_ms, "operations": ops_ms, "mufu": mufu_ms}
    return {"name": "selective_scan", "shape": [bt, s, di, st],
            "dtype": "delta f32, u/B/C bfloat16", "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "library": "none: no single PyTorch call computes a selective "
                       "scan",
            "graph_ms": _graph_ms(kern, 20),
            "plain_graph_ms": _graph_ms(plain, 1),
            "bytes": moved, "operations": ops, "expf": n * st,
            "bytes_ms": bytes_ms, "operations_ms": ops_ms,
            "mufu_ms": mufu_ms, "sms": sms, "max_sm_mhz": mhz,
            "bound_ms": max(terms.values()),
            "bound_by": max(terms, key=terms.get)}


def _lm_modules():
    """(launcher, op) modules of the LM paths' four kernel packages."""
    from repro_torch.kernels.alf_step import alf_step
    from repro_torch.kernels.alf_step import ops as alf_ops
    from repro_torch.kernels.flash_attention import flash_attention as fa_k
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import mamba_scan as ms_k
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rmsnorm import rmsnorm as rn_k
    return ((alf_step, alf_ops), (fa_k, fa_ops), (rn_k, rn_ops),
            (ms_k, ms_ops))


def _lm_reset():
    for launcher, ops in _lm_modules():
        launcher.reset_launches()
        ops.reset_op_calls()


def _lm_counts():
    """(launches, op calls) of the LM path's kernels since _lm_reset()."""
    launches, calls = {}, {}
    for launcher, ops in _lm_modules():
        launches.update(launcher.LAUNCHES)
        calls.update(ops.OP_CALLS)
    return launches, calls


def _lm_check_counts(what: str, per: dict, times: int = 1,
                     plus: dict = None):
    """Every LM-path kernel launched exactly per[name] * times (+ plus)
    times since _lm_reset(), once per op call; every other kernel 0."""
    launches, calls = _lm_counts()
    for name, n in launches.items():
        want = per.get(name, 0) * times + (plus or {}).get(name, 0)
        require(n == want, f"{what}: {name} launched {n} times, expected "
                f"{want}")
        require(n == calls[name], f"{what}: {name} launches {n} != op calls "
                f"{calls[name]}")
    return launches


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def _serve_run(params, cfg, toks, prompt: int, n_decode: int,
               backend: str):
    """prefill + n_decode teacher-forced decode steps: (logits [B, 1 + n,
    V], the MoE routes of every call, prefill ms, decode ms per step)."""
    import torch
    from repro_torch.models import decode_step, init_serve_state, prefill
    from repro_torch.models.moe import recording_routes
    state = init_serve_state(cfg, toks.shape[0], prompt + n_decode)
    with recording_routes() as log:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, state = prefill(params, cfg, {"tokens": toks[:, :prompt]}, state,
                            backend=backend)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        steps = [lg]
        for i in range(n_decode):
            lg, state = decode_step(params, cfg,
                                    toks[:, prompt + i:prompt + i + 1],
                                    state, backend=backend)
            steps.append(lg)
        torch.cuda.synchronize()
    return (torch.cat(steps, 1), list(log), (t1 - t0) * 1e3,
            (time.perf_counter() - t1) * 1e3 / n_decode)


def _lm_compare(dtype, batch: int, prompt: int, n_decode: int):
    """qwen3-1.7b at full width in ``dtype``: the kernel path against the
    plain path (prefill logits and teacher-forced decode logits), and
    prefill(p+1) against prefill(p) + decode(token p), on both paths."""
    import dataclasses
    import torch
    from repro_torch.configs import DEFAULT_ODE, get_config
    from repro_torch.models import init_lm, init_serve_state, prefill
    name = str(dtype).split(".")[-1]
    cfg = dataclasses.replace(get_config(LM_ARCH, DEFAULT_ODE),
                              param_dtype=name, compute_dtype=name)
    params = init_lm(torch.Generator(device="cuda").manual_seed(1), cfg)
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (batch, prompt + n_decode)),
                           device="cuda")
    out, logits = {}, {}
    for backend in ("cuda", "reference"):
        logits[backend], _, pre_ms, dec_ms = _serve_run(
            params, cfg, toks, prompt, n_decode, backend)
        out[f"prefill_ms_{backend}"] = pre_ms
        out[f"decode_ms_per_step_{backend}"] = dec_ms
        # prefill over prompt + 1 tokens: its last logits are decode
        # step 0's (the token at position `prompt` fed after prefill)
        lg1, _ = prefill(params, cfg, {"tokens": toks[:, :prompt + 1]},
                         init_serve_state(cfg, batch, prompt + 1),
                         backend=backend)
        out[f"self_consistency_{backend}"] = _rel(lg1[:, 0],
                                                  logits[backend][:, 1])
    out["kernel_vs_plain_prefill"] = _rel(logits["cuda"][:, 0],
                                          logits["reference"][:, 0])
    out["kernel_vs_plain_decode"] = _rel(logits["cuda"][:, 1:],
                                         logits["reference"][:, 1:])
    out["greedy_agreement"] = float(
        (logits["cuda"].argmax(-1) == logits["reference"].argmax(-1))
        .float().mean())
    tol = LM_TOL[name]
    for key in ("kernel_vs_plain_prefill", "kernel_vs_plain_decode",
                "self_consistency_cuda", "self_consistency_reference"):
        require(out[key] <= tol, f"lm {name} {key}: {out[key]} > {tol}")
    require(all(bool(torch.isfinite(t).all()) for t in logits.values()),
            f"lm {name}: non-finite logits")
    del params
    torch.cuda.empty_cache()
    return {"dtype": name, "batch": batch, "prompt": prompt,
            "decode_steps": n_decode, "tolerance": tol, **out}


def _no_sync(fn):
    """``fn()`` under set_sync_debug_mode("error"): any host sync raises."""
    import torch
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _counted_steps(params, cfg, toks, prompt: int, per_prefill: dict,
                   per_decode: dict, what: str):
    """With no host sync: one prefill, one eager decode step, the decode
    graph's first call (an eager warm-up step and the capture of the next)
    and one replay, each with its launches counted apart: per_prefill,
    per_decode, 2 x per_decode and none (a replay calls no wrapper).
    Returns the graph step and its state, for more replays (``toks``
    holds prompt + 8 positions; 4 are used)."""
    import torch
    from repro_torch.launch.serve import make_decode_step
    from repro_torch.models import decode_step, init_serve_state, prefill
    state = init_serve_state(cfg, toks.shape[0], prompt + 8)
    step = make_decode_step(cfg)
    torch.cuda.synchronize()
    _lm_reset()
    _, state = _no_sync(lambda: prefill(params, cfg,
                                        {"tokens": toks[:, :prompt]}, state))
    _lm_check_counts(f"one {what} prefill", per_prefill)
    for i, (label, fn, times) in enumerate((
            ("eager decode step", lambda t, st: decode_step(
                params, cfg, t, st), 1),
            ("decode graph's warm-up step + capture", lambda t, st: step(
                params, t, st), 2),
            ("decode graph replay", lambda t, st: step(params, t, st), 0))):
        _lm_reset()
        _, state = _no_sync(lambda: fn(toks[:, prompt + i:prompt + i + 1],
                                       state))
        _lm_check_counts(f"one {what} {label}", per_decode, times)
    return step, state


def _graph_vs_eager(params, cfg, prompt, n_decode: int, serve_tokens,
                    busy_ms: float):
    """Greedy decode of ``n_decode`` tokens from one prefill of ``prompt``,
    eagerly (decode_step) and through make_decode_step, with no host sync
    inside a step: the graph's tokens must equal the eager loop's and
    serve()'s (``serve_tokens``, from the same weights and prompt), its
    logits be within LM_TOL of the eager ones, and its ms per step (steps
    2..n, host clock ending in a sync) below the eager ms per step and at
    most half of it or within GRAPH_TO_BUSY of the device's own work per
    step (``busy_ms``, from a profile of replays), which half the eager
    step may lie below. The first step (for the graph: the eager warm-up
    and the capture) is timed apart."""
    import torch
    from repro_torch.launch.serve import make_decode_step
    from repro_torch.models import decode_step, init_serve_state, prefill
    name = str(cfg.compute_dtype)
    batch, prompt_len = next(iter(prompt.values())).shape[:2]
    runs = {}
    for mode in ("eager", "graph"):
        state = init_serve_state(cfg, batch, prompt_len + n_decode)
        logits, state = prefill(params, cfg, prompt, state)
        step = (make_decode_step(cfg) if mode == "graph" else
                lambda p, t, st: decode_step(p, cfg, t, st))
        box = {"tok": torch.argmax(logits[:, -1], -1)[:, None],
               "state": state, "toks": [], "logits": []}

        def steps(k):
            for _ in range(k):
                lg, box["state"] = step(params, box["tok"], box["state"])
                box["tok"] = torch.argmax(lg[:, -1], -1)[:, None]
                box["toks"].append(box["tok"][:, 0])
                box["logits"].append(lg)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _no_sync(lambda: steps(1))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _no_sync(lambda: steps(n_decode - 1))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        runs[mode] = (torch.stack(box["toks"], 1), torch.cat(box["logits"],
                                                             1),
                      (t1 - t0) * 1e3, (t2 - t1) * 1e3 / (n_decode - 1))
        del box, state, step
    (te, le, fe, me), (tg, lg, fg, mg) = runs["eager"], runs["graph"]
    out = {"decode_steps": n_decode, "eager_first_step_ms": fe,
           "eager_ms_per_step": me, "graph_first_step_ms": fg,
           "graph_ms_per_step": mg, "graph_to_eager": mg / me,
           "device_busy_ms_per_step": busy_ms,
           "graph_to_device_busy": mg / busy_ms,
           "graph_vs_eager_logits": _rel(lg, le),
           "graph_vs_eager_logits_max_abs": float(
               (lg.double() - le.double()).abs().max()),
           "tokens_equal": bool(torch.equal(tg, te)),
           "serve_tokens_equal": bool(torch.equal(
               tg.cpu(), torch.as_tensor(serve_tokens)))}
    require(out["tokens_equal"] and out["serve_tokens_equal"],
            f"decode graph: greedy tokens differ from eager decode or "
            f"serve(): {out}")
    require(out["graph_vs_eager_logits"] <= LM_TOL[name],
            f"decode graph vs eager logits {out['graph_vs_eager_logits']} "
            f"> {LM_TOL[name]}")
    require(mg < me and (mg <= 0.5 * me or mg <= GRAPH_TO_BUSY * busy_ms),
            f"decode graph: {mg} ms per step against the eager {me}: not "
            f"faster, or more than half of it and more than "
            f"{GRAPH_TO_BUSY}x the device's own {busy_ms} ms")
    return out


def phase_lm_serve(card: str, smi: str):
    """The port's serve() for qwen3-1.7b at full width on the card."""
    import torch
    from repro_torch.configs import DEFAULT_ODE, get_config
    from repro_torch.launch.serve import serve, serve_prompt
    from repro_torch.models import decode_step, init_lm, init_serve_state
    from repro_torch.models import prefill
    kw = dict(smoke=False, ode=True, prompt_len=LM_PROMPT,
              batch=LM_BATCH, seed=0)
    serve(LM_ARCH, decode_tokens=2, **kw)          # warm: cuBLAS, kernels
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _lm_reset()
    result = serve(LM_ARCH, decode_tokens=LM_DECODE, **kw)
    # the wrappers launch in prefill, in the decode graph's eager warm-up
    # step and in its capture; the replays call no wrapper
    launches = _lm_check_counts(
        f"lm_serve (one prefill + {LM_DECODE} decode steps: one eager, one "
        "captured, replays)", LM_PER_DECODE, 2, plus=LM_PER_PREFILL)
    peak = torch.cuda.max_memory_allocated()
    require(result.tokens.shape == (LM_BATCH, LM_DECODE)
            and int(result.tokens.min()) >= 0, "lm_serve: tokens")

    # per prefill, eager decode step, capture and replay, counted apart,
    # with no host sync; the graph against eager decode; profiles
    cfg = get_config(LM_ARCH, DEFAULT_ODE)
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT + 8)), device="cuda")
    step, gstate = _counted_steps(params, cfg, toks, LM_PROMPT,
                                  LM_PER_PREFILL, LM_PER_DECODE, "qwen3")
    state = init_serve_state(cfg, LM_BATCH, LM_PROMPT + 8)
    prof_prefill = _device_profile(lambda: prefill(
        params, cfg, {"tokens": toks[:, :LM_PROMPT]}, state))

    def decode4():
        st = state._replace(pos=torch.full((), LM_PROMPT, dtype=torch.int32,
                                           device="cuda"))
        for i in range(LM_PROMPT, LM_PROMPT + 4):
            _, st = decode_step(params, cfg, toks[:, i:i + 1], st)

    def replay4():
        st = gstate
        for i in range(LM_PROMPT + 3, LM_PROMPT + 7):
            _, st = step(params, toks[:, i:i + 1], st)

    prof_decode = _device_profile(decode4)
    host_decode = _host_profile(decode4)
    prof_replay = _device_profile(replay4)
    graph = _graph_vs_eager(params, cfg, serve_prompt(
        cfg, LM_BATCH, LM_PROMPT, 0, "cuda"), LM_DECODE, result.tokens,
        prof_replay["device_busy_ms"] / 4)
    del params, state, step, gstate
    torch.cuda.empty_cache()

    compare = [_lm_compare(torch.bfloat16, LM_BATCH, LM_PROMPT, 8),
               _lm_compare(torch.float32, 2, 256, 4)]
    emit({"phase": "lm_serve", "arch": LM_ARCH, "card": card,
          "nvidia_smi": smi, "batch": LM_BATCH, "prompt": LM_PROMPT,
          "decode_tokens": LM_DECODE, "dtype": "bfloat16",
          "ode": "DEFAULT_ODE (per_block, MALI/ALF, n_steps=2)",
          "prefill_ms": result.prefill_ms, "decode_ms": result.decode_ms,
          "decode_ms_per_step": result.decode_ms / LM_DECODE,
          "prefill_tok_s": result.prefill_tok_s,
          "decode_tok_s": result.decode_tok_s,
          "peak_memory_bytes": peak, "launches": launches,
          "per_prefill": LM_PER_PREFILL, "per_decode_step": LM_PER_DECODE,
          "sample": result.tokens[0][:8].tolist(),
          "graph_vs_eager": graph,
          "profile_prefill": prof_prefill, "profile_decode_4_steps":
          prof_decode, "host_profile_decode_4_steps": host_decode,
          "profile_decode_4_replays": prof_replay,
          "compare": compare})
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the Jamba/SSM serving slice (jamba-v0.1-52b, 2 of 4 periods)
# ---------------------------------------------------------------------------

def _ssm_config(dtype_name: str = "bfloat16", periods: int = SSM_PERIODS):
    """jamba-v0.1-52b at its published widths under DEFAULT_ODE, cut to
    ``periods`` of its 4 periods."""
    import dataclasses
    from repro_torch.configs import DEFAULT_ODE, get_config
    return dataclasses.replace(get_config(SSM_ARCH, DEFAULT_ODE),
                               n_periods=periods, param_dtype=dtype_name,
                               compute_dtype=dtype_name)


def _same_routes(a, b, batch: int):
    """Two runs' MoE routes (moe.Routes, call by call; the tokens of a call
    in batch-major order): the count of (token, choice) routes that differ
    (as sets per token), the count compared, and per batch row whether
    every route of the row agreed."""
    import torch
    require(len(a) == len(b), f"routes: {len(a)} vs {len(b)} MoE calls")
    agree = torch.ones(batch, dtype=torch.bool, device="cuda")
    differ, total = 0, 0
    for ra, rb in zip(a, b):
        require(ra.idx.shape == rb.idx.shape, "routes: shapes differ")
        d = ra.idx.sort(-1).values != rb.idx.sort(-1).values
        differ += int(d.sum())
        total += d.numel()
        agree &= ~d.reshape(batch, -1).any(-1)
    return differ, total, agree.cpu()


def _rows_rel(a, b, rows) -> float:
    """max |a - b| / max |b| over the batch rows ``rows`` (None: none)."""
    if not bool(rows.any()):
        return None
    return _rel(a[rows.to(a.device)], b[rows.to(b.device)])


def _moved(params, dtype):
    """``params`` with the embedding moved by one rounding of ``dtype``
    (relative 2^-8 in bf16, 1e-7 in f32): the plain path run on it
    measures how far the model itself carries a rounding."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(5)
    e = params["embed"]
    eps = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-7
    noise = torch.randn(e.shape, generator=gen, device="cuda")
    return {**params, "embed": (e.float() * (1 + eps * noise)).to(e.dtype)}


def _ssm_layers(params, cfg, toks, prompt: int):
    """Layer by layer from the same input (the plain path's output of the
    layer before): each layer's prefill on the kernel path against the
    plain path, on the tokens whose MoE routes agree in every f-eval of
    the layer. Returns one [period, index, mixer, mlp, rel, share of
    tokens compared, share of routes differing] row per layer."""
    import torch
    import torch.utils._pytree as pytree
    from repro_torch.models import transformer
    from repro_torch.models.moe import recording_routes
    batch = toks.shape[0]
    x = params["embed"][toks[:, :prompt]]
    pos = torch.arange(prompt, dtype=torch.int32,
                       device="cuda")[None].expand(batch, prompt)
    rows = []
    for p in range(cfg.n_periods):
        pp = pytree.tree_map(lambda a: a[p], params["blocks"]["period"])
        for j, spec in enumerate(cfg.period):
            ys, logs = {}, {}
            for backend in ("cuda", "reference"):
                cache = transformer.init_layer_cache(cfg, spec, batch, prompt,
                                                     "cuda")
                with recording_routes() as log:
                    ys[backend], _ = transformer.layer_serve(
                        pp[f"sub{j}"], cfg, spec, x, cache, pos, "prefill",
                        backend)
                logs[backend] = list(log)
            same = torch.ones(batch * prompt, dtype=torch.bool, device="cuda")
            differ, total = 0, 0
            for a, b in zip(logs["cuda"], logs["reference"]):
                d = a.idx.sort(-1).values != b.idx.sort(-1).values
                same &= ~d.any(-1)
                differ, total = differ + int(d.sum()), total + d.numel()
            got = ys["cuda"].reshape(batch * prompt, -1)[same]
            want = ys["reference"].reshape(batch * prompt, -1)[same]
            rows.append([p, j, spec.mixer, spec.mlp,
                         _rel(got, want) if got.numel() else float("inf"),
                         float(same.float().mean()),
                         differ / total if total else 0.0])
            x = ys["reference"]
    return rows


def _ssm_compare(dtype, periods: int, batch: int, prompt: int,
                 n_decode: int):
    """jamba-v0.1-52b at full width, ``periods`` periods, in ``dtype``:

    - the kernel path against the plain path (prefill and teacher-forced
      decode logits) on the batch rows whose MoE routes agree in every
      call, and on all rows against the model's own noise floor (the
      plain path with the embedding moved by one rounding);
    - the kernel path run twice: bit-equal;
    - prefill(p+1) against prefill(p) + decode(token p) on both paths, on
      the rows whose routes agree between the two and whose decode step
      dropped no route;
    - layer by layer from the same input (``_ssm_layers``).

    In f32 no route may differ and every comparison is held to LM_TOL; in
    bf16 a near-tie of the router flips routes and this model carries a
    one-rounding change to O(1) (PERF.md), so all-row comparisons
    are held to max(LM_TOL, FLOOR_FACTOR x the floor) and the share of
    differing routes to FLOOR_FACTOR x the plain path's own share."""
    import torch
    from repro_torch.models import init_lm, init_serve_state, prefill
    from repro_torch.models.moe import recording_routes
    name = str(dtype).split(".")[-1]
    cfg = _ssm_config(name, periods)
    params = init_lm(torch.Generator(device="cuda").manual_seed(1), cfg)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (batch, prompt + n_decode)), device="cuda")
    per_call = sum(spec.mlp == "moe" for spec in cfg.layers()) * (
        cfg.ode.n_steps + 1)                # MoE calls per forward
    out, logits, routes = {}, {}, {}
    for label, backend, p in (("cuda", "cuda", params),
                              ("reference", "reference", params),
                              ("cuda_again", "cuda", params),
                              ("reference_moved", "reference",
                               _moved(params, dtype))):
        logits[label], routes[label], pre_ms, dec_ms = _serve_run(
            p, cfg, toks, prompt, n_decode, backend)
        if label in ("cuda", "reference"):
            out[f"prefill_ms_{backend}"] = pre_ms
            out[f"decode_ms_per_step_{backend}"] = dec_ms
    require(torch.equal(logits["cuda"], logits["cuda_again"])
            and _same_routes(routes["cuda"], routes["cuda_again"],
                             batch)[0] == 0,
            f"ssm {name}: two runs of the kernel path differ")

    # prefill over prompt + 1 tokens: its last logits are decode step 0's
    for backend in ("cuda", "reference"):
        with recording_routes() as longer:
            lg1, _ = prefill(params, cfg, {"tokens": toks[:, :prompt + 1]},
                             init_serve_state(cfg, batch, prompt + 1),
                             backend=backend)
        log = routes[backend]
        ok = torch.ones(batch, dtype=torch.bool, device="cuda")
        dropped = 0
        for p_r, d_r, l_r in zip(log[:per_call], log[per_call:2 * per_call],
                                 longer):
            k = p_r.idx.shape[-1]
            lidx = l_r.idx.reshape(batch, prompt + 1, k).sort(-1).values
            pidx = p_r.idx.reshape(batch, prompt, k).sort(-1).values
            didx = d_r.idx.reshape(batch, k).sort(-1).values
            ok &= (lidx[:, :prompt] == pidx).all(-1).all(-1)
            ok &= (lidx[:, prompt] == didx).all(-1)
            ok &= d_r.kept.reshape(batch, k).all(-1)
            dropped += int((~d_r.kept).sum())
        ok = ok.cpu()
        out[f"self_consistency_{backend}"] = _rows_rel(
            lg1[:, 0], logits[backend][:, 1], ok)
        out[f"self_consistency_rows_{backend}"] = int(ok.sum())
        out[f"self_consistency_all_rows_{backend}"] = _rel(
            lg1[:, 0], logits[backend][:, 1])
        out[f"decode_step0_dropped_routes_{backend}"] = dropped

    differ, total, agree = _same_routes(routes["cuda"], routes["reference"],
                                        batch)
    floor_differ, _, _ = _same_routes(routes["reference_moved"],
                                      routes["reference"], batch)
    ref, moved = logits["reference"], logits["reference_moved"]
    out.update(routes_compared=total, routes_differing=differ,
               route_diff_share=differ / total,
               floor_route_diff_share=floor_differ / total,
               rows_with_agreeing_routes=int(agree.sum()))
    out["kernel_vs_plain_prefill"] = _rows_rel(
        logits["cuda"][:, 0], ref[:, 0], agree)
    out["kernel_vs_plain_decode"] = _rows_rel(
        logits["cuda"][:, 1:], ref[:, 1:], agree)
    out["kernel_vs_plain_prefill_all_rows"] = _rel(logits["cuda"][:, 0],
                                                   ref[:, 0])
    out["kernel_vs_plain_decode_all_rows"] = _rel(logits["cuda"][:, 1:],
                                                  ref[:, 1:])
    out["floor_prefill"] = _rel(moved[:, 0], ref[:, 0])
    out["floor_decode"] = _rel(moved[:, 1:], ref[:, 1:])
    out["greedy_agreement"] = float(
        (logits["cuda"].argmax(-1) == ref.argmax(-1)).float().mean())
    out["layers"] = _ssm_layers(params, cfg, toks, prompt)

    tol = LM_TOL[name]
    require(all(bool(torch.isfinite(t).all()) for t in logits.values()),
            f"ssm {name}: non-finite logits")
    for key in ("kernel_vs_plain_prefill", "kernel_vs_plain_decode",
                "self_consistency_cuda", "self_consistency_reference"):
        require(out[key] is None or out[key] <= tol,
                f"ssm {name} {key}: {out[key]} > {tol}")
    for _, _, _, _, err, share, _ in out["layers"]:
        require(err <= tol and share >= LAYER_TOKEN_SHARE,
                f"ssm {name} layer by layer: {out['layers']}")
    if name == "float32":
        # no route may flip and every comparison has rows to compare
        require(differ == 0 and out["self_consistency_rows_cuda"] == batch
                and out["self_consistency_rows_reference"] == batch,
                f"ssm {name}: routes differ or a decode route was dropped")
    else:
        for key, floor in (
                ("kernel_vs_plain_prefill_all_rows", out["floor_prefill"]),
                ("kernel_vs_plain_decode_all_rows", out["floor_decode"]),
                ("self_consistency_all_rows_cuda", out["floor_decode"]),
                ("self_consistency_all_rows_reference",
                 out["floor_decode"])):
            limit = max(tol, FLOOR_FACTOR * floor)
            require(out[key] <= limit, f"ssm {name} {key}: {out[key]} > "
                    f"{limit} (floor {floor})")
        limit = FLOOR_FACTOR * out["floor_route_diff_share"]
        require(out["route_diff_share"] <= limit,
                f"ssm {name}: route share {out['route_diff_share']} > "
                f"{limit}")
    del params
    torch.cuda.empty_cache()
    return {"dtype": name, "periods": periods, "batch": batch,
            "prompt": prompt, "decode_steps": n_decode, "tolerance": tol,
            "floor_factor": FLOOR_FACTOR, **out}


def phase_ssm_serve(card: str, smi: str):
    """The port's serve() for jamba-v0.1-52b at full width (2 of 4
    periods) on the card."""
    import torch
    import torch.utils._pytree as pytree
    from repro_torch.launch.serve import serve, serve_prompt
    from repro_torch.models import decode_step, init_lm, init_serve_state
    from repro_torch.models import prefill
    cfg = _ssm_config()
    kw = dict(ode=True, prompt_len=SSM_PROMPT, batch=SSM_BATCH, seed=0)
    t0 = time.perf_counter()
    serve(cfg, decode_tokens=2, **kw)          # warm: cuBLAS, kernels
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _lm_reset()
    result = serve(cfg, decode_tokens=SSM_DECODE, **kw)
    # the wrappers launch in prefill, in the decode graph's eager warm-up
    # step and in its capture; the replays call no wrapper
    launches = _lm_check_counts(
        f"ssm_serve (one prefill + {SSM_DECODE} decode steps: one eager, "
        "one captured, replays)", SSM_PER_DECODE, 2, plus=SSM_PER_PREFILL)
    run_peak = torch.cuda.max_memory_allocated()
    require(result.tokens.shape == (SSM_BATCH, SSM_DECODE)
            and int(result.tokens.min()) >= 0, "ssm_serve: tokens")
    torch.cuda.empty_cache()

    # init's peak beside the weights it made
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base
    weights = sum(t.numel() * t.element_size()
                  for t in pytree.tree_leaves(params))
    require(init_peak <= INIT_PEAK_RATIO * weights,
            f"ssm_serve: init peaked at {init_peak} bytes for {weights} "
            f"bytes of weights (> {INIT_PEAK_RATIO}x)")

    # per prefill, eager decode step, capture and replay, counted apart,
    # with no host sync; the graph against eager decode (serve()'s weights
    # are these: init_lm from seed 0); profiles. The comparisons that read
    # recording_routes() (_ssm_compare) decode eagerly.
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SSM_BATCH, SSM_PROMPT + 8)), device="cuda")
    step, gstate = _counted_steps(params, cfg, toks, SSM_PROMPT,
                                  SSM_PER_PREFILL, SSM_PER_DECODE, "Jamba")
    state = init_serve_state(cfg, SSM_BATCH, SSM_PROMPT + 8)
    prof_prefill = _device_profile(lambda: prefill(
        params, cfg, {"tokens": toks[:, :SSM_PROMPT]}, state))

    def decode4():
        st = state._replace(pos=torch.full((), SSM_PROMPT, dtype=torch.int32,
                                           device="cuda"))
        for i in range(SSM_PROMPT, SSM_PROMPT + 4):
            _, st = decode_step(params, cfg, toks[:, i:i + 1], st)

    def replay4():
        st = gstate
        for i in range(SSM_PROMPT + 3, SSM_PROMPT + 7):
            _, st = step(params, toks[:, i:i + 1], st)

    prof_decode = _device_profile(decode4)
    host_decode = _host_profile(decode4)
    prof_replay = _device_profile(replay4)
    graph = _graph_vs_eager(params, cfg, serve_prompt(
        cfg, SSM_BATCH, SSM_PROMPT, 0, "cuda"), SSM_DECODE, result.tokens,
        prof_replay["device_busy_ms"] / 4)
    del params, state, step, gstate
    torch.cuda.empty_cache()

    # bf16 at the served depth; f32 (twice the bytes) at one period
    compare = [_ssm_compare(torch.bfloat16, SSM_PERIODS, SSM_BATCH,
                            SSM_PROMPT, 4),
               _ssm_compare(torch.float32, 1, 2, 256, 4)]
    emit({"phase": "ssm_serve", "arch": SSM_ARCH, "card": card,
          "nvidia_smi": smi, "periods": SSM_PERIODS,
          "reduced": f"depth: {SSM_PERIODS} of 4 periods "
                     f"({8 * SSM_PERIODS} of 32 layers); widths as "
                     "published",
          "batch": SSM_BATCH, "prompt": SSM_PROMPT,
          "decode_tokens": SSM_DECODE, "dtype": "bfloat16",
          "ode": "DEFAULT_ODE (per_block, MALI/ALF, n_steps=2)",
          "warm_serve_s": warm_s,
          "prefill_ms": result.prefill_ms, "decode_ms": result.decode_ms,
          "decode_ms_per_step": result.decode_ms / SSM_DECODE,
          "prefill_tok_s": result.prefill_tok_s,
          "decode_tok_s": result.decode_tok_s,
          "weights_bytes": weights, "init_s": init_s,
          "init_peak_bytes": init_peak,
          "init_peak_ratio": init_peak / weights,
          "peak_memory_bytes": run_peak, "launches": launches,
          "per_prefill": SSM_PER_PREFILL, "per_decode_step": SSM_PER_DECODE,
          "sample": result.tokens[0][:8].tolist(),
          "graph_vs_eager": graph,
          "profile_prefill": prof_prefill, "profile_decode_4_steps":
          prof_decode, "host_profile_decode_4_steps": host_decode,
          "profile_decode_4_replays": prof_replay,
          "compare": compare})
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the rest of the solver surface (Runge-Kutta tableaus, ACA,
# Backsolve, diff_bounds, the odeint front door) on the card
# ---------------------------------------------------------------------------

# The methods of (b): (label, odeint kwargs, ALF launches per training
# step). ConstantSteps(4) unless noted. Backsolve on ALF(cuda) launches
# 4 + 4 in the forward solve and 4 + 4 in the reverse augmented solve,
# both grad-free; the Runge-Kutta runs launch no kernel.
METHOD_RUNS = (
    ("mali_alf_cuda", dict(method="mali", n_steps=N_SUB),
     {"alf_midpoint": N_SUB, "alf_update": N_SUB, "alf_bwd_pre": N_SUB,
      "alf_bwd_post": N_SUB}),
    ("aca_heun_euler", dict(method="aca", solver="heun_euler",
                            n_steps=N_SUB), {}),
    ("adjoint_alf_cuda", dict(method="adjoint", n_steps=N_SUB),
     {"alf_midpoint": 2 * N_SUB, "alf_update": 2 * N_SUB}),
    ("adjoint_dopri5_adaptive", dict(method="adjoint", solver="dopri5",
                                     n_steps=0, rtol=1e-4, atol=1e-5,
                                     max_steps=128), {}),
    ("naive_heun_euler", dict(method="naive", solver="heun_euler",
                              n_steps=N_SUB), {}),
)
THM21_A, THM21_ETA, THM21_STEPS = 8.0, 0.9, 128
SAME_DISCRETIZATION_RTOL = 1e-5
# dL/dt0 across discretizations at 32 steps (tests/test_diff_bounds.py)
CROSS_METHOD_RTOL = 5e-3
DB_STEPS = 32


def _rel_err(got, want, zero_atol: float = 0.0) -> float:
    """max |got - want| / max |want| over matching leaves (worst leaf). A
    leaf whose reference is all zero has no scale: it counts 0 when
    max |got - want| <= zero_atol and inf (a failure at any relative
    limit) otherwise."""
    import torch.utils._pytree as pytree
    worst = 0.0
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        diff, scale = float((g - w).abs().max()), float(w.abs().max())
        if scale > 0:
            worst = max(worst, diff / scale)
        elif diff > zero_atol:
            worst = float("inf")
    return worst


def _odeint_kwargs(kw: dict) -> dict:
    """odeint kwargs with the ALF solver on the kernels (ALF is the
    default of MALI and the solver given to Backsolve here)."""
    from repro_torch.core import ALF
    if kw.get("solver") is None and kw["method"] in ("mali", "adjoint"):
        return {**kw, "solver": ALF(eta=1.0, backend="cuda")}
    return kw


def _odeint_loss(kw: dict, x, y):
    import torch
    from repro_torch.core import odeint

    def loss_fn(params):
        z = odeint(field, params["f"], x, 0.0, 1.0, **_odeint_kwargs(kw))
        logits = (z * params["norm"]) @ params["head"] + params["bh"]
        return torch.nn.functional.cross_entropy(logits, y)

    return loss_fn


def _thm21():
    """(a) Thm 2.1 on the card: stiff decay a=8, ALF(eta=0.9), 128 steps;
    Naive on the reference backend is the oracle."""
    import torch
    from repro_torch.core import (ALF, MALI, Backsolve, ConstantSteps,
                                  Naive, solve)

    def grad(gradient, backend):
        a = torch.full((), THM21_A, device="cuda", requires_grad=True)
        sol = solve(lambda p, z, t: -p["a"] * z, {"a": a},
                    torch.ones(3, device="cuda"), 0.0, 1.0,
                    solver=ALF(eta=THM21_ETA, backend=backend),
                    controller=ConstantSteps(THM21_STEPS), gradient=gradient)
        (g,) = torch.autograd.grad(torch.sum(sol.ys), [a])
        return float(g)

    g_naive = grad(Naive(), "reference")
    g_mali = grad(MALI(), "cuda")
    g_back = grad(Backsolve(), "cuda")
    g_back_ref = grad(Backsolve(), "reference")
    rel_mali = abs(g_mali - g_naive) / abs(g_naive)
    rel_back = abs(g_back - g_naive) / abs(g_naive)
    back_vs_ref = abs(g_back - g_back_ref) / abs(g_back_ref)
    require(rel_mali < 1e-4, f"Thm 2.1: MALI rel {rel_mali} >= 1e-4")
    require(rel_back > 1e-3, f"Thm 2.1: Backsolve rel {rel_back} <= 1e-3")
    require(rel_back > 100 * rel_mali,
            f"Thm 2.1: Backsolve {rel_back} not > 100x MALI {rel_mali}")
    require(back_vs_ref <= 1e-5, f"Thm 2.1: Backsolve cuda vs reference "
            f"{back_vs_ref} > 1e-5")
    return {"grad_naive_reference": g_naive, "grad_mali_cuda": g_mali,
            "grad_backsolve_cuda": g_back,
            "grad_backsolve_reference": g_back_ref,
            "rel_mali": rel_mali, "rel_backsolve": rel_back,
            "backsolve_cuda_vs_reference": back_vs_ref}


def _method_runs(x, y):
    """(b) 20 Adam steps of the Sec 4.2 model through odeint(method=...)
    for each of METHOD_RUNS: the loss falls, exact launch counts, no host
    sync in a fixed-step step; ACA's first-step gradient equals Naive's on
    the same tableau, and Backsolve's on the kernels equals its own on the
    plain versions; ms per step, each method timed in turns."""
    import torch
    import torch.utils._pytree as pytree
    from repro_torch import params_from_numpy
    out, launches = {}, {}
    params = params_from_numpy(init_params_numpy(0))
    for p in pytree.tree_leaves(params):
        p.requires_grad_(True)
    leaves = pytree.tree_leaves(params)
    first = {}
    for label, kw, per in METHOD_RUNS:
        loss_fn = _odeint_loss(kw, x, y)
        first[label] = torch.autograd.grad(loss_fn(params), leaves)
        if kw.get("n_steps", 0) > 0:
            # one fixed-step forward + backward with every host sync an
            # error
            _no_sync(lambda: loss_fn(params).backward())
        counts, (losses, _) = _counted(
            f"odeint({label})",
            lambda: _train(x, y, None, None, loss_fn=loss_fn), TRAIN_STEPS,
            per)
        require(all(np.isfinite(losses)), f"{label}: non-finite losses")
        require(losses[-1] < losses[0],
                f"{label}: loss did not fall: {losses[0]} -> {losses[-1]}")
        launches[label] = counts
        out[label] = {"first_loss": losses[0], "last_loss": losses[-1]}
    aca_vs_naive = _rel_err(first["aca_heun_euler"],
                            first["naive_heun_euler"])
    require(aca_vs_naive <= SAME_DISCRETIZATION_RTOL,
            f"ACA vs Naive (heun_euler) first-step gradients: rel "
            f"{aca_vs_naive}")
    # Backsolve's reverse solve runs the forward pair over the packed
    # (z, a, g_params) state: hold the kernels' gradient against the same
    # run on the plain versions (ALF backend "reference")
    from repro_torch.core import ALF
    kw = next(k for lab, k, _ in METHOD_RUNS if lab == "adjoint_alf_cuda")
    ref_loss = _odeint_loss({**kw, "solver": ALF(eta=1.0,
                                                 backend="reference")}, x, y)
    backsolve_vs_ref = _rel_err(first["adjoint_alf_cuda"],
                                torch.autograd.grad(ref_loss(params), leaves))
    require(backsolve_vs_ref <= SAME_DISCRETIZATION_RTOL,
            f"Backsolve first-step gradients, ALF cuda vs reference: rel "
            f"{backsolve_vs_ref}")
    step_ms = {label: [] for label, _, _ in METHOD_RUNS}
    for i in range(2):
        for label, kw, _ in METHOD_RUNS[::1 if i % 2 == 0 else -1]:
            _, wall = _train(x, y, None, None,
                             loss_fn=_odeint_loss(kw, x, y))
            step_ms[label].append(wall / TRAIN_STEPS * 1e3)
    for label, kw, _ in METHOD_RUNS:
        out[label]["step_ms"] = step_ms[label]
        out[label]["median_step_ms"] = float(np.median(step_ms[label]))
        prof = _device_profile(lambda: _train(
            x, y, None, None, loss_fn=_odeint_loss(kw, x, y)))
        out[label]["profile"] = {k: prof[k] for k in (
            "device_busy_ms", "device_window_ms", "idle_share",
            "device_launches", "host_ms")}
    # The adaptive run's forward accounting at the seeded parameters (its
    # reverse augmented solve runs its own accept/reject loop).
    from repro_torch.core import AdaptiveController, Backsolve, Dopri5, solve
    sol = solve(field, params["f"], x, 0.0, 1.0, solver=Dopri5(),
                controller=AdaptiveController(1e-4, 1e-5, 128),
                gradient=Backsolve())
    out["adjoint_dopri5_adaptive"]["forward_stats"] = {
        k: int(getattr(sol.stats, k))
        for k in ("n_accepted", "n_rejected", "n_fevals")}
    return out, launches, {
        "aca_vs_naive_heun_euler_first_grad_rel": aca_vs_naive,
        "backsolve_cuda_vs_reference_first_grad_rel": backsolve_vs_ref}


def _method_memory():
    """(c) Peak device memory of a forward + backward on phase 7's
    2^20-element state at ConstantSteps(8) and (64)."""
    import torch
    import torch.utils._pytree as pytree
    from repro_torch import params_from_numpy
    from repro_torch.core import (ACA, ALF, MALI, Backsolve, ConstantSteps,
                                  HeunEuler, Naive, solve)
    x_np, _ = make_data((1 << 20) // D, seed=2)
    fp = params_from_numpy(init_params_numpy(0)["f"])
    cuda_alf = ALF(eta=1.0, backend="cuda")
    peaks = {}
    for label, solver, gradient in (
            ("mali_cuda", cuda_alf, MALI()),
            ("aca_heun_euler", HeunEuler(), ACA()),
            ("naive_heun_euler", HeunEuler(), Naive()),
            ("backsolve_cuda", cuda_alf, Backsolve())):
        for n in (8, 64):
            p = {k: v.detach().clone().requires_grad_(True)
                 for k, v in fp.items()}
            z0 = torch.as_tensor(x_np, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            sol = solve(field, p, z0, 0.0, 1.0, solver=solver,
                        controller=ConstantSteps(n), gradient=gradient)
            loss = (sol.ys ** 2).mean()
            torch.autograd.grad(loss, pytree.tree_leaves(p))
            torch.cuda.synchronize()
            peaks[(label, n)] = torch.cuda.max_memory_allocated() - base
            del sol, loss
    growth = {k: peaks[(k, 64)] / peaks[(k, 8)]
              for k in ("mali_cuda", "aca_heun_euler", "naive_heun_euler",
                        "backsolve_cuda")}
    require(growth["backsolve_cuda"] <= 1.05, f"Backsolve peak memory grew "
            f"{growth['backsolve_cuda']}x from 8 to 64 steps")
    require(growth["mali_cuda"] <= 1.05, f"MALI peak memory grew "
            f"{growth['mali_cuda']}x from 8 to 64 steps")
    require(growth["aca_heun_euler"] > 2.0, f"ACA peak memory grew only "
            f"{growth['aca_heun_euler']}x from 8 to 64 steps")
    require(peaks[("aca_heun_euler", 64)] < peaks[("naive_heun_euler", 64)],
            "ACA's peak at 64 steps is not below Naive's (heun_euler)")
    require(peaks[("mali_cuda", 64)] < peaks[("aca_heun_euler", 64)],
            "MALI's peak at 64 steps is not below ACA's")
    return ({f"{k}_n{n}": v for (k, n), v in peaks.items()},
            {f"{k}_growth_8_to_64": v for k, v in growth.items()})


def _method_bounds(x_np):
    """(d) diff_bounds on the card: each method's dL/dt1 and dL/dt0 on the
    Sec 4.2 field against bounds_cotangents' analytic values; methods on
    one discretization agree within 1e-5, across discretizations within
    the JAX package's 5e-3."""
    import torch
    from repro_torch import params_from_numpy
    from repro_torch.core import (ACA, ALF, MALI, Backsolve, ConstantSteps,
                                  HeunEuler, Naive, solve)
    from repro_torch.core.interface import tree_vdot
    fp = params_from_numpy(init_params_numpy(0)["f"])
    z0_np = torch.as_tensor(x_np, device="cuda")
    ctrl = ConstantSteps(DB_STEPS)
    cuda_alf = ALF(eta=1.0, backend="cuda")
    runs = {"mali_cuda": (MALI(), cuda_alf),
            "naive_cuda": (Naive(), cuda_alf),
            "aca_heun_euler": (ACA(), HeunEuler()),
            "naive_heun_euler": (Naive(), HeunEuler()),
            "backsolve_cuda": (Backsolve(), cuda_alf)}
    out = {}
    for label, (gradient, solver) in runs.items():
        t0 = torch.zeros((), device="cuda", requires_grad=True)
        t1 = torch.ones((), device="cuda", requires_grad=True)
        z0 = z0_np.clone().requires_grad_(True)
        sol = solve(field, fp, z0, t0, t1, solver=solver, controller=ctrl,
                    gradient=gradient, diff_bounds=True)
        g_t0, g_t1, g_z0 = torch.autograd.grad((sol.ys ** 2).mean(),
                                               [t0, t1, z0])
        z_end = sol.ys.detach()
        want_t1 = tree_vdot(2.0 * z_end / z_end.numel(),
                            field(fp, z_end, t1.detach()))
        want_t0 = -tree_vdot(g_z0, field(fp, z0_np, t0.detach()))
        r1 = abs(float(g_t1) - float(want_t1)) / abs(float(want_t1))
        r0 = abs(float(g_t0) - float(want_t0)) / abs(float(want_t0))
        require(r1 <= SAME_DISCRETIZATION_RTOL and
                r0 <= SAME_DISCRETIZATION_RTOL,
                f"diff_bounds {label}: against the analytic values rel "
                f"{r0} (t0), {r1} (t1)")
        out[label] = {"dL_dt0": float(g_t0), "dL_dt1": float(g_t1),
                      "rel_vs_analytic_t0": r0, "rel_vs_analytic_t1": r1}

    def rel(a, b, key):
        return abs(out[a][key] - out[b][key]) / abs(out[b][key])

    agree = {}
    for a, b, keys in (
            ("mali_cuda", "naive_cuda", ("dL_dt0", "dL_dt1")),
            ("aca_heun_euler", "naive_heun_euler", ("dL_dt0", "dL_dt1")),
            ("backsolve_cuda", "naive_cuda", ("dL_dt1",))):
        for key in keys:
            agree[f"{a}_vs_{b}_{key}"] = r = rel(a, b, key)
            require(r <= SAME_DISCRETIZATION_RTOL,
                    f"diff_bounds: {a} vs {b} {key} rel {r}")
    for label in out:
        for key in ("dL_dt0", "dL_dt1"):
            agree[f"{label}_vs_naive_cuda_{key}"] = r = rel(
                label, "naive_cuda", key)
            require(r <= CROSS_METHOD_RTOL,
                    f"diff_bounds: {label} vs naive_cuda {key} rel {r}")
    return out, agree


def phase_methods(card: str, smi: str):
    """Phase 13: Thm 2.1, the four methods through odeint on the Sec 4.2
    model, their peak memory from 8 to 64 steps, and diff_bounds."""
    import warnings

    import torch
    torch.cuda.empty_cache()
    x_np, y_np = make_data(N_TRAIN, seed=0)
    x = torch.as_tensor(x_np, device="cuda")
    y = torch.as_tensor(y_np, device="cuda")
    thm21 = _thm21()
    with warnings.catch_warnings():
        # odeint() is the legacy facade and says so on every call
        warnings.simplefilter("ignore", DeprecationWarning)
        runs, launches, first_grads = _method_runs(x, y)
    peaks, growth = _method_memory()
    bounds, agree = _method_bounds(x_np)
    emit({"phase": "methods", "card": card, "nvidia_smi": smi,
          "thm21": thm21, "model": "paper Sec 4.2 (D=64, HIDDEN=64, 3 "
          "classes, 2048 images)", "steps": TRAIN_STEPS, "runs": runs,
          "launches": launches,
          **first_grads,
          "memory_state_elements": 1 << 20, "peak_bytes": peaks, **growth,
          "diff_bounds_steps": DB_STEPS, "diff_bounds": bounds,
          "diff_bounds_agreement": agree})
    return launches["adjoint_alf_cuda"]


# ---------------------------------------------------------------------------
# Phase 14: the image CNF (paper Sec 4.4; examples/cnf_image.py) and events
# ---------------------------------------------------------------------------

CNF_HIDDEN, CNF_DEPTH = 64, 2   # examples/cnf_image.py; CNF_DIM above
CNF_STEPS, CNF_N_SUB, CNF_LR, CNF_KINETIC = 20, 8, 1e-3, 0.05
CNF_MEMORY_STEPS = (8, 64)
# kernel backend against the reference backend, same probe: max |a - b| /
# max |b| per leaf; a leaf that is all zero on the reference backend must
# be all zero on the kernel backend too (_rel_err's zero_atol)
CNF_REL, CNF_ZERO_ATOL = 1e-5, 0.0
# launches per MALI training step (8 forward steps: one midpoint and one
# update each; 8 fused backward steps: one bwd_pre and one bwd_post
# each), per Naive gradient (the two reverse rules per forward op) and
# per sample() call (the forward pair only)
CNF_PER_STEP = {"alf_midpoint": CNF_N_SUB, "alf_update": CNF_N_SUB,
                "alf_bwd_pre": CNF_N_SUB, "alf_bwd_post": CNF_N_SUB}
CNF_PER_NAIVE = {"alf_midpoint": CNF_N_SUB, "alf_update": CNF_N_SUB,
                 "alf_midpoint_vjp": CNF_N_SUB, "alf_update_vjp": CNF_N_SUB}
CNF_PER_SAMPLE = {"alf_midpoint": CNF_N_SUB, "alf_update": CNF_N_SUB}
# Events: dz/dt = -a z, z0 = 1, the first coordinate falling through 0.5
# at t* = ln 2 / a; dt*/da = -t*/a. Bars of tests/test_reverse_time.py.
EV_A, EV_T1 = 8.0, 1.0
EV_TIME_ATOL, EV_GRAD_RTOL = 1e-3, 2e-2
EV_KERNEL_REL = 1e-6


def _cnf_data(batch: int):
    """CNF_STEPS dequantized image batches on the card: the port's
    make_image_batch plus uniform noise inside each 1/256 bin."""
    import torch
    from repro_torch.data import DataConfig, make_image_batch
    dcfg = DataConfig(seed=0, global_batch=batch)
    rng = np.random.default_rng(0)
    out = []
    for step in range(CNF_STEPS):
        img = make_image_batch(dcfg, step)["image"]
        x = (img + rng.uniform(0, 1.0 / 256.0, img.shape)).astype(np.float32)
        out.append(torch.as_tensor(x, device="cuda"))
    return out


def _cnf_params():
    import torch
    import torch.utils._pytree as pytree
    from repro_torch.models import init_mlp_vfield
    params = init_mlp_vfield(torch.Generator(device="cuda").manual_seed(0),
                             CNF_DIM, hidden=CNF_HIDDEN, depth=CNF_DEPTH,
                             device="cuda")
    for leaf in pytree.tree_leaves(params):
        leaf.requires_grad_(True)
    return params


def _cnf_probe(step: int):
    import torch
    return torch.Generator(device="cuda").manual_seed(1000 + step)


def _cnf_loss(params, x, gen, backend="cuda", gradient=None,
              n_sub=CNF_N_SUB):
    """cnf_loss(log_prob) of the image CNF: Hutchinson (Rademacher), ALF,
    ConstantSteps(n_sub), MALI unless another gradient is given,
    Lockstep batching."""
    from repro_torch.cnf import CNF, Hutchinson, cnf_loss
    from repro_torch.core import ALF, MALI, ConstantSteps, Lockstep
    from repro_torch.models import mlp_vfield
    flow = CNF(mlp_vfield, CNF_DIM, estimator=Hutchinson())
    res = flow.log_prob(params, x, gen,
                        solver=ALF(eta=1.0, backend=backend),
                        controller=ConstantSteps(n_sub),
                        gradient=MALI() if gradient is None else gradient,
                        batching=Lockstep())
    return cnf_loss(res, kinetic_reg=CNF_KINETIC), res


def _cnf_grads(params, x, step, **kw):
    import torch
    import torch.utils._pytree as pytree
    loss, _ = _cnf_loss(params, x, _cnf_probe(step), **kw)
    grads = torch.autograd.grad(loss, pytree.tree_leaves(params))
    return loss.detach(), grads


def _cnf_train(xs, backend="cuda"):
    """CNF_STEPS Adam steps from the seeded parameters; returns the losses,
    bits/dim, wall seconds and the trained parameters."""
    import torch
    import torch.utils._pytree as pytree
    from repro_torch.cnf import bits_per_dim
    params = _cnf_params()
    opt = torch.optim.Adam(pytree.tree_leaves(params), lr=CNF_LR)
    losses, bpds = [], []
    gens = [_cnf_probe(i) for i in range(CNF_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(CNF_STEPS):
        opt.zero_grad(set_to_none=True)
        loss, res = _cnf_loss(params, xs[i], gens[i], backend)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        bpds.append(bits_per_dim(res, CNF_DIM).detach())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([float(v) for v in losses], [float(v) for v in bpds], wall,
            params)


def _cnf_memory(x):
    """Peak device memory above the pre-forward baseline of
    grad(cnf_loss) at CNF_MEMORY_STEPS, MALI and Naive (ALF cuda), after
    one unmeasured gradient (the first call's one-time allocations, such
    as cuBLAS's workspace, would otherwise count in the first peak). Each
    configuration is measured twice in a row and the growth is taken
    from the second readings, so that a one-time allocation in the first
    measured configuration cannot inflate the baseline; both readings
    are returned."""
    import torch
    import torch.utils._pytree as pytree
    from repro_torch.core import MALI, Naive
    params = _cnf_params()
    torch.autograd.grad(_cnf_loss(params, x, _cnf_probe(0))[0],
                        pytree.tree_leaves(params))
    readings = {}
    for label, gradient in (("mali_cuda", MALI()), ("naive_cuda", Naive())):
        for n in CNF_MEMORY_STEPS:
            for _ in range(2):
                params = _cnf_params()
                gen = _cnf_probe(0)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                loss, _ = _cnf_loss(params, x, gen, gradient=gradient,
                                    n_sub=n)
                torch.autograd.grad(loss, pytree.tree_leaves(params))
                torch.cuda.synchronize()
                readings.setdefault((label, n), []).append(
                    torch.cuda.max_memory_allocated() - base)
                del loss
    peaks = {k: v[-1] for k, v in readings.items()}
    lo, hi = CNF_MEMORY_STEPS
    growth = {k: peaks[(k, hi)] / peaks[(k, lo)]
              for k in ("mali_cuda", "naive_cuda")}
    require(growth["mali_cuda"] <= 1.05, f"CNF: MALI peak memory grew "
            f"{growth['mali_cuda']}x from {lo} to {hi} steps")
    require(growth["naive_cuda"] > 2.0, f"CNF: Naive peak memory grew only "
            f"{growth['naive_cuda']}x")
    return ({f"{k}_n{n}": v for (k, n), v in readings.items()},
            {f"{k}_growth_{lo}_to_{hi}": v for k, v in growth.items()})


def _cnf_sample(params):
    """sample() at batch 16 in reverse time, counted; the flow path over a
    descending grid; the log_prob of the samples finite."""
    import torch
    from repro_torch.cnf import CNF, Hutchinson
    from repro_torch.core import ALF, MALI, ConstantSteps, SaveAt
    from repro_torch.models import mlp_vfield
    flow = CNF(mlp_vfield, CNF_DIM, estimator=Hutchinson())
    kw = dict(solver=ALF(eta=1.0, backend="cuda"),
              controller=ConstantSteps(CNF_N_SUB), gradient=MALI())
    n = CNF_BATCHES[0]
    with torch.no_grad():
        launches, sol = _counted(
            "CNF sample()", lambda: flow.sample(params, _cnf_probe(7), n,
                                                **kw), 1, CNF_PER_SAMPLE)
        path = flow.sample(params, _cnf_probe(7), n,
                           saveat=SaveAt(ts=torch.linspace(1.0, 0.0, 3)),
                           **kw)
        back = flow.log_prob(params, sol.ys[0], _cnf_probe(8), **kw)
    xs = sol.ys[0]
    base = torch.randn((n, CNF_DIM), generator=_cnf_probe(7), device="cuda")
    require(tuple(xs.shape) == (n, CNF_DIM)
            and bool(torch.isfinite(xs).all()), "CNF sample(): samples")
    require(tuple(path.ys[0].shape) == (3, n, CNF_DIM)
            and torch.equal(path.ys[0][0], base)
            and bool(torch.isfinite(path.ys[0]).all()),
            "CNF sample(): flow path")
    require(bool(torch.isfinite(back.logp).all()),
            "CNF sample(): log_prob of the samples not finite")
    return launches, {"shape": list(xs.shape),
                      "path_shape": list(path.ys[0].shape),
                      "round_trip_mean_logp": float(back.logp.mean())}


def _cnf_times(xs_by_batch):
    """ms per training step on each ALF backend, 2 runs of CNF_STEPS each
    in turns (the first backend alternating), and the device's busy share
    over CNF_STEPS profiled kernel-backend steps."""
    out = {}
    for batch, xs in xs_by_batch.items():
        step_ms = {"cuda": [], "reference": []}
        order = ("reference", "cuda")
        for i in range(2):
            for backend in order[::1 if i % 2 == 0 else -1]:
                _, _, wall, _ = _cnf_train(xs, backend)
                step_ms[backend].append(wall / CNF_STEPS * 1e3)
        prof = _device_profile(lambda: _cnf_train(xs, "cuda"))
        out[batch] = {
            "step_ms_cuda": step_ms["cuda"],
            "step_ms_reference": step_ms["reference"],
            "median_step_ms_cuda": float(np.median(step_ms["cuda"])),
            "median_step_ms_reference": float(
                np.median(step_ms["reference"])),
            "profile_cuda": {k: prof[k] for k in (
                "device_busy_ms", "device_window_ms", "idle_share",
                "device_launches", "host_ms", "top_device_ms")}}
    return out


def _decay(p, z, t):
    return -p["a"] * z


def _event_cond(z, t):
    return z[0] - 0.5


def _event_solve(gradient, solver, controller):
    """The event solve of -a z from fresh leaves; returns event_time,
    d event_time / da, the end state and the solution."""
    import torch
    from repro_torch.core import Event, solve
    a = torch.full((), EV_A, device="cuda", requires_grad=True)
    sol = solve(_decay, {"a": a}, torch.ones(3, device="cuda"), 0.0, EV_T1,
                solver=solver, controller=controller, gradient=gradient,
                event=Event(_event_cond, direction=-1))
    (g,) = torch.autograd.grad(sol.stats.event_time, [a])
    return sol.stats.event_time.detach(), g, sol.ys.detach(), sol


def _events():
    """Events on the card: event_time and its IFT gradient for the four
    methods under ConstantSteps(128) and AdaptiveController, the kernel
    backend against the reference backend, and a detection pass whose
    bisection calls no dynamics and reads nothing on the host."""
    import math

    import torch
    from repro_torch.core import (ACA, ALF, MALI, AdaptiveController,
                                  Backsolve, ConstantSteps, Dopri5,
                                  HeunEuler, Naive)
    from repro_torch.core.dense import locate_event
    from repro_torch.core.solve import _record_span, _span_interpolation
    t_star = math.log(2.0) / EV_A
    g_star = -t_star / EV_A
    cuda_alf, ref_alf = ALF(eta=1.0, backend="cuda"), ALF(eta=1.0)
    methods = {"mali_alf_cuda": (MALI(), cuda_alf),
               "naive_alf_cuda": (Naive(), cuda_alf),
               "aca_heun_euler": (ACA(), HeunEuler()),
               "backsolve_dopri5": (Backsolve(), Dopri5())}
    reference = {"mali_alf_cuda": (MALI(), ref_alf),
                 "naive_alf_cuda": (Naive(), ref_alf)}
    controllers = {"constant_128": ConstantSteps(128),
                   "adaptive": AdaptiveController(1e-4, 1e-5, 256)}
    out = {}
    for cname, ctrl in controllers.items():
        for label, (gradient, solver) in methods.items():
            t_ev, g, ys, sol = _event_solve(gradient, solver, ctrl)
            row = {"event_time": float(t_ev), "dt_da": float(g),
                   "time_err": abs(float(t_ev) - t_star),
                   "grad_rel_err": abs(float(g) - g_star) / abs(g_star),
                   "n_fevals": int(sol.stats.n_fevals)}
            require(bool(sol.stats.event_fired),
                    f"event {label} {cname}: did not fire")
            require(row["time_err"] <= EV_TIME_ATOL,
                    f"event {label} {cname}: event_time {row['event_time']}"
                    f" vs ln2/a {t_star}")
            require(row["grad_rel_err"] <= EV_GRAD_RTOL,
                    f"event {label} {cname}: dt*/da {row['dt_da']} vs "
                    f"-t*/a {g_star}")
            if label in reference:
                t_r, g_r, ys_r, _ = _event_solve(*reference[label], ctrl)
                row["kernel_vs_reference"] = rel = max(
                    _rel_err(t_ev, t_r), _rel_err(ys, ys_r), _rel_err(g, g_r))
                require(rel <= EV_KERNEL_REL,
                        f"event {label} {cname}: kernel vs reference rel "
                        f"{rel}")
            out[f"{label}_{cname}"] = row
    # The detection pass: the bisection evaluates the interpolant only.
    calls = {"f": 0, "cond": 0}

    def f(p, z, t):
        calls["f"] += 1
        return -p["a"] * z

    def cond(z, t):
        calls["cond"] += 1
        return z[0] - 0.5

    p = {"a": torch.full((), EV_A, device="cuda")}
    with torch.no_grad():
        grid, res = _record_span(f, p, torch.ones(3, device="cuda"), 0.0,
                                 EV_T1, cuda_alf, ConstantSteps(128))
        interp = _span_interpolation(f, p, cuda_alf, grid, res)
        before = calls["f"]
        t_ev, fired = _no_sync(lambda: locate_event(interp, cond, -1, 32,
                                                    grid[-1]))
    require(calls["f"] == before, "locate_event called the dynamics")
    require(calls["cond"] == 2 + 32, f"locate_event called cond_fn "
            f"{calls['cond']} times, expected 34")
    require(bool(fired) and abs(float(t_ev) - t_star) <= EV_TIME_ATOL,
            "locate_event on the card")
    out["locate_event"] = {"f_calls_in_bisection": calls["f"] - before,
                           "cond_calls": calls["cond"],
                           "event_time": float(t_ev)}
    return out


def phase_cnf(card: str, smi: str):
    """Phase 14: the image CNF trained on the card through the ALF
    kernels at both batches, kernel against reference (MALI and Naive)
    and Naive against MALI, exact launch counts, no host sync, peak
    memory from 8 to 64 steps, sample(), events, and times.

    The first-step comparison is nearly trivial: the output layer starts
    at zero, so f is 0, the ALF kernels see v = 0 and the inner layers'
    gradients are exactly 0 on both backends (held exactly, by
    CNF_ZERO_ATOL); only the output layer's gradient carries weight
    there. The comparisons at the trained parameters are the ones that
    hold the kernels on a moving state."""
    import torch
    from repro_torch.core import Naive
    torch.cuda.empty_cache()
    xs_by_batch = {b: _cnf_data(b) for b in CNF_BATCHES}
    out = {}
    trained_by_batch = {}
    launches = None
    for batch, xs in xs_by_batch.items():
        row = {}
        counts, (losses, bpds, wall, trained) = _counted(
            f"CNF training at batch {batch}", lambda: _cnf_train(xs),
            CNF_STEPS, CNF_PER_STEP)
        if batch == CNF_BATCHES[-1]:
            launches = counts
        require(all(np.isfinite(losses)) and all(np.isfinite(bpds)),
                f"CNF batch {batch}: non-finite losses {losses}")
        require(losses[-1] < losses[0], f"CNF batch {batch}: loss did not "
                f"fall: {losses[0]} -> {losses[-1]}")
        row.update(first_loss=losses[0], last_loss=losses[-1],
                   first_bits_per_dim=bpds[0], last_bits_per_dim=bpds[-1],
                   losses=losses, bits_per_dim=bpds,
                   first_run_step_ms=wall / CNF_STEPS * 1e3)
        # The first step's loss and gradients, and the trained parameters',
        # on the kernel backend against the reference backend (same probe)
        init = _cnf_params()
        for label, params in (("first_step", init), ("trained", trained)):
            l_k, g_k = _cnf_grads(params, xs[0], 0)
            l_r, g_r = _cnf_grads(params, xs[0], 0, backend="reference")
            rel = max(_rel_err(l_k, l_r, CNF_ZERO_ATOL),
                      _rel_err(g_k, g_r, CNF_ZERO_ATOL))
            require(rel <= CNF_REL, f"CNF batch {batch} {label}: kernel vs "
                    f"reference rel {rel}")
            row[f"{label}_kernel_vs_reference_rel"] = rel
        # Naive (ALF cuda) at the trained parameters, counted, against
        # Naive on the reference backend (this holds alf_midpoint_vjp and
        # alf_update_vjp at the packed CNF state) and against MALI
        n_counts, (l_n, g_n) = _counted(
            f"CNF Naive gradient at batch {batch}",
            lambda: _cnf_grads(trained, xs[0], 0, gradient=Naive()), 1,
            CNF_PER_NAIVE)
        l_nr, g_nr = _cnf_grads(trained, xs[0], 0, gradient=Naive(),
                                backend="reference")
        rel = max(_rel_err(l_n, l_nr, CNF_ZERO_ATOL),
                  _rel_err(g_n, g_nr, CNF_ZERO_ATOL))
        require(rel <= CNF_REL, f"CNF batch {batch} Naive: kernel vs "
                f"reference rel {rel}")
        row["naive_kernel_vs_reference_rel"] = rel
        _, g_m = _cnf_grads(trained, xs[0], 0)
        row["naive_vs_mali_max_abs_grad_diff"] = _leaves_close(
            g_n, g_m, f"CNF batch {batch} Naive vs MALI")
        # One fixed-step training step with every host sync an error
        gen = _cnf_probe(0)
        torch.cuda.synchronize()
        _no_sync(lambda: _cnf_loss(trained, xs[0], gen)[0].backward())
        row["no_host_sync_step"] = True
        row["launches_per_step"] = {k: v // CNF_STEPS
                                    for k, v in counts.items() if v}
        row["naive_launches_per_gradient"] = {k: v for k, v in
                                              n_counts.items() if v}
        out[f"batch_{batch}"] = row
        trained_by_batch[batch] = trained
        del init
    peaks, growth = _cnf_memory(xs_by_batch[CNF_BATCHES[-1]][0])
    sample_launches, sample = _cnf_sample(_cnf_params())
    events = _events()
    times = _cnf_times(xs_by_batch)
    emit({"phase": "cnf", "card": card, "nvidia_smi": smi,
          "model": f"examples/cnf_image.py: DIM {CNF_DIM}, mlp_vfield "
          f"hidden {CNF_HIDDEN} depth {CNF_DEPTH}, Hutchinson, ALF(eta=1, "
          f"cuda), ConstantSteps({CNF_N_SUB}), MALI, cnf_loss(kinetic_reg="
          f"{CNF_KINETIC}), Adam {CNF_LR}, Lockstep",
          "steps": CNF_STEPS,
          "packed_state_elements": dict(zip(CNF_BATCHES, CNF_PACKED_N)),
          **out, "peak_bytes_batch_1024": peaks, **growth,
          "sample": sample, "sample_launches": {
              k: v for k, v in sample_launches.items() if v},
          "events": events, "times": {f"batch_{b}": t
                                      for b, t in times.items()}})
    return launches, sample_launches, trained_by_batch, xs_by_batch


# ---------------------------------------------------------------------------
# Phase 15: per-sample batching (PerSample, Sharded) on the card
# ---------------------------------------------------------------------------

# (a) benchmarks/batched_throughput.py's stiffness mix: dz/dt = -lam z,
# lam log-spaced over [0.5, 50], the damped ALF of Appendix A.5
PS_BATCH, PS_LAM = 16, (0.5, 50.0)
PS_ETA, PS_CTRL = 0.9, (1e-3, 1e-4, 512)
# (b, c) the image CNF under PerSample with an adaptive controller: the
# base tolerances, the tighter ones tried for (c) (the first with >= 4x
# the base's mean accepted steps a row is measured), one max_steps
CNF_PS_TOL = (1e-2, 1e-3)
CNF_PS_TIGHT = ((1e-3, 1e-4), (1e-4, 1e-5), (1e-5, 1e-6), (1e-6, 1e-7))
CNF_PS_MAX = 256
CNF_PS_STEPS = 3          # timed PerSample training steps a batch
CNF_PS_PROFILED = 2       # profiled PerSample training steps a batch
CNF_PS_ROWS = 4           # rows held to their own single-row solves


def _stiff_f(p, z, t):
    import torch
    return {"lam": torch.zeros_like(z["lam"]), "y": -z["lam"] * z["y"]}


def _stiff_batch():
    import torch
    lam = torch.logspace(np.log10(PS_LAM[0]), np.log10(PS_LAM[1]),
                         PS_BATCH, device="cuda")
    return {"lam": lam[:, None], "y": torch.ones(PS_BATCH, 1,
                                                 device="cuda")}


def _stiff_solve(z0, batching, gradient=None, backend="cuda"):
    """The stiffness mix's solve from fresh leaves of z0 and its
    d(sum y^2)/d(y0)."""
    import torch
    from repro_torch.core import ALF, MALI, AdaptiveController, solve
    z = {k: v.detach().clone().requires_grad_(True) for k, v in z0.items()}
    sol = solve(_stiff_f, {}, z, 0.0, 1.0,
                solver=ALF(eta=PS_ETA, backend=backend),
                controller=AdaptiveController(*PS_CTRL),
                gradient=MALI() if gradient is None else gradient,
                batching=batching)
    (g,) = torch.autograd.grad((sol.ys["y"] ** 2).sum(), [z["y"]])
    return sol._replace(ys={k: v.detach() for k, v in sol.ys.items()}), g


def _per_sample_stiff():
    """(a): PerSample's per-row counters equal 16 stacked single-row
    solves; total f-evals against Lockstep; Naive and unfused MALI (the
    per-row VJP and inverse kernels) against fused MALI."""
    import torch
    from repro_torch.core import MALI, Lockstep, Naive, PerSample
    z0 = _stiff_batch()
    sol, g = _stiff_solve(z0, PerSample())
    per = sol.stats.per_sample
    row_rel = 0.0
    for i in range(PS_BATCH):
        single, g_i = _stiff_solve({k: v[i] for k, v in z0.items()}, None)
        got = [int(c[i]) for c in per]
        want = [int(single.stats.n_accepted), int(single.stats.n_rejected),
                int(single.stats.n_fevals)]
        require(got == want, f"per_sample (a) row {i}: counters {got} vs "
                f"its single-row solve's {want}")
        row_rel = max(row_rel, _rel_err(sol.ys["y"][i], single.ys["y"]),
                      _rel_err(g[i], g_i))
    require(row_rel <= CNF_REL, f"per_sample (a): values or gradients "
            f"{row_rel} from the single-row solves'")
    lock, _ = _stiff_solve(z0, Lockstep())
    naive, g_n = _stiff_solve(z0, PerSample(), Naive())
    unfused, g_u = _stiff_solve(z0, PerSample(), MALI(fused_bwd=False))
    ref, g_r = _stiff_solve(z0, PerSample(), backend="reference")
    require(torch.equal(ref.stats.per_sample.n_accepted, per.n_accepted),
            "per_sample (a): kernel and reference backends took different "
            "steps")
    rel = {"kernel_vs_reference": max(_rel_err(sol.ys, ref.ys),
                                      _rel_err(g, g_r)),
           "naive_vs_mali": _rel_err(g_n, g),
           "unfused_vs_fused_mali": _rel_err(g_u, g)}
    require(rel["kernel_vs_reference"] <= CNF_REL
            and rel["naive_vs_mali"] <= GRAD_TOL["rtol"]
            and rel["unfused_vs_fused_mali"] <= GRAD_TOL["rtol"],
            f"per_sample (a): {rel}")
    ratio = int(lock.stats.n_fevals) / int(sol.stats.n_fevals)
    require(ratio > 1.0, f"per_sample (a): Lockstep/PerSample f-evals "
            f"{ratio} <= 1")
    return {"per_row_accepted": per.n_accepted.tolist(),
            "per_row_rejected": per.n_rejected.tolist(),
            "fevals_per_sample": int(sol.stats.n_fevals),
            "fevals_lockstep": int(lock.stats.n_fevals),
            "fevals_lockstep_over_per_sample": ratio,
            "rows_vs_single_rel": row_rel, **rel}


def _cnf_ps_loss(params, x, gen, tol=CNF_PS_TOL, backend="cuda",
                 batching="per_sample", estimator=None):
    """cnf_loss(log_prob) of the image CNF under PerSample (or the given
    batching; None: one unbatched sample) with AdaptiveController(*tol,
    CNF_PS_MAX)."""
    from repro_torch.cnf import CNF, Hutchinson, cnf_loss
    from repro_torch.core import ALF, MALI, AdaptiveController, PerSample
    from repro_torch.models import mlp_vfield
    flow = CNF(mlp_vfield, CNF_DIM,
               estimator=Hutchinson() if estimator is None else estimator)
    res = flow.log_prob(params, x, gen, solver=ALF(eta=1.0, backend=backend),
                        controller=AdaptiveController(*tol, CNF_PS_MAX),
                        gradient=MALI(),
                        batching=PerSample() if batching == "per_sample"
                        else batching)
    return cnf_loss(res, kinetic_reg=CNF_KINETIC), res


def _cnf_ps_grads(params, x, **kw):
    import torch
    import torch.utils._pytree as pytree
    loss, res = _cnf_ps_loss(params, x, _cnf_probe(0), **kw)
    grads = torch.autograd.grad(loss, pytree.tree_leaves(params))
    return loss.detach(), res, grads


def _fixed_probe(probe):
    """A Hutchinson estimator that hands ``probe`` to the solve, so a
    row's single-row solve sees the row of the batch's probe."""
    import dataclasses
    from typing import Any

    from repro_torch.cnf import Hutchinson

    @dataclasses.dataclass(frozen=True, eq=False)
    class _Given(Hutchinson):
        given: Any = None

        def init_noise(self, generator, x):
            return self.given

    return _Given(given=probe)


def _count_syncs(fn):
    """fn() with every host sync reported; returns (result, syncs, where:
    the count of syncs by file:line of the Python code that made them)."""
    import collections
    import warnings

    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        caught.clear()      # the notice the mode switch itself gives
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    where = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in syncs)
    return out, len(syncs), dict(where)


def _cnf_ps_batch(params, xs):
    """(b) at one batch: kernel vs reference backend, rows vs their
    single-row solves, host reads and ALF launches per trial (PerSample
    and Lockstep), ms per training step and the device's idle share, the
    spread of accepted steps over rows."""
    import torch
    import torch.utils._pytree as pytree
    from repro_torch.core import Lockstep
    from repro_torch.kernels.alf_step import alf_step
    x = xs[0]
    l_k, res_k, g_k = _cnf_ps_grads(params, x)
    l_r, res_r, g_r = _cnf_ps_grads(params, x, backend="reference")
    per, per_r = res_k.solution.stats.per_sample, res_r.solution.stats.\
        per_sample
    for c_k, c_r in zip(per, per_r):
        require(torch.equal(c_k, c_r), "per_sample (b): kernel and "
                "reference backends' per-row counters differ")
    rel = max(_rel_err(l_k, l_r, CNF_ZERO_ATOL),
              _rel_err(res_k.logp.detach(), res_r.logp.detach(),
                       CNF_ZERO_ATOL),
              _rel_err(g_k, g_r, CNF_ZERO_ATOL))
    require(rel <= CNF_REL, f"per_sample (b): kernel vs reference rel {rel}")
    # the fastest and the slowest rows and two more, each against its own
    # single-row solve with the same probe row
    acc = per.n_accepted
    picks = sorted({int(torch.argmin(acc)), int(torch.argmax(acc)), 1,
                    x.shape[0] // 2})[:CNF_PS_ROWS]
    from repro_torch.cnf import Hutchinson
    probe = Hutchinson().init_noise(_cnf_probe(0), x)   # the batch's probe
    row_rel = {}
    with torch.no_grad():
        for i in picks:
            _, single = _cnf_ps_loss(params, x[i], None, batching=None,
                                     estimator=_fixed_probe(probe[i]))
            row_rel[i] = _rel_err(single.logp, res_k.logp[i].detach())
            got = [int(c[i]) for c in per]
            st = single.solution.stats
            want = [int(st.n_accepted), int(st.n_rejected),
                    int(st.n_fevals)]
            require(got == want, f"per_sample (b) row {i}: counters {got} "
                    f"vs its single-row solve's {want}")
            require(row_rel[i] <= CNF_REL, f"per_sample (b) row {i}: logp "
                    f"rel {row_rel[i]} vs its single-row solve")
        # host reads and ALF launches of a forward: one read a trial; a
        # trial is one midpoint and one update, as a Lockstep trial is
        trials = {}
        for label, batching in (("per_sample", "per_sample"),
                                ("lockstep", Lockstep())):
            gen = _cnf_probe(0)
            alf_step.reset_launches()
            torch.cuda.synchronize()
            (_, res), syncs, where = _count_syncs(lambda: _cnf_ps_loss(
                params, x, gen, batching=batching))
            torch.cuda.synchronize()
            n_trials = int((res.solution.stats.per_sample.n_accepted
                            + res.solution.stats.per_sample.n_rejected)
                           .max())
            trials[label] = {
                "trials": n_trials, "host_reads": syncs,
                "midpoint_launches": alf_step.LAUNCHES["alf_midpoint"],
                "update_launches": alf_step.LAUNCHES["alf_update"],
                "per_row_launches": sum(alf_step.ROW_LAUNCHES.values()),
                "host_reads_at": where}
            require(syncs == n_trials, f"per_sample (b) {label}: {syncs} "
                    f"host reads in {n_trials} trials, at {where}")
            require(alf_step.LAUNCHES["alf_midpoint"] == n_trials
                    and alf_step.LAUNCHES["alf_update"] == n_trials,
                    f"per_sample (b) {label}: ALF launches per trial "
                    f"{trials[label]}")
    # ms per PerSample training step (Adam on a copy of the weights), and
    # the device's idle share over profiled steps
    def train(steps):
        p = pytree.tree_map(lambda l: l.detach().clone().requires_grad_(True),
                            params)
        opt = torch.optim.Adam(pytree.tree_leaves(p), lr=CNF_LR)
        for i in range(steps):
            opt.zero_grad(set_to_none=True)
            loss, _ = _cnf_ps_loss(p, xs[i], _cnf_probe(i))
            loss.backward()
            opt.step()
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    train(CNF_PS_STEPS)
    step_ms = (time.perf_counter() - t0) / CNF_PS_STEPS * 1e3
    prof = _device_profile(lambda: train(CNF_PS_PROFILED))
    accf = acc.double()
    return {"loss": float(l_k), "kernel_vs_reference_rel": rel,
            "rows_vs_single_rel": row_rel, "trials": trials,
            "step_ms": step_ms, "profiled_steps": CNF_PS_PROFILED,
            "profile": {k: prof[k] for k in (
                "device_busy_ms", "device_window_ms", "idle_share",
                "device_launches", "host_ms", "top_device_ms")},
            "accepted_min": int(acc.min()), "accepted_max": int(acc.max()),
            "accepted_mean": float(accf.mean()),
            "accepted_std": float(accf.std()) if acc.numel() > 1 else 0.0}


def _cnf_ps_memory(params, x):
    """(c) MALI's peak memory under PerSample at batch 1024: the base
    tolerances against the first tighter pair with >= 4x the mean
    accepted steps a row, one max_steps; each read twice, the growth
    from the second readings."""
    import torch
    import torch.utils._pytree as pytree
    with torch.no_grad():
        base_acc = float(_cnf_ps_loss(params, x, _cnf_probe(0))[1].solution
                         .stats.per_sample.n_accepted.double().mean())
        tight, tight_acc = None, 0.0
        for tol in CNF_PS_TIGHT:
            st = _cnf_ps_loss(params, x, _cnf_probe(0), tol=tol)[1]\
                .solution.stats
            tight_acc = float(st.per_sample.n_accepted.double().mean())
            require(bool(st.per_sample.n_accepted.max() < CNF_PS_MAX),
                    f"per_sample (c): tolerances {tol} exhaust max_steps")
            if tight_acc >= 4.0 * base_acc:
                tight = tol
                break
    require(tight is not None, f"per_sample (c): no tolerance pair gave 4x "
            f"the base's {base_acc} accepted steps a row")
    readings = {}
    for label, tol in (("base", CNF_PS_TOL), ("tight", tight)):
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            loss, _ = _cnf_ps_loss(params, x, _cnf_probe(0), tol=tol)
            torch.autograd.grad(loss, pytree.tree_leaves(params))
            torch.cuda.synchronize()
            readings.setdefault(label, []).append(
                torch.cuda.max_memory_allocated() - base)
            del loss
    growth = readings["tight"][-1] / readings["base"][-1]
    require(growth <= 1.05, f"per_sample (c): MALI peak memory grew "
            f"{growth}x at {tight_acc / base_acc}x the steps")
    return {"base_tol": list(CNF_PS_TOL), "tight_tol": list(tight),
            "mean_accepted_base": base_acc, "mean_accepted_tight": tight_acc,
            "step_ratio": tight_acc / base_acc, "peak_bytes": readings,
            "peak_growth": growth}


def _sharded_w1(params, x):
    """(d) Sharded(axis='data', inner=Lockstep()) (examples/cnf_image.py's
    batching) and inner=PerSample() on a one-rank mesh on the card: bit
    equal to the inner batching, values and gradients."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import Lockstep, PerSample, Sharded
    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    mesh = make_host_mesh()
    try:
        for label, inner in (("lockstep", Lockstep()),
                             ("per_sample", PerSample())):
            l_i, res_i, g_i = _cnf_ps_grads(params, x, batching=inner)
            with mesh:
                l_s, res_s, g_s = _cnf_ps_grads(
                    params, x, batching=Sharded(axis="data", inner=inner))
            same = (torch.equal(l_i, l_s)
                    and torch.equal(res_i.logp, res_s.logp)
                    and all(torch.equal(a, b) for a, b in zip(g_i, g_s))
                    and all(torch.equal(a, b) for a, b in zip(
                        res_i.solution.stats.per_sample,
                        res_s.solution.stats.per_sample)))
            require(same, f"per_sample (d): Sharded(inner={label}) at W=1 "
                    "is not bit-equal to its inner batching")
            out[label] = {"bit_equal": True, "loss": float(l_s)}
        out["mesh"] = repr(mesh)
    finally:
        dist.destroy_process_group()
    return out


def phase_per_sample(card: str, smi: str, trained, xs_by_batch):
    """Phase 15: PerSample and Sharded on the card, full width: (a) the
    stiffness mix, (b) the image CNF at batch 1024 and 16 on phase 14's
    trained weights, (c) MALI's memory under PerSample, (d) Sharded at
    one rank. The per-row ALF launches of (a) and (b)'s gradients are
    counted from 0."""
    import torch
    import torch.utils._pytree as pytree
    from repro_torch.kernels.alf_step import alf_step, ops
    t0 = time.perf_counter()
    parts = {}

    def lap(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    params = {b: pytree.tree_map(lambda l: l.detach().clone()
                                 .requires_grad_(True), trained[b])
              for b in CNF_BATCHES}
    alf_step.reset_launches()
    ops.reset_op_calls()
    stiff = _per_sample_stiff()
    lap("a")
    for b in CNF_BATCHES[::-1]:
        _cnf_ps_grads(params[b], xs_by_batch[b][0])
    launches = dict(alf_step.ROW_LAUNCHES)
    lap("counted_gradients")
    for name in KERNELS:
        if name != "alf_inverse_update":
            require(launches[name] > 0, f"per_sample: {name} launched no "
                    "per-row call on the PerSample paths")
    cnf = {}
    for b in CNF_BATCHES[::-1]:
        cnf[f"batch_{b}"] = _cnf_ps_batch(params[b], xs_by_batch[b])
        lap(f"b_batch_{b}")
    memory = _cnf_ps_memory(params[CNF_BATCHES[-1]],
                            xs_by_batch[CNF_BATCHES[-1]][0])
    lap("c")
    sharded = _sharded_w1(params[CNF_BATCHES[0]],
                          xs_by_batch[CNF_BATCHES[0]][0])
    torch.cuda.synchronize()
    lap("d")
    emit({"phase": "per_sample", "card": card, "nvidia_smi": smi,
          "stiffness_mix": {"batch": PS_BATCH, "lam": list(PS_LAM),
                            "eta": PS_ETA, "controller": list(PS_CTRL),
                            **stiff},
          "cnf": {"model": f"examples/cnf_image.py widths (DIM {CNF_DIM}, "
                  f"hidden {CNF_HIDDEN} depth {CNF_DEPTH}), Hutchinson, "
                  f"ALF cuda, MALI, PerSample, AdaptiveController"
                  f"{CNF_PS_TOL + (CNF_PS_MAX,)}, phase 14's trained "
                  "weights", **cnf},
          "memory_batch_1024": memory, "sharded_w1": sharded,
          "per_row_launches": {k: v for k, v in launches.items() if v},
          "part_s": parts, "phase_s": time.perf_counter() - t0})
    return launches


# ---------------------------------------------------------------------------
# Phase 16: the continuous-batching ODE serving engine (repro_torch.serve)
# ---------------------------------------------------------------------------

# (a)-(c): benchmarks/serve_load.py's protocol at its own sizes
SV_SLOTS, SV_CHUNK, SV_D, SV_N = 8, 16, 16, 64
SV_LAM = (float(np.log10(0.5)), float(np.log10(200.0)))
SV_MAX_STEPS = 2048
SV_LOAD = 0.75                # offered rate / closed-loop capacity
SV_REPEATS = 6                # hot-trajectory repeat queries
# The JAX package's benchmarks/serve_load.py (python -m benchmarks.run
# --only serve_load, on a CPU). Counts and tick-clock ratios: the same on
# any machine given the same per-request trial counts.
SV_JAX = {"rounds": {"continuous": 176, "static": 251},
          "fevals_per_request": 159.421875,
          "p99_static_over_continuous": 2.19278,
          "solves_continuous_over_static": 1.3805,
          "occupancy": {"continuous": 0.471591, "static": 0.917331}}
SV_ATOL, SV_RTOL = 1e-6, 1e-6     # (a), (b): end states, |d| <= a + r|x|
SV_EVENT_TOL = 1e-6               # (c): event_time against solve()
SV_FULL_REL = 1e-5                # (b) on (d): max |d| / max |x|
SV_FULL_ROWS = 8                  # (b) on (d): the 4 fastest + 4 slowest
# (d): launch/serve.py --mode ode at full width (D = the image CNF's 784)
SV_FULL = dict(batch=1024, d_state=784, n_requests=4096, chunk_steps=32)
SV_PROFILED = 4                   # rounds profiled and sync-counted


def _sv_engine(cls, device: str, **kw):
    """An engine of cls over decay_dynamics at serve_load's sizes, the
    kernels on the card and the reference backend on the CPU."""
    from repro_torch.core import ALF
    from repro_torch.serve import EngineConfig, decay_dynamics
    backend = "cuda" if device == "cuda" else "reference"
    return cls(decay_dynamics, None,
               config=EngineConfig(slots=SV_SLOTS, chunk_steps=SV_CHUNK,
                                   solver=ALF(eta=0.9, backend=backend)),
               device=device, **kw)


def _sv_requests(seed: int, rate: float):
    from repro_torch.serve import mixed_stiffness_requests
    return mixed_stiffness_requests(
        np.random.default_rng(seed), SV_N, rate=rate, d_state=SV_D,
        lam_decades=SV_LAM, max_steps=SV_MAX_STEPS)


def _tick_timer(tau: float):
    """serve_load's deterministic clock: tau/2 a sample."""
    state = {"t": 0.0}

    def timer() -> float:
        state["t"] += tau / 2.0
        return state["t"]

    return timer


def _sv_load(device: str):
    """serve_load's protocol on one device: a closed-loop warm-up, a timed
    closed-loop run (tau, ms a round), capacity on the tick clock, then
    both engines on one Poisson trace at SV_LOAD of it. On the card the
    ALF launches of the continuous load run are counted: 2 a trial, all
    per-row."""
    import torch
    from repro_torch.kernels.alf_step import alf_step
    from repro_torch.serve import ContinuousBatchingEngine, StaticFleetEngine
    closed = 1e9                   # ~all arrivals at t = 0
    warm = _sv_engine(ContinuousBatchingEngine, device)
    warm.submit(_sv_requests(0, closed))
    warm.run()
    timed = _sv_engine(ContinuousBatchingEngine, device)
    timed.submit(_sv_requests(0, closed))
    rep = timed.run()
    tau = rep.duration_s / max(rep.rounds, 1)
    cap = _sv_engine(ContinuousBatchingEngine, device,
                     timer=_tick_timer(tau))
    cap.submit(_sv_requests(0, closed))
    mu = cap.run().solves_per_s
    rate = SV_LOAD * mu
    runs, launches = {}, None
    for cls in (ContinuousBatchingEngine, StaticFleetEngine):
        eng = _sv_engine(cls, device, timer=_tick_timer(tau))
        reqs = _sv_requests(1, rate)
        eng.submit(reqs)
        alf_step.reset_launches()
        runs[eng.name] = (eng, reqs, eng.run())
        if device == "cuda" and launches is None:
            launches = (dict(alf_step.LAUNCHES), dict(alf_step.ROW_LAUNCHES))
            torch.cuda.synchronize()
    cont, stat = runs["continuous"][2], runs["static"][2]
    summary = {
        "device": device, "tau_ms": tau * 1e3,
        "closed_loop_rounds": rep.rounds, "capacity_solves_per_s": mu,
        "rate": rate,
        "p99_static_over_continuous": stat.p99_latency_s
        / max(cont.p99_latency_s, 1e-12),
        "solves_continuous_over_static": cont.solves_per_s
        / max(stat.solves_per_s, 1e-12),
        **{name: {k: getattr(r[2], k) for k in (
            "rounds", "fevals_per_request", "backfill_occupancy",
            "p50_latency_s", "p99_latency_s", "solves_per_s",
            "n_completed")} for name, r in runs.items()}}
    return summary, runs, launches


def _sv_close(got: dict, want: dict, what: str) -> float:
    """End states within SV_ATOL + SV_RTOL |want| per element; returns
    the largest |got - want|."""
    worst = 0.0
    for k, w in want.items():
        g = np.asarray(got[k], np.float64)
        w = np.asarray(w, np.float64)
        require(np.all(np.isfinite(g)), f"{what}: non-finite {k}")
        d = np.abs(g - w)
        require(bool(np.all(d <= SV_ATOL + SV_RTOL * np.abs(w))),
                f"{what}: {k} differs by {float(d.max())}")
        worst = max(worst, float(d.max()))
    return worst


def _sv_card_vs_cpu(card_runs, cpu_runs):
    """(a): per request, the card's counters equal the CPU's and its end
    state is within tolerance; rounds equal."""
    worst = 0.0
    for name, (ge, greqs, grep) in card_runs.items():
        ce, creqs, crep = cpu_runs[name]
        require(grep.rounds == crep.rounds, f"serve (a) {name}: "
                f"{grep.rounds} rounds on the card, {crep.rounds} on the CPU")
        grec = {r.rid: r for r in ge.records}
        crec = {r.rid: r for r in ce.records}
        for i, (a, b) in enumerate(zip(greqs, creqs)):
            ra, rb = grec[a.rid], crec[b.rid]
            got = (ra.n_fevals, ra.n_accepted, ra.completed)
            want = (rb.n_fevals, rb.n_accepted, rb.completed)
            require(got == want, f"serve (a) {name} request {i} (lam "
                    f"{float(a.z0['lam'][0])}): card {got}, CPU {want}")
            worst = max(worst, _sv_close(ge.results[a.rid],
                                         ce.results[b.rid],
                                         f"serve (a) {name} request {i}"))
    return worst


def _sv_solve(f, params, z0, cfg) -> dict:
    """One request's own solve() on the card: scalar kernels, the
    engine's controller."""
    import torch
    from repro_torch.core import ALF, ReproducibleController, solve
    z0 = {k: torch.as_tensor(v, device="cuda") for k, v in z0.items()}
    with torch.no_grad():
        return solve(f, params, z0, cfg.t0, cfg.t1,
                     solver=ALF(eta=0.9, backend="cuda"),
                     controller=ReproducibleController(cfg.rtol, cfg.atol,
                                                       cfg.max_steps))


def _sv_rel(got: dict, want: dict) -> float:
    return max(float(np.abs(np.asarray(got[k]) - w.cpu().numpy()).max()
                     / max(float(w.abs().max()), 1e-30))
               for k, w in want.items())


def _sv_fleet_row(f, rows: int):
    """``f`` for one sample computed as the engine computes a fleet row's:
    row 0 of ``per_sample(f)`` over ``rows`` rows (the others zero). A
    GEMM rounds a row the same whatever the other rows hold, but not as
    the one-row product (a GEMV) does."""
    import torch
    from repro_torch.core.interface import per_sample
    rows_f = per_sample(f)

    def f_row(params, z, t):
        zb = {k: torch.cat([v[None], v.new_zeros((rows - 1,) + v.shape)])
              for k, v in z.items()}
        out = rows_f(params, zb, t.reshape(1).expand(rows))
        return {k: v[0] for k, v in out.items()}

    return f_row


def _sv_vs_solve(eng, reqs, f, params, what: str, rel_tol=None):
    """(b): each request's served end state and counters against its own
    solve() on the card (scalar kernels, the engine's controller, ``f``):
    counters equal, states within SV_ATOL/SV_RTOL or, given rel_tol, max
    |d| / max |x| within it. Returns the worst difference."""
    recs = {r.rid: r for r in eng.records}
    worst = 0.0
    for req in reqs:
        sol = _sv_solve(f, params, req.z0, req.config)
        rec = recs[req.rid]
        want = (int(sol.stats.n_fevals), int(sol.stats.n_accepted))
        require((rec.n_fevals, rec.n_accepted) == want,
                f"{what}: request {req.rid} served with (f-evals, accepted) "
                f"{(rec.n_fevals, rec.n_accepted)}, solve() {want}")
        if rel_tol is None:
            worst = max(worst, _sv_close(
                eng.results[req.rid],
                {k: v.cpu().numpy() for k, v in sol.ys.items()}, what))
            continue
        r = _sv_rel(eng.results[req.rid], sol.ys)
        require(r <= rel_tol, f"{what}: request {req.rid} rel {r}")
        worst = max(worst, r)
    return worst


def _sv_lanes():
    """(c): the dense lane's hot trajectory (hit rate 6/7, 0 f-evals a
    hit) and one event request on -lam*y against the same event solve()
    on the card; 2 scalar ALF launches a trial in both lanes."""
    import torch
    from repro_torch.core import ALF, Event, ReproducibleController, solve
    from repro_torch.kernels.alf_step import alf_step
    from repro_torch.serve import (ContinuousBatchingEngine,
                                   InterpolantCache, LRU, Request,
                                   RequestConfig, decay_dynamics,
                                   hot_trajectory_requests)

    def scalar_launches(trials, what):
        for name in FORWARD:
            n, rows = alf_step.LAUNCHES[name], alf_step.ROW_LAUNCHES[name]
            require(n == trials and rows == 0, f"serve (c) {what}: {name} "
                    f"launched {n} times ({rows} per-row) in {trials} trials")

    cache = InterpolantCache(LRU(max_entries=16))
    eng = _sv_engine(ContinuousBatchingEngine, "cuda", cache=cache,
                     vf_id="decay")
    eng.submit(hot_trajectory_requests(
        np.random.default_rng(2), n_repeats=SV_REPEATS, d_state=SV_D,
        max_steps=SV_MAX_STEPS))
    alf_step.reset_launches()
    rep = eng.run()
    hits = [r.n_fevals for r in eng.records if r.cache_hit]
    (miss,) = [r for r in eng.records if not r.cache_hit]
    require((rep.cache_hits, rep.cache_misses) == (SV_REPEATS, 1)
            and hits == [0] * SV_REPEATS, f"serve (c): cache "
            f"{rep.cache_hits}/{rep.cache_misses}, hit f-evals {hits}")
    scalar_launches(miss.n_fevals - 1, "dense")     # less v0

    lam = 8.0
    ev = Event(lambda z, t: z["y"][0] - 0.5, direction=-1)
    z0 = {"y": np.ones(SV_D, np.float32),
          "lam": np.full(SV_D, lam, np.float32)}
    cfg = RequestConfig(t1=1.0, max_steps=SV_MAX_STEPS)
    req = Request(z0=z0, config=cfg, event=ev)
    ev_eng = _sv_engine(ContinuousBatchingEngine, "cuda")
    ev_eng.submit([req])
    alf_step.reset_launches()
    ev_eng.run()
    (rec,) = ev_eng.records
    scalar_launches(rec.n_fevals - 2, "event")      # less two v0s
    with torch.no_grad():
        single = solve(decay_dynamics, None,
                       {k: torch.as_tensor(v, device="cuda")
                        for k, v in z0.items()}, cfg.t0, cfg.t1,
                       solver=ALF(eta=0.9, backend="cuda"),
                       controller=ReproducibleController(
                           cfg.rtol, cfg.atol, cfg.max_steps), event=ev)
    t_served = ev_eng.event_times[req.rid]
    t_solve = float(single.stats.event_time)
    require(abs(t_served - t_solve) <= SV_EVENT_TOL, f"serve (c): event "
            f"time {t_served} served, {t_solve} by solve()")
    require(abs(t_served - np.log(2.0) / lam) < 1e-3,
            f"serve (c): event time {t_served}, ln 2 / {lam} expected")
    return {"cache_hits": rep.cache_hits, "cache_lookups":
            rep.cache_hits + rep.cache_misses, "hit_fevals": hits,
            "miss_fevals": miss.n_fevals, "event_time": t_served,
            "event_time_solve": t_solve, "event_fevals": rec.n_fevals,
            "event_ln2_over_lam": float(np.log(2.0) / lam)}


def _sv_rounds(eng, n: int) -> None:
    """n rounds of the continuous engine's loop body."""
    for _ in range(n):
        eng._dispatch()
        eng._retire_rows(eng._finished_rows(), eng.now)
        eng.scheduler.release(eng.now)
        eng._backfill()


def _sv_full_engine():
    """A continuous engine on serve_ode's own field and trace at SV_FULL
    (its seed 0, all at once), submitted."""
    from repro_torch.core import ALF
    from repro_torch.launch import serve as tserve
    from repro_torch.serve import (ContinuousBatchingEngine, EngineConfig,
                                   RequestConfig)
    rng = np.random.default_rng(0)
    f, params = tserve.mlp_field(rng, SV_FULL["d_state"], "cuda")
    reqs = tserve.ode_requests(rng, SV_FULL["n_requests"],
                               SV_FULL["d_state"],
                               RequestConfig(t0=0.0, t1=1.0, rtol=1e-3,
                                             atol=1e-4, max_steps=512))
    eng = ContinuousBatchingEngine(
        f, params, config=EngineConfig(
            slots=SV_FULL["batch"], chunk_steps=SV_FULL["chunk_steps"],
            solver=ALF(eta=0.9, backend="cuda")), device="cuda")
    eng.submit(reqs)
    return eng


def _sv_report(rep) -> dict:
    return {"p50_ms": rep.p50_latency_s * 1e3,
            "p99_ms": rep.p99_latency_s * 1e3,
            "solves_per_s": rep.solves_per_s,
            "occupancy": rep.backfill_occupancy, "rounds": rep.rounds,
            "ms_per_round": rep.duration_s * 1e3 / max(rep.rounds, 1),
            "duration_s": rep.duration_s, "n_requests": rep.n_requests,
            "n_completed": rep.n_completed,
            "fevals_per_request": rep.fevals_per_request}


def _sv_full_width():
    """(d) and (e) at full width: serve_ode for both engines all at once
    (the phase's counted main path; its continuous engine kept for peak
    memory and (b)'s 8 rows), 4 profiled and 4 sync-counted rounds, no
    sync inside a chunk, and the CLI at its defaults."""
    import contextlib
    import io
    import os

    import torch
    import repro_torch.serve as serve_pkg
    import repro_torch.serve.engine as engine_mod
    from repro_torch.launch import serve as tserve
    out = {}
    quiet = io.StringIO()
    made = []

    class Kept(serve_pkg.ContinuousBatchingEngine):
        """serve_ode's continuous engine, kept with its requests."""

        def submit(self, requests):
            made.append((self, list(requests)))
            super().submit(requests)

    _lm_reset()
    closed = {}
    serve_pkg.ENGINES["continuous"] = Kept
    try:
        with contextlib.redirect_stdout(quiet):
            for name in ("continuous", "static"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                rep = tserve.serve_ode(engine=name, **SV_FULL)
                torch.cuda.synchronize()
                closed[name] = (rep, time.perf_counter() - t0,
                                torch.cuda.max_memory_allocated() - base)
    finally:
        serve_pkg.ENGINES["continuous"] = serve_pkg.ContinuousBatchingEngine
    launches, _ = _lm_counts()
    rounds = sum(rep.rounds for rep, _, _ in closed.values())
    for name, n in launches.items():
        want = SV_FULL["chunk_steps"] * rounds if name in FORWARD else 0
        require(n == want, f"serve (e): {name} launched {n} times in "
                f"{rounds} rounds of {SV_FULL['chunk_steps']} trials")
    from repro_torch.kernels.alf_step import alf_step
    for name in FORWARD:
        require(alf_step.ROW_LAUNCHES[name] == launches[name],
                f"serve (e): {name}: a scalar launch in the chunk lane")
    out["closed_loop"] = {name: {**_sv_report(rep), "wall_s": wall,
                                 "peak_bytes": peak}
                          for name, (rep, wall, peak) in closed.items()}

    # (b) on the continuous run's rows.
    ((eng, reqs),) = made
    rep = closed["continuous"][0]
    f, params = eng.f, eng.params
    fevals = {x.rid: x.n_fevals for x in eng.records}
    by_cost = sorted(reqs, key=lambda r: fevals[r.rid])
    picked = by_cost[:SV_FULL_ROWS // 2] + by_cost[-SV_FULL_ROWS // 2:]
    out["vs_solve_rel"] = _sv_vs_solve(
        eng, picked, _sv_fleet_row(f, SV_FULL["batch"]), params,
        "serve (b) full width", SV_FULL_REL)
    out["vs_solve_fevals"] = [fevals[r.rid] for r in picked]
    # Capacity in requests a second: at D = 784 most requests spend their
    # whole trial budget (completed=False), which solves/s leaves out.
    out["capacity_requests_per_s"] = rep.n_requests / rep.duration_s
    out["capacity_solves_per_s"] = rep.solves_per_s

    # Four profiled rounds, four sync-counted rounds (no sync inside a
    # chunk: dispatch_chunk under set_sync_debug_mode("error")).
    eng = _sv_full_engine()
    eng.scheduler.release(0.0)
    eng._backfill()
    _sv_rounds(eng, 1)
    out["profile_4_rounds"] = _device_profile(
        lambda: _sv_rounds(eng, SV_PROFILED))
    chunk = engine_mod.dispatch_chunk

    def no_sync_chunk(*a, **kw):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return chunk(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    engine_mod.dispatch_chunk = no_sync_chunk
    try:
        before = eng.host_syncs
        _, n_syncs, where = _count_syncs(lambda: _sv_rounds(eng, SV_PROFILED))
    finally:
        engine_mod.dispatch_chunk = chunk
    explicit = eng.host_syncs - before
    # The round's one sync is the explicit torch.cuda.synchronize, which
    # the sync debug mode does not report; nothing else may sync.
    require(n_syncs == 0 and explicit == SV_PROFILED, f"serve (e): "
            f"{n_syncs} implicit syncs ({where}) and {explicit} explicit "
            f"ones in {SV_PROFILED} rounds; one explicit a round expected")
    out["syncs_4_rounds"] = {
        "reported": n_syncs, "where": where,
        "engine_synchronize_calls": explicit}

    # The CLI at its defaults, as users call it (the card by default).
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "ode"],
        capture_output=True, text=True, timeout=600, cwd=str(HERE),
        env=dict(os.environ, PYTHONPATH=str(SRC)))
    require(cli.returncode == 0, f"serve (d): the CLI exited "
            f"{cli.returncode}: {cli.stderr[-2000:]}")
    require("serve[continuous]" in cli.stdout
            and "256 completed" in cli.stdout and "device=cuda" in
            cli.stdout, f"serve (d): CLI output {cli.stdout[-2000:]}")
    out["cli_defaults"] = {"stdout": cli.stdout.strip().splitlines(),
                           "wall_s": time.perf_counter() - t0}
    return out, launches


def phase_serve(card: str, smi: str):
    """Phase 16: the serving engine on the card. (a) serve_load's protocol
    on the card and on the CPU, per request equal; (b) served rows against
    their own solve(); (c) the dense and event lanes; (d) serve_ode at
    full width; (e) launches and syncs. Returns the ALF launches of (d)'s
    serve_ode runs, counted from 0 (the kernels line's launches_serve)."""
    import torch
    t0 = time.perf_counter()
    parts = {}

    def lap(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    card_sum, card_runs, (lau, rows) = _sv_load("cuda")
    lap("a_card")
    cont = card_runs["continuous"][2]
    for name in FORWARD:
        require(lau[name] == rows[name] == SV_CHUNK * cont.rounds,
                f"serve (e): {name} launched {lau[name]} times "
                f"({rows[name]} per-row) in {cont.rounds} rounds of "
                f"{SV_CHUNK} trials")
    cpu_sum, cpu_runs, _ = _sv_load("cpu")
    lap("a_cpu")
    a_worst = _sv_card_vs_cpu(card_runs, cpu_runs)
    for key in ("p99_static_over_continuous",
                "solves_continuous_over_static"):
        g, c = card_sum[key], cpu_sum[key]
        require(g > 1.0 and c > 1.0 and abs(g - c) <= 1e-6 * abs(c),
                f"serve (a): {key} {g} on the card, {c} on the CPU")
    from repro_torch.serve import decay_dynamics
    eng, reqs, _ = card_runs["continuous"]
    b_worst = _sv_vs_solve(eng, reqs, decay_dynamics, None, "serve (b)")
    lap("b")
    lanes = _sv_lanes()
    lap("c")
    full, launches = _sv_full_width()
    lap("d")
    torch.cuda.synchronize()
    emit({"phase": "serve", "card": card, "nvidia_smi": smi,
          "serve_load": {
              "sizes": {"slots": SV_SLOTS, "chunk_steps": SV_CHUNK,
                        "d_state": SV_D, "requests": SV_N,
                        "lam": [10 ** SV_LAM[0], 10 ** SV_LAM[1]],
                        "max_steps": SV_MAX_STEPS, "load": SV_LOAD},
              "card": card_sum, "cpu": cpu_sum, "jax_cpu": SV_JAX,
              "card_vs_cpu_max_abs": a_worst,
              "launches_per_round": 2 * SV_CHUNK},
          "vs_solve_max_abs": b_worst, "lanes": lanes,
          "full_width": {"sizes": SV_FULL, **full},
          "part_s": parts, "phase_s": time.perf_counter() - t0})
    return launches

# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phase 17: continuous-depth LM training (qwen3-1.7b at full width)
# ---------------------------------------------------------------------------

# (a): qwen3-1.7b at its published widths, bf16, each residual branch a
# MALI solve (ConstantSteps(2)) on ALF(backend="cuda"), batch 2 x 4096
# (the JAX package's train_4k length: the FA2 path, an ALF state of 2^24
# f32), 3 Trainer steps
LT_BATCH, LT_SEQ, LT_STEPS, LT_PROFILED = 2, 4096, 3, 2
# per step: 28 layers x 2 branches x 2 ALF steps, one launch of each
# kernel a step forward (midpoint, update) and backward (bwd_pre, bwd_post)
LT_PER_STEP = {"alf_midpoint": 112, "alf_update": 112, "alf_bwd_pre": 112,
               "alf_bwd_post": 112}
# (b), (c): the 2-of-28-layer cuts, S 1024, f32
LT_CUT_LAYERS, LT_CUT_SEQ = 2, 1024
LT_BF16_TOL = 3e-2            # bf16 kernel vs reference (or 3x the floor)
LT_F32_TOL = 1e-5             # f32 kernel vs reference, relative
LT_MEM_STEPS = (2, 8)
LT_NAIVE_MEM_BATCH = 8        # Naive's activations must outweigh the state
# (d): smoke configs, one step each, f32; gemma2 past the direct limit
LT_SMOKE = (("gemma2-2b", 2, 2304), ("jamba-v0.1-52b", 2, 64),
            ("deepseek-moe-16b", 2, 64))


def _lt_config(backend: str = "cuda", n_steps: int = 2,
               method: str = "mali", layers: int = 0, dtype: str = "",
               arch: str = LM_ARCH, smoke: bool = False):
    """``arch`` with every residual branch an ALF solve (``method``,
    ConstantSteps(n_steps), ``backend``), optionally cut to ``layers``
    periods and cast to ``dtype``."""
    import dataclasses
    from repro_torch.configs import OdeSettings, get_config, smoke_config
    ode = OdeSettings(mode="per_block", method=method, solver="alf",
                      n_steps=n_steps, backend=backend)
    cfg = (smoke_config if smoke else get_config)(arch, ode)
    changes = {}
    if layers:
        changes["n_periods"] = layers
    if dtype:
        changes.update(param_dtype=dtype, compute_dtype=dtype)
    return dataclasses.replace(cfg, **changes)


def _lt_batch(cfg, batch: int, seq: int, step: int = 0):
    from repro_torch.data import DataConfig, batch_to_device, make_batch
    return batch_to_device(make_batch(
        cfg, DataConfig(seed=0, global_batch=batch, seq_len=seq), step),
        "cuda")


def _lt_grads(params, cfg, batch):
    from repro_torch import tree_util
    from repro_torch.train import loss_and_grads
    loss, stats, grads = loss_and_grads(params, batch, cfg=cfg)
    return loss, [int(c) for c in stats], tree_util.tree_leaves(grads)


def _lt_full_width():
    """(a): 3 Trainer steps of qwen3-1.7b at full width; returns (the
    trainer, batch 0, per-step launches, the results)."""
    import torch
    from repro_torch.models import lm_loss
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import MemoryEmitter, Trainer, TrainerConfig
    tc = TrainerConfig(arch=LM_ARCH, smoke=False, steps=LT_STEPS,
                       global_batch=LT_BATCH, seq_len=LT_SEQ,
                       log_every=100, emit="memory")
    snaps = []
    # the optimizer's own defaults (warmup over 100 steps): the rule the
    # Trainer derives from 3 steps warms up over 1, and at this width the
    # loss on batch 0 then ends above where it started (PERF.md)
    trainer = Trainer(tc, emitter=MemoryEmitter(),
                      step_hook=lambda step: snaps.append(
                          _lm_counts()[0]),
                      opt_cfg=OptimizerConfig())
    require(trainer.cfg.ode.backend == "cuda" and trainer.cfg.d_model == 2048
            and trainer.cfg.n_layers == 28, "lm_train: not the full config")
    _lm_reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    require(trainer.train() == LT_STEPS, "lm_train: the run did not finish")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    snaps.append(_lm_counts()[0])
    per_step = [{k: snaps[i + 1][k] - snaps[i][k] for k in snaps[i]}
                for i in range(LT_STEPS)]
    for i, counts in enumerate(per_step):
        for name, n in counts.items():
            want = LT_PER_STEP.get(name, 0)
            require(n == want, f"lm_train step {i}: {name} launched {n} "
                    f"times, expected {want}")
    _, calls = _lm_counts()
    for name in LT_PER_STEP:
        require(calls[name] == LT_STEPS * LT_PER_STEP[name],
                f"lm_train: {name} op calls {calls[name]}")
    recs = [trainer.records[s] for s in range(LT_STEPS)]
    require(all(np.isfinite(r.loss) for r in recs),
            f"lm_train: non-finite loss {[r.loss for r in recs]}")
    batch0 = trainer.batch(0)
    with torch.no_grad():
        after = float(lm_loss(trainer.state.params, trainer.cfg, batch0))
    require(np.isfinite(after) and after < recs[0].loss,
            f"lm_train: loss on batch 0 {recs[0].loss} -> {after}")
    return trainer, batch0, per_step, {
        "config": {"arch": LM_ARCH, "d_model": trainer.cfg.d_model,
                   "layers": trainer.cfg.n_layers,
                   "vocab": trainer.cfg.vocab_size, "dtype": "bfloat16",
                   "batch": LT_BATCH, "seq_len": LT_SEQ,
                   "ode": "MALI, ALF(cuda), ConstantSteps(2)",
                   "optimizer": "AdamW, peak 3e-4, warmup 100"},
        "losses": [r.loss for r in recs], "loss_batch0_after": after,
        "lr": [r.lr for r in recs], "grad_norm": [r.grad_norm for r in recs],
        "step_ms": [r.wall_s * 1e3 for r in recs], "run_s": wall,
        "fevals_per_step": recs[0].fevals,
        "accepted_per_step": recs[0].accepted,
        "residual_bytes": recs[0].residual_bytes,
        "kernel_launches_first_step": recs[0].kernel_launches,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches_per_step": per_step[0]}


def _kernel_profile(run, top: int = 8):
    """torch.profiler with device activity only over ``run()``, read from
    the raw kineto events: the device's busy and idle share and the top
    device operations. ``_device_profile``'s Python event tree takes
    minutes at a training step's ~10^5 kernels and ~10^6 host ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.profiler.kineto_results.events()
           if str(e.device_type()).endswith("CUDA")
           and not e.is_user_annotation() and "#" not in e.name()]
    require(len(dev) > 0, "profile: no device events")
    spans = sorted((e.start_ns(), e.end_ns()) for e in dev)
    busy, (lo, hi) = 0, spans[0]
    for s0, e0 in spans[1:]:
        if s0 > hi:
            busy += hi - lo
            lo, hi = s0, e0
        else:
            hi = max(hi, e0)
    busy += hi - lo
    window = spans[-1][1] - spans[0][0]
    by_name = {}
    for e in dev:
        ns, n = by_name.get(e.name(), (0, 0))
        by_name[e.name()] = (ns + e.duration_ns(), n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e6,
            "device_window_ms": window / 1e6,
            "idle_share": 1.0 - busy / window, "device_launches": len(dev),
            "top_device_ms": [[name[:60], ns / 1e6, n]
                              for name, (ns, n) in ranked]}


def _lt_step_profile(trainer, batch0):
    """No host sync in train_step, and the device profile of
    LT_PROFILED steps."""
    import torch
    from repro_torch.train import train_step
    st = trainer.state
    batches = [batch0] + [trainer.batch(i) for i in range(1, LT_PROFILED)]

    def steps(n):
        # each step from the trained state, its result dropped at once:
        # two states beside it would not fit with its activations
        for i in range(n):
            train_step(st.params, st.opt, None, batches[i], cfg=trainer.cfg,
                       opt_cfg=trainer.opt_cfg)

    _, syncs, where = _count_syncs(lambda: steps(1))
    require(syncs == 0, f"lm_train: train_step synced the host {syncs} "
            f"times: {where}")
    torch.cuda.synchronize()
    prof = _kernel_profile(lambda: steps(LT_PROFILED))
    prof["device_ms_per_step"] = prof["device_busy_ms"] / LT_PROFILED
    return {"host_syncs_in_train_step": syncs, "profile": prof}


def _lt_peak(params, opt, cfg, opt_cfg, batch) -> int:
    """Peak device bytes over one train_step beyond those allocated
    before it."""
    import torch
    from repro_torch.train import train_step
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = train_step(params, opt, None, batch, cfg=cfg, opt_cfg=opt_cfg)
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - base


def _lt_memory_mali(trainer, batch0):
    """(c), MALI: the peak over one train_step at (a)'s shape, 2 and 8
    ALF steps a branch."""
    st = trainer.state
    mali = {n: _lt_peak(st.params, st.opt, _lt_config("cuda", n),
                        trainer.opt_cfg, batch0) for n in LT_MEM_STEPS}
    lo, hi = LT_MEM_STEPS
    ratio = mali[hi] / mali[lo]
    require(ratio <= 1.05, f"lm_train (c): MALI's peak grows {ratio}x from "
            f"{lo} to {hi} steps")
    return {"mali_bytes": mali, "mali_ratio": ratio}


def _lt_memory_naive():
    """(c), Naive: the peak over one train_step on the 2-layer f32 cut at
    batch LT_NAIVE_MEM_BATCH, 2 and 8 ALF steps a branch (the optimizer
    state of the 151936-token vocabulary is most of the cut's weights, so
    the batch is what makes the stored steps count)."""
    import torch
    from repro_torch.models import init_lm
    from repro_torch.optim import OptimizerConfig, init_opt_state
    cut = _lt_config("reference", 2, "naive", LT_CUT_LAYERS, "float32")
    params = init_lm(torch.Generator(device="cuda").manual_seed(3), cut)
    opt_cfg = OptimizerConfig()
    opt = init_opt_state(opt_cfg, params)
    batch = _lt_batch(cut, LT_NAIVE_MEM_BATCH, LT_CUT_SEQ)
    naive = {n: _lt_peak(params, opt, _lt_config(
        "reference", n, "naive", LT_CUT_LAYERS, "float32"), opt_cfg, batch)
        for n in LT_MEM_STEPS}
    lo, hi = LT_MEM_STEPS
    ratio = naive[hi] / naive[lo]
    require(ratio > 2.0, f"lm_train (c): Naive's peak grows only {ratio}x "
            f"from {lo} to {hi} steps")
    return {"naive_bytes": naive, "naive_ratio": ratio,
            "naive_cut": {"layers": LT_CUT_LAYERS, "seq_len": LT_CUT_SEQ,
                          "batch": LT_NAIVE_MEM_BATCH, "dtype": "float32"}}


def _lt_kernel_vs_reference(params, batch0):
    """(b): one step's loss and gradients with backend="cuda" against
    backend="reference": at full width in bf16 (to max(LT_BF16_TOL, 3x the
    reference's one-rounding floor) per gradient leaf), and on the f32
    2-layer cut (LT_F32_TOL; MALI on cuda against Naive on the reference
    backend at GRAD_TOL)."""
    import torch
    from repro_torch.models import init_lm
    out = {}
    runs = {}
    for label, backend, p in (("cuda", "cuda", params),
                              ("reference", "reference", params),
                              ("reference_moved", "reference",
                               _moved(params, torch.bfloat16))):
        runs[label] = _lt_grads(p, _lt_config(backend), batch0)
    ref_loss, ref_stats, ref_g = runs["reference"]
    loss_err = _rel(runs["cuda"][0], ref_loss)
    loss_floor = _rel(runs["reference_moved"][0], ref_loss)
    require(loss_err <= max(LT_BF16_TOL, FLOOR_FACTOR * loss_floor),
            f"lm_train (b) bf16 loss: {loss_err} (floor {loss_floor})")
    require(runs["cuda"][1] == ref_stats, "lm_train (b): counters differ")
    worst = []
    for a, b, m in zip(runs["cuda"][2], ref_g, runs["reference_moved"][2]):
        err, floor = _rel(a, b), _rel(m, b)
        require(err <= max(LT_BF16_TOL, FLOOR_FACTOR * floor),
                f"lm_train (b) bf16 grad: {err} (floor {floor})")
        worst.append((err, floor))
    out["bf16_full_width"] = {
        "loss_rel": loss_err, "loss_floor": loss_floor,
        "grad_rel_max": max(e for e, _ in worst),
        "grad_floor_min": min(f for _, f in worst),
        "grad_leaves": len(worst)}
    del runs
    torch.cuda.empty_cache()

    cut = _lt_config("cuda", layers=LT_CUT_LAYERS, dtype="float32")
    p32 = init_lm(torch.Generator(device="cuda").manual_seed(2), cut)
    batch = _lt_batch(cut, LT_BATCH, LT_CUT_SEQ)
    got = {label: _lt_grads(p32, _lt_config(backend, 2, method,
                                            LT_CUT_LAYERS, "float32"), batch)
           for label, backend, method in (
               ("mali_cuda", "cuda", "mali"),
               ("mali_reference", "reference", "mali"),
               ("naive_reference", "reference", "naive"))}
    k_loss = _rel(got["mali_cuda"][0], got["mali_reference"][0])
    k_grad = max(_rel(a, b) for a, b in zip(got["mali_cuda"][2],
                                            got["mali_reference"][2]))
    require(k_loss <= LT_F32_TOL and k_grad <= LT_F32_TOL,
            f"lm_train (b) f32 kernel vs reference: loss {k_loss}, grads "
            f"{k_grad}")
    naive_excess = max(
        float(((a - b).abs() - GRAD_TOL["atol"]
               - GRAD_TOL["rtol"] * b.abs()).max())
        for a, b in zip(got["mali_cuda"][2], got["naive_reference"][2]))
    require(naive_excess <= 0.0, f"lm_train (b) f32 MALI vs Naive: "
            f"{naive_excess} beyond rtol/atol")
    require(got["mali_cuda"][1] == got["naive_reference"][1],
            "lm_train (b): MALI and Naive counters differ")
    out["f32_cut"] = {"layers": LT_CUT_LAYERS, "seq_len": LT_CUT_SEQ,
                      "kernel_vs_reference_loss": k_loss,
                      "kernel_vs_reference_grad": k_grad,
                      "mali_vs_naive_loss": _rel(
                          got["mali_cuda"][0], got["naive_reference"][0]),
                      "mali_vs_naive_grad": max(
                          _rel(a, b) for a, b in zip(
                              got["mali_cuda"][2],
                              got["naive_reference"][2])),
                      "mali_vs_naive_excess": naive_excess}
    return out


def _lt_smoke():
    """(d): the smoke configs one step each, kernel vs reference (f32),
    then the Trainer with a checkpoint every 2 steps and an injected
    failure at step 3: the resumed loss trace bit-equal to the clean
    one."""
    import tempfile

    import torch
    from repro_torch.models import init_lm
    from repro_torch.train import MemoryEmitter, Trainer, TrainerConfig
    out = {}
    for arch, batch, seq in LT_SMOKE:
        cfg = _lt_config("cuda", arch=arch, smoke=True)
        params = init_lm(torch.Generator(device="cuda").manual_seed(4), cfg)
        b = _lt_batch(cfg, batch, seq)
        k = _lt_grads(params, cfg, b)
        r = _lt_grads(params, _lt_config("reference", arch=arch, smoke=True),
                      b)
        loss = _rel(k[0], r[0])
        grad = max(_rel(x, y) for x, y in zip(k[2], r[2]))
        require(loss <= LT_F32_TOL and grad <= LT_F32_TOL and k[1] == r[1],
                f"lm_train (d) {arch}: loss {loss}, grads {grad}")
        fired = []

        def hook(step):
            if step == 3 and not fired:
                fired.append(step)
                raise RuntimeError("injected failure")

        traces = []
        with tempfile.TemporaryDirectory(dir=HERE / "build") as d:
            for label, kw in (("clean", {}),
                              ("faulty", dict(ckpt_dir=d, ckpt_every=2))):
                tc = TrainerConfig(arch=arch, steps=6, global_batch=4,
                                   seq_len=64, log_every=100, emit="memory",
                                   **kw)
                t = Trainer(tc, emitter=MemoryEmitter(),
                            step_hook=hook if kw else None)
                require(t.train() == 6, f"lm_train (d) {arch} {label}")
                traces.append(t.loss_trace())
        require(fired == [3] and traces[0] == traces[1],
                f"lm_train (d) {arch}: resumed trace {traces[1]} != clean "
                f"{traces[0]}")
        out[arch] = {"batch": batch, "seq_len": seq, "loss_rel": loss,
                     "grad_rel": grad, "fevals": k[1][2],
                     "trace": traces[0]}
    return out


def _lt_cli():
    """(e): the launcher at its defaults (qwen3 smoke, batch 8, S 64)."""
    import os
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--steps", "4"], cwd=str(HERE), env=env,
                         capture_output=True, text=True, timeout=300)
    require(res.returncode == 0 and "final_step=4" in res.stdout,
            f"lm_train (e): the CLI failed: {res.stdout[-2000:]}"
            f"{res.stderr[-2000:]}")
    rows = [json.loads(line) for line in res.stdout.splitlines()
            if line.startswith("{")]
    return {"cli_s": time.perf_counter() - t0,
            "losses": [r["loss"] for r in rows],
            "kernel_launches": rows[0]["kernel_launches"]}


def phase_lm_train(card: str, smi: str):
    """Phase 17: continuous-depth LM training on the card. (a) qwen3-1.7b
    at full width, 3 Trainer steps; no host sync in train_step and a
    device profile; (b) kernel vs reference; (c) memory; (d) the smoke
    configs and a resumed run; (e) the CLI. Returns the ALF launches of
    one step of (a) (the kernels line's launches_lm_train)."""
    import torch
    t0 = time.perf_counter()
    parts = {}

    def lap(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    trainer, batch0, per_step, full = _lt_full_width()
    lap("a_train")
    full.update(_lt_step_profile(trainer, batch0))
    lap("a_profile")
    memory = _lt_memory_mali(trainer, batch0)
    lap("c_memory_mali")
    params = trainer.state.params
    del trainer
    torch.cuda.empty_cache()
    compare = _lt_kernel_vs_reference(params, batch0)
    del params
    torch.cuda.empty_cache()
    lap("b_compare")
    memory.update(_lt_memory_naive())
    torch.cuda.empty_cache()
    lap("c_memory_naive")
    smoke = _lt_smoke()
    lap("d_smoke")
    cli = _lt_cli()
    lap("e_cli")
    emit({"phase": "lm_train", "card": card, "nvidia_smi": smi,
          "full_width": full, "compare": compare, "memory": memory,
          "smoke": smoke, "cli": cli, "part_s": parts,
          "phase_s": time.perf_counter() - t0})
    return per_step[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    card = torch.cuda.get_device_name(0)
    from repro_torch.kernels import PACKAGES, build
    t0 = time.perf_counter()
    build.build(PACKAGES)                      # one nvcc each, in parallel
    emit({"phase": "device", "card": card, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0})

    walls = {}
    last = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        walls[name] = now - last[0]
        last[0] = now

    worst, checks = phase_kernels()
    lap("kernels")
    row_worst, row_checks = phase_kernels_rows()
    lap("kernels_rows")
    times, row_times = phase_times(card)
    lap("times")
    launches, mali_losses = phase_main_path()
    lap("main_path")
    phase_adaptive()
    lap("adaptive")
    # Each kernel's launches come from the path that runs it; the two
    # VJP kernels' and alf_inverse's from the direct-backprop phase.
    # alf_inverse_update runs on no path (no caller in either package).
    direct = phase_direct_backprop(mali_losses)
    for name in (*VJPS, "alf_inverse"):
        launches[name] = direct[name]
    lap("direct_backprop")
    phase_memory()
    phase_profile()
    lap("memory_profile")
    lm_worst, lm_checks = phase_lm_kernels()
    lm_times = phase_lm_times(card)
    lap("lm_kernels_times")
    lm_launches = phase_lm_serve(card, smi)
    lap("lm_serve")
    ssm_launches = phase_ssm_serve(card, smi)
    lap("ssm_serve")
    backsolve_launches = phase_methods(card, smi)
    lap("methods")
    cnf_launches, cnf_sample_launches, trained, xs = phase_cnf(card, smi)
    lap("cnf")
    ps_launches = phase_per_sample(card, smi, trained, xs)
    lap("per_sample")
    serve_launches = phase_serve(card, smi)
    lap("serve")
    train_launches = phase_lm_train(card, smi)
    lap("lm_train")
    emit({"phase": "walls", "seconds": walls})

    table = []
    for name, (replaces, *_rest) in KERNELS.items():
        row = times[(name, SLICE_N)]
        rrow = row_times[(name, BIG_N)]
        table.append({"name": name, "route": "cuda", "source": SOURCE,
                      "replaces": replaces, "launches": launches[name],
                      # the ALF kernels' launches on the LM paths,
                      # beside their own path's
                      "launches_lm_serve": lm_launches[name],
                      "launches_ssm_serve": ssm_launches[name],
                      # and on Backsolve's path (phase 13)
                      "launches_backsolve": backsolve_launches[name],
                      # and on the CNF's (phase 14): 20 training steps at
                      # batch 1024, and one sample() call
                      "launches_cnf": cnf_launches[name],
                      "launches_cnf_sample": cnf_sample_launches[name],
                      "checks": checks[name],
                      "max_abs_err": worst[name], "ms": row["ms"],
                      "plain_ms": row["plain_ms"],
                      "bound_ms": row["bound_ms"],
                      "bound_by": row["bound_by"],
                      "library_ms": row["library_ms"],
                      # the per-row h instantiation (PerSample): at 2^25
                      # as 1024 rows, beside the scalar one in turns
                      "per_row_ms": rrow["per_row_ms"],
                      "per_row_graph_ms": rrow["per_row_graph_ms"],
                      "per_row_bound_ms": rrow["per_row_bound_ms"],
                      "per_row_scalar_ms": rrow["scalar_ms"],
                      "per_row_checks": row_checks[name],
                      "per_row_max_abs_err": row_worst[name],
                      # per-row launches on the PerSample paths (phase 15)
                      "launches_per_sample": ps_launches[name],
                      # on the serving engine's chunk lane (phase 16)
                      "launches_serve": serve_launches[name],
                      # per qwen3-1.7b training step (phase 17)
                      "launches_lm_train": train_launches[name]})
    for name, (replaces, source) in LM_KERNELS.items():
        row = lm_times[name]
        # each kernel's launches from its own path: the scan's from the
        # Jamba serve run, RMSNorm's and flash's from qwen3-1.7b's
        own = ssm_launches if name == "selective_scan" else lm_launches
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces,
                      "launches": own[name],
                      "launches_lm_serve": lm_launches[name],
                      "launches_ssm_serve": ssm_launches[name],
                      "launches_serve": serve_launches[name],
                      "launches_lm_train": train_launches[name],
                      "checks": lm_checks[name],
                      "max_abs_err": lm_worst[name]["bfloat16"],
                      "ms": row["ms"], "plain_ms": row["plain_ms"],
                      "bound_ms": row["bound_ms"],
                      # the MUFU's expf count as operations of their type
                      "bound_by": ("bytes" if row["bound_by"] == "bytes"
                                   else "operations"),
                      "bound_term": row["bound_by"],
                      "library_ms": row["library_ms"],
                      "graph_ms": row["graph_ms"],
                      "library_graph_ms": row.get("library_graph_ms")})
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
