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
               backward) must be exactly one launch. The seven kernels
               that move 16-byte vectors (alf_midpoint, alf_update,
               alf_midpoint_vjp, alf_bwd_pre, alf_bwd_post,
               alf_update_vjp, alf_inverse) also with each input 0-3
               elements past a 16-byte boundary, one input at a time and
               all together, and (through the C entry) the outputs 1-3
               past one, f32, bf16 and f64 at n = 1, 1500*128+37, 2048*64
               and 2^20+37, and with a per-row h at 3 x 37, 2048 x 64,
               8192 x 37 and 1024 x 1570; the C entries of the update,
               of bwd_post and of the inverse must refuse outputs at two
               phases.
3. times     — CUDA-event times of each kernel, its plain version and
               (where one exists) one library call, beside the bound, at
               the main path's shape and at n = 2^25, the forward pair
               also at the LM paths' f32 ALF states (qwen3-1.7b 2^23,
               Jamba 2^24), MALI's backward pair, alf_update_vjp and
               alf_inverse also at 2^24; a kernel with a library call is
               timed against it in turns (kernel, library, kernel,
               library); CUDA-graph times at 2048*64 and, for those six
               and the kernels with a library call, at every size; the
               vector kernels' registers a thread and
               resident blocks per SM. The host's cost per
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
8. (profile: cut, timing only; PERF.md cites its last runs)
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
               card's maximum SM clock). Flash also at the prefill shapes
               of stablelm-1.6b (d 64, MHA 32/32) and granite-20b (MQA
               48/1 at d 128), B4 S1024 causal, each held to its plain
               version first.
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
               memory and the device profile of 4 replays (those of a
               prefill and of 4 eager decode steps were cut to
               keep the script near 1000 s); a decode graph captured
               while a dead one waits in a reference cycle and the cyclic
               collector runs at every allocation (it must not free the
               dead graph inside the capture).
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
               whose decode step dropped none, peak memory and the
               device profile of 4 replays (as phase 11).
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
               full width), ms per step (from the counted run; its own
               timed run, a second round and the profiles were cut);
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
               no host. ms per step of the counted training runs (the
               timed runs on each backend, the profile and a second
               round were cut to keep the script near 1000 s).
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
               per trial (PerSample and Lockstep), ms per step (the
               profiled steps cut), the spread of accepted
               steps; (c)
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
               at --batch 1024 --d-state 784 --requests 2048
               --chunk-steps 32 (its mlp_field), both engines all at
               once: p50/p99, solves/s, occupancy, rounds, ms a
               round, peak memory, the device's busy share over 4 rounds,
               host syncs over 4 rounds, and the CLI at its defaults
               (in phase 23); (e)
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
               train_step, ms a step, peak memory, f-evals a step (the
               profiled step was cut); (b)
               one step's loss and gradients with backend="cuda" against
               "reference": at full width in bf16 within max(3e-2, 3x the
               reference's own one-rounding floor), on 2 of the 28 layers
               at S 1024 in f32 within 1e-5, and MALI (cuda) against
               Naive (reference) within rtol 2e-4 / atol 2e-5; (c) the
               peak memory of one train_step from 2 to 8 ALF steps: MALI
               at (a)'s shape, cut to 8 of the 28 layers for the
               script's time (fresh weights), <= 1.05x, Naive (2 layers,
               S 1024, f32,
               batch 8) > 2x; (d) the gemma2 (S 2304: window, softcaps
               and the FA2 backward), jamba and deepseek smoke configs one
               step each, kernel against reference within 1e-5 in f32,
               and a Trainer run with a checkpoint every 2 steps and a
               failure injected at step 3 whose resumed loss trace is
               bit-equal to the clean one; (e) python -m
               repro_torch.launch.train --steps 4 prints final_step=4
               (in phase 23).
18. xlstm     — xlstm-125m at full width, one of its two periods (6 of
               its 12 layers: 5 mLSTM, 1 sLSTM; d 768, 4 heads, vocab
               50304, bf16, DEFAULT_ODE, seeded weights; the cut keeps
               every check, and its host-bound token loops take half the
               time): (a) phase 11's checks at batch 4, prompt 1024,
               32 graphed decode steps (per prefill and per decode step
               19 RMSNorm, 12 + 12 ALF, no flash, no scan), the kernel
               path against backend="reference" in bf16 and f32 and
               prefill(64) against prefill(63) + decode (the chunk rule
               allows no 1025-token prompt), each within LM_TOL or 3x the
               model's own noise floor (the plain path with the embedding
               moved by one rounding), the device profile of 4
               replays; (b) phase 17's checks for 3 Trainer steps at
               batch 8 x 256 (12 launches of each of the four MALI
               kernels and 18 f-evals a step; kernel vs reference in bf16
               at full width and in f32 at S 128, MALI vs Naive there;
               MALI's peak 2 -> 8 steps) and the bytes one mLSTM f-eval
               VJP holds between its forward and pullback; (c) python -m
               repro_torch.launch.serve and .train --arch xlstm-125m
               --full (both periods) for a few tokens and steps (in phase
               23).
19. gemma2_serve — gemma2-2b at full width (26 layers, d 2304, d_head 256,
               vocab 256000, tied embeddings, bf16): phase 11's checks at
               batch 4, prompt 1024, 32 graphed decode steps (per prefill
               78 flash at d 256, 157 RMSNorm, 104 + 104 ALF), one prompt
               past the 4096-token window (batch 1, 4608 tokens, 8 decode
               steps: kernel vs plain within LM_TOL, the flash launches
               and their share of the prefill's device time), and the
               flash kernel timed at its prefill shape (d 256, softcap
               50) against its bound and plain version.
20. dp_train  — data-parallel training (repro_torch.distributed.
               data_parallel) over two ranks that share the card: two
               processes, gloo through a FileStore, every collective
               staged through the host. (a) qwen3-1.7b at full width,
               cut to DP_LAYERS (8) of its 28 layers for the script's
               time (bf16, pure DP: ZeRO-1 optimizer state), global batch
               4 x 1024, 3 Trainer steps: loss, lr and grad norm a step
               against a one-rank Trainer on the same global batch
               (LT_BF16_TOL; in f32, cut to 2 layers at S 256, LT_F32_TOL),
               parameters bit-equal on the ranks after every step, 32
               launches of each MALI kernel a step on each rank, a rank's
               optimizer bytes <= 0.55x the one rank's, the collectives
               and their bytes and host seconds a step by kind, the
               peaks, the step times, the last step profiled on both
               ranks (their busy times add: the processes time-share the
               card); (b) qwen3's smoke config made pure DP
               with a 1024-token vocabulary (ZeRO-1 shards the embedding
               and head): the host syncs of a step by line (only the
               collectives' stagings), a failure at step 2 on both ranks
               resumes to
               the clean trace bit for bit, a one-rank checkpoint restores
               on two ranks and a two-rank one on one rank with equal
               states; (c) deepseek-moe's smoke config (fsdp_tp, capacity
               factor 0.5): each rank's kept masks equal its block of a
               one-rank forward's on the global batch, with drops, and
               under ode.batch_axis="data" a one-rank forward's on its
               own rows; (d) python -m torch.distributed.run
               --nproc-per-node 2 -m repro_torch.launch.train --steps 3
               --device cuda:0 prints final_step=3 once (in phase 23);
               (e) one adaptive controller over the two ranks
               (ode_steps=0, no ode_batch_axis: each trial's error norm
               summed over the ranks): qwen3-1.7b at full width, 2 of 28
               layers, f32, 2 x 256 tokens a rank, one Trainer step
               against one rank on the global batch (loss and grad norm
               within DP_TOL["float32"]), accepted and rejected trials
               equal block by block, parameters bit-equal on the ranks,
               one error_norm@data reduction a trial.
21. configs_serve — the four configs that fit one card and no earlier
               phase serves, at full width, one at a time (each one's
               weights freed before the next): stablelm-1.6b (d_head 64),
               musicgen-large (input_mode="embeds": prompts from the stub
               frontend, models/frontend.py, and decode through the
               embeds path), deepseek-moe-16b (a dense prelude layer, 27
               MoE layers of 64 experts, top 6, 2 shared) and granite-20b
               (MQA 48/1, d 6144, 52 layers; 56.3 GB of weights). For each:
               the weights and cache predicted from the meta specs
               (launch/specs.py) before anything is made, the prediction
               within 0.9 of the card at init's bound; phase 11's checks
               (_serve_cell: exact launch counts per prefill and decode
               step, CS_PER_PREFILL, no host sync, the graph against eager
               decode and serve(), the device profile of 4 replays); the
               weights equal to the specs' bytes, init's
               peak within them plus its largest draw (_cs_predict), the
               serve run's peak within the specs'
               weights and cache plus one prefill's allocations and
               CS_PEAK_SLACK; graphed decode against the step's byte
               bound (the blocks' weights once per f-eval, the head once,
               every cache slot once, over the card's memory rate); the
               kernel path against backend="reference" in bf16 (LM_TOL;
               deepseek route-aware, as phase 12) and in f32 at batch 2 x
               256 + 4 (2 layers: for stablelm and musicgen to keep
               the script near 1000 s; for granite, whose f32 RMSNorm
               at d 6144 takes the scalar kernel, and deepseek, which
               do not fit in f32; deepseek's
               f32 cut also with a capacity that drops nothing, where
               prefill(p + 1) must equal prefill(p) + decode on every
               row); the phase's seconds beside its CS_PHASE_S budget.
22. tp_train  — tensor parallelism over 'model' and FSDP over 'data'
               (repro_torch.distributed.tensor_parallel, data_parallel)
               on ranks that share the card (gloo through a FileStore,
               every collective staged through the host), each held to a
               one-rank run in this process first. (a) granite-20b at
               full width cut to 2 of its 52 layers (d 6144, MQA 48/1,
               d_ff 24576, vocab 49152, bf16, 1.66 B parameters) on four
               ranks, a (data 2, model 2) mesh, global batch 2 x 1024,
               MALI with ConstantSteps(2) on ALF(cuda), two chained
               train_steps with AdamW: loss, lr and grad norm a step
               within LT_BF16_TOL, every leaf's block bit-equal on the
               ranks that hold it, the ODE end states bit-equal on each
               'model' pair, each ALF kernel's launches a step equal to
               one rank's, a rank's parameter and optimizer bytes equal
               to the rules' reckoning from launch/specs.py to the byte
               and <= 0.30x one rank's, its peak below one rank's,
               FSDP's gathers (each split leaf once a layer forward, at
               most once backward), the collectives a step by kind and
               axis with their bytes and host seconds, the step times;
               (b) deepseek-moe-16b's prelude and 1 MoE layer at full
               width in f32 on (data 1, model 2), 32 of the 64 experts a
               rank, a capacity that drops nothing: every token's route
               (its experts and whether each was kept) in every MoE call
               equal to one rank's, loss and grad norm within
               LT_F32_TOL; (c) python -m torch.distributed.run
               --nproc-per-node 2 -m repro_torch.launch.train --arch
               deepseek-moe-16b --smoke --steps 3 --device cuda:0 prints
               final_step=3 once (in phase 23); the phase's seconds
               beside TP_PHASE_S. (a) also reads each rank's allocator
               at the step's edges and where its forward, backward and
               update end: nothing beyond its shards and the
               workspaces stays after a step, the peaks within bounds
               reckoned from its shards and the config.
23. clis      — (with phase 25's two helper processes beside them)
               the launchers of phases 16 (d), 17 (e), 18 (c), 20 (d)
               and 22 (c), and the serve launcher under python -m
               torch.distributed.run --nproc-per-node 2 (deepseek-moe's
               smoke config on two ranks of the card, the host mesh
               (2, 1): one report, from rank 0, its decode eager), seven
               processes
               started together (host-bound smoke runs: one after
               another they took 120-165 s), each held to its phase's
               check.
24. tp_serve  — LM serving on the JAX package's meshes
               (models/lm.py prefill and decode_step under a mesh,
               data_parallel.ServePlan) on ranks that share the card
               (gloo through a FileStore), each part held to one rank
               serving the same cut in this process first, the ranks
               teacher-forced on its greedy tokens (each group of rank
               processes, (b), (c) and (d) in the same two, starts while
               the work before it runs): (a) granite-20b, 2
               of 52 layers, bf16, on (data 2, model 2), batch 4 x 1024
               + 16 decode steps (FSDP, the rows over 'data', MQA's
               cache split on d_head over 'model', the head split on
               the vocabulary); (b) jamba-v0.1-52b, one period of a
               Mamba+MoE layer and an attention layer, f32, on (1, 2),
               batch 2 x 512 + 8 (the scan on d_inner 4096 a rank, 8 of
               16 experts a rank, the KV heads over 'model'); (c)
               qwen3-1.7b, 8 of 28 layers, bf16, batch 1 on (2, 1), 1024
               + 8 (the KV sequence over 'data': split-KV decode); (d)
               xlstm-125m, one mLSTM and the sLSTM layer, f32, on (1, 2),
               batch 3 x 64 + 4 (every LSTM cache split over 'model' on
               the heads, the mixers computed whole: a decode f-eval
               gathers its slot's state; greedy tokens equal). Each:
               logits within LM_TOL (bf16) or TPS_F32_TOL / 3x the
               model's one-rounding floor (f32), equal on every rank,
               greedy agreement counted; every MoE route equal; a rank's
               parameter and cache bytes equal to launch/specs.py's
               serve_shard_bytes, its allocator after prefill within
               them plus TP_RESIDENT_SLACK, init's peak within its
               shards plus one whole leaf's draw (drawn leaf by leaf);
               the LM kernels' launches a step equal to one rank's; the
               collectives and FSDP gathers a step equal to
               _tps_reckon's; the ALF states bit-equal on the ranks of
               one row block; a decode graph over the gloo ranks
               refused; flash at each rank's heads and the scan at its
               d_inner against their plain versions; prefill and eager
               decode ms beside one rank's; the phase's seconds beside
               TPS_PHASE_S.
25. examples  — the paper's experiments as the port's own entry points:
               each module of repro_torch.examples run on the card
               through its main(), ALF on "cuda", every launch count set
               to 0 just before a run and read just after (the kernels
               line's launches_examples); the two host-bound runs that
               would take most of the time (the latent ODE's adjoint and
               cnf_toy) in helper processes (chip_smoke.py --example,
               counting alike) that start with phase 23's CLIs and that
               phase 23 waits for, the rest in this process. quickstart
               whole:
               dL/dalpha of the four methods within 1e-5 of the port on
               the CPU, MALI against Naive within 1e-6, the counters
               (steps, f-evals, Lockstep's rows) equal the CPU's, the
               event fired, PerSample's rows on both (the stiffest row's
               float32 step-size power differs between the devices) and
               the same PerSample solve under ReproducibleController
               equal on both, the allocator's peak over a
               forward + backward from 8 to 64 steps <= 1.05x for MALI
               and > 2x for Naive; image_recognition at its 400 steps:
               every test accuracy (resnet, node, the five invariance
               solvers) >= 0.98, 4 + 4 forward and 4 + 4 backward
               launches a node step plus the forward-only evaluations;
               time_series_latent_ode, each of its four methods at 20
               steps: the loss falls, its ALF launches a step equal the
               accepted steps of the same rollout on the CPU (its Stats),
               MALI's first-step gradient on the kernels against Naive's
               on the reference backend within rtol 2e-4 / atol 2e-5, the
               test extrapolation MSE; cnf_toy at 150 steps and
               cnf_image at its defaults (each asserts its own result:
               the fine NLL below the Gaussian baseline, bits/dim
               falling); lm_continuous_depth at 6 steps (the recovered
               loss trace bit-equal to the clean one; the serve). Each
               example's ms a step (host clock ending in a sync) and
               wall; the phase's seconds beside EX_PHASE_S.
26. roofline  — the roofline of four steps earlier phases time: phase
               4's Sec 4.2 MALI step, phase 11's qwen3-1.7b prefill and
               eager decode step, phase 17 (a)'s qwen3-1.7b training
               step, each counted on the meta device (launch/cost.py:
               every aten op, each kernel op by its declared work) by a
               helper process (chip_smoke.py --roofline-meta, no card)
               that runs beside phases 2-7: FLOPs (bf16 part), bytes,
               the bound at the card's rates (launch/roofline.py), the
               measured time, roofline_share = bound / measured (must be
               <= RL_SHARE_MAX) and, for the LM steps, mfu = model FLOPs
               / (measured x the bf16 rate). The prefill and the eager
               decode step are also counted on the card in phase 11,
               the kernels launching, and must equal their meta counts.

Phase 22 runs (b)'s two rank processes beside (a)'s four. Phase 2 also
holds the eight kernels with a per-row (B,) h, each row
its own (kernels_rows: B x D in ROW_CASES, f32, bf16, mixed, f64, one
launch of the per-row instantiation a call), and phase 3 times each
per-row instantiation beside its scalar one in turns at 2^25 (1024
rows) and 1024 x 1570 (times_rows).

Every phase runs on every call. The line before the last is the kernel
table; the last line is ``{"ok": true, "device": {...}}``. Any failed
check raises.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"
if not (SRC / "repro_torch").is_dir():
    sys.exit(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
             "from a checkout of the repository")
sys.path.insert(0, str(SRC))
# The paper's experiments are the port's own examples: the Sec 4.2
# model's widths, data and field, and the image CNF's settings.
from repro_torch.examples import cnf_image  # noqa: E402
from repro_torch.examples.image_recognition import (  # noqa: E402
    D, HIDDEN, N_CLASS, field, make_data)
# (memory bytes/s, f32 FLOP/s, bf16 tensor-core FLOP/s) by card name: the
# table the kernel bounds and the roofline both read
from repro_torch.launch.roofline import card_rates  # noqa: E402

N_TRAIN, TRAIN_STEPS, LR, N_SUB = 2048, 20, 3e-3, 4
SLICE_N = N_TRAIN * D                   # the main path's state: 2048 x 64
BIG_N = 1 << 25
TAIL_N = 1500 * 128 + 37
# Above one resident wave of threads (132 SMs x 2048): the vector
# kernels take 16-byte vectors here, one element a thread below
WAVE_N = (1 << 20) + 37
# The f32 ALF state of the LM paths' prefill (batch 4 x 1024 tokens x
# d_model): qwen3-1.7b and jamba-v0.1-52b
QWEN_ALF_N, JAMBA_ALF_N = 4 * 1024 * 2048, 4 * 1024 * 4096
# Backsolve's augmented state (z, a, {w1, b1, w2, b2}) on the main path,
# packed into one buffer by the ALF ops: 270,464 f32
BACKSOLVE_AUG_N = 2 * SLICE_N + 2 * D * HIDDEN + HIDDEN + D
# The image CNF (phase 14; examples/cnf_image.py) at the example's
# default batch and at a real state; its augmented state (z, logdet,
# kinetic, probe), packed into one buffer: 25,120 and 1,607,680 f32
CNF_DIM, CNF_BATCHES = cnf_image.DIM, (cnf_image.BATCH, 1024)
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
TIME_PAIRS = 3
NAIVE_TIME_PAIRS = 2
UNFUSED_STEPS = 3

TPU_SRC = "src/repro/kernels/alf_step/alf_step.py"
# name: (TPU kernel replaced, packed inputs); each kernel's bound is the
# work its op declares (kernels/alf_step/ops.py: alf_work, ALF_WORK)
KERNELS = {
    "alf_midpoint": (f"{TPU_SRC}:43", 2),
    "alf_update": (f"{TPU_SRC}:50", 3),
    "alf_bwd_pre": (f"{TPU_SRC}:107", 4),
    "alf_bwd_post": (f"{TPU_SRC}:118", 6),
    "alf_midpoint_vjp": (f"{TPU_SRC}:91", 1),
    "alf_update_vjp": (f"{TPU_SRC}:97", 2),
    "alf_inverse": (f"{TPU_SRC}:75", 3),
    "alf_inverse_update": (f"{TPU_SRC}:61", 3),
}
VJPS = ("alf_midpoint_vjp", "alf_update_vjp")
FORWARD = ("alf_midpoint", "alf_update")
# timed at JAMBA_ALF_N and in a CUDA graph at every size beside the
# forward pair: MALI's backward pair, the update's reverse rule and psi^-1
GRAPHED = ("alf_bwd_pre", "alf_bwd_post", "alf_update_vjp", "alf_inverse")
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
# phase 10 also times flash at these configs' prefill shapes (batch
# LM_BATCH, prompt LM_PROMPT, causal): d 64, MHA 32/32; MQA 48/1 at d 128
FA_MORE_ARCHS = ("stablelm-1.6b", "granite-20b")
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
# least this share of tokens must be compared at Jamba's
# LAYER_ROUTE_DECISIONS routing decisions a token takes in a layer (top 2
# x 3 f-evals), the same bar per decision at another count: share >=
# LAYER_TOKEN_SHARE ** (decisions / LAYER_ROUTE_DECISIONS)
LAYER_TOKEN_SHARE = 0.9
LAYER_ROUTE_DECISIONS = 6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def _bound(work, bw: float, peak: float):
    """(bound ms, "bytes" or "operations") of a kernel op's declared work
    (``kernels.Work``) at the memory rate ``bw`` and the FLOP rate
    ``peak`` of its class."""
    bytes_ms, ops_ms = work.bytes / bw * 1e3, work.flops / peak * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


# ---------------------------------------------------------------------------
# The paper's Sec 4.2 model (repro_torch.examples.image_recognition)
# ---------------------------------------------------------------------------

def _data_np(n: int, seed: int):
    """The Sec 4.2 example's images and labels, as host numpy."""
    x, y = make_data(n, seed, device="cpu")
    return x.numpy(), y.numpy()


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
    for name, (_, n_in) in KERNELS.items():
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
    for name, (_, n_in) in KERNELS.items():
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
    # The seven vector kernels (16-byte vectors): each input on a 16-byte
    # boundary and 1, 2 and 3 elements past one, one input at a time and
    # all together (an input off the outputs' phase is read element by
    # element, or by vectors again for f64 at 2; for the backward pair and
    # alf_inverse by the general instantiation); the outputs fresh
    # (on a boundary) and, through the library's C entry, 1-3 elements
    # past one (their head written element by element); f32, bf16 and f64
    # at n = 1, TAIL_N, the main path's size (below one wave of threads:
    # one element a thread) and WAVE_N (vectors, a tail of whole
    # elements), and with a per-row h at 3 x 37 and 2048 x 64 (one
    # element a thread), 8192 x 37 and the CNF's 1024 x 1570 (vectors,
    # some of which straddle rows)
    vec_kernels = {
        # name: (launcher, inputs, outputs, plain version, keyword, values)
        "alf_midpoint": (alf_step.midpoint_call, 2, 1, ref.midpoint_ref,
                         "sign", (-1.0,)),
        "alf_update": (alf_step.update_call, 3, 2, ref.update_ref, "eta",
                       (0.9,)),
        "alf_midpoint_vjp": (alf_step.midpoint_vjp_call, 1, 1,
                             ref.midpoint_vjp_ref, "sign", (-1.0,)),
        "alf_bwd_pre": (alf_step.bwd_pre_call, 4, 2, ref.bwd_pre_ref, "eta",
                        (0.9,)),
        # eta 1.0 takes the exact branch of psi^-1's velocity
        "alf_bwd_post": (alf_step.bwd_post_call, 6, 4, ref.bwd_post_ref,
                         "eta", (1.0, 0.9)),
        "alf_update_vjp": (alf_step.update_vjp_call, 2, 2,
                           ref.update_vjp_ref, "eta", (0.9,)),
        "alf_inverse": (alf_step.inverse_call, 3, 2, ref.inverse_ref, "eta",
                        (1.0, 0.9)),
    }
    for name, (launcher, n_in, n_out, plain, key, values) in (
            vec_kernels.items()):
        patterns = [(0,) * n_in]
        for off in (1, 2, 3):
            patterns += [tuple(off if i == j else 0 for i in range(n_in))
                         for j in range(n_in)]
            if n_in > 1:
                patterns.append((off,) * n_in)
        for dtype in (torch.float32, torch.bfloat16, torch.float64):
            hd = h.to(torch.promote_types(dtype, torch.float32))
            # (n, h, row length): the scalar h at four sizes, and a
            # per-row h over 3 and 8192 rows of 37 (rows end inside
            # vectors), the main path's 2048 x 64 and the CNF's
            # 1024 x 1570, each row its own h
            cases = [(n, hd, 0) for n in (1, TAIL_N, SLICE_N, WAVE_N)]
            for b, d in ((3, 37), (N_TRAIN, D), (8192, 37),
                         (1024, CNF_ROW)):
                h_rows = (torch.rand(b, device="cuda", generator=gen)
                          - 0.5) * 0.8
                cases.append((b * d, h_rows.to(hd.dtype), d))
            for (n, hh, row), offs, p in itertools.product(
                    cases, patterns, values):
                ins = [torch.randn(n + 3, device="cuda", generator=gen)
                       .to(dtype)[o:o + n] for o in offs]
                want = ops._plain(plain, hh, *ins, param=p)
                want = [w.double() for w in (
                    want if isinstance(want, tuple) else (want,))]
                tols = [KERNEL_ULPS * _ulp(dtype) * w.abs().max().clamp(
                    min=1.0) for w in want]
                # each output's max error over its tolerance, on the card:
                # one host read for the four output placements
                ratios = []
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
                    for g, w, tol in zip(got, want, tols):
                        ratios.append((g.double() - w).abs().max() / tol)
                    checks[name] += 1
                worst_ratio = float(torch.stack(ratios).max())
                require(worst_ratio <= 1.0, f"{name} {dtype} n={n} row {row} "
                        f"{key} {p} input offsets {offs}, outputs fresh and "
                        f"at offsets 1-3: max abs err {worst_ratio} x the "
                        "tolerance")
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
    # and alf_bwd_post's four, the last at another phase
    rc = alf_step._fn("alf_bwd_post")(
        0, SLICE_N, *[x.data_ptr()] * 6, h.data_ptr(), 0, 0.9,
        *[buf[4:].data_ptr()] * 3, buf[5:].data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    require(rc == 716, f"alf_bwd_post: outputs at two 16-byte phases gave "
            f"{rc}, expected 716 (cudaErrorMisalignedAddress)")
    checks["alf_bwd_post"] += 1
    # and alf_inverse's two
    rc = alf_step._fn("alf_inverse")(
        0, SLICE_N, *[x.data_ptr()] * 3, h.data_ptr(), 0, 0.9,
        buf[4:].data_ptr(), buf[5:].data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    require(rc == 716, f"alf_inverse: outputs at two 16-byte phases gave "
            f"{rc}, expected 716 (cudaErrorMisalignedAddress)")
    checks["alf_inverse"] += 1
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


def _alternate(kernel, plain, reps, plain_reps=None):
    """kernel, plain, kernel, plain — each time the mean of its two runs
    (the plain version over ``plain_reps`` calls a run, if given)."""
    plain_reps = reps if plain_reps is None else plain_reps
    k1 = _time_ms(kernel, reps)
    p1 = _time_ms(plain, plain_reps)
    k2 = _time_ms(kernel, reps)
    p2 = _time_ms(plain, plain_reps)
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
    from repro_torch.kernels.alf_step.ops import alf_work
    gen = torch.Generator(device="cuda").manual_seed(2)
    h = torch.tensor(0.23, device="cuda")
    out = {}
    for b, d, reps in ((1024, BIG_N // 1024, 20), (1024, CNF_ROW, 200)):
        n = b * d
        bufs = [torch.randn(n, device="cuda", generator=gen)
                for _ in range(6)]
        h_rows = 0.1 + 0.2 * torch.rand(b, device="cuda", generator=gen)
        scalar, per_row = _kernel_calls(bufs, h), _kernel_calls(bufs, h_rows)
        for name in KERNELS:
            ms, row_ms = _alternate(scalar[name][0], per_row[name][0], reps)
            row = {"name": name, "rows": b, "row_len": d, "n": n,
                   "scalar_ms": ms, "per_row_ms": row_ms,
                   "per_row_to_scalar": row_ms / ms,
                   "scalar_graph_ms": _graph_ms(scalar[name][0], reps),
                   "per_row_graph_ms": _graph_ms(per_row[name][0], reps),
                   "per_row_bound_ms": _bound(
                       alf_work(name, bufs[0], h_rows), bw, peak)[0]}
            emit({"phase": "times_rows", **row})
            out[(name, n)] = row
        del bufs
        torch.cuda.empty_cache()
    return out


def phase_times(card: str):
    import torch
    from repro_torch.kernels.alf_step import alf_step
    from repro_torch.kernels.alf_step.ops import ALF_WORK, alf_work
    bw, peak, _ = card_rates(card)
    gen = torch.Generator(device="cuda").manual_seed(1)
    h = torch.tensor(0.23, device="cuda")
    rows = {}
    # every kernel at the main path's size and at 2^25; the forward pair
    # also at the LM paths' ALF state sizes and GRAPHED at Jamba's
    # (qwen3's training state, 2 x 4096 x 2048, has as many elements),
    # with graph times at each
    sizes = ((SLICE_N, 500, tuple(KERNELS)),
             (QWEN_ALF_N, 40, FORWARD),
             (JAMBA_ALF_N, 30, FORWARD + GRAPHED),
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
            ms, plain_ms = _alternate(kern, plain, reps)
            bound_ms, bound_by = _bound(alf_work(name, bufs[0], h), bw, peak)
            label, lib = library.get(
                name, (NO_LIBRARY.format(ALF_WORK[name][1]), None))
            row = {"name": name, "n": n, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None, "library": label}
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
            elif lib is not None or name in FORWARD + GRAPHED:
                row["graph_ms"] = _graph_ms(kern, reps)
                if lib is not None:
                    row["library_graph_ms"] = _graph_ms(lib, reps)
            emit({"phase": "times", **row})
            rows[(name, n)] = row
        del bufs
        torch.cuda.empty_cache()
    emit({"phase": "times", "op_host_cost_slice": _op_host_cost(h)})
    # registers a thread, spilled bytes and resident blocks per SM of the
    # vector kernels' all-aligned scalar-h instantiations
    info = {name: {str(dt).split(".")[-1]: alf_step.vec_kernel_info(name, dt)
                   for dt in (torch.float32, torch.bfloat16, torch.float64)}
            for name in alf_step.VEC_KERNELS}
    emit({"phase": "times", "vec_kernel_info": info})
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

    x_np, y_np = _data_np(N_TRAIN, seed=0)
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
    return launches, losses, float(np.median(step_ms["cuda"]))


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
    x_np, _ = _data_np(N_TRAIN, seed=0)
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
    x_np, y_np = _data_np(N_TRAIN, seed=0)
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
    x_np, _ = _data_np((1 << 20) // D, seed=2)
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
    their plain versions and one library call; flash also at
    FA_MORE_ARCHS' prefill shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm import ref as rn_ref
    from repro_torch.kernels.rmsnorm import rmsnorm as rn_k
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_work
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
        bound_ms, bound_by = _bound(rmsnorm_work(x, scale), bw, f32_peak)
        rows[label] = {
            "name": label, "shape": [n, d], "dtype": "bfloat16",
            "ms": ms, "plain_ms": plain_ms, "library_ms": _time_ms(lib, 200),
            "library": "torch.nn.functional.rms_norm",
            "graph_ms": _graph_ms(kern, 100),
            "plain_graph_ms": _graph_ms(plain, 100),
            "library_graph_ms": _graph_ms(lib, 100),
            "bound_ms": bound_ms, "bound_by": bound_by}
        emit({"phase": "lm_times", **rows[label]})
        del x
    rows["flash_attention"] = _flash_times(
        rand, bw, bf16_peak, LM_BATCH, LM_PROMPT, cfg.n_heads,
        cfg.n_kv_heads, cfg.d_head)
    emit({"phase": "lm_times", **rows["flash_attention"]})
    # the prefill shapes of configs_serve's configs that no earlier row
    # has: d 64 (stablelm-1.6b; musicgen-large's is the same) and MQA,
    # 48 query heads over one KV head (granite-20b)
    for arch in FA_MORE_ARCHS:
        c = get_config(arch)
        label = f"flash_attention_{arch}"
        rows[label] = {**_flash_times(rand, bw, bf16_peak, LM_BATCH,
                                      LM_PROMPT, c.n_heads, c.n_kv_heads,
                                      c.d_head), "name": label, "arch": arch}
        emit({"phase": "lm_times", **rows[label]})
    rows["selective_scan"] = _scan_times(gen, bw, f32_peak)
    emit({"phase": "lm_times", **rows["selective_scan"]})
    return rows


def _flash_times(rand, bw: float, bf16_peak: float, b: int, s: int,
                 h: int, kv: int, d: int):
    """The bf16 flash kernel at one causal prefill shape against its
    plain version (within FA_TOL), its bound and SDPA (causal, GQA; held
    to FA_LIB_TOL), each also in a CUDA graph."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fa_k
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention_work
    q, k, v = rand(b, s, h, d), rand(b, s, kv, d), rand(b, s, kv, d)
    # the library's own [B, H, S, d] layout, made outside the timed call
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kern = lambda: fa_k.flash_attention_call(q, k, v, causal=True)  # noqa
    plain = lambda: fa_ref.attention_ref(q, k, v, causal=True)      # noqa
    lib = lambda: F.scaled_dot_product_attention(                   # noqa
        qt, kt, vt, is_causal=True, enable_gqa=True)
    _close(kern(), plain(), *FA_TOL["bfloat16"],
           f"flash at B{b} S{s} H{h}/{kv} d{d} against the plain version")
    # the yardstick computes the same function
    _close(lib().transpose(1, 2), plain(), *FA_LIB_TOL,
           "scaled_dot_product_attention against the plain version")
    ms, plain_ms = _alternate(kern, plain, 10)
    # the op's declared work: 4 d operations for each unmasked (query,
    # key) pair and head, q, k, v read and the output written once
    work = flash_attention_work(q, k, True, 0)
    bound_ms, bound_by = _bound(work, bw, bf16_peak)
    fa = {"name": "flash_attention", "shape": [b, s, h, kv, d],
          "dtype": "bfloat16", "ms": ms, "plain_ms": plain_ms,
          "library_ms": _time_ms(lib, 10),
          "library": "scaled_dot_product_attention(is_causal=True, "
                     "enable_gqa=True)",
          "graph_ms": _graph_ms(kern, 10),
          "plain_graph_ms": _graph_ms(plain, 5),
          "library_graph_ms": _graph_ms(lib, 10),
          "flops": work.flops, "bytes": work.bytes,
          "bound_ms": bound_ms, "bound_by": bound_by}
    # useful operations (the masked half of the scores not counted) per
    # second of device time
    fa["tflops_per_s"] = fa["flops"] / fa["graph_ms"] / 1e9
    fa["library_tflops_per_s"] = fa["flops"] / fa["library_graph_ms"] / 1e9
    fa["graph_to_bound"] = fa["graph_ms"] / fa["bound_ms"]
    return fa


def _scan_times(gen, bw: float, f32_peak: float):
    """The scan kernel at Jamba's prefill shape with the model's dtypes
    (delta f32, u/B/C bf16, A and h0 f32) against its bound and its plain
    version (a Python loop over S)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_scan import mamba_scan as ms_k
    from repro_torch.kernels.mamba_scan import ref as ms_ref
    from repro_torch.kernels.mamba_scan.ops import selective_scan_work
    cfg = get_config(SSM_ARCH)
    bt, s = SSM_BATCH, SSM_PROMPT
    di, st = cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state
    delta, u, a, b, c = _scan_inputs(gen, bt, s, di, st, torch.bfloat16,
                                     torch.float32)
    h0 = torch.zeros(bt, di, st, device="cuda")
    kern = lambda: ms_k.selective_scan_call(delta, u, a, b, c, h0)  # noqa
    plain = lambda: ms_ref.selective_scan_ref(delta, u, a, b, c, h0)  # noqa
    # the plain version (~130-190 ms a call) over one call a run
    ms, plain_ms = _alternate(kern, plain, 4, plain_reps=1)
    n = bt * s * di
    # the op's declared work: each input read once, each output written
    # once; 7 f32 operations per (b, t, i, s) and 1 per (b, t, i)
    work = selective_scan_work(delta, u, a, b, c)
    moved, ops = work.bytes, work.flops
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


def _lm_inputs(cfg, batch: int, n: int, seed: int):
    """``n`` seeded input positions for ``batch`` rows: token ids [B, n]
    from numpy, or for an input_mode="embeds" config the stub frontend's
    frame embeddings [B, n, d_model] (``models.frontend``). A slice of the
    sequence axis is a prefill's or a decode step's input."""
    import torch
    from repro_torch.models.frontend import synthetic_frame_embeddings
    if cfg.input_mode == "embeds":
        return synthetic_frame_embeddings(
            torch.Generator(device="cuda").manual_seed(seed), cfg, batch, n)
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, n)), device="cuda")


def _prompt(cfg, x) -> dict:
    """A prefill batch of ``_lm_inputs``."""
    return {"embeds" if cfg.input_mode == "embeds" else "tokens": x}


def _serve_run(params, cfg, toks, prompt: int, n_decode: int,
               backend: str):
    """prefill + n_decode teacher-forced decode steps (``toks``: token ids
    or embeddings, ``_lm_inputs``): (logits [B, 1 + n, V], the MoE routes
    of every call, prefill ms, decode ms per step)."""
    import torch
    from repro_torch.models import decode_step, init_serve_state, prefill
    from repro_torch.models.moe import recording_routes
    state = init_serve_state(cfg, toks.shape[0], prompt + n_decode)
    with recording_routes() as log:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, state = prefill(params, cfg, _prompt(cfg, toks[:, :prompt]),
                            state, backend=backend)
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


def _lm_compare(dtype, batch: int, prompt: int, n_decode: int,
                arch: str = LM_ARCH, self_prompt: int = 0,
                floor: bool = False, periods: int = 0, period=None):
    """``arch`` at full width in ``dtype``: the kernel path against the
    plain path (prefill logits and teacher-forced decode logits), and
    prefill(p+1) against prefill(p) + decode(token p), on both paths, p =
    ``self_prompt`` (default: ``prompt``). With ``floor``, a comparison
    may also lie within FLOOR_FACTOR x the model's own noise floor: the
    plain path with the embedding moved by one rounding (``_moved``)
    against the plain path. ``periods`` cuts the depth (0: as published),
    to periods of ``period`` (None: its own). An input_mode="embeds" config is fed the stub frontend's embeddings
    (``_lm_inputs``)."""
    import dataclasses
    import torch
    from repro_torch.configs import DEFAULT_ODE, get_config
    from repro_torch.models import init_lm, init_serve_state, prefill
    name = str(dtype).split(".")[-1]
    cfg = get_config(arch, DEFAULT_ODE)
    cfg = dataclasses.replace(cfg, param_dtype=name, compute_dtype=name,
                              n_periods=periods or cfg.n_periods,
                              period=period or cfg.period)
    params = init_lm(torch.Generator(device="cuda").manual_seed(1), cfg)
    toks = _lm_inputs(cfg, batch, prompt + n_decode, 1)
    p = self_prompt or prompt
    out, logits = {}, {}
    runs = [("cuda", "cuda", params), ("reference", "reference", params)]
    if floor:
        runs.append(("moved", "reference", _moved(params, dtype)))
    for label, backend, w in runs:
        logits[label], _, pre_ms, dec_ms = _serve_run(
            w, cfg, toks, prompt, n_decode, backend)
        out[f"prefill_ms_{label}"] = pre_ms
        out[f"decode_ms_per_step_{label}"] = dec_ms
        if label == "moved":
            continue
        # prefill over p + 1 tokens: its last logits are those of decode
        # step 0 after prefill(p) (the token at position p fed)
        decoded = (logits[label] if p == prompt else _serve_run(
            w, cfg, toks, p, 1, backend)[0])[:, 1]
        lg1, _ = prefill(w, cfg, _prompt(cfg, toks[:, :p + 1]),
                         init_serve_state(cfg, batch, p + 1),
                         backend=backend)
        out[f"self_consistency_{label}"] = _rel(lg1[:, 0], decoded)
    out["kernel_vs_plain_prefill"] = _rel(logits["cuda"][:, 0],
                                          logits["reference"][:, 0])
    out["kernel_vs_plain_decode"] = _rel(logits["cuda"][:, 1:],
                                         logits["reference"][:, 1:])
    out["greedy_agreement"] = float(
        (logits["cuda"].argmax(-1) == logits["reference"].argmax(-1))
        .float().mean())
    tol = LM_TOL[name]
    if floor:
        out["floor_prefill"] = _rel(logits["moved"][:, 0],
                                    logits["reference"][:, 0])
        out["floor_decode"] = _rel(logits["moved"][:, 1:],
                                   logits["reference"][:, 1:])
        tol = max(tol, FLOOR_FACTOR * max(out["floor_prefill"],
                                          out["floor_decode"]))
    for key in ("kernel_vs_plain_prefill", "kernel_vs_plain_decode",
                "self_consistency_cuda", "self_consistency_reference"):
        require(out[key] <= tol, f"lm {arch} {name} {key}: {out[key]} > "
                f"{tol}")
    require(all(bool(torch.isfinite(t).all()) for t in logits.values()),
            f"lm {arch} {name}: non-finite logits")
    del params
    torch.cuda.empty_cache()
    return {"arch": arch, "dtype": name, "n_layers": cfg.n_layers,
            "batch": batch, "prompt": prompt, "self_prompt": p,
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
    Returns the graph step and its state, for more replays (``toks``:
    ``_lm_inputs`` of prompt + 8 positions; 4 are used)."""
    import torch
    from repro_torch.launch.serve import make_decode_step
    from repro_torch.models import decode_step, init_serve_state, prefill
    state = init_serve_state(cfg, toks.shape[0], prompt + 8)
    step = make_decode_step(cfg)
    torch.cuda.synchronize()
    _lm_reset()
    _, state = _no_sync(lambda: prefill(params, cfg,
                                        _prompt(cfg, toks[:, :prompt]),
                                        state))
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


def _capture_beside_a_dead_graph(params, cfg, toks, prompt: int) -> dict:
    """make_decode_step's capture while a dead DecodeGraph (captured)
    waits in a reference cycle that only the cyclic collector frees, and
    that collector is set, from the capture's start, to run at every
    allocation: the capture must not free the dead graph (a CUDA graph
    freed inside another capture ends it with an error) and the captured
    step's logits are finite."""
    import gc
    import torch
    from repro_torch.launch.serve import DecodeGraph, make_decode_step
    from repro_torch.models import init_serve_state, prefill
    begin, threshold = torch.cuda.CUDAGraph.capture_begin, gc.get_threshold()
    dead = []

    def first_call(step):
        state = init_serve_state(cfg, toks.shape[0], prompt + 2)
        _, state = prefill(params, cfg, _prompt(cfg, toks[:, :prompt]),
                           state)
        return step(params, toks[:, prompt:prompt + 1], state)

    def capture_begin(graph, *args, **kwargs):
        begin(graph, *args, **kwargs)
        box = [dead.pop()]
        box.append(box)
        del box
        gc.set_threshold(1)

    old = DecodeGraph(cfg)
    first_call(old)
    require(old.graph is not None, "lm_serve: the dead graph was not "
            "captured")
    dead.append(old)
    del old
    step = make_decode_step(cfg)
    torch.cuda.CUDAGraph.capture_begin = capture_begin
    try:
        logits, _ = first_call(step)
    finally:
        torch.cuda.CUDAGraph.capture_begin = begin
        gc.set_threshold(*threshold)
    gc.collect()
    torch.cuda.synchronize()
    require(step.graphed and not dead, "lm_serve: the decode step did not "
            "capture beside the dead graph")
    require(bool(torch.isfinite(logits).all()), "lm_serve: non-finite "
            "logits from the step captured beside a dead graph")
    return {"captured": True, "collector_threshold_in_capture": 1}


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
    from repro_torch.launch.serve import decode_input, make_decode_step
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
                lg, box["state"] = step(params, decode_input(cfg, box["tok"]),
                                        box["state"])
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
    from repro_torch.models import init_lm
    kw = dict(smoke=False, ode=True, prompt_len=LM_PROMPT,
              batch=LM_BATCH, seed=0)
    # (a warm-up serve, for the timings alone, was cut)
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
    # with no host sync; the graph against eager decode; 4 replays
    # profiled
    cfg = get_config(LM_ARCH, DEFAULT_ODE)
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT + 8)), device="cuda")
    step, gstate = _counted_steps(params, cfg, toks, LM_PROMPT,
                                  LM_PER_PREFILL, LM_PER_DECODE, "qwen3")
    # phase 26's prefill and eager decode step, counted on the card
    card_counts = _rl_card_counts(params, cfg, toks)

    def replay4():
        st = gstate
        for i in range(LM_PROMPT + 3, LM_PROMPT + 7):
            _, st = step(params, toks[:, i:i + 1], st)

    prof_replay = _kernel_profile(replay4)
    graph = _graph_vs_eager(params, cfg, serve_prompt(
        cfg, LM_BATCH, LM_PROMPT, 0, "cuda"), LM_DECODE, result.tokens,
        prof_replay["device_busy_ms"] / 4)
    del step, gstate
    dead_graph = _capture_beside_a_dead_graph(params, cfg, toks, LM_PROMPT)
    del params
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
          "capture_beside_a_dead_graph": dead_graph,
          "profile_decode_4_replays": prof_replay,
          "compare": compare})
    return launches, {"qwen3_prefill": result.prefill_ms,
                      "qwen3_decode": graph["eager_ms_per_step"],
                      "card_counts": card_counts}


# ---------------------------------------------------------------------------
# Phase 12: the Jamba/SSM serving slice (jamba-v0.1-52b, 2 of 4 periods)
# ---------------------------------------------------------------------------

def _ssm_config(dtype_name: str = "bfloat16", periods: int = SSM_PERIODS,
                arch: str = SSM_ARCH, **changes):
    """``arch`` (jamba-v0.1-52b) at its published widths under
    DEFAULT_ODE, cut to ``periods`` of its periods (and ``changes``)."""
    import dataclasses
    from repro_torch.configs import DEFAULT_ODE, get_config
    return dataclasses.replace(get_config(arch, DEFAULT_ODE), **changes,
                               n_periods=periods, param_dtype=dtype_name,
                               compute_dtype=dtype_name)


def _route_differs(ra, rb):
    """Per (token, choice) of one MoE call, whether two runs' routes
    differ: the token's experts (as a set) or whether each choice was
    kept or dropped at its expert's capacity. With capacity binding, a
    flip elsewhere moves a token's rank in its expert, so a token whose
    experts agree may be kept in one run and dropped in the other."""
    ia, oa = ra.idx.sort(-1)
    ib, ob = rb.idx.sort(-1)
    return (ia != ib) | (ra.kept.gather(-1, oa) != rb.kept.gather(-1, ob))


def _same_routes(a, b, batch: int):
    """Two runs' MoE routes (moe.Routes, call by call; the tokens of a call
    in batch-major order): the count of (token, choice) routes that differ
    (``_route_differs``), the count compared, and per batch row whether
    every route of the row agreed."""
    import torch
    require(len(a) == len(b), f"routes: {len(a)} vs {len(b)} MoE calls")
    agree = torch.ones(batch, dtype=torch.bool, device="cuda")
    differ, total = 0, 0
    for ra, rb in zip(a, b):
        require(ra.idx.shape == rb.idx.shape, "routes: shapes differ")
        d = _route_differs(ra, rb)
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
    plain path, on the tokens whose MoE routes (``_route_differs``) agree
    in every f-eval of the layer. Returns one [period ("prelude" for the
    prelude's layers),
    index, mixer, mlp, rel, share of tokens compared, share of routes
    differing] row per layer."""
    import torch
    import torch.utils._pytree as pytree
    from repro_torch.models import transformer
    from repro_torch.models.moe import recording_routes
    batch = toks.shape[0]
    x = params["embed"][toks[:, :prompt]]
    pos = torch.arange(prompt, dtype=torch.int32,
                       device="cuda")[None].expand(batch, prompt)
    layers = [("prelude", j, spec, params["blocks"]["prelude"][j])
              for j, spec in enumerate(cfg.prelude)]
    for p in range(cfg.n_periods):
        pp = pytree.tree_map(lambda a: a[p], params["blocks"]["period"])
        layers += [(p, j, spec, pp[f"sub{j}"])
                   for j, spec in enumerate(cfg.period)]
    rows = []
    for p, j, spec, lp in layers:
        ys, logs = {}, {}
        for backend in ("cuda", "reference"):
            cache = transformer.init_layer_cache(cfg, spec, batch, prompt,
                                                 "cuda")
            with recording_routes() as log:
                ys[backend], _ = transformer.layer_serve(
                    lp, cfg, spec, x, cache, pos, "prefill", backend)
            logs[backend] = list(log)
        same = torch.ones(batch * prompt, dtype=torch.bool, device="cuda")
        differ, total = 0, 0
        for a, b in zip(logs["cuda"], logs["reference"]):
            d = _route_differs(a, b)
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
                 n_decode: int, arch: str = SSM_ARCH,
                 consistent_rows=None, **changes):
    """``arch`` (jamba-v0.1-52b; any MoE config) at full width,
    ``periods`` periods, in ``dtype``:

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
    cfg = _ssm_config(name, periods, arch, **changes)
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
        dropped, prefill_dropped = 0, 0
        for p_r, d_r, l_r in zip(log[:per_call], log[per_call:2 * per_call],
                                 longer):
            k = p_r.idx.shape[-1]
            lidx = l_r.idx.reshape(batch, prompt + 1, k).sort(-1).values
            pidx = p_r.idx.reshape(batch, prompt, k).sort(-1).values
            didx = d_r.idx.reshape(batch, k).sort(-1).values
            ok &= (lidx[:, :prompt] == pidx).all(-1).all(-1)
            ok &= (lidx[:, prompt] == didx).all(-1)
            # the prompt's tokens kept or dropped alike in both prefills
            ok &= ~(_route_differs(
                type(p_r)(l_r.idx.reshape(batch, prompt + 1, k)[:, :prompt],
                          l_r.kept.reshape(batch, prompt + 1, k)[:, :prompt]),
                type(p_r)(p_r.idx.reshape(batch, prompt, k),
                          p_r.kept.reshape(batch, prompt, k)))
                    .any(-1).any(-1))
            ok &= d_r.kept.reshape(batch, k).all(-1)
            dropped += int((~d_r.kept).sum())
            prefill_dropped += int((~p_r.kept).sum())
        ok = ok.cpu()
        out[f"self_consistency_{backend}"] = _rows_rel(
            lg1[:, 0], logits[backend][:, 1], ok)
        out[f"self_consistency_rows_{backend}"] = int(ok.sum())
        out[f"self_consistency_all_rows_{backend}"] = _rel(
            lg1[:, 0], logits[backend][:, 1])
        out[f"decode_step0_dropped_routes_{backend}"] = dropped
        out[f"prefill_dropped_routes_{backend}"] = prefill_dropped

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
    decisions = cfg.moe_top_k * (cfg.ode.n_steps + 1)
    out["layer_token_share_bar"] = LAYER_TOKEN_SHARE ** (
        decisions / LAYER_ROUTE_DECISIONS)
    for _, _, _, _, err, share, _ in out["layers"]:
        require(err <= tol and share >= out["layer_token_share_bar"],
                f"ssm {name} layer by layer: {out['layers']}")
    if name == "float32":
        # no route may flip, and prefill(p + 1) = prefill(p) + decode on
        # ``consistent_rows`` rows (None: all of them)
        rows_want = batch if consistent_rows is None else consistent_rows
        require(differ == 0 and out["self_consistency_rows_cuda"] >= rows_want
                and out["self_consistency_rows_reference"] >= rows_want,
                f"ssm {arch} {name}: {differ} routes differ, or fewer than "
                f"{rows_want} rows prefill(p + 1) = prefill(p) + decode: "
                f"{out['self_consistency_rows_cuda']} / "
                f"{out['self_consistency_rows_reference']} (prefill drops "
                f"{out['prefill_dropped_routes_cuda']}, decode drops "
                f"{out['decode_step0_dropped_routes_cuda']})")
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
    return {"arch": arch, "dtype": name, "periods": periods,
            "n_layers": cfg.n_layers, "changes": changes,
            "consistent_rows_required": (batch if consistent_rows is None
                                         else consistent_rows),
            "batch": batch, "prompt": prompt,
            "decode_steps": n_decode, "tolerance": tol,
            "floor_factor": FLOOR_FACTOR, **out}


def phase_ssm_serve(card: str, smi: str):
    """The port's serve() for jamba-v0.1-52b at full width (2 of 4
    periods) on the card."""
    import torch
    import torch.utils._pytree as pytree
    from repro_torch.launch.serve import serve, serve_prompt
    from repro_torch.models import init_lm
    cfg = _ssm_config()
    kw = dict(ode=True, prompt_len=SSM_PROMPT, batch=SSM_BATCH, seed=0)
    # (a warm-up serve, for the timings alone, was cut)
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

    def replay4():
        st = gstate
        for i in range(SSM_PROMPT + 3, SSM_PROMPT + 7):
            _, st = step(params, toks[:, i:i + 1], st)

    prof_replay = _kernel_profile(replay4)
    graph = _graph_vs_eager(params, cfg, serve_prompt(
        cfg, SSM_BATCH, SSM_PROMPT, 0, "cuda"), SSM_DECODE, result.tokens,
        prof_replay["device_busy_ms"] / 4)
    del params, step, gstate
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
    plain versions; ms per step, from the counted run."""
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
        counts, (losses, wall) = _counted(
            f"odeint({label})",
            lambda: _train(x, y, None, None, loss_fn=loss_fn), TRAIN_STEPS,
            per)
        require(all(np.isfinite(losses)), f"{label}: non-finite losses")
        require(losses[-1] < losses[0],
                f"{label}: loss did not fall: {losses[0]} -> {losses[-1]}")
        launches[label] = counts
        out[label] = {"first_loss": losses[0], "last_loss": losses[-1],
                      # the counted run's ms a step (a timed run of its
                      # own was cut)
                      "step_ms": wall / TRAIN_STEPS * 1e3}
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
    x_np, _ = _data_np((1 << 20) // D, seed=2)
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
    t0 = time.perf_counter()
    parts = {}

    def lap(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    torch.cuda.empty_cache()
    x_np, y_np = _data_np(N_TRAIN, seed=0)
    x = torch.as_tensor(x_np, device="cuda")
    y = torch.as_tensor(y_np, device="cuda")
    thm21 = _thm21()
    lap("a_thm21")
    with warnings.catch_warnings():
        # odeint() is the legacy facade and says so on every call
        warnings.simplefilter("ignore", DeprecationWarning)
        runs, launches, first_grads = _method_runs(x, y)
    lap("b_runs")
    peaks, growth = _method_memory()
    lap("c_memory")
    bounds, agree = _method_bounds(x_np)
    lap("d_bounds")
    emit({"phase": "methods", "card": card, "nvidia_smi": smi,
          "part_s": parts,
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

# repro_torch.examples.cnf_image's settings; CNF_DIM above
CNF_HIDDEN, CNF_DEPTH = cnf_image.HIDDEN, cnf_image.DEPTH
CNF_STEPS, CNF_N_SUB = cnf_image.STEPS, cnf_image.N_STEPS
CNF_LR, CNF_KINETIC = cnf_image.LR, cnf_image.KINETIC_REG
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
    """CNF_STEPS dequantized image batches on the card, as the example
    draws them."""
    from repro_torch.data import DataConfig
    dcfg = DataConfig(seed=0, global_batch=batch)
    rng = np.random.default_rng(0)
    return [cnf_image.dequantized_batch(dcfg, step, rng, "cuda")
            for step in range(CNF_STEPS)]


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
    t0 = time.perf_counter()
    parts = {}

    def lap(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

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
    lap("a_train_compare")
    peaks, growth = _cnf_memory(xs_by_batch[CNF_BATCHES[-1]][0])
    lap("b_memory")
    sample_launches, sample = _cnf_sample(_cnf_params())
    lap("c_sample")
    events = _events()
    lap("d_events")
    # the times are the counted runs' (first_run_step_ms): the timed runs
    # on each backend were cut
    emit({"phase": "cnf", "card": card, "nvidia_smi": smi, "part_s": parts,
          "model": f"examples/cnf_image.py: DIM {CNF_DIM}, mlp_vfield "
          f"hidden {CNF_HIDDEN} depth {CNF_DEPTH}, Hutchinson, ALF(eta=1, "
          f"cuda), ConstantSteps({CNF_N_SUB}), MALI, cnf_loss(kinetic_reg="
          f"{CNF_KINETIC}), Adam {CNF_LR}, Lockstep",
          "steps": CNF_STEPS,
          "packed_state_elements": dict(zip(CNF_BATCHES, CNF_PACKED_N)),
          **out, "peak_bytes_batch_1024": peaks, **growth,
          "sample": sample, "sample_launches": {
              k: v for k, v in sample_launches.items() if v},
          "events": events})
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
    and Lockstep), ms per training step, the spread of accepted steps
    over rows."""
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
    accf = acc.double()
    return {"loss": float(l_k), "kernel_vs_reference_rel": rel,
            "rows_vs_single_rel": row_rel, "trials": trials,
            "step_ms": step_ms,
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
# (2048 requests, two of the 1024 slots' worth: the trace cut from 4096
# for the script's time; the checks are a round's)
SV_FULL = dict(batch=1024, d_state=784, n_requests=2048, chunk_steps=32)
SV_PROFILED = 4                   # rounds sync-counted


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
    memory and (b)'s 8 rows), 4 sync-counted rounds, no sync inside a
    chunk. (The CLI at its defaults runs in phase_clis.)"""
    import contextlib
    import io

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

    # Four sync-counted rounds (no sync inside a chunk: dispatch_chunk
    # under set_sync_debug_mode("error")).
    eng = _sv_full_engine()
    eng.scheduler.release(0.0)
    eng._backfill()
    _sv_rounds(eng, 1)
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

    return out, launches


def _sv_cli(res) -> dict:
    """(d), run by phase_clis: the CLI at its defaults, as users call it
    (the card by default)."""
    require(res.returncode == 0, f"serve (d): the CLI exited "
            f"{res.returncode}: {res.stderr[-2000:]}")
    require("serve[continuous]" in res.stdout
            and "256 completed" in res.stdout and "device=cuda" in
            res.stdout, f"serve (d): CLI output {res.stdout[-2000:]}")
    return {"stdout": res.stdout.strip().splitlines(), "wall_s": res.s}


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
# f32), 3 Trainer steps; one more step profiled (phases 17 and 18; a
# second one was cut to keep the script near 1000 s)
LT_BATCH, LT_SEQ, LT_STEPS = 2, 4096, 3
# per step: 28 layers x 2 branches x 2 ALF steps, one launch of each
# kernel a step forward (midpoint, update) and backward (bwd_pre, bwd_post)
LT_PER_STEP = {"alf_midpoint": 112, "alf_update": 112, "alf_bwd_pre": 112,
               "alf_bwd_post": 112}
# (b), (c): the 2-of-28-layer cuts, S 1024, f32
LT_CUT_LAYERS, LT_CUT_SEQ = 2, 1024
LT_BF16_TOL = 3e-2            # bf16 kernel vs reference (or 3x the floor)
LT_F32_TOL = 1e-5             # f32 kernel vs reference, relative
LT_MEM_STEPS = (2, 8)
# (c), MALI: qwen3-1.7b at (a)'s shape cut to 8 of its 28 layers (a
# depth cut for the script's time; the ALF state a branch keeps is the
# same at any depth)
LT_MEM_LAYERS = 8
LT_NAIVE_MEM_BATCH = 8        # Naive's activations must outweigh the state
# (d): smoke configs, one step each, f32; gemma2 past the direct limit
LT_SMOKE = (("gemma2-2b", 2, 2304), ("jamba-v0.1-52b", 2, 64),
            ("deepseek-moe-16b", 2, 64))


def _lt_config(backend: str = "cuda", n_steps: int = 2,
               method: str = "mali", layers: int = 0, dtype: str = "",
               arch: str = LM_ARCH, smoke: bool = False, period=None):
    """``arch`` with every residual branch an ALF solve (``method``,
    ConstantSteps(n_steps), ``backend``), optionally cut to ``layers``
    periods of ``period`` (None: its own) and cast to ``dtype``."""
    import dataclasses
    from repro_torch.configs import OdeSettings, get_config, smoke_config
    ode = OdeSettings(mode="per_block", method=method, solver="alf",
                      n_steps=n_steps, backend=backend)
    cfg = (smoke_config if smoke else get_config)(arch, ode)
    changes = {}
    if layers:
        changes["n_periods"] = layers
    if period:
        changes["period"] = period
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


def _lt_full_width(arch: str = LM_ARCH, batch: int = LT_BATCH,
                   seq: int = LT_SEQ, per_step_want: dict = LT_PER_STEP,
                   periods: int = 0, period=None):
    """(a): LT_STEPS Trainer steps of ``arch`` at full width (cut to
    ``periods`` periods of ``period``, None: its own; 0: every one), each
    launching exactly
    ``per_step_want``; returns (the trainer, batch 0, per-step launches,
    the results)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm_loss
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import MemoryEmitter, Trainer, TrainerConfig
    tc = TrainerConfig(arch=arch, smoke=False, steps=LT_STEPS,
                       global_batch=batch, seq_len=seq,
                       log_every=100, emit="memory")
    full = get_config(arch)
    periods = periods or full.n_periods
    # the Trainer's own config (``train.trainer.build``), cut
    cut = dataclasses.replace(get_config(arch, tc.ode_settings()),
                              n_periods=periods,
                              period=period or full.period)
    snaps = []
    # the optimizer's own defaults (warmup over 100 steps): the rule the
    # Trainer derives from 3 steps warms up over 1, and at this width the
    # loss on batch 0 then ends above where it started (PERF.md)
    trainer = Trainer(tc, emitter=MemoryEmitter(),
                      step_hook=lambda step: snaps.append(
                          _lm_counts()[0]),
                      opt_cfg=OptimizerConfig(), model_cfg=cut)
    require(trainer.cfg.ode.backend == "cuda"
            and trainer.cfg.d_model == full.d_model
            and trainer.cfg.n_periods == periods,
            f"{arch} training: not the full config at {periods} periods")
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
            want = per_step_want.get(name, 0)
            require(n == want, f"{arch} training step {i}: {name} launched "
                    f"{n} times, expected {want}")
    _, calls = _lm_counts()
    for name in per_step_want:
        require(calls[name] == LT_STEPS * per_step_want[name],
                f"{arch} training: {name} op calls {calls[name]}")
    recs = [trainer.records[s] for s in range(LT_STEPS)]
    require(all(np.isfinite(r.loss) for r in recs),
            f"lm_train: non-finite loss {[r.loss for r in recs]}")
    batch0 = trainer.batch(0)
    with torch.no_grad():
        after = float(lm_loss(trainer.state.params, trainer.cfg, batch0))
    require(np.isfinite(after) and after < recs[0].loss,
            f"lm_train: loss on batch 0 {recs[0].loss} -> {after}")
    return trainer, batch0, per_step, {
        "config": {"arch": arch, "d_model": trainer.cfg.d_model,
                   "layers": trainer.cfg.n_layers,
                   "vocab": trainer.cfg.vocab_size, "dtype": "bfloat16",
                   "batch": batch, "seq_len": seq,
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


def _kernel_profile(run, top: int = 8, of: str = ""):
    """torch.profiler with device activity only over ``run()``, read from
    the raw kineto events: the device's busy and idle share, the top
    device operations and, with ``of``, the device time and count of the
    kernels whose name holds it. (The profiler's Python event tree
    takes minutes at a training step's ~10^5 kernels and ~10^6 host
    ops.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _profile_summary(prof, wall_ms, top, of)


def _profile_summary(prof, wall_ms: float, top: int = 8, of: str = ""):
    """:func:`_kernel_profile`'s reading of a finished profiler."""
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
    out = {"wall_ms": wall_ms, "device_busy_ms": busy / 1e6,
           "device_window_ms": window / 1e6,
           "idle_share": 1.0 - busy / window, "device_launches": len(dev),
           "top_device_ms": [[name[:60], ns / 1e6, n]
                             for name, (ns, n) in ranked]}
    if of:
        hits = [v for name, v in by_name.items() if of in name]
        ns = sum(v[0] for v in hits)
        out[of] = {"device_ms": ns / 1e6, "kernels": sum(v[1] for v in hits),
                   "share_of_busy": ns / busy}
    return out


def _lt_no_sync_step(trainer, batch0):
    """No host sync in train_step. (The device profile of a step that
    followed it was cut to keep the script near 1000 s: a
    timing-only part; PERF.md cites the last profiles by their runs.)"""
    from repro_torch.train import train_step
    st = trainer.state

    def step():
        # from the trained state, its result dropped at once: two states
        # beside it would not fit with its activations
        train_step(st.params, st.opt, None, batch0, cfg=trainer.cfg,
                   opt_cfg=trainer.opt_cfg)

    _, syncs, where = _count_syncs(step)
    require(syncs == 0, f"lm_train: train_step synced the host {syncs} "
            f"times: {where}")
    return {"host_syncs_in_train_step": syncs}


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


def _lt_memory_mali(trainer, batch0, layers: int = 0):
    """(c), MALI: the peak over one train_step at (a)'s shape, 2 and 8
    ALF steps a branch, on seeded weights and a fresh optimizer state of
    ``trainer``'s config cut to ``layers`` periods (0: as it is)."""
    import torch
    from repro_torch.models import init_lm
    from repro_torch.optim import init_opt_state
    arch = trainer.cfg.name
    layers = layers or trainer.cfg.n_periods
    period = trainer.cfg.period
    params = init_lm(torch.Generator(device="cuda").manual_seed(3),
                     _lt_config("cuda", layers=layers, arch=arch,
                                period=period))
    opt = init_opt_state(trainer.opt_cfg, params)
    mali = {n: _lt_peak(params, opt, _lt_config(
        "cuda", n, layers=layers, arch=arch, period=period),
        trainer.opt_cfg, batch0) for n in LT_MEM_STEPS}
    lo, hi = LT_MEM_STEPS
    ratio = mali[hi] / mali[lo]
    require(ratio <= 1.05, f"{arch} training (c): MALI's peak grows "
            f"{ratio}x from {lo} to {hi} steps")
    return {"mali_bytes": mali, "mali_ratio": ratio, "mali_layers": layers}


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


def _lt_kernel_vs_reference(params, batch0, arch: str = LM_ARCH,
                            cut_layers: int = LT_CUT_LAYERS,
                            cut_seq: int = LT_CUT_SEQ,
                            cut_batch: int = LT_BATCH, periods: int = 0,
                            period=None):
    """(b): one step's loss and gradients with backend="cuda" against
    backend="reference": at full width in bf16 (``periods`` periods of
    ``period``, None: its own; 0: every one; to max(LT_BF16_TOL, 3x the
    reference's one-rounding floor)
    per gradient leaf), and on the f32 cut to ``cut_layers`` periods at
    ``cut_seq`` tokens (LT_F32_TOL; MALI on cuda against Naive on the
    reference backend at GRAD_TOL)."""
    import torch
    from repro_torch.models import init_lm
    out = {}
    runs = {}
    for label, backend, p in (("cuda", "cuda", params),
                              ("reference", "reference", params),
                              ("reference_moved", "reference",
                               _moved(params, torch.bfloat16))):
        runs[label] = _lt_grads(p, _lt_config(backend, layers=periods,
                                              arch=arch, period=period),
                                batch0)
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

    cut = _lt_config("cuda", layers=cut_layers, dtype="float32", arch=arch,
                     period=period)
    p32 = init_lm(torch.Generator(device="cuda").manual_seed(2), cut)
    batch = _lt_batch(cut, cut_batch, cut_seq)
    got = {label: _lt_grads(p32, _lt_config(backend, 2, method, cut_layers,
                                            "float32", arch, period=period),
                            batch)
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
    out["f32_cut"] = {"periods": cut_layers, "seq_len": cut_seq,
                      "batch": cut_batch,
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


def _lt_cli(res) -> dict:
    """(e), run by phase_clis: the launcher at its defaults (qwen3 smoke,
    batch 8, S 64)."""
    require(res.returncode == 0 and "final_step=4" in res.stdout,
            f"lm_train (e): the CLI failed: {res.stdout[-2000:]}"
            f"{res.stderr[-2000:]}")
    rows = [json.loads(line) for line in res.stdout.splitlines()
            if line.startswith("{")]
    return {"cli_s": res.s, "losses": [r["loss"] for r in rows],
            "kernel_launches": rows[0]["kernel_launches"]}


def phase_lm_train(card: str, smi: str):
    """Phase 17: continuous-depth LM training on the card. (a) qwen3-1.7b
    at full width, 3 Trainer steps; no host sync in train_step; (b)
    kernel vs reference; (c) memory; (d) the smoke
    configs and a resumed run; (e) the CLI (phase_clis). Returns the ALF
    launches of one step of (a) (the kernels line's
    launches_lm_train)."""
    import torch
    t0 = time.perf_counter()
    parts = {}

    def lap(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    trainer, batch0, per_step, full = _lt_full_width()
    lap("a_train")
    full.update(_lt_no_sync_step(trainer, batch0))
    lap("a_no_sync")
    memory = _lt_memory_mali(trainer, batch0, LT_MEM_LAYERS)
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
    emit({"phase": "lm_train", "card": card, "nvidia_smi": smi,
          "full_width": full, "compare": compare, "memory": memory,
          "smoke": smoke, "part_s": parts,
          "phase_s": time.perf_counter() - t0})
    # the steps after the first (which loads and warms up)
    return per_step[0], min(full["step_ms"][1:])


# ---------------------------------------------------------------------------
# Phases 18-19: xlstm-125m served and trained, gemma2-2b served (full width)
# ---------------------------------------------------------------------------

XL_ARCH = "xlstm-125m"
# (a) and (b) run one period of one mLSTM and the sLSTM layer (2 of its 12
# layers; its own period is 5 mLSTM + 1 sLSTM) at full width: the token
# loops are host-bound and scale with the layers, and the cut keeps both
# mixer kinds (from one whole period when phase 20 (f) was added)
XL_PERIODS = 1


def _xl_period():
    """(a) and (b)'s period: one mLSTM layer, then the sLSTM one."""
    from repro_torch.configs.base import LayerSpec
    return (LayerSpec(mixer="mlstm", mlp="none"),
            LayerSpec(mixer="slstm", mlp="none"))


# per prefill and per decode step under DEFAULT_ODE (3 f-evals per
# residual branch, no MLP branch): 2 layers x 3 mixer norms + the final
# norm; 2 layers x 2 ALF steps, one midpoint and one update each
XL_PER_PREFILL = {"rmsnorm": 7, "alf_midpoint": 4, "alf_update": 4}
XL_PER_DECODE = XL_PER_PREFILL
# prefill(p) + decode against prefill(p + 1): the chunk rule allows p < 64
# or a multiple of 64 only, so p = 63 (p + 1 = one 64-token chunk)
XL_SELF_PROMPT = 63
# (b): 3 Trainer steps at batch 8 x 256; per step 2 layers x 2 ALF steps
# of each kernel forward and backward, 6 f-evals
XL_TRAIN_BATCH, XL_TRAIN_SEQ, XL_FEVALS = 8, 256, 6
XL_PER_STEP = {"alf_midpoint": 4, "alf_update": 4, "alf_bwd_pre": 4,
               "alf_bwd_post": 4}
XL_CUT_PERIODS, XL_CUT_SEQ = 1, 128      # (b) f32: one period, 2 layers
GM_ARCH = "gemma2-2b"
# per prefill: 26 layers x 3 flash calls (d 256); 26 layers x 2 branches x
# 3 norms + the final norm; 26 layers x 2 branches x 2 ALF steps
GM_PER_PREFILL = {"flash_attention": 78, "rmsnorm": 157,
                  "alf_midpoint": 104, "alf_update": 104}
GM_PER_DECODE = {"flash_attention": 0, "rmsnorm": 157, "alf_midpoint": 104,
                 "alf_update": 104}
# one prompt past the local layers' 4096-token window, batch 1
GM_LONG_PROMPT, GM_LONG_DECODE = 4608, 8


def _serve_cell(arch, per_prefill: dict, per_decode: dict, what: str):
    """Phase 11's checks for ``arch`` (an arch name, served at full width,
    or a ModelConfig served as given: a depth cut) in bf16 under
    DEFAULT_ODE at batch LM_BATCH, prompt LM_PROMPT and LM_DECODE graphed
    decode steps: exact launch counts, no host sync, the graph against
    eager decode and serve(), peak memory, init's peak beside the weights
    it made, the bytes one prefill allocates beyond the weights and its
    state, and the device profile of 4 replays from the raw kineto events
    (the graph check reads its busy time). An input_mode="embeds" config
    prefills the stub
    frontend's embeddings and decodes through the embeds path. Returns
    (the serve run's launches, the phase's fields, the weights)."""
    import torch
    import torch.utils._pytree as pytree
    from repro_torch.configs import DEFAULT_ODE, ModelConfig, get_config
    from repro_torch.launch.serve import serve, serve_prompt
    from repro_torch.models import init_lm, init_serve_state, prefill
    cfg = (arch.with_ode(DEFAULT_ODE) if isinstance(arch, ModelConfig)
           else get_config(arch, DEFAULT_ODE))
    kw = dict(smoke=False, ode=True, batch=LM_BATCH, seed=0,
              prompt_len=LM_PROMPT)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    serve_base = torch.cuda.memory_allocated()
    _lm_reset()
    result = serve(arch, decode_tokens=LM_DECODE, **kw)
    launches = _lm_check_counts(
        f"{what} (one prefill + {LM_DECODE} decode steps: one eager, one "
        "captured, replays)", per_decode, 2, plus=per_prefill)
    peak = torch.cuda.max_memory_allocated()
    require(result.tokens.shape == (LM_BATCH, LM_DECODE)
            and int(result.tokens.min()) >= 0, f"{what}: tokens")
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
    toks = _lm_inputs(cfg, LM_BATCH, LM_PROMPT + 8, 0)
    step, gstate = _counted_steps(params, cfg, toks, LM_PROMPT,
                                  per_prefill, per_decode, what)
    state = init_serve_state(cfg, LM_BATCH, LM_PROMPT + 8)
    # the bytes a prefill allocates beyond the weights and its state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    prefill(params, cfg, _prompt(cfg, toks[:, :LM_PROMPT]), state)
    torch.cuda.synchronize()
    prefill_bytes = torch.cuda.max_memory_allocated() - base

    def replay4():
        st = gstate
        for i in range(LM_PROMPT + 3, LM_PROMPT + 7):
            _, st = step(params, toks[:, i:i + 1], st)

    prof_replay = _kernel_profile(replay4)
    graph = _graph_vs_eager(params, cfg, serve_prompt(
        cfg, LM_BATCH, LM_PROMPT, 0, "cuda"), LM_DECODE, result.tokens,
        prof_replay["device_busy_ms"] / 4)
    del state, step, gstate
    torch.cuda.empty_cache()
    fields = {
        "arch": cfg.name, "layers": cfg.n_layers, "batch": LM_BATCH,
        "prompt": LM_PROMPT, "input_mode": cfg.input_mode,
        "decode_tokens": LM_DECODE, "dtype": "bfloat16",
        "ode": "DEFAULT_ODE (per_block, MALI/ALF, n_steps=2)",
        "prefill_ms": result.prefill_ms, "decode_ms": result.decode_ms,
        "decode_ms_per_step": result.decode_ms / LM_DECODE,
        "prefill_tok_s": result.prefill_tok_s,
        "decode_tok_s": result.decode_tok_s,
        "peak_memory_bytes": peak,
        # what earlier phases left allocated when the serve run began
        "serve_base_bytes": serve_base, "weights_bytes": weights,
        "init_s": init_s, "init_peak_bytes": init_peak,
        "init_peak_ratio": init_peak / weights,
        "prefill_activation_bytes": prefill_bytes, "launches": launches,
        "per_prefill": per_prefill, "per_decode_step": per_decode,
        "sample": result.tokens[0][:8].tolist(), "graph_vs_eager": graph,
        "profile_decode_4_replays": prof_replay}
    return launches, fields, params


def _compare_cells(arch: str, self_prompt: int = 0, floor: bool = False,
                   periods: int = 0, f32_periods: int = 0, period=None):
    """``_lm_compare`` at phase 11's two cells: bf16 at batch LM_BATCH x
    LM_PROMPT + 8 decode steps (``periods`` periods of ``period``; 0:
    every one), f32 at batch 2 x 256 + 4 (``f32_periods``; 0: as the
    bf16 cell)."""
    import torch
    return [_lm_compare(torch.bfloat16, LM_BATCH, LM_PROMPT, 8, arch,
                        self_prompt, floor, periods, period),
            _lm_compare(torch.float32, 2, 256, 4, arch, self_prompt, floor,
                        f32_periods or periods, period)]


def _xl_vjp_bytes(params, cfg, tokens: int):
    """The device bytes one mLSTM f-eval VJP (period 0's first mLSTM, at
    the training batch and ``tokens``, under torch.func.vjp as MALI's
    backward takes it) holds between its forward and its pullback, and
    its peak during the pullback, each beyond what was allocated
    before."""
    import torch
    from repro_torch.models.xlstm import _mlstm_dims, apply_mlstm_train
    _, heads, dh = _mlstm_dims(cfg)
    mixer = {k: v[0] for k, v in
             params["blocks"]["period"]["sub0"]["mixer"].items()}
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((XL_TRAIN_BATCH, tokens, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, pull = torch.func.vjp(
        lambda p, z: apply_mlstm_train(p, cfg, z).float(), mixer, x)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    grads = pull(torch.ones_like(out))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    require(all(bool(torch.isfinite(g).all()) for g in grads[0].values()),
            "xlstm (b): non-finite mLSTM VJP")
    del out, pull, grads
    return {"batch": XL_TRAIN_BATCH, "tokens": tokens,
            "held_bytes": held, "pullback_peak_bytes": peak,
            # what storing every token's C would hold, per saved tensor
            "per_token_c_bytes_per_saved_tensor":
                XL_TRAIN_BATCH * tokens * heads * dh * dh * 4}


def _xl_cli(label: str, want: str):
    """(c), run by phase_clis: a launcher at --full for a few tokens or
    steps prints ``want``."""
    def check(res) -> dict:
        require(res.returncode == 0 and want in res.stdout,
                f"xlstm (c): the {label} CLI failed: {res.stdout[-2000:]}"
                f"{res.stderr[-2000:]}")
        return {"s": res.s, "stdout_tail": res.stdout.splitlines()[-3:]}
    return check


def phase_xlstm(card: str, smi: str):
    """Phase 18: xlstm-125m at full width, one mLSTM and the sLSTM layer
    (2 of 12 layers). (a) served through the decode graph with phase 11's checks;
    (b) trained (MALI, ALF cuda, 3 Trainer steps at batch 8 x 256) with
    phase 17's checks and the bytes one mLSTM f-eval VJP holds; (c) the
    two launchers (both periods). Returns the per-prefill,
    per-decode-step and per-training-step launches."""
    import torch
    t0 = time.perf_counter()
    parts = {}

    def lap(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    import dataclasses
    from repro_torch.configs import get_config
    period = _xl_period()
    cut = dataclasses.replace(get_config(XL_ARCH), n_periods=XL_PERIODS,
                              period=period)
    _, serve_fields, params = _serve_cell(cut, XL_PER_PREFILL,
                                          XL_PER_DECODE, "xlstm")
    del params
    torch.cuda.empty_cache()
    lap("a_serve")
    serve_fields["compare"] = _compare_cells(XL_ARCH, XL_SELF_PROMPT,
                                             floor=True, periods=XL_PERIODS,
                                             period=period)
    lap("a_compare")
    trainer, batch0, per_step, full = _lt_full_width(
        XL_ARCH, XL_TRAIN_BATCH, XL_TRAIN_SEQ, XL_PER_STEP, XL_PERIODS,
        period)
    require(full["fevals_per_step"] == XL_FEVALS,
            f"xlstm (b): {full['fevals_per_step']} f-evals a step")
    lap("b_train")
    full.update(_lt_no_sync_step(trainer, batch0))
    lap("b_no_sync")
    memory = _lt_memory_mali(trainer, batch0)
    memory["mlstm_feval_vjp"] = _xl_vjp_bytes(
        trainer.state.params, trainer.cfg, batch0["tokens"].shape[1])
    lap("b_memory")
    params = trainer.state.params
    del trainer
    torch.cuda.empty_cache()
    compare = _lt_kernel_vs_reference(params, batch0, XL_ARCH,
                                      XL_CUT_PERIODS, XL_CUT_SEQ,
                                      XL_TRAIN_BATCH, XL_PERIODS, period)
    del params
    torch.cuda.empty_cache()
    lap("b_compare")
    emit({"phase": "xlstm", "card": card, "nvidia_smi": smi,
          "serve": serve_fields,
          "train": {"full_width": full, "compare": compare,
                    "memory": memory},
          "part_s": parts, "phase_s": time.perf_counter() - t0})
    return {"prefill": XL_PER_PREFILL, "decode": XL_PER_DECODE,
            "train": per_step[0]}


def _flash_d256_times(card: str):
    """The flash kernel at gemma2-2b's prefill shape (d 256, causal,
    softcap 50; the 4096 window masks nothing at 1024 tokens) against its
    bound and its plain version. No library call computes a softcapped
    attention; SDPA without the softcap is timed beside it for scale."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa_k
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention_work
    bw, _, bf16_peak = card_rates(card)
    cfg = get_config(GM_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(8)
    b, s, h, kv, d = (LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.n_kv_heads,
                      cfg.d_head)

    def rand(*shape):
        return torch.randn(*shape, generator=gen,
                           device="cuda").to(torch.bfloat16)

    q, k, v = rand(b, s, h, d), rand(b, s, kv, d), rand(b, s, kv, d)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kw = dict(causal=True, window=cfg.sliding_window,
              softcap=cfg.attn_softcap)
    kern = lambda: fa_k.flash_attention_call(q, k, v, **kw)   # noqa: E731
    plain = lambda: fa_ref.attention_ref(q, k, v, **kw)       # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(            # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    _close(kern(), plain(), *FA_TOL["bfloat16"],
           "flash at gemma2's shape against the plain version")
    ms, plain_ms = _alternate(kern, plain, 10)
    work = flash_attention_work(q, k, True, cfg.sliding_window)
    bound_ms, bound_by = _bound(work, bw, bf16_peak)
    graph_ms = _graph_ms(kern, 10)
    return {"shape": [b, s, h, kv, d], "causal": True,
            "window": cfg.sliding_window, "softcap": cfg.attn_softcap,
            "ms": ms, "graph_ms": graph_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "sdpa_without_softcap_ms": _time_ms(sdpa, 10),
            "tflops_per_s": work.flops / graph_ms / 1e9}


def _gm_long_prompt(params):
    """One prompt past the local layers' window (batch 1, 4608 tokens,
    8 decode steps): the kernel path against the plain path within
    LM_TOL, and the flash launches of the kernel path's prefill and their
    share of its device time."""
    import torch
    from repro_torch.configs import DEFAULT_ODE, get_config
    from repro_torch.models import init_serve_state, prefill
    cfg = get_config(GM_ARCH, DEFAULT_ODE)
    n = GM_LONG_PROMPT
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, n + GM_LONG_DECODE)), device="cuda")
    logits, out = {}, {}
    for backend in ("cuda", "reference"):
        logits[backend], _, pre_ms, dec_ms = _serve_run(
            params, cfg, toks, n, GM_LONG_DECODE, backend)
        out[f"prefill_ms_{backend}"] = pre_ms
        out[f"decode_ms_per_step_{backend}"] = dec_ms
    out.update({"prompt": n, "batch": 1, "decode_steps": GM_LONG_DECODE,
           "kernel_vs_plain_prefill": _rel(logits["cuda"][:, 0],
                                           logits["reference"][:, 0]),
           "kernel_vs_plain_decode": _rel(logits["cuda"][:, 1:],
                                          logits["reference"][:, 1:])})
    for key in ("kernel_vs_plain_prefill", "kernel_vs_plain_decode"):
        require(out[key] <= LM_TOL["bfloat16"],
                f"gemma2 long prompt {key}: {out[key]}")
    state = init_serve_state(cfg, 1, n)
    _lm_reset()
    prefill(params, cfg, {"tokens": toks[:, :n]}, state)
    out["flash_launches"] = _lm_counts()[0]["flash_attention"]
    require(out["flash_launches"] == GM_PER_PREFILL["flash_attention"],
            f"gemma2 long prompt: {out['flash_launches']} flash launches")
    return out


def phase_gemma2_serve(card: str, smi: str):
    """Phase 19: gemma2-2b at full width served with phase 11's checks,
    one prompt past the 4096-token window, and the d = 256 flash kernel
    timed at its prefill shape. Returns the per-prefill launches and the
    flash times."""
    import torch
    t0 = time.perf_counter()
    _, fields, params = _serve_cell(GM_ARCH, GM_PER_PREFILL, GM_PER_DECODE,
                                    "gemma2")
    fields["long_prompt"] = _gm_long_prompt(params)
    del params
    torch.cuda.empty_cache()
    fields["compare"] = _compare_cells(GM_ARCH)
    flash = _flash_d256_times(card)
    emit({"phase": "gemma2_serve", "card": card, "nvidia_smi": smi,
          **fields, "flash_d256": flash,
          "phase_s": time.perf_counter() - t0})
    return {"prefill": GM_PER_PREFILL, "flash_d256": flash}


# ---------------------------------------------------------------------------
# Phase 20: data-parallel training, two ranks sharing the one card
# ---------------------------------------------------------------------------

DP_WORLD = 2
DP_DEVICE = "cuda:0"          # both ranks on the one card (gloo)
DP_BATCH, DP_SEQ, DP_STEPS = 4, 1024, 3      # (a): 2 rows of 1024 a rank
# (a) runs qwen3-1.7b at full width, DP_LAYERS of its 28 layers: a depth
# cut for the script's time (the two ranks' steps are mostly gloo's
# staged collectives, which scale with the weights); its ALF launches a
# step, one midpoint, update, bwd_pre and bwd_post per layer, branch and
# ALF step
DP_LAYERS = 8
DP_PER_STEP = {name: 2 * 2 * DP_LAYERS for name in LT_PER_STEP}
DP_CUT_LAYERS, DP_CUT_SEQ = 2, 256           # (a) in f32
DP_OPT_RATIO = 0.55           # a rank's optimizer bytes / the one rank's
DP_TOL = {"bfloat16": LT_BF16_TOL, "float32": LT_F32_TOL}
# (b): qwen3's smoke config made pure-DP with a 1024-token vocabulary:
# ZeRO-1 shards its embedding and head (1024 x 64 = 2^16 elements each)
DP_SMOKE = dict(sharding="dp", vocab_size=1024)
DP_SMOKE_RUN = dict(steps=6, global_batch=4, seq_len=64, ckpt_every=2)
DP_FAIL_STEP = 2
# (c): deepseek-moe's smoke config under its own strategy, with drops
DP_MOE = dict(sharding="fsdp_tp", moe_capacity_factor=0.5)
DP_MOE_BATCH, DP_MOE_SEQ = 4, 64
DP_TIMEOUT = 420              # seconds the ranks may take together
# (e): one adaptive controller over both ranks (ode_steps=0, no
# ode_batch_axis), qwen3-1.7b at full width, DP_CUT_LAYERS layers in f32,
# DP_ADAPTIVE_BATCH rows of DP_CUT_SEQ tokens (2 a rank), one step
DP_ADAPTIVE_BATCH = 4
# (f): the fleet of 'data' (ode_batch_axis="data", ode_steps=0) on a
# (pod 2, data 2, model 1) mesh, four ranks sharing the card: the JAX
# package's Sharded("data") cuts the global batch into 2 blocks, each the
# rows of a pod's 2 data ranks, solved with a controller of its own whose
# error norm is summed over those 2 ranks every trial. qwen3-1.7b at full
# width, DP_CUT_LAYERS layers in f32, DP_FLEET_BATCH rows of DP_CUT_SEQ
# tokens (2 a rank), one step; held to one rank's per-block composition
DP_FLEET_MESH = (2, 2, 1)
DP_FLEET_WORLD = 4
DP_FLEET_BLOCKS = 2
DP_FLEET_BATCH = 8
DP_FLEET_TIMEOUT = 300        # seconds the four ranks may take together


def _dp_checksums(tree):
    """Per leaf, the sum of its bit patterns (int64) and of its values
    (float64), on the host: equal on two ranks only if the leaves are
    (almost surely) bit-equal."""
    import torch
    from repro_torch import tree_util
    out = []
    for t in tree_util.tree_leaves(tree):
        bits = t.contiguous().view({2: torch.int16, 4: torch.int32,
                                    8: torch.int64}[t.element_size()])
        out += [torch.sum(bits, dtype=torch.int64).double(),
                torch.sum(t, dtype=torch.float64)]
    return torch.stack(out).cpu()


def _dp_same_on_ranks(tree) -> bool:
    """Whether every rank holds ``tree`` bit for bit (a gloo all-gather
    of the host checksums, outside the counted collectives)."""
    import torch
    import torch.distributed as dist
    mine = _dp_checksums(tree)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return all(torch.equal(p, mine) for p in parts)


def _dp_counts():
    from repro_torch.distributed import data_parallel
    return dict(_lm_counts()[0]), data_parallel.collective_counts()


def _dp_delta(a, b):
    """Launches, collectives ({kind: calls, bytes, seconds}) and host
    stagings between two ``_dp_counts`` snapshots."""
    (la, ca), (lb, cb) = a, b
    launches = {k: lb[k] - la.get(k, 0) for k in lb if lb[k] - la.get(k, 0)}
    coll = {kind: {k: x - ca.get(kind, {}).get(k, 0) for k, x in v.items()}
            for kind, v in cb.items()}
    return launches, coll


def _dp_opt_bytes(state) -> int:
    from repro_torch import tree_util
    return sum(t.numel() * t.element_size()
               for t in tree_util.tree_leaves((state.opt, state.ef)))


def _dp_trainer(cfg=None, hook=None, **kw):
    """A Trainer of qwen3-1.7b at full width, DP_LAYERS layers (or
    ``cfg``) on DP_DEVICE, AdamW at its defaults."""
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import MemoryEmitter, Trainer, TrainerConfig
    run = dict(arch=LM_ARCH, smoke=False, steps=DP_STEPS,
               global_batch=DP_BATCH, seq_len=DP_SEQ, log_every=100,
               emit="memory", device=DP_DEVICE)
    run.update(kw)
    if cfg is None:
        cfg = _lt_config("cuda", layers=DP_LAYERS)
    return Trainer(TrainerConfig(**run), emitter=MemoryEmitter(),
                   step_hook=hook, opt_cfg=OptimizerConfig(), model_cfg=cfg)


def _dp_records(t) -> dict:
    recs = [t.records[s] for s in sorted(t.records)]
    return {"loss": [r.loss for r in recs], "lr": [r.lr for r in recs],
            "grad_norm": [r.grad_norm for r in recs],
            "step_ms": [r.wall_s * 1e3 for r in recs],
            "fevals": [r.fevals for r in recs]}


def _dp_full_width() -> dict:
    """(a) on one rank: DP_STEPS Trainer steps at full width, each step's
    launches, collectives, host stagings and the ranks' parameters
    compared after it; the optimizer bytes, the peak, and the last step
    under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    snaps, equal = [], []
    prof = profile(activities=[ProfilerActivity.CUDA])
    t_prof = []

    def hook(step):
        if step:
            equal.append(_dp_same_on_ranks(trainer.state.params))
        snaps.append(_dp_counts())
        if step == DP_STEPS - 1:
            torch.cuda.synchronize()
            prof.start()
            t_prof.append(time.perf_counter())

    trainer = _dp_trainer(hook=hook)
    torch.cuda.reset_peak_memory_stats()
    require(trainer.train() == DP_STEPS, "dp_train (a): the run did not "
            "finish")
    torch.cuda.synchronize()
    prof.stop()
    wall_ms = (time.perf_counter() - t_prof[0]) * 1e3
    snaps.append(_dp_counts())
    equal.append(_dp_same_on_ranks(trainer.state.params))
    per_step = [_dp_delta(snaps[i], snaps[i + 1]) for i in range(DP_STEPS)]
    return {**_dp_records(trainer),
            "launches_per_step": [p[0] for p in per_step],
            "collectives_per_step": [p[1] for p in per_step],
            "params_equal_after_each_step": equal,
            "opt_bytes": _dp_opt_bytes(trainer.state),
            "sharded_leaves": trainer.plan.n_sharded,
            "leaves": len(trainer.plan.dims),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "profile": _profile_summary(prof, wall_ms)}


def _dp_f32_cut() -> dict:
    """(a) in f32 on the cut (DP_CUT_LAYERS layers at DP_CUT_SEQ)."""
    cfg = _lt_config("cuda", layers=DP_CUT_LAYERS, dtype="float32")
    t = _dp_trainer(cfg, seq_len=DP_CUT_SEQ)
    require(t.train() == DP_STEPS, "dp_train (a) f32: the run did not "
            "finish")
    return {**_dp_records(t), "params_equal": _dp_same_on_ranks(
        t.state.params)}


@contextlib.contextmanager
def _dp_noting(log: list):
    """Inside the block every branch solve's (accepted, rejected) trials
    are noted in ``log`` (device tensors; a batched solve's first row's,
    its block's), through a wrapper of ``models.transformer.solve``."""
    from repro_torch.models import transformer
    solve = transformer.solve

    def noting(*args, **kw):
        sol = solve(*args, **kw)
        per = sol.stats.per_sample
        log.append((sol.stats.n_accepted, sol.stats.n_rejected)
                   if per is None else (per.n_accepted[0],
                                        per.n_rejected[0]))
        return sol

    transformer.solve = noting
    try:
        yield log
    finally:
        transformer.solve = solve


def _dp_adaptive() -> dict:
    """(e) on one rank, or the one-rank reference: one Trainer step under
    adaptive control, each block's (accepted, rejected) trials in call
    order (the model's solves noted through a wrapper of
    ``models.transformer.solve``), the step's collectives and whether the
    ranks' parameters are bit-equal after it."""
    import torch
    import torch.distributed as dist
    cfg = _lt_config("cuda", n_steps=0, layers=DP_CUT_LAYERS,
                     dtype="float32")
    t = _dp_trainer(cfg, steps=1, global_batch=DP_ADAPTIVE_BATCH,
                    seq_len=DP_CUT_SEQ)
    log = []
    before = _dp_counts()
    with _dp_noting(log):
        require(t.train() == 1, "dp_train (e): the step did not finish")
    _, coll = _dp_delta(before, _dp_counts())
    torch.cuda.synchronize()
    return {**_dp_records(t),
            "blocks": [[int(a), int(r)] for a, r in log],
            "error_norm": coll.get("error_norm", {}),
            "error_norm_data": coll.get("error_norm@data", {}),
            "host_staged": coll["host_staged"],
            "params_equal": (_dp_same_on_ranks(t.state.params)
                             if dist.is_initialized()
                             and dist.get_world_size() > 1 else True)}


def _dp_smoke_cfg():
    import dataclasses
    return dataclasses.replace(_lt_config("cuda", smoke=True), **DP_SMOKE)


def _dp_state_file(t, path: Path) -> None:
    """The Trainer's whole state (gathered: every rank calls this), saved
    by rank 0."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree_util
    whole = t.whole_state()
    if not dist.is_initialized() or dist.get_rank() == 0:
        torch.save({k: [x.cpu() for x in tree_util.tree_leaves(v)]
                    for k, v in (("params", whole.params),
                                 ("opt", whole.opt), ("ef", whole.ef))},
                   path)


def _dp_same_state(path: Path, t, what: str) -> None:
    import torch
    from repro_torch import tree_util
    saved = torch.load(path)
    whole = t.whole_state()
    for key, tree in (("params", whole.params), ("opt", whole.opt),
                      ("ef", whole.ef)):
        mine = [x.cpu() for x in tree_util.tree_leaves(tree)]
        require(len(mine) == len(saved[key]) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(saved[key], mine)),
            f"dp_train (b): {what}: the {key} differ")


def _dp_recovery(d: Path) -> dict:
    """(b) on one rank: the clean run and the host syncs of one more step
    by the line that made them, a run with a failure at DP_FAIL_STEP on
    every rank resumed from the checkpoint before it, the one-rank
    checkpoint restored, and a checkpoint for the one-rank Trainer to
    restore."""
    from repro_torch.train import train_step
    cfg = _dp_smoke_cfg()
    fired = []

    def hook(step):
        if step == DP_FAIL_STEP and not fired:
            fired.append(step)
            raise RuntimeError("injected failure")

    def run(steps=DP_SMOKE_RUN["steps"], hook=None, **kw):
        t = _dp_trainer(cfg, hook, **{**DP_SMOKE_RUN, "smoke": True,
                                      "steps": steps, **kw})
        require(t.train() == steps, "dp_train (b): the run did not finish")
        return t

    clean = run()
    st, batch = clean.state, clean.batch(0)
    staged = _dp_counts()[1]["host_staged"]["calls"]
    with clean.mesh:
        _, syncs, where = _count_syncs(lambda: train_step(
            st.params, st.opt, None, batch, cfg=cfg, opt_cfg=clean.opt_cfg,
            zero1=True))
    staged = _dp_counts()[1]["host_staged"]["calls"] - staged
    # the collectives' host stagings are the step's only host syncs
    elsewhere = {k: n for k, n in where.items()
                 if not k.startswith("data_parallel.py")}
    require(not elsewhere, f"dp_train (b): train_step synced the host "
            f"outside its collectives: {elsewhere}")
    resumed = run(hook=hook, ckpt_dir=str(d / "resumed"))
    restored = run(steps=4, ckpt_dir=str(d / "one_rank"))
    _dp_state_file(restored, d / "restored_state.pt")
    written = run(steps=4, ckpt_dir=str(d / "two_rank"))
    _dp_state_file(written, d / "written_state.pt")
    return {"clean": clean.loss_trace(), "resumed": resumed.loss_trace(),
            "fired": fired, "restored_steps": sorted(restored.records),
            "sharded_leaves": clean.plan.n_sharded,
            "host_syncs_in_train_step": syncs, "host_syncs_by_line": where,
            "host_staged_in_train_step": staged}


def _dp_moe_cfg(batch_axis=None):
    import dataclasses
    cfg = dataclasses.replace(_lt_config("cuda", arch="deepseek-moe-16b",
                                         smoke=True), **DP_MOE)
    return dataclasses.replace(cfg, ode=dataclasses.replace(
        cfg.ode, batch_axis=batch_axis))


def _dp_kept(params, cfg, batch, plan=None):
    """The kept masks of a forward (no grad), rows split when ``plan``."""
    import contextlib

    import torch
    from repro_torch.models import lm_loss
    from repro_torch.models.moe import recording_routes
    split = plan.splitting_rows() if plan else contextlib.nullcontext()
    with torch.no_grad(), recording_routes() as log, split:
        lm_loss(params, cfg, batch)
    return [r.kept.cpu().numpy() for r in log]


def _dp_moe_params(cfg):
    import torch
    from repro_torch.models import init_lm
    return init_lm(torch.Generator(device="cuda").manual_seed(7), cfg,
                   DP_DEVICE)


def _dp_moe(d: Path, rank: int) -> dict:
    """(c) on one rank: the kept masks over this rank's rows in the global
    token order, and solved per shard (ode.batch_axis='data')."""
    from repro_torch.distributed.data_parallel import DataParallel
    from repro_torch.launch.mesh import make_host_mesh
    cfg = _dp_moe_cfg()
    params = _dp_moe_params(cfg)
    mesh = make_host_mesh(DP_DEVICE)
    plan = DataParallel(cfg, mesh, params)
    rows, split = plan.local_rows(_lt_batch(cfg, DP_MOE_BATCH, DP_MOE_SEQ))
    require(split, "dp_train (c): the rows are not split")
    kept = _dp_kept(params, cfg, rows, plan)
    shard_cfg = _dp_moe_cfg("data")
    shard = _dp_kept(params, shard_cfg, rows,
                     DataParallel(shard_cfg, mesh, params))
    np.savez(d / f"moe_{rank}.npz", **{f"global_{i}": k
                                       for i, k in enumerate(kept)},
             **{f"shard_{i}": k for i, k in enumerate(shard)})
    return {"calls": len(kept), "sharded_leaves": plan.n_sharded}


def _dp_rank(argv) -> int:
    """One rank of phase 20: ``chip_smoke.py --dp-rank RANK DIR``."""
    rank, d = int(argv[0]), Path(argv[1])
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(torch.device(DP_DEVICE))
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"),
                                                         DP_WORLD),
                            rank=rank, world_size=DP_WORLD)
    try:
        t0 = time.perf_counter()
        out = {"full_width": _dp_full_width()}
        out["full_width"]["part_s"] = time.perf_counter() - t0
        out["f32_cut"] = _dp_f32_cut()
        out["recovery"] = _dp_recovery(d)
        out["moe"] = _dp_moe(d, rank)
        t1 = time.perf_counter()
        out["adaptive"] = _dp_adaptive()
        out["adaptive"]["part_s"] = time.perf_counter() - t1
        out["rank_s"] = time.perf_counter() - t0
        (d / f"rank{rank}.json").write_text(json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _dp_spawn(d: Path, flag: str = "--dp-rank", name: str = "rank",
              world: int = DP_WORLD, timeout: float = DP_TIMEOUT):
    """Run the ranks (``chip_smoke.py FLAG RANK DIR``, each writing
    ``DIR/<name><rank>.json``); returns their results (raises if any
    fails or the ranks outlast ``timeout``)."""
    import os
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    logs = [open(d / f"{name}{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               flag, str(r), str(d)], cwd=str(HERE),
                              env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        require(p.returncode == 0, f"dp_train: {name} {r} failed "
                f"(exit {p.returncode}): "
                f"{(d / f'{name}{r}.log').read_text()[-3000:]}")
    return [json.loads((d / f"{name}{r}.json").read_text())
            for r in range(world)]


def _dp_one_rank(d: Path) -> dict:
    """The one-rank runs the ranks are held to: (a) at full width and on
    the f32 cut, (b)'s checkpoint for the ranks to restore, (c)'s masks
    on the global batch and on each rank's rows."""
    import torch
    ref = {}
    t = _dp_trainer()
    torch.cuda.reset_peak_memory_stats()
    require(t.train() == DP_STEPS, "dp_train: the one-rank run did not "
            "finish")
    ref["full_width"] = {**_dp_records(t),
                         "opt_bytes": _dp_opt_bytes(t.state),
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del t
    torch.cuda.empty_cache()
    t = _dp_trainer(_lt_config("cuda", layers=DP_CUT_LAYERS,
                               dtype="float32"), seq_len=DP_CUT_SEQ)
    require(t.train() == DP_STEPS, "dp_train: the one-rank f32 run")
    ref["f32_cut"] = _dp_records(t)
    del t
    torch.cuda.empty_cache()
    t = _dp_trainer(_dp_smoke_cfg(), **{**DP_SMOKE_RUN, "smoke": True,
                                        "steps": 4,
                                        "ckpt_dir": str(d / "one_rank")})
    require(t.train() == 4, "dp_train: the one-rank smoke run")
    _dp_state_file(t, d / "one_rank_state.pt")
    t = _dp_trainer(_dp_smoke_cfg(), **{**DP_SMOKE_RUN, "smoke": True})
    require(t.train() == DP_SMOKE_RUN["steps"], "dp_train: the one-rank "
            "smoke trace")
    ref["recovery_clean"] = t.loss_trace()
    cfg = _dp_moe_cfg()
    params = _dp_moe_params(cfg)
    batch = _lt_batch(cfg, DP_MOE_BATCH, DP_MOE_SEQ)
    ref["moe_global"] = _dp_kept(params, cfg, batch)
    rows = DP_MOE_BATCH // DP_WORLD
    ref["moe_shard"] = [_dp_kept(params, cfg, {k: v[r * rows:(r + 1) * rows]
                                               for k, v in batch.items()})
                        for r in range(DP_WORLD)]
    del params
    torch.cuda.empty_cache()
    ref["adaptive"] = _dp_adaptive()
    torch.cuda.empty_cache()
    return ref


def _dp_rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _dp_check(d: Path, ranks, ref) -> dict:
    """Hold the ranks to the one-rank runs and to the phase's counts."""
    import torch
    out = {}
    # (a)
    fw = [r["full_width"] for r in ranks]
    cmp = {}
    for label, key, tol in (("full_width", "full_width", DP_TOL["bfloat16"]),
                            ("f32_cut", "f32_cut", DP_TOL["float32"])):
        one = ref[key]
        worst = {}
        for r in ranks:
            got = r[key]
            for m in ("loss", "grad_norm"):
                errs = [_dp_rel(a, b) for a, b in zip(got[m], one[m])]
                worst[m] = max(worst.get(m, 0.0), *errs)
            require(got["lr"] == one["lr"], f"dp_train (a) {label}: lr "
                    f"{got['lr']} != {one['lr']}")
            require(got["fevals"] == one["fevals"], f"dp_train (a) "
                    f"{label}: f-evals {got['fevals']} != {one['fevals']}")
        require(max(worst.values()) <= tol, f"dp_train (a) {label}: two "
                f"ranks against one: {worst} (tolerance {tol})")
        cmp[label] = {"rel": worst, "tolerance": tol,
                      "two_ranks": {m: ranks[0][key][m] for m in
                                    ("loss", "lr", "grad_norm", "step_ms")},
                      "one_rank": {m: one[m] for m in
                                   ("loss", "lr", "grad_norm", "step_ms")}}
    out["compare"] = cmp
    for r, got in enumerate(fw):
        require(all(got["params_equal_after_each_step"]),
                f"dp_train (a): rank {r}'s parameters differ")
        for i, launches in enumerate(got["launches_per_step"]):
            require(launches == DP_PER_STEP, f"dp_train (a) rank {r} step "
                    f"{i}: launches {launches}, expected {DP_PER_STEP}")
        require(got["opt_bytes"] <= DP_OPT_RATIO
                * ref["full_width"]["opt_bytes"], f"dp_train (a): rank {r}"
                f" holds {got['opt_bytes']} optimizer bytes against "
                f"{ref['full_width']['opt_bytes']} on one rank")
    f32 = [r["f32_cut"] for r in ranks]
    require(all(g["params_equal"] for g in f32), "dp_train (a) f32: the "
            "ranks' parameters differ")
    out["full_width"] = {
        "config": {"arch": LM_ARCH, "layers": f"{DP_LAYERS} of 28",
                   "d_model": 2048,
                   "dtype": "bfloat16", "sharding": "dp (ZeRO-1)",
                   "global_batch": DP_BATCH, "seq_len": DP_SEQ,
                   "ranks": DP_WORLD, "backend": "gloo, one card",
                   "ode": "MALI, ALF(cuda), ConstantSteps(2)"},
        "ranks": [{k: g[k] for k in (
            "step_ms", "launches_per_step", "collectives_per_step",
            "params_equal_after_each_step", "opt_bytes", "sharded_leaves",
            "leaves", "peak_gb", "part_s")} for g in fw],
        "one_rank": {k: ref["full_width"][k] for k in ("opt_bytes",
                                                       "peak_gb",
                                                       "step_ms")},
        "opt_ratio": [g["opt_bytes"] / ref["full_width"]["opt_bytes"]
                      for g in fw],
        "profile_last_step": [g["profile"] for g in fw],
        # two processes' kernels time-share the card: the busy times add
        "idle_share_last_step": 1.0 - sum(
            g["profile"]["device_busy_ms"] for g in fw) / max(
            g["profile"]["wall_ms"] for g in fw),
    }
    # (b)
    rec = [r["recovery"] for r in ranks]
    for r, got in enumerate(rec):
        require(got["fired"] == [DP_FAIL_STEP], f"dp_train (b) rank {r}: "
                f"the failure fired at {got['fired']}")
        require(got["resumed"] == got["clean"],
                f"dp_train (b) rank {r}: resumed {got['resumed']} against "
                f"clean {got['clean']}")
        require(got["restored_steps"] == [] and got["sharded_leaves"] >= 1,
                f"dp_train (b) rank {r}: {got}")
    worst = max(_dp_rel(a, b) for a, b in zip(rec[0]["clean"],
                                             ref["recovery_clean"]))
    require(worst <= DP_TOL["float32"], f"dp_train (b): the two-rank trace "
            f"{rec[0]['clean']} against one rank's {ref['recovery_clean']}")
    restored = _dp_trainer(_dp_smoke_cfg(), **{
        **DP_SMOKE_RUN, "smoke": True, "steps": 4,
        "ckpt_dir": str(d / "two_rank")})
    require(restored.train() == 4 and not restored.records,
            "dp_train (b): the one-rank Trainer ran steps")
    _dp_same_state(d / "written_state.pt", restored,
                   "a two-rank checkpoint restored on one rank")
    saved = torch.load(d / "restored_state.pt")
    mine = torch.load(d / "one_rank_state.pt")
    require(all(len(saved[k]) == len(mine[k]) and all(
        a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(saved[k], mine[k])) for k in mine),
        "dp_train (b): a one-rank checkpoint restored on two ranks "
        "differs")
    out["recovery"] = {"trace": rec[0]["clean"], "fired_at": DP_FAIL_STEP,
                       "two_vs_one_rank_rel": worst,
                       "sharded_leaves": rec[0]["sharded_leaves"],
                       "host_syncs_in_train_step": [
                           {"total": g["host_syncs_in_train_step"],
                            "by_line": g["host_syncs_by_line"],
                            "host_staged": g["host_staged_in_train_step"]}
                           for g in rec]}
    # (c)
    drops, calls = 0, len(ref["moe_global"])
    for r in range(DP_WORLD):
        with np.load(d / f"moe_{r}.npz") as f:
            require(ranks[r]["moe"]["calls"] == calls, "dp_train (c): "
                    "the MoE calls differ")
            for i, want in enumerate(ref["moe_global"]):
                n = f[f"global_{i}"].shape[0]
                require(np.array_equal(f[f"global_{i}"],
                                       want[r * n:(r + 1) * n]),
                        f"dp_train (c): rank {r} call {i}: kept masks "
                        "differ from the one-rank run's")
                require(np.array_equal(f[f"shard_{i}"],
                                       ref["moe_shard"][r][i]),
                        f"dp_train (c): rank {r} call {i}: per-shard masks "
                        "differ")
    for want in ref["moe_global"]:
        drops += int((~want).sum())
    require(drops > 0, "dp_train (c): no (token, choice) was dropped")
    out["moe"] = {"calls": calls, "drops": drops,
                  "kept": int(sum(k.sum() for k in ref["moe_global"])),
                  "sharded_leaves": ranks[0]["moe"]["sharded_leaves"]}
    out["adaptive"] = _dp_check_adaptive(ranks, ref["adaptive"])
    return out


def _dp_check_adaptive(ranks, one) -> dict:
    """(e): hold the ranks' adaptive step to the one-rank step ``one``."""
    require(len(one["blocks"]) == 2 * DP_CUT_LAYERS, f"dp_train (e): the "
            f"one-rank step solved {len(one['blocks'])} blocks")
    worst = {}
    for r, got in enumerate(g["adaptive"] for g in ranks):
        where = f"dp_train (e) rank {r}"
        require(got["blocks"] == one["blocks"], f"{where}: (accepted, "
                f"rejected) by block {got['blocks']}, one rank "
                f"{one['blocks']}")
        require(got["fevals"] == one["fevals"], f"{where}: f-evals "
                f"{got['fevals']}, one rank {one['fevals']}")
        for m in ("loss", "grad_norm"):
            worst[m] = max(worst.get(m, 0.0), _dp_rel(got[m][0], one[m][0]))
        require(got["params_equal"], f"{where}: the ranks' parameters "
                "differ")
        trials = sum(a + b for a, b in got["blocks"])
        require(got["error_norm"].get("calls") == trials
                == got["error_norm_data"].get("calls"), f"{where}: "
                f"{got['error_norm']} error-norm reductions for {trials} "
                "trials")
    require(max(worst.values()) <= DP_TOL["float32"], f"dp_train (e): two "
            f"ranks against one: {worst} (tolerance {DP_TOL['float32']})")
    return {
        "config": {"arch": LM_ARCH, "layers": f"{DP_CUT_LAYERS} of 28",
                   "d_model": 2048, "dtype": "float32",
                   "global_batch": DP_ADAPTIVE_BATCH, "seq_len": DP_CUT_SEQ,
                   "ranks": DP_WORLD, "ode": "MALI, ALF(cuda), "
                   "AdaptiveController(1e-2, 1e-3, 32), one controller "
                   "over the global batch"},
        "blocks": one["blocks"], "rel": worst,
        "tolerance": DP_TOL["float32"],
        "two_ranks": {m: ranks[0]["adaptive"][m] for m in
                      ("loss", "grad_norm", "fevals", "step_ms")},
        "one_rank": {m: one[m] for m in ("loss", "grad_norm", "fevals",
                                          "step_ms")},
        "error_norm": [g["adaptive"]["error_norm"] for g in ranks],
        "host_staged": [g["adaptive"]["host_staged"] for g in ranks],
        "part_s": [g["adaptive"]["part_s"] for g in ranks]}


def _dp_fleet_cfg(batch_axis="data"):
    """(f)'s config: qwen3-1.7b at full width, DP_CUT_LAYERS layers, f32,
    adaptive, its branches a fleet over ``batch_axis`` (None: one
    controller over the batch, the one-rank blocks')."""
    import dataclasses
    cfg = _lt_config("cuda", n_steps=0, layers=DP_CUT_LAYERS,
                     dtype="float32")
    return dataclasses.replace(cfg, ode=dataclasses.replace(
        cfg.ode, batch_axis=batch_axis))


def _dp_fleet_params(cfg):
    import torch
    from repro_torch.models import init_lm
    return init_lm(torch.Generator(device="cuda").manual_seed(0), cfg,
                   DP_DEVICE)


def _dp_fleet_one_rank() -> dict:
    """(f)'s oracle on one rank: each fleet block's loss and gradients
    alone (one controller over its rows), its trials branch by branch
    and its ALF launches, averaged over the blocks (equal token
    counts)."""
    import torch
    from repro_torch import tree_util
    from repro_torch.train import loss_and_grads
    cfg = _dp_fleet_cfg(None)
    params = _dp_fleet_params(cfg)
    batch = _lt_batch(cfg, DP_FLEET_BATCH, DP_CUT_SEQ)
    rows = DP_FLEET_BATCH // DP_FLEET_BLOCKS
    blocks, losses, mean = [], [], None
    for i in range(DP_FLEET_BLOCKS):
        log = []
        before = _dp_counts()
        with _dp_noting(log):
            loss, stats, grads = loss_and_grads(
                params, {k: v[i * rows:(i + 1) * rows]
                         for k, v in batch.items()}, cfg=cfg)
        torch.cuda.synchronize()
        launches, _ = _dp_delta(before, _dp_counts())
        losses.append(float(loss))
        g = [t / DP_FLEET_BLOCKS for t in tree_util.tree_leaves(grads)]
        mean = g if mean is None else [a + b for a, b in zip(mean, g)]
        blocks.append({"trials": [[int(a), int(r)] for a, r in log],
                       "fevals": int(stats.n_fevals),
                       "launches": launches})
    norm = float(torch.sqrt(sum(torch.sum(torch.square(t.double()))
                                for t in mean)))
    return {"loss": float(np.mean(losses)), "grad_norm": norm,
            "fevals": rows * sum(b["fevals"] for b in blocks),
            "blocks": blocks}


def _dp_fleet_rank(argv) -> int:
    """One rank of phase 20 (f): ``chip_smoke.py --fleet-rank RANK
    DIR``."""
    rank, d = int(argv[0]), Path(argv[1])
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(torch.device(DP_DEVICE))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(d / "fleet_store"), DP_FLEET_WORLD), rank=rank,
        world_size=DP_FLEET_WORLD)
    try:
        from repro_torch.distributed.data_parallel import DataParallel
        from repro_torch.optim import OptimizerConfig, init_opt_state
        from repro_torch.train import train_step
        t0 = time.perf_counter()
        mesh = init_device_mesh("cuda", DP_FLEET_MESH,
                                mesh_dim_names=("pod", "data", "model"))
        cfg = _dp_fleet_cfg()
        whole = _dp_fleet_params(cfg)
        plan = DataParallel(cfg, mesh, whole)
        require(plan.checksum_equal(whole), "dp_train (f): the ranks' "
                "seeded weights differ")
        params = plan.param_shards(whole)
        del whole
        opt_cfg = OptimizerConfig()
        opt = init_opt_state(opt_cfg, plan.param_to_opt(params))
        batch = _lt_batch(cfg, DP_FLEET_BATCH, DP_CUT_SEQ)
        rows, split = plan.local_rows({"i": torch.arange(DP_FLEET_BATCH)})
        log = []
        before = _dp_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with mesh, _dp_noting(log):
            params, opt, _, m = train_step(params, opt, None, batch,
                                           cfg=cfg, opt_cfg=opt_cfg,
                                           zero1=True)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t1) * 1e3
        launches, coll = _dp_delta(before, _dp_counts())
        out = {"rows": rows["i"].tolist(), "split": split.axes,
               "coord": dict(zip(mesh.mesh_dim_names,
                                 mesh.get_coordinate())),
               "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "fevals": int(m["ode_fevals"]),
               "trials": [[int(a), int(r)] for a, r in log],
               "launches": launches,
               "error_norm": coll.get("error_norm", {}),
               "error_norm_data": coll.get("error_norm@data", {}),
               "host_staged": coll["host_staged"],
               "params_equal": _dp_same_on_ranks(
                   plan.gather_params(params)),
               "step_ms": step_ms, "rank_s": time.perf_counter() - t0}
        (d / f"fleet_rank{rank}.json").write_text(json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _dp_check_fleet(ranks, one) -> dict:
    """(f): hold each rank to its block of the one-rank composition."""
    rows = DP_FLEET_BATCH // DP_FLEET_BLOCKS
    worst = {}
    for r, got in enumerate(ranks):
        where = f"dp_train (f) rank {r}"
        block = got["rows"][0] // rows
        want = one["blocks"][block]
        require(got["split"] == ["pod", "data"] and block
                == got["coord"]["pod"], f"{where}: rows {got['rows']} over "
                f"{got['split']} at {got['coord']}")
        require(got["trials"] == want["trials"], f"{where}: (accepted, "
                f"rejected) by branch {got['trials']}, block {block} on "
                f"one rank {want['trials']}")
        require(got["launches"] == want["launches"], f"{where}: ALF "
                f"launches {got['launches']}, block {block} on one rank "
                f"{want['launches']}")
        trials = sum(a + b for a, b in got["trials"])
        require(got["error_norm"].get("calls") == trials
                == got["error_norm_data"].get("calls"), f"{where}: "
                f"{got['error_norm']} error-norm reductions for {trials} "
                "trials of its block")
        require(got["fevals"] == one["fevals"], f"{where}: f-evals "
                f"{got['fevals']}, the blocks' {one['fevals']}")
        require(got["params_equal"], f"{where}: the ranks' parameters "
                "differ")
        for m in ("loss", "grad_norm"):
            worst[m] = max(worst.get(m, 0.0), _dp_rel(got[m], one[m]))
    require(max(worst.values()) <= DP_TOL["float32"], f"dp_train (f): four "
            f"ranks against the one-rank blocks: {worst} (tolerance "
            f"{DP_TOL['float32']})")
    return {
        "config": {"arch": LM_ARCH, "layers": f"{DP_CUT_LAYERS} of 28",
                   "d_model": 2048, "dtype": "float32",
                   "global_batch": DP_FLEET_BATCH, "seq_len": DP_CUT_SEQ,
                   "mesh": dict(zip(("pod", "data", "model"),
                                    DP_FLEET_MESH)),
                   "ode": "MALI, ALF(cuda), AdaptiveController(1e-2, 1e-3, "
                   "32), ode_batch_axis='data': 2 blocks of 2 ranks"},
        "blocks": [{k: b[k] for k in ("trials", "fevals", "launches")}
                   for b in one["blocks"]],
        "rel": worst, "tolerance": DP_TOL["float32"],
        "ranks": [{k: g[k] for k in ("loss", "grad_norm", "fevals",
                                     "step_ms", "rank_s", "error_norm",
                                     "host_staged")} for g in ranks],
        "one_rank": {m: one[m] for m in ("loss", "grad_norm", "fevals")},
        "launches_per_rank": [g["launches"] for g in ranks]}


def _dp_cli(res) -> dict:
    """(d), run by phase_clis: the training CLI on two ranks of one
    card."""
    require(res.returncode == 0 and res.stdout.count("final_step=3") == 1,
            f"dp_train (d): the CLI failed: {res.stdout[-2000:]}"
            f"{res.stderr[-3000:]}")
    require(res.stderr.count("backend gloo") == 2, "dp_train (d): the "
            f"backend: {res.stderr[-2000:]}")
    return {"cli_s": res.s,
            "losses": [json.loads(line)["loss"] for line in
                       res.stdout.splitlines() if line.startswith("{")]}


def phase_dp_train(card: str, smi: str):
    """Phase 20: data-parallel training over two ranks sharing the card
    (gloo): (a) qwen3-1.7b at full width, (b) recovery and checkpoints
    across world sizes, (c) the MoE under DP, (d) the CLI, (e) one
    adaptive controller over both ranks; then (f) the fleet of 'data'
    over four ranks on (pod 2, data 2). Returns the ALF launches of one
    step of (a) on a rank and of (f) on each rank."""
    import tempfile

    import torch
    t0 = time.perf_counter()
    parts = {}

    def lap(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        d = Path(tmp)
        ref = _dp_one_rank(d)
        torch.cuda.empty_cache()
        lap("one_rank")
        ranks = _dp_spawn(d)
        lap("ranks")
        fields = _dp_check(d, ranks, ref)
        lap("check")
        one = _dp_fleet_one_rank()
        torch.cuda.empty_cache()
        lap("fleet_one_rank")
        fleet = _dp_spawn(d, "--fleet-rank", "fleet_rank", DP_FLEET_WORLD,
                          DP_FLEET_TIMEOUT)
        lap("fleet_ranks")
        fields["fleet"] = _dp_check_fleet(fleet, one)
        lap("fleet_check")
    emit({"phase": "dp_train", "card": card, "nvidia_smi": smi, **fields,
          "part_s": parts, "phase_s": time.perf_counter() - t0})
    return {"train": ranks[0]["full_width"]["launches_per_step"][0],
            "fleet": fields["fleet"]["launches_per_rank"]}



# ---------------------------------------------------------------------------
# Phase 21: the four configs that fit one card, served at full width
# ---------------------------------------------------------------------------

# (arch, periods of the f32 check), served in this order, one at a time,
# each one's weights freed before the next. In f32 granite-20b (112 GB)
# and deepseek-moe-16b (65.5 GB) do not fit: their f32 checks run 2
# layers (granite 2 periods; deepseek its dense prelude layer and 1 MoE
# layer). stablelm-1.6b's and musicgen-large's run 2 layers too (their
# full depth was cut to keep the script near 1000 s; from 4 layers when
# phases 20 and 24 gained their adaptive and xLSTM parts).
CS_CONFIGS = (("stablelm-1.6b", 2), ("musicgen-large", 2),
              ("deepseek-moe-16b", 1), ("granite-20b", 2))
CS_F32_FITS = ("stablelm-1.6b", "musicgen-large")
# per prefill under DEFAULT_ODE (3 f-evals a branch): flash, RMSNorm and
# each ALF op (tests/test_torch_lm_serve.py, FULL_DEPTH_CALLS: layers x 3;
# layers x 2 branches x 3 + the final norm; layers x 2 branches x 2
# steps). A decode step launches the same but no flash.
CS_PER_PREFILL = {
    "stablelm-1.6b": (72, 145, 96),          # 24 layers
    "musicgen-large": (144, 289, 192),       # 48 layers
    "deepseek-moe-16b": (84, 169, 112),      # 1 prelude + 27 MoE layers
    "granite-20b": (156, 313, 208),          # 52 layers
}
# init's predicted peak and the cache must fit this share of the card
CS_FIT = 0.9
# init's peak beyond the weights and its largest draw: the caching
# allocator's rounding of each block (2 MiB for large ones)
CS_INIT_SLACK = 64 * 2 ** 20
# a serve run's peak beyond the weights, the cache and one prefill's own
# allocations: the prompt, the logits, the decode graph's pool and the
# capture stream's cuBLAS workspace
CS_PEAK_SLACK = 512 * 2 ** 20
# the phase's wall-time budget, seconds: reported beside its time (host
# times vary ~1.5x between calls, so it is not a check)
CS_PHASE_S = 150.0


def _cs_counts(arch: str):
    flash, norms, alf = CS_PER_PREFILL[arch]
    prefill = {"flash_attention": flash, "rmsnorm": norms,
               "alf_midpoint": alf, "alf_update": alf}
    return prefill, {**prefill, "flash_attention": 0}


def _cs_predict(cfg, bw: float):
    """The weights, init's peak, the serve run's cache (batch LM_BATCH,
    LM_PROMPT + LM_DECODE positions) and a decode step's byte bound, from
    the meta specs (``launch.specs``) before anything is made.

    Init holds the weights and one draw's temporaries: an embedding or
    head table drawn whole in float32 (4 bytes an element), or one
    period's slice of a stacked block leaf, drawn in float32 and cast
    before it is copied in (4 + the cast's bytes an element). A decode
    step reads every block's weights once per f-eval (n_steps + 1 a
    branch), the head and the final norm once and, in its attention,
    every f-eval's cache slot once."""
    from repro_torch import tree_util
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.specs import (param_specs, serve_state_specs,
                                          tree_bytes)
    params = param_specs(cfg)
    draws = [4 * t.numel() for t in tree_util.tree_leaves(
        {k: v for k, v in params.items() if k != "blocks"})]
    draws += [4 * t.numel() for t in tree_util.tree_leaves(
        params["blocks"].get("prelude", []))]
    draws += [(4 + t.element_size()) * t[0].numel()
              for t in tree_util.tree_leaves(
                  params["blocks"].get("period", {}))]
    cache = tree_bytes(serve_state_specs(cfg, ShapeCell(
        "serve", LM_PROMPT + LM_DECODE, LM_BATCH, "decode")))
    weights = tree_bytes(params)
    blocks = tree_bytes(params["blocks"])
    head = tree_bytes(params["head"] if "head" in params else
                      params["embed"]) + tree_bytes(params["final_norm"])
    read = (cfg.ode.n_steps + 1) * blocks + head
    return {"weights_bytes": weights, "init_bound_bytes": weights
            + max(draws) + CS_INIT_SLACK, "cache_bytes": cache,
            "decode_weight_bytes": read,
            "decode_weights_bound_ms": read / bw * 1e3,
            "decode_bound_ms": (read + cache) / bw * 1e3}


def phase_configs_serve(card: str, smi: str):
    """Phase 21: stablelm-1.6b, musicgen-large (the embeds path),
    deepseek-moe-16b and granite-20b at full width, one at a time, each
    with phase 11's checks (``_serve_cell``) and its memory predicted from
    the meta specs first; the kernel path against the plain one in bf16
    (deepseek route-aware, as phase 12) and in f32 (at 2 layers). Returns each config's launches per
    prefill and per decode step."""
    import torch
    from repro_torch.configs import DEFAULT_ODE, get_config
    t0 = time.perf_counter()
    bw, _, _ = card_rates(card)
    total = torch.cuda.get_device_properties(0).total_memory
    rows, launches = {}, {}
    for arch, f32_periods in CS_CONFIGS:
        t1 = time.perf_counter()
        cfg = get_config(arch, DEFAULT_ODE)
        want = _cs_predict(cfg, bw)
        fit = want["init_bound_bytes"] + want["cache_bytes"]
        require(fit <= CS_FIT * total,
                f"configs_serve {arch}: {fit} bytes predicted for a card of "
                f"{total}")
        per_prefill, per_decode = _cs_counts(arch)
        torch.cuda.empty_cache()
        _, fields, params = _serve_cell(arch, per_prefill, per_decode, arch)
        del params
        torch.cuda.empty_cache()
        require(fields["weights_bytes"] == want["weights_bytes"],
                f"configs_serve {arch}: {fields['weights_bytes']} bytes of "
                f"weights, the specs say {want['weights_bytes']}")
        require(fields["init_peak_bytes"] <= want["init_bound_bytes"],
                f"configs_serve {arch}: init peaked at "
                f"{fields['init_peak_bytes']} bytes, above the weights and "
                f"one draw's {want['init_bound_bytes']}")
        limit = (want["weights_bytes"] + want["cache_bytes"]
                 + fields["prefill_activation_bytes"] + CS_PEAK_SLACK)
        peak = fields["peak_memory_bytes"] - fields["serve_base_bytes"]
        require(peak <= limit,
                f"configs_serve {arch}: serve peaked at {peak} bytes, more "
                f"than the specs' weights and cache and one prefill's "
                f"{limit}")
        fields.update(want)
        fields["serve_peak_bytes"] = peak
        fields["peak_over_prediction_bytes"] = (
            peak - want["weights_bytes"] - want["cache_bytes"])
        fields["graph_to_decode_bound"] = (
            fields["graph_vs_eager"]["graph_ms_per_step"]
            / want["decode_weights_bound_ms"])
        serve_s = time.perf_counter() - t1
        if cfg.moe_experts:
            # bf16 routes flip at near-ties: phase 12's route-aware
            # checks. The prefill drops at capacity (64 experts, twice the
            # mean load): one more prompt token moves the ranks of every
            # token after it, so prefill(p + 1) = prefill(p) + decode holds
            # only on rows whose drops agree (none, on an H100). The f32
            # cut is run again with a capacity that drops nothing (factor
            # E / k: every expert takes every token), where it must hold
            # on every row.
            no_drop = cfg.moe_experts / cfg.moe_top_k
            fields["compare"] = [
                _ssm_compare(torch.bfloat16, cfg.n_periods, LM_BATCH,
                             LM_PROMPT, 4, arch),
                _ssm_compare(torch.float32, f32_periods, 2, 256, 4, arch,
                             consistent_rows=0),
                _ssm_compare(torch.float32, f32_periods, 2, 256, 4, arch,
                             moe_eval_capacity_factor=no_drop)]
        else:
            fields["compare"] = _compare_cells(arch,
                                               f32_periods=f32_periods)
        f32 = fields["compare"][1]
        fields["f32_cut"] = (
            f"{f32['n_layers']} of {cfg.n_layers} layers: " + (
                "time" if arch in CS_F32_FITS
                else f"{arch} does not fit in f32"))
        if cfg.d_model > 4096:
            # rmsnorm.cu takes f32 rows of more than 4096 elements through
            # its scalar kernel
            fields["f32_rmsnorm_kernel"] = (
                f"scalar (f32, d {cfg.d_model} > 4096): its first run at "
                "a model's shape")
        fields["serve_s"] = serve_s
        fields["config_s"] = time.perf_counter() - t1
        rows[arch] = fields
        launches[arch] = {"prefill": per_prefill, "decode": per_decode}
        emit({"phase": "configs_serve", "card": card, "nvidia_smi": smi,
              **fields})
    phase_s = time.perf_counter() - t0
    emit({"phase": "configs_serve", "card": card, "nvidia_smi": smi,
          "configs": list(rows), "phase_s": phase_s,
          "budget_s": CS_PHASE_S, "within_budget": phase_s <= CS_PHASE_S,
          "config_s": {a: r["config_s"] for a, r in rows.items()}})
    return launches


# ---------------------------------------------------------------------------
# Phase 22: tensor parallelism and FSDP, ranks sharing the one card
# ---------------------------------------------------------------------------

TP_DEVICE = "cuda:0"          # every rank on the one card (gloo)
# (a): granite-20b at full width, 2 of its 52 layers, bf16, on a
# (data 2, model 2) mesh: MQA 48/1 (wk/wv whole on every rank), FSDP
TP_ARCH, TP_LAYERS = "granite-20b", 2
TP_MESH = (2, 2)
TP_BATCH, TP_SEQ, TP_STEPS = 2, 1024, 2
TP_SEED = 11
TP_BYTES_RATIO = 0.30         # a rank's parameter + optimizer bytes / one's
# (b): deepseek-moe-16b at full width, its prelude and 1 MoE layer, f32,
# on (data 1, model 2): 32 of the 64 experts a rank, a capacity that
# drops nothing (>= E / top_k: every token fits every expert)
TP_MOE_ARCH, TP_MOE_MESH = "deepseek-moe-16b", (1, 2)
TP_MOE_BATCH, TP_MOE_SEQ = 2, 256
TP_MOE_CAPACITY = 64.0
TP_TIMEOUT = 300              # seconds the ranks of a part may take
TP_PHASE_S = 180.0            # the phase's budget
# what a rank may hold after a step beyond its parameter and optimizer
# shards: the cuBLAS and cuBLASLt workspaces a process makes at its
# first GEMM (64 MiB with PyTorch 2.11 on the H100) and the allocator's
# rounding (a granite layer's gathered leaves are 0.53 GB a rank, its
# MLP's leaves 151 MB each)
TP_RESIDENT_SLACK = 65 << 20
# the step's activations a rank, as this many float32 tensors of its
# tokens times its widest activation (max(d_model, d_ff / model,
# vocab / model))
TP_ACT_TENSORS = 8
# the update's temporaries: this many float32 copies of the largest leaf
# of a rank's optimizer state (AdamW's g, m, v, m-hat, v-hat and w of one
# leaf at a time)
TP_UPDATE_TEMPS = 8


def _tp_cfg(part: str):
    """(a)'s or (b)'s config: MALI, ConstantSteps(2), ALF(cuda)."""
    import dataclasses
    if part == "granite":
        return _lt_config("cuda", arch=TP_ARCH, layers=TP_LAYERS)
    cfg = _lt_config("cuda", arch=TP_MOE_ARCH, layers=1, dtype="float32")
    return dataclasses.replace(cfg, moe_capacity_factor=TP_MOE_CAPACITY)


def _tp_batch(part: str, cfg, step: int):
    if part == "granite":
        return _lt_batch(cfg, TP_BATCH, TP_SEQ, step)
    return _lt_batch(cfg, TP_MOE_BATCH, TP_MOE_SEQ, step)


def _tp_opt_cfg():
    from repro_torch.optim import OptimizerConfig
    return OptimizerConfig(warmup_steps=1, total_steps=TP_STEPS)


def _tp_bytes(tree) -> int:
    from repro_torch import tree_util
    return sum(t.numel() * t.element_size()
               for t in tree_util.tree_leaves(tree))


def _tp_rule_bytes(cfg, mesh, opt_cfg):
    """(parameter bytes, optimizer bytes) a rank holds by the rules,
    reckoned from the meta specs (launch/specs.py)."""
    import torch
    from repro_torch.distributed.sharding import (opt_state_shardings,
                                                  param_shardings,
                                                  shard_bytes)
    from repro_torch.launch.specs import param_specs
    from repro_torch.models.common import torch_dtype
    meta = param_specs(cfg)
    p_sh = param_shardings(cfg, mesh, meta)
    o_sh = opt_state_shardings(cfg, mesh, p_sh, meta)
    mom = torch_dtype(opt_cfg.momentum_dtype)
    return (shard_bytes(p_sh, meta, mesh),
            2 * shard_bytes(o_sh, meta, mesh, mom)
            + shard_bytes(o_sh, meta, mesh, torch.float32) + 4)


@contextlib.contextmanager
def _tp_memory_marks(log: list):
    """For the block, each train_step appends to ``log`` the device bytes
    allocated when its forward ends (what the backward will read) and
    the peaks of its forward, of its backward (up to the update) and of
    its update: train/loop.py's ``lm_loss_and_stats`` and
    ``apply_updates`` are wrapped to read the allocator's counters (host
    counters: no sync) and reset its peak."""
    import torch
    from repro_torch.train import loop
    fwd, upd = loop.lm_loss_and_stats, loop.apply_updates

    def mark(name):
        log.append((name, torch.cuda.memory_allocated(),
                    torch.cuda.max_memory_allocated()))
        torch.cuda.reset_peak_memory_stats()

    def forward(*a, **kw):
        out = fwd(*a, **kw)
        mark("forward")
        return out

    def update(*a, **kw):
        mark("backward")
        out = upd(*a, **kw)
        mark("update")
        return out

    loop.lm_loss_and_stats, loop.apply_updates = forward, update
    try:
        yield
    finally:
        loop.lm_loss_and_stats, loop.apply_updates = fwd, upd


def _tp_steps(part: str, params, plan=None) -> dict:
    """TP_STEPS chained train_steps (one for (b)) from ``params`` (the
    whole seeded weights on one rank, the rank's shards under ``plan``):
    each step's metrics, ALF launches, collectives, FSDP gathers, time,
    ODE end states and device memory (allocated before it, when its
    forward ends and after it; the peaks of its forward, backward and
    update), and (b)'s routes."""
    import torch
    from repro_torch.distributed.data_parallel import (
        collective_counts, reset_collective_counts)
    from repro_torch.distributed.tensor_parallel import recording_states
    from repro_torch.models.moe import recording_routes
    from repro_torch.optim import init_opt_state
    from repro_torch.train import train_step
    cfg, opt_cfg = _tp_cfg(part), _tp_opt_cfg()
    opt = init_opt_state(opt_cfg, params if plan is None
                         else plan.param_to_opt(params))
    out = {"param_bytes": _tp_bytes(params), "opt_bytes": _tp_bytes(opt),
           "metrics": [], "launches": [], "collectives": [], "step_ms": [],
           "states": [], "routes": None}
    out["memory"] = []
    marks = []
    mesh = contextlib.nullcontext() if plan is None else plan.mesh
    n_steps = TP_STEPS if part == "granite" else 1
    with mesh, _tp_memory_marks(marks):
        for step in range(n_steps):
            batch = _tp_batch(part, cfg, step)
            _lm_reset()
            reset_collective_counts()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            routes = (recording_routes() if part == "moe"
                      else contextlib.nullcontext([]))
            with recording_states() as states, routes as log:
                params, opt, _, m = train_step(
                    params, opt, None, batch, cfg=cfg, opt_cfg=opt_cfg,
                    zero1=plan is not None)
                metrics = {k: float(v) for k, v in m.items()}
            torch.cuda.synchronize()
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["metrics"].append(metrics)
            out["launches"].append({k: n for k, n in _lm_counts()[0].items()
                                    if n})
            out["collectives"].append(collective_counts())
            out["states"].append(_dp_checksums(states).tolist())
            if part == "moe":
                out["routes"] = [(r.idx.cpu().numpy(), r.kept.cpu().numpy())
                                 for r in log]
            # what stays of the step: the new shards and state, nothing
            # it gathered or computed
            del batch, states, log, m
            torch.cuda.synchronize()
            (_, fwd_end, fwd_peak), (_, _, bwd_peak), (_, _, upd_peak) = \
                marks[-3:]
            out["memory"].append({
                "before": before, "forward_end": fwd_end,
                "forward_peak": fwd_peak, "backward_peak": bwd_peak,
                "update_peak": upd_peak,
                "after": torch.cuda.memory_allocated()})
    out["peak_gb"] = max(max(m["forward_peak"], m["backward_peak"],
                             m["update_peak"])
                         for m in out["memory"]) / 1e9
    out["params"] = params
    return out


def _tp_memory_terms(cfg, plan, params, rows: int, seq: int) -> dict:
    """The terms of phase 22's memory bounds on a rank, reckoned from its
    shards and the config: ``gather``, the most one FSDP gather holds (a
    period's slice of every stacked leaf split over 'data', or one such
    unstacked leaf: the embedding, the head; each whole over 'data' and
    the rank's block over 'model'); ``activations``, TP_ACT_TENSORS
    float32 tensors of the rank's tokens times its widest activation;
    ``update_temps``, TP_UPDATE_TEMPS float32 copies of its largest
    optimizer-state leaf."""
    import torch
    layer, single = 0, [0]
    for (path, t), dim in zip(
            torch.utils._pytree.tree_flatten_with_path(params)[0],
            plan.fsdp_dims):
        if dim is None:
            continue
        whole = t.numel() * t.element_size() * plan.sizes["data"]
        if any(getattr(p, "key", None) == "period" for p in path):
            layer += whole // t.shape[0]
        else:
            single.append(whole)
    model = plan.sizes.get("model", 1) if plan.model is not None else 1
    rows_here = rows // max(plan.group.size, 1)
    width = max(cfg.d_model, cfg.d_ff // model, cfg.vocab_size // model)
    from repro_torch import tree_util
    largest = max(t.numel() for t in
                  tree_util.tree_leaves(plan.param_to_opt(params)))
    return {"gather": max(layer, max(single)),
            "activations": TP_ACT_TENSORS * rows_here * seq * width * 4,
            "update_temps": TP_UPDATE_TEMPS * largest * 4}


def _tp_init(part: str):
    """The seeded whole weights of a part's config on the card."""
    import torch
    from repro_torch.models import init_lm
    cfg = _tp_cfg(part)
    return cfg, init_lm(torch.Generator(device="cuda").manual_seed(TP_SEED),
                        cfg, TP_DEVICE)


def _tp_rank(argv) -> int:
    """One rank of phase 22: ``chip_smoke.py --tp-rank PART RANK WORLD
    DIR``."""
    part, rank, world, d = argv[0], int(argv[1]), int(argv[2]), Path(argv[3])
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(torch.device(TP_DEVICE))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(d / f"store_{part}"), world), rank=rank, world_size=world)
    try:
        from repro_torch import tree_util
        from repro_torch.distributed.data_parallel import DataParallel
        t0 = time.perf_counter()
        shape = TP_MESH if part == "granite" else TP_MOE_MESH
        mesh = init_device_mesh("cuda", shape,
                                mesh_dim_names=("data", "model"))
        cfg, whole = _tp_init(part)
        plan = DataParallel(cfg, mesh, whole)
        require(plan.checksum_equal(whole), "tp_train: the ranks' seeded "
                "weights differ")
        start = [plan.param_shards(whole)]
        whole_bytes = _tp_bytes(whole)
        del whole
        torch.cuda.empty_cache()
        # handed over (no reference kept here): the first step frees them
        out = _tp_steps(part, start.pop(), plan)
        params = out.pop("params")
        rule = _tp_rule_bytes(cfg, mesh, _tp_opt_cfg())
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        # every leaf's checksum, with the axes its block is split over
        leaves = tree_util.tree_leaves(params)
        out["leaf_sums"] = [_dp_checksums([t]).tolist() for t in leaves]
        out["leaf_split"] = [sorted({a for _, names in lay.param
                                     for a in names})
                             for lay in plan.leaves]
        out.update(coord=coord, rule_param_bytes=rule[0],
                   rule_opt_bytes=rule[1], whole_param_bytes=whole_bytes,
                   n_fsdp=plan.n_fsdp, rank_s=time.perf_counter() - t0,
                   memory_terms=_tp_memory_terms(
                       cfg, plan, params,
                       TP_BATCH if part == "granite" else TP_MOE_BATCH,
                       TP_SEQ if part == "granite" else TP_MOE_SEQ))
        instances = 0
        for (path, t), dim in zip(
                torch.utils._pytree.tree_flatten_with_path(params)[0],
                plan.fsdp_dims):
            if dim is not None:
                stacked = any(getattr(p, "key", None) == "period"
                              for p in path)
                instances += t.shape[0] if stacked else 1
        out["gather_instances"] = instances
        routes = out.pop("routes")
        if routes is not None:
            np.savez(d / f"routes_{rank}.npz",
                     **{f"idx_{i}": a for i, (a, _) in enumerate(routes)},
                     **{f"kept_{i}": b for i, (_, b) in enumerate(routes)})
            out["route_calls"] = len(routes)
        (d / f"{part}_rank{rank}.json").write_text(json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _tp_start(part: str, d: Path, world: int) -> dict:
    """Start a part's ranks."""
    import os
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    logs = [open(d / f"{part}_rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--tp-rank", part, str(r), str(world),
                               str(d)], cwd=str(HERE), env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    return {"procs": procs, "logs": logs,
            "deadline": time.monotonic() + TP_TIMEOUT}


def _tp_stop(started: dict) -> None:
    for p in started["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in started["logs"]:
        f.close()


def _tp_wait(part: str, d: Path, started: dict):
    """Wait for a part's ranks (started by _tp_start); their results."""
    procs = started["procs"]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, started["deadline"] - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        _tp_stop(started)
    for r, p in enumerate(procs):
        require(p.returncode == 0, f"tp_train {part}: rank {r} failed "
                f"(exit {p.returncode}): "
                f"{(d / f'{part}_rank{r}.log').read_text()[-3000:]}")
    return [json.loads((d / f"{part}_rank{r}.json").read_text())
            for r in range(len(procs))]


def _tp_one_rank(part: str) -> dict:
    """A part's steps on one rank (this process), the ranks' oracle."""
    import torch
    out = _tp_steps(part, _tp_init(part)[1])
    out.pop("params")
    torch.cuda.empty_cache()
    return out


def _tp_check_steps(part: str, ranks, one, tol: float) -> dict:
    """Hold each rank's steps to the one-rank run's."""
    worst = {"loss": 0.0, "grad_norm": 0.0}
    for r, got in enumerate(ranks):
        for step, (g, w) in enumerate(zip(got["metrics"], one["metrics"])):
            for k in worst:
                worst[k] = max(worst[k], _dp_rel(g[k], w[k]))
            require(g["lr"] == w["lr"], f"tp_train {part} rank {r} step "
                    f"{step}: lr {g['lr']} != {w['lr']}")
            for k in ("ode_accepted", "ode_rejected", "ode_fevals"):
                require(g[k] == w[k], f"tp_train {part} rank {r}: {k}")
        for step, launches in enumerate(got["launches"]):
            require(launches == one["launches"][step], f"tp_train {part} "
                    f"rank {r} step {step}: ALF launches {launches}, one "
                    f"rank {one['launches'][step]}")
        require(got["param_bytes"] == got["rule_param_bytes"]
                and got["opt_bytes"] == got["rule_opt_bytes"],
                f"tp_train {part} rank {r}: holds {got['param_bytes']} + "
                f"{got['opt_bytes']} bytes, the rule reckons "
                f"{got['rule_param_bytes']} + {got['rule_opt_bytes']}")
    require(max(worst.values()) <= tol, f"tp_train {part}: the ranks "
            f"against one rank: {worst} (tolerance {tol})")
    # the ODE states bit-equal on the ranks of a 'model' group (the same
    # rows), every leaf's block bit-equal on the ranks that hold it
    for r, got in enumerate(ranks):
        for q, other in enumerate(ranks):
            if got["coord"]["data"] == other["coord"]["data"]:
                require(got["states"] == other["states"], f"tp_train "
                        f"{part}: ranks {r} and {q}'s ODE states differ")
            for i, split in enumerate(got["leaf_split"]):
                if all(got["coord"][a] == other["coord"][a]
                       for a in split):
                    require(got["leaf_sums"][i] == other["leaf_sums"][i],
                            f"tp_train {part}: leaf {i} differs on ranks "
                            f"{r} and {q}")
    return worst


def _tp_check_memory(r: int, got: dict) -> None:
    """FSDP frees what it gathers, on rank ``r`` of (a). Each bound is
    what the rank held before the step plus TP_RESIDENT_SLACK (the
    workspaces the first step makes) plus:

    * after the step: nothing (it holds its new parameter and optimizer
      shards, as many bytes as the old);
    * when the forward ends: the activations the backward reads (MALI
      saves each branch's states, not a layer's gathered leaves);
    * the forward's and the backward's peak: its gradients (one copy of
      its parameter shards), four gathers' bytes (a layer's leaves
      gathered again for the backward, MALI's gradient accumulator over
      them, one f-VJP's gradient and their sum) and the activations;
    * the update's peak: the clipped gradients beside the gradients, the
      new shards and state beside the old, and the update's
      temporaries.

    A layer's gathered leaves kept by the forward would show at its end,
    and, with their gradient, at the backward's peak."""
    terms = got["memory_terms"]
    shards = got["param_bytes"] + got["opt_bytes"]
    for step, m in enumerate(got["memory"]):
        where = f"tp_train (a) rank {r} step {step}: {m}, {terms}"
        base = m["before"] + TP_RESIDENT_SLACK
        require(m["after"] <= base and m["after"] - shards
                <= TP_RESIDENT_SLACK, f"{where}: "
                f"{m['after'] - shards} bytes beyond the shards stay "
                f"after the step")
        require(m["forward_end"] <= base + terms["activations"],
                f"{where}: the forward keeps more than its activations")
        compute = (base + got["param_bytes"] + 4 * terms["gather"]
                   + terms["activations"])
        require(max(m["forward_peak"], m["backward_peak"]) <= compute,
                f"{where}: the forward/backward peak exceeds {compute}")
        update = (base + 2 * got["param_bytes"] + shards
                  + terms["update_temps"])
        require(m["update_peak"] <= update,
                f"{where}: the update's peak exceeds {update}")


def _tp_granite(one: dict, ranks, one_s: float) -> dict:
    """(a)'s checks: the four ranks against the one-rank run."""
    world = TP_MESH[0] * TP_MESH[1]
    worst = _tp_check_steps("granite", ranks, one, LT_BF16_TOL)
    one_bytes = one["param_bytes"] + one["opt_bytes"]
    for r, got in enumerate(ranks):
        mine = got["param_bytes"] + got["opt_bytes"]
        require(mine <= TP_BYTES_RATIO * one_bytes, f"tp_train (a) rank {r}"
                f": {mine} bytes against {one_bytes} on one rank")
        require(got["peak_gb"] < one["peak_gb"], f"tp_train (a) rank {r}: "
                f"peak {got['peak_gb']} GB, one rank {one['peak_gb']} GB")
        _tp_check_memory(r, got)
        for step, col in enumerate(got["collectives"]):
            gathers = col["fsdp_gathers"]
            require(gathers["forward"] == got["gather_instances"]
                    and 0 < gathers["backward"]
                    <= got["gather_instances"], f"tp_train (a) rank {r} "
                    f"step {step}: FSDP gathers {gathers} for "
                    f"{got['gather_instances']} (leaf, layer) instances")
    keep = ("step_ms", "peak_gb", "param_bytes", "opt_bytes",
            "rule_param_bytes", "rule_opt_bytes", "collectives",
            "launches", "coord", "gather_instances", "n_fsdp", "rank_s",
            "memory", "memory_terms")
    return {"config": {"arch": TP_ARCH, "layers": f"{TP_LAYERS} of 52",
                       "d_model": 6144, "heads": "48 / 1 (MQA), d 128",
                       "d_ff": 24576, "vocab": 49152, "dtype": "bfloat16",
                       "mesh": {"data": TP_MESH[0], "model": TP_MESH[1]},
                       "ranks": world, "backend": "gloo, one card",
                       "global_batch": TP_BATCH, "seq_len": TP_SEQ,
                       "steps": TP_STEPS,
                       "ode": "MALI, ALF(cuda), ConstantSteps(2)",
                       "optimizer": "AdamW, warmup 1 of 2 steps"},
            "rel": worst, "tolerance": LT_BF16_TOL,
            "ranks_metrics": ranks[0]["metrics"],
            "one_rank": {k: one[k] for k in ("metrics", "step_ms", "peak_gb",
                                             "param_bytes", "opt_bytes",
                                             "launches", "memory")},
            "bytes_ratio": [(g["param_bytes"] + g["opt_bytes"]) / one_bytes
                            for g in ranks],
            "ranks": [{k: g[k] for k in keep} for g in ranks],
            "one_rank_s": one_s}


def _tp_moe(d: Path, one: dict, ranks) -> dict:
    """(b)'s checks: deepseek-moe-16b's routes on two ranks against one
    rank's."""
    world = TP_MOE_MESH[0] * TP_MOE_MESH[1]
    worst = _tp_check_steps("moe", ranks, one, LT_F32_TOL)
    calls = len(one["routes"])
    differ = []
    for r in range(world):
        require(ranks[r]["route_calls"] == calls, f"tp_train (b) rank {r}: "
                f"{ranks[r]['route_calls']} MoE calls against {calls}")
        with np.load(d / f"routes_{r}.npz") as f:
            for i, (idx, kept) in enumerate(one["routes"]):
                # a token's route: its experts (as a set) and their kept
                mine = np.sort(f[f"idx_{i}"], -1)
                want = np.sort(idx, -1)
                differ.append(int((mine != want).any(-1).sum()
                                  + (f[f"kept_{i}"] != kept).any(-1).sum()))
    require(not any(differ), f"tp_train (b): tokens whose routes differ "
            f"from the one-rank run's, by rank and call: {differ} of "
            f"{TP_MOE_BATCH * TP_MOE_SEQ}")
    require(all(k.all() for _, k in one["routes"]), "tp_train (b): a "
            "(token, choice) was dropped")
    return {"config": {"arch": TP_MOE_ARCH, "layers": "prelude + 1 MoE",
                       "dtype": "float32", "experts_a_rank": 32,
                       "capacity_factor": TP_MOE_CAPACITY,
                       "mesh": {"data": TP_MOE_MESH[0],
                                "model": TP_MOE_MESH[1]},
                       "global_batch": TP_MOE_BATCH,
                       "seq_len": TP_MOE_SEQ},
            "rel": worst, "tolerance": LT_F32_TOL, "route_calls": calls,
            "routes_checked": calls * TP_MOE_BATCH * TP_MOE_SEQ,
            "ranks": [{k: g[k] for k in ("step_ms", "peak_gb",
                                         "param_bytes", "opt_bytes",
                                         "collectives", "rank_s")}
                      for g in ranks],
            "one_rank": {k: one[k] for k in ("metrics", "step_ms",
                                             "peak_gb", "param_bytes")}}


def _tp_cli(res) -> dict:
    """(c), run by phase_clis: the training CLI, deepseek-moe's smoke
    config on two ranks of one card (the host mesh (2, 1))."""
    require(res.returncode == 0 and res.stdout.count("final_step=3") == 1,
            f"tp_train (c): the CLI failed: {res.stdout[-2000:]}"
            f"{res.stderr[-3000:]}")
    return {"cli_s": res.s,
            "losses": [json.loads(line)["loss"] for line in
                       res.stdout.splitlines() if line.startswith("{")]}


def phase_tp_train(card: str, smi: str):
    """Phase 22: tensor parallelism over 'model' and FSDP over 'data' on
    ranks sharing the card (gloo): (a) granite-20b at full width on a
    (2, 2) mesh, (b) deepseek-moe-16b's routes on (1, 2); (c), the CLI,
    runs in phase_clis. Returns the ALF launches of one step of (a) on a
    rank."""
    import tempfile

    import torch
    t0 = time.perf_counter()
    parts = {}

    def lap(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        d = Path(tmp)
        # the one-rank oracles here, then (b)'s two ranks beside (a)'s
        # four: one spawn, whose start-up and gloo waits overlap
        one_granite = _tp_one_rank("granite")
        lap("a_one_rank")
        one_moe = _tp_one_rank("moe")
        torch.cuda.empty_cache()
        lap("b_one_rank")
        started = {"granite": _tp_start("granite", d, TP_MESH[0] * TP_MESH[1]),
                   "moe": _tp_start("moe", d,
                                    TP_MOE_MESH[0] * TP_MOE_MESH[1])}
        try:
            ranks = {part: _tp_wait(part, d, started[part])
                     for part in ("granite", "moe")}
        finally:
            for st in started.values():
                _tp_stop(st)
        lap("ab_ranks")
        granite = _tp_granite(one_granite, ranks["granite"],
                              parts["a_one_rank"])
        moe = _tp_moe(d, one_moe, ranks["moe"])
        torch.cuda.empty_cache()
        lap("ab_checks")
    phase_s = time.perf_counter() - t0
    emit({"phase": "tp_train", "card": card, "nvidia_smi": smi,
          "granite": granite, "moe": moe, "part_s": parts,
          "phase_s": phase_s, "budget_s": TP_PHASE_S,
          "within_budget": phase_s <= TP_PHASE_S})
    return granite["ranks"][0]["launches"][0]


# ---------------------------------------------------------------------------
# Phase 24: LM serving on the JAX package's meshes, ranks sharing the card
# ---------------------------------------------------------------------------

# Each part: a config at full width cut in depth, its dtype, its mesh
# (data, model), its global batch, prompt and decode tokens. Every rank
# draws its shards of the seeded weights leaf by leaf (init_lm's cut):
# it holds its shards plus one whole leaf at a time, never the model.
TPS_PARTS = {
    # (a) FSDP over 'data', the rows over 'data', MQA 48/1 (the cache's
    # d_head over 'model': layout (c)), the head split on the vocabulary
    "granite": dict(arch="granite-20b", layers=2, dtype="bfloat16",
                    mesh=(2, 2), batch=4, prompt=1024, decode=16),
    # (b) one Mamba layer (with a 16-expert MoE: 8 a rank) and one
    # attention layer (32/8 heads, KV heads over 'model': layout (b)); the
    # scan on d_inner 4096 of 8192 a rank
    "jamba": dict(arch="jamba-v0.1-52b", layers=1, dtype="float32",
                  mesh=(1, 2), batch=2, prompt=512, decode=8,
                  period=(("mamba", "moe"), ("attn", "dense"))),
    # (c) batch 1: the KV sequence split over 'data' (layout (d)),
    # weights replicated ('dp')
    "qwen3": dict(arch="qwen3-1.7b", layers=8, dtype="bfloat16",
                  mesh=(2, 1), batch=1, prompt=1024, decode=8),
    # (d) one mLSTM and the sLSTM layer: the rule splits every LSTM cache
    # over 'model' on the heads (4 heads, 2 a rank) while the mixers
    # compute whole from the weights it replicates, so each decode f-eval
    # gathers its slot's state; a batch of 3 does not divide this pure-DP
    # config's ('data', 'model'), so the rows are not split
    "xlstm": dict(arch="xlstm-125m", layers=1, dtype="float32",
                  mesh=(1, 2), batch=3, prompt=64, decode=4,
                  period=(("mlstm", "none"), ("slstm", "none")),
                  tokens_equal=True),
}
# the parts one spawn of rank processes serves, one after another (a
# process takes ~10 s to start and ~10 s more for its first serve plan:
# the meta specs' first imports)
TPS_GROUPS = (("granite",), ("jamba", "qwen3", "xlstm"))
TPS_SEED = 13
TPS_TIMEOUT = 240             # seconds the ranks of a part may take
TPS_PHASE_S = 120.0           # the phase's budget
# f32 logits against one rank's: rtol 1e-5, or 3x the model's own floor
# (the one-rank run with the embedding moved by one rounding) where larger
TPS_F32_TOL = 1e-5


def _tps_cfg(part: str):
    """A part's config: DEFAULT_ODE (MALI, ALF, ConstantSteps(2)) on the
    kernel path, at full width, cut in depth."""
    import dataclasses
    from repro_torch.configs import DEFAULT_ODE, LayerSpec, get_config
    p = TPS_PARTS[part]
    changes = dict(n_periods=p["layers"], param_dtype=p["dtype"],
                   compute_dtype=p["dtype"])
    if "period" in p:
        changes["period"] = tuple(LayerSpec(mixer=m, mlp=f)
                                  for m, f in p["period"])
    return dataclasses.replace(get_config(p["arch"], DEFAULT_ODE), **changes)


def _tps_sizes(part: str) -> dict:
    return dict(zip(("data", "model"), TPS_PARTS[part]["mesh"]))


def _tps_serve(params, cfg, toks, prompt: int, n_decode: int,
               greedy: bool = False):
    """prefill + n_decode eager decode steps of ``toks`` (under the
    ambient mesh, if any), teacher-forced on ``toks`` [B, prompt +
    n_decode] or, ``greedy``, each step's input the argmax of the logits
    before it (``toks`` the prompt): the input tokens, logits per step,
    each step's LM kernel launches, collectives, ALF end states'
    checksums and ms, the MoE routes, and the bytes allocated after
    prefill."""
    import torch
    from repro_torch.distributed.data_parallel import (
        collective_counts, reset_collective_counts)
    from repro_torch.distributed.tensor_parallel import recording_states
    from repro_torch.models import decode_step, init_serve_state, prefill
    from repro_torch.models.moe import recording_routes
    out = {"logits": [], "launches": [], "collectives": [], "ms": [],
           "states": []}
    state = init_serve_state(cfg, toks.shape[0], prompt + n_decode)
    out["cache_bytes"] = _tp_bytes(state.cache)
    with recording_routes() as routes:
        for step in range(n_decode + 1):
            _lm_reset()
            reset_collective_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with recording_states() as states:
                if step == 0:
                    lg, state = prefill(params, cfg,
                                        _prompt(cfg, toks[:, :prompt]), state)
                else:
                    at = prompt + step - 1
                    if greedy:
                        toks = torch.cat([toks, torch.argmax(
                            out["logits"][-1][:, -1], -1)[:, None]], 1)
                    lg, state = decode_step(params, cfg,
                                            toks[:, at:at + 1], state)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["logits"].append(lg)
            out["launches"].append({k: n for k, n in _lm_counts()[0].items()
                                    if n})
            out["collectives"].append(collective_counts())
            out["states"].append(_dp_checksums(states).tolist())
            del states      # the recorded branch states are the harness's
            if step == 0:
                out["allocated_after_prefill"] = torch.cuda.memory_allocated()
    out["routes"] = list(routes)
    out["tokens"] = toks
    return out


def _tps_reckon(cfg, sizes: dict, batch: int, s_max: int, kind: str):
    """The collectives a rank makes in one prefill or decode step (calls
    by ``kind@axis``) and its FSDP gathers, reckoned from the rules and
    the serve path's design (PERF.md): a rank's rows are the cache's
    batch axes; an f-eval of a mixer or MLP split over 'model' leaves
    through one all-reduce; layout (c)'s decode gathers q and the output
    and sums the scores over 'model'; layout (d)'s decode gathers the
    partials over 'data'; Mamba gathers its in-projection's columns; the
    MoE gathers the expert ids over the rows' group; an LSTM mixer's
    decode f-eval gathers each cache leaf the rule splits over 'model';
    FSDP gathers each leaf split over 'data' once a layer (the embedding,
    read by tokens, and the head once a step); the logits are gathered
    over 'model' and over the rows."""
    from collections import Counter

    import torch.utils._pytree as _pt
    from repro_torch.distributed.sharding import (_cache_batch_axes,
                                                  _path_names,
                                                  cache_leaf_spec,
                                                  param_shardings)
    from repro_torch.launch.specs import param_specs
    from repro_torch.models.transformer import n_cache_slots
    from repro_torch.models.xlstm import LstmCache
    m = sizes.get("model", 1)
    f = cfg.ode.n_steps + 1 if cfg.ode.mode != "off" else 1
    rows = tuple(a for a in (_cache_batch_axes(cfg, sizes, batch) or ())
                 if sizes[a] > 1)
    rows_axis = "+".join(rows)
    tp_w = cfg.sharding != "dp" and m > 1
    tp_c = m > 1 and "model" not in rows
    kv = cache_leaf_spec(cfg, sizes, "k", (n_cache_slots(cfg), batch, s_max,
                                           cfg.n_kv_heads, cfg.d_head), batch)
    seq, heads, d_split = kv[2] == "data", kv[3] == "model", \
        kv[4] == "model"
    n = Counter()
    gathers = 0
    meta = param_specs(cfg)
    for (path, leaf), spec in zip(
            _pt.tree_flatten_with_path(meta)[0],
            _pt.tree_leaves(param_shardings(cfg, sizes, meta))):
        names = _path_names(path)
        data = any("data" in ((e,) if isinstance(e, str) else (e or ()))
                   for e in spec) and sizes.get("data", 1) > 1
        if not data or (names == ("embed",) and cfg.input_mode == "embeds"):
            continue
        gathers += leaf.shape[0] if "period" in names else 1
    n["all_gather@data"] += gathers
    if cfg.input_mode != "embeds" and tp_w and cfg.d_model % m == 0:
        n["all_gather@model"] += 1
    h, dh = cfg.n_heads, cfg.d_head
    d_inner = cfg.mamba_expand * cfg.d_model
    for spec in cfg.prelude + cfg.period * cfg.n_periods:
        if spec.mixer == "attn" and (tp_w or tp_c):
            q_local = (tp_w and h % m == 0) or heads
            o_local = tp_w and (h * dh) % m == 0
            if q_local or o_local or heads:
                n["all_reduce@model"] += f
            if kind == "decode" and d_split:
                n["all_reduce@model"] += f
                n["all_gather@model"] += f * (2 if q_local else 1)
        if spec.mixer == "attn" and kind == "decode" and seq:
            n["all_gather@data"] += f
        if spec.mixer in ("mlstm", "slstm") and tp_c and kind == "decode":
            for name, shape in zip(LstmCache._fields, LstmCache.shapes(
                    cfg, spec.mixer == "mlstm", batch)):
                leaf = cache_leaf_spec(cfg, sizes, name,
                                       (n_cache_slots(cfg), *shape), batch)
                if "model" in leaf:
                    n["all_gather@model"] += f
        if spec.mixer == "mamba" and tp_c and d_inner % m == 0:
            n["all_reduce@model"] += 2 * f
            if tp_w:
                n["all_gather@model"] += f
        if spec.mlp == "dense" and tp_w and cfg.d_ff % m == 0:
            n["all_reduce@model"] += f
        if spec.mlp == "moe":
            if rows:
                n[f"all_gather@{rows_axis}"] += f
            dff = cfg.moe_d_ff or cfg.d_ff
            if tp_w and (cfg.moe_experts % m == 0 or dff % m == 0):
                n["all_reduce@model"] += f
    if cfg.tie_embeddings:
        if tp_w and cfg.d_model % m == 0:
            n["all_reduce@model"] += 1
    elif tp_w and cfg.vocab_size % m == 0:
        n["all_gather@model"] += 1
    if rows:
        n[f"all_gather@{rows_axis}"] += 1
    return {k: v for k, v in n.items() if v}, gathers


def _tps_rank(argv) -> int:
    """One rank of phase 24: ``chip_smoke.py --tps-rank PART[,PART] RANK
    WORLD DIR``, the parts one after another in this process (each on its
    own mesh over the same ranks). The process starts with the others of
    the phase and makes its first part's mesh and serve plan at once; it
    touches the card when ``DIR/go_PART`` (its first part) appears."""
    parts, rank, world, d = (argv[0].split(","), int(argv[1]),
                             int(argv[2]), Path(argv[3]))
    start = time.time()
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(torch.device(TP_DEVICE))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(d / f"store_{parts[0]}"), world), rank=rank, world_size=world)
    try:
        for i, part in enumerate(parts):
            go = d / f"go_{parts[0]}" if i == 0 else None
            out = _tps_rank_part(part, rank, d, go,
                                 d / f"ready_{parts[0]}_{rank}")
            out["wall"]["start"] = start
            (d / f"{part}_rank{rank}.json").write_text(json.dumps(out))
            torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _tps_rank_part(part: str, rank: int, d: Path, go=None,
                   ready=None) -> dict:
    """One part on this rank: its mesh and serve plan (then ``ready`` is
    made), then (once ``go`` exists, if given) its shards drawn leaf by
    leaf and the teacher-forced serve (``_tps_serve``) on the part's
    mesh."""
    import torch
    import torch.utils._pytree as _pt
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.data_parallel import serve_plan_for
    from repro_torch.distributed.sharding import _path_names
    from repro_torch.launch.serve import make_decode_step
    from repro_torch.launch.specs import param_specs, serve_shard_bytes
    from repro_torch.models import init_lm
    p = TPS_PARTS[part]
    cfg = _tps_cfg(part)
    mesh = init_device_mesh("cuda", p["mesh"],
                            mesh_dim_names=("data", "model"))
    t0 = time.perf_counter()
    with mesh:
        plan = serve_plan_for(cfg, mesh, p["batch"])
        wall = {"plan_s": time.perf_counter() - t0, "planned": time.time()}
        ready.touch()
        while go is not None and not go.exists():
            time.sleep(0.05)
        wall["ready"] = time.time()
        toks = torch.load(d / f"{part}_tokens.pt").to(TP_DEVICE)
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        params = init_lm(torch.Generator(device="cuda").manual_seed(
            TPS_SEED), cfg, TP_DEVICE, cut=plan.cut)
        torch.cuda.synchronize()
        init_peak = torch.cuda.max_memory_allocated()
        init_s = time.perf_counter() - t0
        out = _tps_serve(params, cfg, toks, p["prompt"], p["decode"])
        wall["served"] = time.time()
        # a decode graph over these gloo ranks is refused, not skipped
        try:
            make_decode_step(cfg, capture=True)(params, toks[:, :1], None)
            out["capture_refused"] = ""
        except NotImplementedError as e:
            out["capture_refused"] = str(e)
    rule = serve_shard_bytes(cfg, mesh, p["batch"],
                             p["prompt"] + p["decode"])
    largest = max(
        t.numel() // (t.shape[0] if "period" in _path_names(path) else 1)
        for path, t in _pt.tree_flatten_with_path(param_specs(cfg))[0])
    out.pop("tokens")
    logits = out.pop("logits")
    if rank == 0:
        torch.save([lg.cpu() for lg in logits], d / f"{part}_logits.pt")
    out["logits_sums"] = _dp_checksums(logits).tolist()
    routes = out.pop("routes")
    if routes:
        np.savez(d / f"{part}_routes_{rank}.npz",
                 **{f"idx_{i}": r.idx.cpu().numpy()
                    for i, r in enumerate(routes)},
                 **{f"kept_{i}": r.kept.cpu().numpy()
                    for i, r in enumerate(routes)})
    out.update(coord=dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())),
               param_bytes=_tp_bytes(params), rule=rule,
               init_peak=init_peak, init_s=init_s, largest_leaf=largest,
               element_size=params["embed"].element_size(),
               row_axes=list(plan.row_axes), route_calls=len(routes),
               rank_s=time.perf_counter() - t0, wall=wall)
    return out


def _tps_start(parts, d: Path) -> dict:
    """Start the rank processes of ``parts`` (one mesh size: the same
    processes serve them one after another); they wait for
    ``go_PART``."""
    import os
    shape = TPS_PARTS[parts[0]]["mesh"]
    world = shape[0] * shape[1]
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    logs = [open(d / f"{parts[0]}_rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--tps-rank", ",".join(parts), str(r),
                               str(world), str(d)], cwd=str(HERE), env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    return {"parts": parts, "world": world, "procs": procs, "logs": logs,
            "spawned": time.time()}


def _tps_stop(started: dict) -> None:
    for p in started["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in started["logs"]:
        f.close()


def _tps_go(started: dict, d: Path) -> None:
    """Let a group of rank processes touch the card."""
    (d / f"go_{started['parts'][0]}").touch()
    started["went"] = time.time()


def _tps_wait_ready(started: dict, d: Path) -> None:
    """Until every rank of a group has made its serve plan (or one has
    ended)."""
    deadline = time.monotonic() + TPS_TIMEOUT
    marks = [d / f"ready_{started['parts'][0]}_{r}"
             for r in range(started["world"])]
    while (not all(m.exists() for m in marks)
           and all(p.poll() is None for p in started["procs"])
           and time.monotonic() < deadline):
        time.sleep(0.05)


def _tps_finish(started: dict, d: Path) -> dict:
    """Wait for a group of rank processes (let go); returns each part's
    rank results."""
    parts, world, procs = (started["parts"], started["world"],
                           started["procs"])
    went = started["went"]
    deadline = time.monotonic() + TPS_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        _tps_stop(started)
    ended = time.time()
    for r, p in enumerate(procs):
        require(p.returncode == 0, f"tp_serve {'+'.join(parts)}: rank {r} "
                f"failed (exit {p.returncode}): "
                f"{(d / f'{parts[0]}_rank{r}.log').read_text()[-3000:]}")
    out = {}
    for part in parts:
        out[part] = [json.loads((d / f"{part}_rank{r}.json").read_text())
                     for r in range(world)]
        for g in out[part]:
            w = g["wall"]
            # seconds from the spawn to the process's start and to its
            # serve plan's end; from the go to the part's start; from the
            # part's serve to the exit
            g["startup_s"] = [w["start"] - started["spawned"],
                              w["planned"] - started["spawned"],
                              max(0.0, w["ready"] - went),
                              ended - w["served"]]
    return out


def _tps_kernel_checks(part: str, gen) -> dict:
    """The kernels at the shapes a rank of the part gives them, against
    their plain versions: flash on the rank's query and KV heads over its
    rows, the scan on its block of d_inner (one layer's prefill)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    cfg, p = _tps_cfg(part), TPS_PARTS[part]
    sizes = _tps_sizes(part)
    m = sizes["model"]
    rows = p["batch"] // (sizes["data"] if p["batch"] % sizes["data"] == 0
                          and sizes["data"] > 1 else 1)
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if m > 1 and h % m == 0:
        h, kv = h // m, (kv // m if kv % m == 0 else 1)
    dtype = getattr(torch, p["dtype"])
    out = {}
    if any(s.mixer == "attn" for s in cfg.prelude + cfg.period):
        q = torch.randn(rows, p["prompt"], h, cfg.d_head, generator=gen,
                        device="cuda").to(dtype)
        k = torch.randn(rows, p["prompt"], kv, cfg.d_head, generator=gen,
                        device="cuda").to(dtype)
        v = torch.randn(rows, p["prompt"], kv, cfg.d_head, generator=gen,
                        device="cuda").to(dtype)
        got = fa_ops.flash_attention(q, k, v, causal=True)
        want = fa_ref.attention_ref(q, k, v, causal=True)
        torch.cuda.synchronize()
        rtol, atol = FA_TOL[p["dtype"]]
        out["flash_attention"] = {
            "shape": [rows, p["prompt"], h, kv, cfg.d_head],
            "max_abs_err": _close(got, want, rtol, atol,
                                  f"tp_serve {part} flash at the rank's "
                                  "heads")}
    if any(s.mixer == "mamba" for s in cfg.period):
        worst = {}
        di = cfg.mamba_expand * cfg.d_model // m
        from repro_torch.kernels.mamba_scan import ops as ms_ops
        from repro_torch.kernels.mamba_scan import ref as ms_ref
        args = _scan_inputs(gen, rows, p["prompt"], di, cfg.mamba_d_state,
                            dtype)
        got, want = ms_ops.selective_scan(*args), \
            ms_ref.selective_scan_ref(*args)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("y", "h")):
            worst[name] = _close(g, w, *MS_TOL,
                                 f"tp_serve {part} scan {name} at d_inner "
                                 f"{di}")
        require(worst["h"] == 0.0, f"tp_serve {part}: the scan's h at the "
                f"rank's d_inner is not bit-equal ({worst['h']})")
        out["selective_scan"] = {"shape": [rows, p["prompt"], di,
                                           cfg.mamba_d_state],
                                 "max_abs_err": worst}
    return out


def _tps_reference(part: str, d: Path) -> dict:
    """A part's one-rank run (and, in f32, its floor) and the kernels at
    the rank's shapes; the greedy tokens saved for the ranks."""
    import torch
    from repro_torch.models import init_lm
    p = TPS_PARTS[part]
    cfg = _tps_cfg(part)
    sizes = _tps_sizes(part)
    s_max = p["prompt"] + p["decode"]
    f32 = p["dtype"] == "float32"
    t0 = time.perf_counter()
    params = init_lm(torch.Generator(device="cuda").manual_seed(TPS_SEED),
                     cfg, "cuda")
    # one rank decodes greedily; the ranks and the floor's run are
    # teacher-forced on its tokens
    one = _tps_serve(params, cfg, _lm_inputs(cfg, p["batch"], p["prompt"],
                                             TPS_SEED),
                     p["prompt"], p["decode"], greedy=True)
    toks = one.pop("tokens")
    floor = None
    if f32:
        moved = _tps_serve(_moved(params, torch.float32), cfg, toks,
                           p["prompt"], p["decode"])
        floor = max(_rel(a, b) for a, b in zip(moved["logits"],
                                                one["logits"]))
    kernels = _tps_kernel_checks(
        part, torch.Generator(device="cuda").manual_seed(TPS_SEED))
    one_bytes = _tp_bytes(params)
    one_logits = [lg.cpu() for lg in one.pop("logits")]
    one_routes = one.pop("routes")
    torch.save(toks.cpu(), d / f"{part}_tokens.pt")
    del params
    torch.cuda.empty_cache()
    return {"one": one, "floor": floor, "kernels": kernels,
            "one_bytes": one_bytes, "one_logits": one_logits,
            "one_routes": one_routes, "one_s": time.perf_counter() - t0}


def _tps_check(part: str, d: Path, ref: dict, ranks) -> dict:
    """Hold a part's ranks to its one-rank run."""
    import torch
    p = TPS_PARTS[part]
    cfg = _tps_cfg(part)
    sizes = _tps_sizes(part)
    s_max = p["prompt"] + p["decode"]
    f32 = p["dtype"] == "float32"
    one, floor, one_logits, one_routes = (
        ref["one"], ref["floor"], ref["one_logits"], ref["one_routes"])
    # the logits: rank 0's against one rank's, the same on every rank
    got = torch.load(d / f"{part}_logits.pt")
    rel = [_rel(g, w) for g, w in zip(got, one_logits)]
    tol = (max(TPS_F32_TOL, FLOOR_FACTOR * floor) if f32
           else LM_TOL["bfloat16"])
    require(max(rel) <= tol, f"tp_serve {part}: logits against one rank's "
            f"{rel} (tolerance {tol})")
    greedy = [int((torch.argmax(g[:, -1], -1) == torch.argmax(w[:, -1],
                                                               -1)).sum())
              for g, w in zip(got, one_logits)]
    if p.get("tokens_equal"):
        require(greedy == [p["batch"]] * len(greedy), f"tp_serve {part}: "
                f"the ranks' greedy tokens agree with one rank's on "
                f"{greedy} of {p['batch']} rows a step")
    reck = {kind: _tps_reckon(cfg, sizes, p["batch"], s_max, kind)
            for kind in ("prefill", "decode")}
    for r, g in enumerate(ranks):
        where = f"tp_serve {part} rank {r}"
        require(g["logits_sums"] == ranks[0]["logits_sums"],
                f"{where}: its logits differ from rank 0's")
        require(g["param_bytes"] == g["rule"]["params"]
                and g["cache_bytes"] == g["rule"]["cache"],
                f"{where}: holds {g['param_bytes']} + {g['cache_bytes']} "
                f"bytes, the rules reckon {g['rule']}")
        held = g["param_bytes"] + g["cache_bytes"]
        require(g["allocated_after_prefill"] <= held + TP_RESIDENT_SLACK,
                f"{where}: {g['allocated_after_prefill']} bytes allocated "
                f"after prefill, the shards and caches are {held}")
        leaf = g["largest_leaf"] * (4 + g["element_size"])
        require(g["init_peak"] <= g["param_bytes"] + leaf
                + TP_RESIDENT_SLACK, f"{where}: init peaked at "
                f"{g['init_peak']} bytes, its shards {g['param_bytes']} "
                f"plus one whole leaf's draw {leaf}")
        require(g["launches"] == one["launches"], f"{where}: launches "
                f"{g['launches']}, one rank {one['launches']}")
        for step, col in enumerate(g["collectives"]):
            kind = "prefill" if step == 0 else "decode"
            want, gathers = reck[kind]
            calls = {k: v["calls"] for k, v in col.items()
                     if "@" in k and v.get("calls")}
            require(calls == want, f"{where} step {step}: collectives "
                    f"{calls}, reckoned {want}")
            require(col["fsdp_gathers"]["forward"] == gathers,
                    f"{where} step {step}: FSDP gathers "
                    f"{col['fsdp_gathers']}, reckoned {gathers}")
        require("stages its collectives through the host"
                in g["capture_refused"], f"{where}: a decode graph over "
                f"gloo ranks was not refused ({g['capture_refused']})")
        for q, other in enumerate(ranks):
            same_rows = all(g["coord"][a] == other["coord"][a]
                            for a in g["row_axes"])
            if same_rows:
                require(g["states"] == other["states"], f"tp_serve {part}: "
                        f"ranks {r} and {q}'s ALF states differ")
    differ = 0
    if one_routes:
        for r, g in enumerate(ranks):
            require(g["route_calls"] == len(one_routes), f"tp_serve {part} "
                    f"rank {r}: {g['route_calls']} MoE calls against "
                    f"{len(one_routes)}")
            with np.load(d / f"{part}_routes_{r}.npz") as f:
                for i, want in enumerate(one_routes):
                    mine = np.sort(f[f"idx_{i}"], -1)
                    theirs = np.sort(want.idx.cpu().numpy(), -1)
                    differ += int((mine != theirs).any(-1).sum() + (
                        f[f"kept_{i}"] != want.kept.cpu().numpy()
                    ).any(-1).sum())
        require(differ == 0, f"tp_serve {part}: {differ} routes differ "
                "from the one-rank run's")
    return {"config": {"arch": p["arch"], "dtype": p["dtype"],
                       "layers": (f"{p['layers']} of "
                                  f"{_tps_layers(p['arch'])}"
                                  if "period" not in p else
                                  "one period of "
                                  + "/".join("+".join(s)
                                             for s in p["period"])),
                       "mesh": sizes, "batch": p["batch"],
                       "prompt": p["prompt"], "decode": p["decode"],
                       "backend": "gloo, ranks sharing one card",
                       "ode": "MALI, ALF(cuda), ConstantSteps(2)"},
            "rel": rel, "tolerance": tol, "floor": floor,
            "greedy_agree": greedy, "rows": p["batch"],
            "kernels": ref["kernels"], "routes_differ": differ,
            "route_calls": len(one_routes),
            "one_rank": {"prefill_ms": one["ms"][0],
                         "decode_ms": one["ms"][1:],
                         "param_bytes": ref["one_bytes"],
                         "cache_bytes": one["cache_bytes"],
                         "launches": one["launches"][:2]},
            "reckoned": reck,
            "ranks": [{"coord": g["coord"], "prefill_ms": g["ms"][0],
                       "decode_ms": g["ms"][1:],
                       "param_bytes": g["param_bytes"],
                       "cache_bytes": g["cache_bytes"],
                       "allocated_after_prefill":
                           g["allocated_after_prefill"],
                       "init_peak": g["init_peak"], "init_s": g["init_s"],
                       "plan_s": g["wall"]["plan_s"],
                       "startup_s": g["startup_s"],
                       "collectives": g["collectives"][:2],
                       "rank_s": g["rank_s"]} for g in ranks],
            "launches": ranks[0]["launches"][:2], "one_rank_s": ref["one_s"]}


def _tps_layers(arch: str) -> int:
    from repro_torch.configs import get_config
    return get_config(arch).n_layers


def phase_tp_serve(card: str, smi: str):
    """Phase 24: LM serving on meshes, ranks sharing the card (gloo): (a)
    granite-20b on (2, 2), (b) jamba-v0.1-52b on (1, 2), (c) qwen3-1.7b at
    batch 1 on (2, 1), (d) xlstm-125m on (1, 2), its LSTM caches split
    over 'model', each against one rank serving the same cut. Each group
    of rank processes (TPS_GROUPS; (b), (c) and (d) in the same two)
    starts before it serves: the first while this process runs the
    one-rank references, the next while the one before it serves.
    Returns each part's launches per rank, per prefill and per decode
    step."""
    import tempfile

    import torch
    t0 = time.perf_counter()
    parts, walls = {}, {}
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        d = Path(tmp)
        started = [_tps_start(TPS_GROUPS[0], d)]
        try:
            refs = {part: _tps_reference(part, d) for group in TPS_GROUPS
                    for part in group}
            walls["one_rank"] = time.perf_counter() - t0
            for i, group in enumerate(TPS_GROUPS):
                t1 = time.perf_counter()
                _tps_go(started[i], d)
                if i + 1 < len(TPS_GROUPS):
                    # the next group starts while this one serves
                    _tps_wait_ready(started[i], d)
                    started.append(_tps_start(TPS_GROUPS[i + 1], d))
                ranks = _tps_finish(started[i], d)
                for part in group:
                    parts[part] = _tps_check(part, d, refs[part],
                                             ranks[part])
                walls["+".join(group)] = time.perf_counter() - t1
        finally:
            for run in started:
                _tps_stop(run)
        torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t0
    emit({"phase": "tp_serve", "card": card, "nvidia_smi": smi, **parts,
          "group_s": walls, "phase_s": phase_s, "budget_s": TPS_PHASE_S,
          "within_budget": phase_s <= TPS_PHASE_S})
    return {part: {"prefill": r["launches"][0], "decode": r["launches"][1]}
            for part, r in parts.items()}

TPS_CLI_ARCH = "deepseek-moe-16b"


def _tps_cli(res) -> dict:
    """Phase 24's CLI, run by phase_clis: the serve launcher under
    torch.distributed.run, deepseek-moe's smoke config on two ranks of one
    card (the host mesh (2, 1): the rows over 'data', the MoE ranking its
    tokens over both ranks): rank 0 alone prints, the decode eager."""
    lines = res.stdout.splitlines()
    heads = [x for x in lines if x.startswith("arch=")]
    require(res.returncode == 0 and len(heads) == 1
            and "mesh={'data': 2, 'model': 1}" in heads[0]
            and any(x.startswith("decode:") and x.endswith("eager")
                    for x in lines),
            f"tp_serve (CLI): {res.stdout[-2000:]}{res.stderr[-3000:]}")
    return {"cli_s": res.s, "lines": lines}


def _cli_runs() -> dict:
    """Each launcher a phase checks: name -> (the arguments after
    ``python -m``, its timeout in seconds, its phase's check of the
    finished run)."""
    dist_run = ["torch.distributed.run", "--standalone",
                "--nproc-per-node", "2", "-m", "repro_torch.launch.train"]
    return {
        "serve_defaults": (["repro_torch.launch.serve", "--mode", "ode"],
                           600, _sv_cli),
        "lm_train": (["repro_torch.launch.train", "--steps", "4"], 300,
                     _lt_cli),
        "xlstm_serve": (["repro_torch.launch.serve", "--arch", XL_ARCH,
                         "--full", "--prompt-len", "64", "--decode-tokens",
                         "8", "--batch", "4"], 300,
                        _xl_cli("serve", f"arch={XL_ARCH} batch=4 "
                                "prompt=64")),
        "xlstm_train": (["repro_torch.launch.train", "--arch", XL_ARCH,
                         "--full", "--steps", "2", "--global-batch", "2",
                         "--seq-len", "64"], 300,
                        _xl_cli("train", "final_step=2")),
        "dp_train": ([*dist_run, "--steps", "3", "--device", DP_DEVICE],
                     240, _dp_cli),
        "tp_train": ([*dist_run, "--arch", TP_MOE_ARCH, "--smoke",
                      "--steps", "3", "--device", TP_DEVICE], 240, _tp_cli),
        "tp_serve": ([*dist_run[:-1], "repro_torch.launch.serve", "--arch",
                      TPS_CLI_ARCH, "--device", TP_DEVICE], 240, _tps_cli)}


def phase_clis(card: str, smi: str):
    """Phase 23: the launchers of phases 16 (d), 17 (e), 18 (c), 20 (d),
    22 (c) and 24's serve launcher on two ranks, all started together (each its own process; their host
    work overlaps) and each held to its phase's check. Every process is
    stopped before this returns."""
    import os
    import tempfile
    import types
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    runs = _cli_runs()
    t0 = time.perf_counter()
    done = {}
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        d = Path(tmp)
        procs = {}
        try:
            for name, (args, timeout, _) in runs.items():
                so = open(d / f"{name}.out", "w")
                se = open(d / f"{name}.err", "w")
                procs[name] = (subprocess.Popen(
                    [sys.executable, "-m", *args], cwd=str(HERE), env=env,
                    stdout=so, stderr=se), so, se, time.perf_counter(),
                    timeout)
            while len(done) < len(procs):
                now = time.perf_counter()
                for name, (p, _, _, start, timeout) in procs.items():
                    if name in done:
                        continue
                    if p.poll() is not None:
                        done[name] = now - start
                    elif now - start > timeout:
                        p.kill()
                        p.wait()
                        done[name] = now - start
                time.sleep(0.05)
        finally:
            for p, so, se, _, _ in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
                so.close()
                se.close()
        out = {}
        for name, (p, _, _, _, _) in procs.items():
            res = types.SimpleNamespace(
                returncode=p.returncode, s=done[name],
                stdout=(d / f"{name}.out").read_text(),
                stderr=(d / f"{name}.err").read_text())
            out[name] = runs[name][2](res)
    emit({"phase": "clis", "card": card, "nvidia_smi": smi, **out,
          "phase_s": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# Phase 25: the paper's experiments as the port's own entry points
# ---------------------------------------------------------------------------

EX_PHASE_S = 60.0             # the phase's budget
EX_TS_STEPS = 20              # latent ODE: training steps a method
EX_TOY_STEPS = 150            # cnf_toy: the reduced run
EX_LM_STEPS = 6               # lm_continuous_depth
EX_MIN_ACC = 0.98             # image_recognition: each test accuracy
EX_QS_REL = 1e-5              # quickstart: card against CPU gradients
EX_QS_MALI_NAIVE = 1e-6       # quickstart: MALI against Naive, relative
EX_PRINTED_LINES = 12         # the tail of each example's output kept
EX_HELPER_TIMEOUT = 240       # seconds a helper process may take
# The two host-bound runs that would take most of the phase run in helper
# processes (chip_smoke.py --example) started with phase 23's CLIs, whose
# host work they overlap; phase 23 waits for them. Each helper runs the
# example's main with the counts set to 0 just before and read just
# after, as _ex_run does here. (key, module, its arguments)
EX_HELPERS = (
    ("time_series_latent_ode_adjoint", "time_series_latent_ode",
     ["--steps", str(EX_TS_STEPS), "--method", "adjoint"]),
    ("cnf_toy", "cnf_toy", ["--steps", str(EX_TOY_STEPS)]),
)


def _ex_run(mod, argv):
    """``mod.main(argv)`` with every launch and op-call count set to 0 just
    before and read just after, its output captured; returns (result,
    launches, wall seconds, printed lines)."""
    import io
    import torch
    _lm_reset()
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, calls = _lm_counts()
    for name, n in launches.items():
        require(n == calls[name], f"examples {mod.__name__}: {name} "
                f"launches {n} != op calls {calls[name]}")
    return out, launches, wall, buf.getvalue().splitlines()


def _ex_require_launches(what: str, launches: dict, want: dict) -> None:
    for name, n in launches.items():
        require(n == want.get(name, 0), f"examples {what}: {name} launched "
                f"{n} times, expected {want.get(name, 0)}")


def _ex_quickstart() -> dict:
    """The quickstart whole on the card against the port on the CPU."""
    import io
    from repro_torch.examples import quickstart
    card, launches, wall, lines = _ex_run(quickstart, ["--device", "cuda"])
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = quickstart.main(["--device", "cpu"])
    rel = {name: abs(card["dalpha"][name] - g) / abs(g)
           for name, g in cpu["dalpha"].items()}
    require(max(rel.values()) <= EX_QS_REL, f"examples quickstart: dL/d"
            f"alpha on the card against the CPU: {rel}")
    require(card["mali_naive_rel"] <= EX_QS_MALI_NAIVE, f"examples "
            f"quickstart: MALI against Naive {card['mali_naive_rel']}")
    for key in ("steps", "fevals"):
        require(card[key] == cpu[key], f"examples quickstart: {key} "
                f"{card[key]} on the card, {cpu[key]} on the CPU")
    require(card["batching"]["lockstep"] == cpu["batching"]["lockstep"],
            f"examples quickstart: Lockstep {card['batching']} on the card, "
            f"{cpu['batching']} on the CPU")
    require(card["event"]["fired"] and cpu["event"]["fired"],
            "examples quickstart: the event did not fire")
    per_row = _ex_per_sample_rounded_once()
    growth = {}
    for name, mem in card["memory"].items():
        growth[name] = mem[1]["peak_bytes"] / mem[0]["peak_bytes"]
    require(growth["mali"] <= 1.05, f"examples quickstart: MALI's peak "
            f"grows {growth['mali']}x from 8 to 64 steps")
    require(growth["naive"] > 2.0, f"examples quickstart: Naive's peak "
            f"grows only {growth['naive']}x from 8 to 64 steps")
    return {"wall_s": wall, "launches": launches,
            "per_sample_card": card["batching"]["per_sample"],
            "per_sample_cpu": cpu["batching"]["per_sample"],
            "per_sample_equal": (card["batching"]["per_sample"]
                                 == cpu["batching"]["per_sample"]),
            "per_sample_rounded_once": per_row,
            "dalpha": card["dalpha"], "dalpha_rel_to_cpu": rel,
            "mali_naive_rel": card["mali_naive_rel"],
            "batching": card["batching"], "event": card["event"],
            "z_T": card["z_T"], "memory": card["memory"],
            "peak_growth_8_to_64": growth, "printed": lines}


def _ex_per_sample_rounded_once() -> dict:
    """The quickstart's PerSample solve (its decay batch, ALF(eta=0.9) on
    the kernels, tolerances 1e-3 / 1e-4, 256 trials) under
    ReproducibleController, on the card and on the CPU: per-row counters
    equal. Under AdaptiveController the float32 power of the step-size
    factor differs between the two devices on ~6% of inputs, and the
    stiffest row's accept/reject decisions part (ROADMAP queue 3, F2);
    rounded once, every other operation of the path must give the CPU's
    decisions."""
    import torch
    from repro_torch.core import (ALF, MALI, PerSample,
                                  ReproducibleController, solve)
    from repro_torch.examples import quickstart
    out = {}
    for dev in ("cuda", "cpu"):
        zb = {"y": torch.ones((8, 1), device=dev),
              "lam": torch.logspace(-0.3, 1.5, 8, device=dev)[:, None]}
        sol = solve(quickstart.decay, {}, zb, 0.0, 1.0,
                    solver=ALF(eta=0.9, backend="cuda"),
                    controller=ReproducibleController(1e-3, 1e-4, 256),
                    gradient=MALI(), batching=PerSample())
        out[dev] = {"fevals": int(sol.stats.n_fevals),
                    "per_row_accepted": [
                        int(v) for v in sol.stats.per_sample.n_accepted]}
    require(out["cuda"] == out["cpu"], f"examples quickstart: PerSample "
            f"under ReproducibleController {out['cuda']} on the card, "
            f"{out['cpu']} on the CPU")
    return out


def _ex_image_recognition() -> dict:
    """Sec 4.2 at its default 400 steps: the accuracies, and phase 4's
    counts for each node step (4 + 4 forward, 4 + 4 backward) plus the
    forward-only evaluations on ALF (node, alf 4, alf 8)."""
    from repro_torch.examples import image_recognition as ex
    out, launches, wall, lines = _ex_run(ex, ["--device", "cuda"])
    accs = {"resnet": out["resnet"]["test_acc"],
            "node": out["node"]["test_acc"],
            **{f"invariance_{k}": v for k, v in out["invariance"].items()}}
    require(min(accs.values()) >= EX_MIN_ACC, f"examples image_"
            f"recognition: test accuracies {accs}")
    steps, evals = 400, 4 + 4 + 8
    _ex_require_launches("image_recognition", launches, {
        "alf_midpoint": N_SUB * steps + evals,
        "alf_update": N_SUB * steps + evals,
        "alf_bwd_pre": N_SUB * steps, "alf_bwd_post": N_SUB * steps})
    return {"wall_s": wall, "launches": launches, "test_acc": accs,
            "train_loss": {m: out[m]["train_loss"]
                           for m in ("resnet", "node")},
            "step_ms": {m: out[m]["step_ms"] for m in ("resnet", "node")},
            "printed": lines}


def _ex_ts_loss(ex, p, data, ts, gradient, solver):
    """The latent ODE's loss through ``solve`` with a given gradient and
    solver (the example's ``loss_fn`` takes a METHODS key)."""
    import torch
    from repro_torch.core import ConstantSteps, SaveAt, solve
    z0 = ex.encode(p, data[:, :ex.T_OBS])
    zs = solve(ex.latent_field, p["f"], z0, solver=solver,
               controller=ConstantSteps(2), gradient=gradient,
               saveat=SaveAt(ts=ts)).ys
    return torch.mean((ex.decode(p, zs.transpose(0, 1)) - data) ** 2)


# the ALF kernels each latent-ODE method launches, per accepted step, in
# training; the extrapolation's forward rollout adds the forward pair
EX_TS_KERNELS = {"mali": ("alf_midpoint", "alf_update", "alf_bwd_pre",
                          "alf_bwd_post"),
                 "naive": ("alf_midpoint", "alf_update", "alf_midpoint_vjp",
                           "alf_update_vjp"),
                 "aca": (), "adjoint": ()}


def _ex_latent_method(method: str, run, acc: int) -> dict:
    """One method's run of the latent ODE ((result, launches, wall,
    printed)): the loss falls, and its launches are EX_TS_KERNELS' at
    ``acc`` accepted steps a rollout."""
    res, launches, wall, lines = run
    losses = res["losses"]
    require(losses[-1] < losses[0], f"examples latent ODE {method}: the "
            f"loss did not fall: {losses[0]} -> {losses[-1]}")
    want = {name: acc * EX_TS_STEPS for name in EX_TS_KERNELS[method]}
    for name in ("alf_midpoint", "alf_update"):
        if name in want:
            want[name] += acc
    _ex_require_launches(f"latent ODE {method}", launches, want)
    return {"wall_s": wall, "launches": launches, "first_loss": losses[0],
            "last_loss": losses[-1], "test_ext_mse": res["test_ext_mse"],
            "step_ms": res["step_ms"], "printed": lines}


def _ex_latent_ode() -> dict:
    """Sec 4.3 at EX_TS_STEPS steps, every method but the adjoint (its
    helper's): the accepted steps of a rollout on the CPU (its Stats),
    MALI's first-step gradient (cuda) against Naive's (reference), each
    method's run."""
    import torch
    from repro_torch import tree_util
    from repro_torch.core import (ALF, MALI, ConstantSteps, Naive, SaveAt,
                                  solve)
    from repro_torch.examples import time_series_latent_ode as ex
    s_cpu, ts_cpu = ex.make_series(16, seed=0, device="cpu")
    p_cpu = ex.init_params(torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        sol = solve(ex.latent_field, p_cpu["f"],
                    ex.encode(p_cpu, s_cpu[:, :ex.T_OBS]),
                    solver=ALF(backend="cuda"), controller=ConstantSteps(2),
                    gradient=MALI(), saveat=SaveAt(ts=ts_cpu))
    acc = int(sol.stats.n_accepted)
    series, ts = ex.make_series(256, seed=0, device="cuda")
    p0 = ex.init_params(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    grads = []
    for gradient, backend in ((MALI(), "cuda"), (Naive(), "reference")):
        leaves, spec = tree_util.tree_flatten(p0)
        leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
        loss = _ex_ts_loss(ex, tree_util.tree_unflatten(leaves, spec),
                           series, ts, gradient, ALF(backend=backend))
        grads.append(torch.autograd.grad(loss, leaves))
    out = {"accepted_steps_a_rollout_cpu": acc,
           "mali_cuda_vs_naive_reference_max_abs_grad_diff":
               _leaves_close(grads[0], grads[1], "examples latent ODE: "
                             "MALI cuda vs Naive reference")}
    for method in ("mali", "naive", "aca"):
        out[method] = _ex_latent_method(method, _ex_run(
            ex, ["--steps", str(EX_TS_STEPS), "--method", method,
                 "--device", "cuda"]), acc)
    return out


def _ex_cnf_toy(helper) -> dict:
    """Sec 4.4 in 2-D at EX_TOY_STEPS steps, from its helper process (the
    example asserts that the fine NLL beats the Gaussian baseline)."""
    out, launches, wall, lines = helper
    require(out["test_nll_fine"] < out["base_nll"], "examples cnf_toy: "
            f"fine NLL {out['test_nll_fine']} against {out['base_nll']}")
    return {"wall_s": wall, "launches": launches,
            **{k: out[k] for k in ("trace_bias", "test_nll",
                                   "test_nll_fine", "base_nll",
                                   "dnll_dt1", "step_ms")},
            "first_loss": out["losses"][0], "last_loss": out["losses"][-1],
            "printed": lines}


def _ex_cnf_image() -> dict:
    """Sec 4.4 at image scale, its defaults (the example asserts that
    bits/dim falls)."""
    from repro_torch.examples import cnf_image as ex
    out, launches, wall, lines = _ex_run(ex, ["--device", "cuda"])
    return {"wall_s": wall, "launches": launches, "bpds": out["bpds"],
            "residual_bytes": out["residual_bytes"],
            "step_ms": out["step_ms"], "printed": lines}


def _ex_lm() -> dict:
    """The LM driver at EX_LM_STEPS steps (the example asserts the
    recovered loss trace bit-equal to the clean one)."""
    from repro_torch.examples import lm_continuous_depth as ex
    out, launches, wall, lines = _ex_run(
        ex, ["--steps", str(EX_LM_STEPS), "--device", "cuda"])
    return {"wall_s": wall, "launches": launches, "clean": out["clean"],
            "discrete": out["discrete"], "faulted": out["faulted"],
            "step_ms": out["step_ms"], "printed": lines[-EX_PRINTED_LINES:]}


def _ex_helper(argv) -> int:
    """One helper of phase 25: ``chip_smoke.py --example DIR KEY MODULE
    ARGS...`` runs the example's main on the card as _ex_run does and
    writes DIR/KEY.json."""
    import importlib
    import torch
    d, key, module, *args = argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mod = importlib.import_module(f"repro_torch.examples.{module}")
    out, launches, wall, lines = _ex_run(mod, [*args, "--device", "cuda"])
    (Path(d) / f"{key}.json").write_text(json.dumps(
        [out, launches, wall, lines],
        default=lambda a: np.asarray(a).tolist()))
    return 0


def _ex_start_helpers(d: Path) -> dict:
    """Start phase 25's helper processes (EX_HELPERS), writing to ``d``."""
    import os
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    started = {}
    for key, module, args in EX_HELPERS:
        log = open(d / f"{key}.log", "w")
        started[key] = (subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--example",
             str(d), key, module, *args], cwd=str(HERE), env=env,
            stdout=log, stderr=subprocess.STDOUT), log, time.perf_counter())
    return started


def _ex_stop_helpers(started: dict) -> None:
    """Stop any helper still running and close the logs."""
    for p, log, _ in started.values():
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


def _ex_finish_helpers(started: dict, d: Path):
    """Wait for the helpers (EX_HELPER_TIMEOUT each from its start), then
    stop any left; returns each one's (result, launches, wall, printed)
    and its process's seconds."""
    out, seconds = {}, {}
    for key, (p, _, t0) in started.items():
        try:
            p.wait(timeout=max(1.0, EX_HELPER_TIMEOUT
                               - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            pass
        seconds[key] = time.perf_counter() - t0
    _ex_stop_helpers(started)
    for key, (p, _, _) in started.items():
        require(p.returncode == 0, f"examples: the {key} helper failed "
                f"(exit {p.returncode}): "
                f"{(d / f'{key}.log').read_text()[-3000:]}")
        out[key] = json.loads((d / f"{key}.json").read_text())
    return out, seconds


def phase_examples(card: str, smi: str, helped) -> dict:
    """Phase 25: the six examples of repro_torch.examples on the card,
    ALF on "cuda": the two of EX_HELPERS from their helper processes'
    results (``helped``: _ex_finish_helpers'; they run beside phase 23's
    CLIs), the rest in this process. Returns each example's launches of
    each kernel."""
    t0 = time.perf_counter()
    helpers, helper_s = helped
    parts, out = {}, {}
    for name, run in (("quickstart", _ex_quickstart),
                      ("image_recognition", _ex_image_recognition),
                      ("time_series_latent_ode", _ex_latent_ode),
                      ("cnf_image", _ex_cnf_image),
                      ("lm_continuous_depth", _ex_lm)):
        t1 = time.perf_counter()
        out[name] = run()
        parts[name] = time.perf_counter() - t1
    latent = out["time_series_latent_ode"]
    latent["adjoint"] = _ex_latent_method(
        "adjoint", helpers["time_series_latent_ode_adjoint"],
        latent["accepted_steps_a_rollout_cpu"])
    out["cnf_toy"] = _ex_cnf_toy(helpers["cnf_toy"])
    launches = {}
    for name, res in out.items():
        if name == "time_series_latent_ode":
            for method in ("mali", "naive", "aca", "adjoint"):
                launches[f"{name}_{method}"] = res[method]["launches"]
        else:
            launches[name] = res["launches"]
    phase_s = time.perf_counter() - t0
    emit({"phase": "examples", "card": card, "nvidia_smi": smi, **out,
          "part_s": parts, "helper_process_s": helper_s,
          "phase_s": phase_s, "budget_s": EX_PHASE_S,
          "within_budget": phase_s <= EX_PHASE_S})
    return launches


# ---------------------------------------------------------------------------
# Phase 26: the roofline of four steps the script times
# ---------------------------------------------------------------------------

# (step, what) of the four steps: phase 4's Sec 4.2 MALI training step,
# phase 11's qwen3-1.7b prefill (4 x 1024, its cache 1024 + 32) and eager
# decode step, phase 17 (a)'s qwen3-1.7b bf16 training step (2 x 4096)
RL_STEPS = (("sec42_mali_step", "phase 4: one Adam step of the Sec 4.2 "
             "model, 2048 images, MALI, ALF cuda, ConstantSteps(4)"),
            ("qwen3_prefill", "phase 11: qwen3-1.7b prefill, 4 x 1024, "
             "DEFAULT_ODE, bf16"),
            ("qwen3_decode", "phase 11: qwen3-1.7b eager decode step, batch "
             "4, cache 1056, DEFAULT_ODE, bf16"),
            ("qwen3_train", "phase 17 (a): qwen3-1.7b training step, bf16, "
             "2 x 4096, MALI on ALF cuda, AdamW"))
# a step's bound over its measured time: above 1 the count is wrong
RL_SHARE_MAX = 1.05
RL_TIMEOUT = 600              # seconds the meta-counting helper may take


def _rl_sec42_step(dev):
    """One Adam step of phase 4's Sec 4.2 model on ``dev`` (meta: only
    shapes), as ``_train`` takes it."""
    import torch
    import torch.utils._pytree as pytree
    from repro_torch.core import ALF, MALI, ConstantSteps
    params = {k: (torch.empty(v.shape, dtype=torch.float32, device=dev)
                  if not isinstance(v, dict) else
                  {kk: torch.empty(vv.shape, dtype=torch.float32,
                                   device=dev) for kk, vv in v.items()})
              for k, v in init_params_numpy(0).items()}
    leaves = pytree.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=LR)
    x = torch.empty((N_TRAIN, D), dtype=torch.float32, device=dev)
    y = torch.empty((N_TRAIN,), dtype=torch.int64, device=dev)
    solver, ctrl = ALF(eta=1.0, backend="cuda"), ConstantSteps(N_SUB)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = _model_loss(params, x, y, solver, MALI(), ctrl)[0]
        loss.backward()
        opt.step()
    return step


def _rl_serve_steps(params, cfg, dev, toks=None):
    """(prefill thunk, decode thunk) of phase 11's timed shapes on
    ``dev``: a prefill of the first LM_PROMPT tokens into a cache of
    LM_PROMPT + LM_DECODE, then one eager decode step after it."""
    import torch
    from repro_torch.models import decode_step, init_serve_state, prefill
    if toks is None:
        toks = torch.empty((LM_BATCH, LM_PROMPT + 1), dtype=torch.int64,
                           device=dev)
    box = {"state": init_serve_state(cfg, LM_BATCH, LM_PROMPT + LM_DECODE,
                                     dev)}

    def pre():
        _, box["state"] = prefill(params, cfg,
                                  _prompt(cfg, toks[:, :LM_PROMPT]),
                                  box["state"])

    def dec():
        decode_step(params, cfg, toks[:, LM_PROMPT:LM_PROMPT + 1],
                    box["state"])
    return pre, dec


def _rl_summary(counter, seconds: float) -> dict:
    return {"flops": counter.flops, "flops_bf16": counter.flops_bf16,
            "hbm_bytes": counter.bytes, "ops": counter.n_ops,
            "kernels": {k: list(v) for k, v in sorted(
                counter.kernels.items())},
            "top_bytes": counter.table(6), "count_s": seconds}


def _rl_count(run, grad: bool = False) -> dict:
    import torch
    from repro_torch.launch.cost import OpCounter
    t0 = time.perf_counter()
    with (torch.enable_grad() if grad else torch.no_grad()), \
            OpCounter() as c:
        run()
    return _rl_summary(c, time.perf_counter() - t0)


def _rl_meta_counts() -> dict:
    """The four steps counted on the meta device (no storage, nothing
    computed), with each LM step's model FLOPs (launch/dryrun.py's)."""
    import torch
    from repro_torch.configs import DEFAULT_ODE, get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.dryrun import _model_flops
    from repro_torch.launch.specs import META, param_specs
    from repro_torch.optim import OptimizerConfig
    from repro_torch.optim.optimizer import init_opt_state
    from repro_torch.train import train_step
    out = {"sec42_mali_step": _rl_count(_rl_sec42_step(META), grad=True)}
    cfg = get_config(LM_ARCH, DEFAULT_ODE)
    params = param_specs(cfg)
    pre, dec = _rl_serve_steps(params, cfg, META)
    out["qwen3_prefill"] = _rl_count(pre)
    out["qwen3_decode"] = _rl_count(dec)
    for key, cell in (("qwen3_prefill", ShapeCell("p", LM_PROMPT, LM_BATCH,
                                                  "prefill")),
                      ("qwen3_decode", ShapeCell("d", LM_PROMPT, LM_BATCH,
                                                 "decode"))):
        out[key]["model_flops"] = _model_flops(cfg, cell, params)
    tcfg = _lt_config()                      # phase 17 (a)'s Trainer config
    tparams = param_specs(tcfg)
    opt_cfg = OptimizerConfig()
    opt = init_opt_state(opt_cfg, tparams)
    batch = {k: torch.empty((LT_BATCH, LT_SEQ), dtype=torch.int32,
                            device=META) for k in ("tokens", "labels")}
    out["qwen3_train"] = _rl_count(
        lambda: train_step(tparams, opt, None, batch, cfg=tcfg,
                           opt_cfg=opt_cfg), grad=True)
    out["qwen3_train"]["model_flops"] = _model_flops(
        tcfg, ShapeCell("t", LT_SEQ, LT_BATCH, "train"), tparams)
    return out


def _rl_helper(argv) -> int:
    """``chip_smoke.py --roofline-meta OUT``: phase 26's meta counts, on
    the host only, written to OUT as JSON."""
    import torch
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = _rl_meta_counts()
    out["helper_s"] = time.perf_counter() - t0
    Path(argv[0]).write_text(json.dumps(out))
    return 0


def _rl_start(d: Path) -> dict:
    """Start the meta-counting helper (no card: CUDA_VISIBLE_DEVICES is
    empty) beside the card's phases."""
    import os
    out, log = d / "roofline_meta.json", d / "roofline_meta.log"
    env = {**os.environ, "PYTHONPATH": str(SRC), "CUDA_VISIBLE_DEVICES": ""}
    f = open(log, "w")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--roofline-meta", str(out)], cwd=str(HERE),
                            env=env, stdout=f, stderr=subprocess.STDOUT)
    return {"proc": proc, "out": out, "log": log, "file": f,
            "t0": time.perf_counter()}


def _rl_stop(started: dict) -> None:
    p = started["proc"]
    if p.poll() is None:
        p.kill()
        p.wait()
    started["file"].close()


def _rl_finish(started: dict) -> dict:
    """Wait for the helper; its counts."""
    p = started["proc"]
    left = RL_TIMEOUT - (time.perf_counter() - started["t0"])
    try:
        p.wait(timeout=max(1.0, left))
    except subprocess.TimeoutExpired:
        pass
    _rl_stop(started)
    require(p.returncode == 0, f"roofline: the meta-counting helper failed "
            f"(exit {p.returncode}): {started['log'].read_text()[-3000:]}")
    return json.loads(started["out"].read_text())


def _rl_card_counts(params, cfg, toks) -> dict:
    """Phase 11's prefill and eager decode step counted on the card, the
    kernels launching (each must be one launch an op call)."""
    pre, dec = _rl_serve_steps(params, cfg, "cuda", toks)
    _lm_reset()
    out = {"qwen3_prefill": _rl_count(pre)}
    _lm_check_counts("roofline: the counted prefill", LM_PER_PREFILL)
    _lm_reset()
    out["qwen3_decode"] = _rl_count(dec)
    _lm_check_counts("roofline: the counted eager decode step",
                     LM_PER_DECODE)
    return out


def phase_roofline(card: str, smi: str, meta: dict, on_card: dict,
                   measured_ms: dict) -> dict:
    """Phase 26: each of RL_STEPS counted on meta (the helper), its
    roofline at the card's rates beside the time an earlier phase
    measured (``measured_ms``): the bound over the measured time must be
    at most RL_SHARE_MAX, and for the LM steps the model FLOPs over the
    measured time at the bf16 rate (MFU). The prefill and the eager decode
    step counted on the card must equal their meta counts."""
    from repro_torch.launch.roofline import CollectiveStats, Roofline
    t0 = time.perf_counter()
    rates = card_rates(card)
    rows = {}
    for key, what in RL_STEPS:
        m = meta[key]
        roof = Roofline(flops=m["flops"], hbm_bytes=m["hbm_bytes"],
                        coll=CollectiveStats(), chips=1,
                        model_flops=m.get("model_flops", 0.0),
                        flops_bf16=m["flops_bf16"], rates=rates)
        ms = measured_ms[key]
        row = {"step": what, "flops": roof.flops,
               "flops_bf16": roof.flops_bf16, "hbm_bytes": roof.hbm_bytes,
               "ops": m["ops"], "t_compute_s": roof.t_compute,
               "t_memory_s": roof.t_memory, "bound_ms": roof.t_bound * 1e3,
               "bottleneck": roof.bottleneck, "measured_ms": ms,
               "roofline_share": roof.t_bound * 1e3 / ms,
               "kernel_ops": m["kernels"], "top_bytes": m["top_bytes"],
               "meta_count_s": m["count_s"]}
        if "model_flops" in m:
            row["model_flops"] = m["model_flops"]
            row["mfu"] = m["model_flops"] / (ms / 1e3 * rates.bf16)
        require(row["roofline_share"] <= RL_SHARE_MAX,
                f"roofline: {key} bound {row['bound_ms']} ms over the "
                f"measured {ms} ms is {row['roofline_share']} > "
                f"{RL_SHARE_MAX}: the count is wrong")
        rows[key] = row
    for key, got in on_card.items():
        want = meta[key]
        for field in ("flops", "flops_bf16", "hbm_bytes", "ops", "kernels"):
            require(got[field] == want[field],
                    f"roofline: {key} counted on the card, {field} "
                    f"{got[field]} != the meta count's {want[field]}")
        rows[key]["card_count_equal"] = True
        rows[key]["card_count_s"] = got["count_s"]
    emit({"phase": "roofline", "card": card, "nvidia_smi": smi,
          "rates": {"hbm_bytes_s": rates.hbm, "f32_flops": rates.f32,
                    "bf16_flops": rates.bf16},
          "share_max": RL_SHARE_MAX, "steps": rows,
          "helper_s": meta.get("helper_s"),
          "phase_s": time.perf_counter() - t0})
    # the figures alone, on a short line of their own
    emit({"phase": "roofline_summary", "nvidia_smi": smi, "steps": {
        key: {k: row.get(k) for k in (
            "flops", "flops_bf16", "hbm_bytes", "bound_ms", "bottleneck",
            "measured_ms", "roofline_share", "mfu", "card_count_equal")}
        for key, row in rows.items()}})
    return rows


def _new_cell_launches(name: str, xlstm: dict, gemma2: dict,
                       dp: dict, configs: dict, tp: dict, tps: dict,
                       examples: dict) -> dict:
    return {"launches_xlstm_prefill": xlstm["prefill"].get(name, 0),
            "launches_xlstm_decode": xlstm["decode"].get(name, 0),
            "launches_xlstm_train": xlstm["train"].get(name, 0),
            "launches_gemma2_prefill": gemma2["prefill"].get(name, 0),
            # per data-parallel qwen3 training step, on each rank (20)
            "launches_dp_train": dp["train"].get(name, 0),
            # per fleet step of (f), on each of the four ranks (20)
            "launches_dp_fleet": [per.get(name, 0) for per in dp["fleet"]],
            # per granite-20b training step on a rank of (2, 2) (22)
            "launches_tp_train": tp.get(name, 0),
            # per prefill and per decode step of each config (21)
            "launches_configs_serve": {
                arch: {kind: per.get(name, 0) for kind, per in c.items()}
                for arch, c in configs.items()},
            # per prefill and per decode step on a rank of each part of
            # the serve on meshes (24)
            "launches_tp_serve": {
                part: {kind: per.get(name, 0) for kind, per in c.items()}
                for part, c in tps.items()},
            # per whole run of each example's main (25)
            "launches_examples": {ex: per.get(name, 0)
                                  for ex, per in examples.items()}}


def main() -> int:
    import tempfile

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
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

    # phase 26's meta counts, on the host beside the card's phases
    (HERE / "build").mkdir(exist_ok=True)
    rl_dir = Path(tempfile.mkdtemp(dir=HERE / "build"))
    rl_helper = _rl_start(rl_dir)
    try:
        return _main_phases(card, smi, rl_helper)
    finally:
        _rl_stop(rl_helper)
        shutil.rmtree(rl_dir, ignore_errors=True)


def _main_phases(card: str, smi: str, rl_helper: dict) -> int:
    import tempfile

    import torch
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
    launches, mali_losses, sec42_ms = phase_main_path()
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
    lap("memory")
    lm_worst, lm_checks = phase_lm_kernels()
    lm_times = phase_lm_times(card)
    lap("lm_kernels_times")
    lm_launches, lm_roof = phase_lm_serve(card, smi)
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
    train_launches, train_ms = phase_lm_train(card, smi)
    lap("lm_train")
    xlstm = phase_xlstm(card, smi)
    lap("xlstm")
    gemma2 = phase_gemma2_serve(card, smi)
    lap("gemma2_serve")
    dp = phase_dp_train(card, smi)
    lap("dp_train")
    configs = phase_configs_serve(card, smi)
    lap("configs_serve")
    tp = phase_tp_train(card, smi)
    lap("tp_train")
    with tempfile.TemporaryDirectory(dir=HERE / "build") as ex_tmp:
        # phase 25's two host-bound runs start beside phase 23's CLIs
        helpers = _ex_start_helpers(Path(ex_tmp))
        try:
            phase_clis(card, smi)
            helped = _ex_finish_helpers(helpers, Path(ex_tmp))
        finally:
            _ex_stop_helpers(helpers)
    lap("clis")
    tps = phase_tp_serve(card, smi)
    lap("tp_serve")
    examples = phase_examples(card, smi, helped)
    lap("examples")
    phase_roofline(card, smi, _rl_finish(rl_helper),
                   lm_roof["card_counts"],
                   {"sec42_mali_step": sec42_ms,
                    "qwen3_prefill": lm_roof["qwen3_prefill"],
                    "qwen3_decode": lm_roof["qwen3_decode"],
                    "qwen3_train": train_ms})
    lap("roofline")
    emit({"phase": "walls", "seconds": walls})

    table = []
    for name, (replaces, _) in KERNELS.items():
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
                      "launches_lm_train": train_launches[name],
                      # per xlstm-125m prefill, decode step and training
                      # step (phase 18), per gemma2-2b prefill (19), per
                      # data-parallel training step on a rank (20)
                      **_new_cell_launches(name, xlstm, gemma2, dp,
                                           configs, tp, tps, examples)})
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
                      **_new_cell_launches(name, xlstm, gemma2, dp,
                                           configs, tp, tps, examples),
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
        if name == "flash_attention":
            # at gemma2-2b's prefill shape: d 256, softcap 50
            table[-1]["gemma2_d256"] = gemma2["flash_d256"]
            # at stablelm-1.6b's (d 64) and granite-20b's (MQA 48/1)
            for arch in FA_MORE_ARCHS:
                table[-1][arch] = lm_times[f"flash_attention_{arch}"]
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(_dp_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["--fleet-rank"]:
        sys.exit(_dp_fleet_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["--tp-rank"]:
        sys.exit(_tp_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["--tps-rank"]:
        sys.exit(_tps_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["--example"]:
        sys.exit(_ex_helper(sys.argv[2:]))
    if sys.argv[1:2] == ["--roofline-meta"]:
        sys.exit(_rl_helper(sys.argv[2:]))
    sys.exit(main())
