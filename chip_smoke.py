#!/usr/bin/env python3
"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `src/repro_torch` only (never JAX, never the `repro` reference
package) and prints one JSON object per phase:

  1. `env` — the card (`nvidia-smi` name and power limit), torch and CUDA
     versions.  Without a CUDA device the script exits 2 and prints no
     result;
  2. `build` — compiles the CUDA sources under
     `src/repro_torch/kernels/csrc/` with nvcc and reports the seconds and
     each kernel's registers/spills, and for the gate walks each kernel's
     registers and static shared memory from `-Xptxas -v` (the level
     walk's plane is dynamic, up to 227 KB, sized per launch); `sass` —
     the `HMMA` / `HGMMA` instructions `cuobjdump -sass` finds in each
     kernel of the ternary library (the tensor-core kernel must have
     some), or that cuobjdump is missing;
  3. `kernel_vs_plain` — every CUDA kernel against its plain PyTorch
     version on the card: the gate walks bit-exact, counted by the variant
     the routing picks (`shared_plane` level walk, `global_scratch` walk),
     on seeded random populations (P up to 64, G up to 4,096 with wide
     unsorted levels, shared and per-individual planes, W in {1, 33,
     2048}), gateless plans, W == 0, plans of 30,000 gates or 60,000
     inputs past shared memory, the five golden tenants through the
     multi-tenant launch, and each golden program through both walks (its
     own schedule, and with 30,000 dead gates appended); every variant must
     have run; `schedule` — the two schedule kernels: the levels
     (`gate_levels`) bit-exact against the plain levels, and a raw plan's
     schedule built on the card equal to the CPU's tensor-op build, on
     random, deep-chain and gateless rows; the host time of a raw P = 64,
     G = 4,096 population's schedule, built per call on the card, and the
     level kernel's time; the ternary matmul in
     bf16 and f32 at M in {1, 7, 8, 9, 16, 64, 65, 256, 768} and (K, N)
     in the LM path's and K {36, 2048, 8192} x N {130, 200, 512, 8192},
     so every variant (split-K, tensor cores, CUDA cores) meets ragged
     edges, every element inside the f32 envelope around the float64
     product and each case launched twice bit-identical; the packed popcount
     bit-exact at (1, 1), (256, 17), (1000, 3), (65536, 32), (65536, 9),
     every W from 0 to 64 at B 1 and 333, W 65 / 100 / 1000 at B 1,001,
     word planes 4 bytes off a 16-byte boundary and the edge words, each
     design (`rows`, `warp`) and both load widths run; the WKV-6 scan on
     the reference's (BH, T, dh) float32 layout at BH in {1, 512}, T in
     {1, 7, 96, 512}, dh in {16, 64}, decays from U(0.01, 0.999), and on
     the model's (B, T, H, dh) layout (strided bf16 and f32 views of a
     wider projection, u shared by the batch, T in {0, 1, 13, 96}, dh in
     {16, 64}, decays log-uniform down to 1e-12, views off 16-byte
     boundaries, each staging design run), with and without an initial
     state, every element inside the f32 envelope of the float64
     recurrence, the state written in place over s0 equal to the run out
     of place bit for bit, and runs split in two with the state carried
     across equal to one pass, bit for bit; the WKV-6 backward kernel
     (`rwkv6_scan_bwd`) from its forward instance's checkpoints against
     `rwkv6_scan_bwd_plain` and the float64 reverse recurrence, on the
     (BH, T, dh) float32 layout and the model's strided bf16/f32 views
     (off 16-byte boundaries too), dh in {16, 64}, T in {1, 13, 96,
     256}, decays down to 1e-12, with and without s0 and a gradient on
     the final state: every gradient and checkpoint inside the
     forward's envelope applied to the absolute-value adjoint (plus one
     bf16 rounding of dr, dk, dv), two launches bit-identical, and
     `rwkv6_scan` under autograd launching one forward and one backward
     with the backward kernel's gradients;
  4. `main_path` — the launch counters are zeroed, then each tenant of
     `tests/golden_emit/fleet.json` is loaded on the card and must
     reproduce `tests/golden/<name>.npz` labels; `scores` must equal the
     plain version; the arrhythmia tenant serves 262,144 seeded readings
     through a `max_batch=65536` engine and 512 submitted requests through
     a `max_batch=1024` engine; the five tenants run through one
     `fleet_eval_words` launch.  Every kernel must have launched, every
     launch through the `shared_plane` level walk (launches are reported
     by variant, with each program's schedule build time);
     `popcount_path` — with its counter zeroed, `ops.packed_popcount`
     counts the binarized features that fire in each of 65,536 arrhythmia
     readings (packed one row a reading, 9 words) and must equal the
     count of the 0/1 matrix;
  4b. `campaign` — the paper's Phases 1-3 on arrhythmia's golden TNN
     (`tests/golden_emit/arrhythmia_tnn.npz`) at full width, through the
     port's entry points, with the launch counters zeroed first: a CGP
     popcount library for each size (3, 52, 55, 127, 130; 2**17 vectors
     above 16 inputs, the reference's grid; the budget cut to
     `CAMPAIGN_POINTS` tau points a metric x `CAMPAIGN_ITERS`
     generations), the PCC library over 30,000 samples, and NSGA-II
     (`configs/tnn_paper`: pop 32 x 60 generations) through
     `TNNApproxProblem.optimize`, then `decode` and `tnn_hw_cost` of the
     front.  Each objective call must be one `fused_eval_uint` launch and
     no schedule may be built during the search; launches are reported
     by phase and variant.  The kernel against its plain version on the
     card, bit for bit, at the two launch shapes it times: an objective
     call (pop 32) and four CGP children at n = 130.  Card against CPU,
     bit for bit: the n = 130 truncation sweep's errors, a CGP library
     of one size at a small budget with its evaluations, one PCC size's
     entries, every population the search scored, a short NSGA-II run,
     each front design's error against its decoded circuits, and the
     exact circuits against the integer path.  Printed: each phase's
     seconds, CGP evaluations/s, objective individuals/s (pop 32 over an
     objective call's p50 on the host's clock), the objective launch and
     a CGP children launch (kernel, plain version, bound) and the
     kernel's share of an objective call;
  4c. `pipeline` — the paper's pipeline from sensor floats to served
     labels with no file the reference wrote, the gate-walk counters
     zeroed first (TF32 must be off): for each Table-2 dataset at full
     topology, `train_tnn` on the card at the golden settings (12 epochs,
     lr 1e-2, seed 0; timed, and again on the CPU beside it), one QAT step
     card against CPU from the same parameters and batch (gradients within
     1e-6 * max|g|) and 20 steps with sync debugging on (no step may wait
     for the host), `lower_classifier` of the exact netlists,
     `write_artifacts`, the emitted Verilog read back by `vread` on 2,048
     random vectors against `predict_bits` on the card and the written
     bundle, `classify_stream` of the test set tiled to 65,536 readings
     (`max_batch` 1,024) against `predict_with_circuits` and the integer
     path, and the score taps against the integer path's scores.  Gates:
     balanced output zeros, test accuracy within 5 pp of
     `tests/golden_emit/<ds>_tnn.npz`, every equality.  Printed, not
     gated: code differences against the golden file and the CPU's
     training, and whether two card trainings of arrhythmia give identical
     latents.  Then the five golden classifiers lowered by the port (each
     bundle's sha256 must equal the committed sidecar), the campaign's
     NSGA-II front decoded, lowered and served (labels equal its circuits',
     training error equal to its objective bit for bit), and `python -m
     repro_torch.compile.export breast_cancer` once on the card;
  4d. `baselines` — the paper's Table-2/3 MLP baselines
     (`core.baselines.train_mlp_baseline`) for every Table-2 dataset x
     {exact, pow2} at `benchmarks/table2_accuracy.py`'s settings, trained
     on the card and on the CPU, timed: test accuracy within 3 pp of the
     reference's (`tests/golden_emit/mlp_baselines.npz`) and of the CPU's,
     `cost("adc4")` equal to the golden one wherever the integer weights
     are; weights differing from the golden file are printed;
  4e. `fleet` — the five golden tenants served by `ClassifierFleet` on the
     card at the reference's defaults (`max_batch` 256, `deadline_ms` 50),
     each tenant's golden readings then its seeded test split tiled to
     65,536 readings, submitted as 256-row frames by 2 producers, in five
     modes in turn (`fleet_mode` lines): in-process with 1 and 2 replicas,
     `megakernel=True`, over the socket (`FleetServer` on 127.0.0.1:0, the
     port's `FleetClient`), and `workers=2` spawned processes on the card.
     Labels must equal offline `CircuitProgram.predict` on the card and the
     golden labels; the counters, zeroed after warm-up, must read
     `fused_eval_uint` = dispatches in-process and over the socket,
     `fleet_eval_words` only (one a megakernel dispatch) in megakernel
     mode, nothing in the parent and `fused_eval_uint` in each worker in
     worker mode, all `shared_plane`.  Readings/s, request p50/p99,
     `n_slo_miss` (not gated), `n_shed` and dispatch p50/p99 are printed.
     `fleet_kernels` times both kernels at the fleet's shape (256
     readings) against their plain versions and bounds, with a dispatch's
     host parts; `fleet_cli` runs `python -m repro_torch.serve replay` on
     the card, then `serve` on port 0 with `replay --connect` against it
     (each must exit 0; the server stops on SIGINT after draining);
  4f. `evolve` — the campaign layer (`repro_torch.evolve`, `checkpoint`,
     `compile.zoo`, `autopilot`) on the card, the gate-walk counters
     zeroed first: (a) the campaign phase's arrhythmia products written
     to a phase-cache entry and read back by name, searched by a
     `Campaign` at `python -m repro_torch.evolve`'s defaults (4 islands x
     pop 24 x 8 epochs x 5 generations, migrate_k 2, a checkpoint an
     epoch): one `fused_eval_uint` launch an objective call; the archive
     and island histories equal to a CPU campaign's on the same products,
     to a campaign stepped by 2 spawned workers on the card, and to a
     fresh campaign resumed from epoch 3's checkpoint; 3 rounds of
     `attach_tnn_drift` at rate 0.25 with objectives equal to the CPU's
     and to the card's `_eval_one`; (b) `python -m repro_torch.evolve
     --problem tnn --dataset cardio` from scratch on the card at a cut
     budget (`EVOLVE_BUDGET`, `EVOLVE_CLI_EPOCHS` epochs): serial, with
     `--workers 2`, and killed after epoch 1 then resumed with `--workers
     2`, all three archives equal; two `train_tnn` runs on the card at the
     CLI's settings compared (printed, not gated); (c) a zoo of cardio and
     breast_cancer x {base, lean} built by 2 spawned workers on the card
     and served by `ClassifierFleet(megakernel=True)`: labels equal offline
     `predict`, every dispatch a `fleet_eval_words` launch; (d) two
     autopilot rounds on the card over (b)'s emitted winner (its sabotaged
     copy rolls back, the winner promotes), then `python -m
     repro_torch.autopilot run` SIGKILLed between round 1's decision and
     its execution and resumed: the journal's decisions equal an
     uninterrupted run's.  Printed: generations/s, objective
     individuals/s, launches and the memo's hit share per epoch,
     checkpoint save and restore ms, epoch seconds serial and with 2
     workers, zoo entries/s, autopilot seconds a round, and the
     objective's launch at pop 24 against its plain version and its
     bytes, operations and chain bounds;
  4g. `paper` — the paper's tables and figures through the port's
     harness (`benchmarks_torch/`) at its quick budgets: the harness's
     QAT of each Table-2 dataset's TNN on the card and on the CPU (test
     accuracies within 5 pp; code differences printed), then, with the
     gate-walk counters zeroed, Table 2 on the five datasets, Fig. 4 at n
     = 8, Figs. 5-8 and Table 3 on cardio and the variation bench on
     redwine on the card, and the same benches on the CPU from the card's
     TNNs: every column equal but the QAT columns (the MLP baselines
     within 3 pp, the variation bench's trainings within 5 pp, printed
     side by side).  Printed: the card's rows, each bench's seconds on
     both, the headline ratios (Table 2's gaps, Fig. 4's truncation over
     CGP area, Fig. 7's savings, Table 3's area and power ratios with the
     interface), and the launches by kernel and by design, at least one
     and all `shared_plane`;
  5. `lm_serving` — llama3.2-1b at full width (16 layers, d_model 2048,
     vocab 128,256) with 2-bit packed ternary projections in bf16, weights
     drawn on the card from seed 0 (`serving_params`): 16 requests (8 of
     32 and 8 of 96 prompt tokens, 32 new tokens each) through
     `ServingEngine(max_batch=8, cache_len=256)`.  The ternary-matmul
     counters are zeroed just before and must read 7 projections x 16
     layers x forwards just after, every decode launch through the
     split-K variant and every prefill launch through the tensor-core
     variant; every request must get its 32 tokens and the logits must be
     finite;
  6. `lm_cross_device` — the same weights in float32, their first
     `LM_CROSS_DEPTH` layers, one 16-token prompt and 8 greedy steps on
     the card (kernel) and on the CPU (plain versions): logits agree
     within `LOGIT_TOL`, tokens agree wherever the top-2 margin exceeds
     it;
  6a. `lm_families` — every row of `repro_torch.launch.families.FAMILIES`
     at its published width, weights drawn on the card from seed 0 by
     `serving_params` (packed there under ternary_packed), its depth
     printed beside the published one (cut only for the card's 80 GB or
     the run's time): qwen2-1.5b, qwen3-4b (8 layers), qwen2.5-14b (4),
     mixtral-8x22b (4), arctic-480b (1), hymba-1.5b (dense),
     whisper-medium (24 + 24), qwen2-vl-72b (2; 288-token prompts over its
     256 vision positions, `cache_len` 512) and llama3.2-1b with an fp8
     KV cache.  Each serves 8 requests of 32 prompt tokens, 16 new each,
     through `ServingEngine(max_batch=8, cache_len=256)` after one warm-up
     request, with the ternary-matmul counters zeroed just before and read
     just after: launches must equal `family_launches` by variant (decode
     split-K, prefill tensor cores; 7 a layer and forward, mixtral 4,
     hymba 0, whisper 6 an encoder and 10 a decoder layer at prefill, 8 at
     decode), the (K, N) the kernel got must be the arch's `_lin` shapes
     (`params.lin_shapes`), every request get its 16 tokens and the logits
     be finite; printed: params, active params, prefill and decode step
     ms, tokens/s, `max_memory_allocated`, and every `(M, K, N, x dtype)`
     the kernel got, the warm-up's included (`SHAPE_LAUNCHES`).
     `lm_families_moe` — layer 0's `moe_ffn` of mixtral and arctic on the
     card and the CPU from one bf16 input of 8 x 32 tokens: routing
     (`tope`, `keep`, the slots) equal, outputs within `MOE_TOL`;
     `lm_families_fp8` — the fp8 cache bytes a prefill writes on the card
     equal the CPU's cast of the same K/V; `lm_families_cross_device` —
     whisper at 12 + 12 layers and hymba at 4 in float32, held as
     `lm_cross_device` is, and llama3.2-1b at 8 layers with its fp8 KV
     cache in float32 (`fp8_cross_device`): the prefill on each side, then greedy
     steps with the CPU handed the card's cache bytes each step, logits
     within `LOGIT_TOL`, tokens equal and cache values within one fp8
     step; `lm_families_ternary` — the ternary matmul at every shape the
     served runs gave it: inside the f32 envelope, with kernel, plain
     version, bound and `library_ms` times;
  6b. `rwkv_serving` — rwkv6-7b at full width and depth (32 layers,
     d_model 4096, 64 heads of 64, vocab 65,536, dense bf16, 7.6 B
     parameters drawn on the card by `init_params` from seed 0): the
     operands of layer 0's `ops.rwkv6_scan_heads` call (the model's bf16
     (B, T, H, dh) views, its decays, its (H, dh) bonus and the state the
     cache holds) in a prefill of 8 x 96 tokens and in a decode step are
     captured, and the kernel is held against the plain version on them,
     in that layout and in the (BH, T, dh) float32 one (the model's own
     decays; a `kernel_vs_plain` line); then, with the counters zeroed,
     the `lm_serving` traffic through `ServingEngine`: `rwkv6_scan` must
     launch 32 x forwards times, all through `cp_async` staging, every
     request get its 32 tokens and the logits be finite;
     `rwkv_cross_device` — the same
     widths at 2 layers in float32 (every leaf drawn, so `u`, `w0` and the
     token shifts are not zero), one 16-token prompt and 8 greedy steps on
     the card and on the CPU, held as `lm_cross_device` is;
  6c. `training` — LM training through `train.loop.Trainer` (the
     `TRAIN_*` constants): the ternary matmul refuses autograd; one train
     step card against CPU in float32 from the same weights and stream on
     reduced llama3.2-1b (ternary QAT), rwkv6-7b and mixtral
     (`training_cross_device`: loss, every gradient and every updated
     parameter held); rwkv6-7b at its published width cut to 4 of 32
     layers (~1.4 B parameters, dense bf16, int8 AdamW moments, int8
     gradient compression, 4 x 256 tokens in 2 microbatches, 6 steps),
     the WKV counters zeroed just before and read just after: forward
     twice a layer a microbatch a step (remat), backward once, no
     ternary-matmul launch; one step under `torch.profiler` (busy share);
     the backward kernel timed at the training shape on layer 0's
     captured operands beside its plain version and bound
     (`timing_rwkv_bwd`); llama3.2-1b at full width and depth in
     `quant="ternary"` with f32 AdamW (8 x 256 tokens, 6 steps),
     checkpointed at step 3 and resumed by a fresh Trainer: the restored
     tensors equal the saved ones bit for bit and the step continues, no
     WKV or ternary-matmul launch; `training_cli` — `python -m
     repro_torch.launch.train --preset lm100m --device cuda --steps 30`
     in a process of its own.  Every run's losses finite, the last below
     the first; printed: tokens/s, step p50, peak memory, checkpoint save
     and restore seconds;
  6d. `roofline` — the step roofline of the cells `training` and
     `lm_serving` ran, costed by a meta trace of the same step
     (`roofline.component_costing.cost_cell`, components x trips, and
     `launch.dryrun.trace_step`, the whole step's peak): rwkv6-7b cut to
     4 layers (4 x 256 in 2 microbatches, int8 moments, compression,
     remat) and llama3.2-1b in ternary QAT (8 x 256, f32 AdamW), against
     the `training` phase's step p50 and launches and the peak of one
     step run here from fresh weights (`train_step_peak`: only the
     step's arguments alive beside it, where a `Trainer.run` also keeps
     its caller's step-0 state), and llama3.2-1b
     ternary_packed at batch 8, cache 256: a 96-token prefill and a decode
     step, run here on weights drawn from seed 0 and timed on the host
     clock (`ROOFLINE_REPS`), peaks from `max_memory_allocated`.  For each
     cell: `bound_ms` (the larger of the traced compute and memory terms
     at `kernel_model`'s peaks), `dominant`, the measured step ms, bound /
     measured, the model-FLOP share of the measured step at
     `BF16_FLOP_PER_S`, the peak estimate beside the measured peak (both
     above what the process held before the step's arguments).  Fails
     when bound / measured > ROOFLINE_FRACTION_MAX, when the costed
     kernel calls differ from the launches counted (112 ternary a
     prefill or decode step, 16 forward and 8 backward WKV a step), or
     when a peak estimate is more than ROOFLINE_PEAK_TOL from the measured
     peak.  In processes of their own, started after `env` so they run
     beside the phases before this one (`start_roofline_clis`), `python
     -m repro_torch.launch.dryrun` and `launch.roofline_run` for
     llama3.2-1b x all shapes; then `python -m benchmarks_torch.run
     --only roofline` on the dry run's file;
  7. `launch_floor` — an empty kernel timed as the kernels are, and the
     card's `clocks.max.sm`; `timing` — kernel (CUDA events, median of 25
     after warm-up, with the program's schedule), plain version and bound
     at 1,024 and 65,536 readings for arrhythmia and cardio, the variant,
     columns a block, dynamic shared memory, the program's schedule build
     time and the chain bound (depth x 30 SM cycles at `clocks.max.sm`)
     beside the bytes/ops bound, plus the engine's per-dispatch wall time;
     `timing_fleet` — the same for the five tenants: `fleet_ms` times the
     wrapper as a caller runs it (the padded plans from its cache, the
     word planes padded, one launch), `fleet_kernel_ms` the launch alone,
     `padding_host_ms` the one-time padding and schedule, and
     `dispatch_p50_ms` `dispatch.fleet_eval_words` end to end on the
     host's clock (numpy planes in, labels on the host); `timing_ternary` —
     the ternary-matmul kernel, its plain version, the bound and one
     `torch.matmul` on weights unpacked to bf16 beforehand (`library_ms`,
     a yardstick the port never calls) at each (K, N) of the LM path and
     M in {1, 8, 256, 768}, with the variant, K splits and tile the plan
     picks;
     `timing_rwkv` and `timing_popcount` — kernel, plain version, bound,
     design and launch floor at the path's shapes (WKV: rwkv6-7b's
     captured prefill, BH 512 x T 96, and decode, T 1 from a state, in
     the (BH, T, dh) float32 layout PR 13 timed, and the same two on the
     model's own bf16 (B, T, H, dh) views with the decode state written
     in place, bound at the bytes those views need; popcount: 65,536
     readings x 9 and x 32 words, and 4,194,304 x 9 random words); no
     single PyTorch call computes either, so their `library_ms` is null;
  8. the `kernels` line (the gate walks' entries with their variant,
     columns a block and chain bound, `fused_eval_uint`'s with a
     `campaign` field: its launches by phase and the two campaign
     launches timed, a `paper` field with the paper phase's launches, a
     `pipeline` field with the pipeline's launches
     (`simulate_population`'s too), a `fleet` field with the fleet's
     launches by mode and the kernels at the fleet's shape (on
     `fleet_eval_words`' entry too, with the zoo's megakernel launches),
     and an `evolve` field with the campaign's launches, by epoch, and
     its objective launch timed; the ternary matmul's entry at decode
     w_gate, with a `prefill` field at M = 768 and its launches by
     variant, and an `lm_families` field (its launches by arch and
     variant, and each new shape's times and bound); the popcount's with
     a `large` field and its design; the WKV
     scan's at the f32 prefill, with `decode`, `model_layout` and
     `model_layout_decode` fields, its design and launches by design; the
     WKV backward's at the rwkv6-7b training microbatch, its launches
     from the `training` phase), the card's name and power limit, and
     last `{"ok": true, "device": {...}}`.

Float32 products on the card run in full float32: TF32 is switched off
(`torch.backends.cuda.matmul.allow_tf32 = False`, and the same for cuDNN)
before any plain version runs.

Any failed check raises, and the script exits non-zero.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
EMIT_DIR = ROOT / "tests" / "golden_emit"
GOLDEN_DIR = ROOT / "tests" / "golden"

# The bounds, and the H100's peaks behind them, come from
# `repro_torch.roofline.kernel_model`.
TIMED_REPS = 25
PLAIN_REPS = 5
SEED = 0

# The LM path's ternary-matmul shapes at llama3.2-1b: K x N of wq/wo,
# wk/wv, w_gate/w_up and w_down, at decode (M = batch 8) and at prefill
# (M = 8 x 96 prompt tokens).
LM_KN = ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048))
# Timed M: one row, decode (batch 8), and the prefills of the 8 x 32 and
# 8 x 96 prompt groups.
LM_M = (1, 8, 256, 768)
# Checked shapes: across the plan's thresholds (split-K up to M 8, K
# splits, tensor-core tiles of 64 to 128 rows) with ragged edges.
TM_CHECK_M = (1, 7, 8, 9, 16, 64, 65, 256, 768)
TM_CHECK_KN = tuple(dict.fromkeys(LM_KN + tuple(
    (K, N) for K in (36, 2048, 8192) for N in (130, 200, 512, 8192))))
PROJECTIONS_PER_LAYER = 7    # wq, wk, wv, wo, w_gate, w_up, w_down
# Card (kernel) against CPU (plain versions) in float32 at full width:
# both sum in f32 in different orders, ~1e-6 relative per product; over 16
# layers that stays far below 1e-3 on logits of order 1.
LOGIT_TOL = 1e-3
# `lm_families`: every row of `repro_torch.launch.families.FAMILIES` (the
# reference's other archs at full width, depth cut only for the card's
# 80 GB or the run's time), each served through `ServingEngine`.
FAMILY_REQUESTS = 8
FAMILY_NEW = 16
# Card against CPU in float32 at published width, depth cut for the run's
# time (the CPU side runs the plain versions): llama3.2-1b (`lm_cross_device`
# and with its fp8 KV cache) at LM_CROSS_DEPTH of 16 layers, whisper at
# WHISPER_CROSS_DEPTH encoder and decoder layers of 24 + 24, hymba at
# HYMBA_CROSS_DEPTH of 32 (its Mamba loop is host-heavy on the CPU).
LM_CROSS_DEPTH = 8
WHISPER_CROSS_DEPTH = 12
HYMBA_CROSS_DEPTH = 4
# One MoE layer alone, card against CPU, at the served prefill shape
# (8 x 32 tokens) in bf16 (arctic's experts in float32 would not fit the
# host twice): routing exact, outputs within MOE_TOL x max|y| (five bf16
# ulps of the largest output: each side rounds h and the products to bf16
# after its own f32 sums).
MOE_TOL = 2e-2
# The training phase (LM training through `train.loop.Trainer`).  rwkv6-7b
# at its published width, depth cut to TRAIN_RWKV_DEPTH of 32 layers (~1.4
# B parameters), dense bf16 with int8 AdamW moments and int8 gradient
# compression, TRAIN_RWKV_BATCH x TRAIN_SEQ tokens a step in
# TRAIN_RWKV_MICRO microbatches; llama3.2-1b at full width and depth in
# `quant="ternary"` (straight-through QAT) with f32 AdamW, TRAIN_LLAMA_BATCH
# x TRAIN_SEQ a step, checkpointed at TRAIN_RESUME_STEP and resumed by a
# fresh Trainer; TRAIN_STEPS steps each.
TRAIN_STEPS = 6
TRAIN_SEQ = 256
TRAIN_RWKV_DEPTH = 4
TRAIN_RWKV_BATCH = 4
TRAIN_RWKV_MICRO = 2
TRAIN_LLAMA_BATCH = 8
TRAIN_RESUME_STEP = 3
TRAIN_LR = 1e-4
TRAIN_CLI_STEPS = 30
# One train step card against CPU in float32 from the same weights, on
# these reduced configs: loss within TRAIN_LOSS_TOL, every gradient within
# TRAIN_GRAD_TOL x the largest gradient of the model (f32 sums in another
# order; MoE routing and ternary codes equal, the flips are printed), the
# updated parameters within what the first AdamW step makes of that
# gradient difference (`adam_step_tol`).
TRAIN_CROSS = (("llama3.2-1b", "ternary"), ("rwkv6-7b", "dense"),
               ("mixtral-8x22b", "dense"))
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
# The roofline phase: the serving cells' prompt length (lm_serving's
# longest), batch and cache; host-clock repetitions a serving step; the
# gates on bound / measured and on the peak estimate.
ROOFLINE_PROMPT = 96
ROOFLINE_BATCH = 8
ROOFLINE_CACHE = 256
ROOFLINE_REPS = 5
ROOFLINE_FRACTION_MAX = 1.05
ROOFLINE_PEAK_TOL = 0.10
# The kernels line's columns for each shape the families gave the kernel.
FAMILY_SHAPE_FIELDS = ("M", "K", "N", "x", "variant", "ms", "plain_ms",
                       "bound_ms", "bound_by", "library_ms")
# The campaign phase's cut of the reference's Phase-1 budget (3 tau points
# a metric x 500 generations in `build_tnn_problem`): 2 points a metric x
# CAMPAIGN_ITERS generations; widths, vector sets and the PCC samples are
# the reference's.  The CPU re-runs one size at CAMPAIGN_CPU_ITERS.
CAMPAIGN_POINTS = 2
CAMPAIGN_ITERS = 300
CAMPAIGN_PCC_SAMPLES = 30_000
CAMPAIGN_CPU_ITERS = 20
# The pipeline phase: QAT at `tools/emit_golden_tnn.py`'s settings (12
# epochs, lr 1e-2, seed 0), PIPE_VERIFY random vectors through the emitted
# RTL, each test set tiled to PIPE_STREAM readings through an engine of
# max_batch PIPE_BATCH.  A card-trained TNN's test accuracy may sit
# PIPE_ACC_TOL from the golden file's: the frameworks' trajectories part
# where a gradient entry cancels to the noise floor.  One step's gradients,
# card against CPU, must agree within PIPE_GRAD_TOL * max|g|.
PIPE_EPOCHS = 12
PIPE_LR = 1e-2
PIPE_VERIFY = 2048
PIPE_STREAM = 65536
PIPE_BATCH = 1024
PIPE_ACC_TOL = 0.05
PIPE_GRAD_TOL = 1e-6
LOOP_STEPS = 20
# The baselines phase: `benchmarks/table2_accuracy.py`'s settings (15
# epochs).  A card-trained baseline's test accuracy may sit MLP_ACC_TOL
# from the reference's (`tests/golden_emit/mlp_baselines.npz`) and from the
# CPU's: the trajectories part where a gradient cancels to the noise floor
# (ROADMAP Queue 3 has the CPU's table).
MLP_EPOCHS = 15
MLP_ACC_TOL = 0.03
# The fleet phase: each golden tenant's stream of FLEET_STREAM readings,
# FLEET_PRODUCERS threads submitting FLEET_FRAME-row frames, FLEET_WORKERS
# spawned processes in worker mode; the replay CLI once at
# FLEET_CLI_READINGS a tenant.
FLEET_STREAM = 65536
FLEET_PRODUCERS = 2
FLEET_FRAME = 256
FLEET_WORKERS = 2
FLEET_CLI_READINGS = 2048
# The evolve phase: (a) a campaign at `python -m repro_torch.evolve`'s
# defaults (EVOLVE_CAMPAIGN, nothing cut) over the campaign phase's
# arrhythmia products, resumed from EVOLVE_RESUME_EPOCH's checkpoint,
# drifted EVOLVE_DRIFT_ROUNDS rounds at EVOLVE_DRIFT_RATE, and stepped by
# EVOLVE_WORKERS spawned workers; (b) the CLI on cardio from scratch with
# the Phase-1/2 budget cut to EVOLVE_BUDGET (the reference's defaults: 3
# tau points a metric x 500 generations, 30,000 PCC samples) and the
# campaign to EVOLVE_CLI_EPOCHS epochs (8), so that its four runs take
# about a minute; (c) a zoo of EVOLVE_ZOO_DATASETS x {base, lean} at
# EVOLVE_ZOO_CAMPAIGN over EVOLVE_BUDGET's products; (d) two autopilot
# rounds at the CLI's defaults.
EVOLVE_CAMPAIGN = {"n_islands": 4, "pop_size": 24, "n_epochs": 8,
                   "gens_per_epoch": 5, "migrate_k": 2}
EVOLVE_RESUME_EPOCH = 3
EVOLVE_DRIFT_RATE = 0.25
EVOLVE_DRIFT_ROUNDS = 3
EVOLVE_WORKERS = 2
EVOLVE_BUDGET = {"tnn_epochs": 12, "cgp_points": 1, "cgp_iters": 100,
                 "pcc_samples": 4000}
EVOLVE_CLI_EPOCHS = 4
EVOLVE_ZOO_DATASETS = ("cardio", "breast_cancer")
EVOLVE_ZOO_CAMPAIGN = {"islands": 2, "pop": 12, "epochs": 2,
                       "gens_per_epoch": 3, "migrate_k": 2}
# The paper phase: the port's harness (`benchmarks_torch/`) at its quick
# budgets on a subset that fits a few minutes: Table 2 on every dataset,
# Fig. 4 at n = 8, Figs. 5-8 and Table 3 on PAPER_DATASET (Fig. 5's own
# default, arrhythmia, spends ~9 s a size in Phase 1 at sizes 127 / 130),
# the variation bench on PAPER_VARIATION_DATASET (where the QAT
# trajectories hold; the bench's quick default is cardio).  QAT columns may
# differ card against CPU by PAPER_TNN_TOL (the TNN's accuracy) and
# PAPER_MLP_TOL (the MLP's): the frameworks' trajectories part where a
# gradient entry cancels to the noise floor.
PAPER_FIG4_SIZES = [8]
PAPER_DATASET = "cardio"
PAPER_VARIATION_DATASET = "redwine"
PAPER_TNN_TOL = 0.05
PAPER_MLP_TOL = 0.03
# Columns that come out of QAT, by bench: held within the tolerance above;
# the MLP rows' costs of Table 3 follow their trained weights and are
# printed, not gated.
PAPER_QAT_COLUMNS = {
    # `delta` is rounded to 3 places apart from `mlp_acc`
    "table2": {"mlp_acc": PAPER_MLP_TOL, "delta": PAPER_MLP_TOL + 1e-3},
    "table3": {"acc": PAPER_MLP_TOL},
    "variation": dict.fromkeys(
        ("clean_acc", "vanilla_mean", "vanilla_p5", "aware_clean",
         "aware_mean", "aware_p5"), PAPER_TNN_TOL),
}
PAPER_MLP_DESIGNS = ("exact_mlp[37]", "ax_mlp_pow2[1,2]")
PAPER_UNGATED = {"variation": ("aware_helps",),
                 "table3": ("area_cm2", "power_mw", "area_cm2_iface",
                            "power_mw_iface", "power_source")}
# WKV-6 envelope: first-order rounding of the recurrence in float32 is at
# most u * (dh + 2T + 2) times the same recurrence run on absolute values
# (u = eps/2: dh terms in each y sum, two roundings a token carried in the
# state); the check allows eps * (dh + 2T + 4), twice that.


def say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def max_sm_clock_mhz() -> float:
    """The card's highest SM clock (`nvidia-smi` clocks.max.sm), MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def ptxas_kernels(log: str) -> list[dict]:
    """Each kernel's registers and static shared memory from `-Xptxas -v`
    (the level walk's plane is dynamic shared memory, sized per launch)."""
    import re

    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)(?:ILb([01])E)?", m.group(1))
            name = m.group(1) if not k else k.group(1) if not k.group(2) \
                else f"{k.group(1)}<{'true' if k.group(2) == '1' else 'false'}>"
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$",
                      line.strip())
        if m and name:
            rows.append({"kernel": name, "registers": int(m.group(1)),
                         "static_smem_bytes": int(m.group(2) or 0)})
            name = None
    return rows


def random_population(rng, n_in, G, n_out, P):
    """Feed-forward random plans over every simulatable opcode (1..12)."""
    op = rng.integers(1, 13, size=(P, G)).astype(np.int32)
    hi = n_in + np.arange(G)
    in0 = rng.integers(0, hi[None, :], size=(P, G)).astype(np.int32) \
        if G else np.zeros((P, 0), np.int32)
    in1 = rng.integers(0, hi[None, :], size=(P, G)).astype(np.int32) \
        if G else np.zeros((P, 0), np.int32)
    outputs = rng.integers(0, n_in + G, size=(P, n_out)).astype(np.int32)
    return op, in0, in1, outputs


def gpu_ms(fn, reps: int, isolate: bool) -> float:
    """Median device time of `fn()` in ms over `reps` runs after one
    warm-up.  With `isolate`, a spin kernel runs first so the host has
    enqueued the launch before the start event fires: the time is the
    kernel's alone, without the wrapper's host work."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if isolate:
            torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def wkv_check(args: tuple, stats: dict) -> None:
    """The WKV-6 kernel and its plain version on the card, each held to
    the envelope around the float64 recurrence, and the kernel run again
    with its final state written in place over a copy of s0, which must
    equal the first run bit for bit; folds the case into `stats`."""
    import torch

    from repro_torch.kernels import rwkv6_scan as WKV

    r, k, v, w, u, s0 = args
    T, dh = r.shape[1], r.shape[-1]
    got = WKV.rwkv6_scan(*args)
    plain = WKV.rwkv6_scan_plain(*args)
    f64 = [None if a is None else a.double() for a in args]
    exact = WKV.rwkv6_scan_plain(*f64)
    env = WKV.rwkv6_scan_plain(*[None if a is None else a.abs() for a in f64])
    gamma = float(np.finfo(np.float32).eps) * (dh + 2 * T + 4)
    ratio = plain_ratio = 0.0
    for g, p, e, m in zip(got, plain, exact, env):
        if not g.numel():
            continue
        bound = gamma * m + 1e-30
        ratio = max(ratio, float(((g.double() - e).abs() / bound).max()))
        plain_ratio = max(plain_ratio,
                          float(((p.double() - e).abs() / bound).max()))
        stats["max_abs_err"] = max(stats["max_abs_err"],
                                   float((g - p).abs().max()))
    if s0 is not None:
        cache = s0.clone()
        y2, s2 = WKV.rwkv6_scan(r, k, v, w, u, cache, cache)
        stats["in_place_cases"] += 1
        stats["in_place_not_bit_identical"] += int(
            s2.data_ptr() != cache.data_ptr() or not torch.equal(y2, got[0])
            or not torch.equal(cache, got[1]))
    torch.cuda.synchronize()
    stats["cases"] += 1
    stats["mismatches"] += int(ratio > 1)
    stats["plain_mismatches"] += int(plain_ratio > 1)
    stats["max_err_over_envelope"] = max(stats["max_err_over_envelope"],
                                         ratio)


def wkv_stats() -> dict:
    return {"cases": 0, "mismatches": 0, "plain_mismatches": 0,
            "max_err_over_envelope": 0.0, "max_abs_err": 0.0,
            "in_place_cases": 0, "in_place_not_bit_identical": 0}


def model_layout(rng, dev, B, T, H, dh, dtype, offset=0):
    """r, k, v as (B, T, H, dh) slices of one wider projection output
    (token step 3 H dh + offset, starting `offset` elements in), w
    (B, T, H, dh) float32 with decays log-uniform over (1e-12, 0.999),
    u (H, dh): the model's layout, or with `offset` one off 16-byte
    boundaries."""
    import torch

    D = H * dh
    big = torch.from_numpy(rng.standard_normal(
        (B, T, 3 * D + offset), dtype=np.float32)).to(dev).to(dtype)
    r, k, v = (big[..., offset + x * D: offset + (x + 1) * D]
               .unflatten(-1, (H, dh)) for x in range(3))
    w = torch.from_numpy(np.exp(rng.uniform(
        np.log(1e-12), np.log(0.999), (B, T, H, dh))).astype(np.float32)
    ).to(dev)
    u = torch.from_numpy(rng.normal(0, 0.5, (H, dh)).astype(np.float32)
                         ).to(dev)
    return r, k, v, w, u


def wkv_vs_plain(dev, rng) -> dict:
    """The WKV-6 grid of `kernel_vs_plain`: synthetic `(BH, T, dh)`
    float32 operands, and the model's `(B, T, H, dh)` layout (strided
    bf16 and f32 views, u shared by the batch, T of 0, 1, 13 and 96, dh 16
    and 64, decays down to 1e-12, with and without a state, the state also
    written in place, and views off 16-byte boundaries); plus split runs
    that must equal one pass bit for bit.  Cases are counted by the
    staging design the plan picks."""
    import torch

    from repro_torch.kernels import cuda_rwkv6_scan as CW
    from repro_torch.kernels import rwkv6_scan as WKV

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    stats = wkv_stats() | {"split_cases": 0, "split_max_abs_diff": 0.0,
                           "designs": {d: 0 for d in CW.DESIGNS}}
    for BH in (1, 512):
        for T in (1, 7, 96, 512):
            for dh in (16, 64):
                for with_s0 in (False, True):
                    r, k, v = (t(rng.standard_normal((BH, T, dh)))
                               for _ in range(3))
                    w = t(rng.uniform(0.01, 0.999, (BH, T, dh)))
                    u = t(rng.normal(0, 0.5, (BH, dh)))
                    s0 = t(rng.standard_normal((BH, dh, dh))) if with_s0 \
                        else None
                    wkv_check((r, k, v, w, u, s0), stats)
                    stats["designs"][CW.plan(
                        *(a.unsqueeze(2) for a in (r, k, v, w)),
                        u.unsqueeze(1)).design] += 1
    for dtype in (torch.bfloat16, torch.float32):
        for B, T, H, dh in ((8, 96, 64, 64), (8, 1, 64, 64), (3, 13, 5, 64),
                            (2, 0, 3, 64), (4, 13, 4, 16), (1, 96, 2, 16)):
            for offset in (0, 1):
                for with_s0 in (False, True):
                    args = model_layout(rng, dev, B, T, H, dh, dtype,
                                        offset)
                    s0 = t(rng.standard_normal((B, H, dh, dh))) \
                        if with_s0 else None
                    wkv_check((*args, s0), stats)
                    stats["designs"][CW.plan(*args, s0).design] += 1
    for BH, T, dh, cut in ((512, 96, 64, 40), (1, 512, 16, 1),
                           (512, 7, 64, 6), (512, 96, 64, 13)):
        r, k, v = (t(rng.standard_normal((BH, T, dh))) for _ in range(3))
        w = t(rng.uniform(0.01, 0.999, (BH, T, dh)))
        u = t(rng.normal(0, 0.5, (BH, dh)))
        y, s = WKV.rwkv6_scan(r, k, v, w, u)
        head = [a[:, :cut].contiguous() for a in (r, k, v, w)]
        tail = [a[:, cut:].contiguous() for a in (r, k, v, w)]
        y1, s1 = WKV.rwkv6_scan(*head, u)
        y2, s2 = WKV.rwkv6_scan(*tail, u, s1)
        diff = max(float((torch.cat([y1, y2], 1) - y).abs().max()),
                   float((s2 - s).abs().max()))
        stats["split_cases"] += 1
        stats["split_max_abs_diff"] = max(stats["split_max_abs_diff"], diff)
    torch.cuda.synchronize()
    return stats


def popcount_vs_plain(dev, rng) -> dict:
    """The popcount kernel against its plain version, bit-exact: random
    planes, every W from 0 to 64 at odd B and wider rows (both designs),
    a word plane 4 bytes off a 16-byte boundary, and the edge words.
    Cases are counted by design and by whether 16-byte loads ran."""
    import torch

    from repro_torch.kernels import cuda_packed_popcount as CP
    from repro_torch.kernels import packed_popcount as PP

    def words_of(shape):
        return torch.from_numpy(rng.integers(0, 2 ** 32, shape,
                                             dtype=np.uint64)
                                .astype(np.uint32).view(np.int32)).to(dev)

    stats = {"cases": 0, "mismatches": 0, "max_abs_err": 0,
             "designs": {d: 0 for d in CP.DESIGNS}, "vec16": 0,
             "word_loads": 0}
    planes = [words_of(shape) for shape in (
        (1, 1), (256, 17), (1000, 3), (65536, 32), (65536, 9))]
    planes += [words_of((B, W)) for W in range(65) for B in (1, 333)]
    planes += [words_of((1001, W)) for W in (65, 100, 1000)]
    for B, W in ((65536, 9), (333, 32), (1001, 70)):    # 4 bytes in
        planes.append(words_of((B * W + 1,))[1:].view(B, W))
    planes.append(torch.from_numpy(np.array([[0, 0xFFFFFFFF, 1, 0x80000000]],
                                            np.uint32).view(np.int32))
                  .to(dev))
    for wt in planes:
        got, want = PP.packed_popcount(wt), PP.packed_popcount_plain(wt)
        err = int((got.long() - want.long()).abs().max()) if got.numel() \
            else 0
        plan = CP.plan(*wt.shape, wt.data_ptr())
        stats["cases"] += 1
        stats["mismatches"] += int(err != 0 or got.shape != want.shape)
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
        stats["designs"][plan.design] += 1
        stats["vec16" if plan.vec16 else "word_loads"] += 1
    edge = int(got[0])
    torch.cuda.synchronize()
    if edge != 34:
        fail(f"packed_popcount: edge words counted {edge}, expected 34")
    return stats


def with_dtypes(tree: dict, defs: dict) -> dict:
    """`tree` with every leaf cast to the dtype of its `ParamDef`."""
    return {k: with_dtypes(v, defs[k]) if isinstance(v, dict)
            else v.to(defs[k].dtype) for k, v in tree.items()}


def finite_logits(cfg, params: dict, prompts: list[list[int]],
                  cache_len: int = 256) -> bool:
    """Whether a prefill of `prompts` (one length) and the decode step
    after it give finite logits."""
    import torch

    from repro_torch.models import transformer as TF
    from repro_torch.serve.lm_engine import make_batch

    dev = params["embed"]["tokens"].device
    with torch.inference_mode():
        hidden, cache = TF.prefill(
            cfg, params, make_batch(cfg, np.array(prompts), dev), cache_len)
        logits = TF.logits_from_hidden(cfg, params, hidden[:, -1:])
        finite = bool(torch.isfinite(logits).all())
        logits, _ = TF.decode_step(cfg, params, cache,
                                   torch.argmax(logits, dim=-1),
                                   len(prompts[0]))
        return finite and bool(torch.isfinite(logits).all())


def greedy_logits(cfg, params, prompt, n_new, TF, torch, forced=None):
    """Prefill `prompt` and decode `n_new - 1` steps greedily, as the
    serving engine does; returns each step's logits on the host.  With
    `forced`, feed those tokens instead of the argmax (so two devices see
    the same inputs)."""
    from repro_torch.serve.lm_engine import make_batch

    dev = params["embed"]["tokens"].device
    with torch.inference_mode():
        hidden, cache = TF.prefill(
            cfg, params, make_batch(cfg, np.array([prompt]), dev), 256)
        logits = TF.logits_from_hidden(cfg, params, hidden[:, -1:])
        out = [logits[0, 0].cpu()]
        for step in range(n_new - 1):
            tok = (torch.tensor([[forced[step]]], device=dev)
                   if forced is not None else torch.argmax(logits, dim=-1))
            logits, cache = TF.decode_step(cfg, params, cache, tok,
                                           len(prompt) + step)
            out.append(logits[0, 0].cpu())
    return torch.stack(out)


def ternary_vs_plain(dev, rng) -> dict:
    """The ternary-matmul kernels and their plain version on the card
    against the float64 product: every element inside the f32 envelope
    eps * sqrt(K) * (|x| @ |w|) * |scale| + 1e-6 (both sum in f32, in
    different orders), at M in `TM_CHECK_M` and (K, N) in `TM_CHECK_KN`,
    so every shape crosses the plan's thresholds and ragged edges; each
    case launched twice must give bit-identical results.  Bytes are drawn
    from all 256 values, so code 0b11 occurs.  Returns per-dtype counts,
    with per-variant counts under `variants`."""
    import torch

    from repro_torch.core.ternary import unpack_ternary
    from repro_torch.kernels import cuda_ternary_matmul as CT
    from repro_torch.kernels import ternary_matmul as TM

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    tstats = {dt: {"cases": 0, "mismatches": 0, "plain_mismatches": 0,
                   "not_bit_identical": 0, "max_err_over_envelope": 0.0,
                   "max_abs_err": 0.0,
                   "variants": {v: {"cases": 0, "mismatches": 0,
                                    "not_bit_identical": 0,
                                    "max_err_over_envelope": 0.0}
                                for v in CT.VARIANTS}}
              for dt in ("bfloat16", "float32")}
    eps32 = float(np.finfo(np.float32).eps)
    for dt in (torch.bfloat16, torch.float32):
        s = tstats[str(dt).removeprefix("torch.")]
        for M in TM_CHECK_M:
            for K, N in TM_CHECK_KN:
                x = t(rng.standard_normal((M, K), dtype=np.float32)).to(dt)
                w2 = t(rng.integers(-128, 128, (K // 4, N)).astype(np.int8))
                sc = t(np.abs(rng.normal(1, 0.1, (1, N))).astype(np.float32))
                got = TM.ternary_matmul(x, w2, sc)
                again = TM.ternary_matmul(x, w2, sc)
                plain = TM.ternary_matmul_plain(x, w2, sc)
                x64, s64 = x.double(), sc.double()
                w64 = unpack_ternary(w2, torch.float64)
                exact = (x64 @ w64) * s64
                bound = eps32 * K ** 0.5 * (
                    (x64.abs() @ w64.abs()) * s64.abs()) + 1e-6
                ratio = float(((got.double() - exact).abs() / bound).max())
                same = bool(torch.equal(got, again))
                v = s["variants"][CT.plan(M, K, N, dt).variant]
                for d in (s, v):
                    d["cases"] += 1
                    d["mismatches"] += int(ratio > 1)
                    d["not_bit_identical"] += int(not same)
                    d["max_err_over_envelope"] = max(
                        d["max_err_over_envelope"], ratio)
                s["plain_mismatches"] += int(
                    ((plain.double() - exact).abs() > bound).any())
                s["max_abs_err"] = max(s["max_abs_err"], float(
                    (got - plain).abs().max()))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return tstats


def sass_tensor_ops(lib: Path) -> dict:
    """`HMMA` / `HGMMA` instructions per kernel in the built library, from
    `cuobjdump -sass`; `{"cuobjdump": "missing"}` without the tool."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {"cuobjdump": "missing"}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    counts: dict = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = {"HMMA": 0, "HGMMA": 0}
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                if op in line:
                    counts[name][op] += 1
                    break
    return {"cuobjdump": tool, "kernels": counts}


def lm_phases(dev, cfg16) -> dict:
    """`lm_serving` and `lm_cross_device` on config `cfg16` (a bf16
    ternary_packed config); returns the ternary-matmul launches of the
    counted serving run, in total and by variant."""
    import torch

    from repro_torch.kernels import cuda_ternary_matmul as CT
    from repro_torch.models import params as P
    from repro_torch.serve.lm_engine import LMServeStats, Request, \
        ServingEngine

    cfg32 = cfg16.replace(param_dtype="float32", compute_dtype="float32")
    t0 = time.perf_counter()
    p32 = P.serving_params(cfg32, SEED, dev)
    p16 = with_dtypes(p32, P.param_defs(cfg16))
    weights_s = time.perf_counter() - t0
    lm_rng = np.random.default_rng(SEED)
    prompts = [lm_rng.integers(1, cfg16.vocab, n).tolist()
               for n in [32] * 8 + [96] * 8]
    engine = ServingEngine(cfg16, p16, max_batch=8, cache_len=256,
                           device=dev)
    engine.run([Request(uid=-1, prompt=prompts[0][:8], max_new_tokens=2)])
    engine.stats = LMServeStats()                 # warm-up not counted
    reqs = [Request(uid=i, prompt=pr, max_new_tokens=32)
            for i, pr in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CT.reset_launches()
    engine.run(reqs)
    tm_launches = CT.LAUNCHES["ternary_matmul"]
    by_variant = dict(CT.VARIANT_LAUNCHES)
    lm = engine.stats.summary()
    forwards = lm["prefills"] + lm["decode_steps"]
    per_forward = PROJECTIONS_PER_LAYER * cfg16.n_layers
    want_launches = per_forward * forwards
    # decode steps (batch 8) run split-K, bf16 prefills the tensor cores
    want_variants = {"split_k": per_forward * lm["decode_steps"],
                     "tensor_core": per_forward * lm["prefills"],
                     "cuda_core": 0}
    peak_bytes = torch.cuda.max_memory_allocated()
    finite = finite_logits(cfg16, engine.params, prompts[8:])
    say("lm_serving", arch=cfg16.name, quant=cfg16.quant,
        n_layers=cfg16.n_layers, d_model=cfg16.d_model, vocab=cfg16.vocab,
        params=P.param_count(cfg16), weights_s=weights_s, requests=len(reqs),
        new_tokens=[len(r.output) for r in reqs], stats=lm,
        ternary_matmul_launches=tm_launches, expected=want_launches,
        launches_by_variant=by_variant, expected_by_variant=want_variants,
        logits_finite=finite, max_memory_allocated_bytes=peak_bytes)
    if any(len(r.output) != 32 for r in reqs):
        fail("lm_serving: a request did not get its 32 tokens")
    if tm_launches != want_launches:
        fail(f"lm_serving: ternary_matmul launched {tm_launches} times, "
             f"expected {want_launches} (7 x {cfg16.n_layers} x {forwards} "
             "forwards)")
    if by_variant != want_variants:
        fail(f"lm_serving: ternary_matmul launches by variant {by_variant}, "
             f"expected {want_variants} (decode split-K, prefill tensor "
             "cores)")
    if not finite:
        fail("lm_serving: non-finite logits")
    del engine, p16

    cross_device("lm_cross_device", *first_layers(cfg32, p32,
                                                  LM_CROSS_DEPTH),
                 lm_rng.integers(1, cfg32.vocab, 16).tolist())
    return {"launches": tm_launches, "by_variant": by_variant}


def first_layers(cfg, params: dict, n: int) -> tuple:
    """`cfg` and `params` cut to their first n layers (and n encoder
    layers where the arch has an encoder): the stacked leaves sliced on
    their L axis, the rest shared."""
    from repro_torch.models import params as P

    over = {"n_layers": n} | ({"enc_layers": n} if cfg.enc_layers else {})
    cut = dict(params)
    for name in ("layers", "enc_layers"):
        if name in cut:
            cut[name] = P.tree_map(lambda a: a[:n], cut[name])
    return cfg.replace(**over), cut


def family_launches(cfg, prefills: int, steps: int) -> dict:
    """Ternary-matmul launches a served run must count, by variant: per
    layer and forward the attention's 4 projections plus the MLP's 3
    (none for the MoE's dense experts, but arctic's residual MLP), none
    under dense; whisper 6 per encoder layer and 10 per decoder layer at
    prefill (its cross-attention K/V over the frames among them), 8 per
    decoder layer at decode.  Decode (batch 8) runs split-K, bf16 prefill
    the tensor cores."""
    if cfg.quant != "ternary_packed":
        pre = dec = 0
    elif cfg.enc_layers:
        pre = 6 * cfg.enc_layers + 10 * cfg.n_layers
        dec = 8 * cfg.n_layers
    else:
        mlp = cfg.moe is None or cfg.moe.dense_residual
        pre = dec = (4 + 3 * mlp) * cfg.n_layers
    return {"split_k": dec * steps, "tensor_core": pre * prefills,
            "cuda_core": 0}


def serve_family(dev, fam) -> dict:
    """`FAMILY_REQUESTS` requests of the row's prompt length, seeded,
    `FAMILY_NEW` new each, through `ServingEngine(max_batch=8)` on the
    card, weights from `serving_params`; the ternary-matmul counters are
    zeroed just before the counted run and read just after.  Fails on a
    short request, non-finite logits, launches other than
    `family_launches`, or projections given (K, N) other than the `_lin`
    shapes of the arch.  Returns the printed row with the engine (its
    weights still on the card) under `engine` and, under `shapes`, the
    launches by `(M, K, N, x dtype)` of the warm-up request and the
    counted run together: every shape the kernel got."""
    import collections

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_ternary_matmul as CT
    from repro_torch.models import params as P
    from repro_torch.serve.lm_engine import LMServeStats, Request, \
        ServingEngine

    cfg, full = fam.config(), get_config(fam.arch)
    plen, cache_len = fam.prompt_tokens, fam.cache_len
    t0 = time.perf_counter()
    params = P.serving_params(cfg, SEED, dev)
    torch.cuda.synchronize()
    weights_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab, plen).tolist()
               for _ in range(FAMILY_REQUESTS)]
    engine = ServingEngine(cfg, params, max_batch=8, cache_len=cache_len,
                           device=dev)
    del params
    CT.reset_launches()
    engine.run([Request(uid=-1, prompt=prompts[0], max_new_tokens=2)])
    shapes = collections.Counter(CT.SHAPE_LAUNCHES)
    engine.stats = LMServeStats()                 # warm-up not counted
    reqs = [Request(uid=i, prompt=pr, max_new_tokens=FAMILY_NEW)
            for i, pr in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CT.reset_launches()
    engine.run(reqs)
    launches = CT.LAUNCHES["ternary_matmul"]
    by_variant = dict(CT.VARIANT_LAUNCHES)
    shapes.update(CT.SHAPE_LAUNCHES)
    peak_bytes = torch.cuda.max_memory_allocated()
    lm = engine.stats.summary()
    want = family_launches(cfg, lm["prefills"], lm["decode_steps"])
    want_kn = P.lin_shapes(cfg) if cfg.quant == "ternary_packed" else set()
    got_kn = {(K, N) for _, K, N, _ in shapes}
    finite = finite_logits(cfg, engine.params, prompts, cache_len)
    new = sum(len(r.output) for r in reqs)
    row = {"arch": cfg.name, "quant": cfg.quant,
           "kv_cache_dtype": cfg.kv_cache_dtype,
           "n_layers": cfg.n_layers, "published_layers": full.n_layers,
           "depth_cut": cfg.n_layers < full.n_layers,
           "enc_layers": cfg.enc_layers, "d_model": cfg.d_model,
           "n_heads": cfg.n_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "experts": None if cfg.moe is None else
           [cfg.moe.n_experts, cfg.moe.top_k],
           "params": P.param_count(cfg),
           "active_params": P.active_param_count(cfg),
           "published_params": P.param_count(full),
           "weights_s": weights_s, "requests": len(reqs),
           "prompt_tokens": plen, "cache_len": cache_len,
           "new_tokens": [len(r.output) for r in reqs],
           "prefill_ms": 1e3 * lm["prefill_s"] / max(lm["prefills"], 1),
           "decode_step_p50_ms": lm["decode_step_p50_ms"],
           "decode_step_p99_ms": lm["decode_step_p99_ms"],
           "tokens_per_s": new / (lm["prefill_s"] + lm["decode_s"]),
           "stats": lm, "ternary_matmul_launches": launches,
           "expected": sum(want.values()), "launches_by_variant": by_variant,
           "expected_by_variant": want,
           "shapes_with_warm_up": sorted([M, K, N, str(dt)[6:], n] for
                                         (M, K, N, dt), n in shapes.items()),
           "lin_kn": sorted(want_kn), "logits_finite": finite,
           "max_memory_allocated_bytes": peak_bytes}
    say("lm_families", **row)
    if any(len(r.output) != FAMILY_NEW for r in reqs):
        fail(f"lm_families: {cfg.name}: a request did not get its "
             f"{FAMILY_NEW} tokens")
    if not finite:
        fail(f"lm_families: {cfg.name}: non-finite logits")
    if by_variant != want:
        fail(f"lm_families: {cfg.name}: ternary_matmul launches by variant "
             f"{by_variant}, expected {want}")
    if got_kn != want_kn:
        fail(f"lm_families: {cfg.name}: ternary_matmul got (K, N) "
             f"{sorted(got_kn)}, the arch's projections are "
             f"{sorted(want_kn)}")
    return row | {"engine": engine, "shapes": shapes}


def moe_layer_check(cfg, lp: dict) -> dict:
    """Layer 0's `moe_ffn` on the card and on the CPU from one seeded bf16
    input at the served prefill shape: the experts each token picks, which
    assignments keep a slot and the slots equal exactly; outputs within
    `MOE_TOL` of the largest."""
    import torch

    from repro_torch.models import moe as MOE
    from repro_torch.models import params as P

    dev = lp["router"]["w"].device
    E, k, cf = cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.capacity_factor
    rng = np.random.default_rng(SEED + 7)
    x = torch.from_numpy(rng.standard_normal(
        (FAMILY_REQUESTS, 32, cfg.d_model), dtype=np.float32)) \
        .to(dev).to(torch.bfloat16)
    C = MOE.capacity(x.shape[0] * x.shape[1], E, k, cf)
    out = {}
    t0 = time.perf_counter()
    for where, p, xx in (("card", lp, x),
                         ("cpu", P.tree_map(lambda a: a.cpu(), lp),
                          x.cpu())):
        with torch.inference_mode():
            r = MOE.route(p["router"]["w"], xx.reshape(1, -1, cfg.d_model),
                          E, k, C)
            y, aux = MOE.moe_ffn(p, xx, n_experts=E, top_k=k,
                                 capacity_factor=cf)
        out[where] = (r, y.float().cpu(), float(aux))
        del p
    cpu_s = time.perf_counter() - t0
    (rc, yc, ac), (rh, yh, ah) = out["card"], out["cpu"]
    same = {n: bool(torch.equal(getattr(rc, n).cpu(), getattr(rh, n)))
            for n in ("tope", "keep", "dst")}
    err = float((yc - yh).abs().max())
    scale = float(yh.abs().max())
    row = {"arch": cfg.name, "tokens": x.shape[0] * x.shape[1],
           "experts": E, "top_k": k, "capacity": C,
           "dropped": int((~rh.keep).sum()), "equal": same,
           "max_abs_err": err, "max_abs_y": scale, "tol": MOE_TOL * scale,
           "aux_card": ac, "aux_cpu": ah, "seconds": cpu_s}
    say("lm_families_moe", **row)
    if not all(same.values()):
        fail(f"lm_families_moe: {cfg.name}: routing differs card vs CPU "
             f"{same}")
    if not err <= MOE_TOL * scale:
        fail(f"lm_families_moe: {cfg.name}: outputs differ by {err:.3g} > "
             f"{MOE_TOL} x {scale:.3g}")
    return row


def fp8_cache_check(cfg, params: dict, prompts: list[list[int]]) -> dict:
    """The fp8 KV cache a prefill writes on the card, as bytes, against the
    CPU's cast of the same prefill's compute-dtype K/V: bit for bit."""
    import torch

    from repro_torch.models import transformer as TF
    from repro_torch.serve.lm_engine import make_batch

    dev = params["embed"]["tokens"].device
    batch = make_batch(cfg, np.array(prompts), dev)
    with torch.inference_mode():
        _, c8 = TF.prefill(cfg, params, batch, 256)
        _, cc = TF.prefill(cfg.replace(kv_cache_dtype="compute"), params,
                           batch, 256)
    row = {"arch": cfg.name, "cache_bytes": 0, "mismatched_bytes": 0}
    for name in ("k", "v"):
        card = c8[name].view(torch.uint8).cpu()
        host = cc[name].cpu().to(torch.float8_e4m3fn).view(torch.uint8)
        row["cache_bytes"] += card.numel()
        row["mismatched_bytes"] += int((card != host).sum())
    say("lm_families_fp8", **row, dtype=str(c8["k"].dtype))
    if c8["k"].dtype != torch.float8_e4m3fn or row["mismatched_bytes"]:
        fail(f"lm_families_fp8: {row['mismatched_bytes']} of "
             f"{row['cache_bytes']} cache bytes differ from the CPU's cast")
    return row


def fp8_steps_apart(a, b):
    """How many fp8 e4m3 values apart two caches are, element by element
    (uint8 views): the magnitude bits order the values of one sign, so
    a signed ordinal of the code makes adjacent values 1 apart (+0 and -0
    both 0)."""
    import torch

    def ordinal(u):
        u = u.to(torch.int16)
        return torch.where(u >= 0x80, -(u & 0x7F), u & 0x7F)

    return (ordinal(a) - ordinal(b)).abs()


def fp8_cross_device(cfg32, p32: dict, prompt: list[int],
                     steps: int = 8) -> dict:
    """A float32 model with an fp8 KV cache on the card (kernels) and on
    the CPU (plain versions), both from `p32`.  The prefill runs on each
    side: logits within `LOGIT_TOL`, and each cache element within one fp8
    step of the CPU's (the two cast float32 K/V that agree to ~1e-6, so a
    value at a rounding midpoint may land on either neighbour).  Then
    `steps - 1` greedy decode steps, the CPU handed the card's cache and
    token before each one, so both read the same fp8 bytes: logits within
    `LOGIT_TOL`, the card's tokens equal the CPU's wherever the top-2
    margin exceeds it, and the row each step writes within one fp8 step.
    (Left to run free, one rounding flip per ~10^5 elements would feed
    each side different bytes from then on.)"""
    import torch

    from repro_torch.models import params as P
    from repro_torch.models import transformer as TF
    from repro_torch.serve.lm_engine import make_batch

    dev = p32["embed"]["tokens"].device
    p_cpu = P.tree_map(lambda a: a.cpu(), p32)
    toks = np.array([prompt])
    diffs, margins, card_tokens, cpu_tokens = [], [], [], []
    cache = {"bytes": 0, "differing": 0, "max_steps_apart": 0}

    def compare(lc, lh, cc, ch, pos: slice) -> None:
        diffs.append(float((lc - lh).abs().max()))
        top2 = lh.topk(2).values
        margins.append(float(top2[0] - top2[1]))
        card_tokens.append(int(lc.argmax()))
        cpu_tokens.append(int(lh.argmax()))
        for n in ("k", "v"):
            a = cc[n][:, :, pos].cpu().view(torch.uint8)
            b = ch[n][:, :, pos].view(torch.uint8)
            cache["bytes"] += a.numel()
            cache["differing"] += int((a != b).sum())
            cache["max_steps_apart"] = max(cache["max_steps_apart"],
                                           int(fp8_steps_apart(a, b).max()))

    t0 = time.perf_counter()
    with torch.inference_mode():
        hc, cc = TF.prefill(cfg32, p32, make_batch(cfg32, toks, dev), 256)
        hh, ch = TF.prefill(cfg32, p_cpu, make_batch(cfg32, toks, "cpu"),
                            256)
        lc = TF.logits_from_hidden(cfg32, p32, hc[:, -1:])[0, 0].cpu()
        lh = TF.logits_from_hidden(cfg32, p_cpu, hh[:, -1:])[0, 0]
        compare(lc, lh, cc, ch, slice(0, len(prompt)))
        for step in range(steps - 1):
            pos = len(prompt) + step
            tok = torch.tensor([[card_tokens[-1]]])
            ch = {n: t.cpu() for n, t in cc.items()}
            lc, cc = TF.decode_step(cfg32, p32, cc, tok.to(dev), pos)
            lh, ch = TF.decode_step(cfg32, p_cpu, ch, tok, pos)
            compare(lc[0, 0].cpu(), lh[0, 0], cc, ch, slice(pos, pos + 1))
    row = {"arch": cfg32.name, "n_layers": cfg32.n_layers,
           "d_model": cfg32.d_model, "kv_cache_dtype": cfg32.kv_cache_dtype,
           "cache_dtype": str(cc["k"].dtype), "prompt_tokens": len(prompt),
           "steps": steps, "logit_tol": LOGIT_TOL,
           "max_abs_diff_per_step": diffs, "top2_margin": margins,
           "card_tokens": card_tokens, "cpu_tokens": cpu_tokens,
           "cache_written": cache, "seconds": time.perf_counter() - t0}
    say("lm_families_cross_device", **row)
    if cc["k"].dtype != torch.float8_e4m3fn:
        fail(f"lm_families_cross_device: {cfg32.name}: cache is "
             f"{cc['k'].dtype}, not fp8")
    if max(diffs) > LOGIT_TOL:
        fail(f"lm_families_cross_device: {cfg32.name} (fp8 KV): logits "
             f"differ by {max(diffs):.3g} > {LOGIT_TOL}")
    for step, (a, b, m) in enumerate(zip(card_tokens, cpu_tokens, margins)):
        if m > LOGIT_TOL and a != b:
            fail(f"lm_families_cross_device: {cfg32.name} (fp8 KV): step "
                 f"{step} token {a} on the card, {b} on the CPU")
    if cache["max_steps_apart"] > 1:
        fail(f"lm_families_cross_device: {cfg32.name}: fp8 cache values "
             f"{cache['max_steps_apart']} steps apart card vs CPU")
    return row


def ternary_families(dev, served: dict) -> tuple[list[dict], float]:
    """The ternary matmul at every `(M, K, N, x dtype)` it was given while
    the families were served (`served`: each arch's launches by shape,
    the warm-up included): every element inside the f32 envelope
    eps * sqrt(K) * (|x| @ |w|) * |scale| + 1e-6 around the float64
    product; then kernel, plain version, `library_ms` (one torch.matmul on
    the weights unpacked to x's dtype beforehand) and bound.  Returns the
    rows and the largest kernel-vs-plain difference."""
    import torch

    from repro_torch.core.ternary import unpack_ternary
    from repro_torch.kernels import cuda_ternary_matmul as CT
    from repro_torch.kernels import ternary_matmul as TM
    from repro_torch.roofline.kernel_model import ternary_bound_ms

    eps32 = float(np.finfo(np.float32).eps)
    cases: dict = {}
    for arch, shapes in served.items():
        for shape, n in shapes.items():
            cases.setdefault(shape, {})[arch] = n
    rows, max_err = [], 0.0
    for (M, K, N, dt), archs in sorted(
            cases.items(), key=lambda c: (c[0][1], c[0][2], c[0][0],
                                          str(c[0][3]))):
        g = torch.Generator(device=dev).manual_seed(SEED + M + K + N)
        x = torch.randn(M, K, device=dev, generator=g).to(dt)
        w2 = torch.randint(-128, 128, (K // 4, N), device=dev, generator=g,
                           dtype=torch.int8)
        sc = torch.rand(1, N, device=dev, generator=g) + 0.5
        got = TM.ternary_matmul(x, w2, sc)
        plain = TM.ternary_matmul_plain(x, w2, sc)
        w64 = unpack_ternary(w2, torch.float64)
        x64, s64 = x.double(), sc.double()
        bound = eps32 * K ** 0.5 * ((x64.abs() @ w64.abs()) * s64) + 1e-6
        ratio = float(((got.double() - (x64 @ w64) * s64).abs()
                       / bound).max())
        err = float((got - plain).abs().max())
        del w64, x64, bound
        max_err = max(max_err, err)
        p = CT.plan(M, K, N, dt)
        w_dense = unpack_ternary(w2, dt)
        row = {"archs": archs, "M": M, "K": K, "N": N, "x": str(dt)[6:],
               "variant": p.variant, "splits": p.splits,
               "tile": list(p.tile), "err_over_envelope": ratio,
               "max_abs_err": err,
               "ms": gpu_ms(lambda: TM.ternary_matmul(x, w2, sc),
                            TIMED_REPS, True),
               "plain_ms": gpu_ms(lambda: TM.ternary_matmul_plain(x, w2, sc),
                                  PLAIN_REPS, True),
               "library_ms": gpu_ms(lambda: torch.matmul(x, w_dense) * sc,
                                    TIMED_REPS, True)}
        row["bound_ms"], row["bound_by"] = ternary_bound_ms(
            M, K, N, x.element_size())
        del w_dense
        rows.append(row)
        say("lm_families_ternary", **row)
        if ratio > 1:
            fail(f"lm_families_ternary: (M={M}, K={K}, N={N}, {dt}) outside "
                 f"the f32 envelope by {ratio:.3g}x")
    return rows, max_err


def lm_families_phase(dev) -> dict:
    """`lm_families`: every row of `launch.families.FAMILIES` served at
    full width on the card (launches counted per arch, every shape the
    ternary matmul got recorded), with layer 0's MoE against the CPU for
    mixtral and arctic and the fp8 cache bytes against the CPU's cast for
    llama; whisper at `WHISPER_CROSS_DEPTH` layers (encoder and decoder),
    hymba at `HYMBA_CROSS_DEPTH` and llama with its fp8 KV cache at
    `LM_CROSS_DEPTH`, card against CPU in float32; then the
    ternary matmul at every shape served.  Returns the rows, the launches
    by arch and the matmul's rows."""
    import gc

    import torch

    from repro_torch.launch.families import FAMILIES
    from repro_torch.models import params as P

    t_phase = time.perf_counter()
    rows, moe, fp8, served = {}, {}, {}, {}
    for fam in FAMILIES:
        row = serve_family(dev, fam)
        engine, served[fam.arch] = row.pop("engine"), row.pop("shapes")
        cfg = engine.cfg
        if cfg.moe is not None:
            moe[fam.arch] = moe_layer_check(cfg, {
                n: {k: v[0] for k, v in leaf.items()}
                for n, leaf in engine.params["layers"]["moe"].items()})
        if cfg.kv_cache_dtype != "compute":
            fp8[fam.arch] = fp8_cache_check(cfg, engine.params, [
                np.random.default_rng(SEED + 1).integers(
                    1, cfg.vocab, fam.prompt_tokens).tolist()
                for _ in range(FAMILY_REQUESTS)])
        rows[fam.arch] = row
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 2)
    f32 = {"param_dtype": "float32", "compute_dtype": "float32"}
    cross = {"whisper-medium": WHISPER_CROSS_DEPTH,
             "hymba-1.5b": HYMBA_CROSS_DEPTH, "llama3.2-1b": LM_CROSS_DEPTH}
    for fam in FAMILIES:
        if fam.arch not in cross:
            continue
        cfg32 = fam.config(**f32)
        cfg32 = cfg32.replace(n_layers=cross[fam.arch], **(
            {"enc_layers": cross[fam.arch]} if cfg32.enc_layers else {}))
        p32 = P.serving_params(cfg32, SEED, dev)
        prompt = rng.integers(1, cfg32.vocab, 16).tolist()
        if cfg32.kv_cache_dtype == "compute":
            cross_device("lm_families_cross_device", cfg32, p32, prompt)
        else:
            fp8[fam.arch + "_cross_device"] = fp8_cross_device(
                cfg32, p32, prompt)
        del p32
        gc.collect()
        torch.cuda.empty_cache()
    tm_rows, tm_err = ternary_families(dev, served)
    say("lm_families_done", seconds=time.perf_counter() - t_phase,
        archs=list(rows))
    return {"rows": rows, "moe": moe, "fp8": fp8, "ternary": tm_rows,
            "ternary_max_abs_err": tm_err,
            "launches": {a: r["ternary_matmul_launches"]
                         for a, r in rows.items()},
            "by_variant": {a: r["launches_by_variant"]
                           for a, r in rows.items()}}


def golden_classifier(name: str):
    """The golden classifier of `name` lowered by the port's functions:
    `tests/test_golden.py`'s recipe (seeded untrained ternary weights,
    zero-balanced output columns, the ABC medians, exact netlists)."""
    import hashlib

    from repro_torch.compile.ir import lower_classifier
    from repro_torch.core import tnn as T
    from repro_torch.core.ternary import TERNARY_THRESHOLD, abc_fit_thresholds
    from repro_torch.data.tabular import make_dataset

    ds = make_dataset(name)
    F, H, Cc = ds.spec.topology
    digest = hashlib.sha256(f"golden:{name}".encode()).digest()
    rng = np.random.default_rng(int.from_bytes(digest[:8], "little"))
    w1_latent = rng.normal(0.0, 0.7, size=(F, H))
    w2_latent = rng.normal(0.0, 0.7, size=(H, Cc))
    w1t = (np.sign(w1_latent)
           * (np.abs(w1_latent) > TERNARY_THRESHOLD)).astype(np.int8)
    w2t = T.balance_zero_counts(w2_latent, TERNARY_THRESHOLD)
    tnn = T.TrainedTNN(w1t=w1t, w2t=w2t,
                       thresholds=abc_fit_thresholds(ds.x_train),
                       train_acc=0.0, test_acc=0.0, name=name)
    return lower_classifier(tnn, *T.exact_netlists(tnn))


def same_netlists(a: list, b: list) -> bool:
    """Two netlist lists equal gate for gate, with equal names and meta."""
    return len(a) == len(b) and all(
        x.n_inputs == y.n_inputs and x.name == y.name and x.meta == y.meta
        and all(np.array_equal(getattr(x, k), getattr(y, k))
                for k in ("op", "in0", "in1", "outputs"))
        for x, y in zip(a, b))


def campaign_phase(dev, smi: str) -> tuple:
    """`campaign` — the paper's Phases 1-3 on arrhythmia's golden TNN at
    full width through the port's entry points, counted, then held against
    the CPU bit for bit; returns the launches, timings and checks, the
    problem on the card and the NSGA-II result."""
    import torch

    from repro_torch.configs.tnn_paper import get_tnn_config
    from repro_torch.core import cgp, pcc
    from repro_torch.core import tnn as T
    from repro_torch.core.circuits import NetlistPopulation, eval_vectors
    from repro_torch.core.nsga2 import NSGA2Config
    from repro_torch.core.ternary import abc_binarize
    from repro_torch.data.tabular import make_dataset
    from repro_torch.kernels import circuit_sim as CS
    from repro_torch.kernels import cuda_circuit_sim as CK
    from repro_torch.roofline.kernel_model import (bound_ms, chain_bound_ms,
                                                   ops_bound_ms)

    cfg = get_tnn_config("arrhythmia")
    tnn = T.load_tnn(EMIT_DIR / "arrhythmia_tnn.npz")
    ds = make_dataset("arrhythmia")
    xb = abc_binarize(ds.x_train, tnn.thresholds, device=dev)
    sizes, pcc_sizes = set(), []
    for p, n in tnn.hidden_sizes():
        if p >= 1 and n >= 1:
            sizes.update([p, n])
            pcc_sizes.append((p, n))
    out_n = max(tnn.out_nnz, 1)
    sizes.add(out_n)
    pcc_sizes = sorted(set(pcc_sizes))

    CK.reset_launches()
    counts = {}

    def take_counts(name: str) -> None:
        counts[name] = {"launches": dict(CK.LAUNCHES),
                        "by_variant": dict(CK.VARIANT_LAUNCHES),
                        "schedule_launches": dict(CK.SCHEDULE_LAUNCHES)}

    # Phase 1: a CGP popcount library for every size, the reference's grid
    t0 = time.perf_counter()
    pc_libs, runs, size_s = {}, {}, {}
    for n in sorted(sizes):
        runs[n] = []
        t = time.perf_counter()
        pc_libs[n] = cgp.evolve_pc_library(
            n, n_points=CAMPAIGN_POINTS, max_iters=CAMPAIGN_ITERS, device=dev,
            results=runs[n])
        size_s[n] = time.perf_counter() - t
    phase1_s = time.perf_counter() - t0
    take_counts("phase1")
    evaluations = sum(r.evaluations for rs in runs.values() for r in rs)
    generations = CAMPAIGN_ITERS * sum(len(rs) for rs in runs.values())
    # Phase 2: the PCC library over 30,000 sampled pairs a size
    t0 = time.perf_counter()
    pcc_lib = pcc.build_pcc_library(pcc_sizes, pc_libs,
                                    n_samples=CAMPAIGN_PCC_SAMPLES,
                                    device=dev)
    pc_out = pcc.pc_pareto(pc_libs[out_n])
    phase2_s = time.perf_counter() - t0
    take_counts("phase2")
    # Phase 3: NSGA-II over the per-neuron choices; every objective call
    # is recorded and must be one launch that builds no schedule
    t0 = time.perf_counter()
    prob = T.TNNApproxProblem(tnn=tnn, pcc_lib=pcc_lib, pc_out_lib=pc_out,
                              xbin=xb, y=ds.y_train, device=dev)
    setup_s = time.perf_counter() - t0
    take_counts("problem")
    scored, per_call, walls = [], [], []
    objective = prob.objective

    def counted(pop):
        before = CK.LAUNCHES["fused_eval_uint"]
        t = time.perf_counter()
        f = objective(pop)
        walls.append(time.perf_counter() - t)
        per_call.append(CK.LAUNCHES["fused_eval_uint"] - before)
        scored.append((np.array(pop), f))
        return f

    prob.objective = counted       # what `optimize` hands to NSGA-II
    t0 = time.perf_counter()
    res = prob.optimize(NSGA2Config(pop_size=cfg.nsga_pop,
                                    n_generations=cfg.nsga_generations,
                                    seed=SEED))
    phase3_s = time.perf_counter() - t0
    take_counts("phase3")
    del prob.objective
    front = []
    for x, f in zip(res.pareto_x, res.pareto_f):
        cost = T.tnn_hw_cost(tnn, *prob.decode(x))
        front.append({"genes": x.tolist(), "error": float(f[0]),
                      "est_area_mm2": float(f[1]),
                      "area_mm2": cost.area_mm2, "power_mw": cost.power_mw})
    exact_cost = T.tnn_hw_cost(tnn, *T.exact_netlists(tnn))
    individuals = sum(p.shape[0] for p, _ in scored)

    # the kernel's share of an objective call: the launch alone (CUDA
    # events) against the call on the host's clock, at a population of
    # nsga_pop random individuals
    pop = np.random.default_rng(SEED).integers(
        0, prob.domains()[None, :], size=(cfg.nsga_pop, prob.n_genes))
    args = prob.launch_args(pop)
    checks = {"objective_launch": torch.equal(
        CK.fused_eval_uint(*args), CS.population_eval_uint(*args[:6]))}
    kernel_ms = gpu_ms(lambda: CK.fused_eval_uint(*args), TIMED_REPS, True)
    plain_ms = gpu_ms(lambda: CS.population_eval_uint(*args[:6]),
                      PLAIN_REPS, False)
    call_ms = []
    for _ in range(TIMED_REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        prob.objective(pop)
        call_ms.append((time.perf_counter() - t) * 1e3)
    rows = [prob.out_cands[int(k)] for k in pop[:, len(prob.hidden_idx):]
            .reshape(-1)]
    W = args[4].shape[-1]
    obj_programs = [(nl.n_inputs, nl.n_gates, nl.n_outputs, W)
                    for nl in rows]
    obj_bound = bound_ms(obj_programs, True)
    mhz = max_sm_clock_mhz()
    # Phase 1's launch shape at the widest size: lambda = 4 children of the
    # 933-node grid over 2**17 vectors, the kernel alone with a schedule,
    # and one fitness call as a generation pays it (schedule built on the
    # card, errors reduced on it, two arrays to the host)
    n_big = max(sizes)
    packed, true = eval_vectors(n_big)
    kid_nls = (pc_libs[n_big] * 4)[:4]
    kids = NetlistPopulation.from_netlists(kid_nls)
    plan = [torch.from_numpy(a).to(dev) for a in CS.check_plan(
        kids.op, kids.in0, kids.in1, kids.outputs, n_big)]
    words = CS.words_tensor(CS.pack_words32(packed), dev)
    true_dev = torch.from_numpy(true).to(dev)
    sched = CK.schedule(*plan[:3], n_big, device=dev)
    checks["cgp_launch"] = torch.equal(
        CK.fused_eval_uint(*plan, words, n_big, schedule=sched),
        CS.population_eval_uint(*plan, words, n_big))
    cgp_kernel_ms = gpu_ms(lambda: CK.fused_eval_uint(*plan, words, n_big,
                                                      schedule=sched),
                           TIMED_REPS, True)
    cgp_plain_ms = gpu_ms(lambda: CS.population_eval_uint(*plan, words,
                                                          n_big), 1, False)
    fitness_ms = []
    for _ in range(TIMED_REPS):
        t = time.perf_counter()
        kids.pc_errors(words, true_dev, device=dev)
        fitness_ms.append((time.perf_counter() - t) * 1e3)
    cgp_programs = [(n_big, nl.n_gates, nl.n_outputs, words.shape[1])
                    for nl in kid_nls]
    cgp_bound = bound_ms(cgp_programs, True, shared_plane=True)

    # held against the CPU, bit for bit: the widest size's truncation
    # sweep (one launch of n - 2 rows), then a CGP run, a PCC size, every
    # population NSGA-II scored and a short search
    trunc_dev, trunc_cpu = (cgp._truncation_stats(n_big, packed, true, d)
                            for d in (dev, "cpu"))
    checks["truncation_sweep"] = [r[1:] for r in trunc_dev] == [
        r[1:] for r in trunc_cpu]
    cpu_runs, dev_runs = [], []
    small = min(n for n in sizes if n > 16)
    lib_cpu = cgp.evolve_pc_library(small, n_points=1,
                                    max_iters=CAMPAIGN_CPU_ITERS,
                                    device="cpu", results=cpu_runs)
    lib_dev = cgp.evolve_pc_library(small, n_points=1,
                                    max_iters=CAMPAIGN_CPU_ITERS, device=dev,
                                    results=dev_runs)
    checks["cgp_library"] = same_netlists(lib_cpu, lib_dev) and [
        r.evaluations for r in cpu_runs] == [r.evaluations for r in dev_runs]
    size = pcc_sizes[0]
    e_cpu = pcc.build_pcc_library([size], pc_libs, CAMPAIGN_PCC_SAMPLES,
                                  device="cpu").get(*size)
    e_dev = pcc_lib.get(*size)
    checks["pcc_entries"] = [
        (e.mde, e.wcde, e.correct_frac, e.est_area, e.pc_pos.name,
         e.pc_neg.name) for e in e_cpu] == [
        (e.mde, e.wcde, e.correct_frac, e.est_area, e.pc_pos.name,
         e.pc_neg.name) for e in e_dev]
    prob_cpu = T.TNNApproxProblem(tnn=tnn, pcc_lib=pcc_lib, pc_out_lib=pc_out,
                                  xbin=xb.cpu(), y=ds.y_train, device="cpu")
    checks["objective"] = all(np.array_equal(prob_cpu.objective(p), f)
                              for p, f in scored)
    short = NSGA2Config(pop_size=16, n_generations=4, seed=SEED + 1)
    r_cpu, r_dev = prob_cpu.optimize(short), prob.optimize(short)
    checks["nsga2_archive"] = bool(
        np.array_equal(r_cpu.pareto_x, r_dev.pareto_x)
        and np.array_equal(r_cpu.pareto_f, r_dev.pareto_f)
        and r_cpu.history == r_dev.history)
    # each front design's error is its decoded circuits' error, one
    # netlist at a time on the card, and the exact circuits give the
    # integer path's labels
    xb_host = xb.cpu().numpy()
    checks["front_error"] = all(
        r["error"] == 1.0 - float((T.predict_with_circuits(
            tnn, xb_host, *prob.decode(x), device=dev) == ds.y_train).mean())
        for r, x in zip(front, res.pareto_x))
    checks["exact_circuits"] = bool(np.array_equal(
        T.predict_with_circuits(tnn, xb_host, *T.exact_netlists(tnn),
                                device=dev),
        T.predict_exact(tnn, xb_host)))

    out = {
        "nvidia_smi": smi, "tnn": "tests/golden_emit/arrhythmia_tnn.npz",
        "topology": list(tnn.topology), "hidden_sizes": tnn.hidden_sizes(),
        "out_nnz": tnn.out_nnz, "train_rows": int(ds.y_train.shape[0]),
        "pc_sizes": sorted(sizes), "pcc_sizes": pcc_sizes,
        "budget": {"n_points": CAMPAIGN_POINTS, "max_iters": CAMPAIGN_ITERS,
                   "pcc_samples": CAMPAIGN_PCC_SAMPLES,
                   "nsga_pop": cfg.nsga_pop,
                   "nsga_generations": cfg.nsga_generations,
                   "reference_default": "n_points 3 (3 tau points a "
                   "metric) x max_iters 500 (build_tnn_problem)"},
        "seconds": {"phase1": phase1_s, "phase2": phase2_s,
                    "problem_build": setup_s, "phase3": phase3_s},
        "phase1": {"tau_points": sum(len(r) for r in runs.values()),
                   "generations": generations, "evaluations": evaluations,
                   "evaluations_per_s": evaluations / phase1_s,
                   "generations_per_s": generations / phase1_s,
                   "seconds_by_size": size_s,
                   "library_sizes": {n: len(v) for n, v in pc_libs.items()}},
        "phase2": {"entries": {f"{p}x{n}": len(v)
                               for (p, n), v in pcc_lib.entries.items()},
                   "pc_out": len(pc_out)},
        "phase3": {"objective_calls": len(scored),
                   "individuals": individuals,
                   "objective_s": sum(walls),
                   "objective_p50_ms": float(np.median(walls)) * 1e3,
                   "launches_per_call": sorted(set(per_call)),
                   "front_size": len(front), "front": front,
                   "exact_area_mm2": exact_cost.area_mm2,
                   "best_area_mm2": min(r["area_mm2"] for r in front)},
        "objective_launch": {
            "rows": int(args[0].shape[0]), "W": int(W),
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "call_p50_ms": float(np.median(call_ms)),
            "individuals_per_s": cfg.nsga_pop / float(np.median(call_ms))
            * 1e3,
            "kernel_share": kernel_ms / float(np.median(call_ms)),
            "bound_ms": obj_bound[0], "bound_by": obj_bound[1],
            "ops_bound_ms": ops_bound_ms(obj_programs),
            "schedule_depth": int(args[-1].depth),
            "chain_bound_ms": chain_bound_ms(args[-1].depth, mhz)},
        "cgp_launch": {
            "n": n_big, "P": kids.size, "G": kids.n_gates,
            "W": int(words.shape[1]), "kernel_ms": cgp_kernel_ms,
            "plain_ms": cgp_plain_ms, "bound_ms": cgp_bound[0],
            "bound_by": cgp_bound[1], "schedule_depth": sched.depth,
            "ops_bound_ms": ops_bound_ms(cgp_programs),
            "chain_bound_ms": chain_bound_ms(sched.depth, mhz),
            "fitness_call_p50_ms": float(np.median(fitness_ms))},
        "counts": counts, "checks": checks,
    }
    say("campaign", **out)
    phase3 = counts["phase3"]
    calls = phase3["launches"]["fused_eval_uint"] - \
        counts["problem"]["launches"]["fused_eval_uint"]
    if calls != len(scored) or set(per_call) != {1}:
        fail(f"campaign: {calls} launches for {len(scored)} objective calls "
             f"(per call {sorted(set(per_call))}), expected one each")
    if phase3["schedule_launches"] != counts["problem"]["schedule_launches"]:
        fail("campaign: a schedule was built during the NSGA-II run")
    for name in ("phase1", "phase2", "problem"):
        if not counts[name]["launches"]["fused_eval_uint"]:
            fail(f"campaign: {name} never launched fused_eval_uint")
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"campaign: card and CPU differ: {bad}")
    return out, prob, res


def qat_step_check(dev, ds, cfg) -> dict:
    """One QAT step from the same seeded parameters and batch on the card
    and on the CPU: the loss's relative difference, the gradients' and the
    updated latents' largest absolute differences, and max|g|.  Then
    LOOP_STEPS steps on the card with sync debugging on: a step that waits
    for the host raises."""
    import torch

    from repro_torch.core import tnn as T
    from repro_torch.core.ternary import abc_binarize, abc_fit_thresholds
    from repro_torch.optim import adamw

    F, H, Cc = ds.spec.topology
    rng = np.random.default_rng(SEED)
    arrays = {"w1": rng.normal(0, 0.7, (F, H)),
              "w2": rng.normal(0, 0.7, (H, Cc))}
    idx = rng.permutation(ds.y_train.shape[0])[: cfg.batch_size]
    thr = abc_fit_thresholds(ds.x_train)
    ocfg = adamw.AdamWConfig(lr=cfg.lr, grad_clip=1.0)
    runs = []
    for d in ("cpu", dev):
        params = T.params_from_arrays(arrays, d)
        xb = abc_binarize(ds.x_train[idx], thr, device=d)
        y = torch.from_numpy(ds.y_train[idx].astype(np.int64)).to(d)
        loss, grads = T.loss_and_grads(params, xb, y, cfg.threshold, H)
        new, _, _ = T.train_step(params, adamw.init(params), xb, y, cfg,
                                 ocfg)
        runs.append((float(loss), {k: g.cpu() for k, g in grads.items()},
                     {k: v.cpu() for k, v in new.items()}))
    (l_cpu, g_cpu, p_cpu), (l_dev, g_dev, p_dev) = runs
    # the training loop on the card never waits for the host: steps run
    # with PyTorch's sync debugging set to raise on any synchronizing call
    state = adamw.init(params)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(LOOP_STEPS):
            params, state, _ = T.train_step(params, state, xb, y, cfg, ocfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return {"loss_rel_diff": abs(l_dev - l_cpu) / abs(l_cpu),
            "grad_max_abs": max(float(g.abs().max()) for g in g_cpu.values()),
            "grad_max_abs_diff": max(float((g_dev[k] - g_cpu[k]).abs().max())
                                     for k in g_cpu),
            "latent_max_abs_diff": max(float((p_dev[k] - p_cpu[k]).abs()
                                             .max()) for k in p_cpu)}


def pipeline_phase(dev, smi: str, prob, res) -> dict:
    """`pipeline` — the paper's pipeline from sensor floats to served labels
    through the port's entry points, with no file the reference wrote, the
    gate-walk counters zeroed first: per Table-2 dataset, QAT on the card
    (and on the CPU, timed beside it), one step card against CPU, lowering,
    `write_artifacts`, the emitted Verilog read back by `vread` against the
    program on the card, the test set served; the five golden classifiers
    lowered by the port, each bundle held to the committed sha256; the
    campaign's NSGA-II front decoded, lowered and served; and the export CLI
    run once on the card.  Returns the launches, timings and checks."""
    import hashlib
    import os
    import tempfile

    import torch

    from repro_torch.compile import artifact as A
    from repro_torch.compile.ir import lower_classifier
    from repro_torch.compile.program import CircuitProgram
    from repro_torch.compile.verilog import egfet_report, write_artifacts
    from repro_torch.compile.vread import (VerilogDesign,
                                          eval_classifier_verilog)
    from repro_torch.core import tnn as T
    from repro_torch.core.ternary import abc_binarize
    from repro_torch.data.tabular import DATASETS, make_dataset
    from repro_torch.kernels import circuit_sim as CS
    from repro_torch.kernels import cuda_circuit_sim as CK
    from repro_torch.kernels import dispatch as D
    from repro_torch.roofline.kernel_model import (bound_ms, chain_bound_ms,
                                                   ops_bound_ms)
    from repro_torch.serve.engine import CircuitServingEngine

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        fail("pipeline: float32 matmuls must run in full float32 (TF32 off)")
    rng = np.random.default_rng(SEED)
    CK.reset_launches()
    rows, checks, progs = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name in sorted(DATASETS):
            ds = make_dataset(name)
            cfg = T.TNNTrainConfig(n_hidden=ds.spec.topology[1],
                                   epochs=PIPE_EPOCHS, lr=PIPE_LR, seed=SEED)
            steps = cfg.epochs * -(-ds.y_train.shape[0] // cfg.batch_size)
            gold = T.load_tnn(EMIT_DIR / f"{name}_tnn.npz")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tnn = T.train_tnn(ds, cfg, device=dev)
            train_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            tnn_cpu = T.train_tnn(ds, cfg, device="cpu")
            cpu_s = time.perf_counter() - t0
            step = qat_step_check(dev, ds, cfg)

            t0 = time.perf_counter()
            hidden, outs = T.exact_netlists(tnn)
            cc = lower_classifier(tnn, hidden, outs)
            lower_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            paths = write_artifacts(cc, tmp / "emit", base=f"tnn_{name}",
                                    dataset=name)
            write_ms = (time.perf_counter() - t0) * 1e3
            prog = progs[name] = CircuitProgram.from_classifier(
                cc, device=dev)
            bundle = A.load_program(paths["program"], device=dev,
                                    expect_sha256=paths["entry"]["sha256"])
            xbits = rng.integers(0, 2, size=(PIPE_VERIFY, cc.n_features)
                                 ).astype(np.uint8)
            t0 = time.perf_counter()
            with open(paths["verilog"]) as f:
                rtl = eval_classifier_verilog(VerilogDesign.parse(f.read()),
                                              xbits)
            vread_ms = (time.perf_counter() - t0) * 1e3
            on_card = prog.predict_bits(xbits)

            reps = -(-PIPE_STREAM // ds.x_test.shape[0])
            stream = np.tile(ds.x_test, (reps, 1))[:PIPE_STREAM]
            eng = CircuitServingEngine(prog, max_batch=PIPE_BATCH)
            eng.warmup()
            labels = eng.classify_stream(stream)
            served = eng.stats.summary()
            xb = abc_binarize(stream, tnn.thresholds, device="cpu").numpy()
            want = T.predict_with_circuits(tnn, xb, hidden, outs,
                                           device="cpu")
            # the score taps (`simulate_population`) against the integer
            # path's XNOR-match counts
            xb_test = xb[: ds.x_test.shape[0]]
            h = (xb_test.astype(np.int64) @ tnn.w1t.astype(np.int64)
                 >= 0).astype(np.int64)
            w2 = tnn.w2t.astype(np.int64)
            nnz = (tnn.w2t != 0).sum(axis=0)
            report = egfet_report(cc)
            rows[name] = {
                "topology": list(tnn.topology), "train_rows":
                int(ds.y_train.shape[0]), "steps": steps,
                "train_s": train_s, "steps_per_s": steps / train_s,
                "cpu_train_s": cpu_s, "cpu_steps_per_s": steps / cpu_s,
                "test_acc": tnn.test_acc, "cpu_test_acc": tnn_cpu.test_acc,
                "golden_test_acc": gold.test_acc,
                "codes_differing_from_golden": {
                    k: int((getattr(tnn, k) != getattr(gold, k)).sum())
                    for k in ("w1t", "w2t")},
                "codes_differing_from_cpu": {
                    k: int((getattr(tnn, k) != getattr(tnn_cpu, k)).sum())
                    for k in ("w1t", "w2t")},
                "step": step, "n_gates": cc.ir.n_gates,
                "depth": cc.ir.depth,
                "total_area_mm2": report["total_area_mm2"],
                "lower_ms": lower_ms, "write_artifacts_ms": write_ms,
                "vread_ms": vread_ms,
                "readings_per_s": served["readings_per_s"],
                "dispatch_p50_ms": served["p50_ms"],
                "dispatches": served["n_batches"]}
            checks[name] = {
                "balanced": bool((nnz == nnz[0]).all()),
                "accuracy": abs(tnn.test_acc - gold.test_acc)
                <= PIPE_ACC_TOL,
                "step_grads": step["grad_max_abs_diff"]
                <= PIPE_GRAD_TOL * step["grad_max_abs"],
                "vread_equals_card": bool(np.array_equal(rtl, on_card)),
                "bundle_equals_program": bool(np.array_equal(
                    bundle.predict_bits(xbits), on_card)),
                "served_equals_circuits": bool(np.array_equal(labels, want)),
                "circuits_equal_integer_path": bool(np.array_equal(
                    want, T.predict_exact(tnn, xb))),
                "scores_equal_integer_path": bool(np.array_equal(
                    prog.scores(xb_test),
                    h @ (w2 == 1) + (1 - h) @ (w2 == -1)))}

        # two card trainings of arrhythmia: the same latents?
        ds = make_dataset("arrhythmia")
        cfg = T.TNNTrainConfig(n_hidden=ds.spec.topology[1],
                               epochs=PIPE_EPOCHS, lr=PIPE_LR, seed=SEED)
        repeat, repeat_s = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            repeat.append(T.train_latents(ds, cfg, device=dev)[0])
            torch.cuda.synchronize()
            repeat_s.append(time.perf_counter() - t0)
        a, b = repeat
        repeat_identical = all(torch.equal(a[k], b[k]) for k in a)

        # the golden classifiers lowered by the port: the reference's bytes
        golden = {}
        for name in sorted(DATASETS):
            cc = golden_classifier(name)
            path = Path(A.save_program(cc, tmp / "golden"
                                       / f"{name}{A.PROGRAM_SUFFIX}"))
            digest = hashlib.sha256(path.read_bytes()).hexdigest()
            fix = np.load(GOLDEN_DIR / f"{name}.npz")
            golden[name] = {
                "sha256_equals_sidecar": digest == (
                    EMIT_DIR / f"{name}{A.PROGRAM_SUFFIX}.sha256"
                ).read_text().strip(),
                "labels_equal_golden": bool(np.array_equal(
                    CircuitProgram.from_classifier(cc, device=dev).predict(
                        fix["x"]), fix["labels"]))}

        # the campaign's NSGA-II front: decoded, lowered, served on the card
        x_train = make_dataset("arrhythmia").x_train
        front = []
        for i, (x, f) in enumerate(zip(res.pareto_x, res.pareto_f)):
            hidden, outs = prob.decode(x)
            cc = lower_classifier(prob.tnn, hidden, outs,
                                  name=f"arrhythmia_front_{i}")
            eng = CircuitServingEngine(
                CircuitProgram.from_classifier(cc, device=dev),
                max_batch=PIPE_BATCH)
            labels = eng.classify_stream(x_train)
            error = 1.0 - float((labels == prob.y).mean())
            front.append({
                "genes": x.tolist(), "n_gates": cc.ir.n_gates,
                "depth": cc.ir.depth, "error": error,
                "labels_equal_circuits": bool(np.array_equal(
                    labels, T.predict_with_circuits(prob.tnn, prob.xbin,
                                                    hidden, outs,
                                                    device=dev))),
                "error_equals_objective": error == float(f[0])})
        launches = dict(CK.LAUNCHES)
        by_variant = dict(CK.VARIANT_LAUNCHES)

        # each card-trained program's launch at the engine's batch, timed
        # after the count: the kernel, its plain version and the bounds
        mhz = max_sm_clock_mhz()
        for name, prog in progs.items():
            ir = prog.ir
            x = make_dataset(name).x_test
            x = np.tile(x, (-(-PIPE_BATCH // x.shape[0]), 1))[:PIPE_BATCH]
            words = prog.pack_input_bits(prog.binarize(x))
            plan = [torch.from_numpy(a).to(dev) for a in D.check_plan(
                *(np.reshape(a, (1, -1)) for a in prog.plan()[:4]),
                ir.n_inputs)]
            row = rows[name]
            row["kernel_ms"] = gpu_ms(lambda: CK.fused_eval_uint(
                *plan, words, ir.n_inputs, schedule=prog.schedule),
                TIMED_REPS, True)
            row["plain_ms"] = gpu_ms(lambda: CS.population_eval_uint(
                *plan, words, ir.n_inputs), PLAIN_REPS, False)
            program = [(ir.n_inputs, ir.n_gates, ir.n_outputs,
                        words.shape[1])]
            row["bound_ms"], row["bound_by"] = bound_ms(program, True)
            row["ops_bound_ms"] = ops_bound_ms(program)
            row["chain_bound_ms"] = chain_bound_ms(ir.depth, mhz)
            row["kernel_equals_plain"] = bool(torch.equal(
                CK.fused_eval_uint(*plan, words, ir.n_inputs,
                                   schedule=prog.schedule),
                CS.population_eval_uint(*plan, words, ir.n_inputs)))

        # the export CLI, once, on the card (a process of its own)
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.compile.export",
             "breast_cancer", str(tmp / "export")], capture_output=True,
            text=True, timeout=600, cwd=str(ROOT),
            env={**os.environ, "PYTHONPATH": str(SRC)})
        export_s = time.perf_counter() - t0
    export_ok = cli.returncode == 0 and any(
        ln.startswith("[verify] RTL == device program") and "cuda" in ln
        for ln in cli.stdout.splitlines())

    out = {"nvidia_smi": smi,
           "settings": {"epochs": PIPE_EPOCHS, "lr": PIPE_LR, "seed": SEED,
                        "verify_vectors": PIPE_VERIFY,
                        "stream_readings": PIPE_STREAM,
                        "max_batch": PIPE_BATCH,
                        "accuracy_tolerance": PIPE_ACC_TOL,
                        "grad_tolerance": PIPE_GRAD_TOL},
           "tf32": False, "datasets": rows,
           "arrhythmia_repeat_latents_identical": repeat_identical,
           "arrhythmia_repeat_train_latents_s": repeat_s,
           "golden": golden, "front": front,
           "launches": launches, "launches_by_variant": by_variant,
           "export": {"seconds": export_s, "returncode": cli.returncode,
                      "ok": export_ok,
                      "stdout": cli.stdout.strip().splitlines()[-4:]},
           "checks": checks}
    say("pipeline", **out)
    bad = [f"{n}.{k}" for n, c in checks.items() for k, v in c.items()
           if not v]
    bad += [f"golden {n}.{k}" for n, c in golden.items() for k, v in c.items()
            if not v]
    bad += [f"{n}.kernel_equals_plain" for n, r in rows.items()
            if not r["kernel_equals_plain"]]
    bad += [f"front {i}.{k}" for i, r in enumerate(front)
            for k in ("labels_equal_circuits", "error_equals_objective")
            if not r[k]]
    if not export_ok:
        bad.append("export")
        print(cli.stderr[-4000:], file=sys.stderr)
    if bad:
        fail(f"pipeline: failed checks {bad}")
    for name in ("fused_eval_uint", "simulate_population"):
        if not launches[name]:
            fail(f"the pipeline never launched {name}")
    return out


def baselines_phase(dev, smi: str) -> dict:
    """`baselines` — the paper's Table-2/3 MLP baselines through the port's
    `train_mlp_baseline`: every Table-2 dataset x {exact, pow2} at
    `benchmarks/table2_accuracy.py`'s settings (hidden = the dataset's
    `mlp_topology[1]`, `MLP_EPOCHS` epochs, lr 5e-3, seed 0), trained on the
    card and on the CPU, timed.  Gates: test accuracy within `MLP_ACC_TOL`
    of `tests/golden_emit/mlp_baselines.npz` (the reference's, from
    `tools/emit_golden_mlp.py`), the card within the same of the CPU, and
    `cost("adc4")` equal to the golden area and power whenever the integer
    weights equal the golden ones.  Integer weights differing from the
    golden file and from the CPU's are printed."""
    import torch

    from repro_torch.core import baselines as B
    from repro_torch.data.tabular import DATASETS, make_dataset

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        fail("baselines: float32 matmuls must run in full float32 (TF32 "
             "off)")
    with np.load(EMIT_DIR / "mlp_baselines.npz") as fix:
        golden = {k: fix[k] for k in fix.files}
    rows, checks = {}, {}
    for name in sorted(DATASETS):
        ds = make_dataset(name)
        hidden = DATASETS[name].mlp_topology[1]
        steps = MLP_EPOCHS * -(-ds.y_train.shape[0] // B.BATCH)
        for mode, pow2 in (("exact", False), ("pow2", True)):
            key = f"{name}_{mode}"
            runs = {}
            for where in (dev, "cpu"):
                if where == dev:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs[str(where)] = (B.train_mlp_baseline(
                    ds, hidden, pow2=pow2, epochs=MLP_EPOCHS, device=where),
                    time.perf_counter() - t0)
            (card, card_s), (cpu, cpu_s) = runs[str(dev)], runs["cpu"]
            gw = [golden[f"{key}_w1"], golden[f"{key}_w2"]]
            g_acc = float(golden[f"{key}_test_acc"])
            g_cost = (float(golden[f"{key}_area_mm2"]),
                      float(golden[f"{key}_power_mw"]))
            same_golden = all(np.array_equal(a, b)
                              for a, b in zip(card.weights_int, gw))
            cost = card.cost("adc4")
            rows[key] = {
                "hidden": hidden, "steps": steps,
                "train_s": card_s, "steps_per_s": steps / card_s,
                "cpu_train_s": cpu_s, "cpu_steps_per_s": steps / cpu_s,
                "test_acc": card.test_acc, "cpu_test_acc": cpu.test_acc,
                "golden_test_acc": g_acc,
                "weights_differing_from_golden": [
                    int((a != b).sum()) for a, b in zip(card.weights_int,
                                                        gw)],
                "weights_differing_from_cpu": [
                    int((a != b).sum()) for a, b in zip(card.weights_int,
                                                        cpu.weights_int)],
                "area_mm2": cost.area_mm2, "power_mw": cost.power_mw,
                "golden_area_mm2": g_cost[0], "golden_power_mw": g_cost[1]}
            checks[key] = {
                "accuracy_vs_golden": abs(card.test_acc - g_acc)
                <= MLP_ACC_TOL,
                "card_vs_cpu": abs(card.test_acc - cpu.test_acc)
                <= MLP_ACC_TOL,
                "cost_when_weights_equal": (not same_golden) or (
                    (cost.area_mm2, cost.power_mw) == g_cost)}
    out = {"nvidia_smi": smi,
           "settings": {"epochs": MLP_EPOCHS, "lr": 5e-3, "seed": 0,
                        "batch": B.BATCH, "accuracy_tolerance": MLP_ACC_TOL},
           "tf32": False, "datasets": rows, "checks": checks}
    say("baselines", **out)
    bad = [f"{k}.{c}" for k, cs in checks.items() for c, v in cs.items()
           if not v]
    if bad:
        fail(f"baselines: failed checks {bad}")
    return out


def fleet_streams(dev) -> tuple[dict, dict, dict]:
    """Each golden tenant's stream — its `tests/golden/<name>.npz` readings,
    then its dataset's seeded test split tiled, `FLEET_STREAM` readings in
    all — with the golden labels and offline `CircuitProgram.predict` on
    the card (which must reproduce the golden labels)."""
    from repro_torch.compile.artifact import load_manifest, load_program
    from repro_torch.data.tabular import make_dataset

    streams, golden, offline = {}, {}, {}
    for row in load_manifest(EMIT_DIR):
        name = row["name"]
        with np.load(GOLDEN_DIR / f"{name}.npz") as fix:
            gx, golden[name] = fix["x"], fix["labels"]
        test = make_dataset(row["dataset"]).x_test
        tiled = np.tile(test, (-(-FLEET_STREAM // test.shape[0]), 1))
        streams[name] = np.ascontiguousarray(
            np.concatenate([gx, tiled])[:FLEET_STREAM], dtype=np.float64)
        prog = load_program(EMIT_DIR / row["program"], device=dev,
                            expect_sha256=row["sha256"])
        offline[name] = prog.predict(streams[name])
        if not np.array_equal(offline[name][: gx.shape[0]], golden[name]):
            fail(f"fleet: offline predict of {name} differs from "
                 f"tests/golden")
    return streams, golden, offline


def drive_fleet(submit_many, streams: dict) -> tuple[dict, float]:
    """`FLEET_PRODUCERS` threads submit every stream in `FLEET_FRAME`-row
    frames, interleaved across tenants; returns each tenant's labels (in
    stream order) and the wall seconds from the first submit to the last
    label."""
    import threading

    names = sorted(streams)
    tasks = [(n, s) for s in range(0, FLEET_STREAM, FLEET_FRAME)
             for n in names]
    handles = {n: [None] * (FLEET_STREAM // FLEET_FRAME) for n in names}
    errors = []

    def produce(w: int) -> None:
        try:
            for n, s in tasks[w::FLEET_PRODUCERS]:
                handles[n][s // FLEET_FRAME] = submit_many(
                    n, streams[n][s:s + FLEET_FRAME])
        except Exception as exc:        # surfaced below, never swallowed
            errors.append(f"producer {w}: {type(exc).__name__}: {exc}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=produce, args=(w,), daemon=True)
               for w in range(FLEET_PRODUCERS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    if errors or any(th.is_alive() for th in threads):
        fail(f"fleet producers: {errors or 'still submitting after 600 s'}")
    labels = {n: np.array([h.result(600.0) for hs in handles[n] for h in hs],
                          dtype=np.int32) for n in names}
    return labels, time.perf_counter() - t0


def fleet_phase(dev, smi: str) -> dict:
    """`fleet` — the five golden tenants of `tests/golden_emit/fleet.json`
    served on the card by `ClassifierFleet` at the reference's defaults
    (`max_batch` 256, `deadline_ms` 50), each tenant's stream
    (`fleet_streams`) submitted by `drive_fleet`, in five modes in turn:
    in-process with one and with two replicas a tenant, `megakernel=True`,
    over the socket (a `FleetServer` on 127.0.0.1:0, the port's
    `FleetClient` sending SUBMIT_BATCH frames), and `workers=2` spawned
    processes on the card.  In every mode the labels must equal offline
    `CircuitProgram.predict` on the card and, on the golden readings,
    `tests/golden/<name>.npz`; the launch counters, zeroed after the
    fleet's warm-up, must show `fused_eval_uint` launches (in the workers'
    own processes in worker mode, none in the parent) and no
    `fleet_eval_words` in-process and over the socket, `fleet_eval_words`
    launches and no other in megakernel mode, all `shared_plane`.
    Printed per mode: readings/s, request p50/p99 ms, `n_slo_miss`,
    `n_shed`, dispatch p50/p99 ms, launches; SLO misses are not gated.
    Then the kernels at the fleet's batch shape (`max_batch` readings, W =
    8 words) against their plain versions and bounds, a dispatch's parts
    (binarize and pack, launch and copy back), and `python -m
    repro_torch.serve replay` on the card, then `serve` on 127.0.0.1:0 with
    `replay --connect` against it, each in a process of its own."""
    import os

    import torch

    from repro_torch.compile.artifact import load_manifest, load_program
    from repro_torch.kernels import circuit_sim as CS
    from repro_torch.kernels import cuda_circuit_sim as CK
    from repro_torch.kernels import dispatch as D
    from repro_torch.roofline.kernel_model import (bound_ms, chain_bound_ms,
                                                   ops_bound_ms)
    from repro_torch.serve import (DEFAULT_DEADLINE_MS, DEFAULT_MAX_BATCH,
                                   ClassifierFleet)
    from repro_torch.serve.client import FleetClient
    from repro_torch.serve.engine import CircuitServingEngine
    from repro_torch.serve.server import FleetServer

    streams, golden, offline = fleet_streams(dev)
    total = sum(x.shape[0] for x in streams.values())
    window = total                      # every request in the percentiles
    modes = {
        "inprocess_replicas_1": dict(replicas=1),
        "inprocess_replicas_2": dict(replicas=2),
        "megakernel": dict(megakernel=True),
        "socket": dict(replicas=2),
        "workers_2": dict(workers=FLEET_WORKERS),
    }
    rows, checks = {}, {}
    for mode, kw in modes.items():
        t0 = time.perf_counter()
        fleet = ClassifierFleet.from_emit_dir(EMIT_DIR, device=dev,
                                              stats_window=window, **kw)
        build_s = time.perf_counter() - t0
        hosts = list(fleet._worker_hosts.values())
        before = [c for h in hosts for c in h.launches()]
        server = client = None
        try:
            if mode == "socket":
                server = FleetServer(fleet)
                host, port = server.start_background()
                client = FleetClient(host, port)

                def submit_many(n, x):
                    return client.submit_many(n, x)
            else:
                def submit_many(n, x):
                    reqs, shed, _ = fleet.submit_many(n, x)
                    if shed.size:
                        fail(f"fleet {mode}: {shed.size} readings shed")
                    return reqs
            torch.cuda.synchronize()
            CK.reset_launches()
            labels, wall = drive_fleet(submit_many, streams)
            torch.cuda.synchronize()
            launches = dict(CK.LAUNCHES)
            by_variant = dict(CK.VARIANT_LAUNCHES)
            s = fleet.stats_summary()
            workers = None
            if hosts:
                after = [c for h in hosts for c in h.launches()]
                workers = [{"launches": {k: a["launches"][k]
                                         - b["launches"][k]
                                         for k in a["launches"]},
                            "by_variant": {k: a["by_variant"][k]
                                           - b["by_variant"][k]
                                           for k in a["by_variant"]}}
                           for a, b in zip(after, before)]
                s["workers"] = {d: h.summary()
                                for d, h in fleet._worker_hosts.items()}
        finally:
            if client is not None:
                client.close()
            if server is not None:
                server.stop()
            fleet.shutdown(drain=True)
        f = s["fleet"]
        row = {"build_s": build_s, "readings": total, "wall_s": wall,
               "readings_per_s": total / wall,
               "req_p50_ms": f["req_p50_ms"], "req_p99_ms": f["req_p99_ms"],
               "n_slo_miss": f["n_slo_miss"], "n_shed": f["n_shed"],
               "dispatch_p50_ms": f["p50_ms"], "dispatch_p99_ms": f["p99_ms"],
               "n_batches": f["n_batches"],
               "wall_per_batch_ms": wall * 1e3 / max(f["n_batches"], 1),
               "errors": fleet.errors[:4],
               "launches": launches, "launches_by_variant": by_variant}
        if "megakernel" in s:
            row["megakernel_launches"] = s["megakernel"]["launches"]
            row["megakernel_peak_tenants"] = \
                s["megakernel"]["peak_tenants_per_launch"]
        if workers is not None:
            row["worker_launches"] = workers
            row["worker_pids"] = [p["pid"] for w in s["workers"].values()
                                  for p in w["procs"]]
            row["worker_device"] = sorted(s["workers"])
        rows[mode] = row
        eq = {n: bool(np.array_equal(labels[n], offline[n])) for n in labels}
        gold = {n: bool(np.array_equal(labels[n][: golden[n].shape[0]],
                                       golden[n])) for n in labels}
        c = {"labels_equal_offline": all(eq.values()),
             "golden_labels": all(gold.values()),
             "no_errors": not fleet.errors}
        if mode == "megakernel":
            c["launched"] = launches["fleet_eval_words"] > 0
            c["only_fleet_eval_words"] = launches["fused_eval_uint"] == 0 \
                and launches["simulate_population"] == 0
            c["megakernel_count"] = \
                row["megakernel_launches"] == launches["fleet_eval_words"] > 0
            c["shared_plane"] = by_variant["global_scratch"] == 0
        elif mode == "workers_2":
            c["parent_launched_nothing"] = sum(launches.values()) == 0
            c["workers_launched"] = all(
                w["launches"]["fused_eval_uint"] > 0 for w in workers)
            c["shared_plane"] = all(w["by_variant"]["global_scratch"] == 0
                                    for w in workers)
            c["spawned_on_card"] = row["worker_device"] == [str(dev)] and \
                len(set(row["worker_pids"])) == FLEET_WORKERS
        else:
            c["launched"] = launches["fused_eval_uint"] == f["n_batches"] > 0
            c["no_fleet_eval_words"] = launches["fleet_eval_words"] == 0
            c["shared_plane"] = by_variant["global_scratch"] == 0
        checks[mode] = c
        say("fleet_mode", mode=mode, nvidia_smi=smi, **row, checks=c)
        torch.cuda.empty_cache()

    # the kernels at the fleet's batch shape, against their plain versions
    progs = {row["name"]: load_program(EMIT_DIR / row["program"], device=dev)
             for row in load_manifest(EMIT_DIR)}
    shape, words_list, plans = {}, [], []
    mismatches = 0
    mhz = max_sm_clock_mhz()
    for name, prog in progs.items():
        ir = prog.ir
        plan = [torch.from_numpy(a).to(dev) for a in D.check_plan(
            *(np.reshape(a, (1, -1)) for a in prog.plan()[:4]), ir.n_inputs)]
        words = prog.pack_input_bits(
            prog.binarize(streams[name][:DEFAULT_MAX_BATCH]))
        words_list.append(words)
        plans.append(prog.plan())
        W = int(words.shape[1])
        got = CK.fused_eval_uint(*plan, words, ir.n_inputs,
                                 schedule=prog.schedule)
        want = CS.population_eval_uint(*plan, words, ir.n_inputs)
        mismatches += int(not torch.equal(got, want))
        r = {"W": W, "G": ir.n_gates, "depth": ir.depth,
             "variant": CK.route(1, ir.n_gates, W, ir.n_inputs,
                                 ir.n_outputs, prog.schedule).variant}
        r["ms"] = gpu_ms(lambda: CK.fused_eval_uint(
            *plan, words, ir.n_inputs, schedule=prog.schedule),
            TIMED_REPS, True)
        r["plain_ms"] = gpu_ms(lambda: CS.population_eval_uint(
            *plan, words, ir.n_inputs), PLAIN_REPS, False)
        program = [(ir.n_inputs, ir.n_gates, ir.n_outputs, W)]
        r["bound_ms"], r["bound_by"] = bound_ms(program, True)
        r["ops_bound_ms"] = ops_bound_ms(program)
        r["chain_bound_ms"] = chain_bound_ms(ir.depth, mhz)
        # a dispatch's parts on the host's clock, each ending on the host
        eng = CircuitServingEngine(prog, max_batch=DEFAULT_MAX_BATCH)
        eng.warmup()
        x = streams[name][:DEFAULT_MAX_BATCH]
        parts = {"prepare_ms": [], "eval_ms": [], "classify_batch_ms": []}
        for _ in range(TIMED_REPS):
            t0 = time.perf_counter()
            w, _ = eng.prepare_packed_batch(x)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            prog.eval_words(w)
            t2 = time.perf_counter()
            eng.classify_batch(x)
            t3 = time.perf_counter()
            for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                parts[k].append(v * 1e3)
        r.update({k: float(np.median(v)) for k, v in parts.items()})
        shape[name] = r
    fl = CK.fleet_plan(plans, dev)
    words_t, W_list = fl.pad_words(words_list)
    fleet_shape = {"tenants": len(plans), "W": max(W_list),
                   "G_padded": int(fl.op.shape[1]),
                   "depth": fl.schedule.depth}
    got = CK.fleet_eval_words(plans, words_list)
    want = CS.population_eval_uint(*fl[:4], words_t, fl.n_in_max)
    mismatches += sum(int(not torch.equal(g, want[t, : W_list[t] * 32]))
                      for t, g in enumerate(got))
    fleet_shape["ms"] = gpu_ms(lambda: CK.fleet_eval_words(plans, words_list),
                               TIMED_REPS, True)
    fleet_shape["kernel_only_ms"] = gpu_ms(
        lambda: CK.fused_eval_uint(*fl[:4], words_t, fl.n_in_max,
                                   schedule=fl.schedule), TIMED_REPS, True)
    fleet_shape["plain_ms"] = gpu_ms(
        lambda: CS.population_eval_uint(*fl[:4], words_t, fl.n_in_max),
        PLAIN_REPS, False)
    fleet_shape["bound_ms"], fleet_shape["bound_by"] = bound_ms(
        [(p[4], np.size(p[0]), np.size(p[3]), w.shape[1])
         for p, w in zip(plans, words_list)], True)
    say("fleet_kernels", nvidia_smi=smi, readings=DEFAULT_MAX_BATCH,
        tenants=shape, fleet_eval_words=fleet_shape, mismatches=mismatches)
    if mismatches:
        fail(f"fleet: {mismatches} kernel launches at the fleet's shape "
             f"differ from the plain version")

    # the CLI on the card, each command a process of its own: `replay`
    # in-process, then `serve` on 127.0.0.1:0 (`serve_forever`, stopped
    # by SIGINT as an operator would) with `replay --connect` against it
    import signal

    on = [] if dev.type == "cuda" else ["--device", str(dev)]
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    cli_cmd = [sys.executable, "-m", "repro_torch.serve"]
    replay = ["--emit-dir", str(EMIT_DIR), "--readings",
              str(FLEET_CLI_READINGS), "--producers", "2", *on]
    t0 = time.perf_counter()
    cli = subprocess.run([*cli_cmd, "replay", *replay], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT), env=env)
    cli_row = {"replay": {"seconds": time.perf_counter() - t0,
                          "returncode": cli.returncode,
                          "stdout": cli.stdout.strip().splitlines()[-6:]}}
    server = subprocess.Popen(
        [*cli_cmd, "serve", "--emit-dir", str(EMIT_DIR), "--port", "0", *on],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT), env=env)
    try:
        t0 = time.perf_counter()
        line = server.stdout.readline()      # "[serve] ... listening on h:p"
        address = line.split("listening on ")[-1].split()[0] \
            if "listening on" in line else None
        remote = subprocess.run(
            [*cli_cmd, "replay", *replay, "--connect", str(address),
             "--batch", str(FLEET_FRAME)], capture_output=True, text=True,
            timeout=600, cwd=str(ROOT), env=env) if address else None
        server.send_signal(signal.SIGINT)
        out, err = server.communicate(timeout=120)
    finally:
        if server.poll() is None:
            server.kill()
            server.communicate()
    cli_row["serve"] = {"listening": line.strip(),
                        "returncode": server.returncode,
                        "stdout": out.strip().splitlines()[-2:]}
    cli_row["replay_connect"] = {
        "seconds": time.perf_counter() - t0,
        "returncode": None if remote is None else remote.returncode,
        "stdout": [] if remote is None
        else remote.stdout.strip().splitlines()[-6:]}
    say("fleet_cli", nvidia_smi=smi, **cli_row)
    cli_ok = (cli.returncode == 0 and remote is not None
              and remote.returncode == 0 and server.returncode == 0
              and any("draining" in ln for ln in out.splitlines()))
    bad = [f"{m}.{k}" for m, c in checks.items() for k, v in c.items()
           if not v]
    if not cli_ok:
        bad.append("cli")
        print(cli.stderr[-2000:], err[-2000:],
              "" if remote is None else remote.stderr[-2000:],
              file=sys.stderr)
    if bad:
        fail(f"fleet: failed checks {bad}")
    return {"modes": rows, "checks": checks, "at_fleet_shape": shape,
            "fleet_eval_words_at_fleet_shape": fleet_shape, "cli": cli_row,
            "settings": {"readings_per_tenant": FLEET_STREAM,
                         "max_batch": DEFAULT_MAX_BATCH,
                         "deadline_ms": DEFAULT_DEADLINE_MS,
                         "producers": FLEET_PRODUCERS,
                         "frame": FLEET_FRAME, "workers": FLEET_WORKERS}}


def evolve_phase(dev, smi: str, prob) -> dict:
    """`evolve` — the campaign layer on the card, each part against the
    CPU or against itself interrupted:

    (a) the campaign phase's arrhythmia products (the golden TNN, its PCC
        library and output PC library) written to a phase-cache entry and
        read back by `build_tnn_problem(phase_key=...)`, searched by a
        `Campaign` at `python -m repro_torch.evolve`'s defaults
        (`EVOLVE_CAMPAIGN`, checkpointing every epoch), counted: the
        archive must equal a CPU campaign's on the same products and a
        campaign with `EVOLVE_WORKERS` spawned workers on the card; a
        fresh campaign resumed from epoch `EVOLVE_RESUME_EPOCH`'s
        checkpoint must end bit-identical; `EVOLVE_DRIFT_ROUNDS` rounds of
        `attach_tnn_drift` (rate `EVOLVE_DRIFT_RATE`) must give the CPU's
        objectives and the card's own `_eval_one`;
    (b) `python -m repro_torch.evolve --problem tnn --dataset cardio` from
        scratch on the card at `EVOLVE_BUDGET`: serially, with `--workers
        2`, and killed after epoch 1 then resumed with `--workers 2`; the
        three archives must be equal; two `train_tnn` runs on the card at
        the CLI's settings are compared (printed, not gated);
    (c) a zoo of `EVOLVE_ZOO_DATASETS` x {base, lean} built by
        `EVOLVE_WORKERS` spawned workers on the card, then served by
        `ClassifierFleet.from_emit_dir(..., megakernel=True)`: labels must
        equal offline `predict`, every dispatch a `fleet_eval_words`
        launch;
    (d) two autopilot rounds on the card over (b)'s emitted winner (its
        sabotaged copy must roll back, the winner promote), then `python
        -m repro_torch.autopilot run` SIGKILLed between round 1's decision
        and its execution and resumed, which must reach the decisions of
        an uninterrupted run.
    Printed: generations/s, objective individuals/s, gate-walk launches
    and the memo's hit share per epoch, checkpoint save and restore ms,
    epoch seconds with workers against serial, zoo entries/s and
    autopilot seconds per round; the objective's launch timed against its
    plain version and bounds."""
    import os
    import shutil
    import signal
    import tempfile

    import torch

    from repro_torch.autopilot import (Autopilot, AutopilotConfig,
                                       Candidate, DecisionJournal,
                                       PromotionPolicy, ScriptedSource,
                                       dataset_traffic, sabotage_classifier)
    from repro_torch.compile import artifact as A
    from repro_torch.compile.zoo import build_zoo, make_entries
    from repro_torch.core import tnn as T
    from repro_torch.data.tabular import make_dataset
    from repro_torch.evolve import (Campaign, CampaignConfig, ProblemSpec,
                                    attach_tnn_drift, build_tnn_problem,
                                    compile_archive_winner)
    from repro_torch.evolve import phase_cache as PCache
    from repro_torch.kernels import circuit_sim as CS
    from repro_torch.kernels import cuda_circuit_sim as CK
    from repro_torch.roofline.kernel_model import (bound_ms, chain_bound_ms,
                                                   ops_bound_ms)
    from repro_torch.serve import ClassifierFleet

    on_card = dev.type == "cuda"

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_evolve_"))
    cache = tmp / "phase_cache"
    checks: dict[str, bool] = {}
    out: dict = {"nvidia_smi": smi}
    try:
        # -- (a) a campaign at the CLI's defaults on arrhythmia -------------
        key = "arrhythmia_campaign_phase"
        PCache.save_phase(cache, key, prob.tnn, {}, prob.pcc_lib,
                          prob.pc_out_lib)
        specs = {d: ProblemSpec("tnn", {"dataset": "arrhythmia",
                                        "device": str(d),
                                        "cache_dir": str(cache),
                                        "phase_key": key})
                 for d in (dev, "cpu")}
        problems = {d: s.build() for d, s in specs.items()}
        walls: list[float] = []
        rows = [0]

        def timed(objective):
            def call(pop):
                t = time.perf_counter()
                f = objective(pop)
                walls.append(time.perf_counter() - t)
                rows[0] += pop.shape[0]
                return f
            return call

        def campaign(d, ckpt=None, workers=0, objective=None, **kw):
            p = problems[d]
            cfg = CampaignConfig(**{**EVOLVE_CAMPAIGN, **kw}, seed=SEED,
                                 device=str(d), workers=workers)
            return Campaign(p.domains, objective or p.objective, cfg,
                            checkpoint_dir=ckpt,
                            seed_population=p.seed_population, name=p.name,
                            problem_spec=specs[d])

        epochs: list[dict] = []

        def mark(epoch: int, c) -> None:
            sync()
            epochs.append({"epoch": epoch, "t": time.perf_counter(),
                           "launches": CK.LAUNCHES["fused_eval_uint"],
                           **c.cache_history[-1]})
            if epoch == EVOLVE_RESUME_EPOCH:
                shutil.copytree(Path(c.ckpt.dir) / f"step_{epoch}",
                                tmp / "resume" / f"step_{epoch}")

        CK.reset_launches()
        t0 = time.perf_counter()
        with campaign(dev, ckpt=str(tmp / "ckpt"),
                      objective=timed(problems[dev].objective)) as c:
            card = c.run(on_epoch=mark)
            sync()
            serial_s = time.perf_counter() - t0
            launches = dict(CK.LAUNCHES)
            by_variant = dict(CK.VARIANT_LAUNCHES)
            schedule_builds = dict(CK.SCHEDULE_LAUNCHES)
            save_ms, restore_ms = [], []
            for _ in range(5):
                t = time.perf_counter()
                c._save(c.next_epoch - 1)
                save_ms.append((time.perf_counter() - t) * 1e3)
                t = time.perf_counter()
                c.ckpt.restore(c._template(), to_device=False)
                restore_ms.append((time.perf_counter() - t) * 1e3)
        per_epoch, last = [], {"t": t0, "launches": 0, "hits": 0,
                               "misses": 0}
        for e in epochs:
            d_hits, d_miss = e["hits"] - last["hits"], \
                e["misses"] - last["misses"]
            per_epoch.append({
                "epoch": e["epoch"], "seconds": e["t"] - last["t"],
                "launches": e["launches"] - last["launches"],
                "memo_hits": d_hits, "memo_misses": d_miss,
                "memo_hit_share": d_hits / max(1, d_hits + d_miss)})
            last = e
        cfg = EVOLVE_CAMPAIGN
        island_generations = cfg["n_islands"] * cfg["n_epochs"] \
            * cfg["gens_per_epoch"]
        t0 = time.perf_counter()
        cpu = campaign("cpu").run()
        cpu_s = time.perf_counter() - t0

        def same(a, b) -> bool:
            return bool(np.array_equal(a.archive_x, b.archive_x)
                        and np.array_equal(a.archive_f, b.archive_f)
                        and a.histories == b.histories)

        checks["campaign_equals_cpu"] = same(card, cpu)
        with campaign(dev, ckpt=str(tmp / "resume")) as c:
            resumed = c.run()
        checks["resume_from_epoch_3"] = same(resumed, card) and \
            resumed.resumed_from == EVOLVE_RESUME_EPOCH
        workers_epochs = []

        def mark_workers(epoch: int, c) -> None:
            sync()
            workers_epochs.append(time.perf_counter())

        t0 = time.perf_counter()
        with campaign(dev, workers=EVOLVE_WORKERS) as c:
            par = c.run(on_epoch=mark_workers)
        workers_s = np.diff([t0] + workers_epochs).tolist()
        checks["workers_equal_serial"] = same(par, card) and \
            par.cache_history[-1]["mode"] == "parallel"
        # drift: card against CPU, and the card's objective against its own
        # serial reference path, round by round
        drifted = {d: attach_tnn_drift(s.build(), EVOLVE_DRIFT_RATE,
                                       seed=SEED) for d, s in specs.items()}
        pop = np.concatenate([card.archive_x, np.random.default_rng(
            SEED).integers(0, problems[dev].domains[None, :],
                           size=(cfg["pop_size"],
                                 problems[dev].domains.size))])
        drift_ok = True
        for r in range(EVOLVE_DRIFT_ROUNDS):
            for p in drifted.values():
                p.drift(r)
            got = drifted[dev].objective(pop)
            drift_ok &= bool(np.array_equal(
                got, drifted["cpu"].objective(pop)))
            drift_ok &= all(tuple(got[i]) == drifted[dev].approx._eval_one(x)
                            for i, x in enumerate(pop[:4]))
        checks["drift_equals_cpu_and_eval_one"] = drift_ok
        # the objective's launch at the campaign's population, timed
        ap = problems[dev].approx
        pop24 = pop[-cfg["pop_size"]:]
        args = ap.launch_args(pop24)
        obj = {"rows": int(args[0].shape[0]), "W": int(args[4].shape[-1]),
               "depth": int(args[-1].depth)}
        programs = [(nl.n_inputs, nl.n_gates, nl.n_outputs, obj["W"])
                    for nl in (ap.out_cands[int(k)] for k in
                               pop24[:, len(ap.hidden_idx):].reshape(-1))]
        obj["bound_ms"], obj["bound_by"] = bound_ms(programs, True)
        obj["ops_bound_ms"] = ops_bound_ms(programs)
        checks["objective_launch"] = bool(torch.equal(
            CK.fused_eval_uint(*args), CS.population_eval_uint(*args[:6])))
        if on_card:
            obj["kernel_ms"] = gpu_ms(lambda: CK.fused_eval_uint(*args),
                                      TIMED_REPS, True)
            obj["plain_ms"] = gpu_ms(
                lambda: CS.population_eval_uint(*args[:6]), PLAIN_REPS,
                False)
            obj["chain_bound_ms"] = chain_bound_ms(obj["depth"],
                                                   max_sm_clock_mhz())
        out["campaign"] = {
            "problem": "arrhythmia golden TNN (274 / 3 / 16), the campaign "
                       "phase's PCC and output PC libraries",
            "config": EVOLVE_CAMPAIGN, "archive_size": len(card.archive_x),
            "seconds": serial_s, "cpu_seconds": cpu_s,
            "generations_per_s": island_generations / serial_s,
            "objective_calls": len(walls), "objective_rows": rows[0],
            "objective_s": sum(walls),
            "objective_individuals_per_s": rows[0] / sum(walls),
            "objective_p50_ms": float(np.median(walls)) * 1e3,
            "launches": launches, "launches_by_variant": by_variant,
            "schedule_builds": schedule_builds, "per_epoch": per_epoch,
            "checkpoint_save_ms": float(np.median(save_ms)),
            "checkpoint_restore_ms": float(np.median(restore_ms)),
            "epoch_seconds_serial": [e["seconds"] for e in per_epoch],
            "epoch_seconds_workers": workers_s,
            "workers": EVOLVE_WORKERS, "objective_launch": obj}
        if on_card and launches["fused_eval_uint"] != len(walls):
            fail(f"evolve: {launches['fused_eval_uint']} gate-walk launches "
                 f"for {len(walls)} objective calls, expected one each")

        # -- (b) the CLI on cardio from scratch, killed and resumed ----------
        on = [] if on_card else ["--device", str(dev)]
        env = {**os.environ, "PYTHONPATH": str(SRC),
               "REPRO_TORCH_PHASE_CACHE": str(cache)}
        budget = [f"--{k.replace('_', '-')}={v}"
                  for k, v in EVOLVE_BUDGET.items()]
        evolve_cmd = [sys.executable, "-m", "repro_torch.evolve",
                      "--problem", "tnn", "--dataset", "cardio",
                      f"--epochs={EVOLVE_CLI_EPOCHS}", *budget, *on]

        def run_cli(cmd, *extra):
            t = time.perf_counter()
            r = subprocess.run([*cmd, *map(str, extra)], capture_output=True,
                               text=True, timeout=900, cwd=str(ROOT),
                               env=env)
            return r, time.perf_counter() - t

        cli = {}
        for name, extra in (
                ("serial", ("--ckpt-dir", tmp / "ck_serial",
                            "--out", tmp / "serial.json")),
                ("workers", ("--workers", EVOLVE_WORKERS, "--ckpt-dir",
                             tmp / "ck_workers", "--out",
                             tmp / "workers.json")),
                ("killed", ("--ckpt-dir", tmp / "ck_kill",
                            "--kill-after-epoch", 1)),
                ("resumed", ("--workers", EVOLVE_WORKERS, "--ckpt-dir",
                             tmp / "ck_kill", "--out", tmp / "resumed.json",
                             "--emit-dir", tmp / "emit"))):
            r, s = run_cli(evolve_cmd, *extra)
            cli[name] = {"seconds": s, "returncode": r.returncode,
                         "resumed": "resumed from epoch 1" in r.stdout,
                         "stdout": r.stdout.strip().splitlines()[-3:]}
            if r.returncode not in (0, -signal.SIGKILL):
                print(r.stderr[-3000:], file=sys.stderr)
        fronts = {n: json.loads((tmp / f"{n}.json").read_text())["archive"]
                  for n in ("serial", "workers", "resumed")
                  if (tmp / f"{n}.json").exists()}
        checks["cli_runs"] = (
            [cli[n]["returncode"] for n in cli] == [0, 0, -signal.SIGKILL, 0]
            and cli["resumed"]["resumed"])
        checks["cli_archives_equal"] = len(fronts) == 3 and \
            fronts["serial"] == fronts["workers"] == fronts["resumed"] != []
        ds = make_dataset("cardio")
        qat = [T.train_tnn(ds, T.TNNTrainConfig(
            n_hidden=ds.spec.topology[1], epochs=EVOLVE_BUDGET["tnn_epochs"],
            lr=1e-2, seed=SEED), device=dev) for _ in range(2)]
        cached = PCache.load_phase(cache, PCache.phase_key(
            "cardio", SEED, EVOLVE_BUDGET["tnn_epochs"],
            EVOLVE_BUDGET["cgp_points"], EVOLVE_BUDGET["cgp_iters"],
            EVOLVE_BUDGET["pcc_samples"], device=dev))[0]

        def codes(t) -> tuple:
            return t.w1t.tobytes(), t.w2t.tobytes()

        out["cli"] = {
            "budget": EVOLVE_BUDGET, "epochs": EVOLVE_CLI_EPOCHS,
            "reference_defaults": "tnn-epochs 12, cgp-points 3, cgp-iters "
                                  "500, pcc-samples 30000, epochs 8",
            "runs": cli, "archive_size": len(fronts.get("serial", [])),
            "qat_card_twice_identical": codes(qat[0]) == codes(qat[1]),
            "qat_card_equals_cli_products": codes(qat[0]) == codes(cached)}

        # -- (c) the zoo, built by spawned workers, served as one fleet ------
        zoo_budget = {**EVOLVE_ZOO_CAMPAIGN,
                      "tnn_epochs": EVOLVE_BUDGET["tnn_epochs"],
                      "cgp_points": EVOLVE_BUDGET["cgp_points"],
                      "cgp_iters": EVOLVE_BUDGET["cgp_iters"],
                      "pcc_samples": EVOLVE_BUDGET["pcc_samples"],
                      "device": str(dev)}
        t0 = time.perf_counter()
        for name in EVOLVE_ZOO_DATASETS:     # products once, in the cache
            build_tnn_problem(name, seed=SEED,
                              epochs=EVOLVE_BUDGET["tnn_epochs"],
                              cgp_points=EVOLVE_BUDGET["cgp_points"],
                              cgp_iters=EVOLVE_BUDGET["cgp_iters"],
                              pcc_samples=EVOLVE_BUDGET["pcc_samples"],
                              device=dev, cache_dir=str(cache))
        products_s = time.perf_counter() - t0
        entries = make_entries(list(EVOLVE_ZOO_DATASETS), ["base", "lean"],
                               **zoo_budget)
        t0 = time.perf_counter()
        report = build_zoo(entries, tmp / "zoo", workers=EVOLVE_WORKERS,
                           cache_dir=str(cache))
        zoo_s = time.perf_counter() - t0
        zoo_rows = A.load_manifest(tmp / "zoo")
        zoo_ok = sorted(report["built"]) == sorted(e.name for e in entries)
        streams = {r["name"]: make_dataset(r["dataset"]).x_test
                   for r in zoo_rows}
        offline = {r["name"]: A.load_program(
            tmp / "zoo" / r["program"], device=dev).predict(
            streams[r["name"]]) for r in zoo_rows}
        with ClassifierFleet.from_emit_dir(tmp / "zoo", device=dev,
                                           megakernel=True) as fleet:
            CK.reset_launches()
            submitted = {n: fleet.submit_many(n, x)
                         for n, x in streams.items()}
            fleet.flush(timeout=120.0)
            for name, (reqs, shed, _) in submitted.items():
                zoo_ok &= not len(shed) and bool(np.array_equal(
                    [q.result(120.0) for q in reqs], offline[name]))
            zoo_launches = dict(CK.LAUNCHES)
            zoo_ok &= fleet.errors == [] and (not on_card or (
                zoo_launches["fleet_eval_words"] > 0
                and zoo_launches["fused_eval_uint"] == 0))
        checks["zoo_serves_offline_labels"] = zoo_ok
        out["zoo"] = {"entries": len(entries), "budget": zoo_budget,
                      "products_s": products_s, "build_s": zoo_s,
                      "entries_per_s": len(entries) / zoo_s,
                      "workers": EVOLVE_WORKERS, "launches": zoo_launches,
                      "provenance_device": sorted({
                          r["provenance"]["device"] for r in zoo_rows})}

        # -- (d) the autopilot: rollback then promotion; a SIGKILL resumed ---
        p = build_tnn_problem("cardio", seed=SEED,
                              epochs=EVOLVE_BUDGET["tnn_epochs"],
                              cgp_points=EVOLVE_BUDGET["cgp_points"],
                              cgp_iters=EVOLVE_BUDGET["cgp_iters"],
                              pcc_samples=EVOLVE_BUDGET["pcc_samples"],
                              device=dev, cache_dir=str(cache))
        front = fronts.get("resumed") or [{"x": [0] * p.domains.size,
                                           "f": [1.0, 0.0]}]
        best = min(front, key=lambda r: r["f"][0])
        cc = compile_archive_winner(p, np.array(best["x"]))
        emits = {n: shutil.copytree(tmp / "emit", tmp / f"emit_{n}")
                 for n in ("inproc", "control", "killed")}
        candidates = [Candidate(cc=sabotage_classifier(cc),
                                objectives=best["f"],
                                provenance={"sabotaged": True}),
                      Candidate(cc=cc, objectives=best["f"], provenance={})]
        with ClassifierFleet.from_emit_dir(emits["inproc"],
                                           device=dev) as fleet:
            pilot = Autopilot(
                fleet, ScriptedSource(candidates),
                dataset_traffic("cardio", seed=SEED),
                DecisionJournal(emits["inproc"] / "journal.jsonl"),
                AutopilotConfig(tenant="tnn_cardio", rounds=2,
                                policy=PromotionPolicy()))
            t0 = time.perf_counter()
            outcomes = pilot.run()
            rounds_s = (time.perf_counter() - t0) / 2
            checks["autopilot_rollback_then_promote"] = (
                [o["event"] for o in outcomes] == ["rolled_back", "promoted"]
                and fleet.errors == [])
        pilot_cmd = [sys.executable, "-m", "repro_torch.autopilot", "run",
                     "--tenant", "tnn_cardio", "--dataset", "cardio",
                     "--rounds", "2", "--sabotage-round", "0",
                     "--no-require-improvement", *budget, *on]
        ap_cli = {}
        for name, emit, extra in (
                ("control", emits["control"], ()),
                ("killed", emits["killed"], ("--kill-after", "decision:1")),
                ("resumed", emits["killed"], ())):
            r, s = run_cli(pilot_cmd, "--emit-dir", emit,
                           "--out", emit / f"{name}.json", *extra)
            ap_cli[name] = {"seconds": s, "returncode": r.returncode,
                            "stdout": r.stdout.strip().splitlines()[-2:]}
            if r.returncode not in (0, -signal.SIGKILL):
                print(r.stderr[-3000:], file=sys.stderr)

        def decided(emit):
            return [(e["round"], e["event"], e.get("action"))
                    for e in DecisionJournal(
                        emit / "autopilot_journal.jsonl").replay()
                    if e["event"] in ("decision", "promoted",
                                      "rolled_back", "held")]

        control = decided(emits["control"])
        checks["autopilot_sigkill_same_decisions"] = (
            [ap_cli[n]["returncode"] for n in ap_cli]
            == [0, -signal.SIGKILL, 0]
            and control == decided(emits["killed"]) and len(control) == 4)
        out["autopilot"] = {
            "inprocess": [o["event"] for o in outcomes],
            "seconds_per_round": rounds_s, "cli": ap_cli,
            "cli_seconds_per_round": ap_cli["control"]["seconds"] / 2,
            "decisions": control}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["checks"] = checks
    say("evolve", **out)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"evolve: failed checks {bad}")
    return out


def paper_benches(device) -> dict:
    """The paper phase's benches of `benchmarks_torch` on `device`, each
    `(rows, seconds)`, in the harness's order."""
    from benchmarks_torch import (fig4_pc_pareto, fig5_pcc_pareto,
                                  fig6_area_estimate, fig7_tnn_pareto,
                                  fig8_nsga2, table2_accuracy, table3_sota,
                                  variation_robustness)
    runs = {
        "table2": lambda: table2_accuracy.run(device=device),
        "fig4": lambda: fig4_pc_pareto.run(PAPER_FIG4_SIZES, device=device),
        "fig5": lambda: fig5_pcc_pareto.run(PAPER_DATASET, device=device),
        "fig6": lambda: fig6_area_estimate.run(PAPER_DATASET, device=device),
        "fig7": lambda: fig7_tnn_pareto.run([PAPER_DATASET], device=device),
        "fig8": lambda: fig8_nsga2.run(PAPER_DATASET, device=device),
        "table3": lambda: table3_sota.run([PAPER_DATASET], device=device),
        "variation": lambda: variation_robustness.run(
            [PAPER_VARIATION_DATASET], device=device),
    }
    out = {}
    for name, fn in runs.items():
        t0 = time.perf_counter()
        rows = fn()
        out[name] = (rows, time.perf_counter() - t0)
    return out


def paper_compare(card: dict, cpu: dict) -> tuple[list[str], list[dict]]:
    """Card rows against CPU rows, bench by bench: every column equal but
    the QAT columns (`PAPER_QAT_COLUMNS`, within their tolerance) and the
    ungated ones (`PAPER_UNGATED`).  Returns (mismatches, the QAT columns
    side by side)."""
    bad, side = [], []
    for bench, (rows, _) in card.items():
        want = cpu[bench][0]
        if len(rows) != len(want):
            bad.append(f"{bench}: {len(rows)} rows on the card, "
                       f"{len(want)} on the CPU")
            continue
        qat = PAPER_QAT_COLUMNS.get(bench, {})
        for i, (a, b) in enumerate(zip(rows, want)):
            if a.keys() != b.keys():
                bad.append(f"{bench} row {i}: keys differ")
                continue
            mlp_row = a.get("design") in PAPER_MLP_DESIGNS
            for k in a:
                if k in PAPER_UNGATED.get(bench, ()) and (
                        bench != "table3" or mlp_row):
                    continue
                if k in qat and (bench != "table3" or mlp_row):
                    side.append({"bench": bench, "row": i,
                                 "dataset": a.get("dataset"),
                                 "design": a.get("design"),
                                 "sigma": a.get("sigma"), "column": k,
                                 "card": a[k], "cpu": b[k]})
                    if abs(a[k] - b[k]) > qat[k] + 1e-9:
                        bad.append(f"{bench} row {i} {k}: card {a[k]} cpu "
                                   f"{b[k]} (tolerance {qat[k]})")
                elif a[k] != b[k]:
                    bad.append(f"{bench} row {i} {k}: card {a[k]!r} cpu "
                               f"{b[k]!r}")
    return bad, side


def paper_headlines(rows: dict) -> dict:
    """The paper's headline claims read off the card's rows: Table 2's
    TNN-to-MLP gap, Fig. 4's CGP area against truncation at matched error,
    Fig. 7's savings, and Table 3's area and power ratios of the best
    approximate MLP to the approximate TNN with the interface counted."""
    t2 = rows["table2"][0]
    cgp = [r for r in rows["fig4"][0] if r["method"] == "cgp"
           and r["rel_area"] > 0]
    head = next(r for r in rows["fig7"][0] if r["bench"] == "fig7_headline")
    t3 = {r["design"]: r for r in rows["table3"][0]
          if r["bench"] == "table3"}
    tnn = t3.get("our_ax_tnn", t3["our_exact_tnn"])
    ax = t3["ax_mlp_pow2[1,2]"]
    return {
        "table2_mlp_minus_tnn": {r["dataset"]: r["delta"] for r in t2},
        "table2_paper_delta": {r["dataset"]: r["paper_delta"] for r in t2},
        "fig4_trunc_over_cgp_area": [
            round(r["trunc_rel_area_at_error"] / r["rel_area"], 3)
            for r in cgp],
        "fig7_iso_saving": head["avg_iso_saving"],
        "fig7_drop5_saving": head["avg_drop5_saving"],
        "fig7_paper": [head["paper_iso_saving"], head["paper_drop5_saving"]],
        "table3_tnn_design": tnn["design"],
        "table3_area_ratio_iface": round(
            ax["area_cm2_iface"] / tnn["area_cm2_iface"], 3),
        "table3_power_ratio_iface": round(
            ax["power_mw_iface"] / tnn["power_mw_iface"], 3),
        "table3_paper_ratios": "area >= 6x, power >= 19x",
        "table3_power_source": tnn["power_source"],
    }


def paper_phase(dev, smi: str) -> dict:
    """`paper` — the paper's tables and figures through the port's harness
    (`benchmarks_torch/`) on the card at its quick budgets, then again on
    the CPU, with the gate-walk counters zeroed just before the card's run
    and read just after it.

    The harness trains each dataset's TNN (`common.get_trained_tnn`: the
    best of two learning rates) on the card and on the CPU; their test
    accuracies must agree within `PAPER_TNN_TOL` (codes are printed).  The
    CPU's cache then takes the card's TNNs, so that both runs start from
    the same `TrainedTNN`s and everything downstream of QAT — CGP and PCC
    libraries, fronts, areas, powers, histories — must be equal; the QAT
    columns (the MLP baselines, the variation bench's trainings) are held
    within their tolerances and printed side by side.  At least one
    gate-walk launch, all `shared_plane`.  Returns the launches."""
    import torch

    from benchmarks_torch import common
    from repro_torch.kernels import cuda_circuit_sim as CK

    datasets = ("arrhythmia", "breast_cancer", "cardio", "redwine",
                "whitewine")
    qat, t0 = {}, time.perf_counter()
    for name in datasets:
        common.get_trained_tnn(name, device=dev)
    card_qat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name in datasets:
        common.get_trained_tnn(name, device="cpu")
    cpu_qat_s = time.perf_counter() - t0
    card_key, cpu_key = common.device_key(dev), common.device_key("cpu")
    for name in datasets:
        a = common._TNN_CACHE[(card_key, name, 0)][1]
        b = common._TNN_CACHE[(cpu_key, name, 0)][1]
        qat[name] = {"tnn_acc": [a.test_acc, b.test_acc],
                     "w1t_differ": int((a.w1t != b.w1t).sum())
                     if a.w1t.shape == b.w1t.shape else None,
                     "w2t_differ": int((a.w2t != b.w2t).sum())
                     if a.w2t.shape == b.w2t.shape else None}
        common._TNN_CACHE[(cpu_key, name, 0)] = \
            common._TNN_CACHE[(card_key, name, 0)]

    CK.reset_launches()
    card = paper_benches(dev)
    torch.cuda.synchronize()
    launches = dict(CK.LAUNCHES)
    by_variant = dict(CK.VARIANT_LAUNCHES)
    cpu = paper_benches("cpu")
    bad, side = paper_compare(card, cpu)
    bad += [f"table2 {n}: TNN accuracy card {q['tnn_acc'][0]} cpu "
            f"{q['tnn_acc'][1]} (tolerance {PAPER_TNN_TOL})"
            for n, q in qat.items()
            if abs(q["tnn_acc"][0] - q["tnn_acc"][1]) > PAPER_TNN_TOL]
    out = {
        "nvidia_smi": smi,
        "subset": {"table2": list(datasets), "fig4": PAPER_FIG4_SIZES,
                   "fig5-fig8, table3": PAPER_DATASET,
                   "variation": PAPER_VARIATION_DATASET,
                   "budgets": "quick" if common.QUICK else "full"},
        "rows": {k: v[0] for k, v in card.items()},
        "seconds": {"card": {k: v[1] for k, v in card.items()},
                    "cpu": {k: v[1] for k, v in cpu.items()},
                    "qat_card": card_qat_s, "qat_cpu": cpu_qat_s},
        "headlines": paper_headlines(card),
        "qat_card_vs_cpu": qat, "qat_columns": side,
        "launches": launches, "launches_by_variant": by_variant,
        "mismatches": bad,
    }
    say("paper", **out)
    if bad:
        fail(f"paper: {len(bad)} columns differ card against CPU: "
             + "; ".join(bad[:8]))
    if sum(launches.values()) < 1:
        fail("paper: the harness never launched the gate walk")
    if by_variant["shared_plane"] != sum(launches.values()):
        fail(f"paper: launches by variant {by_variant}, expected every one "
             f"of {sum(launches.values())} through shared_plane")
    return out


def cross_device(phase: str, cfg32, p32: dict, prompt: list[int]) -> None:
    """A float32 model on the card (kernels) against the CPU (plain
    versions): one prompt and 8 greedy steps, the CPU fed the card's
    tokens; logits must agree within `LOGIT_TOL` and tokens wherever the
    top-2 margin exceeds it."""
    import torch

    from repro_torch.models import params as P
    from repro_torch.models import transformer as TF

    card = greedy_logits(cfg32, p32, prompt, 8, TF, torch)
    card_tokens = card.argmax(dim=-1).tolist()
    p_cpu = P.tree_map(lambda a: a.cpu(), p32)
    t0 = time.perf_counter()
    host = greedy_logits(cfg32, p_cpu, prompt, 8, TF, torch,
                         forced=card_tokens)
    cpu_s = time.perf_counter() - t0
    diff = (card - host).abs().max(dim=-1).values
    top2 = host.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    host_tokens = host.argmax(dim=-1).tolist()
    say(phase, arch=cfg32.name, n_layers=cfg32.n_layers,
        d_model=cfg32.d_model, prompt_tokens=len(prompt),
        steps=len(card_tokens), logit_tol=LOGIT_TOL,
        max_abs_diff_per_step=diff.tolist(), top2_margin=margin.tolist(),
        card_tokens=card_tokens, cpu_tokens=host_tokens, cpu_seconds=cpu_s)
    if float(diff.max()) > LOGIT_TOL:
        fail(f"{phase}: logits differ by {float(diff.max()):.3g} > "
             f"{LOGIT_TOL}")
    for step, (a, b, m) in enumerate(zip(card_tokens, host_tokens, margin)):
        if float(m) > LOGIT_TOL and a != b:
            fail(f"{phase}: step {step} token {a} on the card, {b} on the "
                 "CPU")


def bh_first(args: tuple) -> tuple:
    """Captured (B, T, H, dh) scan operands in the reference's (BH, T, dh)
    float32 layout: u repeated for each b, the state (BH, dh, dh)."""
    r, k, v, w, u, s0 = args
    B, T, H, dh = r.shape
    flat = [a.float().permute(0, 2, 1, 3).reshape(B * H, T, dh).contiguous()
            for a in (r, k, v, w)]
    return (*flat, u.repeat(B, 1),
            None if s0 is None else s0.reshape(B * H, dh, dh).contiguous())


def rwkv_phases(dev, cfg) -> dict:
    """`rwkv_serving` (with the check of the kernel on the model's own
    scan inputs) and `rwkv_cross_device` on `cfg`, a full-width bf16
    RWKV-6 config; returns the counted `rwkv6_scan` launches (in total and
    by staging design), the model-input check's stats and the captured
    prefill and decode scan inputs for timing, in the model's layout and
    in PR 13's `(BH, T, dh)` float32 one."""
    import torch

    from repro_torch.kernels import cuda_rwkv6_scan as CW
    from repro_torch.kernels import ops
    from repro_torch.models import params as P
    from repro_torch.serve.lm_engine import LMServeStats, Request, \
        ServingEngine

    t0 = time.perf_counter()
    params = P.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    weights_s = time.perf_counter() - t0
    lm_rng = np.random.default_rng(SEED)
    prompts = [lm_rng.integers(1, cfg.vocab, n).tolist()
               for n in [32] * 8 + [96] * 8]
    engine = ServingEngine(cfg, params, max_batch=8, cache_len=256,
                           device=dev)

    # warm-up, not counted: capture layer 0's scan operands (the model's
    # own bf16 (B, T, H, dh) views, f32 decays, the (H, dh) bonus, and at
    # decode the state the cache holds before the step) in a prefill of
    # 8 x 96 tokens and in the decode step after it
    captured = []
    real = ops.rwkv6_scan_heads

    def capture(r, k, v, w, u, s0=None, s_out=None):
        if len(captured) < 2 and (not captured or s0 is not None):
            captured.append(tuple(None if a is None else a.clone()
                                  for a in (r, k, v, w, u, s0)))
        return real(r, k, v, w, u, s0, s_out)

    ops.rwkv6_scan_heads = capture
    try:
        engine.run([Request(uid=-1 - i, prompt=pr, max_new_tokens=2)
                    for i, pr in enumerate(prompts[8:])])
    finally:
        ops.rwkv6_scan_heads = real
    if len(captured) != 2 or captured[0][0].shape[:3] != (8, 96,
                                                          cfg.n_heads):
        fail("rwkv_serving: the warm-up did not capture a prefill and a "
             "decode scan")
    # the same numbers in PR 13's (BH, T, dh) float32 layout, for timing
    # rows comparable with its
    flat = [bh_first(args) for args in captured]
    mstats = wkv_stats()
    for args in captured + flat:
        wkv_check(args, mstats)
    w = captured[0][3]
    mstats["decay_quantiles"] = torch.quantile(
        w.flatten()[:: max(1, w.numel() // 1_000_000)],
        torch.tensor([0.0, 0.01, 0.5, 0.99, 1.0], device=dev)).tolist()
    say("kernel_vs_plain", rwkv6_scan_model_inputs=mstats,
        shapes=[list(a[0].shape) for a in captured + flat],
        dtypes=[str(a[0].dtype) for a in captured + flat])
    if mstats["mismatches"] or mstats["plain_mismatches"] or \
            mstats["in_place_not_bit_identical"]:
        fail(f"rwkv6_scan on the model's inputs: {mstats['mismatches']} "
             f"kernel and {mstats['plain_mismatches']} plain cases leave "
             f"the f32 envelope, {mstats['in_place_not_bit_identical']} "
             "states in place differ")

    engine.stats = LMServeStats()
    reqs = [Request(uid=i, prompt=pr, max_new_tokens=32)
            for i, pr in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CW.reset_launches()
    engine.run(reqs)
    launches = CW.LAUNCHES["rwkv6_scan"]
    by_design = dict(CW.DESIGN_LAUNCHES)
    lm = engine.stats.summary()
    forwards = lm["prefills"] + lm["decode_steps"]
    peak_bytes = torch.cuda.max_memory_allocated()
    finite = finite_logits(cfg, engine.params, prompts[8:])
    say("rwkv_serving", arch=cfg.name, quant=cfg.quant,
        n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
        vocab=cfg.vocab, params=P.param_count(cfg), weights_s=weights_s,
        requests=len(reqs), new_tokens=[len(r.output) for r in reqs],
        stats=lm, rwkv6_scan_launches=launches,
        launches_by_design=by_design,
        expected=cfg.n_layers * forwards, logits_finite=finite,
        max_memory_allocated_bytes=peak_bytes)
    if any(len(r.output) != 32 for r in reqs):
        fail("rwkv_serving: a request did not get its 32 tokens")
    if launches != cfg.n_layers * forwards:
        fail(f"rwkv_serving: rwkv6_scan launched {launches} times, expected "
             f"{cfg.n_layers * forwards} ({cfg.n_layers} x {forwards} "
             "forwards)")
    if by_design["cp_async"] != launches:
        fail(f"rwkv_serving: launches by staging design {by_design}, "
             "expected every one through cp_async (the model's views are "
             "16-byte aligned)")
    if not finite:
        fail("rwkv_serving: non-finite logits")
    del engine, params

    cfg32 = cfg.replace(n_layers=2, param_dtype="float32",
                        compute_dtype="float32")
    p32 = P.init_params(cfg32, seed=SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    tm = p32["layers"]["tm"]
    for name, a in tm.items():       # draw the leaves the init leaves at 0
        if name.startswith("mu_"):
            a.uniform_(0, 1, generator=gen)
        elif name in ("w0", "u"):
            a.normal_(0, 1 if name == "w0" else 0.5, generator=gen)
    for name in ("mu_k", "mu_r"):
        p32["layers"]["cm"][name].uniform_(0, 1, generator=gen)
    cross_device("rwkv_cross_device", cfg32, p32,
                  lm_rng.integers(1, cfg32.vocab, 16).tolist())
    return {"launches": launches, "by_design": by_design,
            "model_stats": mstats, "captured": captured, "flat": flat}


def rwkv_popcount_timing(rwkv: dict, pop_words: dict,
                         launch_floor_ms: float) -> tuple:
    """Kernel, plain version and bound of the WKV-6 scan on the captured
    prefill and decode operands (in PR 13's `(BH, T, dh)` float32 layout,
    and in the model's own bf16 `(B, T, H, dh)` views, the decode state
    written in place as the model does), and of the popcount on
    `pop_words`, each row with its design and the launch floor."""
    from repro_torch.kernels import cuda_packed_popcount as CP
    from repro_torch.kernels import cuda_rwkv6_scan as CW
    from repro_torch.kernels import packed_popcount as PP
    from repro_torch.kernels import rwkv6_scan as WKV
    from repro_torch.roofline.kernel_model import (popcount_bound_ms,
                                                   wkv_bound_ms)

    wkv_rows = []
    cases = [(step, "(BH, T, dh) float32", args, None)
             for step, args in zip(("prefill", "decode"), rwkv["flat"])]
    for step, args in zip(("prefill", "decode"), rwkv["captured"]):
        s_out = None if args[5] is None else args[5].clone()
        cases.append((step, "model (B, T, H, dh) bf16", args[:5] + (s_out,),
                      s_out))
    for step, layout, args, s_out in cases:
        r, u, s0 = args[0], args[4], args[5]
        T, dh = r.shape[1], r.shape[-1]
        BH = r.numel() // (T * dh)
        row = {"step": step, "layout": layout, "BH": BH, "T": T, "dh": dh,
               "initial_state": s0 is not None,
               "state_in_place": s_out is not None,
               "design": CW.plan(*(a if a.dim() == 4 else a.unsqueeze(2)
                                   for a in args[:4]),
                                 u if r.dim() == 4 else u.unsqueeze(1)
                                 ).design,
               "launch_floor_ms": launch_floor_ms}
        run = (lambda: WKV.rwkv6_scan(*args, s_out)) if s_out is not None \
            else (lambda: WKV.rwkv6_scan(*args))
        row["ms"] = gpu_ms(run, TIMED_REPS, True)
        row["plain_ms"] = gpu_ms(lambda: WKV.rwkv6_scan_plain(*args),
                                 PLAIN_REPS, False)
        row["bound_ms"], row["bound_by"] = wkv_bound_ms(
            BH, T, dh, s0 is not None, r.element_size(),
            u.numel() // dh)
        row["library_ms"] = None
        wkv_rows.append(row)
        say("timing_rwkv", **row)
    pop_rows = []
    for name, words in pop_words.items():
        B, W = words.shape
        plan = CP.plan(B, W, words.data_ptr())
        row = {"words": name, "B": B, "W": W, "design": plan.design,
               "vec16": plan.vec16, "launch_floor_ms": launch_floor_ms}
        row["ms"] = gpu_ms(lambda: PP.packed_popcount(words), TIMED_REPS,
                           True)
        row["plain_ms"] = gpu_ms(lambda: PP.packed_popcount_plain(words),
                                 PLAIN_REPS, True)
        row["bound_ms"], row["bound_by"] = popcount_bound_ms(B, W)
        row["library_ms"] = None
        pop_rows.append(row)
        say("timing_popcount", **row)
    return wkv_rows, pop_rows


def ternary_timing(dev) -> list[dict]:
    """Kernel, plain version, bound and `library_ms` (one torch.matmul on
    weights unpacked to bf16 outside the timed region; a yardstick the port
    never calls) at each (M, K, N) of the LM path, x in bf16, with the
    variant, K splits and tile the plan picks."""
    import torch

    from repro_torch.core.ternary import unpack_ternary
    from repro_torch.kernels import cuda_ternary_matmul as CT
    from repro_torch.kernels import ternary_matmul as TM
    from repro_torch.roofline.kernel_model import ternary_bound_ms

    rows = []
    for M in LM_M:
        for K, N in LM_KN:
            p = CT.plan(M, K, N, torch.bfloat16)
            x = torch.randn(M, K, device=dev, dtype=torch.bfloat16)
            w2 = torch.randint(-128, 128, (K // 4, N), device=dev,
                               dtype=torch.int8)
            sc = torch.rand(1, N, device=dev) + 0.5
            w_dense = unpack_ternary(w2, torch.bfloat16)
            row = {"M": M, "K": K, "N": N, "x": "bfloat16",
                   "variant": p.variant, "splits": p.splits,
                   "tile": list(p.tile), "blocks": p.blocks}
            row["ms"] = gpu_ms(lambda: TM.ternary_matmul(x, w2, sc),
                               TIMED_REPS, True)
            row["plain_ms"] = gpu_ms(
                lambda: TM.ternary_matmul_plain(x, w2, sc), PLAIN_REPS, True)
            row["library_ms"] = gpu_ms(lambda: torch.matmul(x, w_dense) * sc,
                                       TIMED_REPS, True)
            row["bound_ms"], row["bound_by"] = ternary_bound_ms(M, K, N, 2)
            rows.append(row)
            say("timing_ternary", **row)
    return rows


def wkv_bwd_check(args: tuple, dy, ds, stats: dict) -> None:
    """The WKV-6 backward kernel on `(B, T, H, dh)` operands (r, k, v, w,
    u, s0; s0 and the final state's gradient `ds` may be None), from the
    checkpoints its forward instance kept, against `rwkv6_scan_bwd_plain`
    (from the plain forward's checkpoints) and the float64 reverse
    recurrence.  Every gradient element must lie inside eps (dh + 2T + 4)
    times the same recurrence run on absolute values (the forward's
    envelope, applied to the adjoint), plus one rounding of the output
    type for bf16 dr, dk, dv; the checkpoints inside the forward's
    envelope; a second launch bit-identical to the first."""
    import torch

    from repro_torch.kernels import cuda_rwkv6_scan as CW
    from repro_torch.kernels import rwkv6_scan as WKV

    r, k, v, w, u, s0 = args
    B, T, H, dh = r.shape
    ck = torch.empty((B, H, WKV.n_checkpoints(T), dh, dh),
                     dtype=torch.float32, device=r.device)
    CW.launch(r, k, v, w, u, s0, ckpt=ck)
    got = CW.launch_bwd(r, k, v, w, u, ck, dy, ds)
    again = CW.launch_bwd(r, k, v, w, u, ck, dy, ds)
    ck_plain = torch.empty_like(ck)
    WKV.rwkv6_scan_plain(r, k, v, w, u, s0, ckpt=ck_plain)
    plain = WKV.rwkv6_scan_bwd_plain(r, k, v, w, u, ck_plain, dy, ds)

    def f64(xs, fn):
        return [None if a is None else fn(a.double()) for a in xs]

    def reverse(xs, dy_, ds_):
        c = torch.empty((B, H, WKV.n_checkpoints(T), dh, dh),
                        dtype=torch.float64, device=r.device)
        WKV.rwkv6_scan_plain(*xs, ckpt=c)
        return c, WKV.rwkv6_scan_bwd_plain(*xs[:5], c, dy_, ds_)

    ck64, exact = reverse(f64(args, lambda a: a), *f64((dy, ds),
                                                       lambda a: a))
    ck_abs, env = reverse(f64(args, torch.abs), *f64((dy, ds), torch.abs))
    gamma = float(np.finfo(np.float32).eps) * (dh + 2 * T + 4)
    ratio = plain_ratio = 0.0
    for g, p, e, m in zip(got + (ck,), plain + (ck_plain,), exact + (ck64,),
                          env + (ck_abs,)):
        if not g.numel():
            continue
        bound = gamma * m + 1e-30
        if g.dtype == torch.bfloat16:       # one rounding of the f32 sum
            bound = bound * (1 + 2.0 ** -8) + 2.0 ** -8 * e.abs()
        ratio = max(ratio, float(((g.double() - e).abs() / bound).max()))
        plain_ratio = max(plain_ratio,
                          float(((p.double() - e).abs() / bound).max()))
        stats["max_abs_err"] = max(stats["max_abs_err"],
                                   float((g.float() - p.float()).abs().max()))
    torch.cuda.synchronize()
    stats["cases"] += 1
    stats["mismatches"] += int(ratio > 1)
    stats["plain_mismatches"] += int(plain_ratio > 1)
    stats["not_bit_identical"] += int(not all(
        torch.equal(a, b) for a, b in zip(got, again)))
    stats["max_err_over_envelope"] = max(stats["max_err_over_envelope"],
                                         ratio)


def wkv_bwd_vs_plain(dev, rng) -> dict:
    """The WKV-6 backward grid of `kernel_vs_plain`: the reference's
    `(BH, T, dh)` float32 layout (as H = 1) and the model's strided
    `(B, T, H, dh)` bf16 and float32 views (u shared by the batch, views
    off 16-byte boundaries), dh 16 and 64, T of 1, 13, 96 and 256 (the
    training shape among them), decays log-uniform down to 1e-12, with
    and without an initial state and a gradient on the final state; then
    `rwkv6_scan` under autograd, which must launch the forward and the
    backward kernel once each and give the backward kernel's gradients."""
    import torch

    from repro_torch.kernels import cuda_rwkv6_scan as CW
    from repro_torch.kernels import rwkv6_scan as WKV

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    stats = {"cases": 0, "mismatches": 0, "plain_mismatches": 0,
             "max_err_over_envelope": 0.0, "max_abs_err": 0.0,
             "not_bit_identical": 0}
    grid = []
    for T in (1, 13, 96, 256):
        for dh in (16, 64):
            for state in (False, True):
                grid.append((torch.float32, (64, T, 1, dh), 0, state, False))
                grid.append((torch.bfloat16 if dh == 64 else torch.float32,
                             (2, T, 4, dh), int(state), state, True))
    grid.append((torch.bfloat16, (2, 256, 64, 64), 0, False, True))
    for dtype, (B, T, H, dh), offset, state, shared_u in grid:
        r, k, v, w, u = model_layout(rng, dev, B, T, H, dh, dtype, offset)
        if not shared_u:
            u = t(rng.normal(0, 0.5, (B, H, dh)))
        s0 = t(rng.standard_normal((B, H, dh, dh))) if state else None
        ds = t(rng.standard_normal((B, H, dh, dh))) if state else None
        dy = t(rng.standard_normal((B, T, H, dh)))
        wkv_bwd_check((r, k, v, w, u, s0), dy, ds, stats)
    # the autograd Function on the card: one forward and one backward
    # launch, and the backward kernel's gradients
    r, k, v, w, u = (a.detach().clone().requires_grad_() for a in
                     model_layout(rng, dev, 2, 37, 3, 64, torch.bfloat16))
    s0 = t(rng.standard_normal((2, 3, 64, 64))).requires_grad_()
    before = dict(CW.LAUNCHES)
    y, s = WKV.rwkv6_scan(r, k, v, w, u, s0)
    dy = torch.randn_like(y)
    grads = torch.autograd.grad((y * dy).sum() + s.sum(),
                                (r, k, v, w, u, s0))
    launched = {n: CW.LAUNCHES[n] - before[n] for n in CW.LAUNCHES}
    ck = torch.empty((2, 3, WKV.n_checkpoints(37), 64, 64),
                     dtype=torch.float32, device=dev)
    with torch.no_grad():
        CW.launch(r, k, v, w, u, s0, ckpt=ck)
        want = CW.launch_bwd(r, k, v, w, u, ck, dy, torch.ones_like(s))
    stats["autograd_launches"] = launched
    stats["autograd_equals_kernel"] = all(
        torch.equal(g, x) for g, x in zip(
            grads, want[:4] + (want[4].sum(0), want[5])))
    torch.cuda.synchronize()
    return stats


def adam_step_tol(p, g_cpu, g_card, clip: float, lr: float,
                  eps: float):
    """How far one first AdamW step (no weight decay) may move a
    parameter apart on two devices whose gradients differ by
    |g_card - g_cpu|: the step is lr u, u = g'/(|g'| + eps) of the clipped
    g', so a difference dg' moves it by at most lr eps dg' / (|g'| - dg' +
    eps)^2 (and never more than 2 lr), plus the f32 roundings of u (a few
    ulps of |u| <= 1, in the bias corrections, sqrt and quotient) and of
    p - lr u."""
    import torch

    f32 = float(np.finfo(np.float32).eps)
    dg = (g_card.float() - g_cpu.float()).abs() * clip
    gmin = torch.clamp(g_cpu.float().abs() * clip - dg, min=0.0)
    return lr * torch.clamp(4 * eps * dg / (gmin + eps) ** 2, max=2.0) \
        + 4 * f32 * (lr + p.float().abs())


def train_cross_device(dev) -> list[dict]:
    """One train step card against CPU, float32, from the same weights and
    the same batch (each device draws it from the token stream: the
    tokens must be equal), on each of `TRAIN_CROSS` reduced: loss, every
    gradient and every updated parameter held (`TRAIN_LOSS_TOL`,
    `TRAIN_GRAD_TOL`, `adam_step_tol`)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.models import params as P
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.train.loop import TrainLoopConfig, grads_of, \
        make_train_step

    rows = []
    for arch, quant in TRAIN_CROSS:
        cfg = get_config(arch).reduced().replace(quant=quant)
        gen = torch.Generator().manual_seed(SEED + 1)

        def drawn(a):      # leaves the init leaves constant get noise too
            if a.numel() > 1 and float(a.std()) == 0.0:
                return a + 0.1 * torch.randn(a.shape, generator=gen)
            return a

        p_cpu = P.tree_map(drawn, P.init_params(cfg, seed=SEED,
                                                device="cpu"))
        p_card = P.tree_map(lambda a: a.to(dev), p_cpu)
        pcfg = TokenPipelineConfig(vocab=cfg.vocab, seq_len=32,
                                   global_batch=4, seed=SEED)
        b_cpu = TokenPipeline(pcfg, device="cpu").batch_at(1)
        b_card = TokenPipeline(pcfg, device=dev).batch_at(1)
        if not all(torch.equal(b_cpu[n], b_card[n].cpu()) for n in b_cpu):
            fail(f"training: {arch}'s token stream differs card vs CPU")
        g_cpu, m_cpu = grads_of(cfg, p_cpu, b_cpu)
        g_card, m_card = grads_of(cfg, p_card, b_card)
        ocfg = AdamWConfig(lr=TRAIN_LR)
        step = make_train_step(cfg, TrainLoopConfig(optimizer=ocfg))
        n_cpu, _, _, _ = step(p_cpu, adamw.init(p_cpu), b_cpu)
        n_card, _, _, _ = step(p_card, adamw.init(p_card), b_card)
        clip = float(adamw.clip_scale(ocfg, g_cpu))
        gmax = max(float(g.abs().max()) for g in tree_leaves(g_cpu))
        grad_ratio, step_ratio, worst = 0.0, 0.0, {}
        for path, p, gc, gd, nc, nd in zip(P.leaves(p_cpu), *(
                tree_leaves(x) for x in (p_cpu, g_cpu, g_card, n_cpu,
                                         n_card))):
            gd, nd = gd.cpu(), nd.cpu()
            ratio = float((gd - gc).abs().max()) / (TRAIN_GRAD_TOL * gmax)
            tol = adam_step_tol(p, gc, gd, clip, TRAIN_LR, ocfg.eps)
            sratio = float(((nd - nc).abs() / tol).max())
            name = "/".join(path[0])
            if ratio > grad_ratio:
                grad_ratio, worst["grad"] = ratio, name
            if sratio > step_ratio:
                step_ratio, worst["step"] = sratio, name
        flips = 0
        if quant == "ternary":          # the STE's codes on each device
            from repro_torch.core.ternary import ternary_quantize_lm
            for path, a in P.leaves(p_cpu):
                if path[-1] == "w" and a.dim() == 3:
                    for i in range(a.shape[0]):
                        flips += int((ternary_quantize_lm(a[i])[0]
                                      != ternary_quantize_lm(
                                          a[i].to(dev))[0].cpu()).sum())
        row = {"arch": arch, "quant": quant,
               "loss_cpu": float(m_cpu["loss"]),
               "loss_card": float(m_card["loss"]),
               "grad_diff_over_tol": grad_ratio,
               "step_diff_over_tol": step_ratio, "worst_leaf": worst,
               "ternary_code_flips": flips}
        rows.append(row)
        say("training_cross_device", **row, loss_tol=TRAIN_LOSS_TOL,
            grad_tol=TRAIN_GRAD_TOL)
        if abs(row["loss_card"] - row["loss_cpu"]) > TRAIN_LOSS_TOL or \
                grad_ratio > 1 or step_ratio > 1:
            fail(f"training: {arch} card vs CPU outside its tolerance "
                 f"({row})")
    return rows


def train_run(trainer, params, opt_state, start: int, err=None):
    """`trainer.run` with its log kept; returns (params, opt_state,
    result, log lines, seconds)."""
    import torch

    lines = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt_state, res = trainer.run(params, opt_state, start_step=start,
                                         err_buf=err, log=lines.append)
    torch.cuda.synchronize()
    return params, opt_state, res, lines, time.perf_counter() - t0


def training_phase(dev, smi: str) -> dict:
    """LM training on the card through `train.loop.Trainer`: the ternary
    matmul refuses autograd; one step
    card vs CPU (`train_cross_device`); rwkv6-7b at published width, cut
    to TRAIN_RWKV_DEPTH layers, bf16 with int8 AdamW moments, gradient
    compression and TRAIN_RWKV_MICRO microbatches, its WKV launches
    counted (forward twice a layer a microbatch a step under remat, the
    backward once) and its backward kernel timed at the training shape;
    llama3.2-1b at full width and depth in ternary QAT with f32 AdamW,
    checkpointed at TRAIN_RESUME_STEP and resumed by a fresh Trainer
    (restored tensors bit-exact, the step and the stream continued), no
    ternary-matmul launch; `python -m repro_torch.launch.train --preset
    lm100m` in a process of its own.  Losses finite and the last below
    the first in every run."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels import cuda_rwkv6_scan as CW
    from repro_torch.kernels import cuda_ternary_matmul as CT
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_scan as WKV
    from repro_torch.models import params as P
    from repro_torch.optim import adamw, adamw8bit
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.optim.grad_compress import init_error_buffer
    from repro_torch.roofline.kernel_model import wkv_bwd_bound_ms
    from repro_torch.train.loop import Trainer, TrainLoopConfig

    sys.path.insert(0, str(ROOT / "tools"))
    from chip_profile import device_profile

    x = torch.randn(4, 64, device=dev, requires_grad=True)
    w2 = torch.zeros(16, 8, dtype=torch.int8, device=dev)
    try:
        ops.ternary_matmul(x, w2, torch.ones(1, 8, device=dev))
        refused = False
    except RuntimeError as e:
        refused = "no backward" in str(e)
    if not refused:
        fail("training: the ternary matmul ran under autograd")
    cross = train_cross_device(dev)
    tmp = Path(tempfile.mkdtemp(prefix="train_"))
    out = {"cross_device": cross}

    def check_losses(name, losses):
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"training: {name} losses {losses} are not finite and "
                 "falling")

    def summary(cfg, B, res, seconds, n_steps, peak):
        times = res["times"]
        return {"arch": cfg.name, "n_layers": cfg.n_layers,
                "d_model": cfg.d_model, "vocab": cfg.vocab,
                "quant": cfg.quant, "params": P.param_count(cfg),
                "batch": B, "seq": TRAIN_SEQ, "steps": n_steps,
                "losses": res["losses"], "seconds": seconds,
                "step_ms": [1e3 * t for t in times],
                "step_p50_ms": 1e3 * float(np.median(times[1:] or times)),
                "tokens_per_s": B * TRAIN_SEQ
                / float(np.median(times[1:] or times)),
                "peak_memory_bytes": peak}

    try:
        # -- rwkv6-7b, published width, depth cut --------------------------
        cfg = get_config("rwkv6-7b").replace(n_layers=TRAIN_RWKV_DEPTH,
                                             opt_8bit=True)
        pipe = TokenPipeline(TokenPipelineConfig(
            vocab=cfg.vocab, seq_len=TRAIN_SEQ,
            global_batch=TRAIN_RWKV_BATCH, seed=SEED), device=dev)
        loop = TrainLoopConfig(
            total_steps=TRAIN_STEPS, microbatches=TRAIN_RWKV_MICRO,
            ckpt_every=TRAIN_STEPS, grad_compress=True,
            optimizer=AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                  total_steps=TRAIN_STEPS))
        trainer = Trainer(cfg, loop, pipe, str(tmp / "rwkv"), device=dev)
        params = P.init_params(cfg, seed=SEED, device=dev)
        opt = adamw8bit.init(params)
        err = init_error_buffer(params)
        captured = []
        real = ops.rwkv6_scan_heads

        def capture(r, k, v, w, u, s0=None, s_out=None):
            if not captured:
                captured.append(tuple(a.detach().clone()
                                      for a in (r, k, v, w, u)))
            return real(r, k, v, w, u, s0, s_out)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        CW.reset_launches()
        CT.reset_launches()
        ops.rwkv6_scan_heads = capture
        try:
            params, opt, res, log, seconds = train_run(trainer, params, opt,
                                                       0, err)
        finally:
            ops.rwkv6_scan_heads = real
        launches = dict(CW.LAUNCHES)
        res["times"] = trainer.stats.times
        row = summary(cfg, TRAIN_RWKV_BATCH, res, seconds, TRAIN_STEPS,
                      torch.cuda.max_memory_allocated())
        per = cfg.n_layers * TRAIN_RWKV_MICRO * TRAIN_STEPS
        want = {"rwkv6_scan": 2 * per, "rwkv6_scan_bwd": per}
        row |= {"launches": launches, "expected": want,
                "ternary_matmul_launches": CT.LAUNCHES["ternary_matmul"],
                "opt_8bit": True, "grad_compress": True,
                "microbatches": TRAIN_RWKV_MICRO, "remat": cfg.remat,
                "log": log}
        say("training_rwkv", **row)
        check_losses("rwkv6-7b", res["losses"])
        if launches != want:
            fail(f"training: rwkv6-7b launched {launches}, expected {want} "
                 "(forward twice a layer a microbatch a step under remat, "
                 "the backward once)")
        # one step under the profiler: the device's busy share
        batch = pipe.batch_at(0)
        prof = device_profile(lambda: trainer.train_step(
            params, opt, batch, err), 1)
        row["profile"] = prof
        say("training_rwkv_profile", **prof)
        # the backward kernel at the training shape, on layer 0's operands
        r, k, v, w, u = captured[0]              # one microbatch's
        B, T, H, dh = r.shape
        ck = torch.empty((B, H, WKV.n_checkpoints(T), dh, dh),
                         dtype=torch.float32, device=dev)
        CW.launch(r, k, v, w, u, None, ckpt=ck)
        dy = torch.randn((B, T, H, dh), device=dev)
        bwd = {"B": B, "T": T, "H": H, "dh": dh, "x": str(r.dtype)}
        bwd["ms"] = gpu_ms(lambda: CW.launch_bwd(r, k, v, w, u, ck, dy,
                                                 None), TIMED_REPS, True)
        bwd["plain_ms"] = gpu_ms(lambda: WKV.rwkv6_scan_bwd_plain(
            r, k, v, w, u, ck, dy, None), PLAIN_REPS, False)
        bwd["bound_ms"], bwd["bound_by"] = wkv_bwd_bound_ms(
            B * H, T, dh, False, False, r.element_size(), H)
        bwd["library_ms"] = None
        bwd["forward_ms"] = gpu_ms(lambda: CW.launch(r, k, v, w, u, None,
                                                     ckpt=ck),
                                   TIMED_REPS, True)
        say("timing_rwkv_bwd", **bwd)
        out["rwkv"], out["bwd_timing"] = row, bwd
        del params, opt, err, trainer, captured, r, k, v, w, ck, dy
        torch.cuda.empty_cache()

        # -- llama3.2-1b, full, ternary QAT, checkpoint and resume ---------
        cfg = get_config("llama3.2-1b").replace(quant="ternary")
        pipe = TokenPipeline(TokenPipelineConfig(
            vocab=cfg.vocab, seq_len=TRAIN_SEQ,
            global_batch=TRAIN_LLAMA_BATCH, seed=SEED), device=dev)

        def loop_to(total):
            return TrainLoopConfig(
                total_steps=total, ckpt_every=TRAIN_RESUME_STEP,
                keep_ckpts=1, optimizer=AdamWConfig(
                    lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS))

        def init_fn():
            p = P.init_params(cfg, seed=SEED, device=dev)
            return p, adamw.init(p)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        CW.reset_launches()
        CT.reset_launches()
        first = Trainer(cfg, loop_to(TRAIN_RESUME_STEP), pipe,
                        str(tmp / "llama"), device=dev)
        params, opt, start = first.resume_or_init(init_fn)
        params, opt, res1, log1, s1 = train_run(first, params, opt, start)
        peak = torch.cuda.max_memory_allocated()
        res1["times"] = list(first.stats.times)
        saved = [a.clone() for a in tree_leaves({"p": params, "o": {
            "mu": opt.mu, "nu": opt.nu, "step": opt.step}})]
        del params, opt
        torch.cuda.empty_cache()
        second = Trainer(cfg, loop_to(TRAIN_STEPS), pipe, str(tmp / "llama"),
                         device=dev)
        t0 = time.perf_counter()
        params, opt, start = second.resume_or_init(init_fn)
        restore_s = time.perf_counter() - t0
        restored = tree_leaves({"p": params, "o": {
            "mu": opt.mu, "nu": opt.nu, "step": opt.step}})
        bit_exact = len(saved) == len(restored) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(saved, restored))
        del saved, restored
        params, opt, res2, log2, s2 = train_run(second, params, opt, start)
        res = {"losses": res1["losses"] + res2["losses"],
               "times": res1["times"] + list(second.stats.times)}
        row = summary(cfg, TRAIN_LLAMA_BATCH, res, s1 + s2, TRAIN_STEPS,
                      peak)
        row |= {"launches": dict(CW.LAUNCHES),
                "ternary_matmul_launches": CT.LAUNCHES["ternary_matmul"],
                "resumed_from": start, "restore_s": restore_s,
                "save_s": [s1 - sum(res1["times"]),
                           s2 - sum(second.stats.times)],
                "restored_bit_exact": bit_exact,
                "last_step": res2["last_step"], "log": log1 + log2,
                "checkpoint_steps": second.ckpt.all_steps()}
        say("training_llama", **row)
        check_losses("llama3.2-1b", res["losses"])
        if start != TRAIN_RESUME_STEP or not bit_exact or \
                res2["last_step"] != TRAIN_STEPS:
            fail(f"training: the resume did not hold (from {start}, "
                 f"bit-exact {bit_exact}, last step {res2['last_step']})")
        if CT.LAUNCHES["ternary_matmul"] or sum(CW.LAUNCHES.values()):
            fail("training: llama3.2-1b launched a kernel it must not "
                 f"({CT.LAUNCHES}, {CW.LAUNCHES})")
        out["llama"] = row
        del params, opt, first, second
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- the CLI in a process of its own -----------------------------------
    with tempfile.TemporaryDirectory(prefix="train_cli_") as ck_dir:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--preset",
             "lm100m", "--device", "cuda", "--steps", str(TRAIN_CLI_STEPS),
             "--ckpt-dir", ck_dir, "--ckpt-every", str(TRAIN_CLI_STEPS)],
            capture_output=True, text=True, timeout=600, cwd=str(ROOT),
            env={**os.environ, "PYTHONPATH": str(SRC)})
        cli_s = time.perf_counter() - t0
    if proc.returncode:
        fail(f"training: launch.train exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    cli = json.loads(proc.stdout.strip().splitlines()[-1])
    say("training_cli", **cli, seconds=cli_s)
    if not (cli["steps"] == TRAIN_CLI_STEPS
            and cli["last_loss"] < cli["first_loss"]):
        fail(f"training: launch.train gave {cli}")
    out["cli"] = cli
    return out


def roofline_cell(name: str, cfg, shape, *, microbatches: int = 1,
                  grad_compress: bool = False, cache_len=None,
                  measured_ms: float, peak_bytes: int,
                  launches: dict, smi: str) -> dict:
    """One cell of the `roofline` phase: its cost traced on meta (the
    components x trips and the whole step), held against what the card
    measured for the same step."""
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.models.params import active_param_count
    from repro_torch.roofline.analysis import model_flops
    from repro_torch.roofline.component_costing import cell_tokens, cost_cell
    from repro_torch.roofline.kernel_model import BF16_FLOP_PER_S

    t0 = time.perf_counter()
    cost = cost_cell(cfg, shape, microbatches, grad_compress, cache_len)
    whole = trace_step(cfg, shape, microbatches, grad_compress, cache_len)
    trace_s = time.perf_counter() - t0
    r = cost["roofline"]
    bound_ms = 1e3 * max(r["compute_s"], r["memory_s"])
    mf = model_flops(active_param_count(cfg.replace(quant="dense")),
                     cell_tokens(shape), shape.kind)
    est = whole["memory"]["peak_estimate_bytes"]
    kernels = {k: int(v) for k, v in cost["kernels"].items()}
    row = {"cell": name, "arch": cfg.name, "quant": cfg.quant,
           "n_layers": cfg.n_layers, "kind": shape.kind,
           "batch": shape.global_batch, "seq": shape.seq_len,
           "microbatches": microbatches, "grad_compress": grad_compress,
           "cache_len": cache_len, "bound_ms": bound_ms,
           "compute_ms": 1e3 * r["compute_s"],
           "memory_ms": 1e3 * r["memory_s"], "dominant": r["dominant"],
           "flops_by_class": r["flops_by_class"],
           "bytes": r["bytes_per_device"], "measured_ms": measured_ms,
           "bound_over_measured": bound_ms / measured_ms,
           "model_flops": mf,
           "model_flop_share": mf / BF16_FLOP_PER_S / (measured_ms * 1e-3),
           "peak_estimate_bytes": est,
           "argument_bytes": whole["memory"]["argument_bytes"],
           "measured_peak_bytes": peak_bytes,
           "peak_error": est / peak_bytes - 1.0,
           "costed_kernels": kernels, "traced_kernels": whole["cost"].kernels,
           "launches": launches, "trace_s": trace_s, "nvidia_smi": smi}
    say("roofline_cell", **row)
    if row["bound_over_measured"] > ROOFLINE_FRACTION_MAX:
        fail(f"roofline: {name}'s bound {bound_ms:.3f} ms is "
             f"{row['bound_over_measured']:.3f} of the measured "
             f"{measured_ms:.3f} ms: the costing counts work the card did "
             "not do")
    if kernels != launches or whole["cost"].kernels != cost["kernels"]:
        fail(f"roofline: {name} costs kernel calls {kernels} (whole step "
             f"{whole['cost'].kernels}), the card launched {launches}")
    if abs(row["peak_error"]) > ROOFLINE_PEAK_TOL:
        fail(f"roofline: {name}'s peak estimate {est} B is "
             f"{row['peak_error']:+.1%} off the measured {peak_bytes} B")
    return row


def train_step_peak(dev, cfg, batch: int, microbatches: int = 1,
                    grad_compress: bool = False) -> int:
    """The bytes one `make_train_step` step of `cfg` holds at its peak
    above what the process held before its arguments: fresh weights
    (seed SEED), the optimizer state, the error buffer and one batch of
    the token stream, a warm-up step, then the step measured, with only
    the step's own arguments alive beside it, as the meta trace has them
    (a `Trainer.run` also keeps its caller's step-0 state alive)."""
    import torch

    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.models import params as P
    from repro_torch.optim import adamw, adamw8bit
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.grad_compress import init_error_buffer
    from repro_torch.train.loop import TrainLoopConfig, make_train_step

    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=batch, seed=SEED),
        device=dev)
    step = make_train_step(cfg, TrainLoopConfig(
        microbatches=microbatches, grad_compress=grad_compress,
        optimizer=AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                              total_steps=TRAIN_STEPS)))
    # earlier phases' cyclic garbage freed now, not inside the measured step
    # (where it would pull the allocated bytes below `base`)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = P.init_params(cfg, seed=SEED, device=dev)
    opt = (adamw8bit if cfg.opt_8bit else adamw).init(params)
    err = init_error_buffer(params) if grad_compress else None
    data = pipe.batch_at(0)
    params, opt, _, err = step(params, opt, data, err)       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, opt, _, err = step(params, opt, data, err)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del params, opt, err, data, _
    torch.cuda.empty_cache()
    return peak


def roofline_env() -> dict:
    return {**os.environ,
            "PYTHONPATH": os.pathsep.join([str(SRC), str(ROOT)])}


def start_roofline_clis() -> tuple[Path, dict]:
    """`python -m repro_torch.launch.dryrun` and `launch.roofline_run` for
    llama3.2-1b x all shapes, each in a process of its own, writing under
    a fresh directory.  They trace on meta and only use the host, so they
    are started first and run beside the phases before `roofline`, which
    reads them; at exit any still running is killed and the directory
    removed.  Returns `(directory, {module: process})`."""
    import atexit
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="roofline_"))
    procs = {mod: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.launch.{mod}", "--arch",
         "llama3.2-1b", "--out", str(tmp / "reports" / f"{out}.jsonl")]
        + (["--device", "cuda"] if mod == "dryrun" else []),
        cwd=str(tmp), env=roofline_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for mod, out in (("dryrun", "dryrun_torch"),
                         ("roofline_run", "roofline_torch"))}

    def stop():
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(tmp, ignore_errors=True)

    atexit.register(stop)
    return tmp, procs


def roofline_phase(dev, smi: str, train: dict, clis: tuple) -> dict:
    """The step roofline against the card (the docstring's 6d); `clis` is
    what `start_roofline_clis` returned."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import cuda_ternary_matmul as CT
    from repro_torch.models import params as P
    from repro_torch.models import transformer as TF

    t_phase = time.perf_counter()
    tmp, procs = clis
    reports = tmp / "reports"
    rows = []
    # -- the training phase's cells ------------------------------------
    # the step time and the launches are the training phase's, the
    # peak that of one step with only its arguments alive beside it
    rwkv, llama = train["rwkv"], train["llama"]
    cfg = get_config("rwkv6-7b").replace(n_layers=TRAIN_RWKV_DEPTH,
                                         opt_8bit=True)
    seq = ShapeConfig("train", TRAIN_SEQ, TRAIN_RWKV_BATCH, "train")
    rows.append(roofline_cell(
        "train rwkv6-7b", cfg, seq,
        microbatches=TRAIN_RWKV_MICRO, grad_compress=True,
        measured_ms=rwkv["step_p50_ms"],
        peak_bytes=train_step_peak(dev, cfg, TRAIN_RWKV_BATCH,
                                   TRAIN_RWKV_MICRO, True),
        launches={k: v / TRAIN_STEPS for k, v in (
            *rwkv["launches"].items(),
            ("ternary_matmul", rwkv["ternary_matmul_launches"])) if v},
        smi=smi))
    cfg = get_config("llama3.2-1b").replace(quant="ternary")
    seq = ShapeConfig("train", TRAIN_SEQ, TRAIN_LLAMA_BATCH, "train")
    rows.append(roofline_cell(
        "train llama3.2-1b", cfg, seq, measured_ms=llama["step_p50_ms"],
        peak_bytes=train_step_peak(dev, cfg, TRAIN_LLAMA_BATCH),
        launches={k: v for k, v in (*llama["launches"].items(), (
            "ternary_matmul", llama["ternary_matmul_launches"])) if v},
        smi=smi))

    # -- lm_serving's cells, run here ----------------------------------
    cfg = get_config("llama3.2-1b").replace(quant="ternary_packed")
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = P.serving_params(cfg, SEED, dev)
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.from_numpy(rng.integers(
        1, cfg.vocab, (ROOFLINE_BATCH, ROOFLINE_PROMPT)).astype(
            np.int32)).to(dev)}

    def prefill():
        with torch.inference_mode():
            hidden, cache = TF.prefill(cfg, params, batch,
                                       ROOFLINE_CACHE)
            return TF.logits_from_hidden(cfg, params,
                                         hidden[:, -1:, :]), cache

    def measure(step):
        """(one step's peak above `base` and ternary launches, the
        p50 ms of ROOFLINE_REPS more on the host clock)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        CT.reset_launches()
        out = step(0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        launches = {"ternary_matmul": CT.LAUNCHES["ternary_matmul"]}
        del out
        times = []
        for i in range(ROOFLINE_REPS):
            t0 = time.perf_counter()
            out = step(i + 1)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            del out
        return peak, launches, float(np.median(times))

    prefill()                                       # warm-up
    peak, launches, ms = measure(lambda i: prefill())
    rows.append(roofline_cell(
        "prefill llama3.2-1b ternary_packed", cfg,
        ShapeConfig("prefill", ROOFLINE_PROMPT, ROOFLINE_BATCH,
                    "prefill"), cache_len=ROOFLINE_CACHE,
        measured_ms=ms, peak_bytes=peak, launches=launches, smi=smi))
    logits, cache = prefill()
    del logits
    tok = torch.ones((ROOFLINE_BATCH, 1), dtype=torch.int32, device=dev)

    def decode(i):
        with torch.inference_mode():
            return TF.decode_step(cfg, params, cache, tok,
                                  ROOFLINE_PROMPT + i)[0]

    decode(0)                                       # warm-up
    peak, launches, ms = measure(decode)
    rows.append(roofline_cell(
        "decode llama3.2-1b ternary_packed", cfg,
        ShapeConfig("decode", ROOFLINE_CACHE, ROOFLINE_BATCH, "decode"),
        measured_ms=ms, peak_bytes=peak, launches=launches, smi=smi))
    del params, cache, batch, tok
    torch.cuda.empty_cache()

    # -- the CLIs, in processes of their own ---------------------------
    clis = {}
    for mod, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        clis[mod] = {"returncode": proc.returncode,
                     "lines": out.strip().splitlines()}
        if proc.returncode:
            fail(f"roofline: launch.{mod} exited {proc.returncode}: "
                 f"{err[-2000:]}")
    bench = subprocess.run(
        [sys.executable, "-m", "benchmarks_torch.run", "--only",
         "roofline", "--device", "cuda"], capture_output=True,
        text=True, timeout=300, cwd=str(tmp), env=roofline_env())
    if bench.returncode:
        fail(f"roofline: benchmarks_torch.run --only roofline exited "
             f"{bench.returncode}: {bench.stderr[-2000:]}")
    bench_rows = [json.loads(line.split(",", 2)[2]) for line in
                  bench.stdout.strip().splitlines()[1:]]
    records = [json.loads(line) for line in
               (reports / "dryrun_torch.jsonl").read_text().splitlines()]
    statuses = {r["shape"]: r["status"] for r in records}
    want = {"train_4k": "ok", "prefill_32k": "ok", "decode_32k": "ok",
            "long_500k": "skipped"}
    if statuses != want or [r["status"] for r in bench_rows] != \
            [want[r["shape"]] for r in bench_rows] \
            or len(bench_rows) != len(want):
        fail(f"roofline: the dry run gave {statuses} and the harness "
             f"{bench_rows}")
    clis["bench_rows"] = bench_rows
    clis["device"] = records[0]["device"]
    out = {"cells": rows, "clis": clis,
           "seconds": time.perf_counter() - t_phase}
    say("roofline", nvidia_smi=smi, seconds=out["seconds"],
        cells=[{k: r[k] for k in ("cell", "bound_ms", "dominant",
                                  "measured_ms", "bound_over_measured",
                                  "model_flop_share", "peak_estimate_bytes",
                                  "measured_peak_bytes")} for r in rows],
        dryrun=clis["dryrun"]["lines"],
        roofline_run=clis["roofline_run"]["lines"],
        bench_rows=clis["bench_rows"], dryrun_device=clis["device"])
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir() or not EMIT_DIR.is_dir():
        print(f"chip_smoke: no src/repro_torch or tests/golden_emit beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    from repro_torch import resolve_device
    from repro_torch.compile.artifact import load_manifest, load_program
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import circuit_sim as CS
    from repro_torch.kernels import cuda_circuit_sim as CK
    from repro_torch.kernels import cuda_packed_popcount as CP
    from repro_torch.kernels import cuda_rwkv6_scan as CW
    from repro_torch.kernels import cuda_ternary_matmul as CT
    from repro_torch.kernels import dispatch as D
    from repro_torch.kernels import ops
    from repro_torch.roofline.kernel_model import bound_ms, chain_bound_ms
    from repro_torch.serve.engine import CircuitServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    dev = resolve_device(None)
    say("env", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0],
        device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())
    roofline_clis = start_roofline_clis()      # read by the roofline phase

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    wrappers = (CK, CT, CP, CW)
    libs = _build.build([m.SOURCE for m in wrappers])  # one nvcc each, together
    for m in wrappers:
        m._lib()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for source, lib in libs.items():
        log = Path(str(lib) + ".log")
        ptxas[source] = [ln.strip() for ln in (log.read_text().splitlines()
                                               if log.exists() else [])
                         if "registers" in ln or "spill" in ln]
    circuit_log = Path(str(libs[CK.SOURCE]) + ".log")
    say("build", seconds=round(build_s, 3),
        libraries=[str(p.relative_to(ROOT)) for p in libs.values()],
        ptxas=ptxas,
        circuit_kernels=ptxas_kernels(circuit_log.read_text()
                                      if circuit_log.exists() else ""),
        circuit_dynamic_smem_max_bytes=CK.SMEM_MAX)
    sass = sass_tensor_ops(libs[CT.SOURCE])
    say("sass", library=str(libs[CT.SOURCE].relative_to(ROOT)), **sass)
    if "kernels" in sass and not any(
            c["HMMA"] + c["HGMMA"] for k, c in sass["kernels"].items()
            if "ternary_mma_kernel" in k):
        fail("sass: no HMMA or HGMMA in ternary_mma_kernel")

    # -- 3. every kernel against its plain version on the card -------------
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def checked_plan(prog) -> tuple:
        """A program's validated `(1, G)` int32 plan rows + n_inputs."""
        rows = (np.reshape(a, (1, -1)) for a in prog.plan()[:4])
        return (*D.check_plan(*rows, prog.ir.n_inputs), prog.ir.n_inputs)

    rng = np.random.default_rng(SEED)
    stats = {k: {"cases": 0, "mismatches": 0, "max_abs_err": 0,
                 "variants": {v: {"cases": 0, "mismatches": 0}
                              for v in CK.VARIANTS}}
             for k in CK.LAUNCHES}

    def compare(name, got, want, variant):
        if got.shape != want.shape:
            fail(f"{name}: shape {tuple(got.shape)} != plain "
                 f"{tuple(want.shape)}")
        err = int((got.long() - want.long()).abs().max().item()) \
            if got.numel() else 0
        s = stats[name]
        for d in (s, s["variants"][variant]):
            d["cases"] += 1
            d["mismatches"] += int(err != 0)
        s["max_abs_err"] = max(s["max_abs_err"], err)

    cases = [  # (n_in, G, n_out, P, W, per_individual)
        (274, 3020, 4, 1, 2048, False),
        (16, 4096, 8, 1, 2048, False),
        (8, 512, 3, 64, 2048, False),
        (32, 4096, 8, 64, 33, True),    # wide unsorted levels, P 64
        (32, 4096, 8, 64, 2048, False),
        (12, 300, 5, 17, 33, True),
        (274, 3020, 4, 4, 1, True),
        (6, 40, 3, 5, 1, False),
        (5, 0, 2, 3, 33, False),        # gateless plans
        (3, 0, 3, 2, 1, True),
        (4, 10, 2, 3, 0, False),        # W == 0
        (4, 10, 2, 3, 0, True),
        (16, 30000, 8, 2, 65, False),   # planes past shared memory
        (8, 30000, 4, 3, 1, True),
        (60000, 0, 4, 2, 1, False),
    ]
    for n_in, G, n_out, P, W, per_ind in cases:
        plan = [t(a) for a in random_population(rng, n_in, G, n_out, P)]
        shape = (P, n_in, W) if per_ind else (n_in, W)
        words = t(rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64)
                  .astype(np.uint32).view(np.int32))
        for name, fn, plain in (
                ("fused_eval_uint", CK.fused_eval_uint,
                 CS.population_eval_uint),
                ("simulate_population", CK.simulate_population,
                 CS.simulate_population)):
            variant = CK.route(P, G, W, n_in, n_out, None).variant
            compare(name, fn(*plan, words, n_in),
                    plain(*plan, words, n_in), variant)
        torch.cuda.synchronize()
    # the level kernel against the plain levels, and a raw plan's schedule
    # built on the card against the same build on the CPU
    lstats = {"cases": 0, "mismatches": 0}
    for n_in, G, P in ((32, 4096, 64), (6, 40, 5), (16, 20000, 2),
                       (5, 0, 3), (40000, 300, 3)):
        op, in0, in1, outputs = random_population(rng, n_in, G, 2, P)
        if P == 2:                            # one row a deep chain
            in0[1] = n_in + np.arange(G) - 1
            in0[1, 0] = 0
        got = CK.gate_levels(t(in0), t(in1), n_in).cpu().numpy()
        card = CK.schedule(t(op), t(in0), t(in1), n_in, device=dev)
        cpu = CK.schedule(op, in0, in1, n_in, device="cpu")
        lstats["cases"] += 1
        lstats["mismatches"] += int(
            not np.array_equal(got, CS.gate_levels(in0, in1, n_in))
            or (card.depth, card.width) != (cpu.depth, cpu.width)
            or not torch.equal(card.program.cpu(), cpu.program)
            or not torch.equal(card.rank.cpu(), cpu.rank))
    # the schedule's host time for a raw population, built per call on the
    # card by the two schedule kernels
    raw = random_population(rng, 32, 4096, 8, 64)
    raw_t = [t(a) for a in raw]
    builds = [CK.schedule(*raw_t[:3], 32, device=dev) for _ in range(7)]
    raw_sched = builds[-1]
    say("schedule", gate_levels=lstats,
        schedule_launches=dict(CK.SCHEDULE_LAUNCHES), raw_population={
        "P": 64, "G": 4096, "depth": raw_sched.depth,
        "width": raw_sched.width,
        "schedule_host_ms": float(np.median([b.build_ms for b in builds])),
        "gate_levels_ms": gpu_ms(
            lambda: CK.gate_levels(raw_t[1], raw_t[2], 32), TIMED_REPS,
            True)})
    if lstats["mismatches"]:
        fail(f"gate_levels: {lstats['mismatches']} of {lstats['cases']} "
             "cases differ from the plain levels or the CPU schedule")

    rows = load_manifest(EMIT_DIR)
    progs = {r["name"]: load_program(EMIT_DIR / r["program"], device=dev,
                                     expect_sha256=r["sha256"])
             for r in rows}
    golden = {n: np.load(GOLDEN_DIR / f"{n}.npz") for n in progs}
    for S_extra in (0, 2048, 65536):
        words_list = []
        for i, (name, prog) in enumerate(progs.items()):
            x = golden[name]["x"]
            if S_extra:
                reps = -(-(S_extra + 96 * i) // x.shape[0])
                x = np.tile(x, (reps, 1))[: S_extra + 96 * i]
            words_list.append(prog.pack_input_bits(prog.binarize(x)))
        checked = [checked_plan(prog) for prog in progs.values()]
        got = CK.fleet_eval_words(checked, words_list)
        fleet = CK.fleet_plan(checked, dev)
        words_t, W_list = fleet.pad_words(words_list)
        want = CS.population_eval_uint(*fleet[:4], words_t, fleet.n_in_max)
        variant = CK.route(*fleet.op.shape, max(W_list), fleet.n_in_max,
                           fleet.outputs.shape[1], fleet.schedule).variant
        for tenant, w_t in enumerate(W_list):
            compare("fleet_eval_words", got[tenant],
                    want[tenant, : w_t * 32], variant)
    # the golden programs through each walk: their own schedules, and with
    # dead gates appended past shared memory
    for name, prog in progs.items():
        ir = prog.ir
        x = np.tile(golden[name]["x"], (24, 1))
        words = prog.pack_input_bits(prog.binarize(x))
        base = checked_plan(prog)[:4]
        dead = np.zeros((1, 30000), np.int32)      # BUF gates reading node 0
        plans = {"shared_plane": [t(a) for a in base], "global_scratch": [
            t(np.concatenate([a, dead + fill], axis=1))
            for a, fill in zip(base[:3], (3, 0, 0))] + [t(base[3])]}
        for variant, plan in plans.items():
            sched = prog.schedule if variant == "shared_plane" else None
            routed = CK.route(1, plan[0].shape[1], words.shape[1],
                              ir.n_inputs, ir.n_outputs, sched).variant
            if routed != variant:
                fail(f"{ir.name}: routed {routed}, expected {variant}")
            compare("fused_eval_uint",
                    CK.fused_eval_uint(*plan, words, ir.n_inputs,
                                       schedule=sched),
                    CS.population_eval_uint(*plan, words, ir.n_inputs),
                    variant)
    torch.cuda.synchronize()

    tstats = ternary_vs_plain(dev, rng)
    pstats = popcount_vs_plain(dev, rng)
    wstats = wkv_vs_plain(dev, rng)
    bstats = wkv_bwd_vs_plain(dev, rng)
    say("kernel_vs_plain", kernels=stats, ternary_matmul=tstats,
        packed_popcount=pstats, rwkv6_scan=wstats, rwkv6_scan_bwd=bstats)
    for name, s in stats.items():
        if s["mismatches"]:
            fail(f"{name}: {s['mismatches']} of {s['cases']} cases differ "
                 f"from the plain version (max abs err {s['max_abs_err']})")
    for variant in CK.VARIANTS:
        if not stats["fused_eval_uint"]["variants"][variant]["cases"]:
            fail(f"kernel_vs_plain ran no case through {variant}")
    for dt, s in tstats.items():
        if s["mismatches"] or s["plain_mismatches"]:
            fail(f"ternary_matmul {dt}: {s['mismatches']} kernel and "
                 f"{s['plain_mismatches']} plain cases of {s['cases']} leave "
                 f"the f32 envelope (largest err/envelope "
                 f"{s['max_err_over_envelope']:.3f})")
        if s["not_bit_identical"]:
            fail(f"ternary_matmul {dt}: {s['not_bit_identical']} cases differ "
                 f"between two launches ({s['variants']})")
    if pstats["mismatches"]:
        fail(f"packed_popcount: {pstats['mismatches']} of {pstats['cases']} "
             "cases differ from the plain version")
    if wstats["mismatches"] or wstats["plain_mismatches"]:
        fail(f"rwkv6_scan: {wstats['mismatches']} kernel and "
             f"{wstats['plain_mismatches']} plain cases of {wstats['cases']} "
             f"leave the f32 envelope (largest err/envelope "
             f"{wstats['max_err_over_envelope']:.3f})")
    if wstats["split_max_abs_diff"]:
        fail(f"rwkv6_scan: a split run differs from one pass by "
             f"{wstats['split_max_abs_diff']:.3g}")
    if wstats["in_place_not_bit_identical"]:
        fail(f"rwkv6_scan: {wstats['in_place_not_bit_identical']} states "
             "written in place differ from the run out of place")
    if bstats["mismatches"] or bstats["plain_mismatches"]:
        fail(f"rwkv6_scan_bwd: {bstats['mismatches']} kernel and "
             f"{bstats['plain_mismatches']} plain cases of {bstats['cases']} "
             f"leave the f32 envelope (largest err/envelope "
             f"{bstats['max_err_over_envelope']:.3f})")
    if bstats["not_bit_identical"]:
        fail(f"rwkv6_scan_bwd: {bstats['not_bit_identical']} cases differ "
             "between two launches")
    if bstats["autograd_launches"] != {"rwkv6_scan": 1,
                                       "rwkv6_scan_bwd": 1} or \
            not bstats["autograd_equals_kernel"]:
        fail(f"rwkv6_scan under autograd launched "
             f"{bstats['autograd_launches']} (one forward and one backward "
             "expected) or its gradients differ from the backward kernel's")
    for name, counts in (("rwkv6_scan", wstats["designs"]),
                         ("packed_popcount", pstats["designs"]),
                         ("packed_popcount loads", {
                             k: pstats[k] for k in ("vec16", "word_loads")})):
        for design, n in counts.items():
            if not n:
                fail(f"kernel_vs_plain ran no {name} case through {design}")

    # -- 4. main path, counted ----------------------------------------------
    CK.reset_launches()
    schedule_ms = {}
    for r in rows:
        prog = load_program(EMIT_DIR / r["program"], device="cuda",
                            expect_sha256=r["sha256"])
        progs[r["name"]] = prog
        schedule_ms[r["name"]] = prog.schedule.build_ms
        fix = golden[r["name"]]
        labels = prog.predict(fix["x"])
        if not np.array_equal(labels, fix["labels"]):
            fail(f"{r['name']}: labels differ from tests/golden")
        xbin = prog.binarize(fix["x"])
        got = prog.scores(xbin)
        tap = np.asarray(prog.ir.taps["score"], np.int32)
        plan = [t(a) for a in checked_plan(prog)[:3]] + [t(tap.reshape(1, -1))]
        outw = CS.simulate_population(*plan, prog.pack_input_bits(xbin),
                                      prog.ir.n_inputs)
        want = CS.decode_words(outw.reshape(*tap.shape, -1))
        want = want[:, : xbin.shape[0]].T.cpu().numpy()
        if not np.array_equal(got, want):
            fail(f"{r['name']}: scores differ from the plain version")
    say("golden", tenants=sorted(progs), readings_each=96,
        labels_equal=True, scores_equal_plain=True)

    arr = progs["arrhythmia"]
    thr = arr.thresholds.astype(np.float32)
    x_stream = (thr[None, :] + rng.standard_normal(
        (262_144, thr.shape[0]), dtype=np.float32)
        * np.maximum(np.abs(thr), 1.0)[None, :])
    big = CircuitServingEngine(arr, max_batch=65536)
    big.warmup()
    labels = big.classify_stream(x_stream)
    words = arr.pack_input_bits(arr.binarize(x_stream))
    plan_arr = [t(a) for a in checked_plan(arr)[:4]]
    want = CS.population_eval_uint(*plan_arr, words, arr.ir.n_inputs)[0]
    want = want[: x_stream.shape[0]].cpu().numpy()
    if not np.array_equal(labels, want):
        fail("arrhythmia classify_stream differs from the plain version")
    small = CircuitServingEngine(arr, max_batch=1024)
    small.warmup()
    reqs = [small.submit(row) for row in x_stream[:512]]
    done = small.flush()
    if [r.uid for r in done] != list(range(512)) or \
            [r.label for r in reqs] != [int(v) for v in want[:512]]:
        fail("submit/flush labels differ from the plain version")
    say("serving", tenant="arrhythmia", stream=big.stats.summary(),
        submit_flush=small.stats.summary())

    engines = {n: CircuitServingEngine(p, max_batch=1024)
               for n, p in progs.items()}
    packed = [engines[n].prepare_packed_batch(golden[n]["x"]) for n in progs]
    fused = D.fleet_eval_words([progs[n].plan() for n in progs],
                               [w for w, _ in packed], device="cuda")
    for n, (_, B), lab in zip(progs, packed, fused):
        if not np.array_equal(lab[:B], golden[n]["labels"]):
            fail(f"{n}: fleet_eval_words labels differ from tests/golden")
    launches = dict(CK.LAUNCHES)
    by_variant = dict(CK.VARIANT_LAUNCHES)
    say("main_path", launches=launches, launches_by_variant=by_variant,
        schedule_launches=dict(CK.SCHEDULE_LAUNCHES),
        fleet_tenants=len(progs), fleet_labels_equal=True,
        program_schedule_host_ms=schedule_ms)
    for name, n in launches.items():
        if n <= 0:
            fail(f"the main path never launched {name}")
    if by_variant["shared_plane"] != sum(launches.values()):
        fail(f"main path: launches by variant {by_variant}, expected every "
             f"one of {sum(launches.values())} through shared_plane")

    # per-reading packing: the readings' bits as rows of 9 words
    fire = arr.binarize(x_stream[:65536])
    reading_words = CS.pack_bits32(fire.T.contiguous())
    CP.reset_launches()
    counts = ops.packed_popcount(reading_words)
    pop_launches = CP.LAUNCHES["packed_popcount"]
    pop_by_design = dict(CP.DESIGN_LAUNCHES)
    want = fire.sum(dim=1, dtype=torch.int32)
    say("popcount_path", readings=int(fire.shape[0]),
        words_per_reading=int(reading_words.shape[1]),
        launches=pop_launches, launches_by_design=pop_by_design,
        counts_equal=bool(torch.equal(counts, want)),
        mean_firing=float(want.float().mean()))
    if not torch.equal(counts, want):
        fail("popcount_path: counts differ from the 0/1 matrix")
    if pop_launches <= 0:
        fail("the popcount path never launched packed_popcount")

    # -- 4b. the paper's Phases 1-3, counted; card against CPU -------------
    camp, camp_prob, camp_res = campaign_phase(dev, smi)

    # -- 4c. the pipeline from sensor floats to served labels, counted ------
    pipe = pipeline_phase(dev, smi, camp_prob, camp_res)

    # -- 4d. the MLP baselines on the card; 4e. the fleet, counted ----------
    baselines_phase(dev, smi)
    fleet_out = fleet_phase(dev, smi)
    fleet_launches = {m: {k: r["launches"][k] for k in
                          ("fused_eval_uint", "fleet_eval_words")}
                      for m, r in fleet_out["modes"].items()}

    # -- 4f. the campaign layer: campaigns, checkpoints, workers, the zoo
    # and the autopilot, counted; card against CPU -------------------------
    evo = evolve_phase(dev, smi, camp_prob)

    # -- 4g. the paper's tables and figures through the port's harness,
    # counted; card against CPU -------------------------------------------
    paper = paper_phase(dev, smi)

    # -- 5, 6. LM serving at full width, counted; card against CPU -------
    tm_launches = lm_phases(dev, get_config("llama3.2-1b").replace(
        quant="ternary_packed"))
    # -- 5b. the reference's other LM families at full width, counted ------
    families = lm_families_phase(dev)
    rwkv = rwkv_phases(dev, get_config("rwkv6-7b"))
    # -- 5c. LM training on the card, counted; card against CPU ------------
    train = training_phase(dev, smi)
    # -- 5d. the step roofline of those cells, traced on meta, against the
    # card ------------------------------------------------------------------
    roofline_phase(dev, smi, train, roofline_clis)

    # -- 7. timing ----------------------------------------------------------
    mhz = max_sm_clock_mhz()
    # the least a timed launch can read: an empty kernel, timed the same way
    launch_floor_ms = gpu_ms(lambda: torch.cuda._sleep(0), TIMED_REPS, True)
    say("launch_floor", ms=launch_floor_ms, max_sm_clock_mhz=mhz)
    timings = []
    for name in ("arrhythmia", "cardio"):
        prog = progs[name]
        n_in, G, n_out = prog.ir.n_inputs, prog.ir.n_gates, prog.ir.n_outputs
        plan = [t(a) for a in checked_plan(prog)[:4]]
        tap = np.asarray(prog.ir.taps["score"], np.int32).reshape(1, -1)
        tap_plan = plan[:3] + [t(tap)]
        for batch in (1024, 65536):
            x = x_stream[:batch] if name == "arrhythmia" else np.tile(
                golden[name]["x"], (-(-batch // 96), 1))[:batch]
            words = prog.pack_input_bits(prog.binarize(x))
            W = words.shape[1]
            sched = prog.schedule
            route = CK.route(1, G, W, n_in, n_out, sched)
            tap_route = CK.route(1, G, W, n_in, tap.shape[1], sched)
            row = {"tenant": name, "readings": batch, "W": W, "G": G,
                   "n_in": n_in, "depth": prog.ir.depth,
                   "variant": route.variant,
                   "columns_per_block": route.columns,
                   "simulate_columns_per_block": tap_route.columns,
                   "dynamic_smem_bytes": route.smem_bytes,
                   "schedule_host_ms": sched.build_ms,
                   "chain_bound_ms": chain_bound_ms(prog.ir.depth, mhz),
                   "launch_floor_ms": launch_floor_ms}
            row["fused_ms"] = gpu_ms(
                lambda: CK.fused_eval_uint(*plan, words, n_in,
                                           schedule=sched), TIMED_REPS,
                True)
            row["fused_plain_ms"] = gpu_ms(
                lambda: CS.population_eval_uint(*plan, words, n_in),
                PLAIN_REPS, False)
            row["fused_bound_ms"], row["fused_bound_by"] = bound_ms(
                [(n_in, G, n_out, W)], True)
            row["simulate_ms"] = gpu_ms(
                lambda: CK.simulate_population(*tap_plan, words, n_in,
                                               schedule=sched),
                TIMED_REPS, True)
            row["simulate_plain_ms"] = gpu_ms(
                lambda: CS.simulate_population(*tap_plan, words, n_in),
                PLAIN_REPS, False)
            row["simulate_bound_ms"], row["simulate_bound_by"] = bound_ms(
                [(n_in, G, tap.shape[1], W)], False)
            eng = CircuitServingEngine(prog, max_batch=batch)
            eng.warmup()
            for _ in range(TIMED_REPS):
                eng.classify_batch(x)
            row["engine_dispatch_p50_ms"] = eng.stats.percentile_ms(50)
            timings.append(row)
            say("timing", **row)

    fleet_rows = []
    for batch in (1024, 65536):
        plans, words_list, words_np = [], [], []
        for name, prog in progs.items():
            x = np.tile(golden[name]["x"], (-(-batch // 96), 1))[:batch]
            plans.append(checked_plan(prog))
            words_list.append(prog.pack_input_bits(prog.binarize(x)))
            words_np.append(words_list[-1].cpu().numpy().view(np.uint32))
        t0 = time.perf_counter()
        fleet = CK.pad_plans(plans, dev)
        pad_ms = (time.perf_counter() - t0) * 1e3
        words_t, W_list = fleet.pad_words(words_list)
        T, G_pad = fleet.op.shape
        n_in_max, W_max = fleet.n_in_max, max(W_list)
        route = CK.route(T, G_pad, W_max, n_in_max, fleet.outputs.shape[1],
                         fleet.schedule)
        row = {"tenants": T, "readings_each": batch, "W": W_max,
               "G_padded": G_pad, "n_in_padded": n_in_max,
               "depth": fleet.schedule.depth, "variant": route.variant,
               "columns_per_block": route.columns,
               "dynamic_smem_bytes": route.smem_bytes,
               "schedule_host_ms": fleet.schedule.build_ms,
               "padding_host_ms": pad_ms,
               "chain_bound_ms": chain_bound_ms(fleet.schedule.depth, mhz),
               "launch_floor_ms": launch_floor_ms}
        # the wrapper as a caller runs it (the span the parent timed): the
        # padded plans from the cache, the words padded, one launch
        row["fleet_ms"] = gpu_ms(
            lambda: CK.fleet_eval_words(plans, words_list), TIMED_REPS, True)
        # the launch alone, on word planes padded beforehand
        row["fleet_kernel_ms"] = gpu_ms(
            lambda: CK.fused_eval_uint(*fleet[:4], words_t, n_in_max,
                                       schedule=fleet.schedule),
            TIMED_REPS, True)
        row["fleet_plain_ms"] = gpu_ms(
            lambda: CS.population_eval_uint(*fleet[:4], words_t, n_in_max),
            PLAIN_REPS, False)
        # the serving dispatch end to end on the host's clock: numpy word
        # planes in, labels on the host
        walls = []
        for _ in range(TIMED_REPS):
            t0 = time.perf_counter()
            D.fleet_eval_words(plans, words_np, device=dev)
            walls.append((time.perf_counter() - t0) * 1e3)
        row["dispatch_p50_ms"] = float(np.median(walls))
        row["fleet_bound_ms"], row["fleet_bound_by"] = bound_ms(
            [(p[4], p[0].shape[1], p[3].shape[1], w.shape[1])
             for p, w in zip(plans, words_list)], True)
        fleet_rows.append(row)
        say("timing_fleet", **row)

    tm_rows = ternary_timing(dev)
    wkv_rows, pop_rows = rwkv_popcount_timing(rwkv, {
        "arrhythmia readings": reading_words,
        "random": torch.randint(-2 ** 31, 2 ** 31 - 1, (65536, 32),
                                dtype=torch.int32, device=dev),
        "random, large": torch.randint(-2 ** 31, 2 ** 31 - 1, (4194304, 9),
                                       dtype=torch.int32, device=dev)},
        launch_floor_ms)

    # -- 8. summary -----------------------------------------------------------
    main_row = next(r for r in timings
                    if r["tenant"] == "arrhythmia" and r["readings"] == 65536)
    tm_main, tm_prefill = (next(r for r in tm_rows
                                if (r["M"], r["K"], r["N"]) == (M, 2048, 8192))
                           for M in (8, 768))
    src = "src/repro_torch/kernels/csrc/circuit_sim.cu"
    kernels = [
        {"name": "fused_eval_uint", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/pallas_circuit_sim.py:183",
         "launches": launches["fused_eval_uint"],
         "max_abs_err": stats["fused_eval_uint"]["max_abs_err"],
         "ms": main_row["fused_ms"], "plain_ms": main_row["fused_plain_ms"],
         "bound_ms": main_row["fused_bound_ms"],
         "bound_by": main_row["fused_bound_by"], "library_ms": None,
         "variant": main_row["variant"],
         "columns_per_block": main_row["columns_per_block"],
         "chain_bound_ms": main_row["chain_bound_ms"],
         "launches_by_variant": by_variant,
         "campaign": {
             "launches": {k: v["launches"]["fused_eval_uint"]
                          for k, v in camp["counts"].items()},
             "launches_by_variant": camp["counts"]["phase3"]["by_variant"],
             "schedule_launches":
                 camp["counts"]["phase3"]["schedule_launches"],
             "objective": {k: camp["objective_launch"][k] for k in (
                 "rows", "W", "kernel_ms", "plain_ms", "bound_ms",
                 "bound_by", "call_p50_ms", "individuals_per_s",
                 "kernel_share")},
             "cgp_children": {k: camp["cgp_launch"][k] for k in (
                 "n", "P", "G", "W", "kernel_ms", "plain_ms", "bound_ms",
                 "bound_by", "fitness_call_p50_ms")},
             "note": "launches are cumulative from the campaign's zeroed "
                     "counts at the end of each phase"},
         "pipeline": {"launches": pipe["launches"]["fused_eval_uint"],
                      "launches_by_variant": pipe["launches_by_variant"]},
         "evolve": {
             "launches": evo["campaign"]["launches"]["fused_eval_uint"],
             "launches_by_variant": evo["campaign"]["launches_by_variant"],
             "launches_per_epoch": [e["launches"] for e in
                                    evo["campaign"]["per_epoch"]],
             "objective": {k: evo["campaign"]["objective_launch"][k]
                           for k in ("rows", "W", "depth", "kernel_ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "ops_bound_ms", "chain_bound_ms")}},
         "paper": {"launches": paper["launches"]["fused_eval_uint"],
                   "launches_by_variant": paper["launches_by_variant"],
                   "benches": list(paper["rows"])},
         "fleet": {"launches": {m: v["fused_eval_uint"]
                                for m, v in fleet_launches.items()},
                   "worker_launches": [
                       w["launches"]["fused_eval_uint"] for w in
                       fleet_out["modes"]["workers_2"]["worker_launches"]],
                   "at_fleet_shape": {n: {k: r[k] for k in (
                       "W", "ms", "plain_ms", "bound_ms", "bound_by",
                       "variant")} for n, r in
                       fleet_out["at_fleet_shape"].items()}},
         "cases": stats["fused_eval_uint"]["cases"],
         "mismatches": stats["fused_eval_uint"]["mismatches"],
         "shape": "arrhythmia, 65536 readings"},
        {"name": "simulate_population", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/pallas_circuit_sim.py:78",
         "launches": launches["simulate_population"],
         "max_abs_err": stats["simulate_population"]["max_abs_err"],
         "ms": main_row["simulate_ms"],
         "plain_ms": main_row["simulate_plain_ms"],
         "bound_ms": main_row["simulate_bound_ms"],
         "bound_by": main_row["simulate_bound_by"], "library_ms": None,
         "variant": main_row["variant"],
         "columns_per_block": main_row["simulate_columns_per_block"],
         "chain_bound_ms": main_row["chain_bound_ms"],
         "pipeline": {"launches": pipe["launches"]["simulate_population"]},
         "cases": stats["simulate_population"]["cases"],
         "mismatches": stats["simulate_population"]["mismatches"],
         "shape": "arrhythmia score taps, 65536 readings"},
        {"name": "fleet_eval_words", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/pallas_circuit_sim.py:322",
         "launches": launches["fleet_eval_words"],
         "max_abs_err": stats["fleet_eval_words"]["max_abs_err"],
         "ms": fleet_rows[1]["fleet_ms"],
         "plain_ms": fleet_rows[1]["fleet_plain_ms"],
         "bound_ms": fleet_rows[1]["fleet_bound_ms"],
         "bound_by": fleet_rows[1]["fleet_bound_by"], "library_ms": None,
         "variant": fleet_rows[1]["variant"],
         "columns_per_block": fleet_rows[1]["columns_per_block"],
         "chain_bound_ms": fleet_rows[1]["chain_bound_ms"],
         "kernel_only_ms": fleet_rows[1]["fleet_kernel_ms"],
         "fleet": {"launches": fleet_launches["megakernel"][
                       "fleet_eval_words"],
                   "megakernel_peak_tenants": fleet_out["modes"][
                       "megakernel"]["megakernel_peak_tenants"],
                   "zoo_launches": evo["zoo"]["launches"][
                       "fleet_eval_words"],
                   "at_fleet_shape": fleet_out[
                       "fleet_eval_words_at_fleet_shape"]},
         "cases": stats["fleet_eval_words"]["cases"],
         "mismatches": stats["fleet_eval_words"]["mismatches"],
         "shape": "five golden tenants, 65536 readings each"},
        {"name": "ternary_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ternary_matmul.cu",
         "replaces": "src/repro/kernels/ternary_matmul.py:34",
         "launches": tm_launches["launches"],
         "launches_by_variant": tm_launches["by_variant"],
         "max_abs_err": max(max(s["max_abs_err"] for s in tstats.values()),
                            families["ternary_max_abs_err"]),
         "ms": tm_main["ms"], "plain_ms": tm_main["plain_ms"],
         "bound_ms": tm_main["bound_ms"], "bound_by": tm_main["bound_by"],
         "library_ms": tm_main["library_ms"],
         "cases": sum(s["cases"] for s in tstats.values()),
         "mismatches": sum(s["mismatches"] for s in tstats.values()),
         "shape": "decode w_gate: M 8, K 2048, N 8192, bf16, split_k",
         "prefill": {k: tm_prefill[k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "variant", "splits", "tile")}
         | {"shape": "prefill w_gate: M 768, K 2048, N 8192, bf16"},
         "lm_families": {
             "launches": families["launches"],
             "launches_by_variant": families["by_variant"],
             "shapes": [[r[k] for k in FAMILY_SHAPE_FIELDS]
                        for r in families["ternary"]],
             "shape_fields": list(FAMILY_SHAPE_FIELDS)}},
        {"name": "packed_popcount", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/packed_popcount.cu",
         "replaces": "src/repro/kernels/packed_popcount.py:16",
         "launches": pop_launches, "launches_by_design": pop_by_design,
         "max_abs_err": pstats["max_abs_err"],
         "ms": pop_rows[0]["ms"], "plain_ms": pop_rows[0]["plain_ms"],
         "bound_ms": pop_rows[0]["bound_ms"],
         "bound_by": pop_rows[0]["bound_by"], "library_ms": None,
         "launch_floor_ms": launch_floor_ms, "cases": pstats["cases"],
         "mismatches": pstats["mismatches"],
         "design": "rows: a thread a row over a run of 128 rows staged "
                   "transposed in shared memory (W <= 64); warp: a warp a "
                   "row (W > 64); 16-byte loads from 16-byte-aligned planes",
         "shape": "65536 readings x 9 words",
         "large": {k: pop_rows[2][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "design")} | {"shape": "4194304 x 9 random words"}},
        {"name": "rwkv6_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
         "replaces": "src/repro/kernels/rwkv6_scan.py:34",
         "launches": rwkv["launches"],
         "launches_by_design": rwkv["by_design"],
         "max_abs_err": max(wstats["max_abs_err"],
                            rwkv["model_stats"]["max_abs_err"]),
         "ms": wkv_rows[0]["ms"], "plain_ms": wkv_rows[0]["plain_ms"],
         "bound_ms": wkv_rows[0]["bound_ms"],
         "bound_by": wkv_rows[0]["bound_by"], "library_ms": None,
         "launch_floor_ms": launch_floor_ms,
         "cases": wstats["cases"] + rwkv["model_stats"]["cases"],
         "mismatches": wstats["mismatches"]
         + rwkv["model_stats"]["mismatches"],
         "design": "a block a (b, h) row; an 8 x 8 tile of the state a "
                   "thread; 8-token chunks in a 3-stage cp.async ring; "
                   "partial sums added in a fixed order after each chunk",
         "shape": "rwkv6-7b prefill: BH 512, T 96, dh 64, (BH, T, dh) f32",
         "decode": {k: wkv_rows[1][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "design")} | {"shape": "decode: T 1 from a state, "
                                    "(BH, T, dh) f32"},
         "model_layout": {k: wkv_rows[2][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "design")} | {"shape": "prefill: (8, 96, 64, 64) bf16 views, "
                                    "u (64, 64)"},
         "model_layout_decode": {k: wkv_rows[3][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "design")} | {"shape": "decode: (8, 1, 64, 64) bf16 views, "
                                    "state in place"}},
        {"name": "rwkv6_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
         "replaces": "src/repro/kernels/rwkv6_scan.py:34",
         "note": "the gradient of row 6: the reference has no backward "
                 "Pallas kernel and differentiates the recurrence's "
                 "lax.scan (src/repro/models/ssm.py:163)",
         "launches": train["rwkv"]["launches"]["rwkv6_scan_bwd"],
         "forward_launches_with_checkpoints":
             train["rwkv"]["launches"]["rwkv6_scan"],
         "max_abs_err": bstats["max_abs_err"],
         "ms": train["bwd_timing"]["ms"],
         "plain_ms": train["bwd_timing"]["plain_ms"],
         "bound_ms": train["bwd_timing"]["bound_ms"],
         "bound_by": train["bwd_timing"]["bound_by"], "library_ms": None,
         "cases": bstats["cases"], "mismatches": bstats["mismatches"],
         "design": "a block a (b, h) row; the gradient of the state an R x C "
                   "tile a thread in registers; 16-token chunks recomputed "
                   "forward from the forward's checkpoints into a per-row "
                   "scratch, then walked in reverse; row sums by an xor "
                   "butterfly, dv and du in a fixed order, no atomics",
         "shape": "rwkv6-7b training microbatch: (2, 256, 64, 64) bf16, "
                  "u (64, 64)"},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
