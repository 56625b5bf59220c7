#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero, printing no result:

1. device - a CUDA card is present; its name and power limit.
2. build - the Hopper kernels built from csrc/ with nvcc (seconds,
   registers and spills per kernel).
3. kernel_check - K1 (forward), K2 (dK/dV), K3 (dQ) against their plain
   PyTorch versions in bf16 on the card, with and without the
   key-padding mask, causal and not, at (b=4, h=12, d=64) and (b=4,
   h=6, d=128), each at seq 512 and at the ragged seq 333 (a last tile
   that TMA zero-fills); at every shape also the common-part case (v =
   4 + 0.05 noise): dq, dk, dv within 1% of the f32 gradients.
4. kernel_times - at one BERT-base layer's shape, each kernel against
   its plain version once more, then the median ms (and TFLOP/s) of each
   kernel, its plain version and F.scaled_dot_product_attention, with
   the bound computed from those inputs.
5. train - BERT-base MLM at full width (12 x 768, 12 x 64 heads, vocab
   30522, seq 512, batch 32, AdamW wd 0.01, --flash --packed) through
   the CLI's run(); launch counters must equal 12 per forward (K1) and
   per backward (K2, K3) pass. 5 timed steps after the warm-up: the CLIs'
   --steps is the total budget, the warm-up included. train_plain: the same run on the plain
   attention path.
6. profile - device time of two flash training steps by kernel and by
   kind of kernel.
7. plain_parity - one Trainer.step from the same seed through the flash
   kernels, the plain bf16 path and an f32 plain path, packed and
   unpacked (the unpacked one runs the in-kernel mask path inside the
   model): losses and gradients within the stated tolerances.
8. gpt_kernel_check, gpt_kernel_times - kernel_check's and
   kernel_times' work for K1-K3 with the causal mask at one GPT-small
   layer's shape (4, 4096, 6, 128), each output's worst error with its
   position, then each output held against the f32 plain version one
   (batch, row, head) slice at a time (relative L2 within 2^-5) and as a
   whole (within 1%); SDPA with is_causal=True beside them; the work
   counts the s(s+1)/2 pairs a causal row set keeps.
9. gpt_train - GPT-small (12 x 768, 6 x 128 heads, vocab 32000, seq
   4096, batch 4, AdamW 3e-4 wd 0.01, causal flash) through train/gpt.py,
   then greedy generate of 56 tokens from each row's first 8; launch
   counters must equal 12 per forward (K1) and per backward (K2, K3)
   pass, and the loss must fall.
10. gpt_generate - on that model: teacher-forced GPTDecodeStep logits
   against the training forward's (f32 views, atol/rtol 1e-3), and the
   prefill chain equal to the all-stepwise chain (f32); both reported in
   bf16 too; a profile of 8 decode steps (kernels launched per token,
   device busy share). gpt_train_plain: gpt_train on plain causal
   attention. gpt_profile: as profile, for GPT-small. gpt_host_batch:
   the host's ms to draw one 4 x 4096 batch and to place it on the idle
   card, beside the time gpt_train's loop spent drawing.
11. gpt_parity - plain_parity's criterion for one GPT-small step at
   batch 1, seq 4096.
12. conv_check - K4 (forward), K4 as dx (flipped, transposed kernel) and
   K5 (dW) against their plain versions in bf16 on the card, at the
   four ResNet-50 stage shapes with N=8, at two C != Cout shapes and at
   three ragged ones (H*W = 81, not a multiple of 16; K4 boxes that pad
   N and W).
13. conv_times - at each stage shape at N=256 (the bench's batch), each
   kernel against its plain version once more, then the median ms of
   each kernel, its plain version and the cuDNN call that computes the
   same function (F.conv2d for the forward and for dx on the flipped,
   transposed kernel, torch.nn.grad.conv2d_weight for dW; dx's
   torch.nn.grad.conv2d_input beside it), with the bound computed from
   those inputs; K4's plan (pixel box, tile width) and the L2 request
   rate its plan implies (modelled bytes over measured time).
14. resnet_train - ResNet-50 (stage sizes 3, 4, 6, 3, width 64, 1000
   classes, 224x224, bf16, batch 256, SGD 0.1 momentum 0.9,
   --conv3-impl pallas) through the CLI's run(); launch counters must
   equal 13 K4 launches per forward and per backward pass and 13 K5
   launches per backward pass. resnet_train_xla: the same run with
   --conv3-impl xla (cuDNN for every conv).
15. resnet_profile - device time of two ResNet-50 steps by kernel and by
   kind of kernel, pallas and xla.
16. resnet_parity - one Trainer.step from the same weights and batch
   (N=32, 224x224) through K4/K5, the torch conv in bf16, and the torch
   conv in f32 with TF32 off: losses, gradients and BN running
   statistics within the stated tolerances, then one evaluate.
17. lifecycle - GPT-small at GPT_SHAPE through train/gpt.py with
   --checkpoint-dir, --accum-steps 2 and a 6-step budget: a real SIGTERM
   after step 3 gives exit code 143 and a checkpoint at step 3; the
   restored tensors are bit-equal to the in-memory ones, and one step
   from each on one batch agrees (relative L2 within 1e-6; bit-equal
   reported); the rerun resumes at 3 and exits 0 at step 6. K1 launches
   12 per microbatch forward, K2 and K3 12 per microbatch backward.
   Reported: save (blocking and async) and restore ms, checkpoint bytes,
   one step's peak memory at k = 1 and k = 2, the k = 2 gradient against
   k = 1's (worst relative L2 within 1e-2), and tokens/s and ms per step
   through InputPipeline beside gpt_train's and PR 6's 85.60 ms.
18. run_steps - BERT-base (--flash --packed, 32 x 512) and ResNet-50
   (pallas, batch 256) with a warm-up-cosine schedule: run_steps(n=3)
   (a CUDA graph of the step, replayed) against 3 eager steps from the
   same seed on the same batch; per-step losses (3 run_steps(n=1) calls)
   within 1e-3 relative, each parameter (and BN statistic) within 1e-4
   relative L2, bit-equality reported; kernel launches per replay K1-K3
   12/12/12 and K4/K5 26/13; ms per step, rate and device busy share,
   eager and graph.
19. mnist - train/mnist.py, 1000 steps at batch 512, --target-accuracy
   0.99, --checkpoint-dir: exit code 0, held-out accuracy >= 0.99.
20. eval_loop - the Evaluator replica in its own process over those
   checkpoints while they are written, --until-step 1000: one JSON line
   per step evaluated, the last at step 1000.
21. profile_dir - train/bert.py --profile-dir writes a Chrome trace that
   names K1-K3.
22. rendezvous - testing/rendezvous_worker.py, then train/smoke.py (each
   one's main(), in one launch of two processes), as two ranks on cuda:0
   over gloo (NCCL refuses two ranks on one device), the
   operator's env names set by hand (TPU_WORKER_ID, TPU_WORKER_HOSTNAMES,
   JAX_NUM_PROCESSES, JAX_PROCESS_ID, TFJOB_COORDINATOR_OVERRIDE): ranks
   and world size as injected, an all-gather on the card gives [0, 1],
   the smoke's all-reduce gives 3.
23. ddp_bert - BERT-base MLM (--flash --packed, 32 x 512 global) from one
   seed: the one-process step; the same step through Trainer(mesh=...)
   under DDP in a one-rank NCCL world, bit-equal, and its ms per step
   beside the one process's (DDP's cost at one rank); a world of 2 ranks
   over gloo on the card, 16 rows a rank: loss and every gradient against
   the one process's (DIST_TOLERANCE_WHY), K1-K3 12 launches per pass
   per rank, ms per step labelled as two ranks sharing one card.
24. fsdp_gpt - GPT-small (4 x 4096, causal flash) under FSDP2
   (TRANSFORMER_RULES): a world of 2 over gloo (fsdp=2, 2 rows a rank)
   and a one-rank NCCL world, each against 2 one-process steps (losses,
   step 1's gradient within FSDP_GRAD_RTOL at world 2, the parameters
   after 2 steps); K1-K3 12 per pass; a checkpoint saved under FSDP2
   restores bit-equal into a one-process trainer.
25. syncbn_resnet - ResNet-50 (pallas, batch 256 global, 224^2, bf16)
   under DDP with sync TpuBatchNorm at world 2 over gloo (128 a rank,
   rank 1's images from another distribution): loss, every gradient and
   BN running statistic against the one-process step (plain_parity's
   ratio to f32; BN statistics directly); the same world-2 step in f32
   against the one-process f32 step (every conv gradient and BN
   statistic), and two f32 controls, BN not synced and sums all-reduced
   without a gradient, that must fail those bounds; K4 26 and K5 13
   launches per step per rank.
26. tp_gpt - GPT-small (2 x 4096, causal flash) under TRANSFORMER_RULES'
   Megatron plan at tp = 2: phases 23-25's world of 2 over gloo on the
   card, after them (3 heads of 128, 16000 vocab rows a rank) against the
   one-process step on the
   same weights and batch: the loss, and each rank's gradient shard by
   plain_parity's ratio to the f32 step (DIST_TOLERANCE_WHY); the same
   step in f32 (TF32 off, plain attention, remat) against the one
   process's f32 step (MP_F32_GRAD_RTOL); K1-K3 12 launches per pass
   per rank, ms per step labelled as ranks sharing one card. In the same
   world: ViT-B/16 (batch 32) at tp = 2, its loss against one process's,
   and generate(mesh=) of 16 greedy tokens at f32, the chain equal to
   the one process's.
27. sp_gpt - the same GPT-small step at sp = 2 (2048 positions a rank),
   ring attention and then Ulysses (flash inside), each against the
   one-process step (loss; every gradient by plain_parity's ratio);
   K1-K3 0 launches under the ring, 12 per pass per rank under Ulysses
   (3 heads at the full 4096).
28. tp_sp_cli - a world of 4 over gloo on the card running the
   reference's usage lines through the CLIs' run(): train/gpt.py
   --preset small --tp 2 --sp 2 (ring, 2 x 4096, 3 steps) and
   train/bert.py --preset base --tp 2 --sp 2 --sp-strategy ulysses
   --flash --packed (32 x 512, 4 steps): finite losses that fall, K1-K3
   0 launches for GPT and 12 per pass per rank for BERT.
29. serve - GPT-small (12 x 768, 6 heads of 128, vocab 32000, max_seq_len
   2048, bf16, random weights from a seed) behind
   serve.make_server(batching="continuous") at the server's defaults (8
   slots, paged KV in 64-token blocks, the dense-equivalent pool, 64-token
   prefill chunks), on 127.0.0.1: 12 seeded requests (prompts of 16-1024
   tokens, half sharing a 512-token prefix, 32-128 new tokens, 4 over
   /generate_stream) from 8 threads of the port's DecodeClient. Reported:
   requests/s, tokens/s, TTFT and inter-token p50/p95 from the server's
   /metrics, the engine's counters, captures, KV bytes, peak memory, and
   the paged step at 8 active slots as its CUDA graph and eagerly (ms, and
   device ms by kind with the busy share from torch.profiler; the weight
   casts alone). Held: every served chain against the port's inline
   generate (one batched ragged call), differing first only at a decision
   whose top-2 margin is at most SERVE_MARGIN_ULPS bf16 ulps; every served
   chain teacher-forced through the engine's captured step and prefill
   chunk: the step's logits (an output of its graph) against
   GPTDecodeStep's over the same keys and values at every position
   (SERVE_STEP_LOGIT_RTOL), the chunks' keys and values against
   GPTPrefill's (SERVE_PREFILL_KV_RTOL), every served token the step's
   argmax but at a near-tie; a planted control (a mask one past the index
   in the step, a causal leak of one in the chunk) that must fail both
   bounds; the same requests through a kv_layout="dense" engine (the
   margin rule); one capture of the step and of the prefill chunk; no
   launch of K1-K5; the server shut down and the engine threads joined.
30. int8_decode - GPT-small generate, 8 rows, a 128-token prompt, 32 new
   tokens, bf16, in four modes (plain, weights_int8, kv_int8, both): ms per
   new token, the steady state's device ms per token, kernels per token and
   busy share, weight and KV bytes counted from the tensors; the plain chain
   teacher-forced through each int8 mode (worst logit error over the logit
   range, greedy agreement); f32 on the card (TF32 off) against f32 on the
   CPU: quantized kernels and the KV quantizer bit-equal, caches within one
   int8 step, step logits on the same cache bytes within 1e-4 of the range.
31. int8_serve - the paged engine over the int8 twin with both int8 flags at
   8 slots: tokens/s, inter-token p50/p95, pool bytes against bf16's, the
   step as its CUDA graph and eagerly (and the int8 kernels' casts); every
   served chain replayed through the captured int8 step and chunk; the dense
   int8 cache against the paged int8 pool byte for byte.
32. beam_search - GPT-small, 2 rows x 4 beams, prompt 64, 64 new: beam 1
   equal to greedy generate, ms per step and the parent gather's share,
   scores sorted and, at f32, equal to a teacher-forced recompute.
33. spec_generate - GPT-small generate_speculative, 1 row, 128 new, draft_k
   4, ngram 2, on a repeated-span and a random prompt: f32 chains equal to
   generate's; bf16 tokens per round and ms per token beside generate's, the
   share of bf16 chains that differ and the margin at each divergence.
34. spec_serve - the paged engine at GPT-small, 8 slots, spec_depth 4, one
   request set with speculate off and ngram: tokens/s, inter-token p50/p95,
   accept rate, rounds, final depths, the verify program's graph ms; f32
   chains equal off against ngram; draft mode at GPT_TINY + GPT_DRAFT equal
   to off; near max_total a planted clamping verify must overwrite committed
   keys and values that the sentinel rule keeps.
35. decode_modes_serve - the serve CLI at --preset small --kv-int8
   --weights-int8 as a subprocess with --speculate ngram (engine) and with
   --speculative (inline): chains against in-process decode on the same
   weights, a 4-beam request sorted, the reference's 400s, SIGTERM -> 0; the
   draft preset at GPT-small and --batching continuous --speculative refused
   at startup (exit 2, the reference's text). The four processes start
   together.
36. moe_train - MoE-base (12 x 768, 12 heads, every other block top-2 of
   8 experts with bf16 expert kernels, capacity factor 1.25, vocab 32000)
   at batch 8 x seq 1024 (moe_bench.py:81-86), AdamW 3e-4 wd 0.01,
   through train/moe.py's train(): tokens/s over 5 timed steps, the
   active-parameter MFU (6 P_active + 6 L s h per token over 989e12) and
   the FLOPs the dense dispatch actually spends, peak memory, router
   balance and routed fraction (moe_bench.py:109-143); K1-K5 launch 0
   times (the reference gives the MoE LM plain attention); the LM loss
   must fall.
37. moe_profile - device ms per MoE-base step by region of the model
   (router, dispatch/combine, expert FFN, dense MLP, projections,
   attention, LM head, loss, layer norm, optimizer; GEMMs apart; copies
   and casts apart) and the busy share (profile_regions).
38. moe_parity - one moe_task step of MoE-base at batch 2 x 256: f32 on
   the card (TF32 off) against f32 on the CPU (logits, loss, router_aux,
   router_z, gradients; routing decisions equal but at near-ties), bf16
   against f32 (the loss; the share of decisions that differ per MoE
   layer); a planted router taking its losses from half the batch must
   miss the CPU's; at capacity factor 0.5 the router's dispatch on the
   card equals the CPU's, and a planted per-token claim order moves
   slots (the reference's loop claims in whole rounds).
39. moe_run_steps - run_steps(n=3) of MoE-base at 8 x 1024 as a CUDA
   graph against 3 eager steps (run_steps' criterion; no kernel inside).
40. moe_generate - MoE-base, 8 rows, a 128-token prompt, 128 new tokens
   (moe_bench.py:184): tokens/s as the reference counts them, ms per
   token, busy share; in f32 at capacity factor 2.0, teacher-forced
   MoEDecodeStep against the training forward and the prefill chain
   against the all-stepwise chain.
41. moe_serve - train/moe.py --preset base --steps 2 --checkpoint-dir
   (its main(), in this process), then the serve CLI --preset moe-base on
   that checkpoint as a subprocess: 4 requests from the port's DecodeClient, greedy chains
   equal to in-process moe_generate on the restored weights; a ragged,
   a top_k and a num_beams request each a 400; SIGTERM -> exit 0.
42. vit_train, vit_profile - ViT-B/16 through train/vit.py at 224^2,
   batch 128, AdamW 1e-3 wd 0.05, bf16: images/s over 5 timed steps, MFU
   by the bench's transformer_step_flops (seq 196, not causal), device
   ms by region, peak memory; the loss must fall.
43. vit_parity - ViT-B/16 at batch 4, gap and cls pooling, f32 and uint8
   images: f32 on the card against the CPU, bf16 against f32, a remat
   step against a plain one; a planted column-major patch order must
   fail.
44. train_observe - gpt_train's run (GPT-small, 4 x 4096, causal flash)
   with --monitoring-bind-addr 127.0.0.1:<port>: a scraper thread reads
   every route of the worker's telemetry server while the card trains,
   and each step's hook reads /metrics. Held: train_steps_total moves by
   the steps run, /metrics validates, /healthz reaches "training", every
   route answers 200, and K1-K3 launch 12 times a step each. Tokens/s
   beside gpt_train's.
45. train_observe_smoke - train/observe.py run_train_observe_smoke on
   the card: two MNIST workers in threads, a latency fault on worker-1's
   input fires train-straggler, the fault clears and the alert
   resolves; phase coverage >= 0.95, attribution overhead and the
   sampling profiler's duty cycle < 2%, the goodput ledger reconciles
   exactly. Held too: the healthy worker's step rate when the straggler
   fired stays within OBSERVE_RATE_KEEP of its steady rate (the larger of
   the baseline's and the one after the resolve: the slowed worker's
   sleep is on the host, so the shared card does not couple them).
46. serve_observe - GPT-small behind make_server with tenant quotas
   (OBSERVE_QUOTAS), alerts on, a 0.5 s history cadence and the debug
   endpoints, serve's 12-request mix from 8 client threads over
   /generate_stream (request i from tenant i % 3: vip, a default tenant,
   noisy), once with batching="continuous" and once with
   batching="window", batch_window_ms=5. Held: every chain against the
   inline generate under the margin rule (SERVE_MARGIN_ULPS), a 429 only
   with Retry-After (a client retries after it), OBSERVE_NOISY_BURST
   concurrent noisy requests over its burst draw at least one 429, every
   debug route answers. Tokens/s, TTFT p50/p95 (first streamed token at
   the client) for both modes and by priority class.
47. disagg_serve - GPT-small (bf16, random weights from a seed) as a
   prefill server and a decode server (make_server, role="prefill" and
   "decode", 8 slots each, the default pools) in this process behind the
   port's LeastLoadedRouter: 24 seeded streams (16 of a 512-token shared
   prefix plus 16-128 own tokens, 8 of 64-128 tokens alone, 32-64 new)
   from 8 threads, every one picked by the decode pool and migrated
   first, then the same streams on the decode replica alone. Held: the
   chains equal the monolithic ones (the margin rule otherwise) and the
   inline generate's under the margin rule, no prefill chunk on the
   decode replica for migrated streams, the imported bytes equal to its
   own prefill's, both pools audit clean with no block in use, the
   import route alone gives the monolithic chain and two planted imports
   on it (rebinding the pool tensors, one block off) each give another,
   and 4 streams under kv_quant_int8 move the scale leaves.
   Reported: migrations and picks, one migration's bytes and ms (export,
   ship, import), TTFT p50/p95 migrated against monolithic.
48. export_serve - serve/export.py on the lifecycle phase's checkpoint
   (a copy whose position table is cut to the small preset's 2048 rows):
   the artifact's bytes against the training checkpoint's, its int8
   tensors against quantize_model on the card, and the serve CLI on the
   artifact against --weights-int8 on the checkpoint: seconds from
   process start to the first token, equal greedy chains, exit 0 on
   SIGTERM.
49. fleet_soak_bf16 - serve/fleet.py run_failover_soak at GPT-small (bf16,
   random weights from FLEET_SEED): the port's ServeServiceController on
   its InMemorySubstrate reconciles 3 replica pods, InProcessFleet boots a
   make_server(warm_async=True) engine server of 4 slots (64-token blocks
   and chunks) for each, behind LeastLoadedRouter; 8 client threads stream
   prompts of 16-512 tokens, 32 new each, one replica is killed with exit
   137 after it has streamed a token, 2 connection resets are injected,
   and the clients keep streaming until the controller's replacement is
   ready, so it is built and captures its programs while the survivors
   serve. Held: 0 lost streams, every failover flight-recorded under its
   stream's corr, every chain the inline generate's under the margin rule
   (SERVE_MARGIN_ULPS), streams in flight while the replacement booted,
   each engine's step and chunk captured once, the kill freeing at least
   FLEET_MEMORY_FREED of a replica's share of the memory and the total
   back within FLEET_MEMORY_SLACK of it once the replacement is ready.
   Reported: boots with their seconds, failovers, captures, TTFT and
   inter-token p50/p95 at the clients (host-bound), memory after the
   boots, the kill and the replacement.
50. fleet_soak_f32 - the same soak at f32 with TF32 off: every chain
   bit-identical to inline generate (the reference's criterion).
51. fleet_update - run_rolling_update at GPT-small bf16: v1 -> v2 (another
   seed's weights) with maxUnavailable 1 under 8 client threads; each
   stream's chain that of the version it was admitted under (its first
   token against its replica's swap time; the margin rule against that
   version's model), no stream lost, every replica's programs captured
   once. A planted swap that rebinds the model's tensors
   (load_state_dict(assign=True)) instead of copying into them must fail
   that chain check. Reported: per-replica drain and swap seconds.
52. fleet_autoscale, fleet_trace - run_autoscale_smoke at GPT-small bf16
   (prompts of 64-192 tokens): a latency fault trips the burn-rate alert,
   the autoscaler scales the decode group out (a boot under load), the
   fault clears and the group drains back in; no oscillation, 0 lost
   streams, the margin rule, kind=scale flight records trace-correlated;
   the observatory scraped at the scaled-out point (fleet SLO, KV
   directory, a merged trace). Then run_trace_smoke at GPT-small (a
   prefill and a decode replica, 64-token blocks): a migrated request's
   merged trace through the observatory with all 8 HOP_NAMES. No kernel
   of K1-K5 runs in phases 49-52.
Each phase group prints its seconds (group_seconds), every phase line
the seconds since the script started ("t"), and script_seconds the
total. Then the kernel summary line (with each kernel's launches per
run_steps replay and per step per rank at world 2), the nvidia-smi line,
and the result line. `chip_smoke.py --world2-rank <dir>` is one rank of
phases 23-27's world of 2, which phase 23 launches (the distributed group),
and `--world-rank cli <dir>` one of phase 28's world of 4.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import math
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# bf16 outputs of a kernel and its plain version both round an f32
# result once: allow 2 bf16 ulps (2 * 2^-8) of the largest magnitude
KERNEL_RTOL = 2 * 2.0**-8
# K1's f32 output against the plain version's f32 output. K1 feeds P to
# P.V as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), which keep
# p to within 2^-18 of itself; O is a convex combination of v rows, so
# that moves it by at most 2^-18 * max|v|. Beside it, f32 sums in another
# order: 1e-5 of the largest magnitude.
OUT_F32_P_RTOL = 2.0**-18
OUT_F32_RTOL = 1e-5
# the common-part case (v = 4 + 0.05 noise, where O is large against
# v_k - O): K1 -> delta -> K2, K3 in bf16, each of dq, dk, dv within this
# relative L2 distance of the f32 plain gradients
COMMON_GRAD_RTOL = 1e-2
# K1-K3 at GPT_SHAPE against the f32 plain outputs and gradients, one
# (batch, row, head) slice of head_dim values at a time: relative L2
# distance within ROW_RTOL. A correct kernel is off by bf16 roundings
# (each about 2^-9 of a value); a causal tile bound that drops or repeats
# one 64-key tile of a row that sees n keys moves it by about sqrt(64/n),
# 12% at n = 4096. Slices smaller than ROW_FLOOR of the tensor's median
# slice norm (the dK/dV rows of the last keys, which few queries reach)
# are measured against that floor instead.
ROW_RTOL = 2.0**-5
ROW_FLOOR = 1.0 / 8
# flash vs plain attention inside BERT-base in bf16: the plain path runs
# both products in bf16, the kernels in f32, so logits differ by bf16
# roundings; the f32 loss (about ln 30522 = 10.3) may differ by this
LOSS_ATOL = 2e-2
# gradients: relative L2 distance to the f32 step, flash route over
# plain bf16 route, for each parameter (distances below GRAD_FLOOR
# count as GRAD_FLOOR)
GRAD_RATIO = 1.5
GRAD_FLOOR = 1e-2
MAIN_SHAPE = (32, 512, 12, 64)  # one BERT-base layer at the bench's batch
# seq 333 is not a multiple of the kernels' 64- or 128-row tiles
CHECK_SHAPES = ((4, 512, 12, 64), (4, 512, 6, 128), (4, 333, 12, 64), (4, 333, 6, 128))
LAYERS = 12
FLASH_SOURCE = "tf_operator_tpu_torch/csrc/flash_attention.cu"
CONV_SOURCE = "tf_operator_tpu_torch/csrc/conv_bn.cu"
REPLACES = {
    "flash_fwd": "tf_operator_tpu/ops/pallas/flash_attention.py:88",
    "flash_bwd_dkv": "tf_operator_tpu/ops/pallas/flash_attention.py:250",
    "flash_bwd_dq": "tf_operator_tpu/ops/pallas/flash_attention.py:324",
    "conv3x3_fwd": "tf_operator_tpu/ops/pallas/conv_bn.py:91",
    "conv3x3_dw": "tf_operator_tpu/ops/pallas/conv_bn.py:144",
}
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
ROW_OUTPUTS = {"flash_fwd": ("out",), "flash_bwd_dkv": ("dk", "dv"), "flash_bwd_dq": ("dq",)}
CONV_KERNELS = ("conv3x3_fwd", "conv3x3_dw")
# the kernels' names in a profile
FLASH_KERNEL_SYMBOLS = ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")
CONV_KERNEL_SYMBOLS = ("conv3x3_fwd_kernel", "conv3x3_dw_kernel", "conv3x3_dw_reduce_kernel")
# ResNet-50's stride-1 3x3 convs: (spatial size, channels, how many per
# pass) at stage sizes 3, 4, 6, 3 (the first block of stages 1-3 is
# stride 2 and takes the torch conv)
CONV_STAGES = ((56, 64, 3), (28, 128, 3), (14, 256, 5), (7, 512, 2))
CONVS_PER_PASS = sum(count for _, _, count in CONV_STAGES)
RESNET_BATCH = 256  # the bench's per-chip batch (model_benches.py:97)
RESNET_IMAGE = 224
CONV_CHECK_N = 8
# C != Cout cases, from tests/test_attention.py TestPallasConv, and
# ragged ones: 9x9 images that K5's 112-pixel patches cover with
# padding, and two whose K4 boxes pad N and W (8x8x2 boxes over 3 7x7
# images; a 32x4 box over one 3x11 image)
CONV_EXTRA_CASES = (
    ((2, 8, 8, 128), 64), ((2, 4, 4, 256), 512), ((3, 9, 9, 64), 128),
    ((3, 7, 7, 512), 256), ((1, 3, 11, 512), 64),
)
# K5's f32 dW sums N*H*W products in another order than the plain
# version's f32 matmul: allow 1e-4 of the largest magnitude
DW_RTOL = 1e-4
RESNET_PARITY_BATCH = 32
# device time by kind of kernel in the profiles, first match wins
# (substrings of the lower-cased kernel name)
PROFILE_CATEGORIES = (
    ("flash (K1-K3)", ("flash_",)),
    ("conv3x3 (K4/K5)", ("conv3x3_",)),
    ("cuDNN/cuBLAS conv and GEMM", ("cudnn", "xmma", "conv", "gemm", "nvjet", "cutlass", "wgrad", "dgrad")),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy",)),
    ("elementwise", ("elementwise", "functor")),
    ("pooling", ("pool",)),
)
# the bench's ResNet-50 training FLOP per image (model_benches.py:41-45)
BENCH_FLOP_PER_IMAGE = 3.0 * 7.7e9
# GPT-small (12 x 768, 6 heads of 128) at the reference bench's batch
# and seq (model_benches.py:319-326): one layer's attention, causal
GPT_SHAPE = (4, 4096, 6, 128)
GPT_STEPS = 5
GPT_NEW_TOKENS = 56  # after train/gpt.py's 8-token prompt: 64 positions
# teacher-forced decode logits against the training forward's, as the
# reference's own decode test holds them (tests/test_gpt.py:150-154)
DECODE_ATOL = DECODE_RTOL = 1e-3
# lifecycle: GPT-small through train/gpt.py at GPT_SHAPE, a SIGTERM after
# step 3 of a 6-step budget, gradient accumulation over 2 microbatches
LIFECYCLE_STEPS = 6
LIFECYCLE_PREEMPT_AT = 3
LIFECYCLE_ACCUM = 2
# one step from the restored state against one from the in-memory state:
# the same arithmetic on the same bits (no kernel uses atomics), so
# bit-equal is expected; this bounds any parameter's relative L2 distance
RESUME_STEP_RTOL = 1e-6
# the gradient over 2 microbatches against the full batch's, bf16 model:
# the weighted sum of two halves rounds differently from one pass
ACCUM_GRAD_RTOL = 1e-2
# PR 6's GPT-small flash step with the batch drawn on the host between
# steps (PERF.md section 5, gpt_train, run 3)
PR6_GPT_STEP_MS = 85.60
# run_steps: n steps in a CUDA graph against n eager steps. Both run the
# same optimizer (AdamW or SGD, fused, the rate a device
# scalar), so bit-equal is expected (and reported); the checks hold
# losses within 1e-3 relative at every step and each parameter within
# 1e-4 relative L2
RUN_STEPS = 3
RUN_STEPS_LOSS_RTOL = 1e-3
RUN_STEPS_PARAM_RTOL = 1e-4
# mnist: the reference's recorded run (MNIST_ACC.json)
MNIST_STEPS = 1000
MNIST_BATCH = 512
EVALUATOR_TIMEOUT_S = 180
# several processes (run_distributed_phases)
WORLD2 = 2
DIST_STEPS = 2
DIST_TIMEOUT_S = 420
DIST_SEED = 3
DIST_BATCH_SEED = 7
# world 2 against one process, both bf16 on the same route from the same
# weights and global batch: each rank runs half the rows, so its matmuls
# and convs have other shapes and round otherwise, and the gradient (and
# sync BN's sums) add two halves in another order. plain_parity's
# criterion for a bf16 step: the loss within LOSS_ATOL, and each
# gradient and BN statistic no more than GRAD_RATIO times further
# (relative L2, floor GRAD_FLOOR) from the same step in f32 than the
# one-process bf16 step's
DIST_TOLERANCE_WHY = (
    "same route, weights and global batch; the ranks' halves run other matmul and conv "
    "shapes and sum in another order, so bf16 roundings differ: plain_parity's criterion, "
    "each tensor no more than GRAD_RATIO x further from the f32 step than the one "
    "process's (floor GRAD_FLOOR), the loss within LOSS_ATOL")
# GPT-small's parameters after 2 AdamW steps at world 2 against one
# process: ||p_world2 - p_one|| / ||p_one - p_0||. An early AdamW step
# moves a weight by about lr * sign(g), and a weight whose gradient lies
# within the bf16 roundings of zero may move the other way (2 lr apart):
# 0.25 allows about 1.5% of the weights that; a dropped or wrongly
# sharded update gives about 1
DIST_UPDATE_RTOL = 0.25
DIST_UPDATE_WHY = (
    "an early AdamW step moves a weight by about lr * sign(g); weights whose gradient is "
    "within bf16 roundings of zero may move the other way; a lost update gives ~1")
# GPT-small's step-1 gradient at world 2 against the one process's bf16
# gradient, relative L2 of the worst tensor, each rank on its shards (an
# f32 step at 4 x 4096 on plain attention does not fit the card, so no
# plain_parity ratio): sound runs read 2.3e-3; a reduce-scatter that sums
# instead of averaging, or a wrong weight normalisation, reads about 1
FSDP_GRAD_RTOL = 2e-2
# syncbn_resnet: rank 1's half of the global batch is 3x + 1 of its draw,
# so that per-rank BatchNorm statistics are far from the global batch's.
# The bf16 step's BN running statistics are held directly against the
# one-process bf16 step's (relative L2 of the worst tensor,
# SYNCBN_STAT_RTOL). Its gradients cannot be: ResNet-50 at this init is
# chaotic, so bf16 roundings of other shapes move some conv gradients by
# O(1) (1.07 in the stem's block at world 2, where a BN with no gradient
# through its sums reads 1.19). So the same world-2 step also runs in f32
# on the torch conv (TF32 off) and is held to the one-process f32 step:
# every conv gradient (SYNCBN_F32_GRAD_RTOL) and BN statistic
# (SYNCBN_F32_STAT_RTOL). Two controls run that f32 step with BN that
# does not sync (sync group unset) and with sums that a
# non-differentiable all-reduce carries (global statistics forward, a
# per-rank BN's gradients backward); each must fail an f32 bound. The
# bounds sit between the readings on the card: bf16 statistics 4.6e-3
# (unsynced 1.0); f32 conv gradients 1.9e-2 (an early block's: the
# chaos again, at f32's roundings), the controls 1.16 and 1.73; f32
# statistics 6.6e-7, the unsynced control 1.0
SYNCBN_SHIFT = (3.0, 1.0)
SYNCBN_STAT_RTOL = 5e-2
SYNCBN_F32_GRAD_RTOL = 0.1
SYNCBN_F32_STAT_RTOL = 1e-4
SYNCBN_WHY = (
    "world 2 against one process on the same weights and global batch: bf16 BN statistics "
    "directly (bf16 roundings of other shapes and orders); conv gradients and statistics "
    "in f32 (bf16 gradients of this deep net at init differ O(1) between summation "
    "orders); the controls (BN not synced, sums all-reduced without a gradient) must fail "
    "an f32 bound")


_START = time.monotonic()


def emit(obj) -> None:
    """One JSON line; a phase's line carries "t", the seconds since the
    script started."""
    if "phase" in obj:
        obj = {**obj, "t": round(time.monotonic() - _START, 3)}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def make_inputs(b, s, h, d, seed, with_mask, causal):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (
        torch.randn((b, s, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
        for _ in range(4)
    )
    mask = None
    if with_mask:
        mask = torch.ones((b, s), device="cuda")
        for row in range(b):
            mask[row, s - 37 * (row + 1):] = 0.0
        if not causal:
            # a batch row whose keys are all padding: uniform weights and
            # a finite lse in kernel and plain version alike
            mask[0] = 0.0
    return q, k, v, g, mask


def ptxas_summary(log: str) -> dict:
    """{"flash_fwd_kernel<64>": "0 bytes spilled; 80 registers", ...}
    from nvcc's -Xptxas -v output, with any C75xx warning (wgmmas
    serialized) under "warnings"."""
    import re

    summary, name = {}, None
    for line in log.splitlines():
        if re.search(r"C75\d\d", line):
            summary.setdefault("warnings", []).append(line.strip()[:200])
            continue
        entry = re.search(
            r"((?:flash_(?:fwd|bwd_dkv|bwd_dq)|conv3x3_(?:fwd|dw))_kernel)ILi(\d+)E", line
        )
        reduce = re.search(r"(conv3x3_dw_reduce_kernel)", line)
        if entry or reduce:
            name = f"{entry.group(1)}<{entry.group(2)}>" if entry else reduce.group(1)
            summary[name] = ""
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        regs = re.search(r"Used (\d+) registers", line)
        if name and spill:
            summary[name] += f"{spill.group(1)} bytes spilled; "
        if name and regs:
            summary[name] += f"{regs.group(1)} registers"
    return summary


def model_flop_per_token(cfg, seq: int) -> int:
    """Training FLOP per token of BertForMLM: 3x the forward's matmuls
    (2 per weight for the projections, MLP and head; 4 * seq * hidden
    per layer for q.k and p.v), recomputation not counted."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    weights = cfg.num_layers * (4 * h * h + 2 * h * inter) + h * cfg.vocab_size
    return 3 * (2 * weights + 4 * cfg.num_layers * seq * h)


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()


def worst_position(got: torch.Tensor, want: torch.Tensor) -> list:
    """[b, s, h, d] of the largest |got - want|: a wrong causal tile bound
    shows as a query row s far from the diagonal."""
    diff = (got.float() - want.float()).abs()
    return [int(i) for i in torch.unravel_index(diff.argmax(), diff.shape)]


def check_case(kernels, fa, inputs, causal, case, worst) -> None:
    """K1-K3 against their plain versions on one set of inputs; records
    each kernel's (error, tolerance) in `case` and each output's worst
    position under "worst_at", keeps the worst (error / tolerance) per
    kernel in `worst`, and raises on one out of tolerance."""
    q, k, v, g, mask = inputs
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse, out_f32 = kernels.flash_fwd(q, k, v, mask, causal, scale)
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, mask, causal, scale)
    delta = fa._delta(out_f32, g)
    args = (q, k, v, mask, g, lse, delta, causal, scale)
    dk, dv = kernels.flash_bwd_dkv(*args)
    dq = kernels.flash_bwd_dq(*args)
    ref_dk, ref_dv = fa.flash_backward_dkv_reference(*args)
    ref_dq = fa.flash_backward_dq_reference(*args)
    torch.cuda.synchronize()
    pairs = {
        "flash_fwd": [("out", out, ref_out)],
        "flash_bwd_dkv": [("dk", dk, ref_dk), ("dv", dv, ref_dv)],
        "flash_bwd_dq": [("dq", dq, ref_dq)],
    }
    case["worst_at"] = {}
    for name, items in pairs.items():
        for output, got, want in items:
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{name} {case}: bad shape or non-finite")
            err = max_err(got, want)
            tol = KERNEL_RTOL * max(1.0, want.float().abs().max().item())
            case[name] = [err, tol]
            case["worst_at"][output] = worst_position(got, want)
            if err > tol:
                raise AssertionError(f"{name} ({output}) {case}: error {err} > {tol}")
            if name not in worst or err / tol > worst[name][0] / worst[name][1]:
                worst[name] = (err, tol)
    lse_err = (lse - ref_lse).abs().max().item()
    case["lse"] = lse_err
    if lse_err > 1e-3:
        raise AssertionError(f"lse {case}: error {lse_err}")
    # K1's f32 output (what delta is taken from) against the plain
    # version's before rounding (OUT_F32_P_RTOL, OUT_F32_RTOL)
    ref_f32, _ = fa._forward_f32(q, k, v, mask, causal, scale)
    f32_err = max_err(out_f32, ref_f32)
    f32_tol = (OUT_F32_P_RTOL * v.float().abs().max().item()
               + OUT_F32_RTOL * max(1.0, ref_f32.abs().max().item()))
    case["out_f32"] = [f32_err, f32_tol]
    case["worst_at"]["out_f32"] = worst_position(out_f32, ref_f32)
    if f32_err > f32_tol:
        raise AssertionError(f"out_f32 {case}: error {f32_err} > {f32_tol}")


def f32_pair(kernels, fa, inputs, causal) -> tuple:
    """K1, then `_delta`, K2 and K3 on bf16 inputs; and the plain
    version's output and gradients in f32 from the same bf16 values.
    Returns ({"out", "dq", "dk", "dv"} from the kernels, the same f32)."""
    q, k, v, g, mask = inputs
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse, out_f32 = kernels.flash_fwd(q, k, v, mask, causal, scale)
    args = (q, k, v, mask, g, lse, fa._delta(out_f32, g), causal, scale)
    dk, dv = kernels.flash_bwd_dkv(*args)
    dq = kernels.flash_bwd_dq(*args)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    ref_out, ref_lse = fa._forward_f32(qf, kf, vf, mask, causal, scale)
    ref_dq, ref_dk, ref_dv = fa.flash_backward_reference(
        qf, kf, vf, mask, gf, ref_lse, fa._delta(ref_out, gf), causal, scale
    )
    torch.cuda.synchronize()
    return ({"out": out, "dq": dq, "dk": dk, "dv": dv},
            {"out": ref_out, "dq": ref_dq, "dk": ref_dk, "dv": ref_dv})


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want).norm() / want.norm()).item()


def row_errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    """[b, s, h, d] against its f32 truth: the relative L2 distance of
    each (b, s, h) slice (its norm floored at ROW_FLOOR of the median
    slice norm), the worst with its position and the median, and the
    whole tensor's."""
    norm = want.norm(dim=-1)
    rel = (got.float() - want).norm(dim=-1) / norm.clamp_min(ROW_FLOOR * norm.median())
    return {"worst_row_rel": rel.max().item(),
            "worst_at_b_s_h": [int(i) for i in torch.unravel_index(rel.argmax(), rel.shape)],
            "median_row_rel": rel.median().item(), "whole_rel": rel_l2(got, want)}


def check_common_part(kernels, fa, shape, seed) -> dict:
    """The case behind delta's f32 O (tests/test_torch_flash_attention.py):
    q, k, dO from N(0, 1), v = 4 + 0.05 N(0, 1), all bf16. K1, then
    `_delta`, then K2 and K3, against the f32 plain gradients of the same
    bf16 values: relative L2 distance of dq, dk, dv each within
    COMMON_GRAD_RTOL."""
    b, s, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, g = (torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    v = (4.0 + 0.05 * torch.randn((b, s, h, d), generator=gen, device="cuda")).bfloat16()
    got, ref = f32_pair(kernels, fa, (q, k, v, g, None), False)
    case = {"shape": list(shape), "case": "common part (v = 4 + 0.05 noise)",
            "grad_rtol": COMMON_GRAD_RTOL}
    for name in ("dq", "dk", "dv"):
        case[name] = rel_l2(got[name], ref[name])
    emit({"phase": "kernel_check", **case})
    worst = max(case["dq"], case["dk"], case["dv"])
    if not math.isfinite(worst) or worst > COMMON_GRAD_RTOL:
        raise AssertionError(f"common-part gradients {case}")
    return case


def check_rows(kernels, fa, shape, causal, seed, phase) -> dict:
    """K1-K3 on make_inputs' N(0, 1) inputs against the f32 plain output
    and gradients, on a scale that follows the rows: for each of out,
    dq, dk, dv, the worst (batch, row, head) slice's relative L2 distance
    (ROW_RTOL, ROW_FLOOR) with its position, and the whole tensor's
    (COMMON_GRAD_RTOL). Raises on either out of tolerance."""
    got, ref = f32_pair(kernels, fa, make_inputs(*shape, seed, False, causal), causal)
    case = {"shape": list(shape), "causal": causal, "case": "rows against f32",
            "row_rtol": ROW_RTOL, "row_floor": ROW_FLOOR, "whole_rtol": COMMON_GRAD_RTOL}
    failed = []
    for name in ("out", "dq", "dk", "dv"):
        case[name] = row_errors(got[name], ref[name])
        if not case[name]["worst_row_rel"] <= ROW_RTOL or not (
                case[name]["whole_rel"] <= COMMON_GRAD_RTOL):
            failed.append(name)
    emit({"phase": phase, **case})
    if failed:
        raise AssertionError(f"{failed} out of tolerance against f32: {case}")
    del got, ref
    torch.cuda.empty_cache()
    return case


def check_kernels(kernels, fa) -> dict:
    """Each kernel against its plain version at CHECK_SHAPES, with and
    without the mask, causal and not; returns per kernel the worst
    (error / tolerance) case as (error, tolerance)."""
    worst = {}
    for b, s, h, d in CHECK_SHAPES:
        for causal in (False, True):
            for with_mask in (False, True):
                inputs = make_inputs(b, s, h, d, 1, with_mask, causal)
                case = {"shape": [b, s, h, d], "causal": causal, "mask": with_mask}
                check_case(kernels, fa, inputs, causal, case, worst)
                emit({"phase": "kernel_check", **case})
        check_common_part(kernels, fa, (b, s, h, d), 3)
    return worst


def time_kernels(kernels, fa, worst, shape=MAIN_SHAPE, causal=False,
                 phase="kernel_times", check_phase="kernel_check") -> dict:
    """At one shape: each kernel against its plain version (into
    `worst`), then the median ms of each kernel, its plain version and
    the library call (SDPA, causal as the kernels), plus the bound from
    these inputs. Under a causal mask the work counts the s(s+1)/2 query
    and key pairs each (batch, head) keeps."""
    b, s, h, d = shape
    inputs = make_inputs(b, s, h, d, 2, False, causal)
    case = {"shape": list(shape), "causal": causal, "mask": False}
    check_case(kernels, fa, inputs, causal, case, worst)
    emit({"phase": check_phase, **case})
    q, k, v, g, _ = inputs
    scale = 1.0 / math.sqrt(d)
    out, lse, out_f32 = kernels.flash_fwd(q, k, v, None, causal, scale)
    delta = fa._delta(out_f32, g)
    args = (q, k, v, None, g, lse, delta, causal, scale)

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    gt = g.transpose(1, 2)

    def sdpa_backward():
        torch.autograd.grad(sdpa_out, (qt, kt, vt), gt, retain_graph=True)

    with torch.no_grad():
        sdpa_fwd_ms = median_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal))
    sdpa_bwd_ms = median_ms(sdpa_backward)

    n = b * s * h * d  # elements of one [b, s, h, d] tensor
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    stats_bytes = 4 * b * h * s  # one f32 row statistic
    work = {
        # name: (FLOP, bytes: each input read once, each output written
        # once). K1's outputs are O in bf16 and lse, as the TPU kernel's;
        # its extra f32 copy of O is reported beside the bound.
        "flash_fwd": (4 * pairs * d, 2 * 3 * n + 2 * n + stats_bytes),
        "flash_bwd_dkv": (8 * pairs * d, 2 * 4 * n + 2 * stats_bytes + 2 * 2 * n),
        "flash_bwd_dq": (6 * pairs * d, 2 * 4 * n + 2 * stats_bytes + 2 * n),
    }
    timed = {
        "flash_fwd": (
            lambda: kernels.flash_fwd(q, k, v, None, causal, scale),
            lambda: fa.flash_forward_reference(q, k, v, None, causal, scale),
            sdpa_fwd_ms,
        ),
        "flash_bwd_dkv": (
            lambda: kernels.flash_bwd_dkv(*args),
            lambda: fa.flash_backward_dkv_reference(*args),
            sdpa_bwd_ms,
        ),
        "flash_bwd_dq": (
            lambda: kernels.flash_bwd_dq(*args),
            lambda: fa.flash_backward_dq_reference(*args),
            sdpa_bwd_ms,
        ),
    }
    result = {}
    for name, (kernel_fn, plain_fn, library_ms) in timed.items():
        flops, nbytes = work[name]
        op_ms = flops / PEAK_BF16_FLOPS * 1e3
        byte_ms = nbytes / PEAK_BYTES * 1e3
        result[name] = {
            "ms": median_ms(kernel_fn),
            "plain_ms": median_ms(plain_fn, iters=5, warmup=1),
            "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes",
            "library_ms": library_ms,
            "flop": flops,
            "bytes": nbytes,
        }
        result[name]["tflops"] = flops / result[name]["ms"] / 1e9
    f32_out_bytes = 4 * n
    emit({"phase": phase, "shape": list(shape), "causal": causal, "dtype": "bfloat16",
          "flash_fwd_f32_out_bytes": f32_out_bytes,
          "flash_fwd_f32_out_ms_at_peak": f32_out_bytes / PEAK_BYTES * 1e3,
          "library": f"F.scaled_dot_product_attention(is_causal={causal}) (K2, K3: its "
                     "backward, dq+dk+dv together)", **result})
    del inputs, q, k, v, g, out, lse, out_f32, delta, args, qt, kt, vt, sdpa_out, gt, timed
    torch.cuda.empty_cache()
    return result


def profile_step(bert_lib, trainer_lib, flash_attention) -> None:
    """Device time of two BERT-base flash training steps by kernel and
    by kind of kernel."""
    cfg = bert_lib.BERT_BASE
    model = bert_lib.BertForMLM(
        cfg, attention_fn=flash_attention, generator=torch.Generator().manual_seed(5)
    )
    trainer = trainer_lib.Trainer(
        model, trainer_lib.mlm_task(), learning_rate=1e-4,
        weight_decay=0.01, packed=True, device="cuda",
    )
    batch = bert_lib.synthetic_batch(
        torch.Generator().manual_seed(6), MAIN_SHAPE[0], MAIN_SHAPE[1], cfg
    )
    profile_training("profile", trainer, batch, "flash", FLASH_KERNEL_SYMBOLS)


def profile_training(phase: str, trainer, batch, label: str, ours, extra=None) -> None:
    """Device time of two training steps by kernel and by kind of kernel
    (torch.profiler), the share of the kernels named in `ours` (reported
    under `label`), and the device's busy share of the window's wall
    time; one warm-up step first."""
    from torch.profiler import ProfilerActivity, profile

    state = trainer.init()
    batch = trainer.place_batch(batch)
    state, _ = trainer.step(state, batch)
    torch.cuda.synchronize()
    steps = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.monotonic()
        for _ in range(steps):
            state, _ = trainer.step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - start) * 1e3
    kernels = device_kernels(prof)
    total_us = sum(e.self_device_time_total for e in kernels)
    by_ours = {
        n: sum(e.self_device_time_total for e in kernels if n in e.key) / 1e3 / steps
        for n in ours
    }
    ours_us = sum(e.self_device_time_total for e in kernels if any(n in e.key for n in ours))
    by_category, members = {}, {}
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        category = next(
            (name for name, keys in PROFILE_CATEGORIES if any(k in e.key.lower() for k in keys)),
            "other",
        )
        by_category[category] = by_category.get(category, 0.0) + e.self_device_time_total / 1e3 / steps
        members.setdefault(category, [])
        if len(members[category]) < 3:  # the largest few, to check the sorting
            members[category].append(e.key[:70])
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    emit({
        "phase": phase, **(extra or {}), "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": total_us / 1e3 / steps,
        "device_busy_share": total_us / 1e3 / wall_ms if wall_ms else None,
        f"{label}_kernels_ms_per_step": ours_us / 1e3 / steps,
        f"{label}_kernels_by_name_ms_per_step": by_ours,
        f"{label}_share_of_device": ours_us / total_us if total_us else None,
        "ms_per_step_by_category": by_category,
        "largest_by_category": members,
        "top": [
            {"kernel": e.key[:90], "ms_per_step": e.self_device_time_total / 1e3 / steps,
             "calls_per_step": e.count / steps}
            for e in top
        ],
    })


def device_kernels(prof) -> list:
    """The profile's device events, without the user annotations that
    the profiler also lists on the device (`Optimizer.step#AdamW.step`,
    `ProfilerStep#n`, profile_regions' labels): those span kernels that
    are listed themselves,
    and counting them would count that time twice."""
    return [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not e.key.startswith(("Optimizer.", "ProfilerStep#", REGION_PREFIX))
    ]


def padded_batch(bert_lib, cfg, batch_size, seq_len, seed):
    gen = torch.Generator().manual_seed(seed)
    batch = bert_lib.synthetic_batch(gen, batch_size, seq_len, cfg)
    for row in range(batch_size):
        length = seq_len - 13 * row
        batch["attention_mask"][row, length:] = 0
        batch["mlm_weights"][row, length:] = 0.0
    return batch


def flash_over_plain(grads) -> tuple:
    """Each parameter's relative L2 distance from the f32 step's gradient
    on the flash and the plain route: (the worst (name, distance) per
    route, [(flash / max(plain, GRAD_FLOOR), name, flash, plain), ...]
    largest ratio first)."""
    errors = {"flash": {}, "plain": {}}
    for name, truth in grads["f32"].items():
        if name.endswith("attention.key.bias"):
            # zero in exact arithmetic (a key bias shifts every score
            # of a row by q.b, which the softmax ignores), so every
            # route holds only rounding noise there
            continue
        for route in errors:
            diff = (grads[route][name] - truth).norm() / truth.norm().clamp_min(1e-30)
            errors[route][name] = diff.item()
    worst = {r: max(e.items(), key=lambda kv: kv[1]) for r, e in errors.items()}
    ratios = sorted(
        ((errors["flash"][n] / max(errors["plain"][n], GRAD_FLOOR), n,
          errors["flash"][n], errors["plain"][n]) for n in errors["flash"]),
        reverse=True,
    )
    return worst, ratios


def plain_parity(kernels, bert_lib, trainer_lib, flash_attention) -> dict:
    """One step from the same weights and batch through the flash
    kernels and through the plain attention path, both in bf16, packed
    and unpacked; the unpacked flash step must launch each kernel once
    per layer. Gradients are held against the same step in f32 (plain
    attention, full-f32 matmuls): the flash route may be no further
    from it than the plain bf16 route, parameter by parameter."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = bert_lib.BERT_BASE
    routes = (
        ("flash", flash_attention, base),
        ("plain", None, base),
        ("f32", None, dataclasses.replace(base, dtype=torch.float32)),
    )
    batch_size, seq_len = MAIN_SHAPE[0], MAIN_SHAPE[1]
    report = {}
    for packed in (True, False):
        if packed:
            batch = bert_lib.synthetic_batch(
                torch.Generator().manual_seed(7), batch_size, seq_len, base
            )
        else:
            batch = padded_batch(bert_lib, base, batch_size, seq_len, seed=7)
        losses, grads = {}, {}
        for route, attention_fn, cfg in routes:
            model = bert_lib.BertForMLM(
                cfg, attention_fn=attention_fn,
                generator=torch.Generator().manual_seed(3),
            )
            trainer = trainer_lib.Trainer(
                model, trainer_lib.mlm_task(), learning_rate=1e-4,
                weight_decay=0.01, packed=packed, device="cuda",
            )
            state = trainer.init()
            kernels.reset_launches()
            state, metrics = trainer.step(state, trainer.place_batch(batch))
            losses[route] = float(metrics["loss"])
            counts = dict(kernels.LAUNCHES)
            want = LAYERS if route == "flash" else 0
            if any(counts[k] != want for k in FLASH_KERNELS) or any(
                counts[k] for k in CONV_KERNELS
            ):
                raise AssertionError(
                    f"{route} packed={packed}: launches {counts}, want {want} per "
                    "flash kernel and no conv launch"
                )
            grads[route] = {n: p.grad for n, p in model.named_parameters()}
            del model, trainer, state
        worst, ratios = flash_over_plain(grads)
        ratio, ratio_name = ratios[0][0], ratios[0][1]
        key = "packed" if packed else "unpacked"
        report[key] = {
            "loss_flash": losses["flash"], "loss_plain": losses["plain"],
            "loss_f32": losses["f32"],
            "loss_diff": abs(losses["flash"] - losses["plain"]), "loss_atol": LOSS_ATOL,
            "worst_grad_err_flash": worst["flash"], "worst_grad_err_plain": worst["plain"],
            "worst_flash_over_plain": [ratio_name, ratio, GRAD_RATIO],
            "top_ratios": ratios[:6],
        }
        emit({"phase": "plain_parity", "batch": key, **report[key]})
        if not all(math.isfinite(x) for x in losses.values()):
            raise AssertionError(f"non-finite loss {losses}")
        if report[key]["loss_diff"] > LOSS_ATOL:
            raise AssertionError(f"{key}: loss diff {report[key]['loss_diff']} > {LOSS_ATOL}")
        if ratio > GRAD_RATIO:
            raise AssertionError(
                f"{key}: gradient of {ratio_name} is {ratio}x further from f32 "
                f"than the plain path's (> {GRAD_RATIO})"
            )
        del grads
        torch.cuda.empty_cache()
    return report


def conv_inputs(shape, cout, seed):
    """bf16 x [N, H, W, C], kernel [3, 3, C, Cout] (scaled to keep y near
    unit size), cotangent g [N, H, W, Cout] and the dx kernel (flipped on
    (0, 1), transposed on (2, 3)), on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, h, w, c = shape
    x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    k = (torch.randn((3, 3, c, cout), generator=gen, device="cuda") / math.sqrt(9 * c)).bfloat16()
    g = torch.randn((n, h, w, cout), generator=gen, device="cuda").bfloat16()
    return x, k, g, k.flip(0, 1).transpose(2, 3).contiguous()


def check_conv_case(kernels, conv_bn, shape, cout, seed, worst) -> dict:
    """K4 forward, K4 as dx and K5 against their plain versions on one
    set of inputs, and K5 against itself on a rerun (bit-equal); keeps
    the worst (error / tolerance) per kernel in `worst` and raises on
    one out of tolerance."""
    x, k, g, k_flip = conv_inputs(shape, cout, seed)
    pairs = {
        "fwd": ("conv3x3_fwd", kernels.conv3x3_fwd(x, k), conv_bn.conv3x3_fwd_plain(x, k), KERNEL_RTOL),
        "dx": ("conv3x3_fwd", kernels.conv3x3_fwd(g, k_flip),
               conv_bn.conv3x3_fwd_plain(g, k_flip), KERNEL_RTOL),
        "dw": ("conv3x3_dw", kernels.conv3x3_dw(x, g), conv_bn.conv3x3_dw_plain(x, g), DW_RTOL),
    }
    # K5 sums its split-K partials in a fixed order: bit-equal on a rerun
    again = kernels.conv3x3_dw(x, g)
    torch.cuda.synchronize()
    case = {"shape": list(shape), "cout": cout,
            "fwd_plan": kernels.fwd_plan(*shape, cout)._asdict()}
    if not torch.equal(again, pairs["dw"][1]):
        raise AssertionError(f"conv3x3_dw {case}: two runs on the same inputs differ")
    for part, (name, got, want, rtol) in pairs.items():
        if got.shape != want.shape or got.dtype != want.dtype or not torch.isfinite(got).all():
            raise AssertionError(f"{name} ({part}) {case}: bad shape, dtype or non-finite")
        err = max_err(got, want)
        tol = rtol * max(1.0, want.float().abs().max().item())
        case[part] = [err, tol]
        if err > tol:
            raise AssertionError(f"{name} ({part}) {case}: error {err} > {tol}")
        if name not in worst or err / tol > worst[name][0] / worst[name][1]:
            worst[name] = (err, tol)
    return case


def check_conv_kernels(kernels, conv_bn) -> dict:
    """K4/K5 against their plain versions at the stage shapes (N=8) and
    the C != Cout cases; returns per kernel the worst case as (error,
    tolerance)."""
    worst = {}
    cases = [((CONV_CHECK_N, size, size, c), c) for size, c, _ in CONV_STAGES]
    for i, (shape, cout) in enumerate(cases + list(CONV_EXTRA_CASES)):
        emit({"phase": "conv_check", **check_conv_case(kernels, conv_bn, shape, cout, 10 + i, worst)})
    return worst


def conv_work(m: int, c: int, cout: int) -> dict:
    """(FLOP, bytes) of each function at one shape: each input read once
    and each output written once."""
    flop = 2 * m * 9 * c * cout
    return {
        "fwd": (flop, 2 * m * c + 2 * 9 * c * cout + 2 * m * cout),
        "dx": (flop, 2 * m * cout + 2 * 9 * c * cout + 2 * m * c),
        "dw": (flop, 2 * m * c + 2 * m * cout + 4 * 9 * c * cout),
    }


def k4_l2_request_bytes(kernels, shape, cout: int) -> int:
    """Bytes K4's TMA loads request at one shape, modelled from its plan
    (no counter measures them): each block requests, for each of its
    9 * C/64 steps, one x box (FWD_PIXELS rows of 128 bytes) and BN/64
    weight slabs of 64 rows of 128 bytes, served from L2 or HBM."""
    n, h, w, c = shape
    plan = kernels.fwd_plan(n, h, w, c, cout)
    step = (kernels.FWD_PIXELS + plan.bn) * 128
    return plan.boxes * (cout // plan.bn) * 9 * (c // 64) * step


def time_conv_kernels(kernels, conv_bn, worst) -> dict:
    """At each stage shape at N=256: the kernels against their plain
    versions once more (into `worst`), then the median ms of each kernel,
    its plain version and the cuDNN call on the same inputs, with the
    bound from these inputs. Returns the per-stage numbers and the
    per-step totals, weighted by each stage's launches."""
    grad = torch.nn.grad
    stages = []
    for i, (size, c, count) in enumerate(CONV_STAGES):
        shape = (RESNET_BATCH, size, size, c)
        case = check_conv_case(kernels, conv_bn, shape, c, 20 + i, worst)
        emit({"phase": "conv_check", **case})
        x, k, g, k_flip = conv_inputs(shape, c, 20 + i)
        x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)  # channels_last views
        w_oihw = k.permute(3, 2, 0, 1).contiguous()
        w_flip_oihw = k_flip.permute(3, 2, 0, 1).contiguous()
        timed = {
            "fwd": (lambda: kernels.conv3x3_fwd(x, k),
                    lambda: conv_bn.conv3x3_fwd_plain(x, k),
                    lambda: F.conv2d(x_nchw, w_oihw, padding=1)),
            "dx": (lambda: kernels.conv3x3_fwd(g, k_flip),
                   lambda: conv_bn.conv3x3_fwd_plain(g, k_flip),
                   lambda: F.conv2d(g_nchw, w_flip_oihw, padding=1)),
            "dw": (lambda: kernels.conv3x3_dw(x, g),
                   lambda: conv_bn.conv3x3_dw_plain(x, g),
                   lambda: grad.conv2d_weight(x_nchw, w_oihw.shape, g_nchw, padding=1)),
        }
        work = conv_work(RESNET_BATCH * size * size, c, c)
        entry = {"shape": list(shape), "cout": c, "launches_per_pass": count,
                 "fwd_plan": kernels.fwd_plan(*shape, c)._asdict()}
        for part, (kernel_fn, plain_fn, library_fn) in timed.items():
            flops, nbytes = work[part]
            op_ms = flops / PEAK_BF16_FLOPS * 1e3
            byte_ms = nbytes / PEAK_BYTES * 1e3
            entry[part] = {
                "ms": median_ms(kernel_fn),
                "plain_ms": median_ms(plain_fn, iters=5, warmup=1),
                "library_ms": median_ms(library_fn),
                "bound_ms": max(op_ms, byte_ms),
                "bound_by": "operations" if op_ms >= byte_ms else "bytes",
                "flop": flops, "bytes": nbytes,
            }
            entry[part]["tflops"] = flops / entry[part]["ms"] / 1e9
        # cuDNN's dgrad on the same inputs, beside the forward call on k_flip
        entry["dx"]["dgrad_ms"] = median_ms(
            lambda: grad.conv2d_input(x_nchw.shape, w_oihw, g_nchw, padding=1))
        # the L2 request rate K4's plan implies: modelled bytes over measured time
        entry["fwd"]["l2_request_bytes_modelled"] = k4_l2_request_bytes(kernels, shape, c)
        entry["fwd"]["l2_request_tb_per_s_modelled"] = (
            entry["fwd"]["l2_request_bytes_modelled"] / entry["fwd"]["ms"] / 1e9)
        emit({"phase": "conv_times", "dtype": "bfloat16",
              "library": "cuDNN via F.conv2d (fwd; dx on the flipped, transposed kernel) / "
                         "torch.nn.grad.conv2d_weight, bf16 channels_last", **entry})
        del x, k, g, k_flip, x_nchw, g_nchw, w_oihw, w_flip_oihw, timed
        torch.cuda.empty_cache()
        stages.append(entry)
    # per training step: K4 runs the forward and dx of each conv, K5 its dW
    parts = {"conv3x3_fwd": ("fwd", "dx"), "conv3x3_dw": ("dw",)}
    totals = {}
    for name, names in parts.items():
        totals[name] = {
            key: sum(st["launches_per_pass"] * st[part][key] for st in stages for part in names)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")
        }
        op = sum(st["launches_per_pass"] * st[part]["flop"] for st in stages for part in names)
        by = sum(st["launches_per_pass"] * st[part]["bytes"] for st in stages for part in names)
        totals[name]["bound_by"] = (
            "operations" if op / PEAK_BF16_FLOPS >= by / PEAK_BYTES else "bytes"
        )
    emit({"phase": "conv_times_per_step", "basis": "13 stride-1 3x3 convs per pass: "
          "K4 forward + dx, K5 dW, weighted 3/3/5/2 by stage", **totals})
    return {"stages": stages, "totals": totals}


def gpt_args(gpt_cli, steps: int, generate: int = 0, extra=()):
    """train/gpt.py's flags for `steps` timed steps after its warm-up step
    (its --steps is the total budget, the warm-up included), then `extra`."""
    b, s, _, _ = GPT_SHAPE
    return gpt_cli.parse_args([
        "--preset", "small", "--steps", str(steps + 1), "--batch-size", str(b),
        "--seq-len", str(s), "--learning-rate", "3e-4", "--log-every", "1",
        "--generate", str(generate), *extra,
    ])


def gpt_flop_per_token(model, seq: int) -> int:
    """The reference bench's causal count (model_benches.py:48-62):
    6 * P for the parameters' forward and backward, plus 6 * L * s * h for
    the attention products (causal: half of the dense 12)."""
    cfg = model.cfg
    params = sum(p.numel() for p in model.parameters())
    return 6 * params + 6 * cfg.num_layers * seq * cfg.hidden_size


def run_gpt(kernels, gpt_lib, gpt_cli, smi):
    """gpt_train: GPT-small through train/gpt.py at GPT_SHAPE, greedy
    generate after it; launch counts checked, loss must fall. Returns the
    launches, the summary and the trained model."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    summary, state = gpt_cli.train(gpt_args(gpt_cli, GPT_STEPS, GPT_NEW_TOKENS))
    model = state.model
    launches = dict(kernels.LAUNCHES)
    want = {k: 0 for k in launches}
    want["flash_fwd"] = LAYERS * summary["forward_passes"]
    want["flash_bwd_dkv"] = want["flash_bwd_dq"] = LAYERS * summary["backward_passes"]
    flop_per_token = gpt_flop_per_token(model, GPT_SHAPE[1])
    emit({"phase": "gpt_train", "model": "GPT-small", "shape": list(GPT_SHAPE),
          "card": smi, **{k: v for k, v in summary.items() if k != "generated"},
          "params": sum(p.numel() for p in model.parameters()),
          "model_flop_per_token": flop_per_token,
          "mfu": summary["tokens_per_sec"] * flop_per_token / PEAK_BF16_FLOPS,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "launches_expected": want})
    if launches != want:
        raise AssertionError(f"gpt launches {launches} != expected {want}")
    for key in ("loss", "eval_loss", "tokens_per_sec"):
        if not math.isfinite(summary[key]) or summary[key] <= 0:
            raise AssertionError(f"gpt_train {key} = {summary[key]}")
    if not summary["loss"] < summary["first_loss"]:
        raise AssertionError(
            f"gpt_train loss did not fall: {summary['first_loss']} -> {summary['loss']}"
        )
    return launches, summary, model


def teacher_forced(gpt_lib, model, chain) -> torch.Tensor:
    """GPTDecodeStep's logits [b, n, vocab] in f32 along `chain` [b, n]:
    position i's after consuming chain[:, i]."""
    b, n = chain.shape
    cache = gpt_lib.KVCache.zeros(model.cfg, b, n, chain.device)
    step = gpt_lib.GPTDecodeStep(model)
    return torch.stack([step(chain[:, i], i, cache).float() for i in range(n)], dim=1)


def first_difference(a: torch.Tensor, b: torch.Tensor):
    """(row, position) of the first token where two chains differ, or None."""
    diff = (a != b).nonzero()
    if not len(diff):
        return None
    return [int(x) for x in diff[diff[:, 1].argmin()]]


def gpt_generate(gpt_lib, model, summary) -> dict:
    """From gpt_train's model and its greedy chain (train/gpt.py
    --generate): (a) teacher-forced GPTDecodeStep logits against the
    training forward's at every position, atol/rtol DECODE_ATOL on f32
    views of the same weights (TF32 off), and reported in bf16; (b) the
    uniform path's chain (GPTPrefill, then one step per token) equal to
    the all-stepwise chain on the same prompt, in f32, and reported in
    bf16. No kernel runs in decode, as in the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    device = next(model.parameters()).device
    chain = torch.tensor(summary["generated"], device=device)
    b, total = chain.shape
    prompt = chain[:, :total - GPT_NEW_TOKENS]
    lens = torch.full((b,), prompt.shape[1], device=device)
    greedy = gpt_lib._sampler(0.0, 0, 1.0, None)
    model32 = f32_twin(gpt_lib, model, device)
    report = {"batch": b, "prompt": prompt.shape[1], "new_tokens": GPT_NEW_TOKENS,
              "ms_per_token_bf16": summary["generate_ms_per_token"]}
    chains = {}
    for name, m in (("f32", model32), ("bf16", model)):
        with torch.no_grad():
            prefill = gpt_lib.generate(m, prompt, GPT_NEW_TOKENS)
            stepwise = torch.cat([prompt[:, :1], gpt_lib._decode(
                m, prompt, lens, total, greedy, ragged=True)], dim=1)
        chains[name] = prefill
        report[f"chains_equal_{name}"] = bool(torch.equal(prefill, stepwise))
        report[f"first_difference_{name}"] = first_difference(prefill, stepwise)
    report["bf16_chain_equals_train_cli"] = bool(torch.equal(chains["bf16"], chain))
    # (a) along the f32 chain
    seq = chains["f32"]
    with torch.no_grad():
        train32 = model32(seq).float()
        step32 = teacher_forced(gpt_lib, model32, seq)
        train16 = model(seq).float()
        step16 = teacher_forced(gpt_lib, model, seq)
    err = (step32 - train32).abs()
    allowed = DECODE_ATOL + DECODE_RTOL * train32.abs()
    top2 = torch.topk(step32[:, prompt.shape[1] - 1:-1], 2, dim=-1).values
    report.update({
        "f32_decode_vs_train_max_abs": err.max().item(),
        "f32_decode_vs_train_worst_over_allowed": (err / allowed).max().item(),
        "atol": DECODE_ATOL, "rtol": DECODE_RTOL,
        "f32_min_top2_margin": (top2[..., 0] - top2[..., 1]).min().item(),
        "bf16_decode_vs_train_max_abs": (step16 - train16).abs().max().item(),
        "bf16_train_vs_f32_rel_l2": ((train16 - train32).norm() / train32.norm()).item(),
        "bf16_decode_vs_f32_rel_l2": ((step16 - train32).norm() / train32.norm()).item(),
        "bf16_decode_argmax_agrees": (step16.argmax(-1) == train16.argmax(-1)).float().mean().item(),
    })
    with torch.no_grad():
        report["decode_profile_bf16"] = profile_decode(gpt_lib, model, prompt)
    emit({"phase": "gpt_generate", **report})
    if not bool((err <= allowed).all()):
        raise AssertionError(f"teacher-forced decode logits differ from the training forward's: {report}")
    if not report["chains_equal_f32"]:
        raise AssertionError(f"the prefill and stepwise chains differ: {report}")
    del model32
    return report


def host_batch_ms(gpt_lib, trainer, cfg, reps: int = 5) -> dict:
    """What a training step's batch costs the host at GPT_SHAPE, apart
    from the step: median ms of drawing it (synthetic_batch) and of
    placing it on the idle card (place_batch, then a synchronize)."""
    gen = torch.Generator().manual_seed(11)
    draw, place = [], []
    for _ in range(reps):
        start = time.monotonic()
        batch = gpt_lib.synthetic_batch(gen, GPT_SHAPE[0], GPT_SHAPE[1], cfg)
        draw.append((time.monotonic() - start) * 1e3)
        torch.cuda.synchronize()
        start = time.monotonic()
        trainer.place_batch(batch)
        torch.cuda.synchronize()
        place.append((time.monotonic() - start) * 1e3)
    return {"synthetic_batch_ms": statistics.median(draw),
            "place_batch_ms": statistics.median(place)}


def profile_decode(gpt_lib, model, prompt, steps: int = 8, kv_quant_int8: bool = False) -> dict:
    """GPTDecodeStep plus the greedy argmax, as generate runs them, after
    a GPTPrefill of `prompt` and one warm-up step: the wall ms per token
    without the profiler, then, under torch.profiler, the device kernels
    launched per token, the device ms per token and the device's busy
    share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    b, p = prompt.shape
    cache = gpt_lib.KVCache.zeros(model.cfg, b, p + 2 * steps + 1, prompt.device, kv_quant_int8)
    step = gpt_lib.GPTDecodeStep(model)
    tok = gpt_lib.GPTPrefill(model)(prompt, cache).argmax(-1)
    tok = step(tok, p, cache).argmax(-1)
    torch.cuda.synchronize()
    start = time.monotonic()
    for i in range(steps):
        tok = step(tok, p + 1 + i, cache).argmax(-1)
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - start) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.monotonic()
        for i in range(steps):
            tok = step(tok, p + 1 + steps + i, cache).argmax(-1)
        torch.cuda.synchronize()
        profiled_ms = (time.monotonic() - start) * 1e3
    kernels = device_kernels(prof)
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {
        "decode_steps": steps,
        "wall_ms_per_token": wall_ms / steps,
        "profiled_wall_ms_per_token": profiled_ms / steps,
        "kernels_per_token": sum(e.count for e in kernels) / steps,
        "device_ms_per_token": device_us / 1e3 / steps,
        "device_busy_share": device_us / 1e3 / profiled_ms,
        "top": [{"kernel": e.key[:90], "calls_per_token": e.count / steps,
                 "ms_per_token": e.self_device_time_total / 1e3 / steps} for e in top],
    }


def gpt_parity(kernels, gpt_lib, trainer_lib) -> dict:
    """One GPT-small step at batch 1, seq GPT_SHAPE[1], from one set of
    weights through K1-K3, the plain bf16 route and an f32 plain step
    (TF32 off): losses within LOSS_ATOL, and each gradient no more than
    GRAD_RATIO times further from the f32 step than the plain bf16
    route's (plain_parity's criterion); the flash step launches each
    kernel once per layer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    seq = GPT_SHAPE[1]
    base = dataclasses.replace(gpt_lib.GPT_SMALL, max_seq_len=seq)
    plain = gpt_lib.plain_causal_attention
    routes = (
        ("flash", None, base),
        ("plain", plain, base),
        ("f32", plain, dataclasses.replace(base, dtype=torch.float32)),
    )
    batch = gpt_lib.synthetic_batch(torch.Generator().manual_seed(7), 1, seq, base)
    losses, grads = {}, {}
    for route, attention_fn, cfg in routes:
        model = gpt_lib.GPT(cfg, attention_fn, generator=torch.Generator().manual_seed(3))
        trainer = trainer_lib.Trainer(
            model, trainer_lib.causal_lm_task(), learning_rate=3e-4,
            weight_decay=0.01, device="cuda",
        )
        state = trainer.init()
        kernels.reset_launches()
        state, metrics = trainer.step(state, trainer.place_batch(batch))
        losses[route] = float(metrics["loss"])
        counts = dict(kernels.LAUNCHES)
        want = {k: 0 for k in counts}
        if route == "flash":
            want.update({k: LAYERS for k in FLASH_KERNELS})
        if counts != want:
            raise AssertionError(f"gpt_parity {route}: launches {counts} != {want}")
        grads[route] = {n: p.grad for n, p in model.named_parameters()}
        del model, trainer, state
        torch.cuda.empty_cache()
    worst, ratios = flash_over_plain(grads)
    report = {
        "batch": 1, "seq": seq, "losses": losses,
        "loss_diff": abs(losses["flash"] - losses["plain"]), "loss_atol": LOSS_ATOL,
        "worst_grad_err_flash": worst["flash"], "worst_grad_err_plain": worst["plain"],
        "worst_flash_over_plain": [ratios[0][1], ratios[0][0], GRAD_RATIO],
        "top_ratios": ratios[:6],
    }
    emit({"phase": "gpt_parity", **report})
    if not all(math.isfinite(x) for x in losses.values()):
        raise AssertionError(f"non-finite loss {losses}")
    if report["loss_diff"] > LOSS_ATOL:
        raise AssertionError(f"gpt loss diff {report['loss_diff']} > {LOSS_ATOL}")
    if ratios[0][0] > GRAD_RATIO:
        raise AssertionError(
            f"gradient of {ratios[0][1]} is {ratios[0][0]}x further from f32 "
            f"than the plain path's (> {GRAD_RATIO})"
        )
    del grads
    torch.cuda.empty_cache()
    return report


def run_gpt_phases(kernels, fa, gpt_lib, gpt_cli, trainer_lib, smi) -> dict:
    """Every GPT phase in order; returns what the kernels line needs."""
    gpt_worst = {}
    times = time_kernels(kernels, fa, gpt_worst, GPT_SHAPE, True,
                         "gpt_kernel_times", "gpt_kernel_check")
    rows = check_rows(kernels, fa, GPT_SHAPE, True, 2, "gpt_kernel_check")
    launches, summary, model = run_gpt(kernels, gpt_lib, gpt_cli, smi)
    gpt_generate(gpt_lib, model, summary)
    flop_per_token = gpt_flop_per_token(model, GPT_SHAPE[1])
    del model
    torch.cuda.empty_cache()

    # the reference bench's attention="xla" twin: plain causal attention
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    plain, _ = gpt_cli.train(gpt_args(gpt_cli, GPT_STEPS),
                             attention_fn=gpt_lib.plain_causal_attention)
    if any(kernels.LAUNCHES.values()):
        raise AssertionError(f"the plain GPT route launched a kernel: {kernels.LAUNCHES}")
    emit({"phase": "gpt_train_plain", "card": smi, **plain,
          "mfu": plain["tokens_per_sec"] * flop_per_token / PEAK_BF16_FLOPS,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    if not math.isfinite(plain["loss"]):
        raise AssertionError(f"gpt_train_plain loss {plain['loss']}")
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(gpt_lib.GPT_SMALL, max_seq_len=GPT_SHAPE[1])
    model = gpt_lib.GPT(cfg, generator=torch.Generator().manual_seed(5))
    trainer = trainer_lib.Trainer(
        model, trainer_lib.causal_lm_task(), learning_rate=3e-4,
        weight_decay=0.01, device="cuda",
    )
    batch = gpt_lib.synthetic_batch(
        torch.Generator().manual_seed(6), GPT_SHAPE[0], GPT_SHAPE[1], cfg
    )
    profile_training("gpt_profile", trainer, batch, "flash", FLASH_KERNEL_SYMBOLS,
                     {"model": "GPT-small", "shape": list(GPT_SHAPE)})
    emit({"phase": "gpt_host_batch", **host_batch_ms(gpt_lib, trainer, cfg),
          "train_batch_ms_per_step": summary["batch_seconds"] * 1e3 / GPT_STEPS,
          "train_ms_per_step": summary["seconds"] * 1e3 / GPT_STEPS})
    del model, trainer, batch
    torch.cuda.empty_cache()

    gpt_parity(kernels, gpt_lib, trainer_lib)
    return {"times": times, "worst": gpt_worst, "rows": rows, "launches": launches,
            "summary": summary}


def resnet_flop_per_image(resnet_lib) -> int:
    """Training FLOP per 224x224 image of ResNet-50, counted from its
    layer shapes: 2 per multiply-add of every conv and the Dense in the
    forward, times 3 for forward and backward (recomputation none)."""
    model = resnet_lib.ResNet50(conv3_impl="xla").cuda()
    macs = []

    def hook(module, inputs, output):
        if isinstance(module, torch.nn.Linear):
            macs.append(module.in_features * module.out_features)
        else:  # an OIHW conv: I * kh * kw multiply-adds per output value
            macs.append(output[0].numel() * module.weight[0].numel())

    handles = [
        m.register_forward_hook(hook) for m in model.modules()
        if isinstance(m, (resnet_lib.Conv, torch.nn.Linear))
    ]
    model.eval()
    with torch.no_grad():
        model(torch.zeros((1, RESNET_IMAGE, RESNET_IMAGE, 3), device="cuda"))
    for handle in handles:
        handle.remove()
    return 3 * 2 * sum(macs)


def resnet_args(resnet_cli, conv3_impl: str):
    return resnet_cli.parse_args([
        "--steps", "6", "--per-chip-batch", str(RESNET_BATCH),
        "--image-size", str(RESNET_IMAGE), "--learning-rate", "0.1",
        "--conv3-impl", conv3_impl, "--log-every", "1",
    ])


def profile_resnet(resnet_lib, trainer_lib, conv3_impl: str) -> None:
    """Device time of two ResNet-50 training steps by kernel and by kind
    of kernel, and K4/K5's share of it."""
    model = resnet_lib.ResNet50(conv3_impl=conv3_impl, generator=torch.Generator().manual_seed(5))
    trainer = trainer_lib.Trainer(
        model, trainer_lib.classification_task(), learning_rate=0.1,
        device="cuda", optimizer="sgd",
    )
    batch = resnet_lib.synthetic_batch(torch.Generator().manual_seed(6), RESNET_BATCH, RESNET_IMAGE)
    profile_training("resnet_profile", trainer, batch, "conv3x3", CONV_KERNEL_SYMBOLS,
                     {"conv3_impl": conv3_impl, "batch": RESNET_BATCH})


def xla_to_pallas(state: dict) -> dict:
    """A conv3_impl="xla" ResNet state_dict for the "pallas" model: the
    Conv_1 weights OIHW -> PallasConv3x3's HWIO kernel."""
    out = {}
    for name, value in state.items():
        if name.endswith("Conv_1.weight"):
            out[name[: -len("weight")] + "kernel"] = value.permute(2, 3, 1, 0).contiguous()
        else:
            out[name] = value
    return out


def grads_as_xla(model) -> dict:
    """Each parameter's gradient under its conv3_impl="xla" name and layout."""
    out = {}
    for name, param in model.named_parameters():
        g = param.grad
        if name.endswith("Conv_1.kernel"):
            name, g = name[: -len("kernel")] + "weight", g.permute(3, 2, 0, 1)
        out[name] = g
    return out


def resnet_parity(kernels, resnet_lib, trainer_lib) -> dict:
    """One SGD step from the same weights and batch (N=32, 224x224)
    through K4/K5 ("pallas"), the torch conv in bf16 ("xla") and the
    torch conv in f32 with TF32 off ("f32"). The BatchNorm scales are
    drawn around 1 first: at init the last BN of each block has scale 0,
    which zeroes every gradient inside the residual branches, K4's dx
    and K5's dW included. Checks: the pallas step launches 13 K4 per pass
    and 13 K5; losses within LOSS_ATOL; each parameter's gradient and
    each BN running statistic no more than GRAD_RATIO times further
    (relative L2, floor GRAD_FLOOR) from the f32 step than the xla bf16
    step's; one evaluate in eval mode, finite."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(8)
    base = resnet_lib.ResNet50(conv3_impl="xla", generator=gen)
    with torch.no_grad():
        for module in base.modules():
            if isinstance(module, resnet_lib.TpuBatchNorm):
                module.scale.uniform_(0.5, 1.5, generator=gen)
    xla_state = base.state_dict()
    batch = resnet_lib.synthetic_batch(
        torch.Generator().manual_seed(9), RESNET_PARITY_BATCH, RESNET_IMAGE
    )
    routes = (
        ("pallas", dict(conv3_impl="pallas"), xla_to_pallas(xla_state)),
        ("xla", dict(conv3_impl="xla"), xla_state),
        ("f32", dict(conv3_impl="xla", dtype=torch.float32), xla_state),
    )
    losses, grads, stats = {}, {}, {}
    pallas_eval = None
    for route, kwargs, state_dict in routes:
        model = resnet_lib.ResNet50(**kwargs)
        model.load_state_dict(state_dict)
        trainer = trainer_lib.Trainer(
            model, trainer_lib.classification_task(), learning_rate=0.1,
            device="cuda", optimizer="sgd",
        )
        state = trainer.init()
        placed = trainer.place_batch(batch)
        kernels.reset_launches()
        state, metrics = trainer.step(state, placed)
        losses[route] = float(metrics["loss"])
        counts = dict(kernels.LAUNCHES)
        want = {k: 0 for k in counts}
        if route == "pallas":
            want.update(conv3x3_fwd=2 * CONVS_PER_PASS, conv3x3_dw=CONVS_PER_PASS)
        if counts != want:
            raise AssertionError(f"resnet_parity {route}: launches {counts} != {want}")
        grads[route] = grads_as_xla(model)
        stats[route] = {n: b.clone() for n, b in model.named_buffers()}
        if route == "pallas":
            pallas_eval = {k: float(v) for k, v in trainer.evaluate(state, placed).items()}
        del model, trainer, state
    torch.cuda.empty_cache()

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()

    report = {"losses": losses, "loss_diff": abs(losses["pallas"] - losses["xla"]),
              "loss_atol": LOSS_ATOL, "eval_pallas": pallas_eval}
    for kind, table in (("grad", grads), ("stat", stats)):
        ratios = sorted(
            ((rel(table["pallas"][n], table["f32"][n]) / max(rel(table["xla"][n], table["f32"][n]), GRAD_FLOOR),
              n, rel(table["pallas"][n], table["f32"][n]), rel(table["xla"][n], table["f32"][n]))
             for n in table["f32"]),
            reverse=True,
        )
        report[f"worst_{kind}_pallas_over_xla"] = [ratios[0][1], ratios[0][0], GRAD_RATIO]
        report[f"worst_{kind}_err_pallas"] = max(r[2] for r in ratios)
        report[f"worst_{kind}_err_xla"] = max(r[3] for r in ratios)
        report[f"top_{kind}_ratios"] = ratios[:5]
    emit({"phase": "resnet_parity", "batch": RESNET_PARITY_BATCH, **report})
    if not all(math.isfinite(x) for x in losses.values()):
        raise AssertionError(f"non-finite loss {losses}")
    if report["loss_diff"] > LOSS_ATOL:
        raise AssertionError(f"resnet loss diff {report['loss_diff']} > {LOSS_ATOL}")
    for kind in ("grad", "stat"):
        name, ratio, _ = report[f"worst_{kind}_pallas_over_xla"]
        if ratio > GRAD_RATIO:
            raise AssertionError(
                f"{kind} of {name} is {ratio}x further from f32 than the xla path's"
            )
    if not all(math.isfinite(v) for v in pallas_eval.values()):
        raise AssertionError(f"non-finite evaluate {pallas_eval}")
    return report


def run_resnet(kernels, resnet_lib, resnet_cli, smi) -> dict:
    """resnet_train (pallas, launch counts checked) and resnet_train_xla."""
    flop_per_image = resnet_flop_per_image(resnet_lib)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    summary = resnet_cli.run(resnet_args(resnet_cli, "pallas"))
    launches = dict(kernels.LAUNCHES)
    want = {k: 0 for k in launches}
    want["conv3x3_fwd"] = CONVS_PER_PASS * (summary["forward_passes"] + summary["backward_passes"])
    want["conv3x3_dw"] = CONVS_PER_PASS * summary["backward_passes"]
    emit({"phase": "resnet_train", "model": "ResNet-50", "conv3_impl": "pallas",
          "batch": RESNET_BATCH, "image": RESNET_IMAGE, "card": smi, **summary,
          "model_flop_per_image": flop_per_image,
          "bench_flop_per_image": BENCH_FLOP_PER_IMAGE,
          "mfu": summary["images_per_sec"] * flop_per_image / PEAK_BF16_FLOPS,
          "mfu_bench_flop": summary["images_per_sec"] * BENCH_FLOP_PER_IMAGE / PEAK_BF16_FLOPS,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "launches_expected": want})
    if launches != want:
        raise AssertionError(f"resnet launches {launches} != expected {want}")
    for key in ("loss", "images_per_sec"):
        if not math.isfinite(summary[key]) or summary[key] <= 0:
            raise AssertionError(f"resnet_train {key} = {summary[key]}")
    torch.cuda.empty_cache()
    kernels_before = dict(kernels.LAUNCHES)
    xla = resnet_cli.run(resnet_args(resnet_cli, "xla"))
    if kernels.LAUNCHES != kernels_before:
        raise AssertionError("the xla route launched a conv kernel")
    emit({"phase": "resnet_train_xla", "conv3_impl": "xla", "card": smi, **xla,
          "mfu": xla["images_per_sec"] * flop_per_image / PEAK_BF16_FLOPS})
    if not math.isfinite(xla["loss"]):
        raise AssertionError(f"resnet_train_xla loss {xla['loss']}")
    torch.cuda.empty_cache()
    return launches


def rel_l2_worst(got: dict, want: dict) -> tuple:
    """(worst relative L2 distance over the tensors of two name -> tensor
    maps, its name); a tensor whose reference is zero counts its norm."""
    worst, where = 0.0, None
    for name, ref in want.items():
        norm = ref.float().norm().item()
        diff = (got[name].float() - ref.float()).norm().item()
        err = diff / norm if norm > 0 else diff
        if err > worst or where is None:
            worst, where = err, name
    return worst, where


def optimizer_tensors(optimizer) -> dict:
    """The optimizer's state tensors by (parameter index, key)."""
    sd = optimizer.state_dict()["state"]
    return {f"{index}.{key}": value for index, entry in sd.items()
            for key, value in entry.items() if torch.is_tensor(value)}


def lifecycle_args(gpt_cli, ckpt: str):
    b, s, _, _ = GPT_SHAPE
    return gpt_cli.parse_args([
        "--preset", "small", "--steps", str(LIFECYCLE_STEPS), "--batch-size", str(b),
        "--seq-len", str(s), "--learning-rate", "3e-4", "--log-every", "1",
        "--checkpoint-dir", ckpt, "--accum-steps", str(LIFECYCLE_ACCUM),
    ])


def check_lifecycle_launches(kernels, summary, phase: str) -> dict:
    launches = dict(kernels.LAUNCHES)
    want = {k: 0 for k in launches}
    want["flash_fwd"] = LAYERS * summary["forward_passes"]
    want["flash_bwd_dkv"] = want["flash_bwd_dq"] = LAYERS * summary["backward_passes"]
    if launches != want:
        raise AssertionError(f"{phase} launches {launches} != expected {want}")
    return launches


def run_lifecycle(kernels, gpt_lib, gpt_cli, trainer_lib, smi, gpt_summary,
                  workdir=None) -> dict:
    """lifecycle: GPT-small through train/gpt.py with --checkpoint-dir,
    --accum-steps 2 and --steps 6. A real SIGTERM after step 3 must give
    exit code 143 and a checkpoint at step 3; the restored tensors must be
    bit-equal to the ones in memory, and one step from each on one batch
    must agree (bit-equal expected: no kernel uses atomics); the rerun
    must resume at 3 and end at 6 with exit code 0. K1 launches 12 per
    microbatch forward and K2/K3 12 per microbatch backward (24 each per
    step at k = 2). Also: save (blocking, async) and restore ms and bytes,
    peak memory of one step at k = 1 and k = 2, and the k = 2 gradient
    against the k = 1 gradient from the same weights. With a workdir the
    checkpoint stays there (workdir/ckpt) for export_serve; the caller
    removes it."""
    import os
    import shutil
    import signal
    import tempfile

    tmp = workdir or tempfile.mkdtemp(prefix="lifecycle-")
    try:
        ckpt = os.path.join(tmp, "ckpt")

        def preempt(state):
            if state.step == LIFECYCLE_PREEMPT_AT:
                os.kill(os.getpid(), signal.SIGTERM)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        first, mem_state = gpt_cli.train(lifecycle_args(gpt_cli, ckpt), on_step=preempt)
        peak_cli_k2 = torch.cuda.max_memory_allocated() / 1e9
        launches_first = check_lifecycle_launches(kernels, first, "lifecycle (preempted run)")
        saved = trainer_lib.Checkpointer(ckpt).latest_step()
        if first["exit_code"] != 143 or first["step"] != LIFECYCLE_PREEMPT_AT or saved != LIFECYCLE_PREEMPT_AT:
            raise AssertionError(
                f"preempted run: exit code {first['exit_code']}, step {first['step']}, "
                f"checkpoint {saved}; want 143, {LIFECYCLE_PREEMPT_AT}, {LIFECYCLE_PREEMPT_AT}"
            )
        per_step = {k: v / first["step"] for k, v in launches_first.items() if v}
        if per_step != {k: LAYERS * LIFECYCLE_ACCUM for k in FLASH_KERNELS}:
            raise AssertionError(f"lifecycle launches per step {per_step}")

        # restore into a model built from another seed: every tensor must
        # come back bit-equal to the in-memory state the checkpoint was saved from
        cfg = mem_state.model.cfg
        model = gpt_lib.GPT(cfg, generator=torch.Generator().manual_seed(7))
        restorer = trainer_lib.Trainer(
            model, trainer_lib.causal_lm_task(), learning_rate=3e-4, weight_decay=0.01,
            device="cuda", checkpoint_dir=ckpt, accum_steps=LIFECYCLE_ACCUM,
        )
        fresh = restorer.init()
        torch.cuda.synchronize()
        start = time.monotonic()
        restored = restorer.restore(fresh)
        torch.cuda.synchronize()
        restore_ms = (time.monotonic() - start) * 1e3
        if restored is None or restored.step != LIFECYCLE_PREEMPT_AT:
            raise AssertionError(f"restore gave {restored and restored.step}")
        mismatched = [
            name for name, value in mem_state.model.state_dict().items()
            if not torch.equal(value, restored.model.state_dict()[name])
        ]
        mem_opt, res_opt = optimizer_tensors(mem_state.optimizer), optimizer_tensors(restored.optimizer)
        mismatched += [
            name for name, value in mem_opt.items()
            if not torch.equal(value.cpu(), res_opt[name].cpu())
        ]
        if mismatched or set(mem_opt) != set(res_opt):
            raise AssertionError(f"restored tensors differ from the saved ones: {mismatched[:5]}")

        # one step from each on one batch
        stepper = trainer_lib.Trainer(
            mem_state.model, trainer_lib.causal_lm_task(), learning_rate=3e-4,
            weight_decay=0.01, device="cuda", accum_steps=LIFECYCLE_ACCUM,
        )
        batch = stepper.place_batch(gpt_lib.synthetic_batch(
            torch.Generator().manual_seed(11), GPT_SHAPE[0], GPT_SHAPE[1], cfg))
        mem_state, mem_metrics = stepper.step(mem_state, batch)
        restored, res_metrics = restorer.step(restored, batch)
        mem_params = dict(mem_state.model.named_parameters())
        res_params = dict(restored.model.named_parameters())
        step_worst, step_where = rel_l2_worst(res_params, mem_params)
        step_bit_equal = all(torch.equal(mem_params[n], res_params[n]) for n in mem_params)
        if step_worst > RESUME_STEP_RTOL:
            raise AssertionError(f"step after restore differs: {step_worst} at {step_where}")

        # save and restore costs, into a directory of their own
        timing = trainer_lib.Checkpointer(os.path.join(tmp, "timing"))
        torch.cuda.synchronize()
        start = time.monotonic()
        timing.save(restored.step, restored, block=True)
        save_ms = (time.monotonic() - start) * 1e3
        write = dict(timing.last_write)
        start = time.monotonic()
        timing.save(restored.step + 1, restored, block=False)
        async_return_ms = (time.monotonic() - start) * 1e3
        start = time.monotonic()
        timing.wait()
        async_wait_ms = (time.monotonic() - start) * 1e3
        async_write_ms = timing.last_write["seconds"] * 1e3
        del mem_state, stepper, mem_params, res_params, mem_opt, res_opt
        torch.cuda.empty_cache()

        # the gradient at k = 2 against k = 1 from the same weights, and one
        # step's peak memory at each (learning rate 0: the weights stay put)
        grads, peaks = {}, {}
        for k in (1, LIFECYCLE_ACCUM):
            trainer = trainer_lib.Trainer(
                model, trainer_lib.causal_lm_task(), learning_rate=0.0,
                weight_decay=0.01, device="cuda", accum_steps=k,
            )
            state = trainer.init()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            trainer.step(state, batch)
            torch.cuda.synchronize()
            peaks[k] = {"peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "above_resident_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
            grads[k] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
            del trainer, state
        grad_worst, grad_where = rel_l2_worst(grads[LIFECYCLE_ACCUM], grads[1])
        del grads, restored, restorer, model
        torch.cuda.empty_cache()
        if grad_worst > ACCUM_GRAD_RTOL:
            raise AssertionError(f"k=2 gradient {grad_worst} from k=1 at {grad_where}")

        # the rerun resumes at step 3 and ends at 6
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        second, _ = gpt_cli.train(lifecycle_args(gpt_cli, ckpt))
        launches_second = check_lifecycle_launches(kernels, second, "lifecycle (resumed run)")
        final = trainer_lib.Checkpointer(ckpt).latest_step()
        if (second["exit_code"], second["start_step"], second["step"], final) != (
                0, LIFECYCLE_PREEMPT_AT, LIFECYCLE_STEPS, LIFECYCLE_STEPS):
            raise AssertionError(
                f"resumed run: exit code {second['exit_code']}, from {second['start_step']} "
                f"to {second['step']}, checkpoint {final}"
            )
        step_ms = second["seconds"] * 1e3 / second["steps"]
        train_step_ms = gpt_summary["seconds"] * 1e3 / gpt_summary["steps"]
        report = {
            "phase": "lifecycle", "model": "GPT-small", "shape": list(GPT_SHAPE), "card": smi,
            "accum_steps": LIFECYCLE_ACCUM, "preempted_exit_code": first["exit_code"],
            "checkpoint_after_sigterm": saved, "resumed_from": second["start_step"],
            "resumed_exit_code": second["exit_code"], "final_step": second["step"],
            "restored_bit_equal": True,
            "step_after_restore_bit_equal": step_bit_equal,
            "step_after_restore_worst_rel_l2": step_worst, "step_after_restore_worst_at": step_where,
            "loss_after_restore": [float(mem_metrics["loss"]), float(res_metrics["loss"])],
            "checkpoint_bytes": write["bytes"], "save_blocking_ms": save_ms,
            "save_blocking_write_ms": write["seconds"] * 1e3,
            "save_async_return_ms": async_return_ms, "save_async_wait_ms": async_wait_ms,
            "save_async_write_ms": async_write_ms, "restore_ms": restore_ms,
            "step_peak_memory_k1": peaks[1], "step_peak_memory_k2": peaks[LIFECYCLE_ACCUM],
            "cli_peak_memory_gb_k2": peak_cli_k2,
            "grad_k2_vs_k1_worst_rel_l2": grad_worst, "grad_k2_vs_k1_worst_at": grad_where,
            "launches_preempted_run": launches_first, "launches_resumed_run": launches_second,
            "launches_per_step": per_step,
            "tokens_per_sec_k2_pipeline": {"preempted_run": first["tokens_per_sec"],
                                           "resumed_run": second["tokens_per_sec"]},
            "ms_per_step_k2_pipeline": step_ms,
            "gpt_train_tokens_per_sec_k1_pipeline": gpt_summary["tokens_per_sec"],
            "gpt_train_ms_per_step_k1_pipeline": train_step_ms,
            "pr6_ms_per_step_host_loop": PR6_GPT_STEP_MS,
            "gpt_train_pipeline_producer_ms_per_step": gpt_summary["batch_seconds"] * 1e3 / gpt_summary["steps"],
            "gpt_train_pipeline_wait_ms_per_step": gpt_summary["wait_seconds"] * 1e3 / gpt_summary["steps"],
        }
        emit(report)
        return report
    finally:
        if workdir is None:
            shutil.rmtree(tmp, ignore_errors=True)


def free_device_memory() -> None:
    """Collect what the phase dropped (a trainer and its captured graphs
    hold each other) and hand the cached blocks back."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def profiled(fn, steps: int) -> dict:
    """Device ms per step, wall ms per step and the device's busy share
    of a window that runs fn() once (`steps` steps), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - start) * 1e3
    device_ms = sum(e.self_device_time_total for e in device_kernels(prof)) / 1e3
    return {"wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_ms / steps if device_ms else None,
            "device_busy_share": device_ms / wall_ms if device_ms else None}


def timed_ms(fn, steps: int) -> float:
    torch.cuda.synchronize()
    start = time.monotonic()
    fn()
    torch.cuda.synchronize()
    return (time.monotonic() - start) * 1e3 / steps


def graph_vs_eager(name, kernels, make_trainer, host_batch, want, items, unit, smi,
                   phase: str = "run_steps") -> dict:
    """RUN_STEPS steps of one model three ways from one seed on one batch:
    RUN_STEPS eager `step` calls, one run_steps(n=RUN_STEPS) (an eager
    warm-up step, the capture, RUN_STEPS - 1 replays), and RUN_STEPS
    run_steps(n=1) calls (the same graph, one replay each after the
    first), whose per-step losses are held against the eager ones. The
    graph's kernel launches per replay must be `want`. Then each path's
    ms per step, rate and device busy share at steady state."""
    eager = make_trainer()
    state = eager.init()
    batch = eager.place_batch(host_batch)
    eager_losses = []
    for _ in range(RUN_STEPS):
        state, metrics = eager.step(state, batch)
        eager_losses.append(float(metrics["loss"]))
    eager_params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    eager_buffers = {n: b.detach().clone() for n, b in state.model.named_buffers()}
    eager_ms = timed_ms(lambda: [eager.step(state, batch) for _ in range(RUN_STEPS)], RUN_STEPS)
    eager_profile = profiled(lambda: [eager.step(state, batch) for _ in range(2)], 2)
    del eager, state, metrics
    free_device_memory()

    graph = make_trainer()
    gstate = graph.init()
    kernels.reset_launches()
    gstate, gmetrics = graph.run_steps(gstate, batch, RUN_STEPS)
    captured = graph.last_graph
    if gstate.step != RUN_STEPS or captured is None or captured.replays != RUN_STEPS - 1:
        raise AssertionError(f"{name}: run_steps ran {gstate.step} steps, "
                             f"{captured and captured.replays} replays")
    per_replay = {k: v for k, v in captured.launches.items() if v}
    if per_replay != want:
        raise AssertionError(f"{name}: launches per replay {per_replay} != {want}")
    params = dict(gstate.model.named_parameters())
    worst, where = rel_l2_worst(params, eager_params)
    buffers = dict(gstate.model.named_buffers())
    stats_worst = rel_l2_worst(buffers, eager_buffers)[0] if buffers else 0.0
    bit_equal = all(torch.equal(params[n], eager_params[n]) for n in params)
    last_loss = float(gmetrics["loss"])
    graph_ms = timed_ms(lambda: graph.run_steps(gstate, batch, RUN_STEPS), RUN_STEPS)
    graph_profile = profiled(lambda: graph.run_steps(gstate, batch, 2), 2)
    # a captured launch counts once at capture: launches = count x replays
    replays = captured.replays
    graph_launches = {k: v * replays for k, v in per_replay.items()}
    del graph, gstate, gmetrics, captured, params, buffers
    free_device_memory()

    single = make_trainer()
    sstate = single.init()
    graph_losses = []
    for _ in range(RUN_STEPS):
        sstate, smetrics = single.run_steps(sstate, batch, 1)
        graph_losses.append(float(smetrics["loss"]))
    del single, sstate, smetrics
    free_device_memory()
    loss_rel = max(abs(g - e) / abs(e) for g, e in zip(graph_losses, eager_losses))
    report = {
        "phase": phase, "model": name, "card": smi, "steps": RUN_STEPS,
        "launches_per_replay": per_replay, "replays": replays,
        "graph_launches": graph_launches, "eager_losses": eager_losses,
        "graph_losses": graph_losses, "run_steps_last_loss": last_loss,
        "loss_worst_rel": loss_rel, "params_worst_rel_l2": worst, "params_worst_at": where,
        "bn_stats_worst_rel_l2": stats_worst, "params_bit_equal": bit_equal,
        "losses_bit_equal": graph_losses == eager_losses,
        "eager": {"ms_per_step": eager_ms, "steps_per_sec": 1e3 / eager_ms,
                  f"{unit}_per_sec": items * 1e3 / eager_ms, **eager_profile},
        "graph": {"ms_per_step": graph_ms, "steps_per_sec": 1e3 / graph_ms,
                  f"{unit}_per_sec": items * 1e3 / graph_ms, **graph_profile},
    }
    emit(report)
    if loss_rel > RUN_STEPS_LOSS_RTOL or abs(last_loss - eager_losses[-1]) > RUN_STEPS_LOSS_RTOL * abs(eager_losses[-1]):
        raise AssertionError(f"{name}: graph losses {graph_losses} vs eager {eager_losses}")
    if worst > RUN_STEPS_PARAM_RTOL or stats_worst > RUN_STEPS_PARAM_RTOL:
        raise AssertionError(f"{name}: parameters {worst} at {where}, BN statistics {stats_worst}")
    return report


def run_steps_phases(kernels, bert_lib, resnet_lib, trainer_lib, flash_attention, smi) -> dict:
    """run_steps: BERT-base (--flash --packed, 32 x 512) and ResNet-50
    (--conv3-impl pallas, batch 256), each with a warm-up-cosine schedule,
    through Trainer.run_steps' CUDA graph against eager steps."""

    def bert_trainer():
        model = bert_lib.BertForMLM(bert_lib.BERT_BASE, attention_fn=flash_attention,
                                    generator=torch.Generator().manual_seed(5))
        return trainer_lib.Trainer(
            model, trainer_lib.mlm_task(), weight_decay=0.01, packed=True, device="cuda",
            learning_rate=trainer_lib.warmup_cosine_lr(1e-4, 2 * RUN_STEPS, 2),
        )

    def resnet_trainer():
        model = resnet_lib.ResNet50(conv3_impl="pallas", generator=torch.Generator().manual_seed(5))
        return trainer_lib.Trainer(
            model, trainer_lib.classification_task(), optimizer="sgd", device="cuda",
            learning_rate=trainer_lib.warmup_cosine_lr(0.1, 2 * RUN_STEPS, 2),
        )

    bert_batch = bert_lib.synthetic_batch(
        torch.Generator().manual_seed(6), MAIN_SHAPE[0], MAIN_SHAPE[1], bert_lib.BERT_BASE)
    bert = graph_vs_eager(
        "BERT-base flash packed", kernels, bert_trainer, bert_batch,
        {name: LAYERS for name in FLASH_KERNELS}, MAIN_SHAPE[0] * MAIN_SHAPE[1], "tokens", smi)
    resnet_batch = resnet_lib.synthetic_batch(
        torch.Generator().manual_seed(6), RESNET_BATCH, RESNET_IMAGE)
    resnet = graph_vs_eager(
        "ResNet-50 pallas", kernels, resnet_trainer, resnet_batch,
        {"conv3x3_fwd": 2 * CONVS_PER_PASS, "conv3x3_dw": CONVS_PER_PASS},
        RESNET_BATCH, "images", smi)
    return {**bert["launches_per_replay"], **resnet["launches_per_replay"]}


def run_mnist_and_evaluator(mnist_cli, smi) -> dict:
    """mnist: train/mnist.py at the reference's recorded step count and
    global batch (MNIST_ACC.json: 1000 steps, 512) with
    --target-accuracy 0.99 and --checkpoint-dir; exit code 0 and held-out
    accuracy >= 0.99. eval_loop: the Evaluator replica watching that
    directory from its own process while the run trains, with
    --until-step 1000: one JSON line per step it evaluated, the last at
    step 1000."""
    import os
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="mnist-")
    evaluator = None
    try:
        ckpt, out = os.path.join(tmp, "ckpt"), os.path.join(tmp, "eval.jsonl")
        acc = os.path.join(tmp, "acc.json")
        os.makedirs(ckpt)
        with open(os.path.join(tmp, "evaluator.log"), "w") as log:
            evaluator = subprocess.Popen(
                [sys.executable, "-m", "tf_operator_tpu_torch.train.eval_loop", "--task", "mnist",
                 "--checkpoint-dir", ckpt, "--out", out, "--until-step", str(MNIST_STEPS),
                 "--poll-seconds", "0.2", "--batch-size", str(MNIST_BATCH)],
                stdout=log, stderr=subprocess.STDOUT,
            )
        start = time.monotonic()
        rc = mnist_cli.main([
            "--steps", str(MNIST_STEPS), "--batch-size", str(MNIST_BATCH),
            "--target-accuracy", "0.99", "--checkpoint-dir", ckpt, "--acc-json", acc,
            "--log-every", "250",
        ])
        wall = time.monotonic() - start
        with open(acc) as fh:
            artifact = json.load(fh)
        emit({"phase": "mnist", "card": smi, "exit_code": rc, "wall_seconds": wall, **artifact})
        if rc != 0 or artifact["eval_accuracy"] < 0.99:
            raise AssertionError(f"mnist: exit code {rc}, accuracy {artifact['eval_accuracy']}")
        evaluator_rc = evaluator.wait(timeout=EVALUATOR_TIMEOUT_S)
        with open(out) as fh:
            lines = [json.loads(line) for line in fh if line.strip()]
        steps = [line["step"] for line in lines]
        emit({"phase": "eval_loop", "card": smi, "exit_code": evaluator_rc,
              "evaluated_steps": steps, "lines": lines})
        if evaluator_rc != 0 or not steps or steps[-1] != MNIST_STEPS or steps != sorted(set(steps)):
            with open(os.path.join(tmp, "evaluator.log")) as fh:
                tail = fh.read()[-3000:]
            raise AssertionError(f"eval_loop: exit code {evaluator_rc}, steps {steps}\n{tail}")
        if not all(math.isfinite(line["loss"]) and 0 <= line["accuracy"] <= 1 for line in lines):
            raise AssertionError(f"eval_loop: bad lines {lines}")
        return {"mnist": artifact, "eval_steps": steps}
    finally:
        if evaluator is not None and evaluator.poll() is None:
            evaluator.kill()
            evaluator.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def run_profile_dir(bert_cli, smi) -> dict:
    """profile_dir: train/bert.py --flash --packed --profile-dir writes a
    Chrome trace of its first timed steps that names K1-K3."""
    import os
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="profile-")
    try:
        summary = bert_cli.run(bert_cli.parse_args([
            "--preset", "base", "--steps", "4", "--batch-size", str(MAIN_SHAPE[0]),
            "--seq-len", str(MAIN_SHAPE[1]), "--flash", "--packed", "--weight-decay", "0.01",
            "--profile-dir", tmp,
        ]))
        path = summary.get("trace_path")
        if not path or not os.path.isfile(path):
            raise AssertionError(f"no trace under {tmp}: {os.listdir(tmp)}")
        with open(path) as fh:
            text = fh.read()
        named = {symbol: text.count(symbol) for symbol in FLASH_KERNEL_SYMBOLS}
        emit({"phase": "profile_dir", "card": smi, "trace": os.path.basename(path),
              "trace_bytes": len(text), "kernel_name_mentions": named,
              "tokens_per_sec": summary["tokens_per_sec"]})
        if not all(named.values()):
            raise AssertionError(f"the trace does not name every flash kernel: {named}")
        return named
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- several processes: the bootstrap, DDP, FSDP2 and sync BN -----------------
#
# One card allows three kinds of world: two ranks on cuda:0 over gloo (NCCL
# refuses two ranks on one device), whose collectives go through host memory;
# and one rank over NCCL, which runs the NCCL path and the kernels under the
# DDP and FSDP2 wrappers. Neither is a scaling measurement.


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def rank_env(rank: int, port: int, world: int = WORLD2) -> dict:
    """This process's env plus the identity the operator injects into a
    TPU replica's pods (controller/cluster_spec.py set_tpu_env), with the
    coordinator mapped to 127.0.0.1 as the hermetic E2Es map it."""
    import os

    env = dict(os.environ)
    env.update({
        "TPU_WORKER_ID": str(rank),
        "TPU_WORKER_HOSTNAMES": ",".join(f"worker-{i}.default.svc" for i in range(world)),
        "JAX_NUM_PROCESSES": str(world),
        "JAX_PROCESS_ID": str(rank),
        "TFJOB_COORDINATOR_OVERRIDE": f"127.0.0.1:{port}",
    })
    return env


def run_world(argv: list, logs_dir: str, timeout: float, world: int = WORLD2) -> list:
    """`world` processes of `argv` with rank_env; each one's output. A launch
    in which a rank fails is tried once more on a fresh port (another
    process may take the picked port before the coordinator binds it); a
    fault of the program fails both attempts, and the error names each
    rank's exit code ("timeout" for one that outlived `timeout`, as a rank
    in a hung collective does) beside its output's tail. Every process is
    ended."""
    import os

    tails = []
    for attempt in range(2):
        port = free_port()
        procs = []
        try:
            for rank in range(world):
                log = open(os.path.join(logs_dir, f"a{attempt}-rank{rank}.log"), "w")
                procs.append((subprocess.Popen(
                    # a crash in native code prints the Python stack of each thread
                    [sys.executable, "-X", "faulthandler"] + argv,
                    env=rank_env(rank, port, world), stdout=log, stderr=subprocess.STDOUT,
                ), log))
            deadline = time.monotonic() + timeout
            codes = []
            for proc, _ in procs:
                try:
                    codes.append(proc.wait(timeout=max(deadline - time.monotonic(), 1)))
                except subprocess.TimeoutExpired:
                    codes.append("timeout")
        finally:
            for proc, log in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        texts = [open(log.name).read() for _, log in procs]
        if codes == [0] * world:
            return texts
        tails.append({"codes": codes, "tails": {
            f"rank {rank} ({code})": text[-3000:]
            for rank, (code, text) in enumerate(zip(codes, texts))}})
    raise AssertionError(f"world of {world} running {argv}: {json.dumps(tails)}")


def run_rendezvous(smi: str, logs_dir: str) -> dict:
    """rendezvous: the port's rendezvous worker, then train/smoke.py (each
    entry point's main(), one after the other in the same two processes:
    one launch), as two ranks on cuda:0 over gloo with the operator's env
    names set by hand: each rank's torch.distributed rank and world size
    equal the injected identity, an all-gather of the ranks' ids on the
    card gives [0, 1], and the all-reduce of (rank + 1) x a bf16-matmul
    unit is 3."""
    code = ("import sys\n"
            "from tf_operator_tpu_torch.testing import rendezvous_worker\n"
            "from tf_operator_tpu_torch.train import smoke\n"
            "args = ['--device', 'cuda', '--backend', 'gloo']\n"
            "sys.exit(rendezvous_worker.main(args) or smoke.main(args))\n")
    texts = run_world(["-c", code], logs_dir, 180)
    reports = []
    for rank, text in enumerate(texts):
        lines = [line for line in text.splitlines() if line.startswith("RENDEZVOUS ")]
        if not lines:
            raise AssertionError(f"rank {rank} printed no RENDEZVOUS line: {text[-2000:]}")
        report = json.loads(lines[-1].split(" ", 1)[1])
        reports.append(report)
        if not (report["ok"] and report["process_index"] == rank
                and report["gathered_world"] == list(range(WORLD2))
                and f"process {rank}/{WORLD2}" in text):
            raise AssertionError(f"rank {rank}: {report}")
    sums = [line.split("collective ", 1)[1] for text in texts for line in text.splitlines()
            if "collective sum=" in line]
    emit({"phase": "rendezvous", "card": smi, "world": WORLD2, "backend": "gloo",
          "device": "cuda:0 (both ranks)", "reports": reports, "smoke": sums})
    if len(sums) != WORLD2 or not all(s.endswith("-> OK") for s in sums):
        raise AssertionError(f"smoke: {sums}")
    return {"reports": reports, "smoke": sums}


def dist_bert(mesh=None, rules=None, f32=False):
    """BERT-base MLM (--flash --packed, AdamW 1e-4 wd 0.01) from one seed
    and its global batch (MAIN_SHAPE's 32 x 512); f32: the same model in
    f32 on plain attention (plain_parity's f32 route)."""
    from tf_operator_tpu_torch.models import bert as bert_lib
    from tf_operator_tpu_torch.ops.flash_attention import flash_attention
    from tf_operator_tpu_torch.train import trainer as trainer_lib

    cfg = bert_lib.BERT_BASE
    model = built_from(lambda: bert_lib.BertForMLM(
        dataclasses.replace(cfg, dtype=torch.float32) if f32 else cfg,
        attention_fn=None if f32 else flash_attention),
        seeded_weights(bert_lib.BertForMLM, cfg, DIST_SEED), "cpu")
    extra = {} if rules is None else {"rules": rules}
    trainer = trainer_lib.Trainer(model, trainer_lib.mlm_task(), learning_rate=1e-4,
                                  weight_decay=0.01, packed=True, device="cuda", mesh=mesh, **extra)
    batch = bert_lib.synthetic_batch(torch.Generator().manual_seed(DIST_BATCH_SEED),
                                     MAIN_SHAPE[0], MAIN_SHAPE[1], cfg)
    return trainer, batch


def dist_gpt_model():
    from tf_operator_tpu_torch.models import gpt as gpt_lib

    cfg = dataclasses.replace(gpt_lib.GPT_SMALL, max_seq_len=GPT_SHAPE[1])
    return seeded(gpt_lib.GPT, cfg, DIST_SEED)


def dist_gpt(model, mesh=None, checkpoint_dir=None):
    """GPT-small (causal flash, AdamW 3e-4 wd 0.01) and its global batch
    (GPT_SHAPE's 4 x 4096)."""
    from tf_operator_tpu_torch.models import gpt as gpt_lib
    from tf_operator_tpu_torch.train import trainer as trainer_lib

    trainer = trainer_lib.Trainer(model, trainer_lib.causal_lm_task(), learning_rate=3e-4,
                                  weight_decay=0.01, device="cuda", mesh=mesh,
                                  checkpoint_dir=checkpoint_dir)
    batch = gpt_lib.synthetic_batch(torch.Generator().manual_seed(DIST_BATCH_SEED),
                                    GPT_SHAPE[0], GPT_SHAPE[1], model.cfg)
    return trainer, batch


def dist_resnet(mesh=None, f32=False):
    """ResNet-50 (--conv3-impl pallas, bf16, SGD 0.1 momentum 0.9, BN
    scales drawn around 1 as in resnet_parity) and its global batch (256 x
    224^2, the second half SYNCBN_SHIFT'ed: another distribution from
    rank 0's); f32: the same weights in f32 on the torch conv
    (resnet_parity's f32 route)."""
    from tf_operator_tpu_torch.models import resnet as resnet_lib
    from tf_operator_tpu_torch.parallel.sharding import CONV_RULES
    from tf_operator_tpu_torch.train import trainer as trainer_lib

    gen = torch.Generator().manual_seed(DIST_SEED)
    base = resnet_lib.ResNet50(conv3_impl="xla", generator=gen)
    with torch.no_grad():
        for module in base.modules():
            if isinstance(module, resnet_lib.TpuBatchNorm):
                module.scale.uniform_(0.5, 1.5, generator=gen)
    if f32:
        model = resnet_lib.ResNet50(conv3_impl="xla", dtype=torch.float32)
        model.load_state_dict(base.state_dict())
    else:
        model = resnet_lib.ResNet50(conv3_impl="pallas")
        model.load_state_dict(xla_to_pallas(base.state_dict()))
    trainer = trainer_lib.Trainer(model, trainer_lib.classification_task(), learning_rate=0.1,
                                  device="cuda", optimizer="sgd", mesh=mesh, rules=CONV_RULES)
    batch = resnet_lib.synthetic_batch(torch.Generator().manual_seed(DIST_BATCH_SEED),
                                       RESNET_BATCH, RESNET_IMAGE)
    scale, shift = SYNCBN_SHIFT
    half = RESNET_BATCH // WORLD2
    batch["image"][half:] = scale * batch["image"][half:] + shift  # rank 1's rows differ
    return trainer, batch


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def worst_rel(got: dict, want: dict) -> list:
    """[name, relative L2] of the tensor of `got` furthest from `want`'s;
    the attention key bias, zero in exact arithmetic (plain_parity), is
    left out."""
    errors = {n: rel(got[n].to(want[n].device), want[n]) for n in want
              if not n.endswith("attention.key.bias")}
    return list(max(errors.items(), key=lambda kv: kv[1]))


def errors_from(got: dict, f32: dict) -> dict:
    """Each tensor's relative L2 distance from the f32 step's (the key
    bias left out, as in plain_parity)."""
    return {n: rel(got[n].to(f32[n].device), f32[n]) for n in f32
            if not n.endswith("attention.key.bias")}


def worst_ratio(world2: dict, one: dict) -> list:
    """plain_parity's criterion: [name, ratio, world 2's distance from
    f32, one process's] for the tensor whose world-2 distance from the
    f32 step is largest over the one-process bf16 step's (floor
    GRAD_FLOOR)."""
    return list(max(((n, world2[n] / max(one[n], GRAD_FLOOR), world2[n], one[n]) for n in one),
                    key=lambda row: row[1]))


def full_f32() -> None:
    """f32 matmuls and convs without TF32 (cuDNN's default uses it), as
    the f32 steps the several-process phases hold others to need."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def launches_per_step(kernels, steps: int) -> dict:
    return {name: count / steps for name, count in kernels.LAUNCHES.items()}


def rank_bert(work: str, kernels) -> dict:
    """ddp_bert's world-2 rank: DDP over the (dp=2) mesh, 16 rows a rank.
    Step 1's gradient (rank 0) against the one-process step's; then
    DIST_STEPS - 1 timed steps."""
    import os

    from tf_operator_tpu_torch.parallel import distributed
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    trainer, batch = dist_bert(build_mesh(MeshConfig(), "cuda"))
    state = trainer.init()
    placed = trainer.place_batch(batch)
    kernels.reset_launches()
    state, metrics = trainer.step(state, placed)
    out = {"loss": float(metrics["loss"]), "rows": int(placed["input_ids"].shape[0]),
           "wrapper": type(trainer.module).__name__}
    if distributed.is_coordinator():
        ref = torch.load(os.path.join(work, "bert_ref.pt"), map_location="cuda")
        out["worst_grad"] = worst_ratio(errors_from(
            {n: p.grad for n, p in state.model.named_parameters()}, ref["f32_grads"]),
            ref["one_errors"])
        del ref
    out["ms_per_step"] = timed_ms(
        lambda: [trainer.step(state, placed) for _ in range(DIST_STEPS - 1)], DIST_STEPS - 1)
    out["launches_per_step"] = launches_per_step(kernels, DIST_STEPS)
    return out


def sharded_rel(tensors: dict, want: dict) -> dict:
    """{name: relative L2 distance} of FSDP2-sharded tensors (DTensor
    shards of dim 0, as torch.chunk splits it) from full ones, each rank
    comparing its own shard and the sums all-reduced on the host, so no
    tensor is gathered (a DTensor gather over gloo with CUDA tensors
    crashes torch 2.11: the functional collectives under full_tensor())."""
    from tf_operator_tpu_torch.parallel import distributed
    from tf_operator_tpu_torch.parallel.sharding import local_tensor

    sums = {}
    for name, tensor in tensors.items():
        mine = local_tensor(tensor).float()
        ref = want[name].chunk(distributed.world_size(), dim=0)[distributed.rank()].float()
        if mine.shape != ref.shape:
            raise AssertionError(f"{name}: shard {tuple(mine.shape)} != {tuple(ref.shape)}")
        sums[f"{name}/diff"] = float((mine - ref).square().sum())
        sums[f"{name}/ref"] = float(ref.square().sum())
    sums = distributed.all_reduce_scalars(sums)
    return {name: math.sqrt(sums[f"{name}/diff"]) / max(math.sqrt(sums[f"{name}/ref"]), 1e-30)
            for name in tensors}


def rank_gpt(work: str, kernels) -> dict:
    """fsdp_gpt's world-2 rank: FSDP2 over the (fsdp=2) mesh, 2 rows a
    rank. Step 1's gradient against the one-process step's, step 2's loss,
    and the parameters after 2 steps against the one process's, each rank
    on its shards (sharded_rel)."""
    import os

    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    trainer, batch = dist_gpt(dist_gpt_model(), build_mesh(MeshConfig(fsdp=WORLD2), "cuda"))
    state = trainer.init()
    placed = trainer.place_batch(batch)
    kernels.reset_launches()
    state, metrics = trainer.step(state, placed)
    out = {"rows": int(placed["input_ids"].shape[0]), "losses": [float(metrics["loss"])],
           "sharded": type(state.model.layer_0.mlp_in.weight).__name__}
    ref = torch.load(os.path.join(work, "gpt_ref.pt"), map_location="cuda")
    grads = sharded_rel({n: p.grad for n, p in state.model.named_parameters()}, ref["grads"])
    out["worst_grad"] = list(max(((n, e) for n, e in grads.items()
                                  if not n.endswith("attention.key.bias")), key=lambda kv: kv[1]))
    start = time.monotonic()
    state, metrics = trainer.step(state, placed)
    out["losses"].append(float(metrics["loss"]))
    out["ms_step2"] = (time.monotonic() - start) * 1e3
    out["launches_per_step"] = launches_per_step(kernels, 2)
    params = dict(state.model.named_parameters())
    rels = sharded_rel(params, ref["params"])
    diff = math.sqrt(sum((rels[n] * float(ref["params"][n].float().norm())) ** 2 for n in rels))
    out["update_rel"] = diff / ref["update_norm"]
    return out


def unsynced_bn(model) -> None:
    """syncbn_resnet's first control: every TpuBatchNorm's sync group
    unset, so each rank normalises with its own rows' statistics."""
    from tf_operator_tpu_torch.models.norm import TpuBatchNorm

    for module in model.modules():
        if isinstance(module, TpuBatchNorm):
            module.sync_group = None


def sums_without_gradient(total, total_sq, count, group):
    """syncbn_resnet's second control, in place of norm._global_sums: the
    sums all-reduced by the non-differentiable collective, so the
    statistics are the global batch's but the backward is a per-rank
    BatchNorm's (the gradient of the other ranks' rows through the
    statistics is lost)."""
    import torch.distributed as dist

    channels = total.shape[0]
    local = torch.cat([total, total_sq, total.new_full((1,), float(count))])
    summed = local.detach().clone()
    dist.all_reduce(summed, group=group)
    summed = local + (summed - local.detach())
    return summed[:channels], summed[channels:2 * channels], summed[2 * channels]


def f32_readings(model, ref: dict) -> dict:
    """An f32 world-2 step against the one process's f32 step: the worst
    conv gradient (every 4-D weight) and the worst BN statistic."""
    convs = {n: g for n, g in grads_as_xla(model).items() if g.dim() == 4}
    return {"worst_conv_grad_rel": worst_rel(convs, {n: ref["f32_grads"][n] for n in convs}),
            "worst_stat_rel": worst_rel(dict(model.named_buffers()), ref["f32_stats"])}


def rank_resnet(work: str, kernels) -> dict:
    """syncbn_resnet's world-2 rank: DDP over the (dp=2) mesh with sync
    TpuBatchNorm, 128 images a rank. Step 1's gradient and BN running
    statistics (rank 0) against the one-process bf16 step's; then
    DIST_STEPS - 1 timed steps. Then one f32 step on the torch conv (TF32
    off) as built and under each control (unsynced_bn,
    sums_without_gradient), read against the one-process f32 step
    (f32_readings)."""
    import os

    from tf_operator_tpu_torch.models import norm as norm_lib
    from tf_operator_tpu_torch.parallel import distributed
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    ref = None
    if distributed.is_coordinator():
        ref = torch.load(os.path.join(work, "resnet_ref.pt"), map_location="cuda")
    trainer, batch = dist_resnet(build_mesh(MeshConfig(), "cuda"))
    state = trainer.init()
    placed = trainer.place_batch(batch)
    kernels.reset_launches()
    state, metrics = trainer.step(state, placed)
    out = {"loss": float(metrics["loss"]), "rows": int(placed["image"].shape[0]), "f32": {}}
    if ref is not None:
        grads = grads_as_xla(state.model)
        stats = dict(state.model.named_buffers())
        out["worst_grad"] = worst_ratio(errors_from(grads, ref["f32_grads"]),
                                        ref["one_grad_errors"])
        out["worst_stat"] = worst_ratio(errors_from(stats, ref["f32_stats"]),
                                        ref["one_stat_errors"])
        out["worst_stat_rel"] = worst_rel(stats, ref["one_stats"])
    out["ms_per_step"] = timed_ms(
        lambda: [trainer.step(state, placed) for _ in range(DIST_STEPS - 1)], DIST_STEPS - 1)
    out["launches_per_step"] = launches_per_step(kernels, DIST_STEPS)
    del trainer, state, placed
    free_device_memory()

    full_f32()
    for side in ("synced", "unsynced_bn", "sums_without_gradient"):
        trainer, batch = dist_resnet(build_mesh(MeshConfig(), "cuda"), f32=True)
        state = trainer.init()
        if side == "unsynced_bn":
            unsynced_bn(state.model)
        sums = norm_lib._global_sums
        if side == "sums_without_gradient":
            norm_lib._global_sums = sums_without_gradient
        try:
            state, metrics = trainer.step(state, trainer.place_batch(batch))
        finally:
            norm_lib._global_sums = sums
        out["f32"][side] = {"loss": float(metrics["loss"])}
        if ref is not None:
            out["f32"][side].update(f32_readings(state.model, ref))
        del trainer, state
        free_device_memory()
    return out


def world2_rank(work: str) -> int:
    """One rank of the world-2 phases (ddp_bert, fsdp_gpt, syncbn_resnet,
    then tp_gpt and sp_gpt), launched by run_distributed_phases as
    `chip_smoke.py --world2-rank <dir>` with the operator's env: the world
    over gloo on cuda:0, the one-process references read from <dir>,
    rank<r>.json written there."""
    import os

    from tf_operator_tpu_torch.ops import kernels
    from tf_operator_tpu_torch.parallel import distributed

    distributed.initialize("cuda", backend="gloo")
    try:
        out = {"rank": distributed.rank(), "world": distributed.world_size(),
               "ddp_bert": rank_bert(work, kernels)}
        free_device_memory()
        out["fsdp_gpt"] = rank_gpt(work, kernels)
        free_device_memory()
        out["syncbn_resnet"] = rank_resnet(work, kernels)
        free_device_memory()
        out["tp_gpt"] = rank_tp_gpt(work, kernels)
        out["sp_gpt"] = rank_sp_gpt(work, kernels)
        with open(os.path.join(work, f"rank{out['rank']}.json"), "w") as fh:
            json.dump(out, fh)
        distributed.barrier()
    finally:
        distributed.shutdown()
    return 0


def nccl_world_of_one() -> None:
    import torch.distributed as dist

    from tf_operator_tpu_torch.parallel.distributed import backend_for

    dist.init_process_group(backend_for("cuda"), init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)


def bert_world1(work: str, kernels) -> dict:
    """The one-process BERT-base step and the same step in f32 on plain
    attention (TF32 off): the f32 gradient and the one-process step's
    distance from it saved for the world-2 ranks; the one-process step
    under DDP in a one-rank NCCL world (bit-equal required: DDP's
    all-reduce over one rank is a copy and its division by the world size
    is by 1); DIST_STEPS timed steps of each, in turns, for DDP's cost at
    one rank, then a profile of DIST_STEPS of each (device ms, wall ms,
    busy share)."""
    import os

    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from tf_operator_tpu_torch.parallel.sharding import REPLICATED_RULES

    plain, batch = dist_bert()
    pstate = plain.init()
    placed = plain.place_batch(batch)
    pstate, metrics = plain.step(pstate, placed)
    loss = float(metrics["loss"])
    full_f32()
    f32, _ = dist_bert(f32=True)
    fstate, _ = f32.step(f32.init(), f32.place_batch(batch))
    f32_grads = {n: p.grad.detach() for n, p in fstate.model.named_parameters()}
    one_errors = errors_from({n: p.grad for n, p in pstate.model.named_parameters()}, f32_grads)
    torch.save({"f32_grads": {n: g.cpu() for n, g in f32_grads.items()},
                "one_errors": one_errors}, os.path.join(work, "bert_ref.pt"))
    del f32, fstate, f32_grads
    free_device_memory()
    ddp, _ = dist_bert(build_mesh(MeshConfig(), "cuda"), REPLICATED_RULES)
    dstate = ddp.init()
    dplaced = ddp.place_batch(batch)
    kernels.reset_launches()
    dstate, dmetrics = ddp.step(dstate, dplaced)
    launches = dict(kernels.LAUNCHES)
    pairs = list(zip(pstate.model.parameters(), dstate.model.parameters()))
    bit_equal = float(dmetrics["loss"]) == loss and all(torch.equal(a, b) for a, b in pairs)
    times = {"plain": [], "ddp": []}
    for _ in range(2):
        for name, trainer, state, b in (("plain", plain, pstate, placed),
                                        ("ddp", ddp, dstate, dplaced)):
            times[name].append(timed_ms(
                lambda: [trainer.step(state, b) for _ in range(DIST_STEPS)], DIST_STEPS))
    # where DDP's time goes: device ms (NCCL's copies, bucket copies) or host
    profiles = {
        name: profiled(lambda: [trainer.step(state, b) for _ in range(DIST_STEPS)], DIST_STEPS)
        for name, trainer, state, b in (("plain", plain, pstate, placed),
                                        ("ddp", ddp, dstate, dplaced))
    }
    tokens = MAIN_SHAPE[0] * MAIN_SHAPE[1]
    ms = {name: statistics.median(v) for name, v in times.items()}
    return {"loss_one_process": loss, "loss_ddp": float(dmetrics["loss"]), "bit_equal": bit_equal,
            "wrapper": type(ddp.module).__name__, "launches": launches,
            "ms_per_step": times, "tokens_per_sec": {k: tokens * 1e3 / v for k, v in ms.items()},
            "ddp_overhead_ms": ms["ddp"] - ms["plain"], "profile": profiles}


def gpt_world1(work: str, kernels) -> dict:
    """The one-process GPT-small: 2 steps (step 1's gradient, step 2's
    loss and the parameters saved for the world-2 ranks); the same 2 steps
    under FSDP2 (`shard` with TRANSFORMER_RULES) in a one-rank NCCL world,
    whose parameters after 2 steps must be within RESUME_STEP_RTOL of the
    one process's (the same kernels on the same rows; bit-equality
    reported); then a checkpoint saved under FSDP2 restored into a
    one-process trainer, bit-equal required."""
    import os

    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from tf_operator_tpu_torch.parallel.sharding import TRANSFORMER_RULES, shard
    from tf_operator_tpu_torch.train.trainer import state_payload

    start_params = {n: p.detach().clone() for n, p in dist_gpt_model().named_parameters()}
    plain, batch = dist_gpt(dist_gpt_model())
    pstate = plain.init()
    placed = plain.place_batch(batch)
    pstate, m1 = plain.step(pstate, placed)
    grads = {n: p.grad.detach().cpu() for n, p in pstate.model.named_parameters()}
    pstate, m2 = plain.step(pstate, placed)
    params = {n: p.detach().cpu() for n, p in pstate.model.named_parameters()}
    losses = [float(m1["loss"]), float(m2["loss"])]
    update_norm = math.sqrt(sum(float((params[n].double() - start_params[n].double()).square().sum())
                                for n in params))
    torch.save({"losses": losses, "grads": grads, "params": params, "update_norm": update_norm},
               os.path.join(work, "gpt_ref.pt"))
    del plain, pstate, grads, start_params
    free_device_memory()

    mesh = build_mesh(MeshConfig(), "cuda")
    ckpt = os.path.join(work, "gpt_ckpt")
    trainer, _ = dist_gpt(shard(dist_gpt_model().to("cuda"), mesh, TRANSFORMER_RULES), mesh, ckpt)
    state = trainer.init()
    sharded = type(state.model.layer_0.mlp_in.weight).__name__
    splaced = trainer.place_batch(batch)
    kernels.reset_launches()
    flosses = []
    for _ in range(2):
        state, metrics = trainer.step(state, splaced)
        flosses.append(float(metrics["loss"]))
    launches = launches_per_step(kernels, 2)
    payload = state_payload(state)
    worst = worst_rel(payload["model"], params)
    bit_equal = flosses == losses and all(torch.equal(payload["model"][n], params[n]) for n in params)
    trainer.save(state)
    one, _ = dist_gpt(dist_gpt_model(), checkpoint_dir=ckpt)
    restored = one.restore(one.init())
    back = state_payload(restored)
    flat = lambda p: {**{f"m.{k}": v for k, v in p["model"].items()},  # noqa: E731
                      **{f"o.{i}.{k}": v for i, e in p["optimizer"]["state"].items()
                         for k, v in e.items()}}
    got, want = flat(back), flat(payload)
    restore_equal = set(got) == set(want) and all(
        torch.equal(got[k].cpu(), want[k].cpu()) for k in want)
    return {"losses_one_process": losses, "losses_fsdp": flosses, "sharded": sharded,
            "launches_per_step": launches, "worst_param": worst, "bit_equal": bit_equal,
            "restored_step": restored.step, "restore_bit_equal": restore_equal}


def resnet_reference(work: str, kernels) -> dict:
    """The one-process ResNet-50 step (pallas, batch 256) and the same
    step in f32 on the torch conv (TF32 off): the one-process BN running
    statistics, the f32 gradient and statistics, and the one-process
    step's distance from those, saved for the world-2 ranks."""
    import os

    trainer, batch = dist_resnet()
    state = trainer.init()
    placed = trainer.place_batch(batch)
    kernels.reset_launches()
    state, metrics = trainer.step(state, placed)
    launches = dict(kernels.LAUNCHES)
    full_f32()
    f32, _ = dist_resnet(f32=True)
    fstate, fmetrics = f32.step(f32.init(), f32.place_batch(batch))
    f32_grads = grads_as_xla(fstate.model)
    f32_stats = dict(fstate.model.named_buffers())
    torch.save({
        "one_stats": {n: b.cpu() for n, b in state.model.named_buffers()},
        "f32_grads": {n: g.cpu() for n, g in f32_grads.items()},
        "f32_stats": {n: b.cpu() for n, b in f32_stats.items()},
        "one_grad_errors": errors_from(grads_as_xla(state.model), f32_grads),
        "one_stat_errors": errors_from(dict(state.model.named_buffers()), f32_stats),
    }, os.path.join(work, "resnet_ref.pt"))
    return {"loss": float(metrics["loss"]), "loss_f32": float(fmetrics["loss"]),
            "launches": launches}


def run_distributed_phases(kernels, smi: str) -> dict:
    """rendezvous, then ddp_bert, fsdp_gpt and syncbn_resnet, then tp_gpt
    and sp_gpt: each model's one-process step, the one-rank NCCL world
    (DDP for BERT-base, FSDP2 for GPT-small) in this process, the
    model-parallel phases' one-process sides (mp_reference), then one
    world of 2 ranks over gloo on cuda:0 (run_world, `--world2-rank`)
    that runs the three models' world-2 sides in turn, each rank on its
    rows of the same global batch, and then tp_gpt's and sp_gpt's. Returns
    each kernel's launches per step per rank at world 2 ("ddp_bert",
    "fsdp_gpt", "syncbn_resnet") and K1-K3's per pass per rank under
    tp = 2, ring sp = 2 and Ulysses sp = 2 ("tp2", "ring_sp2",
    "ulysses_sp2")."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    work = tempfile.mkdtemp(prefix="dist-")
    try:
        run_rendezvous(smi, work)
        nccl_world_of_one()
        try:
            bert1 = bert_world1(work, kernels)
            free_device_memory()
            gpt1 = gpt_world1(work, kernels)
            free_device_memory()
        finally:
            dist.destroy_process_group()
        resnet1 = resnet_reference(work, kernels)
        free_device_memory()
        mp1 = mp_reference(work, kernels)
        chain = torch.load(os.path.join(work, "mp_ref.pt"), weights_only=False)["chain"]
        free_device_memory()
        start = time.monotonic()
        run_world([__file__, "--world2-rank", work], work, DIST_TIMEOUT_S + MP_TIMEOUT_S)
        world_s = time.monotonic() - start
        ranks = [json.load(open(os.path.join(work, f"rank{r}.json"))) for r in range(WORLD2)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
        seeded_gpt.cache_clear()
    world2_label = ("two ranks sharing one card, collectives over gloo through host memory: "
                    "not a scaling number")
    out = {
        "ddp_bert": check_ddp_bert(bert1, [r["ddp_bert"] for r in ranks], smi, world2_label),
        "fsdp_gpt": check_fsdp_gpt(gpt1, [r["fsdp_gpt"] for r in ranks], smi, world2_label),
        "syncbn_resnet": check_syncbn_resnet(resnet1, [r["syncbn_resnet"] for r in ranks], smi,
                                             world2_label),
        "tp2": check_tp_gpt(mp1, chain, [r["tp_gpt"] for r in ranks], smi, world_s),
    }
    sp = check_sp_gpt(mp1, [r["sp_gpt"] for r in ranks], smi)
    out["ring_sp2"], out["ulysses_sp2"] = sp["ring"], sp["ulysses"]
    return out


def check_ddp_bert(one: dict, ranks: list, smi: str, label: str) -> dict:
    flash_want = {k: float(LAYERS) for k in FLASH_KERNELS}
    losses = [r["loss"] for r in ranks]
    emit({"phase": "ddp_bert", "card": smi, "model": "BERT-base MLM --flash --packed",
          "global_batch": MAIN_SHAPE[0], "seq": MAIN_SHAPE[1],
          "world1_nccl": one,
          "world2_gloo": {"label": label, "rows_per_rank": [r["rows"] for r in ranks],
                          "wrapper": ranks[0]["wrapper"], "losses": losses,
                          "loss_one_process": one["loss_one_process"],
                          "worst_grad_vs_one_process": ranks[0]["worst_grad"],
                          "ms_per_step": [r["ms_per_step"] for r in ranks],
                          "launches_per_step_per_rank": [r["launches_per_step"] for r in ranks]},
          "tolerances": {"loss_atol": LOSS_ATOL, "grad_ratio": GRAD_RATIO,
                         "grad_floor": GRAD_FLOOR, "why": DIST_TOLERANCE_WHY}})
    if not one["bit_equal"] or one["wrapper"] != "DistributedDataParallel":
        raise AssertionError(f"ddp_bert world 1: {one}")
    if any(one["launches"][k] != LAYERS for k in FLASH_KERNELS):
        raise AssertionError(f"ddp_bert world 1 launches {one['launches']}")
    for r in ranks:
        if any(r["launches_per_step"][k] != flash_want[k] for k in FLASH_KERNELS):
            raise AssertionError(f"ddp_bert world 2 launches {r['launches_per_step']}")
    if max(abs(x - one["loss_one_process"]) for x in losses) > LOSS_ATOL or len(set(losses)) != 1:
        raise AssertionError(f"ddp_bert world 2 losses {losses} vs {one['loss_one_process']}")
    if ranks[0]["worst_grad"][1] > GRAD_RATIO:
        raise AssertionError(f"ddp_bert world 2 gradient {ranks[0]['worst_grad']}")
    return {k: ranks[0]["launches_per_step"][k] for k in FLASH_KERNELS}


def check_fsdp_gpt(one: dict, ranks: list, smi: str, label: str) -> dict:
    world2 = {
        "label": label, "rows_per_rank": [r["rows"] for r in ranks],
        "sharded": ranks[0]["sharded"], "losses": [r["losses"] for r in ranks],
        "losses_one_process": one["losses_one_process"],
        "worst_grad_vs_one_process": ranks[0]["worst_grad"],
        "update_rel_vs_one_process": ranks[0]["update_rel"],
        "ms_step2": [r["ms_step2"] for r in ranks],
        "launches_per_step_per_rank": [r["launches_per_step"] for r in ranks]}
    emit({"phase": "fsdp_gpt", "card": smi, "model": "GPT-small causal flash",
          "shape": list(GPT_SHAPE), "rules": "TRANSFORMER_RULES",
          "world1_nccl_fsdp2": one, "world2_gloo_fsdp2": world2,
          "tolerances": {"loss_atol": LOSS_ATOL, "update_rtol": DIST_UPDATE_RTOL,
                         "param_rtol_world1": RESUME_STEP_RTOL, "why": DIST_TOLERANCE_WHY,
                         "why_update": DIST_UPDATE_WHY, "grad_rtol": FSDP_GRAD_RTOL,
                         "why_grad": "against the one process's bf16 gradient: an f32 step "
                                     "at 4 x 4096 on plain attention does not fit the card"}})
    if one["sharded"] != "DTensor" or one["worst_param"][1] > RESUME_STEP_RTOL:
        raise AssertionError(f"fsdp_gpt world 1: {one}")
    if not one["restore_bit_equal"] or one["restored_step"] != 2:
        raise AssertionError(f"fsdp_gpt checkpoint restore: {one}")
    if any(one["launches_per_step"][k] != LAYERS for k in FLASH_KERNELS):
        raise AssertionError(f"fsdp_gpt world 1 launches {one['launches_per_step']}")
    for r in ranks:
        if r["sharded"] != "DTensor" or any(
                r["launches_per_step"][k] != LAYERS for k in FLASH_KERNELS):
            raise AssertionError(f"fsdp_gpt world 2: {r}")
        for got, want in zip(r["losses"], one["losses_one_process"]):
            if abs(got - want) > LOSS_ATOL:
                raise AssertionError(f"fsdp_gpt world 2 losses {r['losses']}")
    if ranks[0]["worst_grad"][1] > FSDP_GRAD_RTOL:
        raise AssertionError(f"fsdp_gpt world 2 gradient: {ranks[0]['worst_grad']}")
    if ranks[0]["update_rel"] > DIST_UPDATE_RTOL:
        raise AssertionError(f"fsdp_gpt world 2 parameters: {ranks[0]['update_rel']}")
    return world2


def check_syncbn_resnet(one: dict, ranks: list, smi: str, label: str) -> dict:
    losses = [r["loss"] for r in ranks]
    want = {"conv3x3_fwd": 2.0 * CONVS_PER_PASS, "conv3x3_dw": float(CONVS_PER_PASS)}
    emit({"phase": "syncbn_resnet", "card": smi, "model": "ResNet-50 --conv3-impl pallas",
          "global_batch": RESNET_BATCH, "image": RESNET_IMAGE, "one_process": one,
          "world2_gloo": {"label": label, "rows_per_rank": [r["rows"] for r in ranks],
                          "losses": losses,
                          "halves": f"rows {RESNET_BATCH // WORLD2}-{RESNET_BATCH - 1} are "
                                    f"{SYNCBN_SHIFT[0]} x + {SYNCBN_SHIFT[1]} of their draw",
                          "worst_bn_stat_rel_vs_one_process": ranks[0]["worst_stat_rel"],
                          "worst_grad_ratio_vs_one_process": ranks[0]["worst_grad"],
                          "worst_bn_stat_ratio_vs_one_process": ranks[0]["worst_stat"],
                          "f32_vs_one_process_f32": ranks[0]["f32"],
                          "loss_f32_one_process": one["loss_f32"],
                          "ms_per_step": [r["ms_per_step"] for r in ranks],
                          "launches_per_step_per_rank": [r["launches_per_step"] for r in ranks]},
          "tolerances": {"loss_atol": LOSS_ATOL, "grad_and_stat_ratio": GRAD_RATIO,
                         "floor": GRAD_FLOOR, "why": DIST_TOLERANCE_WHY,
                         "stat_rtol": SYNCBN_STAT_RTOL, "f32_conv_grad_rtol": SYNCBN_F32_GRAD_RTOL,
                         "f32_stat_rtol": SYNCBN_F32_STAT_RTOL, "why_direct": SYNCBN_WHY}})
    for r in ranks:
        if any(r["launches_per_step"][k] != v for k, v in want.items()):
            raise AssertionError(f"syncbn_resnet launches {r['launches_per_step']}")
    if max(abs(x - one["loss"]) for x in losses) > LOSS_ATOL or len(set(losses)) != 1:
        raise AssertionError(f"syncbn_resnet losses {losses} vs {one['loss']}")
    for key in ("worst_grad", "worst_stat"):
        if ranks[0][key][1] > GRAD_RATIO:
            raise AssertionError(f"syncbn_resnet {key} {ranks[0][key]}")
    if ranks[0]["worst_stat_rel"][1] > SYNCBN_STAT_RTOL:
        raise AssertionError(f"syncbn_resnet BN statistics {ranks[0]['worst_stat_rel']}")
    f32 = ranks[0]["f32"]
    if not f32_within(f32["synced"]) or abs(f32["synced"]["loss"] - one["loss_f32"]) > LOSS_ATOL:
        raise AssertionError(f"syncbn_resnet f32 against the one process: {f32['synced']}")
    for name in ("unsynced_bn", "sums_without_gradient"):
        if f32_within(f32[name]):
            raise AssertionError(f"syncbn_resnet's f32 check passed the {name} control: {f32}")
    return {k: ranks[0]["launches_per_step"][k] for k in want}


def f32_within(readings: dict) -> bool:
    return (readings["worst_conv_grad_rel"][1] <= SYNCBN_F32_GRAD_RTOL
            and readings["worst_stat_rel"][1] <= SYNCBN_F32_STAT_RTOL)


# -- model parallel: tensor and sequence parallelism ----------------------------
#
# tp_gpt and sp_gpt run in the distributed phases' world of 2 ranks on cuda:0
# over gloo (`--world2-rank`), tp_sp_cli in a world of 4 (`chip_smoke.py
# --world-rank cli <dir>`): ranks sharing
# one card, their collectives through host memory, so no ms per step from
# them is a scaling number. Each rank's kernels run for real on its shard:
# under tp K1-K3 on its 3 of GPT-small's 6 heads, under Ulysses on 6 / 2 = 3
# heads at the full sequence after the all-to-all; the ring is plain torch
# (the reference's ring is a jnp fold with no kernel) and launches none.
MP_SHAPE = (2, 4096)  # GPT-small rows x seq for tp_gpt and sp_gpt
MP_TIMED_STEPS = 1
MP_TIMEOUT_S = 600
MP_VIT_BATCH = 32
MP_PROMPT_LEN = 8
MP_NEW_TOKENS = 16
MP_STRATEGIES = ("ring", "ulysses")
# tp_gpt's f32 step (TF32 off, plain attention, remat) against the one
# process's f32 step, each rank on its shards: the row-parallel all-reduce
# and the vocab-parallel loss re-associate sums, f32 roundings apart; a
# bias counted twice or a shard misplaced reads O(1)
MP_F32_GRAD_RTOL = 1e-3
CLI_WORLD = 4
CLI_STEPS = {"gpt": 3, "bert": 4}
MP_LABEL = ("ranks sharing one card, collectives over gloo through host memory: "
            "not a scaling number")


@functools.lru_cache(maxsize=2)
def seeded_gpt(f32: bool):
    """GPT-small at seq MP_SHAPE[1] on the CPU holding the weights drawn
    from DIST_SEED (seeded_weights: one draw a process, shared with
    dist_gpt_model); f32: its f32 twin with per-block remat (plain causal
    attention: flash_attention routes an f32 CUDA tensor there), the same
    weights (the compute dtype does not enter the draw)."""
    from tf_operator_tpu_torch.models import gpt as gpt_lib

    cfg = dataclasses.replace(gpt_lib.GPT_SMALL, max_seq_len=MP_SHAPE[1])
    weights = seeded_weights(gpt_lib.GPT, cfg, DIST_SEED)
    if f32:
        cfg = dataclasses.replace(cfg, dtype=torch.float32, remat=True)
    return built_from(lambda: gpt_lib.GPT(cfg), weights, "cpu")


def mp_gpt_model(attention_fn=None, f32: bool = False):
    """A copy of seeded_gpt(f32), its blocks attending with attention_fn
    where given (else the causal flash route)."""
    model = copy.deepcopy(seeded_gpt(f32))
    if attention_fn is not None:
        for block in model.blocks():
            block.attention.attention_fn = attention_fn
    return model


def mp_gpt(model, mesh=None, shard_sequence=False):
    """A GPT trainer (AdamW 3e-4 wd 0.01) and its global batch."""
    from tf_operator_tpu_torch.models import gpt as gpt_lib
    from tf_operator_tpu_torch.train import trainer as trainer_lib

    trainer = trainer_lib.Trainer(model, trainer_lib.causal_lm_task(), learning_rate=3e-4,
                                  weight_decay=0.01, device="cuda", mesh=mesh,
                                  shard_sequence=shard_sequence)
    batch = gpt_lib.synthetic_batch(torch.Generator().manual_seed(DIST_BATCH_SEED),
                                    MP_SHAPE[0], MP_SHAPE[1], model.cfg)
    return trainer, batch


def mp_vit(mesh=None):
    """ViT-B/16 (AdamW 1e-3 wd 0.05) and a batch of MP_VIT_BATCH."""
    from tf_operator_tpu_torch.models import vit as vit_lib
    from tf_operator_tpu_torch.train import trainer as trainer_lib

    model = vit_lib.ViT(vit_lib.VIT_B16, generator=torch.Generator().manual_seed(DIST_SEED))
    trainer = trainer_lib.Trainer(model, trainer_lib.classification_task(), learning_rate=1e-3,
                                  weight_decay=0.05, device="cuda", mesh=mesh)
    batch = vit_lib.synthetic_batch(torch.Generator().manual_seed(DIST_BATCH_SEED),
                                    MP_VIT_BATCH, vit_lib.VIT_B16)
    return trainer, batch


def collective_ms(fn) -> dict:
    """fn()'s wall ms and the host ms it spent inside the plans'
    collectives (parallel/distributed.py all_reduce, all_gather,
    all_to_all, ring_exchange), the card synchronized before each call so
    that the time is the exchange's own: gloo stages a CUDA tensor through
    host memory. DDP's gradient all-reduces run in its reducer, outside
    these."""
    from tf_operator_tpu_torch.parallel import distributed

    names = ("all_reduce", "all_gather", "all_to_all", "ring_exchange")
    originals = {name: getattr(distributed, name) for name in names}
    spent = dict.fromkeys(names, 0.0)
    calls = dict.fromkeys(names, 0)

    def timed(name, original):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.monotonic()
            try:
                return original(*args, **kwargs)
            finally:
                spent[name] += time.monotonic() - start
                calls[name] += 1
        return call

    for name in names:
        setattr(distributed, name, timed(name, originals[name]))
    try:
        wall = timed_ms(fn, 1)
    finally:
        for name, original in originals.items():
            setattr(distributed, name, original)
    return {"wall_ms": wall, "collective_ms": sum(spent.values()) * 1e3,
            "by_op_ms": {name: s * 1e3 for name, s in spent.items()}, "calls": calls}


def mp_reference(work: str, kernels) -> dict:
    """The one-process sides of tp_gpt and sp_gpt, TF32 off throughout:
    GPT-small's bf16 step, the same step in f32, the f32 greedy chain, and
    ViT-B/16's bf16 step, saved for the ranks."""
    import os

    from tf_operator_tpu_torch.models import gpt as gpt_lib

    full_f32()
    trainer, batch = mp_gpt(mp_gpt_model())
    state = trainer.init()
    kernels.reset_launches()
    placed = trainer.place_batch(batch)
    state, metrics = trainer.step(state, placed)
    one = {"loss": float(metrics["loss"]), "launches": dict(kernels.LAUNCHES)}
    grads = {n: p.grad.float().cpu() for n, p in state.model.named_parameters()}
    one["ms_per_step"] = timed_ms(
        lambda: [trainer.step(state, placed) for _ in range(MP_TIMED_STEPS)], MP_TIMED_STEPS)
    del trainer, state
    free_device_memory()
    trainer, _ = mp_gpt(mp_gpt_model(f32=True))
    state, metrics = trainer.step(trainer.init(), trainer.place_batch(batch))
    one["loss_f32"] = float(metrics["loss"])
    f32_grads = {n: p.grad.cpu() for n, p in state.model.named_parameters()}
    del trainer, state
    free_device_memory()
    model = mp_gpt_model(f32=True).to("cuda")
    prompt = batch["input_ids"][:, :MP_PROMPT_LEN]
    chain = gpt_lib.generate(model, prompt, MP_NEW_TOKENS).tolist()
    del model
    free_device_memory()
    trainer, vbatch = mp_vit()
    _, vmetrics = trainer.step(trainer.init(), trainer.place_batch(vbatch))
    one["vit_loss"] = float(vmetrics["loss"])
    del trainer
    free_device_memory()
    torch.save({"grads": grads, "f32_grads": f32_grads, "chain": chain, "prompt": prompt,
                **one}, os.path.join(work, "mp_ref.pt"))
    return one


def shard_of(name: str, full: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's slice of a full tensor by the tp plan."""
    from tf_operator_tpu_torch.parallel import sharding

    rule = sharding.tp_rule(name, sharding.TRANSFORMER_RULES.tp)
    if rule is None or mesh.shape["tp"] == 1:
        return full
    return full.chunk(mesh.shape["tp"], rule[0])[mesh.coordinate["tp"]]


def shard_readings(grads: dict, ref: dict, mesh, f32: bool = False) -> dict:
    """This rank's gradient shards against the one process's: the worst
    relative L2 against its bf16 (or, f32, its f32) gradient, and for
    bf16 plain_parity's ratio (each shard's distance from the f32 shard
    over the one-process bf16 shard's, floor GRAD_FLOOR); the attention
    key bias, zero in exact arithmetic, left out."""
    mine, one, f32_ref = {}, {}, {}
    for name, grad in grads.items():
        if name.endswith("attention.key.bias"):
            continue
        got = grad.float().cpu()
        want32 = shard_of(name, ref["f32_grads"][name], mesh)
        mine[name] = rel(got, want32)
        if f32:
            continue
        one[name] = rel(shard_of(name, ref["grads"][name], mesh), want32)
        f32_ref[name] = rel(got, shard_of(name, ref["grads"][name], mesh))
    if f32:
        return {"worst_f32_rel": list(max(mine.items(), key=lambda kv: kv[1]))}
    return {"worst_ratio": worst_ratio(mine, one),
            "worst_rel_vs_one_bf16": list(max(f32_ref.items(), key=lambda kv: kv[1]))}


def mp_step(kernels, trainer, batch, timed: bool = True) -> tuple:
    """Step 1 with its K1-K3 launches (one forward and one backward pass),
    then MP_TIMED_STEPS timed steps and one step with its collectives
    timed (collective_ms); the state and the readings."""
    state = trainer.init()
    placed = trainer.place_batch(batch)
    kernels.reset_launches()
    state, metrics = trainer.step(state, placed)
    out = {"loss": float(metrics["loss"]),
           "launches_per_pass": {k: kernels.LAUNCHES[k] for k in FLASH_KERNELS}}
    if "input_ids" in placed:
        out["rows"], out["positions"] = placed["input_ids"].shape
    if timed:
        grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
        out["ms_per_step"] = timed_ms(
            lambda: [trainer.step(state, placed) for _ in range(MP_TIMED_STEPS)], MP_TIMED_STEPS)
        out["collectives"] = collective_ms(lambda: trainer.step(state, placed))
        return state, out, grads
    return state, out, {n: p.grad for n, p in state.model.named_parameters()}


def rank_tp_gpt(work: str, kernels) -> dict:
    """tp_gpt's world-2 rank: GPT-small at tp = 2 (3 heads of 128 a rank)
    in bf16 and in f32, ViT-B/16 at tp = 2, and generate(mesh=) at f32."""
    import os

    from tf_operator_tpu_torch.models import gpt as gpt_lib
    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    mesh = build_mesh(MeshConfig(tp=WORLD2), "cuda")
    ref = torch.load(os.path.join(work, "mp_ref.pt"), weights_only=False)
    full_f32()  # as the one process ran every step (its head and ViT's hold f32 products)
    trainer, batch = mp_gpt(mp_gpt_model(), mesh)
    state, out, grads = mp_step(kernels, trainer, batch)
    out["heads_per_rank"] = state.model.layer_0.attention.query.out_shape[0]
    out["vocab_per_rank"] = state.model.lm_head.weight.shape[0]
    out.update(shard_readings(grads, ref, mesh))
    del trainer, state, grads
    free_device_memory()
    trainer, _ = mp_gpt(mp_gpt_model(f32=True), mesh)
    state, f32, grads = mp_step(kernels, trainer, batch, timed=False)
    out["f32"] = {"loss": f32["loss"], **shard_readings(grads, ref, mesh, f32=True)}
    del trainer, state, grads
    free_device_memory()
    model = mp_gpt_model(f32=True).to("cuda")
    out["chain"] = gpt_lib.generate(model, ref["prompt"], MP_NEW_TOKENS, mesh=mesh).tolist()
    del model
    free_device_memory()
    trainer, vbatch = mp_vit(mesh)
    _, vit, _ = mp_step(kernels, trainer, vbatch, timed=False)
    out["vit"] = {"loss": vit["loss"], "launches_per_pass": vit["launches_per_pass"],
                  "heads_per_rank": trainer.model.layer_0.attention.query.out_shape[0]}
    del trainer
    free_device_memory()
    return out


def rank_sp_gpt(work: str, kernels) -> dict:
    """sp_gpt's world-2 rank: GPT-small at sp = 2 (2048 positions a rank),
    ring then Ulysses, each step 1 against the one process's."""
    import os

    from tf_operator_tpu_torch.parallel.mesh import MeshConfig, build_mesh, sequence_attention

    mesh = build_mesh(MeshConfig(sp=WORLD2), "cuda")
    ref = torch.load(os.path.join(work, "mp_ref.pt"), weights_only=False)
    full_f32()
    out = {}
    for strategy in MP_STRATEGIES:
        attention = sequence_attention(mesh, strategy, causal=True, flash=True)
        trainer, batch = mp_gpt(mp_gpt_model(attention), mesh, shard_sequence=True)
        state, got, grads = mp_step(kernels, trainer, batch)
        got["wrapper"] = type(trainer.module).__name__
        got.update(shard_readings(grads, ref, mesh))
        out[strategy] = got
        del trainer, state, grads
        free_device_memory()
    return out


def rank_tp_sp_cli(kernels) -> dict:
    """tp_sp_cli's world-4 rank: the reference's usage lines through the
    CLIs' run(), GPT-small --tp 2 --sp 2 (ring), then BERT-base --tp 2
    --sp 2 --sp-strategy ulysses --flash --packed."""
    from tf_operator_tpu_torch.train import bert as bert_cli
    from tf_operator_tpu_torch.train import gpt as gpt_cli

    runs = {
        "gpt": (gpt_cli, ["--preset", "small", "--tp", "2", "--sp", "2", "--batch-size",
                          str(MP_SHAPE[0]), "--seq-len", str(MP_SHAPE[1])]),
        "bert": (bert_cli, ["--preset", "base", "--tp", "2", "--sp", "2", "--sp-strategy",
                            "ulysses", "--flash", "--packed"]),
    }
    out = {}
    for name, (cli, argv) in runs.items():
        args = cli.parse_args(argv + ["--steps", str(CLI_STEPS[name]), "--log-every", "1"])
        kernels.reset_launches()
        summary = cli.run(args)
        passes = {"flash_fwd": summary["forward_passes"],
                  "flash_bwd_dkv": summary["backward_passes"],
                  "flash_bwd_dq": summary["backward_passes"]}
        out[name] = {"argv": argv, "first_loss": summary["first_loss"], "loss": summary["loss"],
                     "eval_loss": summary["eval_loss"], "steps": summary["step"],
                     "tokens_per_sec": summary["tokens_per_sec"],
                     "launches_per_pass": {k: kernels.LAUNCHES[k] / passes[k]
                                           for k in FLASH_KERNELS},
                     "forward_passes": summary["forward_passes"],
                     "backward_passes": summary["backward_passes"]}
        free_device_memory()
    return out


def world_rank(phase: str, work: str) -> int:
    """One rank of tp_sp_cli's world of 4 (run_model_parallel_phases),
    launched as `chip_smoke.py --world-rank cli <dir>`: over gloo on
    cuda:0, rank<r>.json written to <dir>."""
    import os

    from tf_operator_tpu_torch.ops import kernels
    from tf_operator_tpu_torch.parallel import distributed

    distributed.initialize("cuda", backend="gloo")
    try:
        if phase != "cli":
            raise SystemExit(f"unknown world phase {phase!r}")
        out = {"rank": distributed.rank(), "world": distributed.world_size(),
               "tp_sp_cli": rank_tp_sp_cli(kernels)}
        with open(os.path.join(work, f"rank{out['rank']}.json"), "w") as fh:
            json.dump(out, fh)
        distributed.barrier()
    finally:
        distributed.shutdown()
    return 0


def run_model_parallel_phases(kernels, smi: str) -> None:
    """tp_sp_cli: the world of 4 running the CLIs' usage lines, held to
    its bounds (tp_gpt and sp_gpt run in run_distributed_phases' world of
    2)."""
    import os
    import shutil
    import tempfile

    cli_work = tempfile.mkdtemp(prefix="mp-cli-")
    try:
        start = time.monotonic()
        run_world([__file__, "--world-rank", "cli", cli_work], cli_work, MP_TIMEOUT_S,
                  world=CLI_WORLD)
        cli_s = time.monotonic() - start
        cli = [json.load(open(os.path.join(cli_work, f"rank{r}.json")))["tp_sp_cli"]
               for r in range(CLI_WORLD)]
        check_tp_sp_cli(cli, smi, cli_s)
    finally:
        shutil.rmtree(cli_work, ignore_errors=True)


def check_tp_gpt(one: dict, chain: list, ranks: list, smi: str, world_s: float) -> dict:
    flash_want = {k: LAYERS for k in FLASH_KERNELS}
    emit({"phase": "tp_gpt", "card": smi, "model": "GPT-small causal flash, TRANSFORMER_RULES tp",
          "shape": list(MP_SHAPE), "mesh": "dp=1xfsdp=1xsp=1xtp=2", "label": MP_LABEL,
          "one_process": one, "ranks": ranks, "chain_one_process_f32": chain,
          "world_seconds": world_s, "world_runs": "ddp_bert, fsdp_gpt, syncbn_resnet, "
                                                  "tp_gpt and sp_gpt",
          "tolerances": {"loss_atol": LOSS_ATOL, "grad_ratio": GRAD_RATIO,
                         "grad_floor": GRAD_FLOOR, "f32_grad_rtol": MP_F32_GRAD_RTOL,
                         "why": DIST_TOLERANCE_WHY}})
    for r in ranks:
        if r["launches_per_pass"] != flash_want or r["heads_per_rank"] != 3:
            raise AssertionError(f"tp_gpt launches or heads: {r['launches_per_pass']}, "
                                 f"{r['heads_per_rank']} heads")
        if abs(r["loss"] - one["loss"]) > LOSS_ATOL or r["worst_ratio"][1] > GRAD_RATIO:
            raise AssertionError(f"tp_gpt bf16 against the one process: {r['loss']} vs "
                                 f"{one['loss']}, {r['worst_ratio']}")
        f32 = r["f32"]
        if (abs(f32["loss"] - one["loss_f32"]) > LOSS_ATOL
                or f32["worst_f32_rel"][1] > MP_F32_GRAD_RTOL):
            raise AssertionError(f"tp_gpt f32 against the one process: {f32}")
        if r["chain"] != chain:
            raise AssertionError(f"tp_gpt generate(mesh=) chain {r['chain']} != {chain}")
        vit = r["vit"]
        if abs(vit["loss"] - one["vit_loss"]) > LOSS_ATOL or vit["heads_per_rank"] != 6:
            raise AssertionError(f"tp_gpt ViT-B/16 at tp 2: {vit} vs {one['vit_loss']}")
    return {k: ranks[0]["launches_per_pass"][k] for k in FLASH_KERNELS}


def check_sp_gpt(one: dict, ranks: list, smi: str) -> dict:
    emit({"phase": "sp_gpt", "card": smi, "model": "GPT-small causal, sequence parallel",
          "shape": list(MP_SHAPE), "mesh": "dp=1xfsdp=1xsp=2xtp=1", "label": MP_LABEL,
          "one_process": one, "ranks": ranks,
          "tolerances": {"loss_atol": LOSS_ATOL, "grad_ratio": GRAD_RATIO,
                         "grad_floor": GRAD_FLOOR, "why": DIST_TOLERANCE_WHY}})
    out = {}
    for strategy in MP_STRATEGIES:
        want = {k: 0 if strategy == "ring" else LAYERS for k in FLASH_KERNELS}
        for r in ranks:
            got = r[strategy]
            if got["launches_per_pass"] != want or got["positions"] != MP_SHAPE[1] // WORLD2:
                raise AssertionError(f"sp_gpt {strategy} launches {got['launches_per_pass']} "
                                     f"!= {want}, positions {got['positions']}")
            if abs(got["loss"] - one["loss"]) > LOSS_ATOL or got["worst_ratio"][1] > GRAD_RATIO:
                raise AssertionError(f"sp_gpt {strategy} against the one process: {got['loss']} "
                                     f"vs {one['loss']}, {got['worst_ratio']}")
        out[strategy] = {k: ranks[0][strategy]["launches_per_pass"][k] for k in FLASH_KERNELS}
    return out


def check_tp_sp_cli(ranks: list, smi: str, world_s: float) -> None:
    emit({"phase": "tp_sp_cli", "card": smi, "world": CLI_WORLD,
          "mesh": "dp=1xfsdp=1xsp=2xtp=2", "label": MP_LABEL, "ranks": ranks,
          "world_seconds": world_s})
    for r in ranks:
        for name, got in r.items():
            want = 0 if name == "gpt" else LAYERS
            if any(got["launches_per_pass"][k] != want for k in FLASH_KERNELS):
                raise AssertionError(f"tp_sp_cli {name} launches {got['launches_per_pass']}")
            losses = (got["first_loss"], got["loss"], got["eval_loss"])
            if not all(math.isfinite(x) for x in losses) or not got["loss"] < got["first_loss"]:
                raise AssertionError(f"tp_sp_cli {name} losses {losses}")


# the serve phase: GPT-small behind make_server(batching="continuous") at the
# server's defaults (8 slots, paged, 64-token blocks, the dense-equivalent pool
# of 8 x 32 blocks, 64-token prefill chunks)
SERVE_SEED = 9
SERVE_SLOTS = 8
SERVE_BLOCK = 64
SERVE_CHUNK = 64
SERVE_REQUESTS = 12
SERVE_CLIENTS = 8
SERVE_STREAMS = 4
SERVE_PREFIX = 512
SERVE_PROMPT = (16, 1024)
SERVE_NEW = (32, 128)
# A chain may first differ from another path's only at a decision whose top-2
# margin is at most SERVE_MARGIN_ULPS bf16 ulps of its top logit (the logits
# are bf16; GPT-small's top logits with random weights sit in [2, 8), an ulp
# of 1/64 or 1/32). Two paths that round differently through 12 layers (a
# batch of 8 slots over a 2048-position gather against a batch of 32 over the
# chains' length; 64-token prefill chunks against one token a step) may turn
# such a near-tie either way: the first differences read sit at 0 to 2 ulps,
# and 16% of all decisions within 2 (GPT-small on an H100).
SERVE_MARGIN_ULPS = 2
# The captured step's logits, teacher-forced along the served chains, against
# GPTDecodeStep's over a dense cache holding the same prompt keys and values
# and fed the same tokens (the same einsum shapes): relative L2 at each
# position. A quarter of a bf16 ulp (2^-8 relative): the two run the same
# operations on the same values, and read 0 at every position on an H100.
SERVE_STEP_LOGIT_RTOL = 1e-3
# The prompt keys and values the captured prefill chunks wrote, against
# GPTPrefill's over the same tokens: relative L2, worst layer of k or v. The
# chunks' GEMMs (64 rows) and attention widths differ from one prompt-long
# pass, so the two round apart in bf16 (worst 9.8e-3 on an H100).
SERVE_PREFILL_KV_RTOL = 2e-2
SERVE_STEP_REPS = 20
SERVE_PROFILE_STEPS = 10
SERVE_CATEGORIES = (
    ("indexing (pool gather, KV scatter, embedding)", ("index",)),
    ("GEMM", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "splitk")),
    ("softmax", ("softmax",)),
    ("layer norm", ("layer_norm", "layernorm")),
    ("copies and casts", ("copy",)),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "functor")),
)


def serve_requests(cfg) -> list:
    """SERVE_REQUESTS requests from a seeded generator: prompt lengths in
    SERVE_PROMPT, SERVE_NEW new tokens each; half share one SERVE_PREFIX-token
    prefix (two of them are that prefix alone, whose second admission copies
    the cached tail block), SERVE_STREAMS of the rest go over /generate_stream.
    Request 0 is the prefix alone, sent first, so the prefix is published."""
    import numpy as np

    rng = np.random.default_rng(SERVE_SEED)
    prefix = rng.integers(0, cfg.vocab_size, SERVE_PREFIX).tolist()
    reqs = []
    for i in range(SERVE_REQUESTS):
        new = int(rng.integers(SERVE_NEW[0], SERVE_NEW[1] + 1))
        if i < 2:
            prompt = list(prefix)
        elif i < SERVE_REQUESTS // 2:
            tail = int(rng.integers(1, SERVE_PROMPT[1] - SERVE_PREFIX + 1))
            prompt = prefix + rng.integers(0, cfg.vocab_size, tail).tolist()
        else:
            p = int(rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))
            prompt = rng.integers(0, cfg.vocab_size, p).tolist()
        reqs.append({"prompt": prompt, "new": new, "stream": False})
    for i in rng.choice(np.arange(1, SERVE_REQUESTS), SERVE_STREAMS, replace=False):
        reqs[int(i)]["stream"] = True
    return reqs


def client_pool(work, n: int, clients: int, what: str) -> tuple:
    """work(i) for every i < n from `clients` threads, each taking the next
    i from one queue: -> (the results in order of i, the wall seconds).
    Raises with the first errors when a call failed or a thread outlived
    600 s."""
    import queue as queue_mod
    import threading

    out = [None] * n
    todo: queue_mod.Queue = queue_mod.Queue()
    for i in range(n):
        todo.put(i)
    errors = []

    def worker():
        while True:
            try:
                i = todo.get_nowait()
            except queue_mod.Empty:
                return
            try:
                out[i] = work(i)
            except Exception as err:  # noqa: BLE001 — raised below
                errors.append((i, repr(err)))

    threads = [threading.Thread(target=worker) for _ in range(clients)]
    start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - start
    if errors or any(t.is_alive() for t in threads) or any(o is None for o in out):
        raise AssertionError(f"{what} failed: {errors[:3]}")
    return out, wall


def serve_load(client, reqs) -> dict:
    """Request 0 alone, then the rest from SERVE_CLIENTS client threads (each
    takes the next request in a seeded order); -> each request's chain, and
    the wall seconds of the concurrent part."""
    def one(i):
        req = reqs[i]
        if req["stream"]:
            events = list(client.generate_stream(req["prompt"], max_new_tokens=req["new"]))
            tokens = [e["token"] for e in events if "token" in e]
            chain = events[-1]["tokens"][0]
            if chain != req["prompt"] + tokens:
                raise AssertionError(f"request {i}: streamed tokens differ from the done event")
            return chain
        return client.generate([req["prompt"]], max_new_tokens=req["new"])[0]

    reqs[0]["chain"] = one(0)
    chains, wall = client_pool(lambda i: one(i + 1), len(reqs) - 1, SERVE_CLIENTS, "serve load")
    for req, chain in zip(reqs[1:], chains):
        req["chain"] = chain
    return {"wall_s": wall, "requests": len(reqs) - 1,
            "tokens": sum(r["new"] for r in reqs[1:])}


def by_category(kernels, steps: int, categories) -> dict:
    out = {}
    for e in kernels:
        name = next((n for n, keys in categories if any(k in e.key.lower() for k in keys)), "other")
        out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / steps
    return out


def serve_step_timings(engine) -> dict:
    """The paged step at SERVE_SLOTS active slots (each at position 1023 of its
    own 32 blocks, the pool's 256 usable blocks), called from this thread once
    the engine is stopped: median wall ms a step (inputs copied, step, next
    tokens to the host) as the captured graph's replay and as the same step
    launched eagerly; then a torch.profiler window of SERVE_PROFILE_STEPS of
    each: device ms a step by kind and the busy share; and the device ms of
    the weight casts alone (every dense weight to bf16, as each step casts
    them), from a profiler window of SERVE_PROFILE_STEPS sets of casts."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    step = engine.step
    n, mb = engine.n_slots, engine.max_blocks
    rng = np.random.default_rng(SERVE_SEED + 1)
    args = (rng.integers(0, engine.cfg.vocab_size, n).astype(np.int32),
            np.full(n, 1023, np.int32), np.zeros((n, engine.max_total), np.int32),
            np.ones(n, np.int32), (1 + np.arange(n * mb, dtype=np.int32)).reshape(n, mb))
    runs = {"graph": lambda: step(*args).cpu(), "eager": lambda: step.run_eager(*args).cpu()}
    out = {"active_slots": n, "index": 1023}
    def window(fn, steps):
        """Device kernels, wall ms and device ms of `steps` calls of fn."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.monotonic()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            wall = (time.monotonic() - start) * 1e3
        kernels = device_kernels(prof)
        return kernels, wall, sum(e.self_device_time_total for e in kernels) / 1e3

    for name, fn in runs.items():
        for _ in range(3):
            fn()
        times = []
        for _ in range(SERVE_STEP_REPS):
            torch.cuda.synchronize()
            start = time.monotonic()
            fn()
            times.append((time.monotonic() - start) * 1e3)
        out[f"{name}_ms_per_step"] = statistics.median(times)
        kernels, wall, device_ms = window(fn, SERVE_PROFILE_STEPS)
        out[f"{name}_profile"] = {
            "wall_ms_per_step": wall / SERVE_PROFILE_STEPS,
            "device_ms_per_step": device_ms / SERVE_PROFILE_STEPS if device_ms else None,
            "device_busy_share": device_ms / wall if device_ms else None,
            "kernels_per_step": sum(e.count for e in kernels) / SERVE_PROFILE_STEPS,
            "ms_per_step_by_kind": by_category(kernels, SERVE_PROFILE_STEPS, SERVE_CATEGORIES),
            "top": [{"kernel": e.key[:200], "calls_per_step": e.count / SERVE_PROFILE_STEPS,
                     "ms_per_step": e.self_device_time_total / 1e3 / SERVE_PROFILE_STEPS}
                    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]],
        }
    weights = [p for name, p in engine.model.named_parameters()
               if "embed" not in name and ".ln_" not in name and not name.startswith("ln_")]
    # the int8 twin's kernels are buffers, cast to bf16 by every product
    weights += [b for name, b in engine.model.named_buffers() if name.endswith(".kernel")]

    def casts():
        with torch.no_grad():
            return [w.to(torch.bfloat16) for w in weights]

    casts()
    _, _, cast_ms = window(casts, SERVE_PROFILE_STEPS)
    cast_ms /= SERVE_PROFILE_STEPS
    cfg = engine.cfg
    gathered = 2 * cfg.num_layers * n * mb * engine.pool.block_size * cfg.hidden_size * 2
    out.update({
        "weight_cast_device_ms_per_step": cast_ms,
        "weight_casts_per_step": len(weights),
        "weight_cast_params": sum(w.numel() for w in weights),
        "weight_cast_share_of_eager_device": (
            cast_ms / out["eager_profile"]["device_ms_per_step"]
            if out["eager_profile"]["device_ms_per_step"] else None),
        "gathered_kv_bytes_per_step": gathered,
        "gathered_kv_bytes_note": "pool[tables] for k and v in every layer, bf16 (int8 "
                                  "pools gather half, plus their scales)",
    })
    # the timings wrote into real pool blocks: their cached prompts are gone
    engine.pool.flush()
    return out


def inline_chains(gpt_lib, model, reqs, kv_quant_int8: bool = False):
    """The port's inline generate over every request in one batched ragged
    call (models/gpt.py _decode, the path generate takes for ragged lengths),
    with the greedy sampler wrapped to keep each step's bf16 logits. -> chains
    [b, total] and logits [total - 1, b, vocab] (step i predicts position i+1)."""
    b = len(reqs)
    width = max(len(r["prompt"]) for r in reqs)
    new = max(r["new"] for r in reqs)
    prompt = torch.zeros((b, width), dtype=torch.long)
    for i, r in enumerate(reqs):
        prompt[i, :len(r["prompt"])] = torch.tensor(r["prompt"])
    prompt = prompt.cuda()
    lens = torch.tensor([len(r["prompt"]) for r in reqs], device="cuda")
    kept = []

    def greedy(logits):
        kept.append(logits.clone())
        return logits.argmax(dim=-1)

    with torch.no_grad():
        generated = gpt_lib._decode(model, prompt, lens, width + new, greedy, ragged=True,
                                    kv_quant_int8=kv_quant_int8)
    return torch.cat([prompt[:, :1], generated], dim=1), torch.stack(kept)


def first_diff(a: list, b: list):
    for j, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return j
    return None


def decisions(logits: torch.Tensor) -> torch.Tensor:
    """[..., vocab] bf16 logits -> [..., 3] f32: each row's argmax, top-2
    margin, and the margin under which a near-tie may fall either way
    (SERVE_MARGIN_ULPS bf16 ulps of the top logit)."""
    top = torch.topk(logits.float(), 2, dim=-1).values
    exponent = torch.floor(torch.log2(top[..., 0].abs().clamp(min=2.0 ** -126)))
    bound = SERVE_MARGIN_ULPS * torch.exp2(exponent - 7)
    return torch.stack([logits.argmax(dim=-1).float(), top[..., 0] - top[..., 1], bound], -1)


def rel_rows(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Relative L2 of each row (last dim) of got against want."""
    got, want = got.float(), want.float()
    return (got - want).norm(dim=-1) / want.norm(dim=-1)


def replay_served(gpt_lib, step, model, group, chunk: int) -> list:
    """Teacher-force the served chains of `group` (at most step.n_slots
    requests, one a slot) through `step`'s captured programs as the engine
    runs a request admitted without the prefix cache: the prompt's whole
    chunks ((p - 1) // chunk of them) through the prefill chunk, then the
    step from there to the chain's end, each row forced along its served
    chain (prompt = the chain, lens = its length). Each slot owns its own
    max_blocks blocks of the pool, zeroed first. Beside the step runs
    GPTDecodeStep (the inline path's step) over a dense cache that holds
    the same prompt keys and values (copied from the pool once the chunks
    ran) and is fed the same tokens at the same positions.
    -> per request: "prefill_kv_rel", the chunks' keys and values against
    GPTPrefill's over the same tokens (worst relative L2 of a layer's k or
    v; None without a whole chunk); "logit_rel", the step's logits against
    GPTDecodeStep's at every position it ran (relative L2); "decisions"
    [new, 3], `decisions` of the step's logits at positions p-1 .. L-2."""
    import numpy as np

    cfg, device = model.cfg, step.device
    n, mb, total = step.n_slots, step.max_blocks, step.max_total
    step.init_cache()
    tables = (1 + np.arange(n * mb, dtype=np.int32)).reshape(n, mb)
    chains = [r["chain"] for r in group]
    starts = []
    for s, r in enumerate(group):
        k = (len(r["prompt"]) - 1) // chunk
        for c in range(k):
            step.prefill(np.asarray([chains[s][c * chunk:(c + 1) * chunk]], np.int32),
                         c * chunk, tables[s])
        starts.append(k * chunk)
    quantized = step.cache.quantized
    dense = gpt_lib.KVCache.zeros(cfg, n, total, device, quantized)
    kv_rel = []
    for s, start in enumerate(starts):
        if not start:
            kv_rel.append(None)
            continue
        ref = gpt_lib.KVCache.zeros(cfg, 1, start, device, quantized)
        gpt_lib.GPTPrefill(model)(torch.tensor([chains[s][:start]], device=device), ref)
        table = torch.as_tensor(tables[s], device=device).long()
        worst = 0.0
        # keys, values (and under int8 their scales), every layer
        for pool, layer, want in zip(step.cache.tensors(), dense.tensors(), ref.tensors()):
            got = pool[table].reshape(-1, *pool.shape[2:])[:start]
            layer[s, :start] = got
            worst = max(worst, rel(got.float(), want[0].float()))
        kv_rel.append(worst)
    prompt = np.zeros((n, total), np.int32)
    lens = np.ones(n, np.int32)
    for s, chain in enumerate(chains):
        prompt[s, :len(chain)] = chain
        lens[s] = len(chain)
    index = np.zeros(n, np.int32)
    index[:len(starts)] = starts
    decode = gpt_lib.GPTDecodeStep(model)
    rows, indices = [], []
    for _ in range(max(len(c) - 1 - st for c, st in zip(chains, starts))):
        live = index <= lens - 2
        idx = np.where(live, index, 0)
        tok = prompt[np.arange(n), idx] * live
        step(tok, idx, prompt, np.where(live, lens, 1), tables * live[:, None])
        want = decode(torch.as_tensor(tok, device=device).long(),
                      torch.as_tensor(idx, device=device).long(), dense)
        rows.append(torch.cat([rel_rows(step.logits, want)[:, None],
                               decisions(step.logits)], dim=1))
        indices.append(np.where(live, index, -1))
        index = index + 1
    got = torch.stack(rows).cpu().numpy()  # [steps, n, 4]
    indices = np.stack(indices)
    out = []
    for s, r in enumerate(group):
        ran = indices[:, s] >= 0
        decided = indices[:, s] >= len(r["prompt"]) - 1
        out.append({"prefill_kv_rel": kv_rel[s], "logit_rel": got[ran, s, 0],
                    "decisions": got[decided, s, 1:]})
    return out


class _PlantedDecodeStep:
    """PagedDecodeStep with a planted fault: each row attends one position
    past its own (index + 1, a zeroed pool position)."""

    def __init__(self, model) -> None:
        self.model = model

    @torch.no_grad()
    def __call__(self, token, index, tables, pool):
        from tf_operator_tpu_torch.models import gpt as gpt_lib

        model = self.model
        x = model.embed(token[:, None], index[:, None])
        positions = torch.arange(tables.shape[1] * pool.keys[0].shape[1], device=token.device)
        valid = (positions[None, :] <= index[:, None] + 1)[:, None, None, :]
        for block, kv in zip(model.blocks(), pool.layers()):
            x = block(x, valid, gpt_lib._paged_attention(kv, index, tables))
        return model.head(x)[:, 0]


class _PlantedPrefillChunk:
    """PagedPrefillChunk with a planted fault: each query of the chunk
    also sees the next position (a causal leak of one)."""

    def __init__(self, model) -> None:
        self.model = model

    @torch.no_grad()
    def __call__(self, tokens, start, table, pool):
        from tf_operator_tpu_torch.models import gpt as gpt_lib

        model = self.model
        positions = start + torch.arange(tokens.shape[1], device=tokens.device)
        x = model.embed(tokens, positions[None])
        keys_at = torch.arange(table.shape[0] * pool.keys[0].shape[1], device=tokens.device)
        mask = (keys_at[None, :] <= positions[:, None] + 1)[None, None]
        for block, kv in zip(model.blocks(), pool.layers()):
            x = block(x, mask, gpt_lib._paged_prefill_attention(kv, positions, table))
        return x


def planted_replay(gpt_lib, engine, group, chunk: int) -> dict:
    """The control that the replay's checks must fail: a PagedSlotDecodeStep
    like the engine's (its own pool, its own captures) built with two planted
    faults, each read by its own check (the step's logits against
    GPTDecodeStep's see only the mask past the index, the chunks' keys and
    values against GPTPrefill's only the causal leak), replayed along
    `group`'s served chains. -> the worst reading of each check, and the
    count of decisions where the faulty step's argmax is not the served
    token at a margin above the bound (what the margin rule would read)."""
    saved = gpt_lib.PagedDecodeStep, gpt_lib.PagedPrefillChunk
    gpt_lib.PagedDecodeStep, gpt_lib.PagedPrefillChunk = _PlantedDecodeStep, _PlantedPrefillChunk
    try:
        step = gpt_lib.PagedSlotDecodeStep(engine.model, engine.n_slots, engine.max_total,
                                           engine.step.block_size, engine.step.num_blocks,
                                           kv_quant_int8=engine.step.cache.quantized)
        got = replay_served(gpt_lib, step, engine.model, group, chunk)
    finally:
        gpt_lib.PagedDecodeStep, gpt_lib.PagedPrefillChunk = saved
    flips = sum(int(token) != want and m > bound
                for r, g in zip(group, got)
                for (token, m, bound), want in zip(g["decisions"].tolist(),
                                                   r["chain"][len(r["prompt"]):]))
    return {"logit_rel_worst": max(float(r["logit_rel"].max()) for r in got),
            "prefill_kv_rel_worst": max(r["prefill_kv_rel"] or 0.0 for r in got),
            "decisions_flipped_above_margin": flips,
            "captures": (step.compiles, step.prefill_compiles)}


def run_serve(kernels, gpt_lib, smi) -> dict:
    """serve: GPT-small (12 x 768, 6 heads of 128, vocab 32000, max_seq_len
    2048, bf16 compute, random weights from SERVE_SEED) behind
    make_server(batching="continuous") at the server's defaults, on
    127.0.0.1, through the port's DecodeClient (serve_requests, serve_load).
    Reports requests/s, generated tokens/s, TTFT and inter-token p50/p95 from
    the server's /metrics histograms, the engine's counters, captures, KV pool
    bytes, peak memory and the step's timings (serve_step_timings). Holds:
    each served chain against the port's inline generate (one batched ragged
    call), differing first only within SERVE_MARGIN_ULPS; every served chain
    teacher-forced through the engine's captured programs (replay_served):
    the step's logits against GPTDecodeStep's at every position
    (SERVE_STEP_LOGIT_RTOL), the chunks' keys and values against GPTPrefill's
    (SERVE_PREFILL_KV_RTOL), each served token the step's argmax or a
    near-tie; a planted control that must fail both (planted_replay); the
    same requests through a kv_layout="dense" engine (the margin rule); one
    capture of the step and of the prefill chunk; a clean shutdown with the
    engine thread joined. No kernel of K1-K5 runs on this path: their counts
    must stay 0."""
    import threading

    import numpy as np

    from tf_operator_tpu_torch.serve import DecodeClient, make_server
    from tf_operator_tpu_torch.serve.engine import ContinuousBatchingEngine
    from tf_operator_tpu_torch.telemetry import quantile_from_flat, validate_text

    cfg = gpt_lib.GPT_SMALL
    model = gpt_lib.GPT(cfg, generator=torch.Generator().manual_seed(SERVE_SEED), device="cuda")
    reqs = serve_requests(cfg)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    start = time.monotonic()
    server = make_server(model, batching="continuous", n_slots=SERVE_SLOTS, kv_layout="paged",
                         block_size=SERVE_BLOCK, kv_blocks=0, prefill_chunk=SERVE_CHUNK,
                         device="cuda", max_new_cap=SERVE_NEW[1])
    startup_s = time.monotonic() - start
    engine = server.state.engine
    listener = threading.Thread(target=server.serve_forever, daemon=True)
    listener.start()
    try:
        client = DecodeClient(f"http://127.0.0.1:{server.server_address[1]}", timeout=600)
        load = serve_load(client, reqs)
        text = client.metrics_text()
        validate_text(text)
        flat = client.metrics()
        health = client.healthy()
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        listener.join(timeout=30)
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prefix = "tf_operator_tpu_serve_"
    report = {
        "phase": "serve", "card": smi, "model": "GPT-small", "slots": SERVE_SLOTS,
        "kv_layout": "paged", "block_size": SERVE_BLOCK, "prefill_chunk": SERVE_CHUNK,
        "kv_blocks": engine.pool.total, "requests": SERVE_REQUESTS, "clients": SERVE_CLIENTS,
        "streams": SERVE_STREAMS, "startup_s": startup_s,
        "requests_per_s": load["requests"] / load["wall_s"],
        "generated_tokens_per_s": load["tokens"] / load["wall_s"],
        "load_wall_s": load["wall_s"],
        **{f"{name}_{q}_s": quantile_from_flat(flat, prefix + family, p)
           for name, family in (("ttft", "ttft_seconds"), ("itl", "inter_token_seconds"))
           for q, p in (("p50", 0.5), ("p95", 0.95))},
        "steps": engine.steps,
        "mean_active_slots": engine.row_steps / max(engine.steps, 1),
        "prefill_chunks": engine.prefill_chunks,
        "prefix_hits": engine.pool.hits, "cow_copies": engine.pool.cow_copies,
        "compiles": engine.step.compiles, "prefill_compiles": engine.step.prefill_compiles,
        "copy_compiles": engine.step.copy_compiles,
        "kv_bytes_total": engine.step.kv_bytes_total, "peak_memory_gb": peak_gb,
        "engine_seconds": {k: getattr(engine, k) for k in (
            "decode_seconds", "prefill_seconds", "admit_seconds", "dispatch_seconds",
            "sync_seconds", "fanout_seconds")},
        "launches": launches, "healthz": health["status"],
        "engine_thread_joined": not engine.thread.is_alive(),
    }
    report["step"] = serve_step_timings(engine)

    # held: the port's inline generate, one batched ragged call
    chains, logits = inline_chains(gpt_lib, model, reqs)
    differ, inline_decisions = [], []
    for i, r in enumerate(reqs):
        p, served = len(r["prompt"]), r["chain"]
        inline = chains[i, :p + r["new"]].tolist()
        # step k decides position k + 1
        inline_decisions.append(decisions(logits[p - 1:p + r["new"] - 1, i]).cpu())
        j = first_diff(served, inline)
        if j is not None:
            _, m, bound = inline_decisions[-1][j - p].tolist()
            differ.append({"request": i, "position": j, "inline_margin": m, "bound": bound})
    del logits
    free_device_memory()
    # held: every served chain teacher-forced through the engine's captured
    # programs, in groups of SERVE_SLOTS chains of similar length
    order = sorted(range(len(reqs)), key=lambda i: len(reqs[i]["chain"]))
    groups = [[reqs[i] for i in order[k:k + SERVE_SLOTS]]
              for k in range(0, len(order), SERVE_SLOTS)]
    start = time.monotonic()
    for group in groups:
        for r, got in zip(group, replay_served(gpt_lib, engine.step, model, group,
                                               SERVE_CHUNK)):
            r.update(got)
    replay_s = time.monotonic() - start
    replay_differ = []
    for i, r in enumerate(reqs):
        want = r["chain"][len(r["prompt"]):]
        for k, (token, m, bound) in enumerate(r["decisions"].tolist()):
            if int(token) != want[k]:
                replay_differ.append({"request": i, "position": len(r["prompt"]) + k,
                                      "margin": m, "bound": bound})
    # the control: planted faults the replay's checks must fail (the
    # shortest chains, where one position more or less weighs most)
    planted = planted_replay(gpt_lib, engine, groups[0], SERVE_CHUNK)
    # the same requests through a dense engine
    dense = ContinuousBatchingEngine(model, n_slots=SERVE_SLOTS, kv_layout="dense", device="cuda")
    try:
        handles = [dense.submit(r["prompt"], r["new"]) for r in reqs]
        dense_chains = [h.result(600) for h in handles]
    finally:
        dense.stop()
    dense_differ = []
    for i, (r, got) in enumerate(zip(reqs, dense_chains)):
        j = first_diff(got, r["chain"])
        if j is not None:
            # the replay's decision at position j (step j - 1)
            _, m, bound = r["decisions"][j - len(r["prompt"])].tolist()
            dense_differ.append({"request": i, "position": j, "served_margin": m,
                                 "bound": bound})
    inline_all = torch.cat(inline_decisions).numpy()
    served_all = np.concatenate([r["decisions"] for r in reqs])
    served_margins = served_all[:, 1]
    logit_rel = np.concatenate([r["logit_rel"] for r in reqs])
    kv_rel = [r["prefill_kv_rel"] for r in reqs if r["prefill_kv_rel"] is not None]
    report.update({
        "margin_ulps": SERVE_MARGIN_ULPS,
        "chains_differing_from_inline": len(differ), "inline_differences": differ,
        "decisions": len(served_all),
        "inline_share_of_decisions_within_margin": float(
            (inline_all[:, 1] <= inline_all[:, 2]).mean()),
        "served_share_of_decisions_within_margin": float(
            (served_all[:, 1] <= served_all[:, 2]).mean()),
        "served_margin_quantiles": {
            q: float(np.quantile(served_margins, q)) for q in (0.01, 0.1, 0.5, 0.9)},
        "replay_seconds": replay_s,
        "replay_positions": len(logit_rel),
        "replay_logit_rel_l2": {"worst": float(logit_rel.max()),
                                "median": float(np.median(logit_rel)),
                                "exact_share": float((logit_rel == 0).mean())},
        "replay_logit_rtol": SERVE_STEP_LOGIT_RTOL,
        "replay_decisions_differing_from_served": len(replay_differ),
        "replay_differences": replay_differ[:10],
        "prefill_kv_rel_l2_worst": max(kv_rel), "prefill_kv_rtol": SERVE_PREFILL_KV_RTOL,
        "planted": planted,
        "dense_chains_differing": len(dense_differ), "dense_differences": dense_differ,
        "dense_compiles": dense.step.compiles,
    })
    emit(report)
    free_device_memory()
    problems = []
    if any(d["inline_margin"] > d["bound"] for d in differ):
        problems.append("a served chain differs from the inline chain at a decision above the margin")
    if any(d["margin"] > d["bound"] for d in replay_differ):
        problems.append("a served token is not the replayed step's argmax above the margin")
    if any(d["served_margin"] > d["bound"] for d in dense_differ):
        problems.append("a dense-engine chain differs at a decision above the margin")
    if logit_rel.max() > SERVE_STEP_LOGIT_RTOL:
        problems.append("the captured step's logits differ from GPTDecodeStep's")
    if max(kv_rel) > SERVE_PREFILL_KV_RTOL:
        problems.append("the captured prefill chunks' keys and values differ from GPTPrefill's")
    if planted["logit_rel_worst"] <= SERVE_STEP_LOGIT_RTOL:
        problems.append("the planted mask fault passed the step's logit check")
    if planted["prefill_kv_rel_worst"] <= SERVE_PREFILL_KV_RTOL:
        problems.append("the planted causal leak passed the prefill check")
    if not planted["decisions_flipped_above_margin"]:
        problems.append("the planted faults flipped no decision above the margin")
    if (engine.step.compiles, engine.step.prefill_compiles, dense.step.compiles) != (1, 1, 1):
        problems.append("a program was captured other than once")
    if engine.pool.hits == 0 or engine.pool.cow_copies == 0:
        problems.append("the shared prefix gave no prefix hit or no copy-on-write")
    if any(launches.values()):
        problems.append(f"a kernel of K1-K5 launched on the serving path: {launches}")
    if not report["engine_thread_joined"] or dense.thread.is_alive():
        problems.append("an engine thread did not join")
    if health["status"] != "ok":
        problems.append(f"/healthz said {health['status']}")
    if problems:
        raise AssertionError(f"serve: {problems}")
    return report


# -- GPT-small's decode modes: int8, beams, speculation --------------------------

MODES_SEED = 21
INT8_DECODE = (8, 128, 32)  # rows, prompt, new tokens
INT8_F32_CHECK = (2, 32, 16)  # rows, prompt, new: f32 on the card against the CPU
# f32 on the card (TF32 off) against f32 on the CPU, both with both int8
# flags: each decode step's logits with both reading the same cache bytes
# (the CPU's, copied to the card), max error over the logit range. The two
# sum the same products in other orders (~1e-6 relative in f32); the bound
# leaves two orders of magnitude of room.
INT8_F32_LOGIT_RTOL = 1e-4
INT8_SERVE_REQUESTS = 8
INT8_SERVE_PROMPT = (16, 512)
INT8_SERVE_NEW = (32, 96)
# f32, card against CPU: the prefill's logits, each device attending over its
# own int8 cache (a value may sit one grid step apart, as the step check
# allows). Read 4.6e-3 in three H100 runs; the bound leaves 4x room.
INT8_F32_PREFILL_LOGIT_ATOL = 2e-2
# the captured int8 prefill chunks' keys, values and scales against
# GPTPrefill's over the whole prompt (worst relative L2 of a layer's tensor):
# the bf16 rounding apart of SERVE_PREFILL_KV_RTOL, plus the int8 grid steps
# that vectors so far apart round across. Read 1.497e-2 in three H100 runs
# (bf16's 9.8e-3); the bound leaves 2x room, as SERVE_PREFILL_KV_RTOL does.
# The planted causal leak (planted_replay on the int8 pool) is the upper
# reading the bound must stay below.
INT8_PREFILL_KV_RTOL = 3e-2
BYTES_STEPS = 48  # steps of the dense-against-paged int8 byte check
BEAM = (2, 4, 64, 64)  # rows, beams, prompt, new
# f32 (TF32 off): beam_search's scores against the teacher-forced sum of each
# beam's 64 generated log-probabilities through GPTDecodeStep, absolute (each
# term within ~1e-5 of the other path's)
BEAM_SCORE_ATOL = 1e-2
SPEC_NEW = 128
SPEC_K = 4
SPEC_NGRAM = 2
SPEC_PROMPT = 128
SPEC_SPAN = 32  # the repeated span of the repeated prompt
SPEC_BF16_PROMPTS = 2  # more bf16 chains beside the two, for the divergence share
SPEC_BF16_NEW = 128
SPEC_SERVE_REQUESTS = 8
SPEC_SERVE_PROMPT = (64, 512)
SPEC_SERVE_NEW = (64, 128)
SPEC_DEPTH = 4
# f32 (TF32 off), near max_total: the committed keys and values of the
# table's last block under ngram against speculate off's, worst relative L2
# of a layer's tensor. The verify and the step compute them in products of
# other widths (f32 noise, ~1e-6); a clamped overshoot writes another
# token's vectors there (order 1).
SPEC_COMMITTED_KV_RTOL = 1e-4
MODES_SERVE_NEW = 16
MODES_SERVE_TIMEOUT_S = 300
MODES_REFUSAL_TIMEOUT_S = 120


def f32_twin(gpt_lib, model, device):
    """An f32 GPT of `model`'s weights on `device`."""
    return built_from(lambda: gpt_lib.GPT(dataclasses.replace(model.cfg, dtype=torch.float32)),
                      model.state_dict(), device)


def forced_logits(gpt_lib, model, chain, kv_quant_int8: bool = False) -> torch.Tensor:
    """Teacher-forced logits [b, n, vocab] in f32 along `chain` [b, n] in
    one forward: GPTVerifyBlock at offset 0 writes the whole chain's keys
    and values (int8 under kv_quant_int8) and each position attends over
    what was stored at positions <= its own, as stepwise decode does."""
    b, n = chain.shape
    cache = gpt_lib.KVCache.zeros(model.cfg, b, n, chain.device, kv_quant_int8)
    return gpt_lib.GPTVerifyBlock(model)(chain, 0, cache).float()


def timed(fn):
    """(fn's result, its wall ms, the card synchronized before and after)."""
    torch.cuda.synchronize()
    start = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.monotonic() - start) * 1e3


def spec_prompt(cfg, gen, length: int, span: int = 0) -> list:
    """A seeded prompt: `span` tokens repeated to `length`, or drawn at
    random with span 0."""
    if span:
        base = torch.randint(0, cfg.vocab_size, (span,), generator=gen)
        return base.repeat(length // span + 1)[:length].tolist()
    return torch.randint(0, cfg.vocab_size, (length,), generator=gen).tolist()


def first_divergence(gpt_lib, model, got: list, want: list, prompt_len: int):
    """Where `got` first leaves `want` (a greedy chain of `model`), with
    the top-2 margin of `model`'s logits at that decision (forced_logits
    along `want`), or None."""
    j = first_diff(got, want)
    if j is None:
        return None
    chain = torch.tensor([want[:j + 1]], device="cuda")
    logits = forced_logits(gpt_lib, model, chain)[0, j - 1]
    top = torch.topk(logits, 2).values
    return {"position": j, "new_index": j - prompt_len, "top2_margin": float(top[0] - top[1]),
            "top_logit": float(top[0])}


def run_int8_decode(gpt_lib, quant, model, twin, smi) -> dict:
    """int8_decode: GPT-small generate, INT8_DECODE rows x prompt x new
    tokens in bf16, in four modes (plain, weights_int8, kv_int8, both; the
    int8 twin quantized once, outside the timing): ms per new token over
    the whole generate (prefill included), then profile_decode's steady
    state (wall and device ms per token, kernels per token, busy share),
    and the weight and KV bytes counted from the tensors. The plain chain
    teacher-forced through each mode (forced_logits): each int8 mode's
    worst logit error over the plain logits' range, and the share of the
    plain chain's greedy tokens its argmax agrees with. Then f32 on the card (TF32 off)
    against f32 on the CPU at INT8_F32_CHECK: the quantized kernels and
    scales bit-equal, _absmax_quantize bit-equal on the same vectors, the
    free-running int8 caches within one step of the int8 grid, the
    prefill's logits within INT8_F32_PREFILL_LOGIT_ATOL, and each decode
    step's logits on the same cache bytes within INT8_F32_LOGIT_RTOL of the
    logit range."""
    cfg = model.cfg
    rows, p, new = INT8_DECODE
    gen = torch.Generator().manual_seed(MODES_SEED)
    prompt = torch.randint(0, cfg.vocab_size, (rows, p), generator=gen).cuda()
    modes = {"plain": (model, False), "weights_int8": (twin, False),
             "kv_int8": (model, True), "both": (twin, True)}
    out, chains = {}, {}
    for name, (m, kv) in modes.items():
        with torch.no_grad():
            gpt_lib.generate(m, prompt[:, :16], 4, kv_quant_int8=kv)  # warm-up
            chain, wall = timed(lambda: gpt_lib.generate(m, prompt, new, kv_quant_int8=kv))
            prof = profile_decode(gpt_lib, m, prompt, kv_quant_int8=kv)
        chains[name] = chain
        cache = gpt_lib.KVCache.zeros(cfg, rows, p + new, "cuda", kv)
        out[name] = {
            "ms_per_new_token": wall / new, "new_tokens_per_s": rows * new / (wall / 1e3),
            "steady_wall_ms_per_token": prof["wall_ms_per_token"],
            "device_ms_per_token": prof["device_ms_per_token"],
            "device_busy_share": prof["device_busy_share"],
            "kernels_per_token": prof["kernels_per_token"], "top_kernels": prof["top"][:3],
            "weight_bytes": gpt_lib.weight_bytes(m), "kv_bytes": gpt_lib._kv_bytes(cache),
        }
        del cache
    plain_chain = chains["plain"]
    decided = slice(p - 1, p + new - 1)
    with torch.no_grad():
        ref = forced_logits(gpt_lib, model, plain_chain)
        span = float(ref.max() - ref.min())
        for name, (m, kv) in modes.items():
            if name == "plain":
                continue
            got = forced_logits(gpt_lib, m, plain_chain, kv)
            out[name]["teacher_forced_max_logit_err_over_range"] = float(
                (got - ref).abs().max()) / span
            out[name]["greedy_agreement_with_plain"] = float(
                (got[:, decided].argmax(-1) == plain_chain[:, p:]).float().mean())
            out[name]["free_running_rows_equal_plain"] = int(
                (chains[name] == plain_chain).all(dim=1).sum())
            del got
        del ref
    free_device_memory()
    out["f32_card_vs_cpu"] = int8_f32_card_vs_cpu(gpt_lib, quant, model)
    report = {"phase": "int8_decode", "card": smi, "model": "GPT-small", "dtype": "bf16",
              "rows": rows, "prompt": p, "new_tokens": new, "modes": out}
    emit(report)
    check = out["f32_card_vs_cpu"]
    problems = [k for k in ("kernels_bit_equal", "absmax_quantize_bit_equal") if not check[k]]
    if check["kv_int8_max_step_diff"] > 1:
        problems.append("an int8 cache value differs by more than one grid step")
    if check["step_logit_err_over_range"] > INT8_F32_LOGIT_RTOL:
        problems.append("the f32 decode step's logits on the same cache differ")
    if check["prefill_logit_max_abs_diff"] > INT8_F32_PREFILL_LOGIT_ATOL:
        problems.append("the f32 int8 prefill's logits differ")
    for name in ("weights_int8", "both"):
        if not out[name]["weight_bytes"] < out["plain"]["weight_bytes"] / 2:
            problems.append(f"{name} holds more than half the f32 weight bytes")
    if problems:
        raise AssertionError(f"int8_decode: {problems}")
    return report


def int8_f32_card_vs_cpu(gpt_lib, quant, model) -> dict:
    """int8_decode's f32 card-against-CPU check (see run_int8_decode)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, p, new = INT8_F32_CHECK
    cfg = dataclasses.replace(model.cfg, dtype=torch.float32)
    twins = {dev: quant.quantize_model(f32_twin(gpt_lib, model, dev)) for dev in ("cpu", "cuda")}
    cpu_state, gpu_state = twins["cpu"].state_dict(), twins["cuda"].state_dict()
    kernels_equal = all(torch.equal(cpu_state[k], gpu_state[k].cpu()) for k in cpu_state
                        if k.endswith(("kernel", "kernel_scale")))
    gen = torch.Generator().manual_seed(MODES_SEED + 1)
    vectors = torch.randn((rows, 64, cfg.num_heads, cfg.head_dim), generator=gen) * 3
    q_cpu, s_cpu = gpt_lib._absmax_quantize(vectors)
    q_gpu, s_gpu = gpt_lib._absmax_quantize(vectors.cuda())
    absmax_equal = torch.equal(q_cpu, q_gpu.cpu()) and torch.equal(s_cpu, s_gpu.cpu())
    prompt = torch.randint(0, cfg.vocab_size, (rows, p), generator=gen)
    with torch.no_grad():
        chain = gpt_lib.generate(twins["cpu"], prompt, new, kv_quant_int8=True)
        gpu_chain = gpt_lib.generate(twins["cuda"], prompt.cuda(), new, kv_quant_int8=True)
        caches = {dev: gpt_lib.KVCache.zeros(cfg, rows, p + new, dev, True)
                  for dev in ("cpu", "cuda")}
        prefill = {dev: gpt_lib.GPTPrefill(twins[dev])(prompt.to(dev), caches[dev])
                   for dev in ("cpu", "cuda")}
        step_diff = max(int((a.int() - b.cpu().int()).abs().max())
                        for a, b in zip(caches["cpu"].tensors(), caches["cuda"].tensors())
                        if a.dtype == torch.int8)
        steps = {dev: gpt_lib.GPTDecodeStep(twins[dev]) for dev in ("cpu", "cuda")}
        worst, span = 0.0, 0.0
        for index in range(p, p + new - 1):
            for a, b in zip(caches["cpu"].tensors(), caches["cuda"].tensors()):
                b.copy_(a)  # both read the CPU's cache bytes
            tok = chain[:, index]
            want = steps["cpu"](tok, index, caches["cpu"])
            got = steps["cuda"](tok.cuda(), index, caches["cuda"]).cpu()
            span = max(span, float(want.max() - want.min()))
            worst = max(worst, float((got - want).abs().max()))
    return {
        "rows": rows, "prompt": p, "new_tokens": new, "kernels_bit_equal": kernels_equal,
        "absmax_quantize_bit_equal": absmax_equal,
        "kv_int8_max_step_diff": step_diff,
        "prefill_logit_max_abs_diff": float((prefill["cuda"].cpu() - prefill["cpu"]).abs().max()),
        "prefill_logit_atol": INT8_F32_PREFILL_LOGIT_ATOL,
        "step_logit_err_over_range": worst / span, "bound": INT8_F32_LOGIT_RTOL,
        "chains_equal": bool(torch.equal(chain, gpu_chain.cpu())),
    }


def modes_requests(cfg, seed: int, count: int, prompt_range, new_range) -> list:
    """`count` seeded requests, every other one a repeated span (where the
    prompt lookup can hit), the rest random; prompts in prompt_range, new
    tokens in new_range."""
    gen = torch.Generator().manual_seed(seed)
    reqs = []
    for i in range(count):
        length = int(torch.randint(prompt_range[0], prompt_range[1] + 1, (1,), generator=gen))
        span = int(torch.randint(8, 49, (1,), generator=gen)) if i % 2 == 0 else 0
        new = int(torch.randint(new_range[0], new_range[1] + 1, (1,), generator=gen))
        reqs.append({"prompt": spec_prompt(cfg, gen, length, span), "new": new})
    return reqs


def run_engine(engine, reqs, registry=None) -> dict:
    """Submit every request at once and wait: -> wall seconds, tokens/s and
    inter-token p50/p95 (from `registry`'s histogram); each request's
    chain lands in req["chain"]."""
    from tf_operator_tpu_torch.telemetry import quantile_from_flat

    start = time.monotonic()
    handles = [engine.submit(r["prompt"], r["new"]) for r in reqs]
    for r, h in zip(reqs, handles):
        r["chain"] = h.result(600)
    wall = time.monotonic() - start
    out = {"wall_s": wall, "generated_tokens_per_s": sum(r["new"] for r in reqs) / wall}
    if registry is not None:
        flat = {}
        for line in registry.render().splitlines():
            if line and not line.startswith("#"):
                name, value = line.split()
                flat[name] = float(value)
        for q, p in (("p50", 0.5), ("p95", 0.95)):
            out[f"itl_{q}_s"] = quantile_from_flat(flat, "modes_inter_token_seconds", p)
    return out


def int8_bytes_check(gpt_lib, twin) -> dict:
    """The dense int8 cache and the paged int8 pool fed the same grid:
    SlotDecodeStep and PagedSlotDecodeStep with both int8 flags at
    SERVE_SLOTS slots x max_seq_len, BYTES_STEPS steps of a seeded ragged
    grid; each step's tokens equal, then every slot's positions hold the
    same int8 values and scales byte for byte."""
    import numpy as np

    cfg = twin.cfg
    n, total, bs = SERVE_SLOTS, cfg.max_seq_len, SERVE_BLOCK
    mb = total // bs
    flags = dict(kv_quant_int8=True, weights_int8=True)
    dense = gpt_lib.SlotDecodeStep(twin, n, total, **flags)
    paged = gpt_lib.PagedSlotDecodeStep(twin, n, total, bs, n * mb + 1, **flags)
    rng = np.random.default_rng(MODES_SEED + 2)
    lens = rng.integers(4, 40, n).astype(np.int32)
    prompt = np.zeros((n, total), np.int32)
    for i, length in enumerate(lens):
        prompt[i, :length] = rng.integers(0, cfg.vocab_size, length)
    tables = (1 + rng.permutation(n * mb)).reshape(n, mb).astype(np.int32)
    tok, index = prompt[:, 0].copy(), np.zeros(n, np.int32)
    tokens_equal = True
    for _ in range(BYTES_STEPS):
        got = dense(tok, index, prompt, lens).cpu().numpy()
        tokens_equal &= bool((paged(tok, index, prompt, lens, tables).cpu().numpy() == got).all())
        tok, index = got.astype(np.int32), index + 1
    unequal = 0
    for d, p in zip(dense.cache.tensors(), paged.cache.tensors()):
        for row in range(n):
            table = torch.as_tensor(tables[row], device="cuda").long()
            logical = p[table].reshape(total, *p.shape[2:])
            unequal += int((logical[:BYTES_STEPS] != d[row, :BYTES_STEPS]).sum())
    out = {"steps": BYTES_STEPS, "slots": n, "tokens_equal": tokens_equal,
           "unequal_bytes": unequal, "tensors": len(dense.cache.tensors())}
    del dense, paged
    return out


def run_int8_serve(gpt_lib, twin, smi) -> dict:
    """int8_serve: the paged engine over the int8 twin with both int8 flags at
    SERVE_SLOTS slots (the server's defaults otherwise): INT8_SERVE_REQUESTS
    seeded requests submitted at once (tokens/s, inter-token p50/p95), the
    pool's bytes against a bf16 pool's, serve_step_timings (the captured step
    and eager, device ms by kind, the int8 kernels' casts to bf16 alone);
    every served chain replayed through the captured int8 step and prefill
    chunk against GPTDecodeStep and GPTPrefill over an int8 dense cache
    (replay_served: the step's logits within SERVE_STEP_LOGIT_RTOL, the
    chunks' keys, values and scales within INT8_PREFILL_KV_RTOL, each served
    token the step's argmax or a near-tie); the control: planted_replay's
    faults on an int8 pool (the group with the most prefill chunks) must
    fail both checks; the dense int8 cache against the paged int8 pool byte
    for byte (int8_bytes_check); one capture each."""
    from tf_operator_tpu_torch.serve.engine import ContinuousBatchingEngine
    from tf_operator_tpu_torch.telemetry import MetricRegistry

    cfg = twin.cfg
    registry = MetricRegistry("modes")
    engine = ContinuousBatchingEngine(twin, n_slots=SERVE_SLOTS, kv_quant_int8=True,
                                      weights_int8=True, registry=registry, device="cuda",
                                      block_size=SERVE_BLOCK, prefill_chunk=SERVE_CHUNK)
    reqs = modes_requests(cfg, MODES_SEED + 3, INT8_SERVE_REQUESTS, INT8_SERVE_PROMPT,
                          INT8_SERVE_NEW)
    try:
        load = run_engine(engine, reqs, registry)
    finally:
        engine.stop()
    bf16_pool = 2 * cfg.num_layers * engine.step.num_blocks * SERVE_BLOCK * cfg.hidden_size * 2
    timings = serve_step_timings(engine)
    order = sorted(range(len(reqs)), key=lambda i: len(reqs[i]["chain"]))
    groups = [[reqs[i] for i in order[k:k + SERVE_SLOTS]]
              for k in range(0, len(order), SERVE_SLOTS)]
    for group in groups:
        for r, got in zip(group, replay_served(gpt_lib, engine.step, twin, group, SERVE_CHUNK)):
            r.update(got)
    import numpy as np

    logit_rel = np.concatenate([r["logit_rel"] for r in reqs])
    kv_rel = [r["prefill_kv_rel"] for r in reqs if r["prefill_kv_rel"] is not None]
    replay_differ = []
    for i, r in enumerate(reqs):
        want = r["chain"][len(r["prompt"]):]
        for k, (token, m, bound) in enumerate(r["decisions"].tolist()):
            if int(token) != want[k]:
                replay_differ.append({"request": i, "position": len(r["prompt"]) + k,
                                      "margin": m, "bound": bound})
    planted = planted_replay(gpt_lib, engine, max(
        groups, key=lambda g: sum((len(r["prompt"]) - 1) // SERVE_CHUNK for r in g)), SERVE_CHUNK)
    bytes_check = int8_bytes_check(gpt_lib, twin)
    report = {
        "phase": "int8_serve", "card": smi, "model": "GPT-small int8 twin",
        "kv_int8": True, "weights_int8": True, "slots": SERVE_SLOTS,
        "requests": len(reqs), **load,
        "kv_pool_bytes": engine.step.kv_bytes_total, "bf16_pool_bytes": bf16_pool,
        "pool_bytes_over_bf16": engine.step.kv_bytes_total / bf16_pool,
        "weight_bytes": gpt_lib.weight_bytes(twin),
        "compiles": engine.step.compiles, "prefill_compiles": engine.step.prefill_compiles,
        "step": timings,
        "replay_positions": len(logit_rel),
        "replay_logit_rel_l2": {"worst": float(logit_rel.max()),
                                "exact_share": float((logit_rel == 0).mean())},
        "replay_logit_rtol": SERVE_STEP_LOGIT_RTOL,
        "prefill_kv_rel_l2_worst": max(kv_rel) if kv_rel else None,
        "prefill_kv_rtol": INT8_PREFILL_KV_RTOL,
        "replay_decisions_differing_from_served": len(replay_differ),
        "replay_differences": replay_differ[:10],
        "planted": planted,
        "dense_vs_paged": bytes_check,
    }
    emit(report)
    problems = []
    if logit_rel.max() > SERVE_STEP_LOGIT_RTOL:
        problems.append("the captured int8 step's logits differ from GPTDecodeStep's")
    if kv_rel and max(kv_rel) > INT8_PREFILL_KV_RTOL:
        problems.append("the captured int8 chunks' cache differs from GPTPrefill's")
    if planted["logit_rel_worst"] <= SERVE_STEP_LOGIT_RTOL:
        problems.append("the planted mask fault passed the int8 step's logit check")
    if planted["prefill_kv_rel_worst"] <= INT8_PREFILL_KV_RTOL:
        problems.append("the planted causal leak passed the int8 prefill check")
    if any(d["margin"] > d["bound"] for d in replay_differ):
        problems.append("a served token is not the replayed int8 step's argmax above the margin")
    if not bytes_check["tokens_equal"] or bytes_check["unequal_bytes"]:
        problems.append("the paged int8 pool and the dense int8 cache differ")
    if (engine.step.compiles, engine.step.prefill_compiles) != (1, 1):
        problems.append("a program was captured other than once")
    if problems:
        raise AssertionError(f"int8_serve: {problems}")
    del engine
    free_device_memory()
    return report


def run_beam_search(gpt_lib, model, smi) -> dict:
    """beam_search: GPT-small, BEAM rows x beams x prompt x new tokens in bf16:
    num_beams=1 equal to greedy generate; ms per generated position; the
    parent gather (every cache tensor's index_select by the surviving
    beams' parents) timed alone on the search's cache shape, and its share
    of a step; scores sorted best first. At f32 (TF32 off): the scores
    against the teacher-forced sum of each beam's log-probabilities through
    GPTDecodeStep within BEAM_SCORE_ATOL; the same reported in bf16."""
    cfg = model.cfg
    rows, beams, p, new = BEAM
    gen = torch.Generator().manual_seed(MODES_SEED + 4)
    prompt = torch.randint(0, cfg.vocab_size, (rows, p), generator=gen).cuda()

    def recompute(m, seqs):
        flat = seqs.reshape(rows * beams, -1)
        logp = torch.log_softmax(teacher_forced(gpt_lib, m, flat), dim=-1)
        picked = logp[:, p - 1:-1].gather(2, flat[:, p:, None])[..., 0]
        return picked.sum(dim=1).reshape(rows, beams)

    with torch.no_grad():
        one, _ = gpt_lib.beam_search(model, prompt, new, num_beams=1)
        greedy_equal = bool(torch.equal(one[:, 0], gpt_lib.generate(model, prompt, new)))
        gpt_lib.beam_search(model, prompt[:, :8], 4, num_beams=beams)  # warm-up
        (seqs, scores), wall = timed(lambda: gpt_lib.beam_search(model, prompt, new,
                                                                 num_beams=beams))
        cache = gpt_lib.KVCache.zeros(cfg, rows * beams, p + new, "cuda")
        parents = torch.randint(0, rows * beams, (rows * beams,), device="cuda")
        gather_ms = median_ms(lambda: [t.copy_(t.index_select(0, parents))
                                       for t in cache.tensors()])
        del cache
        bf16_err = float((recompute(model, seqs) - scores).abs().max())
        torch.backends.cuda.matmul.allow_tf32 = False
        model32 = f32_twin(gpt_lib, model, "cuda")
        seqs32, scores32 = gpt_lib.beam_search(model32, prompt, new, num_beams=beams)
        f32_err = float((recompute(model32, seqs32) - scores32).abs().max())
    sorted_ok = all(bool((s[:, :-1] >= s[:, 1:]).all()) for s in (scores, scores32))
    report = {
        "phase": "beam_search", "card": smi, "model": "GPT-small", "rows": rows, "beams": beams,
        "prompt": p, "new_tokens": new, "ms_per_step": wall / new,
        "parent_gather_ms": gather_ms, "parent_gather_share_of_step": gather_ms / (wall / new),
        "beam1_equals_greedy": greedy_equal, "scores_sorted": sorted_ok,
        "f32_score_vs_teacher_forced_max_abs": f32_err, "bound": BEAM_SCORE_ATOL,
        "bf16_score_vs_teacher_forced_max_abs": bf16_err,
        "best_scores_bf16": scores[:, 0].tolist(), "best_scores_f32": scores32[:, 0].tolist(),
        "f32_best_beam_equals_bf16": bool(torch.equal(seqs32[:, 0], seqs[:, 0])),
    }
    emit(report)
    del model32
    free_device_memory()
    if not greedy_equal or not sorted_ok or f32_err > BEAM_SCORE_ATOL:
        raise AssertionError(f"beam_search: {report}")
    return report


def run_spec_generate(gpt_lib, model, smi) -> dict:
    """spec_generate: GPT-small generate_speculative, 1 row, SPEC_NEW new
    tokens, draft_k SPEC_K, ngram SPEC_NGRAM, on two SPEC_PROMPT-token
    prompts (a SPEC_SPAN-token span repeated, and one drawn at random):
    at f32 (TF32 off) each chain equal to generate's (and the rounds); in
    bf16 tokens committed per round, ms per token beside generate's, and
    whether the chains differ, with the first divergence and generate's
    top-2 margin there. Over the two and SPEC_BF16_PROMPTS more bf16
    prompts of both kinds (SPEC_BF16_NEW tokens): the share of speculative
    chains that differ from generate's, and each first divergence's
    margin (a verify over k + 1 rows runs GEMMs of another M than the
    one-row step, so near-ties can flip in bf16)."""
    cfg = model.cfg
    gen = torch.Generator().manual_seed(MODES_SEED + 5)
    prompts = {"repeated": spec_prompt(cfg, gen, SPEC_PROMPT, SPEC_SPAN),
               "random": spec_prompt(cfg, gen, SPEC_PROMPT)}
    torch.backends.cuda.matmul.allow_tf32 = False
    model32 = f32_twin(gpt_lib, model, "cuda")
    out = {}
    with torch.no_grad():
        gpt_lib.generate_speculative(model, torch.tensor([prompts["random"][:16]]).cuda(), 8)
        for name, row in prompts.items():
            ids = torch.tensor([row]).cuda()
            spec32, rounds32 = gpt_lib.generate_speculative(
                model32, ids, SPEC_NEW, draft_k=SPEC_K, ngram=SPEC_NGRAM, return_rounds=True)
            plain32 = gpt_lib.generate(model32, ids, SPEC_NEW)
            (spec, rounds), spec_ms = timed(lambda: gpt_lib.generate_speculative(
                model, ids, SPEC_NEW, draft_k=SPEC_K, ngram=SPEC_NGRAM, return_rounds=True))
            plain, plain_ms = timed(lambda: gpt_lib.generate(model, ids, SPEC_NEW))
            out[name] = {
                "f32_equal_generate": bool(torch.equal(spec32, plain32)), "f32_rounds": rounds32,
                "rounds": rounds, "tokens_per_round": (SPEC_NEW - 1) / rounds,
                "ms_per_token": spec_ms / SPEC_NEW, "generate_ms_per_token": plain_ms / SPEC_NEW,
                "speedup": plain_ms / spec_ms,
                "bf16_divergence": first_divergence(gpt_lib, model, spec[0].tolist(),
                                                    plain[0].tolist(), SPEC_PROMPT),
            }
        share = [v["bf16_divergence"] for v in out.values()]
        for i in range(SPEC_BF16_PROMPTS):
            row = spec_prompt(cfg, gen, SPEC_PROMPT, SPEC_SPAN if i % 2 == 0 else 0)
            ids = torch.tensor([row]).cuda()
            spec = gpt_lib.generate_speculative(model, ids, SPEC_BF16_NEW, draft_k=SPEC_K,
                                                ngram=SPEC_NGRAM)[0].tolist()
            plain = gpt_lib.generate(model, ids, SPEC_BF16_NEW)[0].tolist()
            share.append(first_divergence(gpt_lib, model, spec, plain, SPEC_PROMPT))
    report = {"phase": "spec_generate", "card": smi, "model": "GPT-small", "rows": 1,
              "prompt": SPEC_PROMPT, "new_tokens": SPEC_NEW, "draft_k": SPEC_K,
              "ngram": SPEC_NGRAM, "prompts": out,
              "bf16_chains": len(share),
              "bf16_share_differing": sum(d is not None for d in share) / len(share),
              "bf16_divergences": [d for d in share if d is not None]}
    emit(report)
    del model32
    free_device_memory()
    if not all(v["f32_equal_generate"] for v in out.values()):
        raise AssertionError(f"spec_generate: an f32 speculative chain differs: {out}")
    return report


def _clamping_verify_attention(kv, index, tables):
    """A planted fault for spec_serve: the paged verify attention with the
    positions past the table clamped into its last entry (a real block
    holding committed keys and values) instead of sent to the sentinel."""
    from tf_operator_tpu_torch.models import gpt as gpt_lib

    def attend(query, key, value, mask):
        slots, k1 = key.shape[:2]
        bs = kv[0].shape[1]
        pos = index[:, None] + torch.arange(k1, device=index.device)[None, :]
        phys = tables.gather(1, (pos // bs).clamp(max=tables.shape[1] - 1))
        flat = slots * k1
        return gpt_lib._paged_kv(kv, key.reshape(flat, *key.shape[2:]),
                                 value.reshape(flat, *value.shape[2:]), phys.reshape(flat),
                                 (pos % bs).reshape(flat), query, tables, mask)

    return attend


def verify_step_ms(engine) -> dict:
    """The verify program at SERVE_SLOTS active slots (each at position 1023
    of its own blocks) as its captured graph, beside the single-token step's
    graph: median wall ms a call, next tokens to the host."""
    import numpy as np

    n, mb, k1 = engine.n_slots, engine.max_blocks, engine.spec_depth + 1
    rng = np.random.default_rng(MODES_SEED + 6)
    base = (np.full(n, 1023, np.int32), np.zeros((n, engine.max_total), np.int32),
            np.ones(n, np.int32), (1 + np.arange(n * mb, dtype=np.int32)).reshape(n, mb))
    toks = rng.integers(0, engine.cfg.vocab_size, (n, k1)).astype(np.int32)
    out = {}
    for name, fn in (("verify", lambda: engine.step.verify(toks, *base).cpu()),
                     ("step", lambda: engine.step(toks[:, 0], *base).cpu())):
        for _ in range(3):
            fn()
        times = []
        for _ in range(SERVE_STEP_REPS):
            _, ms = timed(fn)
            times.append(ms)
        out[f"{name}_graph_ms"] = statistics.median(times)
    out["window"] = k1
    engine.pool.flush()
    return out


def draft_near_max_total(tiny, draft) -> dict:
    """Draft mode at GPT_TINY + GPT_DRAFT (f32), driven by hand: a request
    ending at max_total (prompt max_total - 2, 2 new) beside a fresh slot
    whose prompt rides the forcing rule at depth 3, so the first row, at
    depth 0 one token from its end, steps on with the draft grid past the
    cache's last position (the engine clamps the draft's positions). ->
    both chains against speculate off's, and the draft grid's highest
    position before the clamp."""
    from tf_operator_tpu_torch.serve.engine import ContinuousBatchingEngine

    cfg = tiny.cfg
    near = [(i * 11) % cfg.vocab_size for i in range(cfg.max_seq_len - 2)]
    fresh = [(i * 5 + 3) % cfg.vocab_size for i in range(16)]
    chains, peak = {}, []
    for speculate in ("off", "draft"):
        engine = ContinuousBatchingEngine(tiny, n_slots=2, start=False, device="cuda",
                                          block_size=8, prefill_chunk=16,
                                          speculate=speculate, spec_depth=3, draft_model=draft)
        if speculate == "draft":
            step = engine.draft

            class Recorder:
                def __getattr__(self, name):
                    return getattr(step, name)

                def __call__(self, *args):
                    peak.append(int(engine._d_index.max()))
                    return step(*args)

            engine.draft = Recorder()
        try:
            head = engine.submit(near, 2)
            while int(engine._index[0]) < len(near) - 6:  # prefill, then forcing
                engine._admit()
                engine._work_once()
            handles = [head, engine.submit(fresh, 20)]
            while not all(h.done.is_set() for h in handles):
                engine._admit()
                if engine.active_slots:
                    engine._work_once()
            chains[speculate] = [h.result(1) for h in handles]
        finally:
            engine.stop()
    return {"chains_equal_off": chains["draft"] == chains["off"],
            "draft_index_peak_before_clamp": max(peak), "max_total": cfg.max_seq_len}


def run_spec_serve(gpt_lib, model, smi) -> dict:
    """spec_serve: the paged engine over GPT-small at SERVE_SLOTS slots, one
    request set (SPEC_SERVE_REQUESTS, half repeated spans) with speculate
    off and then ngram (spec_depth SPEC_DEPTH) in bf16: tokens/s,
    inter-token p50/p95, the accept rate, rounds, fallback steps, the final
    adaptive depths, and the verify program's ms as a graph beside the
    step's; the share of ngram chains differing from off's, with each first
    divergence's margin. At f32 (TF32 off) the set's first SERVE_SLOTS
    requests through both: every chain equal. Draft mode at GPT_TINY + GPT_DRAFT (f32): the
    chains of off, also where the draft grid steps past max_total
    (draft_near_max_total). Near max_total (a prompt of max_seq_len - 3 tokens, 3
    new, f32) the ngram chain equals off's, and so do the committed keys and
    values of the table's last block within SPEC_COMMITTED_KV_RTOL (the
    clean verify sends its overshoot to the sentinel); the planted control,
    a verify that clamps overshoot into the table's last entry, must move
    them past that bound, and the last verify's logits against the clean one's and
    whether the chain then differs are reported (the overwritten position
    is one of max_seq_len a decision attends over)."""
    from tf_operator_tpu_torch.serve.engine import ContinuousBatchingEngine
    from tf_operator_tpu_torch.telemetry import MetricRegistry

    cfg = model.cfg
    reqs = modes_requests(cfg, MODES_SEED + 7, SPEC_SERVE_REQUESTS, SPEC_SERVE_PROMPT,
                          SPEC_SERVE_NEW)

    def serve(m, speculate, requests, registry=None, draft=None, **kw):
        kw.setdefault("block_size", SERVE_BLOCK)
        kw.setdefault("prefill_chunk", SERVE_CHUNK)
        engine = ContinuousBatchingEngine(m, n_slots=SERVE_SLOTS, device="cuda",
                                          speculate=speculate, spec_depth=SPEC_DEPTH,
                                          registry=registry, draft_model=draft, **kw)
        rs = [dict(r) for r in requests]
        try:
            load = run_engine(engine, rs, registry)
        finally:
            engine.stop()
        return engine, rs, load

    runs = {}
    for speculate in ("off", "ngram"):
        registry = MetricRegistry("modes")
        engine, rs, load = serve(model, speculate, reqs, registry)
        entry = {**load, "steps": engine.steps}
        if speculate == "ngram":
            entry.update({
                "spec_rounds": engine.spec_rounds, "spec_proposed": engine.spec_proposed,
                "spec_accepted": engine.spec_accepted,
                "accept_rate": engine.spec_accepted / max(engine.spec_proposed, 1),
                "fallback_steps": engine.spec_fallback_steps,
                "final_depths": engine._slot_depth.tolist(),
                "verify_compiles": engine.step.verify_compiles,
                **verify_step_ms(engine),
            })
        runs[speculate] = (entry, rs)
        del engine
        free_device_memory()
    divergences = [first_divergence(gpt_lib, model, a["chain"], b["chain"], len(a["prompt"]))
                   for a, b in zip(runs["ngram"][1], runs["off"][1])]
    torch.backends.cuda.matmul.allow_tf32 = False
    model32 = f32_twin(gpt_lib, model, "cuda")
    f32 = {}
    for speculate in ("off", "ngram"):
        engine, rs, _ = serve(model32, speculate, reqs[:SERVE_SLOTS])
        f32[speculate] = [r["chain"] for r in rs]
        del engine
        free_device_memory()
    f32_equal = f32["off"] == f32["ngram"]
    near = [{"prompt": [(i * 11) % cfg.vocab_size for i in range(cfg.max_seq_len - 3)],
             "new": 3}]
    near_chains, committed, last_logits = {}, {}, {}
    for label in ("off", "ngram", "planted"):
        saved = gpt_lib._paged_verify_attention
        if label == "planted":
            gpt_lib._paged_verify_attention = _clamping_verify_attention
        try:
            engine, rs, _ = serve(model32, "off" if label == "off" else "ngram", near)
        finally:
            gpt_lib._paged_verify_attention = saved
        near_chains[label] = rs[0]["chain"]
        # a fresh pool hands the request blocks 1..max_blocks in order: the
        # table's last entry is block max_blocks, whose first position a
        # clamped overshoot (position max_total) lands on
        committed[label] = [t[engine.max_blocks, 0].clone() for t in engine.step.cache.tensors()]
        if engine.step.verify_logits is not None:
            last_logits[label] = engine.step.verify_logits.float().clone()
        del engine
    del model32
    free_device_memory()
    tiny_cfg = dataclasses.replace(gpt_lib.GPT_TINY, dtype=torch.float32)
    tiny = gpt_lib.GPT(tiny_cfg, generator=torch.Generator().manual_seed(MODES_SEED),
                       device="cuda")
    draft = gpt_lib.GPT(dataclasses.replace(gpt_lib.GPT_DRAFT, dtype=torch.float32),
                        generator=torch.Generator().manual_seed(MODES_SEED + 1), device="cuda")
    tiny_reqs = modes_requests(tiny_cfg, MODES_SEED + 8, 8, (4, 64), (8, 48))
    tiny_chains, draft_counts = {}, None
    for speculate in ("off", "draft"):
        engine, rs, _ = serve(tiny, speculate, tiny_reqs, draft=draft, block_size=8,
                              prefill_chunk=8)
        tiny_chains[speculate] = [r["chain"] for r in rs]
        if speculate == "draft":
            draft_counts = {"spec_rounds": engine.spec_rounds,
                            "spec_accepted": engine.spec_accepted,
                            "draft_compiles": engine.draft.compiles}
    draft_near = draft_near_max_total(tiny, draft)
    report = {
        "phase": "spec_serve", "card": smi, "model": "GPT-small", "slots": SERVE_SLOTS,
        "spec_depth": SPEC_DEPTH, "requests": len(reqs),
        "off": runs["off"][0], "ngram": runs["ngram"][0],
        "tokens_per_s_ngram_over_off": (runs["ngram"][0]["generated_tokens_per_s"]
                                        / runs["off"][0]["generated_tokens_per_s"]),
        "bf16_share_differing": sum(d is not None for d in divergences) / len(divergences),
        "bf16_divergences": [d for d in divergences if d is not None],
        "f32_chains_equal": f32_equal,
        "draft_tiny": {"chains_equal_off": tiny_chains["off"] == tiny_chains["draft"],
                       **draft_counts, "near_max_total": draft_near},
        "near_max_total": {
            "ngram_equals_off": near_chains["ngram"] == near_chains["off"],
            "ngram_committed_kv_rel_l2_vs_off": max(
                rel(a, b) for a, b in zip(committed["ngram"], committed["off"])),
            "ngram_committed_kv_bit_equal_off": all(
                torch.equal(a, b) for a, b in zip(committed["ngram"], committed["off"])),
            "planted_committed_kv_rel_l2_vs_off": max(
                rel(a, b) for a, b in zip(committed["planted"], committed["off"])),
            "committed_kv_rtol": SPEC_COMMITTED_KV_RTOL,
            "planted_overwrites_committed_kv": any(
                not torch.equal(a, b) for a, b in zip(committed["planted"], committed["ngram"])),
            "planted_chain_differs": near_chains["planted"] != near_chains["off"],
            "planted_last_verify_logits_max_abs_diff": float(
                (last_logits["planted"] - last_logits["ngram"]).abs().max())},
    }
    emit(report)
    del tiny, draft
    free_device_memory()
    problems = []
    if not f32_equal:
        problems.append("an f32 ngram chain differs from speculate off's")
    if not report["draft_tiny"]["chains_equal_off"] or draft_counts["draft_compiles"] != 1:
        problems.append("draft mode at GPT_TINY differs from off")
    if (not draft_near["chains_equal_off"]
            or draft_near["draft_index_peak_before_clamp"] < draft_near["max_total"]):
        problems.append("draft mode near max_total differs from off or never stepped past it")
    if not report["near_max_total"]["ngram_equals_off"]:
        problems.append("the near-max_total chain differs under ngram")
    near_max = report["near_max_total"]
    if near_max["ngram_committed_kv_rel_l2_vs_off"] > SPEC_COMMITTED_KV_RTOL:
        problems.append("the ngram verify moved the chain's committed KV off speculate off's")
    if (not near_max["planted_overwrites_committed_kv"]
            or near_max["planted_committed_kv_rel_l2_vs_off"] <= SPEC_COMMITTED_KV_RTOL):
        problems.append("the planted clamping verify left the chain's committed KV intact")
    if runs["ngram"][0]["verify_compiles"] != 1 or not runs["ngram"][0]["spec_rounds"]:
        problems.append("the verify program was not captured once or never ran")
    if problems:
        raise AssertionError(f"spec_serve: {problems}")
    return report


def serve_cli(args: list, log_path: str):
    """`python -m tf_operator_tpu_torch.serve` with args on 127.0.0.1 and a
    free port, its output to log_path: -> (process, port, log file)."""
    port = free_port()
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tf_operator_tpu_torch.serve", *args, "--host", "127.0.0.1",
         "--port", str(port)], stdout=log, stderr=subprocess.STDOUT)
    return proc, port, log


def stop_cli(proc, log) -> int:
    """SIGTERM, then the exit code (killed after 120 s)."""
    import signal

    try:
        proc.send_signal(signal.SIGTERM)
        return proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def run_decode_modes_serve(gpt_lib, quant, server_lib, smi) -> dict:
    """decode_modes_serve: `python -m tf_operator_tpu_torch.serve --preset small
    --kv-int8 --weights-int8` as a subprocess, once with --batching continuous
    --speculate ngram (paged) and once with --speculative (inline), each on
    the seed-0 random weights; in process the same weights quantized once.
    Engine: DecodeClient greedy chains against in-process generate of the
    twin with the int8 cache, first differing only at a decision within
    SERVE_MARGIN_ULPS (the verify's GEMMs are not the one-token step's in
    bf16), the verify rounds ran. Inline: single-row chains equal to
    in-process generate_speculative, a multi-row request falls back. Both:
    a num_beams 4 request returns 4 beams sorted best first, its best beam
    in "tokens"; ragged and streamed beams are 400s in the reference's
    words; SIGTERM ends the server with exit 0. Refused at startup, exit 2
    with the reference's text: --speculate draft at GPT-small (vocab 32000
    against the draft presets' 512), and --batching continuous with
    --speculative. The four processes start together (the two servers
    boot side by side, boot_s each from that start)."""
    import os
    import tempfile

    from tf_operator_tpu_torch.serve.client import DecodeClient

    work = tempfile.mkdtemp(prefix="modes-serve-")
    twin = quant.quantize_model(server_lib.load_model("small", None, torch.device("cuda")))
    cfg = twin.cfg
    reqs = modes_requests(cfg, MODES_SEED + 9, 4, (64, 256), (MODES_SERVE_NEW, MODES_SERVE_NEW))
    flags = ["--preset", "small", "--kv-int8", "--weights-int8"]
    beam_prompt = [reqs[1]["prompt"][:32]]
    refusal_cases = (
        ("draft_at_small", ["--batching", "continuous", "--speculate", "draft"],
         "draft vocab 512 != target vocab 32000 (the draft must share the tokenizer)"),
        ("continuous_and_speculative", ["--batching", "continuous", "--speculative"],
         "--batching continuous is mutually exclusive with --speculative"),
    )
    start = time.monotonic()
    servers, refusing, out, refused = {}, {}, {}, {}
    try:
        for name, extra in (("engine", ["--batching", "continuous", "--speculate", "ngram"]),
                            ("inline", ["--speculative"])):
            servers[name] = serve_cli(flags + extra, os.path.join(work, f"{name}.log"))
        for name, extra, _ in refusal_cases:
            refusing[name] = subprocess.Popen(
                [sys.executable, "-m", "tf_operator_tpu_torch.serve", *flags, *extra],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in ("engine", "inline"):
            proc, port, log = servers[name]
            wait_for_health(port, proc, MODES_SERVE_TIMEOUT_S)
            boot_s = time.monotonic() - start
            client = DecodeClient(f"http://127.0.0.1:{port}", timeout=600)
            for r in reqs:
                r[name] = client.generate([r["prompt"]], max_new_tokens=r["new"])[0]
            multi = client.generate([r["prompt"][:32] for r in reqs[:2]], max_new_tokens=8)
            flat = client.metrics()
            health = client.healthy()
            beam = post_json(port, "/generate", {"input_ids": beam_prompt, "max_new_tokens": 8,
                                                 "num_beams": 4})
            refusals = {
                "ragged_beams": post_json(port, "/generate", {
                    "input_ids": [[1, 2, 3], [4, 5]], "num_beams": 2}),
                "stream_beams": post_json(port, "/generate_stream", {
                    "input_ids": [[1, 2, 3]], "num_beams": 2}),
            }
            code = stop_cli(proc, log)
            out[name] = {"boot_s": boot_s, "health": {k: health.get(k) for k in (
                             "status", "kv_int8", "weights_int8")},
                         "multi_row": multi, "beam": beam, "refusals": refusals,
                         "sigterm_exit_code": code,
                         "spec_rounds": flat.get("tf_operator_tpu_serve_spec_rounds_total"),
                         "speculative_decodes": flat.get(
                             "tf_operator_tpu_serve_speculative_decodes_total")}
        for name, _, text in refusal_cases:
            output, _ = refusing[name].communicate(timeout=MODES_REFUSAL_TIMEOUT_S)
            refused[name] = {"exit_code": refusing[name].returncode,
                             "text_found": text in output}
    finally:
        for proc, _, log in servers.values():
            if proc.poll() is None:
                stop_cli(proc, log)
        for proc in refusing.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    # in process, on the same weights
    chains, logits = inline_chains(gpt_lib, twin, reqs, kv_quant_int8=True)
    engine_differ, inline_equal = [], []
    for i, r in enumerate(reqs):
        p = len(r["prompt"])
        want = chains[i, :p + r["new"]].tolist()
        j = first_diff(r["engine"], want)
        if j is not None:
            _, m, bound = decisions(logits[j - 1, i]).tolist()
            engine_differ.append({"request": i, "position": j, "margin": m, "bound": bound})
        with torch.no_grad():
            spec = gpt_lib.generate_speculative(twin, torch.tensor([r["prompt"]]).cuda(),
                                                r["new"], ngram=2, kv_quant_int8=True)
        inline_equal.append(r["inline"] == spec[0].tolist())
    del logits
    with torch.no_grad():
        multi_want = gpt_lib.generate(twin, torch.tensor([r["prompt"][:32] for r in reqs[:2]]
                                                         ).cuda(), 8, kv_quant_int8=True).tolist()
        seqs, _ = gpt_lib.beam_search(twin, torch.tensor(beam_prompt).cuda(), 8, num_beams=4,
                                      kv_quant_int8=True)

    def summary(o):
        status, body = o["beam"]
        return {**{k: v for k, v in o.items() if k not in ("beam", "multi_row")},
                "beam_status": status,
                "beam_scores": body.get("beam_scores") if status == 200 else body,
                "beams_equal_in_process": status == 200 and body["beams"] == seqs.tolist()}

    report = {
        "phase": "decode_modes_serve", "card": smi, "model": "GPT-small, random weights seed 0",
        "flags": flags, "requests": len(reqs), "new_tokens": MODES_SERVE_NEW,
        "engine": summary(out["engine"]), "inline": summary(out["inline"]),
        "engine_chains_differing_from_inline": len(engine_differ),
        "engine_differences": engine_differ, "margin_ulps": SERVE_MARGIN_ULPS,
        "inline_chains_equal_generate_speculative": inline_equal,
        "multi_row_fallback_equal_generate": out["inline"]["multi_row"] == multi_want,
        "refused_at_startup": refused,
    }
    emit(report)
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    problems = []
    if any(d["margin"] > d["bound"] for d in engine_differ):
        problems.append("an engine chain differs from inline generate above the margin")
    if not all(inline_equal) or not report["multi_row_fallback_equal_generate"]:
        problems.append("the inline speculative path differs from in-process decode")
    for n, o in out.items():
        status, body = o["beam"]
        scores = body.get("beam_scores", [[]])[0] if status == 200 else []
        if (status != 200 or len(body["beams"][0]) != 4 or body["tokens"][0] != body["beams"][0][0]
                or any(a < b for a, b in zip(scores, scores[1:]))):
            problems.append(f"{n}: the beam request {status}")
        if o["refusals"]["ragged_beams"] != [400, "num_beams > 1 requires uniform-length prompts"]:
            problems.append(f"{n}: ragged beams {o['refusals']['ragged_beams']}")
        if o["refusals"]["stream_beams"] != [400, "/generate_stream does not support beams"]:
            problems.append(f"{n}: streamed beams {o['refusals']['stream_beams']}")
        if o["sigterm_exit_code"] != 0:
            problems.append(f"{n}: exit {o['sigterm_exit_code']} on SIGTERM")
        if not (o["health"]["kv_int8"] and o["health"]["weights_int8"]):
            problems.append(f"{n}: /healthz {o['health']}")
    if not out["engine"]["spec_rounds"]:
        problems.append("the engine server ran no verify round")
    if out["inline"]["speculative_decodes"] != len(reqs):
        problems.append("the inline server's speculative path count is off")
    for name, r in refused.items():
        if r["exit_code"] != 2 or not r["text_found"]:
            problems.append(f"{name}: {r}")
    if problems:
        raise AssertionError(f"decode_modes_serve: {problems}")
    del twin
    free_device_memory()
    return report


def run_decode_modes_phases(kernels, smi) -> dict:
    """GPT-small's decode modes, in order: int8_decode, int8_serve,
    beam_search, spec_generate, spec_serve, decode_modes_serve, over one
    GPT-small with random weights from MODES_SEED (bf16 compute) and its
    int8 twin; K1-K5 must not launch (no TPU kernel lies on these paths)."""
    from tf_operator_tpu_torch.models import gpt as gpt_lib
    from tf_operator_tpu_torch.ops import quant
    from tf_operator_tpu_torch.serve import server as server_lib

    kernels.reset_launches()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    model = gpt_lib.GPT(gpt_lib.GPT_SMALL, generator=torch.Generator().manual_seed(MODES_SEED),
                        device="cuda")
    twin = quant.quantize_model(model)
    out = {}
    try:
        out["int8_decode"] = run_int8_decode(gpt_lib, quant, model, twin, smi)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        out["int8_serve"] = run_int8_serve(gpt_lib, twin, smi)
        out["beam_search"] = run_beam_search(gpt_lib, model, smi)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        out["spec_generate"] = run_spec_generate(gpt_lib, model, smi)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        out["spec_serve"] = run_spec_serve(gpt_lib, model, smi)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        del model, twin
        free_device_memory()
        out["decode_modes_serve"] = run_decode_modes_serve(gpt_lib, quant, server_lib, smi)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if any(kernels.LAUNCHES.values()):
        raise AssertionError(f"the decode-mode phases launched kernels of the port: "
                             f"{kernels.LAUNCHES}")
    return out


# -- the MoE family and ViT-B/16 -------------------------------------------------

MOE_SHAPE = (8, 1024)  # MoE-base at the reference bench's batch x seq (moe_bench.py:81-86)
MOE_TIMED_STEPS = 5
MOE_PARITY_SHAPE = (2, 256)
MOE_DECODE = (8, 128, 128)  # rows, prompt, new tokens (moe_bench.py:184 decodes 512)
# the f32 decode checks' new tokens after the 128-token prompt
MOE_CHECK_NEW = 32
# a capacity factor at which training drops nothing on these shapes (the
# reference's tests/test_moe_pipeline.py:389-394): decode equals training
MOE_NO_DROP_CF = 2.0
MOE_SERVE_REQUESTS = 4
MOE_SERVE_PROMPT = 32
MOE_SERVE_NEW = 32
MOE_SERVE_TIMEOUT_S = 300
# f32 on the card (TF32 off) against f32 on the CPU, MoE-base at 2 x 256:
# two devices sum the same f32 products in other orders through 12 layers
# and a 32000-wide head
MOE_F32_LOGIT_ATOL = 1e-3
MOE_F32_LOSS_RTOL = 1e-5
MOE_F32_AUX_ATOL = 1e-6
MOE_F32_GRAD_RTOL = 1e-3  # worst relative L2 over the parameters
# a routing decision whose top-2 probability gap is below this is a near-tie
MOE_TIE = 1e-5
# bf16 against f32 on the card: the loss (about 10.9 at init) within
MOE_BF16_LOSS_ATOL = 2e-2
VIT_BATCH = 128  # the reference bench's per-chip batch (model_benches.py:405-406)
VIT_TIMED_STEPS = 5
VIT_PARITY_BATCH = 4
VIT_SEQ = 196  # the bench's seq for its MFU: the patch count
VIT_F32_LOGIT_ATOL = 1e-3
VIT_F32_GRAD_RTOL = 1e-3
VIT_BF16_LOSS_ATOL = 2e-2
REMAT_RTOL = 1e-6
# device time by region of the model (profile_regions): the port's
# functions that each region runs, wrapped in a record_function for the
# profile's window; backward kernels follow their forward op's region
GEMM_KEYS = ("gemm", "xmma", "cutlass", "nvjet", "cublas", "splitk", "wgmma", "sm90_")


def moe_targets(moe_lib, bert_lib, attention_lib, losses_lib) -> tuple:
    """(label, owner, attribute) of each MoE region's function."""
    return (
        ("router", moe_lib.TopKRouter, "forward"),
        ("dispatch/combine", moe_lib, "dispatch_tokens"),
        ("dispatch/combine", moe_lib, "combine_tokens"),
        ("expert FFN", moe_lib, "expert_ffn"),
        ("attention", attention_lib, "dot_product_attention"),
        ("projections", attention_lib.DenseGeneral, "forward"),
        ("dense MLP", bert_lib, "transformer_mlp"),
        ("LM head", moe_lib.MoELM, "head"),
        ("layer norm", bert_lib.LayerNorm, "forward"),
        ("loss", losses_lib, "weighted_mean_xent"),
    )


def vit_targets(bert_lib, attention_lib) -> tuple:
    return (
        ("attention", attention_lib, "dot_product_attention"),
        ("projections", attention_lib.DenseGeneral, "forward"),
        ("dense MLP", bert_lib, "transformer_mlp"),
        ("layer norm", bert_lib.LayerNorm, "forward"),
    )


REGION_PREFIX = "region::"


class labelled:
    """Within the block, each target function runs inside
    record_function(REGION_PREFIX + label); restored after."""

    def __init__(self, targets) -> None:
        self.targets = targets
        self.saved = []

    def __enter__(self):
        from torch.profiler import record_function

        for label, owner, attr in self.targets:
            fn = getattr(owner, attr)

            def wrapped(*args, _fn=fn, _label=label, **kwargs):
                with record_function(REGION_PREFIX + _label):
                    return _fn(*args, **kwargs)

            self.saved.append((owner, attr, fn))
            setattr(owner, attr, wrapped)
        return self

    def __exit__(self, *exc) -> None:
        for owner, attr, fn in reversed(self.saved):
            setattr(owner, attr, fn)
        self.saved = []


def _region(event):
    """The innermost labelled region around a profiler event, or None."""
    while event is not None:
        if event.name.startswith(REGION_PREFIX):
            return event.name[len(REGION_PREFIX):]
        if event.name.startswith("Optimizer.step"):
            return "optimizer"
        event = event.cpu_parent
    return None


def _backward_node(event):
    while event is not None:
        if event.name.startswith("autograd::engine::evaluate_function"):
            return event
        event = event.cpu_parent
    return None


def region_times(prof, steps: int) -> dict:
    """Device ms per step by region: each kernel goes to the CPU op that
    launched it; a forward op's region is the innermost labelled range
    around it, a backward op's the region of the forward op whose autograd
    node it evaluates (the last forward op recorded with that sequence
    number created the node). Copy kernels (casts, relayouts) go to
    "copies and casts" whatever their region; in the GEMM-bearing regions
    GEMM kernels and the rest are split."""
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    forward_region = {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.sequence_nr >= 0 and _backward_node(e) is None:
            forward_region[e.sequence_nr] = _region(e)
    out: dict = {}
    for e in events:
        if not e.kernels:
            continue
        region = _region(e)
        if region is None:
            node = _backward_node(e)
            if node is not None:
                region = forward_region.get(node.sequence_nr)
        region = region or "other"
        for k in e.kernels:
            name = k.name.lower()
            if "copy" in name:
                kind = "copies and casts"
            elif region in ("expert FFN", "dense MLP", "projections", "LM head", "attention"):
                gemm = any(key in name for key in GEMM_KEYS)
                kind = f"{region} {'GEMMs' if gemm else 'elementwise'}"
            else:
                kind = region
            out[kind] = out.get(kind, 0.0) + k.duration / 1e3 / steps
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def profile_regions(phase: str, trainer, batch, targets, smi, extra=None) -> dict:
    """Two training steps (after one warm-up) under torch.profiler with
    the targets labelled: device ms per step by region (region_times), by
    kernel kind, the device's busy share of the window's wall time, peak
    memory, and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    state = trainer.init()
    batch = trainer.place_batch(batch)
    state, _ = trainer.step(state, batch)
    torch.cuda.synchronize()
    steps = 2
    with labelled(targets):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.monotonic()
            for _ in range(steps):
                state, _ = trainer.step(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - start) * 1e3
    kernels = device_kernels(prof)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    regions = region_times(prof, steps)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    report = {
        "phase": phase, "card": smi, **(extra or {}), "steps": steps,
        "wall_ms_per_step": wall_ms / steps, "device_ms_per_step": device_ms,
        "device_busy_share": device_ms * steps / wall_ms,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "ms_per_step_by_region": regions,
        "regions_sum_ms": sum(regions.values()),
        "ms_per_step_by_kernel_kind": by_category(kernels, steps, SERVE_CATEGORIES),
        "top": [{"kernel": e.key[:90], "ms_per_step": e.self_device_time_total / 1e3 / steps,
                 "calls_per_step": e.count / steps} for e in top],
    }
    emit(report)
    if abs(report["regions_sum_ms"] - device_ms) > 0.02 * device_ms:
        raise AssertionError(f"{phase}: regions sum to {report['regions_sum_ms']} of {device_ms} ms")
    return report


def moe_active_params(model) -> float:
    """The reference bench's count (moe_bench.py:39-52): expert kernels at
    experts_per_token / num_experts of their size, every other parameter
    whole."""
    cfg = model.cfg
    share = cfg.experts_per_token / cfg.num_experts
    return sum(p.numel() * (share if name.endswith(("expert_in", "expert_out")) else 1.0)
               for name, p in model.named_parameters())


def moe_spent_flop_per_token(cfg, batch: int, seq: int, moe_lib) -> float:
    """What the dense one-hot formulation computes per token, forward and
    backward (3x the forward's products): the attention projections,
    dense MLPs and head on every token; in each MoE layer the router, the
    two dispatch/combine products over every (token, expert, slot) and the
    expert FFN over every slot of every expert's buffer, empty or not; the
    attention products over all s x s pairs (the plain route masks, it
    does not skip)."""
    h, f, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    cap = moe_lib.expert_capacity(cfg, seq)
    n_moe = sum(moe_lib.layer_is_moe(cfg, i) for i in range(cfg.num_layers))
    n_dense = cfg.num_layers - n_moe
    per_token = cfg.num_layers * (2 * 4 * h * h + 2 * 2 * seq * h) + 2 * h * cfg.vocab_size
    per_token += n_dense * 2 * 2 * h * f
    per_token += n_moe * (2 * h * e + 2 * 2 * e * cap * h + 2 * 2 * e * cap * h * f / seq)
    return 3.0 * per_token


def router_readings(moe_lib, model, batch) -> dict:
    """One forward (no gradient) with each router's dispatch captured:
    router_balance = router_aux / (weight x MoE layers), 1.0 when routing
    is uniform, and routed_token_fraction = the (token, slot) claims that
    landed inside capacity over all claims (moe_bench.py:109-143); per
    MoE layer too."""
    cfg = model.cfg
    routed = []

    def keep(module, args, out):
        dispatch = out[0]
        routed.append(float(dispatch.sum()) / (dispatch.shape[0] * dispatch.shape[1]
                                               * cfg.experts_per_token))

    hooks = [m.register_forward_hook(keep) for m in model.modules()
             if isinstance(m, moe_lib.TopKRouter)]
    try:
        with torch.no_grad():
            _, losses = model(batch["input_ids"], batch["attention_mask"])
    finally:
        for hook in hooks:
            hook.remove()
    n_moe = len(routed)
    aux = float(moe_lib.sum_sown(losses, "router_aux"))
    return {"router_balance": aux / (cfg.router_aux_weight * max(n_moe, 1)),
            "routed_token_fraction": sum(routed) / n_moe, "routed_by_layer": routed}


def run_moe_train(kernels, moe_lib, moe_cli, smi) -> dict:
    """moe_train: MoE-base through train/moe.py's train() at MOE_SHAPE,
    AdamW 3e-4 wd 0.01, bf16: tokens/s over MOE_TIMED_STEPS timed steps,
    the active-parameter MFU and the FLOPs the dense formulation spends,
    peak memory, router balance and routed fraction (of the trained
    model); no launch of K1-K5; the LM loss (the training loss less its
    router terms, which grow as the router concentrates) must fall."""
    b, s = MOE_SHAPE
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    args = moe_cli.parse_args([
        "--preset", "base", "--steps", str(MOE_TIMED_STEPS + 1), "--batch-size", str(b),
        "--seq-len", str(s), "--learning-rate", "3e-4", "--log-every", "1",
    ])
    summary, state = moe_cli.train(args)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    model = state.model
    cfg = model.cfg
    active = moe_active_params(model)
    stated = 6 * active + 6 * cfg.num_layers * s * cfg.hidden_size
    spent = moe_spent_flop_per_token(cfg, b, s, moe_lib)
    batch = {k: v.cuda() for k, v in moe_lib.synthetic_batch(
        torch.Generator().manual_seed(3), b, s, cfg).items()}
    router = router_readings(moe_lib, model, batch)
    report = {
        "phase": "moe_train", "model": "MoE-base", "batch": b, "seq": s, "card": smi,
        **summary, "params": sum(p.numel() for p in model.parameters()),
        "active_params": active,
        "expert_param_dtype": str(model.layer_1.moe_mlp.expert_in.dtype),
        "capacity": moe_lib.expert_capacity(cfg, s),
        "stated_flop_per_token": stated, "spent_flop_per_token": spent,
        "mfu_active": summary["tokens_per_sec"] * stated / PEAK_BF16_FLOPS,
        "spent_flops_share_of_peak": summary["tokens_per_sec"] * spent / PEAK_BF16_FLOPS,
        "peak_memory_gb": peak / 1e9, **router, "launches": launches,
        "first_lm_loss": summary["first_loss"] - summary["first_router_aux"]
        - summary["first_router_z"],
        "lm_loss": summary["loss"] - summary["router_aux"] - summary["router_z"],
    }
    emit(report)
    if any(launches.values()):
        raise AssertionError(f"moe_train launched kernels of the port: {launches}")
    for key in ("loss", "eval_loss", "tokens_per_sec", "router_aux", "eval_router_aux"):
        if not math.isfinite(summary[key]) or summary[key] <= 0:
            raise AssertionError(f"moe_train {key} = {summary[key]}")
    # the LM loss (the loss less the router terms it trains with) must fall
    if not report["lm_loss"] < report["first_lm_loss"]:
        raise AssertionError(
            f"moe_train LM loss did not fall: {report['first_lm_loss']} -> {report['lm_loss']}")
    del state, model
    free_device_memory()
    return report


def run_moe_profile(moe_lib, bert_lib, attention_lib, losses_lib, trainer_lib, smi) -> dict:
    """moe_profile: device ms per MoE-base step at MOE_SHAPE by region."""
    cfg = moe_lib.MOE_BASE
    model = seeded(moe_lib.MoELM, cfg, 5)
    trainer = trainer_lib.Trainer(model, trainer_lib.moe_task(), learning_rate=3e-4,
                                  weight_decay=0.01, device="cuda")
    batch = moe_lib.synthetic_batch(torch.Generator().manual_seed(6), *MOE_SHAPE, cfg)
    report = profile_regions(
        "moe_profile", trainer, batch, moe_targets(moe_lib, bert_lib, attention_lib, losses_lib),
        smi, {"model": "MoE-base", "shape": list(MOE_SHAPE)})
    del trainer, model
    free_device_memory()
    return report


def routing_decisions(moe_lib, model, batch) -> list:
    """Per MoE layer, the router's inputs' top-k experts [g, t, k] and the
    probability gaps that decide them [g, t, k] (choice i against the next
    best), from one forward with a pre-hook on each router."""
    k = model.cfg.experts_per_token
    found = []

    def keep(module, args):
        probs = torch.softmax(F.linear(args[0].float(), module.router.weight), dim=-1)
        top = torch.topk(probs, k + 1, dim=-1)
        found.append((top.indices[..., :k].cpu(),
                      (top.values[..., :k] - top.values[..., 1:]).cpu()))

    hooks = [m.register_forward_pre_hook(keep) for m in model.modules()
             if isinstance(m, moe_lib.TopKRouter)]
    try:
        with torch.no_grad():
            model(batch["input_ids"], batch["attention_mask"])
    finally:
        for hook in hooks:
            hook.remove()
    return found


def moe_step_readings(moe_lib, trainer_lib, cfg, weights, batch, device, planted=None) -> dict:
    """One moe_task forward and backward on `device` from `weights`: the
    logits, loss, router_aux, router_z and every gradient, on the CPU.
    planted: a router class to swap in (a control)."""
    model = built_from(lambda: moe_lib.MoELM(cfg), weights, device)
    if planted is not None:
        for m in model.modules():
            if isinstance(m, moe_lib.TopKRouter):
                m.__class__ = planted
    placed = {k: v.to(device) for k, v in batch.items()}
    loss, aux = trainer_lib.moe_task().loss_fn(model, placed, train=True)
    loss.backward()
    with torch.no_grad():
        logits, _ = model(placed["input_ids"], placed["attention_mask"])
    out = {"loss": loss.item(), "aux": aux["router_aux"].item(), "z": aux["router_z"].item(),
           "logits": logits.float().cpu(),
           "grads": {n: p.grad.float().cpu() for n, p in model.named_parameters()},
           "decisions": routing_decisions(moe_lib, model, placed)}
    del model
    return out


def without_key_bias(got: dict, want: dict) -> tuple:
    """Both gradient maps without the attention key biases: zero in exact
    arithmetic (plain_parity), so each side holds only rounding noise."""
    keep = [n for n in want if not n.endswith("attention.key.bias")]
    return {n: got[n] for n in keep}, {n: want[n] for n in keep}


def decisions_differ(a: list, b: list) -> dict:
    """Per layer: the share of (token, choice) decisions that differ, and
    the largest top-2 gap (in a) at a differing decision."""
    shares, gaps = [], []
    for (ia, ga), (ib, _) in zip(a, b):
        diff = ia != ib
        shares.append(float(diff.float().mean()))
        gaps.append(float(ga[diff].max()) if bool(diff.any()) else None)
    return {"share_by_layer": shares, "largest_gap_at_a_difference": gaps}


def half_batch_aux_router(moe_lib):
    """A planted fault: the router's losses from the first half of the
    groups only (its dispatch and combine stay right)."""

    class HalfBatchAux(moe_lib.TopKRouter):
        def forward(self, x):
            dispatch, combine, _ = super().forward(x)
            _, _, losses = super().forward(x[: max(x.shape[0] // 2, 1)])
            return dispatch, combine, losses

    return HalfBatchAux


def per_token_claims_router(moe_lib):
    """A planted fault in the capacity order: claims token by token, all k
    choices of earlier tokens first (the reference comment's order, not
    its loop's)."""

    class PerTokenClaims(moe_lib.TopKRouter):
        def forward(self, x):
            cfg = self.cfg
            g, t = x.shape[:2]
            cap = moe_lib.expert_capacity(cfg, t)
            probs = torch.softmax(F.linear(x.float(), self.router.weight), dim=-1)
            idx = torch.topk(probs, cfg.experts_per_token, dim=-1).indices  # [g, t, k]
            onehot = moe_lib._one_hot(idx, cfg.num_experts, probs.dtype)  # [g, t, k, e]
            flat = onehot.reshape(g, t * cfg.experts_per_token, cfg.num_experts)
            prior = (torch.cumsum(flat, dim=1) - flat).reshape(onehot.shape)
            pos = (prior * onehot).sum(-1)  # [g, t, k]
            slot = moe_lib._one_hot(pos.long(), cap, probs.dtype)
            dispatch = (onehot[..., None] * slot[..., None, :]).sum(2)
            return dispatch, dispatch, {}

    return PerTokenClaims


def run_moe_parity(moe_lib, trainer_lib, smi) -> dict:
    """moe_parity: one moe_task step of MoE-base (full width, 12 layers)
    at MOE_PARITY_SHAPE from one set of weights: f32 on the card (TF32
    off) against f32 on the CPU (logits, loss, router_aux, router_z,
    gradients; routing decisions equal but at near-ties, whose gaps are
    reported); bf16 against f32 on the card (the loss, and per MoE layer
    the share of routing decisions that differ); a planted router whose
    losses come from half the batch must miss the CPU's aux and router
    gradients; at capacity factor 0.5 the router on the card gives the
    CPU's dispatch exactly, and a planted per-token claim order gives
    another."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s = MOE_PARITY_SHAPE
    cfg32 = dataclasses.replace(moe_lib.MOE_BASE, dtype=torch.float32)
    weights = moe_lib.MoELM(cfg32, generator=torch.Generator().manual_seed(7)).state_dict()
    batch = moe_lib.synthetic_batch(torch.Generator().manual_seed(8), b, s, cfg32)
    batch["attention_mask"][1, s - 37:] = 0  # a padded row
    start = time.monotonic()
    cpu = moe_step_readings(moe_lib, trainer_lib, cfg32, weights, batch, "cpu")
    cpu_s = time.monotonic() - start
    card = moe_step_readings(moe_lib, trainer_lib, cfg32, weights, batch, "cuda")
    bf16 = moe_step_readings(moe_lib, trainer_lib, moe_lib.MOE_BASE, weights, batch, "cuda")
    planted = moe_step_readings(moe_lib, trainer_lib, cfg32, weights, batch, "cuda",
                                planted=half_batch_aux_router(moe_lib))
    grads_worst = rel_l2_worst(*without_key_bias(card["grads"], cpu["grads"]))
    router_names = [n for n in cpu["grads"] if "router_gate" in n]
    planted_router = max(rel(planted["grads"][n], cpu["grads"][n]) for n in router_names)
    routing = decisions_differ(card["decisions"], cpu["decisions"])
    bf16_routing = decisions_differ(bf16["decisions"], card["decisions"])

    # the capacity order on the card, at a capacity that drops
    small = dataclasses.replace(cfg32, capacity_factor=0.5)
    x = torch.randn((b, s, cfg32.hidden_size), generator=torch.Generator().manual_seed(9))
    router = moe_lib.TopKRouter(small)
    router.router.weight.data.copy_(weights["layer_1.moe_mlp.router_gate.router.weight"])
    with torch.no_grad():
        d_cpu = router(x)[0]
        d_card = router.cuda()(x.cuda())[0].cpu()
        router.__class__ = per_token_claims_router(moe_lib)
        d_planted = router(x.cuda())[0].cpu()
    report = {
        "phase": "moe_parity", "model": "MoE-base (12 layers, full width)", "card": smi,
        "shape": [b, s], "cpu_step_s": cpu_s,
        "f32_card_vs_cpu": {
            "logits_max_abs": max_err(card["logits"], cpu["logits"]),
            "loss": [card["loss"], cpu["loss"]], "aux": [card["aux"], cpu["aux"]],
            "z": [card["z"], cpu["z"]], "grads_worst_rel_l2": grads_worst,
            "routing": routing,
        },
        "tolerances": {"logits_atol": MOE_F32_LOGIT_ATOL, "loss_rtol": MOE_F32_LOSS_RTOL,
                       "aux_atol": MOE_F32_AUX_ATOL, "grad_rel_l2": MOE_F32_GRAD_RTOL,
                       "tie": MOE_TIE, "bf16_loss_atol": MOE_BF16_LOSS_ATOL},
        "bf16_vs_f32_card": {"loss": [bf16["loss"], card["loss"]],
                             "aux": [bf16["aux"], card["aux"]], "routing": bf16_routing},
        "planted_half_batch_aux": {"aux": planted["aux"],
                                   "router_grad_worst_rel_l2": planted_router},
        "capacity_0.5": {"routed_share": float(d_cpu.sum()) / (b * s * cfg32.experts_per_token),
                         "card_equals_cpu": bool(torch.equal(d_card, d_cpu)),
                         "per_token_order_slots_moved": int((d_planted != d_card).sum())},
    }
    emit(report)
    ties_only = all(g is None or g < MOE_TIE for g in routing["largest_gap_at_a_difference"])
    if not ties_only:
        raise AssertionError(f"moe_parity: routing differs beyond near-ties: {routing}")
    if all(g is None for g in routing["largest_gap_at_a_difference"]):
        if report["f32_card_vs_cpu"]["logits_max_abs"] > MOE_F32_LOGIT_ATOL:
            raise AssertionError("moe_parity: f32 logits differ between the card and the CPU")
        if grads_worst[0] > MOE_F32_GRAD_RTOL:
            raise AssertionError(f"moe_parity: f32 gradients differ: {grads_worst}")
    if abs(card["loss"] - cpu["loss"]) > MOE_F32_LOSS_RTOL * abs(cpu["loss"]):
        raise AssertionError("moe_parity: f32 loss differs between the card and the CPU")
    for key in ("aux", "z"):
        if abs(card[key] - cpu[key]) > MOE_F32_AUX_ATOL:
            raise AssertionError(f"moe_parity: f32 {key} differs between the card and the CPU")
    if abs(bf16["loss"] - card["loss"]) > MOE_BF16_LOSS_ATOL:
        raise AssertionError("moe_parity: the bf16 loss is off the f32 loss")
    if abs(planted["aux"] - cpu["aux"]) <= MOE_F32_AUX_ATOL or planted_router <= MOE_F32_GRAD_RTOL:
        raise AssertionError("moe_parity: the planted half-batch aux passed the bounds")
    if not report["capacity_0.5"]["card_equals_cpu"]:
        raise AssertionError("moe_parity: dispatch at capacity 0.5 differs card vs CPU")
    if not report["capacity_0.5"]["per_token_order_slots_moved"]:
        raise AssertionError("moe_parity: the planted claim order gave the same dispatch")
    free_device_memory()
    return report


def run_moe_run_steps(kernels, moe_lib, trainer_lib, smi) -> dict:
    """moe_run_steps: MoE-base at MOE_SHAPE, run_steps(n=RUN_STEPS) as a CUDA
    graph against RUN_STEPS eager steps from one seed (graph_vs_eager: losses 1e-3
    relative, parameters 1e-4 relative L2, bit-equality reported, ms per
    step and busy share, eager and graph); no kernel of the port inside."""
    cfg = moe_lib.MOE_BASE

    def make():
        model = seeded(moe_lib.MoELM, cfg, 5)
        return trainer_lib.Trainer(
            model, trainer_lib.moe_task(), weight_decay=0.01, device="cuda",
            learning_rate=trainer_lib.warmup_cosine_lr(3e-4, 2 * RUN_STEPS, 2))

    batch = moe_lib.synthetic_batch(torch.Generator().manual_seed(6), *MOE_SHAPE, cfg)
    report = graph_vs_eager("MoE-base", kernels, make, batch, {},
                            MOE_SHAPE[0] * MOE_SHAPE[1], "tokens", smi, phase="moe_run_steps")
    free_device_memory()
    return report


def stepwise_chain(moe_lib, model, prompt, new: int) -> torch.Tensor:
    """Greedy chain with every prompt position through MoEDecodeStep (no
    prefill): [b, p + new]."""
    b, p = prompt.shape
    cache = moe_lib.KVCache.zeros(model.cfg, b, p + new, prompt.device)
    step = moe_lib.MoEDecodeStep(model)
    out = [prompt]
    for i in range(p + new - 1):
        logits = step(prompt[:, i] if i < p else tok, i, cache)
        if i >= p - 1:
            tok = logits.argmax(-1)
            out.append(tok[:, None])
    return torch.cat(out, dim=1)


def run_moe_generate(moe_lib, smi) -> dict:
    """moe_generate: MoE-base (bf16, random weights from a seed), 8 rows,
    a 128-token prompt, 128 new tokens: tokens/s counted as the reference
    counts them, b (p - 1 + new) / s, ms per token, and a profile of decode
    steps (kernels per token, busy share). Then in f32 at capacity factor
    2.0 (TF32 off), along a greedy chain of MOE_CHECK_NEW new tokens:
    teacher-forced MoEDecodeStep logits against the training forward's
    (atol/rtol DECODE_ATOL), no token dropped by that forward (at
    num_experts / experts_per_token where 2.0 drops), and the prefill
    chain equal to the all-stepwise chain."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, p, new = MOE_DECODE
    cfg = moe_lib.MOE_BASE
    model = seeded(moe_lib.MoELM, cfg, 5).to("cuda")  # moe_profile's draw
    prompt = torch.randint(0, cfg.vocab_size, (rows, p),
                           generator=torch.Generator().manual_seed(12)).cuda()
    moe_lib.moe_generate(model, (prompt + 1) % cfg.vocab_size, 8)  # warm-up
    torch.cuda.synchronize()
    start = time.monotonic()
    out = moe_lib.moe_generate(model, prompt, new)
    torch.cuda.synchronize()
    seconds = time.monotonic() - start
    profile = profiled(lambda: moe_lib.moe_generate(model, prompt, 16), 16)
    report = {
        "phase": "moe_generate", "model": "MoE-base", "card": smi, "rows": rows,
        "prompt": p, "new_tokens": new, "seconds": seconds,
        "tokens_per_sec": rows * (p - 1 + new) / seconds,
        "new_tokens_per_sec": rows * new / seconds, "ms_per_token": seconds * 1e3 / new,
        "profile_16_tokens": profile, "shape": list(out.shape),
    }
    weights = model.state_dict()
    del model
    free_device_memory()
    # the forward drops nothing at MOE_NO_DROP_CF on the reference's test
    # data; a greedy chain of random weights repeats tokens and can
    # overflow an expert there, and then the check moves to capacity
    # factor num_experts / experts_per_token, where each expert's buffer
    # holds the whole sequence (no drop is possible)
    routed_at = {}
    for factor in (MOE_NO_DROP_CF, cfg.num_experts / cfg.experts_per_token):
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32, capacity_factor=factor)
        model32 = built_from(lambda: moe_lib.MoELM(cfg32), weights, "cuda")
        with torch.no_grad():
            chain = moe_lib.moe_generate(model32, prompt, MOE_CHECK_NEW)
            batch = {"input_ids": chain, "attention_mask": torch.ones_like(chain)}
            routed = router_readings(moe_lib, model32, batch)["routed_token_fraction"]
        routed_at[factor] = routed
        if routed == 1.0:
            break
    with torch.no_grad():
        stepwise = stepwise_chain(moe_lib, model32, prompt, MOE_CHECK_NEW)
        train, _ = model32(chain)
        n = chain.shape[1]
        cache = moe_lib.KVCache.zeros(model32.cfg, rows, n, chain.device)
        step = moe_lib.MoEDecodeStep(model32)
        stepped = torch.stack([step(chain[:, i], i, cache) for i in range(n)], dim=1)
    err = (stepped - train).abs()
    allowed = DECODE_ATOL + DECODE_RTOL * train.abs()
    top2 = torch.topk(stepped[:, p - 1:-1], 2, dim=-1).values
    report.update({
        "f32_capacity_factor": factor, "f32_routed_token_fraction_by_factor": routed_at,
        "f32_decode_vs_train_max_abs": err.max().item(),
        "f32_decode_vs_train_worst_over_allowed": (err / allowed).max().item(),
        "atol": DECODE_ATOL, "rtol": DECODE_RTOL,
        "f32_min_top2_margin": (top2[..., 0] - top2[..., 1]).min().item(),
        "f32_prefill_chain_equals_stepwise": bool(torch.equal(chain, stepwise)),
        "f32_first_difference": first_difference(chain, stepwise),
    })
    emit(report)
    if out.shape != (rows, p + new) or not torch.equal(out[:, :p], prompt):
        raise AssertionError("moe_generate: the chain's shape or prompt is wrong")
    if routed != 1.0:
        raise AssertionError(f"moe_generate: the f32 forward dropped tokens ({routed})")
    if not bool((err <= allowed).all()):
        raise AssertionError("moe_generate: teacher-forced decode differs from the forward")
    if not report["f32_prefill_chain_equals_stepwise"]:
        raise AssertionError("moe_generate: the prefill and stepwise chains differ")
    del model32
    free_device_memory()
    return report


def post_json(port: int, path: str, payload: dict) -> list:
    """[status, the reply's error text or body] of one POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return [resp.status, json.loads(resp.read())]
    except urllib.error.HTTPError as err:
        return [err.code, json.loads(err.read()).get("error")]


def wait_for_health(port: int, proc, timeout: float) -> None:
    import urllib.error
    import urllib.request

    deadline = time.monotonic() + timeout
    while True:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as resp:
                if resp.status == 200:
                    return
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        if proc.poll() is not None or time.monotonic() > deadline:
            raise AssertionError(f"the server did not come up (exit {proc.poll()})")
        time.sleep(0.5)


def run_moe_serve(moe_lib, server_lib, smi) -> dict:
    """moe_serve: train/moe.py --preset base --steps 2 --checkpoint-dir D
    (its main(), in this process), then `python -m tf_operator_tpu_torch.serve
    --preset moe-base --checkpoint-dir D` as a subprocess: MOE_SERVE_REQUESTS uniform-length
    requests from the port's DecodeClient, half greedy (each chain equal
    to in-process moe_generate on the restored weights) and half sampled
    (reported against in-process moe_generate from the same seed); a
    ragged, a top_k and a num_beams request each a 400; SIGTERM -> exit 0.
    Every process started here is stopped."""
    import os
    import signal
    import tempfile

    from tf_operator_tpu_torch.serve.client import DecodeClient
    from tf_operator_tpu_torch.train import moe as moe_cli

    work = tempfile.mkdtemp(prefix="moe-serve-")
    ckpt = os.path.join(work, "ckpt")
    start = time.monotonic()
    code = moe_cli.main(["--preset", "base", "--steps", "2", "--checkpoint-dir", ckpt,
                         "--log-every", "1"])
    train_s = time.monotonic() - start
    if code != 0:
        raise AssertionError(f"train/moe.py's main returned {code}")
    free_device_memory()
    port = free_port()
    log = open(os.path.join(work, "server.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tf_operator_tpu_torch.serve", "--preset", "moe-base",
         "--checkpoint-dir", ckpt, "--host", "127.0.0.1", "--port", str(port)],
        stdout=log, stderr=subprocess.STDOUT)
    try:
        start = time.monotonic()
        wait_for_health(port, proc, MOE_SERVE_TIMEOUT_S)
        boot_s = time.monotonic() - start
        client = DecodeClient(f"http://127.0.0.1:{port}")
        gen = torch.Generator().manual_seed(13)
        reqs = []
        for i in range(MOE_SERVE_REQUESTS):
            prompt = torch.randint(0, moe_lib.MOE_BASE.vocab_size, (1, MOE_SERVE_PROMPT),
                                   generator=gen).tolist()
            reqs.append({"prompt": prompt, "temperature": 0.0 if i % 2 == 0 else 0.8,
                         "seed": 100 + i})
        start = time.monotonic()
        for req in reqs:
            req["chain"] = client.generate(req["prompt"], max_new_tokens=MOE_SERVE_NEW,
                                           temperature=req["temperature"], seed=req["seed"])
        serve_s = time.monotonic() - start
        refusals = {
            name: post_json(port, "/generate", {"max_new_tokens": 4, **payload})
            for name, payload in (
                ("ragged", {"input_ids": [[1, 2, 3], [4, 5]]}),
                ("top_k", {"input_ids": [[1, 2, 3]], "temperature": 0.5, "top_k": 4}),
                ("num_beams", {"input_ids": [[1, 2, 3]], "num_beams": 2}),
            )
        }
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    model = server_lib.load_model("moe-base", ckpt, torch.device("cuda"))
    greedy_equal, sampled_equal = [], []
    for req in reqs:
        gen = torch.Generator(device="cuda").manual_seed(req["seed"])
        want = moe_lib.moe_generate(model, torch.tensor(req["prompt"]).cuda(), MOE_SERVE_NEW,
                                    temperature=req["temperature"], generator=gen).tolist()
        (greedy_equal if req["temperature"] == 0 else sampled_equal).append(req["chain"] == want)
    report = {
        "phase": "moe_serve", "model": "MoE-base", "card": smi, "train_s": train_s,
        "server_boot_s": boot_s, "requests": len(reqs), "prompt": MOE_SERVE_PROMPT,
        "new_tokens": MOE_SERVE_NEW, "serve_s": serve_s,
        "new_tokens_per_sec": len(reqs) * MOE_SERVE_NEW / serve_s,
        "greedy_equal_inline": greedy_equal, "sampled_equal_inline": sampled_equal,
        "refusals": refusals, "sigterm_exit_code": code,
        "checkpoint_bytes": sum(os.path.getsize(os.path.join(r, f))
                                for r, _, fs in os.walk(ckpt) for f in fs),
    }
    emit(report)
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    if not all(greedy_equal):
        raise AssertionError("moe_serve: a greedy served chain differs from moe_generate")
    if any(status != 400 for status, _ in refusals.values()):
        raise AssertionError(f"moe_serve: refusals {refusals}")
    if code != 0:
        raise AssertionError(f"moe_serve: the server exited {code} on SIGTERM")
    del model
    free_device_memory()
    return report


def vit_flop_per_image(model) -> float:
    """The reference bench's transformer_step_flops per image
    (model_benches.py:48-62): (6 P + 12 L s h) per token, s the patch
    count, not causal."""
    cfg = model.cfg
    params = sum(p.numel() for p in model.parameters())
    return (6.0 * params + 12.0 * cfg.num_layers * VIT_SEQ * cfg.hidden_size) * VIT_SEQ


def run_vit(vit_lib, vit_cli, bert_lib, attention_lib, trainer_lib, smi) -> dict:
    """vit_train: ViT-B/16 through train/vit.py's run() at 224^2, batch
    VIT_BATCH, AdamW 1e-3 wd 0.05, bf16: images/s over VIT_TIMED_STEPS
    timed steps, MFU by the bench's formula, peak memory; the loss must
    fall. vit_profile: device ms per step by region."""
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    summary = vit_cli.run(vit_cli.parse_args([
        "--preset", "b16", "--steps", str(VIT_TIMED_STEPS + 1),
        "--per-chip-batch", str(VIT_BATCH), "--learning-rate", "1e-3", "--log-every", "1",
    ]))
    peak = torch.cuda.max_memory_allocated()
    model = vit_lib.ViT(vit_lib.VIT_B16)
    flop = vit_flop_per_image(model)
    report = {
        "phase": "vit_train", "model": "ViT-B/16", "batch": VIT_BATCH, "card": smi, **summary,
        "params": sum(p.numel() for p in model.parameters()), "flop_per_image": flop,
        "mfu": summary["images_per_sec"] * flop / PEAK_BF16_FLOPS,
        "peak_memory_gb": peak / 1e9,
    }
    emit(report)
    if not math.isfinite(summary["loss"]) or not summary["loss"] < summary["first_loss"]:
        raise AssertionError(
            f"vit_train loss did not fall: {summary['first_loss']} -> {summary['loss']}")
    free_device_memory()
    trainer = trainer_lib.Trainer(model, trainer_lib.classification_task(), learning_rate=1e-3,
                                  weight_decay=0.05, device="cuda")
    batch = vit_lib.synthetic_batch(torch.Generator().manual_seed(6), VIT_BATCH, vit_lib.VIT_B16)
    profile = profile_regions("vit_profile", trainer, batch, vit_targets(bert_lib, attention_lib),
                              smi, {"model": "ViT-B/16", "batch": VIT_BATCH})
    del trainer, model
    free_device_memory()
    return {"train": report, "profile": profile}


def vit_step_readings(vit_lib, cfg, weights, batch, device) -> dict:
    model = built_from(lambda: vit_lib.ViT(cfg), weights, device)
    logits = model(batch["image"].to(device))
    loss = F.cross_entropy(logits.float(), batch["label"].to(device))
    loss.backward()
    return {"loss": loss.item(), "logits": logits.detach().float().cpu(),
            "grads": {n: p.grad.float().cpu() for n, p in model.named_parameters()}}


def run_vit_parity(vit_lib, smi) -> dict:
    """vit_parity: ViT-B/16 (full width) at batch VIT_PARITY_BATCH, for
    both pools and for f32 and uint8 images: f32 on the card (TF32 off in
    matmuls and convs) against f32 on the CPU (logits, loss, gradients),
    bf16 against f32 on the card (the loss), and a --remat step against a
    plain one on the card in bf16 (bit-equality reported, gradients within
    REMAT_RTOL relative L2). A planted control: the CPU's gradients held
    against a card step whose patch grid is flattened column-major must
    fail the f32 bound."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"phase": "vit_parity", "model": "ViT-B/16", "card": smi,
              "batch": VIT_PARITY_BATCH, "cases": {}}
    failures = []
    cpu_readings = {}
    for pool in ("gap", "cls"):
        for wire in ("float", "uint8"):
            cfg32 = dataclasses.replace(vit_lib.VIT_B16, pool=pool, dtype=torch.float32)
            weights = seeded(vit_lib.ViT, cfg32, 21).state_dict()
            batch = vit_lib.synthetic_batch(torch.Generator().manual_seed(22), VIT_PARITY_BATCH,
                                            cfg32)
            if wire == "uint8":
                batch["image"] = torch.randint(0, 256, batch["image"].shape, dtype=torch.uint8,
                                               generator=torch.Generator().manual_seed(23))
            cpu = cpu_readings[pool, wire] = vit_step_readings(vit_lib, cfg32, weights, batch,
                                                               "cpu")
            card = vit_step_readings(vit_lib, cfg32, weights, batch, "cuda")
            cfg16 = dataclasses.replace(cfg32, dtype=torch.bfloat16)
            bf16 = vit_step_readings(vit_lib, cfg16, weights, batch, "cuda")
            remat = vit_step_readings(vit_lib, dataclasses.replace(cfg16, remat=True), weights,
                                      batch, "cuda")
            grads = rel_l2_worst(*without_key_bias(card["grads"], cpu["grads"]))
            remat_worst = rel_l2_worst(remat["grads"], bf16["grads"])
            case = {
                "logits_max_abs_f32": max_err(card["logits"], cpu["logits"]),
                "loss_f32": [card["loss"], cpu["loss"]], "grads_worst_rel_l2_f32": grads,
                "loss_bf16": bf16["loss"],
                "remat_bit_equal": bool(torch.equal(remat["logits"], bf16["logits"])) and all(
                    torch.equal(remat["grads"][n], bf16["grads"][n]) for n in bf16["grads"]),
                "remat_grads_worst_rel_l2": remat_worst,
            }
            report["cases"][f"{pool}-{wire}"] = case
            if case["logits_max_abs_f32"] > VIT_F32_LOGIT_ATOL or grads[0] > VIT_F32_GRAD_RTOL:
                failures.append(f"{pool}-{wire} f32")
            if abs(bf16["loss"] - card["loss"]) > VIT_BF16_LOSS_ATOL:
                failures.append(f"{pool}-{wire} bf16 loss")
            if remat_worst[0] > REMAT_RTOL:
                failures.append(f"{pool}-{wire} remat")
    # the planted control: position_embed added to a column-major patch order,
    # held against the gap pool's f32 CPU step (the default pool's weights and
    # batch: the same computation)
    cfg32 = dataclasses.replace(vit_lib.VIT_B16, dtype=torch.float32)
    weights = seeded(vit_lib.ViT, cfg32, 21).state_dict()
    batch = vit_lib.synthetic_batch(torch.Generator().manual_seed(22), VIT_PARITY_BATCH, cfg32)
    cpu = cpu_readings[cfg32.pool, "float"]
    grid = cfg32.image_size // cfg32.patch_size
    transposed = dict(weights)
    pos = weights["position_embed"].reshape(1, grid, grid, -1).transpose(1, 2)
    transposed["position_embed"] = pos.reshape(1, grid * grid, -1).contiguous()
    planted = vit_step_readings(vit_lib, cfg32, transposed, batch, "cuda")
    report["planted_column_major"] = {
        "logits_max_abs": max_err(planted["logits"], cpu["logits"])}
    report["tolerances"] = {"logits_atol": VIT_F32_LOGIT_ATOL, "grad_rel_l2": VIT_F32_GRAD_RTOL,
                            "bf16_loss_atol": VIT_BF16_LOSS_ATOL, "remat_rel_l2": REMAT_RTOL}
    emit(report)
    if failures:
        raise AssertionError(f"vit_parity: {failures}")
    if report["planted_column_major"]["logits_max_abs"] <= VIT_F32_LOGIT_ATOL:
        raise AssertionError("vit_parity: the planted patch order passed the bound")
    free_device_memory()
    return report


def run_moe_vit_phases(kernels, smi) -> dict:
    """The MoE family's and ViT-B/16's phases, in order; K1-K5 must not
    launch in any of them."""
    from tf_operator_tpu_torch.models import bert as bert_lib
    from tf_operator_tpu_torch.models import moe as moe_lib
    from tf_operator_tpu_torch.models import vit as vit_lib
    from tf_operator_tpu_torch.ops import attention as attention_lib
    from tf_operator_tpu_torch.ops import losses as losses_lib
    from tf_operator_tpu_torch.serve import server as server_lib
    from tf_operator_tpu_torch.train import moe as moe_cli
    from tf_operator_tpu_torch.train import trainer as trainer_lib
    from tf_operator_tpu_torch.train import vit as vit_cli

    kernels.reset_launches()
    out = {"moe_train": run_moe_train(kernels, moe_lib, moe_cli, smi)}
    out["moe_profile"] = run_moe_profile(moe_lib, bert_lib, attention_lib, losses_lib,
                                         trainer_lib, smi)
    out["moe_parity"] = run_moe_parity(moe_lib, trainer_lib, smi)
    out["moe_run_steps"] = run_moe_run_steps(kernels, moe_lib, trainer_lib, smi)
    out["moe_generate"] = run_moe_generate(moe_lib, smi)
    out["moe_serve"] = run_moe_serve(moe_lib, server_lib, smi)
    kernels.reset_launches()
    out["vit"] = run_vit(vit_lib, vit_cli, bert_lib, attention_lib, trainer_lib, smi)
    out["vit_parity"] = run_vit_parity(vit_lib, smi)
    if any(kernels.LAUNCHES.values()):
        raise AssertionError(f"the ViT phases launched kernels of the port: {kernels.LAUNCHES}")
    return out



# the telemetry phases: train_observe, train_observe_smoke, serve_observe
OBSERVE_ROUTES = ("/metrics", "/healthz", "/debug/slozz", "/debug/flightz", "/debug/historyz",
                  "/debug/alertz", "/debug/profilez")
OBSERVE_QUOTAS = {"noisy": {"rate": 200, "burst": 400, "priority": "batch"},
                  "vip": {"priority": "high"}, "*": {"priority": "standard"}}
OBSERVE_TENANTS = ("vip", "default", "noisy")  # request i comes from tenant i % 3
OBSERVE_CLASSES = {"vip": "high", "default": "standard", "noisy": "batch"}
OBSERVE_WINDOW_MS = 5.0
OBSERVE_HISTORY_S = 0.5
# noisy requests of SERVE_NEW[1] tokens sent at once: 5 x 128 = 640 tokens
# against a 400-token burst refilled at 200 tokens/s
OBSERVE_NOISY_BURST = 5
# the healthy smoke worker's steps/s when the straggler fired, as a share of
# its steady rate: both workers' inputs are paced at 0.05 s a batch, and
# only worker-1's gains the fault's host sleep
OBSERVE_RATE_KEEP = 0.7
OBSERVE_DEBUG_ROUTES = ("/debug/clockz", "/debug/flightz?limit=20", "/debug/historyz",
                        "/debug/alertz", "/debug/profilez?seconds=0.2&format=json",
                        "/debug/trace")


def http_get(port: int, path: str, timeout: float = 30.0) -> tuple:
    """(status, body bytes) of one GET; an HTTP error's status and body."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def run_train_observe(kernels, gpt_cli, smi, gpt_summary) -> dict:
    """train_observe: gpt_train's run with the worker telemetry server up
    (see the module docstring, phase 41)."""
    import threading

    from tf_operator_tpu_torch.telemetry import default_registry, validate_text

    port = free_port()
    steps_family = default_registry().get("train_steps_total")
    base = steps_family.value if steps_family is not None else 0.0
    stop = threading.Event()
    scraped = {path: [] for path in OBSERVE_ROUTES}
    phases, per_step, errors = set(), [], []

    def scraper():
        while not stop.is_set():
            for path in OBSERVE_ROUTES:
                try:
                    status, body = http_get(port, path)
                except OSError:  # the listener is not up yet, or is gone
                    continue
                scraped[path].append(status)
                if path == "/healthz" and status == 200:
                    phases.add(json.loads(body)["phase"])
            stop.wait(0.25)

    def on_step(state):
        status, body = http_get(port, "/metrics")
        text = body.decode()
        try:
            validate_text(text)
        except Exception as err:  # noqa: BLE001 — raised below
            errors.append(repr(err))
        value = next(float(line.split()[1]) for line in text.splitlines()
                     if line.startswith("tf_operator_tpu_train_steps_total "))
        per_step.append({"step": state.step, "status": status, "steps_total": value - base})

    thread = threading.Thread(target=scraper, name="observe-scraper", daemon=True)
    thread.start()
    torch.cuda.empty_cache()
    kernels.reset_launches()
    try:
        summary, state = gpt_cli.train(
            gpt_args(gpt_cli, GPT_STEPS, extra=("--monitoring-bind-addr", f"127.0.0.1:{port}")),
            on_step=on_step)
    finally:
        stop.set()
        thread.join(timeout=30)
    launches = dict(kernels.LAUNCHES)
    del state
    want = {k: 0 for k in launches}
    want["flash_fwd"] = LAYERS * summary["forward_passes"]
    want["flash_bwd_dkv"] = want["flash_bwd_dq"] = LAYERS * summary["backward_passes"]
    steps_run = summary["step"]
    report = {
        "phase": "train_observe", "card": smi, "model": "GPT-small", "shape": list(GPT_SHAPE),
        "tokens_per_sec": summary["tokens_per_sec"],
        "gpt_train_tokens_per_sec": gpt_summary["tokens_per_sec"],
        "ratio_to_gpt_train": summary["tokens_per_sec"] / gpt_summary["tokens_per_sec"],
        "steps_run": steps_run, "per_step": per_step, "healthz_phases": sorted(phases),
        "scrapes": {path: len(codes) for path, codes in scraped.items()},
        "launches": launches, "launches_expected": want,
        "launches_per_pass": {
            "flash_fwd": launches["flash_fwd"] / summary["forward_passes"],
            "flash_bwd_dkv": launches["flash_bwd_dkv"] / summary["backward_passes"],
            "flash_bwd_dq": launches["flash_bwd_dq"] / summary["backward_passes"]},
        "loss": summary["loss"], "first_loss": summary["first_loss"],
    }
    emit(report)
    problems = list(errors)
    if launches != want:
        problems.append(f"launches {launches} != expected {want}")
    if not per_step or per_step[-1]["steps_total"] != steps_run:
        problems.append(f"train_steps_total moved {per_step[-1:]} for {steps_run} steps")
    if [p["steps_total"] for p in per_step] != list(range(1, steps_run + 1)):
        problems.append(f"train_steps_total per step {[p['steps_total'] for p in per_step]}")
    if "training" not in phases:
        problems.append(f"/healthz never read training: {sorted(phases)}")
    for path, codes in scraped.items():
        if not codes or any(code != 200 for code in codes):
            problems.append(f"{path}: statuses {sorted(set(codes))} over {len(codes)} reads")
    if not math.isfinite(summary["tokens_per_sec"]) or summary["tokens_per_sec"] <= 0:
        problems.append(f"tokens/s {summary['tokens_per_sec']}")
    if problems:
        raise AssertionError(f"train_observe: {problems}")
    return report


def run_train_observe_smoke(smi) -> dict:
    """train_observe_smoke: train/observe.py's smoke on the card (phase 42)."""
    from tf_operator_tpu_torch.train import observe

    summary = observe.run_train_observe_smoke(device="cuda")  # raises on any problem
    rates = summary["rates"]
    healthy = {stage: rates.get(stage, {}).get("worker-0")
               for stage in ("baseline", "fired", "resolved")}
    emit({"phase": "train_observe_smoke", "card": smi,
          **{k: v for k, v in summary.items() if k not in ("slow_traces", "fleet")},
          "healthy_worker_rate": healthy})
    # the baseline's window holds the warm-up step; the rate after the
    # resolve is the healthy worker's steady one
    steady = max(healthy["baseline"] or 0.0, healthy["resolved"] or 0.0)
    if not (steady and healthy["fired"] and healthy["fired"] >= OBSERVE_RATE_KEEP * steady):
        raise AssertionError(f"train_observe_smoke: the healthy worker's rate followed the "
                             f"slowed one's: {rates}")
    return summary


def stream_with_tenant(port: int, prompt: list, new: int, tenant: str) -> dict:
    """One /generate_stream as `tenant`; a 429 is retried after its
    Retry-After, as a client does. -> the chain, the seconds to the first
    streamed token of the admitted attempt and to the end, and every 429's
    Retry-After."""
    import urllib.error
    import urllib.request

    retries = []
    while True:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate_stream",
            data=json.dumps({"input_ids": [prompt], "max_new_tokens": new}).encode(),
            headers={"Content-Type": "application/json", "X-Tenant": tenant}, method="POST")
        start = time.monotonic()
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                first, done = None, None
                for line in resp:
                    event = json.loads(line)
                    if "token" in event and first is None:
                        first = time.monotonic() - start
                    if event.get("done"):
                        done = event
                    if "error" in event:
                        raise AssertionError(f"stream error: {event['error']}")
            return {"chain": done["tokens"][0], "ttft_s": first,
                    "latency_s": time.monotonic() - start, "retry_after": retries}
        except urllib.error.HTTPError as err:
            if err.code != 429:
                raise
            hint = err.headers.get("Retry-After")
            retries.append(hint)
            if hint is None:
                raise AssertionError("a 429 without Retry-After")
            time.sleep(float(hint))


def serve_observe_mode(gpt_lib, model, reqs, batching: str, smi) -> dict:
    """One mode of serve_observe: the server, the load over streams with
    tenants, the noisy burst and the debug routes."""
    import threading

    from tf_operator_tpu_torch.serve import make_server
    from tf_operator_tpu_torch.telemetry import quantile_from_flat

    options = ({"batching": "continuous", "n_slots": SERVE_SLOTS, "kv_layout": "paged",
                "block_size": SERVE_BLOCK, "prefill_chunk": SERVE_CHUNK}
               if batching == "continuous"
               else {"batching": "window", "batch_window_ms": OBSERVE_WINDOW_MS})
    start = time.monotonic()
    server = make_server(model, device="cuda", max_new_cap=SERVE_NEW[1],
                         tenant_quotas=OBSERVE_QUOTAS, alerts=True,
                         history_interval_s=OBSERVE_HISTORY_S, enable_debug_endpoints=True,
                         **options)
    startup_s = time.monotonic() - start
    port = server.server_address[1]
    listener = threading.Thread(target=server.serve_forever, daemon=True)
    listener.start()
    try:
        results, wall = client_pool(
            lambda i: stream_with_tenant(port, reqs[i]["prompt"], reqs[i]["new"],
                                         OBSERVE_TENANTS[i % 3]),
            len(reqs), SERVE_CLIENTS, f"serve_observe {batching}")
        # the noisy tenant's burst over its bucket, all at once
        burst = [None] * OBSERVE_NOISY_BURST

        def noisy(k):
            burst[k] = post_with_tenant(port, reqs[k]["prompt"][:16], SERVE_NEW[1], "noisy")

        bursters = [threading.Thread(target=noisy, args=(k,)) for k in range(len(burst))]
        for t in bursters:
            t.start()
        for t in bursters:
            t.join(timeout=600)
        time.sleep(2 * OBSERVE_HISTORY_S)  # at least one history tick after the load
        pages = {path: http_get(port, path) for path in OBSERVE_DEBUG_ROUTES}
        metrics = http_get(port, "/metrics")[1].decode()
    finally:
        server.shutdown()
        server.server_close()
        if server.state.engine is not None:
            server.state.engine.stop()
        listener.join(timeout=30)
    flat = {}
    for line in metrics.splitlines():
        if line and not line.startswith("#"):
            name, value = line.split()
            flat[name] = float(value)
    ttfts = [r["ttft_s"] for r in results]
    by_class = {}
    for i, r in enumerate(results):
        by_class.setdefault(OBSERVE_CLASSES[OBSERVE_TENANTS[i % 3]], []).append(r["ttft_s"])

    def p(values, q):
        return float(torch.tensor(values).quantile(q))

    alertz = json.loads(pages["/debug/alertz"][1])
    return {
        "batching": batching, "startup_s": startup_s, "load_wall_s": wall,
        "requests": len(reqs), "generated_tokens_per_s": sum(r["new"] for r in reqs) / wall,
        "ttft_p50_s": p(ttfts, 0.5), "ttft_p95_s": p(ttfts, 0.95),
        "ttft_by_class": {cls: {"n": len(v), "p50_s": p(v, 0.5), "p95_s": p(v, 0.95)}
                          for cls, v in sorted(by_class.items())},
        "server_ttft_p50_s": quantile_from_flat(flat, "tf_operator_tpu_serve_ttft_seconds", 0.5),
        "server_ttft_p95_s": quantile_from_flat(flat, "tf_operator_tpu_serve_ttft_seconds",
                                                0.95),
        "load_429s": {t: sum(len(r["retry_after"]) for i, r in enumerate(results)
                             if OBSERVE_TENANTS[i % 3] == t) for t in OBSERVE_TENANTS},
        "burst": [b[0] for b in burst], "burst_retry_after": [b[1] for b in burst],
        "tenant_rejected": {k: v for k, v in flat.items() if "tenant_rejected_total" in k},
        "debug_routes": {path: status for path, (status, _) in pages.items()},
        "alerts_firing": alertz["firing"], "alert_evaluations": alertz["evaluations"],
        "history_ticks": json.loads(pages["/debug/historyz"][1])["ticks"],
        "chains": [r["chain"] for r in results],
    }


def post_with_tenant(port: int, prompt: list, new: int, tenant: str) -> tuple:
    """(status, Retry-After) of one /generate as `tenant`."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({"input_ids": [prompt], "max_new_tokens": new}).encode(),
        headers={"Content-Type": "application/json", "X-Tenant": tenant}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            resp.read()
            return resp.status, None
    except urllib.error.HTTPError as err:
        err.read()
        return err.code, err.headers.get("Retry-After")


def run_serve_observe(kernels, gpt_lib, smi) -> dict:
    """serve_observe: phase 43 of the module docstring."""
    cfg = gpt_lib.GPT_SMALL
    model = gpt_lib.GPT(cfg, generator=torch.Generator().manual_seed(SERVE_SEED), device="cuda")
    reqs = serve_requests(cfg)
    chains, logits = inline_chains(gpt_lib, model, reqs)
    inline = []
    for i, r in enumerate(reqs):
        p = len(r["prompt"])
        inline.append((chains[i, :p + r["new"]].tolist(),
                       decisions(logits[p - 1:p + r["new"] - 1, i]).cpu()))
    del chains, logits
    free_device_memory()
    kernels.reset_launches()
    modes = {}
    problems = []
    for batching in ("continuous", "window"):
        mode = serve_observe_mode(gpt_lib, model, reqs, batching, smi)
        differ = []
        for i, (r, served) in enumerate(zip(reqs, mode.pop("chains"))):
            want, decided = inline[i]
            j = first_diff(served, want)
            if j is not None:
                _, m, bound = decided[j - len(r["prompt"])].tolist()
                differ.append({"request": i, "position": j, "inline_margin": m,
                               "bound": bound})
                if m > bound:
                    problems.append(f"{batching}: request {i} left the inline chain at {j} "
                                    f"on a margin of {m} > {bound}")
        mode["differ"] = differ
        modes[batching] = mode
        emit({"phase": "serve_observe", "card": smi, "model": "GPT-small", **mode})
        if 429 not in mode["burst"]:
            problems.append(f"{batching}: the noisy burst drew no 429: {mode['burst']}")
        if any(code == 429 and not hint for code, hint in zip(mode["burst"],
                                                             mode["burst_retry_after"])):
            problems.append(f"{batching}: a 429 without Retry-After")
        if mode["load_429s"]["vip"]:
            problems.append(f"{batching}: the vip tenant drew 429s {mode['load_429s']}")
        bad = {path: status for path, status in mode["debug_routes"].items() if status != 200}
        if bad:
            problems.append(f"{batching}: debug routes {bad}")
        if mode["history_ticks"] < 1:
            problems.append(f"{batching}: the history never ticked")
    launches = dict(kernels.LAUNCHES)
    if any(launches.values()):
        problems.append(f"serve_observe launched a kernel of K1-K5: {launches}")
    if problems:
        raise AssertionError(f"serve_observe: {problems}")
    return modes


def run_observe_phases(kernels, gpt_cli, smi, gpt_summary) -> dict:
    """train_observe, train_observe_smoke and serve_observe, in order."""
    from tf_operator_tpu_torch.models import gpt as gpt_lib

    start = time.monotonic()
    out = {"train_observe": run_train_observe(kernels, gpt_cli, smi, gpt_summary)}
    free_device_memory()
    out["train_observe_smoke"] = run_train_observe_smoke(smi)
    free_device_memory()
    out["serve_observe"] = run_serve_observe(kernels, gpt_lib, smi)
    free_device_memory()
    emit({"phase": "observe_seconds", "seconds": time.monotonic() - start})
    return out


# -- disaggregated serving and the serving artifact ------------------------------

DISAGG_SEED = 31
DISAGG_PREFIX = 512  # the shared prefix: 8 blocks of 64
DISAGG_FAMILY = 16  # streams of the shared-prefix family
DISAGG_OWN = (16, 128)  # each family stream's own tokens after the prefix
DISAGG_SOLO = 8  # streams with no shared prefix
DISAGG_SOLO_PROMPT = (64, 128)  # 1-2 blocks
DISAGG_NEW = (32, 64)
DISAGG_CLIENTS = 8
DISAGG_INT8_STREAMS = 4
DISAGG_TIMING_REPS = 3
EXPORT_NEW = 16
EXPORT_PROMPTS = 2
EXPORT_SERVE_TIMEOUT_S = 300


def disagg_requests(cfg, seed: int = DISAGG_SEED) -> list:
    """DISAGG_FAMILY streams of a DISAGG_PREFIX-token shared prefix plus
    their own DISAGG_OWN tokens, then DISAGG_SOLO streams of a
    DISAGG_SOLO_PROMPT-token prompt of their own; DISAGG_NEW new tokens
    each; all drawn from a seeded generator."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, DISAGG_PREFIX).tolist()
    reqs = []
    for i in range(DISAGG_FAMILY + DISAGG_SOLO):
        new = int(rng.integers(DISAGG_NEW[0], DISAGG_NEW[1] + 1))
        if i < DISAGG_FAMILY:
            own = int(rng.integers(DISAGG_OWN[0], DISAGG_OWN[1] + 1))
            prompt = prefix + rng.integers(0, cfg.vocab_size, own).tolist()
        else:
            p = int(rng.integers(DISAGG_SOLO_PROMPT[0], DISAGG_SOLO_PROMPT[1] + 1))
            prompt = rng.integers(0, cfg.vocab_size, p).tolist()
        reqs.append({"prompt": prompt, "new": new, "family": i < DISAGG_FAMILY})
    return reqs


def concurrent_streams(open_stream, reqs, clients: int) -> list:
    """Each request through open_stream(prompt, new) (an iterator of
    events ending with a done event) from `clients` threads (client_pool):
    -> per request {"chain", "ttft_s", "replicas"} in request order; the
    client side's seconds to the first token event."""
    def one(i):
        start = time.monotonic()
        first, done, replicas = None, None, set()
        for event in open_stream(reqs[i]["prompt"], reqs[i]["new"]):
            if "token" in event:
                if first is None:
                    first = time.monotonic() - start
                replicas.add(event.get("replica"))
            if event.get("done"):
                done = event
        return {"chain": done["tokens"][0], "ttft_s": first, "replicas": replicas}

    return client_pool(one, len(reqs), clients, "streams")[0]


def leaf_bytes_differ(a: dict, b: dict) -> dict:
    """Two block sets' leaves compared byte for byte: how many leaves
    differ and the worst difference in ulps of the leaf's dtype (bf16 and
    f32 through their integer bit patterns, int8 codes as numbers)."""
    import base64

    import numpy as np

    bits = {"bfloat16": np.int16, "float32": np.int32, "int8": np.int8}
    differ, worst = 0, 0
    if (a["tokens"], a["blocks"], len(a["leaves"])) != (b["tokens"], b["blocks"],
                                                        len(b["leaves"])):
        return {"comparable": False}
    for x, y in zip(a["leaves"], b["leaves"]):
        if x["data"] == y["data"]:
            continue
        differ += 1
        dt = bits[x["dtype"]]
        u = np.frombuffer(base64.b64decode(x["data"]), dt).astype(np.int64)
        v = np.frombuffer(base64.b64decode(y["data"]), dt).astype(np.int64)
        worst = max(worst, int(np.abs(u - v).max()))
    return {"comparable": True, "leaves": len(a["leaves"]), "leaves_differing": differ,
            "worst_ulps": worst}


def empty_pool(engine) -> None:
    """Drop the prefix cache and zero the pool in place (the captured
    programs keep their tensors): a block a later import forgets to write
    then reads zeros, not the bytes an earlier prefill left there."""
    def op():
        engine.pool.flush()
        engine.step.init_cache()
        torch.cuda.synchronize()

    engine._submit_op(op)  # on the engine's own thread, between its quanta


def planted_imports(engine) -> dict:
    """The two planted faults of an import on the card: a write that
    rebinds the pool's tensors (the captured programs go on reading the
    old ones) and a write one block off. -> name -> (install, restore)."""
    cache = engine.step.cache
    lists = [cache.keys, cache.values] + ([cache.key_scales, cache.value_scales]
                                          if cache.quantized else [])
    saved = [list(lst) for lst in lists]

    def rebinding(leaves, idx, rows):
        fresh = {}
        for leaf, data in zip(leaves, rows):
            new = leaf.clone()
            new.index_copy_(0, idx, data.to(leaf.device))
            fresh[id(leaf)] = new
        for lst in lists:
            for i, t in enumerate(lst):
                lst[i] = fresh.get(id(t), t)

    def one_off(leaves, idx, rows):
        shifted = torch.where(idx + 1 < engine.pool.num_blocks, idx + 1, torch.ones_like(idx))
        for leaf, data in zip(leaves, rows):
            leaf.index_copy_(0, shifted, data.to(leaf.device))

    def restore():
        engine.__dict__.pop("_write_blocks", None)
        for lst, old in zip(lists, saved):
            lst[:] = old

    return {name: (lambda fn=fn: setattr(engine, "_write_blocks", fn), restore)
            for name, fn in (("rebinding_import", rebinding), ("one_block_off", one_off))}


def migration_cost(client_pre, client_dec, engine_pre, engine_dec, prompt) -> dict:
    """One migration of `prompt`'s block set, its parts timed apart
    (median of DISAGG_TIMING_REPS): the export on the prefill replica's
    engine, the POST /kv/import round trip to the decode replica, and the
    import alone on the decode replica's engine (base64 decode, the host
    to device copy, one index_copy_ a leaf); ship = round trip - import.
    Bytes: raw (the leaves), base64 and the JSON body."""
    import base64

    export_ms, trip_ms, import_ms = [], [], []
    payload = None
    for _ in range(DISAGG_TIMING_REPS):
        start = time.monotonic()
        payload = engine_pre.export_prefix_blocks(prompt)
        export_ms.append((time.monotonic() - start) * 1e3)
        empty_pool(engine_dec)
        start = time.monotonic()
        client_dec.kv_import(payload)
        trip_ms.append((time.monotonic() - start) * 1e3)
        empty_pool(engine_dec)
        start = time.monotonic()
        engine_dec.import_prefix_blocks(payload)
        engine_dec._submit_op(torch.cuda.synchronize)
        import_ms.append((time.monotonic() - start) * 1e3)
    empty_pool(engine_dec)
    raw = sum(len(base64.b64decode(leaf["data"])) for leaf in payload["leaves"])
    b64 = sum(len(leaf["data"]) for leaf in payload["leaves"])
    med = statistics.median
    return {
        "blocks": payload["blocks"], "tokens": len(payload["tokens"]),
        "leaves": len(payload["leaves"]), "raw_bytes": raw, "base64_bytes": b64,
        "json_bytes": len(json.dumps(payload)),
        "export_ms": med(export_ms), "kv_import_round_trip_ms": med(trip_ms),
        "import_ms": med(import_ms), "ship_ms": med(trip_ms) - med(import_ms),
        "reps": DISAGG_TIMING_REPS,
    }


def disagg_pair(model, smi, kv_quant_int8: bool = False):
    """A prefill and a decode server (make_server, 8 slots, the default
    pool, paged 64-token blocks, 64-token chunks) on 127.0.0.1 in this
    process, and a LeastLoadedRouter in front: -> (servers by role,
    clients by role, router)."""
    import threading

    from tf_operator_tpu_torch.serve import DecodeClient, LeastLoadedRouter, make_server

    servers, clients = {}, {}
    router = LeastLoadedRouter(retry_wait=0.01, stream_deadline=600.0)
    for role in ("prefill", "decode"):
        srv = make_server(model, batching="continuous", n_slots=SERVE_SLOTS, kv_layout="paged",
                          block_size=SERVE_BLOCK, prefill_chunk=SERVE_CHUNK, device="cuda",
                          max_new_cap=DISAGG_NEW[1], kv_quant_int8=kv_quant_int8, role=role)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        servers[role], clients[role] = srv, DecodeClient(url, timeout=600)
        router.add_replica(role, url, role=role)
    return servers, clients, router


def close_pair(servers) -> None:
    for srv in servers.values():
        srv.shutdown()
        srv.server_close()
        srv.state.engine.stop()


def pools_clean(servers) -> dict:
    """Each engine's pool audit (on its thread) and its blocks in use."""
    out = {}
    for role, srv in servers.items():
        engine = srv.state.engine
        out[role] = {"audit_ok": bool(engine.audit_pool("disagg_serve")),
                     "in_use": engine.pool.in_use(), "cached": engine.pool.cached_blocks()}
    return out


def run_disagg_serve(kernels, gpt_lib, smi) -> dict:
    """disagg_serve: GPT-small (bf16, random weights from DISAGG_SEED) as a
    prefill server and a decode server in this process behind the port's
    LeastLoadedRouter (serve/router.py): DISAGG_FAMILY + DISAGG_SOLO
    streams (disagg_requests) from DISAGG_CLIENTS threads through the
    router, every one picked by the decode pool and migrated first (the
    prefill replica prefills it and ships its block set to the decode
    replica's /kv/import); then the same streams served monolithically by
    the decode replica alone, its pool emptied first. Held: every chain
    equal to the monolithic one (reported with the inline margin where
    not), and to the inline generate under the margin rule; the decode
    replica runs no prefill chunk during the migrated streams; the
    imported bytes of one prompt against the decode replica's own prefill
    of it, byte for byte; both pools audit clean and end with no block in
    use; the import route alone (pool emptied, a block set imported,
    /generate) gives the monolithic chain, and two planted imports on it
    (rebinding the pool tensors, one block off) must each break it; a
    short run of
    DISAGG_INT8_STREAMS under kv_quant_int8 moves the scale leaves with
    the same checks. Reported: migrations, failures and decode-pool
    picks, one migration's bytes and ms by part, TTFT p50/p95 migrated
    against monolithic. No kernel of K1-K5 runs on this path."""
    import numpy as np

    cfg = gpt_lib.GPT_SMALL
    model = gpt_lib.GPT(cfg, generator=torch.Generator().manual_seed(DISAGG_SEED),
                        device="cuda")
    reqs = disagg_requests(cfg)
    kernels.reset_launches()
    start = time.monotonic()
    servers, clients, router = disagg_pair(model, smi)
    startup_s = time.monotonic() - start
    pre, dec = servers["prefill"].state.engine, servers["decode"].state.engine
    try:
        chunks_before = dec.prefill_chunks
        start = time.monotonic()
        migrated = concurrent_streams(
            lambda prompt, new: router.generate_stream(prompt, new), reqs, DISAGG_CLIENTS)
        migrated_wall = time.monotonic() - start
        dec_chunks_migrated = dec.prefill_chunks - chunks_before
        stats = router.stats()
        probe = reqs[0]["prompt"]
        imported = dec.export_prefix_blocks(probe)
        # the same streams, monolithic: the decode replica alone
        empty_pool(dec)
        start = time.monotonic()
        mono = concurrent_streams(
            lambda prompt, new: clients["decode"].generate_stream(prompt, new), reqs,
            DISAGG_CLIENTS)
        mono_wall = time.monotonic() - start
        own = dec.export_prefix_blocks(probe)
        bytes_check = leaf_bytes_differ(imported, own)
        cost = migration_cost(clients["prefill"], clients["decode"], pre, dec, probe)
        # the import route (pool emptied, the prefill replica's block set
        # imported, /generate): unplanted it must give the monolithic
        # chain; each planted import must break it
        payload = pre.export_prefix_blocks(probe)

        def via_import(install=None, restore=None):
            empty_pool(dec)
            if install is not None:
                install()
            try:
                dec.import_prefix_blocks(payload)
                got = clients["decode"].generate([probe], max_new_tokens=reqs[0]["new"])[0]
            finally:
                if restore is not None:
                    restore()
            empty_pool(dec)
            return first_diff(got, mono[0]["chain"])

        unplanted = via_import()
        planted = {}
        for name, (install, restore) in planted_imports(dec).items():
            j = via_import(install, restore)
            planted[name] = {"chain_differs": j is not None, "first_difference": j}
        clean = pools_clean(servers)
        health = {role: c.healthy()["role"] for role, c in clients.items()}
    finally:
        close_pair(servers)
    launches = dict(kernels.LAUNCHES)
    free_device_memory()

    # held: the inline generate (one batched ragged call) under the margin rule
    chains, logits = inline_chains(gpt_lib, model, reqs)
    inline_differ = []
    for i, r in enumerate(reqs):
        p = len(r["prompt"])
        j = first_diff(migrated[i]["chain"], chains[i, :p + r["new"]].tolist())
        if j is not None:
            _, m, bound = decisions(logits[j - 1, i]).tolist()
            inline_differ.append({"request": i, "position": j, "inline_margin": m,
                                  "bound": bound})
    mono_differ = []
    for i, r in enumerate(reqs):
        j = first_diff(migrated[i]["chain"], mono[i]["chain"])
        if j is not None:
            _, m, bound = decisions(logits[j - 1, i]).tolist()
            mono_differ.append({"request": i, "position": j, "inline_margin": m,
                                "bound": bound})
    del logits
    free_device_memory()

    # the short int8-KV run: the scale leaves cross too
    int8_reqs = reqs[:DISAGG_INT8_STREAMS]
    servers8, clients8, router8 = disagg_pair(model, smi, kv_quant_int8=True)
    try:
        dec8 = servers8["decode"].state.engine
        migrated8 = concurrent_streams(
            lambda prompt, new: router8.generate_stream(prompt, new), int8_reqs,
            DISAGG_INT8_STREAMS)
        chunks8 = dec8.prefill_chunks
        payload8 = servers8["prefill"].state.engine.export_prefix_blocks(int8_reqs[0]["prompt"])
        empty_pool(dec8)
        mono8 = concurrent_streams(
            lambda prompt, new: clients8["decode"].generate_stream(prompt, new), int8_reqs,
            DISAGG_INT8_STREAMS)
        stats8 = router8.stats()
        clean8 = pools_clean(servers8)
    finally:
        close_pair(servers8)
    free_device_memory()

    def quantiles(values):
        return {"p50": float(np.quantile(values, 0.5)), "p95": float(np.quantile(values, 0.95))}

    decode_picks = [d["picked"] for d in stats["decisions"]]
    report = {
        "phase": "disagg_serve", "card": smi, "model": "GPT-small", "dtype": "bf16",
        "slots": SERVE_SLOTS, "block_size": SERVE_BLOCK, "prefill_chunk": SERVE_CHUNK,
        "streams": len(reqs), "family": DISAGG_FAMILY, "shared_prefix": DISAGG_PREFIX,
        "solo": DISAGG_SOLO, "clients": DISAGG_CLIENTS, "startup_s": startup_s,
        "migrations": stats["migrations"], "migrate_failures": stats["migrate_failures"],
        "failovers": stats["failovers"],
        "decode_pool_picks": decode_picks.count("decode"), "picks": len(decode_picks),
        "decode_prefill_chunks_during_migrated": dec_chunks_migrated,
        "migrated_wall_s": migrated_wall, "monolithic_wall_s": mono_wall,
        "ttft_migrated_s": quantiles([m["ttft_s"] for m in migrated]),
        "ttft_monolithic_s": quantiles([m["ttft_s"] for m in mono]),
        "ttft_family_migrated_s": quantiles([m["ttft_s"] for m, r in zip(migrated, reqs)
                                             if r["family"]]),
        "ttft_family_monolithic_s": quantiles([m["ttft_s"] for m, r in zip(mono, reqs)
                                               if r["family"]]),
        "chains_differing_from_monolithic": len(mono_differ),
        "monolithic_differences": mono_differ,
        "chains_differing_from_inline": len(inline_differ),
        "inline_differences": inline_differ, "margin_ulps": SERVE_MARGIN_ULPS,
        "imported_vs_own_prefill": bytes_check, "migration": cost,
        "unplanted_import_first_difference": unplanted, "planted": planted,
        "pools": clean, "healthz_roles": health,
        "int8_kv": {
            "streams": len(int8_reqs), "migrations": stats8["migrations"],
            "migrate_failures": stats8["migrate_failures"],
            "leaves": len(payload8["leaves"]),
            "leaf_dtypes": sorted({leaf["dtype"] for leaf in payload8["leaves"]}),
            "decode_prefill_chunks_during_migrated": chunks8,
            "chains_differing_from_monolithic": sum(
                a["chain"] != b["chain"] for a, b in zip(migrated8, mono8)),
            "pools": clean8,
        },
        "launches": launches,
    }
    emit(report)
    problems = []
    if report["migrations"] < 1:
        problems.append("no migration happened")
    if any(d["picked"] != "decode" for d in stats["decisions"]) or \
            len(decode_picks) != len(reqs):
        problems.append("a stream was not picked by the decode pool")
    if any(d["inline_margin"] > d["bound"] for d in mono_differ):
        problems.append("a migrated chain differs from the monolithic one above the margin")
    if any(d["inline_margin"] > d["bound"] for d in inline_differ):
        problems.append("a migrated chain differs from the inline one above the margin")
    if dec_chunks_migrated != 0 and stats["migrate_failures"] == 0:
        problems.append("the decode replica ran prefill chunks for migrated streams")
    if not (bytes_check.get("comparable") and bytes_check["leaves_differing"] == 0):
        problems.append(f"the imported blocks differ from the decode replica's own prefill: "
                        f"{bytes_check}")
    if unplanted is not None:
        problems.append(f"the import route without a plant differs from the monolithic chain "
                        f"at {unplanted}")
    elif not all(p["chain_differs"] for p in planted.values()):
        problems.append(f"a planted import went unnoticed: {planted}")
    for pools in (clean, clean8):
        if not all(v["audit_ok"] and v["in_use"] == 0 for v in pools.values()):
            problems.append(f"a pool audit failed or a block stayed in use: {pools}")
    if health != {"prefill": "prefill", "decode": "decode"}:
        problems.append(f"/healthz roles {health}")
    int8 = report["int8_kv"]
    if int8["migrations"] < 1 or int8["leaf_dtypes"] != ["float32", "int8"] or \
            int8["chains_differing_from_monolithic"]:
        problems.append(f"the int8-KV run: {int8}")
    if any(launches.values()):
        problems.append(f"a kernel of K1-K5 launched on the serving path: {launches}")
    if problems:
        raise AssertionError(f"disagg_serve: {problems}")
    return report


def first_token_seconds(args: list, prompts: list, log_path: str) -> dict:
    """The serve CLI with args as a subprocess: the seconds from its start
    to the first streamed token of one request, then every prompt's greedy
    chain of EXPORT_NEW tokens; SIGTERM -> its exit code."""
    import urllib.request

    start = time.monotonic()
    proc, port, log = serve_cli(args, log_path)
    try:
        wait_for_health(port, proc, EXPORT_SERVE_TIMEOUT_S)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate_stream",
            data=json.dumps({"input_ids": [prompts[0]], "max_new_tokens": 1}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        first = None
        with urllib.request.urlopen(req, timeout=EXPORT_SERVE_TIMEOUT_S) as resp:
            for line in resp:
                if first is None and "token" in json.loads(line):
                    first = time.monotonic() - start
        chains = []
        for prompt in prompts:
            status, body = post_json(port, "/generate", {"input_ids": [prompt],
                                                         "max_new_tokens": EXPORT_NEW})
            if status != 200:
                raise AssertionError(f"serve {args}: {status} {body}")
            chains.append(body["tokens"][0])
    finally:
        code = stop_cli(proc, log)
    return {"first_token_s": first, "chains": chains, "exit_code": code}


def serve_sized_checkpoint(ckpt: str, out: str, cfg) -> tuple:
    """The newest step of a GPT training checkpoint written again at `out`
    with its position table cut to cfg.max_seq_len rows (the lifecycle
    phase trains GPT-small at seq 4096; the small preset serves 2048
    positions, and the reference's restore under the preset would refuse
    the longer table as the port's does). Only the model's weights are
    written: the server and the export read nothing else. -> (rows
    before, rows after)."""
    from tf_operator_tpu_torch.train.trainer import Checkpointer

    checkpointer = Checkpointer(ckpt)
    step = checkpointer.latest_step()
    payload = torch.load(checkpointer.path(step), map_location="cpu", weights_only=True)
    table = payload["model"]["position_embed.weight"]
    payload["model"]["position_embed.weight"] = table[:cfg.max_seq_len].clone()
    Checkpointer(out).write(step, {"model": payload["model"], "step": step})
    return table.shape[0], cfg.max_seq_len


def run_export_serve(gpt_lib, smi, ckpt: str, workdir: str) -> dict:
    """export_serve: serve/export.py on the GPT-small checkpoint the
    lifecycle phase wrote (its newest step; its position table cut to the
    small preset's 2048 rows by serve_sized_checkpoint): the params-only
    int8 artifact. Reported: the manifest's bytes (params against the
    training weights), the artifact's file against the training
    checkpoint's, the export's seconds, and the seconds from process start
    to the first served token of `serve --preset small --checkpoint-dir
    <artifact>` against `--weights-int8` on the training checkpoint. Held:
    the artifact's int8 tensors byte-equal to quantize_model of the
    restored weights on the card; the two servers' greedy chains equal;
    both exit 0 on SIGTERM."""
    import os

    import numpy as np

    from tf_operator_tpu_torch.ops.quant import quantize_model
    from tf_operator_tpu_torch.serve import export as export_mod
    from tf_operator_tpu_torch.train.trainer import Checkpointer

    trained_file = Checkpointer(ckpt).path(Checkpointer(ckpt).latest_step())
    rows = serve_sized_checkpoint(ckpt, os.path.join(workdir, "ckpt"), gpt_lib.GPT_SMALL)
    ckpt = os.path.join(workdir, "ckpt")
    art = os.path.join(workdir, "serving-int8")
    start = time.monotonic()
    code = export_mod.main(["--preset", "small", "--checkpoint-dir", ckpt, "--out", art])
    export_s = time.monotonic() - start
    state, manifest = export_mod.load_exported(art)
    checkpointer = Checkpointer(ckpt)
    step = checkpointer.latest_step()
    trained = torch.load(checkpointer.path(step), map_location="cpu", weights_only=True)
    model = built_from(lambda: gpt_lib.GPT(gpt_lib.GPT_SMALL), trained["model"], "cuda")
    twin = quantize_model(model).state_dict()
    int8_names = [n for n, t in state.items() if t.dtype == torch.int8]
    unequal = [n for n in state if not torch.equal(state[n], twin[n].cpu())]
    del model, twin, trained
    free_device_memory()
    rng = np.random.default_rng(DISAGG_SEED)
    prompts = [rng.integers(0, gpt_lib.GPT_SMALL.vocab_size, int(n)).tolist()
               for n in rng.integers(16, 256, EXPORT_PROMPTS)]
    # one process through the imports, the card's initialisation and a bf16
    # product (the GEMM libraries' first load) first, so that the server
    # timed first does not pay the cold file cache alone
    subprocess.run([sys.executable, "-c", "import torch; "
                    "x = torch.ones(256, 256, device='cuda', dtype=torch.bfloat16); "
                    "(x @ x).float().sum().item(); import tf_operator_tpu_torch.serve.server"],
                   check=True, timeout=300)
    served = {}
    for name, args in (
        ("artifact", ["--preset", "small", "--checkpoint-dir", art, "--batching", "continuous"]),
        ("weights_int8", ["--preset", "small", "--checkpoint-dir", ckpt, "--weights-int8",
                          "--batching", "continuous"]),
    ):
        served[name] = first_token_seconds(args, prompts, os.path.join(workdir, f"{name}.log"))
    report = {
        "phase": "export_serve", "card": smi, "model": "GPT-small", "step": manifest["step"],
        "position_rows": {"trained": rows[0], "served": rows[1]},
        "export_exit_code": code, "export_s": export_s, "manifest": manifest,
        "params_bytes_ratio": manifest["source_params_bytes"] / manifest["params_bytes"],
        "artifact_file_bytes": os.path.getsize(os.path.join(art, export_mod.PARAMS_FILE)),
        "checkpoint_file_bytes": os.path.getsize(trained_file),
        "int8_tensors": len(int8_names), "tensors_unequal_to_quantize_model": unequal,
        **{f"{name}_first_token_s": s["first_token_s"] for name, s in served.items()},
        **{f"{name}_exit_code": s["exit_code"] for name, s in served.items()},
        "chains_equal": served["artifact"]["chains"] == served["weights_int8"]["chains"],
    }
    report["file_bytes_ratio"] = report["checkpoint_file_bytes"] / report["artifact_file_bytes"]
    emit(report)
    problems = []
    if code != 0 or manifest["step"] != step or not manifest["quantized"]:
        problems.append("the export did not write the newest step's quantized artifact")
    if unequal or not int8_names:
        problems.append(f"artifact tensors differ from quantize_model's: {unequal[:5]}")
    if not report["chains_equal"]:
        problems.append("the artifact's chains differ from --weights-int8's")
    if any(s["exit_code"] != 0 for s in served.values()):
        problems.append("a server did not exit 0 on SIGTERM")
    if problems:
        raise AssertionError(f"export_serve: {problems}")
    return report


def run_disagg_phases(kernels, smi, ckpt=None) -> dict:
    """disagg_serve, then export_serve on the lifecycle phase's checkpoint
    (alone, with no checkpoint given: a GPT-small checkpoint of random
    weights from a seed, written by the port's Checkpointer)."""
    import os
    import shutil
    import tempfile

    from tf_operator_tpu_torch.models import gpt as gpt_lib
    from tf_operator_tpu_torch.train.trainer import Checkpointer

    out = {"disagg_serve": run_disagg_serve(kernels, gpt_lib, smi)}
    free_device_memory()
    workdir = tempfile.mkdtemp(prefix="export-")
    try:
        if ckpt is None:
            ckpt = os.path.join(workdir, "random")
            model = gpt_lib.GPT(gpt_lib.GPT_SMALL,
                                generator=torch.Generator().manual_seed(DISAGG_SEED))
            Checkpointer(ckpt).write(1, {"model": model.state_dict(), "step": 1})
            del model
        out["export_serve"] = run_export_serve(gpt_lib, smi, ckpt, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    free_device_memory()
    return out


# -- the serving fleet -------------------------------------------------------------

FLEET_SEED = 41
FLEET_REPLICAS = 3
FLEET_SLOTS = 4
FLEET_STREAMS = 8  # concurrent client streams
FLEET_PROMPT = (16, 512)  # prompt tokens, inclusive
FLEET_NEW = 32
FLEET_CONN_FAULTS = 2
FLEET_BLOCK = 64  # the serving defaults' block size (and prefill chunk)
FLEET_CONTROL = (2, 2, 16)  # the planted control's replicas, clients, new tokens
FLEET_AUTOSCALE_PROMPT = (64, 192)  # a full block or more: the KV directory has entries
# After the boots, a kill frees about one replica's share of the memory the
# replicas hold, and once the replacement is ready the total is back within
# FLEET_MEMORY_SLACK of one replica's share of where it was: a kill/replace
# cycle leaks no replica (its weights, pool and graphs).
FLEET_MEMORY_FREED = 0.8
FLEET_MEMORY_SLACK = 0.25
FLEET_LABEL = ("host-bound: 3-4 engines, their HTTP handlers, the router, the controller "
               "and the client threads share one Python process")


def fleet_margin_check(gpt_lib, model):
    """A chain_check for serve/fleet.py's smokes under the margin rule: a
    served chain that differs from the inline one stands if its first
    difference falls on a decision whose top-2 margin (the model's logits
    teacher-forced along the inline chain) is at most SERVE_MARGIN_ULPS
    bf16 ulps of the top logit."""
    def check(prompt, got, want):
        j = first_diff(got, want)
        if j is None and len(got) == len(want):
            return None
        if j is None or len(got) != len(want):
            return f"lengths {len(got)} and {len(want)}"
        chain = torch.tensor([want[:j + 1]], device="cuda")
        with torch.no_grad():
            logits = forced_logits(gpt_lib, model, chain)[0, j - 1]
        _, margin, bound = decisions(logits[None])[0].tolist()
        if margin <= bound:
            return None
        return (f"first differs at new token {j - len(prompt)}, top-2 margin {margin:.6g} "
                f"> {bound:.6g}")
    return check


def fleet_soak(gpt_lib, fleet_lib, cfg, weights, check, smi, label: str) -> dict:
    """One run_failover_soak at GPT-small (FLEET_* sizes, sustained load)
    and its checks beyond the soak's own: one kill, a failover recorded for
    each, the replacement booted (and captured) while streams were in
    flight, each engine's programs captured once, and the memory across
    the kill and the replacement (FLEET_MEMORY_FREED, FLEET_MEMORY_SLACK)."""
    free_device_memory()
    base = torch.cuda.memory_allocated()
    summary = fleet_lib.run_failover_soak(
        seed=FLEET_SEED, replicas=FLEET_REPLICAS, streams=FLEET_STREAMS, kills=1,
        max_new=FLEET_NEW, conn_faults=FLEET_CONN_FAULTS, namespace=f"soak-{label}", cfg=cfg,
        device="cuda", params=weights, slots=FLEET_SLOTS, prompt_len=FLEET_PROMPT,
        chain_check=check, sustain=True,
    )
    memory = [m["bytes"] for m in summary["memory_allocated"]]
    share = (memory[0] - base) / FLEET_REPLICAS
    problems = []
    if summary["kills"] != 1 or summary["failovers"] < 1:
        problems.append(f"kills {summary['kills']}, failovers {summary['failovers']}")
    if summary["boots"] != FLEET_REPLICAS + 1:
        problems.append(f"boots {summary['boots']}")
    replacement = summary["boot_log"][-1]
    if replacement["streams_in_flight"] < 1:
        problems.append(f"the replacement booted with no stream in flight: {replacement}")
    if any(c["step"] != 1 or c["prefill"] != 1 for c in summary["captures"]):
        problems.append(f"captures {summary['captures']}")
    if memory[0] - memory[1] < FLEET_MEMORY_FREED * share:
        problems.append(f"the kill freed {memory[0] - memory[1]} of a {share} share")
    if memory[2] - memory[0] > FLEET_MEMORY_SLACK * share:
        problems.append(f"after the replacement {memory[2]} against {memory[0]} (share {share})")
    report = {
        "phase": f"fleet_soak_{label}", "card": smi, "label": FLEET_LABEL,
        "model": f"GPT-small {label}", "replicas": FLEET_REPLICAS, "slots": FLEET_SLOTS,
        "clients": FLEET_STREAMS, "prompt": list(FLEET_PROMPT), "new": FLEET_NEW,
        **{k: summary[k] for k in (
            "streams", "kills", "conn_faults_injected", "failovers", "recorded_failovers",
            "boots", "near_ties", "seconds", "captures", "boot_log", "ttft_s", "itl_s")},
        "memory_allocated": summary["memory_allocated"], "memory_base": base,
        "replica_share_bytes": share, "problems": problems,
    }
    emit(report)
    if problems:
        raise AssertionError(f"fleet_soak_{label}: {problems}")
    return report


def rebinding_swap(self, params) -> None:
    """A planted ContinuousBatchingEngine.swap_params that loads the new
    weights by rebinding the module's tensors (load_state_dict(assign=True))
    instead of copying into them. The old tensors are kept alive, so the
    captured graphs go on reading the old weights."""
    state = {k: v.to(self.device, copy=True) for k, v in params.items()}
    self._rebound_from = dict(self.model.state_dict())
    self.model.load_state_dict(state, assign=True)
    if self._paged:
        self.pool.flush()


def run_fleet_update(gpt_lib, fleet_lib, engine_lib, v1, v2, smi) -> dict:
    """fleet_update: run_rolling_update at GPT-small bf16, v1 -> v2 with
    maxUnavailable 1 under FLEET_STREAMS client threads: each stream's
    chain the inline chain of the version it was admitted under (the
    margin rule against that version's model), no stream lost, each
    replica's programs captured once. Then the planted control: the same
    update with rebinding_swap in place of swap_params, which must fail
    the chain check (post-swap streams on the old weights)."""
    cfg = gpt_lib.GPT_SMALL
    models = {name: built_from(lambda: gpt_lib.GPT(cfg), w, "cuda")
              for name, w in (("v1", v1), ("v2", v2))}
    checks = {name: fleet_margin_check(gpt_lib, m) for name, m in models.items()}
    sizes = dict(cfg=cfg, device="cuda", params=v1, params2=v2, slots=FLEET_SLOTS,
                 prompt_len=FLEET_PROMPT, chain_check=checks)
    summary = fleet_lib.run_rolling_update(
        seed=FLEET_SEED, replicas=FLEET_REPLICAS, streams_per_wave=FLEET_STREAMS,
        max_new=FLEET_NEW, namespace="roll", **sizes)
    replicas, clients, new = FLEET_CONTROL
    swap = engine_lib.ContinuousBatchingEngine.swap_params
    engine_lib.ContinuousBatchingEngine.swap_params = rebinding_swap
    try:
        fleet_lib.run_rolling_update(seed=FLEET_SEED, replicas=replicas,
                                     streams_per_wave=clients, max_new=new,
                                     namespace="roll-control", **sizes)
        control = None
    except AssertionError as err:
        control = str(err)
    finally:
        engine_lib.ContinuousBatchingEngine.swap_params = swap
    del models
    report = {"phase": "fleet_update", "card": smi, "label": FLEET_LABEL,
              "model": "GPT-small bf16", "replicas": FLEET_REPLICAS, "slots": FLEET_SLOTS,
              "clients": FLEET_STREAMS, "new": FLEET_NEW, **summary,
              "rebinding_control": None if control is None else control[:600]}
    emit(report)
    if control is None or "admitted under v2" not in control:
        raise AssertionError(f"fleet_update: the rebinding swap passed the chain check: "
                             f"{control}")
    return report


def run_fleet_autoscale(gpt_lib, fleet_lib, weights, smi) -> dict:
    """fleet_autoscale: run_autoscale_smoke at GPT-small bf16 with the
    observatory scraped at the scaled-out point, the margin rule on every
    chain; then run_trace_smoke at GPT-small (one prefill and one decode
    replica, 64-token blocks): one migrated request's merged trace, fetched
    through the observatory, with all of HOP_NAMES."""
    from tf_operator_tpu_torch.telemetry.collector import HOP_NAMES

    cfg = gpt_lib.GPT_SMALL
    model = built_from(lambda: gpt_lib.GPT(cfg), weights, "cuda")
    summary = fleet_lib.run_autoscale_smoke(
        seed=FLEET_SEED, cfg=cfg, device="cuda", params=weights,
        chain_check=fleet_margin_check(gpt_lib, model), observe=True,
        prompt_len=FLEET_AUTOSCALE_PROMPT)
    del model
    emit({"phase": "fleet_autoscale", "card": smi, "label": FLEET_LABEL,
          "model": "GPT-small bf16", **summary})
    trace = fleet_lib.run_trace_smoke(seed=FLEET_SEED, cfg=cfg, device="cuda", params=weights,
                                      block_size=FLEET_BLOCK)
    hops = {tid: [h["name"] for h in trace["breakdowns"][tid]["hops"]]
            for tid in trace["migrated_traces"]}
    emit({"phase": "fleet_trace", "card": smi, "label": FLEET_LABEL, "model": "GPT-small bf16",
          **trace})
    if not hops or any(names != list(HOP_NAMES) for names in hops.values()):
        raise AssertionError(f"fleet_trace: hops {hops}")
    return {"autoscale": summary, "trace": trace}


def run_fleet_phases(kernels, smi) -> dict:
    """fleet_soak_bf16, fleet_soak_f32 (TF32 off, every chain bit-identical
    to inline generate), fleet_update and fleet_autoscale (with
    fleet_trace): serve/fleet.py's InProcessFleet under the port's
    ServeServiceController on its InMemorySubstrate, GPT-small replicas on
    cuda:0. No kernel of K1-K5 runs on this path: their counts stay 0."""
    from tf_operator_tpu_torch.models import gpt as gpt_lib
    from tf_operator_tpu_torch.serve import engine as engine_lib
    from tf_operator_tpu_torch.serve import fleet as fleet_lib

    kernels.reset_launches()
    cfg = gpt_lib.GPT_SMALL
    v1 = seeded_weights(gpt_lib.GPT, cfg, FLEET_SEED)
    v2 = seeded_weights(gpt_lib.GPT, cfg, FLEET_SEED + 1)
    model = built_from(lambda: gpt_lib.GPT(cfg), v1, "cuda")
    out = {"bf16": fleet_soak(gpt_lib, fleet_lib, cfg, v1, fleet_margin_check(gpt_lib, model),
                              smi, "bf16")}
    del model
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out["f32"] = fleet_soak(gpt_lib, fleet_lib, dataclasses.replace(cfg, dtype=torch.float32),
                                v1, None, smi, "f32")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
    if out["f32"]["near_ties"]:
        raise AssertionError(f"fleet_soak_f32: chains differ at {out['f32']['near_ties']}")
    free_device_memory()
    out["update"] = run_fleet_update(gpt_lib, fleet_lib, engine_lib, v1, v2, smi)
    free_device_memory()
    out["autoscale"] = run_fleet_autoscale(gpt_lib, fleet_lib, v1, smi)
    free_device_memory()
    if any(kernels.LAUNCHES.values()):
        raise AssertionError(f"the fleet launched a kernel of K1-K5: {kernels.LAUNCHES}")
    return out


def built_from(make, weights: dict, device):
    """make()'s model holding `weights` on `device`, built on the meta
    device: no random initialisation to pay on the host before the copy
    (the models here have no buffer outside their state dicts)."""
    with torch.device("meta"):
        model = make()
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    return model


_SEEDED: dict = {}


def seeded_weights(ctor, cfg, seed: int, **kw) -> dict:
    """The weights of ctor(cfg, generator=seed, **kw), drawn on the host
    once a process and kept (a draw of a full-width model takes seconds)."""
    key = (ctor.__qualname__, repr(cfg), seed)
    if key not in _SEEDED:
        model = ctor(cfg, generator=torch.Generator().manual_seed(seed), **kw)
        _SEEDED[key] = {k: v.detach() for k, v in model.state_dict().items()}
    return _SEEDED[key]


def seeded(ctor, cfg, seed: int, **kw):
    """A fresh ctor(cfg, **kw) on the host holding seeded_weights'
    values."""
    return built_from(lambda: ctor(cfg, **kw), seeded_weights(ctor, cfg, seed, **kw), "cpu")


def timed_group(seconds: dict, name: str, fn, *args, **kw):
    """fn(*args, **kw), its wall seconds kept under `name` and printed as
    a group_seconds line."""
    start = time.monotonic()
    out = fn(*args, **kw)
    seconds[name] = time.monotonic() - start
    emit({"phase": "group_seconds", "group": name, "seconds": seconds[name]})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs one CUDA card")
    import os
    import shutil
    import tempfile

    from tf_operator_tpu_torch.models import bert as bert_lib
    from tf_operator_tpu_torch.models import gpt as gpt_lib
    from tf_operator_tpu_torch.models import resnet as resnet_lib
    from tf_operator_tpu_torch.ops import conv_bn
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops import kernels
    from tf_operator_tpu_torch.train import bert as bert_cli
    from tf_operator_tpu_torch.train import gpt as gpt_cli
    from tf_operator_tpu_torch.train import mnist as mnist_cli
    from tf_operator_tpu_torch.train import resnet as resnet_cli
    from tf_operator_tpu_torch.train import trainer as trainer_lib

    script_start = time.monotonic()
    seconds: dict = {}
    smi = nvidia_smi()
    card = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": card, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    def build_and_kernels():
        start = time.monotonic()
        kernels.library()
        build_s = time.monotonic() - start
        ptxas = ptxas_summary(str(kernels.build_info.get("ptxas", "")))
        emit({"phase": "build", "seconds": build_s, "nvcc_seconds": kernels.build_info["seconds"],
              "compile_seconds": kernels.build_info.get("compile_seconds"),
              "sources": kernels.build_info.get("sources"),
              "library": kernels.build_info["path"], "ptxas": ptxas})
        worst = check_kernels(kernels, fa)
        return worst, time_kernels(kernels, fa, worst)

    worst, times = timed_group(seconds, "build_and_kernels", build_and_kernels)

    def bert():
        args = bert_cli.parse_args([
            "--preset", "base", "--steps", "6", "--batch-size", str(MAIN_SHAPE[0]),
            "--seq-len", str(MAIN_SHAPE[1]), "--flash", "--packed",
            "--weight-decay", "0.01", "--learning-rate", "1e-4", "--log-every", "1",
        ])
        kernels.reset_launches()
        summary = bert_cli.run(args)
        launches = dict(kernels.LAUNCHES)
        want = {
            "flash_fwd": LAYERS * summary["forward_passes"],
            "flash_bwd_dkv": LAYERS * summary["backward_passes"],
            "flash_bwd_dq": LAYERS * summary["backward_passes"],
            "conv3x3_fwd": 0, "conv3x3_dw": 0,
        }
        flop_per_token = model_flop_per_token(bert_lib.BERT_BASE, MAIN_SHAPE[1])
        emit({"phase": "train", "model": "BERT-base MLM", "batch": MAIN_SHAPE[0],
              "seq": MAIN_SHAPE[1], "card": smi, **summary,
              "model_flop_per_token": flop_per_token,
              "mfu": summary["tokens_per_sec"] * flop_per_token / PEAK_BF16_FLOPS,
              "launches": launches, "launches_expected": want})
        if launches != want:
            raise AssertionError(f"launches {launches} != expected {want}")
        for key in ("loss", "eval_loss", "tokens_per_sec"):
            if not math.isfinite(summary[key]) or summary[key] <= 0:
                raise AssertionError(f"train {key} = {summary[key]}")
        torch.cuda.empty_cache()
        # the same run through the plain attention path, for comparison
        plain = bert_cli.run(bert_cli.parse_args([
            "--preset", "base", "--steps", "6", "--batch-size", str(MAIN_SHAPE[0]),
            "--seq-len", str(MAIN_SHAPE[1]), "--packed", "--weight-decay", "0.01",
            "--learning-rate", "1e-4", "--log-every", "1",
        ]))
        emit({"phase": "train_plain", "card": smi, **plain,
              "mfu": plain["tokens_per_sec"] * flop_per_token / PEAK_BF16_FLOPS})
        torch.cuda.empty_cache()
        profile_step(bert_lib, trainer_lib, fa.flash_attention)
        torch.cuda.empty_cache()
        plain_parity(kernels, bert_lib, trainer_lib, fa.flash_attention)
        torch.cuda.empty_cache()
        return launches

    launches = timed_group(seconds, "bert", bert)
    gpt = timed_group(seconds, "gpt", run_gpt_phases, kernels, fa, gpt_lib, gpt_cli, trainer_lib,
                      smi)
    free_device_memory()
    # the lifecycle phase's GPT-small checkpoint stays here for export_serve
    lifecycle_dir = tempfile.mkdtemp(prefix="lifecycle-")
    try:
        timed_group(seconds, "lifecycle", run_lifecycle, kernels, gpt_lib, gpt_cli, trainer_lib,
                    smi, gpt["summary"], workdir=lifecycle_dir)
        free_device_memory()

        def conv_and_resnet():
            conv_worst = check_conv_kernels(kernels, conv_bn)
            conv_times = time_conv_kernels(kernels, conv_bn, conv_worst)
            resnet_launches = run_resnet(kernels, resnet_lib, resnet_cli, smi)
            for conv3_impl in ("pallas", "xla"):
                profile_resnet(resnet_lib, trainer_lib, conv3_impl)
                torch.cuda.empty_cache()
            resnet_parity(kernels, resnet_lib, trainer_lib)
            free_device_memory()
            return conv_worst, conv_times, resnet_launches

        conv_worst, conv_times, resnet_launches = timed_group(
            seconds, "conv_and_resnet", conv_and_resnet)
        per_replay = timed_group(seconds, "run_steps", run_steps_phases, kernels, bert_lib,
                                 resnet_lib, trainer_lib, fa.flash_attention, smi)

        def mnist_and_profile_dir():
            run_mnist_and_evaluator(mnist_cli, smi)
            run_profile_dir(bert_cli, smi)
            free_device_memory()

        timed_group(seconds, "mnist_and_profile_dir", mnist_and_profile_dir)
        world2 = timed_group(seconds, "distributed", run_distributed_phases, kernels, smi)
        mp = world2
        free_device_memory()
        timed_group(seconds, "model_parallel", run_model_parallel_phases, kernels, smi)
        free_device_memory()
        timed_group(seconds, "serve", run_serve, kernels, gpt_lib, smi)
        free_device_memory()
        timed_group(seconds, "decode_modes", run_decode_modes_phases, kernels, smi)
        free_device_memory()
        timed_group(seconds, "moe_vit", run_moe_vit_phases, kernels, smi)
        free_device_memory()
        timed_group(seconds, "observe", run_observe_phases, kernels, gpt_cli, smi, gpt["summary"])
        free_device_memory()
        timed_group(seconds, "disagg", run_disagg_phases, kernels, smi,
                    ckpt=os.path.join(lifecycle_dir, "ckpt"))
        free_device_memory()
        timed_group(seconds, "fleet", run_fleet_phases, kernels, smi)
        free_device_memory()
    finally:
        shutil.rmtree(lifecycle_dir, ignore_errors=True)
    emit({"phase": "script_seconds", "card": smi, "groups": seconds,
          "total": time.monotonic() - script_start})

    lines = [
        {
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": worst[name][0], "tolerance": worst[name][1],
            "ms": times[name]["ms"],
            "plain_ms": times[name]["plain_ms"], "bound_ms": times[name]["bound_ms"],
            "bound_by": times[name]["bound_by"], "library_ms": times[name]["library_ms"],
            "basis": "per launch at one BERT-base layer; launches over the train phase",
            "launches_per_replay": per_replay[name],
            "replay_basis": "run_steps' CUDA graph of one BERT-base step (32 x 512)",
            "launches_per_step_per_rank_world2": world2["ddp_bert"][name],
            "world2_basis": "ddp_bert: BERT-base under DDP, 2 ranks over gloo, 16 rows a rank",
            "launches_per_pass_per_rank_tp2": mp["tp2"][name],
            "launches_per_pass_per_rank_ulysses_sp2": mp["ulysses_sp2"][name],
            "launches_per_pass_per_rank_ring_sp2": mp["ring_sp2"][name],
            "model_parallel_basis": "tp_gpt and sp_gpt: GPT-small 2 x 4096 causal, 2 ranks "
                                    "over gloo on one card; tp 3 heads of 128 a rank, Ulysses "
                                    "3 heads at the full 4096, the ring (plain torch) none",
            "gpt": {
                "shape": list(GPT_SHAPE), "causal": True,
                "launches": gpt["launches"][name],
                "max_abs_err": gpt["worst"][name][0], "tolerance": gpt["worst"][name][1],
                "worst_row_rel_f32": {
                    out: gpt["rows"][out]["worst_row_rel"] for out in ROW_OUTPUTS[name]},
                "row_rtol": ROW_RTOL,
                **{k: gpt["times"][name][k] for k in (
                    "ms", "tflops", "bound_ms", "bound_by", "plain_ms", "library_ms")},
                "basis": "per launch at one GPT-small layer (causal); launches over "
                         "the gpt_train phase",
            },
        }
        for name in FLASH_KERNELS
    ]
    parts = {"conv3x3_fwd": ("fwd", "dx"), "conv3x3_dw": ("dw",)}
    for name in CONV_KERNELS:
        total = conv_times["totals"][name]
        lines.append({
            "name": name, "route": "cuda", "source": CONV_SOURCE,
            "replaces": REPLACES[name], "launches": resnet_launches[name],
            "max_abs_err": conv_worst[name][0], "tolerance": conv_worst[name][1],
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"], "bound_by": total["bound_by"],
            "library_ms": total["library_ms"],
            "basis": "per ResNet-50 training step at batch 256 (stage launches "
                     "3/3/5/2 per pass); launches over the resnet_train phase",
            "launches_per_replay": per_replay[name],
            "replay_basis": "run_steps' CUDA graph of one ResNet-50 step (batch 256)",
            "launches_per_step_per_rank_world2": world2["syncbn_resnet"][name],
            "world2_basis": "syncbn_resnet: ResNet-50 under DDP + sync BN, 2 ranks over "
                            "gloo, 128 images a rank",
            "per_stage": [
                {"shape": st["shape"], **{
                    part: {k: st[part][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                    "library_ms")}
                    for part in parts[name]
                }}
                for st in conv_times["stages"]
            ],
        })
    emit({"kernels": lines})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--world2-rank":
        sys.exit(world2_rank(sys.argv[2]))
    if len(sys.argv) == 4 and sys.argv[1] == "--world-rank":
        sys.exit(world_rank(sys.argv[2], sys.argv[3]))
    sys.exit(main())
