#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card, no options

Phases, each printing one JSON line (the script stops with a nonzero
exit at the first failure):

1. device + build: the card's name and power limit (nvidia-smi), then
   the CUDA kernels built from `src/repro_torch/kernels/csrc` with nvcc
   for sm_90a (the eight ports of the TPU kernels, split-KV decode's
   f32 combine, and the backwards of flash attention, the grouped
   matmul and the SSD intra-chunk scan), with ptxas's
   registers and spills of every head-dim
   instance of the bf16 flash, paged-prefill, paged-decode and split-KV
   decode kernels and of both designs of the bf16 flash backward
   (`tc_ptxas`; ptxas's warnings on wgmma or setmaxnreg in
   `wgmma_warnings`), of the bf16 SSD backward's column and row
   kernels (`ssd_bwd_ptxas`) and of the grouped backward's kernels
   (`grouped_bwd_ptxas`: dY's rounding, dX and dW on wgmma, f32); a
   spill in, or no report of, any instance of the flash, SSD or grouped
   backward fails the phase.
2. kernels: each paged-attention kernel against its plain PyTorch
   version on the card, at the dense path's shapes (hq 16, hkv 8, d
   128, page 16, batch 8, ragged positions up to 1023, 64 table
   columns; prefill chunks of 1, 7, 8 and 64 with ragged chunk lengths
   including 0, and of 5, the speculative verify window at k 4, with
   lengths 5 and 0), in bf16 and f32, with page_positions + POS_PAD holes +
   partials, and with int8 and fp8 pages, each output element within
   rtol |plain| + atol * max |plain row| (`repro_torch/kernels/
   tolerance.py`).  bf16 q with bf16 pages takes the tensor-core
   designs (decode: split over the KV length; each case names its
   design); bf16 decode (plain, and holes + partials) and prefill at c
   64 are also held at qwen3-moe-30b-a3b's width (hq 32, hkv 4),
   zamba2-2.7b's (hq 32, hkv 32, d 160), phi-3-vision-4.2b's (hq 32,
   hkv 32, d 96) and nemotron-4-340b's (hq 96, hkv 8, d 192).  The
   main-path cases (prefill
   at c 64 and at the verify window's c 5) are timed, and bf16 decode and prefill also at those two widths: kernel,
   plain version, one `scaled_dot_product_attention` call over the
   gathered K/V (a yardstick the port never calls) and the bound;
   decode also with its split rule, its grid's blocks and the blocks
   that walk pages.
3. moe/ssd kernels: the grouped matmul at qwen3-moe-30b-a3b's shapes
   (128 experts, K x F 2048 x 768 and 768 x 2048 at C 64, 2048 x 768 at
   C 4096, with the live rows of a random top-8 routing and without)
   and moonshot-v1-16b-a3b's (64 experts, top 6, 2048 x 1408 and 1408 x
   2048 at C 64, 2048 x 1408 at C 3072: F 1408 is not a multiple of the
   backward's 256-wide tile;
   bf16 with the routing's rows timed at all three, the bound counting
   the zero rows the function writes, beside a memset of the output;
   one MoE layer's dropless dispatch of a 512-token prompt timed beside
   the bytes its dense (E, T k, .) buffers move; the bf16 kernel's
   blocks per SM
   from the occupancy API, which must equal ops.py's mirror, and its
   ptxas registers and spills) and the SSD
   intra-chunk kernel at zamba2-2.7b's (640 batch*heads, p = n = 64,
   chunks of 64 and 256) and mamba2-130m's (24 heads, p 64, n 128, two
   chunks of 256, one ragged chunk of 200 and one of 5), and at one
   rank's share of the sharded training step on (1, 4) (mamba2-130m's 6
   heads a rank for 4 x 2048 tokens, zamba2's 512 positions a rank for
   4 rows), in bf16 and
   f32, against their plain versions by the same rule; timed beside
   one `torch.bmm` (grouped; SSD has no single PyTorch call) and the
   bound.  bf16 SSD runs the tensor-core design: each case's blocks
   (`ssd_scan/ops.py` `num_blocks`) and the kernel's ptxas registers
   and spills are printed, and one whole `ssd_chunked(impl="pallas")`
   call at zamba2's l 256 is timed beside the kernel, the layout
   copies around it and the "xla" impl.
4. contiguous kernels: split-KV decode at the contiguous decode shape
   (batch 8, S 1024, hq 16, hkv 8, d 128, positions spread up to 1023
   and one idle row past S), in bf16 (the tensor-core kernel, one
   launch) and f32 (the split kernel, then the combine kernel, also
   held alone), and in bf16 at the served widths above (qwen3, zamba2,
   phi-3-vision, nemotron), output and partials,
   bf16 also with NaN in every cache row past the positions (never
   read: the clean result); and the flash kernel at prompt lengths 5,
   200 and 511 (causal), one non-causal case and one with a q_offset,
   at 511 tokens at those widths, and non-causal at hubert-xlarge's
   training microbatch (4 x 2048 frames, 16 heads of 80), in bf16
   (tensor cores) and
   f32 (CUDA cores); all against their plain versions by the same
   rule.  Each bf16 case is timed beside one
   `scaled_dot_product_attention` call and the bound; bf16 split-KV
   decode also as partials (no merge) and at every position 0 (its
   floor), with its split rule, blocks and shared memory; the f32
   combine alone beside `combine_splits`.
4b. train kernels: the flash-attention backward (`flash_attention_bwd.cu`:
   dQ, dK, dV) against its plain version, each per element with atol
   scaled by the largest |plain| of its row, as the forward, plus a
   floor 1e-5 of its head's largest (`tolerance.grad_floor`), in bf16 (tensor cores) and f32 (CUDA cores), at internlm2-1.8b's
   heads for the training microbatch (4 x 2048, causal), a ragged 511
   (causal; with q_offset 511 over 1022 keys; non-causal at batch 2),
   qwen3-moe-30b-a3b's group (hq 32, hkv 4) at 2048, zamba2-2.7b's d
   160, nemotron-4-340b's group of 12 at d 192, hubert-xlarge's
   non-causal 16 heads of 80 and phi-3-vision-4.2b's causal 32 heads of
   96 at their training microbatches (4 x 2048), and one rank of a
   sequence-parallel step on (1, 4) (its 512 of 2048 positions at
   q_offset 512, 1024 and 1536 over the keys up to its block's end:
   yi-9b's group of 8 at d 128, zamba2-2.7b's shared block at d 160);
   the training forward's output bit-equal to the serving forward's and
   held, with its lse, against the plain one; a rerun of the backward
   bit-equal.  bf16
   cases are timed beside the plain backward, SDPA's backward (its
   forward + backward less its forward, K/V repeated) and the bound, the
   forward beside its plain version and its bound
   (2.5 x the forward's FLOPs over the pairs seen, or the bytes), each
   with its design (`bwd_design`: wgmma at d 64 to 192 here),
   group split, blocks and each pass timed alone (D, dK/dV, the
   split's reduce, dQ).  Then
   the grouped-matmul backward (`grouped_matmul_bwd.cu`: dY rounded
   once, then dX and dW on persistent wgmma kernels, whose blocks per SM
   from the card's occupancy API must equal ops.py's mirror) at
   qwen3-moe-30b-a3b's training microbatch (4,096 tokens, top-8 of 128
   experts, capacity 320; K x F 2048 x 768 and 768 x 2048, the live
   rows of a routing draw) and moonshot-v1-16b-a3b's (4,096 tokens,
   top-6 of 64, capacity 480; 2048 x 1408 and 1408 x 2048), and the
   SSD intra-chunk backward
   (`ssd_scan_bwd.cu`: dx, ddt, dA, dB, dC) at mamba2-130m's (96
   batch*heads, 8 chunks of 256, p 64, n 128) and zamba2-2.7b's (160,
   p = n = 64), and at the sharded step's rank shares (as in 3), bf16
   and f32, each per element against its plain
   version (the SSD's also against its f64 plain version) with a
   byte-identical rerun; bf16 timed beside the plain version, two
   `torch.bmm` (grouped) and the bound, the grouped backward also pass
   by pass (each launched alone) with its grid, work items and shared
   memory.
5. ws/os matmul kernels: the weight-stationary and output-stationary
   matmuls against their plain version at `tests/test_kernels.py`'s
   shapes in f32 and bf16 and at the four regimes of the dataflow sweep
   (`ws_dataflow.SWEEP`, m padded to 128, full width) in bf16, decode
   b=16 also in f32 and WS also with a 512-deep weight tile at both
   decode regimes, and at 640 x 1536 @ 1536 x 8448 with bk 96 and
   640 x 2560 @ 2560 x 8448 with the deepest tile WS takes (5 M tiles
   over 2 blocks), in f32 and bf16, by the same rule ((1e-4, 1e-4) f32,
   (1e-3, 1e-3) bf16); each bf16 regime timed beside one cuBLAS call
   (`torch.mm(x, w, out_dtype=torch.float32)`), the bound, the traffic
   model's WS and OS bytes at the blocks used, WS against its model
   bytes' time, OS's TFLOP/s, the blocks per SM (the occupancy API,
   which must equal ops.py's mirror) and WS at the splits beside the
   chosen one.  Then the dataflow sweep itself
   (`ws_dataflow.run(device="cuda")`), which must pass and launch each
   kernel once.
6. serve: `LLMServer` on internlm2-1.8b at full width and depth (bf16,
   seeded random weights): 8 prompts, one sampled, one stream forked
   after its first token; every stream finishes, no page leaks, each
   kernel launched 24 times per step call, and a second identical run
   gives byte-identical streams.
7. serve_spec: the same 8 prompts, the sampled row and the fork served
   speculatively (k 4) at full width and depth, once with the
   registry's paired draft (mamba2-130m at full width, vocab coerced to
   internlm2's) and once with the `self:1` draft (the target's first
   layer), the 5-token prompt pinned to plain decode beside the
   windows: every stream finishes, no page leaks, a byte-identical
   rerun, and the launches: paged prefill 24 per prefill call plus 24
   per verify call, paged decode 24 per plain decode call, split-KV
   decode once per draft decode step with `self:1` (one layer) and
   never with the mamba2 draft.  tokens/s, TTFT, the accept rate,
   windows, verify calls and the share of tokens equal to the serve
   phase's streams are printed (in bf16 the verify walk's logits round
   differently from decode's, so that share is not held).  Then
   serve_int8: internlm2-1.8b on an int8 page arena, 4 prompts of 16
   new tokens, held as the plain serve.
7b. serve_tier: internlm2-1.8b at full width and depth (bf16, page 16)
   through `LLMServer` with the persistent prefix cache and the host
   tier (run B: `prefix_cache=True`, `host_tier_pages` 512, watermark
   0.75, a pool of `TIER_POOL` pages, under which wave 1 preempts) and
   without (run A, the default pool): two waves of 8 prompts, each one
   seeded 256-token system prefix and a distinct suffix of 16-240
   tokens, 32 greedy new tokens, wave 2 after wave 1 retired and, in B,
   after the idle cache was flushed to the host tier.  Gates: B's
   streams equal A's; preemptions, tier spills, restores and
   prefetches, cold spills and restores and cross-request hits all
   above 0; B computes fewer prompt tokens; at the end the pool holds
   exactly the cached pages, pinned, and no sequence's parcel is left;
   the launches of both runs; a round trip of cached pages to pinned
   host memory and back through the prefetch path bit-exact.  Then the
   same on an int8 arena (2 prompts a wave, 16 new tokens; its scale
   leaves in the round trip).  Printed: the bytes spilled and restored,
   each kind of copy's seconds (CUDA events) and GB/s, the share of
   host-to-device time the prefetch took off the compute stream, the
   prompt tokens computed, wave 2's median TTFT, tokens/s and peak
   memory of A and B.
7c. serve_front: internlm2-1.8b at full width and depth (bf16, paged,
   page 16) behind the network front (`serve/frontend`
   `FrontendServer` on 127.0.0.1, an ephemeral port, max_batch 8,
   max_seq 1024, `tick_token_budget` 256, tenants alpha 3 and beta 1),
   driven over HTTP/SSE by `benchmarks/traffic_gen.py` `run`: the
   seeded trace of 24 requests over 3 s (14 Poisson chats of up to 256
   prompt and 24 new tokens, greedy or sampled; a burst of 6 at 1.5 s;
   a 512-token beta prompt; an alpha fanout of 3 streams over one
   socket; two beta streams dropped at their 3rd token).  Gates: every
   stream not aborted finished, fanout children included; 6 completed
   streams, greedy and sampled among them, replayed in process on the
   card after the server stopped, each equal to what crossed the wire;
   p99 TTFT finite for both tenants; after the drain allocated ==
   pinned pages, both aborts cancelled, the cancel-reclaim latency
   finite; no error frame, no failed tick, the engine thread gone
   after `stop()`; the launches; and the reference's saturation check
   at the same width (8 requests alternating tenants, 16-token prompts,
   12 new tokens, max_batch 4, `tick_token_budget` 16: alpha's mean
   finish step below beta's at equal token counts).  Printed: per
   tenant TTFT and TPOT p50/p99 and goodput under the 5 s TTFT SLO, the
   cancel-reclaim seconds, the trace's wall seconds and tokens/s, the
   front's and the engine's counters.
7b. serve_tools: the serving tools on the card.  (a) at the
   reference's tiny f32 configurations, `serve_throughput.run` with
   every family (dense at three batch/seq points; moe, hybrid, vlm),
   the sampling, quantized-arena, host-tier, prefix-trace and
   speculative (k 4, `self:1`) sweeps, on the tool's default weights
   (the port's seeded init, drawn on the card): every row's tokens identical
   across the layouts with paged KV <= contiguous, int8 pages <= 0.55x
   bf16 with identical tokens, spills and restores with identical
   tokens, cross-request prefix hits with fewer prompt tokens and
   identical tokens, sampled streams that replay and diverge from
   greedy, speculative streams identical greedy and sampled; every
   engine's launches equal `expected_launches` of its stats and it
   leaves no page but the cached ones (`EngineLedger`); the two timing
   verdicts (cached TTFT below cold, speculative tokens/s above plain)
   printed, not gated.  Then `paged_kernel_bench.run`: every row held
   (f32 at the reference's geometries by its allclose 1e-5, bf16 at
   internlm2-1.8b's width under `tolerance.py`), and the paged kernels
   with f32 queries over bf16 pages (the quantized sweep's bf16 arena)
   against their plain versions (decode and a 64-row prefill chunk at
   bf16's bound with at most `MAX_DIFFERENT_SHARE` of the elements
   differing, decode's partials at f32's bound).  (b) internlm2-1.8b at full width and
   depth through `_row` (8 prompts of 16-511 tokens from
   `default_rng(0)`, 32 new tokens, max_batch 8, max_seq 1024, page
   16): bf16 twice (paged peak KV <= contiguous, each layout's rerun
   byte-identical, the share of equal tokens between the layouts
   printed), then f32 (identical greedy tokens in both layouts), the
   launches held.  (c) `decode_many` at full width (bf16, contiguous,
   a 128-token prompt, 64 steps): greedy equal to the engine's stream
   at max_batch 1, flash launched once per layer and split-KV decode
   64 x 24 times, a sampled run (T 0.8, key 0) repeated identically
   and leaving the greedy tokens; its decode tokens/s beside the
   engine's decode ticks' (each from the first token on).
7d. serve_sharded: near-memory sharded serving, the UniMem arena cut
   into SHARDS banks (all on this card as separate allocations; one a
   card on a machine with as many).  First the kernel gate at
   internlm2-1.8b's width (hq 16, hkv 8, d 128, page 16, batch 8, a
   GLOBAL table over 4 banks with rotations 0-3 and one idle row): the
   decode, prefill c 64 and verify c 5 walks run per bank in partials
   mode on the compacted tables and merge through the combine kernel
   (`layers.run_paged_*_attention` under `mem_axis`), held per element
   against the plain version over the whole global table in bf16 and
   f32; each bank's partials-mode call at the compacted width, the
   combine alone and the whole banked layer are timed beside the
   single-arena kernel.  Then internlm2-1.8b at full width and depth
   (paged, page 16, max_batch 8, max_seq 1024) on `tools_stream`'s 8
   prompts of 16-511 tokens, 32 new: bf16 single arena and 4 banks in
   turns (tokens/s, the share of equal tokens printed; each bank's
   page bytes equal, at least 3 banks used, the pool drained, one
   prefill width, row 1, row 2 and the combine launched decode x
   layers x n, (prefill + verify) x layers x n and (decode + prefill +
   verify) x layers times), f32 (the 4-bank streams equal the single
   arena's), and an f32 run on a `SHARD_TIER` pool with a host tier:
   spills and restores, every restored sequence's pages on its
   rotation's banks, streams equal to the single arena's on the same
   pool.
8. spec_parity: a 2-layer internlm2-width f32 model: speculative
   streams (greedy and sampled rows, k 1 and 4, drafts `self:1` and
   `mamba2-130m@reduced`) equal the plain engine's on the card.
9. serve_moe: the same on qwen3-moe-30b-a3b (48 layers, 128 experts,
   `moe_dispatch="grouped"`): the grouped-matmul kernel launched 3 x 48
   times and each paged kernel 48 times per step call.
10. serve_hybrid: the same on zamba2-2.7b (54 Mamba-2 layers, 9 shared
   attention applications, `ssd_impl="pallas"`), with two identical
   prompts: the SSD kernel launched 54 times per prefill call, each
   paged kernel 9 times per step call.
11. serve_contiguous: internlm2-1.8b again with `layout="contiguous"`
   (no fork: the layout refuses it): the flash kernel launched 24 times
   per (batch=1) prefill call, the bf16 split-KV decode kernel 24 times
   per decode call and the combine kernel never.
12. serve_ssm: mamba2-130m at full width and depth (`ssd_impl="pallas"`,
   the ssm family's contiguous layout): the SSD kernel launched 24
   times per prefill call.
13. card vs CPU: a 2-layer internlm2-width, a 2-layer qwen3-width and a
   12-layer (two shared applications) zamba2-width f32 model, one paged
   prefill and one paged decode step on the card (kernels) and on the
   CPU (plain versions), logits, pages and state compared; and the
   contiguous prefill and decode steps of the 2-layer internlm2-width
   model (an idle row written past max_seq included; its launches
   counted from 0: flash 2 per prefill call, the f32 split-KV decode
   kernel and its combine kernel 2 each per decode call) and of a
   2-layer mamba2-width f32 model (prompts of 300 and 200 tokens: SSD
   chunks of 256 and a ragged 200), logits and cache compared.
13b. train_parity: a 2-layer internlm2-width model (remat "dots",
   logits_chunk 128), the loss and gradients of one training step
   (`make_grad_fn`) with grad_accum 2 over 4 x 256 MarkovLM tokens
   through the flash kernels, against the same with attention through
   `flash_attention_plain` (an oracle patched in for the comparison),
   f32 and bf16: the loss and every gradient leaf (relative L2) within
   `TRAIN_PARITY_TOL`.  train_parity_families: the same in f32 at 2
   layers of qwen3-moe-30b-a3b's width ("grouped" against the einsum
   experts of "scatter") and of mamba2-130m's ("pallas" against the
   torch SSD of "xla").
   train: internlm2-1.8b at full width and depth (bf16, AdamW at 3e-4,
   remat "dots", logits_chunk 512, 8 x 2048 MarkovLM tokens in 2
   microbatches): one warm-up and three timed steps (loss per step, its
   first near ln V + 0.02^2 d / 2, falling; grad norm, step seconds,
   tokens/s, peak memory), a checkpoint of the state (host snapshot and
   write timed), one step under torch.profiler (the device's busy
   share and its top kernels), the state restored from the checkpoint and that step again
   with the same loss; the flash forward launched 2 x 24 x 2 per step
   (the "dots" remat recomputes attention) and the backward 24 x 2.
   train mamba2-130m (24 layers, `ssd_impl="pallas"`, 8 x 2048 tokens
   in 2 microbatches), train qwen3-moe-30b-a3b (full width, 4 of 48
   layers, `moe_dispatch="grouped"`, 4 x 2048 tokens in 2
   microbatches) and train zamba2-2.7b (full width, 18 of 54 layers,
   8 x 2048 tokens in 4 microbatches), bf16, AdamW, remat "full": eight steps (the first
   loss near ln V + 0.02^2 d / 2, plus the router losses for MoE; step
   seconds, tokens/s, peak memory), one profiled step (busy share; the
   port's kernels' device time, the grouped backward's also by pass:
   dY's rounding, dX, dW), a
   held-out batch's loss lower after the steps than before them, and
   the launches of the nine steps: per microbatch and layer the SSD
   kernel twice and its backward once, or the grouped matmul 3 x 2 and
   its backward 3, flash 2 and its backward 1.
13d. train_sharded: sharded training in one world of 4 ranks sharing
   the card (`repro_torch/benchmarks/train_sharded.py`;
   gloo process groups: NCCL refuses two ranks on one GPU; the kernels
   built before the ranks start): internlm2-1.8b at full width, 4 layers, bf16, on a
   (2, 2) = data x model mesh (FSDP over data; heads, MLP columns and
   the vocab over model), 8 x 2048 tokens, 3 steps of AdamW, against the
   single-rank step on the same seeded weights and batches (each step's
   loss and every leaf after step 1 within `SHARDED_BF16_TOL`); the same
   at f32 and 2 layers, grad_accum 2, within the reference test's own
   bounds; qwen3-moe-30b-a3b at full width, 2 layers, f32, on (1, 4)
   under "ep" (32 resident experts a rank, a capacity that drops
   nothing): the loss and every gradient against the single-rank
   "grouped" step (`SHARDED_MOE_TOL`); the flash forward and backward
   and the grouped matmul and its backward launched on every rank as
   counted (`train_sharded.expected_launches`); the int8 ring over the 4
   ranks under 0.02 of the exact sum; GPipe over 4 stages and 6
   microbatches equal to the sequential forward; an elastic restart
   (a reduced internlm2 saved at step 2 on (2, 2), restored on (4, 1) and
   on one rank) whose losses continue the uninterrupted run's; and the
   layouts the reference's constraints resolve to, each under its
   config's rules on (1, 4) against the single rank: yi-9b at full
   width, 2 layers, sequence parallel (4 x 2048 bf16, 2 steps, within
   `SHARDED_BF16_TOL`; 4 x 256 f32 gradients),
   zamba2-2.7b at full width, 12 layers (both shared blocks), sequence
   parallel, bf16 gradients (`train_sharded.SSM_BF16_*`), mamba2-130m
   at full width and depth with its heads split, bf16 gradients (each
   leaf no farther from the f32 gradients than `SSM_BF16_F32_RATIO`
   times the single rank's) and f32 gradients; yi-9b's f32 case and
   mamba2-130m's are gradients within `SHARDED_MOE_TOL`; every rank launching rows 4, 4b, 6 and 6b as counted, and
   each case's trunk cut (or not) as its rules say.  A
   `train_sharded_layout` line per case gives step seconds sharded and
   single, peak memory a rank, bytes per collective, rank 0's launches
   and the constraint sites its forward logged and checked.  It
   prints the transport (gloo; which primitives took CUDA tensors; the
   messages staged through host memory), the bytes each collective moved
   in a step, the step seconds of the sharded and the single-rank runs
   and each rank's peak memory.  A failing rank, or a world past
   `SHARDED_TIMEOUT`, fails the phase.
13c. serve_vlm: phi-3-vision-4.2b at full width and depth (bf16,
   paged, 32 layers), the 8 prompts each behind its own seeded image
   of 576 patch rows (max_seq 1152 holds 576 + 511 + 32), one sampled,
   one forked: every stream finishes, no page leaks, a byte-identical
   rerun, each paged kernel 32 times per step call; then its 2-layer
   f32 paged prefill, a chunk crossing from the image rows into the
   text, and decode, card against CPU.  serve_configs: 4 prompts of 16
   new tokens, paged, bf16, held as serve: yi-9b (48 layers),
   moonshot-v1-16b-a3b (48 layers, 64 experts top 6, grouped dispatch),
   deepseek-67b at 40 of its 95 layers and nemotron-4-340b at 4 of its
   96 (their weights do not fit 80 GB; `SERVE_CONFIGS`).
   train_encoder: hubert-xlarge at full width and depth (48 layers,
   non-causal flash forward and backward at d 80, bf16, AdamW, remat
   "full", 8 x 2048 frames of `SyntheticFrames` in 2 microbatches):
   its labels are random, so every step trains on one batch, whose
   loss must fall.  train_vlm: phi-3-vision-4.2b at full width and
   depth (32 layers; 8 x (576 image rows + 1472 MarkovLM tokens) in 2
   microbatches): the held-out loss must fall.  Both as the family train phases (step
   seconds, positions/s, peak memory, busy share, launches).
13e. xla_tools: the port's XLA tools on the card, each reading a trace
   of the port's own step (`repro_torch/launch/trace.py`; the kernels'
   counts set to 0 before the phase and read after it).  (a) Structure
   gates at `HLO_PROBE_GEOM` and at the serving geometry (internlm2-1.8b
   full width, bf16, batch 8, page 16, max_seq 1024): the traced paged
   decode and prefill calls (`serve_step.lowered_paged_hlo`, traced
   after a warm-up call, which grows the decode split scratch) hold no
   `bulk_attn_shapes` buffer and do hold each layer's kernel launch and
   its output; nothing is copied back to the host and no value is read
   off the card (tokens, not logits, leave the step; the host-to-card copies in are printed); the forced
   plain route
   (`plain_paged_kernels`, the explicit oracle) shows the gather.
   (b) Card records (`launch/dryrun.py run_cell`, mesh "one"): decode
   (8 rows against a 1024-token cache) and prefill (8 x 512) at full
   depth and a 4-layer train step (8 x 2048): step seconds (CUDA
   events), peak memory, the profiler's top kernels, each kernel launch
   with its own FLOPs, and the roofline row against the H100 with its
   MFU.  (c) The sharded gate on 4 banks of the card: every cross-bank
   move (`collectives.hand`) is summary-sized, the combine kernel merges
   every layer; then `serve_throughput.attention_hlo` on the card (the
   record `--json` writes): the plain route's bulk bytes above 0, the
   kernel route's 0.  After the phase the card holds no more than
   `XLA_HELD_LIMIT` bytes beyond what it held before: no trace keeps its
   step's tensors alive.  (d) One production-mesh dry-run on "meta": yi-9b
   x train_4k x single, rank 0's sharded step on dry collectives, with
   its seconds.
14. paper: every paper module of the port's harness
   (`repro_torch.benchmarks.run`: Tables I-VII, ResNet-50 on Sunrise,
   the dataflow sweep on the card) passes, the ws and os kernels each
   launched once (by the sweep's check) and no other kernel.
15. resnet50: ResNet-50 at full width and depth (224 x 224, bf16,
   seeded weights) at batch 1 and 8: images per second from CUDA
   events (three rounds), the device's busy time and kernels per
   forward from torch.profiler, and peak memory; and the card against
   the CPU in f32 at batch 1, logits within 5e-4 of the largest |logit|.

A "total" line gives the run's seconds and the launches of the serve
phases of this last group.  The line before the last is the kernels'
JSON record; the last line is {"ok": true, "device": {...}}.  Without a CUDA device, or without the
repository's `src/` beside it, the script exits nonzero and prints no
result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
ROOT = Path(__file__).resolve().parent
# (arch, hq, hkv, head_dim) of the served widths the paged decode,
# paged prefill, split-KV decode and flash kernels are also held and
# timed at, beside internlm2-1.8b's (16, 8, 128): phi-3-vision-4.2b's
# group of 1 at d 96 and nemotron-4-340b's group of 12 at d 192 too
PREFILL_WIDTHS = (("qwen3-moe-30b-a3b", 32, 4, 128),
                  ("zamba2-2.7b", 32, 32, 160),
                  ("phi-3-vision-4.2b", 32, 32, 96),
                  ("nemotron-4-340b", 96, 8, 192))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# ------------------------------------------------------------- timing

def time_ms(fn, flush, iters: int = 30, warmup: int = 5) -> float:
    """Median of `iters` CUDA-event timings of fn(), each after an L2
    flush (the serving step finds attention's pages cold: other layers'
    weights pass through L2 in between)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ----------------------------------------------------- phase 2: kernels

class KernelBench:
    """Main-path geometry and arenas for the kernel phase."""

    def __init__(self, torch, dev, hq=16, hkv=8, d=128):
        self.torch = torch
        self.dev = dev
        self.b, self.hq, self.hkv, self.d, self.page, self.mp = 8, hq, hkv, d, 16, 64
        g = torch.Generator(device="cpu").manual_seed(0)
        self.P = self.b * self.mp                       # pages; null = P
        perm = torch.randperm(self.P, generator=g).to(torch.int32)
        self.bt = perm.view(self.b, self.mp).to(dev)
        self.positions = torch.tensor([1023, 0, 511, 17, 700, 64, 255, 999],
                                      dtype=torch.int32, device=dev)
        # past each row's last live page the table points at the null page
        live = self.positions // self.page + 1
        cols = torch.arange(self.mp, device=dev)[None, :]
        self.bt = torch.where(cols < live[:, None].long(), self.bt,
                              torch.full_like(self.bt, self.P)).contiguous()
        shape = (self.P + 1, self.page, self.hkv, self.d)
        self.kf = torch.randn(shape, generator=g).to(dev)
        self.vf = torch.randn(shape, generator=g).to(dev)
        self.gen = g
        self.flush_buf = torch.empty(64 << 20, dtype=torch.int32, device=dev)

    def flush(self):
        self.flush_buf.zero_()

    def pages(self, dtype):
        """K/V pages (+ scales) in `dtype` (float32, bfloat16, int8, fp8)."""
        torch = self.torch
        from repro_torch.core.unimem import quantize_kv
        if dtype in (torch.int8, torch.float8_e4m3fn):
            qk, sk = quantize_kv(self.kf, dtype)
            qv, sv = quantize_kv(self.vf, dtype)
            return qk, qv, sk.contiguous(), sv.contiguous()
        return self.kf.to(dtype), self.vf.to(dtype), None, None

    def holes(self):
        """A compacted table: every other live page of each row, at its
        true position, POS_PAD in the holes (a sharded walk's shape)."""
        torch = self.torch
        from repro_torch.kernels.paged_attention.ops import POS_PAD
        cols = torch.arange(self.mp, device=self.dev, dtype=torch.int32)
        ppos = (cols * self.page)[None, :].expand(self.b, self.mp).clone()
        ppos[:, 1::2] = POS_PAD
        return ppos.contiguous()

    def q(self, shape, dtype):
        return self.torch.randn(shape, generator=self.gen).to(self.dev).to(dtype)


def check(name, got, want, qdt, rows, floor=None):
    """Hold a kernel's output against its plain version's, element by
    element (repro_torch.kernels.tolerance, with the flash backward's
    `grad_floor` as `floor`); returns the max abs error."""
    from repro_torch.kernels.tolerance import (GRAD_FLOOR, TOLERANCE,
                                               worst_ratio)
    rtol, atol = TOLERANCE[qdt]
    err, ratio = worst_ratio(got, want, rtol, atol, floor=floor)
    rows.append({"case": name, "max_abs_err": err, "rtol": rtol,
                 "atol_x_row_max": atol, "worst_err_over_bound": ratio})
    if floor is not None:
        rows[-1]["floor_x_head_max"] = GRAD_FLOOR
    if not ratio <= 1.0:
        emit({"phase": "kernels", "failed": rows[-1]})
        fail(f"kernel {name} disagrees with its plain version: "
             f"err / bound {ratio}")
    return err


def phase_kernels(torch, dev, card: str):
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_prefill import ops as pp

    kb = KernelBench(torch, dev)
    b, hq, hkv, d, page = kb.b, kb.hq, kb.hkv, kb.d, kb.page
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []
    results = {}

    # the other served widths: qwen3-moe-30b-a3b and zamba2-2.7b
    wide = {arch: KernelBench(torch, dev, hq=hq_a, hkv=hkv_a, d=d_a)
            for arch, hq_a, hkv_a, d_a in PREFILL_WIDTHS}

    # ---------------------------------------------------------- decode
    # bf16 q with bf16 pages takes the tensor-core design (split over the
    # KV length, one launch), every other pair the CUDA-core one
    # (paged_attention/ops.py `route`)
    for qdt, kvdt, mode in ((bf16, bf16, "plain"), (f32, f32, "plain"),
                            (bf16, bf16, "holes+partials"),
                            (f32, f32, "holes+partials"),
                            (bf16, torch.int8, "plain"),
                            (f32, torch.int8, "plain"),
                            (bf16, torch.float8_e4m3fn, "plain"),
                            (bf16, torch.float8_e4m3fn, "holes+partials")):
        kp, vp, ks, vs = kb.pages(kvdt)
        q = kb.q((b, hq, d), qdt)
        kw = dict(k_scale=ks, v_scale=vs)
        if mode != "plain":
            kw.update(page_positions=kb.holes(), partials=True)
        got = pa.paged_decode_attention(q, kp, vp, kb.bt, kb.positions, **kw)
        want = pa.paged_decode_attention_plain(q, kp, vp, kb.bt,
                                               kb.positions, **kw)
        torch.cuda.synchronize()
        name = f"decode {qdt} q, {kvdt} pages, {mode} ({pa.route(qdt, kvdt)})"
        err = check(name, got, want, qdt, rows)
        if (qdt, kvdt, mode) == (bf16, bf16, "plain"):
            results["decode"] = dict(kb=kb, q=q, kp=kp, vp=vp, err=err)
    for arch, kba in wide.items():
        kp, vp, _, _ = kba.pages(bf16)
        q = kba.q((b, kba.hq, kba.d), bf16)
        for mode in ("plain", "holes+partials"):
            kw = ({} if mode == "plain"
                  else dict(page_positions=kba.holes(), partials=True))
            got = pa.paged_decode_attention(q, kp, vp, kba.bt, kba.positions,
                                            **kw)
            want = pa.paged_decode_attention_plain(q, kp, vp, kba.bt,
                                                   kba.positions, **kw)
            torch.cuda.synchronize()
            name = (f"decode {bf16} q, {bf16} pages, {mode}, {arch} (hq "
                    f"{kba.hq}, hkv {kba.hkv}, d {kba.d}) "
                    f"({pa.route(bf16, bf16)})")
            err = check(name, got, want, bf16, rows)
            if mode == "plain":
                results[f"decode {arch}"] = dict(kb=kba, q=q, kp=kp, vp=vp,
                                                 err=err)

    # ---------------------------------------------------------- prefill
    # bf16 q with bf16 pages takes the tensor-core design, every other
    # pair the CUDA-core one (paged_prefill/ops.py `route`)
    # c 5 is the speculative verify window (k 4): live rows carry the
    # whole window, rows that do not speculate carry 0
    clen_for = {1: [1, 0, 1, 1, 1, 0, 1, 1],
                5: [5, 5, 0, 5, 5, 0, 5, 5],
                7: [7, 3, 0, 7, 1, 7, 5, 2],
                8: [8, 2, 0, 8, 5, 1, 8, 3],
                64: [64, 17, 0, 64, 33, 1, 64, 40]}
    start = torch.tensor([959, 0, 448, 0, 600, 63, 191, 900],
                         dtype=torch.int32, device=dev)
    for c, qdt, kvdt, mode in ((1, bf16, bf16, "plain"),
                               (5, bf16, bf16, "plain"),
                               (5, bf16, bf16, "holes+partials"),
                               (7, bf16, bf16, "plain"),
                               (8, bf16, bf16, "plain"),
                               (64, bf16, bf16, "plain"),
                               (64, bf16, bf16, "holes+partials"),
                               (64, f32, f32, "plain"),
                               (7, bf16, bf16, "holes+partials"),
                               (64, f32, f32, "holes+partials"),
                               (7, bf16, torch.int8, "plain"),
                               (64, f32, torch.int8, "plain"),
                               (7, bf16, torch.float8_e4m3fn, "plain"),
                               (7, f32, torch.float8_e4m3fn,
                                "holes+partials")):
        kp, vp, ks, vs = kb.pages(kvdt)
        clen = torch.tensor(clen_for[c], dtype=torch.int32, device=dev)
        q = kb.q((b, c, hq, d), qdt)
        kw = dict(k_scale=ks, v_scale=vs)
        if mode != "plain":
            kw.update(page_positions=kb.holes(), partials=True)
        got = pp.paged_prefill_attention(q, kp, vp, kb.bt, start, clen, **kw)
        want = pp.paged_prefill_attention_plain(q, kp, vp, kb.bt, start,
                                                clen, **kw)
        torch.cuda.synchronize()
        name = (f"prefill c={c} {qdt} q, {kvdt} pages, {mode} "
                f"({pp.route(qdt, kvdt)})")
        err = check(name, got, want, qdt, rows)
        if (c, qdt, kvdt, mode) == (64, bf16, bf16, "plain"):
            results["prefill"] = dict(kb=kb, q=q, kp=kp, vp=vp, clen=clen,
                                      err=err)
        if (c, qdt, kvdt, mode) == (5, bf16, bf16, "plain"):
            results["prefill verify"] = dict(kb=kb, q=q, kp=kp, vp=vp,
                                             clen=clen, err=err)
    # the other served widths, c 64, bf16: qwen3-moe-30b-a3b and zamba2-2.7b
    clen = torch.tensor(clen_for[64], dtype=torch.int32, device=dev)
    for arch, hq_a, hkv_a, d_a in PREFILL_WIDTHS:
        kba = wide[arch]
        kp, vp, _, _ = kba.pages(bf16)
        q = kba.q((b, 64, hq_a, d_a), bf16)
        got = pp.paged_prefill_attention(q, kp, vp, kba.bt, start, clen)
        want = pp.paged_prefill_attention_plain(q, kp, vp, kba.bt, start,
                                                clen)
        torch.cuda.synchronize()
        name = (f"prefill c=64 {bf16} q, {bf16} pages, plain, {arch} "
                f"(hq {hq_a}, hkv {hkv_a}, d {d_a})")
        err = check(name, got, want, bf16, rows)
        results[f"prefill {arch}"] = dict(kb=kba, q=q, kp=kp, vp=vp,
                                          clen=clen, err=err)
    emit({"phase": "kernels", "cases": rows})

    # ------------------------------------------- timing, main-path case
    elt = 2                                          # bf16 bytes
    timings = {}
    kv_pos = torch.arange(kb.mp * page, device=dev)

    def sdpa_inputs(kbx, qq, kp, vp, c):
        """q, K and V gathered and repeated over the query group, (b, h,
        s, d): the SDPA yardstick's inputs."""
        S = kbx.mp * kbx.page
        bt_l = kbx.bt.long()
        g = kbx.hq // kbx.hkv
        k = kp[bt_l].reshape(b, S, kbx.hkv, kbx.d)
        v = vp[bt_l].reshape(b, S, kbx.hkv, kbx.d)
        k = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
        v = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
        return (qq.reshape(b, c, kbx.hq, kbx.d).transpose(1, 2).contiguous(),
                k, v)

    def decode_timing(dec):
        """Kernel, plain version and SDPA over the gathered K/V at one
        width; the bytes are the live K/V of every row, q, out, the
        walked table entries and the positions.  Beside them the bf16
        design's split rule and its blocks: all of the grid, and those
        that walk pages (a split wholly past its row's position exits);
        and the kernel's floor, the same call with every row at
        position 0 (one token, one split, no merge)."""
        kbx = dec["kb"]
        live = kbx.positions.long() + 1
        pages = (live + page - 1) // page
        nbytes = (2 * int(live.sum()) * kbx.hkv * kbx.d * elt
                  + 2 * b * kbx.hq * kbx.d * elt + 4 * int(pages.sum()) + 4 * b)
        qs, ks, vs = sdpa_inputs(kbx, dec["q"], dec["kp"], dec["vp"], 1)
        mask = (kv_pos[None, :] <= kbx.positions[:, None].long())[:, None,
                                                                  None, :]
        args = (dec["q"], dec["kp"], dec["vp"], kbx.bt, kbx.positions)
        first = (*args[:4], torch.zeros_like(kbx.positions))
        pps = pa.split_pages(page)
        splits = pa.num_splits(kbx.mp, page)
        return dict(
            ms=time_ms(lambda: pa.paged_decode_attention(*args), kbx.flush),
            plain_ms=time_ms(lambda: pa.paged_decode_attention_plain(*args),
                             kbx.flush),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask), kbx.flush),
            bytes=nbytes, ops=4 * kbx.hq * kbx.d * int(live.sum()),
            max_abs_err=dec["err"],
            split_rule=(f"split_pages = max(1, {pa.SPLIT_TOKENS} // page) = "
                        f"{pps} pages; splits = ceil(max_pages / split_pages) "
                        f"= {splits}; grid (b * hkv, splits)"),
            blocks=b * kbx.hkv * splits,
            live_blocks=kbx.hkv * int(((pages + pps - 1) // pps).sum()),
            floor_ms=time_ms(lambda: pa.paged_decode_attention(*first),
                             kbx.flush))

    timings["paged_decode_attention"] = decode_timing(results["decode"])
    for arch, *_ in PREFILL_WIDTHS:
        timings[f"paged_decode_attention {arch}"] = decode_timing(
            results[f"decode {arch}"])

    def prefill_timing(pre, c=64):
        """Kernel, plain version and SDPA over the gathered K/V at one
        width; the bytes are the live K/V (each visible token once), q
        and out, the walked table entries and start/chunk_len."""
        kbx, q, kp, vp = pre["kb"], pre["q"], pre["kp"], pre["vp"]
        clen = pre["clen"].long()
        st = start.long()
        need = torch.where(clen > 0, st + clen, torch.zeros_like(st))
        vis = sum(int(st[i]) * int(clen[i])
                  + int(clen[i]) * (int(clen[i]) + 1) // 2
                  for i in range(b))                 # visible (query, key) pairs
        nbytes = (2 * int(need.sum()) * kbx.hkv * kbx.d * elt
                  + 2 * b * c * kbx.hq * kbx.d * elt
                  + 4 * int(((need + page - 1) // page).sum()) + 8 * b)
        qs, ks, vs = sdpa_inputs(kbx, q, kp, vp, c)
        qpos = st[:, None] + torch.arange(c, device=dev)[None, :]
        mask = ((kv_pos[None, None, :] <= qpos[:, :, None])
                & (torch.arange(c, device=dev)[None, :, None]
                   < clen[:, None, None]))[:, None]
        args = (q, kp, vp, kbx.bt, start, pre["clen"])
        return dict(
            ms=time_ms(lambda: pp.paged_prefill_attention(*args), kbx.flush),
            plain_ms=time_ms(lambda: pp.paged_prefill_attention_plain(*args),
                             kbx.flush),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask), kbx.flush),
            bytes=nbytes, ops=4 * kbx.hq * kbx.d * vis,
            max_abs_err=pre["err"])

    timings["paged_prefill_attention"] = prefill_timing(results["prefill"])
    timings["paged_prefill_attention verify c=5"] = prefill_timing(
        results["prefill verify"], c=5)
    for arch, *_ in PREFILL_WIDTHS:
        timings[f"paged_prefill_attention {arch}"] = prefill_timing(
            results[f"prefill {arch}"])
    for name, t in timings.items():
        t["bound_ms"] = 1e3 * max(t["bytes"] / HBM_BYTES_PER_S,
                                  t["ops"] / PEAK_OPS["bfloat16"])
        t["bound_by"] = ("bytes" if t["bytes"] / HBM_BYTES_PER_S
                         >= t["ops"] / PEAK_OPS["bfloat16"] else "operations")
    emit({"phase": "kernel_times", "card": card, "dtype": "bfloat16",
          "shapes": {"b": b, "hq": hq, "hkv": hkv, "d": d, "page": page,
                     "max_pages": kb.mp, "prefill_c": 64,
                     "widths": {a: {"hq": x, "hkv": y, "d": z}
                                for a, x, y, z in PREFILL_WIDTHS}},
          "timing": "CUDA events, median of 30 after 5 warm-up, L2 flushed",
          **{k: {kk: vv for kk, vv in v.items()} for k, v in timings.items()}})
    return timings


# ------------------------------------------- phase 3: moe/ssd kernels

def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least time in ms, what bounds it) on this card's bf16 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["bfloat16"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def routed_rows(torch, E: int, tokens: int, k: int, gen):
    """Per-expert row counts of `tokens` tokens each routed to k distinct
    experts uniformly at random (the dropless dispatch's counts)."""
    choice = torch.rand(tokens, E, generator=gen).argsort(-1)[:, :k]
    return torch.bincount(choice.reshape(-1), minlength=E).to(torch.int32)


# (arch, experts, top-k, C, K, F) of the grouped matmul's cases:
# qwen3-moe-30b-a3b's gate/up and down at C 64 and its gate/up at C 4096
# (keys without the arch), and moonshot-v1-16b-a3b's (64 experts, top 6,
# F 1408: 22 of the kernel's 64-wide n tiles, 5.5 of the backward's
# 256-wide ones) at C 64 and a 512-token prompt's dropless C 3072
GROUPED_CASES = (("", 128, 8, 64, 2048, 768), ("", 128, 8, 64, 768, 2048),
                 ("", 128, 8, 4096, 2048, 768),
                 ("moonshot-v1-16b-a3b", 64, 6, 64, 2048, 1408),
                 ("moonshot-v1-16b-a3b", 64, 6, 64, 1408, 2048),
                 ("moonshot-v1-16b-a3b", 64, 6, 3072, 2048, 1408))


def phase_moe_ssd_kernels(torch, dev, card: str, flush):
    from repro_torch.kernels.grouped_matmul import ops as gm
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.tolerance import worst_ratio

    gen = torch.Generator(device="cpu").manual_seed(5)
    gdev = torch.Generator(device=dev).manual_seed(6)
    bf16, f32 = torch.bfloat16, torch.float32
    rows_out, times = [], {}

    def hold(name, got, want, tol):
        err, ratio = worst_ratio(got, want, *tol)
        rows_out.append({"case": name, "max_abs_err": err, "rtol": tol[0],
                         "atol_x_row_max": tol[1],
                         "worst_err_over_bound": ratio})
        if not ratio <= 1.0:
            emit({"phase": "moe_ssd_kernels", "failed": rows_out[-1]})
            fail(f"kernel {name} disagrees with its plain version: "
                 f"err / bound {ratio}")
        return err

    # ---------------------------------------------------- grouped matmul
    D, FF = 2048, 768                    # qwen3-moe-30b-a3b's
    for arch, E, k, C, K, F in GROUPED_CASES:
        rows = routed_rows(torch, E, C // k, k, gen).to(dev)
        live = (torch.arange(C, device=dev)[None, :]
                < rows[:, None].long())[..., None]
        x32 = torch.randn(E, C, K, generator=gdev, device=dev) * live
        w32 = torch.randn(E, K, F, generator=gdev, device=dev) * 0.02
        for dt in (bf16, f32):
            x, w = x32.to(dt), w32.to(dt)
            for r in (rows, None):
                got = gm.grouped_matmul(x, w, r)
                want = gm.grouped_matmul_plain(x, w, r)
                torch.cuda.synchronize()
                name = (f"grouped E{E} top{k} C{C} K{K} F{F} {dt} "
                        f"{'rows' if r is not None else 'all rows'}")
                err = hold(name, got, want, gm.TOLERANCE[dt])
                del got, want
                if dt is not bf16 or r is None:
                    continue
                # timed: bf16 with the routing's live rows.  The bound
                # counts the live experts' weights, the live x rows and
                # the whole f32 output, whose rows past each expert's
                # count the function must write as zeros
                n_live = int(rows.sum())
                experts = int((rows > 0).sum())
                nbytes = 2 * experts * K * F + 2 * n_live * K + 4 * E * C * F
                ms, by = bound(nbytes, 2 * n_live * K * F)
                rr = r
                key = (f"grouped_matmul C{C}" + (" down" if K < F else "")
                       + (f" {arch}" if arch else ""))
                zeros = torch.empty(E, C, F, device=dev)
                times[key] = dict(
                    ms=time_ms(lambda: gm.grouped_matmul(x, w, rr), flush),
                    plain_ms=time_ms(lambda: gm.grouped_matmul_plain(x, w, rr),
                                     flush, iters=10),
                    library_ms=time_ms(lambda: torch.bmm(x, w), flush),
                    bound_ms=ms, bound_by=by, max_abs_err=err,
                    live_rows=n_live, live_experts=experts,
                    zero_row_bytes=4 * (E * C - n_live) * F,
                    # a memset of the whole (E, C, F) f32 output: what
                    # writing it costs on this card without any product
                    zero_fill_ms=time_ms(zeros.zero_, flush))
                del zeros
            del x, w
    # ---------------------------------- one MoE layer's dead rows, prefill
    # qwen3's dropless dispatch of one 512-token prompt (C = T * k =
    # 4096, ~99 % of the (E, C, .) rows dead), timed on the card beside
    # the bytes its dense buffers move: the zeroed bf16 buffer; the gate
    # and up products' f32 outputs; silu_ and mul_ over them; h cast to
    # bf16; the down product's f32 output and its cast; the weights
    from repro_torch.configs import get_arch
    from repro_torch.models import moe as PM
    E, k = 128, 8
    cfg = get_arch("qwen3-moe-30b-a3b").model.replace(moe_dispatch="grouped")
    T = 512
    params = PM.moe_block_init(torch.Generator(device=dev).manual_seed(7),
                               cfg, dev)
    xf = torch.randn(T, D, generator=gdev, device=dev).to(cfg.compute_dtype)
    Cn = T * k
    h32, y32 = 4 * E * Cn * FF, 4 * E * Cn * D
    layer_bytes = {"zeroed buffer": 2 * E * Cn * D,
                   "gate and up outputs": 2 * h32, "silu_": 2 * h32,
                   "mul_": 3 * h32, "h to bf16": h32 + h32 // 2,
                   "down output": y32, "down output to bf16": y32 + y32 // 2,
                   "weights": 3 * 2 * E * D * FF}
    total = sum(layer_bytes.values())
    times["moe_layer prefill T512"] = dict(
        ms=time_ms(lambda: PM._moe_scatter(
            params, cfg, xf, experts_fn=PM.experts_apply_grouped), flush,
            iters=10),
        bytes=layer_bytes, total_bytes=total,
        byte_ms=1e3 * total / HBM_BYTES_PER_S)
    del params, xf
    # ------------------------------------------------------------- SSD
    # zamba2-2.7b (batch 8 x 80 heads, p = n = 64) and mamba2-130m (one
    # prompt x 24 heads, p 64, n 128), at the chunk lengths their served
    # prompts give: a full chunk of 256 (two of them for the 333- and
    # 511-token prompts), a ragged 200-token chunk and a 5-token one
    ssd_cases = (("zamba2", 8, 80, 1, 64, 64, 64),
                 ("zamba2", 8, 80, 1, 256, 64, 64),
                 ("mamba2", 1, 24, 2, 256, 64, 128),
                 ("mamba2", 1, 24, 1, 200, 64, 128),
                 ("mamba2", 1, 24, 1, 5, 64, 128),
                 # one rank's share in the sharded training step on (1,
                 # 4): mamba2-130m's 6 heads for 4 x 2048 tokens, and
                 # zamba2's 512 of 2048 positions for 4 rows
                 ("mamba2 heads a rank", 4, 6, 8, 256, 64, 128),
                 ("zamba2 seq a rank", 4, 80, 2, 256, 64, 64))
    ssd_blocks = {}
    for arch, batch, heads, nc, l, p, n in ssd_cases:
        bh = batch * heads
        x32 = torch.randn(bh, nc, l, p, generator=gdev, device=dev)
        B32 = torch.randn(bh, nc, l, n, generator=gdev, device=dev) * 0.3
        C32 = torch.randn(bh, nc, l, n, generator=gdev, device=dev) * 0.3
        dt_ = torch.rand(bh, nc, l, generator=gdev, device=dev) * 0.1
        A = (-torch.linspace(1.0, 16.0, heads, device=dev)).repeat(batch)
        for dt in (bf16, f32):
            args = (x32.to(dt), dt_, A, B32.to(dt), C32.to(dt))
            got = ssd.ssd_intra_chunk(*args)
            want = ssd.ssd_intra_chunk_plain(*args)
            torch.cuda.synchronize()
            errs = [hold(f"ssd {arch} bh{bh} nc{nc} l{l} p{p} n{n} {dt} "
                         f"{part}", g, w_, ssd.TOLERANCE[dt])
                    for part, g, w_ in zip(("y", "s", "cd"), got, want)]
            if dt is bf16:
                ssd_blocks[f"{arch} bh{bh} nc{nc} l{l}"] = ssd.num_blocks(
                    dt, bh, nc, l, n)
            if dt is not bf16 or (arch, l) not in (
                    ("zamba2", 64), ("zamba2", 256), ("mamba2", 256),
                    ("mamba2 heads a rank", 256), ("zamba2 seq a rank", 256)):
                continue
            # x, B, C in bf16, dt and A in f32 in; y, s, cd in f32 out
            rows_ = bh * nc
            nbytes = (2 * rows_ * l * (p + 2 * n) + 4 * (rows_ * l + bh)
                      + 4 * (rows_ * l * p + rows_ * n * p + rows_))
            pairs = l * (l + 1) // 2
            ops = rows_ * (2 * pairs * (n + p) + 2 * l * n * p)
            ms, by = bound(nbytes, ops)
            key = (f"ssd_intra_chunk l{l}" if arch == "zamba2"
                   else f"ssd_intra_chunk {arch} nc{nc} l{l}")
            times[key] = dict(
                ms=time_ms(lambda: ssd.ssd_intra_chunk(*args), flush),
                plain_ms=time_ms(lambda: ssd.ssd_intra_chunk_plain(*args),
                                 flush),
                library_ms=None, bound_ms=ms, bound_by=by,
                max_abs_err=max(errs), bh=bh, nc=nc, p=p, n=n,
                blocks=ssd.num_blocks(dt, bh, nc, l, n))
    times["ssd_chunked zamba2 l256"] = ssd_chunked_times(
        torch, dev, flush, gdev, times["ssd_intra_chunk l256"]["ms"])
    blocks = gm.launched_blocks_per_sm(True, dev)
    if blocks != gm.blocks_per_sm():
        fail(f"grouped bf16 kernel: {blocks} blocks per SM on the card, "
             f"ops.py's mirror says {gm.blocks_per_sm()}")
    from repro_torch.kernels import build as kbuild
    emit({"phase": "moe_ssd_kernels", "cases": rows_out})
    emit({"phase": "moe_ssd_kernel_times", "card": card, "dtype": "bfloat16",
          "shapes": {"grouped": {"E": E, "top_k": k, "d_model": D,
                                 "moe_d_ff": FF,
                                 "cases (arch, E, top_k, C, K, F)":
                                     GROUPED_CASES},
                     "ssd": "bh, nc, p and n in each case"},
          "grouped_bf16": {"blocks_per_sm": blocks,
                           "grid_c64": gm.grid(E, 64, FF),
                           "ptxas": grouped_ptxas(
                               kbuild.library().compiler_log)},
          "ssd_bf16": {"blocks": ssd_blocks,
                       "smem_bytes": {"p64 n64": ssd.tc_smem_bytes(64, 64),
                                      "p64 n128": ssd.tc_smem_bytes(64, 128)},
                       "ptxas": ssd_ptxas(kbuild.library().compiler_log)},
          "library": {"grouped": "one torch.bmm over the same (E, C, K) and "
                                 "(E, K, F), every row",
                      "ssd": "none: no single PyTorch call computes it"},
          "timing": "CUDA events, median of 30 (plain grouped: 10) after 5 "
                    "warm-up, L2 flushed", **times})
    return times


def ssd_chunked_times(torch, dev, flush, gdev, kernel_ms: float) -> dict:
    """One whole `ssd_chunked(impl="pallas")` call at zamba2-2.7b's
    prefill of 8 prompts of one 256-token chunk (80 heads, p = n = 64,
    bf16), beside the kernel's time and the layout copies around it
    (models/mamba2.py: x, B, C and dt into (b*h, nc, l, .) order, y and
    s back, to x's dtype), timed alone as the model makes them."""
    from repro_torch.models.mamba2 import ssd_chunked
    b, s_, h, p, n = 8, 256, 80, 64, 64
    bf16 = torch.bfloat16
    x = torch.randn(b, s_, h, p, generator=gdev, device=dev).to(bf16)
    B = (torch.randn(b, s_, h, n, generator=gdev, device=dev) * 0.3).to(bf16)
    C = (torch.randn(b, s_, h, n, generator=gdev, device=dev) * 0.3).to(bf16)
    dt = torch.rand(b, s_, h, generator=gdev, device=dev) * 0.1
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    yk = torch.empty(b * h, 1, s_, p, device=dev)
    sk = torch.empty(b * h, 1, n, p, device=dev)

    def to_bh(a):
        return a.reshape((b, 1, s_) + tuple(a.shape[2:])).movedim(3, 1) \
            .reshape((b * h, 1, s_) + tuple(a.shape[3:])).contiguous()

    def copies():
        to_bh(x), to_bh(B), to_bh(C), to_bh(dt)
        yk.reshape(b, h, 1, s_, p).movedim(1, 3).to(bf16)
        sk.reshape(b, h, 1, n, p).transpose(-1, -2).movedim(1, 2).to(bf16)

    return dict(
        ms=time_ms(lambda: ssd_chunked(x, dt, A, B, C, s_, impl="pallas"),
                   flush),
        kernel_ms=kernel_ms, layout_copies_ms=time_ms(copies, flush),
        xla_ms=time_ms(lambda: ssd_chunked(x, dt, A, B, C, s_, impl="xla"),
                       flush),
        shape={"b": b, "s": s_, "h": h, "p": p, "n": n, "chunk": s_})


# ------------------------------------------ phase 4: contiguous kernels

def phase_contig_kernels(torch, dev, card: str, flush):
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as dk
    from repro_torch.kernels.flash_attention import ops as fk

    g = torch.Generator(device=dev).manual_seed(11)
    bf16, f32 = torch.bfloat16, torch.float32
    rows, times = [], {}

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    # ------------------------------------------------ split-KV decode
    # bf16 takes the tensor-core kernel (one launch, the splits merged
    # inside it), f32 the split kernel and the combine kernel
    b, S = 8, 1024
    positions = torch.tensor([1023, 0, 511, 17, 700, 64, 255, 1500],
                             dtype=torch.int32, device=dev)
    live = torch.clamp(positions.long(), max=S - 1) + 1
    n_live = int(live.sum())
    unread = (torch.arange(S, device=dev)[None, :]
              >= live[:, None])[:, :, None, None]            # (b, S, 1, 1)
    for width, hq, hkv, d in (("", 16, 8, 128),
                              *((f" {a}", x, y, z)
                                for a, x, y, z in PREFILL_WIDTHS)):
        q32, k32, v32 = (randn(b, hq, d), randn(b, S, hkv, d),
                         randn(b, S, hkv, d))
        for dt in (bf16, f32) if not width else (bf16,):
            q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
            got = dk.decode_attention(q, k, v, positions)
            want = dk.decode_attention_plain(q, k, v, positions)
            gp = dk.decode_partials(q, k, v, positions)
            wp = dk.decode_partials_plain(q, k, v, positions)
            torch.cuda.synchronize()
            name = (f"split-KV decode b{b} S{S}{width} (hq {hq}, hkv {hkv}, "
                    f"d {d}) {dt} ({dk.route(dt)})")
            err = check(name, got, want, dt, rows)
            check(name + " partials", gp, wp, dt, rows)
            if dt is f32:
                # the combine kernel alone, against its plain version on
                # the split kernel's own summaries
                cargs = (*gp, b, hq, d, dt)
                cerr = check(name + " combine",
                             dk.combine_splits_kernel(*cargs),
                             dk.combine_splits(*cargs), dt, rows)
                # summaries (m, l, acc) read once, out written once; 2
                # f32 flops per acc element
                n_acc = gp[2].numel()
                t_b = (4 * (2 * gp[0].numel() + n_acc) + 4 * b * hq * d
                       ) / HBM_BYTES_PER_S
                t_o = 2 * n_acc / PEAK_OPS["float32"]
                c_ms = 1e3 * max(t_b, t_o)
                c_by = "bytes" if t_b >= t_o else "operations"
                times["combine_splits"] = dict(
                    ms=time_ms(lambda: dk.combine_splits_kernel(*cargs),
                               flush),
                    plain_ms=time_ms(lambda: dk.combine_splits(*cargs),
                                     flush),
                    library_ms=None, bound_ms=c_ms, bound_by=c_by,
                    max_abs_err=cerr, dtype="float32",
                    split_and_combine_ms=time_ms(
                        lambda: dk.decode_attention(q, k, v, positions),
                        flush))
                continue
            # NaN in every cache row past each position: never read, so
            # the result is the clean one
            kn, vn = (t.masked_fill(unread, float("nan")) for t in (k, v))
            check(name + ", NaN past the positions",
                  dk.decode_attention(q, kn, vn, positions), want, dt, rows)
            del kn, vn
            nbytes = 2 * 2 * n_live * hkv * d + 2 * 2 * b * hq * d + 4 * b
            ms, by = bound(nbytes, 4 * hq * d * n_live)
            # SDPA over the whole cache, kv heads repeated beforehand
            qs = q.reshape(b, 1, hq, d).transpose(1, 2).contiguous()
            ks = k.repeat_interleave(hq // hkv, 2).transpose(1, 2).contiguous()
            vs = v.repeat_interleave(hq // hkv, 2).transpose(1, 2).contiguous()
            mask = (torch.arange(S, device=dev)[None, :]
                    <= positions[:, None].long())[:, None, None, :]
            first = torch.zeros_like(positions)
            L = dk.split_len(S, 8)
            times[f"decode_attention{width}"] = dict(
                ms=time_ms(lambda: dk.decode_attention(q, k, v, positions),
                           flush),
                # the same kernel writing every split's summary, no merge
                kernel_only_ms=time_ms(lambda: dk.decode_partials(
                    q, k, v, positions), flush),
                plain_ms=time_ms(lambda: dk.decode_attention_plain(
                    q, k, v, positions), flush),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask), flush),
                # every row at position 0: one row, one split, no merge
                floor_ms=time_ms(lambda: dk.decode_attention(
                    q, k, v, first), flush),
                bound_ms=ms, bound_by=by, max_abs_err=err, live_rows=n_live,
                design=dk.route(dt),
                split_rule=f"kv_splits 8, split_len ceil(S / 8) = {L}; "
                           f"grid (b * hkv, 8)",
                blocks=b * hkv * 8,
                live_blocks=hkv * int(((live + L - 1) // L).sum()),
                smem_bytes=dk.tc_smem_bytes(d, 8))
            del qs, ks, vs
    # ---------------------------------------------------------- flash
    # internlm2-1.8b's heads (hq 16, hkv 8, d 128), then a 511-token
    # prompt at the other served widths (PREFILL_WIDTHS)
    flash_cases = [(1, 5, 5, True, 0, 16, 8, 128, ""),
                   (1, 200, 200, True, 0, 16, 8, 128, ""),
                   (1, 511, 511, True, 0, 16, 8, 128, ""),
                   (2, 100, 130, False, 0, 16, 8, 128, ""),
                   (1, 64, 300, True, 236, 16, 8, 128, "")]
    flash_cases += [(1, 511, 511, True, 0, hq_a, hkv_a, d_a, f" {arch}")
                    for arch, hq_a, hkv_a, d_a in PREFILL_WIDTHS]
    # hubert-xlarge's encoder: non-causal over its training microbatch
    # (4 x 2048 frames, 16 heads of 80)
    flash_cases += [(4, 2048, 2048, False, 0, 16, 16, 80, " hubert-xlarge")]
    for b, sq, skv, causal, off, hq, hkv, d, width in flash_cases:
        q32, k32, v32 = (randn(b, sq, hq, d), randn(b, skv, hkv, d),
                         randn(b, skv, hkv, d))
        for dt in (bf16, f32):
            q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
            kw = dict(causal=causal, q_offset=off)
            got = fk.flash_attention(q, k, v, **kw)
            want = fk.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            name = (f"flash b{b} sq{sq} skv{skv} {'causal' if causal else 'full'}"
                    f" q_offset {off}{width} (hq {hq}, hkv {hkv}, d {d}) {dt}"
                    f" ({fk.route(dt)})")
            err = check(name, got, want, dt, rows)
            if dt is not bf16:
                continue
            qi = torch.arange(sq)[:, None] + off
            seen = ((torch.arange(skv)[None, :] <= qi) if causal
                    else torch.ones(sq, skv, dtype=torch.bool))
            pairs = b * int(seen.sum())
            nbytes = 2 * (2 * b * sq * hq * d + 2 * b * skv * hkv * d)
            ms, by = bound(nbytes, 4 * hq * d * pairs)
            qs = q.transpose(1, 2).contiguous()
            ks = k.repeat_interleave(hq // hkv, 2).transpose(1, 2).contiguous()
            vs = v.repeat_interleave(hq // hkv, 2).transpose(1, 2).contiguous()
            sd_mask = seen.to(dev)[None, None] if causal and off else None
            sd_causal = causal and not off
            times[f"flash_attention sq{sq} skv{skv}"
                  f"{'' if causal else ' full'}{f' off{off}' if off else ''}"
                  f"{width}"] = dict(
                ms=time_ms(lambda: fk.flash_attention(q, k, v, **kw), flush),
                plain_ms=time_ms(lambda: fk.flash_attention_plain(
                    q, k, v, **kw), flush),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=sd_mask, is_causal=sd_causal),
                    flush),
                bound_ms=ms, bound_by=by, max_abs_err=err,
                design=fk.route(dt))
    emit({"phase": "contig_kernels", "cases": rows})
    emit({"phase": "contig_kernel_times", "card": card, "dtype": "bfloat16",
          "library": "one scaled_dot_product_attention call, kv heads "
                     "repeated beforehand (decode: over the whole cache "
                     "with a mask); the combine has none",
          "timing": "CUDA events, median of 30 after 5 warm-up, L2 flushed",
          **times})
    return times


# ------------------------------------- phase 4b: the flash backward kernel

# (b, sq, skv, hq, hkv, d, causal, q_offset, label): internlm2-1.8b's
# heads at the training microbatch (4 x 2048) and at a ragged 511, once
# with a q_offset and once non-causal, qwen3-moe-30b-a3b's group (the
# bf16 design splits its walk over blocks), and past head dim 128 (a dK/dV
# tile takes a dV block and a dK block): zamba2-2.7b's shared attention at
# its training microbatch (2 x 2048, 32 heads of 160) and
# nemotron-4-340b's group (96 query heads over 8, d 192); hubert-xlarge's
# non-causal encoder at its training microbatch (4 x 2048 frames, 16
# heads of 80) and phi-3-vision-4.2b's at its (4 x 2048 positions, 32
# heads of 96)
TRAIN_FLASH_CASES = (
    (4, 2048, 2048, 16, 8, 128, True, 0, "train"),
    (1, 511, 511, 16, 8, 128, True, 0, "511"),
    (1, 511, 1022, 16, 8, 128, True, 511, "511 off511"),
    (2, 511, 511, 16, 8, 128, False, 0, "511 full"),
    (1, 2048, 2048, 32, 4, 128, True, 0, "qwen3-moe-30b-a3b group"),
    (2, 2048, 2048, 32, 32, 160, True, 0, "zamba2-2.7b train"),
    (1, 2048, 2048, 96, 8, 192, True, 0, "nemotron-4-340b group"),
    (4, 2048, 2048, 16, 16, 80, False, 0, "hubert-xlarge train"),
    (4, 2048, 2048, 32, 32, 96, True, 0, "phi-3-vision-4.2b train"),
    # a rank of a sequence-parallel step on (1, 4): its 512 of 2048
    # positions at q_offset r x 512 over the keys of [0, (r + 1) x 512)
    (4, 512, 1024, 32, 4, 128, True, 512, "yi-9b seq rank 1"),
    (4, 512, 1536, 32, 4, 128, True, 1024, "yi-9b seq rank 2"),
    (4, 512, 2048, 32, 4, 128, True, 1536, "yi-9b seq rank 3"),
    (4, 512, 2048, 32, 32, 160, True, 1536, "zamba2-2.7b seq rank 3"),
)


def seen_pairs(b, sq, skv, causal, off) -> int:
    """The (query, key) pairs attention computes: under the diagonal
    (queries at q_offset off) when causal."""
    import torch
    qi = torch.arange(sq)[:, None] + off
    return b * int(((torch.arange(skv)[None, :] <= qi) if causal
                    else torch.ones(sq, skv, dtype=torch.bool)).sum())


def bwd_bound(b, sq, skv, hq, hkv, d, causal, off, itemsize):
    """(ms, what bounds it) of the backward: 2.5 x the forward's FLOPs
    (4 hq d per (query, key) pair seen; causal counts the pairs under
    the diagonal, so it is halved) over the bf16 peak, or q, k, v, o,
    dO and lse read and dq, dk, dv written over the memory rate."""
    pairs = seen_pairs(b, sq, skv, causal, off)
    q_el, kv_el = b * sq * hq * d, b * skv * hkv * d
    nbytes = itemsize * (3 * q_el + 2 * kv_el) + 4 * b * hq * sq \
        + itemsize * (q_el + 2 * kv_el)
    return bound(nbytes, 2.5 * 4 * hq * d * pairs)


def phase_train_kernels(torch, dev, card: str, flush):
    """The flash backward against its plain version (dQ, dK, dV, held per
    row with the floor `tolerance.grad_floor`) in bf16 and f32, and the
    training forward (with lse) against the serving forward's bits and
    the plain lse; bf16 timed beside the plain backward and SDPA's
    backward (its forward + backward less its forward)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fk
    from repro_torch.kernels.tolerance import grad_floor

    free_card(torch)
    g = torch.Generator(device=dev).manual_seed(24)
    rows, times = [], {}
    bf16, f32 = torch.bfloat16, torch.float32
    for b, sq, skv, hq, hkv, d, causal, off, label in TRAIN_FLASH_CASES:
        shapes = ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
                  (b, sq, hq, d))
        base = [torch.randn(*s, generator=g, device=dev) for s in shapes]
        kw = dict(causal=causal, q_offset=off)
        for dt in (bf16, f32):
            q, k, v, do = (x.to(dt) for x in base)
            o, lse = fk.flash_attention_lse(q, k, v, **kw)
            if not torch.equal(o, fk.flash_attention(q, k, v, **kw)):
                fail(f"flash forward with lse ({label}, {dt}) differs from "
                     f"the serving forward")
            po, plse = fk.flash_attention_lse_plain(q, k, v, **kw)
            fwd_err = check(f"flash forward ({label}, {dt})", o, po, dt,
                            rows)
            got = fk.flash_attention_backward(q, k, v, o, do, lse, **kw)
            want = fk.flash_attention_backward_plain(q, k, v, po, do, plse,
                                                     **kw)
            torch.cuda.synchronize()
            name = (f"flash backward b{b} sq{sq} skv{skv} "
                    f"{'causal' if causal else 'full'} q_offset {off} "
                    f"(hq {hq}, hkv {hkv}, d {d}) {dt} ({fk.route(dt)})")
            check(name + " lse", lse, plse, f32, rows)
            err = check(name, got, want, dt, rows, floor=grad_floor)
            again = fk.flash_attention_backward(q, k, v, o, do, lse, **kw)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"{name}: a rerun gives other bits")
            del got, want, again, po, plse
            if dt is not bf16:
                continue
            ms, by = bwd_bound(b, sq, skv, hq, hkv, d, causal, off, 2)
            # q, k, v read and o written once; 4 hq d per pair seen
            f_ms, f_by = bound(
                2 * (2 * b * sq * hq * d + 2 * b * skv * hkv * d),
                4 * hq * d * seen_pairs(b, sq, skv, causal, off))
            # SDPA over K/V repeated over the group, (b, h, s, d)
            qs = q.transpose(1, 2).contiguous().requires_grad_()
            ks = k.repeat_interleave(hq // hkv, 2).transpose(1, 2) \
                .contiguous().requires_grad_()
            vs = v.repeat_interleave(hq // hkv, 2).transpose(1, 2) \
                .contiguous().requires_grad_()
            dos = do.transpose(1, 2).contiguous()
            qi = torch.arange(sq, device=dev)[:, None] + off
            mask = (torch.arange(skv, device=dev)[None, :] <= qi) \
                if causal and off else None
            sd = dict(attn_mask=mask, is_causal=causal and not off)

            def sdpa_fwd():
                return F.scaled_dot_product_attention(qs, ks, vs, **sd)

            def sdpa_fwd_bwd():
                return torch.autograd.grad(sdpa_fwd(), (qs, ks, vs), dos)
            full_ms = time_ms(sdpa_fwd_bwd, flush, iters=10, warmup=2)
            fwd_ms = time_ms(sdpa_fwd, flush, iters=10, warmup=2)
            passes, splits = fk.backward_pass_timer(q, k, v, o, do, lse, **kw)
            times[f"flash_attention_backward {label}"] = dict(
                ms=time_ms(lambda: fk.flash_attention_backward(
                    q, k, v, o, do, lse, **kw), flush, iters=10, warmup=2),
                forward_ms=time_ms(lambda: fk.flash_attention_lse(
                    q, k, v, **kw), flush, iters=10, warmup=2),
                forward_plain_ms=time_ms(lambda: fk.flash_attention_lse_plain(
                    q, k, v, **kw), flush, iters=3, warmup=1),
                forward_bound_ms=f_ms, forward_bound_by=f_by,
                forward_max_abs_err=fwd_err,
                plain_ms=time_ms(lambda: fk.flash_attention_backward_plain(
                    q, k, v, o, do, lse, **kw), flush, iters=3, warmup=1),
                library_ms=full_ms - fwd_ms, library_fwd_bwd_ms=full_ms,
                library_fwd_ms=fwd_ms, bound_ms=ms, bound_by=by,
                max_abs_err=err, design=fk.bwd_design(d),
                passes_ms={name: time_ms(fn, flush, iters=10, warmup=2)
                           for name, fn in passes.items()},
                splits=splits,
                blocks=fk.bwd_blocks(b, sq, skv, hq, hkv, d, splits),
                smem_bytes=fk.bwd_smem_bytes(dt, d))
            del qs, ks, vs, dos, passes
        del base
    free_card(torch)
    times.update(family_backward_kernels(torch, dev, flush, rows))
    emit({"phase": "train_kernels", "cases": rows})
    emit({"phase": "train_kernel_times", "card": card, "dtype": "bfloat16",
          "library": {"flash": "SDPA forward + backward less SDPA forward, "
                               "K/V repeated over the group beforehand",
                      "grouped": "two torch.bmm calls (dX = dY W^T, dW = "
                                 "X^T dY) over every row, dY in bf16",
                      "ssd": "none: no single PyTorch call computes it"},
          "timing": "CUDA events, median of 10 after 2 warm-up (plain: "
                    "3 after 1; a flash or grouped backward's passes_ms: "
                    "each pass launched alone into one call's buffers), L2 "
                    "flushed",
          **times})
    return times


# qwen3-moe-30b-a3b's training microbatch (2 x 2048 tokens, top-8 of 128
# experts, capacity ceil(4096 x 8 / 128 x 1.25) = 320): (K, F) of the
# gate/up and the down products
TRAIN_MOE_TOKENS, TRAIN_MOE_CAPACITY = 4096, 320
GROUPED_BWD_CASES = ((2048, 768, "gate/up"), (768, 2048, "down"))
# moonshot-v1-16b-a3b's at the same 4096 tokens (top-6 of 64 experts,
# capacity ceil(4096 x 6 / 64 x 1.25) = 480): F 1408 is 5.5 of the
# backward's 256-wide output tiles (dW of gate/up, dX of down)
MOONSHOT_BWD = (64, 6, 480, ((2048, 1408, "moonshot-v1-16b-a3b gate/up"),
                             (1408, 2048, "moonshot-v1-16b-a3b down")))
# (label, bh, heads, nc, l, p, n): mamba2-130m's training microbatch (4 x
# 2048 tokens, 24 heads, chunks of 256, p 64, n 128) and zamba2-2.7b's
# heads (80, p = n = 64) for 2 x 2048 tokens; then one rank's share in
# the sharded step on (1, 4): mamba2-130m's 6 heads (its heads split)
# and zamba2's 512 of 2048 positions (sequence parallel)
SSD_BWD_CASES = (("mamba2-130m", 96, 24, 8, 256, 64, 128),
                 ("zamba2-2.7b", 160, 80, 8, 256, 64, 64),
                 ("mamba2-130m heads a rank", 24, 6, 8, 256, 64, 128),
                 ("zamba2-2.7b seq a rank", 320, 80, 2, 256, 64, 64))


def family_backward_kernels(torch, dev, flush, rows) -> dict:
    """The grouped-matmul backward (dX, dW) at qwen3's training shapes,
    with each expert's live rows from a routing draw capped at the
    capacity, and the SSD intra-chunk backward (dx, ddt, dA, dB, dC) at
    mamba2-130m's and zamba2's, each against its plain version per
    element (`check`; grouped bf16 with `bf16_rounding` added, SSD by
    `ssd_scan/ops.py` BWD_TOLERANCE in both dtypes) with a
    byte-identical rerun; bf16 timed beside the plain
    version, the library call (grouped: two torch.bmm) and the bound,
    the grouped backward also pass by pass (the rounding of dY, dX, dW,
    each launched alone), with its persistent grid, work items and
    shared memory, after its kernels' occupancy is held to ops.py's
    mirror."""
    from repro_torch.kernels.grouped_matmul import ops as gm
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.tolerance import worst_ratio

    def hold(name, got, want, tol, floor=None):
        err, ratio = worst_ratio(got, want, *tol, floor=floor)
        rows.append({"case": name, "max_abs_err": err, "rtol": tol[0],
                     "atol_x_row_max": tol[1], "worst_err_over_bound": ratio})
        if not ratio <= 1.0:
            emit({"phase": "train_kernels", "failed": rows[-1]})
            fail(f"kernel {name} disagrees with its plain version: "
                 f"err / bound {ratio}")
        return err

    times = {}
    # the persistent bf16 dX and dW kernels: the card's occupancy against
    # ops.py's mirror
    for kind in ("dx", "dw"):
        blocks = gm.launched_bwd_blocks_per_sm(kind, dev)
        if blocks != gm.bwd_blocks_per_sm():
            fail(f"grouped backward {kind} kernel: {blocks} blocks per SM "
                 f"on the card, ops.py's mirror says "
                 f"{gm.bwd_blocks_per_sm()}")
    gen = torch.Generator(device="cpu").manual_seed(25)
    gdev = torch.Generator(device=dev).manual_seed(25)
    bf16, f32 = torch.bfloat16, torch.float32
    for E, k, C, cases in ((128, 8, TRAIN_MOE_CAPACITY, GROUPED_BWD_CASES),
                           MOONSHOT_BWD):
        live = torch.clamp(routed_rows(torch, E, TRAIN_MOE_TOKENS, k, gen),
                           max=C).to(dev)
        n_live = int(live.sum())
        for K, F, label in cases:
            mask = (torch.arange(C, device=dev)[None, :]
                    < live[:, None].long())[..., None]
            x32 = torch.randn(E, C, K, generator=gdev, device=dev) * mask
            w32 = torch.randn(E, K, F, generator=gdev, device=dev) * 0.02
            dy = torch.randn(E, C, F, generator=gdev, device=dev) * mask
            for dt in (bf16, f32):
                x, w = x32.to(dt), w32.to(dt)
                got = gm.grouped_matmul_backward(x, w, dy, live)
                want = gm.grouped_matmul_backward_plain(x, w, dy, live)
                torch.cuda.synchronize()
                name = f"grouped backward E{E} C{C} K{K} F{F} ({label}) {dt}"
                # bf16 stores the f32 sums rounded once: TOLERANCE plus
                # that rounding (`bf16_rounding`)
                floor = gm.bf16_rounding if dt is bf16 else None
                err = max(hold(f"{name} {part}", g, w_, gm.TOLERANCE[dt], floor)
                          for part, g, w_ in zip(("dX", "dW"), got, want))
                again = gm.grouped_matmul_backward(x, w, dy, live)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"{name}: a rerun gives other bits")
                del got, want, again
                if dt is not bf16:
                    continue
                experts = int((live > 0).sum())
                # x, w (bf16) and dy (f32) read (live rows, live experts'
                # weights), dX (every row: the zeros too) and dW written in
                # bf16, the gradients' dtype
                nbytes = (2 * n_live * K + 2 * experts * K * F + 4 * n_live * F
                          + 2 * E * C * K + 2 * E * K * F)
                ms, by = bound(nbytes, 4 * n_live * K * F)
                dyb = dy.to(bf16)
                passes = gm.backward_pass_timer(x, w, dy, live)
                sms = torch.cuda.get_device_properties(dev).multi_processor_count
                times[f"grouped_matmul_backward {label}"] = dict(
                    ms=time_ms(lambda: gm.grouped_matmul_backward(
                        x, w, dy, live), flush, iters=10, warmup=2),
                    passes_ms={name: time_ms(fn, flush, iters=10, warmup=2)
                               for name, fn in passes.items()},
                    plain_ms=time_ms(lambda: gm.grouped_matmul_backward_plain(
                        x, w, dy, live), flush, iters=3, warmup=1),
                    library_ms=time_ms(lambda: (
                        torch.bmm(dyb, w.transpose(1, 2)),
                        torch.bmm(x.transpose(1, 2), dyb)), flush, iters=10,
                        warmup=2),
                    bound_ms=ms, bound_by=by, max_abs_err=err,
                    live_rows=n_live, live_experts=experts,
                    design="wgmma, persistent dX and dW, dY rounded once",
                    blocks=gm.bwd_grid(E, C, K, F, sms),
                    work_items={kind: len(gm.bwd_work_items(kind, E, C, K, F))
                                for kind in ("dx", "dw")},
                    smem_bytes=gm.bwd_smem_bytes())
                del dyb, passes
            del x32, w32, dy, x, w
    free_card(torch)
    for label, bh, heads, nc, l, p, n in SSD_BWD_CASES:
        x32 = torch.randn(bh, nc, l, p, generator=gdev, device=dev)
        B32 = torch.randn(bh, nc, l, n, generator=gdev, device=dev) * 0.3
        C32 = torch.randn(bh, nc, l, n, generator=gdev, device=dev) * 0.3
        dt_ = torch.rand(bh, nc, l, generator=gdev, device=dev) * 0.1
        A = (-torch.linspace(1.0, 16.0, heads, device=dev)).repeat(
            bh // heads)
        dy = torch.randn(bh, nc, l, p, generator=gdev, device=dev)
        ds = torch.randn(bh, nc, n, p, generator=gdev, device=dev)
        for dt in (bf16, f32):
            args = (x32.to(dt), dt_, A, B32.to(dt), C32.to(dt), dy, ds)
            got = ssd.ssd_intra_chunk_backward(*args)
            want = ssd.ssd_intra_chunk_backward_plain(*args)
            torch.cuda.synchronize()
            name = f"ssd backward {label} bh{bh} nc{nc} l{l} p{p} n{n} {dt}"
            parts = ("dx", "ddt", "dA", "dB", "dC")
            errs = [hold(f"{name} {part}", g, w_, ssd.BWD_TOLERANCE)
                    for part, g, w_ in zip(parts, got, want)]
            # and against the f64 plain version, in both designs: the
            # kernel's f32 sums (bf16: of operands split into bf16
            # pieces) are as close to the exact gradient as the bound
            truth = ssd.ssd_intra_chunk_backward_plain(
                *(a.double() for a in args))
            for part, g, t_ in zip(parts, got, truth):
                hold(f"{name} {part} against f64", g, t_, ssd.BWD_TOLERANCE)
            # the plain f32 version's own distance from f64, reported
            # beside the kernel's: the f32 function's conditioning here
            plain_f64 = {part: worst_ratio(w_, t_, *ssd.BWD_TOLERANCE)[1]
                         for part, w_, t_ in zip(parts, want, truth)}
            del truth
            again = ssd.ssd_intra_chunk_backward(*args)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"{name}: a rerun gives other bits")
            del got, want, again
            if dt is not bf16:
                continue
            # the function's work: per pair C.B, dy.x, and the dx, dC and
            # dB sums; per token the state terms B.ds and ds x
            chunks = bh * nc
            pairs = l * (l + 1) // 2
            ops = chunks * (pairs * (6 * n + 4 * p) + 4 * l * n * p)
            # x, B, C (bf16), dy, ds, dt, A in; dx, dB, dC, ddt, dA out
            nbytes = (chunks * (2 * l * (p + 2 * n) + 4 * l * p + 4 * n * p
                                + 4 * l)
                      + chunks * 4 * (l * p + 2 * l * n + l) + 8 * bh)
            ms, by = bound(nbytes, ops)
            times[f"ssd_intra_chunk_backward {label}"] = dict(
                ms=time_ms(lambda: ssd.ssd_intra_chunk_backward(*args),
                           flush, iters=10, warmup=2),
                plain_ms=time_ms(lambda: ssd.ssd_intra_chunk_backward_plain(
                    *args), flush, iters=3, warmup=1),
                library_ms=None, bound_ms=ms, bound_by=by,
                max_abs_err=max(errs), plain_against_f64=plain_f64,
                bh=bh, nc=nc, l=l, p=p, n=n,
                blocks={"column": ssd.bwd_num_blocks(bh, nc, l)
                        * ssd.bwd_col_splits(dt, p, n),
                        "row": ssd.bwd_num_blocks(bh, nc, l)},
                smem_bytes=dict(zip(("column", "row"),
                                    ssd.bwd_smem_bytes(dt, p, n))))
        del x32, B32, C32, dt_, dy, ds, args
        free_card(torch)
    return times


# ---------------------------------------- phase 5: ws/os matmul kernels

# (m, k, n) of tests/test_kernels.py's ws_matmul cases
WS_TEST_SHAPES = ((128, 128, 128), (256, 128, 384), (128, 512, 256),
                  (384, 256, 128))
# launches of each of the ws and os kernels in one run of the dataflow
# sweep (its kernel check calls each wrapper once)
WS_PATH_LAUNCHES = 1
# timed iterations per regime (train mlp's calls take tens of ms)
WS_ITERS = {"decode b=16": 30, "decode b=128": 20, "prefill chunk": 10,
            "train mlp": 3}


def count_path(fn):
    """fn() with every kernel's count set to 0 just before it; returns
    (fn's result, the launches it made)."""
    mods = kernel_modules()
    for m in mods.values():
        m.launches = 0
    out = fn()
    return out, {name: m.launches for name, m in mods.items()}


def check_sweep_launches(phase: str, launches: dict) -> None:
    """One run of the dataflow sweep launches the ws and os kernels
    WS_PATH_LAUNCHES times each and no other kernel."""
    want = {name: 0 for name in launches}
    want.update(ws_matmul=WS_PATH_LAUNCHES, os_matmul=WS_PATH_LAUNCHES)
    if launches != want:
        fail(f"{phase}: kernel launches {launches} != expected {want}")


def phase_ws_kernels(torch, dev, card: str, flush):
    from repro_torch.benchmarks import ws_dataflow
    from repro_torch.kernels.tolerance import worst_ratio
    from repro_torch.kernels.ws_matmul import ops as wm

    gdev = torch.Generator(device=dev).manual_seed(14)
    bf16, f32 = torch.bfloat16, torch.float32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, times = [], {}
    small = torch.ones(16, 16, dtype=bf16, device=dev)
    try:                   # the yardstick: one cuBLAS call, bf16 in, f32 out
        torch.mm(small, small, out_dtype=f32)
        library = lambda x, w: torch.mm(x, w, out_dtype=f32)
        library_note = "torch.mm(x, w, out_dtype=torch.float32)"
    except TypeError:
        library = torch.mm
        library_note = "torch.mm(x, w), bf16 out: this torch has no out_dtype"

    def hold(name, got, want, dt):
        rtol, atol = wm.TOLERANCE[dt]
        err, ratio = worst_ratio(got, want, rtol, atol)
        rows.append({"case": name, "max_abs_err": err, "rtol": rtol,
                     "atol_x_row_max": atol, "worst_err_over_bound": ratio})
        if not ratio <= 1.0:
            emit({"phase": "ws_kernels", "failed": rows[-1]})
            fail(f"kernel {name} disagrees with its plain version: "
                 f"err / bound {ratio}")
        return err

    # (name, m, k, n, dtype, timed regime, WS's bks); OS runs at bk 128
    cases = [("test shape", m, k, n, dt, None, (128,))
             for m, k, n in WS_TEST_SHAPES for dt in (f32, bf16)]
    for regime, m, k, n in ws_dataflow.SWEEP:
        m = -(-m // 128) * 128                       # padded as the sweep pads
        cases.append((regime, m, k, n, bf16, regime,
                      (128, 512) if regime.startswith("decode") else (128,)))
        if regime == "decode b=16":
            cases.append((regime, m, k, n, f32, None, (128,)))
    # 5 M tiles over 2 blocks (3 + 2): a bk that is no multiple of the
    # bf16 slice, and the deepest weight tile the wrapper lets WS hold
    for dt in (f32, bf16):
        cases.append(("bk 96", 640, 1536, 8448, dt, None, (96,)))
        cases.append(("largest bk", 640, 2560, 8448, dt, None,
                      (wm.MAX_BK[dt],)))
    for name, m, k, n, dt, timed, ws_bks in cases:
        x = torch.randn(m, k, generator=gdev, device=dev).to(dt)
        w = (torch.randn(k, n, generator=gdev, device=dev) * k ** -0.5).to(dt)
        want = wm.matmul_plain(x, w)
        errs = {}
        for kern, bk in [("ws", ws_bks[0]), ("os", 128)] + [
                ("ws", b) for b in ws_bks[1:]]:
            got = getattr(wm, f"{kern}_matmul")(x, w, block_k=bk)
            torch.cuda.synchronize()
            errs[f"{kern} bk{bk}"] = hold(f"{kern}_matmul bk{bk} {name} "
                                          f"(m{m} k{k} n{n}) {dt}",
                                          got, want, dt)
            del got
        del want
        if not timed:
            del x, w
            continue
        iters = WS_ITERS[timed]
        warm = min(5, iters)
        nbytes = 2 * m * k + 2 * k * n + 4 * m * n
        ms, by = bound(nbytes, 2 * m * n * k)
        m_tiles, n_tiles = m // 128, n // 128
        plan = wm.plan((m, k), (k, n), bf16)
        splits = wm.ws_splits(m_tiles, n_tiles, sms)
        per = -(-m_tiles // splits)
        t = dict(
            ms=time_ms(lambda: wm.ws_matmul(x, w), flush, iters, warm),
            os_ms=time_ms(lambda: wm.os_matmul(x, w), flush, iters, warm),
            plain_ms=time_ms(lambda: wm.matmul_plain(x, w), flush, iters,
                             warm),
            library_ms=time_ms(lambda: library(x, w), flush, iters, warm),
            bound_ms=ms, bound_by=by, m=m, k=k, n=n, iters=iters,
            ws_splits=splits, max_abs_err=errs)
        # blocks per SM: the occupancy API on the launch as configured,
        # beside ops.py's mirror of it
        t["blocks_per_sm"] = {
            "ws": wm.launched_blocks_per_sm(bf16, "ws", 128, per, dev),
            "os": wm.launched_blocks_per_sm(bf16, "os", 128, 1, dev)}
        mirror = {"ws": wm.blocks_per_sm(wm.smem_bytes(
                      bf16, wm.w_slots(bf16, 128, resident=per > 1)),
                      resident=per > 1),
                  "os": wm.blocks_per_sm(wm.smem_bytes(bf16, wm.STAGES))}
        if t["blocks_per_sm"] != mirror:
            fail(f"ws_kernels {timed}: blocks per SM {t['blocks_per_sm']} "
                 f"!= ops.py's mirror {mirror}")
        # wave quantisation: WS at the splits beside the chosen one
        t["ws_ms_by_splits"] = {
            str(-(-m_tiles // -(-m_tiles // s))): time_ms(
                lambda: wm._launch_ws(x, w, plan, splits=s), flush, iters,
                warm)
            for s in range(max(1, splits - 1), min(m_tiles, splits + 1) + 1)}
        model = wm.hbm_traffic_model(m, n, k)          # blocks 128, 128, 128
        t["model_bytes_bk128"] = {
            "weight_stationary": model["weight_stationary"],
            # the S blocks that share an n tile each read its weights
            "weight_stationary_at_splits": (model["weight_stationary"]
                                            + (splits - 1) * k * n * 2),
            "output_stationary": model["output_stationary"]}
        # WS against the time its dataflow's bytes take; OS's rate
        t["ws_byte_ms"] = (t["model_bytes_bk128"]["weight_stationary_at_splits"]
                           / HBM_BYTES_PER_S * 1e3)
        t["ws_over_byte_time"] = t["ms"] / t["ws_byte_ms"]
        t["os_tflops"] = 2 * m * n * k / t["os_ms"] / 1e9
        if timed.startswith("decode"):
            t["ws_bk512_ms"] = time_ms(
                lambda: wm.ws_matmul(x, w, block_k=512), flush, iters, warm)
            t["ws_bk512_splits"] = s512 = wm.ws_splits(m_tiles, n_tiles,
                                                       sms)
            m512 = wm.hbm_traffic_model(m, n, k, bk=512)
            t["model_bytes_bk512"] = {
                "weight_stationary": m512["weight_stationary"],
                "weight_stationary_at_splits": (m512["weight_stationary"]
                                                + (s512 - 1) * k * n * 2)}
        times[timed] = t
        del x, w
        free_card(torch)
    emit({"phase": "ws_kernels", "cases": rows})
    emit({"phase": "ws_kernel_times", "card": card, "dtype": "bfloat16",
          "blocks": "128 x 128 x 128 unless named", "library": library_note,
          "timing": "CUDA events, median of `iters` after up to 5 warm-up, "
                    "L2 flushed", **times})

    # the sweep itself, through the wrappers, on the card
    res, launches = count_path(lambda: ws_dataflow.run(device=dev))
    emit({"phase": "ws_dataflow", **res, "launches": launches})
    if not res["ok"]:
        fail(f"ws_dataflow: {res}")
    check_sweep_launches("ws_dataflow", launches)
    d16 = times["decode b=16"]
    timings = {}
    for kern, ms_key in (("ws_matmul", "ms"), ("os_matmul", "os_ms")):
        timings[kern] = dict(
            ms=d16[ms_key], plain_ms=d16["plain_ms"],
            library_ms=d16["library_ms"], bound_ms=d16["bound_ms"],
            bound_by=d16["bound_by"],
            max_abs_err=d16["max_abs_err"][f"{kern[:2]} bk128"])
    return timings, launches


# ------------------------------------------------------- phase 6: serve

PROMPT_LENS = (5, 17, 64, 100, 128, 200, 333, 511)
SAMPLED = 3                 # the 100-token prompt samples
FORKED = 7                  # the 511-token prompt's stream is forked
OPT_OUT = 0                 # the 5-token prompt decodes plainly beside
                            # the windows of a speculating engine


def serve_once(torch, dev, cfg, params, prompts, layout=None, max_new=32,
               patches=None, max_seq=1024, **engine_kw):
    """Serve `prompts` (the SAMPLED one sampling, the FORKED one forked
    after its first token when the layout allows it, the
    OPT_OUT one pinned to plain decode) through `LLMServer`, each with
    its image's `patches` rows where given (vlm); `engine_kw` passes to
    the engine (`speculate_k`, `draft`)."""
    from repro_torch.serve.api import LLMServer
    from repro_torch.serve.engine import TokenEvent
    from repro_torch.serve.sampling import SamplingParams

    server = LLMServer(cfg, params, device=dev, max_batch=8,
                       max_seq=max_seq, page_size=16, layout=layout,
                       **engine_kw)
    eng = server.engine
    # the contiguous layout refuses a fork
    fork = eng.layout == "paged" and FORKED < len(prompts)
    steps = {"prefill": [0.0, 0.0], "decode": [0.0, 0.0]}

    def timed(fn, acc):
        """fn, adding its host enqueue time and its time to the card's
        finish (the sync the engine's token read would make anyway)."""
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            t1 = time.perf_counter()
            torch.cuda.synchronize(dev)
            acc[0] += t1 - t0
            acc[1] += time.perf_counter() - t0
            return out
        return run

    eng.prefill_fn = timed(eng.prefill_fn, steps["prefill"])
    eng.decode_fn = timed(eng.decode_fn, steps["decode"])
    if eng.draft is not None:         # the speculative window's calls
        d = eng.draft
        for name, obj, attr in (("draft_sync", d, "sync"),
                                ("propose", d, "propose"),
                                ("rollback", d, "rollback"),
                                ("verify", eng, "verify_fn"),
                                ("verify", eng, "fused_fn")):
            if getattr(obj, attr) is not None and not (
                    attr in ("propose", "rollback") and d.rewindable):
                steps.setdefault(name, [0.0, 0.0])
                setattr(obj, attr, timed(getattr(obj, attr), steps[name]))
    streams = []
    for i, p in enumerate(prompts):
        sp = (SamplingParams(temperature=0.8, top_p=0.9, seed=7,
                             max_new_tokens=max_new) if i == SAMPLED
              else SamplingParams(max_new_tokens=max_new,
                                  speculative=i != OPT_OUT))
        streams.append(server.generate(
            p, sp, patch_embeds=None if patches is None else patches[i]))
    t0 = time.perf_counter()
    ttft = {}
    live = list(streams)
    forked = None
    while live:
        for s in list(live):
            ev = next(s, None)
            if ev is None:
                live.remove(s)
                continue
            if isinstance(ev, TokenEvent) and s.uid not in ttft:
                ttft[s.uid] = time.perf_counter() - t0
            if (fork and forked is None and s is streams[FORKED] and s.tokens
                    and not s.finished and len(eng.slots) < eng.max_batch):
                forked = s.fork()
                streams.append(forked)
                live.append(forked)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return server, streams, forked, ttft, wall, steps


def kernel_modules():
    """name -> the wrapper module (or counter) whose `launches` counts
    that kernel."""
    from repro_torch.kernels.decode_attention import ops as dk
    from repro_torch.kernels.flash_attention import ops as fk
    from repro_torch.kernels.grouped_matmul import ops as gm
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_prefill import ops as pp
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.ws_matmul import ops as wm
    return {"paged_decode_attention": pa, "paged_prefill_attention": pp,
            "grouped_matmul": gm, "ssd_intra_chunk": ssd,
            "decode_attention": dk, "combine_splits": dk.COMBINE,
            "flash_attention": fk, "flash_attention_backward": fk.BACKWARD,
            "grouped_matmul_backward": gm.BACKWARD,
            "ssd_intra_chunk_backward": ssd.BACKWARD,
            "ws_matmul": wm.WS, "os_matmul": wm.OS}


def expected_launches(cfg, st, draft=None) -> dict:
    """Kernel launches one served run must make: each step call launches
    its layout's attention kernel once per attention layer (dense and
    MoE: every layer; hybrid: every shared-block application; ssm:
    none) — paged decode/prefill on the arena, split-KV decode/flash on
    the contiguous cache, where in f32 split-KV decode's combine kernel
    follows each split launch (bf16 merges inside the one launch) — the
    grouped matmul 3 times per MoE layer under the grouped dispatch, the
    SSD kernel once per Mamba layer of a prefill call under
    `ssd_impl="pallas"`, and no ws or os
    matmul and no backward kernel (no serving path runs them).  Speculating (`draft`), each
    verify call walks the arena with the paged-prefill kernel once per
    layer, and each decode step of a dense draft's contiguous cache
    launches split-KV decode once per draft layer; an ssm draft decodes
    by the SSD recurrence and launches no kernel."""
    pre, dec = st["prefill_calls"], st["decode_calls"]
    verify = st.get("speculative", {}).get("verify_calls", 0)
    attn = {"hybrid": cfg.num_layers // max(1, cfg.shared_attn_period),
            "ssm": 0}.get(cfg.family, cfg.num_layers)
    paged = st["layout"] == "paged"
    drafted = (draft.steps * draft.cfg.num_layers
               if draft is not None and draft.cfg.family == "dense" else 0)
    return {"paged_decode_attention": dec * attn if paged else 0,
            "paged_prefill_attention": (pre + verify) * attn if paged else 0,
            "decode_attention": (0 if paged else dec * attn) + drafted,
            "combine_splits": ((dec * attn if not paged else 0) + drafted
                               if cfg.dtype == "float32" else 0),
            "flash_attention": 0 if paged else pre * attn,
            "grouped_matmul": (3 * cfg.num_layers * (pre + dec + verify)
                               if cfg.family == "moe"
                               and cfg.moe_dispatch == "grouped" else 0),
            "ssd_intra_chunk": (cfg.num_layers * pre
                                if cfg.family in ("hybrid", "ssm")
                                and cfg.ssd_impl == "pallas" else 0),
            "flash_attention_backward": 0, "grouped_matmul_backward": 0,
            "ssd_intra_chunk_backward": 0, "ws_matmul": 0, "os_matmul": 0}


def tree_to(tree, d):
    """A parameter tree (dicts and lists of tensors) moved to device d."""
    if isinstance(tree, dict):
        return {k: tree_to(v, d) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, d) for v in tree]
    return tree.to(d)


def free_card(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve(torch, dev, card: str, phase: str, cfg, twins=False,
                layout=None, params=None, n_prompts=8, max_new=32,
                plain=None, **engine_kw):
    """Serve the first `n_prompts` of the 8 prompts (+ one fork on the
    paged layout when the forked prompt is among them) twice on `cfg`
    at the width and depth it has; with `twins` the 333-token prompt is
    replaced by a copy of the 200-token one, so identical prompts
    co-prefill.  A patch-frontend config (vlm) gives each prompt its
    own seeded image of `num_patches` rows, and `max_seq` holds them
    beside the longest prompt and its new tokens.  `engine_kw` passes
    to the engine (speculation); `plain` (uid -> tokens of a plain run)
    is compared token by token and the share printed.  Returns the
    launches and the streams (uid -> tokens) of the first run."""
    import numpy as np
    from repro_torch.models import registry

    free_card(torch)
    t0 = time.perf_counter()
    if params is None:
        params = registry.get_family(cfg).init(0, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS][:n_prompts]
    if twins:
        prompts[6] = prompts[5].copy()
    patches, max_seq = None, 1024
    if cfg.frontend == "patch":
        patches = [rng.standard_normal((cfg.num_patches, cfg.frontend_dim))
                   .astype(np.float32) for _ in prompts]
        need = cfg.num_patches + max(PROMPT_LENS) + max_new
        max_seq = -(-need // 64) * 64
    run_kw = dict(engine_kw, patches=patches, max_seq=max_seq)
    mods = kernel_modules()

    torch.cuda.reset_peak_memory_stats()
    for m in mods.values():                          # count the main path
        m.launches = 0
    server, streams, forked, ttft, wall, steps = serve_once(
        torch, dev, cfg, params, prompts, layout, max_new, **run_kw)
    launches = {name: m.launches for name, m in mods.items()}
    peak = torch.cuda.max_memory_allocated()
    st = server.stats
    draft = server.engine.draft
    if (forked is None and st["layout"] == "paged"
            and FORKED < len(prompts)):
        fail("the fork never happened (no free slot while its parent decoded)")
    for s in streams:
        if s.result is None or not s.finished:
            fail(f"stream {s.uid} did not finish")
        toks = s.result.tokens
        if (len(toks) != max_new
                or not all(0 <= t < cfg.vocab_size for t in toks)):
            fail(f"stream {s.uid}: bad tokens {toks}")
    if st["pool"]["allocated_pages"] != 0:
        fail(f"{st['pool']['allocated_pages']} pages leaked")
    want = expected_launches(cfg, st, draft)
    if launches != want:
        fail(f"{phase}: kernel launches {launches} != expected {want}")
    if twins:
        # per-slot-state families share pages but recompute every token
        if st["prefill_tokens"] != sum(len(p) for p in prompts):
            fail(f"prefill computed {st['prefill_tokens']} prompt tokens, "
                 f"not all {sum(len(p) for p in prompts)}")
        if streams[5].result.tokens != streams[6].result.tokens:
            fail("identical greedy prompts gave different streams")
    first = {s.uid: s.result.tokens for s in streams}
    n_streams = len(streams)
    extra = {}
    if draft is not None:
        extra = {"speculative": st["speculative"], "draft_steps": draft.steps,
                 "draft_layers": draft.cfg.num_layers}
    if plain is not None:
        pairs = [(a, b) for uid, toks in first.items()
                 for a, b in zip(toks, plain.get(uid, ()))]
        extra["tokens_compared_with_plain"] = len(pairs)
        extra["share_equal_plain"] = (sum(a == b for a, b in pairs)
                                      / max(1, len(pairs)))
    del server, streams, forked, draft               # free the first arena
    free_card(torch)

    _, streams2, _, _, wall2, _ = serve_once(torch, dev, cfg, params,
                                             prompts, layout, max_new,
                                             **run_kw)
    if first != {s.uid: s.result.tokens for s in streams2}:
        fail(f"{phase}: rerun streams differ")
    tokens = st["tokens_out"]
    emit({"phase": phase, "card": card, "arch": cfg.name,
          "layout": st["layout"], "layers": cfg.num_layers, "dtype": cfg.dtype,
          "max_seq": max_seq, "patch_rows": cfg.num_patches if patches else 0,
          "kv_dtype": cfg.kv_dtype,
          "moe_dispatch": cfg.moe_dispatch, "ssd_impl": cfg.ssd_impl,
          **engine_kw, **extra,
          "params_init_s": init_s,
          "streams": n_streams, "tokens_out": tokens,
          "prefill_tokens": st["prefill_tokens"],
          "prefill_calls": st["prefill_calls"],
          "decode_calls": st["decode_calls"], "launches": launches,
          "peak_kv_bytes": st["peak_kv_bytes"],
          "peak_allocated_pages": st["pool"]["peak_allocated_pages"],
          "prefix_store": st.get("prefix_store"),
          "max_memory_allocated": peak,
          "wall_s": wall, "tokens_per_s": tokens / wall,
          "rerun_wall_s": wall2, "rerun_tokens_per_s": tokens / wall2,
          "ttft_s": {str(k): v for k, v in sorted(ttft.items())},
          # per step kind: host seconds to enqueue the calls, and seconds
          # until the card finished them; the rest of wall_s is the
          # engine's host work between calls
          "step_s": {k: {"enqueue_s": v[0], "call_s": v[1]}
                     for k, v in steps.items()},
          "between_calls_s": wall - sum(v[1] for v in steps.values()),
          "rerun_identical": True, "leaked_pages": 0})
    return launches, first


# (arch, layers kept (None: all)) of serve_configs, 4 prompts of 16 new
# tokens each, bf16: yi-9b (17.7 GB of weights) and moonshot-v1-16b-a3b
# (57.8 GB, grouped dispatch) whole; deepseek-67b's 95 layers of 1.38 GB
# and nemotron-4-340b's of 6.91 GB (beside 3.4 and 18.9 GB of embedding
# and head) do not fit 80 GB: 40 and 4 layers.  nemotron's init draws
# its 4.7 B-element head in f32 and scales a bf16 copy (37.7 GB at
# once), so 4 layers (27.6 GB) is the most that leaves room for it
SERVE_CONFIGS = (("yi-9b", None), ("moonshot-v1-16b-a3b", None),
                 ("deepseek-67b", 40), ("nemotron-4-340b", 4))


def phase_serve_configs(torch, dev, card: str) -> dict:
    """A short paged serve (the first 4 prompts, 16 new tokens, twice:
    the rerun byte-identical, no page leaked, the launches held) of each
    of `SERVE_CONFIGS`; returns each one's launches."""
    out = {}
    for arch, layers in SERVE_CONFIGS:
        cfg = family_cfg(arch, layers)
        out[arch], _ = phase_serve(torch, dev, card, f"serve_configs {arch}",
                                   cfg, n_prompts=4, max_new=16)
        free_card(torch)
    return out


SPEC_K = 4                  # the served speculative window
SPEC_DRAFTS = ("mamba2-130m", "self:1")


def phase_serve_spec(torch, dev, card: str, cfg, plain) -> None:
    """internlm2-1.8b served speculatively at full width and depth (k =
    SPEC_K) with the registry's paired draft (mamba2-130m at full
    width, vocab coerced) and with the `self:1` truncated draft, then
    with an int8 page arena (4 prompts, 16 new tokens).  Each run is
    held as the plain serve is (every stream finishes, no page leaks,
    the launches, a byte-identical rerun); in bf16 the verify walk's
    logits round differently from decode's, so the share of tokens
    equal to `plain` (the `serve` phase's streams) is printed, not held."""
    from repro_torch.models import registry

    free_card(torch)
    params = registry.get_family(cfg).init(0, cfg, dev)
    for draft in SPEC_DRAFTS:
        phase_serve(torch, dev, card, "serve_spec", cfg, params=params,
                    plain=plain, speculate_k=SPEC_K, draft=draft)
    del params
    phase_serve(torch, dev, card, "serve_int8", cfg.replace(kv_dtype="int8"),
                n_prompts=4, max_new=16)


# ----------------------------------------- serve_tier: cache + host tier

TIER_SYSTEM = 256           # shared system-prompt tokens: 16 full pages
TIER_SUFFIX = (16, 240)     # seeded distinct suffix lengths, inclusive
TIER_WAVE = 8               # requests a wave; wave 2 follows wave 1's end
TIER_NEW = 32               # greedy new tokens a request
TIER_POOL = 128             # run B's pool pages: wave 1 preempts twice
TIER_HOST_PAGES = 512       # run B's host tier (768 MiB of bf16 pages)
TIER_WATERMARK = 0.75
TIER_INT8 = (2, 16)         # the int8 case: requests a wave, new tokens


def tier_prompts(cfg, per_wave: int):
    """Two waves of `per_wave` prompts: one seeded 256-token system
    prefix, each followed by its own seeded suffix of a distinct length
    in TIER_SUFFIX."""
    import numpy as np
    rng = np.random.default_rng(11)
    lens = rng.choice(np.arange(TIER_SUFFIX[0], TIER_SUFFIX[1] + 1),
                      size=2 * TIER_WAVE, replace=False)
    system = rng.integers(0, cfg.vocab_size, TIER_SYSTEM)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, n)])
               .astype(np.int32) for n in lens]
    return [prompts[:per_wave], prompts[TIER_WAVE:TIER_WAVE + per_wave]]


class CopyClock:
    """CUDA-event timings and bytes of the arena's page traffic: the
    spills (`read_pages`: gather + copy to pinned host memory), the restores from host memory (`write_pages`, `write_page`:
    host-to-device + scatter), the prefetches (host-to-device on the copy
    stream) and the restores from a prefetched device copy."""

    def __init__(self, torch, arena):
        self.torch, self.arena = torch, arena
        self.events = {k: [] for k in ("d2h", "h2d", "prefetch",
                                       "from_prefetch", "cold_h2d")}
        self.bytes = dict.fromkeys(self.events, 0)
        if arena.copy_stream is None:
            arena.copy_stream = torch.cuda.Stream(arena.device)
        # read_page goes through read_pages
        for name in ("read_pages", "write_pages", "write_page", "prefetch"):
            setattr(arena, name, self._timed(name, getattr(arena, name)))

    def _timed(self, name, fn):
        torch, arena = self.torch, self.arena

        def run(*args, **kw):
            if name == "read_pages":
                kind, pages = "d2h", len(args[0])
            elif name == "write_page":
                kind, pages = "cold_h2d", 1
            elif name == "prefetch":
                kind, pages = "prefetch", next(iter(args[0].values())).shape[1]
            else:
                on_card = next(iter(args[1].values())).is_cuda
                kind = "from_prefetch" if on_card else "h2d"
                pages = len(args[0])
            stream = (arena.copy_stream if kind == "prefetch"
                      else torch.cuda.current_stream(arena.device))
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(stream)
            out = fn(*args, **kw)
            b.record(stream)
            self.events[kind].append((a, b))
            self.bytes[kind] += pages * arena.page_bytes
            return out
        return run

    def report(self) -> dict:
        self.torch.cuda.synchronize()
        out = {}
        for kind, evs in self.events.items():
            s = sum(a.elapsed_time(b) for a, b in evs) / 1e3
            out[kind] = {"calls": len(evs), "bytes": self.bytes[kind],
                         "s": s, "GB_per_s": (self.bytes[kind] / s / 1e9
                                              if s else None)}
        h2d = out["h2d"]["s"] + out["prefetch"]["s"]
        out["prefetch_hidden_share"] = (out["prefetch"]["s"] / h2d
                                        if h2d else None)
        return out


def serve_waves(torch, dev, cfg, params, waves, max_new, flush=False,
                **engine_kw):
    """Serve `waves` of greedy prompts through `LLMServer`, each wave
    submitted after the one before has retired; with `flush` the store's
    idle entries are evicted to the host tier between the waves.  Returns
    the server, uid -> tokens, each wave's TTFT (uid -> s), the wall
    seconds, the copy timings and the peak memory."""
    from repro_torch.serve.api import LLMServer
    from repro_torch.serve.engine import TokenEvent
    from repro_torch.serve.sampling import SamplingParams

    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    server = LLMServer(cfg, params, device=dev, max_batch=8, max_seq=1024,
                       page_size=16, **engine_kw)
    eng = server.engine
    clock = CopyClock(torch, eng.arena)
    streams, ttft, flushed = [], [], []
    t0 = time.perf_counter()
    for w, prompts in enumerate(waves):
        if w and flush:
            store = eng.prefix_store
            flushed.append(store.evict(len(store)))
        wave = [server.generate(p, SamplingParams(max_new_tokens=max_new))
                for p in prompts]
        tw = time.perf_counter()
        first, live = {}, list(wave)
        while live:
            for s in list(live):
                ev = next(s, None)
                if ev is None:
                    live.remove(s)
                elif isinstance(ev, TokenEvent) and s.uid not in first:
                    first[s.uid] = time.perf_counter() - tw
        streams += wave
        ttft.append(first)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    for s in streams:
        if s.result is None or len(s.result.tokens) != max_new:
            fail(f"serve_tier: stream {s.uid} did not finish its "
                 f"{max_new} tokens")
    return (server, {s.uid: s.result.tokens for s in streams}, ttft, wall,
            clock.report(), torch.cuda.max_memory_allocated(), flushed)


def tier_round_trip(torch, eng) -> dict:
    """Read written pages (cached prompt pages) to pinned host memory,
    bring them back into fresh pages through the prefetch path and hold
    every page leaf (scales too) bit for bit.  Up to 16 pages; idle
    entries are evicted first where the pool has no room for the copy."""
    arena, pool, store = eng.arena, eng.pool, eng.prefix_store
    n = min(16, len(store) // 2)
    if n == 0:
        fail("serve_tier: no cached page to round-trip")
    store.evict(max(0, n - pool.free_pages))
    src = [e.page for e in store._entries.values()][:n]
    host = arena.read_pages(src)
    if not all(t.is_pinned() for t in host.values()):
        fail("serve_tier: spilled pages are not in pinned host memory")
    fresh = pool.alloc(len(src))
    staged, ready = arena.prefetch(host)
    arena.write_pages(fresh, staged, ready=ready)
    torch.cuda.synchronize()
    idx_src = torch.tensor(src, device=arena.device)
    idx_new = torch.tensor(fresh, device=arena.device)
    leaves = sorted(host)
    for name in leaves:
        a = arena.kv[name]
        if not torch.equal(a.index_select(1, idx_src),
                           a.index_select(1, idx_new)):
            fail(f"serve_tier: leaf {name} changed in a page round trip")
    pool.free(fresh)
    return {"pages": len(src), "leaves": leaves, "bit_exact": True}


def phase_serve_tier(torch, dev, card: str, cfg) -> dict:
    """internlm2-1.8b at full width and depth through `LLMServer` with
    the persistent prefix cache and the host tier (run B) against the
    plain engine (run A): two waves of TIER_WAVE prompts behind one
    256-token system prefix, wave 2 after wave 1 retired and, in B,
    after the idle cache was flushed to host DRAM, so wave 2 restores
    cold parcels.  B's pool (TIER_POOL pages) preempts in wave 1 and
    spills to the tier.  Gates: B's streams equal A's, the tier and cache
    counters moved, B computed fewer prompt tokens, nothing leaked, the
    launches held and a page round trip through the prefetch path is
    bit-exact; then the same on an int8 arena (TIER_INT8).  Returns B's
    launches."""
    from repro_torch.models import registry

    free_card(torch)
    params = registry.get_family(cfg).init(0, cfg, dev)
    mods = kernel_modules()
    tier_kw = dict(prefix_cache=True, host_tier_pages=TIER_HOST_PAGES,
                   high_watermark=TIER_WATERMARK, pool_pages=TIER_POOL)
    out = {}
    for label, c, per_wave, max_new in (
            ("bf16", cfg, TIER_WAVE, TIER_NEW),
            ("int8", cfg.replace(kv_dtype="int8"), *TIER_INT8)):
        waves = tier_prompts(c, per_wave)
        runs = {}
        for run, kw in (("A", {}), ("B", tier_kw)):
            for m in mods.values():                  # count the main path
                m.launches = 0
            server, toks, ttft, wall, copies, peak, flushed = serve_waves(
                torch, dev, c, params, waves, max_new, flush=run == "B",
                **kw)
            launches = {n: m.launches for n, m in mods.items()}
            st = server.stats
            want = expected_launches(c, st)
            if launches != want:
                fail(f"serve_tier {label} {run}: kernel launches "
                     f"{launches} != expected {want}")
            runs[run] = dict(tokens=toks, ttft=ttft, wall=wall,
                             copies=copies, peak=peak, st=st,
                             launches=launches, flushed=flushed)
            if run == "B":          # A's arena goes before B's run
                runs[run]["server"] = server
            del server
        a, b = runs["A"], runs["B"]
        if b["tokens"] != a["tokens"]:
            diff = [u for u in a["tokens"] if a["tokens"][u] != b["tokens"][u]]
            fail(f"serve_tier {label}: streams {diff} differ from run A")
        st, eng = b["st"], b["server"].engine
        tier, store, pool = st["host_tier"], st["prefix_store"], st["pool"]
        moved = {"preemptions": st["preemptions"], "spills": tier["spills"],
                 "restores": tier["restores"],
                 "prefetches": tier["prefetches"],
                 "cold_spills": store["cold_spills"],
                 "cold_restores": store["cold_restores"],
                 "cross_request_hits": store["cross_request_hits"]}
        need = (moved if label == "bf16" else
                {k: moved[k] for k in ("cold_spills", "cold_restores",
                                       "cross_request_hits")})
        idle = [k for k, v in need.items() if v <= 0]
        if idle:
            fail(f"serve_tier {label}: counters at 0: {idle} ({moved})")
        if st["prefill_tokens"] >= a["st"]["prefill_tokens"]:
            fail(f"serve_tier {label}: B computed {st['prefill_tokens']} "
                 f"prompt tokens, A {a['st']['prefill_tokens']}")
        if not (pool["allocated_pages"] == pool["pinned_pages"]
                == len(eng.prefix_store)):
            fail(f"serve_tier {label}: {pool['allocated_pages']} pages "
                 f"allocated, {pool['pinned_pages']} pinned, "
                 f"{len(eng.prefix_store)} cached")
        left = [u for u in b["tokens"] if u in eng.host_tier]
        if left:
            fail(f"serve_tier {label}: parcels of {left} left in the tier")
        if a["st"]["pool"]["allocated_pages"]:
            fail(f"serve_tier {label}: run A leaked pages")
        trip = tier_round_trip(torch, eng)
        page_bytes = eng.arena.page_bytes
        out[label] = {
            "requests": 2 * per_wave, "max_new": max_new,
            "pool_pages": {"A": a["st"]["pool"]["num_pages"],
                           "B": pool["num_pages"]},
            "page_bytes": page_bytes, "counters": moved,
            "flushed_entries": b["flushed"],
            "host_tier": tier, "prefix_store": store,
            "bytes_spilled": tier["spilled_pages"] * page_bytes,
            "bytes_restored": tier["restored_pages"] * page_bytes,
            "copies": b["copies"],
            "prompt_tokens_computed": {"A": a["st"]["prefill_tokens"],
                                       "B": st["prefill_tokens"]},
            "wave2_median_ttft_s": {
                r: statistics.median(runs[r]["ttft"][1].values())
                for r in runs},
            "tokens_per_s": {r: runs[r]["st"]["tokens_out"] / runs[r]["wall"]
                             for r in runs},
            "wall_s": {r: runs[r]["wall"] for r in runs},
            "max_memory_allocated": {r: runs[r]["peak"] for r in runs},
            "launches": {r: {n: v for n, v in runs[r]["launches"].items()
                             if v} for r in runs},
            "round_trip": trip, "streams_equal": True}
        del runs, a, b, eng, st
        free_card(torch)
    emit({"phase": "serve_tier", "card": card, "arch": cfg.name,
          "layers": cfg.num_layers, "dtype": cfg.dtype, "page_size": 16,
          "system_tokens": TIER_SYSTEM, "suffix_tokens": list(TIER_SUFFIX),
          "host_tier_pages": TIER_HOST_PAGES, "watermark": TIER_WATERMARK,
          **out})
    return out["bf16"]["launches"]["B"]


FRONT_TRACE = dict(requests=24, horizon=3.0, seed=0)
FRONT_ENGINE = dict(max_batch=8, max_seq=1024, tick_token_budget=256,
                    page_size=16)
FRONT_REPLAYS = 6            # wire streams replayed in process


def front_saturation(torch, dev, cfg, params) -> dict:
    """The reference's engine-level tenant check
    (`tests/test_frontend.py` `test_tenant_budget_shares_under_saturation`)
    at `cfg`'s width: 8 requests alternating alpha (weight 3) and beta
    (weight 1), 16-token prompts, 12 new tokens, max_batch 4,
    `tick_token_budget` 16.  Alpha's mean finish step must be below
    beta's, and both tenants' token counts equal."""
    import numpy as np
    from repro_torch.serve.engine import Request, ServingEngine
    from repro_torch.serve.sampling import SamplingParams

    eng = ServingEngine(cfg, params, device=dev, max_batch=4, max_seq=64,
                        page_size=16, tick_token_budget=16,
                        tenant_weights={"alpha": 3.0, "beta": 1.0})
    rng = np.random.default_rng(0)
    for uid in range(8):
        eng.submit(Request(
            uid=uid, prompt=rng.integers(1, cfg.vocab_size, 16)
            .astype(np.int32), tenant="alpha" if uid % 2 == 0 else "beta",
            sampling=SamplingParams(max_new_tokens=12)))
    finish: dict[int, int] = {}
    while eng.pending or eng.slots:
        eng.step()
        for r in eng.results:
            finish.setdefault(r.uid, eng.steps)
    if len(finish) != 8:
        fail(f"serve_front saturation: {len(finish)} of 8 finished")
    alpha = [finish[u] for u in range(8) if u % 2 == 0]
    beta = [finish[u] for u in range(8) if u % 2 == 1]
    tenants = eng.stats()["tenants"]
    if not statistics.mean(alpha) < statistics.mean(beta):
        fail(f"serve_front saturation: alpha finished at {alpha}, beta "
             f"at {beta}")
    if tenants["alpha"]["tokens"] != tenants["beta"]["tokens"]:
        fail(f"serve_front saturation: tenant tokens {tenants}")
    return {"finish_steps": {"alpha": alpha, "beta": beta},
            "tenants": tenants, "steps": eng.steps}


def phase_serve_front(torch, dev, card: str, cfg) -> dict:
    """internlm2-1.8b at full width and depth behind the network front,
    driven by `traffic_gen.run`'s two-tenant trace over HTTP/SSE on
    localhost (`FRONT_TRACE`, `FRONT_ENGINE`); the in-process replays
    run after the server stopped, on the default stream.  Gates: the
    trace's four, `FRONT_REPLAYS` replays with greedy and sampled among
    them, both aborts cancelled, no error frame or failed tick, the
    engine thread gone, the launches, and `front_saturation`.  Returns
    the launches."""
    from repro_torch.benchmarks import traffic_gen
    from repro_torch.models import registry

    free_card(torch)
    t0 = time.perf_counter()
    params = registry.get_family(cfg).init(0, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mods = kernel_modules()
    seen = {}

    def after_stop(srv):
        seen["launches"] = {n: m.launches for n, m in mods.items()}
        seen["stats"] = srv.llm.stats
        seen["threads_alive"] = [t.name for t in (srv._engine_thread,
                                                  srv._loop_thread)
                                 if t is not None and t.is_alive()]
        seen["tick_errors"] = list(srv.tick_errors)

    for m in mods.values():                          # count the main path
        m.launches = 0
    t1 = time.perf_counter()
    res = traffic_gen.run(**FRONT_TRACE, json_path=None, cfg=cfg,
                          params=params, device=dev,
                          identity_checks=FRONT_REPLAYS,
                          after_stop=after_stop, **FRONT_ENGINE)
    run_s = time.perf_counter() - t1
    st, gates = seen["stats"], res["gates"]
    if seen["tick_errors"]:
        fail(f"serve_front: a tick failed on the engine thread:\n"
             f"{seen['tick_errors'][0]}")
    if seen["threads_alive"]:
        fail(f"serve_front: {seen['threads_alive']} alive after stop()")
    if res["error_frames"]:
        fail(f"serve_front: error frames {res['error_frames']}")
    failed = [k for k in ("streams_complete", "token_identity",
                          "ttft_finite", "zero_leaked_pages")
              if not gates[k]]
    if failed:
        bad = [r for r in res["replays"] if not r["equal"]]
        fail(f"serve_front: gates {failed} failed ({gates}; replays "
             f"that differ: {bad})")
    temps = {r["temperature"] > 0 for r in res["replays"]}
    if gates["identity_checked"] < FRONT_REPLAYS or temps != {False, True}:
        fail(f"serve_front: replays {res['replays']} are not "
             f"{FRONT_REPLAYS} with greedy and sampled among them")
    rows = {r["tenant"]: r for r in res["rows"]}
    if set(rows) != {"alpha", "beta"} or not all(
            r["requests"] and r["ttft_p99_s"] is not None
            for r in rows.values()):
        fail(f"serve_front: a tenant never started: {res['rows']}")
    fe = res["counters"]["frontend"]
    if (fe["cancelled"] != 2 or st["cancellations"] != 2
            or not res["cancel_reclaim_s"] < float("inf")):
        fail(f"serve_front: aborts cancelled {fe['cancelled']} (engine "
             f"{st['cancellations']}), reclaim {res['cancel_reclaim_s']}")
    if st["pool"]["allocated_pages"] != st["pool"]["pinned_pages"]:
        fail(f"serve_front: pool {st['pool']} after the drain")
    want = expected_launches(cfg, st)
    if seen["launches"] != want:
        fail(f"serve_front: kernel launches {seen['launches']} != "
             f"expected {want}")
    t2 = time.perf_counter()
    saturation = front_saturation(torch, dev, cfg, params)
    saturation_s = time.perf_counter() - t2
    del params
    free_card(torch)
    tokens = st["tokens_out"]
    wall = res["trace"]["wall_s"]
    emit({"phase": "serve_front", "card": card, "arch": cfg.name,
          "layers": cfg.num_layers, "dtype": cfg.dtype, **FRONT_ENGINE,
          "tenant_weights": traffic_gen.TENANT_WEIGHTS,
          "trace": res["trace"], "ttft_slo_s": traffic_gen.TTFT_SLO_S,
          "tenants": res["rows"], "tenant_tokens": res["tenant_tokens"],
          "cancel_reclaim_s": res["cancel_reclaim_s"],
          "wall_s": wall, "tokens_out": tokens,
          "tokens_per_s": tokens / wall, "streams": res["streams"],
          "frontend": fe,
          "engine": {k: st[k] for k in ("admitted", "preemptions",
                                        "cancellations", "steps",
                                        "prefill_calls", "decode_calls",
                                        "prefill_tokens")},
          "replays": res["replays"], "gates": gates,
          "launches": {n: v for n, v in seen["launches"].items() if v},
          "saturation": saturation, "params_init_s": init_s,
          "run_s": run_s, "saturation_s": saturation_s,
          "phase_s": time.perf_counter() - t0})
    return seen["launches"]


# ---------------------------------------------------- phase 7b: serve_tools

TOOLS_SWEEPS = dict(sampling=True, quant=True, host_tier=True,
                    prefix_trace=True, speculate=SPEC_K, draft="self:1")
TOOLS_STREAM = dict(requests=8, prompt_lo=16, prompt_hi=511, max_new=32,
                    max_batch=8, max_seq=1024)
TOOLS_DECODE_MANY = dict(prompt=128, steps=64, temperature=0.8)
# paged_kernel_bench's bf16 rows at internlm2-1.8b's width:
# (dtype, hq, hkv, d, page, max_pages, k of the verify window)
TOOLS_BENCH_GEOMS = (("bf16", 16, 8, 128, 16, 64, SPEC_K),)


class EngineLedger:
    """Every engine `serve_throughput` builds while the ledger is open,
    in order: its config, its final stats, the kernel launches it made
    and `expected_launches` of its stats.  The tools build their engines
    one after another, so an engine's launches are the counters'
    growth from its construction to the next engine's (or the ledger's
    close); the previous engine is released before the next one
    allocates."""

    def __init__(self, torch, module):
        self.torch, self.module = torch, module
        self.mods = kernel_modules()
        self.entries: list[dict] = []
        self._open = None

    def _counts(self) -> dict:
        return {name: m.launches for name, m in self.mods.items()}

    def _close(self) -> None:
        if self._open is None:
            return
        eng, start = self._open
        self._open = None
        now, st = self._counts(), eng.stats()
        self.entries.append({
            "arch": eng.cfg.name, "family": eng.cfg.family,
            "layout": st["layout"], "dtype": eng.cfg.dtype,
            "kv_dtype": eng.cfg.kv_dtype, "stats": st,
            "launches": {n: now[n] - start[n] for n in now},
            "want": expected_launches(eng.cfg, st, eng.draft)})
        del eng
        free_card(self.torch)

    def __enter__(self):
        ledger, base = self, self.module.ServingEngine
        self._base = base

        class Counted(base):
            def __init__(self, *args, **kw):
                ledger._close()
                start = ledger._counts()
                super().__init__(*args, **kw)
                ledger._open = (self, start)
        self.module.ServingEngine = Counted
        return self

    def __exit__(self, exc_type, *exc):
        self.module.ServingEngine = self._base
        if exc_type is None:
            self._close()
        self._open = None

    def check(self, phase: str) -> dict:
        """Fail unless every engine launched what its stats predict and
        left no page allocated beyond the pinned (cached) ones; returns
        the launches summed over the engines."""
        total = {name: 0 for name in self.mods}
        for e in self.entries:
            pool = e["stats"]["pool"]
            if pool["allocated_pages"] != pool["pinned_pages"]:
                fail(f"{phase}: {e['arch']} ({e['layout']}) leaked pages: "
                     f"{pool}")
            if e["launches"] != e["want"]:
                fail(f"{phase}: {e['arch']} ({e['layout']}, {e['dtype']}) "
                     f"kernel launches {e['launches']} != expected "
                     f"{e['want']}")
            for name, n in e["launches"].items():
                total[name] += n
        return total


def tools_stream(cfg):
    """`TOOLS_STREAM`'s requests: 8 prompts of 16-511 tokens from
    `np.random.default_rng(0)`, 32 new tokens each."""
    import numpy as np
    from repro_torch.serve import Request

    ts = TOOLS_STREAM
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(
                0, cfg.vocab_size,
                int(rng.integers(ts["prompt_lo"], ts["prompt_hi"] + 1)))
            .astype(np.int32), max_new_tokens=ts["max_new"])
            for i in range(ts["requests"])]


def tools_layouts(torch, dev, ST, cfg, params, reruns: int) -> dict:
    """`serve_throughput._row` over `tools_stream` at `cfg`, `reruns`
    times, with each `_run`'s output kept: returns the rows, the runs by
    layout and the engines' ledger."""
    ts = TOOLS_STREAM
    reqs = tools_stream(cfg)
    runs, base_run = {"contiguous": [], "paged": []}, ST._run

    def kept_run(cfg_, params_, layout, *args, **kw):
        out = base_run(cfg_, params_, layout, *args, **kw)
        runs[layout].append(out)
        return out
    ST._run = kept_run
    try:
        with EngineLedger(torch, ST) as ledger:
            rows = [ST._row(cfg, params, reqs, ts["max_batch"],
                            ts["max_seq"], device=dev)
                    for _ in range(reruns)]
    finally:
        ST._run = base_run
    return {"rows": rows, "runs": runs, "ledger": ledger}


def mixed_pages_check(torch, dev) -> list:
    """The paged kernels with f32 queries over bf16 pages (an f32 model
    over a `kv_dtype="bf16"` arena, the CUDA-core design) against their
    plain versions at the dense path's shapes: decode and a 64-row
    prefill chunk, which round as the plain version does (bf16's bound,
    and at most `MAX_DIFFERENT_SHARE` of the elements differing), and
    decode's partials over a table with holes (p in f32: f32's bound)."""
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_prefill import ops as pp
    from repro_torch.kernels.tolerance import (MAX_DIFFERENT_SHARE,
                                               different_share)

    kb = KernelBench(torch, dev)
    k, v, _, _ = kb.pages(torch.bfloat16)
    rows = []

    def held(name, got, want):
        check(name, got, want, torch.bfloat16, rows)
        share = different_share(got, want)
        rows[-1].update(different_share=share,
                        max_different_share=MAX_DIFFERENT_SHARE)
        if not share <= MAX_DIFFERENT_SHARE:
            fail(f"kernel {name}: {share} of the elements differ from the "
                 f"plain version's (at most {MAX_DIFFERENT_SHARE})")

    q = kb.q((kb.b, kb.hq, kb.d), torch.float32)
    held("f32 q / bf16 pages decode",
         pa.paged_decode_attention(q, k, v, kb.bt, kb.positions),
         pa.paged_decode_attention_plain(q, k, v, kb.bt, kb.positions))
    kw = dict(page_positions=kb.holes(), partials=True)
    check("f32 q / bf16 pages decode holes+partials",
          pa.paged_decode_attention(q, k, v, kb.bt, kb.positions, **kw),
          pa.paged_decode_attention_plain(q, k, v, kb.bt, kb.positions, **kw),
          torch.float32, rows)
    c = 64
    qc = kb.q((kb.b, c, kb.hq, kb.d), torch.float32)
    start = torch.clamp(kb.positions - c + 1, min=0).to(torch.int32)
    clen = torch.full_like(start, c)
    held("f32 q / bf16 pages prefill c64",
         pp.paged_prefill_attention(qc, k, v, kb.bt, start, clen),
         pp.paged_prefill_attention_plain(qc, k, v, kb.bt, start, clen))
    return rows


def decode_many_launches(cfg, steps: int) -> dict:
    """Launches of one batch-1 prefill and `decode_many(steps)` on the
    contiguous cache of a dense `cfg` in bf16: flash once per layer,
    split-KV decode once per layer a step, nothing else."""
    want = {name: 0 for name in kernel_modules()}
    want.update(flash_attention=cfg.num_layers,
                decode_attention=steps * cfg.num_layers)
    return want


def tools_decode_many(torch, dev, cfg, params) -> dict:
    """`make_serve_fns`'s `decode_many` at `cfg` (contiguous, batch 1,
    max_seq 1024) against the engine's greedy stream at max_batch 1 on
    the same prompt, a sampled run repeated and leaving the greedy
    tokens, and the launches of the greedy run: flash once per layer for
    the prefill, split-KV decode once per layer a step.  Both rates are
    of the decode steps alone: `decode_many` from its first token in,
    the engine from its first token's event to its last."""
    import numpy as np
    from repro_torch.serve import Request, ServingEngine, TokenEvent
    from repro_torch.serve import prng
    from repro_torch.serve.serve_step import init_cache, make_serve_fns

    dm = TOOLS_DECODE_MANY
    ms = TOOLS_STREAM["max_seq"]
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, dm["prompt"]).astype(np.int32)
    eng = ServingEngine(cfg, params, device=dev, max_batch=1, max_seq=ms,
                        layout="contiguous")
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=dm["steps"] + 1))
    engine_tokens, stamps = [], []
    for ev in eng.stream():
        if isinstance(ev, TokenEvent):
            engine_tokens.append(ev.token)
            stamps.append(time.perf_counter())
    engine_s = stamps[-1] - stamps[0]
    del eng
    free_card(torch)

    def once(temperature, key):
        prefill, _, decode_many = make_serve_fns(cfg, dev,
                                                 temperature=temperature)
        cache = init_cache(cfg, 1, ms, device=dev)
        cache, logits = prefill(params, {"tokens": prompt[None]}, cache)
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cache, rest, key_out = decode_many(params, cache, first, key,
                                           dm["steps"])
        toks = [int(first[0])] + rest[0].tolist()   # the one read
        dt = time.perf_counter() - t1
        return toks, dt, key_out.tolist()

    (greedy, greedy_s, _), launches = count_path(
        lambda: once(0.0, prng.key(0, dev)))
    want = decode_many_launches(cfg, dm["steps"])
    if launches != want:
        fail(f"serve_tools decode_many: kernel launches {launches} != "
             f"expected {want}")
    if greedy != engine_tokens:
        same = sum(a == b for a, b in zip(greedy, engine_tokens))
        fail(f"serve_tools decode_many: greedy tokens differ from the "
             f"engine's at max_batch 1 ({same} of {len(greedy)} equal)")
    sampled = [once(dm["temperature"], prng.key(0, dev)) for _ in range(2)]
    if sampled[0][0] != sampled[1][0] or sampled[0][2] != sampled[1][2]:
        fail("serve_tools decode_many: a sampled rerun differs")
    if sampled[0][0] == greedy:
        fail(f"serve_tools decode_many: the sampled run (T "
             f"{dm['temperature']}) gave the greedy tokens")
    return {"prompt": dm["prompt"], "steps": dm["steps"],
            "launches": {n: v for n, v in launches.items() if v},
            "equal_to_engine": True,
            "decode_many_tokens_per_s": dm["steps"] / greedy_s,
            "engine_decode_tokens_per_s": dm["steps"] / engine_s,
            "sampled_tokens_per_s": dm["steps"] / sampled[0][1],
            "sampled_rerun_identical": True,
            "sampled_diverged_from_greedy": True,
            "key_out": sampled[0][2]}


def phase_serve_tools(torch, dev, card: str, dense) -> dict:
    """The serving tools on the card.  a: `serve_throughput.run` with
    every family and sweep at the reference's configurations (f32), then
    `paged_kernel_bench.run` (the reference's f32 geometries and bf16 at
    internlm2-1.8b's width), and the f32-query / bf16-page kernels
    against their plain versions.  b: the two layouts at internlm2-1.8b's
    full width and depth through `_row` (`TOOLS_STREAM`), bf16 twice
    (paged KV <= contiguous, each layout's rerun identical) and f32
    (identical greedy tokens in both layouts).  c: `decode_many` at full
    width against the engine.  Gates as documented at each step; the
    tools' timing verdicts are printed, not gated.  Returns the launches
    of the served runs."""
    from repro_torch.benchmarks import paged_kernel_bench as PKB
    from repro_torch.benchmarks import serve_throughput as ST
    from repro_torch.models import registry

    free_card(torch)
    t0 = time.perf_counter()
    # a. the reference's configurations, f32, on the tool's default
    # weights (the port's seeded init, drawn on the card)
    with EngineLedger(torch, ST) as ledger:
        res = ST.run(device=dev, **TOOLS_SWEEPS)
    tools_launches = ledger.check("serve_tools run")
    ta = time.perf_counter()
    bad = [f"{r['family']} b{r['batch']} s{r['max_seq']}"
           for r in res["rows"]
           if not (r["tokens_match"] and r["paged_kv_mb"] <= r["contig_kv_mb"])]
    q, tier, pre = res["quant"], res["host_tier"], res["prefix"]
    smp, spec = res["sampling"], res["speculative"]
    gates = {
        "rows": not bad,
        "quant": q["tokens_match"] and q["bytes_ratio"] <= 0.55,
        "host_tier": (tier["spills"] > 0 and tier["restores"] > 0
                      and tier["tokens_match"]),
        "prefix": (pre["cross_request_hits"] > 0 and pre["tokens_match"]
                   and pre["prefill_tokens_cached"]
                   < pre["prefill_tokens_cold"]),
        "sampling": smp["deterministic"] and smp["diverged_from_greedy"],
        "speculative": spec["tokens_match"] and spec["tokens_match_sampled"]}
    timing = {"prefix_steady_ttft_cached_below_cold":
              pre["steady_ttft_cached_s"] < pre["steady_ttft_cold_s"],
              "speculative_ratio_above_1": spec["speedup"] > 1.0}
    bench = PKB.run(dev, extra_geoms=TOOLS_BENCH_GEOMS)
    mixed = mixed_pages_check(torch, dev)
    tb = time.perf_counter()
    emit({"phase": "serve_tools", "part": "reference configs", "card": card,
          "rows": res["rows"], "quant": q, "host_tier": tier, "prefix": pre,
          "sampling": smp, "speculative": spec, "gates": gates,
          "timing_verdicts": timing, "ok_as_the_reference_judges": res["ok"],
          "engines": len(ledger.entries), "launches": tools_launches,
          "paged_kernel_bench": bench, "mixed_pages": mixed,
          "run_s": ta - t0, "bench_s": tb - ta})
    failed = [k for k, v in gates.items() if not v]
    if failed:
        fail(f"serve_tools: gates {failed} failed (rows {bad})")
    if not bench["ok"]:
        fail(f"serve_tools: paged_kernel_bench rows differ: "
             f"{[r['geom'] for r in bench['rows'] if not r['match']]}")

    # b. the layouts at full width and depth, bf16 (twice) then f32
    params = registry.get_family(dense).init(0, dense, dev)
    bf16 = tools_layouts(torch, dev, ST, dense, params, reruns=2)
    full_launches = bf16["ledger"].check("serve_tools full width bf16")
    row = bf16["rows"][0]
    if not row["paged_kv_mb"] <= row["contig_kv_mb"]:
        fail(f"serve_tools: paged KV {row['paged_kv_mb']} MB above "
             f"contiguous {row['contig_kv_mb']} MB")
    for layout, (run1, run2) in bf16["runs"].items():
        if run1["tokens"] != run2["tokens"]:
            fail(f"serve_tools: the bf16 {layout} rerun differs")
    c1, p1 = bf16["runs"]["contiguous"][0], bf16["runs"]["paged"][0]
    pairs = [(a, b) for uid in c1["tokens"]
             for a, b in zip(c1["tokens"][uid], p1["tokens"][uid])]
    share = sum(a == b for a, b in pairs) / len(pairs)
    del params
    free_card(torch)
    f32cfg = dense.replace(dtype="float32", param_dtype="float32")
    params = registry.get_family(f32cfg).init(0, f32cfg, dev)
    f32 = tools_layouts(torch, dev, ST, f32cfg, params, reruns=1)
    f32_launches = f32["ledger"].check("serve_tools full width f32")
    if not f32["rows"][0]["tokens_match"]:
        fail(f"serve_tools: f32 greedy tokens differ between the layouts "
             f"at full width: {f32['rows'][0]}")
    del params
    free_card(torch)
    tc = time.perf_counter()

    # c. decode_many at full width, bf16, contiguous
    params = registry.get_family(dense).init(0, dense, dev)
    many = tools_decode_many(torch, dev, dense, params)
    del params
    free_card(torch)
    td = time.perf_counter()

    for name, n in (*full_launches.items(), *f32_launches.items()):
        tools_launches[name] += n
    for name, n in many["launches"].items():
        tools_launches[name] += n
    emit({"phase": "serve_tools", "part": "full width", "card": card,
          "arch": dense.name, "layers": dense.num_layers,
          **TOOLS_STREAM, "page_size": 16,
          "bf16": {"rows": bf16["rows"],
                   "paged_tokens_per_s": [r["paged_tok_s"]
                                          for r in bf16["rows"]],
                   "contig_tokens_per_s": [r["contig_tok_s"]
                                           for r in bf16["rows"]],
                   "paged_kv_mb": row["paged_kv_mb"],
                   "contig_kv_mb": row["contig_kv_mb"],
                   "kv_ratio": row["kv_ratio"],
                   "share_equal_between_layouts": share,
                   "reruns_identical": True,
                   "launches": {n: v for n, v in full_launches.items() if v}},
          "f32": {"row": f32["rows"][0], "tokens_match": True,
                  "launches": {n: v for n, v in f32_launches.items() if v}},
          "decode_many": many,
          "layouts_s": tc - tb, "decode_many_s": td - tc,
          "phase_s": td - t0})
    return tools_launches


# -------------------------------------------- phase 7d: serve_sharded

SHARDS = 4                  # banks of the sharded arena
# the tier run's pool: small enough that preemption spills, shared by
# the single arena it is compared with
SHARD_TIER = dict(pool_pages=64, high_watermark=0.75, host_tier_pages=512)


def shard_bench(torch, dev, n=SHARDS, b=8, mp=64, page=16, hkv=8, d=128):
    """The kernel gate's banks at internlm2's width: n banks of pps + 1
    slots (each bank's null slot last, zeros) and a GLOBAL table over
    them (pool page g = bank g // pps, slot g % pps; the null id
    n * pps).  Row i's rotation is i % n: its logical page j comes from
    bank (rot + j) % n up to the page of its position; row 1 is idle
    (all null, position 0)."""
    g = torch.Generator(device="cpu").manual_seed(1)
    pps = b * mp // n
    positions = [1023, 0, 511, 17, 700, 64, 255, 999]
    idle = 1
    bt = torch.full((b, mp), n * pps, dtype=torch.int32)
    free = [torch.randperm(pps, generator=g).tolist() for _ in range(n)]
    for i in range(b):
        if i == idle:
            continue
        for j in range(positions[i] // page + 1):
            s = (i % n + j) % n
            bt[i, j] = s * pps + free[s].pop()
    banks = {}
    for name in ("k", "v"):
        x = torch.randn((n, pps + 1, page, hkv, d), generator=g)
        x[:, pps] = 0
        banks[name] = x
    return dict(n=n, b=b, mp=mp, page=page, hkv=hkv, d=d, pps=pps, idle=idle,
                bt=bt.to(dev), positions=torch.tensor(
                    positions, dtype=torch.int32, device=dev),
                banks={k: v.to(dev) for k, v in banks.items()})


# the sharded path's kernels by their names in a profiler trace
BANK_KERNELS = {"repro::dec_tc::decode_tc_kernel": "paged_decode_attention",
                "paged_decode_kernel": "paged_decode_attention",
                "prefill_tc_kernel": "paged_prefill_attention",
                "paged_prefill_kernel": "paged_prefill_attention",
                "combine_kernel": "combine_splits"}


def device_split(torch, fn, calls: int = 20) -> dict:
    """fn() `calls` times back to back under torch.profiler, per call:
    the host's seconds to the card's finish, the card's busy time, and
    each of the path's kernels' device time and launches
    (`BANK_KERNELS`; "other": PyTorch's own, the stacks and copies)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, busy = {}, 0.0
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        name = next((v for k, v in BANK_KERNELS.items() if k in e.key),
                    "other")
        got = kernels.setdefault(name, {"ms": 0.0, "launches": 0.0})
        got["ms"] += e.self_device_time_total / 1e3 / calls
        got["launches"] += e.count / calls
        busy += e.self_device_time_total / 1e3 / calls
    return {"wall_ms": 1e3 * wall / calls, "busy_ms": busy,
            "kernels": kernels}


def shard_kernel_gate(torch, dev, card: str) -> dict:
    """Rows 1 and 2 in partials mode on each bank's compacted walk,
    merged by the combine kernel, against the plain version over the
    whole global table (decode, prefill c 64, verify c 5; bf16 and f32;
    per element, `tolerance.py`), then timings at bf16: each bank's
    partials call at the compacted width ceil(max_pages / n), the
    combine kernel alone, the whole banked layer and the single-arena
    kernel over the same global table."""
    from repro_torch.kernels.decode_attention import ops as dk
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_prefill import ops as pp
    from repro_torch.models import layers as L
    from repro_torch.models.config import ModelConfig

    sb = shard_bench(torch, dev)
    n, b, page, hkv, d, pps = (sb[k] for k in ("n", "b", "page", "hkv", "d",
                                               "pps"))
    hq = 16
    bt, pos = sb["bt"], sb["positions"]
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = ModelConfig(name="gate", family="dense", num_layers=1,
                      d_model=hq * d, vocab_size=8, num_heads=hq,
                      num_kv_heads=hkv, head_dim=d, mem_axis="mem")
    gen = torch.Generator(device="cpu").manual_seed(2)

    def q_of(shape, dtype):
        return torch.randn(shape, generator=gen).to(dev).to(dtype)

    def flat(x):
        """The banks as one arena (the plain version's), null page last."""
        return torch.cat([x[:, :pps].reshape(n * pps, page, hkv, d),
                          torch.zeros((1, page, hkv, d), dtype=x.dtype,
                                      device=x.device)])

    # prefill rows end at each row's position; the idle row and, at
    # c 5, the rows that do not speculate carry 0
    clen_for = {64: [64, 0, 64, 18, 33, 1, 64, 40],
                5: [5, 0, 5, 5, 0, 5, 5, 5]}
    rows, keep = [], {}
    for qdt in (bf16, f32):
        kb = tuple(sb["banks"]["k"].to(qdt))
        vb = tuple(sb["banks"]["v"].to(qdt))
        kf, vf = flat(sb["banks"]["k"].to(qdt)), flat(sb["banks"]["v"].to(qdt))
        q = q_of((b, hq, d), qdt)
        got = L.run_paged_decode_attention(cfg, q, kb, vb, bt, pos)
        want = pa.paged_decode_attention_plain(q, kf, vf, bt, pos)
        torch.cuda.synchronize()
        err = check(f"sharded decode {qdt}, {n} banks", got,
                    want.reshape(b, hq * d), qdt, rows)
        if not bool(torch.isfinite(got).all()) or bool(got[sb["idle"]].any()):
            fail("serve_sharded: the idle row's merge is not finite zeros")
        keep[("decode", qdt)] = dict(q=q, kb=kb, vb=vb, kf=kf, vf=vf, err=err)
        for c, clen in clen_for.items():
            cl = torch.tensor(clen, dtype=torch.int32, device=dev)
            st = torch.clamp(pos + 1 - cl, min=0).to(torch.int32)
            qc = q_of((b, c, hq, d), qdt)
            got = L.run_paged_prefill_attention(cfg, qc, kb, vb, bt, st, cl)
            want = pp.paged_prefill_attention_plain(qc, kf, vf, bt, st, cl)
            torch.cuda.synchronize()
            err = check(f"sharded prefill c={c} {qdt}, {n} banks", got,
                        want.reshape(b, c, hq * d), qdt, rows)
            keep[("prefill", c, qdt)] = dict(q=qc, start=st, clen=cl,
                                             err=err)

    # ------------------------------------------- bf16 timings, bank 0
    dec = keep[("decode", bf16)]
    tables = L.shard_tables(cfg, bt, dec["kb"])
    lbt, ppos = tables.walks[0], tables.positions[0]
    elt = 2

    # bank 0's resident tokens each row sees, each read once
    tok = sum(min(page, int(pos[i]) - p + 1)
              for i in range(b)
              for p in ppos[i][ppos[i] < pa.POS_PAD].tolist()
              if p <= int(pos[i]))
    kv_bytes = 2 * tok * hkv * d * elt
    m_l_acc = b * hq * (d + 2) * 4
    part_args = (dec["q"], dec["kb"][0], dec["vb"][0], lbt, pos)
    part_kw = dict(page_positions=ppos, partials=True)
    flush_buf = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    flush = flush_buf.zero_
    timings = {}
    timings["decode partials, bank 0"] = dict(
        ms=time_ms(lambda: pa.paged_decode_attention(*part_args, **part_kw),
                   flush),
        plain_ms=time_ms(lambda: pa.paged_decode_attention_plain(
            *part_args, **part_kw), flush),
        library_ms=None, max_abs_err=dec["err"],
        bytes=kv_bytes + b * hq * d * elt + m_l_acc
        + 4 * int(((ppos < pa.POS_PAD).sum())),
        ops=4 * hq * d * tok, columns=lbt.shape[1])
    pre = keep[("prefill", 64, bf16)]
    pre_args = (pre["q"], dec["kb"][0], dec["vb"][0], lbt, pre["start"],
                pre["clen"])
    vis = 0
    for i in range(b):
        for p in ppos[i][ppos[i] < pa.POS_PAD].tolist():
            for r in range(int(pre["clen"][i])):
                qpos = int(pre["start"][i]) + r
                vis += max(0, min(page, qpos - p + 1))
    timings["prefill c=64 partials, bank 0"] = dict(
        ms=time_ms(lambda: pp.paged_prefill_attention(*pre_args, **part_kw),
                   flush),
        plain_ms=time_ms(lambda: pp.paged_prefill_attention_plain(
            *pre_args, **part_kw), flush),
        library_ms=None, max_abs_err=pre["err"],
        bytes=kv_bytes + b * 64 * hq * d * elt + 64 * m_l_acc,
        ops=4 * hq * d * vis, columns=lbt.shape[1])
    parts = [pa.paged_decode_attention(dec["q"], dec["kb"][s], dec["vb"][s],
                                       tables.walks[s], pos,
                                       page_positions=tables.positions[s],
                                       partials=True) for s in range(n)]
    mg, lg, ag = (torch.stack([p[i] for p in parts], dim=1).contiguous()
                  for i in range(3))
    comb = dk.combine_splits_kernel(mg, lg, ag, b, hq, d, bf16)
    comb_plain = dk.combine_splits(mg, lg, ag, b, hq, d, bf16)
    comb_err = check(f"combine of {n} banks' partials", comb, comb_plain,
                     bf16, rows)
    timings["combine_splits, 4 banks"] = dict(
        ms=time_ms(lambda: dk.combine_splits_kernel(mg, lg, ag, b, hq, d,
                                                    bf16), flush),
        plain_ms=time_ms(lambda: dk.combine_splits(mg, lg, ag, b, hq, d,
                                                   bf16), flush),
        library_ms=None, max_abs_err=comb_err,
        bytes=n * m_l_acc + b * hq * d * elt, ops=3 * n * b * hq * d)
    timings["decode, the whole banked layer"] = dict(
        ms=time_ms(lambda: L.run_paged_decode_attention(
            cfg, dec["q"], dec["kb"], dec["vb"], bt, pos, tables=tables),
            flush),
        single_arena_ms=time_ms(lambda: pa.paged_decode_attention(
            dec["q"], dec["kf"], dec["vf"], bt, pos), flush))
    # where the banked layer's time goes: the card's busy time by kernel
    # against the host's time per call, no flush (launches back to back)
    profiles = {
        "decode, banked layer": device_split(
            torch, lambda: L.run_paged_decode_attention(
                cfg, dec["q"], dec["kb"], dec["vb"], bt, pos,
                tables=tables)),
        "decode, one arena": device_split(
            torch, lambda: pa.paged_decode_attention(
                dec["q"], dec["kf"], dec["vf"], bt, pos)),
        "prefill c=64, banked layer": device_split(
            torch, lambda: L.run_paged_prefill_attention(
                cfg, pre["q"], dec["kb"], dec["vb"], bt, pre["start"],
                pre["clen"], tables=tables)),
        "prefill c=64, one arena": device_split(
            torch, lambda: pp.paged_prefill_attention(
                pre["q"], dec["kf"], dec["vf"], bt, pre["start"],
                pre["clen"]))}
    for t in timings.values():
        if "bytes" in t:
            t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["ops"])
    del flush_buf
    return {"cases": rows, "timings": timings, "profiles": profiles,
            "shapes": {"banks": n, "b": b, "hq": hq, "hkv": hkv, "d": d,
                       "page": page, "max_pages": sb["mp"],
                       "compacted_columns": -(-sb["mp"] // n),
                       "rotations": sorted({i % n for i in range(b)
                                            if i != sb["idle"]}),
                       "idle_row": sb["idle"]}}


def sharded_expected_launches(cfg, st, n: int) -> dict:
    """Launches of a served run on n banks: every attention layer of a
    step call walks every bank (row 1 for decode, row 2 for prefill and
    verify) and merges them with one combine launch."""
    want = expected_launches(cfg, st)
    verify = st.get("speculative", {}).get("verify_calls", 0)
    layers = cfg.num_layers
    want["paged_decode_attention"] = st["decode_calls"] * layers * n
    want["paged_prefill_attention"] = (st["prefill_calls"] + verify) \
        * layers * n
    want["combine_splits"] = (st["decode_calls"] + st["prefill_calls"]
                              + verify) * layers
    return want


def phase_serve_sharded(torch, dev, card: str, cfg) -> dict:
    """Near-memory sharded serving on the card (phase 7d of the module
    docstring).  Returns the launches of the first bf16 4-bank run."""
    from repro_torch.launch.mesh import make_mem_mesh
    from repro_torch.models import registry
    from repro_torch.serve.engine import ServingEngine

    t0 = time.perf_counter()
    gate = shard_kernel_gate(torch, dev, card)
    tg = time.perf_counter()
    mesh = make_mem_mesh(SHARDS, devices=None if dev.type == "cuda"
                         else [dev])
    mods = kernel_modules()
    ts = TOOLS_STREAM
    restored = []

    def serve(c, params, sharded, **kw):
        free_card(torch)
        eng = ServingEngine(c, params, device=dev, max_batch=ts["max_batch"],
                            max_seq=ts["max_seq"], page_size=16,
                            mesh=mesh if sharded else None, **kw)
        if sharded and kw.get("host_tier_pages"):
            base = eng._restore_from_tier

            def checked(req, free, pidx=0):
                verdict = base(req, free, pidx)
                if verdict == "restored":
                    s = next(s for s in eng.slots.values()
                             if s.request is req)
                    rot, pages = s.pages.rotation, s.pages.pages
                    if any(eng.pool.shard_of(p) != (rot + j) % SHARDS
                           for j, p in enumerate(pages)):
                        fail(f"serve_sharded: uid {req.uid} restored off "
                             f"its rotation {rot}'s banks")
                    restored.append((req.uid, rot, len(pages)))
                return verdict
            eng._restore_from_tier = checked
        for r in tools_stream(c):
            eng.submit(r)
        for m in mods.values():                  # count the main path
            m.launches = 0
        t = time.perf_counter()
        eng.run()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t
        launches = {name: m.launches for name, m in mods.items()}
        st = eng.stats()
        toks = {r.uid: r.tokens for r in eng.results}
        if len(toks) != ts["requests"] or any(
                len(v) != ts["max_new"] for v in toks.values()):
            fail(f"serve_sharded: streams did not finish: "
                 f"{ {u: len(v) for u, v in toks.items()} }")
        if st["pool"]["allocated_pages"]:
            fail(f"serve_sharded: {st['pool']['allocated_pages']} pages "
                 f"leaked")
        if sharded:
            want = sharded_expected_launches(c, st, SHARDS)
            if launches != want:
                fail(f"serve_sharded: kernel launches {launches} != "
                     f"expected {want}")
            banks = st["shard_kv_bytes"]
            if banks != [sum(banks) // SHARDS] * SHARDS:
                fail(f"serve_sharded: bank bytes {banks} are not total / "
                     f"{SHARDS}")
            peaks = [x["peak_allocated_pages"] for x in st["shards"]]
            if sum(p > 0 for p in peaks) < 3:
                fail(f"serve_sharded: banks used {peaks}")
            if dev.type == "cuda" and {w for _, w in st["prefill_shapes"]} \
                    != {eng.prefill_chunk}:
                fail(f"serve_sharded: prefill widths "
                     f"{st['prefill_shapes']} (one bucket on the card)")
        del eng
        return toks, wall, launches, st

    def share_equal(a, b_):
        pairs = [(x, y) for u in a for x, y in zip(a[u], b_[u])]
        return sum(x == y for x, y in pairs) / max(1, len(pairs))

    # bf16: the single arena and 4 banks in turns
    params = registry.get_family(cfg).init(0, cfg, dev)
    runs = []
    for sharded in (False, True, False, True):
        toks, wall, launches, st = serve(cfg, params, sharded)
        runs.append(dict(sharded=sharded, toks=toks, wall=wall,
                         launches=launches, st=st))
    single, banked = runs[0], runs[1]
    if runs[3]["toks"] != banked["toks"]:
        fail("serve_sharded: the 4-bank rerun's streams differ")
    tokens = banked["st"]["tokens_out"]
    bf16_out = {
        "tokens_per_s": [{"banks": SHARDS if r["sharded"] else 1,
                          "tokens_per_s": tokens / r["wall"]} for r in runs],
        "share_equal_single_arena": share_equal(single["toks"],
                                                banked["toks"]),
        # uid -> the first index where the 4-bank stream leaves the
        # single arena's (None: equal); later tokens follow from it
        "first_difference": {
            u: next((i for i, (x, y) in enumerate(zip(a, banked["toks"][u]))
                     if x != y), None)
            for u, a in single["toks"].items()},
        "shard_kv_bytes": banked["st"]["shard_kv_bytes"],
        "peak_pages_per_bank": [x["peak_allocated_pages"]
                                for x in banked["st"]["shards"]],
        "peak_kv_bytes": {"single": single["st"]["peak_kv_bytes"],
                          "banked": banked["st"]["peak_kv_bytes"]},
        "prefill_calls": banked["st"]["prefill_calls"],
        "decode_calls": banked["st"]["decode_calls"],
        "launches": {n: v for n, v in banked["launches"].items() if v}}
    launches_out = banked["launches"]
    del params, runs, single, banked
    tb = time.perf_counter()

    # f32: the 4-bank streams equal the single arena's, then the tier
    c32 = cfg.replace(dtype="float32", param_dtype="float32")
    params = registry.get_family(c32).init(0, c32, dev)
    f32_single = serve(c32, params, False)
    f32_banked = serve(c32, params, True)
    if f32_banked[0] != f32_single[0]:
        diff = [(u, next(i for i, (x, y) in enumerate(zip(a, f32_banked[0][u]))
                         if x != y))
                for u, a in f32_single[0].items() if a != f32_banked[0][u]]
        fail(f"serve_sharded: f32 streams on {SHARDS} banks differ from the "
             f"single arena's at (uid, index) {diff}")
    tier_single = serve(c32, params, False, **SHARD_TIER)
    tier_banked = serve(c32, params, True, **SHARD_TIER)
    ht = tier_banked[3]["host_tier"]
    if ht["spills"] < 1 or ht["restores"] < 1 or not restored:
        fail(f"serve_sharded: the tier run did not spill and restore: {ht}")
    if tier_banked[0] != tier_single[0]:
        fail("serve_sharded: the 4-bank tier run's streams differ from the "
             "single arena's on the same pool")
    del params
    free_card(torch)
    td = time.perf_counter()
    emit({"phase": "serve_sharded", "card": card, "arch": cfg.name,
          "layers": cfg.num_layers, "banks": SHARDS,
          "mesh": mesh.describe(), "page_size": 16,
          "max_batch": ts["max_batch"], "max_seq": ts["max_seq"],
          "requests": ts["requests"], "max_new": ts["max_new"],
          "kernel_gate": gate["cases"], "gate_shapes": gate["shapes"],
          "timing": "CUDA events, median of 30 after 5 warm-up, L2 flushed",
          "kernel_times": gate["timings"],
          "device_split": gate["profiles"],
          "bf16": bf16_out,
          "f32": {"streams_equal_single_arena": True,
                  "tokens_per_s": {"single": f32_single[3]["tokens_out"]
                                   / f32_single[1],
                                   "banked": f32_banked[3]["tokens_out"]
                                   / f32_banked[1]},
                  "launches": {n: v for n, v in f32_banked[2].items() if v}},
          "tier": {**SHARD_TIER, "host_tier": ht,
                   "preemptions": tier_banked[3]["preemptions"],
                   "restored": restored,
                   "peak_pages_per_bank": [
                       x["peak_allocated_pages"]
                       for x in tier_banked[3]["shards"]],
                   "streams_equal_single_arena": True},
          "gate_s": tg - t0, "bf16_s": tb - tg, "f32_s": td - tb,
          "phase_s": td - t0})
    return launches_out


def phase_spec_parity(torch, dev, cfg) -> None:
    """Speculative streams equal plain decode's on the card in f32 (the
    reference's contract): a 2-layer internlm2-width f32 target, four
    prompts (two sampled), k 1 and 4, drafts `self:1` and
    `mamba2-130m@reduced`."""
    import numpy as np
    from repro_torch.models import registry
    from repro_torch.serve.engine import Request, ServingEngine
    from repro_torch.serve.sampling import SamplingParams

    free_card(torch)
    params = registry.get_family(cfg).init(2, cfg, dev)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 17, 40, 64)]

    def run(**kw):
        eng = ServingEngine(cfg, params, device=dev, max_batch=4,
                            max_seq=256, page_size=16, **kw)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, sampling=SamplingParams(
                temperature=0.8 if i % 2 else 0.0, top_k=50 if i == 3 else 0,
                seed=i, max_new_tokens=16)))
        res = {r.uid: r.tokens for r in eng.run()}
        if eng.pool.stats().allocated_pages:
            fail("spec_parity: pages leaked")
        return res, eng.stats()

    want, _ = run()
    cases = []
    for draft in ("self:1", "mamba2-130m@reduced"):
        for k in (1, 4):
            got, st = run(speculate_k=k, draft=draft)
            if got != want:
                fail(f"spec_parity: k {k} draft {draft}: speculative "
                     f"streams {got} != plain {want}")
            cases.append({"k": k, "draft": draft,
                          "windows": st["speculative"]["windows"],
                          "verify_calls": st["speculative"]["verify_calls"],
                          "accept_rate": st["speculative"]["accept_rate"]})
    emit({"phase": "spec_parity", "config": "internlm2-1.8b width, 2 layers, "
          "f32", "streams": len(want), "tokens": sum(map(len, want.values())),
          "cases": cases, "equal_to_plain": True})


# ----------------------------------------------------- phase 13: parity

def phase_parity(torch, dev):
    from repro_torch.configs import get_arch
    from repro_torch.kernels.tolerance import worst_ratio
    from repro_torch.models import transformer

    cfg = get_arch("internlm2-1.8b").model.replace(
        num_layers=2, dtype="float32", param_dtype="float32")
    params = transformer.init(1, cfg, dev)

    cpu = torch.device("cpu")
    params_cpu = tree_to(params, cpu)
    page, P, mp, b, c = 16, 32, 8, 4, 16
    g = torch.Generator().manual_seed(3)
    bt = torch.full((b, mp), P, dtype=torch.int32)
    perm = torch.randperm(P, generator=g).to(torch.int32)
    for i, n in enumerate((2, 1, 3, 0)):
        bt[i, :n] = perm[4 * i:4 * i + n]
    start = torch.tensor([0, 0, 16, 0], dtype=torch.int32)
    clen = torch.tensor([16, 9, 5, 0], dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (b, c), generator=g,
                           dtype=torch.int32)
    positions = torch.tensor([16, 9, 21, 0], dtype=torch.int32)
    dec_tokens = torch.randint(0, cfg.vocab_size, (b,), generator=g,
                               dtype=torch.int32)
    out = []
    for where, p in ((dev, params), (cpu, params_cpu)):
        arena = transformer.init_paged_cache(cfg, P + 1, page, device=where)
        with torch.inference_mode():
            arena, lp = transformer.paged_prefill(
                p, cfg, {"tokens": tokens.to(where)}, arena, bt.to(where),
                start.to(where), clen.to(where))
            arena, ld = transformer.paged_decode_step(
                p, cfg, arena, bt.to(where), positions.to(where),
                dec_tokens.to(where))
        out.append((lp.cpu(), ld.cpu(),
                    {k: v[:, :P].cpu() for k, v in arena.items()}))
    (lp_g, ld_g, ar_g), (lp_c, ld_c, ar_c) = out
    rows = clen > 0          # inert rows' logits are garbage by contract
    act = positions > 0
    # f32 products of widths 2048 and 8192, summed in another order on
    # each side; per element along each row, as for the kernels
    rtol, atol = 1e-3, 1e-3
    res = {"prefill_logits": worst_ratio(lp_g[rows], lp_c[rows], rtol, atol),
           "decode_logits": worst_ratio(ld_g[act], ld_c[act], rtol, atol),
           **{f"arena_{k}": worst_ratio(ar_g[k], ar_c[k], rtol, atol)
              for k in ar_c}}
    emit({"phase": "parity", "config": "internlm2-1.8b width, 2 layers, f32",
          "rtol": rtol, "atol_x_row_max": atol,
          "max_abs_err": {k: v[0] for k, v in res.items()},
          "worst_err_over_bound": {k: v[1] for k, v in res.items()}})
    for k, (e, r) in res.items():
        if not r <= 1.0:
            fail(f"card vs CPU {k}: err {e}, err / bound {r}")


def phase_parity_family(torch, dev, cfg, label: str, base: int = 0):
    """One paged prefill chunk from position `base` (row 1 from 0), a
    second continuing row 0 (row 1 inert), and one decode step, on the
    card and on the CPU; logits, pages and per-slot state held by the
    per-element rule.  A vlm's chunks carry a patch plane: with `base`
    4 short of its `num_patches`, row 0's first chunk crosses from the
    image rows into the text (row 0's pages below `base` hold zeros on
    both sides)."""
    from repro_torch.kernels.tolerance import worst_ratio
    from repro_torch.models import registry

    fam = registry.get_family(cfg)
    free_card(torch)
    params = fam.init(1, cfg, dev)
    cpu = torch.device("cpu")

    params_cpu = tree_to(params, cpu)
    page, b, c = 16, 2, 8
    g = torch.Generator().manual_seed(4)
    n0 = (base + 2 * c) // page + 1          # row 0's pages, decode included
    mp, P = max(4, n0), max(8, n0 + 2)
    bt = torch.full((b, mp), P, dtype=torch.int32)
    bt[0, :n0] = torch.tensor([3, 6] if n0 == 2 else range(2, 2 + n0),
                              dtype=torch.int32)
    bt[1, :1] = torch.tensor([1], dtype=torch.int32)
    chunks = [(torch.tensor([base, 0], dtype=torch.int32),
               torch.tensor([8, 5], dtype=torch.int32)),
              (torch.tensor([base + 8, 5], dtype=torch.int32),
               torch.tensor([8, 0], dtype=torch.int32))]
    tokens = [torch.randint(0, cfg.vocab_size, (b, c), generator=g,
                            dtype=torch.int32) for _ in chunks]
    planes = [torch.randn(b, c, cfg.frontend_dim, generator=g)
              if cfg.frontend == "patch" else None for _ in chunks]
    positions = torch.tensor([base + 16, 5], dtype=torch.int32)
    dec_tokens = torch.randint(0, cfg.vocab_size, (b,), generator=g,
                               dtype=torch.int32)
    out = []
    for where, prm in ((dev, params), (cpu, params_cpu)):
        arena = fam.init_paged_cache(cfg, P + 1, page, max_batch=b,
                                     device=where)
        logits = []
        with torch.inference_mode():
            for (start, clen), tok, plane in zip(chunks, tokens, planes):
                chunk = {"tokens": tok.to(where)}
                if plane is not None:
                    chunk["patches"] = plane.to(where)
                arena, lg = fam.paged_prefill(
                    prm, cfg, chunk, arena, bt.to(where),
                    start.to(where), clen.to(where))
                logits.append(lg.cpu()[clen > 0])
            arena, ld = fam.paged_decode_step(
                prm, cfg, arena, bt.to(where), positions.to(where),
                dec_tokens.to(where))
            logits.append(ld.cpu())
        out.append((logits, {k: (v[:, :P] if k in ("k", "v") else v).cpu()
                             for k, v in arena.items()}))
    del params, params_cpu
    (lg_g, ar_g), (lg_c, ar_c) = out
    # An SSM state row (one head's channel p over its n state entries)
    # is sum_j w_j x_j[p] B_j: where x[p] is near zero the row is tiny,
    # while the error x_j[p] carries from the projection feeding it is
    # on the scale of the whole head.  So the ssm leaf's "row" is each
    # head's (p, n) state, flattened.
    for ar in (ar_g, ar_c):
        if "ssm" in ar:
            ar["ssm"] = ar["ssm"].flatten(-2)
    rtol, atol = 1e-3, 1e-3
    res = {**{f"logits_{i}": worst_ratio(a, b_, rtol, atol)
              for i, (a, b_) in enumerate(zip(lg_g, lg_c))},
           **{f"arena_{k}": worst_ratio(ar_g[k], ar_c[k], rtol, atol)
              for k in ar_c}}
    emit({"phase": "parity", "config": label,
          "rtol": rtol, "atol_x_row_max": atol,
          "max_abs_err": {k: v[0] for k, v in res.items()},
          "worst_err_over_bound": {k: v[1] for k, v in res.items()}})
    for k, (e, r) in res.items():
        if not r <= 1.0:
            fail(f"{label}: card vs CPU {k}: err {e}, err / bound {r}")


def phase_parity_contiguous(torch, dev, cfg, label: str, lens, S: int):
    """A family's contiguous path on the card (kernels) and on the CPU
    (the kernels' plain versions): batch=1 prefills of prompts of `lens`
    tokens written into rows 0 and 1 of a 3-row cache of `S` rows, row
    2 idle two short of S, then three decode steps, so an attention
    cache's row 2 writes clamp at S - 1; logits and every cache leaf
    held by the per-element rule, `pos` exactly.  Returns the kernel
    launches of the run (counted from 0), after checking them against
    `expected_launches`."""
    from repro_torch.kernels.tolerance import worst_ratio
    from repro_torch.models import registry
    from repro_torch.serve.kv_cache import clear_slot, slot_view

    free_card(torch)
    fam = registry.get_family(cfg)
    params = fam.init(1, cfg, dev)
    cpu = torch.device("cpu")

    params_cpu = tree_to(params, cpu)
    b = 3
    g = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g,
                             dtype=torch.int32) for n in lens]
    dec_tokens = torch.randint(0, cfg.vocab_size, (3, b), generator=g,
                               dtype=torch.int32)
    ax = fam.cache_axes()
    out = []
    mods = kernel_modules()
    for m in mods.values():                          # count the card's run
        m.launches = 0
    for where, prm in ((dev, params), (cpu, params_cpu)):
        cache = fam.init_cache(cfg, b, S, device=where)
        logits = []
        with torch.inference_mode():
            for slot, tok in enumerate(prompts):
                clear_slot(cache, slot, ax)
                _, lg = fam.prefill(prm, cfg, {"tokens": tok[None].to(where)},
                                    slot_view(cache, slot, ax))
                logits.append(lg.cpu())
            cache["pos"][2] = S - 2
            for t in range(3):
                cache, ld = fam.decode_step(prm, cfg, cache,
                                            dec_tokens[t].to(where))
                logits.append(ld.cpu())
        out.append((logits, {k: v.cpu() for k, v in cache.items()}))
        if where == dev:
            launches = {name: m.launches for name, m in mods.items()}
    del params, params_cpu
    want = expected_launches(cfg, {"prefill_calls": len(lens),
                                   "decode_calls": 3,
                                   "layout": "contiguous"})
    if launches != want:
        fail(f"{label}: kernel launches {launches} != expected {want}")
    (lg_g, c_g), (lg_c, c_c) = out
    if not torch.equal(c_g.pop("pos"), c_c.pop("pos")):
        fail(f"{label}: card vs CPU pos differ")
    for c in (c_g, c_c):          # one SSM head's (p, n) state is a row,
        if "ssm" in c:            # as in phase_parity_family
            c["ssm"] = c["ssm"].flatten(-2)
    rtol, atol = 1e-3, 1e-3
    res = {**{f"logits_{i}": worst_ratio(a, b_, rtol, atol)
              for i, (a, b_) in enumerate(zip(lg_g, lg_c))},
           **{f"cache_{k}": worst_ratio(c_g[k], c_c[k], rtol, atol)
              for k in c_c}}
    emit({"phase": "parity", "config": label, "launches": launches,
          "rtol": rtol, "atol_x_row_max": atol,
          "max_abs_err": {k: v[0] for k, v in res.items()},
          "worst_err_over_bound": {k: v[1] for k, v in res.items()}})
    for k, (e, r) in res.items():
        if not r <= 1.0:
            fail(f"{label}: card vs CPU {k}: err {e}, err / bound {r}")
    return launches


# ------------------------------------------------- phase 13b: training

TRAIN_SEED = 24
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM = 8, 2048, 2
TRAIN_WARMUP_STEPS, TRAIN_TIMED_STEPS = 1, 3
# kernel path vs the plain attention oracle, per gradient leaf: relative
# L2 error.  f32: the same sums in other orders (the flash kernels' tiles
# against one masked softmax), ~1e-6 and below; bf16: the kernel rounds P
# and dS to bf16 for its products where autograd over the plain version
# keeps the backward in f32, and the difference passes through two layers
# of bf16 activations.
TRAIN_PARITY_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 5e-2)}


class plain_attention:
    """Within the block, `layers.run_attention` on the card computes
    `flash_attention_plain` (autograd through plain torch): the explicit
    oracle the kernel path is held against, never a path of the port."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops as fk
        from repro_torch.models import layers
        self.layers, self.saved = layers, layers.run_attention
        layers.run_attention = lambda cfg, q, k, v, *, q_offset=0: \
            fk.flash_attention_plain(q, k, v, causal=cfg.causal,
                                     q_offset=q_offset)
        return self

    def __exit__(self, *exc):
        self.layers.run_attention = self.saved
        return False


def _train_opt(total_steps: int):
    """AdamW at the reference's default peak lr (3e-4), one warm-up step
    (lr 0 at step 0, as the reference's schedule gives)."""
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    return make_optimizer(OptimizerConfig(
        name="adamw", peak_lr=3e-4, warmup_steps=1, total_steps=total_steps))


def phase_train_parity(torch, dev, dense):
    """internlm2-1.8b width, 2 layers: the loss and gradients of one
    training step (`make_grad_fn`, what `make_train_step` clips and
    applies) with grad_accum 2 through the flash kernels, held against
    the same with attention through the plain version; loss and every
    gradient leaf (relative L2), in f32 and bf16."""
    from repro_torch.data import DataConfig, make_source
    from repro_torch.train import train_step as TS
    from repro_torch.utils.tree import tree_flatten_with_names

    out = {}
    for dtype in ("float32", "bfloat16"):
        free_card(torch)
        cfg = dense.replace(num_layers=2, dtype=dtype, param_dtype=dtype,
                            remat="dots", logits_chunk=128)
        batch = TS.batch_to(make_source(DataConfig(
            source="markov", seq_len=256, global_batch=4, seed=TRAIN_SEED),
            cfg).batch_at(0), dev)
        runs = []
        grad_fn = TS.make_grad_fn(cfg, grad_accum=2)
        for oracle in (False, True):
            state = TS.init_train_state(cfg, _train_opt(10),
                                        seed=TRAIN_SEED, device=dev)
            with plain_attention() if oracle else contextlib.nullcontext():
                loss, grads = grad_fn(state.params, batch)
            runs.append((float(loss), {
                n: g.float() for n, g in tree_flatten_with_names(grads)}))
            del state, loss, grads
        (lk, gk), (lp, gp) = runs
        rtol_loss, rel_l2 = TRAIN_PARITY_TOL[dtype]
        errs = {n: float((gk[n] - gp[n]).norm() / gp[n].norm().clamp_min(
            1e-30)) for n in gp}
        worst = max(errs, key=errs.get)
        out[dtype] = {"loss_kernel": lk, "loss_plain": lp,
                      "loss_rel_err": abs(lk - lp) / abs(lp),
                      "grad_rel_l2": errs, "worst_leaf": worst,
                      "loss_rtol": rtol_loss, "grad_rel_l2_bound": rel_l2}
        if not abs(lk - lp) <= rtol_loss * abs(lp):
            fail(f"train_parity {dtype}: loss {lk} vs plain {lp}")
        if not errs[worst] <= rel_l2:
            fail(f"train_parity {dtype}: gradient {worst} relative L2 "
                 f"error {errs[worst]} > {rel_l2}")
        del runs, gk, gp
    emit({"phase": "train_parity",
          "config": "internlm2-1.8b width, 2 layers, remat dots, "
                    "logits_chunk 128, 4 x 256 tokens, grad_accum 2",
          **out})


def expected_train_launches(cfg, steps: int, grad_accum: int) -> dict:
    """Kernel launches of `steps` training steps: per microbatch and
    layer, each forward kernel of the layer once, again in the backward
    where the remat policy recomputes the layer ("full" and "dots": no
    kernel's output is a projection `_save_dots` keeps), and each
    backward kernel once.  Attention (dense and MoE: every layer; hybrid:
    each group's shared block, num_layers // shared_attn_period): the
    flash forward and its backward; MoE under "grouped": three grouped
    products and their backwards; ssm and hybrid (every Mamba layer)
    under "pallas": the SSD kernel and its backward; no other kernel."""
    mbs = steps * grad_accum
    again = 1 if cfg.remat == "none" else 2
    attn = {"hybrid": cfg.num_layers // max(1, cfg.shared_attn_period),
            "ssm": 0}.get(cfg.family, cfg.num_layers)
    want = {name: 0 for name in kernel_modules()}
    want["flash_attention"] = mbs * attn * again
    want["flash_attention_backward"] = mbs * attn
    if cfg.family == "moe" and cfg.moe_dispatch == "grouped":
        want["grouped_matmul"] = 3 * mbs * cfg.num_layers * again
        want["grouped_matmul_backward"] = 3 * mbs * cfg.num_layers
    if cfg.family in ("ssm", "hybrid") and cfg.ssd_impl == "pallas":
        want["ssd_intra_chunk"] = mbs * cfg.num_layers * again
        want["ssd_intra_chunk_backward"] = mbs * cfg.num_layers
    return want


def run_steps(torch, step, state, batches):
    """(state, losses, grad norms, seconds) of one step per batch, each
    timed on the host clock to a synchronise."""
    losses, norms, secs = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms, secs


# the port's kernels in a profile, by the C++ namespace of their source
PORT_KERNEL_NAMESPACES = {
    "repro_ssdb::": "ssd_intra_chunk_backward", "repro_ssd::": "ssd_intra_chunk",
    "repro_fab::": "flash_attention_backward", "repro_fa::": "flash_attention",
    "repro_gmb::": "grouped_matmul_backward", "repro_gm::": "grouped_matmul"}


def profiled_step(torch, step, state, batch):
    """One step under torch.profiler: (state, its metrics, seconds, the
    device's busy seconds, the kernels that take the most device time,
    and the device time and launches of each of the port's kernels that
    ran, `PORT_KERNEL_NAMESPACES`; the grouped backward's time also by
    pass, checkout_ab.py's `GROUPED_BWD_PASSES`).  The profiler records
    the device's activity only: every number here is read from it, and
    the host's op events cost its processing over a minute for a
    step of ~60k launches (zamba2-2.7b at full depth, PR 36)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.benchmarks.checkout_ab import GROUPED_BWD_PASSES
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in dev_events)
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:12]
    port = {}
    for e in dev_events:
        for ns, name in PORT_KERNEL_NAMESPACES.items():
            if ns in e.key:
                got = port.setdefault(name, {"ms": 0.0, "calls": 0})
                got["ms"] += e.self_device_time_total / 1e3
                got["calls"] += e.count
                if name == "grouped_matmul_backward":
                    # its passes: dY rounded, dX, dW
                    part = next((p for k, p in GROUPED_BWD_PASSES
                                 if k in e.key), "other")
                    split = got.setdefault("passes_ms", {})
                    split[part] = split.get(part, 0.0) \
                        + e.self_device_time_total / 1e3
    return state, m, prof_s, busy_us / 1e6, [
        {"name": e.key[:100], "ms": e.self_device_time_total / 1e3,
         "calls": e.count} for e in top], port


def first_loss(cfg) -> float:
    """The loss a random init starts at: logits h . w with |h|^2 = d (the
    final norm) and w ~ N(0, 0.02^2), so the CE is ln V plus half their
    variance; MoE adds per layer its router loss, the load balance near
    router_aux_coef and the z-loss of router logits of that variance."""
    import math
    var = 0.02 ** 2 * cfg.d_model
    loss = math.log(cfg.vocab_size) + var / 2
    if cfg.family == "moe":
        lse = math.log(cfg.num_experts) + var / 2
        loss += cfg.num_layers * (cfg.router_aux_coef
                                  + cfg.router_z_coef * lse ** 2)
    return loss


def phase_train(torch, dev, card: str, dense):
    """internlm2-1.8b at full width and depth: bf16 params, AdamW, remat
    "dots", logits_chunk 512, global batch 8 x 2048 in 2 microbatches of
    MarkovLM data from the seed.  One warm-up step, three timed steps,
    a checkpoint of the state, one more step (profiled: the device's
    busy share), then the state restored from the checkpoint and that
    step again: the same loss.  Returns the kernel launches of the run
    (counted from 0), held against `expected_train_launches`."""
    import math
    import shutil
    from repro_torch.data import DataConfig, make_source
    from repro_torch.train import train_step as TS
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.utils.tree import tree_num_params

    free_card(torch)
    cfg = dense
    steps_total = TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS + 2
    opt = _train_opt(100)
    source = make_source(DataConfig(
        source="markov", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=TRAIN_SEED), cfg)
    batches = [TS.batch_to(source.batch_at(i), dev)
               for i in range(TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS + 1)]
    step = TS.make_train_step(cfg, opt, grad_accum=TRAIN_ACCUM)
    mods = kernel_modules()
    for m in mods.values():
        m.launches = 0
    state = TS.init_train_state(cfg, opt, seed=TRAIN_SEED, device=dev)
    n_params = tree_num_params(state.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, losses, norms, secs = run_steps(torch, step, state, batches[:-1])
    peak = torch.cuda.max_memory_allocated()
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt_dir), keep=1)
    t0 = time.perf_counter()
    mgr.save(state, state.step)           # host snapshot now, files async
    snapshot_s = time.perf_counter() - t0
    mgr.wait()               # the writer thread would share the host below
    write_s = time.perf_counter() - t0 - snapshot_s
    last = batches[-1]
    state, m, prof_s, busy_s, top_kernels, port_kernels = profiled_step(
        torch, step, state, last)
    loss_direct = float(m["loss"])
    like = TS.state_like(state)
    del state, m
    free_card(torch)
    t0 = time.perf_counter()
    state, manifest = TS.restore_train_state(mgr, like, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    state, m = step(state, last)
    loss_restored = float(m["loss"])
    launches = {name: mm.launches for name, mm in mods.items()}
    ckpt_bytes = sum(f.stat().st_size for f in ckpt_dir.rglob("*")
                     if f.is_file())
    del state, m, batches
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    free_card(torch)
    timed = secs[TRAIN_WARMUP_STEPS:]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    want_first = first_loss(cfg)
    emit({"phase": "train", "card": card,
          "config": f"{cfg.name}, {cfg.num_layers} layers, bf16, AdamW, "
                    f"remat {cfg.remat}, logits_chunk {cfg.logits_chunk}, "
                    f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_ACCUM} "
                    f"microbatches, MarkovLM seed {TRAIN_SEED}",
          "params": n_params, "losses": losses, "grad_norms": norms,
          "ln_vocab": math.log(cfg.vocab_size),
          "expected_first_loss": want_first, "step_s": secs,
          "tokens_per_s": tokens * len(timed) / sum(timed),
          "max_memory_allocated": peak,
          "profiled_step_s": prof_s, "device_busy_s": busy_s,
          "device_busy_share": busy_s / prof_s,
          "top_device_kernels": top_kernels, "port_kernels": port_kernels,
          "checkpoint": {"step": manifest["step"], "bytes": ckpt_bytes,
                         "host_snapshot_s": snapshot_s,
                         "write_s": write_s,
                         "restore_s": restore_s,
                         "loss_direct": loss_direct,
                         "loss_restored": loss_restored},
          "launches": launches})
    if not all(math.isfinite(x) for x in losses + norms):
        fail(f"train: non-finite loss or grad norm {losses} {norms}")
    if abs(losses[0] - want_first) > 0.1:
        fail(f"train: first loss {losses[0]} not near ln V + 0.02^2 d / 2 "
             f"= {want_first}")
    if not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall: {losses}")
    if loss_restored != loss_direct:
        fail(f"train: the step after the checkpoint round trip gives loss "
             f"{loss_restored}, without it {loss_direct}")
    want = expected_train_launches(cfg, steps_total, TRAIN_ACCUM)
    if launches != want:
        fail(f"train: kernel launches {launches} != expected {want}")
    return launches


# (arch, layers kept (None: all), global batch, sequence, microbatches)
# of each family's training run: mamba2-130m at full depth; qwen3 at its
# full width but 4 of its 48 layers (about 16 bytes a parameter for the
# bf16 weights, the f32 accumulated gradients and AdamW's two f32
# moments: ~10 GB a layer, ~10 GB the embedding and head); zamba2-2.7b at
# full width and 18 of its 54 layers (three groups of 6, both shared
# blocks; at full depth, ~2.96 B parameters, its ~75 s were the longest
# training phase, and the run must keep within its time limit beside the
# sharded phase) and its own train_grad_accum 4, so a microbatch is
# 2 x 2048
TRAIN_FAMILIES = (("mamba2-130m", None, 8, 2048, 2),
                  ("qwen3-moe-30b-a3b", 4, 4, 2048, 2),
                  ("zamba2-2.7b", 18, 8, 2048, 4))
# (arch, layers kept (None: all), global batch, sequence, microbatches,
# phase, every step on batch 0) of the encoder's and the vlm's runs, both
# at full depth: hubert-xlarge (0.95 B parameters), its 2048 frames a
# sequence with random labels, so it trains on one batch; and
# phi-3-vision-4.2b (3.83 B parameters), 1472 text tokens after its 576
# image rows, 2048 positions.  At 24 of its 32 layers phi-3-vision
# peaked at 48.7 GB on an H100 (16.6 bytes a parameter: bf16 weights,
# f32 gradients, AdamW's two f32 moments), so all 32 take ~64 GB
TRAIN_FRONTENDS = (("hubert-xlarge", None, 8, 2048, 2, "train_encoder", True),
                   ("phi-3-vision-4.2b", None, 8, 1472, 2, "train_vlm", False))
TRAIN_FAMILY_STEPS = 8      # a held-out batch's loss must fall across these
HELD_OUT_BATCH = 1000       # the MarkovLM batch index of that held-out batch
# (arch, layers, sequence) of the kernel route vs its plain versions,
# f32, 4 sequences: qwen3 ("grouped") and mamba2-130m ("pallas") at 2
# layers, zamba2-2.7b ("pallas" and flash at d 160) at 12, two groups, so
# both shared blocks receive gradient
TRAIN_PARITY_FAMILIES = (("qwen3-moe-30b-a3b", 2, 256),
                         ("mamba2-130m", 2, 512),
                         ("zamba2-2.7b", 12, 512))


class plain_family_kernels:
    """Within the block, `GroupedMatmulFn`, `SsdIntraChunkFn` and
    `FlashAttentionFn` compute their plain versions on the card, forward
    and backward: the explicit oracle the kernels are held against, never
    a path of the port."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops as fk
        from repro_torch.kernels.grouped_matmul import ops as gm
        from repro_torch.kernels.ssd_scan import ops as ssd
        self.saved = [(fk, "flash_attention_lse", fk.flash_attention_lse_plain),
                      (fk, "flash_attention_backward",
                       fk.flash_attention_backward_plain),
                      (gm, "_forward", gm.grouped_matmul_plain),
                      (gm, "grouped_matmul_backward",
                       gm.grouped_matmul_backward_plain),
                      (ssd, "_forward", ssd.ssd_intra_chunk_plain),
                      (ssd, "ssd_intra_chunk_backward",
                       ssd.ssd_intra_chunk_backward_plain)]
        self.saved = [(m, name, getattr(m, name), fn)
                      for m, name, fn in self.saved]
        for m, name, _, fn in self.saved:
            setattr(m, name, fn)
        return self

    def __exit__(self, *exc):
        for m, name, orig, _ in self.saved:
            setattr(m, name, orig)
        return False


def family_cfg(arch: str, layers=None, **kw):
    from repro_torch.configs import get_arch
    cfg = get_arch(arch).model
    if cfg.family == "moe":
        kw.setdefault("moe_dispatch", "grouped")
    if cfg.family in ("ssm", "hybrid"):
        kw.setdefault("ssd_impl", "pallas")
    return cfg.replace(num_layers=layers or cfg.num_layers, **kw)


def phase_train_parity_families(torch, dev):
    """The MoE, ssm and hybrid families at their full width, f32, at the
    depths of `TRAIN_PARITY_FAMILIES`: one training step's loss and
    gradients (`make_grad_fn`, grad_accum 2) through the kernel route
    ("grouped": the grouped matmul and its backward; "pallas": the SSD
    kernel and its backward; the flash forward and backward) against the
    same step with the kernels' plain versions patched in
    (`plain_family_kernels`), per gradient leaf in relative L2
    (`TRAIN_PARITY_TOL`)."""
    from repro_torch.data import DataConfig, make_source
    from repro_torch.train import train_step as TS
    from repro_torch.utils.tree import tree_flatten_with_names

    out = {}
    rtol_loss, rel_l2 = TRAIN_PARITY_TOL["float32"]
    for arch, layers, seq in TRAIN_PARITY_FAMILIES:
        free_card(torch)
        cfg = family_cfg(arch, layers, dtype="float32", param_dtype="float32",
                         remat="full", logits_chunk=128)
        batch = TS.batch_to(make_source(DataConfig(
            source="markov", seq_len=seq, global_batch=4, seed=TRAIN_SEED),
            cfg).batch_at(0), dev)
        runs = []
        mods = kernel_modules()
        for oracle in (False, True):
            state = TS.init_train_state(cfg, _train_opt(10),
                                        seed=TRAIN_SEED, device=dev)
            for m in mods.values():
                m.launches = 0
            with plain_family_kernels() if oracle else \
                    contextlib.nullcontext():
                loss, grads = TS.make_grad_fn(cfg, grad_accum=2)(
                    state.params, batch)
            runs.append((float(loss), {
                n: g.float() for n, g in tree_flatten_with_names(grads)}))
            del state, loss, grads
            if not oracle:
                launched = {n: m.launches for n, m in mods.items()
                            if m.launches}
        # the kernel route went through its kernels, forward and backward
        want = {n: v for n, v in expected_train_launches(cfg, 1, 2).items()
                if v}
        if launched != want:
            fail(f"train_parity {arch}: kernel launches {launched} != "
                 f"expected {want}")
        (lk, gk), (lp, gp) = runs
        errs = {n: float((gk[n] - gp[n]).norm() / gp[n].norm().clamp_min(
            1e-30)) for n in gp}
        worst = max(errs, key=errs.get)
        out[arch] = {"layers": layers,
                     "route": cfg.moe_dispatch if cfg.family == "moe"
                     else cfg.ssd_impl, "launches": launched,
                     "loss_kernel": lk,
                     "loss_plain": lp, "loss_rel_err": abs(lk - lp) / abs(lp),
                     "worst_leaf": worst, "worst_grad_rel_l2": errs[worst],
                     "grad_rel_l2": errs}
        del batch
        if not (abs(lk - lp) <= rtol_loss * abs(lp)
                and errs[worst] <= rel_l2):
            emit({"phase": "train_parity_families", "failed": out[arch]})
        if not abs(lk - lp) <= rtol_loss * abs(lp):
            fail(f"train_parity {arch}: loss {lk} vs plain {lp}")
        if not errs[worst] <= rel_l2:
            fail(f"train_parity {arch}: gradient {worst} relative L2 "
                 f"error {errs[worst]} > {rel_l2}")
        del runs, gk, gp
    free_card(torch)
    emit({"phase": "train_parity_families",
          "config": "full width, f32, remat full, logits_chunk 128, 4 "
                    "sequences, grad_accum 2; layers per arch",
          "loss_rtol": rtol_loss, "grad_rel_l2_bound": rel_l2, **out})


def phase_train_family(torch, dev, card: str, cfg, global_batch: int,
                       seq: int, accum: int, phase: str | None = None,
                       fixed: bool = False) -> dict:
    """One family at full width (bf16 params, AdamW at 3e-4, remat
    "full", logits_chunk 512, MarkovLM data from the seed; the vlm's
    with seeded patch rows, the encoder's `SyntheticFrames`): the loss of
    a held-out batch (`HELD_OUT_BATCH`), then `TRAIN_FAMILY_STEPS` steps
    (the first loss near `first_loss`; step seconds, positions per
    second over all but the first, peak memory), one step under
    torch.profiler (the device's busy share and its top kernels), and
    the held-out loss again, which must have fallen; every kernel's
    launches counted from 0 over the training steps and held against
    `expected_train_launches`.  Returns them.  With `fixed` every step
    trains on batch 0, and it is that batch's loss that must fall: the
    encoder's labels are random, so no held-out loss can (reported, not
    held)."""
    import math
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, make_source
    from repro_torch.train import train_step as TS
    from repro_torch.utils.tree import tree_num_params

    free_card(torch)
    t_begin = time.perf_counter()
    opt = _train_opt(100)
    source = make_source(DataConfig(source="markov", seq_len=seq,
                                    global_batch=global_batch,
                                    seed=TRAIN_SEED), cfg)
    batches = [TS.batch_to(source.batch_at(0 if fixed else i), dev)
               for i in range(TRAIN_FAMILY_STEPS + 1)]
    held_out = TS.batch_to(source.batch_at(HELD_OUT_BATCH), dev)
    step = TS.make_train_step(cfg, opt, grad_accum=accum)
    evaluate = TS.make_eval_step(cfg)
    # positions a sequence trains on: the vlm's image rows too
    per_seq = seq + (cfg.num_patches if cfg.frontend == "patch" else 0)
    state = TS.init_train_state(cfg, opt, seed=TRAIN_SEED, device=dev)
    n_params = tree_num_params(state.params)
    held_before = float(evaluate(state.params, held_out))
    mods = kernel_modules()
    for m in mods.values():
        m.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_steps = time.perf_counter()
    state, losses, norms, secs = run_steps(torch, step, state, batches[:-1])
    peak = torch.cuda.max_memory_allocated()
    t_prof = time.perf_counter()
    state, m, prof_s, busy_s, top, port_kernels = profiled_step(
        torch, step, state, batches[-1])
    launches = {name: mm.launches for name, mm in mods.items()}
    profiled_loss = float(m["loss"])
    t_eval = time.perf_counter()
    held_after = float(evaluate(state.params, held_out))
    del state, m, batches, held_out
    free_card(torch)
    timed = secs[1:]
    want_first = first_loss(cfg)
    route = {"moe": f"moe_dispatch {cfg.moe_dispatch}",
             "ssm": f"ssd_impl {cfg.ssd_impl}",
             "hybrid": f"ssd_impl {cfg.ssd_impl}"}.get(
        cfg.family, "causal flash" if cfg.causal else "non-causal flash")
    data = {"encoder": f"SyntheticFrames seed {TRAIN_SEED} (random "
                       f"labels)",
            "vlm": f"MarkovLM seed {TRAIN_SEED} with {cfg.num_patches} "
                   f"seeded patch rows a sequence"}.get(
        cfg.family, f"MarkovLM seed {TRAIN_SEED}")
    unit = "frames" if cfg.family == "encoder" else "tokens"
    emit({"phase": phase or f"train {cfg.name}", "card": card,
          "config": f"{cfg.name}, {cfg.num_layers} of "
                    f"{get_arch(cfg.name).model.num_layers} layers, {route}, "
                    f"bf16, "
                    f"AdamW, remat {cfg.remat}, logits_chunk "
                    f"{cfg.logits_chunk}, {global_batch} x {seq} {unit} in "
                    f"{accum} microbatches, {data}"
                    + (", every step on batch 0" if fixed else ""),
          "positions_per_sequence": per_seq,
          "params": n_params, "losses": losses, "grad_norms": norms,
          # the training loss over the first four steps (reported; lr is
          # 0 at step 0, so it shows two updates) beside the held-out
          # loss before and after every step, which is checked
          "four_step_loss": [losses[0], losses[3]],
          "four_step_loss_fell": losses[3] < losses[0],
          "held_out_loss": [held_before, held_after],
          **({"fixed_batch_loss": [losses[0], losses[-1], profiled_loss]}
             if fixed else {}),
          "ln_vocab": math.log(cfg.vocab_size),
          "expected_first_loss": want_first, "step_s": secs,
          "tokens_per_s": global_batch * per_seq * len(timed) / sum(timed),
          "max_memory_allocated": peak, "profiled_step_s": prof_s,
          "device_busy_s": busy_s, "device_busy_share": busy_s / prof_s,
          "top_device_kernels": top, "port_kernels": port_kernels,
          "launches": launches,
          # where the phase's own time went: set-up (data, init, the first
          # held-out loss), the steps, the profiled step with the
          # profiler's processing, the last held-out loss
          "phase_s": {"setup": t_steps - t_begin, "steps": t_prof - t_steps,
                      "profiled": t_eval - t_prof,
                      "eval": time.perf_counter() - t_eval}})
    if not all(math.isfinite(x) for x in losses + norms):
        fail(f"train {cfg.name}: non-finite loss or grad norm {losses} "
             f"{norms}")
    if abs(losses[0] - want_first) > 0.1:
        fail(f"train {cfg.name}: first loss {losses[0]} not near "
             f"{want_first}")
    # after the timed steps' updates (the profiled step's loss is taken
    # before its own)
    if fixed and not profiled_loss < losses[0]:
        fail(f"train {cfg.name}: the fixed batch's loss did not fall: "
             f"{losses} then {profiled_loss}")
    if not fixed and not held_after < held_before:
        fail(f"train {cfg.name}: the held-out loss did not fall: "
             f"{held_before} -> {held_after}")
    want = expected_train_launches(cfg, TRAIN_FAMILY_STEPS + 1, accum)
    if launches != want:
        fail(f"train {cfg.name}: kernel launches {launches} != expected "
             f"{want}")
    return launches


# ------------------------------------------ phase 13d: train_sharded
#
# Sharded training in one world of 4 ranks time-sharing this card
# (`repro_torch/benchmarks/train_sharded.py`; gloo process groups, since
# NCCL refuses two ranks on one GPU): internlm2-1.8b at full width on
# (2, 2) = data x model, bf16 and f32, qwen3-moe-30b-a3b at full width
# on (1, 4) under "ep", the int8 ring, GPipe and an elastic restart, each
# held against the single-rank step on the same card.
# bf16 bounds: the sharded step sums the same products in other orders
# (tensor-parallel partial sums all-reduced, the FSDP gradient
# reduce-scattered in bf16), and AdamW's first step is about lr *
# sign(g), so a leaf's elements whose gradient is near zero may step the
# other way.  Measured on the card by this phase (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md section 6): the worst leaf after step 1 0.0201 (mlp wo),
# the loss 9.0e-4 at step 3; bounded here per leaf (relative L2) and per
# step (loss, absolute).
SHARDED_BF16_TOL = (5e-2, 5e-3)
# qwen3-moe-30b-a3b's gradients, f32 (relative L2 per leaf), "ep" on
# (1, 4) against the single-rank "grouped" step: measured 5.1e-6 at
# worst (attention wk); its loss within the reference's 2e-4.  In bf16
# the routing of a few tokens near a top-8 tie flips with the summation
# order and the gradients part by 5-9 % (measured), which would hide a
# fault of that size.  The f32 layout cases (yi-9b sequence parallel,
# mamba2-130m's heads split) are held to it too: their gradients, not
# their parameters after a step, whose AdamW update is about lr *
# sign(g) and flips where a gradient element is near zero (on the card
# allclose at the reference test's bounds failed on a few elements of
# yi-9b's and mamba2-130m's parameters after one step).
SHARDED_MOE_TOL = 1e-4
SHARDED_TIMEOUT = 600            # seconds for the 4-rank world


def phase_train_sharded(torch, card: str) -> dict:
    """Phase 13d (module docstring); returns the kernels the ranks
    launched in every case, summed over the ranks."""
    import shutil
    from repro_torch.benchmarks import train_sharded as TSH
    work = ROOT / "build" / "chip_smoke_sharded"
    shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    spec = TSH.card_spec(str(work))
    rep = TSH.run(spec, timeout=SHARDED_TIMEOUT)
    seconds = time.perf_counter() - t1
    shutil.rmtree(work, ignore_errors=True)
    bad = TSH.check(rep, *SHARDED_BF16_TOL, SHARDED_MOE_TOL)
    launches = {}
    for case in ("dense", "dense_f32", "moe") + TSH.LAYOUT_CASES:
        for per_rank in rep[case]["launches"]:
            for name, n in per_rank.items():
                launches[name] = launches.get(name, 0) + n
    for case in ("moe",) + TSH.LAYOUT_CASES:
        r = rep[case]
        emit({"phase": "train_sharded_layout", "case": case, "card": card,
              "arch": spec[case]["arch"], "layers": spec[case]["layers"],
              "mesh": r["mesh"], "tokens": r["tokens"] if "tokens" in r
              else spec[case]["global_batch"] * spec[case]["seq"],
              "trunk_split": r["trunk_split"],
              "sharded_step_s": r.get("sharded_step_s", r.get("sharded_s")),
              "single_step_s": r.get("single_step_s", r.get("single_s")),
              "peak_gib_per_rank": r["peak_gib_per_rank"],
              "single_peak_gib": r.get("single_peak_gib"),
              "bytes_per_step_rank0": r["bytes_per_step_rank0"],
              "launches_rank0": r["launches"][0],
              "sites": r["sites"], "sites_checked": r["sites_checked"],
              "worst_leaf": r["worst_leaf"],
              "worst_rel_l2": r["worst_rel_l2"],
              "loss_abs_diff": r["loss_abs_diff"],
              **{f"worst_{k}": max(r[k].values())
                 for k in ("sharded_rel_l2_to_f32", "single_rel_l2_to_f32")
                 if k in r}})
    emit({"phase": "train_sharded", "card": card, "seconds": seconds,
          "tolerance": {"bf16_leaf_rel_l2": SHARDED_BF16_TOL[0],
                        "bf16_loss_abs": SHARDED_BF16_TOL[1],
                        "moe_grad_rel_l2": SHARDED_MOE_TOL,
                        "ssm_bf16_grad_rel_l2": TSH.SSM_BF16_GRAD_TOL,
                        "ssm_bf16_D_rel_l2": TSH.SSM_BF16_D_TOL,
                        "ssm_bf16_loss_rtol": TSH.SSM_BF16_LOSS_RTOL,
                        "ssm_bf16_to_f32_ratio": TSH.SSM_BF16_F32_RATIO},
          "launches": launches, **rep})
    if bad:
        fail("train_sharded: " + "; ".join(bad))
    return launches


# ------------------------------------------------------ phase 14: paper

# ------------------------------------------------ phase 13e: xla tools

XLA_SERVE_GEOM = dict(max_batch=8, max_seq=1024, page_size=16,
                      prefill_chunk=64)
XLA_CARD_CELLS = (("decode_card", None), ("prefill_card", None),
                  ("train_card", 4))         # (shape, layers: None = all)
XLA_DRYRUN = ("yi-9b", "train_4k", "single")
XLA_SHARDS = 4
# bytes the phase may leave allocated on the card: the kernels' grown
# scratch buffers and cuBLAS's workspaces, far below one record's state
# (the 4-layer train step's is 6.3 GB)
XLA_HELD_LIMIT = 256 << 20
# the kernels each card record's step must launch (bf16, contiguous
# cache: split-KV decode and flash; training: flash and its backward)
XLA_CELL_KERNELS = {"decode_card": ("decode_attention",),
                    "prefill_card": ("flash_attention",),
                    "train_card": ("flash_attention",
                                   "flash_attention_backward")}


class plain_paged_kernels:
    """Within the block the paged layers call the paged kernels' plain
    versions on the card: the explicit oracle whose gather the structure
    gate must see, never a path of the port."""

    def __enter__(self):
        from repro_torch.kernels.paged_attention import ops as pa
        from repro_torch.kernels.paged_prefill import ops as pp
        from repro_torch.models import layers
        self.saved = [(layers, "paged_decode_attention",
                       layers.paged_decode_attention),
                      (layers, "paged_prefill_attention",
                       layers.paged_prefill_attention)]
        layers.paged_decode_attention = pa.paged_decode_attention_plain
        layers.paged_prefill_attention = pp.paged_prefill_attention_plain
        return self

    def __exit__(self, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)
        return False


def structure_gates(torch, dev, cfg, params, geom) -> dict:
    """The paged steps' traces at one geometry (phase docstring, (a))."""
    from repro_torch.launch import trace as T
    from repro_torch.serve.serve_step import (bulk_attn_shapes,
                                              lowered_paged_hlo)
    shapes = bulk_attn_shapes(cfg, **geom)
    b = geom["max_batch"]
    out = {}
    for which, name in (("decode", "paged_decode_attention"),
                        ("prefill", "paged_prefill_attention")):
        tr = lowered_paged_hlo(cfg, which, params=params, device=dev, **geom)
        types = tr.result_types()
        launches = [k for k in tr.kernels if k.name == name]
        h2d = [t for t in tr.transfers if t[1:] == ("cpu", "cuda")]
        d2h = [t for t in tr.transfers if t[2] == "cpu"]
        tokens = T.tensor_type(tr.output[1])
        bulk = sorted(set(shapes) & types)
        with plain_paged_kernels():
            plain = lowered_paged_hlo(cfg, which, params=params, device=dev,
                                      **geom)
        gathered = sorted(set(shapes) & plain.result_types())
        got = {"bulk_types_kernel_route": bulk,
               "kernel_launches": len(launches),
               "kernel_outputs": sorted({k.outputs[0] for k in launches}),
               "kernel_flops": sum(k.flops for k in launches),
               "host_to_card": [t[0] for t in h2d], "card_to_host": d2h,
               "tokens": tokens, "ops": len(tr.ops),
               "plain_route_gathered": gathered,
               "plain_route_kernels": len(plain.kernels),
               "plain_bulk_bytes": sum(plain.summary().bytes_by_shape.get(
                   k, 0.0) for k in shapes)}
        out[which] = got
        if bulk:
            fail(f"xla_tools {which}: the kernel route holds {bulk}")
        if len(launches) != cfg.num_layers or not all(
                k.outputs and k.outputs[0] in types for k in launches):
            fail(f"xla_tools {which}: {len(launches)} launches of {name} "
                 f"with outputs in the trace, want {cfg.num_layers}")
        if tokens != f"s32[{b}]" or d2h:
            fail(f"xla_tools {which}: tokens {tokens}, copies to the host "
                 f"{d2h}")
        if not gathered or plain.kernels:
            fail(f"xla_tools {which}: the plain route gathered {gathered} "
                 f"and launched {len(plain.kernels)} kernels")
    return out


def card_record(torch, dev, shape: str, layers) -> dict:
    """One card record of internlm2-1.8b (phase docstring, (b))."""
    from repro_torch.launch import dryrun, roofline
    over = {"num_layers": layers} if layers else None
    rec = dryrun.run_cell("internlm2-1.8b", shape, "one", "", over,
                          device="cuda")
    if not rec["ok"]:
        fail(f"xla_tools record {shape}: {rec.get('error')}")
    row = roofline.row_from_record(rec)
    tr = rec["trace"]
    for name in XLA_CELL_KERNELS[shape]:
        if not tr["kernel_launches"].get(name) \
                or not tr["kernel_flops"].get(name, 0) > 0:
            fail(f"xla_tools record {shape}: {name} launched "
                 f"{tr['kernel_launches'].get(name)} times with "
                 f"{tr['kernel_flops'].get(name)} FLOPs in the trace")
    if not 0 < (row.mfu or 0) < 1:
        fail(f"xla_tools record {shape}: MFU {row.mfu}")
    m = rec["measured"]
    free_card(torch)
    return {"layers": rec["meta"]["num_layers"],
            "model_flops": rec["model_flops"],
            "flops_per_device": rec["hlo"]["flops_per_device"],
            "hbm_bytes": rec["hlo"]["bytes_read_per_device"]
            + rec["hlo"]["bytes_written_per_device"],
            "step_s": m["step_s"], "steps_s": m["steps_s"],
            "peak_memory_bytes": m["peak_memory_bytes"],
            "busy_s": m["busy_s"], "top_kernels": m["top_kernels"][:6],
            "kernel_launches": tr["kernel_launches"],
            "kernel_flops": tr["kernel_flops"], "ops": tr["ops"],
            "roofline_h100": {"compute_s": row.compute_s,
                              "memory_s": row.memory_s,
                              "dominant": row.dominant,
                              "useful_ratio": row.useful_ratio},
            "mfu": row.mfu, "trace_s": rec["timing_s"]["trace"]}


def sharded_gate(torch, dev, cfg, params) -> dict:
    """The summary-size gate on `XLA_SHARDS` banks of the card (phase
    docstring, (c))."""
    from repro_torch.launch import trace as T
    from repro_torch.launch.mesh import make_mem_mesh
    from repro_torch.serve.sharded import lowered_sharded_hlo
    geom = {k: XLA_SERVE_GEOM[k] for k in ("max_batch", "max_seq",
                                           "page_size")}
    mesh = make_mem_mesh(XLA_SHARDS)
    tr = lowered_sharded_hlo(cfg, mesh, "decode", params=params, device=dev,
                             **geom)
    hands = [c for c in tr.collectives if c.kind == T.HAND]
    el = torch.empty((), dtype=cfg.compute_dtype).element_size()
    pps = (geom["max_batch"] * geom["max_seq"] // geom["page_size"]) \
        // XLA_SHARDS
    bank = (pps + 1) * geom["page_size"] * cfg.num_kv_heads \
        * cfg.head_dim * el
    bulk = geom["max_batch"] * geom["max_seq"] * cfg.num_kv_heads \
        * cfg.head_dim * el
    worst = max((c.result_bytes for c in hands), default=0)
    combines = sum(k.name == "combine_splits" for k in tr.kernels)
    walks = sum(k.name == "paged_decode_attention" for k in tr.kernels)
    got = {"banks": XLA_SHARDS, "hands": len(hands),
           "worst_hand_bytes": worst, "bank_layer_bytes": bank,
           "gathered_kv_bytes": bulk,
           "hand_types": sorted({c.result_type for c in hands}),
           "combine_launches": combines, "bank_walks": walks,
           "tokens": T.tensor_type(tr.output[1])}
    if not hands or worst >= bank / 2 or worst >= bulk / 8:
        fail(f"xla_tools sharded: a hand of {worst} bytes against a bank "
             f"layer's {bank}")
    if combines != cfg.num_layers or walks != XLA_SHARDS * cfg.num_layers:
        fail(f"xla_tools sharded: {combines} combines and {walks} bank "
             f"walks for {cfg.num_layers} layers")
    return got


def phase_xla_tools(torch, dev, card: str, dense) -> dict:
    """Phase 13e (module docstring); returns its kernels' launches."""
    from repro_torch.launch import dryrun
    from repro_torch.models import registry
    from repro_torch.serve.serve_step import HLO_PROBE_GEOM
    t0 = time.perf_counter()
    mods = kernel_modules()
    for m in mods.values():
        m.launches = 0
    free_card(torch)
    held_before = torch.cuda.memory_allocated(dev)
    params = registry.get_family(dense).init(0, dense, dev)
    out = {"phase": "xla_tools", "card": card, "structure": {}}
    for gname, geom in (("probe", HLO_PROBE_GEOM), ("serve", XLA_SERVE_GEOM)):
        out["structure"][gname] = structure_gates(torch, dev, dense, params,
                                                  geom)
    out["structure_s"] = time.perf_counter() - t0
    out["sharded"] = sharded_gate(torch, dev, dense, params)
    del params
    from repro_torch.benchmarks import serve_throughput as ST
    out["attention_hlo"] = h = ST.attention_hlo(dev)
    if not h["ok"]:
        fail(f"xla_tools: serve_throughput's attention_hlo gate failed: {h}")
    free_card(torch)
    t1 = time.perf_counter()
    out["records"] = {shape: card_record(torch, dev, shape, layers)
                      for shape, layers in XLA_CARD_CELLS}
    out["records_s"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    arch, shape, mesh = XLA_DRYRUN
    rec = dryrun.run_cell(arch, shape, mesh, "", device="meta")
    if not rec["ok"] or not rec["hlo"]["flops_per_device"] > 0 \
            or not sum(rec["hlo"]["collective_bytes_per_device"].values()):
        fail(f"xla_tools dry-run {arch} x {shape}: {rec.get('error')}")
    from repro_torch.launch import roofline
    rows = {t: roofline.row_from_record(rec, target=t)
            for t in ("h100", "tpu-v5e")}
    out["dryrun"] = {"cell": f"{arch}__{shape}__{mesh}",
                     "seconds": time.perf_counter() - t2,
                     "trace_s": rec["timing_s"]["trace"],
                     "flops_per_device": rec["hlo"]["flops_per_device"],
                     "collective_bytes_per_device":
                         rec["hlo"]["collective_bytes_per_device"],
                     "argument_bytes":
                         rec["memory_analysis"]["argument_size_in_bytes"],
                     "temp_bytes": rec["memory_analysis"]["temp_size_in_bytes"],
                     "step_s": {t: r.step_s for t, r in rows.items()},
                     "dominant": {t: r.dominant for t, r in rows.items()},
                     "useful_ratio": rows["h100"].useful_ratio}
    launches = {n: m.launches for n, m in mods.items()}
    out["launches"] = launches
    # the traces and records keep none of their steps' tensors alive
    free_card(torch)
    out["bytes_held_after"] = held = \
        torch.cuda.memory_allocated(dev) - held_before
    if held > XLA_HELD_LIMIT:
        fail(f"xla_tools: {held} bytes still held on the card after the "
             f"phase")
    for name in ("paged_decode_attention", "paged_prefill_attention",
                 "combine_splits", "decode_attention", "flash_attention",
                 "flash_attention_backward"):
        if not launches[name]:
            fail(f"xla_tools: {name} was not launched")
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return launches


def phase_paper(torch, dev):
    """Every paper module of the port's harness on the card (its
    serving tools run in `serve_tools`); returns the kernel launches of
    the run."""
    from repro_torch.benchmarks import run as paper

    results, launches = count_path(
        lambda: paper.run_all(dev, paper.PAPER_MODULES))
    emit({"phase": "paper", "results": results, "launches": launches})
    bad = [r["name"] for r in results if not r["ok"]]
    if bad:
        fail(f"paper harness: {bad} failed")
    check_sweep_launches("paper", launches)
    return launches


# ---------------------------------------------------- phase 15: resnet50

RESNET_ITERS = 20           # back-to-back forwards per timed round
RESNET_ROUNDS = 3
RESNET_PROFILED = 5         # forwards under torch.profiler
# card against CPU, f32: |card - cpu| <= RESNET_TOL * max |cpu logit|.
# 53 convolutions of up to 4,608-term f32 sums, in another order and
# through cuDNN's own algorithms (Winograd/FFT transforms round
# differently), with TF32 off; TF32 keeps about three digits and would
# exceed it.
RESNET_TOL = 5e-4


def device_busy(torch, fn, calls: int) -> tuple[float, float]:
    """(ms of device kernel time, kernels) per call of fn, from
    torch.profiler over `calls` calls: the self device time of every
    device event, as the profiler's own table totals it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in dev_events)
    return busy_us / 1e3 / calls, sum(e.count for e in dev_events) / calls


def phase_resnet50(torch, dev, card: str):
    from repro_torch.models.resnet import (init_resnet50, resnet50_forward,
                                           resnet50_total_macs)

    free_card(torch)
    g = torch.Generator(device=dev).manual_seed(50)
    params = init_resnet50(0, dev, torch.bfloat16)
    runs = {}
    with torch.inference_mode():
        for batch in (1, 8):
            images = torch.randn(batch, 224, 224, 3, generator=g,
                                 device=dev).to(torch.bfloat16)
            torch.cuda.reset_peak_memory_stats()
            logits = resnet50_forward(params, images)
            torch.cuda.synchronize()
            if (tuple(logits.shape) != (batch, 1000)
                    or not bool(torch.isfinite(logits).all())):
                fail(f"resnet50 batch {batch}: logits {tuple(logits.shape)}"
                     f" not finite or of the wrong shape")
            for _ in range(3):
                resnet50_forward(params, images)
            rounds = []
            for _ in range(RESNET_ROUNDS):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(RESNET_ITERS):
                    resnet50_forward(params, images)
                b.record()
                b.synchronize()
                rounds.append(a.elapsed_time(b) / RESNET_ITERS)
            ms = statistics.median(rounds)
            busy, kernels = device_busy(
                torch, lambda: resnet50_forward(params, images),
                RESNET_PROFILED)
            runs[str(batch)] = {"ms_per_batch": ms,
                                "img_per_s": batch * 1e3 / ms,
                                "rounds_ms_per_batch": rounds,
                                "device_busy_ms_per_batch": busy,
                                "device_idle_share": 1 - busy / ms,
                                "kernels_per_forward": kernels,
                                "max_memory_allocated":
                                    torch.cuda.max_memory_allocated()}
    del params
    free_card(torch)

    params = init_resnet50(1, dev, torch.float32)
    cpu = torch.device("cpu")
    params_cpu = tree_to(params, cpu)
    images = torch.randn(1, 224, 224, 3, generator=g, device=dev)
    with torch.inference_mode():
        got = resnet50_forward(params, images).cpu()
        want = resnet50_forward(params_cpu, images.cpu())
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ratio = err / (RESNET_TOL * scale)
    emit({"phase": "resnet50", "card": card, "image": 224, "dtype": "bfloat16",
          "gmacs_per_image": resnet50_total_macs(224) / 1e9,
          "timing": f"CUDA events, median of {RESNET_ROUNDS} rounds of "
                    f"{RESNET_ITERS} back-to-back forwards after 4 warm-up, "
                    f"eager, cuDNN channels_last; device busy from "
                    f"torch.profiler over {RESNET_PROFILED} more forwards",
          "batches": runs,
          "parity": {"dtype": "float32", "batch": 1, "max_abs_err": err,
                     "max_abs_logit": scale, "rtol_of_max_logit": RESNET_TOL,
                     "err_over_bound": ratio}})
    if not ratio <= 1.0:
        fail(f"resnet50 card vs CPU: err {err} > {RESNET_TOL} x {scale}")


# --------------------------------------------------------------- main

def ptxas_report(log: str, pattern: str, label) -> dict:
    """ptxas's registers and spills of the kernels whose mangled names
    match `pattern` in the build's compiler log, keyed by `label(match)`:
    {label: "Used ... registers ...; ... spill loads"}."""
    import re
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            m = re.search(pattern, ln)
            cur = label(m) if m else None
            if cur is not None:
                out.setdefault(cur, [])
        elif cur is not None and ("registers" in ln or "spill" in ln):
            item = ln.split("ptxas info    : ")[-1].strip()
            if item not in out[cur]:
                out[cur].append(item)
    return {k: "; ".join(v) for k, v in out.items()}


def tc_ptxas(log: str) -> dict:
    """ptxas's report of each head-dim instance of the four bf16
    tensor-core attention kernels (flash_attention.cu, paged_prefill.cu,
    paged_attention.cu and decode_attention.cu) and of the flash
    backward's (flash_attention_bwd.cu: the mma.sync design's two, the
    wgmma design's two and its group split's reduce): {"flash d128":
    ..., "paged_decode d160": ..., "split_decode d128": ...,
    "flash_bwd_dkdv d192": ..., "flash_bwd_dkdv_wg d128": ...,
    "flash_bwd_reduce": ...}."""
    names = {"flash": "flash", "prefill": "paged_prefill",
             "5repro6dec_tc16decode": "paged_decode",
             "9repro_dec6dec_tc16decode": "split_decode",
             "dkdv": "flash_bwd_dkdv", "dq": "flash_bwd_dq"}
    out = ptxas_report(
        log, r"(flash|prefill|5repro6dec_tc16decode|9repro_dec6dec_tc16decode"
             r"|dkdv|dq)_tc_kernelILi(\d+)E",
        lambda m: f"{names[m[1]]} d{m[2]}")
    out.update(ptxas_report(log, r"(dkdv|dq)_wg_kernelILi(\d+)E",
                            lambda m: f"flash_bwd_{m[1]}_wg d{m[2]}"))
    out.update(ptxas_report(log, r"dkdv_reduce_kernel",
                            lambda m: "flash_bwd_reduce"))
    return dict(sorted(out.items(), key=lambda kv: (
        kv[0].split()[0], int((kv[0].split() + ["d0"])[1][1:]))))


def bwd_spills(report: dict) -> list:
    """The flash backward's instances (in a `tc_ptxas` report) that
    spill, or that ptxas did not report at all: each bf16 head dim's two
    kernels of its design (`bwd_design`), and the group split's reduce."""
    import re
    from repro_torch.kernels.flash_attention import ops as fk
    bwd = {k: v for k, v in report.items() if k.startswith("flash_bwd")}
    want = [f"flash_bwd_{k}{'_wg' if fk.bwd_design(d) == fk.WGMMA else ''}"
            f" d{d}" for d in fk.BWD_TC_HEAD_DIMS for k in ("dkdv", "dq")]
    missing = [f"{k} (no report)" for k in (*want, "flash_bwd_reduce")
               if k not in bwd]
    return missing + [k for k, v in bwd.items()
                      if re.search(r"\b[1-9]\d* bytes spill", v)]


def wgmma_warnings(log: str) -> list:
    """ptxas's warnings about wgmma or setmaxnreg (a serialized wgmma, a
    register count it ignored) in the build's compiler log."""
    return sorted({ln.strip() for ln in log.splitlines()
                   if "warning" in ln and ("wgmma" in ln or "setmaxnreg" in ln)})


def grouped_ptxas(log: str) -> dict:
    """ptxas's report of the bf16 grouped-matmul kernel (`gm_bf16_kernel`;
    where it is a template, its instances with 16-byte copies, "vec",
    and element copies)."""
    names = {None: "gm_bf16", "1": "gm_bf16 vec", "0": "gm_bf16 element copies"}
    return dict(sorted(ptxas_report(
        log, r"gm_bf16_kernel(?:ILb([01])E)?", lambda m: names[m[1]]).items()))


def grouped_bwd_ptxas(log: str) -> dict:
    """ptxas's report of each kernel of the grouped-matmul backward
    (grouped_matmul_bwd.cu): the rounding of dY and the bf16 dX and dW
    kernels ("round_dy", "dx_wg", "dw_wg"; a checkout before them has
    "dx_bf16" and "dw_bf16") and the f32 one ("bwd_f32")."""
    return dict(sorted(ptxas_report(
        log, r"repro_gmb(?:2wg)?\d+(round_dy|dx_wg|dw_wg|dx_bf16|dw_bf16|bwd_f32)"
             r"_kernel", lambda m: m[1]).items()))


def grouped_bwd_spills(report: dict) -> list:
    """The grouped backward's kernels (in a `grouped_bwd_ptxas` report)
    that spill, or that ptxas did not report at all."""
    import re
    want = ("round_dy", "dx_wg", "dw_wg", "bwd_f32")
    return [f"{k} (no report)" for k in want if k not in report] + [
        k for k, v in report.items()
        if re.search(r"\b[1-9]\d* bytes spill", v)]


def ssd_ptxas(log: str) -> dict:
    """ptxas's report of each head-dim instance (p rounded up to 16) of
    the bf16 SSD kernel (`ssd_tc_kernel`): {"ssd_tc p64": ...}."""
    out = ptxas_report(log, r"ssd_tc_kernelILi(\d+)E",
                       lambda m: f"ssd_tc p{m[1]}")
    return dict(sorted(out.items(), key=lambda kv: int(kv[0].split("p")[-1])))


def ssd_bwd_ptxas(log: str) -> dict:
    """ptxas's report of each instance (p and n rounded up to a width of
    16, 32, 64 or 128) of the bf16 SSD backward's column and row kernels
    (ssd_scan_bwd.cu `tc::col_kernel`, `tc::row_kernel`; past p = n = 64
    the column pass is two kernels, "col_dx" and "col_db"): {"ssd_bwd_col
    p64 n128": ..., "ssd_bwd_col_db p128 n128": ...}."""
    part = {"0": "col", "1": "col_dx", "2": "col_db", None: "row"}
    out = ptxas_report(
        log, r"tc10(?:col|row)_kernelILi(\d+)ELi(\d+)E(?:Li(\d)E)?",
        lambda m: f"ssd_bwd_{part[m[3]]} p{m[1]} n{m[2]}")
    return dict(sorted(out.items(), key=lambda kv: (
        kv[0].split()[0], int(kv[0].split()[1][1:]),
        int(kv[0].split()[2][1:]))))


def ssd_bwd_spills(report: dict) -> list:
    """The bf16 SSD backward's instances (in an `ssd_bwd_ptxas` report)
    that spill, or that ptxas did not report at all."""
    import re
    from repro_torch.kernels.ssd_scan import ops as ssd
    want = [f"ssd_bwd_{k} p{pw} n{nw}"
            for pw in ssd.BWD_TC_WIDTHS for nw in ssd.BWD_TC_WIDTHS
            for k in (("col_dx", "col_db") if ssd.bwd_col_splits(
                ssd.torch.bfloat16, pw, nw) > 1 else ("col",)) + ("row",)]
    return [f"{k} (no report)" for k in want if k not in report] + [
        k for k, v in report.items()
        if re.search(r"\b[1-9]\d* bytes spill", v)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build as kbuild

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    lib = kbuild.library()
    ptxas = [ln.strip() for ln in lib.compiler_log.splitlines()
             if "registers" in ln or "spill" in ln]
    tc_report = tc_ptxas(lib.compiler_log)
    ssd_bwd_report = ssd_bwd_ptxas(lib.compiler_log)
    grouped_bwd_report = grouped_bwd_ptxas(lib.compiler_log)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.path.relative_to(ROOT)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "ptxas": ptxas,
          "tc_ptxas": tc_report, "ssd_bwd_ptxas": ssd_bwd_report,
          "grouped_bwd_ptxas": grouped_bwd_report,
          "wgmma_warnings": wgmma_warnings(lib.compiler_log)})
    spilled = bwd_spills(tc_report)
    if spilled:
        fail(f"the flash backward spills at {spilled}")
    spilled = ssd_bwd_spills(ssd_bwd_report)
    if spilled:
        fail(f"the SSD backward spills at {spilled}")
    spilled = grouped_bwd_spills(grouped_bwd_report)
    if spilled:
        fail(f"the grouped backward spills at {spilled}")

    timings = phase_kernels(torch, dev, card)
    flush_buf = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    timings.update(phase_moe_ssd_kernels(torch, dev, card, flush_buf.zero_))
    timings.update(phase_contig_kernels(torch, dev, card, flush_buf.zero_))
    timings.update(phase_train_kernels(torch, dev, card, flush_buf.zero_))
    ws_timings, ws_launches = phase_ws_kernels(torch, dev, card,
                                               flush_buf.zero_)
    timings.update(ws_timings)
    del flush_buf
    dense = get_arch("internlm2-1.8b").model
    moe = get_arch("qwen3-moe-30b-a3b").model.replace(moe_dispatch="grouped")
    hybrid = get_arch("zamba2-2.7b").model.replace(ssd_impl="pallas")
    launches, plain = phase_serve(torch, dev, card, "serve", dense)
    phase_serve_spec(torch, dev, card, dense, plain)
    tier_launches = phase_serve_tier(torch, dev, card, dense)
    front_launches = phase_serve_front(torch, dev, card, dense)
    tools_launches = phase_serve_tools(torch, dev, card, dense)
    shard_launches = phase_serve_sharded(torch, dev, card, dense)
    phase_spec_parity(torch, dev, dense.replace(
        num_layers=2, dtype="float32", param_dtype="float32"))
    moe_launches, _ = phase_serve(torch, dev, card, "serve_moe", moe)
    hybrid_launches, _ = phase_serve(torch, dev, card, "serve_hybrid", hybrid,
                                     twins=True)
    contig_launches, _ = phase_serve(torch, dev, card, "serve_contiguous",
                                     dense, layout="contiguous")
    ssm = get_arch("mamba2-130m").model.replace(ssd_impl="pallas")
    ssm_launches, _ = phase_serve(torch, dev, card, "serve_ssm", ssm)
    phase_parity(torch, dev)
    f32 = dict(dtype="float32", param_dtype="float32")
    f32_contig_launches = phase_parity_contiguous(
        torch, dev, dense.replace(num_layers=2, attention_impl="flash_pallas",
                                  **f32),
        "internlm2-1.8b width, 2 layers, f32, contiguous", (20, 13), 64)
    # prompts of two full chunks (300 -> 2 x 256) and one ragged chunk
    phase_parity_contiguous(
        torch, dev, ssm.replace(num_layers=2, **f32),
        "mamba2-130m width, 2 layers, f32, contiguous", (300, 200), 512)
    phase_parity_family(torch, dev, moe.replace(num_layers=2, **f32),
                        "qwen3-moe-30b-a3b width, 2 layers, f32")
    phase_parity_family(
        torch, dev,
        hybrid.replace(num_layers=2 * hybrid.shared_attn_period, **f32),
        "zamba2-2.7b width, 12 layers (2 shared applications), f32")
    phase_train_parity(torch, dev, dense)
    phase_train_parity_families(torch, dev)
    train_launches = phase_train(torch, dev, card, dense)
    for arch, layers, gb, seq, accum in TRAIN_FAMILIES:
        fam_launches = phase_train_family(
            torch, dev, card, family_cfg(arch, layers, remat="full",
                                         logits_chunk=512), gb, seq, accum)
        for name in ("flash_attention_backward", "grouped_matmul_backward",
                     "ssd_intra_chunk_backward"):
            train_launches[name] += fam_launches[name]
    # the vlm and encoder families and the configs that reuse the other
    # families' code at new widths
    vlm = get_arch("phi-3-vision-4.2b").model
    vlm_launches, _ = phase_serve(torch, dev, card, "serve_vlm", vlm)
    phase_parity_family(
        torch, dev, vlm.replace(num_layers=2, **f32),
        "phi-3-vision-4.2b width, 2 layers, f32, a chunk across the "
        "patch/text boundary", base=vlm.num_patches - 4)
    config_launches = phase_serve_configs(torch, dev, card)
    for arch, layers, gb, seq, accum, phase, fixed in TRAIN_FRONTENDS:
        fam_launches = phase_train_family(
            torch, dev, card, family_cfg(arch, layers, remat="full",
                                         logits_chunk=512), gb, seq, accum,
            phase=phase, fixed=fixed)
        train_launches["flash_attention_backward"] += \
            fam_launches["flash_attention_backward"]
    sharded_launches = phase_train_sharded(torch, card)
    for name in ("flash_attention_backward", "grouped_matmul_backward",
                 "ssd_intra_chunk_backward"):
        train_launches[name] += sharded_launches[name]
    xla_launches = phase_xla_tools(torch, dev, card, dense)
    paper_launches = phase_paper(torch, dev)
    phase_resnet50(torch, dev, card)

    # each kernel's launches come from the served runs that drive it
    launches["grouped_matmul"] = moe_launches["grouped_matmul"]
    launches["ssd_intra_chunk"] = (hybrid_launches["ssd_intra_chunk"]
                                   + ssm_launches["ssd_intra_chunk"])
    launches["decode_attention"] = contig_launches["decode_attention"]
    # bf16 decode merges its splits in one launch: the combine kernel
    # runs on the f32 contiguous path and merges the sharded arena's banks
    launches["combine_splits"] = (f32_contig_launches["combine_splits"]
                                  + shard_launches["combine_splits"])
    launches["flash_attention"] = contig_launches["flash_attention"]
    for name in ("flash_attention_backward", "grouped_matmul_backward",
                 "ssd_intra_chunk_backward"):
        launches[name] = train_launches[name]
    for name in ("ws_matmul", "os_matmul"):   # the dataflow sweep, run twice
        launches[name] = ws_launches[name] + paper_launches[name]
    main_case = {"grouped_matmul": "grouped_matmul C64",
                 "ssd_intra_chunk": "ssd_intra_chunk l64",
                 "flash_attention": "flash_attention sq511 skv511",
                 "flash_attention_backward": "flash_attention_backward train",
                 "grouped_matmul_backward":
                     "grouped_matmul_backward gate/up",
                 "ssd_intra_chunk_backward":
                     "ssd_intra_chunk_backward mamba2-130m"}
    sources = {
        "paged_decode_attention": (
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention/kernel.py:245"),
        "paged_prefill_attention": (
            "src/repro_torch/kernels/csrc/paged_prefill.cu",
            "src/repro/kernels/paged_prefill/kernel.py:90"),
        "grouped_matmul": (
            "src/repro_torch/kernels/csrc/grouped_matmul.cu",
            "src/repro/kernels/grouped_matmul/kernel.py:36"),
        "ssd_intra_chunk": (
            "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "src/repro/kernels/ssd_scan/kernel.py:55"),
        "decode_attention": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:51"),
        # the merge the reference computes in XLA beside its Pallas kernel
        "combine_splits": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:94"),
        "flash_attention": (
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:64"),
        # the gradient of the same TPU kernel's function: the reference
        # differentiates its XLA twin and has no backward kernel
        "flash_attention_backward": (
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention/kernel.py:64"),
        # the gradients of the TPU kernels' functions: the reference
        # differentiates its einsum and XLA twins and has no backward
        # kernel
        "grouped_matmul_backward": (
            "src/repro_torch/kernels/csrc/grouped_matmul_bwd.cu",
            "src/repro/kernels/grouped_matmul/kernel.py:36"),
        "ssd_intra_chunk_backward": (
            "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
            "src/repro/kernels/ssd_scan/kernel.py:55"),
        "ws_matmul": (
            "src/repro_torch/kernels/csrc/ws_matmul.cu",
            "src/repro/kernels/ws_matmul/kernel.py:49"),
        "os_matmul": (
            "src/repro_torch/kernels/csrc/ws_matmul.cu",
            "src/repro/kernels/ws_matmul/kernel.py:87")}
    rows = []
    for name, (src, rep) in sources.items():
        t = timings[main_case.get(name, name)]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    emit({"phase": "total", "seconds": time.perf_counter() - t0,
          "launches": {"serve_vlm": vlm_launches,
                       "serve_tier": tier_launches,
                       "serve_front": front_launches,
                       "serve_tools": tools_launches,
                       "serve_sharded": shard_launches,
                       "train_sharded": sharded_launches,
                       "xla_tools": xla_launches,
                       **{f"serve_configs {a}": v
                          for a, v in config_launches.items()}}})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
