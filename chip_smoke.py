#!/usr/bin/env python3
"""Chip smoke for the PyTorch + CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught). A
``[time]`` line after each gives its wall seconds and the run's so far.

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build every kernel from ``src/repro_torch/csrc`` (one nvcc per source,
   started together) and print the build time and, per kernel entry,
   ptxas's registers, static shared memory and spills.
2b. qlint (``repro_torch.analysis``), the analysis path: compile the PTX
   of the eight kernels and the five qlint fixtures (``nvcc -ptx``, all
   started together); run ``qlint --ptx`` over the 17 registry entries
   (it must exit 0: no finding at the aten, launch-plan or PTX level, and
   every integer-scale certificate certified or capped) and ``qlint
   --fixtures --ptx`` (it must exit 1, with every fixture flagged under
   its reference rule from the aten/plan pass and, where the rule has a
   PTX form, from the PTX pass). Then the path: with the launch counts set
   to 0 just before, each fixture runs once on the card, its output equal
   to its plain version bit for bit, its inputs, pads and guards
   unchanged, and the counts must show each launched once. Each fixture
   is then timed beside its plain version (a replayed graph, except the
   one that goes through the host) and, for the two copies, ``clone``.
   One ``[qlint]`` line gives the entries, findings,
   certificate verdicts, the worst accumulator's share of 2^31 and the
   phase's time beside the card's name and power limit.
3. Hold each kernel against its plain PyTorch version on the card at the
   main-path shapes of LLaMA-2-7B (g128: decode M 1..4 and prefill M 128
   for (K, N) in (4096, 4096), (4096, 11008), (11008, 4096); act_quant
   also at K = 14336, Mixtral's down projection; flash
   attention at 128 tokens, 32 heads of 128) and time kernel, plain
   version, a single PyTorch library call where one computes the same
   function, and one bf16 ``torch.matmul`` of x by a bf16 (K, N) weight
   (the FP16 baseline the paper's speedups are measured against). Each
   is timed as a CUDA graph of back-to-back calls, replayed between CUDA
   events, so the host cannot pace a microsecond kernel; GEMM weights
   rotate over copies past 128 MB, so each launch reads them from device
   memory. act_quant, the IS GEMM (W4 and W8) and the coarse FS GEMM must
   be bit-exact; the fine FS GEMM (W4 at every shape, W8 at one decode
   shape) within rtol 1e-5 / atol 1e-4; W4A16 within ``REL_TOLERANCE`` x
   max|y|; flash attention within ``TOLERANCE`` (bf16 output; f32 inputs
   at the prefill shape), also at Mixtral's 32 query heads over 8 KV
   heads, with a window and at a ragged length, each timed beside SDPA.
   The GEMMs (IS, FS, W4A16) and flash must give the same bits on a
   second launch; each timed GEMM shape logs its launch plan (row tile,
   K split) and the paper's ratios (IS / FS, IS / W4A16, each / the bf16
   matmul, share of the bound). Then the
   grouped (MoE) kernels at Mixtral-8x7B's expert shapes, 8 experts,
   (4096 -> 14336) and
   (14336 -> 4096) at capacity 8 (4-slot decode) and 40 (128-token
   prefill), with seeded routed counts that include an empty expert, a
   full one and counts that are no multiple of the row tile: IS (W4, and
   W8 at one decode shape) and coarse FS bit-exact, fine FS within rtol
   1e-5 / atol 1e-4, W4A16 within ``REL_TOLERANCE`` x max|y|; each ragged
   entry point must equal its dense-grouped one (pre-quantized codes, no
   counts) bit for bit on the same zero-padded buffer, and repeat its
   bits on a second launch. The ragged W4A8 entries quantize the routed
   rows (act_quant's routed entry, held bit-exact to its plain version
   and timed alone) before the GEMM, whose epilogue divides by the
   experts' alphas; they are timed whole, as a linear that shares no
   quantization pays them, and once more at a forced K split (the split
   reduction's path; IS and coarse bit-exact there too). Beside each: the
   plain version, one bf16 ``torch.bmm`` over the same (E, C, K) buffer
   (the FP16 baseline; for W4A16 also the library call) and the bound
   (the routed experts' weight and scale bytes, or the routed rows'
   operations); per shape the paper's §5.5 ratios (grouped IS / FS, each
   / bmm, IS / W4A16, share of the bound). A tree whose grouped W4A8
   wrappers take no ``splits=`` (an earlier commit) skips the routed and
   forced-split parts.
   Then the widths of phase 8c's configs: act_quant also at K = 8192,
   29568, 6144, 24576 and 6400; the IS GEMM bit-exact at Qwen2-72B's and
   Granite-34B's (K, N) (``CONFIG_GEMM_KN``, Granite's single KV head at
   N = 128 included), timed beside its plain version, its bound and a
   bf16 ``torch.matmul``, with its launch plan; flash attention at 64
   query heads over 8 and 48 over 1 (heads of 128); the ragged IS GEMM
   and act_quant's routed entry at Phi-3.5-MoE's 16 experts, (4096 ->
   6400) and (6400 -> 4096) at capacity 8 and 24, bit-exact and timed
   beside a bf16 ``torch.bmm``.
   Then the widths of phase 8d's MLA models: act_quant also at K = 2560,
   768, 256 (MiniCPM3) and 5120, 1536, 512, 16384, 12288, 3072
   (DeepSeek-V2); the IS GEMM bit-exact at (K, N) = (2560, 288), (5120,
   576), (1536, 24576), (16384, 5120), (256, 2560), (512, 16384)
   (``MLA_GEMM_KN``: N = 288 and 576 are no multiple of the 64-column
   tile), timed as above; flash attention at 8 query heads over 2 KV
   heads of 32 (bf16 and f32; Qwen2-72B's smoke heads); the ragged IS
   GEMM and act_quant's routed entry at DeepSeek-V2's 160 experts, (5120
   -> 1536) and (1536 -> 5120) at capacity 8, with row counts from a
   seeded top-6 routing of 4 and of 128 tokens, bit-exact, equal to the
   dense-grouped entry and timed beside a bf16 ``torch.bmm``.
4. Build ``llama2-7b`` at its full published widths (32 layers) in bf16
   from a seeded generator on the card, and RTN-quantize it under four
   recipes: W4A8 IS g128 alpha=1024 (the paper's), W4A8 FS g128 (Eq. 1),
   W4A8 per-channel (coarse, the OdysseyLLM baseline) and W4A16 g128 (the
   Marlin analog). Then free the fp weights.
5. Serve 8 seeded prompts (lengths 16..128) with each recipe through
   ``Engine.submit`` / ``Engine.run`` with 4 slots, prefill_len 128,
   max_seq 256 and 32 new tokens. The engine captures its prefill and
   decode steps once each as CUDA graphs and replays them
   (``serving/graphs.py``): ``prefill_traces`` and ``decode_traces`` must
   both be 1 (``[steps]``). For each recipe: every outcome ``ok``; the
   kernels the recipe runs launched (> 0) and the others did not (== 0),
   counted from 0 just before the run, and each kernel's count is
   exactly its captured launches in the decode graph times (ticks + 1
   warm-up call) plus the prefill graph's times (admits + 1); the
   engine's first token for prompt 0 is the argmax of that model's
   logits; peak device memory while serving, graphs' pool included. For
   IS the engine's streams equal a plain eager greedy loop over the same
   model on the engine's schedule (``eager_greedy``), and the first
   layers, copied to the CPU where every wrapper takes its plain version,
   must agree with the same layers on the card within a stated bound,
   on a prefill that writes the KV cache and one decode step that reads
   it back.
   One 4-slot decode step and one 128-token prefill of seeded tokens
   are timed eagerly and as replayed CUDA graphs (the difference is the
   host's share of an eager step); the served tick's idle share is 1 - the device timer's
   mean over the tick's. The greedy token streams' sha256 is logged
   (``[tokens]``), so two trees run on one card can be compared on the
   same seed. One more eager decode step counts each kernel's launches
   in a tick (``[launches]``): act_quant exactly 4 a layer under IS, FS
   and coarse (q/k/v share one quantization, gate/up another; 7 in a
   tree whose linears each quantize their own), none under W4A16.
5b. ``[kv8]``: the int8 KV cache. ``quantize_kv`` on the card equals the
   CPU's bit for bit on one seeded (4, 128, 32, 128) bf16 input; then the
   IS weights served with ``kv_cache_dtype="int8"`` (int8 codes and f32
   per-token, per-head scales, written in place, splice of every key into
   the slot) and checked as IS is in phase 5: outcomes, one capture per
   step, exact launches, the argmax, streams equal to the eager greedy
   loop under the same cache, the first 2 layers against the CPU's plain
   versions through the cache (a prefill, then a decode step that reads
   it back), act_quant 4 a layer. Logs the cache's bytes in bf16 and
   int8, the tick, device timer and idle share, and the share of stream
   tokens equal to phase 5's bf16-cache IS streams (not a gate).
6. Breaker drill: serve the IS weights with the FS weights as the
   circuit breaker's fallback (threshold 2) while a ``ChaosMonkey``
   fails the decode at tick 3 twice; the engine must fall back once,
   capture both steps once more (``decode_traces == prefill_traces ==
   2``), serve every request ``ok`` through ``w4a8_gemm_fs``, and launch
   exactly the IS graphs' counts up to the fallback and the FS graphs'
   after it.
7. Profile one IS and one W4A16 decode step under ``obs.trace_window``
   and print each step's device time, its number of device kernel
   launches, the share of it in the quantized GEMMs and their split
   reductions, and the eight device kernels with the most CUDA time. The
   IS step must run no elementwise division kernel (``DivFunctor``): the
   GEMM's epilogue divides ``sa / alpha``.
   Free the llama2-7b weights.
7b. ``[calib]``: ``llama2-7b`` at full width cut to 8 of its 32 layers
   (bf16, seed 0), its fp weights drawn whole and run over 2 seeded synthetic
   calibration batches of 4 x 128 tokens with the capture on
   (``ptq.collect_calibration``: 512 rows per linear). For each of layer
   0's seven linears, AWQ's and OmniQuant's calibration output MSE must
   be at most RTN's (both grids hold the RTN point). Then W4A8 g128 IS
   under GPTQ, AWQ, SmoothQuant and OmniQuant in turn (each PTQ, which
   captures the batches again, timed; the fp weights freed before
   OmniQuant is served, held while the others are), each served as in
   phase 5: every outcome ``ok``, one
   capture per step, exactly the IS kernels and the graphs' counts, the
   first token the argmax, the first layer against the CPU's plain
   versions; GPTQ's and AWQ's streams equal the eager greedy loop;
   ``[launches]``: act_quant 4 a layer under GPTQ and OmniQuant, 7 under
   AWQ and SmoothQuant (each linear divides its own input by its
   ``pre_scale`` before quantizing it).
8. ``mixtral-8x7b`` at full width (32 layers, 8 experts top-2, expert d_ff
   14336), built block by block (``ptq.quantize_by_layer``: one block's
   fp weights on the card at a time) under IS, FS and W4A16, one recipe at
   a time, each served as in phase 5 (same prompts and ``ServeConfig``):
   every outcome ``ok``, one capture of each step, exactly the recipe's
   kernels launched (the grouped kernel of its scheme on every expert
   linear) and exactly the graphs' counts, the first token of prompt 0
   the argmax of the logits, ``engine_moe_m_tiles_total`` executed <=
   total and > 0 (the routing records the decode graph's capture made,
   handed on after every replay), and for IS the streams equal the eager
   greedy loop and the first layer on the card agrees with the same
   layer on the CPU. The decode step is timed eagerly
   and as a captured CUDA graph with no routing sink attached; the
   capture is itself the check that the MoE layer makes no host sync.
   The tick's launches are counted as in phase 5: act_quant exactly 2
   dense (q/k/v, o) and 2 routed (gate/up, down) a layer under IS and
   FS (4 and 3 in a tree whose linears each quantize their own).
8b. ``[llama3]``: ``llama3.2-3b`` at full width cut to 14 of 28 layers (24 query
   heads over 8 KV heads of 128, bf16, seed 0) quantized under the
   paper's LLaMA-3 recipe (``LLAMA3_RECIPE``: W8A8 g128 heuristic+6 on
   the down projections, W4A8 g128 IS elsewhere, QuaRot rotation on every
   linear, one rotation per (K, layer) shared by the linears that take
   it); every down projection's overflow certificate must be certified
   or capped. Served as in phase 5 (streams equal the eager greedy loop;
   act_quant 7 a layer; one tick's quantized GEMM calls 168 W4A8 IS and
   28 W8A8 IS), then one eager decode step profiled with shapes for the
   device time of its 196 ``x @ rot`` products, which are also timed
   alone as a replayed graph.
8c. ``[configs]``: ``qwen2-72b`` (80 layers, 64 query heads over 8 KV
   heads of 128, d_ff 29568, QKV bias), ``granite-34b`` (88 layers, MQA:
   48 query heads over one KV head, d_ff 24576) and
   ``phi3.5-moe-42b-a6.6b`` (32 layers, 16 experts top-2 of d_ff 6400),
   each at full width and full depth under W4A8 g128 IS, built block by
   block with seed 0; every certificate certified or capped, each capped
   layer printed. Each is served as in phase 8 (outcomes, captures,
   exact launches, the argmax, m-tiles for Phi), Qwen2-72B a second time
   over an int8 KV cache on the same weights; build seconds, peak memory
   building and serving, tick, prefill, TTFT, idle share and the (K,
   dtype) of every dense act_quant row are logged. Each model is freed
   before the next is built.
8d. ``[mla]``: ``minicpm3-4b`` (40 heads, q_lora 768, kv_lora 256, rope
   32, nope 64, v 64, d_ff 6400) at full width cut to 20 of 62 layers and
   ``deepseek-v2-236b`` at full width cut to 24 layers (its dense first
   layer of d_ff 12288 and 23 MoE layers of 160 experts top-6 of d_ff
   1536 plus 2 shared; 128 heads, q_lora 1536, kv_lora 512, rope 64,
   nope 128, v 128, vocab 102400), W4A8 g128 IS built block by block
   with seed 0, every certificate certified or capped (the o projection
   at K = 16384 printed), served as in phase 8 with a latent cache:
   outcomes, one capture per step, exactly the IS kernels and the
   graphs' counts (no flash: MLA's prefill attention is plain PyTorch,
   as the reference's), act_quant per graph exactly 6 (prefill) or 5
   (decode) dense a layer and 2 routed a MoE layer, the argmax, m-tiles,
   the streams equal the eager greedy loop, the first layer against
   the CPU's plain versions through the latent cache. One decode step
   is profiled: the share of the MLA decode's f32 einsums, of
   ``_dense_weight`` (k_up and v_up dequantized inside the step) and of
   the quantized GEMMs. TF32 must be off.
8e. ``[xattn]``: cross attention through the model API, not the engine
   (the engine passes no memory, as the reference's does not):
   ``llama-3.2-vision-90b`` at all 100 layers (80 self, 20 gated cross
   layers; d_model 8192, 64 heads over 8 of 128, d_ff 28672, vocab
   128256) built block by block, and ``whisper-tiny`` whole (4 encoder
   + 4 decoder layers, d_model 384, 6 heads of 64), W4A8 g128 IS, seed
   0, every certificate certified or capped (each capped one printed).
   The VLM's cross gates, 0 at the reference's init, are drawn uniform in
   [0.5, 1.5]. One prefill of 4 seeded 128-token prompts with a seeded
   bf16 memory (4 x 1600 image tokens, 4 x 1500 frames) fills the self
   and cross caches, then 32 greedy decode steps run eagerly and as one
   captured CUDA graph replayed (the VLM at per-row positions, Whisper at
   a 0-d position tensor): the tokens must be equal, the first token the
   argmax of a train-mode forward, and each prefill's and decode step's
   launches exactly the counts derived from the sharing
   (:func:`xattn_launches`: VLM 420 act_quant, 700 IS GEMMs, 100 flash a
   prefill and 400, 660, 20 a step; Whisper 44, 64, 12 and 24, 32, 4).
   Then the kernels against the CPU's plain versions at B = 1 through
   the caches (the VLM's first cross layer fed the card's own hidden
   state; Whisper whole), timing (tokens/s of the
   replayed loop, the replayed step, the prefill), peaks, cache MB, and
   one decode step profiled (the flash and GEMM shares; the cross
   attention modules timed alone as a replayed graph).
   Phase 3 runs the new shapes first: flash non-causal at Sq != Sk
   (``XATTN_FLASH``, beside SDPA), act_quant at K = 28672 and 384 and at
   the memory's 6400 x 8192 and 6000 x 384 rows, the IS GEMM at the
   VLM's MLP and Whisper's widths (``XATTN_GEMM_KN``) and at M = 6400 /
   6000 (``XATTN_BIG_M``, also at forced K splits of 1 and 2).
8f. ``[recurrent]``: the recurrent families at full width and depth,
   W4A8 g128 IS built block by block (seed 0), every certificate
   certified or capped. ``xlstm-1.3b`` cut to 16 of 48 layers (14
   mLSTM, 2 sLSTM) served through the engine with phase 5's prompts and ``ServeConfig``
   and phase 8's checks: outcomes, one capture per step, exactly the IS
   kernels and the graphs' counts, each graph's launches the derived
   ones (:func:`recurrent_launches`: act_quant 4 an mLSTM and 3 an sLSTM
   layer, no flash), the argmax, the streams equal to the eager greedy
   loop that prefills the same padded prompts from a zero state (the
   reference engine's semantics), the first 2 layers against the CPU
   through the state; how many of the first 2 streams equal a loop over
   the unpadded prompts is printed, not held; the state's MB. ``recurrentgemma-9b``
   (38 layers: 26 RG-LRU, 12 local attention at head dim 256, window
   2048) through the model API (the engine refuses it: its decode takes
   one scalar position): a prefill of 4 seeded 128-token prompts, 32
   greedy steps at a 0-d position eager and as a replayed CUDA graph
   (``serving.graphs.Step``, which restores the state its warm-up
   advanced): equal tokens, the first token the argmax of a train-mode
   forward, launches exactly the derived counts (152 act_quant, 240 IS
   GEMMs, 12 flash a prefill; 152, 240, 0 a step); one 2,300-token
   prompt past the window prefilled and decoded 4 steps against a
   train-mode forward over the same tokens (5e-2 of the largest logit);
   its first 3 layers (2 RG-LRU, the first local attention) against the
   CPU. One decode step of each is profiled (``[profile] recurrent``:
   the shares of the quantized GEMMs, the mLSTM cell, the sLSTM step,
   the RG-LRU gates and scan, local-attention decode and the f32 logit
   head). Phase 3 runs their widths first: flash at 16 query heads over
   one of 256 (1 x 128, and 1 x 4096 with the window of 2048; bf16 and
   f32), act_quant at K = 2048 and 2816, the IS GEMM at
   ``RECURRENT_GEMM_KN``.
8g. ``[train]``: training (:func:`train_phase`). ``llama3.2-3b`` at
   full width and all 28 layers, bf16, remat on, the reference's AdamW
   defaults, 6 steps of 4 x 1024 synthetic tokens through
   ``launch.train.train_loop``: per-step ms by CUDA events (the first
   apart), tokens/s, peak memory, losses and grad norms (finite), the
   host's batch time apart; launches exactly 2 flash forwards (remat
   recomputes) and 1 flash backward a layer and step; ``grad_accum=2``
   against 1 on one batch; one step profiled (flash forward, flash
   backward, GEMMs, the f32 logit head, AdamW, the rest). Its first 2
   layers at full width on the card against the CPU (loss 1e-2, each
   leaf's gradient 5e-2). The restart drill on ``bench-lm-30m`` (f32):
   resumed params equal the uninterrupted run's (rtol 1e-5 / atol 1e-6;
   bit-equality printed), the loss at most 0.8 of its first step, the
   eval loss under fp, W4A8 IS and FS printed. Phase 3 runs the flash
   backward kernel first (``FLASH_BWD``: llama3.2-3b's step, the bench
   LM's heads of 64 in f32, a window, non-causal Sq != Sk) against its
   plain version (``BWD_REL_TOLERANCE``), bit-repeatable, timed beside
   the plain version and SDPA's backward, each row with its launch plan
   (the bf16 heads split, dK/dV and dQ blocks); ``[bwd]`` lines give
   ptxas's registers and spills of each backward entry beside the bf16
   blocks' dynamic shared memory, and a spill at head dim 128 fails.
8h. ``[train-moe]``: training the MoE family and MLA
   (:func:`train_moe_phase`). ``mixtral-8x7b`` at full width (8 experts
   top-2 of 14336, capacity factor 1.25: tokens dropped) cut to 2 of 32
   layers, bf16, remat, 4 steps of 4 x 1024 tokens through
   ``launch.train.train_loop``: step ms, tokens/s, peak, loss, ce, aux
   (> 0) and grad norm (finite), each MoE layer's dropped share, launches
   exactly 2 flash forwards and 1 backward a layer and step; one step
   with ``moe_int8_dispatch`` against one without at lr 0 (printed);
   whether two equal forwards and backwards repeat bit for bit; one step
   profiled (the expert GEMMs, dispatch and combine, the router, flash
   forward and backward, AdamW, the rest). Its first layer at full width
   in f32 against the CPU (routed counts compared first, any flip
   printed; loss, aux and every gradient within 1e-2 / 5e-2), on a
   synthetic batch and on one whose first half is one token repeated
   (tokens dropped).
   ``minicpm3-4b`` (MLA) at full width cut to 4 of 62 layers, bf16, 3
   steps of 2 x 1024 (no kernel launched: MLA's prefill attention is
   plain PyTorch, as the reference's is jnp), its first layer in f32
   against the CPU; ``deepseek-v2-236b``'s smoke layout (a dense layer,
   then MoE with shared experts over MLA) in f32 at top-2 and top-6
   against the CPU, each repeated on the card for bit equality.
8i. ``[train-rec]``: training the recurrent families
   (:func:`train_rec_phase`). ``recurrentgemma-9b`` at full width cut to
   8 of 38 layers (the reference's prefix of 2 RG-LRU layers, then 2
   whole (rec, rec, attn) patterns), bf16, remat, 4 steps of 1 x 4096
   tokens (the window of 2048 masks): step ms, tokens/s, peak and
   resident memory, finite metrics, launches exactly 2 flash forwards
   and 1 backward (head dim 256) a local-attention layer and step; two
   equal forwards and backwards bit for bit; one step profiled (flash
   forward and backward, the f32 head, AdamW, the rest; the RG-LRU's
   range apart). Its first 3 layers in f32 against the CPU (the f32
   backward at head dim 256). ``xlstm-1.3b`` at full width cut to one
   period of 8 of 48 layers (7 mLSTM, 1 sLSTM), 3 steps of 2 x 256
   under the per-token scan (its device launches a step printed: host
   time) and one chunkwise, its first 2 layers in f32 against the CPU.
   Phase 3 adds the backward at head dim 256 (16 over 1 head: the train
   shape, 2 x 512 causal, non-causal Sq != Sk; bf16 and f32) beside its
   plain version and SDPA's backward, with the profile of each kernel at
   the train shape.
8j. ``[train-xattn]``: training the cross-attention families
   (:func:`train_xattn_phase`), through ``make_train_step`` with each
   batch's memory seeded on the card (``launch.train`` feeds none, as the
   reference's does not). ``whisper-tiny`` whole (4 + 4 layers), bf16,
   remat (the decoder blocks), 4 steps of 8 x 448 tokens over 8 x 1500
   frames: step ms, tokens/s, peak and resident memory, finite metrics,
   launches exactly 20 flash forwards and 12 backwards a step (the
   encoder's 4, the decoder's causal self and cross attention, rematted);
   two equal forwards and backwards bit for bit; one step profiled; then
   whole in f32 against the CPU on 2 x 448. ``llama-3.2-vision-90b`` at
   full width cut by depth to one self and one cross layer (the cut
   reckoned from the spec trees' bytes and logged), gates drawn by
   :func:`set_cross_gates`, 4 steps of 2 x 1024 tokens over 2 x 1600
   image tokens, the same checks (4 forwards, 2 backwards a step), both
   layers in f32 against the CPU on 1 x 64 tokens. Phase 3 adds the
   backward at their shapes (Whisper's encoder 1500 over 1500, decoder
   causal 448, cross 448 over 1500; the VLM's cross 1024 over 1600 at
   G = 8; bf16 and f32) and a head split at a ragged Sk = 1500.
9. Print the ``kernels`` JSON line (the nine kernels, launches summed
   over every served and training path; the five qlint fixtures,
   launches from their run in phase 2b), then the result line
   ``{"ok": true, "device": {...}}`` last.

Per-shape and per-recipe numbers also go to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores

GEMM_KN = ((4096, 4096), (4096, 11008), (11008, 4096))
# act_quant's rows: LLaMA-2-7B's two K and Mixtral's down projection; then
# Qwen2-72B's (8192, 29568), Granite-34B's (6144, 24576) and Phi-3.5-MoE's
# routed down projection (6400); then MiniCPM3's x / o input (2560), cq
# (768) and c_kv (256), and DeepSeek-V2's x (5120), cq and the routed
# down projection (1536), c_kv (512), o input (16384), the dense layer's
# down projection (12288) and the shared experts' (3072); then
# Llama-3.2-Vision's down projection (28672) and Whisper-tiny's x (384)
# then xLSTM-1.3B's x (2048) and sLSTM ff_down input (2816; its
# RecurrentGemma-9B widths 4096 and 12288 are above)
ACT_QUANT_K = (4096, 11008, 14336, 8192, 29568, 6144, 24576, 6400,
               2560, 768, 256, 5120, 1536, 512, 16384, 12288, 3072, 28672,
               384, 2048, 2816)
# the IS GEMM at Qwen2-72B's linears (K, N): q/o, k/v, gate/up, down; and
# Granite-34B's: q/o, its single KV head (N = 128), gate/up, down
CONFIG_GEMM_KN = ((8192, 8192), (8192, 1024), (8192, 29568), (29568, 8192),
                  (6144, 6144), (6144, 128), (6144, 24576), (24576, 6144))
# the IS GEMM at MLA's widths (K, N): MiniCPM3's kv_down (N = 288, 4.5
# column tiles of 64) and k_up / v_up; DeepSeek-V2's kv_down (N = 576),
# q_up, o (K = 16384) and k_up / v_up
MLA_GEMM_KN = ((2560, 288), (5120, 576), (1536, 24576), (16384, 5120),
               (256, 2560), (512, 16384))
DECODE_M = (1, 2, 3, 4)
PREFILL_M = 128
TIMED_M = (4, PREFILL_M)
GROUP = 128
# rotate weight copies so the timed launches read them from device memory,
# as the serving path does (the 50 MB L2 cannot hold a layer's weights
# across a decode tick of 32 layers)
ROTATE_BYTES = 128 << 20
# fine float scale: f32 group sums in another order than torch.sum
FS_RTOL, FS_ATOL = 1e-5, 1e-4
# logits of the first layers on the CPU (every wrapper's plain version)
# vs the same layers on the card (the kernels), relative to the largest
# logit: flash and plain attention differ by a bf16 ulp, and the CPU's
# elementwise ops by f32 ulps; each such difference can flip an int8
# activation code, and through all 32 random layers the flips grow to
# several percent of the logits, so the check stops after two layers
PLAIN_CHECK_LAYERS = 2
# substrings of the quantized GEMM kernels' device names (both designs),
# for the profile's GEMM share
GEMM_KERNELS = ("w4a8_", "w4a16_", "splitk_reduce")
PLAIN_LOGIT_REL_TOL = 5e-2
KERNELS_OF = {  # recipe -> kernels its serve must launch; the rest must not
    "w4a8-is": {"act_quant", "w4a8_gemm_is", "flash_attention"},
    "w4a8-fs": {"act_quant", "w4a8_gemm_fs", "flash_attention"},
    "w4a8-coarse": {"act_quant", "w4a8_gemm_fs", "flash_attention"},
    "w4a16-fg": {"w4a16_gemm", "flash_attention"},
}
# the same on Mixtral: the recipe's dense kernels (attention linears) and
# its grouped kernel (every expert linear)
MOE_KERNEL_OF = {"w4a8-is": "moe_w4a8_is", "w4a8-fs": "moe_w4a8_fs",
                 "w4a16-fg": "moe_w4a16"}
# Mixtral-8x7B's expert linears: 8 experts, (K, N) of gate/up and of down,
# at the 4-slot decode capacity and the 128-token prefill capacity
# (models.moe.capacity(4, 2, 8, 1.25) = 8, capacity(128, 2, 8, 1.25) = 40)
MOE_E = 8
MOE_KN = ((4096, 14336), (14336, 4096))
MOE_C = (8, 40)
# the forced K split of the grouped W4A8 kernels: Mixtral's down
# projection at the decode capacity (its plan runs unsplit)
MOE_SPLIT = (14336, 4096, 8, 4)  # K, N, C, splits
# Phi-3.5-MoE's expert linears: 16 experts, gate/up and down, at the 4-slot
# decode capacity and the 128-token prefill capacity
# (models.moe.capacity(4, 2, 16, 1.25) = 8, capacity(128, 2, 16, 1.25) = 24)
PHI_E = 16
PHI_KN = ((4096, 6400), (6400, 4096))
PHI_C = (8, 24)
# DeepSeek-V2's routed experts: 160 of them, gate/up and down, at capacity
# 8 for the 4-slot decode and the 128-token prefill alike
# (models.moe.capacity(4, 6, 160, 1.25) = capacity(128, 6, 160, 1.25) = 8),
# with routed counts from a seeded top-6 routing of 4 and of 128 tokens
DS_E, DS_TOP_K, DS_C = 160, 6, 8
DS_KN = ((5120, 1536), (1536, 5120))
DS_TOKENS = (4, 128)
# qlint: each fixture's reference rule, and the rule its PTX must show
# where the rule has a PTX form (tests/test_qlint.py's map)
QLINT_RULE = {"broken-fp32-dot": "float-accum-on-is-path",
              "broken-no-preferred": "int-dot-preferred-type",
              "broken-narrowing": "narrowing-convert",
              "broken-index-map": "index-map-bounds",
              "broken-divisibility": "blockspec-divisibility"}
QLINT_PTX_RULE = {"broken-fp32-dot": "float-accum-on-is-path",
                  "broken-narrowing": "narrowing-convert"}
# the one PyTorch call that computes a fixture, where there is one: the two
# copies (the dot fixtures' int8 products have no CUDA library call at M = 8)
QLINT_LIBRARY = {"broken_index_map": lambda x: x.narrow(0, 4, 8).clone(),
                 "broken_divisibility": lambda x: x.clone()}
# kernels vs plain versions on Mixtral's first layer (a MoE layer; the
# CPU's plain grouped GEMMs take about 15 s a layer on the card's 8-core
# host, so one, where llama2-7b checks two), with the same bound
MIXTRAL_PLAIN_CHECK_LAYERS = 1
# phase 7b: the calibration algorithms on llama2-7b, calibrated on this
# many seeded synthetic batches of 4 x 128 tokens
CALIB_ALGOS = ("gptq", "awq", "smoothquant", "omniquant")
CALIB_BATCHES = 2
# phase 8b: llama3.2-3b under the LLaMA-3 recipe, cut to 14 of its 28
# layers (QuaRot's rotations and the W8A8 certificates are per layer)
LLAMA3_LAYERS = 14
# the calibrated llama2-7b's depth: its first 8 of 32 layers (the
# calibration, PTQ and serving are per layer; phase 5 serves all 32)
CALIB_LAYERS = 8
# each calibrated model's layers held against the CPU's plain versions
# (about 5 s a llama2-7b layer; phase 5 holds two of the RTN model's)
CALIB_PLAIN_CHECK_LAYERS = 1
# phase 8c: the configs served at full width and depth under W4A8 g128 IS
CONFIG_ARCHS = ("qwen2-72b", "granite-34b", "phi3.5-moe-42b-a6.6b")
# phase 8d: the MLA models at full width under W4A8 g128 IS, MiniCPM3 at
# its full depth, DeepSeek-V2 cut to its dense layer plus 23 MoE layers
# (all 60 are about 127 GB under W4A8; 24 are about 52 GB)
MLA_ARCHS = ("minicpm3-4b", "deepseek-v2-236b")
MLA_DEPTH = {"deepseek-v2-236b": 24, "minicpm3-4b": 20}
# the MLA models' layers held against the CPU's plain versions: the first
# (DeepSeek-V2's dense one; its first MoE layer of 160 experts took about
# 50 s of the CPU)
MLA_PLAIN_CHECK_LAYERS = 1
# phase 8e: cross attention at full width under W4A8 g128 IS, through the
# model API (prefill with memory, then greedy decode over the caches):
# Llama-3.2-Vision at all 100 layers (80 self, 20 cross), Whisper-tiny whole
XATTN_ARCHS = ("llama-3.2-vision-90b", "whisper-tiny")
XATTN_B, XATTN_PROMPT, XATTN_STEPS, XATTN_MAX_SEQ = 4, 128, 32, 256
# the reference's init leaves every cross gate at 0, and tanh(0) multiplies
# each cross layer's output away: the gates are drawn uniform in [0.5, 1.5]
# from this seed after building
XATTN_GATE_SEED = 17
# the VLM's first cross layer, held against the CPU on the card's own input
XATTN_CROSS_LAYER = 4
# phase 3 at phase 8e's shapes: the IS GEMM at the VLM's MLP (K, N) and
# Whisper's (K, N) at M = 1..4 and 128; at the memory's rows (4 x 1600
# image tokens, 4 x 1500 frames): the VLM's cross k/v at M = 6400 and
# Whisper's linears at M = 6000 (M, K, N); act_quant at those rows (M, K)
XATTN_GEMM_KN = ((8192, 28672), (28672, 8192), (384, 384), (384, 1536),
                 (1536, 384))
XATTN_BIG_M = ((6400, 8192, 1024), (6000, 384, 384), (6000, 384, 1536),
               (6000, 1536, 384))
XATTN_ACT_ROWS = ((6400, 8192), (6000, 384))
# flash attention, non-causal over a memory (B, Sq, Sk, Hq, Hkv, D): the
# VLM's cross prefill and decode, Whisper's encoder and its cross decode
XATTN_FLASH = ((1, 128, 1600, 64, 8, 128), (4, 1, 1600, 64, 8, 128),
               (1, 1500, 1500, 6, 6, 64), (4, 1, 1500, 6, 6, 64))
# phase 8f: the recurrent families at full width and depth under W4A8 g128
# IS: xLSTM-1.3B served through the engine (phase 5's prompts and
# ServeConfig), RecurrentGemma-9B through the model API (the engine
# refuses it: its decode takes one scalar position): a prefill of
# RG_B seeded RG_PROMPT-token prompts, then RG_STEPS greedy decode steps
# at a 0-d position, eager and as a replayed CUDA graph; then one prompt
# of RG_LONG tokens, past the window of 2048, and RG_LONG_STEPS decode
# steps held to a train-mode forward over the same tokens
RECURRENT_SERVED, RECURRENT_API = "xlstm-1.3b", "recurrentgemma-9b"
# the served xLSTM cut to two of its periods (16 of 48 layers: 14 mLSTM,
# 2 sLSTM), so its eager loops fit the run's time
RECURRENT_SERVED_LAYERS = 16
RG_B, RG_PROMPT, RG_STEPS, RG_MAX_SEQ = 4, 128, 32, 256
RG_LONG, RG_LONG_STEPS = 2300, 4
# RecurrentGemma's first layers held against the CPU: its two RG-LRU
# layers and its first local attention
RG_PLAIN_CHECK_LAYERS = 3
# the served xLSTM's streams set beside an eager loop over the unpadded
# prompt (information, not a gate; about 5 s a prompt): the first two
RECURRENT_UNPADDED_PROMPTS = 2
# phase 3 at phase 8f's widths: the IS GEMM at RecurrentGemma-9B's (K, N)
# (gate / up, down, the single KV head of 256; q, o, gate_proj, x_proj
# and out_proj are GEMM_KN's 4096 -> 4096) and xLSTM-1.3B's (up and wx,
# down, the sLSTM's ff_gate / ff_up and ff_down: K = 2816 is 22 groups)
RECURRENT_GEMM_KN = ((4096, 12288), (12288, 4096), (4096, 256),
                     (2048, 8192), (4096, 2048), (2048, 2816), (2816, 2048))
# phase 3, the flash-attention backward kernel (B, Sq, Sk, Hq, Hkv, D,
# causal, window, dtype): phase 8g's llama3.2-3b step, the bench LM's heads
# of 64 in f32, a window across key tiles, non-causal with Sq != Sk; then
# RecurrentGemma's heads of 256 (16 over 1) in bf16 and f32: phase 8i's
# train shape (the window of 2048 over 4096 tokens), 2 x 512 causal, and
# non-causal with Sq != Sk; then phase 8j's train shapes in bf16 and f32:
# Whisper's encoder (8 x 1500 over 1500, 6 heads of 64: 1500 is no
# multiple of a key tile), decoder (causal 448) and cross attention (448
# over 1500), the VLM's cross layer (2 x 1024 over 1600, 64 over 8 heads
# of 128: G = 8); and G = 8 over one kv head at a ragged Sk = 1500, whose
# 24 key tiles make the bf16 plan split each group's heads 8 ways
FLASH_BWD = ((4, 1024, 1024, 24, 8, 128, True, None, "bfloat16"),
             (8, 256, 256, 8, 8, 64, True, None, "float32"),
             (2, 1024, 1024, 8, 2, 128, True, 256, "bfloat16"),
             (2, 256, 1024, 8, 2, 64, False, None, "bfloat16")) + tuple(
    (*shape, dt) for shape in ((1, 4096, 4096, 16, 1, 256, True, 2048),
                               (2, 512, 512, 16, 1, 256, True, None),
                               (2, 256, 1024, 16, 1, 256, False, None))
    for dt in ("bfloat16", "float32")) + tuple(
    (*shape, dt) for shape in ((8, 1500, 1500, 6, 6, 64, False, None),
                               (8, 448, 448, 6, 6, 64, True, None),
                               (8, 448, 1500, 6, 6, 64, False, None),
                               (2, 1024, 1600, 64, 8, 128, False, None))
    for dt in ("bfloat16", "float32")) + (
    (1, 300, 1500, 8, 1, 128, False, None, "bfloat16"),)
# phase 8g: training. llama3.2-3b at full width and depth, bf16, remat on,
# the reference's AdamWConfig defaults, TRAIN_STEPS steps of TRAIN_B x
# TRAIN_S synthetic tokens through launch.train.train_loop; then its first
# TRAIN_CPU_LAYERS layers at full width against the CPU on TRAIN_CPU_B x
# TRAIN_CPU_S tokens; then the restart drill on bench-lm-30m (f32)
TRAIN_ARCH, TRAIN_STEPS, TRAIN_B, TRAIN_S = "llama3.2-3b", 6, 4, 1024
TRAIN_CPU_LAYERS, TRAIN_CPU_B, TRAIN_CPU_S = 2, 2, 128
TRAIN_CPU_LOSS_REL, TRAIN_CPU_GRAD_REL = 1e-2, 5e-2
# grad_accum=2 against grad_accum=1 on one batch (lr 0, so both read the
# same params): the same mean over the same tokens, bf16 products over
# other row counts (loss); bf16 gradients summed in f32 (grad norm)
TRAIN_ACCUM_LOSS_REL, TRAIN_ACCUM_NORM_REL = 1e-3, 1e-2
DRILL_STEPS, DRILL_CKPT_EVERY, DRILL_FAIL_AT = 40, 10, 25
DRILL_LOSS_RATIO = 0.8
# phase 8h: training the MoE family and MLA. Mixtral-8x7B at full width
# cut to TRAIN_MOE_LAYERS layers (bf16, remat, TRAIN_MOE_STEPS steps of
# TRAIN_MOE_B x TRAIN_MOE_S tokens), then its first layer in f32 against
# the CPU on TRAIN_MOE_CPU_B x TRAIN_MOE_CPU_S tokens; MiniCPM3-4B (MLA)
# at full width cut to TRAIN_MLA_LAYERS layers the same way; DeepSeek-V2's
# smoke config (f32, top-2 and top-6) on TRAIN_SMOKE_B x TRAIN_SMOKE_S
# tokens against the CPU. The CPU checks hold the TRAIN_CPU_* bounds.
TRAIN_MOE_ARCH, TRAIN_MOE_LAYERS, TRAIN_MOE_STEPS = "mixtral-8x7b", 2, 4
TRAIN_MOE_B, TRAIN_MOE_S, TRAIN_MOE_CPU_B, TRAIN_MOE_CPU_S = 4, 1024, 1, 256
TRAIN_MLA_ARCH, TRAIN_MLA_LAYERS, TRAIN_MLA_STEPS = "minicpm3-4b", 4, 3
TRAIN_MLA_B, TRAIN_MLA_S = 2, 1024
TRAIN_SMOKE_ARCH, TRAIN_SMOKE_B, TRAIN_SMOKE_S = "deepseek-v2-236b", 2, 64
# phase 8i: training the recurrent families. RecurrentGemma-9B at full
# width cut to TRAIN_RG_LAYERS layers (the reference's prefix of 2 RG-LRU
# layers, then 2 whole (rec, rec, attn) patterns: 2 local-attention
# layers), bf16, remat, TRAIN_RG_STEPS steps of TRAIN_RG_B x TRAIN_RG_S
# tokens (the window of 2048 masks the keys more than 2048 back), then
# its first TRAIN_RG_CPU_LAYERS layers in f32 against the CPU on
# TRAIN_MOE_CPU_B x TRAIN_MOE_CPU_S tokens. xLSTM-1.3B cut to one period
# of TRAIN_XLSTM_LAYERS layers (7 mLSTM, 1 sLSTM), TRAIN_XLSTM_STEPS steps
# of TRAIN_XLSTM_B x TRAIN_XLSTM_S tokens under its config's per-token
# scan (its launches a step counted from profiled steps of
# TRAIN_XLSTM_COUNT_S tokens), then one chunkwise; its first
# TRAIN_XLSTM_CPU_LAYERS layers in f32 against the CPU on
# TRAIN_XLSTM_CPU_B x TRAIN_XLSTM_CPU_S tokens (the CPU steps a 4 x 1024 x
# 1024 f32 state a head and token). The CPU checks hold the TRAIN_CPU_*
# bounds.
TRAIN_RG_ARCH, TRAIN_RG_LAYERS, TRAIN_RG_STEPS = "recurrentgemma-9b", 8, 4
TRAIN_RG_B, TRAIN_RG_S, TRAIN_RG_CPU_LAYERS = 1, 4096, 3
TRAIN_XLSTM_ARCH, TRAIN_XLSTM_LAYERS, TRAIN_XLSTM_STEPS = "xlstm-1.3b", 8, 3
TRAIN_XLSTM_B, TRAIN_XLSTM_S, TRAIN_XLSTM_COUNT_S = 2, 256, (16, 32)
TRAIN_XLSTM_CPU_LAYERS, TRAIN_XLSTM_CPU_B, TRAIN_XLSTM_CPU_S = 2, 1, 64
# phase 8j: training the cross-attention families, each batch with its
# memory (seeded on the card, normal x 0.1 in bf16, as phase 8e's).
# Whisper-tiny whole (4 + 4 layers), bf16, remat (its decoder blocks),
# TRAIN_WHISPER_STEPS steps of TRAIN_WHISPER_B x TRAIN_WHISPER_S tokens
# (448: its decoder's published context) over as many x 1500 frames, then
# whole in f32 against the CPU on TRAIN_WHISPER_CPU_B x TRAIN_WHISPER_S.
# Llama-3.2-Vision-90B at full width cut by depth to one self and one
# cross layer (num_layers 2, cross_attn_every 2: under the published
# every-5th pattern the fewest layers that hold a cross layer are 5, whose
# params, AdamW moments and gradients alone pass the card's 80 GB),
# TRAIN_VLM_STEPS steps of TRAIN_VLM_B x TRAIN_VLM_S tokens over as many x
# 1600 image tokens, gates drawn by set_cross_gates; then both layers in
# f32 against the CPU on TRAIN_VLM_CPU_B x TRAIN_VLM_CPU_S tokens. The CPU
# checks hold the TRAIN_CPU_* bounds.
TRAIN_WHISPER_ARCH, TRAIN_WHISPER_STEPS = "whisper-tiny", 4
TRAIN_WHISPER_B, TRAIN_WHISPER_S, TRAIN_WHISPER_CPU_B = 8, 448, 2
TRAIN_VLM_ARCH, TRAIN_VLM_LAYERS, TRAIN_VLM_EVERY = "llama-3.2-vision-90b", 2, 2
TRAIN_VLM_STEPS, TRAIN_VLM_B, TRAIN_VLM_S = 4, 2, 1024
TRAIN_VLM_CPU_B, TRAIN_VLM_CPU_S = 1, 64
TRAIN_MEMORY_SEED, TRAIN_MEMORY_SCALE = 29, 0.1


def log(*a):
    print(*a, flush=True)


def time_ms(fn, args_list, iters=30, reps=5):
    """Mean device ms per call, cycling over ``args_list``: ``iters`` calls
    are captured into one CUDA graph, which is replayed ``reps`` times
    between CUDA events, so host launch cost does not pace the calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        for a in args_list[:2]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def bound(bytes_moved: float, *ops: tuple[float, float]):
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and each (operations, peak rate of their type) pair."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(n / rate * 1e3 for n, rate in ops)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report(text: str) -> dict[str, str]:
    """Registers, static shared memory and spills of each kernel entry in
    nvcc's ``-Xptxas -v`` output, keyed by the mangled entry name."""
    out: dict[str, str] = {}
    fn = None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            out[fn] = ""
        elif fn and ("spill" in line or "registers" in line):
            info = line.split(":", 1)[-1].strip()
            out[fn] += ("; " if out[fn] else "") + info
    return out


def check_act_quant(gen, rows):
    import torch
    from repro_torch.kernels.act_quant import act_quant, act_quant_plain

    err = 0.0
    for M in (*DECODE_M, PREFILL_M):
        for K in ACT_QUANT_K:
            x = (torch.randn((M, K), generator=gen, device="cuda") * 3
                 ).to(torch.bfloat16)
            qk, sk = act_quant(x)
            qp, sp = act_quant_plain(x)
            torch.cuda.synchronize()
            e = max((qk.int() - qp.int()).abs().max().item(),
                    (sk - sp).abs().max().item())
            err = max(err, e)
            if not (torch.equal(qk, qp) and torch.equal(sk, sp)):
                raise AssertionError(f"act_quant ({M},{K}) not bit-exact: {e}")
            if M in TIMED_M:
                ms = time_ms(lambda a: act_quant(a), [(x,)])
                plain = time_ms(lambda a: act_quant_plain(a), [(x,)])
                b, by = bound(M * K * 2 + M * K + M * 4,
                              (2 * M * K, F32_FLOPS_PER_S))
                rows.append(dict(kernel="act_quant", variant="", shape=[M, K],
                                 ms=ms, plain_ms=plain, bound_ms=b,
                                 bound_by=by, library_ms=None,
                                 bf16_matmul_ms=None))
    return err


def weight_sets(gen, K, N, copies, w_bits=4):
    """``copies`` random (K, N) layers, each RTN-quantized four ways: g128
    packed codes with f32 scales (FS, W4A16) and with integer scales (IS),
    per-channel (coarse FS), and the W4A16-dequantized bf16 weight (the
    bf16 matmul's operand)."""
    import torch
    from repro_torch.core import integer_scale as isc
    from repro_torch.core import packing, quant

    def pack(q):
        return packing.pack_int4(q) if w_bits == 4 else q

    out = []
    for _ in range(copies):
        w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
        qw = quant.quantize_weight(w, w_bits, GROUP)
        isw = isc.integerize(qw, 1024 if w_bits == 4 else "heuristic+6")
        qc = quant.quantize_weight(w, w_bits, -1)
        wd = (qw.qvalue.reshape(K // GROUP, GROUP, N).float()
              * qw.scale[:, None, :]).reshape(K, N).to(torch.bfloat16)
        out.append(dict(packed=pack(qw.qvalue), scale=qw.scale,
                        int_scale=isw.int_scale, alpha=float(isw.alpha),
                        packed_c=pack(qc.qvalue), scale_c=qc.scale[None, :],
                        wd=wd))
        del w, qw, qc
    return out


def _check(name, shape, y, y_plain, how):
    """Max abs diff of a kernel's output against its plain version on the
    same inputs; raises unless it meets ``how`` ("exact", "fs" or a
    relative bound)."""
    import torch

    torch.cuda.synchronize()
    e = (y - y_plain).abs().max().item()
    if how == "exact":
        ok = torch.equal(y, y_plain)
    elif how == "fs":
        ok = bool(((y - y_plain).abs()
                   <= FS_ATOL + FS_RTOL * y_plain.abs()).all())
    else:
        ok = e <= how * y_plain.abs().max().item()
    if not ok:
        raise AssertionError(f"{name} {shape}: kernel vs plain max abs "
                             f"{e} outside its tolerance ({how})")
    return e


def launch_plan(M, N, K, experts=1):
    """The K split the port's GEMM kernels take at this shape on this
    card (None for a tree whose kernels have no launch plan)."""
    import torch
    from repro_torch.kernels import w4a8_gemm

    plan_on = getattr(w4a8_gemm, "launch_plan_on", None)
    if plan_on is None:
        return None
    return plan_on(torch.device("cuda"), M, N, K, experts=experts)


def log_is_vs_fs(rows, shape):
    """The paper's comparisons at one dense shape, from the rows just
    timed: IS / FS time, IS against the W4A16 kernel and the bf16 matmul,
    and each W4A8 kernel's share of its bound."""
    got = {(r["kernel"], r["variant"]): r for r in rows
           if r["shape"] == shape}
    is_, fs = got[("w4a8_gemm_is", "fine")], got[("w4a8_gemm_fs", "fine")]
    wo = got[("w4a16_gemm", "fine")]
    log(f"[kernel] {shape}: IS / FS {is_['ms'] / fs['ms']:.3f}; IS / W4A16 "
        f"{is_['ms'] / wo['ms']:.3f}; IS / bf16 matmul "
        f"{is_['ms'] / is_['bf16_matmul_ms']:.3f}; FS / bf16 matmul "
        f"{fs['ms'] / fs['bf16_matmul_ms']:.3f}; share of bound IS "
        f"{is_['bound_ms'] / is_['ms']:.3f}, FS "
        f"{fs['bound_ms'] / fs['ms']:.3f}; plan {is_['plan']}")


def log_grouped_is_vs_fs(rows, shape):
    """The paper's §5.5 comparisons at one grouped (Mixtral) shape, from the
    ragged rows just timed: IS / FS (fine and coarse), IS / W4A16, each /
    the bf16 bmm over the same buffer, and each W4A8 kernel's share of its
    bound."""
    got = {(r["kernel"], r["variant"]): r for r in rows
           if r["shape"] == shape and "counts" in r}
    is_, fs = got[("moe_w4a8_is", "fine")], got[("moe_w4a8_fs", "fine")]
    co, wo = got[("moe_w4a8_fs", "coarse")], got[("moe_w4a16", "fine")]
    bmm = is_["bf16_matmul_ms"]
    log(f"[kernel] grouped {shape}: IS / FS {is_['ms'] / fs['ms']:.3f}; IS / "
        f"coarse {is_['ms'] / co['ms']:.3f}; IS / W4A16 "
        f"{is_['ms'] / wo['ms']:.3f}; / bf16 bmm IS {is_['ms'] / bmm:.3f}, "
        f"FS {fs['ms'] / bmm:.3f}, coarse {co['ms'] / bmm:.3f}; dense "
        f"grouped IS / FS {is_['dense_ms'] / fs['dense_ms']:.3f}; share of "
        f"bound IS {is_['bound_ms'] / is_['ms']:.3f}, FS "
        f"{fs['bound_ms'] / fs['ms']:.3f}")


def check_gemms(gen, rows):
    """IS, FS (fine and coarse) and W4A16 GEMMs against their plain
    versions at every main-path shape; timed at M = 4 and 128."""
    import torch
    from repro_torch.kernels.act_quant import act_quant_plain
    from repro_torch.kernels.w4a16_gemm import (REL_TOLERANCE, w4a16_gemm,
                                                w4a16_gemm_plain)
    from repro_torch.kernels.w4a8_gemm import (fg_gemm_integer_scale,
                                               fg_gemm_integer_scale_plain)
    from repro_torch.kernels.w4a8_gemm_fscale import (
        fg_gemm_float_scale, fg_gemm_float_scale_plain)

    gemms = {  # (name, variant) -> (kernel, plain, operands of a set, how)
        ("w4a8_gemm_is", "fine"): (
            lambda xq, sa, xb, q, s, a, **kw: fg_gemm_integer_scale(
                xq, sa, q, s, group_size=GROUP, alpha=a, **kw),
            lambda xq, sa, xb, q, s, a, **kw: fg_gemm_integer_scale_plain(
                xq, sa, q, s, group_size=GROUP, alpha=a, **kw),
            lambda d: (d["packed"], d["int_scale"], d["alpha"]), "exact"),
        ("w4a8_gemm_fs", "fine"): (
            lambda xq, sa, xb, q, s, **kw: fg_gemm_float_scale(
                xq, sa, q, s, group_size=GROUP, **kw),
            lambda xq, sa, xb, q, s, **kw: fg_gemm_float_scale_plain(
                xq, sa, q, s, group_size=GROUP, **kw),
            lambda d: (d["packed"], d["scale"]), "fs"),
        ("w4a8_gemm_fs", "coarse"): (
            lambda xq, sa, xb, q, s: fg_gemm_float_scale(
                xq, sa, q, s, group_size=-1),
            lambda xq, sa, xb, q, s: fg_gemm_float_scale_plain(
                xq, sa, q, s, group_size=-1),
            lambda d: (d["packed_c"], d["scale_c"]), "exact"),
        ("w4a16_gemm", "fine"): (
            lambda xq, sa, xb, q, s: w4a16_gemm(xb, q, s, group_size=GROUP),
            lambda xq, sa, xb, q, s: w4a16_gemm_plain(xb, q, s,
                                                      group_size=GROUP),
            lambda d: (d["packed"], d["scale"]), REL_TOLERANCE),
    }
    errs: dict[str, float] = {}

    def matmul(xb, wd):
        return xb @ wd

    for K, N in GEMM_KN:
        wbytes = K * N // 2 + (K // GROUP) * N * 4
        copies = max(1, math.ceil(ROTATE_BYTES / wbytes))
        sets = weight_sets(gen, K, N, copies)
        x = torch.randn((PREFILL_M, K), generator=gen, device="cuda")
        xq_all, sa_all = act_quant_plain(x)
        xb_all = x.to(torch.bfloat16)
        for M in (*DECODE_M, PREFILL_M):
            xs = (xq_all[:M].contiguous(), sa_all[:M].contiguous(),
                  xb_all[:M].contiguous())
            mm = None
            if M in TIMED_M:
                mm = time_ms(matmul, [(xs[2], d["wd"]) for d in sets])
            for (name, variant), (kern, plain, opnds, how) in gemms.items():
                args = [(*xs, *opnds(d)) for d in sets]
                y = kern(*args[0])
                e = _check(f"{name} {variant}", [M, K, N], y,
                           plain(*args[0]), how)
                errs[name] = max(errs.get(name, 0.0), e)
                if not torch.equal(y, kern(*args[0])):
                    raise AssertionError(f"{name} {variant} {[M, K, N]}: "
                                         "two launches gave different bits")
                if M not in TIMED_M:
                    continue
                scale_bytes = (K // GROUP if variant == "fine" else 1) * N * 4
                w4 = K * N // 2 + scale_bytes + M * N * 4
                if name == "w4a16_gemm":
                    b, by = bound(M * K * 2 + w4,
                                  (2 * M * K * N, BF16_FLOPS_PER_S))
                else:
                    b, by = bound(M * K + M * 4 + w4,
                                  (2 * M * K * N, INT8_OPS_PER_S))
                rows.append(dict(
                    kernel=name, variant=variant, shape=[M, K, N],
                    ms=time_ms(kern, args),
                    plain_ms=time_ms(plain, args[:2], iters=3, reps=3),
                    bound_ms=b, bound_by=by,
                    library_ms=mm if name == "w4a16_gemm" else None,
                    bf16_matmul_ms=mm, copies=copies,
                    plan=launch_plan(M, N, K)))
            if M in TIMED_M:
                log_is_vs_fs(rows, [M, K, N])
        del sets, x, xq_all, sa_all, xb_all
        torch.cuda.empty_cache()

    # W8A8 (unpacked int8 weights) through the IS and FS kernels, at one
    # decode shape
    M, K, N = 4, 4096, 4096
    copies = max(1, math.ceil(ROTATE_BYTES / (K * N + (K // GROUP) * N * 4)))
    sets = weight_sets(gen, K, N, copies, w_bits=8)
    x = torch.randn((M, K), generator=gen, device="cuda")
    xs = (*act_quant_plain(x), x.to(torch.bfloat16))
    mm = time_ms(matmul, [(xs[2], d["wd"]) for d in sets])
    for name in ("w4a8_gemm_is", "w4a8_gemm_fs"):
        kern, plain, opnds, how = gemms[(name, "fine")]
        args = [(*xs, *opnds(d)) for d in sets]
        e = _check(f"{name} w8", [M, K, N], kern(*args[0], w_bits=8),
                   plain(*args[0], w_bits=8), how)
        errs[name] = max(errs[name], e)
        b, by = bound(M * K + M * 4 + K * N + (K // GROUP) * N * 4 + M * N * 4,
                      (2 * M * K * N, INT8_OPS_PER_S))
        if not torch.equal(kern(*args[0], w_bits=8),
                           kern(*args[0], w_bits=8)):
            raise AssertionError(f"{name} w8: two launches gave different "
                                 "bits")
        rows.append(dict(
            kernel=name, variant="w8", shape=[M, K, N], plan=launch_plan(
                M, N, K),
            ms=time_ms(lambda *a: kern(*a, w_bits=8), args),
            plain_ms=time_ms(lambda *a: plain(*a, w_bits=8), args[:2],
                             iters=3, reps=3),
            bound_ms=b, bound_by=by, library_ms=None, bf16_matmul_ms=mm,
            copies=copies))
    return errs


def check_config_gemms(gen, rows, widths=CONFIG_GEMM_KN):
    """The IS GEMM at the (K, N) of ``widths`` (Qwen2-72B's and
    Granite-34B's, ``CONFIG_GEMM_KN``; MiniCPM3's and DeepSeek-V2's,
    ``MLA_GEMM_KN``) against its plain version, bit for bit, at decode
    M 1..4 and prefill M 128; timed at M = 4 and 128 beside its plain
    version, one bf16 ``torch.matmul`` and its bound, with its launch plan.
    Each timed graph reads at least ``ROTATE_BYTES`` of weights (more calls
    a graph where one layer is small), so every launch reads them from
    device memory."""
    import torch
    from repro_torch.kernels.act_quant import act_quant_plain
    from repro_torch.kernels.w4a8_gemm import (fg_gemm_integer_scale,
                                               fg_gemm_integer_scale_plain)

    def kern(xq, sa, q, s, a):
        return fg_gemm_integer_scale(xq, sa, q, s, group_size=GROUP, alpha=a)

    def plain(xq, sa, q, s, a):
        return fg_gemm_integer_scale_plain(xq, sa, q, s, group_size=GROUP,
                                           alpha=a)

    err = 0.0
    for K, N in widths:
        wbytes = K * N // 2 + (K // GROUP) * N * 4
        copies = max(1, math.ceil(ROTATE_BYTES / wbytes))
        sets = weight_sets(gen, K, N, copies)
        x = torch.randn((PREFILL_M, K), generator=gen, device="cuda")
        xq_all, sa_all = act_quant_plain(x)
        xb_all = x.to(torch.bfloat16)
        for M in (*DECODE_M, PREFILL_M):
            xq, sa, xb = (t[:M].contiguous()
                          for t in (xq_all, sa_all, xb_all))
            args = [(xq, sa, d["packed"], d["int_scale"], d["alpha"])
                    for d in sets]
            y = kern(*args[0])
            err = max(err, _check("w4a8_gemm_is", [M, K, N], y,
                                  plain(*args[0]), "exact"))
            if not torch.equal(y, kern(*args[0])):
                raise AssertionError(f"w4a8_gemm_is {[M, K, N]}: two "
                                     "launches gave different bits")
            if M not in TIMED_M:
                continue
            iters = max(30, copies)
            b, by = bound(M * K + M * 4 + wbytes + M * N * 4,
                          (2 * M * K * N, INT8_OPS_PER_S))
            rows.append(dict(
                kernel="w4a8_gemm_is", variant="fine", shape=[M, K, N],
                ms=time_ms(kern, args, iters=iters),
                plain_ms=time_ms(plain, args[:2], iters=3, reps=3),
                bound_ms=b, bound_by=by, library_ms=None,
                bf16_matmul_ms=time_ms(lambda a, w: a @ w,
                                       [(xb, d["wd"]) for d in sets],
                                       iters=iters),
                copies=copies, plan=launch_plan(M, N, K)))
            r = rows[-1]
            log(f"[kernel] w4a8_gemm_is at a new width {[M, K, N]}: "
                f"{r['ms']:.4f} ms, bf16 matmul {r['bf16_matmul_ms']:.4f} "
                f"ms (IS / bf16 {r['ms'] / r['bf16_matmul_ms']:.3f}), share "
                f"of bound {b / r['ms']:.3f}; plan {r['plan']}")
        del sets, x, xq_all, sa_all, xb_all
        torch.cuda.empty_cache()
    return err


def check_flash(gen, rows):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        TOLERANCE, flash_attention, flash_attention_plain)

    err = 0.0
    # (B, Sq, Hq, Hkv, D, window): the prefill shape, then GQA + window +
    # a ragged length; RecurrentGemma's heads of 256 at its prefill and at
    # 4096 tokens with its window of 2048 (there the bf16 kernel reloads
    # Q's fragments per key tile)
    for B, S, Hq, Hkv, D, win in ((1, 128, 32, 32, 128, None),
                                  (1, 128, 32, 8, 128, None),  # Mixtral GQA
                                  (2, 200, 8, 2, 128, 64),
                                  (1, 77, 4, 1, 64, None),
                                  (1, 128, 64, 8, 128, None),  # Qwen2-72B
                                  (1, 128, 48, 1, 128, None),  # Granite
                                  (1, 128, 8, 2, 32, None),  # heads of 32
                                  (1, 128, 16, 1, 256, None),
                                  (1, 4096, 16, 1, 256, 2048)):
        shape = (B, S, Hq, Hkv, D, win)
        q, k, v = (torch.randn((B, S, h, D), generator=gen, device="cuda"
                               ).to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
        ok_ = flash_attention(q, k, v, window=win)
        op = flash_attention_plain(q, k, v, window=win)
        torch.cuda.synchronize()
        e = (ok_.float() - op.float()).abs().max().item()
        err = max(err, e)
        if not e <= TOLERANCE:
            raise AssertionError(f"flash {shape}: max abs {e} > {TOLERANCE}")
        if not torch.equal(ok_, flash_attention(q, k, v, window=win)):
            raise AssertionError(f"flash {shape}: two launches gave "
                                 "different bits")
        if (S == 128 and (Hq == Hkv or D == 32)) or D == 256:  # f32 kernel
            qf, kf, vf = (t.float() for t in (q, k, v))
            ef = (flash_attention(qf, kf, vf, window=win)
                  - flash_attention_plain(qf, kf, vf, window=win)
                  ).abs().max().item()
            if not ef <= TOLERANCE:
                raise AssertionError(f"flash f32 {shape}: max abs {ef}")
            log(f"[kernel] flash_attention f32 {list(shape)}: max abs diff "
                f"vs plain {ef:.2e}")
        ms = time_ms(lambda *a: flash_attention(*a, window=win), [(q, k, v)])
        pms = time_ms(lambda *a: flash_attention_plain(*a, window=win),
                      [(q, k, v)], iters=30 if S <= 512 else 3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = torch.ones((S, S), dtype=torch.bool, device="cuda").tril()
        if win is not None:
            mask &= ~torch.ones_like(mask).tril(-win)
        masking = (dict(is_causal=True) if win is None
                   else dict(attn_mask=mask))
        lib = time_ms(lambda *a: F.scaled_dot_product_attention(
            *a, enable_gqa=Hq != Hkv, **masking), [(qt, kt, vt)])
        pairs = int(mask.sum())  # the (query, key) pairs the mask keeps
        b, by = bound(2 * B * S * (Hq + Hkv) * D * 2,
                      (4 * B * Hq * pairs * D, BF16_FLOPS_PER_S))
        rows.append(dict(kernel="flash_attention",
                         variant=("" if Hq == Hkv else f"gqa kv{Hkv}")
                         + ("" if win is None else f" window {win}"),
                         shape=[B, S, Hq, D], ms=ms, plain_ms=pms,
                         max_abs_diff=e,
                         bound_ms=b, bound_by=by, library_ms=lib,
                         bf16_matmul_ms=None))
    return err


def check_flash_cross(gen, rows):
    """Flash attention with ``causal=False`` and Sq != Sk at
    ``XATTN_FLASH`` (Sk = 1500 and 1600 are no multiple of the 64-key
    tile; Sq = 1 fills one row of a 32-row query tile): bf16 and f32
    within ``TOLERANCE`` of the plain version, bf16 repeated bit for bit,
    timed beside the plain version and SDPA with ``is_causal=False``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        TOLERANCE, flash_attention, flash_attention_plain)

    err = 0.0
    for B, Sq, Sk, Hq, Hkv, D in XATTN_FLASH:
        shape = [B, Sq, Sk, Hq, Hkv, D]
        q = torch.randn((B, Sq, Hq, D), generator=gen, device="cuda")
        k, v = (torch.randn((B, Sk, Hkv, D), generator=gen, device="cuda")
                for _ in range(2))
        for dt in (torch.float32, torch.bfloat16):
            qd, kd, vd = (t.to(dt) for t in (q, k, v))
            out = flash_attention(qd, kd, vd, causal=False)
            e = (out.float() - flash_attention_plain(
                qd, kd, vd, causal=False).float()).abs().max().item()
            if not e <= TOLERANCE:
                raise AssertionError(f"flash non-causal {shape} {dt}: max "
                                     f"abs {e} > {TOLERANCE}")
            err = max(err, e)
        if not torch.equal(out, flash_attention(qd, kd, vd, causal=False)):
            raise AssertionError(f"flash non-causal {shape}: two launches "
                                 "gave different bits")
        ms = time_ms(lambda *a: flash_attention(*a, causal=False),
                     [(qd, kd, vd)])
        pms = time_ms(lambda *a: flash_attention_plain(*a, causal=False),
                      [(qd, kd, vd)], iters=3, reps=3)
        qt, kt, vt = (t.transpose(1, 2) for t in (qd, kd, vd))
        lib = time_ms(lambda *a: F.scaled_dot_product_attention(
            *a, is_causal=False, enable_gqa=Hq != Hkv), [(qt, kt, vt)])
        b, by = bound(2 * B * D * 2 * (Sq * Hq + Sk * Hkv),
                      (4 * B * Hq * Sq * Sk * D, BF16_FLOPS_PER_S))
        rows.append(dict(kernel="flash_attention", variant="non-causal",
                         shape=shape, ms=ms, plain_ms=pms, max_abs_diff=e,
                         bound_ms=b, bound_by=by, library_ms=lib,
                         bf16_matmul_ms=None))
    return err


def check_bwd_build():
    """The backward's kernel entries as ptxas built them (registers, spills,
    static shared memory) beside the dynamic shared memory of the bf16
    blocks (``TcSmem`` of csrc/flash_attention_bwd.cu, from its tile
    constants: bf16 rows of D + 8, and the dK/dV block's f32 lse and delta
    buffers; at D = 256 the dK/dV block's ``TKV_256`` and ``TQS_256``);
    raises if a bf16 kernel at D = 128 spills."""
    import re

    from repro_torch.kernels import _build

    src = _build.source("flash_attention_bwd").read_text()
    t = {n: int(re.search(rf"\b{n} = (\d+)", src).group(1))
         for n in ("TKV", "TQS", "TQD", "TKS", "TKV_256", "TQS_256")}
    for fn, info in ptxas_report(
            _build.BUILD_LOG.get("flash_attention_bwd", "")).items():
        d = next((d for d in (32, 64, 128, 256) if f"_tcILi{d}E" in fn),
                 None)
        if d is not None:
            tkv, tqs = ((t["TKV_256"], t["TQS_256"]) if d == 256
                        else (t["TKV"], t["TQS"]))
            rows = (2 * tkv + 4 * tqs if "dkdv" in fn
                    else 2 * t["TQD"] + 4 * t["TKS"])
            dyn = rows * (d + 8) * 2 + (16 * tqs if "dkdv" in fn else 0)
            info += f"; dynamic shared {dyn} bytes"
        log(f"[bwd] ptxas {fn}: {info}")
        if d == 128 and not re.search(r"\b0 bytes spill stores", info):
            raise AssertionError(f"flash bwd {fn} spills at D = 128: {info}")


def kernel_ms(fn, reps=5) -> dict[str, float]:
    """{device kernel: ms a call of ``fn``} under ``torch.profiler``,
    after one call outside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / reps / 1e3
            for e in prof.key_averages() if e.self_device_time_total > 0}


def device_launches(fn):
    """(``fn()``, its device launches, their device ms) under
    ``torch.profiler`` with the CUDA activity alone (no op or shape
    records: a per-token scan's step makes a quarter of a million)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return (out, sum(e.count for e in ev),
            sum(e.self_device_time_total for e in ev) / 1e3)


def log_kernel_ms(tag: str, ms: dict[str, float]) -> None:
    def short(name: str) -> str:
        name = name.replace("(anonymous namespace)::", "")
        return name.removeprefix("void ").split("(")[0][:60]

    log(f"[bwd] {tag}: {sum(ms.values()):.4f} ms of device kernels a call: "
        + "; ".join(f"{short(k)} {v:.4f}" for k, v in
                    sorted(ms.items(), key=lambda kv: -kv[1])))


def check_flash_bwd(gen, rows):
    """The flash-attention backward kernel at ``FLASH_BWD``: dq, dk and dv
    within ``BWD_REL_TOLERANCE`` x max |plain| of its plain version on the
    same inputs and the forward kernel's lse, the same bits from a second
    call, timed as a replayed graph beside the plain version and beside
    SDPA's backward (eager, between CUDA events: autograd's backward of a
    forward made outside a capture cannot be captured) as the library
    call; at the first row (the train step's) each kernel's device ms of
    both under ``torch.profiler``. Bound: the five products of the
    backward (S, dP, dV, dK, dQ) over the unmasked pairs at the dense
    peak of the inputs' type, or the bytes (q, k, v, o, dO, lse read; dq,
    dk, dv written). Returns the max abs diff."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        BWD_REL_TOLERANCE, _mask, bwd_launch_plan, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_fwd)
    from repro_torch.kernels.w4a8_gemm import _sm_count

    check_bwd_build()
    err = 0.0
    for i, (B, Sq, Sk, Hq, Hkv, D, causal, win, dtype) in enumerate(
            FLASH_BWD):
        dt = getattr(torch, dtype)
        shape = [B, Sq, Hq, D]
        plan = bwd_launch_plan(B, Sq, Sk, Hq, Hkv, D, dt,
                               _sm_count(torch.cuda.current_device()))
        q = torch.randn((B, Sq, Hq, D), generator=gen, device="cuda").to(dt)
        k, v = (torch.randn((B, Sk, Hkv, D), generator=gen, device="cuda"
                            ).to(dt) for _ in range(2))
        do = torch.randn((B, Sq, Hq, D), generator=gen, device="cuda").to(dt)
        kw = dict(causal=causal, window=win)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        e = 0.0
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            ge = (g.float() - w.float()).abs().max().item()
            limit = BWD_REL_TOLERANCE[dt] * w.float().abs().max().item()
            if not ge <= limit:
                raise AssertionError(f"flash bwd {shape} {dt} {name}: max "
                                     f"abs {ge} > {limit}")
            e = max(e, ge)
        again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash bwd {shape}: two launches gave "
                                 "different bits")
        err = max(err, e)
        args = [(q, k, v, o, lse, do)]
        ms = time_ms(lambda *a: flash_attention_bwd(*a, **kw), args, iters=10)
        pms = time_ms(lambda *a: flash_attention_bwd_plain(*a, **kw), args,
                      iters=3, reps=3)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        mask = _mask(Sq, Sk, causal, win, "cuda")
        masking = (dict(is_causal=causal) if win is None
                   else dict(attn_mask=mask))
        out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=Hq != Hkv,
                                             **masking)
        dot = do.transpose(1, 2)
        lib = time_eager_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), (), iters=10)
        if i == 0 or (D == 256 and win is not None
                      and dt == torch.bfloat16):  # the two train shapes
            log_kernel_ms(f"profile {shape} {dtype}, ours", kernel_ms(
                lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw)))
            log_kernel_ms(f"profile {shape} {dtype}, SDPA's backward",
                          kernel_ms(lambda: torch.autograd.grad(
                              out, (qt, kt, vt), dot, retain_graph=True)))
        del out
        pairs = int(mask.sum())
        el = q.element_size()
        # q, o and dO read and dq written; k and v read and dk and dv
        # written; the f32 lse read
        b, by = bound(el * 4 * B * (Sq * Hq + Sk * Hkv) * D
                      + 4 * B * Hq * Sq,
                      (10 * B * Hq * pairs * D,
                       BF16_FLOPS_PER_S if dt == torch.bfloat16
                       else F32_FLOPS_PER_S))
        variant = ("" if causal else "non-causal ") + (
            "" if Hq == Hkv else f"gqa kv{Hkv} ") + (
            "" if win is None else f"window {win} ") + dtype
        rows.append(dict(kernel="flash_attention_bwd", variant=variant,
                         shape=shape, sk=Sk, ms=ms, plain_ms=pms,
                         max_abs_diff=e, bound_ms=b, bound_by=by,
                         library_ms=lib, bf16_matmul_ms=None,
                         plan=(f"heads split {plan['splits']}, "
                               f"{plan['kv_blocks']} dK/dV + "
                               f"{plan['q_blocks']} dQ blocks")))
    return err


def check_xattn_rows(gen, rows):
    """act_quant at the memory's rows (``XATTN_ACT_ROWS``) and the IS GEMM
    at M = 6400 / 6000 (``XATTN_BIG_M``: 100 and 94 row tiles of 64), both
    bit-exact to their plain versions (the GEMM twice, and once more at
    each K split its launch plan takes), timed beside the plain version,
    the bound and, for the GEMM, one bf16 ``torch.matmul``, with the
    launch plan."""
    import torch
    from repro_torch.kernels import w4a8_gemm
    from repro_torch.kernels.act_quant import act_quant, act_quant_plain
    from repro_torch.kernels.w4a8_gemm import (fg_gemm_integer_scale,
                                               fg_gemm_integer_scale_plain)

    err = {"act_quant": 0.0, "w4a8_gemm_is": 0.0}
    for M, K in XATTN_ACT_ROWS:
        x = (torch.randn((M, K), generator=gen, device="cuda") * 3
             ).to(torch.bfloat16)
        (qk, sk), (qp, sp) = act_quant(x), act_quant_plain(x)
        if not (torch.equal(qk, qp) and torch.equal(sk, sp)):
            raise AssertionError(f"act_quant ({M},{K}) not bit-exact")
        b, by = bound(M * K * 2 + M * K + M * 4, (2 * M * K, F32_FLOPS_PER_S))
        rows.append(dict(kernel="act_quant", variant="memory rows",
                         shape=[M, K], ms=time_ms(act_quant, [(x,)]),
                         plain_ms=time_ms(act_quant_plain, [(x,)]),
                         bound_ms=b, bound_by=by, library_ms=None,
                         bf16_matmul_ms=None))

    def kern(xq, sa, q, s, a):
        return fg_gemm_integer_scale(xq, sa, q, s, group_size=GROUP, alpha=a)

    def plain(xq, sa, q, s, a):
        return fg_gemm_integer_scale_plain(xq, sa, q, s, group_size=GROUP,
                                           alpha=a)

    for M, K, N in XATTN_BIG_M:
        wbytes = K * N // 2 + (K // GROUP) * N * 4
        copies = min(8, max(1, math.ceil(ROTATE_BYTES / wbytes)))
        sets = weight_sets(gen, K, N, copies)
        x = torch.randn((M, K), generator=gen, device="cuda")
        xq, sa = act_quant_plain(x)
        args = [(xq, sa, d["packed"], d["int_scale"], d["alpha"])
                for d in sets]
        y = kern(*args[0])
        err["w4a8_gemm_is"] = max(err["w4a8_gemm_is"], _check(
            "w4a8_gemm_is", [M, K, N], y, plain(*args[0]), "exact"))
        plan = launch_plan(M, N, K)
        if not torch.equal(y, kern(*args[0])):
            raise AssertionError(f"w4a8_gemm_is {[M, K, N]}: two launches "
                                 "gave different bits")
        d = sets[0]
        for splits in (1, 2):  # each split path gives the same bits
            ys = w4a8_gemm.launch_ring(
                "w4a8_gemm_is", xq, sa.reshape(M).contiguous(), torch.full(
                    (1,), d["alpha"], device="cuda"), d["packed"],
                d["int_scale"], GROUP, 4, w4a8_gemm.launch_plan_on(
                    xq.device, M, N, K, splits=splits))
            if not torch.equal(ys, y):
                raise AssertionError(f"w4a8_gemm_is {[M, K, N]}: {splits} "
                                     "K splits changed the bits")
        b, by = bound(M * K + M * 4 + wbytes + M * N * 4,
                      (2 * M * K * N, INT8_OPS_PER_S))
        xb = x.to(torch.bfloat16)
        rows.append(dict(
            kernel="w4a8_gemm_is", variant="memory rows", shape=[M, K, N],
            ms=time_ms(kern, args), plain_ms=time_ms(plain, args[:1],
                                                     iters=3, reps=3),
            bound_ms=b, bound_by=by, library_ms=None,
            bf16_matmul_ms=time_ms(lambda a, w: a @ w,
                                   [(xb, d["wd"]) for d in sets]),
            copies=copies, plan=plan))
        r = rows[-1]
        log(f"[kernel] w4a8_gemm_is at the memory's rows {[M, K, N]}: "
            f"{r['ms']:.4f} ms, bf16 matmul {r['bf16_matmul_ms']:.4f} ms "
            f"(IS / bf16 {r['ms'] / r['bf16_matmul_ms']:.3f}), share of "
            f"bound {b / r['ms']:.3f} ({by}); plan {plan}")
        del sets, x, xq, sa, xb
        torch.cuda.empty_cache()
    return err


def top_k_counts(tokens, seed, E=DS_E, k=DS_TOP_K, C=DS_C):
    """Routed rows per expert from a seeded top-k routing of ``tokens``
    tokens over E experts (Gaussian router logits), clipped at capacity
    C, as the MoE dispatch clips them."""
    import numpy as np

    logits = np.random.default_rng(seed).normal(size=(tokens, E))
    top = np.argsort(-logits, axis=1)[:, :k]
    return np.minimum(np.bincount(top.ravel(), minlength=E), C).tolist()


def moe_counts(C, seed, E=MOE_E):
    """Seeded routed counts of E experts at capacity C: expert 0 empty,
    expert 1 full, the rest in [1, C) (none a multiple of the row tile)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [0, C] + rng.integers(1, C, size=E - 2).tolist()


def moe_weights(gen, K, N, w_bits=4, E=MOE_E):
    """Stacked RTN weights of E experts, as ``weight_sets`` makes one
    layer's: packed codes with f32 and integer scales (per-expert alpha),
    per-channel codes and scales, and the bf16 dequantized weight."""
    import torch

    sets = weight_sets(gen, K, N, E, w_bits=w_bits)
    out = {k: torch.stack([d[k] for d in sets])
           for k in ("packed", "scale", "int_scale", "packed_c", "scale_c",
                     "wd")}
    out["alpha"] = torch.tensor([d["alpha"] for d in sets], device="cuda")
    return out


def check_grouped(gen, rows):
    """The grouped (MoE) kernels at Mixtral's expert shapes: each ragged
    entry point (the serving path) and each dense-grouped one (codes
    quantized before the call, every row computed) against its plain
    version, ragged == dense grouped on the same zero-padded buffer; each
    timed with its plain version, a bf16 ``torch.bmm`` over the same
    buffer, and its bound."""
    import inspect

    import torch
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels.act_quant import act_quant_plain
    from repro_torch.kernels.w4a16_gemm import REL_TOLERANCE

    # this tree's grouped W4A8 kernels run the launch plan, quantize the
    # routed rows in act_quant's routed entry and take a forced split
    ring = "splits" in inspect.signature(
        mg.fg_grouped_gemm_integer_scale_ragged).parameters
    if not ring:
        log("[kernel] grouped W4A8: this tree has no routed act_quant "
            "entry and no splits=; its forced-split case is skipped")

    def on_weights(fn, q, sc, **fixed):
        """(a, b, w) -> fn(a, b, w[q], w[sc]): a grouped entry point over
        the codes ``q`` and scales ``sc`` of a weight set"""
        return lambda a, b, w, **kw: fn(a, b, w[q], w[sc], **fixed, **kw)

    # (kernel, variant) -> (ragged, its plain, dense grouped, its plain,
    # tolerance); ragged ones take (x, counts, w), dense W4A8 ones
    # (xq, sa, w), dense W4A16 (x, None, w)
    groups = {
        ("moe_w4a8_is", "fine"): (
            lambda x, rc, w, **kw: mg.fg_grouped_gemm_integer_scale_ragged(
                x, rc, w["packed"], w["int_scale"], alpha=w["alpha"], **kw),
            lambda x, rc, w, **kw:
                mg.fg_grouped_gemm_integer_scale_ragged_plain(
                    x, rc, w["packed"], w["int_scale"], group_size=GROUP,
                    alpha=w["alpha"], **kw),
            lambda xq, sa, w, **kw: mg.fg_grouped_gemm_integer_scale(
                xq, sa, w["packed"], w["int_scale"], alpha=w["alpha"], **kw),
            lambda xq, sa, w, **kw: mg.fg_grouped_gemm_integer_scale_plain(
                xq, sa, w["packed"], w["int_scale"], group_size=GROUP,
                alpha=w["alpha"], **kw),
            "exact"),
        ("moe_w4a8_fs", "fine"): (
            on_weights(mg.fg_grouped_gemm_float_scale_ragged, "packed", "scale"),
            on_weights(mg.fg_grouped_gemm_float_scale_ragged_plain, "packed",
               "scale", group_size=GROUP),
            on_weights(mg.fg_grouped_gemm_float_scale, "packed", "scale"),
            on_weights(mg.fg_grouped_gemm_float_scale_plain, "packed", "scale",
               group_size=GROUP),
            "fs"),
        ("moe_w4a8_fs", "coarse"): (
            on_weights(mg.fg_grouped_gemm_float_scale_ragged, "packed_c", "scale_c",
               group_size=-1),
            on_weights(mg.fg_grouped_gemm_float_scale_ragged_plain, "packed_c",
               "scale_c", group_size=-1),
            on_weights(mg.fg_grouped_gemm_float_scale, "packed_c", "scale_c",
               group_size=-1),
            on_weights(mg.fg_grouped_gemm_float_scale_plain, "packed_c", "scale_c",
               group_size=-1),
            "exact"),
        ("moe_w4a16", "fine"): (
            on_weights(mg.grouped_w4a16_gemm_ragged, "packed", "scale"),
            on_weights(mg.grouped_w4a16_gemm_ragged_plain, "packed", "scale",
               group_size=GROUP),
            lambda x, _, w: mg.grouped_w4a16_gemm(x, w["packed"], w["scale"]),
            lambda x, _, w: mg.grouped_w4a16_gemm_plain(
                x, w["packed"], w["scale"], group_size=GROUP),
            REL_TOLERANCE),
    }
    errs: dict[str, float] = {}

    def bmm(x, wd):
        return torch.bmm(x, wd)

    def one(name, variant, C, K, N, x, rc, xq, sa, w, fns, w_bits=4,
            splits=0):
        ragged, ragged_plain, dense, dense_plain, how = fns
        kw = {} if w_bits == 4 else dict(w_bits=8)
        kk = dict(kw, splits=splits) if splits else kw  # the kernels' kwargs
        E = x.shape[0]
        shape = [E, C, K, N]
        dargs = (x, None, w) if name == "moe_w4a16" else (xq, sa, w)
        y = ragged(x, rc, w, **kk)
        y_d = dense(*dargs, **kk)
        for tag, got, want in (("ragged", y, ragged_plain(x, rc, w, **kw)),
                               ("dense", y_d, dense_plain(*dargs, **kw))):
            e = _check(f"{name} {variant} {tag}", shape, got, want, how)
            errs[name] = max(errs.get(name, 0.0), e)
        if not torch.equal(y, y_d):
            raise AssertionError(f"{name} {variant} {shape}: ragged != "
                                 "dense grouped")
        if not torch.equal(y, ragged(x, rc, w, **kk)):
            raise AssertionError(f"{name} {variant} {shape}: two launches "
                                 "gave different bits")
        counts = [min(int(c), C) for c in rc.tolist()]
        routed, active = sum(counts), sum(c > 0 for c in counts)
        wbytes = K * N // (2 if w_bits == 4 else 1)
        sbytes = (K // GROUP if variant == "fine" else 1) * N * 4
        out_bytes = E * C * N * 4
        wo = name == "moe_w4a16"
        rate = BF16_FLOPS_PER_S if wo else INT8_OPS_PER_S
        # ragged: the routed experts' weights, the routed bf16 rows; dense
        # grouped: every expert and every row (codes + scale, or bf16)
        b, by = bound(active * (wbytes + sbytes) + routed * K * 2
                      + out_bytes, (2 * routed * K * N, rate))
        db, dby = bound(E * (wbytes + sbytes) + out_bytes
                        + E * C * (K * 2 if wo else K + 4),
                        (2 * E * C * K * N, rate))
        plan = launch_plan(C, N, K, E) if wo or ring else None
        if splits:
            plan = dict(plan, splits=splits,
                        workspace=splits * E * C * N)
        return dict(
            kernel=name, variant=(variant if w_bits == 4 else "w8")
            + (f" split{splits}" if splits else ""),
            shape=shape, counts=counts, plan=plan,
            ms=time_ms(lambda *a: ragged(*a, **kk), [(x, rc, w)]),
            plain_ms=time_ms(lambda *a: ragged_plain(*a, **kw), [(x, rc, w)],
                             iters=2, reps=2),
            bound_ms=b, bound_by=by,
            dense_ms=time_ms(lambda *a: dense(*a, **kk), [dargs]),
            dense_plain_ms=time_ms(lambda *a: dense_plain(*a, **kw), [dargs],
                                   iters=2, reps=2),
            dense_bound_ms=db, dense_bound_by=dby)

    def routed_quant(C, K, x, rc):
        """act_quant's routed entry (the grouped W4A8 kernels' input)
        against its plain version, bit for bit, and timed."""
        E = x.shape[0]
        got = aq.act_quant_routed(x, rc)
        want = aq.act_quant_routed_plain(x, rc)
        for g_, w_ in zip(got, want):
            e = _check("act_quant routed", [E, C, K], g_.float(),
                       w_.float(), "exact")
            errs["act_quant"] = max(errs.get("act_quant", 0.0), e)
        routed = sum(min(max(int(c), 0), C) for c in rc.tolist())
        b, by = bound(routed * K * 2 + E * C * (K + 4),
                      (2 * routed * K, F32_FLOPS_PER_S))
        return dict(kernel="act_quant", variant="routed",
                    shape=[E, C, K], ms=time_ms(
                        aq.act_quant_routed, [(x, rc)]),
                    plain_ms=time_ms(aq.act_quant_routed_plain, [(x, rc)]),
                    bound_ms=b, bound_by=by, library_ms=None,
                    bf16_matmul_ms=None)

    def inputs(C, K, counts):
        """A bf16 (E, C, K) dispatch buffer zero past ``counts`` (E =
        len(counts)), its counts on the card, and its codes and scales."""
        E = len(counts)
        rc = torch.tensor(counts, dtype=torch.int32, device="cuda")
        live = torch.arange(C, device="cuda")[None, :] < rc[:, None]
        x = torch.where(live[..., None], torch.randn(
            (E, C, K), generator=gen, device="cuda"), 0.0
        ).to(torch.bfloat16)
        xq, sa = act_quant_plain(x.reshape(E * C, K))
        return x, rc, xq.reshape(E, C, K), sa.reshape(E, C, 1)

    for K, N in MOE_KN:
        w = moe_weights(gen, K, N)
        for C in MOE_C:
            x, rc, xq, sa = inputs(C, K, moe_counts(C, seed=C * K))
            if ring:
                rows.append(routed_quant(C, K, x, rc))
            mm = time_ms(bmm, [(x, w["wd"])])
            for (name, variant), fns in groups.items():
                r = one(name, variant, C, K, N, x, rc, xq, sa, w, fns)
                rows.append(dict(r, library_ms=mm if name == "moe_w4a16"
                                 else None, bf16_matmul_ms=mm, copies=1))
            log_grouped_is_vs_fs(rows, [MOE_E, C, K, N])
            if ring and (K, N, C) == MOE_SPLIT[:3]:
                for key in (("moe_w4a8_is", "fine"), ("moe_w4a8_fs", "fine"),
                            ("moe_w4a8_fs", "coarse")):
                    r = one(*key, C, K, N, x, rc, xq, sa, w, groups[key],
                            splits=MOE_SPLIT[3])
                    rows.append(dict(r, library_ms=None, bf16_matmul_ms=mm,
                                     copies=1))
            del x, xq, sa
        del w
        torch.cuda.empty_cache()

    # Phi-3.5-MoE's experts (16) through the ragged IS kernel, the one its
    # served path runs, with act_quant's routed entry before it
    if ring:
        key = ("moe_w4a8_is", "fine")
        for K, N in PHI_KN:
            w = moe_weights(gen, K, N, E=PHI_E)
            for C in PHI_C:
                x, rc, xq, sa = inputs(C, K, moe_counts(C, C * K, E=PHI_E))
                rows.append(routed_quant(C, K, x, rc))
                r = one(*key, C, K, N, x, rc, xq, sa, w, groups[key])
                rows.append(dict(r, library_ms=None, bf16_matmul_ms=time_ms(
                    bmm, [(x, w["wd"])]), copies=1))
                log(f"[kernel] grouped IS {r['shape']} (Phi-3.5-MoE): "
                    f"{r['ms']:.4f} ms, bf16 bmm "
                    f"{rows[-1]['bf16_matmul_ms']:.4f} ms, share of bound "
                    f"{r['bound_ms'] / r['ms']:.3f}; plan {r['plan']}")
                del x, xq, sa
            del w
            torch.cuda.empty_cache()

    # DeepSeek-V2's 160 experts through the ragged IS kernel, with
    # act_quant's routed entry before it, at the counts of a seeded top-6
    # routing of a 4-slot decode and of a 128-token prefill
    if ring:
        key = ("moe_w4a8_is", "fine")
        for K, N in DS_KN:
            w = moe_weights(gen, K, N, E=DS_E)
            for tokens in DS_TOKENS:
                counts = top_k_counts(tokens, seed=tokens)
                x, rc, xq, sa = inputs(DS_C, K, counts)
                rows.append(routed_quant(DS_C, K, x, rc))
                r = one(*key, DS_C, K, N, x, rc, xq, sa, w, groups[key])
                rows.append(dict(r, library_ms=None, bf16_matmul_ms=time_ms(
                    bmm, [(x, w["wd"])]), copies=1, tokens=tokens))
                log(f"[kernel] grouped IS {r['shape']} (DeepSeek-V2, top-6 "
                    f"of {tokens} tokens: {sum(c > 0 for c in counts)} "
                    f"experts, {sum(counts)} rows): {r['ms']:.4f} ms, bf16 "
                    f"bmm {rows[-1]['bf16_matmul_ms']:.4f} ms, share of "
                    f"bound {r['bound_ms'] / r['ms']:.3f}; plan {r['plan']}")
                del x, xq, sa
            del w
            torch.cuda.empty_cache()

    # W8A8 weights through the IS kernel at one decode shape
    K, N, C = 4096, 14336, 8
    w = moe_weights(gen, K, N, w_bits=8)
    x, rc, xq, sa = inputs(C, K, moe_counts(C, seed=7))
    r = one("moe_w4a8_is", "fine", C, K, N, x, rc, xq, sa, w,
            groups[("moe_w4a8_is", "fine")], w_bits=8)
    rows.append(dict(r, library_ms=None,
                     bf16_matmul_ms=time_ms(bmm, [(x, w["wd"])]), copies=1))
    del w, x, xq, sa
    torch.cuda.empty_cache()
    return errs


def build_models(api, cfg, recipes):
    """Random bf16 weights at full width, quantized under each recipe;
    the fp weights are freed before returning."""
    import torch
    from repro_torch import obs
    from repro_torch.core import ptq
    from repro_torch.nn import spec as S

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    fp = S.materialize(api.param_specs(cfg, None), gen, device="cuda")
    torch.cuda.synchronize()
    log(f"[model] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; random bf16 "
        f"weights {time.perf_counter() - t0:.2f} s")
    out = {}
    for recipe in recipes:
        reg = obs.Registry()
        t0 = time.perf_counter()
        with obs.use_registry(reg):
            qparams = ptq.post_training_quantize(api, cfg, fp, recipe)
        torch.cuda.synchronize()
        qbytes = sum(t.numel() * t.element_size()
                     for blk in qparams["blocks"] for t in S.leaves(blk))
        caps = reg.counter("alpha_cap_events_total").total()
        log(f"[model] {recipe.name}: RTN quantize {time.perf_counter() - t0:.2f}"
            f" s, quantized blocks {qbytes / 1e9:.3f} GB, alpha caps {caps:g}")
        out[recipe.name] = qparams
    del fp
    torch.cuda.empty_cache()
    return out


def _seeded_tokens(cfg, shape):
    """Token ids drawn from a fixed seed: distinct tokens route to several
    experts, as served ones do (one id everywhere routes to two)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(5)
    return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                         device="cuda")


def _decode_inputs(api, cfg, sc):
    import torch
    from repro_torch.nn import spec as S

    B = sc.max_slots
    cache = S.materialize(api.cache_specs(cfg, B, sc.max_seq), device="cuda")
    toks = _seeded_tokens(cfg, (B, 1))
    pos = torch.full((B,), 100, dtype=torch.int64, device="cuda")
    return cache, toks, pos


def time_decode_step(api, cfg, model, sc, reps=5):
    """ms of one batched decode step of seeded tokens at position 100 in
    every slot: eager
    calls between CUDA events, and the same call captured as a CUDA graph
    and replayed. The graph's time is the device's; the difference is the
    host time the eager step adds."""
    cache, toks, pos = _decode_inputs(api, cfg, sc)
    out = time_eager_and_graph(
        lambda: model(toks, mode="decode", cache=cache, pos=pos)[0], reps)
    del cache
    return out


def time_prefill(api, cfg, model, sc, reps=3):
    """ms of one batch-1 prefill of ``sc.prefill_len`` seeded tokens as the
    engine runs it (full-sequence logits, writing the cache), eager and as
    a replayed CUDA graph, as :func:`time_decode_step`."""
    from repro_torch.nn import spec as S

    cache = S.materialize(api.cache_specs(cfg, 1, sc.max_seq), device="cuda")
    toks = _seeded_tokens(cfg, (1, sc.prefill_len))
    out = time_eager_and_graph(
        lambda: model(toks, mode="train", cache=cache, pos=0)[0], reps)
    del cache
    return out


def time_eager_and_graph(step, reps):
    """(eager ms, graph-replay ms) of ``step()``, between CUDA events."""
    import torch

    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        step()  # the allocator's blocks for this stream, outside the timing
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            step()
        end.record()
        end.synchronize()
        eager = start.elapsed_time(end) / reps
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        graph.replay()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        replay = start.elapsed_time(end) / reps
    del graph
    torch.cuda.empty_cache()
    return eager, replay


def shares_quantization() -> bool:
    """Whether this tree quantizes each shared activation once (an
    earlier commit's linears each quantize their own)."""
    from repro_torch.kernels import ops

    return hasattr(ops, "quantize_for")


def tick_launches(api, cfg, model, sc, schemes=None):
    """Each kernel's launches in one 4-slot decode step, and how many of
    the act_quant launches were its routed entry's (counted by wrapping
    the name the grouped wrappers call). ``schemes``: a dict that gets
    the step's quantized GEMM calls per scheme (``w4a8-is``, ``w8a8-is``
    ...)."""
    import torch
    from repro_torch import obs
    from repro_torch.kernels import _build, moe_gemm

    cache, toks, pos = _decode_inputs(api, cfg, sc)
    real, routed = moe_gemm.act_quant_routed, []

    def counted(*a, **k):
        routed.append(1)
        return real(*a, **k)

    moe_gemm.act_quant_routed = counted
    reg = obs.Registry()
    try:
        with torch.inference_mode(), obs.use_registry(reg):
            torch.cuda.synchronize()
            _build.reset_launches()
            model(toks, mode="decode", cache=cache, pos=pos)
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
    finally:
        moe_gemm.act_quant_routed = real
    if schemes is not None:
        calls = reg.counter("qgemm_calls_total", "",
                            ("scheme", "kind", "shape", "block"))
        for (scheme, *_), n in calls.items():
            schemes[scheme] = schemes.get(scheme, 0) + int(n)
    del cache
    return launches, len(routed)


def check_tick_launches(tag, name, cfg, launches, routed, per_layer=None,
                        want=None):
    """act_quant launches of one decode tick: one per distinct quantized
    activation (dense: q/k/v, o, gate/up, down; MoE: q/k/v, o dense and
    gate/up, down routed), or one per W4A8 linear in a tree that does not
    share; none under W4A16; ``per_layer`` dense ones a layer where the
    caller states it (a recipe whose linears transform their inputs), or
    the (dense, routed) pair ``want`` (MLA: :func:`mla_act_quant`).
    Logs and returns the counts."""
    L = cfg.num_layers
    moe_layers = bool(cfg.num_experts)
    shared = shares_quantization()
    if want is not None:
        want_dense, want_routed = want
    elif per_layer is not None:
        want_dense, want_routed = per_layer * L, 0
    elif name.startswith("w4a16"):
        want_dense, want_routed = 0, 0
    elif moe_layers:
        want_dense, want_routed = (2 * L, 2 * L) if shared else (4 * L, 3 * L)
    else:
        want_dense, want_routed = (4 * L, 0) if shared else (7 * L, 0)
    dense = launches["act_quant"] - routed
    log(f"[launches] {tag} {name}: one decode tick, act_quant "
        f"{launches['act_quant']} ({dense} dense + {routed} routed; "
        f"{launches['act_quant'] / L:g} a layer, expected "
        f"{want_dense} + {want_routed}); all kernels {json.dumps(launches)}")
    if (dense, routed) != (want_dense, want_routed):
        raise AssertionError(f"{tag} {name}: act_quant launches a tick "
                             f"{dense} dense + {routed} routed, expected "
                             f"{want_dense} + {want_routed}")
    return dict(launches, act_quant_dense=dense, act_quant_routed=routed)


def profile_decode_step(api, cfg, model, sc, top=8):
    """One decode step under ``obs.trace_window``: the step's total device
    time (ms), the part of it in the quantized GEMM kernels and their
    split reductions (ms), the ``top`` device kernels by CUDA time, the
    number of device kernel launches and of elementwise division
    (``DivFunctor``) launches."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch import obs

    cache, toks, pos = _decode_inputs(api, cfg, sc)
    with torch.inference_mode():
        model(toks, mode="decode", cache=cache, pos=pos)  # warm
        torch.cuda.synchronize()
        with obs.trace_window(str(ROOT / "build" / "profile")) as prof:
            model(toks, mode="decode", cache=cache, pos=pos)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        raise AssertionError("the profiler recorded no device kernels")
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    gemm = sum(e.self_device_time_total for e in kernels
               if any(k in e.key for k in GEMM_KERNELS)) / 1e3
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    n = sum(e.count for e in kernels)
    divs = sum(e.count for e in kernels if "DivFunctor" in e.key)
    del cache
    return total, gemm, [dict(name=e.key[:120], count=e.count,
                              ms=e.self_device_time_total / 1e3)
                         for e in ranked], n, divs


def serve_recipe(api, cfg, qparams, recipe, sc, prompts, *, drill=False,
                 fallback=None):
    """Serve ``prompts``; return (engine, outputs, launches, registry,
    wall seconds, peak bytes allocated from the engine's construction to
    the end of the run). ``drill`` arms the breaker drill (fallback
    weights, threshold 2, two injected decode failures at tick 3)."""
    import torch
    from repro_torch import obs
    from repro_torch.kernels import _build
    from repro_torch.serving.chaos import ChaosConfig, ChaosMonkey, KernelFault
    from repro_torch.serving.engine import Engine

    reg = obs.Registry()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    with obs.use_registry(reg):
        if drill:
            fb_params, fb_recipe = fallback
            eng = Engine(api, cfg, qparams,
                         dataclasses.replace(sc, breaker_threshold=2),
                         recipe=recipe, fallback_params=fb_params,
                         fallback_recipe=fb_recipe)
            ChaosMonkey(ChaosConfig(kernel_failures=(
                KernelFault(tick=3, count=2),))).install(eng)
        else:
            eng = Engine(api, cfg, qparams, sc, recipe=recipe)
        rids = [eng.submit(p) for p in prompts]
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        outs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    bad = {r: eng.outcome(r) for r in rids if eng.outcome(r) != "ok"}
    if bad:
        raise AssertionError(f"{recipe.name}: requests not ok: {bad}")
    if any(len(outs[r]) != sc.max_new_tokens for r in rids):
        raise AssertionError(f"{recipe.name}: a request did not generate "
                             "max_new_tokens")
    if not all(0 <= t < cfg.vocab_size for r in rids for t in outs[r]):
        raise AssertionError(f"{recipe.name}: token id out of range")
    return eng, [outs[r] for r in rids], launches, reg, wall, peak


def report_serve(tag, name, api, cfg, eng, outs, launches, reg, wall, sc,
                 peak):
    """Time one decode step (eager, and as a replayed CUDA graph), log the
    serving numbers of one recipe and return them. The tick and prefill
    means leave out each phase's first call (it holds the capture, as
    the device timer leaves it out); idle share = 1 - device timer / tick
    over the same calls."""
    step_eager, step_graph = time_decode_step(api, cfg, eng.model, sc)
    pre_eager, pre_graph = time_prefill(api, cfg, eng.model, sc)
    ntok = sum(len(o) for o in outs)
    dev = reg.histogram("engine_phase_device_seconds", "", ("phase",))
    ttft = reg.histogram("engine_ttft_seconds").get()

    def mean(h, **lb):
        st = h.get(**lb)
        return st["sum"] / st["count"]

    def steady(ev, key):
        secs = [e["seconds"] for e in reg.events()
                if e["ev"] == ev and key in e]
        return secs[0], sum(secs[1:]) / len(secs[1:])

    first_tick_s, tick_s = steady("tick", "tick")
    first_prefill_s, prefill_s = steady("admit", "rid")
    st = dict(
        depth=cfg.num_layers, requests=len(outs), tokens=ntok,
        wall_s=wall, tokens_per_s=ntok / wall, ticks=eng.ticks,
        decode_tick_s=tick_s, first_tick_s=first_tick_s,
        prefill_s=prefill_s, first_prefill_s=first_prefill_s,
        ttft_mean_s=ttft["sum"] / ttft["count"],
        decode_device_s=mean(dev, phase="decode"),
        prefill_device_s=mean(dev, phase="prefill"),
        idle_share=1 - mean(dev, phase="decode") / tick_s,
        serve_peak_bytes=peak,
        step_eager_ms=step_eager, step_graph_ms=step_graph,
        prefill_eager_ms=pre_eager, prefill_graph_ms=pre_graph,
        launches=launches,
        tokens_sha256=hashlib.sha256(json.dumps(outs).encode()).hexdigest())
    log(f"[{tag}] {name}: {cfg.num_layers} layers, {len(outs)} requests "
        f"ok, {ntok} tokens in {wall:.3f} s = {st['tokens_per_s']:.1f} "
        f"tokens/s; {eng.ticks} ticks, {tick_s * 1e3:.2f} ms per tick after "
        f"the first (device timer {st['decode_device_s'] * 1e3:.2f} ms, "
        f"idle share {st['idle_share']:.3f}; first tick "
        f"{first_tick_s * 1e3:.1f} ms); prefill {prefill_s * 1e3:.2f} ms "
        f"after the first (device timer "
        f"{st['prefill_device_s'] * 1e3:.2f} ms; first "
        f"{first_prefill_s * 1e3:.1f} ms); mean TTFT "
        f"{st['ttft_mean_s'] * 1e3:.1f} ms; peak allocated while serving "
        f"{peak / 1e9:.2f} GB")
    log(f"[{tag}] {name}: one 4-slot decode step eager "
        f"{step_eager:.3f} ms, CUDA graph replay {step_graph:.3f} ms "
        f"(device idle share of the eager step "
        f"{1 - step_graph / step_eager:.3f}); one {sc.prefill_len}-token "
        f"prefill eager {pre_eager:.3f} ms, CUDA graph replay "
        f"{pre_graph:.3f} ms; first token of prompt 0 is "
        f"the argmax of the logits; launches {json.dumps(launches)}")
    log(f"[tokens] {tag} {name}: sha256 of the greedy token streams "
        f"{st['tokens_sha256']}")
    return st


def first_token_is_argmax(tag, eng, toks, n0, first):
    """The engine's first generated token for a prompt is the argmax of
    the model's logits at the prompt's end."""
    import torch

    with torch.inference_mode():
        lk = eng.model(toks)[0][0, n0 - 1]
    if not torch.isfinite(lk).all():
        raise AssertionError(f"{tag}: non-finite logits")
    if first != int(torch.argmax(lk)):
        raise AssertionError(f"{tag}: the engine's first token for prompt 0 "
                             "is not the argmax of the model's logits")


def plain_check(api, cfg, qparams, recipe, toks, n0, layers, sc):
    """The model cut to its first ``layers`` layers on the card (kernels)
    against the same layers on the CPU (plain versions), through the KV
    cache: a prefill of ``toks`` that writes the cache, then one decode
    step at position ``n0`` that reads it back. Returns (max abs diff
    relative to the largest logit over the prefill's logit at ``n0 - 1``
    and the decode step's, CPU seconds)."""
    import torch
    from repro_torch.nn import spec as S

    cut = dict(qparams, blocks=qparams["blocks"][:layers])
    c2 = dataclasses.replace(cfg, num_layers=layers)

    def run(params, device):
        model = api.build(c2, params, recipe)
        cache = S.materialize(api.cache_specs(c2, 1, sc.max_seq),
                              device=device)
        t = toks.to(device)
        pre = model(t, mode="train", cache=cache, pos=0)[0][0, n0 - 1]
        dec = model(t[:, :1], mode="decode", cache=cache, pos=torch.tensor(
            [n0], device=device))[0][0, 0]
        return pre.cpu(), dec.cpu()

    with torch.inference_mode():
        card = run(cut, "cuda")
        t0 = time.perf_counter()
        cpu = run(S.tree_map(lambda t: t.cpu(), cut), "cpu")
        cpu_s = time.perf_counter() - t0
    rel = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(card, cpu))
    if not rel <= PLAIN_LOGIT_REL_TOL:
        raise AssertionError(f"{cfg.name}: kernels vs plain versions, first "
                             f"{layers} layers ({cfg.kv_cache_dtype} cache): "
                             f"logits rel {rel}")
    log(f"[check] {cfg.name} {recipe.name}: first {layers} layers through "
        f"the {cfg.kv_cache_dtype} cache (a prefill, then one decode step), "
        f"kernels on the card vs plain versions on the CPU ({cpu_s:.1f} s): "
        f"logits rel {rel:.2e} (<= {PLAIN_LOGIT_REL_TOL})")
    return rel, cpu_s


def check_launches(tag, launches, must):
    missing = sorted(k for k in must if launches[k] <= 0)
    extra = sorted(k for k, n in launches.items() if k not in must and n)
    if missing or extra:
        raise AssertionError(f"{tag}: kernels that should have launched and "
                             f"did not: {missing}; launched and should not "
                             f"have: {extra}")


def captures_steps(eng) -> bool:
    """Whether this tree's engine captures its steps (an earlier commit's
    runs them eagerly)."""
    return hasattr(eng, "decode_traces")


def step_launches(eng):
    """(decode, prefill): each kernel's launches in one replay of the
    engine's current decode and prefill graphs."""
    return eng._decode_step.launches, eng._prefill_step.launches


def check_steps(tag, eng, reg, launches, gens=None):
    """Each step captured once per established parameter set (1 +
    fallbacks), and every kernel launched exactly what the graphs
    replayed plus one warm-up call per graph: ``gens`` holds each
    parameter set's (decode, prefill) launches a replay (the engine's own
    by default), and the run's events give each set's ticks and admits
    (a fallback event starts the next set). Logs and returns the
    counts."""
    want_traces = 1 + eng.fallbacks
    if (eng.decode_traces, eng.prefill_traces) != (want_traces,) * 2:
        raise AssertionError(
            f"{tag}: decode_traces {eng.decode_traces}, prefill_traces "
            f"{eng.prefill_traces}, expected {want_traces} each")
    gens = gens or [step_launches(eng)]
    ticks, admits = [0], [0]
    for e in reg.events():
        if e["ev"] == "fallback":
            ticks.append(0)
            admits.append(0)
        elif e["ev"] == "tick" and "tick" in e:     # a tick that replayed
            ticks[-1] += 1
        elif e["ev"] == "admit" and "rid" in e:     # a prefill that did
            admits[-1] += 1
    want = dict.fromkeys(launches, 0)
    for (d, p), t, a in zip(gens, ticks, admits, strict=True):
        for k in want:
            want[k] += d.get(k, 0) * (t + (t > 0)) + p.get(k, 0) * (a + (a > 0))
    log(f"[steps] {tag}: prefill_traces {eng.prefill_traces}, decode_traces "
        f"{eng.decode_traces}, fallbacks {eng.fallbacks}; replays: ticks "
        f"{ticks}, admits {admits}; launches = graphs' counts x (replays + "
        f"1 warm-up): {'exact' if launches == want else 'MISMATCH'}; decode "
        f"graph {json.dumps(gens[-1][0])}, prefill graph "
        f"{json.dumps(gens[-1][1])}")
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, the graphs' "
                             f"replays give {want}")
    return dict(decode_traces=eng.decode_traces,
                prefill_traces=eng.prefill_traces, ticks=ticks,
                admits=admits, decode_graph=gens[-1][0],
                prefill_graph=gens[-1][1])


def eager_greedy(api, cfg, model, prompts, sc):
    """Greedy streams of ``prompts`` from a plain eager loop over ``model``
    on the engine's schedule: free slots filled in order, each by a batch-1
    prefill into a fresh cache copied into the slot's rows; one batched
    decode a tick, idle slots fed token 0 at position 0; a request retires
    at ``max_new_tokens`` or ``max_seq`` (no eos). No graph, no engine."""
    import torch
    from repro_torch.nn import spec as S

    B, P = sc.max_slots, sc.prefill_len
    cache = S.materialize(api.cache_specs(cfg, B, sc.max_seq), device="cuda")
    queue, slots, outs = list(enumerate(prompts)), [None] * B, {}
    with torch.inference_mode():
        while queue or any(slots):
            for i in range(B):
                if slots[i] is None and queue:
                    rid, p = queue.pop(0)
                    one = S.materialize(api.cache_specs(cfg, 1, sc.max_seq),
                                        device="cuda")
                    toks = torch.tensor([p + [0] * (P - len(p))],
                                        device="cuda")
                    logits = model(toks, mode="train", cache=one, pos=0)[0]
                    for big, c in zip(cache["blocks"], one["blocks"]):
                        for k, t in big.items():
                            t[i] = c[k][0]
                    slots[i] = (rid, len(p),
                                [int(logits[0, len(p) - 1].argmax())])
            last = torch.tensor([[s[2][-1] if s else 0] for s in slots],
                                device="cuda")
            pos = torch.tensor([s[1] if s else 0 for s in slots],
                               device="cuda")
            nxt = model(last, mode="decode", cache=cache, pos=pos)[0][:, 0]
            for i, tok in enumerate(nxt.argmax(-1).tolist()):
                if slots[i] is None:
                    continue
                rid, n, gen = slots[i]
                gen.append(tok)
                if len(gen) >= sc.max_new_tokens or n + 2 >= sc.max_seq:
                    outs[rid], slots[i] = gen, None
                else:
                    slots[i] = (rid, n + 1, gen)
    del cache
    return [outs[r] for r in range(len(prompts))]


def check_eager_streams(tag, api, cfg, eng, prompts, sc, outs):
    """The engine's greedy streams equal :func:`eager_greedy`'s."""
    t0 = time.perf_counter()
    if eager_greedy(api, cfg, eng.model, prompts, sc) != outs:
        raise AssertionError(f"{tag}: the engine's streams differ from an "
                             "eager greedy loop over the same model")
    log(f"[check] {tag}: the engine's {len(outs)} greedy streams equal an "
        f"eager greedy loop over the same model "
        f"({time.perf_counter() - t0:.1f} s)")


def time_eager_ms(fn, args, iters=30):
    """Mean ms per call of ``iters`` eager calls between CUDA events (for a
    plain version that cannot be captured: one that goes through the
    host)."""
    import torch

    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def qlint_run(args: list[str]) -> tuple[int, list, list]:
    """``python -m repro_torch.analysis.qlint <args>`` in process, its
    lines logged: (exit code, findings, certificates)."""
    from repro_torch.analysis import qlint

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = qlint.run(args)
    for line in out.getvalue().splitlines():
        log(f"[qlint] {line}")
    return res


def check_qlint(smi: str):
    """Phase 2b: qlint's registry and fixtures at every level, then the
    path: each fixture launched once on the card against its plain version,
    its launches counted; then each fixture timed beside its plain version
    (graph-replayed where it can be captured) and, for the two copies, the
    one PyTorch call that computes it. Returns (kernel rows, stats)."""
    import torch
    from repro_torch.analysis import certify, fixtures, registry
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    ptx_s = _build.build(_build.KERNELS + _build.FIXTURES, ptx=True)
    log(f"[qlint] PTX of {len(ptx_s)} sources in "
        f"{time.perf_counter() - t0:.1f} s (nvcc -ptx -arch=sm_90a)")

    rc, findings, certs = qlint_run(["--ptx"])
    if rc != 0 or findings:
        raise AssertionError(f"qlint --ptx over the registry exited {rc}")
    if not certs or not all(c.ok for c in certs):
        raise AssertionError(f"qlint certificates: {certs}")
    summ = certify.summary(certs)

    rc_fx, fx_findings, _ = qlint_run(["--fixtures", "--ptx"])
    if rc_fx != 1:
        raise AssertionError(f"qlint --fixtures exited {rc_fx}, not 1")
    entries = fixtures.entries()
    for entry in entries:
        mine = [f for f in fx_findings if f.kernel == entry.name]
        by_level = {lvl: {f.rule for f in mine if f.level == lvl}
                    for lvl in ("aten", "plan", "ptx")}
        if QLINT_RULE[entry.name] not in by_level["aten"] | by_level["plan"]:
            raise AssertionError(f"{entry.name}: not flagged "
                                 f"{QLINT_RULE[entry.name]}: {mine}")
        want_ptx = QLINT_PTX_RULE.get(entry.name)
        if want_ptx and want_ptx not in by_level["ptx"]:
            raise AssertionError(f"{entry.name}: PTX not flagged {want_ptx}: "
                                 f"{mine}")
        if any(f.rule == "analysis-error" for f in mine):
            raise AssertionError(f"{entry.name}: {mine}")
        log(f"[qlint] {entry.name}: flagged "
            + "; ".join(f"{lvl} {sorted(r)}" for lvl, r in by_level.items()
                        if r))

    # the path: each fixture once on the card, its launches counted
    torch.cuda.synchronize()
    _build.reset_launches()
    errs = {e.op.name: fixtures.run_on_card(e.op) for e in entries}
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES.get(k, 0) for k in _build.FIXTURES}
    if any(n != 1 for n in launches.values()):
        raise AssertionError(f"qlint fixtures: launches {launches}")

    # each fixture beside its plain version and library call (not counted)
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(4321)
    for entry in entries:
        op = entry.op
        shapes = op.shapes()
        inputs = [torch.randint(int(r.lo), int(r.hi) + 1, s, generator=gen,
                                device="cuda", dtype=torch.int64).to(dt)
                  for s, dt, r in zip(shapes[:-1], op.dtypes, op.ranges)]
        out = torch.empty(shapes[-1], dtype=op.dtypes[-1], device="cuda")
        ms = time_ms(lambda *a: op(*a, out=out), [tuple(inputs)])
        if op.name == "broken_no_preferred":  # through the host
            plain_ms, how = time_eager_ms(op.plain, inputs), "eager"
        else:
            plain_ms, how = time_ms(op.plain, [tuple(inputs)]), "graph"
        library = QLINT_LIBRARY.get(op.name)
        lib_ms = (time_ms(library, [tuple(inputs)])
                  if library is not None else None)
        if library is not None and not torch.equal(library(*inputs),
                                                   op.plain(*inputs)):
            raise AssertionError(f"{op.name}: the library call differs")
        nbytes = sum(t.numel() * t.element_size() for t in (*inputs, out))
        if len(inputs) == 2:  # the dot fixtures: M K N multiply-adds
            macs = 2 * shapes[0][0] * shapes[0][1] * shapes[1][1]
            rate = (F32_FLOPS_PER_S if op.dtypes[-1] == torch.float32
                    else INT8_OPS_PER_S)
            b, by = bound(nbytes, (macs, rate))
        else:
            b, by = bound(nbytes, (0, 1.0))
        rows.append(dict(kernel=op.name, variant="qlint fixture",
                         shape=[list(x) for x in shapes], ms=ms,
                         plain_ms=plain_ms, bound_ms=b, bound_by=by,
                         library_ms=lib_ms, bf16_matmul_ms=None,
                         err=errs[op.name], launches=launches[op.name]))
        log(f"[kernel] {op.name} (qlint fixture) {shapes}: {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms ({how}), bound {b:.6f} ms ({by}), "
            f"library {'-' if lib_ms is None else f'{lib_ms:.4f} ms'}; "
            "bit-equal to plain, pad and guards unchanged")
    secs = time.perf_counter() - t0
    log(f"[qlint] {smi}: registry {len(registry.entries())} entries, "
        "0 findings, "
        f"{summ['certified']} certified / {summ['capped-alpha']} capped / "
        f"{summ['fallback']} fallback, worst accumulator "
        f"{summ['worst_frac']:.3f} of 2^31; fixtures "
        f"{len(entries)} entries, {len(fx_findings)} findings, each "
        "flagged and launched once "
        f"{json.dumps(launches)}; {secs:.1f} s")
    return rows, dict(registry=summ, fixture_findings=len(fx_findings),
                      launches=launches, seconds=secs, ptx_build_s=ptx_s)


def serve_checked(tag, name, api, cfg, qparams, recipe, sc, prompts, toks,
                  n0, launches_total, *, per_layer, eager, want=None,
                  must=KERNELS_OF["w4a8-is"],
                  plain_layers=PLAIN_CHECK_LAYERS):
    """Phase 5's serve and checks for one recipe of a later phase: every
    outcome ok, exactly the kernels ``must`` (the W4A8 IS ones) launched
    and exactly the graphs' counts, the first token the argmax of the
    logits, the first ``plain_layers`` layers on the card against the
    CPU's plain versions, the engine's streams against the eager greedy loop
    (``eager``), and ``per_layer`` act_quant a layer (or ``want``, the
    (dense, routed) pair) in one decode tick. Returns (stats, engine)."""
    eng, outs, launches, reg, wall, peak = serve_recipe(
        api, cfg, qparams, recipe, sc, prompts)
    check_launches(f"{tag} {name}", launches, must)
    steps = check_steps(f"{tag} {name}", eng, reg, launches)
    for k, n in launches.items():
        launches_total[k] += n
    first_token_is_argmax(f"{tag} {name}", eng, toks, n0, outs[0][0])
    if eager:
        check_eager_streams(f"{tag} {name}", api, cfg, eng, prompts, sc,
                            outs)
    rel, cpu_s = plain_check(api, cfg, qparams, recipe, toks, n0,
                             plain_layers, sc)
    st = report_serve(tag, name, api, cfg, eng, outs, launches, reg, wall,
                      sc, peak)
    schemes: dict = {}
    st.update(steps=steps, plain_logit_rel=rel, plain_cpu_s=cpu_s,
              tick_launches=check_tick_launches(
                  tag, name, cfg, *tick_launches(api, cfg, eng.model, sc,
                                                 schemes),
                  per_layer=per_layer, want=want),
              tick_gemm_calls=schemes, outs=outs)
    return st, eng


def _fp_linear(fp, path):
    node = fp
    for k in path.split("/"):
        node = node[int(k)] if isinstance(node, list) else node[k]
    return node["w"].float()


def calib_phase(api, cfg, sc, prompts, toks, n0, launches_total, smi):
    """Phase 7b: llama2-7b cut to ``CALIB_LAYERS`` layers, its fp weights
    drawn whole, captured over the
    calibration batches, quantized W4A8 g128 IS under each calibration
    algorithm and served. Layer 0's seven linears: AWQ's and OmniQuant's
    calibration output MSE at most RTN's."""
    import torch
    from repro_torch import obs
    from repro_torch.core import ptq
    from repro_torch.core.algorithms import awq, omniquant
    from repro_torch.core.recipe import QuantRecipe, QuantSpec
    from repro_torch.data.pipeline import calib_batches
    from repro_torch.nn import spec as S

    cfg = dataclasses.replace(cfg, num_layers=CALIB_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    fp = S.materialize(api.param_specs(cfg, None), gen, device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    batches = calib_batches(CALIB_BATCHES, vocab_size=cfg.vocab_size,
                            seq_len=128, batch_size=4)
    t0 = time.perf_counter()
    captured = ptq.collect_calibration(api, cfg, fp, batches)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    rows = {len(torch.cat(r)) for r in captured.values()}
    log(f"[calib] {cfg.name}: {cfg.num_layers} layers, random bf16 weights "
        f"{draw_s:.2f} s; {len(batches)} calibration batches of 4 x 128 "
        f"synthetic tokens captured in {calib_s:.2f} s: {len(captured)} "
        f"linears, {sorted(rows)} rows each")
    if len(captured) != 7 * cfg.num_layers:
        raise AssertionError(f"calibration captured {len(captured)} linears")

    mse = {}
    for path in sorted(p for p in captured if p.startswith("blocks/0/")):
        w, x = _fp_linear(fp, path), torch.cat(captured[path])
        ref = x @ w
        rtn = awq.output_mse(x, ref, *awq._rtn(w, 4, GROUP))
        a = awq.output_mse(x, ref, *awq.awq_quantize(w, x, 4, GROUP))
        o = awq.output_mse(x, ref, *omniquant.omniquant_quantize(w, x, 4,
                                                                 GROUP))
        mse[path] = dict(rtn=rtn, awq=a, omniquant=o)
        log(f"[calib] layer 0 {path}: calibration output MSE RTN {rtn:.6g}, "
            f"AWQ {a:.6g} ({a / rtn:.4f}x), OmniQuant {o:.6g} "
            f"({o / rtn:.4f}x)")
        if not (a <= rtn and o <= rtn):
            raise AssertionError(f"{path}: a search lost to RTN: {mse[path]}")

    del captured
    stats = {"draw_s": draw_s, "calib_s": calib_s, "layer0_mse": mse}
    for algo in CALIB_ALGOS:
        recipe = QuantRecipe(rules=(("*", QuantSpec(algo=algo)),),
                             name=f"w4a8-is-{algo}")
        t0 = time.perf_counter()
        with obs.use_registry(obs.Registry()):
            qp = ptq.post_training_quantize(api, cfg, fp, recipe, batches)
        torch.cuda.synchronize()
        ptq_s = time.perf_counter() - t0
        if algo == CALIB_ALGOS[-1]:
            # the last recipe serves without the fp weights on the card
            # (the others with them): whether they slow the served tick
            del fp
            gc.collect()
            torch.cuda.empty_cache()
        pre = sum(1 for blk in qp["blocks"] for part in ("attn", "mlp")
                  for lin in blk[part].values() if "pre_scale" in lin)
        log(f"[calib] {recipe.name}: PTQ {ptq_s:.2f} s on the card "
            f"(capture included); {pre} linears carry pre_scale; fp weights "
            f"{'freed' if algo == CALIB_ALGOS[-1] else 'held'} while "
            f"serving; {smi}")
        per_layer = 7 if algo in ("awq", "smoothquant") else 4
        if pre != (7 * cfg.num_layers if per_layer == 7 else 0):
            raise AssertionError(f"{recipe.name}: {pre} pre_scale leaves")
        st, eng = serve_checked("calib", recipe.name, api, cfg, qp, recipe,
                                sc, prompts, toks, n0, launches_total,
                                per_layer=per_layer,
                                eager=algo in ("gptq", "awq"),
                                plain_layers=CALIB_PLAIN_CHECK_LAYERS)
        st["ptq_s"] = ptq_s
        stats[recipe.name] = st
        del eng, qp
        gc.collect()
        torch.cuda.empty_cache()
    return stats


def profile_rot_products(api, cfg, model, sc):
    """One eager decode step under ``torch.profiler`` with shapes: the
    device time of the ``x @ rot`` products (the bf16 ``aten::mm`` of an
    (M, K) activation by a (K, K) rotation) and of all kernels, in ms,
    and the number of such products."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cache, toks, pos = _decode_inputs(api, cfg, sc)
    with torch.inference_mode():
        model(toks, mode="decode", cache=cache, pos=pos)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            model(toks, mode="decode", cache=cache, pos=pos)
            torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA) / 1e3
    rot_ms, n = 0.0, 0
    for e in prof.key_averages(group_by_input_shape=True):
        shapes = e.input_shapes or []
        if (e.key == "aten::mm" and len(shapes) >= 2 and len(shapes[1]) == 2
                and shapes[1][0] == shapes[1][1] == shapes[0][-1]):
            rot_ms += e.device_time_total / 1e3
            n += e.count
    del cache
    return rot_ms, total, n


def llama3_phase(sc, prompts, toks, n0, launches_total, smi):
    """Phase 8b: llama3.2-3b at full width, cut to ``LLAMA3_LAYERS``
    layers, under the paper's LLaMA-3
    recipe (W8A8 heuristic+6 on the down projections, W4A8 IS elsewhere,
    QuaRot rotation on every linear), served as in phase 5; every down
    projection's certificate certified or capped; the x @ rot products'
    share of a decode step."""
    import torch
    from repro_torch import obs
    from repro_torch.analysis import certify
    from repro_torch.core import ptq
    from repro_torch.core.recipe import LLAMA3_RECIPE
    from repro_torch.models.registry import get_arch, get_model
    from repro_torch.nn import spec as S

    full = get_arch("llama3.2-3b")
    cfg = dataclasses.replace(full, num_layers=LLAMA3_LAYERS)
    api = get_model(cfg)
    L = cfg.num_layers
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    fp = S.materialize(api.param_specs(cfg, None), gen, device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    fp_bytes = sum(t.numel() * t.element_size() for t in S.leaves(fp))
    log(f"[llama3] {cfg.name}: {L} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} query heads over {cfg.num_kv_heads} KV heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; random "
        f"bf16 weights {fp_bytes / 1e9:.2f} GB in {draw_s:.2f} s")
    n_before = len(certify.log())
    t0 = time.perf_counter()
    with obs.use_registry(obs.Registry()):
        qp = ptq.post_training_quantize(api, cfg, fp, LLAMA3_RECIPE)
    torch.cuda.synchronize()
    ptq_s = time.perf_counter() - t0
    del fp
    gc.collect()
    torch.cuda.empty_cache()
    certs = certify.log()[n_before:]
    downs = [c for c in certs if c.kernel.endswith("/mlp/down")]
    if len(downs) != L or not all(c.ok for c in downs):
        raise AssertionError(f"llama3 down projections' certificates: "
                             f"{[str(c) for c in downs]}")
    down_s = certify.summary(downs)
    rots = {t.data_ptr(): t for blk in qp["blocks"]
            for part in ("attn", "mlp") for lin in blk[part].values()
            for t in (lin["rot"],)}
    rot_bytes = sum(t.numel() * t.element_size() for t in rots.values())
    code_bytes = sum(t.numel() * t.element_size() for blk in qp["blocks"]
                     for part in ("attn", "mlp") for lin in blk[part].values()
                     for k, t in lin.items() if k != "rot")
    log(f"[llama3] {LLAMA3_RECIPE.name}: PTQ {ptq_s:.2f} s on the card "
        f"(one rotation per (K, layer): {len(rots)} matrices, "
        f"{rot_bytes / 1e9:.2f} GB bf16; codes and scales "
        f"{code_bytes / 1e9:.2f} GB); W8A8 down projections' certificates "
        f"{down_s['certified']} certified / {down_s['capped-alpha']} capped / "
        f"{down_s['fallback']} fallback, worst accumulator "
        f"{down_s['worst_frac']:.4f} of 2^31; {smi}")
    for c in downs[:2]:
        log(f"[llama3]   {c}")
    st, eng = serve_checked("llama3", LLAMA3_RECIPE.name, api, cfg, qp,
                            LLAMA3_RECIPE, sc, prompts, toks, n0,
                            launches_total, per_layer=7, eager=True)
    gemms = st["tick_gemm_calls"]
    if gemms.get("w8a8-is") != L or gemms.get("w4a8-is") != 6 * L:
        raise AssertionError(f"llama3: one tick's GEMM calls {gemms}")
    rot_ms, step_ms, n = profile_rot_products(api, cfg, eng.model, sc)
    if n != 7 * L:
        raise AssertionError(f"llama3: {n} x @ rot products in a step")
    # the same products alone, replayed as a graph at the decode shape
    xs = {K: torch.randn((sc.max_slots, K), device="cuda").to(torch.bfloat16)
          for K in {t.shape[0] for t in rots.values()}}
    per_step = [(xs[lin["rot"].shape[0]], lin["rot"]) for blk in qp["blocks"]
                for part in ("attn", "mlp") for lin in blk[part].values()]
    alone_ms = time_ms(lambda: [x @ r for x, r in per_step], [()], iters=3)
    log(f"[llama3] one 4-slot decode step (eager, profiled): {step_ms:.3f} "
        f"ms of device kernels, {n} x @ rot products {rot_ms:.3f} ms "
        f"({rot_ms / step_ms:.3f}); the {n} products alone as a replayed "
        f"graph {alone_ms:.3f} ms, against the step's graph replay "
        f"{st['step_graph_ms']:.3f} ms ({alone_ms / st['step_graph_ms']:.3f});"
        f" one tick's GEMM calls {json.dumps(gemms)}; {smi}")
    st.update(ptq_s=ptq_s, draw_s=draw_s, rot_bytes=rot_bytes,
              code_bytes=code_bytes, down_certificates=down_s,
              rot_ms_profiled=rot_ms, step_ms_profiled=step_ms,
              rot_products=n, rot_alone_ms=alone_ms)
    del eng, qp, per_step, rots
    gc.collect()
    torch.cuda.empty_cache()
    return st


def cache_bytes(api, cfg, sc) -> int:
    """Bytes of the engine's KV cache at ``sc``'s slots and length."""
    from repro_torch.nn import spec as S

    return sum(math.prod(sp.shape) * sp.dtype.itemsize for sp in S.leaves(
        api.cache_specs(cfg, sc.max_slots, sc.max_seq)))


def kv8_phase(api, cfg, qparams, recipe, sc, prompts, toks, n0,
              launches_total, is_outs, smi):
    """Phase 5b, ``[kv8]``: the int8 KV cache. ``quantize_kv`` on the card
    bit-equal to the CPU's on one seeded (4, 128, 32, 128) bf16 input;
    then phase 5's IS weights served with ``kv_cache_dtype="int8"`` and
    checked as phase 5 checks IS (outcomes, one capture per step, exact
    launches, the argmax, the eager greedy loop, the first 2 layers
    against the CPU through the cache, act_quant 4 a layer). Logs the
    cache's bytes in bf16 and int8 and the share of stream tokens equal to
    phase 5's bf16-cache streams (information, not a gate)."""
    import torch
    from repro_torch.models.attention import quantize_kv

    x = (torch.randn((4, 128, 32, 128), generator=torch.Generator(
        ).manual_seed(8)) * 2).to(torch.bfloat16)
    q, s = quantize_kv(x.cuda())
    q_c, s_c = quantize_kv(x)
    torch.cuda.synchronize()
    if not (torch.equal(q.cpu(), q_c) and torch.equal(s.cpu(), s_c)):
        raise AssertionError("quantize_kv on the card differs from the CPU")
    log("[kv8] quantize_kv (4, 128, 32, 128) bf16: codes and scales on the "
        "card equal the CPU's bit for bit")

    kcfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    b16, b8 = cache_bytes(api, cfg, sc), cache_bytes(api, kcfg, sc)
    eng, outs, launches, reg, wall, peak = serve_recipe(
        api, kcfg, qparams, recipe, sc, prompts)
    if eng.cache["blocks"][0]["k"].dtype != torch.int8:
        raise AssertionError("kv8: the engine's cache is not int8")
    check_launches("kv8", launches, KERNELS_OF["w4a8-is"])
    steps = check_steps("kv8", eng, reg, launches)
    for k, n in launches.items():
        launches_total[k] += n
    first_token_is_argmax("kv8", eng, toks, n0, outs[0][0])
    check_eager_streams("kv8", api, kcfg, eng, prompts, sc, outs)
    rel, cpu_s = plain_check(api, kcfg, qparams, recipe, toks, n0,
                             PLAIN_CHECK_LAYERS, sc)
    st = report_serve("kv8", f"{recipe.name} int8 cache", api, kcfg, eng,
                      outs, launches, reg, wall, sc, peak)
    st.update(steps=steps, plain_logit_rel=rel, plain_cpu_s=cpu_s,
              cache_bytes_bf16=b16, cache_bytes_int8=b8,
              tick_launches=check_tick_launches(
                  "kv8", recipe.name, kcfg,
                  *tick_launches(api, kcfg, eng.model, sc)))
    same = sum(a == b for o, p in zip(outs, is_outs) for a, b in zip(o, p))
    st["tokens_equal_bf16_cache"] = same / sum(len(o) for o in outs)
    log(f"[kv8] {cfg.name} {recipe.name}: KV cache {b16 / 1e6:.1f} MB in "
        f"bf16, {b8 / 1e6:.1f} MB in int8 (codes and scales) at "
        f"{sc.max_slots} slots x {sc.max_seq}; tick "
        f"{st['decode_tick_s'] * 1e3:.2f} ms (device timer "
        f"{st['decode_device_s'] * 1e3:.2f} ms, idle share "
        f"{st['idle_share']:.3f}); stream tokens equal to the bf16 cache's "
        f"{st['tokens_equal_bf16_cache']:.3f}; {smi}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return st


def act_quant_rows(api, cfg, model, sc):
    """The (K, dtype) of every dense act_quant call in one decode step."""
    import torch
    from repro_torch.kernels import ops

    real, seen = ops.act_quant, set()

    def recorded(x, *a, **k):
        seen.add((x.shape[-1], str(x.dtype).removeprefix("torch.")))
        return real(x, *a, **k)

    cache, toks, pos = _decode_inputs(api, cfg, sc)
    ops.act_quant = recorded
    try:
        with torch.inference_mode():
            model(toks, mode="decode", cache=cache, pos=pos)
    finally:
        ops.act_quant = real
    del cache
    return sorted(seen)


def build_by_layer(api, cfg, recipe, whole=False):
    """``cfg`` under ``recipe`` built block by block on the card (random
    weights, seed 0; ``whole``: drawn whole from one generator seeded 0
    and quantized with ``post_training_quantize``, for a tree without
    top-level blocks), every overflow certificate certified or capped:
    (params, build s, peak bytes allocated while building, weight bytes,
    the certificates, their summary)."""
    import torch
    from repro_torch import obs
    from repro_torch.analysis import certify
    from repro_torch.core import ptq
    from repro_torch.nn import spec as S

    n_before = len(certify.log())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with obs.use_registry(obs.Registry()):
        if whole:
            gen = torch.Generator(device="cuda").manual_seed(0)
            qp = ptq.post_training_quantize(api, cfg, S.materialize(
                api.param_specs(cfg, None), gen, device="cuda"), recipe)
        else:
            qp = ptq.quantize_by_layer(api, cfg, recipe, seed=0,
                                       device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    qbytes = sum(t.numel() * t.element_size() for t in S.leaves(qp))
    certs = certify.log()[n_before:]
    if not certs or not all(c.ok for c in certs):
        raise AssertionError(f"{cfg.name}: certificates "
                             f"{[str(c) for c in certs if not c.ok]}")
    return qp, build_s, build_peak, qbytes, certs, certify.summary(certs)


def configs_phase(sc, prompts, toks, n0, launches_total, smi):
    """Phase 8c, ``[configs]``: each of ``CONFIG_ARCHS`` at full width
    under W4A8 g128 IS, built block by block (random weights, seed 0),
    every layer's overflow certificate certified or capped (each capped
    one printed), served with phase 5's prompts and ``ServeConfig``:
    every outcome ok, one capture per step, exactly the IS kernels (and
    the grouped IS kernel for a MoE config) and exactly the graphs'
    counts, the first token the argmax, m-tiles executed <= total for a
    MoE config, act_quant per layer as phase 5 and 8. Qwen2-72B is
    served a second time over an int8 KV cache on the same weights. Each
    model is freed before the next is built."""
    import torch
    from repro_torch.core.recipe import DEFAULT_RECIPE
    from repro_torch.models.registry import get_arch, get_model

    recipe = DEFAULT_RECIPE
    stats: dict[str, dict] = {}
    for arch in CONFIG_ARCHS:
        cfg = get_arch(arch)
        api = get_model(cfg)
        qp, build_s, build_peak, qbytes, certs, summ = build_by_layer(
            api, cfg, recipe)
        log(f"[configs] {cfg.name}: {cfg.num_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.num_heads} query heads over "
            f"{cfg.num_kv_heads} KV heads of {cfg.head_dim}, d_ff "
            f"{cfg.moe_d_ff or cfg.d_ff}"
            + (f", {cfg.num_experts} experts top-{cfg.top_k}"
               if cfg.num_experts else "")
            + f", vocab {cfg.vocab_size}; {recipe.name} built block by block"
            f" in {build_s:.1f} s; weights on the card {qbytes / 1e9:.2f} "
            f"GB; peak allocated while building {build_peak / 1e9:.2f} GB; "
            f"certificates {summ['certified']} certified / "
            f"{summ['capped-alpha']} capped / {summ['fallback']} fallback, "
            f"worst accumulator {summ['worst_frac']:.4f} of 2^31; {smi}")
        for c in certs:
            if c.verdict == "capped-alpha":
                log(f"[configs]   {c}")
        runs = [cfg]
        if arch == "qwen2-72b":
            runs.append(dataclasses.replace(cfg, kv_cache_dtype="int8"))
        for c in runs:
            name = f"{arch} {c.kv_cache_dtype} cache"
            torch.cuda.reset_peak_memory_stats()
            eng, outs, launches, reg, wall, peak = serve_recipe(
                api, c, qp, recipe, sc, prompts)
            eng.close()  # no routing sink from here on (the timed graphs)
            must = KERNELS_OF[recipe.name] | (
                {MOE_KERNEL_OF[recipe.name]} if c.num_experts else set())
            check_launches(f"configs {name}", launches, must)
            steps = check_steps(f"configs {name}", eng, reg, launches)
            for k, n in launches.items():
                launches_total[k] += n
            tiles = reg.counter("engine_moe_m_tiles_total", "", ("kind",))
            executed = tiles.get(kind="executed")
            total = tiles.get(kind="total")
            if c.num_experts and not 0 < executed <= total:
                raise AssertionError(f"configs {name}: m-tiles executed "
                                     f"{executed}, total {total}")
            first_token_is_argmax(f"configs {name}", eng, toks, n0,
                                  outs[0][0])
            st = report_serve("configs", name, api, c, eng, outs, launches,
                              reg, wall, sc, peak)
            st.update(
                steps=steps, build_s=build_s, build_peak_bytes=build_peak,
                weight_bytes=qbytes, certificates=summ,
                capped=[str(x) for x in certs
                        if x.verdict == "capped-alpha"],
                cache_bytes=cache_bytes(api, c, sc),
                m_tiles_executed=executed, m_tiles_total=total,
                act_quant_rows=act_quant_rows(api, c, eng.model, sc),
                tick_launches=check_tick_launches(
                    "configs", recipe.name, c,
                    *tick_launches(api, c, eng.model, sc)))
            log(f"[configs] {name}: build {build_s:.1f} s, peak allocated "
                f"building {build_peak / 1e9:.2f} GB / serving "
                f"{peak / 1e9:.2f} GB; tick {st['decode_tick_s'] * 1e3:.2f} "
                f"ms (device timer {st['decode_device_s'] * 1e3:.2f} ms, "
                f"idle share {st['idle_share']:.3f}); prefill "
                f"{st['prefill_s'] * 1e3:.2f} ms; mean TTFT "
                f"{st['ttft_mean_s'] * 1e3:.1f} ms; KV cache "
                f"{st['cache_bytes'] / 1e6:.1f} MB; capped certificates "
                f"{summ['capped-alpha']}; act_quant rows (K, dtype) "
                f"{st['act_quant_rows']}"
                + (f"; m-tiles executed/total {executed:g}/{total:g}"
                   if c.num_experts else "") + f"; {smi}")
            stats[name] = st
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        del qp
        gc.collect()
        torch.cuda.empty_cache()
    return stats


def mla_act_quant(cfg, mode: str) -> tuple[int, int]:
    """(dense, routed) act_quant launches of one MLA forward. A layer
    quantizes x once for q_down / kv_down, cq for q_up, the attention
    output for o and its MLP's two inputs (gate / up, down): 5; in
    prefill also c_kv for k_up / v_up (decode reads them dequantized): 6.
    A MoE layer's MLP is its shared experts' (the same two dense) plus the
    routed pair (gate / up over one dispatch buffer, down)."""
    from repro_torch.models.transformer import layer_kinds

    kinds = layer_kinds(cfg)
    return ((6 if mode == "prefill" else 5) * len(kinds),
            2 * kinds.count("moe"))


def profile_mla_step(api, cfg, model, sc, top=8):
    """One eager 4-slot decode step under ``torch.profiler``: its device
    ms, and the ms of the MLA decode's f32 einsums (``aten::einsum``, the
    absorbed attention over the latent cache), of ``_dense_weight`` (k_up
    and v_up dequantized in the step; a profiler range around each call)
    and of the quantized GEMMs; the ``top`` device kernels; and, as a
    check on the profiler's range, one layer's two ``_dense_weight`` calls
    timed alone as a replayed graph, times the layers."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import attention

    real, tag = attention._dense_weight, "mla._dense_weight"

    def annotated(*a, **k):
        with record_function(tag):
            return real(*a, **k)

    cache, toks, pos = _decode_inputs(api, cfg, sc)
    attention._dense_weight = annotated
    try:
        with torch.inference_mode():
            model(toks, mode="decode", cache=cache, pos=pos)  # warm
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                model(toks, mode="decode", cache=cache, pos=pos)
                torch.cuda.synchronize()
    finally:
        attention._dense_weight = real
    avg = prof.key_averages()
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key != tag]
    if not kernels:
        raise AssertionError("the profiler recorded no device kernels")

    def cpu_ms(key):
        return sum(e.device_time_total for e in avg
                   if e.key == key and e.device_type == DeviceType.CPU) / 1e3

    total = sum(e.self_device_time_total for e in kernels) / 1e3
    gemm = sum(e.self_device_time_total for e in kernels
               if any(k in e.key for k in GEMM_KERNELS)) / 1e3
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    attn = model.blocks[0].attn
    bufs = [(dict(lin.named_buffers(recurse=False)), lin.qspec)
            for lin in (attn.k_up, attn.v_up)]
    with torch.inference_mode():
        alone = time_ms(lambda: [real(p, q, cfg.kv_lora_rank,
                                      cfg.activation_dtype)
                                 for p, q in bufs], [()], iters=10)
    del cache
    return dict(device_ms=total, gemm_ms=gemm, einsum_ms=cpu_ms(
        "aten::einsum"), dense_weight_ms=cpu_ms(tag),
        dense_weight_alone_ms=alone * cfg.num_layers,
        launches=sum(e.count for e in kernels),
        top=[dict(name=e.key[:120], count=e.count,
                  ms=e.self_device_time_total / 1e3) for e in ranked])


def mla_phase(sc, prompts, toks, n0, launches_total, smi):
    """Phase 8d, ``[mla]``: each of ``MLA_ARCHS`` at full width under W4A8
    g128 IS (``MLA_DEPTH`` cuts DeepSeek-V2's depth), built block by
    block (random weights, seed 0), every certificate certified or capped
    (each capped one printed; DeepSeek-V2's o projection at K = 16384
    printed), served with phase 5's prompts and ``ServeConfig``: every
    outcome ok, one capture per step, exactly the IS kernels (the grouped
    one on DeepSeek-V2's experts, no flash: MLA's prefill attention is
    plain PyTorch, as the reference's) and exactly the graphs' counts,
    act_quant per graph as :func:`mla_act_quant` counts it, the first
    token the argmax, m-tiles executed <= total, the streams equal to the
    eager greedy loop, the first layer (DeepSeek-V2's dense one) on the
    card against the CPU's plain versions through the latent cache; then
    one decode step profiled. The decode's
    f32 einsums must run with TF32 off. Each model is freed before the
    next is built."""
    import torch
    from repro_torch.core.recipe import DEFAULT_RECIPE
    from repro_torch.models.registry import get_arch, get_model

    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("MLA decode's f32 einsums need TF32 off")
    recipe = DEFAULT_RECIPE
    stats: dict[str, dict] = {}
    for arch in MLA_ARCHS:
        full = get_arch(arch)
        cfg = dataclasses.replace(
            full, num_layers=MLA_DEPTH.get(arch, full.num_layers))
        api = get_model(cfg)
        qp, build_s, build_peak, qbytes, certs, summ = build_by_layer(
            api, cfg, recipe)
        o_k = cfg.num_heads * cfg.v_head_dim
        o_certs = [c for c in certs if c.kernel.endswith("/attn/o")
                   and f"K={o_k} " in c.config]
        if len(o_certs) != cfg.num_layers:
            raise AssertionError(f"{arch}: {len(o_certs)} o-projection "
                                 f"certificates at K = {o_k}")
        worst_o = max(o_certs, key=lambda c: c.bound)
        log(f"[mla] {cfg.name}: {cfg.num_layers} of {full.num_layers} "
            f"layers, d_model {cfg.d_model}, {cfg.num_heads} heads (q_lora "
            f"{cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}, rope "
            f"{cfg.qk_rope_dim}, nope {cfg.qk_nope_dim}, v {cfg.v_head_dim})"
            + (f", {cfg.num_experts} experts top-{cfg.top_k} of d_ff "
               f"{cfg.moe_d_ff} + {cfg.num_shared_experts} shared, "
               f"{cfg.first_dense_layers} dense layer of d_ff {cfg.d_ff}"
               if cfg.num_experts else f", d_ff {cfg.d_ff}")
            + f", vocab {cfg.vocab_size}; {recipe.name} built block by block"
            f" in {build_s:.1f} s; weights on the card {qbytes / 1e9:.2f} "
            f"GB; peak allocated while building {build_peak / 1e9:.2f} GB; "
            f"certificates {summ['certified']} certified / "
            f"{summ['capped-alpha']} capped / {summ['fallback']} fallback, "
            f"worst accumulator {summ['worst_frac']:.4f} of 2^31; o "
            f"projection at K = {o_k}: worst {worst_o}; {smi}")
        for c in certs:
            if c.verdict == "capped-alpha":
                log(f"[mla]   {c}")
        name = f"{arch} {recipe.name}"
        torch.cuda.reset_peak_memory_stats()
        eng, outs, launches, reg, wall, peak = serve_recipe(
            api, cfg, qp, recipe, sc, prompts)
        eng.close()  # no routing sink from here on (the timed graphs)
        must = {"act_quant", "w4a8_gemm_is"} | (
            {MOE_KERNEL_OF[recipe.name]} if cfg.num_experts else set())
        check_launches(f"mla {name}", launches, must)
        steps = check_steps(f"mla {name}", eng, reg, launches)
        for mode, graph in zip(("decode", "prefill"), step_launches(eng)):
            want = sum(mla_act_quant(cfg, mode))
            if graph["act_quant"] != want:
                raise AssertionError(f"mla {name}: {graph['act_quant']} "
                                     f"act_quant in the {mode} graph, "
                                     f"expected {want}")
        for k, n in launches.items():
            launches_total[k] += n
        tiles = reg.counter("engine_moe_m_tiles_total", "", ("kind",))
        executed = tiles.get(kind="executed")
        total = tiles.get(kind="total")
        if cfg.num_experts and not 0 < executed <= total:
            raise AssertionError(f"mla {name}: m-tiles executed "
                                 f"{executed}, total {total}")
        first_token_is_argmax(f"mla {name}", eng, toks, n0, outs[0][0])
        check_eager_streams(f"mla {name}", api, cfg, eng, prompts, sc, outs)
        rel, cpu_s = plain_check(api, cfg, qp, recipe, toks, n0,
                                 MLA_PLAIN_CHECK_LAYERS, sc)
        st = report_serve("mla", name, api, cfg, eng, outs, launches, reg,
                          wall, sc, peak)
        prof = profile_mla_step(api, cfg, eng.model, sc)
        st.update(
            steps=steps, build_s=build_s, build_peak_bytes=build_peak,
            weight_bytes=qbytes, certificates=summ,
            capped=[str(x) for x in certs if x.verdict == "capped-alpha"],
            o_projection_worst=str(worst_o),
            cache_bytes=cache_bytes(api, cfg, sc),
            m_tiles_executed=executed, m_tiles_total=total,
            plain_logit_rel=rel, plain_cpu_s=cpu_s, profile=prof,
            act_quant_rows=act_quant_rows(api, cfg, eng.model, sc),
            tick_launches=check_tick_launches(
                "mla", recipe.name, cfg,
                *tick_launches(api, cfg, eng.model, sc),
                want=mla_act_quant(cfg, "decode")))
        log(f"[mla] {name}: build {build_s:.1f} s, peak allocated building "
            f"{build_peak / 1e9:.2f} GB / serving {peak / 1e9:.2f} GB; tick "
            f"{st['decode_tick_s'] * 1e3:.2f} ms (device timer "
            f"{st['decode_device_s'] * 1e3:.2f} ms, idle share "
            f"{st['idle_share']:.3f}); prefill {st['prefill_s'] * 1e3:.2f} "
            f"ms; mean TTFT {st['ttft_mean_s'] * 1e3:.1f} ms; latent cache "
            f"{st['cache_bytes'] / 1e6:.1f} MB; act_quant rows (K, dtype) "
            f"{st['act_quant_rows']}"
            + (f"; m-tiles executed/total {executed:g}/{total:g}"
               if cfg.num_experts else "") + f"; {smi}")
        dev = prof["device_ms"]
        log(f"[profile] mla {name}: one 4-slot decode step {dev:.3f} ms of "
            f"device kernels in {prof['launches']} launches: MLA decode "
            f"einsums {prof['einsum_ms']:.3f} ms "
            f"({prof['einsum_ms'] / dev:.3f}), _dense_weight "
            f"{prof['dense_weight_ms']:.3f} ms "
            f"({prof['dense_weight_ms'] / dev:.3f}; alone as a replayed "
            f"graph x {cfg.num_layers} layers "
            f"{prof['dense_weight_alone_ms']:.3f} ms), quantized GEMMs "
            f"{prof['gemm_ms']:.3f} ms ({prof['gemm_ms'] / dev:.3f}); top "
            f"{len(prof['top'])}:")
        for p in prof["top"]:
            log(f"[profile]   {p['ms']:.3f} ms  x{p['count']}  {p['name']}")
        stats[name] = st
        del eng, qp
        gc.collect()
        torch.cuda.empty_cache()
    return stats


def xattn_launches(cfg, mode: str) -> dict[str, int]:
    """act_quant, IS GEMM and flash launches of one forward (mode
    "prefill" or "decode"), from the sharing of each layer kind. The VLM:
    a self layer quantizes q/k/v, o, gate/up and down (4) for 7 GEMMs and,
    in prefill, one causal flash (decode reads the self cache with
    ``decode_attention``); a cross layer quantizes q, o, gate/up and down,
    plus the memory once for k/v in prefill (5 / 4), for 7 / 5 GEMMs (no
    k/v linear in decode) and one non-causal flash. Whisper: an encoder
    layer (prefill only) quantizes q/k/v, o, up and down (4) for 6 GEMMs
    and one flash; a decoder layer the self q/k/v and o, the cross q and
    o, up and down, plus the encoder output once for the cross k/v in
    prefill (7 / 6), for 10 / 8 GEMMs and 2 / 1 flash (the self one causal
    in prefill, the cross one in both)."""
    from repro_torch.models.transformer import layer_kinds

    pre = mode == "prefill"
    if cfg.family == "vlm":
        kinds = layer_kinds(cfg)
        ns, nc = kinds.count("self"), kinds.count("cross")
        return {"act_quant": 4 * ns + (5 if pre else 4) * nc,
                "w4a8_gemm_is": 7 * ns + (7 if pre else 5) * nc,
                "flash_attention": (ns if pre else 0) + nc}
    ne = cfg.num_encoder_layers if pre else 0
    nd = cfg.num_layers
    return {"act_quant": 4 * ne + (7 if pre else 6) * nd,
            "w4a8_gemm_is": 6 * ne + (10 if pre else 8) * nd,
            "flash_attention": ne + (2 if pre else 1) * nd}


def check_xattn_launches(tag, launches, want, times=1):
    """Every kernel's launches equal ``want`` x ``times`` (others 0)."""
    full = {k: want.get(k, 0) * times for k in launches}
    if dict(launches) != full:
        raise AssertionError(f"{tag}: launches {dict(launches)}, expected "
                             f"{full}")


def set_cross_gates(qp) -> list[float]:
    """Draw every cross layer's gate_attn and gate_mlp uniform in [0.5,
    1.5] from ``XATTN_GATE_SEED`` (f32 on the card), in place."""
    import numpy as np
    import torch

    rng = np.random.default_rng(XATTN_GATE_SEED)
    drawn = []
    for blk in qp.get("blocks", []):
        if "gate_attn" in blk:
            for g in ("gate_attn", "gate_mlp"):
                drawn.append(float(rng.uniform(0.5, 1.5)))
                blk[g] = torch.tensor(drawn[-1], dtype=torch.float32,
                                      device=blk[g].device)
    return drawn


def _xattn_pos(cfg, p: int):
    """A decode position on the card: per row for the VLM, one 0-d
    tensor for Whisper (its reference takes a scalar only)."""
    import torch

    if cfg.family == "vlm":
        return torch.full((XATTN_B,), p, dtype=torch.int64, device="cuda")
    return torch.tensor(p, dtype=torch.int64, device="cuda")


def xattn_cache_mb(cfg, cache) -> tuple[float, float]:
    """(self, cross) cache MB."""
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.nn import spec as S

    def mb(tree):
        return sum(t.numel() * t.element_size() for t in S.leaves(tree)) / 1e6

    if cfg.family == "vlm":
        kinds = layer_kinds(cfg)
        return (mb([c for c, k in zip(cache["blocks"], kinds) if k != "cross"]),
                mb([c for c, k in zip(cache["blocks"], kinds) if k == "cross"]))
    return (mb([b["self"] for b in cache["blocks"]]),
            mb([b["cross"] for b in cache["blocks"]]))


def xattn_eager_loop(model, cfg, cache, first, steps, hook=None):
    """Greedy tokens (B, steps + 1) of an eager loop of ``steps`` decode
    steps over the cache from the prefill's ``first`` tokens."""
    import torch

    toks, tok = [first], first[:, None]
    with torch.inference_mode():
        for s in range(steps):
            logits = model(tok, mode="decode", cache=cache,
                           pos=_xattn_pos(cfg, XATTN_PROMPT + s))[0]
            if hook is not None and s == 0:
                hook.remove()
            tok = logits[:, 0].argmax(-1)[:, None]
            toks.append(tok[:, 0])
    return torch.stack(toks, 1)


def xattn_graph_loop(model, cfg, cache, first, steps):
    """The same loop with the decode step (and its argmax) captured once
    as a CUDA graph on static token and position buffers, replayed
    ``steps`` times: (tokens, host seconds of the loop, device ms of the
    loop between CUDA events). The step is warmed up eagerly once on a
    side stream first: it writes the first step's k/v at its position,
    which the first replay writes again with the same values."""
    import torch

    with torch.inference_mode():
        tok = first[:, None].clone()
        pos = _xattn_pos(cfg, XATTN_PROMPT)

        def step():
            return model(tok, mode="decode", cache=cache,
                         pos=pos)[0][:, 0].argmax(-1)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            nxt = step()
        toks = [first]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(steps):
            graph.replay()
            toks.append(nxt.clone())
            tok.copy_(nxt[:, None])
            pos.add_(1)
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
    del graph
    return torch.stack(toks, 1), wall, start.elapsed_time(end)


def xattn_plain_check(api, cfg, qp, recipe, model, toks, mem, hidden, sc):
    """Kernels on the card against plain versions on the CPU, B = 1, a
    prefill then one decode step through the caches; each relative to the
    largest value it is held against (``PLAIN_LOGIT_REL_TOL``). The VLM:
    its first cross layer alone (a self layer is the dense block phase 5
    holds on llama2-7b; one of d_model 8192 takes about 20 s on the CPU),
    fed the card's own input hidden states of row 0 and the same memory,
    compared on the layer's update (output minus input).
    Whisper whole: the encoder output and the logits. Returns ({name:
    rel}, CPU seconds)."""
    import torch
    from repro_torch.models.transformer import Block
    from repro_torch.nn import spec as S

    rels, t_cpu = {}, 0.0
    if cfg.family == "vlm":
        i = XATTN_CROSS_LAYER
        x_pre, x_dec = hidden
        outs = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            p = qp["blocks"][i] if dev == "cuda" else S.tree_map(
                lambda t: t.cpu(), qp["blocks"][i])
            blk = Block(cfg, p, recipe, "cross", f"blocks/{i}")
            cache = S.materialize(api.cache_specs(cfg, 1, sc.max_seq)[
                "blocks"][i], device=dev)
            with torch.inference_mode():
                y_pre = blk(x_pre.to(dev), mode="prefill", cache=cache,
                            pos=0, memory=mem[:1].to(dev))[0]
                y_dec = blk(x_dec.to(dev), mode="decode", cache=cache,
                            pos=None)[0]
            outs[dev] = ((y_pre - x_pre.to(dev)).float().cpu(),
                         (y_dec - x_dec.to(dev)).float().cpu())
            if dev == "cpu":
                t_cpu += time.perf_counter() - t0
        rels[f"cross layer {i}"] = max(
            ((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(outs["cuda"], outs["cpu"]))
    else:
        outs = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            p = qp if dev == "cuda" else S.tree_map(lambda t: t.cpu(), qp)
            m = api.build(cfg, p, recipe)
            cache = S.materialize(api.cache_specs(cfg, 1, sc.max_seq),
                                  device=dev)
            t, f = toks[:1].to(dev), mem[:1].to(dev)
            with torch.inference_mode():
                enc = m.encode(f)
                pre = m(t, mode="prefill", cache=cache, pos=0, memory=f)[0]
                dec = m(pre[:, -1].argmax(-1)[:, None].to(dev),
                        mode="decode", cache=cache,
                        pos=torch.tensor(XATTN_PROMPT, device=dev))[0]
            outs[dev] = [x.float().cpu() for x in (enc, pre, dec)]
            if dev == "cpu":
                t_cpu += time.perf_counter() - t0
        # the decode step's input token is the card's argmax on both
        for name, a, b in zip(("encoder output", "prefill logits",
                               "decode logits"), outs["cuda"], outs["cpu"]):
            rels[name] = ((a - b).abs().max() / b.abs().max()).item()
    bad = {k: v for k, v in rels.items() if not v <= PLAIN_LOGIT_REL_TOL}
    if bad:
        raise AssertionError(f"{cfg.name}: kernels vs plain versions {bad}")
    log(f"[check] {cfg.name}: kernels on the card vs plain versions on the "
        f"CPU, B = 1, a prefill then one decode step ({t_cpu:.1f} s on the "
        f"CPU): rel " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
        + f" (<= {PLAIN_LOGIT_REL_TOL})")
    return rels, t_cpu


def profile_xattn_step(model, cfg, cache, first, top=8):
    """One eager decode step under ``torch.profiler``: its device ms, the
    flash kernel's (in decode only cross attention launches it) and the
    quantized GEMMs'; the ``top`` device kernels; and every cross
    attention module of the step (q_norm, q and its quantization, flash
    over the cross cache, o and its quantization) timed alone as a
    replayed graph. The profiler does not charge the kernels launched
    through ctypes to an enclosing ``record_function`` range, so the
    modules are timed on their own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pos = _xattn_pos(cfg, XATTN_PROMPT + XATTN_STEPS)
    tok = first[:, None]
    with torch.inference_mode():
        model(tok, mode="decode", cache=cache, pos=pos)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(tok, mode="decode", cache=cache, pos=pos)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        raise AssertionError("the profiler recorded no device kernels")
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    gemm = sum(e.self_device_time_total for e in kernels
               if any(k in e.key for k in GEMM_KERNELS)) / 1e3
    flash = sum(e.self_device_time_total for e in kernels
                if "flash" in e.key) / 1e3
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    if cfg.family == "vlm":
        mods = [(b.attn, c) for b, c in zip(model.blocks, cache["blocks"])
                if b.cross]
    else:
        mods = [(b.cross_attn, c["cross"])
                for b, c in zip(model.blocks, cache["blocks"])]
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((XATTN_B, 1, cfg.d_model), generator=gen,
                    device="cuda").to(cfg.activation_dtype)
    with torch.inference_mode():
        alone = time_ms(lambda: [m(x, cache=c, mode="decode")
                                 for m, c in mods], [()], iters=10)
    return dict(device_ms=total, gemm_ms=gemm, flash_ms=flash,
                xattn_ms=alone, xattn_layers=len(mods),
                launches=sum(e.count for e in kernels),
                top=[dict(name=e.key[:120], count=e.count,
                          ms=e.self_device_time_total / 1e3)
                     for e in ranked])


def xattn_phase(launches_total, smi):
    """Phase 8e, ``[xattn]``: each of ``XATTN_ARCHS`` at full width under
    W4A8 g128 IS (the VLM built block by block at all 100 layers,
    Whisper-tiny whole), every certificate certified or capped (each
    capped one printed), the VLM's cross gates drawn nonzero, then run
    through the model API: one prefill of 4 seeded 128-token prompts with
    a seeded memory (normal x 0.1, bf16: 4 x 1600 image tokens, 4 x 1500
    frames) into the caches, and 32 greedy decode steps over them, eager
    and replayed as a CUDA graph. Checks: the graph's tokens equal the
    eager loop's; the first token is the argmax of a train-mode forward's
    last logits; the prefill's and each decode step's launches are
    exactly :func:`xattn_launches`'s (no other kernel); the kernels on
    the card against the plain versions on the CPU
    (:func:`xattn_plain_check`). Logs tokens/s of the replayed loop,
    the replayed step and eager prefill ms, weights, peaks, the caches'
    MB, and one profiled decode step's shares. Each model is freed
    before the next is built."""
    import numpy as np
    import torch
    from repro_torch.core.recipe import DEFAULT_RECIPE
    from repro_torch.kernels import _build
    from repro_torch.models.registry import get_arch, get_model
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.nn import spec as S
    from repro_torch.serving.engine import ServeConfig

    recipe = DEFAULT_RECIPE
    sc = ServeConfig(max_slots=1, prefill_len=XATTN_PROMPT,
                     max_seq=XATTN_MAX_SEQ)
    stats: dict[str, dict] = {}
    for arch in XATTN_ARCHS:
        cfg = get_arch(arch)
        api = get_model(cfg)
        vlm = cfg.family == "vlm"
        qp, build_s, build_peak, qbytes, certs, summ = build_by_layer(
            api, cfg, recipe, whole=not vlm)
        gates = set_cross_gates(qp)
        Sm = cfg.num_image_tokens or cfg.encoder_seq
        kinds = layer_kinds(cfg) if vlm else []
        log(f"[xattn] {cfg.name}: "
            + (f"{cfg.num_layers} layers ({kinds.count('self')} self, "
               f"{kinds.count('cross')} cross), " if vlm else f"{cfg.num_encoder_layers} encoder + "
               f"{cfg.num_layers} decoder layers, ")
            + f"d_model {cfg.d_model}, {cfg.num_heads} query heads over "
            f"{cfg.num_kv_heads} KV heads of {cfg.head_dim}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}, memory {Sm} x "
            f"{cfg.d_model}; {recipe.name} built "
            f"{'block by block' if vlm else 'whole'} in {build_s:.1f} s; "
            f"weights on the card {qbytes / 1e9:.2f} GB; peak allocated "
            f"while building {build_peak / 1e9:.2f} GB; certificates "
            f"{summ['certified']} certified / {summ['capped-alpha']} capped "
            f"/ {summ['fallback']} fallback, worst accumulator "
            f"{summ['worst_frac']:.4f} of 2^31"
            + (f"; cross gates drawn in [{min(gates):.3f}, "
               f"{max(gates):.3f}]" if gates else "") + f"; {smi}")
        for c in certs:
            if c.verdict == "capped-alpha":
                log(f"[xattn]   {c}")
        toks = torch.tensor(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (XATTN_B, XATTN_PROMPT)), device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(4)
        mem = (torch.randn((XATTN_B, Sm, cfg.d_model), generator=gen,
                           device="cuda") * 0.1).to(torch.bfloat16)
        model = api.build(cfg, qp, recipe)
        cache = S.materialize(api.cache_specs(cfg, XATTN_B, XATTN_MAX_SEQ),
                              device="cuda")
        self_mb, cross_mb = xattn_cache_mb(cfg, cache)
        hidden = []
        hook = None
        if vlm:  # the cross layer's inputs, row 0: prefill, first decode
            hook = model.blocks[XATTN_CROSS_LAYER].register_forward_pre_hook(
                lambda m, a: hidden.append(a[0][:1].detach().clone()))
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            torch.cuda.synchronize()
            _build.reset_launches()
            logits = model(toks, mode="prefill", cache=cache, pos=0,
                           memory=mem)[0]
            torch.cuda.synchronize()
            pre_launches = dict(_build.LAUNCHES)
            first = logits[:, -1].argmax(-1)
        check_xattn_launches(f"xattn {arch} prefill", pre_launches,
                             xattn_launches(cfg, "prefill"))
        _build.reset_launches()
        eager = xattn_eager_loop(model, cfg, cache, first, XATTN_STEPS,
                                 hook)
        torch.cuda.synchronize()
        dec_launches = dict(_build.LAUNCHES)
        check_xattn_launches(f"xattn {arch} eager decode", dec_launches,
                             xattn_launches(cfg, "decode"), XATTN_STEPS)
        _build.reset_launches()
        graph_toks, wall, loop_ms = xattn_graph_loop(model, cfg, cache,
                                                     first, XATTN_STEPS)
        check_xattn_launches(f"xattn {arch} warm-up + capture",
                             _build.LAUNCHES, xattn_launches(cfg, "decode"),
                             2)
        for k in _build.KERNELS:
            launches_total[k] += (pre_launches[k] + dec_launches[k]
                                  + _build.LAUNCHES[k]
                                  + xattn_launches(cfg, "decode").get(k, 0)
                                  * XATTN_STEPS)
        if not torch.equal(graph_toks, eager):
            raise AssertionError(f"xattn {arch}: the replayed graph's greedy "
                                 "tokens differ from the eager loop's")
        with torch.inference_mode():
            train = model(toks, mode="train", memory=mem)[0][:, -1]
        if not torch.equal(train.argmax(-1), first):
            raise AssertionError(f"xattn {arch}: the first token is not the "
                                 "argmax of a train-mode forward")
        del train
        pos_t = _xattn_pos(cfg, XATTN_PROMPT + XATTN_STEPS)
        eager_step, step_ms = time_eager_and_graph(
            lambda: model(first[:, None], mode="decode", cache=cache,
                          pos=pos_t)[0], reps=5)
        with torch.inference_mode():
            prefill_ms = time_eager_ms(
                lambda: model(toks, mode="prefill", cache=cache, pos=0,
                              memory=mem), (), iters=3)
        peak = torch.cuda.max_memory_allocated()
        rels, cpu_s = xattn_plain_check(api, cfg, qp, recipe, model, toks,
                                        mem, hidden, sc)
        prof = profile_xattn_step(model, cfg, cache, first)
        sha = hashlib.sha256(str(eager.tolist()).encode()).hexdigest()[:16]
        st = dict(
            layers=cfg.num_layers, build_s=build_s,
            build_peak_bytes=build_peak, weight_bytes=qbytes,
            certificates=summ, capped=[str(x) for x in certs
                                       if x.verdict == "capped-alpha"],
            gates=gates, prefill_launches=pre_launches,
            decode_launches=xattn_launches(cfg, "decode"),
            tokens_per_s=XATTN_B * XATTN_STEPS / wall,
            loop_s=wall, loop_device_ms=loop_ms,
            step_ms=step_ms, eager_step_ms=eager_step,
            prefill_ms=prefill_ms, serving_peak_bytes=peak,
            self_cache_mb=self_mb, cross_cache_mb=cross_mb, plain=rels,
            plain_cpu_s=cpu_s, profile=prof, tokens_sha=sha)
        log(f"[tokens] xattn {arch}: sha256 {sha}")
        log(f"[xattn] {arch}: {XATTN_B} x {XATTN_STEPS} greedy tokens, "
            f"replayed graph == eager loop; {st['tokens_per_s']:.1f} tokens/s"
            f" of the replayed loop ({wall * 1e3:.1f} ms host, "
            f"{loop_ms:.2f} ms device); decode step replayed {step_ms:.3f} ms"
            f" (eager {eager_step:.3f}); prefill {prefill_ms:.2f} ms; weights "
            f"{qbytes / 1e9:.2f} GB; peak allocated building "
            f"{build_peak / 1e9:.2f} GB / running {peak / 1e9:.2f} GB; caches "
            f"self {self_mb:.1f} MB, cross {cross_mb:.1f} MB; "
            f"launches a prefill {json.dumps(pre_launches)}, a decode step "
            f"{json.dumps(xattn_launches(cfg, 'decode'))}; {smi}")
        dev = prof["device_ms"]
        log(f"[profile] xattn {arch}: one {XATTN_B}-row decode step "
            f"{dev:.3f} ms of device kernels in {prof['launches']} launches: "
            f"its {prof['xattn_layers']} cross attention modules alone as "
            f"a replayed graph {prof['xattn_ms']:.3f} ms "
            f"({prof['xattn_ms'] / dev:.3f}; flash in the step "
            f"{prof['flash_ms']:.3f} ms), quantized GEMMs "
            f"{prof['gemm_ms']:.3f} ms "
            f"({prof['gemm_ms'] / dev:.3f}); top {len(prof['top'])}:")
        for p in prof["top"]:
            log(f"[profile]   {p['ms']:.3f} ms  x{p['count']}  {p['name']}")
        stats[arch] = st
        del model, cache, qp, mem, logits
        gc.collect()
        torch.cuda.empty_cache()
    return stats


def recurrent_launches(cfg, mode: str) -> dict[str, int]:
    """act_quant, IS GEMM and flash launches of one forward ("prefill" or
    "decode"), from the sharing of each layer kind. xLSTM: an mLSTM layer
    quantizes its input (up), xc once for q / k, xm (v) and h (down): 4,
    for 5 GEMMs; an sLSTM layer its input (wx), x once for ff_gate /
    ff_up, and ff_down's: 3, for 4 GEMMs; no flash. RecurrentGemma: an
    RG-LRU layer its input once for gate_proj / x_proj, out_proj's and the
    GeGLU's two: 4, for 6 GEMMs; a local attention layer q / k / v once,
    o and the GeGLU's two: 4, for 7 GEMMs and, in prefill only, one flash
    (decode attends over the ring in plain PyTorch)."""
    from repro_torch.models import griffin, xlstm

    kinds = (xlstm if cfg.family == "ssm" else griffin).layer_kinds(cfg)
    aq = {"mlstm": 4, "slstm": 3, "rec": 4, "attn": 4}
    gemm = {"mlstm": 5, "slstm": 4, "rec": 6, "attn": 7}
    out = {"act_quant": sum(aq[k] for k in kinds),
           "w4a8_gemm_is": sum(gemm[k] for k in kinds)}
    if mode == "prefill" and "attn" in kinds:
        out["flash_attention"] = kinds.count("attn")
    return out


def unpadded_streams(api, cfg, model, prompts, n):
    """Greedy streams of ``n`` tokens from an eager batch-1 loop over each
    prompt unpadded (the exact recurrence over the prompt alone, where the
    engine's prefill also reads its pad tokens, as the reference's)."""
    import torch
    from repro_torch.nn import spec as S

    outs = []
    with torch.inference_mode():
        for p in prompts:
            cache = S.materialize(api.cache_specs(cfg, 1, 1), device="cuda")
            logits = model(torch.tensor([p], device="cuda"), mode="prefill",
                           cache=cache)[0]
            seq = [int(logits[0, -1].argmax())]
            for _ in range(n - 1):
                logits = model(torch.tensor([[seq[-1]]], device="cuda"),
                               mode="decode", cache=cache)[0]
                seq.append(int(logits[0, -1].argmax()))
            outs.append(seq)
    return outs


def profile_recurrent_step(model, step, top=8):
    """One eager decode step (``step()``) under ``torch.profiler``, with a
    profiler range around each call of the recurrences (xLSTM's
    ``_mlstm_cell`` on C and ``_slstm_scan``; RecurrentGemma's ``_rglru``:
    the f32 ``wa`` / ``wi`` products, the gates and the scan), of Griffin's
    ``_ring_attention`` (local-attention decode over the ring) and of the
    model's ``logits`` (the final norm and the f32 head): the step's
    device ms, each range's, the quantized GEMMs' (by kernel name; the
    profiler charges no ctypes launch to a range) and the ``top`` device
    kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import griffin, xlstm

    patched = [(xlstm, "_mlstm_cell"), (xlstm, "_slstm_scan"),
               (griffin, "_rglru"), (griffin, "_ring_attention"),
               (type(model), "logits")]
    real = {(o, n): getattr(o, n) for o, n in patched}

    def annotated(fn, tag):
        def wrapped(*a, **k):
            with record_function(tag):
                return fn(*a, **k)
        return wrapped

    for (o, n), fn in real.items():
        setattr(o, n, annotated(fn, f"recurrent.{n}"))
    try:
        with torch.inference_mode():
            step()  # warm
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
    finally:
        for (o, n), fn in real.items():
            setattr(o, n, fn)
    avg = prof.key_averages()
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith("recurrent.")]
    if not kernels:
        raise AssertionError("the profiler recorded no device kernels")

    def range_ms(name):
        return sum(e.device_time_total for e in avg
                   if e.key == f"recurrent.{name}"
                   and e.device_type == DeviceType.CPU) / 1e3

    total = sum(e.self_device_time_total for e in kernels) / 1e3
    gemm = sum(e.self_device_time_total for e in kernels
               if any(k in e.key for k in GEMM_KERNELS)) / 1e3
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return dict(device_ms=total, gemm_ms=gemm,
                ranges={n: range_ms(n) for _, n in patched},
                launches=sum(e.count for e in kernels),
                top=[dict(name=e.key[:120], count=e.count,
                          ms=e.self_device_time_total / 1e3)
                     for e in ranked])


def log_recurrent_profile(name, prof, what):
    dev = prof["device_ms"]
    parts = [f"quantized GEMMs {prof['gemm_ms']:.3f} ms "
             f"({prof['gemm_ms'] / dev:.3f})"]
    for key, label in what:
        ms = prof["ranges"][key]
        parts.append(f"{label} {ms:.3f} ms ({ms / dev:.3f})")
    log(f"[profile] recurrent {name}: one decode step {dev:.3f} ms of device "
        f"kernels in {prof['launches']} launches: " + "; ".join(parts)
        + f"; top {len(prof['top'])}:")
    for p in prof["top"]:
        log(f"[profile]   {p['ms']:.3f} ms  x{p['count']}  {p['name']}")


def rg_plain_check(api, cfg, qp, recipe, toks):
    """RecurrentGemma's first ``RG_PLAIN_CHECK_LAYERS`` layers (its two
    RG-LRU layers and first local attention) on the card against the
    same layers on the CPU, B = 1: a prefill of ``toks`` into the state,
    then one decode step at a 0-d position; (rel to the largest logit,
    CPU seconds)."""
    import torch
    from repro_torch.nn import spec as S

    L = RG_PLAIN_CHECK_LAYERS
    cut = dict(qp, blocks=qp["blocks"][:L])
    c2 = dataclasses.replace(cfg, num_layers=L)
    outs, t_cpu = {}, 0.0
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        p = cut if dev == "cuda" else S.tree_map(lambda t: t.cpu(), cut)
        model = api.build(c2, p, recipe)
        cache = S.materialize(api.cache_specs(c2, 1, RG_MAX_SEQ), device=dev)
        t = toks.to(dev)
        with torch.inference_mode():
            pre = model(t, mode="prefill", cache=cache, pos=0)[0][0, -1]
            dec = model(t[:, :1], mode="decode", cache=cache,
                        pos=torch.tensor(t.shape[1], device=dev))[0][0, 0]
        outs[dev] = (pre.float().cpu(), dec.float().cpu())
        if dev == "cpu":
            t_cpu = time.perf_counter() - t0
    rel = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(outs["cuda"], outs["cpu"]))
    if not rel <= PLAIN_LOGIT_REL_TOL:
        raise AssertionError(f"{cfg.name}: kernels vs plain versions, first "
                             f"{L} layers: logits rel {rel}")
    log(f"[check] {cfg.name}: first {L} layers (2 RG-LRU, 1 local "
        f"attention) through the state, a prefill then one decode step, "
        f"kernels on the card vs plain versions on the CPU ({t_cpu:.1f} s): "
        f"logits rel {rel:.2e} (<= {PLAIN_LOGIT_REL_TOL})")
    return rel, t_cpu


def rg_greedy(model, cache, first, steps, graph):
    """Greedy tokens (B, steps + 1) of ``steps`` decode steps from the
    prefill's ``first`` tokens at a 0-d position on the card, eager or as
    a ``serving.graphs.Step`` (a warm-up whose advance of the state is
    undone, one capture, then replays): (tokens, host s, device ms of the
    loop)."""
    import torch
    from repro_torch.nn import spec as S
    from repro_torch.serving.graphs import Step

    with torch.inference_mode():
        tok = first[:, None].clone()
        pos = torch.tensor(RG_PROMPT, dtype=torch.int64, device="cuda")

        def step():
            return model(tok, mode="decode", cache=cache,
                         pos=pos)[0][:, 0].argmax(-1)

        run = step
        if graph:
            run = Step(step, torch.device("cuda"), state=S.leaves(cache))
            nxt = run()  # warm-up, capture, the first replay
            toks = [first, nxt.clone()]
            tok.copy_(nxt[:, None])
            pos.add_(1)
        else:
            toks = [first]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(steps - (len(toks) - 1)):
            nxt = run()
            toks.append(nxt.clone())
            tok.copy_(nxt[:, None])
            pos.add_(1)
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
    return torch.stack(toks, 1), wall, start.elapsed_time(end)


def recurrent_phase(sc, prompts, toks, n0, launches_total, smi):
    """Phase 8f, ``[recurrent]``: xLSTM-1.3B cut to
    ``RECURRENT_SERVED_LAYERS`` layers served through the engine with
    phase 5's prompts and ``ServeConfig`` and phase 8's checks (outcomes,
    one capture per step,
    exactly the IS kernels and the graphs' counts, each graph's launches
    the derived ones, the argmax, the streams equal to the eager greedy
    loop that prefills the same padded prompts from a zero state, the
    first 2 layers against the CPU's plain versions through the state,
    act_quant 4 an mLSTM and 3 an sLSTM layer); the number of the first
    ``RECURRENT_UNPADDED_PROMPTS`` streams equal to a loop over the
    unpadded prompts is printed, not held. Then
    RecurrentGemma-9B (38 layers: 26 RG-LRU, 12 local attention) through
    the model API: a prefill of ``RG_B`` seeded prompts, ``RG_STEPS``
    greedy steps at a 0-d position eager and as a replayed graph (equal),
    the first token the argmax of a train-mode forward, launches exactly
    :func:`recurrent_launches`'; one ``RG_LONG``-token prompt past the
    window, its prefill and ``RG_LONG_STEPS`` decode steps held to a
    train-mode forward over the same tokens within 5e-2 of the largest
    logit; its first layers against the CPU. Both W4A8 g128 IS built block
    by block (seed 0), every certificate certified or capped; one decode
    step of each profiled (``[profile] recurrent``)."""
    return {RECURRENT_SERVED: recurrent_served(sc, prompts, toks, n0,
                                               launches_total, smi),
            RECURRENT_API: recurrent_model_api(launches_total, smi)}


def recurrent_served(sc, prompts, toks, n0, launches_total, smi):
    """Phase 8f's xLSTM-1.3B, served through the engine (see
    :func:`recurrent_phase`)."""
    import torch
    from repro_torch.core.recipe import DEFAULT_RECIPE
    from repro_torch.models import xlstm
    from repro_torch.models.registry import get_arch, get_model

    recipe = DEFAULT_RECIPE
    cfg = dataclasses.replace(get_arch(RECURRENT_SERVED),
                              num_layers=RECURRENT_SERVED_LAYERS)
    api = get_model(cfg)
    qp, build_s, build_peak, qbytes, certs, summ = build_by_layer(
        api, cfg, recipe)
    kinds = xlstm.layer_kinds(cfg)
    state_mb = cache_bytes(api, cfg, sc) / 1e6
    state1_mb = cache_bytes(api, cfg, dataclasses.replace(
        sc, max_slots=1)) / 1e6
    log(f"[recurrent] {cfg.name}: {cfg.num_layers} layers "
        f"({kinds.count('mlstm')} mLSTM, {kinds.count('slstm')} sLSTM), "
        f"d_model {cfg.d_model}, {cfg.num_heads} heads, vocab "
        f"{cfg.vocab_size}; {recipe.name} built block by block in "
        f"{build_s:.1f} s; weights on the card {qbytes / 1e9:.2f} GB; peak "
        f"allocated while building {build_peak / 1e9:.2f} GB; certificates "
        f"{summ['certified']} certified / {summ['capped-alpha']} capped / "
        f"{summ['fallback']} fallback, worst accumulator "
        f"{summ['worst_frac']:.4f} of 2^31; state {state_mb:.1f} MB at "
        f"{sc.max_slots} slots + {state1_mb:.1f} MB the batch-1 prefill "
        f"cache; {smi}")
    for c in certs:
        if c.verdict == "capped-alpha":
            log(f"[recurrent]   {c}")
    want = recurrent_launches(cfg, "decode")
    torch.cuda.reset_peak_memory_stats()
    st, eng = serve_checked(
        "recurrent", cfg.name, api, cfg, qp, recipe, sc, prompts, toks, n0,
        launches_total, per_layer=None, eager=True,
        want=(want["act_quant"], 0), must={"act_quant", "w4a8_gemm_is"})
    for step, mode in ((eng._decode_step, "decode"),
                       (eng._prefill_step, "prefill")):
        if step.launches != recurrent_launches(cfg, mode):
            raise AssertionError(f"recurrent {cfg.name} {mode} graph: "
                                 f"launches {step.launches}, expected "
                                 f"{recurrent_launches(cfg, mode)}")
    t0 = time.perf_counter()
    unpadded = unpadded_streams(api, cfg, eng.model,
                                prompts[:RECURRENT_UNPADDED_PROMPTS],
                                sc.max_new_tokens)
    same = sum(a == b for a, b in zip(unpadded, st["outs"]))
    log(f"[recurrent] {cfg.name}: {same} of {len(unpadded)} streams equal a "
        f"loop over the unpadded prompt (the engine prefills the padded "
        f"prompt from a zero state, as the reference's; not a gate; "
        f"{time.perf_counter() - t0:.1f} s); graphs' launches a prefill / "
        f"a tick {json.dumps(eng._prefill_step.launches)} / "
        f"{json.dumps(eng._decode_step.launches)}")
    cache, dtoks, dpos = _decode_inputs(api, cfg, sc)
    prof = profile_recurrent_step(eng.model, lambda: eng.model(
        dtoks, mode="decode", cache=cache, pos=dpos))
    del cache
    log_recurrent_profile(cfg.name, prof, (
        ("_mlstm_cell", "mLSTM cell on C"), ("_slstm_scan", "sLSTM step"),
        ("logits", "f32 logit head")))
    st.update(build_s=build_s, build_peak_bytes=build_peak,
              weight_bytes=qbytes, certificates=summ,
              state_mb=state_mb, state1_mb=state1_mb,
              unpadded_equal=same, profile=prof,
              serving_peak_bytes=torch.cuda.max_memory_allocated())
    log(f"[recurrent] {cfg.name}: tick {st['decode_tick_s'] * 1e3:.2f} ms "
        f"(device timer {st['decode_device_s'] * 1e3:.2f} ms, idle share "
        f"{st['idle_share']:.3f}); prefill {st['prefill_s'] * 1e3:.2f} ms; "
        f"mean TTFT {st['ttft_mean_s'] * 1e3:.1f} ms; {st['tokens_per_s']:.1f}"
        f" tokens/s; peak allocated serving "
        f"{st['serving_peak_bytes'] / 1e9:.2f} GB; {smi}")
    del eng, qp
    gc.collect()
    torch.cuda.empty_cache()
    return st


def recurrent_model_api(launches_total, smi):
    """Phase 8f's RecurrentGemma-9B through the model API (see
    :func:`recurrent_phase`)."""
    import numpy as np
    import torch
    from repro_torch.core.recipe import DEFAULT_RECIPE
    from repro_torch.kernels import _build
    from repro_torch.models import griffin
    from repro_torch.models.registry import get_arch, get_model
    from repro_torch.nn import spec as S

    recipe = DEFAULT_RECIPE
    cfg = get_arch(RECURRENT_API)
    api = get_model(cfg)
    qp, build_s, build_peak, qbytes, certs, summ = build_by_layer(
        api, cfg, recipe)
    kinds = griffin.layer_kinds(cfg)
    log(f"[recurrent] {cfg.name}: {cfg.num_layers} layers "
        f"({kinds.count('rec')} RG-LRU, {kinds.count('attn')} local "
        f"attention, window {cfg.window}), d_model {cfg.d_model}, "
        f"{cfg.num_heads} query heads over {cfg.num_kv_heads} KV head of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{recipe.name} built block by block in {build_s:.1f} s; weights on "
        f"the card {qbytes / 1e9:.2f} GB; peak allocated while building "
        f"{build_peak / 1e9:.2f} GB; certificates {summ['certified']} "
        f"certified / {summ['capped-alpha']} capped / {summ['fallback']} "
        f"fallback, worst accumulator {summ['worst_frac']:.4f} of 2^31; "
        f"{smi}")
    for c in certs:
        if c.verdict == "capped-alpha":
            log(f"[recurrent]   {c}")
    model = api.build(cfg, qp, recipe)
    rtoks = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (RG_B, RG_PROMPT)), device="cuda")
    cache = S.materialize(api.cache_specs(cfg, RG_B, RG_MAX_SEQ),
                          device="cuda")
    state_mb = sum(t.numel() * t.element_size()
                   for t in S.leaves(cache)) / 1e6
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        torch.cuda.synchronize()
        _build.reset_launches()
        logits = model(rtoks, mode="prefill", cache=cache, pos=0)[0]
        torch.cuda.synchronize()
        pre_launches = dict(_build.LAUNCHES)
        first = logits[:, -1].argmax(-1)
    check_xattn_launches(f"recurrent {cfg.name} prefill", pre_launches,
                         recurrent_launches(cfg, "prefill"))
    saved = [t.clone() for t in S.leaves(cache)]
    _build.reset_launches()
    eager, _, eager_ms = rg_greedy(model, cache, first, RG_STEPS, False)
    torch.cuda.synchronize()
    dec_launches = dict(_build.LAUNCHES)
    check_xattn_launches(f"recurrent {cfg.name} eager decode", dec_launches,
                         recurrent_launches(cfg, "decode"), RG_STEPS)
    for t, s in zip(S.leaves(cache), saved):
        t.copy_(s)
    del saved
    _build.reset_launches()
    graph_toks, wall, loop_ms = rg_greedy(model, cache, first, RG_STEPS, True)
    torch.cuda.synchronize()
    check_xattn_launches(f"recurrent {cfg.name} warm-up + {RG_STEPS} replays",
                         _build.LAUNCHES, recurrent_launches(cfg, "decode"),
                         RG_STEPS + 1)
    for k in _build.KERNELS:
        launches_total[k] += (pre_launches[k] + dec_launches[k]
                              + _build.LAUNCHES[k])
    if not torch.equal(graph_toks, eager):
        raise AssertionError(f"recurrent {cfg.name}: the replayed graph's "
                             "greedy tokens differ from the eager loop's")
    with torch.inference_mode():
        train = model(rtoks, mode="train")[0][:, -1]
    if not torch.equal(train.argmax(-1), first):
        raise AssertionError(f"recurrent {cfg.name}: the first token is not "
                             "the argmax of a train-mode forward")
    del train, logits
    # one prompt past the window: the ring wraps and the kernel's window
    # masks keys; its decode steps against a train-mode forward
    long = torch.tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, RG_LONG + RG_LONG_STEPS)), device="cuda")
    with torch.inference_mode():
        c1 = S.materialize(api.cache_specs(cfg, 1, RG_MAX_SEQ),
                           device="cuda")
        got = [model(long[:, :RG_LONG], mode="prefill", cache=c1,
                     pos=0)[0][0, -1]]
        for s_ in range(RG_LONG_STEPS):
            got.append(model(long[:, RG_LONG + s_:RG_LONG + s_ + 1],
                             mode="decode", cache=c1, pos=torch.tensor(
                                 RG_LONG + s_, device="cuda"))[0][0, 0])
        ref = model(long, mode="train")[0][0, RG_LONG - 1:]
    long_rel = max(((g - r).abs().max() / r.abs().max()).item()
                   for g, r in zip(got, ref))
    if not long_rel <= PLAIN_LOGIT_REL_TOL:
        raise AssertionError(f"recurrent {cfg.name}: a {RG_LONG}-token "
                             f"prefill and {RG_LONG_STEPS} decode steps vs a "
                             f"train-mode forward: rel {long_rel}")
    log(f"[check] {cfg.name}: a {RG_LONG}-token prompt (window "
        f"{cfg.window}: the ring wraps) prefilled, then {RG_LONG_STEPS} "
        f"decode steps, against a train-mode forward over the "
        f"{RG_LONG + RG_LONG_STEPS} tokens: logits rel {long_rel:.2e} "
        f"(<= {PLAIN_LOGIT_REL_TOL})")
    del c1, got, ref
    torch.cuda.empty_cache()
    pos_t = torch.tensor(RG_PROMPT + RG_STEPS, device="cuda")
    eager_step, step_ms = time_eager_and_graph(
        lambda: model(first[:, None], mode="decode", cache=cache,
                      pos=pos_t)[0], reps=5)
    with torch.inference_mode():
        prefill_ms = time_eager_ms(
            lambda: model(rtoks, mode="prefill", cache=cache, pos=0), (),
            iters=3)
    peak = torch.cuda.max_memory_allocated()
    rel, cpu_s = rg_plain_check(api, cfg, qp, recipe, rtoks[:1])
    prof = profile_recurrent_step(model, lambda: model(
        first[:, None], mode="decode", cache=cache, pos=pos_t))
    log_recurrent_profile(cfg.name, prof, (
        ("_rglru", "RG-LRU gates and scan"),
        ("_ring_attention", "local-attention decode"),
        ("logits", "f32 logit head")))
    sha = hashlib.sha256(str(eager.tolist()).encode()).hexdigest()[:16]
    st = dict(layers=cfg.num_layers, build_s=build_s,
              build_peak_bytes=build_peak, weight_bytes=qbytes,
              certificates=summ, prefill_launches=pre_launches,
              decode_launches=recurrent_launches(cfg, "decode"),
              tokens_per_s=RG_B * (RG_STEPS - 1) / wall, loop_s=wall,
              loop_device_ms=loop_ms, eager_loop_device_ms=eager_ms,
              step_ms=step_ms, eager_step_ms=eager_step,
              prefill_ms=prefill_ms, serving_peak_bytes=peak,
              state_mb=state_mb, long_rel=long_rel, plain=rel,
              plain_cpu_s=cpu_s, profile=prof, tokens_sha=sha)
    log(f"[tokens] recurrent {cfg.name}: sha256 {sha}")
    log(f"[recurrent] {cfg.name}: {RG_B} x {RG_STEPS} greedy tokens, "
        f"replayed graph == eager loop; {st['tokens_per_s']:.1f} tokens/s "
        f"of the replayed loop ({wall * 1e3:.1f} ms host, {loop_ms:.2f} ms "
        f"device); decode step replayed {step_ms:.3f} ms (eager "
        f"{eager_step:.3f}); prefill {prefill_ms:.2f} ms; weights "
        f"{qbytes / 1e9:.2f} GB; peak allocated building "
        f"{build_peak / 1e9:.2f} GB / running {peak / 1e9:.2f} GB; state "
        f"{state_mb:.1f} MB at {RG_B} rows; launches a prefill "
        f"{json.dumps(pre_launches)}, a decode step "
        f"{json.dumps(recurrent_launches(cfg, 'decode'))}; {smi}")
    del model, cache, qp
    gc.collect()
    torch.cuda.empty_cache()
    return st


# the ops of a MoE layer's dispatch and combine (sort, gathers, scatters,
# index_add_ and their backwards), by the CPU op that launches them
DISPATCH_OPS = ("aten::sort", "aten::argsort", "aten::gather",
                "aten::scatter", "aten::scatter_", "aten::scatter_add",
                "aten::scatter_add_", "aten::index", "aten::index_add_",
                "aten::index_put_", "aten::_index_put_impl_",
                "aten::cumsum", "aten::where")


def profile_train_step(step, params, opt, batch, vocab, top=8, experts=0,
                       ranges=()):
    """One train step under ``torch.profiler`` (with input shapes and a
    range around ``optimizer.apply_updates``): device ms in the flash
    forward and backward kernels (by name), the GEMMs (the self device
    time of ``aten::mm`` / ``addmm`` / ``bmm``), of them the f32 logit
    head's (a dimension of ``vocab``), AdamW (the range) and the rest.
    With ``experts``: the expert GEMMs (``aten::bmm``) and the router's
    products (a dimension of ``experts``) apart from the other GEMMs, and
    the dispatch and combine (``DISPATCH_OPS``). ``ranges``: (module,
    function name) pairs, each called inside a profiler range whose
    device ms (its forward calls and their recomputes under remat, the
    GEMMs in them included; autograd's backward runs outside it) is
    returned apart from the split."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.training import optimizer as O

    real = O.apply_updates

    def traced(*a, **k):
        with record_function("train.adamw"):
            return real(*a, **k)

    def annotated(fn, tag):
        def wrapped(*a, **k):
            with record_function(tag):
                return fn(*a, **k)
        return wrapped

    O.apply_updates = traced
    wrapped = {(o, n): getattr(o, n) for o, n in ranges}
    for (o, n), fn in wrapped.items():
        setattr(o, n, annotated(fn, f"train.{n}"))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            step(params, opt, batch)
            torch.cuda.synchronize()
    finally:
        O.apply_updates = real
        for (o, n), fn in wrapped.items():
            setattr(o, n, fn)
    avg = prof.key_averages(group_by_input_shape=True)
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith("train.")]
    if not kernels:
        raise AssertionError("the profiler recorded no device kernels")
    total = sum(e.self_device_time_total for e in kernels) / 1e3

    def kern(*names):
        return sum(e.self_device_time_total for e in kernels
                   if any(n in e.key for n in names)) / 1e3

    gemm = head = expert = router = dispatch = 0.0
    for e in avg:
        if e.device_type != DeviceType.CPU:
            continue
        ms = e.self_device_time_total / 1e3
        if e.key in ("aten::mm", "aten::addmm", "aten::bmm"):
            dims = {d for shp in (e.input_shapes or []) for d in (shp or [])}
            if vocab in dims:
                head += ms
            elif experts and e.key == "aten::bmm":
                expert += ms
            elif experts and experts in dims:
                router += ms
            else:
                gemm += ms
        elif experts and e.key in DISPATCH_OPS:
            dispatch += ms
    adamw = sum(e.device_time_total for e in avg
                if e.key == "train.adamw"
                and e.device_type == DeviceType.CPU) / 1e3
    split = dict(flash_fwd=kern("flash_fwd_kernel", "flash_tc_kernel"),
                 flash_bwd=kern("flash_bwd_"), gemm=gemm, logit_head=head,
                 adamw=adamw)
    if experts:
        split.update(expert_gemm=expert, router=router,
                     dispatch_combine=dispatch)
    split["rest"] = total - sum(split.values())
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    spans = {n: sum(e.device_time_total for e in avg
                    if e.key == f"train.{n}"
                    and e.device_type == DeviceType.CPU) / 1e3
             for _, n in ranges}
    return dict(device_ms=total, split=split, ranges=spans,
                launches=sum(e.count for e in kernels),
                top=[dict(name=e.key[:120], count=e.count,
                          ms=e.self_device_time_total / 1e3)
                     for e in ranked])


def timed_train_loop(cfg, dc, steps):
    """``launch.train.train_loop`` on the card from seed 0 with the
    reference's ``AdamWConfig`` defaults, launch counts reset just before:
    (params, opt, history, [(CUDA events around each step, its metrics)],
    the host's batch seconds, wall s, peak allocated bytes)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch import train as launch_train
    from repro_torch.training import optimizer as O

    timed, data_s = [], []
    real_make, real_pipe = (launch_train.make_train_step,
                            launch_train.SyntheticPipeline)

    def make_timed(*a, **k):
        step = real_make(*a, **k)

        def timed_step(params, opt, batch):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = step(params, opt, batch)
            ev[1].record()
            timed.append((ev, out[2]))
            return out
        return timed_step

    class TimedPipeline(real_pipe):
        def global_batch(self, step):
            t0 = time.perf_counter()
            out = super().global_batch(step)
            data_s.append(time.perf_counter() - t0)
            return out

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"[train] allocated on the card before the loop "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    _build.reset_launches()
    launch_train.make_train_step = make_timed
    launch_train.SyntheticPipeline = TimedPipeline
    t0 = time.perf_counter()
    try:
        params, opt, hist = launch_train.train_loop(
            cfg, dc, O.AdamWConfig(), steps=steps, seed=0, log_every=1,
            log_fn=log, device="cuda")
    finally:
        launch_train.make_train_step = real_make
        launch_train.SyntheticPipeline = real_pipe
    torch.cuda.synchronize()
    return (params, opt, hist, timed, data_s, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated())


def train_phase(launches_total, smi):
    """Phase 8g, ``[train]``: (a) ``TRAIN_ARCH`` (llama3.2-3b: 28 layers,
    d_model 3072, 24 query heads over 8 of 128, d_ff 8192, vocab 128256)
    at full width and depth, bf16, remat on, the reference's
    ``AdamWConfig`` defaults, ``TRAIN_STEPS`` steps of ``TRAIN_B`` x
    ``TRAIN_S`` synthetic tokens through ``launch.train.train_loop`` (no
    checkpoint): per-step device ms by CUDA events around each step (the
    first apart), tokens/s, peak memory, the resident params and AdamW
    state, each loss and grad norm (all finite), the host's batch time
    apart, launches exactly 2 flash forwards (the forward and remat's
    recompute) and 1 backward a layer and step and nothing else; one step
    with ``grad_accum=2`` against ``grad_accum=1`` on one batch at lr 0
    (loss and grad norm within ``TRAIN_ACCUM_*``); one step profiled
    (``profile_train_step``). (b) Its first ``TRAIN_CPU_LAYERS`` layers at
    full width: the loss and every leaf's gradient on the card against
    the CPU's plain versions (``TRAIN_CPU_*`` bounds). (c) The restart
    drill on ``bench-lm-30m`` (f32), as the reference's
    ``test_restart_drill``: an uninterrupted run of ``DRILL_STEPS``, a run
    with checkpoints every ``DRILL_CKPT_EVERY`` steps that fails at step
    ``DRILL_FAIL_AT``, and the restart, which must resume at the last
    checkpoint and end within rtol 1e-5 / atol 1e-6 of the uninterrupted
    run's params (whether they are bit-equal is printed); the loss must
    fall to ``DRILL_LOSS_RATIO`` of its first step; the trained model's
    eval loss under fp, W4A8 g128 IS and FS is printed (not a gate)."""
    import shutil

    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.configs.paper_llama import bench_lm
    from repro_torch.core import ptq
    from repro_torch.core.recipe import DEFAULT_RECIPE, FLOAT_SCALE_RECIPE
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.kernels import _build
    from repro_torch.launch import train as launch_train
    from repro_torch.models.registry import get_arch, get_model
    from repro_torch.nn import spec as S
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as T

    t_phase = time.perf_counter()
    stats: dict = {}

    # -- (a) llama3.2-3b at full width and depth ------------------------------
    cfg = get_arch(TRAIN_ARCH)
    if not cfg.remat or cfg.dtype != "bfloat16":
        raise AssertionError(f"{cfg.name}: expected bf16 with remat")
    api = get_model(cfg)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                    batch_size=TRAIN_B)
    params, opt, hist, timed, data_s, wall, peak = timed_train_loop(
        cfg, dc, TRAIN_STEPS)
    L = cfg.num_layers
    check_xattn_launches(f"train {cfg.name}", _build.LAUNCHES,
                         {"flash_attention": 2 * L,
                          "flash_attention_bwd": L}, TRAIN_STEPS)
    for k, n in _build.LAUNCHES.items():
        launches_total[k] += n
    step_ms = [ev[0].elapsed_time(ev[1]) for ev, _ in timed]
    gnorms = [float(m["grad_norm"]) for _, m in timed]
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"train {cfg.name}: losses {losses}, grad "
                             f"norms {gnorms}")
    steady = sum(step_ms[1:]) / len(step_ms[1:])
    resident = sum(t.numel() * t.element_size()
                   for t in S.leaves(params) + S.leaves(opt))
    tokens = TRAIN_B * TRAIN_S
    # the loop's own rate after its first step: host clock, the batch's
    # sampling included (the heartbeat's dt)
    loop_tps = tokens * (len(hist) - 1) / sum(h["dt"] for h in hist[1:])
    a = dict(layers=L, step_ms=step_ms, first_step_ms=step_ms[0],
             steady_step_ms=steady, tokens_per_s=tokens / (steady / 1e3),
             loop_tokens_per_s=loop_tps,
             data_s=data_s, peak_bytes=peak, resident_bytes=resident,
             losses=losses, grad_norms=gnorms, wall_s=wall,
             launches=dict(_build.LAUNCHES))
    log(f"[train] {cfg.name}: {L} layers at full width, bf16, remat, "
        f"{TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_S} tokens: step ms "
        f"(CUDA events) first {step_ms[0]:.1f}, then "
        + ", ".join(f"{x:.1f}" for x in step_ms[1:])
        + f" (mean {steady:.1f}); {a['tokens_per_s']:.0f} tokens/s of the "
        f"device's steps, {loop_tps:.0f} tokens/s of the loop; host "
        f"batch s " + ", ".join(f"{x:.3f}" for x in data_s)
        + f"; peak allocated {peak / 1e9:.2f} GB, params + AdamW state "
        f"{resident / 1e9:.2f} GB; losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
        + ", ".join(f"{x:.4f}" for x in gnorms)
        + f"; launches {json.dumps(a['launches'])}; {smi}")

    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             SyntheticPipeline(dc).global_batch(TRAIN_STEPS).items()}
    still = O.AdamWConfig(lr=0.0)  # both steps read the same params
    accum = {}
    for ga in (1, 2):
        # the metrics only: a name bound to the returned state would keep
        # it alive past the ``del`` below
        m = T.make_train_step(api, cfg, still, grad_accum=ga)(
            params, opt, batch)[2]
        accum[ga] = (float(m["loss"]), float(m["grad_norm"]))
    dl = abs(accum[2][0] - accum[1][0]) / abs(accum[1][0])
    dn = abs(accum[2][1] - accum[1][1]) / abs(accum[1][1])
    log(f"[train] grad_accum 2 vs 1 on one batch: loss {accum[2][0]:.6f} vs "
        f"{accum[1][0]:.6f} ({dl:.2e} relative, bound "
        f"{TRAIN_ACCUM_LOSS_REL}), grad norm {accum[2][1]:.6f} vs "
        f"{accum[1][1]:.6f} ({dn:.2e}, bound {TRAIN_ACCUM_NORM_REL})")
    if not (dl <= TRAIN_ACCUM_LOSS_REL and dn <= TRAIN_ACCUM_NORM_REL):
        raise AssertionError(f"train grad_accum: {accum}")
    a.update(accum_loss=accum, accum_loss_rel=dl, accum_norm_rel=dn)

    step = T.make_train_step(api, cfg, still)
    step(params, opt, batch)  # builds the model
    prof = profile_train_step(step, params, opt, batch, cfg.vocab_size)
    sp, dev = prof["split"], prof["device_ms"]
    log(f"[profile] train {cfg.name}: one step {dev:.1f} ms of device "
        f"kernels in {prof['launches']} launches: "
        + "; ".join(f"{k} {v:.1f} ms ({v / dev:.3f})" for k, v in sp.items())
        + f"; top {len(prof['top'])}:")
    for p in prof["top"]:
        log(f"[profile]   {p['ms']:.3f} ms  x{p['count']}  {p['name']}")
    a["profile"] = prof
    stats[cfg.name] = a
    del params, opt, batch, step
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) the first layers at full width against the CPU -------------------
    cfg2 = dataclasses.replace(cfg, num_layers=TRAIN_CPU_LAYERS)
    api2 = get_model(cfg2)
    p_card = ptq.materialize_by_layer(api2, cfg2, seed=0, device="cuda")
    stats["cpu_check"] = dict(layers=TRAIN_CPU_LAYERS, **card_vs_cpu(
        f"[train] {cfg.name} first {TRAIN_CPU_LAYERS} layers at full width",
        api2, cfg2, p_card, SyntheticPipeline(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=TRAIN_CPU_S,
            batch_size=TRAIN_CPU_B)).global_batch(0),
        {"flash_attention": 2 * TRAIN_CPU_LAYERS,  # remat recomputes
         "flash_attention_bwd": TRAIN_CPU_LAYERS}))
    del p_card
    gc.collect()
    torch.cuda.empty_cache()

    # -- (c) the restart drill on bench-lm-30m --------------------------------
    bcfg = bench_lm()
    bapi = get_model(bcfg)
    bdc = DataConfig(vocab_size=bcfg.vocab_size, seq_len=128, batch_size=8)
    boc = O.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=DRILL_STEPS)
    ck = ROOT / "build" / "train_drill"
    shutil.rmtree(ck, ignore_errors=True)
    _build.reset_launches()
    quiet = dict(log_every=10, log_fn=log, device="cuda")
    t0 = time.perf_counter()
    p_ref, _, h_ref = launch_train.train_loop(bcfg, bdc, boc,
                                              steps=DRILL_STEPS, **quiet)
    failed = False
    try:
        launch_train.train_loop(bcfg, bdc, boc, steps=DRILL_STEPS,
                                ckpt_dir=str(ck), ckpt_every=DRILL_CKPT_EVERY,
                                fail_at_step=DRILL_FAIL_AT, **quiet)
    except RuntimeError as e:  # the drill's injected failure, nothing else
        if "injected" not in str(e):
            raise
        failed = True
    if not failed:
        raise AssertionError("restart drill: no failure was injected")
    p_res, _, h_res = launch_train.train_loop(
        bcfg, bdc, boc, steps=DRILL_STEPS, ckpt_dir=str(ck),
        ckpt_every=DRILL_CKPT_EVERY, **quiet)
    torch.cuda.synchronize()
    drill_s = time.perf_counter() - t0
    resumed = DRILL_FAIL_AT // DRILL_CKPT_EVERY * DRILL_CKPT_EVERY
    ran = DRILL_STEPS + DRILL_FAIL_AT + (DRILL_STEPS - resumed)
    check_xattn_launches("train drill", _build.LAUNCHES,
                         {"flash_attention": bcfg.num_layers,
                          "flash_attention_bwd": bcfg.num_layers}, ran)
    for k, n in _build.LAUNCHES.items():
        launches_total[k] += n
    shutil.rmtree(ck, ignore_errors=True)
    if h_res[0]["step"] != resumed:
        raise AssertionError(f"restart drill resumed at {h_res[0]['step']}, "
                             f"not {resumed}")
    pairs = list(zip(S.leaves(p_ref), S.leaves(p_res)))
    bit_equal = all(torch.equal(x, y) for x, y in pairs)
    close = all(torch.allclose(y, x, rtol=1e-5, atol=1e-6) for x, y in pairs)
    worst_drill = max((x - y).abs().max().item() for x, y in pairs)
    ratio = h_ref[-1]["loss"] / h_ref[0]["loss"]
    log(f"[train] restart drill {bcfg.name} (f32, {DRILL_STEPS} steps of 8 x "
        f"128 tokens): failed at step {DRILL_FAIL_AT}, resumed at {resumed}; "
        f"final params bit-equal {bit_equal}, max abs diff "
        f"{worst_drill:.3e} (gate rtol 1e-5 / atol 1e-6); loss "
        f"{h_ref[0]['loss']:.4f} -> {h_ref[-1]['loss']:.4f} (ratio "
        f"{ratio:.3f}, gate {DRILL_LOSS_RATIO}); {drill_s:.1f} s for "
        f"{ran} steps")
    if not close or ratio > DRILL_LOSS_RATIO:
        raise AssertionError(f"restart drill: close {close}, loss ratio "
                             f"{ratio}")
    evals = [SyntheticPipeline(bdc).global_batch(100_000 + i)
             for i in range(4)]
    ev = {}
    for name, recipe in (("fp", None), ("w4a8-is", DEFAULT_RECIPE),
                         ("w4a8-fs", FLOAT_SCALE_RECIPE)):
        with obs.use_registry(obs.Registry()):
            qp = p_ref if recipe is None else ptq.post_training_quantize(
                bapi, bcfg, p_ref, recipe, None)
        step = T.make_eval_step(bapi, bcfg, recipe)
        ev[name] = float(np.mean([float(step(qp, {
            k: torch.from_numpy(v).to("cuda") for k, v in b.items()})["loss"])
            for b in evals]))
    log(f"[train] {bcfg.name} eval loss on 4 held-out batches: "
        + ", ".join(f"{k} {v:.4f}" for k, v in ev.items())
        + " (information, not a gate)")
    stats["drill"] = dict(model=bcfg.name, steps=DRILL_STEPS,
                          fail_at=DRILL_FAIL_AT, resumed=resumed,
                          bit_equal=bit_equal, max_abs_diff=worst_drill,
                          loss_first=h_ref[0]["loss"],
                          loss_last=h_ref[-1]["loss"], loss_ratio=ratio,
                          seconds=drill_s, eval_loss=ev)
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"[train] phase {stats['seconds']:.1f} s; {smi}")
    return stats


def _routed(records, layers, steps, tokens, top_k):
    """Each MoE layer's dropped share (1 - routed / (tokens x top_k)) per
    step, from routing-sink records of a remat run: a step records its
    ``layers`` forwards in order, then the recomputes in the backward."""
    if len(records) != 2 * layers * steps:
        raise AssertionError(f"{len(records)} routing records, expected "
                             f"{2 * layers * steps}")
    return [[1.0 - float(records[s * 2 * layers + i]["counts"].sum())
             / (tokens * top_k) for i in range(layers)]
            for s in range(steps)]


def _grads_on(api, cfg, params, batch):
    """(loss, aux, gradient leaves, routed counts per MoE layer call) of
    one forward and backward, the leaves requiring grad only for it."""
    import torch
    from repro_torch.models import moe
    from repro_torch.nn import spec as S
    from repro_torch.training import train_step as T

    leaves = S.leaves(params)
    recs = moe.start_routing_trace()
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, parts = T.make_loss_fn(api, cfg)(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
        moe.stop_routing_trace(recs)
    return (loss.detach(), parts["aux"].detach(), grads,
            [r["counts"].cpu().numpy() for r in recs])


def card_vs_cpu(tag, api, cfg, params, batch, launches=None):
    """One forward and backward of ``params`` (on the card) and of a CPU
    copy on the same batch: a MoE model's routed counts compared first (a
    flip is printed, not failed), then the loss, the aux loss and every
    leaf's gradient held to ``TRAIN_CPU_*``; ``launches``, the kernels the
    card's run must launch. ``tag`` begins the line it logs; returns the
    row."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models import moe
    from repro_torch.nn import spec as S

    p_cpu = S.tree_map(lambda t: t.cpu(), params)
    _build.reset_launches()
    recs = moe.start_routing_trace()  # the card's capacities
    try:
        l_card, a_card, g_card, r_card = _grads_on(api, cfg, params, {
            k: torch.from_numpy(v).to("cuda") for k, v in batch.items()})
    finally:
        moe.stop_routing_trace(recs)
    torch.cuda.synchronize()
    if launches is not None:
        check_xattn_launches(f"{tag} card vs cpu", _build.LAUNCHES, launches)
    t0 = time.perf_counter()
    l_cpu, a_cpu, g_cpu, r_cpu = _grads_on(api, cfg, p_cpu, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    flips = [int((a != b).sum()) for a, b in zip(r_card, r_cpu,
                                                  strict=True)]
    B, Sq = batch["tokens"].shape
    dropped = [round(1.0 - float(r.sum()) / (B * Sq * cfg.top_k), 4)
               for r in r_card]
    loss_rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    aux_rel = abs(float(a_card) - float(a_cpu)) / max(abs(float(a_cpu)),
                                                      1e-30)
    grad_rel = {}
    for (path, _), gk, gp in zip(_paths(p_cpu), g_card, g_cpu, strict=True):
        gk, gp = gk.float().cpu(), gp.float()
        grad_rel[path] = ((gk - gp).norm() / gp.norm().clamp_min(1e-30)
                          ).item()
    worst = max(grad_rel, key=grad_rel.get)
    routing = (f"routed counts of {len(r_card)} MoE layer calls, experts "
               f"whose counts differ {flips} (a routing flip is printed, not "
               f"failed), dropped share {dropped} (capacity "
               f"{[r['capacity'] for r in recs]}); " if r_card else "")
    log(f"{tag}, {cfg.dtype}, card vs CPU plain versions on {B} x {Sq} "
        f"tokens: {routing}"
        f"loss {float(l_card):.6f} vs {float(l_cpu):.6f} ({loss_rel:.2e} "
        f"relative, bound {TRAIN_CPU_LOSS_REL}); aux {float(a_card):.6e} vs "
        f"{float(a_cpu):.6e} ({aux_rel:.2e}); worst leaf |dg|/|g| "
        f"{grad_rel[worst]:.2e} ({worst}; bound {TRAIN_CPU_GRAD_REL}); CPU "
        f"{cpu_s:.1f} s")
    if not (loss_rel <= TRAIN_CPU_LOSS_REL and aux_rel <= TRAIN_CPU_LOSS_REL
            and grad_rel[worst] <= TRAIN_CPU_GRAD_REL
            and all(np.isfinite(float(x)) for x in (l_card, a_card))):
        raise AssertionError(f"{tag} card vs cpu: loss {loss_rel}, aux "
                             f"{aux_rel}, grads {grad_rel}")
    return dict(flips=flips, dropped=dropped, loss_rel=loss_rel,
                aux_rel=aux_rel,
                worst_grad_rel=grad_rel[worst], worst_leaf=worst,
                cpu_s=cpu_s)


def repeats_bits(api, cfg, params, batch) -> dict:
    """Two forwards and backwards of the same params on the same batch
    (numpy arrays, or tensors where a bf16 memory needs them) on the
    card: whether the loss and every gradient repeat bit for bit."""
    import torch

    b = {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
             ).to("cuda") for k, v in batch.items()}
    first = _grads_on(api, cfg, params, b)
    second = _grads_on(api, cfg, params, b)
    differ = sum(not torch.equal(x, y) for x, y in zip(first[2], second[2],
                                                        strict=True))
    return dict(loss_equal=bool(torch.equal(first[0], second[0])),
                leaves=len(first[2]), leaves_differ=differ)


def train_run(tag, cfg, B, Sq, steps, launches, launches_total, smi,
              loop=None):
    """``cfg`` trained through ``loop`` (:func:`timed_train_loop` by
    default; it takes the config, the data config and the steps and
    returns what that does), its checks and its row: launches exactly
    ``launches`` a step, finite metrics, a MoE layer's aux > 0 and dropped
    share (routing sinks). ``tag`` begins its lines; returns (the row,
    params, opt, the data config)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import _build
    from repro_torch.models import moe
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.nn import spec as S

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=Sq, batch_size=B)
    recs = moe.start_routing_trace()
    try:
        params, opt, hist, timed, data_s, wall, peak = (
            loop or timed_train_loop)(cfg, dc, steps)
    finally:
        moe.stop_routing_trace(recs)
    L = cfg.num_layers
    check_xattn_launches(f"{tag} {cfg.name}", _build.LAUNCHES,
                         launches, steps)
    for k, n in _build.LAUNCHES.items():
        launches_total[k] += n
    step_ms = [ev[0].elapsed_time(ev[1]) for ev, _ in timed]
    mets = {k: [float(m[k]) for _, m in timed]
            for k in ("loss", "ce", "aux", "grad_norm")}
    if not all(math.isfinite(x) for v in mets.values() for x in v):
        raise AssertionError(f"{tag} {cfg.name}: {mets}")
    n_moe = sum(k == "moe" for k in layer_kinds(cfg))
    dropped = (_routed(recs, n_moe, steps, B * Sq, cfg.top_k)
               if n_moe else [])
    if n_moe and not min(mets["aux"]) > 0:
        raise AssertionError(f"{tag} {cfg.name}: aux {mets['aux']}")
    steady = sum(step_ms[1:]) / len(step_ms[1:])
    resident = sum(t.numel() * t.element_size()
                   for t in S.leaves(params) + S.leaves(opt))
    row = dict(layers=L, step_ms=step_ms, steady_step_ms=steady,
               tokens_per_s=B * Sq / (steady / 1e3), data_s=data_s,
               peak_bytes=peak, resident_bytes=resident, wall_s=wall,
               dropped=dropped, launches=dict(_build.LAUNCHES), **mets)
    depth = (f"{cfg.num_encoder_layers} + {L}" if cfg.is_encoder_decoder
             else str(L))
    log(f"[{tag}] {cfg.name}: {depth} layers at full width, "
        f"{cfg.dtype}, remat, {steps} steps of {B} x {Sq} tokens: step "
        f"ms (CUDA events) first {step_ms[0]:.1f}, then "
        + ", ".join(f"{x:.1f}" for x in step_ms[1:])
        + f" (mean {steady:.1f}); {row['tokens_per_s']:.0f} tokens/s of "
        f"the device's steps; host batch s "
        + ", ".join(f"{x:.3f}" for x in data_s)
        + f"; peak allocated {peak / 1e9:.2f} GB, params + AdamW state "
        f"{resident / 1e9:.2f} GB; "
        + "; ".join(f"{k} " + ", ".join(f"{x:.4f}" for x in v)
                    for k, v in mets.items())
        + (f"; dropped share per MoE layer and step "
           f"{json.dumps([[round(x, 4) for x in d] for d in dropped])}"
           if dropped else "")
        + f"; launches {json.dumps(row['launches'])}; {smi}")
    return row, params, opt, dc


def train_moe_phase(launches_total, smi):
    """Phase 8h, ``[train-moe]``: (a) ``TRAIN_MOE_ARCH`` (Mixtral-8x7B:
    d_model 4096, 32 query heads over 8 of 128, 8 experts top-2 of d_ff
    14336, vocab 32000, capacity factor 1.25, so tokens are dropped) at
    full width, cut to ``TRAIN_MOE_LAYERS`` layers, bf16, remat on, the
    reference's AdamW defaults, ``TRAIN_MOE_STEPS`` steps of
    ``TRAIN_MOE_B`` x ``TRAIN_MOE_S`` tokens through
    ``launch.train.train_loop`` (:func:`timed_train_loop`): step ms,
    tokens/s, peak, loss, ce, aux, grad norm (finite, aux > 0), each MoE
    layer's dropped share (routing sinks), launches exactly 2 flash
    forwards and 1 backward a layer and step; one step with
    ``moe_int8_dispatch`` against one without on one batch at lr 0
    (finite; the differences printed); whether two equal forwards and
    backwards repeat bit for bit; one step profiled (expert GEMMs,
    dispatch and combine, router, flash forward and backward, AdamW, the
    rest). (b) Its first layer at full width in f32 against the CPU
    (:func:`card_vs_cpu`: routed counts first, then the loss, aux and
    every gradient), on a synthetic batch and on one with its first half
    one token repeated (those route to the same two experts: tokens
    dropped). (c) ``TRAIN_MLA_ARCH`` (MiniCPM3-4B: MLA, dense) at
    full width cut to ``TRAIN_MLA_LAYERS`` layers, bf16, remat, the same
    loop (no flash: MLA's prefill is plain PyTorch), then its first layer
    in f32 against the CPU. (d) ``TRAIN_SMOKE_ARCH``'s smoke config (a
    dense layer, then MoE with shared experts over MLA) in f32 at top-2
    and top-6 against the CPU, and whether each repeats bit for bit."""
    import torch
    from repro_torch.core import ptq
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.kernels import _build
    from repro_torch.models.registry import get_arch, get_model
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as T

    t_phase = time.perf_counter()
    built = set(_build.BUILD_LOG)
    stats: dict = {}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def cpu_batch(cfg, B, Sq):
        return SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=Sq, batch_size=B)
                                 ).global_batch(0)

    # -- (a) Mixtral-8x7B at full width ---------------------------------------
    full = get_arch(TRAIN_MOE_ARCH)
    cfg = dataclasses.replace(full, num_layers=TRAIN_MOE_LAYERS)
    if not cfg.remat or cfg.dtype != "bfloat16" or cfg.capacity_factor > 1.25:
        raise AssertionError(f"{cfg.name}: expected bf16, remat, capacity "
                             "factor 1.25")
    api = get_model(cfg)
    L = cfg.num_layers
    log(f"[train-moe] {cfg.name}: {L} of {full.num_layers} layers (depth "
        f"cut), d_model {cfg.d_model}, {cfg.num_heads} query heads over "
        f"{cfg.num_kv_heads} of {cfg.head_dim}, {cfg.num_experts} experts "
        f"top-{cfg.top_k} of d_ff {cfg.moe_d_ff}, vocab {cfg.vocab_size}, "
        f"capacity factor {cfg.capacity_factor}")
    row, params, opt, dc = train_run(
        "train-moe", cfg, TRAIN_MOE_B, TRAIN_MOE_S, TRAIN_MOE_STEPS,
        {"flash_attention": 2 * L, "flash_attention_bwd": L},
        launches_total, smi)
    batch = SyntheticPipeline(dc).global_batch(TRAIN_MOE_STEPS)
    tb = {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}
    still = O.AdamWConfig(lr=0.0)  # both steps read the same params
    int8 = {}
    for flag in (False, True):
        c = dataclasses.replace(cfg, moe_int8_dispatch=flag)
        _build.reset_launches()
        m = T.make_train_step(get_model(c), c, still)(params, opt, tb)[2]
        torch.cuda.synchronize()
        check_xattn_launches(f"train-moe int8 {flag}", _build.LAUNCHES,
                             {"flash_attention": 2 * L,
                              "flash_attention_bwd": L})
        for k, n in _build.LAUNCHES.items():
            launches_total[k] += n
        int8[flag] = {k: float(v) for k, v in m.items()}
    if not all(math.isfinite(v) for m in int8.values() for v in m.values()):
        raise AssertionError(f"train-moe int8 dispatch: {int8}")
    dl = int8[True]["loss"] - int8[False]["loss"]
    dn = int8[True]["grad_norm"] - int8[False]["grad_norm"]
    log(f"[train-moe] moe_int8_dispatch on one batch at lr 0: loss "
        f"{int8[True]['loss']:.6f} vs {int8[False]['loss']:.6f} ({dl:+.3e}), "
        f"grad norm {int8[True]['grad_norm']:.6f} vs "
        f"{int8[False]['grad_norm']:.6f} ({dn:+.3e}) (information: finite "
        "and the launch counts are the gates)")
    row["int8_dispatch"] = dict(on=int8[True], off=int8[False],
                                loss_diff=dl, grad_norm_diff=dn)
    row["repeat"] = repeats_bits(api, cfg, params, batch)
    log(f"[train-moe] {cfg.name}: two equal forwards and backwards on the "
        f"card: loss bit-equal {row['repeat']['loss_equal']}, gradient "
        f"leaves differing {row['repeat']['leaves_differ']} of "
        f"{row['repeat']['leaves']}")
    step = T.make_train_step(api, cfg, still)
    prof = profile_train_step(step, params, opt, tb, cfg.vocab_size,
                              experts=cfg.num_experts)
    sp, dev = prof["split"], prof["device_ms"]
    log(f"[profile] train-moe {cfg.name}: one step {dev:.1f} ms of device "
        f"kernels in {prof['launches']} launches: "
        + "; ".join(f"{k} {v:.1f} ms ({v / dev:.3f})" for k, v in sp.items())
        + f"; top {len(prof['top'])}:")
    for p in prof["top"]:
        log(f"[profile]   {p['ms']:.3f} ms  x{p['count']}  {p['name']}")
    row["profile"] = prof
    stats[cfg.name] = row
    del params, opt, tb, step
    free()

    # -- (b) its first layer at full width, f32, against the CPU --------------
    c1 = dataclasses.replace(cfg, num_layers=1, dtype="float32", remat=False)
    a1 = get_model(c1)
    p1 = ptq.materialize_by_layer(a1, c1, seed=0, device="cuda")
    b1 = cpu_batch(c1, TRAIN_MOE_CPU_B, TRAIN_MOE_CPU_S)
    flash1 = {"flash_attention": 1, "flash_attention_bwd": 1}
    stats["mixtral_cpu_check"] = card_vs_cpu(
        f"[train-moe] {c1.name} first layer", a1, c1, p1, b1, flash1)
    # the first half of the positions one token repeated: their hidden
    # states are alike, so they route to the same two experts, past their
    # capacity. (All of it repeated would make every value row alike, and
    # the gradient of q and k zero up to rounding on both devices.)
    half = {k: v.copy() for k, v in b1.items()}
    half["tokens"][:, :TRAIN_MOE_CPU_S // 2] = b1["tokens"][0, 0]
    stats["mixtral_cpu_check_dropped"] = card_vs_cpu(
        f"[train-moe] {c1.name} first layer, one token repeated over the "
        "first half", a1, c1, p1, half, flash1)
    if not min(stats["mixtral_cpu_check_dropped"]["dropped"]) > 0:
        raise AssertionError("train-moe: the repeated token dropped none")
    del p1
    free()

    # -- (c) MiniCPM3-4B (MLA, dense) at full width ---------------------------
    mfull = get_arch(TRAIN_MLA_ARCH)
    mcfg = dataclasses.replace(mfull, num_layers=TRAIN_MLA_LAYERS)
    log(f"[train-moe] {mcfg.name}: {TRAIN_MLA_LAYERS} of {mfull.num_layers} "
        f"layers (depth cut), d_model {mcfg.d_model}, {mcfg.num_heads} "
        f"heads, kv_lora_rank {mcfg.kv_lora_rank}, q_lora_rank "
        f"{mcfg.q_lora_rank}, d_ff {mcfg.d_ff}, vocab {mcfg.vocab_size}")
    mrow, mp, mo, _ = train_run("train-moe", mcfg, TRAIN_MLA_B, TRAIN_MLA_S,
                                TRAIN_MLA_STEPS, {}, launches_total, smi)
    stats[mcfg.name] = mrow
    del mp, mo
    free()
    m1 = dataclasses.replace(mcfg, num_layers=1, dtype="float32", remat=False)
    ma1 = get_model(m1)
    mp1 = ptq.materialize_by_layer(ma1, m1, seed=0, device="cuda")
    stats["minicpm3_cpu_check"] = card_vs_cpu(
        f"[train-moe] {m1.name} first layer", ma1, m1, mp1,
        cpu_batch(m1, TRAIN_MOE_CPU_B, TRAIN_MOE_CPU_S), {})
    del mp1
    free()

    # -- (d) DeepSeek-V2's smoke layout, top-2 and top-6 ----------------------
    for top_k in (2, 6):
        sc = dataclasses.replace(get_arch(TRAIN_SMOKE_ARCH, smoke=True),
                                 dtype="float32", top_k=top_k)
        sa = get_model(sc)
        sparams = ptq.materialize_by_layer(sa, sc, seed=0, device="cuda")
        sb = cpu_batch(sc, TRAIN_SMOKE_B, TRAIN_SMOKE_S)
        r = card_vs_cpu(f"[train-moe] {sc.name} top-{top_k}", sa, sc,
                        sparams, sb, {})
        r["repeat"] = repeats_bits(sa, sc, sparams, sb)
        log(f"[train-moe] {sc.name} top-{top_k}: two equal forwards and "
            f"backwards on the card: loss bit-equal "
            f"{r['repeat']['loss_equal']}, gradient leaves differing "
            f"{r['repeat']['leaves_differ']} of {r['repeat']['leaves']}")
        stats[f"{sc.name}-top{top_k}"] = r
        del sparams
    free()
    new = {k: ptxas_report(v) for k, v in _build.BUILD_LOG.items()
           if k not in built}
    for name, fns in new.items():
        for fn, info in fns.items():
            log(f"[train-moe] built anew: {name}: {fn}: {info}")
    stats["built_anew"] = sorted(new)
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"[train-moe] phase {stats['seconds']:.1f} s, kernels built anew "
        f"{sorted(new) or 'none'}; {smi}")
    return stats


def train_rec_phase(launches_total, smi):
    """Phase 8i, ``[train-rec]``: (a) ``TRAIN_RG_ARCH`` (RecurrentGemma-9B:
    d_model 4096, RG-LRU and local attention 2:1, 16 query heads over one
    KV head of 256, window 2048, d_ff 12288, vocab 256000) at full width
    cut to ``TRAIN_RG_LAYERS`` layers, bf16, remat, the reference's AdamW
    defaults, ``TRAIN_RG_STEPS`` steps of ``TRAIN_RG_B`` x ``TRAIN_RG_S``
    tokens through ``launch.train.train_loop`` (:func:`train_run`): step
    ms, tokens/s, peak and resident memory, finite metrics, launches
    exactly 2 flash forwards (the forward and remat's recompute) and 1
    backward a local-attention layer and step (the backward at head dim
    256); whether two equal forwards and backwards repeat bit for bit; one
    step profiled (flash forward and backward, the f32 logit head, AdamW,
    the rest; the RG-LRU's forward and recompute apart). (b) Its first
    ``TRAIN_RG_CPU_LAYERS`` layers (2 RG-LRU, 1 local attention) in f32
    against the CPU (:func:`card_vs_cpu`: the f32 backward kernel at head
    dim 256). (c) ``TRAIN_XLSTM_ARCH`` (xLSTM-1.3B: d_model 2048, 4
    heads, vocab 50304; no attention, so no hand-written kernel) at full
    width cut to ``TRAIN_XLSTM_LAYERS`` layers, the same loop for
    ``TRAIN_XLSTM_STEPS`` steps under its per-token mLSTM scan, then one
    step chunkwise (ms, peak); the scan step's device launches (host
    time: about a thousand a token) from two shorter profiled steps; its
    first
    ``TRAIN_XLSTM_CPU_LAYERS`` layers in f32 against the CPU."""
    import torch
    from repro_torch.core import ptq
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.kernels import _build
    from repro_torch.models import griffin
    from repro_torch.models.registry import get_arch, get_model
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as T

    t_phase = time.perf_counter()
    built = set(_build.BUILD_LOG)
    stats: dict = {}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def cpu_batch(cfg, B, Sq):
        return SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=Sq, batch_size=B)
                                 ).global_batch(0)

    marks: dict[str, float] = {}

    def mark(part):  # the phase's wall seconds at the end of each part
        marks[part] = time.perf_counter() - t_phase

    def log_profile(name, prof):
        sp, dev = prof["split"], prof["device_ms"]
        log(f"[profile] train-rec {name}: one step {dev:.1f} ms of device "
            f"kernels in {prof['launches']} launches: "
            + "; ".join(f"{k} {v:.1f} ms ({v / dev:.3f})"
                        for k, v in sp.items())
            + "".join(f"; {k} (forward and recompute, apart) {v:.1f} ms "
                      f"({v / dev:.3f})" for k, v in prof["ranges"].items())
            + f"; top {len(prof['top'])}:")
        for p in prof["top"]:
            log(f"[profile]   {p['ms']:.3f} ms  x{p['count']}  {p['name']}")

    # -- (a) RecurrentGemma-9B at full width ----------------------------------
    full = get_arch(TRAIN_RG_ARCH)
    cfg = dataclasses.replace(full, num_layers=TRAIN_RG_LAYERS)
    if not cfg.remat or cfg.dtype != "bfloat16":
        raise AssertionError(f"{cfg.name}: expected bf16, remat")
    api = get_model(cfg)
    kinds = griffin.layer_kinds(cfg)
    n_attn = kinds.count("attn")
    log(f"[train-rec] {cfg.name}: {cfg.num_layers} of {full.num_layers} "
        f"layers (depth cut; the reference's layout {griffin.split(cfg)}: "
        f"{', '.join(kinds)}), d_model {cfg.d_model}, {cfg.num_heads} query "
        f"heads over {cfg.num_kv_heads} of {cfg.head_dim}, window "
        f"{cfg.window}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}")
    row, params, opt, dc = train_run(
        "train-rec", cfg, TRAIN_RG_B, TRAIN_RG_S, TRAIN_RG_STEPS,
        {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn},
        launches_total, smi)
    mark("recurrentgemma loop")
    batch = SyntheticPipeline(dc).global_batch(TRAIN_RG_STEPS)
    tb = {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}
    row["repeat"] = repeats_bits(api, cfg, params, batch)
    log(f"[train-rec] {cfg.name}: two equal forwards and backwards on the "
        f"card: loss bit-equal {row['repeat']['loss_equal']}, gradient "
        f"leaves differing {row['repeat']['leaves_differ']} of "
        f"{row['repeat']['leaves']}")
    if not (row["repeat"]["loss_equal"]
            and row["repeat"]["leaves_differ"] == 0):
        raise AssertionError(f"train-rec {cfg.name}: {row['repeat']}")
    mark("recurrentgemma repeat")
    step = T.make_train_step(api, cfg, O.AdamWConfig(lr=0.0))
    prof = profile_train_step(step, params, opt, tb, cfg.vocab_size,
                              ranges=[(griffin, "_rglru")])
    log_profile(cfg.name, prof)
    mark("recurrentgemma profile")
    row["profile"] = prof
    stats[cfg.name] = row
    del params, opt, tb, step
    free()

    # -- (b) its first layers at full width, f32, against the CPU -------------
    c3 = dataclasses.replace(cfg, num_layers=TRAIN_RG_CPU_LAYERS,
                             dtype="float32", remat=False)
    a3 = get_model(c3)
    p3 = ptq.materialize_by_layer(a3, c3, seed=0, device="cuda")
    n3 = griffin.layer_kinds(c3).count("attn")
    stats["recurrentgemma_cpu_check"] = card_vs_cpu(
        f"[train-rec] {c3.name} first {c3.num_layers} layers "
        f"({', '.join(griffin.layer_kinds(c3))})", a3, c3, p3,
        cpu_batch(c3, TRAIN_MOE_CPU_B, TRAIN_MOE_CPU_S),
        {"flash_attention": n3, "flash_attention_bwd": n3})
    del p3
    free()
    mark("recurrentgemma cpu check")

    # -- (c) xLSTM-1.3B at full width ------------------------------------------
    xfull = get_arch(TRAIN_XLSTM_ARCH)
    xcfg = dataclasses.replace(xfull, num_layers=TRAIN_XLSTM_LAYERS)
    if xcfg.mlstm_impl != "scan" or not xcfg.remat:
        raise AssertionError(f"{xcfg.name}: expected the scan, remat")
    log(f"[train-rec] {xcfg.name}: {xcfg.num_layers} of {xfull.num_layers} "
        f"layers (depth cut: one period, {xcfg.slstm_every - 1} mLSTM and 1 "
        f"sLSTM), d_model {xcfg.d_model}, {xcfg.num_heads} heads, vocab "
        f"{xcfg.vocab_size}")
    xrow, xp, xo, xdc = train_run(
        "train-rec", xcfg, TRAIN_XLSTM_B, TRAIN_XLSTM_S, TRAIN_XLSTM_STEPS,
        {}, launches_total, smi)
    mark("xlstm loop")
    xb = {k: torch.from_numpy(v).to("cuda") for k, v in
          SyntheticPipeline(xdc).global_batch(TRAIN_XLSTM_STEPS).items()}
    # the scan's launches, from profiled steps at TRAIN_XLSTM_COUNT_S
    # tokens (the profiler takes about 0.25 ms of host time a launch, so
    # a profiled 2 x 256 step takes over a minute): the count is
    # fixed + per token x tokens, exactly
    xstep = T.make_train_step(get_model(xcfg), xcfg, O.AdamWConfig(lr=0.0))
    counts = {}
    for s_ in TRAIN_XLSTM_COUNT_S:
        b_ = {k: v[:, :s_] for k, v in xb.items()}
        _, counts[s_], _ = device_launches(lambda: xstep(xp, xo, b_))
    (s1, n1), (s2, n2) = sorted(counts.items())
    per_token = (n2 - n1) / (s2 - s1)
    n = n1 + per_token * (TRAIN_XLSTM_S - s1)
    xrow.update(launches_by_tokens=counts, launches_per_token=per_token,
                step_launches=n)
    log(f"[train-rec] {xcfg.name} scan: step {xrow['steady_step_ms']:.1f} "
        f"ms (CUDA events, mean after the first) for {n:.0f} device "
        f"launches a step ({per_token:.0f} a token: the per-token cell's "
        f"launches are host time; profiled steps of {TRAIN_XLSTM_B} x "
        + " and ".join(f"{k} tokens launched {v}" for k, v in counts.items())
        + ")")
    mark("xlstm launch count")
    ccfg = dataclasses.replace(xcfg, mlstm_impl="chunked")
    cstep = T.make_train_step(get_model(ccfg), ccfg, O.AdamWConfig())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    _, _, cm = cstep(xp, xo, xb)
    ev[1].record()
    torch.cuda.synchronize()
    chunk = dict(step_ms=ev[0].elapsed_time(ev[1]),
                 peak_bytes=torch.cuda.max_memory_allocated(),
                 **{k: float(v) for k, v in cm.items()})
    if not all(math.isfinite(v) for v in chunk.values()):
        raise AssertionError(f"train-rec {ccfg.name} chunked: {chunk}")
    log(f"[train-rec] {ccfg.name}: one step chunkwise (chunks of "
        f"{ccfg.chunk_size}) {chunk['step_ms']:.1f} ms (its first call, CUDA "
        f"events), peak allocated {chunk['peak_bytes'] / 1e9:.2f} GB; loss "
        f"{chunk['loss']:.4f}, grad norm {chunk['grad_norm']:.4f}; {smi}")
    xrow["chunked"] = chunk
    mark("xlstm chunked")
    stats[xcfg.name] = xrow
    del xp, xo, xb, xstep, cstep, cm
    free()
    x2 = dataclasses.replace(xcfg, num_layers=TRAIN_XLSTM_CPU_LAYERS,
                             dtype="float32", remat=False)
    xa2 = get_model(x2)
    xp2 = ptq.materialize_by_layer(xa2, x2, seed=0, device="cuda")
    stats["xlstm_cpu_check"] = card_vs_cpu(
        f"[train-rec] {x2.name} first {x2.num_layers} layers", xa2, x2, xp2,
        cpu_batch(x2, TRAIN_XLSTM_CPU_B, TRAIN_XLSTM_CPU_S), {})
    del xp2
    free()
    mark("xlstm cpu check")
    new = {k: ptxas_report(v) for k, v in _build.BUILD_LOG.items()
           if k not in built}
    for name, fns in new.items():
        for fn, info in fns.items():
            log(f"[train-rec] built anew: {name}: {fn}: {info}")
    stats["built_anew"] = sorted(new)
    stats["seconds"] = time.perf_counter() - t_phase
    stats["marks"] = marks
    log(f"[train-rec] phase {stats['seconds']:.1f} s (wall s at the end of "
        f"each part: " + ", ".join(f"{k} {v:.1f}" for k, v in marks.items())
        + f"), kernels built anew {sorted(new) or 'none'}; {smi}")
    return stats


def memory_batch(cfg, dc, step):
    """The pipeline's batch ``step`` (tokens, labels) on the card with the
    family's memory (``image_embeds`` or ``frames``, the shape and dtype
    ``configs.shapes.input_specs`` gives), drawn on the card from
    ``TRAIN_MEMORY_SEED + step``, normal x ``TRAIN_MEMORY_SCALE``."""
    import torch
    from repro_torch.configs import shapes
    from repro_torch.data.pipeline import SyntheticPipeline

    b = {k: torch.from_numpy(v).to("cuda") for k, v in
         SyntheticPipeline(dc).global_batch(step).items()}
    spec = shapes.input_specs(cfg, shapes.Shape(
        "train", "train", dc.seq_len, dc.batch_size))
    key = "image_embeds" if "image_embeds" in spec else "frames"
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_MEMORY_SEED + step)
    b[key] = (torch.randn(spec[key].shape, generator=gen, device="cuda")
              * TRAIN_MEMORY_SCALE).to(spec[key].dtype)
    if shapes.memory_arg(cfg, b) is not b[key]:
        raise AssertionError(f"{cfg.name}: memory_arg picked another entry")
    return b


def xattn_train_launches(cfg, remat: bool) -> dict[str, int]:
    """Flash forward and backward launches of one forward and backward:
    one of each an attention (the VLM: a self and a cross layer one each;
    Whisper: an encoder layer one, a decoder layer two, causal self and
    cross); remat runs each rematted block's forward again in the
    backward (the reference's: the VLM's every block, Whisper's decoder
    blocks; its encoder's once)."""
    from repro_torch.models.transformer import layer_kinds

    if cfg.family == "vlm":
        n = len(layer_kinds(cfg))
        return {"flash_attention": (2 if remat else 1) * n,
                "flash_attention_bwd": n}
    ne, nd = cfg.num_encoder_layers, cfg.num_layers
    return {"flash_attention": ne + (4 if remat else 2) * nd,
            "flash_attention_bwd": ne + 2 * nd}


def memory_loop(api, params):
    """A loop for :func:`train_run` over the given ``params`` (on the card):
    ``make_train_step`` with the reference's ``AdamWConfig`` defaults from
    a zero state, each step's batch from :func:`memory_batch` (its host
    time apart) and the step between CUDA events, launch counts reset just
    before, as :func:`timed_train_loop` (no history: ``launch.train``
    feeds no memory, as the reference's loop does not)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.nn import spec as S
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as T

    def run(cfg, dc, steps):
        p = params
        opt = S.materialize(O.state_specs(api.param_specs(cfg)),
                            device="cuda")
        step = T.make_train_step(api, cfg, O.AdamWConfig())
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        timed, data_s = [], []
        t0 = time.perf_counter()
        for i in range(steps):
            t1 = time.perf_counter()
            b = memory_batch(cfg, dc, i)
            data_s.append(time.perf_counter() - t1)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            p, opt, m = step(p, opt, b)
            ev[1].record()
            timed.append((ev, m))
            del b
        torch.cuda.synchronize()
        return (p, opt, None, timed, data_s, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated())

    return run


def train_xattn_phase(launches_total, smi):
    """Phase 8j, ``[train-xattn]``: the cross-attention families trained
    through ``training.train_step.make_train_step``, each batch carrying
    its memory (``launch.train`` feeds none, as the reference's does not).
    (a) ``TRAIN_WHISPER_ARCH`` (Whisper-tiny: 4 encoder + 4 decoder
    layers, d_model 384, 6 heads of 64, vocab 51865) whole, bf16, remat,
    the reference's AdamW defaults, ``TRAIN_WHISPER_STEPS`` steps of
    ``TRAIN_WHISPER_B`` x ``TRAIN_WHISPER_S`` tokens over as many x 1500
    frames (:func:`train_run` over :func:`memory_loop`): step ms, tokens/s, peak and
    resident memory, finite metrics, flash launches exactly
    :func:`xattn_train_launches`'s (20 forwards, 12 backwards a step: the
    encoder's non-causal 1500 over 1500, the decoder's causal 448 and
    cross 448 over 1500); whether two equal forwards and backwards repeat
    bit for bit; one step profiled; then whole in f32 against the CPU
    (:func:`card_vs_cpu`). (b) ``TRAIN_VLM_ARCH`` (d_model 8192, 64 query
    heads over 8 of 128, d_ff 28672, vocab 128256, 1600 image tokens) at
    full width cut to one self and one cross layer, its gates drawn by
    :func:`set_cross_gates`, the same for ``TRAIN_VLM_STEPS`` steps of
    ``TRAIN_VLM_B`` x ``TRAIN_VLM_S`` tokens (4 forwards, 2 backwards a
    step: causal 1024 and the cross layer's 1024 over 1600, G = 8); both
    layers in f32 against the CPU on ``TRAIN_VLM_CPU_B`` x
    ``TRAIN_VLM_CPU_S`` tokens. The depth cut is reckoned from the spec
    trees' bytes and logged."""
    import torch
    from repro_torch.core import ptq
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import _build
    from repro_torch.models.registry import get_arch, get_model
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.nn import spec as S
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as T

    t_phase = time.perf_counter()
    built = set(_build.BUILD_LOG)
    stats: dict = {}
    marks: dict[str, float] = {}

    def mark(part):  # the phase's wall seconds at the end of each part
        marks[part] = time.perf_counter() - t_phase

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def log_profile(name, prof):
        sp, dev = prof["split"], prof["device_ms"]
        log(f"[profile] train-xattn {name}: one step {dev:.1f} ms of device "
            f"kernels in {prof['launches']} launches: "
            + "; ".join(f"{k} {v:.1f} ms ({v / dev:.3f})"
                        for k, v in sp.items()) + f"; top {len(prof['top'])}:")
        for p in prof["top"]:
            log(f"[profile]   {p['ms']:.3f} ms  x{p['count']}  {p['name']}")

    def trained(name, api, cfg, params, B, Sq, steps, cut):
        """The loop, the repeat and the profile of one model; frees its
        state. Returns its row."""
        row, params, opt, dc = train_run(
            "train-xattn", cfg, B, Sq, steps,
            xattn_train_launches(cfg, cfg.remat), launches_total, smi,
            loop=memory_loop(api, params))
        row["cut"] = cut
        mark(f"{name} loop")
        tb = memory_batch(cfg, dc, steps)
        row["repeat"] = repeats_bits(api, cfg, params, tb)
        log(f"[train-xattn] {cfg.name}: two equal forwards and backwards on "
            f"the card: loss bit-equal {row['repeat']['loss_equal']}, "
            f"gradient leaves differing {row['repeat']['leaves_differ']} of "
            f"{row['repeat']['leaves']}")
        if not (row["repeat"]["loss_equal"]
                and row["repeat"]["leaves_differ"] == 0):
            raise AssertionError(f"train-xattn {cfg.name}: {row['repeat']}")
        mark(f"{name} repeat")
        step = T.make_train_step(api, cfg, O.AdamWConfig(lr=0.0))
        row["profile"] = profile_train_step(step, params, opt, tb,
                                            cfg.vocab_size)
        log_profile(cfg.name, row["profile"])
        mark(f"{name} profile")
        del params, opt, tb, step
        free()
        return row

    # -- (a) Whisper-tiny whole ------------------------------------------------
    wcfg = get_arch(TRAIN_WHISPER_ARCH)
    if not wcfg.remat or wcfg.dtype != "bfloat16":
        raise AssertionError(f"{wcfg.name}: expected bf16, remat")
    wapi = get_model(wcfg)
    log(f"[train-xattn] {wcfg.name}: whole ({wcfg.num_encoder_layers} "
        f"encoder + {wcfg.num_layers} decoder layers), d_model "
        f"{wcfg.d_model}, {wcfg.num_heads} heads of {wcfg.head_dim}, d_ff "
        f"{wcfg.d_ff}, vocab {wcfg.vocab_size}, {wcfg.encoder_seq} frames; "
        f"params {S.param_bytes(wapi.param_specs(wcfg)) / 1e9:.3f} GB")
    wp = S.materialize(wapi.param_specs(wcfg),
                       torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    stats[wcfg.name] = trained(
        "whisper", wapi, wcfg, wp, TRAIN_WHISPER_B, TRAIN_WHISPER_S,
        TRAIN_WHISPER_STEPS, "none (whole)")
    del wp
    w32 = dataclasses.replace(wcfg, dtype="float32", remat=False)
    wa32 = get_model(w32)
    wp32 = S.materialize(wa32.param_specs(w32),
                         torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    wb = {k: v.cpu().numpy() for k, v in memory_batch(
        w32, DataConfig(vocab_size=w32.vocab_size, seq_len=TRAIN_WHISPER_S,
                        batch_size=TRAIN_WHISPER_CPU_B), 0).items()}
    stats["whisper_cpu_check"] = card_vs_cpu(
        f"[train-xattn] {w32.name} whole", wa32, w32, wp32, wb,
        xattn_train_launches(w32, False))
    del wp32
    free()
    mark("whisper cpu check")

    # -- (b) Llama-3.2-Vision-90B at full width, one self and one cross layer --
    full = get_arch(TRAIN_VLM_ARCH)
    cfg = dataclasses.replace(full, num_layers=TRAIN_VLM_LAYERS,
                              cross_attn_every=TRAIN_VLM_EVERY)
    if not cfg.remat or cfg.dtype != "bfloat16":
        raise AssertionError(f"{cfg.name}: expected bf16, remat")
    api = get_model(cfg)
    # params (bf16), AdamW's f32 mu and nu, the bf16 gradients: 12 bytes a
    # bf16 param, before activations and AdamW's per-leaf f32 temporaries
    five = dataclasses.replace(full, num_layers=full.cross_attn_every)

    def state_gb(c):
        return 6 * S.param_bytes(get_model(c).param_specs(c)) / 1e9

    cut = (f"depth: {cfg.num_layers} of {full.num_layers} layers "
           f"({', '.join(layer_kinds(cfg))}; cross_attn_every "
           f"{full.cross_attn_every} -> {cfg.cross_attn_every}): 5 layers, "
           f"the fewest holding a cross layer under the published pattern, "
           f"need {state_gb(five):.1f} GB of params, AdamW moments and "
           f"gradients, {cfg.num_layers} need {state_gb(cfg):.1f} GB")
    log(f"[train-xattn] {cfg.name}: {cut}; d_model {cfg.d_model}, "
        f"{cfg.num_heads} query heads over {cfg.num_kv_heads} of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.num_image_tokens} image tokens")
    params = ptq.materialize_by_layer(api, cfg, seed=0, device="cuda")
    gates = set_cross_gates(params)
    log(f"[train-xattn] {cfg.name}: cross gates drawn {gates}")
    stats[cfg.name] = trained("vlm", api, cfg, params, TRAIN_VLM_B,
                              TRAIN_VLM_S, TRAIN_VLM_STEPS, cut)
    stats[cfg.name]["gates"] = gates
    del params
    free()
    c32 = dataclasses.replace(cfg, dtype="float32", remat=False)
    a32 = get_model(c32)
    p32 = ptq.materialize_by_layer(a32, c32, seed=0, device="cuda")
    set_cross_gates(p32)
    vb = {k: v.cpu().numpy() for k, v in memory_batch(
        c32, DataConfig(vocab_size=c32.vocab_size, seq_len=TRAIN_VLM_CPU_S,
                        batch_size=TRAIN_VLM_CPU_B), 0).items()}
    stats["vlm_cpu_check"] = card_vs_cpu(
        f"[train-xattn] {c32.name} both layers ({', '.join(layer_kinds(c32))})",
        a32, c32, p32, vb, xattn_train_launches(c32, False))
    del p32, vb
    free()
    mark("vlm cpu check")
    new = {k: ptxas_report(v) for k, v in _build.BUILD_LOG.items()
           if k not in built}
    for name, fns in new.items():
        for fn, info in fns.items():
            log(f"[train-xattn] built anew: {name}: {fn}: {info}")
    stats["built_anew"] = sorted(new)
    stats["seconds"] = time.perf_counter() - t_phase
    stats["marks"] = marks
    log(f"[train-xattn] phase {stats['seconds']:.1f} s (wall s at the end of "
        f"each part: " + ", ".join(f"{k} {v:.1f}" for k, v in marks.items())
        + f"), kernels built anew {sorted(new) or 'none'}; {smi}")
    return stats


def _paths(tree, path=""):
    """(path, leaf) pairs in ``S.leaves`` order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on a GPU", file=sys.stderr)
        return 2
    from repro_torch.core.recipe import (DEFAULT_RECIPE, FLOAT_SCALE_RECIPE,
                                         W4A8_COARSE, WEIGHT_ONLY_RECIPE,
                                         QuantRecipe)
    from repro_torch import obs
    from repro_torch.core import ptq
    from repro_torch.kernels import _build
    from repro_torch.models.registry import get_arch, get_model
    from repro_torch.nn import spec as S
    from repro_torch.serving.engine import ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_times: dict[str, float] = {}

    def phase_done(name: str) -> None:
        """Log the wall seconds since the last phase ended."""
        now = time.perf_counter()
        phase_times[name] = now - t_start - sum(phase_times.values())
        log(f"[time] {name}: {phase_times[name]:.1f} s (run "
            f"{now - t_start:.1f} s)")

    # -- 1. the card -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} x{torch.cuda.device_count()}")

    phase_done("card")

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    times = _build.build(_build.KERNELS + _build.FIXTURES)
    log(f"[build] {len(times)} kernels in {time.perf_counter() - t0:.1f} s "
        + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    ptxas = {name: ptxas_report(text)
             for name, text in _build.BUILD_LOG.items()}
    for name, fns in ptxas.items():
        for fn, info in fns.items():
            log(f"[build] {name}: {fn}: {info}")

    phase_done("build")

    # -- 2b. qlint: certificates, lint at every level, the fixtures -----------
    qlint_rows, qlint_stats = check_qlint(smi)

    phase_done("qlint")

    # -- 3. kernels against their plain versions --------------------------------
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows: list[dict] = []
    errs = {"act_quant": check_act_quant(gen, rows),
            **check_gemms(gen, rows),
            "flash_attention": check_flash(gen, rows)}
    errs["w4a8_gemm_is"] = max(errs["w4a8_gemm_is"],
                               check_config_gemms(gen, rows),
                               check_config_gemms(gen, rows, MLA_GEMM_KN),
                               check_config_gemms(gen, rows, XATTN_GEMM_KN))
    errs["flash_attention"] = max(errs["flash_attention"],
                                  check_flash_cross(gen, rows))
    errs["w4a8_gemm_is"] = max(errs["w4a8_gemm_is"], check_config_gemms(
        gen, rows, RECURRENT_GEMM_KN))
    for k, v in check_xattn_rows(gen, rows).items():
        errs[k] = max(errs[k], v)
    for k, v in check_grouped(gen, rows).items():
        errs[k] = max(errs.get(k, 0.0), v)
    errs["flash_attention_bwd"] = check_flash_bwd(gen, rows)

    def opt(v):
        return "-" if v is None else f"{v:.4f} ms"

    for r in rows:
        extra = "" if "counts" not in r else (
            f" counts {r['counts']}; dense grouped {r['dense_ms']:.4f} ms, "
            f"plain {r['dense_plain_ms']:.4f} ms, bound "
            f"{r['dense_bound_ms']:.5f} ms ({r['dense_bound_by']})")
        if r.get("plan"):
            extra += f"; plan {r['plan']}"
        if r.get("sk"):
            extra += f"; Sk {r['sk']}"
        log(f"[kernel] {r['kernel']} {r['variant']} {r['shape']}: "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}), library "
            f"{opt(r['library_ms'])}, bf16 matmul {opt(r['bf16_matmul_ms'])}"
            f"{extra}")
    log(f"[kernel] max abs diff vs plain: {json.dumps(errs)}")

    phase_done("kernels")

    # -- 4. llama2-7b at full width under four recipes ---------------------------
    cfg = get_arch("llama2-7b")
    api = get_model(cfg)
    coarse = QuantRecipe(rules=(("*", W4A8_COARSE),), name="w4a8-coarse")
    recipes = {r.name: r for r in (DEFAULT_RECIPE, FLOAT_SCALE_RECIPE, coarse,
                                   WEIGHT_ONLY_RECIPE)}
    qparams = build_models(api, cfg, recipes.values())

    phase_done("llama2-7b build")

    # -- 5. serve each recipe --------------------------------------------------------
    sc = ServeConfig(max_slots=4, prefill_len=128, max_seq=256,
                     max_new_tokens=32)
    rng = np.random.default_rng(0)
    lengths = rng.integers(16, 129, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in lengths]
    toks = torch.tensor([prompts[0] + [0] * (128 - len(prompts[0]))],
                        device="cuda")
    n0 = len(prompts[0])
    launches_total = collections.Counter(dict.fromkeys(_build.KERNELS, 0))
    serve_stats: dict[str, dict] = {}
    models = {}  # the IS and W4A16 served models, profiled in phase 7
    graphs = {}  # recipe -> its steps' launches a replay (phase 6's check)
    rel = cpu_s = None
    for name, recipe in recipes.items():
        eng, outs, launches, reg, wall, peak = serve_recipe(
            api, cfg, qparams[name], recipe, sc, prompts)
        check_launches(name, launches, KERNELS_OF[name])
        steps = None
        if captures_steps(eng):
            steps = check_steps(f"serve {name}", eng, reg, launches)
            graphs[name] = step_launches(eng)
        for k, n in launches.items():
            launches_total[k] += n
        first_token_is_argmax(name, eng, toks, n0, outs[0][0])
        if name == DEFAULT_RECIPE.name:
            is_outs = outs
            check_eager_streams(f"serve {name}", api, cfg, eng, prompts, sc,
                                outs)
            # the kernels against the plain versions on the same weights
            rel, cpu_s = plain_check(api, cfg, qparams[name], recipe, toks,
                                     n0, PLAIN_CHECK_LAYERS, sc)
        serve_stats[name] = report_serve(
            "serve", name, api, cfg, eng, outs, launches, reg, wall, sc, peak)
        serve_stats[name]["steps"] = steps
        serve_stats[name]["tick_launches"] = check_tick_launches(
            "serve", name, cfg, *tick_launches(api, cfg, eng.model, sc))
        if name in (DEFAULT_RECIPE.name, WEIGHT_ONLY_RECIPE.name):
            models[name] = eng.model
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    phase_done("serve")

    # -- 5b. the int8 KV cache on the IS weights ----------------------------------
    kv8_stats = kv8_phase(api, cfg, qparams[DEFAULT_RECIPE.name],
                          DEFAULT_RECIPE, sc, prompts, toks, n0,
                          launches_total, is_outs, smi)

    phase_done("kv8")

    # -- 6. breaker drill: IS -> FS on the card -----------------------------------
    eng, outs, launches, reg, wall, _ = serve_recipe(
        api, cfg, qparams[DEFAULT_RECIPE.name], DEFAULT_RECIPE, sc, prompts,
        drill=True, fallback=(qparams[FLOAT_SCALE_RECIPE.name],
                              FLOAT_SCALE_RECIPE))
    fb = reg.counter("engine_fallback_events_total", "", ("reason",))
    if eng.fallbacks != 1 or fb.get(reason="decode_exception") != 1:
        raise AssertionError(f"breaker drill: {eng.fallbacks} fallbacks, "
                             f"{fb.total()} fallback events")
    if launches["w4a8_gemm_fs"] <= 0 or launches["w4a8_gemm_is"] <= 0:
        raise AssertionError(f"breaker drill launches: {launches}")
    steps = None
    if captures_steps(eng):  # IS graphs up to the fallback, FS after it
        steps = check_steps("drill IS->FS", eng, reg, launches, gens=[
            graphs[DEFAULT_RECIPE.name], graphs[FLOAT_SCALE_RECIPE.name]])
    for k, n in launches.items():
        launches_total[k] += n
    drill = dict(fallbacks=eng.fallbacks, ticks=eng.ticks, launches=launches,
                 steps=steps, kernel_failures=reg.counter(
                     "engine_kernel_failures_total", "", ("phase",)).total())
    log(f"[drill] IS->FS breaker: 2 injected decode failures at tick 3, "
        f"threshold 2: fallbacks {eng.fallbacks}, all 8 requests ok, "
        f"{eng.ticks} ticks; launches {json.dumps(launches)}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    phase_done("drill")

    # -- 7. profile one IS and one W4A16 decode step ------------------------
    profiles = {}
    for name in (DEFAULT_RECIPE.name, WEIGHT_ONLY_RECIPE.name):
        total, gemm, top, n, divs = profile_decode_step(api, cfg,
                                                        models[name], sc)
        profiles[name] = {"device_ms": total, "gemm_ms": gemm, "top": top,
                          "launches": n, "div_launches": divs}
        log(f"[profile] one {name} 4-slot decode step: {total:.3f} ms of "
            f"device kernels in {n} launches ({divs} elementwise "
            f"divisions), {gemm:.3f} ms ({gemm / total:.3f}) in the "
            "quantized GEMMs and their split reductions; top 8:")
        if name == DEFAULT_RECIPE.name and shares_quantization() and divs:
            raise AssertionError(f"{name} decode step: {divs} elementwise "
                                 "division kernels (the GEMM's epilogue "
                                 "divides sa / alpha)")
        for p in top:
            log(f"[profile]   {p['ms']:.3f} ms  x{p['count']}  {p['name']}")

    del models, qparams
    gc.collect()
    torch.cuda.empty_cache()

    phase_done("profile")

    # -- 7b. llama2-7b under the calibration algorithms ------------------------
    calib_stats = calib_phase(api, cfg, sc, prompts, toks, n0, launches_total,
                              smi)

    phase_done("calib")

    # -- 8. mixtral-8x7b at full width, one recipe at a time ------------------------
    mcfg = get_arch("mixtral-8x7b")
    mapi = get_model(mcfg)
    log(f"[mixtral] {mcfg.name}: {mcfg.num_layers} layers, d_model "
        f"{mcfg.d_model}, {mcfg.num_heads} query heads over "
        f"{mcfg.num_kv_heads} KV heads, {mcfg.num_experts} experts top-"
        f"{mcfg.top_k} of d_ff {mcfg.moe_d_ff}, vocab {mcfg.vocab_size}")
    mixtral_stats: dict[str, dict] = {}
    mrel = mcpu_s = None
    for recipe in (DEFAULT_RECIPE, FLOAT_SCALE_RECIPE, WEIGHT_ONLY_RECIPE):
        name = recipe.name
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with obs.use_registry(obs.Registry()):
            mq = ptq.quantize_by_layer(mapi, mcfg, recipe, seed=0,
                                       device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_peak = torch.cuda.max_memory_allocated()
        qbytes = sum(t.numel() * t.element_size() for t in S.leaves(mq))
        ebytes = sum(t.numel() * t.element_size() for blk in mq["blocks"]
                     for k in ("gate", "up", "down")
                     for t in S.leaves(blk["mlp"][k]))
        log(f"[mixtral] {name}: built block by block in {build_s:.1f} s; "
            f"weights on the card {qbytes / 1e9:.2f} GB (expert stacks "
            f"{ebytes / 1e9:.2f} GB); peak allocated while building "
            f"{build_peak / 1e9:.2f} GB")
        torch.cuda.reset_peak_memory_stats()  # from here: serving's peak
        eng, outs, launches, reg, wall, peak = serve_recipe(
            mapi, mcfg, mq, recipe, sc, prompts)
        eng.close()  # no routing sink from here on: the graph capture below
        check_launches(f"mixtral {name}", launches,
                       KERNELS_OF[name] | {MOE_KERNEL_OF[name]})
        steps = None
        if captures_steps(eng):
            steps = check_steps(f"mixtral {name}", eng, reg, launches)
        for k, n in launches.items():
            launches_total[k] += n
        tiles = reg.counter("engine_moe_m_tiles_total", "", ("kind",))
        executed, total = tiles.get(kind="executed"), tiles.get(kind="total")
        if not 0 < executed <= total:
            raise AssertionError(f"mixtral {name}: m-tiles executed "
                                 f"{executed}, total {total}")
        first_token_is_argmax(f"mixtral {name}", eng, toks, n0, outs[0][0])
        if name == DEFAULT_RECIPE.name:
            check_eager_streams(f"mixtral {name}", mapi, mcfg, eng, prompts,
                                sc, outs)
            mrel, mcpu_s = plain_check(mapi, mcfg, mq, recipe, toks, n0,
                                       MIXTRAL_PLAIN_CHECK_LAYERS, sc)
        st = report_serve("mixtral", name, mapi, mcfg, eng, outs, launches,
                          reg, wall, sc, peak)
        st["steps"] = steps
        st["tick_launches"] = check_tick_launches(
            "mixtral", name, mcfg, *tick_launches(mapi, mcfg, eng.model, sc))
        st.update(build_s=build_s, weight_bytes=qbytes, expert_bytes=ebytes,
                  build_peak_bytes=build_peak,
                  peak_bytes=torch.cuda.max_memory_allocated(),
                  m_tiles_executed=executed, m_tiles_total=total)
        mixtral_stats[name] = st
        log(f"[mixtral] {name}: m-tiles executed/total {executed:g}/"
            f"{total:g}; peak allocated while serving "
            f"{st['peak_bytes'] / 1e9:.2f} GB")
        del eng, mq
        gc.collect()
        torch.cuda.empty_cache()

    phase_done("mixtral")

    # -- 8b. llama3.2-3b under the paper's LLaMA-3 recipe ------------------------
    llama3_stats = llama3_phase(sc, prompts, toks, n0, launches_total, smi)

    phase_done("llama3")

    # -- 8c. Qwen2-72B, Granite-34B and Phi-3.5-MoE at full width ------------------
    configs_stats = configs_phase(sc, prompts, toks, n0, launches_total, smi)

    phase_done("configs")

    # -- 8d. MiniCPM3-4B and DeepSeek-V2 (MLA) at full width ---------------------
    mla_stats = mla_phase(sc, prompts, toks, n0, launches_total, smi)

    phase_done("mla")

    # -- 8e. Llama-3.2-Vision and Whisper-tiny (cross attention) -------------
    xattn_stats = xattn_phase(launches_total, smi)

    phase_done("xattn")

    # -- 8f. xLSTM-1.3B and RecurrentGemma-9B (the recurrent families) -------
    recurrent_stats = recurrent_phase(sc, prompts, toks, n0, launches_total,
                                      smi)

    phase_done("recurrent")

    # -- 8g. training: llama3.2-3b at full width, the restart drill ----------
    train_stats = train_phase(launches_total, smi)

    phase_done("train")

    # -- 8h. training the MoE family and MLA --------------------------------
    train_moe_stats = train_moe_phase(launches_total, smi)

    phase_done("train-moe")

    # -- 8i. training the recurrent families ---------------------------------
    train_rec_stats = train_rec_phase(launches_total, smi)

    phase_done("train-rec")

    # -- 8j. training the cross-attention families -------------------------
    train_xattn_stats = train_xattn_phase(launches_total, smi)

    phase_done("train-xattn")
    missing = sorted(k for k in _build.KERNELS if launches_total[k] <= 0)
    if missing:
        raise AssertionError(f"kernels never launched on a served or "
                             f"training path: {missing}")

    # -- 9. report ----------------------------------------------------------------
    meta = {
        "act_quant": ("src/repro_torch/csrc/act_quant.cu",
                      "src/repro/kernels/act_quant.py:44", [4, 4096]),
        "w4a8_gemm_is": ("src/repro_torch/csrc/w4a8_gemm_is.cu",
                         "src/repro/kernels/w4a8_gemm.py:112",
                         [4, 4096, 11008]),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:85",
                            [1, 128, 32, 128]),
        "w4a8_gemm_fs": ("src/repro_torch/csrc/w4a8_gemm_fs.cu",
                         "src/repro/kernels/w4a8_gemm_fscale.py:52",
                         [4, 4096, 11008]),
        "w4a16_gemm": ("src/repro_torch/csrc/w4a16_gemm.cu",
                       "src/repro/kernels/w4a16_gemm.py:63",
                       [4, 4096, 11008]),
        "moe_w4a8_is": ("src/repro_torch/csrc/moe_w4a8_is.cu",
                        "src/repro/kernels/moe_gemm.py:437",
                        [MOE_E, 8, 4096, 14336]),
        "moe_w4a8_fs": ("src/repro_torch/csrc/moe_w4a8_fs.cu",
                        "src/repro/kernels/moe_gemm.py:437",
                        [MOE_E, 8, 4096, 14336]),
        "moe_w4a16": ("src/repro_torch/csrc/moe_w4a16.cu",
                      "src/repro/kernels/moe_gemm.py:589",
                      [MOE_E, 8, 4096, 14336]),
    }
    kernels = []
    for name, (src, replaces, shape) in meta.items():
        r = next(r for r in rows if r["kernel"] == name and r["shape"] == shape
                 and r["variant"] in ("", "fine"))
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches_total[name],
            "max_abs_err": errs[name], "max_abs_diff": errs[name],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "bf16_matmul_ms": r["bf16_matmul_ms"], "shape": shape})
    r = next(r for r in rows if r["kernel"] == "flash_attention_bwd"
             and r["shape"] == [4, 1024, 24, 128])
    kernels.append({  # the jnp attention that jax.value_and_grad trains
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:53",
        "launches": launches_total["flash_attention_bwd"],
        "max_abs_err": errs["flash_attention_bwd"],
        "max_abs_diff": errs["flash_attention_bwd"], "ms": r["ms"],
        "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], "bf16_matmul_ms": None,
        "shape": r["shape"]})
    for r in qlint_rows:  # row 11: the factory _pallas's five kernels
        kernels.append({
            "name": r["kernel"], "route": "cuda",
            "source": f"src/repro_torch/csrc/fixtures/{r['kernel']}.cu",
            "replaces": "src/repro/analysis/fixtures.py:18",
            "launches": r["launches"], "max_abs_err": r["err"],
            "max_abs_diff": r["err"], "ms": r["ms"], "kernel_ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "bf16_matmul_ms": None, "shape": r["shape"]})
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": smi, "torch": torch.__version__, "kernels": kernels,
        "shapes": rows, "serve": serve_stats, "breaker_drill": drill,
        "launches_total": dict(launches_total), "qlint": qlint_stats,
        "qlint_fixtures": qlint_rows,
        "profile": profiles, "ptxas": ptxas,
        "check": {"plain_logit_rel": rel, "plain_layers": PLAIN_CHECK_LAYERS,
                  "plain_cpu_s": cpu_s, "mixtral_plain_logit_rel": mrel,
                  "mixtral_plain_layers": MIXTRAL_PLAIN_CHECK_LAYERS,
                  "mixtral_plain_cpu_s": mcpu_s},
        "mixtral": mixtral_stats, "calib": calib_stats,
        "llama3": llama3_stats, "kv8": kv8_stats, "configs": configs_stats,
        "mla": mla_stats, "xattn": xattn_stats,
        "recurrent": recurrent_stats, "train": train_stats,
        "train_moe": train_moe_stats, "train_rec": train_rec_stats,
        "train_xattn": train_xattn_stats,
        "seconds": time.perf_counter() - t_start,
        "phase_seconds": phase_times,
    }, indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
