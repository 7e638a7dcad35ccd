#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. the card (``nvidia-smi`` name and power limit), torch, the TF32 flags;
2. build every CUDA kernel of the port from the sources in this checkout
   (K2/K2q, K3/K4m/K4s, K5, K6a/K6b, K7, and the decode kernels D1, R1,
   W1 and M1: nine sources), one ``nvcc`` each,
   all started together, with build seconds and register counts (the flash
   kernels' by name, with their shared memory; the bf16 flash instances at
   D 192 and 256 and D1's at D 192 must show no spills), and the count of
   tensor-core instructions in the flash library's SASS;
2b. the sharded engine (``phase_sharded_engine``) on 4 gloo ranks that
   share the card, each launching the kernels built in phase 2 (no rank
   builds): ``shard_spmm_batched_stream`` on llama4-scout's 4 x 2,048
   prefill dispatch stream (one batch row a rank, K2 wide and K2q int8),
   ``shard_spmm`` on a banded 8192^2 BCSR by (8192, N) at N 512 and 300
   (f32 and bf16), ``shard_spmspm`` on the library's SpMSpM (wide and fp8
   ``a_scales``), ``shard_attention_sparse`` (K4s) at scout's prefill on a
   causal and a sliding-window mask, 512 query rows a rank, and
   ``sharded_flash_attention`` (K3) on a (2, 2) ("data", "model") mesh;
   each rank's launches counted (its kernel once), the sharded result ==
   the one-device kernel on the whole operand (``torch.equal``), that
   kernel against its plain version, each rank's kernel time on its part
   (one rank at a time: no multi-card speedup) beside the one-device
   time, and the phase's seconds; then, in the same spawn, the
   expert-parallel MoE (``moe.apply_moe`` under the shard_map impl) at
   llama4-scout's full width on a (2, 2) mesh, x 4 x 2,048: forward and
   backward, the output and every gradient against the one-device layer
   on each block (MOE_FWD_TOL / MOE_GRAD_TOL), R1 once a rank, each
   collective's seconds, each rank's peak memory; and
   ``sparse_psum_shard_map`` on a 2^24 gradient a rank, top 65,536,
   == ``sparse_allreduce_tree`` (``torch.equal``); the MoE's R1 row joins
   the kernels line, the exchange (no kernel of the port) the phase's
   summary;
2c. the multi-rank train step (``phase_train_mesh``,
   ``launch.steps.make_train_step(mesh=)``) on 4 gloo ranks that share the
   card: qwen3-1.7b and llama4-scout SMOKE (the shard_map MoE) in f32 on a
   (2, 2) and a (1, 2, 2) mesh, three steps each, the losses, norms and
   assembled params / m / v against the card's one-device step within the
   CPU test's tolerances, R1 twice a MoE layer a rank a step; then
   qwen3-1.7b at full width and depth (f32 params and AdamW state cut to
   a rank's shards, bf16 compute) on the (2, 2) mesh, kernel_sharded, 4 x
   512 tokens of ``SyntheticLM(seed=0)``, two steps: both losses against
   the one-device step on the same tokens (run first, then freed) within
   MESH_TRAIN_TOL, K3 twice a layer a rank a step (the forward and the
   remat recompute), each rank's peak memory, step seconds and (step 2)
   seconds in each collective; K3's row at a rank's heads and R1's at the
   SMOKE block join the kernels line;
3. kernel vs plain version on the card: K2 on random BCSR streams (f32 and
   bf16, blocks (8, 8), (8, 16), (16, 8), (8, 1), (16, 32), empty
   block-rows, bucket-pad entries, N not a multiple of the tile or of the
   16-byte vector), and a ``bn`` off the column unit refused; K3, K4m and
   K4s on random q, k, v
   (f32 and bf16 -- bf16 runs on the tensor cores, f32 on the CUDA cores --
   GQA 4/2 at D 64 and 16, 40/8 at D 128, 16/8 at D 256 and 12/1 and 96/8
   at D 192, tiles 32, 16 and 64, the
   reference's mask pattern zoo, bucketed and unbucketed streams, a window,
   a nonzero q_offset, ragged S through ``ops.attention``, causal or not),
   with the laws K4s == K4m, bucketed == unbucketed and K4s on a plain
   causal / window mask == K3 as ``torch.equal``; gemma3-12b's local
   attention at D 256 (16/8 heads, a ragged 1,500 tokens, window 1,024)
   through ``ops.attention`` against the host's plain version, K4s == K4m
   == K3; head dim 96 refused by K3; D1 (one-token decode
   attention; q and cache bf16 or f32, D 16 / 64 / 128 / 192 / 256, GQA
   40/8, 4/2, 16/8 and at D 192 groups of 12 (96/8, 24/2: two passes of 8
   and 4 heads), 6 and 2, per-row ``kv_len`` from 1 to the cache's 544,
   1,024 (a ring), 1,056, 2,064 or 16,400, the last past the CTAs' shared
   score budget, windows, vacant rows) and
   R1 (the router logits, d 5120 x 16 experts, x and W bf16 or f32, at
   every tile regime and its edges from 1 to 8,192 tokens, and at d
   40,960, E 5, d 200, E 128, d 201 and 202 and x and W off a 16-byte
   start, which the threads stage; and at E 128, llama4-maverick's router,
   x bf16 and W f32, at every token count) against their plain versions,
   and as ``torch.equal`` their laws: row i of B in {1, 2, 3, 4, 8, 16}
   rows (R1 at each of its token counts) == the row alone, D1 in a cache 1,520
   positions larger == in the case's, a scalar ``kv_len`` == a vector of equal
   values, each kernel == its order emulated in PyTorch, and at a group of
   12 the heads of a kv head == themselves in a pass of their own and
   alone; float16, other head dims (32, 96) and a group of 17 refused;
   then, as
   ``torch.equal``, K6a and K6b (five stencils, f32 and bf16, ragged, two
   tiles; K6b's march on interiors no multiple of its tile or run, rows
   at every 4-byte offset, tz below its ring, and two 3-D specs of no
   compiled pattern through the general kernel), K5 (f32 and bf16 at four launch shapes, a slab width that does
   not divide C among them; Inf / NaN in B only at keys A lacks, empty rows
   and columns, A keys outside B's key range; ``a_scales`` == on
   host-dequantized rows, three formats), K2q (== K2 on
   host-dequantized blocks, three formats, f32 and bf16 dense; and the
   streams its merge of a group's rows must survive: empty block-rows,
   unsorted and repeated columns, B 2 with distinct scales, N not a
   multiple of the vector, unaligned dense / blocks / out, bm 16, bk 32,
   5 and 1, each at two ``bn``, within 1e-5 of plain), and the
   port's quantizer on the card == on the CPU, as bytes; then K7 (the WKV
   recurrence, ``y`` and the final state) against its plain chunked version
   on r, k, v, w of three dtype pairings, T 100, 256 and 2048 at the
   kernel's one chunk (128) and decays that do or do not saturate the
   clamp, two launches ``torch.equal``, and on a small case both sides
   against an f64 sequential scan; then W1 (the one-token WKV step, 16
   rows of 64 heads, two decay ranges) ``torch.equal`` to its order
   emulated in PyTorch (y and state), its state ``torch.equal`` to the
   plain step's, y within 1e-5 of the plain step's largest |y|, and row
   i at B in {1, 2, 3, 4, 8, 16} == the row alone; and R1 at rwkv6-7b's
   decay-LoRA decode shapes (4096 x 64 with x bf16 and f32, 64 x 4096)
   == its emulated order, rows == alone; and R1 as the decode norms' row
   sum at d 4096, 5120, 3840 and 256 on 4, 32, 64 and 128 rows (both
   sides of the few-token kernel's 64) == its emulated order, rows ==
   alone, within 1e-5 of ``torch.sum``; then M1 (a Mamba-2 layer's whole
   decode step, the conv's output to the gated norm's input) in bf16 and
   f32 at (hd, ns) (64, 64) and (16, 16), 64 heads, B 1 / 4 / 8 / 16, on
   views of a conv output and a projection: its output ``torch.equal`` to
   its emulated order, its state to the plain step's, the output within
   one ulp (bf16) or 1e-5 (f32) of plain, in place == fresh, rows ==
   alone; other shapes, a bf16 state, a misaligned state and a strided
   row refused; D1's cases include zamba2-1.2b's 32/32 heads of 64
   (a GQA group of 1) in bf16, f32 and an int8 cache dequantized to bf16;
4. small f32 configs must give the same logits on the card and on the
   CPU: llama4-scout SMOKE prefill with chunked attention, masked attention
   (K4s) and kernel attention (K3); rwkv6-7b SMOKE prefill (K7 once a
   layer) and one decode step (W1 once a layer, R1 twice a layer and
   once a norm); qwen3-1.7b, qwen2-1.5b (at head dim 16, biases random)
   and nemotron-4-340b SMOKE, and musicgen-large and internvl2-26b SMOKE
   with 4 / 8 frontend embeddings before the prompt (S_total 28 / 32),
   prefill chunked, through K4s and through K3 (each once a layer) and
   one decode step (D1 once a layer, R1 once a decode norm); zamba2-1.2b
   SMOKE at ``shared_attn_every`` 1 and 2
   (f32 caches): prefill chunked, through K4s and through K3 (once a
   repeat) and one decode step (M1 once a mamba layer, D1 once a firing;
   M1's first call held as in phase 3);
4b. training (``phase_train``): qwen3-1.7b, llama4-scout and rwkv6-7b
   SMOKE in f32, the same params on the card and the CPU: step 1's loss
   and every gradient leaf (the CPU's within 1e-4 / 1e-3 of a leaf's
   largest), four ``make_train_step`` steps (losses within 1e-3), R1
   twice a MoE layer and K7 twice a rwkv layer a step (the forward and
   the remat recompute), no plain router or WKV step on the card; then
   qwen3-1.7b at full width and depth (28 layers, 2.03 B params in f32
   with AdamW's state, ``SyntheticLM(seed=0)`` at 4 x 2,048 through the
   ``Prefetcher``, ``seq_chunk`` 512): 16 chunked steps (finite; the
   last 4's mean below step 1's), one more traced (kernels, busy ms, the
   library's products, idle share, the longest kernels), then 4
   kernel_sharded steps from the same start (K3 56 times a step, the
   first loss within 2e-2 of chunked's); each step's loss and ms,
   tokens/s, the model flops' share of the bf16 peak and the peak memory;
   then ``run_with_restarts`` on the card at SMOKE with two injected
   failures: the stitched losses == an uninterrupted run's; then K3's row
   at the kernel_sharded call, R1's and K7's at the SMOKE calls;
5. the serving slice at full llama4-scout width (depth cut to 4 layers,
   random bf16 weights from a seed): ``ServeLoop(dispatch="bcsr")`` serves
   4 prompts of 256 tokens and generates 16 tokens greedily; the captured
   0/1 dispatch streams (the first MoE layer's prefill, the last decode
   step) must give kernel == plain exactly, the prefill stream at two
   ``bn`` too; the same weights with ``dispatch="gather"`` (fused, the
   default: ``model.prefill``, then the decode step replayed as one CUDA
   graph) must give the same tokens; D1 once an attention layer a decode
   step, R1 once a MoE layer a pass and once a decode step's rmsnorm (2
   a layer and the final one: ``layers.rmsnorm(row_order=True)``) in
   every run (a replay counts the launches its capture recorded), their
   plain versions never called on the card; then fused gather,
   ``two_phase=True`` gather (layered, eager) and fused bcsr (the full-grid stream, K2 once a MoE layer a pass): the
   same tokens, the first decode step's logits ``torch.equal``, a replay
   launching D1 4 times and R1 13 (and K2 4 on bcsr); fused and layered
   gather at depth 1 with the same tokens, one fused depth-1 step making
   no host sync; decode tok/s and the capture ms of each; and one decode
   step each, layered and replayed, traced by ``torch.profiler`` (kernels
   a step, busy and wall ms, idle share, the three longest kernels);
   then ``ServeLoop(pipeline_depth=1)`` (route phase 1 with
   the attention half, executes in flight behind the next host route, no
   per-step sync) serves the same prompts in the order depth 0 (the run
   above), 1, 1, 0 -- the greedy runs of each depth, tokens equal, K2
   ``n_moe x GEN`` times and no flash kernel each -- then one temperature
   0.7 run at each depth (tokens equal), the loop's sampler against
   ``torch.multinomial`` (tokens equal, the host syncs of each counted),
   and the host syncs of one extra depth-1 decode step, at most one per
   attn+moe layer (the slot fetch);
6. continuous batching on the same weights: ``ServeScheduler(dispatch=
   "bcsr", max_slots=8, max_seq=544)`` serves 16 requests (prompts 64-512
   tokens, budgets 8-32, from numpy seed 24; two submitted at step 0,
   then one every 2 scheduler steps; one carries as its EOS the token its
   probe run emits 5th) two-phase at depth 0, depth 1, with
   ``dispatch="gather", two_phase=True``, and at temperature 0.7 at each
   depth; then fused (``model.prefill`` admissions, each batch bucket's
   decode step one CUDA graph over the slot pool's rows): gather at depth
   0 (the default) and 1, bcsr (``two_phase=False``, the full-grid
   stream) and gather at temperature 0.7: every greedy run's tokens ==
   bcsr depth 0's and the temperature runs' equal, per request; K2
   ``n_moe x (admissions + decode steps)`` times in each bcsr run (replays
   counted) and never in a gather run; no flash launch and no oracle
   fallback; every decode step's bucket ``batch_bucket(highest occupied
   slot + 1)`` and in {1, 2, 4, 8}; fused, one graph for each bucket seen,
   a replay launching D1 4 times and R1 13 (and K2 4 on bcsr); the EOS
   request ends at its EOS and every other request gets its budget; one
   extra depth-1 two-phase step makes at most ``n_moe + 1`` host syncs,
   one extra fused step at depth 0 or 1 at most 1; D1 and R1 counted as
   in phase 5; then each request served alone through ``ServeLoop`` (B =
   1) must give the tokens every greedy run gave it, all 16 (where one
   parts, the step and the logit gap are printed before the check fails);
   and one decode step at bucket 8 traced, two-phase bcsr, layered gather
   and fused gather (kernels, busy / wall ms, idle share);
   then quantized experts and KV caches on the same weights
   (``quantize_experts=`` / ``kv_quant=``): ``model.prefill(kv_quant=
   "int8")`` logits ``torch.equal`` to wide; 4 x 256, 16 greedy tokens,
   wide gather fused, then int8 experts + int8 KV through two-phase bcsr
   and fused gather and fp8 e4m3 KV alone through fused gather (each
   driver deleted before the next): launches as wide, bcsr == gather
   tokens (so fused == two-phase), the first decode step within 0.2
   relative error of wide, at most 1 host sync an extra fused step; then
   the int8 scheduler (fused gather) on the trace, every request == itself
   alone through an int8 ``ServeLoop``, 16 of 16; decode tok/s, token
   latency, peak memory and capture ms beside the wide runs; then
   resilience (``phase_resilience``) on the same trace: the fused gather
   scheduler with a fault plan (a ``sample`` NaN for one uid, a
   ``prefill`` exception and a ``sample`` exception, both retried: that
   uid alone fails, every survivor == the fault-free run, the plan's
   firings as asked, one host sync an extra step with the plan attached),
   two-phase bcsr at depth 1 (an ``execute`` exception at ``layer=1``,
   retried from the saved step state: the pool's MoE occupancy after the
   step ``torch.equal`` to a fault-free run's; an ``execute`` NaN for one
   uid; the syncs of an extra step as without faults), the ``kv_wide``
   rung on the int8-KV scheduler (``fail_threshold=1``: the pool f32
   without scales, every bucket used afterwards captured again, the other
   15 requests finished, one host sync a fused step), and the decode tok/s
   of the fused scheduler with and without the retry's save; then the
   port's benchmarks on the same weights: ``bench_serve.run`` on the
   reference's ``synth_trace`` law at this phase's sizes (16 requests,
   prompts 64-512, budgets 8-32, a pair every 2 steps, numpy seed 24),
   fused gather and two-phase bcsr at depths 0 and 1 and each under
   ``FaultPlan.random(17, uids, 0.3)`` (16 of 16 in every healthy run,
   serial == pipelined and bcsr == gather tokens, survivors == the healthy
   run, a fault fired, ``compile_signatures`` within its bound, K2 once an
   execute call); and ``bench_moe.run`` / ``run_host_dispatch`` at the
   reference's shapes (its ``torch.equal`` checks, each jit-compiled call
   of the reference replayed from a CUDA graph, K2 launched); the peak of
   each quantized run is printed beside its own peak, the peak less the
   bytes of phase 5's param leaves the quantized driver does not hold;
7. masked serving on the same weights: 4 prompts of 2048 tokens through
   ``ServeLoop(attn_mask=local_global)`` (a synthetic pattern that
   exercises the masked kernels), 16 greedy tokens, once with the
   stream walk (K4s) and once with the masked grid (K4m), which must give
   identical tokens and no oracle fallback; the first run's first dispatch
   stream is captured for K2; then one depth-1 run through K4s with the
   same tokens, launches and no fallback, and its prefill's route, fetch
   wait and hidden route ms;
8. kernel prefill on the same prompts (``prefill_layered(impl="kernel")``,
   K3) and the default chunked prefill (bf16 operands), each timed, their
   first tokens against each other and against ``impl="ref"``
   (information), and K3 == K4s on ``BlockMask.causal`` on its layer-0 q,
   k, v; the expert products of a decode step over all the experts
   (``torch.bmm``) against their bound and against the routed experts'
   products alone; then the llama4 weights are released and the K2, D1,
   R1, K3, K4m and K4s rows are measured at the arch's served shapes;
8b. llama4-maverick-400b-a17b (the one stack that interleaves dense and
   MoE layers, and the one with 128 experts) at full width and depth 1
   of 24 units (a dense layer and a MoE layer, 37.1 GB of random bf16
   weights from a seed; the cut printed), through phases 5-8's own code
   (``serve_moe``, as scout) without the quantized, resilience and
   benchmark runs: the scheduler runs two-phase bcsr at depths 0 and 1,
   fused gather and bcsr, and two-phase bcsr and fused gather with
   ``kv_quant="int8"`` (every request == itself alone, wide and int8);
   the kernel rows' names end in " E128 llama4-maverick-400b-a17b";
9. RWKV-6 serving at full width and depth (rwkv6-7b: d_model 4096, 64
   heads of 64, d_ff 14336, vocab 65536, 32 layers, random bf16 weights
   from a seed, ~15 GB): ``ServeLoop`` serves 4 prompts of 2048 tokens and
   generates 16 greedy tokens through the default, fused loop (the decode
   step one replayed CUDA graph), with K7 launched once a layer in prefill
   (32) and never in decode, W1 once a layer a decode step and R1 twice a
   layer and once a decode step's rmsnorm (32 and 161 a replay), and no
   plain version called on the card; the
   first layer's r, k, v, w, u are captured and K7 is held against plain
   on them; prefill ms, decode tok/s and the phase's peak device memory;
   ``two_phase=True`` (layered, eager) gives the same tokens and the first
   decode step's logits ``torch.equal``; then a depth-1 run of each: the
   same tokens, the same 32 K7 launches, no host sync in a fused depth-1
   step; decode tok/s of each and the capture ms; one decode step each,
   layered and replayed, traced as in phase 5; then 8 requests of phase
   6's trace through ``ServeScheduler`` (8 slots), fused (the default)
   and ``two_phase=True``: equal tokens, K7 32 times an admission and
   never in decode, W1 32 and R1 161 times a decode step (replays
   counted), one graph a bucket seen; every request equals itself served
   alone (8 of 8, checked); the fused run again with a ``sample``
   exception after a replay, retried: 8 of 8 and every pool leaf (``wkv``,
   the shifts) ``torch.equal`` to the fault-free run's; decode tok/s with
   and without the retry's save;
10. gemma3-12b serving at full width (``CONFIG``: d_model 3840, 16/8
   heads of 256, d_ff 15360, vocab 262,144, window 1,024, qk_norm) and
   depth 2 of its 8 units (12 of 48 layers, 10 of them local with
   ring-buffer caches; random bf16 weights from a seed, 9.4 GB; the cut
   printed), after the RWKV weights are freed:
   ``ServeLoop`` serves 4 prompts of 1,536 tokens (past the window, so the
   prefill's rings have wrapped) and 64 greedy tokens, fused and layered
   (tokens equal, the first decode step's logits ``torch.equal``; D1 12
   and R1 49 a decode step -- ln1, ln2, q_norm and k_norm a layer and the
   final norm in row order -- no plain version on the card; the first
   decode step's ln1, q_norm and k_norm squares through R1 == its
   emulated order, rows == alone, near ``torch.sum``); the sliding
   mask (K4s / K4m on the 10 local layers) and ``local_global`` (all 12),
   sparse == dense tokens; the kernel prefill (K3 x 12); one decode step
   each traced; then ``ServeScheduler`` (8 slots, fused) on 8 requests of
   900-1,100 prompt tokens and 48-144 budgets (rows cross the window at
   different steps), wide and with ``kv_quant="int8"`` (global layers
   narrow, rings wide): one graph a bucket, every request == itself alone
   (8 of 8 each), the norms of bucket 8's first step (q_norm 128 rows: the
   many-token R1) checked as the loop's; the phase's peak printed; then
   the D 256 rows of K3 / K4m / K4s (a local layer's captured q, k, v,
   the global layer's K3 beside) and D1 (the ring and global calls of the
   first decode step, B 1 and 8 beside);
10b. the dense GQA family, one arch at a time, each freeing its weights
   before the next: qwen3-1.7b (16/8 heads of 128, qk_norm) and
   qwen2-1.5b (12/2 heads of 128, qkv bias, random biases) at full width
   and DEPTH's 7 of 28 layers on 4 x 2,048 prompts, and
   nemotron-4-340b at full width (96/8 heads of 192: a GQA group of 12;
   d_ff 73,728 squared ReLU; vocab 256,000) and depth 4 of 96 (46.5 GB) on
   4 x 1,024, random bf16 weights from a seed: ``ServeLoop`` chunked
   prefill and 32 greedy tokens fused and layered (tokens equal, first
   decode step logits ``torch.equal``, D1 once a layer and R1 once a
   decode norm a step, no plain version on the card), one decode step
   each traced; nemotron's masked prefill (local_global) through K4s and
   K4m, sparse == dense tokens; the K3 prefill timed; the scheduler on 8
   requests of 256-1,024 prompt tokens and budgets 16-64 (numpy seed 34),
   8 slots, wide and int8 KV, fused and two-phase: fused == two-phase
   tokens, one graph a bucket, every request == itself alone (8 of 8
   each); each arch's K3 (and nemotron's K4m / K4s) and D1 at its served
   shapes timed into the kernels line; each phase's wall seconds; then
   the frontend configs the same way at full width and DEPTH's 12 of 48
   layers: musicgen-large (32/32 heads of 64, vocab 2,048) and
   internvl2-26b (48/8 heads of 128, vocab 92,553) on 4 x 1,024 prompts
   after 64 / 256 bf16 embedding positions
   (S_total 1,088 / 1,280), internvl2's local_global masked prefill
   through K4s and K4m, the scheduler on the same text-only trace; their
   summaries on the serving line's ``frontend`` object;
10c. zamba2-1.2b at full width and depth (38 Mamba-2 layers, 2 of them
   the prologue, and one shared 32/32-head attention block after each of
   the 6 repeats; 2.34 GB of random bf16 weights): ``ServeLoop`` on 4 x
   2,048 prompts, 32 greedy tokens, fused and layered (tokens equal,
   first decode step logits ``torch.equal``; M1 38, D1 6 and R1 89 a
   decode step, no plain version on the card), one step of each traced
   (the fused step's kernel count printed);
   local_global on the shared block, sparse == dense; the K3 prefill; one
   mamba layer's prefill and its chunked SSD timed; the scheduler (the
   dense family's trace, wide and int8 KV, fused and two-phase, 8 of 8
   alone each); then K3 / K4m / K4s, D1 (group 1) and M1 at its served
   shapes (M1 on the served step's own inputs and state: == its order,
   rows == alone; the plain segment beside) into the kernels line;
11. the sparse library slice at the paper's workload sizes, data made on
   the card: ``stencil.ops.apply`` on j3d27pt / j3d7pt (512^3 f32) and
   j2d5pt / j2d9pt / j2d9pt-gol (16384^2 f32), ``spmspm.ops.spmspm`` on
   8192^2 A (5 %) x B (1 %), wide and with fp8 e4m3 ``a_scales``, and
   ``spmm.ops.spmm`` on a banded 8192^2 fp8 e4m3 BCSR (bandwidth 512,
   8 x 8 blocks) x an (8192, 4096) f32 dense; outputs checked against the
   plain versions and the oracles;
12. one JSON line per kernel ({"kernels": [...]}: launches, error, times,
   bound; K3, R1 and K7 as the train steps ran them (phase 4b); K2, D1,
   R1, K3, K4m, K4s, the same six at llama4-maverick's
   shapes (E 128), K7, W1, K3 / K4m / K4s / D1 at D 256,
   K3 / D1 at each dense arch's served shape (K4m / K4s and D1's two
   passes at nemotron-4-340b's D 192), K3 / D1 at musicgen-large's and
   K3 / K4m / K4s / D1 at internvl2-26b's, K3 / K4m / K4s / D1 / M1 at
   zamba2-1.2b's,
   K6a, K6b, K5, K2q; D1, R1 and
   W1 on the calls the serving runs made (decode steps at 4 x 256, the
   scheduler's top bucket, 4 x 2048; R1's prefills; W1 and R1's
   decay-LoRA products at the RWKV-6 decode's first step, W1 at B 1 and 8
   beside; D1's cluster shape and shared memory a CTA), SDPA and
   ``torch.matmul`` beside them, R1's no-FMA instruction floor at the SM
   clock read around its timing; K2 on each captured
   stream with its row statistics, == plain; K5 with its bucketing and
   product passes timed apart; K2q with its share of the f32 peak) and
   one with the serving and
   library summary (its ``serve.pipelined`` object: each depth's prefill
   ms, decode tok/s and ``timing`` split at 4 x 256, the masked depth-1
   run, the RWKV-6 depth-1 run, the host syncs; its ``serve.scheduler``
   object: each scheduler run's decode tok/s, token and first-token
   latency p50 / p99, steps, wall, buckets, capture and ``timing`` split,
   the syncs of an extra step, the alone comparison and the traces; its
   ``rwkv.scheduler`` object: the RWKV scheduler runs; the chunked 4 x 2048
   prefill ms; its ``train`` object: phase 4b's numbers); the SM clock and its
   limit are printed before and after the kernel timings; then one line
   ``{"resilience": {...}}``: the faulted runs' failed uids, survivors
   equal, firings and syncs a step, the captures (count and ms) after
   ``kv_wide``, the save's cost on scout and rwkv6-7b, and the card;
   then one line ``{"bench": {"serve": ..., "moe": ...}}``: the two
   benchmarks' payloads (their rows, launches and wall seconds);
13. last line: {"ok": true, "device": {...}}.

Every launch count is set to 0 just before a run of the main path and read
just after it; launches made to compare a kernel with its plain version or
to time it are not counted.

It exits nonzero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and dense bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

BATCH, PROMPT, GEN = 4, 256, 16
# the MoE archs of phases 5-8; maverick runs them without the quantized,
# resilience and benchmark runs, which stay scout's
SCOUT_ARCH = "llama4-scout-17b-a16e"
MAVERICK_ARCH = "llama4-maverick-400b-a17b"
# the depth (block-unit repeats) each serving phase runs an arch at, always
# at full width, the cut printed (:func:`served_config`); an arch without an
# entry runs at full depth.  scout 4 of 48 layers (21.8 GB); maverick 1 of
# 24 units (2 of 48 layers, 37.1 GB); gemma3-12b 2 of 8 units (12 of 48
# layers); nemotron-4-340b 4 of 96 layers (a layer is 6.91 GB of bf16 and
# the embedding and unembedding 9.44 GB each: 46.5 GB, 6 layers would be
# 60.3 GB of one card's 80 GB); musicgen-large and internvl2-26b 12 of 48
# layers, qwen3-1.7b and qwen2-1.5b 7 of 28, to keep the script under 750
# s with the sharded engine's expert-parallel MoE and the multi-rank train
# step (at 24 of 48 and 14 of 28 the script took 781.5 s on an H100
# machine with a slower host; at full depth 751 and 812 s before the train
# step's phase)
DEPTH = {SCOUT_ARCH: 4, MAVERICK_ARCH: 1, "gemma3-12b": 2,
         "nemotron-4-340b": 4, "musicgen-large": 12, "internvl2-26b": 12,
         "qwen3-1.7b": 7, "qwen2-1.5b": 7}
# masked and kernel prefill: prompt length and the local window of the
# opt-in long-context pattern (local_global: window + the first KV tile),
# a synthetic kernel exercise rather than llama4-scout's own attention
ATTN_PROMPT, MASK_WINDOW = 2048, 512
FLASH_SRC = "src/repro/kernels/flash_attention/kernel.py"
# RWKV-6 serving: the full config, prompts of this length
RWKV_ARCH, RWKV_PROMPT = "rwkv6-7b", 2048
# K7 vs plain: within this share of the largest |value| (y and the state
# alike).  The mid-chunk rescale puts exponents up to half a chunk of decay
# (64 at the clamp), where one f32 ulp of the argument is ~4e-6 of the
# exponential, and the kernel sums its dots in another order than plain.
WKV_REL_TOL = 2e-5


def served_config(arch: str):
    """``arch``'s config at full width and ``DEPTH``'s depth, its full
    config, and the cut as the serving phases print it."""
    from repro_torch.configs import get_config
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_repeats=DEPTH.get(arch,
                                                        full.n_repeats))
    return cfg, full, (f"depth {cfg.n_layers} of {full.n_layers} layers "
                 f"({cfg.n_repeats} of {full.n_repeats} units)")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def tolerance(big: float, dtype) -> float:
    """Kernel vs plain: f32 within 1e-5 of the largest |value| (the kernel
    sums its products in another order); narrower types within one ulp of
    the largest |value| in that type (both round one f32 result, which may
    fall on either side of a tie)."""
    import numpy as np
    import torch
    if dtype == torch.float32:
        return 1e-5 * big
    if big == 0:
        return 0.0
    return 2.0 ** np.floor(np.log2(big)) * torch.finfo(dtype).eps


def max_err(got, want, what: str) -> float:
    """Largest |got - want|, checked against :func:`tolerance`."""
    import torch
    torch.cuda.synchronize()
    big = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    tol = tolerance(big, got.dtype)
    check(err <= tol, f"{what}: kernel disagrees with plain: {err} > {tol}")
    return err


def _counted():
    """Every kernel of the port, by name: its wrapper and the attribute in
    which the wrapper counts its launches (``kernels.launch_counters``; a
    replayed decode graph adds the launches its capture recorded)."""
    from repro_torch import kernels
    return kernels.launch_counters()


def reset_launches() -> None:
    from repro_torch import kernels
    kernels.reset_launches()


def read_launches() -> dict:
    from repro_torch import kernels
    return kernels.read_launches()


def only(**launches) -> dict:
    """The launch counts of a run that launched these kernels and no
    other."""
    return {name: launches.get(name, 0) for name in _counted()}


class no_plain:
    """While on, the plain decode attention, the plain router, the plain
    WKV step and the plain Mamba-2 step raise if they are called on a CUDA
    tensor: the card's main path must launch the kernels D1, R1, W1 and M1
    (their wrappers take the plain versions for CPU tensors only)."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ref as fref
        from repro_torch.kernels.router import kernel as rk
        from repro_torch.kernels.ssd import kernel as mk
        from repro_torch.kernels.wkv import kernel as wk
        self.saved = [(fref, "decode_attention_ref"),
                      (fref, "decode_split_max_ref"),
                      (fref, "decode_split_partial_ref"),
                      (rk, "router_logits_ref"), (wk, "wkv_step_plain"),
                      (mk, "mamba_step_plain")]
        self.saved = [(m, a, getattr(m, a)) for m, a in self.saved]
        for mod, attr, fn in self.saved:
            def guarded(x, *a, _fn=fn, _name=attr, **kw):
                check(x.device.type == "cpu",
                      f"{_name} ran on the card's main path")
                return _fn(x, *a, **kw)
            setattr(mod, attr, guarded)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)
        return False


class hook_calls:
    """While on, every call of D1 and of the prefill attention (through
    ``flash_attention.ops``, as ``models.layers`` calls them) and of R1
    (through ``models.moe``) first goes to ``keep(name, args, kwargs)``,
    ``name`` "decode_attention", "attention" or "router_logits"; the
    kernels' launch counts are untouched."""

    def __init__(self, keep):
        self.keep = keep

    def targets(self) -> list:
        """The (module, attribute) of every hooked entry."""
        from repro_torch.kernels.flash_attention import ops as fops
        from repro_torch.models import moe
        return [(fops, "decode_attention"), (fops, "attention"),
                (moe, "router_logits")]

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n in self.targets()]
        for mod, name, fn in self.saved:
            def hooked(*a, _fn=fn, _name=name, **kw):
                self.keep(_name, a, kw)
                return _fn(*a, **kw)
            setattr(mod, name, hooked)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


class keep_row_sum:
    """While on, the first call of ``router.ops.row_sum`` (the sum of
    squares of a decode step's first rmsnorm, R1 on the card) keeps a copy
    of its argument in ``self.x``, and the first call of each shape one in
    ``self.shapes`` (shape: copy); calls made while a CUDA graph is being
    captured are not kept.  Every call goes on as before and the launch
    counts are untouched."""

    def __enter__(self):
        import torch
        from repro_torch.kernels.router import ops as rops
        self.x, self.shapes, self.entry = None, {}, rops.row_sum

        def kept(x):
            if not torch.cuda.is_current_stream_capturing() \
                    and tuple(x.shape) not in self.shapes:
                self.shapes[tuple(x.shape)] = x.clone()
                if self.x is None:
                    self.x = self.shapes[tuple(x.shape)]
            return self.entry(x)

        rops.row_sum = kept
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.router import ops as rops
        rops.row_sum = self.entry
        return False


ATTN_KINDS = ("attn", "attn_local", "attn_global", "attn+moe",
              "shared_attn")


def step_layers(cfg) -> tuple:
    """The kind of every layer one decode step runs: the prologue's, the
    stack's, and the shared attention block once a repeat it fires on
    (``model.step_kinds``)."""
    from repro_torch.models import model as M
    return M.step_kinds(cfg)


def decode_norms(cfg) -> int:
    """The rmsnorms of one decode step, each summed by R1 on the card
    (``layers.rmsnorm(row_order=True)``): ln1 and ln2 an attention layer
    or shared-block firing (and q_norm and k_norm where the config has
    ``qk_norm``), ln1, ln_x and ln2 an rwkv layer, ln and the gated norm a
    mamba layer, and the final norm."""
    attn = 2 + 2 * cfg.qk_norm
    per = {**{k: attn for k in ATTN_KINDS}, "rwkv": 3, "mamba": 2}
    return sum(per[k] for k in step_layers(cfg)) + 1


def r1_per_step(cfg) -> int:
    """R1's launches in one decode step: the router once a MoE layer, the
    decay LoRA twice an rwkv layer, and :func:`decode_norms`."""
    kinds = step_layers(cfg)
    return (kinds.count("attn+moe") + 2 * kinds.count("rwkv")
            + decode_norms(cfg))


def decode_counts(cfg, prefills: int, decode_steps: int, **others) -> dict:
    """The launch counts of a serving run of an attention or hybrid stack
    that made ``prefills`` prefills and ``decode_steps`` decode steps: D1
    once an attention layer (or shared-block firing) a decode step, M1
    once a mamba layer a decode step, R1 once a MoE layer a prefill and
    :func:`r1_per_step` times a decode step, and ``others`` (a dense stack
    such as gemma3-12b's: no router, R1 the decode norms alone)."""
    kinds = step_layers(cfg)
    n_attn = sum(k in ATTN_KINDS for k in kinds)
    n_moe = cfg.block_unit.count("attn+moe") * cfg.n_repeats
    return only(decode_attention=n_attn * decode_steps,
                ssd_step=kinds.count("mamba") * decode_steps,
                router_logits=n_moe * prefills + r1_per_step(cfg)
                * decode_steps, **others)


def step_counts(cfg) -> dict:
    """The launches of one decode step (a fused step's replay), by
    kernel: :func:`decode_counts` of one step without a prefill."""
    return {k: v for k, v in decode_counts(cfg, 0, 1).items() if v}


def rwkv_counts(cfg, prefills: int, decode_steps: int) -> dict:
    """The launch counts of a serving run of an rwkv stack that made
    ``prefills`` prefills (each row of a batch prefill together) and
    ``decode_steps`` decode steps: K7 once a layer a prefill; W1 once a
    layer a decode step and R1 :func:`r1_per_step` times (the decay LoRA's
    two products a layer and the step's norms)."""
    n = cfg.n_repeats * cfg.block_unit.count("rwkv")
    return only(wkv_kernel=n * prefills, wkv_step=n * decode_steps,
                router_logits=r1_per_step(cfg) * decode_steps)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events), after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 3) -> float:
    """Mean device time of ``fn`` replayed from one CUDA graph of ``iters``
    calls (CUDA events around ``replays`` replays): the kernels' time without
    the host's per-call launch overhead, which :func:`time_ms` includes when
    a call is shorter than its launch."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):             # warm-up off the capture
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def count_syncs(fn):
    """``fn()`` and the host syncs it makes: the synchronizing CUDA calls
    that torch's sync debug mode reports (stream and device syncs, blocking
    copies such as ``.cpu()``), and the CUDA event waits, which that mode
    does not report, counted apart.  Returns (result, syncs, event
    waits)."""
    import warnings
    import torch
    waits = []
    wait = torch.cuda.Event.synchronize

    def counted(event):
        waits.append(1)
        return wait(event)

    torch.cuda.synchronize()
    torch.cuda.Event.synchronize = counted
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        torch.cuda.Event.synchronize = wait
    syncs = sum("synchronizing" in str(w.message) for w in caught)
    return out, syncs, len(waits)


def serve_numbers(depth: int, summary: dict) -> dict:
    """One serving run's numbers from ``ServeLoop.summary()``: prefill ms,
    decode tok/s (over decode + drain), and the whole ``timing`` split."""
    ms = lambda ph: summary.get(ph, {}).get("seconds", 0.0) * 1e3  # noqa: E731
    return {"depth": depth, "prefill_ms": ms("prefill"),
            "decode_tok_per_s": summary["decode"]["tok_per_s"],
            "decode_ms": ms("decode"), "drain_ms": ms("drain"),
            "route_ms": ms("route"), "execute_ms": ms("execute"),
            "timing": summary["timing"]}


def print_serve(label: str, row: dict) -> None:
    tm = row["timing"]
    print(f"  {label}: prefill {row['prefill_ms']:.1f} ms, decode "
          f"{row['decode_tok_per_s']:.1f} tok/s (decode {row['decode_ms']:.1f}"
          f" + drain {row['drain_ms']:.1f} ms); route {row['route_ms']:.1f}, "
          f"execute {row['execute_ms']:.1f} ms; timing " + ", ".join(
              f"{k} {v:.4g}" for k, v in tm.items()))


def first_step_logits(loop, prompts, gen: int = GEN, embeddings=None):
    """``loop.run(prompts, gen, embeddings=)`` keeping a copy of the logits
    its first decode step sampled from (its second draw; the first is the
    prefill's).  Returns (tokens, those logits)."""
    seen = []

    def keep(last_logits, _sample=loop._sample):
        if len(seen) < 2:
            seen.append(last_logits.clone())
        return _sample(last_logits)

    loop._sample = keep
    try:
        tokens = loop.run(prompts, gen, embeddings=embeddings)
    finally:
        del loop._sample
    return tokens, seen[1]


def fused_numbers(label: str, summary: dict, capture: dict,
                  launches: dict) -> dict:
    """One fused or layered serving run's numbers: prefill ms, decode tok/s
    (over decode + drain), the graph capture of the loop's first run (calls
    and ms, not counted in decode) and the run's launches."""
    ms = lambda ph: summary.get(ph, {}).get("seconds", 0.0) * 1e3  # noqa: E731
    return {"label": label, "prefill_ms": ms("prefill"),
            "decode_tok_per_s": summary["decode"]["tok_per_s"],
            "decode_ms": ms("decode"), "drain_ms": ms("drain"),
            "capture": capture,
            "launches": {k: v for k, v in launches.items() if v}}


def print_fused(row: dict) -> None:
    print(f"  {row['label']}: prefill {row['prefill_ms']:.1f} ms, decode "
          f"{row['decode_tok_per_s']:.1f} tok/s (decode {row['decode_ms']:.1f}"
          f" + drain {row['drain_ms']:.1f} ms), capture "
          f"{row['capture']['ms']:.1f} ms ({row['capture']['calls']} in the "
          f"first run); launches {row['launches']}")


def _busy_us(spans) -> float:
    """The union of ``(start, end)`` spans, in their unit."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def trace_decode(label: str, loop, prompts, embeddings=None) -> dict:
    """One depth-0 decode step of ``loop`` after its prefill (with a
    frontend's ``embeddings``), traced by :func:`trace_step`."""
    return trace_step(label,
                      lambda: loop.prefill(prompts, embeddings=embeddings),
                      loop.decode_step)


# kernel-name fragments of the library's (cuBLAS / CUTLASS) matrix products
GEMM_WORDS = ("gemm", "cutlass", "xmma", "cublas")


def trace_step(label: str, prepare, step, top: int = 3) -> dict:
    """One ``step()`` traced by ``torch.profiler`` with CUDA activity,
    after ``prepare()``, two warm steps and three steps timed on the host
    clock (synchronised) without the profiler.  Device work: every CUDA
    event of the trace (kernels, and the copies and fills counted apart),
    busy = the union of their spans.  Wall: the host clock around the
    traced step (the profiler's own cost included) and the median
    untraced step; idle share = 1 - busy / untraced wall.  The ``top``
    kernels of the most summed time, by name, and the summed time of the
    library's matrix products (names with :data:`GEMM_WORDS`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prepare()
    for _ in range(2):
        step()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [e for e in events if e.name.lower().startswith(("memcpy",
                                                              "memset"))]
    kernels = [e for e in events if e not in copies]
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in events]) / 1e3
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + (e.time_range.end
                                       - e.time_range.start) / 1e3)
    longest = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    gemm_ms = sum(t for n, (_, t) in by_name.items()
                  if any(w in n.lower() for w in GEMM_WORDS))
    wall_ms = sorted(walls)[1] * 1e3
    row = {"label": label, "kernels": len(kernels), "copies": len(copies),
           "busy_ms": busy_ms, "gemm_ms": gemm_ms, "wall_ms": wall_ms,
           "traced_wall_ms": traced * 1e3,
           "idle_share": 1 - busy_ms / wall_ms if events else None,
           "top": [{"name": n[:80], "calls": c, "ms": t}
                   for n, (c, t) in longest]}
    print(f"  trace {label}: {row['kernels']} kernels a step (+ "
          f"{row['copies']} copies / fills), busy {busy_ms:.3f} ms (library "
          f"products {gemm_ms:.3f}), wall "
          f"{wall_ms:.3f} ms (traced {row['traced_wall_ms']:.3f}), idle "
          + (f"share {row['idle_share']:.3f}" if events else
             "share not measured (the profiler saw no device work)")
          + "; longest: " + "; ".join(
              f"{t['name'][:48]} x {t['calls']} {t['ms']:.3f} ms"
              for t in row["top"]))
    return row


CLOCKS = "clocks.sm,clocks.max.sm"


def smi(query: str) -> str:
    """The first card's ``nvidia-smi --query-gpu=<query>`` as one CSV
    line."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


def phase_card():
    import torch
    card = smi("name,power.limit")
    print(card)
    # the host CPU runs the plain versions that some checks compare with
    info = {}
    for line in open("/proc/cpuinfo"):
        key, _, val = line.partition(":")
        info.setdefault(key.strip(), val.strip())
    cpu = (f"{info.get('model name', '?')} ({info.get('vendor_id', '?')} "
           f"family {info.get('cpu family', '?')} model "
           f"{info.get('model', '?')}; amx "
           f"{'amx_tile' in info.get('flags', '').split()})")
    print(f"host cpu: {cpu}, {os.cpu_count()} cores, torch cpu capability "
          f"{torch.backends.cpu.get_cpu_capability()}, "
          f"{torch.get_num_threads()} threads")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          "allow_bf16_reduced_precision_reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
          "the port's numerics flags are not set")
    return card


def _flash_resources(log: str) -> dict:
    """The flash kernels' registers, spills and shared memory (``-Xptxas
    -v``; the dynamic shared memory from ``tuning.flash_smem_bytes`` at 64
    x 64 tiles), kernel by kernel.  Returns {(kernel, D): spill line}."""
    import re
    import torch
    from repro_torch.kernels import tuning
    if "ptxas" not in log:
        print(f"  flash_attention: {log}")
        return {}
    name, spills, seen = None, "", {}
    for line in log.splitlines():
        m = re.search(r"\d((?:tc_)?flash_(?:masked_|sparse_)?kernel)ILi(\d+)E",
                      line)
        if "Compiling entry function" in line and m:
            name = (m.group(1), int(m.group(2)))
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "Used" in line:
            kern, d = name
            dt = torch.bfloat16 if kern.startswith("tc_") else torch.float32
            print(f"  flash_attention {kern}<D={d}>: "
                  f"{line.split(':', 1)[-1].strip()}; {spills}; "
                  f"{tuning.flash_smem_bytes(64, 64, d, dt)} bytes dynamic "
                  "smem at 64 x 64 tiles")
            seen[kern, d] = spills
            name = None
    return seen


def kernel_resources(log: str) -> list:
    """(kernel, registers line, spill line) of each entry function in a
    ``-Xptxas -v`` report, its name demangled where ``c++filt`` exists and
    cut before the argument list."""
    import re
    import shutil
    rows, name, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = m.group(1), ""
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "Used" in line:
            rows.append([name, line.split(":", 1)[-1].strip(), spills])
            name = None
    tool = shutil.which("c++filt")
    if rows and tool:
        names = subprocess.run([tool], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True).stdout.split("\n")
        for r, n in zip(rows, names):
            r[0] = n.replace("(anonymous namespace)::", "").split("(")[0] \
                .removeprefix("void ")
    return [tuple(r) for r in rows]


def _flash_sass() -> None:
    """The count of tensor-core instructions (HGMMA: wgmma, HMMA:
    mma.sync) in the flash library's SASS, where the toolkit has
    ``cuobjdump``."""
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        print("  flash_attention SASS: no cuobjdump")
        return
    sass = subprocess.run([tool, "-sass", str(build.library_path(
        "flash_attention"))], capture_output=True, text=True).stdout
    ops = [ln.split("*/", 1)[-1].split()[0] for ln in sass.splitlines()
           if "MMA" in ln and "*/" in ln]
    print(f"  flash_attention SASS: {sum(o.startswith('HGMMA') for o in ops)}"
          f" HGMMA, {sum(o.startswith('HMMA') for o in ops)} HMMA "
          "instructions")


def phase_build():
    from repro_torch.kernels import build
    t0 = time.monotonic()
    res = build.build_all()
    print(f"build: {time.monotonic() - t0:.2f} s for {sorted(res)}")
    for name, r in res.items():
        if name == "flash_attention":
            spills = _flash_resources(r["log"] or "(no compiler report "
                                      "beside the library)")
            # the bf16 instances at D 192 and 256 hold a (64, 192) or (64,
            # 256) f32 accumulator (96 or 128 registers a thread): the
            # build must show no spills
            if not spills:
                print("  flash_attention: the D 192 / 256 spill check was "
                      "NOT run (no compiler report)")
            for kern in ("tc_flash_kernel", "tc_flash_masked_kernel",
                         "tc_flash_sparse_kernel"):
                for d in (192, 256):
                    if spills:
                        check("0 bytes spill stores, 0 bytes spill loads"
                              in spills.get((kern, d), ""),
                              f"{kern}<{d}> spills: {spills.get((kern, d))}")
            continue
        rows = kernel_resources(r["log"])
        for kern, used, spills in rows:
            print(f"  {name} {kern}: {used}; {spills}")
        if name == "decode_attention":
            # D1's twelve instances at D 192 (nemotron-4-340b): four dtype
            # pairings x the one-launch mode and the split mode's two,
            # spill-free
            d192 = [sp for kern, _, sp in rows
                    if "192>" in kern or "Li192E" in kern]
            if not rows:
                print("  decode_attention: the D 192 spill check was NOT "
                      "run (no compiler report)")
            check(not rows or (len(d192) == 12 and all(
                "0 bytes spill stores, 0 bytes spill loads" in sp
                for sp in d192)), f"decode_attention<192> spills: {d192}")
    from repro_torch.kernels import tuning
    from repro_torch.kernels.spmspm import kernel as pk
    rt, ct = tuning.spmspm_tiles(SPMSPM_N, SPMSPM_N, 1, 1, device="cuda")
    nt = tuning.spmspm_nt(SPMSPM_N, ct, 1, device="cuda")
    smem = pk.product_smem_bytes(rt, nt * ct)
    print(f"  spmspm_ell spmspm_row_kernel: {smem} bytes dynamic smem at "
          f"rt {rt}, W {nt * ct}")
    _flash_sass()


def _random_stream(rng, B, gm, gn, block, empty_rows, pad, dtype, device):
    import numpy as np
    import torch
    from repro_torch.core.formats import BatchedBCSR
    bm, bk = block
    mask = rng.random((gm, gn)) < 0.35
    mask[list(empty_rows)] = False
    rows, cols = np.nonzero(mask)
    indptr = np.zeros(gm + 1, np.int32)
    np.cumsum(mask.sum(1), out=indptr[1:])
    blocks = rng.standard_normal((B, len(rows), bm, bk)).astype(np.float32)
    a = BatchedBCSR(
        indptr=torch.from_numpy(indptr).to(device),
        block_rows=torch.from_numpy(rows.astype(np.int32)).to(device),
        block_cols=torch.from_numpy(cols.astype(np.int32)).to(device),
        blocks=torch.from_numpy(blocks).to(device=device, dtype=dtype),
        shape=(B, gm * bm, gn * bk), block=block)
    return a.with_capacity(a.nnzb + pad)


def phase_kernel_vs_plain():
    """Random streams through the kernel and its plain version, on the card.
    Tolerances: f32 output within 1e-5 of the largest |value| (the block
    product's terms are summed in another order); bf16 output within one
    bf16 ulp of the largest |value| (a product that rounds to the other side
    of a bf16 tie moves one ulp)."""
    import numpy as np
    import torch
    from repro_torch.kernels.spmm.kernel import spmm_bcsr
    from repro_torch.kernels.spmm.ref import spmm_bcsr_ref
    rng = np.random.default_rng(0)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (B, gm, gn, block, empty rows, pad, in dtype, out dtype, N)
        (3, 12, 10, (8, 8), (2, 7), 5, f32, f32, 300),
        (2, 9, 6, (8, 16), (0,), 3, f32, f32, 1000),
        (3, 12, 10, (8, 8), (2, 7), 5, bf16, bf16, 300),
        (2, 9, 6, (8, 16), (8,), 7, bf16, bf16, 1000),
        (2, 10, 8, (8, 8), (4,), 4, bf16, f32, 5120 + 40),
        (2, 6, 12, (16, 8), (1,), 2, bf16, bf16, 520),
        (2, 5, 3, (16, 32), (1,), 2, f32, f32, 1001),
        (2, 7, 40, (8, 1), (3,), 6, bf16, f32, 1001),   # last: bf16 dense
    ]
    for B, gm, gn, block, empty, pad, dt, odt, N in cases:
        a = _random_stream(rng, B, gm, gn, block, empty, pad, dt, "cuda")
        dense = torch.from_numpy(rng.standard_normal(
            (B, gn * block[1], N)).astype(np.float32)).to("cuda", dt)
        got = spmm_bcsr(a.indptr, a.block_cols, a.blocks, dense,
                        out_dtype=odt, bn=256)
        want = spmm_bcsr_ref(a.indptr, a.block_cols, a.blocks, dense,
                             out_dtype=odt)
        err = max_err(got, want, f"K2 block {block}")
        rows = got.view(B, gm, block[0], N)
        check(all(rows[:, r].abs().max().item() == 0 for r in empty),
              "an empty block-row is not zero")
        print(f"  K2 {str(dt)[6:]}->{str(odt)[6:]} block {block} B={B} "
              f"nnzb={a.nnzb} N={N}: max_abs_err {err:.3g}")
    for bad in (128, 384, 256 * 9):    # bn off the bf16 column unit (256)
        try:
            spmm_bcsr(a.indptr, a.block_cols, a.blocks, dense, bn=bad)
        except ValueError:
            continue
        check(False, f"K2 took bn {bad} for bf16 dense")
    print("  K2 refuses bn 128, 384 and 2304 for bf16 dense")


def _mask_zoo(S: int, t: int) -> dict:
    """The reference's pattern zoo (``tests/test_attention_sparse.py``) on
    an S x S score grid of t x t tiles."""
    from repro_torch.core.masks import BlockMask as BM
    kw = dict(bq=t, bk=t)
    local = BM.sliding_window(S, S, 3 * t, **kw)
    return {"causal": BM.causal(S, S, **kw),
            "window": BM.sliding_window(S, S, 2 * t, **kw),
            "strided": BM.strided(S, S, 2, **kw),
            "global": BM.global_cols(S, S, 1, **kw),
            "local|global": local | BM.global_cols(S, S, 1, **kw),
            "strided&causal": BM.strided(S, S, 2, **kw) & BM.causal(S, S, **kw)}


def _attention_f64(q, k, v, causal: bool):
    """Softmax attention in f64 on the host, GQA by repeated KV heads: the
    oracle against which both sides of a kernel-vs-plain check are read."""
    import torch
    q, k, v = (x.cpu().double() for x in (q, k, v))
    g = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    s = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1),
                          float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def _ops_plain(q, k, v, **kw):
    """What ``ops.attention(q, k, v, **kw)`` computes for CPU tensors -- the
    same padding and tiles, then the kernel's plain version (``ref.py``) --
    on the tensors' own device.  On the card it holds a kernel reached
    through ``ops`` against its plain version on the card, as the other
    kernel-vs-plain checks do, and not against the host CPU's product,
    which on some hosts drifted 100x further from the f64 oracle."""
    from repro_torch.kernels.flash_attention import ops, ref
    Sq, Skv = q.shape[2], k.shape[2]
    m = kw.get("mask")
    if m is None:
        bq, bk = ops.tiles(q, k, kw.get("bq"), kw.get("bk"))
        kp = (-Skv) % bk
        out = ref.flash_attention_ref(
            ops.pad_seq(q, (-Sq) % bq), ops.pad_seq(k, kp),
            ops.pad_seq(v, kp), causal=kw.get("causal", True),
            window=kw.get("window"), bq=bq, bk=bk, skv=Skv)
        return out[:, :, :Sq]
    kp = m.n_kv_tiles * m.bk - Skv
    qq, kk, vv = (ops.pad_seq(q, m.n_q_tiles * m.bq - Sq),
                  ops.pad_seq(k, kp), ops.pad_seq(v, kp))
    if kw["mask_impl"] == "dense":
        out = ref.flash_attention_masked_ref(
            qq, kk, vv, m.tile_kinds, skv=Skv, window=m.window,
            q_offset=m.q_offset)
    else:
        s = m.lower(bucket=True)
        out = ref.flash_attention_sparse_ref(
            qq, kk, vv, s.rows, s.cols, s.kinds, skv=Skv, window=m.window,
            bq=m.bq, bk=m.bk, q_offset=m.q_offset)
    return out[:, :, :Sq]


def phase_attention_vs_plain():
    """K3, K4m and K4s against their plain versions (``ref.py``, the same
    tile loop in PyTorch) on random q, k, v on the card, with the
    tolerances of :func:`tolerance`, and the kernels' laws as
    ``torch.equal``."""
    import numpy as np
    import torch
    from repro_torch.core.masks import BlockMask
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops, ref
    rng = np.random.default_rng(2)
    ops.reset_fallbacks()
    for dt in (torch.float32, torch.bfloat16):
        for B, Hq, Hkv, S, D, t in ((2, 4, 2, 256, 64, 32),
                                    (1, 40, 8, 512, 128, 64),
                                    (1, 4, 2, 128, 16, 16),
                                    (1, 16, 8, 512, 256, 64),
                                    (1, 12, 1, 512, 192, 64),
                                    (1, 96, 8, 256, 192, 64)):
            q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to("cuda", dt) for shape in
                ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
            errs = {"K3": 0.0, "K4m": 0.0, "K4s": 0.0}

            def note(name, got, want, what):
                errs[name] = max(errs[name], max_err(got, want, what))

            for pattern, m in _mask_zoo(S, t).items():
                kw = dict(skv=S, window=m.window)
                walks = [fk.flash_attention_sparse(
                    q, k, v, s.rows, s.cols, s.kinds, bq=t, bk=t, **kw)
                    for s in (m.lower(bucket=True), m.lower(bucket=False))]
                s = m.lower(bucket=True)
                note("K4s", walks[0], ref.flash_attention_sparse_ref(
                    q, k, v, s.rows, s.cols, s.kinds, bq=t, bk=t, **kw),
                    f"K4s {pattern}")
                grid = fk.flash_attention_masked(q, k, v, m.tile_kinds, **kw)
                note("K4m", grid, ref.flash_attention_masked_ref(
                    q, k, v, m.tile_kinds, **kw), f"K4m {pattern}")
                check(torch.equal(walks[0], walks[1]),
                      f"{pattern}: bucketed stream != unbucketed")
                check(torch.equal(walks[0], grid), f"{pattern}: K4s != K4m")
            for window, q_off in ((None, 0), (3 * t, 0), (None, S // 2),
                                  (2 * t, S // 2)):
                qs = q[:, :, q_off:].contiguous()   # rows from q_off, all keys
                kw = dict(causal=True, window=window, bq=t, bk=t,
                          q_offset=q_off)
                got = fk.flash_attention(qs, k, v, **kw)
                note("K3", got, ref.flash_attention_ref(qs, k, v, **kw),
                     f"K3 window={window} q_offset={q_off}")
                s = BlockMask.full(S - q_off, S, bq=t, bk=t, causal=True,
                                   window=window, q_offset=q_off).lower()
                law = fk.flash_attention_sparse(
                    qs, k, v, s.rows, s.cols, s.kinds, skv=S, window=window,
                    bq=t, bk=t, q_offset=q_off)
                check(torch.equal(law, got),
                      f"K4s on the causal mask != K3 (window={window}, "
                      f"q_offset={q_off})")
            # ragged S through ops.attention: padding, re-clamp, KV tail
            # (masked inside the kernel, causal or not)
            Sr = S - 56
            qr, kr, vr = (x[:, :, :Sr] for x in (q, k, v))
            m = (BlockMask.sliding_window(Sr, Sr, 2 * t, bq=t, bk=t)
                 | BlockMask.global_cols(Sr, Sr, 1, bq=t, bk=t))
            for name, kw in (("K3", dict(causal=True, bq=t, bk=t)),
                             ("K3", dict(causal=False, bq=t, bk=t)),
                             ("K4s", dict(mask=m, mask_impl="sparse")),
                             ("K4m", dict(mask=m, mask_impl="dense"))):
                want = _ops_plain(qr, kr, vr, **kw)
                got = ops.attention(qr, kr, vr, **kw)
                if "causal" in kw:
                    # the kernel, its plain version on the card and the
                    # host CPU's plain version each against an f64 oracle,
                    # printed before the check, so a disagreement shows
                    # which side moved; and the card's result repeats bit
                    # for bit
                    host = ops.attention(qr.cpu(), kr.cpu(), vr.cpu(), **kw)
                    exact = _attention_f64(qr, kr, vr, kw["causal"])
                    card_err, plain_err, cpu_err = (
                        (x.cpu().double() - exact).abs().max().item()
                        for x in (got, want, host))
                    print(f"    K3 via ops, S={Sr} causal={kw['causal']}: vs "
                          f"f64, card {card_err:.3g}, plain on the card "
                          f"{plain_err:.3g}, host cpu {cpu_err:.3g}")
                    check(all(torch.equal(ops.attention(qr, kr, vr, **kw),
                                          got) for _ in range(8)),
                          f"K3 via ops, S={Sr}: the card's result varies")
                note(name, got, want,
                     f"{name} via ops, S={Sr} {kw.get('causal', 'mask')}")
            # a ragged non-causal KV against the materialized oracle, which
            # sums in another order (so twice the tolerance): the padded
            # keys stay invisible
            got = ops.attention(qr, kr, vr, causal=False, bq=t, bk=t)
            want = ref.attention_ref(qr, kr, vr, causal=False)
            check((got.float() - want.float()).abs().max().item()
                  <= 2 * tolerance(want.float().abs().max().item(), dt),
                  f"K3 non-causal ragged KV (S={Sr}) != the oracle")
            print(f"  flash {str(dt)[6:]} B={B} heads {Hq}/{Hkv} S={S} D={D} "
                  f"tiles {t}: max_abs_err " + " ".join(
                      f"{n} {e:.3g}" for n, e in errs.items())
                  + "; K4s == K4m, bucketed == unbucketed, K4s(causal) == K3")
        _gemma_window_case(rng, dt)
    check(ops.fallback_count() == 0,
          f"attention fell back to the oracle: {ops.fallback_reasons()}")
    x = torch.zeros((1, 2, 64, 96), dtype=torch.bfloat16, device="cuda")
    try:
        fk.flash_attention(x, x, x, causal=True, bq=64, bk=64)
        check(False, "K3 took head dim 96")
    except ValueError:
        print("  K3 refuses head dim 96")


GEMMA_WINDOW_S = 1500        # ragged: padded to 24 tiles of 64


def _gemma_window_case(rng, dt):
    """gemma3-12b's local attention at D 256: 16/8 heads, a ragged 1,500
    tokens, the sliding window of 1,024 through ``ops.attention`` as the
    model calls it -- K3 causal with the window, K4s and K4m on the
    serving's sliding-window mask -- each against its plain version on the
    card (:func:`_ops_plain`, its own tiles, within :func:`tolerance`); K4s == K4m and K4s == K3 as
    ``torch.equal`` (one tile update, the same 64 x 64 tiles)."""
    import numpy as np
    import torch
    from repro_torch.core.masks import BlockMask
    from repro_torch.kernels.flash_attention import ops
    S, W = GEMMA_WINDOW_S, 1024
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", dt) for shape in
        ((1, 16, S, 256), (1, 8, S, 256), (1, 8, S, 256)))
    m = BlockMask.sliding_window(S, S, W, bq=64, bk=64)
    got, errs = {}, {}
    for name, kw in (("K3", dict(causal=True, window=W)),
                     ("K4s", dict(mask=m, mask_impl="sparse")),
                     ("K4m", dict(mask=m, mask_impl="dense"))):
        got[name] = ops.attention(q, k, v, **kw)
        want = _ops_plain(q, k, v, **kw)
        errs[name] = max_err(got[name], want,
                             f"{name} D 256 window {W} S={S}")
    check(torch.equal(got["K4s"], got["K4m"]), "D 256: K4s != K4m")
    check(torch.equal(got["K4s"], got["K3"]),
          "D 256: K4s on the sliding mask != K3 with the window")
    print(f"  flash {str(dt)[6:]} D 256 16/8 S={S} window {W} (tiles 64, "
          f"{m.nnzb}/{m.n_q_tiles * m.n_kv_tiles} visible): max_abs_err "
          + " ".join(f"{n} {e:.3g}" for n, e in errs.items())
          + "; K4s == K4m == K3(window)")


# D1 vs plain: (Hq, Hkv, D, q dtype, cache dtype, window, cache) -- scout's
# 40/8 at D 128, the flash phase's 4/2 at D 64 and 16, each dtype pairing,
# windows, in 544-position caches; then rows up to 2,064 positions (up to
# 65 chunks of 32, 9 a CTA), a window of 100 (lo off a chunk boundary), a
# full group of 8, and a 16,400-position cache whose longest rows pass the
# CTAs' shared score budget (13,056 positions at g 5: pass 2 recomputes);
# then gemma3-12b's 16/8 at D 256: a ring of 1,024 slots (every filled
# slot visible, no window) and its 2,064-position full cache under the
# window of 1,024 (per-row kv_len on both sides of the window); then
# nemotron-4-340b's head dim 192: its 96/8 heads (a group of 12, taken in
# passes of 8 and 4) at the served cache of 1,056, bf16 and f32 with a
# window, groups of 6 and 2 in 2,064-position caches, and a group of 12 in
# a 16,400-position cache past the score budget (the 8-head pass
# recomputes where the 4-head one may hold); then zamba2-1.2b's shared
# block, 32/32 heads of 64 (a GQA group of 1: a cluster a (row, head),
# seven in eight of a warp's score lanes idle) at its served cache of
# 2,080 (bf16, f32 with a window) and the scheduler's 1,088 under an f32
# cache
DECODE_CASES = (
    (40, 8, 128, "bfloat16", "bfloat16", None, 544),
    (40, 8, 128, "bfloat16", "bfloat16", 300, 544),
    (40, 8, 128, "bfloat16", "float32", None, 544),
    (40, 8, 128, "float32", "float32", 64, 544),
    (4, 2, 64, "bfloat16", "bfloat16", 7, 544),
    (4, 2, 64, "float32", "bfloat16", None, 544),
    (4, 2, 16, "float32", "float32", None, 544),
    (4, 2, 16, "bfloat16", "bfloat16", 5, 544),
    (40, 8, 128, "bfloat16", "bfloat16", None, 2064),
    (40, 8, 128, "bfloat16", "bfloat16", 100, 2064),
    (64, 8, 64, "bfloat16", "float32", None, 2064),
    (40, 8, 128, "bfloat16", "bfloat16", None, 16400),
    (16, 8, 256, "bfloat16", "bfloat16", None, 1024),
    (16, 8, 256, "float32", "float32", None, 1024),
    (16, 8, 256, "bfloat16", "bfloat16", 1024, 2064),
    (16, 8, 256, "bfloat16", "float32", 1024, 2064),
    (96, 8, 192, "bfloat16", "bfloat16", None, 1056),
    (96, 8, 192, "float32", "float32", 300, 1056),
    (12, 2, 192, "bfloat16", "float32", None, 2064),
    (16, 8, 192, "float32", "bfloat16", 100, 2064),
    (24, 2, 192, "bfloat16", "bfloat16", None, 16400),
    (32, 32, 64, "bfloat16", "bfloat16", None, 2080),
    (32, 32, 64, "float32", "float32", 300, 2080),
    (32, 32, 64, "bfloat16", "float32", None, 1088),
)
DECODE_ROWS, DECODE_CAP_MORE = 16, 1520    # the larger cache: S + 1,520
BATCH_LAW = (1, 2, 3, 4, 8, 16)
# R1 at d 5120 x E 16: every tile regime of ``tuning.router_tiles`` and its
# edges (the few-token kernel up to 64 tokens, the many-token one above,
# one wave of blocks from ~1,000), x and W in each dtype pairing; then
# (T, d, E, shift): d 40,960 (past the earlier kernel's cap), E 5 (W rows
# not whole 16-byte pieces: W staged by the threads), d 200 (a ragged lane
# step and chunk), E 128 (experts split), d 201 and 202 (x rows not whole
# 16-byte pieces: x staged by the threads) and x and W each `shift`
# elements past an aligned start (both staged by the threads at d 5120)
ROUTER_TOKENS = tuple(sorted(set(BATCH_LAW) | {
    1, 4, 8, 64, 65, 1000, 1024, 8191, 8192}))
ROUTER_PAIRS = (("bfloat16", "float32"), ("float32", "float32"),
                ("bfloat16", "bfloat16"), ("float32", "bfloat16"))
ROUTER_SHAPES = ((4, 40960, 16, 0), (65, 40960, 16, 0), (4, 200, 5, 0),
                 (1000, 200, 5, 0), (8, 5120, 128, 0), (1024, 5120, 128, 0),
                 (1000, 202, 16, 0), (1000, 201, 16, 0), (4, 201, 16, 1),
                 (1000, 201, 16, 1), (1000, 5120, 16, 1))


def decode_tolerance(big: float, q_dtype, cache_dtype) -> float:
    """D1 vs plain: one ulp at the largest |value| of the narrowest dtype
    the function rounds to (q's, or the cache's, to which p is cast: a
    score summed in another order can round a p to the neighbouring
    value); f32 throughout: 1e-5 of the largest |value|."""
    import torch
    narrow = [t for t in (q_dtype, cache_dtype) if t != torch.float32]
    return tolerance(big, narrow[0] if narrow else torch.float32)


def _rows_alone_equal(fn, rows_fn, sizes=BATCH_LAW) -> bool:
    """Row i of ``fn(*rows_fn(0, B))`` is ``torch.equal`` to ``fn`` of row
    i alone, for every B of ``sizes`` and every i < B."""
    import torch
    alone = [fn(*rows_fn(i, i + 1)) for i in range(max(sizes))]
    return all(torch.equal(fn(*rows_fn(0, B))[i:i + 1], alone[i])
               for B in sizes for i in range(B))


def _router_case(x, w, what: str):
    """R1 on (x, w): within 1e-5 of the plain product's largest |logit|
    (:func:`max_err`) and ``torch.equal`` to its emulated order.  Returns
    (logits, error)."""
    import torch
    from repro_torch.kernels.router import kernel as rk
    from repro_torch.kernels.router import ref as rref
    got = rk.router_logits(x, w)
    err = max_err(got, rref.router_logits_ref(x, w), what)
    check(torch.equal(got, rref.router_logits_ordered(x, w)),
          f"{what}: kernel != its emulated order")
    return got, err


def _decode_group1_int8(rand) -> None:
    """D1 at zamba2-1.2b's shared block (32/32 heads of 64, a group of 1)
    on an int8 KV cache as decode feeds it: K / V quantized per position
    (``precision.quantize_rows``) and dequantized to bf16, per-row lengths;
    == its emulated order, within :func:`decode_tolerance` of plain, rows
    == alone."""
    import numpy as np
    import torch
    from repro_torch.core import precision
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref
    B, H, D, S = DECODE_ROWS, 32, 64, 2080
    q = rand((B, H, 1, D), torch.bfloat16)
    k, v = (precision.dequantize_rows(*precision.quantize_rows(
        rand((B, H, S, D), torch.bfloat16), "int8", check=False),
        torch.bfloat16) for _ in range(2))
    lens = np.random.default_rng(35).integers(1, S + 1, B)
    lens[:2] = (1, S)
    kv = torch.from_numpy(lens).cuda()
    got = fk.decode_attention(q, k, v, kv_len=kv)
    want = ref.decode_attention_ref(q, k, v, kv_len=kv)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = decode_tolerance(want.float().abs().max().item(), q.dtype, k.dtype)
    what = f"D1 {H}/{H} D {D} int8 cache dequantized to bf16, cache {S}"
    check(err <= tol, f"{what}: kernel disagrees with plain: {err} > {tol}")
    check(torch.equal(ref.decode_attention_ordered(q, k, v, kv_len=kv),
                      got), f"{what}: kernel != its emulated order")
    check(_rows_alone_equal(
        lambda *t: fk.decode_attention(*t[:3], kv_len=t[3]),
        lambda a, b: (q[a:b], k[a:b], v[a:b], kv[a:b])),
        f"{what}: a row depends on its batch")
    print(f"  {what}: max_abs_err {err:.3g} (tol {tol:.3g}); == its "
          f"emulated order; rows of B {BATCH_LAW} == alone")


def phase_decode_vs_plain():
    """D1 (``decode_attention``) and R1 (``router_logits``) against their
    plain versions on the card, and their laws as ``torch.equal``.  D1 on
    :data:`DECODE_CASES`, 16 rows of the case's cache (544, 2,064 or
    16,400 positions), per-row ``kv_len`` including 1, 2 and the capacity,
    and two vacant rows (zero K / V at ``kv_len`` 1, as the scheduler
    leaves them), within :func:`decode_tolerance`; the laws: row i of B in
    BATCH_LAW rows == the row alone, the same rows in a cache 1,520
    positions larger (544 -> 2,064) == in the case's, a scalar ``kv_len``
    == a vector of equal values, and the kernel == its order emulated in
    PyTorch (``ref.decode_attention_ordered`` on the card, whose rows the
    CPU tests hold to the same laws).  The cases must reach every part of
    D1's partition: CTAs with several chunks, ``kv_len`` 1 (one CTA busy),
    a window's lo off a chunk boundary, scores past the shared budget.  R1
    on scout's router shape (d 5120, E 16; x and W f32 or bf16, the four
    pairings) at the :data:`ROUTER_TOKENS` token counts (every tile regime
    and its edges) and at :data:`ROUTER_SHAPES`, within 1e-5 of the largest
    |logit| (the kernel sums in another order than the library); the laws:
    the kernel == its emulated order (``router.ref.router_logits_ordered``)
    at every count and shape, and row i at every count == token i alone.
    A CUDA tensor of a dtype or head dim the kernel lacks raises."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.router import kernel as rk
    rng = np.random.default_rng(11)

    def rand(shape, dt):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", dt)

    B = DECODE_ROWS
    C, R = ref.DECODE_CHUNK, ref.DECODE_CTAS
    reached = set()
    for Hq, Hkv, D, qn, cn, window, S in DECODE_CASES:
        lens = rng.integers(1, S + 1, B)
        lens[:5] = (1, S, 2, S - 1, 1)
        kv = torch.from_numpy(lens).cuda()
        lo = np.maximum(lens - window, 0) if window else np.zeros_like(lens)
        most = -(-(np.minimum(lens, S) - lo) // (C * R)) * C   # a CTA's
        reached |= {"several chunks a CTA"} if (most > C).any() else set()
        reached |= {"kv_len 1"} if (lens == 1).any() else set()
        reached |= ({"lo off a chunk"} if ((lo > 0) & (lo % C > 0)).any()
                    else set())
        heads = min(Hq // Hkv, ref.DECODE_PASS_HEADS)    # the first pass
        past = int((heads * most * 4 > ref.DECODE_SCORE_BYTES).sum())
        reached |= {"scores recomputed"} if past else set()
        qdt, cdt = getattr(torch, qn), getattr(torch, cn)
        q = rand((B, Hq, 1, D), qdt)
        k, v = rand((B, Hkv, S, D), cdt), rand((B, Hkv, S, D), cdt)
        k[4].zero_()                                 # vacant rows
        v[4].zero_()
        kw = dict(kv_len=kv, window=window)
        got = fk.decode_attention(q, k, v, **kw)
        want = ref.decode_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        big = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        tol = decode_tolerance(big, qdt, cdt)
        what = (f"D1 {Hq}/{Hkv} D {D} q {qn} cache {cn} window {window} "
                f"cache {S}")
        check(err <= tol, f"{what}: kernel disagrees with plain: {err} > "
                          f"{tol}")
        check(torch.equal(fk.decode_attention(q, k, v, **kw), got),
              f"{what}: two launches differ")
        check(_rows_alone_equal(
            lambda *t: fk.decode_attention(*t[:3], kv_len=t[3],
                                           window=window),
            lambda a, b: (q[a:b], k[a:b], v[a:b], kv[a:b])),
            f"{what}: a row depends on its batch")
        big_k = torch.zeros((B, Hkv, S + DECODE_CAP_MORE, D), dtype=cdt,
                            device="cuda")
        big_v = torch.zeros_like(big_k)
        big_k[:, :, :S], big_v[:, :, :S] = k, v
        check(torch.equal(fk.decode_attention(q, big_k, big_v, **kw), got),
              f"{what}: the result depends on the cache's capacity")
        del big_k, big_v
        n = int(lens[5])
        check(torch.equal(
            fk.decode_attention(q, k, v, kv_len=n, window=window),
            fk.decode_attention(q, k, v, kv_len=torch.full(
                (B,), n, device="cuda"), window=window)),
            f"{what}: scalar kv_len != a vector of equal values")
        check(torch.equal(ref.decode_attention_ordered(q, k, v, **kw), got),
              f"{what}: kernel != its emulated order")
        g = Hq // Hkv
        if g > ref.DECODE_PASS_HEADS:
            # the passes change no bit: kv head 1's heads == the same heads
            # in a pass of their own and each head alone (a group of 1)
            k1, v1 = k[:, 1:2].contiguous(), v[:, 1:2].contiguous()
            P = ref.DECODE_PASS_HEADS
            for lo_h, hi_h in [(j, min(j + P, g)) for j in range(0, g, P)] \
                    + [(i, i + 1) for i in range(g)]:
                hs = slice(g + lo_h, g + hi_h)
                check(torch.equal(fk.decode_attention(
                    q[:, hs].contiguous(), k1, v1, **kw), got[:, hs]),
                    f"{what}: heads {lo_h}-{hi_h - 1} of kv head 1 alone "
                    "!= in the group")
            reached.add("a group in passes")
        print(f"  {what}: max_abs_err {err:.3g} (tol {tol:.3g}); == its "
              f"emulated order; rows of B {BATCH_LAW} == alone, cache {S} == "
              f"{S + DECODE_CAP_MORE}, scalar == vector kv_len; {past} of "
              f"{B} rows recompute their scores")
        del q, k, v, want, got
    check(reached == {"several chunks a CTA", "kv_len 1", "lo off a chunk",
                      "scores recomputed", "a group in passes"},
          f"D1's cases reach only {sorted(reached)} of the partition")
    _decode_group1_int8(rand)
    for bad, why in (((torch.float16, torch.float16, 128, 4), "float16"),
                     ((torch.bfloat16, torch.bfloat16, 32, 4),
                      "head dim 32"),
                     ((torch.bfloat16, torch.bfloat16, 96, 4),
                      "head dim 96"),
                     ((torch.bfloat16, torch.bfloat16, 128, 34),
                      "a GQA group of 17")):
        qdt, cdt, D, Hq = bad
        try:
            fk.decode_attention(rand((2, Hq, 1, D), qdt),
                                rand((2, 2, 8, D), cdt),
                                rand((2, 2, 8, D), cdt), kv_len=3)
        except (TypeError, ValueError):
            continue
        check(False, f"D1 took {why}")
    print("  D1 refuses float16, head dims 32 and 96 and a GQA group of 17")

    d, E = 5120, 16
    for xn, wn in ROUTER_PAIRS:
        xdt, wdt = getattr(torch, xn), getattr(torch, wn)
        x = rand((max(ROUTER_TOKENS), d), xdt)
        w = rand((d, E), wdt) * d ** -0.5
        alone = torch.cat([rk.router_logits(x[i:i + 1], w)
                           for i in range(x.shape[0])])
        errs = []
        for T in ROUTER_TOKENS:
            what = f"R1 x {xn} W {wn} T {T}"
            got, err = _router_case(x[:T], w, what)
            check(torch.equal(got, alone[:T]),
                  f"{what}: a row differs from the row alone")
            errs.append(err)
        print(f"  R1 x {xn} W {wn} ({d} x {E}), T {ROUTER_TOKENS}: "
              f"max_abs_err {max(errs):.3g}; each == its emulated order; "
              "rows == alone at every T")
        for T, dd, ee, sh in ROUTER_SHAPES:
            xs = rand((T * dd + sh,), xdt)[sh:].view(T, dd)
            ws = (rand((dd * ee + sh,), wdt) * dd ** -0.5)[sh:].view(dd, ee)
            _, err = _router_case(xs, ws, f"R1 x {xn} W {wn} {T} x {dd} x "
                                          f"{ee}, shift {sh}")
            errs.append(err)
        print(f"  R1 x {xn} W {wn} at (T, d, E, shift) {ROUTER_SHAPES}: "
              f"max_abs_err {max(errs):.3g}; each == its emulated order")
    # llama4-maverick's router as served (x bf16, W f32, 128 experts): the
    # few-token kernel's 64-block expert grid and the many-token kernel's
    # 16-expert tile at each token count, rows == alone
    E = 128
    x = rand((max(ROUTER_TOKENS), d), torch.bfloat16)
    w = rand((d, E), torch.float32) * d ** -0.5
    alone = torch.cat([rk.router_logits(x[i:i + 1], w)
                       for i in range(x.shape[0])])
    errs = []
    for T in ROUTER_TOKENS:
        what = f"R1 x bfloat16 W float32 E {E} T {T}"
        got, err = _router_case(x[:T], w, what)
        check(torch.equal(got, alone[:T]),
              f"{what}: a row differs from the row alone")
        errs.append(err)
    print(f"  R1 x bfloat16 W float32 ({d} x {E}), T {ROUTER_TOKENS}: "
          f"max_abs_err {max(errs):.3g}; each == its emulated order; rows "
          "== alone at every T")
    try:
        rk.router_logits(rand((4, 64), torch.float16), rand((64, 4),
                                                            torch.float32))
        check(False, "R1 took float16")
    except TypeError:
        print("  R1 refuses float16")


def _bcsr_moe():
    """The two-phase MoE stage (route, then execute through K2) as the
    ``moe_fn`` of the model's layered prefill."""
    import functools
    from repro_torch.models import moe
    return functools.partial(moe.apply_moe, dispatch="bcsr")


def phase_small_config_card_vs_cpu():
    """The llama4-scout SMOKE config in f32: prefill logits on the card
    (kernel paths) agree with the CPU (plain paths) within 1e-4, with the
    chunked attention, with the masked stream walk (K4s; local_global, tiles
    and window 8) and with K3 (``impl="kernel"``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core.masks import AttnMaskSpec
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_smoke("llama4-scout-17b-a16e"), policy="f32")
    cpu = M.init_params(cfg, seed=0, device="cpu")
    gpu = _tree_to(cpu, "cuda")
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)))
    mask = AttnMaskSpec(local=True, pattern="local_global", window=8, bq=8,
                        bk=8, impl="sparse")
    for label, kw, kernel in (
            ("chunked", {}, None),
            ("attn_mask sparse", {"attn_mask": mask}, "flash_attention_sparse"),
            ("impl=kernel", {"impl": "kernel"}, "flash_attention")):
        want, _, _ = M.prefill_layered(cpu, prompts, cfg, max_seq=32,
                                       moe_fn=_bcsr_moe(), **kw)
        reset_launches()
        got, _, _ = M.prefill_layered(gpu, prompts.cuda(), cfg, max_seq=32,
                                      moe_fn=_bcsr_moe(), **kw)
        launches = read_launches()
        err = (got.cpu() - want).abs().max().item()
        print(f"  smoke f32 prefill logits card vs cpu, {label}: max_abs_err "
              f"{err:.3g}; launches {launches}")
        check(bool(torch.isfinite(got).all()) and err <= 1e-4,
              f"card and cpu disagree on the smoke config ({label}): {err}")
        check(kernel is None or launches[kernel] == cfg.n_repeats,
              f"{label}: {kernel} ran {launches} times, not once a layer")
        check(launches["router_logits"] == cfg.n_repeats,
              f"{label}: R1 ran {launches} times, not once a MoE layer")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_to(v, device) for v in tree)
    return tree.to(device)


def phase_slice(arch: str = SCOUT_ARCH):
    """The serving slice of the MoE arch ``arch`` at full width, its depth
    cut to ``DEPTH[arch]`` block-unit repeats (the cut printed)."""
    import numpy as np
    import torch
    from repro_torch.kernels import engine
    from repro_torch.launch.serve import ServeLoop
    from repro_torch.models import model as M

    cfg, full, cut = served_config(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in _tensors(params)) / 1e9
    print(f"slice: {cfg.name} d={cfg.d_model} heads={cfg.n_heads}/"
          f"{cfg.n_kv_heads} d_ff={cfg.d_ff} E={cfg.n_experts} "
          f"vocab={cfg.vocab_size} block_unit={cfg.block_unit}; {cut} "
          f"policy={cfg.policy}; params {gb:.1f} "
          f"GB, init {time.monotonic() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=g,
                            device="cuda")
    max_seq = PROMPT + GEN
    loop = ServeLoop(params, cfg, max_seq=max_seq, dispatch="bcsr")
    loop.run(prompts, 2)                      # warm-up: allocator, cuBLAS

    captured = []
    stream_entry = engine.spmm_batched_stream

    def capture(a, dense, **kw):        # keep the first and the last call
        del captured[1:]
        captured.append((a, dense, kw))
        return stream_entry(a, dense, **kw)

    decode_calls = {}

    def keep(name, args, kw):   # R1's first call (prefill), the last ones
        if name == "attention":
            return
        if name == "decode_attention":
            decode_calls["d1_decode"] = (args, kw)
        elif "r1_prefill" not in decode_calls:
            decode_calls["r1_prefill"] = (args, kw)
        else:
            decode_calls["r1_decode"] = (args, kw)

    engine.spmm_batched_stream = capture
    reset_launches()
    try:
        with hook_calls(keep), no_plain(), keep_row_sum() as norm:
            tokens = loop.run(prompts, GEN)   # the main path
    finally:
        engine.spmm_batched_stream = stream_entry
    check(norm.x is not None and tuple(norm.x.shape) == (
        BATCH, 1, cfg.d_model), "the first decode norm was not captured")
    decode_calls["r1_norm"] = norm.x
    counts = read_launches()
    launches = counts["spmm_bcsr"]
    summary = loop.summary()
    n_moe = cfg.block_unit.count("attn+moe") * cfg.n_repeats
    print(f"  bcsr run: {launches} K2 launches, "
          f"{summary['execute']['calls']} execute calls, tokens "
          f"{tokens[0, :8].tolist()} ...")
    check(tokens.shape == (BATCH, GEN) and (tokens >= 0).all()
          and (tokens < cfg.vocab_size).all(), "bad token ids")
    check(launches == n_moe * GEN == summary["execute"]["calls"],
          f"K2 launches {launches} != {n_moe} layers x {GEN} passes")
    want = decode_counts(cfg, 1, GEN - 1, spmm_bcsr=launches)
    check(counts == want, f"launches {counts} != {want} (a flash kernel in "
                          "unmasked chunked serving, or D1 / R1 missed)")
    pipelined = phase_pipelined(cfg, params, prompts, loop, tokens, summary)

    # the same prompts' prefill logits are finite and pick the first token
    logits, _, _ = M.prefill_layered(params, prompts, cfg, max_seq=max_seq,
                                     moe_fn=_bcsr_moe())
    check(tuple(logits.shape) == (BATCH, 1, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()), "prefill logits not finite")
    first = logits[:, -1, :cfg.vocab_size].argmax(-1).cpu().numpy()
    check(np.array_equal(first, tokens[:, 0]), "prefill argmax != token 0")

    gather = ServeLoop(params, cfg, max_seq=max_seq, dispatch="gather")
    reset_launches()
    with no_plain():
        g_tokens = gather.run(prompts, GEN)
    check(read_launches() == decode_counts(cfg, 1, GEN - 1),
          f"gather launched {read_launches()}: K2, or not D1 / R1")
    check(np.array_equal(g_tokens, tokens), "bcsr tokens != gather tokens")
    print("  gather run: tokens equal to bcsr; D1 and R1, no K2")
    pipelined["fused"] = phase_fused_moe(cfg, params, prompts, tokens, gather)
    return cfg, params, summary, counts, captured, pipelined, decode_calls


def phase_fused_moe(cfg, params, prompts, tokens, gather):
    """Phase 5's fused mode at 4 x 256 (``ServeLoop``'s default for gather:
    ``model.prefill``, then the decode step replayed as one CUDA graph).
    ``gather`` is the fused loop of the run just made (its capture).  Runs,
    counts set to 0 just before each: fused gather, ``two_phase=True``
    gather (layered, eager) and fused bcsr (``two_phase=False``: the
    full-grid stream), each after a warm-up: the bcsr run's tokens, D1 and
    R1 once a layer a step (replays counted), K2 once a MoE layer a pass on
    fused bcsr, and the first decode step's logits ``torch.equal`` across
    the three.  Then depth 1, fused and layered gather: the same tokens,
    and one extra fused depth-1 step makes no host sync.  Then the trace
    of one decode step, layered and replayed (:func:`trace_decode`)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import ServeLoop
    max_seq = PROMPT + GEN
    n_moe = cfg.block_unit.count("attn+moe") * cfg.n_repeats
    n_attn = n_moe + cfg.block_unit.count("attn") * cfg.n_repeats
    print("fused serving (model.prefill, the decode step one CUDA graph), "
          "4 x 256:")
    loops = {"gather fused": gather,
             "gather layered": ServeLoop(params, cfg, max_seq=max_seq,
                                         dispatch="gather", two_phase=True),
             "bcsr fused": ServeLoop(params, cfg, max_seq=max_seq,
                                     dispatch="bcsr", two_phase=False)}
    capture = {"gather fused": gather.summary()["capture"]}
    for label in ("gather layered", "bcsr fused"):
        loops[label].run(prompts, 2)          # warm-up (and capture)
        capture[label] = loops[label].summary().get(
            "capture", {"calls": 0, "ms": 0.0})
    rows, logits = [], {}
    for label, loop in loops.items():
        reset_launches()
        with no_plain():
            got, logits[label] = first_step_logits(loop, prompts)
        counts = read_launches()
        k2 = {"spmm_bcsr": n_moe * GEN} if label.startswith("bcsr") else {}
        check(np.array_equal(got, tokens), f"{label}: tokens != bcsr's")
        check(counts == decode_counts(cfg, 1, GEN - 1, **k2),
              f"{label}: launches {counts}")
        if label.endswith("fused"):
            per = {"decode_attention": n_attn,
                   "router_logits": r1_per_step(cfg),
                   **({"spmm_bcsr": n_moe} if k2 else {})}
            got = loop.fused_step.launches
            check(got == per, f"{label}: a replay launches {got}")
        rows.append(fused_numbers(label, loop.summary(), capture[label],
                                  counts))
        print_fused(rows[-1])
    for label in ("gather layered", "bcsr fused"):
        check(torch.equal(logits[label], logits["gather fused"]),
              f"first decode step logits: {label} != gather fused "
              f"(max diff {(logits[label] - logits['gather fused']).abs().max().item()})")
    print("  tokens == bcsr two-phase; first decode step logits torch.equal "
          "(gather fused, gather layered, bcsr fused); a replay launches "
          f"{loops['bcsr fused'].fused_step.launches}")

    depth1 = {"fused": ServeLoop(params, cfg, max_seq=max_seq,
                                 dispatch="gather", pipeline_depth=1),
              "layered": ServeLoop(params, cfg, max_seq=max_seq,
                                   dispatch="gather", two_phase=True,
                                   pipeline_depth=1)}
    for label, loop in depth1.items():
        loop.run(prompts, 2)                  # warm-up
        cap = loop.summary().get("capture", {"calls": 0, "ms": 0.0})
        reset_launches()
        with no_plain():
            got = loop.run(prompts, GEN)
        counts = read_launches()
        check(np.array_equal(got, tokens), f"depth 1 {label}: tokens")
        check(counts == decode_counts(cfg, 1, GEN - 1),
              f"depth 1 {label}: launches {counts}")
        rows.append(fused_numbers(f"gather {label}, depth 1", loop.summary(),
                                  cap, counts))
        print_fused(rows[-1])
    _, syncs, waits = count_syncs(depth1["fused"].decode_step)
    torch.cuda.synchronize()
    print(f"  host syncs of one fused depth-1 decode step: {syncs} (event "
          f"waits {waits})")
    check(syncs == 0 and waits == 0,
          f"a fused depth-1 decode step synced {syncs} times, waited {waits}")
    traces = [trace_decode(f"{cfg.name} gather, layered eager",
                           loops["gather layered"], prompts),
              trace_decode(f"{cfg.name} gather, fused replayed",
                           loops["gather fused"], prompts)]
    return {"runs": rows, "depth1_step_syncs": syncs,
            "per_replay": loops["bcsr fused"].fused_step.launches,
            "first_step_logits_equal": True, "traces": traces}


def phase_pipelined(cfg, params, prompts, loop, tokens, summary):
    """Phase 5 at ``pipeline_depth=1``: the same weights and prompts served
    by a second loop at depth 1 (after a warm-up), in the order depth 0 (the
    run just made), 1, 1, 0, so the host's noise falls on both depths
    alike.  Every run: the first depth-0 run's tokens, K2 ``n_moe x GEN``
    times and no flash kernel.  Then a temperature-0.7 run at each depth
    (equal tokens), the sampler against ``torch.multinomial`` on the card
    (equal tokens, each one's host syncs counted), and the host syncs of one
    extra, untimed depth-1 decode step: at most one per attn+moe layer
    (the slot fetch)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import ServeLoop, sample_tokens
    max_seq = PROMPT + GEN
    n_moe = cfg.block_unit.count("attn+moe") * cfg.n_repeats
    print("pipelined serving (pipeline_depth=1), 4 x 256:")
    loop1 = ServeLoop(params, cfg, max_seq=max_seq, dispatch="bcsr",
                      pipeline_depth=1)
    loop1.run(prompts, 2)                     # warm-up
    runs = [serve_numbers(0, summary)]
    print_serve("depth 0", runs[0])
    for depth in (1, 1, 0):
        lp = loop1 if depth else loop
        reset_launches()
        with no_plain():
            got = lp.run(prompts, GEN)        # the main path at this depth
        counts = read_launches()
        check(np.array_equal(got, tokens),
              f"depth {depth}: tokens != the first depth-0 run's")
        check(counts == decode_counts(cfg, 1, GEN - 1,
                                      spmm_bcsr=n_moe * GEN),
              f"depth {depth}: launches {counts}")
        runs.append(serve_numbers(depth, lp.summary()))
        print_serve(f"depth {depth}", runs[-1])
    temp = {d: ServeLoop(params, cfg, max_seq=max_seq, dispatch="bcsr",
                         temperature=0.7, pipeline_depth=d).run(prompts, GEN)
            for d in (0, 1)}
    check(np.array_equal(temp[0], temp[1]),
          "temperature 0.7: depth-1 tokens != depth-0 tokens")
    print(f"  temperature 0.7: depth 1 == depth 0 tokens "
          f"{temp[1][0, :8].tolist()} ...")

    lg = torch.randn(BATCH, cfg.vocab_size, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(9))
    g = [torch.Generator("cuda").manual_seed(10) for _ in range(2)]
    want, multi_syncs, _ = count_syncs(lambda: torch.multinomial(
        torch.softmax(lg / 0.7, dim=-1), 1, generator=g[0]))
    got, ours, _ = count_syncs(lambda: sample_tokens(lg, cfg.vocab_size, 0.7,
                                                     g[1]))
    check(torch.equal(got.long(), want) and ours == 0,
          f"sampler: {got.view(-1).tolist()} vs multinomial "
          f"{want.view(-1).tolist()}, {ours} syncs")
    _, syncs, waits = count_syncs(loop1.decode_step)
    torch.cuda.synchronize()
    print(f"  host syncs: torch.multinomial {multi_syncs}, the loop's "
          f"sampler {ours} (same tokens); one depth-1 decode step {syncs} "
          f"({n_moe} attn+moe layers), event waits {waits}")
    check(syncs <= n_moe, f"a depth-1 decode step synced {syncs} times")
    return {"runs": runs, "order": "0 (captured), 1, 1, 0",
            "temperature_tokens_equal": True,
            "decode_step_syncs": syncs, "decode_step_event_waits": waits,
            "attn_moe_layers": n_moe, "multinomial_syncs": multi_syncs,
            "sampler_syncs": ours}


# continuous batching: the slot pool, the cache capacity (the longest prompt
# plus the largest budget), the trace's size and the numpy seed it comes
# from, and the sampling temperature of the temperature pair
SCHED_SLOTS, SCHED_MAX_SEQ, SCHED_REQUESTS, SCHED_SEED = 8, 544, 16, 24
SCHED_TEMPERATURE = 0.7
# the scheduler runs after the probe, by key: two-phase bcsr at depth 0 (its
# streams and calls kept for the kernel rows) and 1, gather layered, the
# temperature pair, then fused; "int8" runs keep their KV cache in int8
SCHED_RUNS = {
    "bcsr0": dict(dispatch="bcsr"),
    "bcsr1": dict(dispatch="bcsr", pipeline_depth=1),
    "gather0": dict(dispatch="gather", two_phase=True),
    "temp0": dict(dispatch="bcsr", temperature=SCHED_TEMPERATURE),
    "temp1": dict(dispatch="bcsr", pipeline_depth=1,
                  temperature=SCHED_TEMPERATURE),
    "fused_gather0": dict(dispatch="gather"),
    "fused_gather1": dict(dispatch="gather", pipeline_depth=1),
    "fused_bcsr0": dict(dispatch="bcsr", two_phase=False),
    "fused_temp0": dict(dispatch="gather", temperature=SCHED_TEMPERATURE),
    "int8_bcsr0": dict(dispatch="bcsr", kv_quant="int8"),
    "int8_fused_gather0": dict(dispatch="gather", kv_quant="int8")}
# scout runs every wide run (its int8 KV runs are the quantized phase's);
# maverick two-phase and fused, wide and int8 KV
SCHED_KEYS = {
    SCOUT_ARCH: ("bcsr0", "bcsr1", "gather0", "temp0", "temp1",
                 "fused_gather0", "fused_gather1", "fused_bcsr0",
                 "fused_temp0"),
    MAVERICK_ARCH: ("bcsr0", "bcsr1", "fused_gather0", "fused_bcsr0",
                    "int8_bcsr0", "int8_fused_gather0")}


def scheduler_trace(vocab: int):
    """The scheduler phase's requests: prompts uniform in 64-512 tokens,
    budgets uniform in 8-32 tokens, from ``default_rng(SCHED_SEED)``."""
    import numpy as np
    rng = np.random.default_rng(SCHED_SEED)
    return [(rng.integers(0, vocab, int(rng.integers(64, 513))
                          ).astype(np.int32), int(rng.integers(8, 33)))
            for _ in range(SCHED_REQUESTS)]


def drive_scheduler(sched, trace, eos: dict, after_step=None,
                    steps=None) -> float:
    """Two requests submitted at step 0, then one more every 2 scheduler
    steps (request i at step 2 (i - 1)), request i with ``eos.get(i)`` as
    its EOS, until every request has finished (or, given ``steps``, until
    that many steps); ``after_step(sched)`` after each step when given.
    Returns the wall seconds (the token fetch of each step waits for the
    card)."""
    arrivals = [0, 0] + [2 * (i - 1) for i in range(2, len(trace))]
    t0 = time.monotonic()
    nxt = 0
    while (nxt < len(trace) or sched.has_work()) and (
            steps is None or sched.step_idx < steps):
        while nxt < len(trace) and arrivals[nxt] <= sched.step_idx:
            sched.submit(*trace[nxt], eos_id=eos.get(nxt))
            nxt += 1
        sched.step()
        if after_step is not None:
            after_step(sched)
    if steps is None:
        sched.run()
    return time.monotonic() - t0


def scheduler_numbers(label: str, sched, wall_s: float) -> dict:
    """One scheduler run's numbers from ``ServeScheduler.summary()``; fused,
    its graph captures (calls and ms, in no other phase)."""
    s = sched.summary()
    return {"label": label, "two_phase": sched.two_phase,
            "depth": sched.pipeline_depth, "dispatch": sched.backend,
            "temperature": sched.temperature, "steps": sched.step_idx,
            "decode_steps": s["decode"]["calls"], "wall_s": wall_s,
            "decode_tokens": s["decode"]["tokens"],
            "decode_tok_per_s": s["decode"]["tok_per_s"],
            "prefill_ms": s["prefill"]["seconds"] * 1e3,
            "token_latency_ms": s["token_latency_ms"],
            "first_token_ms": s["first_token_ms"],
            "batch_buckets": s["batch_buckets"],
            "nnzb_buckets": s.get("nnzb_buckets"), "timing": s["timing"],
            "capture": s.get("capture")}


def print_scheduler(row: dict) -> None:
    lat, first = row["token_latency_ms"], row["first_token_ms"]
    cap = row["capture"]
    print(f"  {row['label']}: {row['steps']} steps, wall "
          f"{row['wall_s']:.2f} s, decode {row['decode_tok_per_s']:.1f} "
          f"tok/s over {row['decode_tokens']} tokens; token latency p50 "
          f"{lat['p50']:.2f} / p99 {lat['p99']:.2f} ms; first token p50 "
          f"{first['p50']:.1f} / p99 {first['p99']:.1f} ms; buckets "
          f"{row['batch_buckets']}, nnzb {row['nnzb_buckets']}; "
          + (f"capture {cap['ms']:.1f} ms ({cap['calls']} graphs); "
             if cap else "two-phase; ") + "timing "
          + ", ".join(f"{k} {v:.4g}" for k, v in row["timing"].items()))


def phase_scheduler(cfg, params, keys=SCHED_KEYS[SCOUT_ARCH]):
    """Continuous batching on phase 5's weights: ``ServeScheduler`` with
    SCHED_SLOTS slots and ``max_seq`` SCHED_MAX_SEQ serves the 16 requests
    of :func:`scheduler_trace` as :func:`drive_scheduler` submits them.  A
    probe run (bcsr, depth 0, also the warm-up) gives the EOS: the first
    request whose 5th token does not occur among its first four carries
    that token as its ``eos_id``.  Then the runs ``keys`` of
    :data:`SCHED_RUNS` (:data:`SCHED_KEYS`; scout: two-phase bcsr at
    depth 0, bcsr at depth 1, gather at depth 0 (``two_phase=True``), and
    a temperature-0.7 bcsr
    run at each depth; fused (one CUDA graph a batch bucket over the
    pool's rows): gather at depth 0 (the default) and 1, bcsr at depth 0
    (``two_phase=False``, the full-grid stream), and gather at temperature
    0.7; maverick: bcsr at depths 0 and 1, fused gather and bcsr, and bcsr
    two-phase and fused gather with ``kv_quant="int8"``).  Checks: every
    wide greedy run's tokens == bcsr depth 0's, the int8 runs' == each
    other, the temperature runs' == each other, per request; K2 ``n_moe
    x (admissions + decode steps)`` in each bcsr run (replays counted) and
    never in a gather run, D1 once an attention layer a decode step and R1
    as :func:`decode_counts` says in every run, their plain versions never; no
    flash launch and no oracle fallback; each decode step's bucket is
    ``batch_bucket(highest occupied slot + 1)`` and in {1, 2, 4, 8}; fused,
    one graph for each bucket seen, each replay launching D1 once a layer
    and R1 :func:`r1_per_step` times (K2 once a MoE layer on bcsr); the EOS
    request ends at its EOS,
    every other greedy request gets exactly its budget; one extra depth-1
    two-phase step makes at most ``n_moe + 1`` host syncs, one extra fused
    step at either depth at most 1 (each where the arch runs it); and
    every request served alone through ``ServeLoop`` (B = 1, the same
    ``max_seq``, greedy; int8 KV for the int8 runs) gives the tokens each
    greedy run gave it -- where one does not, the first step that differs
    and the alone run's logit gap there are printed before the check
    fails.  Then one decode step at bucket 8 traced, layered and
    fused (:func:`trace_step`).  The bcsr depth-0 run's first dispatch
    stream (an admission) and its first stream at the largest decode
    bucket are kept for the K2 row, its first D1 and R1 decode calls at the
    largest bucket for theirs."""
    import torch
    from repro_torch.kernels import engine
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.serve import ServeScheduler
    n_moe = cfg.block_unit.count("attn+moe") * cfg.n_repeats
    n_attn = n_moe + cfg.block_unit.count("attn") * cfg.n_repeats
    trace = scheduler_trace(cfg.vocab_size)
    print(f"continuous batching: {len(trace)} requests, prompts "
          f"{min(len(p) for p, _ in trace)}-{max(len(p) for p, _ in trace)}"
          f", budgets {min(g for _, g in trace)}-{max(g for _, g in trace)}"
          f", {SCHED_SLOTS} slots, max_seq {SCHED_MAX_SEQ}")

    captured = []
    stream_entry = engine.spmm_batched_stream

    def capture(a, dense, **kw):    # the first call, the first at the top B
        if len(captured) < 2 or a.blocks.shape[0] > captured[1][0].blocks \
                .shape[0]:
            del captured[1:]
            captured.append((a, dense, kw))
        return stream_entry(a, dense, **kw)

    decode_calls = {}

    def keep(name, args, kw):   # the first D1 / R1 decode call at the top B
        x = args[0]                 # q (B, Hq, 1, D) or x (B, S, d)
        if name == "attention" or (name == "router_logits"
                                   and x.shape[1] != 1):
            return                                  # an admission's prefill
        key = "d1_bucket" if name == "decode_attention" else "r1_bucket"
        if key not in decode_calls \
                or x.shape[0] > decode_calls[key][0][0].shape[0]:
            decode_calls[key] = (tuple(a.clone() if isinstance(
                a, torch.Tensor) else a for a in args), {
                k: v.clone() if isinstance(v, torch.Tensor) else v
                for k, v in kw.items()})

    def serve(label, eos, stream_hook=None, call_hook=None, **kw):
        sched = ServeScheduler(params, cfg, max_seq=SCHED_MAX_SEQ,
                               max_slots=SCHED_SLOTS, **kw)
        ops.reset_fallbacks()
        engine.spmm_batched_stream = stream_hook or stream_entry
        reset_launches()
        try:
            with hook_calls(call_hook or (lambda *a: None)), no_plain():
                wall = drive_scheduler(sched, trace, eos)    # the main path
        finally:
            engine.spmm_batched_stream = stream_entry
        counts = read_launches()
        tokens = {r.uid: list(r.tokens) for r in sched.finished}
        check(sorted(tokens) == list(range(len(trace))),
              f"{label}: finished {sorted(tokens)}")
        decode = [st for st in sched.stats if st.phase == "decode"]
        bcsr = sched.backend == "bcsr"
        k2 = n_moe * (len(trace) + len(decode)) if bcsr else 0
        want = decode_counts(cfg, len(trace), len(decode), spmm_bcsr=k2)
        check(counts == want, f"{label}: launches {counts} != {want}")
        check(ops.fallback_count() == 0 and sched.summary()["timing"][
            "attention_ref_fallbacks"] == 0, f"{label}: oracle fallbacks")
        for st in decode:
            b, hi = st.extra["batch_bucket"], st.extra["occupied"]
            check(b == engine.batch_bucket(hi, cap=sched.n_slots)
                  and b in (1, 2, 4, 8) and st.extra["active"] <= hi <= b,
                  f"{label}: step {st.step} bucket {b} for {hi} rows")
        if not sched.two_phase:
            per = {"decode_attention": n_attn,
                   "router_logits": r1_per_step(cfg),
                   **({"spmm_bcsr": n_moe} if bcsr else {})}
            graphs = {b: f.graph is not None and f.launches == per
                      for b, f in sched._fused.items()}
            check(set(graphs) == sched.batch_buckets and all(graphs.values())
                  and sched.summary()["capture"]["calls"] == len(graphs),
                  f"{label}: graphs {graphs} for buckets "
                  f"{sorted(sched.batch_buckets)}, a replay launching "
                  f"{[f.launches for f in sched._fused.values()]}")
        return sched, tokens, {**scheduler_numbers(label, sched, wall),
                               "k2_launches": counts["spmm_bcsr"]}

    probe_sched, probe, _ = serve("probe", {}, dispatch="bcsr")
    kv_mb = sum(t.numel() * t.element_size()
                for c in probe_sched.cache["slots"]
                for t in c["attn"].values()) / 1e6
    print(f"  KV cache {kv_mb:.1f} MB")
    del probe_sched
    eos_req = next(i for i, (_, g) in enumerate(trace)
                   if g > 5 and probe[i][4] not in probe[i][:4])
    eos = {eos_req: probe[eos_req][4]}
    runs, toks, kept = [], {}, {}
    for key in keys:
        kw = dict(SCHED_RUNS[key])
        if key == "bcsr0":
            kw.update(stream_hook=capture, call_hook=keep)
        sched, toks[key], row = serve(key, eos, **kw)
        runs.append({**row, "kv_quant": sched.kv_quant})
        print_scheduler(row)
        if key in ("bcsr1", "fused_gather0", "fused_gather1"):
            kept[key] = sched
        del sched
    temps = [k for k in keys if k.startswith(("temp", "fused_temp"))]
    greedy = {q: [k for k in keys if k not in temps
                  and k.startswith("int8") == (q == "int8")]
              for q in (None, "int8")}
    for group in greedy.values():
        for key in group[1:]:
            check(toks[key] == toks[group[0]],
                  f"{key}: tokens != {group[0]}'s")
    for key in temps[1:]:
        check(toks[key] == toks[temps[0]],
              f"temperature 0.7: {key} tokens != {temps[0]}'s")
    for i, (_, budget) in enumerate(trace):
        got = toks["bcsr0"][i]
        if i == eos_req:
            check(got[-1] == eos[i] and eos[i] not in got[:-1]
                  and len(got) < budget,
                  f"request {i} did not stop at its EOS {eos[i]}: {got}")
        else:
            check(len(got) == budget,
                  f"request {i}: {len(got)} tokens, budget {budget}")
    print("  tokens: " + "; ".join(
        f"{', '.join(g[1:])} == {g[0]}" for g in greedy.values() if g)
          + (f"; temperature runs {', '.join(temps)} equal" if temps else "")
          + f"; request {eos_req} stopped at its EOS {eos[eos_req]} after "
          f"{len(toks['bcsr0'][eos_req])} tokens")

    syncs = {}
    for key, sched in kept.items():
        sched.submit(trace[0][0], 3)          # one more resident request
        sched.step()                          # admits it (fused: bucket 1)
        _, n, waits = count_syncs(sched.step)
        torch.cuda.synchronize()
        syncs[key] = {"syncs": n, "event_waits": waits}
    del kept, sched
    print(f"  one extra scheduler step, host syncs (event waits): "
          + ", ".join(f"{k} {v['syncs']} ({v['event_waits']})"
                      for k, v in syncs.items())
          + f"; {n_moe} attn+moe layers")
    check("bcsr1" not in syncs or syncs["bcsr1"]["syncs"] <= n_moe + 1,
          f"a depth-1 scheduler step synced {syncs.get('bcsr1')} times")
    for key in ("fused_gather0", "fused_gather1"):
        check(key not in syncs or (syncs[key]["syncs"] <= 1
                                   and syncs[key]["event_waits"] == 0),
              f"a fused scheduler step ({key}) synced {syncs.get(key)}")

    alone = {q: _alone_rows(params, cfg, trace, toks, group, q)
             for q, group in greedy.items() if group}
    out_alone = {}
    for q, rows in alone.items():
        n_match = sum(r["match"] for r in rows)
        what = "int8 KV" if q else "wide"
        print(f"  {what}: {n_match} of {len(trace)} requests give, in every "
              f"greedy run (two-phase and fused), the tokens of the request "
              f"served alone through ServeLoop (B = 1)"
              + "".join(f"; request {r['request']} differs first in "
                        f"{r['run']} at step {r['step']} ({r['alone']} "
                        f"alone, {r['scheduler']} scheduled, logit gap "
                        f"{r['logit_gap']:.4g})"
                        for r in rows if not r["match"]))
        check(n_match == len(trace), f"{what}: {len(trace) - n_match} "
              "requests decoded in a batch bucket part from the same "
              "request alone at B = 1")
        out_alone[q] = (n_match, rows)

    traces = []
    for label, kw in (("scheduler bcsr, two-phase eager",
                       dict(dispatch="bcsr")),
                      ("scheduler gather, layered eager",
                       dict(dispatch="gather", two_phase=True)),
                      ("scheduler gather, fused replayed",
                       dict(dispatch="gather"))):
        sched = ServeScheduler(params, cfg, max_seq=SCHED_MAX_SEQ,
                               max_slots=SCHED_SLOTS, **kw)

        def fill(sched=sched):                # bucket 8, 32-token budgets
            for prompt, _ in trace[:SCHED_SLOTS]:
                sched.submit(prompt, 32)
            sched.admit()

        traces.append(trace_step(label, fill, sched.decode_step))
        check(sorted(sched.batch_buckets) == [SCHED_SLOTS],
              f"{label}: buckets {sorted(sched.batch_buckets)}")
        del sched, fill
    int8 = {f"{key}_int8": v for key, v in (
        ("alone_matches", out_alone.get("int8", (None,))[0]),
        ("alone", out_alone.get("int8", (None, None))[1])) if v is not None}
    return {"requests": len(trace), "slots": SCHED_SLOTS,
            "max_seq": SCHED_MAX_SEQ, "kv_cache_mb": kv_mb,
            "eos_request": eos_req, "runs": runs,
            "tokens_equal": {"greedy_runs_bcsr0": greedy[None][1:],
                             "greedy_runs_int8": greedy["int8"],
                             "temperature_runs": temps},
            "step_syncs": syncs, "attn_moe_layers": n_moe,
            "alone_matches": out_alone[None][0], "alone": out_alone[None][1],
            **int8, "traces": traces}, captured, decode_calls, {
                "eos": eos, "tokens": toks["fused_gather0"]}


def _alone_rows(params, cfg, trace, toks, keys, kv_quant) -> list:
    """Each request of ``trace`` served alone through a bcsr ``ServeLoop``
    (B = 1, greedy, ``max_seq`` SCHED_MAX_SEQ, ``kv_quant``) against the
    tokens the scheduler runs ``keys`` gave it: one row a request, with
    the first run, step, tokens and the alone run's logit gap where one
    parts."""
    from repro_torch.launch.serve import ServeLoop
    rows = []
    for i, (prompt, budget) in enumerate(trace):
        loop = ServeLoop(params, cfg, max_seq=SCHED_MAX_SEQ, dispatch="bcsr",
                         kv_quant=kv_quant)
        logits = []

        def keep(lg, sample=loop._sample):    # each token's logits
            logits.append(lg[0].float())
            return sample(lg)

        loop._sample = keep
        with no_plain():
            ref = loop.run(prompt[None], budget)[0].tolist()
        row = {"request": i, "match": True}
        for key in keys:
            got = toks[key][i]
            diff = next((t for t, (a, b) in enumerate(zip(got, ref))
                         if a != b), None)
            if diff is not None and row["match"]:
                lg = logits[diff]
                row.update(match=False, run=key, step=diff, alone=ref[diff],
                           scheduler=got[diff],
                           logit_gap=float(lg[ref[diff]] - lg[got[diff]]))
        rows.append(row)
        del loop, logits
    return rows


def _tensors(tree):
    """Every tensor of a param tree (a ``QuantTensor``'s values and
    scales)."""
    from repro_torch.core.precision import QuantTensor
    if isinstance(tree, dict):
        tree = tree.values()
    elif isinstance(tree, QuantTensor):
        tree = (tree.values, tree.scales)
    elif not isinstance(tree, (tuple, list)):
        yield tree
        return
    for leaf in tree:
        yield from _tensors(leaf)


def unreferenced_bytes(params, held) -> int:
    """The bytes of the leaves of ``params`` whose storage no tensor of the
    driver's param tree ``held`` shares (with ``quantize_experts``, the wide
    expert matrices): resident only because the caller keeps ``params``, so
    a driver's own peak is the device peak less these."""
    ptrs = {t.untyped_storage().data_ptr() for t in _tensors(held)}
    return sum(t.nbytes for t in _tensors(params)
               if t.untyped_storage().data_ptr() not in ptrs)


# the quantized phase: (label, ServeLoop keywords) of its 4 x 256 runs
QUANT_RUNS = (
    ("int8 experts + int8 KV, bcsr two-phase",
     dict(dispatch="bcsr", quantize_experts="int8", kv_quant="int8")),
    ("int8 experts + int8 KV, gather fused",
     dict(dispatch="gather", quantize_experts="int8", kv_quant="int8")),
    ("fp8_e4m3 KV, gather fused", dict(dispatch="gather",
                                       kv_quant="fp8_e4m3")))
QUANT_REL_TOL = 0.2     # first decode step vs wide: the reference's bound


def phase_quant_serving(cfg, params, wide_sched):
    """Quantized experts and KV caches on phase 5's weights (Queue 1 item
    4): ``model.prefill(kv_quant="int8")`` logits ``torch.equal`` to the
    wide prefill's (quantization touches only the emitted cache); then
    BATCH x PROMPT prompts and GEN greedy tokens through the wide fused
    gather ``ServeLoop`` and :data:`QUANT_RUNS` (each made, run and
    deleted before the next: a quantized driver holds an int8 copy of the
    experts beside the phase's bf16 params), counts set to 0 just before
    each run: the launches of :func:`decode_counts` (K2 ``n_moe x GEN`` on
    bcsr), no plain version on the card; bcsr two-phase tokens == gather
    fused tokens (int8 experts + int8 KV: backends and modes agree); the
    first decode step's logits within :data:`QUANT_REL_TOL` relative error
    (largest |difference| over the largest |logit|) of the wide run's; at
    most 1 host sync in an extra fused step.  Then the int8 scheduler on
    phase 6's trace (fused gather), and each request alone through one
    int8 ``ServeLoop`` (B = 1): 16 of 16 equal.  Decode tok/s, token
    latency p50 / p99, peak device memory and capture ms are printed
    beside the wide runs (``wide_sched``: phase 6's fused gather run)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import ServeLoop, ServeScheduler
    from repro_torch.models import model as M
    n_moe = cfg.block_unit.count("attn+moe") * cfg.n_repeats
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=g,
                            device="cuda")
    max_seq = PROMPT + GEN
    print(f"quantized serving: {BATCH} x {PROMPT}, {GEN} tokens, then the "
          f"scheduler on phase 6's trace:")
    wide_lg, _, _ = M.prefill(params, prompts, cfg, max_seq=max_seq,
                              dispatch="gather")
    kv_lg, kv_cache, _ = M.prefill(params, prompts, cfg, max_seq=max_seq,
                                   dispatch="gather", kv_quant="int8")
    leaf = kv_cache["slots"][0]["attn"]
    check(torch.equal(kv_lg, wide_lg)
          and leaf["k"].dtype == torch.int8
          and leaf["k_scale"].dtype == torch.float32,
          "kv_quant prefill logits != wide prefill logits")
    del wide_lg, kv_lg, kv_cache, leaf
    print("  model.prefill(kv_quant='int8') logits == wide logits "
          "(torch.equal); the cache int8 with f32 scales")

    def serve(label, **kw):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loop = ServeLoop(params, cfg, max_seq=max_seq, **kw)
        loop.run(prompts, 2)                  # warm-up: capture, allocator
        capture = loop.summary().get("capture", {"calls": 0, "ms": 0.0})
        reset_launches()
        with no_plain():
            tokens, first = first_step_logits(loop, prompts, GEN)
        counts = read_launches()
        summary = loop.summary()
        bcsr = loop.backend == "bcsr"
        want = decode_counts(cfg, 1, GEN - 1,
                             **({"spmm_bcsr": n_moe * GEN} if bcsr else {}))
        check(counts == want, f"{label}: launches {counts} != {want}")
        syncs = None
        if not loop.two_phase:
            loop.prefill(prompts)
            _, syncs, waits = count_syncs(loop.decode_step)
            torch.cuda.synchronize()
            check(syncs <= 1 and waits == 0,
                  f"{label}: a fused step synced {syncs} times, waited "
                  f"{waits}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        idle = unreferenced_bytes(params, loop.params) / 1e9
        row = {**fused_numbers(label, summary, capture, counts),
               "peak_gb": peak, "own_peak_gb": peak - idle,
               "unreferenced_gb": idle, "step_syncs": syncs,
               "tokens": tokens[:, :8].tolist()}
        print_fused(row)
        print(f"    peak {peak:.1f} GB (its own {peak - idle:.1f} GB: less "
              f"{idle:.1f} GB of phase 5's param leaves it does not hold); "
              f"host syncs of an extra fused step {syncs}; tokens "
              f"{tokens[0, :8].tolist()} ...")
        del loop
        return tokens, first, row

    wide_tokens, wide_first, wide_row = serve("wide, gather fused",
                                              dispatch="gather")
    rows, toks = [wide_row], {}
    for label, kw in QUANT_RUNS:
        toks[label], first, row = serve(label, **kw)
        rel = ((first - wide_first).abs().max()
               / wide_first.abs().max()).item()
        check(rel < QUANT_REL_TOL, f"{label}: first decode step {rel:.4g} "
                                   f"relative error from wide")
        row["first_step_rel_err"] = rel
        row["tokens_equal_wide"] = bool(np.array_equal(toks[label],
                                                       wide_tokens))
        rows.append(row)
        print(f"    first decode step relative error {rel:.4g} (bound "
              f"{QUANT_REL_TOL}); tokens == wide: {row['tokens_equal_wide']}")
    a, b = (toks[label] for label, _ in QUANT_RUNS[:2])
    check(np.array_equal(a, b), "int8: bcsr two-phase tokens != gather "
                                "fused tokens")
    print("  int8 experts + int8 KV: bcsr two-phase tokens == gather fused "
          "tokens")

    trace = scheduler_trace(cfg.vocab_size)
    qkw = dict(quantize_experts="int8", kv_quant="int8")
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    sched = ServeScheduler(params, cfg, max_seq=SCHED_MAX_SEQ,
                           max_slots=SCHED_SLOTS, dispatch="gather", **qkw)
    reset_launches()
    with no_plain():
        wall = drive_scheduler(sched, trace, {})       # the main path
    counts = read_launches()
    decode = [st for st in sched.stats if st.phase == "decode"]
    want = decode_counts(cfg, len(trace), len(decode))
    check(counts == want, f"int8 scheduler: launches {counts} != {want}")
    stoks = {r.uid: list(r.tokens) for r in sched.finished}
    check(sorted(stoks) == list(range(len(trace))),
          f"int8 scheduler: finished {sorted(stoks)}")
    idle = unreferenced_bytes(params, sched.params) / 1e9
    srow = {**scheduler_numbers("int8 experts + int8 KV, gather fused",
                                sched, wall),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "unreferenced_gb": idle}
    srow["own_peak_gb"] = srow["peak_gb"] - idle
    print_scheduler(srow)
    lat = wide_sched["token_latency_ms"]
    print(f"    peak {srow['peak_gb']:.1f} GB (its own "
          f"{srow['own_peak_gb']:.1f} GB); wide (phase 6, "
          f"{wide_sched['label']}): decode "
          f"{wide_sched['decode_tok_per_s']:.1f} tok/s, token p50 / p99 "
          f"{lat['p50']:.2f} / {lat['p99']:.2f} ms, capture "
          f"{wide_sched['capture']['ms']:.1f} ms")
    del sched
    gc.collect()
    loop = ServeLoop(params, cfg, max_seq=SCHED_MAX_SEQ, dispatch="gather",
                     **qkw)
    with no_plain():
        alone = [loop.run(p[None], b)[0].tolist() == stoks[i]
                 for i, (p, b) in enumerate(trace)]
    del loop
    print(f"  {sum(alone)} of {len(trace)} requests give the tokens they "
          f"get alone (B = 1, int8 ServeLoop)")
    check(all(alone), f"int8 scheduler: only {sum(alone)} of {len(trace)} "
                      "requests equal themselves alone")
    return {"runs": rows, "bcsr_equals_gather": True,
            "kv_prefill_logits_equal": True, "rel_tol": QUANT_REL_TOL,
            "scheduler": srow, "alone_matches": sum(alone),
            "requests": len(trace)}


# the resilience phase's faults: decode steps and the admission index
RES_NAN_STEP = 3          # a sample / execute NaN for one resident uid
RES_EXC_STEP = 6          # a sample exception (fused), retried
RES_LAYER_STEP = 2        # an execute exception at layer=1 (two-phase)
RES_PREFILL_CALL = 5      # the 6th admission's prefill hook raises
RES_WIDE_STEP = 4         # the kv_wide run's poisoned step


def _resident_uid(tokens: dict, step: int) -> int:
    """A request of the scheduler trace submitted at step 0 that is still
    resident at decode step ``step`` of the fault-free run (its tokens
    outnumber the step + 1)."""
    return next(u for u in (0, 1) if len(tokens[u]) >= step + 2)


def save_cost(make, trace, eos: dict) -> dict:
    """Fault-free decode tok/s of ``make(retry)``'s scheduler on ``trace``
    with the retry's save (``RetryPolicy()``) and without it
    (``RetryPolicy(max_retries=0)``), in the order without, with, with,
    without; each run's tok/s and their means; and the save itself at the
    pool's top bucket, its device ms (CUDA events, back to back) beside
    its bytes (the step state read and written once) over HBM_BYTES_PER_S."""
    from repro_torch.launch.serve import _row_views, _step_state
    from repro_torch.runtime import resilience as R
    runs = {"without": [], "with": []}
    for key in ("without", "with", "with", "without"):
        sched = make(R.RetryPolicy() if key == "with"
                     else R.RetryPolicy(max_retries=0))
        with no_plain():
            drive_scheduler(sched, trace, eos)
        check(sched.summary()["requests"]["finished"] == len(trace)
              and (sched._step_saved is None) == (key == "without"),
              f"save cost run ({key}): finished "
              f"{sched.summary()['requests']}")
        runs[key].append(sched.summary()["decode"]["tok_per_s"])
        if key == "with":
            top = sched.n_slots
            nbytes = 2 * sum(
                t.numel() * t.element_size() for slot in _row_views(
                    _step_state(sched.cache), top) for t in slot.values())
            save_ms = time_ms(lambda: sched._keep_step_state(top, False), 20)
        del sched
        gc.collect()
    out = {k: {"tok_per_s": v, "mean": sum(v) / len(v)}
           for k, v in runs.items()}
    out["order"] = "without, with, with, without"
    out["cost_frac"] = 1 - out["with"]["mean"] / out["without"]["mean"]
    out["save"] = {"bucket": top, "ms": save_ms, "bytes": nbytes,
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    return out


def phase_resilience(cfg, params, clean: dict, step_syncs: dict,
                     card: str) -> dict:
    """Serving resilience on phase 5's weights, against phase 6's
    fault-free runs (``clean``: the fused gather run's tokens and the EOS
    it served with; ``step_syncs``: the syncs of an extra step).

    * Fused gather scheduler on phase 6's trace with a plan: a ``sample``
      NaN for one resident uid at step RES_NAN_STEP, a ``prefill``
      exception at the RES_PREFILL_CALL-th admission hook (retried) and a
      ``sample`` exception at step RES_EXC_STEP (retried after the replay
      stepped the pool).  Checks: the poisoned uid alone fails, every
      survivor's tokens == the fault-free run's, ``plan.triggered`` is what
      the plan asked for, two retries, no plain version on the card, and an
      extra step (plan attached) makes one host sync.
    * Two-phase bcsr at depth 1: an ``execute`` exception at ``layer=1`` of
      step RES_LAYER_STEP (the first MoE layer's occupancy already
      written) and an ``execute`` NaN for one uid at RES_NAN_STEP + 3.
      Checks: survivors equal, that uid alone fails, the pool's ``moe``
      leaf after the retried step ``torch.equal`` to a fault-free run's
      after the same step, and an extra step's syncs == phase 6's depth-1
      count.
    * ``kv_wide``: the int8-KV fused gather scheduler (wide experts),
      ``fail_threshold=1``, one row poisoned at RES_WIDE_STEP.  Checks: the
      rung applied, the pool f32 without scale leaves, every bucket used
      afterwards captured again (its "capture" stats counted and timed),
      the 15 other requests finished (every step's health bits finite),
      one host sync an extra fused step (no EOS in this run: the int8
      tokens are not the wide run's).
    * The save's cost: fault-free fused gather scheduler tok/s with and
      without the retry's save (:func:`save_cost`).
    Returns the numbers for the ``resilience`` line."""
    import torch
    from repro_torch.launch.serve import ServeScheduler
    from repro_torch.runtime import resilience as R
    trace = scheduler_trace(cfg.vocab_size)
    eos, want = clean["eos"], clean["tokens"]
    n_moe = cfg.block_unit.count("attn+moe") * cfg.n_repeats
    print(f"resilience on phase 6's trace ({len(trace)} requests):")

    def make(**kw):
        return ServeScheduler(params, cfg, max_seq=SCHED_MAX_SEQ,
                              max_slots=SCHED_SLOTS, **kw)

    def extra_step_syncs(sched):
        sched.submit(trace[0][0], 3)          # one more resident request
        sched.step()                          # admits it (fused: bucket 1)
        _, n, waits = count_syncs(sched.step)
        torch.cuda.synchronize()
        return {"syncs": n, "event_waits": waits}

    def survivors(sched, label):
        got = {r.uid: list(r.tokens) for r in sched.finished}
        failed = sorted(r.uid for r in sched.failed)
        check(all(got[u] == want[u] for u in got),
              f"{label}: a survivor's tokens != the fault-free run's")
        check(sorted(list(got) + failed) == list(range(len(trace)))
              and not sched.shed, f"{label}: finished {sorted(got)}, "
                                  f"failed {failed}")
        return failed

    out = {"card": card, "requests": len(trace)}
    # -- fused gather: a poisoned row, a retried admission, a retried step
    bad = _resident_uid(want, RES_NAN_STEP)
    plan = R.FaultPlan([
        R.FaultSpec("sample", "nan", uid=bad, step=RES_NAN_STEP),
        R.FaultSpec("prefill", "exception", layer=RES_PREFILL_CALL),
        R.FaultSpec("sample", "exception", step=RES_EXC_STEP)])
    sched = make(dispatch="gather", fault_plan=plan)
    with no_plain():
        drive_scheduler(sched, trace, eos)
    failed = survivors(sched, "fused gather, faulted")
    fired = sorted((t[0], t[1], str(t[2]), len(t[3]))
                   for t in plan.triggered)
    asked = sorted([("sample", "nan", str(RES_NAN_STEP), 1),
                    ("prefill", "exception", "None", 0),
                    ("sample", "exception", str(RES_EXC_STEP), 0)])
    check(failed == [bad] and fired == asked
          and sched.health.counters["retry"] == 2,
          f"fused gather, faulted: failed {failed} (want [{bad}]), fired "
          f"{plan.triggered}, retries {sched.health.counters['retry']}")
    syncs = extra_step_syncs(sched)
    check(syncs["syncs"] == 1 and syncs["event_waits"] == 0,
          f"fused gather, plan attached: an extra step synced {syncs}")
    out["fused_gather"] = {
        "failed": failed, "survivors_equal": True,
        "triggered": [[*t[:3], list(t[3])] for t in plan.triggered],
        "retries": sched.health.counters["retry"], "step_syncs": syncs}
    print(f"  fused gather: uid {bad} poisoned at step {RES_NAN_STEP} fails "
          f"alone, {len(trace) - 1} survivors == the fault-free run; an "
          f"admission and step {RES_EXC_STEP} retried; fired "
          f"{plan.triggered}; an extra step (plan attached): {syncs}")
    del sched

    # -- two-phase bcsr, depth 1: an exception mid-step, a poisoned row
    def keep_moe(store):
        def after(sched):
            if sched.step_idx == RES_LAYER_STEP + 1:
                store.extend(c["moe"].clone() for c in sched.cache["slots"]
                             if "moe" in c)
        return after

    fault_free, faulted = [], []
    drive_scheduler(make(dispatch="bcsr", pipeline_depth=1), trace, eos,
                    after_step=keep_moe(fault_free),
                    steps=RES_LAYER_STEP + 1)
    bad2 = _resident_uid(want, RES_NAN_STEP + 3)
    plan = R.FaultPlan([
        R.FaultSpec("execute", "exception", step=RES_LAYER_STEP, layer=1),
        R.FaultSpec("execute", "nan", uid=bad2, step=RES_NAN_STEP + 3)])
    sched = make(dispatch="bcsr", pipeline_depth=1, fault_plan=plan)
    with no_plain():
        drive_scheduler(sched, trace, eos, after_step=keep_moe(faulted))
    failed = survivors(sched, "two-phase bcsr depth 1, faulted")
    moe_equal = len(faulted) == len(fault_free) > 0 and all(
        torch.equal(a, b) for a, b in zip(faulted, fault_free))
    syncs = extra_step_syncs(sched)
    check(failed == [bad2] and moe_equal
          and sched.health.counters["retry"] == 1
          and syncs["syncs"] == step_syncs["bcsr1"]["syncs"],
          f"two-phase bcsr depth 1, faulted: failed {failed} (want "
          f"[{bad2}]), moe leaf equal {moe_equal}, retries "
          f"{sched.health.counters['retry']}, extra step {syncs} (fault-"
          f"free {step_syncs['bcsr1']})")
    out["bcsr_depth1"] = {
        "failed": failed, "survivors_equal": True,
        "moe_equal_after_retry": True, "n_moe": n_moe,
        "triggered": [[*t[:3], list(t[3])] for t in plan.triggered],
        "step_syncs": syncs, "fault_free_step_syncs": step_syncs["bcsr1"]}
    print(f"  two-phase bcsr depth 1: step {RES_LAYER_STEP} retried after "
          f"layer 1's execute raised, the pool's moe leaf after it == "
          f"the fault-free run's; uid {bad2} fails alone, survivors equal; "
          f"an extra step {syncs} (fault-free {step_syncs['bcsr1']})")
    del sched, fault_free, faulted

    # -- kv_wide on the int8-KV scheduler, without EOS: request 0 (budget
    # >= 8) is resident at step RES_WIDE_STEP whatever its int8 tokens
    bad3 = 0
    plan = R.FaultPlan.single("sample", "nan", uid=bad3, step=RES_WIDE_STEP)
    sched = make(dispatch="gather", kv_quant="int8", fault_plan=plan,
                 fail_threshold=1)
    mark = []
    rung = sched._apply_rung

    def noted(name):
        mark.append(len(sched.stats))
        rung(name)

    sched._apply_rung = noted
    with no_plain():
        drive_scheduler(sched, trace, {})
    after = sched.stats[mark[0]:] if mark else []
    caps = [st.seconds * 1e3 for st in after if st.phase == "capture"]
    used = {st.extra["batch_bucket"] for st in after
            if st.phase == "decode"}
    pool = [c["attn"] for c in sched.cache["slots"]]
    got = {r.uid for r in sched.finished}
    check(len(mark) == 1 and sched.ladder.state()["applied"] == ["kv_wide"]
          and sched.kv_quant is None
          and all(set(a) == {"k", "v"} and a["k"].dtype == torch.float32
                  for a in pool)
          and len(caps) == len(used) > 0 and set(sched._fused) == used
          and all(f.graph is not None for f in sched._fused.values())
          and [r.uid for r in sched.failed] == [bad3]
          and got == set(range(len(trace))) - {bad3},
          f"kv_wide: rung marks {mark}, ladder {sched.ladder.state()}, "
          f"captures after {caps} for buckets {sorted(used)}, fused "
          f"{sorted(sched._fused)}, failed "
          f"{[r.uid for r in sched.failed]}, finished {sorted(got)}")
    syncs = extra_step_syncs(sched)
    check(syncs["syncs"] == 1 and syncs["event_waits"] == 0,
          f"kv_wide: an extra fused step synced {syncs}")
    out["kv_wide"] = {"failed": [bad3], "finished": len(got),
                      "buckets_after": sorted(used),
                      "captures_after": len(caps), "capture_ms": caps,
                      "step_syncs": syncs}
    print(f"  kv_wide (int8 KV, fail_threshold 1): uid {bad3} poisoned at "
          f"step {RES_WIDE_STEP}; the pool now f32 without scales; "
          f"{len(caps)} buckets {sorted(used)} captured again "
          f"({', '.join(f'{c:.1f}' for c in caps)} ms); {len(got)} "
          f"requests finished; an extra step {syncs}")
    del sched, pool
    gc.collect()

    # -- the save's cost, fault-free
    out["save_cost"] = save_cost(
        lambda retry: make(dispatch="gather", retry=retry), trace, eos)
    sc = out["save_cost"]
    print(f"  the retry's save, fused gather scheduler: "
          f"{sc['with']['mean']:.1f} tok/s with, {sc['without']['mean']:.1f}"
          f" without ({sc['order']}: "
          f"{sc['without']['tok_per_s'][0]:.1f}, "
          f"{sc['with']['tok_per_s'][0]:.1f}, "
          f"{sc['with']['tok_per_s'][1]:.1f}, "
          f"{sc['without']['tok_per_s'][1]:.1f}); the save at bucket "
          f"{sc['save']['bucket']} {sc['save']['ms']:.4f} ms for "
          f"{sc['save']['bytes']} bytes (bound {sc['save']['bound_ms']:.4f} "
          f"ms); {card}")
    return out


# the bench phases: bench_serve's trace law (``synth_trace``) at phase 6's
# sizes and seed, and its healthy-vs-faulty row at this fault rate
BENCH_TRACE = dict(n_requests=SCHED_REQUESTS, prompt_lo=64, prompt_hi=512,
                   gen_lo=8, gen_hi=32, arrival_every=2)
BENCH_FAULT_RATE = 0.3


def phase_bench_serve(cfg, params):
    """``repro_torch.benchmarks.bench_serve`` at full width on phase 5's
    weights: :data:`BENCH_TRACE` (seed SCHED_SEED, SCHED_SLOTS slots,
    ``max_seq`` SCHED_MAX_SEQ) through fused gather and two-phase bcsr
    schedulers at depths 0 and 1, and each at depth 1 under
    ``FaultPlan.random(17, uids, BENCH_FAULT_RATE)``, the plain decode
    kernels guarded (:class:`no_plain`).  Checks: every healthy run
    finishes all its requests; serial == pipelined tokens on each backend
    and bcsr == gather; the faulted runs' survivors == the healthy run and
    at least one fault fired; ``compile_signatures`` <= ``signature_bound``;
    K2 launched once an execute call in each healthy bcsr run and never in
    a gather run; no attention oracle fallback.  Returns the payload (the
    tokens dropped) with its wall seconds."""
    from repro_torch.benchmarks import bench_serve
    from repro_torch.kernels.flash_attention import ops as flash_ops
    n = BENCH_TRACE["n_requests"]
    print(f"bench_serve at full width: {n} requests of synth_trace (prompts "
          f"{BENCH_TRACE['prompt_lo']}-{BENCH_TRACE['prompt_hi']}, budgets "
          f"{BENCH_TRACE['gen_lo']}-{BENCH_TRACE['gen_hi']}, seed "
          f"{SCHED_SEED}), {SCHED_SLOTS} slots, fault rate "
          f"{BENCH_FAULT_RATE}:")
    fallbacks = flash_ops.fallback_count()
    t0 = time.monotonic()
    with no_plain():
        payload = bench_serve.run(
            cfg=cfg, params=params, trace_kw=dict(BENCH_TRACE,
                                                  vocab=cfg.vocab_size),
            max_seq=SCHED_MAX_SEQ, slots=SCHED_SLOTS, seed=SCHED_SEED,
            fault_rate=BENCH_FAULT_RATE, device="cuda")
    wall = time.monotonic() - t0
    check(flash_ops.fallback_count() == fallbacks,
          "bench_serve: attention oracle fallbacks")
    for backend in ("gather", "bcsr"):
        e = payload[backend]
        runs = (e, e["pipelined"])
        check(all(r["requests_finished"] == n for r in runs),
              f"bench_serve {backend}: finished "
              f"{[r['requests_finished'] for r in runs]} of {n}")
        check(e["ab"]["tokens_match"],
              f"bench_serve {backend}: serial != pipelined tokens")
        fl = e["fault"]
        check(fl["survivor_tokens_match"] and fl["faults_triggered"] >= 1,
              f"bench_serve {backend}: fault row {fl}")
        for r in runs:
            k2 = r["launches"].get("spmm_bcsr", 0)
            if backend == "bcsr":
                check(r["two_phase"]
                      and r["compile_signatures"] <= r["signature_bound"]
                      and k2 == r["execute_calls"] > 0,
                      f"bench_serve bcsr depth {r['pipeline_depth']}: "
                      f"signatures {r.get('compile_signatures')} (bound "
                      f"{r.get('signature_bound')}), K2 {k2} for "
                      f"{r.get('execute_calls')} executes")
            else:
                check(not r["two_phase"] and k2 == 0,
                      f"bench_serve gather: two-phase {r['two_phase']}, "
                      f"K2 {k2}")
    check(payload["bcsr"].pop("tokens") == payload["gather"].pop("tokens"),
          "bench_serve: bcsr tokens != gather tokens")
    for line in bench_serve.rows(payload):
        print(f"  {line}")
    for backend in ("gather", "bcsr"):
        e = payload[backend]
        peaks = [r["peak_gb"] for r in (e, e["pipelined"], e["fault"])]
        cap = " / ".join(f"{r['capture']['ms']:.1f}" if r["capture"]
                         else "-" for r in (e, e["pipelined"], e["fault"]))
        extra = (f"; compile_signatures {e['compile_signatures']} / "
                 f"{e['pipelined']['compile_signatures']} (bound "
                 f"{e['signature_bound']}), K2 {e['launches']['spmm_bcsr']}"
                 f" / {e['pipelined']['launches']['spmm_bcsr']}"
                 if backend == "bcsr" else "")
        print(f"  {backend}: peak GB serial / pipelined / faulty "
              + " / ".join(f"{p:.1f}" for p in peaks)
              + f"; capture ms {cap}; ladder {e['fault']['ladder']}{extra}")
    print(f"  bcsr tokens == gather tokens, {n} of {n} finished in each "
          f"healthy run; bench_serve wall {wall:.1f} s")
    payload["wall_s"] = wall
    return payload


def phase_bench_moe():
    """``repro_torch.benchmarks.bench_moe`` at the reference's shapes on the
    card: ``run`` (its ``torch.equal`` checks: bcsr == gather in the layer,
    two-phase == gather, pipelined chain == serial chain) and
    ``run_host_dispatch``, the plain decode kernels guarded; every call the
    reference jit-compiles replayed from a CUDA graph; K2's launches
    counted (from 0) and at least one.  Returns the payload, the launches
    and the wall seconds."""
    from repro_torch.benchmarks import bench_moe
    print("bench_moe at the reference's shapes (T 4096, d 256, 16 experts; "
          "the in-layer A/B at 512 x 128):")
    bench_json: dict = {}
    reset_launches()
    t0 = time.monotonic()
    with no_plain():
        rows = bench_moe.run(bench_json, device="cuda")
        rows += bench_moe.run_host_dispatch(bench_json, device="cuda")
    wall = time.monotonic() - t0
    launches = {k: v for k, v in read_launches().items() if v}
    modes = [*bench_json["two_phase"]["modes"].values(),
             *bench_json["host_dispatch"]["modes"].values()]
    check(launches.get("spmm_bcsr", 0) > 0 and set(modes) == {"graph"},
          f"bench_moe: launches {launches}, modes {modes}")
    bench_json["rows"] = rows
    for line in rows:
        print(f"  {line}")
    print(f"  launches {launches}; bench_moe wall {wall:.1f} s")
    return {**bench_json, "launches": launches, "wall_s": wall}


def _attn_prompts(cfg):
    import torch
    g = torch.Generator(device="cuda").manual_seed(2)
    return torch.randint(0, cfg.vocab_size, (BATCH, ATTN_PROMPT), generator=g,
                         device="cuda")


def serving_mask(cfg, S: int = ATTN_PROMPT):
    """The masked serving spec (without ``impl``) and its mask at the
    prompt length ``S``: the opt-in long-context pattern, a causal local
    window of MASK_WINDOW plus the first KV tile, at the tiles of the
    ``flash`` cuda row.  A synthetic pattern that exercises the masked
    kernels, not llama4-scout's own chunked attention."""
    import torch
    from repro_torch.core.masks import AttnMaskSpec
    from repro_torch.kernels import tuning
    bq, bk = tuning.flash_tiles(S, S, cfg.hd, torch.bfloat16, "cuda")
    spec = dict(local=True, pattern="local_global", window=MASK_WINDOW,
                n_global=1, bq=bq, bk=bk)
    mask = AttnMaskSpec(**spec).build(S, S, layer_window=None, bq=bq, bk=bk)
    return spec, mask


def phase_masked_serving(cfg, params):
    """Masked serving at full width: the same weights serve 4 prompts of
    ATTN_PROMPT tokens through ``ServeLoop(attn_mask=...)``, walking the
    mask's stream (K4s) and over the masked full grid (K4m), in the order
    sparse, dense, dense, sparse; one launch per layer's prefill (decode
    attention is not masked: D1 once an attention layer a decode step), K2
    and R1 at every MoE layer of every pass, identical tokens, no oracle
    fallback.  Each run records its prefill and the host route / execute
    time inside it.  The first run's first dispatch stream (layer 0's
    prefill) is captured for the K2 row, its last D1 call (a 2,064-position
    cache) and first R1 call (8,192 tokens) for theirs.  Then one run of a
    ``pipeline_depth=1`` loop through K4s (after a warm-up): the same
    tokens and launches, no fallback, and its prefill's route ms, fetch
    wait and hidden route ms."""
    import numpy as np
    import torch
    from repro_torch.core.masks import AttnMaskSpec
    from repro_torch.kernels import engine
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.serve import ServeLoop
    # what a prefill pays once for its mask (the layers share it): build,
    # lowering and the upload of its index arrays
    t0 = time.monotonic()
    spec, mask = serving_mask(cfg)
    stream = mask.lower(bucket=True)
    for a in (stream.rows, stream.cols, stream.kinds, mask.tile_kinds):
        torch.as_tensor(a).to("cuda", torch.int32)
    torch.cuda.synchronize()
    mask_ms = (time.monotonic() - t0) * 1e3
    print(f"masked serving: {mask}; density {mask.density()}; stream "
          f"capacity {stream.capacity}; build + lower + upload "
          f"{mask_ms:.3f} ms")
    prompts = _attn_prompts(cfg)
    n_moe = cfg.block_unit.count("attn+moe") * cfg.n_repeats
    kernels = {"sparse": "flash_attention_sparse",
               "dense": "flash_attention_masked"}
    loops = {impl: ServeLoop(params, cfg, max_seq=ATTN_PROMPT + GEN,
                             dispatch="bcsr",
                             attn_mask=AttnMaskSpec(**spec, impl=impl))
             for impl in kernels}
    for loop in loops.values():
        loop.run(prompts, 2)                  # warm-up
    runs = {impl: [] for impl in kernels}
    captured = []
    stream_entry = engine.spmm_batched_stream

    def capture(a, dense, **kw):        # keep the first call
        if not captured:
            captured.append((a, dense, kw))
        return stream_entry(a, dense, **kw)

    decode_calls = {}

    def keep(name, args, kw):   # R1's first call (prefill), D1's last
        if name == "decode_attention":
            decode_calls["d1_long"] = (args, kw)
        elif name == "router_logits" \
                and "r1_long_prefill" not in decode_calls:
            decode_calls["r1_long_prefill"] = (args, kw)

    for n, impl in enumerate(("sparse", "dense", "dense", "sparse")):
        loop, kernel = loops[impl], kernels[impl]
        ops.reset_fallbacks()
        engine.spmm_batched_stream = capture if n == 0 else stream_entry
        reset_launches()
        try:
            with hook_calls(keep if n == 0 else (lambda *a: None)), \
                    no_plain():
                tokens = loop.run(prompts, GEN)   # the main path
        finally:
            engine.spmm_batched_stream = stream_entry
        counts = read_launches()
        summary = loop.summary()
        prefill = {ph: 1e3 * sum(st.seconds for st in loop.stats
                                 if st.phase == ph and st.step == -1)
                   for ph in ("prefill", "route", "execute")}
        print(f"  {impl}: launches {counts}; prefill "
              f"{prefill['prefill']:.1f} ms (route {prefill['route']:.1f}, "
              f"execute {prefill['execute']:.1f}), decode "
              f"{summary['decode']['tok_per_s']:.1f} tok/s; tokens "
              f"{tokens[0, :8].tolist()} ...")
        want = decode_counts(cfg, 1, GEN - 1, spmm_bcsr=n_moe * GEN,
                             **{kernel: cfg.n_layers})
        check(counts == want, f"{impl}: launches {counts} != {want}")
        check(ops.fallback_count() == 0
              and summary["timing"]["attention_ref_fallbacks"] == 0,
              f"{impl}: oracle fallbacks {ops.fallback_reasons()}")
        check(tokens.shape == (BATCH, GEN) and (tokens >= 0).all()
              and (tokens < cfg.vocab_size).all(), "bad token ids")
        runs[impl].append({
            "tokens": tokens, "launches": counts[kernel],
            "prefill_ms": prefill["prefill"],
            "prefill_route_ms": prefill["route"],
            "prefill_execute_ms": prefill["execute"],
            "decode_tok_per_s": summary["decode"]["tok_per_s"],
            "nnzb_stream_mean": summary["stream"]["nnzb_stream_mean"]})
    first = runs["sparse"][0]["tokens"]
    check(all(np.array_equal(r["tokens"], first)
              for rs in runs.values() for r in rs),
          "sparse-masked tokens != dense-masked tokens")
    print("  sparse tokens == dense tokens (4 runs)")

    loop1 = ServeLoop(params, cfg, max_seq=ATTN_PROMPT + GEN,
                      dispatch="bcsr", pipeline_depth=1,
                      attn_mask=AttnMaskSpec(**spec, impl="sparse"))
    loop1.run(prompts, 2)                     # warm-up
    ops.reset_fallbacks()
    reset_launches()
    with no_plain():
        tokens = loop1.run(prompts, GEN)      # the main path at depth 1
    counts = read_launches()
    want = decode_counts(cfg, 1, GEN - 1, spmm_bcsr=n_moe * GEN,
                         flash_attention_sparse=cfg.n_layers)
    check(counts == want, f"sparse, depth 1: launches {counts} != {want}")
    check(ops.fallback_count() == 0
          and loop1.summary()["timing"]["attention_ref_fallbacks"] == 0,
          f"sparse, depth 1: oracle fallbacks {ops.fallback_reasons()}")
    check(np.array_equal(tokens, first),
          "sparse, depth 1: tokens != the depth-0 runs' tokens")
    routes = [st for st in loop1.stats if st.phase == "route"
              and st.step == -1]
    depth1 = {**serve_numbers(1, loop1.summary()),
              "prefill_route_ms": 1e3 * sum(st.seconds for st in routes),
              "prefill_route_wait_ms": 1e3 * sum(st.extra["wait_s"]
                                                 for st in routes),
              "prefill_route_hidden_ms": 1e3 * sum(st.extra["hidden_s"]
                                                   for st in routes)}
    print_serve("sparse, depth 1", depth1)
    print(f"    prefill route {depth1['prefill_route_ms']:.1f} ms (wait "
          f"{depth1['prefill_route_wait_ms']:.1f}, hidden "
          f"{depth1['prefill_route_hidden_ms']:.1f}); launches {counts}; "
          f"tokens == depth 0")
    return mask, runs, mask_ms, captured[0], depth1, decode_calls


def phase_kernel_prefill(cfg, params):
    """Kernel prefill at full width: ``prefill_layered(impl="kernel")`` on
    the 2048-token prompts runs K3 once a layer; the logits are finite.
    The default ``impl="chunked"`` prefill (bf16 operands, f32 products) on
    the same prompts is timed too (after a warm-up), with R1 and K2 once a
    MoE layer and no flash kernel.
    Then layer 0's q, k, v (bf16) give K3 == K4s on ``BlockMask.causal``
    exactly, and are returned for the kernel rows.  The first token's
    agreement with ``impl="chunked"`` and with ``impl="ref"`` (the
    materialized f32 oracle) is printed as information only: the kernels
    keep p at f32 precision in the PV product (bf16 q, k, v: as a bf16 hi +
    lo pair), as the oracle does; chunked rounds it to bf16."""
    import torch
    from repro_torch.core.masks import BlockMask
    from repro_torch.kernels import tuning
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    prompts = _attn_prompts(cfg)
    kw = dict(max_seq=ATTN_PROMPT, moe_fn=_bcsr_moe())
    M.prefill_layered(params, prompts, cfg, impl="kernel", **kw)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.monotonic()
    logits, _, _ = M.prefill_layered(params, prompts, cfg, impl="kernel",
                                     **kw)                # the main path
    torch.cuda.synchronize()
    prefill_ms = (time.monotonic() - t0) * 1e3
    counts = read_launches()
    n_moe = cfg.block_unit.count("attn+moe") * cfg.n_repeats
    want = only(spmm_bcsr=n_moe, flash_attention=cfg.n_layers,
                router_logits=n_moe)
    check(counts == want, f"kernel prefill: launches {counts} != {want}")
    check(tuple(logits.shape) == (BATCH, 1, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()),
          "kernel prefill logits not finite")
    # the default prefill, chunked attention on bf16 operands: warm-up, then
    # timed as the kernel prefill is
    M.prefill_layered(params, prompts, cfg, impl="chunked", **kw)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.monotonic()
    with no_plain():
        chunked, _, _ = M.prefill_layered(params, prompts, cfg,
                                          impl="chunked", **kw)
    torch.cuda.synchronize()
    chunked_ms = (time.monotonic() - t0) * 1e3
    chunked_counts = read_launches()
    want = only(spmm_bcsr=n_moe, router_logits=n_moe)
    check(chunked_counts == want,
          f"chunked prefill: launches {chunked_counts} != {want}")
    check(bool(torch.isfinite(chunked).all()),
          "chunked prefill logits not finite")
    first = logits[:, -1, :cfg.vocab_size].argmax(-1)
    against = {}
    for impl in ("chunked", "ref"):
        other = chunked if impl == "chunked" else M.prefill_layered(
            params, prompts, cfg, impl=impl, **kw)[0]
        against[impl] = (
            (first == other[:, -1, :cfg.vocab_size].argmax(-1)).float()
            .mean().item(), (logits - other).abs().max().item())
        del other
    del chunked
    print(f"kernel prefill: launches {counts}; {prefill_ms:.1f} ms; chunked "
          f"prefill (bf16 operands): {chunked_ms:.1f} ms, launches "
          f"{chunked_counts}; first token agrees with " + ", ".join(
              f"{impl} on {a:.2f} of the rows (logits differ by up to "
              f"{d:.3g})" for impl, (a, d) in against.items())
          + " (information only)")

    x = M._embed(params, prompts, cfg)
    p0 = M._take(params["blocks"][0], 0)
    h = L.rmsnorm(p0["ln1"], x, cfg.norm_eps)
    q, k, v = (t.contiguous() for t in L._qkv(
        p0["attn"], h, cfg, torch.arange(ATTN_PROMPT, device="cuda")))
    bq, bk = tuning.flash_tiles(ATTN_PROMPT, ATTN_PROMPT, cfg.hd, q.dtype,
                                "cuda")
    s = BlockMask.causal(ATTN_PROMPT, ATTN_PROMPT, bq=bq, bk=bk).lower()
    k3 = fk.flash_attention(q, k, v, causal=True, bq=bq, bk=bk)
    k4 = fk.flash_attention_sparse(q, k, v, s.rows, s.cols, s.kinds,
                                   skv=ATTN_PROMPT, bq=bq, bk=bk)
    check(torch.equal(k3, k4), "layer 0: K3 != K4s on BlockMask.causal")
    print(f"  layer 0 q {tuple(q.shape)} k/v {tuple(k.shape)} {q.dtype}: "
          f"K3 == K4s(causal), tiles {bq}x{bk}")
    return {"launches": counts, "prefill_ms": prefill_ms,
            "chunked_prefill_ms": chunked_ms,
            "first_token_agreement": against["chunked"][0],
            "logits_max_diff": against["chunked"][1],
            "first_token_agreement_ref": against["ref"][0],
            "logits_max_diff_ref": against["ref"][1]}, (q, k, v)


def phase_measure_attention(qkv, mask, launches, card, *,
                            k3_window=None, suffix="", names=None):
    """The K3, K4m and K4s rows at the slice's attention shape: layer 0's
    q, k, v of the 2048-token prompts (bf16), K3 causal, K4 on the serving
    mask (gemma3-12b's: a local layer's q, k, v at D 256, K3 causal under
    ``k3_window``, K4 on the sliding-window mask, each row's name with
    ``suffix``; ``names``: these kernels' rows alone).  ``ms``: CUDA events
    over back-to-back launches (``graph_ms``: replayed from a CUDA graph);
    ``plain_ms``: the plain tile loop;
    ``library_ms``: one
    ``scaled_dot_product_attention`` call (``is_causal`` for K3 without a
    window, else the mask's dense boolean; GQA heads expanded beforehand),
    a yardstick the port never calls.  The bound is the larger of the
    FLOPs of the visible score entries (4 D each: q k^T and p v) at the
    bf16 peak and the bytes of q, k, v, the index arrays and the output
    moved once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.masks import BlockMask
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref
    q, k, v = qkv
    B, Hq, S, D = q.shape
    g = Hq // k.shape[1]
    bq, bk = mask.bq, mask.bk
    causal = BlockMask.full(S, S, bq=bq, bk=bk, causal=True,
                            window=k3_window)
    st = mask.lower(bucket=True)
    dev = lambda a: torch.as_tensor(a).to("cuda", torch.int32)  # noqa: E731
    kinds = dev(mask.tile_kinds)
    rows, cols, skinds = dev(st.rows), dev(st.cols), dev(st.kinds)
    k_rep, v_rep = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    dense = torch.from_numpy(mask.dense_mask()).cuda()
    k3_sdpa = (dict(is_causal=True) if k3_window is None else
               dict(attn_mask=torch.from_numpy(causal.dense_mask()).cuda()))
    qkvo_bytes = 2 * q.numel() * q.element_size() \
        + (k.numel() + v.numel()) * k.element_size()
    calls = {
        "flash_attention": (
            ":84", causal, 0,
            lambda: fk.flash_attention(q, k, v, causal=True,
                                       window=k3_window, bq=bq, bk=bk),
            lambda: ref.flash_attention_ref(q, k, v, causal=True,
                                            window=k3_window, bq=bq, bk=bk),
            lambda: F.scaled_dot_product_attention(q, k_rep, v_rep,
                                                   **k3_sdpa)),
        "flash_attention_masked": (
            ":212", mask, kinds.numel() * 4,
            lambda: fk.flash_attention_masked(q, k, v, kinds, skv=S,
                                              window=mask.window),
            lambda: ref.flash_attention_masked_ref(q, k, v, mask.tile_kinds,
                                                   skv=S, window=mask.window),
            lambda: F.scaled_dot_product_attention(q, k_rep, v_rep,
                                                   attn_mask=dense)),
        "flash_attention_sparse": (
            ":297", mask, 3 * st.capacity * 4,
            lambda: fk.flash_attention_sparse(q, k, v, rows, cols, skinds,
                                              skv=S, window=mask.window,
                                              bq=bq, bk=bk),
            lambda: ref.flash_attention_sparse_ref(
                q, k, v, st.rows, st.cols, st.kinds, skv=S,
                window=mask.window, bq=bq, bk=bk),
            lambda: F.scaled_dot_product_attention(q, k_rep, v_rep,
                                                   attn_mask=dense)),
    }
    out = []
    for name, (line, m, idx_bytes, kern, plain, lib) in calls.items():
        if names is not None and name not in names:
            continue
        err = max_err(kern(), plain(), f"{name}{suffix} at the slice's "
                                       "shape")
        ms = time_ms(kern, 10, 2)
        graph = graph_ms(kern)
        plain_ms = time_ms(plain, 2, 1)
        library_ms = time_ms(lib, 10, 2)
        entries = int(m.dense_mask().sum())
        ops_ms = 4 * B * Hq * D * entries / BF16_FLOP_PER_S * 1e3
        bytes_ms = (qkvo_bytes + idx_bytes) / HBM_BYTES_PER_S * 1e3
        out.append({
            "name": name + suffix, "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": FLASH_SRC + line, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "graph_ms": graph,
            "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms,
            "tiles": {"bq": bq, "bk": bk, "visible": m.nnzb,
                      "dense": m.n_q_tiles * m.n_kv_tiles,
                      "visible_entries_per_head": entries},
            "shape": {"B": B, "Hq": Hq, "Hkv": k.shape[1], "S": S, "D": D,
                      "dtype": str(q.dtype)[6:], "k3_window": k3_window},
            "card": card})
        print(f"  {name}{suffix}: {ms:.3f} ms (graph {graph:.3f}; bound "
              f"{max(ops_ms, bytes_ms):.4f}, "
              f"plain {plain_ms:.1f}, sdpa {library_ms:.3f}), max_abs_err "
              f"{err:.3g}, tiles {m.nnzb}/{m.n_q_tiles * m.n_kv_tiles}")
    return out


def _stream_times(captured, what: str, *, second_bn: bool = False,
                  plain_iters: int = 5):
    """K2 on one captured dispatch stream: its row statistics, exactness vs
    plain (and with ``second_bn`` at a second ``bn`` too), then times of the
    kernel, the plain version (``plain_iters`` calls) and one ``torch.bmm``
    of the densified 0/1 matrix, back to back and (kernel and bmm) from a
    CUDA graph, and the bound.  The bound counts each input byte read once
    and each output byte written once (the kernel re-reads dense K-slices
    per stream entry, mostly from L2), and the nonzero blocks'
    multiply-adds."""
    import torch
    from repro_torch.kernels import tuning
    from repro_torch.kernels.spmm.kernel import spmm_bcsr
    from repro_torch.kernels.spmm.ops import stream_row_stats
    from repro_torch.kernels.spmm.ref import spmm_bcsr_ref
    a, dense, kw = captured
    bn = kw.get("bn")
    odt = kw.get("out_dtype") or dense.dtype
    dense = dense.contiguous()
    args = (a.indptr, a.block_cols, a.blocks, dense)
    B, nnzb, bm, bk = a.blocks.shape
    stats = stream_row_stats(a)
    print(f"  {what} stream: gm {stats['gm']}, nnzb routed / covered / "
          f"stream {stats['nnzb_routed']} / {stats['nnzb_covered']} / "
          f"{stats['nnzb_stream']}; entries of the largest row "
          f"{stats['row_max']}, of the last {stats['row_last']}, median of "
          f"the others {stats['row_median_others']}; "
          f"{stats['zero_blocks']} of {B * nnzb} blocks zero")
    got = spmm_bcsr(*args, out_dtype=odt, bn=bn)
    want = spmm_bcsr_ref(*args, out_dtype=odt)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"kernel != plain on the {what} stream")
    extra = {}
    if second_bn:
        unit = tuning.spmm_col_unit(dense.dtype)
        bn2 = unit if bn != unit else 2 * unit
        check(torch.equal(spmm_bcsr(*args, out_dtype=odt, bn=bn2), got),
              f"K2 at bn {bn2} != at bn {bn} on the {what} stream")
        extra["equal_at_bn"] = [bn, bn2]
        print(f"  {what} stream: K2 at bn {bn2} == at bn {bn}")
    err = (got.float() - want.float()).abs().max().item()
    ms = time_ms(lambda: spmm_bcsr(*args, out_dtype=odt, bn=bn), 50)
    plain_ms = time_ms(lambda: spmm_bcsr_ref(*args, out_dtype=odt),
                       plain_iters, min(1, plain_iters - 1))
    a_dense = a.todense()
    library_ms = time_ms(lambda: torch.bmm(a_dense, dense), 50)
    graph = {"ms": graph_ms(lambda: spmm_bcsr(*args, out_dtype=odt, bn=bn)),
             "library_ms": graph_ms(lambda: torch.bmm(a_dense, dense))}
    N = dense.shape[-1]
    nbytes = (a.blocks.numel() * a.blocks.element_size()
              + dense.numel() * dense.element_size()
              + got.numel() * got.element_size()
              + 4 * (a.indptr.numel() + a.block_cols.numel()))
    ops = 2 * (B * nnzb - stats["zero_blocks"]) * bm * bk * N
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_FLOP_PER_S * 1e3
    print(f"  {what} stream: K2 {ms:.4f} ms (bound {max(bytes_ms, ops_ms):.4f}"
          f", plain {plain_ms:.1f}, bmm {library_ms:.4f}; from a CUDA graph "
          f"K2 {graph['ms']:.4f}, bmm {graph['library_ms']:.4f}), == plain")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "graph": graph, "bn": bn, **extra,
            "shape": {"B": B, "nnzb": nnzb, "block": [bm, bk],
                      "K": dense.shape[1], "N": N, "dtype": str(odt)[6:]},
            "rows": stats}


def phase_measure(captured, masked_stream, launches, card, sched_streams,
                  sched_runs, *, tag: str = ""):
    """The K2 row (its name with ``tag``): measured at the prefill stream
    (the first dispatch of the main run), with the last decode step's
    stream, the 4 x 2048 masked prefill's first stream (plain timed once),
    and the scheduler's first admission stream and first stream at its
    largest decode bucket beside it; the scheduler runs' K2 launches too."""
    prefill = _stream_times(captured[0], "4 x 256 prefill", second_bn=True)
    decode = _stream_times(captured[1], "last decode")
    masked = _stream_times(masked_stream, "4 x 2048 masked prefill",
                           plain_iters=1)
    admission = _stream_times(sched_streams[0], "scheduler admission")
    bucket = _stream_times(sched_streams[1], "scheduler decode, top bucket")
    return {"name": "spmm_bcsr" + tag, "route": "cuda",
            "source": "src/repro_torch/kernels/spmm/csrc/spmm_bcsr.cu",
            "replaces": "src/repro/kernels/spmm/kernel.py:74",
            "launches": launches, **prefill, "decode_stream": decode,
            "masked_prefill_stream": masked,
            "scheduler_admission_stream": admission,
            "scheduler_decode_stream": bucket,
            "scheduler_launches": {
                r["label"]: r["k2_launches"] for r in sched_runs},
            "card": card}


def _decode_times(call, what: str) -> dict:
    """D1 on one captured call: error against plain (within
    :func:`decode_tolerance`), times of the kernel (back to back and from
    a CUDA graph), the plain version and one
    ``scaled_dot_product_attention`` call (``enable_gqa``, a boolean mask of
    each row's visible positions), and the bound: the visible K and V, q,
    the output and the lengths moved once at 3.35 TB/s, or 4 D flops a
    (query head, visible position) at the f32 peak, whichever is larger."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref
    (q, k, v), kw = call
    B, Hq, _, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    window = kw.get("window")
    lens = kw["kv_len"]
    lens = (lens.reshape(-1) if isinstance(lens, torch.Tensor)
            else torch.full((B,), int(lens), device="cuda")).long()
    hi = lens.clamp(max=S)
    lo = (lens - window).clamp(min=0) if window is not None \
        else torch.zeros_like(lens)
    pos = torch.arange(S, device="cuda")
    vis = (pos >= lo[:, None]) & (pos < hi[:, None])          # (B, S)
    visible = int(vis.sum().item())
    got = fk.decode_attention(q, k, v, **kw)
    want = ref.decode_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = decode_tolerance(want.float().abs().max().item(), q.dtype, k.dtype)
    check(err <= tol, f"D1 on the {what} call: {err} > {tol}")
    mask = vis[:, None, None, :]
    run = lambda: fk.decode_attention(q, k, v, **kw)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, enable_gqa=True)
    ms, plain_ms = time_ms(run, 50), time_ms(
        lambda: ref.decode_attention_ref(q, k, v, **kw), 20)
    library_ms = time_ms(lib, 50)
    graph = {"ms": graph_ms(run), "library_ms": graph_ms(lib)}
    kv_bytes = 2 * visible * Hkv * D * k.element_size()
    nbytes = kv_bytes + 2 * q.numel() * q.element_size() + 8 * B
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * D * (Hq // Hkv) * Hkv * visible / F32_FLOP_PER_S * 1e3
    # a group past ref.DECODE_PASS_HEADS is taken in passes, each reading
    # the visible K and V once
    passes = -(-(Hq // Hkv) // ref.DECODE_PASS_HEADS)
    passes_ms = (nbytes + (passes - 1) * kv_bytes) / HBM_BYTES_PER_S * 1e3
    launch = fk.decode_info(D, q.dtype, k.dtype)
    print(f"  D1 {what} (B {B}, {Hq}/{Hkv}, cache {S}, {visible // B} "
          f"visible a row on average, {str(k.dtype)[6:]}): {ms:.4f} ms "
          f"(graph {graph['ms']:.4f}; bound {max(bytes_ms, ops_ms):.5f}"
          + (f", {passes} passes {max(passes_ms, ops_ms):.5f}"
             if passes > 1 else "")
          + f", plain {plain_ms:.3f}, sdpa {library_ms:.4f}, graph "
          f"{graph['library_ms']:.4f}), max_abs_err {err:.3g}; "
          f"{B * Hkv * passes} clusters of {launch['cluster']} CTAs x "
          f"{launch['threads']} threads, chunks of {launch['chunk']}, "
          f"{launch['dynamic_smem'] + launch['static_smem']} B shared a CTA "
          f"({launch['dynamic_smem']} dynamic), {launch['registers']} "
          f"registers, {launch['resident_clusters']} clusters resident")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "passes": passes, "passes_bound_ms": max(passes_ms, ops_ms),
            "library_ms": library_ms, "graph": graph, "launch": launch,
            "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "S_cap": S, "D": D,
                      "visible": visible, "window": window,
                      "q_dtype": str(q.dtype)[6:],
                      "cache_dtype": str(k.dtype)[6:]}}


def _router_times(call, what: str) -> dict:
    """R1 on one captured call: error against plain (within 1e-5 of the
    largest |logit|), times of the kernel (back to back and from a CUDA
    graph), the plain version and one ``torch.matmul`` of x already in f32
    by W, and the bound: x, W and the logits moved once, or 2 T d E flops
    at the f32 peak.  Beside it the no-FMA floor: the order makes each term
    a multiply and an add, 2 T d E f32 instructions on 128 lanes an SM at
    the SM clock read around the timings."""
    import torch
    from repro_torch.kernels.router import kernel as rk
    from repro_torch.kernels.router.ref import router_logits_ref
    (x, w), _ = call
    got = rk.router_logits(x, w)
    err = max_err(got, router_logits_ref(x, w), f"R1 on the {what} call")
    xf = x.float()
    run = lambda: rk.router_logits(x, w)  # noqa: E731
    lib = lambda: torch.matmul(xf, w)  # noqa: E731
    clocks = [smi("clocks.sm")]
    ms = time_ms(run, 50)
    plain_ms = time_ms(lambda: router_logits_ref(x, w), 50)
    library_ms = time_ms(lib, 50)
    graph = {"ms": graph_ms(run), "library_ms": graph_ms(lib)}
    clocks.append(smi("clocks.sm"))
    T, d, E = x.numel() // x.shape[-1], w.shape[0], w.shape[1]
    nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
              + got.numel() * 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * T * d * E / F32_FLOP_PER_S * 1e3
    mhz = min(float(c.split()[0]) for c in clocks)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    floor_ms = 2 * T * d * E / (sms * 128 * mhz * 1e6) * 1e3
    print(f"  R1 {what} ({T} x {d} x {E}, x {str(x.dtype)[6:]}): {ms:.4f} ms"
          f" (graph {graph['ms']:.4f}; bound {max(bytes_ms, ops_ms):.5f} "
          f"(bytes {bytes_ms:.5f}), no-FMA floor {floor_ms:.5f} at {mhz:.0f}"
          f" MHz; plain {plain_ms:.4f}, matmul {library_ms:.4f}, graph "
          f"{graph['library_ms']:.4f}), max_abs_err {err:.3g}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "graph": graph,
            "no_fma_floor_ms": floor_ms, "sm_clocks": clocks,
            "shape": {"T": T, "d": d, "E": E, "x_dtype": str(x.dtype)[6:],
                      "w_dtype": str(w.dtype)[6:]}}


def _row_sum_times(x2, what: str) -> dict:
    """R1 as ``router.ops.row_sum`` on one captured decode norm's squared
    hidden state ``x2`` (B, 1, d) f32: :func:`_row_sum_case` on its rows
    and their copies scaled by 2, 4 and 8 (exact, so 4 B distinct rows
    for BATCH_LAW); the kernel's time back to back and from a CUDA graph
    at the served B, beside the plain version (``router_logits_ref``, x
    by the ones column), ``torch.sum`` (``library_ms``) and ``torch.mean``
    the same two ways; the bound: x, the column and the sums moved once,
    or 2 B d flops at the f32 peak."""
    import torch
    from repro_torch.kernels.router import ops as rops
    from repro_torch.kernels.router.ref import router_logits_ref
    B, d = x2.numel() // x2.shape[-1], x2.shape[-1]
    x2 = x2.reshape(B, d)
    err = _row_sum_case(torch.cat([x2 * 2.0 ** j for j in range(4)]),
                        f"R1 row sum on the {what} norm")
    ones = torch.ones((d, 1), device=x2.device)
    run = lambda: rops.row_sum(x2)  # noqa: E731
    lib = lambda: torch.sum(x2, -1, keepdim=True)  # noqa: E731
    mean = lambda: torch.mean(x2, -1, keepdim=True)  # noqa: E731
    ms = time_ms(run, 50)
    plain_ms = time_ms(lambda: router_logits_ref(x2, ones), 50)
    library_ms, mean_ms = time_ms(lib, 50), time_ms(mean, 50)
    graph = {"ms": graph_ms(run), "library_ms": graph_ms(lib),
             "mean_ms": graph_ms(mean)}
    bytes_ms = (x2.numel() + d + B) * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * B * d / F32_FLOP_PER_S * 1e3
    print(f"  R1 row sum, {what} norm ({B} x {d}, x float32): {ms:.4f} ms "
          f"(graph {graph['ms']:.4f}; bound {max(bytes_ms, ops_ms):.5f}; "
          f"plain {plain_ms:.4f}, torch.sum {library_ms:.4f}, graph "
          f"{graph['library_ms']:.4f}, torch.mean {mean_ms:.4f}, graph "
          f"{graph['mean_ms']:.4f}), max_abs_err {err:.3g}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "mean_ms": mean_ms, "graph": graph,
            "shape": {"T": B, "d": d, "E": 1, "x_dtype": "float32",
                      "w_dtype": "float32"}}


def phase_measure_decode(calls, launches, card, *, tag: str = ""):
    """The D1 and R1 rows (their names with ``tag``), measured at the calls the main path made: D1 at
    the 4 x 256 run's last decode step (with the scheduler's first step at
    its largest bucket and the 4 x 2048 masked run's last decode step
    beside it), R1 at the 4 x 256 run's last decode step (with its prefill,
    the scheduler's largest bucket and the 4 x 2048 prefill beside it, and
    the first decode step's first norm as a row sum, :func:`_row_sum_times`);
    ``launches`` are the 4 x 256 bcsr run's."""
    d1 = _decode_times(calls["d1_decode"], "4 x 256, last decode step")
    d1_bucket = _decode_times(calls["d1_bucket"], "scheduler, top bucket")
    d1_long = _decode_times(calls["d1_long"], "4 x 2048, last decode step")
    r1 = _router_times(calls["r1_decode"], "4 x 256, last decode step")
    r1_prefill = _router_times(calls["r1_prefill"], "4 x 256 prefill")
    r1_bucket = _router_times(calls["r1_bucket"], "scheduler, top bucket")
    r1_long = _router_times(calls["r1_long_prefill"], "4 x 2048 prefill")
    r1_norm = _row_sum_times(calls["r1_norm"], "4 x 256 first decode step, "
                                               "layer 0 ln1")
    return [{"name": "decode_attention" + tag, "route": "cuda",
             "source": "src/repro_torch/kernels/flash_attention/csrc/"
                       "decode_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/ops.py:212 "
                         "(array code, no Pallas kernel)",
             "launches": launches["decode_attention"], **d1,
             "scheduler_bucket_call": d1_bucket,
             "masked_4x2048_decode_call": d1_long, "card": card},
            {"name": "router_logits" + tag, "route": "cuda",
             "source": "src/repro_torch/kernels/router/csrc/router.cu",
             "replaces": "src/repro/models/moe.py:232 (array code, no "
                         "Pallas kernel)",
             "launches": launches["router_logits"], **r1,
             "prefill_call": r1_prefill, "scheduler_bucket_call": r1_bucket,
             "prefill_4x2048_call": r1_long, "rmsnorm_calls": [r1_norm],
             "card": card}]


# ---------------------------------------------------------------------------
# Phases 5-8 on one MoE arch: llama4-scout (MoE in every layer, 16 experts)
# and llama4-maverick-400b-a17b (the one stack that interleaves dense and MoE
# layers, and the one with 128 experts) go through the same code.
# ---------------------------------------------------------------------------

def serve_moe(arch: str, card, mark, *, tag: str = "", between=None):
    """Phases 5-8 on the MoE arch ``arch`` at full width and ``DEPTH[arch]``
    (scout 4 of 48 layers; maverick 1 of 24 units, a dense layer and a MoE
    layer of 128 experts, 37.1 GB): :func:`phase_slice`,
    :func:`phase_scheduler` (the runs ``SCHED_KEYS[arch]``), then
    ``between(cfg, params, scheduler, clean)`` where given (scout's
    quantized, resilience and benchmark phases), :func:`phase_masked_serving`,
    :func:`phase_kernel_prefill` and :func:`phase_expert_bmm`; ``mark(name)``
    after each group.  Then, the weights released, the K2, D1, R1, K3, K4m
    and K4s rows at the arch's served shapes (:func:`phase_measure`,
    :func:`phase_measure_decode`, :func:`phase_measure_attention`), each
    row's name with ``tag``.  Returns (summary, kernel rows, what
    ``between`` returned)."""
    import torch
    cfg, params, summary, launches, captured, pipelined, calls = \
        phase_slice(arch)
    mark(f"{arch} slice")
    scheduler, sched_streams, sched_calls, clean = phase_scheduler(
        cfg, params, SCHED_KEYS[arch])
    mark(f"{arch} scheduler")
    extra = between(cfg, params, scheduler, clean) if between else None
    del clean
    mask, masked, mask_ms, masked_stream, masked1, masked_calls = \
        phase_masked_serving(cfg, params)
    kprefill, qkv = phase_kernel_prefill(cfg, params)
    experts = phase_expert_bmm(cfg, params)
    mark(f"{arch} masked and K3 prefill, expert bmm")
    calls.update(sched_calls, **masked_calls)
    del params, sched_calls, masked_calls
    gc.collect()            # the loops' reference cycles hold the weights
    torch.cuda.empty_cache()
    print(f"kernel times at {arch}'s served shapes:")
    clocks = {"before_kernels": smi(CLOCKS)}
    print(f"  sm clock, max: {clocks['before_kernels']}")
    rows = [phase_measure(captured, masked_stream, launches["spmm_bcsr"],
                          card, sched_streams, scheduler["runs"], tag=tag)]
    rows += phase_measure_decode(calls, launches, card, tag=tag)
    rows += phase_measure_attention(qkv, mask, {
        "flash_attention": kprefill["launches"]["flash_attention"],
        "flash_attention_masked": masked["dense"][0]["launches"],
        "flash_attention_sparse": masked["sparse"][0]["launches"]}, card,
        suffix=tag)
    clocks["after_kernels"] = smi(CLOCKS)
    print(f"  sm clock, max: {clocks['after_kernels']}")
    del qkv, captured, masked_stream, sched_streams, calls
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    mark(f"{arch} kernel times")
    fused = pipelined.pop("fused")
    runs = {r["label"]: r for r in fused["runs"]}
    sched = {r["label"]: r for r in scheduler["runs"]}
    info = {"arch": cfg.name, "depth": cfg.n_repeats, "layers": cfg.n_layers,
            "batch": BATCH, "prompt": PROMPT, "gen": GEN, "dispatch": "bcsr",
            "prefill_ms": summary["prefill"]["seconds"] * 1e3,
            "decode_tok_per_s": summary["decode"]["tok_per_s"],
            "decode_ms": summary["decode"]["seconds"] * 1e3,
            "route_ms": summary["route"]["seconds"] * 1e3,
            "execute_ms": summary["execute"]["seconds"] * 1e3,
            "route_calls": summary["route"]["calls"],
            "nnzb_stream_mean": summary["stream"]["nnzb_stream_mean"],
            "nnzb_routed_mean": summary["stream"]["nnzb_routed_mean"],
            "grid_nnzb_last": summary["stream"]["grid_nnzb"],
            "fused_tok_per_s": runs["gather fused"]["decode_tok_per_s"],
            "layered_tok_per_s": runs["gather layered"]["decode_tok_per_s"],
            "scheduler_fused_tok_per_s": sched["fused_gather0"][
                "decode_tok_per_s"],
            "alone": [scheduler["alone_matches"],
                      scheduler.get("alone_matches_int8")],
            "masked": {
                "prompt": ATTN_PROMPT, "pattern": "local_global",
                "window": MASK_WINDOW, "tiles": [mask.bq, mask.bk],
                "nnzb": mask.nnzb,
                "dense_tiles": mask.n_q_tiles * mask.n_kv_tiles,
                "mask_build_lower_upload_ms": mask_ms,
                **{f"{impl}_{key}": [r[key] for r in rs]
                   for impl, rs in masked.items()
                   for key in ("prefill_ms", "prefill_route_ms",
                               "prefill_execute_ms", "decode_tok_per_s",
                               "nnzb_stream_mean")},
                "order": "sparse, dense, dense, sparse",
                "tokens_equal": True},
            "kernel_prefill": {"prompt": ATTN_PROMPT, **{
                k: v for k, v in kprefill.items() if k != "launches"}},
            "peak_gb": peak_gb,
            "pipelined": {"4x256": pipelined, "masked_sparse": masked1},
            "scheduler": scheduler, "fused": fused, "expert_bmm": experts,
            "sm_clocks": clocks, "card": card}
    print(f"{arch}: fused {info['fused_tok_per_s']:.1f} tok/s, layered "
          f"{info['layered_tok_per_s']:.1f}, scheduler fused "
          f"{info['scheduler_fused_tok_per_s']:.1f}; alone (wide, int8 KV) "
          f"{info['alone']} of {scheduler['requests']}; peak {peak_gb:.1f} "
          "GB")
    return info, rows, extra


def phase_expert_bmm(cfg, params) -> list:
    """The expert products of one decode step of the MoE layer
    (``moe._expert_ffn``: three ``torch.bmm`` over all ``n_experts``
    matrices, at capacity 1) on random dispatch rows at 4 rows (the 4 x 256
    decode) and 8 (the scheduler's top bucket), back to back and from a
    CUDA graph, against its bound (every expert matrix, the rows and the
    output moved once at 3.35 TB/s) and, beside it, the same products over
    as many experts as the step has rows alone (``torch.bmm`` on the
    routed experts' slices: what a step that reads only the routed
    experts would move), and whether those products give the all-expert
    products' rows bit for bit (information, not a check: it says whether
    a product over the routed experts alone could replace the one over all
    of them without changing a token)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import moe
    slot = cfg.block_unit.index("attn+moe")
    experts = M._take(params["blocks"][slot]["ffn"], 0)["experts"]
    E, d, ff = experts["w_up"].shape
    g = torch.Generator(device="cuda").manual_seed(11)
    out = []
    for rows in (BATCH, SCHED_SLOTS):
        xe = (torch.randn((E, rows, d), generator=g, device="cuda")
              * 0.1).to(experts["w_up"].dtype)
        part = {k: w[:rows] for k, w in experts.items()}
        run = lambda: moe._expert_ffn(experts, xe, cfg.mlp_type)  # noqa
        routed = lambda: moe._expert_ffn(  # noqa: E731
            part, xe[:rows], cfg.mlp_type)
        y = run()
        check(bool(torch.isfinite(y).all()), "expert bmm: not finite")
        routed_equal = torch.equal(routed(), y[:rows])
        w_bytes = sum(w.numel() * w.element_size() for w in experts.values())
        io = (xe.numel() + y.numel()) * xe.element_size()
        flops = 2 * E * rows * d * ff * len(experts)
        bytes_ms = (w_bytes + io) / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOP_PER_S * 1e3
        row = {"rows": rows, "experts": E, "d": d, "ff": ff,
               "matrices": len(experts), "weight_gb": w_bytes / 1e9,
               "ms": time_ms(run, 5, 2), "graph_ms": graph_ms(run, 5, 2),
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "routed_only_ms": time_ms(routed, 20),
               "routed_only_graph_ms": graph_ms(routed),
               "routed_only_bound_ms": (w_bytes * rows / E + io * rows / E)
               / HBM_BYTES_PER_S * 1e3, "routed_only_equal": routed_equal}
        print(f"  expert bmm, a decode step's MoE layer ({E} x ({rows}, "
              f"{d}) x ({d}, {ff}), {len(experts)} products, "
              f"{w_bytes / 1e9:.1f} GB of experts): {row['ms']:.3f} ms "
              f"(graph {row['graph_ms']:.3f}; bound {row['bound_ms']:.3f}, "
              f"{row['bound_by']}); over {rows} experts alone "
              f"{row['routed_only_ms']:.4f} (graph "
              f"{row['routed_only_graph_ms']:.4f}; bound "
              f"{row['routed_only_bound_ms']:.4f}), its rows == the all-"
              f"expert product's: {routed_equal}")
        out.append(row)
        del xe, y
    return out


# ---------------------------------------------------------------------------
# The sparse library slice: stencils (K6a, K6b), SpMSpM (K5), quantized SpMM
# (K2q), driven through the public ops at the paper's workload sizes.
# ---------------------------------------------------------------------------

QUANT = ("fp8_e4m3", "fp8_e5m2", "int8")
STENCIL_3D, STENCIL_2D = 512, 16384        # interior edge of the grids
SPMSPM_N, SPMSPM_DA, SPMSPM_DB = 8192, 0.05, 0.01
SPMSPM_BAND = 64                           # rows the plain version runs on
SPMM_N, SPMM_BAND, SPMM_COLS = 8192, 512, 4096
SPMM_BLOCK = (8, 8)
LIB_SRC = "src/repro/kernels/"


# K5 launch shapes: the tuning row (one warp a block; W clamped to 256 >
# C 200: one ragged slab), 4 warps with W 36 (6 slabs, the last 20 wide),
# 7 warps with W 128 (the last slab 72 wide), 32 warps with W 4
K5_SHAPES = ({}, dict(rt=4, ct=36, nt=1), dict(rt=7, ct=64, nt=2),
             dict(rt=32, ct=4, nt=1))


def _k5_edge_cases(g) -> dict:
    """Streams (A 300 x 5000 rows, B 5000 x 200 columns) on the card that
    pin K5's edges: Inf and NaN in B only at keys A lacks (A holds even
    keys, B's odd keys are non-finite), empty A rows and B columns, and A
    keys outside B's key range (B's keys in [1000, 3000))."""
    import torch
    from repro_torch.kernels.spmspm import ops as po
    a = _sparse(g, (300, 5000), 0.05)
    b = _sparse(g, (5000, 200), 0.02)
    odd = torch.arange(5000, device="cuda") % 2 == 1
    a_even = a * ~odd
    b_odd = torch.where(odd[:, None] & (b != 0), float("inf"), b)
    b_odd[1::4] = torch.where(b[1::4] != 0, float("nan"), 0.0)
    a_empty, b_empty = a.clone(), b.clone()
    a_empty[::7] = 0
    b_empty[:, ::5] = 0
    b_band = b.clone()
    b_band[:1000] = 0
    b_band[3000:] = 0
    cases = {"Inf / NaN at unmatched keys": (a_even, b_odd),
             "empty rows and columns": (a_empty, b_empty),
             "A keys outside B's range": (a, b_band)}
    return {name: (*po.dense_to_ell_rows(x), *po.dense_to_ell_cols(y))
            for name, (x, y) in cases.items()}


def _sparse(g, shape, density):
    """A dense f32 matrix on the card: N(0, 1) values where a uniform draw
    falls below ``density``, else 0."""
    import torch
    mask = torch.rand(shape, generator=g, device="cuda") < density
    return torch.randn(shape, generator=g, device="cuda") * mask


def _eq(got, want, what: str) -> None:
    import torch
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"{what}: kernel != plain "
          f"(max diff {(got.float() - want.float()).abs().max().item()})")


# K2q streams that its merge of a group's rows must survive: (kind, B,
# block, dense dtype, N, unaligned dense / out / blocks).  Kinds: rows with
# ascending columns ("random"), with some block-rows empty, with shuffled
# columns, with a column repeated beside or later in its row.
K2Q_CASES = (("empty_rows", 1, (8, 8), "float32", 300, False),
             ("unsorted", 1, (8, 8), "float32", 300, False),
             ("repeated", 1, (8, 8), "bfloat16", 300, False),
             ("random", 2, (8, 8), "float32", 256, False),
             ("random", 1, (8, 8), "float32", 301, False),
             ("random", 1, (8, 8), "bfloat16", 301, False),
             ("random", 2, (8, 8), "float32", 300, True),
             ("unsorted", 2, (16, 8), "float32", 300, False),
             ("repeated", 1, (16, 8), "bfloat16", 520, True),
             ("random", 1, (8, 32), "float32", 200, False),
             ("repeated", 2, (8, 5), "float32", 130, False),
             ("empty_rows", 1, (16, 1), "bfloat16", 600, False))


def _k2q_stream(rng, kind, B, gm, gn, block):
    """A K2q stream on the card (fp8 e4m3 blocks quantized per (batch,
    entry), batch b's values scaled by 10^(3b) so that the batches' scales
    differ): indptr, block_cols, blocks, scales."""
    import numpy as np
    import torch
    from repro_torch.core import precision as P
    mask = rng.random((gm, gn)) < 0.4
    if kind == "empty_rows":
        mask[[0, 5, gm - 1]] = False
    rows = []
    for r in range(gm):
        c = list(np.nonzero(mask[r])[0])
        if kind == "unsorted":
            rng.shuffle(c)
        if kind == "repeated" and c:
            for _ in range(3):
                i = int(rng.integers(len(c)))
                c.insert(int(rng.integers(i, len(c) + 1)), c[i])
        rows.append(c)
    indptr = np.zeros(gm + 1, np.int32)
    np.cumsum([len(c) for c in rows], out=indptr[1:])
    cols = np.array([x for c in rows for x in c], np.int32)
    vals = rng.standard_normal((B, len(cols)) + tuple(block)) \
        * 1e3 ** np.arange(B)[:, None, None, None]
    q, sc = P.quantize_blocks(torch.from_numpy(vals.astype(np.float32)),
                              torch.float8_e4m3fn)
    return (torch.from_numpy(indptr).cuda(), torch.from_numpy(cols).cuda(),
            q.cuda(), sc.cuda())


def _unaligned(t):
    """A contiguous copy of ``t`` whose data starts one element past an
    allocation's start (not 16-byte aligned; not 4-byte for 1-byte
    values)."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _k2q_into(out, indptr, cols, q, dense, sc, bn):
    """K2q through the C interface into a given ``out`` (the wrapper
    allocates its own, always aligned); a comparison launch, not counted."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.spmm import kernel as mk
    B, nnzb, bm, bk = q.shape
    lib = mk._lib()
    err = lib.spmm_bcsr_launch(
        indptr.data_ptr(), cols.data_ptr(), q.data_ptr(), sc.data_ptr(),
        dense.data_ptr(), out.data_ptr(), B, indptr.numel() - 1, nnzb, bm,
        bk, dense.shape[1], dense.shape[2], bn, mk._QUANT_CODE[q.dtype],
        mk._DTYPE_CODE[dense.dtype], mk._DTYPE_CODE[torch.float32],
        torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "spmm_bcsr launch (K2q, given out)")
    return out


def _k2q_merge_cases():
    """K2q on the streams of ``K2Q_CASES`` (19 block-rows, 24 block
    columns), at the tuning row's bn and at bn 256 (a group half as
    large): each == K2 on host-dequantized blocks (``torch.equal``), within
    1e-5 of the largest |value| of the plain version (another summation
    order inside a block), and with its empty block-rows zero; the
    unaligned case also through the C interface into an output that is not
    16-byte aligned, == the aligned one."""
    import numpy as np
    import torch
    from repro_torch.core import precision as P
    from repro_torch.kernels import tuning
    from repro_torch.kernels.spmm import kernel as mk
    from repro_torch.kernels.spmm import ref as mr
    rng = np.random.default_rng(17)
    gm, gn = 19, 24
    for kind, B, block, ddt, N, unaligned in K2Q_CASES:
        dt = getattr(torch, ddt)
        indptr, cols, q, sc = _k2q_stream(rng, kind, B, gm, gn, block)
        dense = torch.from_numpy(rng.standard_normal(
            (B, gn * block[1], N)).astype(np.float32)).to("cuda", dt)
        if unaligned:
            dense, q = _unaligned(dense), _unaligned(q)
        what = f"K2q {kind} B={B} block {block} {ddt} N={N}" + (
            " unaligned" if unaligned else "")
        got = mk.spmm_bcsr(indptr, cols, q, dense, scales=sc)
        _eq(got, mk.spmm_bcsr(indptr, cols, P.dequantize_blocks(q, sc),
                              dense), f"{what}: != K2 on host-dequantized")
        _eq(mk.spmm_bcsr(indptr, cols, q, dense, scales=sc, bn=256), got,
            f"{what}: bn 256")
        plain = mr.spmm_bcsr_ref(indptr, cols, q, dense,
                                 out_dtype=torch.float32, scales=sc)
        err = (got - plain).abs().max().item()
        check(err <= 1e-5 * plain.abs().max().item(),
              f"{what}: vs plain {err}")
        empty = (indptr[1:] == indptr[:-1]).nonzero().flatten().tolist()
        rows = got.view(B, gm, block[0], N)
        check(all(rows[:, r].abs().max().item() == 0 for r in empty),
              f"{what}: an empty block-row is not zero")
        if unaligned:
            out = _unaligned(torch.empty_like(got))
            _eq(_k2q_into(out, indptr, cols, q, dense, sc,
                          tuning.spmm_bn(q.dtype, "cuda")), got,
                f"{what}: unaligned out")
    print(f"  K2q merge: {len(K2Q_CASES)} streams (empty rows, unsorted, "
          "repeated columns, B 2 with distinct scales, N % VEC, unaligned "
          "dense / blocks / out, bm 16, bk 32 / 5 / 1) x bn 128, 256 == K2 "
          "on host-dequantized blocks; within 1e-5 of plain")


def phase_library_vs_plain():
    """K6a, K6b, K5 and K2q against their plain versions on random inputs
    on the card, each as ``torch.equal`` (the kernels round every product
    and sum as the plain versions do): all five stencils in f32 and bf16 on
    ragged shapes at the tuning row's tile and at a small tile; K5 wide at
    two densities and three launch shapes (the same bits), and K5 with
    ``a_scales`` == K5 on host-dequantized rows for the three formats; K2q
    == K2 on host-dequantized f32 blocks for the three formats, f32 and
    bf16 dense, blocks (8, 8) and (16, 8); the port's quantizer on the card
    == the same quantizer on the CPU, as bytes."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.core import precision as P
    from repro_torch.core.stencils import STENCILS
    from repro_torch.kernels.spmm import ops as mo
    from repro_torch.kernels.spmspm import kernel as pk
    from repro_torch.kernels.spmspm import ops as po
    from repro_torch.kernels.spmspm import ref as pr
    from repro_torch.kernels.stencil import kernel as sk
    from repro_torch.kernels.stencil import ref as sr
    g = torch.Generator(device="cuda").manual_seed(3)
    for name, spec in STENCILS.items():
        r = spec.radius
        shape = (100, 333) if spec.ndim == 2 else (19, 37, 70)
        fn = sk.stencil_2d if spec.ndim == 2 else sk.stencil_3d
        for dt in (torch.float32, torch.bfloat16):
            grid = torch.randn(tuple(n + 2 * r for n in shape), generator=g,
                               device="cuda").to(dt)
            want = sr.stencil_ref(grid, spec)
            for tile in (None, (8, 32) if spec.ndim == 2 else (2, 4, 32)):
                _eq(fn(grid, spec, tile=tile), want,
                    f"{name} {dt} tile {tile}")
    print("  K6a / K6b: 5 stencils x f32, bf16 x 2 tiles, ragged: "
          "kernel == plain")
    # K6b's march at its edges: interiors no multiple of tz or of a
    # thread's 4-wide run, X + 2 odd and even (rows 4, 8 or 0 bytes off
    # 16; element pairs or single elements staged, an odd window width in
    # pairs), tz below the ring of 4 planes, one-thread rows, the default
    # tile clamped to a small interior; then 3-D specs of no compiled pattern
    # (a reordered box, a star of radius 2), which take the general kernel
    n = 0
    for shape, tile in (((70, 23, 45), (32, 8, 64)), ((37, 11, 64), None),
                        ((19, 37, 70), (3, 5, 13)), ((9, 6, 35), (1, 1, 4)),
                        ((12, 40, 130), (2, 8, 128)), ((11, 9, 30), (3, 4, 5)),
                        ((5, 7, 9), None)):
        for name in ("j3d27pt", "j3d7pt"):
            spec = STENCILS[name]
            for dt in (torch.float32, torch.bfloat16):
                grid = torch.randn(tuple(s + 2 for s in shape), generator=g,
                                   device="cuda").to(dt)
                _eq(sk.stencil_3d(grid, spec, tile=tile),
                    sr.stencil_ref(grid, spec),
                    f"{name} {dt} {shape} tile {tile}")
                n += 1
    box = STENCILS["j3d27pt"]
    customs = (dataclasses.replace(box, name="box reversed",
                                   offsets=box.offsets[::-1],
                                   coeffs=box.coeffs[::-1]),
               dataclasses.replace(
                   STENCILS["j3d7pt"], name="star radius 2",
                   offsets=tuple(tuple(2 * v for v in o)
                                 for o in STENCILS["j3d7pt"].offsets)))
    for spec in customs:
        check(sk.pattern_of(spec) is None, f"{spec.name}: a march pattern")
        for dt in (torch.float32, torch.bfloat16):
            grid = torch.randn(tuple(s + 2 * spec.radius for s in (13, 21, 70)),
                               generator=g, device="cuda").to(dt)
            _eq(sk.stencil_3d(grid, spec), sr.stencil_ref(grid, spec),
                f"{spec.name} {dt}")
    print(f"  K6b march edges: {n} grids (ragged, rows 0 / 4 / 8 / 12 bytes "
          "off 16, tz 1-3 below the ring, bf16), and 2 specs through the "
          "general kernel: kernel == plain")
    for density in (0.05, 0.3):
        a = _sparse(g, (300, 5000), density)
        b = _sparse(g, (5000, 200), 0.02)
        ak, av = po.dense_to_ell_rows(a)
        bk, bv = po.dense_to_ell_cols(b)
        want = pr.spmspm_ell_ref(ak, av, bk, bv)
        for kw in K5_SHAPES:
            _eq(pk.spmspm_ell(ak, av, bk, bv, **kw), want,
                f"K5 density {density} {kw}")
        av16, bv16 = av.bfloat16(), bv.bfloat16()
        _eq(pk.spmspm_ell(ak, av16, bk, bv16),
            pr.spmspm_ell_ref(ak, av16, bk, bv16),
            f"K5 density {density} bf16")
        oracle = a @ b
        err = (want - oracle).abs().max().item()
        check(err <= 1e-5 * oracle.abs().max().item(),
              f"K5 plain vs dense oracle {err}")
        for name in QUANT:
            qv, qs = P.quantize_rows(av, name)
            got = pk.spmspm_ell(ak, qv, bk, bv, a_scales=qs)
            _eq(got, pk.spmspm_ell(ak, P.dequantize_rows(qv, qs), bk, bv),
                f"K5 {name}: in-kernel != host dequantization")
            _eq(got, pr.spmspm_ell_ref(ak, qv, bk, bv, a_scales=qs),
                f"K5 {name}")
    edges = _k5_edge_cases(g)
    for name, streams in edges.items():
        want = pr.spmspm_ell_ref(*streams)
        check(bool(torch.isfinite(want).all()), f"K5 {name}: plain not finite")
        for kw in K5_SHAPES:
            _eq(pk.spmspm_ell(*streams, **kw), want, f"K5 {name} {kw}")
    print(f"  K5: 2 densities and {len(edges)} edge cases x "
          f"{len(K5_SHAPES)} launch shapes {K5_SHAPES}, kernel == plain; "
          "bf16 A and B == plain; a_scales (3 formats) == host-dequantized")
    for name in QUANT:
        for block in ((8, 8), (16, 8)):
            d = _sparse(g, (96, 160), 0.4)
            aq = F.bcsr_from_dense(d, block).quantize(name)
            for ddt in (torch.float32, torch.bfloat16):
                x = torch.randn(160, 300, generator=g, device="cuda").to(ddt)
                _eq(mo.spmm(aq, x), mo.spmm(aq.dequantize(), x),
                    f"K2q {name} block {block} dense {ddt}")
    print("  K2q: 3 formats x blocks (8, 8), (16, 8) x f32, bf16 dense == K2 "
          "on host-dequantized blocks")
    _k2q_merge_cases()
    x = torch.randn(40, 8, 8, generator=g, device="cuda") * torch.exp(
        6 * torch.randn(40, 1, 1, generator=g, device="cuda"))
    x[0] = 0
    noise = {"int8": torch.rand(x.shape, generator=g, device="cuda"),
             "fp8": torch.randint(0, 2**31, x.shape, generator=g,
                                  device="cuda")}
    for name in QUANT:
        nz = noise["int8" if name == "int8" else "fp8"]
        for fn, kw in ((P.quantize_blocks, {}), (P.quantize_rows, {}),
                       (P.quantize_blocks, {"rounding": "stochastic"})):
            on_card = fn(x, name, **kw, **(
                {"noise": nz} if kw else {}))
            on_cpu = fn(x.cpu(), name, **kw, **(
                {"noise": nz.cpu()} if kw else {}))
            check(torch.equal(on_card[0].cpu().view(torch.uint8),
                              on_cpu[0].view(torch.uint8))
                  and torch.equal(on_card[1].cpu(), on_cpu[1]),
                  f"quantizer {fn.__name__} {name} {kw}: card != cpu")
    print("  quantizer (blocks, rows, stochastic with given noise; 3 "
          "formats): card bytes == cpu bytes")


def _library_data():
    """The slice's data, made on the card from one generator: the stencil
    grids, the SpMSpM streams (A 8192^2 at 5 %, B at 1 %, as ELL rows /
    columns, and A's rows quantized to fp8 e4m3) and the quantized banded
    SpMM operand (8192^2, bandwidth 512, 8 x 8 blocks, fp8 e4m3) with its
    dense (8192, 4096) f32 right-hand side."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.core import precision as P
    from repro_torch.kernels.spmspm import ops as po
    g = torch.Generator(device="cuda").manual_seed(4)
    d = {}
    n3, n2 = STENCIL_3D + 2, STENCIL_2D + 2
    d["grid3"] = torch.randn((n3,) * 3, generator=g, device="cuda")
    d["grid2"] = torch.randn((n2, n2), generator=g, device="cuda")
    d["grid2r2"] = torch.randn((n2 + 2, n2 + 2), generator=g, device="cuda")
    n = SPMSPM_N
    a = _sparse(g, (n, n), SPMSPM_DA)
    b = _sparse(g, (n, n), SPMSPM_DB)
    d["ell_a"] = po.dense_to_ell_rows(a)
    d["ell_b"] = po.dense_to_ell_cols(b)
    d["ell_aq"] = P.quantize_rows(d["ell_a"][1], "fp8_e4m3")
    d["oracle_ab"] = (a, b)
    i = torch.arange(SPMM_N, device="cuda")
    band = (i[:, None] - i[None, :]).abs() <= SPMM_BAND
    am = torch.randn((SPMM_N, SPMM_N), generator=g, device="cuda") * band
    d["bcsr_q"] = F.bcsr_from_dense(am, SPMM_BLOCK).quantize("fp8_e4m3")
    del am, band
    d["spmm_x"] = torch.randn((SPMM_N, SPMM_COLS), generator=g,
                              device="cuda")
    torch.cuda.synchronize()
    return d


def phase_library():
    """The library slice's main path, through the public ops: the five
    stencils (``stencil.ops.apply``: j3d27pt and j3d7pt on a 512^3 f32
    interior, j2d5pt, j2d9pt and j2d9pt-gol on 16384^2), SpMSpM wide and
    with fp8 e4m3 ``a_scales`` (``spmspm.ops.spmspm``) and the quantized
    SpMM (``spmm.ops.spmm``), counts set to 0 just before and read just
    after.  Then the outputs are checked: stencils == plain
    (``torch.equal``); SpMSpM within 1e-5 of the largest |value| of the
    densify-and-matmul oracle (another summation order), == plain on a band
    of rows, and the quantized run == the wide kernel on host-dequantized
    rows; SpMM == K2 on host-dequantized blocks, and within 1e-5 of the
    largest |value| of the plain version and of ``torch.matmul`` on the
    dequantized densified A (both sum a block's products in another
    order)."""
    import torch
    from repro_torch.core import precision as P
    from repro_torch.core.formats import INVALID_KEY
    from repro_torch.core.stencils import STENCILS
    from repro_torch.kernels.spmm import ops as mo
    from repro_torch.kernels.spmm import ref as mr
    from repro_torch.kernels.spmspm import ops as po
    from repro_torch.kernels.spmspm import ref as pr
    from repro_torch.kernels.stencil import ops as so
    from repro_torch.kernels.stencil import ref as sr
    t0 = time.monotonic()
    d = _library_data()
    setup_s = time.monotonic() - t0
    grids = {"j3d27pt": "grid3", "j3d7pt": "grid3", "j2d5pt": "grid2",
             "j2d9pt": "grid2", "j2d9pt-gol": "grid2r2"}
    ak, av = d["ell_a"]
    bk, bv = d["ell_b"]
    qv, qs = d["ell_aq"]
    reset_launches()
    t0 = time.monotonic()
    outs = {name: so.apply(d[key], STENCILS[name])
            for name, key in grids.items()}              # the main path
    c_wide = po.spmspm(ak, av, bk, bv)
    c_q = po.spmspm(ak, qv, bk, bv, a_scales=qs)
    y = mo.spmm(d["bcsr_q"], d["spmm_x"])
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    counts = read_launches()
    want = only(stencil_2d=3, stencil_3d=2, spmspm_ell=2, spmm_bcsr_quant=1)
    check(counts == want, f"library: launches {counts} != {want}")
    print(f"library slice: data {setup_s:.2f} s on the card, main path "
          f"{run_s * 1e3:.1f} ms; launches {counts}")

    for name, key in grids.items():
        out = outs[name]
        check(bool(torch.isfinite(out).all()), f"{name}: not finite")
        _eq(out, sr.stencil_ref(d[key], STENCILS[name]), f"{name} full size")
    del outs
    a, b = d.pop("oracle_ab")
    oracle = a @ b
    del a, b
    big = oracle.abs().max().item()
    err = (c_wide - oracle).abs().max().item()
    check(err <= 1e-5 * big, f"SpMSpM vs oracle: {err} > {1e-5 * big}")
    del oracle
    band = slice(0, SPMSPM_BAND)
    plain = pr.spmspm_ell_ref(ak[band], av[band], bk, bv)
    _eq(c_wide[band], plain, "SpMSpM, a band of rows")
    band_err = (c_wide[band] - plain).abs().max().item()
    _eq(c_q, po.spmspm(ak, P.dequantize_rows(qv, qs), bk, bv),
        "SpMSpM fp8 e4m3: in-kernel != host dequantization")
    del c_wide, c_q
    aq = d["bcsr_q"]
    _eq(y, mo.spmm(aq.dequantize(), d["spmm_x"]),
        "SpMM fp8 e4m3: K2q != K2 on host-dequantized blocks")
    plain = mr.spmm_bcsr_ref(aq.indptr, aq.block_cols, aq.blocks[None],
                             d["spmm_x"][None], out_dtype=torch.float32,
                             scales=aq.scales[None])[0]
    q_err = (y - plain).abs().max().item()
    check(q_err <= 1e-5 * plain.abs().max().item(),
          f"SpMM fp8 e4m3: K2q vs plain {q_err}")
    del plain
    ref = torch.matmul(aq.todense(), d["spmm_x"])
    err_q = (y - ref).abs().max().item()
    check(bool(torch.isfinite(y).all())
          and err_q <= 1e-5 * ref.abs().max().item(),
          f"SpMM vs matmul of the dequantized A: {err_q}")
    del ref, y
    stats = po.comparison_stats(ak, bk)
    # multiply-adds: over keys k, (A rows holding k) x (B columns holding k)
    na = torch.bincount(ak[ak != INVALID_KEY].long(), minlength=SPMSPM_N)
    nb = torch.bincount(bk[bk != INVALID_KEY].long(), minlength=SPMSPM_N)
    matches = int((na * nb).sum())
    print(f"  stencils == plain at full size; SpMSpM La={ak.shape[1]} "
          f"Lb={bk.shape[1]}: {stats}, matches {matches} "
          f"({matches / stats['issued']:.3g} of issued), max err vs oracle "
          f"{err:.3g}; SpMM nnzb={aq.nnzb}, max err vs matmul {err_q:.3g}")
    return d, counts, {"spmspm_err": band_err, "spmspm_oracle_err": err,
                       "spmm_err": q_err, "spmm_matmul_err": err_q,
                       "matches": matches, **stats,
                       "main_path_ms": run_s * 1e3, "setup_s": setup_s}


def _lib_row(name, source, line, launches, err, ms, plain_ms, ops, nbytes,
             library_ms, card, **extra):
    """A kernel row of the library slice; the bound at the f32 peak (no
    tensor core applies) and the memory rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOP_PER_S * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": LIB_SRC + line, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "card": card, **extra}


def _stencil_times(d):
    """Per stencil at full size: kernel, plain and ``F.conv3d`` /
    ``F.conv2d`` (the taps as weights; cuDNN TF32 is off) times, with the
    bytes and operations of its bound."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.core.stencils import STENCILS
    from repro_torch.kernels.stencil import kernel as sk
    from repro_torch.kernels.stencil import ref as sr
    per = {}
    for name, key in (("j3d27pt", "grid3"), ("j3d7pt", "grid3"),
                      ("j2d5pt", "grid2"), ("j2d9pt", "grid2"),
                      ("j2d9pt-gol", "grid2r2")):
        spec, grid = STENCILS[name], d[key]
        fn = sk.stencil_3d if spec.ndim == 3 else sk.stencil_2d
        conv = Fn.conv3d if spec.ndim == 3 else Fn.conv2d
        r = spec.radius
        w = torch.zeros((2 * r + 1,) * spec.ndim, device="cuda")
        for off, c in zip(spec.offsets, spec.coeffs_f32()):
            w[tuple(o + r for o in off)] = c
        w, x = w[None, None], grid[None, None]
        out = fn(grid, spec)
        err = (out - sr.stencil_ref(grid, spec)).abs().max().item()
        lib_diff = (conv(x, w)[0, 0] - out).abs().max().item()
        check(lib_diff <= 1e-5 * out.abs().max().item(),
              f"{name}: the conv yardstick disagrees ({lib_diff})")
        per[name] = {
            "ms": time_ms(lambda: fn(grid, spec), 10, 2),
            "plain_ms": time_ms(lambda: sr.stencil_ref(grid, spec), 2, 1),
            "library_ms": time_ms(lambda: conv(x, w), 10, 2),
            "ops": 2 * spec.points * out.numel(),
            "bytes": 4 * (grid.numel() + out.numel()),
            "shape": list(out.shape), "max_abs_err": err,
            "conv_max_abs_diff": lib_diff}
        print(f"  {name} {tuple(out.shape)} f32: {per[name]['ms']:.3f} ms "
              f"({per[name]['bytes'] / 1e9:.3f} GB), plain "
              f"{per[name]['plain_ms']:.1f}, conv "
              f"{per[name]['library_ms']:.3f}")
        del out
    return per


def _spmspm_parts(ak, av, bk, bv, qv, qs) -> dict:
    """K5's two passes timed apart at the slice's streams, on the default
    tiles: B's bucketing (the key range read to the host, then count, scan
    and scatter) and the row-wise product, wide and with fp8 e4m3
    ``a_scales``."""
    from repro_torch.kernels import tuning
    from repro_torch.kernels.spmspm import kernel as pk
    R, C = ak.shape[0], bk.shape[0]
    rt, ct = tuning.spmspm_tiles(R, C, ak.shape[1], bk.shape[1],
                                 device="cuda")
    width = tuning.spmspm_nt(C, ct, bk.shape[1], device="cuda") * ct
    buckets = pk.bucket_columns(bk, bv, width)
    parts = {
        "bucket_ms": time_ms(lambda: pk.bucket_columns(bk, bv, width), 10, 2),
        "product_ms": time_ms(lambda: pk.row_product(
            ak, av, None, buckets, C, rt), 5, 1),
        "product_fp8_e4m3_ms": time_ms(lambda: pk.row_product(
            ak, qv, qs, buckets, C, rt), 5, 1),
        "tiles": {"rt": rt, "W": width},
        "buckets": buckets.span * -(-C // width),
        "bucket_entries": int(buckets.offsets[-1])}
    print(f"  spmspm_ell passes: bucketing {parts['bucket_ms']:.4f} ms "
          f"({parts['buckets']} buckets, {parts['bucket_entries']} entries), "
          f"product {parts['product_ms']:.4f} ms, fp8 a_scales "
          f"{parts['product_fp8_e4m3_ms']:.4f} ms at rt {rt}, W {width}")
    return parts


def phase_measure_library(d, counts, info, card):
    """The K6a, K6b, K5 and K2q rows at the slice's sizes.  ``ms``: CUDA
    events over back-to-back launches; ``plain_ms``: the plain version
    (K5's on the first 64 rows only: its step-by-step search over all 8192
    rows would take minutes); ``library_ms``: one PyTorch call computing the
    same function (``F.conv3d`` / ``F.conv2d``, ``torch.sparse.mm`` on CSR
    tensors then ``to_dense``, ``torch.matmul`` of the dequantized densified
    A), a yardstick the port never calls.  Bounds (3.35 TB/s, f32 67
    TFLOP/s): each input byte read once and each output byte written once;
    2 operations per tap per point, per key match, per nonzero-block element
    and output column.  The K6a row is j2d9pt and the K6b row j3d27pt; the
    other stencils are listed under ``stencils``."""
    import torch
    from repro_torch.kernels.spmm import kernel as mk
    from repro_torch.kernels.spmm import ref as mr
    from repro_torch.kernels.spmspm import ops as po
    from repro_torch.kernels.spmspm import ref as pr
    per = _stencil_times(d)
    rows = []
    for kname, head, names, line in (
            ("stencil_2d", "j2d9pt", ("j2d5pt", "j2d9pt", "j2d9pt-gol"),
             "stencil/kernel.py:58"),
            ("stencil_3d", "j3d27pt", ("j3d27pt", "j3d7pt"),
             "stencil/kernel.py:84")):
        h = per[head]
        rows.append(_lib_row(
            kname, "src/repro_torch/kernels/stencil/csrc/stencil.cu", line,
            counts[kname], h["max_abs_err"], h["ms"], h["plain_ms"], h["ops"],
            h["bytes"],
            h["library_ms"], card, row_of=head,
            stencils={n: per[n] for n in names}))

    ak, av = d["ell_a"]
    bk, bv = d["ell_b"]
    qv, qs = d["ell_aq"]
    R, C = ak.shape[0], bk.shape[0]
    band = slice(0, SPMSPM_BAND)
    ms = time_ms(lambda: po.spmspm(ak, av, bk, bv), 5, 1)
    q_ms = time_ms(lambda: po.spmspm(ak, qv, bk, bv, a_scales=qs), 5, 1)
    parts = _spmspm_parts(ak, av, bk, bv, qv, qs)
    plain_ms = time_ms(lambda: pr.spmspm_ell_ref(ak[band], av[band], bk, bv),
                       1, 1)
    a_csr = pr.ell_to_dense(ak, av, SPMSPM_N).to_sparse_csr()
    b_csr = pr.ell_to_dense(bk, bv, SPMSPM_N).T.contiguous().to_sparse_csr()
    lib_ms = time_ms(lambda: torch.sparse.mm(a_csr, b_csr).to_dense(), 2, 1)
    del a_csr, b_csr
    rows.append(_lib_row(
        "spmspm_ell", "src/repro_torch/kernels/spmspm/csrc/spmspm_ell.cu",
        "spmspm/kernel.py:58", counts["spmspm_ell"], info["spmspm_err"], ms,
        plain_ms, 2 * info["matches"],
        8 * (ak.numel() + bk.numel()) + 4 * R * C, lib_ms, card,
        plain_rows=SPMSPM_BAND, oracle_max_abs_err=info["spmspm_oracle_err"],
        shape={"R": R, "C": C, "K": SPMSPM_N, "La": ak.shape[1],
               "Lb": bk.shape[1], "density_a": SPMSPM_DA,
               "density_b": SPMSPM_DB},
        comparisons={k: info[k] for k in ("issued", "useful_upper",
                                          "valid_a", "valid_b", "matches")},
        a_scales_fp8_e4m3_ms=q_ms, **parts))
    print(f"  spmspm_ell {R}x{C}: {ms:.3f} ms, fp8 a_scales {q_ms:.3f} ms, "
          f"plain ({SPMSPM_BAND} rows) {plain_ms:.1f}, sparse.mm {lib_ms:.1f}")

    aq, x = d["bcsr_q"], d["spmm_x"]
    args = (aq.indptr, aq.block_cols, aq.blocks[None], x[None])
    sc = aq.scales[None]
    ms = time_ms(lambda: mk.spmm_bcsr(*args, scales=sc), 5, 1)
    plain_ms = time_ms(lambda: mr.spmm_bcsr_ref(
        *args, out_dtype=torch.float32, scales=sc), 1, 1)
    a_deq = aq.todense()
    lib_ms = time_ms(lambda: torch.matmul(a_deq, x), 3, 1)
    del a_deq
    nnzb, bm, bk_ = aq.blocks.shape
    nbytes = (aq.blocks.numel() + 4 * nnzb + 4 * (aq.indptr.numel() + nnzb)
              + 4 * x.numel() + 4 * SPMM_N * SPMM_COLS)
    flops = 2 * nnzb * bm * bk_ * SPMM_COLS
    share = flops / (ms * 1e-3) / F32_FLOP_PER_S
    rows.append(_lib_row(
        "spmm_bcsr_quant", "src/repro_torch/kernels/spmm/csrc/spmm_bcsr.cu",
        "spmm/kernel.py:68", counts["spmm_bcsr_quant"], info["spmm_err"], ms,
        plain_ms, flops, nbytes, lib_ms, card,
        shape={"M": SPMM_N, "K": SPMM_N, "N": SPMM_COLS,
               "bandwidth": SPMM_BAND, "block": list(SPMM_BLOCK),
               "nnzb": nnzb, "blocks": "fp8_e4m3", "dense": "float32"},
        matmul_max_abs_err=info["spmm_matmul_err"], f32_peak_share=share))
    print(f"  spmm_bcsr_quant nnzb={nnzb} N={SPMM_COLS}: {ms:.3f} ms "
          f"({100 * share:.1f} % of the f32 peak), plain {plain_ms:.1f}, "
          f"matmul {lib_ms:.3f}")
    return rows


# ---------------------------------------------------------------------------
# The RWKV-6 slice: the WKV recurrence (K7) under rwkv6-7b serving.
# ---------------------------------------------------------------------------

WKV_SRC = "src/repro/kernels/wkv/kernel.py:62"


def wkv_err(got, want, what: str) -> float:
    """Largest |got - want|, within WKV_REL_TOL of the largest |want|."""
    import torch
    torch.cuda.synchronize()
    big = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    check(err <= WKV_REL_TOL * big,
          f"{what}: kernel disagrees with plain: {err} > {WKV_REL_TOL} x "
          f"{big}")
    return err


def wkv_needed_flops(B, T, nh, hd, chunk) -> int:
    """The dots the chunked WKV needs, with the final state: per (b, h) and
    chunk of L real positions, the strictly lower (L, L) scores and att v
    (2 L (L - 1) hd together), r S on every chunk but the first (S is zero
    there; 2 L hd^2) and the state update (2 L hd^2).  ``ops.flops``, the
    reference's count, takes the whole (Q, Q) tile and r S on every
    chunk."""
    total = 0
    for c0 in range(0, T, chunk):
        L = min(chunk, T - c0)
        total += 2 * L * (L - 1) * hd + (2 if c0 else 1) * 2 * L * hd * hd
    return B * nh * total


def _wkv_inputs(g, B, T, nh, wmag, dt, wdt):
    """r, k, v ~ N(0, 1) in ``dt``; w = max(-|N(0, 1)| * wmag, -1) in
    ``wdt``; u ~ 0.1 N(0, 1) f32 (the reference's test inputs); hd 64."""
    import torch
    shape = (B, T, nh, 64)
    r, k, v = (torch.randn(shape, generator=g, device="cuda").to(dt)
               for _ in range(3))
    w = torch.clamp(-torch.randn(shape, generator=g, device="cuda").abs()
                    * wmag, min=-1.0).to(wdt)
    u = 0.1 * torch.randn((nh, 64), generator=g, device="cuda")
    return r, k, v, w, u


# W1 at rwkv6-7b's 64 heads; R1 at its decay LoRA's two decode shapes (d,
# E), x bf16 (the bf16 policy's xw) or f32 (tanh of the first product)
WKV_STEP_HEADS = 64
LORA_CASES = ((4096, 64, "bfloat16"), (4096, 64, "float32"),
              (64, 4096, "float32"))
# R1 as the decode norms' row sum (``router.ops.row_sum`` of f32 x^2 by a
# (d, 1) column of ones, E = 1): rwkv6-7b's d, llama4-scout's, and
# gemma3-12b's d and head dim (qk_norm); at rows on both sides of
# ``tuning.ROUTER_FEW_TOKENS`` (64): gemma's ln1 at B 4, k_norm at B 4,
# q_norm at B 4 and at bucket 8 (8 x 16 heads)
NORM_DIMS = (4096, 5120, 3840, 256)
NORM_ROWS = (4, 32, 64, 128)


def _row_sum_case(x2, what: str) -> float:
    """R1 as ``router.ops.row_sum`` on squared hidden states ``x2`` (T, d)
    f32: ``torch.equal`` to its emulated order (``router_logits_ordered``
    by a column of ones), two launches ``torch.equal``, row i at T and at
    each B of BATCH_LAW up to T == the row alone (past
    ``tuning.ROUTER_FEW_TOKENS`` rows the many-token kernel against the
    few-token one), and within :func:`tolerance` (1e-5 of the largest sum:
    the same terms in another order) of the library's ``x2.sum(-1)``.
    Returns the error."""
    import torch
    from repro_torch.kernels.router import ops as rops
    from repro_torch.kernels.router import ref as rref
    got = rops.row_sum(x2)
    ones = torch.ones((x2.shape[-1], 1), device=x2.device)
    check(torch.equal(got, rref.router_logits_ordered(x2, ones)),
          f"{what}: R1 != its emulated order")
    check(torch.equal(got, rops.row_sum(x2)), f"{what}: two launches differ")
    T = x2.shape[0]
    check(_rows_alone_equal(rops.row_sum, lambda lo, hi: (x2[lo:hi],),
                            sizes=tuple(sorted({b for b in BATCH_LAW
                                                if b <= T} | {T}))),
          f"{what}: a row depends on its batch")
    return max_err(got, x2.sum(-1, keepdim=True), what)


def _kept_row_sums(shapes: dict, what: str) -> None:
    """:func:`_row_sum_case` on each decode norm's x^2 that
    :class:`keep_row_sum` kept (``shapes``: shape: x^2), its rows the
    leading axes (B, or B x heads for qk_norm)."""
    from repro_torch.kernels import tuning
    for shape, x2 in sorted(shapes.items()):
        rows = x2.reshape(-1, shape[-1])
        regime = "few" if rows.shape[0] <= tuning.ROUTER_FEW_TOKENS \
            else "many"
        err = _row_sum_case(rows, f"R1 row sum, {what} norm {shape}")
        print(f"  R1 row sum, {what} decode norm {shape} ({rows.shape[0]} "
              f"rows, {regime}-token kernel): == its emulated order, rows "
              f"== alone, max_abs_err {err:.3g} against torch.sum")


def _wkv_step_case(a, what: str) -> float:
    """W1 (``kernel.wkv_step``) on ``a`` = (r, k, v, e, u, s0): y and the
    state ``torch.equal`` to ``ref.wkv_step_ordered``, the state
    ``torch.equal`` to the plain step's, y within :func:`tolerance` (1e-5
    of the largest |y|: the same 64-term f32 sums in another order) of the
    plain step's, two launches ``torch.equal``, and the step in place
    (``out=`` s0's own storage, as the model runs it) the same bits.
    Returns y's error."""
    import torch
    from repro_torch.kernels.wkv import kernel as wk
    from repro_torch.kernels.wkv import ref
    y, s = wk.wkv_step(*a)
    oy, os_ = ref.wkv_step_ordered(*a)
    py, ps = ref.wkv_step_plain(*a)
    check(torch.equal(y, oy) and torch.equal(s, os_),
          f"{what}: W1 != its emulated order")
    check(torch.equal(s, ps), f"{what}: W1's state != the plain step's")
    y2, s2 = wk.wkv_step(*a)
    check(torch.equal(y, y2) and torch.equal(s, s2),
          f"{what}: two launches differ")
    st = a[5].clone()
    y3, s3 = wk.wkv_step(*a[:5], st, out=st)
    check(s3 is st and torch.equal(y3, y) and torch.equal(st, s),
          f"{what}: the step in place (out = s0) differs")
    return max_err(y, py, f"{what}: y")


def _wkv_step_rows_alone(a, what: str) -> None:
    """Row i of W1 (y and state) at each B of BATCH_LAW up to the rows of
    ``a`` == the row alone."""
    import torch
    from repro_torch.kernels.wkv import kernel as wk
    r, k, v, e, u, s0 = a
    check(_rows_alone_equal(
        lambda *t: torch.cat([x.flatten(1) for x in wk.wkv_step(*t)], 1),
        lambda lo, hi: (r[lo:hi], k[lo:hi], v[lo:hi], e[lo:hi], u,
                        s0[lo:hi]),
        sizes=tuple(b for b in BATCH_LAW if b <= r.shape[0])),
        f"{what}: a row depends on its batch")


def phase_wkv_vs_plain():
    """K7 (``ops.wkv_state``, which pads T to whole chunks) against the
    plain chunked version on the same inputs on the card, ``y`` and the
    final state, with WKV_REL_TOL: r, k, v and w in (f32, f32), (bf16,
    bf16) and (bf16, f32); T 100, 256, 2048 (padded to whole chunks);
    wmag 0.05 and 1.0 (decays that saturate the clamp); the kernel's one
    chunk, the cuda row's 128.  Each case launches twice and the two
    results must be ``torch.equal``.  ``ops.wkv`` is checked too, and on a
    small f32 case of three chunks both sides are printed against an f64
    sequential scan, so a disagreement shows which side moved.

    Then W1 (the one-token step) at 16 rows of 64 heads, decays that do or
    do not saturate the clamp (:func:`_wkv_step_case`; row i at B in
    BATCH_LAW == alone), and R1 at the decay LoRA's decode shapes
    (:data:`LORA_CASES`): each T of BATCH_LAW within 1e-5 of plain and
    ``torch.equal`` to its emulated order, rows == alone; and R1 as the
    decode norms' row sum at :data:`NORM_DIMS` x :data:`NORM_ROWS`
    (:func:`_row_sum_case`)."""
    import torch
    from repro_torch.kernels import tuning
    from repro_torch.kernels.wkv import ops, ref
    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(5)
    chunk = tuning.wkv_chunk(10 ** 9, f32, "cuda")
    worst = 0.0
    for dt, wdt in ((f32, f32), (bf16, bf16), (bf16, f32)):
        for T in (100, 256, 2048):
            for wmag in (0.05, 1.0):
                a = _wkv_inputs(g, 2, T, 3, wmag, dt, wdt)
                y, s = ops.wkv_state(*a, chunk=chunk)
                py, ps = ref.wkv_chunked_plain(*a, chunk)
                what = (f"K7 {str(dt)[6:]}/{str(wdt)[6:]} T={T} "
                        f"wmag={wmag} chunk={chunk}")
                worst = max(worst, wkv_err(y, py, what + " y"),
                            wkv_err(s, ps, what + " state"))
                y2, s2 = ops.wkv_state(*a, chunk=chunk)
                check(torch.equal(y, y2) and torch.equal(s, s2),
                      f"{what}: two launches differ")
                worst = max(worst, wkv_err(ops.wkv(*a), py,
                                           f"ops.wkv {what}"))
        print(f"  K7 r/k/v {str(dt)[6:]}, w {str(wdt)[6:]}: T 100, 256, "
              f"2048 x wmag 0.05, 1.0 at chunk {chunk}: kernel == plain "
              f"within {WKV_REL_TOL} of max, launches repeat bit for bit")
    a = _wkv_inputs(g, 1, 300, 2, 1.0, f32, f32)
    exact_y, exact_s = ref.wkv_scan(*(x.cpu().double() for x in a))
    for name, (y, s) in (("card K7", ops.wkv_state(*a, chunk=chunk)),
                         ("card plain", ref.wkv_chunked_plain(*a, chunk))):
        print(f"    {name} vs f64 scan (T 300, chunk {chunk}, wmag 1.0): y "
              f"{(y.cpu().double() - exact_y).abs().max().item():.3g}, "
              f"state {(s.cpu().double() - exact_s).abs().max().item():.3g}"
              f" (largest |y| {exact_y.abs().max().item():.3g})")
    print(f"  K7 worst max_abs_err {worst:.3g}")
    from repro_torch.kernels.router import kernel as rk
    n, H = max(BATCH_LAW), WKV_STEP_HEADS
    worst = 0.0
    for wmag in (0.05, 1.0):
        r, k, v = (torch.randn((n, H, 64), generator=g, device="cuda")
                   for _ in range(3))
        e = torch.exp(torch.clamp(-torch.randn(
            (n, H, 64), generator=g, device="cuda").abs() * wmag, min=-1.0))
        u = 0.1 * torch.randn((H, 64), generator=g, device="cuda")
        s0 = torch.randn((n, H, 64, 64), generator=g, device="cuda")
        what = f"W1 {n} x {H} heads, wmag {wmag}"
        worst = max(worst, _wkv_step_case((r, k, v, e, u, s0), what))
        _wkv_step_rows_alone((r, k, v, e, u, s0), what)
    print(f"  W1 {n} rows x {H} heads, wmag 0.05 and 1.0: == its emulated "
          f"order (y and state), state == plain, y max_abs_err {worst:.3g}; "
          f"rows of B {BATCH_LAW} == alone; launches repeat bit for bit")
    for d, E, xn in LORA_CASES:
        xdt = getattr(torch, xn)
        x = torch.randn((n, d), generator=g, device="cuda").to(xdt)
        w = torch.randn((d, E), generator=g, device="cuda") * d ** -0.5
        what = f"R1 decay LoRA {d} x {E}, x {xn}"
        errs = [_router_case(x[:T], w, f"{what} T {T}")[1]
                for T in BATCH_LAW]
        check(_rows_alone_equal(lambda xx: rk.router_logits(xx, w),
                                lambda lo, hi: (x[lo:hi],)),
              f"{what}: a row depends on its batch")
        print(f"  {what}, T {BATCH_LAW}: max_abs_err {max(errs):.3g}; each "
              "== its emulated order; rows == alone")
    for d in NORM_DIMS:
        x = torch.randn((max(NORM_ROWS), d), generator=g, device="cuda")
        what = f"R1 row sum (decode norm) d {d}, x float32"
        err = max(_row_sum_case(x[:T] * x[:T], f"{what}, {T} rows")
                  for T in NORM_ROWS)
        print(f"  {what}, rows {NORM_ROWS}: == its emulated order, rows "
              f"== alone, max_abs_err {err:.3g} against torch.sum")


def phase_rwkv_smoke_card_vs_cpu():
    """rwkv6-7b SMOKE in f32: prefill logits (K7 once a layer on the card)
    and one decode step's logits (:func:`rwkv_counts`) agree with
    the CPU within 1e-4."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_smoke(RWKV_ARCH), policy="f32")
    cpu = M.init_params(cfg, seed=0, device="cpu")
    gpu = _tree_to(cpu, "cuda")
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)))
    want, c_cpu, pos = M.prefill_layered(cpu, prompts, cfg, max_seq=32)
    reset_launches()
    got, c_gpu, _ = M.prefill_layered(gpu, prompts.cuda(), cfg, max_seq=32)
    launches = read_launches()
    err = (got.cpu() - want).abs().max().item()
    check(bool(torch.isfinite(got).all()) and err <= 1e-4,
          f"rwkv smoke prefill: card and cpu disagree: {err}")
    check(launches == only(wkv_kernel=cfg.n_repeats),
          f"rwkv smoke prefill launches {launches}")
    tok = want[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    want1, _ = M.decode_step_layered(cpu, cfg, c_cpu, pos, tok)
    reset_launches()
    got1, _ = M.decode_step_layered(gpu, cfg, c_gpu, pos, tok.cuda())
    launches1 = read_launches()
    check(launches1 == rwkv_counts(cfg, 0, 1),
          f"rwkv smoke decode launches {launches1}")
    err1 = (got1.cpu() - want1).abs().max().item()
    check(bool(torch.isfinite(got1).all()) and err1 <= 1e-4,
          f"rwkv smoke decode: card and cpu disagree: {err1}")
    print(f"  rwkv6 smoke f32 card vs cpu: prefill logits max_abs_err "
          f"{err:.3g} (K7 x {launches['wkv_kernel']}), decode step "
          f"{err1:.3g} (W1 x {launches1['wkv_step']}, R1 x "
          f"{launches1['router_logits']})")


def random_biases(params, seed: int) -> None:
    """Every ``bq`` / ``bk`` / ``bv`` leaf of ``params`` filled, in place,
    with N(0, 0.1) values from a ``torch.Generator`` seeded with ``seed``
    on the leaves' device (``init_params`` gives zeros, as the reference's
    does, which would leave the bias add unexercised)."""
    import torch
    for slot in params["blocks"]:
        attn = slot.get("attn", {})
        for name in ("bq", "bk", "bv"):
            if name in attn:
                leaf = attn[name]
                g = torch.Generator(device=leaf.device).manual_seed(seed)
                leaf.copy_(torch.randn(leaf.shape, generator=g,
                                       device=leaf.device) * 0.1)
                seed += 1


def phase_dense_smoke_card_vs_cpu():
    """The dense family's small configs in f32 (qwen3-1.7b and
    nemotron-4-340b SMOKE, qwen2-1.5b SMOKE at head dim 16 with nonzero
    biases) and the frontend configs' (musicgen-large and internvl2-26b
    SMOKE, 4 / 8 frame or patch embeddings of 0.02 * N(0, 1) from numpy
    seed 2 before the prompt: S_total 28 / 32, ragged for the tiles):
    prefill logits on the card agree with the CPU within 1e-4, chunked,
    through K3 (``impl="kernel"``) and through K4s (local_global, tiles
    and window 8), each kernel once a layer; then one decode step from the
    chunked prefill's caches at position S_total (:func:`decode_counts`:
    D1 once a layer, R1 once a decode norm) within 1e-4.  A frontend
    config's step is held from identical caches: each side's own f32
    prefill caches, and one CPU prefill's bf16 caches copied to the card;
    from each side's own bf16 caches only where the two prefills rounded
    no entry apart (the count is printed: one entry rounded the other way
    moves the step's logits by more than the kernels' arithmetic does)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core.masks import AttnMaskSpec
    from repro_torch.models import model as M
    for arch in DENSE_ARCHS + FRONTEND_ARCHS:
        cfg = dataclasses.replace(get_smoke(arch), policy="f32")
        if cfg.hd < 16:           # qwen2's 8 is none of the kernels' dims
            cfg = dataclasses.replace(cfg, head_dim=16)
        cpu = M.init_params(cfg, seed=0, device="cpu")
        random_biases(cpu, 3)
        gpu = _tree_to(cpu, "cuda")
        prompts = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 24)))
        emb = {"cpu": None, "cuda": None}
        if cfg.frontend != "none":
            emb["cpu"] = torch.from_numpy((0.02 * np.random.default_rng(
                2).standard_normal((2, cfg.frontend_tokens, cfg.d_model))
            ).astype(np.float32))
            emb["cuda"] = emb["cpu"].cuda()
        max_seq = prompts.shape[1] + cfg.frontend_tokens + 8
        mask = AttnMaskSpec(pattern="local_global", window=8, bq=8, bk=8,
                            impl="sparse")
        errs = {}
        for label, kw, kernel in (
                ("chunked", {}, None),
                ("attn_mask sparse", {"attn_mask": mask},
                 "flash_attention_sparse"),
                ("impl=kernel", {"impl": "kernel"}, "flash_attention")):
            want, c_cpu, pos = M.prefill_layered(cpu, prompts, cfg,
                                                 max_seq=max_seq,
                                                 embeddings=emb["cpu"], **kw)
            reset_launches()
            got, c_gpu, pos_gpu = M.prefill_layered(
                gpu, prompts.cuda(), cfg, max_seq=max_seq,
                embeddings=emb["cuda"], **kw)
            launches = read_launches()
            check(pos == pos_gpu == prompts.shape[1] + cfg.frontend_tokens,
                  f"{arch} smoke prefill ({label}): next position {pos} / "
                  f"{pos_gpu}")
            errs[label] = (got.cpu() - want).abs().max().item()
            check(bool(torch.isfinite(got).all()) and errs[label] <= 1e-4,
                  f"{arch} smoke prefill ({label}): card and cpu disagree: "
                  f"{errs[label]}")
            check(launches == only(**({kernel: cfg.n_layers} if kernel
                                       else {})),
                  f"{arch} smoke prefill ({label}): launches {launches}")
            if kernel is None:
                caches = (c_cpu, c_gpu, pos, want)
        c_cpu, c_gpu, pos, want = caches
        tok = want[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
        # bf16 cache entries the two prefills rounded apart
        flips = sum(int((a.cpu() != b).sum()) for a, b in
                    zip(_tensors(c_gpu), _tensors(c_cpu)))
        cases = [("own caches", c_cpu, c_gpu)]
        if cfg.frontend != "none":
            f32 = [M.prefill_layered(
                params, prompts.to(dev), cfg, max_seq=max_seq,
                cache_dtype=torch.float32, embeddings=emb[dev])[1]
                for params, dev in ((cpu, "cpu"), (gpu, "cuda"))]
            # copies of the cpu's caches, made before a decode writes them
            same = _tree_to(c_cpu, "cuda")
            cases += [("f32 caches", *f32),
                      ("the cpu's caches", _tree_to(same, "cpu"), same)]
        dec = {}
        for label, c_cpu1, c_gpu1 in cases:
            want1, _ = M.decode_step_layered(cpu, cfg, c_cpu1, pos, tok)
            reset_launches()
            got1, _ = M.decode_step_layered(gpu, cfg, c_gpu1, pos,
                                            tok.cuda())
            launches1 = read_launches()
            check(launches1 == decode_counts(cfg, 0, 1),
                  f"{arch} smoke decode ({label}) launches {launches1}")
            dec[label] = err1 = (got1.cpu() - want1).abs().max().item()
            # a frontend config's decode is held from identical caches: from
            # each side's own bf16 caches only where the two prefills
            # rounded no entry apart
            if cfg.frontend == "none" or label != "own caches" or not flips:
                check(bool(torch.isfinite(got1).all()) and err1 <= 1e-4,
                      f"{arch} smoke decode ({label}): card and cpu "
                      f"disagree: {err1} ({flips} bf16 cache entries "
                      "rounded apart by the two prefills)")
        print(f"  {cfg.name} f32 (hd {cfg.hd}, heads {cfg.n_heads}/"
              f"{cfg.n_kv_heads}{', biases' if cfg.qkv_bias else ''}"
              + (f", {cfg.frontend_tokens} {cfg.frontend} embeddings, "
                 f"S_total {pos}" if cfg.frontend != "none" else "")
              + ") card vs cpu: prefill logits max_abs_err " + ", ".join(
                  f"{k} {v:.3g}" for k, v in errs.items())
              + "; decode step " + ", ".join(
                  f"{k} {v:.3g}" for k, v in dec.items())
              + f" ({flips} bf16 cache entries rounded apart; D1 x "
              f"{launches1['decode_attention']}, R1 x "
              f"{launches1['router_logits']})")


def phase_rwkv_serving(card):
    """RWKV-6 serving at full width and depth: ``ServeLoop`` on rwkv6-7b
    (random bf16 weights from a seed) serves BATCH prompts of RWKV_PROMPT
    tokens and generates GEN greedy tokens.  Counts set to 0 just before
    the run: K7 once a layer in prefill, W1 once a layer and R1
    :func:`r1_per_step` times a decode step (:func:`rwkv_counts`; a replay
    counts the launches its capture recorded), and no plain version
    called on the card.  The first layer's r, k, v, w, u are captured for the K7 row, and the
    layered run's first decode step's W1 and LoRA R1 inputs for theirs.
    Then one run of a ``pipeline_depth=1`` loop (after a warm-up): the
    same tokens, the same launches.  Returns (summary, with the depth-1
    numbers under "depth1"; the main run's launches; K7's captured inputs;
    (W1's captured inputs, the two LoRA R1 calls, the first norm's
    squared hidden state))."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.wkv import kernel as wk
    from repro_torch.kernels.wkv import ops as wkv_ops
    from repro_torch.launch.serve import ServeLoop
    from repro_torch.models import model as M
    from repro_torch.models import rwkv6
    cfg = get_config(RWKV_ARCH)
    t0 = time.monotonic()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    gb = torch.cuda.memory_allocated() / 1e9
    print(f"rwkv serving: {cfg.name} d={cfg.d_model} heads={cfg.n_heads} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} depth={cfg.n_repeats} "
          f"policy={cfg.policy}; params {gb:.1f} GB, init "
          f"{time.monotonic() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(3)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, RWKV_PROMPT),
                            generator=g, device="cuda")
    max_seq = RWKV_PROMPT + GEN
    loop = ServeLoop(params, cfg, max_seq=max_seq)
    check(not loop.two_phase, "rwkv6-7b's default loop is not fused")
    loop.run(prompts, 2)                      # warm-up: allocator, cuBLAS
    capture0 = loop.summary()["capture"]      # the step's graph, once

    captured, seen = [], {}
    entry, plain = wkv_ops.wkv_state, wk.wkv_chunked_plain
    plain_calls = []

    def capture(r, k, v, w_log, u, *, chunk):
        if not captured:
            captured.append((r, k, v, w_log, u, chunk))
        return entry(r, k, v, w_log, u, chunk=chunk)

    def counted_plain(*a, **kw):
        plain_calls.append(1)
        return plain(*a, **kw)

    prefill = loop.prefill

    def counted_prefill(p, **kw):
        out = prefill(p, **kw)
        seen.update(read_launches())
        return out

    loop.prefill = counted_prefill
    wkv_ops.wkv_state, wk.wkv_chunked_plain = capture, counted_plain
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:                                      # the main path
        with no_plain():
            tokens, fused_logits = first_step_logits(loop, prompts)
    finally:
        wkv_ops.wkv_state, wk.wkv_chunked_plain = entry, plain
        loop.prefill = prefill
    counts = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    summary = loop.summary()
    n = cfg.n_repeats
    want = rwkv_counts(cfg, 1, GEN - 1)
    print(f"  launches: prefill {seen}, whole run {counts}; plain calls "
          f"{len(plain_calls)}; tokens {tokens[0, :8].tolist()} ...")
    check(seen == only(wkv_kernel=n), f"prefill launches {seen} != {n} K7")
    check(counts == want, f"launches {counts} != {want} (K7 a layer in "
                          "prefill, W1 and R1 x 2 a layer a decode step)")
    check(not plain_calls, "the plain WKV ran on the card's main path")
    check(captured and captured[0][5] == 128
          and tuple(captured[0][0].shape) == (BATCH, RWKV_PROMPT,
                                              cfg.n_heads, 64),
          "captured WKV inputs have the wrong shape or chunk")
    check(tokens.shape == (BATCH, GEN) and (tokens >= 0).all()
          and (tokens < cfg.vocab_size).all(), "bad token ids")
    logits, _, _ = M.prefill_layered(params, prompts, cfg, max_seq=max_seq)
    check(tuple(logits.shape) == (BATCH, 1, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()), "prefill logits not finite")
    first = logits[:, -1, :cfg.vocab_size].argmax(-1).cpu().numpy()
    check(np.array_equal(first, tokens[:, 0]), "prefill argmax != token 0")
    info = {"arch": cfg.name, "depth": n, "batch": BATCH,
            "prompt": RWKV_PROMPT, "gen": GEN, "params_gb": gb,
            "prefill_ms": summary["prefill"]["seconds"] * 1e3,
            "decode_ms": summary["decode"]["seconds"] * 1e3,
            "decode_tok_per_s": summary["decode"]["tok_per_s"],
            "peak_gb": peak_gb, "card": card}
    print(f"  prefill {info['prefill_ms']:.1f} ms for {BATCH}x{RWKV_PROMPT},"
          f" decode {info['decode_tok_per_s']:.1f} tok/s over {GEN - 1} "
          f"steps, peak {peak_gb:.1f} GB; prefill argmax == token 0")
    del logits
    per_step = {"wkv_step": n, "router_logits": r1_per_step(cfg)}
    check(loop.fused_step.launches == per_step, f"a replay launches "
          f"{loop.fused_step.launches}, not {per_step}")
    rows = [fused_numbers("fused", summary, capture0, counts)]
    layered = ServeLoop(params, cfg, max_seq=max_seq, two_phase=True)
    layered.run(prompts, 2)                   # warm-up
    # the first decode step's layer 0 as the main path calls it: W1's
    # inputs (the state the served prefill left) and the LoRA's two R1
    # calls, for their rows
    step_calls, lora_calls = [], []
    # the mixer's own name for R1 is replaced, not the wrapper, whose
    # launch count lives on the function itself
    r1_module = rwkv6.router_kernel
    step_entry, r1_entry = wkv_ops.wkv_step, r1_module.router_logits

    def keep_step(*a, **kw):
        if not step_calls:
            step_calls.append(tuple(x.clone() for x in a))
        return step_entry(*a, **kw)

    def keep_lora(x, w):
        if len(lora_calls) < 2:
            lora_calls.append((x.clone(), w))
        return r1_entry(x, w)

    wkv_ops.wkv_step = keep_step
    rwkv6.router_kernel = types.SimpleNamespace(router_logits=keep_lora)
    reset_launches()
    try:
        with no_plain(), keep_row_sum() as norm:
            got, layered_logits = first_step_logits(layered, prompts)
    finally:
        wkv_ops.wkv_step, rwkv6.router_kernel = step_entry, r1_module
    counts_l = read_launches()
    check(counts_l == want, f"layered: launches {counts_l}")
    check(step_calls and tuple(step_calls[0][5].shape) == (
        BATCH, cfg.n_heads, 64, 64) and len(lora_calls) == 2
        and norm.x is not None and tuple(norm.x.shape) == (
            BATCH, 1, cfg.d_model),
        "the first decode step's W1 / R1 inputs were not captured")
    check(np.array_equal(got, tokens), "layered tokens != fused tokens")
    check(torch.equal(layered_logits, fused_logits),
          "first decode step logits: layered != fused (max diff "
          f"{(layered_logits - fused_logits).abs().max().item()})")
    rows.append(fused_numbers("layered", layered.summary(),
                              {"calls": 0, "ms": 0.0}, counts_l))
    for row in rows:
        print_fused(row)
    print("  layered tokens == fused tokens, first decode step logits "
          f"torch.equal; a replay launches {per_step}")

    loop1 = ServeLoop(params, cfg, max_seq=max_seq, pipeline_depth=1)
    loop1.run(prompts, 2)                     # warm-up
    capture1 = loop1.summary()["capture"]
    reset_launches()
    got = loop1.run(prompts, GEN)             # the main path at depth 1
    counts1 = read_launches()
    check(counts1 == want, f"depth 1: launches {counts1}")
    check(np.array_equal(got, tokens), "depth 1: tokens != depth 0 tokens")
    info["depth1"] = serve_numbers(1, loop1.summary())
    print(f"  depth 1: prefill {info['depth1']['prefill_ms']:.1f} ms, decode "
          f"{info['depth1']['decode_tok_per_s']:.1f} tok/s (drain "
          f"{info['depth1']['drain_ms']:.1f} ms); launches "
          f"{ {k: v for k, v in counts1.items() if v} }; tokens == depth 0")
    rows.append(fused_numbers("fused, depth 1", loop1.summary(), capture1,
                              counts1))
    layered1 = ServeLoop(params, cfg, max_seq=max_seq, two_phase=True,
                         pipeline_depth=1)
    layered1.run(prompts, 2)                  # warm-up
    reset_launches()
    got = layered1.run(prompts, GEN)
    counts1 = read_launches()
    check(counts1 == want, f"layered depth 1: {counts1}")
    check(np.array_equal(got, tokens), "layered depth 1: tokens")
    rows.append(fused_numbers("layered, depth 1", layered1.summary(),
                              {"calls": 0, "ms": 0.0}, counts1))
    for row in rows[2:]:
        print_fused(row)
    _, syncs, waits = count_syncs(loop1.decode_step)
    torch.cuda.synchronize()
    print(f"  host syncs of one fused depth-1 decode step: {syncs} (event "
          f"waits {waits})")
    check(syncs == 0 and waits == 0,
          f"a fused depth-1 decode step synced {syncs} times, waited {waits}")
    info["fused"] = {
        "runs": rows, "depth1_step_syncs": syncs,
        "first_step_logits_equal": True,
        "traces": [trace_decode("rwkv6-7b, layered eager", layered, prompts),
                   trace_decode("rwkv6-7b, fused replayed", loop, prompts)]}
    del loop, loop1, layered, layered1
    info["scheduler"] = phase_rwkv_scheduler(cfg, params)
    del params
    return info, counts, captured[0], (step_calls[0], lora_calls, norm.x)


RWKV_SCHED_REQUESTS = 8


def phase_rwkv_scheduler(cfg, params):
    """Continuous batching of rwkv6-7b on the RWKV phase's weights: the
    first RWKV_SCHED_REQUESTS requests of :func:`scheduler_trace` (prompts
    64-512 tokens, budgets 8-32) through ``ServeScheduler`` with
    SCHED_SLOTS slots, as :func:`drive_scheduler` submits them, fused (the
    default: one CUDA graph a batch bucket over the pool's rows) and
    ``two_phase=True`` (layered, eager), counts set to 0 just before each.
    Checks: the same tokens per request; K7 once a layer an admission,
    W1 once a layer and R1 :func:`r1_per_step` times a decode step
    (:func:`rwkv_counts`, replays counted), no plain version on the
    card; fused, one graph for each bucket seen, a replay launching W1 and R1 so.  Then each request
    served alone through one fused ``ServeLoop`` (B = 1) must give its
    scheduled tokens, every one of them (W1 and R1 sum in one order a
    row, so the batch cannot enter).  Then resilience: the fused run
    again with a ``sample`` exception at step RES_EXC_STEP, after the
    replay has stepped every layer's state, retried from the saved state:
    8 of 8 requests and every pool leaf (``wkv``, the shifts) at the end
    ``torch.equal`` to the fault-free fused run's; and the save's cost
    (:func:`save_cost`)."""
    import torch
    from repro_torch.launch.serve import ServeLoop, ServeScheduler
    from repro_torch.runtime import resilience as R
    trace = scheduler_trace(cfg.vocab_size)[:RWKV_SCHED_REQUESTS]
    n = cfg.n_repeats
    print(f"rwkv continuous batching: {len(trace)} requests, prompts "
          f"{min(len(p) for p, _ in trace)}-{max(len(p) for p, _ in trace)}"
          f", {SCHED_SLOTS} slots:")
    runs, toks = [], {}
    for key, kw in (("fused", {}), ("layered", {"two_phase": True})):
        sched = ServeScheduler(params, cfg, max_seq=SCHED_MAX_SEQ,
                               max_slots=SCHED_SLOTS, **kw)
        reset_launches()
        with no_plain():
            wall = drive_scheduler(sched, trace, {})   # the main path
        counts = read_launches()
        toks[key] = {r.uid: list(r.tokens) for r in sched.finished}
        check(sorted(toks[key]) == list(range(len(trace))),
              f"rwkv scheduler {key}: finished {sorted(toks[key])}")
        steps = sum(st.phase == "decode" for st in sched.stats)
        want = rwkv_counts(cfg, len(trace), steps)
        check(counts == want, f"rwkv scheduler {key}: launches {counts} "
                              f"!= {want} ({steps} decode steps)")
        if key == "fused":
            per_step = {"wkv_step": n, "router_logits": r1_per_step(cfg)}
            graphs = {b: f.graph is not None and f.launches == per_step
                      for b, f in sched._fused.items()}
            check(set(graphs) == sched.batch_buckets
                  and all(graphs.values()),
                  f"rwkv scheduler: graphs {graphs} for buckets "
                  f"{sorted(sched.batch_buckets)}")
        if key == "fused":
            clean_pool = [t.clone() for slot in sched.cache["slots"]
                          for t in slot.values()]
        runs.append({**scheduler_numbers(f"rwkv {key}", sched, wall),
                     "k7_launches": counts["wkv_kernel"],
                     "w1_launches": counts["wkv_step"],
                     "r1_launches": counts["router_logits"],
                     "decode_steps": steps})
        print_scheduler(runs[-1])
        del sched
    check(toks["fused"] == toks["layered"],
          "rwkv scheduler: fused tokens != layered tokens")
    loop = ServeLoop(params, cfg, max_seq=SCHED_MAX_SEQ)
    alone = [loop.run(p[None], g)[0].tolist() == toks["fused"][i]
             for i, (p, g) in enumerate(trace)]
    del loop
    print(f"  fused tokens == layered; K7 {n} an admission, W1 {n} and R1 "
          f"{r1_per_step(cfg)} a decode step; {sum(alone)} of {len(trace)} "
          f"requests give the tokens they get alone (B = 1)")
    check(all(alone), f"rwkv scheduler: only {sum(alone)} of {len(trace)} "
                      "requests equal themselves alone")

    def make(**kw):
        return ServeScheduler(params, cfg, max_seq=SCHED_MAX_SEQ,
                              max_slots=SCHED_SLOTS, **kw)

    plan = R.FaultPlan.single("sample", "exception", step=RES_EXC_STEP)
    sched = make(fault_plan=plan)
    with no_plain():
        drive_scheduler(sched, trace, {})
    got = {r.uid: list(r.tokens) for r in sched.finished}
    pool = [t for slot in sched.cache["slots"] for t in slot.values()]
    pool_equal = len(pool) == len(clean_pool) and all(
        torch.equal(a, b) for a, b in zip(pool, clean_pool))
    n_equal = sum(got.get(u) == toks["fused"][u] for u in toks["fused"])
    check(n_equal == len(trace) and pool_equal
          and plan.triggered == [("sample", "exception", RES_EXC_STEP, ())]
          and sched.health.counters["retry"] == 1,
          f"rwkv scheduler, sample exception at step {RES_EXC_STEP}: "
          f"{n_equal} of {len(trace)} equal, pool equal {pool_equal}, "
          f"fired {plan.triggered}")
    del sched, pool, clean_pool
    gc.collect()
    cost = save_cost(lambda retry: make(retry=retry), trace, {})
    print(f"  resilience: a sample exception at step {RES_EXC_STEP} retried "
          f"after the replay: {n_equal} of {len(trace)} requests and every "
          f"pool leaf (wkv, shifts) == the fault-free run; the retry's "
          f"save {cost['with']['mean']:.1f} tok/s with, "
          f"{cost['without']['mean']:.1f} without ({cost['order']}: "
          f"{cost['without']['tok_per_s'][0]:.1f}, "
          f"{cost['with']['tok_per_s'][0]:.1f}, "
          f"{cost['with']['tok_per_s'][1]:.1f}, "
          f"{cost['without']['tok_per_s'][1]:.1f}); the save at bucket "
          f"{cost['save']['bucket']} {cost['save']['ms']:.4f} ms for "
          f"{cost['save']['bytes']} bytes (bound "
          f"{cost['save']['bound_ms']:.4f} ms)")
    return {"requests": len(trace), "slots": SCHED_SLOTS, "runs": runs,
            "tokens_equal": True, "alone_matches": sum(alone),
            "alone": alone,
            "resilience": {"retried_step": RES_EXC_STEP,
                           "requests_equal": n_equal, "pool_equal": True,
                           "save_cost": cost}}


def phase_measure_wkv(captured, launches, card):
    """The K7 row at the slice's shape: layer 0's r, k, v, w (f32), u and
    chunk from the served prefill.  Kernel vs plain (``y`` and the state,
    WKV_REL_TOL), two launches equal; ``ms`` by CUDA events, with the SM
    clock and its limit read before and after; ``plain_ms`` the plain
    chunked version; no single PyTorch call computes WKV, so
    ``library_ms`` is null.  Bound: the larger of reading r, k, v, w, u and
    writing y and the state once at 3.35 TB/s and :func:`wkv_needed_flops`
    three times (an f32-accurate product on the tensor cores is three TF32
    ones) at the 495 TFLOP/s TF32 peak; the same flops once at the f32
    CUDA-core peak are printed beside it.  The kernel is called through
    ``ops.wkv_state`` as the model calls it (T = 2048 needs no padding)."""
    import torch
    from repro_torch.kernels.wkv import ops, ref
    r, k, v, w, u, chunk = captured
    run = lambda: ops.wkv_state(r, k, v, w, u, chunk=chunk)  # noqa: E731
    y, s = run()
    py, ps = ref.wkv_chunked_plain(r, k, v, w, u, chunk)
    err = max(wkv_err(y, py, "K7 at the slice's shape, y"),
              wkv_err(s, ps, "K7 at the slice's shape, state"))
    y2, s2 = run()
    check(torch.equal(y, y2) and torch.equal(s, s2),
          "K7 at the slice's shape: two launches differ")
    clocks = [smi(CLOCKS)]
    ms = time_ms(run, 10, 2)
    clocks.append(smi(CLOCKS))
    plain_ms = time_ms(lambda: ref.wkv_chunked_plain(r, k, v, w, u, chunk),
                       3, 1)
    B, T, nh, hd = r.shape
    nbytes = (sum(x.numel() * x.element_size() for x in (r, k, v, w, u))
              + 4 * y.numel() + 4 * s.numel())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops = wkv_needed_flops(B, T, nh, hd, chunk)
    ops_ms = 3 * flops / TF32_FLOP_PER_S * 1e3
    f32_ms = flops / F32_FLOP_PER_S * 1e3
    print(f"  wkv_kernel: {ms:.3f} ms (bound {max(ops_ms, bytes_ms):.4f}: "
          f"bytes {bytes_ms:.4f}, 3xTF32 {ops_ms:.4f}; f32 CUDA cores "
          f"{f32_ms:.4f}; plain {plain_ms:.1f}), max_abs_err {err:.3g}; "
          f"sm clock, max: {clocks[0]} before, {clocks[1]} after")
    return {"name": "wkv_kernel", "route": "cuda",
            "source": "src/repro_torch/kernels/wkv/csrc/wkv.cu",
            "replaces": WKV_SRC, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None, "bytes_ms": bytes_ms, "tf32x3_ms": ops_ms,
            "f32_cuda_core_ms": f32_ms, "sm_clocks": clocks,
            "shape": {"B": B, "T": T, "nh": nh, "hd": hd, "chunk": chunk,
                      "dtype": str(r.dtype)[6:],
                      "w_dtype": str(w.dtype)[6:]},
            "card": card}


def _wkv_step_times(a, what: str) -> dict:
    """W1 on ``a`` = (r, k, v, e, u, s0), as the model runs it:
    :func:`_wkv_step_case`'s checks, the kernel's time in place (on a copy
    of s0, as the decode step writes its cache) back to back and from a
    CUDA graph, the plain step's (``torch.einsum`` and the
    elementwise passes) the same two ways, and the bound: r, k, v, e, u
    and the state read once, y and the new state written once, at 3.35
    TB/s (its 3 B nh 64^2 multiply-adds take ~0.1 % of that at the f32
    peak)."""
    from repro_torch.kernels.wkv import kernel as wk
    from repro_torch.kernels.wkv import ref
    err = _wkv_step_case(a, f"W1 at {what}")
    st = a[5].clone()
    run = lambda: wk.wkv_step(*a[:5], st, out=st)  # noqa: E731
    plain = lambda: ref.wkv_step_plain(*a)  # noqa: E731
    ms, plain_ms = time_ms(run, 50), time_ms(plain, 50)
    graph = {"ms": graph_ms(run), "plain_ms": graph_ms(plain)}
    r, s0 = a[0], a[5]
    B, nh, hd = r.shape
    nbytes = sum(x.numel() * 4 for x in a) + 4 * r.numel() + 4 * s0.numel()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * 3 * B * nh * hd * hd / F32_FLOP_PER_S * 1e3
    print(f"  W1 {what} (B {B} x {nh} heads): {ms:.4f} ms (graph "
          f"{graph['ms']:.4f}; bound {max(bytes_ms, ops_ms):.5f}; plain "
          f"{plain_ms:.4f}, graph {graph['plain_ms']:.4f}), y max_abs_err "
          f"{err:.3g}; == its emulated order, state == plain")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": plain_ms, "graph": graph,
            "shape": {"B": B, "nh": nh, "hd": hd}}


def phase_measure_wkv_step(captured, launches, rows, card):
    """The W1 row at the calls the main path made: layer 0 of the served
    4 x 2048 decode's first step (the state its prefill left), with its
    row 0 alone (B 1) and its rows twice over (the scheduler's bucket 8)
    beside it; row i of the B 4 call == the row alone.  No single PyTorch
    call computes the step, so ``library_ms`` is the plain step's (einsum
    plus elementwise passes), as ``plain_ms``.  The two decay-LoRA R1
    calls of the same step are timed (:func:`_router_times`, against
    ``torch.matmul``) and added to the R1 row of ``rows``, and so is its
    first norm's row sum (:func:`_row_sum_times`)."""
    import torch
    (r, k, v, e, u, s0), lora, norm = captured
    a = (r, k, v, e, u, s0)
    _wkv_step_rows_alone(a, "W1 at the served decode step")
    w1 = _wkv_step_times(a, "4 x 2048, first decode step, layer 0")
    one = _wkv_step_times(tuple(x if x is u else x[:1] for x in a),
                          "its row 0 alone (B 1)")
    eight = _wkv_step_times(tuple(x if x is u else torch.cat([x, x])
                                  for x in a), "its rows twice (bucket 8)")
    r1 = [_router_times((call, {}), f"rwkv6 decay LoRA {i + 1}, 4 x 2048 "
                                    "first decode step")
          for i, call in enumerate(lora)]
    r1_norm = _row_sum_times(norm, "rwkv6 4 x 2048 first decode step, "
                                   "layer 0 ln1")
    for row in rows:
        if row["name"] == "router_logits":
            row["rwkv_lora_calls"] = r1
            row["rmsnorm_calls"].append(r1_norm)
    return {"name": "wkv_step", "route": "cuda",
            "source": "src/repro_torch/kernels/wkv/csrc/wkv_step.cu",
            "replaces": "src/repro/models/rwkv6.py:145 (array code, no "
                        "Pallas kernel)",
            "launches": launches["wkv_step"], **w1, "b1_call": one,
            "bucket8_call": eight, "card": card}


# ---------------------------------------------------------------------------
# gemma3-12b serving at full width and depth: five local layers (a window of
# 1,024, ring-buffer decode caches) to one global, qk_norm, head dim 256.
# ---------------------------------------------------------------------------

GEMMA_ARCH, GEMMA_PROMPT, GEMMA_GEN, GEMMA_MASK_GEN = "gemma3-12b", 1536, 64, 8
# the scheduler's trace: prompts 900-1,100 tokens and budgets 48-144, so
# that rows cross the window of 1,024 at different steps
GEMMA_SCHED_REQUESTS, GEMMA_SCHED_SEED, GEMMA_SCHED_MAX_SEQ = 8, 33, 1280


def gemma_trace(vocab: int):
    """The gemma scheduler's requests, from ``default_rng``
    (GEMMA_SCHED_SEED)."""
    import numpy as np
    rng = np.random.default_rng(GEMMA_SCHED_SEED)
    return [(rng.integers(0, vocab, int(rng.integers(900, 1101))
                          ).astype(np.int32), int(rng.integers(48, 145)))
            for _ in range(GEMMA_SCHED_REQUESTS)]


# ---------------------------------------------------------------------------
# the dense GQA family at full width and DEPTH's depth: qwen3-1.7b and
# qwen2-1.5b 7 of 28 layers, nemotron-4-340b 4 of 96

DENSE_ARCHS = ("qwen3-1.7b", "qwen2-1.5b", "nemotron-4-340b")
# the frontend configs, served by the dense phases at full width and
# DEPTH's 12 of 48 layers (each arch's bf16 params printed): their
# prompts
# come after frontend_tokens (64 / 256) embedding positions, 0.02 * N(0, 1)
# in bf16 from a seeded generator, as the reference's CLI makes them
FRONTEND_ARCHS = ("musicgen-large", "internvl2-26b")
DENSE_PROMPT = {"qwen3-1.7b": 2048, "qwen2-1.5b": 2048,
                "nemotron-4-340b": 1024, "musicgen-large": 1024,
                "internvl2-26b": 1024}
# the archs whose serving phase also runs the local_global masked prefill
MASKED_ARCHS = ("nemotron-4-340b", "internvl2-26b")
DENSE_GEN, DENSE_MASK_GEN = 32, 8
# the scheduler's trace: 8 requests of 256-1,024 prompt tokens and budgets
# of 16-64 from numpy seed DENSE_SCHED_SEED, 8 slots
DENSE_SCHED_REQUESTS, DENSE_SCHED_SEED, DENSE_SCHED_MAX_SEQ = 8, 34, 1088


def dense_trace(vocab: int):
    """The dense family's scheduler requests, from ``default_rng``
    (DENSE_SCHED_SEED)."""
    import numpy as np
    rng = np.random.default_rng(DENSE_SCHED_SEED)
    return [(rng.integers(0, vocab, int(rng.integers(256, 1025))
                          ).astype(np.int32), int(rng.integers(16, 65)))
            for _ in range(DENSE_SCHED_REQUESTS)]


def _alone_report(loop, trace, toks, what: str) -> list:
    """Each request of ``trace`` through ``loop`` alone (B = 1) against its
    scheduled tokens; where one parts, the step and the tokens are
    printed.  Returns one bool a request."""
    alone = []
    for i, (p, g) in enumerate(trace):
        mine = loop.run(p[None], g)[0].tolist()
        alone.append(mine == toks[i])
        if mine != toks[i]:
            at = next(j for j, (a, b) in enumerate(zip(mine, toks[i]))
                      if a != b)
            print(f"  {what}: request {i} (prompt {len(p)}) parts from "
                  f"alone at token {at}: {toks[i][at:at + 4]} scheduled, "
                  f"{mine[at:at + 4]} alone")
    return alone


def phase_gemma_scheduler(cfg, params):
    """Continuous batching of gemma3-12b at full width and depth:
    :func:`gemma_trace`'s 8 requests through ``ServeScheduler`` (8 slots,
    fused: one CUDA graph a batch bucket over the pool's rows; the rings
    written at each row's own slot), as :func:`drive_scheduler` submits
    them, wide and with ``kv_quant="int8"`` (global layers narrow, rings
    wide), counts set to 0 just before each: D1 once a layer and R1 once a
    decode norm (q_norm and k_norm included) a decode step, replays
    counted, no plain version on the card, one graph a bucket seen.  Each
    request served alone through one fused ``ServeLoop`` (B = 1, the same
    ``kv_quant``) must give its scheduled tokens: 8 of 8 in each run."""
    from repro_torch.launch.serve import ServeLoop, ServeScheduler
    trace = gemma_trace(cfg.vocab_size)
    W = cfg.local_window
    cross = [W - len(p) for p, g in trace if len(p) < W < len(p) + g]
    print(f"gemma continuous batching: {len(trace)} requests, prompts "
          f"{min(len(p) for p, _ in trace)}-{max(len(p) for p, _ in trace)}"
          f", budgets {min(g for _, g in trace)}-{max(g for _, g in trace)}"
          f", {SCHED_SLOTS} slots, max_seq {GEMMA_SCHED_MAX_SEQ}; "
          f"{len(cross)} rows cross the window, at their decode steps "
          f"{sorted(cross)}; {sum(len(p) >= W for p, _ in trace)} start "
          "past it")
    per_step = {"decode_attention": cfg.n_layers,
                "router_logits": r1_per_step(cfg)}
    runs = []
    for key, kw in (("fused", {}), ("fused_int8", {"kv_quant": "int8"})):
        sched = ServeScheduler(params, cfg, max_seq=GEMMA_SCHED_MAX_SEQ,
                               max_slots=SCHED_SLOTS, **kw)
        check(not sched.two_phase, "gemma's default scheduler is not fused")
        reset_launches()
        with no_plain(), keep_row_sum() as norm:
            wall = drive_scheduler(sched, trace, {})   # the main path
        counts = read_launches()
        toks = {r.uid: list(r.tokens) for r in sched.finished}
        check(sorted(toks) == list(range(len(trace))),
              f"gemma scheduler {key}: finished {sorted(toks)}")
        steps = sum(st.phase == "decode" for st in sched.stats)
        want = decode_counts(cfg, len(trace), steps)
        check(counts == want, f"gemma scheduler {key}: launches {counts} "
                              f"!= {want} ({steps} decode steps)")
        graphs = {b: f.graph is not None and f.launches == per_step
                  for b, f in sched._fused.items()}
        check(set(graphs) == sched.batch_buckets and all(graphs.values()),
              f"gemma scheduler {key}: graphs {graphs} for buckets "
              f"{sorted(sched.batch_buckets)}")
        runs.append({**scheduler_numbers(f"gemma {key}", sched, wall),
                     "d1_launches": counts["decode_attention"],
                     "r1_launches": counts["router_logits"],
                     "decode_steps": steps})
        print_scheduler(runs[-1])
        if key == "fused":
            # each bucket's first decode step (its warm-up, before the
            # capture): q_norm at bucket 8 is 128 rows, the many-token R1
            top = max(sched.batch_buckets)
            want_shapes = {(top, 1, cfg.d_model),
                           (top, cfg.n_heads, 1, cfg.hd)}
            check(top == SCHED_SLOTS and want_shapes <= set(norm.shapes),
                  f"gemma scheduler: buckets {sorted(sched.batch_buckets)},"
                  f" the decode norms kept {sorted(norm.shapes)}")
            _kept_row_sums({k: v for k, v in norm.shapes.items()
                            if k[0] == top}, f"gemma scheduler, bucket {top},")
        del sched, norm
        gc.collect()
        loop = ServeLoop(params, cfg, max_seq=GEMMA_SCHED_MAX_SEQ, **kw)
        with no_plain():
            alone = _alone_report(loop, trace, toks, f"gemma {key}")
        del loop
        runs[-1]["alone_matches"] = sum(alone)
        print(f"  {key}: {sum(alone)} of {len(trace)} requests give the "
              f"tokens they get alone (B = 1); D1 {cfg.n_layers} and R1 "
              f"{r1_per_step(cfg)} a decode step")
        check(all(alone), f"gemma scheduler {key}: only {sum(alone)} of "
                          f"{len(trace)} requests equal themselves alone")
    return {"requests": len(trace), "slots": SCHED_SLOTS,
            "max_seq": GEMMA_SCHED_MAX_SEQ, "window_crossings": sorted(cross),
            "runs": runs}


def phase_gemma_serving(card):
    """gemma3-12b (``CONFIG``: d_model 3840, 16/8 heads of 256, d_ff 15360,
    vocab 262,144, window 1,024) at DEPTH's 2 of its 8 units (12 of 48
    layers; random bf16 weights from a seed, 9.4 GB) served on the
    card.  ``ServeLoop`` serves BATCH
    prompts of GEMMA_PROMPT tokens (past the window: the prefill's rings
    have wrapped) and GEMMA_GEN greedy tokens, fused (the default: the
    decode step one replayed CUDA graph) and layered (``two_phase=True``):
    the same tokens and first decode step logits ``torch.equal``; D1 once
    a layer and R1 once a decode norm a decode step, nothing in the
    chunked prefill, no plain version on the card.  Then the sliding
    mask (K4s on the local layers, K4m likewise) and ``local_global``
    (K4s / K4m on all), each sparse == dense tokens; the kernel prefill
    (K3 on all); one fused and one layered decode step traced; the
    scheduler (:func:`phase_gemma_scheduler`).  Returns (summary, the
    captured prefill q, k, v of a local and a global layer, the layered
    run's first decode step's D1 calls on a ring and a global cache, the
    launches of each kernel's run)."""
    import numpy as np
    import torch
    from repro_torch.core.masks import AttnMaskSpec
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.serve import ServeLoop
    from repro_torch.models import model as M
    cfg, full, cut = served_config(GEMMA_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in _tensors(params)) / 1e9
    print(f"gemma serving: {cfg.name} d={cfg.d_model} heads={cfg.n_heads}/"
          f"{cfg.n_kv_heads} hd={cfg.hd} d_ff={cfg.d_ff} vocab="
          f"{cfg.vocab_size} {cut} "
          f"window={cfg.local_window} "
          f"qk_norm={cfg.qk_norm}; params {gb:.1f} GB, init "
          f"{time.monotonic() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(5)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, GEMMA_PROMPT),
                            generator=g, device="cuda")
    max_seq = GEMMA_PROMPT + GEMMA_GEN
    loop = ServeLoop(params, cfg, max_seq=max_seq)
    check(not loop.two_phase, "gemma3-12b's default loop is not fused")
    loop.run(prompts, 2)                      # warm-up: allocator, capture
    capture0 = loop.summary()["capture"]
    reset_launches()
    with no_plain():                          # the main path
        tokens, fused_logits = first_step_logits(loop, prompts, GEMMA_GEN)
    counts = read_launches()
    want = decode_counts(cfg, 1, GEMMA_GEN - 1)
    check(counts == want, f"gemma fused: launches {counts} != {want} (D1 "
                          "a layer, R1 a decode norm a decode step)")
    per_step = {"decode_attention": cfg.n_layers,
                "router_logits": r1_per_step(cfg)}
    check(loop.fused_step.launches == per_step, f"a gemma replay launches "
          f"{loop.fused_step.launches}, not {per_step}")
    check(tokens.shape == (BATCH, GEMMA_GEN) and (tokens >= 0).all()
          and (tokens < cfg.vocab_size).all(), "gemma: bad token ids")
    check(bool(torch.isfinite(fused_logits).all()),
          "gemma: first decode step logits not finite")
    summary = loop.summary()
    rows = [fused_numbers("fused", summary, capture0, counts)]
    layered = ServeLoop(params, cfg, max_seq=max_seq, two_phase=True)
    layered.run(prompts, 2)                   # warm-up
    calls = {}

    def keep(name, a, kw):
        if name != "decode_attention":
            return
        which = "ring" if a[1].shape[2] == cfg.local_window else "global"
        if which not in calls:
            calls[which] = (tuple(t.clone() for t in a[:3]), dict(kw))

    reset_launches()
    with no_plain(), hook_calls(keep), keep_row_sum() as norm:
        got, layered_logits = first_step_logits(layered, prompts, GEMMA_GEN)
    counts_l = read_launches()
    check(counts_l == want, f"gemma layered: launches {counts_l}")
    check(np.array_equal(got, tokens), "gemma: layered tokens != fused")
    check(torch.equal(layered_logits, fused_logits),
          "gemma: first decode step logits, layered != fused (max diff "
          f"{(layered_logits - fused_logits).abs().max().item()})")
    check(set(calls) == {"ring", "global"}
          and calls["ring"][1].get("window") is None
          and calls["global"][1].get("window") is None,
          f"gemma: D1 calls captured {sorted(calls)}")
    rows.append(fused_numbers("layered", layered.summary(),
                              {"calls": 0, "ms": 0.0}, counts_l))
    for row in rows:
        print_fused(row)
    print(f"  layered tokens == fused tokens, first decode step logits "
          f"torch.equal; a replay launches {per_step}; tokens "
          f"{tokens[0, :8].tolist()} ...; first decode step's D1: ring "
          f"kv_len {calls['ring'][1]['kv_len']}, global "
          f"{calls['global'][1]['kv_len']}")
    # the first decode step's norms: ln1 (and ln2, the final norm),
    # q_norm and k_norm, R1 against its order, alone and torch.sum
    want_shapes = {(BATCH, 1, cfg.d_model), (BATCH, cfg.n_heads, 1, cfg.hd),
                   (BATCH, cfg.n_kv_heads, 1, cfg.hd)}
    check(want_shapes <= set(norm.shapes), f"gemma: the decode norms kept "
          f"{sorted(norm.shapes)}, not {sorted(want_shapes)}")
    _kept_row_sums({k: norm.shapes[k] for k in want_shapes},
                   "gemma layered, first step,")
    del norm
    traces = [trace_decode("gemma3-12b, layered eager", layered, prompts),
              trace_decode("gemma3-12b, fused replayed", loop, prompts)]
    del layered
    # masked prefill: the same loop, its mask set between runs (the decode
    # step, which no mask reaches, keeps its graph)
    masked, launches = {}, {"decode_attention": counts["decode_attention"]}
    n_local = cfg.block_unit.count("attn_local") * cfg.n_repeats
    for pattern in (None, "local_global"):
        for impl, kern in (("sparse", "flash_attention_sparse"),
                           ("dense", "flash_attention_masked")):
            loop.attn_mask = AttnMaskSpec(local=True, pattern=pattern,
                                          impl=impl)
            fops.reset_fallbacks()
            reset_launches()
            with no_plain():
                toks = loop.run(prompts, GEMMA_MASK_GEN)
            c = read_launches()
            n = n_local if pattern is None else cfg.n_layers
            want_m = decode_counts(cfg, 1, GEMMA_MASK_GEN - 1, **{kern: n})
            label = f"{pattern or 'sliding'} {impl}"
            check(c == want_m, f"gemma {label}: launches {c} != {want_m}")
            check(fops.fallback_count() == 0, f"gemma {label}: fell back")
            masked[label] = {
                "tokens": toks,
                "prefill_ms": loop.summary()["prefill"]["seconds"] * 1e3,
                "launches": {k: v for k, v in c.items() if v}}
            if pattern is None:
                launches[kern] = c[kern]
        a, b = (masked[f"{pattern or 'sliding'} {i}"]["tokens"]
                for i in ("sparse", "dense"))
        check(np.array_equal(a, b), f"gemma {pattern or 'sliding'}: sparse "
                                    "tokens != dense tokens")
    loop.attn_mask = None
    same = float((masked["sliding sparse"]["tokens"]
                  == tokens[:, :GEMMA_MASK_GEN]).mean())
    for label, m in masked.items():
        print(f"  {label}: prefill {m['prefill_ms']:.1f} ms, launches "
              f"{m['launches']}")
    print(f"  sliding sparse == dense tokens, local_global sparse == dense;"
          f" sliding against unmasked (chunked) tokens: {same:.3f} equal")
    del loop
    # the kernel prefill (K3 on every layer); the first local and global
    # layers' q, k, v kept for the rows
    qkv = {}

    def keep_qkv(name, a, kw):
        which = "local" if kw.get("window") is not None else "global"
        if name == "attention" and which not in qkv \
                and kw.get("mask") is None:
            qkv[which] = tuple(t.contiguous().clone() for t in a[:3])

    reset_launches()
    t0 = time.monotonic()
    with hook_calls(keep_qkv):
        logits, _, _ = M.prefill(params, prompts, cfg, max_seq=max_seq,
                                 impl="kernel")
        torch.cuda.synchronize()
    kernel_ms = (time.monotonic() - t0) * 1e3
    check(set(qkv) == {"local", "global"},
          f"gemma kernel prefill: attention calls kept {sorted(qkv)}")
    c = read_launches()
    check(c == only(flash_attention=cfg.n_layers),
          f"gemma kernel prefill: launches {c}")
    check(bool(torch.isfinite(logits).all()), "gemma K3 prefill: logits")
    launches["flash_attention"] = c["flash_attention"]
    k3_first = logits[:, -1, :cfg.vocab_size].argmax(-1).cpu().numpy()
    print(f"  kernel prefill (K3 x {cfg.n_layers}) {kernel_ms:.1f} ms; "
          f"first tokens {np.mean(k3_first == tokens[:, 0]):.2f} equal to "
          "the chunked prefill's (information)")
    del logits
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sched = phase_gemma_scheduler(cfg, params)
    sched_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params
    gc.collect()
    torch.cuda.empty_cache()
    info = {"arch": cfg.name, "depth": cfg.n_layers,
            "full_depth": full.n_layers, "batch": BATCH,
            "prompt": GEMMA_PROMPT, "gen": GEMMA_GEN, "params_gb": gb,
            "runs": rows, "traces": traces,
            "masked": {k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
                       for k, v in masked.items()},
            "kernel_prefill_ms": kernel_ms,
            "sliding_vs_unmasked_tokens_equal": same,
            "peak_gb": peak_gb, "scheduler": sched,
            "scheduler_peak_gb": sched_peak_gb, "card": card}
    print(f"  gemma phase peak {peak_gb:.1f} GB (serving), "
          f"{sched_peak_gb:.1f} GB (with the scheduler)")
    return info, (qkv["local"], qkv["global"]), calls, launches


def phase_measure_gemma(qkv, calls, launches, card) -> list:
    """The D 256 rows: K3, K4m and K4s at a local layer's captured q, k, v
    (4 x 1,536, 16/8 heads), K3 causal under the window of 1,024 and K4 on
    the sliding-window mask (:func:`phase_measure_attention`), the global
    layer's K3 (causal) beside; D1 at the first fused-equal decode step's
    ring call (B 4, 1,024 slots every one visible), with its global call
    (1,537 of 1,600 positions), row 0 alone (B 1) and the rows twice (B 8)
    beside (:func:`_decode_times`)."""
    import torch
    from repro_torch.core.masks import BlockMask
    local, glob = qkv
    S = local[0].shape[2]
    mask = BlockMask.sliding_window(S, S, 1024, bq=64, bk=64)
    rows = phase_measure_attention(local, mask, launches, card,
                                   k3_window=1024, suffix=" D256")
    k3_global = phase_measure_attention(
        glob, BlockMask.causal(S, S, bq=64, bk=64), launches, card,
        suffix=" D256 global", names=("flash_attention",))[0]
    rows[0]["global_layer_call"] = {
        k: k3_global[k] for k in ("max_abs_err", "ms", "graph_ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "tiles")}
    (q, k, v), kw = calls["ring"]
    d1 = _decode_times(calls["ring"], "gemma 4 x 1536, ring, first step")
    beside = {
        "global_call": _decode_times(calls["global"],
                                     "gemma 4 x 1536, global, first step"),
        "b1_call": _decode_times(((q[:1], k[:1], v[:1]), kw),
                                 "gemma ring, row 0 alone (B 1)"),
        "b8_call": _decode_times(((q.repeat(2, 1, 1, 1).contiguous(),
                                   k.repeat(2, 1, 1, 1).contiguous(),
                                   v.repeat(2, 1, 1, 1).contiguous()), kw),
                                 "gemma ring, rows twice (B 8)")}
    rows.append({"name": "decode_attention D256", "route": "cuda",
                 "source": "src/repro_torch/kernels/flash_attention/csrc/"
                           "decode_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention/ops.py:212 "
                             "(array code, no Pallas kernel)",
                 "launches": launches["decode_attention"], **d1, **beside,
                 "card": card})
    return rows


def phase_dense_scheduler(cfg, params):
    """Continuous batching of a dense arch (or zamba2-1.2b):
    :func:`dense_trace`'s 8 requests through ``ServeScheduler`` (8 slots,
    max_seq DENSE_SCHED_MAX_SEQ), as :func:`drive_scheduler` submits them,
    wide and with ``kv_quant="int8"``, each fused (one CUDA graph a batch
    bucket over the pool's rows) and two-phase (layered, eager), counts
    set to 0 just before each: a decode step's launches those of
    :func:`step_counts` (D1 once an attention layer, M1 once a mamba layer,
    R1 once a decode norm), replays counted, no plain version on the card;
    fused == two-phase tokens.  Each request served alone through one fused
    ``ServeLoop`` (B = 1, the same ``kv_quant``) must give its scheduled
    tokens: 8 of 8, wide and int8."""
    from repro_torch.launch.serve import ServeLoop, ServeScheduler
    trace = dense_trace(cfg.vocab_size)
    print(f"  {cfg.name} continuous batching: {len(trace)} requests, "
          f"prompts {min(len(p) for p, _ in trace)}-"
          f"{max(len(p) for p, _ in trace)}, budgets "
          f"{min(g for _, g in trace)}-{max(g for _, g in trace)}, "
          f"{SCHED_SLOTS} slots, max_seq {DENSE_SCHED_MAX_SEQ}")
    per_step = step_counts(cfg)
    runs, alone_matches = [], {}
    for kv in (None, "int8"):
        toks_by = {}
        for two_phase in (False, True):
            key = ("two_phase" if two_phase else "fused") + (
                f"_{kv}" if kv else "")
            sched = ServeScheduler(params, cfg, max_seq=DENSE_SCHED_MAX_SEQ,
                                   max_slots=SCHED_SLOTS,
                                   two_phase=two_phase, kv_quant=kv)
            reset_launches()
            with no_plain():
                wall = drive_scheduler(sched, trace, {})   # the main path
            counts = read_launches()
            toks = {r.uid: list(r.tokens) for r in sched.finished}
            check(sorted(toks) == list(range(len(trace))),
                  f"{cfg.name} scheduler {key}: finished {sorted(toks)}")
            steps = sum(st.phase == "decode" for st in sched.stats)
            want = decode_counts(cfg, len(trace), steps)
            check(counts == want, f"{cfg.name} scheduler {key}: launches "
                                  f"{counts} != {want} ({steps} steps)")
            if not two_phase:
                graphs = {b: f.graph is not None and f.launches == per_step
                          for b, f in sched._fused.items()}
                check(set(graphs) == sched.batch_buckets
                      and all(graphs.values()),
                      f"{cfg.name} scheduler {key}: graphs {graphs} for "
                      f"buckets {sorted(sched.batch_buckets)}")
            runs.append({**scheduler_numbers(f"{cfg.name} {key}", sched,
                                             wall),
                         "d1_launches": counts["decode_attention"],
                         "r1_launches": counts["router_logits"],
                         "m1_launches": counts["ssd_step"],
                         "decode_steps": steps})
            print_scheduler(runs[-1])
            toks_by[two_phase] = toks
            del sched
        check(toks_by[False] == toks_by[True], f"{cfg.name} scheduler "
              f"kv_quant={kv}: fused tokens != two-phase tokens")
        loop = ServeLoop(params, cfg, max_seq=DENSE_SCHED_MAX_SEQ,
                         kv_quant=kv)
        with no_plain():
            alone = _alone_report(loop, trace, toks_by[False],
                                  f"{cfg.name} kv_quant={kv}")
        del loop
        gc.collect()
        alone_matches[kv or "wide"] = sum(alone)
        print(f"  kv_quant={kv}: fused == two-phase tokens; {sum(alone)} of "
              f"{len(trace)} requests give the tokens they get alone (B = "
              f"1); a decode step launches {per_step}")
        check(all(alone), f"{cfg.name} scheduler kv_quant={kv}: only "
                          f"{sum(alone)} of {len(trace)} requests equal "
                          "themselves alone")
    return {"requests": len(trace), "slots": SCHED_SLOTS,
            "max_seq": DENSE_SCHED_MAX_SEQ, "seed": DENSE_SCHED_SEED,
            "runs": runs, "alone_matches": alone_matches}


def phase_dense_serving(arch: str, card):
    """One arch of the dense GQA family, or a frontend config, served on
    the card: its ``CONFIG`` at full width and DEPTH's depth (qwen3-1.7b
    and qwen2-1.5b 7 of 28, musicgen-large and internvl2-26b 12 of 48,
    nemotron-4-340b 4 of 96, the cut printed), random bf16 weights from a
    seed (qwen2's biases random too).  ``ServeLoop`` serves BATCH prompts
    of DENSE_PROMPT tokens (chunked prefill; a frontend config's after its
    ``frontend_tokens`` bf16 embeddings of 0.02 * N(0, 1) from a seeded
    generator, ``max_seq`` counting them) and DENSE_GEN greedy tokens,
    fused (the default: the decode step one replayed CUDA graph) and
    layered (``two_phase=True``): the same tokens and first decode step
    logits ``torch.equal``; D1 once a layer and R1 once a decode norm a
    decode step, nothing in the chunked prefill, no plain version on the
    card; one fused and one layered decode step traced.  MASKED_ARCHS:
    the masked prefill (``local_global`` over S_total) through K4s and
    K4m, sparse == dense tokens.  The kernel prefill (K3 once a layer),
    timed; then the scheduler (:func:`phase_dense_scheduler`, text-only
    requests).  The weights are freed before it returns.  Returns
    (summary, layer 0's q, k, v of the kernel prefill, the layered run's
    first decode step's D1 call, the launches of each kernel's run)."""
    import numpy as np
    import torch
    from repro_torch.core.masks import AttnMaskSpec
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.serve import ServeLoop
    from repro_torch.models import model as M
    t_phase = time.monotonic()
    cfg, full, cut = served_config(arch)
    prompt_len = DENSE_PROMPT[arch]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = M.init_params(cfg, seed=0, device="cuda")
    random_biases(params, 7)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    gb = sum(t.numel() * t.element_size() for t in _tensors(params)) / 1e9
    print(f"{arch} serving: d={cfg.d_model} heads={cfg.n_heads}/"
          f"{cfg.n_kv_heads} (group {cfg.n_heads // cfg.n_kv_heads}) hd="
          f"{cfg.hd} d_ff={cfg.d_ff} ({cfg.mlp_type}) vocab={cfg.vocab_size}"
          f" qk_norm={cfg.qk_norm} qkv_bias={cfg.qkv_bias}; {cut}; "
          f"params {gb:.2f} GB, init "
          f"{init_s:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(5)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, prompt_len),
                            generator=g, device="cuda")
    emb, front = None, cfg.frontend_tokens if cfg.frontend != "none" else 0
    if front:
        ge = torch.Generator(device="cuda").manual_seed(6)
        emb = (0.02 * torch.randn((BATCH, front, cfg.d_model), generator=ge,
                                  device="cuda")).to(torch.bfloat16)
        print(f"  {front} {cfg.frontend} embedding positions (bf16, 0.02 "
              f"* N(0, 1)) before each prompt: S_total {front + prompt_len}")
    max_seq = front + prompt_len + DENSE_GEN
    loop = ServeLoop(params, cfg, max_seq=max_seq)
    check(not loop.two_phase, f"{arch}'s default loop is not fused")
    loop.run(prompts, 2, embeddings=emb)      # warm-up: allocator, capture
    capture0 = loop.summary()["capture"]
    reset_launches()
    with no_plain():                          # the main path
        tokens, fused_logits = first_step_logits(loop, prompts, DENSE_GEN,
                                                 emb)
    counts = read_launches()
    want = decode_counts(cfg, 1, DENSE_GEN - 1)
    check(counts == want, f"{arch} fused: launches {counts} != {want}")
    per_step = {"decode_attention": cfg.n_layers,
                "router_logits": r1_per_step(cfg)}
    check(loop.fused_step.launches == per_step, f"a {arch} replay launches "
          f"{loop.fused_step.launches}, not {per_step}")
    check(tokens.shape == (BATCH, DENSE_GEN) and (tokens >= 0).all()
          and (tokens < cfg.vocab_size).all(), f"{arch}: bad token ids")
    check(bool(torch.isfinite(fused_logits).all()),
          f"{arch}: first decode step logits not finite")
    check(loop.pos == front + prompt_len, f"{arch}: decode started at "
                                          f"{loop.pos}, not S_total")
    rows = [fused_numbers("fused", loop.summary(), capture0, counts)]
    layered = ServeLoop(params, cfg, max_seq=max_seq, two_phase=True)
    layered.run(prompts, 2, embeddings=emb)   # warm-up
    calls = {}

    def keep(name, a, kw):
        if name == "decode_attention" and not calls:
            calls["first"] = (tuple(t.clone() for t in a[:3]), dict(kw))

    reset_launches()
    with no_plain(), hook_calls(keep):
        got, layered_logits = first_step_logits(layered, prompts, DENSE_GEN,
                                                emb)
    counts_l = read_launches()
    check(counts_l == want, f"{arch} layered: launches {counts_l}")
    check(np.array_equal(got, tokens), f"{arch}: layered tokens != fused")
    check(torch.equal(layered_logits, fused_logits),
          f"{arch}: first decode step logits, layered != fused (max diff "
          f"{(layered_logits - fused_logits).abs().max().item()})")
    rows.append(fused_numbers("layered", layered.summary(),
                              {"calls": 0, "ms": 0.0}, counts_l))
    for row in rows:
        print_fused(row)
    print(f"  layered tokens == fused tokens, first decode step logits "
          f"torch.equal; a replay launches {per_step}; tokens "
          f"{tokens[0, :8].tolist()} ...; first decode step's D1 kv_len "
          f"{calls['first'][1]['kv_len']}")
    traces = [trace_decode(f"{arch}, layered eager", layered, prompts, emb),
              trace_decode(f"{arch}, fused replayed", loop, prompts, emb)]
    del layered
    launches = {"decode_attention": counts["decode_attention"]}
    masked = {}
    if arch in MASKED_ARCHS:
        spec, mask = serving_mask(cfg, front + prompt_len)
        for impl, kern in (("sparse", "flash_attention_sparse"),
                           ("dense", "flash_attention_masked")):
            loop.attn_mask = AttnMaskSpec(**spec, impl=impl)
            fops.reset_fallbacks()
            reset_launches()
            with no_plain():
                toks = loop.run(prompts, DENSE_MASK_GEN, embeddings=emb)
            c = read_launches()
            want_m = decode_counts(cfg, 1, DENSE_MASK_GEN - 1,
                                   **{kern: cfg.n_layers})
            check(c == want_m, f"{arch} masked {impl}: launches {c} != "
                               f"{want_m}")
            check(fops.fallback_count() == 0, f"{arch} masked {impl}: fell "
                                              "back")
            launches[kern] = c[kern]
            masked[impl] = {
                "tokens": toks,
                "prefill_ms": loop.summary()["prefill"]["seconds"] * 1e3}
        check(np.array_equal(masked["sparse"]["tokens"],
                             masked["dense"]["tokens"]),
              f"{arch} local_global: sparse tokens != dense tokens")
        loop.attn_mask = None
        print(f"  local_global (window {MASK_WINDOW} + the first tile, "
              f"{mask.nnzb} of {mask.n_q_tiles * mask.n_kv_tiles} tiles): "
              f"sparse == dense tokens; prefill "
              f"{masked['sparse']['prefill_ms']:.1f} ms (K4s), "
              f"{masked['dense']['prefill_ms']:.1f} ms (K4m)")
    del loop
    qkv = {}

    def keep_qkv(name, a, kw):
        if name == "attention" and not qkv and kw.get("mask") is None:
            qkv["first"] = tuple(t.contiguous().clone() for t in a[:3])

    reset_launches()
    t0 = time.monotonic()
    with hook_calls(keep_qkv):
        logits, _, _ = M.prefill(params, prompts, cfg, max_seq=max_seq,
                                 impl="kernel", embeddings=emb)
        torch.cuda.synchronize()
    kernel_ms = (time.monotonic() - t0) * 1e3
    c = read_launches()
    check(c == only(flash_attention=cfg.n_layers),
          f"{arch} kernel prefill: launches {c}")
    check(bool(torch.isfinite(logits).all()), f"{arch} K3 prefill: logits")
    launches["flash_attention"] = c["flash_attention"]
    k3_first = logits[:, -1, :cfg.vocab_size].argmax(-1).cpu().numpy()
    print(f"  kernel prefill (K3 x {cfg.n_layers}) {kernel_ms:.1f} ms; "
          f"first tokens {np.mean(k3_first == tokens[:, 0]):.2f} equal to "
          "the chunked prefill's (information)")
    del logits
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sched = phase_dense_scheduler(cfg, params)
    sched_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.monotonic() - t_phase
    info = {"arch": arch, "depth": cfg.n_layers, "full_depth": full.n_layers,
            "batch": BATCH, "prompt": prompt_len, "gen": DENSE_GEN,
            "frontend_positions": front,
            "params_gb": gb, "init_s": init_s, "runs": rows,
            "traces": traces,
            "masked": {k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
                       for k, v in masked.items()},
            "kernel_prefill_ms": kernel_ms, "peak_gb": peak_gb,
            "scheduler": sched, "scheduler_peak_gb": sched_peak_gb,
            "wall_s": wall, "card": card}
    print(f"  {arch} phase: peak {peak_gb:.1f} GB (serving), "
          f"{sched_peak_gb:.1f} GB (with the scheduler); {wall:.1f} s")
    return info, qkv["first"], calls["first"], launches


def phase_measure_dense(arch, qkv, call, launches, card) -> list:
    """An arch's rows at its served shapes: K3 at layer 0's q, k, v of the
    kernel prefill (causal), and MASKED_ARCHS' K4m and K4s on their
    masked prefill's ``local_global`` mask (:func:`phase_measure_attention`,
    D 192 and 128); D1 at the layered run's first decode step call
    (:func:`_decode_times`: with the bound of the passes at a group past
    8), row 0 alone (B 1) and the rows twice (B 8) beside."""
    from repro_torch.core.masks import BlockMask
    q = qkv[0]
    S, D = q.shape[2], q.shape[3]
    tag = f" D{D} {arch}"
    if arch in MASKED_ARCHS:
        _, mask = serving_mask(types.SimpleNamespace(hd=D), S)
        rows = phase_measure_attention(qkv, mask, launches, card,
                                       suffix=tag)
    else:
        rows = phase_measure_attention(
            qkv, BlockMask.causal(S, S, bq=64, bk=64), launches, card,
            suffix=tag, names=("flash_attention",))
    (q1, k1, v1), kw = call
    what = f"{arch} 4 x {S}, first step"
    d1 = _decode_times(call, what)
    beside = {
        "b1_call": _decode_times(((q1[:1], k1[:1], v1[:1]), kw),
                                 f"{arch}, row 0 alone (B 1)"),
        "b8_call": _decode_times(((q1.repeat(2, 1, 1, 1).contiguous(),
                                   k1.repeat(2, 1, 1, 1).contiguous(),
                                   v1.repeat(2, 1, 1, 1).contiguous()), kw),
                                 f"{arch}, rows twice (B 8)")}
    rows.append({"name": f"decode_attention D{D} {arch}", "route": "cuda",
                 "source": "src/repro_torch/kernels/flash_attention/csrc/"
                           "decode_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention/ops.py:212 "
                             "(array code, no Pallas kernel)",
                 "launches": launches["decode_attention"], **d1, **beside,
                 "card": card})
    return rows


# ---------------------------------------------------------------------------
# zamba2-1.2b serving at full width and depth: 38 Mamba-2 layers (2 prologue,
# 6 repeats x 6) and one shared attention block (32/32 heads of 64: a GQA
# group of 1) after every repeat; the one-token SSD step M1.
# ---------------------------------------------------------------------------

ZAMBA_ARCH, ZAMBA_PROMPT, ZAMBA_GEN, ZAMBA_MASK_GEN = (
    "zamba2-1.2b", 2048, 32, 8)
SSD_SRC = ("src/repro/models/mamba2.py:132-151 (array code, no Pallas "
           "kernel)")
# M1 vs plain: (hd, ns) instances at these batches, zamba2-1.2b's 64 heads
SSD_BATCHES, SSD_HEADS = (1, 4, 8, 16), 64
# the batched arguments of a whole step (xs, b, c, z, dt and the state);
# a_log, dt_bias and d_skip are the layer's
SSD_ROWS = (0, 1, 2, 3, 4, 8)


def _ssd_inputs(g, B, nh, hd, ns, dtype):
    """(xs, b, c, z, dt, a_log, dt_bias, d_skip, h0) of one whole step on
    the card, as ``apply_mamba`` hands them over: xs, b and c views of one
    conv output row (B, d_in + 2 ns), z and dt views of one projection row
    (B, 2 d_in + 2 ns + nh), in ``dtype``; dt + dt_bias past softplus's
    threshold of 20 at head 0 of every row; the layer's f32 a_log (the
    init's log 1..16 plus noise), dt_bias and d_skip; an f32 state."""
    import torch
    d_in = nh * hd
    r = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    conv = r(B, d_in + 2 * ns).to(dtype)
    proj = r(B, 2 * d_in + 2 * ns + nh)
    proj[:, -nh:] *= 2.0
    proj[:, -nh] = 24.0 + 4.0 * torch.rand(B, generator=g, device="cuda")
    proj = proj.to(dtype)
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, device="cuda")) \
        + 0.1 * r(nh)
    return (conv[:, :d_in], conv[:, d_in:d_in + ns], conv[:, d_in + ns:],
            proj[:, d_in + 2 * ns:2 * d_in + 2 * ns], proj[:, -nh:], a_log,
            0.5 * r(nh), 1.0 + 0.3 * r(nh), r(B, nh, hd, ns))


def _ssd_rows(a, lo: int, hi: int) -> tuple:
    """Rows [lo, hi) of a whole step's arguments ``a``."""
    return tuple(t[lo:hi] if i in SSD_ROWS else t for i, t in enumerate(a))


def _ssd_twice(a) -> tuple:
    """A whole step's arguments with every row twice (B 4 -> 8)."""
    import torch
    return tuple(torch.cat([t, t]) if i in SSD_ROWS else t
                 for i, t in enumerate(a))


def _ssd_step_case(a, what: str) -> float:
    """M1 (``kernel.ssd_step``) on ``a``, a whole step's arguments: its
    output ``torch.equal`` to ``ref.mamba_step_ordered``'s, its state to
    that and to ``ref.mamba_step_plain``'s, the output within
    :func:`tolerance` of plain's (one ulp of the largest |value| in bf16,
    1e-5 of it in f32: the same ns-term sums in another order), two
    launches ``torch.equal``, and the step in place (``out=`` h0's own
    storage, as the model runs it) the same bits.  Returns the output's
    error against plain."""
    import torch
    from repro_torch.kernels.ssd import kernel as mk
    from repro_torch.kernels.ssd import ref
    y, h = mk.ssd_step(*a)
    oy, oh = ref.mamba_step_ordered(*a)
    py, ph = ref.mamba_step_plain(*a)
    check(y.dtype == a[0].dtype and torch.equal(y, oy),
          f"{what}: M1's output != its emulated order's")
    check(torch.equal(h, oh) and torch.equal(h, ph),
          f"{what}: M1's state != the plain step's")
    y2, h2 = mk.ssd_step(*a)
    check(torch.equal(y, y2) and torch.equal(h, h2),
          f"{what}: two launches differ")
    st = a[8].clone()
    y3, h3 = mk.ssd_step(*a[:8], st, out=st)
    check(h3 is st and torch.equal(y3, y) and torch.equal(st, h),
          f"{what}: the step in place (out = h0) differs")
    return max_err(y, py, f"{what}: output")


def _ssd_rows_alone(a, what: str) -> None:
    """Row i of M1 (output and state) at each B of BATCH_LAW up to the
    rows of ``a`` == the row alone."""
    import torch
    from repro_torch.kernels.ssd import kernel as mk
    check(_rows_alone_equal(
        lambda *t: torch.cat([z.float().flatten(1)
                              for z in mk.ssd_step(*t)], 1),
        lambda lo, hi: _ssd_rows(a, lo, hi),
        sizes=tuple(b for b in BATCH_LAW if b <= a[0].shape[0])),
        f"{what}: a row depends on its batch")


def phase_ssd_step_vs_plain():
    """M1 against its plain versions on the card in bf16 and f32 at each
    instance (hd, ns) -- (64, 64), zamba2-1.2b's, and (16, 16), its small
    config's -- with 64 heads at B 1 / 4 / 8 / 16 on random inputs
    (:func:`_ssd_step_case`: == its emulated order, the state == plain,
    the output within one ulp / 1e-5, in place), rows == alone at B 16; a
    shape without an instance, a bf16 state, a misaligned state and a
    strided row raise.  The served decode's own inputs are held the same
    way in :func:`phase_zamba_smoke_card_vs_cpu` (f32, (16, 16)) and
    :func:`phase_measure_zamba` (bf16, (64, 64))."""
    import torch
    from repro_torch.kernels.ssd import kernel as mk
    g = torch.Generator(device="cuda").manual_seed(35)
    for dtype in (torch.bfloat16, torch.float32):
        for hd, ns in mk.INSTANCES:
            errs = []
            for B in SSD_BATCHES:
                a = _ssd_inputs(g, B, SSD_HEADS, hd, ns, dtype)
                errs.append(_ssd_step_case(
                    a, f"M1 {dtype} ({hd}, {ns}) B {B}"))
            _ssd_rows_alone(a, f"M1 {dtype} ({hd}, {ns})")
            print(f"  M1 {dtype} (hd {hd}, ns {ns}) x {SSD_HEADS} heads, B "
                  f"{SSD_BATCHES}: output max_abs_err {max(errs):.3g}; == "
                  "its emulated order, state == plain, in place == fresh, "
                  f"rows of B {BATCH_LAW} == alone")
    a = _ssd_inputs(g, 2, 4, 64, 64, torch.bfloat16)
    n = a[8].numel()
    odd = torch.empty(n + 1, device="cuda")[1:].view(a[8].shape)
    strided = torch.empty((2, 512), device="cuda",
                          dtype=torch.bfloat16)[:, ::2]
    for args, err, why in (
            (_ssd_inputs(g, 2, 4, 32, 32, torch.bfloat16), ValueError,
             "(32, 32)"),
            (_ssd_inputs(g, 2, 4, 64, 16, torch.bfloat16), ValueError,
             "(64, 16)"),
            (a[:8] + (a[8].bfloat16(),), TypeError, "a bf16 state"),
            (a[:8] + (odd.copy_(a[8]),), ValueError, "a misaligned state"),
            ((strided,) + a[1:], ValueError, "a strided row")):
        try:
            mk.ssd_step(*args)
        except err:
            continue
        check(False, f"M1 took {why}")
    print("  M1 refuses (hd, ns) (32, 32) and (64, 16), a bf16 state, a "
          "misaligned state and a strided row")


def phase_zamba_smoke_card_vs_cpu():
    """zamba2-1.2b SMOKE in f32 at ``shared_attn_every`` 1 and 2: prefill
    logits on the card agree with the CPU within 1e-4, chunked, through K3
    (``impl="kernel"``) and through K4s (local_global, tiles and window 8)
    on the shared block, which runs every repeat in prefill (its cache is
    collected each repeat; the residual takes it on fire steps); then one
    decode step from the chunked prefill's caches (:func:`decode_counts`:
    M1 once a mamba layer, D1 once a firing, R1 once a decode norm) within
    1e-4; M1's first call of that step (the prologue's layer, f32 at (16,
    16)) held by :func:`_ssd_step_case` and rows == alone.  Those caches stay f32 (``cache_dtype``): two prefills that round
    to bf16 on their own would turn the devices' f32 differences (sums in
    other orders) into whole bf16 ulps of the SSM state wherever a value
    sits near a rounding boundary.  So the default bf16 caches are checked
    from one prefill on the CPU whose cache is copied to the card: both
    decode one step, within 1e-4, from the same bf16-rounded SSM state and
    conv carry, which the step widens (``model.to_decode_dtypes``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core.masks import AttnMaskSpec
    from repro_torch.models import model as M
    for every in (1, 2):
        cfg = dataclasses.replace(get_smoke(ZAMBA_ARCH), policy="f32",
                                  shared_attn_every=every)
        cpu = M.init_params(cfg, seed=0, device="cpu")
        gpu = _tree_to(cpu, "cuda")
        prompts = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 24)))
        mask = AttnMaskSpec(pattern="local_global", window=8, bq=8, bk=8,
                            impl="sparse")
        errs = {}
        for label, kw, kernel in (
                ("chunked", {}, None),
                ("attn_mask sparse", {"attn_mask": mask},
                 "flash_attention_sparse"),
                ("impl=kernel", {"impl": "kernel"}, "flash_attention")):
            want, c_cpu, pos = M.prefill_layered(
                cpu, prompts, cfg, max_seq=32, cache_dtype=torch.float32,
                **kw)
            reset_launches()
            got, c_gpu, _ = M.prefill_layered(
                gpu, prompts.cuda(), cfg, max_seq=32,
                cache_dtype=torch.float32, **kw)
            launches = read_launches()
            errs[label] = (got.cpu() - want).abs().max().item()
            check(bool(torch.isfinite(got).all()) and errs[label] <= 1e-4,
                  f"{cfg.name} every {every} prefill ({label}): card and "
                  f"cpu disagree: {errs[label]}")
            check(launches == only(**({kernel: cfg.n_repeats} if kernel
                                       else {})),
                  f"{cfg.name} every {every} prefill ({label}): launches "
                  f"{launches}")
            if kernel is None:
                caches = (c_cpu, c_gpu, pos, want)
        c_cpu, c_gpu, pos, want = caches
        tok = want[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
        _, c_bf16, _ = M.prefill_layered(cpu, prompts, cfg, max_seq=32)
        errs1 = {}
        for label, c_cpu, c_gpu in (("f32 caches", c_cpu, c_gpu),
                                    ("bf16 caches", c_bf16,
                                     _tree_to(c_bf16, "cuda"))):
            want1, _ = M.decode_step_layered(cpu, cfg, c_cpu, pos, tok)
            reset_launches()
            with keep_ssd_step() as m1_call:
                got1, _ = M.decode_step_layered(gpu, cfg, c_gpu, pos,
                                                tok.cuda())
            launches1 = read_launches()
            what = f"M1 at {cfg.name} every {every} decode ({label})"
            m1_err = _ssd_step_case(m1_call.args, what)
            _ssd_rows_alone(m1_call.args, what)
            check(launches1 == decode_counts(cfg, 0, 1),
                  f"{cfg.name} every {every} decode ({label}) launches "
                  f"{launches1}")
            errs1[label] = (got1.cpu() - want1).abs().max().item()
            check(bool(torch.isfinite(got1).all()) and errs1[label] <= 1e-4,
                  f"{cfg.name} every {every} decode ({label}): card and cpu "
                  f"disagree: {errs1[label]}")
        print(f"  {cfg.name} f32 shared_attn_every {every} card vs cpu: "
              "prefill logits max_abs_err " + ", ".join(
                  f"{k} {v:.3g}" for k, v in errs.items())
              + "; decode step " + ", ".join(
                  f"{k} {v:.3g}" for k, v in errs1.items())
              + f" (M1 x {launches1['ssd_step']}, "
              f"D1 x {launches1['decode_attention']}, R1 x "
              f"{launches1['router_logits']}); M1 on its first call's "
              f"inputs == its order, rows == alone, output max_abs_err "
              f"{m1_err:.3g}")


class keep_ssd_step:
    """While on, the first call of ``kernels.ssd.ops.ssd_step`` (the first
    mamba layer of a decode step, the prologue's) keeps a copy of its
    arguments in ``self.args``, each with its own strides (the rows as
    they lie in the conv output and the projection), the state taken
    before the step writes it in place; calls made while a CUDA graph is
    being captured are not kept.  Every call goes on as before and the
    launch counts are untouched."""

    def __enter__(self):
        import torch
        from repro_torch.kernels.ssd import ops as sops
        self.args, self.entry = None, sops.ssd_step

        def copy(t):
            return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                       device=t.device).copy_(t)

        def kept(*a, **kw):
            if self.args is None and \
                    not torch.cuda.is_current_stream_capturing():
                self.args = tuple(copy(t) for t in a)
            return self.entry(*a, **kw)

        sops.ssd_step = kept
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.ssd import ops as sops
        sops.ssd_step = self.entry
        return False


def phase_zamba_serving(card):
    """zamba2-1.2b served on the card at full width and depth (``CONFIG``:
    38 Mamba-2 layers, the shared block at its 6 sites), random bf16
    weights from a seed.  ``ServeLoop`` serves BATCH prompts of
    ZAMBA_PROMPT tokens (chunked prefill, the SSD chunk 256) and ZAMBA_GEN
    greedy tokens, fused (the default: the decode step one replayed CUDA
    graph) and layered (``two_phase=True``): the same tokens and first
    decode step logits ``torch.equal``; M1 once a mamba layer, D1 once a
    shared-block firing and R1 once a decode norm a decode step (38, 6 and
    89), nothing in the chunked prefill, no plain version on the card; one
    fused and one layered decode step traced.  The masked prefill
    (``local_global``) through K4s and K4m on the shared block, sparse ==
    dense tokens; the kernel prefill (K3 once a repeat), timed; one mamba
    layer's chunked prefill timed alone; then the scheduler
    (:func:`phase_dense_scheduler`: 8 of 8 alone, wide and int8 KV).  The
    weights are freed before it returns.  Returns (summary, the shared
    block's first q, k, v of the kernel prefill, the layered run's first
    D1 call, its first M1 call, the launches of each kernel's run)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.masks import AttnMaskSpec
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.serve import ServeLoop
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2
    from repro_torch.models import model as M
    t_phase = time.monotonic()
    cfg = get_config(ZAMBA_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    gb = sum(t.numel() * t.element_size() for t in _tensors(params)) / 1e9
    d_in = cfg.ssm_expand * cfg.d_model
    print(f"{ZAMBA_ARCH} serving: d={cfg.d_model} mamba layers "
          f"{cfg.n_prologue} + {cfg.n_repeats} x {len(cfg.block_unit)} "
          f"(d_in {d_in}, {d_in // cfg.ssm_head_dim} SSM heads of "
          f"{cfg.ssm_head_dim}, state {cfg.ssm_state}), shared attention "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd} every "
          f"{cfg.shared_attn_every} repeat, d_ff={cfg.d_ff} vocab="
          f"{cfg.vocab_size}; params {gb:.2f} GB, init {init_s:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(5)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, ZAMBA_PROMPT),
                            generator=g, device="cuda")
    max_seq = ZAMBA_PROMPT + ZAMBA_GEN
    loop = ServeLoop(params, cfg, max_seq=max_seq)
    check(not loop.two_phase, f"{ZAMBA_ARCH}'s default loop is not fused")
    loop.run(prompts, 2)                      # warm-up: allocator, capture
    capture0 = loop.summary()["capture"]
    reset_launches()
    with no_plain():                          # the main path
        tokens, fused_logits = first_step_logits(loop, prompts, ZAMBA_GEN)
    counts = read_launches()
    want = decode_counts(cfg, 1, ZAMBA_GEN - 1)
    check(counts == want, f"{ZAMBA_ARCH} fused: launches {counts} != "
                          f"{want}")
    per_step = step_counts(cfg)
    check(loop.fused_step.launches == per_step, f"a {ZAMBA_ARCH} replay "
          f"launches {loop.fused_step.launches}, not {per_step}")
    check(tokens.shape == (BATCH, ZAMBA_GEN) and (tokens >= 0).all()
          and (tokens < cfg.vocab_size).all(), f"{ZAMBA_ARCH}: bad tokens")
    check(bool(torch.isfinite(fused_logits).all()),
          f"{ZAMBA_ARCH}: first decode step logits not finite")
    rows = [fused_numbers("fused", loop.summary(), capture0, counts)]
    layered = ServeLoop(params, cfg, max_seq=max_seq, two_phase=True)
    layered.run(prompts, 2)                   # warm-up
    calls = {}

    def keep(name, a, kw):
        if name == "decode_attention" and not calls:
            calls["first"] = (tuple(t.clone() for t in a[:3]), dict(kw))

    reset_launches()
    with no_plain(), hook_calls(keep), keep_ssd_step() as m1_call:
        got, layered_logits = first_step_logits(layered, prompts,
                                                 ZAMBA_GEN)
    counts_l = read_launches()
    check(counts_l == want, f"{ZAMBA_ARCH} layered: launches {counts_l}")
    check(np.array_equal(got, tokens),
          f"{ZAMBA_ARCH}: layered tokens != fused")
    check(torch.equal(layered_logits, fused_logits),
          f"{ZAMBA_ARCH}: first decode step logits, layered != fused (max "
          f"diff {(layered_logits - fused_logits).abs().max().item()})")
    rows.append(fused_numbers("layered", layered.summary(),
                              {"calls": 0, "ms": 0.0}, counts_l))
    for row in rows:
        print_fused(row)
    print(f"  layered tokens == fused tokens, first decode step logits "
          f"torch.equal; a replay launches {per_step}; tokens "
          f"{tokens[0, :8].tolist()} ...; first decode step's D1 kv_len "
          f"{calls['first'][1]['kv_len']}")
    traces = [trace_decode(f"{ZAMBA_ARCH}, layered eager", layered,
                           prompts),
              trace_decode(f"{ZAMBA_ARCH}, fused replayed", loop, prompts)]
    print(f"  {ZAMBA_ARCH} fused step: {traces[1]['kernels']} kernels, "
          f"{per_step['ssd_step']} of them M1 (a mamba layer's step from the "
          "conv's output to the gated norm's input, one kernel each)")
    del layered
    launches = {"decode_attention": counts["decode_attention"],
                "ssd_step": counts["ssd_step"]}
    spec, mask = serving_mask(cfg, ZAMBA_PROMPT)
    masked = {}
    for impl, kern in (("sparse", "flash_attention_sparse"),
                       ("dense", "flash_attention_masked")):
        loop.attn_mask = AttnMaskSpec(**spec, impl=impl)
        fops.reset_fallbacks()
        reset_launches()
        with no_plain():
            toks = loop.run(prompts, ZAMBA_MASK_GEN)
        c = read_launches()
        want_m = decode_counts(cfg, 1, ZAMBA_MASK_GEN - 1,
                               **{kern: cfg.n_repeats})
        check(c == want_m, f"{ZAMBA_ARCH} masked {impl}: launches {c} != "
                           f"{want_m}")
        check(fops.fallback_count() == 0,
              f"{ZAMBA_ARCH} masked {impl}: fell back")
        launches[kern] = c[kern]
        masked[impl] = {
            "tokens": toks,
            "prefill_ms": loop.summary()["prefill"]["seconds"] * 1e3}
    check(np.array_equal(masked["sparse"]["tokens"],
                         masked["dense"]["tokens"]),
          f"{ZAMBA_ARCH} local_global: sparse tokens != dense tokens")
    loop.attn_mask = None
    print(f"  local_global on the shared block (window {MASK_WINDOW} + the "
          f"first tile, {mask.nnzb} of {mask.n_q_tiles * mask.n_kv_tiles} "
          f"tiles): sparse == dense tokens; prefill "
          f"{masked['sparse']['prefill_ms']:.1f} ms (K4s), "
          f"{masked['dense']['prefill_ms']:.1f} ms (K4m)")
    del loop
    qkv = {}

    def keep_qkv(name, a, kw):
        if name == "attention" and not qkv and kw.get("mask") is None:
            qkv["first"] = tuple(t.contiguous().clone() for t in a[:3])

    reset_launches()
    t0 = time.monotonic()
    with hook_calls(keep_qkv):
        logits, _, _ = M.prefill(params, prompts, cfg, max_seq=max_seq,
                                 impl="kernel")
        torch.cuda.synchronize()
    kernel_ms = (time.monotonic() - t0) * 1e3
    c = read_launches()
    check(c == only(flash_attention=cfg.n_repeats),
          f"{ZAMBA_ARCH} kernel prefill: launches {c}")
    check(bool(torch.isfinite(logits).all()),
          f"{ZAMBA_ARCH} K3 prefill: logits")
    launches["flash_attention"] = c["flash_attention"]
    k3_first = logits[:, -1, :cfg.vocab_size].argmax(-1).cpu().numpy()
    print(f"  kernel prefill (K3 x {cfg.n_repeats}) {kernel_ms:.1f} ms; "
          f"first tokens {np.mean(k3_first == tokens[:, 0]):.2f} equal to "
          "the chunked prefill's (information)")
    del logits
    # one mamba layer's prefill at 4 x ZAMBA_PROMPT alone: the mixer, and
    # the chunked SSD inside it
    p0 = M._take(params["prologue"], 0)
    h = L.rmsnorm(p0["ln"], params["embed"][prompts], cfg.norm_eps)
    layer_ms = time_ms(lambda: mamba2.apply_mamba(p0["mixer"], h, cfg), 3,
                       1)
    nh, hd, ns = d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
    xs = torch.randn((BATCH, ZAMBA_PROMPT, nh, hd), generator=g,
                     device="cuda")
    a_log = -torch.rand((BATCH, ZAMBA_PROMPT, nh), generator=g,
                        device="cuda") * 0.1
    bc = [torch.randn((BATCH, ZAMBA_PROMPT, ns), generator=g, device="cuda")
          for _ in range(2)]
    ssd_ms = time_ms(lambda: mamba2.ssd_chunked(xs, a_log, *bc,
                                                chunk=mamba2.CHUNK), 3, 1)
    del h, xs, a_log, bc
    print(f"  one mamba layer's prefill at {BATCH} x {ZAMBA_PROMPT}: "
          f"{layer_ms:.2f} ms (chunked SSD alone, chunk {mamba2.CHUNK}: "
          f"{ssd_ms:.2f} ms)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sched = phase_dense_scheduler(cfg, params)
    sched_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.monotonic() - t_phase
    info = {"arch": ZAMBA_ARCH, "depth": cfg.n_layers,
            "shared_sites": step_layers(cfg).count("shared_attn"),
            "batch": BATCH, "prompt": ZAMBA_PROMPT, "gen": ZAMBA_GEN,
            "params_gb": gb, "init_s": init_s, "runs": rows,
            "traces": traces,
            "masked": {k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
                       for k, v in masked.items()},
            "kernel_prefill_ms": kernel_ms,
            "mamba_layer_prefill_ms": layer_ms,
            "ssd_chunked_prefill_ms": ssd_ms, "peak_gb": peak_gb,
            "scheduler": sched, "scheduler_peak_gb": sched_peak_gb,
            "wall_s": wall, "card": card}
    print(f"  {ZAMBA_ARCH} phase: peak {peak_gb:.1f} GB (serving), "
          f"{sched_peak_gb:.1f} GB (with the scheduler); {wall:.1f} s")
    return info, qkv["first"], calls["first"], m1_call.args, launches


def _ssd_step_times(a, what: str) -> dict:
    """M1 on ``a``, a whole step's arguments, as the model runs it:
    :func:`_ssd_step_case`'s checks, the kernel's time in place (on a copy
    of h0, as the decode step writes its cache) back to back and from a
    CUDA graph, the plain segment's (``ref.mamba_step_plain``: the
    softplus, exp and cast passes, ``torch.einsum``, the skip and the gate)
    the same two ways, and the bound: the state read and written once, xs,
    z, B, C, dt and the layer's vectors read once and the output written
    once, at 3.35 TB/s (its ~5 B nh hd ns operations take ~1 % of that at
    the f32 peak).  No single PyTorch call computes the step:
    ``library_ms`` is None."""
    from repro_torch.kernels.ssd import kernel as mk
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.kernels.ssd import ref
    err = _ssd_step_case(a, f"M1 at {what}")
    st = a[8].clone()
    run = lambda: mk.ssd_step(*a[:8], st, out=st)  # noqa: E731
    plain = lambda: ref.mamba_step_plain(*a)  # noqa: E731
    ms, plain_ms = time_ms(run, 50), time_ms(plain, 50)
    graph = {"ms": graph_ms(run), "plain_ms": graph_ms(plain)}
    B, nh, hd, ns = a[8].shape
    bytes_ms = sops.state_bytes(B, nh, hd, ns, a[0].element_size()) \
        / HBM_BYTES_PER_S * 1e3
    ops_ms = (5 * B * nh * hd * ns + 12 * B * nh * hd) / F32_FLOP_PER_S * 1e3
    print(f"  M1 {what} (B {B} x {nh} heads, ({hd}, {ns}), "
          f"{a[0].dtype}): {ms:.4f} ms (graph {graph['ms']:.4f}; bound "
          f"{max(bytes_ms, ops_ms):.5f}; plain segment {plain_ms:.4f}, graph "
          f"{graph['plain_ms']:.4f}), output max_abs_err {err:.3g}; == its "
          "emulated order, state == plain")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "graph": graph,
            "shape": {"B": B, "nh": nh, "hd": hd, "ns": ns,
                      "dtype": str(a[0].dtype)}}


def phase_measure_zamba(qkv, d1_call, m1_args, launches, card) -> list:
    """zamba2-1.2b's rows at its served shapes: K3, K4m and K4s at the
    shared block's first q, k, v of the kernel prefill (32/32 heads of 64,
    :func:`phase_measure_attention`: each against its plain version first);
    D1 at the layered run's first decode step's call (a group of 1), row 0
    alone (B 1) and the rows twice (B 8) beside; M1 at the same step's
    first call (the prologue's layer 0 on the state its prefill left: ==
    its emulated order, the state == plain, rows == alone), B 1 and the
    rows twice (the scheduler's bucket 8) beside."""
    import torch
    q = qkv[0]
    S, D = q.shape[2], q.shape[3]
    tag = f" D{D} {ZAMBA_ARCH}"
    _, mask = serving_mask(types.SimpleNamespace(hd=D), S)
    rows = phase_measure_attention(qkv, mask, launches, card, suffix=tag)
    (q1, k1, v1), kw = d1_call
    d1 = _decode_times(d1_call, f"{ZAMBA_ARCH} 4 x {S}, first step")
    beside = {
        "b1_call": _decode_times(((q1[:1], k1[:1], v1[:1]), kw),
                                 f"{ZAMBA_ARCH}, row 0 alone (B 1)"),
        "b8_call": _decode_times(((q1.repeat(2, 1, 1, 1).contiguous(),
                                   k1.repeat(2, 1, 1, 1).contiguous(),
                                   v1.repeat(2, 1, 1, 1).contiguous()), kw),
                                 f"{ZAMBA_ARCH}, rows twice (B 8)")}
    rows.append({"name": f"decode_attention D{D} {ZAMBA_ARCH} group 1",
                 "route": "cuda",
                 "source": "src/repro_torch/kernels/flash_attention/csrc/"
                           "decode_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention/ops.py:212 "
                             "(array code, no Pallas kernel)",
                 "launches": launches["decode_attention"], **d1, **beside,
                 "card": card})
    a = m1_args
    _ssd_rows_alone(a, "M1 at the served decode step")
    m1 = _ssd_step_times(a, f"{ZAMBA_ARCH} 4 x {S}, first decode step, "
                            "prologue layer 0")
    one = _ssd_step_times(_ssd_rows(a, 0, 1), "its row 0 alone (B 1)")
    eight = _ssd_step_times(_ssd_twice(a), "its rows twice (bucket 8)")
    rows.append({"name": "ssd_step", "route": "cuda",
                 "source": "src/repro_torch/kernels/ssd/csrc/ssd_step.cu",
                 "replaces": SSD_SRC, "launches": launches["ssd_step"],
                 **m1, "b1_call": one, "bucket8_call": eight,
                 "card": card})
    return rows


# ------------------------------------------------------------ training --

TRAIN_ARCH = "qwen3-1.7b"
# card vs CPU at SMOKE (f32): R1's backward (scout's MoE), K7's (RWKV-6)
TRAIN_SMOKE_ARCHS = (TRAIN_ARCH, SCOUT_ARCH, RWKV_ARCH)
TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ, TRAIN_SMOKE_CHUNK = 2, 64, 16
TRAIN_SMOKE_STEPS = 4
# card vs CPU: step 1's loss within 1e-4 and every gradient leaf within
# 1e-3 of its largest |grad| (the card sums in other orders, K7 to 2e-5 of
# its largest value); the later losses within 1e-3 (Adam moves a weight by
# about lr times the sign of its gradient, so a near-0 gradient element
# can move on one side and not the other)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_LATER_TOL = 1e-4, 1e-3, 1e-3
# qwen3-1.7b at full width and depth, f32 params: 4 x 2048 tokens from
# SyntheticLM(seed=0), the cross-entropy 512 positions at a time
TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ_CHUNK = 4, 2048, 512
TRAIN_STEPS, TRAIN_SHARDED_STEPS, TRAIN_LR = 16, 4, 1e-3
# kernel_sharded (K3 forward) vs chunked, bf16: first-step losses within
# this (the two attention forwards round their bf16 outputs differently)
TRAIN_SHARDED_TOL = 2e-2
TRAIN_RESTART_STEPS, TRAIN_CRASHES = 12, (5, 9)
TRAIN_TOP = 8                    # kernels named in the traced step


class keep_first_calls(hook_calls):
    """While on, the first call of R1 from ``models.moe``, of
    ``wkv.ops.wkv_state`` from ``models.rwkv6`` and of the prefill
    attention from ``flash_attention.ops`` (K3 under kernel_sharded) keep
    contiguous detached copies of their tensor arguments in
    ``self.args[name]``; every call goes on as before and the launch
    counts are untouched."""

    def __init__(self):
        super().__init__(self._keep_first)
        self.args = {}

    def targets(self) -> list:
        from repro_torch.kernels.flash_attention import ops as fops
        from repro_torch.kernels.wkv import ops as wops
        from repro_torch.models import moe
        return [(moe, "router_logits"), (wops, "wkv_state"),
                (fops, "attention")]

    def _keep_first(self, name, args, kw):
        if name not in self.args:
            self.args[name] = ([x.detach().contiguous().clone()
                                if hasattr(x, "detach") else x
                                for x in args], dict(kw))


def _grad_err(got, want) -> float:
    """The largest, over the leaves, of |got - want| over the leaf's
    largest |want|."""
    from repro_torch import tree
    worst = 0.0
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        big = b.float().abs().max().item()
        diff = (a.float().cpu() - b.float()).abs().max().item()
        worst = max(worst, diff / big if big else diff)
    return worst


def _train_smoke(arch: str, keep) -> dict:
    """``arch``'s SMOKE config in f32 trained on the card and on the CPU
    from the same params (drawn on the CPU, copied to the card): step 1's
    loss and every gradient leaf, then TRAIN_SMOKE_STEPS steps of
    ``make_train_step`` on the same ``SyntheticLM`` batches; the kernels a
    card step launches (R1 and K7 in the forward and again in the remat
    recompute) counted, no plain router or WKV step on the card."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamW
    cfg = dataclasses.replace(get_smoke(arch), policy="f32")
    cpu = M.init_params(cfg, seed=0, device="cpu",
                        param_dtype=torch.float32)
    gpu = _tree_to(cpu, "cuda")
    data = SyntheticLM(cfg, batch=TRAIN_SMOKE_BATCH,
                       seq_len=TRAIN_SMOKE_SEQ, seed=0)
    tok = torch.from_numpy(data.batch_at(0)["tokens"])
    loss_of = lambda t: lambda p: M.loss_fn(  # noqa: E731
        p, t, cfg, seq_chunk=TRAIN_SMOKE_CHUNK)
    lc, gc_ = steps.value_and_grad(loss_of(tok), cpu)
    with no_plain(), keep:
        reset_launches()
        lg, gg = steps.value_and_grad(loss_of(tok.cuda()), gpu)
        launches = read_launches()
    n_moe = cfg.n_repeats * cfg.block_unit.count("attn+moe")
    n_rwkv = cfg.n_repeats * cfg.block_unit.count("rwkv")
    want = only(router_logits=2 * n_moe, wkv_kernel=2 * n_rwkv)
    check(launches == want, f"train {arch} smoke: launches {launches}, "
                            f"want {want}")
    loss_err = abs(lg.item() - lc.item())
    grad_err = _grad_err(gg, gc_)
    check(loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL,
          f"train {arch} smoke: card vs cpu loss {loss_err}, grads "
          f"{grad_err}")
    shape = ShapeSpec("smoke", "train", TRAIN_SMOKE_SEQ, TRAIN_SMOKE_BATCH)
    runs = {}
    for side, params in (("cpu", cpu), ("card", gpu)):
        opt = AdamW(lr=1e-3)
        step = steps.make_train_step(cfg, shape, opt,
                                     seq_chunk=TRAIN_SMOKE_CHUNK)
        state, losses = opt.init(params), []
        with no_plain():
            for i in range(TRAIN_SMOKE_STEPS):
                params, state, m = step(params, state,
                                        data.batch_at(i)["tokens"])
                losses.append(float(m["loss"]))
        runs[side] = losses
    later = max(abs(a - b) for a, b in zip(runs["card"], runs["cpu"]))
    check(all(np.isfinite(runs["card"])) and later <= TRAIN_LATER_TOL,
          f"train {arch} smoke: card losses {runs['card']} vs cpu "
          f"{runs['cpu']}")
    print(f"  train {arch} smoke f32 card vs cpu: loss {lg.item():.6f} "
          f"(err {loss_err:.3g}), grads {grad_err:.3g} of a leaf's largest, "
          f"{TRAIN_SMOKE_STEPS} steps {[round(x, 5) for x in runs['card']]}"
          f" (largest err {later:.3g}); R1 x {launches['router_logits']}, "
          f"K7 x {launches['wkv_kernel']} a step")
    return {"loss_err": loss_err, "grad_err": grad_err,
            "losses": runs["card"], "cpu_losses": runs["cpu"],
            "loss_err_steps": later, "launches": {
                k: v for k, v in launches.items() if v}}


def train_model_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """A train step's model flops: 6 x params x tokens (every parameter,
    the embedding table's too) plus causal attention's score and value
    products, forward and backward: 6 B H S^2 D a layer."""
    attn = 6 * batch * cfg.n_heads * seq * seq * cfg.hd * cfg.n_layers
    return 6 * n_params * batch * seq + attn


def _train_full(impl: str, n_steps: int, trace: bool) -> dict:
    """qwen3-1.7b at full width and depth from ``init_params(seed=0)`` in
    f32 (the same start for each ``impl``): ``n_steps`` steps of
    ``make_train_step`` (AdamW at TRAIN_LR, remat a layer, cross-entropy
    TRAIN_SEQ_CHUNK positions at a time) on ``SyntheticLM(seed=0)``
    batches put on the card by the ``Prefetcher``; each step's loss, ms
    (host clock from a synchronize to ``float(loss)``) and launches; with
    ``trace`` one more step traced (:func:`trace_step`)."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import Prefetcher, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamW
    cfg = get_config(TRAIN_ARCH)
    params = M.init_params(cfg, seed=0, device="cuda",
                           param_dtype=torch.float32)
    n_params = sum(t.numel() for t in tree.leaves(params))
    opt = AdamW(lr=TRAIN_LR)
    state = opt.init(params)
    step = steps.make_train_step(
        cfg, ShapeSpec("train", "train", TRAIN_SEQ, TRAIN_BATCH), opt,
        seq_chunk=TRAIN_SEQ_CHUNK, attn_impl=impl)
    data = SyntheticLM(cfg, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=0)
    pf = Prefetcher(data.stream(0), depth=2, device="cuda")
    out = {"losses": [], "ms": [], "launches": [], "grad_norms": []}
    try:
        for _ in range(n_steps):
            batch = next(pf)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.monotonic()
            params, state, m = step(params, state, batch["tokens"])
            out["losses"].append(float(m["loss"]))
            out["ms"].append((time.monotonic() - t0) * 1e3)
            out["launches"].append(read_launches())
            out["grad_norms"].append(float(m["grad_norm"]))
        if trace:           # the last batch's step again, its result unused
            out["trace"] = trace_step(
                f"train {TRAIN_ARCH} {impl} step", lambda: None,
                lambda: step(params, state, batch["tokens"]), top=TRAIN_TOP)
    finally:
        pf.close()
    del params, state, step
    out["n_params"] = n_params
    out["cfg"] = cfg
    return out


def _train_restart() -> dict:
    """qwen3-1.7b SMOKE (f32) on the card through ``runtime.trainer``:
    an uninterrupted TRAIN_RESTART_STEPS-step run, then one with failures
    injected at TRAIN_CRASHES under ``run_with_restarts``, each restart
    restoring the last checkpoint (every 4 steps, under ``build/``); the
    stitched loss history must equal the uninterrupted one."""
    import shutil
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.trainer import (SimulatedFailure, Trainer,
                                             TrainerConfig,
                                             run_with_restarts)
    cfg = dataclasses.replace(get_smoke(TRAIN_ARCH), policy="f32")
    root = os.path.join(ROOT, "build", "chip_train_ckpt")
    shutil.rmtree(root, ignore_errors=True)

    def make(sub, hook=None):
        opt = AdamW(lr=1e-3)
        step = steps.make_train_step(
            cfg, ShapeSpec("smoke", "train", 16, 2), opt, seq_chunk=8)
        return Trainer(
            TrainerConfig(total_steps=TRAIN_RESTART_STEPS, ckpt_every=4,
                          ckpt_dir=os.path.join(root, sub), log_every=1000),
            cfg, step, opt, SyntheticLM(cfg, batch=2, seq_len=16, seed=0),
            init_state=lambda: M.init_params(cfg, seed=0, device="cuda",
                                             param_dtype=torch.float32),
            failure_hook=hook)

    clean = dict(make("clean").run()["history"])
    crashes = set(TRAIN_CRASHES)

    def hook(s):
        if s in crashes:
            crashes.discard(s)
            raise SimulatedFailure(f"injected at step {s}")

    trainers = []
    out = run_with_restarts(lambda: trainers.append(make("ft", hook))
                            or trainers[-1])
    stitched = {}
    for t in trainers:
        stitched.update(dict(t.history))
    same = stitched == clean
    check(out["restarts"] == len(TRAIN_CRASHES) and same,
          f"train restart: {out['restarts']} restarts, stitched {stitched} "
          f"vs {clean}")
    shutil.rmtree(root, ignore_errors=True)
    print(f"  train restart on the card: {out['restarts']} failures, "
          f"resumed at {[t.history[0][0] for t in trainers]}, the stitched "
          f"{len(stitched)} losses == the uninterrupted run's")
    return {"restarts": out["restarts"], "identical": same,
            "resumed_at": [t.history[0][0] for t in trainers]}


def phase_train(card):
    """Training: the SMOKE configs card vs CPU (:func:`_train_smoke`),
    qwen3-1.7b at full width and depth, chunked for TRAIN_STEPS steps and
    kernel_sharded for TRAIN_SHARDED_STEPS from the same start
    (:func:`_train_full`), the restart on the card (:func:`_train_restart`),
    then the rows of K3, R1 and K7 on the calls the train steps made.
    Returns (the summary, the rows)."""
    import numpy as np
    import torch
    t_start = time.monotonic()
    keep = keep_first_calls()
    smoke = {arch: _train_smoke(arch, keep) for arch in TRAIN_SMOKE_ARCHS}
    r1_args, wkv_args = keep.args["router_logits"], keep.args["wkv_state"]
    smoke_s = time.monotonic() - t_start
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    keep = keep_first_calls()
    for impl, n in (("chunked", TRAIN_STEPS),
                    ("kernel_sharded", TRAIN_SHARDED_STEPS)):
        with keep:
            runs[impl] = _train_full(impl, n, trace=impl == "chunked")
        gc.collect()
        torch.cuda.empty_cache()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ch, ks = runs["chunked"], runs["kernel_sharded"]
    cfg, n_params = ch["cfg"], ch["n_params"]
    losses = ch["losses"]
    check(all(np.isfinite(losses)) and all(np.isfinite(ks["losses"])),
          f"train {TRAIN_ARCH}: a loss is not finite: {losses} {ks['losses']}")
    last4 = float(np.mean(losses[-4:]))
    check(last4 < losses[0], f"train {TRAIN_ARCH}: the last 4 steps' mean "
                             f"loss {last4} is not below step 1's "
                             f"{losses[0]}")
    sharded_err = abs(ks["losses"][0] - losses[0])
    check(sharded_err <= TRAIN_SHARDED_TOL,
          f"train {TRAIN_ARCH}: kernel_sharded's first loss "
          f"{ks['losses'][0]} vs chunked's {losses[0]}")
    k3 = [x["flash_attention"] for x in ks["launches"]]
    check(k3 == [2 * cfg.n_layers] * TRAIN_SHARDED_STEPS
          and all(x == only() for x in ch["launches"])
          and all(x == only(flash_attention=2 * cfg.n_layers)
                  for x in ks["launches"]),
          f"train {TRAIN_ARCH}: launches {ch['launches'][0]} (chunked), "
          f"{ks['launches'][0]} (kernel_sharded)")
    steady = float(np.median(ch["ms"][1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_model_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    share = flops / (steady * 1e-3) / BF16_FLOP_PER_S
    for impl, r in runs.items():
        print(f"  train {TRAIN_ARCH} {impl}: " + ", ".join(
            f"{loss:.4f} ({ms:.0f} ms)" for loss, ms in zip(r["losses"],
                                                            r["ms"])))
    ks_steady = float(np.median(ks["ms"][1:]))
    print(f"  train {TRAIN_ARCH} at full width and depth ({cfg.n_layers} "
          f"layers, {n_params / 1e9:.3f} B params in f32, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}): chunked step {steady:.1f} ms (median of steps "
          f"2-{TRAIN_STEPS}), {tokens / steady * 1e3:.0f} tokens/s, model "
          f"flops {flops:.4g} a step, {share:.4f} of the bf16 peak "
          f"({card}); kernel_sharded {ks_steady:.1f} ms, K3 x {k3[0]} a "
          f"step; first losses {losses[0]:.5f} / {ks['losses'][0]:.5f}, "
          f"grad norms {ch['grad_norms'][0]:.5f} / "
          f"{ks['grad_norms'][0]:.5f}; last 4 mean {last4:.4f}; peak "
          f"{peak_gb:.2f} GB")
    full_s = time.monotonic() - t_start - smoke_s
    restart = _train_restart()
    rows = []
    fa = keep.args["attention"][0][:3]
    from repro_torch.core.masks import BlockMask
    from repro_torch.kernels import tuning
    S, D = fa[0].shape[2], fa[0].shape[3]
    bq, bk = tuning.flash_tiles(S, S, D, fa[0].dtype, fa[0].device)
    rows += phase_measure_attention(
        fa, BlockMask.full(S, S, bq=bq, bk=bk, causal=True),
        {"flash_attention": k3[0] * TRAIN_SHARDED_STEPS}, card,
        suffix=f" (train {TRAIN_ARCH}, kernel_sharded)",
        names=("flash_attention",))
    r1 = _router_times(((r1_args[0][0], r1_args[0][1]), None),
                       f"train {SCOUT_ARCH} smoke")
    rows.append({"name": f"router_logits (train {SCOUT_ARCH} smoke)",
                 "route": "cuda",
                 "source": "src/repro_torch/kernels/router/csrc/router.cu",
                 "replaces": "src/repro/models/moe.py:232 (array code, no "
                             "Pallas kernel)",
                 "launches": smoke[SCOUT_ARCH]["launches"].get(
                     "router_logits", 0),
                 **r1, "card": card})
    (r, k, v, w, u), kw = wkv_args[0][:5], wkv_args[1]
    row = phase_measure_wkv(
        (r, k, v, w, u, kw["chunk"]),
        smoke[RWKV_ARCH]["launches"].get("wkv_kernel", 0), card)
    row["name"] = f"wkv_kernel (train {RWKV_ARCH} smoke)"
    rows.append(row)
    summary = {
        "smoke": smoke, "arch": TRAIN_ARCH, "layers": cfg.n_layers,
        "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "seq_chunk": TRAIN_SEQ_CHUNK, "lr": TRAIN_LR,
        "chunked": {"losses": losses, "ms": ch["ms"],
                    "grad_norm_1": ch["grad_norms"][0],
                    "step_ms": steady, "tokens_per_s": tokens / steady * 1e3,
                    "model_flops": flops, "bf16_peak_share": share,
                    "last4_mean": last4, "trace": ch.get("trace")},
        "kernel_sharded": {"losses": ks["losses"], "ms": ks["ms"],
                           "grad_norm_1": ks["grad_norms"][0],
                           "step_ms": ks_steady, "k3_per_step": k3[0],
                           "first_loss_err": sharded_err},
        "peak_gb": peak_gb, "restart": restart, "card": card,
        "seconds": {"smoke": smoke_s, "full": full_s,
                    "total": time.monotonic() - t_start}}
    print(f"  phase_train: {summary['seconds']['total']:.1f} s (smoke "
          f"{smoke_s:.1f}, full width {full_s:.1f})")
    return summary, rows


# ---------------------------------------------------------------------------
# The sharded engine: SHARDED_RANKS gloo ranks that share the one card.
# ---------------------------------------------------------------------------

SHARDED_RANKS = 4
SHARDED_TIMEOUT = 60.0      # the group's timeout: seconds a collective
SHARDED_LIMIT = 150.0       # the parent's wait for every rank
SHARDED_ITERS = 10
SHARDED_KERNELS = ("spmm_bcsr", "spmspm_ell", "flash_attention", "router")
SHARDED_SPMM_N = (512, 300)


def _bound(nbytes: float, ops: float, peak: float):
    """(bound ms, what bounds it): the bytes at the memory rate against the
    operations at ``peak``."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / peak * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _sharded_dispatch(quant: bool):
    """llama4-scout's 4 x 2,048 prefill dispatch stream (E 16, capacity
    factor 1.25, blocks (8, 8)) as the port's routing makes it from seeded
    uniform expert choices (``tools/compare_spmm.py``'s stream), against
    random bf16 tokens of width 5,120: one batch row a rank, wide (K2, bf16
    out, the serving tile) or BlockQuant int8 (K2q, f32 out)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import engine, tuning
    from repro_torch.kernels.spmm import ops as so
    from repro_torch.kernels.spmm.ref import spmm_bcsr_ref
    from tools.compare_spmm import (dispatch_stream, expert_choice,
                                    routed_slots)
    cfg = get_config(SCOUT_ARCH)
    d, bf16 = cfg.d_model, torch.bfloat16
    fs = routed_slots(expert_choice(np.random.default_rng(11), BATCH,
                                    ATTN_PROMPT, cfg.n_experts, False), cfg)
    a, _ = dispatch_stream(fs, cfg, bf16, "cuda")
    g = torch.Generator(device="cuda").manual_seed(40)
    x = torch.randn((BATCH, a.shape[2], d), generator=g,
                    device="cuda").to(bf16)
    kw = dict(bn=tuning.moe_dispatch_tiles(d, bf16, "cuda")["bn"],
              out_dtype=bf16)
    if quant:
        a, kw = a.quantize("int8"), dict(out_dtype=torch.float32)
    a_dense = a.todense().to(bf16)
    live = (a.blocks.float() != 0).flatten(2).any(-1)      # (B, nnzb)

    def cost(out, mesh):
        """Bytes and multiply-adds of this rank's call on ``mesh`` (the
        whole with None; ``out`` its output): its batch rows' blocks and
        tokens, the stream, the output; the live blocks' products."""
        n, i = engine.mesh_axis(mesh, "data")
        w = -(-BATCH // n)
        rows = slice(i * w, min((i + 1) * w, BATCH))
        nbytes = (_nbytes(a.blocks[rows], x[rows], out)
                  + 4 * (a.indptr.numel() + a.nnzb))
        if quant:
            nbytes += _nbytes(a.scales[rows])
        return nbytes, 2 * int(live[rows].sum()) * 64 * d

    return types.SimpleNamespace(
        kernel="spmm_bcsr_quant" if quant else "spmm_bcsr",
        source="src/repro_torch/kernels/spmm/csrc/spmm_bcsr.cu",
        replaces=LIB_SRC + ("spmm/kernel.py:68" if quant
                            else "spmm/kernel.py:74"),
        sharded=lambda mesh: engine.shard_spmm_batched_stream(
            a, x, mesh=mesh, **kw),
        part=lambda mesh: engine.spmm_batched_part(
            a, x, *engine.mesh_axis(mesh, "data"), **kw).run,
        one=lambda: engine.spmm_batched_stream(a, x, **kw),
        plain=lambda one: (one, spmm_bcsr_ref(
            a.indptr, a.block_cols, a.blocks, x, scales=a.scales,
            out_dtype=kw["out_dtype"])),
        exact=not quant, library=lambda: torch.bmm(a_dense, x), cost=cost,
        peak=BF16_FLOP_PER_S, mesh="data",
        shape={"B": BATCH, "M": a.shape[1], "K": a.shape[2], "N": d,
               "nnzb": a.nnzb, "block": list(a.block),
               "blocks": str(a.blocks.dtype)[6:],
               "out": str(kw["out_dtype"])[6:],
               "stats": so.stream_row_stats(a)})


def _sharded_spmm(dtype_name: str, N: int):
    """K2 on the library's banded 8192^2 BCSR (bandwidth 512, 8 x 8
    blocks: ``tools/compare_spmm.py``'s K2q matrix, wide) by an (8192, N)
    dense, f32 or bf16, N split over the ranks; f32 out.  The bound's
    operations at the peak of the operands' type (bf16: the tensor cores'
    rate)."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import engine
    from repro_torch.kernels.spmm import ops as so
    from repro_torch.kernels.spmm.ref import spmm_bcsr_ref
    dt = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(41)
    i = torch.arange(SPMM_N, device="cuda")
    band = (i[:, None] - i[None, :]).abs() <= SPMM_BAND
    am = torch.randn((SPMM_N, SPMM_N), generator=g, device="cuda") * band
    a = F.bcsr_from_dense(am.to(dt), SPMM_BLOCK)
    del am, band
    x = torch.randn((SPMM_N, N), generator=g, device="cuda").to(dt)
    a_dense = a.todense()

    def cost(out, mesh):
        cols = out.shape[1]
        return (_nbytes(a.blocks, out) + 4 * (a.indptr.numel() + a.nnzb)
                + SPMM_N * cols * x.element_size(),
                2 * a.nnzb * 64 * cols)

    return types.SimpleNamespace(
        kernel="spmm_bcsr",
        source="src/repro_torch/kernels/spmm/csrc/spmm_bcsr.cu",
        replaces=LIB_SRC + "spmm/kernel.py:74",
        sharded=lambda mesh: engine.shard_spmm(a, x, mesh=mesh),
        part=lambda mesh: engine.spmm_part(
            a, x, *engine.mesh_axis(mesh, "data")).run,
        one=lambda: so.spmm(a, x),
        plain=lambda one: (one, spmm_bcsr_ref(
            a.indptr, a.block_cols, a.blocks[None], x[None],
            out_dtype=torch.float32)[0]),
        exact=False, library=lambda: torch.matmul(a_dense, x), cost=cost,
        peak=BF16_FLOP_PER_S if dt == torch.bfloat16 else F32_FLOP_PER_S,
        mesh="data",
        shape={"M": SPMM_N, "K": SPMM_N, "N": N, "bandwidth": SPMM_BAND,
               "block": list(SPMM_BLOCK), "nnzb": a.nnzb,
               "dtype": dtype_name})


def _sharded_spmspm(quant: bool):
    """K5 on the library's SpMSpM (8192^2 A at 5 % by B at 1 %, ELL rows
    and columns; ``tools/compare_spmspm.py``'s shape), wide or with A's
    rows in fp8 e4m3 and ``a_scales``: B's columns split over the ranks."""
    import torch
    from repro_torch.core import precision as P
    from repro_torch.core.formats import INVALID_KEY
    from repro_torch.kernels import engine
    from repro_torch.kernels.spmspm import ops as po
    from repro_torch.kernels.spmspm import ref as pr
    g = torch.Generator(device="cuda").manual_seed(42)
    a = _sparse(g, (SPMSPM_N, SPMSPM_N), SPMSPM_DA)
    b = _sparse(g, (SPMSPM_N, SPMSPM_N), SPMSPM_DB)
    ak, av = po.dense_to_ell_rows(a)
    bk, bv = po.dense_to_ell_cols(b)
    kw = {}
    if quant:
        av, kw["a_scales"] = P.quantize_rows(av, "fp8_e4m3")
    a_csr = a.to_sparse_csr()
    del a, b
    band = slice(0, SPMSPM_BAND)
    na = torch.bincount(ak[ak != INVALID_KEY].long(), minlength=SPMSPM_N)

    def cost(out, mesh):
        """A's streams, this rank's stripe of B's columns on ``mesh`` (as
        wide as ``out``, pads included) and ``out``; the key matches."""
        i = engine.mesh_axis(mesh, "data")[1]
        w = out.shape[1]
        sub = bk[i * w:(i + 1) * w]
        nb = torch.bincount(sub[sub != INVALID_KEY].long(),
                            minlength=SPMSPM_N)
        return (8 * (ak.numel() + w * bk.shape[1]) + _nbytes(out),
                2 * int((na * nb).sum()))

    def library():
        b_csr = pr.ell_to_dense(bk, bv, SPMSPM_N).T.contiguous() \
            .to_sparse_csr()
        return torch.sparse.mm(a_csr, b_csr).to_dense()

    return types.SimpleNamespace(
        kernel="spmspm_ell",
        source="src/repro_torch/kernels/spmspm/csrc/spmspm_ell.cu",
        replaces=LIB_SRC + "spmspm/kernel.py:58",
        sharded=lambda mesh: engine.shard_spmspm(ak, av, bk, bv, mesh=mesh,
                                                 **kw),
        part=lambda mesh: engine.spmspm_part(
            ak, av, bk, bv, *engine.mesh_axis(mesh, "data"), **kw).run,
        one=lambda: po.spmspm(ak, av, bk, bv, **kw),
        plain=lambda one: (one[band], pr.spmspm_ell_ref(
            ak[band], av[band], bk, bv, a_scales=(
                kw["a_scales"][band] if quant else None))),
        exact=False, library=library, cost=cost, peak=F32_FLOP_PER_S,
        mesh="data",
        shape={"R": SPMSPM_N, "C": SPMSPM_N, "La": ak.shape[1],
               "Lb": bk.shape[1], "density_a": SPMSPM_DA,
               "density_b": SPMSPM_DB, "plain_rows": SPMSPM_BAND,
               "a_vals": str(av.dtype)[6:]})


def _scout_qkv(seed: int):
    """Random bf16 q, k, v at llama4-scout's prefill attention: B 4, 40 /
    8 heads of 128, S 2,048."""
    import torch
    cfg = served_config(SCOUT_ARCH)[0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = lambda h: (BATCH, h, ATTN_PROMPT, cfg.hd)  # noqa: E731
    return tuple(torch.randn(shape(h), generator=g, device="cuda")
                 .to(torch.bfloat16)
                 for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))


def _attention_cost(q, k, visible: int, out):
    """q, k, v and ``out`` moved once; 4 D flops a visible score entry."""
    return (_nbytes(q, k, k, out), 4 * q.shape[-1] * visible)


def _sharded_attention(kind: str):
    """K4s at llama4-scout's prefill (``_scout_qkv``) on a causal or a
    sliding-window (MASK_WINDOW) BlockMask at the card's flash tiles: the
    query axis split, 512 rows a rank."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.masks import BlockMask
    from repro_torch.kernels import engine, tuning
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    q, k, v = _scout_qkv(43)
    B, Hq, S, D = q.shape
    bq, bk = tuning.flash_tiles(S, S, D, q.dtype, "cuda")
    mask = (BlockMask.causal(S, S, bq=bq, bk=bk) if kind == "causal" else
            BlockMask.sliding_window(S, S, MASK_WINDOW, bq=bq, bk=bk))
    vis_rows = mask.dense_mask().sum(1)                  # visible keys a row
    dense = torch.as_tensor(mask.dense_mask(), device="cuda")
    st = mask.lower()
    g = Hq // k.shape[1]
    ke, ve = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)

    def cost(out, mesh):
        n, i = engine.mesh_axis(mesh, "data")
        rows = slice(i * (S // n), (i + 1) * (S // n))
        return _attention_cost(q[:, :, rows], k,
                               B * Hq * int(vis_rows[rows].sum()), out)

    return types.SimpleNamespace(
        kernel="flash_attention_sparse",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces=FLASH_SRC + ":297",
        sharded=lambda mesh: engine.shard_attention_sparse(q, k, v, mask,
                                                           mesh=mesh),
        part=lambda mesh: engine.attention_sparse_part(
            q, k, v, mask, *engine.mesh_axis(mesh, "data")).run,
        one=lambda: fops.attention(q, k, v, mask=mask, mask_impl="sparse",
                                   fallback="error"),
        plain=lambda one: (one, fref.flash_attention_sparse_ref(
            q, k, v, st.rows, st.cols, st.kinds, skv=S, window=mask.window,
            bq=bq, bk=bk)),
        exact=False,
        library=lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                       attn_mask=dense),
        cost=cost, peak=BF16_FLOP_PER_S, mesh="data",
        shape={"B": B, "Hq": Hq, "Hkv": k.shape[1], "S": S, "D": D,
               "tiles": [bq, bk], "mask": kind, "window": mask.window,
               "visible_tiles": mask.density()["nnzb"]})


def _sharded_flash():
    """K3 at llama4-scout's prefill (``_scout_qkv``), causal, under a (2,
    2) ("data", "model") mesh: q by batch over "data" and by sequence over
    "model" (``layers.sharded_flash_attention``), 1,024 rows a rank."""
    import torch.nn.functional as F
    from repro_torch.kernels import engine
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import layers
    q, k, v = _scout_qkv(44)
    B, Hq, S, D = q.shape
    bq, bk = fops.tiles(q, k)
    g = Hq // k.shape[1]
    ke, ve = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)

    def sharded(mesh):
        with mesh_context(mesh):
            return layers.sharded_flash_attention(q, k, v, causal=True)

    def cost(out, mesh):
        n_dp, _ = engine.mesh_axis(mesh, "data")
        n_tp, m = engine.mesh_axis(mesh, "model")
        s_loc, b = S // n_tp, B // n_dp
        lo = m * s_loc
        vis = (lo + s_loc) * (lo + s_loc + 1) // 2 - lo * (lo + 1) // 2
        return _attention_cost(q[:b, :, lo:lo + s_loc], k[:b],
                               b * Hq * vis, out)

    return types.SimpleNamespace(
        kernel="flash_attention",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces=FLASH_SRC + ":84", sharded=sharded,
        part=lambda mesh: layers.flash_part(q, k, v, mesh, causal=True),
        one=lambda: fops.attention(q, k, v, causal=True, fallback="error"),
        plain=lambda one: (one, fref.flash_attention_ref(
            q, k, v, causal=True, bq=bq, bk=bk)),
        exact=False,
        library=lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                       is_causal=True),
        cost=cost, peak=BF16_FLOP_PER_S, mesh="data_model",
        shape={"B": B, "Hq": Hq, "Hkv": k.shape[1], "S": S, "D": D,
               "tiles": [bq, bk], "mesh": {"data": 2, "model": 2}})


# the expert-parallel MoE at llama4-scout's width: x (B, S) global on the
# (2, 2) mesh, a (2, 1,024) block a rank; its tolerances against the
# one-device layer on each block, of the largest |value| of the output or of
# a gradient's part: bf16 products at another row count, bf16 sums of the
# gradients in other orders
MOE_X = (4, 2048)
MOE_SEED = 45
MOE_FWD_TOL = 2 ** -6
MOE_GRAD_TOL = 2 ** -5
# the sparse gradient exchange: a (2^24,) f32 gradient a rank, top 65,536
PSUM_D, PSUM_K = 2 ** 24, 65536
PSUM_SEED = 46
PSUM_ITERS = 3
COLLECTIVES = ("all_to_all", "all_gather", "reduce_scatter", "all_reduce",
               "all_reduce_max")


@contextlib.contextmanager
def _timed_collectives(log: list):
    """``parallel.collectives``' plain collectives, each synchronised
    before and after while on and its (name, bytes in, seconds) appended
    to ``log``; its autograd functions call them by module name, forward
    and backward."""
    import torch
    from repro_torch.parallel import collectives as coll
    saved = {n: getattr(coll, n) for n in COLLECTIVES}

    def timed(name, fn):
        def call(t, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(t, *args)
            torch.cuda.synchronize()
            log.append((name, _nbytes(t), time.perf_counter() - t0))
            return out
        return call

    for n in COLLECTIVES:
        setattr(coll, n, timed(n, saved[n]))
    try:
        yield log
    finally:
        for n in COLLECTIVES:
            setattr(coll, n, saved[n])


def _moe_leaves(cfg, g) -> dict:
    """llama4-scout's MoE layer at full width as {name: leaf}: the router
    f32, the 16 experts and the shared expert bf16, N(0, 1) from ``g``
    times ``init_moe``'s scales, each requiring grad."""
    import torch
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def w(shape, scale, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=dtype).mul_(scale).requires_grad_()

    return {"router": w((d, E), d ** -0.5, torch.float32),
            "experts.w_gate": w((E, d, ff), d ** -0.5),
            "experts.w_up": w((E, d, ff), d ** -0.5),
            "experts.w_down": w((E, ff, d), ff ** -0.5),
            "shared.w_gate": w((d, ff), d ** -0.5),
            "shared.w_up": w((d, ff), d ** -0.5),
            "shared.w_down": w((ff, d), ff ** -0.5)}


def _rel_err(got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _moe_rank(rank: int, world: int, meshes) -> dict:
    """One rank of the expert-parallel MoE (``moe.apply_moe`` under
    ``activation_specs(moe_impl="shard_map", mesh=...)``) on the (2, 2)
    mesh at llama4-scout's width: the forward, then the backward of
    ``sum(out.float() ** 2)``, twice (the first with the launch counts set
    to 0 before and read after: R1 once; each collective timed), the peak
    memory; then, one rank at a time on the shared card, the one-device
    ``apply_moe`` on each block and its gradients, against the assembled
    output and this rank's parts of the gradients.  Rank 0 then times R1
    at a block and returns the printed line and R1's kernels row."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import engine
    from repro_torch.models import moe
    from repro_torch.models.moe_shard_map import local_slices
    from repro_torch.parallel.context import activation_specs
    t_start = time.monotonic()
    mesh = meshes["data_model"]
    cfg = get_config(SCOUT_ARCH)
    n_dp, i = engine.mesh_axis(mesh, "data")
    n_tp, j = engine.mesh_axis(mesh, "model")
    B, S = MOE_X
    Bl, Sl = B // n_dp, S // n_tp
    g = torch.Generator(device="cuda").manual_seed(MOE_SEED)
    leaves = _moe_leaves(cfg, g)
    leaves["x"] = torch.randn((B, S, cfg.d_model), generator=g,
                              device="cuda", dtype=torch.bfloat16
                              ).requires_grad_()
    p = {"router": leaves["router"]}
    for name, t in leaves.items():
        head, _, tail = name.partition(".")
        if tail:
            p.setdefault(head, {})[tail] = t
    x = leaves["x"]

    def step(log):
        """(out, forward s, backward s) of the shard_map layer."""
        for t in leaves.values():
            t.grad = None
        torch.cuda.synchronize()
        dist.barrier()
        with _timed_collectives(log), \
                activation_specs(moe_impl="shard_map", mesh=mesh):
            t0 = time.perf_counter()
            out, _ = moe.apply_moe(p, x, cfg)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (out.float() ** 2).sum().backward()
            torch.cuda.synchronize()
        return out.detach(), t1 - t0, time.perf_counter() - t1

    param_bytes = _nbytes(*leaves.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    logs = ([], [])
    reset_launches()
    out, fwd_s, bwd_s = step(logs[0])
    launches = read_launches()
    check(launches == only(router_logits=1),
          f"rank {rank} moe_shard_map: launches {launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    parts = {n: local_slices(n, t.shape, (n_dp, i), (n_tp, j))
             for n, t in leaves.items()}
    mine = {n: t.grad[parts[n]].clone() for n, t in leaves.items()}
    out2, fwd2_s, bwd2_s = step(logs[1])
    repeat_equal = bool(torch.equal(out, out2)) and all(
        torch.equal(t.grad[parts[n]], mine[n]) for n, t in leaves.items())
    del out2
    for t in leaves.values():
        t.grad = None
    torch.cuda.empty_cache()
    fwd_err = bitwise = grad_err = None
    for r in range(world):
        dist.barrier()
        if r != rank:
            continue
        want = torch.empty_like(out)
        for bi in range(n_dp):
            for bj in range(n_tp):
                blk = (slice(bi * Bl, (bi + 1) * Bl),
                       slice(bj * Sl, (bj + 1) * Sl))
                o, _ = moe.apply_moe(p, x[blk], cfg)
                want[blk] = o.detach()
                (o.float() ** 2).sum().backward()
        bitwise = bool(torch.equal(out, want))
        fwd_err = _rel_err(out, want)
        grad_err = {n: _rel_err(mine[n], t.grad[parts[n]])
                    for n, t in leaves.items()}
        del want, o
        for t in leaves.values():
            t.grad = None
        torch.cuda.empty_cache()
    dist.barrier()
    check(fwd_err <= MOE_FWD_TOL, f"rank {rank} moe_shard_map: the output "
          f"is {fwd_err} of its largest |value| off the one-device layer")
    for n, err in grad_err.items():
        check(err <= MOE_GRAD_TOL, f"rank {rank} moe_shard_map: d {n} is "
              f"{err} of its largest |value| off the one-device layer")
    # the gathered weights: this rank's E/tp experts and the whole shared
    gathered = sum(_nbytes(t) // (n_tp if n.startswith("experts.") else 1)
                   for n, t in leaves.items()
                   if n.startswith(("experts.", "shared.")))

    def by_op(log):
        return {op: sum(s for name, _, s in log if name == op)
                for op in COLLECTIVES}

    info = {"rank": rank, "launches": launches["router_logits"],
            "forward_ms": [fwd_s * 1e3, fwd2_s * 1e3],
            "backward_ms": [bwd_s * 1e3, bwd2_s * 1e3],
            "collective_s": [by_op(lg) for lg in logs],
            "collective_calls": [[(n, b / 1e6, s) for n, b, s in lg]
                                 for lg in logs],
            "peak_gb": peak_gb, "held_gb": held_gb,
            "reckoned_gb": (2 * param_bytes + gathered) / 1e9,
            "fwd_err": fwd_err, "bitwise": bitwise, "grad_err": grad_err,
            "repeat_equal": repeat_equal,
            "seconds": time.monotonic() - t_start}
    infos = [None] * world
    dist.all_gather_object(infos, info)
    if rank != 0:
        dist.barrier()
        return info
    r1 = _router_times(((x.detach()[:Bl, :Sl].contiguous(),
                         leaves["router"].detach()), None),
                       f"moe_shard_map block ({Bl} x {Sl})")
    dist.barrier()
    ms = lambda key, k: ", ".join(  # noqa: E731
        "%.1f" % f[key][k] for f in infos)
    coll = lambda k: "; ".join(  # noqa: E731
        "%s %s s" % (op, ", ".join("%.3f" % f["collective_s"][k][op]
                                   for f in infos)) for op in COLLECTIVES)
    cap = moe.dispatch_capacity(Sl, cfg)
    line = (f"  sharded moe_shard_map (llama4-scout MoE at full width, x "
            f"{list(x.shape)} bf16, blocks ({Bl}, {Sl}), cap {cap}, "
            f"(2, 2) mesh): output {'==' if all(f['bitwise'] for f in infos) else 'within'} "
            f"the one-device layer a block (max rel "
            f"{max(f['fwd_err'] for f in infos):.3g}, tol {MOE_FWD_TOL}); "
            f"gradients max rel {max(max(f['grad_err'].values()) for f in infos):.3g} "
            f"(tol {MOE_GRAD_TOL}); R1 x {[f['launches'] for f in infos]} "
            f"a rank; forward ms {ms('forward_ms', 0)} (again "
            f"{ms('forward_ms', 1)}), backward ms {ms('backward_ms', 0)} "
            f"(again {ms('backward_ms', 1)}); collectives, again: "
            f"{coll(1)}; peak GB {', '.join('%.2f' % f['peak_gb'] for f in infos)} "
            f"(reckoned {info['reckoned_gb']:.2f}: params, their gradients, "
            f"the gathered weights); {info['seconds']:.1f} s")
    row = {"name": "router_logits sharded moe_shard_map", "route": "cuda",
           "source": "src/repro_torch/kernels/router/csrc/router.cu",
           "replaces": "src/repro/models/moe.py:232 (array code, no Pallas "
                       "kernel)",
           "launches": sum(f["launches"] for f in infos),
           **{k: r1[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")},
           "r1": r1, "layer": "models/moe_shard_map.apply_moe_shard_map",
           "shape": {"x": list(x.shape), "block": [Bl, Sl, cfg.d_model],
                     "capacity": cap, "experts": cfg.n_experts,
                     "d_ff": cfg.d_ff, "mesh": {"data": n_dp,
                                                "model": n_tp}},
           "ranks": infos, "fwd_tol": MOE_FWD_TOL, "grad_tol": MOE_GRAD_TOL,
           "note": "ranks share one card over gloo (collectives through "
                   "host memory and loopback, not NVLink): no multi-card "
                   "speedup; ms, plain_ms, library_ms and bound_ms are R1 "
                   "at one block"}
    return {"line": line, "row": row}


def _psum_rank(rank: int, world: int, meshes) -> dict:
    """One rank of ``grad_comp.sparse_psum_shard_map`` over the 1-D
    ("data",) mesh (a mesh and a dim name): a (PSUM_D,) f32 gradient a
    rank (the ranks' rows of one seeded (world, PSUM_D) draw), top
    PSUM_K; once with the launch counts set to 0 before and read after
    (no kernel of the port runs in it), == ``sparse_allreduce_tree`` on
    the stacked gradients (``torch.equal``, every rank), then PSUM_ITERS
    more times on the host clock, every rank together.  Rank 0 times the
    tree and returns the printed line and the phase summary's entry: the
    exchange launches no kernel of the port, so it has no kernels row."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.grad_comp import sparse_allreduce as SA
    t_start = time.monotonic()
    g = torch.Generator(device="cuda").manual_seed(PSUM_SEED)
    grads = torch.randn((world, PSUM_D), generator=g, device="cuda")
    group = (meshes["data"], "data")
    run = lambda: SA.sparse_psum_shard_map(grads[rank], PSUM_K,  # noqa: E731
                                           group)
    torch.cuda.synchronize()
    dist.barrier()
    reset_launches()
    got = run()
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == only(), f"rank {rank} sparse_psum: launches "
                              f"{launches}")
    want, _ = SA.sparse_allreduce_tree(grads, PSUM_K)
    equal = bool(torch.equal(got, want))
    check(equal, f"rank {rank} sparse_psum != sparse_allreduce_tree")
    del want
    secs = []
    for _ in range(PSUM_ITERS):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    info = {"rank": rank, "equal": equal, "ms": [s * 1e3 for s in secs],
            "count": int((got != 0).sum())}
    infos = [None] * world
    dist.all_gather_object(infos, info)
    if rank != 0:
        dist.barrier()
        return info
    plain_ms = time_ms(lambda: SA.sparse_allreduce_tree(grads, PSUM_K), 2, 1)
    dist.barrier()
    ms = float(np.median([m for f in infos for m in f["ms"]]))
    line = (f"  sharded sparse_psum ({world} ranks, D {PSUM_D}, k {PSUM_K}):"
            f" == sparse_allreduce_tree on every rank; {info['count']} "
            f"entries; ms a call {', '.join('%.1f' % m for f in infos for m in f['ms'])} "
            f"(host clock, all ranks together, gloo all_gather of "
            f"{world} x {PSUM_K} keys and values), the tree on one device "
            f"{plain_ms:.1f}; {time.monotonic() - t_start:.1f} s")
    summary = {"equal": equal, "ms": ms, "tree_ms": plain_ms, "ranks": infos,
               "shape": {"D": PSUM_D, "k": PSUM_K, "ranks": world},
               "note": "no kernel of the port: torch ops and a gloo "
                       "all_gather; ms is one exchange on the host clock, "
                       "ranks sharing one card; tree_ms the one-device "
                       "tree on the stacked gradients"}
    return {"line": line, "summary": summary}


# phase_sharded_engine's ops: name -> the builder of its case
SHARDED_OPS = {
    "dispatch": functools.partial(_sharded_dispatch, False),
    "dispatch_int8": functools.partial(_sharded_dispatch, True),
    **{f"spmm_{dt}_{n}": functools.partial(_sharded_spmm, dt, n)
       for dt in ("float32", "bfloat16") for n in SHARDED_SPMM_N},
    "spmspm": functools.partial(_sharded_spmspm, False),
    "spmspm_fp8": functools.partial(_sharded_spmspm, True),
    "attention_causal": functools.partial(_sharded_attention, "causal"),
    "attention_window": functools.partial(_sharded_attention, "window"),
    "flash": _sharded_flash,
}
# then its layers: name -> one rank's run, its own checks and timings
# (rank 0 returns {"line", and "row" (a kernels row) or "summary"})
SHARDED_LAYERS = {"moe_shard_map": _moe_rank, "sparse_psum": _psum_rank}


def _sharded_rank(rank: int, world: int, ops, layers) -> list:
    """One rank of phase_sharded_engine, on the card (``cuda:0``, which all
    ranks share), for each op: its case built from seeds (the same operands
    on every rank), the sharded call with the launch counts set to 0 just
    before and read just after (this rank's kernel once, nothing else);
    then each rank's own kernel call on its part timed by CUDA events, one
    rank at a time between barriers.  Rank 0 then holds the sharded result
    against the one-device kernel on the whole operand (``torch.equal``)
    and that kernel against its plain version (``max_err``'s tolerance; the
    dispatch copy exactly), and times the one-device kernel, the plain
    version and the library call.  Then each of ``layers`` (SHARDED_LAYERS:
    the expert-parallel MoE layer, the sparse gradient exchange), with its
    own run, checks and timings.  The kernels must have been built before
    the spawn: no rank builds."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_host_mesh
    missing = [n for n in SHARDED_KERNELS
               if not build.library_path(n).is_file()]
    check(not missing, f"rank {rank}: {missing} not built before the spawn")
    meshes = {"data": make_host_mesh(data=world, device_type="cuda",
                                     timeout=SHARDED_TIMEOUT),
              "data_model": make_host_mesh(data=2, model=world // 2,
                                           device_type="cuda",
                                           timeout=SHARDED_TIMEOUT)}
    rows = []
    for name in ops:
        t0 = time.monotonic()
        case = SHARDED_OPS[name]()
        mesh = meshes[case.mesh]
        torch.cuda.synchronize()
        dist.barrier()
        reset_launches()
        got = case.sharded(mesh)
        torch.cuda.synchronize()
        launches = read_launches()
        check(launches == only(**{case.kernel: 1}),
              f"rank {rank} {name}: launches {launches}")
        run = case.part(mesh)
        part = run()
        ms = None
        for r in range(world):
            dist.barrier()
            if r == rank:
                ms = time_ms(run, SHARDED_ITERS, 2)
        dist.barrier()
        bound, by = _bound(*case.cost(part, mesh), case.peak)
        row = {"op": name, "ms": ms, "bound_ms": bound, "bound_by": by,
               "launches": launches[case.kernel],
               "part_shape": list(part.shape)}
        if rank == 0:
            one = case.one()
            row["equal"] = bool(torch.equal(got, one))
            check(row["equal"], f"{name}: sharded != the one-device kernel")
            sub, want = case.plain(one)
            if case.exact:
                check(torch.equal(sub, want), f"{name}: kernel != plain")
                err = 0.0
            else:
                err = max_err(sub, want, name)
            del sub, want
            one_bound, one_by = _bound(*case.cost(one, None), case.peak)
            row.update(
                kernel=case.kernel, source=case.source,
                replaces=case.replaces, shape=case.shape,
                max_abs_err=err, one_ms=time_ms(case.one, SHARDED_ITERS, 2),
                plain_ms=time_ms(lambda: case.plain(one), 1, 0),
                library_ms=time_ms(case.library, SHARDED_ITERS, 2),
                one_bound_ms=one_bound, one_bound_by=one_by,
                out_shape=list(got.shape), seconds=time.monotonic() - t0)
            del one
        rows.append(row)
        del case, got, part, run
        torch.cuda.empty_cache()
    for name in layers:
        rows.append(SHARDED_LAYERS[name](rank, world, meshes))
        torch.cuda.empty_cache()
    return rows


def phase_sharded_engine(card):
    """The sharded engine (``kernels/engine.py`` ``shard_*``,
    ``models/layers.sharded_flash_attention``) on SHARDED_RANKS gloo ranks
    that share the one card (``parallel.ranks.run_ranks``: spawned
    processes, a ``FileStore`` in a temporary directory, a group timeout
    of SHARDED_TIMEOUT s; NCCL puts no two ranks on one device), each
    launching the port's CUDA kernels on ``cuda:0``; the gather is
    ``torch.distributed.all_gather`` of CUDA tensors over gloo.  Ops
    (``_sharded_rank``): ``shard_spmm_batched_stream`` on llama4-scout's
    4 x 2,048 prefill dispatch stream, wide and int8; ``shard_spmm`` on
    the banded 8192^2 BCSR at N 512 and 300, f32 and bf16;
    ``shard_spmspm`` on the library's SpMSpM, wide and fp8 ``a_scales``;
    ``shard_attention_sparse`` at scout's prefill on a causal and a
    sliding-window mask; ``sharded_flash_attention`` on a (2, 2) mesh.
    Each checks sharded == one device (``torch.equal``) and the kernel
    against its plain version, and prints each rank's kernel time on its
    part beside the one-device kernel's on the whole.  Then two layers:
    ``moe.apply_moe`` under the shard_map impl on the (2, 2) mesh at
    llama4-scout's width (``_moe_rank``: forward and backward against the
    one-device layer on each block within MOE_FWD_TOL / MOE_GRAD_TOL, R1
    once a rank, each collective's seconds, each rank's peak memory) and
    ``sparse_psum_shard_map`` on 4 ranks (``_psum_rank``: ==
    ``sparse_allreduce_tree``).  The ranks time one
    at a time on a card they share: this checks the split and its
    offsets on the card, it measures no multi-card speedup.  A rank that
    fails makes the phase raise.  Returns (the kernel rows, a summary)."""
    from repro_torch.parallel.ranks import run_ranks
    t0 = time.monotonic()
    per_rank = run_ranks(_sharded_rank, SHARDED_RANKS, list(SHARDED_OPS),
                         list(SHARDED_LAYERS), timeout=SHARDED_TIMEOUT,
                         limit=SHARDED_LIMIT)
    seconds = time.monotonic() - t0
    rows = []
    for j, name in enumerate(SHARDED_OPS):
        r0, ranks = per_rank[0][j], [pr[j] for pr in per_rank]
        rank_ms = [r["ms"] for r in ranks]
        listed = lambda key: ", ".join(  # noqa: E731
            "%.4f" % r[key] for r in ranks)
        print(f"  sharded {name} ({r0['kernel']}, parts "
              f"{r0['part_shape']} of {r0['out_shape']}): == one device; "
              f"kernel vs plain {r0['max_abs_err']:.3g}; rank ms "
              f"{listed('ms')} (bounds {listed('bound_ms')}), one device "
              f"{r0['one_ms']:.4f} (bound {r0['one_bound_ms']:.4f}), plain "
              f"{r0['plain_ms']:.1f}, library {r0['library_ms']:.4f}; "
              f"{r0['seconds']:.1f} s")
        rows.append({
            "name": f"{r0['kernel']} sharded {name}", "route": "cuda",
            "source": r0["source"], "replaces": r0["replaces"],
            "launches": sum(r["launches"] for r in ranks),
            "max_abs_err": r0["max_abs_err"], "ms": r0["one_ms"],
            "plain_ms": r0["plain_ms"], "bound_ms": r0["one_bound_ms"],
            "bound_by": r0["one_bound_by"], "library_ms": r0["library_ms"],
            "card": card, "sharded_equal": r0["equal"], "ranks": len(ranks),
            "rank_ms": rank_ms,
            "rank_bound_ms": [r["bound_ms"] for r in ranks],
            "rank_bound_by": [r["bound_by"] for r in ranks],
            "rank_launches": [r["launches"] for r in ranks],
            "part_shape": r0["part_shape"], "shape": r0["shape"],
            "note": "ranks share one card and time one at a time: no "
                    "multi-card speedup; ms, plain_ms, library_ms and "
                    "bound_ms are the one-device call on the whole operand"})
    layers = {}
    for j, name in enumerate(SHARDED_LAYERS, len(SHARDED_OPS)):
        r0 = per_rank[0][j]
        print(r0["line"])
        if "row" in r0:
            rows.append({**r0["row"], "card": card})
        else:
            layers[name] = r0["summary"]
    print(f"  sharded engine: {seconds:.1f} s for {len(SHARDED_OPS)} ops and "
          f"{len(SHARDED_LAYERS)} layers on {SHARDED_RANKS} gloo ranks "
          "sharing the card (gather: all_gather of CUDA tensors over gloo)")
    return rows, {"seconds": seconds, "ranks": SHARDED_RANKS,
                  "ops": list(SHARDED_OPS), "layers": list(SHARDED_LAYERS),
                  **layers}


# ---------------------------------------------------------------------------
# The multi-rank train step: SHARDED_RANKS gloo ranks that share the card.
# ---------------------------------------------------------------------------

# (a) tests/test_torch_train_mesh.py's SMOKE cases on the card, f32, three
# steps each, against the card's one-device step within the CPU test's
# tolerances (1e-5 on the loss and norm and, in units of a leaf's largest,
# on m and v; the params the same plus 2 x lr: AdamW's normalised step can
# flip sign on a near-zero gradient whose sum order changed)
MESH_SMOKE = {"qwen3": (TRAIN_ARCH, "data_model", {}),
              "qwen3_pod": (TRAIN_ARCH, "pod_data_model", {}),
              "scout": (SCOUT_ARCH, "data_model", {"moe_impl": "shard_map"}),
              "scout_pod": (SCOUT_ARCH, "pod_data_model",
                            {"moe_impl": "shard_map"})}
MESH_SMOKE_SHAPE = (4, 32)            # (global batch, sequence)
MESH_SMOKE_CHUNK, MESH_SMOKE_STEPS, MESH_SMOKE_LR = 16, 3, 1e-3
MESH_SMOKE_TOL = 1e-5
# (b) qwen3-1.7b at full width and depth on the (2, 2) mesh: f32 params,
# bf16 compute, SyntheticLM(seed=0) 4 x 512 tokens, kernel_sharded, two
# steps against the one-device step on the same tokens; the losses within
# these (bf16: the row-parallel products' partial sums are added in bf16
# across the ranks, and step 2 follows AdamW's sign-like first step); the
# default seq_chunk, which at 512 tokens takes the loss's unchunked branch
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, MESH_TRAIN_CHUNK = 4, 512, 512
MESH_TRAIN_STEPS = 2
MESH_TRAIN_TOL = (2e-2, 5e-2)
MESH_TRAIN_LIMIT = 600.0              # the parent's wait for every rank
MESHES = {"data_model": ((2, 2), ("data", "model")),
          "pod_data_model": ((1, 2, 2), ("pod", "data", "model"))}


def _mesh_smoke_run(name, params, tokens, mesh) -> dict:
    """One SMOKE case on this rank: the step over ``mesh`` from the
    global ``params`` (CPU) for MESH_SMOKE_STEPS steps; the launches of
    step 1 (set to 0 just before, read just after), each step's loss and
    norm, the final local params and state on the CPU."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel import sharding as S
    arch, _, kw = MESH_SMOKE[name]
    cfg = dataclasses.replace(get_smoke(arch), policy="f32")
    opt = AdamW(lr=MESH_SMOKE_LR)
    step, (p_specs, o_specs, _, _), _ = steps.make_train_step(
        cfg, ShapeSpec("smoke", "train", MESH_SMOKE_SHAPE[1],
                       MESH_SMOKE_SHAPE[0]), opt,
        seq_chunk=MESH_SMOKE_CHUNK, mesh=mesh, **kw)
    local = _tree_to(S.local_tree(params, p_specs, mesh), "cuda")
    state = opt.init(local)
    metrics, launches = [], None
    with no_plain():
        for i, tok in enumerate(tokens):
            torch.cuda.synchronize()
            if i == 0:
                reset_launches()
            local, state, m = step(local, state, tok.cuda())
            torch.cuda.synchronize()
            if i == 0:
                launches = read_launches()
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    n_moe = cfg.n_repeats * cfg.block_unit.count("attn+moe")
    check(launches == only(router_logits=2 * n_moe),
          f"train mesh {name}: launches {launches}")
    cpu = lambda t: t.cpu()  # noqa: E731
    return {"metrics": metrics, "launches": launches["router_logits"],
            "params": S.map_specs(lambda _, s, t: cpu(t), p_specs, local),
            "m": S.map_specs(lambda _, s, t: cpu(t), p_specs, state.m),
            "v": S.map_specs(lambda _, s, t: cpu(t), p_specs, state.v)}


def _mesh_full_params(rank: int, world: int, cfg, p_specs, mesh,
                      param_dtype=None):
    """This rank's part of ``init_params(cfg, seed=0)`` in
    ``param_dtype`` (default f32) on the card: the ranks draw the whole
    tree one at a time (the same draws as the parent's one-device run),
    cut their part and free the rest."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as S
    local = None
    for r in range(world):
        dist.barrier()
        if r == rank:
            full = M.init_params(cfg, seed=0, device="cuda",
                                 param_dtype=param_dtype or torch.float32)
            local = S.local_tree(full, p_specs, mesh)
            del full
            torch.cuda.empty_cache()
    dist.barrier()
    return local


def _train_mesh_rank(rank: int, world: int, smoke, tokens) -> dict:
    """One rank of phase_train_mesh, on ``cuda:0`` (which all ranks
    share): (a) the SMOKE cases (:func:`_mesh_smoke_run`); (b) qwen3-1.7b
    at full width and depth on the (2, 2) mesh, kernel_sharded: this
    rank's part of the params drawn on the card, MESH_TRAIN_STEPS steps on
    the global ``tokens``; step 1 with the launch counts set to 0 just
    before and read just after (K3 twice a layer: the forward and the
    remat recompute), step 2 with every collective synchronised and timed;
    each step's seconds (host clock, from a barrier), the peak memory and
    the peak as step 1's update starts (through the backward).
    Rank 0 then times K3 at the first call the step made and R1 at the
    scout SMOKE case's first router call, and returns the kernels rows."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.optim.adamw import AdamW
    torch.cuda.set_device(0)
    missing = [n for n in ("flash_attention", "router")
               if not build.library_path(n).is_file()]
    check(not missing, f"rank {rank}: {missing} not built before the spawn")
    t_start = time.monotonic()
    meshes = {name: make_mesh(shape, names, "cuda", timeout=SHARDED_TIMEOUT)
              for name, (shape, names) in MESHES.items()}
    keep = keep_first_calls()
    out = {"rank": rank, "smoke": {}}
    with keep:
        for name, (params, toks) in smoke.items():
            out["smoke"][name] = _mesh_smoke_run(
                name, params, toks, meshes[MESH_SMOKE[name][1]])
    r1_args = keep.args["router_logits"]
    smoke_s = time.monotonic() - t_start
    cfg = get_config(TRAIN_ARCH)
    mesh = meshes["data_model"]
    update_peaks = []

    class PeakAtUpdate(AdamW):
        """AdamW noting the peak memory as its update starts: the peak of
        the step's forward and backward."""

        def update(self, *args, **kw):
            update_peaks.append(torch.cuda.max_memory_allocated() / 1e9)
            return super().update(*args, **kw)

    opt = PeakAtUpdate(lr=TRAIN_LR)
    step, (p_specs, _, _, _), _ = steps.make_train_step(
        cfg, ShapeSpec("mesh", "train", MESH_TRAIN_SEQ, MESH_TRAIN_BATCH),
        opt, seq_chunk=MESH_TRAIN_CHUNK, attn_impl="kernel_sharded",
        mesh=mesh)
    local = _mesh_full_params(rank, world, cfg, p_specs, mesh)
    state = opt.init(local)
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    keep = keep_first_calls()
    full = {"losses": [], "grad_norms": [], "seconds": [], "launches": None,
            "collectives": []}
    for i, tok in enumerate(tokens):
        tok = torch.from_numpy(tok).cuda()
        torch.cuda.synchronize()
        dist.barrier()
        log = []
        with no_plain(), keep, _timed_collectives(log) if i else \
                contextlib.nullcontext():
            if i == 0:
                reset_launches()
            t0 = time.perf_counter()
            local, state, m = step(local, state, tok)
            loss = float(m["loss"])
            secs = time.perf_counter() - t0
            if i == 0:
                full["launches"] = read_launches()
        full["losses"].append(loss)
        full["grad_norms"].append(float(m["grad_norm"]))
        full["seconds"].append(secs)
        if log:
            full["collectives"] = {
                op: [sum(1 for n, _, _ in log if n == op),
                     sum(b for n, b, _ in log if n == op) / 1e9,
                     sum(s for n, _, s in log if n == op)]
                for op in COLLECTIVES}
    k3 = full["launches"]["flash_attention"]
    check(full["launches"] == only(flash_attention=2 * cfg.n_layers),
          f"rank {rank} train mesh: launches {full['launches']}, want K3 "
          f"{2 * cfg.n_layers}")
    full.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                backward_peak_gb=update_peaks[0], held_gb=held_gb, k3=k3)
    fa = keep.args["attention"][0][:3]
    del local, state, step
    gc.collect()
    torch.cuda.empty_cache()
    out.update(full=full, seconds={"smoke": smoke_s,
                                   "total": time.monotonic() - t_start})
    infos = [None] * world
    dist.all_gather_object(infos, {"k3": k3})
    if rank != 0:
        dist.barrier()
        return out
    from repro_torch.core.masks import BlockMask
    from repro_torch.kernels import tuning
    S_len, D = fa[0].shape[2], fa[0].shape[3]
    bq, bk = tuning.flash_tiles(S_len, S_len, D, fa[0].dtype, fa[0].device)
    rows = phase_measure_attention(
        fa, BlockMask.full(S_len, S_len, bq=bq, bk=bk, causal=True),
        {"flash_attention": sum(f["k3"] for f in infos)}, None,
        suffix=f" (train mesh {TRAIN_ARCH}, a rank's heads)",
        names=("flash_attention",))
    r1 = _router_times(((r1_args[0][0], r1_args[0][1]), None),
                       f"train mesh {SCOUT_ARCH} smoke block")
    rows.append({"name": f"router_logits (train mesh {SCOUT_ARCH} smoke)",
                 "route": "cuda",
                 "source": "src/repro_torch/kernels/router/csrc/router.cu",
                 "replaces": "src/repro/models/moe.py:232 (array code, no "
                             "Pallas kernel)",
                 "launches": None, **r1})
    dist.barrier()
    out["rows"] = rows
    return out


def _mesh_close(p_specs, got, want, what: str, params: bool) -> list:
    """Every leaf of the tree ``got`` within MESH_SMOKE_TOL of the tree
    ``want`` (both laid out as ``p_specs``) in units of the leaf's largest
    |want| (plus 2 x lr for ``params``); the leaves that needed the 2 x lr
    term, each with its number of such elements."""
    from repro_torch.parallel import sharding as S
    second = []

    def leaf(path, _, a, b):
        name = "/".join(path)
        b = b.float().cpu()
        err = (a.float() - b).abs() - MESH_SMOKE_TOL * b.abs()
        atol = MESH_SMOKE_TOL * b.abs().max().item()
        if params and (err > atol).any():
            second.append((name, int((err > atol).sum())))
            atol += 2 * MESH_SMOKE_LR
        check(bool((err <= atol).all()), f"train mesh {what}: {name} off "
                                         f"by {err.max().item()} > {atol}")

    S.map_specs(leaf, p_specs, got, want)
    return second


def _mesh_smoke_inputs() -> tuple:
    """Each SMOKE case's global params (CPU, seed 0) and tokens (numpy
    seed 0), and the card's one-device step on them: per case the
    metrics and the final params, m and v."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamW
    inputs, want = {}, {}
    for name, (arch, _, _) in MESH_SMOKE.items():
        cfg = dataclasses.replace(get_smoke(arch), policy="f32")
        params = M.init_params(cfg, seed=0, device="cpu",
                               param_dtype=torch.float32)
        rng = np.random.default_rng(0)
        toks = [torch.from_numpy(rng.integers(
            0, cfg.vocab_size, MESH_SMOKE_SHAPE).astype(np.int32))
            for _ in range(MESH_SMOKE_STEPS)]
        inputs[name] = (params, toks)
        opt = AdamW(lr=MESH_SMOKE_LR)
        step = steps.make_train_step(
            cfg, ShapeSpec("smoke", "train", MESH_SMOKE_SHAPE[1],
                           MESH_SMOKE_SHAPE[0]), opt,
            seq_chunk=MESH_SMOKE_CHUNK)
        p = _tree_to(params, "cuda")
        state, metrics = opt.init(p), []
        with no_plain():
            for tok in toks:
                p, state, m = step(p, state, tok.cuda())
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
        want[name] = {"metrics": metrics, "params": _tree_to(p, "cpu"),
                      "m": _tree_to(state.m, "cpu"),
                      "v": _tree_to(state.v, "cpu")}
    return inputs, want


def _mesh_full_one_device(tokens) -> dict:
    """qwen3-1.7b at full width and depth on one device from
    ``init_params(seed=0)`` (f32 params): MESH_TRAIN_STEPS kernel_sharded
    steps on ``tokens``, each step's loss, norm and seconds; the params
    freed after."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamW
    cfg = get_config(TRAIN_ARCH)
    params = M.init_params(cfg, seed=0, device="cuda",
                           param_dtype=torch.float32)
    opt = AdamW(lr=TRAIN_LR)
    state = opt.init(params)
    step = steps.make_train_step(
        cfg, ShapeSpec("mesh", "train", MESH_TRAIN_SEQ, MESH_TRAIN_BATCH),
        opt, seq_chunk=MESH_TRAIN_CHUNK, attn_impl="kernel_sharded")
    torch.cuda.reset_peak_memory_stats()
    out = {"losses": [], "grad_norms": [], "seconds": []}
    with no_plain():
        for tok in tokens:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, torch.from_numpy(tok)
                                    .cuda())
            out["losses"].append(float(m["loss"]))
            out["seconds"].append(time.perf_counter() - t0)
            out["grad_norms"].append(float(m["grad_norm"]))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_mesh(card):
    """The multi-rank train step (``launch.steps.make_train_step(mesh=)``)
    on SHARDED_RANKS gloo ranks that share the card: the one-device steps
    run here first (the SMOKE cases, then qwen3-1.7b at full width and
    depth, freed after), then the ranks (:func:`_train_mesh_rank`).  (a)
    qwen3-1.7b and llama4-scout SMOKE (scout under the shard_map MoE) in
    f32 on a (2, 2) and a (1, 2, 2) mesh, three steps: the losses, norms
    and the assembled params, m and v against the one-device step within
    the CPU test's tolerances, R1 twice a MoE layer a step on each rank;
    (b) qwen3-1.7b at full width and depth on the (2, 2) mesh,
    kernel_sharded, 4 x 512 tokens of ``SyntheticLM(seed=0)``, two steps:
    both losses against the one-device step within MESH_TRAIN_TOL, K3
    twice a layer a rank a step, the peak GB, the step seconds and the
    seconds in collectives a rank (gloo through host memory and loopback,
    not NVLink: no multi-card speedup is measured).  Returns (the K3 and
    R1 rows, a summary)."""
    import numpy as np
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel.ranks import run_ranks
    t0 = time.monotonic()
    smoke, want = _mesh_smoke_inputs()
    cfg = get_config(TRAIN_ARCH)
    data = SyntheticLM(cfg, batch=MESH_TRAIN_BATCH, seq_len=MESH_TRAIN_SEQ,
                       seed=0)
    tokens = [data.batch_at(i)["tokens"] for i in range(MESH_TRAIN_STEPS)]
    one = _mesh_full_one_device(tokens)
    one_s = time.monotonic() - t0
    per_rank = run_ranks(_train_mesh_rank, SHARDED_RANKS, smoke, tokens,
                         timeout=SHARDED_TIMEOUT, limit=MESH_TRAIN_LIMIT)
    summary = {"smoke": {}, "card": card}
    for name, (arch, mesh_name, kw) in MESH_SMOKE.items():
        scfg = dataclasses.replace(get_smoke(arch), policy="f32")
        shape, names = MESHES[mesh_name]
        mesh = S.MeshShape(names, shape)
        p_specs = S.param_specs(steps.abstract_params(scfg), mesh)
        runs = [pr["smoke"][name] for pr in per_rank]
        got, w = runs[0]["metrics"], want[name]["metrics"]
        check(all(r["metrics"] == got for r in runs),
              f"train mesh {name}: the ranks' losses differ")
        err = max(max(abs(a - b) / (1 + abs(b)), abs(c - d) / (1 + abs(d)))
                  for (a, c), (b, d) in zip(got, w))
        check(err <= MESH_SMOKE_TOL, f"train mesh {name}: {got} vs one "
                                     f"device {w}")
        second = {}
        for key in ("params", "m", "v"):
            whole = S.assemble([r[key] for r in runs], p_specs, mesh)
            second[key] = _mesh_close(p_specs, whole, want[name][key],
                                      f"{name} {key}", key == "params")
        summary["smoke"][name] = {
            "losses": [m[0] for m in got], "one_device": [m[0] for m in w],
            "metric_err": err, "r1_launches": [r["launches"] for r in runs],
            "lr_term_leaves": second["params"]}
        print(f"  train mesh {name} ({arch} smoke f32, {shape} mesh, "
              f"{MESH_SMOKE_STEPS} steps): losses "
              f"{[round(m[0], 6) for m in got]} vs one device (largest "
              f"err {err:.3g}); params / m / v assembled within "
              f"{MESH_SMOKE_TOL} of the one-device step's (params leaves "
              f"needing 2 x lr: {second['params']}); R1 x "
              f"{[r['launches'] for r in runs]} a rank in step 1")
    fulls = [pr["full"] for pr in per_rank]
    losses = fulls[0]["losses"]
    check(all(f["losses"] == losses for f in fulls)
          and all(np.isfinite(losses)),
          f"train mesh {TRAIN_ARCH}: the ranks' losses {fulls}")
    errs = [abs(a - b) for a, b in zip(losses, one["losses"])]
    check(all(e <= t for e, t in zip(errs, MESH_TRAIN_TOL)),
          f"train mesh {TRAIN_ARCH}: losses {losses} vs one device "
          f"{one['losses']} (tolerances {MESH_TRAIN_TOL})")
    ks = [f["k3"] for f in fulls]
    coll = {op: [f["collectives"][op] for f in fulls] for op in COLLECTIVES}
    coll_s = [sum(f["collectives"][op][2] for op in COLLECTIVES)
              for f in fulls]
    rows = [{**r, "card": card} for r in per_rank[0]["rows"]]
    rows[-1]["launches"] = sum(sum(pr["smoke"][n]["launches"]
                                   for n in MESH_SMOKE) for pr in per_rank)
    seconds = time.monotonic() - t0
    print(f"  train mesh {TRAIN_ARCH} at full width and depth "
          f"({cfg.n_layers} layers, (2, 2) mesh, kernel_sharded, "
          f"{MESH_TRAIN_BATCH} x {MESH_TRAIN_SEQ}): losses {losses} vs one "
          f"device {one['losses']} (errs {[f'{e:.3g}' for e in errs]}, tol "
          f"{MESH_TRAIN_TOL}); grad norms {fulls[0]['grad_norms']} vs "
          f"{one['grad_norms']}; K3 x {ks} a rank a step; peak GB a rank "
          f"{', '.join('%.2f' % f['peak_gb'] for f in fulls)} (through "
          f"the backward "
          f"{', '.join('%.2f' % f['backward_peak_gb'] for f in fulls)}; "
          f"held {fulls[0]['held_gb']:.2f}; one device "
          f"{one['peak_gb']:.2f}); "
          f"step s a rank {[[round(x, 2) for x in f['seconds']] for f in fulls]}"
          f" (one device {[round(x, 2) for x in one['seconds']]}); step 2's "
          f"collectives s a rank {[round(x, 2) for x in coll_s]} (gloo "
          f"over loopback, each synchronised); phase {seconds:.1f} s (the "
          f"one-device steps {one_s:.1f})")
    summary.update(
        arch=TRAIN_ARCH, layers=cfg.n_layers, batch=MESH_TRAIN_BATCH,
        seq=MESH_TRAIN_SEQ, seq_chunk=MESH_TRAIN_CHUNK, lr=TRAIN_LR,
        losses=losses, one_device=one, loss_errs=errs, tol=MESH_TRAIN_TOL,
        grad_norms=fulls[0]["grad_norms"], k3_per_rank_step=ks,
        peak_gb=[f["peak_gb"] for f in fulls],
        backward_peak_gb=[f["backward_peak_gb"] for f in fulls],
        held_gb=[f["held_gb"] for f in fulls],
        step_s=[f["seconds"] for f in fulls], collective_s=coll_s,
        collectives=coll, rank_seconds=[pr["seconds"] for pr in per_rank],
        seconds=seconds, one_device_s=one_s,
        note="4 gloo ranks share one card (collectives through host "
             "memory and loopback, not NVLink): no multi-card speedup; "
             "step 2 runs with every collective synchronised and timed")
    return rows, summary


# ---------------------------------------------------------------------------
# The serving steps on a mesh: SHARDED_RANKS gloo ranks that share the card.
# ---------------------------------------------------------------------------

# (a) D1's split mode at random inputs: B 4, 16/8 heads of 128, a shard of
# 288 of 576 positions at offset 288, rows that see none of it, part of it
# and all of it, with and without a window; the merge of both shards held
# against one-device D1 within decode_tolerance
SPLIT_CASES = (("bfloat16", None, (100, 400, 576, 300)),
               ("bfloat16", 300, (100, 400, 576, 300)),
               ("float32", None, (288, 289, 576, 450)),
               ("float32", 300, (100, 587, 576, 301)))
SPLIT_SHAPE = (16, 8, 128, 576)              # Hq, Hkv, D, the whole cache
# (b) SMOKE cases in f32 (name: arch, mesh, global batch, the MoE's
# dispatch), a 48-token prompt at max_seq 64 and three decode steps from
# the one-device prefill's bf16 cache, against the one-device steps on the
# card: prefill logits within 1e-4 (the CPU test's), decode logits within
# MESH_SERVE_BF16_TOL (a new K / V rounded to the neighbouring bf16 value
# moves them by up to 4e-4 on the CPU), the MoE counts equal after the
# prefill and after every step; each bcsr case's parts torch.equal to its
# gather case's (MESH_SERVE_BCSR), rank by rank
MESH_SERVE_SMOKE = {"qwen3": (TRAIN_ARCH, "data_model", 4, None),
                    "gemma3": ("gemma3-12b", "data_model", 4, None),
                    "qwen3_pod": (TRAIN_ARCH, "pod_data_model", 4, None),
                    "qwen3_b1": (TRAIN_ARCH, "data_model", 1, None),
                    "scout": (SCOUT_ARCH, "data_model", 4, "gather"),
                    "scout_bcsr": (SCOUT_ARCH, "data_model", 4, "bcsr"),
                    "maverick": (MAVERICK_ARCH, "data_model", 4, "gather"),
                    "maverick_bcsr": (MAVERICK_ARCH, "data_model", 4,
                                      "bcsr")}
MESH_SERVE_BCSR = {"scout_bcsr": "scout", "maverick_bcsr": "maverick"}
MESH_SERVE_PROMPT, MESH_SERVE_MAX, MESH_SERVE_STEPS = 48, 64, 3
MESH_SERVE_LOGIT_TOL = 1e-4
MESH_SERVE_BF16_TOL = 2e-3
# (c) qwen3-1.7b at full width, MESH_SERVE_DEPTH of its 28 layers, bf16
# weights (seed 0) on the (2, 2) mesh, impl="kernel": a 4 x 512 prompt (numpy seed 47) at max_seq
# 576, four greedy decode steps teacher-forced from the one-device run's
# tokens; the last-position logits within MESH_SERVE_FULL_TOL of one
# device's at every step (bf16: the row-parallel products' partial sums
# are added in bf16 across the ranks), the tokens equal wherever one
# device's top-2 margin exceeds it
MESH_SERVE_BATCH, MESH_SERVE_SEQ, MESH_SERVE_CAP = 4, 512, 576
MESH_SERVE_DEPTH = 28
MESH_SERVE_GEN = 4
MESH_SERVE_FULL_TOL = 0.5
MESH_SERVE_LIMIT = 600.0              # the parent's wait for every rank
# (d) llama4-scout at full width (d_model 5120, 16 experts, vocab 202,048)
# at depth 2 of 48, bf16 weights (seed 0) on the (2, 2) mesh, impl
# "kernel", bcsr dispatch: a 4 x 256 prompt (numpy seed 48) at max_seq
# 320, two greedy decode steps teacher-forced from the one-device run's
# tokens.  A token whose router input moved by the ranks' summation order
# may take another expert than on one device (a flip): the flips are
# counted a pass and layer and printed; a token that flips where it had
# not flipped at an earlier layer of the pass must be a near-tie on one
# device, its top-2 router logits within MESH_MOE_GAP; the counts differ
# by no more than the flips so far.  The last-position logits of every
# row whose last position took one device's experts in every layer of the
# pass are held within MESH_MOE_TOL of one device's, the tokens equal
# where one device's top-2 margin exceeds it; at least one row is compared
MESH_MOE_DEPTH = 2
MESH_MOE_BATCH, MESH_MOE_SEQ, MESH_MOE_CAP, MESH_MOE_GEN = 4, 256, 320, 2
MESH_MOE_TOL = 0.25
MESH_MOE_GAP = 0.125
# the split mode's times: the full-width run's first decode step (kv_len
# 513) on the "model" rank that holds positions 288-575
SPLIT_TIME_LEN = 513
D1_SPLIT_SRC = ("src/repro_torch/kernels/flash_attention/csrc/"
                "decode_attention.cu")


def _split_run(q, k, v, kv, window, n):
    """D1's split mode over ``n`` equal shards of the whole cache (k, v),
    as the ranks run it: each shard's max (the kernel), their largest,
    each shard's partials against it (the kernel), merged in rank order.
    Returns (out, the shards' maxima, their (acc, l))."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    w = k.shape[2] // n
    shards = [(k[:, :, i * w:(i + 1) * w].contiguous(),
               v[:, :, i * w:(i + 1) * w].contiguous(), i * w)
              for i in range(n)]
    ms = [fops.decode_attention_max(q, ks, kv_len=kv, window=window,
                                    offset=o) for ks, _, o in shards]
    m = torch.stack(ms).amax(0)
    parts = [fops.decode_attention_partial(q, ks, vs, m, kv_len=kv,
                                           window=window, offset=o)
             for ks, vs, o in shards]
    out = fops.decode_merge(torch.stack([a for a, _ in parts]),
                            torch.stack([l for _, l in parts]), q.dtype)
    return out, ms, parts


def phase_split_decode_vs_plain() -> float:
    """D1's split mode (``decode_attention_max`` / ``_partial``) on the
    card at :data:`SPLIT_CASES`: the shard at offset 288 against its plain
    versions (the max within 1e-5 of the largest |score|, the partials
    within :func:`decode_tolerance`) and ``torch.equal`` to its emulated
    order; a row that sees none of the shard gives -inf, 0 and 0; both
    shards merged against one-device D1 on the whole cache within
    :func:`decode_tolerance`; each row's max and partials at B 1
    ``torch.equal`` to the same row at B 4.  Returns the largest error
    against plain (the partials')."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref
    rng = np.random.default_rng(46)
    Hq, Hkv, D, S = SPLIT_SHAPE
    worst = 0.0
    for dn, window, lens in SPLIT_CASES:
        dt = getattr(torch, dn)
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to("cuda", dt)
            for s in ((4, Hq, 1, D), (4, Hkv, S, D), (4, Hkv, S, D)))
        kv = torch.tensor(lens, device="cuda")
        what = f"D1 split {dn} window {window} rows {lens}"
        ks, vs = k[:, :, S // 2:].contiguous(), v[:, :, S // 2:].contiguous()
        kw = dict(kv_len=kv, window=window, offset=S // 2)
        m = fk.decode_attention_max(q, ks, **kw)
        acc, l = fk.decode_attention_partial(q, ks, vs, m, **kw)
        m_plain = ref.decode_split_max_ref(q, ks, **kw)
        acc_p, l_p = ref.decode_split_partial_ref(q, ks, vs, m, **kw)
        torch.cuda.synchronize()
        seen = torch.isfinite(m_plain)
        check(torch.equal(torch.isfinite(m), seen),
              f"{what}: the rows that see the shard differ from plain")
        check(not seen[0].any() and seen[1:].all(),
              f"{what}: row 0 should see none of the shard, the rest some")
        big = m_plain[seen].abs().max().item()
        m_err = (m[seen] - m_plain[seen]).abs().max().item()
        check(m_err <= 1e-5 * big, f"{what}: max {m_err} > {1e-5 * big}")
        check(not acc[0].any() and not l[0].any(),
              f"{what}: a row that sees none of the shard has partials")
        for got, want in ((acc, acc_p), (l, l_p)):
            err = (got - want).abs().max().item()
            tol = decode_tolerance(want.abs().max().item(), dt, dt)
            check(err <= tol, f"{what}: partials {err} > {tol}")
            worst = max(worst, err)
        check(torch.equal(ref.decode_split_max_ordered(q, ks, **kw), m),
              f"{what}: the max != its emulated order")
        oa, ol = ref.decode_split_partial_ordered(q, ks, vs, m, **kw)
        check(torch.equal(oa, acc) and torch.equal(ol, l),
              f"{what}: the partials != their emulated order")
        for i in range(4):
            r = slice(i, i + 1)
            kr = dict(kw, kv_len=kv[r])
            ai, li = fk.decode_attention_partial(q[r], ks[r], vs[r], m[r],
                                                 **kr)
            check(torch.equal(fk.decode_attention_max(q[r], ks[r], **kr),
                              m[r]) and torch.equal(ai, acc[r])
                  and torch.equal(li, l[r]),
                  f"{what}: row {i} at B 1 != at B 4")
        out, _, _ = _split_run(q, k, v, kv, window, 2)
        one = fk.decode_attention(q, k, v, kv_len=kv, window=window)
        torch.cuda.synchronize()
        err = (out.float() - one.float()).abs().max().item()
        tol = decode_tolerance(one.float().abs().max().item(), dt, dt)
        check(not out.isnan().any() and err <= tol,
              f"{what}: merged vs one-device D1 {err} > {tol}")
        print(f"  {what}: shard at offset {S // 2} of {S}: max within "
              f"{m_err:.3g} of plain, == its order; partials within "
              f"{worst:.3g}, == their order; rows at B 1 == at B 4; both "
              f"shards merged vs one-device D1 {err:.3g} (tol {tol:.3g})")
    return worst


def _split_times(err: float, launches: int, card) -> dict:
    """The split mode's row of the kernels line at the full-width decode
    step's shape on a "model" rank: B 2 rows, 16/8 heads of 128, bf16, the
    shard of 288 of 576 positions at offset 288, kv_len 513 (225 visible
    a row): max + partial back to back and from a graph, their plain
    versions, one-device D1 on the whole cache beside; the bound: the
    shard's visible K and V, q, m and the partials moved once at 3.35
    TB/s."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref
    rng = np.random.default_rng(47)
    Hq, Hkv, D, S = SPLIT_SHAPE
    B, off, n = 2, S // 2, SPLIT_TIME_LEN
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to("cuda", torch.bfloat16)
        for s in ((B, Hq, 1, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    ks, vs = k[:, :, off:].contiguous(), v[:, :, off:].contiguous()
    kv = torch.full((B,), n, device="cuda")
    kw = dict(kv_len=kv, window=None, offset=off)
    m = fk.decode_attention_max(q, ks, **kw)

    def run():
        fk.decode_attention_partial(q, ks, vs,
                                    fk.decode_attention_max(q, ks, **kw),
                                    **kw)

    def plain():
        ref.decode_split_partial_ref(q, ks, vs, ref.decode_split_max_ref(
            q, ks, **kw), **kw)

    ms, plain_ms, g_ms = time_ms(run, 50), time_ms(plain, 20), graph_ms(run)
    one_ms = time_ms(lambda: fk.decode_attention(q, k, v, kv_len=kv), 50)
    visible = B * (n - off)
    nbytes = (2 * visible * Hkv * D * 2 + q.numel() * 2 + m.numel() * 4 * 2
              + B * Hq * (D + 1) * 4 + 8 * B)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  D1 split (max + partial) at the full-width step's shard (B "
          f"{B}, {Hq}/{Hkv}, D {D}, 288 of {S} at offset {off}, "
          f"{n - off} visible a row, bf16): {ms:.4f} ms (graph "
          f"{g_ms:.4f}; bound {bound_ms:.5f}, plain {plain_ms:.3f}; "
          f"one-device D1 on the whole cache {one_ms:.4f})")
    return {"name": "decode_attention split (max + partial, a rank's "
                    "shard of the decode cache)",
            "route": "cuda", "source": D1_SPLIT_SRC,
            "replaces": "src/repro/kernels/flash_attention/ops.py:212 "
                        "(array code, no Pallas kernel; GSPMD splits it "
                        "over the cache's sequence)",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None, "graph_ms": g_ms, "one_device_d1_ms": one_ms,
            "card": card,
            "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "D": D, "shard": S - off,
                      "offset": off, "kv_len": n, "dtype": "bfloat16"}}


def _serve_smoke_inputs() -> tuple:
    """Each SMOKE case's global params (CPU, seed 0, f32), prompt and
    decode tokens (numpy seed 0), and the card's one-device run: prefill
    logits and bf16 cache (CPU), the decode steps' logits from that
    cache."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_smoke
    from repro_torch.models import model as M
    inputs, want = {}, {}
    for name, (arch, _, B, dispatch) in MESH_SERVE_SMOKE.items():
        cfg = dataclasses.replace(get_smoke(arch), policy="f32")
        params = M.init_params(cfg, seed=0, device="cpu",
                               param_dtype=torch.float32)
        rng = np.random.default_rng(0)
        prompt = rng.integers(0, cfg.vocab_size, (B, MESH_SERVE_PROMPT))
        toks = [rng.integers(0, cfg.vocab_size, (B, 1))
                for _ in range(MESH_SERVE_STEPS)]
        prompt, toks = prompt.astype(np.int32), [t.astype(np.int32)
                                                 for t in toks]
        p = _tree_to(params, "cuda")
        with no_plain():
            logits, cache, pos = M.prefill(p, torch.from_numpy(prompt).cuda(),
                                           cfg, max_seq=MESH_SERVE_MAX,
                                           dispatch=dispatch)
            start = tree.map(lambda t: t.to("cpu", copy=True), cache)
            steps_, counts = [], [_moe_counts(start)]
            for t in toks:
                lg, cache = M.decode_step(p, cfg, cache, pos,
                                          torch.from_numpy(t).cuda(),
                                          dispatch=dispatch)
                steps_.append(lg.cpu())
                counts.append(_moe_counts(cache))
                pos += 1
        inputs[name] = {"params": params, "prompt": prompt, "decode": toks,
                        "cache": start, "pos": MESH_SERVE_PROMPT}
        want[name] = {"prefill": (logits.cpu(), start), "decode": steps_,
                      "cache": tree.map(lambda t: t.cpu(), cache),
                      "counts": counts}
    return inputs, want


def _moe_counts(cache) -> list:
    """The ``moe`` counts of every attn+moe slot of a decode cache, on the
    CPU, copies (none for a dense config)."""
    return [slot["moe"].to("cpu", copy=True) for slot in cache["slots"]
            if "moe" in slot]


def _serve_smoke_run(name, inp, mesh) -> dict:
    """One SMOKE case on this rank: the prefill (B > 1) and the decode
    steps from the one-device cache's part; launches of each (set to 0
    just before, read just after); the parts and the MoE counts after
    each step on the CPU."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.parallel import sharding as S
    arch, _, B, dispatch = MESH_SERVE_SMOKE[name]
    cfg = dataclasses.replace(get_smoke(arch), policy="f32")
    shape = ShapeSpec("smoke", "decode", MESH_SERVE_MAX, B)
    serve, (p_specs, c_specs, _, _), _ = steps.make_serve_step(
        cfg, shape, mesh, moe_dispatch=dispatch)
    local = _tree_to(S.local_tree(inp["params"], p_specs, mesh), "cuda")
    out = {"launches": {}, "counts": []}
    with no_plain():
        if B > 1:
            prefill, _, _ = steps.make_prefill_step(cfg, shape, mesh,
                                                    moe_dispatch=dispatch)
            torch.cuda.synchronize()
            reset_launches()
            logits, cache, st = prefill(local, torch.from_numpy(
                inp["prompt"]).cuda())
            torch.cuda.synchronize()
            out["launches"]["prefill"] = read_launches()
            out["prefill"] = (logits.cpu(), _tree_to(cache, "cpu"), int(st))
        cache = _tree_to(S.local_tree(inp["cache"], c_specs, mesh), "cuda")
        pos, out["decode"] = inp["pos"], []
        for i, tok in enumerate(inp["decode"]):
            torch.cuda.synchronize()
            reset_launches()
            nxt, logits, cache = serve(local, cache, pos,
                                       torch.from_numpy(tok).cuda())
            torch.cuda.synchronize()
            out["launches"].setdefault("step", read_launches())
            out["decode"].append((nxt.cpu(), logits.cpu()))
            out["counts"].append(_moe_counts(cache))
            pos += 1
        out["cache"] = _tree_to(cache, "cpu")
    n = cfg.n_layers
    n_moe = cfg.n_repeats * cfg.block_unit.count("attn+moe")
    k2 = n_moe if dispatch == "bcsr" else 0
    check(out["launches"]["step"] == only(
        decode_attention_max=n, decode_attention_partial=n,
        router_logits=decode_norms(cfg) + n_moe, spmm_bcsr=k2),
        f"serve mesh {name}: a step's launches {out['launches']['step']}")
    if B > 1:
        check(out["launches"]["prefill"] == only(router_logits=n_moe,
                                                 spmm_bcsr=k2),
              f"serve mesh {name}: prefill launches "
              f"{out['launches']['prefill']}")
    return out


def _serve_mesh_rank(rank: int, world: int, smoke, full, moe_full) -> dict:
    """One rank of phase_serve_mesh on ``cuda:0`` (which all ranks share):
    (b) the SMOKE cases (:func:`_serve_smoke_run`); (c) qwen3-1.7b at full
    width and MESH_SERVE_DEPTH layers on the (2, 2) mesh: this rank's part
    of the bf16
    params drawn on the card, the prefill (impl "kernel") of the global
    4 x 512 prompt, then MESH_SERVE_GEN decode steps on ``full``'s
    teacher-forced tokens; the launches of the prefill and of step 1 (each
    set to 0 just before and read just after), seconds of each (host
    clock from a barrier, synchronised), the held and peak GB, and the
    last step run again with every collective synchronised and timed;
    (d) llama4-scout at full width (:func:`_serve_moe_full_rank`)."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shapes import ShapeSpec
    torch.cuda.set_device(0)
    missing = [n for n in ("flash_attention", "decode_attention", "router",
                           "spmm_bcsr")
               if not build.library_path(n).is_file()]
    check(not missing, f"rank {rank}: {missing} not built before the spawn")
    t_start = time.monotonic()
    meshes = {name: make_mesh(shape, names, "cuda", timeout=SHARDED_TIMEOUT)
              for name, (shape, names) in MESHES.items()}
    out = {"rank": rank, "smoke": {}}
    for name, inp in smoke.items():
        out["smoke"][name] = _serve_smoke_run(
            name, inp, meshes[MESH_SERVE_SMOKE[name][1]])
    smoke_s = time.monotonic() - t_start
    cfg = _mesh_qwen_cfg()
    mesh = meshes["data_model"]
    shape = ShapeSpec("mesh", "decode", MESH_SERVE_CAP, MESH_SERVE_BATCH)
    prefill, (p_specs, _, _), _ = steps.make_prefill_step(
        cfg, shape, mesh, impl="kernel")
    serve, _, _ = steps.make_serve_step(cfg, shape, mesh)
    local = _mesh_full_params(rank, world, cfg, p_specs, mesh,
                              torch.bfloat16)
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    res = {"seconds": [], "logits": [], "tokens": []}
    prompt = torch.from_numpy(full["prompt"]).cuda()
    with no_plain():
        torch.cuda.synchronize()
        dist.barrier()
        reset_launches()
        t0 = time.perf_counter()
        logits, cache, st = prefill(local, prompt)
        torch.cuda.synchronize()
        res["prefill_s"] = time.perf_counter() - t0
        res["prefill_launches"] = read_launches()
        res["prefill_logits"] = logits.cpu()
        pos = int(st)
        for i, tok in enumerate(full["tokens"]):
            tok = torch.from_numpy(tok).cuda()
            torch.cuda.synchronize()
            dist.barrier()
            if i == 0:
                reset_launches()
            t0 = time.perf_counter()
            nxt, logits, cache = serve(local, cache, pos, tok)
            torch.cuda.synchronize()
            res["seconds"].append(time.perf_counter() - t0)
            if i == 0:
                res["step_launches"] = read_launches()
            res["logits"].append(logits.cpu())
            res["tokens"].append(nxt.cpu())
            pos += 1
        log = []
        # the last step again, its collectives synchronised and timed (the
        # cache's write at that slot is the same write)
        dist.barrier()
        with _timed_collectives(log):
            serve(local, cache, pos - 1, tok)
    res["collectives"] = {
        op: [sum(1 for n_, _, _ in log if n_ == op),
             sum(b for n_, b, _ in log if n_ == op) / 1e9,
             sum(s for n_, _, s in log if n_ == op)] for op in COLLECTIVES}
    res.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               held_gb=held_gb,
               cache_gb=sum(t.numel() * t.element_size()
                            for t in tree.leaves(cache)) / 1e9)
    n = cfg.n_layers
    check(res["prefill_launches"] == only(flash_attention=n),
          f"rank {rank} serve mesh prefill: launches "
          f"{res['prefill_launches']}, want K3 {n}")
    check(res["step_launches"] == only(
        decode_attention_max=n, decode_attention_partial=n,
        router_logits=decode_norms(cfg)),
        f"rank {rank} serve mesh step: launches {res['step_launches']}")
    del local, cache
    gc.collect()
    torch.cuda.empty_cache()
    full_s = time.monotonic() - t_start - smoke_s
    out["moe_full"] = _serve_moe_full_rank(rank, world, mesh, moe_full)
    out.update(full=res, seconds={"smoke": smoke_s, "full": full_s,
                                  "total": time.monotonic() - t_start})
    return out


def _serve_full_one_device() -> dict:
    """qwen3-1.7b at full width and MESH_SERVE_DEPTH layers on one
    device, bf16 weights
    from ``init_params(seed=0)``: the prefill (impl "kernel") of a 4 x 512
    prompt (numpy seed 47) at max_seq 576, then MESH_SERVE_GEN greedy
    decode steps; the prompt, the tokens each step was fed, each step's
    last-position logits (CPU), the seconds, the peak GB; the params freed
    after."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    cfg = _mesh_qwen_cfg()
    params = M.init_params(cfg, seed=0, device="cuda")
    prompt = np.random.default_rng(47).integers(
        0, cfg.vocab_size, (MESH_SERVE_BATCH, MESH_SERVE_SEQ)).astype(
        np.int32)
    torch.cuda.reset_peak_memory_stats()
    out = {"prompt": prompt, "tokens": [], "logits": [], "seconds": []}
    with no_plain():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, pos = M.prefill(params, torch.from_numpy(prompt)
                                       .cuda(), cfg, max_seq=MESH_SERVE_CAP,
                                       impl="kernel")
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_logits"] = logits.cpu()
        for _ in range(MESH_SERVE_GEN):
            tok = logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
            out["tokens"].append(tok.to(torch.int32).cpu().numpy())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = M.decode_step(params, cfg, cache, pos, tok)
            torch.cuda.synchronize()
            out["seconds"].append(time.perf_counter() - t0)
            out["logits"].append(logits.cpu())
            pos += 1
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _margin_check(got, want, vocab: int, tol: float, what: str):
    """(the largest |got - want| of (B, 1, V) logits, the rows whose
    one-device top-2 margin exceeds ``tol``, the tokens that differ among
    them and elsewhere): the error within ``tol``, and the greedy tokens
    equal wherever the margin exceeds it (a mismatch elsewhere is counted
    and printed)."""
    import torch
    err = (got - want).abs().max().item()
    check(err <= tol, f"{what}: logits off by {err} > {tol}")
    top2 = want[:, -1, :vocab].topk(2).values
    clear = top2[:, 0] - top2[:, 1] > tol
    a = got[:, -1, :vocab].argmax(-1)
    b = want[:, -1, :vocab].argmax(-1)
    check(torch.equal(a[clear], b[clear]),
          f"{what}: a greedy token differs where the margin exceeds {tol}")
    return err, int(clear.sum()), int((a != b).sum())


def _mesh_qwen_cfg():
    """qwen3-1.7b at full width, cut to MESH_SERVE_DEPTH layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(TRAIN_ARCH),
                               n_repeats=MESH_SERVE_DEPTH)


def _mesh_moe_cfg():
    """llama4-scout at full width, cut to MESH_MOE_DEPTH layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(SCOUT_ARCH),
                               n_repeats=MESH_MOE_DEPTH)


@contextlib.contextmanager
def _moe_spies(routes: list, calls: dict):
    """While on: the expert ids and router logits of each
    ``models.moe.route_tokens`` call appended to ``routes`` (on the device,
    one ((B, S), (B, S, E)) pair an attn+moe layer; :func:`_routes_cpu`
    copies them after the timed pass), and the first K2 stream call
    (``engine.spmm_batched_stream``) and the first router call
    (``moe.router_logits``) kept in ``calls`` as "k2" and "r1"."""
    from repro_torch.kernels import engine
    from repro_torch.models import moe
    route, stream, router = (moe.route_tokens, engine.spmm_batched_stream,
                             moe.router_logits)

    def route_spy(*args, **kw):
        r = route(*args, **kw)
        routes.append((r.expert_id, r.logits))
        return r

    def stream_spy(a, dense, **kw):
        calls.setdefault("k2", (a, dense, kw))
        return stream(a, dense, **kw)

    def router_spy(x, w):
        calls.setdefault("r1", ((x, w), {}))
        return router(x, w)

    moe.route_tokens, engine.spmm_batched_stream, moe.router_logits = (
        route_spy, stream_spy, router_spy)
    try:
        yield
    finally:
        moe.route_tokens, engine.spmm_batched_stream, moe.router_logits = (
            route, stream, router)


def _routes_cpu(routes: list) -> list:
    """:func:`_moe_spies`' routes on the CPU: (expert ids, one device's
    top-2 router gap) a layer."""
    out = []
    for ids, logits in routes:
        top2 = logits.float().topk(2, dim=-1).values
        out.append((ids.cpu(), (top2[..., 0] - top2[..., 1]).cpu()))
    return out


def _stream_to(a, device):
    """A BatchedBCSR stream's tensors on ``device``."""
    return dataclasses.replace(a, **{f: getattr(a, f).to(device) for f in (
        "indptr", "block_rows", "block_cols", "blocks")})


def _serve_moe_full_rank(rank: int, world: int, mesh, full) -> dict:
    """(d) on this rank: llama4-scout at full width and MESH_MOE_DEPTH
    layers on the (2, 2) mesh, bf16, impl "kernel", bcsr dispatch: its
    part of the params drawn on the card, the prefill of the global 4 x
    256 prompt, then MESH_MOE_GEN decode steps on ``full``'s tokens; a
    pass's launches (set to 0 just before, read just after), seconds (host
    clock from a barrier, synchronised), last-position logits, expert ids
    a layer and MoE counts after it; the last step run again with every
    collective synchronised and timed; held and peak GB; rank 0 also
    returns its first K2 stream call and first router call (CPU) for the
    kernels line."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import ShapeSpec
    cfg = _mesh_moe_cfg()
    shape = ShapeSpec("mesh", "decode", MESH_MOE_CAP, MESH_MOE_BATCH)
    prefill, (p_specs, _, _), _ = steps.make_prefill_step(
        cfg, shape, mesh, impl="kernel", moe_dispatch="bcsr")
    serve, _, _ = steps.make_serve_step(cfg, shape, mesh,
                                        moe_dispatch="bcsr")
    local = _mesh_full_params(rank, world, cfg, p_specs, mesh,
                              torch.bfloat16)
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    res = {"seconds": [], "logits": [], "launches": [], "routes": [],
           "counts": []}
    calls, log = {}, []
    inputs = [torch.from_numpy(full["prompt"]).cuda()] + [
        torch.from_numpy(t).cuda() for t in full["tokens"]]
    cache, pos = None, None
    with no_plain():
        for i, tok in enumerate(inputs):
            routes = []
            torch.cuda.synchronize()
            dist.barrier()
            reset_launches()
            t0 = time.perf_counter()
            with _moe_spies(routes, calls):
                if i == 0:
                    logits, cache, st = prefill(local, tok)
                    pos = int(st)
                else:
                    _, logits, cache = serve(local, cache, pos, tok)
                    pos += 1
                torch.cuda.synchronize()
            res["seconds"].append(time.perf_counter() - t0)
            res["launches"].append(read_launches())
            res["logits"].append(logits[:, -1:].cpu())
            res["routes"].append(_routes_cpu(routes))
            res["counts"].append(_moe_counts(cache))
        # the last step again, its collectives synchronised and timed (its
        # logits and counts are read above; the counts it adds again are
        # not read)
        dist.barrier()
        with _timed_collectives(log):
            serve(local, cache, pos - 1, tok)
    res["collectives"] = {
        op: [sum(1 for n_, _, _ in log if n_ == op),
             sum(b for n_, b, _ in log if n_ == op) / 1e9,
             sum(s for n_, _, s in log if n_ == op)] for op in COLLECTIVES}
    res.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               held_gb=held_gb)
    n = cfg.n_layers
    n_moe = cfg.n_repeats * cfg.block_unit.count("attn+moe")
    check(res["launches"][0] == only(flash_attention=n, router_logits=n_moe,
                                     spmm_bcsr=n_moe),
          f"rank {rank} serve mesh {SCOUT_ARCH} prefill: launches "
          f"{res['launches'][0]}")
    for i, got in enumerate(res["launches"][1:]):
        check(got == only(decode_attention_max=n, decode_attention_partial=n,
                          router_logits=decode_norms(cfg) + n_moe,
                          spmm_bcsr=n_moe),
              f"rank {rank} serve mesh {SCOUT_ARCH} step {i}: launches "
              f"{got}")
    if rank == 0:
        a, dense, kw = calls["k2"]
        (x, w), _ = calls["r1"]
        res["calls"] = {"k2": (_stream_to(a, "cpu"), dense.cpu(), kw),
                        "r1": ((x.cpu(), w.cpu()), {})}
    del local, cache, calls
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _serve_moe_full_one_device() -> dict:
    """(d) on one device: llama4-scout at full width and MESH_MOE_DEPTH
    layers, bf16 weights from ``init_params(seed=0)``, the prefill (impl
    "kernel", bcsr) of a 4 x 256 prompt (numpy seed 48) at max_seq 320,
    then MESH_MOE_GEN greedy decode steps; the prompt, the tokens fed,
    each pass's last-position logits, expert ids a layer and MoE counts
    (CPU), its seconds, the peak GB; the params freed after."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    cfg = _mesh_moe_cfg()
    params = M.init_params(cfg, seed=0, device="cuda")
    prompt = np.random.default_rng(48).integers(
        0, cfg.vocab_size, (MESH_MOE_BATCH, MESH_MOE_SEQ)).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    out = {"prompt": prompt, "tokens": [], "logits": [], "seconds": [],
           "routes": [], "counts": []}
    with no_plain():
        for i in range(MESH_MOE_GEN + 1):
            routes = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _moe_spies(routes, {}):
                if i == 0:
                    logits, cache, pos = M.prefill(
                        params, torch.from_numpy(prompt).cuda(), cfg,
                        max_seq=MESH_MOE_CAP, impl="kernel",
                        dispatch="bcsr")
                else:
                    logits, cache = M.decode_step(params, cfg, cache, pos,
                                                  tok, dispatch="bcsr")
                    pos += 1
                torch.cuda.synchronize()
            out["seconds"].append(time.perf_counter() - t0)
            out["logits"].append(logits[:, -1:].cpu())
            out["routes"].append(_routes_cpu(routes))
            out["counts"].append(_moe_counts(cache))
            if i < MESH_MOE_GEN:
                tok = logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
                out["tokens"].append(tok.to(torch.int32).cpu().numpy())
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _serve_moe_full_compare(per_rank, one, card) -> tuple:
    """(d)'s checks and numbers from the ranks' runs and one device's:
    expert flips a pass and layer (a token routed to another expert than
    on one device; the ranks of one data row route the same whole rows),
    each new flip a near-tie on one device (top-2 router gap within
    MESH_MOE_GAP), the counts' largest difference within the flips so
    far; the last-position logits within MESH_MOE_TOL and the tokens past
    the margin in every row whose last position did not flip (at least
    one); then K2 and R1 at rank 0's first prefill calls (the kernels
    line's mesh rows).  Returns (the rows, the summary)."""
    import torch
    from repro_torch.parallel import sharding as S
    cfg = _mesh_moe_cfg()
    mesh = S.MeshShape(("data", "model"), (2, 2))
    coords = [S.rank_coords(mesh, r) for r in range(len(per_rank))]
    runs = [pr["moe_full"] for pr in per_rank]
    flips, flip_gaps, count_diff, errs, clear, differ, excluded = (
        [], [], [], [], [], [], [])
    n_flips = 0
    for i in range(MESH_MOE_GEN + 1):
        per_layer, moved_before = [], None
        for j, (want, gap) in enumerate(one["routes"][i]):
            got = torch.cat([r["routes"][i][j][0] for r, c in zip(runs, coords)
                             if c["model"] == 0])
            for r, c in zip(runs, coords):
                check(torch.equal(r["routes"][i][j][0], got[
                    2 * c["data"]:2 * c["data"] + 2]),
                      f"serve mesh {SCOUT_ARCH}: the ranks of a data row "
                      f"routed pass {i} layer {j} differently")
            moved = got != want
            fresh = moved if moved_before is None else moved & ~moved_before
            if fresh.any():
                worst = gap[fresh].max().item()
                flip_gaps.append(worst)
                check(worst <= MESH_MOE_GAP,
                      f"serve mesh {SCOUT_ARCH} pass {i} layer {j}: a token "
                      f"took another expert with a one-device top-2 router "
                      f"gap of {worst} > {MESH_MOE_GAP}")
            moved_before = moved if moved_before is None else \
                moved_before | moved
            per_layer.append(int(moved.sum()))
        flips.append(per_layer)
        n_flips += sum(per_layer)
        for r in runs[1:]:
            check(all(torch.equal(a, b) for a, b in zip(
                r["counts"][i], runs[0]["counts"][i])),
                  f"serve mesh {SCOUT_ARCH}: the replicated counts differ")
        count_diff.append(max(int((a - b).abs().max()) for a, b in zip(
            runs[0]["counts"][i], one["counts"][i])))
        check(count_diff[-1] <= n_flips,
              f"serve mesh {SCOUT_ARCH} pass {i}: the counts differ by "
              f"{count_diff[-1]}, more than the {n_flips} flips so far")
        lg = S.assemble([r["logits"][i] for r in runs],
                        S.P("data", None, "model"), mesh)
        keep = ~moved_before[:, -1]
        excluded.append(int((~keep).sum()))
        check(bool(keep.any()), f"serve mesh {SCOUT_ARCH} pass {i}: every "
              "row's last position took another expert; no row compared")
        err_all = (lg - one["logits"][i]).abs().max().item()
        err, n_clear, n_diff = _margin_check(
            lg[keep], one["logits"][i][keep], cfg.vocab_size,
            MESH_MOE_TOL, f"serve mesh {SCOUT_ARCH} pass {i}")
        errs.append([err, err_all])
        clear.append(n_clear)
        differ.append(n_diff)
    k2_launches = sum(r["launches"][p]["spmm_bcsr"] for r in runs
                      for p in range(MESH_MOE_GEN + 1))
    r1_launches = sum(r["launches"][p]["router_logits"] for r in runs
                      for p in range(MESH_MOE_GEN + 1))
    a, dense, kw = runs[0]["calls"]["k2"]
    k2 = _stream_times((_stream_to(a, "cuda"), dense.cuda(), kw),
                       f"mesh {SCOUT_ARCH} rank 0 prefill")
    (x, w), _ = runs[0]["calls"]["r1"]
    r1 = _router_times(((x.cuda(), w.cuda()), {}),
                       f"mesh {SCOUT_ARCH} rank 0 prefill")
    note = ("4 gloo ranks share one card: no multi-card speedup; the call "
            "is rank 0's first of its prefill, on its 2 rows and ")
    rows = [{"name": f"spmm_bcsr mesh {SCOUT_ARCH} (a rank's dispatch "
                     "stream)", "route": "cuda",
             "source": "src/repro_torch/kernels/spmm/csrc/spmm_bcsr.cu",
             "replaces": "src/repro/kernels/spmm/kernel.py:74",
             "launches": k2_launches, **k2, "card": card,
             "note": note + "8 of 16 experts"},
            {"name": f"router_logits mesh {SCOUT_ARCH} (a rank's whole "
                     "rows)", "route": "cuda",
             "source": "src/repro_torch/kernels/router/csrc/router.cu",
             "replaces": "src/repro/models/moe.py:232 (array code, no "
                         "Pallas kernel)",
             "launches": r1_launches, **r1, "card": card,
             "note": note + "all 16 experts"}]
    coll_s = [sum(r["collectives"][op][2] for op in COLLECTIVES)
              for r in runs]
    summary = dict(
        arch=SCOUT_ARCH, layers=cfg.n_layers, batch=MESH_MOE_BATCH,
        prompt=MESH_MOE_SEQ, max_seq=MESH_MOE_CAP, steps=MESH_MOE_GEN,
        tol=MESH_MOE_TOL, logit_errs=errs, rows_excluded=excluded,
        rows_past_margin=clear, tokens_differ=differ,
        expert_flips=flips, flip_gaps=flip_gaps, gap_bound=MESH_MOE_GAP,
        count_max_diff=count_diff,
        launches=[r["launches"] for r in runs],
        peak_gb=[r["peak_gb"] for r in runs],
        held_gb=[r["held_gb"] for r in runs],
        seconds=[r["seconds"] for r in runs], collective_s=coll_s,
        collectives=[r["collectives"] for r in runs],
        one_device={k: one[k] for k in ("seconds", "peak_gb")})
    print(f"  serve mesh {SCOUT_ARCH} at full width ({cfg.n_layers} of 48 "
          f"layers, (2, 2) mesh, bf16, impl kernel, bcsr, "
          f"{MESH_MOE_BATCH} x {MESH_MOE_SEQ}, max_seq {MESH_MOE_CAP}, "
          f"{MESH_MOE_GEN} steps teacher-forced): expert flips a pass and "
          f"layer {flips}, the largest one-device top-2 router gap of a "
          f"new flip {[round(g, 5) for g in flip_gaps]} (bound "
          f"{MESH_MOE_GAP}), counts' largest difference {count_diff}; "
          f"last-position logits vs one device, compared rows / all rows: "
          f"{[[round(e, 4) for e in p] for p in errs]} (tol {MESH_MOE_TOL};"
          f" rows whose last position flipped {excluded}); rows past the "
          f"margin {clear}, tokens that differ {differ}; K2 / R1 {k2_launches}"
          f" / {r1_launches} launches over the ranks; peak GB a rank "
          f"{', '.join('%.2f' % r['peak_gb'] for r in runs)} (held "
          f"{runs[0]['held_gb']:.2f}; one device {one['peak_gb']:.2f}); "
          f"s a pass a rank {[[round(x, 3) for x in r['seconds']] for r in runs]}"
          f" (one device {[round(x, 4) for x in one['seconds']]}); the "
          f"last step's collectives s a rank {[round(x, 3) for x in coll_s]}"
          f" (gloo over loopback, each synchronised)")
    return rows, summary


def phase_serve_mesh(card):
    """The serving steps on a mesh (``launch.steps.make_prefill_step`` /
    ``make_serve_step``) on SHARDED_RANKS gloo ranks that share the card:
    (a) D1's split mode against its plain version, its order and
    one-device D1 (:func:`phase_split_decode_vs_plain`); the one-device
    runs here, then the ranks (:func:`_serve_mesh_rank`): (b) qwen3-1.7b
    and gemma3-12b SMOKE in f32 on (2, 2), qwen3 on (1, 2, 2), a prefill
    and three decode steps, and qwen3 serving at B 1 (the cache's
    sequence over "data") from a one-device prefill cut by
    ``sharding.local_tree``, against the one-device steps; (c)
    qwen3-1.7b at full width, MESH_SERVE_DEPTH layers, bf16, (2, 2), impl
    "kernel": the
    logits against one device's within MESH_SERVE_FULL_TOL at every step,
    the greedy tokens equal where one device's top-2 margin exceeds it,
    K3 once a layer a rank in prefill and the split D1 twice a layer a
    rank a step, peak / held GB, prefill and step seconds and the
    seconds in collectives a rank (gloo through host memory and loopback,
    not NVLink: no multi-card speedup is measured).  (b) also runs
    llama4-scout and llama4-maverick SMOKE with the pjit MoE on (2, 2),
    gather and bcsr (counts equal one device's, bcsr parts torch.equal to
    gather's); (d) llama4-scout at full width and depth 2 with bcsr
    (:func:`_serve_moe_full_compare`).  Returns (the split D1's row and
    the mesh K2 and R1 rows, a summary)."""
    from repro_torch import tree
    from repro_torch.configs import get_smoke
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel.ranks import run_ranks
    import torch
    t0 = time.monotonic()
    err_plain = phase_split_decode_vs_plain()
    smoke, want = _serve_smoke_inputs()
    one = _serve_full_one_device()
    moe_one = _serve_moe_full_one_device()
    one_s = time.monotonic() - t0
    per_rank = run_ranks(_serve_mesh_rank, SHARDED_RANKS, smoke,
                         {"prompt": one["prompt"], "tokens": one["tokens"]},
                         {"prompt": moe_one["prompt"],
                          "tokens": moe_one["tokens"]},
                         timeout=SHARDED_TIMEOUT, limit=MESH_SERVE_LIMIT)
    summary = {"smoke": {}, "card": card}
    for name, (arch, mesh_name, B, _) in MESH_SERVE_SMOKE.items():
        cfg = dataclasses.replace(get_smoke(arch), policy="f32")
        shape, names = MESHES[mesh_name]
        mesh = S.MeshShape(names, shape)
        sshape = ShapeSpec("smoke", "decode", MESH_SERVE_MAX, B)
        _, (_, c_specs, _, tok_spec), _ = steps.make_serve_step(cfg, sshape,
                                                                mesh)
        l_spec = S.P(tok_spec[0], None, "model")
        runs = [pr["smoke"][name] for pr in per_rank]
        row = {"decode_errs": [], "tokens_differ": 0}
        counts = [_moe_counts(r["prefill"][1]) if B > 1 else None
                  for r in runs]
        for i, got in enumerate([counts] + [[r["counts"][j] for r in runs]
                                            for j in range(MESH_SERVE_STEPS)]):
            if got[0] is not None:
                check(all(torch.equal(a, b) for g in got for a, b in zip(
                    g, want[name]["counts"][i])),
                      f"serve mesh {name}: the MoE counts after pass {i}")
        if name in MESH_SERVE_BCSR:
            for r, g in zip(runs, per_rank):
                gather = g["smoke"][MESH_SERVE_BCSR[name]]
                check(all(torch.equal(a, b) for a, b in zip(
                    tree.leaves((r["prefill"][:2], r["decode"], r["counts"],
                                 r["cache"])),
                    tree.leaves((gather["prefill"][:2], gather["decode"],
                                 gather["counts"], gather["cache"])))),
                      f"serve mesh {name}: a rank's parts != gather's")
            row["equal_to_gather"] = True
        if B > 1:
            lg = S.assemble([r["prefill"][0] for r in runs], l_spec, mesh)
            err = (lg - want[name]["prefill"][0]).abs().max().item()
            check(err <= MESH_SERVE_LOGIT_TOL,
                  f"serve mesh {name}: prefill logits {err}")
            check({r["prefill"][2] for r in runs} == {MESH_SERVE_PROMPT},
                  f"serve mesh {name}: the next position")
            whole = S.assemble([r["prefill"][1] for r in runs], c_specs,
                               mesh)
            for a, b in zip(tree.leaves(whole),
                            tree.leaves(want[name]["prefill"][1])):
                a, b = a.float(), b.float()
                check(bool(((a - b).abs() <= 2.0 ** -7 * b.abs() + 1e-6
                            * b.abs().max()).all()),
                      f"serve mesh {name}: the prefill cache")
            row["prefill_err"] = err
        for i in range(MESH_SERVE_STEPS):
            lg = S.assemble([r["decode"][i][1] for r in runs], l_spec, mesh)
            S.assemble([r["decode"][i][0] for r in runs], tok_spec, mesh)
            err, _, differ = _margin_check(
                lg, want[name]["decode"][i], cfg.vocab_size,
                MESH_SERVE_BF16_TOL, f"serve mesh {name} step {i}")
            row["decode_errs"].append(err)
            row["tokens_differ"] += differ
        S.assemble([r["cache"] for r in runs], c_specs, mesh)
        summary["smoke"][name] = row
        step = runs[0]["launches"]["step"]
        print(f"  serve mesh {name} ({arch} smoke f32, {shape} mesh, B {B}"
              "): " + (f"prefill logits within {row['prefill_err']:.3g} of "
                       "one device, cache within one bf16 ulp; "
                       if B > 1 else "from the one-device prefill's cache, ")
              + f"{MESH_SERVE_STEPS} decode steps within "
              f"{max(row['decode_errs']):.3g} (tol {MESH_SERVE_BF16_TOL}); "
              f"split D1 x {step['decode_attention_max']} + "
              f"{step['decode_attention_partial']} a rank a step"
              + ("; MoE counts == one device's after every pass, R1 x "
                 f"{step['router_logits']}, K2 x {step['spmm_bcsr']} a rank "
                 "a step" if cfg.n_experts else "")
              + ("; every rank's parts == gather's"
                 if name in MESH_SERVE_BCSR else ""))
    cfg = _mesh_qwen_cfg()
    shape, names = MESHES["data_model"]
    mesh = S.MeshShape(names, shape)
    l_spec = S.P("data", None, "model")
    fulls = [pr["full"] for pr in per_rank]
    pairs = [("prefill", [f["prefill_logits"] for f in fulls],
              one["prefill_logits"])] + [
        (f"step {i}", [f["logits"][i] for f in fulls], one["logits"][i])
        for i in range(MESH_SERVE_GEN)]
    errs, clear, differ = zip(*(_margin_check(
        S.assemble(parts, l_spec, mesh), w, cfg.vocab_size,
        MESH_SERVE_FULL_TOL, f"serve mesh full {what}")
        for what, parts, w in pairs))
    split_launches = [f["step_launches"]["decode_attention_max"]
                      + f["step_launches"]["decode_attention_partial"]
                      for f in fulls]
    k3 = [f["prefill_launches"]["flash_attention"] for f in fulls]
    coll_s = [sum(f["collectives"][op][2] for op in COLLECTIVES)
              for f in fulls]
    row = _split_times(err_plain, sum(split_launches), card)
    moe_rows, summary["moe_full"] = _serve_moe_full_compare(per_rank,
                                                            moe_one, card)
    seconds = time.monotonic() - t0
    print(f"  serve mesh {TRAIN_ARCH} at full width "
          f"({cfg.n_layers} of 28 layers, (2, 2) mesh, bf16, impl kernel, "
          f"{MESH_SERVE_BATCH} x {MESH_SERVE_SEQ}, max_seq {MESH_SERVE_CAP}"
          f", {MESH_SERVE_GEN} steps teacher-forced): last-position logits "
          f"vs one device, prefill then each step: "
          f"{[round(x, 4) for x in errs]} (tol {MESH_SERVE_FULL_TOL}); rows"
          f" past the margin {list(clear)} of {MESH_SERVE_BATCH}, tokens "
          f"that differ {list(differ)}; K3 x {k3} a rank in prefill, split "
          f"D1 x {split_launches} a rank a step; peak GB a rank "
          f"{', '.join('%.2f' % f['peak_gb'] for f in fulls)} (held "
          f"{fulls[0]['held_gb']:.2f}, cache part "
          f"{fulls[0]['cache_gb']:.3f}; one device {one['peak_gb']:.2f});"
          f" prefill s a rank {[round(f['prefill_s'], 3) for f in fulls]} "
          f"(one device {one['prefill_s']:.3f}); step s a rank "
          f"{[[round(x, 3) for x in f['seconds']] for f in fulls]} (one "
          f"device {[round(x, 4) for x in one['seconds']]}); a step's "
          f"collectives s a rank {[round(x, 3) for x in coll_s]} (gloo over"
          f" loopback, each synchronised); phase {seconds:.1f} s (the "
          f"one-device runs and (a) {one_s:.1f})")
    summary.update(
        arch=TRAIN_ARCH, layers=cfg.n_layers, batch=MESH_SERVE_BATCH,
        prompt=MESH_SERVE_SEQ, max_seq=MESH_SERVE_CAP, steps=MESH_SERVE_GEN,
        logit_errs=list(errs), tol=MESH_SERVE_FULL_TOL,
        rows_past_margin=list(clear), tokens_differ=list(differ),
        k3_per_rank_prefill=k3,
        split_d1_per_rank_step=split_launches,
        peak_gb=[f["peak_gb"] for f in fulls],
        held_gb=[f["held_gb"] for f in fulls],
        cache_part_gb=[f["cache_gb"] for f in fulls],
        one_device={k: one[k] for k in ("prefill_s", "seconds",
                                        "peak_gb")},
        prefill_s=[f["prefill_s"] for f in fulls],
        step_s=[f["seconds"] for f in fulls], collective_s=coll_s,
        collectives=[f["collectives"] for f in fulls],
        rank_seconds=[pr["seconds"] for pr in per_rank],
        split_vs_plain_err=err_plain, seconds=seconds, one_device_s=one_s,
        note="4 gloo ranks share one card (collectives through host "
             "memory and loopback, not NVLink): no multi-card speedup; the "
             "last step is run again with every collective synchronised "
             "and timed")
    return [row] + moe_rows, summary


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (sets the numerics flags)

    t_start = time.monotonic()
    # the seconds from one mark to the next, a phase or a group of phases:
    # what the whole run's time limit is spent on
    marks = [("start", t_start)]
    mark = lambda name: marks.append((name, time.monotonic()))  # noqa: E731
    card = phase_card()
    phase_build()
    mark("build")
    print("sharded engine, 4 gloo ranks on the one card:")
    sharded_rows, sharded = phase_sharded_engine(card)
    mark("sharded engine")
    print("the multi-rank train step, 4 gloo ranks on the one card:")
    mesh_rows, train_mesh = phase_train_mesh(card)
    sharded_rows += mesh_rows
    gc.collect()
    torch.cuda.empty_cache()
    mark("train mesh")
    print("the serving steps on a mesh, 4 gloo ranks on the one card:")
    serve_rows, serve_mesh = phase_serve_mesh(card)
    sharded_rows += serve_rows
    gc.collect()
    torch.cuda.empty_cache()
    mark("serve mesh")
    print("kernel vs plain on the card:")
    phase_kernel_vs_plain()
    phase_attention_vs_plain()
    phase_decode_vs_plain()
    phase_library_vs_plain()
    phase_wkv_vs_plain()
    t0 = time.monotonic()
    phase_ssd_step_vs_plain()
    print(f"  M1 vs plain: {time.monotonic() - t0:.1f} s")
    mark("kernels vs plain")
    phase_small_config_card_vs_cpu()
    phase_rwkv_smoke_card_vs_cpu()
    phase_dense_smoke_card_vs_cpu()
    t0 = time.monotonic()
    phase_zamba_smoke_card_vs_cpu()
    print(f"  zamba2 smoke card vs cpu: {time.monotonic() - t0:.1f} s")
    mark("smoke configs card vs cpu")
    print("training:")
    train, rows = phase_train(card)
    rows = sharded_rows + rows
    gc.collect()
    torch.cuda.empty_cache()
    mark("train")

    def scout_only(cfg, params, scheduler, clean):
        """Scout's phases that no other MoE arch runs, on its weights."""
        quant = phase_quant_serving(cfg, params, next(
            r for r in scheduler["runs"] if r["label"] == "fused_gather0"))
        mark(f"{SCOUT_ARCH} quantized")
        resilience = phase_resilience(cfg, params, clean,
                                      scheduler["step_syncs"], card)
        mark(f"{SCOUT_ARCH} resilience")
        bench = {"serve": phase_bench_serve(cfg, params),
                 "moe": phase_bench_moe()}
        mark("bench")
        return quant, resilience, bench

    scout, scout_rows, (quant, resilience, bench) = serve_moe(
        SCOUT_ARCH, card, mark, between=scout_only)
    rows += scout_rows
    del scout_rows
    scout["quantized"] = quant
    maverick, mav_rows, _ = serve_moe(
        MAVERICK_ARCH, card, mark, tag=f" E128 {MAVERICK_ARCH}")
    rows += mav_rows
    del mav_rows
    rwkv, rwkv_launches, wkv_inputs, step_inputs = phase_rwkv_serving(card)
    resilience["rwkv"] = rwkv["scheduler"].pop("resilience")
    rows.append(phase_measure_wkv(wkv_inputs, rwkv_launches["wkv_kernel"],
                                  card))
    rows.append(phase_measure_wkv_step(step_inputs, rwkv_launches, rows,
                                       card))
    del wkv_inputs, step_inputs
    gc.collect()
    torch.cuda.empty_cache()
    mark("rwkv6-7b")
    gemma, gemma_qkv, gemma_calls, gemma_launches = phase_gemma_serving(card)
    print("gemma3-12b kernel times at its served shapes (D 256):")
    rows += phase_measure_gemma(gemma_qkv, gemma_calls, gemma_launches,
                                card)
    del gemma_qkv, gemma_calls
    mark("gemma3-12b")
    dense, frontend = {}, {}
    for arch in DENSE_ARCHS + FRONTEND_ARCHS:
        into = frontend if arch in FRONTEND_ARCHS else dense
        into[arch], d_qkv, d_call, d_launches = phase_dense_serving(arch,
                                                                    card)
        print(f"{arch} kernel times at its served shapes:")
        rows += phase_measure_dense(arch, d_qkv, d_call, d_launches, card)
        del d_qkv, d_call
        mark(arch)
    zamba, z_qkv, z_d1, z_m1, z_launches = phase_zamba_serving(card)
    print(f"{ZAMBA_ARCH} kernel times at its served shapes:")
    t0 = time.monotonic()
    rows += phase_measure_zamba(z_qkv, z_d1, z_m1, z_launches, card)
    zamba["measure_s"] = time.monotonic() - t0
    print(f"  {ZAMBA_ARCH} kernel times: {zamba['measure_s']:.1f} s")
    del z_qkv, z_d1, z_m1
    mark(ZAMBA_ARCH)
    lib_data, lib_counts, lib_info = phase_library()
    print("library kernel times at the slice's sizes:")
    clocks = {"before_library_kernels": smi(CLOCKS)}
    rows += phase_measure_library(lib_data, lib_counts, lib_info, card)
    clocks["after_library_kernels"] = smi(CLOCKS)
    print(f"  sm clock, max: {clocks['before_library_kernels']} before, "
          f"{clocks['after_library_kernels']} after")
    del lib_data
    mark("library")
    phase_s = {name: t - marks[i][1]
               for i, (name, t) in enumerate(marks[1:])}
    print("seconds a phase: " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in phase_s.items()))
    scout["pipelined"]["rwkv"] = rwkv.pop("depth1")
    serve = {"serve": scout,
             "maverick": maverick,
             "rwkv": rwkv, "gemma": gemma, "dense": dense,
             "frontend": frontend, "zamba": zamba, "train": train,
             "sharded_engine": sharded, "train_mesh": train_mesh,
             "serve_mesh": serve_mesh,
             "library": lib_info,
             "sm_clocks": clocks, "phase_s": phase_s,
             "wall_s": time.monotonic() - t_start}
    print(json.dumps({"kernels": rows}))
    print(json.dumps(serve))
    print(json.dumps({"resilience": resilience}))
    print(json.dumps({"bench": bench}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
