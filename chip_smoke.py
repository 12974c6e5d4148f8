#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, one card

It builds the nine hand-written CUDA kernels from `src/repro_torch/
kernels/csrc/` and then runs these phases, one output line per step:

  device   the card's name and power limit (as nvidia-smi gives them),
           the kernels' build time, and the flash library's SASS per
           kernel (`cuobjdump -sass`: HGMMA, HMMA and FFMA counts, with
           registers and local memory from `--dump-resource-usage`):
           the run fails unless every bfloat16 and float32 instance runs
           on the tensor cores (HGMMA or HMMA); and the paged kernels the
           attention phase runs (split walk bf16 and f32 at hd 128 with 4
           query heads a KV head, and the merge): registers, local
           memory, LDG / LDGSTS counts and the LDG issued before their
           first use;
  small    FD and R-MAT at 2^10 on the card against the port's CPU path,
           which also loads every library before anything is timed;
  attention the attention entry points of `kernels.ops` at Granite-8B's
           width (configs/granite_8b.py: 32 query heads, 8 KV heads,
           head_dim 128), launch counts set to 0 just before and read
           just after: `ops.flash_attention` on batch 4 x 4096 tokens in
           bfloat16 -- causal, causal with a 1024-token window, not
           causal -- and causal in float32 at 2048 tokens, with the KV
           heads broadcast by `repeat_interleave`; `ops.paged_attention`
           (decode) for 64 sequences of seeded lengths in [1, 4096] over
           a paged pool of 16-token blocks whose tables come from the
           port's `BlockAllocator` after a seeded admit / extend /
           release churn (about 1.3 GB of pool, written with
           `write_token`), GQA 32/8 in bfloat16 and once in float32.
           Each kernel against its plain version on the same inputs
           (float32 within rtol 1e-4 / atol 1e-5, bfloat16 within one
           bfloat16 ulp, taken at |value| >= 2^-8), two launches
           bit-identical, and against the
           `ref` oracles (bfloat16 within 5e-2, the reference tests'
           bound); then CUDA-event times beside the plain version's,
           `scaled_dot_product_attention`'s (flash; paged has no one
           PyTorch call) and the bound: the larger of the bytes (q, k,
           v and out once; paged: the K and V rows below each length)
           at 3.35 TB/s and the visible (q, k) pairs x 4 head_dim flops
           at the peak for the inputs' type (989 TFLOP/s bfloat16; for
           float32 the better of the FMA units' 67 TFLOP/s and three
           TF32 products on the tensor cores, 3 x flops at 495 TFLOP/s,
           printed as `tc3_bound_ms`), with `fma_bound_ms` and
           `tc_bound_ms` (one pass on the tensor cores) beside it, and
           each flash cell's achieved TFLOP/s (those flops over
           kernel_ms);
  lm       Granite-8B at its published widths with 18 of its 36 layers
           (configs/granite_8b.py: d 4096, 32/8 heads, bfloat16; seeded
           weights on the card; the cut, with RWKV's, pays for the
           lm_encdec phase) served by `serve.Engine` (8 slots, 1024-token context,
           16-token blocks) over 16 seeded requests (prompts of 16-600
           tokens, budgets of 8-48): every prompt through the flash
           kernel, every decode step through the paged kernel over the
           dense cache.  Counts set to 0 just before the run and read
           just after; every request must finish with its budget, both
           kernels must launch, and a torch.profiler window over decode
           steps 11-20 (device ms a step split into flash, paged, GEMM
           and other, and the busy share) must hold the paged kernel's
           records and no `einsum` or `scaled_dot_product_attention` op.
           Prints steps, tokens, tokens/s, preemptions, prefill ms by
           bucket and decode host ms a step.  Then two requests
           teacher-forced (prefill and 16 decode steps) through the
           kernel path and the plain path (`use_kernels=False`): logits
           within rtol = atol = 0.08; and each kernel against its plain
           version at the phase's shapes (flash 32 x 512 x 128 causal,
           paged B 8 / H 32 / KVH 8 / S_max 1024 / block 16), one
           bfloat16 ulp, timed beside its bound and the library call
           (SDPA causal; SDPA with a length mask over the dense cache):
           the JSON line's flash and paged entries are these;
  lm_hybrid Jamba-v0.1 (configs/jamba_v01_52b.py) at full width with
           one period of its 32 layers (8: Mamba x4, attention, Mamba
           x3; a 16-expert top-2 MoE in the odd layers; d 4096, 32/8
           heads of 128, d_state 16, vocab 65,536, bfloat16, seeded
           weights on the card, 26.5 GB) and RWKV6-3B at full width
           with 8 of its 32 layers (configs/rwkv6_3b.py: d 2560, 40
           heads of 64; the cut pays for the lm_encdec phase),
           each served by `serve.Engine` like Granite above (16 seeded
           requests, prompts 16-600, budgets 8-48; counts set to 0 just
           before and read just after).  Jamba: one flash launch a
           prefill and one paged launch a decode step, the MoE's slot
           choices dropped a step (capacity 1 at 8 slots), three decode
           steps replayed from one cache twice (logits and every cache
           leaf bit for bit), a torch.profiler window of five decode
           steps alone (device split, busy share; no scatter_add /
           index_add kernel), the expert GEMMs of a step against their
           22.5 GB at 3.35 TB/s; then the same family at 5 layers in
           float32 (TF32 off; layer 4 is its first attention layer),
           kernel path against plain path teacher-forced, within
           rtol = atol = 1e-3 on every row whose routing agreed call by
           call (at most 1 % may not).  RWKV: no kernel launches, its
           decode window; then 2 layers of full width in float32 on the
           card against the CPU for a 512-token prompt (the chunked wkv)
           and a 100-token one (the per-token recurrence), each with 8
           decode steps, logits within rtol = atol = 1e-3;
  lm_encdec Whisper-large-v3 uncut (configs/whisper_large_v3.py: 32
           encoder and 32 decoder layers, d 1280, 20 heads of 64, d_ff
           5120, vocab 51,866, bfloat16; 1,535,383,040 seeded parameters
           on the card) through `registry.get_model`: first each kernel
           against its plain version at the phase's shapes, one bfloat16
           ulp and two launches bit-identical -- flash 160 x 1500 x 1500
           x 64 not causal (blocks 125), 160 x 228 x 1500 not causal and
           160 x 228 x 228 causal (blocks 114), paged cross (B 8, H =
           KVH 20, 1,500 keys as 4-token blocks) and self (448-token
           cache, 16-token blocks) -- each timed like Granite's beside
           its bound and SDPA's time.  Then 16 seeded clips of 1,500
           frame embeddings (the frontend stays a stub, as in the
           reference) in two batches of 8: A the 4-token start sequence
           and 48 greedy decode steps, B a 228-token prompt with
           previous-text conditioning and 32 steps; one `prefill(max_len
           =448)` a batch, then `decode_step` calls.  Counts set to 0
           just before and read just after: 96 flash launches a prefill
           (32 encoder, 32 prompt self, 32 prompt cross) and 64 paged a
           decode step (32 self, 32 cross), nothing else.  Prints
           tokens/s, encode and prefill ms a batch, decode host ms a
           step; a torch.profiler window of 5 decode steps (device ms
           split into the cross K/V GEMMs, which a step recomputes from
           the encoder's states, against their 2.52 TFLOP at 989
           TFLOP/s, other GEMMs, paged and other; busy share; paged
           records, no `einsum` or SDPA op); three decode steps replayed
           from one cache twice (logits and every cache leaf bit for
           bit); 4 + 4 layers in float32 (TF32 off), kernel path against
           plain path teacher-forced (batch B's prefill and 16 steps)
           within rtol = atol = 1e-3; and the whole model's bfloat16
           kernel path within 1.1x the plain path's distance from the
           float32 plain path;
  train    StableLM-1.6B (configs/stablelm_1_6b.py, the reference
           launcher's default: 24 layers, d 2048, 32 heads, vocab
           100,352, bfloat16) trained at its published size through the
           port's train step (`train.loop.make_train_step`: autograd over
           `loss_fn(use_kernels=False)`, the plain attention the
           reference trains with, remat none; AdamW from
           `launch.steps.optimizer_for`, lr 3e-4, warmup 2): seeded
           weights on the card, batches of 8 x 512 tokens from
           `SyntheticLM(seed=0)`, 10 steps with loss, grad_norm, lr and
           wall ms each; the median step, tokens/s, model TFLOP/s (6 N
           tokens + 12 L B S^2 d a step) against 989 and the peak device
           memory; a torch.profiler window over steps 6-8 splits a
           step's device ms into the weight GEMMs, the attention (its
           batched einsums, softmax and mask), the optimizer and other,
           with the busy share.  Fails unless every loss and grad_norm is
           finite, the last step repeated from its saved state gives its
           loss within rel 1e-6 (bit for bit printed), no attention
           kernel launches in the phase; the same config at 2 layers in
           float32 (TF32 off, batch 2 x 128; parameters drawn on the card
           and copied to the CPU) on the card against the CPU:
           loss within rtol 1e-5, each gradient leaf within 1e-4 of its
           max |g|, and one AdamW update from the CPU's gradients within
           rtol 1e-6 (atol 1e-6 of the leaf's max); then the reduced
           config learns one batch (lr 3e-3, 30 steps: the loss drops by
           0.5) and `launch.train.main` ends where it ended without a
           crash after a crash at step 7 (last step equal, final loss
           within rel 1e-5);
  mesh     the mesh layer (`distributed.api`'s meshes and `shard_map`,
           `distributed.collectives`, `distributed.pipeline`,
           `optim.grad_compress.crosspod_allreduce_compressed` and the
           MoE mesh paths) on four ranks that share the card over gloo,
           every collective staging CUDA tensors through host memory
           (`launch.mesh.World`: started once the train phase's timed
           steps are done, so the ranks' imports and CUDA contexts
           overlap its untimed checks and no other phase's timings;
           the backend is printed there and each mesh's transport in
           the phase).  First, on this process, the one-rank references:
           Jamba-v0.1's MoE layer at its published widths (d 4096, 16
           experts top-2, d_expert_ff 14336, bf16, 5.25 GiB of seeded
           expert weights) at capacity factor 8 (no slot drops), global
           `apply_moe` on 8 x 512 prefill and 8 x 1 decode tokens in
           bfloat16 and float32; and Jamba's first two layers (Mamba +
           dense FFN, Mamba + the MoE; 6.97 GiB bf16) teacher-forced
           (8 prompts of 512 tokens, 16 decode steps) in float32 and
           bfloat16.  Then each rank, from the same seeds (rank 0 checks
           its inputs' bits against this process's): (A) `apply_moe_
           sharded` and `apply_moe_a2a` on (data 1, model 4) and (data
           2, model 2), `apply_moe_decode` on (2, 2), in bfloat16 (a
           first call and a timed replay, bit for bit; within 1.1x the
           global bf16 layer's error against the global float32 output)
           and float32 with `moe_combine_bf16` off (within 1e-5 of max
           |y|; decode, whose combine is the reference's bfloat16 psum,
           within 2^-7), aux losses within rtol 1e-5 (decode: zeros);
           (B) the two layers under `use_mesh` on (2, 2) with
           `moe_all_to_all` off (the reference's optimized profile):
           prefill through `apply_moe_auto` to the sharded path, each
           decode step to the weight-stationary one (the paths' calls
           counted), logits within 1.1x the one-rank bf16 run's error
           against the one-rank float32 run, the whole run (prefill
           and 16 decode steps) replayed bit for bit; (C)
           `ring_allgather_matmul` float32 (512, 4096) @ (4096, 14336)
           sharded on model 4 against `torch.matmul`, `lse_merge_
           attention` at Granite-8B's decode widths (B 8, H 32 / KVH 8,
           hd 128, a 1,024-token cache split in 4, seeded lengths
           117-1024) against plain softmax attention, both within 1e-4;
           `crosspod_allreduce_compressed` over StableLM-1.6B's
           embedding and layer 0 on (pod 2, data 2), bit for bit the
           formula on one rank; `pipeline_apply` on 4 stages at the
           reference's toy widths within 1e-4; (D) once the MoE parts'
           memory is freed, the partitioned train step
           (`distributed.partition`): StableLM-1.6B at its published
           widths (d 2048, 32 heads of 64, d_ff 5632, vocab 100,352),
           depth cut 24 -> 2, float32, AdamW as the train phase's, 8 x
           512 tokens on (data 2, model 2), each rank on its blocks of
           the state (FSDP on data, Megatron on model) and its rows of
           each batch: 3 steps, step 0 replayed from a copy of its
           state, then one step on (data 1, model 4); between the
           ranks' MoE parts and this part, once the ranks have given
           their memory back, this process runs the same steps on one
           rank, from the same seeded parameters and batches, as the
           gate: loss and grad_norm
           within rel 1e-5 at every step, step 0's gradients (AdamW's
           mu / (1 - b1)) within 1e-4 of each leaf's max on every rank,
           loss and grad_norm the same bits on the four ranks, the
           replay within rel 1e-6; rank 0's step ms (events and host
           clock after a sync), the collectives' host ms and MiB sent,
           each rank's peak GiB, beside the card's name and power
           limit.  Each call's ms (CUDA
           events on rank 0 between barriers) beside its host ms and the
           collectives' share (gloo through the host, not an
           interconnect), the global one-rank layer's ms beside; every
           rank's results the same bits (the ring product, folded from
           each rank's own ring position, within its bound on every
           rank).  A rank that raises or a collective that times out
           fails the run;
  roofline each step an earlier phase timed -- StableLM-1.6B's train
           step (8 x 512, no remat), Granite-8B's, Jamba's, RWKV6's and
           Whisper's decode steps (8 slots; a 1,024-token cache, or 448
           tokens over 1,500 frames) -- at that phase's config and depth,
           its plan built by `launch.steps.build_plan` on one rank and
           traced once on the CPU (fake tensors, the plain path;
           `roofline.op_costs`) in a process started before the build:
           counted matmul and total FLOPs and bytes, their bounds at the
           card's rates (989 TFLOP/s, 3.35 TB/s) and `count_ratio`, the
           larger over the device ms the phase measured; the step's
           floor (the inputs it reads once, the donated ones written
           back, no cache or activation; the train step's weights'
           matmuls) and `share`, the floor over those ms; beside the
           card's name and power limit.  Fails unless the StableLM
           step's and the Granite decode step's matmul FLOPs equal
           closed forms of the config (36,593,121,361,920 for the train
           step);
  main     the main path at 2^22 rows: `fd_matrix` and `rmat_matrix`,
           each of the four graph drivers through the kernels, with every
           launch count set to 0 just before and read just after; then
           the same runs on the plain PyTorch path (use_pallas=False) on
           the card, over the kernel plans' containers (`plain_twins`:
           no second conversion): same iteration counts, BFS/SSSP/CC
           values equal,
           PageRank within rtol 1e-3 (values near 2^-22); then
           `execute_many` on real-valued X (±inf in the ⊕-only
           semirings) at k = 4, 16 and 64 over the FD ELL plans
           (min_plus, or_and) and the R-MAT HYB PageRank plan: two calls
           bit-identical, each row bit-equal to `execute`, one launch of
           each batched kernel a call; each plan's `spmm_ell` gather
           layout (FD: X read as it lies, whose call's trace must hold
           no kernel but `spmm_ell`; HYB: the interleaved copy, timed
           alone as `interleave_ms`); `execute_many_ms` beside the time
           of k `execute` calls, the bound (the layout once, X and Y
           once) and, under plus-times, `torch.sparse.mm` of the CSR
           against the (n, k) block; and the R-MAT plain plan's replay;
  dia      FD PageRank at 2^16, where the compiler picks DIA, counted the
           same way, against its plain path;
  compile  the reference's default `plan.compile` (reorder="auto",
           predictor="auto": 'none' against 'rcm', scored by the shipped
           cost model) on the main path's FD and R-MAT and on `banded_
           matrix(2^22, 8)` under the seeded symmetric permutation
           `default_rng(0).permutation` (its fingerprints pinned at
           2^22): each candidate's 19 features, predicted log2 GFLOPS
           and GFLOPS, the decision, scoring and stage seconds; it fails
           unless the model scored them, each model score is 2 ** the
           model of its features, and the decision and scores equal the
           reference's on the same matrix (`REFERENCE_DECISIONS`, from
           `tools/reference_decisions.py`, as float.hex).
           `predictor="oracle"` on the band (analytic: RCM and DIA;
           its RCM is the default compile's, `SharedRcm`) and
           on R-MAT 2^11 (replay) through a fresh `PlanCache`, whose
           predictor / oracle compiles must be 1 / 1.  Each plan runs
           through its kernels, launch counts set to 0 just before and
           read just after; with integer values in its container and
           layout it equals its use_pallas=False twin bit for bit, with
           its own values within rtol 1e-5.  Then `core.spmv.pagerank`
           on FD 2^22 (32 iterations) within rtol 1e-3 of its plain
           path, `power_iteration` on the band within rtol 1e-5, and the
           dense branch at 2^12 bit for bit;
  reorder  the same scrambled band: `rcm` (the oracle compile's)
           recovers the band, `auto_format(..., reordering=r)` gives
           DIA, the per-call `spmv(..., reordering=r)` (DIA kernel)
           equals `spmv(scrambled)` (padded CSR) within rtol 1e-5 and
           `plan.compile(scrambled, reorder=r)` is DIA and equals the
           per-call result bit for bit;
  rmat_rcm R-MAT 2^22 PageRank with `reorder=r`, r = rcm of its operand
           (the compile phase's RCM of the adjacency, whose symmetrised
           pattern the operand shares), kernels against the plain path;
  bell     a blocked graph at 2^21 (dense 8x128 tiles, 12 per 1024
           rows): `auto_format` gives BELL and the per-call `spmv`
           through the BELL kernel equals its plain path (bit for bit on
           integer-valued x, rtol 1e-5 on real x); its PageRank compiles
           to BELL, kernels against the plain path;
  kernel   each kernel against its plain version on the card, on the
           main path's layouts, under every semiring it serves:
           bit-identical on integer-valued plus-times operands, equal
           under min_plus / or_and / max_times (+-inf included), within
           rtol 1e-5 / atol 1e-6 on real-valued plus-times; BELL, whose
           plain version repeats its summation order, bit-identical on
           real values too, and NaN where its plain version is NaN when
           the first x tile, or a column its blocks drop, holds a
           non-finite value; the batched kernels (`spmm_ell`,
           `spmm_csr_seg` with a (k, n) base) the same way at k = 4, and
           at k = 64 bit for bit against the single-vector kernels' rows
           (FD's `spmm_ell` through both gather layouts);
  time     per kernel at the main path's shapes: CUDA-event time of many
           launches, its plain version's time, a torch.sparse CSR
           product's time where one computes the same function, and the
           bound: the larger of the bytes the kernel's function must
           move (its inputs read once, y written once) at 3.35 TB/s and
           its float32 operations at 67 TFLOP/s.  DIA moves its band,
           ELL its (W, n) slab, padded CSR its nonzeros and row
           pointers, segmented CSR its heavy nonzeros, x, the base and
           y (each of its two passes' device time read from a
           torch.profiler trace of the real launch), BELL its blocks' kept
           columns and their masks and offsets.  The uniform 8 nnz + 12
           n bytes of the unpadded CSR is printed beside it as
           `csr_bound_ms`.  DIA is timed on the reordered 2^22 band (and
           on FD 2^16; each also from a torch.profiler trace, the
           kernel's and torch.sparse's device time alone, since at 2^16
           the events time the host's dispatch as much as the kernel),
           BELL on the blocked PageRank layout (and on the
           per-call layout of the dense tiles), with the padded
           container's bytes beside it as `padded_bound_ms`; `spmm_ell`
           on the FD ELL layout and `spmm_csr_seg` on the R-MAT heavy
           stream at k = 4, 16 and 64 (the JSON entries: 64 and 4; X and
           Y, and the base, k times the vectors' bytes; `torch.sparse.mm`
           against the (n, k) block as the library call, from k = 16
           `torch.addmm` with the base for `spmm_csr_seg`, whose
           `gather_bound_ms` reads each gathered Xt row once);
  serve    `serve_graph.GraphEngine` (64 lanes, compile queue 8, one
           compile a step) over the main path's FD and R-MAT graphs and
           its plan cache, launch counts set to 0 just before and read
           just after: 32 requests, four a step -- the main path's eight
           driver calls first, then seeded ones over both graphs and the
           four analytics with 1-8 sources -- and three mutations of the
           R-MAT graph: M1 (step 3) inserts 0.1 % of nnz absent
           off-diagonal edges, rows and columns uniform, weights in
           [1, 8]; M2 (step 6) deletes 1,024 stored edges (one each of
           uniformly drawn rows); M3 (step 10) inserts 0.5 % of nnz.
           Checks: (1) requests on an unmutated graph that repeat a
           main-path call equal `kern` (PageRank bit for bit, same
           iterations); (2) every other request equals its answer run
           alone, cold, on the graph of the generation it finished in
           (BFS/SSSP/CC equal; PageRank finite, summing to 1 and within
           `PR_L1` of it in L1, the bound its residual tolerance implies
           -- the main path's answer before M1, which is the overlay
           with its delta pass dropped, must fail that bound); (3) overlays of an integer-valued
           R-MAT copy equal fresh compiles of their materialised
           matrices (plus-times with inserts and deletes bit for bit,
           min_plus and or_and with inserts exactly), `execute_many`
           replays bit for bit with rows equal to `execute`; (4) the
           predicted lifecycle actions and cache counters
           (`PREDICTED_ACTIONS`, `PREDICTED_COUNTERS`), a first wave
           admitted warm, at least 96 lanes requested at the peak and a
           preemption; (5) the trace at 2^16 (`--serve-replay-log2n`)
           run twice with fresh caches: identical schedules, actions and
           counters, bit-identical values.  Prints the engine's steps,
           wall and host ms a step, the device time and idle share of
           two windows of steps from `torch.profiler` traces
           (`SERVE_TRACE_STEPS`), lanes and padded lanes, admission hit
           rates, each mutation's
           host seconds (adjacency delta, operands, `csr_diff`, `merge`,
           overlay installation, re-keying), the lineages' staleness,
           overlay installation against the re-plans' compile seconds,
           the PageRank delta pass against its base SpMV, warm against
           cold iterations after M1, and the phase's peak memory;
  sweep    the paper's measurement grids through `telemetry.sweep` and
           the sharded runner, the cells spread over up to 8 spawned
           worker processes (each its own CUDA context), matrices made
           on the card: the headline `run_sweep(log2ns=(12, 14, 16))`
           with the baseline hierarchy, the five §V `MECHANISMS` at
           2^14, `scaling_sweep` at 2^12 over 1, 2, 4 and 8 threads
           (balanced partitions), and `graph_sweep` at 2^12 (PageRank,
           BFS, SSSP; HierarchySpec(l2_bytes=16384, l3_bytes=65536),
           max_iters 128) once with each plan's own format and once
           pinned to CSR, launch counts set to 0 before each graph pass
           and summed over the cells' processes after it.  The payloads'
           sha256 are pinned to the reference's (`SWEEP_DIGESTS`,
           `GRAPH_REFERENCE`, from `tools/reference_sweep.py`; they are
           the simulated Sandy Bridge machine's cycles and misses, not
           the card's): every mech and scaling grid, and every BFS / SSSP
           cell, byte for byte; a PageRank cell its format, nnz,
           semiring and convergence, and its per-iteration summaries
           those of the reference's iterations both ran
           (`PAGERANK_ITERATION_RUNS`), both iteration counts printed
           (ROADMAP C3).  Each graph cell's driver runs once more in the
           main process under torch.profiler: its device time is
           printed beside its driver's and replay's host seconds in the
           worker.  Each graph cell's plan runs through its kernels
           against its plain version, bit for bit.  The graph grid runs
           again stopped at 5 cells into a checkpoint and resumed with
           workers: byte-identical to the uninterrupted run.  The seed-0
           cost-model harvest (240 label cells) equals the shipped
           corpus rows and `costmodel --check` returns 0; the gap
           reports are printed;
  sharded  `plan.compile(mesh=row_mesh([card] * 4))` on the main path's
           FD matrix with integer values, with the default and a
           `rowblock_balanced` partition: four `spmv_ell` launches an
           execute, bit-identical to the CSR plan and to the slabs'
           plain versions; host build seconds, slab bytes, padding
           factor, each slab's kernel ms beside the unsharded ELL plan's.
           Then `save_plan` / `load_plan` of the main path's R-MAT
           PageRank plan (hyb; seconds and bytes printed, bit-identical
           after load) and of a 2^16 sharded plan (without a mesh its
           execute raises the reference's error; rebound with `mesh=`
           it is bit-identical).

Then one JSON line `{"kernels": [...]}` and, last,
`{"ok": true, "device": {...}}`.  It exits nonzero and prints no result
without a card, outside a checkout, or when any check fails.
`--cpu-rehearsal` runs every phase at a small size on the CPU through
the plain versions (no kernels, so no result either; the lm phase at
granite-8b's `reduced()` config) to rehearse the control flow:

    python3 chip_smoke.py --cpu-rehearsal --log2n 17 --dia-log2n 12 \
        --reorder-log2n 14 --bell-log2n 13 --reps 3 --attn-seq 256 \
        --attn-batch 1 --paged-seqs 8 --paged-max-len 512 \
        --serve-replay-log2n 12 --sweep-shift 4
"""
from __future__ import annotations

import argparse
import atexit
import dataclasses
import importlib
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory, data sheet
F32_OPS_PER_S = 67e12               # H100 SXM float32 outside tensor cores
FD_CAP = 1100                       # max_iters of FD bfs/sssp/cc
PR_TOL = 1e-5                       # PageRank L1 residual tolerance
PR_RTOL = 1e-3                      # PageRank kernel vs plain, values
PR_DAMPING = 0.85
#: two PageRank runs that stop at an L1 residual below PR_TOL: the map
#: contracts by d in L1, so with a rounding error of at most eta an
#: iteration each run ends within (d·tol + eta)/(1-d) of the fixpoint,
#: and the two within twice that of each other; eta = 16 float32 ulps
#: of the unit mass (1.388e-4, 22 % over the exact 2·d/(1-d)·tol)
PR_L1 = 2 * (PR_DAMPING * PR_TOL + 16 * float(np.finfo(np.float32).eps)) \
    / (1 - PR_DAMPING)
REAL_RTOL, REAL_ATOL = 1e-5, 1e-6   # real-valued plus-times, kernel/plain
BF16_TC_OPS_PER_S = 989e12          # H100 SXM tensor cores, dense bf16
TF32_TC_OPS_PER_S = 495e12          # H100 SXM tensor cores, dense TF32
TPU_KERNELS = {                     # each one's `pl.pallas_call` line
    "spmv_dia": "src/repro/kernels/spmv_dia.py:71",
    "spmv_ell": "src/repro/kernels/spmv_ell.py:60",
    "spmv_csr": "src/repro/kernels/spmv_csr.py:78",
    "spmv_csr_seg": "src/repro/kernels/spmv_csr_seg.py:86",
    "spmv_bell": "src/repro/kernels/spmv_bell.py:63",
    "flash_attention": "src/repro/kernels/flash_attention.py:104",
    "paged_attention": "src/repro/kernels/paged_attention.py:102",
    # the batched kernels replace no pallas_call: the reference's
    # `execute_many` is its jnp kernel vmapped over X's rows
    "spmm_ell": "src/repro/plan/plan.py:170",
    "spmm_csr_seg": "src/repro/plan/plan.py:170",
}
#: the reference's `plan.compile` decisions on the same matrices
#: (`PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/reference_decisions.py`;
#: R-MAT 2^11 from `repro.plan.compile(rmat_matrix(2048), predictor=...)`):
#: (chosen, format, scoring, {candidate: predicted GFLOPS as float.hex})
REFERENCE_DECISIONS = {
    "fd": ("none", "csr", "model", {"none": "0x1.fac8fac0cd2afp+0",
                                    "rcm": "0x1.fa416cded7e14p+0"}),
    "rmat": ("none", "hyb", "model", {"none": "0x1.ff64321937dc9p+0",
                                      "rcm": "0x1.ff64321937dc9p+0"}),
    "band": ("none", "csr", "model", {"none": "0x1.fc9b9618f61e9p+0",
                                      "rcm": "0x1.0197ac0e9df70p+1"}),
    "band oracle": ("rcm", "dia", "analytic",
                    {"none": "0x1.f4512b55469e5p-3",
                     "rcm": "0x1.f954a4b11eaa6p+0"}),
    "rmat2^11 oracle": ("none", "hyb", "replay",
                        {"none": "0x1.0000000000000p+1",
                         "rcm": "0x1.0000000000000p+1"}),
    "rmat2^11 model": ("none", "hyb", "model",
                       {"none": "0x1.fe4d96509bf02p+0",
                        "rcm": "0x1.faec8caa5d890p+0"}),
}
#: fingerprints of the reorder phase's 2^22 band and scrambled band
BAND_FINGERPRINTS_2_22 = ("c8c7f575e3dde02058de8d1280a73b45",
                          "26bab240962f5f05cc9f5a93a8b1f343")
# Granite-8B's attention widths (src/repro/configs/granite_8b.py)
N_HEADS, N_KV_HEADS, HEAD_DIM = 32, 8, 128
ATTN_WINDOW = 1024                  # the smoke's own: no config sets one
PAGED_BLOCK, PAGED_MAX_BLOCKS = 16, 256
# the paged kernel instances the attention phase runs (GQA 32/8: 4 query
# heads a KV head), and the merge
PAGED_INSTANCES = ("bf16 d128 g4", "f32 d128 g4", "merge_kernel bf16",
                   "merge_kernel f32")
ATTN_RTOL, ATTN_ATOL = 1e-4, 1e-5   # float32 kernel vs plain / oracle
ORACLE_BF16_TOL = 5e-2              # bfloat16 vs the float32-math oracle
TILES_PER_1024 = 12                 # dense 8x128 tiles of the blocked graph
ANALYTICS = ("pagerank", "bfs", "sssp", "connected_components")
#: the reference's payload sha256 of the sweep phase's grids
#: (`PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/reference_sweep.py`):
#: the simulated Sandy Bridge machine's cycles and misses, not the card's
SWEEP_DIGESTS = {
    "headline": "e4fa818fc5cbe9b42c5004c2cd45d5092025f839e2ef171db20e34dd2c21d6e4",
    "mechanisms": "db6afb9f195baaf29e332cb8aabc44f97e93fd7c7c0bcbce8e01bc0bbbfd7c46",
    "scaling": "16abec380908e0fc391d51ad4bbaabd7157c16bc0ee59fcd72d0c8dfaff1a94f",
}
#: the same tool's graph cells, `analytic|kind` -> (payload sha256,
#: format, n_iters, converged, nnz, semiring)
GRAPH_REFERENCE = {
    "graph": {
        "bfs|fd": ("d7220fcc0a9b4096c9638c24612e49febaf110d269051f62ceaf74a8f6f05440", "ell", 33, True, 36864, "or_and"),
        "pagerank|fd": ("853d27343c619ba441838ab5a3be9f4d334d81bdc3ad29f174d75fb5fe998963", "dia", 76, True, 36864, "plus_times"),
        "sssp|fd": ("0328e399cf9ed18e32c3a47a1443c17152ea6efaff0d9521128b86ff3dc239b9", "ell", 42, True, 36864, "min_plus"),
        "bfs|rmat": ("c24411924d18fd86f8a6eb9e27a7999f512942867847f3af803ee7e65af4b1f7", "hyb", 12, True, 28657, "or_and"),
        "pagerank|rmat": ("f380707345f609de1afffb789a97b388074595913d4dc6b97017ef97271bfcaf", "hyb", 32, True, 28657, "plus_times"),
        "sssp|rmat": ("06883f8605bdc0c121cdb415c6857e87cdc678bbc18c2d37c24871b62fc36f6f", "hyb", 12, True, 28657, "min_plus"),
    },
    "graph-csr": {
        "bfs|fd": ("827a18c251b965dc2302df0c4f805a355bd1dc8b850ebc4949bef5bc65c40004", "csr", 33, True, 36864, "or_and"),
        "pagerank|fd": ("2d9c44114b72ca47d719e6d1d1914020ba396892a8cd8ce3124cb8b1b083911e", "csr", 68, True, 36864, "plus_times"),
        "sssp|fd": ("b9ecd077a8df2eb66f1ea128245b37f457a7254ff7b3668d90bf03c52c8f62da", "csr", 42, True, 36864, "min_plus"),
        "bfs|rmat": ("15f2710753d618daf950158672ffdb05212b25bdbe24c9f0343640a6f7708361", "csr", 12, True, 28657, "or_and"),
        "pagerank|rmat": ("ec5014cd640dddf301a5af5c7632cc4ab5f994feb988fd7e48b5f057cac35c9e", "csr", 31, True, 28657, "plus_times"),
        "sssp|rmat": ("ae2c287d0f61c0959bfc4dc3ebc1b8fe47e82c2e40f0545d9c13e1a974f96434", "csr", 12, True, 28657, "min_plus"),
    },
}
#: the same tool's PageRank cells' per-iteration summaries as runs of
#: [sha256[:16] of one iteration's summary, iterations] (its
#: `iteration_runs`), which hold a port that stops at another iteration
#: (ROADMAP C3) to the iterations both ran
PAGERANK_ITERATION_RUNS = {
    "graph": {
        "pagerank|fd": (("e73a1f820e262e80", 1), ("17ea15b732ccaf94", 75)),
        "pagerank|rmat": (("d9311ba10ca2078a", 1), ("23a9a807cbb16c65", 31)),
    },
    "graph-csr": {
        "pagerank|fd": (("e73a1f820e262e80", 1), ("17ea15b732ccaf94", 67)),
        "pagerank|rmat": (("45a96314a54683e7", 1), ("c4b58d03ad873d2b", 30)),
    },
}
GRAPH_ANALYTICS = ("pagerank", "bfs", "sssp")
GRAPH_SPEC = {"l2_bytes": 16384, "l3_bytes": 65536}   # graph_bench's cell
SHARDS = 4                          # row slabs of the sharded phase

FAILURES: list = []
#: device ms a step of each step the phases time, for the roofline phase
STEP_MS: dict = {}
#: the card's name and power limit, as nvidia-smi gives them
CARD = ["not measured"]


def log(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> bool:
    if not ok:
        FAILURES.append(what)
        log(f"FAIL {what}")
    return ok


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# main path: the four drivers on both families
# ---------------------------------------------------------------------------

def drive(drivers, fam, adj, cache, dev, use_pallas):
    """Run the four drivers on one graph; returns {analytic: (result,
    wall seconds)}."""
    src = int(np.argmax(adj.row_lengths()))
    r0 = np.random.default_rng(7).uniform(0.5, 1.5, adj.n_rows) \
        .astype(np.float32)
    cap = FD_CAP if fam == "fd" else None
    kw = dict(plan_cache=cache, use_pallas=use_pallas, device=dev)
    calls = {
        "pagerank": lambda: drivers.pagerank(adj, tol=PR_TOL, r0=r0, **kw),
        "bfs": lambda: drivers.bfs(adj, src, max_iters=cap, **kw),
        "sssp": lambda: drivers.sssp(adj, src, max_iters=cap, **kw),
        "connected_components": lambda: drivers.connected_components(
            adj, max_iters=cap, **kw),
    }
    out = {}
    for name in ANALYTICS:
        t0 = time.perf_counter()
        res = calls[name]()
        sync(dev)
        out[name] = (res, time.perf_counter() - t0)
    return out


def plain_twins(cache) -> int:
    """Install, for every kernel plan in `cache`, its use_pallas=False
    twin under the key a plain driver call looks up: the same container,
    reordering and CSR with no kernel layout -- what `plan.compile(...,
    use_pallas=False)` builds from the same matrix -- so the main path's
    plain runs do not convert their matrices again (about 28 s of host
    time at 2^22).  The twins' compile_stats are empty: they compiled
    nothing.  Returns the number installed."""
    from repro_torch.plan import SpmvPlan

    n = 0
    for key, plan in list(cache._plans.items()):
        if "use_pallas=True" not in key or type(plan) is not SpmvPlan:
            continue
        twin = key.replace("use_pallas=True", "use_pallas=False")
        if not cache.contains(twin):
            cache.get_or_build(twin, lambda p=plan: dataclasses.replace(
                p, prep=None, use_pallas=False, compile_stats={},
                _traces={}))
            n += 1
    return n


def compile_seconds(plan) -> float:
    return sum(v for k, v in plan.compile_stats.items()
               if k.endswith("_s"))


def spmv_ms(plan, dev) -> float:
    """Device time of one `plan.execute`, the SpMV of one iteration
    (CUDA events; the kernels do the same work whatever x holds)."""
    x = torch.ones(plan.n_cols, device=dev)
    return time_ms(lambda: plan.execute(x), 20, dev)


def report_run(tag, fam, name, res, wall, cap=None, spmv=None):
    """One driver run: format, iterations, host compile seconds, host
    wall time per iteration (SpMV, stepper and the one read back) and,
    when given, the SpMV's device time per iteration."""
    it = max(res.n_iters, 1)
    iter_ms = 1e3 * res.iter_s / it
    log(f"{tag} {fam} {name}: fmt={res.plan.format_name} "
        f"iters={res.n_iters} converged={res.converged}"
        f"{f' max_iters={cap}' if cap else ''} "
        f"compile_s={compile_seconds(res.plan):.3f} wall_s={wall:.3f} "
        f"iter_ms={iter_ms:.4f}"
        + ("" if spmv is None else
           f" spmv_device_ms={spmv:.4f} spmv_share={spmv / iter_ms:.3f}"))


def compare_pagerank(tag, a, b):
    """Kernel-path PageRank `a` against plain-path `b`: finite, values
    within PR_RTOL of each other, summing to 1."""
    err = float(np.max(np.abs(a.values - b.values) /
                       np.maximum(np.abs(b.values), 1e-30)))
    check(np.isfinite(a.values).all() and err <= PR_RTOL and
          abs(float(a.values.sum()) - 1.0) < 1e-3,
          f"{tag} pagerank: max rel err {err:.3g}")
    log(f"{tag} pagerank: kernels vs plain max rel err {err:.3g} "
        f"(rtol {PR_RTOL}), sum {float(a.values.sum()):.6f}")


def compare_runs(tag, kern, plain):
    for name in ANALYTICS:
        a, b = kern[name][0], plain[name][0]
        check(a.n_iters == b.n_iters,
              f"{tag} {name}: iterations {a.n_iters} (kernels) vs "
              f"{b.n_iters} (plain)")
        if name == "pagerank":
            compare_pagerank(tag, a, b)
        else:
            same = np.array_equal(a.values, b.values)
            check(same, f"{tag} {name}: values differ from the plain path")
            log(f"{tag} {name}: kernels == plain: {same}, "
                f"finite={int(np.isfinite(a.values).sum())}")


def same_bits(a, b) -> bool:
    """Bit-equal float32 tensors (NaN payloads and -0.0 included)."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def batch_x(sr_name, k, n, seed, dev):
    """Real-valued X in the semiring's domain with +inf in every 50th
    column (and -inf beside it where the domain has negatives)."""
    gen = torch.Generator().manual_seed(seed)
    X = torch.rand((k, n), generator=gen)
    if sr_name == "plus_times":
        X = X * 2 - 1
    else:
        X[:, ::50] = float("inf")
        if sr_name == "min_plus":
            X[:, 1::50] = float("-inf")
    return X.to(dev)


def plan_layout_bytes(plan) -> int:
    """Bytes of an ell or hyb plan's layout that one SpMV must read: the
    (W, n) slab, and a HYB's heavy vals and cols."""
    p = plan.prep
    if plan.format_name == "ell":
        return layout_bytes(p.data, p.idx)
    return layout_bytes(p.light.data, p.light.idx, p.heavy.vals,
                        p.heavy.cols)


def slab_gather(lp, sr) -> str:
    """How the batched ELL kernel reads X for the slab `lp` under the
    semiring `sr` (`spmv_ell.gather_layout`, derived from the slab):
    "direct" reads X as it lies, "xt" gathers rows of its interleaved
    copy."""
    from repro_torch.kernels.spmv_ell import gather_layout

    return gather_layout(lp.data, lp.idx, sr.pad_value)


def gather_of(plan) -> str:
    """`slab_gather` of an ell plan's slab or a hyb plan's light slab (a
    HYB heavy stream always gathers from the interleaved copy)."""
    from repro_torch.graph.semiring import resolve

    p = plan.prep
    return slab_gather(p if plan.format_name == "ell" else p.light,
                       resolve(plan.semiring))


def call_kernels(fn, dev, reps: int) -> list:
    """The names of the device kernels and copies of `fn()`, from a
    torch.profiler trace of `reps` calls (the profiler drops records of
    a short trace: ten calls of a 2 ms kernel left none, fifty kept
    them); [] on the CPU."""
    if dev.type != "cuda":
        return []
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sorted(device_records(prof))


def allocated_bytes(fn, dev):
    """Bytes the caching allocator handed out during one `fn()` call
    (None on the CPU)."""
    if dev.type != "cuda":
        return None
    key = "allocated_bytes.all.allocated"
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats(dev)[key]
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.memory_stats(dev)[key] - before


def execute_many_replays(cases, plain_plan, dev, reps, ks=(4, 16, 64)):
    """`execute_many` on real-valued X over the main path's plans
    (`cases`: (tag, plan) -- the FD ELL plans under min_plus and or_and
    and the R-MAT HYB PageRank plan), at each k of `ks`: a second call
    bit-equal to the first, each row bit-equal to `execute` of that row
    (one launch of each batched kernel a call), its time beside that of
    k calls of `execute` and the bound (the layout once, X and Y once,
    at 3.35 TB/s), and under plus-times `torch.sparse.mm` of the CSR
    against the (n, k) block; the plain oracle replays at k = 4.  Each
    plan's ELL gather layout is logged; the interleaved copy of X is
    timed alone where the call makes one, and a call that reads X as it
    lies must allocate Y alone and show no kernel but `spmm_ell`'s in a
    trace of its calls.
    Returns {(tag, k): line's numbers}."""
    from repro_torch import kernels as K

    out = {}
    for tag, plan in cases:
        sr = plan.semiring
        lib = None
        gather = gather_of(plan)
        copies = gather == "xt" or plan.format_name == "hyb"
        log(f"execute_many {tag} {plan.format_name}: spmm_ell gather "
            f"layout {gather}" + (" (X as it lies, no interleaved copy)"
                                  if not copies else
                                  " (rows of the interleaved copy of X)"))
        if sr == "plus_times":
            c = plan.csr
            A = sparse_csr(*_coo(c), c.n_rows, c.n_cols)
        for k in ks:
            X = batch_x(sr, k, plan.n_cols, 5 + k, dev)
            K.reset_launch_counts()
            Y = plan.execute_many(X)
            launches = {n: v for n, v in K.launch_counts().items() if v}
            same = same_bits(plan.execute_many(X), Y)
            rows = all(same_bits(plan.execute(X[c]), Y[c]) for c in range(k))
            want = {"ell": {"spmm_ell": 1},
                    "hyb": {"spmm_ell": 1, "spmm_csr_seg": 1}}[
                plan.format_name] if dev.type == "cuda" else {}
            check(same and rows and launches == want,
                  f"execute_many {tag} k={k}: replay equal {same}, rows "
                  f"equal execute {rows}, launches {launches}")
            n_rep = max(reps // 10, 2)
            many_ms = time_ms(lambda: plan.execute_many(X), n_rep, dev)
            loop_ms = time_ms(lambda: [plan.execute(X[c]) for c in range(k)],
                              n_rep, dev)
            copy_ms = None
            if copies:      # the wrappers' interleaved copy of X, alone
                copy_ms = time_ms(lambda: K.interleave_columns(X), n_rep,
                                  dev)
            else:
                # no copy: the call allocates Y alone (the caching
                # allocator's cumulative bytes), and its trace holds no
                # kernel but spmm_ell's
                got = allocated_bytes(lambda: plan.execute_many(X), dev)
                y_bytes = 4 * k * plan.n_rows
                check(got is None or got < y_bytes + 2 * k * plan.n_cols,
                      f"execute_many {tag} k={k}: the call allocated {got} "
                      f"bytes, more than Y's {y_bytes}")
                names = call_kernels(lambda: plan.execute_many(X), dev,
                                     max(reps, 50))
                # an empty trace on the card proves nothing: it fails
                only = (dev.type != "cuda" or bool(names)) and \
                    all("spmm_ell" in name for name in names)
                check(only, f"execute_many {tag} k={k}: the call's trace "
                            f"holds {names}, not spmm_ell alone")
                copied = not only or (got is not None and got >= y_bytes
                                      + 2 * k * plan.n_cols)
                log(f"execute_many {tag} k={k}: allocated_bytes={got} (Y: "
                    f"{y_bytes}); trace: device kernels "
                    f"{names or 'none recorded'}; interleaved copy in the "
                    f"call: {copied}")
            need = plan_layout_bytes(plan) + 4 * k * (plan.n_cols
                                                      + plan.n_rows)
            bound = 1e3 * need / HBM_BYTES_PER_S
            if sr == "plus_times":
                Xn = X.t().contiguous()
                lib = time_ms(lambda: torch.sparse.mm(A, Xn), n_rep, dev)
            out[(tag, k)] = dict(ms=many_ms, loop_ms=loop_ms, bound_ms=bound,
                                 library_ms=lib, interleave_ms=copy_ms,
                                 gather=gather)
            log(f"execute_many {tag} {plan.format_name} {sr}, k={k} real X: "
                f"replay bit-identical {same}, rows == execute {rows}, "
                f"launches {json.dumps(launches)}; execute_many_ms="
                f"{many_ms:.4f} k_execute_ms={loop_ms:.4f} "
                f"({loop_ms / many_ms:.2f}x) interleave_ms="
                + ("none (no copy made)" if copy_ms is None
                   else f"{copy_ms:.4f}")
                + f" bound_bytes={need} bound_ms="
                f"{bound:.4f} ({many_ms / bound:.2f}x bound) library_ms="
                + ("null" if lib is None else
                   f"{lib:.4f} (torch.sparse.mm of the CSR, (n, k) block)"))
            del X, Y
    gen = torch.Generator().manual_seed(5)
    X = (torch.rand((4, plain_plan.n_cols), generator=gen) * 2 - 1).to(dev)
    Y = plain_plan.execute_many(X)
    same = torch.equal(plain_plan.execute_many(X), Y)
    rows = all(torch.equal(plain_plan.execute(X[k]), Y[k]) for k in range(4))
    check(same and rows, f"execute_many rmat plain: replay equal {same}, "
          f"rows equal execute {rows}")
    many_ms = time_ms(lambda: plain_plan.execute_many(X), max(reps // 10, 2),
                      dev)
    log(f"execute_many rmat pagerank plain, k=4 real X: replay "
        f"bit-identical {same}, rows == execute {rows}; "
        f"execute_many_ms={many_ms:.4f}")
    return out


# ---------------------------------------------------------------------------
# the reordering, per-call and BELL paths
# ---------------------------------------------------------------------------

FORMAT_KERNELS = {"csr": ["spmv_csr"], "ell": ["spmv_ell"],
                  "dia": ["spmv_dia"], "bell": ["spmv_bell"],
                  "hyb": ["spmv_ell", "spmv_csr_seg"],
                  "csr-seg": ["spmv_csr_seg"]}


def blocked_coo(n, n_blocks, seed=0):
    """The scheme and random stream of the test helper `_blocked_matrix`
    (`tests/test_auto_format.py`): `n_blocks` dense 8x128 tiles at
    seeded block-aligned places, normal values; overlapping tiles make
    duplicate coordinates."""
    rng = np.random.default_rng(seed)
    rr, cc = np.meshgrid(np.arange(8), np.arange(128), indexing="ij")
    rows, cols = [], []
    for _ in range(n_blocks):
        r0 = int(rng.integers(0, n // 8)) * 8
        c0 = int(rng.integers(0, n // 128)) * 128
        rows.append((r0 + rr).ravel())
        cols.append((c0 + cc).ravel())
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = rng.normal(size=rows.shape[0]).astype(np.float32)
    return rows, cols, vals


def close(a, b) -> bool:
    return bool(torch.allclose(a, b, rtol=REAL_RTOL, atol=REAL_ATOL))


def scrambled_band(log2n, dev, T, banded_matrix):
    """(band, scrambled, seconds): `banded_matrix(2^log2n, 8)` and the
    same band under the seeded symmetric permutation
    `default_rng(0).permutation(n)` (`tools/reference_decisions.py`
    builds the identical matrix with the reference)."""
    n = 1 << log2n
    t0 = time.perf_counter()
    band = banded_matrix(n, 8, device=dev)
    perm = np.random.default_rng(0).permutation(n)
    scrambled = T.Reordering(row_perm=perm, col_perm=perm).apply(band)
    return band, scrambled, time.perf_counter() - t0


def run_reorder(log2n, dev, K, core, compile_plan, reps, scrambled, gen_s,
                r, reorder_s):
    """Scrambled band -> RCM -> DIA, per-call and compiled, against the
    padded-CSR multiply of the scrambled matrix.  `r` is the RCM of the
    scrambled band that the compile phase's oracle compile computed,
    reused rather than computed a fourth time; `reorder_s` is that
    compile's candidate build (RCM plus applying the permutation)."""
    n = 1 << log2n
    t0 = time.perf_counter()
    fmt = core.auto_format(scrambled, reordering=r)
    auto_s = time.perf_counter() - t0
    log(f"reorder 2^{log2n}: nnz={scrambled.nnz} gen_s={gen_s:.2f} "
        f"candidates_s={reorder_s:.2f} (the compile phase's RCM plus "
        f"permutation) "
        f"auto_format_s={auto_s:.2f} "
        f"stats={r.stats} fmt={type(fmt).__name__}")
    if not check(type(fmt).__name__ == "DIA",
                 f"reorder: auto_format gave {type(fmt).__name__}, not DIA"):
        return None
    log(f"reorder dia: {fmt.data.shape[0]} diagonals, "
        f"{fmt.data.numel() * 4 / 2 ** 20:.1f} MiB band")
    gen = torch.Generator().manual_seed(3)
    x = torch.rand(n, generator=gen).to(dev)
    K.reset_launch_counts()
    y_dia = core.spmv(fmt, x, reordering=r, use_pallas=True)
    y_csr = core.spmv(scrambled, x, use_pallas=True)
    plan = compile_plan(scrambled, reorder=r, device=dev)
    y_plan = plan.execute(x)
    sync(dev)
    counts = K.launch_counts()
    check(plan.format_name == "dia" and plan.chosen == "rcm",
          f"reorder: compile gave {plan.format_name}/{plan.chosen}")
    check(torch.equal(y_plan, y_dia),
          "reorder: the compiled plan differs from the per-call result")
    check(close(y_dia, y_csr),
          "reorder: DIA after RCM differs from the scrambled CSR")
    y_plain = core.spmv(fmt, x, reordering=r, use_pallas=False)
    check(close(y_dia, y_plain), "reorder: DIA differs from its plain path")
    err = float((y_dia - y_csr).abs().max())
    dia_ms = time_ms(lambda: core.spmv(fmt, x, reordering=r), reps, dev)
    csr_ms = time_ms(lambda: core.spmv(scrambled, x), reps, dev)
    log(f"reorder spmv: dia(rcm) vs csr(scrambled) max abs err {err:.3g}; "
        f"apply_s={plan.compile_stats['reorder_s']:.2f} "
        f"compile_s={compile_seconds(plan):.2f} "
        f"spmv_dia_rcm_ms={dia_ms:.4f} spmv_csr_scrambled_ms={csr_ms:.4f} "
        f"(per call: x gather, kernel, y scatter)")
    log(f"reorder launches {json.dumps(counts)}")
    for k in ("spmv_dia", "spmv_csr"):
        check(dev.type != "cuda" or counts[k] > 0,
              f"reorder path launched {k} no time")
    return {"plan": plan, "counts": counts}


def run_rmat_rcm(adj, main_res, dev, K, drivers, cache, rcm):
    """R-MAT PageRank with the RCM of its operand, kernels vs plain.
    `rcm` is (the RCM of the adjacency, its seconds) from the compile
    phase: RCM reads the symmetrised pattern, which the PageRank operand
    (the adjacency's transpose, normalised) shares, so it is the
    operand's RCM too (equal permutations at 2^12-2^18 on the CPU)."""
    r, rcm_s = rcm
    log(f"rmat_rcm 2^{adj.n_rows.bit_length() - 1}: rcm_s={rcm_s:.2f} "
        f"(the compile phase's, of the adjacency) stats={r.stats}")
    r0 = np.random.default_rng(7).uniform(0.5, 1.5, adj.n_rows) \
        .astype(np.float32)
    kw = dict(tol=PR_TOL, r0=r0, reorder=r, plan_cache=cache, device=dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = drivers.pagerank(adj, **kw)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    ms = spmv_ms(res.plan, dev)
    report_run("rmat_rcm", "rmat", "pagerank", res, wall, spmv=ms)
    log(f"rmat_rcm spmv_ms={ms:.4f} (rcm, incl. x gather and y scatter) "
        f"vs {spmv_ms(main_res.plan, dev):.4f} unreordered; iters "
        f"{res.n_iters} vs {main_res.n_iters}")
    log(f"rmat_rcm launches {json.dumps(counts)}")
    for k in FORMAT_KERNELS[res.plan.format_name]:
        check(dev.type != "cuda" or counts[k] >= res.n_iters,
              f"rmat_rcm path launched {k} {counts[k]} times")
    plain_twins(cache)
    plain = drivers.pagerank(adj, use_pallas=False, **kw)
    check(plain.n_iters == res.n_iters, f"rmat_rcm pagerank: iterations "
          f"{res.n_iters} vs {plain.n_iters}")
    compare_pagerank("rmat_rcm", res, plain)
    return {"plan": res.plan, "counts": counts}


def run_bell(log2n, dev, K, CSR, core, drivers, cache, reps):
    """A blocked graph: per-call BELL SpMV and PageRank on BELL."""
    n = 1 << log2n
    t0 = time.perf_counter()
    adj = CSR.from_coo(*blocked_coo(n, TILES_PER_1024 * n // 1024), n, n,
                       device=dev)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bell = core.auto_format(adj)
    auto_s = time.perf_counter() - t0
    log(f"bell 2^{log2n}: nnz={adj.nnz} gen_s={gen_s:.2f} "
        f"auto_format_s={auto_s:.2f} fmt={type(bell).__name__}")
    if not check(type(bell).__name__ == "BELL",
                 f"bell: auto_format gave {type(bell).__name__}, not BELL"):
        return None
    gen = torch.Generator().manual_seed(4)
    x = torch.rand(n, generator=gen).to(dev)
    xi = torch.randint(-8, 9, (n,), generator=gen).float().to(dev)
    # the same blocks with integer values: every float32 sum is exact
    bell_int = dataclasses.replace(
        bell, data=int_values(bell.data, "plus_times", gen))
    K.reset_launch_counts()
    y, yi = core.spmv(bell, x), core.spmv(bell_int, xi)
    t0 = time.perf_counter()
    res = drivers.pagerank(adj, tol=PR_TOL, plan_cache=cache, device=dev)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    log(f"bell launches {json.dumps(counts)}")
    check(dev.type != "cuda" or counts["spmv_bell"] >= 2 + res.n_iters,
          f"bell path launched spmv_bell {counts['spmv_bell']} times")
    check(res.plan.format_name == "bell",
          f"bell pagerank compiled to {res.plan.format_name}")
    prep = res.plan.prep
    c = res.plan.container
    log(f"bell pagerank layout: blocks_per_row={c.blocks_per_row} "
        f"real_blocks={prep.masks.shape[0]} kept_values="
        f"{prep.values.numel()} layout_GiB="
        f"{layout_bytes(prep.values, prep.val_ptr, prep.masks) / 2 ** 30:.3f}"
        f" padded_GiB={c.storage_bytes() / 2 ** 30:.3f}")
    report_run("bell", "blocked", "pagerank", res, wall,
               spmv=spmv_ms(res.plan, dev))
    check(torch.equal(yi, core.spmv(bell_int, xi, use_pallas=False)),
          "bell: per-call spmv differs from its plain path on integers")
    # normal values cancel, so a row's rounding scales with Σ|a||x|, not
    # with its value: held to rtol 1e-5 of that sum
    scale = core.spmv(dataclasses.replace(bell, data=bell.data.abs()),
                      x.abs(), use_pallas=False)
    err = (y - core.spmv(bell, x, use_pallas=False)).abs()
    check(bool((err <= REAL_RTOL * scale + REAL_ATOL).all()),
          "bell: per-call spmv differs from its plain path")
    log(f"bell per-call vs plain: integer x bit-identical, real x max abs "
        f"err {float(err.max()):.3g} (max err / row sum of |a||x| "
        f"{float((err / scale.clamp(min=1e-30)).max()):.3g})")
    call_ms = time_ms(lambda: core.spmv(bell, x), reps, dev)
    log(f"bell per-call spmv_ms={call_ms:.4f} (blocks_per_row="
        f"{bell.blocks_per_row}, padded {bell.storage_bytes() / 2 ** 30:.3f}"
        f" GiB)")
    plain_twins(cache)
    plain = drivers.pagerank(adj, tol=PR_TOL, plan_cache=cache,
                             use_pallas=False, device=dev)
    check(plain.n_iters == res.n_iters, f"bell pagerank: iterations "
          f"{res.n_iters} vs {plain.n_iters}")
    compare_pagerank("bell", res, plain)
    return {"plan": res.plan, "counts": counts, "bell": bell, "adj": adj}


# ---------------------------------------------------------------------------
# compile: the reference's default plan.compile, scored by the cost model
# ---------------------------------------------------------------------------

class AnalyzeRecorder:
    """Keeps every (matrix, `StructureReport`) pair that `plan.compile`
    analyses while active, so that its candidates' model features can be
    printed; the compile is unchanged."""

    def __init__(self, structure):
        self.structure, self.calls = structure, []

    def __enter__(self):
        self.orig = self.structure.analyze

        def analyze(m, *a, **kw):
            rep = self.orig(m, *a, **kw)
            self.calls.append((m, rep))
            return rep
        self.structure.analyze = analyze
        return self

    def __exit__(self, *exc):
        self.structure.analyze = self.orig

    def by_label(self, tag, plan):
        """label -> report of each scored candidate, told apart by the
        analysed matrix's fingerprint: 'none' is the compiled input's
        (the plan's fingerprint), the one other candidate the one other
        matrix.  The first report of a matrix is the compile's own (an
        analytic score analyses it again).  Fails unless the compile
        analysed exactly one distinct matrix per candidate."""
        from repro_torch.plan.fingerprint import matrix_fingerprint

        first: dict = {}
        for m, rep in self.calls:
            first.setdefault(matrix_fingerprint(m), rep)
        labels = sorted(plan.predicted)
        others = [lab for lab in labels if lab != "none"]
        ok = (len(first) == len(labels) and len(others) <= 1
              and ("none" not in labels or plan.fingerprint in first))
        if not check(ok, f"compile {tag}: analysed {len(first)} distinct "
                         f"matrices for candidates {labels}"):
            return {}
        out = {"none": first.pop(plan.fingerprint)} if "none" in labels \
            else {}
        out.update(zip(others, first.values()))
        return out


def int_twin(P, plan, gen):
    """The plan with integer values in its container and layout (same
    reordering, format and knobs), and that plan's `use_pallas=False`
    twin: every float32 sum of theirs is exact."""
    c = plan.container
    fields = {"DIA": ("data",), "CSR": ("data",),
              "HYB": ("data", "hvals")}[type(c).__name__]
    ci = dataclasses.replace(c, **{f: int_values(getattr(c, f),
                                                 "plus_times", gen)
                                   for f in fields})
    kern = dataclasses.replace(P.plan_for_container(ci),
                               format_name=plan.format_name,
                               reordering=plan.reordering)
    return kern, dataclasses.replace(kern, prep=None, use_pallas=False)


def show_compile(tag, plan, by_label, features_for, model):
    """Print a compiled plan's candidates (features of the reports in
    `by_label`, predicted log2 and GFLOPS), its decision and its stage
    seconds; check that each model score is 2 ** model(features)
    exactly."""
    st = plan.compile_stats
    labels = sorted(plan.predicted) if plan.predicted else [plan.chosen]
    for label in labels:
        pred = plan.predicted.get(label, {})
        line = f"compile {tag} {label}:"
        rep = by_label.get(label)
        if rep is not None and model is not None:
            f = features_for(rep, plan.threads)
            yhat = float(model.predict(f[None, :])[0])
            line += " features=[" + ", ".join(repr(float(v)) for v in f) + \
                f"] log2_gflops={yhat!r}"
            if pred.get("predictor") == "model":
                check(2.0 ** yhat == pred["gflops"],
                      f"compile {tag} {label}: model score "
                      f"{pred['gflops']!r} is not 2**{yhat!r}")
        if pred:
            line += f" gflops={pred['gflops']!r} ({float(pred['gflops']).hex()})"
        log(line)
    log(f"compile {tag}: chosen={plan.chosen} format={plan.format_name} "
        f"scoring={st['scoring']} " + " ".join(
            f"{k}={st[k]:.4f}" for k in ("reorder_s", "analyze_s",
                                          "predict_s", "convert_s",
                                          "prepare_s") if k in st))


def check_decision(tag, plan, pinned):
    """The reference's decision (and exact scores) on the same matrix."""
    want = REFERENCE_DECISIONS.get(tag) if pinned else None
    if want is None:
        log(f"compile {tag}: no pinned reference decision at this size")
        return
    chosen, fmt, scoring, scores = want
    got = (plan.chosen, plan.format_name, plan.compile_stats["scoring"],
           {k: float(v["gflops"]).hex() for k, v in plan.predicted.items()})
    check(got == (chosen, fmt, scoring, scores),
          f"compile {tag}: decision {got} is not the reference's "
          f"{(chosen, fmt, scoring, scores)}")
    log(f"compile {tag}: reference decision {chosen}/{fmt}/{scoring} "
        f"and scores bit-identical: {got == (chosen, fmt, scoring, scores)}")


def run_plan_checks(tag, P, K, plan, dev, gen):
    """The plan and its integer twin through the kernels, launch counts
    set to 0 just before and read just after: the integer twin equals
    its use_pallas=False twin bit for bit, the real plan its own within
    rtol 1e-5."""
    n = plan.n_cols
    kern, plain = int_twin(P, plan, gen)
    xi = torch.randint(-8, 9, (n,), generator=gen).float().to(dev)
    x = torch.rand(n, generator=gen).to(dev)
    K.reset_launch_counts()
    y = plan.execute(x)
    yi = kern.execute(xi)
    sync(dev)
    counts = K.launch_counts()
    real_plain = dataclasses.replace(plan, prep=None, use_pallas=False)
    exact = torch.equal(yi, plain.execute(xi))
    near = close(y, real_plain.execute(x))
    check(exact, f"compile {tag}: integer plan differs from its plain twin")
    check(near, f"compile {tag}: plan differs from its plain twin")
    for k in FORMAT_KERNELS[plan.format_name]:
        check(dev.type != "cuda" or counts[k] > 0,
              f"compile {tag} plan launched {k} no time")
    ms = spmv_ms(plan, dev)
    log(f"compile {tag} execute: integer x bit-identical to plain {exact}, "
        f"real x within rtol {REAL_RTOL} {near}; spmv_ms={ms:.4f}; "
        f"launches {json.dumps({k: v for k, v in counts.items() if v})}")
    return counts


class SharedRcm:
    """While active, `reorder.STRATEGIES["rcm"]` computes a matrix's RCM
    once and hands the same `Reordering` to every later compile of that
    matrix: the band's default compile and its oracle compile score the
    same 'rcm' candidate, which took 38-41 s a compile at 2^22.
    `seconds[id(matrix)]` keeps the time of each first computation."""

    def __enter__(self):
        from repro_torch.reorder import STRATEGIES

        self.strategies = STRATEGIES
        self.rcm = STRATEGIES["rcm"]
        self.memo: dict = {}
        self.seconds: dict = {}

        def shared(csr):
            hit = self.memo.get(id(csr))
            if hit is None or hit[0] is not csr:
                t0 = time.perf_counter()
                hit = (csr, self.rcm(csr))
                self.seconds[id(csr)] = time.perf_counter() - t0
                self.memo[id(csr)] = hit
            return hit[1]

        STRATEGIES["rcm"] = shared
        return self

    def __exit__(self, *exc):
        self.strategies["rcm"] = self.rcm
        self.memo.clear()


def run_compile(args, dev, K, P, core, adjs, band, scrambled, rmat_matrix):
    """The compile phase: the reference's default `plan.compile` on the
    main path's FD and R-MAT and the reorder phase's scrambled band,
    `predictor="oracle"` on the band (analytic) and on R-MAT 2^11
    (replay), a fresh PlanCache's scoring counters, then `core.spmv`'s
    pagerank, power_iteration and dense branch through the kernels
    against their plain paths.  The band's RCM is computed once for its
    two compiles (`SharedRcm`).  Returns the launch counts, (the band
    oracle plan's reordering -- the RCM of the band --, the seconds of
    that RCM plus the oracle compile's permutation) and (the RCM of the
    R-MAT adjacency that its default compile scored, its seconds)."""
    from repro_torch.core import structure
    from repro_torch.plan.costmodel import default_model, features_for

    cspmv = importlib.import_module("repro_torch.core.spmv")

    model = default_model()
    check(model is not None, "compile: the shipped cost model did not load")
    gen = torch.Generator().manual_seed(19)
    totals: dict = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    band_rcm = None
    pinned_main = args.log2n == 22
    pinned_band = args.reorder_log2n == 22
    cases = [("fd", adjs["fd"], {}, pinned_main),
             ("rmat", adjs["rmat"], {}, pinned_main),
             ("band", scrambled, {}, pinned_band),
             ("band oracle", scrambled, {"predictor": "oracle"},
              pinned_band)]
    with SharedRcm() as shared:
        for tag, m, kw, pinned in cases:
            t0 = time.perf_counter()
            with AnalyzeRecorder(structure) as rec:
                plan = P.compile(m, device=dev, **kw)
            sync(dev)
            wall = time.perf_counter() - t0
            log(f"compile {tag} 2^{m.n_rows.bit_length() - 1}: nnz={m.nnz} "
                f"options={kw or 'defaults'} wall_s={wall:.2f}")
            show_compile(tag, plan, rec.by_label(tag, plan), features_for,
                         model)
            del rec
            if "predictor" not in kw:
                check(plan.compile_stats["scoring"] == "model",
                      f"compile {tag}: scored by "
                      f"{plan.compile_stats['scoring']}, not the model")
            check_decision(tag, plan, pinned)
            add(run_plan_checks(tag, P, K, plan, dev, gen))
            if tag == "band oracle":
                rcm_s = shared.seconds[id(scrambled)]
                band_rcm = (plan.reordering,
                            plan.compile_stats["reorder_s"] + rcm_s)
                log(f"compile band oracle: the 'rcm' candidate is the "
                    f"default compile's (one RCM for both, rcm_s="
                    f"{rcm_s:.2f}); its reorder_s is the permutation alone")
            del plan
        rmat = adjs["rmat"]
        rmat_rcm = (shared.memo[id(rmat)][1], shared.seconds[id(rmat)])

    # the replay oracle and the cache's split by scoring, on R-MAT 2^11
    small = rmat_matrix(1 << 11, device=dev)
    cache = P.PlanCache()
    for tag, pred in (("rmat2^11 oracle", "oracle"),
                      ("rmat2^11 model", "model")):
        plan = cache.get_or_compile(small, predictor=pred, device=dev)
        show_compile(tag, plan, {}, features_for, None)
        check_decision(tag, plan, True)
    st = cache.stats()
    ok = (st["predictor_compiles"], st["oracle_compiles"]) == (1, 1)
    check(ok, f"compile cache: predictor/oracle compiles "
          f"{st['predictor_compiles']}/{st['oracle_compiles']}, not 1/1")
    log(f"compile cache: predictor_compiles={st['predictor_compiles']} "
        f"predictor_compile_s={st['predictor_compile_s']} "
        f"oracle_compiles={st['oracle_compiles']} "
        f"oracle_compile_s={st['oracle_compile_s']}")

    # core.spmv: pagerank, power_iteration and the dense branch
    K.reset_launch_counts()
    t0 = time.perf_counter()
    pr = cspmv.pagerank(adjs["fd"], device=dev)
    lam, v = cspmv.power_iteration(band, torch.ones(band.n_cols, device=dev))
    dense_n = 1 << 12
    dm = rmat_matrix(dense_n, device=dev)
    # integer values: the dense and the sparse sums are exact
    dm = dataclasses.replace(dm, data=int_values(dm.data, "plus_times", gen))
    xd = torch.randint(-8, 9, (dense_n,), generator=gen).float().to(dev)
    yd = cspmv.spmv(dm.to_dense(), xd)
    sync(dev)
    counts = K.launch_counts()
    kern_s = time.perf_counter() - t0
    add(counts)
    pr_plain = cspmv.pagerank(adjs["fd"], use_pallas=False, device=dev)
    lam_p, v_p = cspmv.power_iteration(band, torch.ones(band.n_cols,
                                                        device=dev),
                                       use_pallas=False)
    pr_ok = bool(torch.isfinite(pr).all()) and bool(torch.allclose(
        pr, pr_plain, rtol=PR_RTOL, atol=0.0))
    pi_ok = close(v, v_p) and bool(torch.isclose(lam, lam_p, rtol=REAL_RTOL))
    dense_ok = torch.equal(yd, dm.to_dense() @ xd) and \
        torch.equal(yd, cspmv.spmv(dm, xd, use_pallas=False))
    check(pr_ok, "compile: core.spmv.pagerank differs from its plain path")
    check(pi_ok, "compile: power_iteration differs from its plain path")
    check(dense_ok, "compile: the dense spmv branch differs from "
          "CSR.to_dense() @ x or from the sparse product")
    for k in ("spmv_csr",):
        check(dev.type != "cuda" or counts[k] > 0,
              f"compile: core.spmv paths launched {k} no time")
    log(f"compile core.spmv: pagerank FD 2^{adjs['fd'].n_rows.bit_length() - 1}"
        f" (32 iterations) within rtol {PR_RTOL} of plain {pr_ok}, sum "
        f"{float(pr.sum()):.6f}; power_iteration band lam={float(lam):.6f} "
        f"plain lam={float(lam_p):.6f} ok={pi_ok}; dense 2^12 (integer "
        f"values) == to_dense() @ x == sparse {dense_ok}; kernels_s={kern_s:.2f} launches "
        f"{json.dumps({k: v for k, v in counts.items() if v})}")
    return totals, band_rcm, rmat_rcm


# ---------------------------------------------------------------------------
# attention: the ops entry points at Granite-8B's width
# ---------------------------------------------------------------------------

def attn_compare(errs, kname, label, got, want, how):
    """`how`: "f32" (rtol 1e-4 / atol 1e-5), "ulp" (one bfloat16 ulp) or
    "oracle" (bfloat16 against float32 math, 5e-2)."""
    from repro_torch.testing import within_bf16_ulp

    err = float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0
    ok = bool(torch.isfinite(got.float()).all()) and got.shape == want.shape
    if how == "f32":
        ok = ok and bool(torch.allclose(got, want, rtol=ATTN_RTOL,
                                        atol=ATTN_ATOL))
        tol = f"rtol {ATTN_RTOL} atol {ATTN_ATOL}"
    elif how == "ulp":
        ok = ok and within_bf16_ulp(got, want)
        tol = "one bf16 ulp"
    else:
        ok = ok and bool(torch.allclose(got.float(), want.float(),
                                        rtol=ORACLE_BF16_TOL,
                                        atol=ORACLE_BF16_TOL))
        tol = f"rtol=atol {ORACLE_BF16_TOL}"
    if how != "oracle":
        errs[kname] = max(errs.get(kname, 0.0), err)
    check(ok, f"attention {kname} {label}: differs (max abs err {err:.3g}, "
              f"{tol})")
    log(f"attention {kname} {label}: shape={tuple(got.shape)} {tol} "
        f"ok={ok} max_abs_err={err:.3g}")


def visible_pairs(sq, skv, causal, window) -> int:
    """(q, k) pairs the masks leave visible, per batch·head."""
    q = np.arange(sq)[:, None]
    lo = np.zeros((sq, 1), np.int64)
    hi = np.full((sq, 1), skv, np.int64)              # keys [lo, hi)
    if causal:
        hi = np.minimum(hi, q + 1)
    if window is not None:
        lo = np.maximum(lo, q - window + 1)
    return int(np.clip(hi - lo, 0, None).sum())


def paged_tables(n_seqs, max_len, seed, serve):
    """Lengths in [1, max_len] and the tables the port's allocator gives
    them after a seeded churn: targets grow a few blocks at a time while
    decoy sequences are admitted and released around them, so every
    table is scattered over a pool 2.5x the targets' need."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, max_len + 1, n_seqs)
    need = int(sum(-(-int(n) // PAGED_BLOCK) for n in lengths))
    cfg = serve.PoolConfig(n_blocks=int(2.5 * need) + 8,
                           block_size=PAGED_BLOCK,
                           max_blocks_per_seq=PAGED_MAX_BLOCKS)
    al = serve.BlockAllocator(cfg)
    for i in range(n_seqs):
        al.admit(i, 1)
    decoys, next_id = [], n_seqs
    cur = np.ones(n_seqs, np.int64)
    while (cur < lengths).any():
        i = int(rng.choice(np.flatnonzero(cur < lengths)))
        step = int(min(rng.integers(1, 8 * PAGED_BLOCK), lengths[i] - cur[i]))
        if not al.extend(i, step):
            raise RuntimeError("paged churn: the pool ran out")
        cur[i] += step
        left = need - sum(len(al.tables[j]) for j in range(n_seqs))
        size = int(rng.integers(1, 16 * PAGED_BLOCK))
        if rng.random() < 0.3 and al.n_free - left > 2 * size // PAGED_BLOCK:
            al.admit(next_id, size)
            decoys.append(next_id)
            next_id += 1
        if decoys and rng.random() < 0.2:
            al.release(decoys.pop(int(rng.integers(0, len(decoys)))))
    for d in decoys:
        al.release(d)
    tables = np.stack([al.table_array(i) for i in range(n_seqs)])
    return cfg, al, lengths.astype(np.int32), tables


SASS_OPS = ("HGMMA", "HMMA", "FFMA", "LDG", "LDGSTS")


def sass(lib: str):
    """Every function of the library `lib` as the card's compiler left it:
    ({mangled name: [(opcode, operands), ...]} from `cuobjdump -sass`,
    {mangled name: "REG:n LOCAL:n"} from `--dump-resource-usage`)."""
    from repro_torch.kernels import _build

    tool = str(Path(_build.nvcc()).parent / "cuobjdump")

    def dump(flag):
        out = subprocess.run([tool, flag, lib], capture_output=True,
                             text=True, timeout=120)
        check(out.returncode == 0, f"cuobjdump {flag} failed: "
              f"{out.stderr.strip()[-300:]}")
        return out.stdout

    code, fn = {}, None
    for line in dump("-sass").splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            code[fn] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z0-9_.]+)([^;]*);", line)
        if fn is not None and m:
            code[fn].append((m.group(1), m.group(2).strip()))
    usage, fn = {}, None
    for line in dump("--dump-resource-usage").splitlines():
        if line.strip().startswith("Function "):
            fn = line.strip()[len("Function "):].rstrip(":")
        elif fn is not None and "REG:" in line:
            usage[fn] = " ".join(w for w in line.split()
                                 if w.split(":")[0] in ("REG", "LOCAL"))
    return code, usage


def op_counts(instrs) -> dict:
    counts = dict.fromkeys(SASS_OPS, 0)
    for op, _ in instrs:
        if op.split(".")[0] in counts:
            counts[op.split(".")[0]] += 1
    return counts


def load_batches(instrs) -> list:
    """Global loads issued before their first use, in program order: the
    length of each run of LDG instructions issued before an instruction
    reads a register one of them writes (a static count of the loads in
    flight when the first of them is needed)."""
    pending, batches, n = set(), [], 0
    for op, args in instrs:
        base = op.split(".")[0]
        ops = [a.strip() for a in args.split(",")] if args else []
        dest = (bool(ops) and re.fullmatch(r"R\d+", ops[0]) is not None
                and not base.startswith(("ST", "RED", "ATOM")))
        srcs = set()
        for r, wide in re.findall(r"\bR(\d+)(\.64)?",
                                  ",".join(ops[1:] if dest else ops)):
            srcs |= {int(r), int(r) + 1} if wide else {int(r)}
        if pending & srcs:
            batches.append(n)
            pending, n = set(), 0
        if base == "LDG" and dest:
            width = 4 if ".128" in op else 2 if ".64" in op else 1
            pending |= {int(ops[0][1:]) + i for i in range(width)}
            n += 1
    return batches


def flash_sass(_build) -> None:
    """Log each flash kernel's HGMMA / HMMA / FFMA instruction counts and
    its registers and local memory; fail unless every bfloat16 and every
    float32 instance issues tensor-core instructions."""
    def name(mangled):
        m = re.search(r"flash_(\w+?)_kernelILi(\d+)E", mangled)
        m2 = re.search(r"flash_(\w+?)_kernel", mangled)
        return (f"{m.group(1)} d{m.group(2)}" if m
                else m2.group(1) if m2 else mangled)

    code, usage = sass(str(_build.library_path("flash_attention")))
    counts = {name(fn): op_counts(ins) for fn, ins in code.items()}
    usage = {name(fn): u for fn, u in usage.items()}
    for fn, c in sorted(counts.items()):
        log(f"device flash SASS {fn}: " + " ".join(
            f"{op}={c[op]}" for op in SASS_OPS[:3]) + f" {usage.get(fn, '')}")
    for kind in ("bf16", "f32"):
        inst = [fn for fn in counts if fn.startswith(kind + " ")]
        check(len(inst) == 2 and all(counts[fn]["HGMMA"] + counts[fn]["HMMA"]
                                     for fn in inst),
              f"flash {kind} instances {inst} do not all run on the tensor "
              "cores (no HGMMA or HMMA)")


def paged_name(mangled: str) -> str:
    m = re.search(r"(paged_\w*?kernel)I(13__nv_bfloat16|f)"
                  r"(?:Li(\d+)ELi(\d+)E)?", mangled)
    if not m:
        return mangled
    dt = "bf16" if m.group(2) != "f" else "f32"
    return m.group(1) + f" {dt}" + (f" d{m.group(3)} g{m.group(4)}"
                                    if m.group(3) else "")


def paged_sass(lib: str, label: str, instances, dump=None) -> None:
    """Log the paged kernels' registers and local memory, their global
    loads (LDG, and LDGSTS = cp.async) and how many LDG issue before the
    first use of one (`load_batches`), for the named instances; with
    `dump` (a directory), write each one's SASS there as well."""
    code, usage = sass(lib)
    for fn, ins in sorted(code.items()):
        short = paged_name(fn)
        if not any(short.endswith(i) for i in instances):
            continue
        if dump is not None:
            Path(dump).mkdir(parents=True, exist_ok=True)
            (Path(dump) / f"{label} {short}.sass".replace(" ", "_")) \
                .write_text("".join(f"{op} {a}\n" for op, a in ins))
        c, batches = op_counts(ins), load_batches(ins)
        log(f"device paged SASS {label} {short}: LDG={c['LDG']} "
            f"LDGSTS={c['LDGSTS']} FFMA={c['FFMA']} {usage.get(fn, '')}; "
            f"LDG issued before first use, in order: {batches} "
            f"(max {max(batches, default=0)})")


def time_entry(times, key, kern, plain, lib, need_bytes, flops, dtype,
               label, reps, dev) -> None:
    """Time `kern`, its plain version and the library call `lib` (or
    None) into `times[key]`, with the bound: the larger of `need_bytes`
    at the memory rate and `flops` at the peak for `dtype`."""
    # operations at the card's peak for the inputs' type: bfloat16 on
    # the tensor cores; float32 at the better of the FMA units and
    # three TF32 products on the tensor cores (`tc3_bound_ms`, what
    # float32 accuracy costs there); the FMA units' and one pass of
    # the tensor cores' figures are printed beside it
    f32 = dtype == torch.float32
    bytes_ms = 1e3 * need_bytes / HBM_BYTES_PER_S
    fma = 1e3 * flops / F32_OPS_PER_S
    tc = 1e3 * flops / (TF32_TC_OPS_PER_S if f32 else BF16_TC_OPS_PER_S)
    tc3 = 3 * tc if f32 else None
    ops_ms = min(fma, tc3) if f32 else tc
    bound = max(bytes_ms, ops_ms)
    ms = time_ms(kern, reps, dev)
    plain_ms = time_ms(plain, 3, dev)
    lib_ms = time_ms(lib, reps, dev) if lib is not None else None
    times[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                      bound_ms=bound, fma_bound_ms=fma, tc_bound_ms=tc,
                      tc3_bound_ms=tc3,
                      bound_by="bytes" if bytes_ms >= ops_ms
                      else "operations")
    rate = (f" tflops={flops / ms / 1e9:.1f}"
            if key.startswith("flash") else "")
    log(f"time {key} [{label}]: kernel_ms={ms:.4f}{rate} plain_ms="
        f"{plain_ms:.4f} library_ms="
        f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} bound_bytes="
        f"{need_bytes} flops={flops} bound_ms={bound:.4f} "
        f"({ms / bound:.2f}x bound, by "
        f"{times[key]['bound_by']}) fma_bound_ms={fma:.4f} "
        f"tc_bound_ms={tc:.4f}"
        + (f" tc3_bound_ms={tc3:.4f}" if f32 else ""))


def run_attention(args, dev, K):
    """Drive `ops.flash_attention` and `ops.paged_attention` at
    Granite-8B's width, check each kernel against its plain version and
    its oracle, and time both.  Returns (launch counts, errs, times)."""
    from repro_torch import serve
    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False     # float32 plain math
    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    b, s = args.attn_batch, args.attn_seq
    g = N_HEADS // N_KV_HEADS
    bf = torch.bfloat16

    def flash_inputs(seq, dtype):
        q = randn((b, N_HEADS, seq, HEAD_DIM), dtype)
        k = randn((b, N_KV_HEADS, seq, HEAD_DIM), dtype)
        v = randn((b, N_KV_HEADS, seq, HEAD_DIM), dtype)
        # the caller broadcasts KV heads, in jnp.repeat's order
        return q, k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)

    flash_cases = [("causal", s, bf, True, None),
                   (f"window {ATTN_WINDOW}", s, bf, True, ATTN_WINDOW),
                   ("not causal", s, bf, False, None),
                   ("causal f32", s // 2, torch.float32, True, None)]
    inputs = {name: flash_inputs(seq, dt)
              for name, seq, dt, _, _ in flash_cases}

    t0 = time.perf_counter()
    cfg, al, lengths, tables = paged_tables(args.paged_seqs,
                                            args.paged_max_len, 5, serve)
    churn_s = time.perf_counter() - t0
    pool = serve.init_pool(cfg, N_KV_HEADS, HEAD_DIM, 1, dtype=bf,
                           device=dev)
    for t in pool.values():          # stale contents everywhere
        t.copy_(randn(t.shape, bf))
    seq = np.repeat(np.arange(len(lengths)), lengths)
    pos = np.concatenate([np.arange(n) for n in lengths])
    blocks = tables[seq, pos // PAGED_BLOCK]
    k_new = randn((len(seq), N_KV_HEADS, HEAD_DIM), bf)
    v_new = randn((len(seq), N_KV_HEADS, HEAD_DIM), bf)
    serve.write_token(pool, 0, torch.from_numpy(blocks),
                      torch.from_numpy(pos % PAGED_BLOCK), k_new, v_new)
    k_pool, v_pool = pool["k"][0], pool["v"][0]
    tables_t = torch.from_numpy(tables).to(dev)
    lengths_t = torch.from_numpy(lengths).to(dev)
    q_dec = randn((len(lengths), N_HEADS, HEAD_DIM), bf)
    paged_f32 = (q_dec.float(), k_pool.float(), v_pool.float())
    log(f"attention paged pool: {cfg.n_blocks} blocks of {PAGED_BLOCK} "
        f"tokens, {2 * k_pool.numel() * 2 / 2 ** 30:.3f} GiB bf16; "
        f"{len(lengths)} sequences, {int(lengths.sum())} tokens "
        f"(lengths {int(lengths.min())}..{int(lengths.max())}), "
        f"utilization after the churn {al.utilization():.3f}, "
        f"churn_s={churn_s:.2f}")
    n_chk = min(4, len(lengths))
    k_seq, v_seq = serve.gather_kv(pool, 0, tables_t[:n_chk])
    first = np.concatenate([[0], np.cumsum(lengths)])
    same = all(torch.equal(k_seq[i, :lengths[i]],
                           k_new[first[i]:first[i + 1]]) and
               torch.equal(v_seq[i, :lengths[i]],
                           v_new[first[i]:first[i + 1]])
               for i in range(n_chk))
    check(same, "attention: gather_kv does not return what write_token "
                "wrote")

    # -- the path: every count set to 0 just before, read just after ------
    sync(dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    outs = {name: ops.flash_attention(*inputs[name], causal=c, window=w)
            for name, _, _, c, w in flash_cases}
    outs["paged"] = ops.paged_attention(q_dec, k_pool, v_pool, tables_t,
                                        lengths_t)
    outs["paged f32"] = ops.paged_attention(*paged_f32, tables_t, lengths_t)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    log(f"attention launches {json.dumps(counts)} wall_s={wall:.3f}")
    for k in ("flash_attention", "paged_attention"):
        check(dev.type != "cuda" or counts[k] > 0,
              f"attention path launched {k} no time")

    # -- kernels against their plain versions and the oracles --------------
    errs: dict = {}
    for name, seq, dt, c, w in flash_cases:
        q, k, v = (t.reshape(b * N_HEADS, seq, HEAD_DIM)
                   for t in inputs[name])
        got = outs[name].reshape(b * N_HEADS, seq, HEAD_DIM)
        attn_compare(errs, "flash_attention", name, got,
                     K.flash_attention_plain(q, k, v, c, w),
                     "f32" if dt == torch.float32 else "ulp")
        check(torch.equal(got, K.flash_attention(q, k, v, c, w)),
              f"attention flash_attention {name}: replay differs")
        one = slice(0, N_HEADS)                 # batch element 0
        attn_compare(errs, "flash_attention", f"{name} vs mha_ref",
                     got[one], ref.mha_ref(q[one], k[one], v[one], c, w),
                     "f32" if dt == torch.float32 else "oracle")
    for name, args_ in (("paged", (q_dec, k_pool, v_pool)),
                        ("paged f32", paged_f32)):
        f32 = args_[0].dtype == torch.float32
        got = outs[name]
        attn_compare(errs, "paged_attention", name, got,
                     K.paged_attention_plain(*args_, tables_t, lengths_t),
                     "f32" if f32 else "ulp")
        check(torch.equal(got, K.paged_attention(*args_, tables_t,
                                                 lengths_t)),
              f"attention paged_attention {name}: replay differs")
        few = slice(0, 8)
        qq, kp, vp = args_
        attn_compare(errs, "paged_attention", f"{name} vs paged_attention_ref",
                     got[few], ref.paged_attention_ref(
                         qq[few], kp.repeat_interleave(g, dim=2),
                         vp.repeat_interleave(g, dim=2), tables_t[few],
                         lengths_t[few]), "f32" if f32 else "oracle")

    # -- times ----------------------------------------------------------------
    reps = max(args.reps // 10, 3)
    times = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def entry(key, kern, plain, lib, need_bytes, flops, dtype, label):
        time_entry(times, key, kern, plain, lib, need_bytes, flops, dtype,
                   label, reps, dev)

    for name, seq, dt, c, w in flash_cases:
        q, k, v = inputs[name]
        qf, kf, vf = (t.reshape(b * N_HEADS, seq, HEAD_DIM)
                      for t in (q, k, v))
        mask = None
        if w is not None:
            i = torch.arange(seq, device=dev)
            mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < w)
        pairs = b * N_HEADS * visible_pairs(seq, seq, c, w)
        entry("flash_attention" if name == "causal"
              else f"flash_attention {name}",
              lambda qf=qf, kf=kf, vf=vf, c=c, w=w:
                  K.flash_attention(qf, kf, vf, c, w),
              lambda qf=qf, kf=kf, vf=vf, c=c, w=w:
                  K.flash_attention_plain(qf, kf, vf, c, w),
              lambda q=q, k=k, v=v, c=c, m=mask:
                  sdpa(q, k, v, attn_mask=m, is_causal=c and m is None),
              4 * q.numel() * q.element_size(), 4 * HEAD_DIM * pairs, dt,
              f"{name}, batch {b} x {N_HEADS} heads x {seq} tokens, "
              f"{str(dt).split('.')[-1]}")
    walked = -(-lengths.astype(np.int64) // PAGED_BLOCK)
    for name, args_ in (("paged", (q_dec, k_pool, v_pool)),
                        ("paged f32", paged_f32)):
        qq = args_[0]
        el = qq.element_size()
        need = (2 * qq.numel() * el + 2 * int(lengths.sum()) * N_KV_HEADS
                * HEAD_DIM * el + 4 * int(walked.sum()) + 4 * len(lengths))
        entry("paged_attention" if name == "paged"
              else "paged_attention f32",
              lambda a=args_: K.paged_attention(*a, tables_t, lengths_t),
              lambda a=args_: K.paged_attention_plain(*a, tables_t,
                                                      lengths_t),
              None, need, 4 * HEAD_DIM * N_HEADS * int(lengths.sum()),
              qq.dtype,
              f"{name}, {len(lengths)} sequences, GQA "
              f"{N_HEADS}/{N_KV_HEADS}, block {PAGED_BLOCK}")
    # each CUDA kernel of a call, its device time from a trace: float32
    # flash's split passes and 3xTF32 kernel, paged's walk and merge
    seq = flash_cases[3][1]
    f32_qkv = [t.reshape(b * N_HEADS, seq, HEAD_DIM)
               for t in inputs["causal f32"]]
    for key, fn, names in (
            ("flash_attention causal f32",
             lambda: K.flash_attention(*f32_qkv, True, None),
             ("flash_split_k_kernel", "flash_split_vt_kernel",
              "flash_f32_kernel")),
            ("paged_attention", lambda: K.paged_attention(
                q_dec, k_pool, v_pool, tables_t, lengths_t),
             ("paged_split_kernel", "paged_merge_kernel")),
            ("paged_attention f32", lambda: K.paged_attention(
                *paged_f32, tables_t, lengths_t),
             ("paged_split_kernel", "paged_merge_kernel"))):
        traced = trace_ms(fn, reps, dev, names)
        log(f"time {key} traced: " + " ".join(
            f"{n}=" + ("not measured" if t is None else f"{t:.4f}")
            for n, t in traced.items()))
    return counts, errs, times


# ---------------------------------------------------------------------------
# lm: Granite-8B served through the decode engine
# ---------------------------------------------------------------------------

LM_ARCH = "granite-8b"              # published widths, half the depth
LM_LAYERS = 18                      # of 36: pays, with RWKV's, for lm_encdec
LM_SEED = 23                        # weights and requests
LM_ENGINE = dict(max_batch=8, max_context=1024, block_size=16)
LM_REQUESTS, LM_PROMPT, LM_NEW = 16, (16, 600), (8, 48)
LM_TRACE = (11, 20)                 # decode steps in the profiler window
LM_FORCED = (2, 16)                 # teacher-forced: requests, decode steps
LM_F32_TOL = 1e-3                   # float32 kernel path vs plain path
LM_TOL = 0.08                       # the reference's cache-vs-forward bar
LM_BF16_RATIO = 1.1                 # bf16 kernel path's error / plain's
LM_TIME_REPS = 200                  # timed calls at the phase's shapes
LM_FLASH_SHAPE = (32, 512, 128)     # (batch·heads, tokens, head_dim)
LM_PAGED_SEQS = 8                   # the engine's slots
PLAIN_OPS = ("aten::einsum", "scaled_dot_product")   # no kernel-path op


def lm_requests(Request, vocab, n, seed):
    """Seeded requests: prompts of LM_PROMPT tokens, budgets of LM_NEW."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1))
        out.append(Request(req_id=i,
                           prompt=rng.integers(1, vocab, plen).tolist(),
                           max_new_tokens=int(rng.integers(LM_NEW[0],
                                                           LM_NEW[1] + 1))))
    return out


def lm_split(recs) -> dict:
    """Device ms of a trace's records: flash, paged, GEMM and other."""
    split = dict.fromkeys(("flash", "paged", "gemm", "other"), 0.0)
    for key, (_, t) in recs.items():
        k = key.lower()
        part = ("flash" if "flash_" in k else "paged" if "paged_" in k
                else "gemm" if any(w in k for w in (
                    "gemm", "gemv", "xmma", "cutlass", "nvjet", "cublas"))
                else "other")
        split[part] += t / 1e3
    return split


def lm_engine_class(Engine, dev):
    """The engine with a torch.profiler window (CPU and CUDA) over its
    decode calls LM_TRACE[0]..LM_TRACE[1]: `window` is (wall ms, the
    profiler), `trace_s` the seconds the profiler's stop took inside
    the run."""

    class TracedEngine(Engine):
        calls = 0
        window = None
        trace_s = 0.0

        def decode(self, tokens):
            self.calls += 1
            first, last = LM_TRACE
            if dev.type == "cuda" and self.calls == first:
                from torch.profiler import ProfilerActivity, profile

                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.start()
                self.t0 = time.perf_counter()
            out = super().decode(tokens)
            if dev.type == "cuda" and self.calls == last:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                self.prof.stop()
                self.trace_s = time.perf_counter() - t1
                self.window = (1e3 * (t1 - self.t0), self.prof)
                del self.prof
            return out

    return TracedEngine


def run_lm(args, dev, K, errs, times):
    """Serve Granite-8B at full width with 18 of its 36 layers (its
    reduced config on the CPU) through the port's engine: prefill on the flash kernel, decode on the paged
    kernel.  Checks the requests, the launches and the trace, the kernel
    path against the plain path on teacher-forced steps, each kernel
    against its plain version at the phase's shapes; times both.
    Returns the launch counts of the served path."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.serve import Engine, EngineConfig, Request
    from repro_torch.tree import leaves, tree_map

    full = get_config(LM_ARCH)
    cfg = full.reduced() if args.cpu_rehearsal else full
    cfg = dataclasses.replace(cfg, n_layers=min(LM_LAYERS, cfg.n_layers))
    t0 = time.perf_counter()
    params = registry.get_model(cfg).init(
        torch.Generator(device=dev).manual_seed(LM_SEED), dev)
    sync(dev)
    n_params = sum(t.numel() for t in leaves(params))
    log(f"lm model {cfg.name}: layers={cfg.n_layers} of {full.n_layers} "
        f"d={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab} {cfg.dtype} params={n_params} "
        f"({n_params * 2 / 2 ** 30:.2f} GiB; param_count()="
        f"{cfg.param_count():.0f}) init_s={time.perf_counter() - t0:.2f}")

    # -- the served path: every count set to 0 just before, read after ---
    ecfg = EngineConfig(**LM_ENGINE, seed=LM_SEED)
    # one short request first loads the kernels and the GEMMs' plans
    Engine(cfg, params, ecfg).run(lm_requests(Request, cfg.vocab, 1,
                                              LM_SEED + 3))
    eng = lm_engine_class(Engine, dev)(cfg, params, ecfg)
    reqs = lm_requests(Request, cfg.vocab, LM_REQUESTS, LM_SEED)
    budgets = {r.req_id: r.max_new_tokens for r in reqs}
    sync(dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run(reqs)
    sync(dev)
    wall = time.perf_counter() - t0 - eng.trace_s
    counts = K.launch_counts()
    stats = eng.sched.stats()
    n_tok = sum(len(v) for v in out.values())
    log(f"lm launches {json.dumps(counts)}")
    log(f"lm engine: requests={len(out)}/{len(reqs)} steps={stats['steps']} "
        f"decode_steps={len(eng.decode_times)} prefills="
        f"{len(eng.prefill_times)} tokens={n_tok} wall_s={wall:.3f} "
        f"(the profiler's stop, {eng.trace_s:.3f} s, left out) "
        f"tokens_per_s={n_tok / wall:.1f} preemptions="
        f"{stats['preemptions']} prompt_tokens="
        f"{sum(len(r.prompt) for r in reqs)}")
    check({rid: len(v) for rid, v in out.items()} == budgets,
          "lm: not every request finished with its budget")
    if dev.type == "cuda":
        for k in ("flash_attention", "paged_attention"):
            check(counts[k] > 0, f"lm path launched {k} no time")
    by_bucket: dict = {}
    for bucket, s in eng.prefill_times:
        by_bucket.setdefault(bucket, []).append(1e3 * s)
    log("lm prefill ms by bucket: " + " ".join(
        f"{b}:n={len(v)},median={np.median(v):.2f}"
        for b, v in sorted(by_bucket.items())))
    host = 1e3 * np.array([t for i, t in enumerate(eng.decode_times, 1)
                           if not LM_TRACE[0] <= i <= LM_TRACE[1]])
    log(f"lm decode host ms a step (traced steps left out): "
        f"median={np.median(host):.3f} p90={np.percentile(host, 90):.3f} "
        f"min={host.min():.3f} steps={host.size}")
    if eng.window is None:
        log("lm trace: not measured (no card)")
    else:
        wall_ms, prof = eng.window
        avgs = prof.key_averages()
        n = LM_TRACE[1] - LM_TRACE[0] + 1
        # the kernels and copies alone: with CPU activity on, the ops
        # that launched them carry the same device time again
        recs = {}
        for ev in avgs:
            t = getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))
            if t > 0 and ev.count and \
                    ev.device_type == torch.autograd.DeviceType.CUDA:
                recs[ev.key] = (ev.count, t)
        split = lm_split(recs)
        device = sum(split.values())
        plain = sorted({ev.key for ev in avgs
                        if any(w in ev.key for w in PLAIN_OPS)})
        paged = {short_kernel(k): c for k, (c, _) in recs.items()
                 if "paged_" in k}
        STEP_MS["lm decode"] = device / n
        log(f"lm trace decode steps {LM_TRACE[0]}-{LM_TRACE[1]}: wall_ms="
            f"{wall_ms / n:.3f} device_ms={device / n:.3f} "
            + " ".join(f"{k}_ms={v / n:.3f}" for k, v in split.items())
            + f" busy_share={device / wall_ms:.3f} paged_records={paged} "
            f"plain_ops={plain}")
        check(bool(recs), "lm trace: the profiler recorded no device time")
        check(sum(paged.values()) >= 2 * n * cfg.n_layers,
              f"lm trace: {paged} paged records, not 2 a layer a step")
        check(not plain, f"lm trace: plain-path ops {plain} on the kernel "
              "path")
    if dev.type == "cuda":
        log(f"lm engine peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del eng

    # -- teacher-forced: the kernel path against the plain path -----------
    # bfloat16 first, as served, then the same weights in float32: at 36
    # layers the bfloat16 rounding of the residual stream alone moves
    # logits by about 0.1 (the plain path against the float32 one), so
    # the float32 pair, which runs the same tables, lengths and cache
    # view, is held to LM_F32_TOL, and the bfloat16 kernel path's mean
    # and max error against float32 to the plain path's own
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 plain math
    forced = lm_requests(Request, cfg.vocab, LM_FORCED[0], LM_SEED + 1)
    steps = torch.from_numpy(np.random.default_rng(LM_SEED + 2).integers(
        1, cfg.vocab, (LM_FORCED[0], LM_FORCED[1], 1)).astype(np.int32))

    def teacher_forced(p, c, kern):
        e = Engine(c, p, EngineConfig(
            max_batch=LM_FORCED[0], max_context=LM_ENGINE["max_context"],
            block_size=LM_ENGINE["block_size"]), use_kernels=kern)
        rows = [[e.prefill_slot(i, r.prompt).float()]
                for i, r in enumerate(forced)]
        for t in range(LM_FORCED[1]):
            step = e.decode(steps[:, t].to(dev)).float()
            for i in range(LM_FORCED[0]):
                rows[i].append(step[i])
        return torch.stack([torch.stack(r) for r in rows])

    bf16 = {kern: teacher_forced(params, cfg, kern) for kern in (True, False)}
    p32 = tree_map(lambda t: t.float(), params)
    c32 = dataclasses.replace(cfg, dtype="float32")
    f32 = {kern: teacher_forced(p32, c32, kern) for kern in (True, False)}
    del p32
    truth = f32[False]
    err = float((f32[True] - truth).abs().max())
    ok = bool(torch.isfinite(f32[True]).all()) and bool(torch.allclose(
        f32[True], truth, rtol=LM_F32_TOL, atol=LM_F32_TOL))
    check(ok, f"lm teacher-forced float32: kernel path differs from the "
              f"plain path (max abs err {err:.3g}, rtol=atol {LM_F32_TOL})")
    # (request, step, vocab) distances from the float32 plain path
    dist = {kern: (bf16[kern] - truth).abs() for kern in (True, False)}
    bar = float((bf16[True] - bf16[False]).abs().max())
    over = float((~torch.isclose(bf16[True], bf16[False], rtol=LM_TOL,
                                 atol=LM_TOL)).float().mean())
    mean_ratio = float(dist[True].mean() / dist[False].mean())
    max_ratio = float(dist[True].max() / dist[False].max())
    # per (request, step): the worst ratio of means, for the record
    per_row = dist[True].mean(-1) / dist[False].mean(-1)
    ok16 = bool(torch.isfinite(bf16[True]).all()) \
        and mean_ratio <= LM_BF16_RATIO and max_ratio <= LM_BF16_RATIO
    check(ok16, f"lm teacher-forced bfloat16: the kernel path's error "
                f"against float32 is {mean_ratio:.3f}x (mean) and "
                f"{max_ratio:.3f}x (max) the plain path's (limit "
                f"{LM_BF16_RATIO})")
    log(f"lm teacher-forced {LM_FORCED[0]} requests (prompts "
        f"{[len(r.prompt) for r in forced]}), prefill + {LM_FORCED[1]} "
        f"decode steps: float32 kernels vs plain max_abs_err={err:.4g} "
        f"(rtol=atol {LM_F32_TOL}) ok={ok}; bfloat16 kernels vs plain "
        f"max_abs_err={bar:.4g} share over rtol=atol {LM_TOL}: {over:.3g}; "
        f"against float32: kernels max {float(dist[True].max()):.4g} mean "
        f"{float(dist[True].mean()):.4g}, plain max "
        f"{float(dist[False].max()):.4g} mean {float(dist[False].mean()):.4g}"
        f" (ratio mean {mean_ratio:.3f} max {max_ratio:.3f}, limit "
        f"{LM_BF16_RATIO}) ok={ok16}; per request and step, mean ratio "
        f"{float(per_row.min()):.3f}..{float(per_row.max()):.3f}; "
        f"max|logit|={float(truth.abs().max()):.3g}")
    del bf16, f32, truth, dist, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- each kernel against its plain version at the phase's shapes -----
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    bf = torch.bfloat16

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    bh, sq, hd = LM_FLASH_SHAPE
    q, k, v = (randn((bh, sq, hd)) for _ in range(3))
    attn_compare(errs, "flash_attention", f"lm {bh}x{sq}x{hd} causal",
                 K.flash_attention(q, k, v, True, None),
                 K.flash_attention_plain(q, k, v, True, None), "ulp")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # kernels of 0.04-0.07 ms: enough calls that the events' window is
    # not one launch gap, and each call's device time traced beside it
    reps = LM_TIME_REPS if dev.type == "cuda" else args.reps

    def flash_library():
        return sdpa(q[None], k[None], v[None], is_causal=True)

    time_entry(times, "flash_attention lm",
               lambda: K.flash_attention(q, k, v, True, None),
               lambda: K.flash_attention_plain(q, k, v, True, None),
               flash_library, 4 * q.numel() * q.element_size(),
               4 * hd * bh * visible_pairs(sq, sq, True, None), bf,
               f"lm prefill, {bh} heads x {sq} tokens, bfloat16", reps, dev)
    lm_traced(times["flash_attention lm"], "flash_attention lm",
              lambda: K.flash_attention(q, k, v, True, None), flash_library,
              reps, dev)
    del q, k, v

    b, s_max = LM_PAGED_SEQS, LM_ENGINE["max_context"]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    block = LM_ENGINE["block_size"]
    lengths = np.random.default_rng(LM_SEED).integers(1, s_max + 1, b)
    lengths[0] = s_max                       # a full cache, read to its end
    qd = randn((b, h, hd))
    ck, cv = randn((b, s_max, kvh, hd)), randn((b, s_max, kvh, hd))
    pool = (b * s_max // block, block, kvh, hd)
    tables = torch.arange(b * s_max // block, dtype=torch.int32,
                          device=dev).view(b, -1)
    lens = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    paged_args = (qd, ck.view(pool), cv.view(pool), tables, lens)
    attn_compare(errs, "paged_attention",
                 f"lm B {b} H {h} KVH {kvh} S_max {s_max} block {block}",
                 K.paged_attention(*paged_args),
                 K.paged_attention_plain(*paged_args), "ulp")
    mask = (torch.arange(s_max, device=dev)[None, :]
            < lens[:, None].long())[:, None, None, :]
    kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)

    def library():
        return sdpa(qd[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True)

    lib_err = float((library()[:, :, 0].float()
                     - K.paged_attention_plain(*paged_args).float()
                     ).abs().max())
    el = qd.element_size()
    walked = -(-lengths.astype(np.int64) // block)
    time_entry(times, "paged_attention lm",
               lambda: K.paged_attention(*paged_args),
               lambda: K.paged_attention_plain(*paged_args), library,
               2 * qd.numel() * el + 2 * int(lengths.sum()) * kvh * hd * el
               + 4 * int(walked.sum()) + 4 * b,
               4 * hd * h * int(lengths.sum()), bf,
               f"lm decode, {b} sequences of {int(lengths.min())}.."
               f"{int(lengths.max())} tokens, GQA {h}/{kvh}, dense cache "
               f"as a pool of {block}-token blocks; library: SDPA with a "
               f"length mask, max_abs_err {lib_err:.3g} vs plain", reps, dev)
    lm_traced(times["paged_attention lm"], "paged_attention lm",
              lambda: K.paged_attention(*paged_args), library, reps, dev,
              ("paged_split_kernel", "paged_merge_kernel"))
    return counts


def lm_traced(entry, key, kern, lib, reps, dev, parts=()) -> None:
    """Log the traced device ms a call of `kern` (each of `parts` and
    their sum) and of the library call `lib`, beside the events' times
    in `entry`, where they are kept as `device_ms` and
    `library_device_ms` (None on the CPU)."""
    kt = trace_ms(kern, reps, dev, list(parts) or None)
    lt = trace_ms(lib, reps, dev)["all"]
    dev_ms = (None if any(t is None for t in kt.values())
              else sum(kt.values()))
    entry.update(device_ms=dev_ms, library_device_ms=lt)

    def fmt(t):
        return "not measured" if t is None else f"{t:.4f}"

    log(f"time {key} traced over {reps} calls: "
        + "".join(f"{n}={fmt(t)} " for n, t in kt.items() if parts)
        + f"device_ms={fmt(dev_ms)} (kernel_ms {entry['ms']:.4f}) "
        f"library_device_ms={fmt(lt)} (library_ms "
        f"{fmt(entry['library_ms'])})")


# ---------------------------------------------------------------------------
# lm_hybrid: Jamba-v0.1 (Mamba + attention + MoE) and RWKV6-3B served
# ---------------------------------------------------------------------------

HYBRID_ARCH = "jamba-v0.1-52b"      # full width, one period of depth
HYBRID_LAYERS = 8                   # mamba x4, attn, mamba x3; MoE on odd
HYBRID_F32_LAYERS = 5               # layers 0-4: the first attention layer
HYBRID_SEED = 25                    # weights and requests
HYBRID_DISAGREE = 0.01              # forced rows whose routing may differ
HYBRID_REPLAY = 3                   # tokens of the bit-identical replay
HYBRID_WINDOW = 5                   # decode steps in the profiler window
RWKV_ARCH = "rwkv6-3b"              # full width, a quarter of the depth
RWKV_LAYERS = 8                     # of 32: pays for the lm_encdec phase
RWKV_CMP = (2, (512, 100), 8)       # card vs CPU: layers, prompts, steps
ATOMIC_NAMES = ("scatter_add", "index_add", "atomic")


class RouteLog:
    """While active, keeps every `models.moe.route` call's `Routing`
    (on the device; nothing is read back until the run ends)."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe = moe
        self.calls: list = []

    def __enter__(self):
        self.route = self.moe.route

        def logged(probs, k, cap):
            r = self.route(probs, k, cap)
            self.calls.append(r)
            return r

        self.moe.route = logged
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bit patterns, for bit-for-bit comparisons."""
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def served(tag, cfg, params, dev, K, Engine, EngineConfig, Request):
    """Serve LM_REQUESTS seeded requests (LM_PROMPT, LM_NEW) on
    LM_ENGINE: counts set to 0 just before the run and read just after.
    Logs the run; returns (engine, launch counts, route log)."""
    ecfg = EngineConfig(**LM_ENGINE, seed=HYBRID_SEED)
    # one short request first loads the kernels and the GEMMs' plans
    Engine(cfg, params, ecfg).run(lm_requests(Request, cfg.vocab, 1,
                                              HYBRID_SEED + 3))
    eng = Engine(cfg, params, ecfg)
    reqs = lm_requests(Request, cfg.vocab, LM_REQUESTS, HYBRID_SEED)
    budgets = {r.req_id: r.max_new_tokens for r in reqs}
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with RouteLog() as routes:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out = eng.run(reqs)
        sync(dev)
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
    stats = eng.sched.stats()
    n_tok = sum(len(v) for v in out.values())
    peak = (f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
            if dev.type == "cuda" else "not measured")
    log(f"{tag} launches {json.dumps(counts)}")
    log(f"{tag} engine: requests={len(out)}/{len(reqs)} steps="
        f"{stats['steps']} decode_steps={len(eng.decode_times)} prefills="
        f"{len(eng.prefill_times)} tokens={n_tok} wall_s={wall:.3f} "
        f"tokens_per_s={n_tok / wall:.1f} preemptions="
        f"{stats['preemptions']} prompt_tokens="
        f"{sum(len(r.prompt) for r in reqs)} prefill_s="
        f"{sum(t for _, t in eng.prefill_times):.3f} decode_s="
        f"{sum(eng.decode_times):.3f} peak_gib={peak}")
    check({rid: len(v) for rid, v in out.items()} == budgets,
          f"{tag}: not every request finished with its budget")
    by_bucket: dict = {}
    for bucket, s in eng.prefill_times:
        by_bucket.setdefault(bucket, []).append(1e3 * s)
    log(f"{tag} prefill ms by bucket: " + " ".join(
        f"{b}:n={len(v)},median={np.median(v):.2f}"
        for b, v in sorted(by_bucket.items())))
    host = 1e3 * np.array(eng.decode_times)
    log(f"{tag} decode host ms a step: median={np.median(host):.3f} "
        f"p90={np.percentile(host, 90):.3f} min={host.min():.3f} "
        f"steps={host.size}")
    return eng, counts, routes


def decode_window(tag, eng, dev, toks) -> dict:
    """HYBRID_WINDOW decode steps of every slot from the engine's cache under
    torch.profiler, nothing else in the window: device ms a step split
    into flash, paged, GEMM and other, the busy share and the kernels;
    fails on a float atomic (`scatter_add`, `index_add`) among them.
    Returns the split a step ({} on the CPU)."""
    if dev.type != "cuda":
        log(f"{tag} trace: not measured (no card)")
        return {}
    from torch.profiler import ProfilerActivity, profile

    n = HYBRID_WINDOW
    eng.decode(toks)
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.decode(toks)
        sync(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    recs = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0 and ev.count and \
                ev.device_type == torch.autograd.DeviceType.CUDA:
            recs[ev.key] = (ev.count, t)
    split = {k: v / n for k, v in lm_split(recs).items()}
    device = sum(split.values())
    STEP_MS[f"{tag} decode"] = device
    atomics = sorted({short_kernel(k) for k in recs
                      if any(w in k.lower() for w in ATOMIC_NAMES)})
    top = sorted(recs.items(), key=lambda kv: -kv[1][1])[:6]
    log(f"{tag} trace {n} decode steps alone: wall_ms={wall_ms / n:.3f} "
        f"(profiler on) device_ms={device:.3f} "
        + " ".join(f"{k}_ms={v:.3f}" for k, v in split.items())
        + f" busy_share={device * n / wall_ms:.3f} kernels_a_step="
        f"{sum(c for c, _ in recs.values()) / n:.0f} top: "
        + "; ".join(f"{short_kernel(k)} {t / 1e3 / n:.3f} ms x{c / n:.0f}"
                    for k, (c, t) in top))
    check(bool(recs), f"{tag} trace: the profiler recorded no device time")
    check(not atomics, f"{tag} trace: atomic kernels {atomics} on the "
          "decode path")
    log(f"{tag} trace: atomic kernels on the decode path: "
        f"{atomics or 'none'}")
    return split


def run_lm_hybrid(args, dev, K):
    """Serve Jamba-v0.1 at full width with one period of depth (8
    layers: flash prefill and paged decode in its attention layer, the
    Mamba scan in seven, a 16-expert top-2 MoE in four) and RWKV6-3B at
    8 of its 32 layers through the port's engine; their reduced configs
    on the CPU.
    Checks the requests, the launches (one flash a prefill, one paged a
    decode step), a bit-identical replay of a Jamba decode step with no
    atomic kernel on its path, the float32 kernel path against the plain
    path at 5 layers where the routing agrees, and RWKV's card against
    the CPU on both wkv branches.  Returns the launch counts of the
    served paths."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry, transformer
    from repro_torch.serve import Engine, EngineConfig, Request
    from repro_torch.tree import leaves, tree_map

    t_lap = [time.perf_counter()]

    def lap():
        """Seconds since the last lap (the phase's parts, for the log)."""
        t, t_lap[0] = t_lap[0], time.perf_counter()
        return t_lap[0] - t

    full = get_config(HYBRID_ARCH)
    base = full.reduced() if args.cpu_rehearsal else full
    cfg = dataclasses.replace(base, n_layers=HYBRID_LAYERS)
    layout = transformer.layer_layout(cfg)
    t0 = time.perf_counter()
    params = registry.get_model(cfg).init(
        torch.Generator(device=dev).manual_seed(HYBRID_SEED), dev)
    sync(dev)
    n_params = sum(t.numel() for t in leaves(params))
    kinds = " ".join(k + ("+moe" if m else "") for k, m in layout)
    log(f"hybrid model {cfg.name}: layers={cfg.n_layers} of "
        f"{full.n_layers} ({kinds}) "
        f"d={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} "
        f"experts={cfg.moe.n_experts} top_k={cfg.moe.top_k} "
        f"d_expert_ff={cfg.moe.d_expert_ff} d_state={cfg.ssm.d_state} "
        f"d_conv={cfg.ssm.d_conv} expand={cfg.ssm.expand} vocab={cfg.vocab} "
        f"{cfg.dtype} params={n_params} ({n_params * 2 / 2 ** 30:.2f} GiB; "
        f"param_count()={cfg.param_count():.0f}) "
        f"init_s={time.perf_counter() - t0:.2f}")

    # -- the served path ----------------------------------------------------
    eng, counts, routes = served("hybrid", cfg, params, dev, K, Engine,
                                 EngineConfig, Request)
    n_attn = sum(k == "attn" for k, _ in layout)
    n_moe = sum(m for _, m in layout)
    if dev.type == "cuda":
        check(counts["flash_attention"] == n_attn * len(eng.prefill_times),
              f"hybrid: {counts['flash_attention']} flash launches for "
              f"{len(eng.prefill_times)} prefills, not {n_attn} each")
        check(counts["paged_attention"] == n_attn * len(eng.decode_times),
              f"hybrid: {counts['paged_attention']} paged launches for "
              f"{len(eng.decode_times)} decode steps, not {n_attn} each")
    slots = LM_ENGINE["max_batch"]
    decode_calls = [r for r in routes.calls if r.top_e.shape[0] == slots]
    dropped = [int((~r.keep).sum()) for r in decode_calls]
    prefill_drop = sum(int((~r.keep).sum()) for r in routes.calls
                       if r.top_e.shape[0] != slots)
    steps = max(len(eng.decode_times), 1)
    log(f"hybrid moe: {len(decode_calls)} decode-step calls ({n_moe} MoE "
        f"layers x {len(eng.decode_times)} steps), capacity "
        f"{decode_calls[0].cap if decode_calls else 'none'} an expert at "
        f"{slots} slots; slot choices dropped a step: mean "
        f"{sum(dropped) / steps:.2f} of {n_moe * slots * cfg.moe.top_k} "
        f"(max in one layer {max(dropped, default=0)}); prefill drops "
        f"{prefill_drop} over {len(eng.prefill_times)} prompts")
    check(len(decode_calls) == n_moe * len(eng.decode_times),
          f"hybrid moe: {len(decode_calls)} decode routing calls, not "
          f"{n_moe} a step")
    del routes

    # decode steps replayed from the same cache: logits and every cache
    # leaf bit for bit (no float atomics: the MoE combine is k gathers)
    toks = torch.from_numpy(np.random.default_rng(HYBRID_SEED + 4).integers(
        1, cfg.vocab, (slots, 1)).astype(np.int32)).to(dev)
    snap = tree_map(torch.clone, eng.cache)
    runs = []
    for _ in range(2):
        eng.cache = tree_map(torch.clone, snap)
        rows = [eng.decode(toks)]
        for t in range(HYBRID_REPLAY - 1):
            rows.append(eng.decode(rows[-1].argmax(-1, keepdim=True)
                                   .to(torch.int32)))
        sync(dev)
        runs.append((torch.stack(rows), tree_map(torch.clone, eng.cache)))
    same = torch.equal(bits(runs[0][0]), bits(runs[1][0])) and all(
        torch.equal(bits(a) if a.is_floating_point() else a,
                    bits(b) if b.is_floating_point() else b)
        for a, b in zip(leaves(runs[0][1]), leaves(runs[1][1])))
    check(same, "hybrid replay: two replays of the decode steps differ")
    log(f"hybrid replay: {HYBRID_REPLAY} decode steps of {slots} slots "
        f"from one cache, twice: logits and every cache leaf bit-identical "
        f"{same}")
    eng.cache = snap
    del runs
    split = decode_window("hybrid", eng, dev, toks)

    # the MoE expert GEMMs of one decode step alone (cap 1 at 8 slots):
    # four layers x (gate, up, down) over every expert's weights
    moe_p = next(p["moe"] for p in params["layers"] if "moe" in p)
    cap = max(1, int(-(-slots * cfg.moe.top_k // cfg.moe.n_experts)
                     * cfg.moe.capacity_factor))
    buf = torch.randn((cfg.moe.n_experts, cap, cfg.d_model),
                      generator=torch.Generator(device=dev).manual_seed(1),
                      device=dev).to(moe_p["w_gate"].dtype)

    def expert_gemms():
        h = torch.nn.functional.silu(torch.bmm(buf, moe_p["w_gate"])) \
            * torch.bmm(buf, moe_p["w_up"])
        return torch.bmm(h, moe_p["w_down"])

    reps = 50 if dev.type == "cuda" else 2
    layer_ms = time_ms(expert_gemms, reps, dev)
    w_bytes = sum(moe_p[n].numel() * moe_p[n].element_size()
                  for n in ("w_gate", "w_up", "w_down"))
    step_ms = sum(split.values()) if split else None
    log(f"hybrid moe expert GEMMs: {layer_ms:.4f} ms a layer, "
        f"{n_moe * layer_ms:.4f} ms a step ({n_moe} layers, "
        f"{n_moe * w_bytes / 1e9:.2f} GB of expert weights read: bound "
        f"{n_moe * w_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s); "
        f"of the traced decode step's device ms "
        f"{'not measured' if step_ms is None else f'{step_ms:.3f}'} "
        f"[{lap():.1f} s]")
    if dev.type == "cuda":
        log(f"hybrid engine peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del eng, params, moe_p, buf
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- float32: the kernel path against the plain path at 5 layers -----
    # Layers 0-4 hold four Mamba layers (MoE in 1 and 3) and the first
    # attention layer; routing is compared call by call and a row
    # (request, step) counts only while every call up to it agreed
    torch.backends.cuda.matmul.allow_tf32 = False
    c32 = dataclasses.replace(base, n_layers=HYBRID_F32_LAYERS,
                              dtype="float32")
    t0 = time.perf_counter()
    p32 = registry.get_model(c32).init(
        torch.Generator(device=dev).manual_seed(HYBRID_SEED + 5), dev)
    sync(dev)
    n32 = sum(t.numel() for t in leaves(p32))
    forced = lm_requests(Request, c32.vocab, LM_FORCED[0], HYBRID_SEED + 1)
    fsteps = torch.from_numpy(np.random.default_rng(HYBRID_SEED + 2)
                              .integers(1, c32.vocab, (LM_FORCED[0],
                                                       LM_FORCED[1], 1))
                              .astype(np.int32))

    def teacher_forced(kern):
        e = Engine(c32, p32, EngineConfig(
            max_batch=LM_FORCED[0], max_context=LM_ENGINE["max_context"],
            block_size=LM_ENGINE["block_size"]), use_kernels=kern)
        marks = []
        with RouteLog() as rl:
            rows = []
            for i, r in enumerate(forced):
                rows.append([e.prefill_slot(i, r.prompt).float()])
                marks.append(len(rl.calls))
            for t in range(LM_FORCED[1]):
                step = e.decode(fsteps[:, t].to(dev)).float()
                for i in range(LM_FORCED[0]):
                    rows[i].append(step[i])
                marks.append(len(rl.calls))
        return (torch.stack([torch.stack(r) for r in rows]), rl.calls,
                marks)

    K.reset_launch_counts()
    got, rk, marks = teacher_forced(True)
    f_counts = K.launch_counts()
    want, rp, _ = teacher_forced(False)
    agree = [torch.equal(a.top_e, b.top_e) and torch.equal(a.keep, b.keep)
             for a, b in zip(rk, rp)]
    n_req = LM_FORCED[0]
    # row (i, 0): request i's prefill calls; row (i, s): those and every
    # decode call up to step s (the slots share the experts' capacity)
    ok_rows = torch.zeros(got.shape[:2], dtype=torch.bool)
    start = 0
    for i in range(n_req):
        ok_rows[i, 0] = all(agree[start:marks[i]])
        start = marks[i]
    for s in range(LM_FORCED[1]):
        upto = all(agree[marks[n_req - 1]:marks[n_req + s]])
        for i in range(n_req):
            ok_rows[i, s + 1] = ok_rows[i, 0] and upto
    disagree = int((~ok_rows).sum())
    rows = ok_rows.numel()
    err = float((got - want).abs()[ok_rows].max()) if ok_rows.any() \
        else float("nan")
    ok = bool(torch.isfinite(got).all()) and bool(torch.allclose(
        got[ok_rows], want[ok_rows], rtol=LM_F32_TOL, atol=LM_F32_TOL))
    check(ok, f"hybrid teacher-forced float32: the kernel path differs "
              f"from the plain path (max abs err {err:.3g}, rtol=atol "
              f"{LM_F32_TOL})")
    check(disagree <= HYBRID_DISAGREE * rows,
          f"hybrid teacher-forced float32: routing differs at {disagree} "
          f"of {rows} rows (limit {HYBRID_DISAGREE:.0%})")
    if dev.type == "cuda":
        check(f_counts["flash_attention"] > 0 and
              f_counts["paged_attention"] > 0,
              "hybrid teacher-forced: the kernel path launched "
              f"{ {k: v for k, v in f_counts.items() if v} }")
    log(f"hybrid teacher-forced float32 ({c32.n_layers} layers, "
        f"params={n32} = {n32 * 4 / 2 ** 30:.2f} GiB, TF32 off, init_s="
        f"{time.perf_counter() - t0:.2f}): {n_req} requests (prompts "
        f"{[len(r.prompt) for r in forced]}), prefill + {LM_FORCED[1]} "
        f"decode steps; routing calls {len(rk)} (agree "
        f"{sum(agree)}), rows compared {rows - disagree} of {rows} "
        f"(routing differs at {disagree}); kernels vs plain max_abs_err="
        f"{err:.4g} (rtol=atol {LM_F32_TOL}) ok={ok}; max|logit|="
        f"{float(want.abs().max()):.3g} [{lap():.1f} s]")
    del p32, got, want, rk, rp
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- RWKV6-3B: served at full width, 8 of its 32 layers ----------------
    rfull = get_config(RWKV_ARCH)
    rbase = rfull.reduced() if args.cpu_rehearsal else rfull
    rcfg = dataclasses.replace(rbase, n_layers=min(RWKV_LAYERS,
                                                   rbase.n_layers))
    t0 = time.perf_counter()
    rparams = registry.get_model(rcfg).init(
        torch.Generator(device=dev).manual_seed(HYBRID_SEED + 6), dev)
    sync(dev)
    rn = sum(t.numel() for t in leaves(rparams))
    log(f"rwkv model {rcfg.name}: layers={rcfg.n_layers} of "
        f"{rfull.n_layers} d={rcfg.d_model} "
        f"heads={rcfg.d_model // rcfg.hd}x{rcfg.hd} d_ff={rcfg.d_ff} "
        f"vocab={rcfg.vocab} {rcfg.dtype} params={rn} "
        f"({rn * 2 / 2 ** 30:.2f} GiB; param_count()="
        f"{rcfg.param_count():.0f}) init_s={time.perf_counter() - t0:.2f}")
    reng, rcounts, _ = served("rwkv", rcfg, rparams, dev, K, Engine,
                              EngineConfig, Request)
    decode_window("rwkv", reng, dev, torch.from_numpy(
        np.random.default_rng(HYBRID_SEED + 9).integers(
            1, rcfg.vocab, (slots, 1)).astype(np.int32)).to(dev))
    log(f"rwkv served [{lap():.1f} s]")
    check(sum(rcounts.values()) == 0,
          f"rwkv: an attention-free model launched {rcounts}")
    del reng, rparams
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- RWKV: the card against the CPU, both wkv branches ---------------
    n_cmp, prompts, n_steps = RWKV_CMP
    c2 = dataclasses.replace(rcfg, n_layers=n_cmp, dtype="float32")
    api = registry.get_model(c2)
    p_dev = api.init(torch.Generator(device=dev).manual_seed(
        HYBRID_SEED + 7), dev)
    p_cpu = tree_map(lambda t: t.cpu(), p_dev)
    rng = np.random.default_rng(HYBRID_SEED + 8)
    for plen in prompts:
        toks = torch.from_numpy(rng.integers(
            1, c2.vocab, (1, plen + n_steps)).astype(np.int32))
        res = {}
        for where, p in (("card", p_dev), ("cpu", p_cpu)):
            d = dev if where == "card" else torch.device("cpu")
            t1 = time.perf_counter()
            logits, cache = api.prefill(p, {"tokens": toks[:, :plen].to(d)},
                                        plen + n_steps)
            out = [logits[:, -1]]
            for t in range(plen, plen + n_steps):
                step, cache = api.decode_step(p, cache,
                                              toks[:, t:t + 1].to(d))
                out.append(step[:, 0])
            sync(dev)
            res[where] = (torch.stack(out, 1).float().cpu(),
                          [t.cpu() for t in leaves(cache["layers"])],
                          time.perf_counter() - t1)
        (a, sa, ta), (b, sb, tb) = res["card"], res["cpu"]
        err = float((a - b).abs().max())
        serr = max(float((x - y).abs().max()) for x, y in zip(sa, sb))
        ok = bool(torch.isfinite(a).all()) and bool(torch.allclose(
            a, b, rtol=LM_F32_TOL, atol=LM_F32_TOL))
        branch = "chunked" if plen % 256 == 0 else "per-token"
        check(ok, f"rwkv card vs cpu ({plen}-token prompt, {branch}): "
                  f"max abs err {err:.3g} (rtol=atol {LM_F32_TOL})")
        log(f"rwkv card vs cpu float32 ({n_cmp} layers, TF32 off): "
            f"{plen}-token prompt ({branch} wkv) + {n_steps} decode steps: "
            f"logits max_abs_err={err:.4g} (rtol=atol {LM_F32_TOL}) "
            f"state max_abs_err={serr:.4g} max|logit|="
            f"{float(b.abs().max()):.3g} ok={ok}; card_s={ta:.2f} "
            f"cpu_s={tb:.2f} [{lap():.1f} s]")
    del p_dev, p_cpu
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {k: counts.get(k, 0) + rcounts.get(k, 0) for k in K.KERNELS}


# ---------------------------------------------------------------------------
# lm_encdec: Whisper-large-v3 through the model API
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "whisper-large-v3"    # uncut: 32 + 32 layers
ENCDEC_SEED = 26                    # weights, clips and tokens
ENCDEC_CLIPS = 8                    # clips a batch (two batches)
ENCDEC_FRAMES = 1500                # 30 s: 3,000 mel frames, stride 2
ENCDEC_STEPS = (48, 32)             # greedy decode steps of batches A, B
ENCDEC_F32_LAYERS = 4               # encoder and decoder layers, float32
ENCDEC_FORCED = 16                  # teacher-forced decode steps
ENCDEC_REPLAY = 3                   # steps of the bit-identical replay
ENCDEC_WINDOW = 5                   # decode steps in the profiler window
ENCDEC_TRACE_PAD_S = 0.02           # idle host time at the window's edges
#: openai/whisper's multilingual tokenizer as large-v3 numbers it (100
#: languages): <|startoftranscript|> <|en|> <|transcribe|>
#: <|notimestamps|> is decoding.py's start sequence without timestamps,
#: <|startofprev|> opens the previous text's conditioning
WHISPER_SOT = (50258, 50259, 50360, 50364)
WHISPER_SOT_PREV = 50362
WHISPER_TEXT = 50257                # text ids lie below <|endoftext|>


def encdec_prompts(cfg, rng) -> dict:
    """The two batches' prompts, as decoding.py builds them: A the start
    sequence alone; B <|startofprev|>, the last decoder_len // 2 - 1
    tokens of the previous text (seeded text ids) and the start
    sequence (228 tokens at decoder_len 448)."""
    vocab = min(cfg.vocab, WHISPER_TEXT)
    sot = [t % cfg.vocab for t in WHISPER_SOT]
    prev = rng.integers(1, vocab, (ENCDEC_CLIPS, cfg.decoder_len // 2 - 1))
    a = np.tile(np.array(sot, np.int64), (ENCDEC_CLIPS, 1))
    b = np.concatenate([np.full((ENCDEC_CLIPS, 1),
                                WHISPER_SOT_PREV % cfg.vocab), prev, a], 1)
    return {"A": a.astype(np.int32), "B": b.astype(np.int32)}


def run_lm_encdec(args, dev, K, errs, times):
    """Whisper-large-v3 uncut (its reduced config on the CPU) through
    `registry.get_model`: 16 seeded clips of 1,500 frame embeddings in
    two batches of 8, each one `prefill(max_len=448)` -- the encoder,
    the prompt's self- and cross-attention on the flash kernel -- then
    greedy `decode_step` calls whose self- and cross-attention run the
    paged kernel.  Checks each kernel against its plain version at the
    phase's shapes first, then the launches, a decode window's trace,
    a bit-identical replay, the float32 kernel path against the plain
    path at 4 + 4 layers and the bfloat16 paths against float32.
    Returns the launch counts of the served path."""
    from repro_torch.configs import get_config
    from repro_torch.models import common, registry, whisper
    from repro_torch.tree import leaves, tree_map

    t_lap = [time.perf_counter()]

    def lap():
        t, t_lap[0] = t_lap[0], time.perf_counter()
        return t_lap[0] - t

    full = get_config(ENCDEC_ARCH)
    cfg = full.reduced() if args.cpu_rehearsal else full
    n_frames = 150 if args.cpu_rehearsal else ENCDEC_FRAMES
    api = registry.get_model(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(ENCDEC_SEED),
                      dev)
    sync(dev)
    n_params = sum(t.numel() for t in leaves(params))
    log(f"encdec model {cfg.name}: encoder layers={cfg.n_encoder_layers} "
        f"decoder layers={cfg.n_layers} d={cfg.d_model} heads="
        f"{cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} d_ff={cfg.d_ff} vocab="
        f"{cfg.vocab} decoder_len={cfg.decoder_len} {cfg.dtype} params="
        f"{n_params} ({n_params * 2 / 2 ** 30:.2f} GiB; param_count()="
        f"{cfg.param_count():.0f}, which counts tok_embed twice) frames="
        f"{n_frames} [{lap():.1f} s]")
    if not args.cpu_rehearsal:
        check(n_params == 1_535_383_040,
              f"encdec: {n_params} parameters, not Whisper-large-v3's "
              "1,535,383,040")

    rng = np.random.default_rng(ENCDEC_SEED)
    bf = params["tok_embed"].dtype
    clips = torch.from_numpy(rng.normal(
        size=(2, ENCDEC_CLIPS, n_frames, cfg.d_model)).astype(
            np.float32)).to(dev, bf)
    prompts = encdec_prompts(cfg, rng)
    max_len = cfg.decoder_len
    # positions stay below decoder_len (the reduced config's 32 cuts the
    # steps on the CPU)
    steps = {name: min(n, max_len - 1 - prompts[name].shape[1])
             for name, n in zip("AB", ENCDEC_STEPS)}
    batches = {name: {"frames": clips[i],
                      "tokens": torch.from_numpy(prompts[name]).to(dev)}
               for i, name in enumerate(("A", "B"))}

    # -- each kernel against its plain version at the phase's shapes -----
    b, h, kvh, hd = ENCDEC_CLIPS, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    t_b = prompts["B"].shape[1]
    gen = torch.Generator(device=dev).manual_seed(ENCDEC_SEED + 1)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    reps = LM_TIME_REPS if dev.type == "cuda" else args.reps
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bh = b * h
    enc_q = randn((bh, n_frames, hd))
    enc_k, enc_v = randn((bh, n_frames, hd)), randn((bh, n_frames, hd))
    pq, pk, pv = (randn((bh, t_b, hd)) for _ in range(3))
    blk_f, blk_t = common.flash_block(n_frames), common.flash_block(t_b)
    flash_cases = (
        ("encoder", enc_q, enc_k, enc_v, False, (blk_f, blk_f)),
        ("cross", pq, enc_k, enc_v, False, (blk_t, blk_f)),
        ("self", pq, pk, pv, True, (blk_t, blk_t)))
    for tag, q, k, v, causal, (bq, bk) in flash_cases:
        def kern(q=q, k=k, v=v, causal=causal, bq=bq, bk=bk):
            return K.flash_attention(q, k, v, causal, None, bq, bk)

        def plain(q=q, k=k, v=v, causal=causal, bq=bq, bk=bk):
            return K.flash_attention_plain(q, k, v, causal, None, bq, bk)

        def library(q=q, k=k, v=v, causal=causal):
            return sdpa(q[None], k[None], v[None], is_causal=causal)

        label = (f"encdec {tag} {bh}x{q.shape[1]}x{k.shape[1]}x{hd} "
                 f"{'causal' if causal else 'not causal'} blocks {bq}x{bk}")
        got = kern()
        attn_compare(errs, "flash_attention", label, got, plain(), "ulp")
        same = torch.equal(bits(got), bits(kern()))
        check(same, f"attention flash_attention {label}: two launches "
              "differ")
        key = f"flash_attention encdec {tag}"
        time_entry(times, key, kern, plain, library,
                   2 * (q.numel() + k.numel()) * q.element_size(),
                   4 * hd * bh * visible_pairs(q.shape[1], k.shape[1],
                                               causal, None), bf,
                   f"{label}, two launches bit-identical {same}", reps, dev)
        lm_traced(times[key], key, kern, library, reps, dev)
    del enc_q, pq, pk, pv

    # paged: cross over the frames as 4-token blocks, every length the
    # frames; self over the 448-token cache as 16-token blocks
    cross_k, cross_v = randn((b, n_frames, kvh, hd)), randn((b, n_frames,
                                                             kvh, hd))
    self_len = np.random.default_rng(ENCDEC_SEED + 2).integers(
        1, max_len + 1, b)
    self_len[0] = max_len
    self_k, self_v = randn((b, max_len, kvh, hd)), randn((b, max_len, kvh,
                                                          hd))
    qd = randn((b, h, hd))
    for tag, ck, cv, lens in (
            ("cross", cross_k, cross_v, np.full(b, n_frames)),
            ("self", self_k, self_v, self_len)):
        s_max = ck.shape[1]
        idx = common.kv_index(b, s_max, dev)
        lengths = torch.from_numpy(lens.astype(np.int32)).to(dev)
        pool = (b * s_max // idx.block, idx.block, kvh, hd)
        pargs = (qd, ck.view(pool), cv.view(pool), idx.tables, lengths)

        def kern(pargs=pargs):
            return K.paged_attention(*pargs)

        def plain(pargs=pargs):
            return K.paged_attention_plain(*pargs)

        mask = (torch.arange(s_max, device=dev)[None, :]
                < lengths[:, None].long())[:, None, None, :]
        kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)

        def library(kt=kt, vt=vt, mask=mask):
            return sdpa(qd[:, :, None], kt, vt, attn_mask=mask,
                        enable_gqa=True)

        label = (f"encdec {tag} B {b} H {h} KVH {kvh} S {s_max} block "
                 f"{idx.block} lengths {int(lens.min())}..{int(lens.max())}")
        got, want = kern(), plain()
        attn_compare(errs, "paged_attention", label, got, want, "ulp")
        same = torch.equal(bits(got), bits(kern()))
        check(same, f"attention paged_attention {label}: two launches "
              "differ")
        lib_err = float((library()[:, :, 0].float() - want.float()
                         ).abs().max())
        el = qd.element_size()
        walked = -(-lens.astype(np.int64) // idx.block)
        key = f"paged_attention encdec {tag}"
        time_entry(times, key, kern, plain, library,
                   2 * qd.numel() * el + 2 * int(lens.sum()) * kvh * hd * el
                   + 4 * int(walked.sum()) + 4 * b,
                   4 * hd * h * int(lens.sum()), bf,
                   f"{label}, two launches bit-identical {same}; library: "
                   f"SDPA with a length mask, max_abs_err {lib_err:.3g} vs "
                   "plain", reps, dev)
        lm_traced(times[key], key, kern, library, reps, dev,
                  ("paged_split_kernel", "paged_merge_kernel"))
    del cross_k, cross_v, self_k, self_v, qd, enc_k, enc_v
    log(f"encdec kernels vs plain [{lap():.1f} s]")

    # -- the served path ------------------------------------------------------
    # one prefill and step first load the kernels and the GEMMs' plans;
    # each batch's encoder is then timed alone, outside the counted run
    with torch.no_grad():
        _, c = api.prefill(params, batches["A"], max_len)
        api.decode_step(params, c, batches["A"]["tokens"][:, :1])
        del c
        enc_ms = {}
        for name, batch in batches.items():
            sync(dev)
            t0 = time.perf_counter()
            whisper.encode(params, cfg, batch["frames"], remat="none")
            sync(dev)
            enc_ms[name] = 1e3 * (time.perf_counter() - t0)
        sync(dev)
        K.reset_launch_counts()
        prefill_ms, host, caches, n_tok = {}, [], {}, 0
        t_run = time.perf_counter()
        for name, batch in batches.items():
            t0 = time.perf_counter()
            logits, cache = api.prefill(params, batch, max_len)
            sync(dev)
            prefill_ms[name] = 1e3 * (time.perf_counter() - t0)
            tok = logits.argmax(-1).to(torch.int32)
            for _ in range(steps[name]):
                t0 = time.perf_counter()
                logits, cache = api.decode_step(params, cache, tok)
                tok = logits.argmax(-1).to(torch.int32)
                host.append(time.perf_counter() - t0)
                n_tok += b
            caches[name] = (cache, tok)
        sync(dev)
        wall = time.perf_counter() - t_run
        counts = K.launch_counts()
    n_steps = sum(steps.values())
    host = 1e3 * np.array(host)
    n_enc, n_dec = cfg.n_encoder_layers, cfg.n_layers
    log(f"encdec launches {json.dumps(counts)}")
    log(f"encdec run: {len(batches)} batches of {b} clips x {n_frames} "
        f"frames, prompts {[p.shape[1] for p in prompts.values()]} tokens, "
        f"{steps['A']} + {steps['B']} greedy decode steps: tokens={n_tok} "
        f"wall_s={wall:.3f} tokens_per_s={n_tok / wall:.1f}; encode ms "
        + " ".join(f"{k}={v:.2f}" for k, v in enc_ms.items())
        + "; prefill ms (encoder and prompt) "
        + " ".join(f"{k}={v:.2f}" for k, v in prefill_ms.items())
        + f"; decode host ms a step median={np.median(host):.3f} "
        f"p90={np.percentile(host, 90):.3f} min={host.min():.3f} "
        f"steps={host.size}")
    if dev.type == "cuda":
        want = dict.fromkeys(K.KERNELS, 0)
        want["flash_attention"] = (n_enc + 2 * n_dec) * len(batches)
        want["paged_attention"] = 2 * n_dec * n_steps
        check(counts == want,
              f"encdec: launches {counts}, not {n_enc + 2 * n_dec} flash a "
              f"prefill and {2 * n_dec} paged a decode step ({want})")
    pos = {k: c["pos"].tolist() for k, (c, _) in caches.items()}
    check(all(p == [prompts[k].shape[1] + steps[k]] * b
              for k, p in pos.items()) and all(
                  p[0] < cfg.decoder_len for p in pos.values()),
          f"encdec: final positions {pos}")
    check(all(bool(torch.isfinite(c["kv_stack"]["kv"]["k"]).all())
              for c, _ in caches.values()), "encdec: a cache is not finite")
    log(f"encdec served [{lap():.1f} s]")

    # -- a bit-identical replay and the decode window ------------------------
    cache, tok = caches.pop("B")
    del caches
    with torch.no_grad():
        snap = tree_map(torch.clone, cache)
        runs = []
        for _ in range(2):
            c, t, rows = tree_map(torch.clone, snap), tok, []
            for _ in range(ENCDEC_REPLAY):
                logits, c = api.decode_step(params, c, t)
                t = logits.argmax(-1).to(torch.int32)
                rows.append(logits)
            sync(dev)
            runs.append((torch.stack(rows), c))
        same = torch.equal(bits(runs[0][0]), bits(runs[1][0])) and all(
            torch.equal(bits(x) if x.is_floating_point() else x,
                        bits(y) if y.is_floating_point() else y)
            for x, y in zip(leaves(runs[0][1]), leaves(runs[1][1])))
        check(same, "encdec replay: two replays of the decode steps differ")
        log(f"encdec replay: {ENCDEC_REPLAY} decode steps of {b} clips from "
            f"one cache, twice: logits and every cache leaf bit-identical "
            f"{same}")
        del runs
        encdec_window(cfg, api, params, snap, tok, dev, b * n_frames)
    del cache, snap
    log(f"encdec replay and window [{lap():.1f} s]")

    # -- float32: the kernel path against the plain path at 4 + 4 layers ---
    torch.backends.cuda.matmul.allow_tf32 = False
    nl = min(ENCDEC_F32_LAYERS, cfg.n_layers)
    c32 = dataclasses.replace(cfg, dtype="float32", n_layers=nl,
                              n_encoder_layers=nl)
    a32 = registry.get_model(c32)
    p32 = a32.init(torch.Generator(device=dev).manual_seed(ENCDEC_SEED + 3),
                   dev)
    forced = torch.from_numpy(np.random.default_rng(ENCDEC_SEED + 4)
                              .integers(1, min(cfg.vocab, WHISPER_TEXT),
                                        (b, ENCDEC_FORCED, 1))
                              .astype(np.int32)).to(dev)
    batch_b = batches["B"]

    def teacher_forced(a, p, frames, kern):
        with torch.no_grad():
            logits, c = a.prefill(p, {"frames": frames,
                                      "tokens": batch_b["tokens"]}, max_len,
                                  use_kernels=kern)
            rows = [logits.float()]
            for t in range(ENCDEC_FORCED):
                logits, c = a.decode_step(p, c, forced[:, t], use_kernels=kern)
                rows.append(logits.float())
        return torch.cat(rows, 1)

    f_frames = batch_b["frames"].float()
    K.reset_launch_counts()
    got = teacher_forced(a32, p32, f_frames, True)
    f_counts = K.launch_counts()
    want = teacher_forced(a32, p32, f_frames, False)
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and bool(torch.allclose(
        got, want, rtol=LM_F32_TOL, atol=LM_F32_TOL))
    check(ok, f"encdec teacher-forced float32: the kernel path differs from "
              f"the plain path (max abs err {err:.3g}, rtol=atol "
              f"{LM_F32_TOL})")
    if dev.type == "cuda":
        check(f_counts["flash_attention"] == 3 * nl
              and f_counts["paged_attention"] == 2 * nl * ENCDEC_FORCED,
              f"encdec teacher-forced float32: launches {f_counts}")
    log(f"encdec teacher-forced float32 ({nl} + {nl} layers, TF32 off): "
        f"batch B's prefill ({t_b} tokens) + {ENCDEC_FORCED} decode steps: "
        f"kernels vs plain max_abs_err={err:.4g} (rtol=atol {LM_F32_TOL}) "
        f"ok={ok}; max|logit|={float(want.abs().max()):.3g} "
        f"[{lap():.1f} s]")
    del p32, got, want

    # -- bfloat16: both paths against the whole model in float32 ----------
    bf16 = {kern: teacher_forced(api, params, batch_b["frames"], kern)
            for kern in (True, False)}
    p32 = tree_map(lambda t: t.float(), params)
    truth = teacher_forced(registry.get_model(dataclasses.replace(
        cfg, dtype="float32")), p32, f_frames, False)
    del p32
    dist = {kern: (bf16[kern] - truth).abs() for kern in (True, False)}
    bar = float((bf16[True] - bf16[False]).abs().max())
    mean_ratio = float(dist[True].mean() / dist[False].mean())
    max_ratio = float(dist[True].max() / dist[False].max())
    ok16 = bool(torch.isfinite(bf16[True]).all()) \
        and mean_ratio <= LM_BF16_RATIO and max_ratio <= LM_BF16_RATIO
    check(ok16, f"encdec teacher-forced bfloat16: the kernel path's error "
                f"against float32 is {mean_ratio:.3f}x (mean) and "
                f"{max_ratio:.3f}x (max) the plain path's (limit "
                f"{LM_BF16_RATIO})")
    log(f"encdec teacher-forced bfloat16 ({cfg.n_encoder_layers} + "
        f"{cfg.n_layers} layers): kernels vs plain max_abs_err={bar:.4g}; "
        f"against float32: kernels max {float(dist[True].max()):.4g} mean "
        f"{float(dist[True].mean()):.4g}, plain max "
        f"{float(dist[False].max()):.4g} mean {float(dist[False].mean()):.4g}"
        f" (ratio mean {mean_ratio:.3f} max {max_ratio:.3f}, limit "
        f"{LM_BF16_RATIO}) ok={ok16}; max|logit|="
        f"{float(truth.abs().max()):.3g} [{lap():.1f} s]")
    del bf16, truth, dist, params, clips, batches
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return counts


def encdec_window(cfg, api, params, cache, tok, dev, kv_rows) -> None:
    """ENCDEC_WINDOW decode steps from `cache` under torch.profiler,
    nothing else in the window: a step's device ms split into the cross
    K/V GEMMs (the `aten::mm` calls over the kv_rows encoder rows, read
    from the trace's shapes), the other GEMMs, paged and other, the
    busy share and kernels a step; fails unless the paged kernel's
    records are there and no `einsum` or SDPA op is."""
    if dev.type != "cuda":
        log("encdec trace: not measured (no card)")
        return
    from torch.profiler import ProfilerActivity, profile, schedule

    n = ENCDEC_WINDOW
    c = cache
    logits, c = api.decode_step(params, c, tok)
    sync(dev)
    # a warm-up step under the tracer, its records dropped (`schedule`),
    # so that the window starts with the tracer running: a window
    # without it once kept 2,038 of a step's 2,048 kernels.  The window
    # opens a little after `prof.step()` returns, and the records of the
    # kernels launched before it opens are dropped: without the idle
    # ENCDEC_TRACE_PAD_S at its edges 8 of 25 windows lost 1-204 of their
    # first kernels on an H100, with it none of 25
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True, schedule=schedule(
                     wait=0, warmup=1, active=1, repeat=1)) as prof:
        logits, c = api.decode_step(params, c, tok)
        sync(dev)
        prof.step()
        time.sleep(ENCDEC_TRACE_PAD_S)
        t0 = time.perf_counter()
        for _ in range(n):
            logits, c = api.decode_step(params, c, tok)
        sync(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        time.sleep(ENCDEC_TRACE_PAD_S)
        prof.step()
    # one pass over the trace: kernels carry no shapes, so grouping by
    # shape keeps one entry each, and splits the CPU ops by theirs
    avgs = prof.key_averages(group_by_input_shape=True)
    recs, cross_us = {}, 0.0
    for ev in avgs:
        if ev.key.startswith("ProfilerStep"):
            continue        # the schedule's range: the window's whole span
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0 and ev.count and \
                ev.device_type == torch.autograd.DeviceType.CUDA:
            cnt, us = recs.get(ev.key, (0, 0.0))
            recs[ev.key] = (cnt + ev.count, us + t)
        elif ev.key == "aten::mm" and ev.input_shapes \
                and ev.input_shapes[0][:1] == [kv_rows]:
            cross_us += getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0))
    split = {k: v / n for k, v in lm_split(recs).items()}
    cross = cross_us / 1e3 / n
    device = sum(split.values())
    STEP_MS["encdec decode"] = device
    plain = sorted({ev.key for ev in avgs
                    if any(w in ev.key for w in PLAIN_OPS)})
    paged = {short_kernel(k): cnt for k, (cnt, _) in recs.items()
             if "paged_" in k}
    flops = cfg.n_layers * 2 * 2 * kv_rows * cfg.d_model \
        * cfg.n_kv_heads * cfg.hd
    bound = 1e3 * flops / BF16_TC_OPS_PER_S
    log(f"encdec trace {n} decode steps alone: wall_ms={wall_ms / n:.3f} "
        f"(profiler on) device_ms={device:.3f} cross_kv_gemm_ms="
        f"{cross:.3f} other_gemm_ms={split['gemm'] - cross:.3f} paged_ms="
        f"{split['paged']:.3f} other_ms={split['other']:.3f} flash_ms="
        f"{split['flash']:.3f} busy_share={device * n / wall_ms:.3f} "
        f"kernels_a_step={sum(cnt for cnt, _ in recs.values()) / n:.0f}; "
        f"cross K/V recompute {flops / 1e12:.3f} TFLOP a step, bound "
        f"{bound:.3f} ms at 989 TFLOP/s ({cross / bound:.2f}x); paged "
        f"records {paged}; plain ops {plain}")
    check(bool(recs), "encdec trace: the profiler recorded no device time")
    check(cross > 0, "encdec trace: no cross K/V GEMM in the window")
    check(sum(paged.values()) >= 2 * 2 * cfg.n_layers * n,
          f"encdec trace: {paged} paged records, not 2 a call, 2 calls a "
          "layer a step")
    check(not plain, f"encdec trace: plain-path ops {plain} on the kernel "
          "path")


# ---------------------------------------------------------------------------
# train: StableLM-1.6B trained through the port's train step
# ---------------------------------------------------------------------------

TRAIN_ARCH = "stablelm-1.6b"        # the reference launcher's default
TRAIN_SEED = 24                     # weights
TRAIN_STEPS = 10
TRAIN_TRACE = (6, 8)                # steps in the profiler window
TRAIN_REPEAT = 9                    # the step repeated from its state
TRAIN_PEAK_TFLOPS = 989.0           # H100 SXM bf16 dense, data sheet
TRAIN_CMP = (2, 2, 128)             # card vs CPU: layers, batch, tokens
TRAIN_GRAD_TOL = 1e-4               # of each leaf's max |g_cpu|
TRAIN_DESCENT = dict(lr=3e-3, warmup_steps=1, total_steps=100, steps=30,
                     batch=2, seq=16, seed=1, drop=0.5)
TRAIN_LAUNCH_ARGS = ("--arch", "stablelm-1.6b", "--reduced", "--steps",
                     "12", "--batch", "2", "--seq", "16", "--ckpt-every",
                     "4", "--log-every", "100")


def train_split(prof) -> tuple:
    """(device µs by category, busy µs) of a traced window.  Each
    kernel's time goes to the op that launched it: gemm (the weight
    products, `aten::mm` / `aten::addmm`), attention (the plain
    attention's batched einsums, softmax and mask), optimizer (anything
    under the train step's "optimizer" range), other; kernels the trace
    links to no op are `unlinked`.  The range's own device-side record
    (a `gpu_user_annotation` spanning its kernels) is not a kernel and is
    left out.  Busy: the union of the kernels' intervals."""
    attention = ("aten::bmm", "aten::_softmax",
                 "aten::_softmax_backward_data", "aten::where")
    out = dict.fromkeys(("gemm", "attention", "optimizer", "other",
                         "unlinked"), 0.0)
    spans = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if ev.name == "optimizer" or getattr(ev, "is_user_annotation",
                                                 False):
                continue
            spans.append((ev.time_range.start, ev.time_range.end))
            out["unlinked"] += ev.time_range.end - ev.time_range.start
            continue
        kernels = getattr(ev, "kernels", None)
        if not kernels:
            continue
        us = sum(k.duration for k in kernels)
        out["unlinked"] -= us
        up, parents = ev, set()
        while up is not None:
            parents.add(up.name)
            up = up.cpu_parent
        if "optimizer" in parents:
            out["optimizer"] += us
        elif ev.name in ("aten::mm", "aten::addmm"):
            out["gemm"] += us
        elif ev.name in attention:
            out["attention"] += us
        else:
            out["other"] += us
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return out, busy


def run_train(args, dev, K, after_timed=lambda: None):
    """Train StableLM-1.6B at its published size through the port's
    train step (plain attention, AdamW), check the card against the CPU
    at two layers, then the reduced config's descent and the launcher's
    crash/restart.  `after_timed()` runs once the timed steps are done.
    Returns the phase's attention-kernel launches (which must stay 0)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as launch_train
    from repro_torch.models import registry
    from repro_torch.optim import OptimizerConfig, make_optimizer
    from repro_torch.train.loop import (TrainConfig, init_train_state,
                                        loss_and_grads, make_train_step)
    from repro_torch.tree import leaves, tree_map

    before = K.launch_counts()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(TRAIN_ARCH)
    batch, seq = args.train_batch, args.train_seq
    if args.cpu_rehearsal:
        cfg = cfg.reduced()
    api = registry.get_model(cfg)
    tc = train_config(cfg)

    # -- (a) full size: 10 steps, the profiler over steps 6-8 -------------
    t0 = time.perf_counter()
    params, opt_state = init_train_state(
        api, tc, torch.Generator(device=dev).manual_seed(TRAIN_SEED), dev)
    sync(dev)
    n_params = sum(t.numel() for t in leaves(params))
    state_bytes = sum(t.numel() * t.element_size()
                      for t in leaves((params, opt_state)))
    log(f"train model {cfg.name}: layers={cfg.n_layers} d={cfg.d_model} "
        f"heads={cfg.n_heads} d_ff={cfg.d_ff} vocab={cfg.vocab} {cfg.dtype} "
        f"params={n_params} (param_count(), norms left out: "
        f"{cfg.param_count():.0f}) "
        f"optimizer={tc.optimizer.name} state={state_bytes / 2 ** 30:.2f} GiB "
        f"batch={batch}x{seq} remat={tc.remat} init_s="
        f"{time.perf_counter() - t0:.2f}")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=0), device=dev)
    step = make_train_step(api, tc)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rows, snapshot, window = [], None, None
    for i in range(TRAIN_STEPS):
        b = data.batch_at(i)
        if i == TRAIN_REPEAT:           # the state before the last step
            # the training peak, before the snapshot adds its 16 GiB
            peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
                if dev.type == "cuda" else None
            snapshot = tree_map(torch.clone, (params, opt_state))
        if dev.type == "cuda" and i == TRAIN_TRACE[0]:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
            tw = time.perf_counter()
        sync(dev)
        ts = time.perf_counter()
        params, opt_state, m = step(params, opt_state, b)
        loss, gnorm, lr = (float(m[k]) for k in ("loss", "grad_norm", "lr"))
        sync(dev)
        ms = 1e3 * (time.perf_counter() - ts)
        if dev.type == "cuda" and i == TRAIN_TRACE[1]:
            window = (1e3 * (time.perf_counter() - tw), prof)
            prof.stop()
        rows.append((loss, gnorm, lr, ms))
        log(f"train step {i}: loss={loss:.6f} grad_norm={gnorm:.6f} "
            f"lr={lr:.4e} ms={ms:.2f}")
    check(all(np.isfinite(r[0]) and np.isfinite(r[1]) for r in rows),
          "train: a loss or grad_norm is not finite")
    untraced = [r[3] for i, r in enumerate(rows)
                if not TRAIN_TRACE[0] <= i <= TRAIN_TRACE[1]]
    med = float(np.median(untraced))
    tokens = batch * seq
    flops = 6 * n_params * tokens + \
        12 * cfg.n_layers * batch * seq * seq * cfg.d_model
    tflops = flops / (med / 1e3) / 1e12
    # the matmuls the step runs (the roofline phase counts them on its
    # trace): N's embedding is a lookup, not a matmul
    mm = train_matmul_flops(cfg, batch, seq)
    mm_tflops = mm / (med / 1e3) / 1e12
    log(f"train full: median_step_ms={med:.2f} (steps outside the "
        f"profiler window, first included) tokens_per_s="
        f"{tokens / (med / 1e3):.1f} model_tflops={tflops:.1f} "
        f"(6·N·tokens + 12·L·B·S²·d = {flops:.4e} a step; "
        f"{tflops / TRAIN_PEAK_TFLOPS:.3f} of {TRAIN_PEAK_TFLOPS:.0f}) "
        f"matmul_flops={mm} matmul_tflops={mm_tflops:.1f} ("
        f"{mm_tflops / TRAIN_PEAK_TFLOPS:.3f} of "
        f"{TRAIN_PEAK_TFLOPS:.0f}; 6·W·tokens + 12·L·B·S²·d, W the "
        f"matmul weights: N less the embedding and the norms) "
        + (f"peak_gib={peak:.2f} (steps 0-{TRAIN_REPEAT - 1})"
           if peak is not None
           else "peak_gib=not measured"))
    if window is None:
        log("train trace: not measured (no card)")
    else:
        wall_ms, prof = window
        n = TRAIN_TRACE[1] - TRAIN_TRACE[0] + 1
        split, busy = train_split(prof)
        device = sum(split.values())
        STEP_MS["train step"] = device / 1e3 / n
        log(f"train trace steps {TRAIN_TRACE[0]}-{TRAIN_TRACE[1]}: "
            f"wall_ms={wall_ms / n:.3f} device_ms={device / 1e3 / n:.3f} "
            + " ".join(f"{k}_ms={v / 1e3 / n:.3f}" for k, v in split.items())
            + f" busy_ms={busy / 1e3 / n:.3f} busy_share="
            f"{busy / 1e3 / wall_ms:.3f}")
        check(device > 0, "train trace: no device time")
        del prof, window

    # the last step again from its saved state
    with torch.no_grad():
        for live, saved in zip(leaves((params, opt_state)),
                               leaves(snapshot)):
            live.copy_(saved)
    opt_state = opt_state._replace(step=snapshot[1].step)
    del snapshot
    _, _, m = step(params, opt_state, data.batch_at(TRAIN_REPEAT))
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    want = rows[TRAIN_REPEAT]
    log(f"train repeat step {TRAIN_REPEAT}: loss={loss:.9g} vs "
        f"{want[0]:.9g} bit_for_bit={loss == want[0]} grad_norm="
        f"{gnorm:.9g} vs {want[1]:.9g} bit_for_bit={gnorm == want[1]}")
    check(abs(loss - want[0]) <= 1e-6 * abs(want[0]),
          f"train repeat: loss {loss} vs {want[0]} beyond rel 1e-6")
    del params, opt_state, m, data, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"train (a) full size s={time.perf_counter() - t0:.1f}")
    after_timed()
    t0 = time.perf_counter()

    # -- (b) the card against the CPU: two layers, float32, TF32 off ------
    n_layers, cb, cs = TRAIN_CMP
    cfg2 = dataclasses.replace(cfg, n_layers=n_layers, dtype="float32")
    api2 = registry.get_model(cfg2)
    cpu = torch.device("cpu")
    # drawn once on the card (the CPU's single-threaded generator takes
    # about 8 s for these 514 M normals), then copied to the CPU
    p_dev, _ = init_train_state(api2, tc, torch.Generator(
        device=dev).manual_seed(TRAIN_SEED), dev)
    p_cpu = tree_map(lambda t: t.to(cpu, copy=True), p_dev)
    pipe = DataConfig(vocab=cfg2.vocab, seq_len=cs, global_batch=cb, seed=2)
    b_cpu = SyntheticLM(pipe, device=cpu).batch_at(0)
    b_dev = SyntheticLM(pipe, device=dev).batch_at(0)
    check(all(torch.equal(b_cpu[k], b_dev[k].cpu()) for k in b_cpu),
          "train: the card's batch is not the CPU's")
    l_cpu, g_cpu = loss_and_grads(api2, "none")(p_cpu, b_cpu)
    l_dev, g_dev = loss_and_grads(api2, "none")(p_dev, b_dev)
    worst = max(float((gd.cpu() - gc).abs().max() / gc.abs().max())
                for gd, gc in zip(leaves(g_dev), leaves(g_cpu)))
    lrel = abs(float(l_dev) - float(l_cpu)) / abs(float(l_cpu))
    log(f"train card vs cpu ({n_layers} layers, float32, TF32 off, "
        f"{cb}x{cs}): loss {float(l_dev):.9g} vs {float(l_cpu):.9g} "
        f"(rel {lrel:.3e}) grads max|g_card - g_cpu| / max|g_cpu| = "
        f"{worst:.3e} (worst leaf)")
    check(lrel <= 1e-5, f"train card vs cpu: loss rel {lrel:.3e} > 1e-5")
    check(worst <= TRAIN_GRAD_TOL, f"train card vs cpu: a gradient leaf "
          f"{worst:.3e} of its max from the CPU's")
    init2, update2 = make_optimizer(OptimizerConfig(
        lr=3e-4, warmup_steps=2))
    new_cpu, _, _ = update2(g_cpu, init2(p_cpu), p_cpu)
    new_dev, _, _ = update2(tree_map(lambda g: g.to(dev), g_cpu),
                            init2(p_dev), p_dev)
    # within rtol 1e-6, atol 1e-6 of the leaf's max |p|: a step that
    # lands near 0 keeps its operands' absolute rounding
    urel = max(float(((a.cpu() - b).abs() / (b.abs() + b.abs().max())).max())
               for a, b in zip(leaves(new_dev), leaves(new_cpu)))
    log(f"train adamw update from the CPU's grads: max |p_card - p_cpu| / "
        f"(|p_cpu| + max|p_cpu|) = {urel:.3e} (worst leaf)")
    check(urel <= 1e-6, f"train adamw update: {urel:.3e} > 1e-6")
    del p_cpu, p_dev, g_cpu, g_dev, new_cpu, new_dev
    log(f"train (b) card vs cpu s={time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()

    # -- (c) the reduced config: descent and the launcher's restart -------
    small = get_config(TRAIN_ARCH).reduced()
    api3 = registry.get_model(small)
    d = TRAIN_DESCENT
    tc3 = TrainConfig(optimizer=OptimizerConfig(
        lr=d["lr"], warmup_steps=d["warmup_steps"],
        total_steps=d["total_steps"]), remat="none")
    p3, o3 = init_train_state(api3, tc3, torch.Generator(
        device=dev).manual_seed(0), dev)
    fixed = registry.random_train_batch(small, d["batch"], d["seq"],
                                        seed=d["seed"], device=dev)
    step3 = make_train_step(api3, tc3)
    losses = []
    for _ in range(d["steps"]):
        p3, o3, m = step3(p3, o3, fixed)
        losses.append(float(m["loss"]))
    log(f"train descent (reduced, lr {d['lr']}, {d['steps']} steps on one "
        f"batch): first={losses[0]:.4f} last={losses[-1]:.4f}")
    check(losses[-1] < losses[0] - d["drop"],
          f"train descent: {losses[0]:.4f} -> {losses[-1]:.4f}")
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for tag, fail in (("clean", -1), ("crash", 7)):
            runs[tag] = launch_train.main(
                [*TRAIN_LAUNCH_ARGS, "--ckpt-dir", os.path.join(tmp, tag),
                 "--fail-at-step", str(fail), "--device", str(dev)])
    clean, crashed = runs["clean"][-1], runs["crash"][-1]
    log(f"train launcher: clean last step {clean[0]} loss {clean[1]:.6f}, "
        f"crash at 7 then restored: last step {crashed[0]} loss "
        f"{crashed[1]:.6f}")
    check(clean[0] == crashed[0] and
          abs(clean[1] - crashed[1]) <= 1e-5 * abs(clean[1]),
          "train launcher: the restarted run ends elsewhere")
    log(f"train (c) reduced s={time.perf_counter() - t0:.1f}")
    after = K.launch_counts()
    moved = {k: after[k] - before[k]
             for k in ("flash_attention", "paged_attention")}
    log(f"train attention kernel launches during the phase: {moved}")
    check(not any(moved.values()), f"train: attention kernels launched "
          f"{moved} on the training path")
    return moved


def train_config(cfg):
    """The train phase's TrainConfig: AdamW at lr 3e-4 after 2 warmup
    steps, no remat, one microbatch."""
    from repro_torch.launch.steps import optimizer_for
    from repro_torch.train.loop import TrainConfig
    opt = dataclasses.replace(optimizer_for(cfg), lr=3e-4, warmup_steps=2)
    return TrainConfig(optimizer=opt, remat="none", accum_steps=1)


def matmul_weights(cfg) -> int:
    """W: the weights a dense decoder's step multiplies by -- each
    layer's q, k, v and o projections and its MLP, and the head."""
    d, hq, hkv = cfg.d_model, cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    mlp = (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff
    return cfg.n_layers * (2 * d * hq + 2 * d * hkv + mlp) + d * cfg.vocab


def train_matmul_flops(cfg, batch, seq) -> int:
    """The plain train step's matmul FLOPs (no remat): 2·W a token
    forward and twice that backward, and QK^T and PV over every (query,
    key) pair of a sequence (the plain attention masks, it skips
    nothing): 4·B·S²·H·hd a layer forward, again x3 with the backward."""
    t, hq = batch * seq, cfg.n_heads * cfg.hd
    return 6 * t * matmul_weights(cfg) \
        + 12 * cfg.n_layers * batch * seq * seq * hq


def decode_matmul_flops(cfg, batch, s_max) -> int:
    """The plain decode step's matmul FLOPs: 2·W a sequence, and QK^T
    and PV of one query over all s_max cache rows a layer."""
    hq = cfg.n_heads * cfg.hd
    return 2 * batch * matmul_weights(cfg) \
        + 4 * cfg.n_layers * batch * s_max * hq


# ---------------------------------------------------------------------------
# roofline: the timed steps' counted costs against the card's roofline
# ---------------------------------------------------------------------------

ROOFLINE_WAIT_S = 600               # for the traces, after the mesh phase


def roofline_steps(args):
    """(name, config, shape, plan keywords) of each step a phase times,
    at that phase's config, depth and shapes."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig

    def cut(arch, layers=None):
        full = get_config(arch)
        cfg = full.reduced() if args.cpu_rehearsal else full
        return cfg if layers is None else \
            dataclasses.replace(cfg, n_layers=min(layers, cfg.n_layers))

    slots, ctx = LM_ENGINE["max_batch"], LM_ENGINE["max_context"]
    train = cut(TRAIN_ARCH)
    whisper = cut(ENCDEC_ARCH)
    frames = 150 if args.cpu_rehearsal else ENCDEC_FRAMES
    return [
        ("train step", train, ShapeConfig(
            "smoke", args.train_seq, args.train_batch, "train"),
         {"tc": train_config(train)}),
        ("lm decode", cut(LM_ARCH, LM_LAYERS),
         ShapeConfig("smoke", ctx, slots, "decode"), {}),
        ("hybrid decode", dataclasses.replace(
            cut(HYBRID_ARCH), n_layers=HYBRID_LAYERS),
         ShapeConfig("smoke", ctx, slots, "decode"), {}),
        ("rwkv decode", cut(RWKV_ARCH, RWKV_LAYERS),
         ShapeConfig("smoke", ctx, slots, "decode"), {}),
        ("encdec decode", whisper,
         ShapeConfig("smoke", frames, ENCDEC_CLIPS, "decode"), {}),
    ]


def roofline_traces(args) -> list:
    """Each step of `roofline_steps`, its plan built by `launch.steps` on
    one rank and traced once on the CPU (fake tensors, the plain path:
    `LoweredPlan.trace`), as plain numbers: the counted costs, their
    bounds at the card's rates (`roofline.analysis`: 989 TFLOP/s, 3.35
    TB/s), the plan's floor bytes (`LoweredPlan.floor_bytes`) and the
    trace's seconds."""
    from repro_torch.launch.steps import build_plan
    from repro_torch.roofline import analysis

    out = []
    for name, cfg, shape, kw in roofline_steps(args):
        t0 = time.perf_counter()
        plan = build_plan(cfg, shape, {"data": 1, "model": 1}, **kw)
        counter = plan.trace()
        costs = counter.costs()
        rl = analysis.analyze(costs, n_chips=1)
        out.append(dict(
            name=name, arch=cfg.name, layers=cfg.n_layers,
            batch=shape.global_batch, seq=shape.seq_len,
            matmul_flops=int(costs.matmul_flops), flops=int(costs.flops),
            bytes=int(costs.bytes), compute_s=rl.compute_s,
            memory_s=rl.memory_s, bottleneck=rl.bottleneck,
            floor_bytes=plan.floor_bytes(counter),
            trace_s=time.perf_counter() - t0))
    return out


def _roofline_child(conn, flags) -> None:
    """`roofline_traces` in a process of its own: ("ok", rows) or
    ("error", traceback) down `conn`."""
    try:
        torch.set_num_threads(1)
        conn.send(("ok", roofline_traces(types.SimpleNamespace(**flags))))
    except BaseException:
        import traceback
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def start_roofline(args):
    """Start the roofline phase's traces in a spawned process (host work
    alone, no CUDA): started before the build, they run beside it and
    the card phases.  -> (process, the end of the pipe to read)."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_roofline_child, daemon=True, args=(
        send, {"cpu_rehearsal": args.cpu_rehearsal,
               "train_batch": args.train_batch,
               "train_seq": args.train_seq}))
    proc.start()
    send.close()
    atexit.register(lambda: proc.is_alive() and proc.kill())
    return proc, recv


def finish_roofline(child):
    """The traces of `start_roofline`'s process (None, and a failed
    check, if it raised or sent nothing in ROOFLINE_WAIT_S); the process
    is ended either way."""
    proc, conn = child
    status, rows = "error", f"no traces in {ROOFLINE_WAIT_S} s"
    if conn.poll(ROOFLINE_WAIT_S):
        status, rows = conn.recv()
    proc.join(timeout=30)
    if proc.is_alive():
        proc.kill()
        proc.join()
    check(status == "ok", f"roofline traces: {rows}")
    return rows if status == "ok" else None


def run_roofline(args, rows=None) -> list:
    """The traced steps (`rows`, or `roofline_traces(args)` traced here)
    against the device ms their phases measured: counted matmul and
    total FLOPs and bytes; the compute and memory bounds of those counts
    and `count_ratio`, the larger over the measured ms (the plain path's
    counts: each kernel's work priced by its plain version's ops, every
    unfused operand and float32 copy included, so a ratio that can pass
    1); the step's floor, the larger of its floor bytes (the inputs it
    reads once, the donated ones written back, no cache or activation)
    over 3.35 TB/s and, for the train step, its weights' matmuls (6·W a
    token) over 989 TFLOP/s; and `share`, the floor over the measured
    ms.  Fails unless the StableLM step's and the Granite decode step's
    matmul FLOPs equal their closed forms."""
    from repro_torch.roofline import analysis

    if rows is None:
        rows = roofline_traces(args)
    cfgs = {name: cfg for name, cfg, _, _ in roofline_steps(args)}
    tokens = args.train_batch * args.train_seq
    for r in rows:
        name = r["name"]
        floor_flops = 6 * tokens * matmul_weights(cfgs[name]) \
            if name == "train step" else 0
        terms = {"bytes": r["floor_bytes"] / analysis.HBM_BW,
                 "operations": floor_flops / analysis.PEAK_FLOPS}
        by = max(terms, key=terms.get)
        floor_ms = 1e3 * terms[by]
        bound_ms = 1e3 * max(r["compute_s"], r["memory_s"])
        ms = STEP_MS.get(name)
        measured = "not measured" if ms is None else f"{ms:.3f}"
        share = "not measured" if ms is None else f"{floor_ms / ms:.3f}"
        ratio = "not measured" if ms is None else f"{bound_ms / ms:.3f}"
        log(f"roofline {name}: {r['arch']} layers={r['layers']} "
            f"batch={r['batch']} seq={r['seq']} "
            f"matmul_flops={r['matmul_flops']} flops={r['flops']} "
            f"bytes={r['bytes']} compute_ms={1e3 * r['compute_s']:.3f} "
            f"memory_ms={1e3 * r['memory_s']:.3f} bottleneck="
            f"{r['bottleneck']} floor_bytes={r['floor_bytes']} "
            f"floor_flops={floor_flops} floor_ms={floor_ms:.3f} floor_by="
            f"{by} device_ms={measured} share={share} count_ratio={ratio} "
            f"trace_s={r['trace_s']:.1f} [{CARD[0]}]")
    got = {r["name"]: r["matmul_flops"] for r in rows}
    for name, want in (
            ("train step", train_matmul_flops(
                cfgs["train step"], args.train_batch, args.train_seq)),
            ("lm decode", decode_matmul_flops(
                cfgs["lm decode"], LM_ENGINE["max_batch"],
                LM_ENGINE["max_context"]))):
        log(f"roofline {name}: counted matmul FLOPs {got.get(name)} vs "
            f"closed form {want}: equal {got.get(name) == want}")
        check(got.get(name) == want, f"roofline {name}: counted matmul "
              f"FLOPs {got.get(name)} != closed form {want}")
    return rows


# ---------------------------------------------------------------------------
# kernel vs plain on the card
# ---------------------------------------------------------------------------

MESH_ARCH = "jamba-v0.1-52b"        # the MoE at its published widths
MESH_SEED = 27                      # weights, tokens and the collectives'
MESH_RANKS = 4                      # on one card: gloo, ranks share it
MESH_CF = 8.0                       # no slot drops: equal to apply_moe
MESH_MESHES = {"1x4": (1, 4), "2x2": (2, 2)}    # (data, model)
MESH_PATHS = (("sharded", "1x4"), ("a2a", "1x4"), ("sharded", "2x2"),
              ("a2a", "2x2"), ("decode", "2x2"))
MESH_LAYERS = 2                     # Mamba + dense FFN, Mamba + the MoE
MESH_STEPS = 16                     # teacher-forced decode steps
MESH_F32_RTOL = 1e-5                # of max |y|, float32 paths
MESH_DECODE_RTOL = 2.0 ** -7        # its combine is a bfloat16 psum
MESH_GATE = 1.1                     # x the one-rank bfloat16 error
MESH_TOL = 1e-4                     # ring, LSE merge, pipeline (the
#                                     reference's test_multidevice bound)
MESH_TRAIN_ARCH = "stablelm-1.6b"   # the partitioned train step's model
MESH_TRAIN_LAYERS = 2               # of its 24, at its published widths
MESH_TRAIN_SEED = 29                # weights (the batches: seed 0)
MESH_TRAIN_STEPS = 3                # on (data 2, model 2); then step 0
#                                     replayed, and one step on (1, 4)
MESH_TRAIN_RTOL = 1e-5              # loss and grad_norm vs one rank
MESH_TRAIN_GRAD_TOL = 1e-4          # step 0's gradients, of a leaf's max
MESH_TRAIN_REPLAY_RTOL = 1e-6       # the replayed step's loss


def mesh_sizes(small: bool) -> dict:
    """The phase's shapes: tokens (B, S) and decode batch of the MoE; the
    ring matmul's (M, K, N); the LSE merge's (B, H, KVH, hd, cache,
    shortest length) at Granite-8B's decode widths; StableLM-1.6B for
    the cross-pod all-reduce; the pipeline at the reference's toy
    widths.  `small`: the CPU rehearsal's."""
    if small:
        return dict(tokens=(8, 64), decode=8, ring=(64, 256, 512),
                    lse=(2, 8, 2, 32, 128, 17), pipe=(4, 8, 16, 4))
    return dict(tokens=(8, 512), decode=8, ring=(512, 4096, 14336),
                lse=(8, 32, 8, 128, 1024, 117), pipe=(4, 8, 16, 4))


def mesh_config(small: bool, n_layers=None):
    """Jamba-v0.1 at capacity factor 8 (reduced for the rehearsal)."""
    from repro_torch.configs import get_config

    cfg = get_config(MESH_ARCH)
    cfg = cfg.reduced() if small else cfg
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MESH_CF))
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg


def mesh_inputs(cfg, small, dev):
    """The MoE's seeded bfloat16 weights and (prefill, decode) tokens:
    the same bits on every rank and in the parent."""
    from repro_torch.models import moe

    sizes = mesh_sizes(small)
    g = torch.Generator(device=dev).manual_seed(MESH_SEED)
    p = moe.init_moe(g, cfg, dev)
    x = torch.randn(*sizes["tokens"], cfg.d_model, generator=g, device=dev)
    xd = torch.randn(sizes["decode"], 1, cfg.d_model, generator=g,
                     device=dev)
    return p, x.to(torch.bfloat16), xd.to(torch.bfloat16)


def mesh_tokens(cfg, small):
    """The model run's prompts (B, S) and teacher-forced steps (B, T)."""
    b, s = mesh_sizes(small)["tokens"]
    rng = np.random.default_rng(MESH_SEED + 1)
    prompts = rng.integers(1, cfg.vocab, (b, s)).astype(np.int64)
    steps = rng.integers(1, cfg.vocab, (b, MESH_STEPS)).astype(np.int64)
    return torch.from_numpy(prompts), torch.from_numpy(steps)


def bits_digest(t: torch.Tensor, chunk: int = 1 << 24) -> int:
    """A position-weighted sum of the raw bits (equal tensors, equal
    digests), 2^24 values at a time."""
    b = t.detach().contiguous().view({
        1: torch.int8, 2: torch.int16, 4: torch.int32,
        8: torch.int64}[t.element_size()]).reshape(-1)
    total = torch.zeros((), dtype=torch.int64, device=b.device)
    for i in range(0, b.numel(), chunk):
        c = b[i:i + chunk].long()
        w = torch.arange(i, i + c.numel(), device=b.device) % 65521 + 1
        total += (c * w).sum()
    return int(total)


def upcast(p: dict) -> dict:
    """float32 copies of the weights, one leaf at a time (each bfloat16
    leaf freed as it goes)."""
    out = {}
    for k in list(p):
        out[k] = p.pop(k).float()
    return out


def forced_logits(api, params, prompts, steps, dev):
    """Prefill, then the teacher-forced decode steps: (1 + T, B, V)
    float32 logits."""
    logits, cache = api.prefill(params, {"tokens": prompts.to(dev)},
                                prompts.shape[1] + steps.shape[1])
    rows = [logits[:, 0].float()]
    for t in range(steps.shape[1]):
        logits, cache = api.decode_step(params, cache,
                                        steps[:, t:t + 1].to(dev))
        rows.append(logits[:, 0].float())
    return torch.stack(rows)


def mesh_train_setup(small: bool, dev):
    """StableLM-1.6B at its published widths cut to MESH_TRAIN_LAYERS
    layers, float32 (the reduced config for the rehearsal), the train
    phase's TrainConfig, and its batches (8 x 512 tokens; rehearsal
    4 x 32)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import registry

    cfg = get_config(MESH_TRAIN_ARCH)
    cfg = dataclasses.replace(cfg.reduced() if small else cfg,
                              n_layers=MESH_TRAIN_LAYERS, dtype="float32")
    batch, seq = (4, 32) if small else (8, 512)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=0), device=dev)
    return cfg, registry.get_model(cfg), train_config(cfg), data


def mesh_train_params(api, dev):
    """The seeded global parameters in the trainer's layout: the same
    bits on every rank and in the parent."""
    from repro_torch.models.convert import params_to_reference
    gen = torch.Generator(device=dev).manual_seed(MESH_TRAIN_SEED)
    return params_to_reference(api.init(gen, dev), api.cfg)


def mesh_train_reference(small, dev, d) -> dict:
    """The partitioned step's gate: MESH_TRAIN_STEPS one-rank steps on
    this process from the same parameters and batches; step 0's
    gradients (AdamW's mu / (1 - b1)) and each leaf's max |g| saved in
    `d` for the ranks."""
    from repro_torch.optim import OptimizerConfig, make_optimizer
    from repro_torch.train.loop import make_train_step
    from repro_torch.tree import leaves

    cfg, api, tc, data = mesh_train_setup(small, dev)
    params = mesh_train_params(api, dev)
    opt = make_optimizer(tc.optimizer)[0](params)
    out = {"inputs": [bits_digest(t) for t in leaves(params)[:4]],
           "rows": [], "n_params": sum(t.numel() for t in leaves(params))}
    step = make_train_step(api, tc)
    b1 = OptimizerConfig().b1
    for i in range(MESH_TRAIN_STEPS):
        b = data.batch_at(i)
        sync(dev)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        sync(dev)
        out["rows"].append((float(m["loss"]), float(m["grad_norm"]),
                            1e3 * (time.perf_counter() - t0)))
        if i == 0:
            grads = [(mu / (1 - b1)).cpu() for mu in leaves(opt.mu)]
            torch.save({"grads": grads,
                        "max": [float(g.abs().max()) for g in grads]},
                       os.path.join(d, "train_grads.pt"))
            del grads
    out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                       if dev.type == "cuda" else float("nan"))
    return out


def card_memory(dev) -> str:
    """The card's free memory and this process's share of it."""
    if dev.type != "cuda":
        return "not measured (no card)"
    free, total = torch.cuda.mem_get_info()
    return (f"free {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB, this "
            f"process reserves {torch.cuda.memory_reserved() / 2 ** 30:.2f} "
            f"(allocated {torch.cuda.memory_allocated() / 2 ** 30:.2f})")


def run_mesh(args, dev, world) -> dict:
    """The mesh phase: the one-rank references on this process, then the
    four ranks of `world` (`launch.mesh.World`, started in the train phase:
    one card, gloo); then the one-rank train step on this process and the
    partitioned one on the ranks.  Returns the phase's kernel launch counts (none: its
    paths run torch ops and collectives)."""
    from repro_torch.models import moe, registry, transformer
    from repro_torch.tree import leaves, tree_map

    small = args.cpu_rehearsal
    t_lap = [time.perf_counter()]

    def lap():
        t, t_lap[0] = t_lap[0], time.perf_counter()
        return t_lap[0] - t

    # -- A: the global MoE layer on one rank, bfloat16 and float32 --------
    cfg = mesh_config(small)
    p, x, xd = mesh_inputs(cfg, small, dev)
    refs = {"inputs": [bits_digest(t) for t in (x, xd, p["w_gate"],
                                                p["w_down"])]}
    n_w = sum(t.numel() for t in p.values())
    y, aux = moe.apply_moe(p, cfg, x)                 # warm
    sync(dev)
    t0 = time.perf_counter()
    y, aux = moe.apply_moe(p, cfg, x)
    sync(dev)
    global_ms = (time.perf_counter() - t0) * 1e3
    refs["moe bfloat16"] = (y.float().cpu(), moe.apply_moe(
        p, cfg, xd)[0].float().cpu(), {k: float(v) for k, v in aux.items()})
    p32 = upcast(p)
    del p, y
    y, aux = moe.apply_moe(p32, cfg, x.float())
    refs["moe float32"] = (y.cpu(), moe.apply_moe(p32, cfg, xd.float())[0]
                           .cpu(), {k: float(v) for k, v in aux.items()})
    del p32, y
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"mesh moe {cfg.name}: d={cfg.d_model} experts={cfg.moe.n_experts} "
        f"top_k={cfg.moe.top_k} d_expert_ff={cfg.moe.d_expert_ff} "
        f"capacity_factor={MESH_CF} expert weights={n_w} "
        f"({n_w * 2 / 2 ** 30:.2f} GiB bf16 a rank); tokens "
        f"{tuple(x.shape[:2])} prefill, {tuple(xd.shape[:2])} decode; "
        f"global apply_moe on one rank: bf16 {global_ms:.2f} ms a call "
        f"(host clock after a sync) [{lap():.1f} s]")

    # -- B: the model, 2 layers, on one rank in float32 and bfloat16 -------
    mcfg = mesh_config(small, MESH_LAYERS)
    layout = transformer.layer_layout(mcfg)
    api = registry.get_model(mcfg)
    prompts, steps = mesh_tokens(mcfg, small)
    params = api.init(torch.Generator(device=dev).manual_seed(MESH_SEED + 2),
                      dev)
    n_m = sum(t.numel() for t in leaves(params))
    want = forced_logits(api, params, prompts, steps, dev)      # bf16
    c32 = dataclasses.replace(mcfg, dtype="float32")
    params = tree_map(lambda t: t.float(), params)
    ref32 = forced_logits(registry.get_model(c32), params, prompts, steps,
                          dev)
    err = (want - ref32).abs()
    refs["model"] = (ref32.cpu(), float(err.max()), float(err.mean()))
    log(f"mesh model {mcfg.name}: layers={mcfg.n_layers} "
        f"({' '.join(k + ('+moe' if m else '') for k, m in layout)})"
        f" params={n_m} ({n_m * 2 / 2 ** 30:.2f} GiB bf16 a rank); "
        f"{tuple(prompts.shape)} prompts + {MESH_STEPS} decode steps on "
        f"one rank: bf16 vs float32 max_abs_err={refs['model'][1]:.4g} "
        f"mean={refs['model'][2]:.4g} [{lap():.1f} s]")
    del params, want, ref32, err
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the ranks: the MoE paths, the model run, the collectives ----------
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "refs.pt")
        torch.save(refs, path)
        log(f"mesh card memory before the ranks' parts: {card_memory(dev)}")
        t0, wall0 = time.perf_counter(), time.time()
        ranks = world.run(mesh_rank, args=(path, small, global_ms))
        launch_s = time.perf_counter() - t0

        # -- C: StableLM's train step on one rank (the partitioned step's
        # gate), once the ranks have given their parts' memory back ------
        log(f"mesh card memory before the one-rank train step: "
            f"{card_memory(dev)}")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        refs = {"train": mesh_train_reference(small, dev, d), "card": CARD[0]}
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        rows = refs["train"]["rows"]
        log(f"mesh train reference (one rank, this process): "
            f"{MESH_TRAIN_ARCH} {MESH_TRAIN_LAYERS} layers float32, "
            f"params={refs['train']['n_params']}: " + "; ".join(
                f"step {i} loss={lo:.6f} grad_norm={gn:.6f} ms={ms:.1f}"
                for i, (lo, gn, ms) in enumerate(rows))
            + f" (host clock after a sync); peak "
            f"{refs['train']['peak_gib']:.2f} GiB; then "
            f"{card_memory(dev)} [{lap():.1f} s] [{CARD[0]}]")

        # -- D: the partitioned train step on the ranks --------------------
        torch.save(refs, path)
        t0 = time.perf_counter()
        trained = world.run(mesh_train_rank, args=(path,))
        launch_s += time.perf_counter() - t0
    for q, t in zip(ranks, trained):
        for key in ("lines", "checks"):
            q[key] += t[key]
        for key in ("digests", "parts", "peaks", "free"):
            q[key].update(t[key])
    for line in ranks[0]["lines"]:
        log(line)
    for ok, what in ranks[0]["checks"]:
        check(ok, what)
    mesh_train_summary(trained)
    differ = sorted({k for r in ranks for k in r["digests"]
                     if r["digests"][k] != ranks[0]["digests"].get(k)})
    same = not differ
    check(same, f"mesh: the ranks' results differ in {differ}")
    log(f"mesh ranks agree: {same} ({len(ranks[0]['digests'])} results "
        f"on each of {len(ranks)} ranks, bit for bit); run_s="
        f"{launch_s:.1f}: ranks entered after "
        f"{min(q['entered'] for q in ranks) - wall0:.1f}-"
        f"{max(q['entered'] for q in ranks) - wall0:.1f} s, meshes "
        f"{ranks[0]['startup_s']:.1f} s, then rank 0's parts "
        + ", ".join(f"{k} {v:.1f} s" for k, v in ranks[0]["parts"].items())
        + f" [{lap():.1f} s]")
    if dev.type == "cuda":
        log("mesh ranks' peak device memory (torch.cuda.max_memory_allocated"
            " a rank, GiB, by part): " + "; ".join(
                f"rank {i} " + ", ".join(f"{k} {v:.2f}"
                                         for k, v in q["peaks"].items())
                for i, q in enumerate(ranks))
            + f"; the four ranks' largest sum "
            f"{sum(max(q['peaks'].values()) for q in ranks):.2f}; the "
            f"card's free GiB as each part began (rank 0): " + ", ".join(
                f"{k} {v:.2f}" for k, v in ranks[0]["free"].items()))
    return {}


_MESH_RANK: list = []          # this rank process's MeshRank, across runs


class MeshRank:
    """What one rank of the mesh phase holds: its device, meshes and the
    parent's references (rank 0), and what it reports back."""

    def __init__(self, rank, refs_path, small, global_ms):
        from repro_torch.launch.mesh import make_mesh

        self.entered = time.time()          # the launcher's wall clock
        t0 = time.perf_counter()
        self.rank, self.small, self.global_ms = rank, small, global_ms
        on_card = torch.cuda.is_available() and not small
        self.dev = (torch.device("cuda", torch.cuda.current_device())
                    if on_card else torch.device("cpu"))
        self.meshes = {name: make_mesh(shape, ("data", "model"))
                       for name, shape in MESH_MESHES.items()}
        self.meshes["pod"] = make_mesh((2, 2), ("pod", "data"))
        self.meshes["stage"] = make_mesh((MESH_RANKS,), ("stage",))
        self.startup_s = time.perf_counter() - t0
        self.refs = torch.load(refs_path) if rank == 0 else None
        self.grads_path = os.path.join(os.path.dirname(refs_path),
                                       "train_grads.pt")
        self.lines, self.checks, self.digests = [], [], {}
        self.parts, self.peaks, self.free = {}, {}, {}
        self.train: dict = {}

    def part(self, name, fn) -> list:
        """Run one part; its seconds, peak memory and the card's free
        memory as it began; its memory given back to the card after."""
        on_card = self.dev.type == "cuda"
        t0 = time.perf_counter()
        if on_card:
            torch.cuda.reset_peak_memory_stats(self.dev)
            self.free[name] = torch.cuda.mem_get_info(self.dev)[0] / 2 ** 30
        out = fn()
        self.parts[name] = time.perf_counter() - t0
        if on_card:
            self.peaks[name] = (torch.cuda.max_memory_allocated(self.dev)
                                / 2 ** 30)
            torch.cuda.empty_cache()
        return out

    def note(self, line):
        if self.rank == 0:
            self.lines.append(line)

    def gate(self, ok, what):
        if self.rank == 0:
            self.checks.append((bool(ok), what))

    def ref(self, key):
        return tuple(t.to(self.dev) if isinstance(t, torch.Tensor) else t
                     for t in self.refs[key])

    def timed(self, fn):
        """(result, event ms on this rank, host ms, collectives' host ms,
        MiB this rank sent) of one call that every rank enters together."""
        import torch.distributed as dist

        from repro_torch.distributed import api

        on_card = self.dev.type == "cuda"
        dist.barrier()
        if on_card:
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        api.STATS.clear()
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            ev[1].record()
            torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        stats = dict(api.STATS)
        dist.barrier()
        ms = ev[0].elapsed_time(ev[1]) if on_card else float("nan")
        return (out, ms, host_ms, stats.get("seconds", 0.0) * 1e3,
                stats.get("bytes", 0) / 2 ** 20)

    def time_note(self, ms, host_ms, coll_ms, coll_mb) -> str:
        return (f"ms={ms:.3f} (events, rank 0) host_ms={host_ms:.3f} "
                f"collectives_ms={coll_ms:.3f} ({coll_mb:.1f} MiB sent; "
                f"share={coll_ms / max(host_ms, 1e-9):.2f}, gloo through "
                f"the host)")


def mesh_rank(rank, refs_path, small, global_ms):
    """One rank of the mesh phase (spawned by `run_mesh`): the three MoE
    paths in bfloat16, the model run, the paths in float32, then the
    collectives.  Returns rank 0's lines and checks and every rank's
    result digests."""
    r = MeshRank(rank, refs_path, small, global_ms)
    from repro_torch.distributed import api

    r.note("mesh transport: " + ", ".join(
        f"{name} {api.transport(m, m.mesh_dim_names[-1])}"
        for name, m in r.meshes.items())
        + ": psum / pmean / pmax = all_gather, then a fold in mesh order; "
        "all_gather; all_to_all; ppermute = all_to_all with one nonempty "
        "split (host: gloo, CUDA tensors staged through host memory)")
    _MESH_RANK[:] = [r]
    calls = []
    for name, part in (("moe bf16", lambda: mesh_moe_paths(r, "bfloat16")),
                       ("model", lambda: mesh_model(r)),
                       ("moe f32", lambda: mesh_moe_paths(r, "float32")),
                       ("collectives", lambda: mesh_collectives(r) or [])):
        calls += r.part(name, part)
    ran = {path for path, n in calls if n}
    r.gate(ran == {"sharded", "a2a", "decode"},
           f"mesh: the MoE paths that ran are {sorted(ran)}")
    return {"lines": r.lines, "checks": r.checks, "digests": r.digests,
            "entered": r.entered, "startup_s": r.startup_s,
            "parts": r.parts, "peaks": r.peaks, "free": r.free}


def mesh_train_rank(rank, refs_path):
    """The mesh phase's second run on the same ranks (`mesh_rank` ran
    first): the partitioned train step against the one-rank step that
    `run_mesh` ran in between (its references in `refs_path`)."""
    r = _MESH_RANK[0]
    r.refs = torch.load(refs_path) if rank == 0 else None
    r.lines, r.checks, r.digests = [], [], {}
    r.parts, r.peaks, r.free = {}, {}, {}
    r.part("train", lambda: mesh_train(r) or [])
    return {"lines": r.lines, "checks": r.checks, "digests": r.digests,
            "parts": r.parts, "peaks": r.peaks, "free": r.free,
            "train": r.train}


def mesh_moe_paths(r: MeshRank, dtype: str) -> list:
    """Each path on its meshes against the global layer's references:
    float32 within 1e-5 of max |y| (the decode path, whose combine is a
    bfloat16 psum, within 2^-7), bfloat16 within 1.1x the global bfloat16
    layer's error against the global float32 one; aux losses within
    rtol 1e-5 (decode: the reference's zeros); in bfloat16 a replay bit
    for bit (and timed).  -> [(path, calls)]."""
    from repro_torch.distributed.api import use_mesh
    from repro_torch.models import moe, tuning

    cfg = mesh_config(r.small)
    p, x, xd = mesh_inputs(cfg, r.small, r.dev)
    if dtype == "bfloat16" and r.rank == 0:
        got = [bits_digest(t) for t in (x, xd, p["w_gate"], p["w_down"])]
        r.gate(got == r.refs["inputs"],
               "mesh: rank 0's seeded inputs differ from the parent's")
    if dtype == "float32":
        p, x, xd = upcast(p), x.float(), xd.float()
    tuning.set_knob("moe_combine_bf16", dtype == "bfloat16")
    out = []
    try:
        for path, mname in MESH_PATHS:
            fn = getattr(moe, f"apply_moe_{path}")
            xin = xd if path == "decode" else x
            moe.CALLS.clear()
            with use_mesh(r.meshes[mname]):
                # bfloat16: a first call, then the timed replay
                first = fn(p, cfg, xin) if dtype == "bfloat16" else None
                (y, aux), *t = r.timed(lambda: fn(p, cfg, xin))
            out.append((path, moe.CALLS[path]))
            key = f"{path} {mname} {dtype}"
            r.digests[key] = bits_digest(y)
            if r.rank == 0:
                mesh_path_checks(r, key, path, dtype, first, y, aux, t)
    finally:
        tuning.set_knob("moe_combine_bf16", True)
    del p, x, xd
    if r.dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def mesh_path_checks(r, key, path, dtype, first, y, aux, t) -> None:
    replay = first is None or all(same_bits(u, v) for u, v in zip(
        (first[0], *first[1].values()), (y, *aux.values())))
    r.gate(replay, f"mesh {key}: a replay differs")
    r.gate(bool(torch.isfinite(y).all()), f"mesh {key}: not finite")
    i = 1 if path == "decode" else 0
    f32 = r.ref("moe float32")[i]
    top = float(f32.abs().max())
    if dtype == "float32":
        err = float((y - f32).abs().max())
        rtol = MESH_DECODE_RTOL if path == "decode" else MESH_F32_RTOL
        ok = err <= rtol * top
        how = (f"vs global float32: max_abs_err={err:.4g} <= "
               f"{rtol:.3g} x max|y| {top:.4g}")
    else:
        base = r.ref("moe bfloat16")[i]
        err = float((y.float() - f32).abs().max())
        mean = float((y.float() - f32).abs().mean())
        berr = float((base - f32).abs().max())
        bmean = float((base - f32).abs().mean())
        ok = err <= MESH_GATE * berr and mean <= MESH_GATE * bmean
        how = (f"vs global float32: max_abs_err={err:.4g} mean={mean:.4g}; "
               f"global bfloat16's {berr:.4g} / {bmean:.4g} (gate "
               f"{MESH_GATE}x)")
    if path == "decode":
        aux_ok = all(float(v) == 0.0 for v in aux.values())
        aux_how = "aux losses 0 (the reference's, at serve time)"
    else:
        want = r.refs[f"moe {dtype}"][2]
        aux_ok = all(abs(float(aux[k]) - want[k]) <= 1e-5 * abs(want[k])
                     for k in want)
        aux_how = "aux " + " ".join(f"{k}={float(aux[k]):.7g} (global "
                                    f"{want[k]:.7g})" for k in want)
    r.gate(ok, f"mesh {key}: {how}")
    r.gate(aux_ok, f"mesh {key}: {aux_how}, rtol 1e-5")
    r.note(f"mesh {key}: {how} ok={ok}; {aux_how} ok={aux_ok}; "
           + (f"replay bit-identical={replay}; " if first else "one call; ")
           + f"{r.time_note(*t)}; global one-rank bf16 {r.global_ms:.3f} "
           "ms")


def mesh_model(r: MeshRank) -> list:
    """Jamba's first two layers at full width under use_mesh on (2, 2),
    with the reference's optimized profile's `moe_all_to_all` (off):
    prefill through apply_moe_auto to the sharded path, the decode steps
    to the weight-stationary one; teacher-forced logits against the
    one-rank float32 run within 1.1x the one-rank bfloat16 run's error,
    and a replay of the whole run bit for bit.
    -> [(path, calls)]."""
    from repro_torch.distributed.api import use_mesh
    from repro_torch.models import moe, registry, tuning

    mcfg = mesh_config(r.small, MESH_LAYERS)
    api = registry.get_model(mcfg)
    prompts, steps = mesh_tokens(mcfg, r.small)
    params = api.init(torch.Generator(device=r.dev).manual_seed(
        MESH_SEED + 2), r.dev)
    moe.CALLS.clear()
    runs = []
    tuning.set_knob("moe_all_to_all", False)
    try:
        with use_mesh(r.meshes["2x2"]):
            for _ in range(2):
                runs.append(r.timed(lambda: forced_logits(
                    api, params, prompts, steps, r.dev)))
    finally:
        tuning.set_knob("moe_all_to_all", True)
    calls = dict(moe.CALLS)
    got = runs[0][0]
    r.digests["model"] = bits_digest(got)
    replay = same_bits(runs[1][0], got)
    want = {"sharded": 2, "decode": 2 * MESH_STEPS}
    r.gate(calls == want, f"mesh model: MoE path calls {calls}, not {want}")
    if r.rank == 0:
        ref32, berr, bmean = r.ref("model")
        err = float((got - ref32).abs().max())
        mean = float((got - ref32).abs().mean())
        ok = err <= MESH_GATE * berr and mean <= MESH_GATE * bmean
        r.gate(ok, f"mesh model: bf16 on the mesh vs one-rank float32 "
                   f"max_abs_err={err:.4g} mean={mean:.4g}, one-rank bf16 "
                   f"{berr:.4g} / {bmean:.4g} (gate {MESH_GATE}x)")
        r.gate(replay, "mesh model: a replay differs")
        r.gate(bool(torch.isfinite(got).all()), "mesh model: not finite")
        r.note(f"mesh model on 2x2 ({mcfg.n_layers} layers, prompts "
               f"{tuple(prompts.shape)} + {MESH_STEPS} teacher-forced "
               f"decode steps): MoE calls {calls} (moe_all_to_all off: "
               f"prefill through apply_moe_auto -> sharded, each decode "
               f"step -> decode); vs "
               f"one-rank float32 max_abs_err={err:.4g} mean={mean:.4g}; "
               f"one-rank bf16 {berr:.4g} / {bmean:.4g} (gate {MESH_GATE}x) "
               f"ok={ok}; prefill and {MESH_STEPS} steps replayed "
               f"bit-identical={replay}; the run {r.time_note(*runs[0][1:])}")
    del params, runs, got
    if r.dev.type == "cuda":
        torch.cuda.empty_cache()
    return list(calls.items())


def mesh_train(r: MeshRank) -> None:
    """StableLM-1.6B's partitioned train step (`distributed.partition`):
    MESH_TRAIN_STEPS steps on (data 2, model 2) from the seeded state,
    each rank on its blocks and its rows of the batch; step 0 replayed
    from a copy of its state; one step on (data 1, model 4).  Every rank
    holds its step-0 gradients (AdamW's mu / (1 - b1)) against its block
    of the one-rank step's; rank 0 gates the losses and norms against
    the one-rank steps (`mesh_train_reference`)."""
    import struct

    from repro_torch.distributed import partition
    from repro_torch.distributed.sharding import block_of, spec_leaves
    from repro_torch.optim import OptimizerConfig, make_optimizer
    from repro_torch.train.loop import make_train_step
    from repro_torch.tree import leaves, tree_map

    cfg, api, tc, data = mesh_train_setup(r.small, r.dev)
    ref = torch.load(r.grads_path, mmap=True)
    b1 = OptimizerConfig().b1
    runs = {}
    for name, n_steps in (("2x2", MESH_TRAIN_STEPS), ("1x4", 1)):
        mesh = r.meshes[name]
        part = partition.RankLayout(cfg, mesh)
        params = mesh_train_params(api, r.dev)
        if name == "2x2":
            r.digests["train inputs"] = [bits_digest(t)
                                         for t in leaves(params)[:4]]
        blocks = partition.cut(params, part.param_specs, mesh)
        del params
        opt = make_optimizer(tc.optimizer)[0](blocks)
        step = make_train_step(api, tc, mesh)
        rows, snap = [], None
        for i in range(n_steps):
            b = partition.batch_block(data.batch_at(i), mesh)
            if i == 0 and name == "2x2":
                snap = tree_map(torch.clone, (blocks, opt))
            (blocks, opt, m), *t = r.timed(lambda: step(blocks, opt, b))
            rows.append((float(m["loss"]), float(m["grad_norm"]), *t))
            r.digests[f"train {name} step {i}"] = struct.pack(
                "<ff", rows[-1][0], rows[-1][1])
            if i == 0:
                err = 0.0
                for mu, g, mx, spec in zip(
                        leaves(opt.mu), ref["grads"], ref["max"],
                        spec_leaves(part.param_specs)):
                    want = block_of(g, spec, mesh).to(r.dev)
                    err = max(err, float((mu / (1 - b1) - want).abs().max())
                              / max(mx, 1e-30))
                r.train[f"{name} grad_err"] = err
        if snap is not None:
            (p0, o0), b = snap, partition.batch_block(data.batch_at(0), mesh)
            (_, _, m), *t = r.timed(lambda: step(p0, o0, b))
            runs["replay"] = (float(m["loss"]), float(m["grad_norm"]), *t)
            del snap, p0, o0
        runs[name] = rows
        del blocks, opt
        if r.dev.type == "cuda":
            torch.cuda.empty_cache()
    r.train["rows"] = runs
    if r.rank == 0:
        want = r.refs["train"]
        r.gate(r.digests["train inputs"] == want["inputs"],
               "mesh train: the ranks' parameters differ from the parent's")
        card = r.refs["card"]
        for name in ("2x2", "1x4"):
            for i, (loss, gn, ms, host_ms, coll_ms, coll_mb) in enumerate(
                    runs[name]):
                lo1, gn1, ms1 = want["rows"][i]
                el, eg = abs(loss / lo1 - 1), abs(gn / gn1 - 1)
                ok = el <= MESH_TRAIN_RTOL and eg <= MESH_TRAIN_RTOL
                r.gate(ok, f"mesh train {name} step {i}: loss {loss:.7g} vs "
                           f"{lo1:.7g}, grad_norm {gn:.7g} vs {gn1:.7g}")
                r.note(f"mesh train {name} step {i}: loss={loss:.6f} "
                       f"grad_norm={gn:.6f}; one rank loss={lo1:.6f} "
                       f"grad_norm={gn1:.6f} rel_err loss={el:.3g} "
                       f"grad_norm={eg:.3g} (gate {MESH_TRAIN_RTOL}); the "
                       f"step {r.time_note(ms, host_ms, coll_ms, coll_mb)}; "
                       f"one-rank step ms={ms1:.1f} [{card}]")
        loss, gn, ms, host_ms, coll_ms, coll_mb = runs["replay"]
        rel = abs(loss / runs["2x2"][0][0] - 1)
        r.gate(rel <= MESH_TRAIN_REPLAY_RTOL,
               f"mesh train replay: loss {loss:.9g} vs "
               f"{runs['2x2'][0][0]:.9g}")
        r.note(f"mesh train 2x2 step 0 replayed from a copy of its state: "
               f"loss={loss:.6f} rel_err={rel:.3g} (gate "
               f"{MESH_TRAIN_REPLAY_RTOL}) host_ms={host_ms:.1f} [{card}]")
    return None


def mesh_train_summary(ranks) -> None:
    """The partitioned step's cross-rank gates: step 0's gradients on
    every rank within MESH_TRAIN_GRAD_TOL of the one-rank step's leaf
    maxima (the loss and norm bits are in the ranks' digests)."""
    for name in ("2x2", "1x4"):
        errs = [q["train"][f"{name} grad_err"] for q in ranks]
        ok = max(errs) <= MESH_TRAIN_GRAD_TOL
        check(ok, f"mesh train {name}: step 0's gradients differ from the "
                  f"one-rank step's by {max(errs):.3g} of a leaf's max")
        log(f"mesh train {name}: step 0's gradients (mu / (1 - b1)) vs the "
            f"one-rank step's, max over each rank's blocks of |diff| / the "
            f"leaf's max |g|: " + ", ".join(
                f"rank {i} {e:.3g}" for i, e in enumerate(errs))
            + f" (gate {MESH_TRAIN_GRAD_TOL}) ok={ok} [{CARD[0]}]")


def mesh_collectives(r: MeshRank) -> None:
    """The ring matmul and the LSE merge on (1, 4), the cross-pod
    all-reduce on (pod 2, data 2), the pipeline on 4 stages."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives, pipeline
    from repro_torch.distributed.api import P, shard_map
    from repro_torch.models import registry
    from repro_torch.optim import grad_compress
    from repro_torch.tree import leaves_with_path

    sizes = mesh_sizes(r.small)
    dev = r.dev
    g = torch.Generator(device=dev).manual_seed(MESH_SEED + 3)
    rng = np.random.default_rng(MESH_SEED + 4)

    # ring all-gather matmul, float32, w sharded on 'model'
    m, k, n = sizes["ring"]
    x = torch.randn(m, k, generator=g, device=dev)
    w = torch.randn(k, n, generator=g, device=dev)
    ring = shard_map(
        lambda a, b: collectives.ring_allgather_matmul(a, b, "model"),
        r.meshes["1x4"], in_specs=(P(None, None), P("model", None)),
        out_specs=P(None, None))
    y, *t = r.timed(lambda: ring(x, w))
    want = x @ w
    err = float((y - want).abs().max())
    ok = bool(torch.allclose(y, want, rtol=MESH_TOL, atol=MESH_TOL))
    # each rank folds the shards from its own ring position, so the
    # ranks' products differ in rounding (as the reference's devices'
    # do): every rank holds its own within the bound
    r.digests["ring within bound"] = ok
    r.gate(ok, f"mesh ring_allgather_matmul: max_abs_err={err:.4g}")
    r.note(f"mesh ring_allgather_matmul ({m}, {k}) @ ({k}, {n}) float32, w "
           f"on model 4: vs torch.matmul max_abs_err={err:.4g} (rtol=atol "
           f"{MESH_TOL}) ok={ok}; {r.time_note(*t)}")
    del x, w, y, want

    # LSE-merged decode attention over a KV cache split in 4
    b, h, kvh, hd, s, lo = sizes["lse"]
    q = torch.randn(b, h, 1, hd, generator=g, device=dev).bfloat16()
    kc = torch.randn(b, s, kvh, hd, generator=g, device=dev).bfloat16()
    vc = torch.randn(b, s, kvh, hd, generator=g, device=dev).bfloat16()
    lengths = torch.from_numpy(rng.integers(lo, s + 1, b)).to(dev)
    valid = torch.arange(s, device=dev)[None, :] < lengths[:, None]
    merge = shard_map(
        lambda *a: collectives.lse_merge_attention(*a[:3], "model", a[3]),
        r.meshes["1x4"],
        in_specs=(P(), P(None, "model", None, None),
                  P(None, "model", None, None), P(None, "model")),
        out_specs=P())
    out, *t = r.timed(lambda: merge(q, kc, vc, valid))
    kf = kc.float().repeat_interleave(h // kvh, dim=2)
    vf = vc.float().repeat_interleave(h // kvh, dim=2)
    sc = torch.einsum("bhqd,bshd->bhqs", q.float(), kf) / hd ** 0.5
    sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
    want = torch.einsum("bhqs,bshd->bhqd", sc.softmax(-1), vf)
    err = float((out - want).abs().max())
    ok = bool(torch.allclose(out, want, rtol=MESH_TOL, atol=MESH_TOL))
    r.digests["lse"] = bits_digest(out)
    r.gate(ok, f"mesh lse_merge_attention: max_abs_err={err:.4g}")
    r.note(f"mesh lse_merge_attention B {b} H {h}/{kvh} hd {hd}, {s}-token "
           f"cache on model 4, lengths {lengths.min().item()}-"
           f"{lengths.max().item()}, bf16 in: vs plain softmax attention "
           f"max_abs_err={err:.4g} (rtol=atol {MESH_TOL}) ok={ok}; "
           f"{r.time_note(*t)}")
    del q, kc, vc, kf, vf, sc

    # the int8 cross-pod all-reduce over StableLM-1.6B's embedding and
    # first layer, each pod its own gradients and residuals
    scfg = get_config("stablelm-1.6b")
    scfg = dataclasses.replace(scfg.reduced() if r.small else scfg,
                               n_layers=1)
    sp = registry.get_model(scfg).init(
        torch.Generator(device=dev).manual_seed(MESH_SEED + 5), dev)
    shapes = {key: tuple(v.shape) for key, v in leaves_with_path(
        {"embed": sp["embed"], "layer0": sp["layers"][0]})}
    del sp
    grads = {key: torch.randn((2,) + sh, generator=g, device=dev)
             for key, sh in shapes.items()}
    resid = {key: torch.randn((2,) + sh, generator=g, device=dev) * 0.01
             for key, sh in shapes.items()}

    def cross(gr, rs):
        st = grad_compress.CompressionState(
            residual={key: v[0] for key, v in rs.items()})
        return grad_compress.crosspod_allreduce_compressed(
            {key: v[0] for key, v in gr.items()}, st, "pod")

    (red, new), *t = r.timed(lambda: shard_map(
        cross, r.meshes["pod"], in_specs=(P("pod"), P("pod")),
        out_specs=(P(), P()))(grads, resid))
    # every rank: its pod's residual is the one-rank formula's
    mine = r.meshes["pod"].get_local_rank("pod")
    own = grad_compress.compress_grads(
        {key: v[mine] for key, v in grads.items()},
        grad_compress.CompressionState(
            residual={key: v[mine] for key, v in resid.items()}))[2]
    r.digests["crosspod"] = sum(bits_digest(v) for v in red.values())
    r.digests["crosspod own residual"] = all(
        torch.equal(new.residual[key], own.residual[key]) for key in shapes)
    if r.rank == 0:
        pods = [grad_compress.compress_grads(
            {key: v[i] for key, v in grads.items()},
            grad_compress.CompressionState(
                residual={key: v[i] for key, v in resid.items()}))
            for i in range(2)]
        same = r.digests["crosspod own residual"] and all(torch.equal(
            red[key], (pods[0][0][key].to(torch.int32)
                       + pods[1][0][key].to(torch.int32)).float()
            * ((pods[0][1][key] + pods[1][1][key]) / 2) / 2)
            for key in shapes)
        n_el = sum(int(np.prod(sh)) for sh in shapes.values())
        r.gate(same, "mesh crosspod_allreduce_compressed: differs from "
                     "the formula on one rank")
        r.note(f"mesh crosspod_allreduce_compressed on pod 2 x data 2: "
               f"{len(shapes)} leaves of {scfg.name}'s embedding and layer 0 "
               f"({n_el} values a pod), reduced gradients and residuals bit "
               f"for bit the one-rank formula: {same}; {r.time_note(*t)}")
    del grads, resid, red, new, own

    # the GPipe schedule on 4 stages at the reference's toy widths
    stages, micro, width, mb = sizes["pipe"]
    pcfg = pipeline.PipelineConfig(stages, micro, axis_name="stage")
    stacked, stage_fn = pipeline.make_pipelined_mlp(
        pcfg, [width] * (2 * stages + 1), g, dev)
    xs = torch.randn(micro, mb, width, generator=g, device=dev)
    outs, *t = r.timed(lambda: shard_map(
        lambda prm, v: pipeline.pipeline_apply(stage_fn, pcfg, prm[0], v),
        r.meshes["stage"], in_specs=(P("stage"), P()),
        out_specs=P("stage"))(stacked, xs))
    got = outs.reshape(stages, micro, mb, width)[-1]
    want = pipeline.reference_apply(stacked, xs)
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=MESH_TOL, atol=MESH_TOL))
    r.digests["pipeline"] = bits_digest(got)
    r.gate(ok, f"mesh pipeline_apply: max_abs_err={err:.4g}")
    r.note(f"mesh pipeline_apply {stages} stages x {micro} microbatches "
           f"({pcfg.n_ticks} ticks, bubble {pcfg.bubble_fraction:.3f}), "
           f"width {width}: last stage vs reference_apply max_abs_err="
           f"{err:.4g} (rtol=atol {MESH_TOL}) ok={ok}; {r.time_note(*t)}")


def x_for(sr_name, n, gen, dev, kind="int"):
    """A vector in the semiring's domain; min_plus gets some +inf."""
    def ints(lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen).float()
    if sr_name == "plus_times":
        x = ints(-8, 9) if kind == "int" else torch.rand(n, generator=gen)
    elif sr_name == "or_and":
        x = ints(0, 2)
    elif sr_name == "max_times":
        x = ints(0, 9)
    else:
        x = torch.rand(n, generator=gen) * 100
        x[torch.rand(n, generator=gen) < 0.1] = float("inf")
    return x.to(dev)


def int_values(vals, sr_name, gen):
    """Integer-valued copy of a layout's values; padding slots (the
    plus-times pad 0.0 / min_plus pad +inf) are kept as they are."""
    real = (vals != 0.0) & torch.isfinite(vals)
    lo = 1 if sr_name in ("or_and", "max_times") else -8
    hi = 2 if sr_name == "or_and" else 9
    # drawn where the values lie: BELL layouts hold 10^8-10^9 entries
    here = torch.Generator(device=vals.device).manual_seed(
        int(torch.randint(0, 2 ** 31, (1,), generator=gen)))
    ints = torch.randint(lo, hi, vals.shape, generator=here,
                         device=vals.device).float()
    ints[ints == 0] = 1
    return torch.where(real, ints, vals)


def compare(errs, kname, label, got, want, exact):
    finite = torch.isfinite(want)
    inf_ok = torch.equal(torch.isinf(got), torch.isinf(want)) and \
        torch.equal(got[~finite], want[~finite])
    err = float((got[finite] - want[finite]).abs().max()) \
        if finite.any() else 0.0
    if exact:
        ok = torch.equal(got, want)
    else:
        ok = inf_ok and torch.allclose(got, want, rtol=REAL_RTOL,
                                       atol=REAL_ATOL)
    errs.setdefault(kname, 0.0)
    errs[kname] = max(errs[kname], err)
    check(ok, f"kernel {kname} {label}: differs from its plain version "
              f"(max abs err {err:.3g})")
    log(f"kernel {kname} {label}: n={got.shape[-1]} "
        f"{'bit-identical' if exact else f'rtol {REAL_RTOL}'} ok={ok} "
        f"max_abs_err={err:.3g}")


def kernel_vs_plain(K, SR, plans, dev):
    """Every kernel on the main path's layouts against its plain
    version.  Returns {kernel: max abs error}."""
    from repro_torch.kernels.spmv_bell import column_mask

    gen = torch.Generator().manual_seed(0)
    errs: dict = {}
    fd_pr, dia_pr = plans[("fd", "pagerank")], plans[("dia", "pagerank")]

    # DIA: plus-times only; FD 2^16 and the RCM'd band
    dias = [(f"fd2^{dia_pr.n_cols.bit_length() - 1}", dia_pr.prep)]
    if ("reorder", "dia") in plans:
        dias.append(("rcm band", plans[("reorder", "dia")].prep))
    for label, p in dias:
        n = p.n_cols
        for kind in ("int", "real"):
            band = int_values(p.band, "plus_times", gen) if kind == "int" \
                else p.band
            x = x_for("plus_times", n, gen, dev, kind)
            compare(errs, "spmv_dia", f"{label} 2^{n.bit_length() - 1} {kind}",
                    K.spmv_dia(band, p.offsets, x, n),
                    K.spmv_dia_plain(band, p.offsets, x, n), exact=True)

    # BELL: plus-times only; its plain version repeats the kernel's order,
    # so real values are held bit for bit too
    for label, key in (("blocked pagerank", ("bell", "pagerank")),
                       ("blocked adjacency per-call", ("bell", "percall"))):
        if key not in plans:
            continue
        p = plans[key].prep
        for kind in ("int", "real"):
            q = dataclasses.replace(p, values=int_values(
                p.values, "plus_times", gen)) if kind == "int" else p
            x = x_for("plus_times", p.n_cols, gen, dev, kind)
            compare(errs, "spmv_bell", f"{label} {kind}",
                    K.spmv_bell(q, x), K.spmv_bell_plain(q, x), exact=True)
    nan_cases = []
    if ("bell", "small") in plans:
        x = torch.ones(plans[("bell", "small")].n_cols, device=dev)
        x[3] = float("inf")
        nan_cases.append(("blocked 2^10, inf in the first tile",
                          plans[("bell", "small")].prep, x))
    if ("bell", "pagerank") in plans:
        # inf in columns the transposed tiles' blocks drop: NaN over every
        # row of those blocks, from the dropped-column check alone
        p = plans[("bell", "pagerank")].prep
        kept = column_mask(p.masks[:64])
        x = x_for("plus_times", p.n_cols, gen, dev, "real")
        for b in range(0, 64, 16):
            col = int(p.block_cols[b]) * 128 + \
                int(torch.nonzero(~kept[b])[0])
            x[col] = float("inf")
        nan_cases.append(("blocked pagerank, inf in dropped columns", p, x))
    for label, p, x in nan_cases:
        got, want = K.spmv_bell(p, x), K.spmv_bell_plain(p, x)
        nan = torch.isnan(want)
        same = torch.equal(torch.isnan(got), nan) and bool(nan.any()) and \
            torch.equal(got[~nan], want[~nan])
        check(same, f"kernel spmv_bell {label}: NaN rows differ from its "
              "plain version's")
        log(f"kernel spmv_bell {label}: nan rows {int(torch.isnan(got).sum())}"
            f" of {got.shape[0]}, same as plain: {same}")

    # padded CSR: the FD PageRank layout under every semiring
    p = fd_pr.prep
    for sr_name in SR:
        for kind in (("int", "real") if sr_name == "plus_times"
                     else ("int",)):
            vals = p.vals if kind == "real" else \
                int_values(p.vals, sr_name, gen)
            x = x_for(sr_name, p.n_cols, gen, dev, kind)
            args = (vals, p.cols, p.rowptr, x, p.n_rows, SR[sr_name])
            compare(errs, "spmv_csr", f"fd pagerank {sr_name} {kind}",
                    K.spmv_csr(*args), K.spmv_csr_plain(*args),
                    exact=kind == "int")

    # ELL: FD's semiring layouts and every R-MAT light slab
    ell_cases = [(("fd", a), plans[("fd", a)].prep) for a in
                 ("bfs", "sssp", "connected_components")]
    ell_cases += [(("rmat", a), plans[("rmat", a)].prep.light)
                  for a in ANALYTICS]
    for (fam, a), lp in ell_cases:
        sr_name = plans[(fam, a)].semiring
        kinds = ("int", "real") if sr_name == "plus_times" else ("real",)
        for kind in kinds:
            data = int_values(lp.data, sr_name, gen) if kind == "int" \
                else lp.data
            x = x_for(sr_name, lp.n_cols, gen, dev, kind)
            args = (data, lp.idx, x, SR[sr_name])
            compare(errs, "spmv_ell", f"{fam} {a} {sr_name} {kind}",
                    K.spmv_ell(*args), K.spmv_ell_plain(*args),
                    exact=kind == "int" or sr_name != "plus_times")
    lp = plans[("fd", "bfs")].prep
    data = int_values(lp.data, "max_times", gen)
    x = x_for("max_times", lp.n_cols, gen, dev)
    args = (data, lp.idx, x, SR["max_times"])
    compare(errs, "spmv_ell", "fd bfs max_times int", K.spmv_ell(*args),
            K.spmv_ell_plain(*args), exact=True)

    # segmented CSR: every R-MAT heavy stream, joined with a base
    for a in ANALYTICS:
        hp = plans[("rmat", a)].prep.heavy
        sr_name = plans[("rmat", a)].semiring
        cases = [(sr_name, "int"), (sr_name, "real")] \
            if sr_name == "plus_times" else [(sr_name, "real")]
        if a == "pagerank":
            cases.append(("max_times", "int"))
        for name, kind in cases:
            vals = int_values(hp.vals, name, gen) if kind == "int" \
                else hp.vals
            x = x_for(name, hp.n_cols, gen, dev, kind)
            base = x_for(name, hp.n_rows, gen, dev, kind)
            args = (dataclasses.replace(hp, vals=vals), x, SR[name])
            compare(errs, "spmv_csr_seg", f"rmat {a} {name} {kind}",
                    K.spmv_csr_seg(*args, base=base),
                    K.spmv_csr_seg_plain(*args, base=base),
                    exact=kind == "int" or name != "plus_times")

    # batched ELL: FD's semiring layouts and the R-MAT PageRank light slab
    # at k = 4 against the plain version, and each layout at k = 64
    # against the single-vector kernel row by row, bit for bit
    for (fam, a), lp in ell_cases[:4]:
        sr_name = plans[(fam, a)].semiring
        kinds = ("int", "real") if sr_name == "plus_times" else ("real",)
        for kind in kinds:
            data = int_values(lp.data, sr_name, gen) if kind == "int" \
                else lp.data
            X = torch.stack([x_for(sr_name, lp.n_cols, gen, dev, kind)
                             for _ in range(4)])
            args = (data, lp.idx, X, SR[sr_name])
            compare(errs, "spmm_ell", f"{fam} {a} {sr_name} {kind} k=4",
                    K.spmm_ell(*args), K.spmv_ell_plain(*args),
                    exact=kind == "int" or sr_name != "plus_times")
        X = batch_x(sr_name, 64, lp.n_cols, 3, dev)
        rows = [K.spmv_ell(lp.data, lp.idx, X[c], SR[sr_name])
                for c in range(64)]
        batch_vs_rows(
            "spmm_ell", f"{fam} {a} {sr_name} k=64 (gather "
            f"{slab_gather(lp, SR[sr_name])})",
            K.spmm_ell(lp.data, lp.idx, X, SR[sr_name]), rows)
        if fam == "fd":             # the other layout on the same slab
            batch_vs_rows(
                "spmm_ell", f"{fam} {a} {sr_name} k=64 (gather xt, forced)",
                K.spmm_ell(lp.data, lp.idx, X, SR[sr_name], _gather="xt"),
                rows)

    # batched segmented CSR: the R-MAT PageRank (plus_times, max_times)
    # and SSSP (min_plus) heavy streams with a (k, n) base at k = 4
    # against the plain version; at k = 64 against the single-vector
    # kernel row by row, bit for bit
    for a, name, kind in (("pagerank", "plus_times", "int"),
                          ("pagerank", "plus_times", "real"),
                          ("pagerank", "max_times", "int"),
                          ("sssp", "min_plus", "real")):
        hp = plans[("rmat", a)].prep.heavy
        vals = int_values(hp.vals, name, gen) if kind == "int" else hp.vals
        q = dataclasses.replace(hp, vals=vals)
        X = torch.stack([x_for(name, hp.n_cols, gen, dev, kind)
                         for _ in range(4)])
        base = torch.stack([x_for(name, hp.n_rows, gen, dev, kind)
                            for _ in range(4)])
        compare(errs, "spmm_csr_seg", f"rmat {a} {name} {kind} k=4",
                K.spmm_csr_seg(q, X, SR[name], base=base),
                K.spmv_csr_seg_plain(q, X, SR[name], base=base),
                exact=kind == "int" or name != "plus_times")
    for a in ("pagerank", "sssp"):
        hp, sr_name = plans[("rmat", a)].prep.heavy, plans[("rmat", a)].semiring
        X = batch_x(sr_name, 64, hp.n_cols, 4, dev)
        base = batch_x(sr_name, 64, hp.n_rows, 6, dev)
        batch_vs_rows(
            "spmm_csr_seg", f"rmat {a} {sr_name} k=64",
            K.spmm_csr_seg(hp, X, SR[sr_name], base=base),
            [K.spmv_csr_seg(hp, X[c], SR[sr_name], base=base[c])
             for c in range(64)])

    # both batched kernels at the widths the serving engine pads its lanes
    # to, against the plain versions (computed 16 columns at a time: at
    # k = 64 their temporaries do not fit beside the main path's plans):
    # R-MAT's light slab (the Xt kernel) and heavy stream with a (k, n)
    # base (the lanes kernel, G = 4 and 16 lanes a virtual thread)
    for k in (16, 64):
        for a, name, kind in (("pagerank", "plus_times", "int"),
                              ("pagerank", "plus_times", "real"),
                              ("pagerank", "max_times", "int"),
                              ("sssp", "min_plus", "real")):
            prep, sr = plans[("rmat", a)].prep, SR[name]
            exact = kind == "int" or name != "plus_times"
            seed = 1000 * k + len(errs)
            lp, hp = prep.light, prep.heavy
            data = int_values(lp.data, name, gen) if kind == "int" \
                else lp.data
            X = batch_for(name, k, lp.n_cols, seed, dev, kind)
            compare(errs, "spmm_ell", f"rmat {a} light {name} {kind} k={k} "
                    f"(gather {slab_gather(lp, sr)})",
                    K.spmm_ell(data, lp.idx, X, sr),
                    plain_in_chunks(lambda Xc, _: K.spmv_ell_plain(
                        data, lp.idx, Xc, sr), X), exact)
            vals = int_values(hp.vals, name, gen) if kind == "int" \
                else hp.vals
            q = dataclasses.replace(hp, vals=vals)
            base = batch_for(name, k, hp.n_rows, seed + 1, dev, kind)
            compare(errs, "spmm_csr_seg", f"rmat {a} {name} {kind} k={k}",
                    K.spmm_csr_seg(q, X, sr, base=base),
                    plain_in_chunks(lambda Xc, bc: K.spmv_csr_seg_plain(
                        q, Xc, sr, base=bc), X, base), exact)
            del X, base, data, vals, q
    return errs


def batch_for(sr_name, k, n, seed, dev, kind="int"):
    """`x_for`'s values for a (k, n) batch, drawn on the device."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(lo, hi):
        return torch.randint(lo, hi, (k, n), generator=g, device=dev).float()
    if sr_name == "plus_times":
        return ints(-8, 9) if kind == "int" else \
            torch.rand((k, n), generator=g, device=dev)
    if sr_name == "or_and":
        return ints(0, 2)
    if sr_name == "max_times":
        return ints(0, 9)
    X = torch.rand((k, n), generator=g, device=dev) * 100
    X[torch.rand((k, n), generator=g, device=dev) < 0.1] = float("inf")
    return X


def plain_in_chunks(fn, X, base=None, chunk=16):
    """A batched plain version `fn(X_chunk, base_chunk)` over a (k, n)
    batch, `chunk` columns at a time; each column is computed alone, so
    the chunks make the whole."""
    return torch.cat([fn(X[c:c + chunk],
                         None if base is None else base[c:c + chunk])
                      for c in range(0, X.shape[0], chunk)])


def batch_vs_rows(kname, label, got, rows) -> None:
    """A batched kernel's (k, n) result against the single-vector
    kernel's rows, bit for bit."""
    ok = same_bits(got, torch.stack(rows))
    check(ok, f"kernel {kname} {label}: differs from the single-vector "
              "kernel's rows")
    log(f"kernel {kname} {label}: rows == single-vector kernel bit for "
        f"bit: {ok}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int, dev) -> float:
    for _ in range(3):
        fn()
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def trace_ms(fn, reps: int, dev, kernels=None) -> dict:
    """Device time of each named CUDA kernel per `fn()` call, from a
    torch.profiler trace of `reps` calls: {name: ms, or None when the
    trace holds no device time for it (and on the CPU)}.  The name "all"
    (kernels=None gives {"all": ms}) sums every kernel and copy.  A
    kernel the trace holds fewer than `reps` launches of (the profiler
    drops records) counts as one launch a call at its mean over the
    launches recorded."""
    names = ["all"] if kernels is None else list(kernels)
    if dev.type != "cuda":
        return dict.fromkeys(names)
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(names, 0.0)
    for key, (count, t) in device_records(prof).items():
        per_call = t / (reps if count >= reps else count)
        for name in names:
            if name == "all" or name in key:
                us[name] += per_call
    return {name: (t / 1e3 if t > 0 else None) for name, t in us.items()}


def device_records(prof) -> dict:
    """{kernel or copy: (records, device µs)} of a torch.profiler trace;
    host-side entries, which hold no device time, are left out."""
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0 and ev.count:
            out[ev.key] = (ev.count, t)
    return out


def sparse_csr(rows, cols, vals, n_rows, n_cols):
    coo = torch.sparse_coo_tensor(torch.stack([rows.long(), cols.long()]),
                                  vals, (n_rows, n_cols))
    return coo.coalesce().to_sparse_csr()


def layout_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def timings(K, SR, plans, dev, reps, adjacency=None):
    """{kernel: dict(ms, plain_ms, library_ms, bound_ms, shape, pad)};
    `adjacency`: the blocked graph's CSR, of which the per-call BELL plan
    holds the blocks."""
    gen = torch.Generator().manual_seed(1)
    out = {}

    def entry(name, kern, plain, lib, need_bytes, ops, nnz, n, tensors,
              label, key=None):
        """`need_bytes`: what this kernel's function must move, each input
        read once and each output written once; `ops`: its ⊗ and ⊕."""
        unpadded = 8 * nnz + 4 * (n + 1)
        bytes_ms = 1e3 * need_bytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * ops / F32_OPS_PER_S
        bound = max(bytes_ms, ops_ms)
        # the uniform yardstick: 8 nnz + 12 n bytes of the unpadded CSR
        csr_bound = 1e3 * (8 * nnz + 12 * n) / HBM_BYTES_PER_S
        ms = time_ms(kern, reps, dev)
        plain_ms = time_ms(plain, max(reps // 10, 2), dev) \
            if plain is not None else None
        lib_ms = time_ms(lib, reps, dev) if lib is not None else None
        out[key or name] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
            bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        plain_txt = "not measured" if plain_ms is None else f"{plain_ms:.4f}"
        log(f"time {name} [{label}]: n={n} nnz={nnz} kernel_ms={ms:.4f} "
            f"plain_ms={plain_txt} library_ms="
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"bound_bytes={need_bytes} bound_ms={bound:.4f} "
            f"({ms / bound:.2f}x bound) csr_bound_ms={csr_bound:.4f} "
            f"layout/unpadded_csr_bytes="
            f"{layout_bytes(*tensors) / unpadded:.3f}")

    pt = SR["plus_times"]
    # DIA: the RCM'd 2^22 band (the JSON entry) and FD 2^16 PageRank
    for key, label in ((("reorder", "dia"), "rcm band"),
                       (("dia", "pagerank"), "fd pagerank")):
        if key not in plans:
            continue
        plan = plans[key]
        p, c = plan.prep, plan.csr
        x = torch.rand(p.n_cols, generator=gen).to(dev)
        A = sparse_csr(*_coo(c), c.n_rows, c.n_cols)
        D = p.band.shape[0]
        dkey = "spmv_dia" if "spmv_dia" not in out else f"spmv_dia {label}"
        entry("spmv_dia",
              lambda: K.spmv_dia(p.band, p.offsets, x, p.n_cols),
              lambda: K.spmv_dia_plain(p.band, p.offsets, x, p.n_cols),
              lambda: A @ x, layout_bytes(p.band, p.offsets) + 4 * p.n_cols
              + 4 * p.n_rows, 2 * D * p.n_rows, c.nnz, c.n_rows,
              (p.band, p.offsets), f"{label}, plus_times, {D} diagonals",
              dkey)
        # the device time alone, from a trace: at FD 2^16 the events
        # above measure the host's dispatch as much as the kernel
        kt = trace_ms(lambda: K.spmv_dia(p.band, p.offsets, x, p.n_cols),
                      reps, dev, ["spmv_dia_kernel"])["spmv_dia_kernel"]
        lt = trace_ms(lambda: A @ x, reps, dev)["all"]
        out[dkey].update(traced_ms=kt, library_traced_ms=lt)
        log(f"time spmv_dia [{label}] traced: kernel_ms="
            + ("not measured" if kt is None else f"{kt:.4f}")
            + " library_ms (torch.sparse's kernels)="
            + ("not measured" if lt is None else f"{lt:.4f}"))

    # BELL: each real block's kept columns (4 bm k bytes), its mask, value
    # offset and block column, the block row pointers and pad flags, x, y;
    # timed on the blocked PageRank layout (the JSON entry: transposed
    # tiles, 8 kept columns a block) and on the per-call layout of the
    # blocked adjacency (dense tiles, all 128 kept)
    for key, name, label in ((("bell", "pagerank"), "spmv_bell",
                              "blocked pagerank"),
                             (("bell", "percall"), "spmv_bell per-call",
                              "blocked adjacency per-call")):
        if key not in plans:
            continue
        plan = plans[key]
        p, bell = plan.prep, plan.container
        # the per-call plan holds no CSR: its blocks came from `adjacency`
        c = plan.csr if plan.csr is not None else adjacency
        nb = p.masks.shape[0]
        x = torch.rand(p.n_cols, generator=gen).to(dev)
        A = sparse_csr(*_coo(c), c.n_rows, c.n_cols)
        nnz = c.nnz
        io = 4 * p.n_cols + 4 * p.n_rows
        tensors = (p.values, p.val_ptr, p.masks, p.block_cols, p.block_ptr,
                   p.pad0)
        entry("spmv_bell", lambda p=p, x=x: K.spmv_bell(p, x),
              lambda p=p, x=x: K.spmv_bell_plain(p, x),
              lambda A=A, x=x: A @ x,
              layout_bytes(*tensors) + io, 2 * p.values.numel(), nnz,
              p.n_rows, tensors,
              f"{label}, {nb} real blocks of {p.bm}x128, "
              f"{p.values.numel() // max(nb * p.bm, 1)} kept columns a "
              f"block on average", name)
    if ("bell", "pagerank") in plans:
        bell = plans[("bell", "pagerank")].container
        bm = bell.bm
        io = 4 * bell.n_cols + 4 * bell.n_rows
        padded = 1e3 * (bell.storage_bytes() + io) / HBM_BYTES_PER_S
        out["spmv_bell"]["padded_bound_ms"] = padded
        log(f"time spmv_bell padded_bound_ms={padded:.4f} (the padded "
            f"({bell.data.shape[0]}, {bell.blocks_per_row}, {bm}, 128) "
            f"container, {bell.storage_bytes()} bytes, and x, y)")

    # ELL reads every slot of its (W, n) slab; timed under plus-times
    # (the R-MAT PageRank light slab's semiring), where torch.sparse
    # computes the same function, and under or_and (FD BFS)
    plan = plans[("fd", "bfs")]
    lp, c = plan.prep, plan.csr
    W = lp.data.shape[0]
    A = sparse_csr(*_coo(c), c.n_rows, c.n_cols)
    ell_bytes = layout_bytes(lp.data, lp.idx) + 4 * lp.n_cols + 4 * lp.n_rows
    for sr_name, key in (("plus_times", "spmv_ell"),
                         ("or_and", "spmv_ell or_and")):
        x = x_for(sr_name, lp.n_cols, gen, dev, "real")
        sr = SR[sr_name]
        entry("spmv_ell", lambda: K.spmv_ell(lp.data, lp.idx, x, sr),
              lambda: K.spmv_ell_plain(lp.data, lp.idx, x, sr),
              (lambda: A @ x) if sr_name == "plus_times" else None,
              ell_bytes, 2 * W * lp.n_rows, c.nnz, c.n_rows,
              (lp.data, lp.idx), f"fd bfs layout, {sr_name}, W={W}", key)

    # batched ELL at k = 4, 16 and 64 (the JSON entry) on the same layout
    # under plus-times: the slab once, X and Y once; torch.sparse.mm of
    # the CSR against the (n, k) block as the library call
    for k in (4, 16, 64):
        X = torch.rand((k, lp.n_cols), generator=gen).to(dev)
        Xn = X.t().contiguous()
        entry("spmm_ell", lambda: K.spmm_ell(lp.data, lp.idx, X, pt),
              lambda: K.spmv_ell_plain(lp.data, lp.idx, X, pt),
              lambda: torch.sparse.mm(A, Xn),
              layout_bytes(lp.data, lp.idx) + 4 * k * (lp.n_cols
                                                       + lp.n_rows),
              2 * k * W * lp.n_rows, c.nnz, c.n_rows, (lp.data, lp.idx),
              f"fd bfs layout, plus_times, W={W}, k={k}, gather "
              f"{slab_gather(lp, pt)}", None if k == 64 else
              f"spmm_ell k={k}")
        del X, Xn

    # R-MAT's light slab through the Xt kernel (timed by tools/spmm_ab.py):
    # its bounds from its shapes -- the slab, X and Y once; the gather
    # bound reads each real entry's row of the interleaved copy once
    plan = plans[("rmat", "pagerank")]
    lp = plan.prep.light
    hyb = plan.container            # PageRank weights are never 0
    light_nnz = int((hyb.data != hyb.fill).sum())
    slab = layout_bytes(lp.data, lp.idx)
    for k in (4, 16, 64):
        bound = 1e3 * (slab + 4 * k * (lp.n_cols + lp.n_rows)) \
            / HBM_BYTES_PER_S
        gather = 1e3 * (slab + 4 * k * (light_nnz + lp.n_rows)) \
            / HBM_BYTES_PER_S
        log(f"bound spmm_ell [rmat pagerank light slab, W="
            f"{lp.data.shape[0]}, k={k}, gather {slab_gather(lp, pt)}]: "
            f"n={lp.n_rows} nnz={light_nnz} slab_bytes={slab} bound_ms="
            f"{bound:.4f} (slab, X and Y once) gather_bound_ms={gather:.4f} "
            f"(slab, each real entry's Xt row and Y once)")

    # padded CSR: each row walks its own slots, so no padding slot is read
    plan = plans[("fd", "pagerank")]
    cp, c = plan.prep, plan.csr
    x = torch.rand(cp.n_cols, generator=gen).to(dev)
    A = sparse_csr(*_coo(c), c.n_rows, c.n_cols)
    args = (cp.vals, cp.cols, cp.rowptr, x, cp.n_rows, pt)
    entry("spmv_csr", lambda: K.spmv_csr(*args),
          lambda: K.spmv_csr_plain(*args), lambda: A @ x,
          8 * c.nnz + layout_bytes(cp.rowptr) + 4 * cp.n_cols
          + 4 * cp.n_rows, 2 * c.nnz, c.nnz, c.n_rows,
          (cp.vals, cp.cols, cp.rowptr), "fd pagerank, plus_times")

    # segmented CSR: y = base ⊕ (heavy stream ⊗ x); x, the base and y
    plan = plans[("rmat", "pagerank")]
    hp, hyb = plan.prep.heavy, plan.container
    x = torch.rand(hp.n_cols, generator=gen).to(dev)
    base = torch.rand(hp.n_rows, generator=gen).to(dev)
    A = sparse_csr(hyb.hrows, hyb.hcols, hyb.hvals, hyb.n_rows, hyb.n_cols)
    args = (hp, x, pt)
    n_win = hp.win_row.shape[0] - 1
    entry("spmv_csr_seg", lambda: K.spmv_csr_seg(*args, base=base),
          lambda: K.spmv_csr_seg_plain(*args, base=base), lambda: A @ x,
          8 * hyb.heavy_nnz + 4 * hp.n_cols + 8 * hp.n_rows,
          2 * hyb.heavy_nnz + hp.n_rows, hyb.heavy_nnz, hp.n_rows,
          (hp.vals, hp.cols, hp.row_ptr, hp.win_row, hp.split_rows),
          f"rmat pagerank heavy stream, plus_times, {n_win} windows of "
          f"{hp.window} items, {hp.split_rows.shape[0]} split rows")
    # each pass's device time in the real launch -- the windows
    # (products, in-window folds, y and the carries) and the split rows'
    # carry folds -- from a trace of the kernel's calls
    passes = {"spmv_seg_window_kernel": "pass 1 (windows)",
              "spmv_seg_split_kernel": "pass 2 (split rows)"}
    traced = trace_ms(lambda: K.spmv_csr_seg(*args, base=base), reps, dev,
                      passes)
    both = sum(t or 0.0 for t in traced.values())
    for kname, what in passes.items():
        t = traced[kname]
        log(f"time spmv_csr_seg {what}, traced: kernel_ms="
            + ("not measured (no device time in the trace)" if t is None
               else f"{t:.4f} ({100 * t / both:.1f}% of both passes' "
                    f"{both:.4f})"))
    out["spmv_csr_seg"].update(
        pass1_ms=traced["spmv_seg_window_kernel"],
        pass2_ms=traced["spmv_seg_split_kernel"])
    # the same kernel on the same stream with every column index 0: each
    # x gather then hits one cached line, so the gap to the real time is
    # what the random gathers of x cost
    probe = dataclasses.replace(hp, cols=torch.zeros_like(hp.cols))
    probe_ms = time_ms(lambda: K.spmv_csr_seg(probe, x, pt, base=base), reps,
                       dev)
    log(f"time spmv_csr_seg gather probe (every column 0): kernel_ms="
        f"{probe_ms:.4f}, {probe_ms / out['spmv_csr_seg']['ms']:.3f} of the "
        f"real stream's")
    del probe

    # batched segmented CSR at k = 4 (the JSON entry), 16 and 64 on the
    # same stream: the stream once, X, the (k, n) base and Y once; the
    # gather bound reads each gathered Xt row once instead of X once; the
    # library call is torch.sparse.mm against the (n, k) block at k = 4
    # and, from k = 16, torch.addmm of the (n, k) base and that product;
    # each pass's device time traced
    passes = {"spmm_seg_window_kernel": "pass 1 (windows, k <= 4)",
              "spmm_seg_lanes_kernel": "pass 1 (windows, lanes)",
              "spmm_seg_split_kernel": "pass 2 (split rows)"}
    for k in (4, 16, 64):
        X = torch.rand((k, hp.n_cols), generator=gen).to(dev)
        B = torch.rand((k, hp.n_rows), generator=gen).to(dev)
        Xn, Bn = X.t().contiguous(), B.t().contiguous()
        key = "spmm_csr_seg" if k == 4 else f"spmm_csr_seg k={k}"
        nnz = hyb.heavy_nnz
        # the plain version holds about four (k, nnz) float32 temporaries
        plain = lambda: K.spmv_csr_seg_plain(hp, X, pt, base=B)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if dev.type == "cuda" and torch.cuda.mem_get_info(dev)[0] \
                < 5 * 4 * k * nnz:
            plain = None
            log(f"time spmm_csr_seg k={k}: plain version not measured "
                f"(less free device memory than its temporaries need)")
        entry("spmm_csr_seg", lambda: K.spmm_csr_seg(hp, X, pt, base=B),
              plain,
              (lambda: torch.sparse.mm(A, Xn)) if k == 4
              else (lambda: torch.addmm(Bn, A, Xn)),
              8 * nnz + 4 * k * hp.n_cols + 8 * k * hp.n_rows,
              k * (2 * nnz + hp.n_rows), nnz, hp.n_rows,
              (hp.vals, hp.cols, hp.row_ptr, hp.win_row, hp.split_rows),
              f"rmat pagerank heavy stream, plus_times, k={k}", key)
        gather_bound = 1e3 * (8 * nnz + 4 * k * nnz + 8 * k * hp.n_rows) \
            / HBM_BYTES_PER_S
        Xt = K.interleave_columns(X)         # the kernel alone, xt given
        alone = time_ms(lambda: K.spmm_csr_seg(hp, X, pt, base=B, xt=Xt),
                        reps, dev)
        traced = trace_ms(lambda: K.spmm_csr_seg(hp, X, pt, base=B), reps,
                          dev, passes)
        out[key].update(gather_bound_ms=gather_bound, alone_ms=alone,
                        pass1_ms=traced["spmm_seg_window_kernel"]
                        or traced["spmm_seg_lanes_kernel"],
                        pass2_ms=traced["spmm_seg_split_kernel"])
        log(f"time spmm_csr_seg k={k}: kernel_ms={out[key]['ms']:.4f} with "
            f"the wrapper's interleaved copy, {alone:.4f} given the copy; "
            f"gather_bound_ms={gather_bound:.4f} (8 nnz + 4 k nnz + 8 k "
            f"n_rows bytes: each gathered Xt row read once; "
            f"{alone / gather_bound:.2f}x given the copy) library: "
            + ("torch.sparse.mm of the CSR, (n, k) block" if k == 4 else
               "torch.addmm of the (n, k) base and the CSR @ (n, k) block"))
        for kname, what in passes.items():
            t = traced[kname]
            if t is not None or dev.type != "cuda":
                log(f"time spmm_csr_seg k={k} {what}, traced: kernel_ms="
                    + ("not measured" if t is None else f"{t:.4f}"))
        del X, B, Xn, Bn, Xt
    return out


# ---------------------------------------------------------------------------
# serve: the analytics serving engine over the main path's plans
# ---------------------------------------------------------------------------

SERVE_REQUESTS, SERVE_PER_STEP = 32, 4
SERVE_SEED = 11                     # the random requests' generator
SERVE_LANES, SERVE_PEAK_LANES = 64, 96
M1_RATE, M3_RATE = 0.001, 0.005     # inserts, as a fraction of nnz
M2_DELETES_2_22 = 1024              # deletes at 2^22 rows, scaled by n
MUTATION_STEPS = {"M1": 3, "M2": 6, "M3": 10}
#: the engine steps traced for device time and idle share, after the
#: mutations and their re-plans: while the R-MAT requests still run
#: beside FD's, and in FD's tail (its BFS / SSSP / CC run to step ~1,100)
SERVE_TRACE_STEPS = ((21, 120), (501, 600))
#: the lifecycle the phase predicts for the R-MAT lineages (PERF.md §5)
PREDICTED_ACTIONS = {
    "M1": dict.fromkeys(ANALYTICS, "overlay"),
    "M2": {"pagerank": "overlay", "bfs": "replan", "sssp": "replan",
           "connected_components": "replan"},
    "M3": {"pagerank": "replan", "bfs": "overlay", "sssp": "overlay",
           "connected_components": "overlay"},
}
PREDICTED_COUNTERS = {"overlays": 8, "swaps": 4, "delta_recompiles": 4}


def serve_requests(SG, adjs):
    """{arrival step: [AnalyticRequest]}: first the main path's eight
    driver calls (same sources, tol, r0 and FD cap), then requests drawn
    from `SERVE_SEED` over both graphs and the four analytics, with 1-8
    sources each (connected components takes none: one lane), four
    arriving a step."""
    reqs = []
    for fam in ("fd", "rmat"):
        adj = adjs[fam]
        src = int(np.argmax(adj.row_lengths()))
        r0 = np.random.default_rng(7).uniform(0.5, 1.5, adj.n_rows) \
            .astype(np.float32)
        for name in ANALYTICS:
            reqs.append(SG.AnalyticRequest(
                len(reqs), fam, name,
                sources=(src,) if name in ("bfs", "sssp") else (),
                params={"tol": PR_TOL, "r0": r0} if name == "pagerank"
                else {},
                max_iters=FD_CAP if fam == "fd" and name != "pagerank"
                else None))
    rng = np.random.default_rng(SERVE_SEED)
    while len(reqs) < SERVE_REQUESTS:
        fam = ("fd", "rmat")[int(rng.integers(2))]
        name = ANALYTICS[int(rng.integers(len(ANALYTICS)))]
        k = int(rng.integers(1, 9))
        srcs = tuple(int(s) for s in rng.integers(0, adjs[fam].n_rows, k))
        reqs.append(SG.AnalyticRequest(
            len(reqs), fam, name,
            sources=() if name == "connected_components" else srcs,
            params={"tol": PR_TOL} if name == "pagerank" else {},
            max_iters=FD_CAP if fam == "fd" and name != "pagerank"
            else None))
    out = {}
    for i, r in enumerate(reqs):
        out.setdefault(1 + i // SERVE_PER_STEP, []).append(r)
    return out


def insert_batch(D, adj, k, rng):
    """(k, 3) inserts: absent off-diagonal coordinates, rows and columns
    drawn uniformly, distinct, integer weights in [1, 8]."""
    n = adj.n_rows
    keys = np.zeros(0, np.int64)
    while keys.size < k:
        r = rng.integers(0, n, 2 * (k - keys.size) + 16)
        c = rng.integers(0, n, r.size)
        _, stored = D.csr_lookup(adj, r, c)
        new = (r * n + c)[(r != c) & ~stored]
        keys = np.concatenate([keys, new])
        _, first = np.unique(keys, return_index=True)
        keys = keys[np.sort(first)]
    keys = keys[:k]
    w = rng.integers(1, 9, k).astype(np.float64)
    return np.stack([keys // n, keys % n, w], axis=1).astype(np.float64)


def delete_batch(adj, k, rng):
    """(k, 2) deletes: k distinct rows drawn uniformly among the rows
    that store an edge, one stored edge of each drawn uniformly."""
    from repro_torch.device import to_numpy

    lens = adj.row_lengths()
    rows = rng.choice(np.flatnonzero(lens), size=k, replace=False)
    indptr = to_numpy(adj.indptr).astype(np.int64)
    cols = to_numpy(adj.indices)[indptr[rows] + rng.integers(0, lens[rows])]
    return np.stack([rows, cols.astype(np.int64)], axis=1)


def make_mutation(SG, D, tag, adj, rid, rng):
    n = adj.n_rows
    if tag == "M2":
        k = max(1, M2_DELETES_2_22 * n >> 22)
        return SG.GraphMutation(rid, "rmat", deletes=delete_batch(adj, k,
                                                                  rng))
    rate = M1_RATE if tag == "M1" else M3_RATE
    return SG.GraphMutation(rid, "rmat", inserts=insert_batch(
        D, adj, int(rate * adj.nnz), rng))


class StepTrace:
    """A torch.profiler trace of engine steps `first`..`last` on the
    card: the window's wall, its device time (every kernel and copy the
    trace records; one stream, so they do not overlap) split into the
    SpMV kernels, other kernels and copies, and the wrappers' launches
    counted in the window beside the records of their kernels, and the
    records that take the most device time outside the SpMV kernels."""

    def __init__(self, first: int, last: int):
        self.first, self.last = first, last
        self.result = None

    def start(self, eng) -> None:
        from torch.profiler import ProfilerActivity, profile

        from repro_torch import kernels as K

        torch.cuda.synchronize()
        self.launches = K.launch_counts()
        self.compiles = eng.plan_cache.stats()["compiles"]
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self, eng) -> None:
        from repro_torch import kernels as K

        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - self.t0)
        self.prof.stop()
        recs = device_records(self.prof)
        split = {"spmv": 0.0, "other": 0.0, "copies": 0.0}
        for key, (_, t) in recs.items():
            part = ("spmv" if is_spmv(key) else
                    "copies" if key.startswith(("Memcpy", "Memset"))
                    else "other")
            split[part] += t / 1e3
        now = K.launch_counts()
        device_ms = sum(split.values())
        self.result = dict(
            steps=self.last - self.first + 1, wall_ms=wall_ms,
            device_ms=device_ms, idle=1 - device_ms / wall_ms, split=split,
            launches={k: now[k] - self.launches[k] for k in now
                      if now[k] > self.launches[k]},
            spmv_records={short_kernel(k): [c, round(t / 1e3, 2)]
                          for k, (c, t) in recs.items() if is_spmv(k)},
            top_other=[(short_kernel(k), c, round(t / 1e3, 1))
                       for k, (c, t) in sorted(
                           recs.items(), key=lambda kv: -kv[1][1])
                       if not is_spmv(k)][:8],
            compiles=eng.plan_cache.stats()["compiles"] - self.compiles)
        del self.prof


def is_spmv(key: str) -> bool:
    """A trace record of one of the SpMV / SpMM kernels."""
    return "spmv_" in key or "spmm_" in key


def short_kernel(key: str) -> str:
    """A trace record's name without its parameter list."""
    if key.startswith(("Memcpy", "Memset")):
        return key
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return key.split("(")[0][:72]


def run_engine(SG, D, adjs, cache, dev, observe=None, traces=()):
    """Drive one engine over `serve_requests` and the three R-MAT
    mutations (each built on the adjacency it applies to and submitted
    before its step in `MUTATION_STEPS`); `observe(eng, tag)` runs after
    the step that applied a mutation, and each `StepTrace` of `traces`
    around its window of steps.  Returns the engine, the requests, the R-MAT
    adjacency of each generation, the mutation tags by request id, the
    peak lanes requested, the first wave's admission hit rate, the
    engine's wall seconds (building the batches, `observe` and reading
    the trace excluded) and the host seconds of each `step()`."""
    arrivals = serve_requests(SG, adjs)
    eng = SG.GraphEngine(SG.GraphEngineConfig(
        n_lanes=SERVE_LANES, compile_queue_cap=8, compiles_per_step=1,
        device=dev), plan_cache=cache)
    for fam, adj in adjs.items():
        eng.register_graph(fam, adj)
    rng = np.random.default_rng(SERVE_SEED + 1)
    at_step = {s: tag for tag, s in MUTATION_STEPS.items()}
    out = types.SimpleNamespace(eng=eng, reqs=[], tags={}, peak=0,
                                generations=[eng.graphs["rmat"]],
                                first_hit_rate=None, step_s=[])
    wall, aside = time.perf_counter(), 0.0
    while True:
        s = eng.step_count + 1
        for r in arrivals.get(s, ()):
            eng.submit(r)
            out.reqs.append(r)
        if s in at_step:
            t0 = time.perf_counter()
            rid = 100 + len(out.tags)
            out.tags[rid] = at_step[s]
            eng.submit(make_mutation(SG, D, at_step[s], eng.graphs["rmat"],
                                     rid, rng))
            aside += time.perf_counter() - t0
        if eng.idle and s > max(max(arrivals), max(at_step)):
            break
        applied = eng.mutations_applied
        for trace in traces:
            if s == trace.first:
                trace.start(eng)
        t0 = time.perf_counter()
        eng.step()
        out.step_s.append(time.perf_counter() - t0)
        for trace in traces:
            if s == trace.last:
                trace.stop(eng)     # stopping and reading it: aside
                aside += time.perf_counter() - trace.t0 - trace.result[
                    "wall_ms"] / 1e3
        out.peak = max(out.peak, sum(r.lanes for r in out.reqs
                                     if r.req_id not in eng.results))
        if s == 2:              # the first wave (the main path's calls)
            adm = eng.admission
            out.first_hit_rate = adm.warm_hits / max(
                adm.warm_hits + adm.cold_misses, 1)
        if eng.mutations_applied > applied:
            out.generations.append(eng.graphs["rmat"])
            if observe is not None:
                t0 = time.perf_counter()
                observe(eng, at_step[s])
                aside += time.perf_counter() - t0
    sync(dev)
    out.wall = time.perf_counter() - wall - aside
    return out


def iterate(drivers, plan, name, aux, sources, params, cap):
    """A request run alone from its cold start (no engine): the stepper
    over `plan`, every lane through `execute_many`."""
    st = drivers.make_stepper(name, plan, aux, sources=np.asarray(
        sources, np.int64), params=params)
    it = 0
    while it < cap and not st.done:
        st.advance(plan.execute_many(st.frontier()))
        it += 1
    return st.values(), it


def pagerank_l1(a, b) -> float:
    """The largest L1 distance between matching lanes of (k, n) or (n,)
    PageRank vectors."""
    d = np.abs(np.atleast_2d(a).astype(np.float64) - np.atleast_2d(b))
    return float(d.sum(axis=1).max())


def pagerank_close(a, b) -> bool:
    """Two PageRank runs on one graph to PR_TOL from different starts,
    lane by lane: finite, each lane of `a` summing to 1 within 1e-3, and
    within PR_L1 of each other in L1 (the bound the residual tolerance
    implies)."""
    sums = np.atleast_2d(a).sum(axis=1, dtype=np.float64)
    return bool(np.isfinite(a).all() and np.isfinite(b).all()
                and np.all(np.abs(sums - 1.0) < 1e-3)
                and pagerank_l1(a, b) <= PR_L1)


def pagerank_gap(a, b) -> str:
    """The L1 distance as a share of PR_L1, and the largest relative
    difference of one entry."""
    l1 = pagerank_l1(a, b)
    rel = np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))
    return f"l1={l1:.4g} ({l1 / PR_L1:.3f} of PR_L1) max_rel={rel:.3g}"


def check_served(drivers, run, kern, cache, dev):
    """Checks 1 and 2: each request against its answer run alone on the
    graph of the generation it finished in (mutations applied at or
    before its finishing step): a main-path repeat on an unmutated graph
    against `kern` (PageRank bit for bit, same iterations), any other
    cold from its sources on a plan of that generation's graph."""
    eng, generations = run.eng, run.generations
    applied = sorted(eng.mutation_results[m].applied_step for m in run.tags)
    plans, n_kern, n_cold, n_across, gaps = {}, 0, 0, 0, []
    for req in run.reqs:
        res = eng.results[req.req_id]
        g = sum(a <= res.finished_step for a in applied) \
            if req.graph_id == "rmat" else 0
        across = g > sum(a <= res.arrived_step for a in applied)
        n_across += across
        adj = generations[g] if req.graph_id == "rmat" else None
        label = (f"serve req {req.req_id} {req.graph_id} {req.analytic} "
                 f"lanes={req.lanes} gen={g} across={across}")
        if req.req_id < 2 * len(ANALYTICS) and g == 0:
            want = kern[req.graph_id][req.analytic][0]
            same = np.array_equal(res.values[0], want.values)
            check(same and res.n_iters == want.n_iters,
                  f"{label}: differs from the blocking driver (iters "
                  f"{res.n_iters} vs {want.n_iters})")
            n_kern += 1
            continue
        key = (req.graph_id, g, req.analytic)
        if key not in plans:
            graph = adj if adj is not None else eng.graphs[req.graph_id]
            m, sr, aux = drivers.analytic_operand(req.analytic, graph)
            plans[key] = (cache.get_or_compile(
                m, **drivers.plan_options(sr, device=dev)), aux)
        plan, aux = plans[key]
        params = {k: v for k, v in req.params.items() if k == "tol"}
        vals, its = iterate(drivers, plan, req.analytic, aux, req.sources,
                            params, req.max_iters or 256)
        if req.analytic == "pagerank" and g > 0:
            ok = pagerank_close(res.values, vals)
            gaps.append(f"req {req.req_id}: " +
                        pagerank_gap(res.values, vals))
        else:
            ok = np.array_equal(res.values, vals)
        check(ok, f"{label}: differs from its cold answer")
        n_cold += 1
    log(f"serve checks: {n_kern} repeats against the main path, {n_cold} "
        f"against cold runs ({len(plans)} plans), {n_across} ran across a "
        f"mutation")
    log(f"serve check 2 pagerank after a mutation, served vs cold "
        f"(PR_L1 {PR_L1:.4g}): " + "; ".join(gaps))


def overlay_exact(P, D, adj, dev, gen):
    """Check 3: overlays of an integer-valued copy of `adj` (values
    1 + i mod 7, `stream_bench._int_valued`'s scheme) against fresh
    compiles of their materialised matrices: plus-times with inserts
    and deletes (integer x, every sum exact), min_plus (+inf in x) and
    or_and on the pattern with inserts; `execute_many` rows equal
    `execute`, two calls bit-identical."""
    from repro_torch.core.formats import CSR

    rows, cols, _ = _coo(adj)
    n, nnz = adj.n_rows, adj.nnz
    maxlen = int(adj.row_lengths().max())
    check(maxlen * 7 * 3 < 2 ** 24, f"serve exact: rows of {maxlen} "
          "entries could leave float32's exact integers")
    vals = 1.0 + (torch.arange(nnz, device=dev) % 7).float()
    rng = np.random.default_rng(SERVE_SEED + 2)
    for sr in ("plus_times", "min_plus", "or_and"):
        t0 = time.perf_counter()
        m = CSR(data=vals if sr != "or_and" else torch.ones_like(vals),
                indices=adj.indices, indptr=adj.indptr, n_rows=n, n_cols=n)
        ins = insert_batch(D, m, int(M1_RATE * nnz), rng)
        if sr == "or_and":
            ins[:, 2] = 1.0
        dels = delete_batch(m, max(1, M2_DELETES_2_22 * n >> 22), rng) \
            if sr == "plus_times" else ()
        delta = D.EdgeDelta.from_updates(m, inserts=ins, deletes=dels)
        ov = P.overlay(P.compile(m, semiring=sr, reorder="none",
                                 predictor="none", device=dev), delta,
                       staleness_budget=1.0)
        fresh = P.compile(ov.materialize(), semiring=sr, reorder="none",
                          predictor="none", device=dev)
        X = x_for(sr, n, gen, dev) if sr != "plus_times" else \
            torch.randint(-3, 4, (n,), generator=gen).float().to(dev)
        X = torch.stack([X, X.roll(1), X.flip(0), X.roll(7)])
        y = ov.execute(X[0])
        Y = ov.execute_many(X)
        same = torch.equal(y, fresh.execute(X[0]))
        replay = torch.equal(ov.execute_many(X), Y)
        rows_ok = all(torch.equal(ov.execute(X[i]), Y[i]) for i in range(4))
        check(same and replay and rows_ok,
              f"serve exact {sr}: overlay == fresh compile {same}, "
              f"execute_many replay {replay}, rows == execute {rows_ok}")
        log(f"serve exact {sr} 2^{n.bit_length() - 1}: {delta.summary()} "
            f"fmt={ov.format_name}/{fresh.format_name} overlay == fresh "
            f"compile: {same}; execute_many replay bit-identical {replay}, "
            f"rows == execute {rows_ok}; inf={int(torch.isinf(y).sum())} "
            f"s={time.perf_counter() - t0:.1f}")
        del ov, fresh


def replay_small(SG, D, P, fd_matrix, rmat_matrix, log2n, dev):
    """Check 5: the same trace at 2^log2n, twice, each with a fresh plan
    cache: identical schedules, mutation actions and cache counters,
    bit-identical values."""
    n = 1 << log2n
    adjs = {"fd": fd_matrix(n, device=dev), "rmat": rmat_matrix(n, device=dev)}
    runs = []
    for _ in range(2):
        eng = run_engine(SG, D, adjs, P.PlanCache(max_plans=64), dev).eng
        stats = {k: v for k, v in eng.plan_cache.stats().items()
                 if k != "compile_s"}
        runs.append((eng.scheduler.log,
                     {m: r.actions for m, r in eng.mutation_results.items()},
                     stats,
                     {r: (v.values.tobytes(), v.n_iters)
                      for r, v in eng.results.items()}))
    a, b = runs
    same = [x == y for x, y in zip(a, b)]
    check(all(same), f"serve replay 2^{log2n}: schedule, actions, counters, "
          f"values identical {same}")
    log(f"serve replay 2^{log2n} x2: steps={len(a[0])} log events, "
        f"actions {a[1]}, counters {a[2]}, identical (log, actions, "
        f"counters, values) {same}")


def run_serve(args, dev, K, P, SG, D, drivers, fd_matrix, rmat_matrix,
              adjs, cache, kern, reps):
    """The serve phase: `GraphEngine` over the main path's graphs and
    plan cache with 32 requests and three R-MAT mutations, launch counts
    set to 0 just before and read just after; then checks 1-5 and the
    phase's times."""
    seen = {}

    def observe(eng, tag):
        """After each mutation: the R-MAT lineages' staleness and, after
        M1, the overlaid PageRank and SSSP plans with their aux."""
        stale = {}
        for name in ANALYTICS:
            st = eng._derived.get(("rmat", name))
            if st is not None:
                stale[name] = (0.0 if st.delta is None else
                               st.delta.nnz / max(st.base_matrix.nnz, 1))
        log(f"serve {tag} staleness " + " ".join(
            f"{k}={v:.5f}" for k, v in stale.items()))
        if tag == "M1":
            for name in ("pagerank", "sssp"):
                st = eng._derived[("rmat", name)]
                seen[name] = (cache.peek(st.key), st.aux)

    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    before = cache.stats()
    traces = [StepTrace(*w) for w in SERVE_TRACE_STEPS] \
        if dev.type == "cuda" else []
    K.reset_launch_counts()
    run = run_engine(SG, D, adjs, cache, dev, observe=observe,
                     traces=traces)
    counts = K.launch_counts()
    eng, tags, wall = run.eng, run.tags, run.wall
    log(f"serve launches {json.dumps(counts)}")
    if dev.type == "cuda":
        for k in ("spmm_ell", "spmv_csr", "spmm_csr_seg"):
            check(counts[k] > 0, f"serve path launched {k} no time")
    after = cache.stats()
    s = eng.stats()
    aside = sum(v["host_s"] for v in eng.mutation_seconds.values()) + \
        after["compile_s"] - before["compile_s"]
    log(f"serve engine: steps={s['steps']} requests={s['finished']}/"
        f"{s['submitted']} wall_s={wall:.2f} host_ms_per_step="
        f"{1e3 * wall / s['steps']:.3f} (without mutations and re-plans "
        f"{1e3 * (wall - aside) / s['steps']:.3f}) "
        f"spmm_calls={s['spmm_calls']} "
        f"lanes={s['lanes']} padded_lanes={s['padded_lanes']} "
        f"preemptions={s['preemptions']} max_running={s['max_running']} "
        f"peak_lanes_requested={run.peak} warm_hits={s['warm_hits']} "
        f"cold_misses={s['cold_misses']} backpressure={s['backpressure']} "
        f"admission_hit_rate={s['admission_hit_rate']:.4f} (first wave "
        f"{run.first_hit_rate:.4f})")
    ms = 1e3 * np.asarray(run.step_s)
    slow = np.argsort(-ms, kind="stable")[:12]
    log(f"serve engine step host ms: median={np.median(ms):.3f} "
        f"p90={np.quantile(ms, 0.9):.3f} steps 1-20 {ms[:20].sum():.1f} "
        f"(mutations and re-plans included), steps 21-{len(ms)} "
        f"{ms[20:].sum():.1f}; slowest (step, ms): "
        + str([(int(i) + 1, round(float(ms[i]), 1)) for i in slow]))
    if not traces:
        log("serve engine trace: not measured (no card)")
    for trace in traces:
        w = trace.result
        if w is None:
            log(f"serve engine trace steps {trace.first}-{trace.last}: not "
                f"measured (the engine stopped at step {s['steps']})")
            continue
        kernels_ms = w["split"]["spmv"] + w["split"]["other"]
        log(f"serve engine trace steps {trace.first}-{trace.last}: "
            f"wall_ms={w['wall_ms']:.1f} host_ms_per_step="
            f"{w['wall_ms'] / w['steps']:.3f} device_ms={w['device_ms']:.1f} "
            f"({w['device_ms'] / w['steps']:.4f} a step: spmv kernels "
            f"{w['split']['spmv']:.1f}, other kernels "
            f"{w['split']['other']:.1f}, copies {w['split']['copies']:.1f}) "
            f"busy_share={1 - w['idle']:.4f} idle_share={w['idle']:.4f} "
            f"(kernels alone {kernels_ms / w['wall_ms']:.4f}) "
            f"launches {json.dumps(w['launches'])} spmv kernel records "
            f"[records, ms] {json.dumps(w['spmv_records'])} "
            f"compiles={w['compiles']}; "
            f"most device time outside them (name, records, ms): "
            f"{w['top_other']}")
        check(w["split"]["spmv"] > 0, "serve engine trace holds no SpMV "
              "kernel time")
    check(run.first_hit_rate == 1.0,
          f"serve: first wave hit rate {run.first_hit_rate}, not 1.0")
    check(len(eng.results) == SERVE_REQUESTS, "serve: requests unfinished")
    check(run.peak >= SERVE_PEAK_LANES and s["preemptions"] >= 1,
          f"serve: peak lanes {run.peak}, preemptions {s['preemptions']}")
    # check 4: the predicted lifecycle
    delta = {k: after[k] - before[k] for k in after if k != "hit_rate"}
    for rid, tag in tags.items():
        mr = eng.mutation_results[rid]
        sec = eng.mutation_seconds[rid]
        log(f"serve {tag}: step={mr.applied_step} delta_nnz={mr.delta_nnz} "
            f"actions={mr.actions} " + " ".join(
                f"{k}={v:.3f}" for k, v in sec.items()))
        check(mr.actions == PREDICTED_ACTIONS[tag],
              f"serve {tag}: actions {mr.actions}, predicted "
              f"{PREDICTED_ACTIONS[tag]}")
    log(f"serve plan cache: " + " ".join(f"{k}={v}" for k, v in
                                          delta.items()))
    for k, v in PREDICTED_COUNTERS.items():
        check(delta[k] == v, f"serve cache {k}={delta[k]}, predicted {v}")
    replans = {}
    for name in ANALYTICS:
        plan = cache.peek(eng._derived[("rmat", name)].key)
        base = getattr(plan, "base", plan)
        replans[name] = compile_seconds(base)
    m1 = next(r for r, t in tags.items() if t == "M1")
    log(f"serve overlay vs re-plan: overlay()+install_overlay "
        f"{eng.mutation_seconds[m1]['overlay_s']:.3f} s for "
        f"{len(ANALYTICS)} lineages at M1; re-plan compile_s of the last "
        f"base per lineage " + " ".join(f"{k}={v:.2f}"
                                        for k, v in replans.items())
        + f"; cache compile_s in the phase {delta['compile_s']:.2f}")
    if dev.type == "cuda":
        log(f"serve peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    t0 = time.perf_counter()
    check_served(drivers, run, kern, cache, dev)
    log(f"serve checks 1-2 s={time.perf_counter() - t0:.1f}")

    # the delta pass against the base SpMV, and warm starts, after M1
    ov, aux = seen["pagerank"]
    x = torch.ones(ov.n_cols, device=dev)
    y = ov.base.execute(x)
    ov_ms, base_ms, pass_ms = (time_ms(fn, reps, dev) for fn in (
        lambda: ov.execute(x), lambda: ov.base.execute(x),
        lambda: ov.delta_pass(y, x)))
    # device time alone, from traces of each (the base by its kernels'
    # names as well as in all, the delta pass's kernels being PyTorch's)
    base_kernels = ("spmv_ell_kernel", "spmv_seg_window_kernel",
                    "spmv_seg_split_kernel")
    tb = trace_ms(lambda: ov.base.execute(x), reps, dev,
                  ("all",) + base_kernels)
    tp = trace_ms(lambda: ov.delta_pass(y, x), reps, dev)["all"]
    named = [tb[k] for k in base_kernels if tb[k] is not None]
    t_named = sum(named) if named else None

    def fmt(t):
        return "not measured" if t is None else f"{t:.4f}"

    log(f"serve delta pass rmat pagerank after M1 ({ov.delta.summary()}, "
        f"staleness {ov.staleness:.5f}): execute_ms={ov_ms:.4f} "
        f"base_execute_ms={base_ms:.4f} delta_pass_ms={pass_ms:.4f} "
        f"(CUDA events); traced delta_pass={fmt(tp)} base all={fmt(tb['all'])}"
        f" base by kernel name={fmt(t_named)} (" + " ".join(
            f"{k}={fmt(tb[k])}" for k in base_kernels) + ")")
    r0 = np.random.default_rng(7).uniform(0.5, 1.5, ov.n_rows) \
        .astype(np.float32)
    cold = iterate(drivers, ov, "pagerank", aux, (),
                   {"tol": PR_TOL, "r0": r0}, 256)
    warm = iterate(drivers, ov, "pagerank", aux, (),
                   {"tol": PR_TOL,
                    "r0": kern["rmat"]["pagerank"][0].values}, 256)
    check(pagerank_close(warm[0], cold[0]),
          "serve warm pagerank differs from cold")
    # the check's own test: the main path's answer on the graph before
    # M1 -- what the overlay gives with its delta pass dropped -- fails it
    dropped = kern["rmat"]["pagerank"][0].values
    check(not pagerank_close(dropped, cold[0][0]),
          "serve pagerank check passes the answer without the delta pass")
    log(f"serve pagerank check after M1 (PR_L1 {PR_L1:.4g}): warm vs cold "
        f"{pagerank_gap(warm[0], cold[0])}; delta pass dropped vs cold "
        f"{pagerank_gap(dropped, cold[0][0])} (must fail: "
        f"{not pagerank_close(dropped, cold[0][0])})")
    sp, sp_aux = seen["sssp"]
    src = int(np.argmax(adjs["rmat"].row_lengths()))
    scold = iterate(drivers, sp, "sssp", sp_aux, (src,), {}, 256)
    swarm = iterate(drivers, sp, "sssp", sp_aux, (src,),
                    {"d0": kern["rmat"]["sssp"][0].values[None]}, 256)
    check(np.array_equal(swarm[0], scold[0]),
          "serve warm sssp differs from cold")
    log(f"serve warm starts after M1: pagerank iters warm={warm[1]} "
        f"cold={cold[1]}; sssp iters warm={swarm[1]} cold={scold[1]} "
        f"(values equal)")
    del ov, sp
    seen.clear()

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(9)
    overlay_exact(P, D, adjs["rmat"], dev, gen)
    log(f"serve check 3 s={time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    replay_small(SG, D, P, fd_matrix, rmat_matrix, args.serve_replay_log2n,
                 dev)
    log(f"serve check 5 s={time.perf_counter() - t0:.1f}")
    return counts


# ---------------------------------------------------------------------------
# sweep: the paper's measurement grids through the sharded runner
# ---------------------------------------------------------------------------

def digest(points, encode) -> str:
    return hashlib.sha256(b"".join(encode(p) for p in points)).hexdigest()


def pinned(tag, got, want, full) -> None:
    """Check a digest against the reference's, at the pinned size."""
    if not full:
        log(f"sweep {tag}: sha256={got} (not pinned at this size)")
        return
    check(got == want, f"sweep {tag}: payload sha256 {got} is not the "
          f"reference's {want}")
    log(f"sweep {tag}: sha256={got} reference={want} equal={got == want}")


def iteration_digests(point) -> list:
    """sha256[:16] of each iteration's summary, as `iteration_runs` of
    `tools/reference_sweep.py` hashes them."""
    return [hashlib.sha256(json.dumps(s.as_dict(), sort_keys=True)
                           .encode()).hexdigest()[:16] for s in point.iters]


def graph_checks(tag, points, info, encode, full) -> dict:
    """Per graph cell: BFS / SSSP payloads must be the reference's bytes;
    a PageRank cell its format, nnz, semiring and convergence, and its
    per-iteration summaries the reference's for the iterations both ran,
    with both iteration counts printed (ROADMAP C3).  Returns the
    launches the pass's cells made, summed over the processes that ran
    them."""
    launches: dict = {}
    for p in points:
        key = f"{p.analytic}|{p.kind}"
        ck = next(k for k in info if k.startswith(f"graph|{p.kind}|")
                  and k.endswith(f"|{p.analytic}"))
        cinfo = info[ck]
        for k, v in cinfo["launches"].items():
            launches[k] = launches.get(k, 0) + v
        sha = hashlib.sha256(encode(p)).hexdigest()
        log(f"sweep {tag} {key}: format={p.format_name} n_iters={p.n_iters} "
            f"converged={p.converged} nnz={p.nnz} "
            f"driver_s={cinfo['driver_s']:.3f} "
            f"replay_s={cinfo['replay_s']:.3f} launches="
            + json.dumps({k: v for k, v in cinfo["launches"].items() if v}))
        if not full:
            continue
        ref = GRAPH_REFERENCE[tag][key]
        log(f"sweep {tag} {key}: reference format={ref[1]} "
            f"n_iters={ref[2]} converged={ref[3]} nnz={ref[4]}")
        check((p.format_name, p.converged, p.nnz, p.semiring)
              == (ref[1], ref[3], ref[4], ref[5]),
              f"sweep {tag} {key}: (format, converged, nnz, semiring) "
              f"{(p.format_name, p.converged, p.nnz, p.semiring)} are not "
              f"the reference's {ref[1], ref[3], ref[4], ref[5]}")
        if p.analytic != "pagerank":
            check(sha == ref[0], f"sweep {tag} {key}: payload sha256 {sha} "
                  f"is not the reference's {ref[0]}")
            continue
        want = [h for h, n in PAGERANK_ITERATION_RUNS[tag][key]
                for _ in range(n)]
        keep = min(len(want), p.n_iters)
        same = iteration_digests(p)[:keep] == want[:keep]
        check(keep > 0 and same, f"sweep {tag} {key}: the summaries of the "
              f"first {keep} iterations are not the reference's")
        log(f"sweep {tag} {key}: first {keep} iterations' summaries equal "
            f"the reference's: {same}")
    return launches


def graph_device_ms(sweep, tag, fmt, log2n, info, dev) -> None:
    """Each graph cell's driver run once more in this process under
    torch.profiler: its device time (every kernel and copy of one run
    to convergence) beside the host seconds of its driver and replay in
    the worker that ran the cell."""
    for kind in ("fd", "rmat"):
        for analytic in GRAPH_ANALYTICS:
            ck = next(k for k in info if k.startswith(f"graph|{kind}|")
                      and k.endswith(f"|{analytic}"))
            ms = trace_ms(lambda: sweep.run_graph_analytic(
                kind, log2n, analytic, max_iters=128, format=fmt,
                device=dev), 1, dev)["all"]
            log(f"sweep {tag} {analytic}|{kind}: driver device_ms="
                f"{'not measured' if ms is None else f'{ms:.4f}'} "
                f"driver_host_s={info[ck]['driver_s']:.3f} "
                f"replay_s={info[ck]['replay_s']:.3f}")


def graph_kernels_vs_plain(P, drivers, bases, fmt, dev, errs) -> None:
    """Each graph cell's plan through its kernels against its plain
    version on the same operand: plus-times on integer values, the
    semirings on their domains, bit for bit."""
    gen = torch.Generator().manual_seed(23)
    for kind, base in bases.items():
        for analytic in GRAPH_ANALYTICS:
            m, sr, _ = drivers.analytic_operand(analytic, base)
            plan = P.compile(m, **P.compile_kwargs(drivers.plan_options(
                sr, format=fmt, device=dev)))
            if plan.semiring == "plus_times":
                kern, plain = int_twin(P, plan, gen)
            else:
                kern = plan
                plain = dataclasses.replace(plan, prep=None, use_pallas=False)
            x = x_for(plan.semiring, m.n_cols, gen, dev)
            compare(errs, FORMAT_KERNELS[plan.format_name][-1],
                    f"sweep graph {kind} {analytic} {plan.format_name}",
                    kern.execute(x), plain.execute(x), exact=True)


def run_sweep_phase(args, dev, K, P, drivers, gens, errs) -> dict:
    """The reference benchmarks' grids on the card's host, the cells
    sharded over `workers` spawned processes (each with its own CUDA
    context, one pool for every grid); returns the graph passes'
    launches."""
    from repro_torch.telemetry import runner

    shift = args.sweep_shift
    full = shift == 0
    workers = max(1, min(8, os.cpu_count() or 1))
    with runner.shared_workers(workers):
        return sweep_grids(args, dev, K, P, drivers, gens, errs, workers,
                           full, shift)


def sweep_grids(args, dev, K, P, drivers, gens, errs, workers, full,
                shift) -> dict:
    from repro_torch.plan import costmodel
    from repro_torch.telemetry import report, runner, sweep
    from repro_torch.telemetry.hierarchy import HierarchySpec

    kw = dict(workers=workers, device=str(dev))
    enc = runner.encode_point
    log(f"sweep workers={workers} device={dev} log2n shift={shift}")
    t0 = time.perf_counter()
    head = sweep.run_sweep(log2ns=tuple(k - shift for k in (12, 14, 16)),
                           mechanisms={"baseline": HierarchySpec()}, **kw)
    log(f"sweep headline: cells={len(head)} "
        f"s={time.perf_counter() - t0:.1f}")
    pinned("headline", digest(head, enc), SWEEP_DIGESTS["headline"], full)
    t0 = time.perf_counter()
    mech = sweep.run_sweep(log2ns=(14 - shift,),
                           mechanisms=sweep.MECHANISMS, **kw)
    log(f"sweep mechanisms: cells={len(mech)} "
        f"s={time.perf_counter() - t0:.1f}")
    pinned("mechanisms", digest(mech, enc), SWEEP_DIGESTS["mechanisms"],
           full)
    t0 = time.perf_counter()
    scal = sweep.scaling_sweep(log2ns=(12 - shift,),
                               threads_list=(1, 2, 4, 8),
                               partition="balanced", **kw)
    log(f"sweep scaling: cells={len(scal)} "
        f"s={time.perf_counter() - t0:.1f}")
    pinned("scaling", digest(scal, enc), SWEEP_DIGESTS["scaling"], full)

    gkw = dict(log2ns=(12 - shift,), analytics=GRAPH_ANALYTICS,
               spec=HierarchySpec(**GRAPH_SPEC), max_iters=128, **kw)
    passes, launches = {}, {}
    for tag, fmt in (("graph", None), ("graph-csr", "csr")):
        info: dict = {}
        K.reset_launch_counts()
        t0 = time.perf_counter()
        passes[tag] = sweep.graph_sweep(format=fmt, cell_info=info, **gkw)
        log(f"sweep {tag}: cells={len(passes[tag])} "
            f"s={time.perf_counter() - t0:.1f}")
        counts = graph_checks(tag, passes[tag], info, enc, full)
        log(f"sweep {tag} launches {json.dumps(counts)}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        want = {"graph": ("spmv_dia", "spmv_ell", "spmv_csr_seg"),
                "graph-csr": ("spmv_csr",)}[tag]
        if dev.type == "cuda":
            for k in want:
                check(counts.get(k, 0) > 0,
                      f"sweep {tag} launched {k} no time")
        log(f"sweep {tag}: sha256={digest(passes[tag], enc)}")
        t0 = time.perf_counter()
        graph_device_ms(sweep, tag, fmt, 12 - shift, info, dev)
        log(f"sweep {tag} device traces s={time.perf_counter() - t0:.1f}")
    bases = {"fd": gens["fd"](1 << (12 - shift), device=dev),
             "rmat": gens["rmat"](1 << (12 - shift), device=dev)}
    for fmt in (None, "csr"):
        graph_kernels_vs_plain(P, drivers, bases, fmt, dev, errs)

    # interrupted at 5 cells (the runner's `max_cells`), then resumed
    # with workers
    with tempfile.TemporaryDirectory() as ck:
        t0 = time.perf_counter()
        first = runner.execute_cells(
            runner.graph_cells(gkw["log2ns"], ("fd", "rmat"),
                               GRAPH_ANALYTICS),
            runner.SweepConfig(hier_spec=gkw["spec"], max_iters=128,
                               device=str(dev)),
            workers=workers, ckpt_dir=ck, max_cells=5)
        rest = sweep.graph_sweep(ckpt_dir=ck, **gkw)
        same = [enc(p) for p in rest] == [enc(p) for p in passes["graph"]]
        check(len(first) == 5 and same, "sweep resume: the resumed graph "
              "grid is not byte-identical to the uninterrupted one")
        log(f"sweep resume: first={len(first)} resumed={len(rest)} "
            f"byte-identical={same} s={time.perf_counter() - t0:.1f}")

    t0 = time.perf_counter()
    rows = costmodel.harvest(seeds=(0,), workers=workers, device=str(dev))
    want = [r for r in costmodel.load_corpus(costmodel.DEFAULT_CORPUS)
            if r.seed == 0]
    canon = [json.dumps([dataclasses.asdict(r) for r in costmodel.sort_rows(
        rs)], sort_keys=True) for rs in (rows, want)]
    check(len(rows) == 240 and canon[0] == canon[1], "sweep harvest: the "
          "seed-0 labels are not the shipped corpus rows")
    log(f"sweep harvest: rows={len(rows)} corpus_seed0={len(want)} "
        f"equal={canon[0] == canon[1]} s={time.perf_counter() - t0:.1f}")
    rc = costmodel.main(["--check"])
    check(rc == 0, f"costmodel --check returned {rc}")
    log(f"sweep costmodel --check rc={rc}")
    log(report.gap_report(head))
    log(report.graph_gap_report(passes["graph"]))
    log(report.graph_gap_report(passes["graph-csr"]))
    log(report.scaling_gap_report(scal))
    return launches


# ---------------------------------------------------------------------------
# sharded: row-sharded ELL plans and plans through checkpoints
# ---------------------------------------------------------------------------

def sharded_check(tag, K, SR, sp, want, x, dev, reps, ell_ms) -> dict:
    """One sharded plan: launches of one execute, bit-identical to the
    CSR plan and to its slabs' plain versions; slab bytes, padding and
    per-slab kernel times."""
    prep = sp.prep
    K.reset_launch_counts()
    y = sp.execute(x)
    sync(dev)
    counts = K.launch_counts()
    slabs = prep.slabs(sp.mesh.devices)
    plain = torch.cat([K.spmv_ell_plain(d, i, x, SR["plus_times"])[
        : int(prep.starts[p + 1] - prep.starts[p])]
        for p, (d, i) in enumerate(slabs)])
    ok_csr, ok_plain = torch.equal(y, want), torch.equal(y, plain)
    check(ok_csr and ok_plain, f"sharded {tag}: not bit-identical to the "
          f"CSR plan ({ok_csr}) or its plain slabs ({ok_plain})")
    if dev.type == "cuda":
        check(counts["spmv_ell"] == prep.n_parts,
              f"sharded {tag}: {counts['spmv_ell']} spmv_ell launches for "
              f"{prep.n_parts} slabs")
    slots = prep.data.size
    slab_ms = [time_ms(lambda d=d, i=i: K.spmv_ell(d, i, x, SR["plus_times"]),
                       reps, dev) for d, i in slabs]
    log(f"sharded {tag}: parts={prep.n_parts} starts={prep.starts.tolist()} "
        f"slab={tuple(prep.data.shape[1:])} build_s="
        f"{sp.compile_stats['prepare_s']:.2f} slab_bytes={prep.nbytes()} "
        f"padding={slots / max(sp.csr.nnz if sp.csr is not None else 1, 1):.2f}"
        f" launches={counts['spmv_ell']} csr_equal={ok_csr} "
        f"plain_equal={ok_plain}")
    log(f"sharded {tag}: slab_ms={[round(t, 4) for t in slab_ms]} "
        f"sum_ms={sum(slab_ms):.4f} unsharded_ell_ms={ell_ms:.4f}")
    return counts


def run_sharded(args, dev, K, P, SR, fd_adj, hyb_plan, fd_matrix) -> dict:
    """`plan.compile(mesh=row_mesh([dev] * 4))` on the main path's FD
    matrix with integer values, then plans through `save_plan` /
    `load_plan`; returns the launches of the sharded executes."""
    from repro_torch.core.partition import rowblock_balanced
    from repro_torch.distributed import row_mesh

    gen = torch.Generator().manual_seed(31)
    fd = dataclasses.replace(fd_adj, data=int_values(fd_adj.data,
                                                     "plus_times", gen))
    x = x_for("plus_times", fd.n_cols, gen, dev)
    mesh = row_mesh([str(dev)] * SHARDS)
    kw = dict(reorder="none", predictor="none")
    want = P.compile(fd, format="csr", device=dev, **kw).execute(x)
    ell = P.compile(fd, format="ell", device=dev, **kw)
    ell_ms = time_ms(lambda: ell.execute(x), args.reps, dev)
    del ell
    launches = {}
    for tag, part in (("equal", None),
                      ("balanced", rowblock_balanced(fd, SHARDS))):
        t0 = time.perf_counter()
        sp = P.compile(fd, mesh=mesh, partition=part, **kw)
        sync(dev)
        log(f"sharded {tag}: compile_s={time.perf_counter() - t0:.2f}")
        check(sp.format_name == "ell-sharded",
              f"sharded {tag}: format {sp.format_name}")
        counts = sharded_check(tag, K, SR, sp, want, x, dev, args.reps,
                               ell_ms)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        del sp
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as d:
        xr = torch.rand(hyb_plan.n_cols, generator=gen).to(dev)
        y0 = hyb_plan.execute(xr)
        t0 = time.perf_counter()
        P.save_plan(hyb_plan, os.path.join(d, "hyb"))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, _ = P.load_plan(os.path.join(d, "hyb"), device=dev)
        sync(dev)
        load_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(d, "hyb").rglob("*")
                   if f.is_file())
        same = torch.equal(back.execute(xr), y0)
        check(back.format_name == hyb_plan.format_name and same,
              "sharded save/load: the reloaded "
              f"{hyb_plan.format_name} plan is not bit-identical")
        log(f"sharded save_plan {hyb_plan.format_name} n={hyb_plan.n_rows}: "
            f"save_s={save_s:.2f} load_s={load_s:.2f} bytes={size} "
            f"bit-identical={same}")

        small = fd_matrix(1 << args.dia_log2n, device=dev)
        sp = P.compile(small, mesh=mesh, **kw)
        xs = x_for("plus_times", small.n_cols, gen, dev)
        ys = sp.execute(xs)
        P.save_plan(sp, os.path.join(d, "sharded"))
        bare, _ = P.load_plan(os.path.join(d, "sharded"), device=dev)
        try:
            bare.execute(xs)
            refused = "no error"
        except ValueError as e:
            refused = str(e)
        want_msg = ("sharded plan has no mesh bound; pass mesh= to "
                    "load_plan or set plan.mesh")
        rebound, _ = P.load_plan(os.path.join(d, "sharded"), mesh=mesh)
        same = torch.equal(rebound.execute(xs), ys)
        check(refused == want_msg and same, "sharded save/load 2^"
              f"{args.dia_log2n}: refusal {refused!r}, rebound equal {same}")
        log(f"sharded save_plan ell-sharded 2^{args.dia_log2n}: without a "
            f"mesh raises {refused!r}; rebound with mesh= bit-identical="
            f"{same}")
    return launches


def _coo(csr):
    rows = torch.repeat_interleave(
        torch.arange(csr.n_rows, device=csr.data.device),
        torch.diff(csr.indptr.long()))
    return rows, csr.indices, csr.data


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2n", type=int, default=22,
                    help="rows of the main path's matrices (2^k)")
    ap.add_argument("--dia-log2n", type=int, default=16,
                    help="rows of the DIA path's FD matrix (<= 16)")
    ap.add_argument("--reorder-log2n", type=int, default=22,
                    help="rows of the reorder phase's scrambled band")
    ap.add_argument("--bell-log2n", type=int, default=21,
                    help="rows of the bell phase's blocked graph")
    ap.add_argument("--attn-batch", type=int, default=4,
                    help="batch of the attention phase's flash runs")
    ap.add_argument("--attn-seq", type=int, default=4096,
                    help="tokens of the flash runs (float32: half)")
    ap.add_argument("--paged-seqs", type=int, default=64,
                    help="sequences of the paged decode runs")
    ap.add_argument("--paged-max-len", type=int, default=4096,
                    help="longest paged sequence (lengths in [1, this])")
    ap.add_argument("--serve-replay-log2n", type=int, default=16,
                    help="rows of the serve phase's replayed trace (2^k)")
    ap.add_argument("--sweep-shift", type=int, default=0,
                    help="cut the sweep grids' log2n by this much (the "
                         "digests are pinned at 0)")
    ap.add_argument("--train-batch", type=int, default=8,
                    help="sequences a step of the train phase")
    ap.add_argument("--train-seq", type=int, default=512,
                    help="tokens a sequence of the train phase")
    ap.add_argument("--reps", type=int, default=50,
                    help="kernel launches per timing")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the phases on the CPU's plain versions at a "
                         "small size; prints no result")
    args = ap.parse_args(argv)
    if args.cpu_rehearsal:
        dev = torch.device("cpu")
    elif not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    else:
        dev = torch.device("cuda", torch.cuda.current_device())
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch import core
        from repro_torch import kernels as K
        from repro_torch import plan as P
        from repro_torch import reorder as T
        from repro_torch import serve_graph as SG
        from repro_torch.core import delta as D
        from repro_torch.core.formats import CSR
        from repro_torch.core.generators import (banded_matrix, fd_matrix,
                                                 rmat_matrix)
        from repro_torch.graph import drivers
        from repro_torch.graph.semiring import SEMIRINGS as SR
        from repro_torch.kernels import _build
        from repro_torch.plan import PlanCache, compile as compile_plan
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    roofline_child = start_roofline(args)

    # -- device --------------------------------------------------------------
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        check(smi.returncode == 0, "nvidia-smi failed")
        for line in smi.stdout.strip().splitlines():
            log(line.strip())           # name, power limit
        CARD[0] = "; ".join(line.strip()
                            for line in smi.stdout.strip().splitlines())
        build_s = _build.build_all()
        log(f"device torch {torch.__version__} cuda {torch.version.cuda} "
            f"kind={torch.cuda.get_device_name(0)} "
            f"count={torch.cuda.device_count()} nvcc_build_s={build_s:.2f}")
        flash_sass(_build)
        paged_sass(str(_build.library_path("paged_attention")), "split walk",
                   PAGED_INSTANCES)
        # one launch of each kernel on a tiny matrix; with the small phase
        # below (every driver, so every PyTorch kernel and library the
        # steppers use), this keeps one-time loading out of the main
        # path's iterations
        tiny = rmat_matrix(256, device=dev)
        for fmt in ("dia", "bell", "ell", "csr", "hyb"):
            p = compile_plan(tiny, format=fmt, reorder="none",
                             predictor="none", device=dev)
            p.execute(torch.ones(256, device=dev))
            if fmt == "hyb":        # spmm_ell and spmm_csr_seg
                p.execute_many(torch.ones(2, 256, device=dev))
    else:
        log("device cpu rehearsal: plain versions only, no kernels")
    # -- small inputs against the CPU path --------------------------------------
    for fam, gen in (("fd", fd_matrix), ("rmat", rmat_matrix)):
        here = drive(drivers, fam, gen(1024, device=dev), None, dev, True)
        cpu = drive(drivers, fam, gen(1024, device="cpu"), None,
                    torch.device("cpu"), True)
        compare_runs(f"small {fam} 2^10 vs cpu", here, cpu)
    sync(dev)

    # -- attention ------------------------------------------------------------
    t0 = time.perf_counter()
    attn_counts, attn_errs, attn_times = run_attention(args, dev, K)
    log(f"attention phase_s={time.perf_counter() - t0:.1f}")
    if dev.type == "cuda":
        log(f"attention peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # -- lm: Granite-8B served through the engine -----------------------------
    t0 = time.perf_counter()
    lm_times: dict = {}
    lm_counts = run_lm(args, dev, K, attn_errs, lm_times)
    log(f"lm phase_s={time.perf_counter() - t0:.1f}")
    if dev.type == "cuda":
        log(f"lm peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # -- lm_hybrid: Jamba-v0.1 (8 layers) and RWKV6-3B served ---------------
    t0 = time.perf_counter()
    hybrid_counts = run_lm_hybrid(args, dev, K)
    log(f"lm_hybrid phase_s={time.perf_counter() - t0:.1f}")
    if dev.type == "cuda":
        log(f"lm_hybrid peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # -- lm_encdec: Whisper-large-v3 through the model API ------------------
    t0 = time.perf_counter()
    encdec_counts = run_lm_encdec(args, dev, K, attn_errs, lm_times)
    log(f"lm_encdec phase_s={time.perf_counter() - t0:.1f}")
    if dev.type == "cuda":
        log(f"lm_encdec peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # -- train: StableLM-1.6B through the port's train step -----------------
    t0 = time.perf_counter()
    # the mesh phase's ranks start once the train phase's timed steps are
    # done, and wait: their imports and CUDA contexts (11-12.5 s a process
    # on the card's machine) overlap its untimed checks, and no timing
    worlds = []

    def start_world():
        from repro_torch.launch.mesh import World
        worlds.append(World(MESH_RANKS, dev))
        atexit.register(worlds[0].close, wait=False)

    train_counts = run_train(args, dev, K, start_world)
    log(f"train phase_s={time.perf_counter() - t0:.1f}")
    if dev.type == "cuda":
        log(f"train peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # -- mesh: the MoE paths and collectives on four ranks -------------------
    t0 = time.perf_counter()
    try:
        mesh_counts = run_mesh(args, dev, worlds[0])
    finally:
        worlds[0].close()
    log(f"mesh phase_s={time.perf_counter() - t0:.1f}")
    if dev.type == "cuda":
        log(f"mesh peak device memory (this process) "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # -- roofline: the timed steps' counted costs against the card's ------
    # (traced in the process started before the build: the wait is left)
    t0 = time.perf_counter()
    rows = finish_roofline(roofline_child)
    if rows is not None:
        run_roofline(args, rows)
    log(f"roofline phase_s={time.perf_counter() - t0:.1f} (the traces "
        f"took {sum(r['trace_s'] for r in rows or ()):.1f} s beside the "
        f"build and the card phases)")

    # -- main path ------------------------------------------------------------
    n = 1 << args.log2n
    t0 = time.perf_counter()
    adjs = {"fd": fd_matrix(n, device=dev), "rmat": rmat_matrix(n, device=dev)}
    log(f"main generate 2^{args.log2n}: fd nnz={adjs['fd'].nnz} "
        f"rmat nnz={adjs['rmat'].nnz} gen_s={time.perf_counter() - t0:.2f}")
    cache = PlanCache(max_plans=64)
    K.reset_launch_counts()
    kern = {fam: drive(drivers, fam, adj, cache, dev, True)
            for fam, adj in adjs.items()}
    counts = K.launch_counts()
    log(f"main launches {json.dumps(counts)}")
    for fam in adjs:
        for name in ANALYTICS:
            res = kern[fam][name][0]
            report_run("main", fam, name, *kern[fam][name],
                       cap=FD_CAP if fam == "fd" and name != "pagerank"
                       else None, spmv=spmv_ms(res.plan, dev))
    if dev.type == "cuda":
        for k in ("spmv_ell", "spmv_csr", "spmv_csr_seg"):
            check(counts[k] > 0, f"main path launched {k} no time")
    t0 = time.perf_counter()
    n_twins = plain_twins(cache)
    log(f"main plain twins: {n_twins} plans reuse the kernel runs' "
        f"containers (no recompile) in {time.perf_counter() - t0:.2f} s")
    plain = {fam: drive(drivers, fam, adj, cache, dev, False)
             for fam, adj in adjs.items()}
    for fam in adjs:
        for name in ANALYTICS:
            report_run("plain", fam, name, *plain[fam][name])
        compare_runs(f"main {fam}", kern[fam], plain[fam])
    execute_many_replays(
        [("fd sssp", kern["fd"]["sssp"][0].plan),
         ("fd bfs", kern["fd"]["bfs"][0].plan),
         ("rmat pagerank", kern["rmat"]["pagerank"][0].plan)],
        plain["rmat"]["pagerank"][0].plan, dev, args.reps)

    # -- DIA path -------------------------------------------------------------
    nd = 1 << args.dia_log2n
    fd_small = fd_matrix(nd, device=dev)
    r0 = np.random.default_rng(7).uniform(0.5, 1.5, nd).astype(np.float32)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    dres = drivers.pagerank(fd_small, tol=PR_TOL, r0=r0, plan_cache=cache,
                            device=dev)
    sync(dev)
    dwall = time.perf_counter() - t0
    dia_counts = K.launch_counts()
    report_run("dia", "fd", "pagerank", dres, dwall,
               spmv=spmv_ms(dres.plan, dev))
    log(f"dia launches {json.dumps(dia_counts)}")
    check(dres.plan.format_name == "dia",
          f"FD 2^{args.dia_log2n} PageRank compiled to "
          f"{dres.plan.format_name}, not dia")
    if dev.type == "cuda":
        check(dia_counts["spmv_dia"] > 0, "DIA path launched spmv_dia no time")
    dplain = drivers.pagerank(fd_small, tol=PR_TOL, r0=r0, plan_cache=cache,
                              use_pallas=False, device=dev)
    check(dplain.n_iters == dres.n_iters, "dia pagerank: iteration counts "
          f"{dres.n_iters} vs {dplain.n_iters}")
    log(f"dia pagerank kernels vs plain: iters {dres.n_iters} == "
        f"{dplain.n_iters}")
    compare_pagerank("dia", dres, dplain)
    phase_counts = {"attention": attn_counts, "lm": lm_counts,
                    "lm_hybrid": hybrid_counts, "lm_encdec": encdec_counts,
                    "train": train_counts, "mesh": mesh_counts,
                    "main": counts, "dia": dia_counts}

    # -- the reordering, per-call and BELL paths ------------------------------
    plans = {}
    band, scrambled, band_s = scrambled_band(args.reorder_log2n, dev, T,
                                             banded_matrix)
    fps = (P.matrix_fingerprint(band), P.matrix_fingerprint(scrambled))
    log(f"reorder band fingerprints band={fps[0]} scrambled={fps[1]}")
    if args.reorder_log2n == 22:
        check(fps == BAND_FINGERPRINTS_2_22, "reorder: the 2^22 band's "
              f"fingerprints {fps} are not {BAND_FINGERPRINTS_2_22}")

    # -- compile: the reference's default plan.compile -----------------------
    t0 = time.perf_counter()
    phase_counts["compile"], band_rcm, rmat_rcm = run_compile(
        args, dev, K, P, core, adjs, band, scrambled, rmat_matrix)
    log(f"compile phase_s={time.perf_counter() - t0:.1f}")
    if band_rcm[0] is None:         # the oracle kept the scrambled order
        t0 = time.perf_counter()
        band_rcm = (T.rcm(scrambled), time.perf_counter() - t0)
    rr = run_reorder(args.reorder_log2n, dev, K, core, compile_plan,
                     args.reps, scrambled, band_s, *band_rcm)
    if rr is not None:
        plans[("reorder", "dia")] = rr["plan"]
        phase_counts["reorder"] = rr["counts"]
    del band, scrambled
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rm = run_rmat_rcm(adjs["rmat"], kern["rmat"]["pagerank"][0], dev, K,
                      drivers, cache, rmat_rcm)
    phase_counts["rmat_rcm"] = rm["counts"]
    rb = run_bell(args.bell_log2n, dev, K, CSR, core, drivers, cache,
                  args.reps)
    if rb is not None:
        phase_counts["bell"] = rb["counts"]
        plans[("bell", "pagerank")] = rb["plan"]
        bell = rb["bell"]
        plans[("bell", "percall")] = P.DEFAULT_CACHE.get_or_build(
            P.matrix_fingerprint(bell) + "|container",
            lambda: P.plan_for_container(bell))
    small = CSR.from_coo(*blocked_coo(1024, TILES_PER_1024), 1024, 1024,
                         device=dev)
    plans[("bell", "small")] = compile_plan(
        small, format="bell", reorder="none", predictor="none", device=dev)

    # -- kernel vs plain -------------------------------------------------------
    plans.update({(fam, name): kern[fam][name][0].plan
                  for fam in adjs for name in ANALYTICS})
    plans[("dia", "pagerank")] = dres.plan
    want = {("fd", "pagerank"): "csr", ("dia", "pagerank"): "dia"}
    want.update({("fd", a): "ell" for a in ANALYTICS[1:]})
    want.update({("rmat", a): "hyb" for a in ANALYTICS})
    got = {k: plans[k].format_name for k in want}
    if not check(got == want, f"formats {got} are not the main path's "
                 f"{want}; the kernel phases need those layouts"):
        return 1
    errs = kernel_vs_plain(K, SR, plans, dev)
    errs.update(attn_errs)

    # -- timing ------------------------------------------------------------------
    times = timings(K, SR, plans, dev, args.reps,
                    rb["adj"] if rb is not None else None)
    times.update(attn_times)
    times.update(lm_times)
    if dev.type == "cuda":
        log(f"time peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log(f"time done at {time.perf_counter() - t_start:.1f} s")

    # -- serve ------------------------------------------------------------------
    t0 = time.perf_counter()
    phase_counts["serve"] = run_serve(
        args, dev, K, P, SG, D, drivers, fd_matrix, rmat_matrix, adjs,
        cache, kern, args.reps)
    log(f"serve phase_s={time.perf_counter() - t0:.1f}")

    # -- sweep -------------------------------------------------------------------
    t0 = time.perf_counter()
    phase_counts["sweep"] = run_sweep_phase(
        args, dev, K, P, drivers, {"fd": fd_matrix, "rmat": rmat_matrix},
        errs)
    log(f"sweep phase_s={time.perf_counter() - t0:.1f}")

    # -- sharded -----------------------------------------------------------------
    t0 = time.perf_counter()
    phase_counts["sharded"] = run_sharded(
        args, dev, K, P, SR, adjs["fd"], kern["rmat"]["pagerank"][0].plan,
        fd_matrix)
    log(f"sharded phase_s={time.perf_counter() - t0:.1f}")
    totals = {k: sum(c.get(k, 0) for c in phase_counts.values())
              for k in K.KERNELS}
    log(f"launches by path {json.dumps(phase_counts)}")
    log(f"total_s={time.perf_counter() - t_start:.1f}")

    kernels = []
    for name in K.KERNELS:
        # the attention kernels at the shapes of the served model
        t = times.get(f"{name} lm", times[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": TPU_KERNELS[name], "launches": totals[name],
            "max_abs_err": errs.get(name, 0.0), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        log(f"kernels {name}: launches={totals[name]} ("
            + ", ".join(f"{path} {c.get(name, 0)}"
                        for path, c in phase_counts.items()) + ")")
    if dev.type != "cuda":
        log(f"rehearsal done, {len(FAILURES)} failure(s); no result on CPU")
        return 3
    if FAILURES:
        log(f"{len(FAILURES)} check(s) failed")
        return 1
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
