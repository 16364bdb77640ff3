#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``byteps_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which raises (non-zero exit, no result line) on failure:

1. Device — the ``nvidia-smi`` name / power-limit line, torch and CUDA
   versions.  Exits 1 at once when ``torch.cuda.is_available()`` is
   false.
2. Build — compiles every kernel of the serving and training paths from
   the sources in the checkout (one ``nvcc`` per source, ``sm_90a``,
   started together) and prints the build seconds and ``ptxas``'s
   register and spill lines; then the paged kernel's, the bf16 flash
   kernels' on tensor cores (forward, dq, dk/dv) per instantiation, the
   fused-CE kernels' on TMA and wgmma (forward, dlogits, dx, dW), the
   decode kernel's on tensor cores per instantiation and the int8
   product's swap (per row-fragment count) and tma kernels, and fails if
   any flash one of them spills at head_dim 64 or 128, any fused-CE or
   int8 one at all, or a decode one of one row tile (up to 16 query heads
   a KV head).
3. Reference — a small fp32 Llama-shaped model served greedily through
   the paged engine (the kernel decoding) must give exactly the tokens
   of a plain dense-cache greedy loop (``Transformer.decode``, no
   kernel); seeded sampled streams (temperature 0.8, top-k 50, top-p
   0.95) of two fresh engines must repeat token for token.
4. Serve (the main path) — Llama-3.2-1B at full width (16 layers,
   d_model 2048, 32 heads over 8 KV heads, head_dim 64, d_ff 8192, vocab
   128256, rope theta 500000 with llama3 scaling, tied embeddings;
   ``meta-llama/Llama-3.2-1B`` ``config.json``) in bf16 with random
   weights from ``--seed``; max_seq cut from 131072 to 2048.  A
   ``ServeFrontend`` on localhost serves 8 concurrent greedy requests
   (prompts of 32-512 tokens, 32 new tokens each) to
   ``RemoteServeClient``s, twice: both runs must complete at the right
   lengths with identical tokens, every paged-attention launch of the
   run must be one per layer per decode tick, and nothing may run on
   the CPU.  The kernel counts are set to 0 just before each run and
   read just after.
5. Kernel — the paged-attention kernel against its plain PyTorch version
   on the card at Llama-3.2-1B shapes (H=32, KV=8, D=64, block 16, B=8):
   ragged cursors 1..2047 over null-padded tables, all slots at 2047,
   tq=1 and tq=5 (speculation at k=4), window 256, fp32 and bf16, in the
   fp mode and the int8 mode (s8 pools with fp32 scale pools, the scale
   rows past each cursor garbage; q fp32 or bf16), plus the cursors of
   the serve run's last decode tick.  Max abs error <= 1e-4 in fp32
   (online vs dense softmax order) and <= 2e-2 in bf16 (p is rounded to
   bf16 before the PV product, so one bf16 ulp of a probability reaches
   the output); the int8 mode with a bf16 q within 2 bf16 ulps of each
   output row's largest reference magnitude (both sides round p and the
   output at the same points).  Every int8 case also runs the tp wrapper
   at tp=2 and 4 on the same bytes cut into per-shard pools: the output
   bit-identical to the unsharded launch (printed;
   held to the same tolerance).  One launch at every tp (the shard is a
   grid coordinate).  Times (fp cases, and the int8 mode with a bf16 q): device
   time per call from CUDA graphs of 20 (flush, call) pairs less the
   flushes, as in phase 16, of the kernel (and the tp=2 wrapper) and of
   ``F.scaled_dot_product_attention(enable_gqa=True)`` over pre-gathered
   dense rows (dequantized to bf16 for int8) as a yardstick (never called
   by the port); the plain version by CUDA events around each call (it
   syncs to size its gather, so it cannot be captured); the bound is the
   bytes the kernel must move (values, and int8 scales) over 3.35 TB/s
   (or its FLOPs over the dtype's peak if larger).  One more case per
   mode and dtype at head_dim 32 (4 heads, MHA: the serve role's default
   model).
6. Serve role — ``serve_from_env`` with the role's defaults: the dense
   slot engine (grouped rows, attended in plain torch, no kernel
   launch) with the default model (d_model 128, 4 heads, head_dim 32)
   on the GPU answers two identical greedy requests identically; then
   with ``BYTEPS_SERVE_PAGED=1`` the paged engine, through the kernel
   (one launch per layer per tick); then with ``BYTEPS_SERVE_PAGED=1
   BYTEPS_SERVE_KV_DTYPE=int8 BYTEPS_TP=2 BYTEPS_SERVE_PREFIX_CACHE=1
   BYTEPS_SERVE_SPEC=1``: the pool sharded in two and int8, the second
   request a prefix hit, every tick a verify pass, one launch per layer
   per tick (the tp wrapper launches once for both shards).
6b. Tiers reference — the phase-3 fp32 model: the int8-pool engine (the
   kernel's int8 mode) gives exactly the greedy tokens of a plain dense
   loop over an int8 grouped cache whose prompt is quantized at write
   and attended as int8 (``Transformer.decode(fresh_prefill=False)``, no
   kernel; whether ``inference.generate(kv_quant=True)``, which attends
   its prompt unquantized, agrees is printed); tp=2 gives tp=1's tokens
   for fp and int8 pools; the prefix cache on gives the tokens of off
   (int8, prompts sharing 64 tokens, >= 3 hits); speculation (k=4) on
   gives the tokens of off, greedy (fp and int8) and seeded.
6c. Tiers serve (the main path of the tiers slice) — phase 4's
   Llama-3.2-1B in bf16 behind a ``ServeFrontend``: an int8 pool at 513
   MiB (phase 4's 1025-block bf16 pool, 537.4 MB, in whole MiB), the prefix
   cache, speculation at k=4, tp=1.  One warm request, then 8 concurrent
   ones; a base prompt is a shared 256-token prefix, 64-256 unique tokens
   and an 8-token run repeated twice (336-528 tokens); 32 new tokens
   each.  Run with the n-gram proposer at tp=1, then tp=2 (random
   weights accept none of its proposals: the answer changes with any
   change of its context, so no copy of it can sit in a prompt), then on
   fresh engines at tp=1 and tp=2 with a replay proposer offering each
   request's answer from the first run: the accept path at full width
   (cursors moving up to 5, the accepted rows quantized at scatter, tp=2
   writes at tq=5), which must accept.  All four runs token-identical.
   Each run: >= 8 prefix hits, every tick a verify pass, exactly one
   kernel launch per layer per tick (at tp=2 too), no plain version
   called; TTFT/TPOT p50/p99, tokens/s, the acceptance rate, and the blocks the
   budget holds in int8 against bf16.  Then the int8 mode and the tp=2
   wrapper at the last tick's cursors, timed as in phase 5.
6d. Dense reference — phase 3's fp32 model on the dense slot engine
   (``ServingEngine(paged=False)``, 4 slots): grouped rows, flat rows (the
   decode kernel at a position vector: one launch a layer a tick for all
   slots, by the wrapper's count and the library's), chunked prefill
   (``chunk=8``), and int8 rows flat and grouped.  Greedy tokens exactly
   those of a plain dense greedy loop (grouped rows, no kernel; an int8
   loop for the int8 rows) and, for the fp rows, of the paged engine.
6e. Dense serve (the main path of the dense-engine slice) — phase 4's
   Llama-3.2-1B in bf16 with ``attn_impl="flash"`` on the dense slot
   engine: 8 slots of 2048 rows (16 layers x K and V x 2048 x 512 x 2 B
   a slot: 537 MB, the KV bytes of phase 4's 1025-block pool) behind a
   ``ServeFrontend``, phase 4's 8 concurrent greedy requests; flat rows
   twice, then grouped rows, then flat int8 rows (``kv_quant``: the
   kernel's int8 mode at the position vector).  Flat: decode-kernel
   launches = decode ticks x 16 (each reading the slots' position
   vector), grouped: none;
   flash-forward launches = 16 x the prefills whose bucket passes the
   gcd gate (7 of 8); no plain version called; the flat reruns
   token-identical; flat against grouped not "real" by
   ``classify_divergence``, request by request.  TTFT/TPOT p50/p99 and
   tokens/s of each run beside phase 4's paged numbers.  The counts are
   set to 0 just before each run and read just after.
6f. Dense tiers reference — phase 3's fp32 model: the dense engine
   (grouped rows) with the prefix store and speculation (k=4), together
   and alone, gives exactly the tokens of both off (4 prompts sharing 64
   tokens and ending in a repeated run, one after another: >= 3 hits,
   every tick a verify); seeded speculation on == off; the paged gather
   fallback (``paged_kernel="off"``: a grouped fp pool, int8, int8 and fp
   at tp=2) gives exactly the tokens of a plain dense loop (fp, or int8
   quantized at write), the int8 pools decoding through the decode
   kernel at the slots' position vector (one launch a layer a tick, by
   the wrapper's and the library's counts), no paged-kernel call.
6g. Dense tiers serve (the main path of this slice's dense half) — phase
   4's Llama-3.2-1B (bf16, attention ``local``: a flash model is refused
   with a prefix store at this max_seq) on 8 dense grouped slots of 2048
   rows with ``prefix_cache=True`` and ``spec_k=4`` behind a
   ``ServeFrontend``, phase 6c's traffic (a warm request, then 8 sharing
   a 256-token prefix): the n-gram run, a replayed-answer run (accepted,
   token-identical to the n-gram run: the verify width is fixed), the
   prefix store alone, speculation alone, and both off.  Every tick of a
   spec run a verify, >= 8 prefix hits and one row copy a hit in a
   prefix run, no kernel launched (grouped rows attend in plain torch);
   each run against off not "real" by ``classify_divergence``, with
   where it first parts from off and the off stream's logit gap there
   (bf16 sums over other row counts can flip near-tied random logits).
   TTFT/TPOT p50/p99, tokens/s, acceptance.
6h. Gather serve (the main path of this slice's paged half) — phase 4's
   model and traffic on ``ServingEngine(paged=True, paged_kernel="off")``:
   a bf16 grouped pool of phase 4's 1025 blocks, an int8 pool at 513 MiB
   twice, the int8 pool at tp=2, and the paged kernel on the int8 pool
   as the reference.  Int8 gather runs: decode-kernel launches = ticks x
   16, every one reading the position vector, no paged launch, no plain
   call; reruns and tp=2 token-identical to the int8 run; bf16 and int8
   not "real" against the kernel path's stream (phase 4's, or the int8
   kernel run).  The first decode-kernel call at each gather bucket
   (``[8, bucket x 16, 512]`` int8 rows at the position vector) is
   recorded and, after the run, its output held to the plain version at
   phase 16's limits, a call on the same inputs bit-identical, each
   slot's bits independent of the others' positions and within the
   limit of a one-slot launch.  TTFT/TPOT p50/p99, tokens/s, the gather
   buckets used.
6i. Disagg serve (the main path of the serve replica's wire slice) —
   first phase 3's fp32 model on a prefill replica and a decode replica
   (two paged engines, two ``ServeFrontend``s): exactly the greedy
   tokens of one colocated paged engine.  Then phase 4's model and
   traffic: each of the 8 requests, all at once, runs
   ``prefill_ship(prompt, ship_to=decode, kv_ship=key)`` on the prefill
   replica (the first token; the prompt's KV shipped block by block over
   OP_KV_BLOCKS) and then ``stream(prompt, 32, resume=[first],
   kv_ship=key)`` on the decode replica, which adopts the staged blocks
   in place of a prefill.  Three pairs: bf16 pools of phase 4's 1025
   blocks, int8 pools at 513 MiB, and a tp=2 prefill replica shipping to
   a tp=1 decode replica (tokens identical to the tp=1 pair).  Each:
   every ship whole; sum(ceil(T / 16)) = 130 blocks of the pool's
   block_bytes shipped by the prefill replica (bf16 68,157,440 bytes,
   int8 36,208,640) and none by the decode replica; no prefill on the
   decode replica; paged launches = its decode ticks x 16, no plain
   call; both pools back at their base; the decode replica's first
   paged-attention call at each tick that brings a request live for the
   first time (every adopted ship's first decode, the last to arrive
   included) held to the plain version after the run at phase 5's
   limits (a call on the same inputs bit-identical).  bf16 against phase 4's stream and int8 against 6h's
   colocated int8 kernel run: identical or not "real".  Ship ms p50/p99
   (STATS "ship"), MB/s, extract ms, TTFT with the ship, the decode
   replica's TPOT and tokens/s beside phase 4's, and a PING round trip
   (p50 of 100).
6j. Router tier (the main path of the router slice) — phase 4's model
   (bf16, its paged pools) on two replicas behind two port routers, an
   active and a standby fed by the journal, in this process:
   (a) phase 4's traffic, 8 concurrent streams from ``RemoteServeClient``s
   given both router addresses: every request on the kernel (each
   replica's paged calls = its decode ticks x 16, no plain call), tokens
   against phase 4's one-replica stream identical or not "real", and two
   prompts one at a time through the router identical to the same
   requests sent straight to a replica; client-side TTFT and TPOT p50 /
   p99 beside phase 4's and the replicas' own.  (c) the active killed
   mid-stream (after 4 tokens): the client fails over to the standby,
   which takes over at epoch 2; the spliced stream equals its own
   control (the tokens received before the kill, then the replica's own
   resumed continuation of prompt + received, alone); its agreement with
   the unkilled stream, any divergence classified; both replicas then
   fence epoch 1.  (b) the replica that holds a stream killed after 4
   tokens: the router re-dispatches with ``resume`` (redispatches >= 1)
   and the splice is held the same way.  (d) a prefill and a decode
   replica behind one port router (roles prefill, decode): phase 4's
   traffic through ``prefill_ship`` -> ``kv_ship``: every ship whole,
   no fallback, no prefill on the decode side, its paged calls = its
   ticks x 16, pools at base, tokens against phase 4 identical or not
   "real".  Each leg's first paged call of each shape at each decode
   tick that brings a request live on a replica for the first time (each
   replica's first decode, each resumed request's, each adopted ship's)
   held to the plain version at phase 5's limits.  (e) three processes
   of the port's launcher: two ``DMLC_ROLE=serve BYTEPS_SERVE_PAGED=1``
   replicas (the serve role's model, fp32, rows of 1024) and a
   ``DMLC_ROLE=router`` with ``BYTEPS_ROUTER_ROLES=prefill,decode``,
   spawned after the kernels were built: 8 requests of phase 4's prompt
   lengths equal an in-process replica of the same model; ship p50 and
   the decode replica's TPOT with one process a replica; every child
   alive until stopped.  (f) an ``AutoscaleController`` with the port's
   ``ReplicaLauncher`` over a one-replica tier (max 2): a load spike
   spawns a ``byteps_tpu_torch.launcher`` serve process on the card,
   which serves requests; idle load drains and stops it; the spawn time.
7. Training reference — a small fp32 Llama-shaped model (2 layers,
   d_model 256, 4 heads over 2 KV heads, head_dim 64, vocab 1024), B=2,
   T=256: 3 ``Trainer.fit`` steps with ``attn_impl="flash"`` (the
   kernels) and 3 from the same weights with ``"local"`` (no kernel),
   SGD momentum 0.9.  Losses agree within 1e-5 relative; step-1
   gradients within 1e-4 of each tensor's largest entry (fp32 sums in
   other orders; Adam is not used here, as its m / sqrt(v) would turn
   that rounding into updates of up to lr).
8. Train (the main path of the training slice) — Llama-3.2-1B at full
   width, bf16 compute on fp32 weights from ``--seed``, max_seq 2048;
   B=4, T=2048, one fixed batch; ``Trainer.fit`` -> ``lm_loss_fn``
   (plain head) -> ``Transformer`` with ``attn_impl="flash"``;
   ``torch.optim.AdamW(lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
   weight_decay=1e-4, fused=True)``.  One warm-up step, 5 timed: every
   loss finite, the last below the first, 16 launches of each flash
   kernel per step, every parameter and optimizer state on the GPU.
   The counts are set to 0 just before the timed steps, read after.
9. Flash kernels — forward, dq and dk/dv against their plain versions at
   the training shape (B=4, T=2048, H=32, KV=8, D=64, causal) in bf16
   and fp32, plus non-causal, window 256, two packed documents, ALiBi,
   MQA, head_dim 32 and 128, and T=2000.  fp32 within 1e-4 of the
   largest reference magnitude, or absolute below magnitude 1 (dk/dv sum
   G * T products: at MQA, 32 heads of 2048 rows); bf16 within 2e-2 of
   the largest reference magnitude (p and ds are rounded to bf16 before
   their products, and outputs once).  Every case reruns dq and dk/dv:
   the reruns must be bit-identical (no atomics; every sum in a fixed
   order).  In bf16 the three kernels run on tensor cores, in fp32 on
   scalar FMA.  At the
   training shape, times (L2 flushed) of each kernel, its plain
   version, and as the yardstick ``F.scaled_dot_product_attention(...,
   is_causal=True, enable_gqa=True)`` forward and its autograd backward
   (dq + dk + dv in one), with the SDPA kernel that ran; the bound is
   the kernel's FLOPs over the dtype's peak (or its bytes over 3.35
   TB/s if larger).  Also BERT-base's fine-tune shape (B=32, T=128,
   H=KV=12, D=64, non-causal, padding segment ids ``1...1 0...0`` of
   seeded lengths, a row unpadded and a row of one token) in both dtypes,
   timed as the training shape beside SDPA under the same key mask
   (its error read at the valid rows), the bound counting the attended
   pairs only.
10. Fused-head reference — the phase-7 model, 3 SGD-momentum steps with
   ``lm_loss_fn(fused_head=True)`` (the fused LM-head CE kernels) and 3
   from the same weights with the plain head; again with
   ``early_exit=(1, 0.5)``.  Losses within 1e-5 relative, step-1
   gradients within 1e-4 of each tensor's largest entry; one forward
   launch and one dx and one dW launch per vocabulary chunk per CE call.
11. Fused-head train (the main path of the fused-CE slice) — phase 8's
   model, seed, batch and AdamW with ``lm_loss_fn(fused_head=True)``:
   one warm-up step, 5 timed; every loss finite, the last below the
   first; the warm-up loss equal to phase 8's within 1e-3 relative (the
   same bf16 operands, fp32 sums in other orders); per step 1 forward,
   16 dx and 16 dW launches of the fused-CE kernels (16 vocabulary
   chunks), the forward and the dlogits, dx and dW of all 16 chunks on
   the bf16 kernels on TMA and wgmma (49 TMA launches the library
   counts), and 16 of each flash kernel; no plain version called.
12. Evaluation — ``Trainer.evaluate`` of phase 11's trained model with
   the fused-head loss on 2 fresh batches: only the fused forward kernel
   (and the flash forward) launches, on TMA and wgmma; the mean loss
   equals the plain head's under ``no_grad`` within 1e-3 relative; the
   perplexity.
13. Fused-CE kernels — forward, dlogits + dx and dW against their plain
   versions at the training shape (N=8192, H=2048, V=128256, w the tied
   ``[V, H]`` table's transpose view) in bf16 and fp32, at N=8188,
   V=50257 (both edges ragged), and at N=8188, H=2044, V=50257 (rows TMA
   cannot describe); a quarter of the targets -100, a non-uniform loss
   cotangent.  lse and loss within 1e-5 relative in both dtypes (fp32
   sums of exact products on both sides); fp32 dx and dW within 1e-4 of
   the largest reference magnitude, bf16 within 2e-2 of it (dlogits
   rounded to bf16 before each product on both sides).  Which kernels
   ran, by their profiler names and by the TMA launches the library
   counts (``tma_launches``): the first two bf16 cases the kernels on
   TMA and wgmma (the forward, and dlogits, dx and dW of every chunk),
   the H = 2044 bf16 case and fp32 the first design.  At the training shape
   in bf16, times with the L2 flushed: the forward with CUDA events, the
   backward's kernels by device time under ``torch.profiler``, the plain
   versions, and as yardsticks cuBLAS's GEMMs of the products each
   kernel computes (``x @ W^T`` for the forward; ``x @ W^T`` and
   ``dlogits @ W`` for dlogits + dx, and the latter alone; ``dlogits^T
   @ x`` for dW; never called by the port), with each time's TFLOP/s;
   the bound is the kernel's FLOPs over 989 TFLOP/s (or its bytes over
   3.35 TB/s if larger).  Then the same forward and backward on a copy
   of the table with rows of stride H + 1 (the first design throughout:
   W loaded element by element, and dW, held to the chunk's rule, on its
   ``mma.sync`` kernel), and the TMA backward again: dW's time on each
   design, and the median SM clock and power draw ``nvidia-smi`` reads
   while each design's backward runs back to back for 2 s.  GPT-2 small's
   fused head (N=8192, H=768, V=50257) is checked and timed the same way
   in bf16.
13a. Data-parallel training (the main path of the BytePS-core slice).
   (a) One worker on NCCL: ``api.init()`` on ``cuda`` (default backend
   ``nccl``, world 1), then CUDA tensors of Llama-3.2-1B's first layer
   (its 9 parameter shapes) and the tied embedding (257 partitions of
   4,096,000 bytes): ``declare`` gives keys 0..9; ``push_pull_async`` of
   all ten in reverse priority order while the engine's credit is held
   at 0, then released: the grant order is (priority desc, key asc) over
   every partition, as predicted; ``poll`` / ``synchronize``,
   ``push_pull`` with average on and off, ``push_pull_sparse`` (a
   duplicate row, one out of range), ``broadcast`` and
   ``broadcast_parameters`` give the world of one's bits exactly.
   Under ``BYTEPS_TRACE_PATH`` the chrome trace is written, read back,
   and holds a dispatch and a push_pull span for every partition.
   (b) Two workers through the launcher: ``python -m
   byteps_tpu_torch.launcher chip_smoke.py --dp-worker`` twice, with
   ``DMLC_NUM_WORKER=2``, ``DMLC_WORKER_ID`` 0 and 1 and a free
   ``DMLC_PS_ROOT_PORT``, started after the kernels are built (they reuse
   the build directory).  NCCL refuses two ranks on one GPU, so both ask
   for ``backend="gloo"`` on ``cuda:0`` by name.  Each runs
   ``Trainer.fit`` on full-width Llama-3.2-1B with the fused head (random
   weights: rank r's from ``--seed + r``, rank 0's broadcast at start,
   AdamW as phase 11), 2 x 2048 tokens a worker (rank r rows 2r and 2r+1
   of phase 11's 4 x 2048 batch), 3 steps; the DistributedOptimizer
   all-reduces the gradient buckets on the eager engine while backward
   runs.  Each step's averaged loss must be identical on both ranks, the
   parameters' SHA-256 equal after step 3, and each loss within 1e-3
   relative of a one-worker run of the 4 x 2048 batch in this process
   (the split changes the order of the dW sums); every worker step
   launches flash forward, dq and dk/dv once a layer and the fused-CE
   forward once and dx and dW once a vocab chunk, on TMA, with no plain
   call.  Each worker's first flash call and its fused-CE call of step 1
   (B=2 x 2048; N=4096, H=2048, V=128256), forward and backward, are held
   to the plain versions at phase 9's and 13's limits.  The first step's
   averaged gradient at three leaves (the tied embedding's first 4096
   rows, layer 0's q and layer 8's MLP down projection) must lie within
   2e-2 of each leaf's largest |g| of the one-worker run's, and two
   wrong reductions computed from the same readings must not: the sum
   left unaveraged, and each rank's own gradient alone.  Per worker:
   step ms, push_pull busy ms a step (the union of the tracer's
   push_pull spans), each partition's push_pull span and its latency
   from dispatch, the dispatcher's ms in the order gathers, buckets and
   bytes, collectives a step, peak memory, agreement cycles; beside them
   a bare gloo ``all_reduce`` of one partition's 4,096,000 bytes on a
   CUDA and on a host tensor, on the default group while the engine is
   idle.  No collective is staged through the host: the port has no
   staging path.
13h. The rest of the training path (the main path of the slice that adds
   the compression registry with error feedback, checkpoints, callbacks
   and the delayed-gradient overlap step) — phase 11's model, AdamW,
   fused head and 4 x 2048 batch.  (a) ``Trainer(compression="onebit")``
   at one worker, 4 steps: error feedback rounds every gradient leaf
   locally before AdamW (the JAX world-1 chain); losses finite and
   falling; at step 1, at phase 13a's three leaves, the card's
   dequantized gradient and residual against a float64 recomputation on
   the host from the same gradient (copied by a hook before the
   feedback): the scale the float64 mean of |g| within 1 ulp, every
   element ±scale by the sign of g, the residual g - deq exactly and not
   zero; step p50 beside phase 11's; every step phase 11's launches on
   TMA, no plain call.  (b) The run of (a) with ``checkpoint_dir`` (a
   temporary directory), ``checkpoint_every=2``, ``checkpoint_keep=1``,
   stopped after step 2; then fresh weights from ``--seed + 1``, a fresh
   AdamW and a fresh Trainer on the directory resume at step 2 and run
   steps 3-4: their losses and the parameters' SHA-256 bit-identical to
   (a)'s; the same resume with the residual zeroed must differ (the
   resumed Trainers do not save again).  The bytes, seconds and free
   disk of the save, the restore's seconds; a directory with less room
   than the state fails the phase with those numbers.  (c) Two launcher workers as in
   13a (b) (``--ef-worker``): each runs a onebit Trainer for 2 steps,
   then frees it and runs ``Trainer(overlap=True)`` for 3 steps and the
   flush.  Losses identical across ranks and the SHA-256 equal after
   each; at step 1, at the three leaves' first 4096 rows, the averaged
   gradient handed to AdamW equals ``(deq_0 + deq_1) / 2`` of the ranks'
   dequantized payloads (recorded in the error-feedback call), and the
   unaveraged sum and each rank's payload alone do not; each residual
   equals ``g_r - deq_r``; each overlap loss within 1e-3 relative of a
   one-worker delayed-gradient run of the 4 x 2048 batch in this process;
   each worker's first flash and fused-CE calls held as in 13a (b); per
   worker peak memory, and the share of the engine's push_pull busy time
   that falls inside a step's forward and backward (the tracer's
   ``overlap`` spans; printed, not gated).  (d) The serve role (phase 6's
   default model) with ``BYTEPS_SERVE_CHECKPOINT`` on a port checkpoint
   of that model saved from ``--seed + 1``: the served tokens equal the
   in-process ``generate()`` on the saved weights (grouped rows, as the
   dense engine) and differ from the role's default weights'.
13i. The async parameter-server tier (the main path of the slice that
   adds the native reducer, the PS shard and its launcher role, the
   pipelined ``RemoteStore`` and ``Trainer(async_mode=True)``) — phase
   11's model, AdamW and fused head.  Two shard processes of the port's
   launcher (``DMLC_ROLE=server BYTEPS_ENABLE_ASYNC=1``, host only) and
   two launcher workers (``--async-worker``, ``BYTEPS_ENABLE_ASYNC=1``
   and ``BYTEPS_SERVER_ADDRS``; one seed, so one initial state), each a
   ``Trainer(async_mode=True, async_interval=1)`` on its 2 x 2048 rows
   for 3 steps and the drain, over an fp32 wire; then the same for 2
   steps with ``BYTEPS_COMPRESSION=bf16``.  Per run: losses finite; each
   worker's launches 3 (or 2) x phase 11's a step and its first flash
   and fused-CE calls held as in 13a (b); at three leaves (a norm, one
   layer's wq, one MLP matrix), each partition pulled by a fresh client
   equals the initial value plus every delta both workers pushed,
   replayed in the order of the versions the replies carried (bf16-
   rounded under the bf16 wire) — bit for bit — and the same fold
   without worker 1's deltas misses; both shards log the native reducer
   and report no CUDA context, and no shard pid is in ``nvidia-smi
   --query-compute-apps``; the bf16 run puts at most 0.51x the fp32
   run's bytes a push on the wire.  Printed: exchange seconds (p50), the
   bytes each way and GB/s, the shards' summation GB/s, step ms with an
   exchange in flight beside phase 11's, the last step's device idle
   share (profiled), peak RSS of every process and peak device memory a
   worker.

13b. BERT reference — BERT-base (``bert_config()``: 12 x 768, 12 heads,
   3072, vocab 30522) in fp32 from ``--seed``, ``attn_impl="flash"``
   against ``"local"`` on the same weights and a padded batch (B=32,
   T=128): logits within 1e-4 of max(|logit|, 1), every gradient within
   1e-4 of its tensor's largest entry, 12 launches of each flash kernel.
   Without ``transformers`` on the host, one line ``{"phase": "hf", "run":
   false, "why": "transformers not installed"}`` stands for the HF
   comparisons below (13e, and 13f-13g's HF logits), which are then not
   run; the port's own models run those phases' kernel work.
13c. BERT fine-tune (the main path of this slice) —
   ``BertClassifier(bert_config(attn_impl="flash", dtype=bf16), 2)``,
   fp32 weights from ``--seed``; its logits on the first batch against
   the same weights in fp32 with ``"local"`` within 5e-2 of max(|logit|,
   1); ``Trainer.fit`` with ``examples/train_bert.py``'s loss and
   ``AdamW(lr=2e-5, weight_decay=1e-4)``: one warm-up step, then 5
   counted steps at B=32, T=128 (4 batches with padding masks of seeded
   lengths in [1, 128], then one with no mask): 12 launches of each flash
   kernel a step, no plain call; the first flash call of each shape
   (forward and backward, the path's own dO and gradients) held to the
   plain versions at phase 9's limits after the run, the kernels again on
   the same inputs bit-identical; step ms, tokens/s, peak memory, and one
   more step under the profiler (the device's idle share, flash's share).
13d. BertMLM — one forward and backward at B=8, T=512, padded rows: 12
   launches of each flash kernel, a finite loss and gradients.
13e. HF BERT — ``transformers``' ``BertForSequenceClassification(
   BertConfig(attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0))``
   (random weights, fp32, the installed attention implementation) at
   B=32, T=128, padded: inside ``flash_attention_for_hf_bert`` the CLS
   logits and every layer's valid-position hidden states within 1e-4 of
   the stock model's outside it (12 covered calls, 0 uncovered); a fresh
   context whose first call is unpadded (no mask) within 1e-4 of stock,
   12 covered; two train steps inside it, the second counted and timed:
   12 + 12 + 12 flash launches, 0 uncovered.
13f. GPT-2 small — ``load_gpt2`` of a random ``GPT2LMHeadModel(
   GPT2Config())`` (12 x 768, 12 heads, vocab 50257, 1024 positions,
   tied head): fp32 prompt logits within 1e-4 of max(|logit|, 1) of HF's
   forward on the card; greedy ``generate`` in bf16 of 4 prompts of 256,
   64 new tokens, twice (identical): 12 flash prefills, 63 x 12 decode
   launches at one query head a KV head; again after ``quantize_params``
   (q, k, v, o and the MLP int8, the tied head not): 64 x 72 int8
   products, the prefill's on tma, every step's on swap; each run's first
   call of each shape to rows 1, 7 and 9 held to its plain version (phase
   9's and 16's limits; row 9 within two bf16 ulps of the largest output,
   the double rounding of sum and scaled product, beside controls on the
   same inputs: exact sums, the tile design, one rounding, and one K step
   dropped); 3 ``lm_loss_fn(fused_head=True)`` steps at
   B=8, T=1024 on a fresh model: 1 forward, 7 dx and 7 dW fused-CE
   launches a step (V = 50257, 7 chunks; 22 TMA launches), 12 of each
   flash kernel, the first fused call's loss, dx and dW (the path's own
   cotangent and gradients) held to the plain versions at phase 13's
   limits and rerun bit-identical.
13g. Llama-3.2-1B — ``load_llama`` of a random ``LlamaForCausalLM`` at
   the published dimensions (llama3 rope scaling, head_dim 64, tied
   head), its config read back equal to phase 4's: fp32 logits of 2 x 256
   tokens within 1e-4 of max(|logit|, 1) of HF's forward; greedy
   ``generate`` in bf16 of 4 prompts of 256, 32 new tokens: 16 flash
   prefills, 31 x 16 decode launches, the first calls held.
14. Generate reference — the phase-7 fp32 model with
   ``attn_impl="flash"``, B=2, a prompt of 128 (the flash prefill), 32
   new tokens, greedy through ``inference.generate``: a flat cache (the
   decode-attention kernel) and a grouped one (plain dense) give
   identical tokens; so do ``kv_quant=True`` flat (the kernel's int8 mode)
   and grouped (``_cached_attention_q8``).  With ``quantize_params`` (the
   int8 product kernel on every projection) the prefill logits match the
   same model with dequantized float weights within 1e-4 of the largest
   |logit|, and the greedy tokens are identical or ``classify_divergence``
   says "tie".  A seeded sampled run (temperature 0.8, top-k 50, top-p
   0.95) repeats exactly.
15. Generate (the main path of the cached-generation slice) —
   Llama-3.2-1B at full width, bf16 weights from ``--seed``,
   ``attn_impl="flash"``; B=8 prompts of 1920 random tokens, 128 new
   tokens each (``cache_len`` 2048 = max_seq), ``inference.generate``
   greedy: (a) the default layout, flat on the card (the fp kernel), run
   twice — identical tokens, 16 flash-forward launches for the prefill
   and 16 decode-kernel launches per decode step, no plain version
   called; (b) ``cache_layout="grouped"`` (no kernel): its divergence from
   (a) must not be "real"; (c) ``kv_quant=True`` flat (the int8 mode), run
   twice, the same counts; (d) after ``quantize_params``, the flat bf16
   cache, run twice: 112 ``quant_linear`` launches per forward, the
   prefill's on the tma design and every decode step's on swap (the
   library's counts by design).  Each run prints prefill ms, decode ms
   per token (p50 and max, CUDA events between steps), tokens/s, peak
   memory and launches; counts are set to
   0 just before each run and read just after.  Eight decode steps of (a)
   and of (d) under ``torch.profiler``: kernels and device ms per step,
   the device's idle share, the costliest kernels.
15b. Search (the main path of this slice's generation half) — phase 15's
   model (``attn_impl="flash"``, bf16, the default flat cache):
   ``beam_search`` of 2 prompts of 512 tokens, 4 beams, 32 new tokens
   (16 flash forwards, 31 x 16 decode-kernel launches over the 8 beam
   rows; reruns identical; one beam vs greedy ``generate`` identical or
   not "real"), ms per search; ``speculative_generate`` of 4 prompts of
   512, 64 new tokens, gamma 4, a 4-layer ``truncated_draft`` (flash 16 +
   4, draft decode launches = rounds x 4 x 4; tokens not "real" against
   target-only greedy ``generate``), acceptance, rounds, ms per emitted
   token beside greedy ``generate``'s.  The first call of each shape to
   the flash forward (``[2|4, 512]`` prompts) and the decode kernel (the
   ``[8, 544, 512]`` beam rows, the ``[4, 581, 512]`` draft rows, int
   positions) is recorded and held to its plain version after the run,
   as in phase 6h.
16. Decode-attention kernel — against its plain version at H=32, KV=8,
   D=64, B=8, S=2048: pos 0, 1000 and 2047 (the ring design's splits of
   >= 8 chunks checked there), window 256, S=2000 (a ragged tail), one
   slot at pos 1300 (a ragged last split), MHA at head_dim 32, head_dim
   128, MQA; each in fp32, bf16 and int8 with bf16 q.  A bf16 q runs the
   kernel on tensor cores, one launch a call by profiler name (its split
   merge inside; the names are taken in a fresh process of this script,
   ``--decode-kernel-names``: by phase 16 this long run's profiler
   records no device event), within 2 bf16 ulps of each output row's largest
   reference magnitude (p is rounded to bf16 before the PV product at
   other running maxima, and the output once); fp32 the first design
   (its combine kernel where it splits), within 1e-4 absolute; every
   case reruns bit-identically.  At pos 2047, with the L2 flushed before
   each call, device time per call from CUDA graphs of 20 (flush, call)
   pairs less the flushes alone (no host gaps between launches): the
   kernel, the plain version, and as the yardstick (never called by the
   port) ``F.scaled_dot_product_attention(..., enable_gqa=True)`` on the
   rows ``[:pos+1]`` (dequantized to bf16 for the int8 mode); the kernel
   and the yardstick again behind a flush that reads (leaving no dirty
   lines to write back); the bound is the attended K/V bytes (and
   scales) over 3.35 TB/s.  Then the device form, a ``[8]`` int32
   position vector (0, 15, 16, 63, 255, 1000, 1919, 2047) in one launch,
   bf16 and int8 caches with a bf16 q (the ring design) and fp32 and
   int8 caches with an fp32 q (the first design), window None and 256:
   the same tolerances, the library's counts (one launch reading the
   vector), reruns bit-identical, each slot's bits unchanged when the
   other slots' positions change, the ring's tickets back at zero, and
   one CUDA-graph capture replayed at four position sets written into
   the captured vector (no host read).  Timed for bf16 and int8 without
   a window, from CUDA graphs behind both flushes: the one launch, 8
   one-slot int launches at the same depths, the int call with every
   slot at 2047, and SDPA on the same rows under each slot's key mask.
   Also GPT-2 small's decode (B=4, S=1024, H=KV=12, D=64, pos 1023: one
   query head a KV head), each mode, timed in bf16 as the main case.
17. Int8 product kernel — against its plain version at M = 1, 8, 16,
   40, 64, 65, 4096 and 15360 rows on Llama-3.2-1B's projection shapes
   (2048->2048, 2048->512, 2048->8192, 8192->2048), the probe's 768->3072
   and a ragged 208->1000; bf16 x with and without bias and with fp32
   output (the untied quantized head's mode), fp32 x at M = 8 and 15360.
   Each case holds the design the rule names (``_design``: swap up to 64
   bf16 rows, tma above, the tile design for fp32 x) to the launches the
   library counted by design, and a bf16 case to one kernel of that design
   by profiler name (the names taken in a fresh process of this script,
   ``--quant-kernel-names``, as phase 16's are: the split merge of swap
   runs inside its one launch, no combine kernel).  bf16 within one bf16
   ulp of the largest output (2^-7 of it: the same rounding points, fp32
   sums in other orders), fp32 within 1e-5 of it; every case reruns
   bit-identically.  At M = 8 and 15360, bf16 x without bias: device
   times per call, the L2 flushed, from CUDA graphs as in phase 16 (50
   pairs, best of 5, at M = 8): the rule's design, the tile design
   (``quant_linear_design``), the plain version, and ``F.linear`` on the
   dequantized bf16 weight (cuBLAS, the yardstick); the bound is
   max(bytes over 3.35 TB/s, FLOPs over 989 TFLOP/s).  The kernels line
   reports the sums over one layer's seven projections at M = 8 and, as
   ``prefill_layer``, at M = 15360, and the main path's launches by
   design (phase 15 (d)).  GPT-2 small's layer (four 768 -> 768
   projections, 768 -> 3072, 3072 -> 768) is checked and timed the same
   way at M = 4 and 1024, phase 13f's decode and prefill rows.

The last lines are the card's ``nvidia-smi`` line, one ``{"kernels":
[...]}`` JSON object (the paged entry with phase 6i's and 6j's launches
and held calls; each decode entry with a ``device_pos`` record of
its own mode: phase 16's device-form cases and times, and the launches
of the dense serve phase's flat run on that cache; the bf16 entry also
the launches of phase 15b's beam search and speculative draft, the int8
entry those of phase 6h's int8 gather run, and each its ``held_on_path``
calls of 15b or 6h; the flash forward entry phase 15b's prefill launches
and held calls; the flash entries also the BERT fine-tune's launches,
its held forward and backward calls and the BERT case's times, GPT-2's
and Llama's prefills and GPT-2's fused training; the fused-CE entries
GPT-2's training launches and held call; the flash and fused-CE entries
each worker's launches in phase 13a (b) and both workers' held calls,
and phase 13h's launches (``training_rest_launches``: (a)'s four steps,
and (c)'s per worker for each trainer) and its workers' held calls, and
phase 13i's per worker in each run (``async_ps_launches_per_worker``)
and its workers' held calls;
the bf16 decode entry GPT-2's
and Llama's launches, their held calls and the G = 1 case's times; the
int8 product GPT-2's launches by design and held calls), and ``{"ok":
true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
LLAMA_3_2_1B = dict(
    vocab_size=128256, num_layers=16, num_heads=32, num_kv_heads=8,
    d_model=2048, d_ff=8192, head_dim=64, norm="rmsnorm", norm_eps=1e-5,
    pos_emb="rope", rope_theta=500000.0, mlp="swiglu", tie_embeddings=True,
    rope_scaling=(("factor", 32.0), ("high_freq_factor", 4.0),
                  ("low_freq_factor", 1.0),
                  ("original_max_position_embeddings", 8192),
                  ("rope_type", "llama3")))
MAX_SEQ = 2048  # reduced from the config's 131072
BLOCK = 16
N_SLOTS = 8
PROMPT_LENS = (32, 96, 160, 224, 288, 352, 416, 512)
NEW_TOKENS = 32
TRAIN_REF = dict(vocab_size=1024, num_layers=2, num_heads=4, num_kv_heads=2,
                 d_model=256, d_ff=1024, head_dim=64, max_seq_len=256)
TRAIN_B = 4           # full-width training batch (x MAX_SEQ tokens)
TRAIN_TIMED = 5       # timed steps after one warm-up step
GRAD_TOL = 1e-4       # flash vs local step-1 gradients, of max |g|
KERNEL_SOURCES = ("paged_attention", "flash_attention", "fused_cross_entropy",
                  "decode_attention", "quant_dot")
EVAL_TOL = 1e-3       # fused vs plain head at full width, bf16, relative
GEN_B = 8             # full-width generation: slots
GEN_PROMPT = 1920     # prompt tokens (+ GEN_NEW = MAX_SEQ)
GEN_NEW = 128         # new tokens
INT8_BF16_ULPS = 2    # paged int8 mode, bf16 q: ulps of each row's max


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _line(obj) -> None:
    print(json.dumps(obj), flush=True)


def _clock_under(torch, fn, seconds=2.0):
    """Median SM clock (MHz) and power draw (W) that ``nvidia-smi`` reads
    every 50 ms while ``fn`` runs back to back for ``seconds`` (None where
    it read nothing)."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    rows = []
    for ln in out.splitlines()[2:]:   # the first reads may precede fn
        try:
            rows.append(tuple(float(v) for v in ln.split(",")))
        except ValueError:
            continue
    if not rows:
        return {"sm_mhz": None, "power_w": None, "samples": 0}
    mid = len(rows) // 2
    return {"sm_mhz": sorted(r[0] for r in rows)[mid],
            "power_w": sorted(r[1] for r in rows)[mid],
            "samples": len(rows)}


# ----------------------------------------------------------------- build


def _ptxas_entries(log: str) -> dict:
    """ptxas ``-v``'s report per kernel entry: ``{mangled name: {"registers":
    n, "spill_stores": bytes, "spill_loads": bytes}}``."""
    import re

    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


FLASH_MMA_KERNELS = ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
                     "flash_bwd_dkv_mma_kernel")
FCE_TMA_KERNELS = ("fce_fwd_tma_kernel", "fce_dlogits_tma_kernel",
                   "fce_dx_tma_kernel", "fce_dw_tma_kernel")
DECODE_RING_KERNEL = "decode_ring_kernel"
QUANT_KERNELS = ("quant_swap_kernel", "quant_tma_kernel")


def ptxas_phase(logs: dict) -> dict:
    """Registers and spills of the paged kernel, the bf16 flash kernels
    on tensor cores (forward, dq and dk/dv, ``flash_*_mma_kernel<D>``),
    per instantiation, the fused-CE kernels on TMA and wgmma (forward,
    dlogits, dx, dW) and the decode kernel on tensor cores
    (``decode_ring_kernel<cache, D, row tiles>``) and the int8 product's
    swap (``quant_swap_kernel<row fragments>``) and tma kernels; none of
    the flash three may spill at head_dim 64 or 128, none of the fused-CE
    four or the int8 ones at all, and no decode instantiation of one row
    tile (up to 16 query heads a KV head: every model the port runs; two
    row tiles at head_dim 128 hold 256 fp32 accumulators a thread and
    may)."""
    info = {"phase": "ptxas"}
    for src, keys in (("paged_attention", ("paged_attention_kernel",)),
                      ("flash_attention", FLASH_MMA_KERNELS),
                      ("fused_cross_entropy", FCE_TMA_KERNELS),
                      ("decode_attention", (DECODE_RING_KERNEL,)),
                      ("quant_dot", QUANT_KERNELS)):
        if src not in logs:  # built by an earlier run: no report here
            info[src] = "built earlier; no ptxas report in this process"
            continue
        info[src] = {n: r for n, r in _ptxas_entries(logs[src]).items()
                     if any(key in n for key in keys)}
        for key in keys:
            if not any(key in n for n in info[src]):
                raise AssertionError(f"no {key} in the {src} ptxas report")
    for name, r in (info["flash_attention"].items()
                    if isinstance(info["flash_attention"], dict) else ()):
        # the mangled name carries D as its template argument: Li64E
        if ("Li64E" in name or "Li128E" in name) and (
                r.get("spill_stores") or r.get("spill_loads")):
            raise AssertionError(f"{name} spills: {r}")
    for src in ("fused_cross_entropy", "quant_dot"):
        for name, r in (info[src].items() if isinstance(info[src], dict)
                        else ()):
            if r.get("spill_stores") or r.get("spill_loads"):
                raise AssertionError(f"{name} spills: {r}")
    for name, r in (info["decode_attention"].items()
                    if isinstance(info["decode_attention"], dict) else ()):
        # the last template argument, the row tiles: ...Li1EE
        if "Li1EE" in name and (r.get("spill_stores")
                                or r.get("spill_loads")):
            raise AssertionError(f"{name} spills: {r}")
    return info


# ------------------------------------------------------------- reference


def _ref_model(torch, seed):
    """Phase 3's small fp32 Llama-shaped model (attention ``local``)."""
    from byteps_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, init_weights)

    cfg = TransformerConfig(
        **{**LLAMA_3_2_1B, "vocab_size": 1000, "num_layers": 2,
           "num_heads": 8, "num_kv_heads": 2, "d_model": 512,
           "d_ff": 1024, "max_seq_len": 256, "tie_embeddings": False},
        dtype=torch.float32)
    model = Transformer(cfg, device="cuda")
    init_weights(model, seed)
    return model


def reference_phase(torch, seed: int) -> dict:
    """Paged engine (kernel decode) vs a plain dense-cache greedy loop on
    a small fp32 Llama-shaped model: tokens must be identical."""
    import numpy as np

    from byteps_tpu_torch.models.transformer import init_cache
    from byteps_tpu_torch.serving import ServeMetrics, ServingEngine

    model = _ref_model(torch, seed)
    cfg = model.cfg
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)) for n in
               (20, 37, 64, 90)]
    n_new = 16
    want = []
    for p in prompts:
        caches = init_cache(cfg, 1, len(p) + n_new, device="cuda")
        tok = torch.tensor(p[None], device="cuda")
        logits, _ = model.decode(tok, caches, 0, last_only=True)
        out = []
        for i in range(n_new):
            nxt = int(torch.argmax(logits[0, -1]).item())
            out.append(nxt)
            if i + 1 < n_new:
                logits, _ = model.decode(
                    torch.tensor([[nxt]], device="cuda"), caches,
                    len(p) + i)
        want.append(out)
    eng = ServingEngine(model, n_slots=4, max_seq=256, paged=True,
                        block=BLOCK, device="cuda", metrics=ServeMetrics())
    reqs = [eng.submit(p, n_new) for p in prompts]
    eng.drain(timeout=300)
    got = [r.result().tolist() for r in reqs]
    if got != want:
        raise AssertionError(f"paged engine tokens {got} != dense "
                             f"reference {want}")
    # the sampled path (temperature, top-k, top-p, the (seed, k) noise
    # chain): two engines, same seeds, must give the same streams
    sampled = []
    for _ in range(2):
        eng_s = ServingEngine(model, n_slots=4, max_seq=256, paged=True,
                              block=BLOCK, temperature=0.8, top_k=50,
                              top_p=0.95, device="cuda",
                              metrics=ServeMetrics())
        reqs = [eng_s.submit(p, n_new, seed=100 + i)
                for i, p in enumerate(prompts)]
        eng_s.drain(timeout=300)
        sampled.append([r.result().tolist() for r in reqs])
    if sampled[0] != sampled[1]:
        raise AssertionError("seeded sampled streams did not repeat")
    if any(len(t) != n_new or not all(0 <= x < cfg.vocab_size for x in t)
           for t in sampled[0]):
        raise AssertionError(f"bad sampled stream: {sampled[0]}")
    return {"phase": "reference", "requests": len(prompts),
            "new_tokens": n_new, "tokens_identical": True,
            "decode_ticks": eng.decode_ticks,
            "sampled_rerun_identical": True,
            "sampled_differs_from_greedy": sampled[0] != got}


# ----------------------------------------------------------------- serve


def _serve_requests(torch, addr, prompts, vocab):
    """Phase 4's traffic: one ``RemoteServeClient`` a prompt, all at once,
    each asking for ``NEW_TOKENS`` greedy tokens from the frontend at
    ``addr``; returns the tokens (checked for shape and range) and the
    wall seconds until the last answer."""
    from byteps_tpu_torch.serving import RemoteServeClient

    results = [None] * len(prompts)
    errors = []

    def one(i):
        try:
            c = RemoteServeClient(addr, timeout=600)
            try:
                results[i] = c.generate(prompts[i], NEW_TOKENS)
            finally:
                c.close()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t1 = time.perf_counter()
    workers = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    if errors:
        raise errors[0]
    if any(w.is_alive() for w in workers):
        raise AssertionError("a serve request did not finish")
    for r in results:
        if r is None or r.shape != (NEW_TOKENS,):
            raise AssertionError(f"bad result shape: {r}")
        if r.min() < 0 or r.max() >= vocab:
            raise AssertionError("token id out of range")
    return results, wall


def serve_phase(torch, seed: int):
    import numpy as np

    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)
    from byteps_tpu_torch.ops import paged_attention as pa
    from byteps_tpu_torch.serving import ServeMetrics, ServingEngine, serve
    from byteps_tpu_torch.serving import metrics as sm

    cfg = TransformerConfig(**LLAMA_3_2_1B, max_seq_len=MAX_SEQ,
                            dtype=torch.bfloat16)
    t0 = time.perf_counter()
    # serving keeps its weights in bf16 (no per-tick casts)
    model = Transformer(cfg, device="cuda", param_dtype=torch.bfloat16)
    init_weights(model, seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    engine = ServingEngine(model, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                           paged=True, block=BLOCK, device="cuda",
                           metrics=ServeMetrics())
    pool_bytes = sum(t.numel() * t.element_size()
                     for layer in engine.pool.caches for t in layer.values())
    on_gpu = (all(p.is_cuda for p in model.parameters())
              and all(t.is_cuda for layer in engine.pool.caches
                      for t in layer.values()))
    if not on_gpu:
        raise AssertionError("model or KV pool is not on the GPU")
    setup_s = time.perf_counter() - t0
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in PROMPT_LENS]
    srv, thread = serve(engine, 0, host="127.0.0.1", in_thread=True)
    addr = f"127.0.0.1:{srv.server_address[1]}"
    runs = []
    try:
        for run in range(2):
            engine.metrics = ServeMetrics()
            ticks0 = engine.decode_ticks
            pa.launches = 0
            pa.plain_calls = 0
            results, wall = _serve_requests(torch, addr, prompts,
                                            cfg.vocab_size)
            launches, plain = pa.launches, pa.plain_calls
            ticks = engine.decode_ticks - ticks0
            if launches != ticks * cfg.num_layers or ticks == 0:
                raise AssertionError(
                    f"paged_attention launches {launches} != decode "
                    f"ticks {ticks} x {cfg.num_layers} layers")
            if plain:
                raise AssertionError(f"{plain} attention calls ran the "
                                     f"plain version on the CPU")
            summ = engine.metrics.summary()
            runs.append({
                "run": run, "results": results, "launches": launches,
                "decode_ticks": ticks, "wall_s": wall,
                "tokens_per_s": NEW_TOKENS * len(prompts) / wall,
                "ttft_p50_ms": summ["ttft_p50_s"] * 1e3,
                "ttft_p99_ms": summ["ttft_p99_s"] * 1e3,
                "tpot_p50_ms": summ["tpot_p50_s"] * 1e3,
                "tpot_p99_ms": summ["tpot_p99_s"] * 1e3,
                "completed": summ.get(sm.COMPLETED, 0)})
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    for a, b in zip(runs[0]["results"], runs[1]["results"]):
        if not np.array_equal(a, b):
            raise AssertionError("greedy rerun is not token-identical")
    final_pos = [n + NEW_TOKENS - 2 for n in PROMPT_LENS]
    info = {"phase": "serve", "model": "Llama-3.2-1B (random weights)",
            "source": "meta-llama/Llama-3.2-1B config.json",
            "reduced": {"max_seq": [131072, MAX_SEQ]},
            "dtype": "bfloat16", "params": n_params,
            "kv_pool_bytes": pool_bytes,
            "kv_blocks": engine.pool.block_stats()["n_blocks"],
            "setup_s": setup_s, "rerun_identical": True,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    for r in runs:
        info[f"run{r['run']}"] = {k: v for k, v in r.items()
                                  if k not in ("run", "results")}
    del model, engine
    torch.cuda.empty_cache()
    return info, runs[-1]["launches"], final_pos, runs[-1]["results"]


# ---------------------------------------------------------------- kernel


def _kernel_case(torch, np, seed, pos, tq, dtype, H, KV, D, quant=False):
    """q, pools, null-padded tables and cursors at the serving shapes; an
    int8 pool is the fp pool quantized per (position, KV head) with its
    scale pools, the scale rows past each cursor a stale tenant's (1e30:
    the mask must keep them out)."""
    from byteps_tpu_torch.models.transformer import _quantize_kv

    mb = MAX_SEQ // BLOCK
    n_blocks = N_SLOTS * mb + 1
    rng = np.random.RandomState(seed)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q = torch.randn((N_SLOTS, tq, H, D), generator=g, device="cuda")
    ck = torch.randn((n_blocks, BLOCK, KV * D), generator=g, device="cuda")
    cv = torch.randn((n_blocks, BLOCK, KV * D), generator=g, device="cuda")
    table = np.zeros((N_SLOTS, mb), np.int32)  # null-padded tails
    ids = iter(rng.permutation(np.arange(1, n_blocks)))
    for b, p in enumerate(pos):
        for j in range(-(-(p + tq) // BLOCK)):
            table[b, j] = next(ids)
    posv = torch.tensor(pos, dtype=torch.int32, device="cuda")
    tab = torch.from_numpy(table).cuda()
    if not quant:
        return q.to(dtype), ck.to(dtype), cv.to(dtype), tab, posv, {}
    scales = {}
    pools = []
    for name, c in (("k_scale", ck), ("v_scale", cv)):
        qv, sc = _quantize_kv(c.view(n_blocks, BLOCK, KV, D))
        sc[0] = 1e30
        for b, p in enumerate(pos):
            last = p + tq - 1
            sc[table[b, last // BLOCK], last % BLOCK + 1:] = 1e30
        pools.append(qv.view(n_blocks, BLOCK, KV * D))
        scales[name] = sc
    return q.to(dtype), pools[0], pools[1], tab, posv, scales


def _time_ms(torch, fn, flush, iters=20) -> float:
    """ms per call by CUDA events around each call (L2 flushed first) —
    for the paged plain version, which syncs to size its gather and so
    cannot be captured in a CUDA graph."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()  # evict the 50 MB L2: decode finds the pool cold
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def _bound(pa, q, pos, tq, window, elt, dtype_name, KV, quant=False):
    B, _, H, D = q.shape
    KVD = KV * D
    nbytes = (pa.kv_bytes_read(pos, tq, BLOCK, KVD, elt, window,
                               kv_heads=KV if quant else 0)
              + 2 * q.numel() * q.element_size()         # q in, out
              + 4 * len(pos)                             # pos
              + 4 * sum(-(-(p + tq) // BLOCK) for p in pos))  # table
    keys = 0
    for p in pos:
        for i in range(tq):
            lo = max(p + i - window + 1, 0) if window else 0
            keys += p + i - lo + 1
    flops = 4 * H * D * keys                             # QK^T and PV
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def _shard_pools(t, tp):
    """A flat pool (or scale pool) ``[n, block, X]`` cut head-major into
    per-shard pools ``[tp, n, block, X/tp]``."""
    n, blk, x = t.shape
    return t.reshape(n, blk, tp, x // tp).permute(2, 0, 1, 3).contiguous()


def _row_ulps(torch, out, ref) -> float:
    """The largest ``|out - ref|`` in bf16 ulps of its row's largest
    reference magnitude (a row: one query head's D outputs; 8 significant
    bits, so the ulp of [2^e, 2^(e+1)) is 2^(e-7))."""
    top = ref.float().abs().amax(dim=-1, keepdim=True).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return ((out.float() - ref.float()).abs() / ulp).max().item()


def kernel_case(torch, np, name, pos, tq, window, dtype, seed, flush,
                H=32, KV=8, D=64, quant=False, tps=(), timed=True):
    """One paged-attention case against the plain version: fp pools, or
    int8 pools (``quant``) with a q of ``dtype``; with ``tps``, the tp
    wrapper on the same bytes cut into shards must give the unsharded
    launch's output bit for bit.  ``timed``: device ms per call of the
    kernel (and the tp=2 wrapper) and of SDPA on pre-gathered
    (dequantized) rows from CUDA graphs, the plain version's by events."""
    import torch.nn.functional as F

    from byteps_tpu_torch.ops import paged_attention as pa

    dname = str(dtype).split(".")[-1]
    mode = "int8" if quant else dname
    q, ck, cv, table, posv, kw = _kernel_case(torch, np, seed, pos, tq,
                                              dtype, H, KV, D, quant)
    out = pa.paged_attention(q, ck, cv, table, posv, window=window, **kw)
    ref = pa.paged_attention_reference(q, ck, cv, table, posv,
                                       window=window, **kw)
    # int8 with a bf16 q: both sides round p and the output to bf16 at the
    # same points, so each row differs by about one ulp of its magnitude
    ulps = quant and dtype == torch.bfloat16
    tol = (INT8_BF16_ULPS if ulps else
           1e-4 if dtype == torch.float32 else 2e-2)

    def reading(got):
        return (_row_ulps(torch, got, ref) if ulps else
                (got.float() - ref.float()).abs().max().item())

    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.isfinite(out.float()).all() or reading(out) > tol:
        raise AssertionError(f"{name} {mode} q {dname}: max abs err {err} "
                             f"(reading {reading(out)}) > {tol}")
    res = {"case": name, "mode": mode, "q_dtype": dname, "tq": tq,
           "window": window, "heads": [H, KV, D], "max_err": err,
           "tolerance": (f"{tol} bf16 ulps of the row's max |ref|" if ulps
                         else tol)}
    if ulps:
        res["max_err_row_ulps"] = reading(out)
    sharded = {}
    for tp in tps:
        spools = [_shard_pools(t, tp) for t in (ck, cv)]
        skw = {k: _shard_pools(v, tp) for k, v in kw.items()}
        sharded[tp] = (spools, skw)
        before = pa.launches
        got = pa.paged_attention_sharded(q, *spools, table, posv,
                                         window=window, **skw)
        torch.cuda.synchronize()
        if pa.launches != before + 1:  # one launch serves every shard
            raise AssertionError(f"{name}: tp={tp} made "
                                 f"{pa.launches - before} launches")
        res[f"tp{tp}_bit_identical"] = bool(torch.equal(got, out))
        res[f"tp{tp}_max_err"] = (got.float() - ref.float()).abs().max().item()
        if reading(got) > tol:
            raise AssertionError(f"{name} tp={tp}: max abs err "
                                 f"{res[f'tp{tp}_max_err']} (reading "
                                 f"{reading(got)}) > {tol}")
    if not timed:
        return res
    # the yardstick: SDPA over the same keys gathered into dense rows
    # (int8: dequantized to q's dtype)
    B = q.shape[0]
    nb = -(-(max(pos) + tq) // BLOCK)
    S = nb * BLOCK
    idx = table[:, :nb].long()
    kd = ck[idx].reshape(B, S, KV, D)
    vd = cv[idx].reshape(B, S, KV, D)
    if quant:
        kd = (kd.float() * kw["k_scale"][idx].reshape(B, S, KV, 1)).to(dtype)
        vd = (vd.float() * kw["v_scale"][idx].reshape(B, S, KV, 1)).to(dtype)
    kd, vd = (x.transpose(1, 2).contiguous() for x in (kd, vd))
    qd = q.transpose(1, 2).contiguous()
    c = torch.arange(S, device="cuda")
    qpos = posv.long()[:, None] + torch.arange(tq, device="cuda")[None]
    mask = c[None, None, :] <= qpos[:, :, None]
    if window:
        mask = mask & (c[None, None, :] > qpos[:, :, None] - window)
    mask = mask[:, None]                                 # [B, 1, tq, S]
    lib = F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                         enable_gqa=True)
    res["library_err"] = (lib.transpose(1, 2).float()
                          - ref.float()).abs().max().item()
    res["kernel_ms"] = _graph_ms(torch, lambda: pa.paged_attention(
        q, ck, cv, table, posv, window=window, **kw), flush)
    if 2 in sharded:
        spools, skw = sharded[2]
        res["tp2_ms"] = _graph_ms(torch, lambda: pa.paged_attention_sharded(
            q, *spools, table, posv, window=window, **skw), flush)
    res["plain_ms"] = _time_ms(torch, lambda: pa.paged_attention_reference(
        q, ck, cv, table, posv, window=window, **kw), flush, iters=5)
    res["library_ms"] = _graph_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True), flush)
    res["bound_ms"], res["bound_by"], res["bytes"] = _bound(
        pa, q, pos, tq, window, ck.element_size(), dname, KV, quant)
    return res


def kernel_phase(torch, seed: int, final_pos):
    import numpy as np

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rng = np.random.RandomState(seed)
    ragged = sorted(int(x) for x in rng.randint(1, 2048, size=N_SLOTS - 2))
    ragged = [1] + ragged + [2047]
    tq5 = [min(p, 2043) for p in ragged]
    cases = []
    for quant in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            # timed: every fp case, and the int8 mode with a bf16 q (the
            # serving dtype); the tp wrapper on the int8 cases
            timed = not quant or dtype == torch.bfloat16
            tps = (2, 4) if quant else ()
            for name, pos, tq, window in (
                    ("ragged_1_2047", ragged, 1, None),
                    ("all_at_2047", [2047] * N_SLOTS, 1, None),
                    ("ragged_tq5", tq5, 5, None),
                    ("all_at_2043_tq5", [2043] * N_SLOTS, 5, None),
                    ("ragged_window256", ragged, 1, 256),
                    ("ragged_tq5_window256", tq5, 5, 256)):
                cases.append(kernel_case(torch, np, name, pos, tq, window,
                                         dtype, seed, flush, quant=quant,
                                         tps=tps, timed=timed))
                _line(cases[-1])
            # the serve role's default model: 4 heads of 32, MHA
            cases.append(kernel_case(torch, np, "serve_default_head_dim32",
                                     ragged, 1, None, dtype, seed, flush,
                                     H=4, KV=4, D=32, quant=quant,
                                     tps=(2, 4) if quant else (),
                                     timed=timed))
            _line(cases[-1])
    main = kernel_case(torch, np, "serve_last_tick", final_pos, 1, None,
                       torch.bfloat16, seed, flush)
    _line(main)
    return cases, main


# ------------------------------------------------------------- serve role


PAGED_ROLE_ENV = {"BYTEPS_SERVE_PAGED": "1"}
SERVE_ROLE_PROMPT = tuple(i % 7 for i in range(1, 40))
SERVE_ROLE_NEW = 8


def serve_role_phase(torch, env) -> dict:
    """``DMLC_ROLE=serve`` with its defaults plus the knobs ``env``: the
    head_dim-32 model on the GPU, greedy reruns identical.  With no
    knobs the dense slot engine (grouped rows, attended in plain torch:
    no kernel launches); with ``BYTEPS_SERVE_PAGED=1`` the paged engine,
    decoding through its kernel; with the tiers' knobs too the second
    request is a prefix hit and every tick a verify pass over the
    tp-sharded int8 pool."""
    import os

    import numpy as np

    from byteps_tpu_torch.common.config import reset_config
    from byteps_tpu_torch.ops import decode_attention as da
    from byteps_tpu_torch.ops import paged_attention as pa
    from byteps_tpu_torch.serving import RemoteServeClient
    from byteps_tpu_torch.serving.frontend import serve_from_env

    os.environ.pop("BYTEPS_SERVE_MODEL", None)
    os.environ.pop("BYTEPS_SERVE_PAGED", None)
    paged = "BYTEPS_SERVE_PAGED" in env
    pa.launches = pa.plain_calls = 0
    da.launches = da.plain_calls = 0
    srv, thread = serve_from_env(env, port=0, in_thread=True)
    try:
        eng = srv.engine
        cfg = eng.model.cfg
        c = RemoteServeClient(f"127.0.0.1:{srv.server_address[1]}",
                              timeout=300)
        prompt = np.asarray(SERVE_ROLE_PROMPT, np.int32)
        a, b = (c.generate(prompt, SERVE_ROLE_NEW),
                c.generate(prompt, SERVE_ROLE_NEW))
        st = c.stats()
        c.close()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        for k in env:
            os.environ.pop(k, None)
        reset_config()
    torch.cuda.synchronize()
    if cfg.d_head != 32 or not st["device"].startswith("cuda"):
        raise AssertionError(f"serve role ran head_dim {cfg.d_head} on "
                             f"{st['device']}")
    counts = st["step_counts"]
    # paged: one launch per layer a tick at any tp; dense: grouped rows,
    # no kernel (the model's head_dim-32 attention in plain torch)
    want = counts["decode_ticks"] * cfg.num_layers if paged else 0
    if (a.shape != (SERVE_ROLE_NEW,) or not np.array_equal(a, b) or pa.plain_calls
            or da.plain_calls or pa.launches != want or da.launches
            or counts["decode_ticks"] == 0 or eng.paged != paged
            or (st["kv_blocks"] is None) == paged):
        raise AssertionError(f"serve role {env}: {a} / {b}, {pa.launches} "
                             f"paged and {da.launches} decode launches, "
                             f"{pa.plain_calls + da.plain_calls} plain, "
                             f"{counts}")
    info = {"phase": "serve_role", "env": env, "head_dim": cfg.d_head,
            "device": st["device"], "engine": "paged" if paged else "dense",
            "tokens_identical": True, "tokens": a.tolist(),
            "paged_launches": pa.launches, "step_counts": counts,
            "kv_blocks": st["kv_blocks"], "prefix_cache": st["prefix_cache"]}
    if "BYTEPS_TP" in env:
        pool = eng.pool.caches[0]["k"]
        if (eng.tp != int(env["BYTEPS_TP"]) or pool.shape[0] != eng.tp
                or pool.dtype != torch.int8
                or st["prefix_cache"]["hits"] < 1
                or counts["verify_ticks"] != counts["decode_ticks"]):
            raise AssertionError(f"serve role tiers: tp {eng.tp}, pool "
                                 f"{tuple(pool.shape)} {pool.dtype}, "
                                 f"{st['prefix_cache']}, {counts}")
    return info


# ------------------------------------------------------- serving tiers

TIERS_KV_MB = 513    # phase 4's 1025-block bf16 pool (537.4 MB), whole MiB
TIERS_SPEC_K = 4
TIERS_SHARED = 256   # shared prefix tokens of every prompt
TIERS_RUN = 8        # the run each prompt ends with, twice
TIERS_ROLE_ENV = {"BYTEPS_SERVE_KV_DTYPE": "int8", "BYTEPS_TP": "2",
                  "BYTEPS_SERVE_PREFIX_CACHE": "1", "BYTEPS_SERVE_SPEC": "1"}


def tiers_reference_phase(torch, seed: int) -> dict:
    """The serving tiers on the phase-3 fp32 model: int8 pools (kernel)
    vs a plain dense int8 loop; tp=2 vs tp=1 (fp and int8); prefix cache
    on vs off; speculation on vs off (greedy and seeded)."""
    import numpy as np

    from byteps_tpu_torch.inference import generate
    from byteps_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, init_cache, init_weights)
    from byteps_tpu_torch.ops import paged_attention as pa
    from byteps_tpu_torch.serving import ServeMetrics, ServingEngine

    cfg = TransformerConfig(
        **{**LLAMA_3_2_1B, "vocab_size": 1000, "num_layers": 2,
           "num_heads": 8, "num_kv_heads": 2, "d_model": 512,
           "d_ff": 1024, "max_seq_len": 256, "tie_embeddings": False},
        dtype=torch.float32)
    model = Transformer(cfg, device="cuda")
    init_weights(model, seed)
    rng = np.random.RandomState(seed + 7)
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)) for n in
               (20, 37, 64, 90)]
    n_new = 16

    def engine(**kw):
        return ServingEngine(model, n_slots=4, max_seq=256, paged=True,
                             block=BLOCK, device="cuda",
                             metrics=ServeMetrics(), **kw)

    def run(eng, ps, seeds=None, one_by_one=False):
        reqs = []
        for i, p in enumerate(ps):
            reqs.append(eng.submit(p, n_new, seed=seeds[i] if seeds else 0))
            if one_by_one:
                eng.drain(timeout=300)
        eng.drain(timeout=300)
        return [r.result().tolist() for r in reqs]

    # the plain int8 loop: the prompt quantized at write and attended as
    # int8 like every later step (the paged chunk's rule), no kernel
    want = []
    for p in prompts:
        caches = init_cache(cfg, 1, len(p) + n_new, quantized=True,
                            layout="grouped", device="cuda")
        logits, _ = model.decode(torch.tensor(p[None], device="cuda"),
                                 caches, 0, last_only=True,
                                 fresh_prefill=False)
        out = []
        for i in range(n_new):
            out.append(int(torch.argmax(logits[0, -1]).item()))
            if i + 1 < n_new:
                logits, _ = model.decode(
                    torch.tensor([[out[-1]]], device="cuda"), caches,
                    len(p) + i)
        want.append(out)
    info = {"phase": "tiers_reference"}
    launches0 = pa.launches
    int8 = run(engine(kv_dtype="int8"), prompts)
    if int8 != want:
        raise AssertionError(f"int8 engine {int8} != plain int8 loop {want}")
    if pa.launches == launches0:
        raise AssertionError("the int8 engine launched no kernel")
    # generate(kv_quant=True) attends its prompt unquantized (JAX's
    # static pos=0 path), so it may differ from the int8 pool: reported
    gq = generate(model, np.stack([np.asarray(p) for p in prompts[:1]]),
                  n_new, temperature=0.0, kv_quant=True,
                  cache_layout="grouped")["tokens"]
    info["generate_kv_quant_identical"] = gq[0].tolist() == int8[0]
    info["int8_vs_plain_loop_identical"] = True
    fp = run(engine(), prompts)
    for kv in ("", "int8"):
        base = fp if not kv else int8
        if run(engine(kv_dtype=kv, tp=2), prompts) != base:
            raise AssertionError(f"tp=2 ({kv or 'fp'}) != tp=1")
    info["tp2_identical"] = True
    shared = rng.randint(0, cfg.vocab_size, size=(64,))
    prefixed = [np.concatenate([shared, p[:10]]) for p in prompts]
    eng_p = engine(prefix_cache=True, kv_dtype="int8")
    got = run(eng_p, prefixed, one_by_one=True)
    if got != run(engine(kv_dtype="int8"), prefixed):
        raise AssertionError("prefix cache on != off")
    if eng_p.prefix_hits < 3:
        raise AssertionError(f"{eng_p.prefix_hits} prefix hits")
    info["prefix_identical"] = True
    info["prefix_hits"] = eng_p.prefix_hits
    rep = [np.tile(p[:8], 4) for p in prompts]
    for kv in ("", "int8"):
        eng_s = engine(spec_k=TIERS_SPEC_K, kv_dtype=kv)
        if run(eng_s, rep) != run(engine(kv_dtype=kv), rep):
            raise AssertionError(f"spec on != off ({kv or 'fp'}, greedy)")
        info[f"spec_counts_{kv or 'fp'}"] = eng_s.step_counts()
    kw = dict(temperature=0.8, top_k=50, top_p=0.95)
    seeds = [100 + i for i in range(len(rep))]
    on = run(engine(spec_k=TIERS_SPEC_K, **kw), rep, seeds)
    if on != run(engine(**kw), rep, seeds):
        raise AssertionError("spec on != off (seeded)")
    info["spec_identical"] = {"greedy": True, "seeded": True}
    del model
    torch.cuda.empty_cache()
    return info


def _tiers_prompts(np, vocab, seed):
    """9 base prompts (a warm one, then 8): a shared 256-token prefix,
    64-256 unique tokens, and an 8-token run repeated twice."""
    rng = np.random.RandomState(seed + 11)
    shared = rng.randint(0, vocab, size=(TIERS_SHARED,))
    out = []
    for n in np.linspace(64, 256, 9).astype(int):
        run = rng.randint(0, vocab, size=(TIERS_RUN,))
        out.append(np.concatenate([shared, rng.randint(0, vocab, size=(n,)),
                                   run, run]).astype(np.int32))
    return out[0], out[1:]


def _tiers_engine(model, tp):
    from byteps_tpu_torch.serving import ServeMetrics, ServingEngine

    return ServingEngine(model, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                         paged=True, block=BLOCK, kv_mb=TIERS_KV_MB,
                         kv_dtype="int8",
                         tp=tp, prefix_cache=True, spec_k=TIERS_SPEC_K,
                         device="cuda", metrics=ServeMetrics())


class _ReplayProposer:
    """Proposes each request's reference answer (a first run's tokens) —
    the accept path at full width.  Random weights never accept their
    own n-gram proposals: their near-tied logits make the answer change
    with any change of its context, so no copy of it can sit in a
    prompt.  Every row of a verify pass is computed as it would be
    alone, so replayed proposals must be accepted and must give the
    reference tokens.  ``k`` is the engine's proposer's."""

    def __init__(self, k, prompts, answers):
        self.k = k
        self._ref = {p.tobytes(): a for p, a in zip(prompts, answers)}
        self._lens = sorted({len(p) for p in prompts})

    def propose(self, context, max_tokens):
        for n in self._lens:
            ans = self._ref.get(context[:n].tobytes())
            if ans is not None:
                break
        else:
            return []
        done = len(context) - n                    # tokens emitted so far
        if not (context[n:] == ans[:done]).all():
            return []
        return [int(t) for t in ans[done:done + min(self.k, max_tokens)]]


def _tiers_run(torch, np, model, prompts, warm, tp, replay=None):
    """One engine (int8 pool, prefix cache, speculation, tp) behind a
    ServeFrontend: the warm request, then 8 concurrent ones; the kernel
    counts set to 0 just before and read just after.  ``replay`` (the
    first run's answers) swaps the n-gram proposer for a
    :class:`_ReplayProposer`, whose proposals must be accepted."""
    from byteps_tpu_torch.ops import paged_attention as pa
    from byteps_tpu_torch.serving import RemoteServeClient, serve

    engine = _tiers_engine(model, tp)
    if replay is not None:
        engine.spec = _ReplayProposer(engine.spec.k, [warm] + prompts,
                                      replay)
    if not all(t.is_cuda for layer in engine.pool.caches
               for t in layer.values()):
        raise AssertionError("KV pool is not on the GPU")
    srv, thread = serve(engine, 0, host="127.0.0.1", in_thread=True)
    addr = f"127.0.0.1:{srv.server_address[1]}"
    results = [None] * len(prompts)
    errors = []

    def one(i):
        try:
            c = RemoteServeClient(addr, timeout=600)
            try:
                results[i] = c.generate(prompts[i], NEW_TOKENS)
            finally:
                c.close()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    try:
        pa.launches = 0
        pa.plain_calls = 0
        c = RemoteServeClient(addr, timeout=600)
        warm_out = c.generate(warm, NEW_TOKENS)
        c.close()
        t1 = time.perf_counter()
        workers = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches, plain = pa.launches, pa.plain_calls
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    if errors:
        raise errors[0]
    if any(w.is_alive() for w in workers):
        raise AssertionError("a serve request did not finish")
    cfg = model.cfg
    for r in [warm_out] + results:
        if r is None or r.shape != (NEW_TOKENS,) or r.min() < 0 \
                or r.max() >= cfg.vocab_size:
            raise AssertionError(f"bad result: {r}")
    counts = engine.step_counts()
    if (launches != counts["decode_ticks"] * cfg.num_layers  # any tp
            or counts["verify_ticks"] != counts["decode_ticks"] or plain
            or (replay is not None and not counts["spec_accepted"])):
        raise AssertionError(f"tp={tp}: {launches} launches, {plain} plain "
                             f"calls, {counts}")
    if counts["prefix_hits"] < len(prompts):
        raise AssertionError(f"{counts['prefix_hits']} prefix hits")
    summ = engine.metrics.summary()
    final_pos = [len(p) + NEW_TOKENS - 2 for p in prompts]
    out = {"tp": tp, "proposer": "ngram" if replay is None else "replay",
           "results": [warm_out] + results, "launches": launches,
           "step_counts": counts, "wall_s": wall,
           "tokens_per_s": NEW_TOKENS * len(prompts) / wall,
           "ttft_p50_ms": summ["ttft_p50_s"] * 1e3,
           "ttft_p99_ms": summ["ttft_p99_s"] * 1e3,
           "tpot_p50_ms": summ["tpot_p50_s"] * 1e3,
           "tpot_p99_ms": summ["tpot_p99_s"] * 1e3,
           "spec_acceptance": (counts["spec_accepted"]
                               / max(counts["spec_proposed"], 1)),
           "kv_blocks": engine.pool.block_stats(),
           "prefix_cache": engine.prefix.stats(), "final_pos": final_pos}
    del engine
    torch.cuda.empty_cache()
    return out


def tiers_serve_phase(torch, seed: int):
    """The main path of the tiers slice at full width: Llama-3.2-1B bf16
    behind a ServeFrontend on an int8 pool with the prefix cache and
    speculation, twice at tp=1 (fresh engines: identical tokens), then
    at tp=2 (identical to tp=1)."""
    import numpy as np

    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)

    cfg = TransformerConfig(**LLAMA_3_2_1B, max_seq_len=MAX_SEQ,
                            dtype=torch.bfloat16)
    model = Transformer(cfg, device="cuda", param_dtype=torch.bfloat16)
    init_weights(model, seed)
    warm, prompts = _tiers_prompts(np, cfg.vocab_size, seed)
    runs = [_tiers_run(torch, np, model, prompts, warm, tp) for tp in (1, 2)]
    ref = runs[0]["results"]
    runs += [_tiers_run(torch, np, model, prompts, warm, tp, replay=ref)
             for tp in (1, 2)]
    for r in runs[1:]:
        for a, b in zip(ref, r["results"]):
            if not np.array_equal(a, b):
                raise AssertionError(f"tp={r['tp']} run is not "
                                     f"token-identical to the first")
    bf16_block = cfg.num_layers * 2 * BLOCK * cfg.kv_heads * cfg.d_head * 2
    info = {"phase": "tiers_serve", "model": "Llama-3.2-1B (random weights)",
            "source": "meta-llama/Llama-3.2-1B config.json",
            "reduced": {"max_seq": [131072, MAX_SEQ]}, "dtype": "bfloat16",
            "kv_mb": TIERS_KV_MB, "spec_k": TIERS_SPEC_K,
            "prompt_lens": [len(warm)] + [len(p) for p in prompts],
            "int8_blocks": runs[0]["kv_blocks"]["n_blocks"],
            "bf16_blocks": (TIERS_KV_MB << 20) // bf16_block,
            "rerun_identical": True, "tp2_identical": True,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    info["blocks_ratio"] = info["int8_blocks"] / info["bf16_blocks"]
    for i, r in enumerate(runs):
        info[f"run{i}_tp{r['tp']}_{r['proposer']}"] = {
            k: v for k, v in r.items() if k not in ("results", "final_pos")}
    del model
    torch.cuda.empty_cache()
    return info, runs[0], runs[1]


def tiers_kernel_phase(torch, seed: int, final_pos) -> dict:
    """The int8 mode and the tp=2 wrapper at the tiers run's last decode
    cursors (bf16 q): the kernels line's row-8 int8 and tp entries."""
    import numpy as np

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    main = kernel_case(torch, np, "tiers_last_tick", final_pos, 1, None,
                       torch.bfloat16, seed, flush, quant=True, tps=(2,))
    _line(main)
    return main


# ------------------------------------------------------------- dense slots

# the dense engine's runs (name, engine options, reference): the fp runs
# against the plain fp loop and the paged engine, the int8 ones against a
# plain int8 loop (the dense kv_quant prefill attends the prompt before
# quantization, as in JAX, which the paged int8 pool does not)
DENSE_REF_RUNS = (("grouped", {}, "fp"),
                  ("flat", {"cache_layout": "flat"}, "fp"),
                  ("chunk8", {"chunk": 8}, "fp"),
                  ("flat_int8", {"cache_layout": "flat", "kv_quant": True},
                   "int8"),
                  ("grouped_int8", {"kv_quant": True}, "int8"))


def dense_reference_phase(torch, seed: int) -> dict:
    """The dense slot engine on phase 3's fp32 model: grouped rows, flat
    rows (the decode kernel at a position vector, one launch a layer a
    tick), chunked prefill, and int8 rows flat and grouped; greedy
    tokens exactly those of a plain dense greedy loop (grouped rows, no
    kernel) and, for fp rows, of the paged engine."""
    import numpy as np

    from byteps_tpu_torch.models.transformer import init_cache
    from byteps_tpu_torch.ops import decode_attention as da
    from byteps_tpu_torch.serving import ServeMetrics, ServingEngine

    model = _ref_model(torch, seed)
    cfg = model.cfg
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)) for n in
               (20, 37, 64, 90)]
    n_new = 16

    def loop(quant):
        out = []
        for p in prompts:
            caches = init_cache(cfg, 1, len(p) + n_new, quantized=quant,
                                layout="grouped", device="cuda")
            logits, _ = model.decode(torch.tensor(p[None], device="cuda"),
                                     caches, 0, last_only=True)
            toks = []
            for i in range(n_new):
                toks.append(int(torch.argmax(logits[0, -1]).item()))
                if i + 1 < n_new:
                    logits, _ = model.decode(
                        torch.tensor([[toks[-1]]], device="cuda"), caches,
                        len(p) + i)
            out.append(toks)
        return out

    def engine_tokens(**kw):
        eng = ServingEngine(model, n_slots=4, max_seq=256, device="cuda",
                            metrics=ServeMetrics(), **kw)
        reqs = [eng.submit(p, n_new) for p in prompts]
        eng.drain(timeout=300)
        return [r.result().tolist() for r in reqs], eng

    want = {"fp": loop(False), "int8": loop(True)}
    _zero_counts()
    if da.launches or da.plain_calls:
        raise AssertionError("the plain loops called the decode kernel")
    paged, _ = engine_tokens(paged=True, block=BLOCK)
    if paged != want["fp"]:
        raise AssertionError(f"paged engine {paged} != loop {want['fp']}")
    info = {"phase": "dense_reference", "requests": len(prompts),
            "new_tokens": n_new, "paged_equals_loop": True}
    for name, kw, ref in DENSE_REF_RUNS:
        _zero_counts()
        got, eng = engine_tokens(**kw)
        torch.cuda.synchronize()
        ticks = eng.decode_ticks
        flat = kw.get("cache_layout") == "flat"
        want_launches = ticks * cfg.num_layers if flat else 0
        if (da.launches != want_launches or da.plain_calls
                or da.design_launches["device_pos"] != want_launches):
            raise AssertionError(f"dense {name}: {da.launches} decode "
                                 f"launches ({da.design_launches}), "
                                 f"{da.plain_calls} plain, {ticks} ticks")
        if got != want[ref]:
            raise AssertionError(f"dense {name}: tokens {got} != plain "
                                 f"{ref} loop {want[ref]}")
        info[name] = {"tokens_equal_loop": True, "decode_ticks": ticks,
                      "decode_launches": da.launches}
    del model
    torch.cuda.empty_cache()
    return info


def _flash_prefills(prompt_lens) -> int:
    """Whole-prompt prefills whose power-of-two bucket passes the flash
    gcd gate (``gcd(bucket, 1024) >= 128``)."""
    import math

    n = 0
    for t in prompt_lens:
        b = 8
        while b < t:
            b *= 2
        n += math.gcd(min(b, MAX_SEQ), 1024) >= 128
    return n


def dense_serve_phase(torch, seed: int, paged_info: dict):
    """The main path of the dense-engine slice: full-width Llama-3.2-1B in
    bf16 (``attn_impl="flash"``) on ``ServingEngine(paged=False)`` with 8
    slots of 2048 rows behind a ``ServeFrontend``, phase 4's 8 requests:
    flat rows twice, then grouped rows, then flat int8 rows.  Returns the
    phase line and the counts of the second flat run and of the int8
    run."""
    import numpy as np

    from byteps_tpu_torch.inference import classify_divergence
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)
    from byteps_tpu_torch.ops import decode_attention as da
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import paged_attention as pa
    from byteps_tpu_torch.serving import ServeMetrics, ServingEngine, serve

    cfg = TransformerConfig(**LLAMA_3_2_1B, max_seq_len=MAX_SEQ,
                            dtype=torch.bfloat16, attn_impl="flash")
    L = cfg.num_layers
    model = Transformer(cfg, device="cuda", param_dtype=torch.bfloat16)
    init_weights(model, seed)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in PROMPT_LENS]
    flash_want = _flash_prefills(PROMPT_LENS) * L
    runs = {}
    for name, layout, quant in (("flat", "flat", False),
                                ("flat_rerun", "flat", False),
                                ("grouped", "grouped", False),
                                ("flat_int8", "flat", True)):
        engine = ServingEngine(model, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                               cache_layout=layout, kv_quant=quant,
                               device="cuda", metrics=ServeMetrics())
        row_bytes = sum(t.numel() * t.element_size()
                        for layer in engine.pool.caches
                        for t in layer.values())
        srv, thread = serve(engine, 0, host="127.0.0.1", in_thread=True)
        try:
            torch.cuda.synchronize()
            _zero_counts()
            pa.launches = pa.plain_calls = 0
            results, wall = _serve_requests(
                torch, f"127.0.0.1:{srv.server_address[1]}", prompts,
                cfg.vocab_size)
            counts = {"decode": da.launches,
                      "decode_by_design": dict(da.design_launches),
                      "flash_fwd": fa.fwd_launches,
                      "plain": (da.plain_calls + fa.plain_calls
                                + pa.plain_calls),
                      "paged": pa.launches}
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=30)
        ticks = engine.decode_ticks
        want = ticks * L if layout == "flat" else 0
        if (counts["decode"] != want or ticks == 0
                or counts["decode_by_design"]["device_pos"] != want
                or counts["flash_fwd"] != flash_want or counts["plain"]
                or counts["paged"]):
            raise AssertionError(f"dense {name}: {counts}, {ticks} ticks; "
                                 f"want {want} decode and {flash_want} "
                                 f"flash launches")
        summ = engine.metrics.summary()
        runs[name] = {"results": results, "line": {
            "layout": layout, "kv_quant": quant, "row_bytes": row_bytes,
            "decode_ticks": ticks,
            "launches": counts, "wall_s": wall,
            "tokens_per_s": NEW_TOKENS * len(prompts) / wall,
            "ttft_p50_ms": summ["ttft_p50_s"] * 1e3,
            "ttft_p99_ms": summ["ttft_p99_s"] * 1e3,
            "tpot_p50_ms": summ["tpot_p50_s"] * 1e3,
            "tpot_p99_ms": summ["tpot_p99_s"] * 1e3}}
        del engine
        torch.cuda.empty_cache()
    for a, b in zip(runs["flat"]["results"], runs["flat_rerun"]["results"]):
        if not np.array_equal(a, b):
            raise AssertionError("dense flat rerun is not token-identical")
    verdicts = [classify_divergence(model, p[None], a[None], b[None])
                for p, a, b in zip(prompts, runs["flat"]["results"],
                                   runs["grouped"]["results"])]
    worst = max(verdicts, key=lambda v: ["none", "tie", "real"].index(
        v["divergence"]))
    if worst["divergence"] == "real":
        raise AssertionError(f"dense flat vs grouped: {worst}")
    info = {"phase": "dense_serve", "model": "Llama-3.2-1B (random weights)",
            "source": "meta-llama/Llama-3.2-1B config.json",
            "reduced": {"max_seq": [131072, MAX_SEQ]},
            "dtype": "bfloat16", "attn_impl": "flash", "slots": N_SLOTS,
            "rerun_identical": True,
            "flat_vs_grouped": worst["divergence"],
            "flat_vs_grouped_agreement": float(np.mean(
                [v["agreement"] for v in verdicts])),
            "nvidia_smi": _smi(),
            "paged_phase4_run1": {k: paged_info["run1"][k] for k in (
                "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms",
                "tpot_p50_ms", "tpot_p99_ms")},
            **{n: r["line"] for n, r in runs.items()}}
    del model
    torch.cuda.empty_cache()
    return info, {"bfloat16": runs["flat_rerun"]["line"]["launches"],
                  "int8": runs["flat_int8"]["line"]["launches"]}


# ----------------------------------------- dense prefix / spec, the gather

DENSE_TIERS_RUNS = (("prefix_spec", dict(prefix_cache=True,
                                         spec_k=TIERS_SPEC_K)),
                    ("prefix", dict(prefix_cache=True)),
                    ("spec", dict(spec_k=TIERS_SPEC_K)))
GATHER_RUNS = (("fp", {}), ("int8", dict(kv_dtype="int8")),
               ("int8_tp2", dict(kv_dtype="int8", tp=2)),
               ("fp_tp2", dict(tp=2)))


def dense_tiers_reference_phase(torch, seed: int) -> dict:
    """Phase 3's fp32 model: the dense engine (grouped rows) with the
    prefix store and speculation, together and alone, gives exactly the
    tokens of both off (prompts sharing 64 tokens, a repeated run for
    proposals; greedy, and seeded for speculation); the paged gather
    fallback (fp grouped pool, int8, int8 and fp at tp=2) gives exactly
    the tokens of a plain dense loop (fp, or int8 quantized at write),
    the int8 pool through the decode kernel at the slots' position
    vector, one launch a layer a tick, and no paged-kernel call."""
    import numpy as np

    from byteps_tpu_torch.models.transformer import init_cache
    from byteps_tpu_torch.ops import decode_attention as da
    from byteps_tpu_torch.ops import paged_attention as pa
    from byteps_tpu_torch.serving import ServeMetrics, ServingEngine

    model = _ref_model(torch, seed)
    cfg = model.cfg
    rng = np.random.RandomState(seed + 3)
    shared = rng.randint(0, cfg.vocab_size, size=(64,))
    prompts = [np.concatenate([shared, np.tile(rng.randint(
        0, cfg.vocab_size, size=(6,)), 3)[:n]]) for n in (7, 12, 18, 9)]
    n_new = 16

    def run(kw, seeds=None):
        eng = ServingEngine(model, n_slots=4, max_seq=256, device="cuda",
                            metrics=ServeMetrics(), **kw)
        reqs = []
        for i, p in enumerate(prompts):
            reqs.append(eng.submit(p, n_new, seed=seeds[i] if seeds else 0))
            eng.drain(timeout=300)   # one by one: later ones hit the store
        return [r.result().tolist() for r in reqs], eng

    info = {"phase": "dense_tiers_reference", "requests": len(prompts),
            "new_tokens": n_new}
    base, _ = run({})
    for name, kw in DENSE_TIERS_RUNS:
        got, eng = run(kw)
        c = eng.step_counts()
        if got != base:
            raise AssertionError(f"dense {name} on != off: {got} {base}")
        if kw.get("prefix_cache") and c["prefix_hits"] < 3:
            raise AssertionError(f"dense {name}: {c}")
        if kw.get("spec_k") and c["verify_ticks"] != c["decode_ticks"]:
            raise AssertionError(f"dense {name}: {c}")
        info[name] = {"identical_to_off": True, "step_counts": c}
    kw = dict(temperature=0.8, top_k=50, top_p=0.95)
    seeds = [100 + i for i in range(len(prompts))]
    if run(dict(spec_k=TIERS_SPEC_K, **kw), seeds)[0] != run(kw, seeds)[0]:
        raise AssertionError("dense spec on != off (seeded)")
    info["spec_seeded_identical"] = True

    def loop(quant):
        out = []
        for p in prompts:
            caches = init_cache(cfg, 1, len(p) + n_new, quantized=quant,
                                layout="grouped", device="cuda")
            logits, _ = model.decode(torch.tensor(p[None], device="cuda"),
                                     caches, 0, last_only=True,
                                     fresh_prefill=not quant)
            toks = []
            for i in range(n_new):
                toks.append(int(torch.argmax(logits[0, -1]).item()))
                if i + 1 < n_new:
                    logits, _ = model.decode(
                        torch.tensor([[toks[-1]]], device="cuda"), caches,
                        len(p) + i)
            out.append(toks)
        return out

    want = {"": loop(False), "int8": loop(True)}
    for name, kw in GATHER_RUNS:
        _zero_counts()
        pa.launches = pa.plain_calls = 0
        eng = ServingEngine(model, n_slots=4, max_seq=256, paged=True,
                            block=BLOCK, paged_kernel="off", device="cuda",
                            metrics=ServeMetrics(), **kw)
        reqs = [eng.submit(p, n_new) for p in prompts]
        eng.drain(timeout=300)
        torch.cuda.synchronize()
        got = [r.result().tolist() for r in reqs]
        ticks = eng.decode_ticks
        quant = bool(kw.get("kv_dtype"))
        dec = ticks * cfg.num_layers if quant else 0
        if (da.launches != dec or da.design_launches["device_pos"] != dec
                or da.plain_calls or pa.launches or pa.plain_calls):
            raise AssertionError(f"gather {name}: {da.launches} decode "
                                 f"launches ({da.design_launches}), "
                                 f"{da.plain_calls} plain, paged "
                                 f"{pa.launches}/{pa.plain_calls}, {ticks} "
                                 f"ticks")
        if got != want[kw.get("kv_dtype", "")]:
            raise AssertionError(f"gather {name}: {got} != plain loop")
        info[f"gather_{name}"] = {"tokens_equal_loop": True,
                                  "decode_ticks": ticks,
                                  "decode_launches": da.launches,
                                  "step_counts": eng.step_counts()}
    del model
    torch.cuda.empty_cache()
    return info


def _engine_run(torch, engine, prompts, warm=None):
    """Serve ``prompts`` (after ``warm``, alone) through a ServeFrontend
    over ``engine``, the kernel counts set to 0 just before and read just
    after: the tokens, the counts, and the run's latency line."""
    from byteps_tpu_torch.ops import decode_attention as da
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import paged_attention as pa
    from byteps_tpu_torch.serving import RemoteServeClient, serve

    if not all(t.is_cuda for layer in engine.pool.caches
               for t in layer.values()):
        raise AssertionError("KV cache is not on the GPU")
    srv, thread = serve(engine, 0, host="127.0.0.1", in_thread=True)
    addr = f"127.0.0.1:{srv.server_address[1]}"
    try:
        torch.cuda.synchronize()
        _zero_counts()
        pa.launches = pa.plain_calls = 0
        warm_out = []
        if warm is not None:
            c = RemoteServeClient(addr, timeout=600)
            warm_out = [c.generate(warm, NEW_TOKENS)]
            c.close()
        results, wall = _serve_requests(torch, addr, prompts,
                                        engine.model.cfg.vocab_size)
        counts = {"decode": da.launches,
                  "decode_by_design": dict(da.design_launches),
                  "flash_fwd": fa.fwd_launches, "paged": pa.launches,
                  "plain": da.plain_calls + fa.plain_calls + pa.plain_calls}
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    summ = engine.metrics.summary()
    line = {"step_counts": engine.step_counts(), "launches": counts,
            "wall_s": wall, "tokens_per_s": NEW_TOKENS * len(prompts) / wall,
            "ttft_p50_ms": summ["ttft_p50_s"] * 1e3,
            "ttft_p99_ms": summ["ttft_p99_s"] * 1e3,
            "tpot_p50_ms": summ["tpot_p50_s"] * 1e3,
            "tpot_p99_ms": summ["tpot_p99_s"] * 1e3}
    return warm_out + results, counts, line


def _not_real(torch, model, prompts, runs_a, runs_b, what):
    """``classify_divergence`` request by request; raises on "real" and
    returns the worst verdict, the mean agreement, the requests that
    differ, and the earliest divergence: its request, its token and the
    reference's logit gap there between the two choices (path A's
    teacher-forced logits; within ``tie_threshold`` is a tie)."""
    import numpy as np

    from byteps_tpu_torch.inference import classify_divergence

    verdicts = [classify_divergence(model, np.asarray(p)[None], a[None],
                                    b[None])
                for p, a, b in zip(prompts, runs_a, runs_b)]
    worst = max(verdicts, key=lambda v: ["none", "tie", "real"].index(
        v["divergence"]))
    if worst["divergence"] == "real":
        raise AssertionError(f"{what}: {worst}")
    out = {"verdict": worst["divergence"], "agreement": float(np.mean(
        [v["agreement"] for v in verdicts])),
           "requests_differing": sum(v["divergence"] != "none"
                                     for v in verdicts)}
    split = [(v["first_div_pos"], i) for i, v in enumerate(verdicts)
             if v["divergence"] != "none"]
    if split:
        d, i = min(split)
        out["first_divergence"] = {
            "request": i, "token": d,
            **{k: verdicts[i][k] for k in ("divergence", "delta_logit",
                                           "tie_threshold")}}
    return out


def _quant_controls(torch, args, ref) -> dict:
    """A held bf16 int8 product (``args`` of ``quant_linear``) beside
    four controls on the same inputs, each in bf16 ulps of the largest
    reference output: two sound results (the reference from exact fp64
    sums; the tile design), another rounding (the fp32 sum times the
    scale, plus the bias, rounded once) and a fault (the rule's design
    with the last 64 columns of x zeroed, one K step dropped)."""
    from byteps_tpu_torch.ops import quant_dot as qd

    x, w, scale, bias, odt = args
    unit = 2.0 ** -7 * ref.float().abs().max().item()

    def ulps(y):
        return (y.float() - ref.float()).abs().max().item() / unit

    def epilogue(acc):
        y = acc.to(x.dtype).to(odt) * scale.to(odt)
        return y if bias is None else y + bias.to(odt)

    once = (x.float() @ w.float().t()) * scale
    once = (once if bias is None else once + bias.float()).to(odt)
    cut = x.clone()
    cut[..., -64:] = 0
    return {"path": ulps(qd.quant_linear(*args)),
            "exact_sums": ulps(epilogue(
                (x.double() @ w.double().t()).float())),
            "tile": ulps(qd.quant_linear_design(*args, design=qd.TILE)),
            "one_rounding": ulps(once),
            "last_k_step_dropped": ulps(qd.quant_linear(cut, w, scale,
                                                        bias, odt))}


class _PathCalls:
    """The first call of each shape a main path makes to the kernels the
    model calls (row 7's ``decode_attention``, row 1's ``flash_attention``,
    row 9's ``quant_linear`` and row 8's ``paged_attention``, through
    ``models.transformer``'s names,
    and rows 4-6's ``fused_linear_cross_entropy`` in its module, which the
    LM loss binds when it is built), its inputs and output
    copied; under autograd, the gradients that reach the call's output
    and inputs are copied too (the path's own dO, and the dq / dk / dv, or
    dx / dW, its backward kernels computed).  :meth:`hold` then holds
    those outputs and gradients, and the wrapper called again on the same
    inputs, to the plain versions.  Recording launches nothing, so the
    counts stay the main path's.  ``tag``, when a caller sets it, joins
    each call's key: the first call of each shape under each tag is
    recorded."""

    tag = None

    def __init__(self):
        from byteps_tpu_torch.models import transformer as tm
        from byteps_tpu_torch.ops import fused_cross_entropy as fce_mod

        self.targets = [(tm, "decode_attention"), (tm, "flash_attention"),
                        (tm, "quant_linear"), (tm, "paged_attention"),
                        (fce_mod, "fused_linear_cross_entropy")]

    def __enter__(self):
        self.calls = {}
        self.orig = [(m, n, getattr(m, n)) for m, n in self.targets]
        for m, n, fn in self.orig:
            setattr(m, n, self._recording(n, fn))
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.orig:
            setattr(m, n, fn)

    def _recording(self, name, fn):
        import torch

        def sig(x):   # a shape, an int position's type, or the value
            return ((tuple(x.shape), str(x.dtype)) if hasattr(x, "shape")
                    else "int" if type(x) is int else x)

        def copy(x):
            return x.detach().clone() if hasattr(x, "clone") else x

        def keep(grads, n):
            def hook(g):
                grads[n] = g.detach().clone()
            return hook

        def call(*args, **kw):
            out = fn(*args, **kw)
            key = (name, tuple(map(sig, args)),
                   tuple(sorted((k, sig(v)) for k, v in kw.items())),
                   self.tag)
            if key not in self.calls:
                grads = {}
                self.calls[key] = (name, [copy(a) for a in args],
                                   {k: copy(v) for k, v in kw.items()},
                                   out.detach().clone(), grads)
                if out.requires_grad:
                    names = (("dq", "dk", "dv") if name == "flash_attention"
                             else ("dx", "dw"))
                    out.register_hook(keep(grads, "dout"))
                    for n, a in zip(names, args):
                        if isinstance(a, torch.Tensor) and a.requires_grad:
                            a.register_hook(keep(grads, n))
            return out
        return call

    def hold(self, torch) -> list:
        """Each recorded call: its output against the plain version at
        phase 16's limits for row 7 (bf16 q: ulps of each row's largest;
        fp32: absolute), phase 5's for row 8 (fp32 1e-4, bf16 2e-2
        absolute; the int8 mode with a bf16 q 2 bf16 ulps of each row's
        largest), phase 9's for row 1 (relative to the largest
        |o|, and for a backward the largest |dq|, |dk|, |dv|), for row 9
        two bf16 ulps of the largest |out| (fp32 1e-5 of it)
        and phase 13's for rows 4-6 (loss 1e-5 relative, dx / dW 2e-2 of
        the largest in bf16), a call of the wrapper on the same inputs
        (and its backward on the path's dO) bit-identical to it, and at a
        position vector each slot's bits unchanged when the other slots'
        positions move, and within the limit of a one-slot launch at its
        int position.  Raises on a miss; one line a call."""
        from byteps_tpu_torch.ops import decode_attention as da
        from byteps_tpu_torch.ops import flash_attention as fa
        from byteps_tpu_torch.ops import fused_cross_entropy as fce
        from byteps_tpu_torch.ops import paged_attention as pa
        from byteps_tpu_torch.ops import quant_dot as qd

        def rel(out, ref, floor):
            e = (out.float() - ref.float()).abs().max().item()
            return e, e / max(ref.float().abs().max().item(), floor)

        lines = []
        for name, args, kw, got, grads in self.calls.values():
            bf16 = args[0].dtype == torch.bfloat16
            extra = {}
            if name == "decode_attention":
                def call(*a):
                    return da.decode_attention(*a, **kw)
                ref = da.decode_attention_reference(*args, **kw)
                err, tol = ((_row_ulps(torch, got, ref), DECODE_BF16_ULPS)
                            if bf16 else
                            ((got.float() - ref.float()).abs().max()
                             .item(), 1e-4))
            elif name == "paged_attention":
                def call(*a):
                    return pa.paged_attention(*a, **kw)
                ref = pa.paged_attention_reference(*args, **kw)
                if bf16 and kw.get("k_scale") is not None:
                    err, tol = _row_ulps(torch, got, ref), INT8_BF16_ULPS
                else:
                    err = (got.float() - ref.float()).abs().max().item()
                    tol = 2e-2 if bf16 else 1e-4
                extra["pos"] = args[4].tolist()
            elif name == "quant_linear":
                def call(*a):
                    return qd.quant_linear(*a, **kw)
                ref = qd.quant_linear_reference(*args, **kw)
                err = rel(got, ref, 1e-30)[1]
                # bf16: two ulps of the largest output (phase 17 holds its
                # random inputs to one).  Both sides round the fp32 sum to
                # bf16, then its product with the bf16 scale; a sum in
                # another order may round one ulp of the sum the other
                # way, which the scale's mantissa (in [1, 2)) makes up to
                # two ulps of the product.  The controls show where the
                # limit sits between sound results and a fault.
                tol = 2.0 ** -6 if got.dtype == torch.bfloat16 else 1e-5
                if got.dtype == torch.bfloat16:
                    extra["ulps_of_max"] = _quant_controls(torch, args, ref)
            elif name == "fused_linear_cross_entropy":
                def call(*a):
                    return fce.fused_linear_cross_entropy(*a, **kw)
                x, w, t = args[:3]
                lse, tl = fce.fce_forward_reference(x, w, t)
                valid = (t >= 0) & (t < w.shape[1])
                ref = torch.where(valid, lse - tl, 0.0)
                err, tol = rel(got, ref, 1e-30)[1], 1e-5
                if grads:
                    dl = grads["dout"].float() * valid
                    gtol = 2e-2 if bf16 else 1e-4
                    for n, r in (("dx", fce.fce_backward_dx_reference(
                                     x, w, t, lse, dl)),
                                 ("dw", fce.fce_backward_dw_reference(
                                     x, w, t, lse, dl))):
                        extra[f"{n}_err"] = rel(grads[n], r, 1e-30)[1]
                        if not (torch.isfinite(grads[n].float()).all()
                                and extra[f"{n}_err"] <= gtol):
                            raise AssertionError(
                                f"{name} {n} at {tuple(x.shape)}: error "
                                f"{extra[f'{n}_err']} > {gtol}")
                    extra["grad_tolerance"] = gtol
            else:
                def call(*a):
                    return fa.flash_attention(*a, **kw)
                ref, lse = fa.flash_forward_reference(*args, **kw)
                floor = 1e-6 if bf16 else 1.0
                err = rel(got, ref, floor)[1]
                tol = 2e-2 if bf16 else 1e-4
                if grads:
                    q, k, v = args[:3]
                    opts = dict(causal=kw.get("causal", False),
                                segment_ids=kw.get("segment_ids"),
                                window=kw.get("window"))
                    do = grads["dout"]
                    delta = (do.float() * ref.float()).sum(-1).permute(
                        0, 2, 1).contiguous()
                    bwd = (q, k, v, do.to(q.dtype), lse, delta)
                    dk, dv = fa.flash_backward_dkv_reference(*bwd, **opts)
                    for n, r in (("dq", fa.flash_backward_dq_reference(
                                     *bwd, **opts)), ("dk", dk), ("dv", dv)):
                        extra[f"{n}_err"] = rel(grads[n], r, floor)[1]
                        if not (torch.isfinite(grads[n].float()).all()
                                and extra[f"{n}_err"] <= tol):
                            raise AssertionError(
                                f"{name} {n} at {tuple(q.shape)}: error "
                                f"{extra[f'{n}_err']} > {tol}")
            what = f"{name} at {[tuple(a.shape) for a in args[:3]]}"
            if not (torch.isfinite(got.float()).all() and err <= tol):
                raise AssertionError(f"{what}: error {err} > {tol}")
            if grads:
                # the kernels again on the path's inputs and dO: the same
                # bits, forward and backward
                leaves = [a.detach().clone().requires_grad_()
                          if isinstance(a, torch.Tensor)
                          and a.is_floating_point() else a for a in args]
                out = call(*leaves)
                torch.autograd.backward(out, grads["dout"])
                names = (("dq", "dk", "dv") if name == "flash_attention"
                         else ("dx", "dw"))
                same = torch.equal(out.detach(), got) and all(
                    torch.equal(a.grad, grads[n])
                    for n, a in zip(names, leaves) if n in grads)
                extra["backward_held"] = sorted(n for n in names
                                                if n in grads)
            else:
                same = torch.equal(call(*args), got)
            if not same:
                raise AssertionError(f"{what}: a call on the same inputs "
                                     f"differs from the path's")
            line = {"kernel": name, "shapes": [list(a.shape)
                                               for a in args[:3]],
                    "dtype": str(args[1].dtype).split(".")[-1],
                    "max_abs_err": (got.float() - ref.float()).abs().max()
                    .item(), "err": err, "tolerance": tol, **extra}
            pos = args[3] if name == "decode_attention" else None
            if hasattr(pos, "shape"):
                q, ck, cv = args[:3]
                one = dict(kw)
                for b in range(q.shape[0]):
                    moved = pos.flip(0)
                    moved[b] = pos[b]
                    if not torch.equal(call(q, ck, cv, moved)[b], got[b]):
                        raise AssertionError(f"{what}: slot {b}'s bits "
                                             f"moved with the others'")
                    for k in ("k_scale", "v_scale"):
                        if kw.get(k) is not None:
                            one[k] = kw[k][b:b + 1]
                    ref1 = da.decode_attention(
                        q[b:b + 1], ck[b:b + 1], cv[b:b + 1],
                        int(pos[b]), **one)
                    e1 = (_row_ulps(torch, got[b:b + 1], ref1) if bf16
                          else (got[b:b + 1].float() - ref1.float()).abs()
                          .max().item())
                    if e1 > tol:
                        raise AssertionError(f"{what}: slot {b} is {e1} "
                                             f"from its one-slot launch")
                line["pos"] = pos.tolist()
                line["slots_independent_and_one_slot_close"] = True
            elif name == "decode_attention":
                line["pos"] = pos
            lines.append(line)
        return lines


def dense_tiers_serve_phase(torch, seed: int) -> dict:
    """The dense engine's prefix store and verify at full width: phase 4's
    serving model (bf16, attention in plain torch: a flash model is
    refused with a prefix store at this max_seq) on 8 dense grouped slots
    of 2048 rows with ``prefix_cache=True`` and ``spec_k=4``, phase 6c's
    traffic (a warm request, then 8 sharing a 256-token prefix): the
    n-gram run, a run replaying each first answer as its proposals (which
    must be accepted and give the same tokens: the verify width is
    fixed), the prefix store alone, speculation alone, and both off;
    every tick of a spec run a verify, >= 8 prefix hits (row copies) in a
    prefix run, no kernel launched.  Each run against off: identical, or
    where it first parts and the off stream's logit gap there."""
    import numpy as np

    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)
    from byteps_tpu_torch.serving import ServeMetrics, ServingEngine

    cfg = TransformerConfig(**LLAMA_3_2_1B, max_seq_len=MAX_SEQ,
                            dtype=torch.bfloat16)
    model = Transformer(cfg, device="cuda", param_dtype=torch.bfloat16)
    init_weights(model, seed)
    warm, prompts = _tiers_prompts(np, cfg.vocab_size, seed)

    both = dict(prefix_cache=True, spec_k=TIERS_SPEC_K)
    runs = {}
    # (name, options): both on with the n-gram proposer and with replayed
    # proposals, each alone (which of them parts the streams from off,
    # and where), and both off
    for name, kw in (("ngram", both), ("replay", both),
                     ("prefix_only", dict(prefix_cache=True)),
                     ("spec_only", dict(spec_k=TIERS_SPEC_K)), ("off", {})):
        eng = ServingEngine(model, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                            device="cuda", metrics=ServeMetrics(), **kw)
        if name == "replay":
            eng.spec = _ReplayProposer(eng.spec.k, [warm] + prompts,
                                       runs["ngram"][0])
        results, counts, line = _engine_run(torch, eng, prompts, warm)
        c = line["step_counts"]
        if counts["decode"] or counts["paged"] or counts["plain"] \
                or counts["flash_fwd"]:
            raise AssertionError(f"dense {name}: launches {counts}")
        if (kw.get("spec_k") and c["verify_ticks"] != c["decode_ticks"]) \
                or (kw.get("prefix_cache") and (
                    c["prefix_hits"] < len(prompts)
                    or c["prefix_copies"] != c["prefix_hits"])):
            raise AssertionError(f"dense {name}: {c}")
        if name == "replay" and not c["spec_accepted"]:
            raise AssertionError(f"dense replay accepted nothing: {c}")
        line["spec_acceptance"] = (c["spec_accepted"]
                                   / max(c["spec_proposed"], 1))
        runs[name] = (results, line)
        del eng
        torch.cuda.empty_cache()
    for a, b in zip(runs["ngram"][0], runs["replay"][0]):
        if not np.array_equal(a, b):
            raise AssertionError("dense replay run != n-gram run")
    vs_off = {name: _not_real(torch, model, [warm] + prompts,
                              runs["off"][0], runs[name][0],
                              f"dense {name} vs off")
              for name in ("ngram", "prefix_only", "spec_only")}
    info = {"phase": "dense_tiers_serve",
            "model": "Llama-3.2-1B (random weights)",
            "source": "meta-llama/Llama-3.2-1B config.json",
            "reduced": {"max_seq": [131072, MAX_SEQ]}, "dtype": "bfloat16",
            "layout": "grouped", "slots": N_SLOTS, "spec_k": TIERS_SPEC_K,
            "prompt_lens": [len(warm)] + [len(p) for p in prompts],
            "replay_identical_to_ngram": True,
            "on_identical_to_off": vs_off["ngram"]["verdict"] == "none",
            "on_vs_off": vs_off["ngram"],
            **{f"{n}_vs_off": vs_off[n] for n in ("prefix_only",
                                                  "spec_only")},
            "nvidia_smi": _smi(),
            **{n: r[1] for n, r in runs.items()}}
    del model
    torch.cuda.empty_cache()
    return info


def gather_serve_phase(torch, seed: int, paged_results) -> tuple:
    """The paged gather fallback at full width on phase 4's model and
    traffic: a bf16 grouped pool (phase 4's 1025 blocks), an int8 pool at
    513 MiB (run twice) and the int8 pool at tp=2, and the paged kernel
    on the int8 pool as its reference.  Int8 runs: decode-kernel launches
    = ticks x 16, every one reading the slots' position vector, no paged
    kernel, no plain call; reruns identical; tp=2 identical to tp=1; each
    run not "real" against the kernel path's stream (phase 4's, or the
    int8 kernel run).  Returns the phase line and the int8 run's
    counts."""
    import numpy as np

    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)
    from byteps_tpu_torch.serving import ServeMetrics, ServingEngine

    cfg = TransformerConfig(**LLAMA_3_2_1B, max_seq_len=MAX_SEQ,
                            dtype=torch.bfloat16)
    L = cfg.num_layers
    model = Transformer(cfg, device="cuda", param_dtype=torch.bfloat16)
    init_weights(model, seed)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in PROMPT_LENS]
    runs = {}
    for name, kw in (("bf16", dict(kv_blocks=1025)),
                     ("int8_kernel", dict(kv_mb=TIERS_KV_MB,
                                          kv_dtype="int8",
                                          paged_kernel="on")),
                     ("int8", dict(kv_mb=TIERS_KV_MB, kv_dtype="int8")),
                     ("int8_rerun", dict(kv_mb=TIERS_KV_MB,
                                         kv_dtype="int8")),
                     ("int8_tp2", dict(kv_mb=TIERS_KV_MB, kv_dtype="int8",
                                       tp=2))):
        kw.setdefault("paged_kernel", "off")
        eng = ServingEngine(model, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                            paged=True, block=BLOCK, device="cuda",
                            metrics=ServeMetrics(), **kw)
        with _PathCalls() as path:
            results, counts, line = _engine_run(torch, eng, prompts)
        ticks = line["step_counts"]["decode_ticks"]
        gather = kw["paged_kernel"] == "off"
        want_dec = ticks * L if gather and "kv_dtype" in kw else 0
        want_paged = 0 if gather else ticks * L
        if (counts["decode"] != want_dec or counts["plain"]
                or counts["decode_by_design"]["device_pos"] != want_dec
                or counts["paged"] != want_paged or ticks == 0):
            raise AssertionError(f"gather {name}: {counts}, {ticks} ticks")
        buckets = sorted(eng.gather_buckets)
        # row 7 on this run's gathered rows, one held call a bucket
        held = path.hold(torch)
        rows = sorted(h["shapes"][1][1] // BLOCK for h in held
                      if h["kernel"] == "decode_attention")
        if rows != (buckets if want_dec else []):
            raise AssertionError(f"gather {name}: held decode calls at "
                                 f"{rows} blocks, buckets {buckets}")
        line.update(kv_blocks=eng.pool.block_stats()["n_blocks"],
                    gather_buckets=buckets, held=held)
        runs[name] = (results, line)
        del eng
        torch.cuda.empty_cache()
    for other in ("int8_rerun", "int8_tp2"):
        for a, b in zip(runs["int8"][0], runs[other][0]):
            if not np.array_equal(a, b):
                raise AssertionError(f"gather {other} != int8")
    info = {"phase": "gather_serve",
            "model": "Llama-3.2-1B (random weights)",
            "source": "meta-llama/Llama-3.2-1B config.json",
            "reduced": {"max_seq": [131072, MAX_SEQ]}, "dtype": "bfloat16",
            "slots": N_SLOTS, "rerun_identical": True, "tp2_identical": True,
            "bf16_vs_kernel": _not_real(torch, model, prompts,
                                        paged_results, runs["bf16"][0],
                                        "gather bf16 vs the paged kernel"),
            "int8_vs_kernel": _not_real(torch, model, prompts,
                                        runs["int8_kernel"][0],
                                        runs["int8"][0],
                                        "gather int8 vs the paged kernel"),
            "nvidia_smi": _smi(),
            **{n: r[1] for n, r in runs.items()}}
    del model
    torch.cuda.empty_cache()
    return info, runs["int8"][1]["launches"], runs["int8_kernel"][0]


# ---------------------------------------------------------- disagg serve

DISAGG_POOLS = (("bf16", dict(kv_blocks=1025), {}),
                ("int8", dict(kv_mb=TIERS_KV_MB, kv_dtype="int8"), {}),
                ("tp2_to_tp1", dict(kv_blocks=1025), dict(tp=2)))
PING_CALLS = 100


def _pct(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs, float), q))


def _disagg_run(torch, model, prompts, new, pool, prefill_over, n_slots,
                max_seq, path=None):
    """A prefill replica and a decode replica (two paged engines on
    ``model``, pools ``pool``, the prefill one also ``prefill_over``)
    behind two ServeFrontends; every prompt at once runs its two client
    legs: ``prefill_ship`` (first token, KV shipped to the decode
    replica) then ``stream(resume=[first], kv_ship=key)`` there.  The
    kernel counts are set to 0 just before and read just after.  Checks:
    every ship whole, sum(ceil(T / block)) blocks of the pool's
    block_bytes shipped by the prefill replica and none by the decode
    replica, no prefill on the decode replica, paged launches = its
    decode ticks x layers (none on the prefill replica), no plain call,
    both pools back at their base.  With a recorder ``path``, each
    decode tick at which a request is live for the first time tags its
    calls with the count of requests seen live so far, so every adopted
    ship's first decode is recorded.  Returns the tokens and the line."""
    from byteps_tpu_torch.ops import paged_attention as pa
    from byteps_tpu_torch.serving import (RemoteServeClient, ServeMetrics,
                                          ServingEngine, serve)
    from byteps_tpu_torch.serving import metrics as sm

    import numpy as np

    engines = [ServingEngine(model, n_slots=n_slots, max_seq=max_seq,
                             paged=True, block=BLOCK, device="cuda",
                             metrics=ServeMetrics(), **pool, **over)
               for over in (prefill_over, {})]
    pre, dec = engines
    if path is not None:
        seen, tick = set(), dec._decode_tick

        def tagged(active):
            seen.update(dec._slot_req[s].id for s in active
                        if dec._slot_req[s] is not None)
            path.tag = len(seen)
            return tick(active)

        dec._decode_tick = tagged
    if not all(t.is_cuda for e in engines for layer in e.pool.caches
               for t in layer.values()):
        raise AssertionError("KV pool is not on the GPU")
    base = [e.pool.alloc.used_count for e in engines]
    srvs = [serve(e, 0, host="127.0.0.1", in_thread=True) for e in engines]
    addrs = [f"127.0.0.1:{s.server_address[1]}" for s, _ in srvs]
    results = [None] * len(prompts)
    legs = [None] * len(prompts)
    errors = []

    def one(i):
        try:
            t0 = time.perf_counter()
            c = RemoteServeClient(addrs[0], timeout=600)
            try:
                first, info = c.prefill_ship(prompts[i], ship_to=addrs[1],
                                             kv_ship=f"ship{i}")
            finally:
                c.close()
            ttft = time.perf_counter() - t0
            d = RemoteServeClient(addrs[1], timeout=600)
            try:
                rest = list(d.stream(prompts[i], new,
                                     resume=[int(first[0])],
                                     extra={"kv_ship": f"ship{i}"}))
            finally:
                d.close()
            results[i] = np.asarray([int(first[0])] + rest, np.int32)
            legs[i] = (ttft, info)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    try:
        torch.cuda.synchronize()
        _zero_counts()
        pa.launches = pa.plain_calls = 0
        t1 = time.perf_counter()
        workers = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches, plain = pa.launches, pa.plain_calls
        if errors:
            raise errors[0]
        if any(w.is_alive() for w in workers):
            raise AssertionError("a disagg request did not finish")
        c = RemoteServeClient(addrs[0], timeout=60)
        stats = c.stats()
        pings = []
        for _ in range(PING_CALLS):
            t0 = time.perf_counter()
            if not c.ping():
                raise AssertionError("PING failed")
            pings.append((time.perf_counter() - t0) * 1e3)
        c.close()
    finally:
        for s, t in srvs:
            s.shutdown()
            s.server_close()
            t.join(timeout=30)
    L = model.cfg.num_layers
    infos = [info for _, info in legs]
    if not all(i.get("shipped") for i in infos):
        raise AssertionError(f"disagg: not every ship was whole: {infos}")
    want_blocks = sum(-(-len(p) // BLOCK) for p in prompts)
    shipped = pre.metrics.get(sm.KV_BLOCKS_SHIPPED)
    nbytes = pre.metrics.get(sm.KV_BLOCKS_SHIPPED_BYTES)
    counts = [e.step_counts() for e in engines]
    if (shipped != want_blocks or nbytes != want_blocks * dec.pool.block_bytes
            or sum(i["blocks"] for i in infos) != want_blocks
            or dec.metrics.get(sm.KV_BLOCKS_SHIPPED)):
        raise AssertionError(f"disagg: {shipped} blocks / {nbytes} bytes "
                             f"shipped, want {want_blocks} blocks of "
                             f"{dec.pool.block_bytes}")
    if (dec.metrics.get(sm.PREFILL_TOKENS) or counts[1]["prefill_chunks"]
            or counts[0]["decode_ticks"]):
        raise AssertionError(f"disagg: the decode replica prefilled or the "
                             f"prefill replica decoded: {counts}")
    if launches != counts[1]["decode_ticks"] * L or plain or not launches:
        raise AssertionError(f"disagg: {launches} paged launches for "
                             f"{counts[1]['decode_ticks']} decode ticks, "
                             f"{plain} plain calls")
    used = [e.pool.alloc.used_count for e in engines]
    if used != base:
        raise AssertionError(f"disagg: pools at {used} blocks, base {base}")
    for r in results:
        if r.shape != (new,) or r.min() < 0 or r.max() >= model.cfg.vocab_size:
            raise AssertionError(f"disagg: bad result {r}")
    summ = dec.metrics.summary()
    ttfts = [t * 1e3 for t, _ in legs]
    line = {"pools": {"prefill": pre.pool.block_stats(),
                      "decode": dec.pool.block_stats(),
                      "prefill_tp": pre.tp, "decode_tp": dec.tp},
            "requests": len(prompts), "shipped": len(infos),
            "blocks": shipped, "bytes": nbytes, "launches": launches,
            "decode_ticks": counts[1]["decode_ticks"],
            "step_counts": {"prefill": counts[0], "decode": counts[1]},
            "ship_p50_ms": stats["ship_p50_s"] * 1e3,
            "ship_p99_ms": stats["ship_p99_s"] * 1e3,
            "ship_n": stats["ship_n"],
            "ship_mb_per_s_p50": _pct([i["bytes"] / i["ms"] / 1e3
                                       for i in infos], 50),
            "extract_ms_p50": _pct([i["extract_ms"] for i in infos], 50),
            "extract_ms_max": max(i["extract_ms"] for i in infos),
            "ttft_with_ship_p50_ms": _pct(ttfts, 50),
            "ttft_with_ship_p99_ms": _pct(ttfts, 99),
            "decode_tpot_p50_ms": summ["tpot_p50_s"] * 1e3,
            "decode_tpot_p99_ms": summ["tpot_p99_s"] * 1e3,
            "wall_s": wall, "tokens_per_s": new * len(prompts) / wall,
            "ping_p50_ms": _pct(pings, 50)}
    del engines, pre, dec
    torch.cuda.empty_cache()
    return results, line


def disagg_reference_phase(torch, seed: int) -> dict:
    """Phase 3's fp32 model: the disaggregated pair (prefill ships, decode
    adopts) gives exactly the greedy tokens of one colocated paged
    engine on the same prompts."""
    import numpy as np

    from byteps_tpu_torch.serving import ServeMetrics, ServingEngine

    model = _ref_model(torch, seed)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, model.cfg.vocab_size, size=(n,)).astype(
        np.int32) for n in (20, 37, 64, 90)]
    n_new = 16
    eng = ServingEngine(model, n_slots=4, max_seq=256, paged=True,
                        block=BLOCK, device="cuda", metrics=ServeMetrics())
    reqs = [eng.submit(p, n_new) for p in prompts]
    eng.drain(timeout=300)
    want = [r.result() for r in reqs]
    got, line = _disagg_run(torch, model, prompts, n_new, {}, {}, 4, 256)
    if any(not np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"disagg fp32 tokens {got} != colocated "
                             f"{want}")
    return {"phase": "disagg_reference", "tokens_identical": True,
            "blocks": line["blocks"], "launches": line["launches"],
            "decode_ticks": line["decode_ticks"]}


def disagg_serve_phase(torch, seed: int, paged_results, int8_results):
    """The main path of the serve replica's wire slice: phase 4's model
    and traffic, disaggregated — bf16 pools of phase 4's 1025 blocks, int8
    pools at 513 MiB, and a tp=2 prefill replica shipping to a tp=1
    decode replica (tokens identical to the tp=1 pair).  The decode
    replica's first paged-attention call of each shape at each tick that
    brings a request live for the first time (every adopted ship, the
    512-token one and the tp=2 rows included) is recorded and held to
    the plain version after each run.  bf16 against phase 4's
    colocated stream, int8 against the colocated int8 kernel run of 6h:
    identical or not "real"."""
    import numpy as np

    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)

    cfg = TransformerConfig(**LLAMA_3_2_1B, max_seq_len=MAX_SEQ,
                            dtype=torch.bfloat16)
    model = Transformer(cfg, device="cuda", param_dtype=torch.bfloat16)
    init_weights(model, seed)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in PROMPT_LENS]
    runs = {}
    for name, pool, prefill_over in DISAGG_POOLS:
        with _PathCalls() as path:
            results, line = _disagg_run(torch, model, prompts, NEW_TOKENS,
                                        pool, prefill_over, N_SLOTS,
                                        MAX_SEQ, path)
        line["held"] = path.hold(torch)
        tags = sorted(k[-1] for k in path.calls)
        if ({h["kernel"] for h in line["held"]} != {"paged_attention"}
                or tags[-1] != len(prompts)):
            raise AssertionError(f"disagg {name}: held {line['held']} at "
                                 f"request counts {tags}")
        line["held_at_live_requests"] = tags
        runs[name] = (results, line)
    for a, b in zip(runs["bf16"][0], runs["tp2_to_tp1"][0]):
        if not np.array_equal(a, b):
            raise AssertionError("disagg tp2 -> tp1 != tp1 -> tp1")
    info = {"phase": "disagg_serve",
            "model": "Llama-3.2-1B (random weights)",
            "source": "meta-llama/Llama-3.2-1B config.json",
            "reduced": {"max_seq": [131072, MAX_SEQ]}, "dtype": "bfloat16",
            "slots": N_SLOTS, "prompt_lens": list(PROMPT_LENS),
            "tp2_to_tp1_identical": True,
            "bf16_vs_colocated": _not_real(torch, model, prompts,
                                           paged_results, runs["bf16"][0],
                                           "disagg bf16 vs phase 4"),
            "int8_vs_colocated": _not_real(torch, model, prompts,
                                           int8_results, runs["int8"][0],
                                           "disagg int8 vs 6h's kernel run"),
            "nvidia_smi": _smi(),
            **{n: r[1] for n, r in runs.items()}}
    del model
    torch.cuda.empty_cache()
    return info


# ----------------------------------------------------------- router tier

ROUTER_KILL_AT = 4     # tokens a stream delivers before its kill
PROC_MODEL = "max_seq_len=1024"   # the serve role's model, rows for 512 + 32
PROC_ENV = {"BYTEPS_SERVE_PAGED": "1", "BYTEPS_SERVE_MODEL": PROC_MODEL}
PROC_START_S = 300.0   # a child's CUDA context, model init and first ping
AUTOSCALE_SPIKE_NEW = 512   # new tokens of each stream of the load spike


class _ReplicaPath(_PathCalls):
    """:class:`_PathCalls` over several replicas in one process: each
    replica's decode tick names the replica and, as 6i does, how many
    requests it has seen live so far (thread-local: every engine ticks
    on a thread of its own), so the first call of each shape at each
    tick that brings a request live on a replica is recorded; every
    paged-attention call is also counted for its replica."""

    def __init__(self):
        super().__init__()
        self._local = threading.local()
        self.paged_calls = {}

    @property
    def tag(self):
        return getattr(self._local, "tag", None)

    def watch(self, name, engine) -> None:
        seen, tick = set(), engine._decode_tick

        def tagged(active):
            seen.update(engine._slot_req[s].id for s in active
                        if engine._slot_req[s] is not None)
            self._local.replica = name
            self._local.tag = (name, len(seen))
            return tick(active)

        engine._decode_tick = tagged

    def _recording(self, name, fn):
        rec = super()._recording(name, fn)
        if name != "paged_attention":
            return rec

        def call(*a, **kw):
            r = getattr(self._local, "replica", None)
            self.paged_calls[r] = self.paged_calls.get(r, 0) + 1
            return rec(*a, **kw)
        return call


def _resumes(engine) -> list:
    """Record each submit's resume length on ``engine`` (the splice
    point of a re-dispatched stream)."""
    seen, submit = [], engine.submit

    def recording(prompt, max_new_tokens, **kw):
        r = kw.get("resume_tokens")
        seen.append((len(prompt), 0 if r is None else len(r)))
        return submit(prompt, max_new_tokens, **kw)

    engine.submit = recording
    return seen


def _router_kw(**kw):
    from byteps_tpu_torch.observability.metrics import MetricsRegistry
    from byteps_tpu_torch.resilience.policy import RetryPolicy

    out = dict(credits=N_SLOTS, affinity=True, deadline=300.0,
               stream_timeout=120.0, heartbeat_interval=0.2,
               miss_threshold=2, ping_timeout=10.0,
               registry=MetricsRegistry(),
               retry=RetryPolicy(max_attempts=8, backoff_base=0.02,
                                 backoff_mult=2.0, backoff_cap=0.5,
                                 jitter=0.0, deadline=0.0))
    out.update(kw)
    return out


def _timed_streams(torch, call, prompts, new):
    """Every prompt at once, each on a thread of its own through
    ``call(i, prompt)`` (a token iterator): the tokens, and each
    request's client-side TTFT and TPOT (ms)."""
    import numpy as np

    out = [None] * len(prompts)
    errors = []

    def one(i):
        try:
            t0 = time.perf_counter()
            toks, times = [], []
            for tok in call(i, prompts[i]):
                times.append(time.perf_counter())
                toks.append(int(tok))
            out[i] = (np.asarray(toks, np.int32), (times[0] - t0) * 1e3,
                      (times[-1] - times[0]) * 1e3 / max(1, len(times) - 1))
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    workers = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    t1 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    if errors:
        raise errors[0]
    if any(w.is_alive() for w in workers):
        raise AssertionError("a routed request did not finish")
    for toks, _, _ in out:
        if toks.shape != (new,):
            raise AssertionError(f"bad routed result {toks}")
    return ([o[0] for o in out], [o[1] for o in out], [o[2] for o in out],
            wall)


def _client_stream(addr, prompt, new, **kw):
    """Tokens of one stream from a fresh client of ``addr`` (a router
    list fails over), the client closed at the end."""
    from byteps_tpu_torch.serving import RemoteServeClient

    c = RemoteServeClient(addr, timeout=600)
    try:
        yield from c.stream(prompt, new, **kw)
    finally:
        c.close()


def _stream_to(addr, prompt, new, **kw):
    return [int(t) for t in _client_stream(addr, prompt, new, **kw)]


def _splice(torch, model, prompt, got, resumes, survivor_addr, unkilled,
            what):
    """Hold a spliced stream to its own control: the tokens received
    before the kill (the survivor's resume length) and then the
    survivor's own resumed continuation of prompt + received, alone; its
    agreement with the unkilled stream, any divergence classified."""
    import numpy as np

    ks = [k for n, k in resumes if n == len(prompt) and k > 0]
    if not ks:
        raise AssertionError(f"{what}: no resumed submit on the survivor")
    k = ks[-1]
    control = list(got[:k]) + _stream_to(survivor_addr, prompt, NEW_TOKENS,
                                         resume=list(got[:k]))
    if list(got) != control:
        raise AssertionError(f"{what}: spliced {list(got)} != its control "
                             f"{control} (resumed after {k})")
    g, u = np.asarray(got, np.int32), np.asarray(unkilled, np.int32)
    return {"resumed_after": k, "splice_equals_control": True,
            "tokens_agreeing_with_unkilled": int((g == u).sum()),
            "vs_unkilled": _not_real(torch, model, [prompt], [u], [g],
                                     f"{what} vs the unkilled stream")}


def _kill_after(stream, n, kill):
    toks = []
    for tok in stream:
        toks.append(int(tok))
        if len(toks) == n:
            kill()
    return toks


def router_serve_phase(torch, seed: int, serve_info, paged_results):
    """Legs (a)-(d) of phase 6j on phase 4's model (module docstring)."""
    import numpy as np

    from byteps_tpu_torch.engine.transport import free_port
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)
    from byteps_tpu_torch.ops import paged_attention as pa
    from byteps_tpu_torch.serving import (RemoteServeClient, RouterFrontend,
                                          ServeMetrics, ServeReplyError,
                                          ServeRouter, ServingEngine, serve)
    from byteps_tpu_torch.serving import metrics as sm
    from byteps_tpu_torch.serving import router as rt

    cfg = TransformerConfig(**LLAMA_3_2_1B, max_seq_len=MAX_SEQ,
                            dtype=torch.bfloat16)
    model = Transformer(cfg, device="cuda", param_dtype=torch.bfloat16)
    init_weights(model, seed)
    L = cfg.num_layers
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in PROMPT_LENS]

    def engines(n):
        return [ServingEngine(model, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                              paged=True, block=BLOCK, device="cuda",
                              metrics=ServeMetrics()) for _ in range(n)]

    def check_path(path, names, ticks, what):
        calls = {n: path.paged_calls.get(n, 0) for n in names}
        want = {n: ticks[n] * L for n in names}
        if (calls != want or not all(ticks.values())
                or pa.launches != sum(calls.values()) or pa.plain_calls):
            raise AssertionError(
                f"{what}: paged calls {calls} for decode ticks {ticks} x "
                f"{L}, {pa.launches} launches, {pa.plain_calls} plain")
        return {"paged_calls": calls, "decode_ticks": ticks,
                "launches": pa.launches}

    info = {"phase": "router_serve",
            "model": "Llama-3.2-1B (random weights)",
            "source": "meta-llama/Llama-3.2-1B config.json",
            "reduced": {"max_seq": [131072, MAX_SEQ]}, "dtype": "bfloat16",
            "slots": N_SLOTS, "prompt_lens": list(PROMPT_LENS)}
    reps = engines(2)
    names = ("r0", "r1")
    resumes = [_resumes(e) for e in reps]
    base = [e.pool.alloc.used_count for e in reps]
    srvs = [serve(e, 0, host="127.0.0.1", in_thread=True) for e in reps]
    addrs = [f"127.0.0.1:{s.server_address[1]}" for s, _ in srvs]
    pa_, pb_ = free_port(), free_port()
    peers = [f"127.0.0.1:{pa_}", f"127.0.0.1:{pb_}"]
    fronts = []

    def router(i, port):
        """A router of the HA pair, its frontend serving at once: the
        standby's heartbeat pings the active's frontend from its
        construction on, and two misses (0.4 s) before that frontend
        listens would hand the standby the epoch."""
        r = ServeRouter(addrs, **_router_kw(peers=peers, self_addr=peers[i],
                                            epoch_timeout=0.2))
        f = RouterFrontend(("127.0.0.1", port), r)
        threading.Thread(target=f.serve_forever, daemon=True).start()
        fronts.append(f)
        return r

    ra = router(0, pa_)
    rb = router(1, pb_)
    try:
        with _ReplicaPath() as path:
            for n, e in zip(names, reps):
                path.watch(n, e)
            both = ",".join(peers)
            # (a) placement: phase 4's traffic through the routers
            torch.cuda.synchronize()
            ticks0 = [e.decode_ticks for e in reps]
            _zero_counts()
            pa.launches = pa.plain_calls = 0
            path.paged_calls.clear()
            results, ttft, tpot, wall = _timed_streams(
                torch, lambda i, p: _client_stream(both, p, NEW_TOKENS),
                prompts, NEW_TOKENS)
            ticks = {n: e.decode_ticks - t for n, e, t in
                     zip(names, reps, ticks0)}
            placement = check_path(path, names, ticks, "router (a)")
            st = ra.stats()
            if (st[rt.COMPLETED] != len(prompts) or st[rt.FAILED]
                    or st[rt.FAILOVERS]):
                raise AssertionError(f"router (a): {st}")
            summ = [e.metrics.summary() for e in reps]
            same = sum(np.array_equal(a, b)
                       for a, b in zip(results, paged_results))
            placement.update({
                "requests": len(prompts), "wall_s": wall,
                "tokens_per_s": NEW_TOKENS * len(prompts) / wall,
                "per_replica_submitted": [e.metrics.get(sm.SUBMITTED)
                                          for e in reps],
                "client_ttft_p50_ms": _pct(ttft, 50),
                "client_ttft_p99_ms": _pct(ttft, 99),
                "client_tpot_p50_ms": _pct(tpot, 50),
                "client_tpot_p99_ms": _pct(tpot, 99),
                "replica_tpot_p50_ms": [m["tpot_p50_s"] * 1e3 for m in summ],
                "replica_ttft_p50_ms": [m["ttft_p50_s"] * 1e3 for m in summ],
                "phase4_ttft_p50_ms": serve_info["run1"]["ttft_p50_ms"],
                "phase4_ttft_p99_ms": serve_info["run1"]["ttft_p99_ms"],
                "phase4_tpot_p50_ms": serve_info["run1"]["tpot_p50_ms"],
                "phase4_tpot_p99_ms": serve_info["run1"]["tpot_p99_ms"],
                "identical_to_phase4": int(same),
                "vs_phase4": _not_real(torch, model, prompts, paged_results,
                                       results, "router (a) vs phase 4")})
            # one at a time: the router's placement changes no bit
            alone = []
            for p in prompts[:2]:
                via = _stream_to(both, p, NEW_TOKENS)
                direct = _stream_to(addrs[0], p, NEW_TOKENS)
                if via != direct:
                    raise AssertionError(f"router (a): one request through "
                                         f"the router {via} != straight to "
                                         f"a replica {direct}")
                alone.append(len(p))
            placement["alone_identical_prompt_lens"] = alone
            info["placement"] = placement
            # (c) the active router killed mid-stream
            deadline = time.monotonic() + 30.0
            while (rb._journal_epoch < 1 or not all(
                    r.verified for r in rb._replicas)):
                if time.monotonic() > deadline:
                    raise AssertionError("router (c): the standby never "
                                         "folded the journal")
                time.sleep(0.05)
            p = prompts[2]
            unkilled = _stream_to(addrs[0], p, NEW_TOKENS)
            cli = RemoteServeClient(both, timeout=600)
            t0 = time.perf_counter()
            got = _kill_after(cli.stream(p, NEW_TOKENS, rid="ha"),
                              ROUTER_KILL_AT, fronts[0].kill)
            failover_s = time.perf_counter() - t0
            cli.close()
            if not (rb.active and rb.epoch == 2):
                raise AssertionError(f"router (c): standby active="
                                     f"{rb.active} epoch={rb.epoch}")
            holder = [i for i, rs in enumerate(resumes)
                      if any(n == len(p) and k for n, k in rs)]
            ha = _splice(torch, model, p, got, resumes[holder[-1]],
                         addrs[holder[-1]], unkilled, "router (c)")
            # phase 4's prompts again through the new active (the
            # journaled affinity places them on both replicas as in (a)):
            # both learn epoch 2, then refuse epoch 1
            for q in prompts:
                _stream_to(peers[1], q, 2)
            fenced = []
            for i, a in enumerate(addrs):
                if reps[i].epoch_high_water != 2:
                    raise AssertionError(f"router (c): replica {i} at "
                                         f"epoch {reps[i].epoch_high_water}")
                c = RemoteServeClient(a, timeout=60)
                try:
                    c.generate(prompts[0], 2, epoch=1)
                    raise AssertionError(f"router (c): replica {i} "
                                         f"accepted epoch 1")
                except ServeReplyError as e:
                    if e.name != "EpochFencedError":
                        raise
                    fenced.append(i)
                finally:
                    c.close()
            stb = rb.stats()
            ha.update({"takeover_epoch": rb.epoch,
                       "takeovers": stb[rt.TAKEOVERS],
                       "fenced_replicas": fenced,
                       "stream_wall_s_with_failover": failover_s})
            info["router_ha"] = ha
            # (b) the replica holding a stream killed mid-stream
            p = prompts[1]
            unkilled = _stream_to(addrs[0], p, NEW_TOKENS)
            red0 = stb[rt.REDISPATCHES]
            state = {}

            def kill_holder():
                idx = rb._inflight["kill"]["r"]
                state["killed"] = idx
                srvs[idx][0].kill()

            got = _kill_after(rb.stream(p, NEW_TOKENS, rid="kill"),
                              ROUTER_KILL_AT, kill_holder)
            surv = 1 - state["killed"]
            kill = _splice(torch, model, p, got, resumes[surv], addrs[surv],
                           unkilled, "router (b)")
            stb = rb.stats()
            kill.update({"killed_replica": state["killed"],
                         "redispatches": stb[rt.REDISPATCHES] - red0,
                         "failovers": stb[rt.FAILOVERS]})
            if kill["redispatches"] < 1:
                raise AssertionError(f"router (b): {stb}")
            info["replica_kill"] = kill
            if pa.plain_calls or pa.launches != sum(
                    path.paged_calls.values()):
                raise AssertionError(
                    f"router (a)-(c): {pa.launches} launches for "
                    f"{path.paged_calls} paged calls, {pa.plain_calls} plain")
        held = path.hold(torch)
        replicas_held = {t[0] for t in (k[-1] for k in path.calls) if t}
        if ({h["kernel"] for h in held} != {"paged_attention"}
                or replicas_held != set(names)):
            raise AssertionError(f"router (a)-(c): held {held}")
        info["held"] = held
        info["held_at"] = sorted(k[-1] for k in path.calls)
        info["pools_at_base_before_kill"] = base
    finally:
        for f in fronts:
            try:
                f.kill()
            except OSError:
                pass
        for s, t in srvs:
            s.shutdown()
            s.server_close()
            t.join(timeout=30)
    # (d) the disaggregated legs behind one port router
    pre, dec = engines(2)
    base = [e.pool.alloc.used_count for e in (pre, dec)]
    srvs = [serve(e, 0, host="127.0.0.1", in_thread=True) for e in (pre, dec)]
    addrs = [f"127.0.0.1:{s.server_address[1]}" for s, _ in srvs]
    router = ServeRouter(addrs, **_router_kw(roles=["prefill", "decode"]))
    try:
        with _ReplicaPath() as path:
            path.watch("decode", dec)
            router.start()
            torch.cuda.synchronize()
            ticks0 = dec.decode_ticks
            _zero_counts()
            pa.launches = pa.plain_calls = 0
            results, ttft, tpot, wall = _timed_streams(
                torch, lambda i, p: router.stream(p, NEW_TOKENS), prompts,
                NEW_TOKENS)
            disagg = check_path(path, ("decode",),
                                {"decode": dec.decode_ticks - ticks0},
                                "router (d)")
        st = router.stats()
        want_blocks = sum(-(-len(p) // BLOCK) for p in prompts)
        counts = [e.step_counts() for e in (pre, dec)]
        if (st[rt.DISAGG_PREFILLS] != len(prompts)
                or st[rt.DISAGG_SHIPPED_BLOCKS] != want_blocks
                or st[rt.DISAGG_FALLBACKS] or st[rt.REDISPATCHES]
                or pre.metrics.get(sm.KV_BLOCKS_SHIPPED) != want_blocks):
            raise AssertionError(f"router (d): not every ship whole: {st}")
        if (dec.metrics.get(sm.PREFILL_TOKENS) or counts[1]["prefill_chunks"]
                or counts[0]["decode_ticks"]):
            raise AssertionError(f"router (d): the decode replica prefilled "
                                 f"or the prefill replica decoded: {counts}")
        used = [e.pool.alloc.used_count for e in (pre, dec)]
        if used != base:
            raise AssertionError(f"router (d): pools at {used}, base {base}")
        held = path.hold(torch)
        tags = sorted(k[-1] for k in path.calls)
        if ({h["kernel"] for h in held} != {"paged_attention"}
                or tags[-1] != ("decode", len(prompts))):
            raise AssertionError(f"router (d): held {held} at {tags}")
        summ = dec.metrics.summary()
        pst = RemoteServeClient(addrs[0], timeout=60)
        ship = pst.stats()
        pst.close()
        disagg.update({
            "blocks_shipped": want_blocks,
            "disagg_prefills": st[rt.DISAGG_PREFILLS],
            "fallbacks": st[rt.DISAGG_FALLBACKS],
            "ship_p50_ms": ship["ship_p50_s"] * 1e3,
            "ship_p99_ms": ship["ship_p99_s"] * 1e3,
            "client_ttft_p50_ms": _pct(ttft, 50),
            "client_ttft_p99_ms": _pct(ttft, 99),
            "client_tpot_p50_ms": _pct(tpot, 50),
            "client_tpot_p99_ms": _pct(tpot, 99),
            "decode_tpot_p50_ms": summ["tpot_p50_s"] * 1e3,
            "wall_s": wall, "held": held, "held_at": tags,
            "identical_to_phase4": int(sum(
                np.array_equal(a, b) for a, b in zip(results,
                                                     paged_results))),
            "vs_phase4": _not_real(torch, model, prompts, paged_results,
                                   results, "router (d) vs phase 4")})
        info["disagg"] = disagg
    finally:
        router.close()
        for s, t in srvs:
            s.shutdown()
            s.server_close()
            t.join(timeout=30)
    info["nvidia_smi"] = _smi()
    del model, reps, pre, dec
    torch.cuda.empty_cache()
    return info


def _child_env(over) -> dict:
    """This process's environment without its ``BYTEPS_*`` / ``DMLC_*``
    knobs, plus ``over``, with this checkout first on ``PYTHONPATH``: a
    launcher child's."""
    import os

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BYTEPS_", "DMLC_"))}
    env.update(over)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in [os.environ.get("PYTHONPATH")] if p])
    return env


@contextlib.contextmanager
def _children():
    """Processes of the port's launcher, each logging to a file of its
    own; every one still running is killed on the way out, and one that
    exited by itself fails the phase (its log's tail in the error)."""
    import os
    import tempfile

    procs = []

    def spawn(name, env_over):
        log = tempfile.NamedTemporaryFile("w+", prefix=f"{name}-",
                                          suffix=".log", delete=False)
        proc = subprocess.Popen(
            [sys.executable, "-m", "byteps_tpu_torch.launcher"],
            env=_child_env(env_over),
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
            stderr=subprocess.STDOUT)
        proc.log_path = log.name
        procs.append((name, proc, log))
        return proc

    def check():
        for name, proc, log in procs:
            if proc.poll() is not None:
                log.flush()
                with open(log.name) as f:
                    tail = f.read()[-3000:]
                raise AssertionError(f"child {name} exited rc="
                                     f"{proc.returncode}:\n{tail}")

    spawn.check = check
    try:
        yield spawn
        check()
    finally:
        for _, proc, log in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
            log.close()
            os.unlink(log.name)


def _await_ping(addr, check, timeout=PROC_START_S) -> float:
    from byteps_tpu_torch.serving import RemoteServeClient

    t0 = time.perf_counter()
    while True:
        check()
        try:
            c = RemoteServeClient(addr, timeout=30)
            try:
                if c.ping():
                    return time.perf_counter() - t0
            finally:
                c.close()
        except OSError:
            pass
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{addr} never answered PING")
        time.sleep(0.25)


def _proc_prompts(seed, vocab):
    import numpy as np

    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=(n,)).astype(np.int32)
            for n in PROMPT_LENS]


def router_process_phase(torch, seed: int):
    """Leg (e) of phase 6j (module docstring)."""
    import numpy as np

    from byteps_tpu_torch.engine.transport import free_port
    from byteps_tpu_torch.serving import (RemoteServeClient, ServeMetrics,
                                          ServingEngine)
    from byteps_tpu_torch.serving import router as rt
    from byteps_tpu_torch.serving.frontend import _model_from_env

    model = _model_from_env(PROC_MODEL, "cuda")
    L, V = model.cfg.num_layers, model.cfg.vocab_size
    prompts = _proc_prompts(seed, V)
    solo = ServingEngine(model, n_slots=N_SLOTS, max_seq=1024, paged=True,
                         block=BLOCK, device="cuda", metrics=ServeMetrics())
    reqs = [solo.submit(p, NEW_TOKENS) for p in prompts]
    solo.drain(timeout=300)
    want = [r.result() for r in reqs]
    ports = [free_port() for _ in range(3)]
    addrs = [f"127.0.0.1:{p}" for p in ports]
    with _children() as spawn:
        t0 = time.perf_counter()
        for port in ports[:2]:
            spawn(f"serve{port}", {**PROC_ENV, "DMLC_ROLE": "serve",
                                   "BYTEPS_SERVE_PORT": str(port)})
        up = [_await_ping(a, spawn.check) for a in addrs[:2]]
        spawn("router", {"DMLC_ROLE": "router",
                         "BYTEPS_ROUTER_PORT": str(ports[2]),
                         "BYTEPS_ROUTER_REPLICAS": ",".join(addrs[:2]),
                         "BYTEPS_ROUTER_ROLES": "prefill,decode",
                         "BYTEPS_HEARTBEAT_TIMEOUT_MS": "30000"})
        _await_ping(addrs[2], spawn.check)
        start_s = time.perf_counter() - t0
        results, ttft, tpot, wall = _timed_streams(
            torch, lambda i, p: _client_stream(addrs[2], p, NEW_TOKENS),
            prompts, NEW_TOKENS)
        spawn.check()
        stats = []
        for a in addrs:
            c = RemoteServeClient(a, timeout=60)
            stats.append(c.stats())
            c.close()
    pre, dec, rst = stats
    if any(not np.array_equal(a, b) for a, b in zip(results, want)):
        raise AssertionError(f"router (e): {results} != the in-process "
                             f"replica's {want}")
    want_blocks = sum(-(-len(p) // BLOCK) for p in prompts)
    pc, dc = pre["step_counts"], dec["step_counts"]
    if (rst[rt.DISAGG_PREFILLS] != len(prompts) or rst[rt.DISAGG_FALLBACKS]
            or rst[rt.DISAGG_SHIPPED_BLOCKS] != want_blocks
            or pc["decode_ticks"] or dc["prefill_chunks"]
            or dc["paged_attention_launches"] != dc["decode_ticks"] * L
            or not dc["decode_ticks"] or pc["paged_attention_launches"]):
        raise AssertionError(f"router (e): router {rst}, prefill {pc}, "
                             f"decode {dc}")
    del model, solo
    torch.cuda.empty_cache()
    return {"phase": "router_process",
            "model": "the serve role's default (BYTEPS_SERVE_MODEL="
                     f"{PROC_MODEL!r}), fp32",
            "processes": 3, "tokens_identical_to_in_process": True,
            "replica_ping_s": up, "tier_start_s": start_s,
            "blocks_shipped": want_blocks,
            "decode_launches": dc["paged_attention_launches"],
            "decode_ticks": dc["decode_ticks"],
            "ship_p50_ms": pre["ship_p50_s"] * 1e3,
            "ship_p99_ms": pre["ship_p99_s"] * 1e3,
            "ship_n": pre["ship_n"],
            "decode_tpot_p50_ms": dec["tpot_p50_s"] * 1e3,
            "decode_tpot_p99_ms": dec["tpot_p99_s"] * 1e3,
            "client_ttft_p50_ms": _pct(ttft, 50),
            "client_tpot_p50_ms": _pct(tpot, 50),
            "wall_s": wall, "nvidia_smi": _smi()}


def router_autoscale_phase(torch, seed: int):
    """Leg (f) of phase 6j (module docstring)."""
    from byteps_tpu_torch.serving import (AutoscaleController,
                                          RemoteServeClient, ReplicaLauncher,
                                          ScalePolicy, ServeMetrics,
                                          ServeRouter, ServingEngine,
                                          TierSignals, serve)
    from byteps_tpu_torch.serving import metrics as sm
    from byteps_tpu_torch.serving.autoscale import poll_router
    from byteps_tpu_torch.serving.frontend import _model_from_env

    model = _model_from_env(PROC_MODEL, "cuda")
    prompts = _proc_prompts(seed + 1, model.cfg.vocab_size)
    seed_eng = ServingEngine(model, n_slots=N_SLOTS, max_seq=1024,
                             paged=True, block=BLOCK, device="cuda",
                             metrics=ServeMetrics())
    srv, thread = serve(seed_eng, 0, host="127.0.0.1", in_thread=True)
    router = ServeRouter([f"127.0.0.1:{srv.server_address[1]}"],
                         **_router_kw(credits=2, affinity=False))
    launcher = ReplicaLauncher(base_env=_child_env(PROC_ENV),
                               startup_timeout_s=PROC_START_S)
    ctl = AutoscaleController(
        router, ScalePolicy(min_replicas=1, max_replicas=2,
                            up_threshold=0.8, down_threshold=0.3,
                            up_cooldown_s=0.0, down_cooldown_s=0.0),
        TierSignals(poll_router(router), window_s=0.0), launcher,
        interval_s=1.0, drain_timeout_s=120.0)
    handle = None
    try:
        router.start()
        errors = []

        def hold_credit(p):
            try:
                list(router.stream(p, AUTOSCALE_SPIKE_NEW))
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        spike = [threading.Thread(target=hold_credit, args=(p,))
                 for p in prompts[:4]]
        for t in spike:
            t.start()
        deadline = time.monotonic() + 120
        while router.signal_snapshot()["inflight"] < 2:
            if time.monotonic() > deadline:
                raise AssertionError("autoscale: no spike")
            time.sleep(0.01)
        load = router.signal_snapshot()
        t0 = time.perf_counter()
        up = ctl.step()
        spawn_s = time.perf_counter() - t0
        if (up.action != "up" or ctl.scale_ups != 1
                or router.placeable_count() != 2):
            raise AssertionError(f"autoscale: {up} at {load}")
        handle = ctl._dynamic[-1]
        for t in spike:
            t.join(timeout=300)
        if errors or any(t.is_alive() for t in spike):
            raise AssertionError(f"autoscale: the spike's streams {errors}")
        for p in prompts:
            toks = list(router.stream(p, NEW_TOKENS))
            if len(toks) != NEW_TOKENS:
                raise AssertionError(f"autoscale: {toks}")
        c = RemoteServeClient(handle.addr, timeout=60)
        st = c.stats()
        c.close()
        served, device = st.get(sm.SUBMITTED, 0), st["device"]
        if served < 1 or not device.startswith("cuda"):
            raise AssertionError(f"autoscale: the spawned replica served "
                                 f"{served} on {device}")
        down = ctl.step()
        if (down.action != "down" or ctl.scale_downs != 1
                or router.placeable_count() != 1
                or handle.proc.poll() is None):
            raise AssertionError(f"autoscale: {down}, process "
                                 f"{handle.proc.poll()}")
        handle = None
    finally:
        router.close()
        if handle is not None and handle.proc.poll() is None:
            handle.proc.kill()
            handle.proc.wait(timeout=60)
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    del model, seed_eng
    torch.cuda.empty_cache()
    return {"phase": "router_autoscale", "spike": load,
            "up": [up.action, up.target, up.reason],
            "spawn_s": spawn_s, "spawned_served": served,
            "spawned_device": device,
            "down": [down.action, down.target, down.reason],
            "startup_timeout_s": PROC_START_S, "nvidia_smi": _smi()}


# -------------------------------------------------------------- training


def _flash_counts():
    from byteps_tpu_torch.ops import flash_attention as fa

    return (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)


def _zero_counts():
    """Every launch and plain-call count of the flash, fused-CE, decode
    and int8-product wrappers to 0."""
    from byteps_tpu_torch.ops import decode_attention as da
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import fused_cross_entropy as fce
    from byteps_tpu_torch.ops import quant_dot as qd

    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = fa.plain_calls = 0
    fce.fwd_launches = fce.dx_launches = fce.dw_launches = 0
    fce.plain_calls = fce.tma_launches = 0
    da.launches = da.plain_calls = 0
    da.design_launches = dict.fromkeys(da.COUNTS, 0)
    qd.launches = qd.plain_calls = 0
    qd.design_launches = dict.fromkeys(qd.DESIGNS, 0)


def _fce_counts():
    from byteps_tpu_torch.ops import fused_cross_entropy as fce

    return (fce.fwd_launches, fce.dx_launches, fce.dw_launches)


def train_reference_phase(torch, seed: int) -> dict:
    """3 fp32 steps with the flash kernels vs 3 with the plain local
    attention, same weights and batch: losses and step-1 gradients."""
    import numpy as np

    from byteps_tpu_torch import api
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)
    from byteps_tpu_torch.training import Trainer, lm_loss_fn

    toks = np.random.RandomState(seed).randint(
        0, TRAIN_REF["vocab_size"], size=(2, TRAIN_REF["max_seq_len"]))
    runs = {}
    for impl in ("flash", "local"):
        cfg = TransformerConfig(**{**LLAMA_3_2_1B, **TRAIN_REF},
                                attn_impl=impl, dtype=torch.float32)
        model = Transformer(cfg, device="cuda")
        init_weights(model, seed)
        trainer = Trainer(lm_loss_fn(model), torch.optim.SGD(
            model.parameters(), lr=0.05, momentum=0.9), log_every=0)
        _zero_counts()
        losses, grads = [], None
        for step in range(3):
            trainer.fit(model, {}, [{"tokens": toks}])
            losses.append(trainer.metrics["loss"].item())
            if step == 0:
                grads = {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}
        runs[impl] = (losses, grads, _flash_counts())
        api.shutdown()
        del model, trainer
    (lf, gf, nf), (ll, gl, nl) = runs["flash"], runs["local"]
    want = 3 * TRAIN_REF["num_layers"]
    if nf != (want, want, want) or nl != (0, 0, 0):
        raise AssertionError(f"flash launches {nf} (want {want} each), "
                             f"local {nl}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lf, ll))
    if not all(np.isfinite(lf)) or loss_rel > 1e-5:
        raise AssertionError(f"losses flash {lf} vs local {ll}")
    grad_rel = max(((gf[n] - gl[n]).abs().max()
                    / gl[n].abs().max().clamp(min=1e-30)).item() for n in gl)
    if grad_rel > GRAD_TOL:
        raise AssertionError(f"step-1 gradients differ by {grad_rel} of "
                             f"their largest entry (> {GRAD_TOL})")
    torch.cuda.empty_cache()
    return {"phase": "train_reference", "losses_flash": lf,
            "losses_local": ll, "loss_max_rel_diff": loss_rel,
            "grad_max_rel_diff": grad_rel, "grad_tolerance": GRAD_TOL,
            "flash_launches": nf}


def fused_reference_phase(torch, seed: int) -> dict:
    """3 fp32 steps with the fused LM-head CE kernels vs 3 with the plain
    head from the same weights, then both again with the early-exit
    term: losses and step-1 gradients."""
    import numpy as np

    from byteps_tpu_torch import api
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)
    from byteps_tpu_torch.ops import fused_cross_entropy as fce
    from byteps_tpu_torch.training import Trainer, lm_loss_fn

    toks = np.random.RandomState(seed).randint(
        0, TRAIN_REF["vocab_size"], size=(2, TRAIN_REF["max_seq_len"]))
    cfg = TransformerConfig(**{**LLAMA_3_2_1B, **TRAIN_REF},
                            attn_impl="flash", dtype=torch.float32)
    nc = fce.vocab_chunks(cfg.vocab_size)
    info = {"phase": "fused_reference"}
    for early_exit in (None, (1, 0.5)):
        runs = {}
        for fused in (True, False):
            model = Transformer(cfg, device="cuda")
            init_weights(model, seed)
            trainer = Trainer(
                lm_loss_fn(model, fused_head=fused, early_exit=early_exit),
                torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
                log_every=0)
            _zero_counts()
            losses, grads = [], None
            for step in range(3):
                trainer.fit(model, {}, [{"tokens": toks}])
                losses.append(trainer.metrics["loss"].item())
                if step == 0:
                    grads = {n: p.grad.detach().clone()
                             for n, p in model.named_parameters()}
            runs[fused] = (losses, grads, _fce_counts(), fce.plain_calls)
            api.shutdown()
            del model, trainer
        (lf, gf, nf, pf), (lp, gp, np_, pp) = runs[True], runs[False]
        calls = 3 * (1 if early_exit is None else 2)  # CE calls in 3 steps
        if nf != (calls, calls * nc, calls * nc) or np_ != (0, 0, 0) \
                or pf or pp:
            raise AssertionError(f"fused-CE launches {nf} (want {calls}, "
                                 f"{calls * nc} x2), plain head {np_}, "
                                 f"plain calls {pf}/{pp}")
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lf, lp))
        if not all(np.isfinite(lf)) or loss_rel > 1e-5:
            raise AssertionError(f"losses fused {lf} vs plain {lp}")
        grad_rel = max(((gf[n] - gp[n]).abs().max()
                        / gp[n].abs().max().clamp(min=1e-30)).item()
                       for n in gp)
        if grad_rel > GRAD_TOL:
            raise AssertionError(f"step-1 gradients differ by {grad_rel} "
                                 f"of their largest entry (> {GRAD_TOL})")
        tag = "" if early_exit is None else "early_exit_"
        info.update({f"{tag}losses_fused": lf, f"{tag}losses_plain": lp,
                     f"{tag}loss_max_rel_diff": loss_rel,
                     f"{tag}grad_max_rel_diff": grad_rel,
                     f"{tag}fce_launches": nf})
    torch.cuda.empty_cache()
    return info


def train_phase(torch, seed: int, fused_head: bool = False, then=None):
    """Full-width Llama-3.2-1B training through Trainer.fit: the main
    path of the training slice, or with ``fused_head`` that of the
    fused-CE slice.  ``then(trainer, model)``, if given, runs on the
    trained model before it is freed; its result is returned third."""
    import numpy as np

    from byteps_tpu_torch import api
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import fused_cross_entropy as fce
    from byteps_tpu_torch.training import Trainer, lm_loss_fn

    cfg = TransformerConfig(**LLAMA_3_2_1B, max_seq_len=MAX_SEQ,
                            dtype=torch.bfloat16, attn_impl="flash")
    nc = fce.vocab_chunks(cfg.vocab_size)
    want = (cfg.num_layers,) * 3 + ((1, nc, nc) if fused_head else (0, 0, 0))
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda")            # fp32 weights
    init_weights(model, seed)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4, fused=True)
    trainer = Trainer(lm_loss_fn(model, fused_head=fused_head), opt,
                      log_every=0)
    toks = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(TRAIN_B, MAX_SEQ))
    batch = {"tokens": torch.from_numpy(toks).cuda()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    trainer.fit(model, {}, [batch])                     # warm-up
    losses = [trainer.metrics["loss"].item()]
    _zero_counts()
    step_ms = []
    for _ in range(TRAIN_TIMED):
        before = _flash_counts() + _fce_counts()
        tma0 = fce.tma_launches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.fit(model, {}, [batch])
        losses.append(trainer.metrics["loss"].item())   # synchronizes
        step_ms.append((time.perf_counter() - t1) * 1e3)
        per = tuple(a - b for a, b in zip(_flash_counts() + _fce_counts(),
                                          before))
        if per != want:
            raise AssertionError(f"launches this step (flash fwd/dq/dkv, "
                                 f"fused CE fwd/dx/dw) {per}, want {want}")
        if fused_head and fce.tma_launches - tma0 != 1 + 3 * nc:
            raise AssertionError(f"{fce.tma_launches - tma0} fused-CE TMA "
                                 f"kernels launched in a step, want "
                                 f"{1 + 3 * nc} (forward, dlogits, dx and "
                                 f"dW of every chunk)")
    launches = _flash_counts() + _fce_counts()
    if fa.plain_calls or fce.plain_calls:
        raise AssertionError(f"{fa.plain_calls} flash and {fce.plain_calls} "
                             f"fused-CE calls ran the plain version")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses}: not finite and falling")
    on_gpu = all(p.is_cuda for p in model.parameters()) and all(
        t.is_cuda for st in opt.state.values() for t in st.values()
        if torch.is_tensor(t))
    if not on_gpu or len(opt.state) != len(list(model.parameters())):
        raise AssertionError("a parameter or optimizer state is not on "
                             "the GPU")
    n_params = sum(p.numel() for p in model.parameters())
    tokens = TRAIN_B * MAX_SEQ
    info = {"phase": "train_fused_head" if fused_head else "train",
            "model": "Llama-3.2-1B (random weights)",
            "source": "meta-llama/Llama-3.2-1B config.json",
            "reduced": {"max_seq": [131072, MAX_SEQ]},
            "dtype": "bfloat16 compute, float32 weights",
            "params": n_params, "batch": [TRAIN_B, MAX_SEQ],
            "optimizer": "AdamW lr 1e-4 wd 1e-4 (fused)",
            "setup_s": setup_s, "losses": losses,
            "step_ms_p50": float(np.median(step_ms)),
            "step_ms_max": float(np.max(step_ms)), "step_ms": step_ms,
            "tokens_per_s": tokens / (float(np.median(step_ms)) / 1e3),
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "flash_launches": launches[:3], "fce_launches": launches[3:],
            "fce_tma_launches": fce.tma_launches}
    extra = then(trainer, model) if then is not None else None
    api.shutdown()
    del model, opt, trainer, batch
    torch.cuda.empty_cache()
    return info, launches, extra


def eval_phase(torch, seed: int, trainer, model) -> dict:
    """Trainer.evaluate with the fused-head loss on 2 fresh full-width
    batches: the forward kernel only, the plain head's mean loss."""
    import numpy as np

    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import fused_cross_entropy as fce
    from byteps_tpu_torch.training import lm_loss_fn

    rng = np.random.RandomState(seed + 1)
    batches = [{"tokens": rng.randint(0, model.cfg.vocab_size,
                                      size=(TRAIN_B, MAX_SEQ))}
               for _ in range(2)]
    fused = lm_loss_fn(model, fused_head=True)
    _zero_counts()
    t0 = time.perf_counter()
    out = trainer.evaluate(
        lambda st, b: {"loss": fused(st.model, {}, b)[0]}, batches)
    eval_s = time.perf_counter() - t0
    counts = _flash_counts() + _fce_counts()
    want = (2 * model.cfg.num_layers, 0, 0, 2, 0, 0)  # forward kernels only
    if counts != want or fa.plain_calls or fce.plain_calls:
        raise AssertionError(f"evaluate launched (flash fwd/dq/dkv, fused CE "
                             f"fwd/dx/dw) {counts}, want {want}")
    if fce.tma_launches != len(batches):
        raise AssertionError(f"{fce.tma_launches} of {len(batches)} fused "
                             f"forwards took the TMA kernel")
    plain = lm_loss_fn(model)
    with torch.no_grad():
        want = float(np.mean([plain(model, {}, {
            "tokens": torch.from_numpy(b["tokens"]).cuda()})[0].item()
            for b in batches]))
    rel = abs(out["loss"] - want) / abs(want)
    if not np.isfinite(out["loss"]) or rel > EVAL_TOL:
        raise AssertionError(f"evaluate loss {out['loss']} vs plain head "
                             f"{want}: {rel} > {EVAL_TOL}")
    return {"phase": "evaluate", "batches": len(batches),
            "loss_fused": out["loss"], "loss_plain_head": want,
            "rel_diff": rel, "tolerance": EVAL_TOL,
            "perplexity": float(np.exp(out["loss"])), "seconds": eval_s,
            "launches": counts}


# ------------------------------------------- BERT and the HF integrations

BERT_B, BERT_T = 32, 128   # the fine-tune batch (bench.py, train_bert.py)
BERT_STEPS = 5             # 4 padded batches, then one with no mask
BERT_MLM = (8, 512)        # BERT's max_seq_len
BERT_LR, BERT_WD = 2e-5, 1e-4
# bf16 flash vs the same weights in fp32 with local attention: logits
# within 5e-2 of max(|logit|, 1) — every product of the bf16 model takes
# operands rounded to bf16 (2^-8 relative) through 12 blocks
BERT_BF16_TOL = 5e-2
# fp32 on the card against fp32 (flash vs local, port vs HF): 1e-4 of the
# largest magnitude (or absolute below 1) — the same sums in other orders
FP32_TOL = 1e-4
# GPT-2 small (``transformers`` ``GPT2Config()`` defaults, the dimensions
# of the published gpt2 checkpoint)
GPT2_SMALL = dict(vocab_size=50257, num_layers=12, num_heads=12, d_model=768,
                  d_ff=3072, max_seq_len=1024, norm="layernorm",
                  norm_eps=1e-5, use_bias=True, tie_embeddings=True,
                  pos_emb="learned", mlp="gelu")
GPT2_GEN = (4, 256, 64)      # prompts, prompt tokens, new tokens
GPT2_TRAIN = (8, 1024, 3)    # batch, tokens a row, fused-head steps
LLAMA_GEN = (4, 256, 32)
HF_NOT_RUN = {"phase": "hf", "run": False,
              "why": "transformers not installed"}


def _transformers():
    """``transformers`` if this host has it, else None: only its
    ImportError says so."""
    try:
        import transformers
    except ImportError:
        return None
    return transformers


def _rel_err(torch, got, want, floor=1.0) -> float:
    """max |got - want| over max(max |want|, floor)."""
    e = (got.float() - want.float()).abs().max().item()
    return e / max(want.float().abs().max().item(), floor)


def _device_events(torch, fn) -> tuple:
    """One call of ``fn`` under torch.profiler: the CUDA kernels it ran as
    ``(name, us)``, and the host wall ms (profiler on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    evs = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    if not evs:
        raise AssertionError("the profiler saw no device time")
    return evs, wall_ms


def _step_profile(torch, fn, groups) -> dict:
    """One call of ``fn`` under torch.profiler: device busy ms, host wall
    ms (profiler on), the device's idle share, and each group's share of
    the busy time (kernels whose names hold the group's string)."""
    evs, wall_ms = _device_events(torch, fn)
    busy = sum(us for _, us in evs)
    by_group = {g: sum(us for n, us in evs if part in n)
                for g, part in groups.items()}
    return {"kernels": len(evs), "device_ms": busy / 1e3,
            "host_ms_profiled": wall_ms,
            "device_idle_share": 1.0 - busy / 1e3 / wall_ms,
            **{f"{g}_share_of_device": t / busy for g, t in by_group.items()},
            **{f"{g}_device_ms": t / 1e3 for g, t in by_group.items()}}


def _bert_batch(torch, np, seed, B, T, vocab, masked=True):
    rng = np.random.RandomState(seed)
    batch = {"tokens": torch.from_numpy(rng.randint(
        0, vocab, size=(B, T))).cuda(),
             "label": torch.from_numpy(rng.randint(0, 2, size=B)).cuda()}
    if masked:
        batch["attention_mask"] = _padding_mask(torch, seed, B, T)
    return batch


def _bert_loss(model, model_state, batch):
    """``examples/train_bert.py``'s loss: softmax cross-entropy of the
    classifier's logits on the labels."""
    import torch.nn.functional as F

    logits = model(batch["tokens"], batch.get("attention_mask"))
    return F.cross_entropy(logits, batch["label"]), model_state


def bert_reference_phase(torch, seed: int) -> dict:
    """BERT-base at full width in fp32: ``attn_impl="flash"`` (the fp32
    kernels, the mask on their segment ids) against ``"local"`` on the
    same weights and a padded batch: logits and every gradient."""
    import numpy as np
    import torch.nn.functional as F

    from byteps_tpu_torch.models.bert import BertClassifier, bert_config
    from byteps_tpu_torch.models.transformer import init_weights
    from byteps_tpu_torch.ops import flash_attention as fa

    models = {}
    for impl in ("local", "flash"):
        m = BertClassifier(bert_config(dtype=torch.float32, attn_impl=impl),
                           2, device="cuda")
        if impl == "local":
            init_weights(m, seed)
        else:
            m.load_state_dict(models["local"].state_dict())
        models[impl] = m
    batch = _bert_batch(torch, np, seed, BERT_B, BERT_T, 30522)
    out, grads = {}, {}
    _zero_counts()
    for impl, m in models.items():
        logits = m(batch["tokens"], batch["attention_mask"])
        F.cross_entropy(logits, batch["label"]).backward()
        out[impl] = logits.detach()
        grads[impl] = {n: p.grad for n, p in m.named_parameters()}
    counts = _flash_counts()
    L = models["flash"].encoder.cfg.num_layers
    if counts != (L, L, L) or fa.plain_calls:
        raise AssertionError(f"fp32 BERT flash launches {counts}, plain "
                             f"{fa.plain_calls}; want {L} of each, 0 plain")
    err = _rel_err(torch, out["flash"], out["local"])
    gerr = max(_rel_err(torch, grads["flash"][n], g, 1e-30)
               for n, g in grads["local"].items())
    if not (err <= FP32_TOL and gerr <= FP32_TOL):
        raise AssertionError(f"BERT fp32 flash vs local: logits {err}, "
                             f"grads {gerr} > {FP32_TOL}")
    del models, grads
    torch.cuda.empty_cache()
    return {"phase": "bert_reference", "batch": [BERT_B, BERT_T],
            "lengths": batch["attention_mask"].sum(1).tolist(),
            "logits_err": err, "grads_err_of_max": gerr,
            "tolerance": FP32_TOL, "flash_launches": counts}


def bert_phase(torch, seed: int):
    """The BERT-base fine-tune (the main path of this slice): returns the
    phase line, the launch counts of the 5 steps and the held calls."""
    import numpy as np

    from byteps_tpu_torch import api
    from byteps_tpu_torch.models.bert import BertClassifier, bert_config
    from byteps_tpu_torch.models.transformer import init_weights
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.training import Trainer

    cfg = bert_config(attn_impl="flash", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = BertClassifier(cfg, 2, device="cuda")      # fp32 weights
    init_weights(model, seed)
    batches = [_bert_batch(torch, np, seed + i, BERT_B, BERT_T,
                           cfg.vocab_size, masked=i < BERT_STEPS - 1)
               for i in range(BERT_STEPS)]
    # the reference: the same weights in fp32, local attention
    ref = BertClassifier(bert_config(dtype=torch.float32), 2, device="cuda")
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        b = batches[0]
        ref_err = _rel_err(torch, model(b["tokens"], b["attention_mask"]),
                           ref(b["tokens"], b["attention_mask"]))
    del ref
    if ref_err > BERT_BF16_TOL:
        raise AssertionError(f"BERT bf16 flash vs fp32 local logits: "
                             f"{ref_err} > {BERT_BF16_TOL}")
    opt = torch.optim.AdamW(model.parameters(), lr=BERT_LR,
                            weight_decay=BERT_WD)
    trainer = Trainer(_bert_loss, opt, log_every=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    trainer.fit(model, {}, [batches[0]])                # warm-up
    losses = [trainer.metrics["loss"].item()]
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    step_ms = []
    with _PathCalls() as path:
        for b in batches:
            before = _flash_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            trainer.fit(model, {}, [b])
            losses.append(trainer.metrics["loss"].item())   # synchronizes
            step_ms.append((time.perf_counter() - t1) * 1e3)
            per = tuple(a - c for a, c in zip(_flash_counts(), before))
            if per != (cfg.num_layers,) * 3:
                raise AssertionError(f"BERT step flash launches {per}, "
                                     f"want {cfg.num_layers} of each")
    launches = _flash_counts()
    if fa.plain_calls:
        raise AssertionError(f"{fa.plain_calls} flash calls ran the plain "
                             f"version")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"BERT losses {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    held = path.hold(torch)
    if sorted(len(h.get("backward_held", ())) for h in held) != [3, 3]:
        raise AssertionError(f"BERT held calls: {held}")
    prof = _step_profile(torch, lambda: trainer.fit(model, {}, [batches[0]]),
                         {"flash": "flash_"})
    p50 = float(np.median(step_ms))
    valid = sum(int(b["attention_mask"].sum()) if "attention_mask" in b
                else BERT_B * BERT_T for b in batches)
    info = {"phase": "bert_finetune",
            "model": "BERT-base classifier (random weights)",
            "source": "transformers BertConfig() defaults (bert-base-"
                      "uncased): 12 x 768, 12 heads, 3072, vocab 30522",
            "dtype": "bfloat16 compute, float32 weights",
            "attn_impl": "flash", "batch": [BERT_B, BERT_T],
            "steps": BERT_STEPS, "optimizer": "AdamW lr 2e-5 wd 1e-4",
            "setup_s": setup_s, "losses": losses,
            "ref_logits_err": ref_err, "ref_tolerance": BERT_BF16_TOL,
            "step_ms": step_ms, "step_ms_p50": p50,
            "tokens_per_s": BERT_B * BERT_T / (p50 / 1e3),
            "valid_tokens_per_s": valid / (sum(step_ms) / 1e3),
            "max_memory_allocated_gb": peak_gb,
            "flash_launches": launches, "plain_calls": fa.plain_calls,
            "profile_one_step": prof, "held": held, "nvidia_smi": _smi()}
    api.shutdown()
    del model, opt, trainer
    torch.cuda.empty_cache()
    return info, launches, held


def bert_mlm_phase(torch, seed: int) -> dict:
    """One BertMLM forward and backward at B=8, T=512 (BERT's max_seq_len,
    vocab 30522), padded rows: 12 launches of each flash kernel."""
    import numpy as np
    import torch.nn.functional as F

    from byteps_tpu_torch.models.bert import BertMLM, bert_config
    from byteps_tpu_torch.models.transformer import init_weights
    from byteps_tpu_torch.ops import flash_attention as fa

    B, T = BERT_MLM
    cfg = bert_config(attn_impl="flash", dtype=torch.bfloat16)
    model = BertMLM(cfg, device="cuda")
    init_weights(model, seed)
    batch = _bert_batch(torch, np, seed, B, T, cfg.vocab_size)
    mask = batch["attention_mask"]

    def step():
        logits = model(batch["tokens"], mask)
        ce = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                             batch["tokens"].reshape(-1), reduction="none")
        loss = (ce * mask.reshape(-1)).sum() / mask.sum()
        loss.backward()
        return loss

    step()                                              # warm-up
    model.zero_grad(set_to_none=True)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = step().item()
    ms = (time.perf_counter() - t0) * 1e3
    counts = _flash_counts()
    if counts != (cfg.num_layers,) * 3 or fa.plain_calls \
            or not np.isfinite(loss):
        raise AssertionError(f"BertMLM: launches {counts}, plain "
                             f"{fa.plain_calls}, loss {loss}")
    grads_finite = all(torch.isfinite(p.grad).all().item()
                       for p in model.parameters() if p.grad is not None)
    if not grads_finite:
        raise AssertionError("BertMLM: a non-finite gradient")
    del model
    torch.cuda.empty_cache()
    return {"phase": "bert_mlm", "batch": [B, T], "vocab": cfg.vocab_size,
            "loss": loss, "step_ms": ms, "flash_launches": counts}


def hf_bert_phase(torch, seed: int, hf) -> dict:
    """A stock HF ``BertForSequenceClassification`` (random weights, fp32,
    dropout off) through ``flash_attention_for_hf_bert``: padded batches at
    B=32, T=128; inside the context the CLS logits and the valid
    positions' hidden states equal the stock model's outside it, also on
    a fresh context's unpadded first call; two train steps inside it (the
    second counted and timed), all on the kernels."""
    import numpy as np

    from byteps_tpu_torch.integrations import flash_attention_for_hf_bert
    from byteps_tpu_torch.ops import flash_attention as fa

    torch.manual_seed(seed)
    model = hf.BertForSequenceClassification(hf.BertConfig(
        attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0)).cuda()
    model.eval()
    impl = model.config._attn_implementation
    batch = _bert_batch(torch, np, seed, BERT_B, BERT_T,
                        model.config.vocab_size)
    tok, mask = batch["tokens"], batch["attention_mask"]
    with torch.no_grad():
        stock = model(tok, attention_mask=mask, output_hidden_states=True)
        _zero_counts()
        with flash_attention_for_hf_bert() as counts:
            got = model(tok, attention_mask=mask, output_hidden_states=True)
    L = model.config.num_hidden_layers
    fwd = _flash_counts()
    if fwd != (L, 0, 0) or counts.covered != L or counts.uncovered_total:
        raise AssertionError(f"HF BERT forward: launches {fwd}, covered "
                             f"{counts.covered}, uncovered "
                             f"{dict(counts.uncovered)}")
    keep = mask.bool()
    logits_err = _rel_err(torch, got.logits, stock.logits)
    hidden_err = max(_rel_err(torch, h[keep], w[keep]) for h, w in zip(
        got.hidden_states, stock.hidden_states))
    if not (logits_err <= FP32_TOL and hidden_err <= FP32_TOL):
        raise AssertionError(f"HF BERT in the context vs stock: logits "
                             f"{logits_err}, hidden {hidden_err}")
    # a fresh context whose first call has nothing padded (SDPA BERT hands
    # the attention no mask then)
    with torch.no_grad():
        stock_full = model(tok).logits
        _zero_counts()
        with flash_attention_for_hf_bert() as full_counts:
            got_full = model(tok).logits
    full_err = _rel_err(torch, got_full, stock_full)
    if (_flash_counts() != (L, 0, 0) or full_counts.covered != L
            or full_counts.uncovered_total or not full_err <= FP32_TOL):
        raise AssertionError(f"HF BERT unpadded first call: launches "
                             f"{_flash_counts()}, covered "
                             f"{full_counts.covered}, logits {full_err}")
    model.train()
    opt = torch.optim.AdamW(model.parameters(), lr=BERT_LR,
                            weight_decay=BERT_WD)
    ms = []
    for _ in range(2):     # a first step, then the counted one
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with flash_attention_for_hf_bert() as train_counts:
            loss = model(tok, attention_mask=mask,
                         labels=batch["label"]).loss
            loss.backward()
            opt.step()
            opt.zero_grad()
        loss = loss.item()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = _flash_counts()
    if (launches != (L, L, L) or fa.plain_calls
            or train_counts.uncovered_total or not np.isfinite(loss)):
        raise AssertionError(f"HF BERT train step: launches {launches}, "
                             f"plain {fa.plain_calls}, uncovered "
                             f"{dict(train_counts.uncovered)}, loss {loss}")
    del model, opt
    torch.cuda.empty_cache()
    return {"phase": "hf_bert", "transformers": hf.__version__,
            "attn_implementation": impl,
            "batch": [BERT_B, BERT_T], "dtype": "float32",
            "logits_err": logits_err, "valid_hidden_err": hidden_err,
            "unpadded_first_call_logits_err": full_err,
            "tolerance": FP32_TOL, "covered": counts.covered,
            "uncovered": dict(counts.uncovered),
            "first_train_step_ms": ms[0], "train_step_ms": ms[1],
            "train_loss": loss,
            "train_launches": launches,
            "train_uncovered": dict(train_counts.uncovered)}


def _gen_run(torch, np, model, prompt, new, want, name, path=None, **kw):
    """One greedy ``make_generate_fn`` run (``kw``: its cache options) at
    the counts set to 0 just before it: the launches held to ``want``, the
    tokens on the GPU and in the vocabulary; with a :class:`_PathCalls`
    ``path``, the first call of each shape to the kernels held to its
    plain version after the run.  Returns the tokens and the run's line."""
    from byteps_tpu_torch.inference import make_generate_fn

    fn = make_generate_fn(model, new, temperature=0, **kw)
    events = []

    def on_step(i):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with path or contextlib.nullcontext():
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        out = fn(prompt, on_step=on_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _gen_counts()
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, want {want}")
    if not out["tokens"].is_cuda:
        raise AssertionError(f"{name}: tokens are not on the GPU")
    B = prompt.shape[0]
    toks = out["tokens"].cpu().numpy()
    if toks.shape != (B, new) or toks.min() < 0 \
            or toks.max() >= model.cfg.vocab_size:
        raise AssertionError(f"{name}: bad tokens {toks.shape}")
    dec = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    p50 = float(np.median(dec))
    line = {"run": name, "prompt": list(prompt.shape), "new": new,
            "layout": kw.get("cache_layout", "auto"),
            "kv_quant": kw.get("kv_quant", False),
            "prefill_ms": start.elapsed_time(events[0]),
            "decode_ms_p50": p50, "decode_ms_max": float(np.max(dec)),
            "wall_s": wall, "tokens_per_s": B * new / wall,
            "decode_tokens_per_s": B / (p50 / 1e3),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts}
    if path is not None:
        line["held"] = path.hold(torch)
    return toks, line


def _gen_want(L, new, q_rows=0):
    """A greedy run's counts: one flash prefill a layer, a decode launch a
    layer a step, and ``q_rows`` int8 products a forward (the prefill's
    on tma, every step's on swap)."""
    steps = new - 1
    return {"flash_fwd": L, "decode": steps * L,
            "quant_dot": new * q_rows,
            "quant_dot_by_design": {"tile": 0, "swap": steps * q_rows,
                                    "tma": q_rows},
            "plain": 0}


def gpt2_phase(torch, seed: int, hf):
    """GPT-2 small through ``load_gpt2`` (or, without ``transformers``, the
    port's own model at its dimensions): the fp32 prompt logits against
    HF's forward; greedy generation in bf16 (flash prefill, the decode
    kernel at one query head a KV head), again under ``quantize_params``
    (the int8 product on q, k, v, o and the MLP; the tied head stays);
    3 fused-head training steps at V = 50257.  Returns the line and the
    counts."""
    import numpy as np

    from byteps_tpu_torch import api
    from byteps_tpu_torch.inference import quantize_params
    from byteps_tpu_torch.integrations.gpt2 import load_gpt2
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)
    from byteps_tpu_torch.ops import fused_cross_entropy as fce
    from byteps_tpu_torch.training import Trainer, lm_loss_fn

    B, T, new = GPT2_GEN
    rng = np.random.RandomState(seed)
    prompt = torch.from_numpy(rng.randint(0, 50257, size=(B, T))).cuda()
    info = {"phase": "gpt2", "source": "transformers GPT2Config() defaults "
            "(gpt2, 124M): 12 x 768, 12 heads, 3072, vocab 50257, 1024 "
            "positions, tied head"}
    if hf is not None:
        torch.manual_seed(seed)
        hf_model = hf.GPT2LMHeadModel(hf.GPT2Config()).cuda().eval()

        def model_of(dtype):
            return load_gpt2(hf_model, dtype=dtype, attn_impl="flash")

        m32 = load_gpt2(hf_model)                        # fp32, local
        with torch.no_grad():
            want = hf_model(prompt).logits
            got = m32(prompt)
        info["hf_logits_err"] = _rel_err(torch, got, want)
        info["hf_tolerance"] = FP32_TOL
        if info["hf_logits_err"] > FP32_TOL:
            raise AssertionError(f"GPT-2 vs HF: {info['hf_logits_err']}")
        del m32, want, got
        info["weights"] = "random GPT2LMHeadModel(GPT2Config()) via " \
                          "load_gpt2"
    else:
        def model_of(dtype):
            m = Transformer(TransformerConfig(**GPT2_SMALL, dtype=dtype,
                                              attn_impl="flash"),
                            device="cuda")
            init_weights(m, seed)
            return m
        info["weights"] = "the port's Transformer at GPT-2 small's " \
                          "dimensions, init_weights(seed)"
    model = model_of(torch.bfloat16)
    L = model.cfg.num_layers
    runs = {}
    toks, runs["bf16"] = _gen_run(torch, np, model, prompt, new,
                                  _gen_want(L, new), "bf16", _PathCalls())
    toks2, runs["bf16_rerun"] = _gen_run(torch, np, model, prompt, new,
                                         _gen_want(L, new), "bf16_rerun",
                                         _PathCalls())
    if not (toks == toks2).all():
        raise AssertionError("GPT-2 greedy reruns differ")
    quantize_params(model)
    q_toks, runs["int8_weights"] = _gen_run(
        torch, np, model, prompt, new, _gen_want(L, new, 6 * L),
        "int8_weights", _PathCalls())
    info["runs"] = runs
    del model
    # the fused LM head at V = 50257 (a vocab tail no tile divides)
    Bt, Tt, steps = GPT2_TRAIN
    model = model_of(torch.bfloat16)
    batch = {"tokens": torch.from_numpy(rng.randint(
        0, 50257, size=(Bt, Tt))).cuda()}
    nc = fce.vocab_chunks(model.cfg.vocab_size)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    losses, step_ms = [], []
    _zero_counts()
    with _PathCalls() as path:
        trainer = Trainer(lm_loss_fn(model, fused_head=True), opt,
                          log_every=0)
        for _ in range(steps):
            tma0 = fce.tma_launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.fit(model, {}, [batch])
            losses.append(trainer.metrics["loss"].item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if fce.tma_launches - tma0 != 1 + 3 * nc:
                raise AssertionError(f"GPT-2 fused step: "
                                     f"{fce.tma_launches - tma0} TMA "
                                     f"launches, want {1 + 3 * nc}")
    launches = _flash_counts() + _fce_counts()
    tma = fce.tma_launches
    if launches != (steps * L,) * 3 + (steps, steps * nc, steps * nc) \
            or fce.plain_calls or not np.all(np.isfinite(losses)):
        raise AssertionError(f"GPT-2 fused training: launches {launches}, "
                             f"plain {fce.plain_calls}, losses {losses}")
    held = path.hold(torch)
    if sum(h["kernel"] == "fused_linear_cross_entropy" for h in held) != 1:
        raise AssertionError(f"GPT-2 fused training held {held}")
    info["train"] = {"batch": [Bt, Tt], "losses": losses,
                     "step_ms": step_ms, "launches": launches,
                     "tma_launches": tma, "held": held}
    api.shutdown()
    del model, opt, trainer
    if hf is not None:
        del hf_model
    torch.cuda.empty_cache()
    return info, runs, launches


def llama_phase(torch, seed: int, hf):
    """Llama-3.2-1B through ``load_llama`` from a random
    ``LlamaForCausalLM`` at its published dimensions (llama3 rope scaling,
    head_dim 64, tied head; or, without ``transformers``, the port's own
    model): the fp32 prompt logits against HF's forward, then greedy
    generation in bf16.  Returns the line and the run."""
    import numpy as np

    from byteps_tpu_torch.integrations.llama import load_llama
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)

    B, T, new = LLAMA_GEN
    prompt = torch.from_numpy(np.random.RandomState(seed).randint(
        0, LLAMA_3_2_1B["vocab_size"], size=(B, T))).cuda()
    info = {"phase": "llama", "source": "meta-llama/Llama-3.2-1B "
            "config.json", "reduced": {"max_seq": [131072, MAX_SEQ]}}
    if hf is not None:
        c = LLAMA_3_2_1B
        torch.manual_seed(seed)
        cfg = hf.LlamaConfig(
            vocab_size=c["vocab_size"], hidden_size=c["d_model"],
            intermediate_size=c["d_ff"], num_hidden_layers=c["num_layers"],
            num_attention_heads=c["num_heads"],
            num_key_value_heads=c["num_kv_heads"], head_dim=c["head_dim"],
            max_position_embeddings=131072, rms_norm_eps=c["norm_eps"],
            rope_theta=c["rope_theta"], rope_scaling=dict(c["rope_scaling"]),
            tie_word_embeddings=True, hidden_act="silu")
        with torch.device("cuda"):
            hf_model = hf.LlamaForCausalLM(cfg).eval()
        m32 = load_llama(hf_model, max_seq_len=MAX_SEQ)   # fp32, local
        got_cfg = {k: getattr(m32.cfg, k) for k in LLAMA_3_2_1B
                   if k != "head_dim"}
        got_cfg["head_dim"] = m32.cfg.d_head    # None when implied
        if got_cfg != LLAMA_3_2_1B:
            raise AssertionError(f"llama_config of the HF config: {got_cfg}")
        with torch.no_grad():
            want = hf_model(prompt[:2]).logits
            got = m32(prompt[:2])
        info["hf_logits_err"] = _rel_err(torch, got, want)
        info["hf_tolerance"] = FP32_TOL
        if info["hf_logits_err"] > FP32_TOL:
            raise AssertionError(f"Llama vs HF: {info['hf_logits_err']}")
        del m32, want, got
        model = load_llama(hf_model, dtype=torch.bfloat16, attn_impl="flash",
                           max_seq_len=MAX_SEQ)
        del hf_model
        info["weights"] = "random LlamaForCausalLM via load_llama"
    else:
        model = Transformer(TransformerConfig(
            **LLAMA_3_2_1B, max_seq_len=MAX_SEQ, dtype=torch.bfloat16,
            attn_impl="flash"), device="cuda")
        init_weights(model, seed)
        info["weights"] = "the port's Transformer, init_weights(seed)"
    torch.cuda.empty_cache()
    toks, run = _gen_run(torch, np, model, prompt, new,
                         _gen_want(model.cfg.num_layers, new), "bf16",
                         _PathCalls())
    info["run"] = run
    del model
    torch.cuda.empty_cache()
    return info, run


# --------------------------------------------------------- flash kernels

FLASH_MAIN = dict(B=TRAIN_B, T=MAX_SEQ, H=32, KV=8, D=64, causal=True,
                  window=None, seg=False, alibi=False)
FLASH_CASES = (("training_shape", {}), ("noncausal", {"causal": False}),
               ("window256", {"window": 256}), ("two_documents", {"seg": True}),
               ("alibi", {"alibi": True}), ("mqa", {"KV": 1}),
               ("head_dim32", {"D": 32}), ("head_dim128", {"D": 128}),
               ("t2000", {"T": 2000}))
# BERT-base's fine-tune shape (phase 13c): non-causal, padding segment ids
# 1...1 0...0 of seeded lengths in [1, T] (row 0 unpadded, row 1 one valid
# token), H = KV = 12, two 64-row tiles; timed beside SDPA under the key
# mask
FLASH_BERT = ("bert_padding", {"B": 32, "T": 128, "H": 12, "KV": 12,
                               "causal": False, "seg": "padding"})


def _flash_inputs(torch, seed, c, dtype):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def t(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    B, T, H, KV, D = c["B"], c["T"], c["H"], c["KV"], c["D"]
    q, k, v, do = t(B, T, H, D), t(B, T, KV, D), t(B, T, KV, D), t(B, T, H, D)
    seg = None
    if c["seg"] == "padding":
        seg = _padding_mask(torch, seed, B, T).to(torch.int32)
    elif c["seg"]:
        cut = torch.tensor([T // 3 + 97 * b for b in range(B)], device="cuda")
        seg = (torch.arange(T, device="cuda")[None] >= cut[:, None]).to(
            torch.int32)
    slopes = (2.0 ** -torch.arange(1, H + 1, device="cuda").float()
              if c["alibi"] else None)
    return q, k, v, do, seg, slopes


def _padding_mask(torch, seed, B, T):
    """A ``[B, T]`` int64 padding mask on the card: 1 on the first
    ``length`` positions of a row, lengths seeded in [1, T], row 0
    unpadded and row 1 one valid token (phase 13c's batches, phase 9's
    BERT case)."""
    import numpy as np

    lengths = np.random.RandomState(seed).randint(1, T + 1, size=B)
    lengths[:2] = (T, 1)
    return torch.from_numpy((np.arange(T)[None] < lengths[:, None]).astype(
        np.int64)).cuda()


def _bounds(flops, nbytes, elt):
    """Least time (ms) of each kernel: max(FLOPs / the dtype's peak,
    bytes / HBM rate), and which of the two it is."""
    peak = PEAK_FLOPS["bfloat16" if elt == 2 else "float32"]
    out = {}
    for n in flops:
        t_ops = flops[n] / peak * 1e3
        t_bytes = nbytes[n] / HBM_BYTES_PER_S * 1e3
        out[n] = (max(t_ops, t_bytes),
                  "operations" if t_ops >= t_bytes else "bytes")
    return out


def _flash_bounds(fa, c, elt, seg=None):
    """Least time (ms) for each kernel: max(FLOPs / peak, bytes / HBM).
    With padding segment ids (non-causal), only the attended pairs count:
    ``len^2 + (T - len)^2`` a row, what these inputs need."""
    B, T, H, KV, D = c["B"], c["T"], c["H"], c["KV"], c["D"]
    flops = fa.attention_flops(B, T, H, D, c["causal"], c["window"])
    if c["seg"] == "padding":
        n = seg.sum(1).double()
        pairs = float((n * n + (T - n) * (T - n)).sum())
        flops = {k: v * pairs / (B * T * T) for k, v in flops.items()}
    q_bytes, kv_bytes, row_bytes = B * T * H * D * elt, B * T * KV * D * elt, \
        B * H * T * 4
    nbytes = {"fwd": 2 * q_bytes + 2 * kv_bytes + row_bytes,       # q k v o lse
              "dq": 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,    # q do dq k v
              "dkv": 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes}   # q do k v dk dv
    return _bounds(flops, nbytes, elt)


def _kernel_us(torch, fn, flush=None, reps=1) -> dict:
    """Device microseconds per call of ``fn`` by CUDA kernel name, under
    torch.profiler (the L2 flushed before each call if ``flush``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            times[e.name] = times.get(e.name, 0.0) + e.time_range.elapsed_us()
    return {n: t / reps for n, t in times.items()}


def _graph_ms(torch, fn, flush, iters=20, reps=3) -> float:
    """Device ms per call of ``fn`` with the L2 flushed before each call,
    without the host's gaps between launches (which a call of a few
    microseconds can be shorter than): ``iters`` (flush, call) pairs are
    captured in one CUDA graph, and its best replay of ``reps``, timed with
    CUDA events, less the best replay of a graph of the flushes alone, is
    divided by ``iters``."""
    def replay_ms(body):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):       # warm-up off the capture
            body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        best = float("inf")
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            graph.replay()
            e1.record()
            e1.synchronize()
            best = min(best, e0.elapsed_time(e1))
        del graph
        return best

    def calls():
        for _ in range(iters):
            flush.zero_()
            fn()

    def flushes():
        for _ in range(iters):
            flush.zero_()

    return (replay_ms(calls) - replay_ms(flushes)) / iters


class _ReadFlush:
    """An L2 flush by reading 256 MB (a sum), which leaves clean lines
    behind: the write flush (``zero_`` of 256 MB) leaves up to 50 MB of
    dirty lines whose write-back the next call pays for."""

    def __init__(self, torch):
        self.torch = torch
        self.buf = torch.ones(64 << 20, device="cuda")
        self.out = torch.empty((), device="cuda")

    def zero_(self):
        self.torch.sum(self.buf, dim=0, out=self.out)


def _sdpa_kernels(torch, fn) -> list:
    """Names of the CUDA kernels one call of ``fn`` ran, by device time."""
    times = _kernel_us(torch, fn)
    return [n[:80] for n, _ in sorted(times.items(), key=lambda kv: -kv[1])][:3]


def flash_case(torch, name, over, dtype, seed, flush, timed):
    import torch.nn.functional as F

    from byteps_tpu_torch.ops import flash_attention as fa

    c = {**FLASH_MAIN, **over}
    dname = str(dtype).split(".")[-1]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    q, k, v, do, seg, slopes = _flash_inputs(torch, seed, c, dtype)
    opts = (c["causal"], None, seg, c["window"], slopes)
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, *opts)
    delta = (do.float() * o_ref.float()).sum(-1).permute(0, 2, 1).contiguous()
    bwd = (q, k, v, do, lse_ref, delta)
    outs = {"fwd": fa.flash_forward(q, k, v, *opts),
            "dq": (fa.flash_backward_dq(*bwd, *opts),),
            "dkv": fa.flash_backward_dkv(*bwd, *opts)}
    refs = {"fwd": (o_ref, lse_ref),
            "dq": (fa.flash_backward_dq_reference(*bwd, *opts),),
            "dkv": fa.flash_backward_dkv_reference(*bwd, *opts)}
    torch.cuda.synchronize()
    res = {"case": name, "dtype": dname,
           "B_T_H_KV_D": [c["B"], c["T"], c["H"], c["KV"], c["D"]],
           "causal": c["causal"], "window": c["window"], "segments": c["seg"],
           "alibi": c["alibi"], "tolerance": tol}
    # reruns give the same bits: no atomics, every sum in a fixed order
    again = {"dq": (fa.flash_backward_dq(*bwd, *opts),),
             "dkv": fa.flash_backward_dkv(*bwd, *opts)}
    res["rerun_bit_identical"] = {
        n: torch.equal(a, b) for kname in again
        for n, a, b in zip(("dq",) if kname == "dq" else ("dk", "dv"),
                           outs[kname], again[kname])}
    if not all(res["rerun_bit_identical"].values()):
        raise AssertionError(f"flash backward {name} {dname}: a rerun "
                             f"differs: {res['rerun_bit_identical']}")
    for kname in ("fwd", "dq", "dkv"):
        abs_err = rel_err = 0.0
        for out, ref in zip(outs[kname], refs[kname]):
            if not (torch.isfinite(out.float()).all()
                    and torch.isfinite(ref.float()).all()):
                raise AssertionError(f"flash {kname} {name} {dname}: "
                                     f"non-finite output")
            e = (out.float() - ref.float()).abs().max().item()
            abs_err = max(abs_err, e)
            top = ref.float().abs().max().item()
            rel_err = max(rel_err, e / (max(top, 1e-6)
                                        if out.dtype == torch.bfloat16
                                        else max(top, 1.0)))
        if rel_err > tol:
            raise AssertionError(f"flash {kname} {name} {dname}: error "
                                 f"{rel_err} > {tol}")
        res[f"{kname}_max_abs_err"] = abs_err
        res[f"{kname}_err"] = rel_err
    if not timed:
        return res
    kern = {"fwd": lambda: fa.flash_forward(q, k, v, *opts),
            "dq": lambda: fa.flash_backward_dq(*bwd, *opts),
            "dkv": lambda: fa.flash_backward_dkv(*bwd, *opts)}
    plain = {"fwd": lambda: fa.flash_forward_reference(q, k, v, *opts),
             "dq": lambda: fa.flash_backward_dq_reference(*bwd, *opts),
             "dkv": lambda: fa.flash_backward_dkv_reference(*bwd, *opts)}
    bounds = _flash_bounds(fa, c, q.element_size(), seg)
    for kname in kern:
        res[f"{kname}_ms"] = _time_ms(torch, kern[kname], flush, iters=10)
        res[f"{kname}_plain_ms"] = _time_ms(torch, plain[kname], flush,
                                            iters=5)
        res[f"{kname}_bound_ms"], res[f"{kname}_bound_by"] = bounds[kname]
    # the yardstick: one PyTorch call for the same function (with a
    # padding mask, under the same key mask: its pad rows attend the valid
    # keys, so its error is read at the valid rows)
    qd, kd, vd = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dod = do.transpose(1, 2).contiguous()
    mask = (None if c["seg"] != "padding"
            else seg.bool()[:, None, None, :])

    def sdpa():
        return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                              is_causal=c["causal"],
                                              enable_gqa=True)

    out = sdpa()
    res["library_fwd_ms"] = _time_ms(torch, sdpa, flush, iters=10)
    res["library_bwd_ms"] = _time_ms(torch, lambda: torch.autograd.grad(
        out, (qd, kd, vd), dod, retain_graph=True), flush, iters=10)
    rows = (slice(None) if mask is None else seg.bool())
    res["library_fwd_err"] = (out.detach().transpose(1, 2)[rows].float()
                              - o_ref[rows].float()).abs().max().item()
    res["library_fwd_kernels"] = _sdpa_kernels(torch, sdpa)
    res["library_bwd_kernels"] = _sdpa_kernels(torch, lambda: torch.autograd
                                               .grad(out, (qd, kd, vd), dod,
                                                     retain_graph=True))
    return res


def flash_kernel_phase(torch, seed: int):
    """Phase 9: returns the training shape's bf16 line, with the BERT
    case's lines (bf16 and fp32, both timed) under ``"bert"``."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    main, bert = None, {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, over in FLASH_CASES + (FLASH_BERT,):
            r = flash_case(torch, name, over, dtype, seed, flush,
                           timed=not over or name == FLASH_BERT[0])
            _line(r)
            if not over and dtype == torch.bfloat16:
                main = r
            if name == FLASH_BERT[0]:
                bert[r["dtype"]] = r
            torch.cuda.empty_cache()
    main["bert"] = bert
    return main


# ------------------------------------------------------- fused-CE kernels

FCE_MAIN = dict(N=TRAIN_B * MAX_SEQ, H=2048, V=128256)
# (name, shape over FCE_MAIN, whether bf16 takes the kernels on TMA and
# wgmma): H = 2044 rows are 4088 bytes, which TMA cannot describe, so
# bf16 there keeps the first design's mma.sync kernels
FCE_CASES = (("training_shape", {}, True),
             ("ragged_8188_50257", {"N": 8188, "V": 50257}, True),
             ("first_design_8188_2044_50257",
              {"N": 8188, "H": 2044, "V": 50257}, False))
# GPT-2 small's fused head (phase 13f): 8 x 1024 rows, H = 768, V = 50257
# (7 chunks, a vocab tail no tile divides); timed in bf16
FCE_GPT2 = ("gpt2_8192_768_50257", {"N": 8192, "H": 768, "V": 50257}, True)
# name prefixes of the backward's kernels: both designs (fce_dx_kernel,
# fce_dx_tma_kernel, ...)
FCE_KERNELS = ("fce_dlogits", "fce_dx_", "fce_dw_")


def _fce_inputs(torch, seed, c, dtype):
    """x [N, H], the head table [V, H] (w is its transpose view), targets
    with every 4th row -100, a non-uniform cotangent zero on those."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    N, H, V = c["N"], c["H"], c["V"]
    x = torch.randn((N, H), generator=g, device="cuda").to(dtype)
    table = (torch.randn((V, H), generator=g, device="cuda") * 0.02).to(dtype)
    t = torch.randint(0, V, (N,), generator=g, device="cuda")
    t[::4] = -100
    dl = (torch.rand((N,), generator=g, device="cuda") + 0.5) / N * (t >= 0)
    return x, table, t, dl


def _fce_bounds(fce, c, elt):
    """Least time (ms) of each kernel; bytes: x, W, int64 targets, and
    per kernel lse / tl out (forward), lse, dl in and dx out (dx), lse,
    dl in and dW out (dW)."""
    N, H, V = c["N"], c["H"], c["V"]
    x_b, w_b = N * H * elt, V * H * elt
    base = x_b + w_b + 8 * N + 8 * N
    nbytes = {"fwd": base, "dx": base + x_b, "dw": base + w_b}
    return _bounds(fce.fce_flops(N, H, V), nbytes, elt)


def _device_ms(torch, fn, names, flush, reps=3):
    """Device ms per call of ``fn`` of the kernels whose names contain
    each of ``names`` (L2 flushed before each call), and the names of
    every kernel that ran."""
    fn()
    times = _kernel_us(torch, fn, flush, reps)
    ms = {n: sum(t for k, t in times.items() if n in k) / 1e3 for n in names}
    if not all(ms.values()):
        raise AssertionError(f"the profiler saw no device time for {ms}")
    return ms, set(times)


def _fce_path_check(kernels, tma: bool, what: str, forward=True) -> None:
    """The fused-CE kernels that ran (profiler names) are the TMA design's
    forward (if ``forward`` ran), dlogits, dx and dW where ``tma``, else
    the first design's, and none of the other design's."""
    new = FCE_TMA_KERNELS
    old = ("fce_fwd_kernel", "fce_dlogits_kernel", "fce_dx_kernel",
           "fce_dw_kernel")
    want, absent = (new, old) if tma else (old, new)
    ran = [k for k in kernels if "fce_" in k]
    missing = [n for n in want[0 if forward else 1:]
               if not any(n in k for k in ran)]
    stray = [k for k in ran if any(n in k for n in absent)]
    if missing or stray:
        raise AssertionError(f"fused CE {what}: kernels {sorted(ran)}; "
                             f"missing {missing}, not expected {stray}")


def fce_case(torch, name, over, takes_tma, dtype, seed, flush, timed):
    from byteps_tpu_torch.ops import fused_cross_entropy as fce

    c = {**FCE_MAIN, **over}
    dname = str(dtype).split(".")[-1]
    x, table, t, dl = _fce_inputs(torch, seed, c, dtype)
    w = table.t()                     # the tied head's [H, V] view
    valid = t >= 0
    lse_r, tl_r = fce.fce_forward_reference(x, w, t)
    got = {}

    def run():
        got["fwd"] = fce.fce_forward(x, w, t)
        got["bwd"] = fce.fce_backward(x, w, t, lse_r, dl)

    tma_path = takes_tma and dtype == torch.bfloat16
    tma0 = fce.tma_launches
    # the flush leads the profiled run: the profiler may miss the first
    # kernel it sees
    _fce_path_check(_kernel_us(torch, run, flush), tma_path,
                    f"{name} {dname}")
    (lse, tl), (dx, dw) = got["fwd"], got["bwd"]
    tma = fce.tma_launches - tma0
    want_tma = 1 + 3 * fce.vocab_chunks(c["V"]) if tma_path else 0
    if tma != want_tma:
        raise AssertionError(f"fused CE {name} {dname}: the library "
                             f"launched {tma} TMA kernels, want {want_tma}")
    dx_r = fce.fce_backward_dx_reference(x, w, t, lse_r, dl)
    dw_r = fce.fce_backward_dw_reference(x, w, t, lse_r, dl)
    torch.cuda.synchronize()
    outs = {"fwd": ((lse, lse_r), (torch.where(valid, lse - tl, 0.0),
                                   torch.where(valid, lse_r - tl_r, 0.0))),
            "dx": ((dx, dx_r),), "dw": ((dw, dw_r),)}
    fp32 = dtype == torch.float32
    res = {"case": name, "dtype": dname, "N_H_V": [c["N"], c["H"], c["V"]],
           "ignored_rows": int((~valid).sum().item()), "tma_launches": tma}
    for kname, pairs in outs.items():
        # lse and loss: fp32 sums of exact products on both sides, in
        # either dtype
        tol = 1e-5 if kname == "fwd" else 1e-4 if fp32 else 2e-2
        abs_err = rel_err = 0.0
        for out, ref in pairs:
            if not (torch.isfinite(out.float()).all()
                    and torch.isfinite(ref.float()).all()):
                raise AssertionError(f"fused CE {kname} {name} {dname}: "
                                     f"non-finite output")
            e = (out.float() - ref.float()).abs().max().item()
            abs_err = max(abs_err, e)
            rel_err = max(rel_err, e / max(ref.float().abs().max().item(),
                                           1e-30))
        if rel_err > tol:
            raise AssertionError(f"fused CE {kname} {name} {dname}: error "
                                 f"{rel_err} of the largest magnitude > {tol}")
        res.update({f"{kname}_max_abs_err": abs_err, f"{kname}_err": rel_err,
                    f"{kname}_tolerance": tol})
    if (dx[~valid] != 0).any():
        raise AssertionError("an ignored row got a gradient")
    del dx_r, dw_r
    if not timed:
        return res
    bwd = (x, w, t, lse_r, dl)
    res["fwd_ms"] = _time_ms(torch, lambda: fce.fce_forward(x, w, t), flush,
                             iters=10)
    dev, ran = _device_ms(torch, lambda: fce.fce_backward(*bwd),
                          FCE_KERNELS, flush)
    _fce_path_check(ran, tma_path, f"{name} {dname} timed", forward=False)
    res["dlogits_ms"] = dev["fce_dlogits"]
    res["dx_product_ms"] = dev["fce_dx_"]
    res["dx_ms"] = dev["fce_dlogits"] + dev["fce_dx_"]
    res["dw_ms"] = dev["fce_dw_"]
    # the same work on the first design (W rows of stride H + 1, which TMA
    # cannot describe; that design then loads W element by element, and
    # dW, held to the chunk's rule, takes its first design too), then the
    # TMA design again: dW's time on each design, and the SM clock and
    # power each backward runs at
    tab1 = torch.empty((c["V"], c["H"] + 1), dtype=dtype,
                       device="cuda")[:, :c["H"]]
    tab1.copy_(table)
    w1 = tab1.t()
    res["odd_stride_fwd_ms"] = _time_ms(
        torch, lambda: fce.fce_forward(x, w1, t), flush, iters=10)
    dev1, ran = _device_ms(
        torch, lambda: fce.fce_backward(x, w1, t, lse_r, dl), FCE_KERNELS,
        flush)
    _fce_path_check(ran, False, f"{name} {dname} timed, W stride H + 1",
                    forward=False)
    dev2, ran = _device_ms(torch, lambda: fce.fce_backward(*bwd),
                           FCE_KERNELS, flush)
    _fce_path_check(ran, tma_path, f"{name} {dname} timed again",
                    forward=False)
    res["clock_tma_design"] = _clock_under(
        torch, lambda: fce.fce_backward(*bwd))
    res["clock_odd_stride"] = _clock_under(
        torch, lambda: fce.fce_backward(x, w1, t, lse_r, dl))
    del tab1, w1
    res["odd_stride_dlogits_ms"] = dev1["fce_dlogits"]
    res["odd_stride_dx_product_ms"] = dev1["fce_dx_"]
    res["dw_first_design_ms"] = dev1["fce_dw_"]
    res["dw_ms_again"] = dev2["fce_dw_"]
    res["dlogits_ms_again"] = dev2["fce_dlogits"]
    res["dx_product_ms_again"] = dev2["fce_dx_"]
    res["backward_event_ms"] = _time_ms(
        torch, lambda: fce.fce_backward(*bwd), flush, iters=3)
    res["fwd_plain_ms"] = _time_ms(
        torch, lambda: fce.fce_forward_reference(x, w, t), flush, iters=3)
    res["dx_plain_ms"] = _time_ms(
        torch, lambda: fce.fce_backward_dx_reference(*bwd), flush, iters=2)
    res["dw_plain_ms"] = _time_ms(
        torch, lambda: fce.fce_backward_dw_reference(*bwd), flush, iters=2)
    # the yardsticks: cuBLAS's GEMMs of the products each kernel computes
    # (dlogits + dx: both x @ W^T and dlogits @ W; each alone too)
    d = torch.randn((c["N"], c["V"]), device="cuda").to(dtype)
    res["fwd_library_ms"] = _time_ms(torch, lambda: torch.matmul(x, w),
                                     flush, iters=5)
    res["dx_product_library_ms"] = _time_ms(
        torch, lambda: torch.matmul(d, table), flush, iters=5)
    res["dx_library_ms"] = _time_ms(
        torch, lambda: (torch.matmul(x, w), torch.matmul(d, table)), flush,
        iters=5)
    res["dw_library_ms"] = _time_ms(torch, lambda: torch.matmul(d.t(), x),
                                    flush, iters=5)
    del d
    for kname, (b, by) in _fce_bounds(fce, c, x.element_size()).items():
        res[f"{kname}_bound_ms"], res[f"{kname}_bound_by"] = b, by
    # achieved rates: each product is 2·N·V·H FLOPs
    n = fce.fce_flops(c["N"], c["H"], c["V"])["fwd"]
    for kname, ms, flops in (("fwd", res["fwd_ms"], n),
                             ("dlogits", res["dlogits_ms"], n),
                             ("dx_product", res["dx_product_ms"], n),
                             ("dx", res["dx_ms"], 2 * n),
                             ("dw", res["dw_ms"], n),
                             ("fwd_library", res["fwd_library_ms"], n),
                             ("dx_library", res["dx_library_ms"], 2 * n),
                             ("dw_library", res["dw_library_ms"], n)):
        res[f"{kname}_tflops"] = flops / ms / 1e9
    return res


def fce_kernel_phase(torch, seed: int):
    """Phase 13: returns the training shape's bf16 line, with GPT-2's
    shape's bf16 line under ``"gpt2"``."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    main = gpt2 = None
    for dtype in (torch.bfloat16, torch.float32):
        for name, over, takes_tma in FCE_CASES + (FCE_GPT2,):
            bf16 = dtype == torch.bfloat16
            timed = bf16 and (not over or name == FCE_GPT2[0])
            r = fce_case(torch, name, over, takes_tma, dtype, seed, flush,
                         timed)
            _line(r)
            if timed and not over:
                main = r
            elif timed:
                gpt2 = r
            torch.cuda.empty_cache()
    main["gpt2"] = gpt2
    return main

# ------------------------------------------------ data-parallel training

DP_WORLD = 2          # workers of phase 13a (b), one process each
DP_STEPS = 3
DP_LOSS_TOL = 1e-3    # the two-worker losses vs one worker's, relative
DP_TIMEOUT_S = 600.0  # both workers: start, broadcast, 3 steps, hash
# the first step's averaged gradient vs the one-worker run's at these
# leaves (their first DP_GRAD_ROWS rows), relative to each leaf's largest
# |g|: the bf16 gradient limit of the held dx / dW calls
DP_GRAD_LEAVES = ("embed.weight", "blocks.0.attn.q.weight",
                  "blocks.8.mlp.down.weight")
DP_GRAD_ROWS = 4096
DP_GRAD_TOL = 2e-2
DP_BARE_REPS = 10     # bare all_reduces timed a tensor kind, after 2 warm


def dp_eager_phase(torch, seed: int) -> dict:
    """Phase 13a (a): the eager API at one worker on NCCL (module
    docstring)."""
    import math
    import os
    import tempfile

    from byteps_tpu_torch import api
    from byteps_tpu_torch.common.config import get_config, reset_config
    from byteps_tpu_torch.common.context import partition_key
    from byteps_tpu_torch.common.tracing import reset_tracer
    from byteps_tpu_torch.engine.dispatcher import get_engine
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig)

    cfg = TransformerConfig(**LLAMA_3_2_1B, max_seq_len=MAX_SEQ,
                            dtype=torch.bfloat16)
    meta = Transformer(cfg, device="meta")
    shapes = [(n, tuple(p.shape)) for n, p in meta.named_parameters()
              if n == "embed.weight" or n.startswith("blocks.0.")]
    total = sum(math.prod(s) * 4 for _, s in shapes)
    fd, trace = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    # credit for every byte at once: held at 0 while the tensors are
    # enqueued, then released, the queue grants its whole order in one go
    over = {"BYTEPS_TRACE_PATH": trace,
            "BYTEPS_SCHEDULING_CREDIT": str(total + 1)}
    os.environ.update(over)
    reset_config()
    reset_tracer()
    info = {"phase": "dp_eager", "world": 1,
            "tensors": [[n, list(s)] for n, s in shapes]}
    try:
        api.init()
        info["backend"] = api.backend()
        if (api.size(), info["backend"]) != (1, "nccl"):
            raise AssertionError(f"world {api.size()} on "
                                 f"{info['backend']}, want 1 on nccl")
        engine = get_engine()
        bound = get_config().effective_partition_bytes
        names = [n for n, _ in shapes]
        keys = [api.declare(f"avg.{n}") for n in names]
        if keys != list(range(len(names))):
            raise AssertionError(f"declared keys {keys}")
        g = torch.Generator(device="cuda").manual_seed(seed)
        xs = [torch.randn(s, device="cuda", generator=g) for _, s in shapes]
        parts = [-(-x.numel() * 4 // bound) for x in xs]
        held = engine.queue.credits
        if not engine.queue.try_debit(held):
            raise AssertionError("could not hold the engine's credit")
        grants0 = len(engine.grants)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handles = {n: api.push_pull_async(x, name=f"avg.{n}")
                   for n, x in reversed(list(zip(names, xs)))}
        if any(api.poll(h) for h in handles.values()):
            raise AssertionError("a push_pull finished with no credit")
        engine.queue.credit(held)
        outs = {n: api.synchronize(h) for n, h in handles.items()}
        info["avg_ms"] = (time.perf_counter() - t0) * 1e3
        granted = [g_[0] for g_ in list(engine.grants)[grants0:]]
        # priority -declared_key: (priority desc, key asc) sorts by
        # (declared key, partition key)
        predicted = [name for _, _, name in sorted(
            (k, partition_key(k, i),
             f"avg.{n}_{i}" if p > 1 else f"avg.{n}")
            for k, n, p in zip(keys, names, parts) for i in range(p))]
        info["grant_order_as_predicted"] = granted == predicted
        info["granted_first"] = granted[:3]
        info["partitions_per_tensor"] = dict(zip(names, parts))
        if granted != predicted:
            raise AssertionError(f"grant order {granted[:12]}... vs "
                                 f"(priority desc, key asc) "
                                 f"{predicted[:12]}...")
        bad = [n for n, x in zip(names, xs) if not torch.equal(outs[n], x)]
        polls = 0
        h = api.push_pull_async(xs[1], average=False, name="sum.one")
        while not api.poll(h):
            polls += 1
            time.sleep(1e-4)
        if not torch.equal(api.synchronize(h), xs[1]):
            bad.append("sum.one")
        # again with the communicator up: the first collective on a
        # group initializes NCCL inside avg_ms
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sums = [api.push_pull_async(x, average=False, name=f"sum.{n}")
                for n, x in zip(names, xs)]
        sums = [api.synchronize(h) for h in sums]
        info["sum_ms"] = (time.perf_counter() - t0) * 1e3
        bad += [f"sum.{n}" for n, x, y in zip(names, xs, sums)
                if not torch.equal(y, x)]
        idx = torch.tensor([3, 3, 7, 5000, 5], device="cuda")
        vals = torch.randn(5, cfg.d_model, device="cuda", generator=g)
        want = torch.zeros(64, cfg.d_model)
        for i, v in zip(idx.tolist(), vals.cpu()):
            if i < 64:
                want[i] += v
        if not torch.equal(api.push_pull_sparse(idx, vals, 64).cpu(), want):
            bad.append("push_pull_sparse")
        if not torch.equal(api.broadcast(xs[2]), xs[2]):
            bad.append("broadcast")
        layer = torch.nn.ParameterDict({n.replace(".", "_"):
                                        torch.nn.Parameter(x.clone())
                                        for n, x in zip(names, xs)})
        if api.broadcast_parameters(layer) is not layer or not all(
                torch.equal(layer[n.replace(".", "_")], x)
                for n, x in zip(names, xs)):
            bad.append("broadcast_parameters")
        if bad:
            raise AssertionError(f"not the world of one's bits: {bad}")
        info["polls_before_done"] = polls
        info["engine"] = dict(engine.counts)
    finally:
        api.shutdown()           # flushes the trace
        for k in over:
            os.environ.pop(k, None)
        reset_config()
        reset_tracer()
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    os.unlink(trace)
    per = {}
    for e in events:
        if e.get("ph") == "X" and e["name"].startswith("avg."):
            per.setdefault(e["name"], set()).add(e["cat"])
    n_parts = sum(parts)
    if len(per) != n_parts or any(v != {"dispatch", "push_pull"}
                                  for v in per.values()):
        raise AssertionError(f"trace: {len(per)} partitions with spans, "
                             f"want {n_parts} with dispatch and push_pull")
    info["trace_events"] = len(events)
    info["trace_partitions"] = len(per)
    info["trace_events_per_partition"] = 2
    torch.cuda.empty_cache()
    return info


def _union_ms(spans) -> float:
    """Milliseconds covered by the union of ``(start_us, end_us)``."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def dp_worker(torch, seed: int, out: str) -> int:
    """One worker of phase 13a (b), run by the port's launcher: the
    fused-head Llama-3.2-1B step on this rank's rows through
    ``Trainer.fit`` at world 2, gloo on the shared card."""
    import hashlib
    import os

    import numpy as np
    import torch.distributed as dist

    from byteps_tpu_torch import api
    from byteps_tpu_torch.common.config import get_config
    from byteps_tpu_torch.common.tracing import get_tracer
    from byteps_tpu_torch.engine.dispatcher import get_engine
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import fused_cross_entropy as fce
    from byteps_tpu_torch.training import Trainer, lm_loss_fn

    api.init(device="cuda", backend="gloo")
    rank, world = api.rank(), api.size()
    cfg = TransformerConfig(**LLAMA_3_2_1B, max_seq_len=MAX_SEQ,
                            dtype=torch.bfloat16, attn_impl="flash")
    nc = fce.vocab_chunks(cfg.vocab_size)
    want = (cfg.num_layers,) * 3 + (1, nc, nc)
    model = Transformer(cfg, device="cuda")
    init_weights(model, seed + rank)     # rank 0's are phase 11's
    leaves = dict(model.named_parameters())
    local = {}

    def keep(n):
        def hook(p):
            if n not in local:               # the first step's, unreduced
                local[n] = p.grad[:DP_GRAD_ROWS].detach().clone()
        return hook

    # registered before the DistributedOptimizer's hooks, so each runs
    # first, while the gradient is still this rank's own
    for n in DP_GRAD_LEAVES:
        leaves[n].register_post_accumulate_grad_hook(keep(n))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4, fused=True)
    toks = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(TRAIN_B, MAX_SEQ))
    per = TRAIN_B // world
    batch = {"tokens": torch.from_numpy(
        toks[rank * per:(rank + 1) * per]).cuda()}
    with _PathCalls() as path:     # the loss binds the fused CE here
        trainer = Trainer(lm_loss_fn(model, fused_head=True), opt,
                          log_every=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.state = trainer.init_state(model)     # rank 0's weights
        torch.cuda.synchronize()
        bcast_s = time.perf_counter() - t0
        engine, tracer = get_engine(), get_tracer()
        plan = trainer.step_fn.optimizer._bps_plan
        torch.cuda.reset_peak_memory_stats()
        steps = []
        for i in range(DP_STEPS):
            _zero_counts()
            c0 = engine.counts["collectives"]
            g0 = engine.counts["gather_ms"]
            torch.cuda.synchronize()
            tracer.instant("step_start", "dp", step=i)
            t1 = time.perf_counter()
            trainer.fit(model, {}, [batch])
            loss = trainer.metrics["loss"].item()     # synchronizes
            ms = (time.perf_counter() - t1) * 1e3
            tracer.instant("step_end", "dp", step=i)
            launches = _flash_counts() + _fce_counts()
            if launches != want or fce.tma_launches != 1 + 3 * nc \
                    or fa.plain_calls or fce.plain_calls:
                raise AssertionError(
                    f"rank {rank} step {i}: launches {launches} (want "
                    f"{want}), {fce.tma_launches} TMA (want {1 + 3 * nc}), "
                    f"plain calls {fa.plain_calls}/{fce.plain_calls}")
            steps.append({"loss": loss, "ms": ms, "launches": launches,
                          "collectives": engine.counts["collectives"] - c0,
                          "gather_ms": engine.counts["gather_ms"] - g0})
            if i == 0:       # the averaged gradient, and this rank's own
                torch.save({"local": {n: g.cpu() for n, g in local.items()},
                            "avg": {n: leaves[n].grad[:DP_GRAD_ROWS].cpu()
                                    for n in DP_GRAD_LEAVES}},
                           out + ".grads.pt")
    peak = torch.cuda.max_memory_allocated()
    # one partition's all_reduce with nothing else on the wire: the
    # default group (gloo, as the engine's), idle while the engine is
    bare = {}
    elems = get_config().effective_partition_bytes // 4
    for kind in ("cuda", "cpu"):
        t = torch.ones(elems, device=kind)
        times = []
        for k in range(2 + DP_BARE_REPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dist.all_reduce(t)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        bare[kind] = float(np.median(times[2:]))
    h = hashlib.sha256()
    for _, p in model.named_parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    cycles = engine.counts["cycles"]
    del trainer, opt, model, leaves, local, batch
    torch.cuda.empty_cache()
    held = path.hold(torch)
    api.shutdown()                                      # flushes the trace
    with open(os.environ["BYTEPS_TRACE_PATH"]) as f:
        events = json.load(f)["traceEvents"]
    marks = {(e["name"], e["args"]["step"]): e["ts"] for e in events
             if e.get("cat") == "dp"}
    for i, st in enumerate(steps):
        a, b = marks[("step_start", i)], marks[("step_end", i)]
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") in ("dispatch", "push_pull")
                 and a <= e["ts"] <= b]
        done = {e["name"]: e["ts"] + e["dur"] for e in spans
                if e["cat"] == "push_pull"}
        st["push_pull_busy_ms"] = _union_ms(
            [(e["ts"], e["ts"] + e["dur"]) for e in spans
             if e["cat"] == "push_pull"])
        st["push_pull_spans"] = len(done)
        st["push_pull_span_ms_p50"] = float(np.median(
            [e["dur"] for e in spans if e["cat"] == "push_pull"])) / 1e3
        st["dispatch_to_done_ms_p50"] = float(np.median(
            [done[e["name"]] - e["ts"] for e in spans
             if e["cat"] == "dispatch" and e["name"] in done])) / 1e3
    with open(out, "w") as f:
        json.dump({"rank": rank, "world": world, "backend": "gloo",
                   "device": torch.cuda.get_device_name(0),
                   "broadcast_s": bcast_s, "steps": steps,
                   "buckets": plan.num_buckets,
                   "bucket_bytes": sum(b.nbytes for b in plan.buckets),
                   "agreement_cycles": cycles, "peak_memory_gb": peak / 1e9,
                   "bare_all_reduce_bytes": elems * 4,
                   "bare_all_reduce_ms_p50": bare,
                   "params_sha256": h.hexdigest(),
                   "predicted_launches": want, "held": held}, f)
    return 0


def _launch_workers(flag: str, seed: int, tmp: str, env_over=None,
                    args=(), timeout: float = DP_TIMEOUT_S) -> tuple:
    """``DP_WORLD`` workers through the port's launcher (``DMLC_ROLE=
    worker``, a free ``DMLC_PS_ROOT_PORT``, and ``env_over``), each
    running this script with ``flag`` (and ``args``) and tracing to
    ``tmp/trace{r}.json``; every one still running at ``timeout`` is
    killed.  Returns each worker's JSON result and the wall seconds; a
    worker that failed fails the phase with its log's tail."""
    import os

    from byteps_tpu_torch.engine.transport import free_port

    port = free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(DP_WORLD):
            log = open(os.path.join(tmp, f"worker{r}.log"), "w")
            env = _child_env({
                "DMLC_ROLE": "worker", "DMLC_NUM_WORKER": str(DP_WORLD),
                "DMLC_WORKER_ID": str(r), "DMLC_PS_ROOT_URI": "127.0.0.1",
                "DMLC_PS_ROOT_PORT": str(port),
                "BYTEPS_TRACE_PATH": os.path.join(tmp, f"trace{r}.json"),
                **(env_over or {})})
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "byteps_tpu_torch.launcher",
                 sys.executable, os.path.join(here, "chip_smoke.py"),
                 flag, "--seed", str(seed), "--dp-out",
                 os.path.join(tmp, f"worker{r}.json"), *args],
                env=env, cwd=here, stdout=log, stderr=subprocess.STDOUT),
                log))
        deadline = time.monotonic() + timeout
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
            log.close()
    wall_s = time.perf_counter() - t0
    failed = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = {}
        for r in failed:
            with open(os.path.join(tmp, f"worker{r}.log")) as f:
                tails[r] = f.read()[-3000:]
        raise AssertionError(f"{flag} workers {failed} failed "
                             f"(rc {[p.returncode for p, _ in procs]}): "
                             f"{tails}")
    res = []
    for r in range(DP_WORLD):
        with open(os.path.join(tmp, f"worker{r}.json")) as f:
            res.append(json.load(f))
    return res, wall_s


def dp_train_phase(torch, seed: int) -> dict:
    """Phase 13a (b): one worker's reference run of phase 11's batch, then
    two workers through the launcher (module docstring)."""
    import os
    import tempfile

    import numpy as np

    from byteps_tpu_torch import api
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)
    from byteps_tpu_torch.training import Trainer, lm_loss_fn

    cfg = TransformerConfig(**LLAMA_3_2_1B, max_seq_len=MAX_SEQ,
                            dtype=torch.bfloat16, attn_impl="flash")
    model = Transformer(cfg, device="cuda")
    init_weights(model, seed)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4, fused=True)
    trainer = Trainer(lm_loss_fn(model, fused_head=True), opt, log_every=0)
    toks = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(TRAIN_B, MAX_SEQ))
    batch = {"tokens": torch.from_numpy(toks).cuda()}
    leaves = dict(model.named_parameters())
    ref, ref_ms = [], []
    for i in range(DP_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.fit(model, {}, [batch])
        ref.append(trainer.metrics["loss"].item())
        ref_ms.append((time.perf_counter() - t1) * 1e3)
        if i == 0:
            ref_grads = {n: leaves[n].grad[:DP_GRAD_ROWS].cpu()
                         for n in DP_GRAD_LEAVES}
    api.shutdown()
    del model, opt, trainer, batch, leaves
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="dp-")
    res, wall_s = _launch_workers("--dp-worker", seed, tmp)
    losses = [[s["loss"] for s in w["steps"]] for w in res]
    if any(ls != losses[0] for ls in losses):
        raise AssertionError(f"averaged losses differ across ranks: "
                             f"{losses}")
    if len({w["params_sha256"] for w in res}) != 1:
        raise AssertionError("the ranks' parameters differ after the "
                             "last step")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[0], ref)]
    if not all(np.isfinite(losses[0])) or max(rel) > DP_LOSS_TOL:
        raise AssertionError(f"two-worker losses {losses[0]} vs one "
                             f"worker's {ref}: rel {rel} > {DP_LOSS_TOL}")
    grads = [torch.load(os.path.join(tmp, f"worker{r}.json.grads.pt"))
             for r in range(DP_WORLD)]
    grad_check = _dp_grad_check(torch, ref_grads, grads)
    want_held = sorted([
        ("flash_attention", [TRAIN_B // DP_WORLD, MAX_SEQ, cfg.num_heads,
                             cfg.d_head], ["dk", "dq", "dv"]),
        ("fused_linear_cross_entropy",
         [TRAIN_B // DP_WORLD * MAX_SEQ, cfg.d_model], ["dw", "dx"])])
    for w in res:
        got = sorted((h["kernel"], h["shapes"][0], h.get("backward_held"))
                     for h in w["held"])
        if got != want_held:
            raise AssertionError(f"rank {w['rank']} held calls {got}, want "
                                 f"{want_held}")
    launches = tuple(res[0]["steps"][0]["launches"])
    info = {"phase": "dp_train", "world": DP_WORLD, "backend": "gloo",
            "model": "Llama-3.2-1B (random weights, rank 0's broadcast)",
            "reduced": {"max_seq": [131072, MAX_SEQ]},
            "batch_per_worker": [TRAIN_B // DP_WORLD, MAX_SEQ],
            "steps": DP_STEPS, "losses": losses[0],
            "one_worker_losses": ref, "one_worker_step_ms": ref_ms,
            "loss_max_rel_diff": max(rel), "loss_tolerance": DP_LOSS_TOL,
            "params_sha256_equal": True, "wall_s": wall_s,
            "first_step_gradient": grad_check,
            "host_staging": "none (the port has no staging path)",
            "launches_per_worker_step": launches,
            "workers": [{
                "rank": w["rank"],
                "step_ms": [s["ms"] for s in w["steps"]],
                "step_ms_p50": float(np.median([s["ms"]
                                                for s in w["steps"]])),
                "push_pull_busy_ms": [s["push_pull_busy_ms"]
                                      for s in w["steps"]],
                "push_pull_spans": [s["push_pull_spans"]
                                    for s in w["steps"]],
                "push_pull_span_ms_p50": [s["push_pull_span_ms_p50"]
                                          for s in w["steps"]],
                "dispatch_to_done_ms_p50": [s["dispatch_to_done_ms_p50"]
                                            for s in w["steps"]],
                "gather_ms": [s["gather_ms"] for s in w["steps"]],
                "bare_all_reduce_bytes": w["bare_all_reduce_bytes"],
                "bare_all_reduce_ms_p50": w["bare_all_reduce_ms_p50"],
                "collectives_per_step": [s["collectives"]
                                         for s in w["steps"]],
                "buckets": w["buckets"], "bucket_bytes": w["bucket_bytes"],
                "agreement_cycles": w["agreement_cycles"],
                "broadcast_s": w["broadcast_s"],
                "peak_memory_gb": w["peak_memory_gb"],
                "launches": [s["launches"] for s in w["steps"]],
                "predicted_launches": w["predicted_launches"],
                "held": w["held"]}
                for w in res]}
    return info


def _dp_grad_check(torch, ref: dict, grads: list) -> dict:
    """Phase 13a (b)'s first-step gradients: each rank's averaged
    gradient at each leaf against the one-worker run's ``ref``, as the
    largest difference over the leaf's largest |g|, within
    ``DP_GRAD_TOL``; the same measure for two wrong reductions of this
    run's own readings (the sum left unaveraged, each rank's own gradient
    alone), each of which must miss the limit, or the check could not
    tell them from a right one."""
    def err(g, r):
        return ((g.float() - r.float()).abs().max()
                / r.float().abs().max()).item()

    out = {"leaves": list(DP_GRAD_LEAVES), "rows": DP_GRAD_ROWS,
           "tolerance": DP_GRAD_TOL}
    for n, r in ref.items():
        avg = [g["avg"][n] for g in grads]
        if any(not torch.equal(a, avg[0]) for a in avg):
            raise AssertionError(f"{n}: the ranks' averaged gradients "
                                 f"differ")
        line = {"averaged": err(avg[0], r),
                "control_sum_unaveraged": err(avg[0] * len(grads), r),
                "control_own_gradient": [err(g["local"][n], r)
                                         for g in grads]}
        out[n] = line
        if not line["averaged"] <= DP_GRAD_TOL:
            raise AssertionError(f"{n}: averaged gradient {line} off the "
                                 f"one-worker run's by > {DP_GRAD_TOL}")
        if min([line["control_sum_unaveraged"]]
               + line["control_own_gradient"]) <= DP_GRAD_TOL:
            raise AssertionError(f"{n}: a wrong reduction falls within "
                                 f"{DP_GRAD_TOL}: {line}")
    return out


# ------------------------------------------------ the rest of training

EF_STEPS = 4           # 13h (a): onebit steps at world 1
EF_SAVE_AT = 2         # 13h (b): checkpoint_every; resumed after it
EF_WORLD2_STEPS = 2    # 13h (c): the onebit trainer's steps a worker
OVL_STEPS = 3          # 13h (c): the overlap trainer's steps, then a flush
OVL_LOSS_TOL = 1e-3    # world-2 overlap losses vs one worker's, relative


def _fused_model(torch, seed: int):
    """Phase 11's model (fp32 weights from ``seed``, bf16 compute, flash)
    and AdamW, not yet in a Trainer."""
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)

    cfg = TransformerConfig(**LLAMA_3_2_1B, max_seq_len=MAX_SEQ,
                            dtype=torch.bfloat16, attn_impl="flash")
    model = Transformer(cfg, device="cuda")
    init_weights(model, seed)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4, fused=True)
    return cfg, model, opt


def _train_batch(torch, seed: int, rows=slice(None)) -> dict:
    """Phase 11's 4 x 2048 batch (``rows`` of it)."""
    import numpy as np

    toks = np.random.RandomState(seed).randint(
        0, LLAMA_3_2_1B["vocab_size"], size=(TRAIN_B, MAX_SEQ))
    return {"tokens": torch.from_numpy(toks[rows]).cuda()}


def _params_sha(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for _, p in model.named_parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _want_launches(fce) -> tuple:
    nc = fce.vocab_chunks(LLAMA_3_2_1B["vocab_size"])
    return (LLAMA_3_2_1B["num_layers"],) * 3 + (1, nc, nc), 1 + 3 * nc


def _step_launches(torch, fit, what: str) -> tuple:
    """``fit()`` one step with the counts at 0; the launches it made,
    which must be phase 11's, on TMA, with no plain call."""
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import fused_cross_entropy as fce

    want, tma = _want_launches(fce)
    _zero_counts()
    fit()
    got = _flash_counts() + _fce_counts()
    if got != want or fce.tma_launches != tma or fa.plain_calls \
            or fce.plain_calls:
        raise AssertionError(
            f"{what}: launches {got} (want {want}), {fce.tma_launches} TMA "
            f"(want {tma}), plain calls {fa.plain_calls}/{fce.plain_calls}")
    return got


def _onebit_leaf(torch, g, deq, e_new) -> dict:
    """Error feedback's first step at a leaf (zero residual before), held
    to a float64 recomputation on the host: the dequantized value is
    ±scale by the sign of g, the scale the float64 mean of |g| rounded
    once (within 1 ulp), and the residual g - deq exactly."""
    import numpy as np

    g, deq, e_new = g.float().cpu(), deq.float().cpu(), e_new.float().cpu()
    exact = g.double().abs().mean().item()
    scale = deq.abs().max().item()
    ulps = abs(scale - float(np.float32(exact))) / float(
        np.spacing(np.float32(exact)))
    s = torch.tensor(scale)
    line = {"numel": g.numel(), "scale": scale, "scale_float64": exact,
            "scale_ulps": ulps,
            "signs_equal": torch.equal(deq, torch.where(g >= 0, s, -s)),
            "residual_equal": torch.equal(e_new, g - deq),
            "residual_max_abs": e_new.abs().max().item()}
    if not (ulps <= 1 and line["signs_equal"] and line["residual_equal"]
            and line["residual_max_abs"] > 0):
        raise AssertionError(f"onebit error feedback at step 1: {line}")
    return line


def _tree_bytes(torch, tree) -> int:
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tree_bytes(torch, v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(torch, v) for v in tree)
    return 0


def ef_phase(torch, seed: int, phase11_ms: float) -> tuple:
    """Phase 13h (a) onebit at one worker and (b) checkpoint and resume
    (module docstring).  Returns the line and (a)'s launches."""
    import gc
    import os
    import shutil
    import tempfile

    import numpy as np

    from byteps_tpu_torch import api
    from byteps_tpu_torch.training import Trainer, lm_loss_fn

    batch = _train_batch(torch, seed)
    root = tempfile.mkdtemp(prefix="ckpt-")
    saves = []

    def run(seed_, n, what, zero_residual=False, watch=False, **kw):
        """A fused-head onebit Trainer from ``seed_`` (resuming when
        ``kw`` names a checkpoint directory holding one), ``n`` steps;
        everything it held is freed on return."""
        cfg, model, opt = _fused_model(torch, seed_)
        leaves = dict(model.named_parameters())
        raw = {}
        for name in DP_GRAD_LEAVES if watch else ():
            def hook(p, name=name):
                if name not in raw:   # step 1's gradient, before feedback
                    raw[name] = p.grad.detach().to("cpu", copy=True)
            leaves[name].register_post_accumulate_grad_hook(hook)
        trainer = Trainer(lm_loss_fn(model, fused_head=True), opt,
                          compression="onebit", log_every=0, **kw)
        if trainer.ckpt is not None:
            real = trainer.ckpt.maybe_save

            def save(state, step):
                need = _tree_bytes(torch, state.state_dict())
                free_b = shutil.disk_usage(root).free
                if step % trainer.ckpt.save_every == 0 and free_b < need:
                    raise AssertionError(
                        f"13h (b): {free_b} bytes free under {root}, the "
                        f"checkpoint needs {need}")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                path = real(state, step)
                if path is not None:
                    saves.append({
                        "step": step, "s": time.perf_counter() - t0,
                        "bytes": os.path.getsize(os.path.join(
                            path, "checkpoint.pt")),
                        "state_bytes": need, "free_bytes_before": free_b})
                return path
            trainer.ckpt.maybe_save = save
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.state = trainer.init_state(model)
        torch.cuda.synchronize()
        out = {"init_s": time.perf_counter() - t0,
               "start_step": trainer.state.step, "losses": [], "ms": [],
               "launches": []}
        if zero_residual:
            for e in trainer.state.optimizer.ef_state.error:
                e.zero_()
        torch.cuda.reset_peak_memory_stats()
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out["launches"].append(_step_launches(
                torch, lambda: trainer.fit(model, {}, [batch]),
                f"{what} step {i + 1}"))
            out["losses"].append(trainer.metrics["loss"].item())
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            if watch and i == 0:
                ef = trainer.state.optimizer.ef_state
                index = {k: j for j, k in enumerate(leaves)}
                out["step1_leaves"] = {
                    k: _onebit_leaf(torch, raw[k], leaves[k].grad,
                                    ef.error[index[k]])
                    for k in DP_GRAD_LEAVES}
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["sha256"] = _params_sha(model)
        api.shutdown()
        return out

    def done():
        gc.collect()
        torch.cuda.empty_cache()

    try:
        a = run(seed, EF_STEPS, "13h (a)", watch=True)        # (a)
        done()
        first = run(seed, EF_SAVE_AT, "13h (b)", checkpoint_dir=root,
                    checkpoint_every=EF_SAVE_AT, checkpoint_keep=1)
        done()
        control = run(seed + 1, EF_STEPS - EF_SAVE_AT, "13h (b) control",
                      zero_residual=True, checkpoint_dir=root,
                      checkpoint_every=10 ** 9)
        done()
        resumed = run(seed + 1, EF_STEPS - EF_SAVE_AT, "13h (b) resumed",
                      checkpoint_dir=root, checkpoint_every=10 ** 9)
        done()
        listing = sorted(os.listdir(root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    losses = a["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"13h (a) losses {losses}: not finite and "
                             f"falling")
    total = tuple(int(x) for x in np.sum(a["launches"], axis=0))
    identical = (first["losses"] + resumed["losses"] == losses
                 and resumed["sha256"] == a["sha256"])
    control_differs = (control["sha256"] != a["sha256"]
                       and control["losses"] != losses[EF_SAVE_AT:])
    ck = {"dir": root, "saves": saves, "restore_s": resumed["init_s"],
          "resumed_at": [control["start_step"], resumed["start_step"]],
          "listing_after": listing, "losses_first": first["losses"],
          "losses_resumed": resumed["losses"],
          "losses_control": control["losses"],
          "resumed_bit_identical": identical,
          "control_residual_zeroed_differs": control_differs,
          "peak_memory_gb_resumed": resumed["peak_memory_gb"]}
    if (not identical or not control_differs
            or ck["resumed_at"] != [EF_SAVE_AT] * 2
            or listing != [f"step_{EF_SAVE_AT:010d}"]):
        raise AssertionError(f"13h (b): {ck}")
    info = {"phase": "training_rest", "model": "Llama-3.2-1B "
            "(random weights)", "reduced": {"max_seq": [131072, MAX_SEQ]},
            "batch": [TRAIN_B, MAX_SEQ], "compression": "onebit",
            "onebit": {"losses": losses, "step_ms": a["ms"],
                       "step_ms_p50": float(np.median(a["ms"][1:])),
                       "phase11_step_ms_p50": phase11_ms,
                       "peak_memory_gb": a["peak_memory_gb"],
                       "launches": total,
                       "step1_leaves": a["step1_leaves"]},
            "checkpoint": ck}
    return info, total


def _intervals(spans) -> list:
    """The union of ``(start, end)`` spans as sorted disjoint intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _inside_ms(spans, within) -> float:
    """Milliseconds of the union of ``spans`` that fall inside the union
    of ``within``."""
    total = 0.0
    for a, b in _intervals(spans):
        for c, d in _intervals(within):
            total += max(0.0, min(b, d) - max(a, c))
    return total / 1e3


def ef_worker(torch, seed: int, out: str) -> int:
    """One worker of phase 13h (c), run by the port's launcher: the
    fused-head Llama-3.2-1B step on this rank's rows at world 2, gloo on
    the shared card, with onebit compression for EF_WORLD2_STEPS steps,
    then with the delayed-gradient overlap for OVL_STEPS steps and a
    flush."""
    import gc
    import os

    from byteps_tpu_torch import api
    from byteps_tpu_torch.common.tracing import get_tracer
    from byteps_tpu_torch.training import Trainer, lm_loss_fn

    api.init(device="cuda", backend="gloo")
    rank, world = api.rank(), api.size()
    per = TRAIN_B // world
    batch = _train_batch(torch, seed, slice(rank * per, (rank + 1) * per))
    tracer = get_tracer()
    res = {"rank": rank, "world": world, "backend": "gloo"}
    rec, raw = {}, {}

    def onebit():
        cfg, model, opt = _fused_model(torch, seed + rank)
        leaves = dict(model.named_parameters())
        names = list(leaves)
        for n in DP_GRAD_LEAVES:
            # registered before the DistributedOptimizer's hooks: this
            # rank's own gradient, before error feedback rounds it
            def hook(p, n=n):
                if n not in raw:
                    raw[n] = p.grad[:DP_GRAD_ROWS].detach().to(
                        "cpu", copy=True)
            leaves[n].register_post_accumulate_grad_hook(hook)
        trainer = Trainer(lm_loss_fn(model, fused_head=True), opt,
                          compression="onebit", log_every=0)
        ef = trainer.step_fn.optimizer.error_feedback
        leaf = ef.leaf

        def recording(i, g, e, count):
            deq, e_new = leaf(i, g, e, count)
            if count == 0 and names[i] in DP_GRAD_LEAVES:
                rec[names[i]] = (deq[:DP_GRAD_ROWS].detach().cpu(),
                                 e_new[:DP_GRAD_ROWS].detach().cpu())
            return deq, e_new
        ef.leaf = recording
        trainer.state = trainer.init_state(model)     # rank 0's weights
        torch.cuda.reset_peak_memory_stats()
        steps, avg = [], {}
        for i in range(EF_WORLD2_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            launches = _step_launches(
                torch, lambda: trainer.fit(model, {}, [batch]),
                f"13h (c) rank {rank} onebit step {i + 1}")
            steps.append({"loss": trainer.metrics["loss"].item(),
                          "ms": (time.perf_counter() - t0) * 1e3,
                          "launches": launches})
            if i == 0:   # the averaged gradient handed to AdamW
                avg = {n: leaves[n].grad[:DP_GRAD_ROWS].cpu()
                       for n in DP_GRAD_LEAVES}
        return {"steps": steps, "sha256": _params_sha(model),
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}, \
            avg

    def overlap():
        cfg, model, opt = _fused_model(torch, seed + rank)
        trainer = Trainer(lm_loss_fn(model, fused_head=True), opt,
                          overlap=True, log_every=0)
        trainer.state = trainer.init_state(model)     # rank 0's weights
        steps = []
        mark = [time.perf_counter(), _flash_counts() + _fce_counts()]

        def record(state):
            now = _flash_counts() + _fce_counts()
            steps.append({"loss": trainer.metrics["loss"].item(),
                          "ms": (time.perf_counter() - mark[0]) * 1e3,
                          "launches": [a - b for a, b in zip(now, mark[1])]})
            mark[:] = [time.perf_counter(), now]
        trainer.callbacks.append(record)
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        mark[1] = _flash_counts() + _fce_counts()
        tracer.instant("overlap_start", "ef")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(model, {}, [batch] * OVL_STEPS)      # flushes at the end
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tracer.instant("overlap_end", "ef")
        from byteps_tpu_torch.ops import fused_cross_entropy as fce

        want, _ = _want_launches(fce)
        if any(tuple(s["launches"]) != want for s in steps):
            raise AssertionError(f"13h (c) rank {rank} overlap launches "
                                 f"{[s['launches'] for s in steps]}, want "
                                 f"{want} a step")
        return {"steps": steps, "wall_s": wall, "step": trainer.state.step,
                "sha256": _params_sha(model),
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}

    with _PathCalls() as path:     # the loss binds the fused CE here
        res["onebit"], avg = onebit()
    gc.collect()
    torch.cuda.empty_cache()       # the first trainer's state is freed
    res["allocated_gb_between_trainers"] = \
        torch.cuda.memory_allocated() / 1e9
    torch.save({"raw": raw, "deq": {n: d for n, (d, _) in rec.items()},
                "residual": {n: e for n, (_, e) in rec.items()},
                "avg": avg}, out + ".ef.pt")
    res["overlap"] = overlap()
    gc.collect()
    torch.cuda.empty_cache()
    res["held"] = path.hold(torch)
    api.shutdown()                 # flushes the trace
    with open(os.environ["BYTEPS_TRACE_PATH"]) as f:
        events = json.load(f)["traceEvents"]
    marks = {e["name"]: e["ts"] for e in events if e.get("cat") == "ef"}
    a, b = marks["overlap_start"], marks["overlap_end"]
    spans = [e for e in events if e.get("ph") == "X" and a <= e["ts"] <= b]
    pp = [(e["ts"], e["ts"] + e["dur"]) for e in spans
          if e["cat"] == "push_pull"]
    fb = [(e["ts"], e["ts"] + e["dur"]) for e in spans
          if e["cat"] == "overlap"]
    busy = _union_ms(pp)
    res["overlap"].update({
        "push_pull_busy_ms": busy, "forward_backward_ms": _union_ms(fb),
        "push_pull_inside_forward_backward_ms": _inside_ms(pp, fb),
        "push_pull_share_inside_forward_backward":
            _inside_ms(pp, fb) / busy if busy else None,
        "push_pull_spans": len(pp), "forward_backward_spans": len(fb)})
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def ef_world2_phase(torch, seed: int) -> dict:
    """Phase 13h (c): a one-worker delayed-gradient run of phase 11's
    batch, then two workers through the launcher (module docstring)."""
    import gc
    import tempfile

    import numpy as np

    from byteps_tpu_torch import api
    from byteps_tpu_torch.training import Trainer, lm_loss_fn

    def one_worker():
        cfg, model, opt = _fused_model(torch, seed)
        trainer = Trainer(lm_loss_fn(model, fused_head=True), opt,
                          overlap=True, log_every=0)
        losses = []
        trainer.callbacks.append(
            lambda st: losses.append(trainer.metrics["loss"].item()))
        trainer.fit(model, {}, [_train_batch(torch, seed)] * OVL_STEPS)
        api.shutdown()
        return losses

    ref = one_worker()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="ef-")
    res, wall_s = _launch_workers("--ef-worker", seed, tmp)
    info = {"phase": "training_rest_world2", "world": DP_WORLD,
            "backend": "gloo", "batch_per_worker": [TRAIN_B // DP_WORLD,
                                                    MAX_SEQ],
            "wall_s": wall_s, "allocated_gb_between_trainers": [
                w["allocated_gb_between_trainers"] for w in res]}
    for kind in ("onebit", "overlap"):
        losses = [[s["loss"] for s in w[kind]["steps"]] for w in res]
        if any(ls != losses[0] for ls in losses) or \
                len({w[kind]["sha256"] for w in res}) != 1:
            raise AssertionError(f"13h (c) {kind}: the ranks differ: "
                                 f"{losses}")
        info[kind] = {"losses": losses[0], "params_sha256_equal": True,
                      "workers": [w[kind] for w in res]}
    rel = [abs(a - b) / abs(b) for a, b in zip(info["overlap"]["losses"],
                                               ref)]
    info["overlap"].update({"one_worker_losses": ref,
                            "loss_max_rel_diff": max(rel),
                            "loss_tolerance": OVL_LOSS_TOL})
    if not all(np.isfinite(ref)) or max(rel) > OVL_LOSS_TOL:
        raise AssertionError(f"13h (c) overlap losses "
                             f"{info['overlap']['losses']} vs one worker's "
                             f"{ref}: rel {rel}")
    # step 1's average: exactly (deq_0 + deq_1) / 2 of the recorded
    # payloads (a sum of two fp32 values, halved); the unaveraged sum and
    # one rank's payload alone must miss; each residual g + 0 - deq
    ef = [torch.load(f"{tmp}/worker{r}.json.ef.pt") for r in range(DP_WORLD)]
    check = {}
    for n in DP_GRAD_LEAVES:
        deq = [e["deq"][n] for e in ef]
        avg = [e["avg"][n] for e in ef]
        want = (deq[0] + deq[1]) / 2
        line = {"average_equal": all(torch.equal(a, want) for a in avg),
                "control_sum_unaveraged_equal": torch.equal(
                    avg[0], deq[0] + deq[1]),
                "control_one_payload_equal": [torch.equal(avg[0], d)
                                              for d in deq],
                "residuals_equal": [torch.equal(e["residual"][n],
                                                e["raw"][n] - e["deq"][n])
                                    for e in ef],
                "scales": [e["deq"][n].abs().max().item() for e in ef]}
        check[n] = line
        if not (line["average_equal"] and all(line["residuals_equal"])) \
                or line["control_sum_unaveraged_equal"] \
                or any(line["control_one_payload_equal"]):
            raise AssertionError(f"13h (c) {n}: {line}")
    info["onebit"]["step1_average"] = {"rows": DP_GRAD_ROWS, **check}
    cfg_h = LLAMA_3_2_1B["num_heads"]
    want_held = sorted([
        ("flash_attention", [TRAIN_B // DP_WORLD, MAX_SEQ, cfg_h,
                             LLAMA_3_2_1B["head_dim"]], ["dk", "dq", "dv"]),
        ("fused_linear_cross_entropy",
         [TRAIN_B // DP_WORLD * MAX_SEQ, LLAMA_3_2_1B["d_model"]],
         ["dw", "dx"])])
    for w in res:
        got = sorted((h["kernel"], h["shapes"][0], h.get("backward_held"))
                     for h in w["held"])
        if got != want_held:
            raise AssertionError(f"13h (c) rank {w['rank']} held calls "
                                 f"{got}, want {want_held}")
    info["held"] = [h for w in res for h in w["held"]]
    info["launches_per_worker"] = {
        kind: [int(x) for x in np.sum([s["launches"] for s in
                                        res[0][kind]["steps"]], axis=0)]
        for kind in ("onebit", "overlap")}
    return info


def serve_checkpoint_phase(torch, seed: int) -> dict:
    """Phase 13h (d): the serve role with ``BYTEPS_SERVE_CHECKPOINT`` on
    a port checkpoint of its model saved from another seed."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from byteps_tpu_torch.inference import generate
    from byteps_tpu_torch.serving.frontend import _model_from_env
    from byteps_tpu_torch.training import save_checkpoint

    root = tempfile.mkdtemp(prefix="serve-ckpt-")
    try:
        model = _model_from_env("", torch.device("cuda"), seed=seed + 1)
        path = save_checkpoint(os.path.join(root, "weights"), model)
        info = serve_role_phase(torch, {"BYTEPS_SERVE_CHECKPOINT": path})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    prompt = torch.tensor([SERVE_ROLE_PROMPT], dtype=torch.int32,
                          device="cuda")
    want = generate(model, prompt, SERVE_ROLE_NEW, temperature=0,
                    cache_layout="grouped")["tokens"][0].tolist()
    default = generate(_model_from_env("", torch.device("cuda")), prompt,
                       SERVE_ROLE_NEW, temperature=0,
                       cache_layout="grouped")["tokens"][0].tolist()
    info.update({"phase": "serve_role_checkpoint",
                 "generate_on_saved_weights": want,
                 "default_weights_tokens": default})
    if info["tokens"] != want or want == default:
        raise AssertionError(f"13h (d): served {info['tokens']}, generate "
                             f"on the saved weights {want}, on the role's "
                             f"default weights {default}")
    del model
    torch.cuda.empty_cache()
    return info


# ------------------------------------------------------------ generation


ASYNC_LEAVES = ("blocks.3.ln1.scale", "blocks.5.attn.q.weight",
                "blocks.8.mlp.down.weight")   # a norm, one wq, one MLP matrix
ASYNC_RUNS = (("fp32", 3, {}), ("bf16", 2, {"BYTEPS_COMPRESSION": "bf16"}))
ASYNC_SHARDS = 2
ASYNC_TIMEOUT_S = 900.0   # both workers: start, INIT, the steps, the drain
ASYNC_BF16_BYTES = 0.51   # bf16 wire bytes a push, of the fp32 run's


def _interval_ms(spans) -> float:
    return sum(b - a for a, b in _intervals(spans)) / 1e3


def async_worker(torch, seed: int, out: str, steps_n: int) -> int:
    """One worker of phase 13i, run by the port's launcher under
    ``BYTEPS_ENABLE_ASYNC=1``: phase 11's fused-head Llama-3.2-1B and
    AdamW in ``Trainer(async_mode=True, async_interval=1)`` over the two
    shards of ``BYTEPS_SERVER_ADDRS``, ``steps_n`` steps on this rank's
    2 x 2048 rows and the drain."""
    import os
    import resource

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from byteps_tpu_torch import api
    from byteps_tpu_torch.common.config import get_config
    from byteps_tpu_torch.compression import get_compression_stats
    from byteps_tpu_torch.engine import ps_server
    from byteps_tpu_torch.engine.async_ps import get_async_store
    from byteps_tpu_torch.training import Trainer, lm_loss_fn

    rank = get_config().worker_id
    api.init(device="cuda")
    assert api.size() == 1, "async workers share no process group"
    cfg, model, opt = _fused_model(torch, seed)    # both ranks: one init
    names = [n for n, _ in model.named_parameters()]
    watch = {f"param_{names.index(n)}": n for n in ASYNC_LEAVES}
    init = {n: dict(model.named_parameters())[n].detach().cpu().numpy()
            .copy() for n in ASYNC_LEAVES}
    per = TRAIN_B // DP_WORLD
    batch = _train_batch(torch, seed, slice(rank * per, (rank + 1) * per))
    store = get_async_store()
    deltas = {n: [] for n in watch}
    versions: dict = {}
    push_pull, note = store.push_pull, store._note_success

    def recording_push_pull(name, delta, priority=None):
        if name in watch:
            deltas[name].append(np.array(delta, copy=True))
        return push_pull(name, delta, priority)

    def recording_note(op, name, rname, out_, arr=None, shard=0):
        if op == ps_server.OP_PUSH_PULL and name.split("#p")[0] in watch:
            versions.setdefault(name, []).append(int(rname))
        return note(op, name, rname, out_, arr, shard=shard)

    store.push_pull, store._note_success = recording_push_pull, recording_note
    steps, prof = [], {}
    with _PathCalls() as path:     # the loss binds the fused CE here
        trainer = Trainer(lm_loss_fn(model, fused_head=True), opt,
                          async_mode=True, async_interval=1, log_every=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.state = trainer.init_state(model)   # INIT of every leaf
        init_s = time.perf_counter() - t0
        aw, inner = trainer._async_worker, trainer.step_fn

        class Timed:
            """The step, timed; the last one (an exchange in flight)
            under the profiler for the device's idle share."""

            def __getattr__(self, k):
                return getattr(inner, k)

            def __call__(self, state, b):
                inflight = aw.exchange_in_flight()
                res = []
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                profiled = len(steps) == steps_n - 1
                if profiled:
                    with profile(activities=[ProfilerActivity.CUDA]) as p:
                        res.append(inner(state, b))
                        torch.cuda.synchronize()
                    wall = (time.perf_counter() - t1) * 1e3
                    ev = [(e.time_range.start, e.time_range.end)
                          for e in p.events()
                          if e.device_type == DeviceType.CUDA]
                    busy = _interval_ms(ev) if ev else None
                    prof.update({
                        "kernels_and_copies": len(ev), "wall_ms": wall,
                        "device_busy_ms": busy,
                        "device_idle_share": (1.0 - busy / wall
                                              if busy else None)})
                else:
                    res.append(inner(state, b))
                loss = res[0][1]["loss"].item()          # synchronizes
                steps.append({"loss": loss, "exchange_in_flight": inflight,
                              "profiled": profiled,
                              "ms": (time.perf_counter() - t1) * 1e3})
                return res[0]

        trainer.step_fn = Timed()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        trainer.fit(model, {}, [batch] * steps_n)   # drains at the end
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _flash_counts() + _fce_counts()
    from byteps_tpu_torch.ops import fused_cross_entropy as fce

    want, _ = _want_launches(fce)
    want = tuple(steps_n * w for w in want)
    if launches != want:
        raise AssertionError(f"13i rank {rank}: launches {launches}, want "
                             f"{want}")
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout
    res = {"rank": rank, "pid": os.getpid(), "steps": steps,
           "profiled_step": prof, "init_s": init_s, "fit_s": fit_s,
           "exchange_s": list(aw.exchange_seconds),
           "exchanges": len(aw.exchange_seconds),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters()),
           "wire": get_compression_stats().summary(),
           "launches": launches, "predicted_launches": want,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "compute_apps": smi.split()}
    trainer.close()
    del trainer, opt
    torch.cuda.empty_cache()
    res["held"] = path.hold(torch)
    res["peak_rss_gb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1e6
    np.savez(out + ".deltas.npz",
             **{f"init/{watch_n}": init[n] for watch_n, n in watch.items()},
             **{f"delta/{k}/{i}": d for k, ds in deltas.items()
                for i, d in enumerate(ds)})
    res["versions"] = versions
    res["watch"] = watch
    store.close()
    api.shutdown()
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def _sum_of_deltas(torch, np, res, tmp, pulled, bf16: bool) -> dict:
    """Each watched leaf, partition by partition: the initial value plus
    every delta both workers pushed, replayed in the order of the
    versions the shard's replies carried, equals the pulled value bit
    for bit (bf16-rounded deltas under a bf16 wire); the same fold
    without worker 1's deltas must miss."""
    import os

    from byteps_tpu_torch.common.config import get_config
    from byteps_tpu_torch.common.partition import partition_offsets

    cfg = get_config()
    files = [np.load(os.path.join(tmp, f"worker{r}.json.deltas.npz"))
             for r in range(DP_WORLD)]
    out = {}
    for pname, leaf in res[0]["watch"].items():
        init = [f[f"init/{pname}"] for f in files]
        if not all(np.array_equal(init[0], x) for x in init):
            raise AssertionError(f"13i {leaf}: the workers' initial "
                                 f"values differ")
        x0 = init[0].reshape(-1)
        got = pulled[leaf].reshape(-1)
        parts = partition_offsets(x0.nbytes, cfg.effective_partition_bytes)
        n_ok = misses = 0
        for i, (off, length) in enumerate(parts):
            key = pname if len(parts) == 1 else f"{pname}#p{i}"
            lo, hi = off // 4, (off + length) // 4
            entries = []
            for r, f in enumerate(files):
                vs = res[r]["versions"][key]
                for e, v in enumerate(vs):
                    d = f[f"delta/{pname}/{e}"].reshape(-1)[lo:hi]
                    if bf16 and d.nbytes >= cfg.compression_min_bytes:
                        d = torch.from_numpy(d.copy()).to(
                            torch.bfloat16).float().numpy()
                    entries.append((v, r, d))
            entries.sort(key=lambda t: t[0])
            if [v for v, _, _ in entries] != list(range(1,
                                                       len(entries) + 1)):
                raise AssertionError(f"13i {key}: versions "
                                     f"{[v for v, _, _ in entries]}")
            want, control = x0[lo:hi].copy(), x0[lo:hi].copy()
            for _, r, d in entries:
                want = want + d
                if r != 1:
                    control = control + d
            if want.tobytes() != got[lo:hi].tobytes():
                raise AssertionError(f"13i {key}: the pulled value is not "
                                     f"the initial one plus the replayed "
                                     f"deltas")
            n_ok += 1
            misses += control.tobytes() != got[lo:hi].tobytes()
        if misses == 0:
            raise AssertionError(f"13i {leaf}: the control without worker "
                                 f"1's deltas did not miss")
        out[leaf] = {"partitions": len(parts), "pushes_per_partition":
                     len(entries), "bit_equal": n_ok,
                     "control_misses": misses}
    return out


def async_ps_phase(torch, seed: int, phase11_ms) -> dict:
    """Phase 13i (module docstring): two shards and two async workers
    through the port's launcher, an fp32 wire run, then a bf16 one."""
    import os
    import tempfile

    import numpy as np

    from byteps_tpu_torch.engine.ps_server import RemoteStore
    from byteps_tpu_torch.engine.transport import free_port

    info = {"phase": "async_ps", "model": "Llama-3.2-1B (random weights)",
            "reduced": {"max_seq": [131072, MAX_SEQ]}, "workers": DP_WORLD,
            "shards": ASYNC_SHARDS,
            "batch_per_worker": [TRAIN_B // DP_WORLD, MAX_SEQ],
            "phase11_step_ms_p50": phase11_ms, "leaves": ASYNC_LEAVES}
    for run, steps_n, env in ASYNC_RUNS:
        tmp = tempfile.mkdtemp(prefix=f"async-{run}-")
        ports = [free_port() for _ in range(ASYNC_SHARDS)]
        addrs = [f"127.0.0.1:{p}" for p in ports]
        with _children() as spawn:
            shards = [spawn(f"ps-shard{i}", {
                "DMLC_ROLE": "server", "BYTEPS_ENABLE_ASYNC": "1",
                "DMLC_SERVER_ID": str(i), "BYTEPS_SERVER_PORT": str(p),
                "BYTEPS_LOG_LEVEL": "INFO", **env})
                for i, p in enumerate(ports)]
            client = RemoteStore(addrs)
            t0 = time.perf_counter()
            while not client.ping():
                spawn.check()
                if time.perf_counter() - t0 > PROC_START_S:
                    raise AssertionError("13i: the shards never answered")
                time.sleep(0.2)
            res, wall_s = _launch_workers(
                "--async-worker", seed, tmp,
                env_over={"BYTEPS_ENABLE_ASYNC": "1",
                          "BYTEPS_SERVER_ADDRS": ",".join(addrs), **env},
                args=("--async-steps", str(steps_n)),
                timeout=ASYNC_TIMEOUT_S)
            spawn.check()
            stats = [client.shard_stats(i) for i in range(ASYNC_SHARDS)]
            pulled = {leaf: client.pull(pname) for pname, leaf in
                      res[0]["watch"].items()}
            smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                                  "--format=csv,noheader"],
                                 capture_output=True, text=True,
                                 timeout=60).stdout
            shard_pids = [s.pid for s in shards]
            logs = []
            for s in shards:
                with open(s.log_path) as f:
                    logs.append(f.read())
            client.close()
        for r, w in enumerate(res):
            if not all(np.isfinite(s["loss"]) for s in w["steps"]):
                raise AssertionError(f"13i {run} rank {r}: losses "
                                     f"{[s['loss'] for s in w['steps']]}")
        if not all("reducer native" in lg for lg in logs):
            raise AssertionError(f"13i {run}: a shard does not sum with "
                                 f"the native reducer: {logs}")
        apps = set(smi.split()) | {a for w in res
                                   for a in w["compute_apps"]}
        if apps & {str(p) for p in shard_pids} or any(
                st["cuda_initialized"] for st in stats):
            raise AssertionError(f"13i {run}: a shard process holds a CUDA "
                                 f"context (pids {shard_pids}, compute "
                                 f"apps {sorted(apps)}, stats "
                                 f"{[st['cuda_initialized'] for st in stats]})")
        want_held = sorted([
            ("flash_attention", [TRAIN_B // DP_WORLD, MAX_SEQ,
                                 LLAMA_3_2_1B["num_heads"],
                                 LLAMA_3_2_1B["head_dim"]],
             ["dk", "dq", "dv"]),
            ("fused_linear_cross_entropy",
             [TRAIN_B // DP_WORLD * MAX_SEQ, LLAMA_3_2_1B["d_model"]],
             ["dw", "dx"])])
        for w in res:
            got = sorted((h["kernel"], h["shapes"][0],
                          h.get("backward_held")) for h in w["held"])
            if got != want_held:
                raise AssertionError(f"13i {run} rank {w['rank']} held "
                                     f"calls {got}, want {want_held}")
        contract = _sum_of_deltas(torch, np, res, tmp, pulled,
                                  bf16=run == "bf16")
        exch = [s for w in res for s in w["exchange_s"]]
        push_b = [w["wire"]["wire_bytes_sent"] / w["exchanges"]
                  for w in res]
        pull_b = res[0]["param_bytes"]
        p50 = float(np.median(exch))
        inflight = [s["ms"] for w in res for s in w["steps"]
                    if s["exchange_in_flight"] and not s["profiled"]]
        info[run] = {
            "steps": steps_n, "compression": env.get("BYTEPS_COMPRESSION",
                                                    "none"),
            "wall_s": wall_s,
            "losses": [[s["loss"] for s in w["steps"]] for w in res],
            "sum_of_deltas": contract,
            "exchange_s_p50": p50, "exchange_s": exch,
            "push_bytes_per_exchange": push_b,
            "pull_bytes_per_exchange": pull_b,
            "exchange_gb_per_s": (float(np.mean(push_b)) + pull_b)
            / p50 / 1e9,
            "init_s": [w["init_s"] for w in res],
            "server_sum_gb_per_s": [st["sum_bytes"] / st["sum_seconds"]
                                    / 1e9 for st in stats],
            "server_sum_bytes": [st["sum_bytes"] for st in stats],
            "server_omp_threads": [st.get("omp_threads") for st in stats],
            "server_reducer_built_with": [st.get("built_with")
                                          for st in stats],
            "step_ms": [[s["ms"] for s in w["steps"]] for w in res],
            "step_ms_exchange_in_flight_p50":
                float(np.median(inflight)) if inflight else None,
            "profiled_step": [w["profiled_step"] for w in res],
            # a shard's ru_maxrss carries this process's peak across the
            # launcher's fork and exec: its resident bytes after the run
            # (the store only grows) stand in for its peak
            "peak_rss_gb": {"workers": [w["peak_rss_gb"] for w in res]},
            "shard_rss_gb_after_run": [st["rss_bytes"] / 1e9
                                       for st in stats],
            "shard_cuda_initialized": [st["cuda_initialized"]
                                       for st in stats],
            "peak_device_memory_gb": [w["peak_memory_gb"] for w in res],
            "launches_per_worker": [list(w["launches"]) for w in res],
            "shard_pids": shard_pids, "compute_apps": sorted(apps),
            "held": [h for w in res for h in w["held"]]}
    ratio = (np.mean(info["bf16"]["push_bytes_per_exchange"])
             / np.mean(info["fp32"]["push_bytes_per_exchange"]))
    info["bf16_push_bytes_ratio"] = float(ratio)
    if ratio > ASYNC_BF16_BYTES:
        raise AssertionError(f"13i: the bf16 wire puts {ratio:.3f}x the "
                             f"fp32 run's bytes on the wire a push")
    return info


def _gen_counts() -> dict:
    from byteps_tpu_torch.ops import decode_attention as da
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import quant_dot as qd

    return {"flash_fwd": fa.fwd_launches, "decode": da.launches,
            "quant_dot": qd.launches,
            "quant_dot_by_design": dict(qd.design_launches),
            "plain": fa.plain_calls + da.plain_calls + qd.plain_calls}


def generate_reference_phase(torch, seed: int) -> dict:
    """fp32: flat (kernel) vs grouped (plain) caches, fp and int8; int8
    weights vs the same weights dequantized; seeded sampling repeats."""
    import copy

    import numpy as np

    from byteps_tpu_torch.inference import (classify_divergence, generate,
                                            quantize_params)
    from byteps_tpu_torch.models.transformer import (Dense, Transformer,
                                                     TransformerConfig,
                                                     init_cache, init_weights)

    cfg = TransformerConfig(**{**LLAMA_3_2_1B, **TRAIN_REF},
                            attn_impl="flash", dtype=torch.float32)
    model = Transformer(cfg, device="cuda")
    init_weights(model, seed)
    B, T, n, L = 2, 128, 32, cfg.num_layers
    prompt = np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                 size=(B, T))
    info = {"phase": "generate_reference", "prompt": [B, T],
            "new_tokens": n}

    def run(m, want, **kw):
        _zero_counts()
        out = generate(m, prompt, n, temperature=0, **kw)
        torch.cuda.synchronize()
        counts = _gen_counts()
        by = counts.pop("quant_dot_by_design")
        # fp32 x takes the tile design (its split-K adds a combine launch)
        if counts != want or by["swap"] or by["tma"] or \
                not want["quant_dot"] <= by["tile"] <= 2 * want["quant_dot"]:
            raise AssertionError(f"generate {kw}: launches {counts} {by}, "
                                 f"want {want}")
        return out["tokens"].cpu().numpy()

    flat_want = {"flash_fwd": L, "decode": (n - 1) * L, "quant_dot": 0,
                 "plain": 0}
    for kv_quant in (False, True):
        tag = "int8_cache_" if kv_quant else ""
        flat = run(model, flat_want, cache_layout="flat", kv_quant=kv_quant)
        grouped = run(model, {**flat_want, "decode": 0},
                      cache_layout="grouped", kv_quant=kv_quant)
        if not (flat == grouped).all():
            raise AssertionError(f"{tag}flat (kernel) tokens {flat} != "
                                 f"grouped {grouped}")
        info[f"{tag}flat_vs_grouped_identical"] = True
    # int8 weights against the same int8 weights dequantized to fp32
    quantize_params(model)
    deq = copy.deepcopy(model)
    for m in deq.modules():
        if isinstance(m, Dense):
            m.weight = torch.nn.Parameter(m.weight.float() * m.scale[:, None],
                                          requires_grad=False)
            m.scale = None

    def prefill(m):
        caches = init_cache(cfg, B, T, layout="flat", device="cuda")
        return m.decode(torch.from_numpy(prompt).cuda(), caches, 0)[0]

    _zero_counts()
    lq = prefill(model)
    if _gen_counts()["quant_dot"] != 7 * L:
        raise AssertionError(f"int8 prefill launches {_gen_counts()}")
    lf = prefill(deq)
    logit_rel = ((lq - lf).abs().max() / lf.abs().max()).item()
    if not torch.isfinite(lq).all() or logit_rel > 1e-4:
        raise AssertionError(f"int8 vs dequantized prefill logits differ by "
                             f"{logit_rel} of the largest")
    tq = run(model, {**flat_want, "quant_dot": n * 7 * L},
             cache_layout="flat")
    tf = run(deq, flat_want, cache_layout="flat")
    verdict = classify_divergence(deq, prompt, tf, tq)
    if verdict["divergence"] == "real":
        raise AssertionError(f"int8 weights vs dequantized: {verdict}")
    sampled = [generate(deq, prompt, n, temperature=0.8, top_k=50, top_p=0.95,
                        seed=seed + 1)["tokens"].cpu().numpy()
               for _ in range(2)]
    if not (sampled[0] == sampled[1]).all():
        raise AssertionError("seeded sampled generation did not repeat")
    info.update({"int8_weights_logit_rel_diff": logit_rel,
                 "int8_weights_vs_dequantized": verdict["divergence"],
                 "int8_weights_agreement": verdict["agreement"],
                 "sampled_rerun_identical": True,
                 "sampled_differs_from_greedy": bool((sampled[0] != tf).any())})
    del model, deq
    torch.cuda.empty_cache()
    return info


def _decode_profile(torch, model, prompt, steps=8, **cache_kw) -> dict:
    """``steps`` decode steps of ``Transformer.decode`` (the call the
    generate loop makes) after a prefill, under ``torch.profiler``: CUDA
    kernels and device busy ms per step, host wall per step (with the
    profiler on), the device's idle share, and the kernels taking the
    most device time."""
    from byteps_tpu_torch.models.transformer import init_cache

    B, T = prompt.shape
    caches = init_cache(model.cfg, B, T + steps, device="cuda", **cache_kw)
    logits, _ = model.decode(prompt, caches, 0, last_only=True)
    tok = [logits[:, -1].argmax(-1)]

    def decode():
        for i in range(steps):
            logits, _ = model.decode(tok[0][:, None], caches, T + i)
            tok[0] = logits[:, -1].argmax(-1)

    evs, wall_ms = _device_events(torch, decode)
    by_name, busy_us = {}, 0.0
    for name, us in evs:
        busy_us += us
        by_name[name[:70]] = by_name.get(name[:70], 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"steps": steps, "kernels_per_step": len(evs) / steps,
            "device_ms_per_step": busy_us / 1e3 / steps,
            "host_ms_per_step_profiled": wall_ms / steps,
            "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "top_device_ms_per_step": {k: v / 1e3 / steps for k, v in top}}


def generate_phase(torch, seed: int):
    """Full-width Llama-3.2-1B cached generation through
    ``make_generate_fn``: fp flat (twice), grouped, int8-cache flat
    (twice), int8 weights (twice).  Returns the run lines and the launch
    counts of the last fp, int8-cache and int8-weight runs."""
    import numpy as np

    from byteps_tpu_torch.inference import (classify_divergence,
                                            quantize_params)
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)

    cfg = TransformerConfig(**LLAMA_3_2_1B, max_seq_len=MAX_SEQ,
                            dtype=torch.bfloat16, attn_impl="flash")
    L, steps = cfg.num_layers, GEN_NEW - 1
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", param_dtype=torch.bfloat16)
    init_weights(model, seed)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prompt = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(GEN_B, GEN_PROMPT))).cuda()
    fp_want = {"flash_fwd": L, "decode": steps * L, "quant_dot": 0,
               "quant_dot_by_design": {"tile": 0, "swap": 0, "tma": 0},
               "plain": 0}

    def run(name, want, **kw):
        toks, line = _gen_run(torch, np, model, prompt, GEN_NEW, want, name,
                              **kw)
        line = {"phase": "generate_run", **line, "nvidia_smi": _smi()}
        _line(line)
        return toks, line

    runs = {}
    for name, want, kw in (
            ("fp_flat", fp_want, {}),
            ("fp_flat_rerun", fp_want, {}),
            ("fp_grouped", {**fp_want, "decode": 0},
             {"cache_layout": "grouped"}),
            ("int8_cache", fp_want, {"kv_quant": True,
                                     "cache_layout": "flat"}),
            ("int8_cache_rerun", fp_want, {"kv_quant": True,
                                           "cache_layout": "flat"})):
        runs[name] = run(name, want, **kw)
    verdict = classify_divergence(model, prompt, runs["fp_flat"][0],
                                  runs["fp_grouped"][0])
    if verdict["divergence"] == "real":
        raise AssertionError(f"flat (kernel) vs grouped: {verdict}")
    int8_cache_vs_fp = classify_divergence(model, prompt, runs["fp_flat"][0],
                                           runs["int8_cache"][0])
    profiles = {"fp_flat": _decode_profile(torch, model, prompt,
                                           layout="flat")}
    quantize_params(model)
    # bf16 x: the prefill's 15360 rows on the tma design, each decode
    # step's 8 on swap, one launch a call
    q_want = {**fp_want, "quant_dot": GEN_NEW * 7 * L,
              "quant_dot_by_design": {"tile": 0, "swap": steps * 7 * L,
                                      "tma": 7 * L}}
    for name in ("int8_weights", "int8_weights_rerun"):
        runs[name] = run(name, q_want, cache_layout="flat")
    profiles["int8_weights"] = _decode_profile(torch, model, prompt,
                                               layout="flat")
    for a in ("fp_flat", "int8_cache", "int8_weights"):
        if not (runs[a][0] == runs[a + "_rerun"][0]).all():
            raise AssertionError(f"{a}: greedy rerun is not token-identical")
    info = {"phase": "generate", "model": "Llama-3.2-1B (random weights)",
            "source": "meta-llama/Llama-3.2-1B config.json",
            "reduced": {"max_seq": [131072, MAX_SEQ]},
            "dtype": "bfloat16", "batch": GEN_B, "prompt": GEN_PROMPT,
            "new_tokens": GEN_NEW, "setup_s": setup_s,
            "reruns_identical": True,
            "flat_vs_grouped": verdict,
            "int8_cache_vs_fp": int8_cache_vs_fp,
            "decode_step_profile": profiles,
            "runs": {n: {k: v for k, v in r[1].items()
                         if k not in ("phase", "run")}
                     for n, r in runs.items()}}
    launches = {n: runs[n][1]["launches"] for n in
                ("fp_flat_rerun", "int8_cache_rerun", "int8_weights_rerun")}
    del model
    torch.cuda.empty_cache()
    return info, launches


SEARCH_BEAM = dict(B=2, T=512, beams=4, new=32)
SEARCH_SPEC = dict(B=4, T=512, new=64, gamma=4, draft_layers=4)


def search_phase(torch, seed: int):
    """``beam_search`` and ``speculative_generate`` at full width on phase
    15's model (``attn_impl="flash"``, bf16; ``init_cache``'s default, flat,
    cache).  Beam search, 2 prompts of 512 tokens, 4 beams, 32 new tokens:
    16 flash forwards (the prefill, once), 31 x 16 decode-kernel launches
    over the 8 beam rows, reruns identical, one beam equal to greedy
    ``generate`` (or a selection tie by ``classify_divergence``).
    Speculative generation, 4 prompts of 512, 64 new tokens, gamma 4, a
    4-layer ``truncated_draft``: the draft's decode launches (rounds x
    gamma x 4), its tokens not "real" against target-only greedy
    ``generate``; acceptance, rounds, and ms per emitted token.  Returns
    the phase line and the launch counts."""
    import numpy as np

    from byteps_tpu_torch.inference import (beam_search, generate,
                                            speculative_generate,
                                            truncated_draft)
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)

    cfg = TransformerConfig(**LLAMA_3_2_1B, max_seq_len=MAX_SEQ,
                            dtype=torch.bfloat16, attn_impl="flash")
    L = cfg.num_layers
    model = Transformer(cfg, device="cuda", param_dtype=torch.bfloat16)
    init_weights(model, seed)
    rng = np.random.RandomState(seed + 5)
    bm, sp = SEARCH_BEAM, SEARCH_SPEC
    info = {"phase": "search", "model": "Llama-3.2-1B (random weights)",
            "source": "meta-llama/Llama-3.2-1B config.json",
            "reduced": {"max_seq": [131072, MAX_SEQ]}, "dtype": "bfloat16",
            "attn_impl": "flash", "beam": bm, "speculative": sp}

    def timed(fn):
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, _gen_counts()

    def held(path, want):
        """Rows 7 and 1 on the run's own inputs, one held call a shape:
        ``want`` the shapes the run must have given them."""
        lines = path.hold(torch)
        got = sorted((h["kernel"], tuple(h["shapes"][1])) for h in lines)
        if got != sorted(want):
            raise AssertionError(f"held calls {got}, want {want}")
        return lines

    D, KVD = cfg.d_head, cfg.kv_heads * cfg.d_head
    prompt = rng.randint(0, cfg.vocab_size, size=(bm["B"], bm["T"]))
    beams = []
    with _PathCalls() as path:    # the first run's calls, held below
        beams.append(timed(lambda: beam_search(
            model, prompt, bm["new"], bm["beams"])))
    for i in range(2):
        out, ms, counts = beams[i] if i < len(beams) else timed(
            lambda: beam_search(model, prompt, bm["new"], bm["beams"]))
        want = {"flash_fwd": L, "decode": (bm["new"] - 1) * L,
                "quant_dot": 0, "plain": 0}
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"beam search launches {counts}, want "
                                 f"{want}")
        toks = out["tokens"].cpu().numpy()
        if toks.shape != (bm["B"], bm["new"]) or not torch.isfinite(
                out["beam_scores"]).all():
            raise AssertionError(f"beam search output {toks.shape}")
        beams[i:i + 1] = [(out, ms, counts)]
    beam_held = held(path, [
        ("flash_attention", (bm["B"], bm["T"], cfg.kv_heads, D)),
        ("decode_attention", (bm["B"] * bm["beams"], bm["T"] + bm["new"],
                              KVD))])
    for k in ("beam_tokens", "beam_scores"):
        if not torch.equal(beams[0][0][k], beams[1][0][k]):
            raise AssertionError(f"beam search rerun: {k} differ")
    one = beam_search(model, prompt, bm["new"], 1)["tokens"].cpu().numpy()
    greedy = generate(model, prompt, bm["new"],
                      temperature=0)["tokens"].cpu().numpy()
    one_vs_greedy = _not_real(torch, model, prompt, greedy, one,
                              "one beam vs greedy generate")
    info["beam_run"] = {"ms": [b[1] for b in beams],
                        "launches": beams[1][2],
                        "best_scores": beams[1][0]["scores"].tolist(),
                        "rerun_identical": True,
                        "one_beam_equals_greedy":
                            bool((one == greedy).all()),
                        "one_beam_vs_greedy": one_vs_greedy,
                        "held": beam_held, "nvidia_smi": _smi()}
    prompt = rng.randint(0, cfg.vocab_size, size=(sp["B"], sp["T"]))
    draft = truncated_draft(model, sp["draft_layers"])
    greedy, g_ms, _ = timed(lambda: generate(model, prompt, sp["new"],
                                             temperature=0)["tokens"])
    spec_rows = sp["T"] + sp["new"] + sp["gamma"] + 1   # its cache_len
    with _PathCalls() as path:
        out, ms, counts = timed(lambda: speculative_generate(
            model, draft, prompt, sp["new"], gamma=sp["gamma"]))
    rounds = out["rounds"]
    want = {"flash_fwd": L + sp["draft_layers"],
            "decode": rounds * sp["gamma"] * sp["draft_layers"],
            "quant_dot": 0, "plain": 0}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"speculative launches {counts}, want {want}")
    toks = out["tokens"].cpu().numpy()
    info["speculative_run"] = {
        "ms": ms, "ms_per_token": ms / sp["new"],
        "greedy_generate_ms": g_ms,
        "greedy_generate_ms_per_token": g_ms / sp["new"],
        "acceptance": out["acceptance"], "rounds": rounds,
        "tokens_per_target_forward": out["tokens_per_target_forward"],
        "launches": counts,
        "vs_greedy": _not_real(torch, model, prompt, greedy.cpu().numpy(),
                               toks, "speculative vs greedy generate"),
        # the target's and the draft's prefill share the flash shape
        "held": held(path, [
            ("flash_attention", (sp["B"], sp["T"], cfg.kv_heads, D)),
            ("decode_attention", (sp["B"], spec_rows, KVD))]),
        "nvidia_smi": _smi()}
    del model, draft
    torch.cuda.empty_cache()
    return info, {"beam": beams[1][2], "speculative": counts}


# ------------------------------------------------------ decode attention

DECODE_MAIN = dict(B=GEN_B, S=MAX_SEQ, H=32, KV=8, D=64, pos=MAX_SEQ - 1,
                   window=None)
# (name, shape over DECODE_MAIN, what the ring design's split plan must
# be there: "long" = splits of >= RING_MIN_CHUNKS chunks, "ragged" = a
# last split shorter than the others)
DECODE_CASES = (("pos_2047", {}, "long"), ("pos_0", {"pos": 0}, None),
                ("pos_1000", {"pos": 1000}, None),
                ("window256", {"window": 256}, None),
                ("s2000_ragged", {"S": 2000, "pos": 1999}, None),
                ("one_slot_ragged_split", {"B": 1, "pos": 1300}, "ragged"),
                ("mha_head_dim32", {"KV": 32, "D": 32}, None),
                ("head_dim128", {"D": 128}, None), ("mqa", {"KV": 1}, None),
                ("gpt2_g1", {"B": 4, "S": 1024, "H": 12, "KV": 12,
                             "pos": 1023}, None))
# GPT-2 small's decode (phase 13f): one query head a KV head, 12 heads;
# timed in bf16 beside SDPA
DECODE_G1 = "gpt2_g1"
DECODE_BF16_ULPS = 2  # ring design: ulps of each output row's largest


def _decode_inputs(torch, seed, c, mode):
    """q [B, 1, H, D] and flat caches: fp32 or bf16, or int8 values and
    scales (``_quantize_kv``) with a bf16 q."""
    from byteps_tpu_torch.models.transformer import _quantize_kv

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    B, S, H, KV, D = c["B"], c["S"], c["H"], c["KV"], c["D"]
    q = torch.randn((B, 1, H, D), generator=g, device="cuda")
    k = torch.randn((B, S, KV, D), generator=g, device="cuda")
    v = torch.randn((B, S, KV, D), generator=g, device="cuda")
    if mode.startswith("int8"):   # "int8": bf16 q, "int8_fp32q": fp32 q
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        qdt = torch.float32 if mode == "int8_fp32q" else torch.bfloat16
        return (q.to(qdt), kq.reshape(B, S, -1), vq.reshape(B, S, -1), ks,
                vs)
    dt = torch.float32 if mode == "float32" else torch.bfloat16
    return (q.to(dt), k.reshape(B, S, -1).to(dt), v.reshape(B, S, -1).to(dt),
            None, None)


def _decode_kernels(torch, fn, flush, tries=3, part="decode_") -> list:
    """Names of the decode kernels (names holding ``part``) one call of
    ``fn`` launched, one entry a launch, by the profiler (CPU and CUDA
    activities, as phase 15 takes them: after such a profile, CUDA-only
    profiles saw none of these kernels).  The flush and a sync lead the
    call, since the profiler can miss what is launched while it starts; a
    profile that saw none of these kernels is taken again on a fresh call,
    up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            flush.zero_()
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        ran = [n for n in names if part in n]
        if ran:
            return ran
        seen.append([n[:60] for n in names])
    print(json.dumps({"decode_profile_saw": seen,
                      "events": len(prof.events())}), file=sys.stderr)
    return []


def _decode_call(torch, seed, over, mode):
    """The case's inputs and a function making one wrapper call on them."""
    from byteps_tpu_torch.ops import decode_attention as da

    c = {**DECODE_MAIN, **over}
    q, ck, cv, ks, vs = _decode_inputs(torch, seed, c, mode)
    args = (q, ck, cv, c["pos"])
    kw = {"k_scale": ks, "v_scale": vs, "window": c["window"]}
    return c, args, kw, lambda: da.decode_attention(*args, **kw)


def decode_kernel_names(torch, seed: int) -> dict:
    """``{"case/mode": names}``: the decode kernels one call of each
    phase-16 case launched, by the profiler.  Run in a fresh process
    (``--decode-kernel-names``): by phase 16 the long run of this script
    has a profiler that records no device event (seen on the H100)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for mode in ("bfloat16", "int8", "float32"):
        for name, over, _ in DECODE_CASES:
            _, _, _, call = _decode_call(torch, seed, over, mode)
            call()
            out[f"{name}/{mode}"] = _decode_kernels(torch, call, flush)
    return out


def decode_case(torch, name, over, plan, mode, seed, flush, timed, ran):
    """One case of phase 16: the kernel against its plain version, the
    kernels one call launched (``ran``, profiler names), a rerun's bits,
    the split plan the case is for, and at the main shape the times."""
    import torch.nn.functional as F

    from byteps_tpu_torch.ops import decode_attention as da

    c, args, kw, call = _decode_call(torch, seed, over, mode)
    B, S, H, KV, D, pos, w = (c[k] for k in ("B", "S", "H", "KV", "D",
                                             "pos", "window"))
    q, ck, cv, ks, vs = *args[:3], kw["k_scale"], kw["v_scale"]
    ring = mode != "float32"          # a bf16 q: the design on tensor cores
    lo = (max(pos - w + 1, 0) if w else 0) // da.CHUNK
    n = pos // da.CHUNK - lo + 1
    nsplit, per = da._splits(B, KV, n, torch.cuda.get_device_properties(
        0).multi_processor_count, ring)
    if ring and ((plan == "long" and not (nsplit > 1
                                          and per >= da.RING_MIN_CHUNKS))
                 or (plan == "ragged" and not (nsplit > 1 and n % per))):
        raise AssertionError(f"decode {name}: plan ({nsplit}, {per}) over "
                             f"{n} chunks is not {plan}")
    out = call()
    want = (["decode_ring_kernel"] if ring else
            ["decode_attention_kernel"]
            + (["decode_attention_combine"] if nsplit > 1 else []))
    if len(ran) != len(want) or not all(
            sum(x in k for k in ran) == 1 for x in want):
        raise AssertionError(f"decode {name} {mode}: kernels {ran}, want "
                             f"one each of {want}")
    ref = da.decode_attention_reference(*args, **kw)
    again = da.decode_attention(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"decode {name} {mode}: a rerun differs")
    if not (torch.isfinite(out.float()).all()
            and torch.isfinite(ref.float()).all()):
        raise AssertionError(f"decode {name} {mode}: non-finite output")
    abs_err = (out.float() - ref.float()).abs().max().item()
    if ring:      # both sides round p and the output to bf16
        err, tol = _row_ulps(torch, out, ref), DECODE_BF16_ULPS
    else:         # online softmax over splits vs one dense softmax
        err, tol = abs_err, 1e-4
    if err > tol:
        raise AssertionError(f"decode {name} {mode}: error {err} > {tol}")
    res = {"case": name, "mode": mode, "B_S_H_KV_D": [B, S, H, KV, D],
           "pos": pos, "window": w, "splits_per": [nsplit, per],
           "kernels": [k[:80] for k in ran], "max_abs_err": abs_err,
           "err": err,
           "err_unit": "bf16 ulps of the row's max" if ring else "absolute",
           "tolerance": tol, "rerun_identical": True}
    if not timed:
        return res
    res["kernel_ms"] = _graph_ms(torch, lambda: da.decode_attention(
        *args, **kw), flush)
    res["plain_ms"] = _graph_ms(
        torch, lambda: da.decode_attention_reference(*args, **kw), flush,
        iters=5)
    # the yardstick: SDPA over the attended rows (int8: dequantized to bf16)
    n = pos + 1
    kd, vd = (x.view(B, S, KV, D)[:, :n] for x in (ck, cv))
    if mode == "int8":
        kd = (kd.float() * ks[:, :n, :, None]).to(torch.bfloat16)
        vd = (vd.float() * vs[:, :n, :, None]).to(torch.bfloat16)
    kd, vd = (x.transpose(1, 2).contiguous() for x in (kd, vd))
    qd = q.transpose(1, 2).contiguous()
    lib = F.scaled_dot_product_attention(qd, kd, vd, enable_gqa=True)
    res["library_err"] = (lib.transpose(1, 2).float()
                          - ref.float()).abs().max().item()
    res["library_ms"] = _graph_ms(
        torch, lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                      enable_gqa=True),
        flush)
    # both again behind a flush that leaves the L2 clean: what the dirty
    # lines' write-back adds to a call of a few microseconds
    clean = _ReadFlush(torch)
    res["kernel_ms_clean_l2"] = _graph_ms(torch, lambda: da.decode_attention(
        *args, **kw), clean)
    res["library_ms_clean_l2"] = _graph_ms(
        torch, lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                      enable_gqa=True),
        clean)
    del clean
    elt = ck.element_size()
    nbytes = (da.kv_bytes_read(B, pos, KV * D, elt, w,
                               kv_heads=KV if mode == "int8" else 0)
              + 2 * q.numel() * q.element_size())           # q in, out
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (da.decode_flops(B, H, D, pos, w)
             / PEAK_FLOPS[str(q.dtype).split(".")[-1]] * 1e3)
    res["bound_ms"] = max(t_bytes, t_ops)
    res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    res["bytes"] = nbytes
    return res


# the device form: 8 slots at mixed depths in one launch
DEVICE_POS = (0, 15, 16, 63, 255, 1000, 1919, 2047)
# q and cache: bf16 / bf16, int8 with a bf16 q (the ring design), fp32 /
# fp32 and int8 with an fp32 q (the first design)
DEVICE_MODES = ("bfloat16", "int8", "float32", "int8_fp32q")


def decode_device_case(torch, mode, window, seed, flush, timed) -> dict:
    """The decode kernel at a ``[8]`` position vector on the card: held to
    the plain version at phase 16's tolerances, the library's counts
    (one launch reading the vector), reruns bit-identical, each slot's
    bits unchanged when the other slots' positions change, the ring's
    tickets back at zero, and a CUDA graph captured once and replayed at
    positions rewritten in place (no host read of the vector).  Timed:
    the one launch, 8 one-slot int launches at the same depths, the int
    call with every slot at 2047, and SDPA on the same rows under a key
    mask, from CUDA graphs behind the write flush and the read flush."""
    import torch.nn.functional as F

    from byteps_tpu_torch.ops import decode_attention as da

    c = {**DECODE_MAIN, "window": window}
    q, ck, cv, ks, vs = _decode_inputs(torch, seed, c, mode)
    B, S, H, KV, D = (c[k] for k in ("B", "S", "H", "KV", "D"))
    kw = {"k_scale": ks, "v_scale": vs, "window": window}
    posv = torch.tensor(DEVICE_POS, dtype=torch.int32, device="cuda")
    ring = q.dtype == torch.bfloat16
    nsplit, per = da._splits(B, KV, da._max_chunks(S, window),
                             torch.cuda.get_device_properties(
                                 0).multi_processor_count, ring)

    def call(p):
        return da.decode_attention(q, ck, cv, p, **kw)

    def reading(out, p):
        ref = da.decode_attention_reference(q, ck, cv, p, **kw)
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"decode device {mode}: non-finite output")
        abs_err = (out.float() - ref.float()).abs().max().item()
        return abs_err, (_row_ulps(torch, out, ref) if ring else abs_err)

    tol = DECODE_BF16_ULPS if ring else 1e-4
    by = dict(da.design_launches)
    out = call(posv)
    took = [da.design_launches[k] - by[k] for k in da.COUNTS]
    if took != da._kernels_for(ring, nsplit, True):
        raise AssertionError(f"decode device {mode}: launches {took}")
    abs_err, err = reading(out, posv)
    if err > tol:
        raise AssertionError(f"decode device {mode} window {window}: error "
                             f"{err} > {tol}")
    if not torch.equal(out, call(posv)):
        raise AssertionError(f"decode device {mode}: a rerun differs")
    other = torch.tensor(DEVICE_POS[::-1], dtype=torch.int32, device="cuda")
    for b in range(B):
        moved = other.clone()
        moved[b] = posv[b]
        if not torch.equal(call(moved)[b], out[b]):
            raise AssertionError(f"decode device {mode}: slot {b}'s bits "
                                 f"moved with the other slots' positions")
    torch.cuda.synchronize()
    if ring and nsplit > 1 and da._tickets[q.device][:B * KV].any():
        raise AssertionError(f"decode device {mode}: tickets left set")
    live = posv.clone()
    call(live)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call(live)
    replays = 0
    for p in (DEVICE_POS[::-1], (2047,) * B, (5,) * B, DEVICE_POS):
        live.copy_(torch.tensor(p, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        if reading(got, live)[1] > tol or not torch.equal(got, call(live)):
            raise AssertionError(f"decode device {mode}: graph replay at "
                                 f"{p} is wrong")
        replays += 1
    del graph
    res = {"case": f"device_pos_{mode}", "mode": mode,
           "q_dtype": str(q.dtype).split(".")[-1],
           "B_S_H_KV_D": [B, S, H, KV, D], "pos": list(DEVICE_POS),
           "window": window, "splits_per": [nsplit, per],
           "library_counts": took, "max_abs_err": abs_err, "err": err,
           "err_unit": "bf16 ulps of the row's max" if ring else "absolute",
           "tolerance": tol, "rerun_identical": True,
           "slots_independent": True, "graph_replays": replays}
    if not timed:
        return res
    rows = [(q[b:b + 1], ck[b:b + 1], cv[b:b + 1],
             None if ks is None else ks[b:b + 1],
             None if vs is None else vs[b:b + 1]) for b in range(B)]

    def per_slot():
        for b, (qb, kb, vb, ksb, vsb) in enumerate(rows):
            da.decode_attention(qb, kb, vb, DEVICE_POS[b], k_scale=ksb,
                                v_scale=vsb, window=window)

    # SDPA on the same rows: keys [0, max pos], each slot's own mask
    n = max(DEVICE_POS) + 1
    kd, vd = (x.view(B, S, KV, D)[:, :n] for x in (ck, cv))
    if ks is not None:
        kd = (kd.float() * ks[:, :n, :, None]).to(q.dtype)
        vd = (vd.float() * vs[:, :n, :, None]).to(q.dtype)
    kd, vd = (x.transpose(1, 2).contiguous() for x in (kd, vd))
    qd = q.transpose(1, 2).contiguous()
    keys = torch.arange(n, device="cuda")[None, :]
    mask = keys <= posv.long()[:, None]
    if window:
        mask &= keys > posv.long()[:, None] - window
    mask = mask[:, None, None, :]                       # [B, 1, 1, n]

    def sdpa():
        return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                              enable_gqa=True)

    clean = _ReadFlush(torch)
    for key, fn in (("kernel_ms", lambda: call(posv)),
                    ("per_slot_ms", per_slot),
                    ("int_all_2047_ms", lambda: call(S - 1)),
                    ("library_ms", sdpa)):
        res[key] = _graph_ms(torch, fn, flush)
        res[key + "_clean_l2"] = _graph_ms(torch, fn, clean)
    del clean
    res["plain_ms"] = _time_ms(torch, lambda: da.decode_attention_reference(
        q, ck, cv, posv, **kw), flush, iters=5)
    elt = ck.element_size()
    nbytes = (da.kv_bytes_read(B, DEVICE_POS, KV * D, elt, window,
                               kv_heads=KV if ks is not None else 0)
              + 2 * q.numel() * q.element_size() + 4 * B)  # q, out, pos
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (da.decode_flops(B, H, D, DEVICE_POS, window)
             / PEAK_FLOPS[res["q_dtype"]] * 1e3)
    res["bound_ms"] = max(t_bytes, t_ops)
    res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    res["bytes"] = nbytes
    return res


def decode_kernel_phase(torch, seed: int) -> dict:
    names = json.loads(subprocess.run(
        [sys.executable, __file__, "--seed", str(seed),
         "--decode-kernel-names"], capture_output=True, text=True,
        check=True, timeout=600).stdout.strip().splitlines()[-1])
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    main = {}
    g1 = None
    for mode in ("bfloat16", "int8", "float32"):
        for name, over, plan in DECODE_CASES:
            timed = ((not over and mode != "float32")
                     or (name == DECODE_G1 and mode == "bfloat16"))
            r = decode_case(torch, name, over, plan, mode, seed, flush,
                            timed, names[f"{name}/{mode}"])
            _line(r)
            if name == DECODE_G1 and timed:
                g1 = r
            elif timed:
                main[mode] = r
        torch.cuda.empty_cache()
    cases = []
    for mode in DEVICE_MODES:
        for window in (None, 256):
            timed = window is None and mode in main
            cases.append(decode_device_case(torch, mode, window, seed, flush,
                                            timed))
            _line(cases[-1])
            if timed:
                main[mode]["device_pos"] = cases[-1]
        torch.cuda.empty_cache()
    for r in main.values():
        r["device_cases"] = sum(c["mode"] == r["mode"] for c in cases)
        r["device_max_abs_err"] = max(c["max_abs_err"] for c in cases
                                      if c["mode"] == r["mode"])
    main["bfloat16"]["gpt2_g1"] = g1
    return main


# ------------------------------------------------------ int8 product

# Llama-3.2-1B's projections (K -> N) and how many a layer runs; then the
# probe's shape and a ragged one (N, and K % 64 != 0)
QUANT_SHAPES = (("q_o_2048x2048", 2048, 2048, 2),
                ("k_v_2048x512", 2048, 512, 2),
                ("gate_up_2048x8192", 2048, 8192, 2),
                ("down_8192x2048", 8192, 2048, 1),
                ("probe_768x3072", 768, 3072, 0),
                ("ragged_208x1000", 208, 1000, 0))
QUANT_ROWS = (1, GEN_B, 16, 40, 64, 65, 4096, GEN_B * GEN_PROMPT)
# GPT-2 small's layer under quantize_params (phase 13f): q, k, v, o at
# 768 -> 768, the MLP's 768 -> 3072 and 3072 -> 768; timed at that
# phase's decode rows (4 prompts) and prefill rows (4 x 256)
GPT2_QUANT_SHAPES = (("gpt2_768x768", 768, 768, 4),
                     ("probe_768x3072", 768, 3072, 1),
                     ("gpt2_3072x768", 3072, 768, 1))
GPT2_QUANT_ROWS = (4, 1024)
QUANT_TIMED = (GEN_B, GEN_B * GEN_PROMPT)   # decode, prefill
# (name, x dtype, output dtype, bias): bf16 x takes swap (<= 64 rows) or
# tma; fp32 output from bf16 x is the untied quantized head's mode; fp32 x
# the tile design
QUANT_MODES = (("bf16", "bfloat16", "bfloat16", False),
               ("bf16_bias", "bfloat16", "bfloat16", True),
               ("bf16_fp32_out_bias", "bfloat16", "float32", True),
               ("fp32", "float32", "float32", False),
               ("fp32_bias", "float32", "float32", True))


def _quant_modes(M):
    """The modes a row count runs: every bf16 one; fp32 x at the timed
    rows only."""
    return [m for m in QUANT_MODES if m[1] == "bfloat16" or M in QUANT_TIMED]


def _quant_call(torch, seed, M, K, N, mode):
    """The case's inputs and a function making one wrapper call on them."""
    from byteps_tpu_torch.ops import quant_dot as qd

    _, xdt, odt, bias = mode
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.randn((M, K), generator=g, device="cuda").to(getattr(torch,
                                                                   xdt))
    w, scale = qd.quantize_weight(
        torch.randn((N, K), generator=g, device="cuda") * 0.02)
    b = torch.randn((N,), generator=g, device="cuda") if bias else None
    odt = getattr(torch, odt)
    return (x, w, scale, b, odt), lambda: qd.quant_linear(x, w, scale, b, odt)


def quant_kernel_names(torch, seed: int) -> dict:
    """``{"shape/M/mode": names}``: the int8-product kernels one call of
    each bf16 phase-17 case launched, by the profiler.  Run in a fresh
    process (``--quant-kernel-names``), as phase 16's names are."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for M in QUANT_ROWS:
        for name, K, N, _ in QUANT_SHAPES:
            for mode in _quant_modes(M):
                if mode[1] != "bfloat16":
                    continue
                _, call = _quant_call(torch, seed, M, K, N, mode)
                call()
                out[f"{name}/{M}/{mode[0]}"] = [
                    k[:60] for k in _decode_kernels(torch, call, flush,
                                                    part="quant_")]
        torch.cuda.empty_cache()
    return out


def quant_case(torch, name, M, K, N, mode, seed, flush, timed, ran):
    """One case of phase 17: the kernel against its plain version, the
    design the rule names against the launches the library counted, the
    kernels one call launched (``ran``, profiler names; bf16 x), a rerun's
    bits, and at the timed rows the times of both designs, the plain
    version, cuBLAS on the dequantized weight and the bound."""
    import torch.nn.functional as F

    from byteps_tpu_torch.ops import quant_dot as qd

    (x, w, scale, b, odt), call = _quant_call(torch, seed, M, K, N, mode)
    before = dict(qd.design_launches)
    out = call()
    torch.cuda.synchronize()
    took = {k: qd.design_launches[k] - before[k] for k in qd.DESIGNS}
    design = qd._design(x.dtype, M, N, K, x.data_ptr(), w.data_ptr(),
                        out.data_ptr())
    want = (qd.SWAP if M <= qd.SWAP_MAX_ROWS else qd.TMA) \
        if x.dtype == torch.bfloat16 else qd.TILE
    if design != want or not took[qd.DESIGNS[want]] or sum(
            took.values()) != took[qd.DESIGNS[want]]:
        raise AssertionError(f"quant {name} M={M} {mode[0]}: rule "
                             f"{qd.DESIGNS[design]}, launched {took}, want "
                             f"{qd.DESIGNS[want]}")
    if ran is not None:
        kern = "quant_swap_kernel" if want == qd.SWAP else "quant_tma_kernel"
        if len(ran) != 1 or kern not in ran[0]:
            raise AssertionError(f"quant {name} M={M} {mode[0]}: kernels "
                                 f"{ran}, want one {kern}")
    again = call()
    ref = qd.quant_linear_reference(x, w, scale, b, odt)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"quant {name} M={M} {mode[0]}: a rerun "
                             f"differs")
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"quant {name} M={M}: non-finite output")
    top = ref.float().abs().max().item()
    abs_err = (out.float() - ref.float()).abs().max().item()
    tol = 2.0 ** -7 if x.dtype == torch.bfloat16 else 1e-5
    if abs_err > tol * top:
        raise AssertionError(f"quant {name} M={M} {mode[0]}: error "
                             f"{abs_err} > {tol} x {top}")
    res = {"case": name, "M_K_N": [M, K, N], "mode": mode[0],
           "design": qd.DESIGNS[design], "launched": took,
           "kernels": ran, "rerun_identical": True,
           "max_abs_err": abs_err, "err": abs_err / top,
           "err_bf16_ulps_of_max": abs_err / (2.0 ** -7 * top),
           "tolerance": tol}
    if not timed:
        return res
    few = M <= qd.SWAP_MAX_ROWS
    iters, reps = (50, 5) if few else (3, 3)
    res["design_ms"] = _graph_ms(torch, lambda: qd.quant_linear(x, w, scale),
                                 flush, iters, reps)
    res["tile_ms"] = _graph_ms(torch, lambda: qd.quant_linear_design(
        x, w, scale, design=qd.TILE), flush, iters, reps)
    res["plain_ms"] = _graph_ms(
        torch, lambda: qd.quant_linear_reference(x, w, scale), flush,
        min(iters, 5))
    wbf = (w.float() * scale[:, None]).to(torch.bfloat16)
    res["library_ms"] = _graph_ms(torch, lambda: F.linear(x, wbf), flush,
                                  iters, reps)
    elt = x.element_size()
    nbytes = M * K * elt + N * K + 4 * N + M * N * elt
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = qd.quant_flops(M, N, K) / PEAK_FLOPS["bfloat16"] * 1e3
    res["bound_ms"] = max(t_bytes, t_ops)
    res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    res["design_tflops"] = qd.quant_flops(M, N, K) / res["design_ms"] / 1e9
    return res


def quant_kernel_phase(torch, seed: int) -> dict:
    """Every case checked; bf16 x without bias timed at the decode and
    prefill rows.  Returns the sums over one layer's seven projections at
    each: ``{"decode": {...}, "prefill": {...}}``."""
    names = json.loads(subprocess.run(
        [sys.executable, __file__, "--seed", str(seed),
         "--quant-kernel-names"], capture_output=True, text=True,
        check=True, timeout=600).stdout.strip().splitlines()[-1])
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    layers = {}
    # (shapes, rows, the timed rows' layer keys, a row's modes): Llama's
    # layer in every mode, GPT-2's in bf16 without bias
    for shapes, rows, keys, modes in (
            (QUANT_SHAPES, QUANT_ROWS, dict(zip(QUANT_TIMED, (
                "decode", "prefill"))), _quant_modes),
            (GPT2_QUANT_SHAPES, GPT2_QUANT_ROWS, dict(zip(GPT2_QUANT_ROWS, (
                "gpt2_decode", "gpt2_prefill"))), lambda M: QUANT_MODES[:1])):
        for M in rows:
            layer = {"rows": M, "design_ms": 0.0, "tile_ms": 0.0,
                     "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                     "max_abs_err": 0.0, "bytes_bound": True}
            for name, K, N, count in shapes:
                for mode in modes(M):
                    timed = M in keys and mode[0] == "bf16"
                    r = quant_case(torch, name, M, K, N, mode, seed, flush,
                                   timed, names.get(f"{name}/{M}/{mode[0]}"))
                    _line(r)
                    if timed and count:
                        for k in ("design_ms", "tile_ms", "plain_ms",
                                  "library_ms", "bound_ms"):
                            layer[k] += count * r[k]
                        layer["max_abs_err"] = max(layer["max_abs_err"],
                                                   r["max_abs_err"])
                        layer["bytes_bound"] &= r["bound_by"] == "bytes"
                torch.cuda.empty_cache()
            if M in keys:
                layer["bound_by"] = ("bytes" if layer.pop("bytes_bound")
                                     else "operations")
                layers[keys[M]] = layer
                _line({"phase": f"quant_dot_{keys[M]}_layer", **layer})
    return layers


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and inputs")
    ap.add_argument("--decode-kernel-names", action="store_true",
                    help="print only the decode kernels each phase-16 "
                         "case launches (phase 16 runs this in a fresh "
                         "process)")
    ap.add_argument("--dp-worker", action="store_true",
                    help="run one worker of phase 13a (b) (the phase "
                         "starts two through the port's launcher)")
    ap.add_argument("--ef-worker", action="store_true",
                    help="run one worker of phase 13h (c) (the phase "
                         "starts two through the port's launcher)")
    ap.add_argument("--async-worker", action="store_true",
                    help="run one worker of phase 13i (the phase starts "
                         "two through the port's launcher)")
    ap.add_argument("--async-steps", type=int, default=3,
                    help="--async-worker's steps")
    ap.add_argument("--dp-out", default="",
                    help="where --dp-worker, --ef-worker or --async-worker "
                         "writes its JSON result")
    ap.add_argument("--only", choices=("13i",), default=None,
                    help="build, then run only this phase and print no "
                         "result line (a quick check of one phase)")
    ap.add_argument("--quant-kernel-names", action="store_true",
                    help="print only the int8-product kernels each bf16 "
                         "phase-17 case launches (phase 17 runs this in a "
                         "fresh process)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs a GPU",
              file=sys.stderr)
        return 1
    from byteps_tpu_torch.ops import _build

    # fp32 products in full fp32 for the reference phases (TF32 keeps
    # three digits); stated and set, not assumed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.decode_kernel_names:
        _line(decode_kernel_names(torch, args.seed))
        return 0
    if args.quant_kernel_names:
        _line(quant_kernel_names(torch, args.seed))
        return 0
    if args.dp_worker:
        return dp_worker(torch, args.seed, args.dp_out)
    if args.ef_worker:
        return ef_worker(torch, args.seed, args.dp_out)
    if args.async_worker:
        return async_worker(torch, args.seed, args.dp_out, args.async_steps)
    smi = _smi()
    _line({"phase": "device", "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "device": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    libs = _build.build(KERNEL_SOURCES)   # one nvcc per source, in parallel
    _line({"phase": "build", "kernels": {n: str(p) for n, p in libs.items()},
           "seconds": time.perf_counter() - t0,
           "ptxas": {n: [ln.strip() for ln in log.splitlines()
                         if "registers" in ln or "spill" in ln]
                     for n, log in _build.build_logs.items()}})
    _line(ptxas_phase(_build.build_logs))
    if args.only == "13i":
        _line(async_ps_phase(torch, args.seed, None))
        return 0
    _line(reference_phase(torch, args.seed))
    serve_info, paged_launches, final_pos, paged_results = serve_phase(
        torch, args.seed)
    serve_info["nvidia_smi"] = smi
    _line(serve_info)
    _, paged_main = kernel_phase(torch, args.seed, final_pos)
    _line(serve_role_phase(torch, {}))
    _line(serve_role_phase(torch, PAGED_ROLE_ENV))
    _line(serve_role_phase(torch, {**PAGED_ROLE_ENV, **TIERS_ROLE_ENV}))
    _line(tiers_reference_phase(torch, args.seed))
    tiers_info, tiers_tp1, tiers_tp2 = tiers_serve_phase(torch, args.seed)
    tiers_info["nvidia_smi"] = _smi()
    _line(tiers_info)
    tiers_main = tiers_kernel_phase(torch, args.seed, tiers_tp1["final_pos"])
    _line(dense_reference_phase(torch, args.seed))
    dense_info, dense_launches = dense_serve_phase(torch, args.seed,
                                                   serve_info)
    _line(dense_info)
    _line(dense_tiers_reference_phase(torch, args.seed))
    _line(dense_tiers_serve_phase(torch, args.seed))
    gather_info, gather_launches, int8_results = gather_serve_phase(
        torch, args.seed, paged_results)
    _line(gather_info)
    _line(disagg_reference_phase(torch, args.seed))
    disagg_info = disagg_serve_phase(torch, args.seed, paged_results,
                                     int8_results)
    disagg_info["phase4_tpot_p50_ms"] = serve_info["run1"]["tpot_p50_ms"]
    disagg_info["phase4_tpot_p99_ms"] = serve_info["run1"]["tpot_p99_ms"]
    disagg_info["phase4_tokens_per_s"] = serve_info["run1"]["tokens_per_s"]
    _line(disagg_info)
    router_info = router_serve_phase(torch, args.seed, serve_info,
                                     paged_results)
    _line(router_info)
    _line(router_process_phase(torch, args.seed))
    _line(router_autoscale_phase(torch, args.seed))
    _line(train_reference_phase(torch, args.seed))
    train_info, flash_launches, _ = train_phase(torch, args.seed)
    train_info["nvidia_smi"] = _smi()
    _line(train_info)
    flash_main = flash_kernel_phase(torch, args.seed)
    _line(fused_reference_phase(torch, args.seed))
    fused_info, fce_launches, eval_info = train_phase(
        torch, args.seed, fused_head=True,
        then=lambda tr, m: eval_phase(torch, args.seed, tr, m))
    warm_rel = (abs(fused_info["losses"][0] - train_info["losses"][0])
                / abs(train_info["losses"][0]))
    if warm_rel > EVAL_TOL:
        raise AssertionError(f"fused-head warm-up loss "
                             f"{fused_info['losses'][0]} vs plain head "
                             f"{train_info['losses'][0]}: {warm_rel}")
    fused_info["warmup_loss_rel_diff_vs_plain_head"] = warm_rel
    fused_info["nvidia_smi"] = _smi()
    _line(fused_info)
    _line(eval_info)
    fce_main = fce_kernel_phase(torch, args.seed)
    _line(dp_eager_phase(torch, args.seed))
    dp_info = dp_train_phase(torch, args.seed)
    dp_info["nvidia_smi"] = _smi()
    _line(dp_info)
    dp_launches = [DP_STEPS * n for n in dp_info["launches_per_worker_step"]]
    dp_held = [h for w in dp_info["workers"] for h in w["held"]]
    ef_info, ef_launches = ef_phase(torch, args.seed,
                                    fused_info["step_ms_p50"])
    ef_info["nvidia_smi"] = _smi()
    _line(ef_info)
    ef2_info = ef_world2_phase(torch, args.seed)
    ef2_info["nvidia_smi"] = _smi()
    _line(ef2_info)
    _line(serve_checkpoint_phase(torch, args.seed))
    async_info = async_ps_phase(torch, args.seed, fused_info["step_ms_p50"])
    async_info["nvidia_smi"] = _smi()
    _line(async_info)
    async_held = async_info["fp32"]["held"] + async_info["bf16"]["held"]

    def async_rows(i, kernel):
        """Phase 13i's launches of count ``i`` per worker in each run, and
        its workers' held calls of ``kernel``."""
        return {"async_ps_launches_per_worker": {
                    run: [w[i] for w in async_info[run]
                          ["launches_per_worker"]]
                    for run, _, _ in ASYNC_RUNS},
                "async_ps_held_on_path": held(async_held, kernel)}
    # this slice's phases run after phase 13: their profile takes CPU and
    # CUDA activities, after which phase 13's CUDA-only profiles saw no
    # kernel (seen on the H100)
    hf = _transformers()
    if hf is None:
        _line(HF_NOT_RUN)
    _line(bert_reference_phase(torch, args.seed))
    bert_info, bert_launches, bert_held = bert_phase(torch, args.seed)
    _line(bert_info)
    _line(bert_mlm_phase(torch, args.seed))
    if hf is not None:
        _line(hf_bert_phase(torch, args.seed, hf))
    gpt2_info, gpt2_runs, gpt2_train = gpt2_phase(torch, args.seed, hf)
    gpt2_info["nvidia_smi"] = _smi()
    _line(gpt2_info)
    llama_info, llama_run = llama_phase(torch, args.seed, hf)
    llama_info["nvidia_smi"] = _smi()
    _line(llama_info)
    _line(generate_reference_phase(torch, args.seed))
    gen_info, gen_launches = generate_phase(torch, args.seed)
    _line(gen_info)
    search_info, search_launches = search_phase(torch, args.seed)
    _line(search_info)
    decode_main = decode_kernel_phase(torch, args.seed)
    quant_layers = quant_kernel_phase(torch, args.seed)
    print(_smi(), flush=True)
    search_held = (search_info["beam_run"]["held"]
                   + search_info["speculative_run"]["held"])
    gather_held = [h for name in ("int8", "int8_rerun", "int8_tp2")
                   for h in gather_info[name]["held"]]

    def held(lines, kernel):
        """A slice's calls of a kernel held on the main path's inputs
        (phases 6h and 15b; 13c, 13f and 13g): how many, at which second
        operands (cache rows, K/V, weights), the worst; with backward
        calls held, the worst of each gradient."""
        hs = [h for h in lines if h["kernel"] == kernel]
        out = {"calls": len(hs),
               "shapes": sorted({tuple(h["shapes"][1]) for h in hs}),
               "max_abs_err": max(h["max_abs_err"] for h in hs),
               "err": max(h["err"] for h in hs),
               "tolerance": hs[0]["tolerance"]}
        for g in ("dq", "dk", "dv", "dx", "dw"):
            errs = [h[f"{g}_err"] for h in hs if f"{g}_err" in h]
            if errs:
                out[f"{g}_err"] = max(errs)
        return out

    # this slice's paths: GPT-2's and Llama's generation, GPT-2's fused
    # training, the BERT fine-tune
    gen_held = (gpt2_runs["bf16"]["held"] + gpt2_runs["int8_weights"]["held"]
                + llama_run["held"])
    gpt2_train_held = gpt2_info["train"]["held"]

    def training_rest(i, kernel):
        """Phase 13h's launches of count ``i`` (flash fwd, dq, dkv, fused
        CE fwd, dx, dw) and its workers' held calls of ``kernel``."""
        return {"training_rest_launches": {
                    "onebit_world1": ef_launches[i],
                    "world2_per_worker": {
                        k: v[i] for k, v in
                        ef2_info["launches_per_worker"].items()}},
                "training_rest_held_on_path": held(ef2_info["held"],
                                                   kernel)}

    def case(r):
        return {k: r[k] for k in (
            "B_T_H_KV_D", "causal", "segments", "fwd_max_abs_err",
            "dq_max_abs_err", "dkv_max_abs_err", "fwd_ms", "dq_ms",
            "dkv_ms", "fwd_plain_ms", "dq_plain_ms", "dkv_plain_ms",
            "fwd_bound_ms", "dq_bound_ms", "dkv_bound_ms", "fwd_bound_by",
            "dq_bound_by", "dkv_bound_by", "library_fwd_ms",
            "library_bwd_ms")}

    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "byteps_tpu_torch/csrc/paged_attention.cu",
        "replaces": "byteps_tpu/ops/paged_attention.py:76",
        "launches": paged_launches, "max_abs_err": paged_main["max_err"],
        "ms": paged_main["kernel_ms"], "plain_ms": paged_main["plain_ms"],
        "bound_ms": paged_main["bound_ms"],
        "bound_by": paged_main["bound_by"],
        "library_ms": paged_main["library_ms"],
        # this slice's path: the decode replica of phase 6i's pairs
        "disagg_launches": {name: disagg_info[name]["launches"]
                            for name, _, _ in DISAGG_POOLS},
        # per run: the int8 mode's limit is in ulps, the bf16 one's not
        "disagg_held_on_path": {name: held(disagg_info[name]["held"],
                                           "paged_attention")
                                for name, _, _ in DISAGG_POOLS},
        # the router slice's path: phase 6j's replicas, (a) per replica
        # and (d)'s decode replica, and their held calls
        "router_launches": {
            "placement": router_info["placement"]["paged_calls"],
            "disagg": router_info["disagg"]["paged_calls"]},
        "router_held_on_path": held(router_info["held"]
                                    + router_info["disagg"]["held"],
                                    "paged_attention")}]
    for kname, run, ms, err in (
            ("paged_attention_int8", tiers_tp1, "kernel_ms", "max_err"),
            ("paged_attention_int8_tp2", tiers_tp2, "tp2_ms", "tp2_max_err")):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "byteps_tpu_torch/csrc/paged_attention.cu",
            "replaces": ("byteps_tpu/ops/paged_attention.py:76"
                         if run["tp"] == 1 else
                         "byteps_tpu/ops/paged_attention.py:306"),
            "launches": run["launches"], "max_abs_err": tiers_main[err],
            "ms": tiers_main[ms], "plain_ms": tiers_main["plain_ms"],
            "bound_ms": tiers_main["bound_ms"],
            "bound_by": tiers_main["bound_by"],
            "library_ms": tiers_main["library_ms"]})
    for kname, line, n in (("fwd", 116, flash_launches[0]),
                           ("dq", 374, flash_launches[1]),
                           ("dkv", 444, flash_launches[2])):
        extra = ({"beam_search_prefill_launches":
                  search_launches["beam"]["flash_fwd"],
                  "speculative_prefill_launches":
                  search_launches["speculative"]["flash_fwd"],
                  "held_on_path": held(search_held, "flash_attention")}
                 if kname == "fwd" else {})
        i = ("fwd", "dq", "dkv").index(kname)
        extra.update({
            "dp_world2_launches_per_worker": dp_launches[i],
            "dp_held_on_path": held(dp_held, "flash_attention"),
            **training_rest(i, "flash_attention"),
            **async_rows(i, "flash_attention"),
            "bert_finetune_launches": bert_launches[i],
            "bert_held_on_path": held(bert_held, "flash_attention"),
            "bert_case": {d: case(r) for d, r in flash_main["bert"].items()},
            "gpt2_train_launches": gpt2_train[i],
            "gpt2_train_held_on_path": held(gpt2_train_held,
                                            "flash_attention")})
        if kname == "fwd":
            extra.update({
                "gpt2_prefill_launches":
                    gpt2_runs["bf16"]["launches"]["flash_fwd"],
                "llama_prefill_launches": llama_run["launches"]["flash_fwd"],
                "generation_held_on_path": held(gen_held,
                                                "flash_attention")})
        kernels.append({**extra,
            "name": f"flash_attention_{kname}", "route": "cuda",
            "source": "byteps_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"byteps_tpu/ops/flash_attention.py:{line}",
            "launches": n,
            "max_abs_err": flash_main[f"{kname}_max_abs_err"],
            "ms": flash_main[f"{kname}_ms"],
            "plain_ms": flash_main[f"{kname}_plain_ms"],
            "bound_ms": flash_main[f"{kname}_bound_ms"],
            "bound_by": flash_main[f"{kname}_bound_by"],
            # SDPA's backward computes dq, dk and dv in one call
            "library_ms": flash_main["library_fwd_ms" if kname == "fwd"
                                     else "library_bwd_ms"]})
    for kname, line, n in (("fwd", 77, fce_launches[3]),
                           ("dx", 115, fce_launches[4]),
                           ("dw", 144, fce_launches[5])):
        g = fce_main["gpt2"]
        kernels.append({
            "gpt2_case": {"N_H_V": g["N_H_V"],
                          "max_abs_err": g[f"{kname}_max_abs_err"],
                          **{k: g[f"{kname}_{k}"] for k in (
                              "ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "tflops")}},
            "gpt2_train_launches": gpt2_train[3 + ("fwd", "dx", "dw").index(
                kname)],
            "dp_world2_launches_per_worker": dp_launches[
                3 + ("fwd", "dx", "dw").index(kname)],
            "dp_held_on_path": held(dp_held, "fused_linear_cross_entropy"),
            **training_rest(3 + ("fwd", "dx", "dw").index(kname),
                            "fused_linear_cross_entropy"),
            **async_rows(3 + ("fwd", "dx", "dw").index(kname),
                         "fused_linear_cross_entropy"),
            "gpt2_train_held_on_path": held(gpt2_train_held,
                                            "fused_linear_cross_entropy"),
            "name": f"fused_cross_entropy_{kname}", "route": "cuda",
            "source": "byteps_tpu_torch/csrc/fused_cross_entropy.cu",
            "replaces": f"byteps_tpu/ops/fused_cross_entropy.py:{line}",
            "launches": n, "max_abs_err": fce_main[f"{kname}_max_abs_err"],
            "ms": fce_main[f"{kname}_ms"],
            "plain_ms": fce_main[f"{kname}_plain_ms"],
            "bound_ms": fce_main[f"{kname}_bound_ms"],
            "bound_by": fce_main[f"{kname}_bound_by"],
            "library_ms": fce_main[f"{kname}_library_ms"],
            "tflops": fce_main[f"{kname}_tflops"]})
    for kname, mode, run in (("decode_attention", "bfloat16", "fp_flat_rerun"),
                             ("decode_attention_int8", "int8",
                              "int8_cache_rerun")):
        r = decode_main[mode]
        dev = r["device_pos"]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "byteps_tpu_torch/csrc/decode_attention.cu",
            "replaces": "byteps_tpu/ops/decode_attention.py:71",
            "launches": gen_launches[run]["decode"],
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            # this slice's paths: the beam search over 8 beam rows and the
            # speculative draft (bf16, int pos), the gather over an int8
            # pool (device positions)
            **({"beam_search_launches": search_launches["beam"]["decode"],
                "speculative_draft_launches":
                    search_launches["speculative"]["decode"],
                "held_on_path": held(search_held, "decode_attention"),
                "gpt2_launches": gpt2_runs["bf16"]["launches"]["decode"],
                "llama_launches": llama_run["launches"]["decode"],
                "generation_held_on_path": held(gen_held,
                                                "decode_attention"),
                "gpt2_g1_case": {k: r["gpt2_g1"][k] for k in (
                    "B_S_H_KV_D", "pos", "max_abs_err", "err", "kernel_ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "kernel_ms_clean_l2", "library_ms_clean_l2")}}
               if mode == "bfloat16" else
               {"gather_int8_launches": gather_launches["decode"],
                "held_on_path": held(gather_held, "decode_attention")}),
            # the position-vector form (the dense engine's decode tick):
            # this mode's cases in phase 16, and its launches on the dense
            # serve phase's flat run of this cache (bf16, or kv_quant int8)
            "device_pos": {
                "cases": r["device_cases"],
                "max_abs_err": r["device_max_abs_err"],
                "launches":
                    dense_launches[mode]["decode_by_design"]["device_pos"],
                **{k: dev[k] for k in (
                    "pos", "kernel_ms", "per_slot_ms", "int_all_2047_ms",
                    "library_ms", "plain_ms", "bound_ms", "bound_by",
                    "kernel_ms_clean_l2", "per_slot_ms_clean_l2",
                    "int_all_2047_ms_clean_l2", "library_ms_clean_l2")}}})
    dec, pre = quant_layers["decode"], quant_layers["prefill"]
    kernels.append({
        "name": "quant_dot", "route": "cuda",
        "source": "byteps_tpu_torch/csrc/quant_dot.cu",
        "replaces": "scripts/dot_probe.py:27",
        "launches": gen_launches["int8_weights_rerun"]["quant_dot"],
        "launches_by_design":
            gen_launches["int8_weights_rerun"]["quant_dot_by_design"],
        "gpt2_launches": gpt2_runs["int8_weights"]["launches"]["quant_dot"],
        "gpt2_launches_by_design":
            gpt2_runs["int8_weights"]["launches"]["quant_dot_by_design"],
        "gpt2_held_on_path": held(gen_held, "quant_linear"),
        "gpt2_layer": {k: quant_layers[f"gpt2_{k}"]
                       for k in ("decode", "prefill")},
        "max_abs_err": max(dec["max_abs_err"], pre["max_abs_err"]),
        "ms": dec["design_ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"], "tile_ms": dec["tile_ms"],
        "prefill_layer": {k: pre[k] for k in (
            "rows", "design_ms", "tile_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")}})
    _line({"kernels": kernels})
    _line({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
