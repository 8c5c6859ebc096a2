#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of GLIN on one NVIDIA card, end to end.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and exits non-zero without one (or without the
repository's ``src/`` beside it).

Phases (any failure raises, and the script exits non-zero):

1. the card (``nvidia-smi`` name and power limit), torch and nvcc versions;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. a 2,000,000-record ``mixed`` store (points, polylines, convex and concave
   polygons, 64-vertex rings; fp32-representable coordinates), indexed by
   ``SpatialIndex.build(gs, device="cuda")``;
4. each kernel against its plain torch version at the main path's shapes
   (1024 windows at selectivity 1e-4, budget 256, both prefilters and all
   seven fused relations; the compact kernel also on the 32 ladder windows
   at 1e-3 (the long runs) at budgets 256 and 4096, on a real first kNN
   rung's squares at budget 256 and on its fat rows at a budget of at
   least 4096, and through ``ops.refine_compact`` in slot-as-leaf mode on
   64 windows; the kNN top-k on that rung's (1024, 256) distances and on
   a wide (1024, 4096) case (the block route); the Morton encoding of
   every record; the mask of 64 windows over every slot), exact equality of every output, with
   CUDA-event times, device times from ``torch.profiler``, the least time
   the card could take, and the launches that comparison and its timing
   made; the compact and fused lines also carry what the group -> leaf ->
   slot walk read (``groups_walked``, ``leaves_walked``,
   ``meeting_leaf_slots``), ``bound_slot_ms`` (the bound of a per-slot
   pass over every run slot) and, for fused, the compact kernel's time on
   the same runs (``fused_minus_compact_ms``: the probe and exact stage);
   the intersects compact line also times the 32 longest and the 32
   shortest runs alone; the count kernel walks the same way (the snapshot's
   leaf tables, and a second line in slot-as-leaf mode on the 64 mask
   windows), its lines with the walk's counts and, for the first,
   ``bound_slot_ms``; the mask also at an awkward shape (63 windows over
   2,002,941 slots: rows of every alignment, runs past both ends); each
   top-k line carries its route (``kernels.knn.knn_plan``: a warp a row up
   to 1024 columns, else a block a row);
5. the window path through the facade: every relation with the default
   (fused kernel) plan, against the plain reference composition, the staged
   kernel path and the fp64 host path (``disjoint`` on 16 windows: a
   complement row holds nearly every live record); one fused 1024-window
   batch under ``torch.profiler`` (device busy share, top kernels, host
   ms); an
   overflow-ladder batch at selectivity 1e-3 (each batch's first 8
   windows also against the fp64 host path); ``count_candidates`` (three
   batches, one count launch each, and one under ``torch.profiler``); an
   insert + delete patched on the published snapshot (``device+delta``),
   then a forced ``device`` batch that republishes;
6. the kNN path through the facade: 1024 points (the windows' centres) at
   k = 10 and 100, the default plan (top-k and compact kernels) against the
   plain two-key sort and, on 8 points, the fp64 host kNN; then one top-k
   line per (row width, k) the drive launched, with its route, on that
   shape's inputs from one more batch;
5b. (after 6) the paper's baselines on phase 3's store as the facade holds
   it: ``RTree`` and ``QuadTree`` built over it (each build's wall and
   ``stats()`` index bytes beside GLIN's ``total_index_bytes``; phase 5's
   deleted record deleted from each), the first 16 main windows through
   each tree for ``intersects`` and ``contains`` (per-window ms beside the
   fused 1024-window batch's wall over its windows), ids equal to the
   fused batch and to the fp64 host path; ``SortedArray`` on 1 of them
   for ``contains``;
   1,024 published records deleted from each tree and inserted again (ms
   per operation), then the same windows and checks again;
5c. (after 5b) the port's examples, each ``main`` in-process on the card:
   quickstart at 100,000 ``cluster`` records, ``serve_queries --n 20000
   --batches 5 --batch-size 128``, ``distributed_glin`` at 100,000 records
   on a (4, 2) mesh (its hits also against its facade's ``device``
   batch); any of their checks fails the run;
6a. the write stream on phase 3's store: 2,048 inserts (``mixed``, seed 3,
   fp32) and 1,024 deletes of published records (numpy seed 5), a delta of
   3,072: the 1024 main windows through ``device+delta`` for the seven
   device relations (three runs each) and ``disjoint`` (on 16 windows: a
   complement row holds nearly every live record), with the delta-patch
   stage's wall; the added-set check's device ms (``torch.profiler``);
   1024 kNN points at k = 10 through ``device+delta``. Every batch equal to
   the same batch on a synchronous republish at the same epoch (a second
   facade over the same host tree; its wall split into capture, build,
   upload and payload) and, on 8 windows, to the fp64 host path; kNN ids
   and distances equal to the republished device result;
6b. the async swap: ``async_republish`` set on the index (as the server
   sets it), 1,536 more inserts past ``refresh_threshold``, 1024-window
   ``intersects`` batches streamed until the double-buffered build swaps
   in, with a delete of a record the pending snapshot holds and an insert
   landing mid-build: batches in flight, their median and largest wall
   beside the synchronous republish's, the build's start to the swap; the
   first and last in-flight batches and the first after the swap equal to
   the host path on 8 windows;
6c. serving: ``SpatialQueryServer`` with the reference launcher's settings
   (2 replicas, max_queue 2048, min_batch 8, max_batch 4096, two tenants;
   ``intersects``, ``contains``, ``dwithin:0.003`` over a pool of 65,536
   windows at 1e-4, seed 11; a write fraction of 0.02): a closed loop of
   1024 submissions with interleaved inserts and 64 ``submit_knn`` points,
   every ticket equal to ``index.query`` at the flush's epoch and the
   first 8 (and the kNN points) to the host path; then Poisson arrivals
   at 2,000 and
   16,000 offered queries/s for 8 s each (offered, submitted and served
   queries/s, shed, p50/p99/max latency from submit to result, the batch
   histogram, backend counts, publishes) and one profiled second (the
   device's busy share);
6d. the sharded backend: a second facade over the same host tree with
   ``EngineConfig(mesh=make_mesh((4, 2), ("data", "model"), [cuda:(i %
   count) for i in range(8)]), shard_min_records=1)`` (the positions per
   card and each shard's table bytes logged): the 1024 main windows for the
   seven device relations and ``disjoint`` on 16, the 32 ladder windows,
   and 1024 kNN points at k = 10 and 100, each planned ``sharded`` (wall
   ms, dispatches, escalations, merge bytes, launches) and equal to the
   primary facade's ``device`` batch (kNN ids exactly, distances within
   1e-4 relative) and to the host path on 8 windows for every relation
   and the ladder (the fp64 host walk takes ~12 s per 64 windows of an
   augmented probe at this size);
   the compact kernel with a shard's walk against its plain version on
   that shard's tables (a position of the main batch, one of the ladder),
   the k-merge's top-k against the plain sort; then 64 inserts (one in
   each of the first 64 windows) and 16 deletes (a hit of each of the
   first 16) through the sharded facade and a 1024-window ``intersects``
   batch served sharded with the delta patched on top, equal to the host
   path on 8 windows;
7. the kernel-level ``ops`` entry point: the Morton keys of every record
   against the host's, the candidate mask against the candidate counts, and
   the keys, the mask, the counts and the compaction (both in slot-as-leaf
   mode) and the fused query (64 windows over phase 3's snapshot, over its
   cached walk and over the walk derived from the packed tables) against
   the entry point's plain side (``use_kernel=False``);
8. LM serving: ``granite_3_2b`` at full width in bf16 (weights drawn on the
   card from seed 0) behind the port's ``SlotServer``: 8 slots, max_ctx
   1024, 8 requests of 512-token prompts with ``main_lm``'s generation
   lengths capped at SERVE_GEN_MAX (numpy seed 0) — prefill ms per
   request, decode ms per step,
   tokens/s, peak memory, the device busy share of a few decode steps; then
   the two attention kernels against their plain versions on q/k/v captured
   from layer 0 of a real prefill and a real decode step (the decode kernel
   also its log-sum-exp output; bf16, fp32, and a 128-slot windowed ring
   that wraps), decode against the full forward (bf16
   and fp32 weights), and the kernel path against the plain path
   (teacher-forced prefill + 32 decode steps of 2 requests); for the two
   bf16 cases also the launch (blocks, tokens per flash block, the blocks
   that share a decode row's slots), each kernel's registers, shared memory
   and spills as ptxas printed them, and the tensor-core instructions in
   the flash kernel's SASS (``cuobjdump -sass``; not measured without it);
   and the flash kernel at head dim 128 (phi4_mini_3p8b's 24 and 8 heads, a
   512-token prompt, seeded q/k/v) against its plain version and SDPA;
9. SSM serving: ``mamba2_2p7b`` at full width in bf16 (seed 0) behind the
   same ``SlotServer`` with the same traffic — prefill and decode ms,
   tokens/s, peak memory, the busy share of profiled decode steps and of a
   prefill; then the ``ssd_scan`` kernel against its plain version (y and
   the final state) on layer 0's inputs of a real prefill (with each of its
   launches' device time from ``torch.profiler``, and beside the bound on
   the tensor cores the CUDA cores' ``bound_fp32_ms``) and on synthetic
   ones (dt in [0.001, 0.1], a in [-1, -0.1]: slow decay, so a wrong carry
   across tiles shows), bf16 and fp32; 128 decode steps after a 384-token
   prefill against one 512-token forward, and the kernel path against the
   plain path (prefill + 32 decode steps of 2 requests), each in fp32 and
   in bf16 (the bf16 paths held against the fp32 weights' result; decode
   against the forward also in the first 8 layers);
10. hybrid serving: ``hymba_1p5b`` at full width in bf16 (seed 0; 32
   layers of 25 query heads over 5 kv heads of 64 beside 50 SSM heads of
   64 with a state of 16, a 1,024-token window, 128 meta tokens) behind the
   same ``SlotServer``: 8 slots, max_ctx 1024, 10 requests of 512-token
   prompts (two admitted into reused slots) — prefill and decode ms,
   tokens/s, peak memory, the busy share
   of profiled decode steps; then the three kernels against their plain
   versions on layer 0's inputs of a real prefill (640 positions) and
   decode step, and of a prefill of two 1,024-token prompts (the window
   slides) and its decode step (the ring wraps), bf16 and fp32, with
   times, bounds and SDPA for the bf16 cases; 128 decode steps after a
   384-token prefill against one 512-token forward, and the kernel path
   against the plain path (prefill + 16 decode steps of 2 requests), in
   fp32 at ``LM_FP32_TOL`` and in bf16 as phase 9's (decode against the
   forward also in the first 8 layers);
11. MoE serving: ``mixtral_8x22b`` (8 experts, top-2, a 4,096 window) and
   ``qwen3_moe_235b`` (128 experts, top-8, QK-norm) at published widths
   with every expert, cut to their first 8 layers (a full-depth model does
   not fit the card), bf16, seed 0, one after the other behind the same
   ``SlotServer`` (8 slots, max_ctx 1024, 8 requests of 512-token
   prompts): prefill and decode ms, tokens/s, weight, cache and peak
   bytes, the MoE drop counters (``models.moe.stats``), the busy share of
   profiled decode steps; the two attention kernels against their plain
   versions on layer 0's inputs of a real prefill and decode step (and
   for mixtral of a 4,608-token prefill, where the window binds, and its
   decode step on the wrapped 4,096-slot ring), bf16 and fp32, with times,
   bounds and SDPA; layer 0's MoE FFN on the real prefill's input against
   an fp32 oracle of the same capacity rule (:func:`moe_layer_check`);
   decode against the forward (384 + 128 against 512, in the layers before
   the first that drops a replica; where one drops, also 64 + 64 against
   128 at full depth, where no replica can drop) and the kernel path
   against the plain path, in fp32 in the first 2 layers and in bf16 by
   phase 9's drift rule (the fp32 counterparts of 8 layers upcast a layer
   at a time), every run's drops and the share of routes on which the
   bf16 kernel and plain paths differ logged;
12. the stub frontends: ``qwen2_vl_2b`` (M-RoPE; its prompts' first 256
   embeddings on a 16 x 16 patch grid) and ``musicgen_medium`` at full
   width, their first 12 layers (STUB_LAYERS), bf16, seed 0, through
   ``prefill`` / ``decode_step``
   with seeded embeddings (8 rows of 512, then 128 decode steps): prefill
   and decode ms, tokens/s, peak bytes, the busy share; the two attention
   kernels against their plain versions at their shapes with times,
   bounds and SDPA; decode against the forward and the kernel path
   against the plain path, fp32 and bf16 at those layers;
13. training on the card (``train_phase``), bf16 unless stated:
   a. ``granite_3_2b`` at full width and depth (2.53 B parameters, seed 0)
      on ``SyntheticLM(vocab, 4096, 2, seed 0)`` through the launcher's
      ``Prefetcher``, 12 steps of ``train_step`` (remat on, the launcher's
      AdamW: lr 3e-4, 2 warm-up steps): each step's loss, grad_norm, lr
      and ms (AdamW apart), tokens/s (of the median step, of the summed
      steady steps, of the run's wall), the bytes of parameters, gradients
      and AdamW state, the peak, one profiled step's busy share and top
      kernels, the leaves and elements whose bits no step changed;
      finite losses and norms, the last loss below the first, every leaf
      that was not a constant at init moved, ``flash_attention``
      launched twice a layer a step (the forward and the remat recompute)
      and the plain version only in the backward's query chunks;
   b. the same model cut to its first 2 layers: the loss and every
      gradient leaf through the kernels against the plain path (the plain
      versions swapped in), fp32 gated (the loss within 1e-5 relative,
      each leaf within 1e-3 of its largest plain gradient), bf16 logged;
      B7's Function alone on layer 0's captured bf16 q, k, v (forward,
      backward, both, the plain version, SDPA forward + backward);
   c. one AdamW step of the fp32 2-layer model by those gradients on the
      card against the same on the CPU (mu, nu, parameters and grad_norm
      within 1e-6 relative, lr equal);
   d. ``save_async`` + ``wait_all`` of the bf16 2-layer model and its
      AdamW state and ``restore`` onto the card with equal bits; the
      launcher as a subprocess (``--reduced``, 12 steps, a checkpoint every
      4): a crash at step 7 exits 42, ``--resume`` ends with LATEST at 12;
   e. ``mamba2_2p7b`` at full width, its first 8 layers, 4 steps
      (``ssd_scan`` twice a layer a step, finite losses); B9's forward
      and backward on layer 0's captured inputs of a 2-layer bf16 run; the
      2-layer gradient check through the kernel against the plain path,
      bf16 logged, fp32 gated as in b; then the host time of one call
      of each autograd Function (B7, B9, the head) with no gradient
      wanted, beside its launch alone;
14. the sharded trainer (``sharded_train_phase``) on meshes whose
   positions all sit on the card (``make_test_mesh(devices=["cuda:0"] *
   n)``):
   a. ``granite_3_2b`` at full width and depth, bf16, seed 0, on a (4, 2)
      ``("data", "model")`` mesh: ``build_train_step`` (FSDP + TP,
      microbatches 1, remat on, the launcher's AdamW) for 3 steps on
      ``SyntheticLM(vocab, 4096, 4, seed 0)`` (one sequence a data row):
      a warm-up step, one timed step (step ms and tokens/s are its), the
      last under ``torch.profiler``; each step's loss,
      grad_norm, lr, ms and AdamW ms, the peak, the busy share, the bytes
      each position holds; the first loss within 1e-2 of the single-device
      ``loss_fn`` on the same parameters and batch, finite losses, every
      non-constant leaf moved, ``flash_attention`` launched 8 positions x
      40 layers x 2 (forward, remat recompute) a step and nothing else;
   b. fp32, the first 2 layers: granite_3_2b at 4 x 4,096 (its vocab
      whole) and phi4_mini_3p8b at 4 x 1,024 (its vocab split over
      ``model``): the sharded loss and every gathered gradient leaf, then
      the step's loss, grad_norm, lr and parameters, against the
      single-device ``value_and_grad`` and ``train_step`` (loss, grad_norm
      and lr within 1e-5 relative, each gradient leaf within 3e-5 of its
      largest magnitude, parameters within 2 lr everywhere and 1e-6 on all
      but 0.1% of elements), with each leaf's spread beside it when the
      single-device path takes its batch in two halves;
   e. (after b) ``ckpt.save`` of b's granite state from the mesh,
      ``restore`` onto the card and back onto the mesh: the step and
      every bit;
   c. ``gpipe`` over a (4,) ``("pod",)`` mesh: granite_3_2b's 40 bf16
      layers as 4 stages of 10, 8 microbatches of 1 x 512 tokens, equal
      bits to the layers run in sequence; ``bubble_fraction(4, 8)``;
   d. ``compressed_psum_mean`` of 8 seeded fp32 blocks of 2,048 x 8,192
      (a granite layer's ``wu``) over an ``("data",)`` mesh of 8: equal
      bits to the CPU's, within 2 max|g| / 127 of the exact mean; 20
      steps of ``apply_error_feedback`` on a constant gradient, drift
      under 2e-3;
15. the sharded families and serving steps (``families_phase``) on the
   (4, 2) mesh of the card, bf16 and seed 0 unless stated:
   a. ``mamba2_2p7b`` at full width, its first 8 of 64 layers, and
   b. ``hymba_1p5b`` at full width, its first 8 of 32 layers
      (FAM_TRAIN_LAYERS; ``None`` runs the full depth), each through
      ``build_train_step`` (microbatches 1, remat on, the launcher's
      AdamW) for 3 steps on ``SyntheticLM(vocab, 4096, 4, seed 0)``: a
      warm-up, one timed, the last profiled; step ms,
      tokens/s, peak bytes, the busy share, B9's (and B7's) launches
      against 8 positions x layers x 2 (forward, remat recompute) a step;
   c. ``mixtral_8x22b`` (4 x 4,096 tokens) and ``qwen3_moe_235b`` (4 x
      2,048) at published widths with every expert, one layer each, the
      same steps: also the replicas dropped, the largest expert load
      (global counters) and the bytes the two ``all_to_all`` s hand over a
      layer;
   d. the sharded prefill and 8 teacher-forced decode steps
      (``build_prefill_step`` / ``build_decode_step``) against one
      device's ``prefill`` / ``decode_step`` on the same weights:
      ``granite_3_2b`` at full depth (a 4 x 4,096 prompt into a
      32,768-slot cache, 16,384 slots a position), ``hymba_1p5b`` at 8
      layers (1,024 tokens after the 128 meta tokens: the 1,024-slot ring
      wraps) and ``mixtral_8x22b`` at 2 layers (a 6,136-token prompt: the
      4,096-slot ring wraps, and the written slot crosses from the first
      position's slots to the second's in the eighth step); prefill and
      decode ms, B8 a position a layer a step; granite's logits within
      LM_BF16_REL of one device's largest at every step, its gathered
      caches within it of each leaf's largest (integer leaves equal);
      hymba's and mixtral's held by phase 9's rule instead (within
      SSM_BF16_DRIFT_RATIO times one device's bf16 distance from its
      fp32-upcast run; a mixtral token that a bf16 near tie routes
      differently on the two paths leaves its row's logits and its ring
      slots out, counted); B8 on position (0, 0)'s inputs against its
      plain version and SDPA (its slot range, with the log-sum-exp), and
      the merge's time;
   e. fp32, the first 2 layers, 4 x 1,024 tokens: ``mamba2_2p7b``,
      ``hymba_1p5b``, ``mixtral_8x22b`` and ``qwen3_moe_235b``: the sharded
      loss and every gathered gradient leaf against the single-device
      ``value_and_grad`` (the loss within 1e-5 relative, each leaf within
      3e-5 of its largest, hymba's 2e-4: FAM_EXACT_REL), the MoE drop
      counts equal, and a 512-token prefill with 8 decode steps against
      one device at the same bound;
16. sequence sharding and the production meshes' refused cells
   (``seq_phase``), bf16 and seed 0 unless stated:
   a. ``granite_3_2b`` at full width and depth on 14a's (4, 2) mesh with
      ``MeshRules(seq_sharding=True)``, 4 x 4,096 tokens, 3 steps of
      ``build_train_step`` (a warm-up, one timed, the last profiled):
      step ms, tokens/s, peak bytes and the busy share beside 14a's, the
      bytes remat keeps of a layer (the block input, laid out ``("data",
      "model")``: each position's rows); finite losses; B7 launched 8
      positions x 40 layers x 2 a step and nothing else; B7 at a
      position's shape;
   b. (first, on the same seed-0 weights) granite's seq-sharded prefill of
      15d's 4 x 4,096 tokens into 32,768 slots and 2 decode steps against
      15d's sharded run without ``seq`` on the same placed weights: each
      step's logits and the gathered caches within LM_BF16_REL of the
      largest; B7 8 x 40 in the prefill, B8 8 x 40 a decode step;
   c. fp32, 2 layers, 4 x 1,024 tokens: ``granite_3_2b`` and
      ``hymba_1p5b`` (its 128 meta rows and 1,024 rows split over 2)
      seq-sharded against one device (15e's gates: the loss within 1e-5
      relative, each gradient leaf within 3e-5 of its largest, hymba's
      2e-4), B7 (and B9) launched 8 x 2 x 2, B9 at a position's shape;
   d. the production meshes' refused cells at reduced depth:
      ``qwen2_vl_2b`` (12 query heads) at full width, 4 layers, on a
      (1, 16) ``("data", "model")`` mesh: the sharded prefill of 1 x 2,048
      embeddings and 4 decode steps against one device at LM_BF16_REL, B7
      on the 12 positions that hold a head (the other 4 launch none), B8
      on all 16, each at a position's shape against its plain version;
      15e's fp32 ``qwen3_moe_235b`` check on a (2, 2, 2) ``("pod", "data",
      "model")`` mesh (experts over ``data``, capacity slots over
      ``pod``), with 15e's gates, its logging of routing ties and its
      launch counts;
17. the dry run and PF3 (``dryrun_phase``):
   a. PF3's ring laid out by kv heads: ``granite_3_2b`` reduced (4 query
      and 4 kv heads of 16, 2 layers) on the (4, 2) mesh of the card,
      8 x 1,024 tokens into 1,025 slots (they do not split over 2 ``model``
      positions, the kv heads do) and 4 decode steps (the last wraps the
      ring), against one device: fp32 within SHARD_REL of its largest, bf16
      within LM_BF16_REL beside the same run on 1,024 slots split by slots
      (prefill and decode ms); B8 launched 8 positions x 2 layers a step,
      each on its 2 query heads over its 2 kv heads and every slot, and no
      merge; B8 at position (0, 0)'s bf16 shape against its plain version
      and SDPA; then ``granite_3_2b`` at full width (32 query heads over 8
      kv heads of 64, a GQA group of 4), cut to 2 layers, fp32: 8 x 1,024
      tokens into 4,097 slots and 4 decode steps within SHARD_REL of one
      device, B8 on each position's 16 query heads over its 4 kv heads
      (no merge), and held at position (0, 0)'s (2, 16, 64) over
      (2, 4, 4,097, 64) against its plain version, in fp32 and (timed,
      beside SDPA) on the same inputs in bf16;
   b. the dry run's memory reckoning (``launch.dryrun.reckon``, all 8
      positions on one device) of 14a's, 15a's and 16a's cells beside the
      peak each measured in this run, within DRY_MEMORY_REL;
   c. ``python -m repro_torch.launch.dryrun --arch granite_3_2b --shape
      train_4k --mesh single``: its exit code, record and ``reckon_s``;
   b's reckoning and c run in subprocesses with no card, started before
   phase 16 so that they run beside 16 and a;
18. one ``{"kernels": [...]}`` line (the three LM kernels' entries carry
   their hymba numbers under ``hymba``, the attention kernels' also each
   phase 11 and 12 model's under its name, B7's and B9's their training
   numbers under ``training``, B7's phase 14a's under
   ``sharded_training``, B7's, B8's and B9's phase 15 launches under
   ``sharded_families``, with B8's position-local line, and their phase
   16 launches under ``seq_sharded`` (16a-16c) and ``pf2`` (16d), with
   their lines at those shapes, and B7's and B8's 17a launches under
   ``pf3``, with B8's position-local lines, reduced and full width), and
   last the ``{"ok": true,
   ...}`` line.

Launch counters are zeroed just before each of phases 5, 6, 5b, 5c, 6a, 6b,
6c, 6d (its two paths), 7, 8's, 9's, 10's and 11's serving runs, 12's runs,
13's two training runs, 14a's sharded run, each run of 15a-15d (15d's
prefill apart from its decode steps), each of 16a-16d's sharded runs and
each of 17a's, and read just after (6a's,
6c's and 6d's before the comparisons that check them): every kernel of
that path must have launched, and a kernel's ``launches`` in the last line
is its count from its path, summed over phases 5-6d for
``refine_compact``, ``refine_fused`` and ``knn_topk`` and over phases 8-12
for ``flash_attention``, ``decode_attention`` and ``ssd_scan`` (the
training runs' under ``training``, 14a's under ``sharded_training``). Each phase's start is logged with the seconds
since the script started (``{"phase": ..., "t_s": ...}``).
"""
import collections
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path
from typing import NamedTuple, Optional

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"            # every index and tensor of the drive lives here
N_RECORDS = 2_000_000
N_WINDOWS = 1024
SELECTIVITY = 1e-4         # the main batch: ~200 records per window
LADDER_SELECTIVITY = 1e-3  # ~2000 per window: past the budget, up the ladder
BUDGET = 256
HOST_CHECK = 8             # windows held against the fp64 host path
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
FP32_OPS_PER_S = 67e12     # H100 SXM fp32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12    # H100 SXM bf16 tensor-core rate (dense)
FUSED_RELATIONS = ("intersects", "contains", "covers", "within", "touches",
                   "crosses", "dwithin:0.0005")
FACADE_RELATIONS = FUSED_RELATIONS + ("disjoint",)
KNN_KS = (10, 100)
KNN_TOPK_WIDE = (4096, 100)  # (B, k) of the synthetic top-k case
MASK_WINDOWS = 64            # the (Q, N) int8 mask: 2 MB per window
LM_ARCH = "granite_3_2b"
FLASH_D128_ARCH = "phi4_mini_3p8b"   # the flash kernel at head dim 128
LM_SLOTS, LM_CTX, LM_REQUESTS, LM_PROMPT = 8, 1024, 8, 512
# the serving runs' generation lengths (phases 8-11): main_lm draws each
# from [8, max_ctx - prompt); capped here, so a run is at most 127 decode
# steps (uncapped, the five runs took 111 s of the script on an H100)
SERVE_GEN_MAX = 128
LM_WINDOW = 128              # the windowed case: a 128-slot ring that wraps
LM_FORWARD_STEPS = 8         # decode steps held against the full forward
LM_TEACHER_STEPS = 32        # kernel path vs plain path, teacher-forced
LM_FP32_STEPS = 2            # the same two checks with fp32 weights
# attention kernel vs plain version (as the reference's kernel tests): the
# kernels sum in another order (online softmax over key tiles)
ATT_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# ... and never below one bf16 step of the plain output where it is bf16:
# from a magnitude of 4 that step (2^-5) passes 3e-2, and two results that
# agree to a few fp32 ulps still round to neighbouring bf16 values wherever
# a rounding midpoint lies between them (the phases' real activations reach
# it where a token attends to few keys; :func:`att_bound`)
BF16_MANTISSA_BITS = 7
# logits of two paths through the 40-layer bf16 model: activations are
# rounded to bf16 (2^-8 relative) at every layer, and a rounding flip in one
# path spreads; the bound is a share of the logits' range. fp32 weights:
# summation order only.
LM_BF16_REL = 0.1
LM_FP32_TOL = (2e-3, 1e-3)   # atol, rtol
SSM_ARCH = "mamba2_2p7b"
SSM_SLOTS, SSM_CTX, SSM_REQUESTS, SSM_PROMPT = 8, 1024, 8, 512
SSM_FORWARD_PROMPT = 384     # + 128 decode steps against one 512 forward
SSM_TEACHER_STEPS = 32       # kernel path vs plain path, teacher-forced
# bf16 logits of two paths through mamba2_2p7b: every layer rounds to bf16
# and the paths' difference grows with depth (~1% of the logits' range at
# 2 layers, ~2% at 4, in the reference as in the port, from the same
# weights: tests/test_torch_ssm_drift.py). Each path is held to its
# counterpart within SSM_BF16_DRIFT_RATIO times how far the counterpart's
# bf16 run strays from its fp32 run (two paths each no further from fp32
# than that lie within twice it: the reference's own pairs stay within
# 1.21x at full width, 2 to 16 layers), at every depth of SSM_DEPTHS and
# the full 64; at SSM_REL_DEPTH layers also within phase 8's LM_BF16_REL of
# the range.
SSM_BF16_DRIFT_RATIO = 2.0
SSM_DEPTHS = (8,)            # first layers of the same weights, + all 64
SSM_REL_DEPTH = 8
# ssd_scan vs its plain version: the kernel tiles 64 steps where the plain
# version takes chunk 128, so fp32 differs by summation order — the
# reference's chunk-invariance tolerance (atol, rtol), its relative part
# taken of the magnitude of the terms each output sums (ssd of |x|, dt, a,
# |b|, |c|: summation error grows with them, and on real inputs y's terms
# reach ~1e3 and cancel); a bf16 y is two roundings of such values, one
# bf16 step (2^-7 of |y|) more
SSD_TOL = (2e-4, 1e-3)
SSD_BF16_STEP = 2.0 ** -7
# phases 6a-6c: the write stream, the async swap, serving (on phase 3's store)
WRITE_INSERTS, WRITE_DELETES = 2048, 1024   # a delta of 3072 < 4096
ASYNC_INSERTS = 1536                         # the delta past refresh_threshold
# 6a's disjoint windows: a complement row holds nearly every live record
# (~2M ids), and 6a runs each row three ways (patched, republished,
# host) besides phase 5's 64; 16 keep that to seconds (and fewer than
# the planner's device_min_batch of 16 would take the host path)
DISJOINT_WINDOWS = 16
SERVE_POOL = 65_536       # windows at SELECTIVITY: the cache seldom hits
SERVE_RELATIONS = ("intersects", "contains", "dwithin:0.003")
SERVE_CLOSED = 1024       # closed-loop submissions
SERVE_KNN = 64            # closed-loop kNN points (k = 10)
SERVE_RATES = (2_000.0, 16_000.0)   # offered queries/s, Poisson arrivals
SERVE_SECONDS = 4.0       # each rate's open-loop run
SERVE_WRITE_FRAC = 0.02   # the launcher's: an 8-vertex ring, radius 2e-4
# phase 6d: the sharded backend
SHARD_MESH = (4, 2)       # (data, model): 4 record shards, 2 query columns
SHARD_INSERTS = 64        # the delta patched on top of the sharded batch
SHARD_DELETES = 16
# phase 5b: the paper's baselines on phase 3's store
BASE_WINDOWS = 16           # of the main windows, through each tree
BASE_SORTED_WINDOWS = 1     # SortedArray refines its whole augmented run
BASE_SORTED_RELATIONS = ("contains",)  # intersects: 33.9 s a window (s25-j)
BASE_RELATIONS = ("intersects", "contains")
BASE_MAINTAIN = 1024        # published records deleted and inserted again
# phase 5c: the port's examples at the verify skill's sizes
EXAMPLES_ARGS = {"quickstart": ["--n", "100000"],
                 "serve_queries": ["--n", "20000", "--batches", "5",
                                   "--batch-size", "128"],
                 "distributed_glin": ["--n", "100000"]}
# phase 10: hybrid serving (hymba_1p5b), 10 requests in 8 slots: the last
# two are admitted into slots freed while the others still decode, so both
# caches (the windowed KV ring and the SSM state) are written into a reused
# slot
HYBRID_ARCH = "hymba_1p5b"
HYBRID_SLOTS, HYBRID_CTX, HYBRID_REQUESTS, HYBRID_PROMPT = 8, 1024, 10, 512
# decode against the forward: a prefill of 384 tokens (512 positions with
# the meta tokens), then the prompt's last 128 one decode step at a time,
# against one forward over the 512 (the SSD scan takes multiples of its
# 128-step chunk, as the reference's)
HYBRID_FORWARD_PROMPT = 384
HYBRID_TEACHER_STEPS = 16    # kernel path vs plain path, teacher-forced
# the bf16 checks take phase 9's drift rule at 8 and all 32 layers,
# not its share of the range: at full width in 8 layers the reference's
# own decode path strays 12% of the logits' range from its forward, the
# port's 15% (a CPU run of tests/test_torch_hybrid.py as a script)
HYBRID_DEPTHS = (8,)
# phase 11: MoE serving at the published widths with every expert, cut to
# the first 8 layers (of 56 and 94: a full-depth model does not fit one
# 80 GB card); every layer is attention + the MoE FFN, so 8 layers hold
# every kind of layer the model has
MOE_ARCHS = ("mixtral_8x22b", "qwen3_moe_235b")
MOE_LAYERS = 8
MOE_SLOTS, MOE_CTX, MOE_REQUESTS, MOE_PROMPT = 8, 1024, 8, 512
MOE_FORWARD_PROMPT = 384     # + 128 decode steps against one 512 forward
# a forward that drops replicas differs from decode steps (which never
# drop): the decode-against-forward check then runs in the layers before the
# first that drops, and also over the prompt's first 128 tokens at full
# depth (64 + 64 decode steps), where the capacity floor of 128 slots holds
# every replica
MOE_SHORT_PROMPT = 128
MOE_TEACHER_STEPS = 16       # kernel path vs plain path, teacher-forced
MOE_FP32_LAYERS = 2          # the 8 layers in fp32 would need ~82 GB
# bf16 decode against the forward also in the first 2 layers: at 8 the
# bf16 model's expert choices part from the fp32 model's on a rounding and
# its logits from fp32 by most of their range (mixtral on the card), so the
# drift rule bounds little there
MOE_DEPTHS = (2,)
MOE_WINDOW_PROMPT = 4608     # mixtral: a prompt past its 4,096 window
# the MoE layer against its fp32 oracle (same routing, fp32 expert FFNs of
# the same bf16 weights and input): the port multiplies in bf16 with fp32
# accumulation and rounds to bf16 three times (the expert products, the
# gated SiLU, the expert output; then the gated sum), each 2^-9 relative;
# 2% of the output's largest magnitude is ~5 bf16 steps there, and a
# replica routed to a wrong expert, a wrong gate or a lost row is O(1)
MOE_ORACLE_REL = 0.02
# phase 12: the stub-frontend models at full width, their first
# STUB_LAYERS layers (of 28 and 48), through prefill / decode_step with
# embeddings (the slot server takes tokens only)
STUB_ARCHS = ("qwen2_vl_2b", "musicgen_medium")
STUB_LAYERS = 12
STUB_ROWS, STUB_PROMPT, STUB_STEPS = 8, 512, 128
STUB_GRID = 16               # qwen2_vl: a 16 x 16 patch grid of M-RoPE
STUB_FORWARD_PROMPT = 384
STUB_TEACHER_STEPS = 16
TRAIN_ARCH = "granite_3_2b"
# the reference's train_4k sequence (configs/base.py), at a batch one card
# holds with the weights, gradients and AdamW state of 2.5 B parameters
TRAIN_SEQ, TRAIN_BATCH = 4096, 2
TRAIN_STEPS, TRAIN_LR = 12, 3e-4     # the launcher's AdamW for 12 steps
TRAIN_PROFILE_STEP = 10              # the step under torch.profiler
TRAIN_CHECK_LAYERS = 2               # 13b-13d: the first 2 layers
TRAIN_LOSS_REL = 1e-5                # kernel path vs plain path, fp32:
TRAIN_GRAD_REL = 1e-3                # of each leaf's largest plain gradient
TRAIN_ADAMW_REL = 1e-6               # the card's AdamW step vs the CPU's
TRAIN_SSM_ARCH = "mamba2_2p7b"
TRAIN_SSM_LAYERS, TRAIN_SSM_STEPS = 8, 4
TRAIN_LAUNCH_ARGS = ["--arch", "granite_3_2b", "--reduced", "--steps", "12",
                     "--ckpt-every", "4"]
TRAIN_CRASH_AT = 7
# phase 14: the sharded train step on a (4, 2) ("data", "model") mesh whose
# eight positions all sit on the card
SHARD_TRAIN_MESH = (4, 2)
SHARD_TRAIN_BATCH = 4                # one train_4k sequence a data row
SHARD_TRAIN_STEPS = 3                # step 0 warms up, 1 is timed,
SHARD_TRAIN_TIMED = (1,)             # the last runs under torch.profiler
SHARD_TRAIN_PROFILE_STEP = SHARD_TRAIN_STEPS - 1
SHARD_LOSS_ABS = 1e-2                # 14a: bf16 sharded vs one device
# 14b: fp32, 2 layers, against the single-device step: (arch, sequence)
SHARD_EXACT = (("granite_3_2b", 4096), ("phi4_mini_3p8b", 1024))
SHARD_REL = 1e-5                     # loss, grad_norm, lr
# each gradient leaf, of its largest magnitude: fp32 sums over 16,384
# tokens put the sharded leaves up to 1.40e-5 from one device's, and one
# device up to 1.42e-5 from itself with its batch in two halves (H100,
# PERF.md's PR 24 entry); the bound is twice that, for every leaf
SHARD_GRAD_REL = 3e-5
SHARD_PARAM_TIGHT = 1e-6             # parameters within 2 lr everywhere,
SHARD_PARAM_LOOSE_SHARE = 1e-3       # within 1e-6 but on 0.1%
PIPE_STAGES, PIPE_MICRO, PIPE_TOKENS = 4, 8, 512     # 14c
COMPRESS_BLOCK, COMPRESS_STEPS = (2048, 8192), 20    # 14d
FAM_BATCH = 4                        # 15: one sequence a data row
FAM_TRAIN = ("mamba2_2p7b", "hymba_1p5b")            # 15a, 15b
FAM_TRAIN_LAYERS = 8     # of 64 and 32: at full depth 15a and 15b took
#                          87 and 67 s of the script's time (s25-b)
FAM_MOE = (("mixtral_8x22b", 4096), ("qwen3_moe_235b", 2048))  # 15c: 1 layer
FAM_STEPS, FAM_TIMED = 3, (1,)       # a warm-up, one timed, the last profiled
# 15d: (arch, layers (None: all), prompt, cache slots); mixtral's prompt
# puts the decode's written slot (pos % 4096) across the two positions'
# boundary at 2,048 in its eighth step
FAM_SERVE = (("granite_3_2b", None, 4096, 32768),
             ("hymba_1p5b", 8, 1024, 1168), ("mixtral_8x22b", 2, 6136, 6152))
FAM_SERVE_STEPS = 8      # 16 took 12 s of granite's decode (s25-b)
FAM_EXACT = ("mamba2_2p7b", "hymba_1p5b", "mixtral_8x22b", "qwen3_moe_235b")
FAM_EXACT_LAYERS, FAM_EXACT_SEQ = 2, 1024                        # 15e
FAM_EXACT_PROMPT, FAM_EXACT_STEPS = 512, 8
# 15e's bound on each gradient leaf, the logits and the caches, as a share
# of the largest: 14b's SHARD_GRAD_REL, but for hymba_1p5b, whose fp32
# gradient differs from itself by up to 8.39e-5 of a leaf's largest when
# one device takes its batch in two halves (``embed``; the sharded step's
# worst leaf 7.86e-5, s25-d): about twice that (mamba2_2p7b's halves reach
# 1.88e-5, inside 3e-5)
FAM_EXACT_REL = {"hymba_1p5b": 2e-4}
# a token whose top-k experts differ between 15e's two fp32 paths in the
# first layer where any does must sit at a tie on one device: its k-th and
# next expert's probabilities within this (the paths' router inputs differ
# by fp32 roundings there, ~1e-7 of them; s25-h: qwen3's one such token,
# 3.54e-8; the later layers' differences follow from it)
FAM_NEAR_TIE = 1e-5
# phase 16: sequence sharding (MeshRules(seq_sharding=True)) and the
# production meshes' refused cells (PF2), on meshes of the card
SEQ_TRAIN_STEPS = 3                  # 16a: a warm-up, one timed, the last
SEQ_TRAIN_TIMED = (1,)               # profiled
SEQ_SERVE_STEPS = 2                  # 16b: decode steps after the prefill
SEQ_EXACT = ("granite_3_2b", "hymba_1p5b")                       # 16c
# 16d: qwen2_vl_2b's 12 query heads over a (1, 16) mesh's 16 model
# positions: (arch, layers, prompt rows, decode steps, cache slots; 16
# divides the slots, so the ring splits its slots as on the production
# mesh)
PF2_VL = ("qwen2_vl_2b", 4, 2048, 4, 2064)
PF2_VL_MESH = (1, 16)
# ... and 15e's qwen3_moe_235b on a pod mesh: the experts over data, the
# capacity slots over pod
PF2_POD_MESH, PF2_POD_AXES = (2, 2, 2), ("pod", "data", "model")
# 17a: a ring laid out by kv heads (PF3): granite_3_2b reduced (4 heads and
# 4 kv heads of 16, 2 layers), fp32 and bf16, on the (4, 2) mesh, (arch, batch,
# prompt, cache slots, decode steps); 1,025 slots do not split over 2
# model positions and the 4 kv heads do, so the rules lay the ring out by
# heads; the fourth step writes slot 0 (the ring wraps). Beside it the
# same run into 1,024 slots, which split by slots.
PF3 = ("granite_3_2b", 8, 1024, 1025, 4)
PF3_SPLIT_SLOTS = 1024
# ... and granite_3_2b at full width (32 query heads over 8 kv heads of 64:
# a GQA group of 4), cut to 2 layers, fp32: (layers, prompt, cache slots);
# 4,097 slots do not split over 2 model positions, so each position holds
# 4 kv heads over every slot and runs its 16 query heads over them
PF3_FULL = (2, 1024, 4097)
# 17b: the dry run's memory reckoning of 14a's, 15a's and 16a's cells on
# the (4, 2) mesh of the card (all 8 positions on one device), within
# DRY_MEMORY_REL of the peak each phase measured in this run
DRY_MEMORY_REL = 0.25
# 17c: one production cell through the dry run's command line
DRY_CLI = ["--arch", "granite_3_2b", "--shape", "train_4k", "--mesh",
           "single"]
_CU = "src/repro_torch/kernels/csrc/"
CSRC = {"refine_count": _CU + "refine.cu", "refine_compact": _CU + "refine.cu",
        "refine_fused": _CU + "refine.cu", "knn_topk": _CU + "knn.cu",
        "morton_encode": _CU + "morton.cu", "refine_mask": _CU + "refine.cu",
        "flash_attention": _CU + "flash_attention.cu",
        "decode_attention": _CU + "decode_attention.cu",
        "ssd_scan": _CU + "ssd_scan.cu"}
REPLACES = {"refine_count": "src/repro/kernels/refine.py:391",
            "refine_compact": "src/repro/kernels/refine.py:415",
            "refine_fused": "src/repro/kernels/refine.py:466",
            "knn_topk": "src/repro/kernels/refine.py:592",
            "morton_encode": "src/repro/kernels/morton.py:40",
            "refine_mask": "src/repro/kernels/refine.py:368",
            "flash_attention": "src/repro/kernels/flash_attention.py:79",
            "decode_attention": "src/repro/kernels/decode_attention.py:64",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:64"}


T0 = time.perf_counter()


def log(obj):
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def mark(phase: str) -> None:
    """A phase starts: its name and the seconds since the script started."""
    log({"phase": phase, "t_s": time.perf_counter() - T0})


def card_line() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi: not found"
    r = subprocess.run([smi, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else (
        f"nvidia-smi failed: {r.stderr.strip()}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def profiled(fn, reps: int = 1, counts: dict | None = None):
    """Run ``fn`` ``reps`` times under ``torch.profiler`` -> (host wall ms
    per run, {kernel name: device ms per run}, device kernels per run); the
    dict is empty when the profiler sees no device activity (device time
    then goes unmeasured). ``counts``, when given, gets each kernel's
    recorded launches per run: late in a long process the profiler records
    only some of the launches (each with its right duration), so device
    ms per run and busy shares are then lower bounds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    dev, seen = {}, collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev[e.name] = dev.get(e.name, 0.0) + e.device_time_total / 1e3 / reps
            seen[e.name] += 1
    if counts is not None:
        counts.update({k: n / reps for k, n in seen.items()})
    return wall, dev, sum(seen.values()) / reps


def per_launch(dev: dict, seen: dict) -> dict:
    """{kernel: device ms per run} for kernels launched once a run: those
    the profiler recorded at most once a run take the mean of the launches
    it recorded; the others keep their per-run sum."""
    return {k: t / seen[k] if seen[k] <= 1 else t for k, t in dev.items()}


def device_ms(fn, kernel: str, reps: int = 10):
    """Device time per call of the kernels whose name holds ``kernel`` (the
    event timing of a small kernel also holds the wrapper's host work,
    since the card waits for the launch), by :func:`per_launch`; None when
    the profiler recorded none."""
    seen = {}
    _, dev, _ = profiled(fn, reps, seen)
    ms = [t for name, t in per_launch(dev, seen).items() if kernel in name]
    return sum(ms) if ms else None


def fp32_exact(gs) -> None:
    """Snap the CSR pool to fp32-representable coordinates in place and
    recompute every record MBR from its ring (the fp64 host path and the
    fp32 device path then decide the same configurations) — without the
    dense (N, maxV, 2) view, which would not fit comfortably at this size."""
    import numpy as np

    off, nv = gs.offsets, gs.nverts.astype(np.int64)
    if not (np.all(off[1:] == off[:-1] + nv[:-1])
            and off[-1] + nv[-1] == gs.pool.shape[0]):
        raise RuntimeError("pool rings are not contiguous")
    pool = gs.pool
    pool[:] = pool.astype(np.float32).astype(np.float64)
    gs.mbrs = np.concatenate([np.minimum.reduceat(pool, off, axis=0),
                              np.maximum.reduceat(pool, off, axis=0)], 1)


def compare(name, got, want) -> dict:
    """Exact equality of integer outputs: mismatching elements and the
    largest absolute difference."""
    import torch

    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if isinstance(want, torch.Tensor) else list(want)
    mism, err = 0, 0
    for g, w in zip(got, want):
        mism += int((g != w).sum())
        err = max(err, int((g.long() - w.long()).abs().max()))
    if mism:
        raise RuntimeError(f"{name}: {mism} elements differ from the plain "
                           f"version (max abs err {err})")
    return {"mismatches": mism, "max_abs_err": err}


def covered_slots(bounds, n: int) -> int:
    """Slots inside at least one query's run: overlapping runs read the same
    rows, and the bound counts each input byte once."""
    return union_size(bounds[:, 0].clamp(0, n).long(),
                      bounds[:, 1].clamp(0, n).long(), n)


def union_size(lo, hi, n: int) -> int:
    """Slots inside at least one of the half-open ranges [lo, hi)."""
    import torch

    ok = hi > lo
    d = torch.zeros(n + 1, dtype=torch.int64, device=lo.device)
    d.index_add_(0, lo[ok], torch.ones_like(lo[ok]))
    d.index_add_(0, hi[ok], -torch.ones_like(hi[ok]))
    return int((d.cumsum(0)[:n] > 0).sum())


def walk_work(bounds, probe_w, walk) -> dict:
    """What the compact and fused kernels' group -> leaf -> slot walk reads
    for these runs (csrc/refine.cu, walk_run), summed over the queries:
    the group rows of each run, the leaves tested (those of the groups
    that meet, inside the run), the leaves that meet and their run slots;
    and the distinct rows of each table, which the bound counts once."""
    import torch

    from repro_torch.core.geometry import mbr_intersects

    n, nl = walk.rec_leaf.shape[0], walk.leaf_mbr.shape[0]
    lo = bounds[:, 0].clamp(0, n).long()
    hi = bounds[:, 1].clamp(0, n).long()
    live = torch.nonzero(hi > lo).flatten()
    lo, hi, w = lo[live], hi[live], probe_w[live]
    l0 = walk.rec_leaf[lo].long().clamp(min=0)
    l1 = walk.rec_leaf[hi - 1].long().clamp(max=nl - 1)
    g0, g1 = l0 // 32, l1 // 32
    ng = (g1 - g0 + 1).clamp(min=0)
    qg = torch.repeat_interleave(torch.arange(live.numel(),
                                              device=bounds.device), ng)
    start = torch.cumsum(ng, 0) - ng
    gid = g0[qg] + torch.arange(qg.numel(), device=bounds.device) - start[qg]
    gm = mbr_intersects(walk.group_mbr[gid], w[qg])
    mq, mg = qg[gm], gid[gm]
    leaf = mg[:, None] * 32 + torch.arange(32, device=bounds.device)
    in_run = (leaf >= l0[mq, None]) & (leaf <= l1[mq, None])
    leafc = leaf.clamp(max=nl - 1)
    a = torch.maximum(walk.leaf_start[leafc].long(), lo[mq, None])
    b = torch.minimum(walk.leaf_start[leafc + 1].long(), hi[mq, None])
    meets = in_run & (a < b) & mbr_intersects(walk.leaf_mbr[leafc],
                                              w[mq][:, None, :])
    return {"groups_walked": int(qg.numel()),
            "leaves_walked": int(in_run.sum()),
            "meeting_leaves": int(meets.sum()),
            "meeting_leaf_slots": int((b - a)[meets].sum()),
            "distinct_groups": int(torch.unique(gid).numel()),
            "distinct_leaves": int(torch.unique(leaf[in_run]).numel()),
            "distinct_slots": union_size(a[meets], b[meets], n)}


def walk_bytes_ops(ww: dict, q: int) -> tuple:
    """Bytes and operations the walk needs: each distinct group row (16 B),
    tested leaf (its 16 B MBR and 4 B start) and record MBR row of a run
    slot inside a meeting leaf (16 B) read once, plus each query's two
    rec_leaf reads; 8 operations per MBR test (4 compares, 3 ands, the
    compaction's add)."""
    nbytes = (ww["distinct_groups"] * 16 + ww["distinct_leaves"] * 20
              + ww["distinct_slots"] * 16 + q * 8)
    ops = 8 * (ww["groups_walked"] + ww["leaves_walked"]
               + ww["meeting_leaf_slots"])
    return nbytes, ops


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S
          ) -> dict:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return {"bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to
            else "operations", "bytes": int(nbytes), "ops": int(ops)}


def queued_ms(fn, reps: int = 20) -> float:
    """Device time per call of ``fn``, every kernel it launches included,
    without the host's launch work: the stream first spins (~0.1 s,
    ``torch.cuda._sleep``) while the host queues all ``reps`` calls, so the
    CUDA events around them time only the device's run of them. ``fn`` must
    not synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def kernel_resources(key: str):
    """Registers, static shared memory and spills (ptxas ``-v``) of the
    built kernel whose mangled name holds ``key``; None when this process
    loaded an earlier build (ptxas did not run)."""
    from repro_torch.kernels import _build

    res = _build.kernel_resources()
    if not res:
        return None
    found = {n: r for n, r in res.items() if key in n}
    if len(found) != 1:
        raise RuntimeError(f"ptxas lines for {key}: {sorted(found)}")
    (name, r), = found.items()
    return {"kernel": name, **r}


def sass_tensor_ops(keys: tuple):
    """{kernel: {"HMMA": n, "HGMMA": n}} over the built library's SASS
    (``cuobjdump -sass``) for every kernel whose mangled name holds one of
    ``keys``; None where the toolkit has no cuobjdump."""
    from repro_torch.kernels import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        return None
    r = subprocess.run([tool, "-sass", str(_build.library_path())],
                       capture_output=True, text=True, timeout=300)
    if r.returncode:
        raise RuntimeError(f"cuobjdump failed: {r.stderr.strip()}")
    out, cur = {}, None
    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), {"HMMA": 0, "HGMMA": 0}) if (
                any(key in m.group(1) for key in keys)) else None
        elif cur is not None:
            for op in cur:
                cur[op] += bool(re.search(rf"\b{op}\.", line))
    return out


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def serve(server, cfg, counters, requests: int, prompt_len: int, ctx: int):
    """Drive ``server`` as ``main_lm`` does: ``requests`` prompts of
    ``prompt_len`` tokens with ``main_lm``'s generation lengths, capped at
    SERVE_GEN_MAX (numpy seed
    0), admitted into free slots, every slot stepped, finished requests
    retired. Zeroes every launch counter (and the peak memory) just before
    the first admit. CUDA events time each admit (the prefill) and each
    step."""
    import numpy as np
    import torch

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    slots = server.slots
    rng = np.random.default_rng(0)
    queue = [(rng.integers(0, cfg.vocab, prompt_len).astype(np.int32),
              int(rng.integers(8, min(ctx - prompt_len, SERVE_GEN_MAX))))
             for _ in range(requests)]
    prompts = [p for p, _ in queue]
    gens = [g for _, g in queue]
    owner = [None] * slots
    outputs = {}
    cur = np.zeros(slots, np.int32)
    prefill_ms, step_ms, active_hist = [], [], []
    decoded = 0
    pending = list(range(requests))
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t_run = time.perf_counter()
    while pending or any(server.active):
        for s in range(slots):
            if not server.active[s] and pending:
                r = pending.pop(0)
                a, b = events()
                a.record()
                server.admit(s, prompts[r], gens[r])
                b.record()
                b.synchronize()
                prefill_ms.append(a.elapsed_time(b))
                owner[s], cur[s] = r, prompts[r][-1]
        a, b = events()
        a.record()
        nxt = server.step(cur)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        active_hist.append(sum(server.active))
        for s in range(slots):
            if server.active[s]:
                server.generated[s].append(int(nxt[s]))
                cur[s] = nxt[s]
                server.remaining[s] -= 1
                decoded += 1
                if server.remaining[s] <= 0:
                    server.active[s] = False
                    outputs[owner[s]] = list(server.generated[s])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    if sorted(outputs) != list(range(requests)) or any(
            len(outputs[r]) != gens[r] or min(outputs[r]) < 0
            or max(outputs[r]) >= cfg.vocab for r in outputs):
        raise RuntimeError(f"{cfg.name} serving: a request's tokens are "
                           "missing or out of the vocabulary")
    return types.SimpleNamespace(
        prompts=prompts, gens=gens, outputs=outputs, cur=cur,
        prefill_ms=prefill_ms, step_ms=step_ms, active_hist=active_hist,
        decoded=decoded, wall=wall)


def serving_line(run, slots, ctx, prompt_len, base_mem, launches) -> dict:
    """The serving run's end-to-end numbers (peak memory since ``serve``
    reset it)."""
    import torch

    requests = len(run.prompts)
    return {
        "requests": requests, "slots": slots, "max_ctx": ctx,
        "prompt_len": prompt_len, "generated_tokens": run.decoded,
        "decode_steps": len(run.step_ms), "wall_s": run.wall,
        "tokens_per_s": run.decoded / run.wall,
        "prefill_ms_median": statistics.median(run.prefill_ms),
        "prefill_ms_first": run.prefill_ms[0],
        "prefill_ms_min": min(run.prefill_ms),
        "prefill_ms_max": max(run.prefill_ms),
        "decode_step_ms_median": statistics.median(run.step_ms),
        "decode_step_ms_full_batch_median": statistics.median(
            [t for t, n in zip(run.step_ms, run.active_hist) if n == slots]
            or [float("nan")]),
        "decode_step_ms_min": min(run.step_ms),
        "prefill_s_total": sum(run.prefill_ms) / 1e3,
        "decode_s_total": sum(run.step_ms) / 1e3,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "memory_before_model_bytes": base_mem,
        "launches": launches}


def lm_phase(katt, counters) -> tuple:
    """8. LM serving on the port: returns ({kernel: result line}, {kernel:
    launches of the serving run})."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import SlotServer
    from repro_torch.models import attention as mattn
    from repro_torch.models import transformer as tf
    from repro_torch.utils.tree import leaves, tree_map

    cfg = get_arch(LM_ARCH)
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, 0, device=DEVICE)
    server = SlotServer(cfg, params, LM_SLOTS, LM_CTX, DEVICE)
    torch.cuda.synchronize()
    log({"lm_model": {"arch": LM_ARCH, "layers": cfg.n_layers,
                      "d_model": cfg.d_model, "heads": cfg.n_heads,
                      "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
                      "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                      "dtype": cfg.dtype,
                      "params": sum(t.numel() for t in leaves(params)),
                      "weight_bytes": sum(t.numel() * t.element_size()
                                          for t in leaves(params)),
                      "cache_bytes": sum(t.numel() * t.element_size()
                                         for t in leaves(server.cache)),
                      "init_s": time.perf_counter() - t0}})

    # ------------------------------------------------ serve the requests
    run = serve(server, cfg, counters, LM_REQUESTS, LM_PROMPT, LM_CTX)
    prompts, outputs, cur = run.prompts, run.outputs, run.cur
    launches = {"flash_attention": katt.flash_attention.launches,
                "decode_attention": katt.decode_attention.launches}
    log({"path": "lm serving", "launches": {
        k: fn.launches for k, fn in counters.items()}})
    steps = len(run.step_ms)
    if launches != {"flash_attention": cfg.n_layers * LM_REQUESTS,
                    "decode_attention": cfg.n_layers * steps}:
        raise RuntimeError(f"lm serving: launches {launches}, expected "
                           f"{cfg.n_layers} per prefill ({LM_REQUESTS}) and "
                           f"per decode step ({steps})")
    log({"lm_serving": serving_line(run, LM_SLOTS, LM_CTX, LM_PROMPT,
                                    base_mem, launches)})
    prof_wall, dev, n_kernels = profiled(lambda: server.step(cur), reps=4)
    busy = sum(dev.values())
    log({"lm_decode_profile": {
        "steps": 4, "wall_ms_per_step": prof_wall,
        "device_ms_per_step": busy, "device_kernels_per_step": n_kernels,
        "device_busy_share": busy / prof_wall if dev else None,
        "top_kernels": dict(sorted(dev.items(), key=lambda kv: -kv[1])[:8])}})

    # ------------------------- each kernel against its plain version
    # the model reaches the kernels as ``models.attention.katt.<wrapper>``:
    # a stand-in module there captures layer 0's inputs (or, below, routes
    # to the plain versions) and leaves the kernel module as it is
    cap = {}

    def grab(tag):
        def wrap(name):
            def wrapper(*args):
                cap.setdefault(name.split("_")[0] + tag, tuple(
                    t.clone() for t in args if isinstance(t, torch.Tensor)))
                return getattr(katt, name)(*args)
            return wrapper
        return types.SimpleNamespace(
            flash_attention=wrap("flash_attention"),
            decode_attention=wrap("decode_attention"))

    cfg_w = dataclasses.replace(cfg, window=LM_WINDOW)
    try:
        mattn.katt = grab("")
        server.admit(0, prompts[0], 1)            # layer 0 of a real prefill
        server.step(cur)                          # ... and of a decode step
        mattn.katt = grab("_w")
        toks_w = torch.from_numpy(np.stack(prompts[:LM_SLOTS])).to(DEVICE)
        _, cache_w = tf.prefill(params, cfg_w, {"tokens": toks_w},
                                seq_len_cache=LM_CTX)
        tf.decode_step(params, cfg_w, {"tokens": toks_w[:, 0]}, cache_w)
        del cache_w
    finally:
        mattn.katt = katt
    ap, pos = cap["decode_w"][3], cap["decode_w"][4]
    if not (ap.shape[1] == LM_WINDOW and int(pos.min()) > LM_WINDOW):
        raise RuntimeError("windowed case: the ring did not wrap")

    cases = [("flash_attention", "bf16", cap["flash"], 0),
             ("flash_attention", "fp32", fp32_args(cap["flash"]), 0),
             ("flash_attention", f"bf16 window {LM_WINDOW}", cap["flash_w"],
              LM_WINDOW),
             ("decode_attention", "bf16", cap["decode"], 0),
             ("decode_attention", "fp32", fp32_args(cap["decode"]), 0),
             ("decode_attention", f"bf16 window {LM_WINDOW}",
              cap["decode_w"], LM_WINDOW)]
    results = {}
    for name, case, args, window in cases:
        kern = getattr(katt, name)
        plain = getattr(katt, name + "_plain")
        got = kern(*args, window)
        want = plain(*args, window)
        err, share, ok = att_bound(got, want)
        tol = ATT_TOL[str(args[0].dtype).split(".")[1]]
        line = {"name": f"{name}[{case}]",
                "shape": {"q": list(args[0].shape), "k": list(args[1].shape)},
                "max_abs_err": err, "tolerance": tol,
                "worst_share_of_bound": share,
                "plain_max_abs": float(want.float().abs().max())}
        if not ok:
            raise RuntimeError(f"{name}[{case}]: max abs err {err} from the "
                               f"plain version, past its bound ({line})")
        if name == "decode_attention":
            line.update(lse_check(katt, args, window, line["name"]))
        if case != "bf16":
            log(line)
            continue
        q, k, v = args[:3]
        if name == "flash_attention":
            b_, hq, s_, d_ = q.shape
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
            ops = 4 * b_ * hq * d_ * s_ * (s_ + 1) // 2

            def lib():
                return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
        else:
            b_, hq, d_ = q.shape
            apos, p_ = args[3], args[4]
            valid = (apos >= 0) & (apos <= p_[:, None])
            live = int(valid.sum())          # this run's live slots
            hkv = k.shape[1]
            nbytes = (2 * live * hkv * d_ * 2 + 2 * 2 * q.numel()
                      + apos.numel() * 4 + p_.numel() * 4)
            ops = 4 * live * hq * d_
            mask = valid[:, None, None, :]

            def lib():
                return F.scaled_dot_product_attention(
                    q[:, :, None], k, v, attn_mask=mask,
                    enable_gqa=True)[:, :, 0]
            line["live_slots"] = live
        if name == "flash_attention":
            shape = katt.flash_plan(b_, k.shape[1], hq // k.shape[1], s_,
                                    d_, q.dtype)
            key = shape["kernel"] + (
                "" if shape["kernel"] == "flash_wgmma_kernel"
                else f"ILi{d_}E")
        else:
            shape = katt.decode_plan(b_, k.shape[1])
            key = f"decode_split_kernelI13__nv_bfloat16Li{d_}E"
        report = {"launch": f"{name}[{case}]", **shape,
                  "resources": kernel_resources(key)}
        if shape["blocks"] < katt.H100_SMS:
            raise RuntimeError(f"{name}: {shape['blocks']} blocks on the "
                               f"card's {katt.H100_SMS} SMs")
        if name == "flash_attention":
            report["dynamic_smem_bytes"] = (
                _build.load().glin_flash_attention_bf16_smem(d_))
            # every bf16 flash kernel (wgmma at head dim 64, mma.sync at
            # the others) computes on the tensor cores
            sass = sass_tensor_ops(("flash_wgmma_kernel", "flash_mma_kernel"))
            report["sass_tensor_ops"] = (sass if sass is not None
                                         else "not measured (no cuobjdump)")
            if sass is not None and (
                    not any("flash_wgmma_kernel" in f for f in sass)
                    or any(c["HMMA"] + c["HGMMA"] == 0
                           for c in sass.values())):
                raise RuntimeError(f"a bf16 flash kernel without tensor-core "
                                   f"instructions in its SASS: {sass}")
        log(report)
        lib_err = max_err(lib(), want)
        line.update({
            "kernel_ms": queued_ms(lambda: kern(*args, window), 50),
            "event_ms": cuda_ms(lambda: kern(*args, window), 25),
            "plain_ms": queued_ms(lambda: plain(*args, window), 20),
            "plain_event_ms": cuda_ms(lambda: plain(*args, window), 10),
            "library_ms": queued_ms(lib, 50),
            "library_event_ms": cuda_ms(lib, 25),
            "library_call": "torch.nn.functional.scaled_dot_product_attention"
                            + (" (is_causal, enable_gqa)"
                               if name == "flash_attention" else
                               " (boolean mask from abs_pos/pos, enable_gqa)"),
            "library_max_abs_err": lib_err,
            **bound(nbytes, ops, BF16_OPS_PER_S)})
        log(line)
        results[name] = line

    # head dim 128 (phi4_mini_3p8b, codeqwen1p5_7b, granite_34b run the
    # mma.sync kernel there): phi4_mini's 24 query and 8 KV heads over a
    # 512-token prompt, q/k/v drawn from a seeded generator; measured only
    c128 = get_arch(FLASH_D128_ARCH)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    q, k, v = (torch.randn((1, h_, LM_PROMPT, c128.head_dim), device=DEVICE,
                           generator=g).bfloat16()
               for h_ in (c128.n_heads, c128.n_kv_heads, c128.n_kv_heads))
    got, want = katt.flash_attention(q, k, v), katt.flash_attention_plain(
        q, k, v)
    err, tol = max_err(got, want), ATT_TOL["bfloat16"]
    if not err < tol:
        raise RuntimeError(f"flash_attention[bf16 D128]: max abs err {err} "
                           f"from the plain version, tolerance {tol}")

    def lib128():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    log({"name": "flash_attention[bf16 D128]", "arch": FLASH_D128_ARCH,
         "shape": {"q": list(q.shape), "k": list(k.shape)},
         "plan": katt.flash_plan(1, c128.n_kv_heads,
                                 c128.n_heads // c128.n_kv_heads, LM_PROMPT,
                                 c128.head_dim, q.dtype),
         "max_abs_err": err, "tolerance": tol,
         "library_max_abs_err": max_err(lib128(), want),
         "kernel_ms": queued_ms(lambda: katt.flash_attention(q, k, v), 50),
         "event_ms": cuda_ms(lambda: katt.flash_attention(q, k, v), 25),
         "plain_ms": queued_ms(lambda: katt.flash_attention_plain(q, k, v),
                               20),
         "library_ms": queued_ms(lib128, 50),
         "library_event_ms": cuda_ms(lib128, 25),
         "library_call": "torch.nn.functional.scaled_dot_product_attention "
                         "(is_causal, enable_gqa)",
         **bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                 4 * c128.n_heads * c128.head_dim * LM_PROMPT
                 * (LM_PROMPT + 1) // 2, BF16_OPS_PER_S)})
    del q, k, v, got, want

    # ----------------- decode against the full forward, through the kernels
    def check(got, want, atol, rtol):
        """(max abs error, its limit: atol + rtol * the logits' range)."""
        return max_err(got, want), atol + rtol * float(want.abs().max())

    def decode_vs_forward(prm, c, n_steps, tol):
        toks = torch.from_numpy(np.concatenate(
            [prompts[0], np.asarray(outputs[0], np.int32)])).to(DEVICE)[None]
        last, cache = tf.prefill(prm, c, {"tokens": toks[:, :LM_PROMPT]},
                                 seq_len_cache=LM_CTX)
        worst = []
        for t in range(n_steps + 1):
            if t:
                last, cache = tf.decode_step(
                    prm, c, {"tokens": toks[:, LM_PROMPT + t - 1]}, cache)
            full, _ = tf.forward(prm, c, {"tokens": toks[:, :LM_PROMPT + t]},
                                 logits_last_only=True)
            worst.append(check(last, full[:, -1], *tol))
        return worst

    def kernel_vs_plain(prm, c, n_steps, tol):
        """Prefill + n decode steps of 2 requests, the same tokens fed to
        the kernel path and the plain path."""
        g = np.random.default_rng(1)
        toks = torch.from_numpy(np.stack(prompts[:2])).to(DEVICE)
        feed = torch.from_numpy(g.integers(0, c.vocab, (n_steps, 2)).astype(
            np.int32)).to(DEVICE)
        runs = {}
        for path in ("kernel", "plain"):
            n0 = katt.flash_attention.launches + katt.decode_attention.launches
            if path == "plain":
                mattn.katt = types.SimpleNamespace(
                    flash_attention=katt.flash_attention_plain,
                    decode_attention=katt.decode_attention_plain)
            try:
                logits, cache = tf.prefill(prm, c, {"tokens": toks},
                                           seq_len_cache=LM_CTX)
                out = [logits]
                for t in range(n_steps):
                    logits, cache = tf.decode_step(prm, c,
                                                   {"tokens": feed[t]}, cache)
                    out.append(logits)
                runs[path] = out
            finally:
                mattn.katt = katt
            n = katt.flash_attention.launches + katt.decode_attention.launches
            if (n - n0 == 0) != (path == "plain"):
                raise RuntimeError(f"the {path} path launched {n - n0} "
                                   "attention kernels")
        return [check(a, b, *tol)
                for a, b in zip(runs["kernel"], runs["plain"])]

    bf16_tol = (0.0, LM_BF16_REL)
    report = {"decode_vs_forward[bf16]": decode_vs_forward(
                  params, cfg, LM_FORWARD_STEPS, bf16_tol),
              "kernel_vs_plain[bf16]": kernel_vs_plain(
                  params, cfg, LM_TEACHER_STEPS, bf16_tol)}
    del server
    params32 = tree_map(params, lambda t: t.float())
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    report["decode_vs_forward[fp32]"] = decode_vs_forward(
        params32, cfg32, LM_FP32_STEPS, LM_FP32_TOL)
    report["kernel_vs_plain[fp32]"] = kernel_vs_plain(
        params32, cfg32, LM_FP32_STEPS, LM_FP32_TOL)
    del params32
    for what, errs in report.items():
        log({"lm_check": what, "steps": len(errs) - 1,
             "max_abs_err": max(e for e, _ in errs),
             "limit": min(lim for _, lim in errs),
             "per_step": [round(e, 6) for e, _ in errs]})
        bad = [i for i, (e, lim) in enumerate(errs) if not e <= lim]
        if bad:
            raise RuntimeError(f"{what}: logits off at steps {bad}: "
                               f"{[errs[i] for i in bad]}")
    torch.cuda.empty_cache()
    return results, launches


def ssd_work(x, dt, b, chunk: int) -> tuple:
    """(bytes, C B^T operations, the other operations) of ``ssd_scan`` on
    these inputs: C B^T once per chunk (shared by the heads), and per head
    and chunk W X, C state and the state update; x, dt, a, B, C read once,
    y and the fp32 final state written once. The causal mask leaves C B^T
    and W X only their lower triangle, ch (ch + 1) / 2 of the ch^2 pairs."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    ch = min(chunk, s)
    nc = -(-s // ch)
    tri = ch * (ch + 1) // 2
    nbytes = (2 * x.numel() * x.element_size() + bsz * h * n * p * 4
              + dt.numel() * 4 + h * 4 + 2 * b.numel() * b.element_size())
    return (nbytes, bsz * nc * 2 * tri * n,
            bsz * h * nc * (2 * tri * p + 4 * ch * n * p))


def ssd_bound(x, dt, b, tile: int) -> dict:
    """The least time for ``ssd_scan`` on these inputs, counted at the
    kernel's own chunk ``tile``: the bytes, or the products on the tensor
    cores at the bf16 rate, each counted once per bf16 part the kernel
    multiplies (an fp32 operand is split in two: two products against a
    bf16 operand, three with both fp32; C B^T of bf16 inputs is one),
    whichever takes longer. ``bound_fp32_ms`` beside it: the same work with
    each product once on the CUDA cores at the fp32 rate."""
    nbytes, ops_cb, ops_rest = ssd_work(x, dt, b, tile)
    parts_cb, parts_rest = (1, 2) if x.dtype.itemsize == 2 else (3, 3)
    fp32 = bound(nbytes, ops_cb + ops_rest)
    return {**bound(nbytes, parts_cb * ops_cb + parts_rest * ops_rest,
                    BF16_OPS_PER_S),
            "bound_fp32_ms": fp32["bound_ms"], "bound_fp32_by": fp32["bound_by"],
            "ops_fp32": fp32["ops"]}


def ssd_errors(got, want, mag) -> tuple:
    """(max abs error, worst share of the bound): the bound per element is
    atol + rtol * mag (the magnitude of the terms the element sums), plus
    one bf16 step of |plain| for a bf16 output."""
    atol, rtol = SSD_TOL
    if got.dtype != want.dtype or got.shape != want.shape:
        raise RuntimeError(f"ssd_scan: {got.dtype} {tuple(got.shape)} "
                           f"against {want.dtype} {tuple(want.shape)}")
    d = (got.float() - want.float()).abs()
    lim = atol + rtol * mag
    if str(got.dtype) == "torch.bfloat16":
        lim = lim + SSD_BF16_STEP * want.float().abs()
    return float(d.max()), float((d / lim).max())


def ssd_check(kssd, name, args, chunk) -> dict:
    """``ssd_scan`` against its plain version on ``args`` (x, dt, a, b, c):
    y and the final state within :func:`ssd_errors`' bound, both finite;
    raises otherwise. Returns the result line."""
    import torch

    y, st = kssd.ssd_scan(*args, chunk, return_state=True)
    want_y, want_st = kssd.ssd_scan_plain(*args, chunk, return_state=True)
    mag_y, mag_st = kssd.ssd_scan_plain(
        args[0].float().abs(), args[1], args[2], args[3].float().abs(),
        args[4].float().abs(), chunk, return_state=True)
    ey, shy = ssd_errors(y, want_y, mag_y)
    es, shs = ssd_errors(st, want_st, mag_st)
    line = {"name": name,
            "shape": {"x": list(args[0].shape), "b": list(args[3].shape)},
            "strides": {"x": list(args[0].stride()),
                        "b": list(args[3].stride())},
            "max_abs_err": ey, "state_max_abs_err": es,
            "worst_share_of_bound": max(shy, shs),
            "y_max_abs": float(want_y.float().abs().max()),
            "y_terms_max_abs": float(mag_y.abs().max()),
            "state_max_abs": float(want_st.abs().max()),
            "tolerance": {"atol": SSD_TOL[0], "rtol_of_terms": SSD_TOL[1],
                          "rtol_of_y": (SSD_BF16_STEP
                                        if y.dtype == torch.bfloat16
                                        else 0.0)}}
    if not (max(shy, shs) <= 1 and torch.isfinite(y.float()).all()
            and torch.isfinite(st).all()):
        raise RuntimeError(f"{name}: off its plain version ({line})")
    return line


def step_errs(got, want) -> list:
    """Per step: the largest |got - want| and want's largest magnitude."""
    return [(max_err(g, w), float(w.abs().max())) for g, w in zip(got, want)]


def swap_in(swaps):
    """Set each ``(module, attribute, value)`` of ``swaps``; returns the
    swaps that put the old values back."""
    old = [(m, a, getattr(m, a)) for m, a, _ in swaps]
    for m, a, v in swaps:
        setattr(m, a, v)
    return old


def timed_calls(module, attr):
    """Swap ``module.<attr>`` for a wrapper that records a pair of CUDA
    events around each call; returns (the list of (start, end) pairs, the
    swaps that undo it)."""
    import torch

    real, events = getattr(module, attr), []

    def timed(*a, **kw):
        e = (torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True))
        e[0].record()
        out = real(*a, **kw)
        e[1].record()
        events.append(e)
        return out
    return events, swap_in([(module, attr, timed)])


def check_launches(what, kernels, before, c, steps, plain=False):
    """Each of ``kernels`` ({name: (wrapper, "prefill" or "decode")}) ran
    once a layer in the prefill, or once a layer in each of ``steps``
    decode steps, since the counts ``before``; on the plain path, never."""
    got = {k: fn.launches - before[k] for k, (fn, _) in kernels.items()}
    want = {k: 0 if plain else c.n_layers * (1 if when == "prefill"
                                             else steps)
            for k, (_, when) in kernels.items()}
    if got != want:
        raise RuntimeError(f"{what}: launches {got}, expected {want}")


def prefix(batch, n: int) -> dict:
    """The first ``n`` positions of a prompt batch: tokens (B, S), embeds
    (B, S, d), M-RoPE positions (B, 3, S)."""
    return {k: v[..., :n] if k == "positions" else v[:, :n]
            for k, v in batch.items()}


def at(batch, t: int) -> dict:
    """The decode step input of position ``t`` of a prompt batch."""
    return {k: v[:, t] for k, v in batch.items() if k != "positions"}


class Upcast:
    """The layers of a stacked bf16 ``blocks`` tree in fp32, one at a time:
    iterating copies layer i into one fp32 layer's buffers and yields them,
    so a forward or decode step (``models.transformer`` takes such an
    iterable as its blocks) runs the fp32 model of the first ``n`` layers
    while the card holds one fp32 layer (a full MoE model in fp32 would not
    fit). Each layer is used before the next overwrites it: the stack runs
    its layers in turn on one stream."""

    def __init__(self, blocks, n: int):
        import torch

        from repro_torch.utils.tree import tree_map

        self.blocks, self.n = blocks, n
        self.buf = tree_map(blocks, lambda t: torch.empty(
            t.shape[1:], dtype=torch.float32, device=t.device))

    def __iter__(self):
        def fill(dst, src, i):
            for k, t in dst.items():
                if isinstance(t, dict):
                    fill(t, src[k], i)
                else:
                    t.copy_(src[k][i])
        for i in range(self.n):
            fill(self.buf, self.blocks, i)
            yield self.buf


class MoERecorder:
    """Stands in for ``models.transformer.moe`` (the module the blocks call)
    and, while ``runs`` is a list, records per MoE call, on the device, the
    replicas the call's dispatch drops and each token's sorted experts
    (``moe.route`` of the call's input: one dispatch chunk, which every
    call of the phases is, at most 65,536 tokens); anything else is the
    module's."""

    def __init__(self, real):
        self.real, self.runs = real, None

    def __getattr__(self, name):
        return getattr(self.real, name)

    def moe_ffn(self, x, p, cfg, **kw):
        if self.runs is not None:
            r = self.real.route(x.reshape(-1, x.shape[-1]), p["router"],
                                cfg.top_k)
            self.runs.append(((r.counts - r.cap).clamp(min=0).sum(),
                              r.eidx.sort(-1).values))
        return self.real.moe_ffn(x, p, cfg, **kw)

    def record(self, fn):
        """(fn's result, the dropped replicas of each of its MoE calls)."""
        self.runs = []
        try:
            out = fn()
        finally:
            calls, self.runs = self.runs, None
        return out, [int(d) for d, _ in calls], [e for _, e in calls]


class Probe(NamedTuple):
    """A decode-against-forward check: prefill the first ``split``
    positions of ``seq`` (a one-row prompt batch: tokens, or embeddings
    with their positions), feed the rest one decode step at a time, and
    hold the logits of positions split - 1 .. S - 1 against one forward
    over all S, in the first ``layers`` layers (all where None); ``note``
    ends its report lines."""
    seq: dict
    split: int
    layers: Optional[int] = None
    note: str = ""


def lm_path_checks(tag, prm, c, probes, two, feed, kernels, plain_swaps, *,
                   depths, rel_depth=None, ctx=None, fp32_layers=None,
                   recorder=None) -> None:
    """Phases 9-12's end-to-end checks of a bf16 model with weights
    ``prm``:

    - decode against the forward, for each :class:`Probe` of ``probes``;
    - the kernel path against the plain path (``plain_swaps`` installed):
      a prefill of the two-row batch ``two`` and one decode step for each
      batch of ``feed``;

    each with the weights upcast to fp32 (the same function without bf16
    rounding) at LM_FP32_TOL, in the first ``fp32_layers`` layers (all
    where None), and in bf16 within SSM_BF16_DRIFT_RATIO times its
    counterpart's distance from the fp32 run, decode against the forward
    also cut to the first ``depths`` layers (and at ``rel_depth`` layers
    within LM_BF16_REL of the logits' range). The fp32 runs deeper than
    ``fp32_layers`` (the bf16 checks' counterparts) take the layers upcast
    one at a time (:class:`Upcast`). Every path checks the launches of
    ``kernels`` (:func:`check_launches`). With a :class:`MoERecorder`
    installed as ``recorder``, every run's drops are logged, and the bf16
    kernel and plain paths' expert choices compared. Raises on any check
    past its limit."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.utils.tree import tree_map

    kw = {} if ctx is None else {"seq_len_cache": ctx}
    nl = c.n_layers
    d32 = fp32_layers or nl
    routes = {}

    def counts():
        return {k: fn.launches for k, (fn, _) in kernels.items()}

    def recorded(name, cc, fn):
        if recorder is None:
            return fn()
        out, drops, experts = recorder.record(fn)
        routes[name] = experts
        log({f"lm_{tag}_moe_run": name, "layers": cc.n_layers,
             "dtype": cc.dtype, "calls": len(drops),
             "dropped": sum(drops), "dropped_by_call": drops})
        return out

    def decode_path(pr, p, cc):
        seq_len = next(iter(pr.seq.values())).shape[1]

        def run():
            before = counts()
            last, cache = tf.prefill(p, cc, prefix(pr.seq, pr.split), **kw)
            out = [last]
            for t in range(pr.split, seq_len):
                last, cache = tf.decode_step(p, cc, at(pr.seq, t), cache)
                out.append(last)
            check_launches(f"{tag} decode path", kernels, before, cc,
                           seq_len - pr.split)
            return torch.cat(out)
        return recorded(f"decode path {seq_len} {cc.n_layers} {cc.dtype}",
                        cc, run)

    def forward_path(pr, p, cc):
        def run():
            full, _ = tf.forward(p, cc, pr.seq)
            return full[0, pr.split - 1:]
        return recorded(f"forward {full_len(pr)} {cc.n_layers} {cc.dtype}",
                        cc, run)

    def full_len(pr):
        return next(iter(pr.seq.values())).shape[1]

    def teacher_paths(p, cc):
        runs = {}
        for path in ("kernel", "plain"):
            def run():
                before = counts()
                old = swap_in(plain_swaps if path == "plain" else ())
                try:
                    logits, cache = tf.prefill(p, cc, two, **kw)
                    out = [logits]
                    for step in feed:
                        logits, cache = tf.decode_step(p, cc, step, cache)
                        out.append(logits)
                finally:
                    swap_in(old)
                check_launches(f"{tag} {path} path", kernels, before, cc,
                               len(feed), plain=path == "plain")
                return torch.stack(out)
            runs[path] = recorded(f"{path} path {cc.n_layers} {cc.dtype}",
                                  cc, run)
        return runs

    def first(p, cc, n):
        """The model cut to its first n layers (views of the weights)."""
        return ({**p, "blocks": tree_map(p["blocks"], lambda t: t[:n])},
                dataclasses.replace(cc, n_layers=n))

    c32 = dataclasses.replace(c, dtype="float32")
    top32 = {k: v.float() for k, v in prm.items() if k != "blocks"}
    held = {"p32": {**top32, "blocks": tree_map(
        prm["blocks"], lambda t: t[:d32].float())}}
    fwd32 = {}

    def fp32_at(n):
        """The fp32 model of the first n layers: views of the upcast
        weights while they are held, else the layers upcast in turn."""
        if held["p32"] is not None and n <= d32:
            return first(held["p32"], c32, n)
        held["p32"] = None
        torch.cuda.empty_cache()
        return ({**top32, "blocks": Upcast(prm["blocks"], n)},
                dataclasses.replace(c32, n_layers=n))

    def forward32(i, n):
        if (i, n) not in fwd32:
            fwd32[i, n] = forward_path(probes[i], *fp32_at(n))
        return fwd32[i, n]

    def layers_name(n):
        return "" if n == nl else f", {n} layers"

    atol32, rtol32 = LM_FP32_TOL
    teach32 = teacher_paths(*fp32_at(d32))
    report = {f"kernel_vs_plain[fp32{layers_name(d32)}]": [
        (e, atol32 + rtol32 * r)
        for e, r in step_errs(teach32["kernel"], teach32["plain"])]}
    for i, pr in enumerate(probes):
        n32 = min(d32, pr.layers or nl)
        report[f"decode_vs_forward[fp32{layers_name(n32)}{pr.note}]"] = [
            (e, atol32 + rtol32 * r)
            for e, r in step_errs(decode_path(pr, *fp32_at(n32)),
                                  forward32(i, n32))]
    # bf16 against depth: the decode path against the forward, each limit
    # SSM_BF16_DRIFT_RATIO times the forward's largest distance to its fp32
    # run of the same layers
    for i, pr in enumerate(probes):
        top = pr.layers or nl
        for n in tuple(d for d in depths if d < top) + (top,):
            f32 = forward32(i, n)
            f16 = forward_path(pr, *first(prm, c, n))
            d16 = decode_path(pr, *first(prm, c, n))
            gap = step_errs(d16, f16)
            drift = max(e for e, _ in step_errs(f16, f32))
            rng = float(f32.abs().max())
            name = layers_name(n) + pr.note
            report[f"decode_vs_forward[bf16{name}]"] = [
                (e, SSM_BF16_DRIFT_RATIO * drift) for e, _ in gap]
            if n == rel_depth:
                report[f"decode_vs_forward[bf16{name}, share of range]"] = [
                    (e, LM_BF16_REL * r) for e, r in gap]
            log({f"lm_{tag}_bf16_depth": n, "tokens": full_len(pr),
                 "split": pr.split, "logits_range": rng,
                 "gap_max": max(e for e, _ in gap), "gap_first": gap[0][0],
                 "forward_drift": drift,
                 "decode_drift": max(e for e, _ in step_errs(d16, f32)),
                 "gap_share_of_range": max(e for e, _ in gap) / rng,
                 "drift_share_of_range": drift / rng,
                 "gap_over_drift": max(e for e, _ in gap) / drift})
            del f16, d16
    fwd32.clear()
    teach32_full = teach32 if d32 == nl else teacher_paths(*fp32_at(nl))
    held["p32"] = None
    torch.cuda.empty_cache()
    teach16 = teacher_paths(prm, c)
    drift = max(e for e, _ in step_errs(teach16["plain"],
                                        teach32_full["plain"]))
    report["kernel_vs_plain[bf16]"] = [
        (e, SSM_BF16_DRIFT_RATIO * drift)
        for e, _ in step_errs(teach16["kernel"], teach16["plain"])]
    line = {f"lm_{tag}_bf16_teacher": "kernel_vs_plain", "plain_drift": drift,
            "kernel_drift": max(e for e, _ in step_errs(
                teach16["kernel"], teach32_full["kernel"]))}
    if recorder is not None:
        # (token, layer) routes on which the two bf16 paths chose other
        # experts: a near-tie in a router flips on a rounding
        ks = routes[f"kernel path {nl} {c.dtype}"]
        ps = routes[f"plain path {nl} {c.dtype}"]
        differ = sum(int((a != b).any(-1).sum()) for a, b in zip(ks, ps))
        total = sum(a.shape[0] for a in ks)
        line.update(routes=total, routes_differ=differ,
                    routes_differ_share=differ / total)
    log(line)
    failed = []
    for what, errs_ in report.items():
        log({f"lm_{tag}_check": what, "steps": len(errs_) - 1,
             "max_abs_err": max(e for e, _ in errs_),
             "limit": min(lim for _, lim in errs_),
             "per_step": [round(e, 6) for e, _ in errs_]})
        bad = [i for i, (e, lim) in enumerate(errs_) if not e <= lim]
        if bad:
            failed.append(f"{tag} {what}: logits off at steps {bad}: "
                          f"{[errs_[i] for i in bad]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    torch.cuda.empty_cache()


def token_inputs(prompts, vocab: int, steps: int) -> tuple:
    """lm_path_checks' inputs for a token model: ``prompts[0]`` as a
    one-row prompt batch, ``prompts[:2]`` as the two-row prefill and
    ``steps`` teacher-forced decode steps of seeded tokens (numpy seed
    1)."""
    import numpy as np
    import torch

    gen = np.random.default_rng(1)
    feed = torch.from_numpy(gen.integers(0, vocab, (steps, 2)).astype(
        np.int32)).to(DEVICE)
    return ({"tokens": torch.from_numpy(prompts[0]).to(DEVICE)[None]},
            {"tokens": torch.from_numpy(np.stack(prompts[:2])).to(DEVICE)},
            [{"tokens": f} for f in feed])


def ssm_phase(kssd, counters) -> tuple:
    """9. SSM serving on the port: returns ({"ssd_scan": result line},
    {"ssd_scan": launches of the serving run})."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import SlotServer
    from repro_torch.models import ssm as mssm
    from repro_torch.models import transformer as tf
    from repro_torch.utils.tree import leaves

    cfg = get_arch(SSM_ARCH)
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, 0, device=DEVICE)
    server = SlotServer(cfg, params, SSM_SLOTS, SSM_CTX, DEVICE)
    torch.cuda.synchronize()
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in leaves(server.cache))
    log({"lm_ssm_model": {
        "arch": SSM_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "d_inner": cfg.d_inner, "ssm_heads": cfg.ssm_heads,
        "ssm_head_dim": cfg.ssm_head_dim, "ssm_state": cfg.ssm_state,
        "conv_width": cfg.conv_width, "vocab": cfg.vocab,
        "dtype": cfg.dtype, "ssd_chunk": cfg.ssd_chunk,
        "params": sum(t.numel() for t in leaves(params)),
        "param_count": cfg.param_count(),
        "weight_bytes": sum(t.numel() * t.element_size()
                            for t in leaves(params)),
        "cache_bytes": cache_bytes,
        "cache_bytes_per_slot": cache_bytes // SSM_SLOTS,
        "init_s": time.perf_counter() - t0}})

    # ------------------------------------------------ serve the requests
    run = serve(server, cfg, counters, SSM_REQUESTS, SSM_PROMPT, SSM_CTX)
    prompts, cur = run.prompts, run.cur
    got = {k: fn.launches for k, fn in counters.items()}
    log({"path": "lm ssm serving", "launches": got})
    launches = {"ssd_scan": got["ssd_scan"]}
    if launches["ssd_scan"] != cfg.n_layers * SSM_REQUESTS or any(
            n for k, n in got.items() if k != "ssd_scan"):
        raise RuntimeError(f"ssm serving: launches {got}, expected "
                           f"ssd_scan {cfg.n_layers} per prefill "
                           f"({SSM_REQUESTS}) and nothing else")
    log({"lm_ssm_serving": serving_line(run, SSM_SLOTS, SSM_CTX, SSM_PROMPT,
                                        base_mem, launches)})
    for what, fn, reps in (("decode", lambda: server.step(cur), 4),
                           ("prefill", lambda: server.admit(
                               0, prompts[0], 1), 1)):
        seen = {}
        prof_wall, dev, n_kernels = profiled(fn, reps, seen)
        busy = sum(dev.values())
        log({f"lm_ssm_{what}_profile": {
            "calls": reps, "wall_ms_per_call": prof_wall,
            "device_ms_per_call": busy, "device_kernels_per_call": n_kernels,
            "device_busy_share": busy / prof_wall if dev else None,
            # the SSD kernels: (ms, launches recorded) per call, of the
            # layers' launches (one each a prefill)
            "ssd_kernels": {re.sub(r"^.*::|<.*$|\(.*$", "", k): [t, seen[k]]
                            for k, t in dev.items() if "ssd_" in k},
            "top_kernels": dict(sorted(dev.items(),
                                       key=lambda kv: -kv[1])[:8])}})

    # ------------------------------- the kernel against its plain version
    # the model reaches the kernel as ``models.ssm.kssd.ssd_scan``: a
    # stand-in module there keeps layer 0's inputs of a real prefill (the
    # views into the convolution's output, as the kernel reads them)
    cap = []

    def grab(*args, **kw):
        if not cap:
            cap.extend(args[:5])
        return kssd.ssd_scan(*args, **kw)

    try:
        mssm.kssd = types.SimpleNamespace(ssd_scan=grab)
        server.admit(0, prompts[0], 1)
    finally:
        mssm.kssd = kssd
    x, dt, a, bm, cm = cap
    g = torch.Generator(device=DEVICE).manual_seed(0)
    synth = (torch.randn(x.shape, device=DEVICE, generator=g),
             torch.rand(dt.shape, device=DEVICE, generator=g) * 0.099 + 0.001,
             -(torch.rand(a.shape, device=DEVICE, generator=g) * 0.9 + 0.1),
             torch.randn(bm.shape, device=DEVICE, generator=g),
             torch.randn(cm.shape, device=DEVICE, generator=g))

    def as_dtype(args, dtype):
        return (args[0].to(dtype), args[1], args[2], args[3].to(dtype),
                args[4].to(dtype))

    cases = [("real bf16", (x, dt, a, bm, cm)),
             ("real fp32", as_dtype((x, dt, a, bm, cm), torch.float32)),
             ("synthetic bf16", as_dtype(synth, torch.bfloat16)),
             ("synthetic fp32", synth)]
    chunk = cfg.ssd_chunk
    result = None
    for case, args in cases:
        line = ssd_check(kssd, f"ssd_scan[{case}]", args, chunk)
        if case == "real bf16":       # the main path's inputs: timed
            seen = {}
            _, dev_ssd, _ = profiled(lambda: kssd.ssd_scan(
                *args, chunk, return_state=True), 20, seen)
            # one launch of each phase a call
            dev_ssd = per_launch(dev_ssd, seen)
            phases = collections.Counter()
            per_call = collections.Counter()
            for k, t in dev_ssd.items():
                if "ssd_" in k:
                    name = re.sub(r"^.*::|<.*$|\(.*$", "", k)
                    phases[name] += t
                    per_call[name] += seen[k]
            line.update({
                "phase_device_ms": dict(phases) or "not measured",
                "phase_recorded_per_call": dict(per_call),
                "device_ms": sum(phases.values()) if phases else None,
                "kernel_ms": queued_ms(lambda: kssd.ssd_scan(
                    *args, chunk, return_state=True), 50),
                "event_ms": cuda_ms(lambda: kssd.ssd_scan(
                    *args, chunk, return_state=True), 25),
                "plain_ms": queued_ms(lambda: kssd.ssd_scan_plain(
                    *args, chunk, return_state=True), 20),
                "plain_event_ms": cuda_ms(lambda: kssd.ssd_scan_plain(
                    *args, chunk, return_state=True), 10),
                "library_ms": None,
                **ssd_bound(x, dt, bm, kssd.TILE)})
            result = line
        log(line)
    del cap, synth, cases

    # ------ decode against the full forward, the kernel path against plain
    del server
    torch.cuda.empty_cache()
    seq, two, feed = token_inputs(prompts, cfg.vocab, SSM_TEACHER_STEPS)
    lm_path_checks(
        "ssm", params, cfg, [Probe(seq, SSM_FORWARD_PROMPT)], two, feed,
        {"ssd_scan": (kssd.ssd_scan, "prefill")},
        [(mssm, "kssd", types.SimpleNamespace(ssd_scan=kssd.ssd_scan_plain))],
        depths=SSM_DEPTHS, rel_depth=SSM_REL_DEPTH)
    return {"ssd_scan": result}, launches


def same_ids(a, b, what):
    """Exact equality of two lists of id arrays."""
    import numpy as np

    if len(a) != len(b):
        raise RuntimeError(f"{what}: {len(a)} vs {len(b)} rows")
    for i, (x, y) in enumerate(zip(a, b)):
        if not np.array_equal(x, y):
            raise RuntimeError(f"{what}: row {i} differs ({len(x)} vs "
                               f"{len(y)} ids)")


def ring_of(gs, i: int):
    """Record ``i``'s ring from a CSR store."""
    o = int(gs.offsets[i])
    return gs.pool[o:o + int(gs.nverts[i])]


def write_phase(idx, wins, pts, counters, read_path):
    """6a. The write stream on phase 3's store: inserts and deletes leave a
    delta of 3072 records, patched on the published snapshot
    (``device+delta``) for every window relation and for kNN; each batch
    equal to the same batch on a synchronous republish at the same epoch
    (a second facade over the same host tree) and, on 32 windows, to the
    fp64 host path. Returns the path's launches and the republish's ms."""
    import numpy as np
    import torch

    from repro_torch.core import device as dev
    from repro_torch.core.datasets import generate
    from repro_torch.core.engine import EngineConfig, QueryBatch, SpatialIndex

    src = generate("mixed", WRITE_INSERTS, seed=3)
    fp32_exact(src)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for i in range(WRITE_INSERTS):
        idx.insert(ring_of(src, i), int(src.nverts[i]), int(src.kinds[i]))
    t1 = time.perf_counter()
    published = np.nonzero(idx.glin._live_mask()[:idx._snapshot_recs])[0]
    for rec in np.random.default_rng(5).choice(published, WRITE_DELETES,
                                               replace=False):
        if not idx.delete(int(rec)):
            raise RuntimeError(f"delete of record {rec} failed")
    t2 = time.perf_counter()
    log({"writes": {"inserts": WRITE_INSERTS, "deletes": WRITE_DELETES,
                    "delta": idx.delta_size(),
                    "insert_ms_each": (t1 - t0) * 1e3 / WRITE_INSERTS,
                    "delete_ms_each": (t2 - t1) * 1e3 / WRITE_DELETES}})
    if idx.delta_size() != WRITE_INSERTS + WRITE_DELETES:
        raise RuntimeError(f"delta of {idx.delta_size()}")

    batches = {}
    for rel in FACADE_RELATIONS:
        batch = wins[:DISJOINT_WINDOWS] if rel == "disjoint" else wins
        walls, res = [], None
        for _ in range(1 if rel == "disjoint" else 3):
            t0 = time.perf_counter()
            r = idx.query(QueryBatch.window(batch, rel))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            if r.plan.backend != "device+delta":
                raise RuntimeError(f"{rel}: not patched ({r.plan})")
            if res is not None:
                same_ids(r.ids, res.ids, f"{rel} device+delta rerun")
            res = r
        st = {s.stage: s for s in res.stages}
        log({"batch": "device+delta", "relation": rel,
             "queries": len(batch), "wall_ms": walls,
             "refine_impl": st["refine"].impl,
             "refine_ms": st["refine"].wall_ms,
             "delta_patch_ms": st["delta-patch"].wall_ms,
             "delta_added": st["delta-patch"].delta_added,
             "delta_tombstoned": st["delta-patch"].delta_tombstoned,
             "hits": res.total_hits})
        batches[rel] = (batch, res)
    # the added-set check alone: one (1024 x rows) pass on the card
    table, snap = idx._delta_table(), idx._snapshot
    wt = torch.from_numpy(wins.astype(np.float32)).to(DEVICE)
    wall, devt, nk = profiled(lambda: dev.batch_check_added(
        table, wt, "intersects", snap.grid_x0, snap.grid_y0, snap.grid_cell))
    log({"added_set_check": {
        "queries": len(wins), "table_rows": table.size,
        "added": int((table.ids >= 0).sum()), "profiled_wall_ms": wall,
        "device_ms": sum(devt.values()) if devt else "not measured",
        "device_kernels": nk}})
    t0 = time.perf_counter()
    knn = idx.query(QueryBatch.knn(pts, KNN_KS[0]))
    torch.cuda.synchronize()
    st = knn.stages[0]
    log({"batch": "knn[device+delta]", "k": KNN_KS[0], "queries": len(pts),
         "wall_ms": (time.perf_counter() - t0) * 1e3,
         "backend": knn.plan.backend, "rungs": st.rungs,
         "delta_added": st.delta_added,
         "delta_tombstoned": st.delta_tombstoned})
    if knn.plan.backend != "device+delta":
        raise RuntimeError(f"knn not patched: {knn.plan}")
    launches = read_path("write", ("refine_fused", "refine_compact",
                                   "knn_topk"))

    # the same batches on a synchronous republish at the same epoch: a
    # second facade over the same host tree, whose first batch (forced
    # onto the device) publishes and uploads the geometry payload; the
    # publish's parts (capture, numpy build, upload) as the index times
    # them
    rep = SpatialIndex(idx.glin, EngineConfig(), device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = rep.query(QueryBatch.window(wins, "intersects", backend="device"))
    torch.cuda.synchronize()
    sync_ms = (time.perf_counter() - t0) * 1e3
    if not (first.plan.rebuild_snapshot and first.plan.backend == "device"):
        raise RuntimeError(f"republishing batch plan {first.plan}")
    parts = rep.stats()["sync_publish"]
    publish_ms = parts["capture_ms"] + parts["build_ms"] + parts["upload_ms"]
    log({"republish": {**parts, "publish_ms": publish_ms,
                       "payload_and_batch_ms": sync_ms - publish_ms,
                       "total_ms": sync_ms}})
    same_ids(batches["intersects"][1].ids, first.ids,
             "intersects: device+delta vs republishing batch")
    for rel, (batch, res) in batches.items():
        r = rep.query(QueryBatch.window(batch, rel))
        if r.plan.backend != "device" or r.plan.rebuild_snapshot:
            raise RuntimeError(f"{rel}: republished facade plan {r.plan}")
        same_ids(res.ids, r.ids, f"{rel}: device+delta vs republished")
        host = idx.query(QueryBatch.window(batch[:HOST_CHECK], rel,
                                           backend="host"))
        same_ids(res.ids[:HOST_CHECK], host.ids,
                 f"{rel}: device+delta vs host")
    r = rep.query(QueryBatch.knn(pts, KNN_KS[0]))
    same_ids(knn.ids, r.ids, "knn: device+delta vs republished")
    for i, (a, b) in enumerate(zip(knn.distances, r.distances)):
        if not np.array_equal(a, b):
            raise RuntimeError(f"knn point {i}: distances differ from the "
                               "republished snapshot's")
    del rep, first, r
    torch.cuda.empty_cache()
    # the republish's capture compacted the shared store: the next query
    # re-uploads the geometry payload (here, not inside phase 6b)
    t0 = time.perf_counter()
    idx.query(QueryBatch.window(wins, "intersects"))
    torch.cuda.synchronize()
    log({"write_checks": {"relations": len(batches), "host_windows":
                          HOST_CHECK, "knn_points": len(pts),
                          "payload_reupload_batch_ms":
                          (time.perf_counter() - t0) * 1e3}})
    return launches, sync_ms


def async_phase(idx, wins, counters, read_path, sync_ms):
    """6b. Async double-buffered republish: ``async_republish`` set as the
    server sets it, the delta driven past ``refresh_threshold``, and
    1024-window ``intersects`` batches streamed while the next snapshot
    builds on the side; a delete of a record the pending snapshot holds and
    an insert land mid-build, right after the first in-flight batch. The
    first and last in-flight batches and the first after the swap equal
    the fp64 host path on 32 windows at their epochs (the first's host
    answer is taken before the stream: a host batch of 32 windows outlasts
    the build)."""
    import numpy as np
    import torch

    from repro_torch.core.datasets import generate
    from repro_torch.core.engine import QueryBatch

    idx.config = dataclasses.replace(idx.config, async_republish=True)
    src = generate("mixed", ASYNC_INSERTS, seed=4)
    fp32_exact(src)
    for i in range(ASYNC_INSERTS):
        idx.insert(ring_of(src, i), int(src.nverts[i]), int(src.kinds[i]))
    delta = idx.delta_size()
    if delta < idx.config.refresh_threshold:
        raise RuntimeError(f"delta of {delta} below the threshold")
    pubs0 = idx.stats()["snapshot_publishes"]

    def host():
        """The fp64 host path on 32 windows, through the host index itself:
        a facade query would poll (and start) the async build."""
        with idx._lock:
            return [np.sort(idx.glin.query(w, "intersects"))
                    for w in wins[:HOST_CHECK]]

    # the host's answer at the first in-flight batch's epoch, taken before
    # the stream (a host batch outlasts the build)
    want_first = host()
    for fn in counters.values():
        fn.launches = 0
    walls, first, last, victim, late = [], None, None, None, None
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        res = idx.query(QueryBatch.window(wins, "intersects"))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if idx.stats()["snapshot_publishes"] > pubs0:
            swap_s, after, after_ms = t0 - t_start, res, wall
            break
        if not (idx.republish_inflight()
                and "async republish in flight" in res.plan.reason):
            raise RuntimeError(f"no build in flight: {res.plan}")
        walls.append(wall)
        last = res
        if first is None:
            first = res
            victim = int(first.ids[1][0])    # live in the pending snapshot
            if not idx.delete(victim):
                raise RuntimeError(f"delete of record {victim} failed")
            c = (wins[0, :2] + wins[0, 2:]) / 2
            late = idx.insert(np.asarray(
                [[c[0] - 1e-4, c[1] - 1e-4], [c[0] + 1e-4, c[1] - 1e-4],
                 [c[0], c[1] + 1e-4]], np.float32).astype(np.float64), 3, 0)
        if time.perf_counter() - t_start > 300:
            raise RuntimeError("the async republish never swapped in")
    launches = read_path("async", ("refine_fused",))
    want = host()
    same_ids(first.ids[:HOST_CHECK], want_first,
             "first in-flight batch vs host")
    same_ids(last.ids[:HOST_CHECK], want if last is not first else
             want_first, "last in-flight batch vs host")
    same_ids(after.ids[:HOST_CHECK], want, "first batch after the swap vs "
             "host")
    if victim in after.ids[1] or late not in after.ids[0]:
        raise RuntimeError("mid-build writes lost across the swap")
    if not (victim in idx._tombstones and late in idx._added):
        raise RuntimeError("the swap installed the wrong delta")
    log({"async_swap": {
        "delta_at_start": delta, "batches_in_flight": len(walls),
        "batches_in_flight_after_writes": len(walls) - 1,
        "inflight_wall_ms_median": statistics.median(walls),
        "inflight_wall_ms_max": max(walls), "first_batch_ms": walls[0],
        "sync_republish_ms": sync_ms, "build_to_swap_s": swap_s,
        "after_swap_ms": after_ms, "after_swap_backend": after.plan.backend,
        "delta_after_swap": idx.delta_size()}})
    idx.config = dataclasses.replace(idx.config, async_republish=False)
    return launches


def open_loop(server, pool, rng, rate: float, seconds: float,
              profile: bool = False):
    """Poisson arrivals at ``rate`` queries/s for ``seconds`` (tenants and
    relations drawn at random, a write after SERVE_WRITE_FRAC of them),
    results collected as they resolve; latency from submit to resolution.
    With ``profile``, the window runs under ``torch.profiler`` and the
    device's busy time is summed."""
    import contextlib

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from repro_torch.serve import Rejected

    st0 = server.stats()
    pubs0 = server.index.stats()["snapshot_publishes"]
    pending = collections.deque()
    lat, shed, submitted, writes = [], 0, 0, 0
    prof = (tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if profile else contextlib.nullcontext())

    def collect(ticket, t_sub, timeout):
        nonlocal shed
        val, ts = server.result_at(ticket, timeout=timeout)
        if isinstance(val, Rejected):
            shed += 1
        else:
            lat.append(ts - t_sub)
        return ts

    with prof:
        t_begin = time.perf_counter()
        t_end, next_arrival, t_last = t_begin + seconds, t_begin, t_begin
        while time.perf_counter() < t_end:
            now = time.perf_counter()
            while next_arrival <= now:
                w = pool[rng.integers(len(pool))]
                rel = SERVE_RELATIONS[rng.integers(len(SERVE_RELATIONS))]
                pending.append((server.submit(
                    w, rel, tenant=f"tenant{rng.integers(2)}"),
                    time.perf_counter()))
                submitted += 1
                if rng.random() < SERVE_WRITE_FRAC:
                    c = rng.uniform(0.15, 0.85, 2)
                    ang = np.sort(rng.uniform(0, 2 * np.pi, 8))
                    v = np.stack([c[0] + 2e-4 * np.cos(ang),
                                  c[1] + 2e-4 * np.sin(ang)], -1)
                    server.insert(v.astype(np.float32).astype(np.float64),
                                  8, 0)
                    writes += 1
                next_arrival += rng.exponential(1.0 / rate)
            while pending:
                try:
                    t_last = collect(*pending[0], 0.0)
                except TimeoutError:
                    break
                pending.popleft()
            time.sleep(min(0.001, max(0.0, next_arrival - time.perf_counter())))
        t_sub_end = time.perf_counter()
        while pending:
            t_last = max(t_last, collect(*pending.popleft(), 120.0))
        if profile:
            torch.cuda.synchronize()
        t_done = time.perf_counter()
    st = server.stats()
    hist = {k: v - st0["batch_size_hist"].get(k, 0)
            for k, v in st["batch_size_hist"].items()}
    out = {"offered_qps": rate, "seconds": seconds,
           "submitted_qps": submitted / (t_sub_end - t_begin),
           "served_qps": len(lat) / max(t_last - t_begin, 1e-9),
           "served": len(lat), "shed": shed, "writes": writes,
           "latency_ms_p50": (float(np.percentile(lat, 50)) * 1e3
                              if lat else None),
           "latency_ms_p99": (float(np.percentile(lat, 99)) * 1e3
                              if lat else None),
           "latency_ms_max": max(lat) * 1e3 if lat else None,
           "batch_size_hist": {k: v for k, v in hist.items() if v},
           "backend_counts": {k: v - st0["backend_counts"].get(k, 0)
                              for k, v in st["backend_counts"].items()},
           "failed_batches": st["failed_batches"] - st0["failed_batches"],
           "publishes": server.index.stats()["snapshot_publishes"] - pubs0}
    if profile:
        # the device's busy time over the whole profiled window: arrivals
        # (which overrun ``seconds`` when submits fall behind) and drain
        busy = sum(e.device_time_total for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
        out["profiled_s"] = t_done - t_begin
        out["submit_window_s"] = t_sub_end - t_begin
        out["device_busy_s"] = busy
        out["device_busy_share"] = busy / (t_done - t_begin)
    if out["failed_batches"]:
        raise RuntimeError(f"{out['failed_batches']} serving batches failed")
    return out


def serve_phase(idx, gs, counters):
    """6c. The spatial serving tier on the card: ``SpatialQueryServer``
    with the reference launcher's settings, a closed loop held ticket by
    ticket against the facade and the host path, then open-loop Poisson
    traffic at two offered rates and one profiled second. The index takes
    the launcher's planner settings (``device_min_batch=1``,
    ``stale_rebuild_min_batch=1``). Returns the path's launches (the
    server's own queries; the checks' not)."""
    import numpy as np
    import torch

    from repro_torch.core.datasets import make_query_windows
    from repro_torch.core.engine import QueryBatch
    from repro_torch.serve import ServerConfig, SpatialQueryServer

    cfg = ServerConfig(replicas=2, max_queue=2048, min_batch=8,
                       max_batch=4096)
    # the launcher's planner settings: every micro-batch may take the card
    idx.config = dataclasses.replace(idx.config, device_min_batch=1,
                                     stale_rebuild_min_batch=1)
    t0 = time.perf_counter()
    pool = make_query_windows(gs, SELECTIVITY, SERVE_POOL, seed=11)
    log({"serve_pool": {"windows": len(pool), "seconds":
                        time.perf_counter() - t0}})
    rng = np.random.default_rng(12)
    kernels = ("refine_fused", "refine_compact", "knn_topk")
    for fn in counters.values():
        fn.launches = 0
    # ---- closed loop: submit, interleave writes, flush, check every ticket
    server = SpatialQueryServer(idx, async_republish=True, config=cfg)
    sub, writes = [], 0
    for i in range(SERVE_CLOSED):
        w = pool[rng.integers(len(pool))]
        rel = SERVE_RELATIONS[rng.integers(len(SERVE_RELATIONS))]
        sub.append((server.submit(w, rel, tenant=f"tenant{i % 2}"), w, rel))
        if rng.random() < SERVE_WRITE_FRAC:
            c = (w[:2] + w[2:]) / 2 + rng.uniform(-1e-3, 1e-3, 2)
            ang = np.sort(rng.uniform(0, 2 * np.pi, 8))
            v = np.stack([c[0] + 2e-4 * np.cos(ang),
                          c[1] + 2e-4 * np.sin(ang)], -1)
            server.insert(v.astype(np.float32).astype(np.float64), 8, 0)
            writes += 1
    kpts = np.stack([(pool[j, :2] + pool[j, 2:]) / 2 for j in
                     rng.integers(len(pool), size=SERVE_KNN)])
    kpts = kpts.astype(np.float32).astype(np.float64)
    ktick = [server.submit_knn(p, KNN_KS[0]) for p in kpts]
    t0 = time.perf_counter()
    out = server.flush()
    torch.cuda.synchronize()
    flush_ms = (time.perf_counter() - t0) * 1e3
    served = {kn: counters[kn].launches for kn in kernels}
    for rel in SERVE_RELATIONS:
        items = [(t, w) for t, w, r in sub if r == rel]
        ws = np.stack([w for _, w in items])
        want = idx.query(QueryBatch.window(ws, rel))
        for (t, _), ids in zip(items, want.ids):
            if not np.array_equal(out[t], ids):
                raise RuntimeError(f"ticket {t} ({rel}) differs from "
                                   "index.query")
        head = [(t, w) for t, w, r in sub[:HOST_CHECK] if r == rel]
        if head:
            host = idx.query(QueryBatch.window(
                np.stack([w for _, w in head]), rel, backend="host"))
            same_ids([out[t] for t, _ in head], host.ids,
                     f"closed loop {rel} vs host")
    host = idx.query(QueryBatch.knn(kpts, KNN_KS[0], backend="host"))
    for i, t in enumerate(ktick):
        ids, d = out[t]
        if not (np.array_equal(ids, host.ids[i])
                and np.allclose(d, host.distances[i], rtol=1e-4, atol=1e-7)):
            raise RuntimeError(f"submit_knn point {i} differs from the host")
    st = server.stats()
    log({"serve_closed": {"submitted": SERVE_CLOSED, "knn": SERVE_KNN,
                          "writes": writes, "flush_ms": flush_ms,
                          "backend_counts": st["backend_counts"],
                          "batch_size_hist": st["batch_size_hist"],
                          "replica_queries": st["replica_queries"],
                          "coalesced": st["coalesced"],
                          "checked_vs_index": SERVE_CLOSED,
                          "checked_vs_host": HOST_CHECK + SERVE_KNN}})
    # ---- open loop
    for fn in counters.values():
        fn.launches = 0
    for rate in SERVE_RATES:
        server = SpatialQueryServer(idx, async_republish=True, config=cfg)
        server.start()
        try:
            run_ = open_loop(server, pool, rng, rate, SERVE_SECONDS)
        finally:
            server.stop()
        log({"serve_open": run_})
    server = SpatialQueryServer(idx, async_republish=True, config=cfg)
    server.start()
    try:
        run_ = open_loop(server, pool, rng, SERVE_RATES[-1], 1.0,
                         profile=True)
    finally:
        server.stop()
    log({"serve_profiled_second": run_})
    inflight = idx._inflight
    if inflight is not None and not inflight.done.wait(300):
        raise RuntimeError("an async republish never finished")
    for kn in kernels:
        served[kn] += counters[kn].launches
    log({"path": "serve", "launches": served})
    for kn, n in served.items():
        if n == 0:
            raise RuntimeError(f"{kn} never launched on the serve path")
    return served


def sharded_phase(idx, wins, wins_hi, pts, counters, read_path):
    """6d. The sharded backend on phase 3's store (after 6a-6c's writes): a
    second facade over the same host tree at the same epoch with a (4, 2)
    mesh, every position on ``cuda:(i % device_count)`` (on one card, all
    eight). The path: window batches for every relation, the 1e-3 ladder
    batch and kNN at k = 10 and 100, planned ``sharded``. Each equal to the
    primary facade's ``device`` batch and (windows) to the fp64 host path
    on :data:`HOST_CHECK` windows (the ladder's too). Outside the path's
    counts, the compact kernel on one (shard, model) position of the main
    batch and one of the ladder batch against its plain version on that
    shard's tables, and the k-merge's top-k (grabbed from one more kNN
    batch) against the plain two-key sort.
    Then a second path: 64 inserts (a triangle in each of the first 64
    windows) and 16 deletes (a hit of each of the first 16) through the
    sharded facade and one ``intersects`` batch served sharded with the
    delta patched on top, equal to the host path. Returns the two paths' launches
    of the compact and top-k kernels."""
    import numpy as np
    import torch

    from repro_torch.core import distributed as tdist
    from repro_torch.core.engine import EngineConfig, QueryBatch, SpatialIndex
    from repro_torch.kernels import knn as kk
    from repro_torch.kernels import refine as kr

    t_phase = time.perf_counter()
    ncard = torch.cuda.device_count()
    devices = [torch.device("cuda", i % ncard) for i in range(8)]
    mesh = tdist.make_mesh(SHARD_MESH, ("data", "model"), devices)
    idx.snapshot()        # the primary facade at the tree's current state
    sf = SpatialIndex(idx.glin, EngineConfig(mesh=mesh, shard_min_records=1),
                      device=DEVICE)
    t0 = time.perf_counter()
    sf.snapshot()
    t1 = time.perf_counter()
    snaps, table, shards, maxw = sf._sharded_placement()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    per_card = collections.Counter(str(d) for _, _, d in
                                   tdist.mesh_positions(mesh))
    log({"sharded_mesh": {
        "shape": dict(mesh.shape), "positions_per_card": dict(per_card),
        "shards": shards, "slots_per_shard": table.local_n,
        "shard_bytes": {f"{s}@{d}": t.nbytes()
                        for (s, d), t in table.tables.items()},
        "walk_leaves": [table.at(s, mesh.flat[s * SHARD_MESH[1]])
                        .walk.leaf_mbr.shape[0] for s in range(shards)],
        "padding_slots": int(sum((t.recs < 0).sum()
                                 for t in table.tables.values())),
        "max_width": maxw, "publish_ms": (t1 - t0) * 1e3,
        "placement_ms": (t2 - t1) * 1e3}})
    kernels = ("refine_compact", "knn_topk")
    for fn in counters.values():
        fn.launches = 0

    def sharded(name, batch, **fields):
        before = {kn: counters[kn].launches for kn in kernels}
        t0 = time.perf_counter()
        res = sf.query(batch)
        torch.cuda.synchronize()
        st = res.stages[0]
        log({"batch": name, "queries": len(batch),
             "wall_ms": (time.perf_counter() - t0) * 1e3,
             "backend": res.plan.backend, "reason": res.plan.reason,
             "impl": st.impl, "dispatches": st.dispatches,
             "escalations": st.escalations, "cap": st.cap,
             "budget": st.budget, "merge_bytes": st.merge_bytes,
             "rungs": st.rungs, "hits": res.total_hits,
             "launches": {kn: counters[kn].launches - before[kn]
                          for kn in kernels}, **fields})
        if res.plan.backend != "sharded" or st.impl != "sharded":
            raise RuntimeError(f"{name}: not sharded ({res.plan})")
        return res

    # the path: every relation's window batch, the ladder batch and kNN,
    # planned sharded by the facade
    checks = []
    for rel in FACADE_RELATIONS:
        batch = wins[:DISJOINT_WINDOWS] if rel == "disjoint" else wins
        got = sharded("sharded", QueryBatch.window(batch, rel), relation=rel)
        checks.append((rel, batch, got))
    ladder = sharded("sharded[ladder]",
                     QueryBatch.window(wins_hi, "intersects"),
                     relation="intersects", selectivity=LADDER_SELECTIVITY)
    if ladder.stages[0].escalations < 1:
        raise RuntimeError("the sharded ladder batch never escalated")
    knn = {k: sharded("knn[sharded]", QueryBatch.knn(pts, k), k=k)
           for k in KNN_KS}
    for k, res in knn.items():
        if res.stages[0].merge_bytes <= 0 or any(len(r) != k
                                                 for r in res.ids):
            raise RuntimeError(f"sharded knn k={k}: {res.stages[0]}")
    launches = read_path("sharded", kernels)

    # the checks at the same epoch: the primary facade's device batches (its
    # own kernels, not counted) and the host path on 32 windows
    t0 = time.perf_counter()
    for rel, batch, got in checks:
        dev_res = idx.query(QueryBatch.window(batch, rel, backend="device"))
        same_ids(got.ids, dev_res.ids, f"{rel}: sharded vs device")
    same_ids(ladder.ids, idx.query(QueryBatch.window(
        wins_hi, "intersects", backend="device")).ids,
        "ladder: sharded vs device")
    knn_err = {}
    for k, res in knn.items():
        d = idx.query(QueryBatch.knn(pts, k))
        if d.plan.backend != "device":
            raise RuntimeError(f"primary facade kNN plan {d.plan}")
        same_ids(res.ids, d.ids, f"knn k={k}: sharded vs device")
        err = 0.0
        for a, b in zip(res.distances, d.distances):
            if not np.allclose(a, b, rtol=1e-4, atol=1e-7):
                raise RuntimeError(f"knn k={k}: sharded distances off the "
                                   "device's")
            err = max(err, float(np.abs(a - b).max()))
        knn_err[k] = err
    t1 = time.perf_counter()
    for rel, batch, got in checks:
        host = sf.query(QueryBatch.window(batch[:HOST_CHECK], rel,
                                          backend="host"))
        same_ids(got.ids[:HOST_CHECK], host.ids, f"{rel}: sharded vs host")
    same_ids(ladder.ids[:HOST_CHECK], sf.query(QueryBatch.window(
        wins_hi[:HOST_CHECK], "intersects", backend="host")).ids,
        "ladder: sharded vs host")
    t2 = time.perf_counter()

    # the kernels on shard tables, outside the path's counts: B1 with the
    # shard's walk against its plain version on the slot-aligned tables,
    # at the (shard, model 0) position with the most run slots of the main
    # batch (at the budget) and of the ladder (at the kNN ladder's 4096)
    model = mesh.shape["model"]
    for name, w_np, budget in (
            ("refine_compact[shard]", wins[:len(wins) // model], BUDGET),
            ("refine_compact[shard, ladder]",
             wins_hi[:len(wins_hi) // model], 4096)):
        runs = []
        for shard in range(shards):
            dev0 = mesh.flat[shard * model]
            t = table.at(shard, dev0)
            w = torch.from_numpy(w_np.astype(np.float32)).to(dev0)
            lo, hi = tdist._local_bounds(snaps[dev0], w, t, "intersects")
            runs.append((int((hi - lo).sum()), shard, t, w,
                         torch.stack([lo, hi], 1)))
        _, shard, t, w, b = max(runs, key=lambda r: r[:2])
        lo, hi = b[:, 0], b[:, 1]
        got = kr.refine_compact(w, b, t.lmbrs, t.mbrs, budget=budget,
                                leaves=t.walk)
        want = kr.refine_compact_plain(w, b, t.lmbrs, t.mbrs, budget)
        log({"name": name, "shard": shard, "queries": w.shape[0],
             "slots": t.local_n, "walk_leaves": t.walk.leaf_mbr.shape[0],
             "budget": budget, "run_slots": int((hi - lo).sum()),
             "survivors": int(want[1].sum()),
             **compare(name, got, want),
             "kernel_ms": cuda_ms(lambda: kr.refine_compact(
                 w, b, t.lmbrs, t.mbrs, budget=budget, leaves=t.walk), 10),
             "plain_ms": cuda_ms(lambda: kr.refine_compact_plain(
                 w, b, t.lmbrs, t.mbrs, budget), 2)})
    # B3's k-merge: the (Q, shards * k) blocks of one more sharded kNN
    # batch (the wrapper counts into the stand-in meanwhile)
    grabbed, real_topk = {}, kk.knn_topk

    def grab_topk(d, ids, k):
        if d.shape[1] == shards * k:
            grabbed.setdefault(k, (d.clone(), ids.clone()))
        return real_topk(d, ids, k)

    grab_topk.launches = 0
    kk.knn_topk = grab_topk
    try:
        sf.query(QueryBatch.knn(pts, KNN_KS[0]))
    finally:
        kk.knn_topk = real_topk
    k = KNN_KS[0]
    if k not in grabbed:
        raise RuntimeError("no k-merge top-k was launched")
    d, ids = grabbed[k]
    log({"name": "knn_topk[k-merge]", "shape": [*d.shape, k],
         **kk.knn_plan(d.shape[1]),
         **compare("knn_topk[k-merge]", kk.knn_topk(d, ids, k),
                   kk.knn_topk_plain(d, ids, k)),
         "kernel_ms": cuda_ms(lambda: kk.knn_topk(d, ids, k), 25),
         "plain_ms": cuda_ms(lambda: kk.knn_topk_plain(d, ids, k), 10)})

    # the delta: written through the sharded facade (the primary facade is
    # not queried after: it does not see these writes), patched on top. A
    # small triangle at the centre of each of the first 64 windows, and the
    # deletes of a hit of each of the first 16 (so the host check sees both)
    added = []
    for x, y in (wins[:SHARD_INSERTS, :2] + wins[:SHARD_INSERTS, 2:]) / 2:
        tri = np.asarray([[x - 1e-4, y - 1e-4], [x + 1e-4, y - 1e-4],
                          [x, y + 1e-4]], np.float32).astype(np.float64)
        added.append(sf.insert(tri, 3, 0))
    dead = []
    for row in checks[0][2].ids[:SHARD_DELETES]:       # intersects
        rec = next(int(r) for r in row if int(r) not in dead)
        if not sf.delete(rec):
            raise RuntimeError(f"delete of record {rec} failed")
        dead.append(rec)
    for fn in counters.values():
        fn.launches = 0
    patched = sharded("sharded[delta]", QueryBatch.window(wins,
                                                          "intersects"),
                      relation="intersects", delta=sf.delta_size())
    delta_launches = read_path("sharded delta", ("refine_compact",))
    st = {s_.stage: s_ for s_ in patched.stages}["delta-patch"]
    if "patched on top" not in patched.plan.reason or (
            st.delta_added, st.delta_tombstoned) != (SHARD_INSERTS,
                                                     SHARD_DELETES):
        raise RuntimeError(f"delta not patched: {patched.plan}")
    if not (all(a in r for a, r in zip(added, patched.ids))
            and not any(np.isin(dead, r).any() for r in patched.ids)):
        raise RuntimeError("the delta is not reflected by the patch")
    t3 = time.perf_counter()
    host = sf.query(QueryBatch.window(wins[:HOST_CHECK], "intersects",
                                      backend="host"))
    same_ids(patched.ids[:HOST_CHECK], host.ids,
             "delta: sharded patched vs host")
    log({"sharded_checks": {
        "relations": len(checks), "device_windows": len(wins),
        "ladder_windows": len(wins_hi),
        "host_windows": HOST_CHECK,
        "knn_points": len(pts), "knn_max_abs_err_vs_device": knn_err,
        "delta_inserts_hit": sum(int(a in r) for a, r in
                                 zip(added, host.ids)),
        "delta_deletes": len(dead),
        "device_checks_s": t1 - t0,
        "host_checks_s": t2 - t1 + time.perf_counter() - t3}})
    for kn, n in delta_launches.items():
        launches[kn] += n
    del sf, snaps, table
    torch.cuda.empty_cache()
    log({"sharded_phase_s": time.perf_counter() - t_phase})
    return launches


def baselines_phase(idx, wins, counters, read_path):
    """5b. The paper's baselines (``core.baselines``: ``RTree``,
    ``QuadTree``, ``SortedArray``; host structures, as in the reference) on
    phase 3's store as the facade holds it after phase 5's write (one
    record inserted, one deleted: each tree deletes the facade's dead
    records after its build, ``SortedArray``, which cannot delete, has
    them filtered from its answers). Each tree's build wall and
    ``stats()`` index bytes beside GLIN's ``total_index_bytes``; the first
    :data:`BASE_WINDOWS` main windows for ``intersects`` and ``contains``
    through each tree (per-window ms beside the fused 1024-window batch's
    wall over its windows), ids equal to that fused batch and to the fp64
    host path; ``SortedArray`` on :data:`BASE_SORTED_WINDOWS` of them for
    :data:`BASE_SORTED_RELATIONS`;
    then :data:`BASE_MAINTAIN` published records (hits of those windows)
    deleted from each tree and inserted again, per operation, and the
    windows once more with the same checks. Returns the path's launches
    of the fused kernel (the facade's batches)."""
    import numpy as np
    import torch

    from repro_torch.core.baselines import QuadTree, RTree, SortedArray
    from repro_torch.core.engine import QueryBatch

    t_phase = time.perf_counter()
    gs = idx.gs
    live = idx.glin._live_mask()
    dead = np.flatnonzero(~live)
    glin_bytes = idx.stats()["total_index_bytes"]
    w = wins[:BASE_WINDOWS]
    for fn in counters.values():
        fn.launches = 0
    fused, host = {}, {}
    for rel in BASE_RELATIONS:
        idx.query(QueryBatch.window(wins, rel))      # allocations, untimed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = idx.query(QueryBatch.window(wins, rel))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if not (res.plan.backend == "device" and res.plan.fused):
            raise RuntimeError(f"baselines: the facade's {rel} batch did not "
                               f"take the fused plan ({res.plan})")
        t0 = time.perf_counter()
        h = idx.query(QueryBatch.window(w, rel, backend="host"))
        host_ms = (time.perf_counter() - t0) * 1e3
        same_ids(res.ids[:BASE_WINDOWS], h.ids, f"baselines: {rel} fused vs "
                 "host")
        fused[rel], host[rel] = res.ids[:BASE_WINDOWS], h.ids
        log({"baselines_facade": {
            "relation": rel, "windows": len(wins), "fused_wall_ms": wall,
            "fused_ms_per_window": wall / len(wins),
            "host_windows": BASE_WINDOWS, "host_ms": host_ms,
            "host_ms_per_window": host_ms / BASE_WINDOWS,
            "hits_first_windows": int(sum(len(r) for r in fused[rel]))}})
    launches = read_path("baselines", ("refine_fused",))

    def through(tree, name, windows, tag, filt=None, rels=BASE_RELATIONS):
        """Each window through ``tree``, one at a time: ids (ascending)
        against the fused batch's and the host path's, and the walls."""
        per = {}
        for rel in rels:
            walls, got = [], []
            for row in windows:
                t0 = time.perf_counter()
                ids = np.sort(tree.query(row, rel))
                walls.append((time.perf_counter() - t0) * 1e3)
                got.append(ids if filt is None else ids[filt[ids]])
            n = len(got)
            same_ids(got, fused[rel][:n], f"baselines: {name} {rel} vs fused")
            same_ids(got, host[rel][:n], f"baselines: {name} {rel} vs host")
            per[rel] = {"windows": n, "ms_per_window": statistics.mean(walls),
                        "ms_per_window_median": statistics.median(walls),
                        "ms_per_window_max": max(walls)}
        log({"baselines_query": {"index": name, "pass": tag, **per}})

    trees = {}
    for cls in (RTree, QuadTree):
        t0 = time.perf_counter()
        tree = cls.build(gs)
        build_s = time.perf_counter() - t0
        for rec in dead:
            if not tree.delete(int(rec)):
                raise RuntimeError(f"baselines: {cls.__name__} lost record "
                                   f"{rec}")
        st = tree.stats()
        log({"baselines_build": {
            "index": cls.__name__, "records": len(gs),
            "dead_deleted": len(dead), "build_s": build_s, **st,
            "glin_total_index_bytes": glin_bytes,
            "bytes_over_glin": st["index_bytes"] / glin_bytes}})
        trees[cls.__name__] = tree
        through(tree, cls.__name__, w, "built")
    t0 = time.perf_counter()
    sa = SortedArray.build(gs, idx.glin.cfg.piece_limitation)
    sa_s = time.perf_counter() - t0
    log({"baselines_build": {"index": "SortedArray", "records": len(gs),
                             "build_s": sa_s, **sa.stats(),
                             "glin_total_index_bytes": glin_bytes}})
    through(sa, "SortedArray", w[:BASE_SORTED_WINDOWS], "built", filt=live,
            rels=BASE_SORTED_RELATIONS)

    # maintenance: published records that the windows hit, deleted from
    # each tree and inserted again (dead records stay out of both lists)
    hits = np.unique(np.concatenate(fused["intersects"]))
    rng = np.random.default_rng(7)
    recs = rng.choice(hits, min(BASE_MAINTAIN, hits.size), replace=False)
    if recs.size < BASE_MAINTAIN:
        rest = np.setdiff1d(np.flatnonzero(live), recs)
        recs = np.concatenate([recs, rng.choice(rest, BASE_MAINTAIN
                                                - recs.size, replace=False)])
    for name, tree in trees.items():
        walls = {"delete": [], "insert": []}
        for rec in recs:
            t0 = time.perf_counter()
            ok = tree.delete(int(rec))
            walls["delete"].append((time.perf_counter() - t0) * 1e3)
            if not ok:
                raise RuntimeError(f"baselines: {name} could not delete "
                                   f"record {rec}")
        for rec in recs:
            t0 = time.perf_counter()
            tree.insert(int(rec))
            walls["insert"].append((time.perf_counter() - t0) * 1e3)
        log({"baselines_maintenance": {
            "index": name, "records": len(recs),
            **{f"{op}_ms_per_op": statistics.mean(t)
               for op, t in walls.items()},
            **{f"{op}_ms_per_op_median": statistics.median(t)
               for op, t in walls.items()},
            **{f"{op}_ops_per_s": len(t) / (sum(t) / 1e3)
               for op, t in walls.items()},
            "index_bytes_after": tree.stats()["index_bytes"]}})
        through(tree, name, w, "after maintenance")
    log({"baselines_phase_s": time.perf_counter() - t_phase})
    return launches


def examples_phase(counters, read_path):
    """5c. The port's three GLIN examples, each ``main`` called in-process
    on the card at the verify skill's sizes (their own checks raise on a
    mismatch); the sharded example's hits also against its facade's
    ``device`` batch (both fp32). Returns the path's launches of the fused
    kernel (quickstart's batched query, the serving loop's batches)."""
    import numpy as np
    import torch

    from repro_torch.core.engine import QueryBatch
    from repro_torch.examples import distributed_glin, quickstart, \
        serve_queries

    for fn in counters.values():
        fn.launches = 0
    for mod in (quickstart, serve_queries, distributed_glin):
        name = mod.__name__.rsplit(".", 1)[1]
        argv = EXAMPLES_ARGS[name]
        t0 = time.perf_counter()
        out = mod.main(argv)
        torch.cuda.synchronize()
        line = {"example": name, "argv": argv,
                "wall_s": time.perf_counter() - t0}
        if name == "quickstart":
            line.update(batched_backend=out["batched"].plan.backend,
                        batched_hits=out["batched"].total_hits)
        elif name == "serve_queries":
            line.update({k: out[k] for k in ("total_hits", "writes",
                                              "refreshes", "backends",
                                              "p50_ms", "qps")})
        else:
            hits, index = out["hits"], out["index"]
            dev = index.query(QueryBatch.window(
                out["windows"].astype(np.float64), "intersects",
                backend="device"))
            same_ids([np.sort(h[h >= 0]) for h in hits.reshape(
                len(out["windows"]), -1)], dev.ids,
                "distributed_glin vs the device batch")
            line.update(ms_per_batch=out["ms_per_batch"],
                        hits=int(out["counts"].sum()),
                        devices=[str(d) for d in
                                 out["mesh"].distinct_devices()])
        log(line)
        del out
    torch.cuda.empty_cache()
    return read_path("examples", ("refine_fused",))


def band_pairs(s: int, window: int) -> int:
    """(query, key) pairs of a causal, optionally windowed, prompt of s."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def att_bound(got, want) -> tuple:
    """(max abs error, worst share of the bound, whether every element
    passes): an element passes within ATT_TOL of its dtype (strictly, as
    before) or, for bf16, within one bf16 step of |want|."""
    import torch

    d = (got.float() - want.float()).abs()
    tol = ATT_TOL[str(want.dtype).split(".")[1]]
    ok, lim = d < tol, torch.full_like(d, tol)
    if want.dtype == torch.bfloat16:
        w = want.float().abs().clamp(min=2.0 ** -126)
        step = torch.exp2(torch.floor(torch.log2(w)) - BF16_MANTISSA_BITS)
        ok |= d <= step
        lim = torch.maximum(lim, step)
    return float(d.max()), float((d / lim).max()), bool(ok.all())


def lse_check(katt, args, win, name: str) -> dict:
    """B8's log-sum-exp output (``return_lse``) against its plain
    version's on ``args``: within ATT_TOL's fp32 bound, -inf on the same
    (row, head)s; the output unchanged by asking for it. Raises past it."""
    import torch

    out, lse = katt.decode_attention(*args, win, return_lse=True)
    _, want = katt.decode_attention_plain(*args, win, return_lse=True)
    empty = torch.isneginf(want)
    same_empty = bool(torch.equal(torch.isneginf(lse), empty))
    err = (float((lse[~empty] - want[~empty]).abs().max())
           if bool((~empty).any()) else 0.0)
    line = {"lse_max_abs_err": err, "lse_tolerance": ATT_TOL["float32"],
            "lse_rows_heads_without_live_slot": int(empty.sum()),
            "lse_empty_equal": same_empty,
            "lse_output_unchanged": bool(torch.equal(
                out, katt.decode_attention(*args, win)))}
    if not (same_empty and err < ATT_TOL["float32"]
            and line["lse_output_unchanged"]):
        raise RuntimeError(f"{name}: the log-sum-exp differs from the "
                           f"plain version's ({line})")
    return line


def attention_check(katt, label, name, case, args, win) -> dict:
    """``katt.<name>`` (``flash_attention`` or ``decode_attention``)
    against its plain version on ``args`` (a layer's captured inputs) at
    window ``win``, within :func:`att_bound` (raises past it); a bf16 case
    also
    timed by queued events beside the plain version and SDPA on the same
    inputs, with the least time the card could take (the q/k/v bytes, or
    the causal or windowed band's products at the bf16 rate; for decode the
    live slots' K/V). Logs and returns the line ``name[label case]``."""
    import torch
    import torch.nn.functional as F

    kern = getattr(katt, name)
    plain = getattr(katt, name + "_plain")
    got_, want_ = kern(*args, win), plain(*args, win)
    err, share, ok = att_bound(got_, want_)
    tol = ATT_TOL[str(args[0].dtype).split(".")[1]]
    line = {"name": f"{name}[{label} {case}]",
            "shape": {"q": list(args[0].shape), "k": list(args[1].shape)},
            "window": win, "max_abs_err": err, "tolerance": tol,
            "worst_share_of_bound": share,
            "plain_max_abs": float(want_.float().abs().max())}
    if not ok:
        raise RuntimeError(f"{name}[{label} {case}]: max abs err {err} "
                           f"from the plain version, past its bound "
                           f"({line})")
    if name == "decode_attention":
        line.update(lse_check(katt, args, win, line["name"]))
    if args[0].dtype != torch.bfloat16:
        log(line)
        return line
    q, k, v = args[:3]
    if name == "flash_attention":
        b_, hq, s_, d_ = q.shape
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        ops = 4 * b_ * hq * d_ * band_pairs(s_, win)
        qi = torch.arange(s_, device=q.device)
        band = None if win <= 0 or s_ <= win else (
            (qi[:, None] >= qi[None, :]) & (qi[:, None] - qi[None, :] < win))

        def lib():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=band, is_causal=band is None,
                enable_gqa=True)
        line["plan"] = katt.flash_plan(b_, k.shape[1], hq // k.shape[1],
                                       s_, d_, q.dtype)
        call = ("torch.nn.functional.scaled_dot_product_attention ("
                + ("is_causal" if band is None
                   else "boolean causal window band") + ", enable_gqa)")
    else:
        b_, hq, d_ = q.shape
        apos, p_ = args[3], args[4]
        valid = (apos >= 0) & (apos <= p_[:, None])
        if win > 0:
            valid &= p_[:, None] - apos < win
        live = int(valid.sum())
        hkv = k.shape[1]
        nbytes = (2 * live * hkv * d_ * 2 + 2 * 2 * q.numel()
                  + apos.numel() * 4 + p_.numel() * 4)
        ops = 4 * live * hq * d_
        mask = valid[:, None, None, :]

        def lib():
            return F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=mask,
                enable_gqa=True)[:, :, 0]
        line.update(live_slots=live, plan=katt.decode_plan(b_, k.shape[1]))
        call = ("torch.nn.functional.scaled_dot_product_attention "
                "(boolean mask from abs_pos/pos"
                + (" and the window" if win > 0 else "") + ", enable_gqa)")
    line.update({
        "kernel_ms": queued_ms(lambda: kern(*args, win), 50),
        "event_ms": cuda_ms(lambda: kern(*args, win), 25),
        "plain_ms": queued_ms(lambda: plain(*args, win), 20),
        "library_ms": queued_ms(lib, 50),
        "library_event_ms": cuda_ms(lib, 25),
        "library_call": call,
        "library_max_abs_err": max_err(lib(), want_),
        **bound(nbytes, ops, BF16_OPS_PER_S)})
    log(line)
    return line


def hybrid_phase(katt, kssd, counters) -> tuple:
    """10. Hybrid serving on the port: ``hymba_1p5b`` at full width in bf16
    behind ``SlotServer``, then the three kernels against their plain
    versions at its shapes, decode against the full forward and the kernel
    path against the plain path. Returns ({kernel: its hymba result line},
    {kernel: launches of the serving run})."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import SlotServer
    from repro_torch.models import attention as mattn
    from repro_torch.models import ssm as mssm
    from repro_torch.models import transformer as tf
    from repro_torch.utils.tree import leaves

    t_phase = time.perf_counter()
    cfg = get_arch(HYBRID_ARCH)
    meta, win = cfg.meta_tokens, cfg.window
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, 0, device=DEVICE)
    server = SlotServer(cfg, params, HYBRID_SLOTS, HYBRID_CTX, DEVICE)
    torch.cuda.synchronize()
    log({"lm_hybrid_model": {
        "arch": HYBRID_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim, "window": win, "meta_tokens": meta,
        "ssm_heads": cfg.ssm_heads, "ssm_head_dim": cfg.ssm_head_dim,
        "ssm_state": cfg.ssm_state, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
        "dtype": cfg.dtype,
        "params": sum(t.numel() for t in leaves(params)),
        "param_count": cfg.param_count(),
        "weight_bytes": sum(t.numel() * t.element_size()
                            for t in leaves(params)),
        "cache_bytes": sum(t.numel() * t.element_size()
                           for t in leaves(server.cache)),
        "init_s": time.perf_counter() - t0}})
    if sum(t.numel() for t in leaves(params)) != cfg.param_count():
        raise RuntimeError("hymba_1p5b: the parameter tree does not count "
                           "param_count()")

    # ------------------------------------------------ serve the requests
    run = serve(server, cfg, counters, HYBRID_REQUESTS, HYBRID_PROMPT,
                HYBRID_CTX)
    prompts, cur = run.prompts, run.cur
    got = {k: fn.launches for k, fn in counters.items()}
    log({"path": "lm hybrid serving", "launches": got})
    steps = len(run.step_ms)
    launches = {"flash_attention": got["flash_attention"],
                "decode_attention": got["decode_attention"],
                "ssd_scan": got["ssd_scan"]}
    want = {"flash_attention": cfg.n_layers * HYBRID_REQUESTS,
            "decode_attention": cfg.n_layers * steps,
            "ssd_scan": cfg.n_layers * HYBRID_REQUESTS}
    if launches != want or any(n for k, n in got.items() if k not in want):
        raise RuntimeError(f"hybrid serving: launches {got}, expected "
                           f"{want} and nothing else")
    line = serving_line(run, HYBRID_SLOTS, HYBRID_CTX, HYBRID_PROMPT,
                        base_mem, launches)
    line["max_position"] = int(server.cache["attn"]["pos"].max())
    log({"lm_hybrid_serving": line})
    prof_wall, dev, n_kernels = profiled(lambda: server.step(cur), reps=4)
    busy = sum(dev.values())
    log({"lm_hybrid_decode_profile": {
        "steps": 4, "wall_ms_per_step": prof_wall,
        "device_ms_per_step": busy, "device_kernels_per_step": n_kernels,
        "device_busy_share": busy / prof_wall if dev else None,
        "top_kernels": dict(sorted(dev.items(), key=lambda kv: -kv[1])[:8])}})

    # ---------------- the three kernels against their plain versions
    # layer 0's inputs of a real prefill and decode step (the meta tokens
    # and a 512-token prompt: 640 positions), and of a prefill of two
    # 1,024-token prompts (1,152 positions: the window slides) and its
    # decode step (a ring that wraps)
    cap = {}

    def grab(tag):
        def wrap(mod, name):
            def wrapper(*args, **kw):
                cap.setdefault(name.split("_")[0] + tag, tuple(
                    t.clone() for t in args[:5]
                    if isinstance(t, torch.Tensor)))
                return getattr(mod, name)(*args, **kw)
            return wrapper
        return (types.SimpleNamespace(
                    flash_attention=wrap(katt, "flash_attention"),
                    decode_attention=wrap(katt, "decode_attention")),
                types.SimpleNamespace(ssd_scan=wrap(kssd, "ssd_scan")))

    long = torch.from_numpy(np.stack([np.concatenate(prompts[i:i + 2])
                                      for i in (0, 2)])).to(DEVICE)
    try:
        mattn.katt, mssm.kssd = grab("")
        server.admit(0, prompts[0], 1)
        server.step(cur)
        mattn.katt, mssm.kssd = grab("_w")
        _, cache_w = tf.prefill(params, cfg, {"tokens": long},
                                seq_len_cache=HYBRID_CTX)
        tf.decode_step(params, cfg, {"tokens": long[:, 0]}, cache_w)
        del cache_w
    finally:
        mattn.katt, mssm.kssd = katt, kssd
    ap, pos = cap["decode_w"][3], cap["decode_w"][4]
    if not (cap["flash_w"][0].shape[2] == long.shape[1] + meta > win
            and ap.shape[1] == win and int(pos.min()) > win):
        raise RuntimeError("hybrid: the long prompt's window did not slide "
                           "or its ring did not wrap")

    att_cases = [("flash_attention", "bf16", cap["flash"]),
                 ("flash_attention", "fp32", fp32_args(cap["flash"])),
                 ("flash_attention", f"bf16 S {long.shape[1] + meta}",
                  cap["flash_w"]),
                 ("decode_attention", "bf16", cap["decode"]),
                 ("decode_attention", "fp32", fp32_args(cap["decode"])),
                 ("decode_attention", "bf16 wrapped", cap["decode_w"])]
    results = {}
    for name, case, args in att_cases:
        line = attention_check(katt, "hymba", name, case, args, win)
        if case == "bf16":
            results[name] = line

    x, dt, a, bm, cm = cap["ssd"]
    g = torch.Generator(device=DEVICE).manual_seed(0)
    synth = (torch.randn(x.shape, device=DEVICE, generator=g),
             torch.rand(dt.shape, device=DEVICE, generator=g) * 0.099 + 0.001,
             -(torch.rand(a.shape, device=DEVICE, generator=g) * 0.9 + 0.1),
             torch.randn(bm.shape, device=DEVICE, generator=g),
             torch.randn(cm.shape, device=DEVICE, generator=g))

    def as_dtype(args, dtype):
        return (args[0].to(dtype), args[1], args[2], args[3].to(dtype),
                args[4].to(dtype))

    chunk = cfg.ssd_chunk
    for case, args in (("real bf16", cap["ssd"]),
                       ("real fp32", as_dtype(cap["ssd"], torch.float32)),
                       (f"real bf16 S {long.shape[1] + meta}", cap["ssd_w"]),
                       ("synthetic bf16", as_dtype(synth, torch.bfloat16)),
                       ("synthetic fp32", synth)):
        line = ssd_check(kssd, f"ssd_scan[hymba {case}]", args, chunk)
        if case == "real bf16":
            line.update({
                "kernel_ms": queued_ms(lambda: kssd.ssd_scan(
                    *args, chunk, return_state=True), 50),
                "event_ms": cuda_ms(lambda: kssd.ssd_scan(
                    *args, chunk, return_state=True), 25),
                "plain_ms": queued_ms(lambda: kssd.ssd_scan_plain(
                    *args, chunk, return_state=True), 20),
                "library_ms": None,
                **ssd_bound(args[0], args[1], args[3], kssd.TILE)})
            results["ssd_scan"] = line
        log(line)
    del cap, synth

    # ----- decode against the full forward, the kernel path against plain
    del server
    torch.cuda.empty_cache()
    seq, two, feed = token_inputs(prompts, cfg.vocab, HYBRID_TEACHER_STEPS)
    lm_path_checks(
        "hybrid", params, cfg, [Probe(seq, HYBRID_FORWARD_PROMPT)], two, feed,
        {"flash_attention": (katt.flash_attention, "prefill"),
         "decode_attention": (katt.decode_attention, "decode"),
         "ssd_scan": (kssd.ssd_scan, "prefill")},
        [(mattn, "katt", types.SimpleNamespace(
            flash_attention=katt.flash_attention_plain,
            decode_attention=katt.decode_attention_plain)),
         (mssm, "kssd", types.SimpleNamespace(ssd_scan=kssd.ssd_scan_plain))],
        depths=HYBRID_DEPTHS, ctx=HYBRID_CTX)
    log({"lm_hybrid_phase_s": time.perf_counter() - t_phase})
    torch.cuda.empty_cache()
    return results, launches


def grab_attention(katt, fn) -> dict:
    """Run ``fn`` with a stand-in for ``models.attention.katt`` that keeps
    a copy of the first flash and the first decode launch's tensors (layer
    0's q, k, v[, abs_pos, pos], in the layouts the model hands in) and
    passes every launch on to the kernels."""
    import torch

    from repro_torch.models import attention as mattn

    cap = {}

    def wrap(name):
        def wrapper(*args):
            cap.setdefault(name, tuple(t.clone() for t in args
                                       if isinstance(t, torch.Tensor)))
            return getattr(katt, name)(*args)
        return wrapper

    old = swap_in([(mattn, "katt", types.SimpleNamespace(
        flash_attention=wrap("flash_attention"),
        decode_attention=wrap("decode_attention")))])
    try:
        fn()
    finally:
        swap_in(old)
    return cap


def fp32_args(args):
    import torch

    return tuple(t.float() if torch.is_floating_point(t) else t
                 for t in args)


def moe_layer_check(moe, x, p, cfg, arch) -> dict:
    """One layer's ``moe_ffn`` (bf16) on ``x`` (a real prefill's normed
    input) against a plain fp32 oracle: the router's fp32 probabilities
    (the same product on the same card), the top-k by a stable sort on the
    host (the lower expert first on a tie), gates renormalised, each
    expert keeping its first ``cap`` replicas in (token, slot) order, and
    per expert the fp32 FFN of its kept tokens (its bf16 weights upcast)
    times their gates, summed per token. The port's experts and kept
    replicas must be the oracle's, and its output within MOE_ORACLE_REL of
    the oracle's largest magnitude. Returns the line."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    d = x.shape[-1]
    xf = x.reshape(-1, d)
    t, k, e = xf.shape[0], cfg.top_k, cfg.n_experts
    y = moe.moe_ffn(x, p, cfg).reshape(t, d)
    r = moe.route(xf, p["router"], k)
    probs = torch.softmax(xf.float() @ p["router"], dim=-1).cpu().numpy()
    eidx = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    gates = np.take_along_axis(probs, eidx, -1)
    gates = gates / np.maximum(gates.sum(-1, keepdims=True), 1e-9)
    cap = moe.capacity(t, k, e)
    load = np.zeros(e, np.int64)
    keep = np.zeros((t, k), bool)
    for tok in range(t):
        for j in range(k):
            keep[tok, j] = load[eidx[tok, j]] < cap
            load[eidx[tok, j]] += 1
    same = (np.array_equal(r.eidx.cpu().numpy(), eidx)
            and np.array_equal(r.keep.view(t, k).cpu().numpy(), keep)
            and np.array_equal(r.counts.cpu().numpy(), load))
    want = torch.zeros(t, d, dtype=torch.float32, device=x.device)
    x32 = xf.float()
    g32 = torch.from_numpy(gates.astype(np.float32)).to(x.device)
    for ex in range(e):
        tok, slot = np.nonzero((eidx == ex) & keep)
        if not len(tok):
            continue
        ti = torch.from_numpy(tok).to(x.device)
        xe = x32[ti]
        if cfg.mlp_gated:
            h = F.silu(xe @ p["wg"][ex].float()) * (xe @ p["wu"][ex].float())
        else:
            h = F.gelu(xe @ p["wu"][ex].float(), approximate="tanh")
        g = g32[ti, torch.from_numpy(slot).to(x.device)]
        want.index_add_(0, ti, (h @ p["wd"][ex].float()) * g[:, None])
    err, mag = max_err(y, want), float(want.abs().max())
    line = {"moe_layer_check": arch, "tokens": t, "top_k": k, "experts": e,
            "capacity": cap, "replicas": t * k, "kept": int(keep.sum()),
            "dropped": int((~keep).sum()), "max_load": int(load.max()),
            "routing_equal": same, "max_abs_err": err, "oracle_max_abs": mag,
            "limit": MOE_ORACLE_REL * mag,
            "zero_rows": int((~keep.any(-1)).sum()),
            "moe_ffn_ms": queued_ms(lambda: moe.moe_ffn(x, p, cfg), 10)}
    log(line)
    if not (same and err <= MOE_ORACLE_REL * mag
            and bool(torch.isfinite(y.float()).all())):
        raise RuntimeError(f"{arch}: moe_ffn off its fp32 oracle: {line}")
    return line


def moe_model(arch, katt, counters) -> tuple:
    """Phase 11 for one MoE config: returns ({label: {kernel: bf16 line}},
    {kernel: launches of the serving run})."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import SlotServer
    from repro_torch.models import attention as mattn
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.utils.tree import leaves

    t_model = time.perf_counter()
    full = get_arch(arch)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, 0, device=DEVICE)
    server = SlotServer(cfg, params, MOE_SLOTS, MOE_CTX, DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    log({"lm_moe_model": {
        "arch": arch, "layers": cfg.n_layers,
        "published_layers": full.n_layers, "d_model": cfg.d_model,
        "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim, "window": cfg.window,
        "qk_norm": cfg.qk_norm, "experts": cfg.n_experts,
        "top_k": cfg.top_k, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
        "dtype": cfg.dtype, "params": n_params,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "weight_bytes": sum(t.numel() * t.element_size()
                            for t in leaves(params)),
        "cache_bytes": sum(t.numel() * t.element_size()
                           for t in leaves(server.cache)),
        "init_peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "init_s": time.perf_counter() - t0}})
    if n_params != cfg.param_count():
        raise RuntimeError(f"{arch}: the parameter tree holds {n_params}, "
                           f"param_count() {cfg.param_count()}")

    # ------------------------------------------------ serve the requests
    moe.stats.reset()
    run = serve(server, cfg, counters, MOE_REQUESTS, MOE_PROMPT, MOE_CTX)
    got = {k: fn.launches for k, fn in counters.items()}
    log({"path": f"lm moe serving {arch}", "launches": got})
    steps = len(run.step_ms)
    want = {"flash_attention": cfg.n_layers * MOE_REQUESTS,
            "decode_attention": cfg.n_layers * steps}
    launches = {k: got[k] for k in want}
    if launches != want or any(n for k, n in got.items() if k not in want):
        raise RuntimeError(f"{arch} serving: launches {got}, expected "
                           f"{want} and nothing else")
    line = serving_line(run, MOE_SLOTS, MOE_CTX, MOE_PROMPT, base_mem,
                        launches)
    stats = moe.stats.read()
    if stats["calls"] != cfg.n_layers * (MOE_REQUESTS + steps):
        raise RuntimeError(f"{arch} serving: {stats['calls']} MoE calls")
    log({"lm_moe_serving": {"arch": arch, **line, "moe": stats}})
    prof_wall, dev, n_kernels = profiled(lambda: server.step(run.cur),
                                         reps=4)
    busy = sum(dev.values())
    log({"lm_moe_decode_profile": {
        "arch": arch, "steps": 4, "wall_ms_per_step": prof_wall,
        "device_ms_per_step": busy, "device_kernels_per_step": n_kernels,
        "device_busy_share": busy / prof_wall if dev else None,
        "top_kernels": dict(sorted(dev.items(), key=lambda kv: -kv[1])[:8])}})

    # ---- layer 0's inputs of a real prefill and decode step: the two
    # attention kernels against their plain versions, the MoE layer
    # against its fp32 oracle; for mixtral also a 4,608-token prefill (the
    # 4,096 window binds) and its decode step (the ring wraps)
    grabbed = {}

    def grab_moe(x, p, c, **kw):
        grabbed.setdefault("prefill" if x.shape[1] > 1 else "decode",
                           (x.clone(), p))
        return moe.moe_ffn(x, p, c, **kw)

    def real():
        server.admit(0, run.prompts[0], 1)
        server.step(run.cur)

    old = swap_in([(tf, "moe", types.SimpleNamespace(moe_ffn=grab_moe))])
    try:
        cap = grab_attention(katt, real)
    finally:
        swap_in(old)
    cases = [("flash_attention", "bf16", cap["flash_attention"]),
             ("flash_attention", "fp32", fp32_args(cap["flash_attention"])),
             ("decode_attention", "bf16", cap["decode_attention"]),
             ("decode_attention", "fp32",
              fp32_args(cap["decode_attention"]))]
    if 0 < cfg.window < MOE_WINDOW_PROMPT:
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab, (1, MOE_WINDOW_PROMPT)).astype(np.int32)).to(
                DEVICE)

        def long():
            _, cache_w = tf.prefill(params, cfg, {"tokens": toks},
                                    seq_len_cache=MOE_WINDOW_PROMPT)
            tf.decode_step(params, cfg, {"tokens": toks[:, -1]}, cache_w)

        cap_w = grab_attention(katt, long)
        ap, pos = cap_w["decode_attention"][3:5]
        if not (cap_w["flash_attention"][0].shape[2] == MOE_WINDOW_PROMPT
                and ap.shape[1] == cfg.window
                and int(pos.min()) > cfg.window):
            raise RuntimeError(f"{arch}: the long prompt's window did not "
                               "bind or its ring did not wrap")
        cases += [("flash_attention", f"bf16 S {MOE_WINDOW_PROMPT}",
                   cap_w["flash_attention"]),
                  ("decode_attention", "bf16 wrapped",
                   cap_w["decode_attention"])]
        del cap_w
    results = {}
    for name, case, args in cases:
        line = attention_check(katt, arch, name, case, args, cfg.window)
        if case == "bf16":
            results.setdefault(arch, {})[name] = line
        elif case.startswith("bf16"):
            results.setdefault(f"{arch} window", {})[name] = line
    del cap, cases
    x, p = grabbed["prefill"]
    moe_layer_check(moe, x, p, cfg, arch)
    xd, pd = grabbed["decode"]
    t_dec = xd.shape[0] * xd.shape[1]
    log({"moe_ffn_decode": arch, "tokens": t_dec,
         "replicas": t_dec * cfg.top_k,
         "rows_computed": cfg.n_experts * moe.capacity(
             t_dec, cfg.top_k, cfg.n_experts),
         "moe_ffn_ms": queued_ms(lambda: moe.moe_ffn(xd, pd, cfg), 20)})
    del grabbed, x, p, xd, pd

    # ----- decode against the full forward, the kernel path against plain
    del server
    torch.cuda.empty_cache()
    seq, two, feed = token_inputs(run.prompts, cfg.vocab, MOE_TEACHER_STEPS)
    rec = MoERecorder(moe)
    old = swap_in([(tf, "moe", rec)])
    try:
        # the first layer where the forward over the prompt, or the
        # prefill of its first MOE_FORWARD_PROMPT tokens, drops a replica
        _, fwd_drops, _ = rec.record(lambda: tf.forward(
            params, cfg, seq, logits_last_only=True))
        _, pre_drops, _ = rec.record(lambda: tf.prefill(
            params, cfg, prefix(seq, MOE_FORWARD_PROMPT),
            seq_len_cache=MOE_CTX))
        dropping = [i for i, (a, b) in enumerate(zip(fwd_drops, pre_drops))
                    if a or b]
        forward_layers = dropping[0] if dropping else cfg.n_layers
        log({"lm_moe_forward_drops": {
            "arch": arch, "forward_by_layer": fwd_drops,
            "prefill_by_layer": pre_drops,
            "forward_layers": forward_layers}})
        # the prompt's check in the layers before the first that drops; if
        # any drops, also the first MOE_SHORT_PROMPT tokens at full depth,
        # where the capacity (at least 128) holds every replica
        probes = []
        if forward_layers:
            probes.append(Probe(
                seq, MOE_FORWARD_PROMPT, forward_layers,
                "" if forward_layers == cfg.n_layers else
                f" (layer {forward_layers} drops replicas)"))
        if forward_layers < cfg.n_layers:
            probes.append(Probe(
                prefix(seq, MOE_SHORT_PROMPT), MOE_SHORT_PROMPT // 2,
                note=f", {MOE_SHORT_PROMPT} tokens (no drop possible)"))
        lm_path_checks(
            arch, params, cfg, probes, two, feed,
            {"flash_attention": (katt.flash_attention, "prefill"),
             "decode_attention": (katt.decode_attention, "decode")},
            [(mattn, "katt", types.SimpleNamespace(
                flash_attention=katt.flash_attention_plain,
                decode_attention=katt.decode_attention_plain))],
            depths=MOE_DEPTHS, ctx=MOE_CTX, fp32_layers=MOE_FP32_LAYERS,
            recorder=rec)
    finally:
        swap_in(old)
    del params
    torch.cuda.empty_cache()
    log({"lm_moe_model_s": time.perf_counter() - t_model, "arch": arch})
    return results, launches


def moe_phase(katt, counters) -> tuple:
    """11. MoE serving on the port: each of MOE_ARCHS at its published
    widths with every expert, cut to MOE_LAYERS layers, in bf16 behind
    ``SlotServer``, then its checks (:func:`moe_model`); each model freed
    before the next is built. Returns ({label: {kernel: bf16 line}},
    {arch: {kernel: launches of its serving run}})."""
    results, launches = {}, {}
    for arch in MOE_ARCHS:
        res, launches[arch] = moe_model(arch, katt, counters)
        results.update(res)
    return results, launches


def patch_grid(b: int, s: int, grid: int):
    """(B, 3, S) int32 M-RoPE positions: a grid x grid patch grid first (t
    0, h the row, w the column), then each position's index in all three
    streams."""
    import numpy as np

    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, 3, s)).copy()
    n = grid * grid
    pos[:, 0, :n] = 0
    pos[:, 1, :n] = np.arange(n) // grid
    pos[:, 2, :n] = np.arange(n) % grid
    return pos


def stub_model(arch, katt, counters) -> tuple:
    """Phase 12 for one stub-frontend config: returns ({arch: {kernel: bf16
    line}}, {kernel: launches of its run})."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import attention as mattn
    from repro_torch.models import transformer as tf
    from repro_torch.utils.tree import leaves

    t_model = time.perf_counter()
    cfg = dataclasses.replace(get_arch(arch), n_layers=STUB_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, 0, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    total = STUB_PROMPT + STUB_STEPS
    ctx = total + 4                 # room for 4 profiled steps past them
    log({"lm_stub_model": {
        "arch": arch, "family": cfg.family, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "heads": cfg.n_heads,
        "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
        "mrope": cfg.mrope, "mrope_sections": list(cfg.mrope_sections),
        "mlp_gated": cfg.mlp_gated, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
        "dtype": cfg.dtype, "params": n_params,
        "param_count": cfg.param_count(),
        "weight_bytes": sum(t.numel() * t.element_size()
                            for t in leaves(params)),
        "init_s": time.perf_counter() - t0}})
    if n_params != cfg.param_count():
        raise RuntimeError(f"{arch}: the parameter tree holds {n_params}, "
                           f"param_count() {cfg.param_count()}")
    rng = np.random.default_rng(0)
    batch = {"embeds": torch.from_numpy(rng.standard_normal(
        (STUB_ROWS, total, cfg.d_model)).astype(np.float32)).to(DEVICE)}
    if cfg.mrope:
        batch["positions"] = torch.from_numpy(
            patch_grid(STUB_ROWS, total, STUB_GRID)).to(DEVICE)

    # --------------------- a prefill of every row, then the decode steps
    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t_run = time.perf_counter()
    a, b = events()
    a.record()
    logits, cache = tf.prefill(params, cfg, prefix(batch, STUB_PROMPT),
                               seq_len_cache=ctx)
    b.record()
    b.synchronize()
    prefill_ms = a.elapsed_time(b)
    step_ms = []
    for t in range(STUB_PROMPT, total):
        a, b = events()
        a.record()
        logits, cache = tf.decode_step(params, cfg, at(batch, t), cache)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
    wall = time.perf_counter() - t_run
    got = {k: fn.launches for k, fn in counters.items()}
    launches = {"flash_attention": got["flash_attention"],
                "decode_attention": got["decode_attention"]}
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * STUB_STEPS}
    log({"path": f"lm stub {arch}", "launches": got})
    if launches != want or any(n for k, n in got.items() if k not in want):
        raise RuntimeError(f"{arch}: launches {got}, expected {want} and "
                           "nothing else")
    if tuple(logits.shape) != (STUB_ROWS, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise RuntimeError(f"{arch}: logits {tuple(logits.shape)} or not "
                           "finite")
    log({"lm_stub_run": {
        "arch": arch, "rows": STUB_ROWS, "prompt": STUB_PROMPT,
        "decode_steps": STUB_STEPS, "prefill_ms": prefill_ms,
        "decode_step_ms_median": statistics.median(step_ms),
        "decode_step_ms_min": min(step_ms),
        "tokens_per_s": STUB_ROWS * STUB_STEPS / (sum(step_ms) / 1e3),
        "wall_s": wall, "max_position": int(cache["attn"]["pos"].max()),
        "cache_bytes": sum(t.numel() * t.element_size()
                           for t in leaves(cache)),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "memory_before_model_bytes": base_mem, "launches": launches}})
    step = at(batch, total - 1)
    prof_wall, dev, n_kernels = profiled(
        lambda: tf.decode_step(params, cfg, step, cache), reps=3)
    busy = sum(dev.values())
    log({"lm_stub_decode_profile": {
        "arch": arch, "steps": 3, "wall_ms_per_step": prof_wall,
        "device_ms_per_step": busy, "device_kernels_per_step": n_kernels,
        "device_busy_share": busy / prof_wall if dev else None,
        "top_kernels": dict(sorted(dev.items(), key=lambda kv: -kv[1])[:8])}})
    del cache

    # ------ layer 0's inputs of the same prefill and its first decode step
    def real():
        _, c_ = tf.prefill(params, cfg, prefix(batch, STUB_PROMPT),
                           seq_len_cache=ctx)
        tf.decode_step(params, cfg, at(batch, STUB_PROMPT), c_)

    cap = grab_attention(katt, real)
    results = {}
    for name in ("flash_attention", "decode_attention"):
        for case, args in (("bf16", cap[name]), ("fp32", fp32_args(cap[name]))):
            line = attention_check(katt, arch, name, case, args, cfg.window)
            if case == "bf16":
                results.setdefault(arch, {})[name] = line
    del cap

    # ----- decode against the full forward, the kernel path against plain
    # (the first row's prompt; the first two rows and their next embeddings)
    seq = {k: v[:1, ..., :STUB_PROMPT] if k == "positions"
           else v[:1, :STUB_PROMPT] for k, v in batch.items()}
    two = {k: v[:2, ..., :STUB_PROMPT] if k == "positions"
           else v[:2, :STUB_PROMPT] for k, v in batch.items()}
    feed = [{"embeds": batch["embeds"][:2, STUB_PROMPT + t]}
            for t in range(STUB_TEACHER_STEPS)]
    lm_path_checks(
        arch, params, cfg, [Probe(seq, STUB_FORWARD_PROMPT)], two, feed,
        {"flash_attention": (katt.flash_attention, "prefill"),
         "decode_attention": (katt.decode_attention, "decode")},
        [(mattn, "katt", types.SimpleNamespace(
            flash_attention=katt.flash_attention_plain,
            decode_attention=katt.decode_attention_plain))],
        depths=(), ctx=ctx)
    del params, batch
    torch.cuda.empty_cache()
    log({"lm_stub_model_s": time.perf_counter() - t_model, "arch": arch})
    return results, launches


def stub_phase(katt, counters) -> tuple:
    """12. The stub-frontend models on the port: each of STUB_ARCHS at full
    width, its first STUB_LAYERS layers, in bf16, through ``prefill`` /
    ``decode_step`` with embeddings (:func:`stub_model`). Returns ({arch:
    {kernel: bf16 line}}, {arch: {kernel: launches of its run}})."""
    results, launches = {}, {}
    for arch in STUB_ARCHS:
        res, launches[arch] = stub_model(arch, katt, counters)
        results.update(res)
    return results, launches


# ------------------------------------------------------ 13. training
def profile_once(fn):
    """``fn()`` once under ``torch.profiler`` with the CUDA activity alone,
    the device kernels read from the profiler's raw events (no event tree:
    a sharded step launches ~10^5 kernels, and the tree over them took
    ~110 s) -> (its result, host wall ms, {kernel: device ms}, device
    kernels); the dict is empty when the profiler saw no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev, n = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev[e.name()] = dev.get(e.name(), 0.0) + e.duration_ns() / 1e6
            n += 1
    return out, wall, dev, n


def tree_bytes(tree) -> int:
    from repro_torch.utils.tree import leaves

    return sum(t.numel() * t.element_size() for t in leaves(tree))


def train_adamw(steps: int):
    """The launcher's AdamW for a run of ``steps``."""
    from repro_torch.train.optimizer import AdamWConfig

    return AdamWConfig(lr=TRAIN_LR, warmup_steps=max(2, steps // 20),
                       total_steps=steps)


def train_stream(cfg):
    """13a's stream: ``SyntheticLM(vocab, TRAIN_SEQ, TRAIN_BATCH, seed 0)``."""
    from repro_torch.data.pipeline import SyntheticLM

    return SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)


def on_card(batch) -> dict:
    import torch

    return {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}


def train_run(tag, cfg, steps, counters, kernels, profile_at, must_fall):
    """Train ``cfg`` (seed 0, bf16) for ``steps`` steps of the launcher's
    AdamW (lr TRAIN_LR, warm-up max(2, steps // 20), remat on) on
    :func:`train_stream` through the ``Prefetcher``, as the launcher does;
    the step at ``profile_at`` under ``torch.profiler``. Logs each step's
    loss, grad_norm, lr and ms (its AdamW update's apart), the bytes of
    the parameters, gradients and AdamW state, the peak, tokens/s and the
    profiled step's busy share and top kernels, and the leaves and
    elements whose bits no step changed. Gates: finite losses and norms,
    with ``must_fall`` a last loss below the first, every leaf that was
    not one constant at init changed in some element, and each of
    ``kernels`` ({name: launches a layer a step}) launched exactly that
    often, nothing else; the plain flash version only in the backward's
    recompute (its query chunks, when attention runs). Returns the run's
    summary line."""
    import torch

    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.kernels import attention as katt
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep
    from repro_torch.utils.tree import leaves, paths

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, 0, device=DEVICE)
    opt = topt.adamw_init(params)
    ocfg = train_adamw(steps)
    torch.cuda.synchronize()
    init = [t.to("cpu", copy=True) for t in leaves(params)]
    sizes = {"param_bytes": tree_bytes(params),
             "grad_bytes": tree_bytes(params),    # gradients in their dtype
             "adamw_state_bytes": tree_bytes(opt["mu"]) + tree_bytes(
                 opt["nu"]) + 4,
             "params": sum(t.numel() for t in leaves(params))}
    log({"train_model": {"tag": tag, "arch": cfg.name, "layers":
                         cfg.n_layers, "d_model": cfg.d_model,
                         "dtype": cfg.dtype, "batch": TRAIN_BATCH,
                         "seq": TRAIN_SEQ, "steps": steps, "remat": True,
                         "lr": TRAIN_LR, "warmup_steps": ocfg.warmup_steps,
                         **sizes, "init_s": time.perf_counter() - t0}})
    events, old = timed_calls(tstep, "adamw_update")
    plain_calls = [0]
    plain = katt.flash_attention_plain

    def counted_plain(*a, **kw):
        plain_calls[0] += 1
        return plain(*a, **kw)

    old += swap_in([(katt, "flash_attention_plain", counted_plain)])
    prefetch = Prefetcher(train_stream(cfg), transform=on_card)
    rows, prof = [], None
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t_run = time.perf_counter()
    try:
        for step, batch in prefetch:
            if step >= steps:
                break

            def one():
                return tstep.train_step(params, opt, batch, cfg, ocfg,
                                        remat=True)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            if step == profile_at:
                (params, opt, m), wall, dev, n_k = profile_once(one)
                prof = {"step": step, "wall_ms": wall,
                        "device_ms": sum(dev.values()),
                        "device_kernels": n_k,
                        "device_busy_share": sum(dev.values()) / wall
                        if dev else None,
                        "top_kernels": dict(sorted(
                            dev.items(), key=lambda kv: -kv[1])[:10])}
            else:
                params, opt, m = one()
            b.record()
            b.synchronize()
            ua, ub = events[-1]
            rows.append({"step": step, "loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "lr": float(m["lr"]), "step_ms": a.elapsed_time(b),
                         "adamw_ms": ua.elapsed_time(ub)})
            log({"train_step": {"tag": tag, **rows[-1]}})
    finally:
        prefetch.close()
        swap_in(old)
    wall = time.perf_counter() - t_run
    got = {k: fn.launches for k, fn in counters.items()}
    want = {k: n * cfg.n_layers * steps for k, n in kernels.items()}
    chunks = -(-TRAIN_SEQ // katt.BACKWARD_ROWS)
    want_plain = (steps * cfg.n_layers * chunks
                  if "flash_attention" in kernels else 0)
    log({"path": f"train {tag}", "launches": got,
         "plain_flash_calls": plain_calls[0]})
    if {k: got[k] for k in want} != want or any(
            n for k, n in got.items() if k not in want):
        raise RuntimeError(f"train {tag}: launches {got}, expected {want} "
                           "and nothing else")
    if plain_calls[0] != want_plain:
        raise RuntimeError(f"train {tag}: the plain flash version ran "
                           f"{plain_calls[0]} times, expected {want_plain} "
                           "(the backward's query chunks)")
    bad = [r for r in rows if not (math.isfinite(r["loss"])
                                   and math.isfinite(r["grad_norm"]))]
    if bad or len(rows) != steps:
        raise RuntimeError(f"train {tag}: steps {len(rows)}, not finite: "
                           f"{bad}")
    peak = torch.cuda.max_memory_allocated()
    moved = params_moved(tag, paths(params), init)
    del init
    timed = [r for r in rows if r["step"] != profile_at]
    steady = [r["step_ms"] for r in timed if r["step"] > 0]
    step_ms = statistics.median(r["step_ms"] for r in timed)
    adamw_ms = statistics.median(r["adamw_ms"] for r in timed)
    line = {"tag": tag, "arch": cfg.name, "layers": cfg.n_layers,
            "steps": steps, "losses": [r["loss"] for r in rows],
            "first_loss": rows[0]["loss"], "last_loss": rows[-1]["loss"],
            "step_ms_median": step_ms, "adamw_ms_median": adamw_ms,
            "forward_backward_ms_median": statistics.median(
                r["step_ms"] - r["adamw_ms"] for r in timed),
            # AdamW reads each parameter, gradient and moment once and
            # writes each parameter and moment once
            "adamw_bound_ms": bound(2 * sizes["param_bytes"]
                                    + sizes["grad_bytes"]
                                    + 2 * sizes["adamw_state_bytes"],
                                    0)["bound_ms"],
            "first_step_ms": rows[0]["step_ms"],
            # tokens/s of the median step; of the steps after the first
            # but the profiled one, their tokens over their summed ms; of
            # every step over the run's wall (the first step's warm-up,
            # the profiler and the per-step reads included)
            "tokens_per_s_median_step": TRAIN_BATCH * TRAIN_SEQ
            / (step_ms / 1e3),
            "tokens_per_s_steady": TRAIN_BATCH * TRAIN_SEQ * len(steady)
            / (sum(steady) / 1e3),
            "tokens_per_s_run_wall": TRAIN_BATCH * TRAIN_SEQ * steps / wall,
            "wall_s": wall, **sizes, "peak_memory_bytes": peak,
            "memory_before_model_bytes": base_mem, "launches": got,
            "plain_flash_calls": plain_calls[0], "profile": prof,
            "moved": moved}
    log({"train_run": line})
    if must_fall and not rows[-1]["loss"] < rows[0]["loss"]:
        raise RuntimeError(f"train {tag}: the loss did not fall "
                           f"({rows[0]['loss']} -> {rows[-1]['loss']})")
    del params, opt
    return line


def params_moved(tag, named, init) -> dict:
    """Which parameters a run changed: ``named`` ((path, tensor) on the
    card, after the run) against ``init`` (host copies of the same leaves
    before it), compared by their bits. Logs and returns the leaves and
    elements left unchanged; raises where a leaf that was not one constant
    at init (a norm's gain, a filled SSM leaf) has no element changed."""
    import torch

    words = {2: torch.int16, 4: torch.int32}
    n = same = 0
    unchanged, constant = {}, []
    for (name, t), t0 in zip(named, init):
        t0 = t0.to(t.device)
        k = int((t.view(words[t.element_size()])
                 == t0.view(words[t0.element_size()])).sum())
        n, same = n + t.numel(), same + k
        if bool((t0 == t0.flatten()[0]).all()):
            constant.append(name)
        if k:
            unchanged[name] = k / t.numel()
    stuck = [k for k, share in unchanged.items()
             if share == 1.0 and k not in constant]
    line = {"tag": tag, "leaves": len(init), "elements": n,
            "elements_unchanged": same, "elements_unchanged_share": same / n,
            "constant_leaves": constant,
            "leaves_unchanged": [k for k, share in unchanged.items()
                                 if share == 1.0],
            "unchanged_share_by_leaf": unchanged}
    log({"train_moved": line})
    if stuck:
        raise RuntimeError(f"train {tag}: no element of {stuck} moved")
    return {k: line[k] for k in ("elements_unchanged_share",
                                 "leaves_unchanged")}


def grad_check(tag, cfg, batch, swaps, kernels, gate: bool):
    """The loss and every gradient leaf of ``cfg`` (seed 0) on ``batch``
    through the kernels (remat on) against the same with ``swaps`` (the
    plain versions in their places); ``kernels``: {name: (wrapper,
    launches a layer)} on the kernel path, none on the plain. With
    ``gate``: the loss within TRAIN_LOSS_REL relative and each leaf within
    TRAIN_GRAD_REL of its largest plain gradient, else only logged.
    Returns (the params, the kernel path's gradients)."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.train.step import value_and_grad
    from repro_torch.utils.tree import paths

    torch.cuda.empty_cache()
    params = tf.init_params(cfg, 0, device=DEVICE)
    names = [k for k, _ in paths(params)]
    out = {}
    for path in ("kernel", "plain"):
        old = swap_in(swaps) if path == "plain" else None
        n0 = {k: fn.launches for k, (fn, _) in kernels.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            loss, grads = value_and_grad(params, cfg, batch, remat=True)
            torch.cuda.synchronize()
        finally:
            if old:
                swap_in(old)
        got = {k: fn.launches - n0[k] for k, (fn, _) in kernels.items()}
        want = {k: 0 if path == "plain" else 2 * n * cfg.n_layers
                for k, (_, n) in kernels.items()}
        if got != want:
            raise RuntimeError(f"grad check {tag} {path}: launches {got}, "
                               f"expected {want}")
        out[path] = (float(loss), grads, time.perf_counter() - t0)
    (lk, gk, sk), (lp, gp, sp) = out["kernel"], out["plain"]
    errs = {}
    for name, a, b in zip(names, gk, gp):
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        errs[name] = err / scale if scale else err
    worst_leaf = max(errs, key=errs.get)
    worst = errs[worst_leaf]
    finite = all(bool(torch.isfinite(g).all()) for g in gk)
    line = {"tag": tag, "arch": cfg.name, "layers": cfg.n_layers,
            "dtype": cfg.dtype, "batch": list(batch["tokens"].shape),
            "loss_kernel": lk, "loss_plain": lp,
            "loss_rel_err": abs(lk - lp) / abs(lp),
            "grad_worst_rel_err": worst,
            "grad_worst_leaf": worst_leaf,
            "kernel_path_s": sk, "plain_path_s": sp, "gated": gate,
            "loss_rel_tol": TRAIN_LOSS_REL, "grad_rel_tol": TRAIN_GRAD_REL}
    log({"train_grad_check": line})
    if not finite or not math.isfinite(lk):
        raise RuntimeError(f"grad check {tag}: not finite")
    if gate and not (line["loss_rel_err"] <= TRAIN_LOSS_REL
                     and worst <= TRAIN_GRAD_REL):
        raise RuntimeError(f"grad check {tag}: loss {lk} against {lp}, "
                           f"worst leaf {worst_leaf} {worst}")
    return params, gk


def adamw_card_vs_cpu(params, grads):
    """13c: one AdamW step of ``params`` (the 2-layer fp32 model) by the
    kernel path's ``grads`` on the card and the same on the CPU: mu, nu
    and the parameters within TRAIN_ADAMW_REL of each leaf's largest
    magnitude, grad_norm within it relative, lr equal."""
    import torch

    from repro_torch.train import optimizer as topt
    from repro_torch.utils.tree import paths, tree_map, unflatten

    ocfg = train_adamw(TRAIN_STEPS)
    cpu_p = tree_map(params, lambda t: t.cpu())
    cpu_g = unflatten(cpu_p, [g.cpu() for g in grads])
    card_g = unflatten(params, grads)
    t0 = time.perf_counter()
    p1, s1, m1 = topt.adamw_update(card_g, topt.adamw_init(params), params,
                                   ocfg)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p2, s2, m2 = topt.adamw_update(cpu_g, topt.adamw_init(cpu_p), cpu_p,
                                   ocfg)
    cpu_s = time.perf_counter() - t0
    worst = {}
    for what, a_, b_ in (("params", p1, p2), ("mu", s1["mu"], s2["mu"]),
                         ("nu", s1["nu"], s2["nu"])):
        w = 0.0
        for (_, a), (_, b) in zip(paths(a_), paths(b_)):
            scale = float(b.abs().max())
            err = float((a.cpu() - b).abs().max())
            w = max(w, err / scale if scale else err)
        worst[what] = w
    gn1, gn2 = float(m1["grad_norm"]), float(m2["grad_norm"])
    line = {"worst_rel_err": worst, "grad_norm_card": gn1,
            "grad_norm_cpu": gn2, "grad_norm_rel_err": abs(gn1 - gn2) / gn2,
            "grad_norm_bit_equal": gn1 == gn2, "lr_card": float(m1["lr"]),
            "lr_cpu": float(m2["lr"]), "step": int(s1["step"]),
            "card_s": card_s, "cpu_s": cpu_s, "tol": TRAIN_ADAMW_REL}
    log({"train_adamw_card_vs_cpu": line})
    if not (max(worst.values()) <= TRAIN_ADAMW_REL
            and line["grad_norm_rel_err"] <= TRAIN_ADAMW_REL
            and line["lr_card"] == line["lr_cpu"]
            and int(s1["step"]) == int(s2["step"]) == 1):
        raise RuntimeError(f"AdamW on the card against the CPU: {line}")
    return p1, s1


def checkpoint_check(params, opt, scratch: Path):
    """13d: ``save_async`` + ``wait_all`` of the 2-layer bf16 model and its
    AdamW state, then ``restore`` onto the card with equal bits; then the
    launcher as a subprocess: a crash at TRAIN_CRASH_AT (exit 42) and a
    ``--resume`` that ends with LATEST at its last step."""
    import torch

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.utils.tree import paths, tree_map

    shutil.rmtree(scratch, ignore_errors=True)
    tree = {"params": params, "opt": opt}
    t0 = time.perf_counter()
    ckpt.save_async(str(scratch / "state"), 1, tree)
    snap_s = time.perf_counter() - t0
    ckpt.wait_all()
    save_s = time.perf_counter() - t0
    like = tree_map(tree, torch.empty_like)
    like["opt"]["step"] = torch.zeros((), dtype=torch.int32, device=DEVICE)
    t0 = time.perf_counter()
    step, back = ckpt.restore(str(scratch / "state"), like)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same = all(a.dtype == b.dtype and a.device == b.device and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
        for (_, a), (_, b) in zip(paths(tree), paths(back)))
    files = sum(f.stat().st_size for f in (scratch / "state").rglob("*")
                if f.is_file())
    line = {"step": step, "bytes": tree_bytes(tree), "file_bytes": files,
            "snapshot_s": snap_s, "save_s": save_s, "restore_s": restore_s,
            "bits_equal": same}
    log({"train_checkpoint": line})
    if not same or step != 1:
        raise RuntimeError(f"checkpoint round trip on the card: {line}")
    del back

    run_dir = scratch / "launcher"
    args = [sys.executable, "-m", "repro_torch.launch.train",
            *TRAIN_LAUNCH_ARGS, "--ckpt-dir", str(run_dir)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r1 = subprocess.run([*args, "--simulate-failure-at", str(TRAIN_CRASH_AT)],
                        capture_output=True, text=True, env=env, timeout=300)
    crashed = ckpt.latest_step(str(run_dir))
    r2 = subprocess.run([*args, "--resume"], capture_output=True, text=True,
                        env=env, timeout=300)
    final = ckpt.latest_step(str(run_dir))
    launcher = {"crash_rc": r1.returncode, "resume_rc": r2.returncode,
                "latest_after_crash": crashed, "latest_at_end": final,
                "crash_tail": r1.stdout.strip().splitlines()[-2:],
                "resume_tail": r2.stdout.strip().splitlines()[-3:],
                "wall_s": time.perf_counter() - t0}
    log({"train_launcher": launcher})
    steps = int(TRAIN_LAUNCH_ARGS[TRAIN_LAUNCH_ARGS.index("--steps") + 1])
    if not (r1.returncode == 42 and f"simulating crash at step "
            f"{TRAIN_CRASH_AT}" in r1.stdout and crashed is not None
            and r2.returncode == 0
            and f"resumed from step {crashed}" in r2.stdout
            and final == steps):
        raise RuntimeError(f"the launcher's crash and resume: {launcher}; "
                           f"stderr {r1.stderr[-2000:]} {r2.stderr[-2000:]}")
    shutil.rmtree(scratch, ignore_errors=True)
    return {**line, "launcher": launcher}


def capture_first(module, attr, fn):
    """Swap ``module.<attr>`` for a namespace whose ``fn`` records its first
    call's arguments and runs the real one; returns (the record, the swaps
    that undo it)."""
    real = getattr(module, attr)
    seen = []

    def grab(*a, **kw):
        if not seen:
            seen.append((a, kw))
        return getattr(real, fn)(*a, **kw)
    ns = types.SimpleNamespace(**{k: getattr(real, k) for k in dir(real)
                                  if not k.startswith("__")})
    setattr(ns, fn, grab)
    return seen, swap_in([(module, attr, ns)])


def flash_training_line(q, k, v, window: int,
                        name: str = "flash_attention[train]") -> dict:
    """B7 at the training shape (layer 0's captured bf16 q, k, v): the
    kernel's forward, the Function's backward (the plain derivative in
    query chunks) and both through autograd, beside the plain version and
    SDPA's forward + backward on the same inputs; the forward within
    :func:`att_bound` of the plain version, the gradients within it of the
    plain version's unchunked autograd on fp32 copies of the inputs, cast
    to bf16 (the Function sums in fp32 and rounds once; autograd through
    the bf16 inputs rounds each head's dk and dv to bf16 before the group's
    sum, a few bf16 steps off)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import attention as katt

    g = torch.Generator(device=DEVICE).manual_seed(13)
    dout = torch.randn(q.shape, device=DEVICE, generator=g).to(q.dtype)
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.no_grad():
        got, want = katt.flash_attention(q, k, v, window), \
            katt.flash_attention_plain(q, k, v, window)
    f_err, f_share, f_ok = att_bound(got, want)
    del got, want
    gk = katt.flash_attention_grad(q, k, v, dout, window)
    ins32 = [t.detach().float().requires_grad_() for t in (q, k, v)]
    gp = [t.to(q.dtype) for t in torch.autograd.grad(
        katt.flash_attention_plain(*ins32, window), ins32, dout.float())]
    del ins32
    g_err = [att_bound(a, b) for a, b in zip(gk, gp)]
    del gk, gp
    if not (f_ok and all(ok for _, _, ok in g_err)):
        raise RuntimeError(f"flash_attention[train]: forward {f_err}, "
                           f"gradients {g_err}")

    def fn_fwd_bwd():
        return torch.autograd.grad(katt.flash_attention(*ins, window), ins,
                                   dout)

    def lib():
        return torch.autograd.grad(F.scaled_dot_product_attention(
            *ins, is_causal=True, enable_gqa=True), ins, dout)

    b, hq, s, d = q.shape
    pairs = band_pairs(s, window)
    fwd_ops = 4 * b * hq * d * pairs
    io = 2 * (2 * q.numel() + 2 * k.numel())
    line = {"name": name, "shape": {
        "q": list(q.shape), "k": list(k.shape)}, "window": window,
        "max_abs_err": f_err, "bound_share": f_share,
        "grad_max_abs_err": [e for e, _, _ in g_err],
        "kernel_ms": queued_ms(lambda: katt.flash_attention(q, k, v, window),
                               10),
        "backward_ms": cuda_ms(lambda: katt.flash_attention_grad(
            q, k, v, dout, window), 3, 1),
        "forward_backward_ms": cuda_ms(fn_fwd_bwd, 3, 1),
        "plain_ms": cuda_ms(lambda: katt.flash_attention_plain(
            q, k, v, window), 3, 1),
        "library_ms": cuda_ms(lib, 5),
        "library_call": "torch.nn.functional.scaled_dot_product_attention "
                        "(is_causal, enable_gqa) forward + backward",
        **bound(io, fwd_ops, BF16_OPS_PER_S),
        # the backward: q, k, v, dout in, dq, dk, dv out; 5 products of the
        # forward's 2 (S = QK^T and dP = dO V^T again, dV, dQ, dK)
        "backward_bound_ms": bound(2 * (3 * q.numel() + 4 * k.numel()),
                                   fwd_ops * 5 / 2,
                                   BF16_OPS_PER_S)["bound_ms"]}
    log(line)
    return line


def ssd_training_line(args, chunk: int, name: str = "ssd_scan[train]"
                      ) -> dict:
    """B9 at the training shape (layer 0's captured bf16 inputs): the
    kernel's forward against the plain version (:func:`ssd_check`'s rule)
    and the Function's backward (the plain derivative) timed."""
    import torch

    from repro_torch.kernels import ssd as kssd

    x, dt, a, b, c = args
    g = torch.Generator(device=DEVICE).manual_seed(14)
    dy = torch.randn(x.shape, device=DEVICE, generator=g).to(x.dtype)
    line = ssd_check(kssd, name, args, chunk)
    line.update({
        "kernel_ms": queued_ms(lambda: kssd.ssd_scan(*args, chunk), 10),
        "plain_ms": cuda_ms(lambda: kssd.ssd_scan_plain(*args, chunk), 3, 1),
        "library_ms": None, **ssd_bound(x, dt, b, kssd.TILE)})
    ins = [t.detach().requires_grad_() for t in args]

    def fn_fwd_bwd():
        return torch.autograd.grad(kssd.ssd_scan(*ins, chunk), ins, dy)

    grads = fn_fwd_bwd()
    if not all(bool(torch.isfinite(t).all()) for t in grads):
        raise RuntimeError(f"{name}: gradients not finite")
    _, ops_cb, ops_rest = ssd_work(x, dt, b, kssd.TILE)
    xb, bb = x.numel() * x.element_size(), b.numel() * b.element_size()
    line.update({
        "backward_ms": cuda_ms(lambda: kssd.ssd_scan_grad(*args, dy, chunk),
                               3, 1),
        "forward_backward_ms": cuda_ms(fn_fwd_bwd, 3, 1),
        # the backward: x, dy, dt, a, b, c in, dx, ddt, da, db, dc out; each
        # product's derivative takes two products
        "backward_bound_ms": bound(
            3 * xb + 2 * (dt.numel() + a.numel()) * 4 + 4 * bb,
            2 * (ops_cb + ops_rest), BF16_OPS_PER_S)["bound_ms"]})
    log({name: line})
    return line


def host_us(fn, reps: int = 100) -> float:
    """Host microseconds to issue one call of ``fn``: the stream first
    spins (``torch.cuda._sleep``) so that no call waits for the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def function_overhead_line() -> dict:
    """The host cost of launching through an autograd Function where no
    input requires a gradient (as serving calls them): B7's
    ``flash_attention``, B9's ``ssd_scan`` and the head's ``_Head`` beside
    the same launch made directly, at small bf16 shapes where the host
    sets the pace; :func:`host_us`, alternated, the median of 5 rounds."""
    import torch

    from repro_torch.kernels import attention as katt
    from repro_torch.kernels import ssd as kssd
    from repro_torch.models import transformer as tf

    g = torch.Generator(device=DEVICE).manual_seed(15)

    def rnd(*shape):
        return torch.randn(shape, device=DEVICE, generator=g).to(
            torch.bfloat16)

    q, k, v = rnd(1, 32, 64, 64), rnd(1, 8, 64, 64), rnd(1, 8, 64, 64)
    x, b, c = rnd(1, 64, 80, 64), rnd(1, 64, 128), rnd(1, 64, 128)
    dt = torch.rand((1, 64, 80), device=DEVICE, generator=g) * 0.1
    a = -0.5 - torch.rand((80,), device=DEVICE, generator=g)
    x2, w = rnd(64, 2048), rnd(2048, 4096)
    calls = {
        "flash_attention": (lambda: katt.flash_attention(q, k, v),
                            lambda: katt._flash_launch(q, k, v, 0)),
        "ssd_scan": (lambda: kssd.ssd_scan(x, dt, a, b, c),
                     lambda: kssd._ssd_launch(x, dt, a, b, c, 128)),
        "head": (lambda: tf._Head.apply(x2, w),
                 lambda: torch.mm(x2, w, out_dtype=torch.float32))}
    times = {k: ([], []) for k in calls}
    for _ in range(5):
        for name, (through, direct) in calls.items():
            times[name][0].append(host_us(through))
            times[name][1].append(host_us(direct))
    line = {}
    for name, (through, direct) in times.items():
        fn_us, launch_us = statistics.median(through), statistics.median(
            direct)
        line[name] = {"function_us": fn_us, "launch_us": launch_us,
                      "extra_us": fn_us - launch_us}
    log({"function_overhead": line})
    return line


def train_phase(katt, kssd, counters) -> tuple:
    """13. Training on the card (a-e of the module docstring). Returns
    ({kernel: its training line}, {kernel: launches of the training
    runs})."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import attention as mattn
    from repro_torch.models import ssm as mssm
    from repro_torch.utils.tree import unflatten

    t_phase = time.perf_counter()
    plain_att = [(mattn, "katt", types.SimpleNamespace(
        flash_attention=katt.flash_attention_plain,
        decode_attention=katt.decode_attention_plain))]
    plain_ssd = [(mssm, "kssd", types.SimpleNamespace(
        ssd_scan=kssd.ssd_scan_plain))]
    flash, ssd = ({"flash_attention": (katt.flash_attention, 1)},
                  {"ssd_scan": (kssd.ssd_scan, 1)})

    # 13a. granite_3_2b at full width and depth, bf16
    cfg = get_arch(TRAIN_ARCH)
    run = train_run("granite", cfg, TRAIN_STEPS, counters,
                    {"flash_attention": 2}, TRAIN_PROFILE_STEP, True)
    launches = {"flash_attention": run["launches"]["flash_attention"]}

    # 13b. kernel path against plain path, 2 layers at full width
    batch = on_card(train_stream(cfg).batch_at(0))
    c32 = dataclasses.replace(cfg, n_layers=TRAIN_CHECK_LAYERS,
                              dtype="float32")
    p32, g32 = grad_check("granite fp32", c32, batch, plain_att, flash,
                          gate=True)
    # 13c. the same gradients through AdamW on the card and on the CPU
    adamw_card_vs_cpu(p32, g32)
    del p32, g32
    c16 = dataclasses.replace(cfg, n_layers=TRAIN_CHECK_LAYERS)
    seen, old = capture_first(mattn, "katt", "flash_attention")
    try:
        p16, g16 = grad_check("granite bf16", c16, batch, plain_att,
                              flash, gate=False)
    finally:
        swap_in(old)
    (q, k, v, *rest), kw = seen[0]
    results = {"flash_attention": flash_training_line(
        q.detach(), k.detach(), v.detach(), rest[0] if rest else
        kw.get("window", 0))}
    del q, k, v, seen

    # 13d. checkpoints of the 2-layer bf16 model and its AdamW state
    from repro_torch.train import optimizer as topt
    p16, s16, _ = topt.adamw_update(unflatten(p16, g16),
                                    topt.adamw_init(p16), p16,
                                    train_adamw(TRAIN_STEPS))
    del g16
    checkpoint_check(p16, s16, ROOT / "build" / "chip_smoke_ckpt")
    del p16, s16

    # 13e. mamba2_2p7b at full width, its first TRAIN_SSM_LAYERS layers
    scfg = dataclasses.replace(get_arch(TRAIN_SSM_ARCH),
                               n_layers=TRAIN_SSM_LAYERS)
    srun = train_run("mamba2", scfg, TRAIN_SSM_STEPS, counters,
                     {"ssd_scan": 2}, None, False)
    launches["ssd_scan"] = srun["launches"]["ssd_scan"]
    sbatch = on_card(train_stream(scfg).batch_at(0))
    s2 = dataclasses.replace(scfg, n_layers=TRAIN_CHECK_LAYERS)
    seen, old = capture_first(mssm, "kssd", "ssd_scan")
    try:
        grad_check("mamba2 bf16", s2, sbatch, plain_ssd, ssd, gate=False)
    finally:
        swap_in(old)
    (x, dt, a, b, c, chunk), _ = seen[0]
    results["ssd_scan"] = ssd_training_line(
        tuple(t.detach() for t in (x, dt, a, b, c)), chunk)
    del seen, x, dt, a, b, c
    grad_check("mamba2 fp32", dataclasses.replace(s2, dtype="float32"),
               sbatch, plain_ssd, ssd, gate=True)
    function_overhead_line()
    log({"train_phase_s": time.perf_counter() - t_phase})
    return results, launches


# ------------------------------------------------- 14. the sharded trainer
def shard_mesh(shape=SHARD_TRAIN_MESH, axes=("data", "model")):
    from repro_torch.launch.mesh import make_test_mesh

    return make_test_mesh(shape, axes, devices=[DEVICE] * math.prod(shape))


def bits(t):
    """A tensor's bits, for exact comparisons (NaNs and -0 included)."""
    import torch

    words = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(words[t.element_size()])


def position_bytes(tree) -> list:
    """The bytes each mesh position holds of a tree of placed values."""
    from repro_torch.utils.tree import leaves

    ls = leaves(tree)
    return [sum(s.blocks[p].numel() * s.blocks[p].element_size()
                for s in ls) for p in range(len(ls[0].blocks))]


def distinct_bytes(tree) -> int:
    from repro_torch.sharding.placement import unique_blocks
    from repro_torch.utils.tree import leaves

    return sum(b.numel() * b.element_size() for s in leaves(tree)
               for _, b in unique_blocks(s))


def sharded_granite_run(counters) -> dict:
    """14a: granite_3_2b at full width and depth, bf16, seed 0, on a (4, 2)
    mesh of the card: SHARD_TRAIN_STEPS steps of the sharded step on
    ``SyntheticLM(vocab, 4096, 4, seed 0)`` (microbatches 1, remat on, the
    launcher's AdamW), the step at SHARD_TRAIN_PROFILE_STEP profiled. The
    first loss against the single-device ``loss_fn`` on the same parameters
    and batch (run first, then freed), finite losses, every non-constant
    leaf moved, ``flash_attention`` launched 8 positions x 40 layers x 2
    (forward, remat recompute) a step and nothing else."""
    import torch

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import attention as mattn
    from repro_torch.models import transformer as tf
    from repro_torch.sharding import MeshRules, place_tree
    from repro_torch.sharding.placement import unique_blocks
    from repro_torch.train import step as tstep
    from repro_torch.utils.tree import paths

    cfg = get_arch(TRAIN_ARCH)
    mesh = shard_mesh()
    rules = MeshRules(mesh)
    shape = ShapeConfig("train_4k", TRAIN_SEQ, SHARD_TRAIN_BATCH, "train")
    ocfg = train_adamw(SHARD_TRAIN_STEPS)
    step, in_sh, _, _ = tstep.build_train_step(cfg, shape, rules, ocfg,
                                               microbatches=1, remat=True)
    stream = SyntheticLM(cfg.vocab, TRAIN_SEQ, SHARD_TRAIN_BATCH, seed=0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, 0, device=DEVICE)
    with torch.no_grad():
        single = float(tf.loss_fn(params, cfg, on_card(stream.batch_at(0)),
                                  remat=False))
    single_peak = torch.cuda.max_memory_allocated()
    pd = place_tree(params, in_sh[0])
    del params
    torch.cuda.empty_cache()
    opt = tstep.sharded_adamw_init(pd)
    init_s = time.perf_counter() - t0
    named = [(f"{k}#{p}", b) for k, s in paths(pd)
             for p, b in unique_blocks(s)]
    init = [b.to("cpu", copy=True) for _, b in named]
    held = {"param_bytes_by_position": position_bytes(pd),
            "adamw_state_bytes_by_position": position_bytes(
                {"mu": opt["mu"], "nu": opt["nu"]}),
            "param_bytes_distinct": distinct_bytes(pd),
            "adamw_state_bytes_distinct": distinct_bytes(
                {"mu": opt["mu"], "nu": opt["nu"]})}
    log({"shard_train_model": {
        "arch": cfg.name, "mesh": list(SHARD_TRAIN_MESH),
        "positions_on": str(mesh.flat[0]), "layers": cfg.n_layers,
        "batch": SHARD_TRAIN_BATCH, "seq": TRAIN_SEQ,
        "steps": SHARD_TRAIN_STEPS, "dtype": cfg.dtype, "init_s": init_s,
        "single_device_loss": single,
        "single_device_peak_bytes": single_peak, **held,
        "embed_spec": str(pd["embed"].spec),
        "wq_spec": str(pd["blocks"]["attn"]["wq"].spec)}})
    torch.cuda.reset_peak_memory_stats()
    rows = []
    seen, old = capture_first(mattn, "katt", "flash_attention")
    events, undo = timed_calls(tstep, "_sharded_adamw")
    old += undo
    for fn in counters.values():
        fn.launches = 0
    t_run = time.perf_counter()
    try:
        pd, opt, prof = run_steps(step, pd, opt, stream, in_sh, rows,
                                  events)
    finally:
        swap_in(old)
    wall = time.perf_counter() - t_run
    got = {k: fn.launches for k, fn in counters.items()}
    want = 8 * cfg.n_layers * 2 * SHARD_TRAIN_STEPS
    log({"path": "sharded train", "launches": got,
         "flash_attention_reckoned": want})
    if got["flash_attention"] != want or any(
            n for k, n in got.items() if k != "flash_attention"):
        raise RuntimeError(f"sharded train: launches {got}, expected "
                           f"flash_attention {want} and nothing else")
    peak = torch.cuda.max_memory_allocated()
    moved = params_moved("sharded granite", named, init)
    del init, named, pd, opt
    torch.cuda.empty_cache()
    (q, k, v, *rest), kw = seen[0]          # position (0, 0), layer 0
    flash = flash_training_line(q.detach(), k.detach(), v.detach(),
                                rest[0] if rest else kw.get("window", 0),
                                "flash_attention[sharded]")
    del q, k, v, seen
    timed = [r["step_ms"] for r in rows if r["step"] in SHARD_TRAIN_TIMED]
    step_ms = statistics.median(timed)
    tokens = SHARD_TRAIN_BATCH * TRAIN_SEQ
    line = {"arch": cfg.name, "mesh": list(SHARD_TRAIN_MESH),
            "losses": [r["loss"] for r in rows],
            "grad_norms": [r["grad_norm"] for r in rows],
            "first_loss": rows[0]["loss"], "single_device_loss": single,
            "first_loss_abs_diff": abs(rows[0]["loss"] - single),
            "step_ms": [r["step_ms"] for r in rows],
            "adamw_ms": [r["adamw_ms"] for r in rows],
            "warmup_step_ms": rows[0]["step_ms"],
            "step_ms_median_timed": step_ms,
            "adamw_ms_median_timed": statistics.median(
                r["adamw_ms"] for r in rows
                if r["step"] in SHARD_TRAIN_TIMED),
            "tokens_per_s_median_step": tokens / (step_ms / 1e3),
            "tokens_per_s_run_wall": tokens * SHARD_TRAIN_STEPS / wall,
            "peak_memory_bytes": peak, "memory_before_bytes": base_mem,
            "launches": got, "profile": prof, "moved": moved, **held,
            "flash_attention": flash}
    log({"shard_train_run": line})
    bad = [r for r in rows if not (math.isfinite(r["loss"])
                                   and math.isfinite(r["grad_norm"]))]
    if bad or line["first_loss_abs_diff"] > SHARD_LOSS_ABS:
        raise RuntimeError(f"sharded train: not finite {bad}, or the first "
                           f"loss {rows[0]['loss']} differs from the single-"
                           f"device loss {single} by more than "
                           f"{SHARD_LOSS_ABS}")
    return line


def run_steps(step, pd, opt, stream, in_sh, rows, events,
              steps=SHARD_TRAIN_STEPS, profile_at=SHARD_TRAIN_PROFILE_STEP,
              label="shard_train_step"):
    """``steps`` steps of a sharded step (14a's by default), each timed by
    CUDA events, the step at ``profile_at`` under :func:`profile_once`;
    appends a row per step to ``rows``, with the AdamW update's time from
    ``events`` (:func:`timed_calls`), and logs it under ``label``. Returns
    (params, opt state, the profile)."""
    import torch

    from repro_torch.sharding import gather, place_tree

    prof = None
    for i in range(steps):
        batch = place_tree(on_card(stream.batch_at(i)), in_sh[2])

        def one():
            return step(pd, opt, batch)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        if i == profile_at:
            t_prof = time.perf_counter()
            (pd, opt, m), wall, dev, n_k = profile_once(one)
            prof = {"step": i, "wall_ms": wall,
                    "device_ms": sum(dev.values()), "device_kernels": n_k,
                    "device_busy_share": sum(dev.values()) / wall
                    if dev else None,
                    "profiler_s": time.perf_counter() - t_prof,
                    "top_kernels": {k[:120]: v for k, v in sorted(
                        dev.items(), key=lambda kv: -kv[1])[:10]}}
        else:
            pd, opt, m = one()
        b.record()
        b.synchronize()
        ua, ub = events[-1]
        rows.append({"step": i, **{k: float(gather(v)) for k, v in
                                   m.items()}, "step_ms": a.elapsed_time(b),
                     "adamw_ms": ua.elapsed_time(ub)})
        log({label: rows[-1]})
    return pd, opt, prof


def sharded_exact(arch: str, seq: int, keep: bool = False):
    """14b: the fp32 2-layer ``arch`` on ``SyntheticLM(vocab, seq, 4,
    seed 0)``: the sharded step's loss and every gathered gradient leaf
    (``sharded_value_and_grad``), then its updated parameters, loss,
    grad_norm and lr, against the single-device ``value_and_grad`` and
    ``train_step`` on the same parameters and batch. Returns the placed
    (parameters, AdamW state) where ``keep``."""
    import dataclasses

    import torch

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tf
    from repro_torch.sharding import MeshRules, gather, place_tree
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep
    from repro_torch.utils.tree import leaves, paths

    cfg = dataclasses.replace(get_arch(arch), n_layers=TRAIN_CHECK_LAYERS,
                              dtype="float32")
    rules = MeshRules(shard_mesh())
    shape = ShapeConfig("exact", seq, SHARD_TRAIN_BATCH, "train")
    ocfg = train_adamw(TRAIN_STEPS)
    step, in_sh, _, _ = tstep.build_train_step(cfg, shape, rules, ocfg,
                                               microbatches=1, remat=True)
    batch = on_card(SyntheticLM(cfg.vocab, seq, SHARD_TRAIN_BATCH,
                                seed=0).batch_at(0))
    params = tf.init_params(cfg, 0, device=DEVICE)
    pd = place_tree(params, in_sh[0])
    bd = place_tree(batch, in_sh[2])
    t0 = time.perf_counter()
    l1, g1 = tstep.sharded_value_and_grad(pd, cfg, bd, rules)
    torch.cuda.synchronize()
    vg_s = time.perf_counter() - t0
    l0, g0 = tstep.value_and_grad(params, cfg, batch)
    grad_err, repeat_err = {}, {}
    for (k, a), b in zip(paths(g1), g0):
        grad_err[k] = float((gather(a) - b).abs().max()
                            / b.abs().max().clamp(min=1e-30))
    del g1
    # the single-device path under another order of summation (its batch
    # in two halves, the gradients averaged): the spread that fp32 sums of
    # this length have, printed beside each leaf's error
    halves = [tstep.value_and_grad(params, cfg, {
        k: v[h * SHARD_TRAIN_BATCH // 2:(h + 1) * SHARD_TRAIN_BATCH // 2]
        for k, v in batch.items()})[1] for h in (0, 1)]
    for (k, _), a, b, c in zip(paths(pd), *halves, g0):
        repeat_err[k] = float(((a + b) / 2 - c).abs().max()
                              / c.abs().max().clamp(min=1e-30))
    del g0, halves
    opt = tstep.sharded_adamw_init(pd)
    pd, opt, m1 = step(pd, opt, bd)
    params, _, m0 = tstep.train_step(params, topt.adamw_init(params), batch,
                                     cfg, ocfg)
    lr = float(m0["lr"])
    worst, loose, n = 0.0, 0, 0
    for a, b in zip(leaves(pd), leaves(params)):
        d = (gather(a) - b).abs()
        worst = max(worst, float(d.max()))
        loose += int((d > SHARD_PARAM_TIGHT).sum())
        n += d.numel()
    rel = {k: abs(float(gather(m1[k])) - float(m0[k]))
           / max(abs(float(m0[k])), 1e-30) for k in ("loss", "grad_norm",
                                                      "lr")}
    line = {"arch": cfg.name, "layers": cfg.n_layers, "batch":
            SHARD_TRAIN_BATCH, "seq": seq, "vocab_spec": str(
                pd["embed"].spec), "loss": float(gather(m1["loss"])),
            "single_loss": float(m0["loss"]),
            "value_and_grad_loss_rel": abs(float(gather(l1)) - float(l0))
            / abs(float(l0)), "metric_rel": rel,
            "grad_rel_worst": max(grad_err.values()),
            "grad_rel_worst_leaf": max(grad_err, key=grad_err.get),
            "grad_rel_by_leaf": grad_err,
            "single_halves_grad_rel_by_leaf": repeat_err,
            "grad_bound": SHARD_GRAD_REL,
            "param_abs_worst": worst, "param_bound": 2 * lr,
            "param_elements_past_1e-6": loose, "param_elements": n,
            "sharded_value_and_grad_s": vg_s}
    log({"shard_exact": line})
    if (line["value_and_grad_loss_rel"] > SHARD_REL
            or max(rel.values()) > SHARD_REL
            or line["grad_rel_worst"] > SHARD_GRAD_REL
            or worst > 2 * lr or loose > SHARD_PARAM_LOOSE_SHARE * n):
        raise RuntimeError(f"sharded step against one device: {line}")
    del params, l0, l1
    if keep:
        return pd, opt
    del pd, opt
    torch.cuda.empty_cache()
    return None


def elastic_check(params, opt, scratch: Path) -> dict:
    """14e: ``save`` of 14b's placed granite state (parameters, moments,
    step) from the (4, 2) mesh, ``restore`` onto one device and back onto
    the mesh: the step and every bit as saved."""
    import torch

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.sharding import NamedSharding, gather
    from repro_torch.sharding.placement import shape_dtype
    from repro_torch.utils.tree import paths, tree_map

    shutil.rmtree(scratch, ignore_errors=True)
    tree = {"params": params, "opt": opt}
    step_no = int(gather(opt["step"]))
    t0 = time.perf_counter()
    ckpt.save(str(scratch), step_no, tree)
    save_s = time.perf_counter() - t0
    like = tree_map(tree, shape_dtype)
    t0 = time.perf_counter()
    s1, one = ckpt.restore(str(scratch), like, device=DEVICE)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    same_one = all(torch.equal(bits(gather(a)), bits(b)) for (_, a), (_, b)
                   in zip(paths(tree), paths(one)))
    del one
    layouts = tree_map(tree, lambda s: NamedSharding(s.mesh, s.spec))
    t0 = time.perf_counter()
    s2, back = ckpt.restore(str(scratch), like, shardings=layouts)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    same_mesh = all(a.spec == b.spec and all(
        torch.equal(bits(x), bits(y)) for x, y in zip(a.blocks, b.blocks))
        for (_, a), (_, b) in zip(paths(tree), paths(back)))
    files = sum(f.stat().st_size for f in scratch.rglob("*") if f.is_file())
    line = {"step": step_no, "restored_steps": [s1, s2],
            "file_bytes": files, "save_s": save_s,
            "restore_one_device_s": one_s, "restore_mesh_s": mesh_s,
            "bits_equal_one_device": same_one, "bits_equal_mesh": same_mesh}
    log({"shard_elastic": line})
    shutil.rmtree(scratch, ignore_errors=True)
    if not (same_one and same_mesh and s1 == s2 == step_no):
        raise RuntimeError(f"elastic restore: {line}")
    return line


def gpipe_check() -> dict:
    """14c: granite_3_2b's 40 bf16 layers (seed 0) as PIPE_STAGES stages
    over a ("pod",) mesh of the card, PIPE_MICRO microbatches of 1 x
    PIPE_TOKENS token rows forward through ``gpipe``, against the same
    layers run in sequence: equal bits."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import attention as mattn
    from repro_torch.models import transformer as tf
    from repro_torch.sharding import gather
    from repro_torch.sharding.pipeline import bubble_fraction, gpipe
    from repro_torch.utils.tree import tree_map

    cfg = get_arch(TRAIN_ARCH)
    params = tf.init_params(cfg, 0, device=DEVICE)
    per = cfg.n_layers // PIPE_STAGES
    stages = tree_map(params["blocks"], lambda t: t.view(
        PIPE_STAGES, per, *t.shape[1:]))
    g = torch.Generator(device="cpu").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (PIPE_MICRO, 1, PIPE_TOKENS),
                           generator=g).to(DEVICE)
    rot = mattn.rot_tables(cfg, torch.arange(PIPE_TOKENS, device=DEVICE))

    def stage(p, x):
        for pl in tf._layers(p):
            x = tf._block_full(x, pl, cfg, rot)[0]
        return x

    mesh = shard_mesh((PIPE_STAGES,), ("pod",))
    with torch.no_grad():
        xs = params["embed"][tokens.long()]             # (M, 1, S, d)
        t0 = time.perf_counter()
        ys = gather(gpipe(stage, mesh, "pod")(stages, xs))
        torch.cuda.synchronize()
        piped_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = torch.stack([stage(params["blocks"], xs[i])
                           for i in range(PIPE_MICRO)])
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
    line = {"stages": PIPE_STAGES, "layers_per_stage": per,
            "microbatches": PIPE_MICRO, "tokens": PIPE_TOKENS,
            "dtype": cfg.dtype, "bubble_fraction": bubble_fraction(
                PIPE_STAGES, PIPE_MICRO), "piped_s": piped_s,
            "sequential_s": seq_s, "bits_equal": torch.equal(
                bits(ys), bits(ref)),
            "max_abs_err": float((ys.float() - ref.float()).abs().max())}
    log({"shard_gpipe": line})
    if not line["bits_equal"]:
        raise RuntimeError(f"gpipe differs from the sequential layers: "
                           f"{line}")
    return line


def compression_check() -> dict:
    """14d: ``compressed_psum_mean`` of 8 seeded fp32 blocks of one
    granite layer's ``wu`` size over a ("data",) mesh of 8 on the card,
    against the same on the CPU (equal bits) and the exact mean (within
    2 max|g| / 127); then COMPRESS_STEPS steps of ``apply_error_feedback``
    on a constant gradient (a linspace over [-1, 1]), its drift under
    2e-3."""
    import torch

    from repro_torch.sharding import gather, place
    from repro_torch.train.compress import (apply_error_feedback,
                                            compressed_psum_mean)

    r, c = COMPRESS_BLOCK
    g = torch.Generator(device="cpu").manual_seed(0)
    gs = torch.randn(8 * r, c, generator=g)
    mesh = shard_mesh((8,), ("data",))
    cpu_mesh = dataclasses.replace(mesh, flat=(torch.device("cpu"),) * 8)
    t0 = time.perf_counter()
    card = gather(compressed_psum_mean(place(gs, mesh, ("data",)), "data"),
                  "cpu")
    card_s = time.perf_counter() - t0
    host = gather(compressed_psum_mean(place(gs, cpu_mesh, ("data",)),
                                       "data"))
    exact = gs.double().view(8, r, c).mean(0)
    err = float((card.view(8, r, c)[0].double() - exact).abs().max())
    bound = 2 * float(gs.abs().max()) / 127
    same = torch.equal(bits(card), bits(host))
    rows_equal = all(torch.equal(card.view(8, r, c)[i], card.view(8, r, c)[0])
                     for i in range(8))
    del host, exact
    const = torch.linspace(-1, 1, r * c).view(r, c).repeat(8, 1)
    gp = place(const, mesh, ("data",))
    e = place(torch.zeros_like(const), mesh, ("data",))
    tot = torch.zeros(r, c, dtype=torch.float64, device=DEVICE)
    for _ in range(COMPRESS_STEPS):
        avg, e = apply_error_feedback(gp, e, "data")
        tot += avg.blocks[0].double()
    drift = float((tot.cpu() / COMPRESS_STEPS - const[:r].double()).abs()
                  .max())
    line = {"blocks": 8, "block": [r, c], "bits_equal_cpu": same,
            "blocks_equal": rows_equal, "max_abs_err": err,
            "error_bound": bound, "card_s": card_s,
            "error_feedback_steps": COMPRESS_STEPS, "drift": drift}
    log({"shard_compression": line})
    if not (same and rows_equal and err < bound and drift < 2e-3):
        raise RuntimeError(f"gradient compression on the card: {line}")
    return line


def sharded_train_phase(counters) -> dict:
    """14. The sharded trainer on the card (a-e of the module docstring).
    Returns 14a's line."""
    import torch

    t_phase = time.perf_counter()
    mark("14a")
    run = sharded_granite_run(counters)
    mark("14b")
    sharded_exact(*SHARD_EXACT[1])
    params, opt = sharded_exact(*SHARD_EXACT[0], keep=True)
    mark("14e")
    elastic_check(params, opt, ROOT / "build" / "chip_smoke_elastic")
    del params, opt
    torch.cuda.empty_cache()
    mark("14c")
    gpipe_check()
    torch.cuda.empty_cache()
    mark("14d")
    compression_check()
    log({"shard_phase_s": time.perf_counter() - t_phase})
    return run


# --------------------------------------------- 15. the sharded families
def family_cfg(arch: str, layers=None, dtype=None):
    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def a2a_bytes(cfg, tokens: int, dp: int) -> dict:
    """The bytes the MoE FFN's two ``all_to_all`` s hand over a layer
    forward: each of the ``dp`` data rows sends its (E, cap, d) dispatch
    buffer cut into ``dp`` expert (or capacity) blocks, and each owner sends
    its (E/dp, cap, d) rows back to every row; the share that leaves its
    position is (dp - 1) / dp (on one card no byte leaves the device)."""
    from repro_torch.models import moe

    cap = moe.capacity(tokens, cfg.top_k, cfg.n_experts)
    one = dp * cfg.n_experts * cap * cfg.d_model * 2     # bf16
    return {"cap": cap, "dispatch_bytes": one, "return_bytes": one,
            "off_position_bytes": 2 * one * (dp - 1) // dp}


def family_train_run(tag, arch, layers, seq, counters, kernels) -> dict:
    """15a-15c: ``arch`` (cut to ``layers`` where given) at full width,
    bf16, seed 0, on the (4, 2) mesh of the card: FAM_STEPS steps of
    ``build_train_step`` (microbatches 1, remat on, the launcher's AdamW)
    on ``SyntheticLM(vocab, seq, 4, seed 0)``, the last profiled; each
    kernel of ``kernels`` launched 8 positions x layers x 2 (forward,
    remat recompute) a step and nothing else; finite losses."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import attention as mattn
    from repro_torch.models import moe
    from repro_torch.models import parallel_ssm as pssm
    from repro_torch.models import transformer as tf
    from repro_torch.sharding import MeshRules, place_tree
    from repro_torch.train import step as tstep

    cfg = family_cfg(arch, layers)
    rules = MeshRules(shard_mesh())
    shape = ShapeConfig("train_4k", seq, FAM_BATCH, "train")
    step, in_sh, _, _ = tstep.build_train_step(
        cfg, shape, rules, train_adamw(FAM_STEPS), microbatches=1,
        remat=True)
    stream = SyntheticLM(cfg.vocab, seq, FAM_BATCH, seed=0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, 0, device=DEVICE)
    pd = place_tree(params, in_sh[0])
    del params
    torch.cuda.empty_cache()
    opt = tstep.sharded_adamw_init(pd)
    init_s = time.perf_counter() - t0
    held = {"param_bytes_distinct": distinct_bytes(pd),
            "adamw_state_bytes_distinct": distinct_bytes(
                {"mu": opt["mu"], "nu": opt["nu"]}),
            "parameters": cfg.param_count()}
    rows = []
    events, undo = timed_calls(tstep, "_sharded_adamw")
    grabbed = {}                # position (0, 0)'s layer-0 kernel inputs
    if "flash_attention" in kernels:
        grabbed["flash_attention"], old = capture_first(
            mattn, "katt", "flash_attention")
        undo += old
    if "ssd_scan" in kernels:
        grabbed["ssd_scan"], old = capture_first(pssm, "kssd", "ssd_scan")
        undo += old
    moe.stats.reset()
    for fn in counters.values():
        fn.launches = 0
    t_run = time.perf_counter()
    try:
        pd, opt, prof = run_steps(step, pd, opt, stream, in_sh, rows, events,
                                  FAM_STEPS, FAM_STEPS - 1,
                                  f"family_train_step[{tag}]")
    finally:
        swap_in(undo)
    wall = time.perf_counter() - t_run
    got = {k: fn.launches for k, fn in counters.items()}
    want = {k: 8 * cfg.n_layers * 2 * FAM_STEPS for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    drops = moe.stats.read()
    del pd, opt
    torch.cuda.empty_cache()
    at_shape = {}               # each kernel at a position's shape
    if "flash_attention" in grabbed:
        (q, k, v, *rest), kw = grabbed.pop("flash_attention")[0]
        at_shape["flash_attention"] = flash_training_line(
            q.detach(), k.detach(), v.detach(),
            rest[0] if rest else kw.get("window", 0),
            f"flash_attention[{tag} {arch}]")
    if "ssd_scan" in grabbed:
        (x, dt, a, b, c, chunk), _ = grabbed.pop("ssd_scan")[0]
        at_shape["ssd_scan"] = ssd_training_line(
            tuple(t.detach() for t in (x, dt, a, b, c)), chunk,
            f"ssd_scan[{tag} {arch}]")
    timed = [r["step_ms"] for r in rows if r["step"] in FAM_TIMED]
    step_ms = statistics.median(timed)
    tokens = FAM_BATCH * seq
    line = {"tag": tag, "arch": cfg.name, "layers": cfg.n_layers,
            "mesh": list(SHARD_TRAIN_MESH), "batch": FAM_BATCH, "seq": seq,
            "dtype": cfg.dtype, "init_s": init_s, **held,
            "losses": [r["loss"] for r in rows],
            "grad_norms": [r["grad_norm"] for r in rows],
            "step_ms": [r["step_ms"] for r in rows],
            "adamw_ms": [r["adamw_ms"] for r in rows],
            "step_ms_median_timed": step_ms,
            "tokens_per_s_median_step": tokens / (step_ms / 1e3),
            "tokens_per_s_run_wall": tokens * FAM_STEPS / wall,
            "peak_memory_bytes": peak, "peak_gb": peak / 1e9,
            "profile": {k: prof[k] for k in (
                "wall_ms", "device_ms", "device_kernels",
                "device_busy_share", "top_kernels")},
            "launches": got, "launches_reckoned": want,
            "backward_launches": "none: the backward is the plain "
                                 "version's derivative (ROADMAP B-T1, B-T2)",
            "kernels_at_position_shape": at_shape}
    if cfg.is_moe:
        line["moe"] = {**drops, **a2a_bytes(cfg, tokens, rules.extent(
            ("data",)))}
    log({"family_train_run": line})
    bad = [r for r in rows if not (math.isfinite(r["loss"])
                                   and math.isfinite(r["grad_norm"]))]
    if bad or any(got[k] != want.get(k, 0) for k in got):
        raise RuntimeError(f"family train {tag}: not finite {bad}, or "
                           f"launches {got}, expected {want} and nothing "
                           "else")
    return line


def cache_errors(got, want, skip=None) -> dict:
    """Each cache leaf of the sharded path (gathered) against one
    device's: integer leaves equal, float leaves' largest |difference| as a
    share of the one-device leaf's largest magnitude; ``skip`` ((B, W)
    bool) leaves those ring slots out of ``attn/k`` and ``attn/v``."""
    import torch

    from repro_torch.sharding import gather
    from repro_torch.utils.tree import paths

    out = {}
    for (k, s), (_, w) in zip(paths(got), paths(want)):
        g = gather(s)
        if w.dtype in (torch.int32, torch.int64):
            out[k] = 0.0 if torch.equal(g, w) else math.inf
        else:
            if skip is not None and k in ("attn/k", "attn/v"):
                keep = ~skip[None, :, :, None, None]
                g, w = g * keep, w * keep
            out[k] = max_err(g, w) / max(float(w.float().abs().max()), 1e-30)
        del g
    return out


class RouteLog:
    """The MoE routing of a run, a call at a time: which experts keep each
    token (its replicas below the capacity), as a (T, E) bool matrix, from
    ``models.moe.route`` on one device and from ``parallel_moe.routing``
    (the data rows' tokens in order) on the mesh. In bf16 the two paths'
    router inputs differ by roundings, and a near tie can send a token to
    another expert (phase 11 logs that share between the kernel and plain
    paths); the steps and cache slots such a token touches are left out of
    15d's gates and counted."""

    def __init__(self):
        self.calls = {"one": [], "sharded": []}
        self.gaps = []          # one device: each token's p_k - p_(k+1)

    @staticmethod
    def kept(eidx, keep, e: int):
        import torch

        t, k = eidx.shape
        return torch.zeros(t, e, dtype=torch.bool, device=eidx.device
                           ).scatter(1, eidx, keep.view(t, k))

    def one_device(self, e: int):
        import torch

        from repro_torch.models import moe

        real = moe.route

        def rec(xf, router, k, *a, **kw):
            r = real(xf, router, k, *a, **kw)
            with torch.no_grad():
                self.calls["one"].append(self.kept(r.eidx, r.keep, e))
                top = torch.softmax(xf.detach().float() @ router.detach(),
                                    -1).topk(k + 1).values
                self.gaps.append(top[:, k - 1] - top[:, k])
            return r
        return swap_in([(moe, "route", rec)])

    def sharded(self, e: int, m: int = SHARD_TRAIN_MESH[1]):
        """Record the mesh's routing; ``m`` the ``model`` extent (the
        data rows' tokens are read from every m-th position)."""
        import torch

        from repro_torch.models import parallel_moe as pmoe

        real = pmoe.routing

        def rec(h, router, cfg, plan):
            out = real(h, router, cfg, plan)
            eidx, _, _, keep = out[0][:4]
            self.calls["sharded"].append(self.kept(
                torch.cat(eidx.blocks[::m]), torch.cat(keep.blocks[::m]), e))
            return out
        return swap_in([(pmoe, "routing", rec)])

    def flips(self, calls: int) -> list:
        """Per call of the first ``calls``: (the tokens whose kept experts
        differ, their gaps between the k-th and the next expert's
        probability on one device)."""
        out = []
        for c in range(calls):
            t = (self.calls["one"][c] != self.calls["sharded"][c]).any(1)
            idx = t.nonzero().flatten()
            out.append((idx.tolist(), self.gaps[c][idx].tolist()))
        return out

    def differ(self, layers: int, b: int, prompt: int) -> dict:
        """{segment (0: the prefill, t: decode step t): the (row, position)
        of each token whose kept experts differ between the paths in some
        layer}."""
        one, sh = self.calls["one"], self.calls["sharded"]
        if len(one) != len(sh):
            raise RuntimeError(f"MoE calls: {len(one)} on one device, "
                               f"{len(sh)} on the mesh")
        out = {}
        for c, (a, z) in enumerate(zip(one, sh)):
            seg = c // layers
            for t in (a != z).any(1).nonzero().flatten().tolist():
                out.setdefault(seg, set()).add(
                    (t // prompt, t % prompt) if seg == 0
                    else (t, prompt + seg - 1))
        return out


def serve_pair(cfg, box, toks, prompt: int, seq: int, steps: int,
               counters, label: str, rel: float, grab: bool = False,
               drift: bool = False, keep_placed: bool = False,
               rules=None) -> dict:
    """The sharded prefill of ``toks[:, :prompt]`` (token ids, or a prompt
    batch of embeddings and M-RoPE positions) into a ``seq``-slot
    cache and ``steps`` teacher-forced decode steps
    (``build_prefill_step`` / ``build_decode_step`` on ``rules``' mesh,
    default the (4, 2) mesh of
    the card) against one device's ``prefill`` / ``decode_step`` on the
    same weights (``box``: a list holding them, emptied so that they are
    freed once placed): each step's logits within
    ``rel`` of one device's largest, the final caches (gathered) within
    ``rel`` of each leaf's largest, integer leaves equal. With ``drift``
    (a bf16 model with an SSM or experts) the bound is phase 9's instead:
    SSM_BF16_DRIFT_RATIO times how far one device's bf16 run strays from
    the same run with the weights upcast to fp32 (the largest over the
    steps; per leaf for the caches). The sharded run's launches are read
    from ``counters`` (zeroed just before it). With ``grab``, position (0,
    0)'s B8 inputs at layer 0 of the first sharded decode step come back
    under ``decode_args``; with ``keep_placed``, the placed weights under
    ``placed``."""

    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.models import moe
    from repro_torch.models import parallel_serve as pserve
    from repro_torch.models import transformer as tf
    from repro_torch.sharding import MeshRules, gather, place_tree
    from repro_torch.train import step as tstep
    from repro_torch.utils.tree import paths

    params = box.pop()
    batch = toks if isinstance(toks, dict) else {"tokens": toks}
    b = next(iter(batch.values())).shape[0]
    routes = RouteLog()
    undo = routes.one_device(cfg.n_experts) if cfg.is_moe else []
    moe.stats.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, c0 = tf.prefill(params, cfg, prefix(batch, prompt),
                        seq_len_cache=seq)
    torch.cuda.synchronize()
    one_prefill_ms = (time.perf_counter() - t0) * 1e3
    one = [lg.float()]
    t0 = time.perf_counter()
    for t in range(steps):
        lg, c0 = tf.decode_step(params, cfg, at(batch, prompt + t), c0)
        one.append(lg.float())
    torch.cuda.synchronize()
    one_decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    one_drops = moe.stats.read()
    swap_in(undo)
    if drift:                   # the same run with the weights upcast
        from repro_torch.utils.tree import tree_map

        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = tree_map(params, lambda t: t.float())
        lg, c32 = tf.prefill(p32, cfg32, prefix(batch, prompt),
                             seq_len_cache=seq)
        up = [lg]
        for t in range(steps):
            lg, c32 = tf.decode_step(p32, cfg32, at(batch, prompt + t), c32)
            up.append(lg)
        del p32
        torch.cuda.empty_cache()
    rules = rules or MeshRules(shard_mesh())
    pf, pin, pout, _ = tstep.build_prefill_step(
        cfg, ShapeConfig("prefill", seq, b, "prefill"), rules)
    df, din, _, _ = tstep.build_decode_step(
        cfg, ShapeConfig("decode", seq, b, "decode"), rules)
    pd = place_tree(params, pin[0])
    del params
    torch.cuda.empty_cache()
    moe.stats.reset()
    seen, undo = [], []
    if grab:
        seen, undo = grab_first(pserve, "katt", "decode_attention")
    if cfg.is_moe:
        undo += routes.sharded(cfg.n_experts, rules.mesh.shape["model"])
    for fn in counters.values():
        fn.launches = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = pf(pd, place_tree(prefix(batch, prompt), pin[1]))
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_launches = {k: fn.launches for k, fn in counters.items()}
        got = [gather(lg).float()]
        dec_ms = []
        for t in range(steps):
            tb = place_tree(at(batch, prompt + t), din[2])
            t0 = time.perf_counter()
            lg, cache = df(pd, cache, tb)
            torch.cuda.synchronize()
            dec_ms.append((time.perf_counter() - t0) * 1e3)
            got.append(gather(lg).float())
    finally:
        swap_in(undo)
    launches = {k: fn.launches for k, fn in counters.items()}
    drops = moe.stats.read()
    errs = [(max_err(g, w), float(w.abs().max())) for g, w in zip(got, one)]
    flips = (routes.differ(cfg.n_layers, b, prompt) if cfg.is_moe else {})
    # a row's logits whose own token went to other experts are not gated
    ungated = [(i, r) for i in range(len(got)) for r in range(b)
               if (r, prompt + i - 1) in flips.get(i, ())]
    worst = max(max_err(g[r], w[r]) / float(w.abs().max())
                for i, (g, w) in enumerate(zip(got, one)) for r in range(b)
                if (i, r) not in ungated)
    skip = None
    if flips:
        ap = c0["attn"]["abs_pos"][0]                       # (B, W)
        skip = torch.zeros_like(ap, dtype=torch.bool)
        for row, p in set().union(*flips.values()):
            skip[row] |= ap[row] == p
    cerr = cache_errors(cache, c0, skip)
    rule = "a share of one device's largest"
    gate = {"logits": (worst, rel)}
    gate.update({k: (e, rel) for k, e in cerr.items()})
    if drift:
        d_logits = max(max_err(a, b) for a, b in zip(one, up))
        gap = max(max_err(g[r], w[r]) for i, (g, w) in enumerate(zip(
            got, one)) for r in range(b) if (i, r) not in ungated)
        rule = "SSM_BF16_DRIFT_RATIO x one device's bf16 - fp32 distance"
        gate = {"logits": (gap, SSM_BF16_DRIFT_RATIO * d_logits)}
        for k, e in cerr.items():
            w16 = dict(paths(c0))[k]
            if w16.dtype in (torch.int32, torch.int64):
                gate[k] = (e, 0.0)
                continue
            w32 = dict(paths(c32))[k]
            keep = (~skip[None, :, :, None, None] if skip is not None
                    and k in ("attn/k", "attn/v") else 1)
            scale = max(float(w16.float().abs().max()), 1e-30)
            gate[k] = (e * scale, SSM_BF16_DRIFT_RATIO * max_err(
                w16 * keep, w32 * keep))
        del c32, up
    line = {"label": label, "arch": cfg.name, "layers": cfg.n_layers,
            "mesh": dict(rules.mesh.shape),
            "seq_sharding": rules.seq_sharding,
            "batch": b, "prompt": prompt, "cache_slots": int(
                cache["attn"]["k"].shape[2]) if "attn" in cache else None,
            "steps": steps, "dtype": cfg.dtype,
            "cache_specs": {k: str(v.spec) for k, v in paths(cache)},
            "prefill_ms": prefill_ms, "decode_ms": dec_ms,
            "decode_ms_median": statistics.median(dec_ms),
            "one_device_prefill_ms": one_prefill_ms,
            "one_device_decode_ms": one_decode_ms,
            "logit_errs": [e for e, _ in errs],
            "logit_err_worst_share": worst, "bound_share": rel,
            "route_differs": {str(k): sorted(v) for k, v in flips.items()},
            "logit_rows_ungated": ungated,
            "cache_slots_ungated": 0 if skip is None else int(skip.sum()),
            "cache_err_share": cerr, "gate_rule": rule,
            "gate": gate, "gate_ok": all(e <= lim for e, lim in
                                         gate.values()),
            "prefill_launches": prefill_launches,
            "launches": launches}
    if cfg.is_moe:
        line["moe_drops"] = {"sharded": drops, "one_device": one_drops}
    if keep_placed:
        line["placed"] = pd
    del pd, cache, c0, got, one
    torch.cuda.empty_cache()
    if grab:
        line["decode_args"] = seen[0]
    return line


def grab_first(module, attr, fn, when=None):
    """:func:`capture_first` keeping copies of the first call's tensors
    (the call's inputs may be views that later calls change); with
    ``when``, of the first call whose arguments it accepts."""
    import torch

    real = getattr(module, attr)
    seen = []

    def keep(*a, **kw):
        if not seen and (when is None or when(*a)):
            seen.append(tuple(t.clone() for t in a
                              if isinstance(t, torch.Tensor)))
        return getattr(real, fn)(*a, **kw)
    ns = types.SimpleNamespace(**{k: getattr(real, k) for k in dir(real)
                                  if not k.startswith("__")})
    setattr(ns, fn, keep)
    return seen, swap_in([(module, attr, ns)])


def family_serve_run(katt, arch, layers, prompt, seq, counters,
                     local_line: bool) -> dict:
    """15d: ``arch`` (cut to ``layers``) at full width, bf16, seed 0: the
    sharded prefill and FAM_SERVE_STEPS decode steps against one device
    (:func:`serve_pair`, at LM_BF16_REL); B8 launched 8 positions x layers a
    step, B7 (and B9) 8 x layers in the prefill. With ``local_line``, B8
    on position (0, 0)'s captured inputs against its plain version and
    SDPA (its slot range), and the merge's time at that shape."""
    import torch

    from repro_torch.models import parallel_serve as pserve
    from repro_torch.models import transformer as tf

    cfg = family_cfg(arch, layers)
    g = torch.Generator(device="cpu").manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (FAM_BATCH, prompt + FAM_SERVE_STEPS),
                         generator=g).to(DEVICE)
    line = serve_pair(cfg, [tf.init_params(cfg, 0, device=DEVICE)], toks,
                      prompt, seq, FAM_SERVE_STEPS, counters, f"15d {arch}",
                      LM_BF16_REL, local_line,
                      drift=cfg.has_ssm or cfg.is_moe)
    per_layer = 8 * cfg.n_layers
    want_dec = {"decode_attention": per_layer * FAM_SERVE_STEPS}
    want_pre = {"flash_attention": per_layer}
    if cfg.has_ssm:
        want_pre["ssd_scan"] = per_layer
    got_pre = line["prefill_launches"]
    got_dec = {k: line["launches"][k] - got_pre[k] for k in got_pre}
    line["launches_reckoned"] = {"prefill": want_pre, "decode": want_dec}
    ok = (all(got_pre[k] == want_pre.get(k, 0) for k in got_pre)
          and all(got_dec[k] == want_dec.get(k, 0) for k in got_dec))
    if local_line:
        args = line.pop("decode_args")          # q, k, v, abs_pos, pos
        ap = args[3]
        line["b8_position_local"] = attention_check(
            katt, "sharded decode", "decode_attention",
            f"position 0 of 2, {ap.shape[1]} slots", args, cfg.window)
        outs = torch.stack([katt.decode_attention(*args, cfg.window)] * 2)
        lse = torch.stack([katt.decode_attention(
            *args, cfg.window, return_lse=True)[1]] * 2)
        line["merge_ms"] = queued_ms(
            lambda: pserve.merge_softmax(outs, lse), 50)
        line["merge_shape"] = list(outs.shape)
    log({"family_serve_run": line})
    if (not ok or not line["gate_ok"]
            or not all(math.isfinite(e) for e in line["logit_errs"])):
        raise RuntimeError(f"family serve {arch}: launches "
                           f"{line['prefill_launches']} / "
                           f"{line['launches']} (reckoned "
                           f"{line['launches_reckoned']}), gate "
                           f"{line['gate']}")
    return line


def leaf_err(a, b) -> float:
    """A placed gradient leaf ``a`` against ``b`` (on the host): the
    largest |difference| over b's largest magnitude, a layer at a time for
    a stacked leaf (a MoE layer's experts are GBs in fp32)."""
    from repro_torch.sharding import gather, smap

    parts = [(a, b)]
    if len(a.shape) >= 3 and not a.spec.axes(0):
        parts = [(smap(lambda t, i=i: t[i], a, out=tuple(a.spec)[1:]), b[i])
                 for i in range(a.shape[0])]
    worst = 0.0
    for s_, w in parts:
        g, w = gather(s_), w.to(DEVICE)
        worst = max(worst, float((g - w).abs().max()))
        del g, w
    return worst / max(float(b.abs().max()), 1e-30)


def family_exact(arch: str, counters, tag: str = "15e", rules=None,
                 serve: bool = True) -> dict:
    """15e: the fp32 ``arch`` cut to FAM_EXACT_LAYERS layers at full width
    on ``SyntheticLM(vocab, FAM_EXACT_SEQ, 4, seed 0)``: the sharded loss
    and every gathered gradient leaf against the single-device
    ``value_and_grad`` (the loss within SHARD_REL relative, each leaf
    within FAM_EXACT_REL's bound of its largest; with an SSM, each leaf's
    spread when one device takes its batch in two halves printed beside),
    the MoE drop counts equal, B7 (and B9) launched positions x layers x 2
    (forward, remat recompute) and nothing else; then (with ``serve``) the
    prefill of the batch's first FAM_EXACT_PROMPT tokens and
    FAM_EXACT_STEPS decode steps against one device's (:func:`serve_pair`,
    at the same bound; B7 and B9 positions x layers in the prefill, B8
    positions x layers a decode step). ``rules``: the mesh and rules
    (default the (4, 2) mesh, no sequence sharding); 16c and 16d run it
    on others under their ``tag``."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.sharding import MeshRules, gather, place_tree
    from repro_torch.train import step as tstep
    from repro_torch.utils.tree import paths

    from repro_torch.models import parallel as par

    cfg = family_cfg(arch, FAM_EXACT_LAYERS, "float32")
    rel = FAM_EXACT_REL.get(arch, SHARD_GRAD_REL)
    rules = rules or MeshRules(shard_mesh())
    npos, m = len(rules.mesh.flat), rules.mesh.shape["model"]
    shape = ShapeConfig("exact", FAM_EXACT_SEQ, FAM_BATCH, "train")
    _, in_sh, _, _ = tstep.build_train_step(cfg, shape, rules,
                                            microbatches=1)
    batch = on_card(SyntheticLM(cfg.vocab, FAM_EXACT_SEQ, FAM_BATCH,
                                seed=0).batch_at(0))
    params = tf.init_params(cfg, 0, device=DEVICE)
    routes = RouteLog()
    undo = routes.one_device(cfg.n_experts) if cfg.is_moe else []
    moe.stats.reset()
    l0, g0 = tstep.value_and_grad(params, cfg, batch)
    drops0 = moe.stats.read()
    swap_in(undo)
    halves = {}
    if cfg.has_ssm:             # one device's spread over another order
        hs = [tstep.value_and_grad(params, cfg, {
            k: v[h * FAM_BATCH // 2:(h + 1) * FAM_BATCH // 2]
            for k, v in batch.items()})[1] for h in (0, 1)]
        for (k, _), a, b, c in zip(paths(params), *hs, g0):
            halves[k] = float(((a + b) / 2 - c).abs().max()
                              / c.abs().max().clamp(min=1e-30))
        del hs
    g0 = [g.cpu() for g in g0]
    torch.cuda.empty_cache()
    # the serving comparison first: it places the weights and frees one
    # device's (two fp32 copies of a MoE layer pair and its gradient do
    # not fit the card beside each other)
    box = [params]
    del params
    per_layer = npos * cfg.n_layers
    serve_want = {}
    if serve:
        serve = serve_pair(cfg, box, batch["tokens"], FAM_EXACT_PROMPT,
                           FAM_EXACT_PROMPT + FAM_EXACT_STEPS,
                           FAM_EXACT_STEPS, counters, f"{tag} {arch}", rel,
                           keep_placed=True, rules=rules)
        pd = serve.pop("placed")
        pre = {"flash_attention": per_layer if cfg.has_attention else 0,
               "ssd_scan": per_layer if cfg.has_ssm else 0}
        serve_want = {"prefill": pre, "decode": {
            "decode_attention": per_layer * FAM_EXACT_STEPS
            if cfg.has_attention else 0}}
        serve_got = {"prefill": serve["prefill_launches"], "decode": {
            k: n - serve["prefill_launches"][k]
            for k, n in serve["launches"].items()}}
    else:
        pd = place_tree(box.pop(), in_sh[0])
        torch.cuda.empty_cache()
    bd = place_tree(batch, in_sh[2])
    undo = routes.sharded(cfg.n_experts, m) if cfg.is_moe else []
    specs = []                  # each block input's layout

    def block(x, *a, **kw):
        specs.append(str(x.spec))
        return real_block(x, *a, **kw)
    real_block = par._block
    undo += swap_in([(par, "_block", block)])
    moe.stats.reset()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        l1, g1 = tstep.sharded_value_and_grad(pd, cfg, bd, rules)
        torch.cuda.synchronize()
    finally:
        swap_in(undo)
    vg_s = time.perf_counter() - t0
    got = {k: fn.launches for k, fn in counters.items()}
    want = {"flash_attention": 2 * per_layer if cfg.has_attention else 0,
            "ssd_scan": 2 * per_layer if cfg.has_ssm else 0}
    drops1 = moe.stats.read()
    # the forward's routing (the remat recompute routes again after it)
    flips = (routes.flips(cfg.n_layers) if cfg.is_moe else [])
    flipped = [(c, t, g) for c, (ts, gs) in enumerate(flips)
               for t, g in zip(ts, gs)]
    del pd, bd
    grad_err = {k: leaf_err(a, b) for (k, a), b in zip(paths(g1), g0)}
    del g1, g0
    torch.cuda.empty_cache()
    loss_rel = abs(float(gather(l1)) - float(l0)) / abs(float(l0))
    line = {"tag": tag, "arch": cfg.name, "layers": cfg.n_layers,
            "mesh": dict(rules.mesh.shape),
            "seq_sharding": rules.seq_sharding,
            "block_input_specs": sorted(set(specs)),
            "batch": FAM_BATCH, "seq": FAM_EXACT_SEQ,
            "loss": float(gather(l1)),
            "single_loss": float(l0), "loss_rel": loss_rel,
            "grad_rel_worst": max(grad_err.values()),
            "grad_rel_worst_leaf": max(grad_err, key=grad_err.get),
            "grad_rel_by_leaf": grad_err, "grad_bound": rel,
            "single_halves_grad_rel_by_leaf": halves,
            "sharded_value_and_grad_s": vg_s,
            "launches": got, "launches_reckoned": want}
    if serve:
        line.update({"logit_err_worst_share": serve["logit_err_worst_share"],
                     "cache_err_share": serve["cache_err_share"],
                     "prefill_ms": serve["prefill_ms"],
                     "decode_ms_median": serve["decode_ms_median"],
                     "serve_launches": serve_got,
                     "serve_launches_reckoned": serve_want})
    if cfg.is_moe:
        line["drops"] = {"sharded": drops1, "one_device": drops0,
                         "serve": serve["moe_drops"] if serve else None}
        line["route_flips"] = [{"layer": c, "token": t, "gap": g}
                               for c, t, g in flipped]
    log({"family_exact": line})
    same_drops = not cfg.is_moe or (
        drops0["dropped"] == drops1["dropped"] and (
            not serve or serve["moe_drops"]["sharded"]["dropped"]
            == serve["moe_drops"]["one_device"]["dropped"]))
    if any(got[k] != want.get(k, 0) for k in got) or any(
            serve_got[w][k] != serve_want[w].get(k, 0)
            for w in serve_want for k in serve_got[w]):
        raise RuntimeError(f"family exact {arch} ({tag}): launches {got}, "
                           f"expected {want} and nothing else; serving "
                           f"{serve_got if serve else None}, expected "
                           f"{serve_want}")
    first = min((c for c, _, _ in flipped), default=None)
    if any(g > FAM_NEAR_TIE for c, _, g in flipped if c == first):
        raise RuntimeError(f"family exact {arch}: a token routed apart "
                           f"with no near tie: {line['route_flips']}")
    if flipped:
        # a token at a tie between its k-th and next expert goes to either
        # on the two paths; past the capacity that moves a replica across
        # the line, the later tokens' inputs part, and so do later layers'
        # routes: the loss, the drops and the gradients are logged, not
        # gated
        log({"family_exact_ungated": {
            "arch": arch, "route_flips": line["route_flips"],
            "loss_rel": loss_rel, "grad_rel_worst": line["grad_rel_worst"],
            "drops": [drops0["dropped"], drops1["dropped"]]}})
    elif (loss_rel > SHARD_REL or line["grad_rel_worst"] > rel
            or not same_drops):
        raise RuntimeError(f"family exact {arch}: {line}")
    if serve and not serve["gate_ok"]:
        raise RuntimeError(f"family exact {arch}: serving gate "
                           f"{serve['gate']}")
    return line


def families_phase(katt, counters) -> dict:
    """15. The sharded families and serving steps on the card (a-e of the
    module docstring). Returns {sub-phase: its line}."""
    import torch

    t_phase = time.perf_counter()
    out = {}
    mark("15a")
    out["15a"] = family_train_run("15a", FAM_TRAIN[0], FAM_TRAIN_LAYERS,
                                  TRAIN_SEQ, counters, ("ssd_scan",))
    mark("15b")
    out["15b"] = family_train_run("15b", FAM_TRAIN[1], FAM_TRAIN_LAYERS,
                                  TRAIN_SEQ, counters,
                                  ("flash_attention", "ssd_scan"))
    mark("15c")
    for arch, seq in FAM_MOE:
        out[f"15c {arch}"] = family_train_run(
            "15c", arch, 1, seq, counters, ("flash_attention",))
    mark("15d")
    for i, (arch, layers, prompt, seq) in enumerate(FAM_SERVE):
        out[f"15d {arch}"] = family_serve_run(katt, arch, layers, prompt,
                                              seq, counters, i == 0)
    torch.cuda.empty_cache()
    mark("15e")
    for arch in FAM_EXACT:
        out[f"15e {arch}"] = family_exact(arch, counters)
        torch.cuda.empty_cache()
    log({"families_phase_s": time.perf_counter() - t_phase})
    return out


# ------------------------- 16. sequence sharding, the production meshes' cells
def seq_serve_check(pd, cfg, counters) -> dict:
    """16b: granite_3_2b's sharded prefill of 15d's 4 x 4,096 tokens into
    32,768 slots and SEQ_SERVE_STEPS decode steps on the (4, 2) mesh with
    ``MeshRules(seq_sharding=True)``, against 15d's sharded run without it
    on the same placed weights ``pd``: each step's logits and every
    gathered cache leaf within LM_BF16_REL of the largest (integer leaves
    equal); with sequence sharding B7 launched 8 x layers in the prefill
    and B8 8 x layers a decode step, nothing else."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.sharding import MeshRules, gather, gather_tree
    from repro_torch.sharding import place_tree
    from repro_torch.train import step as tstep

    _, _, prompt, seq = FAM_SERVE[0]
    g = torch.Generator(device="cpu").manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (FAM_BATCH, prompt + SEQ_SERVE_STEPS),
                         generator=g).to(DEVICE)
    runs = {}
    for split in (False, True):
        rules = MeshRules(shard_mesh(), seq_sharding=split)
        pf, pin, _, _ = tstep.build_prefill_step(
            cfg, ShapeConfig("prefill", seq, FAM_BATCH, "prefill"), rules)
        df, din, _, _ = tstep.build_decode_step(
            cfg, ShapeConfig("decode", seq, FAM_BATCH, "decode"), rules)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = pf(pd, place_tree({"tokens": toks[:, :prompt]}, pin[1]))
        torch.cuda.synchronize()
        run = {"prefill_ms": (time.perf_counter() - t0) * 1e3,
               "prefill_launches": {k: fn.launches
                                    for k, fn in counters.items()},
               "logits": [gather(lg).float()], "decode_ms": []}
        for t in range(SEQ_SERVE_STEPS):
            tb = place_tree({"tokens": toks[:, prompt + t]}, din[2])
            t0 = time.perf_counter()
            lg, cache = df(pd, cache, tb)
            torch.cuda.synchronize()
            run["decode_ms"].append((time.perf_counter() - t0) * 1e3)
            run["logits"].append(gather(lg).float())
        run["launches"] = {k: fn.launches - run["prefill_launches"][k]
                           for k, fn in counters.items()}
        run["cache"] = cache if split else gather_tree(cache)
        del cache
        runs[split] = run
    want, got = runs[False], runs[True]
    errs = [max_err(a, b) / float(b.abs().max())
            for a, b in zip(got["logits"], want["logits"])]
    cerr = cache_errors(got["cache"], want["cache"])
    per_layer = 8 * cfg.n_layers
    reckoned = {"prefill": {"flash_attention": per_layer},
                "decode": {"decode_attention": per_layer * SEQ_SERVE_STEPS}}
    line = {"arch": cfg.name, "layers": cfg.n_layers, "batch": FAM_BATCH,
            "prompt": prompt, "cache_slots": seq,
            "steps": SEQ_SERVE_STEPS, "dtype": cfg.dtype,
            "prefill_ms": got["prefill_ms"], "decode_ms": got["decode_ms"],
            "no_seq_prefill_ms": want["prefill_ms"],
            "no_seq_decode_ms": want["decode_ms"],
            "logit_err_share": errs, "cache_err_share": cerr,
            "bound_share": LM_BF16_REL,
            "prefill_launches": got["prefill_launches"],
            "decode_launches": got["launches"],
            "launches_reckoned": reckoned}
    del runs, want, got
    torch.cuda.empty_cache()
    log({"seq_serve_run": line})
    ok = all(line["prefill_launches"][k] == reckoned["prefill"].get(k, 0)
             and line["decode_launches"][k] == reckoned["decode"].get(k, 0)
             for k in counters)
    if not (ok and max(errs) <= LM_BF16_REL and all(
            e <= LM_BF16_REL for e in cerr.values())):
        raise RuntimeError(f"seq serve: {line}")
    return line


def seq_train_run(pd, cfg, counters, shard_run) -> dict:
    """16a: granite_3_2b at full width and depth, bf16, on the (4, 2) mesh
    with ``MeshRules(seq_sharding=True)``: SEQ_TRAIN_STEPS steps of
    ``build_train_step`` (microbatches 1, remat on, the launcher's AdamW)
    on 14a's ``SyntheticLM(vocab, 4096, 4, seed 0)`` from the placed
    weights ``pd``: step ms, tokens/s, peak bytes and the busy share
    beside 14a's; the bytes remat keeps of a layer a position (the block
    input: the position's rows); finite losses; B7 launched 8 positions x
    layers x 2 (forward, remat recompute) a step and nothing else; B7 at a
    position's shape (the whole sequence: the heads split, not the
    rows)."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import attention as mattn
    from repro_torch.models import parallel as par
    from repro_torch.sharding import MeshRules, PartitionSpec
    from repro_torch.train import step as tstep

    rules = MeshRules(shard_mesh(), seq_sharding=True)
    shape = ShapeConfig("train_4k", TRAIN_SEQ, SHARD_TRAIN_BATCH, "train")
    step, in_sh, _, _ = tstep.build_train_step(
        cfg, shape, rules, train_adamw(SEQ_TRAIN_STEPS), microbatches=1,
        remat=True)
    stream = SyntheticLM(cfg.vocab, TRAIN_SEQ, SHARD_TRAIN_BATCH, seed=0)
    opt = tstep.sharded_adamw_init(pd)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    events, undo = timed_calls(tstep, "_sharded_adamw")
    seen, old = capture_first(mattn, "katt", "flash_attention")
    undo += old
    inputs = []                 # the first block's input, as remat keeps it

    def block(x, *a, **kw):
        if not inputs:
            inputs.append((str(x.spec), list(x.blocks[0].shape),
                           x.blocks[0].numel() * x.blocks[0].element_size()))
        return real_block(x, *a, **kw)
    real_block = par._block
    undo += swap_in([(par, "_block", block)])
    for fn in counters.values():
        fn.launches = 0
    t_run = time.perf_counter()
    try:
        pd, opt, prof = run_steps(step, pd, opt, stream, in_sh, rows, events,
                                  SEQ_TRAIN_STEPS, SEQ_TRAIN_STEPS - 1,
                                  "seq_train_step")
    finally:
        swap_in(undo)
    wall = time.perf_counter() - t_run
    got = {k: fn.launches for k, fn in counters.items()}
    want = {"flash_attention": 8 * cfg.n_layers * 2 * SEQ_TRAIN_STEPS}
    peak = torch.cuda.max_memory_allocated()
    del opt
    torch.cuda.empty_cache()
    (q, k, v, *rest), kw = seen[0]          # position (0, 0), layer 0
    flash = flash_training_line(q.detach(), k.detach(), v.detach(),
                                rest[0] if rest else kw.get("window", 0),
                                "flash_attention[16a seq_sharded]")
    del q, k, v, seen
    step_ms = statistics.median(r["step_ms"] for r in rows
                                if r["step"] in SEQ_TRAIN_TIMED)
    tokens = SHARD_TRAIN_BATCH * TRAIN_SEQ
    spec, local, nbytes = inputs[0]
    line = {"arch": cfg.name, "mesh": list(SHARD_TRAIN_MESH),
            "seq_sharding": True, "batch": SHARD_TRAIN_BATCH,
            "seq": TRAIN_SEQ, "steps": SEQ_TRAIN_STEPS,
            "losses": [r["loss"] for r in rows],
            "grad_norms": [r["grad_norm"] for r in rows],
            "step_ms": [r["step_ms"] for r in rows],
            "adamw_ms": [r["adamw_ms"] for r in rows],
            "step_ms_timed": step_ms,
            "tokens_per_s": tokens / (step_ms / 1e3),
            "tokens_per_s_run_wall": tokens * SEQ_TRAIN_STEPS / wall,
            "peak_memory_bytes": peak,
            "busy_share": prof["device_busy_share"],
            "profile": {k: prof[k] for k in (
                "wall_ms", "device_ms", "device_kernels",
                "device_busy_share", "top_kernels")},
            "block_input": {"spec": spec, "local_shape": local,
                            "bytes_a_position": nbytes,
                            "remat_kept_bytes_all_layers_positions":
                                nbytes * 8 * cfg.n_layers},
            "beside_14a": {
                "step_ms": shard_run["step_ms_median_timed"],
                "tokens_per_s": shard_run["tokens_per_s_median_step"],
                "peak_memory_bytes": shard_run["peak_memory_bytes"],
                "busy_share": shard_run["profile"]["device_busy_share"]},
            "step_ms_over_14a": step_ms / shard_run["step_ms_median_timed"],
            "peak_minus_14a_bytes": peak - shard_run["peak_memory_bytes"],
            "launches": got, "launches_reckoned": want,
            "flash_attention": flash}
    log({"seq_train_run": line})
    bad = [r for r in rows if not (math.isfinite(r["loss"])
                                   and math.isfinite(r["grad_norm"]))]
    if bad or any(got[k] != want.get(k, 0) for k in got) or \
            spec != str(PartitionSpec("data", "model")):
        raise RuntimeError(f"seq train: not finite {bad}, launches {got} "
                           f"(expected {want} and nothing else), or the "
                           f"residual laid out {spec}")
    return line


def pf2_vl_run(katt, counters) -> dict:
    """16d: qwen2_vl_2b (12 query heads, 2 kv heads) at full width, its
    first layers (PF2_VL), bf16, seed 0, on a (1, 16) ``("data", "model")``
    mesh of the card: the sharded prefill of one row of seeded embeddings
    with 16 x 16 patch-grid M-RoPE positions and teacher-forced decode
    steps against one device (:func:`serve_pair` at LM_BF16_REL); B7
    launched on the 12 positions that hold a head, once a layer, and not
    on the other 4; B8 on all 16 positions a layer a step; B7 and B8 at a
    position's shapes against their plain versions and SDPA."""
    import numpy as np
    import torch

    from repro_torch.models import attention as mattn
    from repro_torch.models import transformer as tf
    from repro_torch.sharding import MeshRules

    arch, layers, prompt, steps, slots = PF2_VL
    cfg = family_cfg(arch, layers)
    total = prompt + steps
    rng = np.random.default_rng(0)
    batch = {"embeds": torch.from_numpy(rng.standard_normal(
        (1, total, cfg.d_model)).astype(np.float32)).to(DEVICE),
             "positions": torch.from_numpy(
                 patch_grid(1, total, STUB_GRID)).to(DEVICE)}
    rules = MeshRules(shard_mesh(PF2_VL_MESH))
    m = PF2_VL_MESH[1]
    held = sum(1 for j in range(m)
               if (j + 1) * cfg.n_heads // m > j * cfg.n_heads // m)
    seen, undo = grab_first(mattn, "katt", "flash_attention",
                            when=lambda q, *a: q.shape[1] < cfg.n_heads)
    try:
        line = serve_pair(cfg, [tf.init_params(cfg, 0, device=DEVICE)],
                          batch, prompt, slots, steps, counters,
                          f"16d {arch}", LM_BF16_REL, grab=True, rules=rules)
    finally:
        swap_in(undo)
    want_pre = {"flash_attention": held * cfg.n_layers}
    want_dec = {"decode_attention": m * cfg.n_layers * steps}
    got_pre = line["prefill_launches"]
    got_dec = {k: line["launches"][k] - got_pre[k] for k in got_pre}
    line.update({"model_positions": m, "positions_with_a_head": held,
                 "launches_reckoned": {"prefill": want_pre,
                                       "decode": want_dec}})
    args = line.pop("decode_args")
    line["b8_position_local"] = attention_check(
        katt, "16d pf2", "decode_attention",
        f"position 0 of {m}, {args[3].shape[1]} slots", args, cfg.window)
    line["b7_position_local"] = attention_check(
        katt, "16d pf2", "flash_attention", "a position's one head",
        seen[0], cfg.window)
    del args, seen
    log({"pf2_serve_run": line})
    ok = (all(got_pre[k] == want_pre.get(k, 0) for k in got_pre)
          and all(got_dec[k] == want_dec.get(k, 0) for k in got_dec))
    if not ok or not line["gate_ok"]:
        raise RuntimeError(f"pf2 {arch}: launches {got_pre} / {got_dec} "
                           f"(reckoned {want_pre} / {want_dec}), gate "
                           f"{line['gate']}")
    return line


def seq_phase(katt, counters, shard_run) -> dict:
    """16. Sequence sharding and the production meshes' cells (a-d of the
    module docstring). Returns {sub-phase: its line}."""
    import torch

    from repro_torch.models import parallel_ssm as pssm
    from repro_torch.models import transformer as tf
    from repro_torch.sharding import MeshRules, place_tree
    from repro_torch.train import step as tstep

    t_phase = time.perf_counter()
    out = {}
    cfg = family_cfg(TRAIN_ARCH)
    _, p_sh = tstep.param_shardings(cfg, MeshRules(shard_mesh()))
    # the same placement with or without sequence sharding
    pd = place_tree(tf.init_params(cfg, 0, device=DEVICE), p_sh)
    torch.cuda.empty_cache()
    mark("16b")
    out["16b"] = seq_serve_check(pd, cfg, counters)
    mark("16a")
    out["16a"] = seq_train_run(pd, cfg, counters, shard_run)
    del pd
    torch.cuda.empty_cache()
    mark("16c")
    for arch in SEQ_EXACT:
        # B9 at position (0, 0)'s shape: its first call on the mesh
        seen, undo = grab_first(pssm, "kssd", "ssd_scan")
        try:
            out[f"16c {arch}"] = family_exact(
                arch, counters, "16c",
                MeshRules(shard_mesh(), seq_sharding=True), serve=False)
        finally:
            swap_in(undo)
        if seen:
            c = family_cfg(arch)
            out[f"16c {arch}"]["ssd_scan"] = ssd_training_line(
                seen[0][:5], min(c.ssd_chunk, FAM_EXACT_SEQ + c.meta_tokens),
                f"ssd_scan[16c {arch} seq_sharded]")
        del seen
        torch.cuda.empty_cache()
    mark("16d")
    out["16d qwen2_vl_2b"] = pf2_vl_run(katt, counters)
    torch.cuda.empty_cache()
    out["16d qwen3_moe_235b"] = family_exact(
        "qwen3_moe_235b", counters, "16d",
        MeshRules(shard_mesh(PF2_POD_MESH, PF2_POD_AXES)))
    torch.cuda.empty_cache()
    out["seq_phase_s"] = time.perf_counter() - t_phase
    log({"seq_phase_s": out["seq_phase_s"]})
    return out


def phase16_entries(k: str, seq16: dict) -> dict:
    """Phase 16's part of kernel ``k``'s entry in the ``kernels`` line:
    its launches on each path under ``seq_sharded`` (16a-16c) and ``pf2``
    (16d), with its lines at those paths' shapes."""
    keys = ("shape", "max_abs_err", "kernel_ms", "backward_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    seq, pf2 = {}, {}
    a, b = seq16["16a"], seq16["16b"]
    if a["launches"].get(k):
        seq["16a"] = a["launches"][k]
    if b["prefill_launches"].get(k):
        seq["16b prefill"] = b["prefill_launches"][k]
    if b["decode_launches"].get(k):
        seq["16b decode"] = b["decode_launches"][k]
    for arch in SEQ_EXACT:
        if seq16[f"16c {arch}"]["launches"].get(k):
            seq[f"16c {arch}"] = seq16[f"16c {arch}"]["launches"][k]
    vl, q3 = seq16["16d qwen2_vl_2b"], seq16["16d qwen3_moe_235b"]
    n_pre = vl["prefill_launches"].get(k, 0)
    if n_pre:
        pf2["16d qwen2_vl_2b prefill"] = n_pre
    if vl["launches"].get(k, 0) - n_pre:
        pf2["16d qwen2_vl_2b decode"] = vl["launches"][k] - n_pre
    if q3["launches"].get(k):
        pf2["16d qwen3_moe_235b train"] = q3["launches"][k]
    for when, n in q3["serve_launches"].items():
        if n.get(k):
            pf2[f"16d qwen3_moe_235b {when}"] = n[k]
    out = {}
    if seq:
        out["seq_sharded"] = {"launches": seq}
        if k == "flash_attention":
            out["seq_sharded"]["16a"] = {
                "step_ms": a["step_ms_timed"],
                **{key: a["flash_attention"].get(key) for key in keys}}
        for arch in SEQ_EXACT:
            line = seq16[f"16c {arch}"].get(k)
            if line:                # B9 at a position's fp32 shape
                out["seq_sharded"][f"16c {arch}"] = {
                    key: line.get(key) for key in keys}
    if pf2:
        out["pf2"] = {"launches": pf2}
        local = {"flash_attention": "b7_position_local",
                 "decode_attention": "b8_position_local"}.get(k)
        if local:
            out["pf2"]["16d qwen2_vl_2b"] = {
                key: vl[local].get(key) for key in keys}
    return out


# ------------------------------------------------------ 17. the dry run, PF3
def pf3_run(katt, counters) -> dict:
    """17a: the sharded prefill and PF3's decode steps on a ring laid out
    by kv heads (:data:`PF3`) against one device (:func:`serve_pair`):
    first in fp32 (within SHARD_REL of one device's largest), then in bf16
    (within LM_BF16_REL, as 15d and 16d) beside the same bf16 run on a
    ring split by slots, for the step's ms; B8 launched once a position
    and layer a step, on the position's 2 query heads over its 2 kv heads
    and every slot, with no merge; B8 at position (0, 0)'s bf16 shape
    against its plain version and SDPA. Then granite_3_2b at full width
    (:data:`PF3_FULL`: a GQA group of 4) in fp32 against one device within
    SHARD_REL, B8 launched on each position's 16 query heads over its 4 kv
    heads, and held at position (0, 0)'s shape in fp32 and, timed, on the
    same inputs in bf16."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import parallel_serve as pserve
    from repro_torch.models import transformer as tf

    arch, b, prompt, slots, steps = PF3
    g = torch.Generator(device=DEVICE).manual_seed(0)
    merges = []
    real_merge = pserve.merge_softmax

    def counted_merge(*a):
        merges.append(1)
        return real_merge(*a)
    layers, full_prompt, full_slots = PF3_FULL
    reduced = get_arch(arch).reduced()
    full = dataclasses.replace(get_arch(arch), n_layers=layers)
    out, cfgs = {}, {}
    for tag, base, dtype, n, p_len, rel in (
            ("fp32 by_heads", reduced, "float32", slots, prompt, SHARD_REL),
            ("bf16 by_heads", reduced, "bfloat16", slots, prompt,
             LM_BF16_REL),
            ("bf16 by_slots", reduced, "bfloat16", PF3_SPLIT_SLOTS, prompt,
             LM_BF16_REL),
            ("fp32 full_width", full, "float32", full_slots, full_prompt,
             SHARD_REL)):
        cfg = cfgs[tag] = dataclasses.replace(base, dtype=dtype)
        toks = torch.randint(0, cfg.vocab, (b, p_len + steps), generator=g,
                             device=DEVICE, dtype=torch.int32)
        merges.clear()
        undo = swap_in([(pserve, "merge_softmax", counted_merge)])
        try:
            line = serve_pair(cfg, [tf.init_params(cfg, 0, device=DEVICE)],
                              toks, p_len, n, steps, counters,
                              f"17a {tag}", rel,
                              grab=tag in ("bf16 by_heads",
                                           "fp32 full_width"))
        finally:
            swap_in(undo)
        pre = line["prefill_launches"]
        line["decode_launches"] = {k: line["launches"][k] - pre[k]
                                   for k in pre}
        line["merges"] = len(merges)
        out[tag] = line
    for tag in ("bf16 by_heads", "fp32 full_width"):
        cfg, line = cfgs[tag], out[tag]
        hq, hkv = cfg.n_heads // 2, cfg.n_kv_heads // 2   # a position's
        args = line.pop("decode_args")
        line["b8_position_local"] = attention_check(
            katt, f"17a pf3 {tag}", "decode_attention",
            f"position 0: {hq} query heads over {hkv} of "
            f"{cfg.n_kv_heads} kv heads, {args[1].shape[2]} slots", args,
            cfg.window)
        line["b8_shape_ok"] = (
            tuple(args[0].shape) == (b // 4, hq, cfg.head_dim)
            and tuple(args[1].shape) == (b // 4, hkv, line["cache_slots"],
                                         cfg.head_dim))
        if cfg.dtype == "float32":      # timed (bf16) at the same shape
            line["b8_position_local_bf16"] = attention_check(
                katt, f"17a pf3 {tag}", "decode_attention",
                f"position 0 in bf16: {hq} query heads over {hkv} kv "
                f"heads, {args[1].shape[2]} slots",
                tuple(t.bfloat16() if torch.is_floating_point(t) else t
                      for t in args), cfg.window)
        del args
    heads = out["bf16 by_heads"]
    want = {t: {"decode_attention": 8 * cfgs[t].n_layers * steps}
            for t in out}
    line = {"arch": arch, "layers": reduced.n_layers, "runs": out,
            "by_heads": heads, "full_width": out["fp32 full_width"],
            "decode_ms_median": {t: v["decode_ms_median"]
                                 for t, v in out.items()},
            "prefill_ms": {t: v["prefill_ms"] for t, v in out.items()},
            "gates": {t: v["gate"] for t, v in out.items()},
            "decode_launches_reckoned": want}
    log({"pf3_serve_run": {k: v for k, v in line.items()
                           if k not in ("runs", "by_heads", "full_width")}})
    by_heads = {t: v for t, v in out.items() if "by_slots" not in t}
    ok = (all(v["gate_ok"] for v in out.values())
          and all(v.get("b8_shape_ok", True) for v in by_heads.values())
          and all(v["merges"] == 0 and all(
              v["decode_launches"][k] == want[t].get(k, 0)
              for k in v["decode_launches"]) for t, v in by_heads.items()))
    if not ok:
        raise RuntimeError(
            f"17a: gates {line['gates']}, merges "
            f"{ {t: v['merges'] for t, v in by_heads.items()} }, decode "
            f"launches { {t: v['decode_launches'] for t, v in by_heads.items()} }"
            f" (reckoned {want})")
    return line


def dry_reckon(out: str) -> None:
    """17b's reckoning, run in a subprocess with no card (:class:`DryRuns`):
    ``launch.dryrun.reckon`` (arguments and outputs from the layouts,
    temporaries from a count on meta tensors) of 14a's, 15a's and 16a's
    cells per device, all 8 positions on one device, written to ``out``
    as {tag: {arch, layers, seq_sharding, memory, reckon_s}}."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(SHARD_TRAIN_MESH, devices=["cpu"] * 8)
    shape = ShapeConfig("train_4k", TRAIN_SEQ, SHARD_TRAIN_BATCH, "train")
    cells = {"14a": (family_cfg(TRAIN_ARCH), False),
             "15a": (family_cfg(FAM_TRAIN[0], FAM_TRAIN_LAYERS), False),
             "16a": (family_cfg(TRAIN_ARCH), True)}
    rec = {}
    for tag, (cfg, seq) in cells.items():
        t0 = time.perf_counter()
        r = dryrun.reckon(cfg, shape, mesh, microbatches=1, seq_shard=seq,
                          devices=[0] * 8)
        rec[tag] = {"arch": cfg.name, "layers": cfg.n_layers,
                    "seq_sharding": seq, "memory": r["memory"],
                    "reckon_s": time.perf_counter() - t0}
    Path(out).write_text(json.dumps(rec))


class DryRuns:
    """17b's reckoning (:func:`dry_reckon`) and 17c's command line, each
    in a subprocess with no card (``CUDA_VISIBLE_DEVICES`` empty), started
    before phase 16 so that they run beside it; :meth:`stop` ends both
    (the script leaves no process behind)."""

    def __init__(self):
        import tempfile

        self.dir = Path(tempfile.mkdtemp(prefix="dryrun_"))
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   CUDA_VISIBLE_DEVICES="")
        self.t0 = time.perf_counter()
        code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + "
                "'/src']; import chip_smoke; chip_smoke.dry_reckon("
                "sys.argv[2])")
        self.procs = {
            "17b": subprocess.Popen(
                [sys.executable, "-c", code, str(ROOT),
                 str(self.dir / "reckon.json")], cwd=str(ROOT), env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            "17c": subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 *DRY_CLI, "--out", str(self.dir / "cli")], cwd=str(ROOT),
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)}

    def wait(self, key: str) -> tuple:
        """(returncode, stdout, stderr, seconds from the start) of one."""
        out, err = self.procs[key].communicate(timeout=600)
        return (self.procs[key].returncode, out, err,
                time.perf_counter() - self.t0)

    def stop(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def dry_memory(dry: DryRuns, shard_run, fam, seq16) -> dict:
    """17b: :func:`dry_reckon`'s reckoned peaks of 14a's, 15a's and 16a's
    cells per device, which is this one card, beside the peak each phase
    measured, within DRY_MEMORY_REL."""
    rc, _, err, wall = dry.wait("17b")
    path = dry.dir / "reckon.json"
    if rc != 0 or not path.exists():
        raise RuntimeError(f"17b: the reckoning failed (rc {rc}): "
                           f"{err[-2000:]}")
    rec = json.loads(path.read_text())
    out = {}
    for tag, run in (("14a", shard_run), ("15a", fam["15a"]),
                     ("16a", seq16["16a"])):
        r = rec[tag]
        reckoned = r["memory"]["total_bytes_per_device"]
        measured = run["peak_memory_bytes"]
        out[tag] = {**r, "reckoned_bytes": reckoned,
                    "measured_peak_bytes": measured,
                    "reckoned_over_measured": reckoned / measured}
    out["wall_s"] = wall
    log({"dry_memory": out})
    bad = {t: v["reckoned_over_measured"] for t, v in out.items()
           if isinstance(v, dict)
           and abs(v["reckoned_over_measured"] - 1) > DRY_MEMORY_REL}
    if bad:
        raise RuntimeError(f"17b: reckoned peaks off the measured ones by "
                           f"more than {DRY_MEMORY_REL}: {bad}")
    return out


def dryrun_phase(katt, counters, dry: DryRuns, shard_run, fam,
                 seq16) -> dict:
    """17. The dry run and PF3 (a-c of the module docstring): 17a here,
    then 17b's and 17c's subprocesses (:class:`DryRuns`, started before
    phase 16) are read. Returns {sub-phase: its line}."""
    t_phase = time.perf_counter()
    out = {}
    mark("17a")
    out["17a"] = pf3_run(katt, counters)
    mark("17b")
    out["17b"] = dry_memory(dry, shard_run, fam, seq16)
    mark("17c")
    rc, stdout, stderr, wall = dry.wait("17c")
    recs = list((dry.dir / "cli").glob("*.json"))
    rec = json.loads(recs[0].read_text()) if recs else {}
    out["17c"] = {"argv": DRY_CLI, "returncode": rc, "wall_s": wall,
                  "stdout": stdout[-2000:], "record": rec}
    log({"dryrun_cli": out["17c"]})
    if rc != 0 or rec.get("status") != "ok":
        raise RuntimeError(f"17c: the dry run's command line failed "
                           f"(rc {rc}): {stderr[-2000:]}")
    out["dryrun_phase_s"] = time.perf_counter() - t_phase
    log({"dryrun_phase_s": out["dryrun_phase_s"]})
    return out


def main() -> int:
    import torch

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("no CUDA device: this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import device as dev
    from repro_torch.core.datasets import generate, make_query_windows
    from repro_torch.core.engine import (EngineConfig, QueryBatch,
                                         SpatialIndex)
    from repro_torch.core import engine as eng_mod
    from repro_torch.core import exec as exec_mod
    from repro_torch.core.relations import get_relation
    from repro_torch.core.zorder import (ZGrid, morton_encode_np,
                                         split_hilo_np)
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention as katt
    from repro_torch.kernels import knn as kk
    from repro_torch.kernels import morton as km
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import refine as kr
    from repro_torch.kernels import ssd as kssd

    r = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                       text=True, timeout=60)
    log("nvcc " + r.stdout.strip().splitlines()[-1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------- 2. build
    mark("2")
    t0 = time.perf_counter()
    _build.load()
    log({"build_s": time.perf_counter() - t0,
         "library": _build.library_path().name,
         "nvcc_s": _build.build_seconds,
         "nvcc_source_s": _build.source_seconds,
         "nvcc_source_sum_s": sum(_build.source_seconds.values())})
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("ptxas: " + line.strip())

    # ---------------------------------------------------------- 3. store
    mark("3")
    t0 = time.perf_counter()
    gs = generate("mixed", N_RECORDS, seed=0)
    fp32_exact(gs)
    t1 = time.perf_counter()
    idx = SpatialIndex.build(gs, device=DEVICE)
    snap = idx.snapshot()
    pods = idx._device_payload()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log({"store": {"records": len(gs), "pool_rows": int(gs.pool.shape[0]),
                   "leaves": len(idx.glin.leaves),
                   "nodes": int(snap.node_dlo_hi.shape[0]),
                   "pieces": int(idx.glin.pw.num_pieces),
                   "slots_padded": snap.num_slots,
                   "pod_rows": int(pods.pool.shape[0]),
                   "max_width": pods.max_width,
                   "search_steps": snap.search_steps, "depth": snap.depth,
                   "cuda_memory_allocated": torch.cuda.memory_allocated(),
                   "generate_s": t1 - t0, "build_and_publish_s": t2 - t1}})
    t0 = time.perf_counter()
    wins = make_query_windows(gs, SELECTIVITY, N_WINDOWS, seed=1)
    # the ladder ends in the dense single-stage path, which needs each
    # window's candidate run inside max_cap: a window whose Z-interval
    # straddles a top-level quadrant boundary (lengthened further by the
    # piecewise augmentation) can exceed it, and is left out and counted
    cand = make_query_windows(gs, LADDER_SELECTIVITY, 64, seed=2)
    s_, e_ = dev.batch_query_bounds(
        snap, torch.from_numpy(cand.astype(np.float32)).to(DEVICE),
        "intersects")
    runs = (e_ - s_).cpu().numpy()
    fit = runs <= EngineConfig().max_cap // 2
    wins_hi = cand[fit][:32]
    log({"windows_s": time.perf_counter() - t0,
         "ladder_windows": len(wins_hi), "ladder_left_out": int((~fit).sum()),
         "ladder_run_max": int(runs.max())})
    if len(wins_hi) < 16:
        raise RuntimeError("too few ladder windows fit max_cap")
    w = torch.from_numpy(wins.astype(np.float32)).to(DEVICE)

    # ------------------------------------------- 4. kernels vs plain versions
    mark("4")
    results = {}
    lm, rm = snap.slot_lmbr, snap.slot_rmbr

    def probe(rel_name):
        """The relation's probe windows and slot runs; the summed run
        length (query-slot pairs tested) and the slots covered (rows that
        must be read)."""
        rel = get_relation(rel_name)
        s, e = dev.batch_query_bounds(snap, w, rel_name)
        b = torch.stack([s, e], 1)
        return (rel, rel.probe_window(w).contiguous(), b,
                int((e - s).clamp(min=0).sum()),
                covered_slots(b, snap.num_slots))

    def run_max(b) -> int:
        """The longest run: one block walks it, so it sets the kernel's
        time once every block is resident."""
        return int((b[:, 1] - b[:, 0]).max())

    q = N_WINDOWS
    rel_i, pw_i, b_i, run_i, cov_i = probe("intersects")
    # the slice of the kernel-level entry point's checks (mask, compact,
    # slot-as-leaf count)
    wm, bm = pw_i[:MASK_WINDOWS].contiguous(), b_i[:MASK_WINDOWS].contiguous()
    walk = snap.leaf_walk
    n0 = kr.refine_count.launches
    got = kr.refine_count(pw_i, b_i, rm, leaves=walk)
    want = kr.refine_count_plain(pw_i, b_i, rm)
    ww = walk_work(b_i, pw_i, walk)
    walk_b, walk_o = walk_bytes_ops(ww, q)

    def count_i_call():
        return kr.refine_count(pw_i, b_i, rm, leaves=walk)

    line = {"name": "refine_count", "shape": [q, snap.num_slots],
            **compare("refine_count", got, want),
            "kernel_ms": cuda_ms(count_i_call, 25),
            "device_ms": device_ms(count_i_call, "count_kernel"),
            "queued_ms": queued_ms(count_i_call),
            "plain_ms": cuda_ms(lambda: kr.refine_count_plain(pw_i, b_i, rm),
                                3, 1),
            "run_slots": run_i, "run_max": run_max(b_i),
            "covered_slots": cov_i, **ww,
            # the walk's rows, windows and bounds in, counts out
            **bound(walk_b + q * 28, walk_o),
            "bound_slot_ms": bound(cov_i * 16 + q * 28, run_i * 8)["bound_ms"]}
    line["launches"] = kr.refine_count.launches - n0
    count_i = got.cpu().numpy()
    results["refine_count"] = line
    log(line)
    # slot-as-leaf mode (ops.refine_count): each slot its own leaf, the
    # record MBRs as leaf rows, group rows built in every call (timed in
    # kernel_ms and queued_ms, not in device_ms nor the bound)
    slots_n = torch.arange(snap.num_slots + 1, dtype=torch.int32,
                           device=DEVICE)
    swalk = kr.LeafWalk(slots_n[:-1], slots_n, rm, dev.leaf_group_mbrs(rm))
    n0 = kr.refine_count.launches
    got = kr.refine_count(wm, bm, rm)
    sw = walk_work(bm, wm, swalk)
    log({"name": "refine_count[slot-as-leaf]",
         "shape": [MASK_WINDOWS, snap.num_slots],
         **compare("refine_count[slot-as-leaf]", got,
                   kr.refine_count_plain(wm, bm, rm)),
         "kernel_ms": cuda_ms(lambda: kr.refine_count(wm, bm, rm), 10),
         "device_ms": device_ms(lambda: kr.refine_count(wm, bm, rm),
                                "count_kernel"),
         "queued_ms": queued_ms(lambda: kr.refine_count(wm, bm, rm)),
         "run_max": run_max(bm), **sw,
         # the group and leaf rows (the record MBRs) once, windows and
         # bounds in, counts out; no rec_leaf or leaf_start read
         **bound(sw["distinct_groups"] * 16 + sw["distinct_leaves"] * 16
                 + MASK_WINDOWS * 28,
                 8 * (sw["groups_walked"] + sw["leaves_walked"]
                      + sw["meeting_leaf_slots"])),
         "launches": kr.refine_count.launches - n0})
    del slots_n, swalk

    for prefilter, rel_name in (("intersects", "intersects"),
                                ("contains", "within")):
        rel, pw, b, run, cov = probe(rel_name)
        args = (pw, b, lm, rm)
        kw = dict(budget=BUDGET, prefilter=prefilter, leaves=walk)
        n0 = kr.refine_compact.launches
        got = kr.refine_compact(*args, **kw)
        want = kr.refine_compact_plain(*args, BUDGET, prefilter)
        ww = walk_work(b, pw, walk)
        walk_b, walk_o = walk_bytes_ops(ww, q)
        line = {"name": f"refine_compact[{prefilter}]",
                "shape": [q, snap.num_slots, BUDGET],
                **compare(f"refine_compact[{prefilter}]", got, want),
                "kernel_ms": cuda_ms(lambda: kr.refine_compact(*args, **kw),
                                     25),
                "device_ms": device_ms(lambda: kr.refine_compact(*args, **kw),
                                       "compact_kernel"),
                "plain_ms": cuda_ms(lambda: kr.refine_compact_plain(
                    *args, BUDGET, prefilter), 3, 1),
                "survivors": int(got[1].sum()), "run_slots": run,
                "run_max": run_max(b), "covered_slots": cov, **ww,
                **bound(walk_b + q * (24 + 4 + BUDGET * 4), walk_o),
                "bound_slot_ms": bound(cov * 32 + q * (28 + BUDGET * 4),
                                       run * 12)["bound_ms"]}
        if prefilter == "intersects":
            # does the batch's time follow its longest runs? The kernel on
            # the 32 windows with the longest runs and on the 32 shortest
            order = torch.argsort(b[:, 1] - b[:, 0])
            for tag, rows in (("longest", order[-32:]),
                              ("shortest", order[:32])):
                a32 = (pw[rows].contiguous(), b[rows].contiguous(), lm, rm)
                line[f"{tag}_32_runs_device_ms"] = device_ms(
                    lambda: kr.refine_compact(*a32, **kw), "compact_kernel")
                line[f"{tag}_32_run_slots"] = int(
                    (a32[1][:, 1] - a32[1][:, 0]).clamp(min=0).sum())
        line["launches"] = kr.refine_compact.launches - n0
        log(line)
        results.setdefault("refine_compact", line)

    # the compact kernel on the long runs of the 1e-3 ladder windows, at the
    # main budget and past the fused kernel's bound
    wl = torch.from_numpy(wins_hi.astype(np.float32)).to(DEVICE)
    s_l, e_l = dev.batch_query_bounds(snap, wl, "intersects")
    b_l = torch.stack([s_l, e_l], 1)
    pw_l = rel_i.probe_window(wl).contiguous()
    for budget in (BUDGET, 4096):
        name = f"refine_compact[ladder 1e-3, budget {budget}]"
        n0 = kr.refine_compact.launches
        got = kr.refine_compact(pw_l, b_l, lm, rm, budget=budget, leaves=walk)
        want = kr.refine_compact_plain(pw_l, b_l, lm, rm, budget,
                                       "intersects")
        log({"name": name, "shape": [len(wins_hi), snap.num_slots, budget],
             **compare(name, got, want), "survivors": int(got[1].sum()),
             "survivors_max": int(got[1].max()), "run_max": run_max(b_l),
             **walk_work(b_l, pw_l, walk),
             "launches": kr.refine_compact.launches - n0})
    # the kernel-level entry point: the reference's signature has only
    # slot-aligned tables, so the kernel walks each slot as its own leaf
    n0 = kr.refine_compact.launches
    got = kops.refine_compact(wm, bm, lm, rm, budget=BUDGET)
    want = kops.refine_compact(wm, bm, lm, rm, budget=BUDGET,
                               use_kernel=False)
    log({"name": "ops.refine_compact[slot-as-leaf]",
         "shape": [MASK_WINDOWS, snap.num_slots, BUDGET],
         **compare("ops.refine_compact", got, want),
         "kernel_ms": cuda_ms(lambda: kops.refine_compact(
             wm, bm, lm, rm, budget=BUDGET), 10),
         "survivors": int(got[1].sum()), "run_max": run_max(bm),
         "launches": kr.refine_compact.launches - n0})

    packed = snap.fused_operands
    for rel_name in FUSED_RELATIONS:
        rel, pw, b, run, cov = probe(rel_name)
        qkeys = torch.stack(dev._raw_query_keys(snap, w, rel), 1)
        ops = (w, pw, qkeys, *packed, pods.headers, pods.pool, lm, rm)
        kw = dict(budget=BUDGET, prefilter=rel.prefilter_kind, code=rel.code,
                  dist=rel.dist,
                  augment=bool(rel.augment) and snap.pw_zmax_hi.shape[0] > 0,
                  search_steps=snap.search_steps, depth=snap.depth,
                  leaves=walk)
        n0 = kr.refine_fused.launches
        got = kr.refine_fused(*ops, **kw)
        want = kr.refine_fused_plain(*ops[:15], **{
            k: v for k, v in kw.items() if k != "leaves"})
        # bytes this run needs, each read once: the walked group, leaf and
        # record MBR rows, the survivor slots' record ids, the survivor
        # records' pod headers and vertices, the probe's table reads, the
        # windows/keys in and the hits/counts out; operations: 8 per MBR
        # test, ~70 per survivor vertex tested. bound_slot_ms counts every
        # run slot's leaf + record MBR rows instead (12 operations a slot).
        ckw = dict(budget=BUDGET, prefilter=rel.prefilter_kind, leaves=walk)
        slots, _ = kr.refine_compact(pw, b, lm, rm, **ckw)
        taken = slots >= 0
        recs = snap.recs[slots.clamp(min=0)][taken].long()
        urec = torch.unique(recs)
        surv, pair_verts = int(taken.sum()), int(pods.nv[recs].sum())
        probe_bytes = q * 2 * (snap.depth * 24 + (snap.search_steps + 2) * 8
                               + 48)
        exact_bytes = (int(torch.unique(slots[taken]).numel()) * 4
                       + int(urec.numel()) * 16
                       + int(pods.nv[urec].sum()) * 8 + probe_bytes
                       + q * (52 + BUDGET * 4))
        ww = walk_work(b, pw, walk)
        walk_b, walk_o = walk_bytes_ops(ww, q)
        line = {"name": f"refine_fused[{rel_name}]",
                "shape": [q, snap.num_slots, BUDGET],
                **compare(f"refine_fused[{rel_name}]", got, want),
                "kernel_ms": cuda_ms(lambda: kr.refine_fused(*ops, **kw), 25),
                "device_ms": device_ms(lambda: kr.refine_fused(*ops, **kw),
                                       "fused_kernel"),
                "plain_ms": cuda_ms(lambda: kr.refine_fused_plain(
                    *ops[:15], **{k: v for k, v in kw.items()
                                  if k != "leaves"}), 2, 1),
                # the same runs through the compact kernel alone: the rest
                # of the fused time is the probe and the exact stage
                "compact_ms": cuda_ms(lambda: kr.refine_compact(
                    pw, b, lm, rm, **ckw), 25),
                "compact_device_ms": device_ms(lambda: kr.refine_compact(
                    pw, b, lm, rm, **ckw), "compact_kernel"),
                "survivors": surv, "survivor_vertices": pair_verts,
                "run_slots": run, "run_max": run_max(b),
                "covered_slots": cov, **ww,
                "hits": int(got[1].clamp(min=0).sum()),
                "overflow_rows": int((got[1] < 0).sum()),
                **bound(walk_b + exact_bytes, walk_o + pair_verts * 70),
                "bound_slot_ms": bound(cov * 32 + exact_bytes,
                                       run * 12 + pair_verts * 70)["bound_ms"]}
        line["fused_minus_compact_ms"] = line["kernel_ms"] - line["compact_ms"]
        if line["device_ms"] is not None and line["compact_device_ms"]:
            line["fused_minus_compact_device_ms"] = (
                line["device_ms"] - line["compact_device_ms"])
        line["launches"] = kr.refine_fused.launches - n0
        log(line)
        results.setdefault("refine_fused", line)

    # the kNN top-k on a real first rung: the windows' centres probed at
    # their seeded radii through the intersects pipeline, the survivors'
    # exact squared distances (what batch_knn_rank hands the top-k)
    k0 = KNN_KS[0]
    ctr = (w[:, :2] + w[:, 2:]) / 2
    cw = torch.cat([ctr, ctr], 1)
    rad = dev.knn_seed_radii(snap, cw, k0)
    sq = torch.cat([ctr - rad[:, None], ctr + rad[:, None]], 1)
    rung_hits, rung_counts = dev.batch_query(
        snap, sq, pods, relation="intersects", cap=idx.device_cap,
        exact_budget=BUDGET, compaction="kernel")
    # the compact kernel at the kNN path's inputs: the rung's squares at
    # the pinned budget, then its fat rows at the budget their ladder grows
    # to (at least 4096: past MAX_COMPACT_BUDGET, which only the staged
    # compaction takes)
    s_sq, e_sq = dev.batch_query_bounds(snap, sq, "intersects")
    pw_sq = rel_i.probe_window(sq).contiguous()
    b_sq = torch.stack([s_sq, e_sq], 1)
    fat = torch.nonzero(rung_counts < 0).flatten()
    if fat.numel() == 0:
        raise RuntimeError("the first kNN rung has no fat row")
    need = int((-rung_counts[fat] - 1).max())
    fat_budget = max(4096, 1 << (need - 1).bit_length())
    for name, rows, budget in (("refine_compact[knn rung]", slice(None),
                                BUDGET),
                               ("refine_compact[knn fat rows]", fat,
                                fat_budget)):
        args = (pw_sq[rows].contiguous(), b_sq[rows].contiguous(), lm, rm)
        n0 = kr.refine_compact.launches
        got = kr.refine_compact(*args, budget=budget, leaves=walk)
        want = kr.refine_compact_plain(*args, budget, "intersects")
        log({"name": name, "shape": [int(args[0].shape[0]), snap.num_slots,
                                     budget],
             **compare(name, got, want), "survivors": int(got[1].sum()),
             "survivors_max": int(got[1].max()), "run_max": run_max(args[1]),
             "launches": kr.refine_compact.launches - n0})
    valid = rung_hits >= 0
    rung_d = dev._sqdist_over(cw, pods, rung_hits.clamp(min=0), valid)
    rung_i = torch.where(valid, rung_hits, kk.ID_PAD)
    g = torch.Generator(device=DEVICE).manual_seed(3)

    def synthetic_rows(b):
        """(d, ids) of q rows of b columns: distances in eighths (many
        ties), a quarter +inf tails with ID_PAD, every seventh column a
        duplicate of the pair before it."""
        d = torch.randint(0, 64, (q, b), device=DEVICE,
                          generator=g).float() / 8
        ids = torch.randint(0, 1 << 20, (q, b), device=DEVICE, generator=g,
                            dtype=torch.int32)
        dead = torch.rand((q, b), device=DEVICE, generator=g) < 0.25
        d[dead] = float("inf")
        ids[dead] = kk.ID_PAD
        ids[:, 1::7] = ids[:, ::7][:, :ids[:, 1::7].shape[1]]
        d[:, 1::7] = d[:, ::7][:, :d[:, 1::7].shape[1]]
        return d, ids

    def packed_topk(d, ids, k):
        """The nearest PyTorch call: (d bits << 32 | id) packed into int64
        (d >= 0, so its bits order as the distance; ids >= 0), then
        torch.topk — two calls."""
        key = (d.view(torch.int32).long() << 32) | ids.long()
        return torch.topk(key, k, dim=1, largest=False, sorted=True).values

    def topk_line(name, d, ids, k) -> dict:
        """The top-k kernel on (d, ids): its route, exact equality with the
        plain version and with the packed torch.topk, times and bound."""
        got = kk.knn_topk(d, ids, k)
        want = kk.knn_topk_plain(d, ids, k)
        lib = packed_topk(d, ids, k)
        if not (torch.equal((lib & 0xFFFFFFFF).int(), got[1])
                and torch.equal((lib >> 32).int().view(torch.float32),
                                got[0])):
            raise RuntimeError(f"{name}: packed torch.topk disagrees")
        rows, b = d.shape
        return {"name": name, "shape": [rows, b, k], **kk.knn_plan(b),
                **compare(name, got, want),
                "kernel_ms": cuda_ms(lambda: kk.knn_topk(d, ids, k), 25),
                "plain_ms": cuda_ms(lambda: kk.knn_topk_plain(d, ids, k), 10),
                "library_ms": cuda_ms(lambda: packed_topk(d, ids, k), 10),
                "library_call": "int64 pack of (d bits << 32 | id), then "
                                "torch.topk: two calls",
                "device_ms": device_ms(lambda: kk.knn_topk(d, ids, k),
                                       "knn_"),
                "queued_ms": queued_ms(lambda: kk.knn_topk(d, ids, k), 50),
                "library_device_ms": device_ms(
                    lambda: packed_topk(d, ids, k), ""),
                "library_queued_ms": queued_ms(
                    lambda: packed_topk(d, ids, k), 50),
                "live_columns": int((d < float("inf")).sum()),
                **bound(rows * b * 8 + rows * k * 8, rows * b * 2)}

    for name, (d, ids, k) in (
            ("knn_topk", (rung_d, rung_i, k0)),
            ("knn_topk[wide]", (*synthetic_rows(KNN_TOPK_WIDE[0]),
                                KNN_TOPK_WIDE[1]))):
        n0 = kk.knn_topk.launches
        line = topk_line(name, d, ids, k)
        line["launches"] = kk.knn_topk.launches - n0
        log(line)
        results.setdefault("knn_topk", line)

    # Morton keys of every record's lower-left corner
    qx_np, qy_np = ZGrid(snap.grid_x0, snap.grid_y0,
                         snap.grid_cell).quantize_np(gs.mbrs[:, 0],
                                                     gs.mbrs[:, 1])
    qx = torch.from_numpy(qx_np.astype(np.int32)).to(DEVICE)
    qy = torch.from_numpy(qy_np.astype(np.int32)).to(DEVICE)
    n0 = km.morton_encode.launches
    got = km.morton_encode(qx, qy)
    want = km.morton_encode_plain(qx, qy)
    nrec = int(qx.shape[0])
    line = {"name": "morton_encode", "shape": [nrec],
            **compare("morton_encode", got, want),
            "kernel_ms": cuda_ms(lambda: km.morton_encode(qx, qy), 25),
            "device_ms": device_ms(lambda: km.morton_encode(qx, qy),
                                   "morton_kernel"),
            "plain_ms": cuda_ms(lambda: km.morton_encode_plain(qx, qy), 10),
            **bound(nrec * 16, nrec * 40)}
    line["launches"] = km.morton_encode.launches - n0
    log(line)
    results["morton_encode"] = line

    # the candidate mask of MASK_WINDOWS windows over every slot
    n0 = kr.refine_mask.launches
    got = kr.refine_mask(wm, bm, rm)
    want = kr.refine_mask_plain(wm, bm, rm)
    nslot = snap.num_slots
    line = {"name": "refine_mask", "shape": [MASK_WINDOWS, nslot],
            **compare("refine_mask", got, want),
            "kernel_ms": cuda_ms(lambda: kr.refine_mask(wm, bm, rm), 25),
            "device_ms": device_ms(lambda: kr.refine_mask(wm, bm, rm),
                                   "mask_kernel"),
            "queued_ms": queued_ms(lambda: kr.refine_mask(wm, bm, rm)),
            "plain_ms": cuda_ms(lambda: kr.refine_mask_plain(wm, bm, rm), 5),
            "candidates": int(got.sum()),
            **bound(nslot * 16 + MASK_WINDOWS * (24 + nslot),
                    MASK_WINDOWS * nslot * 6)}
    line["launches"] = kr.refine_mask.launches - n0
    log(line)
    results["refine_mask"] = line
    # the kernel's edges at the same scale: n not a multiple of 16 (rows
    # of every alignment, a tail thread), q not a multiple of the 16-row
    # chunk, runs from below 0 and past n
    na, qa = nslot - 3, MASK_WINDOWS - 1
    wa, ba, ra = wm[:qa].clone(), bm[:qa].clone(), rm[:na]
    ba[0] = torch.tensor([-9, na + 9])
    ba[1] = torch.tensor([na - 100_000, na + 40])
    inf = float("inf")
    wa[1] = torch.tensor([-inf, -inf, inf, inf])   # meets every slot
    n0 = kr.refine_mask.launches
    got = kr.refine_mask(wa, ba, ra)
    want = kr.refine_mask_plain(wa, ba, ra)
    if not (bool(got[1, -3:].all()) and torch.equal(
            got.sum(1, dtype=torch.int32), kr.refine_count(wa, ba, ra))):
        raise RuntimeError("refine_mask[awkward]: tail or row sums wrong")
    log({"name": f"refine_mask[awkward q {qa}, n {na}]", "shape": [qa, na],
         **compare("refine_mask[awkward]", got, want),
         "kernel_ms": cuda_ms(lambda: kr.refine_mask(wa, ba, ra), 10),
         "device_ms": device_ms(lambda: kr.refine_mask(wa, ba, ra),
                                "mask_kernel"),
         "candidates": int(got.sum()),
         **bound(na * 16 + qa * (24 + na), qa * na * 6),
         "launches": kr.refine_mask.launches - n0})
    del got, want, wa, ba

    # -------------------------------------------- 5. the window path
    mark("5")
    counters = {"refine_count": kr.refine_count,
                "refine_compact": kr.refine_compact,
                "refine_fused": kr.refine_fused,
                "knn_topk": kk.knn_topk,
                "morton_encode": km.morton_encode,
                "refine_mask": kr.refine_mask,
                "flash_attention": katt.flash_attention,
                "decode_attention": katt.decode_attention,
                "ssd_scan": kssd.ssd_scan}
    window_kernels = ("refine_count", "refine_compact", "refine_fused")
    def read_path(path, kernels, keep=None):
        """The counts of one path's run; every kernel of the path must have
        launched. Returns the counts of ``keep`` (default: ``kernels``)."""
        got_ = {kn: counters[kn].launches for kn in kernels}
        log({"path": path, "launches": got_})
        for kn, n in got_.items():
            if n == 0:
                raise RuntimeError(f"{kn} never launched on the {path} path")
        return {kn: got_[kn] for kn in (keep or kernels)}

    for fn in counters.values():
        fn.launches = 0
    facades = {"kernel": idx,
               "reference": SpatialIndex(idx.glin,
                                         EngineConfig(fusion="reference"),
                                         device=DEVICE),
               "off": SpatialIndex(idx.glin, EngineConfig(fusion="off"),
                                   device=DEVICE)}
    for f in facades.values():
        f.snapshot()
        f._device_payload()
    torch.cuda.synchronize()

    def run(facade, name, windows, relation, **kw):
        before = {k: fn.launches for k, fn in counters.items()}
        t0 = time.perf_counter()
        res = facade.query(QueryBatch.window(windows, relation, **kw))
        torch.cuda.synchronize()
        st = res.stages[0]
        log({"batch": name, "relation": relation, "queries": len(windows),
             "wall_ms": (time.perf_counter() - t0) * 1e3,
             "backend": res.plan.backend, "impl": st.impl,
             "escalations": st.escalations, "dispatches": st.dispatches,
             "budget": st.budget, "hits": res.total_hits,
             "launches": {k: fn.launches - before[k]
                          for k, fn in counters.items()}})
        return res

    def same(a, b, what):
        for i, (x, y) in enumerate(zip(a, b)):
            if not np.array_equal(x, y):
                raise RuntimeError(f"{what}: window {i} differs "
                                   f"({len(x)} vs {len(y)} hits)")

    for rel_name in FACADE_RELATIONS:
        # a complement returns nearly every live record per window: its id
        # lists are O(N) each, so it runs on the host-checked windows only
        batch = wins[:DISJOINT_WINDOWS] if rel_name == "disjoint" else wins
        n0 = kr.refine_fused.launches
        main = run(idx, "fused", batch, rel_name)
        if not (main.plan.backend == "device" and main.plan.fused
                and main.stages[0].impl == "fused"
                and kr.refine_fused.launches > n0):
            raise RuntimeError(f"{rel_name}: main path did not run the fused "
                               f"kernel ({main.plan})")
        same(main.ids, run(facades["reference"], "reference", batch,
                           rel_name).ids, f"{rel_name} fused vs reference")
        n0 = kr.refine_compact.launches
        staged = run(facades["off"], "staged", batch, rel_name)
        if kr.refine_compact.launches <= n0:
            raise RuntimeError(f"{rel_name}: staged path did not run the "
                               "compact kernel")
        same(main.ids, staged.ids, f"{rel_name} fused vs staged")
        host = run(idx, "host", wins[:HOST_CHECK], rel_name, backend="host")
        same(main.ids[:HOST_CHECK], host.ids, f"{rel_name} fused vs host")

    # where a fused window batch's time goes: the batch unprofiled (three
    # runs; the least wall) and once under the profiler. host_ms is the
    # least wall less the device's busy time.
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        idx.query(QueryBatch.window(wins, "intersects"))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall, devt, nk = profiled(
        lambda: idx.query(QueryBatch.window(wins, "intersects")))
    busy = sum(devt.values()) if devt else None
    log({"window_profile": {
        "relation": "intersects", "queries": len(wins), "wall_ms": walls,
        "profiled_wall_ms": wall, "device_ms": busy, "device_kernels": nk,
        "device_busy_share": busy / min(walls) if devt else None,
        "host_ms": min(walls) - busy if devt else None,
        "top_kernels": dict(sorted(devt.items(), key=lambda kv: -kv[1])[:8])}})

    ladder = run(idx, "ladder", wins_hi, "intersects")
    if ladder.stages[0].escalations < 1:
        raise RuntimeError(f"selectivity {LADDER_SELECTIVITY} batch never "
                           f"overflowed the budget of {BUDGET}")
    same(ladder.ids[:HOST_CHECK], run(idx, "host", wins_hi[:HOST_CHECK],
                                      "intersects", backend="host").ids,
         "ladder vs host")

    walls, n0 = [], kr.refine_count.launches
    for _ in range(3):
        t0 = time.perf_counter()
        counts = idx.count_candidates(wins, "intersects")
        walls.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(counts, count_i):
            raise RuntimeError("count_candidates differs from refine_count")
    if kr.refine_count.launches - n0 != 3:
        raise RuntimeError("count_candidates did not launch one count "
                           "kernel a call")
    # where its time goes: the probe bounds' torch arithmetic, the kernel
    wall, devt, nk = profiled(
        lambda: idx.count_candidates(wins, "intersects"))
    busy = sum(devt.values()) if devt else None
    log({"batch": "count_candidates", "queries": len(wins),
         "wall_ms": walls, "profiled_wall_ms": wall, "device_ms": busy,
         "device_kernels": nk,
         "count_kernel_ms": sum(t for k, t in devt.items()
                                if "count_kernel" in k) if devt else None,
         "device_busy_share": busy / min(walls) if devt else None})

    hit0 = run(idx, "fused", wins, "intersects")
    victim = int(hit0.ids[1][0])
    c = (wins[0, :2] + wins[0, 2:]) / 2
    ring = np.asarray([[c[0] - 1e-4, c[1] - 1e-4], [c[0] + 1e-4, c[1] - 1e-4],
                       [c[0], c[1] + 1e-4]], np.float32).astype(np.float64)
    new = idx.insert(ring, 3, 0)
    if not idx.delete(victim):
        raise RuntimeError(f"delete of record {victim} failed")
    # a delta of two is patched on the published snapshot (device+delta);
    # a forced device batch then republishes synchronously
    patched = run(idx, "patched", wins, "intersects")
    if patched.plan.backend != "device+delta":
        raise RuntimeError(f"write was not patched: {patched.plan}")
    if new not in patched.ids[0] or victim in patched.ids[1]:
        raise RuntimeError("insert/delete not reflected by the patch")
    after = run(idx, "republish", wins, "intersects", backend="device")
    if not (after.plan.rebuild_snapshot and after.plan.backend == "device"):
        raise RuntimeError(f"write did not republish: {after.plan}")
    if new not in after.ids[0] or victim in after.ids[1]:
        raise RuntimeError("insert/delete not reflected after republish")
    same(after.ids, patched.ids, "republished vs patched")
    same(after.ids[:HOST_CHECK], run(idx, "host", wins[:HOST_CHECK],
                                     "intersects", backend="host").ids,
         "republished vs host")

    launches = read_path("window", window_kernels)

    # -------------------------------------------------------- 6. the kNN path
    mark("6")
    pts = ((wins[:, :2] + wins[:, 2:]) / 2).astype(np.float32).astype(
        np.float64)
    by_sort = SpatialIndex(idx.glin, EngineConfig(knn_topk="sort"),
                           device=DEVICE)
    by_sort.snapshot()
    by_sort._device_payload()
    # count the rung dispatches by compaction (scan / kernel / dense)
    plain_batch_query = eng_mod.batch_query
    modes = collections.Counter()

    def counting_batch_query(*a, **kw):
        modes[kw.get("compaction") if kw.get("exact_budget") else "dense"] += 1
        return plain_batch_query(*a, **kw)

    for facade in (idx, by_sort):       # first-call allocations, untimed
        facade.query(QueryBatch.knn(pts[:HOST_CHECK], KNN_KS[0]))
    for fn in counters.values():
        fn.launches = 0
    # the (B, k) of every top-k launch the drive makes: each rank of the
    # kNN stage pads its hit columns to at least k before the top-k
    real_rank, topk_shapes = exec_mod.batch_knn_rank, collections.Counter()

    def shape_rank(windows, pods_, hits, radius, k, impl="sort", **kw):
        if impl == "kernel":
            topk_shapes[(max(hits.shape[1], k), k)] += 1
        return real_rank(windows, pods_, hits, radius, k, impl, **kw)

    eng_mod.batch_query = counting_batch_query
    exec_mod.batch_knn_rank = shape_rank
    try:
        for k in KNN_KS:
            knn, wall_ms = {}, {}
            # in turns (kernel, sort, sort, kernel): the first batch of a
            # new k pays the allocator's first requests of its sizes
            for name in ("kernel", "sort", "sort", "kernel"):
                facade = idx if name == "kernel" else by_sort
                modes.clear()
                before = {kn: fn.launches for kn, fn in counters.items()}
                t0 = time.perf_counter()
                res = facade.query(QueryBatch.knn(pts, k))
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                wall_ms.setdefault(name, []).append(wall)
                st = res.stages[0]
                log({"batch": f"knn[{name}]", "k": k, "queries": len(pts),
                     "wall_ms": wall,
                     "backend": res.plan.backend, "rungs": st.rungs,
                     "rung_hist": list(st.rung_hist),
                     "seed_hits": st.seed_hits,
                     "escalations": st.escalations,
                     "dispatches": st.dispatches, "cap": st.cap,
                     "note": st.note,
                     "host_fallback": "host fallback" in st.note,
                     "rung_dispatches": dict(modes),
                     "scan_dispatches": modes.get("scan", 0),
                     "launches": {kn: fn.launches - before[kn]
                                  for kn, fn in counters.items()}})
                if res.plan.backend != "device" or any(
                        len(r) != k for r in res.ids):
                    raise RuntimeError(f"knn[{name}] k={k}: {res.plan}")
                if name in knn:
                    same(res.ids, knn[name].ids, f"knn[{name}] k={k} rerun")
                knn[name] = res
            same(knn["kernel"].ids, knn["sort"].ids,
                 f"knn k={k} kernel vs sort")
            for a, b in zip(knn["kernel"].distances, knn["sort"].distances):
                if not np.array_equal(a, b):
                    raise RuntimeError(f"knn k={k}: distances differ "
                                       "between the kernel and the sort")
            t0 = time.perf_counter()
            host = idx.query(QueryBatch.knn(pts[:HOST_CHECK], k,
                                            backend="host"))
            log({"batch": "knn[host]", "k": k, "queries": HOST_CHECK,
                 "wall_ms": (time.perf_counter() - t0) * 1e3})
            same(knn["kernel"].ids[:HOST_CHECK], host.ids,
                 f"knn k={k} kernel vs host")
            err = 0.0
            for a, b in zip(knn["kernel"].distances, host.distances):
                if not np.allclose(a, b, rtol=1e-4, atol=1e-7):
                    raise RuntimeError(f"knn k={k}: distances off the host's")
                err = max(err, float(np.abs(a - b).max()))
            log({"knn_vs_host": {"k": k, "max_abs_err": err}})
            # where the batch's time goes: device time by kernel of the same
            # query repeated under the profiler, over its unprofiled wall
            wall, dev, _ = profiled(
                lambda: idx.query(QueryBatch.knn(pts, k)))
            busy = sum(dev.values())
            log({"knn_profile": {
                "k": k, "profiled_wall_ms": wall, "device_ms": busy,
                "device_busy_share": (busy / min(wall_ms["kernel"]) if dev
                                      else None),
                "top_kernels": dict(sorted(dev.items(),
                                           key=lambda kv: -kv[1])[:8])}})
    finally:
        eng_mod.batch_query = plain_batch_query
        exec_mod.batch_knn_rank = real_rank
    launches.update(read_path("knn", ("knn_topk", "refine_compact"),
                              keep=("knn_topk",)))
    # one line per (B, k) the drive launched, on the inputs of that shape's
    # first launch in one more batch per k (after the counts were read: the
    # wrapper counts into the stand-in that core.device calls meanwhile)
    grabbed, real_topk = {}, kk.knn_topk

    def grab_topk(d, ids, k):
        grabbed.setdefault((d.shape[1], k), (d.clone(), ids.clone()))
        return real_topk(d, ids, k)

    grab_topk.launches = 0
    kk.knn_topk = grab_topk
    try:
        for k in KNN_KS:
            idx.query(QueryBatch.knn(pts, k))
    finally:
        kk.knn_topk = real_topk
    for (b, k), n in sorted(topk_shapes.items()):
        if (b, k) not in grabbed:
            raise RuntimeError(f"knn_topk (B {b}, k {k}) did not recur")
        log({**topk_line(f"knn_topk[drive B {b}, k {k}]", *grabbed[(b, k)],
                         k), "drive_launches": n})
    del grabbed

    # ------------------------------------------------ 5b. the baselines
    mark("5b")
    # (the fused kernel's launches of 5b and 5c add to its count)
    for kn, n in baselines_phase(idx, wins, counters, read_path).items():
        launches[kn] += n
    # ------------------------------------------------ 5c. the examples
    mark("5c")
    for kn, n in examples_phase(counters, read_path).items():
        launches[kn] += n

    # ------------------------------------- 6a-6c. writes, async swap, serving
    mark("6a-6c")
    # each path's launches of B1, B2 and B3 add to theirs in the last line
    # (and 6d's of B1 and B3)
    write_launches, sync_ms = write_phase(idx, wins, pts, counters,
                                          read_path)
    for path in (write_launches,
                 async_phase(idx, wins, counters, read_path, sync_ms),
                 serve_phase(idx, gs, counters)):
        for kn, n in path.items():
            launches[kn] += n
    torch.cuda.empty_cache()

    # ------------------------------------------------ 6d. the sharded backend
    mark("6d")
    for kn, n in sharded_phase(idx, wins, wins_hi, pts, counters,
                               read_path).items():
        launches[kn] += n

    # ------------------------------------------------ 7. the ops entry point
    mark("7")
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    hi, lo = kops.morton_encode(qx, qy)
    want_hi, want_lo = split_hilo_np(morton_encode_np(qx_np, qy_np))
    if not (np.array_equal(hi.cpu().numpy(), want_hi)
            and np.array_equal(lo.cpu().numpy(), want_lo)):
        raise RuntimeError("ops.morton_encode differs from the host keys")
    mask = kops.refine_mask(wm, bm, rm)
    ops_count = kops.refine_count(wm, bm, rm)
    if not torch.equal(mask.sum(1, dtype=torch.int32), ops_count):
        raise RuntimeError("ops.refine_mask row sums differ from "
                           "ops.refine_count")
    # the entry point's plain side (use_kernel=False) on the same inputs
    compare("ops.morton_encode", (hi, lo),
            kops.morton_encode(qx, qy, use_kernel=False))
    compare("ops.refine_mask", mask,
            kops.refine_mask(wm, bm, rm, use_kernel=False))
    compare("ops.refine_count", ops_count,
            kops.refine_count(wm, bm, rm, use_kernel=False))
    compare("ops.refine_compact", kops.refine_compact(wm, bm, lm, rm,
                                                      budget=BUDGET),
            kops.refine_compact(wm, bm, lm, rm, budget=BUDGET,
                                use_kernel=False))
    # the fused query over phase 3's snapshot's packed operands, over the
    # snapshot's walk and over the walk the entry point derives (``dev`` is
    # a profile's dict by now)
    from repro_torch.core import device as core_dev

    frel = core_dev._device_relation("intersects")
    wf = w[:MASK_WINDOWS]
    f_args = (wf, frel.probe_window(wf), torch.stack(
        core_dev._raw_query_keys(snap, wf, frel), dim=1),
        *snap.fused_operands,
        pods.headers, pods.pool, lm, rm)
    f_kw = dict(budget=BUDGET, prefilter=frel.prefilter_kind, code=frel.code,
                dist=frel.dist, augment=bool(frel.augment)
                and snap.pw_zmax_hi.shape[0] > 0,
                search_steps=snap.search_steps, depth=snap.depth)
    f_want = kops.refine_fused(*f_args, **f_kw, use_kernel=False)
    compare("ops.refine_fused", kops.refine_fused(
        *f_args, **f_kw, leaves=snap.leaf_walk), f_want)
    compare("ops.refine_fused[derived walk]",
            kops.refine_fused(*f_args, **f_kw), f_want)
    torch.cuda.synchronize()
    log({"batch": "ops", "wall_ms": (time.perf_counter() - t0) * 1e3,
         "records": nrec, "mask_windows": MASK_WINDOWS})
    launches.update(read_path("ops", ("morton_encode", "refine_mask",
                                      "refine_count", "refine_compact",
                                      "refine_fused"),
                              keep=("morton_encode", "refine_mask")))

    # ------------------------------------------------------ 8. LM serving
    mark("8")
    torch.cuda.empty_cache()
    lm_results, lm_launches = lm_phase(katt, counters)
    results.update(lm_results)
    launches.update(lm_launches)

    # ------------------------------------------------------ 9. SSM serving
    mark("9")
    ssm_results, ssm_launches = ssm_phase(kssd, counters)
    results.update(ssm_results)
    launches.update(ssm_launches)

    # ------------------------------------------------ 10. hybrid serving
    torch.cuda.empty_cache()
    mark("10")
    hybrid_results, hybrid_launches = hybrid_phase(katt, kssd, counters)
    for kn, n in hybrid_launches.items():
        launches[kn] += n

    # ------------------------------- 11. MoE serving, 12. stub frontends
    # (their launches of B7 and B8 add to phases 8-10's)
    mark("11")
    moe_results, moe_launches = moe_phase(katt, counters)
    mark("12")
    stub_results, stub_launches = stub_phase(katt, counters)
    family_results = {**moe_results, **stub_results}
    family_launches = {**moe_launches, **stub_launches}
    for per_model in family_launches.values():
        for kn, n in per_model.items():
            launches[kn] += n

    # ---------------------------------------------------------- 13. training
    torch.cuda.empty_cache()
    mark("13")
    train_results, train_launches = train_phase(katt, kssd, counters)

    # ------------------------------------------------- 14. the sharded trainer
    torch.cuda.empty_cache()
    mark("14")
    shard_run = sharded_train_phase(counters)

    # ------------------------------------ 15. the sharded families, serving
    torch.cuda.empty_cache()
    mark("15")
    fam = families_phase(katt, counters)

    # ------------- 16. sequence sharding, the production meshes' refused cells
    torch.cuda.empty_cache()
    mark("16")
    dry = DryRuns()                     # 17b and 17c, beside 16 and 17a
    try:
        seq16 = seq_phase(katt, counters, shard_run)

        # --------------------------------------------- 17. the dry run, PF3
        torch.cuda.empty_cache()
        mark("17")
        dry17 = dryrun_phase(katt, counters, dry, shard_run, fam, seq16)
    finally:
        dry.stop()

    # ------------------------------------------------------------ 18. report
    mark("18")
    entries = []
    for k in counters:
        r_ = results[k]
        entry = {"name": k, "route": "cuda", "source": CSRC[k],
                 "replaces": REPLACES[k], "launches": launches[k],
                 "max_abs_err": r_["max_abs_err"],
                 "ms": r_["kernel_ms"], "plain_ms": r_["plain_ms"],
                 "bound_ms": r_["bound_ms"], "bound_by": r_["bound_by"],
                 "library_ms": r_.get("library_ms"),
                 **{key: r_[key] for key in (
                     "device_ms", "queued_ms", "bound_slot_ms",
                     "leaves_walked", "groups_walked") if key in r_}}
        if k in hybrid_results:     # the same kernel at hymba_1p5b's shapes
            h_ = hybrid_results[k]
            entry["hymba"] = {
                "launches": hybrid_launches[k], "shape": h_["shape"],
                **{key: h_[key] for key in (
                    "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")}}
        if k in train_results:      # the training path's launches
            t_ = train_results[k]
            entry["training"] = {
                "launches": train_launches[k], "shape": t_["shape"],
                **{key: t_.get(key) for key in (
                    "max_abs_err", "kernel_ms", "backward_ms",
                    "forward_backward_ms", "plain_ms", "bound_ms",
                    "bound_by", "backward_bound_ms", "library_ms")}}
        if k == "flash_attention":  # the sharded step's launches (14a)
            f_ = shard_run["flash_attention"]
            entry["sharded_training"] = {
                "launches": shard_run["launches"][k],
                "mesh": shard_run["mesh"], "shape": f_["shape"],
                "step_ms_median": shard_run["step_ms_median_timed"],
                **{key: f_.get(key) for key in (
                    "max_abs_err", "kernel_ms", "backward_ms",
                    "forward_backward_ms", "plain_ms", "bound_ms",
                    "bound_by", "backward_bound_ms", "library_ms")}}
        fam_paths = {tag: run["launches"][k] for tag, run in fam.items()
                      if run.get("launches", {}).get(k)}
        if fam_paths:               # phase 15's paths (15a-15d)
            entry["sharded_families"] = {"launches": fam_paths}
            for tag, run in fam.items():
                if run.get("launches", {}).get(k) and \
                        "step_ms_median_timed" in run:
                    at = run["kernels_at_position_shape"].get(k, {})
                    entry["sharded_families"][tag] = {
                        "step_ms_median": run["step_ms_median_timed"],
                        "tokens_per_s": run["tokens_per_s_median_step"],
                        **{key: at.get(key) for key in (
                            "shape", "max_abs_err", "kernel_ms",
                            "backward_ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms") if at}}
            if k == "decode_attention":
                b8 = fam["15d granite_3_2b"]
                loc = b8["b8_position_local"]
                entry["sharded_families"]["position_local"] = {
                    "shape": loc["shape"], "live_slots": loc["live_slots"],
                    "merge_ms": b8["merge_ms"],
                    "decode_ms_median": b8["decode_ms_median"],
                    **{key: loc.get(key) for key in (
                        "max_abs_err", "lse_max_abs_err", "kernel_ms",
                        "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        entry.update(phase16_entries(k, seq16))
        pf3 = dry17["17a"]["by_heads"]
        if pf3["launches"].get(k):  # 17a: the ring laid out by kv heads
            entry["pf3"] = {"launches": {
                "17a prefill": pf3["prefill_launches"][k],
                "17a decode": pf3["decode_launches"][k]}}
            full = dry17["17a"]["full_width"]
            entry["pf3"]["launches"].update({
                "17a full_width prefill": full["prefill_launches"][k],
                "17a full_width decode": full["decode_launches"][k]})
            if k == "decode_attention":
                for name, run, loc in (
                        ("position_local", pf3, pf3["b8_position_local"]),
                        ("full_width_position_local", full,
                         full["b8_position_local_bf16"])):
                    entry["pf3"][name] = {
                        "decode_ms_median": run["decode_ms_median"],
                        **{key: loc.get(key) for key in (
                            "shape", "live_slots", "max_abs_err",
                            "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms")}}
        for label, lines in family_results.items():
            if k in lines:          # the same kernel at a family's shapes
                f_ = lines[k]
                entry[label] = {
                    "launches": family_launches.get(label, {}).get(k),
                    "shape": f_["shape"], "window": f_["window"],
                    **{key: f_[key] for key in (
                        "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")}}
        entries.append(entry)
    log({"script_s": time.perf_counter() - T0})
    log(card_line())
    log({"kernels": entries})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
