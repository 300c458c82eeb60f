#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches and continues):

1. build    -- compile the CUDA kernels from ``src/repro_torch/csrc`` with
               nvcc (one process per source, started together) and print
               the build seconds and ptxas register / spill lines; the
               library's SASS (``cuobjdump``) must show tensor-core HMMA
               instructions in every bf16 flash instance and every
               tensor-core KDE instance (the bf16 sample_block /
               masked_blocksum tile, ``sampler_mma_kernel``, and the bf16
               rowsum / blocksum tile, ``blocksum_mma_kernel``), and none
               in the f32 flash instances or the other sampler and rowsum
               tiles (the wide ones built for the f32 kinds only).
               Then (``phase_tuning``) the card against
               ``kernels/tuning.py``: its limits as the CUDA attributes
               give them, and every kernel instance's registers, shared
               memory, local memory, spills and CTAs an SM equal to
               ``tuning.RESOURCES`` and ``tuning.ctas_per_sm``, a
               ``[tuning]`` line each.
2. kernels  -- every kernel against its plain PyTorch version on the card:
               all four kernel kinds on ragged shapes (m=37, n=301, d=19,
               bn=70; the kde_hash kernels at m=37, t=45, d=19; laplacian
               also at d=784) and each kernel at its main-path shape;
               floats within rtol 2e-4 / atol 1e-5 (the reference's own
               kernel tolerance; the kde_hash kernels' atol scales with
               the output, see ``HASH_ATOL``), drawn blocks equal except
               on rows whose top two scores lie within 1e-5.  Times the
               kernel, its plain version and a PyTorch yardstick
               (``torch.cdist`` + elementwise + sum) with CUDA events, and
               every kernel's card time with torch.profiler
               (``device_ms``).  The sample-block kernel is also held to
               one device launch a call (profiler events), to int32 and
               int64 own giving the same result, to planted exact ties
               (two equal blocks, equal Gumbel noise: the lower block on
               every row, every kind) and to calls of several row counts
               in a row (its arrival counters reset themselves); the
               blocksum kernel to one launch a call and the rowsum to two;
               the wide-tile ragged shapes (d = 8, 32), the deep tile's
               (d = 36, 784) and views off 16 bytes (the generic tile of
               every kernel; for the kde_hash kernels, x) join the ragged
               checks, each printing the rowsum / blocksum tile it took,
               and so do the paper phase's widths (d = 2 and 3: the
               generic tile; d = 200: the deep one) and a rings-like
               input (coordinates near 100, where the L2 expansion
               cancels in f32) in every kind.
               ``host_us`` of the sample-block and weighted-kv wrappers,
               and the weighted-kv kernel's achieved rate of gathered
               bytes, are printed.  The rowsum kernel is also checked and
               timed at the rs row norms' shape (1024 queries against 80
               subsampled rows of cX, d = 784).
3. sparsify -- ``spectral_sparsify`` (exact level-1, Alg 5.1) at n=65536,
               d=16, t=10n, batch 1024, with counters checked against the
               analytic formula; after the main path, the law of all its
               drawn edges is checked by chi-square (sources per level-1
               block against the exact degrees, destinations by their
               probability integral transform under k(u, .) / deg(u)), and
               sum(w) against the exact total kernel mass, which only
               shows that the sums are consistent.
4. sampler  -- ``NeighborSampler.sample`` then ``prob_of`` (a second
               sampler, so the masked-blocksum kernel reads the frontier
               afresh) on a 4096-row frontier at n=65536; then
               ``sample_exact`` (Theorem 4.12, rounds 8, slack 2) on a
               stratified sampler over the same frontier, which launches
               no kernel: its fallback count is printed and, after the
               main path, its destinations are held to k(u, .) / deg(u)
               by the destination PITs of the sparsify phase's edge law.
5. lra      -- ``fkv_lowrank`` (Alg 5.15) on mnist_like(16384, 784) with
               the laplacian kernel, rank 20, 500 rows, against a block
               subspace iteration on the dense K computed on the card.
               After phase 7, the same call with the sub-linear row norms
               (``estimator="rs"``: 80 uniformly drawn rows of cX a query
               through the rowsum kernel, exactly 16 launches; and
               ``estimator="stratified"``: 16 of each 256-row block, no
               kernel), each run counted on its own: kernel_evals n 80 +
               500 n and n 64 16 + 500 n, and each error within 1.5x the
               subspace iteration's, the exact LRA's bound.
6. hash     -- ``spectral_sparsify(estimator="hash")`` (the sub-linear
               hashed-KDE path of Section 3.1) on gaussian_clusters(n =
               262144, d = 16), gaussian kernel at bandwidth 1.0, t = 10n,
               batch 1024, the reference's defaults (block size 512,
               max_bucket 128, far_per_block 2, 64 FAR samples per degree
               query, 8 hash dims, cell width 2.0).  Then, off the counted
               run: (1) hashing the rows on the card reproduces the host
               build's ``point_bucket``; (2) sum of the hashed degrees
               within 2% of the exact sum (blocksum kernel); (3) no fatal
               status flag, ``kernel_evals`` and ``kde_queries`` equal the
               reference's formulas; (4) the edge law -- sources by
               chi-square per level-1 block against the hashed degrees the
               sampler drew from, destinations by randomized PITs under
               k(u, .) restricted to the destination's block (level 2 is
               exact; the block law itself is estimated); (5) the spectral
               error at the reference's bench_kde spectral config within
               ``SPEC_BOUND``.  A per-stage breakdown of one edge batch
               follows, timed with CUDA events.
7. stratified -- the reference's default call ``spectral_sparsify(x, k,
               t)`` (stratified level-1 reads, s = 16 of each 512-row
               block, B = 512; degrees from the same structure) on phase
               6's data; the run launches no kernel.  Then, off the
               counted run: (1) no fatal status flag, ``kernel_evals`` =
               n B s + drawn (B s + bs + 1) and ``kde_queries`` = n +
               drawn; (2) the sum of the stratified degrees within 2% of
               the exact sum (blocksum kernel); (3) the edge law of phase
               6's check 4; (4) the spectral error at the same config
               within ``STRAT_SPEC_BOUND``.  A per-stage breakdown of one
               edge batch follows (CUDA events).
8. bf16     -- the bf16 precision policy (DESIGN.md §14): (a) the bf16
               instances of all six KDE kernel entry points against their
               plain versions on the card, every L2 kind, at the ragged
               shapes and tiles of phase 2 (d = 19, 8, 32, 36, 784, views
               off 16 bytes; kde_hash m=37, t=45), one-column blocksums
               (every kernel value: equal to the plain value wherever no
               bf16 rounding midpoint lies within the f32 error of the
               pair's argument), dyadic points (no slack) with planted
               ties and sample_block calls of several row counts, and each
               kernel at its main-path shape, timed; floats within rtol
               2e-4 / atol 1e-5 plus the flip slack of the pairs behind
               each output (``ref.bf16_flip_slack``: two correct f32
               summation orders may round the exp argument to
               neighbouring bf16 values, and read neighbouring table
               entries, only where a rounding midpoint lies within the
               f32 error of the exact argument); (b) the reference's
               bench_kde precision sweep, ExactKDE f32 against bf16,
               gaussian at bandwidth 4.0, d = 16, m = 64, n = 65,536 ...
               1,048,576 (not cut): us a batch, evals/s, the bf16 / f32
               time ratio, the max relative error within 2 BF16_REL_ERR;
               (c) the exact sparsifier in bf16 on phase 3's data and
               configuration from the public classes
               (``NeighborSampler(exact_blocks=True, precision="bf16")``,
               a ``DegreeSampler`` over its blocks, ``edge_batches``):
               kernel_evals = n^2 + drawn (n + bs + 1), no fatal flag, the
               bf16 degree sum against the exact f32 one (within 2
               BF16_REL_ERR), the edge law (sources against the bf16
               degrees drawn from, destinations by the block-restricted
               PITs of phase 6), then ``prob_of`` on a fresh bf16 sampler;
               (d) the hashed sparsifier in bf16 on phase 6's data
               (``NeighborSampler(level1="hash", precision="bf16")``,
               degrees from its hash estimator, t = 10n): phase 6's
               layout, counter formula, degree-sum bound and edge law,
               then a bf16 hashed walk (1024 x 8) on the same sampler.
               (c) and (d) launch only bf16 instances (asserted), and
               every weighted launch of (d) gathers the estimator's one
               bf16-resident copy of the dataset (asserted).  (a) also
               holds the sampler kernels' tensor-core tile to the
               flip slack on inputs built for cancellation (a common
               offset large against the spread; queries that are dataset
               rows), the rowsum / blocksum tensor-core tile at m = 64
               (one short query tile: two warps a row slice split the
               columns) and m = 65 (full and short), with two calls
               bitwise equal, and the weighted kernels on the bf16 copy
               bitwise to their bf16 instances on the f32 rows.  The
               rowsum and blocksum rows print their plan's instance, and
               the rowsum row the reduce's share of its device time.
9. graph    -- walks (Algorithm 4.16) and the Table-1 applications through
               the public entry points, each configuration's wall time and
               rate printed beside the card line.  (a) stratified walks on
               the walk-resident cache at bench_sampling's largest
               walk-scaling point (x ~ N(0, 0.5^2), n = 1,048,576, d = 16,
               gaussian at bandwidth 4.0, s = 16): 256 walkers x 4 steps
               timed (walk-steps/s), then 1024 x 8 with the path: no
               kernel launch, kernel_evals = steps (w B s_eff + w wbs) of
               the printed walk layout, no fatal flag, every transition by
               its in-stratum PITs (chi-square, alpha 1e-3); (b)
               exact-block walks on phase 3's data: 1024 x 8, exactly 8
               sample-block launches, kernel_evals 8 (w n + w bs), every
               transition held to k(u, .) / deg(u) (``neighbor_law``); with
               rejection rounds (8, slack 2) 256 x 4, exactly 4
               masked-blocksum launches and no sample-block launch,
               fallbacks printed, the same law; (c) hashed walks on phase
               6's data and sampler, 1024 x 8: exactly 8 weighted-kv
               launches, the counter formula, destinations by their
               block-restricted PITs; (d) Theorem 4.15: 20,000 exact-block
               walks of 3 steps from vertex 0 at n = 4096, endpoints per
               level-1 block by chi-square against e_0 M^3 computed in
               float64 on the card, on N(0, 0.5^2) at bandwidth 4.0 (where
               e_0 M^3 is near uniform over the blocks) and on GM_CLUSTERS
               sorted by label at bandwidth 1.0, where uniform endpoints
               and the walks' endpoints against e_0 M^2 must be rejected;
               (e)
               ``triangle_batches`` at bench_graph's engine configuration
               (n = 16,384, 2048 pairs x 16 draws) on the stratified
               sampler (timed, draws/s, no kernel) and on the exact one
               (exact degrees through the blocksum kernel, then exactly one
               masked-blocksum launch a call and kernel_evals m (n + 1) +
               ns (m bs + m), timed), then ``estimate_triangle_weight`` at
               bench_graph's accuracy configuration (gaussian_clusters n =
               1200; 200 x 8 and 600 x 24) within ``TRI_BOUND`` of
               ``exact_triangle_weight``; (f) ``edge_batches`` at the engine
               configuration (4096 edges, timed, edges/s), then
               ``estimate_arboricity`` at m = 2400 and 9600 within
               ``ARB_BOUND`` of ``exact_arboricity``, kernel_evals n B s +
               drawn (B s + bs + 1); (g) on the accuracy configuration:
               ``same_cluster_test`` on the reference test's four pairs
               (the expected decisions, kernel_evals 6 walks (n + bs), six
               sample-block launches a test), ``top_eigenvalue(
               method="noisy_power", t=192)`` within Lemma 5.21's 2 n /
               sqrt(t) of ``top_eigenvalue_exact``, ``solve_kernel_
               laplacian``'s residual under ``CG_RTOL``,
               ``approximate_spectrum``'s counter formula and its EMD to
               ``exact_spectrum``, ``spectral_cluster`` on a sparsifier
               (accuracy printed).  A torch.profiler split of one walk of
               (a), (b), (c) and of one triangle batch of (e) follows.
               Each counted path's first call of each kernel wrapper is
               recorded (``tapped``) and held against the plain version on
               the same inputs at phase 2's tolerances, its max abs error
               folded into the kernel's row (``path_kernel_checks``): the
               sample-block kernel on the walks of (b), (d) and (g), the
               masked-blocksum kernel on the rejection walk and the exact
               triangle batch, the weighted-kv kernel on the hashed walk,
               the blocksum kernel on the exact degrees of (e); those
               degrees against the plain float64 row sums, and the exact
               triangle batch's oriented pairs and weights against
               ``triangle_batch_ref`` on its own noise.
10. lm-prefill -- yi-6b at full width and depth (random f32 weights drawn
               on the card, 6.06 B parameters): ``make_prefill_step(impl=
               "flash")`` on ``make_batch`` tokens at batch 1, seq 8192
               (the reference's prefill_32k shape, 32768 x 32, cut to
               8192 x 1): exactly 32 flash launches; its last-position
               logits against ``impl="xla"`` (the chunked branch at 8192):
               max |diff| <= 1e-3 max |logit| and the same argmax per row.
11. lm-serve -- the port's serve driver (``launch.serve.run_lm``) on the
               same model, batch 4, prompt 512, gen 16, twice: ``--attention
               xla`` (its last-prompt-step logits against the flash prefill
               of the same prompts, same bound and argmax) and ``--attention
               kde`` (the CLI defaults top_p 4, bk 32, stride 4; cache 528
               rounded up to 544): exactly 32 x (512 + 15) launches of the
               fused KDE decode kernel, then on its final cache (layers 0,
               15, 31) kde_attention through the kernel against the
               plain-torch mirror.  Prints the first
               generated step's logit correlation (kde vs xla, reported,
               not gated), prefill s and decode tok/s, a torch.profiler
               split of 8 decode steps of each attention, and their walls
               over three rounds of 8 steps taken in turns (xla, kde, kde,
               xla, xla, kde).
12. lm-bf16 -- the bf16 LM, the reference's default dtype.  (a) phase
               10's f32 weights rounded through bf16 in place and their bf16
               twin from ``cast_params`` (yi-6b as configured, bfloat16):
               ``make_prefill_step(impl="flash")`` at 8192 x 1 on phase
               10's tokens, exactly 32 flash launches on bf16 operands,
               the bf16 xla (chunked) prefill and the f32 flash prefill of
               the rounded f32 model; gate max |flash_bf16 - xla_bf16| <=
               max |xla_bf16 - f32| over the real vocab at the last
               position; both gaps, the argmax agreement and tokens/s
               printed; the f32 model is then freed.  (b) the reference's
               long_500k KDE decode cell (``launch/dryrun.py``:106-114:
               batch 1, ``init_cache``'s default bf16 cache of 524,288
               slots, top_p 16, bk 512, stride 16): first kde vs
               ``exact_decode_attention`` on bench_attention's planted
               keys at this shape (printed), then the cache with seeded
               synthetic N(0, 1) K/V below its last 64 slots, 32
               teacher-forced and 32 generated ``make_decode_step(impl=
               "kde")`` steps: exactly 32 x 64 kde_decode launches, finite
               logits; decode tok/s and ``max_memory_allocated``; a
               profile of one step (idle share, kde_decode device ms
               against its bytes bound beside its grid -- the spread
               kernel, CTAs a launch --, the GEMM / GEMV time against the
               weights' bytes / 3.35 TB/s); on the final cache (layers 0,
               15, 31) the bf16 kernel bitwise the f32 instance on the
               upcast inputs and within phase 2's tolerances of the plain
               pipeline (est; out within one bf16 step); then 2 dense
               ``impl="xla"`` steps on the same cache (their wall, the
               kde-vs-xla logit correlation: reported, not gated).
13. streaming -- the streaming engine (DESIGN.md §12) at the reference's
               streaming bench (benchmarks/bench_streaming.py:65-80: x ~
               N(0, 0.5^2), d 8, gaussian at bandwidth 2.0, batches of m =
               n0 / 100 rows a third each insert / delete / update, a
               64-row frontier, block size 512) scaled to n0 = 262,144,
               capacity n0 + 5 m + 64, journal 16.  (a) exact level 1:
               ``DynamicDataset`` + ``NeighborSampler(dataset=,
               exact_blocks=True)`` + ``DegreeSampler(nbr.blocks,
               dataset=)``; one warm-up batch and 4 timed (streaming
               rows/s) against the bench's rebuild baseline (rows/s, the
               speedup), after each batch the patched degrees against a
               fresh blocksum recompute (rtol 5e-4 / atol 5e-5, dead slots
               exactly 0) and ``prob_of`` of the patched cache against a
               fresh sampler's (masked-blocksum kernel, rtol 2e-5 / atol
               1e-7); then ``edge_batches`` (4096 edges: sources by block
               against the live degrees, destinations by ``neighbor_law``),
               a walk and ``prob_of`` on a fresh frontier, every draw on a
               live slot; a torch.profiler busy / idle split of one
               batch.  (b) hashed: the patched layout against a fresh
               ``build_hash_state(live=, overflow_cap=)`` after deletes and
               same-cell updates (every row's bucket bitwise, the same FAR
               draw's NEAR counts equal and estimates within rtol 1e-6; on
               cells of 0.5, where no bucket is truncated); then
               ``StreamingKernelGraph(level1="hash")`` (f32, 5 batches) and
               the same parts with ``precision="bf16"`` (3 batches): after
               each batch vertices, neighbors, edges and walks on live slots
               only, the layout's invariants (device state = the patcher's
               mirrors, no dead slot stored, every live self-stored slot in
               its bucket or the overflow region), the eval and overflow
               counters at the overflow width, no flag but the benign ones
               and ``OVERFLOW_SATURATED`` (the region fills in ~3 batches
               of this plan and compacts: these reads run with
               ``REPRO_CHECKS=0``, under which saturation compacts instead
               of raising), bf16: the bf16 copy bitwise the rounded current
               rows; the weighted kernels timed at the overflow width
               beside their plain versions and bounds.  (c) journal gaps:
               6 batches unread past the journal (the exact consumers
               rebuild: the degree estimator as a ``StratifiedKDE`` of the
               exact-block one's block size and samples, degrees and
               ``prob_of`` against fresh ones) and ``compact`` (the hash
               layout rebuilds).
14. estimators -- ``GridHBE`` on phase 3's data (256 queries, 128 FAR
               samples: mean relative error against the rowsum kernel
               under 0.15, tests/test_kde.py:59-70, evals under m n, no
               kernel launch); ``RobustEstimator`` on phase 6's data: 1024
               clean queries build only the hash stage (one
               weighted-kv-sum launch), 64 planted queries far from every
               bucket with a NEAR-only hash stage escalate hash ->
               stratified -> exact (counts asserted) and the exact rows
               equal the rowsum kernel's; tree-mode sampling over a
               ``MultiLevelKDE`` of ``ExactKDE`` nodes (n 4096, leaf 32,
               256 sources x 4 draws): the destinations by
               ``neighbor_law``, exactly 2 (depth - 1) rowsum launches a
               draw.  Each path's first call of each kernel wrapper is held
               against its plain version (``tapped``), as in phase 9.
15. serve    -- the multi-tenant servable (``core.serving``) and the
               serve CLI's graph-serving modes.  (a) bench_serve.py's own
               plan (n 1024, d 8, gaussian 1.0, blocks of 32, 4 tenants, 32
               mixed requests a tick -- sample w 16, query q 8, walk w 8
               length 4, prob_of w 16 -- 16 timed ticks after a warm-up):
               all tenants blocked (stratified: no kernel launch,
               asserted), then the hash mix (odd tenants hashed); p50 / p99
               latency, served and sequential req/s and their ratio, and a
               torch.profiler busy / idle split of one tick; ``failed ==
               0`` in every tick.  (b) 4 exact tenants of
               ``gaussian_clusters(n=65536, d=16)`` (seeds 0-3), blocks of
               256, 8 ticks of the same mix: each group one launch of each
               tenant-axis kernel (sample_block, masked_blocksum, blocksum;
               the walk group one a step); the tapped tenant-axis launches
               bitwise equal to per-tenant launches on the same rows and
               within phase 2's tolerances of their plain versions, timed
               against the group's single-request launches; every request
               against the single-request program fed its noise (sample
               neighbors equal, probabilities, prob_of and query within
               rtol 1e-6); the draws by ``neighbor_law``; then
               ``max_resident`` 2: admissions and evictions by the LRU
               rule.  (c) ``serve --serve-tenants 4 --requests 32 --ticks
               8 --level1 hash --telemetry --metrics-format prometheus``
               and ``--graph-stream 262144 --ticks 4`` (blocked, hash):
               exit 0, metrics lines valid, the dump holds
               ``serve.tick.us``.  Every serve path's launches are counted
               (``serve_launches``); the five kernels of the serving path
               must all have run.
16. train    -- training on the card (``phase_train``).  (a)
               granite-3-2b at full width and depth (40 layers, d 2048, 32
               / 8 heads, head dim 64, d_ff 8192, vocab 49,155; random f32
               weights drawn on the card from seed 0), one ``make_batch``
               batch of 4096 tokens (the reference's train_4k shape, 4096 x
               256, cut in batch): ``loss_fn`` and its gradients with
               ``impl="flash"`` -- exactly 80 flash launches with
               ``remat=True`` (the forward and the recompute), 40 without
               -- against ``impl="xla"`` on the same weights: the loss at
               rtol 1e-5, the global gradient norm at rtol 1e-4, layers 0,
               19 and 39's wq / wk / wv / wo gradients within 1e-3 of the
               xla gradient's largest entry.  (b) four steps of
               ``make_train_step(impl="flash")`` (peak lr 1e-5, the
               reference's warmup of 100 steps, the same batch): the loss
               falls at every step, every metric
               finite, 80 flash launches a step; ms a step, tokens/s,
               model FLOP/s (6 N T plus the causal attention) against the
               67 TFLOP/s FP32 peak, a torch.profiler busy / idle split of
               one step; the path's first flash launch against the plain
               version on its own inputs.  (c) ``cast_params`` to bf16 and
               two steps: every flash launch on bf16 operands in the
               tensor-core body (the tapped launch's instance), finite
               metrics, the step-1 loss within 1% of the f32 loss on the
               same weights and batch.  Then the flash kernel at the
               training shape (1, 32, 4096, 64), 8 kv-heads, f32 and bf16:
               against its plain version, its device ms beside its bound
               and SDPA's time (the rows' ``train_*`` keys).  (d)
               ``python -m repro_torch.launch.train --arch granite_3_2b
               --reduced --steps 6 --ckpt-every 2 --fail-at-step 3`` on the
               card exits 17, the rerun exits 0 "resumed from step 2", and
               its losses equal an unbroken run's at rtol 1e-6.  Prints
               ``memory_allocated`` at the start and each part's peak.
17. families -- the non-dense LM families (``phase_families``), one
               config at a time, each freed before the next, at full width
               in f32 with random weights drawn on the card from seed 0:
               granite-moe-1b-a400m **cut to 12 of 24 layers**,
               qwen3-moe-235b-a22b **cut to its first 4 of 94 layers** (45
               GB), rwkv6-3b **cut to 16 of 32**, zamba2-7b,
               seamless-m4t-medium, internvl2-1b (parameters beside
               ``param_count()``, peak memory).  (a) the flash prefill
               against xla on one ``make_batch`` batch of 4 x 512 (the
               frontend configs: 128 embeddings + 384 tokens): exactly
               12 / 4 / 0 / 14 / 12 / 24 flash launches; last-position
               logits within 1e-3 x max |logit|, the same argmax -- for
               MoE only when no (row, position, layer) router top-k set
               differs between the two runs (a tap on ``layers._top_k``),
               and at most 1% may.  (b) ``launch.serve.run_lm`` at batch
               4, **prompt cut to 256** (64 embeddings + 192 tokens for
               the frontend configs), gen 16, xla then kde (top_p 4, bk
               32, stride 4): finite logits, exactly (attention layers or
               shared-block applications) x (prompt tokens + 15)
               kde_decode launches, the kde_attention kernel path against
               its plain pipeline on the final cache's first and last
               attention layer, rwkv6's replay against the forward's scan
               over the same prompts within 1e-3 x max |logit| (the
               chunked forward's gap from the scan printed: the
               reference's one-sided -30 clamp); decode tok/s, a busy /
               idle split of 4 decode steps of each attention and the
               kde-vs-xla first-step logit correlation printed.
18. mesh     -- the multi-device engines on ``torch.distributed``
               (``phase_mesh``): 4 spawned ranks time-share the one card
               (each selects device 0) in a **gloo** group with a 300 s
               timeout -- NCCL refuses two ranks on one device
               (``tools/nccl_one_card_probe.py``) -- and a rank's failure
               fails the phase.  (a) ``spectral_sparsify(estimator=
               "exact", exact_blocks=True, mesh=)`` on a (4,) ("data",)
               mesh with phase 3's data and configuration: kernel_evals
               and kde_queries equal phase 3's, every rank's edge list the
               same, phase 3's edge law on rank 0's edges, per rank one
               masked-blocksum launch and one all-reduce an edge batch
               (640), the ring's 4 rowsum launches (3 exchanges, one
               all-gather), no sample-block launch; the wall, edges/s and
               the share of the wall inside the collectives (gloo stages a
               CUDA tensor through the host) -- correctness numbers, not a
               speed-up, the ranks sharing one card.  (b) on a (2, 2)
               ("pod", "data") mesh with both axes as ``data_axes``:
               ``degree_preprocessing`` within rtol 1e-3 of the exact
               degrees (4 rowsum launches a rank) and
               ``sharded_block_sums`` (one blocksum launch a rank) against
               the plain block sums.  (c) ``HashedKDE(mesh=)`` degrees on
               phase 6's data: the sum within 2% of the exact one, one
               weighted-kv-sum launch and one all-reduce a query batch.
               (d) a mesh serving tenant (n 8192, exact blocks): 3 ticks of
               2 sample + 2 prob_of requests, one all-reduce and one
               masked-blocksum launch a group, no failure.  (e) the (a)
               sparsifier at P = 1 on NCCL and on gloo, run at once: edge
               lists bitwise equal.  Rank 0 holds the first launch of each
               kernel on each path against its plain version
               (``tapped``); the counts are reported as ``mesh_launches``.
19. lm-mesh  -- the LM's sharded state (``phase_lm_mesh``): 4 gloo ranks
               on the card as in 18, a (2, 2) ("data", "model") mesh, each
               model at full width with 2 layers in f32, seed-0 weights
               drawn on the card, the state stored as each rank's shards
               (``distributed.state.shard_model``).  (a) yi-6b's sharded
               train step (batch 4 x 512, remat, flash on each rank's 16
               heads and 2 rows, AdamW lr 1e-5) held by rank 0 to the
               unsharded port step on the same card: loss and grad norm
               (rtol 1e-4), every gradient leaf (1e-3 of its max |g|),
               the parameters after 2 steps (2 lr steps); each rank's
               parameter + AdamW bytes, flash launches a step (2 L), the
               wall and its share inside the collective wrapper.  (b) the
               long_500k cell: a 524,288-slot bf16 cache, kv heads over
               "model" and the sequence over "data", seeded synthetic K/V
               below the last 64 slots, a 56-token prefill into the cache
               (one decode_step call; xla attention combined across the
               sequence slices) then 8 decode steps through the shard_map
               KDE decode, against the single-device steps (the fused
               kernel; logits 1e-3 of max |logit|); per decode step one lse
               all-gather and four reductions a layer.  (c) granite-moe-1b-a400m by expert
               parallelism: the forward's logits (atol 1e-4) and aux
               (1e-4), a train step's gradients (atol 2e-3) and metrics.
               (d) ``compressed_psum`` over the "pod" axis of a (2, 2)
               ("pod", "data") mesh, bitwise the plain sum of the codes at
               the larger scale, residuals bitwise.  (e) (a) at P = 1 on
               NCCL against the unsharded step: bitwise, or what differs.
               (f) context-parallel prefill: qwen2.5-14b (40 / 8 heads,
               the config seq mode is for; 2 of 48 layers, full width,
               f32) on a (1, 4) mesh, a flash prefill of batch 1 x 2048
               with ``seq_mode=True`` (rank r's 512 queries at offset
               512 r, weights gathered a layer at a time, keys and values
               gathered) and with ``seq_mode=False`` (tensor-parallel):
               each held by rank 0 to the unsharded prefill (last
               position and whole forward within 1e-3 of max |logit|,
               argmax equal), each rank's first flash launch tapped and
               held to the plain version at its offset; the walls, the
               share inside the collective wrapper, collectives and
               bytes, each rank's peak memory and its flash device ms
               beside the bound.  (g) (a)'s train step with the sequence
               split over "model" (``seq_mode=True``) on (a)'s mesh,
               batch and weights: gradients leaf by leaf, loss and grad
               norm against the unsharded step.  Flash is held to its
               plain version at each rank's shapes first; the launches
               are ``lm_mesh_launches``.
20. paper   -- the paper's Section 7 experiments through the public
               entry points (``phase_paper``).  (a) Figure 4: nested (n =
               5000, gaussian at bandwidth 0.3, 2.5% of the n (n - 1) / 2
               edges) and rings (n = 2500, 0.25 x the median bandwidth,
               3.3%), ``spectral_sparsify(estimator="exact",
               exact_blocks=True, seed=0)``: num_edges, kernel_evals and
               kde_queries equal the reference's (``PAPER_REF``, from
               ``tools/paper_reference.py``), the cluster accuracy at most
               0.03 below the reference's, the size reduction, the
               sparsifier's wall and ``laplacian_eigenvectors``' against
               the same subspace iteration on the dense K on the card.
               (b) Figure 3: mnist_like and glove_like at n = 2500,
               laplacian at the median L1 bandwidth, ranks 5 / 10 / 20 /
               40, ``fkv_lowrank(estimator="rs", num_rows=25 r)``:
               kernel_evals the reference's, the relative Frobenius error
               within 1.5x a 10-step subspace iteration's (the countsketch
               sketch's printed beside it), the evaluation reduction.  (c)
               Each kernel's first call on each path held to its plain
               version on the path's own inputs; the launches are
               ``paper_launches``.
21. report  -- a ``{"kernels": [...]}`` line (each row with its launches on
               the graph phase's paths, ``graph_launches``, on the
               streaming and estimator paths, ``stream_launches``, on the
               serve paths, ``serve_launches``, on the mesh paths (per
               rank), ``mesh_launches``, on the lm-mesh paths,
               ``lm_mesh_launches``, on the paper's, ``paper_launches``,
               the two flash rows on
               the training paths, ``train_launches``, and the f32 flash
               and kde_decode rows on the family phase's, by arch,
               ``family_launches``, with their device ms at each family's
               shape beside its bound, ``family_shapes``; the bf16 flash
               row with ``max_bf16_steps`` from its plain version), the
               card line from nvidia-smi, and a last line ``{"ok": true,
               "device": ...}``.

Phase 2 also holds the two LM kernels against their plain versions
(``phase_lm_kernels``): flash at the reference's ragged sweep and (5, 37),
at head dims that take the scalar-staged instance (30, 7) and on k / v
rows off 16-byte alignment, f32 and bf16 operands, and at the prefill
shape (1, 32, 8192, 128) with 4 kv-heads in f32 and in bf16 (the
lm-bf16 prefill's row); at explicit query offsets (``flash_at``, a
sequence shard's rows: ``flash_offset_checks``) over 4 shards of 777
and of 1024 rows (40 / 8 heads, dh 128), f32 and bf16, each offset's
device ms at the 1024-row shard beside its bound (``cp_offsets`` on the
flash rows); printing the kernel instance and body each check
ran (FMA f32, or the tensor-core bf16 body: mma.sync with p split into
bf16 hi + lo) and, for bf16, its ``max_bf16_steps``; the
fused KDE decode kernel (out and its step-1 estimates) against its plain
pipeline and ``block_lse_plain`` at the serve shape over kv_valid 1, 31,
32, 33, 527, 544, at S = 32768, bk 256, stride 16, top_p 16 (random and
bench_attention's planted keys) and at a 131072-key cache at the serve
settings; its bf16 instance (q, k, v in bf16) at the serve shape, at S =
32768 and at the long_500k shape, each bitwise the f32 instance on the
upcast inputs (out rounded to bf16, est equal) and against the plain
pipeline (est at rtol 2e-4 / atol 1e-5, out within one bf16 step); and
both kernels at the family phase's shapes (``family_kernel_checks``: flash
f32 / bf16 at (4, hq, hkv, 512, 512, dh) and the decode kernel at (4, hq,
hkv, 544, dh) over kv_valid 1 / 399 / 527 / 544, for head dim 112 at group
1, group 7, group 16 at head dim 128, 16 / 16 and 16 / 8 heads).  The
decode plan picks a kernel by shape (``kernel.decode_grid``): the cluster
kernel at the serve shape (16 (batch, kv-head) groups: 128 CTAs), the
spread kernel (every SM: 132 CTAs on the H100) at batch 1; each bf16 row
prints its plan and the other kernel's device time on the same inputs.
Times
the kernels (``ms``: CUDA events around back-to-back calls, host cost
included; ``device_ms``: torch.profiler's kernel durations), their plain
versions and, for flash, ``scaled_dot_product_attention(is_causal=True,
enable_gqa=True)`` in the operands' dtype as the yardstick.

Launch counters are set to 0 just before phase 3 and read just after
phase 5, set to 0 again just before phase 6 and read just after its
sparsifier returns, again around phase 7's sparsifier and each of phase
5's rs and stratified runs, around phase 8's sweep (b), exact path (c) and
hashed path (d), around the flash prefill of phase 10, the kde serve run
of phase 11, the bf16 flash prefill of phase 12 (a) (two calls, 64
launches, the row takes one call's) and its long_500k decode (b), so the
comparisons and timings of phase 2 and of (a) and the checks do not
count.  The bf16 rows take their launches from phase 12.  Each kernel's ``launches`` is its count
from the run of its own path (the bf16 rows: rowsum_bf16 from (b),
blocksum, masked_blocksum and sample_block from (c), the kde_hash pair
from (d)).  Phase 9 sets every counter to 0 just before each walk,
triangle batch and application call it counts, reads them just after, and
reports them under ``graph_launches`` by path; phases 13 and 14 do the same
around each streaming and estimator path (build, batches, reads, the
reads after a journal gap) and report them under ``stream_launches``, and
every f32 KDE kernel and both bf16 weighted kernels must have been
launched there; phase 15 does the same around each timed serving tick and
CLI run (``serve_launches``); phase 16 around each loss-and-gradient
call and each run of train steps (``train_launches``); phase 17 around
each family's flash prefill and kde serve run (``family_launches``);
every rank of phase 18 around each of its paths (``mesh_launches``);
phase 19 around its train steps, the single-device decode, (f)'s
timed prefills and (g)'s train step (``lm_mesh_launches``); phase 20
around each sparsifier and each ``fkv_lowrank`` call
(``paper_launches``).

``bound_ms`` is the least time the card could take for a kernel's work at
its main-path shape: the larger of (bytes of every input read once and
every output written once) / 3.35 TB/s and (FP32 operations) / 67 TFLOP/s
(H100 SXM data sheet, non-tensor f32).  Operations are counted per
(query, dataset row) pair: 2d + 6 for the L2 kinds (d FMAs of the cross
term, the distance assembly, the scale, exp and the accumulate) and
3d + 3 for the laplacian (subtract, |.|, add per coordinate; scale, exp,
accumulate); the kde_hash kernels add one multiply by the weight per
pair and read each distinct gathered row of x once (x is 16 MB and stays
in the 50 MB L2).  Flash counts the causal half, 4 b hq dh s^2 / 2 FP32
operations (QK^T and PV), against q, k, v, out and lse (at a shard's
offset ``flash_cp_bound``: its causal pairs, and the keys the mask
leaves); the KDE decode
kernel's work depends on the run's data (kv_valid and the selection): it
reads the strided keys below kv_valid once per kv-head, less those of the
selected blocks (they are read as gathered keys), and the gathered keys and
values below kv_valid, with q and out, each at its dtype's size (2 bytes
in bf16); 2 dh + 4 operations per (q-head, strided key below kv_valid)
and 4 dh + 4 per (q-head, selected key below kv_valid) -- counted from the
plain pipeline's selection on the same inputs (``decode_bound``).  The
bf16 flash row counts its operations on bf16 operands at the tensor
cores' 989 TFLOP/s, its bytes at 2 a value.  The bf16 rows count the same operations as the f32
ones (f32 FMAs on the rounded values) and the same f32 operand bytes, plus
the 256 KB exp table for the gaussian kind they run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

RTOL, ATOL = 2e-4, 1e-5
TIE = 1e-5
# H100 SXM, FP32 outside the tensor cores (NVIDIA's data sheet; no field
# of roofline.analysis.ChipSpec, whose peak is the bf16 tensor-core rate)
PEAK_FLOPS = 67e12
SP_N, SP_D, SP_BW = 65536, 16, 1.0
NS_FRONTIER = 4096
LRA_N, LRA_D, LRA_RANK, LRA_ROWS = 16384, 784, 20, 500
LRA_FACTOR = 1.5            # FKV error <= 1.5x the subspace-iteration error
MASS_RTOL = 1e-3            # |sum w - total/2| / (total/2)
CHI2_Z = 3.0902             # normal quantile of alpha = 1e-3
PIT_BINS = 100
BATCH = 1024
HS_N, HS_D, HS_BW = 262144, 16, 1.0
HS_MAX_BUCKET, HS_FAR_PER_BLOCK, HS_NUM_FAR = 128, 2, 64
HS_LAYOUT_SEED = 0 + 2 + 7919   # spectral_sparsify(seed=0)'s hashed layout
HS_DEG_RTOL = 0.02              # |sum deg_hash - sum deg_exact| / sum
# The hash kernels' outputs carry HT weights up to block_size/far_per_block
# = 256 (frontier reads) and n/num_far = 4096 (degree queries): their f32
# rounding scales with the output, so the atol is 1e-6 of the largest
# plain value (on top of rtol 2e-4).
HASH_ATOL = 1e-6
SPEC_N, SPEC_D, SPEC_SIGMA, SPEC_BW = 1024, 8, 0.35, 3.0
# 1.5x the largest spectral error of the JAX reference's
# spectral_sparsify(estimator="hash") at this config over seeds 0-4 on the
# CPU (tools/hash_spectral_bound.py: 0.04874407935336533).
SPEC_BOUND = 0.073116119030048
# The reference's default sparsifier (stratified reads, s rows a level-1
# block) on the hash phase's data, and 1.5x the largest spectral error of
# the JAX reference's spectral_sparsify(estimator="stratified") at the
# SPEC config over seeds 0-4 on the CPU (tools/hash_spectral_bound.py
# --estimator stratified: 0.028442029409182723).
ST_S = 16
STRAT_SPEC_BOUND = 0.042663044113774085
# Theorem 4.12 rejection on the sampler phase's frontier
EXACT_ROUNDS, EXACT_SLACK = 8, 2.0
# the bf16 policy: its six kernel entry points (launch-counter keys), the
# L2 kinds it takes, and the reference's bench_kde precision sweep
# (benchmarks/bench_kde.py _precision_scaling: ExactKDE, gaussian at
# bandwidth 4.0, d 16, m 64)
BF16_NAMES = ("rowsum_bf16", "blocksum_bf16", "masked_blocksum_bf16",
              "sample_block_bf16", "weighted_kv_sum_bf16", "weighted_kv_bf16")
L2_KINDS = ("gaussian", "exponential", "rational_quadratic")
SWEEP_N = (65536, 262144, 524288, 1048576)
SWEEP_D, SWEEP_M, SWEEP_BW = 16, 64, 4.0
# the LRA's sub-linear row norms: rs reads ceil(1/(tau eps^2)) = 80 rows a
# query (tau 0.05, eps 0.5); stratified reads s = 16 of each 256-row block
RS_SAMPLES = 80
LRA_NB = -(-LRA_N // 256)     # StratifiedKDE's default block size
LM_ARCH = "yi_6b"
# the reference's prefill_32k shape (seq 32768, batch 32), cut to 8192 x 1
LM_PREFILL_SEQ, LM_PREFILL_BATCH = 8192, 1
LM_SERVE_ARGS = ["--batch", "4", "--prompt-len", "512", "--gen", "16"]
LM_LOGIT_REL = 1e-3         # max |diff| <= 1e-3 max |logit|, same argmax
LM_KDE_LAYERS = (0, 15, 31)
# (b, hq, hkv, sq, skv, dh): the reference's flash sweep and (5, 37)
FLASH_RAGGED = [(2, 4, 2, 64, 64, 32), (1, 8, 2, 1, 300, 64),
                (2, 4, 4, 100, 228, 16), (1, 2, 1, 17, 17, 8),
                (1, 2, 1, 5, 37, 16)]
# head dims that are not a multiple of 16 bytes: the scalar-staged instance
FLASH_SCALAR = [(1, 4, 2, 257, 257, 30), (1, 2, 2, 70, 70, 7)]
FLASH_MAIN = (1, 32, 4, 8192, 8192, 128)    # the prefill shape
#: flash at a sequence shard's query offset (``flash_at``): (b, hq, hkv,
#: sq, skv, dh), the queries of shard r of skv / sq at offset r sq -- a
#: ragged shard of 777 and qwen2.5-14b's rank shape at 4096 tokens on 4
FLASH_CP = ((1, 40, 8, 777, 4 * 777, 128), (1, 40, 8, 1024, 4096, 128))
# (b, hq, hkv, S, dh, bk, stride): the serve shape (yi's heads, cache 544)
# and bench_attention's production setting at yi's heads
LSE_SERVE = (4, 32, 4, 544, 128, 32, 4)
LSE_LONG = (1, 32, 4, 32768, 128, 256, 16)
# a long cache at the serve settings: 4096 blocks, 512 per CTA of a cluster
LSE_XL = (4, 32, 4, 131072, 128, 32, 4)
KDE_LONG_TOP_P = 16
# the fused KDE decode's two kernels (the plan picks one by shape)
KDE_KERNELS = ("kde_decode_kernel", "kde_spread_kernel")
# the reference's long_500k KDE decode cell (launch/dryrun.py:106-114 and
# KDE_DECODE_CFG at :40): yi-6b, batch 1, a 524,288-slot bf16 cache, top_p
# 16, bk 512, stride 16 (1,024 blocks)
LONG_S = 524288
LONG_KDE = {"top_p": 16, "bk": 512, "stride": 16}
LSE_500K = (1, 32, 4, LONG_S, 128, LONG_KDE["bk"], LONG_KDE["stride"])
# the lm-bf16 decode: 32 teacher-forced prompt tokens then 32 generated, in
# the last 64 slots; cache positions [0, LONG_FILL) hold seeded synthetic
# K/V (the reference cell compiles this decode and holds no contents)
LONG_PROMPT, LONG_GEN = 32, 32
LONG_FILL = LONG_S - LONG_PROMPT - LONG_GEN
KDE_SERVE_TOP_P = 4
# decode steps of the serve run around block edges, and its last step
KDE_VALID_SWEEP = (1, 31, 32, 33, 527, 544)
# the graph phase: bench_sampling's largest walk-scaling point (x ~ N(0,
# 0.5^2), numpy seed 0, gaussian at bandwidth 4.0, s = 16; 256 walkers x 4
# steps), the Markov-law check's n and walk count (tests/test_sampling.py),
# bench_graph's engine configuration (n 16384, 2048 pairs x 16 draws, 4096
# edges) and its accuracy configuration (gaussian_clusters n = 1200)
GW_N, GW_D, GW_BW, GW_S, GW_WALKERS, GW_STEPS = 1048576, 16, 4.0, 16, 256, 4
GM_N, GM_WALKS = 4096, 20000
# clustered data, sorted by label so blocks follow clusters, on which the
# law check rejects uniform endpoints and e_0 M^2 (expected chi-square
# 32,165 and 2,179 against an alpha 1e-3 point of 103.5 at df 63, where
# the N(0, 0.5^2) data give 65.1 and 63.0: tools/markov_law_power.py)
GM_CLUSTERS, GM_CLUSTER_BW = dict(k=8, spread=0.3, sep=0.4), 1.0
GT_N, GT_PAIRS, GT_DRAWS, GA_EDGES = 16384, 2048, 16, 4096
ACC_N = 1200
# 1.5x the largest relative error of the JAX reference's estimators at the
# accuracy configuration over seeds 0-4 on the CPU (tools/graph_app_bounds.py:
# arboricity m=2400 0.12865036708776897, m=9600 0.02072011012285744;
# triangles 200x8 0.1926557008010198, 600x24 0.13892643496443688)
ARB_BOUND = {2400: 0.19297555063165345, 9600: 0.03108016518428616}
TRI_BOUND = {(200, 8): 0.2889835512015297, (600, 24): 0.2083896524466553}
# the CG residual of the reference's CG test (tests/test_fused_apps.py:
# 1e-4 |b| on its cloud), and on the accuracy configuration, where f32 CG
# stalls on the plateau of a two-cluster graph (the reference's own solve
# there stops at 5.88e-3 |b| on the CPU), 2e-2 |b|
CG_RTOL, CG_PLATEAU = 1e-4, 2e-2
# the streaming phase: the reference's streaming benchmark
# (benchmarks/bench_streaming.py:65-80: x ~ N(0, 0.5^2), d 8, gaussian at
# bandwidth 2.0, batches of n / 100 rows a third each insert / delete /
# update, deletes clear of the frontier rows [0, 64), a 64-row frontier,
# capacity n + batches m + 64, journal 4 x batches) scaled from n = 16,384
# to the hashed sparsifier phase's n; one warm-up batch and 4 timed, then 2
# profiled and 6 past the journal (the gap)
ST_N0, ST_D, ST_BW = 262144, 8, 2.0
ST_M = ST_N0 // 100
ST_BATCHES, ST_FRONT, ST_BS = 4, 64, 512
ST_CAP = ST_N0 + (ST_BATCHES + 1) * ST_M + 64
ST_JOURNAL = 4 * ST_BATCHES
ST_EDGES = 4096
# patched against fresh state: the reference streaming test's tolerances
# (tests/test_streaming.py: prob_of :132, degrees :157)
ST_PROB_TOL = dict(rtol=2e-5, atol=1e-7)
ST_DEG_TOL = dict(rtol=5e-4, atol=5e-5)
# the estimators phase: GridHBE as tests/test_kde.py:59-70 runs it (128
# FAR samples, mean relative error under 0.15), on phase 3's data; the
# robust chain on phase 6's data; tree mode at n 4096, leaf 32
HBE_QUERIES, HBE_FAR, HBE_REL = 256, 128, 0.15
ROBUST_CLEAN, ROBUST_PLANTED = 1024, 64
TREE_N, TREE_D, TREE_LEAF, TREE_SRC, TREE_DRAWS = 4096, 16, 32, 256, 4
# hash cells narrow enough that no bucket of the streaming data is
# truncated: the patched layout's bitwise contract with a fresh build
PARITY_CELL = 0.5
# the serving phase: (a) bench_serve.py's plan (n 1024, d 8, 4 tenants, 32
# mixed requests a tick, 16 timed ticks, blocks of 32); (b) 4 exact tenants
# of phase 3's data shape (blocks of 256, 8 ticks of the same mix); (c) the
# CLI's graph-stream mode at the streaming phase's n
SV_N, SV_D, SV_BW, SV_S, SV_R, SV_TICKS, SV_BS = 1024, 8, 1.0, 4, 32, 16, 32
SV_SAMPLE_W, SV_QUERY_Q, SV_WALK_W, SV_WALK_LEN = 16, 8, 8, 4
SVB_N, SVB_D, SVB_BS, SVB_TICKS = 65536, 16, 256, 8
SV_STREAM_N = 262144


# phase 16: granite-3-2b trained at full width and depth on one batch of
# 4096 tokens (the reference's train_4k shape, 4096 x 256, cut in batch)
TRAIN_ARCH = "granite_3_2b"
TRAIN_SEQ, TRAIN_BATCH = 4096, 1
TRAIN_STEPS = 4
# peak lr of the reference's AdamWConfig (warmup 100 steps): 1e-7 a
# parameter at step 1, rising by 1e-7 a step.  Adam's first steps move
# every parameter by about lr, and 2.5 B of them at 3e-6 a step already
# overshoot this batch's minimum by step 2 (PERF.md §6, training)
TRAIN_LR = 1e-5
TRAIN_GRAD_LAYERS = (0, 19, 39)
TRAIN_LOSS_RTOL = 1e-5       # flash vs xla loss on the same weights
TRAIN_GNORM_RTOL = 1e-4      # flash vs xla global gradient norm
TRAIN_GRAD_REL = 1e-3        # a layer's wq/wk/wv/wo grads: max |diff| <=
#                              1e-3 max |xla grad| (the prefill's rule)
TRAIN_BF16_REL = 1e-2        # bf16 step-1 loss vs the f32 loss, relative
TRAIN_CLI = ["--arch", "granite_3_2b", "--reduced", "--steps", "6",
             "--ckpt-every", "2", "--log-every", "1"]
# phase 17: the non-dense families served at full width (qwen3-moe cut to
# its first 4 of 94 layers: 45 GB of f32 weights), one at a time, each at
# the lm-serve shape (batch 4, prompt 512, gen 16; the frontend configs
# split the 512 into 128 embeddings and 384 tokens).  Since the lm-mesh
# phase joined, two of the slowest families run at a cut depth too, so the
# script stays near 1000 s on a slow host: granite-moe 12 of 24 layers,
# rwkv6 16 of 32.  zamba2 keeps its 81: cut to 27 its random-weight
# prefill's flash-vs-xla gap passes the 1e-3 gate (1.32e-3 of max |logit|)
FAMILY_ARCHS = ("granite_moe_1b_a400m", "qwen3_moe_235b_a22b", "rwkv6_3b",
                "zamba2_7b", "seamless_m4t_medium", "internvl2_1b")
FAMILY_CUTS = {"qwen3_moe_235b_a22b": {"num_layers": 4},
               "granite_moe_1b_a400m": {"num_layers": 12},
               "rwkv6_3b": {"num_layers": 16}}
# flash launches of one prefill = the causal self-attention layers (the
# hybrid's 14 shared-block applications; none in rwkv6)
FAMILY_FLASH = {"granite_moe_1b_a400m": 12, "qwen3_moe_235b_a22b": 4,
                "rwkv6_3b": 0, "zamba2_7b": 14, "seamless_m4t_medium": 12,
                "internvl2_1b": 24}
FAMILY_FLIP_SHARE = 0.01    # MoE: top-k sets differing flash vs xla, at most
# the serve runs' prompt cut from lm-serve's 512 to 256 (the frontend
# configs: 64 embeddings + 192 tokens): the teacher-forced replay is
# host-bound, 2-4 ms a layer a step, and at 512 the phase took ~7 minutes
FAMILY_SERVE_ARGS = ["--batch", "4", "--prompt-len", "256", "--gen", "16"]


def log(*a):
    print(*a, flush=True)


def timed(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up, by CUDA
    events around the whole run."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Mean host microseconds per call of ``fn`` over ``reps`` calls after
    one warm-up: the host clock around the calls only, so a wrapper's
    Python and launch cost, not the card's time."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def close(got, want, what: str, atol: float = ATOL,
          rtol: float = RTOL, slack=0.0) -> float:
    """Assert |got - want| <= atol + rtol |want| + slack everywhere; return
    the max abs error.  ``slack`` (the bf16 kernels' flip slack of the
    pairs behind each output, ``flip_slack``) is 0 for the f32 kernels."""
    import torch
    got, want = got.double(), want.double()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs() + slack
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} values outside rtol {rtol} / atol "
        f"{atol:.3e}{' + flip slack' if torch.is_tensor(slack) else ''} "
        f"(max abs err {float(err.max()):.3e})")
    assert bool(torch.isfinite(got).all()), f"{what}: non-finite values"
    return float(err.max())


def check_blk(blk, bs_plain, gumbel, what: str, widen=0.0) -> None:
    """Drawn blocks equal the plain argmax except on near-tie rows: top two
    scores within TIE (+ ``widen``, a row's score slack in bf16)."""
    import torch
    score = torch.log(bs_plain) + gumbel
    top2 = torch.topk(score, min(2, score.shape[1]), dim=1).values
    tie = (top2[:, 0] - top2[:, -1]).double() <= TIE + widen \
        if score.shape[1] > 1 else \
        torch.zeros(score.shape[0], dtype=torch.bool, device=score.device)
    want = torch.argmax(score, dim=1)
    bad = (blk != want) & ~tie
    assert not bool(bad.any()), f"{what}: {int(bad.sum())} drawn blocks differ"


def sample_block_err(got, want, g, what: str) -> float:
    """The sample-block kernel's (blk, p, tot, bs) against the plain
    version's on Gumbel noise ``g``: the draws by ``check_blk``, the sums,
    totals and p at rtol / atol; returns the max abs error."""
    import torch
    check_blk(got[0], want[3], g, what)
    pb = torch.gather(want[3], 1, got[0][:, None])[:, 0] / want[2]
    return max(close(got[3], want[3], what),
               close(got[2], want[2], f"{what} tot"),
               close(got[1], pb, f"{what} p"))


def bound(flops: float, nbytes: float, bf16_flops: float = 0.0):
    """(bound_ms, bound_by) of a kernel call: ``flops`` f32 operations at
    the FP32 rate plus ``bf16_flops`` operations on bf16 operands at the
    tensor cores' rate (``roofline.analysis.H100.peak_flops``), against
    ``nbytes`` at the HBM rate (``H100.hbm_bw``)."""
    from repro_torch.roofline.analysis import H100
    t_ops = (flops / PEAK_FLOPS + bf16_flops / H100.peak_flops) * 1e3
    t_bytes = nbytes / H100.hbm_bw * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pair_ops(kind: str, d: int) -> int:
    return 3 * d + 3 if kind == "laplacian" else 2 * d + 6


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    log(f"[build] {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.BUILD_SECONDS:.2f} s; library {build.source_hash()})")
    for line in build.BUILD_LOG.splitlines():
        if "Compiling entry function" in line or "registers" in line \
                or "spill" in line:
            log("[build]", line.strip())
    return sass_dump(build)


def sass_dump(build):
    """Start dumping the built library's SASS (``cuobjdump --dump-sass``,
    filtered by ``grep`` to the function headers and ``HMMA`` lines) for
    ``sass_check``, which ``main`` calls after phase 2: the dump runs
    beside the tuning and kernel phases (inline, with its parse, it was
    part of the build phase's ~35 s past nvcc on the card).  Returns the
    two processes and grep's output file."""
    import atexit
    import tempfile
    tool = Path(build._nvcc()).with_name("cuobjdump")
    lib = build.BUILD_ROOT / build.source_hash() / "libkde.so"
    out = tempfile.TemporaryFile(mode="w+")     # a pipe would fill and stall
    dump = subprocess.Popen([str(tool), "--dump-sass", str(lib)],
                            stdout=subprocess.PIPE)
    grep = subprocess.Popen(["grep", "-E", "Function : |HMMA"],
                            stdin=dump.stdout, stdout=out)
    dump.stdout.close()       # grep alone reads the pipe
    # a phase that fails before sass_check leaves no process behind
    atexit.register(lambda: [p.kill() for p in (dump, grep)
                             if p.poll() is None])
    return dump, grep, out


def sass_check(procs) -> None:
    """The built library's SASS (``sass_dump``'s processes): every bf16
    instance of the flash kernel (``flash_mma_kernel``) and of the KDE
    tensor-core tile (``sampler_mma_kernel`` and ``blocksum_mma_kernel``,
    the bf16 kinds 4-6) contains tensor-core ``HMMA`` instructions, and no
    f32 flash instance (``flash_fwd_kernel``) and no other sampler or
    rowsum tile (the wide, deep and generic tiles, every f32 kind among
    them) does; the wide tiles are built for the f32 kinds 0-3 only."""
    import re
    from repro_torch.kernels.flash_attention import kernel as fk
    import torch
    dump, grep, out = procs
    codes = dump.wait(timeout=300), grep.wait(timeout=300)
    assert codes == (0, 0), ("cuobjdump | grep failed", codes)
    out.seek(0)
    sass = out.read()
    out.close()
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur is not None and "HMMA" in line:
            counts[cur] += 1
    for dtype, (body, name) in fk.BODIES.items():
        hits = {f: c for f, c in counts.items() if name in f}
        assert hits, f"no {name} in the library's SASS"
        tensor = dtype == torch.bfloat16
        assert all((c > 0) == tensor for c in hits.values()), (name, hits)
        log(f"[build] SASS of {name} ({body}): HMMA instructions per "
            f"instance {sorted(hits.values())}")

    def named(*names):
        return {f: c for f, c in counts.items()
                if any(f"{n}I" in f for n in names)}

    # (mma kernel, instances: 3 bf16 kinds x 2 DK [x 2 DRAW]; the other
    # tiles of its source: {name: instances}, wide ones of kinds 0-3 only;
    # the f32 kinds' wide, deep and generic tiles twice: with and without
    # the tenant axis)
    for mma_name, n_mma, others in (
            ("sampler_mma_kernel", 12,
             # <KIND, DK, DRAW, TENANT> for the 4 f32 kinds x 2 x 2 x 2;
             # <KIND, DRAW, TENANT> for all 7 kinds x 2, the f32 ones x 2
             {"sampler_wide_kernel": 32, "sampler_generic_kernel": 22}),
            ("blocksum_mma_kernel", 6,
             # <KIND, DK, TENANT> for the 4 f32 kinds x 2 x 2; <KIND,
             # TENANT> for all 7 kinds, the f32 ones x 2
             {"blocksum_wide_kernel": 16, "blocksum_deep_kernel": 11,
              "blocksum_kernel": 11})):
        mma = named(mma_name)
        assert len(mma) == n_mma and all(c > 0 for c in mma.values()), mma
        assert all(re.search(r"mma_kernelILi[456]E", f) for f in mma), mma
        other = named(*others)
        for name, n in others.items():
            got = named(name)
            assert len(got) == n, (name, sorted(got))
            if "wide" in name:
                assert all(re.search(r"wide_kernelILi[0-3]E", f)
                           for f in got), got
        assert not any(other.values()), other
        log(f"[build] SASS of {mma_name}: HMMA instructions per instance "
            f"{sorted(mma.values())}; its source's {len(other)} wide / deep "
            f"/ generic instances (the f32 kinds' among them): none")


def phase_tuning():
    """Phase 1b: the card against ``kernels/tuning.py``.  ``tuning.limits``
    (torch's device properties, the rest through ``cudaDeviceGetAttribute``)
    equals every field as ``cudaDeviceGetAttribute`` reports it, and each
    plan's CTA count (``tuning.PLAN_FAMILIES``) is the same on the card's
    figures as on ``H100_SXM``'s.  For every ``RESOURCES`` instance, what
    ``kde_func_attributes`` reports (block size, registers, static and
    dynamic shared memory, local memory) equals the table, and its CTAs an
    SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) equal
    ``tuning.ctas_per_sm``'s.  When this process built the library, the
    ptxas lines name exactly the table's instances, with its registers,
    shared memory, stack frames and spills (held to the table, not to 0:
    25 instances spill)."""
    import shutil
    import torch
    from repro_torch.kernels import build, tuning
    dev = torch.device("cuda", 0)
    lim = tuning.limits(dev)
    card = {f: tuning.device_attribute(f, dev) for f in tuning.DEVICE_FIELDS}
    props = torch.cuda.get_device_properties(dev)
    log(f"[tuning] limits {lim}; from torch: "
        f"{[f for f, a in tuning.TORCH_FIELDS.items() if hasattr(props, a)]}")
    assert all(getattr(lim, f) == v for f, v in card.items()), (lim, card)
    plans = {w: tuning.plan_ctas(w, lim) for w in tuning.PLAN_FAMILIES}
    log(f"[tuning] plan CTAs an SM on the card {plans}")
    assert all(getattr(tuning, w) == c for w, c in plans.items()), plans
    ptx = None
    if build.BUILD_LOG:
        tool = shutil.which("c++filt") or str(
            Path(build._nvcc()).with_name("cu++filt"))

        def demangle(names):
            return subprocess.run([tool], input="\n".join(names), check=True,
                                  capture_output=True, text=True,
                                  timeout=60).stdout.splitlines()
        ptx = tuning.ptxas_resources(build.BUILD_LOG, demangle)
    else:
        log("[tuning] the library was built before this process: no ptxas "
            "lines to hold to the table")
    bad = [] if ptx is None else sorted(set(ptx) ^ set(tuning.RESOURCES))
    for name, r in tuning.RESOURCES.items():
        got = tuning.card_resources(name, dev)
        ctas = tuning.resource_ctas(name, lim)
        if (got.threads, got.regs, got.static, got.smem, got.local,
                got.ctas) != (r.threads, r.regs, r.static, r.smem, r.stack,
                              ctas) or got.max_threads < r.threads:
            bad.append((name, got, r, ctas))
        if ptx is not None and ptx.get(name) != (
                r.regs, r.static, r.stack, r.spill_stores, r.spill_loads):
            bad.append((name, "ptxas", ptx.get(name), r))
        spill = (f" spills {r.spill_stores} / {r.spill_loads} B"
                 if r.spill_stores or r.spill_loads else "")
        log(f"[tuning] {name} regs {got.regs} smem {got.static + got.smem} "
            f"B ctas/SM {got.ctas}{spill}")
    assert not bad, bad
    log(f"[tuning] {len(tuning.RESOURCES)} instances equal the table on the "
        f"card ({sum(1 for r in tuning.RESOURCES.values() if r.spill_stores)}"
        f" spill as the table says)")


def phase_kernels(data, gen):
    """Phase 2: every kernel against its plain version; returns the
    report rows (launches filled in after the main path)."""
    import numpy as np
    import torch
    from repro_torch.kernels.kde_rowsum import kernel as rk
    from repro_torch.kernels.kde_sampler import kernel as sk
    from repro_torch.kernels.kde_sampler.ops import gumbel
    dev = torch.device("cuda")
    errs = {k: 0.0 for k in ("rowsum", "blocksum", "masked_blocksum",
                             "sample_block")}

    def check_all(q, x, own, g, kind, inv_bw, beta, bn, tag):
        e = errs
        e["rowsum"] = max(e["rowsum"], close(
            rk.rowsum_cuda(q, x, kind, inv_bw, beta),
            rk.rowsum_plain(q, x, kind, inv_bw, beta), f"rowsum {tag}"))
        e["blocksum"] = max(e["blocksum"], close(
            rk.blocksum_cuda(q, x, kind, inv_bw, beta, bn),
            rk.blocksum_plain(q, x, kind, inv_bw, beta, bn),
            f"blocksum {tag}"))
        e["masked_blocksum"] = max(e["masked_blocksum"], close(
            sk.masked_blocksum_cuda(q, x, own, kind, inv_bw, beta, bn),
            sk.masked_blocksum_plain(q, x, own, kind, inv_bw, beta, bn),
            f"masked_blocksum {tag}"))
        got = sk.sample_block_cuda(q, x, own, g, kind, inv_bw, beta, bn)
        want = sk.sample_block_plain(q, x, own, g, kind, inv_bw, beta, bn)
        check_blk(got[0], want[3], g, f"sample_block {tag}")
        e["sample_block"] = max(
            e["sample_block"],
            close(got[3], want[3], f"sample_block sums {tag}"),
            close(got[2], want[2], f"sample_block tot {tag}"))
        # p_blk against the plain sums at the kernel's own draw
        pb = torch.gather(want[3], 1, got[0][:, None])[:, 0] / want[2]
        e["sample_block"] = max(e["sample_block"],
                                close(got[1], pb, f"sample_block p {tag}"))

    def misaligned(a):              # a contiguous copy 4 bytes past 16
        view = torch.empty(a.numel() + 1, device=dev)[1:]
        return view.view(a.shape).copy_(a)

    # ragged shapes, every kind (d = 19: every kernel's generic tile; d =
    # 8, 32: the wide tile padded to 16 and 32; d = 36, 784: rowsum's and
    # blocksum's deep tile, the sampler kernels' generic one; views off 16
    # bytes: the generic tile of every kernel)
    for kind, d, view in [("gaussian", 19, False), ("exponential", 19, False),
                          ("rational_quadratic", 19, False),
                          ("laplacian", 19, False), ("laplacian", 784, False),
                          ("exponential", 8, False),
                          ("rational_quadratic", 32, False),
                          ("gaussian", 36, False), ("laplacian", 36, False),
                          ("gaussian", 16, True), ("laplacian", 784, True),
                          # the paper phase's widths: nested (2) and rings
                          # (3) on the generic tile, glove_like (200) on
                          # rowsum's and blocksum's deep one
                          ("gaussian", 2, False), ("laplacian", 2, False),
                          ("gaussian", 3, False), ("exponential", 3, False),
                          ("gaussian", 200, False),
                          ("laplacian", 200, False)]:
        m, n, bn = 37, 301, 70
        q = torch.randn(m, d, generator=gen, device=dev) * 0.3
        x = torch.randn(n, d, generator=gen, device=dev) * 0.3
        if view:
            q, x = misaligned(q), misaligned(x)
        inv_bw = 1.0 / (0.3 * d) if kind == "laplacian" else \
            1.0 / (0.4 * d ** 0.5)
        own = torch.randint(-1, -(-n // bn), (m,), generator=gen, device=dev)
        g = gumbel((m, -(-n // bn)), gen, dev)
        tag = f"{kind} d={d} ragged{' misaligned' if view else ''}"
        check_all(q, x, own, g, kind, inv_bw, 0.7, bn, tag)
        log(f"[kernels] {tag} m={m} n={n} bn={bn}: ok (rowsum / blocksum "
            f"tile {rk._cached_plan(q, x, kind, inv_bw, 0.7, bn)[0].instance})")

    # a rings-like input (coordinates near 100, tori of radius 5): the L2
    # expansion |q|^2 + |x|^2 - 2 q.x cancels in f32, in the kernels and
    # in their plain versions alike; every kind at phase 2's tolerances
    from repro_torch.core.kernels_fn import median_bandwidth
    from repro_torch.data.synthetic_points import rings
    xr = torch.as_tensor(rings(n=301, seed=0)[0], device=dev)
    qr = torch.as_tensor(rings(n=37, seed=1)[0], device=dev)
    for kind in ("gaussian", "exponential", "rational_quadratic",
                 "laplacian"):
        bw_r = 0.25 * median_bandwidth(xr, ord=1 if kind == "laplacian"
                                       else 2)
        own = torch.randint(-1, 5, (37,), generator=gen, device=dev)
        g = gumbel((37, 5), gen, dev)
        tag = f"{kind} d=3 rings-like (|x| ~ 100)"
        check_all(qr, xr, own, g, kind, 1.0 / bw_r, 0.7, 70, tag)
        tile = rk._cached_plan(qr, xr, kind, 1.0 / bw_r, 0.7, 70)[0]
        log(f"[kernels] {tag} m=37 n=301 bn=70 bandwidth {bw_r:.4f}: ok "
            f"(tile {tile.instance})")

    rows = []
    # main-path shapes
    xs, bw_l = data["lra_xs"], data["lra_bw"]
    q = xs[:BATCH].contiguous()
    inv = 1.0 / bw_l
    err = close(rk.rowsum_cuda(q, xs, "laplacian", inv),
                rk.rowsum_plain(q, xs, "laplacian", inv), "rowsum main")
    errs["rowsum"] = max(errs["rowsum"], err)
    m, n, d = q.shape[0], xs.shape[0], xs.shape[1]
    b_ms, b_by = bound(m * n * pair_ops("laplacian", d),
                       4 * (m * d + n * d + m))
    plan = rk._cached_plan(q, xs, "laplacian", inv, 1.0, None)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_call = launches_per_call(lambda: rk.rowsum_cuda(q, xs, "laplacian",
                                                        inv), 5)
    assert per_call == 2.0, f"rowsum: {per_call} launches a call"
    # a subtract and an add with |.| per (pair, coordinate), no packed f32
    # add: the issue floor at 128 lanes an SM and 1.98 GHz
    log(f"[kernels] rowsum main: plan {plan[0]} ({plan[1].bn} columns a "
        f"split); {per_call:.0f} device launches a call; issue floor "
        f"{2 * m * n * d / (sms * 128 * 1.98e9) * 1e3:.4f} ms")
    rows.append(dict(
        name="rowsum", route="cuda", source="src/repro_torch/csrc/kde_rowsum.cu",
        replaces="src/repro/kernels/kde_rowsum/kernel.py:137",
        shape=f"m={m} n={n} d={d} laplacian",
        ms=timed(lambda: rk.rowsum_cuda(q, xs, "laplacian", inv), 10),
        # its two kernels: the split's block sums, rowsum_reduce_kernel
        device_ms=kernel_device_ms(
            lambda: rk.rowsum_cuda(q, xs, "laplacian", inv), "", 5),
        plain_ms=timed(lambda: rk.rowsum_plain(q, xs, "laplacian", inv), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timed(lambda: torch.cdist(q, xs, p=1).mul_(-inv).exp_()
                         .sum(1), 3)))
    # the rs row norms' shape: RSKDE.query reduces a uniform subsample of
    # RS_SAMPLES rows of cX a query batch (fkv_lowrank(estimator="rs"))
    sub = xs[torch.as_tensor(np.random.default_rng(0).integers(
        0, n, RS_SAMPLES), device=dev)]
    err = close(rk.rowsum_cuda(q, sub, "laplacian", inv),
                rk.rowsum_plain(q, sub, "laplacian", inv), "rowsum rs shape")
    errs["rowsum"] = max(errs["rowsum"], err)
    rs_ms, rs_by = bound(m * RS_SAMPLES * pair_ops("laplacian", d),
                         4 * (m * d + RS_SAMPLES * d + m))
    log(f"[kernels] rowsum rs shape m={m} n={RS_SAMPLES} d={d} laplacian: "
        f"plan {rk._cached_plan(q, sub, 'laplacian', inv, 1.0, None)[0]}; "
        f"max_abs_err {err:.3e}, "
        f"{timed(lambda: rk.rowsum_cuda(q, sub, 'laplacian', inv), 20):.4f}"
        f" ms (plain "
        f"{timed(lambda: rk.rowsum_plain(q, sub, 'laplacian', inv), 5):.4f}"
        f", bound {rs_ms:.5f} by {rs_by})")

    x, bn = data["sp_x"], data["sp_bs"]
    n, d = x.shape
    nb = -(-n // bn)
    inv = 1.0 / SP_BW
    inv2 = inv * inv

    def cdist_blocks(qq):
        kv = torch.cdist(qq, x).square_().mul_(-inv2).exp_()
        return kv.view(qq.shape[0], nb, bn).sum(-1)

    q = x[:BATCH].contiguous()
    m = q.shape[0]
    errs["blocksum"] = max(errs["blocksum"], close(
        rk.blocksum_cuda(q, x, "gaussian", inv, 1.0, bn),
        rk.blocksum_plain(q, x, "gaussian", inv, 1.0, bn), "blocksum main"))
    per_call = launches_per_call(
        lambda: rk.blocksum_cuda(q, x, "gaussian", inv, 1.0, bn), 10)
    assert per_call == 1.0, f"blocksum: {per_call} launches a call"
    log(f"[kernels] blocksum main: plan "
        f"{rk._cached_plan(q, x, 'gaussian', inv, 1.0, bn)[0]}; "
        f"{per_call:.0f} device launch a call")
    b_ms, b_by = bound(m * n * pair_ops("gaussian", d),
                       4 * (m * d + n * d + m * nb))
    rows.append(dict(
        name="blocksum", route="cuda", source="src/repro_torch/csrc/kde_rowsum.cu",
        replaces="src/repro/kernels/kde_rowsum/kernel.py:169",
        shape=f"m={m} n={n} d={d} bn={bn} gaussian",
        ms=timed(lambda: rk.blocksum_cuda(q, x, "gaussian", inv, 1.0, bn), 20),
        device_ms=kernel_device_ms(
            lambda: rk.blocksum_cuda(q, x, "gaussian", inv, 1.0, bn),
            "blocksum", 20),
        plain_ms=timed(lambda: rk.blocksum_plain(q, x, "gaussian", inv, 1.0,
                                                 bn), 5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timed(lambda: cdist_blocks(q), 5)))

    src = data["ns_src"]
    q = x[src].contiguous()
    own = src // bn                 # int64, as the sampler hands it
    m = q.shape[0]
    errs["masked_blocksum"] = max(errs["masked_blocksum"], close(
        sk.masked_blocksum_cuda(q, x, own, "gaussian", inv, 1.0, bn),
        sk.masked_blocksum_plain(q, x, own, "gaussian", inv, 1.0, bn),
        "masked_blocksum main"))

    def cdist_masked():
        s = cdist_blocks(q)
        s[torch.arange(m, device=dev), own.long()] -= 1.0
        return s.clamp_(min=1e-12)

    b_ms, b_by = bound(m * n * pair_ops("gaussian", d),
                       4 * (m * d + n * d + m + m * nb))
    rows.append(dict(
        name="masked_blocksum", route="cuda",
        source="src/repro_torch/csrc/kde_sampler.cu",
        replaces="src/repro/kernels/kde_sampler/kernel.py:90",
        shape=f"m={m} n={n} d={d} bn={bn} gaussian",
        ms=timed(lambda: sk.masked_blocksum_cuda(q, x, own, "gaussian", inv,
                                                 1.0, bn), 10),
        device_ms=kernel_device_ms(lambda: sk.masked_blocksum_cuda(
            q, x, own, "gaussian", inv, 1.0, bn), "sampler_", 10),
        plain_ms=timed(lambda: sk.masked_blocksum_plain(
            q, x, own, "gaussian", inv, 1.0, bn), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=timed(cdist_masked, 3)))

    src = src[:BATCH]
    q = x[src].contiguous()
    own = src // bn                 # the edge batch's own blocks, int64
    m = q.shape[0]
    g = gumbel((m, nb), gen, dev)
    plan = sk.sample_block_plan(
        m, n, d, bn, sms=torch.cuda.get_device_properties(dev)
        .multi_processor_count)
    got = sk.sample_block_cuda(q, x, own, g, "gaussian", inv, 1.0, bn)
    want = sk.sample_block_plain(q, x, own, g, "gaussian", inv, 1.0, bn)
    assert got[0].dtype == torch.int64, got[0].dtype
    errs["sample_block"] = max(errs["sample_block"], sample_block_err(
        got, want, g, "sample_block main"))
    got32 = sk.sample_block_cuda(q, x, own.to(torch.int32), g, "gaussian",
                                 inv, 1.0, bn)
    assert all(torch.equal(a, b) for a, b in zip(got32, got)), \
        "sample_block: int32 and int64 own differ"
    per_call = launches_per_call(
        lambda: sk.sample_block_cuda(q, x, own, g, "gaussian", inv, 1.0, bn),
        10)
    assert per_call == 1.0, f"sample_block: {per_call} launches a call"
    log(f"[kernels] sample_block main: plan {plan}; {per_call:.0f} device "
        f"launch a call (torch.profiler); int32 and int64 own agree")
    sample_block_draw_checks(x, bn, gen)
    b_ms, b_by = bound(m * n * pair_ops("gaussian", d) + 3 * m * nb,
                       4 * (m * d + n * d + m + 2 * m * nb + 3 * m))
    rows.append(dict(
        name="sample_block", route="cuda",
        source="src/repro_torch/csrc/kde_sampler.cu",
        replaces="src/repro/kernels/kde_sampler/kernel.py:129",
        shape=f"m={m} n={n} d={d} bn={bn} gaussian",
        ms=timed(lambda: sk.sample_block_cuda(q, x, own, g, "gaussian", inv,
                                              1.0, bn), 20),
        device_ms=kernel_device_ms(lambda: sk.sample_block_cuda(
            q, x, own, g, "gaussian", inv, 1.0, bn), "sampler_", 20),
        host_us=host_us(lambda: sk.sample_block_cuda(
            q, x, own, g, "gaussian", inv, 1.0, bn), 200),
        plain_ms=timed(lambda: sk.sample_block_plain(
            q, x, own, g, "gaussian", inv, 1.0, bn), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    for r in rows:
        r["max_abs_err"] = errs[r["name"]]
        log_row(r)
    return rows


def f32_counts(*counters):
    """The f32 kernels' launch counts of the given ``LAUNCHES`` dicts (the
    bf16 instances count under ``<name>_bf16``)."""
    return {k: v for c in counters for k, v in c.items()
            if not k.endswith("_bf16")}


def log_row(r) -> None:
    host = f", host {r['host_us']:.2f} us a call" if "host_us" in r else ""
    log(f"[kernels] {r['name']} main {r['shape']}: max_abs_err "
        f"{r['max_abs_err']:.3e}, {r['ms']:.4f} ms (device "
        f"{r.get('device_ms')}{host}, plain {r['plain_ms']:.4f}, library "
        f"{r['library_ms']}, bound {r['bound_ms']:.5f} by {r['bound_by']})")


def sample_block_draw_checks(x, bn, gen):
    """The fused draw of the sample-block kernel on the card: (1) planted
    exact ties at the main shape's n, d and bn go to the lower block on
    every row, every kind; (2) calls of several row counts in a row, each
    with fresh noise, match the plain version, so every launch leaves its
    tiles' arrival counters at 0."""
    import torch
    from repro_torch.kernels.kde_sampler import kernel as sk
    from repro_torch.kernels.kde_sampler.ops import gumbel
    dev = x.device
    n, d = x.shape
    nb = -(-n // bn)
    lo, hi = 1, nb - 2
    # dyadic coordinates: every distance is exact in f32 in any order, so
    # block hi (a copy of block lo) has bitwise equal sums
    xt = torch.randint(-4, 5, (n, d), generator=gen, device=dev) / 8.0
    xt[hi * bn:(hi + 1) * bn] = xt[lo * bn:(lo + 1) * bn]
    qt = torch.randint(-4, 5, (BATCH, d), generator=gen, device=dev) / 8.0
    own = torch.randint(-1, nb, (BATCH,), generator=gen, device=dev)
    own[(own == lo) | (own == hi)] = -1
    g = gumbel((BATCH, nb), gen, dev)
    g[:, lo] = g[:, hi] = 30.0
    for kind in ("gaussian", "exponential", "rational_quadratic",
                 "laplacian"):
        inv = 1.0 / (0.25 * d) if kind == "laplacian" else \
            1.0 / (0.5 * d ** 0.5)
        blk, _, tot, bs = sk.sample_block_cuda(qt, xt, own, g, kind, inv,
                                               0.7, bn)
        assert torch.equal(bs[:, lo], bs[:, hi]), f"tie sums differ {kind}"
        assert bool((blk == lo).all()), (
            f"sample_block ties {kind}: {int((blk != lo).sum())} rows did "
            f"not take the lower block")
        want = sk.sample_block_plain(qt, xt, own, g, kind, inv, 0.7, bn)
        close(bs, want[3], f"sample_block ties sums {kind}")
        close(tot, want[2], f"sample_block ties tot {kind}")
    log(f"[kernels] sample_block planted ties (blocks {lo} and {hi} equal, "
        f"equal Gumbel noise, {BATCH} rows, every kind): the lower block "
        f"on every row")
    ms = (BATCH, 37, 300, 1, BATCH, 129, 4096, BATCH)
    for m in ms:
        q = x[torch.randint(0, n, (m,), generator=gen, device=dev)]
        own = torch.randint(-1, nb, (m,), generator=gen, device=dev)
        g = gumbel((m, nb), gen, dev)
        got = sk.sample_block_cuda(q, x, own, g, "gaussian", 1.0 / SP_BW,
                                   1.0, bn)
        want = sk.sample_block_plain(q, x, own, g, "gaussian", 1.0 / SP_BW,
                                     1.0, bn)
        check_blk(got[0], want[3], g, f"sample_block repeated m={m}")
        close(got[3], want[3], f"sample_block repeated sums m={m}")
        pb = torch.gather(want[3], 1, got[0][:, None])[:, 0] / want[2]
        close(got[1], pb, f"sample_block repeated p m={m}")
    log(f"[kernels] sample_block repeated calls, m = {ms}: every draw "
        f"matches (the arrival counters reset themselves)")


def phase_sparsify(data):
    import numpy as np
    import torch
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sparsify import spectral_sparsify
    from repro_torch.ft import guards
    from repro_torch.kernels.kde_rowsum import kernel as rk
    from repro_torch.kernels.kde_sampler import kernel as sk
    n = SP_N
    t = 10 * n
    t0 = time.perf_counter()
    g = spectral_sparsify(data["sp_x_np"], gaussian(SP_BW), num_edges=t,
                          estimator="exact", exact_blocks=True, seed=0,
                          batch=BATCH, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    bs = data["sp_bs"]
    drawn = -(-t // BATCH) * BATCH
    assert rk.LAUNCHES["blocksum"] > 0, "degrees did not use the blocksum kernel"
    assert sk.LAUNCHES["sample_block"] > 0, \
        "edge batches did not use the sample-block kernel"
    assert g.kernel_evals == n * n + drawn * (n + bs + 1), g.kernel_evals
    assert g.kde_queries == n + drawn, g.kde_queries
    assert not (g.status & guards.FATAL), guards.decode_status(g.status)
    assert g.num_edges == t and np.all(np.isfinite(g.weight))
    assert g.src.min() >= 0 and g.src.max() < n and g.dst.max() < n
    log(f"[sparsify] n={n} d={SP_D} t={t}: {secs:.2f} s, "
        f"{t / secs:.0f} edges/s, kernel_evals={g.kernel_evals}, "
        f"status={g.status}")
    return g, secs


def chi2_critical(df: int) -> float:
    """Upper alpha = 1e-3 point of chi-square(df) by the Wilson-Hilferty
    approximation (within 0.1% of the exact point for df >= 50)."""
    a = 2.0 / (9.0 * df)
    return df * (1.0 - a + CHI2_Z * a ** 0.5) ** 3


def chi2_stat(counts, expected):
    """(statistic, alpha 1e-3 critical point, df) of Pearson's chi-square
    of ``counts`` against ``expected`` (float64 tensors; cells expecting
    fewer than 5 pooled into one)."""
    import torch
    small = expected < 5.0
    if bool(small.any()):
        counts = torch.cat([counts[~small], counts[small].sum()[None]])
        expected = torch.cat([expected[~small], expected[small].sum()[None]])
    stat = float(((counts - expected) ** 2 / expected).sum())
    df = counts.numel() - 1
    return stat, chi2_critical(df), df


def chi2_test(counts, expected, what: str) -> str:
    """``chi2_stat`` asserted under its critical point; returns the log
    text."""
    stat, crit, df = chi2_stat(counts, expected)
    assert stat < crit, f"{what}: chi-square {stat:.1f} >= {crit:.1f} (df {df})"
    return f"{what} chi-square {stat:.2f} < {crit:.2f} (df {df})"


def exact_degrees(x, inv_bw):
    """deg(u) = sum_{v != u} k(u, v) by the plain version, in float64."""
    import torch
    from repro_torch.kernels.kde_rowsum import kernel as rk
    return torch.cat([
        rk.rowsum_plain(x[lo:lo + BATCH], x, "gaussian", inv_bw).double()
        for lo in range(0, x.shape[0], BATCH)]) - 1.0


def edge_law(data, g, deg):
    """Chi-square checks of the main-path sparsifier's own edges against
    the exact law of Alg 5.1, with the plain versions on the card:

    - sources u ~ deg(u) / sum deg: counts per level-1 block against the
      blocks' degree mass;
    - destinations v ~ k(u, .) / deg(u) over v != u, by two randomized
      probability integral transforms, each uniform on [0, 1) exactly when
      every v follows its source's neighbor law: F_u(v-) + r k(u, v) in
      index order (sees a draw from the wrong block or column), and the
      mass of the w with k(u, w) < k(u, v) plus r times the mass of its
      ties, in kernel-value order (sees a law too flat or too sharp);
      each divided by deg(u), r ~ U[0, 1), in PIT_BINS equal bins.

    This reads the block drawn by the Gumbel-max kernel and the in-block
    draw of every edge, which the weight sum cannot see (with exact reads
    every weight is total / (2t) whatever was drawn)."""
    import torch
    x, bn = data["sp_x"], data["sp_bs"]
    n, dev = x.shape[0], x.device
    src = torch.as_tensor(g.src, device=dev)
    dst = torch.as_tensor(g.dst, device=dev)
    t = src.numel()
    nb = -(-n // bn)
    blk_mass = torch.zeros(nb, dtype=torch.float64, device=dev)
    blk_mass.index_add_(0, torch.arange(n, device=dev) // bn, deg)
    got = torch.bincount(src // bn, minlength=nb).double()
    texts = [chi2_test(got, t * blk_mass / blk_mass.sum(), "sources")]
    return "; ".join(texts + neighbor_law(x, src, dst, 1.0 / SP_BW))


def neighbor_law(x, src, dst, inv_bw):
    """Chi-square checks (alpha 1e-3) of destinations ``dst`` against v ~
    k(u, .) / deg(u) over v != u for sources ``src`` (gaussian kernel), by
    the two randomized PITs of ``edge_law``, in the plain version on the
    card; returns the log texts.  ``x``, ``src`` and ``dst`` may be lists
    (draws on several datasets: one test over all their PITs)."""
    import torch
    if isinstance(x, (list, tuple)):
        gen = torch.Generator(device=x[0].device).manual_seed(1)
        pit = torch.cat([neighbor_pits(xi, si, di, inv_bw, gen)
                         for xi, si, di in zip(x, src, dst)], dim=1)
    else:
        gen = torch.Generator(device=x.device).manual_seed(1)
        pit = neighbor_pits(x, src, dst, inv_bw, gen)
    t = pit.shape[1]
    texts = []
    for row, what in zip(pit, ("destinations, index order",
                               "destinations, value order")):
        got = torch.histc(row, bins=PIT_BINS, min=0.0, max=1.0).double()
        texts.append(chi2_test(got, torch.full_like(got, t / PIT_BINS),
                               what))
    return texts


def neighbor_pits(x, src, dst, inv_bw, gen):
    """The (2, t) randomized PITs of ``neighbor_law`` on one dataset."""
    import torch
    from repro_torch.kernels.kde_rowsum.ref import kernel_values
    t, dev = src.numel(), x.device
    pit = torch.empty((2, t), dtype=torch.float64, device=dev)
    for lo in range(0, t, BATCH):
        u, v = src[lo:lo + BATCH], dst[lo:lo + BATCH]
        rows = torch.arange(u.numel(), device=dev)
        kv = kernel_values(x[u], x, "gaussian", inv_bw).double()
        kv[rows, u] = 0.0                        # no self edges
        kuv = kv[rows, v][:, None]
        tot = kv.sum(1)
        r = torch.rand((2, u.numel()), generator=gen, device=dev,
                       dtype=torch.float64)
        below_idx = torch.cumsum(kv, dim=1)[rows, v] - kuv[:, 0]
        below_val = torch.where(kv < kuv, kv, 0.0).sum(1)
        ties = torch.where(kv == kuv, kv, 0.0).sum(1)
        pit[0, lo:lo + BATCH] = (below_idx + r[0] * kuv[:, 0]) / tot
        pit[1, lo:lo + BATCH] = (below_val + r[1] * ties) / tot
    return pit


def phase_sampler(data):
    """Phase 4: ``sample`` then ``prob_of`` on the exact read, then
    ``sample_exact`` (Theorem 4.12) on a stratified sampler, whose read
    launches no kernel.  Returns (seconds, (src, exact draws))."""
    import numpy as np
    import torch
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sampling.edge import NeighborSampler
    from repro_torch.kernels.kde_rowsum import kernel as rk
    from repro_torch.kernels.kde_sampler import kernel as sk
    t0 = time.perf_counter()
    x = data["sp_x"]
    src = data["ns_src"].cpu().numpy()
    nbr = NeighborSampler(x, gaussian(SP_BW), exact_blocks=True, seed=3,
                          device="cuda")
    v, p = nbr.sample(src)
    fresh = NeighborSampler(x, gaussian(SP_BW), exact_blocks=True, seed=4,
                            device="cuda")
    before = sk.LAUNCHES["masked_blocksum"]
    p_fresh = fresh.prob_of(src, v)
    assert sk.LAUNCHES["masked_blocksum"] > before, \
        "prob_of did not use the masked-blocksum kernel"
    p_cached = nbr.prob_of(src, v)
    np.testing.assert_allclose(p_fresh, p, rtol=1e-4)
    np.testing.assert_allclose(p_cached, p, rtol=1e-4)
    assert np.all(v != src) and np.all(p > 0) and np.all(np.isfinite(p))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"[sampler] frontier {len(src)} at n={x.shape[0]}: prob_of matches "
        f"the realized probabilities (max rel err "
        f"{float(np.max(np.abs(p_fresh - p) / p)):.2e}); {secs:.2f} s")
    before = {**rk.LAUNCHES, **sk.LAUNCHES}
    t0 = time.perf_counter()
    strat = NeighborSampler(x, gaussian(SP_BW), seed=5, device="cuda")
    v_ex = strat.sample_exact(src, rounds=EXACT_ROUNDS, slack=EXACT_SLACK)
    torch.cuda.synchronize()
    ex_secs = time.perf_counter() - t0
    assert {**rk.LAUNCHES, **sk.LAUNCHES} == before, \
        "the stratified read launched a kernel"
    w, bs, nb = len(src), strat.block_size, strat.num_blocks
    assert strat.exact_draws == w and np.all(v_ex != src)
    assert strat.evals == w * nb * ST_S + (EXACT_ROUNDS + 1) * w * bs \
        + EXACT_ROUNDS * w, strat.evals
    log(f"[sampler] sample_exact (rounds {EXACT_ROUNDS}, slack "
        f"{EXACT_SLACK}) on a stratified sampler (s {ST_S}): {w} draws, "
        f"{strat.exact_fallbacks} fallbacks (predicted rate "
        f"{(1 - 1 / EXACT_SLACK) ** EXACT_ROUNDS:.4f}), {ex_secs:.2f} s, "
        f"kernel_evals {strat.evals}")
    return secs + ex_secs, (src, v_ex)


def phase_lra(data):
    import torch
    from repro_torch.core.kernels_fn import laplacian
    from repro_torch.core.lowrank import fkv_lowrank
    from repro_torch.kernels.kde_rowsum import kernel as rk
    ker = laplacian(data["lra_bw"])
    t0 = time.perf_counter()
    res = fkv_lowrank(data["lra_x_np"], ker, rank=LRA_RANK,
                      num_rows=LRA_ROWS, estimator="exact", seed=0,
                      device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = LRA_N
    assert rk.LAUNCHES["rowsum"] > 0, "row norms did not use the rowsum kernel"
    assert res.kernel_evals == n * n + LRA_ROWS * n, res.kernel_evals
    assert res.u.shape == (LRA_RANK, n)
    return res, secs


def phase_lra_estimators(data):
    """``fkv_lowrank`` with the sub-linear row-norm estimators on phase 5's
    data, each run counted on its own: ``rs`` (RSKDE through the rowsum
    kernel, one launch a query batch) and ``stratified`` (plain torch, no
    kernel).  Returns {estimator: (result, seconds)}."""
    import torch
    from repro_torch.core.kernels_fn import laplacian
    from repro_torch.core.lowrank import fkv_lowrank
    from repro_torch.kernels.kde_rowsum import kernel as rk
    n = LRA_N
    out = {}
    for est, per_row in (("rs", RS_SAMPLES), ("stratified", LRA_NB * ST_S)):
        rk.reset_launches()
        t0 = time.perf_counter()
        res = fkv_lowrank(data["lra_x_np"], laplacian(data["lra_bw"]),
                          rank=LRA_RANK, num_rows=LRA_ROWS, estimator=est,
                          seed=0, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = rk.LAUNCHES["rowsum"]
        assert res.kernel_evals == n * per_row + LRA_ROWS * n, \
            (est, res.kernel_evals)
        assert res.u.shape == (LRA_RANK, n)
        want = -(-n // BATCH) if est == "rs" else 0
        assert launches == want, (est, launches, want)
        log(f"[lra] estimator={est}: {secs:.2f} s, kernel_evals "
            f"{res.kernel_evals} = n*{per_row} + {LRA_ROWS}*n (n^2 / "
            f"kernel_evals = {n * n / res.kernel_evals:.2f}), rowsum "
            f"launches {launches}")
        out[est] = (res, secs)
    return out


def lra_errors(data, results):
    """(FKV errors, one per result, subspace iteration) relative Frobenius
    errors on the dense K, computed in float64 on the card by the plain
    versions."""
    import torch
    from repro_torch.kernels.kde_sampler.ref import l1_dists
    x = data["lra_x"]
    k = torch.exp(-l1_dists(x, x) / data["lra_bw"]).double()
    fro2 = float((k * k).sum())

    def err(u):                      # u (r, n), orthonormal rows
        u, _ = torch.linalg.qr(u.T)
        r = k - (k @ u) @ u.T
        return float((r * r).sum()) / fro2

    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.linalg.qr(torch.randn(k.shape[0], LRA_RANK, generator=gen,
                                    device="cuda", dtype=torch.float64)).Q
    for _ in range(10):
        q = torch.linalg.qr(k @ q).Q
    return ([err(torch.as_tensor(res.u, device="cuda")) for res in results],
            err(q.T))


def close_scaled(got, want, what: str) -> float:
    """``close`` with the kde_hash kernels' atol: HASH_ATOL times the
    largest |plain value|."""
    return close(got, want, what, HASH_ATOL * float(want.abs().max()))


def hash_layout(x):
    """The hashed layout ``spectral_sparsify(estimator="hash", seed=0)``
    builds over ``x`` (its sampler's ``HashedKDE``), and its cell width."""
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.kernels.kde_hash.ops import build_hash_state
    return build_hash_state(x, gaussian(HS_BW), max_bucket=HS_MAX_BUCKET,
                            seed=HS_LAYOUT_SEED, device=x.device)


def phase_hash_kernels(data, gen):
    """Phase 2, kde_hash part: both weighted kernels against their plain
    versions (every kind, ragged; then the main-path shapes, whose
    columns and weights come from the hash phase's own layout and
    gathers); returns the two report rows."""
    import torch
    from repro_torch.kernels.kde_hash import kernel as hk
    from repro_torch.kernels.kde_hash import ops as hops
    from repro_torch.kernels.kde_hash import ref as href
    from repro_torch.roofline.analysis import H100
    dev = torch.device("cuda")
    errs = {"weighted_kv_sum": 0.0, "weighted_kv": 0.0}

    def check(q, x, cols, wgt, kind, inv_bw, beta, tag):
        args = (q, x, cols, wgt, kind, inv_bw, beta)
        errs["weighted_kv"] = max(errs["weighted_kv"], close_scaled(
            hk.weighted_kv_cuda(*args), hk.weighted_kv_plain(*args),
            f"weighted_kv {tag}"))
        errs["weighted_kv_sum"] = max(errs["weighted_kv_sum"], close_scaled(
            hk.weighted_kv_sum_cuda(*args), hk.weighted_kv_sum_plain(*args),
            f"weighted_kv_sum {tag}"))

    # ragged, every kind: d = 19, 784 and x off 16 bytes take the scalar
    # instance, d = 8, 16, 32 the vector one
    for kind, d, aligned in [("gaussian", 19, True), ("exponential", 19, True),
                             ("rational_quadratic", 19, True),
                             ("laplacian", 19, True), ("laplacian", 784, True),
                             ("gaussian", 8, True), ("laplacian", 16, True),
                             ("rational_quadratic", 32, True),
                             ("gaussian", 16, False)]:
        m, t, n = 37, 45, 301
        q = torch.randn(m, d, generator=gen, device=dev) * 0.3
        flat = torch.randn(n * d + 1, generator=gen, device=dev) * 0.3
        x = (flat[:-1] if aligned else flat[1:]).view(n, d)
        cols = torch.randint(-2, n + 2, (m, t), generator=gen,
                             dtype=torch.int32, device=dev)
        wgt = torch.rand((m, t), generator=gen, device=dev) * 256.0
        inv_bw = 1.0 / (0.3 * d) if kind == "laplacian" else \
            1.0 / (0.4 * d ** 0.5)
        plan = hk.weighted_kv_plan(m, n, d, t, x.data_ptr() % 16 == 0)
        check(q, x, cols, wgt, kind, inv_bw, 0.7, f"{kind} d={d} ragged")
        log(f"[kernels] ragged m={m} t={t} d={d} {kind}"
            f"{'' if aligned else ', x off 16 bytes'} [{plan}]: ok")

    x, state, cw = data["hs_x"], data["hs_state"], data["hs_cw"]
    n, d = x.shape
    bn = data["hs_bs"]
    nb = -(-n // bn)
    inv = 1.0 / HS_BW
    rows = []
    # one degree batch (hashed_query) and one edge batch's frontier read
    q = x[:BATCH].contiguous()
    fidx = hops.draw_query_noise(BATCH, HS_NUM_FAR, n, gen, dev)
    qcols, qwgt, _, _ = href.query_gather(q, state, fidx, cw, HS_NUM_FAR, n)
    src = torch.randint(0, n, (BATCH,), generator=gen, device=dev)
    off = hops.draw_frontier_noise(BATCH, nb, HS_FAR_PER_BLOCK, bn, gen, dev)
    fcols, fwgt, _, _ = href.frontier_gather(src, state, off,
                                             HS_FAR_PER_BLOCK, bn, nb, n)
    fq = x[src].contiguous()
    for name, qq, cols, wgt, line, sum_out in (
            ("weighted_kv_sum", q, qcols, qwgt, 87, True),
            ("weighted_kv", fq, fcols, fwgt, 97, False)):
        kern = hk.weighted_kv_sum_cuda if sum_out else hk.weighted_kv_cuda
        plain = hk.weighted_kv_sum_plain if sum_out else hk.weighted_kv_plain
        args = (qq, x, cols, wgt, "gaussian", inv)
        errs[name] = max(errs[name], close_scaled(kern(*args), plain(*args),
                                                  f"{name} main"))
        m, t = cols.shape
        uniq = torch.unique(cols).numel()
        b_ms, b_by = bound(m * t * (pair_ops("gaussian", d) + 1),
                           4 * (m * d + 2 * m * t + (m if sum_out else m * t)
                                + uniq * d))
        rows.append(dict(
            name=name, route="cuda", source="src/repro_torch/csrc/kde_hash.cu",
            replaces=f"src/repro/kernels/kde_hash/kernel.py:{line}",
            shape=f"m={m} t={t} d={d} gaussian, {uniq} distinct rows",
            ms=timed(lambda: kern(*args), 50),
            device_ms=kernel_device_ms(lambda: kern(*args), "weighted_kv",
                                       50),
            plain_ms=timed(lambda: plain(*args), 10),
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
        if not sum_out:
            rows[-1]["host_us"] = host_us(lambda: kern(*args), 200)
        gathered = m * t * d * 4
        dms = rows[-1]["device_ms"]
        rate = "not measured" if dms is None else \
            f"{gathered / (dms * 1e-3) / 1e12:.2f} TB/s"
        log(f"[kernels] {name} main [{hk.weighted_kv_plan(m, n, d, t)}]: "
            f"gathers {gathered / 1e6:.1f} MB of x rows through L2 "
            f"({gathered / (uniq * d * 4):.2f}x the distinct rows) at {rate} "
            f"on the card, against the HBM bound's {H100.hbm_bw / 1e12:.2f} "
            f"TB/s over the distinct rows")
    for r in rows:
        r["max_abs_err"] = errs[r["name"]]
        log_row(r)
    return rows


def free_cuda():
    """Hand a phase's freed tensors back to the card before the next."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def grid_text(grid) -> str:
    """A kde_decode plan's kernel and grid, as ``kernel.decode_grid`` gives
    them."""
    return (f"{grid['kernel']} kernel, {grid['ctas']} CTAs a launch, "
            f"{grid['ctas_per_group']} a (batch, kv-head)")


def decode_bound(q, k, kw, est):
    """bound() of one kde_decode call on this run's data: ``est`` (b, hq,
    nb) is the plain pipeline's step 1 on the same inputs, so its top-P
    selection is the call's.  Bytes at the operands' own sizes (K/V rows at
    2 bytes a value in bf16; q and out at q's)."""
    import torch
    from repro_torch.kernels.kde_attention import ref as kref
    b, hq, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    bk, stride, kv = kw["bk"], kw["stride"], kw["kv_valid"]
    nb = s // bk
    sel = kref.top_blocks(kref._group_lse(est, hq // hkv),
                          min(kw["top_p"], nb)).cpu()    # (b, hkv, P)
    blk = torch.arange(nb)
    strided = ((blk[:, None] * bk + torch.arange(0, bk, stride)[None])
               < kv).sum(1)                 # strided keys below kv_valid
    gathered = (kv - blk * bk).clamp(0, bk)     # block keys below kv_valid
    n_str = b * hkv * int(strided.sum())
    n_gat = int(gathered[sel].sum())
    rows = n_str - int(strided[sel].sum()) + 2 * n_gat
    g = hq // hkv
    return bound(g * (n_str * (2 * dh + 4) + n_gat * (4 * dh + 4)),
                 k.element_size() * rows * dh
                 + q.element_size() * 2 * b * hq * dh)


def phase_lm_kernels(gen):
    """Phase 2, LM part: the flash kernel against its plain version on the
    card (ragged, scalar-staged, bf16, the prefill shape); the fused KDE
    decode kernel against its plain pipeline (out and its step-1
    estimates, the latter also against block_lse_plain) over the serve
    run's decode steps and at S = 32768 with bench_attention's planted
    keys; the estimate-only block-lse kernel against its plain version;
    returns the two report rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.kde_attention import kernel as kk
    from repro_torch.kernels.kde_attention import ops as kops
    from repro_torch.testing import assert_bf16_close
    dev = gen.device
    errs = {"flash_attention": 0.0, "kde_decode": 0.0}
    steps = {}

    def qkv(b, hq, hkv, sq, skv, dh, dtype=torch.float32):
        # q, k contiguous and v a transposed view: as the model hands them
        q = torch.randn((b, hq, sq, dh), generator=gen, device=dev)
        k = torch.randn((b, hkv, skv, dh), generator=gen, device=dev)
        v = torch.randn((b, skv, hkv, dh), generator=gen,
                        device=dev).transpose(1, 2)
        return q.to(dtype), k.to(dtype), v.to(dtype)

    def flash_check(q, k, v, bq, bk, tag):
        """Kernel vs plain version: out and lse at RTOL / ATOL; a bf16 out
        within one bf16 step of the plain version's (both sum in f32 from
        the same operands and round once), its worst step count kept in
        ``steps[tag]``."""
        kp, vp, kw = fops.flash_args(q, k, v, True, bq, bk)
        out, lse = fk.flash_attention_cuda(q, kp, vp, **kw)
        p_out, p_lse = fk.flash_attention_plain(q, kp, vp, **kw)
        inst = f"{fk.instantiation(q, kp, vp)}, {fk.BODIES[q.dtype][0]}"
        if q.dtype == torch.bfloat16:
            e, steps[tag] = assert_bf16_close(out, p_out, ATOL,
                                              f"flash out {tag}")
            return max(e, close(lse, p_lse, f"flash lse {tag}")), inst
        e = max(close(out, p_out, f"flash out {tag}"),
                close(lse, p_lse, f"flash lse {tag}"))
        errs["flash_attention"] = max(errs["flash_attention"], e)
        return e, inst

    for kind, shapes in (("ragged", FLASH_RAGGED), ("scalar", FLASH_SCALAR)):
        for shape in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                shape_tag = f"{shape} {dtype}"
                e, inst = flash_check(*qkv(*shape, dtype=dtype), 64, 64,
                                      shape_tag)
                log(f"[kernels] flash {kind} (b, hq, hkv, sq, skv, dh) = "
                    f"{shape} {str(dtype)[6:]} [{inst}]: max_abs_err "
                    f"{e:.3e}" + (f", max bf16 steps {steps[shape_tag]}"
                                  if dtype == torch.bfloat16 else ""))
    # rows 4 bytes off 16-byte alignment: k / v views into a flat buffer
    # (skv a multiple of the block, so flash_args does not pad them)
    q, _, _ = qkv(1, 4, 2, 256, 256, 64)
    flat = torch.randn(2, 2 * 256 * 64 + 1, generator=gen, device=dev)
    k, v = (t[1:].view(1, 2, 256, 64) for t in flat)
    e, inst = flash_check(q, k, v, 64, 64, "unaligned rows")
    assert fk.instantiation(q, k, v).endswith("scalar"), inst
    log(f"[kernels] flash unaligned k / v rows (1, 4, 2, 256, 256, 64) "
        f"[{inst}]: max_abs_err {e:.3e}")

    rows = []
    b, hq, hkv, s, _, dh = FLASH_MAIN
    q, k, v = qkv(*FLASH_MAIN)
    e, inst = flash_check(q, k, v, 128, 128, "main")
    log(f"[kernels] flash main {FLASH_MAIN} [{inst}]: max_abs_err {e:.3e}")
    free_cuda()
    kp, vp, kw = fops.flash_args(q, k, v)
    b_ms, b_by = bound(4 * b * hq * dh * s * s / 2,
                       4 * (2 * b * hq * s * dh + 2 * b * hkv * s * dh
                            + b * hq * s))
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:67",
        shape=f"b={b} hq={hq} hkv={hkv} s={s} dh={dh} causal f32 [{inst}]",
        ms=timed(lambda: fk.flash_attention_cuda(q, kp, vp, **kw), 5),
        device_ms=kernel_device_ms(
            lambda: fk.flash_attention_cuda(q, kp, vp, **kw),
            fk.BODIES[torch.float32][1], 3),
        plain_ms=timed(lambda: fk.flash_attention_plain(q, kp, vp, **kw), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timed(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 3)))
    del q, k, v, kp, vp
    free_cuda()

    # the flash kernel's bf16 operands at the prefill shape: the lm-bf16
    # prefill's row (SDPA in bf16 its yardstick)
    q, k, v = qkv(*FLASH_MAIN, dtype=torch.bfloat16)
    e, inst = flash_check(q, k, v, 128, 128, "main bf16")
    errs["flash_attention_bf16"] = e
    log(f"[kernels] flash main bf16 {FLASH_MAIN} [{inst}]: max_abs_err "
        f"{e:.3e}, max bf16 steps {steps['main bf16']} (beyond atol {ATOL})")
    free_cuda()
    kp, vp, kw = fops.flash_args(q, k, v)
    b_ms, b_by = bound(0.0, 2 * (2 * b * hq * s * dh + 2 * b * hkv * s * dh)
                       + 4 * b * hq * s,
                       bf16_flops=4 * b * hq * dh * s * s / 2)
    rows.append(dict(
        name="flash_attention_bf16", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:67",
        shape=f"b={b} hq={hq} hkv={hkv} s={s} dh={dh} causal bf16 [{inst}]",
        max_bf16_steps=steps["main bf16"],
        ms=timed(lambda: fk.flash_attention_cuda(q, kp, vp, **kw), 5),
        device_ms=kernel_device_ms(
            lambda: fk.flash_attention_cuda(q, kp, vp, **kw),
            fk.BODIES[torch.bfloat16][1], 3),
        plain_ms=timed(lambda: fk.flash_attention_plain(q, kp, vp, **kw), 2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timed(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 3)))
    del q, k, v, kp, vp
    free_cuda()

    def decode_inputs(b, hq, hkv, s, dh, dtype=torch.float32):
        q = torch.randn((b, hq, dh), generator=gen, device=dev)
        k = torch.randn((b, hkv, s, dh), generator=gen, device=dev) * 0.3
        v = torch.randn((b, hkv, s, dh), generator=gen, device=dev)
        return q.to(dtype), k.to(dtype), v.to(dtype)

    def decode_check(q, k, v, kw, tag):
        """Fused kernel vs plain pipeline (out, est), est vs
        block_lse_plain; blocks past kv_valid at -1e30 exactly."""
        out, est = kk.kde_decode_cuda(q, k, v, with_est=True, **kw)
        p_out, p_est = kk.kde_decode_plain(q, k, v, with_est=True, **kw)
        want_est = kk.block_lse_plain(
            q, k, scale=q.shape[-1] ** -0.5, stride=kw["stride"],
            kv_valid=kw["kv_valid"], bk=kw["bk"])
        e = max(close(out, p_out, f"kde_decode out {tag}"),
                close(est, p_est, f"kde_decode est {tag}"),
                close(est, want_est, f"kde_decode est vs block_lse {tag}"))
        dead = -(-kw["kv_valid"] // kw["bk"])
        assert bool((est[..., dead:] == -1e30).all()), tag
        errs["kde_decode"] = max(errs["kde_decode"], e)
        return e

    b, hq, hkv, s, dh, bk, stride = LSE_SERVE
    q, k, v = decode_inputs(b, hq, hkv, s, dh)
    for kv_valid in KDE_VALID_SWEEP:
        kw = dict(top_p=KDE_SERVE_TOP_P, bk=bk, stride=stride,
                  kv_valid=kv_valid)
        e = decode_check(q, k, v, kw, f"serve kv={kv_valid}")
        log(f"[kernels] kde_decode serve shape kv_valid {kv_valid}: out and "
            f"est (also vs block_lse_plain) max_abs_err {e:.3e}")
    kw = dict(top_p=KDE_SERVE_TOP_P, bk=bk, stride=stride, kv_valid=s - 17)
    b_ms, b_by = decode_bound(q, k, kw, kk.kde_decode_plain(
        q, k, v, with_est=True, **kw)[1])
    rows.append(dict(
        name="kde_decode", route="cuda",
        source="src/repro_torch/csrc/kde_attention.cu",
        replaces="src/repro/kernels/kde_attention/kernel.py:40",
        shape=f"b={b} hq={hq} hkv={hkv} S={s} dh={dh} bk={bk} "
              f"stride={stride} top_p={KDE_SERVE_TOP_P} kv_valid={s - 17}",
        ms=timed(lambda: kk.kde_decode_cuda(q, k, v, **kw), 200),
        device_ms=kernel_device_ms(lambda: kk.kde_decode_cuda(q, k, v, **kw),
                                   KDE_KERNELS, 200),
        plain_ms=timed(lambda: kk.kde_decode_plain(q, k, v, **kw), 50),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    log(f"[kernels] kde_decode wrapper host time: "
        f"{host_us(lambda: kk.kde_decode_cuda(q, k, v, **kw), 200):.2f} us a "
        f"call (host clock over 200 calls, no synchronize inside)")

    b, hq, hkv, s, dh, bk, stride = LSE_LONG
    q, k, v = decode_inputs(b, hq, hkv, s, dh)
    kw = dict(top_p=KDE_LONG_TOP_P, bk=bk, stride=stride, kv_valid=s)
    e = decode_check(q, k, v, kw, "S=32768")
    log(f"[kernels] kde_decode S={s} random keys: max_abs_err {e:.3e}")
    # bench_attention's peaked mass at yi's heads: planted keys dominate
    # the S-key background
    k = planted_keys(q, hkv, s, gen)
    e = decode_check(q, k, v, kw, "S=32768 planted")
    b_ms, _ = decode_bound(q, k, kw, kk.kde_decode_plain(
        q, k, v, with_est=True, **kw)[1])
    kw = dict(top_p=KDE_LONG_TOP_P, bk=bk, stride=stride)
    out = kops.kde_attention(q, k, v, **kw)
    close(out, kops.kde_attention_ref(q, k, v, **kw), "kde_attention S=32768")
    exact = kops.exact_decode_attention(q, k, v)
    dms = kernel_device_ms(lambda: kops.kde_attention(q, k, v, **kw),
                           KDE_KERNELS, 50)
    log(f"[kernels] kde_decode S={s} (top_p {KDE_LONG_TOP_P}, bk {bk}, "
        f"stride {stride}, planted keys) through ops.kde_attention: kernel "
        f"= plain pipeline (max_abs_err {e:.3e}); device {dms} ms a launch, "
        f"bound {b_ms:.5f} ms; max |kde - exact| / max |exact| = "
        f"{float((out - exact).abs().max() / exact.abs().max()):.4e}")
    del q, k, v, out, exact
    free_cuda()

    b, hq, hkv, s, dh, bk, stride = LSE_XL
    q, k, v = decode_inputs(b, hq, hkv, s, dh)
    for kv_valid in (s // 2 + 3, s):
        kw = dict(top_p=KDE_SERVE_TOP_P, bk=bk, stride=stride,
                  kv_valid=kv_valid)
        e = decode_check(q, k, v, kw, f"S={s} kv={kv_valid}")
    b_ms, _ = decode_bound(q, k, kw, kk.kde_decode_plain(
        q, k, v, with_est=True, **kw)[1])
    dms = kernel_device_ms(lambda: kk.kde_decode_cuda(q, k, v, **kw),
                           KDE_KERNELS, 50)
    log(f"[kernels] kde_decode S={s} (b {b}, bk {bk}, stride {stride}, "
        f"top_p {KDE_SERVE_TOP_P}; {s // bk} blocks): max_abs_err {e:.3e}; "
        f"device {dms} ms a launch, bound {b_ms:.5f} ms")
    del q, k, v
    free_cuda()

    # the bf16 instances: bitwise the f32 instance on the upcast inputs,
    # and against the plain pipeline; timed at each shape, the long_500k
    # one the lm-bf16 decode's row
    errs["kde_decode_bf16"] = 0.0
    for shape, top_p in ((LSE_SERVE, KDE_SERVE_TOP_P),
                         (LSE_LONG, KDE_LONG_TOP_P),
                         (LSE_500K, LONG_KDE["top_p"])):
        b, hq, hkv, s, dh, bk, stride = shape
        q, k, v = decode_inputs(b, hq, hkv, s, dh, torch.bfloat16)
        for kv_valid in sorted({s, s // 2 + 3}):
            kw = dict(top_p=top_p, bk=bk, stride=stride, kv_valid=kv_valid)
            e = decode_bf16_check(q, k, v, kw, f"bf16 S={s} kv={kv_valid}")
            errs["kde_decode_bf16"] = max(errs["kde_decode_bf16"], e)
        grid = kk.decode_grid(q, k, v, top_p=top_p, bk=bk, stride=stride)
        b_ms, b_by = decode_bound(q, k, kw, kk.kde_decode_plain(
            q, k, v, with_est=True, **kw)[1])
        row = dict(
            name="kde_decode_bf16", route="cuda",
            source="src/repro_torch/csrc/kde_attention.cu",
            replaces="src/repro/kernels/kde_attention/kernel.py:40",
            shape=f"b={b} hq={hq} hkv={hkv} S={s} dh={dh} bk={bk} "
                  f"stride={stride} top_p={top_p} kv_valid={s} bf16 q, k, v "
                  f"({grid_text(grid)})", ctas=grid["ctas"],
            ms=timed(lambda: kk.kde_decode_cuda(q, k, v, **kw), 50),
            device_ms=kernel_device_ms(
                lambda: kk.kde_decode_cuda(q, k, v, **kw),
                KDE_KERNELS, 50),
            plain_ms=timed(lambda: kk.kde_decode_plain(q, k, v, **kw), 5),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        q32, k32, v32 = q.float(), k.float(), v.float()
        dms32 = kernel_device_ms(
            lambda: kk.kde_decode_cuda(q32, k32, v32, **kw),
            KDE_KERNELS, 50)
        # the other kernel on the same inputs, forced past the plan
        other = "cluster" if grid["kernel"] == "spread" else "spread"
        dms_other = kernel_device_ms(
            lambda: kk.kde_decode_cuda(q, k, v, kernel=other, **kw),
            KDE_KERNELS, 20)
        log(f"[kernels] kde_decode bf16 {row['shape']}: {row['ms']:.4f} ms "
            f"(device {row['device_ms']}; the f32 instance on the upcast "
            f"inputs: device {dms32}; the {other} kernel: device "
            f"{dms_other}; plain {row['plain_ms']:.4f}, bound {b_ms:.5f} by "
            f"{b_by})")
        del q, k, v, q32, k32, v32
        free_cuda()
    rows.append(row)
    flash_offset_checks(rows, qkv, errs)
    family_kernel_checks(rows, flash_check, decode_check, decode_inputs,
                         qkv, steps)
    for r in rows:
        r["max_abs_err"] = errs[r["name"]]
        log(f"[kernels] {r['name']} main {r['shape']}: max_abs_err "
            f"{r['max_abs_err']:.3e}, {r['ms']:.4f} ms (device "
            f"{r['device_ms']}, plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']}, bound {r['bound_ms']:.5f} by "
            f"{r['bound_by']})")
    log("[kernels] kde_decode library_ms null: no PyTorch call computes "
        "KDE block selection with attention over the selected blocks")
    return rows


def flash_cp_bound(b, hq, hkv, sq, dh, off, dtype):
    """(bound_ms, bound_by) of the flash kernel on a shard's sq query rows
    at offset ``off``: its causal pairs, b hq (sq off + sq (sq + 1) / 2),
    at 4 dh operations a pair (FP32, or bf16 operands on the tensor
    cores), against q, out and lse and the keys and values the mask
    leaves (positions below off + sq), at the operands' size."""
    import torch
    ops = 4 * dh * b * hq * (sq * off + sq * (sq + 1) // 2)
    vb = 4 if dtype == torch.float32 else 2
    nbytes = vb * (2 * b * hq * sq * dh + 2 * b * hkv * (off + sq) * dh) \
        + 4 * b * hq * sq
    if dtype == torch.float32:
        return bound(ops, nbytes)
    return bound(0.0, nbytes, bf16_flops=ops)


def flash_offset_checks(rows, qkv, errs):
    """Phase 2: the flash kernel at explicit query offsets (``flash_at``'s
    launches: a sequence shard's rows against the whole key timeline), f32
    and bf16, against its plain version at the same offset -- f32 at RTOL
    / ATOL, bf16 within one bf16 step (``max_bf16_steps`` <= 1) -- over
    the shards of ``FLASH_CP`` (a ragged 777-row shard; qwen2.5-14b's rank
    shape at 4096 tokens, each offset's device ms beside its bound).  The results go on
    the flash rows as ``cp_offsets``."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.testing import assert_bf16_close
    by_name = {r["name"]: r for r in rows}
    for dtype, name in ((torch.float32, "flash_attention"),
                        (torch.bfloat16, "flash_attention_bf16")):
        cp = by_name[name].setdefault("cp_offsets", [])
        for b, hq, hkv, sq, skv, dh in FLASH_CP:
            q, k, v = qkv(b, hq, hkv, skv, skv, dh, dtype=dtype)
            kp, vp, kw = fops.flash_args(q[:, :, :sq], k, v)
            timed_shape = (b, hq, hkv, sq, skv, dh) == FLASH_CP[-1]
            for off in range(0, skv, sq):
                qs = q[:, :, off:off + sq]
                kw["offset"] = off
                out, lse = fk.flash_attention_cuda(qs, kp, vp, **kw)
                p_out, p_lse = fk.flash_attention_plain(qs, kp, vp, **kw)
                tag = f"flash_at {(b, hq, hkv, sq, skv, dh)} offset {off}"
                if dtype == torch.bfloat16:
                    e, nsteps = assert_bf16_close(out, p_out, ATOL, tag)
                    e = max(e, close(lse, p_lse, f"{tag} lse"))
                else:
                    e, nsteps = max(close(out, p_out, tag),
                                    close(lse, p_lse, f"{tag} lse")), None
                errs[name] = max(errs[name], e)
                via = fops.flash_at(qs, k, v, off)
                assert torch.equal(via, out), f"{tag}: flash_at differs"
                rec = dict(shape=[b, hq, hkv, sq, skv, dh], offset=off,
                           max_abs_err=e, instance=fk.instantiation(
                               qs, kp, vp))
                if nsteps is not None:
                    rec["max_bf16_steps"] = nsteps
                if timed_shape:
                    rec["device_ms"] = kernel_device_ms(
                        lambda: fk.flash_attention_cuda(qs, kp, vp, **kw),
                        fk.BODIES[dtype][1], 3)
                    rec["bound_ms"], rec["bound_by"] = flash_cp_bound(
                        b, hq, hkv, sq, dh, off, dtype)
                cp.append(rec)
                log(f"[kernels] flash_at {str(dtype)[6:]} (b, hq, hkv, sq, "
                    f"skv, dh) = {(b, hq, hkv, sq, skv, dh)} offset {off} "
                    f"[{rec['instance']}]: max_abs_err {e:.3e}"
                    + (f", max bf16 steps {nsteps}" if nsteps is not None
                       else "")
                    + (f"; device {rec['device_ms']} ms, bound "
                       f"{rec['bound_ms']:.5f} by {rec['bound_by']}"
                       if timed_shape else ""))
            del q, k, v, kp, vp, out, lse, p_out, p_lse, via
            free_cuda()


def family_heads():
    """(arch, hq, hkv, dh) of every family phase's config with attention."""
    from repro_torch.configs.base import get_config
    out = []
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        if not cfg.attention_free:
            out.append((arch, cfg.num_heads, cfg.num_kv_heads, cfg.hd))
    return out


def family_kernel_checks(rows, flash_check, decode_check, decode_inputs,
                         qkv, steps) -> None:
    """Phase 2 at the family phase's attention shapes, before phase 17
    runs them: the flash kernel (f32 and bf16 operands) at each family's
    prefill, (4, hq, hkv, 512, 512, dh), and the fused KDE decode kernel at
    its serve shape, (4, hq, hkv, 544, dh), bk 32, stride 4, top_p 4, over
    kv_valid 1 / 399 / 527 / 544, each against its plain version; each
    shape's device ms beside its bound goes into the f32 rows'
    ``family_shapes``."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.kde_attention import kernel as kk
    by_name = {r["name"]: r for r in rows}
    for r in ("flash_attention", "kde_decode"):
        by_name[r]["family_shapes"] = {}
    for arch, hq, hkv, dh in family_heads():
        shape = (4, hq, hkv, 512, 512, dh)
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{arch} {str(dtype)[6:]}"
            q, k, v = qkv(*shape, dtype=dtype)
            e, inst = flash_check(q, k, v, 128, 128, tag)
            extra = (f", max bf16 steps {steps[tag]}"
                     if dtype == torch.bfloat16 else "")
            log(f"[kernels] flash {arch} prefill shape {shape} "
                f"{str(dtype)[6:]} [{inst}]: max_abs_err {e:.3e}{extra}")
        q, k, v = qkv(*shape)
        kp, vp, kw = fops.flash_args(q, k, v)
        b, s = shape[0], shape[3]
        b_ms, b_by = bound(4 * b * hq * dh * s * s / 2,
                           4 * (2 * b * hq * s * dh + 2 * b * hkv * s * dh
                                + b * hq * s))
        dms = kernel_device_ms(lambda: fk.flash_attention_cuda(
            q, kp, vp, **kw), fk.BODIES[torch.float32][1], 10)
        by_name["flash_attention"]["family_shapes"][arch] = dict(
            shape=f"b={b} hq={hq} hkv={hkv} s={s} dh={dh} f32",
            device_ms=dms, bound_ms=b_ms, bound_by=b_by)
        log(f"[kernels] flash {arch} f32 prefill shape: device {dms} ms, "
            f"bound {b_ms:.5f} by {b_by}")
        del q, k, v, kp, vp
        q, k, v = decode_inputs(4, hq, hkv, 544, dh)
        for kv_valid in (1, 399, 527, 544):
            kw = dict(top_p=KDE_SERVE_TOP_P, bk=32, stride=4,
                      kv_valid=kv_valid)
            e = decode_check(q, k, v, kw, f"{arch} kv={kv_valid}")
        kw["kv_valid"] = 527
        grid = kk.decode_grid(q, k, v, top_p=KDE_SERVE_TOP_P, bk=32,
                              stride=4)
        b_ms, b_by = decode_bound(q, k, kw, kk.kde_decode_plain(
            q, k, v, with_est=True, **kw)[1])
        dms = kernel_device_ms(lambda: kk.kde_decode_cuda(q, k, v, **kw),
                               KDE_KERNELS, 100)
        by_name["kde_decode"]["family_shapes"][arch] = dict(
            shape=f"b=4 hq={hq} hkv={hkv} S=544 dh={dh} bk=32 stride=4 "
                  f"top_p={KDE_SERVE_TOP_P} kv_valid=527 ({grid_text(grid)})",
            device_ms=dms, bound_ms=b_ms, bound_by=b_by)
        log(f"[kernels] kde_decode {arch} serve shape (4, {hq}, {hkv}, 544, "
            f"{dh}), {grid_text(grid)}: kernel = plain pipeline over "
            f"kv_valid 1 / 399 / 527 / 544 (max_abs_err {e:.3e}); device "
            f"{dms} ms a launch at kv_valid 527, bound {b_ms:.5f} by {b_by}")
        del q, k, v
        free_cuda()


def planted_keys(q, hkv, s, gen):
    """bench_attention's peaked mass at q's heads: N(0, 0.05^2) keys with
    runs along each group's mean query at [50, 90) (x 8) and [s/2, s/2 +
    30) (x 6), in q's dtype."""
    import torch
    b, hq, dh = q.shape
    k = torch.randn((b, hkv, s, dh), generator=gen, device=q.device) * 0.05
    qv = q.float().reshape(b, hkv, hq // hkv, dh).mean(2)
    qv = qv / torch.linalg.vector_norm(qv, dim=-1, keepdim=True)
    k[:, :, 50:90] += 8.0 * qv[:, :, None]
    k[:, :, s // 2:s // 2 + 30] += 6.0 * qv[:, :, None]
    return k.to(q.dtype)


def decode_bf16_check(q, k, v, kw, tag) -> float:
    """A bf16 instance of kde_decode (q and the cache in bf16): out and
    est bitwise the f32 instance's on the upcast inputs (out rounded to
    bf16); est against the plain pipeline at rtol 2e-4 / atol 1e-5 and out
    within one bf16 step of the plain pipeline's bf16 out (or within atol
    1e-5 of it, where a sum near zero has steps finer than the f32
    rounding); blocks past kv_valid at -1e30.  Returns the max abs error
    against the plain pipeline."""
    import torch
    from repro_torch.kernels.kde_attention import kernel as kk
    from repro_torch.testing import assert_bf16_close
    out, est = kk.kde_decode_cuda(q, k, v, with_est=True, **kw)
    o32, e32 = kk.kde_decode_cuda(q.float(), k.float(), v.float(),
                                  with_est=True, **kw)
    assert out.dtype == q.dtype, tag
    assert torch.equal(out, o32.to(q.dtype)), f"{tag}: out != f32 instance"
    assert torch.equal(est, e32), f"{tag}: est != f32 instance"
    p_out, p_est = kk.kde_decode_plain(q, k, v, with_est=True, **kw)
    e = close(est, p_est, f"{tag} est")
    diff, _ = assert_bf16_close(out, p_out, ATOL, f"{tag} out")
    assert bool(torch.isfinite(out).all()), tag
    dead = -(-kw["kv_valid"] // kw["bk"])
    assert bool((est[..., dead:] == -1e30).all()), tag
    return max(e, diff)


def logit_check(got, want, vocab: int, what: str) -> str:
    """max |got - want| <= LM_LOGIT_REL max |want| over the real vocab, and
    the same argmax on every row; returns the log text."""
    import torch
    got, want = got[..., :vocab].double(), want[..., :vocab].double()
    assert bool(torch.isfinite(got).all()), f"{what}: non-finite logits"
    diff = float((got - want).abs().max())
    top = float(want.abs().max())
    assert diff <= LM_LOGIT_REL * top, (what, diff, top)
    same = torch.equal(got.argmax(-1), want.argmax(-1))
    assert same, f"{what}: argmax differs"
    return (f"max |diff| {diff:.3e} <= {LM_LOGIT_REL} x max |logit| "
            f"{top:.4f}; argmax equal on all {got.shape[0]} rows")


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_kernels(fn, reps: int):
    """``profiling.device_kernels`` (padded, retraced until whole), each
    trace that lost records logged."""
    from repro_torch.kernels.profiling import device_kernels as traced
    return traced(fn, reps, log=log)


def kernel_device_ms(fn, kernel, reps: int):
    """Mean device ms per call of ``fn`` in the CUDA kernels whose names
    contain ``kernel`` (a name, or a tuple of names; "" for all of them),
    from torch.profiler's kernel durations over ``reps`` calls (so the
    host's cost per call is left out), taken from a trace that recorded
    every launch; None, printed as not measured, when no trace shows such a
    kernel or none was whole."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    hit = [us for name, (_, us) in device_kernels(fn, reps).items()
           if any(k in name for k in names)]
    if not hit or None in hit:
        return None
    return sum(hit) / reps / 1e3


def launches_per_call(fn, reps: int) -> float:
    """Device launches (kernels, memsets, copies) per call of ``fn``, from
    ``device_kernels``; NaN when no trace shows device activity."""
    ks = device_kernels(fn, reps)
    return sum(c for c, _ in ks.values()) / reps if ks else float("nan")


def device_profile(fn, top: int = 4):
    """(wall s without the profiler, device s, busy share, the ``top``
    kernels by device time) of one call of ``fn``: the wall time from a
    host clock around a run ending in a synchronize, the device time from
    a ``torch.profiler`` trace of a second run (the sum of the CUDA
    kernels' self time; one stream, so they do not overlap).  A trace that
    shows no device time gives device s 0.0, printed as not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if _dev_us(e) > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(_dev_us(e) for e in kern) / 1e6
    kern.sort(key=_dev_us, reverse=True)
    names = [(e.key[:60], _dev_us(e) / 1e6, e.count) for e in kern[:top]]
    return wall, busy, busy / wall, names


def profile_text(wall, busy, share, names) -> str:
    if busy == 0.0:
        return (f"wall {wall:.4f} s; device time not measured (the trace "
                f"shows none)")
    return (f"wall {wall:.4f} s, device busy {busy:.4f} s ({share:.1%}; "
            f"idle share {1 - share:.1%}); top kernels: " + "; ".join(
                f"{n} {t:.4f} s x{c}" for n, t, c in names))


def phase_lm_prefill():
    """Phase 10: yi-6b at full width and depth, the flash prefill counted
    and checked against xla; returns the f32 model, the flash launches,
    the flash seconds and the prefill batch."""
    import torch
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import transformer as T
    from repro_torch.train.train_step import make_prefill_step
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    t0 = time.perf_counter()
    model = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    # the reference's param_count leaves out the final norm's d gains
    assert n_params == cfg.param_count() + cfg.d_model, n_params
    log(f"[lm-prefill] {cfg.name} f32 random init on the card: {n_params} "
        f"parameters ({4 * n_params / 1e9:.2f} GB), "
        f"{time.perf_counter() - t0:.2f} s")
    shape = ShapeConfig("prefill_8k", LM_PREFILL_SEQ, LM_PREFILL_BATCH,
                        "prefill")
    batch = make_batch(cfg, shape, 0, 0)
    tokens = LM_PREFILL_SEQ * LM_PREFILL_BATCH
    fk.reset_launches()
    t0 = time.perf_counter()
    flash = make_prefill_step(cfg, impl="flash")(model, batch)
    torch.cuda.synchronize()
    t_flash = time.perf_counter() - t0
    launches = fk.LAUNCHES["flash_attention"]
    assert launches == cfg.num_layers, launches
    t0 = time.perf_counter()
    xla = make_prefill_step(cfg, impl="xla")(model, batch)
    torch.cuda.synchronize()
    t_xla = time.perf_counter() - t0
    text = logit_check(flash[:, -1], xla[:, -1], cfg.vocab_size,
                       "lm-prefill flash vs xla")
    log(f"[lm-prefill] batch {LM_PREFILL_BATCH} x seq {LM_PREFILL_SEQ}: "
        f"flash {t_flash:.3f} s ({tokens / t_flash:.1f} tokens/s, "
        f"{launches} flash launches), xla (chunked) {t_xla:.3f} s "
        f"({tokens / t_xla:.1f} tokens/s); last-position logits: {text}")
    del flash, xla
    free_cuda()
    step = make_prefill_step(cfg, impl="flash")
    log("[lm-prefill] one flash prefill, where the time goes: "
        + profile_text(*device_profile(lambda: step(model, batch))))
    return model, launches, t_flash, batch


def phase_lm_serve(model, gen):
    """Phase 11: the serve driver on the full model, xla then kde."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels.kde_attention import kernel as kk
    from repro_torch.kernels.kde_attention import ops as kops
    from repro_torch.launch import serve
    from repro_torch.train.train_step import (make_decode_step,
                                              make_prefill_step)
    cfg = model.cfg
    args = {a: serve.parser().parse_args(LM_SERVE_ARGS + ["--attention", a])
            for a in ("xla", "kde")}
    b, plen = args["xla"].batch, args["xla"].prompt_len
    batch = make_batch(cfg, ShapeConfig("serve", plen, b, "prefill"), 0,
                       args["xla"].seed)
    want = make_prefill_step(cfg, impl="flash")(model, batch)[:, 0]
    res = {"xla": serve.run_lm(args["xla"], model=model)}
    text = logit_check(res["xla"]["prompt_logits"], want, cfg.vocab_size,
                       "lm-serve xla last prompt step vs flash prefill")
    log(f"[lm-serve] xla: last-prompt-step logits vs the flash prefill of "
        f"the same prompts: {text}")
    del res["xla"]["cache"], want
    free_cuda()
    kk.reset_launches()
    res["kde"] = serve.run_lm(args["kde"], model=model)
    launches = kk.LAUNCHES["kde_decode"]
    steps = plen + args["kde"].gen - 1
    assert launches == cfg.num_layers * steps, (launches, steps)
    assert res["kde"]["max_len"] == 544, res["kde"]["max_len"]
    kcfg = dict(top_p=args["kde"].kde_top_p, bk=args["kde"].kde_bk,
                stride=args["kde"].kde_stride, kv_valid=steps)
    for layer in LM_KDE_LAYERS:
        ck = res["kde"]["cache"]["k"][layer]
        cv = res["kde"]["cache"]["v"][layer]
        q = torch.randn((b, cfg.num_heads, cfg.hd), generator=gen,
                        device=ck.device)
        e = close(kops.kde_attention(q, ck, cv, **kcfg),
                  kops.kde_attention_ref(q, ck, cv, **kcfg),
                  f"kde_attention layer {layer} final cache")
        log(f"[lm-serve] kde final cache layer {layer}: kde_attention "
            f"kernel path vs plain pipeline max_abs_err {e:.3e}")
    v = cfg.vocab_size
    a = res["xla"]["prompt_logits"][:, :v].double().cpu().numpy()
    k = res["kde"]["prompt_logits"][:, :v].double().cpu().numpy()
    corr = float(np.mean([np.corrcoef(x1, x2)[0, 1] for x1, x2 in zip(a, k)]))
    agree = float((res["xla"]["tokens"] == res["kde"]["tokens"]).mean())
    for name, r in res.items():
        log(f"[lm-serve] {name}: batch {b}, prompt {plen}, gen "
            f"{args[name].gen}, cache {r['max_len']}: prefill (teacher-"
            f"forced replay) {r['prefill_s']:.3f} s, decode "
            f"{r['decode_s']:.3f} s ({args[name].gen * b / r['decode_s']:.1f}"
            f" tok/s)")
    log(f"[lm-serve] kde: {launches} kde_decode launches = {cfg.num_layers} "
        f"layers x {steps} steps; first generated step's logits, Pearson "
        f"correlation kde vs xla {corr:.6f} (reported, not gated); "
        f"generated tokens equal to xla's: {agree:.3f}")
    # where a decode step's time goes: 8 steps past the run's last
    # position on its cache (544 slots), each attention once
    cache = res["kde"]["cache"]
    cur = torch.as_tensor(res["kde"]["tokens"][:, -1:],
                          device=cache["k"].device)
    step = {name: make_decode_step(cfg, impl=name, kde_cfg=dict(
        top_p=args["kde"].kde_top_p, bk=args["kde"].kde_bk,
        stride=args["kde"].kde_stride)) for name in ("xla", "kde")}

    def steps8(name):
        for pos in range(steps, steps + 8):
            step[name](model, cache, cur, pos)

    walls = {}
    for name in ("xla", "kde"):
        prof = device_profile(lambda: steps8(name))
        walls[name] = [prof[0] / 8]
        log(f"[lm-serve] 8 {name} decode steps (batch {b}, cache 544), "
            f"where the time goes: " + profile_text(*prof))
    # host-bound walls spread with the machine: two more rounds in turns
    for name in ("kde", "xla", "xla", "kde"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps8(name)
        torch.cuda.synchronize()
        walls[name].append((time.perf_counter() - t0) / 8)
    mean = {n: sum(w) / len(w) for n, w in walls.items()}
    log(f"[lm-serve] decode step wall over 3 rounds of 8 steps (xla, kde, "
        f"kde, xla, xla, kde): kde {mean['kde'] * 1e3:.2f} ms "
        f"{[round(w * 1e3, 2) for w in walls['kde']]}, xla "
        f"{mean['xla'] * 1e3:.2f} ms {[round(w * 1e3, 2) for w in walls['xla']]}"
        f" (kde / xla {mean['kde'] / mean['xla']:.3f})")
    del res, cache
    free_cuda()
    return launches


def lm_bf16_prefill(model, batch):
    """Phase 12 (a): the f32 yi-6b of phase 10 rounded through bf16 in
    place, its bf16 twin from ``cast_params``; the flash prefill of the
    bf16 model (exactly 32 launches, bf16 operands), its xla (chunked)
    prefill and the f32 flash prefill of the rounded f32 model on phase
    10's tokens.  Gate: max |flash_bf16 - xla_bf16| <= max |xla_bf16 -
    f32| over the real vocab at the last position.  Returns the bf16
    model, its config and the flash launches."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import transformer as T
    from repro_torch.train.train_step import make_prefill_step
    cfg = get_config(LM_ARCH)
    assert cfg.dtype == "bfloat16", cfg.dtype     # as configured
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.to(torch.bfloat16))
    m16 = T.cast_params(model, torch.bfloat16)
    torch.cuda.synchronize()
    pairs = list(zip(model.parameters(), m16.parameters()))
    assert all(torch.equal(a, b.float()) for a, b in pairs)
    n16 = sum(p.numel() * p.element_size() for p in m16.parameters())
    n_bf16 = sum(p.dtype == torch.bfloat16 for p in m16.parameters())
    log(f"[lm-bf16] f32 weights rounded through bf16 in place, cast_params "
        f"to bf16: {n16 / 1e9:.2f} GB ({n_bf16} of {len(pairs)} tensors "
        f"bf16), {time.perf_counter() - t0:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    tokens = LM_PREFILL_SEQ * LM_PREFILL_BATCH
    fk.reset_launches()
    (flash, walls), taps = tapped(
        lambda: timed_calls(lambda: make_prefill_step(cfg, impl="flash")(
            m16, batch), 2), (fk, "flash_attention_cuda"))
    launches = fk.LAUNCHES["flash_attention"]
    assert launches == 2 * cfg.num_layers, launches
    launches //= 2
    q = taps["flash_attention_cuda"][0][0]
    assert q.dtype == torch.bfloat16 and flash.dtype == torch.float32, \
        (q.dtype, flash.dtype)
    del taps, q
    t0 = time.perf_counter()
    xla = make_prefill_step(cfg, impl="xla")(m16, batch)
    torch.cuda.synchronize()
    t_xla = time.perf_counter() - t0
    f32 = make_prefill_step(model.cfg, impl="flash")(model, batch)
    v = cfg.vocab_size
    got, want, ref = (t[:, -1, :v].double() for t in (flash, xla, f32))
    assert bool(torch.isfinite(got).all() and torch.isfinite(want).all())
    gap = float((got - want).abs().max())
    bf16_err = float((want - ref).abs().max())
    assert gap <= bf16_err, (gap, bf16_err)
    agree = float((got.argmax(-1) == want.argmax(-1)).double().mean())
    agree32 = float((got.argmax(-1) == ref.argmax(-1)).double().mean())
    log(f"[lm-bf16] (a) bf16 prefill, batch {LM_PREFILL_BATCH} x seq "
        f"{LM_PREFILL_SEQ}, {launches} flash launches (bf16 operands): "
        f"flash {walls[0]:.3f} s first, {walls[1]:.3f} s second "
        f"({tokens / walls[1]:.1f} tokens/s), xla (chunked) {t_xla:.3f} s "
        f"({tokens / t_xla:.1f} tokens/s); last-position logits: max "
        f"|flash_bf16 - xla_bf16| {gap:.4e} <= max |xla_bf16 - f32| "
        f"{bf16_err:.4e} (max |logit| {float(ref.abs().max()):.4f}); argmax "
        f"flash_bf16 = xla_bf16 on {agree:.3f}, = f32 on {agree32:.3f} of "
        f"the rows; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return m16, cfg, launches


def timed_calls(fn, n: int):
    """(last result, host seconds of each of ``n`` calls of ``fn``, each
    ending in a synchronize)."""
    import torch
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, walls


def lm_bf16_long_decode(m16, cfg, gen):
    """Phase 12 (b): the reference's long_500k KDE decode cell on the bf16
    yi-6b: a 524,288-slot bf16 cache (``init_cache``'s default) holding
    seeded synthetic K/V below LONG_FILL, then 64 ``make_decode_step(impl=
    "kde")`` steps (32 teacher-forced prompt tokens, 32 generated) at top_p
    16, bk 512, stride 16: exactly 32 x 64 kde_decode launches, finite
    logits.  Then the kernel on the final cache (layers 0, 15, 31) against
    the f32 instance on the upcast inputs (bitwise) and the plain
    pipeline, a profile of one step, and 2 dense xla steps on the same
    cache.  Returns the kde_decode launches."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels.kde_attention import kernel as kk
    from repro_torch.kernels.kde_attention import ops as kops
    from repro_torch.models import transformer as T
    from repro_torch.train.train_step import make_decode_step
    from repro_torch.roofline.analysis import H100
    dev = m16.embed.device
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.hd

    # kde vs exact on bench_attention's planted keys at this shape (before
    # the cache: exact attention expands K / V to every q-head in f32)
    q = torch.randn((1, hq, dh), generator=gen, device=dev).bfloat16()
    k = planted_keys(q, hkv, LONG_S, gen)
    v = torch.randn((1, hkv, LONG_S, dh), generator=gen,
                    device=dev).bfloat16()
    out = kops.kde_attention(q, k, v, **LONG_KDE)
    exact = kops.exact_decode_attention(q, k, v)
    rel = float((out.float() - exact.float()).abs().max()
                / exact.float().abs().max())
    log(f"[lm-bf16] (b) planted keys at S={LONG_S} (bf16 q, k, v; top_p "
        f"{LONG_KDE['top_p']}, bk {LONG_KDE['bk']}, stride "
        f"{LONG_KDE['stride']}): max |kde - exact| / max |exact| = "
        f"{rel:.4e}")
    del q, k, v, out, exact
    free_cuda()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache = T.init_cache(cfg, 1, LONG_S, device=dev)
    assert cache["k"].dtype == torch.bfloat16, cache["k"].dtype
    g = torch.Generator(device=dev).manual_seed(500)
    for name in ("k", "v"):
        for layer in cache[name]:
            layer[:, :, :LONG_FILL].normal_(generator=g)
    torch.cuda.synchronize()
    c_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    log(f"[lm-bf16] (b) cache {tuple(cache['k'].shape)} x 2 bf16 "
        f"({c_bytes / 1e9:.2f} GB), positions [0, {LONG_FILL}) synthetic "
        f"N(0, 1) K/V, {time.perf_counter() - t0:.2f} s")
    prompt = torch.as_tensor(make_batch(
        cfg, ShapeConfig("long_500k", LONG_PROMPT, 1, "prefill"), 0,
        0)["tokens"], device=dev)
    step = make_decode_step(cfg, impl="kde", kde_cfg=LONG_KDE)
    finite = torch.ones((), dtype=torch.bool, device=dev)   # no host sync
    kk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LONG_PROMPT):
        nxt, logits, cache = step(m16, cache, prompt[:, i:i + 1],
                                  LONG_FILL + i)
        finite &= torch.isfinite(logits[..., :cfg.vocab_size]).all()
    torch.cuda.synchronize()
    t_prompt = time.perf_counter() - t0
    cur = nxt[:, None]
    t0 = time.perf_counter()
    for i in range(LONG_GEN):
        nxt, logits, cache = step(m16, cache, cur,
                                  LONG_FILL + LONG_PROMPT + i)
        finite &= torch.isfinite(logits[..., :cfg.vocab_size]).all()
        cur = nxt[:, None]
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    assert bool(finite), "non-finite logits in the long_500k decode"
    launches = kk.LAUNCHES["kde_decode"]
    assert launches == cfg.num_layers * (LONG_PROMPT + LONG_GEN), launches
    peak = torch.cuda.max_memory_allocated()
    log(f"[lm-bf16] (b) long_500k KDE decode (yi-6b bf16, batch 1, cache "
        f"{LONG_S}, top_p {LONG_KDE['top_p']}, bk {LONG_KDE['bk']}, stride "
        f"{LONG_KDE['stride']}): {launches} kde_decode launches = "
        f"{cfg.num_layers} layers x {LONG_PROMPT + LONG_GEN} steps; "
        f"{LONG_PROMPT} teacher-forced steps {t_prompt:.3f} s, {LONG_GEN} "
        f"generated {t_gen:.3f} s ({LONG_GEN / t_gen:.2f} tok/s, "
        f"{t_gen / LONG_GEN * 1e3:.2f} ms a step); finite logits; peak "
        f"{peak / 1e9:.2f} GB (max_memory_allocated)")

    # where one step's time goes (the last slot rewritten: the same cache)
    last = LONG_S - 1
    wall, busy, _, names = device_profile(
        lambda: step(m16, cache, cur, last), top=100000)   # every kernel
    q = torch.randn((1, hq, dh), generator=gen, device=dev).bfloat16()
    ck, cv = cache["k"][0], cache["v"][0]
    kw = dict(LONG_KDE, kv_valid=LONG_S)
    grid = kk.decode_grid(q, ck, cv, top_p=kw["top_p"], bk=kw["bk"],
                          stride=kw["stride"])
    b_ms, b_by = decode_bound(q, ck, kw, kk.kde_decode_plain(
        q, ck, cv, with_est=True, **kw)[1])
    w_bytes = sum(p.numel() * p.element_size() for n, p in
                  m16.named_parameters() if n != "embed")
    if busy == 0.0:
        log(f"[lm-bf16] (b) one decode step: wall {wall * 1e3:.2f} ms; "
            f"device time not measured (the trace shows none)")
    else:
        kde = [(t, c) for n, t, c in names
               if any(k in n for k in KDE_KERNELS)]
        gemm = sum(t for n, t, _ in names if any(
            w in n.lower() for w in ("gemv", "gemm", "xmma", "cutlass", "nvjet")))
        kde_ms = sum(t for t, _ in kde) / max(1, sum(c for _, c in kde)) * 1e3
        log(f"[lm-bf16] (b) one decode step at S={LONG_S}: wall "
            f"{wall * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms (idle "
            f"share {1 - busy / wall:.1%}); kde_decode {kde_ms:.4f} ms a "
            f"launch x {sum(c for _, c in kde)} (bound {b_ms:.5f} ms by "
            f"{b_by}; {grid_text(grid)}"
            f"); GEMM / GEMV kernels {gemm * 1e3:.3f} ms against the weights' "
            f"{w_bytes / 1e9:.2f} GB / 3.35 TB/s = "
            f"{w_bytes / H100.hbm_bw * 1e3:.3f} ms; top kernels: " + "; ".join(
                f"{n[:50]} {t * 1e3:.3f} ms x{c}" for n, t, c in names[:6]))

    # the bf16 kernel on the final cache: bitwise the f32 instance on the
    # upcast inputs, against the plain pipeline at phase 2's tolerances
    err = 0.0
    for layer in LM_KDE_LAYERS:
        ck, cv = cache["k"][layer], cache["v"][layer]
        e = decode_bf16_check(q, ck, cv, kw, f"long_500k layer {layer}")
        err = max(err, e)
        log(f"[lm-bf16] (b) final cache layer {layer}: kde_decode bf16 = f32 "
            f"instance on upcast inputs (bitwise, out and est); vs plain "
            f"pipeline max abs err {e:.3e}")
    free_cuda()

    # two dense steps on the same cache: the logits of the kde step of
    # the same token at the same slot against xla's (reported, not gated)
    _, kde_logits, cache = step(m16, cache, cur, last)
    xla_step = make_decode_step(cfg, impl="xla")
    xla_logits, walls = None, []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, logits, cache = xla_step(m16, cache, cur, last)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        xla_logits = logits if xla_logits is None else xla_logits
        del logits
    a = kde_logits[0, -1, :cfg.vocab_size].double().cpu().numpy()
    b = xla_logits[0, -1, :cfg.vocab_size].double().cpu().numpy()
    corr = float(np.corrcoef(a, b)[0, 1])
    log(f"[lm-bf16] (b) 2 dense xla steps at S={LONG_S}: "
        f"{walls[0] * 1e3:.1f} / {walls[1] * 1e3:.1f} ms (kde step "
        f"{t_gen / LONG_GEN * 1e3:.2f} ms); logits Pearson correlation kde "
        f"vs xla {corr:.6f} (reported, not gated); argmax equal "
        f"{bool(a.argmax() == b.argmax())}; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del cache, kde_logits, xla_logits
    free_cuda()
    return launches, err


def phase_hash(data):
    """Phase 6's counted run: the hashed-KDE sparsifier."""
    import torch
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sparsify import spectral_sparsify
    t = 10 * HS_N
    t0 = time.perf_counter()
    g = spectral_sparsify(data["hs_x_np"], gaussian(HS_BW), num_edges=t,
                          estimator="hash", seed=0, batch=BATCH,
                          device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"[hash] n={HS_N} d={HS_D} t={t}: {secs:.2f} s, "
        f"{t / secs:.0f} edges/s, kernel_evals={g.kernel_evals}, "
        f"kde_queries={g.kde_queries}, status={g.status}")
    return g, secs


def block_pits(x, bn, src, dst, bw, gen, chunk=8192):
    """(2, t) randomized probability integral transforms of each
    destination v under k(u, .) restricted to v's level-1 block, v != u,
    in float64: F(v-) + r k(u, v) in index order and the mass below
    k(u, v) plus r times its ties in value order, each over the block's
    mass.  Uniform on [0, 1) exactly when the in-block draw follows the
    kernel row; a block whose row underflows to 0 is drawn uniformly over
    its live columns, as the sampler does."""
    import torch
    n, dev = x.shape[0], x.device
    t = src.numel()
    xd = x.double()
    ar = torch.arange(bn, device=dev)
    pit = torch.empty((2, t), dtype=torch.float64, device=dev)
    for lo in range(0, t, chunk):
        u, v = src[lo:lo + chunk], dst[lo:lo + chunk]
        rows = torch.arange(u.numel(), device=dev)
        base = v // bn * bn
        cols = base[:, None] + ar
        live = (cols < n) & (cols != u[:, None])
        kv = torch.exp(-((xd[u][:, None, :] - xd[cols.clamp(max=n - 1)])
                         ** 2).sum(-1) / bw ** 2)
        kv = torch.where(live, kv, 0.0)
        kv = torch.where((kv.sum(1) > 0)[:, None], kv, live.double())
        j = v - base
        kuv = kv[rows, j]
        tot = kv.sum(1)
        r = torch.rand((2, u.numel()), generator=gen, device=dev,
                       dtype=torch.float64)
        below_idx = torch.cumsum(kv, dim=1)[rows, j] - kuv
        below_val = torch.where(kv < kuv[:, None], kv, 0.0).sum(1)
        ties = torch.where(kv == kuv[:, None], kv, 0.0).sum(1)
        pit[0, lo:lo + chunk] = (below_idx + r[0] * kuv) / tot
        pit[1, lo:lo + chunk] = (below_val + r[1] * ties) / tot
    return pit


def hash_edge_law(x, bn, g, bw=HS_BW):
    """Chi-square checks (alpha 1e-3) of the hashed sparsifier's edges:
    sources per level-1 block against the hashed degrees ``g.degrees`` the
    run drew them from, and each destination's in-block PIT (index order,
    value order) against the uniform.  The block a destination was drawn
    from follows the row's hashed block estimates, which the run does not
    keep: that draw is held against the reference on the CPU only
    (tests/test_torch_hash_pipeline.py, shared noise)."""
    import torch
    n, dev = x.shape[0], x.device
    src = torch.as_tensor(g.src, device=dev)
    dst = torch.as_tensor(g.dst, device=dev)
    t = src.numel()
    nb = -(-n // bn)
    deg = torch.as_tensor(g.degrees, dtype=torch.float64, device=dev)
    blk_mass = torch.zeros(nb, dtype=torch.float64, device=dev)
    blk_mass.index_add_(0, torch.arange(n, device=dev) // bn, deg)
    got = torch.bincount(src // bn, minlength=nb).double()
    texts = [chi2_test(got, t * blk_mass / blk_mass.sum(), "sources")]
    gen = torch.Generator(device=dev).manual_seed(1)
    pit = block_pits(x, bn, src, dst, bw, gen)
    for row, what in zip(pit, ("destinations, index order",
                               "destinations, value order")):
        got = torch.histc(row, bins=PIT_BINS, min=0.0, max=1.0).double()
        texts.append(chi2_test(got, torch.full_like(got, t / PIT_BINS),
                               what))
    return "; ".join(texts)


def spectral_error(lap_g, lap, probes: int = 24, seed: int = 1) -> float:
    """The reference bench's spectral error (benchmarks/bench_kde.py):
    max |v^T L_G v / v^T L v - 1| over centred Gaussian probes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((lap.shape[0], probes))
    v -= v.mean(0)
    ratios = np.einsum("ij,ij->j", v, lap_g @ v) / \
        np.einsum("ij,ij->j", v, lap @ v)
    return float(np.abs(ratios - 1.0).max())


def hs_exact_degrees(data):
    """deg(u) = sum_{v != u} k(u, v) over the hash phase's data by the
    blocksum kernel, float64 numpy; computed once, off every counted
    run."""
    import torch
    from repro_torch.kernels.kde_rowsum import kernel as rk
    if "hs_exact" not in data:
        x, bn = data["hs_x"], data["hs_bs"]
        data["hs_exact"] = torch.cat([
            rk.blocksum_cuda(x[lo:lo + BATCH].contiguous(), x, "gaussian",
                             1.0 / HS_BW, 1.0, bn).double().sum(1)
            for lo in range(0, x.shape[0], BATCH)]).cpu().numpy() - 1.0
    return data["hs_exact"]


def degree_check(data, deg, name: str) -> str:
    """Sum of the degrees a run drew its sources from within HS_DEG_RTOL
    of the exact sum; returns the log text."""
    import numpy as np
    exact = hs_exact_degrees(data)
    rel = abs(deg.sum() - exact.sum()) / exact.sum()
    per_row = np.abs(deg - exact) / exact
    assert rel <= HS_DEG_RTOL, (name, rel)
    return (f"sum {name} {deg.sum():.6e} vs exact {exact.sum():.6e}: rel "
            f"err {rel:.3e} (bound {HS_DEG_RTOL}); per-row rel err median "
            f"{np.median(per_row):.3e}, p99 {np.quantile(per_row, 0.99):.3e}")


def spec_config_error(**kw) -> float:
    """The spectral error of ``spectral_sparsify(**kw)`` at the reference
    bench's spectral config (SPEC_*, t = 16n, seed 0) on the card."""
    import numpy as np
    import torch
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sparsify import spectral_sparsify
    xs = np.random.default_rng(0).normal(
        0, SPEC_SIGMA, (SPEC_N, SPEC_D)).astype(np.float32)
    gs = spectral_sparsify(xs, gaussian(SPEC_BW), num_edges=16 * SPEC_N,
                           seed=0, batch=BATCH, device="cuda", **kw)
    xd = torch.as_tensor(xs, device="cuda").double()
    k = torch.exp(-torch.cdist(xd, xd) ** 2 / SPEC_BW ** 2)
    k.fill_diagonal_(0.0)
    lap = (torch.diag(k.sum(1)) - k).cpu().numpy()
    return spectral_error(gs.laplacian_dense(), lap)


def hash_checks(data, g):
    """Checks 1-5 of the hash phase, off the counted run."""
    import numpy as np
    from repro_torch.ft import guards
    from repro_torch.kernels.kde_hash.ref import lookup_buckets
    x, bn, n = data["hs_x"], data["hs_bs"], HS_N
    state, cw = data["hs_state"], data["hs_cw"]
    # (1) device hashing parity with the host build, all n rows
    b, hit = lookup_buckets(x, state, cw)
    assert bool(hit.all()), f"{int((~hit).sum())} rows miss their bucket"
    assert bool((b == state.point_bucket).all()), "bucket ids differ"
    log(f"[hash] (1) device hashing reproduces point_bucket for all {n} "
        f"rows: {state.keys.numel()} buckets, "
        f"{int(state.truncated.sum())} truncated at {HS_MAX_BUCKET}")
    # (2) the hashed degrees the run drew its sources from, against the
    # exact degrees
    log(f"[hash] (2) {degree_check(data, g.degrees, 'deg_hash')}")
    # (3) status and the reference's counter formulas
    t = 10 * n
    drawn = -(-t // BATCH) * BATCH
    nb = -(-n // bn)
    near = int(state.counts[state.point_bucket].sum())
    want = (near + n * HS_NUM_FAR
            + drawn * (HS_MAX_BUCKET + nb * HS_FAR_PER_BLOCK + bn + 1))
    assert not (g.status & guards.FATAL), guards.decode_status(g.status)
    assert g.kernel_evals == want, (g.kernel_evals, want)
    assert g.kde_queries == n + drawn, g.kde_queries
    assert g.num_edges == t and np.all(np.isfinite(g.weight))
    log(f"[hash] (3) status {guards.decode_status(g.status)} (no fatal "
        f"flag); kernel_evals {g.kernel_evals} = NEAR {near} + n*{HS_NUM_FAR}"
        f" + drawn*({HS_MAX_BUCKET} + {nb}*{HS_FAR_PER_BLOCK} + {bn} + 1); "
        f"kde_queries {g.kde_queries} = n + drawn")
    # (4) the edge law
    log(f"[hash] (4) edge law of the {g.num_edges} drawn edges: "
        f"{hash_edge_law(x, bn, g)} (alpha 1e-3)")
    # (5) spectral error at the reference bench's spectral config
    err = spec_config_error(estimator="hash")
    log(f"[hash] (5) spectral error n={SPEC_N} d={SPEC_D} t={16 * SPEC_N}: "
        f"{err:.6f} (bound {SPEC_BOUND:.6f})")
    assert err <= SPEC_BOUND, err


def hash_breakdown(data):
    """CUDA-event ms of the stages of one hashed edge batch (m = 1024
    frontier rows) on the hash phase's layout: the frontier gather (its
    (m, B far_per_block, max_bucket) collision mask alone too), the
    weighted-kv kernel, the block-sum scatter, and a whole fused edge
    batch."""
    import torch
    from repro_torch.kernels.kde_hash import kernel as hk
    from repro_torch.kernels.kde_hash import ops as hops
    from repro_torch.kernels.kde_hash import ref as href
    from repro_torch.kernels.kde_sampler import ops as sops
    from repro_torch.kernels.kde_sampler.ref import block_views
    x, state, bn = data["hs_x"], data["hs_state"], data["hs_bs"]
    n = x.shape[0]
    nb = -(-n // bn)
    dev = x.device
    gen = torch.Generator(device=dev).manual_seed(5)
    src = torch.randint(0, n, (BATCH,), generator=gen, device=dev)
    off = hops.draw_frontier_noise(BATCH, nb, HS_FAR_PER_BLOCK, bn, gen, dev)
    fidx = (torch.arange(nb, dtype=torch.int32, device=dev)[None, :, None]
            * bn + off).reshape(BATCH, -1)
    b = state.point_bucket[src]
    mem = state.members[b]
    mvalid = (torch.arange(mem.shape[1], device=dev)[None, :]
              < state.counts[b][:, None])
    cols, wgt, _, _ = href.frontier_gather(src, state, off,
                                           HS_FAR_PER_BLOCK, bn, nb, n)
    kv = hk.weighted_kv_cuda(x[src], x, cols, wgt, "gaussian", 1.0 / HS_BW)
    cdf = torch.linspace(0, 1, n + 1, device=dev)[1:]
    degs = torch.ones(n, device=dev)
    x_sq = torch.sum(x * x, -1)
    views = block_views(x, x_sq, bn)
    noise = sops.draw_edge_noise(BATCH, nb, gen, dev, level1="hash",
                                 exact=False, num_far=HS_FAR_PER_BLOCK,
                                 block_size=bn)
    cfg = dict(kind="gaussian", inv_bw=1.0 / HS_BW, beta=1.0, pairwise=None,
               block_size=bn, num_blocks=nb, n=n, s=16, exact=False,
               level1="hash", num_far=HS_FAR_PER_BLOCK)
    stages = {
        "frontier_gather": lambda: href.frontier_gather(
            src, state, off, HS_FAR_PER_BLOCK, bn, nb, n),
        "far_collide mask": lambda: href._far_collide(fidx, mem, mvalid),
        "weighted_kv kernel": lambda: hk.weighted_kv_cuda(
            x[src], x, cols, wgt, "gaussian", 1.0 / HS_BW),
        "scatter_block_sums": lambda: href.scatter_block_sums(
            kv, cols, src, state, HS_FAR_PER_BLOCK, bn, nb),
        "fused edge batch": lambda: sops.fused_edge_batch(
            x, x_sq, cdf, degs, 1.0 / n, 1.0 / n, *noise, views=views,
            hstate=state, **cfg),
    }
    return {k: timed(fn, 20) for k, fn in stages.items()}


def phase_stratified(data):
    """Phase 7's counted run: the reference's default sparsifier,
    ``spectral_sparsify(x, k, t)`` with no estimator argument."""
    import torch
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sparsify import spectral_sparsify
    t = 10 * HS_N
    t0 = time.perf_counter()
    g = spectral_sparsify(data["hs_x_np"], gaussian(HS_BW), t)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"[stratified] n={HS_N} d={HS_D} t={t}: {secs:.2f} s, "
        f"{t / secs:.0f} edges/s, kernel_evals={g.kernel_evals}, "
        f"kde_queries={g.kde_queries}, status={g.status}")
    return g, secs


def strat_checks(data, g):
    """Checks 1-4 of the stratified phase, off the counted run."""
    import numpy as np
    from repro_torch.ft import guards
    x, bn, n = data["hs_x"], data["hs_bs"], HS_N
    nb = -(-n // bn)
    t = 10 * n
    drawn = -(-t // BATCH) * BATCH
    # (1) status and the reference's counter formulas
    assert not (g.status & guards.FATAL), guards.decode_status(g.status)
    assert g.kernel_evals == n * nb * ST_S + drawn * (nb * ST_S + bn + 1), \
        g.kernel_evals
    assert g.kde_queries == n + drawn, g.kde_queries
    assert g.num_edges == t and np.all(np.isfinite(g.weight))
    log(f"[stratified] (1) status {guards.decode_status(g.status)} (no "
        f"fatal flag); kernel_evals {g.kernel_evals} = n*{nb}*{ST_S} + "
        f"drawn*({nb}*{ST_S} + {bn} + 1); kde_queries {g.kde_queries} = "
        f"n + drawn")
    # (2) the stratified degrees the run drew its sources from
    log(f"[stratified] (2) {degree_check(data, g.degrees, 'deg_strat')}")
    # (3) the edge law: level 2 is exact, the block law estimated
    log(f"[stratified] (3) edge law of the {g.num_edges} drawn edges: "
        f"{hash_edge_law(x, bn, g)} (alpha 1e-3)")
    # (4) spectral error at the reference bench's spectral config
    err = spec_config_error()
    log(f"[stratified] (4) spectral error n={SPEC_N} d={SPEC_D} "
        f"t={16 * SPEC_N}: {err:.6f} (bound {STRAT_SPEC_BOUND:.6f})")
    assert err <= STRAT_SPEC_BOUND, err


def strat_breakdown(data):
    """CUDA-event ms of the stages of one stratified edge batch (m = 1024
    frontier rows) on the stratified phase's data, each the path's own
    function: the subsample's top-k, the (m, B s) read with its gather,
    the inverse-CDF block draw, the exact level 2, and a whole fused edge
    batch."""
    import torch
    from repro_torch.kernels.kde_sampler import ops as sops
    from repro_torch.kernels.kde_sampler import ref as sref
    x, bn = data["hs_x"], data["hs_bs"]
    n = x.shape[0]
    nb = -(-n // bn)
    dev = x.device
    inv = 1.0 / HS_BW
    gen = torch.Generator(device=dev).manual_seed(6)
    src = torch.randint(0, n, (BATCH,), generator=gen, device=dev)
    x_sq = torch.sum(x * x, -1)
    u = torch.rand((nb, bn), generator=gen, device=dev)
    shape = dict(block_size=bn, num_blocks=nb, n=n, s=ST_S)
    cfg = dict(kind="gaussian", inv_bw=inv, beta=1.0, **shape)
    q = x[src]
    bs, _ = sops.masked_block_sums(x, x_sq, src, u, exact=False,
                                   pairwise=None, **cfg)
    u_blk = torch.rand(BATCH, generator=gen, device=dev)
    u_in = torch.rand(BATCH, generator=gen, device=dev)
    blk, _ = sref.choose_block(bs, u_blk)
    views = sref.block_views(x, x_sq, bn)
    cdf = torch.linspace(0, 1, n + 1, device=dev)[1:]
    degs = torch.ones(n, device=dev)
    noise = sops.draw_edge_noise(BATCH, nb, gen, dev, exact=False,
                                 block_size=bn)
    stages = {
        "subsample top-k": lambda: sops.stratified_columns(u, **shape),
        f"({BATCH} x {nb * ST_S}) read, gather included":
            lambda: sops.stratified_block_sums(q, x, x_sq, u, **cfg),
        "block draw": lambda: sref.choose_block(bs, u_blk),
        "level 2": lambda: sref.level2_draw(*sref.level2_row(
            x, x_sq, views, src, blk, "gaussian", inv, 1.0, bn, n), u_in),
        "fused edge batch": lambda: sops.fused_edge_batch(
            x, x_sq, cdf, degs, 1.0 / n, 1.0 / n, *noise, views=views,
            exact=False, pairwise=None, **cfg),
    }
    return {k: timed(fn, 20) for k, fn in stages.items()}


# ------------------------------------------------------------------ bf16
def bf16_bound(pairs: int, d: int, nbytes: float, f32_extra: float = 0.0):
    """bound() of a gaussian bf16 call over ``pairs`` pairs: the cross
    term's 2d operations a pair have bf16 operands (tensor-core rate);
    the finish's 6 a pair (and ``f32_extra``) are f32."""
    return bound(6 * pairs + f32_extra, nbytes, bf16_flops=2 * d * pairs)


def table_bytes(q, x, inv_bw, chunk=1024) -> int:
    """Bytes of the exp table a gaussian bf16 call on these inputs needs:
    4 for each distinct bf16 argument among its pairs (x (n, d), or
    gathered rows (m, t, d) chunked with q)."""
    import torch
    from repro_torch.kernels.kde_sampler.ref import bf16_bits, round_bf16
    seen = torch.zeros(65536, dtype=torch.bool, device=q.device)
    for lo in range(0, q.shape[0], chunk):
        qf = round_bf16(q[lo:lo + chunk])
        xf = round_bf16(x[lo:lo + chunk] if x.dim() == 3 else x)
        cross = torch.einsum("wd,wtd->wt", qf, xf) if xf.dim() == 3 \
            else qf @ xf.T
        d2 = (qf * qf).sum(-1, keepdim=True) + (xf * xf).sum(-1) - 2 * cross
        seen[bf16_bits(-d2.clamp(min=0.0) * (inv_bw * inv_bw))] = True
    return 4 * int(seen.sum())


def bf16_kernel_checks(gen):
    """(a), ragged part: every bf16 entry point against its plain version
    on the card, every L2 kind, at the ragged shapes (m=37, n=301, d=19,
    bn=70; kde_hash m=37, t=45), the wide tile (d = 8, 32), the deep tile
    (d = 36, 784) and views off 16 bytes; one-column blocks (every kernel
    value of the tile: equal to the plain value wherever the flip slack
    is 0); dyadic points (exact in bf16 and f32: no slack) with planted
    ties in sample_block; sample_block calls of several row counts in a
    row.  Returns the max abs error per kernel."""
    import torch
    from repro_torch.kernels.kde_hash import kernel as hk
    from repro_torch.kernels.kde_rowsum import kernel as rk
    from repro_torch.kernels.kde_sampler import kernel as sk
    from repro_torch.kernels.kde_sampler.ops import gumbel
    from repro_torch.kernels.kde_sampler.ref import (bf16_flip_slack,
                                                     round_bf16)
    dev = torch.device("cuda")
    errs = {k: 0.0 for k in BF16_NAMES}

    def note(name, err):
        errs[name] = max(errs[name], err)

    def misaligned(a):
        view = torch.empty(a.numel() + 1, device=dev)[1:]
        return view.view(a.shape).copy_(a)

    for kind, d, view in [(k, 19, False) for k in L2_KINDS] + [
            ("gaussian", 8, False), ("exponential", 32, False),
            ("rational_quadratic", 36, False), ("gaussian", 784, False),
            ("exponential", 16, True), ("gaussian", 784, True)]:
        m, n, bn = 37, 301, 70
        q = torch.randn(m, d, generator=gen, device=dev) * 0.3
        x = torch.randn(n, d, generator=gen, device=dev) * 0.3
        if view:
            q, x = misaligned(q), misaligned(x)
        inv_bw = 1.0 / (0.4 * d ** 0.5)
        own = torch.randint(-1, -(-n // bn), (m,), generator=gen, device=dev)
        g = gumbel((m, -(-n // bn)), gen, dev)
        tag = f"{kind} d={d} ragged{' misaligned' if view else ''}"
        slack = bf16_flip_slack(q, x, kind, inv_bw)
        bsl = bf16_flip_slack(q, x, kind, inv_bw, bn)
        a = (kind, inv_bw, 0.7)
        note("rowsum_bf16", close(
            rk.rowsum_cuda(q, x, *a, "bf16"), rk.rowsum_plain(q, x, *a, "bf16"),
            f"rowsum bf16 {tag}", slack=slack.sum(1)))
        note("blocksum_bf16", close(
            rk.blocksum_cuda(q, x, *a, bn, "bf16"),
            rk.blocksum_plain(q, x, *a, bn, "bf16"), f"blocksum bf16 {tag}",
            slack=bsl))
        one = rk.blocksum_cuda(q, x, *a, 1, "bf16")
        one_plain = rk.blocksum_plain(q, x, *a, 1, "bf16")
        if kind != "rational_quadratic":
            assert torch.equal(one[slack == 0], one_plain[slack == 0]), \
                f"blocksum bf16 one-column {tag}: values differ off the slack"
        close(one, one_plain, f"blocksum bf16 one-column {tag}", slack=slack)
        note("masked_blocksum_bf16", close(
            sk.masked_blocksum_cuda(q, x, own, *a, bn, "bf16"),
            sk.masked_blocksum_plain(q, x, own, *a, bn, "bf16"),
            f"masked_blocksum bf16 {tag}", slack=bsl))
        got = sk.sample_block_cuda(q, x, own, g, *a, bn, "bf16")
        want = sk.sample_block_plain(q, x, own, g, *a, bn, "bf16")
        note("sample_block_bf16", check_sample_block_bf16(got, want, g, bsl,
                                                          tag))
        log(f"[bf16] {tag} m={m} n={n} bn={bn}: ok (rowsum / blocksum tile "
            f"{rk._cached_plan(q, x, kind, inv_bw, 0.7, bn, 'bf16')[0].instance}"
            f"; {int((slack > 0).sum())} of {slack.numel()} pairs within "
            f"the f32 error of a bf16 midpoint; one-column blocks equal off "
            f"them)")

    # the tensor-core rowsum / blocksum at the short tile's edge: m = 64
    # (one short tile: two warps a row slice split each chunk's columns)
    # and m = 65 (one full tile, one short); ragged, full and one-column
    # blocks; two calls bitwise equal
    for m, d, bn in ((64, 16, 70), (65, 16, 70), (64, 32, 256),
                     (65, 32, 256), (64, 8, 1), (65, 8, 1)):
        n = 3000
        q = torch.randn(m, d, generator=gen, device=dev) * 0.3
        x = torch.randn(n, d, generator=gen, device=dev) * 0.3
        inv_bw = 1.0 / (0.4 * d ** 0.5)
        for kind in L2_KINDS:
            a = (kind, inv_bw, 0.7)
            slack = bf16_flip_slack(q, x, kind, inv_bw)
            for b in (None, bn):
                inst = rk._cached_plan(q, x, *a, b, "bf16")[0].instance
                assert inst == sk.MMA + (16 if d <= 16 else 32), (m, d, inst)
            tag = f"{kind} m={m} d={d} bn={bn} (tensor-core tile)"
            got = rk.rowsum_cuda(q, x, *a, "bf16")
            note("rowsum_bf16", close(got, rk.rowsum_plain(q, x, *a, "bf16"),
                                      f"rowsum bf16 {tag}",
                                      slack=slack.sum(1)))
            assert torch.equal(got, rk.rowsum_cuda(q, x, *a, "bf16")), \
                f"rowsum bf16 {tag}: two calls differ"
            got = rk.blocksum_cuda(q, x, *a, bn, "bf16")
            want = rk.blocksum_plain(q, x, *a, bn, "bf16")
            note("blocksum_bf16", close(
                got, want, f"blocksum bf16 {tag}",
                slack=bf16_flip_slack(q, x, kind, inv_bw, bn)))
            assert torch.equal(got, rk.blocksum_cuda(q, x, *a, bn, "bf16")), \
                f"blocksum bf16 {tag}: two calls differ"
            if bn == 1 and kind != "rational_quadratic":
                assert torch.equal(got[slack == 0], want[slack == 0]), \
                    f"blocksum bf16 one-column {tag}: values differ off the slack"
        log(f"[bf16] rowsum / blocksum m={m} n={n} d={d} bn={bn} on the "
            f"tensor-core tile ({'short' if m <= 64 else 'full + short'} "
            f"query tiles): every L2 kind within the flip slack, two calls "
            f"bitwise equal")

    for kind, d, aligned in [(k, 19, True) for k in L2_KINDS] + [
            ("gaussian", 8, True), ("exponential", 16, True),
            ("rational_quadratic", 32, True), ("gaussian", 784, True),
            ("exponential", 16, False)]:
        m, t, n = 37, 45, 301
        q = torch.randn(m, d, generator=gen, device=dev) * 0.3
        flat = torch.randn(n * d + 1, generator=gen, device=dev) * 0.3
        x = (flat[:-1] if aligned else flat[1:]).view(n, d)
        cols = torch.randint(-2, n + 2, (m, t), generator=gen,
                             dtype=torch.int32, device=dev)
        wgt = torch.rand((m, t), generator=gen, device=dev) * 256.0
        inv_bw = 1.0 / (0.4 * d ** 0.5)
        args = (q, x, cols, wgt, kind, inv_bw, 0.7)
        sl = bf16_flip_slack(q, x[cols.long().clamp(0, n - 1)], kind,
                             inv_bw) \
            * wgt.double()
        want = hk.weighted_kv_plain(*args, precision="bf16")
        note("weighted_kv_bf16", close(
            hk.weighted_kv_cuda(*args, precision="bf16"), want,
            f"weighted_kv bf16 {kind} d={d}",
            HASH_ATOL * float(want.abs().max()), slack=sl))
        want = hk.weighted_kv_sum_plain(*args, precision="bf16")
        note("weighted_kv_sum_bf16", close(
            hk.weighted_kv_sum_cuda(*args, precision="bf16"), want,
            f"weighted_kv_sum bf16 {kind} d={d}",
            HASH_ATOL * float(want.abs().max()), slack=sl.sum(1)))
        # the dataset's bf16-resident copy (off 8 bytes where x is off 16):
        # the bf16-row instances, bitwise the bf16 instances on f32 rows
        x16 = torch.empty(n * d + 1, dtype=torch.bfloat16, device=dev)[
            0 if aligned else 1:][:n * d].view(n, d).copy_(round_bf16(x))
        for fn in (hk.weighted_kv_cuda, hk.weighted_kv_sum_cuda):
            assert torch.equal(fn(q, x16, *args[2:], precision="bf16"),
                               fn(*args, precision="bf16")), \
                f"{fn.__name__} bf16 rows {kind} d={d}: not the f32 rows' bits"
        log(f"[bf16] kde_hash ragged m={m} t={t} d={d} {kind}"
            f"{'' if aligned else ', x off 16 bytes'} "
            f"[{hk.weighted_kv_plan(m, n, d, t, x.data_ptr() % 16 == 0)}]: ok;"
            f" on the bf16 copy "
            f"[{hk.weighted_kv_plan(m, n, d, t, x16.data_ptr() % 8 == 0, torch.bfloat16, 'bf16')}]"
            f": bitwise")

    # cancellation: a common offset large against the spread (qq + xx - 2c
    # keeps a few bits of the norms), queries that are dataset rows (d2 =
    # 0 against themselves); the tensor-core tile within the flip slack
    for d, off, bn in ((16, 4.0, 256), (16, 30.0, 256), (8, 100.0, 70),
                       (32, 12.0, 70), (16, 300.0, 70)):
        n, m = 4096, 300
        x = off + torch.randn(n, d, generator=gen, device=dev) * 0.5
        src = torch.randint(0, n, (m,), generator=gen, device=dev)
        q = x[src].contiguous()
        own = src // bn
        g = gumbel((m, -(-n // bn)), gen, dev)
        plan = sk.sample_block_plan(m, n, d, bn, precision="bf16")
        assert plan.instance == sk.MMA + (16 if d <= 16 else 32), plan
        with_slack = 0
        for kind in L2_KINDS:
            a = (kind, 1.0 / (0.5 * d ** 0.5), 0.7)
            bsl = bf16_flip_slack(q, x, kind, a[1], bn)
            with_slack += int((bsl > 0).sum())
            note("masked_blocksum_bf16", close(
                sk.masked_blocksum_cuda(q, x, own, *a, bn, "bf16"),
                sk.masked_blocksum_plain(q, x, own, *a, bn, "bf16"),
                f"masked_blocksum bf16 cancelling {kind} d={d} offset {off}",
                slack=bsl))
            got = sk.sample_block_cuda(q, x, own, g, *a, bn, "bf16")
            note("sample_block_bf16", check_sample_block_bf16(
                got, sk.sample_block_plain(q, x, own, g, *a, bn, "bf16"), g,
                bsl, f"cancelling {kind} d={d} offset {off}"))
            assert all(torch.equal(u, v) for u, v in zip(
                got, sk.sample_block_cuda(q, x, own, g, *a, bn, "bf16"))), \
                f"sample_block bf16 cancelling {kind}: two calls differ"
        log(f"[bf16] cancelling inputs d={d} offset {off} bn={bn} (tile "
            f"{plan.instance}): masked_blocksum and sample_block within the "
            f"flip slack, every L2 kind ({with_slack} of {3 * bsl.numel()} "
            f"block sums have slack); two calls bitwise equal")

    # dyadic points: exact in bf16, every distance exact in f32 in any
    # order, so no slack; blocks lo and hi equal, equal Gumbel noise there
    n, bn, m = 65536, 256, BATCH
    nb = n // bn
    lo, hi = 1, nb - 2
    for d in (16, 19):
        xt = torch.randint(-4, 5, (n, d), generator=gen, device=dev) / 8.0
        xt[hi * bn:(hi + 1) * bn] = xt[lo * bn:(lo + 1) * bn]
        qt = torch.randint(-4, 5, (m, d), generator=gen, device=dev) / 8.0
        own = torch.randint(-1, nb, (m,), generator=gen, device=dev)
        own[(own == lo) | (own == hi)] = -1
        g = gumbel((m, nb), gen, dev)
        g[:, lo] = g[:, hi] = 30.0
        for kind in L2_KINDS:
            a = (kind, 1.0 / (0.5 * d ** 0.5), 0.7)
            note("rowsum_bf16", close(rk.rowsum_cuda(qt, xt, *a, "bf16"),
                                      rk.rowsum_plain(qt, xt, *a, "bf16"),
                                      f"rowsum bf16 dyadic {kind} d={d}"))
            note("masked_blocksum_bf16", close(
                sk.masked_blocksum_cuda(qt, xt, own, *a, bn, "bf16"),
                sk.masked_blocksum_plain(qt, xt, own, *a, bn, "bf16"),
                f"masked_blocksum bf16 dyadic {kind} d={d}"))
            blk, _, tot, bs = sk.sample_block_cuda(qt, xt, own, g, *a, bn,
                                                   "bf16")
            assert torch.equal(bs[:, lo], bs[:, hi]), f"tie sums {kind} d={d}"
            assert bool((blk == lo).all()), (
                f"sample_block bf16 ties {kind} d={d}: "
                f"{int((blk != lo).sum())} rows did not take the lower block")
            want = sk.sample_block_plain(qt, xt, own, g, *a, bn, "bf16")
            note("sample_block_bf16", max(
                close(bs, want[3], f"sample_block bf16 ties sums {kind}"),
                close(tot, want[2], f"sample_block bf16 ties tot {kind}")))
        for m2 in (BATCH, 37, 300, 1, 129, BATCH):
            q2 = xt[torch.randint(0, n, (m2,), generator=gen, device=dev)]
            own2 = torch.randint(-1, nb, (m2,), generator=gen, device=dev)
            g2 = gumbel((m2, nb), gen, dev)
            a = ("gaussian", 1.0 / (0.5 * d ** 0.5), 1.0)
            got = sk.sample_block_cuda(q2, xt, own2, g2, *a, bn, "bf16")
            want = sk.sample_block_plain(q2, xt, own2, g2, *a, bn, "bf16")
            check_blk(got[0], want[3], g2, f"sample_block bf16 m={m2}")
            close(got[3], want[3], f"sample_block bf16 repeated m={m2}")
    log(f"[bf16] dyadic points (no slack), d = 16 / 19, every L2 kind: "
        f"rowsum, masked_blocksum and sample_block within rtol {RTOL}; "
        f"planted ties (blocks {lo} and {hi}, {m} rows) go to the lower "
        f"block; sample_block calls of m = BATCH, 37, 300, 1, 129, BATCH in "
        f"a row match (the arrival counters reset themselves)")
    return errs


def check_sample_block_bf16(got, want, g, bsl, what):
    """sample_block in bf16 against its plain version: sums and tot within
    the flip slack, the drawn block equal except where the top two plain
    scores lie within 1e-5 or within the sums' slack, p_blk against the
    plain sums at the kernel's draw."""
    import torch
    blk, pb, tot, bs = got
    _, _, rtot, rbs = want
    err = max(close(bs, rbs, f"sample_block bf16 sums {what}", slack=bsl),
              close(tot, rtot, f"sample_block bf16 tot {what}",
                    slack=bsl.sum(1)))
    check_blk(blk, rbs, g, f"sample_block bf16 {what}",
              2.0 * torch.log1p(bsl / rbs.double()).max(1).values)
    pslack = (bsl.sum(1) + torch.gather(bsl, 1, blk[:, None])[:, 0]) \
        / rtot.double()
    pwant = torch.gather(rbs, 1, blk[:, None])[:, 0] / rtot
    return max(err, close(pb, pwant, f"sample_block bf16 p {what}",
                          slack=pslack))


def bf16_main_rows(data, gen, errs):
    """(a), main-path part: each bf16 kernel at the shape its path gives
    it, checked (flip slack) and timed: kernel (CUDA events, host
    included), device (torch.profiler), plain version, and the yardstick
    (``torch.cdist`` on the rounded inputs, the table finish and the sum;
    none for the kde_hash kernels).  Returns the six report rows."""
    import numpy as np
    import torch
    from repro_torch.kernels.kde_hash import kernel as hk
    from repro_torch.kernels.kde_hash import ops as hops
    from repro_torch.kernels.kde_hash import ref as href
    from repro_torch.kernels.kde_rowsum import kernel as rk
    from repro_torch.kernels.kde_sampler import kernel as sk
    from repro_torch.kernels.kde_sampler.ops import gumbel
    from repro_torch.kernels.kde_sampler.ref import (
        bf16_flip_slack, exp_bf16, round_bf16)
    dev = torch.device("cuda")
    rows = []

    def row(name, src, line, shape, fn, plain, b, lib, kernel_name, **kw):
        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=f"src/repro/kernels/{line}", shape=shape,
            ms=timed(fn, kw.get("reps", 20)),
            device_ms=kernel_device_ms(fn, kernel_name, kw.get("reps", 20)),
            plain_ms=timed(plain, 3), bound_ms=b[0], bound_by=b[1],
            library_ms=None if lib is None else timed(lib, 3),
            max_abs_err=errs[name]))

    # rowsum: the bench_kde sweep's largest batch, ExactKDE(bf16)
    rng = np.random.default_rng(0)
    xr = torch.as_tensor(rng.normal(0, 0.5, (SWEEP_N[-1], SWEEP_D))
                         .astype(np.float32), device=dev)
    qr = torch.as_tensor(rng.normal(0, 0.5, (SWEEP_M, SWEEP_D))
                         .astype(np.float32), device=dev)
    inv = 1.0 / SWEEP_BW
    a = ("gaussian", inv, 1.0)
    errs["rowsum_bf16"] = max(errs["rowsum_bf16"], close(
        rk.rowsum_cuda(qr, xr, *a, "bf16"), rk.rowsum_plain(qr, xr, *a, "bf16"),
        "rowsum bf16 main", slack=bf16_flip_slack(qr, xr, "gaussian", inv).sum(1)))
    qb, xb = round_bf16(qr), round_bf16(xr)
    m, n, d = SWEEP_M, SWEEP_N[-1], SWEEP_D
    row("rowsum_bf16", "kde_rowsum.cu", "kde_rowsum/kernel.py:137",
        f"m={m} n={n} d={d} gaussian bw {SWEEP_BW}",
        lambda: rk.rowsum_cuda(qr, xr, *a, "bf16"),
        lambda: rk.rowsum_plain(qr, xr, *a, "bf16"),
        bf16_bound(m * n, d, 4 * (m * d + n * d + m)
                   + table_bytes(qr, xr, inv)),
        lambda: exp_bf16(torch.cdist(qb, xb).square_().mul_(-inv * inv))
        .sum(1), "")
    plan, kshape = rk._cached_plan(qr, xr, *a, None, "bf16")
    rows[-1]["instance"] = plan.instance
    # one trace of both launches: the block sums' and the reduce's device ms
    traced = device_kernels(lambda: rk.rowsum_cuda(qr, xr, *a, "bf16"), 20)
    split = {k: next((us / 20 / 1e3 for name, (_, us) in traced.items()
                      if k in name and us is not None), None)
             for k in ("blocksum_mma_kernel", "rowsum_reduce_kernel")}
    share = None if None in split.values() \
        else split["rowsum_reduce_kernel"] / sum(split.values())
    rows[-1]["reduce_share"] = share
    log(f"[bf16] rowsum main: instance {plan.instance} (MMA + "
        f"{plan.instance - sk.MMA}), {plan.nb} splits of {kshape.bn} "
        f"columns; device ms {split}; the reduce's share of the row "
        f"{'not measured' if share is None else repr(share)}")
    del xr, xb

    x, bn = data["sp_x"], data["sp_bs"]
    n, d = x.shape
    nb = -(-n // bn)
    inv = 1.0 / SP_BW
    a = ("gaussian", inv, 1.0)
    xb = round_bf16(x)

    def cdist_blocks(qq):
        kv = exp_bf16(torch.cdist(round_bf16(qq), xb).square_().mul_(
            -inv * inv))
        return kv.view(qq.shape[0], nb, bn).sum(-1)

    q = x[:BATCH].contiguous()
    m = q.shape[0]
    bsl = bf16_flip_slack(q, x, "gaussian", inv, bn)
    errs["blocksum_bf16"] = max(errs["blocksum_bf16"], close(
        rk.blocksum_cuda(q, x, *a, bn, "bf16"),
        rk.blocksum_plain(q, x, *a, bn, "bf16"), "blocksum bf16 main",
        slack=bsl))
    row("blocksum_bf16", "kde_rowsum.cu", "kde_rowsum/kernel.py:169",
        f"m={m} n={n} d={d} bn={bn} gaussian",
        lambda: rk.blocksum_cuda(q, x, *a, bn, "bf16"),
        lambda: rk.blocksum_plain(q, x, *a, bn, "bf16"),
        bf16_bound(m * n, d, 4 * (m * d + n * d + m * nb)
                   + table_bytes(q, x, inv)),
        lambda: cdist_blocks(q), "blocksum")
    rows[-1]["instance"] = rk._cached_plan(q, x, *a, bn, "bf16")[0].instance
    log(f"[bf16] blocksum main: instance {rows[-1]['instance']}")

    src = data["ns_src"]
    qm = x[src].contiguous()
    own = src // bn
    mm = qm.shape[0]
    bsl = bf16_flip_slack(qm, x, "gaussian", inv, bn)
    errs["masked_blocksum_bf16"] = max(errs["masked_blocksum_bf16"], close(
        sk.masked_blocksum_cuda(qm, x, own, *a, bn, "bf16"),
        sk.masked_blocksum_plain(qm, x, own, *a, bn, "bf16"),
        "masked_blocksum bf16 main", slack=bsl))

    def cdist_masked():
        s = cdist_blocks(qm)
        s[torch.arange(mm, device=dev), own] -= 1.0
        return s.clamp_(min=1e-12)

    row("masked_blocksum_bf16", "kde_sampler.cu",
        "kde_sampler/kernel.py:90", f"m={mm} n={n} d={d} bn={bn} gaussian",
        lambda: sk.masked_blocksum_cuda(qm, x, own, *a, bn, "bf16"),
        lambda: sk.masked_blocksum_plain(qm, x, own, *a, bn, "bf16"),
        bf16_bound(mm * n, d, 4 * (mm * d + n * d + mm + mm * nb)
                   + table_bytes(qm, x, inv)),
        cdist_masked, "sampler_", reps=10)

    src = src[:BATCH]
    qs = x[src].contiguous()
    own = src // bn
    m = qs.shape[0]
    g = gumbel((m, nb), gen, dev)
    bsl = bf16_flip_slack(qs, x, "gaussian", inv, bn)
    got = sk.sample_block_cuda(qs, x, own, g, *a, bn, "bf16")
    errs["sample_block_bf16"] = max(errs["sample_block_bf16"],
                                    check_sample_block_bf16(
        got, sk.sample_block_plain(qs, x, own, g, *a, bn, "bf16"), g, bsl,
        "main"))
    per_call = launches_per_call(
        lambda: sk.sample_block_cuda(qs, x, own, g, *a, bn, "bf16"), 10)
    assert per_call == 1.0, f"sample_block bf16: {per_call} launches a call"
    log(f"[bf16] sample_block main: {per_call:.0f} device launch a call")
    row("sample_block_bf16", "kde_sampler.cu", "kde_sampler/kernel.py:129",
        f"m={m} n={n} d={d} bn={bn} gaussian",
        lambda: sk.sample_block_cuda(qs, x, own, g, *a, bn, "bf16"),
        lambda: sk.sample_block_plain(qs, x, own, g, *a, bn, "bf16"),
        bf16_bound(m * n, d, 4 * (m * d + n * d + m + 2 * m * nb + 3 * m)
                   + table_bytes(qs, x, inv), 3 * m * nb),
        None, "sampler_")

    x, state, cw = data["hs_x"], data["hs_state"], data["hs_cw"]
    n, d = x.shape
    bn = data["hs_bs"]
    nb = -(-n // bn)
    inv = 1.0 / HS_BW
    q = x[:BATCH].contiguous()
    fidx = hops.draw_query_noise(BATCH, HS_NUM_FAR, n, gen, dev)
    qcols, qwgt, _, _ = href.query_gather(q, state, fidx, cw, HS_NUM_FAR, n)
    src = torch.randint(0, n, (BATCH,), generator=gen, device=dev)
    off = hops.draw_frontier_noise(BATCH, nb, HS_FAR_PER_BLOCK, bn, gen, dev)
    fcols, fwgt, _, _ = href.frontier_gather(src, state, off,
                                             HS_FAR_PER_BLOCK, bn, nb, n)
    fq = x[src].contiguous()
    # the bf16-resident copy HashedKDE(precision="bf16") makes once
    copy_ms = timed(lambda: round_bf16(x).to(torch.bfloat16), 5)
    x16 = round_bf16(x).to(torch.bfloat16)
    log(f"[bf16] the dataset's bf16 copy: {x16.numel() * 2} bytes (n={n} "
        f"d={d}), {copy_ms!r} ms to build once (CUDA events, mean of 5), "
        f"against the f32 rows' {x.numel() * 4} bytes")
    for name, qq, cols, wgt, line, sum_out in (
            ("weighted_kv_sum_bf16", q, qcols, qwgt, 87, True),
            ("weighted_kv_bf16", fq, fcols, fwgt, 97, False)):
        kern = hk.weighted_kv_sum_cuda if sum_out else hk.weighted_kv_cuda
        plain = hk.weighted_kv_sum_plain if sum_out else hk.weighted_kv_plain
        args = (qq, x16, cols, wgt, "gaussian", inv)
        rows_g = x[cols.long()]
        sl = bf16_flip_slack(qq, rows_g, "gaussian", inv, chunk=256) \
            * wgt.double()
        want = plain(*args, precision="bf16")
        errs[name] = max(errs[name], close(
            kern(*args, precision="bf16"), want, f"{name} main",
            HASH_ATOL * float(want.abs().max()),
            slack=sl.sum(1) if sum_out else sl))
        m, t = cols.shape
        uniq = torch.unique(cols).numel()
        # bytes: q, cols, wgt and the output at 4, each distinct gathered
        # row once at 2 bytes a coordinate (4 on the f32 rows: the old
        # bound, logged beside the new one)
        fixed = 4 * (m * d + 2 * m * t + (m if sum_out else m * t)) \
            + table_bytes(qq, rows_g, inv)
        b = bf16_bound(m * t, d, fixed + 2 * uniq * d, m * t)
        log(f"[bf16] {name} bound on the bf16 rows {b[0]!r} ms ({b[1]}); "
            f"on the f32 rows "
            f"{bf16_bound(m * t, d, fixed + 4 * uniq * d, m * t)[0]!r} ms")
        row(name, "kde_hash.cu", f"kde_hash/kernel.py:{line}",
            f"m={m} t={t} d={d} gaussian, {uniq} distinct rows, bf16 copy",
            lambda: kern(*args, precision="bf16"),
            lambda: plain(*args, precision="bf16"),
            b, None, "weighted_kv", reps=50)
    return rows


def bf16_sweep():
    """(b): the reference's bench_kde precision sweep on the card, not
    cut: ExactKDE(precision="f32") against ExactKDE(precision="bf16"),
    gaussian at bandwidth 4.0, d = 16, m = 64, n = 65,536 ... 1,048,576,
    data from normal(0, 0.5) with seed 0 (x first, then q, as
    bench_kde.py).  Prints us a batch, evals/s, the bf16 / f32 time ratio
    and the max relative error, gated at 2 * BF16_REL_ERR."""
    import numpy as np
    import torch
    from repro_torch.core.kde.base import ExactKDE
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.kernels.kde_sampler.ref import BF16_REL_ERR
    for n in SWEEP_N:
        rng = np.random.default_rng(0)
        x = rng.normal(0, 0.5, (n, SWEEP_D)).astype(np.float32)
        q = torch.as_tensor(rng.normal(0, 0.5, (SWEEP_M, SWEEP_D))
                            .astype(np.float32), device="cuda")
        per = {}
        for prec in ("f32", "bf16"):
            est = ExactKDE(x, gaussian(SWEEP_BW), precision=prec,
                           device="cuda")
            ms = timed(lambda: est.query(q), 20)
            per[prec] = (ms, est.query(q).double())
        rel = float((per["bf16"][1] / per["f32"][1] - 1.0).abs().max())
        ratio = per["bf16"][0] / per["f32"][0]
        text = ", ".join(
            f"{p} {ms * 1e3:.2f} us a batch ({n * SWEEP_M / (ms * 1e-3):.4e} "
            f"evals/s)" for p, (ms, _) in per.items())
        log(f"[bf16] sweep n={n}: {text}; bf16 / f32 time {ratio:.4f}; max "
            f"rel err {rel:.4e} (bound {2 * BF16_REL_ERR})")
        assert rel <= 2 * BF16_REL_ERR, (n, rel)


def bf16_sparsify(x_np, bw, t, **sampler_kw):
    """Alg 5.1 in bf16 from the public classes, as ``spectral_sparsify``
    builds it (which takes no ``precision``): a ``NeighborSampler(...,
    precision="bf16")`` (seed 2, so the hashed layout is phase 6's), a
    ``DegreeSampler`` over its own level-1 structure (the exact blocks or
    the hash estimator) and its ``edge_batches``.  Returns the graph's
    fields as a namespace, with the run's seconds."""
    import types
    import numpy as np
    import torch
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sampling.edge import NeighborSampler
    from repro_torch.core.sampling.vertex import DegreeSampler
    t0 = time.perf_counter()
    nbr = NeighborSampler(x_np, gaussian(bw), seed=2, precision="bf16",
                          device="cuda", **sampler_kw)
    est = nbr.hash_estimator if nbr.level1 == "hash" else nbr.blocks
    deg = DegreeSampler(est, seed=1)
    u, v, w, q_uv, _ = nbr.edge_batches(deg.cdf_device, deg.degrees_device,
                                        deg.total, t, batch=BATCH)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return types.SimpleNamespace(
        src=u.astype(np.int64), dst=v.astype(np.int64), weight=w,
        q_uv=q_uv, degrees=deg.degrees, num_edges=len(u), secs=secs,
        kernel_evals=nbr.evals + (0 if est is nbr.blocks else est.evals),
        status=nbr.status | est.device_counters.status, nbr=nbr)


def bf16_exact_path(data):
    """(c): the exact sparsifier in bf16 on phase 3's data and
    configuration, then ``prob_of`` on a fresh bf16 sampler (the
    masked-blocksum kernel).  Returns (graph, launches)."""
    import numpy as np
    import torch
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sampling.edge import NeighborSampler
    from repro_torch.ft import guards
    from repro_torch.kernels.kde_rowsum import kernel as rk
    from repro_torch.kernels.kde_sampler import kernel as sk
    n, bs, t = SP_N, data["sp_bs"], 10 * SP_N
    rk.reset_launches()
    sk.reset_launches()
    g = bf16_sparsify(data["sp_x_np"], SP_BW, t, exact_blocks=True)
    fresh = NeighborSampler(data["sp_x"], gaussian(SP_BW), exact_blocks=True,
                            seed=4, precision="bf16", device="cuda")
    p = fresh.prob_of(g.src[:NS_FRONTIER], g.dst[:NS_FRONTIER])
    launches = {**rk.LAUNCHES, **sk.LAUNCHES}
    np.testing.assert_allclose(p, g.q_uv[:NS_FRONTIER], rtol=1e-4)
    drawn = -(-t // BATCH) * BATCH
    assert g.kernel_evals == n * n + drawn * (n + bs + 1), g.kernel_evals
    assert not (g.status & guards.FATAL), guards.decode_status(g.status)
    assert g.num_edges == t and np.all(np.isfinite(g.weight))
    log(f"[bf16] (c) exact sparsifier n={n} d={SP_D} t={t}: {g.secs:.2f} s, "
        f"{t / g.secs:.0f} edges/s, kernel_evals {g.kernel_evals} = n^2 + "
        f"drawn*(n + {bs} + 1), status {guards.decode_status(g.status)}; "
        f"prob_of on a fresh bf16 sampler reproduces q_uv of {NS_FRONTIER} "
        f"edges; launches {launches}")
    want = {"blocksum_bf16": n // BATCH, "sample_block_bf16": drawn // BATCH,
            "masked_blocksum_bf16": 1}
    assert launches == {**{k: 0 for k in launches}, **want}, launches
    return g, launches


def bf16_exact_checks(data, g):
    """(c)'s checks, off the counted run: the bf16 degrees against the
    exact f32 ones, and the edge law (sources against the bf16 degrees the
    run drew them from, destinations by the block-restricted PITs; level 2
    is exact f32)."""
    from repro_torch.kernels.kde_sampler.ref import BF16_REL_ERR
    exact = exact_degrees(data["sp_x"], 1.0 / SP_BW).cpu().numpy()
    rel = abs(g.degrees.sum() - exact.sum()) / exact.sum()
    log(f"[bf16] (c) sum deg(bf16) {g.degrees.sum():.6e} vs exact f32 "
        f"{exact.sum():.6e}: rel err {rel:.3e} (bound {2 * BF16_REL_ERR})")
    assert rel <= 2 * BF16_REL_ERR, rel
    log(f"[bf16] (c) edge law of the {g.num_edges} drawn edges: "
        f"{hash_edge_law(data['sp_x'], data['sp_bs'], g, SP_BW)} "
        f"(alpha 1e-3)")


def gathered_rows(fn):
    """(fn's result, the set of (dtype, data_ptr) of the dataset every
    weighted-kv(-sum) launch made during ``fn`` gathered from)."""
    from repro_torch.kernels.kde_hash import kernel as hk
    seen, saved = set(), []

    def spy(orig):
        def call(q, x, *a, **kw):
            seen.add((x.dtype, x.data_ptr()))
            return orig(q, x, *a, **kw)
        return call

    for attr in ("weighted_kv_cuda", "weighted_kv_sum_cuda"):
        saved.append((attr, getattr(hk, attr)))
        setattr(hk, attr, spy(getattr(hk, attr)))
    try:
        out = fn()
    finally:
        for attr, orig in saved:
            setattr(hk, attr, orig)
    return out, seen


def bf16_hash_path(data):
    """(d): the hashed sparsifier in bf16 on phase 6's data (the reference's
    hash defaults, degrees from the sampler's own hash estimator, t = 10n).
    Every weighted launch gathers the estimator's bf16 copy of the dataset.
    Returns (graph, launches)."""
    import torch
    from repro_torch.kernels.kde_hash import kernel as hk
    hk.reset_launches()
    g, rows = gathered_rows(lambda: bf16_sparsify(
        data["hs_x_np"], HS_BW, 10 * HS_N, level1="hash"))
    launches = dict(hk.LAUNCHES)
    copy = g.nbr.hash_estimator.state.x_bf16
    log(f"[bf16] (d) hashed sparsifier n={HS_N} d={HS_D} t={10 * HS_N}: "
        f"{g.secs:.2f} s, {10 * HS_N / g.secs:.0f} edges/s, kernel_evals "
        f"{g.kernel_evals}, status {g.status}; launches {launches}")
    want = {"weighted_kv_sum_bf16": HS_N // BATCH,
            "weighted_kv_bf16": -(-10 * HS_N // BATCH)}
    assert launches == {**{k: 0 for k in launches}, **want}, launches
    assert rows == {(torch.bfloat16, copy.data_ptr())}, rows
    log(f"[bf16] (d) every weighted launch gathered the estimator's bf16 "
        f"copy ({copy.numel() * 2} bytes, made once)")
    return g, launches


def bf16_hash_walk(g, errs):
    """(d), walks: a bf16 hashed walk (1024 x 8) on (d)'s sampler: the
    weighted-kv bf16 kernel once a step on the estimator's bf16 copy, its
    first call against its plain version within the flip slack."""
    import inspect
    import numpy as np
    import torch
    from repro_torch.kernels.kde_hash import kernel as hk
    from repro_torch.kernels.kde_sampler.ref import bf16_flip_slack
    nbr = g.nbr
    copy = nbr.hash_estimator.state.x_bf16
    starts = np.random.default_rng(3).integers(0, HS_N, 1024).astype(
        np.int64)
    hk.reset_launches()
    (_, taps), rows = gathered_rows(lambda: tapped(
        lambda: nbr.walk(starts, 8), (hk, "weighted_kv_cuda")))
    launches = {k: v for k, v in hk.LAUNCHES.items() if v}
    assert launches == {"weighted_kv_bf16": 8}, launches
    assert rows == {(torch.bfloat16, copy.data_ptr())}, rows
    args, kw, got = taps["weighted_kv_cuda"]
    a = inspect.signature(hk.weighted_kv_cuda).bind(*args, **kw).arguments
    want = hk.weighted_kv_plain(**a)
    x32 = nbr.x
    sl = bf16_flip_slack(a["q"], x32[a["cols"].long().clamp(0, HS_N - 1)],
                         a["kind"], a["inv_bw"], chunk=256) \
        * a["wgt"].double()
    errs["weighted_kv_bf16"] = max(errs["weighted_kv_bf16"], close(
        got, want, "weighted_kv bf16 on the hashed walk",
        HASH_ATOL * float(want.abs().max()), slack=sl))
    secs, walls = best_wall(lambda: nbr.walk(starts, 8), 3)
    log(f"[bf16] (d) bf16 hashed walk 1024 x 8: best {secs!r} s of "
        f"{[round(w, 6) for w in walls]}, {8 * 1024 / secs:.0f} "
        f"walk-steps/s, launches {launches} on the bf16 copy; the first "
        f"call against its plain version within the flip slack")
    return launches


def bf16_hash_checks(data, g):
    """(d)'s checks: phase 6's counter formulas, the degree sum within 2%
    of exact, the edge law of phase 6."""
    import numpy as np
    from repro_torch.ft import guards
    state, bn, n = data["hs_state"], data["hs_bs"], HS_N
    hstate = g.nbr._hstate
    assert all(bool((a == b).all()) for a, b in zip(hstate[:8], state[:8])), \
        "the bf16 sampler's layout is not phase 6's"
    t = 10 * n
    drawn = -(-t // BATCH) * BATCH
    nb = -(-n // bn)
    near = int(state.counts[state.point_bucket].sum())
    want = (near + n * HS_NUM_FAR
            + drawn * (HS_MAX_BUCKET + nb * HS_FAR_PER_BLOCK + bn + 1))
    assert not (g.status & guards.FATAL), guards.decode_status(g.status)
    assert g.kernel_evals == want, (g.kernel_evals, want)
    assert g.num_edges == t and np.all(np.isfinite(g.weight))
    log(f"[bf16] (d) status {guards.decode_status(g.status)} (no fatal "
        f"flag); kernel_evals {g.kernel_evals} = NEAR {near} + n*{HS_NUM_FAR}"
        f" + drawn*({HS_MAX_BUCKET} + {nb}*{HS_FAR_PER_BLOCK} + {bn} + 1)")
    log(f"[bf16] (d) {degree_check(data, g.degrees, 'deg_hash_bf16')}")
    log(f"[bf16] (d) edge law of the {g.num_edges} drawn edges: "
        f"{hash_edge_law(data['hs_x'], bn, g)} (alpha 1e-3)")


def phase_bf16(data, gen):
    """Phase 8: the bf16 policy.  (a) the bf16 kernels against their plain
    versions, (b) the bench_kde precision sweep, (c) the exact sparsifier
    in bf16, (d) the hashed sparsifier in bf16, each counted on its own.
    Returns (the six report rows, launches by kernel, seconds by part)."""
    from repro_torch.kernels.kde_rowsum import kernel as rk
    secs = {}
    t0 = time.perf_counter()
    errs = bf16_kernel_checks(gen)
    rows = bf16_main_rows(data, gen, errs)
    for r in rows:
        log_row(r)
    free_cuda()
    secs["bf16 kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rk.reset_launches()
    bf16_sweep()
    launches = {"rowsum_bf16": rk.LAUNCHES["rowsum_bf16"]}
    # timed(): a warm-up call and 20 timed ones, then one for the values
    assert rk.LAUNCHES["rowsum"] == launches["rowsum_bf16"] \
        == 22 * len(SWEEP_N), rk.LAUNCHES
    secs["bf16 sweep"] = time.perf_counter() - t0
    g_ex, ex_launches = bf16_exact_path(data)
    secs["bf16 exact"] = g_ex.secs
    g_hs, hs_launches = bf16_hash_path(data)
    secs["bf16 hash"] = g_hs.secs
    t0 = time.perf_counter()
    walk_errs = {"weighted_kv_bf16": 0.0}
    bf16_hash_walk(g_hs, walk_errs)
    for r in rows:
        if r["name"] in walk_errs:
            r["max_abs_err"] = max(r["max_abs_err"], walk_errs[r["name"]])
    secs["bf16 hashed walk"] = time.perf_counter() - t0
    for k, v in {**ex_launches, **hs_launches}.items():
        if k.endswith("_bf16") and v:
            launches[k] = v
    assert sorted(launches) == sorted(BF16_NAMES), launches
    t0 = time.perf_counter()
    bf16_exact_checks(data, g_ex)
    bf16_hash_checks(data, g_hs)
    secs["bf16 checks"] = time.perf_counter() - t0
    return rows, launches, secs


# --------------------------------------------------------------------- #
# phase 9: graph (walks and the Table-1 applications)
# --------------------------------------------------------------------- #
def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def kernel_launches(fn):
    """(fn's result, the f32 kernel launches it made, by name, zeros
    left out): every counter is set to 0 just before the call."""
    from repro_torch.kernels.kde_hash import kernel as hk
    from repro_torch.kernels.kde_rowsum import kernel as rk
    from repro_torch.kernels.kde_sampler import kernel as sk
    for mod in (rk, sk, hk):
        mod.reset_launches()
    out = fn()
    counts = f32_counts(rk.LAUNCHES, sk.LAUNCHES, hk.LAUNCHES)
    return out, {k: v for k, v in counts.items() if v}


def best_wall(fn, reps: int):
    """(min, all) host seconds of ``reps`` calls of ``fn`` after one
    warm-up, each ending in a synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return min(walls), walls


def transitions(starts, path, dev):
    """(sources, destinations) of every step of a (T, w) walk path."""
    import numpy as np
    import torch
    src = np.concatenate([np.asarray(starts)[None], path[:-1]]).reshape(-1)
    return (torch.as_tensor(src, device=dev),
            torch.as_tensor(path.reshape(-1), device=dev))


def pit_law(pit, what: str):
    """Chi-square of (2, t) PITs against the uniform on PIT_BINS bins."""
    import torch
    t = pit.shape[1]
    return [chi2_test(torch.histc(row, bins=PIT_BINS, min=0.0,
                                  max=1.0).double(),
                      torch.full((PIT_BINS,), t / PIT_BINS,
                                 dtype=torch.float64, device=pit.device),
                      f"{what}, {order} order")
            for row, order in zip(pit, ("index", "value"))]


def tapped(fn, *targets):
    """(fn's result, {attr: (args, kwargs, output)}): the first call of
    each ``(module, attr)`` function in ``targets`` made during ``fn``,
    with its inputs and output cloned -- what the path hands a kernel
    wrapper and what it gets back.  The functions are restored after."""
    import torch

    def copy(a):
        if torch.is_tensor(a):
            return a.clone()
        if isinstance(a, (tuple, list)):
            return type(a)(copy(b) for b in a)
        if isinstance(a, dict):
            return {k: copy(v) for k, v in a.items()}
        return a

    seen, saved = {}, []

    def tap(orig, attr):
        def call(*args, **kw):
            if attr in seen:
                return orig(*args, **kw)
            inputs = copy(args), copy(kw)
            out = orig(*args, **kw)
            seen[attr] = (*inputs, copy(out))
            return out
        return call

    for mod, attr in targets:
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, tap(getattr(mod, attr), attr))
    try:
        out = fn()
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)
    return out, seen


def kernel_mods():
    """The module of each f32 kernel phases 9, 13 and 14 check, by
    kernel."""
    from repro_torch.kernels.kde_hash import kernel as hk
    from repro_torch.kernels.kde_rowsum import kernel as rk
    from repro_torch.kernels.kde_sampler import kernel as sk
    return {"rowsum": rk, "blocksum": rk, "masked_blocksum": sk,
            "sample_block": sk, "weighted_kv": hk, "weighted_kv_sum": hk}


def kernel_taps(*names):
    """``tapped`` targets of the CUDA wrappers of the named f32 kernels."""
    mods = kernel_mods()
    return [(mods[name], f"{name}_cuda") for name in names]


def path_kernel_checks(taps, what: str, errs, phase: str = "graph") -> None:
    """Every kernel call ``tapped`` recorded on a path against its plain
    version on the same inputs (bound by parameter name: the plain
    versions take more parameters), at phase 2's tolerances; each max abs
    error is folded into ``errs`` by kernel."""
    import inspect
    mods = kernel_mods()
    for attr, (args, kw, got) in taps.items():
        name = attr[:-len("_cuda")]
        if name not in mods:
            continue
        mod = mods[name]
        a = inspect.signature(getattr(mod, attr)).bind(*args, **kw).arguments
        want = getattr(mod, f"{name}_plain")(**a)
        tag = f"{name} on the {what}"
        if name == "sample_block":
            err = sample_block_err(got, want, a["gumbel"], tag)
        elif name.startswith("weighted_kv"):
            err = close_scaled(got, want, tag)
        else:
            err = close(got, want, tag)
        errs[name] = max(errs.get(name, 0.0), err)
        width = f"t={a['cols'].shape[1]}" if "cols" in a else \
            f"bn={a['bn']}" if "bn" in a else "rows"
        x = a["x"]
        arena = f" x {x.shape[0]} tenants" if x.dim() == 3 else ""
        log(f"[{phase}] {tag}: m={a['q'].shape[0]} n={x.shape[-2]}{arena} "
            f"d={x.shape[-1]} {width}, the path's own inputs against the "
            f"plain version: max abs err {err:.3e}")


def graph_stratified_walks(card, gen, launches, profiles):
    """(a) stratified walks on the walk-resident cache at bench_sampling's
    largest walk-scaling point: timed, counted, no kernel, every
    transition by its in-stratum PITs."""
    import numpy as np
    import torch
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sampling.edge import NeighborSampler
    from repro_torch.ft import guards
    from repro_torch.kernels.kde_sampler import ops
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.5, (GW_N, GW_D)).astype(np.float32)
    nbr = NeighborSampler(x, gaussian(GW_BW), samples_per_block=GW_S, seed=0,
                          device="cuda")
    starts = rng.integers(0, GW_N, GW_WALKERS).astype(np.int64)
    wbs, w_blocks, s_eff = ops.walk_layout(nbr.n, nbr.block_size,
                                           nbr.num_blocks, GW_S)
    per_walk = GW_STEPS * (GW_WALKERS * w_blocks * s_eff + GW_WALKERS * wbs)
    e0 = nbr.evals
    (best, walls), counts = kernel_launches(
        lambda: best_wall(lambda: nbr.walk(starts, GW_STEPS), 3))
    assert not counts, f"the stratified walk launched kernels: {counts}"
    assert nbr.evals - e0 == 4 * per_walk, (nbr.evals - e0, per_walk)
    assert nbr.device_counters["evals"] == nbr.evals
    log(f"[graph] (a) stratified walks n={GW_N} d={GW_D} s={GW_S}: walk "
        f"layout wbs {wbs}, {w_blocks} strata, s_eff {s_eff} (sampler "
        f"blocks {nbr.block_size} x {nbr.num_blocks}); {GW_WALKERS} "
        f"walkers x {GW_STEPS} steps: best {best!r} s of "
        f"{[round(w, 6) for w in walls]}, "
        f"{GW_WALKERS * GW_STEPS / best:.0f} walk-steps/s; kernel_evals "
        f"{per_walk} a walk = steps (w B s_eff + w wbs); no kernel launch "
        f"({card})")
    profiles["stratified walk 256 x 4"] = device_profile(
        lambda: nbr.walk(starts, GW_STEPS))
    starts2 = rng.integers(0, GW_N, 1024).astype(np.int64)
    (ends, path), counts = kernel_launches(
        lambda: nbr.walk(starts2, 8, record_path=True))
    assert not counts and path.shape == (8, 1024), counts
    assert not nbr.status & guards.FATAL, guards.decode_status(nbr.status)
    launches["stratified walk"] = {}
    src, dst = transitions(starts2, path, nbr.device)
    xd = torch.as_tensor(x, device="cuda")
    texts = pit_law(block_pits(xd, wbs, src, dst, GW_BW, gen),
                    "destinations in their stratum")
    log(f"[graph] (a) 1024 walkers x 8 steps (record_path): "
        f"{'; '.join(texts)} (alpha 1e-3)")
    del nbr, xd
    free_cuda()


def graph_exact_walks(data, card, launches, profiles, errs):
    """(b) exact-block walks on phase 3's data: one sample-block launch a
    step; with rejection rounds one masked-blocksum launch a step; every
    transition held to k(u, .) / deg(u); each kernel's first call of a
    walk against its plain version."""
    import numpy as np
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sampling.edge import NeighborSampler
    from repro_torch.ft import guards
    x, bs, n = data["sp_x"], data["sp_bs"], SP_N
    rng = np.random.default_rng(1)
    nbr = NeighborSampler(x, gaussian(SP_BW), exact_blocks=True, seed=6,
                          device="cuda")
    starts = rng.integers(0, n, 1024).astype(np.int64)
    e0 = nbr.evals
    ((ends, path), taps), counts = kernel_launches(lambda: tapped(
        lambda: nbr.walk(starts, 8, record_path=True),
        *kernel_taps("sample_block")))
    assert counts == {"sample_block": 8}, counts
    path_kernel_checks(taps, "exact-block walk", errs)
    assert nbr.evals - e0 == 8 * (1024 * n + 1024 * bs), nbr.evals - e0
    launches["exact-block walk 1024 x 8"] = counts
    src, dst = transitions(starts, path, x.device)
    secs, walls = best_wall(lambda: nbr.walk(starts, 8), 3)
    log(f"[graph] (b) exact-block walk 1024 x 8 at n={n}: best {secs!r} s "
        f"of {[round(w, 6) for w in walls]}, {8 * 1024 / secs:.0f} "
        f"walk-steps/s, launches {counts}, "
        f"kernel_evals 8 (w n + w bs); "
        + "; ".join(neighbor_law(x, src, dst, 1.0 / SP_BW))
        + f" (alpha 1e-3; {card})")
    profiles["exact-block walk 1024 x 8"] = device_profile(
        lambda: nbr.walk(starts, 8))
    ex = NeighborSampler(x, gaussian(SP_BW), exact_blocks=True, seed=7,
                         device="cuda")
    starts = rng.integers(0, n, 256).astype(np.int64)
    ((ends, path), taps), counts = kernel_launches(lambda: tapped(
        lambda: ex.walk(starts, 4, exact=True, rounds=EXACT_ROUNDS,
                        slack=EXACT_SLACK, record_path=True),
        *kernel_taps("masked_blocksum")))
    assert counts == {"masked_blocksum": 4}, counts
    path_kernel_checks(taps, "exact walk with rejection rounds", errs)
    assert ex.exact_draws == 256 * 4
    assert not (nbr.status | ex.status) & guards.FATAL
    launches["exact walk 256 x 4"] = counts
    src, dst = transitions(starts, path, x.device)
    fallbacks = ex.exact_fallbacks
    secs, walls = best_wall(lambda: ex.walk(
        starts, 4, exact=True, rounds=EXACT_ROUNDS, slack=EXACT_SLACK), 3)
    log(f"[graph] (b) exact walk (rounds {EXACT_ROUNDS}, slack "
        f"{EXACT_SLACK}) 256 x 4: best {secs!r} s of "
        f"{[round(w, 6) for w in walls]}, {4 * 256 / secs:.0f} "
        f"walk-steps/s, launches {counts}, {fallbacks} fallbacks of "
        f"{256 * 4} draws; "
        + "; ".join(neighbor_law(x, src, dst, 1.0 / SP_BW))
        + " (alpha 1e-3)")


def graph_hash_walks(data, card, gen, launches, profiles, errs):
    """(c) hashed walks on phase 6's data and sampler: the weighted-kv
    kernel once a step (its first call against its plain version), the
    counter formula, destinations by phase 6's block-restricted PITs."""
    import numpy as np
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sampling.edge import NeighborSampler
    from repro_torch.ft import guards
    from repro_torch.kernels.kde_hash.ops import _widths
    x, bs = data["hs_x"], data["hs_bs"]
    nbr = NeighborSampler(x, gaussian(HS_BW), level1="hash", seed=2,
                          device="cuda")
    rng = np.random.default_rng(2)
    starts = rng.integers(0, HS_N, 1024).astype(np.int64)
    mb, ov = _widths(nbr.hash_estimator.state)
    per_step = 1024 * (mb + ov + nbr.num_blocks * HS_FAR_PER_BLOCK) \
        + 1024 * bs
    e0 = nbr.evals
    ((ends, path), taps), counts = kernel_launches(lambda: tapped(
        lambda: nbr.walk(starts, 8, record_path=True),
        *kernel_taps("weighted_kv")))
    assert counts == {"weighted_kv": 8}, counts
    path_kernel_checks(taps, "hashed walk", errs)
    assert nbr.evals - e0 == 8 * per_step, (nbr.evals - e0, per_step)
    assert nbr.device_counters["evals"] == 8 * per_step
    assert not nbr.status & guards.FATAL, guards.decode_status(nbr.status)
    launches["hashed walk 1024 x 8"] = counts
    src, dst = transitions(starts, path, x.device)
    texts = pit_law(block_pits(x, bs, src, dst, HS_BW, gen),
                    "destinations in their block")
    secs, walls = best_wall(lambda: nbr.walk(starts, 8), 3)
    log(f"[graph] (c) hashed walk 1024 x 8 at n={HS_N}: best {secs!r} s of "
        f"{[round(w, 6) for w in walls]}, {8 * 1024 / secs:.0f} "
        f"walk-steps/s, launches {counts}, kernel_evals 8 x {per_step} = 8 "
        f"(w (max_bucket "
        f"{mb} + overflow {ov} + B far {nbr.num_blocks} x "
        f"{HS_FAR_PER_BLOCK}) + w bs); {'; '.join(texts)} (alpha 1e-3; "
        f"{card})")
    profiles["hashed walk 1024 x 8"] = device_profile(
        lambda: nbr.walk(starts, 8))


def block_masses(x, bw, bs, nb, steps):
    """The level-1 block masses of e_0 M^t for each t in ``steps``, M the
    gaussian walk matrix of ``x`` at bandwidth ``bw`` (float64 on the
    card)."""
    import torch
    xd = torch.as_tensor(x, device="cuda").double()
    k = torch.exp(-torch.cdist(xd, xd) ** 2 / bw ** 2)
    k.fill_diagonal_(0.0)
    m = k / k.sum(1, keepdim=True)
    own = torch.arange(x.shape[0], device="cuda") // bs
    p, out = m[0], {}
    for t in range(1, max(steps) + 1):
        if t > 1:
            p = p @ m
        if t in steps:
            out[t] = torch.zeros(nb, dtype=torch.float64,
                                 device="cuda").index_add_(0, own, p)
    return out


def graph_markov_law(launches, gen, errs):
    """(d) Theorem 4.15: 20,000 exact-block walks of 3 steps from vertex
    0; endpoints per level-1 block against e_0 M^3 (float64 on the card).
    First on bench_sampling's data (x ~ N(0, 0.5^2), bandwidth 4.0), where
    every kernel value is near exp(-0.5) and e_0 M^3 is near uniform over
    the blocks; then on GM_CLUSTERS sorted by label at bandwidth 1.0,
    where the law is far from uniform and two controls must be rejected:
    uniform endpoints against e_0 M^3, and the walks' endpoints against
    e_0 M^2."""
    import numpy as np
    import torch
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sampling.edge import NeighborSampler
    from repro_torch.data.synthetic_points import gaussian_clusters
    x = np.random.default_rng(0).normal(0, 0.5, (GM_N, GW_D)).astype(
        np.float32)
    xc, lab = gaussian_clusters(n=GM_N, d=GW_D, seed=0, **GM_CLUSTERS)
    xc = xc[np.argsort(lab, kind="stable")]
    for tag, data, bw in (("N(0, 0.5^2), bandwidth 4.0", x, GW_BW),
                          (f"clusters {GM_CLUSTERS} sorted by label, "
                           f"bandwidth {GM_CLUSTER_BW}", xc, GM_CLUSTER_BW)):
        nbr = NeighborSampler(data, gaussian(bw), exact_blocks=True, seed=0,
                              device="cuda")
        (ends, taps), counts = kernel_launches(lambda: tapped(
            lambda: nbr.walk(np.zeros(GM_WALKS, np.int64), 3)[0],
            *kernel_taps("sample_block")))
        assert counts == {"sample_block": 3}, counts
        launches[f"markov law 20000 x 3, {tag}"] = counts
        path_kernel_checks(taps, f"Markov-law walk ({tag})", errs)
        bs, nb = nbr.block_size, nbr.num_blocks
        mass = block_masses(data, bw, bs, nb, (2, 3))
        got = torch.bincount(torch.as_tensor(ends, device="cuda") // bs,
                             minlength=nb).double()
        text = chi2_test(got, GM_WALKS * mass[3], "endpoint blocks")
        if data is xc:
            uni = torch.bincount(torch.randint(
                0, GM_N, (GM_WALKS,), generator=gen, device="cuda") // bs,
                minlength=nb).double()
            controls = (("uniform endpoints against e_0 M^3", uni, mass[3]),
                        ("the endpoints against e_0 M^2", got, mass[2]))
            for what, c, m in controls:
                stat, crit, df = chi2_stat(c, GM_WALKS * m)
                assert stat >= crit, f"control passed: {what} {stat:.1f}"
                text += (f"; control {what}: chi-square {stat:.2f} >= "
                         f"{crit:.2f} (df {df}), rejected")
        log(f"[graph] (d) Markov law ({tag}): {GM_WALKS} walks of 3 steps "
            f"from vertex 0 at n={GM_N}: endpoints per {bs}-row block "
            f"against e_0 M^3: {text} (alpha 1e-3)")
        del nbr
    free_cuda()


def triangle_vs_plain(rec, what: str) -> str:
    """A recorded ``triangle_edge_scan`` call (``tapped``) against the
    plain oracle ``triangle_batch_ref`` on the same inputs and noise: the
    oriented pairs equal, the weights at rtol on all but m / 1000 + 1 rows
    (a draw that a near-tie of the level-1 sums, summed in another order,
    sent elsewhere); returns the log text."""
    import torch
    from repro_torch.kernels.kde_sampler import ref as sref
    (x, x_sq, u, v, degs, (_, u_blk, u_in), _), kw, got = rec
    want = sref.triangle_batch_ref(x, x_sq, u, v, degs, u_blk, u_in,
                                   kw["kind"], kw["inv_bw"], kw["beta"],
                                   kw["block_size"], kw["n"])
    m = u.shape[0]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
        f"{what}: oriented pairs differ"
    off = ~torch.isclose(got[2], want[2], rtol=RTOL, atol=1e-7)
    assert int(off.sum()) <= m // 1000 + 1, (what, int(off.sum()))
    assert bool(torch.isfinite(got[2]).all()), f"{what}: non-finite w_hat"
    err = float((got[2] - want[2])[~off].abs().max())
    return (f"{what}: oriented pairs equal, w_hat of {m} pairs against "
            f"triangle_batch_ref: {int(off.sum())} rows off (bound "
            f"{m // 1000 + 1}), max abs err {err:.3e} on the rest")


def graph_triangles(card, launches, profiles, errs):
    """(e) triangle batches at bench_graph's engine configuration,
    stratified (timed) and exact (the exact degrees and one masked-blocksum
    launch a call, each against its plain version), then
    ``estimate_triangle_weight`` at the accuracy configuration.  Returns
    the engine's stratified sampler and its data for (f)."""
    import numpy as np
    import torch
    from repro_torch.core.graph.triangles import (estimate_triangle_weight,
                                                  exact_triangle_weight)
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sampling.edge import NeighborSampler
    from repro_torch.core.sampling.vertex import approximate_degrees
    from repro_torch.ft import guards
    from repro_torch.kernels.kde_sampler import ops
    n, m, ns = GT_N, GT_PAIRS, GT_DRAWS
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.5, (n, GW_D)).astype(np.float32)
    ker = gaussian(GW_BW)
    nbr = NeighborSampler(x, ker, samples_per_block=GW_S, seed=2,
                          device="cuda")
    degs = torch.as_tensor(approximate_degrees(nbr.blocks),
                           dtype=torch.float32)
    u = rng.integers(0, n, size=m)
    v = rng.integers(0, n - 1, size=m)
    v = np.where(v >= u, v + 1, v)
    (best, walls), counts = kernel_launches(lambda: best_wall(
        lambda: nbr.triangle_batches(u, v, degs, ns), 5))
    assert not counts, counts
    log(f"[graph] (e) triangle batches n={n} m={m} x {ns} draws, "
        f"stratified: best {best!r} s of {[round(w, 6) for w in walls]}, "
        f"{m * ns / best:.0f} draws/s, no kernel launch ({card})")
    profiles["triangle batch stratified"] = device_profile(
        lambda: nbr.triangle_batches(u, v, degs, ns))
    ex = NeighborSampler(x, ker, exact_blocks=True, seed=2, device="cuda")
    (deg_ex, taps), counts = kernel_launches(lambda: tapped(
        lambda: approximate_degrees(ex.blocks), *kernel_taps("blocksum")))
    assert counts == {"blocksum": -(-n // BATCH)}, counts
    launches["triangle exact degrees"] = counts
    path_kernel_checks(taps, "exact degrees", errs)
    err = close(torch.as_tensor(deg_ex, device="cuda"),
                exact_degrees(ex.x, 1.0 / GW_BW), "exact degrees")
    log(f"[graph] (e) exact degrees of n={n} against the plain float64 "
        f"row sums: max abs err {err:.3e}")
    deg_ex = torch.as_tensor(deg_ex, dtype=torch.float32)
    bs = ex.block_size
    e0 = ex.evals
    (_, taps), counts = kernel_launches(lambda: tapped(
        lambda: ex.triangle_batches(u, v, deg_ex, ns),
        *kernel_taps("masked_blocksum"), (ops, "triangle_edge_scan")))
    assert counts == {"masked_blocksum": 1}, counts
    path_kernel_checks(taps, "exact triangle batch", errs)
    log("[graph] (e) " + triangle_vs_plain(taps["triangle_edge_scan"],
                                           "exact triangle batch"))
    assert ex.evals - e0 == m * (n + 1) + ns * (m * bs + m), ex.evals - e0
    launches["triangle batch exact"] = counts
    best, walls = best_wall(lambda: ex.triangle_batches(u, v, deg_ex, ns), 5)
    assert not (nbr.status | ex.status) & guards.FATAL
    log(f"[graph] (e) triangle batches, exact_blocks: launches {counts} a "
        f"call, kernel_evals m (n + 1) + ns (m bs + m); best {best!r} s of "
        f"{[round(w, 6) for w in walls]}, {m * ns / best:.0f} draws/s "
        f"({card})")
    profiles["triangle batch exact"] = device_profile(
        lambda: ex.triangle_batches(u, v, deg_ex, ns))
    xa, _ = acc_data()
    truth = exact_triangle_weight(gaussian(1.0), xa, device="cuda")
    for (pairs, draws), bound_ in TRI_BOUND.items():
        t0 = time.perf_counter()
        res = estimate_triangle_weight(xa, gaussian(1.0), pairs, draws,
                                       seed=0, device="cuda")
        secs = time.perf_counter() - t0
        rel = abs(res.total_weight - truth) / truth
        log(f"[graph] (e) estimate_triangle_weight n={ACC_N} {pairs} pairs x "
            f"{draws} draws: {res.total_weight!r} against the exact "
            f"{truth!r}, rel err {rel!r} (bound {bound_!r}), kernel_evals "
            f"{res.kernel_evals}, {secs:.2f} s")
        assert rel <= bound_, (pairs, draws, rel, bound_)
    return nbr, degs


def acc_data():
    """bench_graph's accuracy configuration: two clusters, n = 1200."""
    from repro_torch.data.synthetic_points import gaussian_clusters
    return gaussian_clusters(n=ACC_N, d=4, k=2, spread=0.3, sep=1.2, seed=3)


def graph_arboricity(nbr, card):
    """(f) edge batches at the engine configuration (timed), then
    ``estimate_arboricity`` at the accuracy configuration with its
    counter formula."""
    import numpy as np
    from repro_torch.core.graph.arboricity import (estimate_arboricity,
                                                   exact_arboricity)
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sampling.vertex import DegreeSampler
    deg = DegreeSampler(nbr.blocks, seed=1)
    (best, walls), counts = kernel_launches(lambda: best_wall(
        lambda: nbr.edge_batches(deg.cdf_device, deg.degrees_device,
                                 deg.total, GA_EDGES, batch=BATCH), 5))
    assert not counts, counts
    log(f"[graph] (f) edge batches n={GT_N} {GA_EDGES} edges, batch "
        f"{BATCH}, stratified: best {best!r} s of "
        f"{[round(w, 6) for w in walls]}, {GA_EDGES / best:.0f} edges/s, no "
        f"kernel launch ({card})")
    xa, _ = acc_data()
    truth = exact_arboricity(gaussian(1.0), xa, device="cuda")
    bs = max(int(np.sqrt(ACC_N)), 16)
    nb = -(-ACC_N // bs)
    for m, bound_ in ARB_BOUND.items():
        t0 = time.perf_counter()
        res = estimate_arboricity(xa, gaussian(1.0), m, seed=0,
                                  device="cuda")
        secs = time.perf_counter() - t0
        drawn = -(-m // 512) * 512
        want = ACC_N * nb * GW_S + drawn * (nb * GW_S + bs + 1)
        assert res.kernel_evals == want, (res.kernel_evals, want)
        rel = abs(res.density - truth) / truth
        log(f"[graph] (f) estimate_arboricity n={ACC_N} m={m}: density "
            f"{res.density!r} against the exact peel's {truth!r}, rel err "
            f"{rel!r} (bound {bound_!r}), kernel_evals {res.kernel_evals} = "
            f"n B s + drawn (B s + bs + 1), {secs:.2f} s")
        assert rel <= bound_, (m, rel, bound_)


def graph_table1(launches, errs):
    """(g) local clustering, the top eigenvalue, the Laplacian solve, the
    spectrum and spectral clustering on the accuracy configuration; the
    first sample-block call of a test and of the spectrum against its
    plain version."""
    import numpy as np
    from repro_torch.core import (approximate_spectrum, cg_laplacian,
                                  cluster_accuracy, emd_1d, exact_spectrum,
                                  same_cluster_test, solve_kernel_laplacian,
                                  spectral_cluster, spectral_sparsify,
                                  top_eigenvalue, top_eigenvalue_exact)
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sampling.edge import NeighborSampler
    xa, lab = acc_data()
    ker, n = gaussian(1.0), ACC_N
    i0, i1 = np.where(lab == 0)[0], np.where(lab == 1)[0]
    cases = [(int(i0[0]), int(i0[5]), True), (int(i1[1]), int(i1[7]), True),
             (int(i0[0]), int(i1[0]), False), (int(i0[3]), int(i1[2]), False)]
    stats_ = []
    for seed, (u, w, want) in enumerate(cases):
        nbr = NeighborSampler(xa, ker, exact_blocks=True, seed=seed,
                              device="cuda")
        (res, taps), counts = kernel_launches(lambda: tapped(
            lambda: same_cluster_test(xa, ker, u, w, walk_length=6,
                                      num_walks=400, sampler=nbr, seed=seed),
            *kernel_taps("sample_block")))
        path_kernel_checks(taps, f"same_cluster_test ({u}, {w})", errs)
        rng = np.random.default_rng(seed)
        walks = max(int(rng.poisson(400)), 1) + max(int(rng.poisson(400)), 1)
        assert counts == {"sample_block": 6}, counts
        assert res.kernel_evals == 6 * walks * (n + nbr.block_size)
        assert res.same_cluster == want, (u, w, res.statistic)
        stats_.append(f"({u}, {w}) {res.statistic:.3e}")
    launches["same_cluster_test a pair"] = counts
    log(f"[graph] (g) same_cluster_test (walk_length 6, 400 walks) on the "
        f"four reference pairs: decisions as expected, statistics "
        f"{', '.join(stats_)} (threshold {1.0 / n:.3e}), kernel_evals "
        f"6 walks (n + bs), launches {counts} a test")
    t = 192
    truth = top_eigenvalue_exact(ker, xa, device="cuda")
    res = top_eigenvalue(xa, ker, t=t, method="noisy_power", seed=0,
                         device="cuda")
    err = abs(res.eigenvalue - truth)
    log(f"[graph] (g) top_eigenvalue(noisy_power, t={t}): {res.eigenvalue!r}"
        f" against {truth!r}, |err| {err:.4f} <= 2 n / sqrt(t) = "
        f"{2 * n / t ** 0.5:.4f}; kernel_evals {res.kernel_evals}, sampled "
        f"lookups {res.matvec_sampled_evals}")
    assert err <= 2.0 * n / np.sqrt(t)
    assert res.kernel_evals == t * t
    b = np.random.default_rng(1).standard_normal(n)
    b -= b.mean()
    t0 = time.perf_counter()
    sol, g = solve_kernel_laplacian(xa, ker, b, device="cuda")
    secs = time.perf_counter() - t0
    _, res = cg_laplacian(g, b, iters=300, device="cuda")
    log(f"[graph] (g) solve_kernel_laplacian: {g.num_edges} edges, "
        f"{secs:.2f} s; CG residual {res / np.linalg.norm(b):.3e} |b| (the "
        f"f32 plateau of a two-cluster graph), |L_G' x - b| / |b| = "
        f"{np.linalg.norm(g.matvec(sol) - b) / np.linalg.norm(b):.3e}")
    assert res < CG_PLATEAU * np.linalg.norm(b), res
    # the reference's CG test (tests/test_fused_apps.py): its cloud, an
    # exact sparsifier of 12000 edges, the residual under 1e-4 |b| and the
    # solution within 1e-3 of the dense solve
    xc = np.random.default_rng(0).normal(0, 0.35, (300, 5)).astype(
        np.float32)
    g = spectral_sparsify(xc, gaussian(2.0), 12000, estimator="exact",
                          exact_blocks=True, seed=0, device="cuda")
    b = np.random.default_rng(1).standard_normal(g.n)
    b -= b.mean()
    sol, res = cg_laplacian(g, b, iters=400, device="cuda")
    direct = np.linalg.lstsq(g.laplacian_dense(), b, rcond=None)[0]
    direct -= direct.mean()
    err = np.linalg.norm(sol - direct) / np.linalg.norm(direct)
    log(f"[graph] (g) cg_laplacian on the reference test's cloud (n 300, "
        f"12000 exact edges): residual {res / np.linalg.norm(b):.3e} |b| "
        f"(bound {CG_RTOL}), solution vs the dense solve {err:.3e} (bound "
        f"1e-3)")
    assert res < CG_RTOL * np.linalg.norm(b) and err < 1e-3, (res, err)
    sampler = NeighborSampler(xa, ker, exact_blocks=True, seed=0,
                              device="cuda")
    (sp, taps), counts = kernel_launches(lambda: tapped(
        lambda: approximate_spectrum(xa, ker, sampler=sampler),
        *kernel_taps("sample_block")))
    assert counts == {"sample_block": 10}, counts
    path_kernel_checks(taps, "approximate_spectrum", errs)
    assert sp.kernel_evals == 10 * 32 * 64 * (n + sampler.block_size)
    launches["approximate_spectrum"] = counts
    emd = emd_1d(sp.eigenvalues, exact_spectrum(ker, xa, device="cuda"))
    log(f"[graph] (g) approximate_spectrum (10 steps, 32 x 64 walks): EMD "
        f"to the exact spectrum {emd!r}, kernel_evals {sp.kernel_evals}, "
        f"launches {counts}")
    g = spectral_sparsify(xa, ker, 10 * n, seed=0, device="cuda")
    acc = cluster_accuracy(spectral_cluster(g, 2).labels, lab, 2)
    log(f"[graph] (g) spectral_cluster on a {g.num_edges}-edge sparsifier: "
        f"accuracy {acc!r}")


def phase_graph(data, gen):
    """Phase 9: walks and the Table-1 applications.  Returns (launches by
    path and kernel, seconds by part, the largest error of each kernel
    against its plain version on the paths' own inputs)."""
    import torch
    card = card_line()
    launches, profiles, secs, errs = {}, {}, {}, {}
    t0 = time.perf_counter()
    graph_stratified_walks(card, gen, launches, profiles)
    secs["graph (a)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph_exact_walks(data, card, launches, profiles, errs)
    secs["graph (b)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph_hash_walks(data, card, gen, launches, profiles, errs)
    secs["graph (c)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph_markov_law(launches, gen, errs)
    secs["graph (d)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nbr, _ = graph_triangles(card, launches, profiles, errs)
    secs["graph (e)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph_arboricity(nbr, card)
    secs["graph (f)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph_table1(launches, errs)
    secs["graph (g)"] = time.perf_counter() - t0
    for what, prof in profiles.items():
        log(f"[graph] profile of one {what}: {profile_text(*prof)}")
    torch.cuda.synchronize()
    free_cuda()
    return launches, secs, errs


# --------------------------------------------------------------------- #
# phase 13: streaming (DESIGN.md §12)
# --------------------------------------------------------------------- #
def counted(launches, path: str, fn):
    """``fn()``, every kernel launch it made -- the f32 and the bf16
    instances -- added to ``launches[path]`` by name: every counter is set
    to 0 just before the call."""
    from repro_torch.kernels.kde_hash import kernel as hk
    from repro_torch.kernels.kde_rowsum import kernel as rk
    from repro_torch.kernels.kde_sampler import kernel as sk
    mods = (rk, sk, hk)
    for mod in mods:
        mod.reset_launches()
    out = fn()
    acc = launches.setdefault(path, {})
    for mod in mods:
        for k, v in mod.LAUNCHES.items():
            if v:
                acc[k] = acc.get(k, 0) + v
    return out


def stream_plan(rng, n, d, m, batches):
    """bench_streaming._mutation_plan: the identical mutation sequence for
    every path -- a third of m inserts, deletes and updates a batch;
    deletes clear of the frontier rows [0, 64) and of each other."""
    import numpy as np
    mi = md = m // 3
    mu = m - mi - md
    dead_pool = rng.permutation(np.arange(64, n))[: md * batches]
    return [dict(ins=rng.normal(0, 0.5, (mi, d)).astype(np.float32),
                 dele=np.sort(dead_pool[b * md:(b + 1) * md]),
                 upd_rows=rng.normal(0, 0.5, (mu, d)).astype(np.float32))
            for b in range(batches)]


def stream_apply(ds, batch, rng):
    """bench_streaming._apply: insert, delete, then update live rows >= 64
    drawn by ``rng``."""
    ds.insert_rows(batch["ins"])
    ds.delete_rows(batch["dele"])
    live = ds.live_slots()
    upd = rng.choice(live[live >= 64], size=len(batch["upd_rows"]),
                     replace=False)
    ds.update_rows(upd, batch["upd_rows"])


@contextlib.contextmanager
def checks_off():
    """A context in which fatal status flags are advisory (REPRO_CHECKS=0):
    the hashed streaming paths saturate their overflow region by design,
    which raises under checks; their callers assert the status instead."""
    old = os.environ.get("REPRO_CHECKS")
    os.environ["REPRO_CHECKS"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["REPRO_CHECKS"]
        else:
            os.environ["REPRO_CHECKS"] = old


def assert_live(ds, *arrays, what: str) -> None:
    import numpy as np
    for a in arrays:
        a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
        assert ds.is_live(a.reshape(-1)), f"{what}: a draw on a dead slot"


def fresh_degrees(ds, ker):
    """Degrees of the live rows of ``ds`` recomputed from scratch through
    the blocksum kernel (a fresh exact-block estimator), dead slots 0."""
    from repro_torch.core.kde.base import ExactBlockKDE
    from repro_torch.core.sampling.vertex import streaming_degrees
    return streaming_degrees(ExactBlockKDE(ds.x_pad, ker, block_size=ST_BS,
                                           device=ds.device), ds)


def stream_edge_law(ds, bs, u, v, deg) -> str:
    """Chi-square checks (alpha 1e-3) of streaming edges: sources per
    level-1 block against the live degrees' block mass (dead slots carry
    none), destinations by ``neighbor_law`` over the padded rows (dead
    columns carry no kernel mass)."""
    import torch
    dev = ds.device
    x = ds.x_pad
    n = x.shape[0]
    nb = -(-n // bs)
    d = torch.as_tensor(deg, dtype=torch.float64, device=dev)
    blk_mass = torch.zeros(nb, dtype=torch.float64, device=dev)
    blk_mass.index_add_(0, torch.arange(n, device=dev) // bs, d)
    src = torch.as_tensor(u, device=dev)
    dst = torch.as_tensor(v, device=dev)
    got = torch.bincount(src // bs, minlength=nb).double()
    keep = blk_mass > 0
    texts = [chi2_test(got[keep], src.numel() * blk_mass[keep]
                       / blk_mass.sum(), "sources")]
    return "; ".join(texts + neighbor_law(x, src, dst, 1.0 / ST_BW))


def stream_exact(x0, plan, dev, launches, errs, secs, profiles):
    """(a) and (c), exact level 1: ``DynamicDataset`` + ``NeighborSampler(
    dataset=, exact_blocks=True)`` + ``DegreeSampler(nbr.blocks,
    dataset=)``, the bench's streaming loop timed against its rebuild
    baseline, each batch checked, then a journal gap."""
    import numpy as np
    import torch
    from repro_torch.core.dataset import DynamicDataset
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sampling.edge import NeighborSampler
    from repro_torch.core.sampling.vertex import DegreeSampler
    ker = gaussian(ST_BW)
    src = np.arange(ST_FRONT)

    def build():
        ds = DynamicDataset(x0, capacity=ST_CAP, journal_limit=ST_JOURNAL,
                            device=dev)
        nbr = NeighborSampler(ds.x_pad, ker, dataset=ds, exact_blocks=True,
                              block_size=ST_BS, seed=0)
        deg = DegreeSampler(nbr.blocks, seed=1, dataset=ds)
        deg.sample(8)             # builds the initial CDF outside the clock
        nbr.sample(src)
        return ds, nbr, deg

    t0 = time.perf_counter()
    (ds, nbr, deg), taps = counted(launches, "streaming exact: build",
                                   lambda: tapped(build, *kernel_taps(
                                       "blocksum", "sample_block")))
    path_kernel_checks(taps, "streaming build", errs, "streaming")
    secs["streaming (a) build"] = time.perf_counter() - t0
    mrng = np.random.default_rng(7)

    def stream_batch(batch):
        stream_apply(ds, batch, mrng)
        deg.sample(8)             # folds the coalesced degree / CDF patch in
        return nbr.sample(src)    # folds the level-1 patch in

    walls = []
    for i, batch in enumerate(plan[:ST_BATCHES + 1]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, p = counted(launches, "streaming exact: batches",
                       lambda: stream_batch(batch))
        torch.cuda.synchronize()
        if i:                     # batch 0 is the bench's warm-up
            walls.append(time.perf_counter() - t0)
        # checks, off the clock: patched against fresh state
        fresh = fresh_degrees(ds, ker)
        np.testing.assert_allclose(deg.degrees, fresh, **ST_DEG_TOL)
        assert np.all(deg.degrees[~ds.live_host] == 0.0)
        assert_live(ds, v, what="sample")
        p_patch = nbr.prob_of(src, v)
        p_fresh = NeighborSampler(ds.x_pad, ker, exact_blocks=True,
                                  block_size=ST_BS, seed=0,
                                  device=dev).prob_of(src, v)
        np.testing.assert_allclose(p_patch, p_fresh, **ST_PROB_TOL)
        np.testing.assert_allclose(p_patch, p, **ST_PROB_TOL)
    assert deg.rebuilds == 0, "journal gap hit -- the phase is mis-sized"
    t_stream = sum(walls)
    log(f"[streaming] (a) {ST_BATCHES} timed batches of {ST_M} rows at "
        f"n0={ST_N0} (capacity {ST_CAP}, {ds.num_live} live): patched "
        f"degrees within rtol {ST_DEG_TOL['rtol']} / atol "
        f"{ST_DEG_TOL['atol']} of a fresh blocksum recompute after every "
        f"batch, dead slots exactly 0; prob_of of the patched cache within "
        f"rtol {ST_PROB_TOL['rtol']} / atol {ST_PROB_TOL['atol']} of a fresh "
        f"sampler's (masked-blocksum kernel); walls {walls}")

    def more():
        e = nbr.edge_batches(deg.cdf_device, deg.degrees_device, deg.total,
                             ST_EDGES)
        end, path = nbr.walk(src, 4, record_path=True)
        other = ds.live_slots()[1000:1256]
        q = nbr.prob_of(other, np.roll(other, 1))
        return e, end, path, q

    ((u, v, wgt, quv, qvu), end, path, q), taps = counted(
        launches, "streaming exact: edges, walk, prob_of",
        lambda: tapped(more, *kernel_taps("sample_block",
                                          "masked_blocksum")))
    path_kernel_checks(taps, "streaming edges / prob_of", errs, "streaming")
    assert_live(ds, u, v, end, path, what="edge_batches / walk")
    assert np.all(np.isfinite(wgt)) and np.all(q > 0) and np.all(
        np.isfinite(q))
    log(f"[streaming] (a) edge_batches ({ST_EDGES} edges) after the "
        f"patches: {stream_edge_law(ds, ST_BS, u, v, deg.degrees)} "
        f"(alpha 1e-3); walk {ST_FRONT} x 4 and prob_of on a fresh "
        f"frontier: every draw on a live slot")

    # the rebuild baseline: frozen engines over the compacted live rows
    ds2 = DynamicDataset(x0, capacity=ST_CAP, journal_limit=ST_JOURNAL,
                         device=dev)
    mrng2 = np.random.default_rng(7)

    def rebuild_batch(batch):
        stream_apply(ds2, batch, mrng2)
        x_live, _ = ds2.live_x()
        nbr2 = NeighborSampler(x_live, ker, exact_blocks=True,
                               block_size=ST_BS, seed=0, device=dev)
        deg2 = DegreeSampler(nbr2.blocks, seed=1)
        deg2.sample(8)
        nbr2.sample(src)

    rwalls = []
    for i, batch in enumerate(plan[:ST_BATCHES + 1]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rebuild_batch(batch)
        torch.cuda.synchronize()
        if i:
            rwalls.append(time.perf_counter() - t0)
    rows = ST_M * ST_BATCHES
    new_rps, old_rps = rows / t_stream, rows / sum(rwalls)
    log(f"[streaming] (a) update throughput at n0={ST_N0}, m={ST_M} "
        f"({100 * ST_M / ST_N0:.1f}% of the rows a batch): streaming "
        f"{new_rps:.1f} rows/s ({t_stream / ST_BATCHES:.4f} s a batch), "
        f"rebuild {old_rps:.1f} rows/s ({sum(rwalls) / ST_BATCHES:.4f} s a "
        f"batch), speedup {new_rps / old_rps:.2f}x (bench_streaming's "
        f"speedup); rebuild walls {rwalls}")
    secs["streaming (a)"] = t_stream + sum(rwalls)
    del ds2
    it = iter(plan[ST_BATCHES + 1:ST_BATCHES + 3])
    profiles["streaming batch (exact)"] = device_profile(
        lambda: stream_batch(next(it)))

    # (c) past the journal: 6 batches unread, then every consumer rebuilds
    for batch in plan[ST_BATCHES + 3:ST_BATCHES + 9]:
        stream_apply(ds, batch, mrng)
    assert ds.mutations_since(deg._ds_epoch) is None
    v, p = counted(launches, "streaming exact: after a journal gap",
                   lambda: (deg.sample(8), nbr.sample(src))[1])
    est = deg._estimator
    assert deg.rebuilds == 1 and type(est).__name__ == "StratifiedKDE"
    assert (est.block_size, est.samples_per_block) == (ST_BS, ST_BS)
    np.testing.assert_allclose(deg.degrees, fresh_degrees(ds, ker),
                               **ST_DEG_TOL)
    assert_live(ds, v, deg.sample(4096), what="after the gap")
    p_fresh = NeighborSampler(ds.x_pad, ker, exact_blocks=True,
                              block_size=ST_BS, seed=0,
                              device=dev).prob_of(src, v)
    np.testing.assert_allclose(nbr.prob_of(src, v), p_fresh, **ST_PROB_TOL)
    log(f"[streaming] (c) exact: {len(plan[ST_BATCHES + 3:ST_BATCHES + 9])} "
        f"batches past the journal ({ST_JOURNAL} entries): the degree "
        f"sampler rebuilt its estimator as a StratifiedKDE (block size "
        f"{est.block_size}, {est.samples_per_block} samples a block -- the "
        f"reference's outcome for an exact-block estimator), degrees "
        f"within the fresh recompute's tolerance, the neighbor sampler "
        f"rebuilt (prob_of as a fresh one's), every draw live")
    return ds


def hash_consistent(est, ds) -> None:
    """The patched layout's invariants on the card and on the host: the
    device state equals the patcher's mirrors, no dead slot is stored
    (bucket or overflow), every live self-stored slot is in its bucket or
    in the overflow region."""
    import numpy as np
    p, st = est._patcher, est.state
    for name in ("members", "counts", "point_bucket", "self_stored",
                 "overflow"):
        assert np.array_equal(getattr(st, name).cpu().numpy(),
                              getattr(p, name)), name
    cnt = p.counts
    valid = np.arange(p.members.shape[1])[None, :] < cnt[:, None]
    stored = np.zeros(len(p.self_stored), bool)
    stored[p.members[valid]] = True
    stored[p.overflow[p.overflow >= 0]] = True
    live = ds.live_host
    assert not stored[~live].any(), "a dead slot is stored"
    assert np.all(stored[live & (p.self_stored > 0)]), \
        "a self-stored live slot is missing"


def hash_patch_parity(x0, plan, dev) -> str:
    """tests/test_streaming.py:177-202 at this size: deletes and in-place
    updates (same cells) patched into a ``HashedKDE(dataset=)`` layout
    equal a fresh ``build_hash_state(live=, overflow_cap=)``, and
    the same FAR draw gives the same NEAR counts and estimates (rtol 1e-6)
    through the weighted-kv-sum kernel.  Bucket ids are compared through
    the rows: a delete that empties a cell leaves its key in the frozen
    key set, where a rebuild drops it.  The contract holds for untruncated
    buckets only (``HashPatcher.exact_parity``; a truncated bucket is a
    seeded subsample a rebuild redraws), so the cells are ``PARITY_CELL``
    wide: at the default (2 bandwidths) this data falls in ~76 buckets,
    nearly all truncated."""
    import numpy as np
    import torch
    from repro_torch.core.dataset import DynamicDataset
    from repro_torch.core.kde.hashed import HashedKDE
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.kernels.kde_hash import ops as hops
    ker = gaussian(ST_BW)
    ds = DynamicDataset(x0, capacity=ST_CAP, device=dev)
    est = HashedKDE(None, ker, seed=5, dataset=ds,
                    cell_width=PARITY_CELL)
    assert not bool(est.state.truncated.any())
    ds.delete_rows(plan[0]["dele"])
    upd = ds.live_slots()[64:64 + ST_M // 3]
    ds.update_rows(upd, ds.x_pad[torch.as_tensor(upd.astype(np.int64),
                                                 device=dev)].cpu().numpy())
    est._sync()
    assert est.rebuilds == 0 and est._patcher.exact_parity
    cap = est.state.overflow.shape[0]
    fresh, _ = hops.build_hash_state(ds.x_pad, ker, seed=5,
                                     cell_width=PARITY_CELL,
                                     live=ds.live_host, overflow_cap=cap,
                                     device=dev)
    # bucket ids shift where a delete empties a cell (the frozen key set
    # keeps it, a rebuild drops it), so compare each row's bucket
    live = torch.as_tensor(ds.live_slots().astype(np.int64), device=dev)
    dead = torch.as_tensor(np.flatnonzero(~ds.live_host), device=dev)

    def layout(st):
        b = st.point_bucket[live]
        cnt = st.counts[b]
        rows = st.members[b]
        valid = torch.arange(rows.shape[1], device=dev)[None, :] \
            < cnt[:, None]
        return cnt, torch.where(valid, rows, -1), st.point_bucket[dead]

    for a, b in zip(layout(est.state), layout(fresh)):
        assert torch.equal(a, b)
    assert torch.equal(est.state.self_stored, fresh.self_stored)
    assert torch.equal(est.state.overflow, fresh.overflow)
    gen = torch.Generator(device=dev).manual_seed(3)
    y = ds.x_pad[torch.as_tensor(ds.live_slots()[:BATCH].astype(np.int64),
                                 device=dev)]
    fidx = hops.draw_query_noise(BATCH, est._cfg["num_far"], ds.n, gen, dev)
    cfg = {k: v for k, v in est._cfg.items() if k != "pairwise"}
    e1, c1, _ = hops.hashed_query(ds.x_pad, y, est.state, fidx, **cfg)
    e2, c2, _ = hops.hashed_query(ds.x_pad, y, fresh, fidx, **cfg)
    assert torch.equal(c1, c2)
    close(e1, e2, "patched hash state against a fresh build", atol=0.0,
          rtol=1e-6)
    return (f"cell width {PARITY_CELL} ({est.state.keys.numel()} buckets, "
            f"none truncated), {len(plan[0]['dele'])} deletes + {len(upd)} "
            f"same-cell updates: every live row's bucket (count, members in "
            f"slot order), dead rows unbucketed, self_stored and overflow "
            f"bitwise a fresh build's; {BATCH} queries under one FAR draw: "
            f"NEAR counts equal, estimates within rtol 1e-6")


def stream_hash_run(x0, plan, dev, launches, precision: str, batches: int):
    """(b): the hashed streaming engine on the plan -- f32 through
    ``StreamingKernelGraph(level1="hash")``, bf16 from the same parts with
    ``precision="bf16"``.  After each batch: vertices, neighbors, edges and
    walks on live slots only, the patched layout's invariants, the counter
    formula at the overflow width, the status (only the benign flags and
    the overflow region's saturation, which compacts); bf16: the bf16 copy
    bitwise the rounded current rows, bf16 instances only.  Returns the
    graph-like (dataset, neighbor sampler, degree sampler)."""
    import numpy as np
    import torch
    from repro_torch.core.dataset import DynamicDataset
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sampling.edge import NeighborSampler
    from repro_torch.core.sampling.vertex import DegreeSampler
    from repro_torch.core.streaming import StreamingKernelGraph
    from repro_torch.ft import guards as tg
    from repro_torch.kernels.kde_sampler.ref import round_bf16
    ker = gaussian(ST_BW)
    tag = f"streaming hash {precision}"

    def build():
        if precision == "f32":
            g = StreamingKernelGraph(x0, ker, capacity=ST_CAP, level1="hash",
                                     seed=0, block_size=ST_BS, device=dev)
            return g.dataset, g.nbr, g.deg
        ds = DynamicDataset(x0, capacity=ST_CAP, device=dev)
        nbr = NeighborSampler(ds.x_pad, ker, dataset=ds, level1="hash",
                              block_size=ST_BS, seed=0, precision="bf16")
        return ds, nbr, DegreeSampler(nbr.hash_estimator, seed=1,
                                      dataset=ds)

    ds, nbr, deg = counted(launches, f"{tag}: build", build)
    est = nbr.hash_estimator
    mb, ov = est.state.members.shape[1], est.state.overflow.shape[0]
    cols1 = mb + ov + nbr.num_blocks * nbr._far_per_block
    assert nbr._level1_evals(1) == cols1
    mrng = np.random.default_rng(7)
    benign = tg.BUCKET_OVERFLOW | tg.HT_HEAVY | tg.REJECT_EXHAUSTED \
        | tg.OVERFLOW_SATURATED
    fills = []
    for batch in plan[:batches]:
        stream_apply(ds, batch, mrng)
        before = nbr.evals
        ov_before = nbr.device_counters["overflow"]

        def reads():
            u = deg.sample(BATCH)
            v, q = nbr.sample(u)
            e = nbr.edge_batches(deg.cdf_device, deg.degrees_device,
                                 deg.total, ST_EDGES, batch=BATCH)
            end, path = nbr.walk(u[:256], 4, record_path=True)
            return u, v, q, e, end, path

        with checks_off():
            u, v, q, e, end, path = counted(launches, f"{tag}: batches",
                                            reads)
        fills.append(est._patcher.overflow_fill)
        assert_live(ds, u, v, e[0], e[1], end, path, what=tag)
        assert np.all(np.isfinite(q)) and np.all(np.isfinite(e[2]))
        assert (nbr.status | est.status) & ~benign == 0, \
            tg.decode_status(nbr.status | est.status)
        hash_consistent(est, ds)
        bs, ww = nbr.block_size, len(u[:256])
        drawn = -(-ST_EDGES // BATCH) * BATCH
        want = (BATCH * cols1 + BATCH * bs) \
            + (drawn * cols1 + drawn * bs + drawn) \
            + 4 * (ww * cols1 + ww * bs)
        assert nbr.evals - before == want, (nbr.evals - before, want)
        assert nbr.device_counters["overflow"] - ov_before \
            == (BATCH + drawn + 4 * ww) * ov
        if precision == "bf16":
            fresh = round_bf16(ds.x_pad).to(torch.bfloat16)
            assert torch.equal(est.state.x_bf16.view(torch.int16),
                               fresh.view(torch.int16)), \
                "the bf16 copy is stale"
    log(f"[streaming] (b) {precision}: {batches} batches, draws live, "
        f"layout invariants held, counters at the overflow width "
        f"(level-1 read {cols1} columns a row: max_bucket {mb} + overflow "
        f"{ov} + {nbr.num_blocks} blocks x {nbr._far_per_block} FAR), "
        f"overflow fill after each batch {fills}, {est.rebuilds} "
        f"compactions (saturation: {tg.decode_status(est.status)})")
    return ds, nbr, deg


def weighted_overflow_timing(ds, nbr, dev, card) -> None:
    """The weighted-kv kernels at the overflow width, timed (CUDA events,
    profiler device time) beside their plain versions and bounds: the
    degree query (t = max_bucket + overflow + num_far) and the level-1
    frontier read (t = max_bucket + overflow + B far_per_block)."""
    import numpy as np
    import torch
    from repro_torch.kernels.kde_hash import kernel as hk
    from repro_torch.kernels.kde_hash import ops as hops
    from repro_torch.kernels.kde_hash import ref as href
    est = nbr.hash_estimator
    state, x, n = est.state, ds.x_pad, ds.n
    gen = torch.Generator(device=dev).manual_seed(11)
    live = torch.as_tensor(ds.live_slots().astype(np.int64), device=dev)
    src = live[torch.randint(0, live.numel(), (BATCH,), generator=gen,
                             device=dev)]
    q = x[src].contiguous()
    nf = est._cfg["num_far"]
    fidx = hops.draw_query_noise(BATCH, nf, n, gen, dev)
    qcols, qwgt, _, _ = href.query_gather(q, state, fidx, est.cell_width,
                                          nf, n)
    nb, fpb = nbr.num_blocks, nbr._far_per_block
    off = hops.draw_frontier_noise(BATCH, nb, fpb, nbr.block_size, gen, dev)
    fcols, fwgt, _, _ = href.frontier_gather(src, state, off, fpb,
                                             nbr.block_size, nb, n)
    d = x.shape[1]
    for name, cols, wgt, sum_out in (("weighted_kv_sum", qcols, qwgt, True),
                                     ("weighted_kv", fcols, fwgt, False)):
        kern = hk.weighted_kv_sum_cuda if sum_out else hk.weighted_kv_cuda
        plain = hk.weighted_kv_sum_plain if sum_out else hk.weighted_kv_plain
        args = (q, x, cols, wgt, "gaussian", 1.0 / ST_BW)
        err = close_scaled(kern(*args), plain(*args),
                           f"{name} at the overflow width")
        m, t = cols.shape
        uniq = torch.unique(cols).numel()
        b_ms, b_by = bound(m * t * (pair_ops("gaussian", d) + 1),
                           4 * (m * d + 2 * m * t + (m if sum_out else m * t)
                                + uniq * d))
        ms = timed(lambda: kern(*args), 50)
        dms = kernel_device_ms(lambda: kern(*args), "weighted_kv", 50)
        log(f"[streaming] {name} at the overflow width: m={m} t={t} d={d} "
            f"({uniq} distinct rows) {hk.weighted_kv_plan(m, n, d, t)}: "
            f"{ms:.4f} ms (device {dms}), plain "
            f"{timed(lambda: plain(*args), 5):.4f} ms, bound {b_ms:.5f} ms "
            f"by {b_by}, max abs err {err:.3e}; {card}")


def phase_streaming(dev):
    """Phase 13: the streaming engine at the reference's streaming bench,
    scaled to n0 = 262,144.  Returns (launches by path, seconds by part,
    errors by kernel)."""
    import numpy as np
    card = card_line()
    launches, secs, errs, profiles = {}, {}, {}, {}
    rng = np.random.default_rng(0)
    x0 = rng.normal(0, 0.5, (ST_N0, ST_D)).astype(np.float32)
    plan = stream_plan(rng, ST_N0, ST_D, ST_M, ST_BATCHES + 9)
    t0 = time.perf_counter()
    stream_exact(x0, plan, dev, launches, errs, secs, profiles)
    secs["streaming (a, c)"] = time.perf_counter() - t0
    free_cuda()
    t0 = time.perf_counter()
    log(f"[streaming] (b) patch parity: {hash_patch_parity(x0, plan, dev)}")
    ds, nbr, _ = stream_hash_run(x0, plan, dev, launches, "f32",
                                 ST_BATCHES + 1)
    weighted_overflow_timing(ds, nbr, dev, card)
    builds = nbr.hash_estimator.rebuilds
    ds.compact()              # (c), hashed: a structural journal gap
    g_reads = counted(launches, "streaming hash f32: after compact",
                      lambda: nbr.sample(ds.live_slots()[:BATCH]))
    assert_live(ds, g_reads[0], what="after compact")
    assert nbr.hash_estimator.rebuilds == builds + 1
    log(f"[streaming] (c) hash: compact (slot ids change: the journal "
        f"cannot bridge it) -> the hash layout rebuilt "
        f"({nbr.hash_estimator.rebuilds} layout builds since the start), "
        f"draws live")
    del ds, nbr
    free_cuda()
    stream_hash_run(x0, plan, dev, launches, "bf16", 3)
    secs["streaming (b)"] = time.perf_counter() - t0
    free_cuda()
    for what, prof in profiles.items():
        log(f"[streaming] profile of one {what}: {profile_text(*prof)}")
    log(f"[streaming] launches by path: {launches}; {card}")
    return launches, secs, errs


# --------------------------------------------------------------------- #
# phase 14: the remaining estimators
# --------------------------------------------------------------------- #
def phase_estimators(data, dev):
    """Phase 14: ``GridHBE`` on phase 3's data, ``RobustEstimator`` on
    phase 6's (clean and planted paths), tree-mode sampling over a
    ``MultiLevelKDE`` of ``ExactKDE`` nodes.  Returns (launches by path,
    seconds, errors by kernel)."""
    import numpy as np
    import torch
    from repro_torch.core import MultiLevelKDE
    from repro_torch.core.kde.base import ExactKDE, make_estimator
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sampling.edge import NeighborSampler
    from repro_torch.ft.guards import RobustEstimator
    from repro_torch.kernels.kde_rowsum import kernel as rk
    launches, errs = {}, {}
    t0 = time.perf_counter()
    # GridHBE (the host oracle of the hashed family): pairwise on the card
    x = torch.as_tensor(data["sp_x_np"], device=dev)
    n = x.shape[0]
    q = x[::n // HBE_QUERIES][:HBE_QUERIES].contiguous()
    ker = gaussian(SP_BW)
    hbe = counted(launches, "grid_hbe", lambda: make_estimator(
        "grid_hbe", x, ker, seed=0, num_far_samples=HBE_FAR, device=dev))
    vals = counted(launches, "grid_hbe", lambda: hbe.query(q))
    truth = rk.rowsum_cuda(q, x, "gaussian", 1.0 / SP_BW)
    rel = (vals.double() / truth.double() - 1.0).abs()
    assert float(rel.mean()) < HBE_REL and hbe.evals < HBE_QUERIES * n, \
        (float(rel.mean()), hbe.evals)
    log(f"[estimators] GridHBE (num_far_samples {HBE_FAR}) on phase 3's "
        f"data (n {n}, d {x.shape[1]}), {HBE_QUERIES} queries: mean rel err "
        f"{float(rel.mean()):.4f} (bound {HBE_REL}), max "
        f"{float(rel.max()):.4f}; evals {hbe.evals} < m n = "
        f"{HBE_QUERIES * n}; launches {launches.get('grid_hbe', {})}")
    assert not launches.get("grid_hbe"), "GridHBE launched a kernel"
    # RobustEstimator on phase 6's data
    hx = torch.as_tensor(data["hs_x_np"], device=dev)
    hn = hx.shape[0]
    rob = RobustEstimator(hx, gaussian(HS_BW), seed=0, device=dev)
    qc = hx[::hn // ROBUST_CLEAN][:ROBUST_CLEAN].contiguous()
    (vc, taps) = counted(launches, "robust clean", lambda: tapped(
        lambda: rob.query(qc), *kernel_taps("weighted_kv_sum")))
    path_kernel_checks(taps, "robust clean path", errs, "estimators")
    assert bool((vc > 0).all()) and bool(torch.isfinite(vc).all())
    assert set(rob._stages) == {"hash"} and rob.retries == 0
    assert sum(rob.escalations.values()) == 0
    assert launches["robust clean"] == {"weighted_kv_sum": 1}, \
        launches["robust clean"]
    far = (hx[:ROBUST_PLANTED] + 100.0).contiguous()
    rob2 = RobustEstimator(hx, gaussian(HS_BW), seed=0, device=dev,
                           stage_kw={"hash": {"num_far_samples": 0}})
    (vp, taps) = counted(launches, "robust planted", lambda: tapped(
        lambda: rob2.query(far), *kernel_taps("rowsum")))
    path_kernel_checks(taps, "robust planted path", errs, "estimators")
    assert rob2.escalations == {"stratified": ROBUST_PLANTED,
                                "exact": ROBUST_PLANTED}, rob2.escalations
    assert rob2.retries == 2 * ROBUST_PLANTED, rob2.retries
    want = rk.rowsum_cuda(far, hx, "gaussian", 1.0 / HS_BW)
    assert torch.equal(vp, want), "the exact stage is not the rowsum's"
    assert launches["robust planted"] == {"weighted_kv_sum": 2,
                                          "rowsum": 1}, \
        launches["robust planted"]
    log(f"[estimators] RobustEstimator on phase 6's data (n {hn}): "
        f"{ROBUST_CLEAN} clean queries built only the hash stage "
        f"(launches {launches['robust clean']}, evals {rob.evals}); "
        f"{ROBUST_PLANTED} planted queries far from every bucket (hash "
        f"NEAR-only): 0 at the hash stage, retried, escalated "
        f"{rob2.escalations}, retries {rob2.retries}, the exact stage's "
        f"rows equal to the rowsum kernel's (launches "
        f"{launches['robust planted']})")
    secs = {"estimators (grid_hbe, robust)": time.perf_counter() - t0}
    # tree mode: the paper's literal descent, a rowsum launch a segment
    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    xt = torch.as_tensor(rng.normal(0, 0.5, (TREE_N, TREE_D)).astype(
        np.float32), device=dev)
    tk = gaussian(SP_BW)
    tree = MultiLevelKDE(xt, tk, lambda xs, s: ExactKDE(xs, tk, device=dev),
                         leaf_size=TREE_LEAF, seed=0, device=dev)
    nbr = NeighborSampler(xt, tk, mode="tree", tree=tree, seed=0, device=dev)
    # TREE_DRAWS draws from each source, for the law's chi-square
    src = np.repeat(rng.choice(TREE_N, TREE_SRC, replace=False), TREE_DRAWS)
    (v, p), taps = counted(launches, "tree mode", lambda: tapped(
        lambda: nbr.sample(src), *kernel_taps("rowsum")))
    path_kernel_checks(taps, "tree descent", errs, "estimators")
    levels = tree.depth - 1
    assert launches["tree mode"] == {"rowsum": 2 * levels * len(src)}, \
        (launches["tree mode"], levels)
    assert np.all(v != src) and np.all(p > 0)
    law = neighbor_law(xt, torch.as_tensor(src, device=dev),
                       torch.as_tensor(v, device=dev), 1.0 / SP_BW)
    secs["estimators (tree)"] = time.perf_counter() - t0
    log(f"[estimators] tree mode (n {TREE_N}, leaf {TREE_LEAF}, depth "
        f"{tree.depth}, ExactKDE nodes), {TREE_SRC} sources x {TREE_DRAWS} "
        f"draws: "
        f"{'; '.join(law)} (alpha 1e-3); rowsum launches 2 x {levels} a "
        f"source = {launches['tree mode']['rowsum']}; tree evals "
        f"{tree.evals}, {secs['estimators (tree)']:.2f} s")
    return launches, secs, errs


# --------------------------------------------------------------------- #
# phase 15: serving
# --------------------------------------------------------------------- #
def serve_plan(rng, n, d, S, R, ticks, near=None):
    """bench_serve._request_plan: one (tenant, op, payload, seed) entry a
    request, the same (op, tenant) mix every tick, payloads drawn anew.
    ``near`` (the tenants' datasets): query points are tenant rows plus
    N(0, 0.1) noise instead of N(0, 0.6) points (clustered data far from
    the origin would give them no kernel mass: ZERO_MASS)."""
    import numpy as np
    plan = []
    for t in range(ticks):
        tick = []
        for r in range(R):
            tenant = (r // 4) % S
            op = ("sample", "query", "walk", "prob_of")[r % 4]
            seed = 10_000 * t + r
            if op == "sample":
                payload = dict(src=rng.integers(0, n, size=SV_SAMPLE_W))
            elif op == "query" and near is not None:
                rows = near[tenant][rng.integers(0, n, size=SV_QUERY_Q)]
                payload = dict(y=(rows + rng.normal(0, 0.1, size=rows.shape))
                               .astype(np.float32))
            elif op == "query":
                payload = dict(y=rng.normal(0, 0.6, size=(SV_QUERY_Q, d))
                               .astype(np.float32))
            elif op == "walk":
                payload = dict(starts=rng.integers(0, n, size=SV_WALK_W),
                               length=SV_WALK_LEN)
            else:
                payload = dict(src=rng.integers(0, n, size=SV_SAMPLE_W),
                               dst=rng.integers(0, n, size=SV_SAMPLE_W))
            tick.append((tenant, op, payload, seed))
        plan.append(tick)
    return plan


def submit_tick(srv, tick):
    return [srv.submit(f"t{tenant}", op, seed=seed, **payload)
            for tenant, op, payload, seed in tick]


def serve_bench(datasets, ker, level1s, dev, launches, path, exact=False,
                block_size=SV_BS, ticks=SV_TICKS, rng_seed=0):
    """bench_serve._measure on the card: the servable over ``ticks`` timed
    ticks after one warm-up tick (``failed == 0`` in every tick), then the
    sequential driver (one engine call a request, each ending on the host)
    over the same requests, then a profiled tick.  Returns a dict: the
    servable, p50 / p99 ms, served and sequential req/s, the per-tick
    launch counts, tick stats and requests, the plan, the profile."""
    import numpy as np
    import torch
    from repro_torch.core.serving import KernelGraphServable
    S = len(datasets)
    n, d = datasets[0].shape
    rng = np.random.default_rng(rng_seed)
    plan = serve_plan(rng, n, d, S, SV_R, ticks + 3,
                      near=datasets if exact else None)
    warmup, plan, extra = plan[0], plan[1:ticks + 1], plan[ticks + 1:]
    srv = KernelGraphServable(max_resident=S, device=dev)
    for i, x in enumerate(datasets):
        srv.add_tenant(f"t{i}", x, ker, block_size=block_size,
                       level1=level1s[i], exact_blocks=exact, seed=i)
    rs = submit_tick(srv, warmup)
    st = srv.tick()
    assert st["failed"] == 0, (path, st, [
        repr(r.error) for r in rs if r.error is not None][:4])
    torch.cuda.synchronize()
    lat, per_tick, stats, reqs = [], [], [], []
    t0 = time.perf_counter()
    for tick in plan:
        rs = submit_tick(srv, tick)
        before = {k: dict(v) for k, v in launches.items()}
        st = counted(launches, path, srv.tick)
        assert st["failed"] == 0, (path, st, [
            repr(r.error) for r in rs if r.error is not None])
        per_tick.append({k: launches[path].get(k, 0)
                         - before.get(path, {}).get(k, 0)
                         for k in launches.get(path, {})})
        stats.append(st)
        reqs.append(rs)
        lat.extend(r.latency for r in rs)
    t_served = time.perf_counter() - t0
    samplers = [srv.tenant(f"t{i}").admit() for i in range(S)]

    def run_one(tenant, op, payload):
        nbr = samplers[tenant]
        if op == "sample":
            return nbr.sample(payload["src"])
        if op == "walk":
            return nbr.walk(payload["starts"], payload["length"])
        if op == "prob_of":
            return nbr.prob_of(payload["src"], payload["dst"])
        if nbr.level1 == "hash":
            return nbr.hash_estimator.query(payload["y"]).cpu()
        return nbr.blocks.query(payload["y"]).cpu()

    for tenant, op, payload, _ in warmup:
        run_one(tenant, op, payload)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tick in plan:
        for tenant, op, payload, _ in tick:
            run_one(tenant, op, payload)
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    lat_ms = 1e3 * np.asarray(lat)
    it = iter(extra)

    def one_tick():
        submit_tick(srv, next(it))
        st = srv.tick()
        assert st["failed"] == 0, st
    prof = device_profile(one_tick)
    return dict(srv=srv, p50=float(np.percentile(lat_ms, 50)),
                p99=float(np.percentile(lat_ms, 99)),
                rps=ticks * SV_R / t_served, seq_rps=ticks * SV_R / t_seq,
                per_tick=per_tick, stats=stats, reqs=reqs, plan=plan,
                profile=prof)


def serve_bench_line(tag, res, card):
    return (f"[serve] ({tag}) p50 {res['p50']:.4f} ms, p99 "
            f"{res['p99']:.4f} ms, served {res['rps']:.1f} req/s, "
            f"sequential {res['seq_rps']:.1f} req/s, ratio "
            f"{res['rps'] / res['seq_rps']:.3f}; one tick: "
            f"{profile_text(*res['profile'])}; {card}")


def serve_exact_checks(res, dev, errs):
    """(b)'s per-request checks: each group one launch of each tenant-axis
    kernel (the walk group one a step); the tenant-axis launches bitwise
    the per-tenant launches on the same rows and within phase 2's
    tolerances of their plain versions; each served ``sample`` the
    single-request program fed its noise (neighbors and block draws
    equal, probabilities within rtol 1e-6), each ``prob_of`` and
    ``query`` within rtol 1e-6 of it; the draws by ``neighbor_law``."""
    import inspect

    import numpy as np
    import torch
    from repro_torch.core.serving import _host_gen, _pad_idx, shape_bucket
    from repro_torch.kernels.kde_rowsum import kernel as rk
    from repro_torch.kernels.kde_sampler import kernel as sk
    from repro_torch.kernels.kde_sampler import ops as sops
    srv = res["srv"]
    want = {"sample_block": 1 + SV_WALK_LEN, "masked_blocksum": 1,
            "blocksum": 1}
    for st, per in zip(res["stats"], res["per_tick"]):
        assert st["groups"] == 4, st
        assert {k: v for k, v in per.items() if v} == want, (per, want)
    # one more tick with every kernel wrapper tapped
    submit_tick(srv, res["plan"][0])
    st, taps = tapped(srv.tick, *kernel_taps(
        "sample_block", "masked_blocksum", "blocksum"))
    assert st["failed"] == 0 and sorted(taps) == sorted(
        f"{k}_cuda" for k in want), sorted(taps)
    path_kernel_checks(taps, "serve (b) tenant-axis launch", errs, "serve")
    for attr, (args, kw, got) in taps.items():
        fn = getattr(kernel_mods()[attr[:-5]], attr)
        a = inspect.signature(fn).bind(*args, **kw).arguments
        base = a.pop("tile_base")
        xa = a.pop("x")
        n, d = xa.shape[1], xa.shape[2]
        bm = rk.blocksum_tile_rows(d) if attr == "blocksum_cuda" \
            else sk.tile_rows(d)
        row_base = base.long().repeat_interleave(bm)[:len(a["q"])]
        singles = []
        for b in torch.unique(row_base).tolist():
            rows = torch.nonzero(row_base == b)[:, 0]
            sub = {k: (v[rows] if torch.is_tensor(v) and v.dim() and
                       v.shape[0] == len(a["q"]) else v)
                   for k, v in a.items()}
            one = fn(x=xa[b // n], **sub)
            gots = got if isinstance(got, tuple) else (got,)
            ones = one if isinstance(one, tuple) else (one,)
            for g, o in zip(gots, ones):
                assert torch.equal(g[rows], o), (attr, b)
            singles.append((sub, b // n))
        log(f"[serve] (b) {attr[:-5]}: the tenant-axis launch "
            f"(m {len(a['q'])}, {len(base)} tiles of {bm} rows, "
            f"{len(singles)} tenants) bitwise equal to the per-tenant "
            f"launches on the same rows")
        # the tenant-axis launch against R single-request launches (one a
        # request of the group, each on its tenant's rows)
        grp = [r for r in res["reqs"][0] if r.op == {
            "sample_block_cuda": "sample", "masked_blocksum_cuda": "prob_of",
            "blocksum_cuda": "query"}[attr]]
        w = SV_QUERY_Q if attr == "blocksum_cuda" else SV_SAMPLE_W
        one_req = {k: (v[:w] if torch.is_tensor(v) and v.dim() and
                       v.shape[0] == len(a["q"]) else v)
                   for k, v in a.items()}
        tenant_call = lambda: fn(x=xa, tile_base=base, **a)   # noqa: E731
        single_calls = lambda: [fn(x=xa[0], **one_req)        # noqa: E731
                                for _ in grp]
        name = {"sample_block_cuda": "sampler_", "masked_blocksum_cuda":
                "sampler_", "blocksum_cuda": "blocksum"}[attr]
        t_ms, s_ms = timed(tenant_call, 50), timed(single_calls, 50)
        t_dev = kernel_device_ms(tenant_call, name, 20)
        s_dev = kernel_device_ms(single_calls, name, 20)
        fmt = lambda v: "not measured" if v is None else f"{v:.5f}"  # noqa
        log(f"[serve] (b) {attr[:-5]} at (b)'s group shape: one tenant-axis "
            f"launch {t_ms:.5f} ms (device {fmt(t_dev)}) against "
            f"{len(grp)} single-request launches of {w} rows "
            f"{s_ms:.5f} ms (device {fmt(s_dev)}); {card_line()}")
    # each request against the single-request program fed its noise
    nb_all, mismatches = {}, 0
    for rs in res["reqs"]:
        for r in rs:
            nbr, i = srv.tenant(r.tenant).admit(), int(r.tenant[1:])
            gen = _host_gen(r.seed)
            if r.op == "sample":
                src = np.asarray(r.payload["src"])
                wb = shape_bucket(len(src))
                noise = tuple(u.to(dev) for u in sops.draw_sample_noise(
                    wb, nbr.num_blocks, gen, "cpu", **nbr._noise_cfg))
                nb, p, _, _ = sops.fused_sample(
                    nbr.x, nbr.x_sq, torch.as_tensor(_pad_idx(src, wb),
                                                     device=dev),
                    *noise, views=nbr._views, **nbr._cfg)
                nb, p = nb.cpu().numpy()[:len(src)], p.cpu().numpy()
                assert np.array_equal(nb, r.result[0]), r.tenant
                np.testing.assert_allclose(r.result[1], p[:len(src)],
                                           rtol=1e-6)
                s, v = nb_all.setdefault(i, ([], []))
                s.append(src)
                v.append(nb)
            elif r.op == "prob_of":
                src = torch.as_tensor(np.asarray(r.payload["src"]),
                                      device=dev)
                bs, _ = sops.masked_block_sums(nbr.x, nbr.x_sq, src,
                                               **nbr._cfg)
                p, _ = sops.prob_of_from_block_sums(
                    nbr.x, nbr.x_sq, src, torch.as_tensor(
                        np.asarray(r.payload["dst"]), device=dev), bs,
                    nbr._views, **nbr._l2_cfg)
                np.testing.assert_allclose(r.result, p.cpu().numpy(),
                                           rtol=1e-6)
            elif r.op == "query":
                est = nbr.blocks.query(torch.as_tensor(r.payload["y"],
                                                       device=dev))
                np.testing.assert_allclose(r.result, est.cpu().numpy(),
                                           rtol=1e-6)
    laws = neighbor_law(
        [srv.tenant(f"t{i}").nbr.x for i in sorted(nb_all)],
        [torch.as_tensor(np.concatenate(nb_all[i][0]), device=dev)
         for i in sorted(nb_all)],
        [torch.as_tensor(np.concatenate(nb_all[i][1]), device=dev)
         for i in sorted(nb_all)], 1.0 / SV_BW)
    log(f"[serve] (b) every sample request's neighbors equal the "
        f"single-request program's on its noise (probabilities within "
        f"rtol 1e-6), every prob_of and query within rtol 1e-6; "
        f"{sum(len(np.concatenate(v[0])) for v in nb_all.values())} "
        f"draws of {len(nb_all)} tenants: {'; '.join(laws)} (alpha 1e-3)")


def serve_lru_check(datasets, dev, launches):
    """(b) with ``max_resident`` 2: each tick touches tenants in a planned
    order; admissions, evictions and the resident set follow the LRU rule
    (a Python model of it), and every request is served."""
    import numpy as np
    from collections import OrderedDict
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.serving import KernelGraphServable
    srv = KernelGraphServable(max_resident=2, device=dev)
    for i, x in enumerate(datasets):
        srv.add_tenant(f"t{i}", x, gaussian(SV_BW), block_size=SVB_BS,
                       exact_blocks=True, seed=i)
    lru, adm, ev = OrderedDict(), 0, 0
    order = [[0, 1], [2], [0], [1, 3], [3], [2, 0, 1]]
    rng = np.random.default_rng(5)
    for k, touched in enumerate(order):
        for t in touched:
            srv.submit(f"t{t}", "sample", seed=k,
                       src=rng.integers(0, SVB_N, SV_SAMPLE_W))
        st = counted(launches, "serve (b) lru", srv.tick)
        assert st["failed"] == 0, st
        needed = {f"t{t}" for t in touched}
        for name in sorted(needed):
            if name not in lru:
                adm += 1
            lru[name] = True
            lru.move_to_end(name)
            while len(lru) > 2:
                victim = next((c for c in lru if c not in needed), None)
                if victim is None:
                    break
                lru.pop(victim)
                ev += 1
        rep = srv.report()
        assert (rep["admissions"], rep["evictions"], rep["resident"]) == \
            (adm, ev, list(lru)), (k, rep, adm, ev, list(lru))
        assert all(srv.tenant(n).resident == (n in lru)
                   for n in (f"t{i}" for i in range(len(datasets))))
    log(f"[serve] (b) max_resident 2 over {len(order)} ticks touching "
        f"{order}: admissions {adm}, evictions {ev}, resident {list(lru)} "
        f"as the LRU rule gives them")


def serve_cli(launches):
    """(c) the CLI on the card: the multi-tenant mode with hashed tenants
    and a Prometheus dump, the graph-stream mode at the streaming cell's
    n with each level-1 read; every metrics line validated.  The hashed
    graph stream runs with ``REPRO_CHECKS=0``: its random mutations fill
    the overflow region (cap 5,120 at this capacity) by the second tick,
    and under checks ``OVERFLOW_SATURATED`` is an error (exit 3, as the
    reference's driver) where without them it compacts, as phase 13's
    hashed reads do."""
    import io
    from contextlib import redirect_stdout
    from repro_torch.ft import guards
    from repro_torch.launch import serve
    from repro_torch.obs import export, metrics
    runs = [("multi-tenant hash", ["--serve-tenants", "4", "--requests",
                                   "32", "--ticks", "8", "--level1", "hash",
                                   "--telemetry", "--metrics-format",
                                   "prometheus"])] + [
        (f"graph-stream {lv}", ["--graph-stream", str(SV_STREAM_N),
                                "--ticks", "4", "--level1", lv])
        for lv in ("blocked", "hash")]
    secs = {}
    for tag, argv in runs:
        buf = io.StringIO()
        t0 = time.perf_counter()
        metrics.reset()
        checks = os.environ["REPRO_CHECKS"]
        if tag == "graph-stream hash":
            os.environ["REPRO_CHECKS"] = "0"
        try:
            with redirect_stdout(buf):
                rc = counted(launches, f"serve (c) {tag}",
                             lambda: serve.main(argv))
        finally:
            os.environ["REPRO_CHECKS"] = checks
        secs[f"serve (c) {tag}"] = time.perf_counter() - t0
        metrics.disable()
        out = buf.getvalue()
        lines = [json.loads(ln[len(export.METRICS_PREFIX):])
                 for ln in out.splitlines()
                 if ln.startswith(export.METRICS_PREFIX)]
        assert rc == 0 and len(lines) == 1, (tag, rc, out[-2000:])
        export.validate_metrics_line(lines[0])
        m = lines[0]
        if tag.startswith("multi"):
            assert m["failed"] == 0 and "repro_serve_tick_us" in out, m
            log(f"[serve] (c) serve {' '.join(argv)}: exit 0, metrics line "
                f"valid: p50 {m['p50_ms']} ms, p99 {m['p99_ms']} ms, "
                f"{m['throughput_rps']} req/s, served {m['served']}, "
                f"evals {m['realized_evals']}; the Prometheus dump holds "
                f"repro_serve_tick_us")
        else:
            fatal = set(guards.decode_status(guards.FATAL))
            assert m["error"] is None and not fatal & set(m["flags"]), m
            log(f"[serve] (c) serve {' '.join(argv)}: exit 0, metrics line "
                f"valid: {m['mutation_ms_per_tick']} ms mutation, "
                f"{m['query_ms_per_tick']} ms queries a tick, epoch "
                f"{m['epoch']}, live {m['live']}, flags {m['flags']}, "
                f"hash rebuilds {m['hash_rebuilds']}")
    return secs


def phase_serve(dev):
    """Phase 15: (a) bench_serve's own plan, blocked and hash mix; (b)
    exact tenants at phase 3's size; (c) the serve CLI.  Returns (launches
    by path, seconds by part, errors by kernel)."""
    import numpy as np
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.data.synthetic_points import gaussian_clusters
    card = card_line()
    launches, secs, errs = {}, {}, {}
    # (a) bench_serve.py:120-158 -- n 1024, d 8, S 4, R 32, 16 ticks
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    datasets = [rng.normal(0, 0.6, (SV_N, SV_D)).astype(np.float32)
                + 0.1 * i for i in range(SV_S)]
    ker = gaussian(SV_BW)
    for tag, level1s in (("a: blocked", ["blocked"] * SV_S),
                         ("a: hash mix", ["hash" if i % 2 else "blocked"
                                          for i in range(SV_S)])):
        res = serve_bench(datasets, ker, level1s, dev, launches,
                          f"serve ({tag})")
        log(serve_bench_line(tag, res, card))
        if tag.endswith("blocked"):
            assert not launches.get(f"serve ({tag})"), launches
    secs["serve (a)"] = time.perf_counter() - t0
    free_cuda()
    # (b) exact tenants at a real size
    t0 = time.perf_counter()
    big = [gaussian_clusters(n=SVB_N, d=SVB_D, seed=i)[0]
           for i in range(SV_S)]
    res = serve_bench(big, ker, ["blocked"] * SV_S, dev, launches,
                      "serve (b) exact", exact=True, block_size=SVB_BS,
                      ticks=SVB_TICKS, rng_seed=1)
    log(serve_bench_line("b: exact, n 65536 x 4 tenants", res, card))
    serve_exact_checks(res, dev, errs)
    del res
    free_cuda()
    serve_lru_check(big, dev, launches)
    secs["serve (b)"] = time.perf_counter() - t0
    del big
    free_cuda()
    secs.update(serve_cli(launches))
    free_cuda()
    log(f"[serve] launches by path: {launches}; {card}")
    return launches, secs, errs


def train_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 N T for the weight products
    (forward, and the backward's two products of each; the tied embedding
    counted once, as the head) plus the causal attention, 3 (4 b hq dh
    s^2 / 2) a layer (forward and backward).  The recompute of ``remat``
    and the backward's dense (not causal-halved) attention products are
    work the step does, not model FLOPs."""
    attn = 3 * cfg.num_layers * 4 * batch * cfg.num_heads * cfg.hd \
        * seq * seq / 2
    return 6.0 * n_params * batch * seq + attn


def train_flash_rows(errs):
    """The flash kernel at the training shape (b, hq, s, dh) = (1, 32,
    4096, 64) with 8 kv-heads, causal, in f32 and bf16: against its plain
    version (f32 at RTOL / ATOL, bf16 within one bf16 step), its device ms
    (torch.profiler), its bound and SDPA's time on the same inputs.
    Returns {row name: keys for the row}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.testing import assert_bf16_close
    cfg = get_config(TRAIN_ARCH)
    b, hq, hkv, s, dh = (TRAIN_BATCH, cfg.num_heads, cfg.num_kv_heads,
                         TRAIN_SEQ, cfg.hd)
    gen = torch.Generator(device="cuda").manual_seed(16)
    out = {}
    for name, dtype in (("flash_attention", torch.float32),
                        ("flash_attention_bf16", torch.bfloat16)):
        q, k, v = (torch.randn((b, h, s, dh), generator=gen,
                               device="cuda").to(dtype)
                   for h in (hq, hkv, hkv))
        kp, vp, kw = fops.flash_args(q, k, v)
        got, lse = fk.flash_attention_cuda(q, kp, vp, **kw)
        want, want_lse = fk.flash_attention_plain(q, kp, vp, **kw)
        if dtype == torch.float32:
            e = max(close(got, want, "train-shape flash out"),
                    close(lse, want_lse, "train-shape flash lse"))
            b_ms, b_by = bound(4 * b * hq * dh * s * s / 2,
                               4 * (2 * b * hq * s * dh + 2 * b * hkv * s * dh
                                    + b * hq * s))
        else:
            e, steps = assert_bf16_close(got, want, ATOL,
                                         "train-shape flash bf16 out")
            e = max(e, close(lse, want_lse, "train-shape flash bf16 lse"))
            b_ms, b_by = bound(0.0, 2 * (2 * b * hq * s * dh
                                         + 2 * b * hkv * s * dh)
                               + 4 * b * hq * s,
                               bf16_flops=4 * b * hq * dh * s * s / 2)
        errs[name] = max(errs.get(name, 0.0), e)
        del got, lse, want, want_lse
        out[name] = dict(
            train_shape=f"b={b} hq={hq} hkv={hkv} s={s} dh={dh} causal "
                        f"{str(dtype)[6:]} [{fk.instantiation(q, kp, vp)}, "
                        f"{fk.BODIES[dtype][0]}]",
            train_ms=timed(lambda: fk.flash_attention_cuda(q, kp, vp, **kw),
                           5),
            train_device_ms=kernel_device_ms(
                lambda: fk.flash_attention_cuda(q, kp, vp, **kw),
                fk.BODIES[dtype][1], 3),
            train_bound_ms=b_ms, train_bound_by=b_by,
            train_library_ms=timed(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 3))
        r = out[name]
        log(f"[train] flash at the training shape {r['train_shape']}: "
            f"max_abs_err {e:.3e}, ms {r['train_ms']:.4f}, device_ms "
            f"{r['train_device_ms']!r}, bound {b_ms:.4f} ms ({b_by}), SDPA "
            f"{r['train_library_ms']:.4f} ms")
        del q, k, v, kp, vp
        free_cuda()
    return out


def train_cli():
    """Phase 16 (d): the training CLI on the card with a failure injected
    before step 3 (exit 17), the rerun resuming from the step-2
    checkpoint (exit 0), and an unbroken run: the resumed run's losses
    equal the unbroken run's at rtol 1e-6.  Returns the printed text."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI]

    def run(*extra):
        return subprocess.run(cmd + list(extra), env=env, cwd=ROOT,
                              capture_output=True, text=True, timeout=600)

    def losses(out):
        return {int(ln.split("step=")[1].split()[0]):
                float(ln.split("loss=")[1].split()[0])
                for ln in out.splitlines() if ln.startswith("[train] step=")}

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        p = run("--ckpt-dir", ck, "--fail-at-step", "3")
        assert p.returncode == 17, (p.returncode, p.stderr[-2000:])
        assert "INJECTED FAILURE at step 3" in p.stdout, p.stdout
        p = run("--ckpt-dir", ck)
        assert p.returncode == 0, (p.returncode, p.stderr[-2000:])
        assert "resumed from step 2" in p.stdout, p.stdout
        whole = run("--ckpt-dir", os.path.join(tmp, "whole"))
        assert whole.returncode == 0, whole.stderr[-2000:]
    resumed, unbroken = losses(p.stdout), losses(whole.stdout)
    assert sorted(resumed) == [2, 3, 4, 5], resumed
    for s_, loss in resumed.items():
        assert abs(loss - unbroken[s_]) <= 1e-6 * abs(unbroken[s_]), \
            (s_, loss, unbroken[s_])
    return (f"exit 17 at step 3, then 0 (resumed from step 2); losses of "
            f"steps 2-5 {[resumed[i] for i in range(2, 6)]} = the unbroken "
            f"run's (rtol 1e-6)")


def phase_train():
    """Phase 16: training on the card.  (a) granite-3-2b at full width and
    depth (random f32 weights drawn on the card from seed 0), one
    ``make_batch`` batch of 4096 tokens: ``loss_fn`` and its gradients with
    ``impl="flash"`` (``remat=True``: exactly 2 L flash launches, the
    forward and the recompute; ``remat=False``: exactly L) against
    ``impl="xla"`` on the same weights (loss, global gradient norm, layers
    0 / 19 / 39's wq / wk / wv / wo gradients).  (b) four steps of
    ``make_train_step(impl="flash")`` (peak lr 1e-5, the reference's
    warmup of 100 steps, the same batch):
    the loss falls at every step, every metric finite, exactly 2 L flash
    launches a step; ms a step, tokens/s, model FLOP/s against the FP32
    peak, a torch.profiler busy / idle split of one step, the path's first
    flash launch against the plain version on its own inputs.  (c) the
    weights cast to bf16 (``cast_params``), two steps: the flash launches
    take the tensor-core bf16 body (the tapped launch's operands and
    instance), finite metrics, the step-1 loss within ``TRAIN_BF16_REL``
    of the f32 loss on the same batch.  (d) the training CLI's failure and
    resume (``train_cli``).  Returns (train_launches by row, the rows'
    training-shape keys, seconds by part, errors by row)."""
    import torch
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import transformer as T
    from repro_torch.testing import assert_bf16_close
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import loss_fn, make_train_step
    import numpy as np
    secs, errs, launches = {}, {}, {"flash_attention": {},
                                    "flash_attention_bf16": {}}
    log(f"[train] memory_allocated at the start "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32")
    nl = cfg.num_layers
    model = T.init_params(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    b, hq, s = TRAIN_BATCH, cfg.num_heads, TRAIN_SEQ
    scores = 4 * b * hq * s * s
    log(f"[train] {cfg.name} f32 at full width and depth ({nl} layers, d "
        f"{cfg.d_model}, {hq} / {cfg.num_kv_heads} heads, head dim "
        f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}): {n_params} "
        f"parameters ({4 * n_params / 1e9:.2f} GB); reckoned peak of a step: "
        f"parameters, gradients, AdamW m and v {16 * n_params / 1e9:.1f} GB "
        f"+ the attention backward's recompute ~3 x {scores / 1e9:.2f} GB")
    batch = make_batch(cfg, ShapeConfig("train_4k", s, b, "train"), 0, 0)
    tokens = b * s
    names = [n for n, _ in model.named_parameters()]
    watch = [f"layers.{i}.attn.{w}" for i in TRAIN_GRAD_LAYERS
             for w in ("wq", "wk", "wv", "wo")]

    # (a) loss and gradients, flash against xla
    def loss_and_grad(impl, remat):
        fk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tot, (loss, _) = loss_fn(model, cfg, batch, impl=impl, remat=remat)
        grads = torch.autograd.grad(tot, list(model.parameters()))
        gn = float(opt.global_norm(grads))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        keep = {k: g for k, g in zip(names, grads) if k in watch}
        count = fk.LAUNCHES["flash_attention"]
        del grads, tot
        free_cuda()
        return float(loss.detach()), gn, keep, count, wall

    t0 = time.perf_counter()
    fl = loss_and_grad("flash", True)
    assert fl[3] == 2 * nl, fl[3]
    xl = loss_and_grad("xla", True)
    assert xl[3] == 0, xl[3]
    fl0 = loss_and_grad("flash", False)
    assert fl0[3] == nl, fl0[3]
    launches["flash_attention"].update({"loss_grad remat": fl[3],
                                        "loss_grad": fl0[3]})
    assert abs(fl[0] - xl[0]) <= TRAIN_LOSS_RTOL * abs(xl[0]), (fl[0], xl[0])
    assert abs(fl[1] - xl[1]) <= TRAIN_GNORM_RTOL * xl[1], (fl[1], xl[1])
    assert abs(fl0[0] - fl[0]) <= 1e-6 * abs(fl[0]), (fl0[0], fl[0])
    assert abs(fl0[1] - fl[1]) <= 1e-5 * fl[1], (fl0[1], fl[1])
    worst = 0.0
    for k in watch:
        ref = xl[2][k]
        rel = float((fl[2][k] - ref).abs().max() / ref.abs().max())
        assert rel <= TRAIN_GRAD_REL, (k, rel)
        worst = max(worst, rel)
    log(f"[train] (a) loss_fn + gradients, batch {b} x seq {s}: flash "
        f"(remat) loss {fl[0]:.6f}, grad norm {fl[1]:.6f}, {fl[3]} flash "
        f"launches, {fl[4]:.3f} s; xla (remat) loss {xl[0]:.6f}, grad norm "
        f"{xl[1]:.6f}, {xl[4]:.3f} s; flash without remat loss {fl0[0]:.6f}"
        f", {fl0[3]} flash launches, {fl0[4]:.3f} s; |loss diff| "
        f"{abs(fl[0] - xl[0]):.3e} (rtol {TRAIN_LOSS_RTOL}), |norm diff| "
        f"{abs(fl[1] - xl[1]):.3e} (rtol {TRAIN_GNORM_RTOL}); layers "
        f"{TRAIN_GRAD_LAYERS} wq/wk/wv/wo grads: max |diff| / max |xla| "
        f"{worst:.3e} (bound {TRAIN_GRAD_REL}); peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del fl, xl, fl0
    free_cuda()
    secs["train (a)"] = time.perf_counter() - t0

    # (b) four train steps
    t0 = time.perf_counter()
    state = opt.init_adamw(model)
    step = make_train_step(cfg, opt.AdamWConfig(lr=TRAIN_LR), impl="flash")
    fk.reset_launches()
    metrics, walls = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if i == 0:
            (model, state, m), taps = tapped(
                lambda: step(model, state, batch),
                (fk, "flash_attention_cuda"))
        else:
            model, state, m = step(model, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        metrics.append({k: float(v) for k, v in m.items()})
    count = fk.LAUNCHES["flash_attention"]
    assert count == TRAIN_STEPS * 2 * nl, count
    launches["flash_attention"][f"train_step x{TRAIN_STEPS}"] = count
    for mt in metrics:
        assert all(map(np.isfinite, mt.values())), metrics
    losses = [mt["loss"] for mt in metrics]
    assert all(b_ < a for a, b_ in zip(losses, losses[1:])), losses
    args, kw, (out, lse) = taps["flash_attention_cuda"]
    want, want_lse = fk.flash_attention_plain(*args, **kw)
    e = max(close(out, want, "train path flash out"),
            close(lse, want_lse, "train path flash lse"))
    errs["flash_attention"] = e
    inst = fk.instantiation(*args[:3])
    del taps, args, kw, out, lse, want, want_lse
    free_cuda()
    step_s = float(np.mean(walls[1:]))
    flops = train_flops(cfg, n_params, b, s)
    log(f"[train] (b) {TRAIN_STEPS} steps of make_train_step(impl=\"flash\")"
        f", lr {TRAIN_LR}, warmup 100, the same batch: losses {losses}, "
        f"grad norms "
        f"{[mt['grad_norm'] for mt in metrics]}; step walls "
        f"{[round(w, 4) for w in walls]} s; {step_s * 1e3:.1f} ms a step "
        f"(steps 2-{TRAIN_STEPS}), {tokens / step_s:.1f} tokens/s; model "
        f"FLOPs a step {flops:.4e} (6 N T + causal attention), "
        f"{flops / step_s / 1e12:.2f} TFLOP/s = {flops / step_s / PEAK_FLOPS:.1%}"
        f" of the FP32 peak; {count} flash launches ({2 * nl} a step) "
        f"[{inst}]; the path's first launch against the plain version: "
        f"max_abs_err {e:.3e}; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log("[train] one train step, where the time goes: " + profile_text(
        *device_profile(lambda: step(model, state, batch), top=6)))
    with torch.no_grad():
        _, (f32_loss, _) = loss_fn(model, cfg, batch, impl="flash")
    f32_loss = float(f32_loss)
    secs["train (b)"] = time.perf_counter() - t0
    del state, step
    free_cuda()

    # (c) bf16
    t0 = time.perf_counter()
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    m16 = T.cast_params(model, torch.bfloat16)
    del model
    free_cuda()
    st16 = opt.init_adamw(m16)
    step16 = make_train_step(cfg16, opt.AdamWConfig(lr=TRAIN_LR),
                             impl="flash")
    fk.reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    (m16, st16, m1), taps = tapped(lambda: step16(m16, st16, batch),
                                   (fk, "flash_attention_cuda"))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    m16, st16, m2 = step16(m16, st16, batch)
    torch.cuda.synchronize()
    walls16 = [t2 - t1, time.perf_counter() - t2]
    count = fk.LAUNCHES["flash_attention"]
    assert count == 2 * 2 * nl, count
    launches["flash_attention_bf16"]["train_step x2"] = count
    args, kw, (out, _) = taps["flash_attention_cuda"]
    assert args[0].dtype == torch.bfloat16 and out.dtype == torch.bfloat16
    inst = f"{fk.instantiation(*args[:3])}, {fk.BODIES[args[0].dtype][0]}"
    assert inst.startswith("bfloat16") and "tensor-core" in inst, inst
    want, _ = fk.flash_attention_plain(*args, **kw)
    e, steps = assert_bf16_close(out, want, ATOL, "train path flash bf16")
    errs["flash_attention_bf16"] = e
    del taps, args, kw, out, want
    mm = [{k: float(v) for k, v in m.items()} for m in (m1, m2)]
    assert all(np.isfinite(v) for mt in mm for v in mt.values()), mm
    rel = abs(mm[0]["loss"] - f32_loss) / abs(f32_loss)
    assert rel <= TRAIN_BF16_REL, (mm[0]["loss"], f32_loss)
    log(f"[train] (c) cast_params to bf16, 2 steps: walls "
        f"{[round(w, 4) for w in walls16]} s (the first with the tapped "
        f"launch's copies; {tokens / walls16[1]:.1f} tokens/s in the "
        f"second), losses {[mt['loss'] for mt in mm]}, grad norms "
        f"{[mt['grad_norm'] for mt in mm]}; step-1 loss against the f32 "
        f"loss on the same batch {f32_loss:.6f}: rel {rel:.3e} (bound "
        f"{TRAIN_BF16_REL}); {count} flash launches [{inst}], the first "
        f"against the plain version: max_abs_err {e:.3e}, max bf16 steps "
        f"{steps}; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del m16, st16, step16, m1, m2
    free_cuda()
    secs["train (c)"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rows = train_flash_rows(errs)
    secs["train flash shape"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("[train] (d) python -m repro_torch.launch.train "
        + " ".join(TRAIN_CLI) + " on the card: " + train_cli())
    secs["train (d)"] = time.perf_counter() - t0
    log(f"[train] phase 16 took {time.perf_counter() - t_phase:.2f} s")
    return launches, rows, secs, errs


# phase 17: the non-dense LM families
# --------------------------------------------------------------------- #
def router_taps():
    """A tap on ``layers._top_k`` recording every MoE router's top-k
    indices (one (b, s, k) tensor a layer, in call order); returns (the
    list, a function restoring the original)."""
    from repro_torch.models import layers as L
    orig = L._top_k
    calls = []

    def tapped(logits, k):
        vals, idx = orig(logits, k)
        calls.append(idx.clone())
        return vals, idx

    L._top_k = tapped
    return calls, lambda: setattr(L, "_top_k", orig)


def router_flips(a, b) -> tuple:
    """(differing, total) (row, position, layer) top-k sets between two
    runs' router taps."""
    import torch
    assert len(a) == len(b), (len(a), len(b))
    diff = total = 0
    for x, y in zip(a, b):
        same = (torch.sort(x, -1).values == torch.sort(y, -1).values).all(-1)
        diff += int((~same).sum())
        total += same.numel()
    return diff, total


def family_prefill(cfg, model, batch):
    """(a): ``make_prefill_step(impl="flash")`` against ``impl="xla"``:
    exactly FAMILY_FLASH flash launches; the MoE router's top-k sets
    compared (at most FAMILY_FLIP_SHARE differ; the logits gate only when
    none do); else last-position logits within LM_LOGIT_REL of max |logit|
    over the real vocab, the same argmax.  Returns (flash launches,
    seconds flash / xla, the log text)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.train.train_step import make_prefill_step
    taps = {}
    out = {}
    walls = {}
    launches = None
    for impl in ("flash", "xla"):
        calls, restore = router_taps()
        fk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out[impl] = make_prefill_step(cfg, impl=impl)(model, batch)[:, -1]
            torch.cuda.synchronize()
        finally:
            restore()
        walls[impl] = time.perf_counter() - t0
        taps[impl] = calls
        if impl == "flash":
            launches = fk.LAUNCHES["flash_attention"]
    want = FAMILY_FLASH[cfg.name]
    assert launches == want, (cfg.name, launches, want)
    text = ""
    if cfg.is_moe:
        diff, total = router_flips(taps["flash"], taps["xla"])
        assert len(taps["flash"]) == cfg.num_layers
        text = (f"router top-k sets differing flash vs xla: {diff} of "
                f"{total} (row, position, layer) decisions (bound "
                f"{FAMILY_FLIP_SHARE:.0%}); ")
        assert diff <= FAMILY_FLIP_SHARE * total, (cfg.name, diff, total)
        if diff:
            return launches, walls, text + (
                "logits gate not applied (a flipped expert moves the "
                "logits)")
    return launches, walls, text + "last-position logits " + \
        logit_check(out["flash"], out["xla"], cfg.vocab_size,
                    f"{cfg.name} prefill flash vs xla")


def family_serve(cfg, model, gen):
    """(b): ``launch.serve.run_lm`` xla then kde (the CLI's KDE defaults)
    at ``FAMILY_SERVE_ARGS``: finite logits; exactly (attention layers or
    applications) x (prompt tokens + gen - 1) kde_decode launches; on the
    final kde cache the kde_attention kernel path against its plain
    pipeline on the first and last attention layer; rwkv6: the replay's
    last prompt step (the scan, a step at a time) against the forward's
    scan over the same prompts within LM_LOGIT_REL, and the chunked
    forward's gap from the scan reported (the reference's chunked form
    clamps its log decays one-sidedly at -30: ROADMAP.md section 3); a
    torch.profiler busy / idle split of 4 decode steps of each attention.
    Returns (kde_decode launches, decode tok/s by attention, the log
    lines)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels.kde_attention import kernel as kk
    from repro_torch.kernels.kde_attention import ops as kops
    from repro_torch.launch import serve
    from repro_torch.train.train_step import make_prefill_step
    lines, res, toks = [], {}, {}
    for att in ("xla", "kde"):
        args = serve.parser().parse_args(
            ["--arch", cfg.name] + FAMILY_SERVE_ARGS + ["--attention", att])
        kk.reset_launches()
        res[att] = serve.run_lm(args, model=model)
        if att == "kde":
            launches = kk.LAUNCHES["kde_decode"]
        r = res[att]
        v = cfg.vocab_size
        for key in ("prompt_logits", "first_decode_logits"):
            assert bool(torch.isfinite(r[key][:, :v]).all()), (cfg.name, att,
                                                                key)
        assert ((r["tokens"] >= 0) & (r["tokens"] < v)).all()
        toks[att] = args.gen * args.batch / r["decode_s"]
        lines.append(f"{att}: prompt {r['prompt_tokens']} tokens replayed "
                     f"in {r['prefill_s']:.3f} s, decode {r['decode_s']:.3f} "
                     f"s ({toks[att]:.1f} tok/s), logits finite")
        if att == "xla":
            if cfg.attention_free:
                sb = make_batch(cfg, ShapeConfig(
                    "serve", args.prompt_len, args.batch, "prefill"), 0,
                    args.seed)
                scan = make_prefill_step(cfg, seq_mixer="scan")(model, sb)
                chunked = make_prefill_step(cfg)(model, sb)
                lines.append(
                    "replay's last prompt step vs the forward's scan: "
                    + logit_check(r["prompt_logits"], scan[:, -1], v,
                                  f"{cfg.name} replay vs scan forward")
                    + "; the chunked forward vs the scan: max |diff| "
                    f"{float((chunked - scan)[..., :v].abs().max()):.3e} "
                    "(reported, not gated: the reference's clamp)")
            del r["cache"]
            free_cuda()
    steps = res["kde"]["prompt_tokens"] + 15
    cache = res["kde"]["cache"]
    apps = 0 if cfg.attention_free else len(cache["k"])
    assert launches == apps * steps, (cfg.name, launches, apps, steps)
    if apps:
        kcfg = dict(top_p=KDE_SERVE_TOP_P, bk=32, stride=4, kv_valid=steps)
        for layer in sorted({0, apps - 1}):
            ck, cv = cache["k"][layer], cache["v"][layer]
            q = torch.randn((ck.shape[0], cfg.num_heads, cfg.hd),
                            generator=gen, device=ck.device)
            e = close(kops.kde_attention(q, ck, cv, **kcfg),
                      kops.kde_attention_ref(q, ck, cv, **kcfg),
                      f"{cfg.name} kde_attention layer {layer}")
            lines.append(f"kde final cache, attention {layer}: kernel path "
                         f"vs plain pipeline max_abs_err {e:.3e}")
    # where a decode step's time goes: 4 steps past the run's last
    # position on its cache, each attention once
    from repro_torch.train.train_step import make_decode_step
    cur = torch.as_tensor(res["kde"]["tokens"][:, -1:],
                          device=model.embed.device)
    kcfg = dict(top_p=KDE_SERVE_TOP_P, bk=32, stride=4)
    for att in ("xla", "kde"):
        step = make_decode_step(cfg, impl=att, kde_cfg=kcfg)

        def steps4():
            for pos in range(steps, steps + 4):
                step(model, cache, cur, pos)

        lines.append(f"4 {att} decode steps (batch 4, cache "
                     f"{res['kde']['max_len']}), where the time goes: "
                     + profile_text(*device_profile(steps4)))
    a = res["xla"]["first_decode_logits"][:, :cfg.vocab_size].double()
    k = res["kde"]["first_decode_logits"][:, :cfg.vocab_size].double()
    corr = float(np.mean([np.corrcoef(x1, x2)[0, 1] for x1, x2 in
                          zip(a.cpu().numpy(), k.cpu().numpy())]))
    lines.append(f"kde: {launches} kde_decode launches = {apps} x {steps} "
                 f"steps; first decode step's logits, Pearson correlation "
                 f"kde vs xla {corr:.6f} (reported, not gated)")
    return launches, toks, lines


def phase_families(gen):
    """Phase 17: each non-dense family at full width (``FAMILY_CUTS``: the
    listed depth cut), f32, random weights drawn on the card from seed 0,
    one config at a time, each freed before the next: (a)
    ``family_prefill`` on one ``make_batch`` batch of 4 x 512 (the
    frontend split of ``token_split``), (b) ``family_serve`` at
    ``FAMILY_SERVE_ARGS``.  Returns
    (flash launches by arch, kde_decode launches by arch, seconds by
    arch)."""
    import torch
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data.pipeline import make_batch, token_split
    from repro_torch.models import transformer as T
    flash, kde, secs = {}, {}, {}
    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), dtype="float32",
                                  **FAMILY_CUTS.get(arch, {}))
        torch.cuda.reset_peak_memory_stats()
        model = T.init_params(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        cut = FAMILY_CUTS.get(arch)
        log(f"[families] {arch} ({cfg.family}) f32 random init on the card"
            f"{f', cut to {cut}' if cut else ''}: {n_params} parameters "
            f"(cfg.param_count() {cfg.param_count()}; the port counts the "
            f"padded vocab rows and the final norms), "
            f"{4 * n_params / 1e9:.2f} GB, memory_allocated "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, "
            f"{time.perf_counter() - t0:.2f} s")
        shape = ShapeConfig("serve", 512, 4, "prefill")
        batch = make_batch(cfg, shape, 0, 0)
        split = token_split(cfg, shape)
        flash[arch], walls, text = family_prefill(cfg, model, batch)
        log(f"[families] {arch} (a) prefill 4 x 512 (frontend "
            f"{split['frontend']}, tokens {split['tokens']}): flash "
            f"{walls['flash']:.3f} s ({flash[arch]} flash launches), xla "
            f"{walls['xla']:.3f} s; {text}")
        kde[arch], toks, lines = family_serve(cfg, model, gen)
        for line in lines:
            log(f"[families] {arch} (b) {line}")
        secs[arch] = time.perf_counter() - t0
        log(f"[families] {arch}: peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
            f"{secs[arch]:.2f} s")
        del model
        free_cuda()
    return flash, kde, secs


# --------------------------------------------------------------------- #
# phase 18: the multi-device engines on torch.distributed
# --------------------------------------------------------------------- #
MESH_P = 4                  # gloo ranks time-sharing the one card
MESH_TIMEOUT = 300          # seconds: every rank's process-group timeout
MESH_WALL = 900             # seconds a spawned group may take in all
MESH_DEG_RTOL = 1e-3        # (b): the ring's degrees against exact ones
MESH_BLOCK = 256            # (b): the functional block sums' block size
MESH_SERVE_N = 8192         # (d): the serving tenant's rows
MESH_SERVE_TICKS = 3
MESH_SERVE_W = 64
MESH_DEVICE = "cuda"
MESH_SOLO = ("nccl", "gloo")   # (e): P = 1 on each backend, compared


def mesh_card() -> None:
    """Every rank's card is device 0; its context exists before the mesh
    (so ``init_device_mesh`` keeps it), and no matmul takes TF32."""
    import torch
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mesh_rank(rank, world, backend, store, out, job):
    """One spawned rank of phase 18: the card is device 0 for every rank,
    the group has a timeout, the rank's result goes to ``out``.  A rank
    that raises exits non-zero and fails the phase."""
    import datetime
    import torch
    import torch.distributed as dist
    mesh_card()
    dist.init_process_group(
        backend, store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=MESH_TIMEOUT))
    res = {"mesh_main": mesh_job_main, "mesh_solo": mesh_job_solo,
           "lm_mesh_main": lmm_job_main, "lm_mesh_solo": lmm_job_solo}[job](
        rank, world)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def mesh_start(job: str, world: int, backend: str, tag: str):
    """Spawn ``world`` ranks of ``job`` on ``backend``; returns a callable
    that waits for them (at most ``MESH_WALL`` s), kills any rank still
    running on failure, and returns the ranks' results."""
    import shutil
    import torch
    import torch.multiprocessing as mp
    out = ROOT / "build" / "mesh" / tag
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    ctx = mp.start_processes(
        mesh_rank, args=(world, backend, str(out / "store"), str(out), job),
        nprocs=world, join=False, start_method="spawn")
    t0 = time.perf_counter()

    def wait():
        try:
            while not ctx.join(timeout=1.0):
                assert time.perf_counter() - t0 < MESH_WALL, \
                    f"mesh group {tag} ran past {MESH_WALL} s"
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(out / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
    return wait


def mesh_sparsify(mesh):
    """The (a) sparsifier on ``mesh``: phase 3's data and configuration.
    Returns its edges, counters, launches, collectives and wall."""
    import torch
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.sparsify import spectral_sparsify
    from repro_torch.data.synthetic_points import gaussian_clusters
    from repro_torch.kernels.kde_sampler import sharded as sh
    x_np, _ = gaussian_clusters(n=SP_N, d=SP_D, seed=0)
    sh.reset_collectives()
    t0 = time.perf_counter()
    g, launches = kernel_launches(lambda: spectral_sparsify(
        x_np, gaussian(SP_BW), num_edges=10 * SP_N, estimator="exact",
        exact_blocks=True, seed=0, batch=BATCH, mesh=mesh))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return dict(src=g.src, dst=g.dst, weight=g.weight,
                evals=g.kernel_evals, queries=g.kde_queries,
                status=g.status, launches=launches,
                cc=dict(sh.COLLECTIVES), coll_secs=sh.COLLECTIVE_SECONDS[0],
                secs=secs, backend=sh.mesh_group(mesh).backend)


def mesh_job_main(rank, world):
    """(a)-(d) on ``world`` gloo ranks; rank 0 also holds every kernel's
    first launch on each path against its plain version."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.kde.distributed import (degree_preprocessing,
                                                  make_sharded_dataset,
                                                  sharded_block_sums)
    from repro_torch.core.kde.hashed import HashedKDE
    from repro_torch.core.kernels_fn import gaussian
    from repro_torch.core.serving import KernelGraphServable
    from repro_torch.data.synthetic_points import gaussian_clusters
    from repro_torch.kernels.kde_rowsum import kernel as rk
    from repro_torch.kernels.kde_sampler import sharded as sh
    errs, res = {}, {}
    mesh = init_device_mesh(MESH_DEVICE, (world,), mesh_dim_names=("data",))

    def checked(what, fn, *names):
        out, taps = tapped(fn, *kernel_taps(*names))
        if rank == 0:
            path_kernel_checks(taps, what, errs, "mesh")
        return out
    # (a) the exact sparsifier
    res["sparsify"] = checked("mesh sparsifier",
                              lambda: mesh_sparsify(mesh),
                              "masked_blocksum", "rowsum")
    # (b) the degree ring and the block sums on a (2, 2) mesh, both axes
    mesh2 = init_device_mesh(MESH_DEVICE, (2, world // 2),
                             mesh_dim_names=("pod", "data"))
    axes = ("pod", "data")
    ker = gaussian(SP_BW)
    x_np, _ = gaussian_clusters(n=SP_N, d=SP_D, seed=0)
    x = torch.as_tensor(x_np, device=MESH_DEVICE)
    xs = make_sharded_dataset(mesh2, x, data_axes=axes)
    deg, l_deg = kernel_launches(lambda: checked(
        "2 x 2 mesh degree ring",
        lambda: degree_preprocessing(mesh2, ker, data_axes=axes)(xs),
        "rowsum"))
    y = x[:BATCH].contiguous()
    nbs = SP_N // world // MESH_BLOCK
    bsum, l_blk = kernel_launches(lambda: checked(
        "2 x 2 mesh block sums",
        lambda: sharded_block_sums(mesh2, ker, nbs, data_axes=axes)(y, xs),
        "blocksum"))
    res["degrees"] = dict(launches=l_deg, block_launches=l_blk)
    if rank == 0:
        want = exact_degrees(x, 1.0 / SP_BW)
        rel = float(((deg.double() - want).abs() / want).max())
        assert rel <= MESH_DEG_RTOL, rel
        errs["blocksum"] = max(errs.get("blocksum", 0.0), close(
            bsum, rk.blocksum_plain(y, x, "gaussian", 1.0 / SP_BW, 1.0,
                                    MESH_BLOCK), "2 x 2 mesh block sums"))
        res["degrees"]["max_rel"] = rel
    # (c) the hashed degrees on phase 6's data
    hs = torch.as_tensor(gaussian_clusters(n=HS_N, d=HS_D, seed=0)[0],
                         device=MESH_DEVICE)
    est = HashedKDE(hs, gaussian(HS_BW), max_bucket=HS_MAX_BUCKET,
                    num_far_samples=HS_NUM_FAR, seed=HS_LAYOUT_SEED,
                    mesh=mesh)
    sh.reset_collectives()
    deg_h, l_hash = kernel_launches(lambda: checked(
        "mesh hashed degrees", est.degrees, "weighted_kv_sum"))
    res["hash"] = dict(launches=l_hash, cc=dict(sh.COLLECTIVES),
                       deg_sum=float(deg_h.sum()))
    if rank == 0:
        res["hash"]["exact_sum"] = float(hs_exact_degrees(
            {"hs_x": hs, "hs_bs": max(int(np.sqrt(HS_N)), 16)}).sum())
    # (d) a mesh serving tenant: sample and prob_of groups
    srv = KernelGraphServable(device=MESH_DEVICE)
    srv.add_tenant("m", x_np[:MESH_SERVE_N], ker, exact_blocks=True,
                   mesh=mesh, seed=0)
    rng = np.random.default_rng(0)
    ticks = []
    for t in range(MESH_SERVE_TICKS):
        reqs = []
        for i in range(2):
            src = rng.integers(0, MESH_SERVE_N, MESH_SERVE_W)
            reqs.append(srv.submit("m", "sample", src=src, seed=10 * t + i))
            reqs.append(srv.submit(
                "m", "prob_of", src=src,
                dst=rng.integers(0, MESH_SERVE_N, MESH_SERVE_W),
                seed=10 * t + i + 5))
        sh.reset_collectives()
        stats, launches = kernel_launches(srv.tick)
        assert stats["failed"] == 0, stats
        for r in reqs:
            vals = r.result[1] if r.op == "sample" else r.result
            assert np.isfinite(vals).all() and (vals >= 0).all(), r.op
        ticks.append(dict(launches=launches, cc=dict(sh.COLLECTIVES),
                          ms=stats["tick_ms"]))
    res["serve"] = ticks
    res["errs"] = errs
    return res


def mesh_job_solo(rank, world):
    """(e): the (a) sparsifier at P = 1 on this group's backend."""
    from torch.distributed.device_mesh import init_device_mesh
    return mesh_sparsify(init_device_mesh(MESH_DEVICE, (1,),
                                          mesh_dim_names=("data",)))


def phase_mesh(sp_counts):
    """Phase 18: the multi-device engines (``kde_sampler.sharded``,
    ``kde_hash.sharded``, ``core.kde.distributed``) through the public
    entry points, ``MESH_P`` gloo ranks time-sharing the one card (NCCL
    refuses two ranks on one device), then P = 1 on NCCL against P = 1 on
    gloo.  Returns (launches by path, secs, max abs errors)."""
    import types
    import numpy as np
    import torch
    from repro_torch.data.synthetic_points import gaussian_clusters
    secs = {}
    t0 = time.perf_counter()
    res = mesh_start("mesh_main", MESH_P, "gloo", "main")()
    secs["mesh (a)-(d)"] = time.perf_counter() - t0
    r0 = res[0]
    a = r0["sparsify"]
    batches = -(-10 * SP_N // BATCH)
    assert (a["evals"], a["queries"]) == sp_counts, (a["evals"], sp_counts)
    for r in res:
        s = r["sparsify"]
        for k in ("src", "dst", "weight"):
            np.testing.assert_array_equal(s[k], a[k])
        assert s["launches"] == {"masked_blocksum": batches,
                                 "rowsum": MESH_P}, s["launches"]
        assert (s["cc"]["psum"], s["cc"]["ppermute"],
                s["cc"]["all_gather"]) == (batches, MESH_P - 1, 1), s["cc"]
        assert s["backend"] == "gloo"
    dev = torch.device(MESH_DEVICE)
    data = {"sp_x": torch.as_tensor(
                gaussian_clusters(n=SP_N, d=SP_D, seed=0)[0], device=dev),
            "sp_bs": max(int(np.sqrt(SP_N)), 16)}
    deg = exact_degrees(data["sp_x"], 1.0 / SP_BW)
    g = types.SimpleNamespace(src=a["src"], dst=a["dst"])
    log(f"[mesh] (a) the exact sparsifier on a ({MESH_P},) mesh, rank 0's "
        f"edges: {edge_law(data, g, deg)} (alpha 1e-3)")
    del data, deg
    share = a["coll_secs"] / a["secs"]
    log(f"[mesh] (a) spectral_sparsify(mesh=) n={SP_N} t={10 * SP_N} on "
        f"{MESH_P} gloo ranks: {a['secs']:.2f} s, "
        f"{10 * SP_N / a['secs']:.0f} edges/s, {share:.1%} of the wall in "
        f"the collectives ({a['cc']}, gloo staged through the host); "
        f"kernel_evals {a['evals']} and kde_queries {a['queries']} equal "
        f"phase 3's; per rank {a['launches']}, every rank's edge list the "
        f"same.  {MESH_P} ranks time-share one card: correctness numbers, "
        f"not a speed-up")
    for r in res:
        d = r["degrees"]
        assert d["launches"] == {"rowsum": MESH_P}, d["launches"]
        assert d["block_launches"] == {"blocksum": 1}, d["block_launches"]
        h = r["hash"]
        assert h["launches"] == {"weighted_kv_sum": HS_N // BATCH}, \
            h["launches"]
        assert h["cc"]["psum"] == HS_N // BATCH, h["cc"]
        assert h["deg_sum"] == r0["hash"]["deg_sum"]
        for t in r["serve"]:
            assert t["launches"] == {"masked_blocksum": 2}, t["launches"]
            assert t["cc"]["psum"] == 2, t["cc"]
    rel = abs(r0["hash"]["deg_sum"] - r0["hash"]["exact_sum"]) \
        / r0["hash"]["exact_sum"]
    assert rel <= HS_DEG_RTOL, rel
    log(f"[mesh] (b) degree_preprocessing on a (2, 2) ('pod', 'data') mesh: "
        f"max rel err {r0['degrees']['max_rel']:.3e} (bound "
        f"{MESH_DEG_RTOL}), {MESH_P} rowsum launches a rank; "
        f"sharded_block_sums one blocksum launch a rank")
    log(f"[mesh] (c) HashedKDE(mesh=) degrees at n={HS_N}: sum "
        f"{r0['hash']['deg_sum']:.6e} vs exact {r0['hash']['exact_sum']:.6e}"
        f", rel err {rel:.3e} (bound {HS_DEG_RTOL}); one weighted_kv_sum "
        f"launch and one all-reduce a query batch")
    log(f"[mesh] (d) mesh serving tenant: {MESH_SERVE_TICKS} ticks of 2 "
        f"sample + 2 prob_of requests (w {MESH_SERVE_W}): one all-reduce "
        f"and one masked_blocksum launch a group; tick ms "
        + ", ".join(f"{t['ms']:.2f}" for t in r0["serve"]))
    t0 = time.perf_counter()
    waits = [mesh_start("mesh_solo", 1, b, f"solo_{i}_{b}")
             for i, b in enumerate(MESH_SOLO)]
    nccl, gloo = (w()[0] for w in waits)
    secs["mesh (e)"] = time.perf_counter() - t0
    assert (nccl["backend"], gloo["backend"]) == MESH_SOLO
    for k in ("src", "dst", "weight"):
        np.testing.assert_array_equal(nccl[k], gloo[k])
    assert nccl["launches"] == gloo["launches"] == {
        "masked_blocksum": batches, "rowsum": 1}, nccl["launches"]
    log(f"[mesh] (e) P = 1: the NCCL run's edge list bitwise the gloo run's "
        f"({nccl['secs']:.2f} s vs {gloo['secs']:.2f} s)")
    launches = {"sparsify (a)": a["launches"],
                "degrees (b)": r0["degrees"]["launches"],
                "block sums (b)": r0["degrees"]["block_launches"],
                "hashed degrees (c)": r0["hash"]["launches"],
                "serve tick (d)": r0["serve"][0]["launches"]}
    return launches, secs, r0["errs"]


# --------------------------------------------------------------------- #
# phase 19: the LM's sharded state (lm-mesh)
# --------------------------------------------------------------------- #
LMM_LAYERS = 2              # every lm-mesh model: full width, 2 layers, f32
LMM_SHAPE = (2, 2)          # ("data", "model") over MESH_P gloo ranks
LMM_BATCH, LMM_SEQ = 4, 512  # (a): the train batch
LMM_LR, LMM_STEPS = 1e-5, 2  # (a): AdamW at lr 1e-5 (no warmup), 2 steps
LMM_RTOL = 1e-4             # (a): loss, grad norm vs the unsharded step
LMM_GRAD_REL = 1e-3         # (a): a gradient leaf within 1e-3 max |g|
LMM_PROMPT, LMM_GEN = 56, 8  # (b): the last 64 slots: a prefill, then decode
LMM_LOGIT_REL = 1e-3        # (b): logits within 1e-3 max |logit|
LMM_MOE = "granite_moe_1b_a400m"
LMM_MOE_SEQ = 256           # (c): batch 4 x 256
LMM_MOE_ATOL, LMM_AUX_ATOL, LMM_MOE_GRAD_ATOL = 1e-4, 1e-4, 2e-3
LMM_SOLO = "nccl"           # (e): P = 1 on NCCL against the unsharded step
#: flash at a rank's shapes: (a) yi-6b's 32 / 4 heads over 2 "model"
#: ranks, 2 rows a "data" rank; (c) granite-moe's 16 / 8 heads likewise
LMM_FLASH = ((LMM_BATCH // 2, 16, 2, LMM_SEQ, 128),
             (LMM_BATCH // 2, 8, 4, LMM_MOE_SEQ, 64))
#: (f): qwen2.5-14b's context-parallel prefill (40 / 8 heads, the config
#: seq mode is for) on a (1, 4) mesh, batch 1 x LMM_CP_SEQ (s_l 512 a
#: rank; cut from 4096 when the whole script passed 900 s of its 1200)
LMM_CP_ARCH = "qwen2_5_14b"
LMM_CP_SHAPE = (1, 4)
LMM_CP_SEQ = 2048


def lmm_config(arch: str):
    import dataclasses
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(arch), num_layers=LMM_LAYERS,
                               dtype="float32")


def lmm_models(cfg, mesh, rank0: bool):
    """Seed-0 weights drawn on the card, sharded onto ``mesh``; rank 0
    also keeps an unsharded copy (the yardstick)."""
    from repro_torch.distributed import state as D
    from repro_torch.models import transformer as T
    model = T.init_params(cfg, seed=0, device=MESH_DEVICE)
    ref = T.map_params(model, lambda n, p: p.detach().clone()) \
        if rank0 else None
    return D.shard_model(model, mesh), ref


def lmm_whole(model, named=None):
    """Name -> whole tensor (on the card) of a sharded model's parameters
    or of a dict of its gradients (counted all-gathers)."""
    from repro_torch.distributed import state as D
    named = dict(model.named_parameters()) if named is None else named
    specs = {n: D.spec_of(p) for n, p in model.named_parameters()}
    return D.full_named(named, specs, model._mesh)


def lmm_train(mesh, rank0: bool, tag: str):
    """(a) / (e): reduced-depth yi-6b's sharded train step on ``mesh``
    (flash, remat) held by rank 0 to the unsharded port step on the same
    card, weights and batches: the first step's gradients leaf by leaf,
    then LMM_STEPS steps' loss, grad norm and parameters."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import state as D
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import layers as L
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step, step_grads
    cfg = lmm_config(LM_ARCH)
    shape = ShapeConfig("lm-mesh", LMM_SEQ, LMM_BATCH, "train")
    batches = [make_batch(cfg, shape, i, 0) for i in range(LMM_STEPS)]
    adamw = opt.AdamWConfig(lr=LMM_LR, warmup_steps=1)
    model, ref = lmm_models(cfg, mesh, rank0)
    n_whole = sum(int(torch.Size(D.full_shape(p)).numel())
                  for p in model.parameters())
    ost = opt.init_adamw(model)
    res = dict(params=sum(p.numel() for p in model.parameters()),
               params_whole=n_whole, bytes=D.state_bytes(model, ost),
               bytes_whole=3 * 4 * n_whole)
    step = make_train_step(cfg, adamw, impl="flash", remat=True)
    with L.activation_sharding(mesh, SH.batch_axes(mesh)):
        g, _, _ = step_grads(model, cfg, batches[0], impl="flash",
                             remat=True)
        g = lmm_whole(model, g)
        fk.reset_launches()
        C.reset_collectives()
        walls, mets = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, ost, m = step(model, ost, b)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            mets.append({k: float(v) for k, v in m.items()})
        res.update(walls=walls, metrics=mets, coll_secs=C.COLLECTIVE_SECONDS[0],
                   cc=dict(C.COLLECTIVES), cbytes=dict(C.COLLECTIVE_BYTES),
                   flash=fk.LAUNCHES["flash_attention"])
        after = lmm_whole(model)
    if not rank0:
        return res
    del model, ost
    free_cuda()
    g_ref, _, _ = step_grads(ref, cfg, batches[0], impl="flash", remat=True)
    res["grad_rel"] = max(float((g[n] - g_ref[n]).abs().max()
                                / g_ref[n].abs().max().clamp_min(1e-30))
                          for n in g_ref)
    res["grads_bitwise"] = all(torch.equal(g[n], g_ref[n]) for n in g_ref)
    del g, g_ref
    o_ref = opt.init_adamw(ref)
    step = make_train_step(cfg, adamw, impl="flash", remat=True)
    ref_mets, ref_walls = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref, o_ref, m = step(ref, o_ref, b)
        torch.cuda.synchronize()
        ref_walls.append(time.perf_counter() - t0)
        ref_mets.append({k: float(v) for k, v in m.items()})
    named = {n: p.detach() for n, p in ref.named_parameters()}
    res.update(ref_metrics=ref_mets, ref_walls=ref_walls,
               param_diff=max(float((after[n] - named[n]).abs().max())
                              for n in named),
               params_bitwise=all(torch.equal(after[n], named[n])
                                  for n in named))
    return res


def lmm_fill(cache_k, cache_v, cfg, specs, mesh):
    """Seeded synthetic N(0, 1) K/V in positions [0, S - 64) of every
    layer (the lm-bf16 phase's fill), each rank writing its slice of the
    whole layer tensor (``specs`` None: the whole cache)."""
    import torch
    from repro_torch.distributed import sharding as SH
    g = torch.Generator(device=MESH_DEVICE).manual_seed(500)
    fill = LONG_S - LMM_PROMPT - LMM_GEN
    for name, cache in (("k", cache_k), ("v", cache_v)):
        for i in range(cfg.num_layers):
            whole = torch.zeros((1, cfg.num_kv_heads, LONG_S, cfg.hd),
                                dtype=torch.bfloat16, device=MESH_DEVICE)
            whole[:, :, :fill].normal_(generator=g)
            if specs is not None:
                whole = SH.shard(whole, specs[name][1:], mesh)
            cache[i].copy_(whole)
            del whole


def lmm_decode(mesh, rank0: bool):
    """(b) the long_500k cell on ``mesh``: heads over "model", the
    524,288-slot bf16 cache's sequence over "data"; a LMM_PROMPT-token
    prefill into the cache (one ``decode_step`` call: xla attention over
    the sequence slices, combined by their logsumexps), then LMM_GEN
    decode steps through the shard_map KDE decode in every layer; rank 0
    then runs the same tokens through the single-device steps (the fused
    kde_decode kernel) on a whole copy of the cache."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels.kde_attention import kernel as kk
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.train.train_step import make_decode_step
    cfg = lmm_config(LM_ARCH)
    model, ref = lmm_models(cfg, mesh, rank0)
    prompt = make_batch(cfg, ShapeConfig("long_500k", LMM_PROMPT, 1,
                                         "prefill"), 0, 0)["tokens"]
    step = make_decode_step(cfg, impl="kde", kde_cfg=LONG_KDE)
    fill = LONG_S - LMM_PROMPT - LMM_GEN
    res = {}
    with L.activation_sharding(mesh, ("data",)):
        cache = T.init_cache(cfg, 1, LONG_S)
        res["specs"] = dict(cache.specs)
        res["cache_bytes"] = sum(t.numel() * t.element_size()
                                 for t in cache.values())
        lmm_fill(cache["k"], cache["v"], cfg, cache.specs, mesh)
        kk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, lg, cache = step(model, cache, torch.as_tensor(prompt), fill)
        torch.cuda.synchronize()
        res["prefill_s"] = time.perf_counter() - t0
        toks = [int(t) for t in prompt[0]] + [int(nxt[0])]
        logits, walls, cc = [lg[0, -1, :cfg.vocab_size].float().cpu()], [], \
            None
        for i in range(LMM_GEN):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cnt = {}
            cc = C.collective_counts(lambda: cnt.setdefault("o", step(
                model, cache, torch.tensor([[toks[LMM_PROMPT + i]]]),
                fill + LMM_PROMPT + i)))
            nxt, lg, cache = cnt["o"]
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            logits.append(lg[0, -1, :cfg.vocab_size].float().cpu())
            toks.append(int(nxt[0]))
        res.update(walls=walls, cc=cc, sharded_launches=kk.LAUNCHES[
            "kde_decode"], tokens=toks)
    del cache
    free_cuda()
    if not rank0:
        return res
    del model
    cache = T.init_cache(cfg, 1, LONG_S, device=MESH_DEVICE)
    lmm_fill(cache["k"], cache["v"], cfg, None, None)
    kk.reset_launches()
    _, lg, cache = step(ref, cache, torch.as_tensor(prompt), fill)
    ref_logits, ref_walls = [lg[0, -1, :cfg.vocab_size].float().cpu()], []
    for i in range(LMM_GEN):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, lg, cache = step(ref, cache,
                            torch.tensor([[toks[LMM_PROMPT + i]]]),
                            fill + LMM_PROMPT + i)
        torch.cuda.synchronize()
        ref_walls.append(time.perf_counter() - t0)
        ref_logits.append(lg[0, -1, :cfg.vocab_size].float().cpu())
    res.update(ref_walls=ref_walls, launches=kk.LAUNCHES["kde_decode"],
               logit_rel=max(float((a - b).abs().max() / b.abs().max())
                             for a, b in zip(logits, ref_logits)),
               finite=all(bool(torch.isfinite(a).all()) for a in logits))
    del cache, ref
    free_cuda()
    return res


def lmm_moe(mesh, rank0: bool):
    """(c) granite-moe-1b-a400m (2 layers) on ``mesh``: the forward's
    logits and aux, then one train step's gradients and metrics, against
    the unsharded port on rank 0."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step, step_grads
    cfg = lmm_config(LMM_MOE)
    model, ref = lmm_models(cfg, mesh, rank0)
    batch = make_batch(cfg, ShapeConfig("lm-mesh-moe", LMM_MOE_SEQ,
                                        LMM_BATCH, "train"), 0, 0)
    adamw = opt.AdamWConfig(lr=LMM_LR, warmup_steps=1)
    res = {"embed_spec": tuple(model.embed._repro_spec)}
    dg = C.mesh_group(mesh, ("data",))
    with L.activation_sharding(mesh, ("data",)):
        with torch.inference_mode():
            lg, aux = T.forward(model, cfg, batch, impl="flash")
            lg = C.all_gather(lg, dg, 0)
        fk.reset_launches()
        g, _, _ = step_grads(model, cfg, batch, impl="flash", remat=True)
        g = lmm_whole(model, g)
        ost = opt.init_adamw(model)
        _, _, m = make_train_step(cfg, adamw, impl="flash", remat=True)(
            model, ost, batch)
        res.update(flash=fk.LAUNCHES["flash_attention"], aux=float(aux),
                   metrics={k: float(v) for k, v in m.items()})
    if not rank0:
        return res
    del model, ost
    free_cuda()
    with torch.inference_mode():
        lg_ref, aux_ref = T.forward(ref, cfg, batch, impl="flash")
    g_ref, _, _ = step_grads(ref, cfg, batch, impl="flash", remat=True)
    _, _, m_ref = make_train_step(cfg, adamw, impl="flash", remat=True)(
        ref, opt.init_adamw(ref), batch)
    v = cfg.vocab_size
    res.update(logit_err=float((lg[..., :v] - lg_ref[..., :v]).abs().max()),
               logit_max=float(lg_ref[..., :v].abs().max()),
               aux_err=abs(float(aux) - float(aux_ref)),
               grad_err=max(float((g[n] - g_ref[n]).abs().max())
                            for n in g_ref),
               ref_metrics={k: float(v) for k, v in m_ref.items()})
    del ref, g, g_ref, lg, lg_ref
    free_cuda()
    return res


def lmm_cp_models(cfg, mesh, rank: int, world: int):
    """``lmm_models`` one rank at a time (a rank holds the whole f32
    model only while it cuts its shards), the others waiting at a
    barrier."""
    import torch.distributed as dist
    for r in range(world):
        if r == rank:
            model, ref = lmm_models(cfg, mesh, rank == 0)
            free_cuda()
        dist.barrier()
    return model, ref


def logits_match(got, want, vocab: int, what: str, chunk: int = 512):
    """max |got - want| <= LM_LOGIT_REL max |want| over every position of
    (b, s, V) logits (compared a chunk of positions at a time), and the
    same argmax at every position whose top-two gap in ``want`` exceeds
    twice that max |diff| (a nearer tie may swap); returns the log
    text."""
    import torch
    diff, top, ties, pos = 0.0, 0.0, 0, 0
    tops, args = [], []
    for i in range(0, got.shape[1], chunk):
        g = got[:, i:i + chunk, :vocab].double()
        w = want[:, i:i + chunk, :vocab].double()
        assert bool(torch.isfinite(g).all()), f"{what}: non-finite logits"
        diff = max(diff, float((g - w).abs().max()))
        top = max(top, float(w.abs().max()))
        tops.append(torch.topk(w, 2, dim=-1).values)
        args.append((g.argmax(-1), w.argmax(-1)))
    assert diff <= LM_LOGIT_REL * top, (what, diff, top)
    for t2, (ga, wa) in zip(tops, args):
        clear = (t2[..., 0] - t2[..., 1]) > 2 * diff
        assert bool((ga == wa)[clear].all()), f"{what}: argmax differs"
        ties += int((~clear).sum())
        pos += int(clear.numel())
    return (f"max |diff| {diff:.3e} <= {LM_LOGIT_REL} x max |logit| "
            f"{top:.4f}; argmax equal at all {pos - ties} of {pos} positions "
            f"whose top-two gap exceeds 2 max |diff| ({ties} nearer ties)")


def lmm_cp_prefill(rank: int, world: int):
    """(f) qwen2.5-14b's flash prefill (LMM_LAYERS layers, full width, f32)
    on a LMM_CP_SHAPE ("data", "model") mesh, batch 1 x LMM_CP_SEQ: the
    context-parallel layout (``seq_mode=True``: rank r's LMM_CP_SEQ / 4
    queries at offset r LMM_CP_SEQ / 4) and the tensor-parallel one
    (``seq_mode=False``), each first as the whole forward (its logits
    kept, its first flash launch tapped; the warm-up), then the prefill
    step timed (counts set to 0 just before); rank 0 holds both to the
    unsharded prefill.  Each rank's flash device ms at its shapes are
    taken one rank at a time."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import state as D
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.train.train_step import make_prefill_step
    cfg = lmm_config(LMM_CP_ARCH)
    mesh = make_debug_mesh(*LMM_CP_SHAPE, device_type=MESH_DEVICE)
    model, ref = lmm_cp_models(cfg, mesh, rank, world)
    batch = make_batch(cfg, ShapeConfig("lm-mesh-cp", LMM_CP_SEQ, 1,
                                        "prefill"), 0, 0)
    step = make_prefill_step(cfg, impl="flash")
    v = cfg.vocab_size
    res = dict(bytes=D.state_bytes(model), bytes_whole=4 * sum(
        int(torch.Size(D.full_shape(p)).numel())
        for p in model.parameters()))
    keep = {}
    for tag, seq_mode in (("cp", True), ("tp", False)):
        with L.activation_sharding(mesh, ("data",), seq_mode=seq_mode):
            with torch.inference_mode():
                (lg, _), seen = tapped(
                    lambda: T.forward(model, cfg, batch, impl="flash"),
                    (fk, "flash_attention_cuda"))
            if rank == 0:
                keep[tag] = lg
            del lg
            (q, kp, vp), kw, (out, lse) = seen["flash_attention_cuda"]
            p_out, p_lse = fk.flash_attention_plain(q, kp, vp, **kw)
            err = max(close(out, p_out, f"lm-mesh (f) {tag} flash"),
                      close(lse, p_lse, f"lm-mesh (f) {tag} flash lse"))
            shapes = dict(q=list(q.shape), k=list(kp.shape),
                          offset=kw["offset"], kv_valid=kw["kv_valid"])
            del seen, q, kp, vp, out, lse, p_out, p_lse
            free_cuda()
            fk.reset_launches()
            C.reset_collectives()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            dist.barrier()
            t0 = time.perf_counter()
            last = step(model, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            r = dict(wall=wall, coll_secs=C.COLLECTIVE_SECONDS[0],
                     cc=dict(C.COLLECTIVES), cbytes=dict(C.COLLECTIVE_BYTES),
                     flash=fk.LAUNCHES["flash_attention"],
                     peak=torch.cuda.max_memory_allocated() - held,
                     held=held, layout=L._ACT["seq_layout"], tap_err=err,
                     tap=shapes, last=last[0, -1, :v].float().cpu())
            del last
            free_cuda()
        res[tag] = r
    # each rank's flash at its shapes, timed one rank at a time
    hd, hq, hkv = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    m, s_l = LMM_CP_SHAPE[1], LMM_CP_SEQ // LMM_CP_SHAPE[1]
    g = torch.Generator(device=MESH_DEVICE).manual_seed(7)
    for r in range(world):
        if r == rank:
            k = torch.randn((1, hkv, LMM_CP_SEQ, hd), generator=g,
                            device=MESH_DEVICE)
            q = torch.randn((1, hq, s_l, hd), generator=g,
                            device=MESH_DEVICE)
            kp, vp, kw = fops.flash_args(q, k, k)
            kw["offset"] = rank * s_l
            res["cp"]["flash_ms"] = kernel_device_ms(
                lambda: fk.flash_attention_cuda(q, kp, vp, **kw),
                fk.BODIES[torch.float32][1], 3)
            res["cp"]["flash_bound"] = flash_cp_bound(
                1, hq, hkv, s_l, hd, rank * s_l, torch.float32)
            q = torch.randn((1, hq // m, LMM_CP_SEQ, hd), generator=g,
                            device=MESH_DEVICE)
            kt = k[:, :hkv // m].contiguous()
            kp, vp, kw = fops.flash_args(q, kt, kt)
            res["tp"]["flash_ms"] = kernel_device_ms(
                lambda: fk.flash_attention_cuda(q, kp, vp, **kw),
                fk.BODIES[torch.float32][1], 3)
            res["tp"]["flash_bound"] = flash_cp_bound(
                1, hq // m, hkv // m, LMM_CP_SEQ, hd, 0, torch.float32)
            del q, k, kt, kp, vp
            free_cuda()
        dist.barrier()
    if rank != 0:
        return res
    del model
    free_cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    last = step(ref, batch)
    torch.cuda.synchronize()
    res["ref_wall"] = time.perf_counter() - t0
    res["ref_peak"] = torch.cuda.max_memory_allocated() - held
    want_last = last[0, -1, :v].float().cpu()
    for tag in ("cp", "tp"):
        res[tag]["last_text"] = logit_check(
            res[tag]["last"][None], want_last[None], v,
            f"lm-mesh (f) {tag} last position")
    del last
    with torch.inference_mode():
        want, _ = T.forward(ref, cfg, batch, impl="flash")
    del ref
    free_cuda()
    for tag in ("cp", "tp"):
        res[tag]["whole_text"] = logits_match(
            keep.pop(tag), want, v, f"lm-mesh (f) {tag} whole forward")
        free_cuda()
    del want
    free_cuda()
    for tag in ("cp", "tp"):
        del res[tag]["last"]
    return res


def lmm_cp_train(mesh, rank0: bool):
    """(g) (a)'s yi-6b train step on (a)'s mesh, batch and weights with the
    sequence split over "model" (``seq_mode=True``: 256 positions a
    rank): the step's gradients leaf by leaf against the unsharded ones
    (rank 0), then one timed step's metrics, wall and collectives."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import layers as L
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step, step_grads
    cfg = lmm_config(LM_ARCH)
    batch = make_batch(cfg, ShapeConfig("lm-mesh", LMM_SEQ, LMM_BATCH,
                                        "train"), 0, 0)
    adamw = opt.AdamWConfig(lr=LMM_LR, warmup_steps=1)
    model, ref = lmm_models(cfg, mesh, rank0)
    step = make_train_step(cfg, adamw, impl="flash", remat=True)
    with L.activation_sharding(mesh, SH.batch_axes(mesh), seq_mode=True):
        g, _, _ = step_grads(model, cfg, batch, impl="flash", remat=True)
        layout = L._ACT["seq_layout"]
        g = lmm_whole(model, g)
        ost = opt.init_adamw(model)
        fk.reset_launches()
        C.reset_collectives()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, ost, m = step(model, ost, batch)
        torch.cuda.synchronize()
        res = dict(wall=time.perf_counter() - t0, layout=layout,
                   metrics={k: float(v) for k, v in m.items()},
                   coll_secs=C.COLLECTIVE_SECONDS[0], cc=dict(C.COLLECTIVES),
                   cbytes=dict(C.COLLECTIVE_BYTES),
                   flash=fk.LAUNCHES["flash_attention"])
    del model, ost
    free_cuda()
    if not rank0:
        return res
    g_ref, _, _ = step_grads(ref, cfg, batch, impl="flash", remat=True)
    res["grad_rel"] = max(float((g[n] - g_ref[n]).abs().max()
                                / g_ref[n].abs().max().clamp_min(1e-30))
                          for n in g_ref)
    del g, g_ref, ref
    free_cuda()
    return res


def lmm_compressed(rank: int, world: int):
    """(d) ``compressed_psum`` over the "pod" axis of a (2, 2) ("pod",
    "data") mesh: the rank's leaves and residuals (seeded by rank) and
    what came back."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models import layers as L
    from repro_torch.train import optimizer as opt
    mesh = init_device_mesh(MESH_DEVICE, (2, world // 2),
                            mesh_dim_names=("pod", "data"))
    g = torch.Generator(device=MESH_DEVICE).manual_seed(100 + rank)
    shapes = {"w": (1024, 1024), "b": (4096,), "odd": (33, 7)}
    grads = {k: torch.randn(s, generator=g, device=MESH_DEVICE)
             for k, s in shapes.items()}
    resid = {k: torch.randn(s, generator=g, device=MESH_DEVICE) * 1e-3
             for k, s in shapes.items()}
    with L.activation_sharding(mesh, ("pod", "data")):
        summed, new_r = opt.compressed_psum(grads, resid, "pod")
    cpu = (lambda d: {k: v.cpu() for k, v in d.items()})
    return dict(g=cpu(grads), r=cpu(resid), summed=cpu(summed),
                resid=cpu(new_r))


def lmm_cp_report(res) -> str:
    """(f)'s checks over every rank's results, and its printed lines;
    returns a one-line summary."""
    f0 = res[0]["f"]
    s_l = LMM_CP_SEQ // LMM_CP_SHAPE[1]
    for rank, r in enumerate(res):
        f = r["f"]
        assert f["cp"]["layout"] == "split" and f["tp"]["layout"] is None
        for tag in ("cp", "tp"):
            assert f[tag]["flash"] == LMM_LAYERS, (rank, tag, f[tag]["flash"])
        assert f["cp"]["tap"]["offset"] == rank * s_l, f["cp"]["tap"]
        assert f["cp"]["tap"]["q"][2] == s_l, f["cp"]["tap"]
    for tag, name in (("cp", "context-parallel (seq_mode=True)"),
                      ("tp", "tensor-parallel (seq_mode=False)")):
        t = f0[tag]
        log(f"[lm-mesh] (f) {LMM_CP_ARCH} ({LMM_LAYERS} of 48 layers, full "
            f"width, f32) flash prefill, batch 1 x {LMM_CP_SEQ}, "
            f"{name} on a {LMM_CP_SHAPE} ('data', 'model') mesh: last "
            f"position {t['last_text']}; whole forward {t['whole_text']}")
        log(f"[lm-mesh] (f) {tag}: wall " + ", ".join(
            f"rank {i} {r['f'][tag]['wall']:.3f} s" for i, r in enumerate(res))
            + f" (unsharded on the same card {f0['ref_wall']:.3f} s); "
            f"{t['coll_secs'] / t['wall']:.1%} of rank 0's wall inside the "
            f"collective wrapper; rank 0's collectives {t['cc']}, operand "
            f"bytes {({k: v for k, v in t['cbytes'].items() if v})}; peak "
            f"memory of the step above what the rank held before it "
            + ", ".join(
                f"rank {i} {r['f'][tag]['peak'] / 1e9:.2f} GB (held "
                f"{r['f'][tag]['held'] / 1e9:.2f})"
                for i, r in enumerate(res))
            + f" (the unsharded step {f0['ref_peak'] / 1e9:.2f} GB on rank "
            f"0); flash device ms "
            + ", ".join(
                f"rank {i} {r['f'][tag]['flash_ms']} (bound "
                f"{r['f'][tag]['flash_bound'][0]:.4f} by "
                f"{r['f'][tag]['flash_bound'][1]}; tapped launch at offset "
                f"{r['f'][tag]['tap']['offset']}, q {r['f'][tag]['tap']['q']}"
                f" vs k {r['f'][tag]['tap']['k']}: max_abs_err "
                f"{r['f'][tag]['tap_err']:.3e})" for i, r in enumerate(res)))
    log(f"[lm-mesh] (f) state a rank: " + ", ".join(
        f"rank {i} {r['f']['bytes'] / 1e9:.3f} GB" for i, r in enumerate(res))
        + f" of {f0['bytes_whole'] / 1e9:.3f} GB of f32 parameters unsharded")
    return (f"CP prefill wall {f0['cp']['wall']:.3f} s vs TP "
            f"{f0['tp']['wall']:.3f} s (rank 0; {MESH_P} ranks time-share "
            f"one card)")


def lmm_job_main(rank, world):
    """(a)-(d), (f) and (g) on ``world`` gloo ranks sharing the card."""
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(*LMM_SHAPE, device_type=MESH_DEVICE)
    res = {}
    t0 = time.perf_counter()
    res["a"] = lmm_train(mesh, rank == 0, "a")
    t1 = time.perf_counter()
    res["b"] = lmm_decode(mesh, rank == 0)
    t2 = time.perf_counter()
    res["c"] = lmm_moe(mesh, rank == 0)
    t3 = time.perf_counter()
    res["d"] = lmm_compressed(rank, world)
    t4 = time.perf_counter()
    res["f"] = lmm_cp_prefill(rank, world)
    t5 = time.perf_counter()
    res["g"] = lmm_cp_train(mesh, rank == 0)
    res["secs"] = dict(a=t1 - t0, b=t2 - t1, c=t3 - t2, d=t4 - t3,
                       f=t5 - t4, g=time.perf_counter() - t5)
    return res


def lmm_job_solo(rank, world):
    """(e): (a) at P = 1 on this group's backend."""
    from repro_torch.launch.mesh import make_debug_mesh
    return lmm_train(make_debug_mesh(1, 1, device_type=MESH_DEVICE), True,
                     "e")


def phase_lm_mesh():
    """Phase 19 (lm-mesh): the LM's sharded state through the public
    entry points on MESH_P gloo ranks time-sharing the card (NCCL refuses
    two ranks on one device), each model at full width with its depth cut
    to LMM_LAYERS, f32, seed-0 weights drawn on the card; then (e) on one
    NCCL rank.  Returns (launches by path, secs, max abs errors)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.train import optimizer as opt
    secs = {}
    errs = {"flash_attention": 0.0}
    gen = torch.Generator(device=MESH_DEVICE).manual_seed(19)
    for shape in LMM_FLASH:
        b, hq, hkv, s, dh = shape
        q = torch.randn((b, hq, s, dh), generator=gen, device=MESH_DEVICE)
        k, v = (torch.randn((b, hkv, s, dh), generator=gen,
                            device=MESH_DEVICE) for _ in range(2))
        kp, vp, kw = fops.flash_args(q, k, v)
        out, lse = fk.flash_attention_cuda(q, kp, vp, **kw)
        p_out, p_lse = fk.flash_attention_plain(q, kp, vp, **kw)
        e = max(close(out, p_out, f"lm-mesh flash {shape}"),
                close(lse, p_lse, f"lm-mesh flash lse {shape}"))
        errs["flash_attention"] = max(errs["flash_attention"], e)
        log(f"[lm-mesh] flash at a rank's shape (b, hq, hkv, s, dh) = "
            f"{shape} f32 [{fk.instantiation(q, kp, vp)}]: kernel vs plain "
            f"max_abs_err {e:.3e}")
    del q, k, v, kp, vp, out, lse, p_out, p_lse
    free_cuda()
    t0 = time.perf_counter()
    res = mesh_start("lm_mesh_main", MESH_P, "gloo", "lm_main")()
    secs["lm-mesh (a)-(d)"] = time.perf_counter() - t0
    r0 = res[0]
    a = r0["a"]
    L2 = 2 * LMM_LAYERS
    for r in res:
        ra = r["a"]
        assert ra["metrics"] == a["metrics"], (ra["metrics"], a["metrics"])
        assert ra["flash"] == L2 * LMM_STEPS, ra["flash"]
    for m, w in zip(a["metrics"], a["ref_metrics"]):
        for k in ("loss", "grad_norm"):
            assert abs(m[k] - w[k]) <= LMM_RTOL * abs(w[k]), (k, m, w)
    assert a["grad_rel"] <= LMM_GRAD_REL, a["grad_rel"]
    assert a["param_diff"] <= 2 * LMM_LR * LMM_STEPS, a["param_diff"]
    wall = sum(a["walls"]) / len(a["walls"])
    log(f"[lm-mesh] (a) yi-6b ({LMM_LAYERS} layers, full width, f32) "
        f"sharded train step on a {LMM_SHAPE} ('data', 'model') mesh of "
        f"{MESH_P} gloo ranks, batch {LMM_BATCH} x {LMM_SEQ}, remat, flash, "
        f"AdamW lr {LMM_LR}: per step loss "
        + ", ".join(f"{m['loss']:.6f} (unsharded {w['loss']:.6f})"
                    for m, w in zip(a["metrics"], a["ref_metrics"]))
        + "; grad norm "
        + ", ".join(f"{m['grad_norm']:.6f} (unsharded {w['grad_norm']:.6f})"
                    for m, w in zip(a["metrics"], a["ref_metrics"]))
        + f" (rtol {LMM_RTOL}); step-1 gradients max |diff| / max |g| "
        f"{a['grad_rel']:.3e} over every leaf (bound {LMM_GRAD_REL}); "
        f"parameters after {LMM_STEPS} steps max |diff| "
        f"{a['param_diff']:.3e} (bound {2 * LMM_LR * LMM_STEPS:.0e})")
    log(f"[lm-mesh] (a) state a rank: "
        + ", ".join(f"rank {i} {r['a']['params']:,} of "
                    f"{r['a']['params_whole']:,} parameters "
                    f"({r['a']['params'] / r['a']['params_whole']:.2f}), "
                    f"{r['a']['bytes'] / 1e9:.3f} GB parameters + AdamW of "
                    f"{r['a']['bytes_whole'] / 1e9:.3f} GB unsharded"
                    for i, r in enumerate(res))
        + f"; flash {a['flash'] // LMM_STEPS} launches a rank a step "
        f"(2 L with remat, each on its {32 // LMM_SHAPE[1]} heads and "
        f"{LMM_BATCH // LMM_SHAPE[0]} rows)")
    log(f"[lm-mesh] (a) step wall {', '.join(f'{w:.3f}' for w in a['walls'])}"
        f" s (unsharded on the same card "
        f"{', '.join(f'{w:.3f}' for w in a['ref_walls'])} s); "
        f"{a['coll_secs'] / sum(a['walls']):.1%} of the sharded wall inside "
        f"the collective wrapper (gloo staged through the host); rank 0's "
        f"collectives over {LMM_STEPS} steps {a['cc']}, operand bytes "
        f"{ {k: v for k, v in a['cbytes'].items() if v} }; {MESH_P} ranks "
        f"time-share one card: correctness numbers, not a speed-up")
    b = r0["b"]
    L1 = LMM_LAYERS
    assert b["specs"]["k"] == (None, None, "model", ("data",), None), \
        b["specs"]
    for r in res:
        assert r["b"]["sharded_launches"] == 0, r["b"]["sharded_launches"]
        assert r["b"]["tokens"] == b["tokens"]
        cc = r["b"]["cc"]
        assert (cc["all_gather"], cc["pmax"], cc["psum"]) == \
            (8 * L1 + 1, L1, 5 * L1 + 1), cc
    assert b["finite"] and b["logit_rel"] <= LMM_LOGIT_REL, b["logit_rel"]
    assert b["launches"] == LMM_LAYERS * LMM_GEN, b["launches"]
    log(f"[lm-mesh] (b) long_500k KDE decode (yi-6b, {LMM_LAYERS} layers, "
        f"batch 1, a {LONG_S}-slot bf16 cache, top_p {LONG_KDE['top_p']}, "
        f"bk {LONG_KDE['bk']}, stride {LONG_KDE['stride']}) on the same "
        f"mesh: cache spec {b['specs']['k']} ({b['cache_bytes'] / 1e9:.3f} "
        f"GB a rank), synthetic K/V below the last {LMM_PROMPT + LMM_GEN} "
        f"slots, a {LMM_PROMPT}-token prefill into the cache "
        f"({b['prefill_s']:.2f} s) then {LMM_GEN} decode steps: "
        f"logits max |diff| / max |logit| {b['logit_rel']:.3e} against the "
        f"single-device prefill and decode through the fused kernel (bound "
        f"{LMM_LOGIT_REL}); a step {b['cc']['all_gather']} all-gathers "
        f"({L1} lse tables, {L1} x 7 weights' 'data' shards, the logits), "
        f"{b['cc']['pmax']} max and "
        f"{b['cc']['psum']} sum all-reduces ({L1} x (1 max + 3 sums) of the "
        f"KDE combine, {L1} x 2 row-parallel outputs, 1 embedding); step "
        f"{sum(b['walls']) / len(b['walls']) * 1e3:.2f} ms sharded vs "
        f"{sum(b['ref_walls']) / len(b['ref_walls']) * 1e3:.2f} ms single "
        f"device ({b['launches']} kde_decode launches on the yardstick, 0 "
        f"on the shard_map path)")
    c = r0["c"]
    for r in res:
        assert r["c"]["metrics"] == c["metrics"]
    assert c["logit_err"] <= LMM_MOE_ATOL, c["logit_err"]
    assert c["aux_err"] <= LMM_AUX_ATOL, c["aux_err"]
    assert c["grad_err"] <= LMM_MOE_GRAD_ATOL, c["grad_err"]
    for k in ("loss", "grad_norm"):
        assert abs(c["metrics"][k] - c["ref_metrics"][k]) \
            <= LMM_RTOL * abs(c["ref_metrics"][k]), (c["metrics"],
                                                     c["ref_metrics"])
    log(f"[lm-mesh] (c) granite-moe-1b-a400m ({LMM_LAYERS} layers, 32 "
        f"experts, top 8; embed spec {c['embed_spec']}: the padded vocab "
        f"divides 'model') by expert parallelism on the mesh, batch "
        f"{LMM_BATCH} x {LMM_MOE_SEQ}: logits max |diff| {c['logit_err']:.3e}"
        f" (of max {c['logit_max']:.3f}; atol {LMM_MOE_ATOL}), aux "
        f"{c['aux']:.6f} |diff| {c['aux_err']:.3e} (atol {LMM_AUX_ATOL}), "
        f"gradients max |diff| {c['grad_err']:.3e} (atol "
        f"{LMM_MOE_GRAD_ATOL}); train step loss {c['metrics']['loss']:.6f} "
        f"(unsharded {c['ref_metrics']['loss']:.6f}), grad norm "
        f"{c['metrics']['grad_norm']:.6f} (unsharded "
        f"{c['ref_metrics']['grad_norm']:.6f})")
    n_ok = 0
    for rank, r in enumerate(res):
        peer = res[rank ^ 2]["d"]          # the other "pod", same "data"
        d = r["d"]
        for k in d["g"]:
            q0, s0, nr = opt.compress(d["g"][k], d["r"][k])
            q1, s1, _ = opt.compress(peer["g"][k], peer["r"][k])
            want = opt.decompress(q0.to(torch.int32) + q1.to(torch.int32),
                                  torch.maximum(s0, s1))
            assert torch.equal(d["summed"][k], want), (rank, k)
            assert torch.equal(d["resid"][k], nr), (rank, k)
            n_ok += 1
    log(f"[lm-mesh] (d) compressed_psum over the 'pod' axis of a (2, 2) "
        f"('pod', 'data') mesh: {n_ok} leaves on {MESH_P} ranks bitwise "
        f"the plain sum of the int8 codes at the larger scale, residuals "
        f"bitwise")
    f_txt = lmm_cp_report(res)
    g = r0["g"]
    for r in res:
        assert r["g"]["metrics"] == g["metrics"], (r["g"]["metrics"],
                                                   g["metrics"])
        assert r["g"]["layout"] == "split" and r["g"]["flash"] == L2, r["g"]
    for k in ("loss", "grad_norm"):
        assert abs(g["metrics"][k] - a["ref_metrics"][0][k]) \
            <= LMM_RTOL * abs(a["ref_metrics"][0][k]), (k, g["metrics"],
                                                       a["ref_metrics"][0])
    assert g["grad_rel"] <= LMM_GRAD_REL, g["grad_rel"]
    log(f"[lm-mesh] (g) (a)'s yi-6b train step with the sequence split over "
        f"'model' (seq_mode=True, {LMM_SEQ // LMM_SHAPE[1]} positions a rank,"
        f" layout {g['layout']}) on (a)'s mesh, batch and weights: loss "
        f"{g['metrics']['loss']:.6f} (unsharded {a['ref_metrics'][0]['loss']:.6f}),"
        f" grad norm {g['metrics']['grad_norm']:.6f} (unsharded "
        f"{a['ref_metrics'][0]['grad_norm']:.6f}; rtol {LMM_RTOL}); gradients "
        f"max |diff| / max |g| {g['grad_rel']:.3e} over every leaf (bound "
        f"{LMM_GRAD_REL}); step wall {g['wall']:.3f} s (TP (a) step 1 "
        f"{a['walls'][0]:.3f} s), {g['coll_secs'] / g['wall']:.1%} inside the "
        f"collective wrapper; rank 0's collectives {g['cc']}, operand bytes "
        f"{ {k: v for k, v in g['cbytes'].items() if v} }; flash "
        f"{g['flash']} launches a rank a step (2 L with remat)")
    t0 = time.perf_counter()
    e = mesh_start("lm_mesh_solo", 1, LMM_SOLO, "lm_solo")()[0]
    secs["lm-mesh (e)"] = time.perf_counter() - t0
    same = [k for k in ("grads", "params") if e[f"{k}_bitwise"]]
    differ = [k for k in ("grads", "params") if not e[f"{k}_bitwise"]]
    m_same = e["metrics"] == e["ref_metrics"]
    assert e["grad_rel"] <= LMM_GRAD_REL and \
        e["param_diff"] <= 2 * LMM_LR * LMM_STEPS, e
    log(f"[lm-mesh] (e) P = 1 on {LMM_SOLO} ((1, 1) mesh) vs the unsharded "
        f"step: metrics {'bitwise equal' if m_same else 'differ'} "
        f"({e['metrics']} vs {e['ref_metrics']}); bitwise equal: "
        f"{same or 'nothing'}; differ: {differ or 'nothing'} (step-1 "
        f"gradients max rel {e['grad_rel']:.3e}, parameters max |diff| "
        f"{e['param_diff']:.3e}); step wall "
        f"{', '.join(f'{w:.3f}' for w in e['walls'])} s vs "
        f"{', '.join(f'{w:.3f}' for w in e['ref_walls'])} s")
    log(f"[lm-mesh] phase secs by part (rank 0): {r0['secs']}")
    launches = {"flash_attention": {
                    "(a) train a rank": a["flash"],
                    "(c) moe grads + step a rank": c["flash"],
                    "(e) P = 1": e["flash"]},
                "kde_decode_bf16": {"(b) single-device yardstick":
                                    b["launches"],
                                    "(b) shard_map path": 0}}
    launches["flash_attention"].update({
        "(f) CP prefill a rank": r0["f"]["cp"]["flash"],
        "(f) TP prefill a rank": r0["f"]["tp"]["flash"],
        "(g) CP train step a rank": g["flash"]})
    errs["flash_attention"] = max(errs["flash_attention"],
                                  max(r["f"][t]["tap_err"] for r in res
                                      for t in ("cp", "tp")))
    log(f"[lm-mesh] (f) {f_txt}")
    return launches, secs, errs


# --------------------------------------------------------------------- #
# phase 20: the paper's Section 7 experiments (Figures 4 and 3)
# --------------------------------------------------------------------- #
#: Figure 4 (``bench_sparsify.py`` ``_figure4``, at the generators' default
#: sizes): (dataset, n, gaussian bandwidth or None for 0.25 x the median
#: bandwidth, fraction of the n (n - 1) / 2 edges)
PAPER_FIG4 = (("nested", 5000, 0.3, 0.025), ("rings", 2500, None, 0.033))
#: Figure 3 (``bench_lra.py`` ``run``): the datasets at n 2500, the ranks
PAPER_FIG3 = ("mnist_like", "glove_like")
PAPER_LRA_N = 2500
PAPER_RANKS = (5, 10, 20, 40)
PAPER_ACC_SLACK = 0.03      # accuracy at most this far below the reference's
#: the reference's values for the same calls, from its CPU run
#: (``tools/paper_reference.py``, JAX 0.9.0): num_edges, kernel_evals and
#: kde_queries are functions of the static shapes; accuracy is
#: ``cluster_accuracy(spectral_cluster(g, 2, seed=0).labels, labels, 2)``
PAPER_REF = {
    "nested": dict(num_edges=312437, kernel_evals=1613967424,
                   kde_queries=318344, accuracy=1.0),
    "rings": dict(num_edges=103083, kernel_evals=270084624,
                  kde_queries=105924, accuracy=1.0)}
#: ``fkv_lowrank(estimator="rs", num_rows=25 r)``'s kernel_evals at n 2500
#: (both datasets; the reference's run gives these)
PAPER_REF_LRA = {5: 512500, 10: 825000, 20: 1450000, 40: 2700000}
#: the paper's own figures (abstract and Section 7): size reduction of the
#: sparsifier, cluster accuracy, the sparse / dense eigenvector speed-up,
#: the LRA's kernel-evaluation reduction
PAPER_SAYS = dict(size=41.0, acc={"nested": 0.995, "rings": 1.0}, eig=4.5,
                  evals=9.0)
PAPER_KERNELS = ("rowsum", "blocksum", "masked_blocksum", "sample_block")
PAPER_DEVICE = "cuda"


def dense_eig_secs(k, kk: int, iters: int, guard: int = 4) -> float:
    """Seconds of ``laplacian_eigenvectors``' subspace iteration run on the
    dense normalized adjacency D^-1/2 (K - I) D^-1/2 on the card in f64
    (``bench_sparsify._dense_eig_time`` on the host): the dense yardstick
    of Figure 4's eigenvector speed-up."""
    import torch
    n = k.shape[0]
    d = torch.clamp(k.sum(1) - 1.0, min=1e-12)
    dm = torch.rsqrt(d)
    nadj = dm[:, None] * (k - torch.eye(n, dtype=k.dtype, device=k.device)) \
        * dm[None, :]
    gen = torch.Generator(device=k.device).manual_seed(0)
    q = torch.linalg.qr(torch.randn(n, kk + guard, generator=gen,
                                    device=k.device, dtype=k.dtype)).Q
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        q = torch.linalg.qr(nadj @ q + q).Q
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def paper_figure4(name, n, bw, frac, launches, errs) -> float:
    """Figure 4 on the card: the exact sparsifier (exact level-1 blocks),
    spectral clustering and the eigenvector speed-up; returns seconds."""
    import numpy as np
    import torch
    from repro_torch.core.cluster.spectral import (cluster_accuracy,
                                                   laplacian_eigenvectors,
                                                   spectral_cluster)
    from repro_torch.core.kernels_fn import gaussian, median_bandwidth
    from repro_torch.core.sparsify import spectral_sparsify
    from repro_torch.data import synthetic_points as data
    from repro_torch.ft import guards
    t_phase = time.perf_counter()
    x_np, lab = getattr(data, name)(n=n, seed=0)
    x = torch.as_tensor(x_np, device=PAPER_DEVICE)
    if bw is None:
        bw = 0.25 * median_bandwidth(x)
    ker = gaussian(bw)
    total = n * (n - 1) / 2
    budget = int(frac * total)
    wall = {}

    def run():
        t0 = time.perf_counter()
        g = spectral_sparsify(x_np, ker, num_edges=budget, estimator="exact",
                              exact_blocks=True, seed=0, device=PAPER_DEVICE)
        torch.cuda.synchronize()
        wall["sparsify"] = time.perf_counter() - t0
        return g

    (g, taps), counts = kernel_launches(
        lambda: tapped(run, *kernel_taps(*PAPER_KERNELS)))
    path = f"fig4 {name}"
    launches[path] = counts
    for k in ("blocksum", "sample_block"):
        assert counts.get(k, 0) > 0, f"{path}: {k} was not launched"
    ref = PAPER_REF[name]
    got = dict(num_edges=g.num_edges, kernel_evals=int(g.kernel_evals),
               kde_queries=int(g.kde_queries))
    for k, v in got.items():
        assert v == ref[k], (path, k, v, ref[k])
    assert budget == ref["num_edges"], (budget, ref["num_edges"])
    assert not (g.status & guards.FATAL), guards.decode_status(g.status)
    assert np.all(np.isfinite(g.weight)) and np.all(g.weight > 0)
    path_kernel_checks(taps, f"{name} sparsifier", errs, phase="paper")
    acc = cluster_accuracy(spectral_cluster(g, 2, seed=0).labels, lab, 2)
    assert acc >= ref["accuracy"] - PAPER_ACC_SLACK, (path, acc, ref)
    t0 = time.perf_counter()
    laplacian_eigenvectors(g, 2, iters=100, seed=0)
    t_sparse = time.perf_counter() - t0
    k = ker.matrix(x).double()
    t_dense = dense_eig_secs(k, 2, 100)
    del k
    log(f"[paper] Figure 4 {name}: n={n} d={x_np.shape[1]} gaussian "
        f"bandwidth {bw:.6f}, {frac:.1%} of {int(total)} edges = {budget}; "
        f"num_edges {got['num_edges']}, kernel_evals {got['kernel_evals']}, "
        f"kde_queries {got['kde_queries']} (the reference's, exactly); "
        f"spectral_sparsify {wall['sparsify']:.3f} s "
        f"({budget / wall['sparsify']:.0f} edges/s); launches {counts}")
    log(f"[paper] Figure 4 {name}: size reduction {total / budget:.1f}x "
        f"(paper ~{PAPER_SAYS['size']:.0f}x); cluster accuracy {acc:.4f} "
        f"(reference CPU {ref['accuracy']:.4f}, bound -{PAPER_ACC_SLACK}; "
        f"paper {PAPER_SAYS['acc'][name]:.1%}); laplacian_eigenvectors "
        f"(100 iters, host) {t_sparse:.4f} s vs the dense subspace "
        f"iteration on the card (f64) {t_dense:.4f} s: speed-up "
        f"{t_dense / t_sparse:.2f}x (paper {PAPER_SAYS['eig']}x, dense on "
        f"its host)")
    return time.perf_counter() - t_phase


def paper_figure3(name, launches, errs) -> float:
    """Figure 3 on the card: ``fkv_lowrank(estimator="rs")`` at each rank
    against the countsketch sketch and a 10-step subspace iteration on the
    dense K (computed on the card in f64); returns seconds."""
    import numpy as np
    import torch
    from repro_torch.core.kernels_fn import laplacian, median_bandwidth
    from repro_torch.core.lowrank import (countsketch_lowrank, fkv_lowrank,
                                          projection_error,
                                          subspace_iteration)
    from repro_torch.data import synthetic_points as data
    from repro_torch.kernels.kde_sampler.ref import l1_dists
    t_phase = time.perf_counter()
    n = PAPER_LRA_N
    x_np = getattr(data, name)(n=n)
    x = torch.as_tensor(x_np, device=PAPER_DEVICE)
    bw = median_bandwidth(x, ord=1)
    ker = laplacian(bw)
    k = torch.exp(-l1_dists(x, x) / bw).double().cpu().numpy()
    fro2 = float(np.linalg.norm(k, "fro") ** 2)
    path = f"fig3 {name}"
    launches[path] = {}
    taps_all = {}
    for r in PAPER_RANKS:
        t0 = time.perf_counter()
        (res, taps), counts = kernel_launches(lambda: tapped(
            lambda: fkv_lowrank(x_np, ker, rank=r, num_rows=25 * r,
                                estimator="rs", seed=0,
                                device=PAPER_DEVICE),
            *kernel_taps(*PAPER_KERNELS)))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for key, v in counts.items():
            launches[path][key] = launches[path].get(key, 0) + v
        for key, v in taps.items():
            taps_all.setdefault(key, v)
        assert counts.get("rowsum", 0) == -(-n // BATCH), (path, r, counts)
        assert int(res.kernel_evals) == PAPER_REF_LRA[r], \
            (path, r, res.kernel_evals, PAPER_REF_LRA[r])
        assert res.u.shape == (r, n) and np.all(np.isfinite(res.u))
        err = projection_error(k, res.u) / fro2
        err_is = projection_error(
            k, countsketch_lowrank(k, r, max(4 * r, 32), seed=0)) / fro2
        err_svd = projection_error(
            k, subspace_iteration(k, r, iters=10, seed=0)[1]) / fro2
        assert err <= LRA_FACTOR * err_svd, (path, r, err, err_svd)
        log(f"[paper] Figure 3 {name} n={n} d={x_np.shape[1]} laplacian "
            f"bandwidth {bw:.4f} rank {r}: relative Frobenius error "
            f"KDE {err:.6e} / countsketch {err_is:.6e} / subspace "
            f"iteration {err_svd:.6e} (ratio {err / err_svd:.4f}, bound "
            f"{LRA_FACTOR}x); kernel_evals {res.kernel_evals} (the "
            f"reference's), reduction n^2 / kernel_evals "
            f"{n * n / res.kernel_evals:.2f}x (paper ~"
            f"{PAPER_SAYS['evals']:.0f}x); fkv_lowrank {secs:.3f} s; "
            f"launches {counts}")
    path_kernel_checks(taps_all, f"{name} LRA", errs, phase="paper")
    return time.perf_counter() - t_phase


def phase_paper():
    """Phase 20: Figures 4 and 3 through the public entry points; every
    kernel launch counted by path (``paper_launches``) and each kernel's
    first call on a path held to its plain version.  Returns (launches by
    path, errs by kernel, seconds by part)."""
    launches, errs, secs = {}, {}, {}
    for name, n, bw, frac in PAPER_FIG4:
        secs[f"paper fig4 {name}"] = paper_figure4(name, n, bw, frac,
                                                   launches, errs)
    for name in PAPER_FIG3:
        secs[f"paper fig3 {name}"] = paper_figure3(name, launches, errs)
    return launches, errs, secs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    os.environ["REPRO_CHECKS"] = "1"      # fatal status flags raise
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np
    from repro_torch.core.kernels_fn import median_bandwidth
    from repro_torch.data.synthetic_points import (gaussian_clusters,
                                                   mnist_like)
    from repro_torch.kernels.kde_hash import kernel as hk
    from repro_torch.kernels.kde_rowsum import kernel as rk
    from repro_torch.kernels.kde_sampler import kernel as sk
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    phases = {}
    t_start = t0 = time.perf_counter()
    sass = phase_build()
    phases["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_tuning()
    phases["tuning"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sp_x_np, _ = gaussian_clusters(n=SP_N, d=SP_D, seed=0)
    lra_x_np = mnist_like(n=LRA_N, d=LRA_D, seed=0)
    lra_x = torch.as_tensor(lra_x_np, device=dev)
    lra_bw = median_bandwidth(lra_x, ord=1)
    rng = np.random.default_rng(0)
    hs_x_np, _ = gaussian_clusters(n=HS_N, d=HS_D, seed=0)
    hs_x = torch.as_tensor(hs_x_np, device=dev)
    hs_state, hs_cw = hash_layout(hs_x)
    data = dict(
        hs_x_np=hs_x_np, hs_x=hs_x, hs_state=hs_state, hs_cw=hs_cw,
        hs_bs=max(int(np.sqrt(HS_N)), 16),
        sp_x_np=sp_x_np, sp_x=torch.as_tensor(sp_x_np, device=dev),
        sp_bs=max(int(np.sqrt(SP_N)), 16),
        ns_src=torch.as_tensor(rng.choice(SP_N, NS_FRONTIER, replace=False),
                               device=dev),
        lra_x_np=lra_x_np, lra_x=lra_x, lra_bw=lra_bw,
        lra_xs=(lra_x * 2.0).contiguous())   # laplacian squaring constant
    log(f"[setup] data made; laplacian median bandwidth {lra_bw:.4f}")
    rows = phase_kernels(data, gen) + phase_hash_kernels(data, gen) + \
        phase_lm_kernels(gen)
    phases["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sass_check(sass)
    phases["sass"] = time.perf_counter() - t0

    rk.reset_launches()
    sk.reset_launches()
    g, phases["sparsify"] = phase_sparsify(data)
    phases["sampler"], (ex_src, ex_dst) = phase_sampler(data)
    res, phases["lra"] = phase_lra(data)
    launches = f32_counts(rk.LAUNCHES, sk.LAUNCHES)
    log(f"[main path] launches {launches}")
    for name, count in launches.items():
        assert count > 0, f"kernel {name} was not launched on the main path"

    rk.reset_launches()
    sk.reset_launches()
    hk.reset_launches()
    g_hash, phases["hash"] = phase_hash(data)
    hash_launches = f32_counts(hk.LAUNCHES)
    log(f"[hash path] launches {hash_launches}")
    want = {"weighted_kv_sum": HS_N // BATCH,
            "weighted_kv": -(-10 * HS_N // BATCH)}
    assert hash_launches == want, (hash_launches, want)
    launches.update(hash_launches)

    # the stratified read and its degrees are plain torch ops, as in the
    # reference: the run launches no kernel
    rk.reset_launches()
    sk.reset_launches()
    hk.reset_launches()
    g_strat, phases["stratified"] = phase_stratified(data)
    strat_launches = {**rk.LAUNCHES, **sk.LAUNCHES, **hk.LAUNCHES}
    log(f"[stratified path] launches {strat_launches}")
    assert not any(strat_launches.values()), strat_launches
    lra_est = phase_lra_estimators(data)
    phases["lra rs + stratified"] = sum(v[1] for v in lra_est.values())

    t0 = time.perf_counter()
    deg = exact_degrees(data["sp_x"], 1.0 / SP_BW)
    log(f"[sparsify] edge law of the {g.num_edges} drawn edges: "
        f"{edge_law(data, g, deg)} (alpha 1e-3)")
    half = float(deg.sum()) / 2.0
    wsum = float(g.weight.sum())
    rel = abs(wsum - half) / half
    log(f"[sparsify] sums consistent: sum(w) = {wsum:.6e}, total kernel "
        f"mass / 2 = {half:.6e}, rel err {rel:.2e} (bound {MASS_RTOL})")
    assert rel <= MASS_RTOL, rel
    log("[sampler] sample_exact destinations against k(u, .) / deg(u): "
        + "; ".join(neighbor_law(data["sp_x"], torch.as_tensor(
            ex_src, device=dev), torch.as_tensor(ex_dst, device=dev),
            1.0 / SP_BW)) + " (alpha 1e-3)")
    runs = [("exact", res, phases["lra"])] + [
        (k, *v) for k, v in lra_est.items()]
    e_fkvs, e_svd = lra_errors(data, [r for _, r, _ in runs])
    for (est, _, secs), e_fkv in zip(runs, e_fkvs):
        log(f"[lra] n={LRA_N} d={LRA_D} rank {LRA_RANK} estimator={est}: "
            f"relative Frobenius error FKV {e_fkv:.6e}, subspace iteration "
            f"{e_svd:.6e} (ratio {e_fkv / e_svd:.4f}, bound {LRA_FACTOR}x); "
            f"fkv_lowrank {secs:.2f} s")
        assert e_fkv <= LRA_FACTOR * e_svd, (est, e_fkv, e_svd)
    phases["checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hash_checks(data, g_hash)
    phases["hash checks"] = time.perf_counter() - t0
    log("[hash] one edge batch, ms by stage (CUDA events): " + ", ".join(
        f"{k} {v:.4f}" for k, v in hash_breakdown(data).items()))
    t0 = time.perf_counter()
    strat_checks(data, g_strat)
    phases["stratified checks"] = time.perf_counter() - t0
    log("[stratified] one edge batch, ms by stage (CUDA events): "
        + ", ".join(f"{k} {v:.4f}"
                    for k, v in strat_breakdown(data).items()))
    sp_counts = (g.kernel_evals, g.kde_queries)
    del g, g_hash, g_strat, res, lra_est, runs, deg
    free_cuda()

    bf16_rows, bf16_launches, bf16_secs = phase_bf16(data, gen)
    rows += bf16_rows
    launches.update(bf16_launches)
    phases.update(bf16_secs)
    graph_launches, graph_secs, graph_errs = phase_graph(data, gen)
    phases.update(graph_secs)
    est_data = {k: data[k] for k in ("sp_x_np", "hs_x_np")}
    del data
    free_cuda()

    # the LM phases run in IEEE f32: no TF32 in any matmul
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    t0 = time.perf_counter()
    model, launches["flash_attention"], _, batch = phase_lm_prefill()
    phases["lm-prefill"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["kde_decode"] = phase_lm_serve(model, gen)
    phases["lm-serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    m16, cfg16, launches["flash_attention_bf16"] = lm_bf16_prefill(model,
                                                                   batch)
    del model, batch
    free_cuda()
    launches["kde_decode_bf16"], e = lm_bf16_long_decode(m16, cfg16, gen)
    phases["lm-bf16"] = time.perf_counter() - t0
    for r in rows:
        if r["name"] == "kde_decode_bf16":
            r["max_abs_err"] = max(r["max_abs_err"], e)
    del m16
    free_cuda()

    stream_launches, st_secs, st_errs = phase_streaming(dev)
    phases.update(st_secs)
    est_launches, est_secs, est_errs = phase_estimators(est_data, dev)
    phases.update(est_secs)
    stream_launches.update(est_launches)
    free_cuda()
    ran = {k for c in stream_launches.values() for k in c}
    for name in ("rowsum", "blocksum", "masked_blocksum", "sample_block",
                 "weighted_kv_sum", "weighted_kv", "weighted_kv_sum_bf16",
                 "weighted_kv_bf16"):
        assert name in ran, f"kernel {name} was not launched on the " \
            f"streaming / estimator paths"
    serve_launches, sv_secs, sv_errs = phase_serve(dev)
    phases.update(sv_secs)
    ran = {k for c in serve_launches.values() for k in c}
    for name in ("sample_block", "masked_blocksum", "blocksum",
                 "weighted_kv_sum", "weighted_kv"):
        assert name in ran, f"kernel {name} was not launched on the " \
            f"serve paths"
    free_cuda()
    train_launches, train_rows, tr_secs, tr_errs = phase_train()
    phases.update(tr_secs)
    free_cuda()
    fam_flash, fam_kde, fam_secs = phase_families(gen)
    phases.update({f"families {k}": v for k, v in fam_secs.items()})
    family_launches = {"flash_attention": fam_flash, "kde_decode": fam_kde}
    free_cuda()
    mesh_launches, mesh_secs, mesh_errs = phase_mesh(sp_counts)
    phases.update(mesh_secs)
    free_cuda()
    lmm_launches, lmm_secs, lmm_errs = phase_lm_mesh()
    phases.update(lmm_secs)
    free_cuda()
    paper_launches, paper_errs, paper_secs = phase_paper()
    phases.update(paper_secs)

    for r in rows:
        r["launches"] = launches[r["name"]]
        r["max_abs_err"] = max(r["max_abs_err"],
                               graph_errs.get(r["name"], 0.0),
                               st_errs.get(r["name"], 0.0),
                               est_errs.get(r["name"], 0.0),
                               sv_errs.get(r["name"], 0.0),
                               tr_errs.get(r["name"], 0.0),
                               mesh_errs.get(r["name"], 0.0),
                               lmm_errs.get(r["name"], 0.0),
                               paper_errs.get(r["name"], 0.0))
        if r["name"] in lmm_launches:
            r["lm_mesh_launches"] = lmm_launches[r["name"]]
        r["mesh_launches"] = {path: c[r["name"]] for path, c in
                              mesh_launches.items() if r["name"] in c}
        r["graph_launches"] = {path: c[r["name"]] for path, c in
                               graph_launches.items() if r["name"] in c}
        r["paper_launches"] = {path: c[r["name"]] for path, c in
                               paper_launches.items() if r["name"] in c}
        r["stream_launches"] = {path: c[r["name"]] for path, c in
                                stream_launches.items() if r["name"] in c}
        r["serve_launches"] = {path: c[r["name"]] for path, c in
                               serve_launches.items() if r["name"] in c}
        if r["name"] in family_launches:
            r["family_launches"] = family_launches[r["name"]]
        if r["name"] in train_launches:
            r["train_launches"] = train_launches[r["name"]]
            r.update(train_rows[r["name"]])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log("[phases] " + ", ".join(f"{k} {v:.2f} s" for k, v in phases.items())
        + f"; total {time.perf_counter() - t_start:.2f} s")
    log(json.dumps({"kernels": [
        {k: r[k] for k in keys + ("device_ms", "host_us", "max_bf16_steps",
                                  "ctas", "instance", "reduce_share",
                                  "graph_launches", "stream_launches",
                                  "serve_launches", "mesh_launches",
                                  "lm_mesh_launches", "paper_launches",
                                  "train_launches",
                                  "train_shape", "train_ms",
                                  "train_device_ms", "train_bound_ms",
                                  "train_bound_by", "train_library_ms",
                                  "family_launches", "family_shapes",
                                  "cp_offsets")
         if k in r}
        for r in rows]}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
