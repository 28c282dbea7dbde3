"""Drive the PyTorch/CUDA port (``mmlspark_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure exits nonzero and prints no result line:

1. card   — ``nvidia-smi`` name and power limit, the torch device name.
2. build  — compile ``mmlspark_tpu_torch/csrc``: the kernels with nvcc,
   the host plane (``binning.cpp``, ``murmur.cpp``) with g++ (each
   timed).
3. kernels against their plain PyTorch versions on the card, at the GBDT
   bench shapes (1M rows x 200 features, 255 bins): ``hist_accumulate`` at
   N = 1, 8, 16, 64 nodes in every lane layout and at its edges (128-bin
   gradients at their extremes, every row in one node and one bin, an
   all-inactive frontier, a ragged row count, and one streamed tile of
   131,072 rows whose last 48,576 are padded with node -1, at N = 1 and
   16, also timed); ``frontier_finish`` in
   direct, subtract and depth-gated modes, in the leaf-wise slot form (the
   parent read from the carry and both children written into it; int32
   and int16 carries, the step's gate on and off) and at its edges (2 and
   256 bins, one feature, 203 features, ungated 0/0 gains), each dense
   with 8 parents and in the slot form.  Histograms must be bit-identical;
   best splits equal, except where the two best gains are within 1e-6
   relative (an f32 near-tie), with left stats within rtol 1e-5; the slot
   form and the edges bit-identical in every array.  Then each kernel is
   timed at the main path's level-4 frontier step (8 parents, smaller
   children only; ``frontier_finish`` into dense arrays, the form
   ``frontier_step`` gives the level-wise grower), ``frontier_finish``
   also at the leaf-wise N = 1 step in the slot form, and both at every
   level of a depth-5 tree: device
   time from ``torch.profiler`` (``ms``) beside CUDA events around
   back-to-back wrapper calls (``wrapper_ms``), with the plain version
   and one library call timed by CUDA events.
4. slice  — ``LightGBMClassifier(max_depth=5, num_iterations=8)`` fits on
   1M x 200 binary data (the label of ``bench.py``'s GBDT phase), then
   transforms 100k fresh rows.  The kernels' launch counts are zeroed just
   before the fit and read just after the transform: each kernel must have
   run (8 trees x 5 levels = 40 launches each).  Accuracy must reach 0.9;
   the card's leaf walk must equal the CPU's; one depth-5 tree grown on the
   card must equal the same tree grown by the plain versions on the CPU.
5. leaf   — the leaf-wise grower and the boosting modes.  31-leaf trees
   grown on the card (50k x 20 uncapped and at ``max_depth=4``, int32
   carry; 2,000 rows, int16 carry) equal the CPU plain-version trees, and
   the card's growth runs under ``torch.cuda.set_sync_debug_mode("error")``
   (the step loop never waits for the card).  ``LightGBMClassifier()`` with
   its defaults (leaf-wise, 31 leaves) fits 8 iterations on the bench data
   with exactly 8 x 31 = 248 launches of each kernel, reaches accuracy 0.9
   on 100k fresh rows, and its card and CPU leaf walks agree; ``train()``
   phases and a profiled fit (2 of the 8 iterations) give the busy share,
   the top kernels, the ``cudaLaunchKernel`` calls per tree and the
   per-step kernel times of one tree beside each step's bound.  Bagging,
   GOSS, RF and DART each fit leaf-wise at 200k x 200 for 4 iterations and
   reach accuracy 0.85 on 50k fresh rows.
6. data   — edges on the host and bins on the card at 1M x 208 (the bench
   features plus NaN, +inf, -inf, integer codes, the leading -inf edge,
   a mix, ±inf alone and a constant): the card's train-route bins
   bit-identical to the port's host route, the numpy route's semantics on
   the card bit-identical to numpy's (on the first 250,000 rows: the
   numpy route's host apply is the slow one), ``bin_matrix`` on the card
   bit-identical to its CPU run; the edges, the transfer, the card apply
   and the C++ and numpy host applies timed.  (Every fit above already
   bins this way; ``fit_phases`` prints ``binning_s`` and its parts.)
7. cat    — categorical splits and the regression objectives.  50k x 20
   categorical trees (one-vs-rest and sorted-subset columns) grown on the
   card equal the CPU trees in every array, the leaf-wise one under sync
   debug mode "error";  ``LightGBMClassifier(categorical_features=...)``
   on the bench data with 10 columns of codes (5 of 3, 5 of 64) and a
   planted category subset in the label, leaf-wise defaults and then
   ``max_depth=5``, 8 iterations each: 248 and 40 launches of each kernel
   (one histogram build per step or level), accuracy 0.9 on 100k fresh
   rows, card walk = CPU walk, then each fit's ``train()`` phases and
   profile (2 iterations) as in the leaf phase; one fit per new regression
   objective at
   200k x 200 for 4 iterations, its default metric finite and falling.
8. multiclass — K = 3 trees per iteration at 50k x 20 grown from the
   columns of the (n, 3) gradients equal the CPU trees in every array
   (leaf-wise under sync debug mode "error", and level-wise);
   ``LightGBMClassifier()`` on 7-class labels (UCI Covertype's class count;
   the argmax of 7 fixed linear projections of the first 4 bench features
   plus noise) at 1M x 200, leaf-wise defaults and then ``max_depth=5``, 8
   iterations each: 8 x 7 x 31 = 1,736 and 8 x 7 x 5 = 280 launches of
   each kernel, accuracy 0.8 on 100k fresh rows, ``multi_logloss`` on them
   falling at every iteration, card walk = CPU walk; both fits profiled
   (1 iteration leaf-wise, 2 level-wise).
9. ranker — LambdaRank at 1M x 136 (MSLR-WEB30K's width) in ragged queries
   of 16-256 rows (~7,400), relevance 0-4 planted from two features: the
   lambdas on the card equal the CPU's within rtol 1e-5, atol 1e-6 at
   all-tied scores, after one tree and with rows outside every query (the
   card's pass under sync debug mode "error"); the pass timed (CUDA events)
   with its peak memory; one tree from the card's tied lambdas at the full
   1M x 136 x 255 with each of its 31 + 31 kernel calls bit-identical to
   the plain version on the same inputs, and one from the first ~50k rows'
   queries at 136 features on the card (sync debug mode "error") equal to
   the CPU tree in every array; ``LightGBMRanker()`` defaults for 8 iterations:
   248 launches of each kernel, NDCG@10 0.9 on 200 held-out queries, above
   a random ranking's; the fit profiled (2 iterations).
10. streamed — out-of-core ``train_streamed`` and checkpoints.  One tile
   (131,072 x 200 uint8) staged host -> card in three layouts, each
   timed with the kernel on it (PERF.md says which the driver keeps);
   50k x 20 in tiles of 8,192 (7 tiles, the last padded): 3 quantized
   iterations level-wise (``max_depth=4``) and leaf-wise
   (``num_leaves=15``) on the card equal the CPU's in every booster
   array; the bench data at 1M x 200 in tiles of 131,072 (8 tiles, the
   last with 82,496 real rows), 6 iterations (``STREAM_ITERS``; 8 through
   PR 20), level-wise ``max_depth=5`` (5 passes x 8 tiles x 6 iterations
   = 240 launches of each kernel) and leaf-wise ``num_leaves=31`` (one
   launch per tile per pass, up to 1,488), each
   with its binning and boosting times, prefetch wait and overlap, bytes
   per pass and the copy stream's rate, accuracy >= 0.9 on 100k fresh
   rows, and the leaf-wise fit's peak device memory under 150 MB; the
   level-wise fit at 262,144 rows a tile (4 tiles, 5 x 4 x 6 = 120
   launches of each kernel, accuracy >= 0.9) with edges equal to the
   host sketch fed those same tiles (1M rows are above the sketch's
   200,000-row sample cap, where the edges follow the tile width, as the
   JAX package's do; whether its booster differs from the 131,072-row
   fit's is printed, not gated); the leaf-wise fit preempted after
   iteration 3 (``request_preemption``) and resumed at the same width,
   bit-identical to the uninterrupted one; below the cap, the bench
   data's first 196,608 rows preempted at 32,768 rows a tile and resumed
   at 65,536, bit-identical to the uninterrupted fit; a leaf-wise
   ``train()`` fit preempted and resumed: tree structure equal, leaf
   values within 1e-6.
11. dnn    — deep-learning scoring, no JAX on the card: the committed
   ``artifacts/model_repo/ShapesResNet20`` through the port's repo and
   ``JaxModel`` (batch 256) on the trainer's 8,000-image holdout,
   accuracy within 0.002 of ``eval.json``, logits card = CPU on 512
   images; ResNet-50 at full width (224 x 224 x 3, 1000 classes, 2048-d
   features, every weight and BN statistic seeded): features of 8 images
   card = CPU in float32 (TF32 off) and bfloat16 = float32 on the card,
   each within its stated tolerance; backbone images/s at batch 256 in
   float32 and bfloat16 (CUDA events around normalize + ``features=True``),
   FLOPs per image from the layer shapes, the share of the dtype's dense
   peak and the peak memory; ``ImageFeaturizer`` end to end on 10,000
   seeded 32 x 32 x 3 uint8 images (resize to 224 and normalize on the
   card, bfloat16 backbone, batch 256): wall images/s and its split (host
   stacking, host -> card, device, card -> host), the first 4 images'
   features = the backbone's on the same resized input; the committed
   ONNX ``DigitsMLP``: logits card = CPU on 256 seeded inputs.  One
   summary line; details in the detail file.
12. seq    — the sequence models, no JAX on the card.  (a) Decode at
   ``bench.py``'s LM (vocab 512, embed 256, 4 heads, 4 layers, mlp 512,
   max_len 4096, causal, float32, seeded weights) through
   ``ModelRunner.decode``: bench.py's arm (8 x 16-token prompts, 32 new
   tokens) and 64 ragged prompts of 16-128 tokens with 128 new tokens
   and ``eos_id`` the token the model emits most, each dense and paged at
   page sizes 64 and 16: greedy tokens dense = paged bit-identical,
   collected logits within 1e-4 of dense, the card's tokens = the CPU's
   (except from a near-tie step, where the CPU's top two logits lie
   within 1e-4, reported) and logits within 1e-4, every page back in its
   pool; tokens/s (CUDA events around the call, and wall), steps,
   ``pages_peak``, cache bytes per sequence, peak memory; the dense and
   16-token-page decodes profiled (device time per forward, busy share,
   launches per forward, top kernels).  (b)
   ``TransformerEncoder`` at its defaults (vocab 512) on 8 x 4,096 tokens
   through ``JaxModel``: dense = blockwise = ring and card = CPU (2
   sequences) within 1e-4 of the outputs' largest magnitude;
   sequences/s and peak memory per mode.  (c) BASELINE config 5:
   ``BiLSTMTagger`` defaults, vocab 200, 3 tags, ``JaxModel`` at batch
   256 on 16,384 x 24 and 1,024 x 512 tokens: tokens/s, card = CPU
   within 1e-4 on 256 sequences each.  (d) ``export_gbdt`` of a booster
   fitted on the card, imported on the card, = ``raw_scores`` within
   1e-5; ``export_resnet`` of seeded ResNet-50 weights, imported, within
   1e-4 of the port's ResNet-50; a small torch CNN through
   ``torch_to_jax_model`` within 1e-5 of the module's own output.
13. serve  — the decode/serving engine at the seq phase's LM (seeded
   weights, float32), no JAX on the card.  (a) ``bench.py``'s continuous
   trace (48 Poisson arrivals at 1.25x the capacity of 8 slots, prompts
   of 4-16 tokens, budgets of 4-32, pages of 16, ``default_rng(17)``, on
   the step clock) through the ticked drain (``decode`` per group, bound
   by its longest budget) and through ``ContinuousDecoder``: every
   request's tokens equal a one-shot paged ``decode`` of its prompt,
   except from a step where the one-shot's top two logits lie within
   1e-4 (a near-tie, reported); every page back after ``close()``;
   useful tokens/s of each, prefills, steps, wall per forward, and the
   continuous engine's device time and kernels per forward
   (``torch.profiler``, the card's activity only).  (b) ``bench.py``'s
   template trace (40 arrivals, 3 templates of 12 tokens + 4-token
   suffixes, budget 16, pages of 4, ``default_rng(23)``) cold and with
   the prefix cache: cached tokens = cold tokens bit for bit, every page
   back after ``evict_pages``; hit rate, TTFT p50/p99, CoW splits.  (c)
   ``PipelineServer`` on 127.0.0.1 in front of
   ``runner.scorer(mode="decode", continuous=True, report_ttft=True,
   slots=8, prompt_bucket=16, max_new_tokens=32, page_size=16)``: the 48
   trace prompts answered 200 with one-shot tokens (near-tie rule);
   ``mixed_load``'s decode class, 128 requests from 8 persistent
   connections: p50, p99, TTFT p99, tokens/s; then ``drain()`` with 8
   requests of 512 tokens in flight: none dropped, a newcomer 503 with
   ``Retry-After``, every page back after ``stop()``; and a port
   ``LightGBMClassificationModel`` behind a ``PipelineServer``
   (``bench.py``'s phase_serving): single-row p50/p95 over one
   persistent connection, ``sustained_load``'s rps and p99.  (d) The
   stall drill: a continuous scorer with 2 live requests aborted as the
   watchdog's monitor thread does (``_stall_abort``) while its engine
   thread runs: both shed 503 ``shed_engine_stall``, the slabs dropped
   and every page back, the rebuild refused inside its backoff
   (``engine_restarting``), the rebuilt engine's first request = one-shot,
   ``mmlspark_engine_restarts_total`` 1, no engine thread left alive.
13b. graphs — the runner's compiled programs (CUDA graphs captured per
   signature by ``InstrumentedJit``) against the same runner code run
   eagerly (``eager_runner``: every program built by ``instrumented_call``),
   at the seq LM: (a) bench.py's decode arm (8 x 16 prompts, 32 new
   tokens) dense and paged at 16: greedy tokens equal, collected logits
   equal bit for bit; tokens/s in turns and ``decode_profile``'s host
   enqueue and device ms per forward, eager and replayed; (b) bench.py's
   continuous trace through each runner's engine: tokens equal, no join
   compiled, TTFT p50/p99; (c) copy-on-write splits (a 12-token prompt's
   full and partial hits, one-shot and through an engine): tokens and
   splits equal, splits > 0; (d) one call sequence on a runner on the card
   and one on the CPU: ``compile_stats()`` equal; (e) ResNet-50 bfloat16
   at batch 256 through ``apply_batch`` on 384 images: both buckets'
   replays = the module called eagerly, bit for bit.  Capture seconds per
   signature and the graph pool's bytes printed.  No kernel of this
   repository runs (``launches_by_path["graphs"]``, 0).
13c. gbdt_graphs — the GBDT family's compiled programs (budget 90 s,
   stated before the run).  Every GBDT fit and transform of this script
   runs them as CUDA graphs (``lightgbm.iter`` / ``iter_pre``, four
   iterations a graph in ``lightgbm.multi_iter``, ``objective``,
   ``valid_update``, ``tree_walk``, ``lambdarank_grads``, the four
   ``ooc_*`` programs, ``models.gbdt_walk``, ``ops.bin_matrix``), so the
   earlier GBDT phases' gates hold the replayed path; this phase holds it
   against the same code with its programs eager
   (``lightgbm.core.eager_programs``): (a) level-wise and leaf-wise at
   the bench width: a first fit (its captures), a second same-shape fit
   that compiles nothing and replays on the first fit's buffers, the
   eager fit and the unchunked fit (``MMLSPARK_TPU_GBDT_CHUNK=1``),
   boosters bit for bit, 40 / 248 launches of each kernel a fit; the
   transform of 1M rows replayed = eager; fit rows/s, boosting
   row-iterations/s and host enqueue per iteration eager and replayed,
   the leaf-wise busy share from ``torch.profiler``, peak memory; (b)
   multiclass (3), LambdaRank and DART at 200,000 x 200, replayed =
   eager; (c) a leaf-wise streamed fit of 4 x 131,072 rows, replayed =
   eager, its peak device memory under 150 MB; (d) the same fits and
   transform on the card and the CPU with empty program caches book the
   same compiles.  Capture seconds per program and the graph pool's bytes
   printed.  ``launches_by_path["gbdt_graphs"]``: the replayed fits of
   (a) and (c).
14. fleet  — the training monitor on the kernels and a serving fleet on
   one card, no JAX on the card.  (a) A ``TopologyService`` on 127.0.0.1;
   ``train()`` leaf-wise with its defaults (31 leaves, 8 iterations,
   quantized gradients) on the bench data at 1M x 200 with
   ``monitor_port=0`` and ``monitor_stall_timeout_s=60``: a thread polls
   ``/progress`` while the fit runs and registers the monitor with the
   topology (iteration 3's callback waits until the thread has read
   ``/fleet/metrics`` and ``/routing`` there); a reading with 0 < step <
   8 and rows/s > 0, the last step 8, exactly 248 launches of each
   kernel, the run's training series in ``/fleet/metrics`` and the
   trainer never in ``/routing``, the booster equal to the unmonitored
   fit's in every array; then unmonitored and monitored fits in turns
   (``boosting_s`` printed, not gated); ``train_streamed()`` leaf-wise on
   the first 262,144 rows in tiles of 131,072 with and without the
   monitor (one launch per tile per pass, live progress, boosters
   equal); one 31-leaf tree grown on the card inside
   ``ambient_phase("lightgbm.histogram")`` with a live monitor ticking,
   under ``torch.cuda.set_sync_debug_mode("error")``; ``saabas``
   contributions of 1,000 rows on the card = the CPU's within 1e-9, rows
   summing to the raw score within 1e-5.  (b) Two ``request_class=
   "score"`` ``WorkerServer``s wrapping a ``LightGBMClassificationModel``
   of (a)'s booster (the reply is the class-1 probability) and one
   ``"decode"`` worker wrapping the serve phase's continuous scorer
   (``report_ttft=True``, 8 slots, prompts of 16, 32 new tokens, pages of
   16), each with its own registry; a ``RoutingClient`` per class (the
   routing table carries every class): 1,000 single-row score requests
   from 8 threads, half round robin and half by key (hedging on), each
   within 1e-6 of the model's own transform on the card, beside the same
   1,000 sent straight to one worker (rps, p50, p99); the serve phase's
   48 trace prompts through the decode router, tokens = one-shot
   (near-tie rule), TTFT p99; ``federation_tick`` timed, the federated
   ``mmlspark_serving_requests_total{status="replied"}`` = the sum of the
   workers' own ``/metrics``; ``/fleet/autoscale`` per class; a drain of
   one score worker under load from 8 threads (no request fails, the
   ``MembershipWatcher`` sees it leave) and its next generation joining;
   the other score worker stopped hard (its breaker opens, every request
   fails over, no request fails) and every ``/fleet/*`` endpoint
   answering within its deadline; after ``stop()`` every page back and
   no thread the phase started left alive.
15. backends — the rest of the histogram dispatcher and the streamed
   tiles' transfer bytes.  (a) At the bench shape's level-4 step (1M x 200
   x 255, 16 gradient levels, 8 parents, the smaller children's 500,000
   rows): ``build_histograms_matmul_quantized`` on the card bit-identical
   to ``hist_accumulate``'s decoded lanes and to the plain scatter build;
   the float ``build_histograms_matmul`` within 1e-5 of the float scatter
   build relative to each cell's sum of (|g|, |h|, count), called with
   TF32 on (the build turns it off and restores it); both matmul builds,
   the scatter builds and the kernels timed with CUDA events (printed,
   not gated).  (b) ``train()`` at 200k x 200 for 4 iterations,
   leaf-wise and ``max_depth=5``, under ``MMLSPARK_TPU_HIST_BACKEND``
   unset, ``pallas``, ``matmul`` and ``scatter``: 4 x 31 and 4 x 5
   launches of each kernel under the first two, none under the others,
   every booster the unset one's in every array (or parted first at a
   reported f32 near-tie); ``MMLSPARK_TPU_HIST_QUANT=off`` runs the float
   path (no quantizer call, no launch); the environment put back after
   each fit.  (c) ``train_streamed()`` leaf-wise on the first 262,144
   rows in 2 tiles books ``mmlspark_device_transfer_bytes_total{site=
   "lightgbm.ooc_tile"}``: at least 262,144 x 200 bytes a histogram pass
   and the
   stager's own ``h2d_bytes``; its booster equals the same fit's with the
   tiles copied as before the booking, in every array; ``device_put`` of
   a pinned tile runs under sync debug mode "error".
16. vw — VowpalWabbit, BASELINE config 4, no JAX on the card (budget
   120 s): 400,000
   synthetic tweets and 100,000 held out (5-30 tokens over a 100,000-word
   Zipf(1.1) vocabulary; labels from a logistic model of 2,000 planted
   word weights, so the Bayes AUC is known).  (a) ``murmur3_batch_native``
   = ``murmur3_bytes`` on every word; ``VowpalWabbitFeaturizer(string_
   split_cols=["text"], num_bits=18)`` on every tweet, rows/s (the same
   tweets featurized at 24 bits in a child process meanwhile, for (c)).
   (b) ``VowpalWabbitClassifier()`` defaults on the card (the step a
   captured program, replayed), on the card with the step eager
   (``eager_plain_programs``) and on the CPU: weights within 1e-4 x
   max|w| of the CPU's and of the eager fit's, held-out AUC
   (``ComputeModelStatistics``) card = eager = CPU within 1e-4 and within
   0.02 of the Bayes AUC; fit rows/s, learn rows/s and steps/s of the
   step alone, host enqueue ms beside device ms a step (CUDA events),
   device ops a step (``torch.profiler`` over 50 steps), eager and
   replayed, peak device memory.  (c) The same at 24 bits (16.7M weights,
   201 MB of state): the same gates, the step's time and its share of HBM
   bandwidth.  (d) ``optimizer="bfgs"`` (20 iterations) on
   the first 100,000 tweets (budget 35 s): one estimator fitted twice on
   the card (the first fit captures ``vw.bfgs_direction`` and
   ``vw.bfgs_trial``, the second captures nothing), a fresh one with
   both programs eager, and the CPU: objectives within 1e-4 relative,
   AUC within 1e-3; fit s, trial points and host reads a fit, captures,
   replays, capture s, graph pool bytes; one more replayed fit profiled
   (device busy ms, its top kernels).  (e) ``VowpalWabbitRegressor(
   interactions=["ab"])`` on 100,000 rows of two namespaces and
   ``VowpalWabbitContextualBandit()`` (4 actions, ips) on 100,000 logged
   rows: card = CPU as in (b), the bandit also replayed = eager; the
   learned policy's true cost on held-out
   rows below the uniform logging policy's.  (f) ``model_bytes()``
   round-trips bit for bit; a saved model reloads and scores identically.
   No Hopper kernel of this repository runs in this phase.
17. featurize — featurization, the auto-trainers, Word2Vec and tuning
   (budget 125 s).
   (a) UCI Adult's shape, seeded (32,561 rows to train, 16,281 to test; 6
   numeric columns with 1% NaN, 8 string columns at the published
   cardinalities; the label from a planted logistic model, so the Bayes
   accuracy is known): ``TrainClassifier(LightGBMClassifier())`` at the
   estimator's defaults, one-hot and with ``one_hot_encode_categoricals=
   False`` (the index-encoded slots wired as ``categorical_features``).
   Gates: the featurized matrix uploaded to the card = the port's CPU
   featurization bit for bit, and its bins on the card = the host's; the
   wired slots = ``FeaturizeModel.categorical_slots()``; the booster =
   a plain ``LightGBMClassifier`` fitted on the card on the same frame in
   every array; test accuracy within 0.02 of the Bayes accuracy.  (b)
   ``Word2Vec()`` at its defaults on 100,000 of the vw phase's tweets,
   each epoch under sync debug mode "error", its steps replayed in
   captured blocks of 32, and again with the blocks eager
   (``eager_plain_programs``): vectors within 1e-3 x max|v| (two eager
   fits differ by ~3e-4 there, ``tools/w2v_spread.py``), pairs/s of each,
   the blocks' captures and capture seconds; on 2,000 tweets with the
   same uniforms card = CPU and replayed = eager within 1e-4 x max|v|;
   the step eager and the block replayed, host enqueue and device ms a
   step and a profile of 50 steps each;
   the document vectors through ``TrainClassifier(LightGBMClassifier(
   num_iterations=30))`` (held-out AUC >= a floor calibrated on the CPU,
   beside the Bayes AUC; trained on 20,000 tweets with the same uniforms
   on the card and on the CPU, held-out AUCs within 0.02);
   ``TuneHyperparameters(parallelism=2)`` over a grid on the learner
   (``num_leaves`` x ``learning_rate``): ``all_metrics`` = the candidates
   fitted alone, ``best_model``'s booster = its candidate's bit for bit,
   ``FindBestModel`` the same pick; a timed fit at ``vector_size=300``
   on the first 20,000 tweets.
   Each ``TrainClassifier`` and the tuning fits launch both kernels.
18. neighbours (budget 110 s) — (a) ``KNN`` (k = 5) over 100,000
   clustered items x 512 (ResNet-18's pooled width), every item querying
   the index (budget 50 s) through the model's ``nn.knn_search`` program
   (98 chunks of 1,024, the tail padded: the first transform captures
   once, the second only replays) and again with the search eager:
   replayed = eager bit for bit; card = CPU
   on 2,000 queries (scores within 1e-4 relative, indices equal apart
   from near-ties, a gap < 1e-5 x |score|), = the ball tree's exact MIPS
   on 20; query s and queries/s eager and replayed, a chunk's matmul and
   search, captures, replays, capture s, graph pool bytes.  (b) ``SAR`` (jaccard, support
   4, 30-day half-life) at MovieLens-1M's shape (6,040 users x 3,706
   items, 1,000,209 ratings): co-occurrence and similarity card = CPU bit
   for bit, scores within 1e-5 relative, top-10 lists equal apart from
   near-ties, ``RankingTrainValidationSplit(train_ratio=0.75)`` over
   ``RankingAdapter(SAR, k=10)`` with ndcgAt, map, precisionAtk and
   recallAtK card = CPU.  (c) ``IsolationForest()`` (100 trees of 256,
   contamination 0.01) on 1,000,000 x 20 float64 rows with 1% planted
   outliers: scores card = CPU within 1e-12 on 200,000 rows, labels
   equal, the planted outliers' AUC >= 0.9; rows/s of the walk.  No Hopper
   kernel of this repository runs in this phase.
19. explain — the explainers, AccessAnomaly, streaming speech, io, the
   cognitive services and the image chain (budget 150 s).  (a) Adult's shape index-encoded
   (32,561 x 14):
   ``LightGBMClassifier()`` fitted on the card (its launches are the
   ``explain`` path's), ``TabularSHAP`` (5,000 samples, 100 background
   rows) and ``TabularLIME`` (defaults) on 5 held-out rows, on the card
   and on the CPU: masks equal, scores within 1e-6, SHAP coefficients
   within 1e-4, LIME's within 1e-4 x max|coef|, each row's SHAP
   coefficients plus intercept its own score within 1e-3; no kernel
   launched while explaining; every LIME row's lasso (its 200 ISTA steps
   one captured program) = the eager loop bit for bit, ms a call of
   each.  (b) ``ImageLIME`` (256 samples) over the
   seeded float32 ResNet-50 (softmax, ``JaxModel``) on 4 procedural 224 x
   224 images, alpha 1e-7 (the random network's probabilities move by
   ~1e-4, so 0.01 zeroes every coefficient): superpixels = the CPU's, the
   card's lasso = the CPU's on the same inputs within 1e-4 x max|coef|
   (and of the intercept), nonzero, replayed = eager bit for bit;
   samples/s.  (c)
   ``AccessAnomaly()`` (rank 10, 10 sweeps, implicit) on 3 tenants of
   40,000 users in 3 departments x 10,000 resources, 1,000,000 distinct
   pairs each with seeded counts (budget 45 s), the half-sweep's
   ``cyber.als_accumulate`` and ``cyber.als_solve`` programs captured in
   the first sweep and replayed since: tenant 0 refitted on the CPU
   (factors and the 100,000 held-out scores within 1e-4 x max), again by
   the same estimator (capturing nothing; the spread from the first fit
   reported) and by a fresh one with both programs eager (replayed =
   eager within 1e-4 x max); the held-out accesses' 1%
   planted across departments at AUC >= 0.9; unseen users 3.0; explicit
   mode with ``complementset_factor=2`` on tenant 0; ALS sweep seconds
   eager and replayed, captures, replays, capture s, graph pool bytes and
   the fit's peak device memory beside the (chunk, k, k) buffer's bytes.
   (d) The streaming encoder's defaults from a seeded generator:
   ``SpeechToTextSDK`` on 32 seeded 20 s utterances at 16 kHz in 0.5 s
   chunks (each chunk's LSTM, head and argmax one captured program a
   chunk length), and again with the step eager: logits replayed = eager
   bit for bit, card = CPU per frame apart from near-ties (the CPU's top
   two logits within 1e-5, reported) and streamed = one full-utterance
   pass on the card by the same rule; host ms beside device ms a chunk,
   eager and replayed, chunks per second; ``ConversationTranscription``'s
   speaker turns on a
   two-voice stream card = CPU; ``SpeechServingModel`` behind
   ``PipelineServer`` on 127.0.0.1 with 16 concurrent sessions of 5 s,
   each transcript = its offline one.  (e) A 200,000 x 20 numeric CSV:
   ``read_csv(numeric_only=True)`` (the native parser) = the Python route
   in float32; 1,000 PNGs through ``read_binary_files`` / ``read_images``
   (= the source arrays) into ``ImageFeaturizer`` (the ResNet-50 at 224)
   on the card, = the backbone; every cognitive service against a mock on
   127.0.0.1 sends the requests recorded from the JAX package
   (``tests/resources/cognitive_requests.json``), and a 500 fills the
   error column.  (f) ``ImageTransformer`` ``resize(256, 256) ->
   center_crop(224, 224) -> blur(5, 5, 1.0) -> normalize() -> unroll()``
   (a featurizer's preprocessing) on 512 seeded float32 frames, 384 at
   480 x 640 x 3 and 128 at 360 x 480 x 3, mixed across 4 partitions of
   96, 128, 160 and 128 rows (budget 20 s): transformed twice through the
   ``opencv.image_chain`` program (row buckets of at most 64, padded to a
   power of two; the second transform captures nothing), with the chain
   eager, and on the CPU: replayed = eager bit for bit, card = CPU within
   1e-4; images/s of each, captures, replays, capture s, graph pool
   bytes.  The new parts (neighbours (a), explain (c), (f), vw (d))
   launch neither Hopper kernel.
20. harness — the test harness, codegen and the small utilities (budget
   60 s): (a) ``ClusterUtil.get_topology()`` reports the visible cards and
   platform ``gpu``, and ``default_parallelism`` follows them; (b) every
   ``testing.seeds.seed_objects()`` entry left on the default device (the
   card) passes ``ExperimentFuzzing`` and ``SerializationFuzzing``
   (reloaded = fitted within atol 1e-5), each of the three LightGBM seeds'
   fits launching both kernels; (c) ``train(callbacks=[
   LightGBMDelegate().as_callback()])`` at 200,000 x 200 calls the
   delegate once per iteration and grows the plain fit's booster bit for
   bit; (d) ``python -m mmlspark_tpu_torch codegen`` in a child process
   writes a manifest of the in-process registry's 144 stages.
21. sharded — the sharded GBDT on ``torch.distributed`` (budget 90 s): a
   world of two ranks on the one card over gloo (``parallel.world.World``;
   NCCL refuses two ranks on one device, gloo takes CUDA tensors in
   ``all_reduce``, the only collective the path needs).  Each rank makes
   the bench data from its seed and fits ``train(shard_rows=True)`` for 8
   iterations: (i) level-wise ``max_depth=5``, (ii) leaf-wise defaults,
   (iii) leaf-wise ``voting_k=20`` (``parallelism="voting_parallel"``'s
   default ``top_k``; 2k = 40 < 200 features, so the vote engages).  Rank
   0's first tree of (i) runs once more with every ``hist_accumulate``
   call held bit-identical to its plain version at the shard's 500,000 x
   200 x 255 (``kernels_held_to_plain``).  Gates: both ranks' boosters
   equal bit for bit in each fit; (i) and (ii) equal a world-1
   ``shard_rows=True`` fit in this process bit for bit; accuracy 0.9 on
   100k fresh rows each; both kernels launched in every fit of every rank
   (the sharded path sums the histograms before the gain scan, so it does
   not fuse: its builds go through ``build_quantized``, ``hist_accumulate``
   and ``frontier_finish`` decoding the lanes with its gains off, and the
   gains are scanned in torch on the summed histograms).  Printed: each
   rank's fit
   seconds, the bytes all-reduced per tree and the seconds in
   ``all_reduce`` (timed between device syncs), world 1 against world 2.
22. parallel — the rest of ``parallel/`` on ``torch.distributed`` (budget
   95 s), two ranks on the one card over gloo (``all_gather`` and
   ``ppermute`` carried by the slot all_reduce of
   ``parallel.collectives``).  The seeded models are drawn once and saved
   whole; every process loads them.  (a) ``run_local_cluster`` with 2
   executor processes: ResNet-50 at full width scores 512 images at 224
   through ``ModelRunner`` batch-sharded over ``data`` (both processes'
   logits equal, and within 1e-4 relative of world 1 here, float32);
   process 0 serves a ``WorkerServer`` and process 1 routes 8 requests
   through ``RoutingClient`` on 127.0.0.1 ports the OS picks (every routed
   reply equal to the stage called directly).  (b) ``Trainer`` on
   ResNet-50 (1,000 classes, 32 images a rank at 224, data 2, SGD with
   momentum, BatchNorm over the global batch), 6 steps through
   ``train_stream`` with ``checkpoint_every=3``; again preempted after
   step 3 and resumed at world 2 (bit-identical to the uninterrupted run)
   and here at world 1 (within 1e-4 relative); the uninterrupted state
   saved with ``backend="orbax"`` (``torch.distributed.checkpoint``) on
   both ranks and restored into a fresh trainer's template there, and
   here at world 1, bit for bit, save and load seconds; both ranks'
   params bit-identical after every step; step time, gradient bytes and
   timed ``all_reduce`` seconds a step.  (c) ``ring_attention`` at 2 x 4 x 4,096
   x 64 over ``seq`` 2, causal and not, within 1e-4 of dense attention;
   ``make_seq_parallel_train_step`` on the encoder at bench.py's LM width
   (ring mode, 2 x 4,096 tokens) for 3 steps, losses within 1e-4 relative
   of world 1's blockwise step at twice the rate (the reference's step is
   P times the mean-loss gradient).  (d) a GPipe pipeline of 2
   ``tanh(x @ W + b)`` stages at d 1,024, 8 microbatches of 256: forward
   within 1e-4 of the sequential stack, 3 steps, losses falling.  (e)
   ``MoELayer(E=8, d=1024, hidden=4096)`` on 4,096 tokens over ``expert``
   2: forward within 1e-5 relative of world 1, 5 Adam steps, both ranks'
   losses equal.  (f) VW defaults on each rank's half of the vw phase's
   tweets, the pass-end average: weights bit-identical on both ranks.
   Each leg prints one JSON line (seconds, collectives by route, peak
   device memory); TF32 is off in every leg.
23. analysis — graft-lint, the port's static-analysis gate (budget 15 s):
   ``mmlspark_tpu_torch.analysis.cli.main([])`` in this process over the
   checkout's ``mmlspark_tpu_torch`` against
   ``mmlspark_tpu_torch/analysis/baseline.toml``; any exit but 0 stops the
   run.  One JSON line: the phase's seconds, the findings, baselined and
   stale counts, and the rule families scanned.  Host-side source parsing:
   its 0 launches have their own key in ``launches_by_path``.
24. results — one ``{"kernels": [...]}`` line (``launches`` sums the
   level-wise fit + transform, the leaf-wise fit, the two categorical
   fits, the two multiclass fits, the ranker fit, the two streamed fits,
   the gbdt_graphs phase's replayed fits (each kernel launch a replay
   makes counted, as the graph's capture tallied it), the fleet phase's
   monitored ``train()`` and ``train_streamed()`` fits
   and the backends phase's unset and ``pallas`` fits and its booked
   streamed fit, the featurize phase's ``TrainClassifier`` and tuning
   fits, the explain phase's LightGBM fit, the harness phase's seed
   sweep and delegated fit, and both ranks' fits of the sharded phase,
   split in
   ``launches_by_path``; the vw, neighbours, parallel and analysis paths'
   0 have their own keys (the parallel path's summed over the rank and executor
   processes that run its legs, each counting its own); the dnn, seq and serve phases and the fleet phase's serving
   run no kernel of this repository on their paths (the serve phase's
   booster fit, the fleet phase's unmonitored fits and its one grown tree,
   and the backends phase's ``matmul``, ``scatter``, float and bare-copy
   fits, the featurize phase's plain fits, subset fits and candidates
   fitted alone, and the harness phase's plain fit are set-up, references
   or checks, as are the sharded phase's world-1 fits): the JAX package
   runs those
   paths in XLA, outside any Pallas kernel, and the port in cuDNN/cuBLAS
   and eager PyTorch), the card's name and power limit, and the last line
   ``{"ok": true, "device": {...}}``.

Details (per-level and per-step kernel times, every comparison) go to
``chiprun_out/chip_smoke_detail.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_ROWS, N_FEAT, N_BINS, QUANT_BINS = 1_000_000, 200, 255, 16
STREAM_TILE = 131_072           # train_streamed's tile rows at 1M x 200
STREAM_ITERS = 6                # the streamed phase's iterations
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
SCALAR_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
SOURCE = "mmlspark_tpu_torch/csrc/frontier.cu"
REPLACES = {"hist_accumulate": "mmlspark_tpu/ops/pallas_histogram.py:199",
            "frontier_finish": "mmlspark_tpu/ops/pallas_histogram.py:240"}
DETAIL = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after
    one warm-up call, between two CUDA events."""
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


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def leaf_finish_bytes(C: int, F: int, B: int, width: int,
                      root: bool = False) -> int:
    """Bytes a leaf-wise ``frontier_finish`` call must move: the lane sums,
    the parent read from the carry and the children written into it (both
    at the carry's dtype ``width``), the masks, scales and slots, and each
    child's best split (gain, feature, bin, left sums; the root also its
    totals)."""
    if root:
        return (C * F * B * 4 + F * B * 3 * width + F + F * B + 1 + 8 + 8
                + 36)
    return (C * F * B * 4 + 3 * F * B * 3 * width + F + F * B + 1 + 8
            + 1 + 24 + 2 * 24)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def best_error(kernel_best, plain_best) -> float:
    """Compare two (N_out, 9) best-split records; raise unless the picks are
    equal or an f32 near-tie.  Returns the max abs difference."""
    k, p = kernel_best.double().cpu(), plain_best.double().cpu()
    same = (k[:, 1] == p[:, 1]) & (k[:, 2] == p[:, 2])
    tie = (k[:, 0] - p[:, 0]).abs() <= 1e-6 * p[:, 0].abs()
    if not bool((same | tie).all()):
        raise AssertionError(f"best splits differ:\n{k}\n{p}")
    np.testing.assert_array_equal(k[:, 6:].numpy(), p[:, 6:].numpy())
    ks, ps = k[same], p[same]
    fin = torch.isfinite(ps[:, 0])
    np.testing.assert_allclose(ks[fin][:, [0, 3, 4, 5]].numpy(),
                               ps[fin][:, [0, 3, 4, 5]].numpy(), rtol=1e-5,
                               atol=1e-6)
    d = (ks - ps).abs()
    d[~torch.isfinite(d)] = 0.0          # -inf == -inf at gated nodes
    return float(d.max()) if d.numel() else 0.0


def device_ms(fn, reps: int, names) -> float:
    """Mean device time per call of ``fn`` spent in the kernels named by
    ``names``, from ``torch.profiler`` over ``reps`` calls after one
    warm-up: kernel time only, without the wrapper's host work or the
    allocations and memsets around the launch.  The profiler has been seen
    to drop kernel records of a window on an H100: one of 50, and once
    every record of two windows in a row.  A short window is profiled
    again, up to three windows; after three short ones the calls are timed
    between two CUDA events instead (``time_ms``: the wrapper's device
    work around the launch included, so never below the kernel's time).
    The short windows go to ``DETAIL["short_profiler_windows"]`` with
    their launch counts and the time that was returned."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, calls = 0.0, 0
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA and any(
                    name in evt.key for name in names):
                total += evt.self_device_time_total
                calls += evt.count
        if calls >= reps:
            ms, timed_by = total / 1e3 / reps, "profiler"
            break
        seen.append(calls)
        log(f"[profiler] saw {calls} launches of {names} in {reps} calls")
    else:
        ms, timed_by = time_ms(fn, reps), "cuda_events"
        log(f"[profiler] {names} timed between CUDA events instead: "
            f"{ms:.4f} ms a call")
    if seen:
        DETAIL.setdefault("short_profiler_windows", []).append(
            {"kernels": list(names), "calls": reps, "launches_seen": seen,
             "timed_by": timed_by, "ms": ms})
    return ms


KERNEL_NAMES = {"hist_accumulate": ("hist_accumulate_kernel",),
                "frontier_finish": ("frontier_finish_kernel",)}


def same_record(a, b) -> bool:
    """Bit-identical, with NaN equal to NaN (ungated 0/0 gains)."""
    if a.is_floating_point():
        return torch.equal(a.isnan(), b.isnan()) and torch.equal(
            a.nan_to_num(nan=7.0), b.nan_to_num(nan=7.0))
    return torch.equal(a, b)


def slot_step(CH, acc, lay, carry, gp, j, at_j, at_new):
    """The leaf-wise N = 1 step in the slot form, on the kernel and on the
    plain version, each from its own copy of ``carry``; raises unless every
    array of the two copies is bit-identical.  Returns the kernel's copy."""
    left = torch.ones((1,), dtype=torch.bool, device=acc.device)
    got = CH.FinishOut(*(x.clone() for x in carry[:5]))
    ref = CH.FinishOut(*(x.clone() for x in carry[:5]))
    CH.frontier_finish(acc, *lay, None, left, gp, out=got,
                       out_slots=(at_j, at_new), parent_slot=j)
    CH.frontier_finish_plain(acc, *lay, None, left, gp, out=ref,
                             out_slots=(at_j, at_new), parent_slot=j)
    torch.cuda.synchronize()
    for name, x, y in zip(got._fields[:5], got, ref):
        if not same_record(x, y):
            raise AssertionError(f"frontier_finish slot form: {name} "
                                 f"differs")
    return got


def kernel_phase(dev):
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    from mmlspark_tpu_torch.ops.histogram import _pack_lanes, \
        quantize_gradients

    n, F, B = N_ROWS, N_FEAT, N_BINS
    gen = torch.Generator(device=dev).manual_seed(0)
    binned = torch.randint(0, B, (F, n), generator=gen, device=dev,
                           dtype=torch.uint8).t()       # feature-major
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev) * 0.25 + 1e-3
    qg, qh, gs, hs = quantize_gradients(g, h, QUANT_BINS, generator=gen)
    qg, qh = CH.to_int8(qg), CH.to_int8(qh)
    errs = {"hist_accumulate": 0.0, "frontier_finish": 0.0}
    checks = []

    def node_ids(N, per_node, rows=n):
        if per_node is None:
            return torch.randint(0, N, (rows,), generator=gen, device=dev,
                                 dtype=torch.int32)
        ids = torch.full((rows,), -1, dtype=torch.int32, device=dev)
        sel = torch.randperm(rows, generator=gen, device=dev)[:per_node * N]
        ids[sel] = (torch.arange(per_node * N, device=dev) % N) \
            .to(torch.int32)
        return ids

    def check_accumulate(name, bins, q_g, q_h, ids, N, bound, quant_bins,
                         decode=False):
        lay = CH.lane_layout(bins.shape[0], bound, quant_bins)
        acc = CH.hist_accumulate(bins, q_g, q_h, ids, N, B, lay)
        acc_p = CH.hist_accumulate_plain(bins, q_g, q_h, ids, N, B, lay)
        torch.cuda.synchronize()
        if not torch.equal(acc, acc_p):
            raise AssertionError(f"hist_accumulate differs: {name} "
                                 f"{lay.mode}")
        if decode:
            hist, _ = CH.frontier_finish(acc, *lay)
            hist_p, _ = CH.frontier_finish_plain(acc, *lay)
            torch.cuda.synchronize()
            if not torch.equal(hist, hist_p):
                raise AssertionError(f"decode differs: {name} {lay.mode}")
        checks.append({"kernel": "hist_accumulate" + "+decode" * decode,
                       "case": name, "nodes": N, "layout": lay.mode,
                       "bit_identical": True})
        log(f"[kernels] hist_accumulate {name:22s} N={N:2d} {lay.mode:4s}: "
            f"bit-identical")
        return acc

    # hist_accumulate + decode, every lane layout, N = 1, 8, 16, 64
    for N in (1, 8, 16, 64):
        for per_node in (None, 4000, 128):        # wide, 2ch, all3
            check_accumulate("random", binned, qg, qh,
                             node_ids(N, per_node), N, per_node or n,
                             QUANT_BINS, decode=True)
    # the edges: 128-bin gradients at their extremes, every row on one
    # address, no active row, and a ragged row count
    qg128 = torch.randint(-64, 65, (n,), generator=gen, device=dev) \
        .to(torch.int8)
    qh128 = torch.randint(0, 128, (n,), generator=gen, device=dev) \
        .to(torch.int8)
    qg128[: n // 3], qh128[: n // 3] = -64, 127
    qg128[n // 3: n // 2], qh128[n // 3: n // 2] = 64, 127
    for per_node in (None, 4000, 60):
        check_accumulate("quant_bins=128 extremes", binned, qg128, qh128,
                         node_ids(8, per_node), 8, per_node or n, 128)
    one_bin = torch.full((F, n), 7, dtype=torch.uint8, device=dev).t()
    lo, hi = torch.full_like(qg128, -64), torch.full_like(qh128, 127)
    check_accumulate("one node, one bin", one_bin, lo, hi,
                     torch.full((n,), 5, dtype=torch.int32, device=dev), 8,
                     n, 128)
    del one_bin
    acc_none = check_accumulate(
        "all-inactive frontier", binned, qg, qh,
        torch.full((n,), -1, dtype=torch.int32, device=dev), 8, n // 2 + 16,
        QUANT_BINS)
    if acc_none.any():
        raise AssertionError("an all-inactive frontier must sum to zero")
    n_odd = n - 4017                               # no multiple of 4 x 1024
    check_accumulate("ragged rows", binned.t()[:, :n_odd].contiguous().t(),
                     qg[:n_odd].contiguous(), qh[:n_odd].contiguous(),
                     node_ids(8, None, n_odd), 8, n_odd, QUANT_BINS)
    # one tile of train_streamed: the bench width at 131,072 rows,
    # feature-major as it lands on the card, the last 48,576 rows padded
    # with node -1 (the 1M fit's last tile), lanes planned from the tile's
    # row bound; N = 1 (a leaf-wise pass) and N = 16 (level 4)
    T, real = STREAM_TILE, N_ROWS - 7 * STREAM_TILE
    tile = binned[:T].t().contiguous().t()
    qg_t, qh_t = qg[:T].contiguous(), qh[:T].contiguous()
    stream_tile = {}
    for N in (1, 16):
        ids_t = node_ids(N, None, T)
        ids_t[real:] = -1
        check_accumulate("streamed tile", tile, qg_t, qh_t, ids_t, N, T,
                         QUANT_BINS, decode=True)
        lay_t = CH.lane_layout(T, T, QUANT_BINS)
        Ct = CH._CHANNELS[lay_t.mode]

        def tile_call():
            return CH.hist_accumulate(tile, qg_t, qh_t, ids_t, N, B, lay_t)

        t_tile = device_ms(tile_call, 20, KERNEL_NAMES["hist_accumulate"])
        tb_ms, tb_by = bound_ms(T * 4 + real * (F + 2) + Ct * N * F * B * 4,
                                real * F * Ct)
        stream_tile[N] = {"ms": t_tile, "bound_ms": tb_ms, "bound_by": tb_by,
                          "layout": lay_t.mode, "active_rows": real,
                          "plain_ms": time_ms(lambda: CH.hist_accumulate_plain(
                              tile, qg_t, qh_t, ids_t, N, B, lay_t), 3)}
        log(f"[kernels] hist_accumulate streamed tile N={N}: {t_tile:.4f} "
            f"ms device, bound {tb_ms:.4f} ms ({tb_by}), plain "
            f"{stream_tile[N]['plain_ms']:.3f} ms")
    del tile

    # frontier_finish: direct (root), subtract (level 4), depth-gated
    fmask = torch.ones(F, dtype=torch.bool, device=dev)
    fmask[7] = False
    edge_ok = torch.ones((F, B), dtype=torch.bool, device=dev)
    edge_ok[:, B - 1] = False
    edge_ok[3, 100:] = False

    def gains(depth_ok=None):
        return CH.gain_params(gs, hs, fmask, edge_ok, depth_ok, l1=0.0,
                              l2=0.0, min_data=20.0, min_hess=1e-3)

    P = 8
    parent_ids = node_ids(P, None)
    small_left = torch.rand(P, generator=gen, device=dev) < 0.5
    in_small = torch.rand(n, generator=gen, device=dev) < 0.5
    small_ids = torch.where(in_small, parent_ids, -1).to(torch.int32)
    lay_n = CH.lane_layout(n, n, QUANT_BINS)
    parent = CH.frontier_finish_plain(
        CH.hist_accumulate_plain(binned, qg, qh, parent_ids, P, B, lay_n),
        *lay_n)[0]
    lay4 = CH.lane_layout(n, n // 2 + 2 * P, QUANT_BINS)
    acc4 = CH.hist_accumulate(binned, qg, qh, small_ids, P, B, lay4)
    root_ids = torch.zeros(n, dtype=torch.int32, device=dev)
    acc0 = CH.hist_accumulate(binned, qg, qh, root_ids, 1, B, lay_n)
    cases = {
        "direct": (acc0, lay_n, None, None, gains()),
        "subtract": (acc4, lay4, parent, small_left, gains()),
        "depth_ok=True": (acc4, lay4, parent, small_left, gains(True)),
        "depth_ok=False": (acc0, lay_n, None, None, gains(False)),
    }
    for name, (acc, lay, par, sl, gp) in cases.items():
        hist, best = CH.frontier_finish(acc, *lay, par, sl, gp)
        hist_p, best_p = CH.frontier_finish_plain(acc, *lay, par, sl, gp)
        torch.cuda.synchronize()
        if not torch.equal(hist, hist_p):
            raise AssertionError(f"frontier_finish {name}: histograms differ")
        err = best_error(best, best_p)
        errs["frontier_finish"] = max(errs["frontier_finish"], err)
        if name == "depth_ok=False" and not bool(
                torch.isneginf(best[:, 0]).all()):
            raise AssertionError("depth gate off must gate every candidate")
        checks.append({"kernel": "frontier_finish", "mode": name,
                       "hist_bit_identical": True, "best_max_abs_err": err,
                       "best_bit_identical": bool(torch.equal(best, best_p))})
        log(f"[kernels] frontier_finish {name:14s}: hist bit-identical, "
            f"best max|diff| {err:.3g}, "
            f"bit-identical={torch.equal(best, best_p)}")

    # the leaf-wise N = 1 step in the slot form: the parent read from the
    # carry and both children written into it, int32 and int16 carries,
    # the step's gate on (slots 2 and 5) and off (both to the trash slot 7)
    L = 7
    in_left = torch.rand(n, generator=gen, device=dev) < 0.5
    left_ids = torch.where(in_left, 0, -1).to(torch.int32)
    acc1 = CH.hist_accumulate(binned, qg, qh, left_ids, 1, B, lay_n)
    root_hist = CH.frontier_finish_plain(acc0, *lay_n)[0]
    slot = {s: torch.tensor([s], device=dev) for s in (2, 5, L)}
    for dtype in (torch.int32, torch.int16):
        hists = torch.randint(-999, 999, (L + 1, F, B, 3), generator=gen,
                              device=dev).to(dtype)
        hists[2] = root_hist[0].to(dtype)
        carry = CH.FinishOut(
            hists, torch.randn(L + 1, generator=gen, device=dev),
            torch.zeros(L + 1, dtype=torch.int32, device=dev),
            torch.zeros(L + 1, dtype=torch.int32, device=dev),
            torch.randn((L + 1, 3), generator=gen, device=dev))
        for do in (True, False):
            at_j, at_new = (slot[2], slot[5]) if do else (slot[L], slot[L])
            got = slot_step(CH, acc1, lay_n, carry, gains(True), slot[2],
                            at_j, at_new)
            if not do and not all(torch.equal(x[:L], y[:L])
                                  for x, y in zip(got[:5], carry)):
                raise AssertionError("a gated step wrote a real slot")
            name = f"slot N=1 {str(dtype)[6:]} gate {'on' if do else 'off'}"
            checks.append({"kernel": "frontier_finish", "mode": name,
                           "bit_identical": True})
            log(f"[kernels] frontier_finish {name}: carry bit-identical")
        if dtype == torch.int32:
            carry32 = carry

    # the edges: 2 and 256 bins, one feature, a feature count that is no
    # multiple of a block's five, and ungated 0/0 gains (NaN), each dense
    # (8 parents) and in the slot form (one parent)
    n_e = 200_000
    for name, B_e, F_e, ungated in (("B=2", 2, 24, False),
                                    ("B=256", 256, 24, False),
                                    ("F=1", 255, 1, False),
                                    ("F=203", 255, 203, False),
                                    ("ungated NaN", 255, 24, True)):
        b_e = torch.randint(0, B_e, (F_e, n_e), generator=gen, device=dev,
                            dtype=torch.int16).to(torch.uint8).t()
        qg_e, qh_e = qg[:n_e].contiguous(), qh[:n_e].contiguous()
        lay_e = CH.lane_layout(n_e, n_e, QUANT_BINS)
        fm_e = torch.ones(F_e, dtype=torch.bool, device=dev)
        ed_e = torch.ones((F_e, B_e), dtype=torch.bool, device=dev)
        gp_e = CH.gain_params(gs, hs, fm_e, ed_e, None, l2=0.0,
                              min_data=0.0, min_hess=0.0) if ungated else \
            CH.gain_params(gs, hs, fm_e, ed_e, True, l2=1.0, min_data=20.0,
                           min_hess=1e-3)
        pid = node_ids(8, None, n_e)
        par_e = CH.frontier_finish_plain(CH.hist_accumulate(
            b_e, qg_e, qh_e, pid, 8, B_e, lay_e), *lay_e)[0]
        sid = torch.where(in_small[:n_e], pid, -1).to(torch.int32)
        acc_e = CH.hist_accumulate(b_e, qg_e, qh_e, sid, 8, B_e, lay_e)
        sl_e = small_left.contiguous()
        hist, best = CH.frontier_finish(acc_e, *lay_e, par_e, sl_e, gp_e)
        hist_p, best_p = CH.frontier_finish_plain(acc_e, *lay_e, par_e,
                                                  sl_e, gp_e)
        torch.cuda.synchronize()
        if not (torch.equal(hist, hist_p) and same_record(best, best_p)):
            raise AssertionError(f"frontier_finish {name} (8 parents) "
                                 f"differs")
        if ungated and not bool(best.isnan().any()):
            raise AssertionError("the ungated case must have NaN gains")
        ids1 = torch.where(in_left[:n_e], 0, -1).to(torch.int32)
        acc_e1 = CH.hist_accumulate(b_e, qg_e, qh_e, ids1, 1, B_e, lay_e)
        hists_e = torch.zeros((L + 1, F_e, B_e, 3), dtype=torch.int32,
                              device=dev)
        hists_e[2] = CH.frontier_finish_plain(CH.hist_accumulate(
            b_e, qg_e, qh_e, torch.zeros(n_e, dtype=torch.int32, device=dev),
            1, B_e, lay_e), *lay_e)[0][0]
        carry_e = CH.FinishOut(
            hists_e, torch.zeros(L + 1, device=dev),
            torch.zeros(L + 1, dtype=torch.int32, device=dev),
            torch.zeros(L + 1, dtype=torch.int32, device=dev),
            torch.zeros((L + 1, 3), device=dev))
        slot_step(CH, acc_e1, lay_e, carry_e, gp_e, slot[2], slot[2],
                  slot[5])
        fb = CH._finish_plan(8, F_e, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        checks.append({"kernel": "frontier_finish", "mode": name,
                       "features_per_block_8_parents": fb,
                       "bit_identical": True})
        log(f"[kernels] frontier_finish {name:11s}: dense (8 parents, {fb} "
            f"features a block) and slot form bit-identical")
        del b_e

    # timing at the level-4 frontier step of a depth-5 tree: device time
    # from the profiler, the wrapper's pace from CUDA events
    C = acc4.shape[0]
    active = int((small_ids >= 0).sum())

    def acc_call():
        return CH.hist_accumulate(binned, qg, qh, small_ids, P, B, lay4)

    t_acc = device_ms(acc_call, 20, KERNEL_NAMES["hist_accumulate"])
    w_acc = time_ms(acc_call, 20)
    t_acc_plain = time_ms(lambda: CH.hist_accumulate_plain(
        binned, qg, qh, small_ids, P, B, lay4), 3)
    S = P * F * B
    seg = (small_ids.to(torch.int64)[:, None] * F
           + torch.arange(F, device=dev)[None, :]) * B \
        + binned.to(torch.int64)
    seg = torch.where(small_ids[:, None] >= 0, seg, S).reshape(-1)
    lanes4 = torch.stack(_pack_lanes(qg, qh, *lay4))
    src = lanes4.t()[:, None, :].expand(n, F, C).reshape(n * F, C) \
        .contiguous()
    dst = torch.zeros((S + 1, C), dtype=torch.int32, device=dev)
    t_acc_lib = time_ms(lambda: dst.index_add_(0, seg, src), 5)
    del seg, src, dst, lanes4
    # node ids of every row; bins and int8 gradients of the active rows;
    # the int32 output
    acc_bytes = n * 4 + active * (F + 2) + C * P * F * B * 4
    acc_bound, acc_by = bound_ms(acc_bytes, active * F * C)

    gp = gains()

    # the level-wise grower's form (``frontier_step``): dense arrays
    def fin_call():
        CH.frontier_finish(acc4, *lay4, parent, small_left, gp,
                           out=CH.dense_out(2 * P, F, B, dev))

    t_fin = device_ms(fin_call, 50, KERNEL_NAMES["frontier_finish"])
    w_fin = time_ms(fin_call, 50)
    t_fin_plain = time_ms(lambda: CH.frontier_finish_plain(
        acc4, *lay4, parent, small_left, gp), 3)
    n_out = 2 * P
    fin_bytes = (C * P * F * B * 4 + P * F * B * 12 + n_out * F * B * 12
                 + F + F * B + P + 8 + n_out * 36)
    fin_bound, fin_by = bound_ms(fin_bytes, n_out * F * B * 24)

    # the leaf-wise N = 1 step in the slot form (int32 carry; the children
    # go to slots 5 and 7 so that the parent in slot 2 stays as it is)
    left1, gp1 = torch.ones((1,), dtype=torch.bool, device=dev), gains(True)

    def fin1_call():
        CH.frontier_finish(acc1, *lay_n, None, left1, gp1, out=carry32,
                           out_slots=(slot[5], slot[L]), parent_slot=slot[2])

    t_fin1 = device_ms(fin1_call, 50, KERNEL_NAMES["frontier_finish"])
    w_fin1 = time_ms(fin1_call, 50)
    C1 = acc1.shape[0]
    fin1_bound, fin1_by = bound_ms(leaf_finish_bytes(C1, F, B, 4),
                                   2 * F * B * 24)
    log(f"[kernels] frontier_finish leaf-wise N=1 slot step: {t_fin1:.4f} "
        f"ms device ({w_fin1:.4f} wrapper), bound {fin1_bound:.4f} ms "
        f"({fin1_by})")

    # per-level kernel times of one depth-5 tree (direct root, then the
    # smaller children of 1, 2, 4, 8 parents)
    levels = []
    for d in range(5):
        Pd = max(1, 2 ** d // 2)
        if d == 0:
            ids, bound = root_ids, n
        else:
            ids = torch.where(in_small, node_ids(Pd, None), -1) \
                .to(torch.int32)
            bound = n // 2 + 2 ** d
        lay_d = CH.lane_layout(n, bound, QUANT_BINS)
        acc_d = CH.hist_accumulate(binned, qg, qh, ids, Pd, B, lay_d)
        par_d = None if d == 0 else torch.zeros((Pd, F, B, 3),
                                                dtype=torch.int32, device=dev)
        sl_d = None if d == 0 else small_left[:Pd].contiguous()

        def acc_d_call():
            return CH.hist_accumulate(binned, qg, qh, ids, Pd, B, lay_d)

        def fin_d_call():
            CH.frontier_finish(acc_d, *lay_d, par_d, sl_d, gp,
                               out=CH.dense_out(2 * Pd if d else 1, F, B,
                                                dev))

        rec = {"level": d, "parents": Pd, "layout": lay_d.mode,
               "active_rows": int((ids >= 0).sum()),
               "hist_accumulate_ms": device_ms(
                   acc_d_call, 10, KERNEL_NAMES["hist_accumulate"]),
               "hist_accumulate_wrapper_ms": time_ms(acc_d_call, 10),
               "frontier_finish_ms": device_ms(
                   fin_d_call, 20, KERNEL_NAMES["frontier_finish"]),
               "frontier_finish_wrapper_ms": time_ms(fin_d_call, 20)}
        levels.append(rec)
        log(f"[kernels] level {d}: {Pd} parent(s), {lay_d.mode}: "
            f"hist_accumulate {rec['hist_accumulate_ms']:.4f} ms device "
            f"({rec['hist_accumulate_wrapper_ms']:.4f} wrapper), "
            f"frontier_finish {rec['frontier_finish_ms']:.4f} ms device "
            f"({rec['frontier_finish_wrapper_ms']:.4f} wrapper)")
    torch.cuda.synchronize()
    DETAIL["checks"] = checks
    DETAIL["levels"] = levels
    DETAIL["level4_active_rows"] = active
    return {
        "hist_accumulate": dict(max_abs_err=errs["hist_accumulate"],
                                ms=t_acc, wrapper_ms=w_acc,
                                plain_ms=t_acc_plain, bound_ms=acc_bound,
                                bound_by=acc_by, library_ms=t_acc_lib,
                                stream_tile=stream_tile),
        "frontier_finish": dict(max_abs_err=errs["frontier_finish"],
                                ms=t_fin, wrapper_ms=w_fin,
                                plain_ms=t_fin_plain, bound_ms=fin_bound,
                                bound_by=fin_by, library_ms=None,
                                leaf_step_ms=t_fin1,
                                leaf_step_wrapper_ms=w_fin1,
                                leaf_step_bound_ms=fin1_bound),
    }


# ---------------------------------------------------------------------------
# phase 4: the slice, through the estimator
# ---------------------------------------------------------------------------

_BENCH_DATA: dict = {}


def bench_data(n: int, seed: int):
    """bench.py's GBDT phase data: N(0, 1) features, noisy linear label.
    Drawn once per (n, seed) in a process (1M x 200 takes seconds of host
    time, and ten phases ask for it); every call gets its own copies."""
    if (n, seed) not in _BENCH_DATA:
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(n, N_FEAT)).astype(np.float32)
        y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(scale=0.3, size=n)
             > 0).astype(np.float32)
        _BENCH_DATA[n, seed] = X, y
    X, y = _BENCH_DATA[n, seed]
    return X.copy(), y.copy()


def slice_phase(dev):
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
    from mmlspark_tpu_torch.ops import cuda_histogram as CH

    X, y = bench_data(N_ROWS, seed=0)
    Xt, yt = bench_data(100_000, seed=1)
    df = DataFrame.from_dict({"features": X, "label": y})
    df_t = DataFrame.from_dict({"features": Xt, "label": yt})
    clf = LightGBMClassifier().set_params(max_depth=5, num_iterations=8)
    torch.cuda.synchronize()
    CH.reset_launch_counts()
    t0 = time.perf_counter()
    model = clf.fit(df)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.transform(df_t).collect()
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    launches = CH.launch_counts()
    log(f"[slice] launches during fit+transform: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    prob = np.stack(out["probability"])
    if prob.shape != (100_000, 2) or not np.isfinite(prob).all():
        raise AssertionError(f"bad probabilities {prob.shape}")
    acc = float((out["prediction"] == yt).mean())
    log(f"[slice] accuracy on 100k fresh rows: {acc:.4f}")
    if acc < 0.9:
        raise AssertionError(f"accuracy {acc} < 0.9")
    booster = model.booster
    leaves_gpu = booster.predict_leaf(Xt[:20000])
    leaves_cpu = booster.predict_leaf(Xt[:20000], device="cpu")
    if not np.array_equal(leaves_gpu, leaves_cpu):
        raise AssertionError("card and CPU leaf walks differ")
    fit_rps = N_ROWS / fit_s
    transform_rps = 100_000 / transform_s
    log(f"[slice] fit {fit_s:.3f} s = {fit_rps:.0f} rows/s; transform "
        f"{transform_s:.3f} s = {transform_rps:.0f} rows/s")
    DETAIL["slice"] = {"fit_s": fit_s, "fit_rows_per_s": fit_rps,
                       "transform_s": transform_s,
                       "transform_rows_per_s": transform_rps,
                       "accuracy": acc, "launches": launches}
    return launches


def fit_phases(params, label: str, data=None, profile_iterations=None,
               **train_kw):
    """Where the fit's time goes: the trainer's own phase clocks, then a
    second fit under ``torch.profiler`` for the device time of the binning
    kernels and of each kernel in the boosting loop, and the loop's device
    busy share.  ``data`` defaults to the bench data; the profiled fit runs
    ``profile_iterations`` (default: all of them; the profiler's cost grows
    with the launches); ``train_kw`` goes to ``train()`` (a ranker's
    ``group_ptr``).  Returns the profiled run's booster and its
    ``hist_accumulate`` / ``frontier_finish`` device times per launch, in
    launch order."""
    from torch.profiler import ProfilerActivity, profile
    from mmlspark_tpu_torch.lightgbm import train
    X, y = data or bench_data(N_ROWS, seed=0)
    iters = params.num_iterations
    ex = dict(train(X, y, params, **train_kw).extras)
    ex["boosting_row_iterations_per_s"] = N_ROWS * iters / ex["boosting_s"]
    log(f"[{label}] train() phases: " + ", ".join(
        f"{k} {v:.4g}" for k, v in ex.items())
        + " (binning_s = edges_s + bin_apply_s; host numpy binning of this "
        "fit before the card applied the bins: 19.1-29.9 s, PERF.md)")

    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        prof_res = train(X, y, dataclasses.replace(
            params, num_iterations=profile_iterations or iters), **train_kw)
    prof_ex = prof_res.extras
    events = prof.events()
    # train()'s profiler ranges: the card's binning kernels run (and are
    # waited for) inside "train.bin_apply", before "train.boosting" starts
    spans = {e.name: e.time_range for e in events
             if e.name in ("train.bin_apply", "train.boosting")}
    loop_start = spans["train.boosting"].start
    by_kernel, bin_ms = {}, 0.0
    for e in events:
        # skipped: the host-to-card copies, and the ranges themselves,
        # which the profiler also books on the card's timeline
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                "memcpy" in e.name.lower() or e.name in spans:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        if e.time_range.start >= loop_start:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + ms
        elif e.time_range.start >= spans["train.bin_apply"].start:
            bin_ms += ms
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    share = busy_ms / (prof_ex["boosting_s"] * 1e3)
    # every kernel the host enqueued in the loop, ours and PyTorch's: the
    # host's work
    runtime_launches = sum(1 for e in events if e.name == "cudaLaunchKernel"
                           and e.time_range.start >= loop_start)
    trees = prof_res.booster.num_trees
    log(f"[{label}] profiled fit of {trees} trees and its parse: "
        f"{time.perf_counter() - t_prof:.1f} s")
    log(f"[{label}] profiled fit: binning kernels on the card "
        f"{bin_ms:.3f} ms; boosting {prof_ex['boosting_s']:.4f} s, "
        f"device kernels {busy_ms:.3f} ms (busy share {share:.3f}), "
        f"{runtime_launches} cudaLaunchKernel calls "
        f"({runtime_launches / trees:.0f} per tree over {trees} trees; the "
        f"two-kernel finish with the grower's copies: 3,362 leaf-wise, 354 "
        f"level-wise)")
    for name, ms in top:
        log(f"[{label}]   {ms:9.3f} ms  {name[:90]}")
    per_launch = {}
    for kernel, names in KERNEL_NAMES.items():
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and any(nm in e.name for nm in names)]
        per_name = [sorted((e for e in events if nm in e.name),
                           key=lambda e: e.time_range.start)
                    for nm in names]
        per_launch[kernel] = [sum(e.time_range.elapsed_us() for e in evs)
                              / 1e3 for evs in zip(*per_name)]
    DETAIL[label + "_train_phases"] = ex
    DETAIL[label + "_profile"] = {
        "boosting_s": prof_ex["boosting_s"], "device_kernel_ms": busy_ms,
        "binning_kernel_ms": bin_ms, "train_phases": prof_ex,
        "busy_share": share, "top_kernels_ms": top, "trees": trees,
        "cuda_launch_kernel_calls": runtime_launches,
        "launches_profiled": {k: len(v) for k, v in per_launch.items()},
        "profiled_fit_and_parse_s": time.perf_counter() - t_prof}
    return prof_res.booster, per_launch


def grower_check(dev):
    """One depth-5 tree on the card equals the same tree grown by the plain
    versions on the CPU, from the same data and quantizer uniforms."""
    from mmlspark_tpu_torch.lightgbm import BinMapper, GBDTParams
    from mmlspark_tpu_torch.lightgbm.core import make_tree_grower
    rng = np.random.default_rng(5)
    n, F = 50_000, 20
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] * X[:, 2] > 0).astype(np.float32)
    mapper = BinMapper(255).fit(X)
    binned = mapper.transform(X)
    p = 1 / (1 + np.exp(-rng.normal(scale=0.5, size=n)))
    g = (p - y).astype(np.float32)
    h = (p * (1 - p)).astype(np.float32)
    u = rng.random((2, n), dtype=np.float32)
    params = GBDTParams(max_depth=5, use_quantized_grad=True,
                        lambda_l2=1.0).resolve()
    grow = make_tree_grower(5, F, 255, params)
    trees = []
    for d in (dev, torch.device("cpu")):
        def t(a):
            return torch.from_numpy(a).to(d)
        trees.append(grow(t(binned).t().contiguous().t(), t(g), t(h),
                          torch.ones(n, dtype=torch.bool, device=d),
                          torch.ones(F, dtype=torch.bool, device=d),
                          t(mapper.edges), noise=t(u)))
    identical = card_equals_cpu(*trees, "depth-5 tree")
    log(f"[slice] depth-5 tree on the card equals the CPU plain-version "
        f"tree (bit-identical in {identical} arrays)")


def card_equals_cpu(card, cpu, what: str) -> str:
    """Raise unless a tree grown on the card equals the CPU's: integer
    arrays bit-identical, float arrays (f32 math on both) within rtol 1e-6.
    Returns how many arrays are bit-identical, as "k/n"."""
    identical = []
    for name, a, b in zip(card._fields, card, cpu):
        if a is None and b is None:
            continue
        a, b = a.cpu(), b.cpu()
        if a.is_floating_point():
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=0, err_msg=f"{what}: {name}")
        elif not torch.equal(a, b):
            raise AssertionError(f"{what} on the card differs in {name}")
        identical.append(bool(torch.equal(a, b)))
    return f"{sum(identical)}/{len(identical)}"


# ---------------------------------------------------------------------------
# phase 5: the leaf-wise grower and the boosting modes
# ---------------------------------------------------------------------------

def leafwise_grower_check(dev):
    """31-leaf trees grown on the card equal the same trees grown by the
    plain versions on the CPU: uncapped and capped at ``max_depth=4`` at
    50k x 20 (an int32 histogram carry), and uncapped at 2,000 rows (the
    int16 carry).  The card's growth runs under
    ``torch.cuda.set_sync_debug_mode("error")``: any call that waits for the
    card raises, so the step loop is shown never to sync."""
    from mmlspark_tpu_torch.lightgbm import BinMapper, GBDTParams
    from mmlspark_tpu_torch.lightgbm.core import (leafwise_store_dtype,
                                                  make_leafwise_grower)
    from mmlspark_tpu_torch.models.gbdt import children_depth_bound
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    rng = np.random.default_rng(6)
    n_all, F = 50_000, 20
    X = rng.normal(size=(n_all, F)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] * X[:, 2] + 0.5 * X[:, 3] > 0).astype(np.float32)
    p = 1 / (1 + np.exp(-rng.normal(scale=0.5, size=n_all)))
    g_all = (p - y).astype(np.float32)
    h_all = (p * (1 - p)).astype(np.float32)
    u_all = rng.random((2, n_all), dtype=np.float32)
    results = []
    for n, max_depth in ((n_all, 0), (n_all, 4), (2_000, 0)):
        mapper = BinMapper(255).fit(X[:n])
        binned = mapper.transform(X[:n])
        params = GBDTParams(num_leaves=31, max_depth=max_depth,
                            use_quantized_grad=True, lambda_l2=1.0).resolve()
        grow = make_leafwise_grower(31, max_depth, F, 255, params)
        trees = []
        for d in (dev, torch.device("cpu")):
            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(d)
            args = (t(binned).t().contiguous().t(), t(g_all[:n]),
                    t(h_all[:n]), torch.ones(n, dtype=torch.bool, device=d),
                    torch.ones(F, dtype=torch.bool, device=d),
                    t(mapper.edges))
            u = t(u_all[:, :n])
            torch.cuda.synchronize()
            CH.reset_launch_counts()
            if d.type == "cuda":
                torch.cuda.set_sync_debug_mode("error")
            try:
                tree = grow(*args, noise=u)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if d.type == "cuda":
                torch.cuda.synchronize()
                launches = CH.launch_counts()
                if set(launches.values()) != {31}:
                    raise AssertionError(f"leaf-wise tree launched "
                                         f"{launches}, not 31 each")
            trees.append(tree)
        identical = card_equals_cpu(
            *trees, f"leaf-wise tree (n={n}, max_depth={max_depth})")
        card = trees[0]
        rec = {"rows": n, "max_depth": max_depth,
               "carry": str(leafwise_store_dtype(n, True, QUANT_BINS)),
               "splits": int((card.split_feature >= 0).sum()),
               "depth": children_depth_bound(card.left_child.cpu().numpy(),
                                             card.right_child.cpu().numpy()),
               "bit_identical_arrays": identical,
               "sync_debug_mode": "error"}
        results.append(rec)
        log(f"[leafwise] {n} x {F}, max_depth={max_depth}, {rec['carry']} "
            f"carry: {rec['splits']} splits, depth {rec['depth']}; the card "
            f"tree equals the CPU tree ({rec['bit_identical_arrays']} arrays "
            f"bit-identical), grown under sync debug mode 'error', 31 "
            f"launches of each kernel")
    DETAIL["leafwise_grower_check"] = results


def leaf_slice_phase(dev):
    """``LightGBMClassifier()`` with its defaults (leaf-wise, 31 leaves) for
    8 iterations on the bench data, then transform of 100k fresh rows."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
    from mmlspark_tpu_torch.ops import cuda_histogram as CH

    X, y = bench_data(N_ROWS, seed=0)
    Xt, yt = bench_data(100_000, seed=1)
    df = DataFrame.from_dict({"features": X, "label": y})
    df_t = DataFrame.from_dict({"features": Xt, "label": yt})
    clf = LightGBMClassifier().set_params(num_iterations=8)
    torch.cuda.synchronize()
    CH.reset_launch_counts()
    t0 = time.perf_counter()
    model = clf.fit(df)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = CH.launch_counts()
    log(f"[leaf] launches during the fit: {launches}")
    if launches != {"hist_accumulate": 248, "frontier_finish": 248}:
        raise AssertionError(f"the leaf-wise fit must launch each kernel "
                             f"8 x 31 = 248 times, got {launches}")
    t0 = time.perf_counter()
    out = model.transform(df_t).collect()
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    prob = np.stack(out["probability"])
    if prob.shape != (100_000, 2) or not np.isfinite(prob).all():
        raise AssertionError(f"bad probabilities {prob.shape}")
    acc = float((out["prediction"] == yt).mean())
    booster = model.booster
    log(f"[leaf] accuracy on 100k fresh rows: {acc:.4f}; {booster.num_trees}"
        f" trees of {booster.num_leaves} leaves, walk depth "
        f"{booster.max_depth}")
    if acc < 0.9:
        raise AssertionError(f"accuracy {acc} < 0.9")
    leaves_gpu = booster.predict_leaf(Xt[:20000])
    leaves_cpu = booster.predict_leaf(Xt[:20000], device="cpu")
    if not np.array_equal(leaves_gpu, leaves_cpu):
        raise AssertionError("card and CPU leaf walks differ")
    fit_rps = N_ROWS / fit_s
    transform_rps = 100_000 / transform_s
    log(f"[leaf] fit {fit_s:.3f} s = {fit_rps:.0f} rows/s; transform "
        f"{transform_s:.3f} s = {transform_rps:.0f} rows/s; card and CPU "
        f"leaf walks equal")
    DETAIL["leaf_slice"] = {"fit_s": fit_s, "fit_rows_per_s": fit_rps,
                            "transform_s": transform_s,
                            "transform_rows_per_s": transform_rps,
                            "accuracy": acc, "launches": launches,
                            "walk_depth": booster.max_depth}
    return launches


def leaf_step_times(booster, per_launch):
    """Per-step device times of the first tree of the profiled leaf-wise
    fit, each beside the bound for that step's active rows: the root reads
    every row, step s >= 1 the rows of internal node s - 1's left child
    (the child each step rebuilds).  Where the profiler dropped a record
    of the fit (``device_ms``), no launch can be matched to its step: the
    steps' times are not measured (None), and the window goes to
    ``DETAIL["short_profiler_windows"]``."""
    from mmlspark_tpu_torch.lightgbm.core import leafwise_store_dtype
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    n, F, B = N_ROWS, N_FEAT, N_BINS
    expected = booster.num_trees * booster.num_leaves
    if any(len(times) != expected for times in per_launch.values()):
        seen = {k: len(v) for k, v in per_launch.items()}
        log(f"[profiler] saw {seen} launches in the leaf-wise fit of "
            f"{expected} each: per-step times not measured")
        DETAIL.setdefault("short_profiler_windows", []).append(
            {"kernels": list(per_launch), "calls": expected,
             "launches_seen": seen, "timed_by": None})
        per_launch = {k: [None] * expected for k in per_launch}
    lc, ic, lcnt = (booster.left_child[0], booster.internal_count[0],
                    booster.leaf_count[0])
    M = lc.shape[0]
    C = CH._CHANNELS[CH.lane_layout(n, n, QUANT_BINS).mode]
    width = leafwise_store_dtype(n, True, QUANT_BINS).itemsize  # the carry
    steps = []
    for s in range(M + 1):
        if s == 0:
            active = n
        else:
            child = int(lc[s - 1])
            active = int(ic[child] if child >= 0 else lcnt[~child])
        n_out = 1 if s == 0 else 2
        acc_bound, acc_by = bound_ms(n * 4 + active * (F + 2)
                                     + C * F * B * 4, active * F * C)
        fin_bound, fin_by = bound_ms(
            leaf_finish_bytes(C, F, B, width, root=s == 0),
            n_out * F * B * 24)
        steps.append({
            "step": s, "active_rows": active,
            "hist_accumulate_ms": per_launch["hist_accumulate"][s],
            "hist_accumulate_bound_ms": acc_bound,
            "hist_accumulate_bound_by": acc_by,
            "frontier_finish_ms": per_launch["frontier_finish"][s],
            "frontier_finish_bound_ms": fin_bound,
            "frontier_finish_bound_by": fin_by})
        log(f"[leaf] step {s:2d}: {active:7d} rows, hist_accumulate "
            f"{steps[-1]['hist_accumulate_ms']} ms (bound "
            f"{acc_bound:.4f}, {acc_by}), frontier_finish "
            f"{steps[-1]['frontier_finish_ms']} ms (bound "
            f"{fin_bound:.4f})")
    tot = {k: None if None in v else sum(v) for k, v in per_launch.items()}
    log(f"[leaf] profiled fit: hist_accumulate {tot['hist_accumulate']} "
        f"ms over {len(per_launch['hist_accumulate'])} launches, "
        f"frontier_finish {tot['frontier_finish']} ms over "
        f"{len(per_launch['frontier_finish'])}")
    DETAIL["leaf_steps_tree0"] = steps
    DETAIL["leaf_kernel_ms_per_fit"] = tot


MODES = {"bagging": dict(bagging_fraction=0.8, bagging_freq=1),
         "goss": dict(boosting_type="goss"),
         "rf": dict(boosting_type="rf"),
         "dart": dict(boosting_type="dart")}


def modes_phase(dev):
    """Bagging, GOSS, RF and DART, each leaf-wise through the estimator at
    200k x 200 for 4 iterations, scored on 50k fresh rows."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    X, y = bench_data(200_000, seed=2)
    Xt, yt = bench_data(50_000, seed=3)
    df = DataFrame.from_dict({"features": X, "label": y})
    df_t = DataFrame.from_dict({"features": Xt, "label": yt})
    results = {}
    for name, kw in MODES.items():
        torch.cuda.synchronize()
        CH.reset_launch_counts()
        t0 = time.perf_counter()
        model = LightGBMClassifier().set_params(num_iterations=4,
                                                **kw).fit(df)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = CH.launch_counts()
        out = model.transform(df_t).collect()
        acc = float((out["prediction"] == yt).mean())
        b = model.booster
        results[name] = {"accuracy": acc, "fit_s": fit_s,
                         "launches": launches,
                         "tree_weight": b.tree_weight.tolist(),
                         "root_rows": b.internal_count[:, 0].tolist(),
                         "average_output": b.average_output}
        log(f"[modes] {name:7s}: accuracy {acc:.4f}, fit {fit_s:.2f} s, "
            f"launches {launches}, root rows "
            f"{b.internal_count[:, 0].astype(int).tolist()}, tree weights "
            f"{[round(float(w), 4) for w in b.tree_weight]}")
        if acc < 0.85 or set(launches.values()) != {4 * 31}:
            raise AssertionError(f"{name}: accuracy {acc} < 0.85 or "
                                 f"launches {launches} != 124")
    DETAIL["modes"] = results


# ---------------------------------------------------------------------------
# phase 6: the data plane
# ---------------------------------------------------------------------------

def data_matrix(n: int, seed: int) -> np.ndarray:
    """The bench features plus 8 columns of the awkward values binning must
    keep: NaN, +inf, -inf, integer codes, the column whose first fitted
    edge is -inf (codes with -inf in every 7th row), all three mixed, ±inf
    alone and a constant."""
    X, _ = bench_data(n, seed)
    rng = np.random.default_rng(seed + 50)
    extra = np.empty((n, 8), np.float32)
    extra[:, 0] = np.where(rng.random(n) < 0.1, np.nan, rng.normal(size=n))
    extra[:, 1] = rng.exponential(size=n)
    extra[::13, 1] = np.inf
    extra[:, 2] = rng.normal(size=n)
    extra[::17, 2] = -np.inf
    extra[:, 3] = rng.integers(0, 10, n)
    extra[:, 4] = rng.integers(0, 5, n)
    extra[::7, 4] = -np.inf
    extra[:, 5] = rng.choice(np.array([np.nan, np.inf, -np.inf, 1.0, 2.0],
                                      np.float32), size=n)
    extra[:, 6] = np.where(rng.random(n) < 0.5, -np.inf, np.inf)
    extra[:, 7] = 3.0
    return np.concatenate([X, extra], axis=1)


def data_phase(dev):
    """Edges on the host, bins on the card, at the bench size plus the 8
    awkward columns: the card's train-route bins bit-identical to the
    port's host route (which the CPU tests hold equal to the JAX package's),
    the numpy route's semantics on the card bit-identical to numpy,
    ``bin_matrix`` on the card bit-identical to its CPU run; each part
    timed."""
    from mmlspark_tpu_torch.lightgbm.binning import BinMapper, host_route
    from mmlspark_tpu_torch.ops import histogram as H
    X = data_matrix(N_ROWS, seed=0)
    n, F = X.shape
    route = host_route(X.size)
    t0 = time.perf_counter()
    mapper = BinMapper(N_BINS).fit(X)
    edges_s = time.perf_counter() - t0
    if mapper.edges[N_FEAT + 4, 0] != -np.inf:
        raise AssertionError("the -inf column must fit a leading -inf edge")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = torch.from_numpy(X).to(dev)
    torch.cuda.synchronize()
    transfer_s = time.perf_counter() - t0
    tables = {}
    for r in ("cxx", "numpy"):
        table, ascending = mapper.route_table(r)
        if not ascending.all():
            raise AssertionError(f"{r} route table not ascending")
        tables[r] = torch.from_numpy(table).to(dev)
    t_apply = {r: time_ms(lambda r=r: H.apply_bins(
        x, tables[r], nan_to_num=r == "numpy"), 5) for r in tables}
    del x
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = mapper.bin_on_device(X, dev)
    torch.cuda.synchronize()
    bin_on_device_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = mapper.transform(X)
    host_s = time.perf_counter() - t0
    if not torch.equal(card.t().cpu(), torch.from_numpy(host)):
        raise AssertionError("card bins differ from the host route's")
    # the numpy route on the first quarter of the rows (its bins are
    # elementwise; the whole 1M took 23.4 s on the host)
    m = n // 4
    t0 = time.perf_counter()
    numpy_bins = mapper._host_bins(X[:m], "numpy", mapper.edges)
    numpy_s = time.perf_counter() - t0
    card_np = H.apply_bins(torch.from_numpy(X[:m]).to(dev), tables["numpy"],
                           nan_to_num=True)
    if not torch.equal(card_np.t().cpu(), torch.from_numpy(numpy_bins)):
        raise AssertionError("the numpy route on the card differs")
    differ = int((numpy_bins != host[:m]).any(axis=0).sum())
    del card_np, numpy_bins
    e_dev = torch.from_numpy(mapper.edges).to(dev)
    bm_card = H.bin_matrix(torch.from_numpy(X).to(dev), e_dev, N_BINS)
    t_bm = time_ms(lambda: H.bin_matrix(torch.from_numpy(X).to(dev), e_dev,
                                        N_BINS), 3)
    if not torch.equal(bm_card.cpu(), H.bin_matrix(
            torch.from_numpy(X), torch.from_numpy(mapper.edges), N_BINS)):
        raise AssertionError("bin_matrix on the card differs from the CPU")
    del bm_card, card
    rec = {"rows": n, "features": F, "host_route": route,
           "edges_s": edges_s, "transfer_s": transfer_s,
           "card_apply_ms": t_apply[route],
           "card_apply_ms_by_route": t_apply,
           "bin_on_device_s": bin_on_device_s,
           "train_route_binning_s": edges_s + bin_on_device_s,
           "host_apply_s": {route: host_s, "numpy": numpy_s},
           "numpy_route_rows": m,
           "bin_matrix_ms_with_transfer": t_bm,
           "features_where_the_routes_differ": differ}
    log(f"[data] {n} x {F} ({route} route): edges {edges_s:.3f} s, X to "
        f"the card {transfer_s:.3f} s, card apply {t_apply[route]:.2f} ms "
        f"(numpy route {t_apply['numpy']:.2f} ms), bin_on_device "
        f"{bin_on_device_s:.3f} s; host apply {route} {host_s:.3f} s, "
        f"numpy {numpy_s:.3f} s on {m:,} rows; bin_matrix with transfer "
        f"{t_bm:.2f} ms")
    log(f"[data] train-route binning {edges_s + bin_on_device_s:.3f} s "
        f"(host numpy binning of a 1M x 200 fit before the card applied "
        f"the bins: 19.1-29.9 s, PERF.md); card bins "
        f"bit-identical to the host route, numpy route ({m:,} rows) and "
        f"bin_matrix bit-identical on the card; the routes differ on "
        f"{differ} features")
    DETAIL["data"] = rec


# ---------------------------------------------------------------------------
# phase 7: categorical splits and the regression objectives
# ---------------------------------------------------------------------------

CAT_COLS = list(range(N_FEAT - 10, N_FEAT))       # 5 x 3 codes, 5 x 64
PLANTED = np.random.default_rng(7).permutation(64)[:32]


def cat_data(n: int, seed: int, F: int = N_FEAT):
    """The bench data with its last 10 columns replaced by codes (5 of 3
    codes, 5 of 64), the label the bench label plus a planted half of one
    64-code column's codes and one 3-code column's code 1."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    cols = list(range(F - 10, F))
    X[:, cols[:5]] = rng.integers(0, 3, (n, 5))
    X[:, cols[5:]] = rng.integers(0, 64, (n, 5))
    in_set = np.isin(X[:, cols[5]], PLANTED)
    y = (X[:, 0] + 0.5 * X[:, 1] + 1.5 * (in_set - 0.5)
         + 0.8 * (X[:, cols[0]] == 1) + rng.normal(scale=0.3, size=n)
         > 0).astype(np.float32)
    return X, y, cols


def cat_grower_check(dev):
    """50k x 20 categorical trees (one-vs-rest and sorted-subset columns)
    grown on the card equal the CPU trees in every array, category sets
    included; the leaf-wise one under sync debug mode "error"."""
    from mmlspark_tpu_torch.lightgbm import BinMapper, GBDTParams
    from mmlspark_tpu_torch.lightgbm.core import (_cat_subset,
                                                  make_leafwise_grower,
                                                  make_tree_grower)
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    n, F = 50_000, 20
    X, y, cols = cat_data(n, seed=8, F=F)
    rng = np.random.default_rng(9)
    p = 1 / (1 + np.exp(-rng.normal(scale=0.5, size=n)))
    g = (p - y).astype(np.float32)
    h = (p * (1 - p)).astype(np.float32)
    u = rng.random((2, n), dtype=np.float32)
    mapper = BinMapper(N_BINS, categorical_features=cols).fit(X)
    binned = torch.from_numpy(mapper.transform(X))
    base = GBDTParams(categorical_features=tuple(cols),
                      use_quantized_grad=True, lambda_l2=1.0)
    subset = _cat_subset(base, binned, N_BINS)
    if subset != tuple(cols[5:]):
        raise AssertionError(f"cardinality split {subset}")
    results = []
    for growth in ("leaf", "level"):
        if growth == "leaf":
            params = dataclasses.replace(base, num_leaves=31,
                                         cat_subset=subset).resolve()
            grow = make_leafwise_grower(31, 0, F, N_BINS, params)
            launches = 31
        else:
            params = dataclasses.replace(base, max_depth=5,
                                         cat_subset=subset).resolve()
            grow = make_tree_grower(5, F, N_BINS, params)
            launches = 5
        trees = []
        for d in (dev, torch.device("cpu")):
            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(d)
            args = (binned.to(d).t().contiguous().t(), t(g), t(h),
                    torch.ones(n, dtype=torch.bool, device=d),
                    torch.ones(F, dtype=torch.bool, device=d),
                    t(mapper.edges))
            noise = t(u)
            torch.cuda.synchronize()
            CH.reset_launch_counts()
            if d.type == "cuda" and growth == "leaf":
                torch.cuda.set_sync_debug_mode("error")
            try:
                tree = grow(*args, noise=noise)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if d.type == "cuda":
                torch.cuda.synchronize()
                got = CH.launch_counts()
                if set(got.values()) != {launches}:
                    raise AssertionError(f"{growth}-wise categorical tree "
                                         f"launched {got}")
            trees.append(tree)
        identical = card_equals_cpu(*trees, f"{growth}-wise categorical "
                                            f"tree")
        sf = trees[0].split_feature.cpu().numpy()
        cat_splits = int(np.isin(sf, cols).sum())
        if not cat_splits:
            raise AssertionError(f"{growth}-wise tree made no categorical "
                                 f"split")
        results.append({"growth": growth, "bit_identical_arrays": identical,
                        "categorical_splits": cat_splits,
                        "splits": int((sf >= 0).sum())})
        log(f"[cat] {growth}-wise 50k x 20 tree on the card equals the CPU "
            f"tree ({identical} arrays bit-identical, {cat_splits} "
            f"categorical of {int((sf >= 0).sum())} splits"
            + (", sync debug mode 'error')" if growth == "leaf" else ")"))
    DETAIL["cat_grower_check"] = results


def cat_phase(dev):
    """``LightGBMClassifier(categorical_features=...)`` at 1M x 200, leaf-wise
    defaults and then ``max_depth=5``, 8 iterations each: accuracy on 100k
    fresh rows, the kernels' launches (the categorical path builds its
    histograms on both kernels and searches splits in torch: one build per
    leaf-wise step, one per level), card walk = CPU walk."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.lightgbm import GBDTParams, LightGBMClassifier
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    X, y, cols = cat_data(N_ROWS, seed=10)
    Xt, yt, _ = cat_data(100_000, seed=11)
    df = DataFrame.from_dict({"features": X, "label": y})
    df_t = DataFrame.from_dict({"features": Xt, "label": yt})
    out_launches, results = {}, {}
    for label, kw, per_tree in (("leaf", {}, 31),
                                ("level", dict(max_depth=5), 5)):
        clf = LightGBMClassifier().set_params(
            num_iterations=8, categorical_features=cols, **kw)
        torch.cuda.synchronize()
        CH.reset_launch_counts()
        t0 = time.perf_counter()
        model = clf.fit(df)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = CH.launch_counts()
        want = {"hist_accumulate": 8 * per_tree,
                "frontier_finish": 8 * per_tree}
        if launches != want:
            raise AssertionError(f"categorical {label}-wise fit launched "
                                 f"{launches}, not {want}")
        out = model.transform(df_t).collect()
        acc = float((out["prediction"] == yt).mean())
        b = model.booster
        leaves_gpu = b.predict_leaf(Xt[:20000])
        leaves_cpu = b.predict_leaf(Xt[:20000], device="cpu")
        if not np.array_equal(leaves_gpu, leaves_cpu):
            raise AssertionError("card and CPU categorical walks differ")
        cat_nodes = int(np.isin(b.split_feature, cols).sum())
        log(f"[cat] {label}-wise fit {fit_s:.3f} s, launches {launches}, "
            f"accuracy {acc:.4f} on 100k fresh rows, {cat_nodes} "
            f"categorical splits, category sets "
            f"{'stored' if b.cat_bitset is not None else 'none'}; card "
            f"and CPU walks equal")
        if acc < 0.9 or b.cat_bitset is None or not cat_nodes:
            raise AssertionError(f"categorical {label}-wise: accuracy {acc}"
                                 f", {cat_nodes} categorical splits")
        out_launches[label] = launches
        results[label] = {"fit_s": fit_s, "accuracy": acc,
                          "launches": launches,
                          "categorical_splits": cat_nodes}
    DETAIL["cat"] = results
    # the profiles hold 2 of the 8 iterations: a profile's cost grows with
    # its launches (the leaf-wise one took 53.7 s at 8)
    for label, kw in (("cat_leaf", dict(num_leaves=31)),
                      ("cat_level", dict(max_depth=5))):
        fit_phases(GBDTParams(num_iterations=8, objective="binary",
                              categorical_features=tuple(cols), **kw),
                   label, (X, y), profile_iterations=2)
    return out_launches


REG_OBJECTIVES = ("regression_l1", "huber", "quantile", "poisson", "tweedie",
                  "gamma")


def objectives_phase(dev):
    """One fit per new regression objective at 200k x 200, 4 iterations,
    leaf-wise, with a 50k-row valid set: the default metric finite and
    falling."""
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train
    from mmlspark_tpu_torch.lightgbm.core import default_metric
    n, nv = 200_000, 50_000
    X, _ = bench_data(n + nv, seed=12)
    rng = np.random.default_rng(13)
    counts = rng.poisson(np.exp(0.5 * X[:, 0] - 0.3 * X[:, 1] + 0.2)) \
        .astype(np.float32)
    cont = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(scale=0.3, size=n + nv)) \
        .astype(np.float32)
    results = {}
    for obj in REG_OBJECTIVES:
        y = {"poisson": counts, "tweedie": counts + 0.5,
             "gamma": counts + 0.5}.get(obj, cont)
        t0 = time.perf_counter()
        r = train(X[:n], y[:n], GBDTParams(objective=obj, num_iterations=4,
                                           num_leaves=31),
                  valid=(X[n:], y[n:]))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        name = default_metric(obj)
        vals = [e[name] for e in r.evals]
        log(f"[objectives] {obj:13s} {name:12s} "
            f"{' '.join(f'{v:.5f}' for v in vals)} (fit {fit_s:.2f} s)")
        if not (np.isfinite(vals).all() and vals[-1] < vals[0]):
            raise AssertionError(f"{obj}: {name} {vals} not finite and "
                                 f"falling")
        results[obj] = {"metric": name, "evals": vals, "fit_s": fit_s}
    DETAIL["objectives"] = results


# ---------------------------------------------------------------------------
# phase 8: multiclass
# ---------------------------------------------------------------------------

N_CLASSES = 7                                     # UCI Covertype's classes
W_CLASSES = np.random.default_rng(70).normal(size=(N_CLASSES, 4))


def mc_data(n: int, seed: int, F: int = N_FEAT, K: int = N_CLASSES):
    """The bench features; the label the argmax of K fixed linear
    projections of the first 4 features plus N(0, 0.1²) noise."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    z = X[:, :4] @ W_CLASSES[:K].T + rng.normal(scale=0.1, size=(n, K))
    return X, np.argmax(z, axis=1).astype(np.float32)


def multiclass_grower_check(dev):
    """K = 3 trees per iteration at 50k x 20, grown from the columns of the
    (n, 3) multiclass gradients (views with stride 3, as ``train()`` hands
    them over), on the card and on the CPU: every array equal, leaf-wise
    (under sync debug mode "error", the three trees back to back) and
    level-wise."""
    from mmlspark_tpu_torch.lightgbm import BinMapper, GBDTParams
    from mmlspark_tpu_torch.lightgbm.core import _make_grower, make_objective
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    n, F, K = 50_000, 20, 3
    X, y = mc_data(n, seed=22, F=F, K=K)
    rng = np.random.default_rng(23)
    mapper = BinMapper(N_BINS).fit(X)
    binned = torch.from_numpy(mapper.transform(X))
    scores = torch.from_numpy(rng.normal(scale=0.5, size=(n, K))
                              .astype(np.float32))
    u = torch.from_numpy(rng.random((K, 2, n), dtype=np.float32))
    results = []
    for growth, kw, per_tree in (("leaf", dict(num_leaves=31), 31),
                                 ("level", dict(max_depth=5), 5)):
        params = GBDTParams(objective="multiclass", num_class=K,
                            use_quantized_grad=True, lambda_l2=1.0,
                            **kw).resolve()
        # made once on the host, so both devices quantize the same floats
        g_all, h_all = make_objective(params)(scores, torch.from_numpy(y),
                                              torch.ones(n))
        grow = _make_grower(params, F, N_BINS)
        out = []
        for d in (dev, torch.device("cpu")):
            g, h = g_all.to(d), h_all.to(d)
            if g.stride() != (K, 1):
                raise AssertionError(f"gradients not (n, K) row-major: "
                                     f"{g.stride()}")
            args = (binned.to(d).t().contiguous().t(),)
            rest = (torch.ones(n, dtype=torch.bool, device=d),
                    torch.ones(F, dtype=torch.bool, device=d),
                    torch.from_numpy(mapper.edges).to(d))
            ud = u.to(d)
            torch.cuda.synchronize()
            CH.reset_launch_counts()
            if d.type == "cuda" and growth == "leaf":
                torch.cuda.set_sync_debug_mode("error")
            try:
                trees = [grow(*args, g[:, c], h[:, c], *rest, noise=ud[c])
                         for c in range(K)]
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if d.type == "cuda":
                torch.cuda.synchronize()
                got = CH.launch_counts()
                if set(got.values()) != {K * per_tree}:
                    raise AssertionError(f"{growth}-wise K={K} trees "
                                         f"launched {got}")
            out.append(trees)
        identical = [card_equals_cpu(a, b, f"{growth}-wise class {c} tree")
                     for c, (a, b) in enumerate(zip(*out))]
        splits = [tuple(t.split_feature.cpu().tolist()) for t in out[0]]
        if len(set(splits)) != K:
            raise AssertionError("the classes grew the same tree")
        results.append({"growth": growth, "classes": K,
                        "bit_identical_arrays": identical,
                        "launches_per_class": per_tree})
        log(f"[multiclass] {growth}-wise K={K} trees at {n} x {F} on the "
            f"card equal the CPU trees (arrays bit-identical per class: "
            f"{', '.join(identical)})"
            + (", grown under sync debug mode 'error'" if growth == "leaf"
               else ""))
    DETAIL["multiclass_grower_check"] = results


def multiclass_phase(dev):
    """``LightGBMClassifier()`` on 7-class labels at 1M x 200, leaf-wise
    defaults and then ``max_depth=5``, 8 iterations each (7 trees an
    iteration): the kernels' launches, accuracy on 100k fresh rows,
    ``multi_logloss`` on them after each iteration, card walk = CPU walk."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.lightgbm import GBDTParams, LightGBMClassifier
    from mmlspark_tpu_torch.lightgbm.core import _metric_multi_logloss
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    t0 = time.perf_counter()
    X, y = mc_data(N_ROWS, seed=20)
    Xt, yt = mc_data(100_000, seed=21)
    df = DataFrame.from_dict({"features": X, "label": y})
    df_t = DataFrame.from_dict({"features": Xt, "label": yt})
    out_launches, results = {}, {"data_s": time.perf_counter() - t0}
    for label, kw, per_tree in (("leaf", {}, 31),
                                ("level", dict(max_depth=5), 5)):
        clf = LightGBMClassifier().set_params(num_iterations=8, **kw)
        torch.cuda.synchronize()
        CH.reset_launch_counts()
        t0 = time.perf_counter()
        model = clf.fit(df)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = CH.launch_counts()
        n_launch = 8 * N_CLASSES * per_tree
        if launches != {"hist_accumulate": n_launch,
                        "frontier_finish": n_launch}:
            raise AssertionError(f"multiclass {label}-wise fit launched "
                                 f"{launches}, not {n_launch} of each")
        t0 = time.perf_counter()
        out = model.transform(df_t).collect()
        torch.cuda.synchronize()
        transform_s = time.perf_counter() - t0
        prob = np.stack(out["probability"])
        if prob.shape != (100_000, N_CLASSES) or \
                not np.isfinite(prob).all():
            raise AssertionError(f"bad probabilities {prob.shape}")
        acc = float((out["prediction"] == yt).mean())
        b = model.booster
        ll = [_metric_multi_logloss(yt, b.raw_scores(Xt, num_iteration=i))
              for i in range(1, 9)]
        leaves_gpu = b.predict_leaf(Xt[:20000])
        leaves_cpu = b.predict_leaf(Xt[:20000], device="cpu")
        if not np.array_equal(leaves_gpu, leaves_cpu):
            raise AssertionError("card and CPU multiclass walks differ")
        log(f"[multiclass] {label}-wise fit {fit_s:.3f} s, launches "
            f"{launches}, {b.num_trees} trees; accuracy {acc:.4f} on 100k "
            f"fresh rows; transform {transform_s:.3f} s; multi_logloss by "
            f"iteration {' '.join(f'{v:.4f}' for v in ll)}; card and CPU "
            f"walks equal")
        if acc < 0.8 or b.num_trees != 8 * N_CLASSES or \
                not all(b2 < a2 for a2, b2 in zip(ll, ll[1:])):
            raise AssertionError(f"multiclass {label}-wise: accuracy {acc}, "
                                 f"{b.num_trees} trees, logloss {ll}")
        out_launches[label] = launches
        results[label] = {"fit_s": fit_s, "fit_rows_per_s": N_ROWS / fit_s,
                          "transform_s": transform_s, "accuracy": acc,
                          "launches": launches, "multi_logloss": ll}
    DETAIL["multiclass"] = results
    # the leaf-wise profile holds 1 of the 8 iterations (7 trees, ~20k
    # launches), the level-wise one 2: a profile's cost grows with its
    # launches
    for label, kw, prof_it in (("multiclass_leaf", dict(num_leaves=31), 1),
                               ("multiclass_level", dict(max_depth=5), 2)):
        t0 = time.perf_counter()
        fit_phases(GBDTParams(num_iterations=8, objective="multiclass",
                              num_class=N_CLASSES, **kw), label, (X, y),
                   profile_iterations=prof_it)
        results[label + "_fit_phases_s"] = time.perf_counter() - t0
    return out_launches


# ---------------------------------------------------------------------------
# phase 9: the LambdaRank ranker
# ---------------------------------------------------------------------------

RANK_FEAT = 136                                   # MSLR-WEB30K's width


def rank_data(n: int, seed: int):
    """``n`` rows x 136 features in ragged queries of 16-256 rows (the last
    one cut to fit); relevance 0-4 planted from two features plus noise.
    Returns ``(X, rel, group_ptr)``."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(16, 257, n // 16 + 1)
    gp = np.concatenate([[0], np.cumsum(sizes)])
    gp = np.concatenate([gp[gp < n], [n]])
    X = rng.normal(size=(n, RANK_FEAT)).astype(np.float32)
    raw = 1.2 * X[:, 0] - 0.8 * X[:, 1] + 0.3 * rng.normal(size=n)
    rel = np.digitize(raw, [-0.5, 0.5, 1.3, 2.1]).astype(np.float32)
    return X, rel, gp


def ndcg_at_k(scores, rel, group_ptr, k=10):
    """Independent NDCG@k (a copy of ``_ndcg_at_k`` in
    ``tests/test_ranker_ndcg_gate.py``): gain 2^rel - 1, log2 discount,
    ideal DCG by brute-force descending-relevance sort per query."""
    vals = []
    for i in range(len(group_ptr) - 1):
        a, b = group_ptr[i], group_ptr[i + 1]
        order = np.argsort(-scores[a:b], kind="stable")
        g = (2.0 ** rel[a:b] - 1.0)
        disc = 1.0 / np.log2(np.arange(b - a) + 2.0)
        dcg = float((g[order][:k] * disc[:k]).sum())
        ideal = float((np.sort(g)[::-1][:k] * disc[:k]).sum())
        if ideal > 0:
            vals.append(dcg / ideal)
    return float(np.mean(vals))


@contextlib.contextmanager
def kernels_held_to_plain(CH, checked):
    """Within the block every ``hist_accumulate`` and ``frontier_finish``
    call also runs the kernel's plain version on the same inputs, on the
    card (the finish into a copy of the arrays it writes), and raises unless
    every output is bit-identical (NaN equal to NaN).  ``checked`` counts
    the calls held, by kernel.  The wrappers count their launches on the
    module's names, so the stand-ins carry the counts while they stand."""
    acc_kernel, fin_kernel = CH.hist_accumulate, CH.frontier_finish

    def acc(binned, qg, qh, ids, N, B, lay):
        got = acc_kernel(binned, qg, qh, ids, N, B, lay)
        if not torch.equal(got, CH.hist_accumulate_plain(binned, qg, qh, ids,
                                                         N, B, lay)):
            raise AssertionError(f"hist_accumulate differs at "
                                 f"{tuple(binned.shape)}, N={N}, {lay.mode}")
        checked["hist_accumulate"] += 1
        return got

    def fin(acc_, *args, out=None, **kw):
        ref = None if out is None else out._replace(
            **{k: v.clone() for k, v in out._asdict().items()
               if v is not None})
        got = fin_kernel(acc_, *args, out=out, **kw)
        want = CH.frontier_finish_plain(acc_, *args, out=ref, **kw)
        pairs = zip(out, ref) if out is not None else zip(got, want)
        for x, y in pairs:
            if x is not None and not same_record(x, y):
                raise AssertionError(f"frontier_finish differs at "
                                     f"{tuple(acc_.shape)}")
        checked["frontier_finish"] += 1
        return got

    CH.hist_accumulate, CH.frontier_finish = acc, fin
    try:
        yield
    finally:
        CH.hist_accumulate, CH.frontier_finish = acc_kernel, fin_kernel


def ranker_grower_check(dev, X, rel, gp):
    """One ranker tree from the card's lambdas at the all-tied first
    iteration, the first tree the fit grows: (1) at the phase's full
    1M x 136 x 255 on the card, every kernel call held against its plain
    version on the same inputs (``kernels_held_to_plain``); (2) from the
    queries of the first ~50k rows at the same 136 features, grown on the
    card (under sync debug mode "error") and on the CPU, every array of
    the two trees equal."""
    from mmlspark_tpu_torch.lightgbm import BinMapper, GBDTParams
    from mmlspark_tpu_torch.lightgbm.core import (_make_grower,
                                                  make_lambdarank_grad_fn)
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    n, F = X.shape
    params = GBDTParams(objective="lambdarank", num_leaves=31,
                        use_quantized_grad=True).resolve()
    grow = _make_grower(params, F, N_BINS)
    mapper = BinMapper(N_BINS).fit(X)
    binned = mapper.bin_on_device(X, dev).t()          # (n, F) feature-major
    edges = torch.from_numpy(mapper.edges)
    u = torch.from_numpy(np.random.default_rng(32).random((2, n),
                                                          dtype=np.float32))
    g, h = make_lambdarank_grad_fn(rel, gp, 1.0, device=dev)(
        torch.zeros((n, 1), device=dev))
    checked = {"hist_accumulate": 0, "frontier_finish": 0}
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    CH.reset_launch_counts()
    with kernels_held_to_plain(CH, checked):
        tree = grow(binned, g[:, 0], h[:, 0],
                    torch.ones(n, dtype=torch.bool, device=dev),
                    torch.ones(F, dtype=torch.bool, device=dev),
                    edges.to(dev), noise=u.to(dev))
    torch.cuda.synchronize()
    launches = CH.launch_counts()
    if checked != {"hist_accumulate": 31, "frontier_finish": 31} or \
            launches != checked:
        raise AssertionError(f"the held ranker tree checked {checked}, "
                             f"launched {launches}")
    splits = int((tree.split_feature >= 0).sum())
    held_s = time.perf_counter() - t0
    log(f"[ranker] tree at {n} x {F} x {N_BINS} from the card's lambdas: "
        f"{splits} splits, each of its 31 hist_accumulate and 31 "
        f"frontier_finish calls bit-identical to the plain version on the "
        f"same inputs ({held_s:.1f} s)")

    q = int(np.searchsorted(gp, 50_000, side="right")) - 1
    m = int(gp[q])
    g_s, h_s = make_lambdarank_grad_fn(rel[:m], gp[:q + 1], 1.0, device=dev)(
        torch.zeros((m, 1), device=dev))
    b_s = binned.t()[:, :m].contiguous()                # (F, m)
    trees = []
    for d in (dev, torch.device("cpu")):
        args = (b_s.to(d).t(), g_s[:, 0].to(d), h_s[:, 0].to(d),
                torch.ones(m, dtype=torch.bool, device=d),
                torch.ones(F, dtype=torch.bool, device=d), edges.to(d))
        ud = u[:, :m].contiguous().to(d)
        torch.cuda.synchronize()
        if d.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            trees.append(grow(*args, noise=ud))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    identical = card_equals_cpu(*trees, f"ranker tree ({m} x {F})")
    log(f"[ranker] tree from the card's lambdas at {m} x {F} ({q} queries) "
        f"on the card equals the CPU tree ({identical} arrays "
        f"bit-identical), grown under sync debug mode 'error'")
    return {"held_rows": n, "features": F, "held_splits": splits,
            "held_calls": checked, "held_s": held_s, "cpu_rows": m,
            "cpu_queries": q, "bit_identical_arrays": identical}


def ranker_phase(dev):
    """LambdaRank at 1M x 136 in ~7,400 ragged queries: the lambdas on the
    card against the CPU's (all-tied scores, after one tree, with rows
    outside every query), the pass's time and peak memory, then
    ``LightGBMRanker()`` with its defaults for 8 iterations (248 launches of
    each kernel) and NDCG@10 on 200 held-out queries."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.lightgbm import (GBDTParams, LightGBMRanker,
                                             train)
    from mmlspark_tpu_torch.lightgbm.core import make_lambdarank_grad_fn
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    X, rel, gp = rank_data(N_ROWS, seed=30)
    sizes = np.diff(gp)
    log(f"[ranker] {N_ROWS} x {RANK_FEAT}, {len(sizes)} queries of "
        f"{sizes.min()}-{sizes.max()} rows (mean {sizes.mean():.1f}), "
        f"relevance counts {np.bincount(rel.astype(int)).tolist()}")
    one = train(X, rel, GBDTParams(objective="lambdarank", num_iterations=1,
                                   num_leaves=31), group_ptr=gp).booster
    checks = {}
    for case, ptr, scores in (
            ("tied", gp, np.zeros((N_ROWS, 1), np.float32)),
            ("after one tree", gp,
             one.raw_scores(X).astype(np.float32)),
            # up to 1,000 queries from a quarter in: the rows before and
            # after them lie outside every query
            ("uncovered rows", gp[len(gp) // 4:len(gp) // 4 + 1001],
             one.raw_scores(X).astype(np.float32))):
        got = []
        for d in (dev, torch.device("cpu")):
            fn = make_lambdarank_grad_fn(rel, ptr, 1.0, device=d)
            s = torch.from_numpy(scores).to(d)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if d.type == "cuda":
                torch.cuda.set_sync_debug_mode("error")
            try:
                g, h = fn(s)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            g, h = g.cpu().numpy(), h.cpu().numpy()
            got.append((g, h, time.perf_counter() - t0))
        (gc, hc, _), (gp_, hp, cpu_s) = got
        np.testing.assert_allclose(gc, gp_, rtol=1e-5, atol=1e-6,
                                   err_msg=f"lambdas, {case}")
        np.testing.assert_allclose(hc, hp, rtol=1e-5, atol=1e-6,
                                   err_msg=f"lambda hessians, {case}")
        err = float(max(np.abs(gc - gp_).max(), np.abs(hc - hp).max()))
        if case == "uncovered rows":
            outside = np.ones(N_ROWS, bool)
            outside[ptr[0]:ptr[-1]] = False
            if not ((gc[outside] == 0).all() and (hc[outside] == 1e-16)
                    .all()):
                raise AssertionError("rows outside the queries not inert")
        checks[case] = {"max_abs_err": err, "cpu_s": cpu_s}
        log(f"[ranker] lambdas card = CPU ({case}): max |diff| {err:.3g} "
            f"(rtol 1e-5, atol 1e-6; CPU pass {cpu_s:.2f} s), under sync "
            f"debug mode 'error'")

    fn = make_lambdarank_grad_fn(rel, gp, 1.0, device=dev)
    s = torch.zeros((N_ROWS, 1), device=dev)
    fn(s)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn(s)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    pass_ms = time_ms(lambda: fn(s), 5)
    gmax = int(sizes.max())
    chunk = fn.chunks[0][1] - fn.chunks[0][0]
    # the least time for the same work: the scores and labels read, g and
    # h written; ~27 f32 operations for each ordered pair of a query (the
    # score difference, exp and reciprocal, the pair mask, |ΔNDCG|, the two
    # weighted terms and their row and column sums)
    pairs = int((sizes.astype(np.int64) ** 2).sum())
    lam_bound, lam_by = bound_ms(N_ROWS * 4 * 4, pairs * 27)
    log(f"[ranker] lambda pass {pass_ms:.2f} ms (CUDA events, 5 calls), "
        f"peak {peak_gb:.3f} GB above its inputs; {len(sizes)} queries "
        f"padded to {gmax} in {len(fn.chunks)} chunks of up to {chunk} "
        f"queries; {pairs} pairs, "
        f"bound {lam_bound:.4f} ms ({lam_by})")
    n_chunks = len(fn.chunks)
    del fn, s
    tree_check = ranker_grower_check(dev, X, rel, gp)

    Xv, relv, gpv = rank_data(60_000, seed=31)       # ~440 queries
    gpv = gpv[:201]                                  # the first 200
    Xv, relv = Xv[:gpv[-1]], relv[:gpv[-1]]
    groups = np.repeat(np.arange(len(sizes)), sizes)
    df = DataFrame.from_dict({"features": X, "label": rel, "group": groups})
    torch.cuda.synchronize()
    CH.reset_launch_counts()
    t0 = time.perf_counter()
    model = LightGBMRanker().set_params(num_iterations=8).fit(df)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = CH.launch_counts()
    if launches != {"hist_accumulate": 248, "frontier_finish": 248}:
        raise AssertionError(f"the ranker fit must launch each kernel 8 x 31 "
                             f"= 248 times, got {launches}")
    pred = model.transform(DataFrame.from_dict(
        {"features": Xv})).collect()["prediction"]
    if pred.shape != (len(relv),) or not np.isfinite(pred).all():
        raise AssertionError(f"bad ranker scores {pred.shape}")
    ndcg = ndcg_at_k(pred, relv, gpv)
    ndcg_rand = ndcg_at_k(np.random.default_rng(0).normal(size=len(relv)),
                          relv, gpv)
    b = model.booster
    leaves_gpu = b.predict_leaf(Xv)
    if not np.array_equal(leaves_gpu, b.predict_leaf(Xv, device="cpu")):
        raise AssertionError("card and CPU ranker walks differ")
    log(f"[ranker] LightGBMRanker() fit {fit_s:.3f} s, launches {launches}; "
        f"NDCG@10 on 200 held-out queries {ndcg:.4f} (random ranking "
        f"{ndcg_rand:.4f}); card and CPU walks equal")
    if ndcg < 0.9 or not ndcg_rand < ndcg:
        raise AssertionError(f"NDCG@10 {ndcg} < 0.9 or random {ndcg_rand} "
                             f"not below it")
    DETAIL["ranker"] = {"queries": len(sizes), "gmax": gmax,
                        "lambda_checks": checks, "lambda_pass_ms": pass_ms,
                        "lambda_pairs": pairs, "lambda_bound_ms": lam_bound,
                        "lambda_peak_gb": peak_gb, "chunk_queries": chunk,
                        "chunks": n_chunks, "tree_check": tree_check,
                        "fit_s": fit_s, "fit_rows_per_s": N_ROWS / fit_s,
                        "launches": launches, "ndcg_at_10": ndcg,
                        "ndcg_at_10_random": ndcg_rand}
    t0 = time.perf_counter()
    fit_phases(GBDTParams(num_iterations=8, num_leaves=31,
                          objective="lambdarank"), "ranker", (X, rel),
               group_ptr=gp, profile_iterations=2)
    DETAIL["ranker"]["fit_phases_s"] = time.perf_counter() - t0
    return launches


# ---------------------------------------------------------------------------
# phase 10: out-of-core train_streamed, checkpoints and resume
# ---------------------------------------------------------------------------

BOOSTER_ARRAYS = ("split_feature", "threshold", "threshold_bin",
                  "split_gain", "internal_value", "internal_count",
                  "leaf_value", "leaf_count", "left_child", "right_child",
                  "tree_weight")


def booster_diff(a, b, what: str, exact=BOOSTER_ARRAYS, atol=0.0) -> bool:
    """Raise unless the ``exact`` arrays of two boosters are equal and the
    rest agree within ``atol``; returns whether every array is equal."""
    same = True
    for k in BOOSTER_ARRAYS:
        x, y = getattr(a, k), getattr(b, k)
        if k in exact:
            if not np.array_equal(x, y):
                raise AssertionError(f"{what}: {k} differs")
        else:
            np.testing.assert_allclose(x, y, rtol=0, atol=atol,
                                       err_msg=f"{what}: {k}")
            same &= bool(np.array_equal(x, y))
    return same


def staging_layouts(dev):
    """One full tile (131,072 x 200 uint8) host -> card in three layouts
    the driver could stage: strided feature-major slices of an (F, n)
    host matrix (the driver's), contiguous (F, T) blocks of a tile-major
    host matrix, and row-major slices of an (n, F) one, transposed on the
    card; and the kernel on each form (a row-major tile without the
    transpose is read at stride F).  The host copy into pinned memory by
    the host clock (median of 5 rounds of 10, the layouts in turns), the
    copy to the card and the card's work (the kernel's wrapper) by CUDA
    events."""
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    T, F, B = STREAM_TILE, N_FEAT, N_BINS
    rng = np.random.default_rng(3)
    n = 4 * T
    fm = rng.integers(0, B, size=(F, n), dtype=np.uint8)
    tiles = np.ascontiguousarray(fm.reshape(F, 4, T).transpose(1, 0, 2))
    rm = np.ascontiguousarray(fm.T)
    ids = torch.zeros(T, dtype=torch.int32, device=dev)
    qg = torch.ones(T, dtype=torch.int8, device=dev)
    qh = torch.ones(T, dtype=torch.int8, device=dev)
    lay = CH.lane_layout(T, T, QUANT_BINS)
    forms = {"feature_major": (fm[:, T:2 * T], (F, T)),
             "tile_major": (tiles[1], (F, T)),
             "row_major": (rm[T:2 * T], (T, F))}
    pinned = {k: torch.empty(shape, dtype=torch.uint8, pin_memory=True)
              for k, (_, shape) in forms.items()}
    rounds = {k: [] for k in forms}
    for _ in range(5):
        for k, (host, _) in forms.items():
            src = torch.from_numpy(host)
            pinned[k].copy_(src)
            t0 = time.perf_counter()
            for _ in range(10):
                pinned[k].copy_(src)
            rounds[k].append((time.perf_counter() - t0) / 10 * 1e3)
    out = {}
    for k in forms:
        buf = pinned[k]
        h2d_ms = time_ms(lambda: buf.to(dev, non_blocking=True), 10)
        on_card = buf.to(dev)
        rec = {"host_copy_ms": float(np.median(rounds[k])),
               "host_copy_ms_rounds": rounds[k], "h2d_ms": h2d_ms,
               "h2d_GB_per_s": T * F / h2d_ms / 1e6}
        if k == "row_major":
            rec["card_transpose_ms"] = time_ms(
                lambda: on_card.t().contiguous(), 10)
            rec["kernel_row_major_ms"] = time_ms(
                lambda: CH.hist_accumulate(on_card, qg, qh, ids, 1, B, lay),
                10)
            bins = on_card.t().contiguous().t()
        else:
            bins = on_card.t()
        rec["kernel_ms"] = time_ms(
            lambda: CH.hist_accumulate(bins, qg, qh, ids, 1, B, lay), 10)
        rec["total_ms"] = rec["host_copy_ms"] + h2d_ms + rec["kernel_ms"] \
            + rec.get("card_transpose_ms", 0.0)
        out[k] = rec
        log(f"[streamed] staging {k}: " + ", ".join(
            f"{key} {v:.4f}" for key, v in rec.items()
            if not isinstance(v, list)) + " (host copy rounds "
            + " ".join(f"{v:.3f}" for v in rounds[k]) + ")")
    del fm, rm, tiles
    DETAIL["streamed_staging"] = out
    return out


def streamed_card_equals_cpu(dev):
    """50k x 20 in tiles of 8,192 (7 tiles, the last padded): 3 quantized
    iterations level-wise (max_depth=4) and leaf-wise (num_leaves=15) by
    ``train_streamed`` on the card and on the CPU; every booster array
    equal."""
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train_streamed
    rng = np.random.default_rng(8)
    n, F = 50_000, 20
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] * X[:, 2] + rng.normal(scale=0.3, size=n)
         > 0).astype(np.float32)
    for name, kw in (("level", dict(max_depth=4)),
                     ("leaf", dict(num_leaves=15))):
        p = GBDTParams(num_iterations=3, objective="binary", seed=3,
                       use_quantized_grad=True, **kw)
        card = train_streamed(X, y, p, tile_rows=8192)
        cpu = train_streamed(X, y, p, tile_rows=8192, device="cpu")
        if card.extras["num_tiles"] != 7.0:
            raise AssertionError(f"{card.extras['num_tiles']} tiles, not 7")
        booster_diff(card.booster, cpu.booster,
                     f"streamed {name}-wise card vs CPU")
        log(f"[streamed] {name}-wise 50k x 20 in 7 tiles: card = CPU in "
            f"{len(BOOSTER_ARRAYS)}/{len(BOOSTER_ARRAYS)} booster arrays")


def streamed_fit(label, X, y, Xt, yt, params, tile_rows=STREAM_TILE,
                 **kw):
    """One streamed fit at the bench width with its launch counts (zeroed
    just before, read just after) and its peak device memory."""
    from mmlspark_tpu_torch.lightgbm import core as LC, train_streamed
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    # the graphs earlier fits captured hold their static inputs and
    # outputs, and idle fits' buffers wait for their next fit: dropped, so
    # the peak is this fit's (its own graphs are captured inside it)
    LC.release_programs()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    CH.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_streamed(X, y, params, tile_rows=tile_rows, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = CH.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    ex = res.extras
    prob = np.asarray(res.booster.predict(Xt)).reshape(len(yt), -1)[:, 0]
    if not np.isfinite(prob).all():
        raise AssertionError(f"streamed {label}: non-finite predictions")
    acc = float(((prob > 0.5) == (yt > 0)).mean())
    passes = ex["hist_passes"]
    rec = dict(ex, wall_s=wall, fit_rows_per_s=len(y) / wall,
               boosting_row_iterations_per_s=len(y) * res.booster.num_trees
               / ex["boosting_s"], accuracy=acc, launches=launches,
               peak_bytes=peak, base_bytes=base,
               h2d_GB_per_s=ex["h2d_bytes"] / max(ex["h2d_s"], 1e-9) / 1e9,
               trees=res.booster.num_trees)
    log(f"[streamed] {label}: {res.booster.num_trees} trees, "
        f"{ex['num_tiles']:.0f} tiles of {ex['tile_rows']:.0f}; binning_s "
        f"{ex['binning_s']:.3f}, boosting_s {ex['boosting_s']:.3f}, fit "
        f"{wall:.3f} s = {rec['fit_rows_per_s']:.0f} rows/s; "
        f"prefetch_wait_s {ex['prefetch_wait_s']:.4f}, tile_compute_s "
        f"{ex['tile_compute_s']:.4f}, prefetch_overlap_pct "
        f"{ex['prefetch_overlap_pct']:.2f}; {passes:.0f} histogram passes of "
        f"{ex['hist_pass_bytes'] / 1e6:.1f} MB host -> card, "
        f"{ex['h2d_bytes'] / 1e9:.3f} GB in all at "
        f"{rec['h2d_GB_per_s']:.2f} GB/s on the copy stream "
        f"({ex['h2d_s']:.3f} s); accuracy on 100k fresh rows {acc:.4f}; "
        f"launches {launches}; peak device memory {peak / 1e6:.1f} MB "
        f"({base / 1e6:.1f} MB before the fit)")
    if acc < 0.9:
        raise AssertionError(f"streamed {label}: accuracy {acc} < 0.9")
    for name, count in launches.items():
        if count != passes * ex["num_tiles"]:
            raise AssertionError(f"streamed {label}: {count} launches of "
                                 f"{name}, not one per tile per pass")
    return res, rec


def streamed_phase(dev):
    import tempfile
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train, \
        train_streamed
    from mmlspark_tpu_torch.lightgbm.binning import BinMapper
    from mmlspark_tpu_torch.utils.resilience import request_preemption

    staging_layouts(dev)
    streamed_card_equals_cpu(dev)
    X, y = bench_data(N_ROWS, seed=0)
    Xt, yt = bench_data(100_000, seed=1)
    # 6 iterations (8 through PR 20; the gbdt_graphs phase holds the
    # streamed path replayed against eager since PR 21)
    level = GBDTParams(num_iterations=STREAM_ITERS, max_depth=5,
                       objective="binary")
    leaf = GBDTParams(num_iterations=STREAM_ITERS, num_leaves=31,
                      objective="binary")
    r_level, rec_level = streamed_fit("level-wise", X, y, Xt, yt, level)
    if rec_level["launches"]["hist_accumulate"] != 5 * 8 * STREAM_ITERS:
        raise AssertionError(f"level-wise: not 5 x 8 tiles x "
                             f"{STREAM_ITERS} iterations")
    r_leaf, rec_leaf = streamed_fit("leaf-wise", X, y, Xt, yt, leaf)
    T = STREAM_TILE
    tile_bytes = rec_leaf["hist_pass_bytes"] / rec_leaf["num_tiles"]
    acc_bytes = {"level_N16": 16 * N_FEAT * N_BINS * 3 * 4,
                 "leaf_N1": N_FEAT * N_BINS * 3 * 4}
    log(f"[streamed] leaf-wise peak {rec_leaf['peak_bytes'] / 1e6:.1f} MB "
        f"against two live tiles of {2 * tile_bytes / 1e6:.1f} MB "
        f"({tile_bytes / 1e6:.1f} MB each: {T * N_FEAT / 1e6:.1f} MB bins, "
        f"{T / 1e6:.2f} MB each of int8 grad and hess, {T * 4 / 1e6:.2f} "
        f"MB of int32 node ids) and an "
        f"accumulator of {acc_bytes['leaf_N1'] / 1e6:.2f} MB (level-wise "
        f"N = 16: {acc_bytes['level_N16'] / 1e6:.2f} MB); the full binned "
        f"matrix is {N_ROWS * N_FEAT / 1e6:.0f} MB")
    if rec_leaf["peak_bytes"] >= 150e6:
        raise AssertionError(f"leaf-wise peak {rec_leaf['peak_bytes']} B "
                             f">= 150 MB")

    # above the sketch's cap the edges follow the tile width, as the
    # reference's do: at 262,144 rows a tile they are the host sketch's
    # fed those tiles; the booster is printed as differing or not
    t0 = time.perf_counter()
    wide, rec_wide = streamed_fit("level-wise at 262,144 rows a tile", X, y,
                                  Xt, yt, level, tile_rows=2 * T)
    if rec_wide["launches"]["hist_accumulate"] != 5 * 4 * STREAM_ITERS:
        raise AssertionError(f"level-wise at 262,144: not 5 x 4 tiles x "
                             f"{STREAM_ITERS} iterations")
    host = BinMapper(N_BINS).fit_streaming(
        X[lo:lo + 2 * T] for lo in range(0, N_ROWS, 2 * T))
    if not np.array_equal(wide.bin_mapper.edges, host.edges):
        raise AssertionError("level-wise at 262,144: edges differ from the "
                             "host sketch fed the same tiles")
    same = all(np.array_equal(getattr(r_level.booster, k),
                              getattr(wide.booster, k))
               for k in BOOSTER_ARRAYS)
    log(f"[streamed] level-wise at 262,144 rows a tile "
        f"({wide.extras['num_tiles']:.0f} tiles): edges = the host sketch "
        f"fed those tiles; {5 * 4 * STREAM_ITERS} launches; booster "
        f"{'bit-identical to' if same else 'differs from'} 131,072's "
        f"(above the sketch's cap the edges follow the width) "
        f"({time.perf_counter() - t0:.1f} s)")

    def preempt_at(k):
        def cb(it, ev):
            if it == k:
                request_preemption("chip_smoke")
        return cb

    def preempt_resume(label, Xs, ys, ref, params, t_first, t_resume, d):
        t0 = time.perf_counter()
        r1 = train_streamed(Xs, ys, params, tile_rows=t_first,
                            checkpoint_dir=d, checkpoint_every=1,
                            callbacks=[preempt_at(3)])
        r2 = train_streamed(Xs, ys, params, tile_rows=t_resume,
                            checkpoint_dir=d, checkpoint_every=1)
        ex1, ex2 = r1.extras, r2.extras
        if not (ex1["preempted"] == 1.0 and r1.booster.num_trees == 4
                and ex2["resharded"] == float(t_first != t_resume)
                and ex2["resumed_from_iteration"] == 4.0):
            raise AssertionError(f"streamed preempt/resume {label}: {ex1} "
                                 f"{ex2}")
        booster_diff(ref.booster, r2.booster, label)
        log(f"[streamed] {label}: resumed_from_iteration 4, resharded "
            f"{ex2['resharded']:.0f}, booster bit-identical to the "
            f"uninterrupted fit ({time.perf_counter() - t0:.1f} s)")

    with tempfile.TemporaryDirectory() as d:
        # leaf-wise at 1M rows (above the cap), preempted after iteration 3
        # and resumed at the same width
        preempt_resume("leaf-wise preempted at 3, resumed at 131,072",
                       X, y, r_leaf, leaf, T, T, d + "/s")
        # below the cap a resume may re-tile: the bench data's first
        # 196,608 rows at 32,768 rows a tile, resumed at 65,536
        n_small = 196_608
        Xs, ys = X[:n_small], y[:n_small]
        small = train_streamed(Xs, ys, leaf, tile_rows=32_768)
        preempt_resume("leaf-wise 196,608 rows preempted at 3 in tiles of "
                       "32,768, resumed at 65,536", Xs, ys, small, leaf,
                       32_768, 65_536, d + "/r")

        # train() on the card: leaf-wise, checkpoint_every=2, preempted
        # after iteration 3 and resumed
        t0 = time.perf_counter()
        full = train(X, y, leaf)
        prob = np.asarray(full.booster.predict(Xt)).reshape(len(yt), -1)
        mem_acc = float(((prob[:, 0] > 0.5) == (yt > 0)).mean())
        log(f"[streamed] accuracy on 100k fresh rows, streamed beside in "
            f"memory: leaf-wise {rec_leaf['accuracy']:.4f} beside train() "
            f"{mem_acc:.4f}; level-wise {rec_level['accuracy']:.4f} beside "
            f"the slice phase's estimator "
            f"{DETAIL.get('slice', {}).get('accuracy', float('nan')):.4f}")
        t1 = train(X, y, leaf, checkpoint_dir=d + "/t", checkpoint_every=2,
                   callbacks=[preempt_at(3)])
        t2 = train(X, y, leaf, checkpoint_dir=d + "/t", checkpoint_every=2)
        if not (t1.extras["preempted"] == 1.0
                and t2.extras["resumed_from_iteration"] == 4.0
                and t2.booster.num_trees == STREAM_ITERS):
            raise AssertionError(f"train() preempt/resume: {t1.extras} "
                                 f"{t2.extras}")
        bitwise = booster_diff(
            full.booster, t2.booster, "train() preempted and resumed",
            exact=("split_feature", "threshold_bin", "left_child",
                   "right_child", "leaf_count"), atol=1e-6)
        log(f"[streamed] train() leaf-wise preempted after iteration 3 and "
            f"resumed: tree structure equal, leaf values within 1e-6, "
            f"bitwise equal: {bitwise} ({time.perf_counter() - t0:.1f} s)")
    DETAIL["streamed"] = {"level": rec_level, "leaf": rec_leaf,
                          "level_262144": rec_wide,
                          "level_262144_booster_equal": same,
                          "accumulator_bytes": acc_bytes,
                          "in_memory_leaf_accuracy": mem_acc,
                          "train_resume_bitwise": bitwise}
    return {"level": rec_level["launches"], "leaf": rec_leaf["launches"]}


# ---------------------------------------------------------------------------
# phase 11: deep-learning scoring (ResNet family, JaxModel, ImageFeaturizer,
# the model repo, ONNX import)
# ---------------------------------------------------------------------------

#: dense peaks of one H100 SXM (data sheet) for the dtypes the backbone runs
#: in: bfloat16 on the tensor cores, float32 with TF32 off on the CUDA cores
DNN_PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
#: card vs CPU in float32 (TF32 off on the card): max |diff| over the
#: outputs' max |value|.  cuDNN picks other algorithms, and so other
#: summation orders, than the CPU; float32 rounds ~1e-7 per layer, and the
#: differences measured on narrow nets are ~1e-6 relative
F32_REL_TOL = 1e-4
#: bfloat16 against float32 on the card, same measure: bfloat16 keeps 8
#: significant bits and rounds every layer's output (0.4% measured on the
#: seeded ResNet-50 on the CPU).  It must also lie above BF16_REL_FLOOR:
#: a bfloat16 path that computed in float32 would agree within
#: F32_REL_TOL
BF16_REL_TOL = 2e-2
BF16_REL_FLOOR = 10 * F32_REL_TOL
#: the backbone's input side, batch, and timed calls per dtype
DNN_HW = 224
DNN_BATCH = 256
DNN_REPS = {"float32": 4, "bfloat16": 10}
#: the featurizer's images: CIFAR-10's test-set size
FEATURIZER_IMAGES = 10_000


def rel_err(a, b) -> float:
    a = a.detach().float().cpu() if isinstance(a, torch.Tensor) else \
        torch.as_tensor(a).float()
    b = b.detach().float().cpu() if isinstance(b, torch.Tensor) else \
        torch.as_tensor(b).float()
    return float((a - b).abs().max() / b.abs().max())


def seeded_resnet50(gen: torch.Generator):
    """ResNet-50 at full width (224 x 224 x 3 in, 1000 classes, 2048-d
    features) with every weight and BN statistic drawn from ``gen``:
    flax's initializers for the kernels, BN scales in [0.7, 1.1] ([0.2, 0.5]
    for the last BN of each block, so the residual branch is live but
    damped), biases and means N(0, 0.1^2), variances in [0.5, 1.5]."""
    from mmlspark_tpu_torch.models import resnet
    model = resnet.resnet50(generator=gen)

    def bn(m, lo, hi):
        c = m.weight.numel()
        m.weight.copy_(torch.empty(c).uniform_(lo, hi, generator=gen))
        m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
        m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
        m.running_var.copy_(torch.empty(c).uniform_(0.5, 1.5, generator=gen))

    with torch.no_grad():
        bn(model.bn_init, 0.7, 1.1)
        for block in model.blocks:
            for m in block.norms[:-1]:
                bn(m, 0.7, 1.1)
            bn(block.norms[-1], 0.2, 0.5)
            if block.proj:
                bn(block.norm_proj, 0.7, 1.1)
        model.head.bias.copy_(torch.randn(1000, generator=gen) * 0.1)
    return model


def conv_flops(model, hw: int) -> float:
    """FLOPs of one image through ``model(x, features=True)``, counted from
    the layer shapes as 2 x multiply-adds of every convolution (BN, ReLU,
    pooling and the residual adds are left out: < 0.5%)."""
    from mmlspark_tpu_torch.models import resnet
    total = []

    def hook(m, inp, out):
        o, i, kh, kw = m.weight.shape
        total.append(2.0 * out.shape[2] * out.shape[3] * o * i * kh * kw)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, resnet.Conv)]
    with torch.inference_mode():
        model(torch.zeros(1, hw, hw, 3, device=model.head.weight.device),
              features=True)
    for h in handles:
        h.remove()
    return sum(total)


def dnn_checkpoint(dev, repo: str):
    """The committed ShapesResNet20 through the port's repo and JaxModel on
    the card: the trainer's holdout (``tools/train_backbone.py``:
    ``make_shapes(8000, seed=1)``, scored raw), accuracy within 0.002 of
    ``eval.json``; the card's logits = the CPU port's on the first 512."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.dl import JaxModel, ModelDownloader
    from mmlspark_tpu_torch.dl.procedural_shapes import make_shapes
    with open(os.path.join(repo, "ShapesResNet20", "eval.json")) as f:
        pinned = json.load(f)["shapes_holdout_acc"]
    t0 = time.perf_counter()
    X, y = make_shapes(8000, seed=1)
    data_s = time.perf_counter() - t0
    payload = ModelDownloader(local_cache=repo).download_by_name(
        "ShapesResNet20")
    jm = JaxModel(input_col="image", output_col="logits", batch_size=256,
                  input_shape=[32, 32, 3])
    jm.set("model", payload)
    if jm.runner().device.type != "cuda" or any(
            p.device.type != "cuda" for p in jm.runner().module.parameters()):
        raise AssertionError("ShapesResNet20 is not on the card")
    t0 = time.perf_counter()
    out = jm.transform(DataFrame.from_dict({"image": X})).collect()["logits"]
    score_s = time.perf_counter() - t0
    logits = np.stack(list(out))
    if logits.shape != (8000, 10) or not np.isfinite(logits).all():
        raise AssertionError(f"ShapesResNet20 logits {logits.shape}")
    acc = float((logits.argmax(1) == y).mean())
    cpu = ModelDownloader(local_cache=repo).download_by_name(
        "ShapesResNet20", device="cpu")
    with torch.inference_mode():
        ref = cpu.module(torch.from_numpy(X[:512])).numpy()
    err = rel_err(logits[:512], ref)
    rec = {"accuracy": acc, "pinned": pinned, "card_vs_cpu_rel": err,
           "max_abs_logit": float(np.abs(ref).max()),
           "make_shapes_s": data_s, "transform_s": score_s,
           "bucket_calls": dict(jm.runner().bucket_calls)}
    if abs(acc - pinned) > 0.002:
        raise AssertionError(f"ShapesResNet20 accuracy {acc} vs {pinned}")
    if err > F32_REL_TOL:
        raise AssertionError(f"ShapesResNet20 card vs CPU: {err}")
    return rec


def dnn_backbone(dev):
    """ResNet-50 at full width: features of 8 images card = CPU (float32,
    TF32 off) and bfloat16 = float32 on the card; backbone images/s at
    batch 256 for both dtypes (CUDA events around warm back-to-back calls
    of normalize + ``features=True``, as ``bench.py``'s ``phase_resnet``),
    FLOPs per image, the share of the dtype's dense peak, peak memory."""
    from mmlspark_tpu_torch.models import resnet
    from mmlspark_tpu_torch.ops import image
    gen = torch.Generator().manual_seed(50)
    cpu32 = seeded_resnet50(gen)
    width = cpu32.head.in_features
    models = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        m = resnet.ResNet.from_config({**cpu32.config(),
                                       "dtype": str(dtype)[6:]})
        m.load_state_dict(cpu32.state_dict())
        models[name] = m.to(dev)
    imgs = torch.rand(8, DNN_HW, DNN_HW, 3, generator=torch.Generator(
        ).manual_seed(51)) * 255
    with torch.inference_mode():
        ref = cpu32(image.normalize(imgs), features=True)
        x8 = image.normalize(imgs.to(dev))
        f32 = models["float32"](x8, features=True)
        f16 = models["bfloat16"](x8, features=True)
    if f32.shape != (8, width) or not torch.isfinite(f32).all() \
            or not torch.isfinite(f16).all():
        raise AssertionError(f"ResNet-50 features {tuple(f32.shape)}")
    rec = {"features_f32_card_vs_cpu_rel": rel_err(f32, ref),
           "features_bf16_vs_f32_card_rel": rel_err(f16, f32),
           "max_abs_feature": float(ref.abs().max())}
    if rec["features_f32_card_vs_cpu_rel"] > F32_REL_TOL:
        raise AssertionError(f"ResNet-50 card vs CPU: {rec}")
    if not BF16_REL_FLOOR < rec["features_bf16_vs_f32_card_rel"] \
            <= BF16_REL_TOL:
        raise AssertionError(f"ResNet-50 bfloat16 vs float32: {rec}")
    flops = conv_flops(models["float32"], DNN_HW)
    x = torch.rand(DNN_BATCH, DNN_HW, DNN_HW, 3, device=dev,
                   generator=torch.Generator(dev).manual_seed(52)) * 255
    for name, m in models.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.inference_mode():
            ms = time_ms(lambda: m(image.normalize(x), features=True),
                         DNN_REPS[name])
        ips = DNN_BATCH / ms * 1e3
        rec[name] = {"ms_per_batch": ms, "batch": DNN_BATCH,
                     "images_per_s": ips,
                     "tflops": flops * ips / 1e12,
                     "peak_share": flops * ips / DNN_PEAK_FLOPS[name],
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "base_bytes": base}
    rec["gflop_per_image"] = flops / 1e9
    rec["bfloat16"]["profile"] = backbone_profile(models["bfloat16"], x)
    return models, rec


def backbone_profile(model, x, calls: int = 3):
    """Where a backbone call's device time goes: ``torch.profiler`` over
    ``calls`` warm calls; the device time per call, the busy share of the
    window's wall and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    from mmlspark_tpu_torch.ops import image
    with torch.inference_mode():
        model(image.normalize(x), features=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                model(image.normalize(x), features=True)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"device_ms_per_call": total / calls,
            "busy_share": total / 1e3 / wall,
            "top": [{"name": e.key[:90], "calls": e.count // calls,
                     "ms_per_call": e.self_device_time_total / 1e3 / calls}
                    for e in kernels[:10]]}


def dnn_featurizer(dev, model_bf16):
    """The BASELINE config's shape end to end: 10,000 seeded 32 x 32 x 3
    uint8 images (CIFAR-10's test-set size and shape) through
    ``ImageFeaturizer`` with the bfloat16 ResNet-50 (224 x 224, batch
    256): resize and normalize on the card, 2048-d features.  Wall
    images/s of ``transform`` and its split (host stacking, host -> card,
    device, card -> host); the first 4 images' features equal the
    backbone's on the same resized input."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.dl import FlaxModelPayload, ImageFeaturizer
    from mmlspark_tpu_torch.ops import image
    rng = np.random.default_rng(53)
    X = rng.integers(0, 256, (FEATURIZER_IMAGES, 32, 32, 3), dtype=np.uint8)
    feat = ImageFeaturizer(input_col="image", output_col="features",
                           height=DNN_HW, width=DNN_HW, batch_size=DNN_BATCH)
    feat.set_model(payload=FlaxModelPayload(module=model_bf16))
    warm = DataFrame.from_dict({"image": X[:DNN_BATCH]})
    feat.transform(warm).collect()
    runner = feat._build_runner().runner()
    if runner.device.type != "cuda" or any(
            p.device.type != "cuda" for p in runner.module.parameters()):
        raise AssertionError("the featurizer does not run on the card")
    before = dict(runner.phase_s)
    df = DataFrame.from_dict({"image": X})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = feat.transform(df).collect()["features"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = np.stack(list(out[:4]))
    split = {k: runner.phase_s[k] - before[k] for k in before}
    with torch.inference_mode():
        first = torch.from_numpy(X[:DNN_BATCH].astype(np.float32)).to(dev)
        direct = model_bf16(image.normalize(image.resize(first, DNN_HW,
                                                         DNN_HW)),
                            features=True)[:4]
    err = rel_err(got, direct)
    rec = {"images": len(out), "wall_s": wall,
           "images_per_s": len(out) / wall, "split_s": split,
           "features_vs_backbone_rel": err,
           "bucket_calls": dict(runner.bucket_calls)}
    if len(out) != FEATURIZER_IMAGES or out[0].shape != (model_bf16.head.in_features,) or \
            not np.isfinite(got).all():
        raise AssertionError(f"featurizer output {len(out)} x "
                             f"{out[0].shape}")
    if err > 1e-3:
        raise AssertionError(f"featurizer vs backbone: {err}")
    return rec


def dnn_onnx(dev, repo: str):
    """The committed ONNX DigitsMLP through the port's repo: logits on 256
    seeded inputs card = CPU (its pinned accuracy needs sklearn's digits,
    which the tier-1 tests hold)."""
    from mmlspark_tpu_torch.dl import ModelDownloader
    x = np.random.default_rng(54).uniform(0, 1, (256, 64)).astype(np.float32)
    card, cpu = (ModelDownloader(local_cache=repo).download_by_name(
        "DigitsMLP", device=d).apply(x) for d in (None, "cpu"))
    if card.device.type != "cuda" or card.shape != (256, 10):
        raise AssertionError(f"DigitsMLP on {card.device}, {card.shape}")
    err = rel_err(card, cpu)
    if err > F32_REL_TOL:
        raise AssertionError(f"DigitsMLP card vs CPU: {err}")
    return {"card_vs_cpu_rel": err}


def dnn_phase(dev):
    repo = os.path.join(ROOT, "artifacts", "model_repo")
    t0 = time.perf_counter()
    ckpt = dnn_checkpoint(dev, repo)
    t_ckpt = time.perf_counter() - t0
    models, backbone = dnn_backbone(dev)
    del models["float32"]
    t_backbone = time.perf_counter() - t0 - t_ckpt
    feat = dnn_featurizer(dev, models["bfloat16"])
    onnx = dnn_onnx(dev, repo)
    DETAIL["dnn"] = {"shapes_resnet20": ckpt, "resnet50": backbone,
                     "featurizer": feat, "digits_mlp": onnx,
                     "seconds": {"checkpoint": t_ckpt,
                                 "backbone": t_backbone,
                                 "total": time.perf_counter() - t0}}
    b16, b32 = backbone["bfloat16"], backbone["float32"]
    sp = feat["split_s"]
    log(f"[dnn] ShapesResNet20 accuracy {ckpt['accuracy']:.4f} (pinned "
        f"{ckpt['pinned']}), card vs CPU {ckpt['card_vs_cpu_rel']:.2e}; "
        f"ResNet-50 features card vs CPU {backbone['features_f32_card_vs_cpu_rel']:.2e}"
        f" (f32), bf16 vs f32 {backbone['features_bf16_vs_f32_card_rel']:.2e}; "
        f"backbone at batch 256, {backbone['gflop_per_image']:.3f} GFLOP/image: "
        f"f32 {b32['images_per_s']:.1f} img/s ({100 * b32['peak_share']:.1f}% "
        f"of 67 TFLOP/s, peak {b32['peak_bytes'] / 1e9:.2f} GB), bf16 "
        f"{b16['images_per_s']:.1f} img/s ({100 * b16['peak_share']:.1f}% of "
        f"989 TFLOP/s, peak {b16['peak_bytes'] / 1e9:.2f} GB); featurizer "
        f"10,000 x 32x32 -> 224, bf16: {feat['images_per_s']:.1f} img/s "
        f"(wall {feat['wall_s']:.3f} s: stack {sp['stack']:.3f}, h2d "
        f"{sp['h2d']:.3f}, device {sp['device']:.3f}, d2h {sp['d2h']:.3f}), "
        f"vs backbone {feat['features_vs_backbone_rel']:.1e}; DigitsMLP "
        f"card vs CPU {onnx['card_vs_cpu_rel']:.1e}")


# --------------------------------------------------------------------- seq
#: bench.py's decode LM (``phase_runner``, ``bench.py:449-452``)
SEQ_LM = dict(vocab_size=512, num_classes=512, embed_dim=256, num_heads=4,
              num_layers=4, mlp_dim=512, max_len=4096, causal=True,
              pool="none")
#: the reference's committed decode tolerance (tests/test_paged_decode.py)
DECODE_ATOL = 1e-4
SEQ_PAGE_SIZES = (64, 16)
ENCODER_BATCH, ENCODER_LEN = 8, 4096
BILSTM_POINTS = ((16_384, 24), (1_024, 512))   # (sequences, tokens)
BILSTM_BATCH = 256


def _column(rows):
    col = np.empty(len(rows), dtype=object)
    for i, r in enumerate(rows):
        col[i] = r
    return col


def timed_decode(runner, prompts, **kw):
    """One decode on the card: CUDA events around the call (the device
    timeline, host gaps included) and the host clock; tokens/s counts the
    real (unfrozen) tokens; peak memory above what was held before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    res = runner.decode(prompts, **kw)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ev_s = start.elapsed_time(end) / 1e3
    ex = res.extras
    rec = {"tokens_per_s_events": ex["real_tokens"] / ev_s,
           "tokens_per_s_wall": ex["real_tokens"] / wall,
           "events_s": ev_s, "wall_s": wall, "steps": res.steps,
           "real_tokens": ex["real_tokens"],
           "cache_bytes_per_seq": ex["cache_bytes_per_seq"],
           "peak_bytes": torch.cuda.max_memory_allocated() - base,
           "dispatch_s": ex["dispatch_s"], "device_s": ex["device_s"]}
    if ex["kv_layout"] == "paged":
        rec.update(pages_peak=ex["pages_peak"],
                   pages_prefill=ex["pages_prefill"],
                   table_width=ex["table_width"])
    return res, rec


def decode_profile(runner, prompts, **kw):
    """Where one decode's time goes: ``torch.profiler`` over a warm call;
    the device time and its busy share of the call's wall, kernel and
    CUDA-graph launches per forward, the host's enqueue per step (the
    decode's own ``dispatch_s``: the call of each step's program) and the
    top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = runner.decode(prompts, **kw)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    graphs = sum(e.count for e in events if e.key == "cudaGraphLaunch")
    forwards = res.steps + 1
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "busy_share": device_ms / 1e3 / wall,
            "launches_per_forward": launches / forwards,
            "graph_launches_per_forward": graphs / forwards,
            "host_enqueue_ms_per_step": res.extras["dispatch_s"] * 1e3
            / max(res.steps, 1),
            "device_ms_per_step": device_ms / forwards,
            "wall_ms_per_step": wall * 1e3 / forwards,
            "top": [{"name": e.key[:80], "calls": e.count,
                     "ms": e.self_device_time_total / 1e3}
                    for e in kernels[:8]]}


def decode_card_vs_cpu(card, cpu, what: str):
    """Tokens equal, except from a step where the CPU's top-two logits lie
    within DECODE_ATOL (a near-tie, reported); logits within DECODE_ATOL
    up to and including each row's first divergent step."""
    near_ties, max_err = [], 0.0
    for b in range(card.tokens.shape[0]):
        bad = np.nonzero(card.tokens[b] != cpu.tokens[b])[0]
        stop = card.tokens.shape[1] if len(bad) == 0 else int(bad[0]) + 1
        err = float(np.abs(card.logits[b, :stop]
                           - cpu.logits[b, :stop]).max())
        max_err = max(max_err, err)
        if err > DECODE_ATOL:
            raise AssertionError(f"{what}: row {b} logits card vs CPU {err}")
        if len(bad):
            t = int(bad[0])
            top2 = np.sort(cpu.logits[b, t])[-2:]
            gap = float(top2[1] - top2[0])
            if gap > DECODE_ATOL:
                raise AssertionError(f"{what}: row {b} step {t} tokens "
                                     f"differ, CPU top-two gap {gap}")
            near_ties.append({"row": b, "step": t, "gap": gap})
    return {"max_abs_logit_err": max_err, "near_ties": near_ties}


def seq_decode_point(dev, lm, name, prompts, lengths, new_tokens,
                     eos_id=None):
    """One decode point in both layouts: dense and paged at each page size
    give the same greedy tokens, bit for bit; their collected logits agree
    within DECODE_ATOL; the card's agree with the CPU's; every paged page is
    back in its pool at the end."""
    from mmlspark_tpu_torch.models import ModelRunner
    runner = ModelRunner(module=lm, name=f"seq.{name}",
                         batch_size=len(prompts))
    if runner.device.type != "cuda":
        raise AssertionError("the decode runner is not on the card")
    kw = dict(lengths=lengths, max_new_tokens=new_tokens, eos_id=eos_id)
    layouts = {"dense": {}}
    layouts.update({f"paged{ps}": {"kv_layout": "paged", "page_size": ps}
                    for ps in SEQ_PAGE_SIZES})
    rec = {"batch": len(prompts), "prompt_lens": [int(lengths.min()),
                                                  int(lengths.max())],
           "new_tokens": new_tokens, "eos_id": eos_id}
    greedy = {}
    for lay, lkw in layouts.items():
        runner.decode(prompts, **kw, **lkw)                     # warm
        greedy[lay], rec[lay] = timed_decode(runner, prompts, **kw, **lkw)
        if lay != "dense" and not np.array_equal(greedy[lay].tokens,
                                                 greedy["dense"].tokens):
            raise AssertionError(f"{name}: {lay} greedy tokens differ from "
                                 "dense")
        if lay != "dense" and greedy[lay].steps != greedy["dense"].steps:
            raise AssertionError(f"{name}: {lay} steps differ")
    logits = {lay: runner.decode(prompts, collect_logits=True, **kw, **lkw)
              for lay, lkw in layouts.items()}
    for lay, res in logits.items():
        if not np.array_equal(res.tokens, logits["dense"].tokens):
            raise AssertionError(f"{name}: {lay} collect_logits tokens")
        err = float(np.abs(res.logits - logits["dense"].logits).max())
        rec[lay]["logits_vs_dense"] = err
        if err > DECODE_ATOL:
            raise AssertionError(f"{name}: {lay} logits vs dense {err}")
    if not np.array_equal(logits["dense"].tokens, greedy["dense"].tokens):
        raise AssertionError(f"{name}: fused and host-argmax tokens differ")
    for lay in ("dense", f"paged{SEQ_PAGE_SIZES[-1]}"):
        rec[lay]["profile"] = decode_profile(runner, prompts, **kw,
                                             **layouts[lay])
    for ps in SEQ_PAGE_SIZES:
        pool = runner.page_pool(ps)
        if pool.pages_in_use():
            raise AssertionError(f"{name}: {pool.pages_in_use()} pages of "
                                 f"size {ps} still held")
    cpu = ModelRunner(module=lm, name=f"seq.{name}.cpu", device="cpu")
    t0 = time.perf_counter()
    ref = cpu.decode(prompts, collect_logits=True, **kw)
    rec["cpu_s"] = time.perf_counter() - t0
    rec["card_vs_cpu"] = decode_card_vs_cpu(logits["dense"], ref, name)
    rec["finished_rows"] = int((greedy["dense"].tokens == eos_id).any(1).sum()
                               ) if eos_id is not None else 0
    return rec


def seq_decode(dev):
    """(a) decode at bench.py's LM (seeded weights, float32): bench.py's
    arm (8 x 16 prompts, 32 new tokens) and a batch of 64 ragged 16-128
    token prompts, 128 new tokens, with ``eos_id`` the token the model
    emits most often there (so some rows finish and free their pages)."""
    from mmlspark_tpu_torch.models import TransformerEncoder
    lm = TransformerEncoder(**SEQ_LM,
                            generator=torch.Generator().manual_seed(60))
    rng = np.random.default_rng(61)
    out = {}
    prompts = rng.integers(0, 512, (8, 16)).astype(np.int32)
    out["bench"] = seq_decode_point(dev, lm, "bench", prompts,
                                    np.full(8, 16, np.int32), 32)
    lengths = rng.integers(16, 129, 64).astype(np.int32)
    prompts = rng.integers(0, 512, (64, int(lengths.max()))).astype(np.int32)
    from mmlspark_tpu_torch.models import ModelRunner
    probe = ModelRunner(module=lm, name="seq.probe").decode(
        prompts, lengths=lengths, max_new_tokens=128)
    eos = int(np.bincount(probe.tokens.ravel()).argmax())
    out["large"] = seq_decode_point(dev, lm, "large", prompts, lengths, 128,
                                    eos_id=eos)
    return out


def seq_encoder(dev):
    """(b) ``TransformerEncoder`` at its defaults (vocab 512) scoring 8 x
    4,096 tokens through ``JaxModel``, dense, blockwise and ring: the three
    agree, and the card agrees with the CPU on 2 sequences."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.dl import JaxModel
    from mmlspark_tpu_torch.models import TransformerEncoder
    cpu = TransformerEncoder(512, generator=torch.Generator().manual_seed(62))
    x = np.random.default_rng(63).integers(
        0, 512, (ENCODER_BATCH, ENCODER_LEN)).astype(np.int32)
    df = DataFrame.from_dict({"tokens": _column(x)})
    rec, outs = {}, {}
    for mode in ("dense", "blockwise", "ring"):
        model = TransformerEncoder.from_config({**cpu.config(),
                                                "attention_mode": mode})
        model.load_state_dict(cpu.state_dict())
        jm = JaxModel(input_col="tokens", output_col="logits",
                      batch_size=ENCODER_BATCH, input_dtype="int32")
        jm.set_model(module=model)
        jm.transform(df).collect()                              # warm
        if jm.runner().device.type != "cuda":
            raise AssertionError("the encoder is not on the card")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = jm.transform(df).collect()["logits"]
        wall = time.perf_counter() - t0
        outs[mode] = np.stack(list(out))
        rec[mode] = {"sequences_per_s": ENCODER_BATCH / wall, "wall_s": wall,
                     "peak_bytes": torch.cuda.max_memory_allocated() - base}
        del jm, model
    if outs["dense"].shape != (ENCODER_BATCH, 2) or \
            not np.isfinite(outs["dense"]).all():
        raise AssertionError(f"encoder output {outs['dense'].shape}")
    for mode in ("blockwise", "ring"):
        rec[mode]["vs_dense_rel"] = rel_err(outs[mode], outs["dense"])
        if rec[mode]["vs_dense_rel"] > F32_REL_TOL:
            raise AssertionError(f"encoder {mode} vs dense: {rec[mode]}")
    with torch.inference_mode():
        ref = cpu(torch.from_numpy(x[:2]))
    rec["card_vs_cpu_rel"] = rel_err(outs["dense"][:2], ref)
    rec["max_abs_logit"] = float(ref.abs().max())
    if rec["card_vs_cpu_rel"] > F32_REL_TOL:
        raise AssertionError(f"encoder card vs CPU: {rec['card_vs_cpu_rel']}")
    return rec


def seq_bilstm(dev):
    """(c) BASELINE config 5: ``BiLSTMTagger`` at its defaults with the
    example's vocabulary (200) and tags (3) through ``JaxModel`` at batch
    256: 16,384 sequences of the example's 24 tokens, then 1,024 of 512;
    tokens/s per length; the card's logits equal the CPU's on the first 256
    sequences of each."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.dl import JaxModel
    from mmlspark_tpu_torch.models import BiLSTMTagger
    cpu = BiLSTMTagger(200, 3, generator=torch.Generator().manual_seed(64))
    card = BiLSTMTagger.from_config(cpu.config())
    card.load_state_dict(cpu.state_dict())
    jm = JaxModel(input_col="tokens", output_col="tags",
                  batch_size=BILSTM_BATCH, input_dtype="int32")
    jm.set_model(module=card)
    rec = {}
    rng = np.random.default_rng(65)
    for n, L in BILSTM_POINTS:
        x = rng.integers(0, 200, (n, L)).astype(np.int32)
        df = DataFrame.from_dict({"tokens": _column(x)})
        jm.transform(DataFrame.from_dict(
            {"tokens": _column(x[:BILSTM_BATCH])})).collect()   # warm
        if jm.runner().device.type != "cuda":
            raise AssertionError("the tagger is not on the card")
        runner = jm.runner()
        before = dict(runner.phase_s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = jm.transform(df).collect()["tags"]
        wall = time.perf_counter() - t0
        got = np.stack(list(out[:BILSTM_BATCH]))
        with torch.inference_mode():
            ref = cpu(torch.from_numpy(x[:BILSTM_BATCH]))
        err = rel_err(got, ref)
        rec[f"{n}x{L}"] = {
            "tokens_per_s": n * L / wall, "wall_s": wall,
            "split_s": {k: runner.phase_s[k] - before[k] for k in before},
            "card_vs_cpu_rel": err}
        if len(out) != n or out[0].shape != (L, 3) or \
                not np.isfinite(got).all():
            raise AssertionError(f"tagger output {len(out)} x {out[0].shape}")
        if err > F32_REL_TOL:
            raise AssertionError(f"tagger {n}x{L} card vs CPU: {err}")
    return rec


def seq_interchange(dev):
    """(d) ONNX export of a booster fitted on the card and of seeded
    ResNet-50 weights, each imported by the port's ``onnx_import`` on the
    card; a small torch CNN through ``torch_to_jax_model``."""
    from mmlspark_tpu_torch._device import float32_exact
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.dl import (export_gbdt, export_resnet,
                                       onnx_to_jax, torch_to_jax_model)
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train
    rec = {}
    X, y = bench_data(50_000, seed=66)
    X = X[:, :20].copy()
    booster = train(X, y, GBDTParams(num_iterations=4, num_leaves=15,
                                     objective="binary")).booster
    fn, weights = onnx_to_jax(export_gbdt(booster))
    Xd = torch.from_numpy(X).to(dev)
    label, scores = fn(weights, Xd)
    raw = booster.raw_scores(X)
    if scores.device.type != "cuda":
        raise AssertionError("the imported booster ran off the card")
    rec["gbdt_max_abs_err"] = float(np.abs(scores[:, 1].cpu().numpy()
                                           - raw.ravel()).max())
    if rec["gbdt_max_abs_err"] > 1e-5:
        raise AssertionError(f"exported booster vs raw_scores: {rec}")
    model = seeded_resnet50(torch.Generator().manual_seed(67)).to(dev)
    t0 = time.perf_counter()
    data = export_resnet(model)
    rec["resnet50_export_s"] = time.perf_counter() - t0
    rec["resnet50_onnx_mb"] = len(data) / 1e6
    fn, weights = onnx_to_jax(data)
    weights = {k: torch.tensor(v, device=dev) for k, v in weights.items()}
    x = torch.rand(4, DNN_HW, DNN_HW, 3, device=dev,
                   generator=torch.Generator(dev).manual_seed(68))
    with torch.inference_mode():
        want = model(x)
        got = fn(weights, x.permute(0, 3, 1, 2).contiguous())
    rec["resnet50_rel"] = rel_err(got, want)
    if rec["resnet50_rel"] > F32_REL_TOL:
        raise AssertionError(f"exported ResNet-50 vs the port's: {rec}")
    net = torch.nn.Sequential(
        torch.nn.Conv2d(3, 16, 3, padding=1), torch.nn.BatchNorm2d(16),
        torch.nn.ReLU(), torch.nn.MaxPool2d(2),
        torch.nn.Conv2d(16, 32, 3, stride=2), torch.nn.ReLU(),
        torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
        torch.nn.Linear(32, 10)).eval()
    gen = torch.Generator().manual_seed(69)
    with torch.no_grad():
        bn = net[1]
        bn.running_mean.copy_(torch.randn(16, generator=gen) * 0.2)
        bn.running_var.copy_(torch.rand(16, generator=gen) + 0.5)
    imgs = np.random.default_rng(70).normal(size=(64, 32, 32, 3)).astype(
        np.float32)
    jm = torch_to_jax_model(net, input_col="image", output_col="logits",
                            batch_size=32)
    out = np.stack(list(jm.transform(DataFrame.from_dict(
        {"image": _column(imgs)})).collect()["logits"]))
    if jm.runner().device.type != "cuda":
        raise AssertionError("the imported CNN is not on the card")
    net = net.to(dev)
    with torch.inference_mode(), float32_exact():
        want = net(torch.from_numpy(imgs).to(dev).permute(0, 3, 1, 2))
    rec["torch_cnn_rel"] = rel_err(out, want)
    if rec["torch_cnn_rel"] > 1e-5:
        raise AssertionError(f"imported CNN vs the torch module: {rec}")
    return rec


def seq_phase(dev):
    t0 = time.perf_counter()
    dec = seq_decode(dev)
    t_dec = time.perf_counter() - t0
    enc = seq_encoder(dev)
    t_enc = time.perf_counter() - t0 - t_dec
    tag = seq_bilstm(dev)
    inter = seq_interchange(dev)
    DETAIL["seq"] = {"decode": dec, "encoder": enc, "bilstm": tag,
                     "interchange": inter,
                     "seconds": {"decode": t_dec, "encoder": t_enc,
                                 "total": time.perf_counter() - t0}}
    for point, r in dec.items():
        lays = " | ".join(
            f"{lay} {r[lay]['tokens_per_s_events']:.0f} tok/s (events; wall "
            f"{r[lay]['tokens_per_s_wall']:.0f}), {r[lay]['steps']} steps, "
            f"{r[lay]['cache_bytes_per_seq'] / 1e6:.3f} MB/seq"
            + (f", pages_peak {r[lay]['pages_peak']}" if "pages_peak"
               in r[lay] else "")
            + f", peak {r[lay]['peak_bytes'] / 1e6:.1f} MB"
            + (", profiled: {device_ms_per_step:.3f} device / "
               "{wall_ms_per_step:.3f} wall ms per forward, busy "
               "{busy_share:.2f}, {launches_per_forward:.0f} launches per "
               "forward".format(**r[lay]["profile"]) if "profile" in r[lay]
               else "")
            for lay in ("dense", *(f"paged{ps}" for ps in SEQ_PAGE_SIZES)))
        log(f"[seq] decode {point} (B {r['batch']}, prompts "
            f"{r['prompt_lens'][0]}-{r['prompt_lens'][1]}, "
            f"{r['new_tokens']} new, eos {r['eos_id']}, "
            f"{r['finished_rows']} rows hit eos): {lays}; dense = paged "
            f"tokens; logits card vs CPU "
            f"{r['card_vs_cpu']['max_abs_logit_err']:.1e}, near-ties "
            f"{r['card_vs_cpu']['near_ties']}")
    log(f"[seq] encoder {ENCODER_BATCH} x {ENCODER_LEN} (vocab 512, "
        "defaults): " + " | ".join(
        f"{m} {enc[m]['sequences_per_s']:.1f} seq/s, peak "
        f"{enc[m]['peak_bytes'] / 1e9:.2f} GB"
        + (f", vs dense {enc[m]['vs_dense_rel']:.1e}" if m != "dense"
           else "") for m in ("dense", "blockwise", "ring"))
        + f"; card vs CPU {enc['card_vs_cpu_rel']:.1e}")
    log("[seq] BiLSTM (config 5, batch 256): " + " | ".join(
        f"{k} {v['tokens_per_s']:.0f} tok/s (wall {v['wall_s']:.3f} s, card "
        f"vs CPU {v['card_vs_cpu_rel']:.1e})" for k, v in tag.items()))
    log(f"[seq] interchange: exported booster vs raw_scores "
        f"{inter['gbdt_max_abs_err']:.1e}; exported ResNet-50 "
        f"({inter['resnet50_onnx_mb']:.1f} MB) vs the port's "
        f"{inter['resnet50_rel']:.1e}; imported CNN vs torch "
        f"{inter['torch_cnn_rel']:.1e}")


# --------------------------------------------------------------------------
# serve phase: the decode/serving engine at bench.py's decode LM
# --------------------------------------------------------------------------

SERVE_SLOTS, SERVE_PROMPT, SERVE_NEW, SERVE_PAGE = 8, 16, 32, 16
SERVE_REQUESTS = 48                     # bench.py's continuous trace
PREFIX_PAGE, PREFIX_REQUESTS, PREFIX_BUDGET = 4, 40, 16
HTTP_CLIENTS, HTTP_PER_CLIENT = 8, 16   # 128 decode requests
DRAIN_NEW = 512                         # long budgets keep 8 in flight
#: a greedy token may differ from the one-shot decode's only from a step
#: where the one-shot's top two logits lie within this (a near-tie)
NEAR_TIE = 1e-4


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def serve_trace(vocab: int):
    """bench.py's continuous trace (``bench.py:529-545``): 48 requests,
    prompts of 4-16 tokens, budgets of 4-32, Poisson arrivals at 1.25x
    the engine's capacity on the step clock, from ``default_rng(17)``."""
    rng = np.random.default_rng(17)
    min_b = max(2, SERVE_NEW // 8)
    rate = 1.25 * SERVE_SLOTS / ((min_b + SERVE_NEW) / 2.0)
    reqs, arrive = [], 0.0
    for _ in range(SERVE_REQUESTS):
        arrive += rng.exponential(1.0 / rate)
        plen = int(rng.integers(max(2, SERVE_PROMPT // 4), SERVE_PROMPT + 1))
        reqs.append((rng.integers(0, vocab, plen).astype(np.int32), plen,
                     int(rng.integers(min_b, SERVE_NEW + 1)), int(arrive)))
    return reqs


def template_trace(vocab: int):
    """bench.py's template trace (``bench.py:703-719``): 40 requests, one
    of 3 templates of 12 tokens plus a 4-token suffix each, budget 16,
    Poisson arrivals at 1.25x capacity, from ``default_rng(23)``."""
    rng = np.random.default_rng(23)
    templates = [rng.integers(0, vocab, 12).astype(np.int32)
                 for _ in range(3)]
    rate = 1.25 * SERVE_SLOTS / PREFIX_BUDGET
    reqs, arrive = [], 0.0
    for i in range(PREFIX_REQUESTS):
        arrive += rng.exponential(1.0 / rate)
        p = np.concatenate([templates[i % 3],
                            rng.integers(0, vocab, 4).astype(np.int32)])
        reqs.append((p, PREFIX_BUDGET, int(arrive)))
    return reqs


class OneShot:
    """One-shot paged decodes of single prompts, each run once at the
    largest budget with its logits (a greedy prefix is the same for any
    shorter budget): the reference every served request is held to."""

    def __init__(self, runner, page_size: int):
        self.runner, self.page_size = runner, page_size
        self._memo = {}

    def get(self, prompt, budget: int = SERVE_NEW):
        key = (tuple(int(t) for t in prompt), self.page_size)
        if key not in self._memo or len(self._memo[key][0]) < budget:
            res = self.runner.decode(
                np.asarray(prompt, np.int32)[None], max_new_tokens=budget,
                kv_layout="paged", page_size=self.page_size,
                collect_logits=True)
            self._memo[key] = (list(res.tokens[0]), res.logits[0])
        return self._memo[key]

    def check(self, prompt, tokens, what: str, ties: list) -> None:
        """Tokens equal the one-shot's, except from a near-tie step
        (reported in ``ties``); a divergence anywhere else fails."""
        ref, logits = self.get(prompt, max(len(tokens), 1))
        tokens = [int(t) for t in tokens]
        bad = [t for t, (a, b) in enumerate(zip(tokens, ref)) if a != b]
        if not bad:
            return
        t = bad[0]
        top2 = np.sort(logits[t])[-2:]
        gap = float(top2[1] - top2[0])
        if gap > NEAR_TIE:
            raise AssertionError(f"{what}: tokens differ from one-shot at "
                                 f"step {t} (top-two gap {gap})")
        ties.append({"what": what, "step": t, "gap": gap})


def drive_stream(decoder, reqs, submit_kw):
    """Replay a trace on a stepped decoder, as bench.py drives it: arrivals
    join once the step clock passes their time (idle stretches
    fast-forwarded), a full engine holds them back."""
    from collections import deque
    from mmlspark_tpu_torch.models import SlotsExhausted
    pend, handles, virtual = deque(reqs), [], 0
    while pend or decoder._live or decoder._arrivals:
        now = decoder.steps + virtual
        while pend and pend[0][-1] <= now:
            try:
                handles.append(decoder.submit(pend[0][0],
                                              **submit_kw(pend[0])))
            except SlotsExhausted:
                break
            pend.popleft()
        if decoder._live or decoder._arrivals:
            decoder.step()
        elif pend:
            virtual = pend[0][-1] - decoder.steps
    return handles


def serve_continuous(runner, reqs, ref, ties):
    """(a) the ticked drain against the continuous engine on the trace."""
    useful = sum(r[2] for r in reqs)

    def ticked():
        t0, clock_steps, i = time.perf_counter(), 0, 0
        prefills = steps = 0
        out = []
        while i < len(reqs):
            clock_steps = max(clock_steps, reqs[i][3])
            group = []
            while i < len(reqs) and reqs[i][3] <= clock_steps \
                    and len(group) < SERVE_SLOTS:
                group.append(reqs[i])
                i += 1
            gmax = max(r[2] for r in group)
            stacked = np.zeros((len(group), SERVE_PROMPT), np.int32)
            for j, r in enumerate(group):
                stacked[j, :r[1]] = r[0]
            res = runner.decode(stacked, lengths=[r[1] for r in group],
                                max_new_tokens=gmax, kv_layout="paged",
                                page_size=SERVE_PAGE,
                                batch_bucket=SERVE_SLOTS,
                                prompt_bucket=SERVE_PROMPT)
            out += [list(res.tokens[j, :r[2]]) for j, r in enumerate(group)]
            prefills += 1
            steps += res.steps
            clock_steps += gmax
        _sync()
        wall = time.perf_counter() - t0
        return {"tokens_per_s": useful / wall, "prefills": prefills,
                "steps": steps,
                "wall_ms_per_forward": wall * 1e3 / (prefills + steps)}, out

    def continuous(profile=False):
        dec = runner.decode_stream(slots=SERVE_SLOTS,
                                   prompt_bucket=SERVE_PROMPT,
                                   max_new_tokens=SERVE_NEW,
                                   page_size=SERVE_PAGE)
        dec.warmup()
        b0 = runner._c_batches["decode"].value
        ctx = contextlib.nullcontext()
        if profile:
            # the card's activity only: tracing every host op would cost
            # the host loop more than it spends
            from torch.profiler import ProfilerActivity
            acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() \
                else [ProfilerActivity.CPU]
            ctx = torch.profiler.profile(activities=acts)
        _sync()
        t0 = time.perf_counter()
        with ctx as prof:
            hs = drive_stream(dec, reqs, lambda r: {"max_new_tokens": r[2]})
            _sync()
        wall = time.perf_counter() - t0
        rec = {"tokens_per_s": useful / wall,
               "prefills": int(runner._c_batches["decode"].value - b0),
               "steps": dec.steps}
        rec["forwards"] = dec.steps + rec["prefills"]
        rec["wall_ms_per_forward"] = wall * 1e3 / rec["forwards"]
        if profile:
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
            rec = {"device_ms_per_forward": dev_ms / rec["forwards"],
                   "kernels_per_forward": sum(e.count for e in kernels)
                   / rec["forwards"],
                   "busy_share": dev_ms / 1e3 / wall, **rec}
        dec.close()
        return rec, hs

    # in turns after one warm run each: the host's pace drifts within a
    # call by more than the two engines differ
    ticked()
    continuous()
    runs = {"ticked": [], "continuous": []}
    for name in ("ticked", "continuous", "continuous", "ticked"):
        rec, out = ticked() if name == "ticked" else continuous()
        runs[name].append(rec)
        for r, got in zip(reqs, out):
            toks = got if name == "ticked" else got.tokens
            if name == "continuous" and (got.status != "ok"
                                         or len(toks) != r[2]):
                raise AssertionError(f"serve (a): request {got.status} "
                                     f"with {len(toks)} of {r[2]} tokens")
            ref.check(r[0], toks, name, ties)
    prof, _ = continuous(profile=True)
    pool = runner.page_pool(SERVE_PAGE)
    if pool.pages_in_use():
        raise AssertionError(f"serve (a): {pool.pages_in_use()} pages held "
                             "after close()")
    mean = {k: sum(r["tokens_per_s"] for r in v) / len(v)
            for k, v in runs.items()}
    return {"useful_tokens": useful, "runs": runs,
            "ratio": mean["continuous"] / mean["ticked"],
            "continuous_profile": prof}


def serve_prefix(runner, reqs):
    """(b) the template trace through the continuous engine, cold and
    then with the prefix cache."""
    cow = runner.registry.family("mmlspark_prefix_cow_splits_total")
    out, tokens = {}, {}
    for mode in ("cold", "cached"):
        cow0 = cow.labels(runner=runner.name).value
        dec = runner.decode_stream(slots=SERVE_SLOTS,
                                   prompt_bucket=SERVE_PROMPT,
                                   max_new_tokens=PREFIX_BUDGET,
                                   page_size=PREFIX_PAGE,
                                   prefix_cache=mode == "cached")
        dec.warmup()
        hs = drive_stream(dec, reqs, lambda r: {"max_new_tokens": r[1]})
        ttfts = sorted(1e3 * h.ttft_s for h in hs)
        out[mode] = {"ttft_p50_ms": ttfts[len(ttfts) // 2],
                     "ttft_p99_ms": ttfts[int(len(ttfts) * 0.99)],
                     "cow_splits": cow.labels(runner=runner.name).value
                     - cow0}
        if mode == "cached":
            out[mode].update(dec.index.stats())
        tokens[mode] = [list(h.tokens) for h in hs]
        if any(h.status != "ok" for h in hs):
            raise AssertionError(f"serve (b): a {mode} request failed")
        dec.close()
    if tokens["cached"] != tokens["cold"]:
        bad = sum(a != b for a, b in zip(tokens["cached"], tokens["cold"]))
        raise AssertionError(f"serve (b): {bad} cached requests' tokens "
                             "differ from cold")
    idx = runner.prefix_cache(PREFIX_PAGE)
    idx.evict_pages(idx.retained_pages(), reason="pressure")
    held = runner.page_pool(PREFIX_PAGE).pages_in_use()
    if held:
        raise AssertionError(f"serve (b): {held} pages held after eviction")
    return out


def _post(port: int, path: str, obj, timeout: float = 60.0):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, json.dumps(obj),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode()), \
            dict(resp.getheaders())
    finally:
        conn.close()


def _fire_all(port: int, path: str, bodies, clients: int):
    """POST every body, ``clients`` threads at a time; returns the
    (status, reply, headers) triples in order."""
    import threading
    out = [None] * len(bodies)

    def worker(k):
        for i in range(k, len(bodies), clients):
            out[i] = _post(port, path, bodies[i])

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    return out


def serve_http(runner, reqs, ref, ties):
    """(c) ``PipelineServer`` over 127.0.0.1 in front of the continuous
    scorer: every trace prompt answered 200 with one-shot tokens,
    ``mixed_load``'s decode class (128 requests from 8 persistent
    connections), then a zero-drop drain with 8 requests in flight."""
    import threading
    from mmlspark_tpu_torch.serving import PipelineServer, mixed_load
    scorer = runner.scorer(mode="decode", continuous=True, report_ttft=True,
                           slots=SERVE_SLOTS, prompt_bucket=SERVE_PROMPT,
                           max_new_tokens=SERVE_NEW, page_size=SERVE_PAGE)
    srv = PipelineServer(scorer, port=0, mode="continuous").start()
    rec = {}
    prompts = [r[0].tolist() for r in reqs]
    try:
        got = _fire_all(srv.port, srv.api_path, prompts, SERVE_SLOTS)
        for p, (status, reply, _) in zip(prompts, got):
            if status != 200:
                raise AssertionError(f"serve (c): status {status}: {reply}")
            ref.check(p, reply["tokens"], "http", ties)
        load = mixed_load("127.0.0.1", srv.port, [{
            "name": "decode", "path": srv.api_path,
            "prompt_pool": {"prefixes": prompts},
            "headers": {"Content-Type": "application/json"},
            "n_clients": HTTP_CLIENTS, "per_client": HTTP_PER_CLIENT,
            "ttft_key": "ttft_ms", "tokens_key": "tokens"}], warm=2)
        d = load["decode"]
        if d["errors"] or d["non_2xx"] or \
                d["completed"] != HTTP_CLIENTS * HTTP_PER_CLIENT:
            raise AssertionError(f"serve (c): mixed_load {d}")
        rec["load"] = {k: d[k] for k in ("rps", "p50_ms", "p99_ms",
                                         "ttft_p50_ms", "ttft_p99_ms",
                                         "decode_tokens_per_sec",
                                         "completed")}
    finally:
        srv.stop()
    # the drain drill, on a scorer whose budgets keep 8 requests in flight
    drainer = runner.scorer(mode="decode", continuous=True,
                            slots=SERVE_SLOTS, prompt_bucket=SERVE_PROMPT,
                            max_new_tokens=DRAIN_NEW, page_size=SERVE_PAGE)
    srv = PipelineServer(drainer, port=0, mode="continuous").start()
    results = [None] * SERVE_SLOTS

    def fire(i):
        results[i] = _post(srv.port, srv.api_path, prompts[i], timeout=300)

    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(SERVE_SLOTS)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 60
    while drainer._decoder is None or drainer._decoder._live < SERVE_SLOTS:
        if time.monotonic() > deadline:
            raise AssertionError("serve (c): the drain's requests never "
                                 "all joined")
        time.sleep(0.001)
    verdict = {}
    t_drain = threading.Thread(target=lambda: verdict.update(
        ok=srv.drain(timeout_s=120.0)))
    t0 = time.perf_counter()
    t_drain.start()
    while not srv.draining:
        time.sleep(0.0005)
    status, reply, headers = _post(srv.port, srv.api_path, prompts[0])
    if status != 503 or int(headers.get("Retry-After", 0)) < 1:
        raise AssertionError(f"serve (c): a newcomer during the drain got "
                             f"{status} {headers}: {reply}")
    for t in threads:
        t.join(300)
    t_drain.join(300)
    drain_s = time.perf_counter() - t0
    srv.stop()
    dropped = sum(1 for r in results
                  if r is None or r[0] != 200 or len(r[1]) != DRAIN_NEW)
    if dropped or verdict.get("ok") is not True:
        raise AssertionError(f"serve (c): the drain dropped {dropped} "
                             f"requests (verdict {verdict})")
    held = runner.page_pool(SERVE_PAGE).pages_in_use()
    if held:
        raise AssertionError(f"serve (c): {held} pages held after stop()")
    rec["drain"] = {"in_flight": SERVE_SLOTS, "dropped": 0,
                    "newcomer_status": status,
                    "retry_after": int(headers["Retry-After"]),
                    "drain_s": drain_s}
    return rec


def serve_gbdt(dev):
    """(c) a port ``LightGBMClassificationModel`` behind a
    ``PipelineServer``, single-row requests over one persistent
    connection and then ``sustained_load``, as bench.py's phase_serving
    (``bench.py:962-1018``)."""
    import http.client
    from mmlspark_tpu_torch.core import DataFrame, Transformer
    from mmlspark_tpu_torch.core.schema import vector_column
    from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
    from mmlspark_tpu_torch.serving import PipelineServer, sustained_load
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2000, 20))
    y = (X[:, 0] > 0).astype(float)
    df = DataFrame.from_dict({"features": vector_column(list(X)),
                              "label": y})
    model = LightGBMClassifier().set_params(num_iterations=30,
                                            min_data_in_leaf=5,
                                            device=str(dev)).fit(df)

    class Scorer(Transformer):
        def _transform(self, frame):
            def per_part(p):
                feats = vector_column([np.asarray(v, np.float32)
                                       for v in p["request"]])
                out = model.transform(DataFrame.from_dict(
                    {"features": feats}))
                return {**p, "reply": out.collect()["prediction"]}
            return frame.map_partitions(per_part)

        def transform_schema(self, schema):
            return schema

    srv = PipelineServer(Scorer(), port=0, mode="continuous").start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
        body = json.dumps(list(np.asarray(X[0], float)))
        hdrs = {"Content-Type": "application/json"}
        want = float(model.transform(DataFrame.from_dict(
            {"features": vector_column([X[0].astype(np.float32)])}))
            .collect()["prediction"][0])
        for _ in range(50):
            conn.request("POST", srv.api_path, body, hdrs)
            got = json.loads(conn.getresponse().read().decode())
        if float(got) != want:
            raise AssertionError(f"serve gbdt: reply {got} != {want}")
        lats = []
        for _ in range(1000):
            t0 = time.perf_counter()
            conn.request("POST", srv.api_path, body, hdrs)
            conn.getresponse().read()
            lats.append(time.perf_counter() - t0)
        conn.close()
        lats.sort()
        load = sustained_load("127.0.0.1", srv.port, srv.api_path, body,
                              hdrs)
    finally:
        srv.stop()
    if load["errors"] or load["non_2xx"]:
        raise AssertionError(f"serve gbdt: sustained_load {load}")
    return {"p50_ms": 1e3 * lats[500], "p95_ms": 1e3 * lats[950],
            "sustained_rps": load["rps"], "sustained_p99_ms": load["p99_ms"]}


def serve_stall(runner, ref, ties):
    """(d) the stall drill: a continuous scorer with 2 live requests is
    aborted as the watchdog's monitor thread would; both shed
    ``shed_engine_stall``, the rebuild waits out its backoff
    (``engine_restarting``), the slabs were dropped, and the first request
    the rebuilt engine serves equals one-shot."""
    import threading
    from mmlspark_tpu_torch.models.runner import EngineUnavailable
    from mmlspark_tpu_torch.utils.resilience import RestartSupervisor
    sup = RestartSupervisor(initial_backoff_s=0.5)
    scorer = runner.scorer(mode="decode", continuous=True,
                           slots=SERVE_SLOTS, prompt_bucket=SERVE_PROMPT,
                           max_new_tokens=DRAIN_NEW, page_size=SERVE_PAGE,
                           supervisor=sup)
    verdicts, lock = [], threading.Lock()

    def resolve(**kw):
        with lock:
            verdicts.append((kw["status"], kw["verdict"]))

    dec = scorer._ensure_decoder()
    prompts = [np.arange(1, 9, dtype=np.int32), np.arange(9, 13,
                                                          dtype=np.int32)]
    for p in prompts:
        scorer.continuous_submit(p, resolve)
    deadline = time.monotonic() + 30
    while dec._live < 2:
        if time.monotonic() > deadline:
            raise AssertionError("serve (d): the requests never joined")
        time.sleep(0.0005)
    pool = dec.pool
    dec._stall_abort("dispatch", 99.0)
    if verdicts != [(503, "shed_engine_stall")] * 2:
        raise AssertionError(f"serve (d): verdicts {verdicts}")
    if pool._cache is not None or pool.pages_in_use():
        raise AssertionError("serve (d): the aborted engine's slabs or "
                             "pages are still in the pool")
    try:
        scorer._ensure_decoder()
        raise AssertionError("serve (d): the engine rebuilt inside its "
                             "backoff")
    except EngineUnavailable as e:
        if e.shed_reason != "engine_restarting":
            raise AssertionError(f"serve (d): {e.shed_reason}")
        time.sleep(e.retry_after_s + 0.05)
    dec2 = scorer._ensure_decoder()
    h = dec2.submit(prompts[0], max_new_tokens=SERVE_NEW)
    if not h.done.wait(60) or h.status != "ok":
        raise AssertionError(f"serve (d): first rebuilt request {h.status}")
    ref.check(prompts[0], h.tokens, "after_stall", ties)
    restarts = runner.registry.family(
        "mmlspark_engine_restarts_total").labels(runner=runner.name).value
    if restarts != 1:
        raise AssertionError(f"serve (d): {restarts} restarts booked")
    scorer.continuous_close()
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("mmlspark-decode-stream")]
    deadline = time.monotonic() + 30
    while alive and time.monotonic() < deadline:
        time.sleep(0.05)
        alive = [t.name for t in threading.enumerate()
                 if t.name.startswith("mmlspark-decode-stream")]
    if alive:
        raise AssertionError(f"serve (d): engine threads still alive: "
                             f"{alive}")
    return {"verdicts": verdicts, "restarts": restarts,
            "backoff_s": sup.as_dict()}


def serve_phase(dev, smi: str):
    """The decode/serving engine at bench.py's decode LM: (a) continuous
    vs ticked, (b) the prefix cache, (c) HTTP, (d) the stall drill."""
    from mmlspark_tpu_torch.models import ModelRunner, TransformerEncoder
    lm = TransformerEncoder(**SEQ_LM,
                            generator=torch.Generator().manual_seed(60))
    runner = ModelRunner(module=lm, name="serve", device=dev)
    t0 = time.perf_counter()
    ties: list = []
    reqs = serve_trace(SEQ_LM["vocab_size"])
    ref = OneShot(runner, SERVE_PAGE)
    for r in reqs:
        ref.get(r[0])
    t_ref = time.perf_counter() - t0
    cont = serve_continuous(runner, reqs, ref, ties)
    t_a = time.perf_counter() - t0
    prefix = serve_prefix(runner, template_trace(SEQ_LM["vocab_size"]))
    t_b = time.perf_counter() - t0
    http = serve_http(runner, reqs, ref, ties)
    gbdt = serve_gbdt(dev)
    t_c = time.perf_counter() - t0
    stall = serve_stall(runner, ref, ties)
    DETAIL["serve"] = {"card": smi, "continuous": cont, "prefix": prefix,
                       "http": http, "gbdt": gbdt, "stall": stall,
                       "near_ties": ties,
                       "seconds": {"one_shot_refs": t_ref, "a": t_a - t_ref,
                                   "b": t_b - t_a, "c": t_c - t_b,
                                   "total": time.perf_counter() - t0}}
    p = cont["continuous_profile"]

    def runs(name):
        rs = cont["runs"][name]
        return (" / ".join(f"{r['tokens_per_s']:.0f}" for r in rs)
                + f" tok/s ({rs[0]['prefills']} prefills, {rs[0]['steps']} "
                f"steps; wall per forward "
                + " / ".join(f"{r['wall_ms_per_forward']:.3f}" for r in rs)
                + " ms)")

    log(f"[serve] {smi} | (a) {SERVE_REQUESTS} requests, {SERVE_SLOTS} "
        f"slots, useful {cont['useful_tokens']} tokens, in turns: ticked "
        f"{runs('ticked')}, continuous {runs('continuous')}, ratio of "
        f"means {cont['ratio']:.2f}; profiled continuous: "
        f"{p['device_ms_per_forward']:.3f} device ms and "
        f"{p['kernels_per_forward']:.0f} kernels per forward, busy "
        f"{p['busy_share']:.3f}; tokens = one-shot (near-ties {len(ties)})")
    log(f"[serve] {smi} | (b) template trace: hit rate "
        f"{prefix['cached']['hit_rate_pct']:.1f}%, TTFT p50/p99 cold "
        f"{prefix['cold']['ttft_p50_ms']:.2f}/"
        f"{prefix['cold']['ttft_p99_ms']:.2f} ms, cached "
        f"{prefix['cached']['ttft_p50_ms']:.2f}/"
        f"{prefix['cached']['ttft_p99_ms']:.2f} ms, CoW splits "
        f"{prefix['cached']['cow_splits']:.0f}; cached = cold tokens")
    ld = http["load"]
    log(f"[serve] {smi} | (c) HTTP: {SERVE_REQUESTS} trace prompts 200 = "
        f"one-shot; mixed_load {ld['completed']:.0f} requests from "
        f"{HTTP_CLIENTS} connections: p50 {ld['p50_ms']:.1f} ms, p99 "
        f"{ld['p99_ms']:.1f} ms, TTFT p99 {ld['ttft_p99_ms']:.1f} ms, "
        f"{ld['decode_tokens_per_sec']:.0f} tok/s, {ld['rps']:.1f} rps; "
        f"drain with {http['drain']['in_flight']} in flight: 0 dropped, "
        f"newcomer {http['drain']['newcomer_status']} Retry-After "
        f"{http['drain']['retry_after']}, {http['drain']['drain_s']:.2f} s; "
        f"GBDT single-row p50 {gbdt['p50_ms']:.3f} ms, p95 "
        f"{gbdt['p95_ms']:.3f} ms, sustained {gbdt['sustained_rps']:.0f} "
        f"rps p99 {gbdt['sustained_p99_ms']:.2f} ms")
    log(f"[serve] {smi} | (d) stall drill: {stall['verdicts']}, rebuilt "
        f"after backoff, first request = one-shot, restarts "
        f"{stall['restarts']:.0f}")
    return runner, ref, reqs


# --------------------------------------------------------------------------
# graphs phase: the runner's compiled programs (CUDA graphs) against eager
# --------------------------------------------------------------------------

GRAPHS_RESNET_ROWS = 384        # ResNet-50 buckets of 256 and 128 rows


def eager_runner(**kw):
    """A ``ModelRunner`` whose programs are eager: the same runner code with
    every program built by ``instrumented_call`` (booked, never captured),
    the baseline the replayed programs are held to bit for bit."""
    from mmlspark_tpu_torch.models import ModelRunner
    from mmlspark_tpu_torch.observability import compute

    class EagerRunner(ModelRunner):
        def _instrumented(self, fn, suffix="", **jit_kwargs):
            wrapper = compute.instrumented_call(
                fn, name=f"runner.{self.name}{suffix}",
                registry=self.registry, **jit_kwargs)
            self._wrappers.append(wrapper)
            return wrapper

    return EagerRunner(**kw)


def _eager_program_class():
    from mmlspark_tpu_torch.observability import compute

    class EagerProgram(compute.InstrumentedJit):
        """``compute.captured``'s program with its capture swapped for an
        eager call: the same code, never captured."""

        def _run(self, sig, args, kwargs):
            return compute.InstrumentedCall._run(self, sig, args, kwargs)

    return EagerProgram


def eager_captured(fn, **kw):
    """What ``compute.captured(fn, **kw)`` builds, run eagerly: the
    baseline the plain-jit twins' replays are held to."""
    return _eager_program_class()(fn, booked=False, **kw)


@contextlib.contextmanager
def eager_plain_programs(*modules):
    """Within the block, ``modules`` build their ``captured`` programs as
    ``eager_captured`` ones (the VW step per fit, Word2Vec's blocks per
    fit); the lasso's module-level program is swapped likewise."""
    from mmlspark_tpu_torch.explainers import regression
    saved = [(m, m.captured) for m in modules]
    ista = regression._ISTA
    try:
        for m in modules:
            m.captured = eager_captured
        regression._ISTA = eager_captured(regression._ista,
                                          static_argnums=(4,))
        yield
    finally:
        for m, c in saved:
            m.captured = c
        regression._ISTA = ista


def time_program(fn, calls) -> dict:
    """``fn(*args)`` for each ``args`` of ``calls``: host enqueue ms a call
    (the loop's wall before the closing sync) beside device ms a call
    (CUDA events around the loop)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    start.record()
    for args in calls:
        fn(*args)
    end.record()
    host_s = time.perf_counter() - h0
    torch.cuda.synchronize()
    n = max(len(calls), 1)
    return {"calls": len(calls), "host_enqueue_ms": host_s / n * 1e3,
            "device_ms": start.elapsed_time(end) / n}


def program_stats(prog) -> dict:
    """A captured program's captures, re-captures, replays and capture
    seconds."""
    snap = prog.snapshot()
    return {"captures": snap.get("captures", 0),
            "recaptures": snap.get("recaptures", 0),
            "replays": snap.get("replays", 0),
            "capture_s": [c for c in snap.get("capture_seconds", [])
                          if c is not None]}


def graphs_decode(runners):
    """(a) bench.py's decode arm (8 x 16 prompts, 32 new tokens) at the
    seq LM, dense and paged at 16, on the replayed and the eager runner:
    greedy tokens equal, then the collected logits equal bit for bit (each
    replayed call after its capture); tokens/s (``timed_decode``, in
    turns) and ``decode_profile``'s host enqueue and device ms per
    forward for each."""
    rng = np.random.default_rng(61)
    prompts = rng.integers(0, SEQ_LM["vocab_size"], (8, 16)).astype(
        np.int32)
    lengths = np.full(8, 16, np.int32)
    rec = {}
    for lay, lkw in (("dense", {}),
                     (f"paged{SERVE_PAGE}", {"kv_layout": "paged",
                                             "page_size": SERVE_PAGE})):
        kw = dict(lengths=lengths, max_new_tokens=32, **lkw)
        r = {name: {"timed": []} for name in runners}
        for run in runners.values():
            run.decode(prompts, **kw)             # capture / warm-up
        greedy = {}
        for name in ("replayed", "eager", "eager", "replayed"):
            # captures and the collector's passes during the call: a slow
            # call says which of the two it paid for, or neither
            c0 = runners[name].graph_stats()["captures"]
            g0 = [g["collections"] for g in gc.get_stats()]
            greedy[name], t = timed_decode(runners[name], prompts, **kw)
            t["captures"] = runners[name].graph_stats()["captures"] - c0
            t["gc_passes"] = [g["collections"] - n
                              for g, n in zip(gc.get_stats(), g0)]
            r[name]["timed"].append(t)
        if not np.array_equal(greedy["replayed"].tokens,
                              greedy["eager"].tokens):
            raise AssertionError(f"graphs (a) {lay}: replayed tokens differ "
                                 "from eager")
        logits = {}
        for name, run in runners.items():
            run.decode(prompts, collect_logits=True, **kw)
            logits[name] = run.decode(prompts, collect_logits=True, **kw)
        g, e = logits["replayed"], logits["eager"]
        if not (np.array_equal(g.tokens, e.tokens)
                and np.array_equal(g.logits, e.logits)):
            raise AssertionError(
                f"graphs (a) {lay}: replayed logits differ from eager by "
                f"{float(np.abs(g.logits - e.logits).max())}: the capture "
                "picked other kernels")
        # the process's first profile pays the profiler's own start-up:
        # one profile is thrown away before the two that are kept
        decode_profile(runners["eager"], prompts, **kw)
        for name, run in runners.items():
            r[name]["profile"] = decode_profile(run, prompts, **kw)
        rec[lay] = r
    return rec


def graphs_engine(runners):
    """(b) bench.py's continuous trace through each runner's
    ``ContinuousDecoder``: every request's tokens equal, replayed and
    eager, and no join compiles; TTFT p50/p99 and wall per forward of
    each.  (c) copy-on-write splits (``tests/test_prefix_cache.py``'s
    drill at the seq LM): a 12-token prompt decoded with the prefix
    cache, then again (a full hit ending mid-page: a split), a partial
    hit, then both through a continuous engine on the same pool (a join's
    split): tokens and splits equal, splits > 0 (the replayed runner's
    ``cow_copy`` program)."""
    from mmlspark_tpu_torch.models import PagePool
    reqs = serve_trace(SEQ_LM["vocab_size"])
    useful = sum(r[2] for r in reqs)
    rec, toks = {}, {}
    for name, run in runners.items():
        dec = run.decode_stream(slots=SERVE_SLOTS, prompt_bucket=SERVE_PROMPT,
                                max_new_tokens=SERVE_NEW,
                                page_size=SERVE_PAGE)
        dec.warmup()
        n0 = run.compile_stats()["compiles"]
        _sync()
        t0 = time.perf_counter()
        hs = drive_stream(dec, reqs, lambda r: {"max_new_tokens": r[2]})
        _sync()
        wall = time.perf_counter() - t0
        if any(h.status != "ok" for h in hs):
            raise AssertionError(f"graphs (b) {name}: a request failed")
        if run.compile_stats()["compiles"] != n0:
            raise AssertionError(f"graphs (b) {name}: a join compiled")
        ttfts = sorted(1e3 * h.ttft_s for h in hs)
        rec[name] = {"ttft_p50_ms": ttfts[len(ttfts) // 2],
                     "ttft_p99_ms": ttfts[int(len(ttfts) * 0.99)],
                     "tokens_per_s": useful / wall,
                     "wall_ms_per_forward": wall * 1e3 / (dec.steps
                                                          + len(hs))}
        toks[name] = [[int(t) for t in h.tokens] for h in hs]
        dec.close()
    if toks["replayed"] != toks["eager"]:
        raise AssertionError("graphs (b): the replayed engine's tokens "
                             "differ from the eager engine's")
    base = np.random.default_rng(63).integers(
        1, SEQ_LM["vocab_size"], 12).astype(np.int32)
    partial = base.copy()
    partial[8:] = base[8:] + 1
    cow = {}
    for name, run in runners.items():
        fam = run.registry.family("mmlspark_prefix_cow_splits_total")
        c0 = fam.labels(runner=run.name).value
        pool = PagePool(run.module, num_pages=24, page_size=4,
                        name=run.name, registry=run.registry)
        got = [[int(t) for t in run.decode(
            p[None], max_new_tokens=5, kv_layout="paged", page_size=4,
            pool=pool, prefix_cache=True).tokens[0]]
            for p in (base, base, partial)]
        dec = run.decode_stream(slots=2, prompt_bucket=16, max_new_tokens=5,
                                pool=pool, prefix_cache=True)
        dec.warmup()
        got += [[int(t) for t in h.tokens]
                for h in drive_stream(dec, [(base, 0), (partial, 0)],
                                      lambda r: {})]
        dec.close()
        cow[name] = (fam.labels(runner=run.name).value - c0, got)
    if cow["replayed"][1] != cow["eager"][1]:
        raise AssertionError("graphs (c): the replayed prefix-cache tokens "
                             f"differ from eager: {cow}")
    if not cow["replayed"][0] == cow["eager"][0] > 0:
        raise AssertionError(f"graphs (c): CoW splits {cow}")
    rec["cow_splits"] = cow["replayed"][0]
    return rec


def graphs_keys(lm):
    """(d) one call sequence (dense and paged decodes, greedy, eos and
    logits, an apply, a continuous engine with the prefix cache warmed)
    on a runner on the card and on a runner on the CPU over the same
    weights: ``compile_stats()`` equal, keys and compiles."""
    from mmlspark_tpu_torch.models import ModelRunner, TransformerEncoder
    from mmlspark_tpu_torch.observability import MetricsRegistry
    cpu_lm = TransformerEncoder(**SEQ_LM,
                                generator=torch.Generator().manual_seed(60))
    runners = [ModelRunner(module=lm, name="graphs.keys", batch_size=8,
                           registry=MetricsRegistry()),
               ModelRunner(module=cpu_lm, name="graphs.keys", batch_size=8,
                           registry=MetricsRegistry(), device="cpu")]
    prompts = np.random.default_rng(62).integers(
        0, SEQ_LM["vocab_size"], (3, 12)).astype(np.int32)
    calls = [dict(max_new_tokens=8), dict(max_new_tokens=8, eos_id=7),
             dict(max_new_tokens=8, kv_layout="paged", page_size=16),
             dict(max_new_tokens=8, collect_logits=True),
             dict(max_new_tokens=24, kv_layout="paged", page_size=16)]
    for run in runners:
        for kw in calls:
            run.decode(prompts, **kw)
        run.apply_batch(prompts)
        dec = run.decode_stream(slots=4, prompt_bucket=16, max_new_tokens=8,
                                page_size=16, prefix_cache=True)
        dec.warmup()
        dec.close()
    card, cpu = (r.compile_stats() for r in runners)
    if card != cpu:
        raise AssertionError(f"graphs (d): compile_stats card {card} != "
                             f"CPU {cpu}")
    return card


def graphs_resnet(dev):
    """(e) ResNet-50 at full width in bfloat16 through ``apply_batch`` at
    batch 256 (``features=True``) on 384 images: buckets of 256 and 128
    captured, then replayed; the replay equals the module called eagerly
    on the same padded buckets, bit for bit."""
    from mmlspark_tpu_torch.models import ModelRunner, resnet
    from mmlspark_tpu_torch.models.runner import _pad_rows, bucket_rows
    cpu32 = seeded_resnet50(torch.Generator().manual_seed(50))
    m = resnet.ResNet.from_config({**cpu32.config(), "dtype": "bfloat16"})
    m.load_state_dict(cpu32.state_dict())
    m = m.to(dev)
    x = np.random.default_rng(55).standard_normal(
        (GRAPHS_RESNET_ROWS, DNN_HW, DNN_HW, 3), dtype=np.float32)
    runner = ModelRunner(module=m, name="graphs.resnet50",
                         batch_size=DNN_BATCH, apply_kwargs={"features": True})
    runner.apply_batch(x)                         # captures both buckets
    split0 = dict(runner.phase_s)
    _sync()
    t0 = time.perf_counter()
    got = runner.apply_batch(x)                   # replays
    wall = time.perf_counter() - t0
    want = []
    with torch.inference_mode():
        for i in range(0, len(x), DNN_BATCH):
            chunk = x[i:i + DNN_BATCH]
            b = bucket_rows(len(chunk), DNN_BATCH)
            y = m(torch.from_numpy(_pad_rows(chunk, b)).to(dev),
                  features=True)
            want.append(y[:len(chunk)].float().cpu().numpy())
    want = np.concatenate(want)
    if not np.array_equal(got, want):
        raise AssertionError(
            f"graphs (e): ResNet-50 replay differs from eager by "
            f"{float(np.abs(got - want).max())}: the capture picked other "
            "kernels")
    return runner, {"rows": len(x), "buckets": sorted(runner.bucket_calls),
                    "replay_wall_s": wall,
                    "replay_split_s": {k: runner.phase_s[k] - split0[k]
                                       for k in split0},
                    "compile_stats": runner.compile_stats()}


def graphs_phase(dev, smi: str):
    """The runner's compiled programs on the card: (a) decode, (b) the
    continuous engine, (c) a CoW split, (d) the keys card = CPU, (e)
    ResNet-50's buckets; capture seconds per signature and the graph
    pool's bytes."""
    from mmlspark_tpu_torch.models import ModelRunner, TransformerEncoder
    from mmlspark_tpu_torch.observability import compute
    t0 = time.perf_counter()

    def run():
        lm = TransformerEncoder(**SEQ_LM,
                                generator=torch.Generator().manual_seed(60))
        runners = {"replayed": ModelRunner(module=lm, name="graphs",
                                           batch_size=8, device=dev),
                   "eager": eager_runner(module=lm, name="graphs.eager",
                                         batch_size=8, device=dev)}
        lm = runners["replayed"].module
        rec = {"decode": graphs_decode(runners)}
        t_a = time.perf_counter() - t0
        rec["engine"] = graphs_engine(runners)
        t_b = time.perf_counter() - t0
        rec["keys"] = graphs_keys(lm)
        t_d = time.perf_counter() - t0
        resnet_runner, rec["resnet50"] = graphs_resnet(dev)
        rec["pool_bytes"] = compute.graph_pool_bytes(
            torch.cuda.current_device())
        rec["graph_stats"] = {
            "decode": runners["replayed"].graph_stats(),
            "resnet50": resnet_runner.graph_stats()}
        rec["seconds"] = {"decode": t_a, "engine_cow": t_b - t_a,
                          "keys": t_d - t_b,
                          "resnet50": time.perf_counter() - t0 - t_d}
        return rec

    rec, launches = counted(run)
    if any(launches.values()):
        raise AssertionError(f"graphs: Hopper kernels launched {launches}")
    rec.update(card=smi, launches=launches,
               total_s=time.perf_counter() - t0)
    DETAIL["graphs"] = rec
    for lay, r in rec["decode"].items():
        e, g = r["eager"], r["replayed"]
        ep, gp = e["profile"], g["profile"]
        log(f"[graphs] {smi} | (a) decode {lay}, 8 x 16 + 32: replayed = "
            f"eager (tokens, logits bit for bit); host enqueue per step "
            f"eager {ep['host_enqueue_ms_per_step']:.3f} ms, replayed "
            f"{gp['host_enqueue_ms_per_step']:.3f} ms; device per forward "
            f"eager {ep['device_ms_per_step']:.3f} ms, replayed "
            f"{gp['device_ms_per_step']:.3f} ms; wall per forward eager "
            f"{ep['wall_ms_per_step']:.3f} ms, replayed "
            f"{gp['wall_ms_per_step']:.3f} ms (launches per forward "
            f"{ep['launches_per_forward']:.0f} -> "
            f"{gp['launches_per_forward']:.0f} + "
            f"{gp['graph_launches_per_forward']:.1f} graphs); tokens/s "
            f"(events, in turns) eager "
            + " / ".join(f"{t['tokens_per_s_events']:.0f}"
                         for t in e["timed"]) + ", replayed "
            + " / ".join(f"{t['tokens_per_s_events']:.0f}"
                         for t in g["timed"]) + " (captures "
            + " / ".join(str(t["captures"]) for t in g["timed"])
            + ", gc passes " + " / ".join(str(t["gc_passes"])
                                          for t in g["timed"]) + ")")
    en = rec["engine"]
    log(f"[graphs] {smi} | (b) continuous trace ({SERVE_REQUESTS} "
        f"requests, {SERVE_SLOTS} slots): replayed = eager tokens, no join "
        f"compiled; TTFT p50/p99 eager {en['eager']['ttft_p50_ms']:.2f}/"
        f"{en['eager']['ttft_p99_ms']:.2f} ms, replayed "
        f"{en['replayed']['ttft_p50_ms']:.2f}/"
        f"{en['replayed']['ttft_p99_ms']:.2f} ms; wall per forward eager "
        f"{en['eager']['wall_ms_per_forward']:.3f} ms, replayed "
        f"{en['replayed']['wall_ms_per_forward']:.3f} ms; tokens/s eager "
        f"{en['eager']['tokens_per_s']:.0f}, replayed "
        f"{en['replayed']['tokens_per_s']:.0f}; (c) prefix cache: "
        f"{en['cow_splits']:.0f} CoW splits each, tokens equal")
    gs = rec["graph_stats"]
    caps = {k: [round(c, 4) for c in v]
            for st in gs.values() for k, v in st["capture_seconds"].items()
            if v}
    log(f"[graphs] {smi} | (d) compile_stats card = CPU: "
        f"{rec['keys']['compiles']} compiles, "
        f"{len(rec['keys']['executables'])} keys; (e) ResNet-50 bf16 "
        f"buckets {rec['resnet50']['buckets']} replayed = eager bit for "
        f"bit, replay of {rec['resnet50']['rows']} images "
        f"{rec['resnet50']['replay_wall_s']:.3f} s; captures "
        f"{gs['decode']['captures'] + gs['resnet50']['captures']}, "
        f"re-captures {gs['decode']['recaptures']}, graph pool "
        f"{(rec['pool_bytes'] or 0) / 1e6:.1f} MB; phase "
        f"{rec['total_s']:.1f} s")
    log(f"[graphs] {smi} | capture seconds per signature: "
        f"{json.dumps(caps)}")
    return launches


# --------------------------------------------------------------------------
# gbdt_graphs phase: the GBDT family's compiled programs as CUDA graphs
# --------------------------------------------------------------------------

GG_BUDGET_S = 90.0
GG_MODE_ROWS = 100_000          # multiclass, LambdaRank, DART
GG_STREAM_TILES = 4             # train_streamed's 4 tiles of STREAM_TILE
GG_PARITY_ROWS = 50_000         # the compile book card = CPU, chunked
#: the GBDT family's names in ``compile_report()``
GG_FAMILY = ("lightgbm.", "models.gbdt_walk", "ops.bin_matrix")


def gg_compiles() -> dict:
    """The process's compile counter by function."""
    from mmlspark_tpu_torch.observability import get_registry
    fam = get_registry().counter("mmlspark_jit_compile_total",
                                 labels=("fn",))
    return {k[0]: c.value for k, c in fam._snapshot()}


def gg_programs() -> dict:
    """Per GBDT-family function: compiles, captures, re-captures and the
    capture seconds of each captured signature, over its live programs."""
    from mmlspark_tpu_torch.observability import compute
    out = {}
    for w in list(compute._PROGRAMS):
        if not w.name.startswith(GG_FAMILY):
            continue
        snap = w.snapshot()
        r = out.setdefault(w.name, {"compiles": 0, "captures": 0,
                                    "recaptures": 0, "replays": 0,
                                    "capture_s": []})
        for k in ("compiles", "captures", "recaptures", "replays"):
            r[k] += snap[k]
        r["capture_s"] += [c for c in snap["capture_seconds"]
                           if c is not None]
    return out


def gg_fit(label: str, fit, iterations: int, rows: int, eager: bool,
           profile_fit: bool = False) -> dict:
    """One fit on the card, timed, with its compile-counter delta, its
    peak device memory above what was held before, and with
    ``profile_fit`` the device kernels' busy share of its boosting loop
    (``torch.profiler``: kernels a replayed graph launches are device
    events too).  ``eager`` runs it under ``eager_programs`` (the same
    code, programs booked and never captured)."""
    from torch.profiler import ProfilerActivity, profile
    from mmlspark_tpu_torch.lightgbm import core as LC
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    c0 = gg_compiles()
    p0 = gg_programs()
    ctx = LC.eager_programs() if eager else contextlib.nullcontext()
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA], acc_events=True) \
        if profile_fit else contextlib.nullcontext()
    t0 = time.perf_counter()
    with ctx, prof:
        res = fit()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ex = res.extras
    p1 = gg_programs()
    ran = {k: {f: v[f] - p0.get(k, {}).get(f, 0)
               for f in ("captures", "recaptures", "replays")}
           for k, v in p1.items()}
    ran = {k: v for k, v in ran.items() if any(v.values())}
    rec = {"wall_s": wall, "fit_rows_per_s": rows / wall,
           "boosting_s": ex["boosting_s"],
           "boosting_row_iterations_per_s": rows * iterations
           / ex["boosting_s"],
           "peak_above_base_bytes": torch.cuda.max_memory_allocated() - base,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "base_bytes": base,
           "compiled": {k: v - c0.get(k, 0) for k, v in gg_compiles().items()
                        if v != c0.get(k, 0)},
           "programs_run": ran,
           "captures": sum(v["captures"] for v in ran.values()),
           "recaptures": sum(v["recaptures"] for v in ran.values()),
           "replays": sum(v["replays"] for v in ran.values())}
    if "dispatch_s" in ex:
        rec["host_enqueue_ms_per_iteration"] = \
            ex["dispatch_s"] * 1e3 / iterations
    if profile_fit:
        # the boosting loop's span (``train.boosting``): its device
        # kernels, the graphs' included, and the host's launch calls
        events = prof.events()
        loop = next(e.time_range for e in events
                    if e.name == "train.boosting"
                    and e.device_type != torch.autograd.DeviceType.CUDA)

        def inside(e):
            return loop.start <= e.time_range.start <= loop.end

        device_ms = sum(
            e.time_range.elapsed_us() for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name != "train.boosting"
            and "memcpy" not in e.name.lower() and inside(e)) / 1e3
        rec.update(device_kernel_ms=device_ms,
                   busy_share=device_ms / (ex["boosting_s"] * 1e3),
                   kernel_launch_calls=sum(
                       1 for e in events if e.name == "cudaLaunchKernel"
                       and inside(e)),
                   graph_launch_calls=sum(
                       1 for e in events if e.name == "cudaGraphLaunch"
                       and inside(e)))
    log(f"[gbdt_graphs] {label}: fit {wall:.3f} s = "
        f"{rec['fit_rows_per_s']:.0f} rows/s, boosting "
        f"{ex['boosting_s']:.4f} s = "
        f"{rec['boosting_row_iterations_per_s']:.0f} row-iterations/s"
        + (f", host enqueue {rec['host_enqueue_ms_per_iteration']:.3f} ms "
           f"an iteration" if "host_enqueue_ms_per_iteration" in rec else "")
        + (f", busy share {rec['busy_share']:.3f} "
           f"({rec['device_kernel_ms']:.1f} device ms, "
           f"{rec['kernel_launch_calls']} kernel launches, "
           f"{rec['graph_launch_calls']} graph launches)"
           if profile_fit else "")
        + f"; peak {rec['peak_above_base_bytes'] / 1e6:.1f} MB above "
        f"{base / 1e6:.1f} MB; compiled {rec['compiled']}, captures "
        f"{rec['captures']}, re-captures {rec['recaptures']}, replays "
        f"{rec['replays']}")
    return res, rec


def gg_growth(label: str, X, y, params, want_launches: int) -> dict:
    """(a) One growth mode at the bench width: the replayed fit (its
    captures first, then a second same-shape fit that compiles nothing),
    the eager baseline and the unchunked fit, boosters bit for bit; the
    transform of every row replayed = eager."""
    from mmlspark_tpu_torch.lightgbm import core as LC, train
    rows, iters = len(y), params.num_iterations
    leaf = params.num_leaves is not None

    def fit():
        return train(X, y, params)

    (first, r_first), l_first = counted(
        lambda: gg_fit(f"{label} replayed, first fit", fit, iters, rows,
                       False))
    (second, r_second), l_second = counted(
        lambda: gg_fit(f"{label} replayed, second fit", fit, iters, rows,
                       False))
    if r_second["compiled"]:
        raise AssertionError(f"gbdt_graphs {label}: the second same-shape "
                             f"fit compiled {r_second['compiled']}")
    eager, r_eager = gg_fit(f"{label} eager", fit, iters, rows, True)
    if leaf:
        # the busy share of the boosting loop, eager and replayed, from
        # fits of their own (the profiler's cost stays out of the others;
        # the eager one over 2 of the 8 iterations: its cost grows with
        # its ~3,000 launches a tree)
        r_eager["profile"] = gg_fit(
            f"{label} eager, profiled (2 iterations)",
            lambda: train(X, y, dataclasses.replace(params,
                                                    num_iterations=2)),
            2, rows, True, profile_fit=True)[1]
        r_second["profile"] = gg_fit(f"{label} replayed, profiled", fit,
                                     iters, rows, False,
                                     profile_fit=True)[1]
    os.environ["MMLSPARK_TPU_GBDT_CHUNK"] = "1"
    try:
        (plain, r_plain), l_plain = counted(
            lambda: gg_fit(f"{label} replayed, unchunked", fit, iters, rows,
                           False))
    finally:
        del os.environ["MMLSPARK_TPU_GBDT_CHUNK"]
    for what, b in (("second", second), ("eager", eager),
                    ("unchunked", plain)):
        same_booster(b.booster, first.booster,
                     f"gbdt_graphs {label}: {what} vs the first fit")
    for what, got in (("first", l_first), ("second", l_second),
                      ("unchunked", l_plain)):
        if any(v != want_launches for v in got.values()):
            raise AssertionError(f"gbdt_graphs {label}: {what} fit "
                                 f"launched {got}, want {want_launches}")
    for what, r in (("first", r_first), ("second", r_second)):
        if "lightgbm.multi_iter" not in r["programs_run"]:
            raise AssertionError(f"gbdt_graphs {label}: the {what} fit ran "
                                 f"no chunk ({r['programs_run']})")
    if r_second["captures"] or r_second["recaptures"]:
        raise AssertionError(f"gbdt_graphs {label}: the second fit "
                             f"captured ({r_second['programs_run']})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_replayed = first.booster.predict(X)
    torch.cuda.synchronize()
    t_replayed = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_again = first.booster.predict(X)
    torch.cuda.synchronize()
    t_again = time.perf_counter() - t0
    with LC.eager_programs():
        t0 = time.perf_counter()
        p_eager = first.booster.predict(X)
        torch.cuda.synchronize()
        t_eager = time.perf_counter() - t0
    if not (np.array_equal(p_replayed, p_eager)
            and np.array_equal(p_again, p_eager)):
        raise AssertionError(f"gbdt_graphs {label}: transform replayed != "
                             f"eager")
    log(f"[gbdt_graphs] {label}: boosters first = second = eager = "
        f"unchunked bit for bit; launches {l_first} / {l_second} / "
        f"{l_plain} (first, second, unchunked); transform of {rows} rows "
        f"replayed = eager: first call {t_replayed:.3f} s (captures), "
        f"replayed {t_again:.3f} s = {rows / t_again:.0f} rows/s, eager "
        f"{t_eager:.3f} s = {rows / t_eager:.0f} rows/s")
    return {"first": r_first, "second": r_second, "eager": r_eager,
            "unchunked": r_plain,
            "transform_s": {"first": t_replayed, "replayed": t_again,
                            "eager": t_eager},
            "launches": add_counts(add_counts(l_first, l_second), l_plain)}


def gg_modes(dev) -> dict:
    """(b) Multiclass (3 classes), LambdaRank and DART, leaf-wise at 200,000
    x 200: replayed boosters = eager, bit for bit."""
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train
    X, y = bench_data(GG_MODE_ROWS, seed=5)
    rng = np.random.default_rng(6)
    ymc = np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.5, 0.5]).astype(
        np.float32)
    rel = np.digitize(X[:, 0] + 0.3 * rng.normal(size=len(y)),
                      [-0.5, 0.5, 1.3, 2.1]).astype(np.float32)
    gp = np.arange(0, len(y) + 1, 100)
    out = {}
    for name, labels, pkw, kw in (
            ("multiclass", ymc, dict(objective="multiclass", num_class=3),
             {}),
            ("lambdarank", rel, dict(objective="lambdarank"),
             {"group_ptr": gp}),
            ("dart", y, dict(boosting_type="dart", drop_rate=0.5,
                             skip_drop=0.0), {})):
        params = GBDTParams(num_iterations=8, num_leaves=31, **pkw)

        def fit():
            return train(X, labels, params, **kw)

        first, f = gg_fit(f"(b) {name} replayed, first fit", fit, 8,
                          len(y), False)
        replayed, r = gg_fit(f"(b) {name} replayed, second fit", fit, 8,
                             len(y), False)
        eager, e = gg_fit(f"(b) {name} eager", fit, 8, len(y), True)
        for what, b in (("first", first), ("second", replayed)):
            same_booster(b.booster, eager.booster,
                         f"gbdt_graphs (b) {name}: {what} replayed fit")
        out[name] = {"first": f, "replayed": r, "eager": e}
    return out


def gg_streamed(dev) -> dict:
    """(c) A leaf-wise streamed fit of 4 tiles x 131,072 rows: replayed =
    eager bit for bit, the replayed fit's peak device memory above what
    the script held before it (its graphs captured inside it, every
    earlier graph and idle buffer dropped first) under 150 MB."""
    from mmlspark_tpu_torch.lightgbm import GBDTParams, core as LC, \
        train_streamed
    n = GG_STREAM_TILES * STREAM_TILE
    X, y = bench_data(n, seed=7)
    params = GBDTParams(num_iterations=4, num_leaves=31)

    def fit():
        return train_streamed(X, y, params, tile_rows=STREAM_TILE)

    LC.release_programs()
    (replayed, r), launches = counted(
        lambda: gg_fit("(c) streamed replayed", fit, 4, n, False))
    eager, e = gg_fit("(c) streamed eager", fit, 4, n, True)
    same_booster(replayed.booster, eager.booster, "gbdt_graphs (c) streamed")
    if r["peak_above_base_bytes"] >= 150e6:
        raise AssertionError(f"gbdt_graphs (c): replayed streamed peak "
                             f"{r['peak_above_base_bytes']} B above the "
                             f"held >= 150 MB")
    return {"replayed": r, "eager": e, "launches": launches}


def gg_parity(dev) -> dict:
    """(d) One call sequence on the card and on the CPU, each with empty
    program caches and four iterations a chunk: a leaf-wise fit with a
    valid set, a DART fit and a transform past the host-walk threshold
    book the same compiles under the same names."""
    from mmlspark_tpu_torch.lightgbm import GBDTParams, core as LC, train
    from mmlspark_tpu_torch.models import gbdt as GM
    rng = np.random.default_rng(8)
    X = rng.normal(size=(GG_PARITY_ROWS, 10)).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.normal(size=len(X)) > 0).astype(np.float32)
    Xv, yv = X[:2_000] + 0.1, y[:2_000]
    books = {}
    saved = dict(LC._JIT_CACHE), dict(GM._WALKS)
    os.environ["MMLSPARK_TPU_GBDT_CHUNK"] = "4"
    try:
        for where in ("cuda", "cpu"):
            LC._JIT_CACHE.clear()
            GM._WALKS.clear()
            c0 = gg_compiles()
            res = train(X, y, GBDTParams(num_iterations=8, num_leaves=7),
                        valid=(Xv, yv), device=where)
            train(X, y, GBDTParams(num_iterations=3, num_leaves=7,
                                   boosting_type="dart", drop_rate=0.5,
                                   skip_drop=0.0), device=where)
            res.booster.predict(X, device=where)
            books[where] = {k: v - c0.get(k, 0)
                            for k, v in gg_compiles().items()
                            if v != c0.get(k, 0)}
    finally:
        del os.environ["MMLSPARK_TPU_GBDT_CHUNK"]
        LC._JIT_CACHE.clear()
        LC._JIT_CACHE.update(saved[0])
        GM._WALKS.clear()
        GM._WALKS.update(saved[1])
    if books["cuda"] != books["cpu"] or "lightgbm.multi_iter" not in \
            books["cuda"]:
        raise AssertionError(f"gbdt_graphs (d): compiles on the card "
                             f"{books['cuda']} != on the CPU {books['cpu']}")
    return books


def gbdt_graphs_phase(dev, smi: str):
    """The GBDT family's compiled programs on the card (``lightgbm.iter`` /
    ``iter_pre`` / ``multi_iter`` / ``objective`` / ``valid_update`` /
    ``tree_walk`` / ``lambdarank_grads``, the four ``ooc_*`` programs,
    ``models.gbdt_walk``), each a CUDA graph per signature, against the
    same code with its programs eager (``lightgbm.core.eager_programs``):
    (a) level-wise and leaf-wise at the bench width, (b) multiclass,
    LambdaRank and DART, (c) a streamed fit, (d) the compile book card =
    CPU.  Launches are counted on the replayed fits of (a) and (c)."""
    from mmlspark_tpu_torch.lightgbm import GBDTParams, core as LC
    from mmlspark_tpu_torch.observability import compute
    log(f"[gbdt_graphs] budget {GG_BUDGET_S:.0f} s: (a) level-wise and "
        f"leaf-wise at {N_ROWS:,} x {N_FEAT}, (b) three modes at "
        f"{GG_MODE_ROWS:,}, (c) streamed {GG_STREAM_TILES} x "
        f"{STREAM_TILE:,}, (d) the compile book card = CPU")
    t0 = time.perf_counter()
    # every graph and idle buffer set of the earlier phases dropped: the
    # first fit of each growth mode captures its programs
    LC.release_programs()
    X, y = bench_data(N_ROWS, seed=0)
    rec = {"level": gg_growth("(a) level-wise", X, y, GBDTParams(
        num_iterations=8, max_depth=5, objective="binary"), 8 * 5)}
    rec["leaf"] = gg_growth("(a) leaf-wise", X, y, GBDTParams(
        num_iterations=8, num_leaves=31, objective="binary"), 8 * 31)
    del X, y
    rec["pool_bytes"] = compute.graph_pool_bytes(torch.cuda.current_device())
    rec["programs"] = gg_programs()
    rec["modes"] = gg_modes(dev)
    rec["streamed"] = gg_streamed(dev)
    rec["parity"] = gg_parity(dev)
    rec.update(card=smi, total_s=time.perf_counter() - t0)
    launches = add_counts(add_counts(rec["level"]["launches"],
                                     rec["leaf"]["launches"]),
                          rec["streamed"]["launches"])
    rec["launches"] = launches
    DETAIL["gbdt_graphs"] = rec
    for g in ("level", "leaf"):
        r = rec[g]
        log(f"[gbdt_graphs] {smi} | (a) {g}: fit rows/s eager "
            f"{r['eager']['fit_rows_per_s']:.0f}, replayed "
            f"{r['second']['fit_rows_per_s']:.0f} (first, with captures, "
            f"{r['first']['fit_rows_per_s']:.0f}); boosting "
            f"row-iterations/s eager "
            f"{r['eager']['boosting_row_iterations_per_s']:.0f}, replayed "
            f"{r['second']['boosting_row_iterations_per_s']:.0f}; host "
            f"enqueue ms an iteration eager "
            f"{r['eager']['host_enqueue_ms_per_iteration']:.3f}, replayed "
            f"{r['second']['host_enqueue_ms_per_iteration']:.3f}"
            + (f"; busy share eager "
               f"{r['eager']['profile']['busy_share']:.3f}, replayed "
               f"{r['second']['profile']['busy_share']:.3f}"
               if "profile" in r["eager"] else "")
            + f"; peak MB above the held eager "
            f"{r['eager']['peak_above_base_bytes'] / 1e6:.1f}, replayed "
            f"{r['second']['peak_above_base_bytes'] / 1e6:.1f} (first "
            f"{r['first']['peak_above_base_bytes'] / 1e6:.1f})")
    m = rec["modes"]
    log(f"[gbdt_graphs] {smi} | (b) replayed = eager bit for bit: "
        + "; ".join(f"{k} boosting s eager {v['eager']['boosting_s']:.3f}, "
                    f"replayed {v['replayed']['boosting_s']:.3f} (first, "
                    f"with captures, {v['first']['boosting_s']:.3f})"
                    for k, v in m.items()))
    s = rec["streamed"]
    log(f"[gbdt_graphs] {smi} | (c) streamed {GG_STREAM_TILES} x "
        f"{STREAM_TILE:,}: replayed = eager bit for bit; boosting s eager "
        f"{s['eager']['boosting_s']:.3f}, replayed "
        f"{s['replayed']['boosting_s']:.3f}; peak above the held "
        f"replayed {s['replayed']['peak_above_base_bytes'] / 1e6:.1f} MB "
        f"(< 150), eager {s['eager']['peak_above_base_bytes'] / 1e6:.1f} "
        f"MB (held before: {s['replayed']['base_bytes'] / 1e6:.1f} MB); "
        f"launches {s['launches']}")
    log(f"[gbdt_graphs] {smi} | (d) compiles card = CPU: "
        f"{rec['parity']['cuda']}")
    log(f"[gbdt_graphs] {smi} | capture s per program: " + json.dumps(
        {k: [round(c, 4) for c in v["capture_s"]]
         for k, v in rec["programs"].items() if v["capture_s"]})
        + f"; graph pool {(rec['pool_bytes'] or 0) / 1e6:.1f} MB; phase "
        f"{rec['total_s']:.1f} s (budget {GG_BUDGET_S:.0f} s)")
    return launches


# --------------------------------------------------------------------------
# fleet phase: the training monitor on the kernels, then a serving fleet
# --------------------------------------------------------------------------

FLEET_SCORE_REQUESTS = 1_000
FLEET_CLIENTS = 8
FLEET_STREAM_ROWS = 2 * STREAM_TILE     # train_streamed's 2 tiles
FLEET_KEYS = 50                         # distinct routing keys
MONITOR_STALL_S = 60.0


class ProgressPoller:
    """Polls the live ``/progress`` of a training run's monitor while the
    fit runs on the main thread.  Once the monitor is up it registers it
    with the fleet's ``TopologyService`` (as ``MonitorServer`` does when
    built with ``topology_address``) and, with ``fleet_check``, reads
    ``/fleet/metrics`` and ``/routing`` there before ``checked`` is set."""

    def __init__(self, job: str, topo: str, fleet_check: bool = False):
        import threading
        self.job, self.topo, self.fleet_check = job, topo, fleet_check
        self.readings, self.errors = [], []
        self.checked = threading.Event()
        self.fleet = {}
        self.run = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="chip-smoke-poller")

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(30)

    def _loop(self):
        import urllib.request
        from mmlspark_tpu_torch.observability import (active_monitors,
                                                      get_registry)
        from mmlspark_tpu_torch.observability.federation import \
            parse_prometheus
        from mmlspark_tpu_torch.serving.distributed import _http_json
        mon = None
        while not self._stop.is_set():
            if mon is None:
                mons = [m for m in active_monitors(get_registry())
                        if m.run.job == self.job]
                if not mons:
                    time.sleep(0.0005)
                    continue
                mon, self.run = mons[0], mons[0].run
                try:
                    mon.topology_address = self.topo
                    _http_json(f"{self.topo}/register", mon._registration())
                    mon.registered = True
                    if self.fleet_check:
                        text = urllib.request.urlopen(
                            f"{self.topo}/fleet/metrics?refresh=1",
                            timeout=10).read().decode()
                        values, _, _ = parse_prometheus(text)
                        self.fleet["training_series"] = sorted(
                            f"{n}{dict(ls)}" for (n, ls), _v in
                            values.items() if n.startswith(
                                "mmlspark_training_")
                            and dict(ls).get("job") == self.job)
                        self.fleet["in_routing"] = mon.server_id in \
                            _http_json(f"{self.topo}/routing")
                except Exception as e:  # noqa: BLE001 — reported, gated
                    self.errors.append(f"{type(e).__name__}: {e}")
                self.checked.set()
            try:
                with urllib.request.urlopen(f"{mon.address}/progress",
                                            timeout=5) as r:
                    self.readings.append(json.loads(r.read()))
            except Exception:  # noqa: BLE001 — the monitor stopped
                if self._stop.is_set():
                    break
            time.sleep(0.002)

    def final(self):
        """The last reading: the run's own snapshot (the body ``/progress``
        serves) once the fit has returned."""
        return self.run.progress() if self.run is not None else None


def check_progress(label: str, poller, total: int) -> dict:
    mid = [r for r in poller.readings if 0 < r["step"] < total
           and (r["rows_per_second"] or 0) > 0]
    final = poller.final()
    if poller.errors:
        raise AssertionError(f"fleet (a) {label}: {poller.errors}")
    if not mid:
        raise AssertionError(f"fleet (a) {label}: no /progress reading with "
                             f"0 < step < {total} and rows/s > 0 in "
                             f"{len(poller.readings)}")
    if final is None or final["step"] != total:
        raise AssertionError(f"fleet (a) {label}: last reading {final}")
    return {"readings": len(poller.readings), "mid": mid[0],
            "last_http_step": poller.readings[-1]["step"]
            if poller.readings else None, "final": final}


def fleet_monitored_fits(dev, topo: str):
    """(a) ``train()`` and ``train_streamed()`` leaf-wise with the live
    monitor, registered with the fleet: live progress, the kernels'
    launches, boosters equal to the unmonitored fits'."""
    from mmlspark_tpu_torch.lightgbm import GBDTParams
    X, y = bench_data(N_ROWS, seed=0)
    params = GBDTParams(num_iterations=8, num_leaves=31, objective="binary")
    cache: dict = {}
    # the monitor ticks from the callbacks, which the chunked path calls
    # once a chunk (the reference's contract): the in-memory fits here run
    # one iteration a program, so the poller can see a step mid-way with
    # its rate (a rate needs two ticks)
    os.environ["MMLSPARK_TPU_GBDT_CHUNK"] = "1"
    try:
        return _fleet_monitored_fits(dev, topo, X, y, params, cache)
    finally:
        del os.environ["MMLSPARK_TPU_GBDT_CHUNK"]


def _fleet_monitored_fits(dev, topo: str, X, y, params, cache):
    from mmlspark_tpu_torch.lightgbm import train, train_streamed
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    plain = train(X, y, params, bin_cache=cache)      # bins the data once
    rec = {"boosting_s": {"plain": [plain.extras["boosting_s"]]}}

    with ProgressPoller("lightgbm.train", topo, fleet_check=True) as poll:
        def hold(i, ev):
            # iteration 3's callback waits for the poller's fleet reads,
            # so they land while the run is live and mid-way
            if i == 3 and not poll.checked.wait(60):
                raise AssertionError("fleet (a): the monitor never showed "
                                     "up in active_monitors")
        torch.cuda.synchronize()
        CH.reset_launch_counts()
        mon = train(X, y, params, bin_cache=cache, callbacks=[hold],
                    monitor_port=0, monitor_stall_timeout_s=MONITOR_STALL_S)
        torch.cuda.synchronize()
        launches = CH.launch_counts()
    if launches != {"hist_accumulate": 248, "frontier_finish": 248}:
        raise AssertionError(f"fleet (a): the monitored leaf-wise fit must "
                             f"launch each kernel 248 times, got {launches}")
    rec["progress"] = check_progress("train", poll, 8)
    rec["fleet"] = dict(poll.fleet)
    if not poll.fleet.get("training_series") or poll.fleet["in_routing"]:
        raise AssertionError(f"fleet (a): the trainer must federate and "
                             f"never route: {poll.fleet}")
    booster_diff(mon.booster, plain.booster, "fleet (a) monitored train()")
    # the pace with and without the monitor, in turns (printed, not gated:
    # the host's noise is larger than the tick's cost)
    rec["boosting_s"]["monitored"] = []
    for kind in ("plain", "monitored", "plain", "monitored"):
        kw = {} if kind == "plain" else dict(
            monitor_port=0, monitor_stall_timeout_s=MONITOR_STALL_S)
        res = train(X, y, params, bin_cache=cache, **kw)
        booster_diff(res.booster, plain.booster, f"fleet (a) {kind} fit")
        rec["boosting_s"][kind].append(res.extras["boosting_s"])
    del cache

    Xs, ys = X[:FLEET_STREAM_ROWS], y[:FLEET_STREAM_ROWS]
    Xt, yt = bench_data(100_000, seed=1)
    s_plain, _ = streamed_fit("fleet unmonitored", Xs, ys, Xt, yt, params)
    with ProgressPoller("lightgbm.train_streamed", topo) as spoll:
        s_mon, s_rec = streamed_fit(
            "fleet monitored", Xs, ys, Xt, yt, params, monitor_port=0,
            monitor_stall_timeout_s=MONITOR_STALL_S)
    rec["streamed_progress"] = check_progress("train_streamed", spoll, 8)
    booster_diff(s_mon.booster, s_plain.booster,
                 "fleet (a) monitored train_streamed()")
    # the pace in turns, with no poller (its GETs every 2 ms share the GIL
    # with the prefetch worker and the consumer)
    rec["streamed_boosting_s"] = {"plain": [], "monitored": []}
    for kind in ("monitored", "plain", "plain", "monitored"):
        kw = {} if kind == "plain" else dict(
            monitor_port=0, monitor_stall_timeout_s=MONITOR_STALL_S)
        res = train_streamed(Xs, ys, params, tile_rows=STREAM_TILE, **kw)
        booster_diff(res.booster, s_plain.booster,
                     f"fleet (a) streamed {kind} fit")
        rec["streamed_boosting_s"][kind].append(res.extras["boosting_s"])
    rec["sync_check"] = monitored_grow_sync_check(dev)
    # saabas contributions walk on the card in float64: = the CPU's
    rows = Xt[:1000]
    card = mon.booster.predict_contrib(rows, method="saabas")
    cpu = mon.booster.predict_contrib(rows, method="saabas", device="cpu")
    raw = mon.booster.raw_scores(rows, device="cpu")[:, 0]
    rec["saabas"] = {"card_vs_cpu": float(np.abs(card - cpu).max()),
                     "sum_vs_raw": float(np.abs(cpu.sum(1) - raw).max())}
    if rec["saabas"]["card_vs_cpu"] > 1e-9 or \
            rec["saabas"]["sum_vs_raw"] > 1e-5:
        raise AssertionError(f"fleet (a): saabas {rec['saabas']}")
    return mon.booster, launches, s_rec["launches"], rec


def monitored_grow_sync_check(dev) -> dict:
    """One 31-leaf tree grown on the card inside the drivers' phase scope
    and with a live training monitor ticking, under
    ``torch.cuda.set_sync_debug_mode("error")``: the monitor and the
    ``ambient_phase`` marks add no wait on the card."""
    from mmlspark_tpu_torch.lightgbm import BinMapper, GBDTParams
    from mmlspark_tpu_torch.lightgbm.core import make_leafwise_grower
    from mmlspark_tpu_torch.observability import (ambient_phase,
                                                  start_training_monitor)
    rng = np.random.default_rng(6)
    n, F = 50_000, 20
    X = rng.normal(size=(n, F)).astype(np.float32)
    p = 1 / (1 + np.exp(-rng.normal(scale=0.5, size=n)))
    y = (X[:, 0] - X[:, 1] * X[:, 2] > 0).astype(np.float32)
    mapper = BinMapper(255).fit(X)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    args = (t(mapper.transform(X)).t().contiguous().t(),
            t((p - y).astype(np.float32)),
            t((p * (1 - p)).astype(np.float32)),
            torch.ones(n, dtype=torch.bool, device=dev),
            torch.ones(F, dtype=torch.bool, device=dev), t(mapper.edges))
    grow = make_leafwise_grower(31, 0, F, 255, GBDTParams(
        num_leaves=31, use_quantized_grad=True).resolve())
    noise = t(rng.random((2, 2, n), dtype=np.float32))
    run, srv = start_training_monitor("chip_smoke.sync", total_steps=2,
                                      rows_per_step=n, monitor_port=0)
    try:
        torch.cuda.synchronize()
        for step in (1, 2):
            torch.cuda.set_sync_debug_mode("error")
            try:
                with ambient_phase("lightgbm.histogram"):
                    tree = grow(*args, noise=noise[step - 1])
                run.tick(step=step)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        splits = int((tree.split_feature >= 0).sum())
        step = run.progress()["step"]
    finally:
        srv.stop()
        run.close()
    if step != 2 or splits < 1:
        raise AssertionError(f"fleet (a): sync check step {step}, "
                             f"{splits} splits")
    return {"splits": splits, "sync_debug_mode": "error"}


def gbdt_reply_stage(model):
    """A score worker's stage: the request (one row of features) through a
    port ``LightGBMClassificationModel`` on the card; the reply is the
    class-1 probability."""
    from mmlspark_tpu_torch.core import DataFrame, Transformer
    from mmlspark_tpu_torch.core.schema import vector_column

    class GBDTReply(Transformer):
        def _transform(self, frame):
            def per_part(p):
                feats = vector_column([np.asarray(v, np.float32)
                                       for v in p["request"]])
                out = model.transform(DataFrame.from_dict(
                    {"features": feats})).collect()
                return {**p, "reply": np.asarray(
                    [float(q[1]) for q in out["probability"]])}
            return frame.map_partitions(per_part)

        def transform_schema(self, schema):
            return schema

    return GBDTReply()


def class_router(topo: str, request_class: str, **kw):
    """A ``RoutingClient`` over the workers of one request class: the
    routing table carries every class, and score rows must not land on
    the decode worker."""
    from mmlspark_tpu_torch.serving import RoutingClient

    class ClassRouter(RoutingClient):
        def _refresh(self, force: bool = False):
            super()._refresh(force)
            with self._lock:
                self._table = [w for w in self._table
                               if w.get("request_class") == request_class]

    return ClassRouter(topo, **kw)


def _pct(lats, q):
    s = sorted(lats)
    return 1e3 * s[min(len(s) - 1, int(q * len(s)))]


def fire_threads(fn, n: int, clients: int):
    """``fn(i)`` for i in range(n) from ``clients`` threads; returns the
    per-call (seconds, result or exception) and the wall seconds."""
    import threading
    out = [None] * n

    def worker(k):
        for i in range(k, n, clients):
            t0 = time.perf_counter()
            try:
                r = fn(i)
            except Exception as e:  # noqa: BLE001 — gated by the caller
                r = e
            out[i] = (time.perf_counter() - t0, r)

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    return out, time.perf_counter() - t0


def worker_counts(worker) -> float:
    """Requests a worker's own ``/metrics`` books as replied."""
    import urllib.request
    from mmlspark_tpu_torch.observability.federation import parse_prometheus
    srv = worker.server
    text = urllib.request.urlopen(f"http://{srv.host}:{srv.port}/metrics",
                                  timeout=10).read().decode()
    values, _, _ = parse_prometheus(text)
    return sum(v for (n, ls), v in values.items()
               if n == "mmlspark_serving_requests_total"
               and dict(ls).get("status") == "replied")


def fleet_serving(dev, svc, booster, runner, ref, reqs, ties):
    """(b) three workers behind one ``TopologyService``: score and decode
    through routers, a drain under load, a hard stop, the fleet plane."""
    import threading
    import urllib.error
    import urllib.request
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.lightgbm import LightGBMClassificationModel
    from mmlspark_tpu_torch.observability import MetricsRegistry
    from mmlspark_tpu_torch.observability.federation import \
        parse_prometheus
    from mmlspark_tpu_torch.serving import MembershipWatcher, WorkerServer
    from mmlspark_tpu_torch.serving.distributed import _http_json
    topo = svc.address
    model = LightGBMClassificationModel()
    model.set("booster", booster)
    model.set("classes", [0.0, 1.0])
    rows, _ = bench_data(FLEET_SCORE_REQUESTS, seed=3)
    want = np.asarray([float(q[1]) for q in model.transform(
        DataFrame.from_dict({"features": rows})).collect()["probability"]])
    bodies = [[float(v) for v in r] for r in rows]

    def score_worker(i, gen=0):
        return WorkerServer(gbdt_reply_stage(model), server_id=f"score-{i}",
                            driver_address=topo, port=0,
                            request_class="score", generation=gen,
                            mode="continuous",
                            registry=MetricsRegistry()).start()

    scorer = runner.scorer(mode="decode", continuous=True, report_ttft=True,
                           slots=SERVE_SLOTS, prompt_bucket=SERVE_PROMPT,
                           max_new_tokens=SERVE_NEW, page_size=SERVE_PAGE)
    workers = {"score-0": score_worker(0), "score-1": score_worker(1),
               "decode-0": WorkerServer(
                   scorer, server_id="decode-0", driver_address=topo,
                   port=0, request_class="decode", mode="continuous",
                   registry=MetricsRegistry()).start()}
    shrinks = []
    watcher = MembershipWatcher(topo, poll_s=0.02,
                                on_shrink=shrinks.append)
    watcher.poll_once()
    watcher.start()
    reg = MetricsRegistry()
    score = class_router(topo, "score", registry=reg, hedge=True,
                         refresh_s=0.05)
    decode = class_router(topo, "decode", registry=reg)
    rec = {}
    try:
        for i in range(16):                             # warm both paths
            score.request(bodies[i])
        # 2,000 single-row requests through the router: half round robin,
        # half by key
        def routed(i):
            key = None if i < FLEET_SCORE_REQUESTS // 2 \
                else f"user{i % FLEET_KEYS}"
            return score.request(bodies[i], key=key)

        got, wall = fire_threads(routed, FLEET_SCORE_REQUESTS, FLEET_CLIENTS)
        bad = [r for _, r in got if isinstance(r, Exception)]
        if bad:
            raise AssertionError(f"fleet (b): {len(bad)} routed score "
                                 f"requests failed: {bad[0]!r}")
        err = float(np.abs(np.asarray([r for _, r in got]) - want).max())
        if err > 1e-6:
            raise AssertionError(f"fleet (b): routed replies differ from "
                                 f"the model's transform by {err}")
        lats = [t for t, _ in got]
        rec["routed"] = {"rps": FLEET_SCORE_REQUESTS / wall,
                         "p50_ms": _pct(lats, 0.5),
                         "p99_ms": _pct(lats, 0.99), "max_abs_err": err}
        direct_url = workers["score-0"].address
        got, wall = fire_threads(lambda i: _http_json(direct_url, bodies[i]),
                                 FLEET_SCORE_REQUESTS, FLEET_CLIENTS)
        if any(isinstance(r, Exception) for _, r in got):
            raise AssertionError("fleet (b): a direct score request failed")
        lats = [t for t, _ in got]
        rec["direct"] = {"rps": FLEET_SCORE_REQUESTS / wall,
                         "p50_ms": _pct(lats, 0.5),
                         "p99_ms": _pct(lats, 0.99), "max_abs_err": float(
                             np.abs(np.asarray([r for _, r in got])
                                    - want).max())}
        # the serve phase's 48 trace prompts through the decode router,
        # after one request that starts the worker's engine
        prompts = [r[0].tolist() for r in reqs]
        ref.check(prompts[0], decode.request(prompts[0], timeout=120)[
            "tokens"], "fleet", ties)
        got, wall = fire_threads(lambda i: decode.request(prompts[i],
                                                          timeout=120),
                                 len(prompts), FLEET_CLIENTS)
        for p, (_, r) in zip(prompts, got):
            if isinstance(r, Exception):
                raise AssertionError(f"fleet (b): decode request {r!r}")
            ref.check(p, r["tokens"], "fleet", ties)
        rec["decode"] = {"requests": len(prompts), "wall_s": wall,
                         "ttft_p99_ms": sorted(r["ttft_ms"] for _, r in got)[
                             int(0.99 * len(got))]}
        # federated request counters = the sum of the workers' own
        t0 = time.perf_counter()
        svc.federation_tick()
        rec["federation_tick_ms"] = 1e3 * (time.perf_counter() - t0)
        text = urllib.request.urlopen(f"{topo}/fleet/metrics?refresh=1",
                                      timeout=10).read().decode()
        values, _, _ = parse_prometheus(text)
        fleet_replied = sum(v for (n, ls), v in values.items()
                            if n == "mmlspark_serving_requests_total"
                            and dict(ls).get("status") == "replied")
        own = {sid: worker_counts(w) for sid, w in workers.items()}
        rec["counters"] = {"fleet_replied": fleet_replied, "workers": own}
        if fleet_replied != sum(own.values()) or fleet_replied < \
                2 * FLEET_SCORE_REQUESTS + len(prompts):
            raise AssertionError(f"fleet (b): federated {fleet_replied} != "
                                 f"the workers' own {own}")
        rec["autoscale"] = _http_json(f"{topo}/fleet/autoscale?refresh=1")[
            "classes"]

        # drain score-0 under load: no request fails, the watcher sees it
        # leave, and a new generation takes its place
        stop_load = threading.Event()
        load_out = []

        def load(k):
            i = k
            while not stop_load.is_set():
                try:
                    r = score.request(bodies[i % FLEET_SCORE_REQUESTS])
                    load_out.append(abs(r - want[i % FLEET_SCORE_REQUESTS]))
                except Exception as e:  # noqa: BLE001 — gated below
                    load_out.append(e)
                i += FLEET_CLIENTS

        loaders = [threading.Thread(target=load, args=(k,))
                   for k in range(FLEET_CLIENTS)]
        for t in loaders:
            t.start()
        time.sleep(0.5)
        ok = workers["score-0"].drain(timeout_s=30.0)
        deadline = time.monotonic() + 10
        while not shrinks and time.monotonic() < deadline:
            time.sleep(0.01)
        workers["score-0"] = score_worker(0, gen=1)
        time.sleep(0.5)
        stop_load.set()
        for t in loaders:
            t.join(60)
        failed = [r for r in load_out if isinstance(r, Exception)]
        rec["drain"] = {"verdict": ok, "requests": len(load_out),
                        "failed": len(failed), "shrinks": list(shrinks)}
        if not ok or failed or not shrinks or \
                shrinks[0]["lost"] != ["score-0"] or \
                max(load_out) > 1e-6:
            raise AssertionError(f"fleet (b): drain {rec['drain']} "
                                 f"{failed[:1]}")

        # stop score-1 hard (socket gone, still registered): its breaker
        # opens, every request fails over, the fleet plane still answers
        workers["score-1"].server.stop()
        got, _ = fire_threads(lambda i: score.request(bodies[i]), 200,
                              FLEET_CLIENTS)
        bad = [r for _, r in got if isinstance(r, Exception)]
        state = score.breakers["score-1"].state \
            if "score-1" in score.breakers else None
        failovers = sum(v for (n, ls), v in parse_prometheus(
            reg.to_prometheus())[0].items()
            if n == "mmlspark_routing_failovers_total")
        rec["hard_stop"] = {"failed": len(bad), "breaker": state,
                            "failovers": failovers}
        if bad or state != "open" or failovers < 1:
            raise AssertionError(f"fleet (b): hard stop {rec['hard_stop']}")
        ends = {}
        for path, limit in (("/fleet/slow?k=5&deadline_ms=2000", 2.0),
                            ("/fleet/metrics?refresh=1&deadline_ms=3000",
                             3.0),
                            ("/fleet/slo?refresh=1", 3.0),
                            ("/fleet/autoscale?refresh=1", 3.0),
                            ("/fleet/capacity?refresh=1&deadline_ms=3000",
                             3.0),
                            ("/fleet/trace/" + "0" * 32 + "?deadline_ms=2000",
                             2.0),
                            ("/fleet/dump", 5.0),
                            ("/fleet/membership", 1.0)):
            t0 = time.perf_counter()
            try:
                status = urllib.request.urlopen(f"{topo}{path}",
                                                timeout=30).status
            except urllib.error.HTTPError as e:
                status = e.code
            s = time.perf_counter() - t0
            ends[path.split("?")[0]] = {"status": status, "s": s}
            ok_status = (200, 404) if path.startswith("/fleet/trace") \
                else (200,)
            if status not in ok_status or s > limit + 1.0:
                raise AssertionError(f"fleet (b): {path} -> {status} in "
                                     f"{s:.2f} s")
        rec["endpoints"] = ends
        rec["hedges"] = {dict(ls).get("outcome"): v for (n, ls), v in
                         parse_prometheus(reg.to_prometheus())[0].items()
                         if n == "mmlspark_hedges_total"}
    finally:
        watcher.stop()
        for w in workers.values():
            w.stop()
        scorer.continuous_close()
    held = runner.page_pool(SERVE_PAGE).pages_in_use()
    if held:
        raise AssertionError(f"fleet (b): {held} pages held after stop()")
    return rec


def fleet_phase(dev, smi: str, served=None):
    """(a) the training monitor on the kernels, (b) a fleet on one card;
    ``served`` is the serve phase's (runner, one-shot reference, trace)."""
    import threading
    from mmlspark_tpu_torch.observability import MetricsRegistry
    from mmlspark_tpu_torch.serving import TopologyService
    before = {t.ident for t in threading.enumerate()}
    t0 = time.perf_counter()
    if served is None:
        from mmlspark_tpu_torch.models import ModelRunner, TransformerEncoder
        lm = TransformerEncoder(**SEQ_LM,
                                generator=torch.Generator().manual_seed(60))
        runner = ModelRunner(module=lm, name="serve", device=dev)
        served = (runner, OneShot(runner, SERVE_PAGE),
                  serve_trace(SEQ_LM["vocab_size"]))
    runner, ref, reqs = served
    ties: list = []
    svc = TopologyService(registry=MetricsRegistry()).start()
    try:
        booster, leaf, streamed, mon = fleet_monitored_fits(dev,
                                                            svc.address)
        t_a = time.perf_counter() - t0
        serving = fleet_serving(dev, svc, booster, runner, ref, reqs, ties)
    finally:
        svc.stop()
    deadline = time.monotonic() + 30
    alive = [t for t in threading.enumerate() if t.ident not in before]
    while alive and time.monotonic() < deadline:
        time.sleep(0.05)
        alive = [t for t in threading.enumerate() if t.ident not in before]
    if alive:
        raise AssertionError(f"fleet: threads left alive after stop(): "
                             f"{sorted(t.name for t in alive)}")
    DETAIL["fleet"] = {"card": smi, "monitored": mon, "serving": serving,
                       "near_ties": ties,
                       "seconds": {"a": t_a,
                                   "total": time.perf_counter() - t0}}
    bs = mon["boosting_s"]
    p = mon["progress"]
    log(f"[fleet] {smi} | (a) monitored train() leaf-wise 1M x 200: "
        f"launches {leaf}; /progress {p['readings']} readings, first "
        f"mid-run step {p['mid']['step']} at "
        f"{p['mid']['rows_per_second']:.0f} rows/s, last step "
        f"{p['final']['step']}; federated "
        f"{len(mon['fleet']['training_series'])} training series, in "
        f"/routing {mon['fleet']['in_routing']}; booster = unmonitored; "
        f"boosting_s plain "
        + " / ".join(f"{v:.3f}" for v in bs["plain"]) + ", monitored "
        + " / ".join(f"{v:.3f}" for v in bs["monitored"])
        + f"; streamed 262,144 rows in 2 tiles: launches {streamed}, "
        f"booster = unmonitored, boosting_s in turns plain "
        + " / ".join(f"{v:.3f}" for v in mon["streamed_boosting_s"]["plain"])
        + ", monitored "
        + " / ".join(f"{v:.3f}"
                     for v in mon["streamed_boosting_s"]["monitored"])
        + f"; saabas card = CPU "
        f"within {mon['saabas']['card_vs_cpu']:.1e}")
    r, d = serving["routed"], serving["direct"]
    log(f"[fleet] {smi} | (b) {FLEET_SCORE_REQUESTS} score requests from "
        f"{FLEET_CLIENTS} threads: routed {r['rps']:.0f} rps p50 "
        f"{r['p50_ms']:.2f} ms p99 {r['p99_ms']:.2f} ms (max |err| "
        f"{r['max_abs_err']:.1e}), direct {d['rps']:.0f} rps p50 "
        f"{d['p50_ms']:.2f} ms p99 {d['p99_ms']:.2f} ms; decode "
        f"{serving['decode']['requests']} prompts = one-shot (near-ties "
        f"{len(ties)}), TTFT p99 {serving['decode']['ttft_p99_ms']:.1f} ms; "
        f"federation_tick {serving['federation_tick_ms']:.1f} ms, "
        f"federated replied {serving['counters']['fleet_replied']:.0f} = "
        f"the workers' own; drain {serving['drain']['requests']} requests "
        f"under load, {serving['drain']['failed']} failed, watcher saw "
        f"{serving['drain']['shrinks'][0]['lost']} leave; hard stop: "
        f"breaker {serving['hard_stop']['breaker']}, "
        f"{serving['hard_stop']['failovers']:.0f} failovers, 0 failed; "
        f"hedges {serving['hedges']}; autoscale "
        + ", ".join(f"{c}: {v.get('current')} -> {v.get('desired')} "
                    f"({v.get('reason')})"
                    for c, v in serving['autoscale'].items()))
    return {"monitored_leaf": leaf, "monitored_streamed": streamed}


# ---------------------------------------------------------------------------
# phase 15: the histogram backends and the streamed tiles' transfer bytes
# ---------------------------------------------------------------------------

BACKEND_ROWS = 200_000          # train() under each backend: 200k x 200
BACKEND_ITERS = 4
BACKEND_ENV = ("MMLSPARK_TPU_HIST_BACKEND", "MMLSPARK_TPU_HIST_QUANT")
OOC_SITE = "lightgbm.ooc_tile"


@contextlib.contextmanager
def hist_env(**values):
    """Set the ``MMLSPARK_TPU_HIST_<KEY>`` variables given (None: unset)
    for the body and put every one back as it was after."""
    saved = {k: os.environ.get(k) for k in BACKEND_ENV}
    try:
        for key, v in values.items():
            name = f"MMLSPARK_TPU_HIST_{key}"
            if v is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def backend_builds(dev) -> dict:
    """(a) The builds at the bench shape's level-4 step (1M x 200 x 255,
    16 gradient levels, 8 parents, the smaller children's 500,000 rows):
    the quantized matmul build bit-identical to ``hist_accumulate``'s
    decoded lanes and to the scatter build; the float matmul build within
    1e-5 of the float scatter build relative to each cell's sum of
    magnitudes, TF32 left on by the caller; each timed (CUDA events)."""
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    from mmlspark_tpu_torch.ops import histogram as TH
    n, F, B, P = N_ROWS, N_FEAT, N_BINS, 8
    gen = torch.Generator(device=dev).manual_seed(150)
    binned = torch.randint(0, B, (F, n), generator=gen, device=dev,
                           dtype=torch.uint8).t()         # feature-major
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev) * 0.25 + 1e-3
    qg, qh, _, _ = TH.quantize_gradients(g, h, QUANT_BINS, generator=gen)
    small = torch.randperm(n, generator=gen, device=dev)[: n // 2]
    ids = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ids[small] = torch.randint(0, P, (n // 2,), generator=gen, device=dev,
                               dtype=torch.int32)
    bound = n // 2 + 2 * P                  # the grower's level-4 max_rows
    qg8, qh8 = CH.to_int8(qg), CH.to_int8(qh)
    lay = CH.lane_layout(n, bound, QUANT_BINS)

    def kernel():
        return CH.frontier_finish(CH.hist_accumulate(
            binned, qg8, qh8, ids, P, B, lay), *lay)[0]

    def scatter():
        return TH.build_histograms_quantized(binned, qg, qh, ids, P, B,
                                             QUANT_BINS, bound, bound)

    def matmul():
        return TH.build_histograms_matmul_quantized(binned, qg, qh, ids, P,
                                                    B, QUANT_BINS,
                                                    max_rows=bound)

    hk, hs, hm = kernel(), scatter(), matmul()
    torch.cuda.synchronize()
    if not (torch.equal(hm, hk) and torch.equal(hm, hs)):
        raise AssertionError("backends (a): the quantized matmul build is "
                             "not bit-identical to hist_accumulate's lanes "
                             "and the scatter build")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True   # the build turns it off
    try:
        fm = TH.build_histograms_matmul(binned, g, h, ids, P, B,
                                        max_rows=bound)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if torch.backends.cuda.matmul.allow_tf32 != tf32:
        raise AssertionError("backends (a): the TF32 flag was not restored")
    fs = TH.build_histograms(binned, g, h, ids, P, B)
    mag = TH.build_histograms(binned, g.abs(), h.abs(), ids, P, B)
    rel = ((fm - fs).abs() / mag.clamp_min(1e-30)).amax(dim=(0, 1, 2))
    rel = [float(v) for v in rel.cpu()]
    if max(rel) > 1e-5:
        raise AssertionError(f"backends (a): float matmul vs scatter "
                             f"{rel} of the cells' magnitudes (> 1e-5)")
    del fm, fs, mag

    def accumulate():
        return CH.hist_accumulate(binned, qg8, qh8, ids, P, B, lay)

    def float_matmul():
        return TH.build_histograms_matmul(binned, g, h, ids, P, B,
                                          max_rows=bound)

    def float_scatter():
        return TH.build_histograms(binned, g, h, ids, P, B)

    times = {"hist_accumulate": time_ms(accumulate, 20),
             "kernels_build": time_ms(kernel, 20),
             "matmul_quantized": time_ms(matmul, 3),
             "scatter_quantized": time_ms(scatter, 3),
             "matmul_float": time_ms(float_matmul, 3),
             "scatter_float": time_ms(float_scatter, 3)}
    rec = {"shape": [n, F, B, P], "active_rows": n // 2,
           "quantized_bit_identical": True,
           "float_matmul_vs_scatter_rel": rel, "ms": times}
    log("[backends] (a) level-4 step at 1M x 200 x 255, 8 parents, "
        f"500,000 rows: matmul_quantized = hist_accumulate's lanes = "
        f"scatter, bit for bit; float matmul vs scatter "
        + "/".join(f"{v:.2e}" for v in rel)
        + " of the cells' (|g|, |h|, count) sums (TF32 off inside); ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return rec


def backend_boosters(a, b, what: str) -> str:
    """``b`` against the reference ``a``: the tree structure equal, or
    parted first at a node whose two split gains lie within 1e-6 relative
    (an f32 near-tie, reported; the trees after it are not compared);
    where the structure is equal, the float arrays within rtol 1e-6.
    Returns "k/n arrays bit-identical" or the near-tie."""
    struct = ("split_feature", "threshold_bin", "left_child", "right_child")
    diff = np.zeros_like(a.split_feature, dtype=bool)
    for k in struct:
        diff |= getattr(a, k) != getattr(b, k)
    if diff.any():
        t, i = np.argwhere(diff)[0]
        ga, gb = float(a.split_gain[t, i]), float(b.split_gain[t, i])
        if abs(ga - gb) > 1e-6 * abs(ga):
            raise AssertionError(f"{what}: trees part at tree {t} node {i} "
                                 f"with gains {ga} / {gb}, not a near-tie")
        return f"near-tie at tree {t} node {i} (gains {ga} / {gb})"
    same = 0
    for k in BOOSTER_ARRAYS:
        x, y = getattr(a, k), getattr(b, k)
        np.testing.assert_allclose(y, x, rtol=1e-6, atol=0,
                                   err_msg=f"{what}: {k}")
        same += bool(np.array_equal(x, y))
    return f"{same}/{len(BOOSTER_ARRAYS)} arrays bit-identical"


def backend_fits(dev):
    """(b) ``train()`` at 200k x 200, 4 iterations, leaf-wise and
    ``max_depth=5``, under ``MMLSPARK_TPU_HIST_BACKEND`` unset, ``pallas``,
    ``matmul`` and ``scatter``: the kernels launched 4 x 31 and 4 x 5 times
    under the first two and never under the others, every booster the
    unset one's (near-tie rule); ``MMLSPARK_TPU_HIST_QUANT=off`` the float
    path (no quantizer call, no launch).  Returns the launches of the
    main-path fits (unset and ``pallas``) and the record."""
    from mmlspark_tpu_torch.lightgbm import GBDTParams, core as LC, train
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    X, y = bench_data(BACKEND_ROWS, seed=150)
    cache: dict = {}
    train(X, y, GBDTParams(num_iterations=1, max_depth=2,
                           objective="binary"), bin_cache=cache)
    main = {"hist_accumulate": 0, "frontier_finish": 0}
    rec = {}
    for growth, shape, steps in (("leaf", {"num_leaves": 31}, 31),
                                 ("level", {"max_depth": 5}, 5)):
        params = GBDTParams(num_iterations=BACKEND_ITERS,
                            objective="binary", **shape)
        fits = {}
        for env in ("unset", "pallas", "matmul", "scatter"):
            with hist_env(BACKEND=None if env == "unset" else env):
                torch.cuda.synchronize()
                CH.reset_launch_counts()
                t0 = time.perf_counter()
                res = train(X, y, params, bin_cache=cache)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = CH.launch_counts()
            want = BACKEND_ITERS * steps if env in ("unset", "pallas") else 0
            if launches != {"hist_accumulate": want, "frontier_finish": want}:
                raise AssertionError(f"backends (b) {growth} {env}: "
                                     f"launches {launches}, want {want}")
            if want:
                for k in main:
                    main[k] += launches[k]
            fits[env] = res
            rec[f"{growth}_{env}"] = {
                "launches": launches, "wall_s": wall,
                "boosting_s": res.extras["boosting_s"],
                "vs_unset": "reference" if env == "unset" else
                backend_boosters(fits["unset"].booster, res.booster,
                                 f"backends (b) {growth} {env}")}
        calls = []
        real = LC.hist_ops.quantize_gradients
        LC.hist_ops.quantize_gradients = \
            lambda *a, **k: calls.append(1) or real(*a, **k)
        try:
            with hist_env(QUANT="off", BACKEND=None):
                CH.reset_launch_counts()
                res = train(X, y, params, bin_cache=cache)
                torch.cuda.synchronize()
                launches = CH.launch_counts()
        finally:
            LC.hist_ops.quantize_gradients = real
        if calls or any(launches.values()):
            raise AssertionError(f"backends (b) {growth} QUANT=off: "
                                 f"{len(calls)} quantizer calls, launches "
                                 f"{launches}")
        rec[f"{growth}_quant_off"] = {"launches": launches,
                                      "quantizer_calls": 0,
                                      "boosting_s": res.extras["boosting_s"]}
        log(f"[backends] (b) {growth}-wise train() 200k x 200, "
            f"{BACKEND_ITERS} iterations: "
            + "; ".join(f"{env} {rec[f'{growth}_{env}']['launches']['hist_accumulate']} "
                        f"launches, boosting_s "
                        f"{rec[f'{growth}_{env}']['boosting_s']:.3f}, "
                        f"{rec[f'{growth}_{env}']['vs_unset']}"
                        for env in ("unset", "pallas", "matmul", "scatter"))
            + f"; QUANT=off: float path, 0 launches, boosting_s "
            f"{rec[f'{growth}_quant_off']['boosting_s']:.3f}")
    if any(os.environ.get(k) is not None for k in BACKEND_ENV):
        raise AssertionError("backends (b): the environment was not "
                             "restored")
    return main, rec


def backend_streamed(dev):
    """(c) The leaf-wise streamed fit on the bench data's first 262,144
    rows in 2 tiles books ``mmlspark_device_transfer_bytes_total
    {site="lightgbm.ooc_tile"}``: at least 262,144 x 200 bytes per
    histogram pass,
    the stager's own count; its booster equals the same fit's with the
    tiles copied as before the booking (``device_put`` replaced by the
    bare copy); ``device_put`` of a pinned tile runs under sync debug
    mode "error"."""
    from mmlspark_tpu_torch.lightgbm import GBDTParams, core as LC, \
        train_streamed
    from mmlspark_tpu_torch.observability import get_registry
    from mmlspark_tpu_torch.observability.compute import device_put
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    X, y = bench_data(N_ROWS, seed=0)
    Xs, ys = X[:FLEET_STREAM_ROWS], y[:FLEET_STREAM_ROWS]
    del X, y
    params = GBDTParams(num_iterations=BACKEND_ITERS, num_leaves=31,
                        objective="binary")

    def booked() -> float:
        fam = get_registry().family("mmlspark_device_transfer_bytes_total")
        if fam is None:
            return 0.0
        return {k[0]: c.value for k, c in fam._snapshot()}.get(OOC_SITE, 0.0)

    def bare(x, device=None, *, site=None, registry=None,
             non_blocking=False):
        return [t.to(device, non_blocking=non_blocking) for t in x]

    LC.device_put = bare
    try:
        b0 = booked()
        ref = train_streamed(Xs, ys, params, tile_rows=STREAM_TILE)
        if booked() != b0:
            raise AssertionError("backends (c): the bare copy booked bytes")
    finally:
        LC.device_put = device_put
    b0 = booked()
    torch.cuda.synchronize()
    CH.reset_launch_counts()
    res = train_streamed(Xs, ys, params, tile_rows=STREAM_TILE)
    torch.cuda.synchronize()
    launches = CH.launch_counts()
    moved = booked() - b0
    ex = res.extras
    # every histogram pass stages the binned tiles (and what rides with
    # them); the gradient passes stage no bins
    passes = ex["hist_passes"]
    per_pass = moved / passes
    if per_pass < FLEET_STREAM_ROWS * N_FEAT or moved != ex["h2d_bytes"]:
        raise AssertionError(f"backends (c): {moved} bytes booked under "
                             f"{OOC_SITE} over {passes:.0f} histogram "
                             f"passes, the stager moved {ex['h2d_bytes']}")
    want = ex["hist_passes"] * ex["num_tiles"]
    if any(v != want for v in launches.values()):
        raise AssertionError(f"backends (c): launches {launches}, want "
                             f"{want}")
    booster_diff(res.booster, ref.booster, "backends (c) booked vs bare")
    pinned = [torch.empty((N_FEAT, STREAM_TILE), dtype=torch.uint8,
                          pin_memory=True),
              torch.empty(STREAM_TILE, dtype=torch.int32, pin_memory=True)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = device_put(pinned, dev, site="chip_smoke.sync_check",
                         non_blocking=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    del out, pinned
    rec = {"rows": FLEET_STREAM_ROWS, "tiles": ex["num_tiles"],
           "hist_passes": passes, "grad_passes": ex["grad_passes"],
           "booked_bytes": moved,
           "booked_per_pass": per_pass,
           "booked_per_row_pass": per_pass / FLEET_STREAM_ROWS,
           "launches": launches, "vs_bare_copy": "bit-identical",
           "device_put_sync_debug": "error"}
    log(f"[backends] (c) streamed leaf-wise 262,144 x 200 in "
        f"{ex['num_tiles']:.0f} tiles: {moved / 1e6:.1f} MB booked under "
        f"{OOC_SITE} over {passes:.0f} histogram passes (and "
        f"{ex['grad_passes']:.0f} gradient passes) = {per_pass / 1e6:.2f} MB "
        f"a pass ({per_pass / FLEET_STREAM_ROWS:.1f} bytes a row), = the "
        f"stager's h2d_bytes; launches {launches}; booster = the bare "
        f"copy's in every array; device_put under sync debug \"error\"")
    return launches, rec


def backends_phase(dev, smi: str):
    t0 = time.perf_counter()
    builds = backend_builds(dev)
    main, fits = backend_fits(dev)
    s_launches, streamed = backend_streamed(dev)
    for k in main:
        main[k] += s_launches[k]
    DETAIL["backends"] = {"card": smi, "builds": builds, "fits": fits,
                          "streamed": streamed,
                          "seconds": time.perf_counter() - t0}
    return main


# ---------------------------------------------------------------------------
# phase 16: VowpalWabbit (BASELINE config 4)
# ---------------------------------------------------------------------------

VW_VOCAB = 100_000               # Zipf(1.1) vocabulary of the tweets
VW_TRAIN, VW_HELD = 400_000, 100_000   # a quarter of Sentiment140's 1.6M
VW_PLANTED = 2_000               # planted sentiment words (label model)
VW_PLANTED_FROM = 10             # ... among ranks 10-2,009 (the 10 most
VW_PLANTED_SCALE = 1.5           # frequent are stopwords), weights N(0, 1.5^2)
VW_BITS, VW_WIDE_BITS = 18, 24
VW_SIDE_ROWS = 100_000           # --bfgs, the -q regressor, the bandit
VW_PROFILE_STEPS = 50
VW_ACTIONS = 4


def vw_vocab() -> np.ndarray:
    return np.asarray([f"w{i}" for i in range(VW_VOCAB)], dtype=object)


def vw_tweets(n: int, seed: int):
    """``n`` synthetic tweets: 5-30 whitespace tokens drawn from the
    Zipf(1.1) vocabulary; the label drawn from a logistic model whose
    logit sums the planted words' weights (the token counts' dot), so
    ``p`` is each tweet's true probability.  Returns (text, label, p)."""
    rng = np.random.default_rng(seed)
    pz = np.arange(1, VW_VOCAB + 1, dtype=np.float64) ** -1.1
    pz /= pz.sum()
    prng = np.random.default_rng(160)
    w_true = np.zeros(VW_VOCAB)
    planted = prng.choice(np.arange(VW_PLANTED_FROM,
                                    VW_PLANTED_FROM + VW_PLANTED),
                          VW_PLANTED, replace=False)
    w_true[planted] = prng.normal(scale=VW_PLANTED_SCALE, size=VW_PLANTED)
    lengths = rng.integers(5, 31, size=n)
    tok = rng.choice(VW_VOCAB, size=int(lengths.sum()), p=pz)
    off = np.concatenate([[0], np.cumsum(lengths)])
    logit = np.add.reduceat(w_true[tok], off[:-1])
    logit -= np.median(logit)
    p = 1.0 / (1.0 + np.exp(-logit))
    y = (rng.random(n) < p).astype(np.float64)
    words = vw_vocab()[tok]
    text = np.empty(n, dtype=object)
    for i in range(n):
        text[i] = " ".join(words[off[i]:off[i + 1]])
    return text, y, p


def vw_featurize(text: np.ndarray, bits: int):
    """The port's ``VowpalWabbitFeaturizer`` on the tweets (the ``text``
    column split on whitespace, ``num_bits`` = ``bits``): the features
    column and the seconds it took."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.vw import VowpalWabbitFeaturizer
    feat = VowpalWabbitFeaturizer(input_cols=["text"], output_col="features",
                                  string_split_cols=["text"], num_bits=bits)
    t0 = time.perf_counter()
    col = feat.transform(DataFrame.from_dict({"text": text})) \
        .collect()["features"]
    return col, time.perf_counter() - t0


def _wide_features(conn) -> None:
    """A child process: the same tweets featurized at 24 bits, sent back as
    CSR arrays (the parent featurizes at 18 bits meanwhile)."""
    out = []
    for n, seed in ((VW_TRAIN, 161), (VW_HELD, 162)):
        col, _ = vw_featurize(vw_tweets(n, seed)[0], VW_WIDE_BITS)
        lens = np.fromiter((len(v["indices"]) for v in col), np.int64, n)
        out.append((np.concatenate([[0], np.cumsum(lens)]),
                    np.concatenate([v["indices"] for v in col]),
                    np.concatenate([v["values"] for v in col])))
    conn.send(out)
    conn.close()


def _csr_column(csr) -> np.ndarray:
    off, idx, val = csr
    col = np.empty(len(off) - 1, dtype=object)
    for i in range(len(col)):
        col[i] = {"indices": idx[off[i]:off[i + 1]],
                  "values": val[off[i]:off[i + 1]]}
    return col


def vw_frames(col_tr, y_tr, col_ho, y_ho):
    from mmlspark_tpu_torch.core import DataFrame
    return (DataFrame.from_dict({"features": col_tr, "label": y_tr}),
            DataFrame.from_dict({"features": col_ho, "label": y_ho}))


def vw_auc(model, df_ho) -> float:
    """Held-out AUC through the port's ``ComputeModelStatistics``."""
    from mmlspark_tpu_torch.train import ComputeModelStatistics
    stats = ComputeModelStatistics().set_params(
        label_col="label", scored_probabilities_col="probability",
        evaluation_metric="classification").transform(
            model.transform(df_ho)).collect()
    return float(stats["AUC"][0])


def vw_card_vs_cpu(card, cpu, what: str) -> dict:
    """max |w_card - w_cpu| <= 1e-4 max |w_cpu|."""
    wc, wh = card.weights, cpu.weights
    dw = float(np.abs(wc - wh).max())
    scale = float(np.abs(wh).max())
    if not np.isfinite(wc).all() or dw > 1e-4 * scale:
        raise AssertionError(f"vw {what}: card vs CPU max |dw| {dw} > "
                             f"1e-4 x {scale}")
    return {"max_abs_dw": dw, "max_abs_w": scale,
            "rel": dw / max(scale, 1e-30)}


def vw_fit_pair(est_cls, df, what: str, eager: bool = False, **params):
    """One fit on the card (its wall, peak memory, the Hopper kernels'
    launches) and the same on the CPU, the weights held as
    ``vw_card_vs_cpu`` holds them; with ``eager``, the card fit again with
    its step eager (``eager_plain_programs``), the replayed weights held
    to it within 1e-4 x max|w|."""
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    from mmlspark_tpu_torch.vw import learners
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    card = est_cls().set_params(**params).fit(df)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    cpu = est_cls().set_params(device="cpu", **params).fit(df)
    cpu_wall = time.perf_counter() - t0
    out = {"card_fit_s": wall, "cpu_fit_s": cpu_wall, "peak_bytes": peak,
           **vw_card_vs_cpu(card, cpu, what)}
    if eager:
        with eager_plain_programs(learners):
            t0 = time.perf_counter()
            out["eager_model"] = est_cls().set_params(**params).fit(df)
            torch.cuda.synchronize()
            out["eager_fit_s"] = time.perf_counter() - t0
        we = out["eager_model"].weights
        dw = float(np.abs(card.weights - we).max())
        scale = float(np.abs(we).max())
        if dw > 1e-4 * scale:
            raise AssertionError(f"vw {what}: replayed vs eager max |dw| "
                                 f"{dw} > 1e-4 x {scale}")
        out["replayed_vs_eager_rel"] = dw / max(scale, 1e-30)
    if any(CH.launch_counts().values()):
        raise AssertionError(f"vw {what}: a Hopper kernel was launched")
    return card, cpu, out


def vw_step_profile(dev, df, bits: int) -> dict:
    """The SGD step alone over the fit's own minibatches (the estimator's
    ``_make_trainer`` and staging), eager (the step's function) and
    replayed (its captured program, the fit's path): host enqueue ms a
    step beside device ms a step (CUDA events), steps/s and learn rows/s,
    and from a ``torch.profiler`` window over 50 steps the kernels and
    device busy ms a step; the bytes a step must move (the batch's
    indices and values read once, and read + write of weights, gsq and
    xmax at the batch's distinct indices) against the step's time."""
    from torch.profiler import ProfilerActivity, profile
    from mmlspark_tpu_torch.vw import VowpalWabbitClassifier
    from mmlspark_tpu_torch.vw.learners import _Staged, pack_sparse_column
    est = VowpalWabbitClassifier().set_params(num_bits=bits)
    step, D = est._make_trainer("logistic")
    data = df.collect()
    idx, val = pack_sparse_column(data["features"], mask=D - 1)
    y = np.where(data["label"] > 0, 1.0, -1.0).astype(np.float32)
    bs = est.get("batch_size")
    sp = _Staged(idx, val, y, np.ones(len(y), np.float32), bs, dev)
    batches = [b[1:] for b in sp.batches(bs)]
    steps = len(batches)
    k = idx.shape[1]
    uniq = np.mean([len(np.unique(idx[s:s + bs]))
                    for s in range(0, len(y), bs)])
    step_bytes = bs * k * (8 + 4) + bs * 8 + uniq * 3 * 8
    out = {"steps": steps, "rows": len(y), "nnz_width": k,
           "distinct_indices_per_step": float(uniq),
           "step_bytes": float(step_bytes),
           "step_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3}
    for mode, fn in (("eager", step._fn), ("replayed", step)):
        state = tuple(torch.zeros(D, device=dev) for _ in range(3))
        fn(state, *batches[0], None)         # the replayed one: its capture
        t = time_program(lambda *b: fn(state, *b, None), batches)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for b in batches[:VW_PROFILE_STEPS]:
                fn(state, *b, None)
            torch.cuda.synchronize()
        kernels, busy_us = 0, 0.0
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                kernels += evt.count
                busy_us += evt.self_device_time_total
        step_ms = t["device_ms"]
        out[mode] = {"host_enqueue_ms_per_step": t["host_enqueue_ms"],
                     "device_ms_per_step": step_ms,
                     "steps_per_s": 1e3 / step_ms,
                     "learn_rows_per_s": bs * 1e3 / step_ms,
                     "kernels_per_step": kernels / VW_PROFILE_STEPS,
                     "device_busy_ms_per_step":
                         busy_us / 1e3 / VW_PROFILE_STEPS,
                     "hbm_share": step_bytes / (step_ms / 1e3)
                     / HBM_BYTES_PER_S}
    out["program"] = program_stats(step)
    return out


def vw_step_line(prof: dict) -> str:
    """The step profile's eager and replayed figures, for the log."""
    e, r = prof["eager"], prof["replayed"]
    return (f"{prof['steps']} steps; host enqueue "
            f"{e['host_enqueue_ms_per_step']:.4f} ms eager, "
            f"{r['host_enqueue_ms_per_step']:.4f} ms replayed, beside "
            f"device {e['device_ms_per_step']:.4f} / "
            f"{r['device_ms_per_step']:.4f} ms a step (busy "
            f"{e['device_busy_ms_per_step']:.4f} / "
            f"{r['device_busy_ms_per_step']:.4f} ms in "
            f"{e['kernels_per_step']:.1f} / {r['kernels_per_step']:.1f} "
            f"device ops); learn {r['learn_rows_per_s']:,.0f} rows/s "
            f"replayed")


def vw_objective(weights, df, l1=0.0, l2=0.0) -> float:
    """The --bfgs objective of ``weights`` in float64 on the host."""
    from mmlspark_tpu_torch.vw.learners import pack_sparse_column
    data = df.collect()
    idx, val = pack_sparse_column(data["features"], mask=len(weights) - 1)
    pred = (weights[idx].astype(np.float64) * val).sum(1)
    ysgn = np.where(data["label"] > 0, 1.0, -1.0)
    w64 = weights.astype(np.float64)
    return float(np.mean(np.logaddexp(0.0, -ysgn * pred))
                 + 0.5 * l2 * (w64 ** 2).sum() + l1 * np.abs(w64).sum())


def vw_namespaces(n: int, seed: int):
    """Two namespace columns (``a_user``: 3 of 50 user ids; ``b_item``: 3
    of 50 item ids) and a base column, with a target that is the sum of
    planted (user, item) pair effects plus noise: the -q ab regressor's
    data."""
    from mmlspark_tpu_torch.core import DataFrame
    rng = np.random.default_rng(seed)
    pair = np.random.default_rng(163).normal(size=(50, 50))
    ua = rng.integers(0, 50, size=(n, 3))
    ib = rng.integers(0, 50, size=(n, 3))
    y = pair[ua[:, :, None], ib[:, None, :]].sum(axis=(1, 2)) \
        + rng.normal(scale=0.1, size=n)
    cols = {"a_user": np.empty(n, dtype=object),
            "b_item": np.empty(n, dtype=object),
            "features": np.empty(n, dtype=object)}
    ones = np.ones(3, np.float32)
    for i in range(n):
        cols["a_user"][i] = {"indices": (ua[i] * 7919 + 1).astype(np.int32),
                             "values": ones}
        cols["b_item"][i] = {"indices": (ib[i] * 104729 + 3)
                             .astype(np.int32), "values": ones}
        cols["features"][i] = {"indices": np.array([5], np.int32),
                               "values": np.ones(1, np.float32)}
    return DataFrame.from_dict({**cols, "label": y})


def vw_bandit_rows(n: int, seed: int):
    """Logged contextual-bandit rows: 5 shared context features (of 200
    ids, values N(0, 1)), per action its own copy of them (hashed by
    action) and an action-id feature; the true cost of action ``a`` is
    the context's dot with planted per-action weights; the logging policy
    is uniform.  Returns the frame and the true costs (n, actions)."""
    from mmlspark_tpu_torch.core import DataFrame
    rng = np.random.default_rng(seed)
    w_true = np.random.default_rng(164).normal(size=(200, VW_ACTIONS))
    ctx = rng.integers(0, 200, size=(n, 5))
    xv = rng.normal(size=(n, 5)).astype(np.float32)
    costs = (w_true[ctx] * xv[:, :, None]).sum(axis=1)       # (n, A)
    chosen = rng.integers(0, VW_ACTIONS, size=n)
    shared = np.empty(n, dtype=object)
    acts = np.empty(n, dtype=object)
    for i in range(n):
        shared[i] = {"indices": ctx[i].astype(np.int32) + 50_000,
                     "values": xv[i]}
        acts[i] = [{"indices": np.concatenate([
                        ctx[i] * VW_ACTIONS + a, [90_000 + a]])
                    .astype(np.int32),
                    "values": np.concatenate([xv[i], [1.0]])
                    .astype(np.float32)} for a in range(VW_ACTIONS)]
    df = DataFrame.from_dict({
        "shared_features": shared, "action_features": acts,
        "chosen_action": chosen + 1.0,
        "cost": costs[np.arange(n), chosen] + rng.normal(scale=0.1, size=n),
        "probability": np.full(n, 1.0 / VW_ACTIONS)})
    return df, costs


def vw_bfgs(df, df_ho) -> dict:
    """(d) ``optimizer="bfgs"`` (20 iterations): one estimator fitted
    twice on the card (its first fit captures ``vw.bfgs_direction`` and
    ``vw.bfgs_trial``, the second replays only), a fresh one with both
    programs eager, and the CPU.  L-BFGS is held by its objective and AUC:
    the card's gradients sum duplicated indices in another order, and the
    line search can take another step from there."""
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    from mmlspark_tpu_torch.vw import VowpalWabbitClassifier, learners
    t_part = part_start("vw (d)")
    launches0 = CH.launch_counts()
    fits = {}
    fresh_pool()
    card = VowpalWabbitClassifier().set_params(optimizer="bfgs")
    for mode in ("first", "replayed", "eager", "cpu"):
        ctx, est = contextlib.nullcontext(), card
        if mode in ("eager", "cpu"):
            est = VowpalWabbitClassifier().set_params(optimizer="bfgs")
        if mode == "eager":
            ctx = eager_plain_programs(learners)
        elif mode == "cpu":
            est.set_params(device="cpu")
        with ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = est.fit(df)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        progs = est._bfgs_programs()
        stats = model.get("stats")[0]
        fits[mode] = {"model": model, "fit_s": wall,
                      "ingest_s": stats["ingest_time_s"],
                      "learn_s": stats["learn_time_s"],
                      **progs.last_run,
                      "direction": program_stats(progs.direction),
                      "trial": program_stats(progs.trial)}
        if mode == "replayed":
            run = fits[mode]
            if (run["direction"]["captures"], run["trial"]["captures"]) \
                    != (1, 1):
                raise AssertionError(f"vw (d): the second fit captured: "
                                     f"{run}")
            pool_own = pool_bytes()
    # where a replayed fit's device time goes: one more fit, profiled
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        card.fit(df)
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in kernels)
    obj = {m: vw_objective(f["model"].weights, df) for m, f in fits.items()}
    auc = {m: vw_auc(f["model"], df_ho) for m, f in fits.items()}
    for m in ("replayed", "eager", "cpu"):
        if abs(obj[m] - obj["first"]) > 1e-4 * abs(obj[m]) or \
                abs(auc[m] - auc["first"]) > 1e-3:
            raise AssertionError(f"vw (d): bfgs objective {obj}, AUC {auc}")
    if CH.launch_counts() != launches0:
        raise AssertionError("vw (d): a Hopper kernel was launched")
    out = {m: {k: v for k, v in f.items() if k != "model"}
           for m, f in fits.items()}
    out.update(objective=obj, auc=auc, graph_pool_bytes=pool_own,
               profiled_busy_ms=busy_ms, profiled_kernels=kernels[:8],
               objective_card=obj["first"], objective_cpu=obj["cpu"],
               auc_card=auc["first"], auc_cpu=auc["cpu"])
    f, r, e = fits["first"], fits["replayed"], fits["eager"]
    log(f"[vw] (d) optimizer='bfgs', {r['iterations']} iterations on "
        f"{VW_SIDE_ROWS:,} tweets: fit {r['fit_s']:.2f} s replayed "
        f"({r['trials']} trial points, {r['host_reads']} host reads), "
        f"{f['fit_s']:.2f} s the first (capturing), {e['fit_s']:.2f} s "
        f"eager ({e['trials']} trial points), {fits['cpu']['fit_s']:.2f} s "
        f"CPU; vw.bfgs_direction {r['direction']['captures']} capture, "
        f"{r['direction']['replays']} replays, vw.bfgs_trial "
        f"{r['trial']['captures']} capture, {r['trial']['replays']} replays "
        f"(capture s {sum(f['direction']['capture_s']):.3f} + "
        f"{sum(f['trial']['capture_s']):.3f}); the second fit captured "
        f"nothing; the programs' graph pool {pool_own / 2**20:.0f} MiB; "
        f"objective replayed {obj['replayed']:.7f}, first {obj['first']:.7f},"
        f" eager {obj['eager']:.7f}, CPU {obj['cpu']:.7f} (within 1e-4 "
        f"relative); AUC {auc['replayed']:.5f} / {auc['first']:.5f} / "
        f"{auc['eager']:.5f} / {auc['cpu']:.5f}; learn s replayed "
        f"{r['learn_s']:.2f} (ingest {r['ingest_s']:.2f}), eager "
        f"{e['learn_s']:.2f}, CPU {fits['cpu']['learn_s']:.2f}; a replayed "
        f"fit's device busy {busy_ms:.1f} ms, most in "
        + "; ".join(f"{k[:60]} {ms:.1f} ms x{n}" for k, ms, n in kernels[:3])
        + "; 0 launches")
    part_done("vw (d)", t_part, out)
    return out


def vw_phase(dev, smi: str):
    import multiprocessing as mp
    import shutil
    import tempfile
    from mmlspark_tpu_torch.core import DataFrame, load, save
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    from mmlspark_tpu_torch.train.metrics import _auc
    from mmlspark_tpu_torch.utils.native_loader import murmur3_batch_native
    from mmlspark_tpu_torch.vw import (
        VowpalWabbitClassificationModel, VowpalWabbitClassifier,
        VowpalWabbitContextualBandit, VowpalWabbitRegressor, murmur3_bytes)
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    CH.reset_launch_counts()
    rec = {"card": smi}
    # the 24-bit featurization runs in a child process meanwhile
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_wide_features, args=(child,), daemon=True)
    proc.start()
    child.close()
    try:
        # (a) hashing: the C++ batch = the scalar hash on every word
        words = list(vw_vocab())
        t0 = time.perf_counter()
        native = murmur3_batch_native(words, 0)
        t_native = time.perf_counter() - t0
        scalar = [murmur3_bytes(w.encode(), 0) for w in words]
        if native.tolist() != scalar:
            raise AssertionError("vw (a): murmur3_batch_native differs from "
                                 "murmur3_bytes")
        tr_text, y_tr, _ = vw_tweets(VW_TRAIN, 161)
        ho_text, y_ho, p_ho = vw_tweets(VW_HELD, 162)
        col_tr, s_tr = vw_featurize(tr_text, VW_BITS)
        col_ho, s_ho = vw_featurize(ho_text, VW_BITS)
        feat_rps = (VW_TRAIN + VW_HELD) / (s_tr + s_ho)
        nnz = float(np.mean([len(v["indices"]) for v in col_tr]))
        bayes = _auc(y_ho, p_ho)
        rec["hashing"] = {"vocab": VW_VOCAB, "native_s": t_native,
                          "native_words_per_s": VW_VOCAB / t_native,
                          "featurize_rows_per_s": feat_rps,
                          "featurize_s": s_tr + s_ho,
                          "features_per_tweet": nnz, "bayes_auc": bayes}
        log(f"[vw] (a) murmur3_batch_native = murmur3_bytes on all "
            f"{VW_VOCAB:,} words ({VW_VOCAB / t_native:,.0f} words/s); "
            f"featurizer {feat_rps:,.0f} rows/s over "
            f"{VW_TRAIN + VW_HELD:,} tweets ({nnz:.2f} features a tweet); "
            f"Bayes AUC of the held-out rows {bayes:.4f}")
        df_tr, df_ho = vw_frames(col_tr, y_tr, col_ho, y_ho)
        del tr_text, ho_text, col_tr, col_ho

        # (b) defaults on the card and on the CPU
        card, cpu, fit = vw_fit_pair(VowpalWabbitClassifier, df_tr,
                                     "defaults", eager=True)
        auc_card, auc_cpu = vw_auc(card, df_ho), vw_auc(cpu, df_ho)
        auc_eager = vw_auc(fit.pop("eager_model"), df_ho)
        if abs(auc_card - auc_cpu) > 1e-4 or abs(auc_card - bayes) > 0.02 \
                or abs(auc_card - auc_eager) > 1e-4:
            raise AssertionError(f"vw (b): held-out AUC card {auc_card}, "
                                 f"eager {auc_eager}, CPU {auc_cpu}, Bayes "
                                 f"{bayes}")
        prof = vw_step_profile(dev, df_tr, VW_BITS)
        stats = card.get("stats")[0]
        rec["defaults"] = {**fit, "auc_card": auc_card, "auc_cpu": auc_cpu,
                           "auc_eager": auc_eager,
                           "fit_rows_per_s": VW_TRAIN / fit["card_fit_s"],
                           "ingest_s": stats["ingest_time_s"],
                           "learn_s": stats["learn_time_s"], "step": prof}
        log(f"[vw] (b) VowpalWabbitClassifier() defaults at {VW_BITS} bits "
            f"on {VW_TRAIN:,} tweets: card = CPU within "
            f"{fit['rel']:.2e} x max|w|, replayed = eager within "
            f"{fit['replayed_vs_eager_rel']:.2e}; held-out AUC card "
            f"{auc_card:.5f} (eager {auc_eager:.5f}), CPU {auc_cpu:.5f}, "
            f"Bayes {bayes:.5f}; fit {fit['card_fit_s']:.2f} s replayed "
            f"({VW_TRAIN / fit['card_fit_s']:,.0f} rows/s; ingest "
            f"{stats['ingest_time_s']:.2f} s, learn "
            f"{stats['learn_time_s']:.2f} s), {fit['eager_fit_s']:.2f} s "
            f"eager, CPU fit {fit['cpu_fit_s']:.2f} s; peak device memory "
            f"{fit['peak_bytes'] / 1e6:.1f} MB; the step: "
            f"{vw_step_line(prof)}")
        # (f) interchange
        b = card.model_bytes()
        if VowpalWabbitClassificationModel.bytes_to_weights(
                b, 1 << VW_BITS).tobytes() != b:
            raise AssertionError("vw (f): model bytes do not round-trip")
        tmp = tempfile.mkdtemp(prefix="vw_model_")
        try:
            save(card, os.path.join(tmp, "m"))
            back = load(os.path.join(tmp, "m"))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        a = card.transform(df_ho).collect()["raw_prediction"]
        b2 = back.transform(df_ho).collect()["raw_prediction"]
        if not all(np.array_equal(u, v) for u, v in zip(a, b2)):
            raise AssertionError("vw (f): the reloaded model scores "
                                 "differently")
        rec["interchange"] = {"bytes": len(b), "bit_identical": True}
        del card, cpu, back

        # (d) --bfgs on the first 100,000 rows
        df_bf = DataFrame.from_dict({
            "features": df_tr.collect()["features"][:VW_SIDE_ROWS],
            "label": y_tr[:VW_SIDE_ROWS]})
        rec["bfgs"] = vw_bfgs(df_bf, df_ho)
        del df_bf

        # (e) -q ab regressor and the contextual bandit
        df_q = vw_namespaces(VW_SIDE_ROWS, 165)
        qcard, qcpu, qfit = vw_fit_pair(VowpalWabbitRegressor, df_q, "-q ab",
                                        interactions=["ab"])
        q_ho = vw_namespaces(20_000, 166)
        pred = qcard.transform(q_ho).collect()["prediction"]
        yq = q_ho.collect()["label"]
        r2 = 1.0 - float(np.mean((pred - yq) ** 2) / np.var(yq))
        df_cb, _ = vw_bandit_rows(VW_SIDE_ROWS, 167)
        cb_card, cb_cpu, cbfit = vw_fit_pair(VowpalWabbitContextualBandit,
                                             df_cb, "bandit", eager=True)
        del cbfit["eager_model"]
        df_cb_ho, costs_ho = vw_bandit_rows(20_000, 168)
        scores = np.stack(cb_card.transform(df_cb_ho).collect()["prediction"])
        picked = scores.argmin(axis=1)
        v_policy = float(costs_ho[np.arange(len(picked)), picked].mean())
        v_uniform = float(costs_ho.mean())
        if not v_policy < v_uniform:
            raise AssertionError(f"vw (e): the learned policy's cost "
                                 f"{v_policy} does not beat the uniform "
                                 f"logging policy's {v_uniform}")
        rec["interactions"] = {**qfit, "held_out_r2": r2}
        rec["bandit"] = {**cbfit, "policy_cost": v_policy,
                         "uniform_cost": v_uniform}
        log(f"[vw] (e) VowpalWabbitRegressor(interactions=['ab']) on "
            f"{VW_SIDE_ROWS:,} rows: card = CPU within {qfit['rel']:.2e} x "
            f"max|w|, held-out R^2 {r2:.3f}; VowpalWabbitContextualBandit() "
            f"({VW_ACTIONS} actions, ips) on {VW_SIDE_ROWS:,} logged rows: "
            f"card = CPU within {cbfit['rel']:.2e} x max|w|, replayed = "
            f"eager within {cbfit['replayed_vs_eager_rel']:.2e} (fit "
            f"{cbfit['card_fit_s']:.2f} s replayed, {cbfit['eager_fit_s']:.2f}"
            f" s eager); held-out cost "
            f"of the learned policy {v_policy:.4f} against the uniform "
            f"logging policy's {v_uniform:.4f}")
        del qcard, qcpu, cb_card, cb_cpu, df_q, df_cb

        # (c) the same fit at 24 bits, on the child's features
        tr24, ho24 = parent.recv()
        proc.join(120)
    finally:
        parent.close()
        if proc.is_alive():
            proc.terminate()
        proc.join()
    if proc.exitcode != 0:
        raise AssertionError(f"vw (c): the 24-bit featurizer exited "
                             f"{proc.exitcode}")
    df_tr, df_ho = vw_frames(_csr_column(tr24), y_tr, _csr_column(ho24),
                             y_ho)
    wcard, wcpu, wfit = vw_fit_pair(VowpalWabbitClassifier, df_tr,
                                    "24 bits", eager=True,
                                    num_bits=VW_WIDE_BITS)
    auc_c, auc_h = vw_auc(wcard, df_ho), vw_auc(wcpu, df_ho)
    auc_e = vw_auc(wfit.pop("eager_model"), df_ho)
    if abs(auc_c - auc_h) > 1e-4 or abs(auc_c - bayes) > 0.02 or \
            abs(auc_c - auc_e) > 1e-4:
        raise AssertionError(f"vw (c): held-out AUC card {auc_c}, eager "
                             f"{auc_e}, CPU {auc_h}, Bayes {bayes}")
    wprof = vw_step_profile(dev, df_tr, VW_WIDE_BITS)
    rec["wide"] = {**wfit, "auc_card": auc_c, "auc_cpu": auc_h,
                   "auc_eager": auc_e,
                   "state_bytes": 3 * 4 << VW_WIDE_BITS, "step": wprof}
    log(f"[vw] (c) the same fit at {VW_WIDE_BITS} bits "
        f"({1 << VW_WIDE_BITS:,} weights, {(3 * 4 << VW_WIDE_BITS) / 1e6:.0f}"
        f" MB of state): card = CPU within {wfit['rel']:.2e} x max|w|, "
        f"replayed = eager within {wfit['replayed_vs_eager_rel']:.2e}; AUC "
        f"card {auc_c:.5f} (eager {auc_e:.5f}), CPU {auc_h:.5f}; fit "
        f"{wfit['card_fit_s']:.2f} s replayed, {wfit['eager_fit_s']:.2f} s "
        f"eager; the step: {vw_step_line(wprof)}; "
        f"{wprof['step_bytes'] / 1e3:.0f} kB a step = "
        f"{100 * wprof['replayed']['hbm_share']:.3f}% of HBM bandwidth "
        f"replayed; peak device memory {wfit['peak_bytes'] / 1e6:.1f} MB")
    launches = CH.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"vw: Hopper kernels launched {launches}")
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    DETAIL["vw"] = rec
    log(f"[vw] launches of the repository's Hopper kernels in the VW phase: "
        f"{launches} (VW runs no TPU kernel: its step is PyTorch, "
        f"replayed as a CUDA graph)")
    return launches


# ---------------------------------------------------------------------------
# phase 17: featurization, the auto-trainers, Word2Vec and tuning
# ---------------------------------------------------------------------------

ADULT_TRAIN, ADULT_TEST = 32_561, 16_281         # UCI Adult's split
ADULT_NUMERIC = ("age", "fnlwgt", "education_num", "capital_gain",
                 "capital_loss", "hours_per_week")
ADULT_CATEGORICAL = {"workclass": 9, "education": 16, "marital_status": 7,
                     "occupation": 15, "relationship": 6, "race": 5,
                     "sex": 2, "native_country": 42}
ADULT_NAN = 0.01                                 # per numeric column
W2V_TWEETS = 100_000                             # of vw_tweets' generator
W2V_SUBSET = 20_000                              # card vs CPU downstream
W2V_SMALL = 2_000                                # card = CPU vectors
W2V_HELD = 20_000                                # held out of W2V_TWEETS
W2V_AUC_FLOOR = 0.60      # the port's CPU: 0.6229 (float), 0.6245 (quantized)
W2V_PROFILE_STEPS = 50
#: replayed vs eager at W2V_TWEETS, x max|v| (two eager fits differ by
#: ~3e-4 there: tools/w2v_spread.py); 1e-4 holds at W2V_SMALL
W2V_FULL_TOL = 1e-3
TUNE_GRID = {"num_leaves": [15, 31], "learning_rate": [0.05, 0.1]}


def adult_frame(n: int, seed: int):
    """``n`` rows of UCI Adult's shape: 6 numeric columns (1% NaN each) and
    8 string columns at the published cardinalities, each level's
    frequency Zipf-like; the label (``>50K`` / ``<=50K``) drawn from a
    planted logistic model of the standardized numerics and one effect per
    level, the model seeing a NaN as its column's mean, so ``p`` is each
    row's true probability given what the row shows.  Returns (columns,
    p)."""
    rng = np.random.default_rng(seed)
    prng = np.random.default_rng(172)           # the planted model
    num = {"age": np.clip(rng.normal(38.6, 13.6, n), 17, 90).round(),
           "fnlwgt": rng.lognormal(12.0, 0.5, n).round(),
           "education_num": rng.integers(1, 17, n).astype(np.float64),
           "capital_gain": np.where(rng.random(n) < 0.08,
                                    rng.lognormal(8.5, 1.0, n).round(), 0.0),
           "capital_loss": np.where(rng.random(n) < 0.05,
                                    rng.lognormal(7.5, 0.3, n).round(), 0.0),
           "hours_per_week": np.clip(rng.normal(40.4, 12.3, n), 1,
                                     99).round()}
    weights = {"age": 0.55, "fnlwgt": 0.0, "education_num": 0.8,
               "capital_gain": 0.6, "capital_loss": 0.25,
               "hours_per_week": 0.45}
    logit = np.full(n, -1.6)
    cols = {}
    for name in ADULT_NUMERIC:
        v = num[name].copy()
        v[rng.random(n) < ADULT_NAN] = np.nan
        z = np.log1p(v) if name.startswith("capital") else v
        mu, sd = np.nanmean(z), np.nanstd(z)
        logit += weights[name] * np.nan_to_num((z - mu) / sd, nan=0.0)
        cols[name] = v
    for name, card in ADULT_CATEGORICAL.items():
        freq = np.arange(1, card + 1, dtype=np.float64) ** -1.2
        codes = rng.choice(card, n, p=freq / freq.sum())
        effect = prng.normal(scale=0.6, size=card)
        logit += effect[codes]
        levels = np.asarray([f"{name}_{i}" for i in range(card)],
                            dtype=object)
        cols[name] = levels[codes]
    p = 1.0 / (1.0 + np.exp(-logit))
    y = rng.random(n) < p
    cols["income"] = np.asarray(np.where(y, ">50K", "<=50K"), dtype=object)
    return cols, p


def _split_cols(cols, n: int):
    return ({k: v[:n] for k, v in cols.items()},
            {k: v[n:] for k, v in cols.items()})


def same_booster(a, b, what: str) -> None:
    """Raise unless two boosters are equal in every array and meta field."""
    for k in a._present_arrays():
        if not np.array_equal(getattr(a, k), getattr(b, k)):
            raise AssertionError(f"{what}: {k} differs")
    if list(a.categorical_features or []) != \
            list(b.categorical_features or []):
        raise AssertionError(f"{what}: categorical_features differ")


def counted(fn):
    """``fn()`` with the kernels' counts zeroed just before and read just
    after: (result, launches)."""
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    torch.cuda.synchronize()
    CH.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, CH.launch_counts()


def add_counts(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + more[k] for k in more}


def featurize_census(dev) -> dict:
    """(a) ``TrainClassifier(LightGBMClassifier())`` at the estimator's
    defaults on Adult's shape, one-hot and index-encoded (the categorical
    slots wired)."""
    from mmlspark_tpu_torch.core import DataFrame, stack_vector_column
    from mmlspark_tpu_torch.featurize import Featurize
    from mmlspark_tpu_torch.lightgbm import BinMapper, LightGBMClassifier
    from mmlspark_tpu_torch.train import TrainClassifier
    cols, p = adult_frame(ADULT_TRAIN + ADULT_TEST, 173)
    tr_cols, te_cols = _split_cols(cols, ADULT_TRAIN)
    bayes = float(np.maximum(p[ADULT_TRAIN:], 1 - p[ADULT_TRAIN:]).mean())
    df_tr, df_te = DataFrame.from_dict(tr_cols), DataFrame.from_dict(te_cols)
    truth = te_cols["income"]
    rec = {"rows": [ADULT_TRAIN, ADULT_TEST], "bayes_accuracy": bayes}
    launches = {}
    for one_hot in (True, False):
        label = "one_hot" if one_hot else "index"
        tc = TrainClassifier(LightGBMClassifier()).set_params(
            label_col="income", one_hot_encode_categoricals=one_hot)
        t0 = time.perf_counter()
        model, fit_launches = counted(lambda: tc.fit(df_tr))
        fit_s = time.perf_counter() - t0
        launches = add_counts(launches, fit_launches)
        t0 = time.perf_counter()
        pred = model.transform(df_te).collect()["predicted_income"]
        score_s = time.perf_counter() - t0
        acc = float(np.mean(pred == truth))
        feat = model.get("featurizer")
        inner = model.get("inner_model")
        fc = model.get("features_col")
        # the port's CPU featurization, and the matrix the card trains on
        cpu_feat = Featurize().set_params(
            input_cols=[c for c in tr_cols if c != "income"], output_col=fc,
            one_hot_encode_categoricals=one_hot).fit(df_tr)
        X_cpu = stack_vector_column(cpu_feat.transform(df_tr).collect()[fc])
        X = stack_vector_column(feat.transform(df_tr).collect()[fc])
        X_card = torch.from_numpy(X.astype(np.float32)).to(dev)
        if not np.array_equal(X_card.cpu().numpy(),
                              X_cpu.astype(np.float32), equal_nan=True):
            raise AssertionError(f"featurize (a) {label}: the card's "
                                 f"matrix differs from the CPU's")
        if cpu_feat.get("plan") != feat.get("plan"):
            raise AssertionError(f"featurize (a) {label}: plans differ")
        slots = feat.categorical_slots()
        wired = inner.get("booster").categorical_features or []
        if list(wired) != slots or (not one_hot) != bool(slots):
            raise AssertionError(f"featurize (a) {label}: wired slots "
                                 f"{wired} != categorical_slots {slots}")
        mapper = BinMapper(255, categorical_features=slots).fit(X)
        if not torch.equal(mapper.bin_on_device(X, dev).t().cpu(),
                           torch.from_numpy(mapper.transform(X))):
            raise AssertionError(f"featurize (a) {label}: the card's bins "
                                 f"differ from the host's")
        # the wrapper adds nothing to the fit
        work = feat.transform(model.get("label_model").transform(df_tr))
        plain = LightGBMClassifier().set_params(
            features_col=fc, label_col="income_idx",
            categorical_features=slots).fit(work)
        same_booster(inner.get("booster"), plain.get("booster"),
                     f"featurize (a) {label}: TrainClassifier vs plain")
        if abs(acc - bayes) > 0.02:
            raise AssertionError(f"featurize (a) {label}: test accuracy "
                                 f"{acc} not within 0.02 of the Bayes "
                                 f"accuracy {bayes}")
        rec[label] = {"width": int(X.shape[1]), "categorical_slots": slots,
                      "fit_s": fit_s, "transform_s": score_s,
                      "fit_rows_per_s": ADULT_TRAIN / fit_s,
                      "accuracy": acc, "launches": fit_launches,
                      "trees": int(inner.get("booster").num_trees)}
        log(f"[featurize] (a) TrainClassifier(LightGBMClassifier()) "
            f"{label}: {X.shape[1]} features ({len(slots)} categorical "
            f"slots wired), fit {fit_s:.2f} s on the card "
            f"({ADULT_TRAIN / fit_s:,.0f} rows/s), {fit_launches} launches;"
            f" booster = plain LightGBMClassifier's in every array; test "
            f"accuracy {acc:.4f} (Bayes {bayes:.4f}); transform "
            f"{score_s:.2f} s")
    rec["launches"] = launches
    return rec


def _w2v_class():
    """The port's ``Word2Vec`` with each epoch run under sync debug mode
    "error" (any call in it that waits for the card raises), keeping the
    last epoch's inputs for the step profile."""
    from mmlspark_tpu_torch.featurize import Word2Vec

    class SyncCheckedWord2Vec(Word2Vec):
        def _epoch(self, ep, W_in, W_out, centers, contexts, cum, gen, K,
                   lr, block):
            self.last_epoch = (W_in.clone(), W_out.clone(), centers,
                               contexts, cum, K, lr)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                super()._epoch(ep, W_in, W_out, centers, contexts, cum, gen,
                               K, lr, block)
            finally:
                torch.cuda.set_sync_debug_mode(0)

    return SyncCheckedWord2Vec


def w2v_step_profile(dev, est) -> dict:
    """The SGD step over the first steps of the fit's last epoch (its
    pairs, a draw of its negatives, its tables as the epoch began), eager
    (``sgns_step`` a step) and replayed (``sgns_block``'s captured blocks
    of ``BLOCK_STEPS``, the fit's program): host enqueue ms a step beside
    device ms a step (CUDA events), and from a ``torch.profiler`` window
    the device ops and busy ms a step of each."""
    from torch.profiler import ProfilerActivity, profile
    from mmlspark_tpu_torch.featurize.word2vec import (BLOCK_STEPS,
                                                       draw_negatives,
                                                       sgns_block,
                                                       sgns_step)
    from mmlspark_tpu_torch.observability.compute import captured
    W_in, W_out, centers, contexts, cum, K, lr = est.last_epoch
    L = BLOCK_STEPS
    S = min(len(centers), 400) // L * L
    B = centers.shape[1]
    cen = torch.from_numpy(centers[:S].astype(np.int64)).to(dev)
    ctx = torch.from_numpy(contexts[:S].astype(np.int64)).to(dev)
    negs = draw_negatives(cum, torch.rand((S, B, K), device=dev))
    ones_b = torch.ones(B, device=dev)
    ones_bk = torch.ones(B * K, device=dev)
    block = captured(sgns_block, name="featurize.word2vec_block",
                     donate_argnums=(0, 1), static_argnums=(5,))
    tables = {"eager": (W_in.clone(), W_out.clone()),
              "replayed": (W_in.clone(), W_out.clone())}
    runs = {
        "eager": (lambda s, t=tables["eager"]: sgns_step(
            t[0], t[1], cen[s], ctx[s], negs[s], lr, ones_b, ones_bk),
            [(s,) for s in range(S)], 1),
        "replayed": (lambda s, t=tables["replayed"]: block(
            t[0], t[1], cen[s:s + L], ctx[s:s + L], negs[s:s + L], lr),
            [(s,) for s in range(0, S, L)], L)}
    block(*tables["replayed"], cen[:L], ctx[:L], negs[:L], lr)  # capture
    for s in range(10):
        sgns_step(*tables["eager"], cen[s], ctx[s], negs[s], lr, ones_b,
                  ones_bk)
    out = {"steps": S, "batch": B, "vocab": int(W_in.shape[0]),
           "width": int(W_in.shape[1]), "block_steps": L}
    for mode, (fn, calls, per) in runs.items():
        t = time_program(fn, calls)
        n_prof = max(1, W2V_PROFILE_STEPS // per)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for args in calls[:n_prof]:
                fn(*args)
            torch.cuda.synchronize()
        ops, busy_us = 0, 0.0
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                ops += evt.count
                busy_us += evt.self_device_time_total
        steps = n_prof * per
        out[mode] = {"host_enqueue_ms_per_step": t["host_enqueue_ms"] / per,
                     "device_ms_per_step": t["device_ms"] / per,
                     "steps_per_s": 1e3 * per / t["device_ms"],
                     "device_ops_per_step": ops / steps,
                     "device_busy_ms_per_step": busy_us / 1e3 / steps}
    out["block_program"] = program_stats(block)
    D = out["width"]
    # a step must read the B centre, B context and B*K negative rows and
    # write them back, and read its ids
    step_bytes = (B * (2 + K) * D * 4) * 2 + B * (2 + K) * 8
    out.update(step_bytes=float(step_bytes),
               step_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3)
    return out


def w2v_frame(n: int, seed: int):
    from mmlspark_tpu_torch.core import DataFrame
    text, y, p = vw_tweets(n, seed)
    return DataFrame.from_dict({"text": text}), y, p


def doc_vectors(model, df, y):
    """The model's document vectors beside the label, as a frame."""
    from mmlspark_tpu_torch.core import DataFrame
    vec = model.transform(df).collect()["vec"]
    return DataFrame.from_dict({"vec": vec, "label": y})


def _rows(df, lo: int, hi: int):
    from mmlspark_tpu_torch.core import DataFrame
    return DataFrame.from_dict({k: v[lo:hi] for k, v in df.collect().items()})


def held_auc(model, df) -> float:
    from mmlspark_tpu_torch.train.metrics import _auc
    out = model.transform(df).collect()
    return _auc(np.asarray(out["label"]),
                np.stack(out["probability"])[:, 1])


def featurize_word2vec(dev) -> dict:
    """(b) Word2Vec at its defaults on the synthetic tweets, then
    ``TrainClassifier`` on the document vectors, ``TuneHyperparameters``
    over a grid on the learner and ``FindBestModel`` over the same
    candidates fitted alone."""
    from mmlspark_tpu_torch.automl import (DiscreteHyperParam, FindBestModel,
                                           GridSpace, HyperparamBuilder,
                                           TuneHyperparameters)
    from mmlspark_tpu_torch.automl.tune import _metric_value
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.featurize import Word2Vec
    from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
    from mmlspark_tpu_torch.train import TrainClassifier
    from mmlspark_tpu_torch.train.metrics import _auc
    from mmlspark_tpu_torch.featurize import word2vec as w2v_module
    SyncChecked = _w2v_class()
    rec = {}
    launches = {}
    df, y, p = w2v_frame(W2V_TWEETS, 171)
    n_tr = W2V_TWEETS - W2V_HELD
    kw = dict(input_col="text", output_col="vec")
    est = SyncChecked(**kw)
    t0 = time.perf_counter()
    w2v = est.fit(df)
    fit_s = time.perf_counter() - t0
    st = w2v.fit_stats
    # the same fit with the blocks eager: the same draws, so the vectors
    # differ only by index_add_'s atomic order
    with eager_plain_programs(w2v_module):
        t0 = time.perf_counter()
        w2v_eager = Word2Vec(**kw).fit(df)
        eager_fit_s = time.perf_counter() - t0
    est_e = w2v_eager.fit_stats
    a = np.asarray(w2v.get("vectors"))
    b = np.asarray(w2v_eager.get("vectors"))
    dv, vmax = float(np.abs(a - b).max()), float(np.abs(b).max())
    # index_add_'s atomic order compounds over the epoch's 17,465 steps:
    # two eager fits differ by ~3e-4 x max|v| here (tools/w2v_spread.py),
    # so this size is held to that order; the 1e-4 gate is below, at
    # W2V_SMALL tweets, where the card is held to the CPU too
    if w2v.get("vocab") != w2v_eager.get("vocab") or \
            dv > W2V_FULL_TOL * vmax:
        raise AssertionError(f"featurize (b): Word2Vec replayed vs eager "
                             f"max |dv| {dv} > {W2V_FULL_TOL} x {vmax}")
    if st["captures"] < 1 or st["replays"] < 1 or est_e["captures"]:
        raise AssertionError(f"featurize (b): Word2Vec blocks captured "
                             f"{st['captures']}, replayed {st['replays']}; "
                             f"eager captured {est_e['captures']}")
    del w2v_eager
    prof = w2v_step_profile(dev, est)
    rec["fit"] = {**st, "fit_s": fit_s, "pairs_per_s": st["pairs"] /
                  st["train_s"], "steps_per_s": st["steps"] / st["train_s"],
                  "sync_debug": "error", "step": prof,
                  "eager": {"fit_s": eager_fit_s, "train_s": est_e["train_s"],
                            "pairs_per_s": est_e["pairs"] / est_e["train_s"]},
                  "replayed_vs_eager_max_abs_dv": dv, "max_abs_v": vmax}
    pe, pr = prof["eager"], prof["replayed"]
    log(f"[featurize] (b) Word2Vec() defaults on {W2V_TWEETS:,} tweets "
        f"(vocabulary {st['vocab']:,}, {st['pairs']:,} pairs, "
        f"{st['steps']:,} steps of {st['pairs'] // st['steps']}): host "
        f"pairs {st['pairs_s']:.2f} s, the epoch {st['train_s']:.2f} s "
        f"replayed under sync debug 'error' "
        f"({st['pairs'] / st['train_s']:,.0f} pairs/s) against "
        f"{est_e['train_s']:.2f} s eager "
        f"({est_e['pairs'] / est_e['train_s']:,.0f} pairs/s); replayed = "
        f"eager within {dv / vmax:.2e} x max|v|; blocks of "
        f"{prof['block_steps']}: {st['captures']} captures "
        f"({', '.join(f'{c:.3f}' for c in st['capture_s'])} s), "
        f"{st['replays']} replays; a step eager: host enqueue "
        f"{pe['host_enqueue_ms_per_step']:.4f} ms beside device "
        f"{pe['device_ms_per_step']:.4f} ms (busy "
        f"{pe['device_busy_ms_per_step']:.4f} ms in "
        f"{pe['device_ops_per_step']:.1f} device ops); replayed: host "
        f"{pr['host_enqueue_ms_per_step']:.4f} ms beside device "
        f"{pr['device_ms_per_step']:.4f} ms (busy "
        f"{pr['device_busy_ms_per_step']:.4f} ms in "
        f"{pr['device_ops_per_step']:.1f} device ops)")
    del est

    # card = CPU on the same uniforms
    small, _, _ = w2v_frame(W2V_SMALL, 174)
    probe = Word2Vec(device="cpu", max_iter=0, **kw).fit(small).fit_stats
    S, B = probe["steps"], probe["pairs"] // probe["steps"]
    us = [np.random.default_rng(175).random((S, B, 5), dtype=np.float32)]
    card = Word2Vec(negative_uniforms=us, **kw).fit(small)
    with eager_plain_programs(w2v_module):
        card_eager = Word2Vec(negative_uniforms=us, **kw).fit(small)
    cpu = Word2Vec(negative_uniforms=us, device="cpu", **kw).fit(small)
    a, b = np.asarray(card.get("vectors")), np.asarray(cpu.get("vectors"))
    c = np.asarray(card_eager.get("vectors"))
    dv, vmax = float(np.abs(a - b).max()), float(np.abs(b).max())
    de = float(np.abs(a - c).max())
    if card.get("vocab") != cpu.get("vocab") or dv > 1e-4 * vmax or \
            de > 1e-4 * vmax or card.fit_stats["replays"] < 1:
        raise AssertionError(f"featurize (b): Word2Vec card vs CPU max |dv| "
                             f"{dv}, replayed vs eager {de}, > 1e-4 x "
                             f"{vmax}, or no replay")
    rec["card_vs_cpu"] = {"tweets": W2V_SMALL, "max_abs_dv": dv,
                          "max_abs_v": vmax, "rel": dv / vmax,
                          "replayed_vs_eager_rel": de / vmax}
    log(f"[featurize] (b) Word2Vec on {W2V_SMALL:,} tweets with the same "
        f"uniforms: card = CPU within {dv / vmax:.2e} x max|v|, replayed = "
        f"eager within {de / vmax:.2e} x max|v|")

    # downstream: TrainClassifier on the document vectors
    vec_df = doc_vectors(w2v, df, y)
    tr, ho = _rows(vec_df, 0, n_tr), _rows(vec_df, n_tr, W2V_TWEETS)
    tc = TrainClassifier(LightGBMClassifier().set_params(
        num_iterations=30)).set_params(label_col="label")
    t0 = time.perf_counter()
    clf, c_launches = counted(lambda: tc.fit(tr))
    clf_s = time.perf_counter() - t0
    launches = add_counts(launches, c_launches)
    auc = held_auc(clf, ho)
    bayes = _auc(y[n_tr:], p[n_tr:])
    if auc < W2V_AUC_FLOOR:
        raise AssertionError(f"featurize (b): held-out AUC {auc} below the "
                             f"floor {W2V_AUC_FLOOR}")

    # card vs CPU end to end on a subset, on the same uniforms (the AUC of
    # two fits on other draws spread 0.667-0.686 over five CPU seeds)
    sub_df, y_sub = _rows(df, 0, W2V_SUBSET), y[:W2V_SUBSET]
    ho_df, y_ho = _rows(df, n_tr, W2V_TWEETS), y[n_tr:]
    probe = Word2Vec(device="cpu", max_iter=0, **kw).fit(sub_df).fit_stats
    S, B = probe["steps"], probe["pairs"] // probe["steps"]
    us = [np.random.default_rng(176).random((S, B, 5), dtype=np.float32)]
    aucs = {}
    for where in ("card", "cpu"):
        extra = {"device": "cpu"} if where == "cpu" else {}
        m = Word2Vec(negative_uniforms=us, **kw, **extra).fit(sub_df)
        c = TrainClassifier(LightGBMClassifier().set_params(
            num_iterations=30, **extra)).set_params(label_col="label") \
            .fit(doc_vectors(m, sub_df, y_sub))
        aucs[where] = held_auc(c, doc_vectors(m, ho_df, y_ho))
    if abs(aucs["card"] - aucs["cpu"]) > 0.02:
        raise AssertionError(f"featurize (b): subset AUC card "
                             f"{aucs['card']} vs CPU {aucs['cpu']}")
    rec["downstream"] = {"fit_s": clf_s, "launches": c_launches,
                         "auc": auc, "auc_floor": W2V_AUC_FLOOR,
                         "bayes_auc": bayes, "subset_auc": aucs}
    log(f"[featurize] (b) TrainClassifier(LightGBMClassifier("
        f"num_iterations=30)) on the vectors: fit {clf_s:.2f} s, "
        f"{c_launches} launches; held-out AUC {auc:.4f} (floor "
        f"{W2V_AUC_FLOOR}, Bayes {bayes:.4f}); trained on {W2V_SUBSET:,} "
        f"tweets with the same uniforms: card {aucs['card']:.4f}, CPU "
        f"{aucs['cpu']:.4f}")

    # TuneHyperparameters on the vector column, the grid on the learner
    feats = DataFrame.from_dict({"features": vec_df.collect()["vec"],
                                 "label": y})
    space = HyperparamBuilder()
    for name, values in TUNE_GRID.items():
        space.add_hyperparam(name, DiscreteHyperParam(values))
    tuner = TuneHyperparameters().set_params(
        evaluation_metric="accuracy", parallelism=2, label_col="label")
    tuner.set("models", [LightGBMClassifier().set_params(num_iterations=30)])
    tuner.set("param_space", GridSpace(space.build()))
    t0 = time.perf_counter()
    g0 = gg_programs()
    tuned, t_launches = counted(lambda: tuner.fit(feats))
    tune_s = time.perf_counter() - t0
    # the candidates' fits on two threads: each has its own state, so
    # each captures its programs once (a graph per fit's buffers), and
    # neither evicts the other's
    g1 = gg_programs()
    tune_graphs = {k: {f: v[f] - g0.get(k, {}).get(f, 0)
                       for f in ("captures", "recaptures")}
                   for k, v in g1.items()
                   if v["captures"] != g0.get(k, {}).get("captures", 0)}
    launches = add_counts(launches, t_launches)
    # the same candidates, one at a time
    train, valid = feats.random_split([0.8, 0.2], seed=0)
    alone, metrics, params = [], [], []
    for pm in GridSpace(space.build()).param_maps():
        m = LightGBMClassifier().set_params(num_iterations=30, **pm) \
            .fit(train)
        alone.append(m)
        params.append(pm)
        metrics.append(_metric_value(m.transform(valid), "label",
                                     "accuracy")[0])
    if tuned.get("all_metrics") != metrics:
        raise AssertionError(f"featurize (b): tuned metrics "
                             f"{tuned.get('all_metrics')} != alone "
                             f"{metrics}")
    best = params.index(tuned.get("best_params"))
    same_booster(tuned.get("best_model").get("booster"),
                 alone[best].get("booster"),
                 "featurize (b): the tuned best model vs alone")
    fb = FindBestModel().set_params(evaluation_metric="accuracy")
    fb.set("models", alone)
    picked = fb.fit(valid)
    if picked.get("all_model_metrics") != metrics or \
            picked.get("best_model") is not alone[best]:
        raise AssertionError("featurize (b): FindBestModel picked another "
                             "candidate")
    t0 = time.perf_counter()
    wide = Word2Vec(vector_size=300, **kw).fit(sub_df)
    wide_s = time.perf_counter() - t0
    rec["tune"] = {"seconds": tune_s, "launches": t_launches,
                   "all_metrics": metrics, "best_params": params[best],
                   "candidates": len(metrics), "graphs": tune_graphs}
    rec["wide"] = {"vector_size": 300, "documents": W2V_SUBSET,
                   "fit_s": wide_s,
                   **wide.fit_stats}
    log(f"[featurize] (b) TuneHyperparameters(parallelism=2) over "
        f"{len(metrics)} candidates in {tune_s:.2f} s, {t_launches} "
        f"launches, program captures / re-captures {tune_graphs}: "
        f"all_metrics = the candidates fitted alone "
        f"({', '.join(f'{m:.4f}' for m in metrics)}), best "
        f"{params[best]} bit-identical to its candidate alone, "
        f"FindBestModel the same pick; Word2Vec(vector_size=300) on "
        f"{W2V_SUBSET:,} tweets fit "
        f"{wide_s:.2f} s (epoch {wide.fit_stats['train_s']:.2f} s)")
    rec["launches"] = launches
    return rec


def featurize_phase(dev, smi: str):
    t0 = time.perf_counter()
    rec = {"card": smi, "census": featurize_census(dev)}
    rec["census"]["seconds"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    rec["word2vec"] = featurize_word2vec(dev)
    rec["word2vec"]["seconds"] = time.perf_counter() - t1
    launches = add_counts(rec["census"]["launches"],
                          rec["word2vec"]["launches"])
    for name, n in launches.items():
        if not n:
            raise AssertionError(f"featurize: {name} never launched")
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t0
    DETAIL["featurize"] = rec
    log(f"[featurize] launches of the repository's Hopper kernels on the "
        f"path: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 18: KNN, SAR and the isolation forest
# ---------------------------------------------------------------------------

KNN_ITEMS, KNN_DIM, KNN_K = 100_000, 512, 5      # ResNet-18's pooled width
KNN_CLUSTERS = 100
KNN_CPU_QUERIES, KNN_TREE_QUERIES = 2_000, 20
ML_USERS, ML_ITEMS, ML_RATINGS = 6_040, 3_706, 1_000_209   # MovieLens-1M
ML_YEARS = 3
SAR_K = 10
IF_ROWS, IF_FEAT, IF_OUTLIERS = 1_000_000, 20, 0.01
IF_CPU_ROWS = 200_000


def knn_items(n: int, d: int, seed: int) -> np.ndarray:
    """Clustered non-negative float32 rows, as pooled ReLU features are:
    |center + noise| around ``KNN_CLUSTERS`` centers."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(KNN_CLUSTERS, d)).astype(np.float32)
    X = centers[rng.integers(0, KNN_CLUSTERS, n)] + 0.5 * rng.normal(
        size=(n, d)).astype(np.float32)
    return np.abs(X).astype(np.float32)


def same_but_near_ties(idx_a, sc_a, idx_b, sc_b, rtol: float = 1e-4,
                       tie: float = 1e-5) -> int:
    """Two top-k lists of one query, each sorted by score: the scores agree
    position by position within ``rtol``, and where the indices differ the
    two scores at that place are a near-tie (a gap < ``tie`` x |score|):
    tied items in another order or, at the k-th place, another tied item.
    Raises otherwise; returns the positions that differ (the reported
    near-ties)."""
    sc_a, sc_b = np.asarray(sc_a, np.float64), np.asarray(sc_b, np.float64)
    np.testing.assert_allclose(sc_a, sc_b, rtol=rtol, atol=0)
    moved = np.nonzero(np.asarray(idx_a) != np.asarray(idx_b))[0]
    for i in moved:
        if abs(sc_a[i] - sc_b[i]) > tie * abs(sc_b[i]):
            raise AssertionError(f"lists differ at {i} without a near-tie: "
                                 f"{idx_a} {idx_b} {sc_a} {sc_b}")
    return len(moved)


def part_start(name: str) -> float:
    """State a part's budget before it runs; returns its start time."""
    log(f"[{name.split()[0]}] {name} budget {PART_BUDGET_S[name]:.0f} s")
    return time.perf_counter()


def part_done(name: str, t0: float, rec: dict) -> None:
    """A part's seconds against its budget, kept in ``rec``."""
    rec["seconds"] = time.perf_counter() - t0
    rec["budget_s"] = PART_BUDGET_S[name]
    log(f"[{name.split()[0]}] {name} done in {rec['seconds']:.1f} s "
        f"(budget {PART_BUDGET_S[name]:.0f} s)")


def pool_bytes() -> int:
    """The shared graph pool's bytes on card 0 (0 with no live graph)."""
    from mmlspark_tpu_torch.observability import compute
    return int(compute.graph_pool_bytes(0) or 0)


def fresh_pool() -> None:
    """Drop every captured graph of the process, so the next captures
    start a pool of their own and ``pool_bytes()`` reads theirs alone (a
    dropped program captures again at its next call)."""
    from mmlspark_tpu_torch.observability import compute
    compute.release_graphs()


def program_line(prog) -> str:
    st = program_stats(prog)
    return (f"{st['captures']} captures ({st['recaptures']} re-), "
            f"{st['replays']} replays, capture "
            f"{sum(st['capture_s']):.3f} s")


def knn_matches(rows):
    return (np.asarray([[r["value"] for r in row] for row in rows]),
            np.asarray([[r["distance"] for r in row] for row in rows]))


def neighbours_knn(dev) -> dict:
    """(a) KNN over 100,000 items x 512, every item querying the index:
    the search replayed (its first transform captures, the second
    replays) and eager on the same code."""
    from mmlspark_tpu_torch.core import DataFrame, vector_column
    from mmlspark_tpu_torch.nn import KNN, knn
    from mmlspark_tpu_torch.nn.knn import _device_topk
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    t_part = part_start("neighbours (a)")
    X = knn_items(KNN_ITEMS, KNN_DIM, 176)
    df = DataFrame.from_dict({"features": vector_column(list(X)),
                              "values": np.arange(KNN_ITEMS)})
    t0 = time.perf_counter()
    model = KNN().set_params(output_col="m", k=KNN_K).fit(df)
    build_s = time.perf_counter() - t0
    tree = model.get("ball_tree")
    walls = {}
    results = {}
    fresh_pool()
    for mode in ("first", "replayed", "eager"):
        m = model
        ctx = contextlib.nullcontext()
        if mode == "eager":
            m, ctx = model.copy(), eager_plain_programs(knn)
        with ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[mode] = knn_matches(m.transform(df).collect()["m"])
            walls[mode] = time.perf_counter() - t0
        if mode == "first":
            pool_own = pool_bytes()
    prog = model._program()
    idx_card, sc_card = results["replayed"]
    for mode in ("first", "eager"):
        for a, b in zip(results[mode], results["replayed"]):
            if not np.array_equal(a, b):
                raise AssertionError(f"neighbours (a): the {mode} transform "
                                     "differs from the replayed one")
    chunks = -(-KNN_ITEMS // 1024)
    st = program_stats(prog)
    if (st["captures"], st["recaptures"], st["replays"]) != \
            (1, 0, 2 * chunks - 1):
        raise AssertionError(f"neighbours (a): program {st}, want 1 capture "
                             f"and {2 * chunks - 1} replays")
    # the matmul of one 1,024-query chunk, and one chunk's whole search
    # through the model's program (replayed) and eagerly
    Xd = model._items(tree, torch.device("cuda", torch.cuda.current_device()))
    Q = Xd[:1024]
    from mmlspark_tpu_torch._device import float32_exact
    with float32_exact():
        mm_ms = time_ms(lambda: Q @ Xd.T, 20)
    eager_prog = eager_captured(knn._search, static_argnums=(2,),
                                inplace_argnums=(1,))
    chunk_ms = {mode: time_ms(lambda: _device_topk(
        Xd, X[:1024], KNN_K, program=p), 20)
        for mode, p in (("replayed", prog), ("eager", eager_prog))}
    # card vs the port's CPU on 2,000 queries
    qdf = DataFrame.from_dict({"features": vector_column(
        list(X[:KNN_CPU_QUERIES]))})
    cpu = model.copy().set_params(device="cpu").transform(qdf) \
        .collect()["m"]
    moved = 0
    for i, row in enumerate(cpu):
        moved += same_but_near_ties(
            idx_card[i], sc_card[i], np.asarray([r["value"] for r in row]),
            np.asarray([r["distance"] for r in row]))
    # the ball tree's exact MIPS on KNN_TREE_QUERIES queries (a query walks
    # nearly every leaf at 512 dimensions: ~0.25 s of host Python each;
    # eight spawned workers, each sent the tree, took longer than this loop
    # on the card's host; 20 keep the check inside the script's clock)
    tree_moved = 0
    t0 = time.perf_counter()
    for i in range(KNN_TREE_QUERIES):
        exact = tree.find_maximum_inner_products(X[i], KNN_K)
        tree_moved += same_but_near_ties(
            idx_card[i], sc_card[i], np.asarray([j for j, _ in exact]),
            np.asarray([s for _, s in exact]))
    tree_s = time.perf_counter() - t0
    if any(CH.launch_counts().values()):
        raise AssertionError("neighbours (a): a Hopper kernel was launched")
    flops = 2.0 * 1024 * KNN_DIM * KNN_ITEMS
    rec = {"items": KNN_ITEMS, "dim": KNN_DIM, "k": KNN_K,
           "tree_build_s": build_s, "query_s": walls["replayed"],
           "queries_per_s": KNN_ITEMS / walls["replayed"],
           "query_s_first": walls["first"], "query_s_eager": walls["eager"],
           "queries_per_s_eager": KNN_ITEMS / walls["eager"],
           "replayed_eq_eager_bit_for_bit": True,
           "matmul_ms_per_1024": mm_ms,
           "search_ms_per_1024": chunk_ms["replayed"],
           "search_ms_per_1024_eager": chunk_ms["eager"],
           "matmul_tflops": flops / (mm_ms / 1e3) / 1e12,
           "near_ties_cpu": moved, "near_ties_tree": tree_moved,
           "tree_query_s": tree_s, "program": program_stats(prog),
           "graph_pool_bytes": pool_own}
    log(f"[neighbours] (a) KNN over {KNN_ITEMS:,} x {KNN_DIM}, k = {KNN_K}:"
        f" ball tree built once on the host in {build_s:.1f} s; every item "
        f"queried in {walls['replayed']:.2f} s replayed "
        f"({KNN_ITEMS / walls['replayed']:,.0f} queries/s; the first "
        f"transform, capturing, {walls['first']:.2f} s), "
        f"{walls['eager']:.2f} s eager ({KNN_ITEMS / walls['eager']:,.0f} "
        f"queries/s), replayed = eager bit for bit; nn.knn_search "
        f"{program_line(prog)}, its graph pool {pool_own / 2**20:.0f} MiB; "
        f"a 1,024-query chunk: matmul {mm_ms:.3f} ms "
        f"({rec['matmul_tflops']:.1f} TFLOP/s float32), the search "
        f"{chunk_ms['replayed']:.3f} ms replayed, {chunk_ms['eager']:.3f} ms "
        f"eager; card = CPU on {KNN_CPU_QUERIES:,} queries "
        f"({moved} near-tie positions), = the ball tree's exact MIPS on "
        f"{KNN_TREE_QUERIES} ({tree_moved} near-tie positions; the tree's "
        f"queries {tree_s:.1f} s); 0 launches of the repository's kernels")
    part_done("neighbours (a)", t_part, rec)
    return rec


def movielens_frame(seed: int):
    """MovieLens-1M's shape: 6,040 users with at least 20 ratings each
    (a long tail above), 1,000,209 ratings of 1-5 over 3,706 items drawn
    without replacement by Zipf popularity, timestamps uniform over three
    years."""
    from mmlspark_tpu_torch.core import DataFrame
    rng = np.random.default_rng(seed)
    extra = rng.pareto(1.2, ML_USERS)
    counts = 20 + np.floor(extra / extra.sum() * (ML_RATINGS - 20 * ML_USERS))
    counts = np.minimum(counts, ML_ITEMS).astype(np.int64)
    while counts.sum() < ML_RATINGS:
        room = np.nonzero(counts < ML_ITEMS)[0]
        short = min(ML_RATINGS - int(counts.sum()), len(room))
        counts[rng.choice(room, short, replace=False)] += 1
    logp = -0.9 * np.log(np.arange(1, ML_ITEMS + 1, dtype=np.float64))
    users = np.repeat(np.arange(ML_USERS), counts)
    items = np.empty(ML_RATINGS, np.int64)
    off = 0
    for u, c in enumerate(counts):
        g = logp + rng.gumbel(size=ML_ITEMS)
        items[off:off + c] = np.argpartition(-g, c - 1)[:c]
        off += c
    ratings = rng.choice(5, ML_RATINGS, p=[0.056, 0.108, 0.261, 0.349,
                                           0.226]) + 1.0
    t = 9.6e8 + rng.uniform(0, ML_YEARS * 365 * 86400, ML_RATINGS)
    uid = np.asarray([f"u{i}" for i in range(ML_USERS)], dtype=object)
    iid = np.asarray([f"i{i}" for i in range(ML_ITEMS)], dtype=object)
    return DataFrame.from_dict({"user": uid[users], "item": iid[items],
                                "rating": ratings, "t": t})


class _AllRankingMetrics:
    """An evaluator for ``RankingTrainValidationSplit`` that keeps all four
    ranking metrics of the frame it is handed, and each user's list."""

    def __init__(self, k: int):
        self.k, self.values, self.lists = k, {}, None

    def evaluate(self, df) -> float:
        from mmlspark_tpu_torch.recommendation import RankingEvaluator
        for name in ("ndcgAt", "map", "precisionAtk", "recallAtK"):
            self.values[name] = RankingEvaluator().set_params(
                k=self.k, metric_name=name).evaluate(df)
        data = df.collect()
        self.lists = dict(zip(data["user"], data["prediction"]))
        return self.values["ndcgAt"]


def neighbours_sar(dev) -> dict:
    """(b) SAR at MovieLens-1M's shape."""
    from mmlspark_tpu_torch.recommendation import (RankingAdapter,
                                                   RankingTrainValidationSplit,
                                                   SAR)
    from mmlspark_tpu_torch.recommendation.sar import _matmul
    df = movielens_frame(177)
    kw = dict(similarity_function="jaccard", support_threshold=4,
              time_col="t", time_decay_coeff=30.0)
    t0 = time.perf_counter()
    card = SAR().set_params(**kw).fit(df)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = SAR().set_params(device="cpu", **kw).fit(df)
    cpu_fit_s = time.perf_counter() - t0
    seen = card.get("seen")
    cooc_card = _matmul(seen, None, dev)
    if not np.array_equal(cooc_card, _matmul(seen, None, "cpu")):
        raise AssertionError("neighbours (b): co-occurrence card != CPU")
    for name in ("similarity", "affinity", "seen"):
        if not np.array_equal(card.get(name), cpu.get(name)):
            raise AssertionError(f"neighbours (b): {name} card != CPU")
    t0 = time.perf_counter()
    s_card = card._scores()
    score_s = time.perf_counter() - t0
    s_cpu = cpu._scores()
    np.testing.assert_allclose(s_card, s_cpu, rtol=1e-5,
                               atol=1e-7 * float(np.abs(s_cpu).max()))
    t0 = time.perf_counter()
    rc = card.recommend_for_all_users(SAR_K).collect()
    rec_s = time.perf_counter() - t0
    rh = cpu.recommend_for_all_users(SAR_K).collect()
    item_ix = {v: i for i, v in enumerate(card.get("item_ids"))}
    moved = 0
    for u, (a, b) in enumerate(zip(rc["recommendations"],
                                   rh["recommendations"])):
        ia = np.asarray([item_ix[x] for x in a], np.int64)
        ib = np.asarray([item_ix[x] for x in b], np.int64)
        moved += same_but_near_ties(ia, s_card[u, ia], ib, s_card[u, ib])
    # the ranking split over the adapter, card and CPU
    split = {}
    for where, extra in (("card", {}), ("cpu", {"device": "cpu"})):
        ev = _AllRankingMetrics(SAR_K)
        rtvs = RankingTrainValidationSplit().set_params(train_ratio=0.75)
        rtvs.set("estimator", RankingAdapter(SAR().set_params(**kw, **extra),
                                             k=SAR_K))
        rtvs.set("evaluator", ev)
        t0 = time.perf_counter()
        fitted = rtvs.fit(df)
        split[where] = (ev, fitted.get("fitted"), time.perf_counter() - t0)
    ev_c, sar_c, split_s = split["card"]
    ev_h = split["cpu"][0]
    differ = [u for u in ev_c.lists
              if list(ev_c.lists[u]) != list(ev_h.lists[u])]
    if differ:
        sc = sar_c._scores()
        u_ix = {v: i for i, v in enumerate(sar_c.get("user_ids"))}
        i_ix = {v: i for i, v in enumerate(sar_c.get("item_ids"))}
        for u in differ:
            ia = np.asarray([i_ix[x] for x in ev_c.lists[u]], np.int64)
            ib = np.asarray([i_ix[x] for x in ev_h.lists[u]], np.int64)
            same_but_near_ties(ia, sc[u_ix[u], ia], ib, sc[u_ix[u], ib])
    bound = len(differ) / max(len(ev_c.lists), 1)
    for name, v in ev_c.values.items():
        if abs(v - ev_h.values[name]) > bound:
            raise AssertionError(f"neighbours (b): {name} card {v} vs CPU "
                                 f"{ev_h.values[name]}")
    rec = {"users": ML_USERS, "items": ML_ITEMS, "ratings": ML_RATINGS,
           "fit_s": fit_s, "cpu_fit_s": cpu_fit_s, "score_s": score_s,
           "recommend_s": rec_s, "near_ties_top10": moved,
           "split_s": split_s, "metrics_card": ev_c.values,
           "metrics_cpu": ev_h.values, "split_users_differing": len(differ)}
    log(f"[neighbours] (b) SAR (jaccard, support 4, 30-day half-life) at "
        f"MovieLens-1M's shape ({ML_USERS:,} x {ML_ITEMS:,}, "
        f"{ML_RATINGS:,} ratings): fit {fit_s:.2f} s (CPU {cpu_fit_s:.2f} "
        f"s), co-occurrence and similarity card = CPU bit for bit; score "
        f"{score_s:.3f} s, recommend top-{SAR_K} for every user "
        f"{rec_s:.2f} s ({moved} near-tie positions); split at 0.75: "
        + ", ".join(f"{k} {v:.5f}" for k, v in ev_c.values.items())
        + f" (card = CPU, {len(differ)} users' lists differ at near-ties)")
    return rec


def neighbours_iforest(dev) -> dict:
    """(c) ``IsolationForest`` at its defaults (contamination 0.01) on
    1,000,000 x 20 float64 rows with 1% planted outliers."""
    from mmlspark_tpu_torch.core import DataFrame, vector_column
    from mmlspark_tpu_torch.isolationforest import IsolationForest
    from mmlspark_tpu_torch.train.metrics import _auc
    rng = np.random.default_rng(178)
    X = rng.normal(size=(IF_ROWS, IF_FEAT))
    planted = rng.random(IF_ROWS) < IF_OUTLIERS
    X[planted] = rng.normal(size=(int(planted.sum()), IF_FEAT)) * 3.0 + \
        rng.choice([-4.0, 4.0], size=(int(planted.sum()), IF_FEAT))
    df = DataFrame.from_dict({"features": vector_column(list(X))})
    t0 = time.perf_counter()
    model = IsolationForest().set_params(contamination=0.01).fit(df)
    fit_s = time.perf_counter() - t0
    forest = model.get("forest")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forest.mean_path_length(X, dev)
    walk_s = time.perf_counter() - t0
    out = model.transform(df).collect()
    scores, labels = out["outlier_score"], out["predicted_label"]
    sub = DataFrame.from_dict({"features": vector_column(
        list(X[:IF_CPU_ROWS]))})
    t0 = time.perf_counter()
    cpu = model.copy().set_params(device="cpu").transform(sub).collect()
    cpu_s = time.perf_counter() - t0
    d = float(np.abs(cpu["outlier_score"] - scores[:IF_CPU_ROWS]).max())
    if d > 1e-12 or not np.array_equal(cpu["predicted_label"],
                                       labels[:IF_CPU_ROWS]):
        raise AssertionError(f"neighbours (c): forest card vs CPU max "
                             f"|ds| {d}, or labels differ")
    auc = _auc(planted.astype(np.float64), scores)
    if auc < 0.9:
        raise AssertionError(f"neighbours (c): planted outliers' AUC {auc}")
    rec = {"rows": IF_ROWS, "features": IF_FEAT, "fit_s": fit_s,
           "walk_s": walk_s, "walk_rows_per_s": IF_ROWS / walk_s,
           "cpu_walk_rows_per_s": IF_CPU_ROWS / cpu_s,
           "max_abs_ds": d, "threshold": model.get("threshold"),
           "flagged": float(labels.mean()), "auc": auc}
    log(f"[neighbours] (c) IsolationForest() (100 trees of 256, "
        f"contamination 0.01) on {IF_ROWS:,} x {IF_FEAT} float64: fit "
        f"{fit_s:.2f} s (the threshold's walk included); the walk "
        f"{walk_s:.2f} s ({IF_ROWS / walk_s:,.0f} rows/s; the CPU "
        f"{IF_CPU_ROWS / cpu_s:,.0f}); card = CPU within {d:.1e} on "
        f"{IF_CPU_ROWS:,} rows, labels equal; {100 * labels.mean():.2f}% "
        f"flagged; planted outliers' AUC {auc:.4f}")
    return rec


def neighbours_phase(dev, smi: str):
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    CH.reset_launch_counts()
    rec = {"card": smi}
    for name, part in (("knn", neighbours_knn), ("sar", neighbours_sar),
                       ("iforest", neighbours_iforest)):
        t1 = time.perf_counter()
        rec[name] = part(dev)
        rec[name]["seconds"] = time.perf_counter() - t1
    launches = CH.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"neighbours: Hopper kernels launched "
                             f"{launches}")
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t0
    DETAIL["neighbours"] = rec
    log(f"[neighbours] launches of the repository's Hopper kernels: "
        f"{launches} (KNN, SAR and the forest run no TPU kernel)")
    return launches


# ---------------------------------------------------------------------------
# phase 19: explainers, AccessAnomaly, streaming speech, io and cognitive
# ---------------------------------------------------------------------------

EXPLAIN_ROWS = 5                         # rows explained by each tabular kind
SHAP_SAMPLES, SHAP_BACKGROUND = 5_000, 100
SHAP_TOL = 1e-4                          # |coef card - coef CPU|
LOCAL_ACCURACY = 1e-3                    # |sum(coefs) + intercept - score|
IMAGE_LIME_IMAGES, IMAGE_LIME_SAMPLES = 4, 256
#: the seeded ResNet-50's top-class probability (~0.003) moves by ~1e-4
#: under masking (the port's CPU, 48 samples): the default alpha 0.01
#: zeroes every coefficient, 1e-7 keeps most
IMAGE_LIME_ALPHA = 1e-7
LASSO_TOL = 1e-4                         # x max |coef|, card vs CPU
AA_TENANTS, AA_USERS, AA_RES = 3, 40_000, 10_000
AA_DEPTS, AA_PAIRS = 3, 1_000_000
AA_HELD, AA_PLANTED = 100_000, 0.01
AA_TOL = 1e-4                            # x max |factor| and x max |score|
SPEECH_UTTERANCES, SPEECH_S, SPEECH_CHUNK_S = 32, 20.0, 0.5
SPEECH_SESSIONS, SPEECH_SESSION_S = 16, 5.0
NEAR_TIE_LOGIT = 1e-5
CSV_ROWS, CSV_COLS = 200_000, 20
PNG_IMAGES = 1_000


class _Recorded:
    """Mix-in for an explainer class: keeps each row's mask, scores,
    weights, coefficients and intercept as the surrogate sees them."""

    def _fit_surrogate(self, mask, scores, weights, device):
        coefs, intercept = super()._fit_surrogate(mask, scores, weights,
                                                  device)
        self.rows_seen.append({"mask": mask, "scores": scores,
                               "weights": weights, "coefs": coefs,
                               "intercept": intercept})
        return coefs, intercept


def recorded(cls, **kw):
    exp = type("Recorded" + cls.__name__, (_Recorded, cls), {})(**kw)
    exp.rows_seen = []
    return exp


LASSO_TIMED_CALLS = 20


def lasso_replayed_vs_eager(rows_seen, alpha: float, what: str) -> dict:
    """Each recorded surrogate fit's lasso again with the ISTA loop eager
    (``eager_plain_programs``): its coefficients and intercept = the
    replayed ones the explainer kept, bit for bit; then the last row's
    lasso timed ``LASSO_TIMED_CALLS`` times each way (``lasso_regression``
    reads its answer back, so a call's wall is its latency)."""
    from mmlspark_tpu_torch.explainers import lasso_regression, regression
    prog = regression._ISTA
    for i, row in enumerate(rows_seen):
        with eager_plain_programs():
            coefs, b = lasso_regression(row["mask"], row["scores"],
                                        row["weights"], alpha=alpha)
        if not np.array_equal(coefs, row["coefs"]) or b != row["intercept"]:
            raise AssertionError(f"{what}: row {i}'s replayed lasso differs "
                                 f"from the eager loop")
    last = rows_seen[-1]
    args = (last["mask"], last["scores"], last["weights"])
    walls = {}
    for mode, ctx in (("replayed", contextlib.nullcontext),
                      ("eager", eager_plain_programs)):
        with ctx():
            lasso_regression(*args, alpha=alpha)
            t0 = time.perf_counter()
            for _ in range(LASSO_TIMED_CALLS):
                lasso_regression(*args, alpha=alpha)
            walls[mode] = (time.perf_counter() - t0) / LASSO_TIMED_CALLS
    return {"rows_bit_identical": len(rows_seen),
            "replayed_ms_per_call": walls["replayed"] * 1e3,
            "eager_ms_per_call": walls["eager"] * 1e3,
            "samples": int(len(last["scores"])),
            "features": int(np.asarray(last["mask"]).shape[1]),
            "program": program_stats(prog)}


def explain_tabular(dev) -> dict:
    """(a) ``TabularSHAP`` (5,000 samples, 100 background rows) and
    ``TabularLIME`` (defaults) over ``LightGBMClassifier()`` fitted on the
    card on Adult's shape, index-encoded."""
    from mmlspark_tpu_torch.core import (DataFrame, stack_vector_column,
                                         vector_column)
    from mmlspark_tpu_torch.explainers import TabularLIME, TabularSHAP
    from mmlspark_tpu_torch.featurize import Featurize
    from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
    cols, _ = adult_frame(ADULT_TRAIN + ADULT_TEST, 173)
    tr_cols, te_cols = _split_cols(cols, ADULT_TRAIN)
    inputs = [c for c in tr_cols if c != "income"]
    feat = Featurize().set_params(input_cols=inputs, output_col="features",
                                  one_hot_encode_categoricals=False) \
        .fit(DataFrame.from_dict(tr_cols))
    X = stack_vector_column(feat.transform(DataFrame.from_dict(
        tr_cols)).collect()["features"])
    Xt = stack_vector_column(feat.transform(DataFrame.from_dict(
        te_cols)).collect()["features"])
    names = [f"f{j}" for j in range(X.shape[1])]
    y = (tr_cols["income"] == ">50K").astype(np.float64)
    df = DataFrame.from_dict({"features": vector_column(list(X)),
                              "label": y})
    t0 = time.perf_counter()
    model, launches = counted(lambda: LightGBMClassifier().fit(df))
    fit_s = time.perf_counter() - t0
    if X.shape[1] != 14 or any(not n for n in launches.values()):
        raise AssertionError(f"explain (a): {X.shape[1]} columns, "
                             f"launches {launches}")
    rows = DataFrame.from_dict({n: Xt[:EXPLAIN_ROWS, j]
                                for j, n in enumerate(names)})
    background = DataFrame.from_dict({n: X[:SHAP_BACKGROUND, j]
                                      for j, n in enumerate(names)})
    cpu_model = model.copy().set_params(device="cpu")
    rec = {"rows": int(len(X)), "columns": int(X.shape[1]),
           "fit_s": fit_s, "launches": launches}
    for kind, cls, kw in (
            ("shap", TabularSHAP, dict(num_samples=SHAP_SAMPLES,
                                       background_data=background)),
            ("lime", TabularLIME, {})):
        runs = {}
        for where, m, extra in (("card", model, {}),
                                ("cpu", cpu_model, {"device": "cpu"})):
            exp = recorded(cls, model=m, input_col="features",
                           input_cols=names, output_col="w",
                           target_classes=[1], **kw, **extra)
            t0 = time.perf_counter()
            out, more = counted(lambda: exp.transform(rows).collect())
            runs[where] = (exp.rows_seen, out, time.perf_counter() - t0,
                           more)
        (card, out, card_s, more), (cpu, _, cpu_s, _) = runs["card"], \
            runs["cpu"]
        if any(more.values()):
            raise AssertionError(f"explain (a) {kind}: kernels launched "
                                 f"while explaining: {more}")
        d_score = d_coef = local = 0.0
        for a, b in zip(card, cpu):
            if not np.array_equal(a["mask"], b["mask"]):
                raise AssertionError(f"explain (a) {kind}: masks differ")
            d_score = max(d_score, float(np.abs(a["scores"] -
                                                b["scores"]).max()))
            d_coef = max(d_coef, float(np.abs(a["coefs"] -
                                              b["coefs"]).max()))
            local = max(local, abs(float(a["coefs"].sum()) + a["intercept"]
                                   - float(a["scores"][0])))
        coef_max = max(float(np.abs(a["coefs"]).max()) for a in card)
        tol = SHAP_TOL if kind == "shap" else LASSO_TOL * coef_max
        if d_score > 1e-6 or d_coef > tol or (kind == "shap" and
                                              local > LOCAL_ACCURACY):
            raise AssertionError(
                f"explain (a) {kind}: scores card vs CPU {d_score}, "
                f"coefficients {d_coef} (tolerance {tol}), local accuracy "
                f"{local}")
        for i, a in enumerate(card):
            if not np.array_equal(out["w"][i], a["coefs"]):
                raise AssertionError(f"explain (a) {kind}: output column")
        n_samples = len(card[0]["scores"])
        if kind == "lime":
            rec["lasso"] = lasso_replayed_vs_eager(
                card, exp.get("regularization"), "explain (a) lime")
        rec[kind] = {"samples_per_row": n_samples, "card_s": card_s,
                     "cpu_s": cpu_s, "max_abs_dscore": d_score,
                     "max_abs_dcoef": d_coef, "coef_tolerance": tol,
                     "local_accuracy": local,
                     "samples_per_s": EXPLAIN_ROWS * n_samples / card_s,
                     "r2": [float(v) for v in out["r2"]]}
        log(f"[explain] (a) Tabular{kind.upper()} on {EXPLAIN_ROWS} rows x "
            f"{n_samples:,} samples over LightGBMClassifier() (fit on the "
            f"card {fit_s:.2f} s, {launches} launches; {X.shape[1]} "
            f"index-encoded columns): masks card = CPU, scores within "
            f"{d_score:.1e}, coefficients within {d_coef:.1e} "
            f"(tolerance {tol:.1e})"
            + (f", sum + intercept = own score within {local:.1e}"
               if kind == "shap" else "")
            + f"; {card_s:.2f} s on the card "
            f"({EXPLAIN_ROWS * n_samples / card_s:,.0f} samples/s), "
            f"{cpu_s:.2f} s on the CPU"
            + (f"; the lasso replayed (one graph of 200 ISTA steps) = "
               f"eager bit for bit on every row, "
               f"{rec['lasso']['replayed_ms_per_call']:.3f} ms a call "
               f"replayed against {rec['lasso']['eager_ms_per_call']:.3f} "
               f"ms eager" if kind == "lime" else ""))
    return rec


_BACKBONE = {}


def explain_backbone():
    """The dnn phase's seeded ResNet-50 (float32, eval), built once."""
    if "m" not in _BACKBONE:
        _BACKBONE["m"] = seeded_resnet50(
            torch.Generator().manual_seed(50)).eval()
    return _BACKBONE["m"]


class _Probabilities(torch.nn.Module):
    """ImageNet normalisation -> a ResNet -> softmax: class probabilities
    of (batch, 224, 224, 3) float pixels in [0, 255]."""

    def __init__(self, backbone):
        super().__init__()
        self.backbone = backbone

    def forward(self, x):
        from mmlspark_tpu_torch.ops import image
        return torch.softmax(self.backbone(image.normalize(x)), dim=-1)


def procedural_image(seed: int) -> np.ndarray:
    """A ``DNN_HW`` x ``DNN_HW`` x 3 float64 image of a few flat-coloured
    discs and a bar on a gradient, from ``seed``."""
    hw = DNN_HW
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float64)
    img = np.stack([xx / hw * 120, yy / hw * 120,
                    np.full((hw, hw), 60.0)], axis=-1)
    for _ in range(4):
        cy, cx, r = rng.uniform(30, hw - 30, 2).tolist() + [rng.uniform(15,
                                                                        45)]
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    x0 = int(rng.integers(0, hw - 40))
    img[:, x0:x0 + 12] = rng.uniform(0, 255, 3)
    return img


def explain_image(dev) -> dict:
    """(b) ``ImageLIME`` (256 samples) over the seeded ResNet-50 behind
    ``JaxModel`` on 4 procedural 224 x 224 images."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.dl import JaxModel
    from mmlspark_tpu_torch.explainers import (ImageLIME, lasso_regression,
                                               slic_superpixels)
    backbone = explain_backbone()
    model = JaxModel(input_col="image", output_col="probability",
                     batch_size=DNN_BATCH).set_model(
                         module=_Probabilities(backbone))
    imgs = np.empty(IMAGE_LIME_IMAGES, dtype=object)
    for i in range(IMAGE_LIME_IMAGES):
        imgs[i] = procedural_image(180 + i)
    df = DataFrame.from_dict({"image": imgs})
    exp = recorded(ImageLIME, model=model, input_col="image",
                   output_col="w", num_samples=IMAGE_LIME_SAMPLES,
                   regularization=IMAGE_LIME_ALPHA)
    probe = DataFrame.from_dict({"image": np.stack(
        [imgs[0].astype(np.float32)] * IMAGE_LIME_SAMPLES)})
    model.transform(probe).collect()                 # warm: weights placed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.transform(probe).collect()
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = exp.transform(df).collect()
    explain_s = time.perf_counter() - t0
    d_coef = 0.0
    segs, nonzero = [], []
    for i, row in enumerate(exp.rows_seen):
        sp = slic_superpixels(imgs[i], 16.0, 130.0)
        if not np.array_equal(out["superpixels"][i], sp) or \
                len(row["coefs"]) != sp.max() + 1:
            raise AssertionError("explain (b): superpixels card != CPU")
        segs.append(int(sp.max()) + 1)
        cpu, cpu_b = lasso_regression(row["mask"], row["scores"],
                                      row["weights"], alpha=IMAGE_LIME_ALPHA,
                                      device="cpu")
        if not np.any(cpu) or not np.any(row["coefs"]):
            raise AssertionError("explain (b): every coefficient zero")
        d = max(float(np.abs(row["coefs"] - cpu).max() /
                      np.abs(cpu).max()),
                abs(row["intercept"] - cpu_b) / abs(cpu_b))
        d_coef = max(d_coef, d)
        nonzero.append(int(np.count_nonzero(row["coefs"])))
        if not np.isfinite(row["scores"]).all():
            raise AssertionError("explain (b): non-finite scores")
    if d_coef > LASSO_TOL:
        raise AssertionError(f"explain (b): lasso card vs CPU {d_coef} x "
                             f"max|coef| > {LASSO_TOL}")
    lasso = lasso_replayed_vs_eager(exp.rows_seen, IMAGE_LIME_ALPHA,
                                    "explain (b)")
    n = IMAGE_LIME_IMAGES * IMAGE_LIME_SAMPLES
    rec = {"images": IMAGE_LIME_IMAGES, "samples": IMAGE_LIME_SAMPLES,
           "superpixels": segs, "explain_s": explain_s,
           "samples_per_s": n / explain_s,
           "model_samples_per_s": IMAGE_LIME_SAMPLES / score_s,
           "lasso_rel_err": d_coef, "nonzero_coefs": nonzero,
           "lasso": lasso,
           "alpha": IMAGE_LIME_ALPHA, "r2": [float(v) for v in out["r2"]]}
    log(f"[explain] (b) ImageLIME ({IMAGE_LIME_SAMPLES} samples) over the "
        f"seeded ResNet-50 (float32, JaxModel) on {IMAGE_LIME_IMAGES} "
        f"procedural {DNN_HW} x {DNN_HW} images ({segs} superpixels, = the "
        f"CPU's): {explain_s:.2f} s, {n / explain_s:,.0f} samples/s end to "
        f"end ({IMAGE_LIME_SAMPLES / score_s:,.0f}/s through the model "
        f"alone); alpha {IMAGE_LIME_ALPHA}: {nonzero} nonzero coefficients, "
        f"r2 {[round(float(v), 4) for v in out['r2']]}; the lasso card vs "
        f"CPU on the same inputs within {d_coef:.1e} x max|coef|, replayed "
        f"= eager bit for bit, {lasso['replayed_ms_per_call']:.3f} ms a "
        f"call replayed against {lasso['eager_ms_per_call']:.3f} ms eager "
        f"({lasso['features']} superpixels x {lasso['samples']} samples)")
    return rec


def access_frame(seed: int):
    """``AA_TENANTS`` tenants of ``AA_USERS`` users in ``AA_DEPTS``
    departments over ``AA_RES`` resources (split by department) with
    ``AA_PAIRS`` distinct (user, resource) pairs each, 95% inside the
    user's department, access counts geometric; and ``AA_HELD`` held-out
    accesses of tenant 0, ``AA_PLANTED`` of them across departments.
    Returns (columns, held columns, planted mask)."""
    rng = np.random.default_rng(seed)
    unames = np.asarray([f"u{i}" for i in range(AA_USERS)], dtype=object)
    rnames = np.asarray([f"r{i}" for i in range(AA_RES)], dtype=object)
    per = AA_RES // AA_DEPTS

    def draw(n, cross):
        u = rng.integers(0, AA_USERS, n)
        dept = u % AA_DEPTS
        dept = np.where(cross, (dept + rng.integers(1, AA_DEPTS, n))
                        % AA_DEPTS, dept)
        return u, dept * per + rng.integers(0, per, n)

    parts = {"tenant": [], "user": [], "res": [], "count": []}
    for t in range(AA_TENANTS):
        keys = np.zeros(0, np.int64)
        while len(keys) < AA_PAIRS:                  # distinct pairs
            m = int(AA_PAIRS * 1.05)
            u, r = draw(m, rng.random(m) < 0.05)
            keys = np.unique(np.concatenate([keys, u.astype(np.int64)
                                             * AA_RES + r]))
        keys = rng.choice(keys, AA_PAIRS, replace=False)
        parts["tenant"].append(np.full(AA_PAIRS, f"t{t}", dtype=object))
        parts["user"].append(unames[keys // AA_RES])
        parts["res"].append(rnames[keys % AA_RES])
        parts["count"].append(rng.geometric(0.3, AA_PAIRS).astype(
            np.float64))
    cols = {k: np.concatenate(v) for k, v in parts.items()}
    planted = rng.random(AA_HELD) < AA_PLANTED
    u, r = draw(AA_HELD, planted)
    held = {"tenant": np.full(AA_HELD, "t0", dtype=object),
            "user": unames[u], "res": rnames[r]}
    return cols, held, planted


@contextlib.contextmanager
def timed_als(log_to: list):
    """Books each ``sparse_als`` call's seconds (the card synchronized)."""
    from mmlspark_tpu_torch.cyber import anomaly
    inner = anomaly.sparse_als

    def wrapper(*a, **kw):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        log_to.append({"s": time.perf_counter() - t0, "iters": a[7],
                       "nnz": len(a[0]),
                       "device": str(kw.get("device"))})
        return out

    anomaly.sparse_als = wrapper
    try:
        yield
    finally:
        anomaly.sparse_als = inner


def explain_anomaly(dev) -> dict:
    """(c) ``AccessAnomaly()`` on 3 tenants of 1,000,000 distinct pairs
    (the half-sweep's two programs captured in the first tenant's first
    sweep, replayed since), card = CPU on one tenant, the same estimator
    refitted on it (capturing nothing) and a fresh one with the programs
    eager, explicit mode on one, scoring 100,000 held-out accesses with 1%
    planted across departments."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.cyber import AccessAnomaly, anomaly
    from mmlspark_tpu_torch.cyber.anomaly import _CHUNK_NNZ
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    from mmlspark_tpu_torch.train.metrics import _auc
    t_part = part_start("explain (c)")
    launches0 = CH.launch_counts()
    t0 = time.perf_counter()
    cols, held, planted = access_frame(181)
    df = DataFrame.from_dict(cols)
    data_s = time.perf_counter() - t0
    sweeps = {mode: [] for mode in ("replayed", "cpu", "again", "eager",
                                    "explicit")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fresh_pool()
    est = AccessAnomaly().set_params(likelihood_col="count")
    with timed_als(sweeps["replayed"]):
        t0 = time.perf_counter()
        model = est.fit(df)
        fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    pool_own = pool_bytes()
    progs = est._programs()
    k = model.get("factors")["t0"]["U"].shape[1]
    held_df = DataFrame.from_dict(held)
    t0 = time.perf_counter()
    scores = model.transform(held_df).collect()["anomaly_score"]
    score_s = time.perf_counter() - t0
    auc = _auc(planted.astype(np.float64), scores)
    unseen = model.transform(DataFrame.from_dict({
        "tenant": np.asarray(["t0", "t1"], dtype=object),
        "user": np.asarray(["nobody", "u1"], dtype=object),
        "res": np.asarray(["r1", "nothing"], dtype=object)})).collect()[
            "anomaly_score"]
    if auc < 0.9 or not (unseen == 3.0).all():
        raise AssertionError(f"explain (c): planted AUC {auc}, unseen "
                             f"scores {unseen}")
    # tenant 0 alone on the CPU, again by the same estimator (replays
    # only), and with the programs eager
    t0_df = DataFrame.from_dict({k_: v[:AA_PAIRS] for k_, v in
                                 cols.items()})
    captures = (progs.accumulate.captures, progs.solve.captures)
    with timed_als(sweeps["cpu"]):
        cpu = AccessAnomaly().set_params(likelihood_col="count",
                                         device="cpu").fit(t0_df)
    with timed_als(sweeps["again"]):
        again = est.fit(t0_df)
    if (progs.accumulate.captures, progs.solve.captures) != captures:
        raise AssertionError(f"explain (c): the second fit captured "
                             f"{program_stats(progs.accumulate)} "
                             f"{program_stats(progs.solve)}")
    with eager_plain_programs(anomaly), timed_als(sweeps["eager"]):
        eager = AccessAnomaly().set_params(likelihood_col="count").fit(t0_df)
    fc, fh, fa, fe = (m.get("factors")["t0"] for m in (model, cpu, again,
                                                       eager))
    d = {key: float(np.abs(fc[key] - fh[key]).max() /
                    np.abs(fh[key]).max()) for key in ("U", "V")}
    rerun = {key: float(np.abs(fc[key] - fa[key]).max() /
                        np.abs(fa[key]).max()) for key in ("U", "V")}
    vs_eager = {key: float(np.abs(fa[key] - fe[key]).max() /
                           np.abs(fe[key]).max()) for key in ("U", "V")}
    cpu_scores = cpu.transform(held_df).collect()["anomaly_score"]
    d_score = float(np.abs(scores - cpu_scores).max() /
                    np.abs(cpu_scores).max())
    if max(d.values()) > AA_TOL or d_score > AA_TOL or \
            max(vs_eager.values()) > AA_TOL:
        raise AssertionError(f"explain (c): card vs CPU factors {d}, "
                             f"scores {d_score}, replayed vs eager "
                             f"{vs_eager} (tolerance {AA_TOL})")
    # explicit mode, complement negatives, on tenant 0
    with timed_als(sweeps["explicit"]):
        t1 = time.perf_counter()
        explicit = AccessAnomaly().set_params(
            likelihood_col="count", implicit_cf=False,
            complementset_factor=2).fit(t0_df)
        explicit_s = time.perf_counter() - t1
    ex_scores = explicit.transform(held_df).collect()["anomaly_score"]
    ex_auc = _auc(planted.astype(np.float64), ex_scores)
    if not np.isfinite(ex_scores).all():
        raise AssertionError("explain (c): explicit scores not finite")
    if CH.launch_counts() != launches0:
        raise AssertionError("explain (c): a Hopper kernel was launched")
    sweep = {mode: [c["s"] / c["iters"] for c in calls]
             for mode, calls in sweeps.items()}
    rec = {"tenants": AA_TENANTS, "users": AA_USERS, "resources": AA_RES,
           "pairs": AA_PAIRS, "rank": int(k), "data_s": data_s,
           "fit_s": fit_s, "als_calls": sweeps,
           "sweep_s": sweep, "sweep_s_card": sweep["replayed"],
           "score_s": score_s,
           "scores_per_s": AA_HELD / score_s, "auc": auc,
           "explicit_auc": ex_auc, "explicit_fit_s": explicit_s,
           "card_vs_cpu_rel": d, "score_rel": d_score,
           "card_rerun_rel": rerun, "replayed_vs_eager_rel": vs_eager,
           "peak_bytes": int(peak),
           "chunk_buffer_bytes": _CHUNK_NNZ * k * k * 4,
           "programs": {"accumulate": program_stats(progs.accumulate),
                        "solve": program_stats(progs.solve)},
           "graph_pool_bytes": pool_own}
    log(f"[explain] (c) AccessAnomaly() on {AA_TENANTS} tenants x "
        f"{AA_PAIRS:,} pairs ({AA_USERS:,} users, {AA_RES:,} resources, "
        f"rank {k}, 10 sweeps): fit {fit_s:.2f} s (data {data_s:.1f} s), "
        f"ALS sweep s a tenant replayed "
        f"{', '.join(f'{x:.4f}' for x in sweep['replayed'])} (the first "
        f"capturing), tenant 0 again {sweep['again'][0]:.4f} s replayed, "
        f"{sweep['eager'][0]:.4f} s eager (CPU {sweep['cpu'][0]:.3f} s); "
        f"cyber.als_accumulate {program_line(progs.accumulate)}, "
        f"cyber.als_solve {program_line(progs.solve)}; the second fit "
        f"captured nothing; their graph pool {pool_own / 2**20:.0f} MiB; "
        f"peak device memory {peak / 2**20:.0f} MiB (the (chunk, k, k) "
        f"buffer {rec['chunk_buffer_bytes'] / 2**20:.0f} MiB); card = CPU "
        f"factors within {max(d.values()):.1e}, scores {d_score:.1e} x max,"
        f" replayed = eager within {max(vs_eager.values()):.1e} (first fit "
        f"vs second {max(rerun.values()):.1e}); {AA_HELD:,} held-out "
        f"scored in {score_s:.2f} s, planted AUC {auc:.4f} (explicit mode "
        f"{ex_auc:.4f}, fit {explicit_s:.2f} s); unseen users 3.0; 0 "
        f"launches of the repository's kernels")
    part_done("explain (c)", t_part, rec)
    return rec


def utterance(seed: int, seconds: float, sr: int = 16000) -> np.ndarray:
    """Seeded speech-like audio: 0.1-0.6 s segments, each a tone of 2-4
    harmonics at 100-3,000 Hz, a noise burst or silence, under an
    envelope, plus a noise floor."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    out = np.zeros(n, np.float32)
    pos = 0
    while pos < n:
        m = min(int(rng.uniform(0.1, 0.6) * sr), n - pos)
        t = np.arange(m) / sr
        kind = rng.random()
        if kind < 0.6:
            f0 = rng.uniform(100, 3000)
            seg = sum(rng.uniform(0.1, 0.4) / h
                      * np.sin(2 * np.pi * f0 * h * t)
                      for h in range(1, int(rng.integers(2, 5))))
        elif kind < 0.85:
            seg = rng.normal(scale=0.2, size=m)
        else:
            seg = np.zeros(m)
        out[pos:pos + m] = seg * np.hanning(m) if m > 1 else seg
        pos += m
    return out + rng.normal(scale=0.005, size=n).astype(np.float32)


def _decode_ids(ids, alphabet) -> str:
    prev, out = 0, []
    for i in ids:
        i = int(i)
        if i != prev and i != 0:
            out.append(alphabet[i])
        prev = i
    return "".join(out)


def _near_ties(ids_a, ids_b, logits_ref, what: str) -> int:
    """Frames whose argmax differs must be near-ties of ``logits_ref``
    (top-2 within ``NEAR_TIE_LOGIT``); returns their count."""
    moved = np.nonzero(ids_a != ids_b)[0]
    for f in moved:
        top = np.sort(logits_ref[f])[-2:]
        if top[1] - top[0] > NEAR_TIE_LOGIT:
            raise AssertionError(f"{what}: frame {f} differs without a "
                                 f"near-tie ({top})")
    return len(moved)


def explain_speech(dev) -> dict:
    """(d) ``SpeechToTextSDK`` on 32 seeded 20 s utterances at 16 kHz in
    0.5 s chunks; ``ConversationTranscription`` on two voices;
    ``SpeechServingModel`` behind ``PipelineServer`` with 16 sessions."""
    import threading
    import urllib.request
    from mmlspark_tpu_torch.cognitive import (ConversationTranscription,
                                              SpeechServingModel,
                                              SpeechToTextSDK,
                                              StreamingRecognizer)
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.io.audio import log_mel
    from mmlspark_tpu_torch.serving import PipelineServer
    rec_card = StreamingRecognizer(chunk_s=SPEECH_CHUNK_S, seed=182)
    rec_eager = StreamingRecognizer(chunk_s=SPEECH_CHUNK_S, seed=182)
    rec_eager._program = eager_captured(rec_eager._encode,
                                        inplace_argnums=(0,))
    rec_cpu = StreamingRecognizer(chunk_s=SPEECH_CHUNK_S, device="cpu")
    rec_cpu.variables = rec_card.variables
    clips = [utterance(183 + i, SPEECH_S) for i in range(SPEECH_UTTERANCES)]
    col = np.empty(len(clips), dtype=object)
    for i, c in enumerate(clips):
        col[i] = c
    df = DataFrame.from_dict({"audio": col})
    steps = {"card": [], "eager": [], "cpu": []}

    def tap(rec, key, events=False):
        """Keep each step's logits (read after the step's program, never
        inside it: a capture refuses a sync); on the card, time the
        program with events.  Returns the untapped program."""
        inner = rec._program

        def program(v, c, f):
            if events:
                a, b = torch.cuda.Event(enable_timing=True), \
                    torch.cuda.Event(enable_timing=True)
                a.record()
            out = inner(v, c, f)
            if events:
                b.record()
            steps[key].append((out[1][0].float().cpu().numpy(),
                               (a, b) if events else None))
            return out
        rec._program = program
        return inner

    untapped = tap(rec_card, "card", events=True)
    tap(rec_eager, "eager", events=True)
    tap(rec_cpu, "cpu")
    walls = {}
    for key, rec_k in (("card", rec_card), ("eager", rec_eager)):
        stt_k = SpeechToTextSDK(input_col="audio", output_col="ev",
                                audio_format="pcm", chunk_s=SPEECH_CHUNK_S)
        stt_k.set("recognizer", rec_k)
        stt_k.transform(DataFrame.from_dict({"audio": col[:1]})).collect()
        steps[key].clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_k = stt_k.transform(df).collect()
        torch.cuda.synchronize()
        walls[key] = time.perf_counter() - t0
        if key == "card":
            stt, out = stt_k, out_k
        else:
            out_eager = out_k
    wall = walls["card"]
    n_steps = len(steps["card"])
    device_ms = [a.elapsed_time(b) for _, (a, b) in steps["card"]]
    eager_ms = [a.elapsed_time(b) for _, (a, b) in steps["eager"]]
    host_ms = wall * 1e3 / n_steps
    if len(steps["eager"]) != n_steps or any(
            not np.array_equal(a, b) for (a, _), (b, _) in
            zip(steps["card"], steps["eager"])) or \
            list(out["ev_text"]) != list(out_eager["ev_text"]):
        raise AssertionError("explain (d): replayed logits differ from the "
                             "eager step's")
    speech_prog = program_stats(untapped)
    if speech_prog["captures"] < 1 or speech_prog["replays"] < n_steps - 3:
        raise AssertionError(f"explain (d): the step program {speech_prog}")
    stt_cpu = SpeechToTextSDK(input_col="audio", output_col="ev",
                              audio_format="pcm", chunk_s=SPEECH_CHUNK_S)
    stt_cpu.set("recognizer", rec_cpu)
    out_cpu = stt_cpu.transform(df).collect()
    if len(steps["cpu"]) != n_steps:
        raise AssertionError("explain (d): step counts differ")
    ids_card = np.concatenate([lg.argmax(-1) for lg, _ in steps["card"]])
    ids_cpu = np.concatenate([lg.argmax(-1) for lg, _ in steps["cpu"]])
    ties = _near_ties(ids_card, ids_cpu,
                      np.concatenate([lg for lg, _ in steps["cpu"]]),
                      "explain (d) card vs CPU")
    differ = sum(a != b for a, b in zip(out["ev_text"], out_cpu["ev_text"]))
    if differ and not ties:
        raise AssertionError("explain (d): texts differ without a near-tie")
    # streaming = one full-utterance pass on the card
    frame_at = 0
    stream_ties = 0
    module = rec_card.module
    for i, clip in enumerate(clips):
        feats = log_mel(clip, 16000, rec_card.n_mels)
        with torch.inference_mode():
            _, logits = module(rec_card.init_carry(1),
                               torch.from_numpy(feats[None]).to(dev))
        lg = logits[0].float().cpu().numpy()
        whole = lg.argmax(-1)
        streamed = ids_card[frame_at:frame_at + len(whole)]
        frame_at += len(whole)
        t = _near_ties(streamed, whole, lg, f"explain (d) stream {i}")
        stream_ties += t
        if not t and _decode_ids(whole, rec_card.alphabet) != \
                out["ev_text"][i]:
            raise AssertionError(f"explain (d): utterance {i} streamed "
                                 f"text != one full pass")
    if frame_at != len(ids_card):
        raise AssertionError("explain (d): frame counts differ")
    # two voices: speaker turns card = CPU
    t = np.arange(48_000) / 16000
    voices = np.concatenate([
        sum(0.3 / h * np.sin(2 * np.pi * f0 * h * t) for h in (1, 2, 3))
        * (0.7 + 0.3 * np.sin(2 * np.pi * 3 * t)) for f0 in (150, 2800)]) \
        .astype(np.float32)
    vcol = np.empty(1, dtype=object)
    vcol[0] = voices
    turns = {}
    for where, rec in (("card", rec_card), ("cpu", rec_cpu)):
        ct = ConversationTranscription(input_col="audio", output_col="ev",
                                       audio_format="pcm",
                                       chunk_s=SPEECH_CHUNK_S)
        ct.set("recognizer", rec)
        ev = ct.transform(DataFrame.from_dict({"audio": vcol})).collect()[
            "ev"][0]
        turns[where] = [e["speaker"] for e in ev]
    if turns["card"] != turns["cpu"] or len(set(turns["card"])) < 2:
        raise AssertionError(f"explain (d): speaker turns {turns}")
    # 16 concurrent sessions through PipelineServer
    rec_card._program = untapped
    model = SpeechServingModel(rec_card)
    srv = PipelineServer(model, port=0, mode="continuous").start()
    n_sess = int(SPEECH_SESSION_S * 16000)
    piece = rec_card.chunk_samples // 2
    replies = [None] * SPEECH_SESSIONS
    errors = []

    def post(payload):
        req = urllib.request.Request(
            srv.address, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read().decode())

    def session(s):
        try:
            audio = clips[s][:n_sess]
            for lo in range(0, n_sess - piece, piece):
                post({"session": f"s{s}", "chunk": audio[lo:lo + piece]
                      .tolist()})
            lo = (n_sess - piece) // piece * piece
            replies[s] = post({"session": f"s{s}", "chunk":
                               audio[lo:].tolist(), "final": True})
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=session, args=(s,))
               for s in range(SPEECH_SESSIONS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    serve_s = time.perf_counter() - t0
    srv.stop()
    heads = np.empty(SPEECH_SESSIONS, dtype=object)
    for s in range(SPEECH_SESSIONS):
        heads[s] = clips[s][:n_sess]
    offline = stt.transform(DataFrame.from_dict({"audio": heads})) \
        .collect()["ev_text"]
    bad = [s for s in range(SPEECH_SESSIONS)
           if replies[s] is None or replies[s]["text"] != offline[s]]
    if errors or bad:
        raise AssertionError(f"explain (d): sessions {bad} differ from "
                             f"offline; errors {errors[:3]}")
    rec = {"utterances": SPEECH_UTTERANCES, "seconds_each": SPEECH_S,
           "chunk_s": SPEECH_CHUNK_S, "steps": n_steps, "wall_s": wall,
           "chunks_per_s": n_steps / wall,
           "audio_s_per_s": SPEECH_UTTERANCES * SPEECH_S / wall,
           "host_ms_per_chunk": host_ms,
           "device_ms_per_chunk": float(np.mean(device_ms)),
           "eager_wall_s": walls["eager"],
           "eager_host_ms_per_chunk": walls["eager"] * 1e3 / n_steps,
           "eager_device_ms_per_chunk": float(np.mean(eager_ms)),
           "replayed_logits_equal_eager": True, "program": speech_prog,
           "near_ties_cpu": ties, "texts_differing_cpu": int(differ),
           "near_ties_stream": stream_ties, "speakers": sorted(set(
               turns["card"])), "sessions": SPEECH_SESSIONS,
           "serve_s": serve_s,
           "mean_text_len": float(np.mean([len(t) for t in
                                           out["ev_text"]]))}
    log(f"[explain] (d) SpeechToTextSDK on {SPEECH_UTTERANCES} x "
        f"{SPEECH_S:.0f} s at 16 kHz in {SPEECH_CHUNK_S} s chunks: "
        f"{n_steps:,} steps in {wall:.2f} s ({n_steps / wall:,.0f} "
        f"chunks/s, {SPEECH_UTTERANCES * SPEECH_S / wall:,.0f} s of audio "
        f"a second); per chunk replayed: host {host_ms:.3f} ms wall beside "
        f"device {np.mean(device_ms):.3f} ms (the 2-layer LSTM, head and "
        f"argmax as one captured program: {speech_prog['captures']} "
        f"captures, {speech_prog['replays']} replays); eager: host "
        f"{walls['eager'] * 1e3 / n_steps:.3f} ms beside device "
        f"{np.mean(eager_ms):.3f} ms; replayed logits = eager bit for bit; "
        f"card = "
        f"CPU text ({ties} near-tie frames, {differ} texts differ), "
        f"streamed = one full pass ({stream_ties} near-tie frames); "
        f"speaker turns card = CPU ({sorted(set(turns['card']))}); "
        f"{SPEECH_SESSIONS} concurrent sessions of {SPEECH_SESSION_S:.0f} s "
        f"through PipelineServer in {serve_s:.2f} s, each = its offline "
        f"transcript")
    return rec


def _mock_service():
    """A JSON echo server on 127.0.0.1 recording each request as
    ``tests/test_torch_cognitive_io.py::normalize`` does; a path ending in
    ``/fail`` answers 500.  Returns (server, url, requests)."""
    import base64
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    requests = []
    drop = {"host", "user-agent", "accept-encoding", "connection",
            "content-length", "traceparent", "x-mmlspark-trace-id"}

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length",
                                                        0)))
            try:
                parsed = {"json": json.loads(body) if body else None}
            except ValueError:
                parsed = {"b64": base64.b64encode(body).decode()}
            requests.append({"method": self.command, "path": self.path,
                             "headers": {k.lower(): v for k, v in sorted(
                                 self.headers.items())
                                 if k.lower() not in drop},
                             "body": parsed})
            if self.path.split("?")[0].endswith("/fail"):
                self.send_response(500)
                self.end_headers()
                return
            resp = json.dumps({"echo": parsed, "path": self.path}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(resp)))
            self.end_headers()
            self.wfile.write(resp)

        do_GET = do_POST

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_port}", requests


def explain_io(dev) -> dict:
    """(e) The native CSV parser, binary files and PNGs into
    ``ImageFeaturizer`` on the card, every cognitive service against a
    local mock."""
    import base64
    import shutil
    import tempfile
    from PIL import Image
    import mmlspark_tpu_torch.cognitive as cog
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.dl import FlaxModelPayload, ImageFeaturizer
    from mmlspark_tpu_torch.io import read_binary_files, read_images
    from mmlspark_tpu_torch.io.csv import read_csv
    from mmlspark_tpu_torch.ops import image
    rec = {}
    tmp = tempfile.mkdtemp(prefix="explain_io_")
    try:
        rng = np.random.default_rng(184)
        X = np.round(rng.normal(size=(CSV_ROWS, CSV_COLS)), 5)
        path = os.path.join(tmp, "m.csv")
        t0 = time.perf_counter()
        np.savetxt(path, X, delimiter=",", fmt="%.5f", comments="",
                   header=",".join(f"c{j}" for j in range(CSV_COLS)))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        nat = read_csv(path, numeric_only=True).collect()
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        py = read_csv(path).collect()
        python_s = time.perf_counter() - t0
        for j in range(CSV_COLS):
            c = f"c{j}"
            if not np.array_equal(nat[c], py[c].astype(np.float32)
                                  .astype(np.float64)):
                raise AssertionError(f"explain (e): column {c} native != "
                                     f"the Python route")
        rec["csv"] = {"rows": CSV_ROWS, "cols": CSV_COLS, "write_s": write_s,
                      "native_s": native_s, "python_s": python_s,
                      "native_mb_per_s": os.path.getsize(path) / 2**20 /
                      native_s}
        log(f"[explain] (e) read_csv {CSV_ROWS:,} x {CSV_COLS} "
            f"({os.path.getsize(path) / 2**20:.1f} MiB): the native parser "
            f"{native_s:.2f} s = the Python route {python_s:.2f} s (float32 "
            f"of each cell)")
        # PNGs -> read_images -> ImageFeaturizer on the card
        imgs = rng.integers(0, 256, (PNG_IMAGES, 32, 32, 3), dtype=np.uint8)
        pdir = os.path.join(tmp, "png")
        os.makedirs(pdir)
        for i in range(PNG_IMAGES):
            Image.fromarray(imgs[i]).save(os.path.join(pdir, f"{i:04d}.png"))
        t0 = time.perf_counter()
        blobs = read_binary_files(pdir, pattern="*.png").collect()
        df = read_images(pdir, pattern="*.png")
        decoded = df.collect()["image"]
        read_s = time.perf_counter() - t0
        if len(blobs["bytes"]) != PNG_IMAGES or not all(
                np.array_equal(decoded[i], imgs[i])
                for i in range(PNG_IMAGES)):
            raise AssertionError("explain (e): decoded PNGs differ")
        backbone = explain_backbone().to(dev)
        feat = ImageFeaturizer(input_col="image", output_col="f",
                               height=DNN_HW, width=DNN_HW,
                               batch_size=DNN_BATCH)
        feat.set_model(payload=FlaxModelPayload(module=backbone))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = feat.transform(df).collect()["f"]
        torch.cuda.synchronize()
        feat_s = time.perf_counter() - t0
        with torch.inference_mode():
            first = torch.from_numpy(imgs[:4].astype(np.float32)).to(dev)
            direct = backbone(image.normalize(image.resize(
                first, DNN_HW, DNN_HW)), features=True)
        err = rel_err(np.stack(list(out[:4])), direct)
        if len(out) != PNG_IMAGES or err > 1e-4:
            raise AssertionError(f"explain (e): featurizer {len(out)} "
                                 f"rows, vs backbone {err}")
        rec["images"] = {"images": PNG_IMAGES, "read_s": read_s,
                         "featurize_s": feat_s,
                         "images_per_s": PNG_IMAGES / feat_s,
                         "features_vs_backbone_rel": err}
        log(f"[explain] (e) {PNG_IMAGES:,} PNGs read and decoded in "
            f"{read_s:.2f} s (= the source arrays), ImageFeaturizer "
            f"(ResNet-50 float32 at {DNN_HW}) on the card {feat_s:.2f} s "
            f"({PNG_IMAGES / feat_s:,.0f} images/s), = the backbone within "
            f"{err:.1e}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # every cognitive service against the recorded requests
    with open(os.path.join(ROOT, "tests", "resources",
                           "cognitive_requests.json")) as f:
        recorded = json.load(f)
    cols = {}
    for name, spec in recorded["frame"].items():
        arr = np.empty(len(spec["values"]), dtype=object)
        for i, v in enumerate(spec["values"]):
            arr[i] = base64.b64decode(v) if spec["kind"] == "b64" else v
        cols[name] = arr
    frame = DataFrame.from_dict(cols)
    srv, url, requests = _mock_service()
    try:
        def run(case, path):
            svc = getattr(cog, case["service"])(output_col="out")
            svc.set("url", url + path)
            for k_, v in case["params"].items():
                svc.set(k_, v)
            for k_, c in case["cols"].items():
                svc.set_col(k_, c)
            del requests[:]
            got = svc.transform(frame).collect()
            return got, sorted(requests, key=json.dumps)

        for case in recorded["cases"]:
            got, sent = run(case, case["path"])
            if sent != case["requests"] or any(e is not None
                                               for e in got["error"]):
                raise AssertionError(f"explain (e): {case['service']} "
                                     f"requests differ from the recorded")
        got, _ = run(recorded["cases"][0], "/fail")
        if [e["status_code"] for e in got["error"]] != [500] * len(
                got["error"]) or any(v is not None for v in got["out"]):
            raise AssertionError("explain (e): a 500 did not fill the "
                                 "error column")
    finally:
        srv.shutdown()
        srv.server_close()
    rec["cognitive"] = {"services": len(recorded["cases"])}
    log(f"[explain] (e) {len(recorded['cases'])} cognitive services against "
        f"a mock on 127.0.0.1: requests = the recorded shapes; a 500 fills "
        f"the error column")
    return rec


#: explain (f): 512 video-sized frames, a featurizer's preprocessing
CHAIN_SHAPES = ((480, 640, 3), (360, 480, 3))
CHAIN_COUNTS = (384, 128)
CHAIN_PARTS = (96, 128, 160, 128)
CHAIN_TOL = 1e-4                    # card vs CPU, normalized pixels


def chain_frames(seed: int):
    """``CHAIN_COUNTS`` seeded float32 frames of each of ``CHAIN_SHAPES``
    in a seeded order, cut into partitions of ``CHAIN_PARTS`` rows."""
    from mmlspark_tpu_torch.core import DataFrame
    rng = np.random.default_rng(seed)
    shapes = [sh for sh, n in zip(CHAIN_SHAPES, CHAIN_COUNTS)
              for _ in range(n)]
    col = np.empty(len(shapes), dtype=object)
    for j, i in enumerate(rng.permutation(len(shapes))):
        col[j] = rng.random(shapes[i], dtype=np.float32) * np.float32(255)
    bounds = np.cumsum((0,) + CHAIN_PARTS)
    return DataFrame([{"image": col[lo:hi]}
                      for lo, hi in zip(bounds[:-1], bounds[1:])])


def featurizer_chain(**kw):
    from mmlspark_tpu_torch.opencv import ImageTransformer
    return ImageTransformer(input_col="image", output_col="out", **kw) \
        .resize(256, 256).center_crop(224, 224).blur(5, 5, 1.0) \
        .normalize().unroll()


def explain_chain(dev) -> dict:
    """(f) ``ImageTransformer``'s chain ``resize(256, 256) ->
    center_crop(224, 224) -> blur(5, 5, 1.0) -> normalize() -> unroll()``
    on 512 frames of two shapes in 4 partitions: transformed twice on the
    card (the first captures ``opencv.image_chain`` per row bucket, the
    second replays only), with the chain eager, and on the CPU."""
    from mmlspark_tpu_torch.opencv import image_transformer
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    t_part = part_start("explain (f)")
    launches0 = CH.launch_counts()
    t0 = time.perf_counter()
    df = chain_frames(190)
    data_s = time.perf_counter() - t0
    n = sum(CHAIN_PARTS)
    t = featurizer_chain()
    outs, walls = {}, {}
    fresh_pool()
    for mode in ("first", "replayed", "eager", "cpu"):
        m, ctx = t, contextlib.nullcontext()
        if mode == "eager":
            ctx = eager_plain_programs(image_transformer)
        with ctx:
            if mode in ("eager", "cpu"):
                m = featurizer_chain(**({"device": "cpu"} if mode == "cpu"
                                        else {}))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[mode] = m.transform(df).collect()["out"]
            walls[mode] = time.perf_counter() - t0
        if mode == "first":
            (prog,) = t._programs.values()
            first_stats = program_stats(prog)
            pool_own = pool_bytes()
    stats = program_stats(prog)
    if stats["captures"] != first_stats["captures"] or stats["recaptures"]:
        raise AssertionError(f"explain (f): the second transform captured: "
                             f"{first_stats} -> {stats}")
    d_cpu = 0.0
    for i in range(n):
        a = outs["first"][i]
        if a.shape != (224 * 224 * 3,) or not np.isfinite(a).all():
            raise AssertionError(f"explain (f): row {i} {a.shape}")
        for mode in ("replayed", "eager"):
            if not np.array_equal(a, outs[mode][i]):
                raise AssertionError(f"explain (f): row {i}: the {mode} "
                                     "chain differs from the first")
        d_cpu = max(d_cpu, float(np.abs(a - outs["cpu"][i]).max()))
    if d_cpu > CHAIN_TOL:
        raise AssertionError(f"explain (f): card vs CPU {d_cpu} > "
                             f"{CHAIN_TOL}")
    if CH.launch_counts() != launches0:
        raise AssertionError("explain (f): a Hopper kernel was launched")
    rec = {"frames": n, "shapes": CHAIN_SHAPES, "counts": CHAIN_COUNTS,
           "partitions": CHAIN_PARTS, "data_s": data_s,
           "transform_s": walls,
           "images_per_s": {k: n / v for k, v in walls.items()},
           "card_vs_cpu_max_abs": d_cpu, "replayed_eq_eager": True,
           "signatures": sorted(e.rendered for e in prog._entries.values()),
           "program": stats, "graph_pool_bytes": pool_own}
    ips = rec["images_per_s"]
    log(f"[explain] (f) ImageTransformer resize(256, 256) -> "
        f"center_crop(224, 224) -> blur(5, 5, 1.0) -> normalize() -> "
        f"unroll() on {n} float32 frames ({CHAIN_COUNTS[0]} x "
        f"{CHAIN_SHAPES[0]}, {CHAIN_COUNTS[1]} x {CHAIN_SHAPES[1]}) in "
        f"partitions of {CHAIN_PARTS}: {ips['replayed']:,.0f} images/s "
        f"replayed ({walls['replayed']:.2f} s), {ips['first']:,.0f} the "
        f"first transform (capturing), {ips['eager']:,.0f} eager, "
        f"{ips['cpu']:,.0f} CPU; opencv.image_chain {program_line(prog)} "
        f"over {len(rec['signatures'])} row-bucket signatures, the second "
        f"transform captured nothing; its graph pool "
        f"{pool_own / 2**20:.0f} MiB; replayed = eager bit for bit, card = "
        f"CPU within {d_cpu:.1e} (gate {CHAIN_TOL}); 0 "
        f"launches")
    part_done("explain (f)", t_part, rec)
    return rec


def explain_phase(dev, smi: str):
    t0 = time.perf_counter()
    rec = {"card": smi}
    launches = None
    for name, part in (("tabular", explain_tabular), ("image",
                                                      explain_image),
                       ("anomaly", explain_anomaly),
                       ("speech", explain_speech), ("io", explain_io),
                       ("chain", explain_chain)):
        t1 = time.perf_counter()
        rec[name] = part(dev)
        rec[name]["seconds"] = time.perf_counter() - t1
        if name == "tabular":
            launches = rec[name]["launches"]
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t0
    DETAIL["explain"] = rec
    log(f"[explain] launches of the repository's Hopper kernels on the "
        f"path: {launches} (the LightGBM fit; the explainers, ALS, speech, "
        f"io and the image chain run none)")
    return launches


def harness_seeds(dev) -> dict:
    """(b) Every ``seed_objects()`` entry on the default device (the card):
    ``ExperimentFuzzing`` and ``SerializationFuzzing`` (reloaded = fitted
    within the reference's atol 1e-5); the sweep's launches are the path's,
    and each LightGBM seed's own must reach both kernels."""
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    from mmlspark_tpu_torch.testing import (ExperimentFuzzing,
                                            SerializationFuzzing)
    from mmlspark_tpu_torch.testing.seeds import seed_objects
    objs = seed_objects()
    if len(objs) != 17:
        raise AssertionError(f"harness (b): {len(objs)} seeds, not 17")
    per, total = {}, {}
    for name, obj in objs.items():
        if "device" in obj.stage._params and obj.stage.is_set("device"):
            raise AssertionError(f"harness (b): {name} is not on the card")
        t1 = time.perf_counter()

        def sweep():
            _, out = ExperimentFuzzing.run(obj)
            if out.count() <= 0:
                raise AssertionError(f"harness (b): {name} gave no rows")
            SerializationFuzzing.run(obj)
        _, counts = counted(sweep)
        if name.startswith("LightGBM") and min(counts.values()) <= 0:
            raise AssertionError(f"harness (b): {name}'s fits launched "
                                 f"{counts}")
        per[name] = {"seconds": time.perf_counter() - t1, **counts}
        total = add_counts(total, counts)
    log(f"[harness] (b) {len(objs)} seeds on the card: experiment and "
        f"save/load fuzzing pass; launches {total} (the three LightGBM "
        f"seeds; " + ", ".join(f"{k} {v['seconds']:.2f} s"
                               for k, v in per.items()) + ")")
    return {"seeds": per, "launches": total}


def harness_delegate(dev) -> dict:
    """(c) ``LightGBMDelegate`` on ``train()`` on the card: called once per
    iteration, and the booster = the undelegated fit's, bit for bit."""
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train
    from mmlspark_tpu_torch.lightgbm.delegate import LightGBMDelegate
    X, y = bench_data(200_000, 31)
    params = GBDTParams(num_iterations=8, num_leaves=31, objective="binary")
    seen = []

    class Recorder(LightGBMDelegate):
        def after_training_iteration(self, iteration, eval_result=None):
            seen.append(iteration)

    # callbacks run once a program call: per iteration here (a chunk of
    # four iterations, the card's default, calls them once, at its last
    # iteration, as the reference's chunked path does)
    os.environ["MMLSPARK_TPU_GBDT_CHUNK"] = "1"
    try:
        plain = train(X, y, params).booster
        hooked, counts = counted(lambda: train(
            X, y, params, callbacks=[Recorder().as_callback()]).booster)
    finally:
        del os.environ["MMLSPARK_TPU_GBDT_CHUNK"]
    if seen != list(range(8)):
        raise AssertionError(f"harness (c): the delegate saw {seen}")
    same_booster(plain, hooked, "harness (c) delegated vs plain")
    log(f"[harness] (c) delegate on train() at 200,000 x {N_FEAT}: called "
        f"once per iteration (8), booster = the plain fit's bit for bit; "
        f"launches {counts}")
    return {"launches": counts, "iterations": len(seen)}


def harness_codegen() -> dict:
    """(d) ``python -m mmlspark_tpu_torch codegen <tmp>`` in a child: its
    manifest lists the in-process registry's 144 stages."""
    import tempfile
    from mmlspark_tpu_torch.codegen import all_stage_classes
    want = sorted(f"{c.__module__}.{c.__qualname__}"
                  for c in all_stage_classes())
    with tempfile.TemporaryDirectory() as d:
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mmlspark_tpu_torch", "codegen", d],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": ROOT})
        if proc.returncode != 0:
            raise AssertionError("harness (d): codegen failed: "
                                 + proc.stderr[-2000:])
        seconds = time.perf_counter() - t1
        with open(os.path.join(d, "params_manifest.json")) as f:
            got = sorted(json.load(f))
    if got != want or len(want) != 144:
        raise AssertionError(f"harness (d): the child's manifest lists "
                             f"{len(got)} stages, the registry {len(want)}")
    log(f"[harness] (d) codegen in a child process in {seconds:.1f} s: "
        f"{len(got)} stages = the in-process registry")
    return {"stages": len(got), "seconds": seconds}


def harness_phase(dev, smi: str):
    """The test harness, codegen and the small utilities on the card."""
    from mmlspark_tpu_torch.utils import ClusterUtil
    t0 = time.perf_counter()
    topo = ClusterUtil.get_topology()
    count = torch.cuda.device_count()
    if (topo.num_devices, topo.platform) != (count, "gpu") or \
            ClusterUtil.default_parallelism(64) != min(64, count):
        raise AssertionError(f"harness (a): topology {topo} on {count} "
                             f"card(s)")
    log(f"[harness] (a) ClusterUtil: {topo.num_devices} device(s), "
        f"platform {topo.platform}, default_parallelism(64) = "
        f"{ClusterUtil.default_parallelism(64)}")
    rec = {"card": smi, "topology": dataclasses.asdict(topo)}
    rec["seeds"] = harness_seeds(dev)
    rec["delegate"] = harness_delegate(dev)
    rec["codegen"] = harness_codegen()
    launches = add_counts(rec["seeds"]["launches"],
                          rec["delegate"]["launches"])
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t0
    DETAIL["harness"] = rec
    log(f"[harness] launches of the repository's Hopper kernels on the "
        f"path: {launches} (the LightGBM seeds' fits and the delegated fit; "
        f"the plain fit is the reference)")
    return launches


# ---------------------------------------------------------------------------
# phase 21: the sharded GBDT, two ranks on the one card over gloo
# ---------------------------------------------------------------------------

SHARDED_WIDTH = 2
SHARDED_FITS = (("level", dict(max_depth=5)), ("leaf", dict(num_leaves=31)),
                ("voting", dict(num_leaves=31, voting_k=20)))


def sharded_rank(fits=SHARDED_FITS, held: bool = True) -> dict:
    """One rank of a sharded world (run by ``parallel.world.World``): the
    bench data from its seed, optionally rank 0's first level-wise tree
    with every kernel call held to its plain version, then each fit of
    ``fits`` with ``shard_rows=True``, its launches and its all_reduce
    book read around it.  Returns the boosters' arrays, fit seconds,
    launches, all_reduce calls, bytes and seconds, accuracy on 100k fresh
    rows."""
    from mmlspark_tpu_torch._device import resolve_device
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    from mmlspark_tpu_torch.parallel import collectives as PC
    from mmlspark_tpu_torch.parallel.mesh import world_rank, world_size
    dev = resolve_device(None)          # the rank's card
    t0 = time.perf_counter()
    X, y = bench_data(N_ROWS, seed=0)
    Xt, yt = bench_data(100_000, seed=1)
    out = {"rank": world_rank(), "world": world_size(), "device": str(dev),
           "data_s": time.perf_counter() - t0, "fits": {}}
    if held:
        checked = {"hist_accumulate": 0, "frontier_finish": 0}
        held_ctx = kernels_held_to_plain(CH, checked) if world_rank() == 0 \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        with held_ctx:
            train(X, y, GBDTParams(num_iterations=1, objective="binary",
                                   max_depth=5, use_quantized_grad=True),
                  shard_rows=True, device=dev)
        torch.cuda.synchronize()
        out["held"] = {"checked": checked, "s": time.perf_counter() - t0}
    for label, kw in fits:
        params = GBDTParams(num_iterations=8, objective="binary",
                            use_quantized_grad=True, **kw)
        torch.cuda.synchronize()
        PC.reset_collective_stats(timed=True)
        CH.reset_launch_counts()
        t0 = time.perf_counter()
        res = train(X, y, params, shard_rows=True, device=dev)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = CH.launch_counts()
        book = PC.collective_stats()
        acc = float(((res.booster.predict(Xt, device=dev) > 0.5)
                     == yt).mean())
        out["fits"][label] = {
            "arrays": {k: np.asarray(getattr(res.booster, k))
                       for k in BOOSTER_ARRAYS},
            "fit_s": fit_s, "launches": launches, "allreduce": book,
            "accuracy": acc, "extras": res.extras,
            "trees": int(res.booster.num_trees)}
    return out


def same_arrays(a: dict, b: dict, what: str) -> None:
    """Raise unless two boosters' arrays are equal bit for bit."""
    for k in BOOSTER_ARRAYS:
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{what}: {k} differs")


def sharded_phase(dev, smi: str):
    """The sharded GBDT: two ranks on the one card, world 1 beside them."""
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train
    from mmlspark_tpu_torch.parallel.world import World
    t_phase = time.perf_counter()
    with World(SHARDED_WIDTH, backend="gloo", timeout_s=600) as w:
        ranks = w.run(sharded_rank)
    world_s = time.perf_counter() - t_phase
    held = ranks[0]["held"]["checked"]
    if held != {"hist_accumulate": 5, "frontier_finish": 5}:
        raise AssertionError(f"sharded: rank 0's held tree checked {held}")
    log(f"[sharded] {smi} | rank 0's first level-wise tree at "
        f"{N_ROWS // SHARDED_WIDTH:,} x {N_FEAT} x {N_BINS} a shard: each of "
        f"its 5 hist_accumulate and 5 frontier_finish (lane decode) calls "
        f"bit-identical to the plain version on the same inputs "
        f"({ranks[0]['held']['s']:.1f} s)")
    X, y = bench_data(N_ROWS, seed=0)
    rec = {"card": smi, "width": SHARDED_WIDTH, "world_s": world_s,
           "ranks": [{k: v for k, v in r.items() if k != "fits"}
                     for r in ranks], "fits": {}}
    launches = {"hist_accumulate": 0, "frontier_finish": 0}
    for label, kw in SHARDED_FITS:
        fits = [r["fits"][label] for r in ranks]
        for r, f in enumerate(fits[1:], 1):
            same_arrays(fits[0]["arrays"], f["arrays"],
                        f"sharded ({label}) rank 0 vs rank {r}")
        for r, f in enumerate(fits):
            if min(f["launches"].values()) <= 0:
                raise AssertionError(f"sharded ({label}) rank {r} launched "
                                     f"{f['launches']}")
            if f["accuracy"] < 0.9:
                raise AssertionError(f"sharded ({label}) rank {r}: accuracy "
                                     f"{f['accuracy']}")
            launches = add_counts(launches, f["launches"])
        one = None
        if label != "voting":
            params = GBDTParams(num_iterations=8, objective="binary",
                                use_quantized_grad=True, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res1 = train(X, y, params, shard_rows=True, device=dev)
            torch.cuda.synchronize()
            one = {"fit_s": time.perf_counter() - t0,
                   "extras": res1.extras}
            arrays1 = {k: np.asarray(getattr(res1.booster, k))
                       for k in BOOSTER_ARRAYS}
            same_arrays(arrays1, fits[0]["arrays"],
                        f"sharded ({label}) world 1 vs world 2")
        trees = fits[0]["trees"]
        per_tree = [f["allreduce"]["all_reduce_bytes"] / trees for f in fits]
        ar_s = [f["allreduce"]["all_reduce_s"] for f in fits]
        rec["fits"][label] = {
            "ranks": [{k: v for k, v in f.items() if k != "arrays"}
                      for f in fits], "world_1": one,
            "allreduce_bytes_per_tree": per_tree, "allreduce_s": ar_s}
        log(f"[sharded] {smi} | ({label}) {dict(kw)}: fit "
            + ", ".join(f"rank {r} {f['fit_s']:.2f} s" for r, f in
                        enumerate(fits))
            + f"; boosters equal on both ranks"
            + (f" and = world 1 bit for bit (world 1 {one['fit_s']:.2f} s)"
               if one else "")
            + f"; accuracy {fits[0]['accuracy']:.4f}; all_reduce "
            f"{fits[0]['allreduce']['all_reduce_calls']} calls, "
            f"{per_tree[0] / 1e6:.3f} MB a tree a rank, "
            + ", ".join(f"rank {r} {s:.3f} s" for r, s in enumerate(ar_s))
            + f"; launches {[f['launches'] for f in fits]}")
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t_phase
    DETAIL["sharded"] = rec
    log(f"[sharded] launches of the repository's Hopper kernels on the "
        f"path (both ranks): {launches}; the world of {SHARDED_WIDTH} "
        f"(start, data, held tree, 3 fits) {world_s:.1f} s")
    return launches


# phase 22: the rest of parallel/, two ranks on the one card over gloo
PARALLEL_WIDTH = 2
PAR_IMAGES, PAR_HW, PAR_SCORE_BATCH = 512, 224, 256
PAR_TRAIN_BATCH, PAR_TRAIN_STEPS, PAR_PREEMPT_AT = 32, 6, 3
PAR_RING = (2, 4, 4096, 64)                   # B, H, L, D
PAR_SEQ_BATCH, PAR_SEQ_STEPS, PAR_SEQ_LR = 2, 3, 0.05
PAR_PIPE = (1024, 8, 256, 3)                  # d, M, mb, steps (S = width)
PAR_MOE = (8, 1024, 4096, 4096, 5)            # E, d, hidden, tokens, steps
PAR_SERVE_REQUESTS = 8


def _tf32_off() -> None:
    """Float32 is float32 in this process (the ranks are processes of
    their own)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _par_dev() -> torch.device:
    """This rank's device: the card (the CPU only in a rehearsal without
    one)."""
    from mmlspark_tpu_torch.parallel.mesh import default_device
    return default_device()


def _par_sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _par_images() -> np.ndarray:
    """The seeded 512 x 224 x 224 x 3 float32 batch every process makes."""
    return np.random.default_rng(90).standard_normal(
        (PAR_IMAGES, PAR_HW, PAR_HW, 3), dtype=np.float32)


def _leg_record(leg: str, t0: float, **more) -> dict:
    """A leg's JSON line: its seconds, this process's collectives by route
    and its peak device memory."""
    from mmlspark_tpu_torch.parallel import collectives as PC
    _par_sync()
    book = PC.collective_stats()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20 \
        if torch.cuda.is_available() else None
    return {"leg": leg, "seconds": time.perf_counter() - t0,
            "routes": book["routes"], "peak_mb": peak, **more}


def _start_leg(timed: bool = True) -> float:
    from mmlspark_tpu_torch.parallel import collectives as PC
    _par_sync()
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    PC.reset_collective_stats(timed=timed)
    return time.perf_counter()


def _rank_counts_reset() -> None:
    """Zero this process's kernel launch counts at the start of a leg's
    work in a rank or executor process (each process counts its own)."""
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    CH.reset_launch_counts()


def _rank_counts() -> dict:
    """This process's kernel launches since :func:`_rank_counts_reset`."""
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    return CH.launch_counts()


class _ImageScorer:
    """The serving leg's stage: request = an image index, reply = that
    image's top class and logit from ResNet-50 scored alone (a world of
    one: ``ModelRunner.__call__`` on one device batch)."""

    def __init__(self, runner, images):
        self.runner, self.images = runner, images

    def reply(self, i: int) -> list:
        with torch.inference_mode():
            x = torch.from_numpy(self.images[int(i)][None]).to(
                self.runner.device)
            logits = self.runner(x)[0]
            return [int(logits.argmax()), float(logits.max())]

    def stage(self):
        from mmlspark_tpu_torch.core import Transformer
        scorer = self

        class Scorer(Transformer):
            def _transform(self, df):
                def per_part(p):
                    out = np.empty(len(p["request"]), dtype=object)
                    for j, r in enumerate(p["request"]):
                        out[j] = scorer.reply(r)
                    return {**p, "reply": out}
                return df.map_partitions(per_part)

            def transform_schema(self, schema):
                return schema

        return Scorer()


def _par_models(work: str) -> dict:
    """The phase's seeded models, drawn once here and saved whole
    (``torch.save`` of the module) under ``work``: every process of the
    phase loads them instead of drawing 25M and 67M truncated normals on
    its host again.  Returns the files."""
    from mmlspark_tpu_torch.parallel.moe import MoELayer
    E, d, H, _, _ = PAR_MOE
    files = {"resnet50": os.path.join(work, "resnet50.pt"),
             "moe": os.path.join(work, "moe.pt")}
    torch.save(seeded_resnet50(torch.Generator().manual_seed(93)),
               files["resnet50"])
    torch.save(MoELayer(E, H, d, generator=torch.Generator().manual_seed(98)),
               files["moe"])
    return files


def _par_load(path: str):
    return torch.load(path, map_location="cpu", weights_only=False)


def parallel_serving_job(mesh, process_id, model_file: str):
    """Leg (a), one executor process of ``run_local_cluster``: ResNet-50
    seeded at full width scores the 512 images through ``ModelRunner``
    batch-sharded over ``data`` (rows all-gathered); then process 0 serves
    a ``WorkerServer`` (with its ``TopologyService``) on ports the OS picks
    and process 1 routes requests to it through ``RoutingClient``, beside
    the stage's direct replies."""
    import torch.distributed as dist
    from mmlspark_tpu_torch.models.runner import ModelRunner
    from mmlspark_tpu_torch.observability import MetricsRegistry
    from mmlspark_tpu_torch.parallel import psum
    from mmlspark_tpu_torch.parallel.mesh import world_rank
    from mmlspark_tpu_torch.serving import (RoutingClient, TopologyService,
                                            WorkerServer)
    _rank_counts_reset()
    _tf32_off()
    torch.backends.cudnn.deterministic = True
    t_start = time.perf_counter()
    model = _par_load(model_file)
    runner = ModelRunner(module=model, name="parallel.resnet50",
                         batch_size=PAR_SCORE_BATCH, device=_par_dev(),
                         registry=MetricsRegistry())
    images = _par_images()
    runner.apply_batch(images[:PAR_SCORE_BATCH])           # warm
    t0 = _start_leg()
    logits = runner.apply_batch(images)
    rec = _leg_record("a.inference", t0, rank=world_rank())
    rec["images_per_s"] = PAR_IMAGES / rec["seconds"]
    # serving: the stage scores at world 1 (the worker's thread must not
    # enter the data mesh's collectives)
    scorer = _ImageScorer(runner, images)
    svc = worker = None
    t1 = time.perf_counter()
    port = 0
    if process_id == 0:
        svc = TopologyService(port=0, registry=MetricsRegistry()).start()
        worker = WorkerServer(scorer.stage(), server_id="rank0",
                              driver_address=svc.address, port=0,
                              registry=MetricsRegistry()).start()
        port = int(svc.address.rsplit(":", 1)[1])
    port = int(psum(torch.tensor([port]), "data", mesh))
    dist.barrier()
    served = []
    if process_id == 1:
        client = RoutingClient(f"http://127.0.0.1:{port}")
        for i in range(PAR_SERVE_REQUESTS):
            idx = (37 * i) % PAR_IMAGES
            served.append((idx, client.request(idx), scorer.reply(idx)))
    dist.barrier()
    if worker is not None:
        worker.stop()
        svc.stop()
    rec.update(serve_s=time.perf_counter() - t1, port=port,
               process_s=time.perf_counter() - t_start)
    return {"logits": logits, "served": served, "record": rec,
            "launches": _rank_counts()}


def parallel_warm() -> float:
    """A process's one-time costs of the trainer, paid before the legs
    need them (run beside leg (a)): the first ``torch.optim`` optimizer
    (it imports torch's compiler and DTensor stacks, seconds of host
    time) and the first cuDNN convolution.  Returns its seconds."""
    t0 = time.perf_counter()
    dev = _par_dev()
    w = torch.zeros(4, 3, 3, 3, device=dev, requires_grad=True)
    opt = torch.optim.SGD([w], lr=0.1, momentum=0.9)
    torch.nn.functional.conv2d(torch.zeros(1, 3, 8, 8, device=dev),
                               w).sum().backward()
    opt.step()
    from torch.func import functional_call  # noqa: F401
    _par_sync()
    return time.perf_counter() - t0


def _in_thread(fn, *args):
    """Run ``fn(*args)`` on a thread; ``join()`` returns its result or
    raises its exception."""
    import threading
    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as e:           # noqa: BLE001 — re-raised
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def join():
        t.join()
        if "err" in box:
            raise box["err"]
        return box["out"]

    return join


def _ckpt_save_s() -> float:
    """Seconds this process's checkpoint writer has spent writing
    snapshots (``mmlspark_checkpoint_save_seconds``)."""
    from mmlspark_tpu_torch.observability import get_registry
    fam = get_registry().to_dict().get("mmlspark_checkpoint_save_seconds")
    return sum(x["sum"] for x in fam["samples"]) if fam else 0.0


def _param_print(params) -> list:
    """An exact fingerprint of a nest of float32 tensors: the int64 sums
    of their bit patterns and of the patterns' squares (wrapping)."""
    from mmlspark_tpu_torch.parallel.partition import tree_leaves_with_path
    s = sq = 0
    for _, t in tree_leaves_with_path(params):
        bits = t.detach().reshape(-1).view(torch.int32).to(torch.int64)
        s += int(bits.sum())
        sq += int((bits * bits).sum())
    return [s, sq]


def _par_batches(n: int, width: int):
    """The trainer leg's global batches (every rank makes the same):
    ``width x 32`` images at 224 and labels in [0, 1000)."""
    r = np.random.default_rng(92)
    for _ in range(n):
        yield {"x": r.standard_normal((width * PAR_TRAIN_BATCH, PAR_HW,
                                       PAR_HW, 3), dtype=np.float32),
               "y": r.integers(0, 1000, width * PAR_TRAIN_BATCH)}


def _par_trainer(mesh, model_file: str):
    """A trainer of a fresh copy of the seeded ResNet-50."""
    from mmlspark_tpu_torch.parallel.trainer import (Trainer,
                                                     softmax_cross_entropy)
    return Trainer(_par_load(model_file),
                   lambda ps: torch.optim.SGD(ps, lr=1e-3, momentum=0.9),
                   softmax_cross_entropy, mesh=mesh, has_batch_stats=True)


def _same_state(a, b) -> bool:
    """Two whole host states equal bit for bit (params, optimizer state,
    batch statistics, step)."""
    from mmlspark_tpu_torch.parallel.partition import tree_leaves_with_path
    for x, y in ((a.params, b.params), (a.opt_state, b.opt_state),
                 (a.batch_stats or {}, b.batch_stats or {})):
        fx, fy = dict(tree_leaves_with_path(x)), dict(tree_leaves_with_path(y))
        if fx.keys() != fy.keys() or not all(
                np.array_equal(np.asarray(fx[k]), np.asarray(fy[k]))
                for k in fx):
            return False
    return int(a.step) == int(b.step)


def _orbax_round_trip(tr, state, full, mesh, model_file: str,
                      path: str) -> dict:
    """Every rank: ``state`` saved with ``backend="orbax"``
    (``torch.distributed.checkpoint``, host copies gathered whole) and
    restored into a fresh trainer's template, equal to ``full`` (its whole
    state) bit for bit; save and load seconds."""
    from mmlspark_tpu_torch.parallel.checkpoint import (load_train_state,
                                                        save_train_state)
    t0 = time.perf_counter()
    save_train_state(state, path, backend="orbax", trainer=tr)
    save_s = time.perf_counter() - t0
    tr_o = _par_trainer(mesh, model_file)
    template = tr_o.init_state()
    t0 = time.perf_counter()
    back = load_train_state(path, trainer=tr_o, template=template)
    load_s = time.perf_counter() - t0
    equal = _same_state(full, tr_o.full_state(back))
    del tr_o, back, template
    return {"save_s": save_s, "load_s": load_s, "equal": equal,
            "bytes": sum(os.path.getsize(os.path.join(path, "orbax", f))
                         for f in os.listdir(os.path.join(path, "orbax")))}


def parallel_trainer_rank(ckpt_dir: str, width: int,
                          model_file: str) -> dict:
    """Leg (b), one rank: ResNet-50 at full width trained data-parallel
    (BatchNorm over the global batch) 6 steps through ``train_stream`` with
    a checkpoint every 3; then again preempted after step 3 and resumed at
    world 2.  Fingerprints of the params after every step; the resumed
    run's params against the uninterrupted run's, bit for bit."""
    import shutil
    from mmlspark_tpu_torch.parallel import make_mesh
    from mmlspark_tpu_torch.parallel.mesh import world_rank
    from mmlspark_tpu_torch.utils.resilience import request_preemption
    _rank_counts_reset()
    _tf32_off()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mesh = make_mesh({"data": width})
    out = {"rank": world_rank()}

    def run(label, batches, directory, stop_at=None):
        t_setup = time.perf_counter()
        tr = _par_trainer(mesh, model_file)
        state = tr.init_state()
        setup_s = time.perf_counter() - t_setup
        ckpt0 = _ckpt_save_s()
        prints, marks = [], []

        def cb(step, _evals):
            _par_sync()
            marks.append(time.perf_counter())
            prints.append(_param_print(tr.last_state.params))
            if stop_at is not None and step + 1 == stop_at:
                request_preemption("parallel leg (b)")

        t0 = _start_leg()
        state, losses, stats = tr.train_stream(
            state, batches, checkpoint_dir=directory, checkpoint_every=3,
            callbacks=[cb])
        rec = _leg_record(f"b.{label}", t0, losses=losses,
                          prints=prints, stats=stats, setup_s=setup_s,
                          ckpt_write_s=_ckpt_save_s() - ckpt0,
                          compute_s=stats["compute_s"],
                          step_s=[b - a for a, b in zip(marks, marks[1:])])
        return tr, state, rec

    full_dir = os.path.join(ckpt_dir, "full")
    part_dir = os.path.join(ckpt_dir, "part")
    tr, st_full, out["full"] = run(
        "uninterrupted", _par_batches(PAR_TRAIN_STEPS, width), full_dir)
    n_params = sum(p.numel() for p in
                   tr.module.parameters())
    out["grad_bytes_per_step"] = 4 * (n_params + 1)
    full = tr.full_state(st_full)
    out["orbax"] = _orbax_round_trip(tr, st_full, full, mesh, model_file,
                                     os.path.join(ckpt_dir, "orbax"))
    del tr, st_full
    _, _, out["preempted"] = run(
        "preempted", _par_batches(PAR_TRAIN_STEPS, width), part_dir,
        stop_at=PAR_PREEMPT_AT)
    # the world-1 resume (in the driving process) restores the same
    # snapshot: this world resumes from a copy of it
    resume_dir = os.path.join(ckpt_dir, "resume")
    if world_rank() == 0:
        shutil.copytree(part_dir, resume_dir)
    torch.distributed.barrier()
    tr2, st2, out["resumed"] = run(
        f"resumed_world{width}", _par_batches(PAR_TRAIN_STEPS, width),
        resume_dir)
    res = tr2.full_state(st2)
    from mmlspark_tpu_torch.parallel.partition import tree_leaves_with_path
    a = dict(tree_leaves_with_path(full.params))
    b = dict(tree_leaves_with_path(res.params))
    out["resume_equal"] = all(np.array_equal(a[k], b[k]) for k in a)
    out["full_params"] = full.params if world_rank() == 0 else None
    del tr2, st2
    torch.cuda.empty_cache()
    out["launches"] = _rank_counts()
    return out


def parallel_ring_seq_rank(width: int) -> dict:
    """Leg (c), one rank: ring attention at B 2, H 4, L 4,096, D 64 over
    ``seq`` 2, causal and not, against dense attention; then the
    sequence-parallel step on the encoder at bench.py's LM width
    (``attention_mode="ring"``, a per-token next-token classifier) for 3
    steps at 2 x 4,096 tokens."""
    from mmlspark_tpu_torch.models.transformer import TransformerEncoder
    from mmlspark_tpu_torch.parallel import make_mesh
    from mmlspark_tpu_torch.parallel.mesh import world_rank
    from mmlspark_tpu_torch.parallel.ring_attention import \
        make_ring_attention_fn
    from mmlspark_tpu_torch.parallel.seq_parallel import \
        make_seq_parallel_train_step
    _rank_counts_reset()
    _tf32_off()
    mesh = make_mesh({"data": 1, "seq": width})
    out = {"rank": world_rank(), "ring": {}}
    B, H, L, D = PAR_RING
    dev = _par_dev()
    gen = torch.Generator(device=dev).manual_seed(94)
    q, k, v = (torch.randn(B, H, L, D, device=dev, generator=gen)
               for _ in range(3))
    for causal in (False, True):
        fn = make_ring_attention_fn(mesh, causal=causal)
        t0 = _start_leg()
        got = fn(q, k, v)
        rec = _leg_record("c.ring", t0, causal=causal)
        s = (q @ k.transpose(-1, -2)) / np.sqrt(D)
        if causal:
            s = torch.where(torch.ones(L, L, dtype=torch.bool,
                                       device=dev).tril(), s, -1e30)
        dense = torch.softmax(s, dim=-1) @ v
        del s
        rec["max_abs_err"] = float((got - dense).abs().max())
        if rec["max_abs_err"] > 1e-4:
            raise AssertionError(f"parallel (c): ring attention (causal "
                                 f"{causal}) differs from dense by "
                                 f"{rec['max_abs_err']}")
        out["ring"][str(causal)] = rec
        del got, dense
    tokens, labels, positions = _par_tokens()
    module = TransformerEncoder(**dict(SEQ_LM, attention_mode="ring"),
                                generator=torch.Generator().manual_seed(95))
    init_fn, step_fn = make_seq_parallel_train_step(module, PAR_SEQ_LR,
                                                    mesh)
    params = init_fn(None, tokens, positions)
    losses = []
    t0 = _start_leg()
    for _ in range(PAR_SEQ_STEPS):
        params, loss = step_fn(params, tokens, positions, labels)
        losses.append(float(loss))
    out["seq"] = _leg_record("c.seq", t0, losses=losses)
    del params, module
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    out["launches"] = _rank_counts()
    return out


def _par_tokens():
    from mmlspark_tpu_torch.parallel.seq_parallel import global_positions
    L = SEQ_LM["max_len"]
    rng = np.random.default_rng(96)
    tokens = rng.integers(0, SEQ_LM["vocab_size"],
                          (PAR_SEQ_BATCH, L)).astype(np.int64)
    labels = np.roll(tokens, -1, axis=1)
    return tokens, labels, global_positions(PAR_SEQ_BATCH, L)


def _stage_apply(p, x):
    return torch.tanh(x @ p["W"] + p["b"])


def _mse(outs, y):
    return torch.mean((outs - y) ** 2)


def _pipe_data(S: int):
    d, M, mb, _ = PAR_PIPE
    rng = np.random.default_rng(97)
    params = {"W": (rng.standard_normal((S, d, d), dtype=np.float32)
                    / np.sqrt(d)).astype(np.float32),
              "b": (rng.standard_normal((S, d), dtype=np.float32)
                    * 0.1).astype(np.float32)}
    x = rng.standard_normal((M, mb, d), dtype=np.float32)
    R = rng.standard_normal((d, d), dtype=np.float32) / np.sqrt(d)
    return params, x, np.tanh(x @ R).astype(np.float32)


def parallel_pipe_moe_rank(width: int, moe_file: str) -> dict:
    """Legs (d) and (e), one rank: the GPipe schedule of two
    ``tanh(x @ W + b)`` stages at d 1,024 on 8 microbatches of 256 (its
    forward against the sequential stack, 3 SGD steps); then
    ``MoELayer(E=8, d=1024, hidden=4096)`` on 4,096 tokens over ``expert``
    2 (its forward returned for the world-1 check, 5 Adam steps)."""
    from torch.func import functional_call
    from mmlspark_tpu_torch.parallel import make_mesh
    from mmlspark_tpu_torch.parallel.collectives import live_axes
    from mmlspark_tpu_torch.parallel.mesh import world_rank
    from mmlspark_tpu_torch.parallel.moe import MoELayer, shard_moe_params
    from mmlspark_tpu_torch.parallel.pipeline_parallel import \
        make_pipeline_train_step
    _rank_counts_reset()
    _tf32_off()
    out = {"rank": world_rank()}
    S = width
    d, M, mb, steps = PAR_PIPE
    params, x, y = _pipe_data(S)
    mesh = make_mesh({"pipe": S})
    init_fn, step_fn, fwd_fn = make_pipeline_train_step(
        _stage_apply, S, _mse, learning_rate=0.5, mesh=mesh)
    p = init_fn(params)
    dev = _par_dev()
    t0 = _start_leg()
    got = fwd_fn(p, x)
    ref = torch.from_numpy(x).to(dev).reshape(-1, d)
    for s in range(S):
        ref = torch.tanh(ref @ torch.from_numpy(params["W"][s]).to(dev)
                         + torch.from_numpy(params["b"][s]).to(dev))
    err = float((got - ref.reshape(M, mb, d)).abs().max())
    losses = []
    for _ in range(steps):
        p, loss = step_fn(p, x, y)
        losses.append(float(loss))
    out["pipe"] = _leg_record("d.pipeline", t0, max_abs_err=err,
                              losses=losses)
    if err > 1e-4 or not losses[-1] < losses[0]:
        raise AssertionError(f"parallel (d): forward err {err}, losses "
                             f"{losses}")
    E, d, H, T, steps = PAR_MOE
    mesh = make_mesh({"expert": width})
    module = _par_load(moe_file)
    rng = np.random.default_rng(99)
    xm = torch.from_numpy(rng.standard_normal((T, d),
                                              dtype=np.float32)).to(dev)
    ym = torch.tanh(xm.flip(1))
    pm = shard_moe_params(dict(module.state_dict()), mesh)
    module = module.to(dev)
    t0 = _start_leg()
    with torch.no_grad(), live_axes(mesh):
        fwd = functional_call(module, pm, (xm,))
    leaves = [v.requires_grad_(True) for v in pm.values()]
    opt = torch.optim.Adam(leaves, lr=1e-3)
    losses = []
    for _ in range(steps):
        with live_axes(mesh):
            pred = functional_call(module, pm, (xm,))
            loss = torch.mean((pred - ym) ** 2) + \
                sum(module.losses["moe_aux"])
            loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(loss.detach()))
    out["moe"] = _leg_record("e.experts", t0, losses=losses,
                             w_in_block=list(pm["w_in"].shape))
    out["moe_forward"] = fwd.cpu().numpy()
    del pm, leaves, opt, fwd, module
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    out["launches"] = _rank_counts()
    return out


def _vw_half(path: str, r: int, parts: int) -> None:
    """A child process: part ``r`` of ``parts`` of the vw phase's training
    tweets featurized at the vw phase's bits, saved as CSR arrays (the
    host featurizer's ~10 s run beside the other legs)."""
    text, y, _ = vw_tweets(VW_TRAIN, 161)
    part = slice(r * VW_TRAIN // parts, (r + 1) * VW_TRAIN // parts)
    col, feat_s = vw_featurize(text[part], VW_BITS)
    lens = np.fromiter((len(v["indices"]) for v in col), np.int64, len(col))
    np.savez(path, off=np.concatenate([[0], np.cumsum(lens)]),
             idx=np.concatenate([v["indices"] for v in col]),
             val=np.concatenate([v["values"] for v in col]), y=y[part],
             featurize_s=feat_s)


def _vw_children(work: str, parts: int):
    """Start one featurizing child per rank; returns (processes, files)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    files = [os.path.join(work, f"vw_{r}.npz") for r in range(parts)]
    procs = [ctx.Process(target=_vw_half, args=(f, r, parts), daemon=True)
             for r, f in enumerate(files)]
    for p in procs:
        p.start()
    return procs, files


def parallel_vw_rank(files) -> dict:
    """Leg (f), one rank: ``VowpalWabbitClassifier()`` defaults on this
    rank's part of the ``vw`` phase's training tweets (featurized by a
    child of the driving process), the pass-end average over the
    world."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.parallel.mesh import world_rank
    from mmlspark_tpu_torch.vw import VowpalWabbitClassifier
    _rank_counts_reset()
    r = world_rank()
    t0 = time.perf_counter()
    with np.load(files[r]) as z:
        col = _csr_column((z["off"], z["idx"], z["val"]))
        y, feat_s = z["y"], float(z["featurize_s"])
    df = DataFrame.from_dict({"features": col, "label": y})
    data_s = time.perf_counter() - t0
    est = VowpalWabbitClassifier()
    if not torch.cuda.is_available():          # a rehearsal on the CPU
        est.set_params(device="cpu")
    t0 = _start_leg()
    model = est.fit(df)
    rec = _leg_record("f.vw", t0, rank=r, rows=len(col), data_s=data_s,
                      featurize_s=feat_s)
    return {"weights": np.asarray(model.weights), "record": rec,
            "launches": _rank_counts()}


def parallel_phase(dev, smi: str):
    """The rest of ``parallel/`` on the card (legs (a)-(f)); see the
    module doc.  Two ranks share the one card over gloo."""
    return parallel_legs(dev, smi)


def parallel_legs(dev, smi: str, width: int = PARALLEL_WIDTH,
                  backend: str = "gloo", legs: str = "abcdef"):
    """Legs ``legs`` of the parallel phase in a world of ``width`` ranks
    over ``backend`` (``tools/parallel_nccl.py``: legs (b)-(e), one rank a
    card over NCCL), each held as the module doc says; the world-1
    references run in this process.  Returns the GBDT kernels' launches
    on the legs' paths: each rank and executor process zeroes its own
    counts when its part of a leg starts and returns them when it ends,
    and the phase sums them (none: no leg runs those kernels)."""
    import shutil
    import tempfile
    from mmlspark_tpu_torch.parallel.world import World
    t_phase = time.perf_counter()
    _par_sync()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    launches = {"hist_accumulate": 0, "frontier_finish": 0}
    rec = {"card": smi, "width": width, "backend": backend, "legs": {}}

    def emit(line: dict) -> None:
        if "." not in line["leg"]:
            # a leg's own line: its sub-steps' collectives by route (every
            # process's, summed) and the largest peak of any process
            subs = [x for k, v in rec["legs"].items()
                    if k.split(".")[0] in line["leg"] for x in v]
            routes: dict = {}
            for x in subs:
                for r, b in x.get("routes", {}).items():
                    acc = routes.setdefault(r, {"calls": 0, "bytes": 0,
                                                "s": 0.0})
                    for key in acc:
                        acc[key] += b[key]
            peaks = [x["peak_mb"] for x in subs
                     if x.get("peak_mb") is not None]
            line = dict(line, routes=routes,
                        peak_mb=max(peaks) if peaks else None)
        rec["legs"].setdefault(line["leg"], []).append(line)
        log("[parallel] " + json.dumps(
            {k: v for k, v in line.items()
             if k not in ("prints", "stats", "step_s")}, default=str))

    work = tempfile.mkdtemp(prefix="parallel_")
    vw = ([], [])
    try:
        # the VW data's host featurizer and the world's start run beside
        # leg (a)
        if "f" in legs:
            vw = _vw_children(work, width)
        t0 = time.perf_counter()
        files = _par_models(work)
        rec["models_s"] = time.perf_counter() - t0
        with World(width, backend=backend, timeout_s=600) as w:
            warm_here = _in_thread(parallel_warm)
            warm_ranks = _in_thread(w.run, parallel_warm)
            if "a" in legs:
                launches = add_counts(
                    launches, _leg_serving(dev, width, files, emit))
            rec["warm_s"] = {"driver": warm_here(), "ranks": warm_ranks()}
            if "b" in legs:
                launches = add_counts(
                    launches, _leg_trainer(w, dev, width, files, work, emit))
            if "c" in legs:
                launches = add_counts(
                    launches, _leg_ring_seq(w, dev, width, emit))
            if "d" in legs or "e" in legs:
                launches = add_counts(
                    launches, _leg_pipe_moe(w, dev, width, files, emit))
            if "f" in legs:
                launches = add_counts(launches, _leg_vw(w, vw, emit))
    finally:
        for p in vw[0]:
            if p.is_alive():
                p.kill()
        shutil.rmtree(work, ignore_errors=True)
    _par_sync()
    rec["seconds"] = time.perf_counter() - t_phase
    rec["launches"] = launches
    DETAIL["parallel" if backend == "gloo" else f"parallel_{backend}"] = rec
    log(f"[parallel] {smi} x{width} over {backend} | legs {legs} held in "
        f"{rec['seconds']:.1f} s; launches of the repository's Hopper "
        f"kernels in the legs' processes: {launches}")
    return launches


def _held(what: str, ok: bool, detail: str = "") -> None:
    """Fail the phase unless ``ok``."""
    if not ok:
        raise AssertionError(f"parallel {what} {detail}")


def _all_equal(values) -> bool:
    return all(v == values[0] for v in values[1:])


def _sum_counts(parts) -> dict:
    """The launches the leg's processes returned, summed."""
    total = {"hist_accumulate": 0, "frontier_finish": 0}
    for p in parts:
        total = add_counts(total, p["launches"])
    return total


def _leg_serving(dev, width: int, files: dict, emit) -> None:
    """(a) sharded inference and serving across executor processes; the
    processes import the job by name (no cloudpickle on the card)."""
    import functools
    import importlib
    from mmlspark_tpu_torch.models.runner import ModelRunner
    from mmlspark_tpu_torch.observability import MetricsRegistry
    from mmlspark_tpu_torch.parallel.executor import run_local_cluster
    me = importlib.import_module("chip_smoke")
    t0 = time.perf_counter()
    procs = run_local_cluster(
        functools.partial(me.parallel_serving_job,
                          model_file=files["resnet50"]),
        num_processes=width, devices_per_process=1, timeout_s=300)
    cluster_s = time.perf_counter() - t0
    _tf32_off()
    one = ModelRunner(module=_par_load(files["resnet50"]),
                      name="parallel.world1", batch_size=PAR_SCORE_BATCH,
                      device=dev, registry=MetricsRegistry())
    want = one.apply_batch(_par_images())
    for p in procs:
        emit(p["record"])
    logits = [p["logits"] for p in procs]
    _held("(a)", all(np.array_equal(logits[0], x) for x in logits[1:]),
          "the processes' logits differ")
    err = float(np.abs(logits[0] - want).max() / np.abs(want).max())
    _held("(a)", err <= 1e-4, f"sharded vs world 1 rel err {err}")
    replies = procs[1]["served"]
    _held("(a)", len(replies) == PAR_SERVE_REQUESTS and all(
        list(routed) == list(direct) for _, routed, direct in replies),
        f"routed replies {replies}")
    counts = _sum_counts(procs)
    emit({"leg": "a", "seconds": cluster_s, "ok": True,
          "rel_err_vs_world1": err, "routed": len(replies),
          "launches": counts})
    return counts


def _leg_trainer(w, dev, width: int, files: dict, ckpt: str,
                 emit) -> None:
    """(b) the trainer at ``width``, then its resume here at world 1."""
    from mmlspark_tpu_torch.parallel import make_mesh
    from mmlspark_tpu_torch.parallel.partition import tree_leaves_with_path
    t0 = time.perf_counter()
    ranks = w.run(parallel_trainer_rank, ckpt, width, files["resnet50"])
    b_s = time.perf_counter() - t0
    for r in ranks:
        for key in ("full", "preempted", "resumed"):
            emit(dict(r[key], rank=r["rank"]))
    for key in ("full", "preempted", "resumed"):
        _held("(b)", _all_equal([r[key]["prints"] for r in ranks]),
              f"{key}: the ranks' params differ")
    full0, res0 = ranks[0]["full"], ranks[0]["resumed"]
    _held("(b)", ranks[0]["preempted"]["stats"]["preempted"] == 1.0 and
          res0["stats"]["resumed_from_step"] == PAR_PREEMPT_AT,
          "no preemption and resume")
    _held("(b)", all(r["resume_equal"] for r in ranks) and
          res0["losses"] == full0["losses"][PAR_PREEMPT_AT:] and
          res0["prints"] == full0["prints"][PAR_PREEMPT_AT:],
          f"the world-{width} resume differs from the uninterrupted run")
    t1 = time.perf_counter()
    tr1 = _par_trainer(make_mesh({"data": 1}, device=dev), files["resnet50"])
    st0 = tr1.init_state()
    setup1_s = time.perf_counter() - t1
    ckpt0 = _ckpt_save_s()
    st1, tail, stats1 = tr1.train_stream(
        st0, _par_batches(PAR_TRAIN_STEPS, width),
        checkpoint_dir=os.path.join(ckpt, "part"), resume="must")
    _par_sync()
    one_s = time.perf_counter() - t1
    got = dict(tree_leaves_with_path(tr1.full_state(st1).params))
    ref = dict(tree_leaves_with_path(ranks[0]["full_params"]))
    p_err = max(float(np.abs(got[k] - ref[k]).max() /
                      max(np.abs(ref[k]).max(), 1e-30)) for k in ref)
    want = np.array(full0["losses"][PAR_PREEMPT_AT:])
    l_err = float(np.max(np.abs(np.array(tail) - want) / np.abs(want)))
    _held("(b)", stats1["resharded"] == 1.0 and p_err <= 1e-4 and
          l_err <= 1e-4, f"world-1 resume: params rel err {p_err}, losses "
          f"rel err {l_err}, {stats1}")
    # backend="orbax": the ranks' round trip, then its restore at world 1
    from mmlspark_tpu_torch.parallel.checkpoint import load_train_state
    _held("(b)", all(r["orbax"]["equal"] for r in ranks),
          "orbax round trip on the ranks differs")
    del tr1, st0, st1
    tr_o = _par_trainer(make_mesh({"data": 1}, device=dev), files["resnet50"])
    t2 = time.perf_counter()
    st_o = load_train_state(os.path.join(ckpt, "orbax"), trainer=tr_o,
                            template=tr_o.init_state())
    orbax1_s = time.perf_counter() - t2
    got = dict(tree_leaves_with_path(tr_o.full_state(st_o).params))
    _held("(b)", got.keys() == ref.keys() and all(
        np.array_equal(got[k], ref[k]) for k in ref),
        "orbax checkpoint of the ranks restored at world 1 differs")
    del tr_o, st_o, got
    ar = full0["routes"].get("all_reduce/sum", {})
    emit({"leg": "b", "seconds": b_s, "ok": True,
          "step_s_median": float(np.median(full0["step_s"])),
          "grad_bytes_per_step": ranks[0]["grad_bytes_per_step"],
          "all_reduce_bytes_per_step": ar.get("bytes", 0) / PAR_TRAIN_STEPS,
          "all_reduce_s_per_step": ar.get("s", 0.0) / PAR_TRAIN_STEPS,
          "world1_resume_s": one_s, "world1_setup_s": setup1_s,
          "world1_compute_s": stats1["compute_s"],
          "world1_ckpt_write_s": _ckpt_save_s() - ckpt0,
          "world1_param_rel_err": p_err,
          "world1_loss_rel_err": l_err, "losses": full0["losses"],
          "orbax": {"ranks": [r["orbax"] for r in ranks],
                    "world1_load_s": orbax1_s},
          "launches": _sum_counts(ranks)})
    return _sum_counts(ranks)


def _leg_ring_seq(w, dev, width: int, emit) -> None:
    """(c) ring attention and the sequence-parallel step, then world 1's
    blockwise step here."""
    from mmlspark_tpu_torch.models.transformer import TransformerEncoder
    from mmlspark_tpu_torch.parallel import make_mesh
    from mmlspark_tpu_torch.parallel.seq_parallel import \
        make_seq_parallel_train_step
    t0 = time.perf_counter()
    ranks = w.run(parallel_ring_seq_rank, width)
    c_s = time.perf_counter() - t0
    for r in ranks:
        for line in r["ring"].values():
            emit(dict(line, rank=r["rank"]))
        emit(dict(r["seq"], rank=r["rank"]))
    _tf32_off()
    module = TransformerEncoder(**dict(SEQ_LM, attention_mode="blockwise"),
                                generator=torch.Generator().manual_seed(95))
    # the reference's step is P = data x seq times the mean-loss gradient,
    # so world 1 takes the same step at P times the rate
    init_fn, step_fn = make_seq_parallel_train_step(
        module, PAR_SEQ_LR * width,
        make_mesh({"data": 1, "seq": 1}, device=dev))
    tokens, labels, positions = _par_tokens()
    params = init_fn(None, tokens, positions)
    one = []
    for _ in range(PAR_SEQ_STEPS):
        params, loss = step_fn(params, tokens, positions, labels)
        one.append(float(loss))
    seq = [r["seq"]["losses"] for r in ranks]
    s_err = float(np.max(np.abs(np.array(seq[0]) - one) / np.abs(one)))
    _held("(c)", _all_equal(seq) and s_err <= 1e-4,
          f"seq losses {seq} vs world 1 {one}")
    emit({"leg": "c", "seconds": c_s, "ok": True,
          "ring_max_abs_err": max(l["max_abs_err"] for r in ranks
                                  for l in r["ring"].values()),
          "seq_losses": seq[0], "world1_losses": one,
          "seq_loss_rel_err": s_err, "launches": _sum_counts(ranks)})
    return _sum_counts(ranks)


def _leg_pipe_moe(w, dev, width: int, files: dict, emit) -> None:
    """(d) the pipeline and (e) the experts, the experts' forward against
    world 1's here."""
    t0 = time.perf_counter()
    ranks = w.run(parallel_pipe_moe_rank, width, files["moe"])
    de_s = time.perf_counter() - t0
    for r in ranks:
        emit(dict(r["pipe"], rank=r["rank"]))
        emit(dict(r["moe"], rank=r["rank"]))
    _held("(d)", _all_equal([r["pipe"]["losses"] for r in ranks]),
          "the stages' losses differ")
    E, d, H, T, _ = PAR_MOE
    moe = _par_load(files["moe"]).to(dev)
    xm = torch.from_numpy(np.random.default_rng(99).standard_normal(
        (T, d), dtype=np.float32)).to(dev)
    _tf32_off()
    with torch.no_grad():
        ref = moe(xm).cpu().numpy()
    m_err = max(float(np.abs(r["moe_forward"] - ref).max() /
                      np.abs(ref).max()) for r in ranks)
    _held("(e)", m_err <= 1e-5 and _all_equal(
        [r["moe"]["losses"] for r in ranks]), f"experts: forward rel err "
        f"{m_err}, losses {[r['moe']['losses'] for r in ranks]}")
    emit({"leg": "de", "seconds": de_s, "ok": True,
          "pipe_max_abs_err": max(r["pipe"]["max_abs_err"] for r in ranks),
          "moe_rel_err_vs_world1": m_err, "launches": _sum_counts(ranks)})
    return _sum_counts(ranks)


def _leg_vw(w, vw, emit) -> None:
    """(f) VW's pass-end average over the world."""
    procs, files = vw
    t0 = time.perf_counter()
    for p in procs:
        p.join(timeout=300)
        _held("(f)", p.exitcode == 0, f"featurizing child rc {p.exitcode}")
    wait_s = time.perf_counter() - t0
    ranks = w.run(parallel_vw_rank, files)
    f_s = time.perf_counter() - t0
    for r in ranks:
        emit(r["record"])
    ws = [r["weights"] for r in ranks]
    _held("(f)", all(np.array_equal(ws[0], x) for x in ws[1:]) and
          np.abs(ws[0]).sum() > 0, "the ranks' VW weights differ")
    emit({"leg": "f", "seconds": f_s, "ok": True, "featurize_wait_s": wait_s,
          "nonzero_weights": int(np.count_nonzero(ws[0])),
          "launches": _sum_counts(ranks)})
    return _sum_counts(ranks)


# ---------------------------------------------------------------------------
# phase 23: graft-lint, the port's static-analysis gate
# ---------------------------------------------------------------------------

def analysis_phase(smi: str):
    """``mmlspark_tpu_torch.analysis.cli.main([])`` in this process over
    the checkout's package against its baseline: exit 0, or the run stops.
    It parses source on the host and launches no kernel."""
    import io
    import re
    from mmlspark_tpu_torch.analysis import cli, rule_catalog

    def gate():
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main([])
        return rc, out.getvalue(), time.perf_counter() - t0

    (rc, text, seconds), launches = counted(gate)
    for line in text.splitlines():
        log(f"[analysis] {line}")
    if rc != 0:
        raise AssertionError(f"analysis: graft-lint exited {rc}")
    if any(launches.values()):
        raise AssertionError(f"analysis: Hopper kernels launched {launches}")
    counts = re.search(r"graft-lint: (\d+) findings?, (\d+) baselined, "
                       r"(\d+) stale", text)
    if counts is None:
        raise AssertionError("analysis: no graft-lint summary line")
    rec = {"phase": "analysis", "seconds": seconds, "exit": rc,
           "findings": int(counts[1]), "baselined": int(counts[2]),
           "stale": int(counts[3]),
           "families": sorted({r[:3] for r in rule_catalog()}),
           "launches": launches, "card": smi}
    DETAIL["analysis"] = rec
    print(json.dumps(rec), flush=True)
    return launches


#: the seconds a phase that holds captured programs to their eager runs
#: is given, stated before it runs (each runs its eager baseline beside
#: its replayed path)
PHASE_BUDGET_S = {"vw": 120.0, "featurize": 125.0, "explain": 150.0,
                  "neighbours": 110.0, "parallel": 95.0}
#: the seconds of each part that runs KNN's search, the ALS half-sweep,
#: the image chain or --bfgs replayed and eager, stated before it runs
PART_BUDGET_S = {"neighbours (a)": 50.0, "explain (c)": 45.0,
                 "vw (d)": 35.0, "explain (f)": 20.0}


def phase_start(name: str) -> float:
    """State a budgeted phase's budget; returns its start time."""
    if name in PHASE_BUDGET_S:
        log(f"[{name}] budget {PHASE_BUDGET_S[name]:.0f} s")
    return time.perf_counter()


def phase_done(name: str, t0: float) -> None:
    """Log a phase's seconds (against its budget, where it has one) and
    keep them in the details."""
    seconds = time.perf_counter() - t0
    DETAIL.setdefault("phase_s", {})[name] = seconds
    budget = PHASE_BUDGET_S.get(name)
    log(f"[{name}] phase done in {seconds:.1f} s"
        + (f" (budget {budget:.0f} s)" if budget else ""))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = nvidia_smi()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}")

    from mmlspark_tpu_torch.kernels import _build
    from mmlspark_tpu_torch.lightgbm import GBDTParams
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    log(f"[build] {path} built and loaded in {time.perf_counter() - t0:.1f} s")
    with open(os.path.join(os.path.dirname(path), "nvcc.log")) as f:
        for line in f:
            if any(k in line for k in ("registers", "Compiling entry",
                                       "spill")):
                log("[build] " + line.strip())
    t0 = time.perf_counter()
    host_path = _build.build_host()
    _build.load_host_library()
    log(f"[build] {host_path} (g++) built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    stats = kernel_phase(dev)
    torch.cuda.synchronize()
    phase_done("kernels", t0)

    t0 = time.perf_counter()
    level_launches = slice_phase(dev)
    grower_check(dev)
    fit_phases(GBDTParams(num_iterations=8, max_depth=5,
                          objective="binary"), "slice")
    torch.cuda.synchronize()
    phase_done("slice", t0)

    t0 = time.perf_counter()
    leafwise_grower_check(dev)
    leaf_launches = leaf_slice_phase(dev)
    leaf_step_times(*fit_phases(GBDTParams(num_iterations=8, num_leaves=31,
                                           objective="binary"), "leaf",
                                profile_iterations=2))
    modes_phase(dev)
    torch.cuda.synchronize()
    phase_done("leaf", t0)

    t0 = time.perf_counter()
    data_phase(dev)
    torch.cuda.synchronize()
    phase_done("data", t0)

    t0 = time.perf_counter()
    cat_grower_check(dev)
    cat_launches = cat_phase(dev)
    objectives_phase(dev)
    torch.cuda.synchronize()
    phase_done("cat", t0)

    t0 = time.perf_counter()
    multiclass_grower_check(dev)
    log(f"[multiclass] grower check done in {time.perf_counter() - t0:.1f} s")
    mc_launches = multiclass_phase(dev)
    torch.cuda.synchronize()
    phase_done("multiclass", t0)

    t0 = time.perf_counter()
    rank_launches = ranker_phase(dev)
    torch.cuda.synchronize()
    phase_done("ranker", t0)

    t0 = time.perf_counter()
    stream_launches = streamed_phase(dev)
    torch.cuda.synchronize()
    phase_done("streamed", t0)

    t0 = time.perf_counter()
    dnn_phase(dev)
    torch.cuda.synchronize()
    phase_done("dnn", t0)

    t0 = time.perf_counter()
    seq_phase(dev)
    torch.cuda.synchronize()
    phase_done("seq", t0)

    t0 = time.perf_counter()
    served = serve_phase(dev, smi)
    torch.cuda.synchronize()
    phase_done("serve", t0)

    t0 = time.perf_counter()
    graphs_launches = graphs_phase(dev, smi)
    torch.cuda.synchronize()
    phase_done("graphs", t0)

    t0 = time.perf_counter()
    gbdt_graphs_launches = gbdt_graphs_phase(dev, smi)
    torch.cuda.synchronize()
    phase_done("gbdt_graphs", t0)

    t0 = time.perf_counter()
    fleet_launches = fleet_phase(dev, smi, served)
    del served
    torch.cuda.synchronize()
    phase_done("fleet", t0)

    t0 = time.perf_counter()
    backend_launches = backends_phase(dev, smi)
    torch.cuda.synchronize()
    phase_done("backends", t0)

    t0 = phase_start("vw")
    vw_launches = vw_phase(dev, smi)
    torch.cuda.synchronize()
    phase_done("vw", t0)

    t0 = phase_start("featurize")
    featurize_launches = featurize_phase(dev, smi)
    torch.cuda.synchronize()
    phase_done("featurize", t0)

    t0 = phase_start("neighbours")
    neighbours_launches = neighbours_phase(dev, smi)
    torch.cuda.synchronize()
    phase_done("neighbours", t0)

    t0 = phase_start("explain")
    explain_launches = explain_phase(dev, smi)
    torch.cuda.synchronize()
    phase_done("explain", t0)

    t0 = time.perf_counter()
    harness_launches = harness_phase(dev, smi)
    torch.cuda.synchronize()
    phase_done("harness", t0)

    t0 = time.perf_counter()
    sharded_launches = sharded_phase(dev, smi)
    torch.cuda.synchronize()
    phase_done("sharded", t0)

    t0 = phase_start("parallel")
    parallel_launches = parallel_phase(dev, smi)
    torch.cuda.synchronize()
    phase_done("parallel", t0)

    t0 = time.perf_counter()
    analysis_launches = analysis_phase(smi)
    phase_done("analysis", t0)

    paths = {"level": level_launches, "leaf": leaf_launches,
             "cat_leaf": cat_launches["leaf"],
             "cat_level": cat_launches["level"],
             "multiclass_leaf": mc_launches["leaf"],
             "multiclass_level": mc_launches["level"],
             "ranker": rank_launches,
             "streamed_level": stream_launches["level"],
             "streamed_leaf": stream_launches["leaf"],
             **fleet_launches, "backends": backend_launches,
             "vw": vw_launches, "featurize": featurize_launches,
             "neighbours": neighbours_launches, "explain": explain_launches,
             "graphs": graphs_launches, "gbdt_graphs": gbdt_graphs_launches,
             "harness": harness_launches, "sharded": sharded_launches,
             "parallel": parallel_launches, "analysis": analysis_launches}
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name],
                "launches": sum(c[name] for c in paths.values()),
                "launches_by_path": {k: c[name] for k, c in paths.items()},
                **stats[name]} for name in ("hist_accumulate",
                                            "frontier_finish")]
    for k in kernels:
        for key, v in k.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{k['name']}.{key} is {v}")
    DETAIL.update(card=smi, kind=kind, kernels=kernels)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_detail.json"),
              "w") as f:
        json.dump(DETAIL, f, indent=1, default=str)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
