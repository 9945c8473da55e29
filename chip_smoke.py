#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tensorflowonspark_tpu_torch``) on one
NVIDIA card, end to end — serving, training, training fed through the
cluster plane, the pipeline (TFRecords, data-parallel fit with
checkpoint and resume, export, transform), the model zoo with
``:predict``, the cluster API's streaming, example and TFParallel
paths, the parallel package (ring attention on the flash kernels,
the long-context and Criteo examples, MoE, the pipeline), and the rest
of generation (the contiguous cache, speculative decoding, KV
ship/splice, the generate example), and the serving planes (QoS and
quotas, shedding, dedup and fencing, ``/metrics`` and ``/debug/trace``,
drain, respawn and the chaos sites), and the serving fleet (a router
over replicas in this process and in executor processes, rolling
drain, failover, two-stage prefill -> decode dispatch, the control-state
journal and a standby router), and the fleet's policy planes (the
supervisor restarting a dead scheduler, the SLO autoscaler scaling up
and down, a lost executor replica attributed and replaced), and
supervised training (a killed trainer restored from its checkpoint, an
executor lost and returned under elastic resize, the profiler's trace of
a step), and a decoder whose heads are 256 wide served and trained
through the D-256 kernels, and one whose heads are 512 wide through the
kernels above 256 — and hold its CUDA kernels against their plain
PyTorch versions.

    python3 chip_smoke.py

Phases, stopping with a non-zero exit at the first failure:

1. card — the ``nvidia-smi`` name and power limit;
2. build — every kernel source of the port (``paged_attention.cu``,
   ``flash_attention.cu``, ``wide_attention.cu``), compiled from
   ``csrc/`` with nvcc, all at once;
3. kernel against plain version — ``paged_attention``'s CUDA kernels
   against ``_blockwise`` on the card, fp32 and int8 pools, S_q 1 (the
   split-KV route) and S_q 16 and 128 (the tensor-core query-tiled
   route) at 12 heads of 64, and S_q 16 at 4 heads of 192 (the same
   route, zero-padded to its 256 instantiation), mixed row depths, rows
   whose positions
   overshoot the table, an all-scratch (inactive) row; a second call
   must be bitwise equal, and NaN-poisoned dead pool rows must leave the
   output bitwise unchanged. Then the kernels' times at the serving
   decode shape (split route) and at two prefill shapes of one row
   (tiled route): a 256-token tail at positions 256..511 and a cold
   512-token prompt at 0..511, the traffic's commonest prefill; time
   per eager call, as the flash kernels are timed, and device time
   through CUDA-graph replays beside it; the plain version's time; a
   ``scaled_dot_product_attention`` yardstick over the pre-gathered
   contiguous view, timed both ways (timed here only; the port never
   calls it); and the bound, at the float32-accurate tensor-core rate
   as for the flash kernels and at the CUDA-core float32 rate beside
   it. Then the three flash-attention kernels (forward, dQ, dK/dV)
   through the public autograd path, each against its plain
   version on the inputs it was given, on four cases: (a) the training
   shape, B 8, S 1024, 12 heads of 64, causal, float32; (b) non-causal
   rectangular S_q 128, S_k 384 with a key mask that leaves one batch
   row fully masked (lse -inf, out and grads 0); (c) case (a) in
   bfloat16; (d) a ragged S 48 at block 16; (e) BERT's shape, B 32, S 384,
   bfloat16, a key mask with one fully masked row, not causal. The
   backward takes a random
   dO and a nonzero lse cotangent. Each kernel's time at shape (a)
   beside the plain version's, one
   ``scaled_dot_product_attention(is_causal=True)`` call and its
   autograd backward (timed here only; the port never calls it), the
   bound at the float32-accurate tensor-core rate and, beside it, at
   the CUDA-core float32 rate, each time per eager call and as device
   time through CUDA-graph replays (SDPA's backward in a graph of its
   own); dQ + dK/dV over SDPA's backward; and the
   registers, spills, shared memory and CTAs per SM at D 64 of the
   three flash kernels and of the tensor-core tiled paged kernel;
4. serving — a GPT-2-small-shaped ``DecoderLM`` (vocab 50257, hidden
   768, 12 heads, 12 layers, max_len 1024; random weights from a seed)
   behind the port's ``ModelServer``: 16 ``:generate`` requests from 4
   concurrent HTTP clients (prompts 32-512 tokens, 4 sharing a
   256-token prefix, 32-128 new tokens, greedy), once with float KV and
   once with int8 KV; then the first 8 of those requests through a
   float engine whose pool holds one slot's worth of blocks, so that
   requests are preempted and resumed. The kernel's launch count must
   grow, and the tokens must equal an ``attn_impl="gather"`` engine's
   on the same weights (a divergence is accepted only at a top-2 logit
   tie, gap below 1e-4). Every decode step must have taken the
   split-KV route and every prefill the tensor-core tiled one, once a
   layer;
5. training — the same GPT-2-small ``DecoderLM`` at full depth, float32
   with TF32 off, random weights from the seed. First one forward and
   backward on the initial weights and the first batch, once through
   the kernels and once with attention routed to the plain versions:
   same loss and gradients. Then the port's ``Trainer`` with
   ``adamw(3e-4)`` (optax's defaults, weight decay 1e-4) trains 10
   steps on batches of 8 x 1024 tokens fed through
   ``infeed.device_batches``: rows that repeat a random motif, ``y``
   ``x`` shifted by one. Every loss finite, the mean of the last 3
   below the first, each flash kernel launched exactly 12 times per
   step;
6. cluster — the paper's own path on the port: an engine ``Context``
   with one executor, ``cluster.run(..., InputMode.SPARK)`` with
   ``TFOS_FEED_TRANSPORT=shm``, the 10 batches of phase 5 as 80 records
   of 1025 token ids in 4 partitions through ``tfc.train``. The trainer,
   forked from the executor, builds phase 5's model from the same seed
   on ``cuda:0`` (``NodeContext.initialize_torch``), reads the records
   with ``DataFeed.numpy_batches(8)`` and trains through
   ``infeed.device_batches`` and ``Trainer.train_loop`` with the goodput
   ledger (``cluster_map_fun``, shipped by value from ``__main__``).
   Exactly 10 steps; each record delivered once, in order; the shm ring
   used; each flash kernel launched 12 times per step; losses equal to
   phase 5's within 1e-4 relative; the executor holds no CUDA context
   after training; ``tfc.metrics()`` carries the executor's feed
   counters; ``shutdown`` raises nothing and ``sc.stop`` leaves no
   process. Printed: bootstrap seconds, feed rate over ``tfc.train``,
   ``DataFeed`` wait per step, the cluster-fed step p50 beside phase
   5's, and the goodput ledger's productive share;
7. pipeline — the slice a TFoS user runs end to end: phase 5's 80 rows
   through the port's ``Context.createDataFrame(num_slices=4)`` and
   ``dfutil.saveAsTFRecords`` into ``part-00000..3``;
   ``TFEstimator(pipeline_train_fn).setInputMode("tensorflow").fit(df)``
   on one executor, whose trainer (forked from the executor) joins a
   one-rank NCCL group so the ``Trainer`` runs in
   ``DistributedDataParallel``, reads the shards with the native
   TFRecord codec, trains phase 5's model from the same seed 5 steps
   with ``checkpoint.hook(every_steps=5)`` (``torch.distributed
   .checkpoint``), restores step 5 into a fresh model from another seed
   and trains steps 6-10, exports with ``tfnode.export_saved_model``
   and scores 16 held-out rows with its own model; then
   ``TFModel.transform`` of those rows in the executor from the export,
   on the card. Exactly 10 steps; losses equal to phase 5's within 1e-4
   relative across the resume; the restored parameters and AdamW
   moments bitwise equal to the saved ones (digests); DDP over NCCL;
   each flash kernel launched 12 times per step; the native codec read
   every shard and ``part-*`` holds 80 records; ``transform``'s 16 rows
   agree with the trainer's (``next_token`` equal but at a top-2 tie
   below 1e-4, ``next_logit`` within 1e-4 relative) and ran the flash
   forward 12 times a batch, and a second (warm) ``transform`` gives the
   same rows; the port's ``tfrecord``, ``checkpoint``,
   ``export`` and ``pipeline`` loaded and nothing of JAX, in the driver,
   the executor and the trainer; no process left after ``sc.stop``; the
   work directory (~2 GB: checkpoint and export) removed. Printed: the
   step p50 beside phase 5's, checkpoint bytes and save / restore
   seconds, the goodput ledger's ``checkpoint_save`` and ``restore``,
   export bytes and seconds, ``load_model`` seconds, ``transform``
   rows/s cold and warm, TFRecord write and read MB/s, and the phase's
   wall;
8. models — the zoo at its published widths, through the port's entry
   points (TF32 off for float32 products; bfloat16 products in
   bfloat16). BERT-base QA (vocab 30522, hidden 768, 12 layers, 12 heads
   of 64, 3072, 512 positions, bfloat16, dropout 0 so training takes the
   flash kernels): one loss on the initial weights with attention
   through the kernels and through their plain versions (same loss
   within ``BERT_STEP_RTOL``); the three flash kernels at this shape
   (B 32, S 384, this run's key mask) timed beside their plain
   versions, SDPA with the same boolean mask (per eager call and device
   time, as in phase 3), the bytes bound and the products' bounds at the
   bfloat16, one-pass TF32 and 3xTF32 rates; the forward over SDPA's
   forward, and dQ + dK/dV over SDPA's backward (per eager call and
   device time) beside each kernel's share of its bound;
   then ``Trainer(adamw(3e-5), qa_span_loss)`` 10 steps on seeded
   SQuAD-shaped rows (lengths 192-384 padded to 384, a planted answer
   marker): losses finite and falling, each flash kernel launched 12
   times a step. The dropout leg: the same weights at dropout 0.1 with
   ``Trainer(dropout_rng=True)`` take the einsum path (no flash
   launch), step 3 twice gives a bitwise equal loss and step 4 another.
   The trained model is exported (``export.save_model``, its
   ``apply_fn`` a ``meta`` skeleton) and served by
   ``ModelServer(export_dir, batch_window_ms=5)``: 8 HTTP clients send
   64 row-format requests of 1-4 rows; every response agrees with the
   model's own eval forward on its rows (``PREDICT_RTOL``), the window
   makes fewer apply calls than requests, each running the flash
   forward 12 times, and a ragged request gets a 400. ResNet-50 trains
   10 SGD steps (0.1, momentum 0.9) at 224 px, batch 64, bfloat16 with
   float32 BatchNorm: losses finite, running statistics moved.
   Inception-v3 infers batch 32 at 299 px twice: finite and bitwise
   equal. Wide & Deep (13 dense, 26 slots of 100 000 buckets, embed 32,
   MLP 256-128-64) trains 10 Adam steps at batch 2048, then its int8
   tables (``quantize_embeddings``) give logits within the reference
   test's 0.05 + 0.05 |float| and correlation > 0.999. U-Net (64 px,
   features 16 and 32, batch 16) and LeNet (28 px, batch 128) take 5
   Adam steps on one batch each: the loss falls. The port's
   ``models.*`` and ``serving`` loaded, nothing of JAX. Printed: BERT's
   step p50, sequences/s and peak memory, the flash rows, ``:predict``
   request p50/p99 and rows/s and the apply calls, ResNet-50 images/s
   (one card) and peak memory, Inception-v3 images/s, Wide & Deep rows/s
   and the phase's wall;
9. examples and streaming — (a) phase 5's 80 records as 5 spool files
   of 16 lines of token ids, each written hidden and renamed, the first
   at once and the rest every 0.25 s once the trainer has pulled its
   first batch: ``StreamingContext(sc).textFileStream(spool)`` feeds
   ``tfc.train(dstream)`` on a one-executor cluster running phase 6's
   trainer, which parses each line back into tokens, and
   ``tfc.shutdown(ssc)`` follows the last file. Exactly 10 steps, losses
   equal to phase 5's within 1e-4 relative, every record consumed once
   in order, no CUDA context in the executor, 12 launches of each
   float32 flash kernel a step. Printed: records/s, the lag from each
   file's landing to its first batch, the step p50 beside phase 5's.
   (b) ``python -m tensorflowonspark_tpu_torch.examples.bert.
   bert_squad_spark --full_size`` through ``cluster.run(InputMode.SPARK)``
   on one executor: BERT-base, bfloat16, dropout 0, S 64 with seeded
   lengths (keys masked), batch 32, 256 examples: 8 steps in its
   ``train_stats.json``, the loss falls, 12 launches of each bfloat16
   flash kernel a step as the trainer counted them. Printed:
   sequences/s and the trainer's start-up. (c)
   ``parallel_runner.run(sc, parallel_job, args, 2)``: two jobs share
   the card, each Inception-v3 (299 px) from the seed on its own seeded
   batch of 32, in processes of their own forked from CUDA-free
   executors; the same two forwards in this process give the same
   logits (``PREDICT_RTOL``) and top-1 wherever the top-2 gap is clear.
   Printed: each job's wall and start-up. The Spark adapter has no leg
   here (no pyspark on the card's machine): the CPU tests hold it;
10. parallelism — (a) ``ring_flash_attention``'s per-rank step code as a
   4-way ring run in lockstep on the card (``_ring_lockstep``: every
   rank's steps in one process, the rotation an index) at GPT-2-small's
   attention width, B 1, global S 8192, 12 heads of 64 (local 2048,
   zigzag half 1024), float32 (TF32 off) and bfloat16, in three
   schedules: contiguous causal, zigzag causal (through ``to_zigzag`` /
   ``from_zigzag``) and non-causal; a seeded dO. ``out``, dq, dk, dv are
   held against the full-sequence ``flash_attention`` (the kernel
   route) and the same lockstep ring with ``impl="plain"``, at the
   phase-3b limits of each dtype (``ring_error``: one call's for
   ``out``, whose merge is a convex combination; the gradients' scaled
   by the partials autograd sums), and each kernel's launches against the schedule's
   live pairs exactly (``ring_live_pairs``: 10, 36 and 16). Printed: each
   schedule's fwd+bwd eager time with its device time (one CUDA graph of
   the whole call, replayed) in brackets, beside one full-sequence call
   and one ``scaled_dot_product_attention`` call with its backward
   (timed here only; the port never calls it). (b) ``python -m
   tensorflowonspark_tpu_torch.examples.longcontext.train_long`` at its
   defaults in both layouts (a one-rank ring), then ``--seq_len 32768
   --layout zigzag --steps 10``: the loss falls and the trainer counts
   exactly 2 (contiguous) or 6 (zigzag) launches of each flash kernel a
   step; printed: step p50, tokens/s, peak memory. Before it runs, the
   kernels are held as in (a) at its width (batch 2, 2 heads of 32,
   float32) through the ring calls it makes: one rank at S 2048 in both
   layouts and at S 32768 zigzag (halves of 16384), and a 4-way
   lockstep ring at S 2048 in both layouts. (c) ``moe_ffn`` at
   hidden 768, ffn 3072, 8 experts, 4096 tokens, float32, on a one-rank
   mesh, against each token through its routed expert alone, output and
   gradients (``MOE_RTOL``); ``pipeline_apply`` of one stage against the
   stage applied microbatch by microbatch. (d) ``criteo_spark
   --cluster_size 1 --tp 1 --quantize_export`` at the config's defaults
   through the cluster: steps in its stats, and one ``:predict`` round
   trip to the int8 export returns one float;
11. generation — phase 4's model from the seed: (a) the paged kernel at
   the speculative verify window (8 slots, S_q 4 from mid-sequence
   cursors, float and int8 pools) held as phase 3's cases are (bitwise
   repeat, NaN-poisoned dead rows) and timed as phase 3's shapes are;
   (b) the first 4 requests through solo ``generate`` (the contiguous
   cache) and a ``kv_block_size=0`` engine; (c) the 16 requests over
   HTTP through ``speculate_k=4`` engines with a 6-layer draft (float
   and int8 KV) and with the whole target as its draft (acceptance >=
   0.95): the counter algebra, and the split and tiled launches exactly
   by the round arithmetic; (d) a ``tier="prefill"`` and a
   ``tier="decode"`` server: 8 requests ``:prefill``-ed and shipped, then
   ``:generate``-d on the decode server, whose prefix hits are the
   shipped blocks; confirmed shipments, ``bytes`` the buffers' frame
   bytes, int8 under a third of float's; (e) ``python -m
   tensorflowonspark_tpu_torch.examples.generate.lm_generate --serve 8``:
   the loss falls and every served output equals solo ``generate``.
   Tokens of (b)-(d) equal phase 4's plain engines' but at a top-2 tie
   below 1e-4. Printed: the verify window's times, tokens/s, TTFT p50,
   acceptance, tokens a slot-round, ``measure_spec``'s draft and verify
   ms, the transport, blocks, MB and ship ms;
12. serving planes — phase 4's model from the seed behind the port's
   ``ModelServer`` (a ``qos_policy``: tenants ``antagonist`` and
   ``quiet`` at equal weight, ``metered`` at 2 tokens/s): (a) 24
   antagonist requests, then 4 quiet ones (phase 4's prompts of at most
   256 tokens, 64 new tokens each) — every quiet request admitted before
   the antagonist's last (from ``/debug/trace``'s queue spans, the
   requests carrying ``X-TFOS-Trace`` ids); 8 ``low`` requests fill the
   slots and a ``high`` one preempts one of them, admitted within two
   step boundaries; the indebted ``metered`` tenant gets 429 +
   ``Retry-After`` with nothing queued; (b) a 2-prompt body whose
   ``deadline_s`` is half its own estimate gets 503 ``Shed`` +
   ``Retry-After``, ``shed`` +2, the queue unmoved, and a feasible one
   completes; (d) two concurrent sends with one ``X-TFOS-Request-Id``
   run one generation, a third replays it; ``fence`` 410, ``unfence``
   200, a control epoch below the fence 409; (c) ``/metrics`` parses
   line by line, holds the reference's families (``REFERENCE_FAMILIES``)
   and counts what the clients were served; ``/debug/trace`` has one
   request span per served request, each request's attribution stages
   sum to its wall within 1%; ``measure_attn(reps=5)`` launches the
   split route exactly 6 times; ``measure_dequant`` on an int8 engine and
   ``kv_cache_bytes``; (e) ``drain`` with 8 in flight (``/healthz``
   draining, a new request 503 ``Draining``, zero loss), then
   ``respawn`` on one counter series; (f) ``kill_scheduler_at_step``:
   503 ``EngineFailed``, ``/healthz`` not alive, a respawn serves;
   ``disconnect_client_at_token``: 499 and the slot freed. Tokens equal
   phase 4's float engine's but at a top-2 tie below 1e-4, and the
   phase's launches by route equal its decode steps and prefills times
   the layers (plus ``measure_attn``'s 6);
13. the serving fleet — phase 4's model from the seed behind the port's
   ``fleet``: (a) ``ServingFleet(replicas=2)`` on the card, phase 4's 16
   requests from 4 HTTP clients through the router's ``:generate``: both
   replicas served (the router's ``/metrics`` labels), the split
   launches exactly 12 x the replicas' decode steps summed and the tiled
   ones 12 x their prefills; (b) ``rolling_drain(upgrade=)`` with the
   same weights while 8 requests are in flight: zero lost, every engine
   replaced; (c) ``kill_scheduler_at_step`` on one replica mid-stream:
   zero client-visible failures, the replica dead in ``/healthz``, the
   failover counted; (d) ``tiers={"prefill": 1, "decode": 1}``: each
   request's blocks shipped and spliced, the decode replica's prefix
   hits the shipped blocks; (e) ``cluster.serving_fleet(...,
   placement="executors")`` on a 2-executor ``Context``: the two
   replicas, each in its own executor process on the card, serve 8 of
   phase 4's requests, and ``stop`` / ``sc.stop()`` leave no process
   and no KV-ship ring; (f)
   ``ServingFleet(journal=)``: ``restart_reservation()`` mid-traffic
   with zero failures and every epoch kept, then a ``RouterStandby``
   takes over from a crashed router and the old router's control epoch
   is refused 409; (g) ``lm_generate --fleet 2 --serve 8 --steps 40``:
   every
   output equals solo ``generate``. Legs (b)-(d) are held to the same
   exact launch counts as (a). Tokens equal phase 4's float engine's
   but at a top-2 tie below 1e-4. Printed: fleet tokens/s and TTFT p50
   beside phase 4's, the router overhead p50, failovers, drain walls,
   ship MB and ms, the beat's host ms, the executor-hosted formation
   seconds and tokens/s;
14. the supervised and autoscaled fleet — phase 4's model from the seed:
   (a) ``cluster.serving_fleet(replicas=2, supervise=True)``, phase 4's
   16 requests from 4 clients with ``kill_scheduler_at_step`` armed on
   replica-1: zero client-visible failures, the router's quiesce of
   replica-1 before the supervisor's ``engine_restarted`` and its
   readmit after, ``engine_restarts`` [0, 1], ``/healthz`` 200 again,
   replica-1 completing requests after the readmit; (b)
   ``rolling_drain()`` with 8 in flight under the supervisor: zero
   lost, ``engine_restarts`` unmoved, then the drained-in successor of
   replica-0 killed once and restarted (the watch followed it); (c)
   ``serving_fleet(replicas=1, autoscale=AutoscalePolicy(min 1, max
   2))``, a burst of 32 requests from 16 clients, then idle: one up
   decision with its breach reason, the new replica serving, then one
   down decision whose retirement drains with zero loss; (d) a
   2-executor ``Context``, one executor-hosted replica, ``supervise=True``
   and the autoscaler, ``kill_serving_executor_at_request=3`` SIGKILLs
   its executor: 8 requests with zero client-visible failures, one
   ``serving_replica_lost`` and no ``engine_restarted``, the replacement
   on the other executor with a new pid and a newer epoch, no process
   and no KV ring left after ``stop`` / ``sc.stop()``. Legs (a)-(c) are
   held to exact launch counts over every engine they ran (a restarted
   or retired engine's steps counted once); tokens equal phase 4's float
   engine's but at a top-2 tie below 1e-4. Printed: each leg's wall,
   death -> quiesce -> readmit seconds, tokens/s, breach -> first
   completion on the new replica, the retirement's drain wall, leg (c)'s
   peak memory, kill -> attribution and kill -> the replacement's first
   answer;
15. supervised training — ``cluster.run(..., supervise=SupervisorConfig)``
   through ``profile_recovery``'s legs: (a) phase 5's model at full depth
   on one executor, phase 5's 80 records as 10 partitions of 8 (one
   partition a step a checkpoint); the trainer runs
   ``supervisor.attach``, trains, confirms the partition's ack, saves
   with ``Checkpointer`` and calls ``sup.step``;
   ``kill_trainer_at_step=5,fuse=`` SIGKILLs it after step 5's
   checkpoint and ``RestartFromCheckpoint`` reforms: the fuse fired, 2
   formations and ``["trainer_crash"]``, 10 partitions acked, each step
   once (the killed step not re-run), losses equal to phase 5's within
   1e-4 relative, the final train state's digest equal to phase 5's,
   each flash kernel launched exactly 12 x 10 times over both attempts,
   every MTTR stage present; (b) the same width at 2 layers on two
   executors, each trainer alone with its own checkpoint chain,
   ``drop_executor_then_return_after=20,only=1,fuse=`` (the return after
   the shrink's teardown, which waits for the survivor's step) with
   ``ElasticResize(min_width=1)`` and ``chaos.schedule_executor_return``:
   formation widths [2, 1, 2], the failures exactly ``["executor_lost"]``
   on executor 1, nothing excluded, steps summed over both chains equal
   to the partitions and the rows' token sum equal to the data's, 2 x
   10 launches of each flash kernel; in both legs every trainer on
   ``cuda:0`` and forked from an executor that had loaded no torch (no
   bad fork), no executor holding a CUDA context after the job, no
   process left; (c) step 7 of (a) under ``tracing.trace``: its Chrome
   trace names ``flash_fwd_kernel``, ``flash_dq_kernel`` and
   ``flash_dkv_kernel``, and the loss goes through
   ``tracing.SummaryWriter`` (a no-op where ``tensorboard`` is missing).
   Printed: the MTTR stages (detect, reform, restore, first step, MTTR),
   the regrow's drain -> formed -> first step, checkpoint save and step
   p50, each trainer's peak memory and the phase's wall;
16. tensor-parallel decode — 4 processes on ``cuda:0`` in one gloo group
   over CUDA tensors (NCCL refuses two ranks on one card; the megatron
   decode needs only all-reduces, which gloo runs on CUDA tensors, and
   a collective gloo lacks for them fails the phase — nothing is routed
   through the CPU): each builds phase 4's GPT-2-small from the seed
   (the ranks' weights checked equal) and decodes 4 prompts of 32
   tokens plus 32 new at temperature 0 through ``generation.generate``
   at tp 1 (the plain model), 2 and 4 (a copy laid out by
   ``distribute_params(..., DECODER_TP_RULES, src_data_rank=None)`` on
   ``{"data": 4 / tp, "model": tp}``): every rank of a width the same
   tokens, tp 2 and 4 tp 1's but at a top-2 tie below 1e-4, each rank's
   query weight ``Shard(0)`` on ``model`` and its cache 12 / tp heads,
   one decode step's collectives (``CollectiveRecorder``) exactly 24
   all-reduces of 294,912 bytes in all (2 x 12 layers x 4 x 768 x 4), no
   kernel launched (the contiguous path is einsums and cuBLAS). Printed:
   max |logit - tp 1| over the teacher-forced sequence, each rank's peak
   memory, each width's wall and tokens/s (ranks sharing one card over
   gloo, not a TP speed);
17. heads 256 wide — (a) each D-256 instantiation against its plain
   version on the card: the split-KV route (8 slots, block 16, 8 heads
   of 256) and the tensor-core tiled route (blocks 16, 32 and 64, a
   256-token tail and a cold 512 prompt), float and int8, held as phase
   3's cases are; the three flash kernels at B 4 x S 1024 x 8 x 256,
   causal, in float32 and bfloat16 (float32: one CTA of 8 warps a row
   or key tile; bfloat16: one CTA of two warpgroups), and at D 192
   through the padding, under phase 3b's limits; each timed beside its
   plain version, its SDPA yardstick and its bound (the bfloat16
   forward's device time also over SDPA's and as a share of the bound);
   the budgets of the D-256 tiled kernel, of the float32 forward, dQ and
   dK/dV and of the bfloat16 forward, dQ and dK/dV (spill-free, within
   227 KB);
   (b) a ``DecoderLM`` of Gemma-2B's attention width and depth on the
   repo's own block (vocab 50257, hidden 2048 = 8 heads x
   256, 18 layers, max_len 1024; random weights from the seed) behind
   ``ModelServer``, the engine at its automatic block (16) and 8 slots,
   phase 4's 16 requests from 4 clients at float and int8 KV: every
   decode step on the split route and every prefill on the tiled one,
   18 a step or prefill, exactly; tokens equal the gather oracle's but
   at a top-2 tie (below 1e-4 at float KV, 1e-3 at int8, where the two
   engines quantize K/V that differ by float noise); tokens/s, TTFT p50
   and decode-step p50 printed; (c) 10 ``Trainer`` steps of that model
   at B 4 x S 1024: the loss falls, exactly 180 launches of each flash
   kernel; step p50, tokens/s and peak memory printed; (d) the model and
   engines freed before the phase ends;
18. heads above 256 — (a) each kernel of ``wide_attention.cu`` against
   its plain version on the card at head dims 257, 300, 384, 512, 576
   and 1024: paged decode (the split kernel and its combine), the verify
   window (2 to 4 queries a row), a 256-token tail and a cold 512 prompt
   (the tiled kernel), float and int8, block 16, and at D 512 blocks 1
   and 64, held as phase 3's cases are; the flash forward, dQ and dK/dV
   in float32 and bfloat16, causal and key-masked, forward and backward,
   and at the training shape, under phase 3b's limits; their budgets
   (spill-free); the split kernel at row 1d's decode shape at 8 x 512,
   the tiled kernel at the 256-token tail and the flash kernels at B 2 x
   S 1024 x 8 x 512, causal, each timed beside its plain version, SDPA
   and its bound; (b) a ``DecoderLM`` of DeepSeek-V4-Flash's hidden size
   and head dim on the repo's own block (vocab 50257, hidden 4096 = 8
   heads x 512, 4 layers, max_len 1024; random weights from the seed)
   behind ``ModelServer``, phase 4's first 4 requests at float and at
   int8 KV: every decode step on the split route and every prefill on
   the tiled one, 4 a step or prefill, exactly; tokens equal the gather
   oracle's but at a top-2 tie (1e-4 float, 1e-3 int8); (c) 3 ``Trainer``
   steps at B 2 x S 1024, ``adamw(1e-4)``: the last loss below the first,
   exactly 4 launches of each flash kernel a step; (d) the model and
   engines freed;
19. the ``{"kernels": [...]}`` line (the flash rows add phase 6's launch
   counts as ``launches_cluster``, phase 7's as ``launches_pipeline``,
   phase 8's (BERT training plus ``:predict``) as ``launches_models``,
   phase 9's streaming-fed trainer's as ``launches_streaming`` and the
   BERT example's as ``launches_examples``, phase 10's ring and
   long-context launches as ``launches_ring``, their times at BERT's
   shape as ``bert_shape``, and the kernel each dtype runs as
   ``design``; the paged row adds phase 11's launches as
   ``launches_spec`` and ``launches_disagg``, phase 12's as
   ``launches_planes``, phase 13's as ``launches_fleet``, phase 14's as
   ``launches_supervised``, and the verify window's times as
   ``verify``; the flash rows add phase 15's as ``launches_recovery``;
   phase 17's rows: the split route and the tensor-core tiled route at
   D 256 with 17(b)'s launches, and the flash kernels at D 256 with
   17(c)'s, their bfloat16 instantiations' times beside them; phase
   18's rows: the wide split and tiled kernels with 18(b)'s launches, the
   wide flash kernels with 18(c)'s), the card line, and last the
   ``{"ok": true, ...}`` line.

``--out-dir DIR`` also writes every number of the run to
``DIR/chip_smoke.json``. Needs one card; exits non-zero, printing no
result, without one or when the port's package is not beside this
script.
"""

import argparse
import gc
import http.client
import json
import os
import sys
import threading
import time

import numpy as np

SEED = 1234
#: |kernel - plain| bound: both compute the same fp32 online softmax
#: over the same live keys; only the summation order (per-lane fmaf
#: dot products, shuffle reductions) and expf differ, on outputs that
#: are convex combinations of unit-scale values
KERNEL_TOL = 1e-5
#: a fused/gather token divergence is accepted only at a tie this tight
TIE_GAP = 1e-4
#: H100 SXM device-memory rate and fp32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
#: the float32-accurate tensor-core rate: dense TF32 (495 TFLOP/s) over
#: the three passes of the 3xTF32 split — the attention rows' yardstick
TF32X3_FLOPS = 495e12 / 3
#: the bfloat16 tensor-core peak (dense) and one TF32 pass
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12

#: flash kernel against plain version, each on the inputs the kernel
#: was given. lse is float32 in every dtype, and float32 outputs are held
#: as max |kernel - plain| <= 1e-4 max(1, max |plain|): the forward
#: computes the same float32 products in another summation order (sums of
#: up to 1024 terms, ~1e-6 relative); the backward's 3xTF32 tensor-core
#: products are float32-accurate (each term to ~2^-21 relative; up to
#: 1.3e-5 of max |plain| measured at case (a)), where a single TF32 pass
#: would miss this limit (tests/test_torch_flash_attention.py emulates
#: both). bfloat16 outputs are held element
#: by element. Each side rounds a float32 result once to bfloat16 (7
#: stored mantissa bits: two roundings of values that differ in order
#: land at most one ulp, 2^-7 relative, apart). dq, dk, dv: |kernel -
#: plain| <= 2^-7 |plain| + 1e-3 max |plain|, the floor for order noise
#: where a sum cancels. out: both sides also round each P entry to
#: bfloat16 before P V, at different scales (the kernel against its
#: running row max, the plain version against the final lse), half an
#: ulp (2^-9 relative) each, so the products differ by at most 2^-8
#: sum_j p_j |v_j|: |kernel - plain| <= 2^-7 (|plain| + sum_j p_j |v_j|),
#: a factor 2 over that. A bfloat16 kernel that dropped one 64-key tile
#: from late rows moves lse by ~0.07 and fails the float32 limit.
FLASH_F32_RTOL = 1e-4
BF16_RTOL, BF16_FLOOR = 2.0 ** -7, 1e-3
#: kernel-attention vs plain-attention step: loss within 1e-4 relative;
#: gradients within 1e-3 of each parameter's largest, as max |kernel -
#: plain| over max |plain|. The attention runs in float32 on both routes
#: and differs in summation order only (~1e-6 relative per layer); 12
#: layers of backward and the 50257-way softmax spread that over every
#: gradient, and a key projection's gradient is a sum over positions
#: whose position-mean part cancels exactly (the key bias's gradient is
#: zero), which raises its relative error where hidden states share a
#: large mean. Checked on the initial weights.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-3

VOCAB, HIDDEN, HEADS, LAYERS, MAX_LEN = 50257, 768, 12, 12, 1024
#: the training path's attention shape (batch, sequence)
TRAIN_BATCH, TRAIN_SEQ = 8, MAX_LEN
TRAIN_STEPS = 10
TRAIN_LR = 3e-4
SLOTS, BLOCK = 8, 16
#: the preemption leg's pool: one slot's worth of blocks, where the 8
#: requests it serves need 164 blocks at their full lengths
PREEMPT_BLOCKS = MAX_LEN // BLOCK


def fail(msg):
    print("FAIL: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        fail(msg)


class PrefillQueries(object):
    """Every paged prefill that launches the kernels (``attn_impl``
    "fused"), recorded at ``generation.paged_prefill_into_slot`` once it
    returns — engines call it through the module — as (query count: the
    tail's bucket, layers, head dim): what the prefills since the last
    :meth:`reset` owe each paged route (:func:`want_routes`)."""

    def __init__(self):
        self._calls = []
        self._lock = threading.Lock()
        self._real = None

    def install(self, generation):
        real = self._real = generation.paged_prefill_into_slot

        def record(model, cache, table_row, tokens, *args, **kw):
            out = real(model, cache, table_row, tokens, *args, **kw)
            if kw.get("attn_impl", "fused") == "fused":
                with self._lock:
                    self._calls.append((len(tokens), model.num_layers,
                                        model.head_dim))
            return out

        generation.paged_prefill_into_slot = record

    def reset(self):
        with self._lock:
            del self._calls[:]

    def calls(self):
        with self._lock:
            return list(self._calls)


PREFILLS = PrefillQueries()


def want_routes(pa, split, prefills, window=0, calls=None):
    """The launches by route a leg owes since the counts were zeroed:
    ``split`` decode calls, ``window`` verify-window calls, and one call
    a layer for each recorded prefill (``calls``, default all since the
    last reset) — on the window route at 2 to ``WINDOW_MAX_QUERIES``
    queries and a split head dim or one above 256, else the tiled one.
    Checks that the
    recorder saw the ``prefills`` prefills the engines counted."""
    calls = PREFILLS.calls() if calls is None else calls
    check(len(calls) == prefills, "recorded {} paged prefills where the "
          "engines counted {}".format(len(calls), prefills))
    owed = {"split": split, "window": window, "tiled": 0}
    for s_q, layers, d in calls:
        short = 2 <= s_q <= pa.WINDOW_MAX_QUERIES \
            and (d in pa.SPLIT_HEAD_DIMS or d > 256)
        owed["window" if short else "tiled"] += layers
    return owed


def zero_launches(pa):
    """Set every route's launch count to 0 and forget the recorded
    prefills: just before a leg whose launches are checked."""
    for route in pa.route_launches:
        pa.route_launches[route] = 0
    PREFILLS.reset()


# -- phase 3: kernel against plain version ------------------------------


def make_case(torch, rng, b, s_q, mb, quant, dev, depths=None,
              overshoot_row=None, scratch_row=None, n=HEADS,
              d=HIDDEN // HEADS, bs=BLOCK, on_device=False):
    """Pools, tables and positions (the serving widths unless ``n``/``d``/
    ``bs`` say otherwise): each row owns distinct pool rows for its live
    blocks (scratch 0 elsewhere). ``on_device``: q and the pools are drawn
    on ``dev`` by a torch generator seeded from ``rng`` (phase 18's pools
    of 8 x 512 heads take seconds each to draw on the host)."""
    pool = b * mb + 1
    if on_device:
        gen = torch.Generator(device=dev).manual_seed(
            int(rng.randint(2 ** 31)))
        q, kp, vp = (torch.randn(shape, generator=gen, device=dev)
                     for shape in ((b, s_q, n, d), (pool, bs, n, d),
                                   (pool, bs, n, d)))
    else:
        q = torch.from_numpy(rng.randn(b, s_q, n, d).astype("float32"))
        kp = torch.from_numpy(rng.randn(pool, bs, n, d).astype("float32"))
        vp = torch.from_numpy(rng.randn(pool, bs, n, d).astype("float32"))
    perm = rng.permutation(pool - 1) + 1
    table = perm[:b * mb].reshape(b, mb).astype("int32")
    if depths is None:
        depths = rng.randint(s_q, mb * bs + 1, size=b)
    pos = (depths[:, None] - s_q + np.arange(s_q)[None, :]).astype("int32")
    if overshoot_row is not None:
        pos[overshoot_row] = mb * bs - s_q // 2 + np.arange(s_q)
    if scratch_row is not None:
        # an inactive engine slot: table all scratch, cursor at 0
        table[scratch_row] = 0
        pos[scratch_row] = np.arange(s_q)
    for r in range(b):
        live = min((int(pos[r].max()) + bs) // bs, mb)
        if r != scratch_row:
            table[r, live:] = 0
    args = [q, kp, vp, torch.from_numpy(table), torch.from_numpy(pos)]
    scales = [None, None]
    if quant:
        from tensorflowonspark_tpu_torch.ops import paged_attention as pa
        args[1], ks = pa.quantize_kv(kp)
        args[2], vs = pa.quantize_kv(vp)
        scales = [ks, vs]
    args = [a.to(dev).contiguous() for a in args]
    scales = [s if s is None else s.to(dev).contiguous() for s in scales]
    return args, scales


def live_rows(table, pos, bs):
    """Pool rows some row of the batch may read."""
    live = set()
    for r in range(table.shape[0]):
        nblk = min((int(pos[r].max()) + bs) // bs, table.shape[1])
        live |= set(int(x) for x in table[r, :nblk])
    return live


#: (queries per row, heads, head dim, table width) of the kernel cases:
#: the split route at decode, a 16-query window (the window route, or
#: the tiled one above ``WINDOW_MAX_QUERIES``), the tensor-core tiled
#: route at a 128-query window of the serving widths and at a head dim
#: above 128 (192, zero-padded to the 256 instantiation)
PAGED_CASES = [(1, HEADS, HIDDEN // HEADS, MAX_LEN // BLOCK),
               (16, HEADS, HIDDEN // HEADS, MAX_LEN // BLOCK),
               (128, HEADS, HIDDEN // HEADS, MAX_LEN // BLOCK),
               (16, 4, 192, 8)]


def hold_case(torch, pa, dev, args, scales, s_q, d, quant, bs=BLOCK,
              plain="blockwise"):
    """One case of the kernel against its plain version (``_blockwise``,
    or ``plain``): the route the shape maps to (split-KV at S_q = 1 and
    the window kernel at 2 to ``WINDOW_MAX_QUERIES`` queries, at the head
    dims they are built for and at every head dim above 256; the
    tensor-core query-tiled route for every other call), finite and
    within
    ``KERNEL_TOL``, a second call bitwise equal to the first, and
    NaN-poisoned dead pool rows leaving the output bitwise unchanged.
    Returns (route, |difference|)."""
    ks, vs = scales
    scale = d ** -0.5
    before = dict(pa.route_launches)
    got = pa.paged_attention(*args, scale=scale, impl="kernel",
                             k_scale=ks, v_scale=vs)
    route = pa._route(s_q, d)
    dims = (16, 32, 64, 128, 256)
    split = d in dims or d > 256
    check(route == ("split" if s_q == 1 and split else "window"
                    if 2 <= s_q <= pa.WINDOW_MAX_QUERIES and split
                    else "tiled"),
          "s_q={} D={} maps to the {} route".format(s_q, d, route))
    check(pa.route_launches == {r: before[r] + (r == route) for r in before},
          "s_q={} did not take the {} route alone".format(s_q, route))
    want = pa.paged_attention(*args, scale=scale, impl=plain,
                              k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()),
          "kernel output not finite (s_q={}, int8={})".format(s_q, quant))
    err = (got - want).abs().max().item()
    again = pa.paged_attention(*args, scale=scale, impl="kernel",
                               k_scale=ks, v_scale=vs)
    check(torch.equal(again, got), "two kernel calls on the same "
          "inputs differ (s_q={}, int8={})".format(s_q, quant))
    log("kernel vs plain  int8={!s:<5} s_q={:<3} D={:<3} block={:<2} "
        "route={:<10} max_abs_err={:.3e} (tol {:.0e}; {})".format(
            quant, s_q, d, bs, route, err, KERNEL_TOL, plain))
    check(err <= KERNEL_TOL, "kernel disagrees with plain version")
    # never reads a dead pool row: poison them, output unchanged
    table = args[3].cpu().numpy()
    live = live_rows(table, args[4].cpu().numpy(), bs)
    dead = torch.tensor(sorted(set(range(args[1].shape[0])) - live),
                        device=dev, dtype=torch.long)
    check(dead.numel() > 0, "case leaves no dead rows")
    pk, pv = args[1].clone(), args[2].clone()
    if quant:
        # int8 codes cannot hold NaN: poison the scales instead
        ks2, vs2 = ks.clone(), vs.clone()
        ks2[dead] = float("nan")
        vs2[dead] = float("nan")
    else:
        ks2, vs2 = ks, vs
        pk[dead] = float("nan")
        pv[dead] = float("nan")
    poisoned = pa.paged_attention(args[0], pk, pv, args[3], args[4],
                                  scale=scale, impl="kernel",
                                  k_scale=ks2, v_scale=vs2)
    torch.cuda.synchronize()
    check(torch.equal(poisoned, got),
          "kernel output changed under NaN-poisoned dead rows "
          "(s_q={}, int8={})".format(s_q, quant))
    return route, err


def kernel_cases(torch, pa, dev):
    """Hold the kernels against ``_blockwise`` on every case, on every
    route (``hold_case``), and the window kernel at 2, 3, 4 and
    ``WINDOW_MAX_QUERIES`` queries a row at the serving widths; returns
    the largest |difference| per route."""
    rng = np.random.RandomState(SEED)
    worst = {route: 0.0 for route in pa.route_launches}
    seen = set()
    window = [(s_q, HEADS, HIDDEN // HEADS, MAX_LEN // BLOCK)
              for s_q in sorted({2, 3, 4, pa.WINDOW_MAX_QUERIES})]
    for quant in (False, True):
        for s_q, n, d, mb in PAGED_CASES + window:
            args, scales = make_case(
                torch, rng, SLOTS, s_q, mb, quant, dev, overshoot_row=1,
                scratch_row=SLOTS - 1, n=n, d=d)
            route, err = hold_case(torch, pa, dev, args, scales, s_q, d,
                                   quant)
            worst[route] = max(worst[route], err)
            seen.add(route)
    check(seen == set(worst), "phase 3 held only the routes {}".format(
        sorted(seen)))
    return worst


#: the H100's L2 (50 MB); and how many times over a timing's pool
#: copies must exceed it when the smoke picks their number from the
#: live bytes (:func:`l2_copies`)
L2_BYTES = 50 * 2 ** 20
L2_OVER = 4


def live_kv_bytes(depths, n, d, quant, keys):
    """The K/V bytes one paged call reads: a row ending at depth ``t``
    reads min(t, ``keys``) keys and values of ``n`` heads of ``d``,
    float32 or int8 codes with a float32 scale a (key, head)."""
    live = int(np.minimum(np.asarray(depths), keys).sum())
    return 2 * live * n * (d * (1 if quant else 4) + (4 if quant else 0))


def l2_copies(kv_bytes):
    """Pool copies whose live K/V together exceed the L2 ``L2_OVER``
    times, and at least ``L2_OVER`` of them."""
    return max(L2_OVER, -(-L2_OVER * L2_BYTES // kv_bytes))


def time_ms(torch, fn, sets, reps=20):
    """Mean milliseconds per call, cycling over ``sets`` argument sets.
    A layer's pool is cold when the serving step reaches it, so sets whose
    live K/V together stay inside the 50 MB L2 flatter a kernel:
    :func:`l2_copies` says how many copies keep them out of it. Calls are
    issued from the host one by one, so a call whose host work outlasts
    its kernels measures the host."""
    for a in sets:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for a in sets:
            fn(*a)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(sets))


def paged_timing(torch, pa, dev, quant, s_q, depths, copies, n=HEADS,
                 d=HIDDEN // HEADS, bs=BLOCK, on_device=False):
    """Times of one paged-attention call over ``len(depths)`` rows of
    ``s_q`` queries ending at ``depths`` (``n`` heads of ``d``, block
    ``bs``, a table of 1024 tokens), cycling over ``copies`` pools (None:
    as many as :func:`l2_copies` asks of the call's live bytes): the
    kernel's time per eager call (``ms``) and its device time through
    CUDA-graph replays (``device_ms``), the plain version's, an SDPA
    yardstick timed both ways, and the bound."""
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.profile_paged import graph_ms, sdpa_sets

    rng = np.random.RandomState(SEED + 1 + s_q)
    b = len(depths)
    mb = MAX_LEN // bs
    if copies is None:
        copies = l2_copies(live_kv_bytes(depths, n, d, quant, mb * bs))
    sets = []
    for _ in range(copies):
        args, (ks, vs) = make_case(torch, rng, b, s_q, mb, quant, dev,
                                   depths=depths, n=n, d=d, bs=bs,
                                   on_device=on_device)
        sets.append(args + [ks, vs])
    scale = d ** -0.5

    def kernel(q, kp, vp, t, p, ks, vs):
        return pa.paged_attention(q, kp, vp, t, p, scale=scale,
                                  impl="kernel", k_scale=ks, v_scale=vs)

    def plain(q, kp, vp, t, p, ks, vs):
        return pa.paged_attention(q, kp, vp, t, p, scale=scale,
                                  impl="blockwise", k_scale=ks, v_scale=vs)

    # the library yardstick: one SDPA call over the contiguous view,
    # gathered (and dequantized) beforehand, outside the timed call
    lib_sets = sdpa_sets(torch, pa, sets)

    def library(q, k, v, mask):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              scale=scale)

    before = dict(pa.route_launches)
    kernel(*sets[0])
    route = [r for r in before if pa.route_launches[r] != before[r]][0]
    ms = time_ms(torch, kernel, sets)
    device_ms = graph_ms(torch, kernel, sets)
    plain_ms = time_ms(torch, plain, sets, reps=2)
    library_ms = time_ms(torch, library, lib_sets)
    library_device_ms = graph_ms(torch, library, lib_sets)
    # the bound: each input read once (the live K/V and scales, q, the
    # table, pos), the output written once; the products' flops on the
    # visible (query, key) pairs at the float32-accurate tensor-core rate
    # (bound_ms), and at the CUDA-core float32 rate (bound_simt_ms)
    pos = sets[0][4].cpu().numpy()
    live_tokens = int(sum(min(int(r.max()) + 1, mb * bs) for r in pos))
    pairs = int((np.minimum(pos, mb * bs - 1) + 1).sum())
    kv_bytes = live_kv_bytes(pos.max(1) + 1, n, d, quant, mb * bs)
    io_bytes = 2 * b * s_q * n * d * 4 + b * (mb + s_q) * 4
    flops = 4.0 * pairs * n * d
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / TF32X3_FLOPS * 1e3
    return {"route": route, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_simt_ms": max(t_bytes, flops / FP32_FLOPS * 1e3),
            "live_tokens": live_tokens, "kv_bytes": kv_bytes,
            "flops": flops, "copies": copies}


def kernel_timing(torch, pa, dev, quant):
    """Times at the serving decode shape: 8 slots, S_q = 1, rows at
    depths 32..640 (what the traffic's prompts plus generated tokens
    reach), over 6 pool copies so the live K/V does not sit in L2."""
    depths = np.random.RandomState(SEED + 1).randint(32, 641, size=SLOTS)
    return paged_timing(torch, pa, dev, quant, 1, depths, 6)


def prefill_timing(torch, pa, dev, quant):
    """Times at a prefill shape: one row, a 256-token tail at positions
    256..511 (a prompt whose first 256 tokens hit the prefix cache)."""
    return paged_timing(torch, pa, dev, quant, 256, np.array([512]), 6)


def cold_prefill_timing(torch, pa, dev, quant):
    """Times at the traffic's commonest prefill: one row, a cold
    512-token prompt at positions 0..511."""
    return paged_timing(torch, pa, dev, quant, 512, np.array([512]), 6)


# -- phase 3b: flash kernels against plain versions ---------------------


def flash_inputs(torch, rng, b, s_q, s_k, dtype, dev, masked_row=None,
                 n=HEADS, d=HIDDEN // HEADS):
    """q, k, v, dO, lse cotangent and key mask at ``n`` heads of ``d``
    (12 of 64 unless asked otherwise)."""

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype("float32")).to(
            dev, dtype)

    q, k, v, dout = t(b, s_q, n, d), t(b, s_k, n, d), t(b, s_k, n, d), \
        t(b, s_q, n, d)
    g_lse = torch.from_numpy(rng.randn(b, n, s_q).astype("float32")).to(dev)
    mask = None
    if masked_row is not None:
        mask = torch.from_numpy(rng.rand(b, s_k) > 0.25)
        mask[:, 0] = True
        mask[masked_row] = False
        mask = mask.to(dev)
    return q, k, v, dout, g_lse, mask


def flash_run(torch, fa, inputs, causal, block):
    """Forward and backward through the public autograd path; returns
    out, lse, dq, dk, dv."""
    q, k, v, dout, g_lse, mask = inputs
    q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out, lse = fa.flash_attention_lse(q, k, v, causal=causal, key_mask=mask,
                                      block_q=block, block_k=block)
    torch.autograd.backward([out, lse], [dout, g_lse])
    return out.detach(), lse.detach(), q.grad, k.grad, v.grad


def flash_plain(fa, inputs, causal, out, lse):
    """Each kernel's plain version on the inputs that kernel was given:
    the forward on q, k, v; dQ and dK/dV also on the kernel's lse and
    the delta the backward formed from the kernel's out. Returns out,
    lse, dq, dk, dv and ``sum_j p_j |v_j|`` (the forward on |v|)."""
    q, k, v, dout, g_lse, mask = inputs
    b, s_q, n, d = q.shape
    scale = d ** -0.5
    bias = fa._mask_to_bias(mask)
    want_out, want_lse = fa._reference_lse(q, k, v, causal, scale, bias)
    lse = lse.reshape(b * n, s_q)
    delta = fa._delta(out, dout, g_lse)
    dq = fa._dq_plain(q, k, v, bias, dout, lse, delta, causal, scale)
    dk, dv = fa._dkv_plain(q, k, v, bias, dout, lse, delta, causal, scale)
    pv, _ = fa._reference_lse(q, k, v.abs(), causal, scale, bias)
    return (want_out, want_lse, dq, dk, dv), pv


FLASH_CASES = [
    # (label, b, s_q, s_k, causal, dtype, masked batch row, block)
    ("a: B8 S1024 causal fp32", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, True,
     "float32", None, 128),
    ("b: S_q128 S_k384 key mask", 2, 128, 384, False, "float32", 1, 128),
    ("c: B8 S1024 causal bf16", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, True,
     "bfloat16", None, 128),
    ("d: S48 block16 causal", 2, 48, 48, True, "float32", None, 16),
    ("e: BERT B32 S384 bf16 key mask", 32, 384, 384, False, "bfloat16", 3,
     128),
    # Phase 9(b)'s shape: each row is one partly masked 64-key tile.
    ("f: BERT example B32 S64 bf16 key mask", 32, 64, 64, False, "bfloat16",
     3, 128),
]


def library_text(ft):
    """``library_ms`` of a flash row, with its device time, for a log
    line."""
    if ft["library_ms"] is None:
        return "-"
    return "{:.4f} ms ({:.4f} ms device time)".format(
        ft["library_ms"], ft["library_device_ms"])


def flash_error(torch, name, got, want, dtype, pv):
    """``(max |got - want|, largest |got - want| over its limit)`` over
    the entries where ``want`` is finite (see FLASH_F32_RTOL); ``pv`` is
    ``sum_j p_j |v_j|`` per output entry."""
    fin = torch.isfinite(want)
    g, w = got.float()[fin], want.float()[fin]
    diff = (g - w).abs()
    top = w.abs().max().item()
    if dtype != "bfloat16" or name == "lse":
        limit = torch.full_like(w, FLASH_F32_RTOL * max(1.0, top))
    elif name == "out":
        limit = BF16_RTOL * (w.abs() + pv.float()[fin])
    else:
        limit = BF16_RTOL * w.abs() + BF16_FLOOR * top
    over = torch.where(diff > 0, diff / limit, torch.zeros_like(diff))
    return diff.max().item(), over.max().item()


def flash_cases(torch, fa, dev, cases=FLASH_CASES, n=HEADS,
                d=HIDDEN // HEADS, seed=SEED + 4):
    """Hold the three kernels against the plain versions on every case
    (at ``n`` heads of ``d``); returns the largest |kernel - plain| per
    case letter and kernel."""
    rng = np.random.RandomState(seed)
    worst = {}
    for label, b, s_q, s_k, causal, dtype, masked, block in cases:
        inputs = flash_inputs(torch, rng, b, s_q, s_k,
                              getattr(torch, dtype), dev, masked, n=n, d=d)
        before = dict(fa.launches)
        got = flash_run(torch, fa, inputs, causal, block)
        torch.cuda.synchronize()
        check(fa.launches == {k: before[k] + 1 for k in before},
              "case {}: the kernels were not each launched once".format(
                  label))
        want, pv = flash_plain(fa, inputs, causal, got[0], got[1])
        torch.cuda.synchronize()
        check(fa.launches == {k: before[k] + 1 for k in before},
              "the plain versions launched a kernel")
        errs = {}
        for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
            check(torch.equal(torch.isneginf(g), torch.isneginf(w)),
                  "case {}: {} -inf pattern differs".format(label, name))
            fin = torch.isfinite(w)
            check(bool(torch.isfinite(g[fin]).all()),
                  "case {}: {} not finite".format(label, name))
            errs[name] = flash_error(torch, name, g, w, dtype, pv)
        if masked is not None:
            out, lse, dq = got[0], got[1], got[2]
            check(bool(torch.isneginf(lse[masked]).all())
                  and bool((out[masked] == 0).all())
                  and bool((dq[masked] == 0).all()),
                  "case {}: the fully masked row is not lse -inf, out 0, "
                  "dq 0".format(label))
        over = max(v[1] for v in errs.values())
        log("flash vs plain  {:<28} ".format(label) + "  ".join(
            "{} {:.2e}".format(k, v[0]) for k, v in errs.items())
            + "  (error/limit " + " ".join(
                "{:.2g}".format(v[1]) for v in errs.values()) + ")")
        check(over <= 1.0, "case {}: flash kernel disagrees with plain "
              "version".format(label))
        worst[label[0]] = {"fwd": max(errs["out"][0], errs["lse"][0]),
                           "dq": errs["dq"][0],
                           "dkv": max(errs["dk"][0], errs["dv"][0])}
    return worst


def flash_timing(torch, fa, dev, b=TRAIN_BATCH, s=TRAIN_SEQ,
                 dtype="float32", mask=None, n=HEADS, d=HIDDEN // HEADS):
    """Each kernel's time beside its plain version, the SDPA yardstick
    and the bounds: at the training shape (a) by default (causal,
    float32), or at ``b`` x ``s`` in ``dtype`` under the key ``mask``
    (not causal; SDPA takes the same boolean mask). Kernel and SDPA
    times per eager call (``ms``, ``library_ms``: the host's work
    included, as a caller sees it) and device times through CUDA-graph
    replays (``device_ms``, ``library_device_ms``: no host work between
    the kernels)."""
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.profile_flash import backward_graph_ms
    from tensorflowonspark_tpu_torch.profile_paged import graph_ms

    rng = np.random.RandomState(SEED + 5)
    causal = mask is None
    q, k, v, dout, g_lse, _ = flash_inputs(torch, rng, b, s, s,
                                           getattr(torch, dtype), dev, n=n,
                                           d=d)
    if not causal:
        g_lse = None
    bias = fa._mask_to_bias(mask)
    scale = d ** -0.5
    out, lse = fa._kernel_fwd(q, k, v, bias, causal, scale)
    delta = fa._delta(out, dout, g_lse)
    fns = {
        "fwd": (lambda: fa._kernel_fwd(q, k, v, bias, causal, scale),
                lambda: fa._reference_lse(q, k, v, causal, scale, bias)),
        "dq": (lambda: fa._kernel_dq(q, k, v, bias, dout, lse, delta, causal,
                                     scale),
               lambda: fa._dq_plain(q, k, v, bias, dout, lse, delta, causal,
                                    scale)),
        "dkv": (lambda: fa._kernel_dkv(q, k, v, bias, dout, lse, delta,
                                       causal, scale),
                lambda: fa._dkv_plain(q, k, v, bias, dout, lse, delta,
                                      causal, scale)),
    }
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    sdpa = dict(is_causal=True) if causal else dict(
        attn_mask=mask[:, None, None, :])
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, **sdpa)
    dout_t = dout.transpose(1, 2).contiguous()
    library = {
        "fwd": lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa),
        "dq": lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dout_t,
                                          retain_graph=True),
    }
    library_device = {
        "fwd": lambda: graph_ms(torch, library["fwd"], [()]),
        "dq": lambda: backward_graph_ms(
            torch, lambda *x: F.scaled_dot_product_attention(*x, **sdpa),
            (qt, kt, vt), dout_t),
    }
    # what each kernel must do on these inputs: every (query, key) pair
    # it attends (causal: key <= query; masked: every query against this
    # run's live keys, since a padded query still gets an output and a
    # padded key needs no product), 2 flops per multiply-add of each
    # product it computes (forward: Q K^T, P V; dQ: Q K^T, dO V^T, dS K;
    # dK/dV: K Q^T, V dO^T, P^T dO, dS^T Q); each input read once, each
    # output written once (q, k, v, dO and outputs in the input dtype;
    # lse, delta and the bias row float32), where k and v are read at the
    # live keys only, as the pairs count them (every output is written in
    # full: a padded key's dK and dV are 0). The operations are timed at
    # the input dtype's tensor-core rate for bound_ms (float32: the
    # float32-accurate 3xTF32 rate), and beside it at every other rate
    live = b * s if causal else int(mask.sum().item())
    if causal:
        pairs = b * n * s * (s + 1) // 2
    else:
        pairs = n * s * live
    tensor = b * s * n * d * q.element_size()
    kv = live * n * d * q.element_size()   # k or v at the live keys
    row = b * n * s * 4
    bias_bytes = 0 if bias is None else b * s * 4
    work = {"fwd": (4 * pairs * d, 2 * tensor + 2 * kv + row + bias_bytes),
            "dq": (6 * pairs * d, 3 * tensor + 2 * kv + 2 * row + bias_bytes),
            "dkv": (8 * pairs * d,
                    4 * tensor + 2 * kv + 2 * row + bias_bytes)}
    rate = BF16_FLOPS if dtype == "bfloat16" else TF32X3_FLOPS
    res = {}
    for name, (kern, plain) in fns.items():
        flops, nbytes = work[name]
        t_ops = flops / rate * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        res[name] = {
            "ms": time_ms(torch, kern, [()], reps=20),
            "device_ms": graph_ms(torch, kern, [()]),
            "plain_ms": time_ms(torch, plain, [()], reps=5 if causal else 3),
            "library_ms": (time_ms(torch, library[name], [()], reps=20)
                           if name in library else None),
            "library_device_ms": (library_device[name]()
                                  if name in library else None),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_simt_ms": max(flops / FP32_FLOPS * 1e3, t_bytes),
            "bytes_ms": t_bytes,
            "ops_bf16_ms": flops / BF16_FLOPS * 1e3,
            "ops_tf32_ms": flops / TF32_FLOPS * 1e3,
            "ops_3xtf32_ms": flops / TF32X3_FLOPS * 1e3,
            "flops": flops, "bytes": nbytes}
    return res


def kernel_budget(torch, fa, pa):
    """Registers, spills, shared memory and CTAs per SM of the flash
    kernels and of the tensor-core tiled paged kernel at the models'
    head dim, of the window kernel at the models' head dims (each
    instantiation, no spills), and of every D-256 instantiation (flash
    in both dtypes, the split-KV kernel, the tensor-core tiled kernel),
    as the card reports them. The D-256 tiled kernel, the float32 forward, dQ and
    dK/dV at D 256 and the bfloat16 dQ and dK/dV at D 256 (two
    warpgroups a CTA) must be spill-free within the card's 227 KB of
    shared memory (the tiled kernel's as ``tiled_smem_bytes`` reckons
    it)."""
    out = {}
    for quant in (False, True):
        kv = "int8" if quant else "float32"
        for route in ("split", "tiled"):
            got = pa.budget(256, quant, route=route)
            key = "paged_{} D256 {}".format(route, kv)
            out[key] = got
            log("budget {:<25}: {} registers, {} spill bytes, {} bytes "
                "shared, {} CTAs/SM".format(
                    key, got["registers"], got["spill_bytes"],
                    got["smem_bytes"], got["ctas_per_sm"]))
        got = out["paged_tiled D256 {}".format(kv)]
        check(got["spill_bytes"] == 0 and got["ctas_per_sm"] >= 1
              and got["smem_bytes"] == pa.tiled_smem_bytes(256, quant)
              <= pa.MAX_SMEM_BYTES,
              "the D-256 tiled kernel ({}) spills or does not fit: {}"
              .format(kv, got))
    for kind in ("fwd", "dq", "dkv"):
        for dtype in ("float32", "bfloat16"):
            got = fa.budget(kind, 256, getattr(torch, dtype))
            out["{} D256 {}".format(kind, dtype)] = got
            log("budget {:<3} D256 {:<8}: {} registers, {} spill bytes, {} "
                "KB shared, {} CTAs/SM".format(
                    kind, dtype, got["registers"], got["spill_bytes"],
                    got["smem_bytes"] // 1024, got["ctas_per_sm"]))
    for key in ("fwd D256 float32", "dq D256 float32", "dkv D256 float32",
                "dq D256 bfloat16", "dkv D256 bfloat16"):
        got = out[key]
        check(got["spill_bytes"] == 0 and got["ctas_per_sm"] >= 1
              and got["smem_bytes"] <= pa.MAX_SMEM_BYTES,
              "{} spills or does not fit: {}".format(key, got))
    # the window kernel at every instantiation the serving widths and the
    # D-256 decoder launch (2, 4, 8, 16 queries up to WINDOW_MAX_QUERIES)
    for quant in (False, True):
        kv = "int8" if quant else "float32"
        for d in (HIDDEN // HEADS, 256):
            for qn in (2, 4, 8, 16):
                if qn > pa.WINDOW_MAX_QUERIES:
                    continue
                got = pa.budget(d, quant, route="window", queries=qn)
                key = "paged_window D{} Q{} {}".format(d, qn, kv)
                out[key] = got
                log("budget {:<28}: {} registers, {} spill bytes, {} bytes "
                    "shared, {} CTAs/SM".format(
                        key, got["registers"], got["spill_bytes"],
                        got["smem_bytes"], got["ctas_per_sm"]))
                check(got["spill_bytes"] == 0 and got["ctas_per_sm"] >= 1
                      and got["smem_bytes"] <= pa.MAX_SMEM_BYTES,
                      "{} spills or does not fit: {}".format(key, got))
    for quant in (False, True):
        got = pa.budget(HIDDEN // HEADS, quant)
        out["paged_tiled {}".format("int8" if quant else "float32")] = got
        log("budget paged_tiled D{} {:<7}: {} registers, {} spill bytes, {} "
            "KB shared, {} CTAs/SM".format(
                HIDDEN // HEADS, "int8" if quant else "float32",
                got["registers"], got["spill_bytes"],
                got["smem_bytes"] // 1024, got["ctas_per_sm"]))
    for kind in ("fwd", "dq", "dkv"):
        for dtype in ("float32", "bfloat16"):
            got = fa.budget(kind, HIDDEN // HEADS, getattr(torch, dtype))
            out["{} {}".format(kind, dtype)] = got
            log("budget {:<3} D{} {:<8}: {} registers, {} spill bytes, {} "
                "KB shared, {} CTAs/SM".format(
                    kind, HIDDEN // HEADS, dtype, got["registers"],
                    got["spill_bytes"], got["smem_bytes"] // 1024,
                    got["ctas_per_sm"]))
    return out


# -- phase 4: serving at full width -------------------------------------


def traffic():
    """16 requests: prompts 32-512 tokens (4 of them sharing one
    256-token prefix), 32-128 new tokens each."""
    rng = np.random.RandomState(SEED + 2)
    shared = rng.randint(0, VOCAB, size=256).tolist()
    reqs = []
    for i in range(16):
        n_new = int(rng.randint(32, 129))
        if i % 4 == 1:  # requests 1, 5, 9, 13 share the prefix
            prompt = shared + rng.randint(
                0, VOCAB, size=int(rng.randint(1, 257))).tolist()
        else:
            prompt = rng.randint(0, VOCAB,
                                 size=int(rng.randint(32, 513))).tolist()
        reqs.append((prompt, n_new))
    return reqs


def serve_over_http(serving, engine, reqs, clients=4):
    """Send ``reqs`` through a ModelServer from ``clients`` concurrent
    HTTP clients; returns (outputs, wall seconds)."""
    out = [None] * len(reqs)
    errors = []
    with serving.ModelServer(None, name="gpt2", port=0,
                             engine=engine) as srv:
        port = srv.address[1]

        def client(c):
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=600)
                for i in range(c, len(reqs), clients):
                    prompt, n_new = reqs[i]
                    conn.request("POST", "/v1/models/gpt2:generate",
                                 body=json.dumps({"prompt": prompt,
                                                  "max_new_tokens": n_new}),
                                 headers={"Content-Type":
                                          "application/json"})
                    resp = conn.getresponse()
                    body = json.loads(resp.read())
                    if resp.status != 200:
                        raise RuntimeError("HTTP {}: {}".format(
                            resp.status, body))
                    out[i] = body["tokens"]
                conn.close()
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))

        t0 = time.monotonic()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = conn.getresponse()
        health.read()
    check(not errors, "HTTP clients failed: {}".format(errors))
    check(health.status == 200, "/healthz answered {}".format(health.status))
    return out, wall


def top2_gap(torch, generation, model, tokens, kv_dtype, dev):
    """Top-2 logit gap after ``tokens`` (gather oracle, fresh cache)."""
    mb = MAX_LEN // BLOCK
    cache = generation.init_paged_cache(model, 1, MAX_LEN, kv_blocks=mb,
                                        block_size=BLOCK, kv_dtype=kv_dtype,
                                        device=dev)
    table = torch.arange(1, mb + 1, dtype=torch.int32, device=dev)[None]
    with torch.no_grad():
        logits = model(torch.tensor([tokens], dtype=torch.int32, device=dev),
                       cache, torch.zeros(1, dtype=torch.int32, device=dev),
                       table, attn_impl="gather")
    top = torch.topk(logits[0, -1], 2).values
    return (top[0] - top[1]).item()


def compare_tokens(torch, generation, model, fused, gather, reqs, kv_dtype,
                   dev, tie=TIE_GAP):
    """Fused tokens must equal gather tokens, except after a tie (a top-2
    gap below ``tie``)."""
    ties = 0
    for i, ((prompt, n_new), f, g) in enumerate(zip(reqs, fused, gather)):
        check(len(f) == len(prompt) + n_new and f[:len(prompt)] == prompt,
              "request {}: malformed output".format(i))
        check(all(0 <= t < VOCAB for t in f), "token outside vocab")
        if f == g:
            continue
        first = next(j for j in range(len(f)) if f[j] != g[j])
        gap = top2_gap(torch, generation, model, f[:first], kv_dtype, dev)
        log("  request {} diverges at position {}: top-2 gap {:.3e}".format(
            i, first, gap))
        check(gap < tie, "fused and gather tokens differ at a non-tie")
        ties += 1
    return ties


def serving_phase(torch, dev):
    from tensorflowonspark_tpu_torch import generation, serving
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM
    from tensorflowonspark_tpu_torch.ops import paged_attention as pa

    model = DecoderLM(VOCAB, hidden=HIDDEN, num_heads=HEADS,
                      num_layers=LAYERS, max_len=MAX_LEN, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(SEED))
    reqs = traffic()
    runs = {}
    # THE main path: counts at zero just before, read just after
    pa.launches = 0
    zero_launches(pa)
    for kv in (None, "int8"):
        engine = serving.DecodeEngine(model, slots=SLOTS, total_len=MAX_LEN,
                                      kv_block_size=BLOCK, kv_dtype=kv,
                                      device=dev)
        with engine:
            out, wall = serve_over_http(serving, engine, reqs)
            counts = engine.counters.snapshot()["counts"]
            runs[kv] = {"out": out, "wall": wall, "counts": counts,
                        "stages": engine.timers.snapshot(),
                        "stage_samples": engine.timers.counts(),
                        "ttft_p50": engine.histograms["ttft"].quantile(0.5),
                        "step_p50": engine.histograms["decode_step"]
                        .quantile(0.5)}
    preempt = preemption_leg(torch, serving, generation, model, reqs[:8],
                             runs[None]["out"][:8], dev)
    launches = pa.launches
    route_launches = dict(pa.route_launches)
    check(launches > 0, "the serving path never launched the kernel")
    # every decode step (S_q = 1) takes the split-KV route, every prefill
    # (a bucket of >= 8 tokens) the window route up to
    # WINDOW_MAX_QUERIES queries and the query-tiled one above, once a
    # layer
    steps = sum(r["counts"].get("decode_steps", 0) for r in runs.values())
    steps += preempt["decode_steps"]
    prefills = sum(r["counts"].get("prefills", 0) for r in runs.values())
    prefills += preempt["prefills"]
    want = want_routes(pa, LAYERS * steps, prefills)
    log("serving paged launches by route: {} (decode steps {}, prefills {}, "
        "{} layers)".format(route_launches, steps, prefills, LAYERS))
    check(route_launches == want,
          "decode steps did not all take the split route and prefills "
          "the window or tiled one by their query counts: {} vs {}".format(
              route_launches, want))
    for kv in (None, "int8"):
        r = runs[kv]
        gen = sum(n for _, n in reqs)
        log("serving kv={:<7} tokens/s={:.1f} wall={:.2f}s ttft_p50={:.4f}s "
            "decode_step_p50={:.4f}s prefix_hit_blocks={} preemptions={} "
            "decode_steps={}".format(
                kv or "float32", gen / r["wall"], r["wall"], r["ttft_p50"],
                r["step_p50"], r["counts"].get("prefix_hit_blocks", 0),
                r["counts"].get("preemptions", 0),
                r["counts"].get("decode_steps", 0)))
        log("  stages: " + ", ".join(
            "{} {:.3f}s/{}".format(k, v, r["stage_samples"][k])
            for k, v in sorted(r["stages"].items())))
        check(r["counts"].get("prefix_hit_blocks", 0) > 0,
              "shared-prefix requests never hit the prefix cache")
        r["tokens_per_s"] = gen / r["wall"]
        with serving.DecodeEngine(model, slots=SLOTS, total_len=MAX_LEN,
                                  kv_block_size=BLOCK, kv_dtype=kv,
                                  attn_impl="gather", device=dev) as oracle:
            gather = [h.result(600) for h in
                      [oracle.submit(p, n) for p, n in reqs]]
        r["ties"] = compare_tokens(torch, generation, model, r["out"], gather,
                                   reqs, kv, dev)
        log("serving kv={:<7} fused == gather on {}/{} requests ({} at a "
            "tie)".format(kv or "float32", len(reqs) - r["ties"], len(reqs),
                          r["ties"]))
    check(pa.launches == launches, "the gather oracle launched the kernel")
    return launches, route_launches, runs, preempt


def preemption_leg(torch, serving, generation, model, reqs, want, dev):
    """Serve ``reqs`` through a float engine whose pool cannot hold them
    all at full length: the youngest admissions are preempted and
    resume with a continuation prefill, and their tokens must equal the
    unpressured run's ``want`` (up to a tie)."""
    with serving.DecodeEngine(model, slots=SLOTS, total_len=MAX_LEN,
                              kv_block_size=BLOCK, kv_blocks=PREEMPT_BLOCKS,
                              device=dev) as engine:
        t0 = time.monotonic()
        out = [h.result(600) for h in
               [engine.submit(p, n) for p, n in reqs]]
        wall = time.monotonic() - t0
        counts = engine.counters.snapshot()["counts"]
    preempted = counts.get("preemptions", 0)
    log("preemption kv=float32 kv_blocks={} preemptions={} prefills={} "
        "wall={:.2f}s".format(PREEMPT_BLOCKS, preempted,
                              counts.get("prefills", 0), wall))
    check(preempted > 0, "the small pool never preempted a request")
    ties = compare_tokens(torch, generation, model, out, want, reqs, None,
                          dev)
    log("preemption kv=float32 equal to the unpressured run on {}/{} "
        "requests ({} at a tie)".format(len(reqs) - ties, len(reqs), ties))
    return {"preemptions": preempted, "wall": wall, "ties": ties,
            "prefills": counts.get("prefills", 0),
            "decode_steps": counts.get("decode_steps", 0)}


# -- phase 5: training at full width ------------------------------------


def motif_batches(steps, batch, seq):
    """A seeded, learnable stream: each row repeats a random motif of
    16-64 tokens drawn from a pool of 256 token ids; ``y`` is ``x``
    shifted by one."""
    rng = np.random.RandomState(SEED + 3)
    pool = rng.choice(VOCAB, size=256, replace=False)
    out = []
    for _ in range(steps):
        rows = np.empty((batch, seq + 1), np.int64)
        for r in range(batch):
            motif = pool[rng.randint(0, len(pool),
                                     size=rng.randint(16, 65))]
            rows[r] = np.resize(motif, seq + 1)
        out.append({"x": rows[:, :-1].copy(), "y": rows[:, 1:].copy()})
    return out


def loss_and_grads(torch, training, model, batch, attn_impl):
    model.zero_grad(set_to_none=True)
    logits = model(batch["x"], attn_impl=attn_impl)
    loss = training.softmax_xent(logits, batch)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def plain_step_check(torch, training, fa, model, batch, dev):
    """One forward and backward on the initial weights and the first
    batch, attention through the kernels and then through the plain
    versions: same loss, same gradients."""
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    before = dict(fa.launches)
    k_loss, k_grads = loss_and_grads(torch, training, model, batch, "fused")
    check(all(fa.launches[k] == before[k] + LAYERS for k in before),
          "the kernel step did not launch each flash kernel once a layer")
    p_loss, p_grads = loss_and_grads(torch, training, model, batch,
                                     "gather")
    check(fa.launches == {k: before[k] + LAYERS for k in before},
          "the plain step launched a flash kernel")
    rel_loss = abs(k_loss - p_loss) / abs(p_loss)
    worst_name, worst = "", -1.0
    top = max(g.abs().max().item() for g in p_grads.values())
    for name, want in p_grads.items():
        got = k_grads[name]
        check(bool(torch.isfinite(got).all()), name + " grad not finite")
        if name.endswith("attn.key.bias"):
            # a key bias shifts every logit of a row alike: its gradient
            # is zero in exact arithmetic, and both routes return
            # rounding noise — held small against the largest gradient
            check(max(got.abs().max().item(), want.abs().max().item())
                  <= 1e-4 * top, name + " gradient is not at noise level")
            continue
        rel = (got - want).abs().max().item() / want.abs().max().item()
        if rel > worst:
            worst_name, worst = name, rel
    log("kernel vs plain attention step: loss {:.6f} vs {:.6f} (rel "
        "{:.2e}, tol {:.0e}); worst gradient {} rel {:.2e} (tol {:.0e})"
        .format(k_loss, p_loss, rel_loss, STEP_LOSS_RTOL, worst_name, worst,
                STEP_GRAD_RTOL))
    check(rel_loss <= STEP_LOSS_RTOL, "kernel and plain losses differ")
    check(worst <= STEP_GRAD_RTOL, "kernel and plain gradients differ")
    return {"loss_rel": rel_loss, "grad_rel": worst, "grad_worst": worst_name}


def training_phase(torch, dev):
    from tensorflowonspark_tpu_torch import infeed, training
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    model = DecoderLM(VOCAB, hidden=HIDDEN, num_heads=HEADS,
                      num_layers=LAYERS, max_len=MAX_LEN, device=dev)
    trainer = training.Trainer(model, training.adamw(TRAIN_LR), device=dev)
    state = trainer.init(torch.Generator(device=dev).manual_seed(SEED))
    batches = motif_batches(TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    plain_step = plain_step_check(torch, training, fa, model, batches[0],
                                  dev)
    losses, step_s, counts = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    # THE main path: counts at zero just before, read just after
    for name in fa.launches:
        fa.launches[name] = 0
    t0 = time.monotonic()
    for batch in infeed.device_batches(iter(batches), device=dev):
        ts = time.monotonic()
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        step_s.append(time.monotonic() - ts)
        counts.append(dict(fa.launches))
    wall = time.monotonic() - t0
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    check(len(losses) == TRAIN_STEPS, "the feed did not yield every batch")
    log("training losses: " + " ".join("{:.4f}".format(x) for x in losses))
    check(all(np.isfinite(losses)), "a training loss is not finite")
    check(np.mean(losses[-3:]) < losses[0],
          "the loss did not fall (first {:.4f}, mean of last 3 {:.4f})"
          .format(losses[0], np.mean(losses[-3:])))
    for i, c in enumerate(counts):
        check(all(c[k] == LAYERS * (i + 1) for k in c),
              "step {}: flash launches {} are not {} per kernel per step"
              .format(i + 1, c, LAYERS))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    p50 = float(np.median(step_s))
    log("training step p50 {:.4f}s  tokens/s {:.1f} (p50)  {:.1f} (10-step "
        "wall {:.2f}s)  max_memory_allocated {:.2f} GiB".format(
            p50, tokens / p50, tokens * TRAIN_STEPS / wall, wall,
            peak / 2 ** 30))
    log("training flash launches per kernel: {} over {} steps".format(
        launches, TRAIN_STEPS))
    from tensorflowonspark_tpu_torch import profile_recovery

    # the uninterrupted run's final train state, for phase 15's restart
    digest = profile_recovery.state_digest(state)
    return launches, {"losses": losses, "step_s": step_s, "p50_s": p50,
                      "tokens_per_s": tokens / p50, "wall_s": wall,
                      "max_memory_allocated": peak,
                      "plain_step": plain_step, "digest": digest}


# -- phase 6: the cluster-fed trainer -----------------------------------


#: phase 6's partitions of the 80 records (10 batches of 8): each a
#: multiple of the batch, since a batch never straddles a partition
CLUSTER_PARTITIONS = (16, 24, 16, 24)


def row_digest(row):
    import hashlib
    return hashlib.blake2b(np.ascontiguousarray(row).tobytes(),
                           digest_size=8).hexdigest()


def cluster_map_fun(args, ctx):
    """The trainer of phases 6 and 9(a), run by the port's cluster in a
    process forked from the executor (this function ships by value from
    ``__main__``): phase 5's model and optimizer from the same seed,
    fed by ``DataFeed`` through ``infeed.device_batches`` into
    ``Trainer.train_loop`` with the goodput ledger; writes what it saw to
    ``args["out"]``. With ``args["text"]`` each record is a line of
    comma-separated token ids (phase 9's spool files), parsed back into
    a row; ``args["first_batch_mark"]`` is a file it creates when it
    pulls its first batch."""
    import json
    import time

    # wall-clock marks of the trainer's start-up, for the breakdown
    marks = [("start", time.time())]
    import torch
    from tensorflowonspark_tpu_torch import goodput, infeed, training
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM
    from tensorflowonspark_tpu_torch.ops import _build
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    marks.append(("imports", time.time()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prebuilt = os.path.exists(_build.library_path("flash_attention"))
    dev = ctx.initialize_torch(args["device"])
    torch.zeros(1, device=dev).sum().item()  # the CUDA context exists
    marks.append(("device", time.time()))
    cfg = args["model"]
    model = DecoderLM(cfg["vocab"], hidden=cfg["hidden"],
                      num_heads=cfg["heads"], num_layers=cfg["layers"],
                      max_len=cfg["max_len"], device=dev)
    marks.append(("model", time.time()))
    trainer = training.Trainer(model, training.adamw(args["lr"]), device=dev)
    gen = (torch.Generator(device=dev) if dev.type == "cuda"
           else torch.Generator())
    state = trainer.init(gen.manual_seed(args["seed"]))
    float(next(model.parameters()).sum())  # the init has run
    marks.append(("init", time.time()))
    # phase 9 streams the records as text lines of token ids
    text = args.get("text", False)
    feed = ctx.get_data_feed(
        train_mode=True, input_mapping=None if text else {"tokens": "tokens"})
    marks.append(("feed", time.time()))
    digests, pulled = [], []

    def batches():
        for b in feed.numpy_batches(args["batch"]):
            pulled.append(time.time())
            if text:
                rows = np.stack([np.array(line.split(","), np.int64)
                                 for line in b])
            else:
                rows = b["tokens"]  # the feed's staging buffer, reused
            if len(pulled) == 1 and args.get("first_batch_mark"):
                open(args["first_batch_mark"], "w").close()
            digests.extend(row_digest(r) for r in rows)
            yield {"x": rows[:, :-1], "y": rows[:, 1:]}

    losses, step_s, counts, at_step = [], [], [], {}
    clock = [None]

    def hook(n, st, metrics):
        losses.append(float(metrics["loss"]))  # waits for the step
        now = time.monotonic()
        step_s.append(now - clock[0])
        clock[0] = now
        counts.append(dict(fa.launches))
        # the feed and the ledger as of this step: after the last one
        # the loop still waits for the end-of-feed marker shutdown sends
        at_step.update(feed=feed.stats(), goodput=goodput.ledger().report())

    # THE main path of this phase: counts at zero just before
    for name in fa.launches:
        fa.launches[name] = 0
    clock[0] = time.monotonic()
    state, steps, _ = trainer.train_loop(
        state, infeed.device_batches(batches(), device=dev), log_every=0,
        hooks=(hook,))
    with open(args["out"], "w") as f:
        json.dump({"steps": steps, "losses": losses, "step_s": step_s,
                   "flash_launches": counts, "digests": digests,
                   "pulled_wall": pulled, "startup_marks": marks,
                   "feed_stats": feed.stats(),
                   "feed_stats_at_last_step": at_step.get("feed"),
                   "goodput_at_last_step": at_step.get("goodput"),
                   "goodput_final": goodput.ledger().report(),
                   "transport": ctx.mgr.get("feed_transport"),
                   "ring": feed._ring is not None,
                   "device": str(dev), "kernels_prebuilt": prebuilt,
                   "pid": os.getpid()}, f)


def cuda_probe(iterator):
    """Run as a task in the executor after training: its CUDA state and
    the foreign modules it holds (none may be there)."""
    import torch
    list(iterator)
    return [{"cuda_initialized": torch.cuda.is_initialized(),
             "pid": os.getpid(),
             "foreign": sorted(m for m in sys.modules
                               if m.split(".")[0] in (
                                   "jax", "flax", "optax", "cloudpickle",
                                   "tensorflowonspark_tpu")
                               and sys.modules[m] is not None)}]


def cluster_phase(device, phase5, parent):
    """``cluster.run(InputMode.SPARK)`` with one executor, the 10 motif
    batches of phase 5 as 80 records in 4 partitions through
    ``tfc.train``, a CUDA probe in the executor, ``shutdown`` and
    ``sc.stop``; every check of phase 6. The engine's work directory is
    a ``.tfos-cluster-*`` directory under ``parent``, removed at the
    end."""
    import shutil
    import tempfile

    from tensorflowonspark_tpu_torch import cluster
    from tensorflowonspark_tpu_torch.engine import Context

    batches = motif_batches(TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    rows = np.concatenate([np.concatenate([b["x"], b["y"][:, -1:]], axis=1)
                           for b in batches])
    records = [{"tokens": r} for r in rows]
    check(len(records) == sum(CLUSTER_PARTITIONS), "partition sizes")
    work = tempfile.mkdtemp(prefix=".tfos-cluster-", dir=parent)
    out = os.path.join(work, "trainer.json")
    args = {"device": device, "seed": SEED, "lr": TRAIN_LR,
            "batch": TRAIN_BATCH, "out": out,
            "model": {"vocab": VOCAB, "hidden": HIDDEN, "heads": HEADS,
                      "layers": LAYERS, "max_len": MAX_LEN}}
    t0 = time.monotonic()
    sc = Context(num_executors=1, work_root=os.path.join(work, "engine"),
                 executor_env={"TFOS_FEED_TRANSPORT": "shm"})
    try:
        t_ctx = time.monotonic() - t0
        t0 = time.monotonic()
        tfc = cluster.run(sc, cluster_map_fun, args, 1,
                          input_mode=cluster.InputMode.SPARK)
        bootstrap = time.monotonic() - t0
        parts, start = [], 0
        for n in CLUSTER_PARTITIONS:
            parts.append(sc.parallelize(records[start:start + n], 1))
            start += n
        rdd = sc.union(parts)
        check(rdd.getNumPartitions() == len(CLUSTER_PARTITIONS),
              "the records are not in {} partitions".format(
                  len(CLUSTER_PARTITIONS)))
        t0, wall0 = time.monotonic(), time.time()
        tfc.train(rdd, num_epochs=1)
        feed_s = time.monotonic() - t0
        probe = sc.parallelize([0], 1).mapPartitions(cuda_probe).collect()
        leases = tfc.server.lease_snapshot()
        t0 = time.monotonic()
        tfc.shutdown()
        shutdown_s = time.monotonic() - t0
        metrics = tfc.metrics()
    finally:
        sc.stop()
    alive = [p.pid for p in sc._procs if p.poll() is None]
    check(not alive, "executors alive after sc.stop(): {}".format(alive))
    with open(out) as f:
        got = json.load(f)
    shutil.rmtree(work, ignore_errors=True)
    try:
        os.kill(got["pid"], 0)
        trainer_alive = True
    except ProcessLookupError:
        trainer_alive = False
    check(not trainer_alive, "the trainer outlived shutdown")
    check(got["device"] == "cuda:0" or device == "cpu",
          "the trainer ran on {}".format(got["device"]))
    check(got["kernels_prebuilt"], "the trainer found no built kernel")
    transports = {v["payload"].get("feed_transport")
                  for v in leases.values()}
    check(got["transport"] == "shm" and got["ring"]
          and transports == {"shm"},
          "the feed did not ride the shm ring (trainer {}, ring {}, "
          "leases {})".format(got["transport"], got["ring"], transports))
    check(got["steps"] == TRAIN_STEPS and len(got["losses"]) == TRAIN_STEPS,
          "the trainer took {} steps, not {}".format(got["steps"],
                                                     TRAIN_STEPS))
    stats = got["feed_stats_at_last_step"]
    check(got["feed_stats"]["records"] == len(records),
          "DataFeed counted {} records, not {}".format(
              got["feed_stats"]["records"], len(records)))
    check(got["digests"] == [row_digest(r) for r in rows],
          "the records were not each delivered once, in order")
    for i, c in enumerate(got["flash_launches"]):
        check(all(c[k] == LAYERS * (i + 1) for k in c),
              "cluster step {}: flash launches {} are not {} per kernel "
              "per step".format(i + 1, c, LAYERS))
    want = phase5["losses"]
    rel = [abs(g - w) / abs(w) for g, w in zip(got["losses"], want)]
    check(max(rel) <= STEP_LOSS_RTOL,
          "cluster-fed losses differ from phase 5's (worst rel {:.2e})"
          .format(max(rel)))
    check(probe and probe[0]["cuda_initialized"] is False,
          "the executor holds a CUDA context: {}".format(probe))
    check(probe[0]["foreign"] == [], "the executor imported {}".format(
        probe[0]["foreign"]))
    merged = metrics["cluster"]["merged"]["counters"].get("tfos_feed", {})
    records_seen = merged.get("counts", {}).get("records")
    check(records_seen == len(records),
          "tfc.metrics() shows {} fed records".format(records_seen))
    nbytes = rows.nbytes
    steps = len(got["step_s"])
    p50 = float(np.median(got["step_s"]))
    share = got["goodput_at_last_step"]
    log("cluster losses: " + " ".join("{:.4f}".format(x)
                                      for x in got["losses"]))
    log("cluster vs phase 5 losses: worst rel {:.2e} (tol {:.0e})".format(
        max(rel), STEP_LOSS_RTOL))
    log("cluster bootstrap {:.3f}s (cluster.run to formed; executor start "
        "{:.3f}s), shutdown {:.3f}s".format(bootstrap, t_ctx, shutdown_s))
    first_lag = got["pulled_wall"][0] - wall0
    log("cluster feed over tfc.train: {} records, {} bytes in {:.3f}s: "
        "{:.1f} records/s, {:.3f} MB/s; transport {}; the first batch "
        "reached the trainer {:.3f}s after tfc.train began (its start-up: "
        "imports, CUDA context, model init)".format(
            len(records), nbytes, feed_s, len(records) / feed_s,
            nbytes / feed_s / 1e6, got["transport"], first_lag))
    marks = got["startup_marks"]
    log("cluster trainer start-up: {}; first batch {:.3f}s after the "
        "feed was ready".format(", ".join(
            "{} {:.3f}s".format(name, t - marks[i][1])
            for i, (name, t) in enumerate(marks[1:])),
            got["pulled_wall"][0] - marks[-1][1]))
    log("cluster DataFeed wait {:.4f}s per step ({:.3f}s over {} steps); "
        "stages {}".format(stats["wait_s"] / steps, stats["wait_s"], steps,
                           {k: round(v, 4) for k, v in
                            stats["stages"].items()}))
    log("cluster-fed step p50 {:.4f}s vs phase 5 {:.4f}s (ratio {:.3f})"
        .format(p50, phase5["p50_s"], p50 / phase5["p50_s"]))
    log("cluster goodput at step {}: productive share {:.4f} of {:.3f}s "
        "(compile {:.3f}s, feed_wait {:.3f}s, idle {:.3f}s)".format(
            share["steps"] + 1, share["goodput_ratio"], share["wall_s"],
            share["badput"]["compile"], share["badput"]["feed_wait"],
            share["badput"]["idle"]))
    log("cluster executor CUDA initialized: {}; flash launches per kernel "
        "{}".format(probe[0]["cuda_initialized"], got["flash_launches"][-1]))
    return {"bootstrap_s": bootstrap, "executor_start_s": t_ctx,
            "shutdown_s": shutdown_s, "feed_s": feed_s,
            "records": len(records), "bytes": int(nbytes),
            "records_per_s": len(records) / feed_s,
            "first_batch_lag_s": first_lag,
            "mb_per_s": nbytes / feed_s / 1e6,
            "wait_s_per_step": stats["wait_s"] / steps,
            "p50_s": p50, "phase5_p50_s": phase5["p50_s"],
            "loss_rel_worst": max(rel), "probe": probe[0],
            "trainer": {k: v for k, v in got.items()
                        if k not in ("digests", "pulled_wall")}}


# -- phase 7: the pipeline (TFRecords -> fit -> checkpoint -> export ->
# transform) -------------------------------------------------------------

#: the DataFrame's slices, so saveAsTFRecords writes part-00000..3
PIPELINE_SLICES = 4
#: held-out rows scored by TFModel.transform, and its batch
HELD_ROWS, TRANSFORM_BATCH = 16, 8
#: steps before the checkpoint; the rest run on the restored model
RESUME_AT = 5
#: transform's last-position logit against the trainer's own, relative:
#: the same weights through the same kernels, one on the trainer's model
#: and one on the export's variables
TRANSFORM_RTOL = 1e-4


def state_digest(state):
    """sha256 over every parameter and every optimizer moment and step
    count, in parameter-name order: equal digests are a bitwise equal
    state."""
    import hashlib

    h = hashlib.sha256()
    names = {id(p): n for n, p in state["params"].items()}
    for name, p in sorted(state["params"].items()):
        h.update(name.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    opt = state["opt_state"]
    for p, st in sorted(opt.state.items(), key=lambda kv: names[id(kv[0])]):
        for k in sorted(st):
            h.update(k.encode())
            h.update(st[k].detach().cpu().numpy().tobytes())
    h.update(str(int(state["step"])).encode())
    return h.hexdigest()


def make_apply_fn(cfg):
    """The export's ``apply_fn``: a ``DecoderLM`` skeleton on the
    ``meta`` device, run on the loaded variables through
    ``torch.func.functional_call``; the last position's arg-max token
    and its logit."""

    def apply_fn(variables, batch):
        import torch
        from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

        skeleton = DecoderLM(cfg["vocab"], hidden=cfg["hidden"],
                             num_heads=cfg["heads"],
                             num_layers=cfg["layers"],
                             max_len=cfg["max_len"], device="meta")
        with torch.no_grad():
            logits = torch.func.functional_call(skeleton, variables,
                                                (batch["x"],))
        last = logits[:, -1]
        return {"next_token": last.argmax(-1), "next_logit": last.max(-1)[0]}

    return apply_fn


def pipeline_train_fn(args, ctx):
    """Phase 7's trainer, run by ``TFEstimator.fit`` in a process forked
    from the executor (``InputMode.TENSORFLOW``; ships by value from
    ``__main__``): joins a one-rank group (NCCL on the card) so the
    ``Trainer`` takes its DDP path, reads the ``part-*`` TFRecords with
    the native codec, trains phase 5's model from the same seed for
    ``RESUME_AT`` steps with a checkpoint hook, restores that step into a
    fresh model from another seed, trains the rest, exports from the
    chief and scores the held-out rows with its own live model."""
    import gc
    import json
    import sys
    import time

    marks = [("start", time.time())]
    import numpy as np
    import torch
    import torch.distributed as dist
    from tensorflowonspark_tpu_torch import (checkpoint, goodput, infeed,
                                             tfnode, tfrecord, training)
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    marks.append(("imports", time.time()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = ctx.initialize_torch(args.device)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method="tcp://" + ctx.coordinator_address(),
            world_size=1, rank=0)
    sync = (torch.cuda.synchronize if dev.type == "cuda" else lambda: None)
    torch.zeros(1, device=dev).sum().item()  # the context exists
    marks.append(("device", time.time()))

    files = tfrecord.list_tfrecord_files(args.tfrecord_dir)
    t0 = time.monotonic()
    rows = np.concatenate([
        tfrecord.read_batch(f, {"tokens": ("int64", args.seq + 1)})["tokens"]
        for f in files])
    read_s = time.monotonic() - t0
    read_bytes = sum(os.path.getsize(f) for f in files)
    bs = args.batch_size
    # batches of bs rows, cut across file boundaries
    batches = [{"x": rows[i:i + bs, :-1], "y": rows[i:i + bs, 1:]}
               for i in range(0, len(rows), bs)]
    cfg = args.model

    def build(seed):
        model = DecoderLM(cfg["vocab"], hidden=cfg["hidden"],
                          num_heads=cfg["heads"], num_layers=cfg["layers"],
                          max_len=cfg["max_len"], device=dev)
        trainer = training.Trainer(model, training.adamw(args.lr),
                                   device=dev)
        gen = (torch.Generator(device=dev) if dev.type == "cuda"
               else torch.Generator())
        return model, trainer, trainer.init(gen.manual_seed(seed))

    losses, step_s, counts = [], [], []
    clock = [None]

    def record(n, st, metrics):
        losses.append(float(metrics["loss"]))  # waits for the step
        now = time.monotonic()
        step_s.append(now - clock[0])
        clock[0] = now
        counts.append(dict(fa.launches))

    ckpt = checkpoint.Checkpointer(args.model_dir, chief=True)
    save_s = []
    save_hook = checkpoint.hook(ckpt, every_steps=RESUME_AT)

    def timed_save(n, st, metrics):
        t = time.monotonic()
        save_hook(n, st, metrics)
        sync()
        if n % RESUME_AT == 0:
            save_s.append(time.monotonic() - t)
        clock[0] = time.monotonic()  # the save is not the next step's

    model, trainer, state = build(args.seed)
    float(next(model.parameters()).sum())  # the init has run
    marks.append(("model", time.time()))
    ddp = [isinstance(trainer.net, torch.nn.parallel.DistributedDataParallel)]
    # THE main path of this phase: counts at zero just before
    for name in fa.launches:
        fa.launches[name] = 0
    clock[0] = time.monotonic()
    state, steps_a, _ = trainer.train_loop(
        state, infeed.device_batches(iter(batches[:RESUME_AT]), device=dev),
        log_every=0, hooks=(record, timed_save))
    saved_digest = state_digest(state)
    step_dir = os.path.join(args.model_dir, str(RESUME_AT))
    ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs_ in os.walk(step_dir) for f in fs_)
    del model, trainer, state, save_hook
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    model, trainer, state = build(args.seed + 1000)
    fresh_digest = state_digest(state)
    sync()
    t0 = time.monotonic()
    state = ckpt.restore(state, step=RESUME_AT)
    sync()
    restore_s = time.monotonic() - t0
    restored_digest = state_digest(state)
    ddp.append(isinstance(trainer.net,
                          torch.nn.parallel.DistributedDataParallel))
    clock[0] = time.monotonic()
    state, steps_b, _ = trainer.train_loop(
        state, infeed.device_batches(iter(batches[RESUME_AT:]), device=dev),
        log_every=0, hooks=(record,))
    launches = dict(fa.launches)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    out = {}
    if ctx.job_name == "chief":
        sync()
        t0 = time.monotonic()
        tfnode.export_saved_model(
            args.export_dir, args.apply_fn, model.state_dict(),
            {"inputs": ["x"], "outputs": ["next_token", "next_logit"]})
        out["export_s"] = time.monotonic() - t0
        out["export_bytes"] = sum(
            os.path.getsize(os.path.join(args.export_dir, f))
            for f in os.listdir(args.export_dir))
        held = np.load(args.held)
        model.eval()
        tokens, logits, gaps = [], [], []
        with torch.no_grad():
            for i in range(0, len(held), TRANSFORM_BATCH):
                x = torch.from_numpy(held[i:i + TRANSFORM_BATCH]).to(dev)
                last = model(x)[:, -1]
                top2 = last.topk(2, dim=-1).values
                tokens += last.argmax(-1).tolist()
                logits += top2[:, 0].tolist()
                gaps += (top2[:, 0] - top2[:, 1]).tolist()
        out.update(held_tokens=tokens, held_logits=logits, held_gaps=gaps)
    with open(args.out, "w") as f:
        json.dump(dict(
            out, steps=steps_a + steps_b, losses=losses, step_s=step_s,
            flash_launches=counts, launches=launches, ddp=ddp,
            backend=dist.get_backend(), world=dist.get_world_size(),
            saved_digest=saved_digest, fresh_digest=fresh_digest,
            restored_digest=restored_digest, restored_step=RESUME_AT,
            ckpt_bytes=ckpt_bytes, save_s=save_s, restore_s=restore_s,
            read_s=read_s, read_bytes=read_bytes, rows=len(rows),
            codec_reads=dict(tfrecord.codec_reads),
            goodput=goodput.ledger().report(),
            max_memory_allocated_after_restore=peak,
            startup_marks=marks, device=str(dev), pid=os.getpid(),
            modules=sorted(m for m in sys.modules
                           if m.startswith("tensorflowonspark_tpu_torch.")),
            foreign=sorted(m for m in sys.modules
                           if m.split(".")[0] in (
                               "jax", "flax", "optax", "orbax",
                               "cloudpickle", "tensorflowonspark_tpu")
                           and sys.modules[m] is not None)), f)
    dist.destroy_process_group()


def executor_probe(args):
    """A task in the executor: load the export (timed; ``TFModel``
    then finds it in the per-process cache) or read what the executor
    holds — its flash launches, its modules, the foreign ones."""

    def probe(iterator):
        import time

        from tensorflowonspark_tpu_torch import export
        from tensorflowonspark_tpu_torch.ops import flash_attention as fa
        list(iterator)
        out = {"pid": os.getpid(), "fwd": fa.launches["fwd"]}
        if args.get("load"):
            t0 = time.monotonic()
            export.load_model(args["load"], device=args["device"])
            out["load_s"] = time.monotonic() - t0
        out["modules"] = sorted(m for m in sys.modules if m.startswith(
            "tensorflowonspark_tpu_torch."))
        out["foreign"] = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "flax", "optax", "orbax",
                                   "cloudpickle", "tensorflowonspark_tpu")
            and sys.modules[m] is not None)
        return [out]

    return probe


def pipeline_phase(device, phase5, parent):
    """Phase 7: the 80 rows of phase 5 to ``part-*`` TFRecords through
    ``createDataFrame`` + ``dfutil.saveAsTFRecords``,
    ``TFEstimator.fit`` in TENSORFLOW mode (``pipeline_train_fn``), then
    ``TFModel.transform`` of 16 held-out rows from the export; every
    check of phase 7. The work directory (TFRecords, the ~2 GB
    checkpoint, the export) is a ``.tfos-pipeline-*`` directory under
    ``parent``, removed at the end."""
    import shutil
    import tempfile

    from tensorflowonspark_tpu_torch import dfutil, pipeline, tfrecord
    from tensorflowonspark_tpu_torch.engine import Context

    t_phase = time.monotonic()
    batches = motif_batches(TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    rows = np.concatenate([np.concatenate([b["x"], b["y"][:, -1:]], axis=1)
                           for b in batches])
    held = np.random.RandomState(SEED + 7).randint(
        0, VOCAB, (HELD_ROWS, TRAIN_SEQ)).astype(np.int64)
    work = tempfile.mkdtemp(prefix=".tfos-pipeline-", dir=parent)
    paths = {k: os.path.join(work, k) for k in (
        "records", "ckpt", "export", "engine")}
    held_path = os.path.join(work, "held.npy")
    np.save(held_path, held)
    out = os.path.join(work, "trainer.json")
    cfg = {"vocab": VOCAB, "hidden": HIDDEN, "heads": HEADS,
           "layers": LAYERS, "max_len": MAX_LEN}
    sc = Context(num_executors=1, work_root=paths["engine"])
    try:
        df = sc.createDataFrame([{"tokens": r} for r in rows],
                                num_slices=PIPELINE_SLICES)
        t0 = time.monotonic()
        written = dfutil.saveAsTFRecords(df, paths["records"])
        write_s = time.monotonic() - t0
        files = tfrecord.list_tfrecord_files(paths["records"])
        write_bytes = sum(os.path.getsize(f) for f in files)
        counted = sum(tfrecord.count_records(f) for f in files)
        est = (pipeline.TFEstimator(pipeline_train_fn, {
            "device": device, "seed": SEED, "lr": TRAIN_LR,
            "seq": TRAIN_SEQ, "model": cfg, "held": held_path, "out": out,
            "apply_fn": make_apply_fn(cfg)})
            .setClusterSize(1).setInputMode("tensorflow")
            .setTfrecordDir(paths["records"]).setModelDir(paths["ckpt"])
            .setExportDir(paths["export"]).setBatchSize(TRAIN_BATCH))
        t0 = time.monotonic()
        fitted = est.fit(df)
        fit_s = time.monotonic() - t0
        # the trainer has exited: the executor now takes the card
        model = pipeline.TFModel(vars(fitted.merged_args()), device=device)
        model.setInputMapping({"tokens": "x"}).setOutputMapping(
            {"next_token": "next_token", "next_logit": "next_logit"})
        model.setBatchSize(TRANSFORM_BATCH)
        held_df = sc.createDataFrame([{"tokens": r} for r in held],
                                     num_slices=HELD_ROWS // TRANSFORM_BATCH)
        one = sc.parallelize([0], 1)
        loaded = one.mapPartitions(executor_probe(
            {"load": paths["export"], "device": device})).collect()[0]
        t0 = time.monotonic()
        scored_df = model.transform(held_df)
        scored = scored_df.collect()
        transform_s = time.monotonic() - t0
        after = one.mapPartitions(executor_probe({})).collect()[0]
        # again, warm: the executor's first forward is behind it
        t0 = time.monotonic()
        warm = model.transform(held_df).collect()
        warm_s = time.monotonic() - t0
        schema = scored_df.schema  # inferred from one more row
    finally:
        sc.stop()
    alive = [p.pid for p in sc._procs if p.poll() is None]
    check(not alive, "executors alive after sc.stop(): {}".format(alive))
    with open(out) as f:
        got = json.load(f)
    shutil.rmtree(work, ignore_errors=True)
    check(not os.path.exists(work), "the pipeline's work directory stayed")
    try:
        os.kill(got["pid"], 0)
        trainer_alive = True
    except ProcessLookupError:
        trainer_alive = False
    check(not trainer_alive, "the trainer outlived the fit")
    check(written == counted == len(rows) and len(files) == PIPELINE_SLICES,
          "part-* holds {} records in {} files ({} written), not {} in {}"
          .format(counted, len(files), written, len(rows), PIPELINE_SLICES))
    check(got["steps"] == TRAIN_STEPS and len(got["losses"]) == TRAIN_STEPS,
          "the pipeline trainer took {} steps, not {}".format(
              got["steps"], TRAIN_STEPS))
    check(got["rows"] == len(rows), "the trainer read {} rows".format(
        got["rows"]))
    check(got["codec_reads"] == {"native": PIPELINE_SLICES, "python": 0},
          "the trainer's TFRecord reads were not all native: {}".format(
              got["codec_reads"]))
    check(got["ddp"] == [True, True] and got["world"] == 1
          and (got["backend"] == "nccl" or device == "cpu"),
          "the trainer did not run in DDP over NCCL ({} {} {})".format(
              got["ddp"], got["backend"], got["world"]))
    check(got["restored_digest"] == got["saved_digest"]
          != got["fresh_digest"],
          "the restored parameters and AdamW moments are not the saved "
          "ones bitwise")
    for i, c in enumerate(got["flash_launches"]):
        check(all(c[k] == LAYERS * (i + 1) for k in c),
              "pipeline step {}: flash launches {} are not {} per kernel "
              "per step".format(i + 1, c, LAYERS))
    want = phase5["losses"]
    rel = [abs(g - w) / abs(w) for g, w in zip(got["losses"], want)]
    check(max(rel) <= STEP_LOSS_RTOL,
          "pipeline losses differ from phase 5's (worst rel {:.2e}; steps "
          "{}-{} after the restore)".format(max(rel), RESUME_AT + 1,
                                            TRAIN_STEPS))
    check(len(scored) == HELD_ROWS, "transform returned {} rows".format(
        len(scored)))
    check(sorted(schema) == [("next_logit", "float32"),
                             ("next_token", "int64")],
          "transform's schema is {}".format(schema))
    ties = 0
    for i, row in enumerate(scored):
        if row["next_token"] != got["held_tokens"][i]:
            check(got["held_gaps"][i] < TIE_GAP,
                  "transform row {}: token {} vs the trainer's {} (top-2 "
                  "gap {:.2e})".format(i, row["next_token"],
                                       got["held_tokens"][i],
                                       got["held_gaps"][i]))
            ties += 1
    check(warm == scored, "a second transform gave other outputs")
    logit_rel = max(abs(r["next_logit"] - w) / abs(w)
                    for r, w in zip(scored, got["held_logits"]))
    check(logit_rel <= TRANSFORM_RTOL,
          "transform's logits differ from the trainer's (rel {:.2e})".format(
              logit_rel))
    check(after["fwd"] == LAYERS * HELD_ROWS // TRANSFORM_BATCH
          or device == "cpu",
          "transform launched the flash forward {} times, not {}".format(
              after["fwd"], LAYERS * HELD_ROWS // TRANSFORM_BATCH))
    port = "tensorflowonspark_tpu_torch."
    need = {"trainer": (got["modules"], ("tfrecord", "checkpoint",
                                         "export")),
            "executor": (after["modules"], ("pipeline", "export")),
            "driver": (sorted(sys.modules), ("pipeline", "dfutil",
                                             "tfrecord"))}
    for where, (mods, names) in need.items():
        missing = [n for n in names if port + n not in mods]
        check(not missing, "the {} did not use the port's {}".format(
            where, missing))
    driver_foreign = sorted(
        m for m in sys.modules if m.split(".")[0] in (
            "jax", "flax", "optax", "orbax", "cloudpickle",
            "tensorflowonspark_tpu") and sys.modules[m] is not None)
    check(got["foreign"] == after["foreign"] == driver_foreign == [],
          "foreign modules: trainer {}, executor {}, driver {}".format(
              got["foreign"], after["foreign"], driver_foreign))
    wall = time.monotonic() - t_phase
    p50 = float(np.median(got["step_s"]))
    led = got["goodput"]["badput"]
    log("pipeline losses: " + " ".join("{:.4f}".format(x)
                                       for x in got["losses"]))
    log("pipeline vs phase 5 losses: worst rel {:.2e} (tol {:.0e}); steps "
        "{}-{} ran on a fresh model restored from step {}".format(
            max(rel), STEP_LOSS_RTOL, RESUME_AT + 1, TRAIN_STEPS, RESUME_AT))
    log("pipeline step p50 {:.4f}s vs phase 5 {:.4f}s (ratio {:.3f}); DDP "
        "over {} with {} rank".format(p50, phase5["p50_s"],
                                      p50 / phase5["p50_s"], got["backend"],
                                      got["world"]))
    log("pipeline checkpoint: {} bytes, save {:.3f}s, restore {:.3f}s; "
        "restored state bitwise equal to the saved one; goodput ledger "
        "checkpoint_save {:.3f}s, restore {:.3f}s; max_memory_allocated "
        "after the restore {:.2f} GiB".format(
            got["ckpt_bytes"], got["save_s"][0], got["restore_s"],
            led["checkpoint_save"], led["restore"],
            got["max_memory_allocated_after_restore"] / 2 ** 30))
    log("pipeline export: {} bytes in {:.3f}s; load_model {:.3f}s in the "
        "executor".format(got["export_bytes"], got["export_s"],
                          loaded["load_s"]))
    log("pipeline TFRecords: write {} bytes in {:.3f}s ({:.2f} MB/s, "
        "createDataFrame + saveAsTFRecords), read {} bytes in {:.4f}s "
        "({:.2f} MB/s, native codec)".format(
            write_bytes, write_s, write_bytes / write_s / 1e6,
            got["read_bytes"], got["read_s"],
            got["read_bytes"] / got["read_s"] / 1e6))
    log("pipeline transform: {} rows in {:.3f}s cold ({:.2f} rows/s; the "
        "export already loaded, the executor's first forward), {:.3f}s warm "
        "({:.2f} rows/s, the same outputs); next_token equal on {} of {} "
        "rows ({} top-2 ties), next_logit worst rel {:.2e} (tol {:.0e})"
        .format(len(scored), transform_s, len(scored) / transform_s, warm_s,
                len(scored) / warm_s, len(scored) - ties, len(scored), ties,
                logit_rel, TRANSFORM_RTOL))
    log("pipeline phase wall {:.1f}s (fit {:.1f}s)".format(wall, fit_s))
    return {"wall_s": wall, "fit_s": fit_s, "p50_s": p50,
            "phase5_p50_s": phase5["p50_s"], "loss_rel_worst": max(rel),
            "write_s": write_s, "write_bytes": write_bytes,
            "transform_s": transform_s, "rows_per_s":
            len(scored) / transform_s, "transform_warm_s": warm_s,
            "warm_rows_per_s": len(scored) / warm_s,
            "load_s": loaded["load_s"],
            "ties": ties, "logit_rel": logit_rel,
            "executor_fwd_launches": after["fwd"],
            "trainer": {k: v for k, v in got.items()
                        if not k.startswith("held_")}}


# -- phase 8: the model zoo -------------------------------------------------

#: BERT-base QA fine-tuning at full width, bfloat16, dropout off so the
#: training steps take the flash kernels (examples/bert: S 384)
BERT_BATCH, BERT_SEQ, BERT_STEPS, BERT_LR = 32, 384, 10, 3e-5
BERT_VOCAB, BERT_LAYERS = 30522, 12
#: the planted answer token (examples/bert/bert_squad_spark.py's MARKER)
BERT_MARKER = 1
BERT_KEYS = ("input_ids", "attention_mask", "token_type_ids")
#: the BERT loss with attention through the kernels and through their
#: plain versions, on the same weights and batch, bfloat16. Each route
#: rounds its attention output to bfloat16 once (and P before P V), so
#: an element differs by at most a bfloat16 ulp, 2^-8 of its size, and
#: these rounding differences are independent from layer to layer: over
#: 12 layers the hidden state moves by ~sqrt(12) x 2^-8 ~ 1.4% of an
#: element at the very worst. The loss, a mean over 64 log-softmaxes of
#: 384 positions, averages them; held at that worst case, 1.4e-2.
BERT_STEP_RTOL = 12 ** 0.5 * 2.0 ** -8
#: :predict: 8 clients, 64 row-format requests of 1-4 rows, a 5 ms window
PREDICT_REQUESTS, PREDICT_CLIENTS, PREDICT_WINDOW_MS = 64, 8, 5
#: a served row against the model's own eval forward on its request's
#: rows alone: the same kernels and weights, but the window merges rows
#: from several requests, and cuBLAS may take another bfloat16 GEMM (a
#: different split of the sum) at another row count, so a product's
#: bfloat16 output can differ by an ulp (2^-8), independently per layer:
#: sqrt(12) x 2^-8 ~ 1.4% of the largest logit at worst; held at 2^-5
#: (3.1%) of each request's largest |logit|. A row served with another
#: row's mask or positions moves its logits by O(1).
PREDICT_RTOL = 2.0 ** -5
#: ResNet-50 at ImageNet shape (examples/resnet: SGD 0.1, momentum 0.9)
RESNET_BATCH, RESNET_STEPS, RESNET_IMAGE = 64, 10, 224
#: Inception-v3 batch inference at 299x299
INCEPTION_BATCH, INCEPTION_IMAGE, INCEPTION_CALLS = 32, 299, 5
#: Wide & Deep at Criteo shape, the model's defaults
WD_BATCH, WD_STEPS = 2048, 10
#: U-Net (examples/segmentation) and LeNet (examples/mnist)
UNET_BATCH, UNET_IMAGE, UNET_FEATURES, UNET_CLASSES = 16, 64, (16, 32), 3
LENET_BATCH, SMALL_STEPS = 128, 5


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def qa_batches(steps, batch, seq, seed):
    """Seeded SQuAD-shaped rows (examples/bert's synthetic rows): token
    ids from the vocabulary, lengths 192-384 padded to 384 with the
    attention mask false, a 2-3 token answer span of the planted marker;
    question tokens type 0, the rest type 1."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        ids = np.zeros((batch, seq), np.int64)
        mask = np.zeros((batch, seq), bool)
        tt = np.zeros((batch, seq), np.int64)
        start = np.zeros(batch, np.int64)
        end = np.zeros(batch, np.int64)
        for r in range(batch):
            length = int(rng.randint(seq // 2, seq + 1))
            ids[r, :length] = rng.randint(16, BERT_VOCAB, size=length)
            mask[r, :length] = True
            tt[r, 32:length] = 1
            s = int(rng.randint(32, length - 3))
            span = int(rng.randint(2, 4))
            ids[r, s:s + span] = BERT_MARKER
            start[r], end[r] = s, s + span - 1
        out.append({"input_ids": ids, "attention_mask": mask,
                    "token_type_ids": tt, "start_positions": start,
                    "end_positions": end})
    return out


def make_bert_apply_fn(cfg_kwargs):
    """The BERT export's ``apply_fn``: a ``meta`` skeleton of the QA
    model in eval mode, built at the first call of a process and kept,
    called on the loaded variables (the server runs it under
    ``torch.inference_mode``)."""
    built = {}

    def apply_fn(variables, batch):
        import torch
        from tensorflowonspark_tpu_torch.models import bert as _bert

        skeleton = built.get("skeleton")
        if skeleton is None:
            skeleton = built["skeleton"] = _bert.BertForQuestionAnswering(
                _bert.BertConfig(**cfg_kwargs), device="meta").eval()
        dev = next(iter(variables.values())).device
        inputs = tuple(torch.as_tensor(batch[k]).to(dev)
                       for k in ("input_ids", "attention_mask",
                                 "token_type_ids") if k in batch)
        start, end = torch.func.functional_call(skeleton, variables, inputs)
        return {"start_logits": start, "end_logits": end}

    return apply_fn


def repeat_step(trainer, state, batch, step):
    """One step from ``state`` at step number ``step``; the model and
    optimizer are restored afterwards. Returns the loss (a tensor)."""
    import copy

    model_sd = copy.deepcopy(trainer.model.state_dict())
    opt_sd = copy.deepcopy(state["opt_state"].state_dict())
    state["step"] = step
    _, m = trainer.step(state, batch)
    loss = m["loss"].clone()
    trainer.model.load_state_dict(model_sd)
    state["opt_state"].load_state_dict(opt_sd)
    return loss


def bert_loss(torch, bert, model, batch, attn_impl):
    with torch.no_grad():
        logits = model(*(batch[k] for k in BERT_KEYS), attn_impl=attn_impl)
        return float(bert.qa_span_loss(logits, batch))


def serve_predict(serving, export_dir, reqs):
    """``reqs`` (lists of rows) through ``ModelServer(export_dir,
    batch_window_ms=5)`` from PREDICT_CLIENTS concurrent HTTP clients;
    returns (responses, per-request seconds, wall, apply calls, the
    status of a ragged request)."""
    out = [None] * len(reqs)
    lat = [None] * len(reqs)
    errors = []
    with serving.ModelServer(export_dir, name="bert", port=0,
                             batch_window_ms=PREDICT_WINDOW_MS) as srv:
        port = srv.address[1]

        def client(c):
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=600)
                for i in range(c, len(reqs), PREDICT_CLIENTS):
                    t0 = time.monotonic()
                    conn.request("POST", "/v1/models/bert:predict",
                                 body=json.dumps({"instances": reqs[i]}),
                                 headers={"Content-Type":
                                          "application/json"})
                    resp = conn.getresponse()
                    body = json.loads(resp.read())
                    lat[i] = time.monotonic() - t0
                    if resp.status != 200:
                        raise RuntimeError("HTTP {}: {}".format(
                            resp.status, body))
                    out[i] = body["predictions"]
                conn.close()
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))

        t0 = time.monotonic()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(PREDICT_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        calls = srv.apply_calls
        bad = dict(reqs[0][0])
        bad["input_ids"] = bad["input_ids"][:-1]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/models/bert:predict",
                     body=json.dumps({"instances": [reqs[0][0], bad]}))
        ragged = conn.getresponse()
        ragged.read()
        conn.close()
    check(not errors, ":predict clients failed: {}".format(errors))
    return out, lat, wall, calls, ragged.status


def bert_legs(torch, dev, here):
    """Phase 8's BERT legs: training through the flash kernels, the
    plain-attention step, the dropout leg and the export served over
    ``:predict``."""
    import tempfile

    from tensorflowonspark_tpu_torch import export, infeed, serving, training
    from tensorflowonspark_tpu_torch.models import bert
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    cfg_kwargs = dict(vocab_size=BERT_VOCAB, num_layers=BERT_LAYERS,
                      dropout_rate=0.0)
    cfg = bert.BertConfig(**cfg_kwargs)
    check((cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
           cfg.max_position, cfg.dtype) == (HIDDEN, HEADS, 3072, 512,
                                            torch.bfloat16),
          "BERT is not at BERT-base width in bfloat16")
    model = bert.BertForQuestionAnswering(cfg, device=dev)
    trainer = training.Trainer(model, training.adamw(BERT_LR),
                               loss_fn=bert.qa_span_loss,
                               input_keys=BERT_KEYS, device=dev)
    state = trainer.init(torch.Generator(device=dev).manual_seed(SEED))
    batches = qa_batches(BERT_STEPS, BERT_BATCH, BERT_SEQ, SEED + 20)
    first = {k: torch.from_numpy(v).to(dev) for k, v in batches[0].items()}

    # one step's loss with attention through the kernels and through
    # their plain versions, on the initial weights
    model.train()
    before = dict(fa.launches)
    k_loss = bert_loss(torch, bert, model, first, None)
    check(fa.launches["fwd"] == before["fwd"] + BERT_LAYERS,
          "the kernel step did not launch the flash forward once a layer")
    p_loss = bert_loss(torch, bert, model, first, "plain")
    check(fa.launches["fwd"] == before["fwd"] + BERT_LAYERS,
          "the plain step launched a flash kernel")
    step_rel = abs(k_loss - p_loss) / abs(p_loss)
    log("BERT kernel vs plain attention loss: {:.6f} vs {:.6f} (rel {:.2e}, "
        "tol {:.2e})".format(k_loss, p_loss, step_rel, BERT_STEP_RTOL))
    check(step_rel <= BERT_STEP_RTOL, "BERT kernel and plain losses differ")

    # the kernels at this shape, on this run's key mask
    mask = first["attention_mask"]
    flash_t = flash_timing(torch, fa, dev, BERT_BATCH, BERT_SEQ, "bfloat16",
                           mask)
    for name, ft in flash_t.items():
        log("flash {:<3} at BERT B32 S384 bf16 key mask: kernel {:.4f} ms "
            "({:.4f} ms device time)  plain {:.4f} ms  sdpa {}  bound {:.4f} "
            "ms ({}; bytes {:.4f} ms, bf16 {:.4f} ms, one-pass TF32 {:.4f} "
            "ms, 3xTF32 {:.4f} ms; {:.3g} flop over {} live keys, {:.3g} B)"
            .format(name, ft["ms"], ft["device_ms"], ft["plain_ms"],
                    library_text(ft), ft["bound_ms"], ft["bound_by"],
                    ft["bytes_ms"], ft["ops_bf16_ms"], ft["ops_tf32_ms"],
                    ft["ops_3xtf32_ms"], ft["flops"], int(mask.sum().item()),
                    ft["bytes"]))
    ft = flash_t["fwd"]
    log("flash fwd at BERT's shape vs SDPA: {:.3f}x per eager call, {:.3f}x "
        "device time; {:.1f}% of the bound".format(
            ft["ms"] / ft["library_ms"],
            ft["device_ms"] / ft["library_device_ms"],
            100.0 * ft["bound_ms"] / ft["device_ms"]))
    # the backward: dQ + dK/dV against SDPA's backward (dq, dk and dv
    # from one autograd call, timed in the dq row's library_ms)
    dq, dkv = flash_t["dq"], flash_t["dkv"]
    bwd = {"ms": dq["ms"] + dkv["ms"],
           "device_ms": dq["device_ms"] + dkv["device_ms"],
           "library_ms": dq["library_ms"],
           "library_device_ms": dq["library_device_ms"]}
    bwd["vs_library"] = bwd["ms"] / bwd["library_ms"]
    bwd["vs_library_device"] = bwd["device_ms"] / bwd["library_device_ms"]
    log("flash dq + dkv at BERT's shape vs SDPA backward (dq+dk+dv): {:.4f} "
        "vs {:.4f} ms = {:.3f}x per eager call, {:.4f} vs {:.4f} ms = {:.3f}x "
        "device time; dq {:.1f}% and dkv {:.1f}% of their bounds".format(
            bwd["ms"], bwd["library_ms"], bwd["vs_library"],
            bwd["device_ms"], bwd["library_device_ms"],
            bwd["vs_library_device"],
            100.0 * dq["bound_ms"] / dq["device_ms"],
            100.0 * dkv["bound_ms"] / dkv["device_ms"]))

    # THE main path of the BERT leg: counts at zero just before
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for name in fa.launches:
        fa.launches[name] = 0
    losses, step_s, counts = [], [], []
    for batch in infeed.device_batches(iter(batches), device=dev):
        ts = time.monotonic()
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        step_s.append(time.monotonic() - ts)
        counts.append(dict(fa.launches))
    train_launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    log("BERT losses: " + " ".join("{:.4f}".format(x) for x in losses))
    check(len(losses) == BERT_STEPS and all(np.isfinite(losses)),
          "a BERT loss is not finite")
    check(np.mean(losses[-3:]) < losses[0],
          "the BERT loss did not fall (first {:.4f}, mean of last 3 {:.4f})"
          .format(losses[0], np.mean(losses[-3:])))
    for i, c in enumerate(counts):
        check(all(c[k] == BERT_LAYERS * (i + 1) for k in c),
              "BERT step {}: flash launches {} are not {} per kernel per "
              "step".format(i + 1, c, BERT_LAYERS))
    p50 = float(np.median(step_s))
    log("BERT step p50 {:.4f}s  sequences/s {:.1f}  max_memory_allocated "
        "{:.2f} GiB; flash launches {}".format(
            p50, BERT_BATCH / p50, peak / 2 ** 30, train_launches))

    # the dropout leg: the einsum path, masks a function of the step
    dcfg = bert.BertConfig(**dict(cfg_kwargs, dropout_rate=0.1))
    dmodel = bert.BertForQuestionAnswering(dcfg, device=dev)
    dmodel.load_state_dict(model.state_dict())
    dtrainer = training.Trainer(dmodel, training.adamw(BERT_LR),
                                loss_fn=bert.qa_span_loss,
                                input_keys=BERT_KEYS, device=dev,
                                dropout_rng=True)
    dstate = dtrainer.init()
    before = dict(fa.launches)
    a = repeat_step(dtrainer, dstate, first, 3)
    b = repeat_step(dtrainer, dstate, first, 3)
    c = repeat_step(dtrainer, dstate, first, 4)
    check(fa.launches == before, "the dropout leg launched a flash kernel")
    check(torch.equal(a, b), "dropout step 3 twice gave other losses")
    check(not torch.equal(a, c), "dropout steps 3 and 4 drew the same masks")
    log("BERT dropout leg (einsum path, dropout_rng): step 3 {:.6f} twice "
        "bitwise, step 4 {:.6f}".format(float(a), float(c)))
    del dmodel, dtrainer, dstate

    # export, then :predict through the batching window
    model.eval()
    rng = np.random.RandomState(SEED + 21)
    pool = qa_batches(1, PREDICT_REQUESTS * 4, BERT_SEQ, SEED + 22)[0]
    reqs, lo = [], 0
    for _ in range(PREDICT_REQUESTS):
        n = int(rng.randint(1, 5))
        reqs.append([{k: pool[k][r].tolist() for k in BERT_KEYS}
                     for r in range(lo, lo + n)])
        lo += n
    work = tempfile.mkdtemp(prefix="tfos-bert-export-", dir=here)
    try:
        export_dir = os.path.join(work, "bert_qa")
        t0 = time.monotonic()
        export.save_model(export_dir, make_bert_apply_fn(cfg_kwargs),
                          model.state_dict(),
                          signature={"inputs": list(BERT_KEYS),
                                     "outputs": ["start_logits",
                                                 "end_logits"]})
        export_s = time.monotonic() - t0
        fwd0 = fa.launches["fwd"]
        got, lat, wall, calls, ragged = serve_predict(serving, export_dir,
                                                      reqs)
        predict_fwd = fa.launches["fwd"] - fwd0
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    check(ragged == 400, "a ragged :predict answered {}".format(ragged))
    check(calls < PREDICT_REQUESTS,
          "the window made {} apply calls for {} requests".format(
              calls, PREDICT_REQUESTS))
    check(predict_fwd == BERT_LAYERS * calls,
          ":predict ran the flash forward {} times over {} apply calls"
          .format(predict_fwd, calls))
    worst = 0.0
    for rows, preds in zip(reqs, got):
        cols = {k: torch.tensor([r[k] for r in rows], device=dev)
                for k in BERT_KEYS}
        with torch.no_grad():
            start, end = model(*(cols[k] for k in BERT_KEYS))
        for key, want in (("start_logits", start), ("end_logits", end)):
            g = torch.tensor([p[key] for p in preds], device=dev)
            check(g.shape == want.shape and bool(torch.isfinite(g).all()),
                  ":predict {} has the wrong shape or is not finite"
                  .format(key))
            rel = ((g - want).abs().max() / want.abs().max()).item()
            worst = max(worst, rel)
    check(worst <= PREDICT_RTOL,
          ":predict disagrees with the model's own forward (rel {:.2e})"
          .format(worst))
    rows_total = sum(len(r) for r in reqs)
    log(":predict {} requests ({} rows) from {} clients, window {} ms: {} "
        "apply calls; flash forward {} ({} per call); request p50 {:.4f}s "
        "p99 {:.4f}s; {:.1f} rows/s; worst rel vs own forward {:.2e} (tol "
        "{:.2e}); ragged request -> {}; export {:.2f}s".format(
            PREDICT_REQUESTS, rows_total, PREDICT_CLIENTS,
            PREDICT_WINDOW_MS, calls, predict_fwd, predict_fwd // calls,
            float(np.percentile(lat, 50)), float(np.percentile(lat, 99)),
            rows_total / wall, worst, PREDICT_RTOL, ragged, export_s))
    return {"losses": losses, "step_s": step_s, "p50_s": p50,
            "sequences_per_s": BERT_BATCH / p50,
            "max_memory_allocated": peak, "launches": train_launches,
            "plain_step": {"kernel_loss": k_loss, "plain_loss": p_loss,
                           "rel": step_rel},
            "dropout": {"step3": float(a), "step4": float(c)},
            "flash_timing": flash_t,
            "flash_backward": bwd,
            "predict": {"requests": PREDICT_REQUESTS, "rows": rows_total,
                        "apply_calls": calls, "fwd_launches": predict_fwd,
                        "p50_s": float(np.percentile(lat, 50)),
                        "p99_s": float(np.percentile(lat, 99)),
                        "rows_per_s": rows_total / wall, "rel": worst,
                        "export_s": export_s}}


def image_batches(torch, dev, steps, batch, size, classes, seed):
    """Seeded uint8 images (examples/resnet's synthetic shards) scaled
    to [0, 1] on the device, NHWC, with integer labels."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        img = rng.randint(0, 256, (batch, size, size, 3), dtype=np.uint8)
        x = torch.from_numpy(img).to(dev).float() / 255.0
        y = torch.from_numpy(rng.randint(0, classes, batch)).to(dev)
        out.append({"x": x, "y": y})
    return out


def timed_steps(torch, dev, trainer, state, batches):
    losses, step_s = [], []
    for batch in batches:
        ts = time.monotonic()
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        step_s.append(time.monotonic() - ts)
    return state, losses, step_s


def resnet_leg(torch, dev):
    from tensorflowonspark_tpu_torch import training
    from tensorflowonspark_tpu_torch.models import resnet

    model = resnet.ResNet50(device=dev).to(memory_format=torch.channels_last)
    trainer = training.Trainer(
        model, lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9),
        device=dev)
    state = trainer.init(torch.Generator(device=dev).manual_seed(SEED))
    stats0 = model.bn_init.running_mean.clone()
    batches = image_batches(torch, dev, RESNET_STEPS, RESNET_BATCH,
                            RESNET_IMAGE, 1000, SEED + 30)
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state, losses, step_s = timed_steps(torch, dev, trainer, state, batches)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    check(all(np.isfinite(losses)), "a ResNet-50 loss is not finite")
    moved = (model.bn_init.running_mean - stats0).abs().max().item()
    check(moved > 0, "ResNet-50's BatchNorm running statistics did not move")
    p50 = float(np.median(step_s))
    log("ResNet-50 224px bf16 batch {}: losses {}; step p50 {:.4f}s  "
        "images/s {:.1f} (one card)  max_memory_allocated {:.2f} GiB; "
        "bn_init running mean moved {:.3g}".format(
            RESNET_BATCH, " ".join("{:.3f}".format(x) for x in losses), p50,
            RESNET_BATCH / p50, peak / 2 ** 30, moved))
    return {"losses": losses, "step_s": step_s, "p50_s": p50,
            "images_per_s": RESNET_BATCH / p50,
            "max_memory_allocated": peak}


def inception_leg(torch, dev):
    from tensorflowonspark_tpu_torch.models import inception

    model = inception.InceptionV3(device=dev).to(
        memory_format=torch.channels_last)
    model.init_weights(torch.Generator(device=dev).manual_seed(SEED))
    model.eval()
    x = image_batches(torch, dev, 1, INCEPTION_BATCH, INCEPTION_IMAGE, 1000,
                      SEED + 31)[0]["x"]
    with torch.inference_mode():
        a = model(x)
        b = model(x)
        _sync(torch, dev)
        t0 = time.monotonic()
        for _ in range(INCEPTION_CALLS):
            model(x)
        _sync(torch, dev)
        per_call = (time.monotonic() - t0) / INCEPTION_CALLS
    check(tuple(a.shape) == (INCEPTION_BATCH, 1000)
          and bool(torch.isfinite(a).all()),
          "Inception-v3 logits have the wrong shape or are not finite")
    check(torch.equal(a, b), "two Inception-v3 calls gave other logits")
    log("Inception-v3 299px bf16 batch {} inference: {:.4f}s a call, "
        "images/s {:.1f}".format(INCEPTION_BATCH, per_call,
                                 INCEPTION_BATCH / per_call))
    return {"s_per_call": per_call,
            "images_per_s": INCEPTION_BATCH / per_call}


def criteo_batches(steps, batch, buckets, seed):
    """Criteo-shaped rows (examples/criteo's synthetic lines): 13 dense
    features log-normalised, 26 categorical ids hashed into the buckets,
    a label that depends on dense[0] and cat[0]."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        d0 = rng.randint(0, 100, batch)
        c0 = rng.randint(0, 8, batch)
        dense = np.log1p(rng.randint(0, 1000, (batch, 13))).astype(
            np.float32)
        dense[:, 0] = np.log1p(d0)
        cat = rng.randint(0, buckets, (batch, 26))
        cat[:, 0] = c0
        label = ((d0 > 50) ^ (c0 < 2)).astype(np.int64)
        out.append({"dense": dense, "cat": cat, "label": label})
    return out


def widedeep_leg(torch, dev):
    from tensorflowonspark_tpu_torch import training
    from tensorflowonspark_tpu_torch.models import widedeep

    model = widedeep.WideDeep(device=dev)
    trainer = training.Trainer(
        model, lambda p: torch.optim.Adam(p, lr=1e-3),
        loss_fn=widedeep.ctr_loss, input_keys=("dense", "cat"), device=dev)
    state = trainer.init(torch.Generator(device=dev).manual_seed(SEED))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in criteo_batches(WD_STEPS + 1, WD_BATCH,
                                       model.hash_buckets, SEED + 32)]
    state, losses, step_s = timed_steps(torch, dev, trainer, state,
                                        batches[:WD_STEPS])
    check(all(np.isfinite(losses)), "a Wide & Deep loss is not finite")
    slim, quant = widedeep.quantize_embeddings(model.state_dict())
    qmodel = widedeep.WideDeep(quantized=True, device=dev)
    qmodel.load_state_dict(dict(slim, **quant))
    held = batches[WD_STEPS]
    model.eval()
    qmodel.eval()
    with torch.no_grad():
        ref = model(held["dense"], held["cat"]).float().cpu().numpy()
        got = qmodel(held["dense"], held["cat"]).float().cpu().numpy()
    # the reference's agreement (tests/test_models.py): per-row int8
    # tables track the float tables within quantization error
    close = bool(np.all(np.abs(got - ref) <= 0.05 + 0.05 * np.abs(ref)))
    corr = float(np.corrcoef(got, ref)[0, 1])
    check(close and corr > 0.999,
          "int8 Wide & Deep logits disagree with the float model's (worst "
          "{:.3g}, corr {:.6f})".format(float(np.abs(got - ref).max()), corr))
    p50 = float(np.median(step_s))
    table = quant["deep_embeddings.table"]
    log("Wide & Deep (13 dense, 26 slots x 100000 buckets, embed 32, MLP "
        "256-128-64) batch {}: losses {:.4f} -> {:.4f}; step p50 {:.4f}s  "
        "rows/s {:.1f}; int8 table {:.1f} MB vs float {:.1f} MB, logits "
        "worst |diff| {:.3g}, corr {:.6f}".format(
            WD_BATCH, losses[0], losses[-1], p50, WD_BATCH / p50,
            (table.numel() + quant["deep_embeddings.scale"].numel() * 4)
            / 1e6, table.numel() * 4 / 1e6, float(np.abs(got - ref).max()),
            corr))
    return {"losses": losses, "step_s": step_s, "p50_s": p50,
            "rows_per_s": WD_BATCH / p50, "int8_corr": corr,
            "int8_worst": float(np.abs(got - ref).max())}


def small_legs(torch, dev):
    """U-Net and LeNet at their examples' shapes: SMALL_STEPS Adam steps
    on one seeded batch each (memorised, so the loss must fall)."""
    from tensorflowonspark_tpu_torch import training
    from tensorflowonspark_tpu_torch.models import lenet, unet

    out = {}
    rng = np.random.RandomState(SEED + 33)
    # U-Net: noise backgrounds with a bright square of class 1 and a
    # dimmer one of class 2 (examples/segmentation's shapes problem)
    x = rng.rand(UNET_BATCH, UNET_IMAGE, UNET_IMAGE, 3).astype(np.float32)
    x *= 0.2
    y = np.zeros((UNET_BATCH, UNET_IMAGE, UNET_IMAGE), np.int64)
    for i in range(UNET_BATCH):
        for cls, level in ((1, 0.9), (2, 0.6)):
            r, c = rng.randint(0, UNET_IMAGE - 16, 2)
            x[i, r:r + 16, c:c + 16] = level
            y[i, r:r + 16, c:c + 16] = cls
    seg = {"x": torch.from_numpy(x).to(dev), "y": torch.from_numpy(y).to(dev)}
    digits = {"x": torch.from_numpy(rng.rand(LENET_BATCH, 28, 28, 1).astype(
                  np.float32)).to(dev),
              "y": torch.from_numpy(rng.randint(0, 10, LENET_BATCH)).to(dev)}
    for name, model, loss_fn, batch in (
            ("unet", unet.UNet(UNET_CLASSES, features=UNET_FEATURES,
                               device=dev), unet.segmentation_loss, seg),
            ("lenet", lenet.LeNet(device=dev), training.softmax_xent,
             digits)):
        trainer = training.Trainer(
            model, lambda p: torch.optim.Adam(p, lr=1e-3), loss_fn=loss_fn,
            device=dev)
        state = trainer.init(torch.Generator(device=dev).manual_seed(SEED))
        state, losses, step_s = timed_steps(torch, dev, trainer, state,
                                            [batch] * SMALL_STEPS)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              "{} loss did not fall: {}".format(name, losses))
        out[name] = {"losses": losses, "p50_s": float(np.median(step_s))}
        log("{} batch {}: losses {}; step p50 {:.4f}s".format(
            name, batch["x"].shape[0],
            " ".join("{:.4f}".format(v) for v in losses),
            out[name]["p50_s"]))
    return out


def models_phase(torch, dev, here):
    """Phase 8: the model zoo on the card, each family through the
    port's entry points; returns every number of the phase."""
    t0 = time.monotonic()
    res = {"bert": bert_legs(torch, dev, here)}
    for name, leg in (("resnet50", resnet_leg),
                      ("inception_v3", inception_leg),
                      ("widedeep", widedeep_leg)):
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        res[name] = leg(torch, dev)
    res.update(small_legs(torch, dev))
    want = ["tensorflowonspark_tpu_torch.models." + m for m in (
        "_layers", "bert", "resnet", "inception", "widedeep", "unet",
        "lenet")] + ["tensorflowonspark_tpu_torch.serving"]
    missing = [m for m in want if m not in sys.modules]
    foreign = [m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "tensorflowonspark_tpu")]
    check(not missing and not foreign,
          "phase 8 modules missing {} or foreign ones loaded {}".format(
              missing, foreign))
    res["wall_s"] = time.monotonic() - t0
    log("models phase wall {:.1f}s".format(res["wall_s"]))
    return res


# -- phase 9: examples and streaming ----------------------------------------


#: phase 9(a): phase 5's 80 records as 5 spool files of 16, one record a
#: line; the first lands at once, the rest every STREAM_LAND_S seconds
#: (faster than the trainer's 2 steps a file) once the trainer has
#: pulled its first batch, and the stream polls every STREAM_POLL_S
STREAM_FILES, STREAM_FILE_RECORDS = 5, 16
STREAM_LAND_S, STREAM_POLL_S = 0.25, 0.1
#: phase 9(b): the port's bert_squad_spark --full_size --dropout 0 through the
#: cluster, one executor, 256 examples in batches of 32 (8 steps), at
#: the example's S 64 with seeded lengths 32-63 (keys masked)
EXAMPLE_BERT_BATCH, EXAMPLE_BERT_EXAMPLES, EXAMPLE_BERT_LR = 32, 256, 1e-4
EXAMPLE_BERT_LAYERS = 12
#: phase 9(c): two parallel_runner jobs, each Inception-v3 (299 px) from
#: the seed on its own seeded batch of 32, against the same forwards in
#: this process. Phase 8 holds two calls in one process bitwise equal;
#: another process may get other cuDNN algorithms for the same
#: convolutions, so the logits are held at phase 8's tolerance for a
#: bfloat16 model's outputs computed in another call (PREDICT_RTOL:
#: 2^-5 of the largest |logit|), and top-1 equal wherever the top-2 gap
#: exceeds it
PARALLEL_JOBS = 2


def parallel_job(args, index):
    """One ``parallel_runner`` job (shipped by value from ``__main__``;
    runs in a child forked from an executor): Inception-v3 from the seed
    on the card, its own seeded batch of 32; returns the logits, its pid
    and device, its start-up and wall."""
    import os
    import time

    t0 = time.monotonic()
    import numpy as np
    import torch
    from tensorflowonspark_tpu_torch.models import inception

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args["device"])
    model = inception_model(torch, inception, dev, args["seed"])
    x = inception_batch(torch, dev, args["seed"], index)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    startup = time.monotonic() - t0
    with torch.inference_mode():
        logits = model(x).float().cpu().numpy()
    return {"index": index, "logits": logits, "pid": os.getpid(),
            "device": str(dev), "startup_s": startup,
            "wall_s": time.monotonic() - t0}


def inception_model(torch, inception, dev, seed):
    model = inception.InceptionV3(device=dev).to(
        memory_format=torch.channels_last)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    return model.eval()


def inception_batch(torch, dev, seed, index):
    rng = np.random.RandomState(seed + 40 + index)
    img = rng.randint(0, 256, (INCEPTION_BATCH, INCEPTION_IMAGE,
                               INCEPTION_IMAGE, 3), dtype=np.uint8)
    return torch.from_numpy(img).to(dev).float() / 255.0


def streaming_leg(device, phase5, parent):
    """9(a): phase 5's records land as spool files; ``textFileStream``
    feeds ``tfc.train(dstream)`` on a one-executor cluster whose trainer
    is phase 6's; ``shutdown(ssc)`` after the last file."""
    import shutil
    import tempfile

    from tensorflowonspark_tpu_torch import cluster
    from tensorflowonspark_tpu_torch.engine import Context, StreamingContext
    from tensorflowonspark_tpu_torch.examples.streaming import (
        streaming_mnist)

    batches = motif_batches(TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    rows = np.concatenate([np.concatenate([b["x"], b["y"][:, -1:]], axis=1)
                           for b in batches])
    check(len(rows) == STREAM_FILES * STREAM_FILE_RECORDS, "spool sizes")
    lines = [",".join(str(int(t)) for t in r) for r in rows]
    work = tempfile.mkdtemp(prefix=".tfos-stream-", dir=parent)
    spool = os.path.join(work, "spool")
    os.makedirs(spool)
    out = os.path.join(work, "trainer.json")
    mark = os.path.join(work, "first-batch")
    args = {"device": device, "seed": SEED, "lr": TRAIN_LR,
            "batch": TRAIN_BATCH, "out": out, "text": True,
            "first_batch_mark": mark,
            "model": {"vocab": VOCAB, "hidden": HIDDEN, "heads": HEADS,
                      "layers": LAYERS, "max_len": MAX_LEN}}
    landed = []
    sc = Context(num_executors=1, work_root=os.path.join(work, "engine"))
    try:
        tfc = cluster.run(sc, cluster_map_fun, args, 1,
                          input_mode=cluster.InputMode.SPARK)
        ssc = StreamingContext(sc, batch_interval=STREAM_POLL_S)
        tfc.train(ssc.textFileStream(spool, num_slices=1))
        ssc.start()
        t0 = time.monotonic()
        for i in range(STREAM_FILES):
            if i == 1:
                deadline = time.monotonic() + 600
                while not os.path.exists(mark):
                    check(time.monotonic() < deadline,
                          "the streaming trainer pulled no batch in 600 s")
                    time.sleep(0.02)
            elif i > 1:
                time.sleep(STREAM_LAND_S)
            part = lines[i * STREAM_FILE_RECORDS:(i + 1) * STREAM_FILE_RECORDS]
            streaming_mnist.land_file(spool, "part-%05d" % i, part)
            landed.append(time.time())
        # the last file's micro-batch dispatches at the next poll;
        # shutdown(ssc) stops the stream (draining it) before EndFeed
        time.sleep(2 * STREAM_POLL_S)
        ts = time.monotonic()
        tfc.shutdown(ssc)
        shutdown_s = time.monotonic() - ts
        wall = time.monotonic() - t0
        # after shutdown: the executor runs one task at a time, and a
        # probe (which imports torch there, seconds) queued between two
        # micro-batches' feed tasks would hold the later files back
        probe = sc.parallelize([0], 1).mapPartitions(cuda_probe).collect()
    finally:
        sc.stop()
    alive = [p.pid for p in sc._procs if p.poll() is None]
    check(not alive, "executors alive after sc.stop(): {}".format(alive))
    with open(out) as f:
        got = json.load(f)
    spooled = sorted(os.listdir(spool))
    shutil.rmtree(work, ignore_errors=True)
    check(spooled == ["part-%05d" % i for i in range(STREAM_FILES)],
          "the spool holds {}".format(spooled))
    check(got["device"] == "cuda:0" or device == "cpu",
          "the streaming trainer ran on {}".format(got["device"]))
    check(got["steps"] == TRAIN_STEPS and len(got["losses"]) == TRAIN_STEPS,
          "the streaming trainer took {} steps, not {}".format(
              got["steps"], TRAIN_STEPS))
    check(got["digests"] == [row_digest(r) for r in rows],
          "the streamed records were not each consumed once, in order")
    for i, c in enumerate(got["flash_launches"]):
        check(all(c[k] == LAYERS * (i + 1) for k in c),
              "streaming step {}: flash launches {} are not {} per kernel "
              "per step".format(i + 1, c, LAYERS))
    want = phase5["losses"]
    rel = [abs(g - w) / abs(w) for g, w in zip(got["losses"], want)]
    check(max(rel) <= STEP_LOSS_RTOL,
          "streaming-fed losses differ from phase 5's (worst rel {:.2e})"
          .format(max(rel)))
    check(probe and probe[0]["cuda_initialized"] is False,
          "the executor holds a CUDA context: {}".format(probe))
    check(probe[0]["foreign"] == [], "the executor imported {}".format(
        probe[0]["foreign"]))
    per_file = TRAIN_STEPS // STREAM_FILES
    pulled = got["pulled_wall"]
    lags = [pulled[i * per_file] - landed[i] for i in range(STREAM_FILES)]
    steady = (STREAM_FILES - 1) * STREAM_FILE_RECORDS
    steady_s = pulled[-1] - landed[1]
    p50 = float(np.median(got["step_s"]))
    marks = got["startup_marks"]
    log("streaming losses: " + " ".join("{:.4f}".format(x)
                                        for x in got["losses"]))
    log("streaming vs phase 5 losses: worst rel {:.2e} (tol {:.0e})".format(
        max(rel), STEP_LOSS_RTOL))
    log("streaming lag from a file landing to its first batch: {} s (file "
        "0 waits for the trainer's start-up: {})".format(
            " ".join("{:.3f}".format(x) for x in lags), ", ".join(
                "{} {:.3f}s".format(name, t - marks[i][1])
                for i, (name, t) in enumerate(marks[1:]))))
    log("streaming records/s: {:.1f} over files 1-{} ({} records from the "
        "second landing to the last batch, {:.3f}s); {:.1f} over the run "
        "({} records, {:.3f}s from the first landing to shutdown's end, "
        "start-up included); shutdown(ssc) {:.3f}s".format(
            steady / steady_s, STREAM_FILES - 1, steady, steady_s,
            len(rows) / wall, len(rows), wall, shutdown_s))
    log("streaming-fed step p50 {:.4f}s vs phase 5 {:.4f}s (ratio {:.3f})"
        .format(p50, phase5["p50_s"], p50 / phase5["p50_s"]))
    return {"losses": got["losses"], "loss_rel_worst": max(rel),
            "lags_s": lags, "records_per_s_steady": steady / steady_s,
            "records_per_s_run": len(rows) / wall, "wall_s": wall,
            "shutdown_s": shutdown_s, "p50_s": p50,
            "phase5_p50_s": phase5["p50_s"], "step_s": got["step_s"],
            "startup_marks": marks, "probe": probe[0],
            "flash_launches": got["flash_launches"][-1]}


def bert_example_leg(here, parent):
    """9(b): ``python -m ...examples.bert.bert_squad_spark --full_size``
    through ``cluster.run(InputMode.SPARK)``, one executor; every check
    reads the chief's ``train_stats.json``."""
    import shutil
    import subprocess
    import tempfile

    work = tempfile.mkdtemp(prefix=".tfos-bert-", dir=parent)
    model_dir = os.path.join(work, "model")
    steps = EXAMPLE_BERT_EXAMPLES // EXAMPLE_BERT_BATCH
    cmd = [sys.executable, "-m",
           "tensorflowonspark_tpu_torch.examples.bert.bert_squad_spark",
           "--cluster_size", "1", "--full_size", "--dropout", "0",
           "--batch_size", str(EXAMPLE_BERT_BATCH),
           "--num_examples", str(EXAMPLE_BERT_EXAMPLES),
           "--lr", str(EXAMPLE_BERT_LR), "--model_dir", model_dir]
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.monotonic()
    res = subprocess.run(cmd, cwd=work, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.monotonic() - t0
    check(res.returncode == 0, "bert_squad_spark --full_size failed:\n"
          + res.stdout[-2000:] + res.stderr[-3000:])
    with open(os.path.join(model_dir, "train_stats.json")) as f:
        got = json.load(f)
    shutil.rmtree(work, ignore_errors=True)
    losses = got["losses"]
    check(got["steps"] == steps and len(losses) == steps,
          "the BERT example took {} steps, not {}".format(got["steps"],
                                                         steps))
    check(got["device"] == "cuda:0", "the BERT example trained on {}".format(
        got["device"]))
    check(got["config"] == {"hidden": 768, "layers": EXAMPLE_BERT_LAYERS,
                            "heads": 12, "dtype": "torch.bfloat16",
                            "dropout_rate": 0.0, "seq": 64},
          "the BERT example's config is {}".format(got["config"]))
    check(all(np.isfinite(losses)) and np.mean(losses[-3:]) < losses[0],
          "the BERT example's loss did not fall: {}".format(losses))
    for i, c in enumerate(got["flash_launches"]):
        check(all(c[k] == EXAMPLE_BERT_LAYERS * (i + 1) for k in c),
              "BERT example step {}: flash launches {} are not {} per "
              "kernel per step".format(i + 1, c, EXAMPLE_BERT_LAYERS))
    p50 = float(np.median(got["step_s"]))
    log("BERT example losses: " + " ".join("{:.4f}".format(x)
                                          for x in losses))
    log("BERT example (bert_squad_spark --full_size, S 64, batch {}, one "
        "executor): sequences/s {:.1f} (train_loop), step p50 {:.4f}s "
        "({:.1f} sequences/s); trainer start-up {:.3f}s; command wall "
        "{:.1f}s; flash launches per kernel {}".format(
            EXAMPLE_BERT_BATCH, got["examples_per_sec"], p50,
            EXAMPLE_BERT_BATCH / p50, got["startup_s"], wall,
            got["flash_launches"][-1]))
    return {"losses": losses, "sequences_per_s": got["examples_per_sec"],
            "p50_s": p50, "startup_s": got["startup_s"], "wall_s": wall,
            "step_s": got["step_s"],
            "flash_launches": got["flash_launches"][-1]}


def parallel_leg(torch, dev, parent):
    """9(c): ``parallel_runner.run(sc, parallel_job, args, 2)``: two jobs
    share the card; the same two forwards in this process."""
    from tensorflowonspark_tpu_torch import parallel_runner
    from tensorflowonspark_tpu_torch.engine import Context
    from tensorflowonspark_tpu_torch.models import inception

    import tempfile

    work = tempfile.mkdtemp(prefix=".tfos-parallel-", dir=parent)
    args = {"device": str(dev), "seed": SEED}
    t0 = time.monotonic()
    sc = Context(num_executors=PARALLEL_JOBS, work_root=work)
    try:
        results = parallel_runner.run(sc, parallel_job, args, PARALLEL_JOBS)
        probe = sc.parallelize(list(range(PARALLEL_JOBS)),
                               PARALLEL_JOBS).mapPartitions(
                                   cuda_probe).collect()
    finally:
        sc.stop()
    wall = time.monotonic() - t0
    import shutil
    shutil.rmtree(work, ignore_errors=True)
    results = sorted(results, key=lambda r: r["index"])
    check([r["index"] for r in results] == list(range(PARALLEL_JOBS)),
          "parallel_runner returned jobs {}".format(
              [r["index"] for r in results]))
    pids = {r["pid"] for r in results}
    check(len(pids) == PARALLEL_JOBS and os.getpid() not in pids,
          "the jobs did not run in processes of their own: {}".format(pids))
    check(all(r["device"].startswith("cuda") for r in results),
          "a job ran on {}".format([r["device"] for r in results]))
    check(all(p["cuda_initialized"] is False for p in probe),
          "an executor holds a CUDA context: {}".format(probe))
    model = inception_model(torch, inception, dev, SEED)
    worst, bitwise = 0.0, True
    for r in results:
        with torch.inference_mode():
            want = model(inception_batch(torch, dev, SEED, r["index"]))
        want = want.float().cpu().numpy()
        got = np.asarray(r["logits"])
        check(got.shape == want.shape and np.isfinite(got).all(),
              "job {} logits: shape {} or not finite".format(r["index"],
                                                            got.shape))
        bitwise = bitwise and np.array_equal(got, want)
        top = np.abs(want).max()
        err = np.abs(got - want).max() / top
        worst = max(worst, err)
        check(err <= PREDICT_RTOL, "job {} logits differ from this "
              "process's by {:.2e} of the largest (tol {:.2e})".format(
                  r["index"], err, PREDICT_RTOL))
        srt = np.sort(want, axis=1)
        clear = (srt[:, -1] - srt[:, -2]) > PREDICT_RTOL * top
        check((got.argmax(1) == want.argmax(1))[clear].all(),
              "job {}: top-1 differs where the top-2 gap is clear".format(
                  r["index"]))
    del model
    log("parallel_runner: {} Inception-v3 jobs ({} px, batch {}) on one "
        "card, pids {}: wall {} s, start-up {} s; run() {:.2f}s; logits "
        "vs this process worst {:.2e} of the largest (tol {:.2e}), "
        "bitwise {}".format(
            PARALLEL_JOBS, INCEPTION_IMAGE, INCEPTION_BATCH, sorted(pids),
            " ".join("{:.2f}".format(r["wall_s"]) for r in results),
            " ".join("{:.2f}".format(r["startup_s"]) for r in results),
            wall, worst, PREDICT_RTOL, bitwise))
    return {"wall_s": [r["wall_s"] for r in results],
            "startup_s": [r["startup_s"] for r in results],
            "run_s": wall, "rel_err": worst, "bitwise": bitwise,
            "pids": sorted(pids)}


def examples_phase(torch, dev, phase5, here):
    """Phase 9: the streaming-fed trainer, the BERT example through the
    cluster and two TFParallel jobs; returns every number of the
    phase."""
    t0 = time.monotonic()
    res = {"streaming": streaming_leg(None if dev.type == "cuda" else "cpu",
                                      phase5, here)}
    gc.collect()
    torch.cuda.empty_cache()
    res["bert_example"] = bert_example_leg(here, here)
    res["parallel"] = parallel_leg(torch, dev, here)
    log("spark_adapter: no leg on the card (no pyspark on this machine); "
        "tests/test_torch_spark_adapter.py holds it on the CPU")
    res["wall_s"] = time.monotonic() - t0
    log("examples phase wall {:.1f}s".format(res["wall_s"]))
    return res


# -- phase 10: parallelism on the card ----------------------------------

#: 10(a): the ring op at GPT-2-small's attention width, a 4-way ring run
#: in lockstep on the one card: B 1, global S 8192, 12 heads of 64
RING_P, RING_B, RING_S = 4, 1, 8192
RING_BLOCK = 128
#: (name, causal, layout) of each schedule
RING_SCHEDULES = (("contiguous_causal", True, "contiguous"),
                  ("zigzag_causal", True, "zigzag"),
                  ("non_causal", False, "contiguous"))
#: 10(b): the long-context example at its defaults in both layouts, then
#: at the length it exists for
LONG_DEFAULT_LAYERS = 2
LONG_SEQ, LONG_STEPS = 32768, 10
#: the ring calls 10(b) makes, held before it runs: train_long's width
#: (batch 2, hidden 64 over 2 heads of 32, float32, blocks of 128), as
#: (P, global S, layout), all causal — its one-rank calls at both
#: lengths, and a 4-way ring at the default length (local 512, zigzag
#: half 256)
LONG_B, LONG_HEADS, LONG_HEAD_DIM, LONG_DEFAULT_SEQ = 2, 2, 32, 2048
LONG_RING_CASES = ((1, LONG_DEFAULT_SEQ, "contiguous"),
                   (1, LONG_DEFAULT_SEQ, "zigzag"),
                   (4, LONG_DEFAULT_SEQ, "contiguous"),
                   (4, LONG_DEFAULT_SEQ, "zigzag"),
                   (1, LONG_SEQ, "zigzag"))
#: 10(c): MoE at GPT-2-small's MLP width, and a one-stage pipeline
MOE_HIDDEN, MOE_FFN, MOE_EXPERTS, MOE_TOKENS = 768, 3072, 8, 4096
PIPE_MICRO, PIPE_MB = 8, 512
#: float32 products (TF32 off) in another grouping: the dense dispatch
#: runs every expert over every token in one batched product where the
#: reference runs each expert over its own tokens; both sum the same
#: 768 / 3072 products per output, in another order (~1e-6 relative)
MOE_RTOL = 1e-4


def ring_live_pairs(p, causal, layout):
    """The (q block, kv block) pairs a P-way ring launches the flash
    kernels on (a masked pair launches nothing), summed over the ranks:
    contiguous causal sum_r (r + 1) = P(P+1)/2; non-causal P^2; zigzag
    sum_r [(r + 1) + P + (P - r)] = P(2P+1) half-length pairs. Each has
    one forward launch and, in the backward, one dQ and one dK/dV."""
    if layout == "zigzag":
        return p * (2 * p + 1)
    return p * (p + 1) // 2 if causal else p * p


def ring_partials(p, layout):
    """The most partials one query row merges (and one key block's
    gradient sums): P, or 2P under zigzag (rank 0's late half merges its
    P fully visible early halves and its P late ones)."""
    return 2 * p if layout == "zigzag" else p


def ring_error(torch, name, got, want, dtype, pv, calls, partials):
    """``(max |got - want|, worst error/limit)`` of a ring output against
    a reference, over the entries where ``want`` is finite, against
    ``calls`` flash calls' errors: 1 against the plain ring, 2 against
    the full-sequence call (which adds its own). ``out``: the merge is a
    convex combination (weights exp(lse_i - lse) that sum to 1), so a
    merged row's error is a weighted mean of its partials' errors, each
    within the phase-3b limit (``flash_error``): float32 as there;
    bfloat16 2^-7 (sum_i w_i |o_i| + pv) <= 2^-7 2 pv, since |o_i| <=
    pv_i and sum_i w_i pv_i = pv (``pv`` = sum_j p_j |v_j| of the full
    row), plus the merged float32 row's rounding to bfloat16 on each
    side, one ulp apart at most (2^-7 |out|). dq, dk, dv: autograd sums
    the per-pair gradients, so a row or key carries up to ``partials``
    calls' errors (``partials + 1`` against the full call), at the
    phase-3b limit; bfloat16 adds one term, since autograd sums them in
    bfloat16: each side rounds up to ``partials - 1`` partial sums, each
    by half an ulp (2^-8 relative) of a sum of the gradient's magnitude,
    2^-7 of max |want| a partial counting both sides (float32 sums them
    in float32)."""
    fin = torch.isfinite(want)
    g, w = got.float()[fin], want.float()[fin]
    diff = (g - w).abs()
    top = w.abs().max().item()
    if name == "out":
        times = calls
    else:
        times = partials + calls - 1
    if dtype != "bfloat16":
        limit = torch.full_like(w, FLASH_F32_RTOL * max(1.0, top))
    elif name == "out":
        limit = BF16_RTOL * (w.abs() + 2 * pv.float()[fin])
    else:
        limit = BF16_RTOL * w.abs() + (BF16_FLOOR + BF16_RTOL) * top
    over = torch.where(diff > 0, diff / (times * limit),
                       torch.zeros_like(diff))
    return diff.max().item(), over.max().item()


def ring_run(torch, ra, inputs, p, causal, layout, impl, block=RING_BLOCK):
    """One P-way lockstep ring over the GLOBAL q, k, v (permuted into
    and out of the zigzag layout around it): out, dq, dk, dv in global
    order."""
    q, k, v, dout = inputs
    q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    args = (q, k, v)
    if layout == "zigzag":
        args = tuple(ra.to_zigzag(x, p) for x in args)
    out = ra._ring_lockstep(*args, p, causal=causal, block_q=block,
                            block_k=block, layout=layout, impl=impl)
    if layout == "zigzag":
        out = ra.from_zigzag(out, p)
    torch.autograd.backward(out, dout)
    return out.detach(), q.grad, k.grad, v.grad


def full_run(torch, fa, inputs, causal, block=RING_BLOCK):
    q, k, v, dout = inputs
    q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(q, k, v, causal=causal, block_q=block,
                             block_k=block)
    torch.autograd.backward(out, dout)
    return out.detach(), q.grad, k.grad, v.grad


def sdpa_run(torch, inputs, causal):
    """``scaled_dot_product_attention`` over the full sequence and its
    autograd backward on ``inputs`` (q, k, v, dO as ``[B, S, N, D]``)."""
    import torch.nn.functional as F

    q, k, v, dout = (x.detach().transpose(1, 2) for x in inputs)
    q, k, v = (x.contiguous().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    torch.autograd.backward(out, dout)
    return out.detach(), q.grad, k.grad, v.grad


def ring_check(torch, fa, ra, inputs, p, causal, layout, label,
               block=RING_BLOCK):
    """One P-way lockstep ring on the kernel route held against the same
    ring on the plain route and one full-sequence flash call
    (``ring_error``), each kernel's launches against the schedule's live
    pairs exactly. Returns (launches, errors, worst error/limit)."""
    dtype = str(inputs[0].dtype).split(".")[-1]
    before = dict(fa.launches)
    got = ring_run(torch, ra, inputs, p, causal, layout, None, block)
    torch.cuda.synchronize()
    counts = {kk: fa.launches[kk] - before[kk] for kk in before}
    want_n = ring_live_pairs(p, causal, layout)
    check(counts == {"fwd": want_n, "dq": want_n, "dkv": want_n},
          "ring {}: launches {} are not {} of each kernel".format(
              label, counts, want_n))
    before = dict(fa.launches)
    plain = ring_run(torch, ra, inputs, p, causal, layout, "plain", block)
    full = full_run(torch, fa, inputs, causal, block)
    torch.cuda.synchronize()
    check({kk: fa.launches[kk] - before[kk] for kk in before}
          == {"fwd": 1, "dq": 1, "dkv": 1},
          "the plain ring launched a kernel, or the full call did not "
          "launch each once")
    pv = None
    if dtype == "bfloat16":
        q, k, v, _ = inputs
        pv = fa._reference_lse(q, k, v.abs(), causal,
                               q.shape[-1] ** -0.5)[0]
    partials = ring_partials(p, layout)
    errs = {}
    for ref_name, ref, calls in (("plain_ring", plain, 1),
                                 ("full_flash", full, 2)):
        for name, g, w in zip(("out", "dq", "dk", "dv"), got, ref):
            check(bool(torch.isfinite(g).all()),
                  "ring {}: {} not finite".format(label, name))
            errs[ref_name + "/" + name] = ring_error(
                torch, name, g, w, dtype, pv, calls, partials)
    worst = max(e[1] for e in errs.values())
    log("ring {:<26} vs plain ring / full flash: ".format(label) + "  ".join(
        "{} {:.2e} ({:.2g})".format(kk, e[0], e[1])
        for kk, e in errs.items())
        + "  (|error| (error/limit); out x1 / x2, grads x{} / x{})".format(
            partials, partials + 1))
    check(worst <= 1.0, "ring {} disagrees with its references".format(
        label))
    return counts, errs, worst


def graph_step_ms(torch, fn, reps=5):
    """The card's milliseconds per call of ``fn`` (a forward and its
    autograd backward) with no host work between kernels: the whole
    call captured in one CUDA graph after two warm-up calls on a side
    stream (PyTorch's whole-network capture), then replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def ring_leg(torch, fa, ra, dev):
    """10(a): every schedule in float32 (TF32 off) and bfloat16 through
    the kernel route, held against the full-sequence flash call and the
    same lockstep ring on the plain route; exact launch counts; the
    times of each beside one full-sequence call, eager (host work
    included) and as device time (``graph_step_ms``)."""
    from tensorflowonspark_tpu_torch.profile_flash import eager_ms

    rng = np.random.RandomState(SEED + 100)
    n, d = HEADS, HIDDEN // HEADS
    res = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        inputs = [torch.from_numpy(rng.randn(RING_B, RING_S, n, d)
                                   .astype("float32")).to(dev, dt)
                  for _ in range(4)]
        for sched, causal, layout in RING_SCHEDULES:
            counts, errs, worst = ring_check(
                torch, fa, ra, inputs, RING_P, causal, layout,
                "{} {}".format(sched, dtype))

            def ring_fwd(_c=causal, _l=layout):
                args = inputs[:3]
                if _l == "zigzag":
                    args = [ra.to_zigzag(x, RING_P) for x in args]
                with torch.no_grad():
                    return ra._ring_lockstep(*args, RING_P, causal=_c,
                                             block_q=RING_BLOCK,
                                             block_k=RING_BLOCK, layout=_l)

            def ring_step(_c=causal, _l=layout):
                ring_run(torch, ra, inputs, RING_P, _c, _l, None)

            def full_step(_c=causal):
                full_run(torch, fa, inputs, _c)

            def sdpa_step(_c=causal):
                sdpa_run(torch, inputs, _c)

            # the least time for the ring's work: every schedule attends
            # the full call's (query, key) pairs (causal: key <= query),
            # at 2 flops a multiply-add of the forward's 2, dQ's 3 and
            # dK/dV's 4 products, at the dtype's tensor-core rate
            # (float32: 3xTF32); the bytes (q, k, v, dO in, out, dq, dk,
            # dv out) take ~0.1 ms and do not bound it
            pairs = RING_B * n * (RING_S * (RING_S + 1) // 2 if causal
                                  else RING_S * RING_S)
            rate = BF16_FLOPS if dtype == "bfloat16" else TF32X3_FLOPS
            t = {"launches": counts,
                 "partials": ring_partials(RING_P, layout),
                 "errors": {kk: e[0] for kk, e in errs.items()},
                 "error_over_limit": worst,
                 "bound_ms": 18 * pairs * d / rate * 1e3,
                 "bound_by": "operations"}
            t["fwd_ms"], t["fwd_host_ms"] = eager_ms(torch, ring_fwd, 5)
            t["step_ms"], t["step_host_ms"] = eager_ms(torch, ring_step, 3)
            t["step_device_ms"] = graph_step_ms(torch, ring_step)
            t["full_step_ms"], _ = eager_ms(torch, full_step, 3)
            t["full_step_device_ms"] = graph_step_ms(torch, full_step)
            # the library yardstick (timed here only): one SDPA call over
            # the full sequence and its autograd backward
            t["sdpa_step_ms"], _ = eager_ms(torch, sdpa_step, 3)
            t["sdpa_step_device_ms"] = graph_step_ms(torch, sdpa_step)
            log("ring {:<17} {:<8} fwd+bwd {:.3f} ms eager [{:.3f} ms "
                "device time], host {:.3f} ms; fwd {:.3f} ms; one "
                "full-sequence flash call fwd+bwd {:.3f} ms [{:.3f}]; one "
                "full-sequence SDPA call fwd+bwd {:.3f} ms [{:.3f}]; bound "
                "{:.3f} ms (operations; {:.1f}% of the ring's device "
                "time)".format(
                    sched, dtype, t["step_ms"], t["step_device_ms"],
                    t["step_host_ms"], t["fwd_ms"], t["full_step_ms"],
                    t["full_step_device_ms"], t["sdpa_step_ms"],
                    t["sdpa_step_device_ms"], t["bound_ms"],
                    100.0 * t["bound_ms"] / t["step_device_ms"]))
            res["{}/{}".format(dtype, sched)] = t
        del inputs
        gc.collect()
        torch.cuda.empty_cache()
    return res


def long_ring_leg(torch, fa, ra, dev):
    """10(b) first: the flash kernels at the long-context example's
    width (head dim 32, float32) through the ring calls it makes, each
    held as 10(a)'s are (``ring_check``); returns the errors by case."""
    rng = np.random.RandomState(SEED + 102)
    res = {}
    for p, s, layout in LONG_RING_CASES:
        inputs = [torch.from_numpy(rng.randn(
            LONG_B, s, LONG_HEADS, LONG_HEAD_DIM).astype("float32")).to(dev)
            for _ in range(4)]
        label = "P{} S{} {} D{} float32".format(p, s, layout, LONG_HEAD_DIM)
        counts, errs, worst = ring_check(torch, fa, ra, inputs, p, True,
                                         layout, label)
        res[label] = {"launches": counts, "error_over_limit": worst,
                      "errors": {kk: e[0] for kk, e in errs.items()}}
        del inputs
    gc.collect()
    torch.cuda.empty_cache()
    return res


def long_leg(here, parent):
    """10(b): ``python -m ...examples.longcontext.train_long`` at its
    defaults in both layouts, then ``--seq_len 32768 --layout zigzag
    --steps 10``: one rank, a one-rank NCCL group it starts and ends;
    every check reads its last line."""
    import subprocess

    runs = {}
    for name, extra, per_layer in (
            ("contiguous", [], 1), ("zigzag", ["--layout", "zigzag"], 3),
            ("zigzag_32k", ["--layout", "zigzag", "--seq_len",
                            str(LONG_SEQ), "--steps", str(LONG_STEPS)], 3)):
        cmd = [sys.executable, "-m",
               "tensorflowonspark_tpu_torch.examples.longcontext.train_long"
               ] + extra
        env = dict(os.environ, PYTHONPATH=here + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t0 = time.monotonic()
        out = subprocess.run(cmd, cwd=parent, env=env, capture_output=True,
                             text=True, timeout=600)
        wall = time.monotonic() - t0
        check(out.returncode == 0, "train_long {} failed:\n{}".format(
            name, out.stdout[-2000:] + out.stderr[-3000:]))
        got = json.loads(out.stdout.strip().splitlines()[-1])
        losses = got["losses"]
        want = per_layer * LONG_DEFAULT_LAYERS
        check(got["device"].startswith("cuda") and got["ranks"] == 1,
              "train_long {} ran on {} over {} ranks".format(
                  name, got["device"], got["ranks"]))
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              "train_long {}: the loss did not fall: {}".format(name,
                                                                losses))
        check(bool(got["peak_bytes"]), "train_long {} reported no peak "
              "memory".format(name))
        check(got["flash_launches_per_step"] == {
            "fwd": want, "dq": want, "dkv": want},
            "train_long {}: flash launches a step {} are not {} of each"
            .format(name, got["flash_launches_per_step"], want))
        log("longcontext {:<10} S {} batch {}: loss {:.4f} -> {:.4f}; step "
            "p50 {:.4f}s, {:.0f} tokens/s, peak {:.1f} MiB; flash launches "
            "a step {}; command wall {:.1f}s".format(
                name, got["seq_len"], got["batch"], losses[0], losses[-1],
                got["step_p50_s"], got["tokens_per_s"],
                (got["peak_bytes"] or 0) / 2 ** 20, want, wall))
        runs[name] = dict(got, wall_s=wall)
    return runs


def moe_pipeline_leg(torch, dev):
    """10(c): moe_ffn and pipeline_apply on one-rank meshes (a one-rank
    NCCL group), each against its plain counterpart: each token through
    its routed expert alone, and the stage applied microbatch by
    microbatch; outputs and gradients."""
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.parallel import build_mesh, moe, pipeline

    rng = np.random.RandomState(SEED + 101)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            "float32")).to(dev).requires_grad_()

    h, f, e = MOE_HIDDEN, MOE_FFN, MOE_EXPERTS
    x, router = t(MOE_TOKENS, h), t(h, e, scale=0.5)
    w_in, w_out = t(e, h, f, scale=(2.0 / h) ** 0.5), \
        t(e, f, h, scale=(2.0 / f) ** 0.5)
    tgt = torch.from_numpy(rng.randn(MOE_TOKENS, h).astype("float32")).to(dev)
    mesh = build_mesh({"expert": 1}, device=dev)
    t0 = time.monotonic()
    y, aux = moe.moe_ffn(x, router, w_in, w_out, mesh)
    loss = F.mse_loss(y, tgt) + 0.01 * aux
    grads = torch.autograd.grad(loss, (x, router, w_in, w_out))
    torch.cuda.synchronize()
    moe_s = time.monotonic() - t0
    # the plain counterpart: each token through its routed expert only
    one_hot, gate, aux_ref = moe.top1_gating(x @ router)
    idx = one_hot.argmax(dim=-1)
    y_ref = torch.zeros_like(x)
    for j in range(e):
        rows = (idx == j).nonzero()[:, 0]
        hj = F.gelu(x[rows] @ w_in[j], approximate="tanh") @ w_out[j]
        y_ref = y_ref.index_put((rows,), hj * gate[rows, None])
    loss_ref = F.mse_loss(y_ref, tgt) + 0.01 * aux_ref
    grads_ref = torch.autograd.grad(loss_ref, (x, router, w_in, w_out))
    errs = {"y": ((y - y_ref).abs().max() / y_ref.abs().max()).item(),
            "aux": abs(aux.item() - aux_ref.item())}
    for name, g, w in zip(("dx", "drouter", "dw_in", "dw_out"), grads,
                          grads_ref):
        errs[name] = ((g - w).abs().max() / w.abs().max()).item()
    log("moe_ffn {} tokens x {} -> {} x {} experts (one rank): {:.3f}s "
        "fwd+bwd; max |dense - per-expert| / max: {}".format(
            MOE_TOKENS, h, f, e, moe_s, "  ".join(
                "{} {:.2e}".format(k, v) for k, v in errs.items())))
    check(all(v <= MOE_RTOL for v in errs.values()) and aux.item() > 0,
          "moe_ffn disagrees with the per-expert reference: {}".format(errs))
    # one pipeline stage: tanh(x W + b) over PIPE_MICRO microbatches
    smesh = build_mesh({"stage": 1}, device=dev)
    w, b = t(h, h, scale=h ** -0.5), t(h, scale=0.1)
    xs = torch.from_numpy(rng.randn(PIPE_MICRO, PIPE_MB, h).astype(
        "float32")).to(dev)

    def stage(p, z):
        return torch.tanh(z @ p[0] + p[1])

    out = pipeline.pipeline_apply(stage, (w, b), xs, smesh)
    g_pp = torch.autograd.grad(out.square().mean(), (w, b))
    ref = torch.stack([stage((w, b), xs[m]) for m in range(PIPE_MICRO)])
    g_ref = torch.autograd.grad(ref.square().mean(), (w, b))
    pipe_err = {"out": (out - ref).abs().max().item()}
    for name, g, r in zip(("dw", "db"), g_pp, g_ref):
        pipe_err[name] = ((g - r).abs().max() / r.abs().max()).item()
    log("pipeline_apply one stage, {} microbatches of {} x {}: |pipeline - "
        "per-microbatch| out {:.2e} (bitwise: {}), dw {:.2e}, db {:.2e} "
        "(relative)".format(PIPE_MICRO, PIPE_MB, h, pipe_err["out"],
                            bool(torch.equal(out, ref)), pipe_err["dw"],
                            pipe_err["db"]))
    check(torch.equal(out, ref) and pipe_err["dw"] <= MOE_RTOL
          and pipe_err["db"] <= MOE_RTOL,
          "pipeline_apply disagrees with the stage applied per "
          "microbatch: {}".format(pipe_err))
    return {"moe": dict(errs, seconds=moe_s), "pipeline": pipe_err}


def criteo_leg(here, parent):
    """10(d): ``criteo_spark --cluster_size 1 --tp 1`` at the config's
    defaults through the cluster with ``--quantize_export``, then one
    ``:predict`` round trip to ``ModelServer(export)``."""
    import shutil
    import subprocess
    import tempfile

    from tensorflowonspark_tpu_torch import serving
    from tensorflowonspark_tpu_torch.examples.criteo import criteo_spark

    work = tempfile.mkdtemp(prefix=".tfos-criteo-", dir=parent)
    model_dir = os.path.join(work, "model")
    export_dir = os.path.join(work, "wd_int8")
    cmd = [sys.executable, "-m",
           "tensorflowonspark_tpu_torch.examples.criteo.criteo_spark",
           "--cluster_size", "1", "--tp", "1", "--model_dir", model_dir,
           "--quantize_export", export_dir]
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.monotonic()
    res = subprocess.run(cmd, cwd=work, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.monotonic() - t0
    check(res.returncode == 0, "criteo_spark failed:\n"
          + res.stdout[-2000:] + res.stderr[-3000:])
    with open(os.path.join(model_dir, "train_stats.json")) as f:
        got = json.load(f)
    check(got["steps"] > 0 and got["device"] == "cuda:0",
          "criteo_spark took {} steps on {}".format(got["steps"],
                                                    got["device"]))
    dense, cat, _ = criteo_spark.etl(criteo_spark.synthetic_criteo_lines(
        1, seed=SEED)[0])
    row = {"dense": dense.tolist(), "cat": cat.tolist()}
    with serving.ModelServer(export_dir, name="wd", port=0) as srv:
        conn = http.client.HTTPConnection("127.0.0.1", srv.address[1],
                                          timeout=120)
        t1 = time.monotonic()
        conn.request("POST", "/v1/models/wd:predict",
                     body=json.dumps({"instances": [row]}))
        resp = conn.getresponse()
        body = json.loads(resp.read())
        predict_s = time.monotonic() - t1
        conn.close()
    preds = body.get("predictions")
    check(resp.status == 200 and isinstance(preds, list) and len(preds) == 1
          and isinstance(preds[0], float) and np.isfinite(preds[0]),
          "the int8 Wide & Deep :predict returned {} {}".format(
              resp.status, body))
    shutil.rmtree(work, ignore_errors=True)
    log("criteo_spark (cluster_size 1, tp 1, defaults): {} steps, {:.1f} "
        "examples/s, table {} rows on {}; int8 export :predict -> {:.4f} in "
        "{:.3f}s; command wall {:.1f}s".format(
            got["steps"], got["examples_per_sec"], got["table_rows"],
            got["device"], preds[0], predict_s, wall))
    return {"steps": got["steps"], "examples_per_sec":
            got["examples_per_sec"], "predict": preds[0],
            "predict_s": predict_s, "wall_s": wall}


def parallel_phase(torch, dev, here):
    """Phase 10: the ring op 4-way in lockstep, the long-context example,
    MoE and the pipeline at one rank, the Criteo example through the
    cluster; returns every number of the phase."""
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.parallel import ring_attention as ra

    t0 = time.monotonic()
    res = {"ring": ring_leg(torch, fa, ra, dev)}
    res["longcontext_ring"] = long_ring_leg(torch, fa, ra, dev)
    res["longcontext"] = long_leg(here, here)
    res["moe_pipeline"] = moe_pipeline_leg(torch, dev)
    if dist.is_initialized():
        dist.destroy_process_group()  # the one-rank group of 10(c)
    gc.collect()
    torch.cuda.empty_cache()
    res["criteo"] = criteo_leg(here, here)
    res["wall_s"] = time.monotonic() - t0
    log("parallel phase wall {:.1f}s".format(res["wall_s"]))
    return res


# -- phase 11: generation -------------------------------------------------


#: the speculative window: the draft proposes this many tokens a round,
#: and the verify is one paged call of this many queries a row
SPEC_K = 4
#: (a)'s depths: 8 slots from mid-sequence cursors, one window short of
#: a block boundary, on it and just past it, deep, and a row whose window
#: overshoots the table
VERIFY_DEPTHS = np.array([SPEC_K, BLOCK, BLOCK + 1, 2 * BLOCK + SPEC_K - 1,
                          100, 333, 640, MAX_LEN - 1])
#: (b): the first requests of phase 4's traffic through solo generate and
#: the contiguous engine
CONTIGUOUS_REQUESTS = 4
#: (d): the requests prefilled on one server and decoded on another
DISAGG_REQUESTS = 4
#: (c): the requests of the int8 and the whole-target speculative legs
#: (the float 6-layer leg serves all 16)
SPEC_SHORT_REQUESTS = 8
#: (c): acceptance when the draft is the whole target (a tie can reject)
FULL_DRAFT_ACCEPTANCE = 0.95


def verify_window_leg(torch, pa, dev):
    """11(a): the paged kernel at the verify window — 8 slots, S_q =
    ``SPEC_K`` from mid-sequence cursors, float and int8 pools, the
    window route — held as
    phase 3's cases are (``hold_case``), then timed (``paged_timing``:
    eager and device, the plain version, SDPA over the pre-gathered
    view, the bound). Returns (largest |difference|, times by dtype)."""
    rng = np.random.RandomState(SEED + 110)
    worst = 0.0
    d = HIDDEN // HEADS
    for quant in (False, True):
        args, scales = make_case(torch, rng, SLOTS, SPEC_K, MAX_LEN // BLOCK,
                                 quant, dev, depths=VERIFY_DEPTHS.copy(),
                                 overshoot_row=SLOTS - 1, scratch_row=0)
        route, err = hold_case(torch, pa, dev, args, scales, SPEC_K, d,
                               quant)
        check(route == "window", "the verify window took the {} route"
              .format(route))
        worst = max(worst, err)
    depths = np.random.RandomState(SEED + 111).randint(
        SPEC_K + 32, 641, size=SLOTS)
    times = {}
    for quant in (False, True):
        t = times["int8" if quant else "float32"] = paged_timing(
            torch, pa, dev, quant, SPEC_K, depths, 6)
        check(t["route"] == "window", "the timed verify window took the "
              "{} route".format(t["route"]))
        log("verify window int8={!s:<5} 8 slots S_q {} {} kernel {:.4f} ms "
            "per eager call ({:.4f} ms device time)  plain {:.4f} ms  sdpa "
            "{:.4f} ms ({:.4f} ms device time)  bound {:.4f} ms ({}; "
            "{:.1f}% of device time, {:.1f}% of eager; {} live tokens); "
            "device time {:.3f} x SDPA's; one kernel a call "
            "(paged_window_kernel, its merge folded in)"
            .format(quant, SPEC_K, t["route"], t["ms"], t["device_ms"],
                    t["plain_ms"], t["library_ms"], t["library_device_ms"],
                    t["bound_ms"], t["bound_by"],
                    100.0 * t["bound_ms"] / t["device_ms"],
                    100.0 * t["bound_ms"] / t["ms"], t["live_tokens"],
                    t["device_ms"] / t["library_device_ms"]))
    return worst, times


def counter_algebra(counts, k, label):
    """The speculative counters' documented contract."""
    rounds = counts.get("spec_rounds", 0)
    proposed = counts.get("spec_proposed", 0)
    accepted = counts.get("spec_accepted", 0)
    check(0 < rounds <= proposed <= k * rounds,
          "{}: rounds {} <= proposed {} <= {} x rounds fails".format(
              label, rounds, proposed, k))
    check(0 <= accepted <= proposed, "{}: accepted {} > proposed {}".format(
        label, accepted, proposed))
    check(counts.get("decode_tokens", 0) <= k * rounds,
          "{}: more tokens than rounds can emit".format(label))
    return accepted / proposed


def contiguous_leg(torch, generation, serving, model, reqs, want, dev):
    """11(b): the first requests through solo ``generate`` (one at a
    time, the prompt fed token by token into a contiguous cache) and a
    ``kv_block_size=0`` engine; both must give the paged engine's tokens
    ``want`` but at a tie."""
    t0 = time.monotonic()
    solo = [generation.generate(model, [p], n, device=dev)[0].tolist()
            for p, n in reqs]
    solo_s = time.monotonic() - t0
    with serving.DecodeEngine(model, slots=SLOTS, total_len=MAX_LEN,
                              kv_block_size=0, device=dev) as engine:
        check(engine.load_stats()["attn_impl"] == "contiguous",
              "kv_block_size=0 did not select the contiguous cache")
        t0 = time.monotonic()
        served = [h.result(600) for h in
                  [engine.submit(p, n) for p, n in reqs]]
        engine_s = time.monotonic() - t0
        counts = engine.counters.snapshot()["counts"]
    ties = {"solo": compare_tokens(torch, generation, model, solo, want,
                                   reqs, None, dev),
            "engine": compare_tokens(torch, generation, model, served, want,
                                     reqs, None, dev)}
    log("contiguous: solo generate {:.2f}s, kv_block_size=0 engine {:.2f}s "
        "({} decode steps); equal to the paged engine on {}/{} and {}/{} "
        "requests (the rest at a tie)".format(
            solo_s, engine_s, counts.get("decode_steps", 0),
            len(reqs) - ties["solo"], len(reqs),
            len(reqs) - ties["engine"], len(reqs)))
    return {"solo_s": solo_s, "engine_s": engine_s, "ties": ties,
            "decode_steps": counts.get("decode_steps", 0)}


def speculative_leg(torch, pa, generation, serving, model, reqs, runs, dev):
    """11(c): phase 4's requests over HTTP through ``speculate_k``
    engines — a 6-layer draft at float and int8 KV, and the whole target
    as its own draft, where every proposal stands but after a tie (the
    last two on the first ``SPEC_SHORT_REQUESTS`` requests). Each run:
    tokens equal the plain engine's of phase 4 (same KV dtype) but at a
    tie, the counter algebra, and the routes' launches exactly by the
    round arithmetic (the draft's ``SPEC_K`` one-token steps on the split
    route, the verify on the window route, every prefill, target and
    draft, by its query count)."""
    res = {}
    total = 0
    everything = reqs
    for draft_layers, kv in ((LAYERS // 2, None), (LAYERS // 2, "int8"),
                             (LAYERS, None)):
        label = "draft {} kv {}".format(draft_layers, kv or "float32")
        reqs = everything if (draft_layers, kv) == (LAYERS // 2, None) \
            else everything[:SPEC_SHORT_REQUESTS]
        engine = serving.DecodeEngine(
            model, slots=SLOTS, total_len=MAX_LEN, kv_block_size=BLOCK,
            kv_dtype=kv, speculate_k=SPEC_K, draft_layers=draft_layers,
            device=dev)
        with engine:
            launches = pa.launches
            zero_launches(pa)
            out, wall = serve_over_http(serving, engine, reqs)
            routes = dict(pa.route_launches)
            calls = PREFILLS.calls()
            total += pa.launches - launches
            counts = engine.counters.snapshot()["counts"]
            load = engine.load_stats()
            ttft = engine.histograms["ttft"].quantile(0.5)
            spec_ms = engine.measure_spec()
        rounds, prefills = counts["decode_steps"], counts["prefills"]
        # each round: the draft's SPEC_K one-token steps (split), the
        # target's SPEC_K-query verify (window); each prefill: the
        # target's and the draft's, by their query counts
        want = want_routes(pa, draft_layers * SPEC_K * rounds, 2 * prefills,
                           LAYERS * rounds, calls)
        check(routes == want,
              "{}: paged launches by route {} are not {} ({} rounds, {} "
              "prefills)".format(label, routes, want, rounds, prefills))
        check(routes["window"] > 0, "{}: the verify windows never "
              "launched the window kernel".format(label))
        rate = counter_algebra(counts, SPEC_K, label)
        check(load["spec_acceptance_rate"] == round(rate, 4),
              "{}: load_stats' acceptance rate is not accepted/proposed"
              .format(label))
        ties = compare_tokens(torch, generation, model, out,
                              runs[kv]["out"][:len(reqs)], reqs, kv, dev)
        if draft_layers == LAYERS:
            check(rate >= FULL_DRAFT_ACCEPTANCE,
                  "{}: the whole target as its draft accepted {:.4f} < {}"
                  .format(label, rate, FULL_DRAFT_ACCEPTANCE))
        gen = sum(n for _, n in reqs)
        per_round = counts["decode_tokens"] / counts["spec_rounds"]
        res[label] = {
            "draft_layers": draft_layers, "kv_dtype": kv or "float32",
            "tokens_per_s": gen / wall, "wall_s": wall, "ttft_p50_s": ttft,
            "acceptance": rate, "tokens_per_round": per_round,
            "rounds": rounds, "prefills": prefills, "routes": routes,
            "ties": ties, "measure_spec_ms": spec_ms,
            "counts": {k: counts.get(k, 0) for k in (
                "spec_rounds", "spec_proposed", "spec_accepted",
                "decode_tokens", "prefix_hit_blocks")}}
        log("speculative {:<22} tokens/s={:.1f} wall={:.2f}s ttft_p50={:.4f}s "
            "acceptance={:.4f} tokens/slot-round={:.3f} rounds={} "
            "prefills={}; measure_spec draft {:.3f} ms verify {:.3f} ms; "
            "routes {}; equal to the plain engine on {}/{} ({} at a tie)"
            .format(label, gen / wall, wall, ttft, rate, per_round, rounds,
                    prefills, spec_ms["draft"], spec_ms["verify"], routes,
                    len(reqs) - ties, len(reqs), ties))
    check(total > 0, "the speculative engines never launched the kernel")
    return total, res


def _post_json(port, path, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", path, body=json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    check(resp.status == 200, "POST {} answered {}: {}".format(
        path, resp.status, body))
    return body


def disagg_leg(torch, pa, generation, serving, model, reqs, runs, dev):
    """11(d): a ``tier="prefill"`` and a ``tier="decode"`` server in this
    process. Each request: ``:prefill`` on the first with ``ship`` at
    the second (confirmed, ``bytes`` equal to ``frames.frame_bytes`` of
    the exported buffers), then ``:generate`` on the second, whose prefix
    hits must be the shipped blocks (only the tail prefills there), with
    tokens equal to phase 4's mixed engine's but at a tie; float and
    int8 KV, int8's wire bytes under a third of float's."""
    from tensorflowonspark_tpu_torch import frames, kvship

    res = {}
    total = 0
    for kv in (None, "int8"):
        engines = {tier: serving.DecodeEngine(
            model, slots=SLOTS, total_len=MAX_LEN, kv_block_size=BLOCK,
            kv_dtype=kv, tier=tier, replica_id="smoke-" + tier, device=dev)
            for tier in ("prefill", "decode")}
        servers = {tier: serving.ModelServer(None, name="gpt2", port=0,
                                             engine=eng)
                   for tier, eng in engines.items()}
        launches = pa.launches
        try:
            for srv in servers.values():
                srv.start()
            addr = "127.0.0.1:{}".format(servers["decode"].address[1])
            p_port = servers["prefill"].address[1]
            d_port = servers["decode"].address[1]
            out, ships = [], []
            t0 = time.monotonic()
            for prompt, n in reqs:
                shipped = _post_json(p_port, "/v1/models/gpt2:prefill", {
                    "prompt": prompt,
                    "ship": {"addr": addr, "replica_id": "smoke-decode"}})
                check(shipped.get("shipped") is True,
                      "a shipment did not land: {}".format(shipped))
                buffers, _ = engines["prefill"].export_prefix(prompt)
                check(shipped["bytes"] == frames.frame_bytes(buffers),
                      "shipped bytes {} are not the buffers' {}".format(
                          shipped["bytes"], frames.frame_bytes(buffers)))
                hits = engines["decode"].counters.get("prefix_hit_blocks")
                body = _post_json(d_port, "/v1/models/gpt2:generate",
                                  {"prompt": prompt, "max_new_tokens": n})
                hits = engines["decode"].counters.get(
                    "prefix_hit_blocks") - hits
                want_hits = min(shipped["blocks"], (len(prompt) - 1) // BLOCK)
                check(hits == want_hits,
                      "the decode server hit {} prefix blocks, not the {} "
                      "shipped".format(hits, want_hits))
                out.append(body["tokens"])
                ships.append(shipped)
            wall = time.monotonic() - t0
            stats = {tier: eng.load_stats() for tier, eng in engines.items()}
            ship_ms = engines["prefill"].histograms["kv_ship_ms"]
            ship_ms = {"p50": ship_ms.quantile(0.5),
                       "max": ship_ms.quantile(1.0)}
        finally:
            for srv in servers.values():
                srv.stop()
            for eng in engines.values():
                eng.stop()
            kvship.close_rings()
        total += pa.launches - launches
        ties = compare_tokens(torch, generation, model, out,
                              runs[kv]["out"][:len(reqs)], reqs, kv, dev)
        wire = sum(s["bytes"] for s in ships)
        blocks = sum(s["blocks"] for s in ships)
        label = kv or "float32"
        check(stats["prefill"]["tier"] == "prefill"
              and stats["decode"]["tier"] == "decode",
              "load_stats does not carry the tiers")
        check(stats["prefill"]["kv_ship_bytes"] == wire,
              "the prefill engine accounted {} shipped bytes, not {}".format(
                  stats["prefill"]["kv_ship_bytes"], wire))
        res[label] = {
            "wire_bytes": wire, "blocks": blocks,
            "spliced_blocks": stats["decode"]["kv_spliced_blocks"],
            "transport": sorted({s["transport"] for s in ships}),
            "ship_ms": ship_ms,
            "wall_s": wall, "ties": ties}
        log("disaggregated kv={:<7} {} requests: {} blocks shipped over {} "
            "({} spliced, the rest resident), {:.3f} MB on the wire, ship "
            "ms p50 {:.2f} max {:.2f}; wall {:.2f}s; equal to the mixed "
            "engine on {}/{} ({} at a tie)".format(
                label, len(reqs), blocks, "/".join(res[label]["transport"]),
                res[label]["spliced_blocks"], wire / 1e6, ship_ms["p50"],
                ship_ms["max"], wall, len(reqs) - ties,
                len(reqs), ties))
    check(res["int8"]["wire_bytes"] * 3 < res["float32"]["wire_bytes"],
          "int8 wire bytes {} are not under a third of float's {}".format(
              res["int8"]["wire_bytes"], res["float32"]["wire_bytes"]))
    log("disaggregated int8 / float32 wire bytes: {:.4f}".format(
        res["int8"]["wire_bytes"] / res["float32"]["wire_bytes"]))
    return total, res


def generate_example_leg(here, parent):
    """11(e): ``python -m ...examples.generate.lm_generate --serve 8`` on
    the card: the loss falls, and every served output equals solo
    ``generate``."""
    import subprocess

    cmd = [sys.executable, "-m",
           "tensorflowonspark_tpu_torch.examples.generate.lm_generate",
           "--serve", "8"]
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.monotonic()
    out = subprocess.run(cmd, cwd=parent, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.monotonic() - t0
    check(out.returncode == 0, "lm_generate failed:\n{}".format(
        out.stdout[-2000:] + out.stderr[-3000:]))
    got = json.loads(out.stdout.strip().splitlines()[-1])
    check(got["device"].startswith("cuda"),
          "lm_generate ran on {}".format(got["device"]))
    check(got["loss"] < got["loss_first"],
          "lm_generate's loss did not fall: {} -> {}".format(
              got["loss_first"], got["loss"]))
    check(got["serve"]["solo_mismatches"] == 0,
          "lm_generate: served outputs differ from solo generate")
    log("lm_generate --serve 8: loss {:.4f} -> {:.4f}, served {} requests "
        "{:.1f} tokens/s, solo_mismatches 0; command wall {:.1f}s".format(
            got["loss_first"], got["loss"], got["serve"]["requests"],
            got["serve"]["tokens_per_sec"], wall))
    return dict(got, wall_s=wall)


def generation_phase(torch, pa, dev, runs, here):
    """Phase 11: (a) the kernel at the verify window; (b) the contiguous
    cache; (c) speculative serving; (d) disaggregated prefill and decode;
    (e) the generate example. Phase 4's model from the same seed, its
    requests and its plain engines' tokens (``runs``)."""
    from tensorflowonspark_tpu_torch import generation, serving
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

    t_phase = time.monotonic()
    verify_err, verify_t = verify_window_leg(torch, pa, dev)
    model = DecoderLM(VOCAB, hidden=HIDDEN, num_heads=HEADS,
                      num_layers=LAYERS, max_len=MAX_LEN, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(SEED))
    reqs = traffic()
    contiguous = contiguous_leg(
        torch, generation, serving, model, reqs[:CONTIGUOUS_REQUESTS],
        runs[None]["out"][:CONTIGUOUS_REQUESTS], dev)
    spec_launches, spec = speculative_leg(torch, pa, generation, serving,
                                          model, reqs, runs, dev)
    window_launches = sum(r["routes"]["window"] for r in spec.values())
    disagg_launches, disagg = disagg_leg(
        torch, pa, generation, serving, model, reqs[:DISAGG_REQUESTS], runs,
        dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    example = generate_example_leg(here, here)
    wall = time.monotonic() - t_phase
    log("generation phase wall {:.1f}s".format(wall))
    return {"verify_error": verify_err, "verify": verify_t,
            "contiguous": contiguous, "speculative": spec,
            "launches_spec": spec_launches,
            "launches_window": window_launches, "disagg": disagg,
            "launches_disagg": disagg_launches, "example": example,
            "wall_s": wall}


# -- phase 12: the serving planes -----------------------------------------

#: 12(a): phase 4's requests with a prompt of at most 256 tokens and at
#: least 64 new tokens (indices into ``traffic()``); at temperature 0 the
#: first 64 generated tokens of phase 4's output are the expected ones
PLANES_PROMPTS = (0, 3, 6, 8, 10, 14)
PLANES_NEW = 64
#: 12(a): the antagonist's burst and the quiet tenant's requests
ANTAGONIST_REQUESTS, QUIET_REQUESTS = 24, 4
#: 12(a): the metered tenant's rate (tokens/s) and burst (seconds): one
#: 64-token request leaves the bucket decisively in debt
METERED_RATE, METERED_BURST_S = 2.0, 1.0
#: 12(e): requests in flight when the drain starts
DRAIN_REQUESTS = 8
#: the families the reference's ``ModelServer.metrics_text`` renders for
#: this engine config (paged, fused, a qos_policy with a quota) after
#: this phase's kind of traffic — fair share, class preemption, a quota
#: refusal, a shed body, dedup joins and replays and a control-epoch
#: refusal — read off the JAX package's server on the CPU
REFERENCE_FAMILIES = (
    "tfos_control_admin_rejections", "tfos_kv_ship_ms",
    "tfos_qos_admitted", "tfos_qos_preemptions",
    "tfos_qos_queue_wait_high_seconds", "tfos_qos_queue_wait_low_seconds",
    "tfos_qos_queue_wait_normal_seconds", "tfos_qos_quota_rejections",
    "tfos_qos_tokens", "tfos_serving_attn_impl",
    "tfos_serving_decode_step_seconds", "tfos_serving_decode_steps",
    "tfos_serving_decode_tokens", "tfos_serving_dedup_hits",
    "tfos_serving_dedup_joined", "tfos_serving_drain_seconds",
    "tfos_serving_generated_prefix_registered",
    "tfos_serving_kv_blocks_cached", "tfos_serving_kv_blocks_free",
    "tfos_serving_kv_blocks_total", "tfos_serving_kv_dtype",
    "tfos_serving_preemptions", "tfos_serving_prefills",
    "tfos_serving_prefix_digest_chains",
    "tfos_serving_prefix_digest_truncated",
    "tfos_serving_prefix_hit_blocks", "tfos_serving_prefix_miss_blocks",
    "tfos_serving_queue_depth", "tfos_serving_queue_wait_seconds",
    "tfos_serving_replica_info", "tfos_serving_request_seconds",
    "tfos_serving_requests_completed", "tfos_serving_shed",
    "tfos_serving_slot_occupancy", "tfos_serving_stage_samples",
    "tfos_serving_stage_seconds", "tfos_serving_token_latency_seconds",
    "tfos_serving_tokens", "tfos_serving_ttft_seconds",
    "tfos_slo_attrib_admission_seconds", "tfos_slo_attrib_decode_seconds",
    "tfos_slo_attrib_preempted_seconds", "tfos_slo_attrib_prefill_seconds",
    "tfos_slo_attrib_queue_wait_seconds", "tfos_trace_spans_dropped")


class _Client(object):
    """Raw-HTTP ``:generate`` client of phase 12 that keeps the tallies
    ``/metrics`` must agree with: requests the engine executed and the
    tokens it generated for them (a dedup replay or join executes
    nothing new; a refused body executes nothing)."""

    def __init__(self, port):
        self.port = port
        self.executed = 0
        self.tokens = 0
        self.lock = threading.Lock()

    def post(self, payload, headers=None, path=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=600)
        conn.request("POST", path or "/v1/models/gpt2:generate",
                     body=json.dumps(payload),
                     headers=dict({"Content-Type": "application/json"},
                                  **(headers or {})))
        resp = conn.getresponse()
        body = json.loads(resp.read())
        hdrs = dict(resp.getheaders())
        conn.close()
        return resp.status, hdrs, body

    def generate(self, payload, headers=None, executes=True):
        status, hdrs, body = self.post(payload, headers)
        if status == 200 and executes:
            prompts = payload["prompt"]
            n = len(prompts) if isinstance(prompts[0], list) else 1
            with self.lock:
                self.executed += n
                self.tokens += n * payload["max_new_tokens"]
        return status, hdrs, body

    def get(self, path):
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=60)
        t0 = time.monotonic()
        conn.request("GET", path)
        resp = conn.getresponse()
        raw = resp.read()
        ms = (time.monotonic() - t0) * 1e3
        hdrs = dict(resp.getheaders())
        conn.close()
        return resp.status, hdrs, raw, ms


def _threaded(fn, args):
    """Run ``fn(*a)`` for every ``a`` of ``args`` in its own thread;
    returns (threads, results list filled in order)."""
    out = [None] * len(args)

    def run(i):
        try:
            out[i] = fn(*args[i])
        except Exception as e:  # noqa: BLE001 - reported by the caller
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(args))]
    for t in threads:
        t.start()
    return threads, out


def _wait_for(cond, what, timeout=120):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            fail("phase 12: timed out waiting for " + what)
        time.sleep(0.001)


def _trace_stats(doc):
    """Per request row of a Chrome trace: admission (queue span end),
    first token (first prefill span end), the request span, and the
    engine's decode-step span ends."""
    rows = {}
    steps = []
    for e in doc["traceEvents"]:
        if e.get("ph") != "X":
            continue
        if e["tid"] == 0:
            if e["name"] == "decode_step":
                steps.append(e["ts"] + e["dur"])
            continue
        row = rows.setdefault(e["tid"], {})
        end = e["ts"] + e["dur"]
        if e["name"] == "queue":
            row["admitted"] = end
        elif e["name"] == "prefill":
            row.setdefault("first_token", end)
        elif e["name"] == "request":
            row["request"] = e
    return rows, sorted(steps)


def _expected(runs, reqs, i, n_new):
    """Phase 4's float output of request ``i`` cut to ``n_new`` tokens."""
    prompt = reqs[i][0]
    return runs[None]["out"][i][:len(prompt) + n_new]


def planes_phase(torch, pa, dev, runs, decode_timing):
    """Phase 12: the serving planes on phase 4's model, over HTTP to the
    port's ``ModelServer``: (a) fair share, class preemption and the
    quota; (b) deadline shedding; (c) ``/metrics``, ``/debug/trace``, SLO
    attribution and the probes; (d) dedup and fencing; (e) drain and
    respawn; (f) the serving chaos sites. Tokens equal phase 4's float
    engine's (``runs``) but at a top-2 tie below 1e-4."""
    from tensorflowonspark_tpu_torch import chaos, generation, serving, slo
    from tensorflowonspark_tpu_torch import tracing
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

    t_phase = time.monotonic()
    model = DecoderLM(VOCAB, hidden=HIDDEN, num_heads=HEADS,
                      num_layers=LAYERS, max_len=MAX_LEN, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(SEED))
    reqs = traffic()
    res = {}
    policy = {"weights": {"antagonist": 1.0, "quiet": 1.0},
              "quotas": {"metered": METERED_RATE},
              "burst_s": METERED_BURST_S}
    flight = tracing.FlightRecorder(capacity=1 << 16)
    # THE path of this phase: counts at zero just before, read just after
    zero_launches(pa)
    engine = serving.DecodeEngine(model, slots=SLOTS, total_len=MAX_LEN,
                                  kv_block_size=BLOCK, qos_policy=policy,
                                  replica_id="planes-0", flight=flight,
                                  device=dev)
    srv = serving.ModelServer(None, name="gpt2", port=0, engine=engine)
    client = _Client(srv.start()[1])
    served = []  # (request index, output) for the token check
    trace_ids = {}  # trace id -> (tenant, request index)

    def gen(i, tenant, priority=None, n_new=PLANES_NEW, extra=None):
        # pid-salted ids: no clash with the engine's local ones
        tid = tracing.mint_trace_id()
        trace_ids[tid] = (tenant, i)
        payload = {"prompt": reqs[i][0], "max_new_tokens": n_new,
                   "tenant": tenant}
        if priority:
            payload["priority"] = priority
        payload.update(extra or {})
        status, hdrs, body = client.generate(
            payload, headers={"X-TFOS-Trace": str(tid)})
        if status == 200:
            served.append((i, n_new, body["tokens"]))
        return status, hdrs, body, tid

    # (a) fair share: the antagonist's burst, then the quiet tenant
    t0 = time.monotonic()
    idx = [PLANES_PROMPTS[k % len(PLANES_PROMPTS)]
           for k in range(ANTAGONIST_REQUESTS + QUIET_REQUESTS)]
    ant_threads, ant = _threaded(
        gen, [(i, "antagonist") for i in idx[:ANTAGONIST_REQUESTS]])
    _wait_for(lambda: engine.outstanding() + engine.counters.get(
        "requests_completed") >= ANTAGONIST_REQUESTS, "the burst")
    quiet_threads, quiet = _threaded(
        gen, [(i, "quiet") for i in idx[ANTAGONIST_REQUESTS:]])
    for t in ant_threads + quiet_threads:
        t.join()
    burst_wall = time.monotonic() - t0
    check(all(r[0] == 200 for r in ant + quiet),
          "12(a) fair-share requests failed: {}".format(
              [r for r in ant + quiet if r[0] != 200][:2]))
    rows, _ = _trace_stats(flight.chrome_trace())
    by_tenant = {}
    for tid, (tenant, _) in trace_ids.items():
        row = rows.get(tid)
        check(row is not None and "admitted" in row,
              "12(a) no trace row for request {}".format(tid))
        by_tenant.setdefault(tenant, []).append(row)
    last_ant = max(r["admitted"] for r in by_tenant["antagonist"])
    quiet_admitted = sorted(r["admitted"] for r in by_tenant["quiet"])
    check(all(t < last_ant for t in quiet_admitted),
          "12(a) a quiet request waited out the antagonist's backlog")
    ttft = {tenant: float(np.median(
        [(r["first_token"] - r["request"]["ts"]) / 1e3 for r in rows_]))
        for tenant, rows_ in by_tenant.items()}
    gen_tokens = (ANTAGONIST_REQUESTS + QUIET_REQUESTS) * PLANES_NEW
    res["fair_share"] = {"ttft_p50_ms": ttft, "wall_s": burst_wall,
                         "tokens_per_s": gen_tokens / burst_wall,
                         "quiet_admitted_before_last_antagonist": True}
    log("planes 12(a) fair share: TTFT p50 antagonist {:.1f} ms, quiet "
        "{:.1f} ms; {:.1f} tokens/s over {} requests ({:.2f}s)".format(
            ttft["antagonist"], ttft["quiet"], gen_tokens / burst_wall,
            ANTAGONIST_REQUESTS + QUIET_REQUESTS, burst_wall))

    # (a) class preemption: eight low slots, then one high arrival
    chaos.arm("stall_decode_for=1.0")
    low_threads, low = _threaded(
        gen, [(PLANES_PROMPTS[k % len(PLANES_PROMPTS)], "batch", "low")
              for k in range(SLOTS)])
    _wait_for(lambda: engine.load_stats()["slot_occupancy"] == SLOTS,
              "eight low slots")
    preempt0 = engine.counters.get("preemptions")
    status, _, _, hi_tid = gen(PLANES_PROMPTS[0], "vip", "high", n_new=16)
    check(status == 200, "12(a) the high request failed")
    for t in low_threads:
        t.join()
    check(all(r[0] == 200 for r in low), "12(a) low requests failed")
    doc = flight.chrome_trace()
    rows, steps = _trace_stats(doc)
    hi = rows[hi_tid]
    admit_ts = [e["ts"] for e in doc["traceEvents"]
                if e.get("ph") == "i" and e["name"] == "admit"
                and e["tid"] == hi_tid][0]
    boundaries = sum(1 for s in steps if admit_ts <= s <= hi["admitted"])
    tallies = engine.qos_tallies()
    check(engine.counters.get("preemptions") > preempt0
          and ("batch", "low") in tallies["preemptions"],
          "12(a) the high arrival preempted no low slot")
    check(boundaries <= 2, "12(a) the high request waited {} step "
          "boundaries".format(boundaries))
    res["preemption"] = {"boundaries": boundaries, "preemptions": {
        "/".join(k): v for k, v in tallies["preemptions"].items()}}
    log("planes 12(a) class preemption: high admitted after {} step "
        "boundaries; preemptions {}".format(boundaries,
                                            tallies["preemptions"]))

    # (a) quota: post-paid, so the first metered request runs into debt
    status = gen(PLANES_PROMPTS[1], "metered")[0]
    check(status == 200, "12(a) the metered request failed")
    prefills0 = engine.counters.get("prefills")
    status, hdrs, body, _ = gen(PLANES_PROMPTS[1], "metered", n_new=4)
    check(status == 429 and body.get("kind") == "QuotaExceeded"
          and int(hdrs.get("Retry-After", "0")) >= 1,
          "12(a) an indebted tenant was not refused 429 + Retry-After: "
          "{} {}".format(status, body))
    check(engine.counters.get("prefills") == prefills0
          and engine.load_stats()["queue_depth"] == 0,
          "12(a) the refused request was queued")
    res["quota"] = {"status": status, "retry_after": hdrs["Retry-After"]}

    # (b) shed: a body of two whose deadline is below its own estimate
    shed0 = engine.counters.get("shed")
    depth0 = engine.load_stats()["queue_depth"]
    pair = [reqs[i][0] for i in PLANES_PROMPTS[:2]]
    est = engine.estimate_admission(PLANES_NEW, prompt=pair[0])
    deadline = 0.5 * (est["queue_wait_s"] + est["service_s"])
    status, hdrs, body = client.generate(
        {"prompt": pair, "max_new_tokens": PLANES_NEW,
         "deadline_s": deadline})
    shed = engine.counters.get("shed") - shed0
    check(status == 503 and body.get("kind") == "Shed"
          and "Retry-After" in hdrs,
          "12(b) an infeasible body was not shed: {} {}".format(
              status, body))
    check(shed == 2 and engine.load_stats()["queue_depth"] == depth0,
          "12(b) shed counted {} (want 2) or the queue moved".format(shed))
    status, _, body = client.generate(
        {"prompt": pair, "max_new_tokens": PLANES_NEW, "deadline_s": 120.0})
    check(status == 200, "12(b) a feasible deadline failed")
    served.extend((i, PLANES_NEW, out)
                  for i, out in zip(PLANES_PROMPTS[:2], body["tokens"]))
    res["shed"] = {"shed": shed, "deadline_s": deadline, "estimate": est}
    log("planes 12(b) shed: {} requests refused 503 at deadline {:.4f}s "
        "(estimate: queue {:.4f}s + service {:.4f}s); a 120 s deadline "
        "served".format(shed, deadline, est["queue_wait_s"],
                        est["service_s"]))

    # (d) dedup and fencing
    payload = {"prompt": reqs[PLANES_PROMPTS[2]][0],
               "max_new_tokens": PLANES_NEW}
    rid = {"X-TFOS-Request-Id": "planes-dedup-1"}
    chaos.arm("stall_decode_for=0.5")
    prefills0 = engine.counters.get("prefills")
    dup_threads, dup = _threaded(client.post, [(payload, rid),
                                               (payload, rid)])
    for t in dup_threads:
        t.join()
    client.executed += 1
    client.tokens += PLANES_NEW
    third = client.post(payload, rid)
    check(all(r[0] == 200 for r in dup) and third[0] == 200
          and dup[0][2] == dup[1][2] == third[2],
          "12(d) dedup answers differ or failed")
    check(engine.counters.get("prefills") == prefills0 + 1
          and engine.counters.get("dedup_joined") == 1
          and engine.counters.get("dedup_hits") == 1,
          "12(d) dedup: prefills +{}, joined {}, hits {}".format(
              engine.counters.get("prefills") - prefills0,
              engine.counters.get("dedup_joined"),
              engine.counters.get("dedup_hits")))
    served.append((PLANES_PROMPTS[2], PLANES_NEW, third[2]["tokens"]))
    srv.fence("superseded by a newer lease epoch")
    fenced = client.post(payload)
    srv.unfence()
    unfenced = client.generate({"prompt": reqs[PLANES_PROMPTS[3]][0],
                                "max_new_tokens": 8})
    served.append((PLANES_PROMPTS[3], 8, unfenced[2]["tokens"]))
    fence_set = client.post({"control_epoch": 5},
                            path="/admin/control_fence")
    stale = client.post({"replica_id": "p", "min_epoch": 1},
                        headers={"X-TFOS-Control-Epoch": "4"},
                        path="/admin/ship_fence")
    check(fenced[0] == 410 and fenced[2].get("kind") == "Fenced"
          and unfenced[0] == 200 and fence_set[0] == 200
          and stale[0] == 409 and stale[2].get("kind") == "ControlFenced",
          "12(d) fencing codes {} {} {} {}".format(
              fenced[0], unfenced[0], fence_set[0], stale[0]))
    res["dedup_fencing"] = {"joined": 1, "hits": 1, "fenced": fenced[0],
                            "unfenced": unfenced[0],
                            "control_fenced": stale[0]}
    log("planes 12(d) dedup: two concurrent sends, one generation (joined "
        "1), a replay (hits 1), identical bodies; fence 410, unfence 200, "
        "control epoch 4 < 5: 409")

    # (c) observability
    status, hdrs, raw, scrape_ms = client.get("/metrics")
    check(status == 200 and hdrs.get("Content-Type")
          == serving.OPENMETRICS_CONTENT_TYPE, "12(c) /metrics answered "
          "{} {}".format(status, hdrs.get("Content-Type")))
    text = raw.decode()
    types, values = {}, {}
    for line in text.splitlines():
        if line == "# EOF":
            continue
        if line.startswith("# TYPE "):
            _, _, fam, kind = line.split()
            types[fam] = kind
            continue
        if line.startswith(("# HELP ", "# UNIT ")):
            continue
        check(line and not line.startswith("#"),
              "12(c) malformed exposition line {!r}".format(line))
        sample = line.split(" # ")[0]
        name, value = sample.rsplit(" ", 1)
        values[name] = float(value)
    check(text.endswith("# EOF\n"), "12(c) /metrics does not end in # EOF")
    missing = sorted(set(REFERENCE_FAMILIES) - set(types))
    check(not missing, "12(c) /metrics lacks the reference's families "
          "{}".format(missing))
    check(values.get("tfos_serving_requests_completed_total")
          == client.executed
          and values.get("tfos_serving_tokens_total") == client.tokens,
          "12(c) /metrics counts {} requests, {} tokens; the clients "
          "{} and {}".format(
              values.get("tfos_serving_requests_completed_total"),
              values.get("tfos_serving_tokens_total"), client.executed,
              client.tokens))
    status, hdrs, raw, trace_ms = client.get("/debug/trace")
    doc = json.loads(raw)
    check(status == 200 and "X-TFOS-Trace-Dropped" in hdrs,
          "12(c) /debug/trace answered {}".format(status))
    rows, _ = _trace_stats(doc)
    finished = [r["request"] for r in rows.values() if "request" in r
                and r["request"]["args"]["outcome"] == "finish"]
    check(len(finished) == client.executed,
          "12(c) {} request spans for {} served requests".format(
              len(finished), client.executed))
    worst = 0.0
    for span in finished:
        report = slo.attribute_trace(doc, span["tid"])
        stages = sum(report["stages"].values())
        wall = span["dur"] / 1e6
        worst = max(worst, abs(stages - wall) / wall)
    check(worst <= 0.01, "12(c) attribution is {:.2%} off a request's "
          "wall".format(worst))
    hist_sum = sum(engine.metrics.get_histogram(
        "tfos_slo_attrib_{}_seconds".format(s)).snapshot()["sum"]
        for s in serving._ATTRIB_STAGES)
    req_sum = engine.metrics.get_histogram(
        "tfos_serving_request_seconds").snapshot()["sum"]
    check(abs(hist_sum - req_sum) <= 0.01 * req_sum,
          "12(c) attribution histograms sum {:.4f}s, requests {:.4f}s"
          .format(hist_sum, req_sum))
    before = dict(pa.route_launches)
    attn_ms = engine.measure_attn(reps=5)
    moved = {r: pa.route_launches[r] - before[r] for r in before}
    check(moved == {"split": 6, "window": 0, "tiled": 0},
          "12(c) measure_attn(reps=5) launched {} (want 5 timed calls "
          "and one warm-up on the split route)".format(moved))
    with serving.DecodeEngine(model, slots=SLOTS, total_len=MAX_LEN,
                              kv_block_size=BLOCK, kv_dtype="int8",
                              device=dev) as q8:
        dequant_ms = q8.measure_dequant(reps=3)
        pools = sum(t.numel() * t.element_size() for layer in q8._cache
                    for t in layer.values())
        check(dequant_ms is not None and dequant_ms > 0
              and q8.kv_cache_bytes() == pools,
              "12(c) int8 probes: dequant {} ms, kv_cache_bytes {} vs "
              "pools {}".format(dequant_ms, q8.kv_cache_bytes(), pools))
        q8_bytes = q8.kv_cache_bytes()
    check(engine.kv_cache_bytes() == sum(
        t.numel() * t.element_size() for layer in engine._cache
        for t in layer.values()), "12(c) kv_cache_bytes != the pools")
    res["observability"] = {
        "scrape_ms": scrape_ms, "scrape_bytes": len(text.encode()),
        "trace_ms": trace_ms, "families": len(types),
        "attribution_worst_rel": worst, "measure_attn_ms": attn_ms,
        "phase3_decode_ms": decode_timing["ms"],
        "phase3_decode_device_ms": decode_timing["device_ms"],
        "measure_dequant_ms": dequant_ms,
        "kv_cache_bytes": engine.kv_cache_bytes(),
        "kv_cache_bytes_int8": q8_bytes}
    log("planes 12(c) /metrics {} families, {} bytes in {:.2f} ms; "
        "/debug/trace {:.2f} ms, {} request spans; attribution within "
        "{:.4%} of each wall; measure_attn {:.4f} ms a call (phase 3's "
        "decode shape {:.4f} ms eager, {:.4f} ms device); measure_dequant "
        "(int8) {:.4f} ms; kv_cache_bytes {} (int8 {})".format(
            len(types), len(text.encode()), scrape_ms, trace_ms,
            len(finished), worst, attn_ms, decode_timing["ms"],
            decode_timing["device_ms"], dequant_ms,
            engine.kv_cache_bytes(), q8_bytes))

    # every token so far against phase 4's float engine
    ties = compare_tokens(
        torch, generation, model, [out for _, _, out in served],
        [_expected(runs, reqs, i, n) for i, n, _ in served],
        [(reqs[i][0], n) for i, n, _ in served], None, dev)
    res["tokens"] = {"requests": len(served), "ties": ties}
    log("planes tokens equal phase 4's on {}/{} requests ({} at a tie)"
        .format(len(served) - ties, len(served), ties))

    # (e) drain with eight in flight, then respawn
    drain_idx = [PLANES_PROMPTS[k % len(PLANES_PROMPTS)]
                 for k in range(DRAIN_REQUESTS)]
    chaos.arm("stall_decode_for=0.5")
    done0 = engine.counters.get("requests_completed")
    drain_threads, drained = _threaded(
        lambda i: client.generate({"prompt": reqs[i][0],
                                   "max_new_tokens": PLANES_NEW}),
        [(i,) for i in drain_idx])
    _wait_for(lambda: engine.outstanding() == DRAIN_REQUESTS,
              "eight requests in flight")
    t0 = time.monotonic()
    verdict = []
    drainer = threading.Thread(target=lambda: verdict.append(srv.drain()))
    drainer.start()
    _wait_for(lambda: srv._draining, "the drain latch")
    health = client.get("/healthz")
    refused = client.post({"prompt": [1, 2, 3], "max_new_tokens": 4})
    for t in drain_threads:
        t.join()
    drainer.join()
    drain_s = time.monotonic() - t0
    check(health[0] == 503 and json.loads(health[2])["status"] == "draining",
          "12(e) /healthz during the drain: {}".format(health[0]))
    check(refused[0] == 503 and refused[2].get("kind") == "Draining"
          and "Retry-After" in refused[1],
          "12(e) a new :generate during the drain got {}".format(
              refused[0]))
    check(verdict == [True] and all(r[0] == 200 for r in drained)
          and engine.counters.get("requests_completed") - done0
          == DRAIN_REQUESTS, "12(e) the drain lost requests")
    ties = compare_tokens(
        torch, generation, model, [r[2]["tokens"] for r in drained],
        [_expected(runs, reqs, i, PLANES_NEW) for i in drain_idx],
        [(reqs[i][0], PLANES_NEW) for i in drain_idx], None, dev)
    tokens0 = engine.counters.get("tokens")
    t0 = time.monotonic()
    fresh = engine.respawn()
    srv = serving.ModelServer(None, name="gpt2", port=0, engine=fresh)
    client.port = srv.start()[1]
    status, _, body = client.generate(
        {"prompt": reqs[PLANES_PROMPTS[4]][0], "max_new_tokens": 8})
    respawn_s = time.monotonic() - t0
    # a deliberate respawn is not a restart: only the supervisor's
    # RestartEngine counts engine_restarts (phase 14(a))
    check(status == 200 and fresh.counters is engine.counters
          and fresh.counters.get("tokens") == tokens0 + 8
          and fresh.counters.get("engine_restarts") == 0,
          "12(e) the respawned engine: {} tokens {} -> {}, restarts {}"
          .format(status, tokens0, fresh.counters.get("tokens"),
                  fresh.counters.get("engine_restarts")))
    res["drain"] = {"drain_s": drain_s, "respawn_s": respawn_s,
                    "ties": ties}
    log("planes 12(e) drain of {} in flight: {:.3f}s, zero loss, tokens "
        "equal phase 4's ({} at a tie); respawn to the first answer "
        "{:.3f}s, one counter series".format(DRAIN_REQUESTS, drain_s, ties,
                                             respawn_s))

    # (f) chaos: a scheduler kill, then a client disconnect
    chaos.arm("kill_scheduler_at_step=1,only=planes-0")
    status, _, body = client.generate(
        {"prompt": reqs[PLANES_PROMPTS[5]][0], "max_new_tokens": 8})
    health = client.get("/healthz")
    check(status == 503 and body.get("kind") == "EngineFailed"
          and health[0] == 503
          and json.loads(health[2])["engine"]["alive"] is False,
          "12(f) a killed scheduler answered {} / healthz {}".format(
              status, health[0]))
    fresh.stop()
    again = fresh.respawn()
    srv.attach_engine(again)
    status, _, body = client.generate(
        {"prompt": reqs[PLANES_PROMPTS[5]][0], "max_new_tokens": 8})
    check(status == 200, "12(f) the respawned engine failed")
    ties = compare_tokens(torch, generation, model, [body["tokens"]],
                          [_expected(runs, reqs, PLANES_PROMPTS[5], 8)],
                          [(reqs[PLANES_PROMPTS[5]][0], 8)], None, dev)
    cancelled0 = again.counters.get("cancelled")
    chaos.arm("disconnect_client_at_token=4")
    status, _, body = client.generate(
        {"prompt": reqs[PLANES_PROMPTS[0]][0], "max_new_tokens": 32})
    _wait_for(lambda: again.load_stats()["slot_occupancy"] == 0
              and again._pool.live_refs() == {}, "the cancelled slot")
    check(status == 499 and again.counters.get("cancelled")
          == cancelled0 + 1, "12(f) the disconnect answered {}".format(
              status))
    res["chaos"] = {"killed": 503, "respawned": 200, "disconnect": status,
                    "ties": ties}
    log("planes 12(f) chaos: scheduler kill -> 503 EngineFailed, healthz "
        "503; respawn serves; disconnect at token 4 -> 499, slot freed")
    srv.stop()
    again.stop()
    chaos.disarm()
    counts = again.counters.snapshot()["counts"]
    routes = dict(pa.route_launches)
    steps, prefills = counts["decode_steps"], counts["prefills"]
    want = want_routes(pa, LAYERS * steps + 6, prefills)
    check(routes == want, "phase 12 launches by route {} are not {} ({} "
          "steps, {} prefills, measure_attn's 6)".format(
              routes, want, steps, prefills))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    res["launches"] = routes
    res["wall_s"] = time.monotonic() - t_phase
    log("planes phase: launches {} ({} steps, {} prefills); wall {:.1f}s"
        .format(routes, steps, prefills, res["wall_s"]))
    return res


# -- phase 13: the serving fleet ----------------------------------------

#: 13(b): requests in flight while the rolling drain cycles the replicas
FLEET_DRAIN_REQUESTS = 8
#: 13(c): the replica whose scheduler dies, the decode step it dies at,
#: and the requests sent across the kill
FLEET_VICTIM, FLEET_KILL_STEP, FLEET_KILL_REQUESTS = "replica-1", 4, 8
#: 13(d): phase 4's requests without the shared prefix (no block of one
#: is resident anywhere before its own shipment), one at a time
FLEET_TIER_REQUESTS = (0, 2, 3, 4)
#: 13(e): phase 4's requests the executor-hosted replicas serve
FLEET_EXECUTOR_REQUESTS = 8
#: calls timed for the beat's host cost
BEAT_SAMPLES = 50


def _launch_check(pa, engines, leg):
    """The launches by route since the last reset must be exactly
    LAYERS x the engines' decode steps (split) and LAYERS x their
    prefills (window or tiled by query count); returns the routes."""
    counts = [e.counters.snapshot()["counts"] for e in engines]
    steps = sum(c.get("decode_steps", 0) for c in counts)
    prefills = sum(c.get("prefills", 0) for c in counts)
    routes = dict(pa.route_launches)
    want = want_routes(pa, LAYERS * steps, prefills)
    check(routes == want, "{} launches by route {} are not {} ({} "
          "steps, {} prefills summed over the replicas)".format(
              leg, routes, want, steps, prefills))
    return routes, steps, prefills


def _fleet_clients(port, reqs, idx, clients=4, name="gpt2"):
    """Send ``reqs[i]`` for ``i`` in ``idx`` through the router at
    ``port`` from ``clients`` concurrent HTTP clients; returns ({i:
    tokens}, errors, wall seconds)."""
    out, errors = {}, []
    lock = threading.Lock()

    def client(c):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        for i in idx[c::clients]:
            prompt, n_new = reqs[i]
            try:
                conn.request("POST", "/v1/models/{}:generate".format(name),
                             body=json.dumps({"prompt": prompt,
                                              "max_new_tokens": n_new}),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = json.loads(resp.read())
                if resp.status != 200:
                    raise RuntimeError("HTTP {}: {}".format(resp.status,
                                                            body))
                with lock:
                    out[i] = body["tokens"]
            except Exception as e:  # noqa: BLE001 - reported by the caller
                with lock:
                    errors.append(repr(e))
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=600)
        conn.close()

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, errors, time.monotonic() - t0


def _replica_completions(fleet_):
    """{replica: requests completed} as the router's /metrics labels
    them (the beat-carried engine snapshots)."""
    out = {}
    for line in fleet_.router.metrics_text().splitlines():
        if line.startswith("tfos_serving_requests_completed_total{"):
            label = line.split('replica="', 1)[1].split('"', 1)[0]
            out[label] = int(float(line.rsplit(" ", 1)[1]))
    return out


def _fleet_tokens(torch, generation, model, runs, reqs, got, idx, leg,
                  dev):
    """Fleet outputs must equal phase 4's float engine's but at a top-2
    tie below 1e-4; returns the ties."""
    check(sorted(got) == sorted(idx), "13({}) answered {} of {} "
          "requests".format(leg, len(got), len(idx)))
    return compare_tokens(torch, generation, model, [got[i] for i in idx],
                          [runs[None]["out"][i] for i in idx],
                          [reqs[i] for i in idx], None, dev)


def _beat_cost(replica):
    """Host ms of one beat's payload (``load_stats`` + the registry
    snapshot) and of one uncached prefix digest, p50 over BEAT_SAMPLES."""
    beat, digest = [], []
    pool = replica.engine._pool
    for _ in range(BEAT_SAMPLES):
        # a beat during traffic finds the pool changed since the last
        # one: its first digest read sorts, the second hits the memo
        pool.forget_digest()
        t0 = time.perf_counter()
        replica._payload()
        beat.append((time.perf_counter() - t0) * 1e3)
        pool.forget_digest()
        t0 = time.perf_counter()
        dig = pool.prefix_digest()
        digest.append((time.perf_counter() - t0) * 1e3)
    return {"beat_ms_p50": float(np.median(beat)),
            "digest_ms_p50": float(np.median(digest)),
            "digest_chains": len(dig["top"])}


def fleet_phase(torch, pa, dev, runs, here):
    """Phase 13: the serving fleet on phase 4's model, through the
    port's ``fleet`` and ``cluster.serving_fleet``: (a) two in-process
    replicas behind the router, phase 4's 16 requests from 4 clients;
    (b) a rolling drain with requests in flight; (c) a scheduler killed
    mid-stream, failed over; (d) the two-stage prefill -> decode tiers;
    (e) replicas hosted in executor processes; (f) the control-state
    journal across a reservation restart and a standby router's
    takeover; (g) ``lm_generate --fleet 2``. Tokens equal phase 4's
    float engine's (``runs``) but at a top-2 tie below 1e-4."""
    import shutil
    import subprocess
    import tempfile

    from tensorflowonspark_tpu_torch import (chaos, cluster, fleet,
                                             generation, kvship, serving)
    from tensorflowonspark_tpu_torch.engine import Context
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

    t_phase = time.monotonic()
    model = DecoderLM(VOCAB, hidden=HIDDEN, num_heads=HEADS,
                      num_layers=LAYERS, max_len=MAX_LEN, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(SEED))
    reqs = traffic()
    engine_kw = {"slots": SLOTS, "total_len": MAX_LEN,
                 "kv_block_size": BLOCK, "device": str(dev)}
    res = {}
    launches = {"split": 0, "window": 0, "tiled": 0}

    def add(routes):
        for k in launches:
            launches[k] += routes[k]

    # (a) two replicas behind the router: THE main path of this phase,
    # counts at zero just before, read just after
    f = fleet.ServingFleet(model, replicas=2, name="gpt2",
                           engine_kw=engine_kw, host="127.0.0.1")
    f.start()
    try:
        port = f.router_addr[1]
        check(all(r.engine.device.type == "cuda"
                  and r.engine.model is not model for r in f.replicas),
              "13(a) the replicas are not on the card with their own "
              "modules")
        zero_launches(pa)
        idx = list(range(len(reqs)))
        got, errors, wall = _fleet_clients(port, reqs, idx)
        check(not errors, "13(a) fleet requests failed: {}".format(
            errors[:2]))
        engines = [r.engine for r in f.replicas]
        routes, steps, prefills = _launch_check(pa, engines, "13(a)")
        add(routes)
        ties = _fleet_tokens(torch, generation, model, runs, reqs, got, idx,
                             "a", dev)
        deadline = time.monotonic() + 10
        while sum(_replica_completions(f).values()) < len(reqs) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        per_replica = _replica_completions(f)
        check(sorted(per_replica) == ["replica-0", "replica-1"]
              and all(n > 0 for n in per_replica.values())
              and sum(per_replica.values()) == len(reqs),
              "13(a) the router's /metrics shows completions {}".format(
                  per_replica))
        n_new = sum(n for _, n in reqs)
        counts = f.router.counters.snapshot()["counts"]
        beat = _beat_cost(f.replicas[0])
        res["a"] = {
            "tokens_per_s": n_new / wall, "wall_s": wall,
            "ttft_p50_s": {r.replica_id: r.engine.histograms["ttft"]
                           .quantile(0.5) for r in f.replicas},
            "route_overhead_p50_s": f.router._hist_overhead.quantile(0.5),
            "failovers": counts.get("failovers", 0),
            "per_replica": per_replica, "launches": routes,
            "decode_steps": steps, "prefills": prefills, "ties": ties,
            "beat": beat}
        log("fleet 13(a) 2 replicas: {:.1f} tokens/s over {} requests "
            "({:.2f}s) vs phase 4's single engine {:.1f}; TTFT p50 {} vs "
            "{:.4f}s; router overhead p50 {:.3f} ms; failovers {}; per "
            "replica {}; launches {} ({} x {} steps, {} x {} prefills); "
            "tokens equal phase 4's ({} at a tie); beat {:.3f} ms p50 "
            "(uncached digest {:.3f} ms over {} chains)".format(
                n_new / wall, len(reqs), wall, runs[None]["tokens_per_s"],
                {k: round(v, 4) for k, v in res["a"]["ttft_p50_s"].items()},
                runs[None]["ttft_p50"],
                1e3 * res["a"]["route_overhead_p50_s"], res["a"]["failovers"],
                per_replica, routes, LAYERS, steps, LAYERS, prefills, ties,
                beat["beat_ms_p50"], beat["digest_ms_p50"],
                beat["digest_chains"]))

        # (b) rolling drain with the same weights, requests in flight
        zero_launches(pa)
        before = {id(e): e.counters.snapshot()["counts"] for e in engines}
        idx = list(range(FLEET_DRAIN_REQUESTS))
        box = {}
        sender = threading.Thread(target=lambda: box.update(
            zip(("got", "errors", "wall"),
                _fleet_clients(port, reqs, idx))))
        sender.start()
        deadline = time.monotonic() + 60
        while sum(r.engine.outstanding() for r in f.replicas) < 4 \
                and time.monotonic() < deadline:
            time.sleep(0.001)

        def upgrade(old):
            return serving.DecodeEngine(
                old.model, replica_id=old.replica_id, counters=old.counters,
                timers=old.timers, metrics=old.metrics, flight=old.flight,
                **engine_kw)

        report = f.rolling_drain(upgrade=upgrade)
        sender.join()
        check(report["completed"] and report["zero_loss"]
              and not box["errors"],
              "13(b) the rolling drain lost requests: {} {}".format(
                  report, box["errors"][:2]))
        check(all(r.engine not in engines for r in f.replicas),
              "13(b) an engine was not replaced")
        after = [e.counters.snapshot()["counts"] for e in
                 [r.engine for r in f.replicas]]
        steps = sum(a.get("decode_steps", 0) - before[id(e)].get(
            "decode_steps", 0) for a, e in zip(after, engines))
        prefills = sum(a.get("prefills", 0) - before[id(e)].get(
            "prefills", 0) for a, e in zip(after, engines))
        routes = dict(pa.route_launches)
        check(routes == want_routes(pa, LAYERS * steps, prefills),
              "13(b) launches {} vs {} steps, {} prefills".format(
                  routes, steps, prefills))
        add(routes)
        ties_b = _fleet_tokens(torch, generation, model, runs, reqs,
                               box["got"], idx, "b", dev)
        res["b"] = {"drain_wall_s": [r["wall_s"] for r in report["replicas"]],
                    "requests": len(idx), "launches": routes,
                    "ties": ties_b}
        log("fleet 13(b) rolling drain with {} in flight: zero lost, walls "
            "{} s, tokens equal phase 4's ({} at a tie)".format(
                len(idx), res["b"]["drain_wall_s"], ties_b))

        # (c) one replica's scheduler dies mid-stream
        zero_launches(pa)
        engines = [r.engine for r in f.replicas]
        before = {id(e): e.counters.snapshot()["counts"] for e in engines}
        chaos.arm("kill_scheduler_at_step={},only={}".format(
            FLEET_KILL_STEP, FLEET_VICTIM))
        idx = list(range(8, 8 + FLEET_KILL_REQUESTS))
        got, errors, _ = _fleet_clients(port, reqs, idx)
        chaos.disarm()
        check(not errors, "13(c) client-visible failures: {}".format(
            errors[:2]))
        victim = f.replicas[1]
        check(victim.replica_id == FLEET_VICTIM
              and not victim.engine.healthy()["alive"],
              "13(c) the victim's scheduler is alive")
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            status, body = f.router.healthz()
            if body["replicas"][FLEET_VICTIM]["alive"] is False:
                break
            time.sleep(0.05)
        failovers = f.router.counters.snapshot()["counts"].get(
            "failovers", 0) - res["a"]["failovers"]
        check(body["replicas"][FLEET_VICTIM]["alive"] is False
              and body["routable"] == 1 and failovers >= 1,
              "13(c) healthz {} / failovers {}".format(
                  body["replicas"][FLEET_VICTIM], failovers))
        after = [e.counters.snapshot()["counts"] for e in engines]
        steps = sum(a.get("decode_steps", 0) - before[id(e)].get(
            "decode_steps", 0) for a, e in zip(after, engines))
        prefills = sum(a.get("prefills", 0) - before[id(e)].get(
            "prefills", 0) for a, e in zip(after, engines))
        routes = dict(pa.route_launches)
        check(routes == want_routes(pa, LAYERS * steps, prefills),
              "13(c) launches {} vs {} steps, {} prefills".format(
                  routes, steps, prefills))
        add(routes)
        ties_c = _fleet_tokens(torch, generation, model, runs, reqs, got,
                               idx, "c", dev)
        res["c"] = {"failovers": failovers, "requests": len(idx),
                    "launches": routes, "ties": ties_c}
        log("fleet 13(c) {} killed at step {}: {} requests, zero client "
            "failures, {} failovers, healthz shows it dead; tokens equal "
            "phase 4's ({} at a tie)".format(FLEET_VICTIM, FLEET_KILL_STEP,
                                             len(idx), failovers, ties_c))
    finally:
        chaos.disarm()
        f.stop()

    # (d) two-stage dispatch: a prefill tier and a decode tier
    zero_launches(pa)
    f = fleet.ServingFleet(model, name="gpt2",
                           tiers={"prefill": 1, "decode": 1},
                           engine_kw=engine_kw, host="127.0.0.1")
    f.start()
    try:
        pre, dec = f.replicas
        idx = list(FLEET_TIER_REQUESTS)
        got, errors, _ = _fleet_clients(f.router_addr[1], reqs, idx,
                                        clients=1)
        check(not errors, "13(d) failed: {}".format(errors[:2]))
        routes, _, _ = _launch_check(pa, [pre.engine, dec.engine],
                                     "13(d)")
        add(routes)
        counts = f.router.counters.snapshot()["counts"]
        shipped = pre.engine.kv_counters.get("ship_blocks")
        spliced = dec.engine.kv_counters.get("spliced_blocks")
        hits = dec.engine.counters.get("prefix_hit_blocks")
        want_hits = sum((len(reqs[i][0]) - 1) // BLOCK for i in idx)
        check(counts.get("prefill_ships") == len(idx)
              and shipped == spliced and hits == want_hits
              and spliced >= hits,
              "13(d) ships {}, blocks shipped {} spliced {}, decode hits "
              "{} (want {})".format(counts.get("prefill_ships"), shipped,
                                   spliced, hits, want_hits))
        ties_d = _fleet_tokens(torch, generation, model, runs, reqs, got,
                               idx, "d", dev)
        ship_ms = pre.engine.histograms["kv_ship_ms"]
        res["d"] = {"ships": len(idx), "blocks": shipped,
                    "ship_mb": pre.engine.kv_counters.get("ship_bytes")
                    / 2 ** 20,
                    "ship_ms_p50": ship_ms.quantile(0.5),
                    "decode_prefix_hit_blocks": hits, "launches": routes,
                    "ties": ties_d}
        log("fleet 13(d) prefill -> decode tiers: {} ships, {} blocks "
            "({:.2f} MB), ship p50 {:.2f} ms, decode prefix hits {} = the "
            "shipped prompt blocks; tokens equal phase 4's ({} at a tie)"
            .format(len(idx), shipped, res["d"]["ship_mb"],
                    res["d"]["ship_ms_p50"], hits, ties_d))
    finally:
        f.stop()
        kvship.close_rings()

    # (e) replicas hosted in two executor processes
    work = tempfile.mkdtemp(prefix=".tfos-fleet-", dir=here)
    t0 = time.monotonic()
    sc = Context(2, work_root=os.path.join(work, "engine"))
    pids = set()
    try:
        f = cluster.serving_fleet(model, replicas=2, name="gpt2",
                                  placement="executors", sc=sc,
                                  engine_kw=engine_kw, spawn_timeout=300)
        formation = time.monotonic() - t0
        try:
            snap = f.reservation.serving_snapshot()
            pids = {info["host"]["pid"] for info in snap.values()}
            devices = {info["serving"]["device"] for info in snap.values()}
            check(len(pids) == 2 and os.getpid() not in pids
                  and all(d.startswith("cuda") for d in devices),
                  "13(e) executor replicas: pids {} devices {}".format(
                      pids, devices))
            idx = list(range(FLEET_EXECUTOR_REQUESTS))
            got, errors, wall_e = _fleet_clients(f.router_addr[1], reqs,
                                                 idx)
            check(not errors, "13(e) failed: {}".format(errors[:2]))
            ties_e = _fleet_tokens(torch, generation, model, runs, reqs,
                                   got, idx, "e", dev)
        finally:
            f.stop()
    finally:
        sc.stop()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and any(
            os.path.exists("/proc/%d" % p) for p in pids):
        time.sleep(0.1)
    left = [p for p in pids if os.path.exists("/proc/%d" % p)]
    rings = [r for r in os.listdir("/dev/shm") if r.startswith(
        "tfos-kvship-") and r.rsplit(".", 1)[-1] in {str(p) for p in pids}] \
        if os.path.isdir("/dev/shm") else []
    check(not left and not rings, "13(e) left behind: processes {} "
          "rings {}".format(left, rings))
    shutil.rmtree(work, ignore_errors=True)
    n_new = sum(reqs[i][1] for i in idx)
    res["e"] = {"formation_s": formation, "devices": sorted(devices),
                "requests": len(idx), "wall_s": wall_e,
                "tokens_per_s": n_new / wall_e, "ties": ties_e,
                "pids_differ": True}
    log("fleet 13(e) executor-hosted: formation {:.2f}s, devices {}, {} "
        "requests {:.1f} tokens/s ({:.2f}s; the in-process fleet {:.1f}, "
        "phase 4's engine {:.1f}), tokens equal phase 4's ({} at a tie); "
        "stop leaves no process, no ring".format(
            formation, sorted(devices), len(idx), n_new / wall_e, wall_e,
            res["a"]["tokens_per_s"], runs[None]["tokens_per_s"], ties_e))

    # (f) journal across a reservation restart, then a standby takeover
    journal = os.path.join(tempfile.mkdtemp(prefix=".tfos-journal-",
                                            dir=here), "control.journal")
    f = fleet.ServingFleet(model, replicas=2, name="gpt2",
                           engine_kw=engine_kw, host="127.0.0.1",
                           journal=journal)
    f.start()
    sb = None
    try:
        epochs = {r.replica_id: r.epoch for r in f.replicas}
        control = f.control_epoch
        box = {}
        sender = threading.Thread(target=lambda: box.update(
            zip(("got", "errors", "wall"),
                _fleet_clients(f.router_addr[1], reqs, list(range(4)),
                               clients=2))))
        sender.start()
        time.sleep(0.2)
        fresh = f.restart_reservation()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and {
                k: v.get("epoch")
                for k, v in fresh.serving_snapshot().items()} != epochs:
            time.sleep(0.05)
        sender.join()
        check(not box["errors"] and {
            k: v.get("epoch") for k, v in
            fresh.serving_snapshot().items()} == epochs,
            "13(f) restart: errors {} epochs {} vs {}".format(
                box["errors"][:2], {k: v.get("epoch") for k, v in
                                    fresh.serving_snapshot().items()},
                epochs))
        _fleet_tokens(torch, generation, model, runs, reqs, box["got"],
                      list(range(4)), "f", dev)
        old_router, old_epoch = f.router, f.control_epoch
        sb = fleet.RouterStandby(f, probe_interval=0.05, confirm=2).start()
        t0 = time.monotonic()
        old_router.crash()
        check(sb.took_over.wait(30), "13(f) the standby never took over")
        takeover = time.monotonic() - t0
        got, errors, _ = _fleet_clients(f.router_addr[1], reqs, [4])
        conn = http.client.HTTPConnection(*f.replicas[0].addr, timeout=30)
        conn.request("POST", "/admin/ship_fence", body=json.dumps(
            {"replica_id": "x", "min_epoch": 1}), headers={
                "X-TFOS-Control-Epoch": str(old_epoch)})
        resp = conn.getresponse()
        refused = (resp.status, json.loads(resp.read()))
        conn.close()
        check(not errors and f.control_epoch > old_epoch > 0
              and control == old_epoch
              and fresh.mint_epoch("probe") == 1
              and refused[0] == 409
              and refused[1].get("kind") == "ControlFenced",
              "13(f) takeover: errors {}, epochs {} -> {}, old leader's "
              "write {}".format(errors[:2], old_epoch, f.control_epoch,
                                refused))
        _fleet_tokens(torch, generation, model, runs, reqs, got, [4], "f",
                      dev)
        res["f"] = {"epochs": epochs, "control_epoch": [old_epoch,
                                                        f.control_epoch],
                    "takeover_s": takeover, "old_leader_write": refused[0]}
        log("fleet 13(f) journal: reservation restarted mid-traffic, zero "
            "failures, epochs kept {}; standby took over in {:.3f}s, "
            "control epoch {} -> {}, the old leader's write refused {}"
            .format(epochs, takeover, old_epoch, f.control_epoch,
                    refused[0]))
    finally:
        if sb is not None:
            sb.stop()
        f.stop()
        shutil.rmtree(os.path.dirname(journal), ignore_errors=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # (g) the example driver through a fleet
    cmd = [sys.executable, "-m",
           "tensorflowonspark_tpu_torch.examples.generate.lm_generate",
           "--fleet", "2", "--serve", "8", "--steps", "40"]
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.monotonic()
    out = subprocess.run(cmd, cwd=here, env=env, capture_output=True,
                         text=True, timeout=600)
    check(out.returncode == 0, "lm_generate --fleet 2 failed:\n{}".format(
        out.stdout[-2000:] + out.stderr[-3000:]))
    got = json.loads(out.stdout.strip().splitlines()[-1])
    check(got["fleet"]["solo_mismatches"] == 0
          and got["serve"]["solo_mismatches"] == 0
          and all(d.startswith("cuda")
                  for d in got["fleet"]["replica_devices"]),
          "13(g) lm_generate --fleet 2: {}".format(got["fleet"]))
    res["g"] = dict(got["fleet"], wall_s=time.monotonic() - t0)
    log("fleet 13(g) lm_generate --fleet 2 --serve 8: {} requests through "
        "the fleet {:.1f} tokens/s, solo_mismatches 0; command wall {:.1f}s"
        .format(got["fleet"]["requests"], got["fleet"]["tokens_per_sec"],
                res["g"]["wall_s"]))
    res["launches"] = launches
    res["wall_s"] = time.monotonic() - t_phase
    log("fleet phase: launches {}; wall {:.1f}s".format(launches,
                                                        res["wall_s"]))
    return res


# -- phase 14: the supervised and autoscaled fleet -----------------------

#: 14(a): the replica whose scheduler dies and the decode step it dies at
SUPERVISED_VICTIM, SUPERVISED_KILL_STEP = "replica-1", 4
#: 14(a): phase 4's requests sent once the victim is readmitted
SUPERVISED_AFTER = (0, 2, 3, 4, 6, 7, 8, 10)
#: 14(a): requests sent straight to the survivor the moment the victim
#: dies (phase 4's shortest prompts, this many new tokens), so that the
#: restart window holds completions however many tokens the traffic's
#: requests in the survivor's slots still owe
WINDOW_REQUESTS, WINDOW_NEW = 2, 4
#: 14(b): requests in flight while the rolling drain cycles the replicas
SUPERVISED_DRAIN_REQUESTS = 8
#: 14(c): the burst (phase 4's 16 requests twice) and its clients
SCALE_BURST, SCALE_CLIENTS = 32, 16
#: 14(c): the policy, with cooldowns short enough for one pass (the
#: defaults are 2 s up and 20 s down)
SCALE_POLICY = {"min_replicas": 1, "max_replicas": 2,
                "queue_wait_slo_s": 0.25, "up_cooldown_s": 1.0,
                "down_cooldown_s": 3.0, "dead_after_s": 10.0}
#: 14(d): requests through the executor-hosted replica, and the request
#: of the replica's at which its executor is SIGKILLed
LOSS_REQUESTS, LOSS_KILL_AT = 8, 3


class _Series(object):
    """Every engine a fleet runs while this samples (every 10 ms): the
    counters of each (shared by a restarted or respawned engine with its
    predecessor, so each series is summed once), when each replica was
    first seen with a completed request, and a timeline of each
    replica's completions and decode steps, and of the new tokens each
    request in its slots still owes."""

    def __init__(self, fleet_):
        self.fleet = fleet_
        self.series = {}
        self.first_done = {}
        self.timeline = []
        self.owed = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self.sample()
        self._thread.start()
        return self

    def sample(self):
        row, owed = {}, {}
        for replica in list(self.fleet.replicas):
            engine = replica.engine
            if engine is None:
                continue
            self.series.setdefault(id(engine.counters), engine.counters)
            done = engine.counters.get("requests_completed")
            row[replica.replica_id] = (done,
                                       engine.counters.get("decode_steps"))
            if replica.replica_id not in self.first_done and done > 0:
                self.first_done[replica.replica_id] = time.monotonic()
            owed[replica.replica_id] = [
                h.max_new_tokens - len(h._tokens)
                for h in list(getattr(engine, "_slot_req", ()))
                if h is not None]
        now = time.time()
        self.timeline.append((now, row))
        self.owed.append((now, owed))

    def at(self, wall, rid):
        """``rid``'s (completed, decode steps) at its last sample taken
        at or before the wall-clock time ``wall``."""
        rows = [row[rid] for t, row in self.timeline
                if t <= wall and rid in row]
        return rows[-1] if rows else (0, 0)

    def owed_at(self, wall, rid):
        """The new tokens each request in ``rid``'s slots still owed at
        its last sample taken at or before ``wall`` (None: no sample)."""
        rows = [row[rid] for t, row in self.owed
                if t <= wall and rid in row]
        return rows[-1] if rows else None

    def _loop(self):
        while not self._stop.wait(0.01):
            self.sample()

    def stop(self):
        self._stop.set()
        self._thread.join()
        self.sample()

    def totals(self):
        counts = [c.snapshot()["counts"] for c in self.series.values()]
        return (sum(c.get("decode_steps", 0) for c in counts),
                sum(c.get("prefills", 0) for c in counts))


def _exact_launches(pa, series, before, leg):
    """The launches by route since the last reset must be LAYERS x the
    decode steps and LAYERS x the prefills every sampled engine made
    since ``before``; returns (routes, steps, prefills)."""
    steps, prefills = (a - b for a, b in zip(series.totals(), before))
    routes = dict(pa.route_launches)
    check(routes == want_routes(pa, LAYERS * steps, prefills),
          "{} launches by route {} vs {} steps, {} prefills over {} "
          "counter series".format(leg, routes, steps, prefills,
                                  len(series.series)))
    return routes, steps, prefills


def _restarts(fleet_):
    return [r.engine.counters.get("engine_restarts")
            for r in fleet_.replicas]


def _record_holds(router, holds):
    """Log every quiesce / readmit the router is asked for, with the
    owner and both clocks."""
    for name in ("quiesce", "readmit"):
        def call(rid, *args, _orig=getattr(router, name), _name=name,
                 **kw):
            holds.append({"name": _name, "replica": rid,
                          "owner": kw.get("owner"), "t": time.monotonic(),
                          "wall": time.time()})
            return _orig(rid, *args, **kw)
        setattr(router, name, call)


def _when_killed(fuse, stop, fn):
    """``fn()`` once the chaos fuse ``fuse`` exists (the kill fired),
    polled every 5 ms; None if ``stop`` is set first."""
    while not os.path.exists(fuse):
        if stop.wait(0.005):
            return None
    return fn()


def _healthz(addr):
    conn = http.client.HTTPConnection(addr[0], addr[1], timeout=30)
    try:
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _retrying_generate(serving, port, prompt, n_new, name="gpt2"):
    """One ``:generate`` through the router with the client retry policy
    (``serving.retry_call`` on 429/503): what 'zero client-visible
    failures' means while a replica is replaced."""
    def attempt():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            conn.request("POST", "/v1/models/{}:generate".format(name),
                         body=json.dumps({"prompt": prompt,
                                          "max_new_tokens": n_new}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
        except (OSError, http.client.HTTPException) as e:
            err = serving.Retriable("router connection: {!r}".format(e))
            err.retry_after = 0.5
            raise err
        finally:
            conn.close()
        if resp.status == 200:
            return body["tokens"]
        retriable = serving.http_retriable(resp.status,
                                           resp.getheader("Retry-After"))
        if retriable is not None:
            raise retriable
        raise RuntimeError("HTTP {}: {}".format(resp.status, body))

    return serving.retry_call(attempt, attempts=60, base_delay=0.2,
                              max_delay=2.0)


def supervised_phase(torch, pa, dev, runs, here):
    """Phase 14: the fleet's policy planes on phase 4's model: (a) a
    supervised restart of a killed scheduler, in process; (b) a rolling
    drain under the supervisor, then the successor killed and restarted;
    (c) the autoscaler's closed loop, one replica to two and back; (d)
    an executor-hosted replica's executor SIGKILLed, attributed by the
    supervisor and replaced by the autoscaler. Tokens equal phase 4's
    float engine's (``runs``) but at a top-2 tie below 1e-4."""
    import shutil
    import tempfile

    from tensorflowonspark_tpu_torch import (autoscale, chaos, cluster, fleet,
                                             generation, kvship, serving)
    from tensorflowonspark_tpu_torch.engine import Context
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

    t_phase = time.monotonic()
    model = DecoderLM(VOCAB, hidden=HIDDEN, num_heads=HEADS,
                      num_layers=LAYERS, max_len=MAX_LEN, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(SEED))
    reqs = traffic()
    want = runs[None]["out"]
    engine_kw = {"slots": SLOTS, "total_len": MAX_LEN,
                 "kv_block_size": BLOCK, "device": str(dev)}
    work = tempfile.mkdtemp(prefix=".tfos-supervised-", dir=here)
    res = {}
    launches = {"split": 0, "window": 0, "tiled": 0}

    def add(routes):
        for k in launches:
            launches[k] += routes[k]

    def tokens(got, idx, leg, expect=None, requests=None):
        """``got[i]`` for ``i`` in ``idx`` against phase 4's outputs;
        returns the ties."""
        check(sorted(got) == sorted(idx), "14({}) answered {} of {} "
              "requests".format(leg, len(got), len(idx)))
        expect = expect or (lambda i: want[i])
        requests = requests or reqs
        return compare_tokens(torch, generation, model,
                              [got[i] for i in idx], [expect(i) for i in idx],
                              [requests[i] for i in idx], None, dev)

    # (a) a scheduler killed mid-stream under the supervisor: THE main
    # path of this leg, counts at zero just before, read just after
    t_leg = time.monotonic()
    fuse = os.path.join(work, "kill-a.fuse")
    f = cluster.serving_fleet(model, replicas=2, name="gpt2", supervise=True,
                              engine_kw=engine_kw, host="127.0.0.1")
    holds = []
    _record_holds(f.router, holds)
    series = _Series(f).start()
    try:
        port = f.router_addr[1]
        sup = f.supervisor
        check(all(r.engine.device.type == "cuda" for r in f.replicas)
              and len(sup._watched) == 2,
              "14(a) the supervised replicas are not on the card")
        zero_launches(pa)
        before = series.totals()
        chaos.arm("kill_scheduler_at_step={},only={},fuse={}".format(
            SUPERVISED_KILL_STEP, SUPERVISED_VICTIM, fuse))
        idx = list(range(len(reqs)))
        window_idx = sorted(range(len(reqs)),
                            key=lambda i: len(reqs[i][0]))[:WINDOW_REQUESTS]
        window_reqs = {i: (reqs[i][0], WINDOW_NEW) for i in window_idx}
        survivor_port = next(r for r in f.replicas
                             if r.replica_id != SUPERVISED_VICTIM).addr[1]
        stop, window = threading.Event(), []
        prober = threading.Thread(target=lambda: window.append(_when_killed(
            fuse, stop, lambda: _fleet_clients(
                survivor_port, window_reqs, window_idx,
                clients=WINDOW_REQUESTS))))
        prober.start()
        got, errors, wall = _fleet_clients(port, reqs, idx)
        stop.set()
        prober.join()
        check(not errors, "14(a) client-visible failures: {}".format(
            errors[:2]))
        check(os.path.exists(fuse), "14(a) the kill never fired")
        check(window and window[0] is not None and not window[0][1],
              "14(a) the survivor's window requests: {}".format(
                  window and window[0] and window[0][1][:2]))
        _wait_for(lambda: sup.events.events("engine_restarted"),
                  "the supervisor's restart", timeout=60)
        chaos.disarm()
        with open(fuse) as fh:
            died = float(fh.read().strip())
        ours = [h for h in holds if h["owner"] == "supervisor"]
        dead = sup.events.events("engine_dead")
        restarted = sup.events.events("engine_restarted")
        check([(h["name"], h["replica"]) for h in ours] ==
              [("quiesce", SUPERVISED_VICTIM), ("readmit", SUPERVISED_VICTIM)]
              and len(dead) == 1 and len(restarted) == 1
              and dead[0]["replica"] == SUPERVISED_VICTIM
              and ours[0]["t"] <= dead[0]["t"] <= ours[1]["t"]
              <= restarted[0]["t"],
              "14(a) the supervisor's order: holds {} dead {} restarted {}"
              .format(ours, dead, restarted))
        check(_restarts(f) == [0, 1], "14(a) engine_restarts {}".format(
            _restarts(f)))
        victim, survivor = f.replicas[1], f.replicas[0]
        # the killed scheduler released the card's launch turn: the
        # survivor stepped and completed requests between the death and
        # the readmit, and the restarted engine takes the same turn
        held0, steps0 = series.at(died, survivor.replica_id)
        held1, steps1 = series.at(ours[1]["wall"], survivor.replica_id)
        check(steps1 > steps0 and held1 > held0
              and victim.engine._turn is survivor.engine._turn,
              "14(a) the survivor in the restart window: {} -> {} steps, "
              "{} -> {} completions; one turn {}; new tokens its slots "
              "still owed at the death {}".format(
                  steps0, steps1, held0, held1,
                  victim.engine._turn is survivor.engine._turn,
                  series.owed_at(died, survivor.replica_id)))
        _wait_for(lambda: SUPERVISED_VICTIM in fleet.route_order(
            f.router.replica_views(), f.router.stale_after),
            "the victim back in the router's order", timeout=30)
        status, body = _healthz(victim.addr)
        check(status == 200 and body["engine"]["alive"],
              "14(a) the victim's /healthz after the restart: {} {}".format(
                  status, body.get("status")))
        done1 = victim.engine.counters.get("requests_completed")
        after_idx = list(SUPERVISED_AFTER)
        got_after, errors, _ = _fleet_clients(port, reqs, after_idx)
        check(not errors, "14(a) after the readmit: {}".format(errors[:2]))
        served_after = victim.engine.counters.get("requests_completed") \
            - done1
        check(served_after > 0, "14(a) the restarted replica served none of "
              "{} requests".format(len(after_idx)))
        routes, steps, prefills = _exact_launches(pa, series, before, "14(a)")
        add(routes)
        ties = tokens(got, idx, "a") + tokens(got_after, after_idx, "a") \
            + tokens(window[0][0], window_idx, "a",
                     lambda i: _expected(runs, reqs, i, WINDOW_NEW),
                     window_reqs)
        n_new = sum(n for _, n in reqs)
        res["a"] = {
            "tokens_per_s": n_new / wall, "wall_s": wall,
            "death_to_quiesce_s": ours[0]["wall"] - died,
            "quiesce_to_readmit_s": ours[1]["wall"] - ours[0]["wall"],
            "engine_restarts": _restarts(f), "served_after": served_after,
            "survivor_in_window": {"decode_steps": steps1 - steps0,
                                   "completed": held1 - held0,
                                   "sent_at_the_death": WINDOW_REQUESTS},
            "launches": routes, "decode_steps": steps,
            "prefills": prefills, "ties": ties,
            "leg_wall_s": time.monotonic() - t_leg}
        log("supervised 14(a) {} killed at step {} under 16 requests: zero "
            "client failures, {:.1f} tokens/s; death -> quiesce {:.3f}s, "
            "quiesce -> readmit {:.3f}s (the survivor meanwhile {} decode "
            "steps, {} completions); engine_restarts {}; /healthz 200; "
            "{} of {} later requests on the restarted replica; launches {} "
            "({} x {} steps, {} x {} prefills); tokens equal phase 4's ({} "
            "at a tie); leg {:.1f}s".format(
                SUPERVISED_VICTIM, SUPERVISED_KILL_STEP, n_new / wall,
                res["a"]["death_to_quiesce_s"],
                res["a"]["quiesce_to_readmit_s"], steps1 - steps0,
                held1 - held0, _restarts(f), served_after,
                len(after_idx), routes, LAYERS, steps, LAYERS, prefills, ties,
                res["a"]["leg_wall_s"]))

        # (b) a rolling drain under the supervisor, then the drained-in
        # successor of replica-0 killed once
        t_leg = time.monotonic()
        zero_launches(pa)
        before = series.totals()
        engines = [r.engine for r in f.replicas]
        idx = list(range(SUPERVISED_DRAIN_REQUESTS))
        box = {}
        sender = threading.Thread(target=lambda: box.update(
            zip(("got", "errors", "wall"), _fleet_clients(port, reqs, idx))))
        sender.start()
        _wait_for(lambda: sum(r.engine.outstanding()
                              for r in f.replicas) >= 4,
                  "requests in flight before the drain")
        report = f.rolling_drain()
        sender.join()
        check(report["completed"] and report["zero_loss"]
              and not box["errors"]
              and all(r.engine not in engines for r in f.replicas),
              "14(b) the drain under the supervisor: {} {}".format(
                  report, box["errors"][:2]))
        check(_restarts(f) == [0, 1]
              and len(sup.events.events("engine_restarted")) == 1,
              "14(b) the drain moved engine_restarts: {}".format(
                  _restarts(f)))
        successor = f.replicas[0].engine
        _wait_for(lambda: all(e["engine"] is r.engine for e, r in
                              zip(sup._watched, f.replicas)),
                  "the watch on the successors", timeout=10)
        chaos.arm("kill_scheduler_at_step=1,only=replica-0")
        kill_idx = [11, 12]
        got_k, errors, _ = _fleet_clients(port, reqs, kill_idx, clients=2)
        check(not errors, "14(b) the successor's kill: {}".format(
            errors[:2]))
        _wait_for(lambda: len(sup.events.events("engine_restarted")) == 2
                  and f.replicas[0].engine is not successor
                  and f.replicas[0].engine.healthy()["alive"],
                  "the successor's restart", timeout=60)
        chaos.disarm()
        check(_restarts(f) == [1, 1], "14(b) engine_restarts after the "
              "successor's restart {}".format(_restarts(f)))
        routes, steps, prefills = _exact_launches(pa, series, before, "14(b)")
        add(routes)
        ties_b = tokens(box["got"], idx, "b") + tokens(got_k, kill_idx, "b")
        res["b"] = {"drain_wall_s": [r["wall_s"] for r in report["replicas"]],
                    "engine_restarts": _restarts(f), "launches": routes,
                    "ties": ties_b, "leg_wall_s": time.monotonic() - t_leg}
        log("supervised 14(b) rolling drain with {} in flight: zero lost, "
            "walls {} s, engine_restarts unmoved; the successor killed and "
            "restarted -> {}; launches {}; tokens equal phase 4's ({} at a "
            "tie); leg {:.1f}s".format(
                len(idx), res["b"]["drain_wall_s"], _restarts(f), routes,
                ties_b, res["b"]["leg_wall_s"]))
    finally:
        chaos.disarm()
        series.stop()
        f.stop()
    # the drained and restarted engines (their modules and KV pools) go
    # before (c) measures its memory
    f = sup = series = victim = survivor = engines = successor = None
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the closed loop: one replica, a burst, idle
    t_leg = time.monotonic()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev) / 2 ** 30
    torch.cuda.reset_peak_memory_stats(dev)
    f = cluster.serving_fleet(
        model, replicas=1, name="gpt2", engine_kw=engine_kw,
        host="127.0.0.1",
        autoscale=autoscale.AutoscalePolicy(**SCALE_POLICY))
    ctl = f.autoscaler
    series = _Series(f).start()
    try:
        zero_launches(pa)
        before = series.totals()
        burst = reqs + reqs
        idx = list(range(SCALE_BURST))
        got, errors, wall = _fleet_clients(f.router_addr[1], burst, idx,
                                           clients=SCALE_CLIENTS)
        check(not errors, "14(c) client-visible failures in the burst: {}"
              .format(errors[:2]))
        _wait_for(lambda: ctl.counters.get("scale_downs") >= 1
                  and len(f.replicas) == 1, "the idle fleet's scale-down",
                  timeout=90)
        decisions = ctl.events.events("autoscale_decision")
        ups = [d for d in decisions if d["action"] == "up"]
        downs = [d for d in decisions if d["action"] == "down"]
        up_done = ctl.events.events("autoscale_scaled_up")
        down_done = ctl.events.events("autoscale_scaled_down")
        check(len(ups) == 1 and len(up_done) == 1
              and ("queue_wait" in ups[0]["reason"]
                   or "saturated" in ups[0]["reason"]),
              "14(c) up decisions {}".format(
                  [(d["action"], d["reason"]) for d in ups]))
        new_rid = up_done[0]["replica"]
        check(new_rid in series.first_done,
              "14(c) the new replica {} served nothing".format(new_rid))
        check(len(downs) == 1 and len(down_done) == 1
              and down_done[0]["drained_clean"]
              and down_done[0]["replica"] not in
              f.reservation.serving_snapshot(),
              "14(c) down decisions {} / retirements {}".format(
                  [(d["action"], d["reason"]) for d in downs], down_done))
        routes, steps, prefills = _exact_launches(pa, series, before, "14(c)")
        add(routes)
        ties_c = tokens(got, idx, "c", expect=lambda i: want[i % len(reqs)],
                        requests=burst)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        n_new = sum(n for _, n in burst)
        res["c"] = {
            "tokens_per_s": n_new / wall, "wall_s": wall,
            "up_reason": ups[0]["reason"], "down_reason": downs[0]["reason"],
            "new_replica": new_rid, "retired": down_done[0]["replica"],
            "breach_to_first_completion_s":
                series.first_done[new_rid] - ups[0]["t"],
            "drain_wall_s": down_done[0]["t"] - downs[0]["t"],
            "allocated_before_gib": base, "peak_gib": peak,
            "launches": routes, "decode_steps": steps,
            "prefills": prefills, "ties": ties_c,
            "leg_wall_s": time.monotonic() - t_leg}
        log("supervised 14(c) autoscale: {} requests from {} clients {:.1f} "
            "tokens/s; up ({}) -> {} first answered {:.3f}s after the "
            "breach; down ({}) retired {} in a {:.3f}s drain, zero lost; "
            "peak {:.2f} GiB allocated ({:.2f} GiB before the fleet); "
            "launches {}; tokens equal phase 4's ({} at a tie); leg "
            "{:.1f}s".format(
                len(idx), SCALE_CLIENTS, n_new / wall, ups[0]["reason"],
                new_rid, res["c"]["breach_to_first_completion_s"],
                downs[0]["reason"], res["c"]["retired"],
                res["c"]["drain_wall_s"], peak, base, routes, ties_c,
                res["c"]["leg_wall_s"]))
    finally:
        series.stop()
        f.stop()

    # (d) an executor-hosted replica's executor SIGKILLed: attributed by
    # the supervisor, replaced by the autoscaler on the free executor
    t_leg = time.monotonic()
    fuse = os.path.join(work, "kill-d.fuse")
    spec = "kill_serving_executor_at_request={},only=replica-0,fuse={}" \
        .format(LOSS_KILL_AT, fuse)
    sc = Context(2, work_root=os.path.join(work, "engine"),
                 executor_env={"TFOS_CHAOS": spec})
    pids = set()
    try:
        f = cluster.serving_fleet(model, replicas=1, name="gpt2",
                                  placement="executors", sc=sc,
                                  engine_kw=engine_kw, spawn_timeout=300,
                                  supervise=True)
        try:
            ctl = f.autoscale(policy=autoscale.AutoscalePolicy(
                min_replicas=1, max_replicas=2, dead_after_s=1.5,
                down_cooldown_s=3600.0), interval=0.2)
            old = f.reservation.serving_snapshot()["replica-0"]
            pids.add(old["host"]["pid"])
            port = f.router_addr[1]
            got, answered = {}, {}
            for i in range(LOSS_REQUESTS):
                got[i] = _retrying_generate(serving, port, *reqs[i])
                answered[i] = time.time()
            check(os.path.exists(fuse), "14(d) the executor kill never "
                  "fired")
            with open(fuse) as fh:
                killed = float(fh.read().strip())
            info = f.reservation.serving_snapshot()["replica-0"]
            pids.add(info["host"]["pid"])
            lost = f.supervisor.events.events("serving_replica_lost")
            check(info["host"]["pid"] != old["host"]["pid"]
                  and info["host"]["executor"] != old["host"]["executor"]
                  and info["epoch"] > old["epoch"]
                  and ctl.counters.get("replacements") >= 1,
                  "14(d) the replacement: {} -> {}, epoch {} -> {}".format(
                      old["host"], info["host"], old["epoch"],
                      info["epoch"]))
            check(len(lost) == 1 and lost[0]["replica"] == "replica-0"
                  and not f.supervisor.events.events("engine_restarted"),
                  "14(d) the supervisor's events: lost {}, restarted {}"
                  .format(lost, f.supervisor.events.events(
                      "engine_restarted")))
            idx = list(range(LOSS_REQUESTS))
            ties_d = tokens(got, idx, "d")
            first = min(t for t in answered.values() if t > killed)
        finally:
            f.stop()
    finally:
        sc.stop()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and any(
            os.path.exists("/proc/%d" % p) for p in pids):
        time.sleep(0.1)
    left = [p for p in pids if os.path.exists("/proc/%d" % p)]
    rings = [r for r in os.listdir("/dev/shm") if r.startswith(
        "tfos-kvship-") and r.rsplit(".", 1)[-1] in {str(p) for p in pids}] \
        if os.path.isdir("/dev/shm") else []
    check(not left and not rings, "14(d) left behind: processes {} rings "
          "{}".format(left, rings))
    kvship.close_rings()
    res["d"] = {"kill_to_attribution_s": lost[0]["wall"] - killed,
                "kill_to_replacement_answer_s": first - killed,
                "pids": sorted(pids), "epochs": [old["epoch"], info["epoch"]],
                "executors": [old["host"]["executor"],
                              info["host"]["executor"]],
                "ties": ties_d, "leg_wall_s": time.monotonic() - t_leg}
    log("supervised 14(d) executor loss: {} requests, zero client failures; "
        "kill -> serving_replica_lost {:.3f}s, kill -> the replacement's "
        "first answer {:.3f}s; executor {} -> {}, epoch {} -> {}, no "
        "engine_restarted; stop leaves no process, no ring; tokens equal "
        "phase 4's ({} at a tie); leg {:.1f}s".format(
            LOSS_REQUESTS, res["d"]["kill_to_attribution_s"],
            res["d"]["kill_to_replacement_answer_s"],
            *res["d"]["executors"], *res["d"]["epochs"], ties_d,
            res["d"]["leg_wall_s"]))
    shutil.rmtree(work, ignore_errors=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    res["launches"] = launches
    res["wall_s"] = time.monotonic() - t_phase
    log("supervised phase: launches {}; wall {:.1f}s".format(
        launches, res["wall_s"]))
    return res


# -- phase 15: supervised training (restart, elastic resize, profiler) -----

#: 15(a): the trainer is SIGKILLed after this step's checkpoint
RECOVERY_KILL_AT = 5
#: 15(c): the post-restore step traced by ``tracing.trace``
RECOVERY_TRACE_STEP = RECOVERY_KILL_AT + 2
#: 15(b): the elastic leg's depth (its return delay is
#: ``profile_recovery.SHRINK_RETURN_AFTER``)
SHRINK_LAYERS = 2
#: the three flash kernels, as the profiler names them
FLASH_KERNEL_NAMES = ("flash_fwd_kernel", "flash_dq_kernel",
                      "flash_dkv_kernel")


def _trace_kernels(path):
    """The kernel names a ``torch.profiler`` Chrome trace holds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted({e["name"] for e in events
                   if e.get("cat") == "kernel" and "name" in e})


def _gib(peaks):
    """Each trainer's (pid's) peak ``max_memory_allocated`` in GiB."""
    return {pid: None if v is None else "{:.2f} GiB".format(v / 2 ** 30)
            for pid, v in peaks.items()}


def _leg_common_checks(leg, label, parts):
    check(leg["fired"], label + ": the chaos injection never fired")
    check(leg["exactly_once"],
          label + ": not exactly-once (steps {}, acked {})".format(
              leg.get("step_ids", leg.get("steps_by_executor")),
              leg["ledger"]["acked_partitions"]))
    check(leg["ledger"]["acked_partitions"] == parts,
          label + ": {} partitions acked, not {}".format(
              leg["ledger"]["acked_partitions"], parts))
    for t in leg["trainers"]:
        check(t["device"] == "cuda:0", label + ": a trainer ran on {}"
              .format(t["device"]))
        check(not t["in_bad_fork"] and not t["torch_in_executor"],
              label + ": trainer {} was forked from an executor that had "
              "loaded torch or touched CUDA: {}".format(t["pid"], t))
    for p in leg["executor_probes"]:
        check(not p["cuda_initialized"],
              label + ": executor pid {} holds a CUDA context".format(
                  p["pid"]))
    check(not leg["processes_left"], label + ": processes left after "
          "sc.stop(): {}".format(leg["processes_left"]))


def recovery_phase(torch, dev, phase5, here):
    """Phase 15: ``cluster.run(..., supervise=)`` on the card through
    ``profile_recovery``'s legs. (a) phase 5's model at full depth on
    one executor, phase 5's 80 records as 10 partitions of 8 (a
    partition a step a checkpoint), the trainer SIGKILLed after step
    ``RECOVERY_KILL_AT``'s checkpoint and restored by
    ``RestartFromCheckpoint``; (b) the same width at ``SHRINK_LAYERS``
    layers on two executors, executor 1 dropped and returned,
    ``ElasticResize`` shrinking to 1 and regrowing to 2; (c) one
    post-restore step of (a) under ``tracing.trace`` and the loss
    through ``tracing.SummaryWriter``."""
    import shutil
    import tempfile

    from tensorflowonspark_tpu_torch import profile_recovery as pr

    t_phase = time.monotonic()
    batches = motif_batches(TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    rows = np.concatenate([np.concatenate([b["x"], b["y"][:, -1:]], axis=1)
                           for b in batches])
    check(np.array_equal(rows, pr.motif_rows(TRAIN_STEPS, TRAIN_BATCH,
                                             TRAIN_SEQ, VOCAB, SEED)),
          "profile_recovery's motif stream differs from phase 5's")
    model = {"vocab": VOCAB, "hidden": HIDDEN, "heads": HEADS,
             "layers": LAYERS, "max_len": MAX_LEN}
    work = tempfile.mkdtemp(prefix=".tfos-recovery-", dir=here)
    res = {}
    try:
        # (a) restart at full depth
        os.makedirs(os.path.join(work, "restart"))
        a = pr.restart_leg(rows, model, os.path.join(work, "restart"),
                           batch=TRAIN_BATCH, kill_at=RECOVERY_KILL_AT,
                           lr=TRAIN_LR, seed=SEED,
                           trace_step=RECOVERY_TRACE_STEP)
        res["a"] = a
        _leg_common_checks(a, "15(a)", TRAIN_STEPS)
        ledger = a["ledger"]
        check(ledger["formations"] == 2
              and ledger["failures"] == ["trainer_crash"],
              "15(a): the ledger is {}".format(ledger))
        check(a["step_ids"] == list(range(1, TRAIN_STEPS + 1)),
              "15(a): steps {} (the killed step must not re-run)".format(
                  a["step_ids"]))
        starts = a["trainers"]
        check(len(starts) == 2 and starts[0]["restored_step"] is None
              and starts[1]["restored_step"] == RECOVERY_KILL_AT,
              "15(a): the restarted trainer restored {}".format(
                  [t["restored_step"] for t in starts]))
        rel = [abs(g - w) / abs(w) for g, w in zip(a["losses"],
                                                   phase5["losses"])]
        check(len(rel) == TRAIN_STEPS and max(rel) <= STEP_LOSS_RTOL,
              "15(a): losses differ from phase 5's (worst rel {:.2e})"
              .format(max(rel)))
        check(a["digest"] == phase5["digest"],
              "15(a): the final train state's digest differs from phase "
              "5's uninterrupted run")
        check(a["launches"] == {k: LAYERS * TRAIN_STEPS
                                for k in ("fwd", "dq", "dkv")},
              "15(a): flash launches over both attempts {} are not {} "
              "each".format(a["launches"], LAYERS * TRAIN_STEPS))
        stages = a["recovery"]
        check(stages is not None and all(
            stages[k] is not None for k in ("detect_s", "reform_s",
                                            "restore_s", "first_step_s",
                                            "mttr_s")),
              "15(a): MTTR stages missing: {}".format(stages))
        # (c) the profiler on the card
        check(a["trace"] is not None, "15(c): no trace was written")
        kernels = _trace_kernels(a["trace"])
        named = {k: [n for n in kernels if k in n]
                 for k in FLASH_KERNEL_NAMES}
        check(all(named.values()), "15(c): the trace names {} (wanted "
              "{})".format(kernels[:20], FLASH_KERNEL_NAMES))
        res["c"] = {"trace_kernels": kernels,
                    "summary_backend": a["summary_backend"]}
        log("recovery 15(a) restart: MTTR detect {detect_s}s, reform "
            "{reform_s}s, restore {restore_s}s, first step {first_step_s}s,"
            " MTTR {mttr_s}s".format(**stages))
        log("recovery 15(a): formations {}, failures {}, acked {}; losses "
            "vs phase 5 worst rel {:.2e} (tol {:.0e}); final digest equal "
            "to phase 5's; flash launches {} over both attempts; leg wall "
            "{:.1f}s; checkpoint save p50 {:.2f}s; step p50 {:.4f}s; "
            "trainer peak {}".format(
                ledger["formations"], ledger["failures"],
                ledger["acked_partitions"], max(rel), STEP_LOSS_RTOL,
                a["launches"], a["wall_s"], float(np.median(a["save_s"])),
                float(np.median(a["step_s"])), _gib(a["peak_bytes"])))
        log("recovery 15(c): the traced step's kernels include {}; "
            "SummaryWriter backend {}".format(
                {k: v[0] if v else None for k, v in named.items()},
                a["summary_backend"] or "none (no tensorboard: no-op)"))
        # (b) elastic shrink and regrow
        os.makedirs(os.path.join(work, "shrink"))
        b = pr.shrink_leg(rows, dict(model, layers=SHRINK_LAYERS),
                          os.path.join(work, "shrink"), batch=TRAIN_BATCH,
                          lr=TRAIN_LR, seed=SEED)
        res["b"] = b
        _leg_common_checks(b, "15(b)", TRAIN_STEPS)
        ledger = b["ledger"]
        check(ledger["widths"] == [2, 1, 2],
              "15(b): formation widths {}".format(ledger["widths"]))
        check(ledger["failures"] == ["executor_lost"]
              and ledger["failure_executors"] == [1],
              "15(b): failures {} on {}".format(
                  ledger["failures"], ledger["failure_executors"]))
        check(ledger["excluded"] == [] and ledger["width"] == 2,
              "15(b): excluded {}, width {}".format(ledger["excluded"],
                                                    ledger["width"]))
        check(b["regrow_requested"], "15(b): no regrow was requested")
        check(b["launches"] == {k: SHRINK_LAYERS * TRAIN_STEPS
                                for k in ("fwd", "dq", "dkv")},
              "15(b): flash launches {} are not {} each".format(
                  b["launches"], SHRINK_LAYERS * TRAIN_STEPS))
        log("recovery 15(b) shrink: executor loss -> MTTR stages {}; "
            "regrow {}; widths {}, failures {}, steps by executor {}, "
            "acked {}; leg wall {:.1f}s; trainer peaks {}".format(
                b["recovery"], b["regrow"], ledger["widths"],
                ledger["failures"], b["steps_by_executor"],
                ledger["acked_partitions"], b["wall_s"],
                _gib(b["peak_bytes"])))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["launches"] = {"restart": a["launches"], "shrink": b["launches"]}
    res["wall_s"] = time.monotonic() - t_phase
    log("recovery phase: wall {:.1f}s".format(res["wall_s"]))
    return res


# -- phase 16: tensor-parallel decode, TP ranks sharing the card -------------

#: the TP widths decoded, and the ranks (processes on cuda:0) that run
#: them: the mesh is {"data": TP_RANKS // tp, "model": tp}
TP_WIDTHS = (1, 2, 4)
TP_RANKS = 4
TP_BATCH, TP_PROMPT, TP_NEW = 4, 32, 32
#: seconds the phase's ranks must finish within
TP_TIMEOUT = 240


def tp_config():
    """Phase 16's model and decode shape (the ranks get it as an
    argument: a spawned rank re-imports this file)."""
    return {"vocab": VOCAB, "hidden": HIDDEN, "heads": HEADS,
            "layers": LAYERS, "max_len": MAX_LEN, "batch": TP_BATCH,
            "prompt": TP_PROMPT, "new": TP_NEW, "widths": TP_WIDTHS}


def tp_prompts(cfg):
    return np.random.RandomState(SEED + 16).randint(
        0, cfg["vocab"], (cfg["batch"], cfg["prompt"])).astype(np.int32)


def tp_decode_rank(rank, world, port, out_dir, device, cfg):
    """One TP rank of phase 16 (a process on ``cuda:0``, spawned): joins
    a gloo group over CUDA tensors, builds phase 4's GPT-2-small from the
    seed (every rank the same weights, checked), and for each width of
    ``cfg["widths"]`` decodes ``tp_prompts(cfg)`` through ``generate``
    — the plain model at tp 1, a copy laid out by
    ``distribute_params(..., DECODER_TP_RULES)`` on ``{"data": world //
    tp, "model": tp}`` otherwise — then records the logits teacher-forced
    over tp 1's tokens, one decode step's collectives after them, the
    cache's heads and the query weight's placements. Writes ``tp_rank<rank>.json``."""
    import copy
    import datetime

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="tcp://127.0.0.1:{}".format(port),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TP_TIMEOUT))
    try:
        from tensorflowonspark_tpu_torch import generation, tp_scaling_model
        from tensorflowonspark_tpu_torch.models.decoder import DecoderLM
        from tensorflowonspark_tpu_torch.ops import flash_attention as fa
        from tensorflowonspark_tpu_torch.ops import paged_attention as pa
        from tensorflowonspark_tpu_torch.parallel import build_mesh, sharding

        model = DecoderLM(cfg["vocab"], hidden=cfg["hidden"],
                          num_heads=cfg["heads"], num_layers=cfg["layers"],
                          max_len=cfg["max_len"], device=dev)
        model.init_weights(torch.Generator(device=dev).manual_seed(SEED))
        # every rank keeps its own slice of its own weights (a gloo
        # group has no scatter of CUDA tensors): they must be equal
        digest = torch.stack([sum(p.double().sum() for p in
                                  model.parameters())] * 2)
        digest[1] = -digest[1]
        dist.all_reduce(digest, op=dist.ReduceOp.MAX)
        res = {"rank": rank, "weights_equal":
               bool(digest[0].item() == -digest[1].item()), "widths": {}}
        prompt = torch.as_tensor(tp_prompts(cfg), device=dev)
        base_logits = seq = None
        cuda = dev.type == "cuda"
        for tp in cfg["widths"]:
            if tp == 1:
                m = model
            else:
                mesh = build_mesh({"data": world // tp, "model": tp},
                                  device=dev)
                m = sharding.distribute_params(
                    copy.deepcopy(model), mesh, sharding.DECODER_TP_RULES,
                    src_data_rank=None)
            if cuda:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            dist.barrier()
            t0 = time.monotonic()
            tokens = generation.generate(m, prompt, cfg["new"], device=dev)
            if cuda:
                torch.cuda.synchronize(dev)
            wall = time.monotonic() - t0
            peak = torch.cuda.max_memory_allocated(dev) if cuda else None
            if tp == 1:
                seq = tokens
            step = tp_scaling_model.decode_step_traffic(m, seq, device=dev)
            logits = step["logits"]
            if tp == 1:
                base_logits = logits
            w = {"tokens": tokens.cpu().tolist(), "wall_s": wall,
                 "peak_bytes": peak,
                 "max_abs_logit_diff": (logits - base_logits).abs().max()
                 .item(),
                 "bytes_per_token": step["bytes"],
                 "collectives": step["families"],
                 "cache_heads": generation.init_cache(m, 1, 1, device=dev)[
                     0]["cached_key"].shape[2],
                 "query_placements": [str(p) for p in getattr(
                     m.blocks[0].attn.query.weight, "placements", ())],
                 # per mesh dim (data, model): the query weight's rows
                 # split there, and the replicated elsewhere
                 "query_row_split": [
                     (p.is_shard(0), p.is_replicate()) for p in getattr(
                         m.blocks[0].attn.query.weight, "placements", ())]}
            # where this width's tokens leave tp 1's: tp 1's top-2 gap
            # at the logits that picked tp 1's token there
            w["divergences"] = []
            for b, (got, want) in enumerate(zip(w["tokens"],
                                                seq.cpu().tolist())):
                if got != want:
                    j = next(i for i in range(len(got)) if got[i] != want[i])
                    top = torch.topk(base_logits[b, j - 1], 2).values
                    w["divergences"].append(
                        {"row": b, "position": j,
                         "gap": (top[0] - top[1]).item()})
            res["widths"][str(tp)] = w
            if tp != 1:
                del m, mesh
        res["kernel_launches"] = {"paged": pa.launches,
                                  "flash": dict(fa.launches)}
        with open(os.path.join(out_dir, "tp_rank{}.json".format(rank)),
                  "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def tp_decode_phase(torch, here, device="cuda", cfg=None):
    """Phase 16: ``generation.generate`` of GPT-2-small under
    ``DECODER_TP_RULES`` at tp 1, 2 and 4, by ``TP_RANKS`` processes
    sharing ``cuda:0`` over a gloo group (NCCL refuses two ranks on one
    card; the megatron decode needs only all-reduces, which gloo runs
    on CUDA tensors)."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from tensorflowonspark_tpu_torch import util

    cfg = cfg or tp_config()
    t_phase = time.monotonic()
    out = tempfile.mkdtemp(prefix=".tfos-tp-", dir=here)
    try:
        ctx = mp.start_processes(
            tp_decode_rank,
            args=(TP_RANKS, util.find_free_port(), out, device, cfg),
            nprocs=TP_RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + TP_TIMEOUT
        try:
            while not ctx.join(timeout=2):
                check(time.monotonic() < deadline,
                      "16: the TP ranks outlived {} s".format(TP_TIMEOUT))
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks = []
        for r in range(TP_RANKS):
            with open(os.path.join(out, "tp_rank{}.json".format(r))) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    check(all(r["weights_equal"] for r in ranks),
          "16: the ranks built different weights from the seed")
    base = ranks[0]["widths"]["1"]["tokens"]
    check(len(base) == cfg["batch"]
          and all(len(t) == cfg["prompt"] + cfg["new"] for t in base)
          and all(0 <= x < cfg["vocab"] for t in base for x in t),
          "16: tp 1's tokens are malformed")
    heads, layers = cfg["heads"], cfg["layers"]
    want_bytes = 2 * layers * cfg["batch"] * cfg["hidden"] * 4
    res = {"widths": {}}
    for tp in cfg["widths"]:
        ws = [r["widths"][str(tp)] for r in ranks]
        check(all(w["tokens"] == ws[0]["tokens"] for w in ws),
              "16: tp {}: the ranks decoded different tokens".format(tp))
        for w in ws:
            for d in w["divergences"]:
                check(d["gap"] < TIE_GAP,
                      "16: tp {} leaves tp 1's tokens at row {} position "
                      "{}, top-2 gap {:.3e} (not a tie)".format(
                          tp, d["row"], d["position"], d["gap"]))
        check(all(w["cache_heads"] == heads // tp for w in ws),
              "16: tp {}: the caches hold {} heads, not {}".format(
                  tp, [w["cache_heads"] for w in ws], heads // tp))
        if tp > 1:
            check(all(w["query_row_split"] == [[False, True], [True, False]]
                      for w in ws),
                  "16: tp {}: query weight placements {}".format(
                      tp, ws[0]["query_placements"]))
            check(all(w["bytes_per_token"] == want_bytes
                      and set(w["collectives"]) == {"all_reduce"}
                      and w["collectives"]["all_reduce"]["ops"]
                      == 2 * layers for w in ws),
                  "16: tp {}: a decode step moved {} ({} bytes), not 2 x {} "
                  "all-reduces, {} bytes".format(
                      tp, ws[0]["collectives"], ws[0]["bytes_per_token"],
                      layers, want_bytes))
        else:
            check(all(w["bytes_per_token"] == 0 for w in ws),
                  "16: the plain model's decode step moved bytes")
        wall = max(w["wall_s"] for w in ws)
        res["widths"][tp] = {
            "wall_s": wall,
            "tokens_per_s": cfg["batch"] * cfg["new"] / wall,
            "max_abs_logit_diff": max(w["max_abs_logit_diff"] for w in ws),
            "peak_gib": [None if w["peak_bytes"] is None
                         else w["peak_bytes"] / 2 ** 30 for w in ws],
            "bytes_per_token": ws[0]["bytes_per_token"],
            "cache_heads": ws[0]["cache_heads"],
            "ties": sum(len(w["divergences"]) for w in ws) // len(ws)}
        log("tp decode 16 tp {}: {} heads a rank, query {}; a decode step "
            "moves {} bytes ({}); max |logit - tp 1| {:.3e}; {} tie "
            "divergences; wall {:.2f}s, {:.1f} tokens/s (ranks sharing one "
            "card over gloo, not a TP speed); peak GiB by rank {}".format(
                tp, ws[0]["cache_heads"], ws[0]["query_placements"] or
                "plain", ws[0]["bytes_per_token"], ws[0]["collectives"],
                res["widths"][tp]["max_abs_logit_diff"],
                res["widths"][tp]["ties"], wall,
                res["widths"][tp]["tokens_per_s"],
                ["{:.2f}".format(g) if g is not None else None
                 for g in res["widths"][tp]["peak_gib"]]))
    launched = [r["kernel_launches"] for r in ranks]
    check(all(r["paged"] == 0 and not any(r["flash"].values())
              for r in launched),
          "16: the contiguous TP decode launched a kernel: {}".format(
              launched))
    res["kernel_launches"] = launched[0]
    res["bytes_per_token_megatron"] = want_bytes
    res["wall_s"] = time.monotonic() - t_phase
    log("tp decode phase: wall {:.1f}s".format(res["wall_s"]))
    return res


# -- phase 17: heads 256 wide ---------------------------------------------

#: Gemma-2B's attention width and depth (2048 = 8 heads x 256, 18 layers)
#: on the repo's own GPT-style block; vocab and max_len as phase 4's
WIDE_HIDDEN, WIDE_HEADS, WIDE_LAYERS = 2048, 8, 18
WIDE_D = WIDE_HIDDEN // WIDE_HEADS
#: the D-256 training shape (batch, sequence)
WIDE_BATCH = 4
#: the three flash kernels at D 256 against their plain versions, at the
#: training shape (B 4, S 1024, 8 heads, causal) in both dtypes
WIDE_FLASH_CASES = [
    ("g: D256 B4 S1024 causal fp32", WIDE_BATCH, TRAIN_SEQ, TRAIN_SEQ,
     True, "float32", None, 128),
    ("h: D256 B4 S1024 causal bf16", WIDE_BATCH, TRAIN_SEQ, TRAIN_SEQ,
     True, "bfloat16", None, 128),
]
#: a fused/gather token divergence of the D-256 decoder at int8 KV is
#: accepted at a top-2 gap below this. The two engines quantize their own
#: K/V, which differ by float noise (the attention's summation order), so
#: a value at a rounding boundary lands one code apart: one code is
#: scale / 127 of a head's absmax (~0.024 at this width), which moves a
#: logit by ~1e-3 |q_d| — 10x the float rule, as the CPU decoder tests
#: hold int8 logits at 10x the float tolerance. (At float KV the phase-4
#: rule, TIE_GAP, holds.)
WIDE_INT8_TIE_GAP = 1e-3
#: 17(b): the requests of the int8 leg (the float leg serves all 16)
WIDE_INT8_REQUESTS = 8
#: D 192, zero-padded to the 256 instantiation by the public path
PAD_FLASH_CASES = [
    ("i: D192 B2 S512 causal fp32", 2, 512, 512, True, "float32", None, 128),
    ("j: D192 B2 S512 key mask bf16", 2, 512, 512, False, "bfloat16", 1,
     128),
]


def wide_model(torch, dev):
    """The D-256 ``DecoderLM`` on ``dev`` (its weights set by the
    caller, from the seed)."""
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

    return DecoderLM(VOCAB, hidden=WIDE_HIDDEN, num_heads=WIDE_HEADS,
                     num_layers=WIDE_LAYERS, max_len=MAX_LEN, device=dev)


def wide_kernel_cases(torch, pa, fa, dev):
    """17(a): each D-256 instantiation against its plain version on the
    card. Paged: the split route at D 256 and the window route at
    ``SPEC_K`` and ``WINDOW_MAX_QUERIES`` queries (8 slots, block 16,
    mixed depths, a row overshooting the table, an all-scratch slot) and the
    tensor-core tiled route at D 256, blocks 16, 32 and 64 (a D-256
    engine's pool block of 64 was refused before the tiled route took
    these widths), on a 256-token tail and a cold 512 prompt; float and
    int8 (``hold_case``: the route, ``KERNEL_TOL``, a bitwise repeat,
    NaN-poisoned dead rows). Flash: the three kernels at D 256 in float32
    and bfloat16 at B 4 x S 1024 x 8, causal (float32: one CTA of 8
    warps a row or key tile; bfloat16: one CTA of two warpgroups, over
    128 query rows in the forward and dQ, a 64-key tile in dK/dV), and D
    192 through the padding (``flash_cases``, the phase-3b limits).
    Returns the largest errors."""
    rng = np.random.RandomState(SEED + 17)
    worst = {"split": 0.0, "window": 0.0, "tiled": 0.0}
    seen = set()
    for quant in (False, True):
        for s_q in sorted({1, SPEC_K, pa.WINDOW_MAX_QUERIES}):
            args, scales = make_case(
                torch, rng, SLOTS, s_q, MAX_LEN // BLOCK, quant, dev,
                overshoot_row=1, scratch_row=SLOTS - 1, n=WIDE_HEADS,
                d=WIDE_D)
            route, err = hold_case(torch, pa, dev, args, scales, s_q,
                                   WIDE_D, quant)
            worst[route] = max(worst[route], err)
            seen.add(route)
        for bs in (16, 32, 64):
            for s_q in (256, 512):
                args, scales = make_case(
                    torch, rng, 1, s_q, MAX_LEN // bs, quant, dev,
                    depths=np.array([512]), n=WIDE_HEADS, d=WIDE_D, bs=bs)
                route, err = hold_case(torch, pa, dev, args, scales, s_q,
                                       WIDE_D, quant, bs=bs)
                worst[route] = max(worst[route], err)
                seen.add(route)
    check(seen == {"split", "window", "tiled"},
          "the D-256 cases took the routes {}".format(sorted(seen)))
    flash = flash_cases(torch, fa, dev, WIDE_FLASH_CASES, n=WIDE_HEADS,
                        d=WIDE_D, seed=SEED + 18)
    flash.update(flash_cases(torch, fa, dev, PAD_FLASH_CASES, n=WIDE_HEADS,
                             d=192, seed=SEED + 19))
    return worst, flash


def wide_timing(torch, pa, fa, dev):
    """The D-256 rows' times: the split route at the serving decode shape
    (phase 3's depths, 8 heads of 256), the tensor-core tiled route at
    the 256-token tail and the cold 512 prompt (block 16), float and int8;
    the flash kernels at B 4 x S 1024 x 8 x 256, causal, both dtypes, and
    for row 2d, the bfloat16 forward (one CTA of two warpgroups over 128
    query rows), its device time over SDPA's, its share of the bound and
    its budget (registers, spills, shared memory, CTAs an SM), which must
    be spill-free within 227 KB."""
    depths = np.random.RandomState(SEED + 1).randint(32, 641, size=SLOTS)
    paged = {}
    for shape, s_q, rows in (("decode", 1, depths),
                             ("prefill", 256, np.array([512])),
                             ("prefill_cold", 512, np.array([512]))):
        for quant in (False, True):
            t = paged_timing(torch, pa, dev, quant, s_q, rows, 6,
                             n=WIDE_HEADS, d=WIDE_D)
            paged.setdefault(shape, {})["int8" if quant else "float32"] = t
            log("D256 {} shape int8={!s:<5} {} kernel {:.4f} ms per eager "
                "call ({:.4f} ms device time)  plain {:.4f} ms  sdpa {:.4f} "
                "ms ({:.4f} ms device time)  bound {:.4f} ms ({}; {:.4f} ms "
                "at 67; {} live tokens, {} KV bytes, {:.3g} flop)".format(
                    shape, quant, t["route"], t["ms"], t["device_ms"],
                    t["plain_ms"], t["library_ms"], t["library_device_ms"],
                    t["bound_ms"], t["bound_by"], t["bound_simt_ms"],
                    t["live_tokens"], t["kv_bytes"], t["flops"]))
    check(all(paged[shape][kv]["route"] == route
              for shape, route in (("decode", "split"),
                                   ("prefill", "tiled"),
                                   ("prefill_cold", "tiled"))
              for kv in ("float32", "int8")),
          "D 256: decode must take the split route, prefills the tiled one")
    for kv in ("float32", "int8"):
        t = paged["decode"][kv]
        log("D256 decode {} split device time {:.4f} ms = {:.3f} x SDPA's "
            "{:.4f} ms; {:.2f}% of the {:.4f} ms bound; split and merge in "
            "one kernel a call (paged_split256_kernel: the last CTA of a "
            "row and head merges; no combine kernel; CTA stamps: "
            "profile_paged.py --trace)"
            .format(kv, t["device_ms"],
                    t["device_ms"] / t["library_device_ms"],
                    t["library_device_ms"], 100.0 * t["bound_ms"]
                    / t["device_ms"], t["bound_ms"]))
    for shape in ("prefill", "prefill_cold"):
        for kv in ("float32", "int8"):
            t = paged[shape][kv]
            log("D256 {} {} tiled device time {:.4f} ms = {:.3f} x SDPA's "
                "{:.4f} ms; {:.2f}% of the {:.4f} ms bound".format(
                    shape, kv, t["device_ms"],
                    t["device_ms"] / t["library_device_ms"],
                    t["library_device_ms"],
                    100.0 * t["bound_ms"] / t["device_ms"], t["bound_ms"]))
    flash = {}
    for dtype in ("float32", "bfloat16"):
        flash[dtype] = flash_timing(torch, fa, dev, WIDE_BATCH, TRAIN_SEQ,
                                    dtype, n=WIDE_HEADS, d=WIDE_D)
        for name, ft in flash[dtype].items():
            log("flash {:<3} D256 B4 S1024 causal {:<8}: kernel {:.4f} ms "
                "({:.4f} ms device time)  plain {:.4f} ms  sdpa {}  bound "
                "{:.4f} ms ({}; {:.4f} ms at 67; {:.3g} flop, {:.3g} B)"
                .format(name, dtype, ft["ms"], ft["device_ms"],
                        ft["plain_ms"], library_text(ft), ft["bound_ms"],
                        ft["bound_by"], ft["bound_simt_ms"], ft["flops"],
                        ft["bytes"]))
        ft = flash[dtype]
        pair = ft["dq"]["device_ms"] + ft["dkv"]["device_ms"]
        log("flash backward D256 {}: dQ + dK/dV device time {:.4f} ms, "
            "SDPA backward {:.4f} ms, ratio {:.3f}".format(
                dtype, pair, ft["dq"]["library_device_ms"],
                pair / ft["dq"]["library_device_ms"]))
    # row 2d: the bfloat16 forward at D 256, one CTA of two warpgroups
    # over 128 query rows and a third that refills their K/V ring
    # (flash_fwd_wgmma_pair_kernel)
    fwd = flash["bfloat16"]["fwd"]
    got = fa.budget("fwd", WIDE_D, torch.bfloat16)
    log("flash forward D256 bfloat16 (two warpgroups and a producer a CTA): "
        "device time {:.4f} ms = {:.3f} x SDPA's {:.4f} ms; {:.2f}% of the "
        "{:.4f} ms bound ({}); {} registers, {} spill bytes, {} KB shared, "
        "{} CTAs/SM".format(
            fwd["device_ms"], fwd["device_ms"] / fwd["library_device_ms"],
            fwd["library_device_ms"], 100.0 * fwd["bound_ms"]
            / fwd["device_ms"], fwd["bound_ms"], fwd["bound_by"],
            got["registers"], got["spill_bytes"], got["smem_bytes"] // 1024,
            got["ctas_per_sm"]))
    check(got["spill_bytes"] == 0 and got["ctas_per_sm"] >= 1
          and got["smem_bytes"] <= pa.MAX_SMEM_BYTES,
          "the bfloat16 D-256 forward spills or does not fit: {}".format(got))
    return paged, flash


def wide_serving(torch, pa, dev, model, layers=WIDE_LAYERS, legs=None,
                 label="D256"):
    """17(b): the D-256 decoder behind ``ModelServer``, the engine at its
    automatic block (16) and 8 slots, phase 4's 16 requests from 4
    clients at float KV and the first ``WIDE_INT8_REQUESTS`` at int8
    (18(c): the D-512 decoder, ``layers`` deep, the requests of
    ``legs``). Every decode step takes the split
    route and every prefill the window route (up to
    ``WINDOW_MAX_QUERIES`` queries) or the tensor-core tiled one, once a
    layer, exactly; tokens equal the gather oracle's but at a top-2
    tie."""
    from tensorflowonspark_tpu_torch import generation, serving

    everything = traffic()
    if legs is None:
        legs = {None: everything, "int8": everything[:WIDE_INT8_REQUESTS]}
    runs = {}
    # THE main path of 17(b): counts at zero just before, read just after
    pa.launches = 0
    zero_launches(pa)
    for kv in (None, "int8"):
        engine = serving.DecodeEngine(model, slots=SLOTS, total_len=MAX_LEN,
                                      kv_dtype=kv, device=dev)
        check(engine.kv_block_size == BLOCK,
              "the engine's automatic block is {}, not {}".format(
                  engine.kv_block_size, BLOCK))
        with engine:
            out, wall = serve_over_http(serving, engine, legs[kv])
            counts = engine.counters.snapshot()["counts"]
            runs[kv] = {"out": out, "wall": wall, "counts": counts,
                        "ttft_p50": engine.histograms["ttft"].quantile(0.5),
                        "step_p50": engine.histograms["decode_step"]
                        .quantile(0.5)}
    route_launches = dict(pa.route_launches)
    steps = sum(r["counts"].get("decode_steps", 0) for r in runs.values())
    prefills = sum(r["counts"].get("prefills", 0) for r in runs.values())
    log("{} serving paged launches by route: {} (decode steps {}, "
        "prefills {}, {} layers)".format(label, route_launches, steps,
                                        prefills, layers))
    want = want_routes(pa, layers * steps, prefills)
    check(route_launches == want,
          "{}: decode steps did not all take the split route and "
          "prefills the window or tiled one by query count, once a layer: "
          "{} vs {}".format(label, route_launches, want))
    for kv in (None, "int8"):
        reqs = legs[kv]
        r = runs[kv]
        r["tokens_per_s"] = sum(n for _, n in reqs) / r["wall"]
        t_oracle = time.monotonic()
        with serving.DecodeEngine(model, slots=SLOTS, total_len=MAX_LEN,
                                  kv_dtype=kv, attn_impl="gather",
                                  device=dev) as oracle:
            gather = [h.result(600) for h in
                      [oracle.submit(p, n) for p, n in reqs]]
        r["oracle_wall"] = time.monotonic() - t_oracle
        r["ties"] = compare_tokens(torch, generation, model, r["out"], gather,
                                   reqs, kv, dev,
                                   tie=WIDE_INT8_TIE_GAP if kv else TIE_GAP)
        log("{} serving kv={:<7} tokens/s={:.1f} wall={:.2f}s "
            "ttft_p50={:.4f}s decode_step_p50={:.4f}s decode_steps={} "
            "prefills={}; fused == gather on {}/{} requests ({} at a tie; "
            "oracle {:.1f}s)".format(
                label, kv or "float32", r["tokens_per_s"], r["wall"], r["ttft_p50"],
                r["step_p50"], r["counts"].get("decode_steps", 0),
                r["counts"].get("prefills", 0), len(reqs) - r["ties"],
                len(reqs), r["ties"], r["oracle_wall"]))
        del r["out"]
    check(pa.route_launches == route_launches,
          "the gather oracle launched the kernel")
    return route_launches, {kv or "float32": r for kv, r in runs.items()}


def wide_training(torch, fa, dev, make_model=None, layers=WIDE_LAYERS,
                  rows=WIDE_BATCH, steps=TRAIN_STEPS, lr=TRAIN_LR,
                  label="D256"):
    """17(c): 10 ``Trainer`` steps of the D-256 decoder at B 4 x S 1024,
    float32, TF32 off: the losses fall and every step launches each
    flash kernel once a layer (180 of each in all). 18(d): ``steps`` of
    ``make_model``'s decoder, ``layers`` deep, at ``rows`` x 1024 and
    learning rate ``lr``; with fewer than 6 steps the last loss must be
    below the first."""
    from tensorflowonspark_tpu_torch import infeed, training

    model = (make_model or wide_model)(torch, dev)
    trainer = training.Trainer(model, training.adamw(lr), device=dev)
    state = trainer.init(torch.Generator(device=dev).manual_seed(SEED))
    batches = motif_batches(steps, rows, TRAIN_SEQ)
    losses, step_s, counts = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    # THE main path of 17(c): counts at zero just before, read just after
    for name in fa.launches:
        fa.launches[name] = 0
    t0 = time.monotonic()
    for batch in infeed.device_batches(iter(batches), device=dev):
        ts = time.monotonic()
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        step_s.append(time.monotonic() - ts)
        counts.append(dict(fa.launches))
    wall = time.monotonic() - t0
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    log("{} training losses: ".format(label) + " ".join(
        "{:.4f}".format(x) for x in losses))
    check(len(losses) == steps and all(np.isfinite(losses)),
          "{}: a training loss is missing or not finite".format(label))
    tail = losses[-3:] if steps >= 6 else losses[-1:]
    check(np.mean(tail) < losses[0],
          "{}: the loss did not fall (first {:.4f}, mean of last {} "
          "{:.4f})".format(label, losses[0], len(tail), np.mean(tail)))
    for i, c in enumerate(counts):
        check(all(c[k] == layers * (i + 1) for k in c),
              "{} step {}: flash launches {} are not {} per kernel per "
              "step".format(label, i + 1, c, layers))
    tokens = rows * TRAIN_SEQ
    p50 = float(np.median(step_s))
    log("{} training step p50 {:.4f}s  tokens/s {:.1f} (p50)  {:.1f} "
        "({}-step wall {:.2f}s)  max_memory_allocated {:.2f} GiB; flash "
        "launches {}".format(label, p50, tokens / p50, tokens * steps / wall,
                             steps, wall, peak / 2 ** 30, launches))
    return launches, {"losses": losses, "step_s": step_s, "p50_s": p50,
                      "tokens_per_s": tokens / p50, "wall_s": wall,
                      "max_memory_allocated": peak}


def wide_phase(torch, pa, fa, dev):
    """Phase 17: heads 256 wide — (a) the D-256 instantiations against
    their plain versions and timed, (b) the D-256 decoder served, (c)
    trained; (d) its model and engines freed before the phase ends."""
    t0 = time.monotonic()
    paged_err, flash_err = wide_kernel_cases(torch, pa, fa, dev)
    log("D256 kernel cases {:.1f}s".format(time.monotonic() - t0))
    paged_t, flash_t = wide_timing(torch, pa, fa, dev)
    t_a = time.monotonic() - t0
    model = wide_model(torch, dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(SEED))
    routes, serve = wide_serving(torch, pa, dev, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t_b = time.monotonic() - t0 - t_a
    flash_launches, train = wide_training(torch, fa, dev)
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.monotonic() - t0
    log("D256 phase wall {:.1f}s (kernels {:.1f}s, serving {:.1f}s, "
        "training {:.1f}s); {:.2f} GiB still allocated".format(
            wall, t_a, t_b, wall - t_a - t_b,
            torch.cuda.memory_allocated(dev) / 2 ** 30))
    return {"paged_err": paged_err, "flash_err": flash_err,
            "paged_timing": paged_t, "flash_timing": flash_t,
            "route_launches": routes, "serving": serve,
            "flash_launches": flash_launches, "training": train,
            "wall_s": wall, "kernels_s": t_a, "serving_s": t_b}


# -- phase 18: heads above 256 ------------------------------------------------

#: DeepSeek-V4-Flash's hidden size and head dim (4096 = 8 heads x 512; the
#: model has 64 query heads over one KV head) on the repo's own
#: GPT-style block, float32, cut to 4 layers; vocab and max_len as phase
#: 4's
WIDER_HIDDEN, WIDER_HEADS, WIDER_LAYERS = 4096, 8, 4
WIDER_D = WIDER_HIDDEN // WIDER_HEADS
#: the head dims each kernel of ``csrc/wide_attention.cu`` is held at:
#: one past the narrow kernels, int8 rows of 300 codes (not a 16-byte
#: multiple), 384, the model's 512, 576 (512 + 64 latent attention) and
#: 1024
WIDER_DIMS = (257, 300, 384, 512, 576, 1024)
#: training: 3 steps of 2 x 1024. The learning rate is phase 5's over 3:
#: at hidden 4096 Adam's first step at 3e-4 overshot (the loss went
#: 11.86, 16.62, 11.00 on the card), as a width 5x phase 5's predicts
WIDER_BATCH, WIDER_STEPS, WIDER_LR = 2, 3, 1e-4
#: 18(c): the first requests of phase 4's traffic served at each KV dtype
WIDER_REQUESTS = 4
#: 18(a): tokens a row's table holds in the cases away from D 512: three
#: splits of 256 keys, and room for the 512-token cold prompt
WIDER_TABLE = 640


def wider_model(torch, dev):
    """The D-512 ``DecoderLM`` on ``dev`` (its weights set by the caller,
    from the seed)."""
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

    return DecoderLM(VOCAB, hidden=WIDER_HIDDEN, num_heads=WIDER_HEADS,
                     num_layers=WIDER_LAYERS, max_len=MAX_LEN, device=dev)


def wider_kernel_cases(torch, pa, fa, dev):
    """18(a): each wide kernel against its plain version at every head
    dim of ``WIDER_DIMS``. Paged, float and int8, block 16: decode (S_q 1,
    the split kernel and its combine), the verify window (S_q 3; 2 and 4
    at D 512: the split kernel at 2 and 4 queries a row), a 256-token
    tail and a cold 512 prompt (the tiled kernel); at D 512 the main
    path's 8 heads, 8 slots and table of 1024 tokens (a row overshooting
    the table, an all-scratch slot) against ``_blockwise``, elsewhere 2
    heads, 4 rows and a table of ``WIDER_TABLE`` tokens (three splits
    of 256 keys) against the gather oracle (one batched product where
    the blockwise version walks one block an iteration); then D 512 at
    blocks of 1 (against the gather oracle) and 64. Each as
    ``hold_case`` holds it (the route, ``KERNEL_TOL``, a bitwise repeat,
    NaN-poisoned dead rows).
    Flash, float32 and bfloat16 at B 2 x 2 heads: causal at S 256 and a
    key mask at S_q 128 x S_k 320 with a fully masked batch row, forward
    and backward through the public pair (q, k, v and dO padded to a
    multiple of 128), and the training shape B 2 x S 1024 x 8 x 512,
    causal, float32, under phase 3b's limits. Returns the largest errors
    by route and by head dim."""
    rng = np.random.RandomState(SEED + 25)
    worst = {"split": 0.0, "window": 0.0, "tiled": 0.0}
    seen = set()

    def hold(quant, s_q, d, n, b, bs=BLOCK, depths=None, plain="blockwise",
             tokens=MAX_LEN):
        tail = depths is not None
        args, scales = make_case(
            torch, rng, b, s_q, tokens // bs, quant, dev,
            depths=np.array(depths) if tail else None,
            overshoot_row=None if tail else 1,
            scratch_row=None if tail else b - 1, n=n, d=d, bs=bs,
            on_device=True)
        route, err = hold_case(torch, pa, dev, args, scales, s_q, d, quant,
                               bs=bs, plain=plain)
        worst[route] = max(worst[route], err)
        seen.add(route)

    t0 = time.monotonic()
    for d in WIDER_DIMS:
        main = d == WIDER_D
        n, b = (WIDER_HEADS, SLOTS) if main else (2, 4)
        kw = {} if main else {"plain": "gather", "tokens": WIDER_TABLE}
        for quant in (False, True):
            for s_q in (1, 2, 4) if main else (1, 3):
                hold(quant, s_q, d, n, b, **kw)
            for s_q in (256, 512):
                hold(quant, s_q, d, n, 1, depths=[512], **kw)
    for bs in (1, 64):
        for quant in (False, True):
            plain = "gather" if bs == 1 else "blockwise"
            hold(quant, 1, WIDER_D, WIDER_HEADS, SLOTS, bs=bs, plain=plain)
            hold(quant, 256, WIDER_D, WIDER_HEADS, 1, bs=bs, depths=[512],
                 plain=plain)
    check(seen == {"split", "window", "tiled"},
          "the wide cases took the routes {}".format(sorted(seen)))
    log("D512 paged cases {:.1f}s".format(time.monotonic() - t0))
    t0 = time.monotonic()
    flash = {}
    for d in WIDER_DIMS:
        cases = [
            ("c: D{} B2 S256 causal fp32".format(d), 2, 256, 256, True,
             "float32", None, 128),
            ("m: D{} S_q128 S_k320 key mask fp32".format(d), 2, 128, 320,
             False, "float32", 1, 64),
            ("b: D{} B2 S256 causal bf16".format(d), 2, 256, 256, True,
             "bfloat16", None, 128),
            ("n: D{} S_q128 S_k320 key mask bf16".format(d), 2, 128, 320,
             False, "bfloat16", 1, 64)]
        flash[d] = flash_cases(torch, fa, dev, cases, n=2, d=d,
                               seed=SEED + 26 + d)
    flash["train"] = flash_cases(
        torch, fa, dev, [("t: D512 B2 S1024 causal fp32", WIDER_BATCH,
                          TRAIN_SEQ, TRAIN_SEQ, True, "float32", None,
                          128)], n=WIDER_HEADS, d=WIDER_D, seed=SEED + 27)
    log("D512 flash cases {:.1f}s".format(time.monotonic() - t0))
    return worst, flash


def wider_budget(torch, fa, pa):
    """Registers, spills, shared memory and CTAs per SM of every kernel of
    ``wide_attention.cu`` (the same instantiation at every D above 256):
    the paged split kernel at 1, 2 and 4 queries a row and the tiled
    kernel, float and int8 pools; the flash forward, dQ and dK/dV in
    float32 and bfloat16. Each must be spill-free and fit the card."""
    out = {}
    for quant in (False, True):
        kv = "int8" if quant else "float32"
        for route, queries in (("split", 1), ("window", 2), ("window", 4),
                               ("tiled", None)):
            key = "paged_{} Q{} wide {}".format(route, queries or "-", kv)
            out[key] = pa.budget(WIDER_D, quant, route=route,
                                 queries=queries)
    for kind in ("fwd", "dq", "dkv"):
        for dtype in ("float32", "bfloat16"):
            out["{} wide {}".format(kind, dtype)] = fa.budget(
                kind, WIDER_D, getattr(torch, dtype))
    for key, got in out.items():
        log("budget {:<26}: {} registers, {} spill bytes, {} bytes shared, "
            "{} CTAs/SM".format(key, got["registers"], got["spill_bytes"],
                                got["smem_bytes"], got["ctas_per_sm"]))
        check(got["spill_bytes"] == 0 and got["ctas_per_sm"] >= 1
              and got["smem_bytes"] <= pa.MAX_SMEM_BYTES,
              "{} spills or does not fit: {}".format(key, got))
    return out


def wider_timing(torch, pa, fa, dev):
    """The wide rows' times: the split kernel at row 1d's decode shape (8
    slots at phase 3's depths, 8 heads of 512), float and int8; the tiled
    kernel at the 256-token tail, float; the flash kernels at B 2 x S
    1024 x 8 x 512, causal, float32 and bfloat16. Each beside its plain
    version, SDPA over the same inputs and the bound, with its share of
    the bound."""
    depths = np.random.RandomState(SEED + 1).randint(32, 641, size=SLOTS)
    paged = {}
    for shape, s_q, rows, quant in (("decode", 1, depths, False),
                                    ("decode", 1, depths, True),
                                    ("prefill", 256, np.array([512]),
                                     False)):
        # pool copies from each shape's live bytes: 4 at float decode
        # (59.5 MB a call), more at int8 decode and the tail (about 15
        # and 17 MB), so the set stays out of the L2 at every shape
        t = paged_timing(torch, pa, dev, quant, s_q, rows, None,
                         n=WIDER_HEADS, d=WIDER_D, on_device=True)
        paged.setdefault(shape, {})["int8" if quant else "float32"] = t
        log("D512 {} int8={!s:<5} {} kernel {:.4f} ms per eager call "
            "({:.4f} ms device time)  plain {:.4f} ms  sdpa {:.4f} ms "
            "({:.4f} ms device time)  bound {:.4f} ms ({}; {:.2f}% of it; "
            "{} live tokens, {} KV bytes, {:.3g} flop; {} pool copies)"
            .format(
                shape, quant, t["route"], t["ms"], t["device_ms"],
                t["plain_ms"], t["library_ms"], t["library_device_ms"],
                t["bound_ms"], t["bound_by"],
                100.0 * t["bound_ms"] / t["device_ms"], t["live_tokens"],
                t["kv_bytes"], t["flops"], t["copies"]))
    check(all(t["route"] == ("split" if shape == "decode" else "tiled")
              for shape in paged for t in paged[shape].values()),
          "D 512: decode must take the split route, the tail the tiled one")
    flash = {}
    for dtype in ("float32", "bfloat16"):
        flash[dtype] = flash_timing(torch, fa, dev, WIDER_BATCH, TRAIN_SEQ,
                                    dtype, n=WIDER_HEADS, d=WIDER_D)
        for name, ft in flash[dtype].items():
            log("flash {:<3} D512 B2 S1024 causal {:<8}: kernel {:.4f} ms "
                "({:.4f} ms device time)  plain {:.4f} ms  sdpa {}  bound "
                "{:.4f} ms ({}; {:.2f}% of it; {:.3g} flop, {:.3g} B)"
                .format(name, dtype, ft["ms"], ft["device_ms"],
                        ft["plain_ms"], library_text(ft), ft["bound_ms"],
                        ft["bound_by"],
                        100.0 * ft["bound_ms"] / ft["device_ms"],
                        ft["flops"], ft["bytes"]))
    return paged, flash


def wider_phase(torch, pa, fa, dev):
    """Phase 18: heads above 256 — (a) the kernels of
    ``wide_attention.cu`` against their plain versions at every head dim
    of ``WIDER_DIMS``, their budgets and times, (b) the D-512 decoder
    served, (c) trained; (d) its model and engines freed before the phase
    ends."""
    t0 = time.monotonic()
    paged_err, flash_err = wider_kernel_cases(torch, pa, fa, dev)
    log("D512 kernel cases {:.1f}s".format(time.monotonic() - t0))
    budget = wider_budget(torch, fa, pa)
    t_timing = time.monotonic()
    paged_t, flash_t = wider_timing(torch, pa, fa, dev)
    log("D512 timing {:.1f}s".format(time.monotonic() - t_timing))
    t_a = time.monotonic() - t0
    model = wider_model(torch, dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(SEED))
    reqs = traffic()[:WIDER_REQUESTS]
    routes, serve = wide_serving(torch, pa, dev, model, layers=WIDER_LAYERS,
                                 legs={None: reqs, "int8": reqs},
                                 label="D512")
    check(routes["split"] > 0 and routes["tiled"] > 0,
          "D 512: the split or tiled kernel was not launched: {}".format(
              routes))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t_b = time.monotonic() - t0 - t_a
    flash_launches, train = wide_training(
        torch, fa, dev, make_model=wider_model, layers=WIDER_LAYERS,
        rows=WIDER_BATCH, steps=WIDER_STEPS, lr=WIDER_LR, label="D512")
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.monotonic() - t0
    log("D512 phase wall {:.1f}s (kernels {:.1f}s, serving {:.1f}s, "
        "training {:.1f}s); {:.2f} GiB still allocated".format(
            wall, t_a, t_b, wall - t_a - t_b,
            torch.cuda.memory_allocated(dev) / 2 ** 30))
    return {"paged_err": paged_err, "flash_err": flash_err,
            "budget": budget, "paged_timing": paged_t,
            "flash_timing": flash_t, "route_launches": routes,
            "serving": serve, "flash_launches": flash_launches,
            "training": train, "wall_s": wall, "kernels_s": t_a,
            "serving_s": t_b}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out-dir", default=None,
                    help="also write every number to DIR/chip_smoke.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one card",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not all(os.path.isfile(os.path.join(
            here, "tensorflowonspark_tpu_torch", "csrc", name + ".cu"))
            for name in ("paged_attention", "flash_attention",
                         "wide_attention")):
        print("the port's package is not beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tensorflowonspark_tpu_torch import device_info, generation
    from tensorflowonspark_tpu_torch.ops import _build
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.ops import paged_attention as pa

    # every paged prefill of this process from here on, by query count:
    # what the prefills owe each route in the exact launch checks
    PREFILLS.install(generation)
    t_start = time.monotonic()
    card = device_info.describe().splitlines()[0]
    dev = device_info.default_device()
    log("card: " + card)
    log("torch {} cuda {}".format(torch.__version__, torch.version.cuda))

    # the flash and wide sources build (the longer) while the paged
    # kernels are held and timed
    t0 = time.monotonic()
    flash_build = {}

    def build_flash():
        try:
            flash_build.update(_build.build(["flash_attention",
                                             "wide_attention"]))
        except Exception as e:  # re-raised on the main thread below
            flash_build["error"] = e

    flash_thread = threading.Thread(target=build_flash)
    flash_thread.start()
    report = _build.build(["paged_attention"])
    log("build: paged_attention {:.2f}s".format(time.monotonic() - t0))

    max_err = kernel_cases(torch, pa, dev)
    timing = {"decode": {}, "prefill": {}, "prefill_cold": {}}
    for shape, fn in (("decode", kernel_timing), ("prefill", prefill_timing),
                      ("prefill_cold", cold_prefill_timing)):
        for quant in (False, True):
            t = timing[shape][quant] = fn(torch, pa, dev, quant)
            log("{} shape int8={!s:<5} {} kernel {:.4f} ms per eager call "
                "({:.4f} ms device time)  plain {:.4f} ms  sdpa {:.4f} ms "
                "({:.4f} ms device time)  bound {:.4f} ms ({}, 3xTF32 at "
                "165 TFLOP/s; {:.4f} ms at 67; {} live tokens, {} KV bytes, "
                "{:.3g} flop)".format(
                    shape, quant, t["route"], t["ms"], t["device_ms"],
                    t["plain_ms"], t["library_ms"], t["library_device_ms"],
                    t["bound_ms"], t["bound_by"], t["bound_simt_ms"],
                    t["live_tokens"], t["kv_bytes"], t["flops"]))
    check(all(timing[shape][quant]["route"] == route
              for shape, route in (("decode", "split"), ("prefill", "tiled"),
                                   ("prefill_cold", "tiled"))
              for quant in (False, True)),
          "the decode shape must take the split route, the prefill shapes "
          "the tensor-core tiled one")
    for quant in (False, True):
        t = timing["prefill"][quant]
        log("prefill shape int8={!s:<5} tiled device time {:.4f} ms = {:.3f}"
            " x SDPA's {:.4f} ms; {:.2f}% of the {:.4f} ms bound".format(
                quant, t["device_ms"], t["device_ms"] / t["library_device_ms"],
                t["library_device_ms"], 100.0 * t["bound_ms"] / t["device_ms"],
                t["bound_ms"]))
    flash_thread.join()
    if "error" in flash_build:
        raise flash_build["error"]
    report.update(flash_build)
    log("build: {:.2f}s since the start ({})".format(
        time.monotonic() - t0, ", ".join(
            "{} {:.2f}s".format(k, v["seconds"]) for k, v in report.items())))
    for name, rep in report.items():
        for line in rep["ptxas"].splitlines():
            if ("registers" in line or "spill" in line
                    or "Performance Loss" in line):
                log("  {}: {}".format(name, line.strip()))

    budget = kernel_budget(torch, fa, pa)
    flash_err = flash_cases(torch, fa, dev)
    flash_t = flash_timing(torch, fa, dev)
    for name, ft in flash_t.items():
        log("flash {:<3} at B8 S1024 causal fp32: kernel {:.4f} ms ({:.4f} "
            "ms device time)  plain {:.4f} ms  sdpa {}  bound {:.4f} ms ({}, "
            "3xTF32 at 165 TFLOP/s; {:.4f} ms at 67; {:.3g} flop, {:.3g} B)"
            .format(name, ft["ms"], ft["device_ms"], ft["plain_ms"],
                    library_text(ft), ft["bound_ms"], ft["bound_by"],
                    ft["bound_simt_ms"], ft["flops"], ft["bytes"]))
    bwd_ms = flash_t["dq"]["ms"] + flash_t["dkv"]["ms"]
    log("flash backward at B8 S1024 causal fp32: dQ + dK/dV {:.4f} ms, "
        "SDPA backward {:.4f} ms, ratio {:.3f}".format(
            bwd_ms, flash_t["dq"]["library_ms"],
            bwd_ms / flash_t["dq"]["library_ms"]))

    launches, route_launches, runs, preempt = serving_phase(torch, dev)
    torch.cuda.empty_cache()
    flash_launches, train = training_phase(torch, dev)
    # phase 5's model and optimizer were locals of training_phase: free
    # their memory before the trainer process of phase 6 takes the card
    gc.collect()
    torch.cuda.empty_cache()
    log("before the cluster phase: {:.2f} GiB allocated in this process"
        .format(torch.cuda.memory_allocated(dev) / 2 ** 30))
    clus = cluster_phase(None, train, here)
    pipe = pipeline_phase(None, train, here)
    gc.collect()
    torch.cuda.empty_cache()
    zoo = models_phase(torch, dev, here)
    gc.collect()
    torch.cuda.empty_cache()
    ex = examples_phase(torch, dev, train, here)
    gc.collect()
    torch.cuda.empty_cache()
    par = parallel_phase(torch, dev, here)
    gc.collect()
    torch.cuda.empty_cache()
    gen = generation_phase(torch, pa, dev, runs, here)
    gc.collect()
    torch.cuda.empty_cache()
    planes = planes_phase(torch, pa, dev, runs, timing["decode"][False])
    gc.collect()
    torch.cuda.empty_cache()
    fleet_res = fleet_phase(torch, pa, dev, runs, here)
    gc.collect()
    torch.cuda.empty_cache()
    sup_res = supervised_phase(torch, pa, dev, runs, here)
    gc.collect()
    torch.cuda.empty_cache()
    rec = recovery_phase(torch, dev, train, here)
    gc.collect()
    torch.cuda.empty_cache()
    tpd = tp_decode_phase(torch, here)
    gc.collect()
    torch.cuda.empty_cache()
    wide = wide_phase(torch, pa, fa, dev)
    gc.collect()
    torch.cuda.empty_cache()
    wider = wider_phase(torch, pa, fa, dev)
    t = timing["decode"][False]
    kernels = {"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "tensorflowonspark_tpu_torch/csrc/paged_attention.cu",
        "replaces": "tensorflowonspark_tpu/ops/paged_attention.py:210",
        "launches": launches,
        # phase 11: (c) the speculative engines (the draft's one-token
        # steps on the split route, verify windows and prefills on the
        # tiled one), (d) the prefill and decode servers
        "launches_spec": gen["launches_spec"],
        "launches_disagg": gen["launches_disagg"],
        # phase 12: every serving-plane leg's calls by route (decode
        # steps x layers + measure_attn's 6 on split, prefills x layers
        # on tiled), counted exactly
        "launches_planes": planes["launches"],
        # phase 13: the fleet's replicas (two engines, then a prefill and
        # a decode tier) by route, each leg exact against its steps and
        # prefills
        "launches_fleet": fleet_res["launches"],
        # phase 14: the supervised fleet (a killed scheduler restarted, a
        # drained-in successor killed and restarted) and the autoscaled
        # one (a replica spawned and retired), each leg exact against the
        # steps and prefills of every engine it ran
        "launches_supervised": sup_res["launches"],
        "max_abs_err": max(max(max_err.values()), gen["verify_error"]),
        # the decode shape (split-KV route), the main path's decode
        # steps; ms and library_ms per eager call, as for the flash rows,
        # with the device times (CUDA-graph replays) beside them
        "ms": t["ms"],
        "device_ms": t["device_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "bound_simt_ms": t["bound_simt_ms"],
        "library_ms": t["library_ms"],
        "library_device_ms": t["library_device_ms"],
        # launches: calls of the wrapper, one per layer per step; a split
        # call launches two kernels, a tiled call one
        "paged_routes": {
            "split": {"kernels": ["paged_split_kernel",
                                  "paged_combine_kernel"],
                      "calls": route_launches["split"],
                      "kernel_launches": 2 * route_launches["split"],
                      "shape": "decode"},
            "window": {"kernels": ["paged_window_kernel"],
                       "calls": route_launches["window"],
                       "kernel_launches": route_launches["window"],
                       "shape": "prefill tails of at most "
                                "WINDOW_MAX_QUERIES queries (11(c)'s "
                                "verify windows are in the "
                                "paged_attention_window row)"},
            "tiled": {"kernels": ["paged_tiled_kernel"],
                      "calls": route_launches["tiled"],
                      "kernel_launches": route_launches["tiled"],
                      "shape": "prefill (phase 17's D-256 calls are in "
                               "the paged_attention_tiled_d256 row)"}},
        "by_shape": {shape: {"float32": timing[shape][False],
                             "int8": timing[shape][True]}
                     for shape in timing},
        # 11(a): the verify window, 8 slots x S_q 4 (the window route)
        "verify": gen["verify"]}]}
    t = gen["verify"]["float32"]
    kernels["kernels"].append({
        "name": "paged_attention_window",
        "route": "cuda",
        "source": "tensorflowonspark_tpu_torch/csrc/paged_attention.cu",
        "replaces": "tensorflowonspark_tpu/ops/paged_attention.py:210",
        # 11(c): the speculative engines' verify windows and short
        # prefill tails (counts zeroed before each engine, read after);
        # phase 4's short prefill tails beside them
        "launches": gen["launches_window"],
        "launches_serving": route_launches["window"],
        "launches_planes": planes["launches"]["window"],
        "launches_fleet": fleet_res["launches"]["window"],
        "launches_supervised": sup_res["launches"]["window"],
        "launches_d256": wide["route_launches"]["window"],
        "max_abs_err": max(max_err["window"], gen["verify_error"],
                           wide["paged_err"]["window"]),
        # 11(a)'s verify window, 8 slots x S_q 4, float32 (int8 in
        # "verify"); ms per eager call, device time beside it
        "ms": t["ms"],
        "device_ms": t["device_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "bound_simt_ms": t["bound_simt_ms"],
        "library_ms": t["library_ms"],
        "library_device_ms": t["library_device_ms"],
        "window_max_queries": pa.WINDOW_MAX_QUERIES,
        "budget": {k: v for k, v in budget.items()
                   if k.startswith("paged_window")},
        "verify": gen["verify"]})
    t = timing["prefill"][False]
    kernels["kernels"].append({
        "name": "paged_attention_tiled",
        "route": "cuda",
        "source": "tensorflowonspark_tpu_torch/csrc/paged_attention.cu",
        "replaces": "tensorflowonspark_tpu/ops/paged_attention.py:210",
        # the tensor-core query-tiled kernel: the serving legs' prefills
        "launches": route_launches["tiled"],
        "launches_fleet": fleet_res["launches"]["tiled"],
        "launches_supervised": sup_res["launches"]["tiled"],
        "max_abs_err": max_err["tiled"],
        # the 256-token tail, float32; ms per eager call, device time
        # through CUDA-graph replays beside it; int8 and the cold 512
        # prompt in the paged_attention row's by_shape
        "ms": t["ms"],
        "device_ms": t["device_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "bound_simt_ms": t["bound_simt_ms"],
        "library_ms": t["library_ms"],
        "library_device_ms": t["library_device_ms"],
        "budget_d64": {kv: budget["paged_tiled " + kv]
                       for kv in ("float32", "int8")}})
    for name, replaces, note in (
            ("fwd", 83, "scaled_dot_product_attention(is_causal=True)"),
            ("dq", 137, "autograd backward of that call: dq, dk and dv "
                        "together"),
            ("dkv", 186, "covered by the flash_dq row's library_ms")):
        ft = flash_t[name]
        kernels["kernels"].append({
            "name": "flash_" + name,
            "route": "cuda",
            "source": "tensorflowonspark_tpu_torch/csrc/flash_attention.cu",
            "replaces": "tensorflowonspark_tpu/ops/flash_attention.py:{}"
                        .format(replaces),
            "launches": flash_launches[name],
            # the same kernel's launches in phase 6's cluster-fed trainer
            "launches_cluster": clus["trainer"]["flash_launches"][-1][name],
            # and in phase 7's pipeline trainer (DDP, checkpoint, resume)
            "launches_pipeline": pipe["trainer"]["launches"][name],
            # and in phase 8: BERT-base training plus :predict
            "launches_models": zoo["bert"]["launches"][name] + (
                zoo["bert"]["predict"]["fwd_launches"] if name == "fwd"
                else 0),
            # phase 9: the streaming-fed trainer (float32) and the BERT
            # example's trainer (bfloat16), as each trainer counted them
            "launches_streaming": ex["streaming"]["flash_launches"][name],
            "launches_examples": ex["bert_example"]["flash_launches"][name],
            # phase 10: (a) the 4-way lockstep ring at S 8192, one call of
            # each schedule and dtype (forward and backward); (b) the
            # long-context example's launches a step, each run
            "launches_ring": {
                "lockstep_4way_s8192": {
                    key: r["launches"][name]
                    for key, r in par["ring"].items()},
                "longcontext_per_step": {
                    run: got["flash_launches_per_step"][name]
                    for run, got in par["longcontext"].items()}},
            # phase 15: the supervised trainers' launches summed over
            # attempts — (a) killed after step 5 and restored (12 layers,
            # 10 steps), (b) shrunk to one executor and regrown (2
            # layers, 10 steps over both executors)
            "launches_recovery": {leg: got[name] for leg, got in
                                  rec["launches"].items()},
            # the same kernel at BERT's shape (bfloat16, key mask, S 384)
            "bert_shape": zoo["bert"]["flash_timing"][name],
            # case (a), the main path's shape and dtype; every case below
            "max_abs_err": flash_err["a"][name],
            "max_abs_err_by_case": {c: e[name] for c, e in flash_err.items()},
            "ms": ft["ms"],
            "device_ms": ft["device_ms"],
            "plain_ms": ft["plain_ms"],
            "bound_ms": ft["bound_ms"],
            "bound_by": ft["bound_by"],
            "bound_simt_ms": ft["bound_simt_ms"],
            "library_ms": ft["library_ms"],
            "library_device_ms": ft["library_device_ms"],
            "library": note,
            # the kernel each dtype launches (bert_shape: bfloat16)
            "design": {
                "float32": "flash_{}_kernel<float>: mma.sync TF32, 3xTF32 "
                           "split, cp.async ring".format(name),
                "bfloat16": "flash_{}_wgmma_kernel: wgmma + TMA ring{}"
                            .format(name, ", live key tiles only"
                                    if name == "dq" else "")}})
    # phase 17's rows: the D-256 instantiations, launches from 17(b)'s
    # serving (paged) and 17(c)'s training (flash, float32)
    for name, route, shape, note in (
            ("paged_attention_split_d256", "split", "decode",
             "the split-KV route at D 256 (paged_split256_kernel: 8 keys in "
             "flight a warp, 16 at int8; the last CTA of each row and head "
             "merges the splits, no combine kernel); 17(b)'s decode "
             "steps"),
            ("paged_attention_tiled_d256", "tiled", "prefill",
             "the tensor-core tiled route at D 256 (paged_tiled_kernel<Q, "
             "256>: 32-key tiles, 4 partial sums of S), block 16; 17(b)'s "
             "prefills; the 256-token tail (the cold 512 prompt in "
             "by_shape)")):
        t = wide["paged_timing"][shape]["float32"]
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "tensorflowonspark_tpu_torch/csrc/paged_attention.cu",
            "replaces": "tensorflowonspark_tpu/ops/paged_attention.py:210",
            "launches": wide["route_launches"][route],
            "max_abs_err": wide["paged_err"][route],
            "ms": t["ms"],
            "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "bound_simt_ms": t["bound_simt_ms"],
            "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"],
            "note": note,
            # registers, spills, shared memory, CTAs per SM at D 256
            "budget": {kv: budget["paged_{} D256 {}".format(route, kv)]
                       for kv in ("float32", "int8")},
            "by_shape": {sh: wide["paged_timing"][sh]
                         for sh in wide["paged_timing"]
                         if wide["paged_timing"][sh]["float32"]["route"]
                         == route}})
    for name, replaces in (("fwd", 83), ("dq", 137), ("dkv", 186)):
        ft = wide["flash_timing"]["float32"][name]
        bt = wide["flash_timing"]["bfloat16"][name]
        kernels["kernels"].append({
            "name": "flash_{}_d256".format(name),
            "route": "cuda",
            "source": "tensorflowonspark_tpu_torch/csrc/flash_attention.cu",
            "replaces": "tensorflowonspark_tpu/ops/flash_attention.py:{}"
                        .format(replaces),
            # 17(c): the D-256 decoder's 10 training steps, float32
            "launches": wide["flash_launches"][name],
            # case g (float32, B 4 x S 1024 x 8 x 256, causal); h
            # (bfloat16), i and j (D 192 padded to 256) beside it
            "max_abs_err": wide["flash_err"]["g"][name],
            "max_abs_err_by_case": {c: e[name] for c, e in
                                    wide["flash_err"].items()},
            "ms": ft["ms"],
            "device_ms": ft["device_ms"],
            "plain_ms": ft["plain_ms"],
            "bound_ms": ft["bound_ms"],
            "bound_by": ft["bound_by"],
            "bound_simt_ms": ft["bound_simt_ms"],
            "library_ms": ft["library_ms"],
            "library_device_ms": ft["library_device_ms"],
            # the bfloat16 instantiation at the same shape (wgmma + TMA)
            "bfloat16": {k: bt[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms")},
            "design": {
                "float32": "flash_{}_kernel<256>: mma.sync 3xTF32, "
                           "one CTA of 8 warps a 64-row tile, {}".format(
                               name, {
                                   "fwd": "warp pairs on out's column "
                                          "halves summing their partial "
                                          "scores, 32-key tiles",
                                   "dq": "warp w S and P, warp w + 4 dP, "
                                         "each dS K on one column half, "
                                         "32-key tiles",
                                   "dkv": "a dV half and a dK half, P^T "
                                          "through shared memory, "
                                          "16-query tiles"}[name]),
                "bfloat16": {
                    "fwd": "flash_fwd_wgmma_pair_kernel<256>: wgmma + "
                           "TMA, two warpgroups over 128 query rows, each "
                           "S, softmax and P V of its own 64 rows over one "
                           "shared ring of 64-key K/V tiles that a third "
                           "warpgroup's warp refills; P V of a tile under "
                           "the next tile's softmax",
                    "dq": "flash_dq_wgmma_pair_kernel<256>: wgmma + TMA, "
                          "two warpgroups over 128 query rows, each S, "
                          "dP, dS and dQ of its own 64 rows over one "
                          "shared ring of 32-key K/V tiles",
                    "dkv": "flash_dkv_wgmma_pair_kernel<256>: wgmma + "
                           "TMA, two warpgroups a 64-key tile (S^T, P^T "
                           "and dV; dP^T, dS^T from that P^T and dK), "
                           "64-query Q/dO tiles"}[name]}})
    # phase 18's rows: the kernels of wide_attention.cu, launches from
    # 18(c)'s serving (paged: the split kernel also serves the window
    # route) and 18(d)'s training (flash, float32)
    for name, routes, shape, note in (
            ("paged_attention_split_wide", ("split", "window"), "decode",
             "decode and the verify window above head dim 256 "
             "(paged_wide_split_kernel<Q, QN>, CUDA cores: a CTA of 8 warps "
             "per 256 logical keys of a row and head and 1024 output "
             "columns, scores over all of D a warp a key; then "
             "paged_wide_combine_kernel merges the splits in order: two "
             "launches a call); 18(c)'s decode steps at 8 x 512"),
            ("paged_attention_tiled_wide", ("tiled",), "prefill",
             "prefill tails and cold prompts above head dim 256 "
             "(paged_wide_tiled_kernel<Q>: mma.sync 3xTF32, 64 queries and "
             "128 output columns a CTA, scores over D in 32-column "
             "chunks, 32-key tiles through the table, columns past D "
             "predicated); 18(c)'s prefills; the 256-token tail")):
        t = wider["paged_timing"][shape]["float32"]
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "tensorflowonspark_tpu_torch/csrc/wide_attention.cu",
            "replaces": "tensorflowonspark_tpu/ops/paged_attention.py:210",
            "launches": sum(wider["route_launches"][r] for r in routes),
            "max_abs_err": max(wider["paged_err"][r] for r in routes),
            "ms": t["ms"],
            "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "bound_simt_ms": t["bound_simt_ms"],
            "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"],
            "note": note,
            "head_dims": list(WIDER_DIMS),
            "budget": {k: v for k, v in wider["budget"].items()
                       if k.startswith(("paged_split", "paged_window")
                                       if shape == "decode"
                                       else ("paged_tiled",))},
            "by_shape": {kv: wider["paged_timing"][shape][kv]
                         for kv in wider["paged_timing"][shape]}})
    for name, replaces in (("fwd", 83), ("dq", 137), ("dkv", 186)):
        ft = wider["flash_timing"]["float32"][name]
        bt = wider["flash_timing"]["bfloat16"][name]
        kernels["kernels"].append({
            "name": "flash_{}_wide".format(name),
            "route": "cuda",
            "source": "tensorflowonspark_tpu_torch/csrc/wide_attention.cu",
            "replaces": "tensorflowonspark_tpu/ops/flash_attention.py:{}"
                        .format(replaces),
            # 18(d): the D-512 decoder's training steps, float32
            "launches": wider["flash_launches"][name],
            # the training shape (B 2 x S 1024 x 8 x 512, causal,
            # float32); every head dim's cases beside it
            "max_abs_err": wider["flash_err"]["train"]["t"][name],
            "max_abs_err_by_dim": {
                str(d): {c: e[name] for c, e in errs.items()}
                for d, errs in wider["flash_err"].items()},
            "ms": ft["ms"],
            "device_ms": ft["device_ms"],
            "plain_ms": ft["plain_ms"],
            "bound_ms": ft["bound_ms"],
            "bound_by": ft["bound_by"],
            "bound_simt_ms": ft["bound_simt_ms"],
            "library_ms": ft["library_ms"],
            "library_device_ms": ft["library_device_ms"],
            # the bfloat16 instantiation at the same shape
            "bfloat16": {k: bt[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms")},
            "budget": {dtype: wider["budget"]["{} wide {}".format(
                name, dtype)] for dtype in ("float32", "bfloat16")},
            "design": "flash_{}_wide_kernel<T>: mma.sync TF32 (3xTF32 at "
                      "float32, one pass on bfloat16 operands), one CTA of "
                      "4 warps over 64 {} and 128 output columns{}, scores "
                      "summed over D in 32-column chunks, 32-row tiles"
                      .format(name, "keys" if name == "dkv" else "queries",
                              " (dK and dV in CTAs of their own)"
                              if name == "dkv" else "")})
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as f:
            json.dump({"card": card, "kernels": kernels["kernels"],
                       "paged_timing": {
                           shape: {"float32": timing[shape][False],
                                   "int8": timing[shape][True]}
                           for shape in timing},
                       "flash_timing": flash_t,
                       "budget": budget,
                       "serving": {kv or "float32": {
                           k: v for k, v in r.items() if k != "out"}
                           for kv, r in runs.items()},
                       "preemption": preempt,
                       "training": train,
                       "cluster": clus,
                       "pipeline": pipe,
                       "models": zoo,
                       "examples": ex,
                       "parallel": par,
                       "generation": gen,
                       "planes": planes,
                       "fleet": fleet_res,
                       "supervised": sup_res,
                       "recovery": rec,
                       "tp_decode": tpd,
                       "wide": wide,
                       "wider": wider,
                       "seconds": time.monotonic() - t_start}, f, indent=1)
    log("total: {:.1f}s".format(time.monotonic() - t_start))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
