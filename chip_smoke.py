#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

or, to run some phases only (numbers of the list below; phase 1 always
runs, and phases 7 and 8 bring in phase 6, whose model they test), for
example the zoo's:

    python3 chip_smoke.py --phases 21,22,23

or the K5 slice's:

    python3 chip_smoke.py --phases 10,12,15

or the precision slice's (float16 kernels, f16, grad-accum, bf16_full,
ckpt-async and the exit test):

    python3 chip_smoke.py --phases 24,25,26,27,28,29,30,31

or the streaming loader's and ``--remat``'s:

    python3 chip_smoke.py --phases 36,37

or observability's and the kernel cache's:

    python3 chip_smoke.py --phases 38

or the phase of fault plans and elastic worlds:

    python3 chip_smoke.py --phases 39

or the phase of ``serve`` as an elastic world of replicas and the fleet
collector, and the front door's and the simulator's after it:

    python3 chip_smoke.py --phases 40,41

or the switch mixture-of-experts vit's (``--moe-experts``):

    python3 chip_smoke.py --phases 42

or placement over 'model', tensor and expert parallelism
(``--model-parallel`` without a ring, ``--tensor-parallel``):

    python3 chip_smoke.py --phases 43

or the GPipe vit and its ring over 'seq' (``--pipeline-parallel``,
``--seq-parallel``):

    python3 chip_smoke.py --phases 44

or the stacked block runs of ``--scan-layers`` (which bring in phase 43,
in whose world the stacked ring runs):

    python3 chip_smoke.py --phases 45

or the checkpoint directories of ``--ckpt-format orbax`` (which bring in
phase 43, in whose world they are first written):

    python3 chip_smoke.py --phases 46

A partial run skips no check within a phase it runs, ends with a line
naming the skipped phases, and never prints the last line of a full run.
It needs one CUDA card and the CUDA toolkit (``nvcc``); without a card,
or without the port's package beside it, it exits non-zero and prints no
result.  Phases, each printing its lines before the last:

  1. environment: the card's name and power limit (nvidia-smi), torch,
     CUDA, Triton and nvcc versions, and the time to build the kernels
     from ``distributedpytorch_tpu_torch/csrc``;
  2. kernel K1 (flash-attention forward) against its plain PyTorch version
     on the card, at the vit's shapes and at causal, wider-head and longer
     sequences: each case's route, and at a tensor-core case the scalar
     route too (forced); max abs error of O and lse against the stated
     tolerance, two calls bit-identical; kernel / scalar route / plain /
     SDPA (yardstick only) times — call time from CUDA events, and device
     time from torch.profiler, the median of 3 traces at the main shape
     and one trace elsewhere, where the plain version is not timed — and
     the bound;
  3. the main path: a full-width vit (dim 128, depth 4, 4 heads, S = 49,
     random weights from a seed) saved as a port checkpoint and served by
     ``python -m distributedpytorch_tpu_torch serve --attention flash`` in
     two subprocesses: three waves of 64 concurrent HTTP requests at a
     100 ms flush deadline (partial buckets served), and one wave of 64 at
     a 5 s deadline that must come back as one batch of bucket 64; every
     answer held against the in-process predict step at the bucket that
     served it (label, and confidence to 1e-4); each server's K1 launch
     count held against 4 x (batches + warm-up buckets), every one on the
     tensor cores; and the model's flash logits held against its
     full-attention logits;
  4. kernels K2 and K3 (flash-attention backward: delta and dq, and
     dk/dv) against their plain PyTorch version on the card, at the vit's
     training shapes and at causal, wider-head and longer sequences: each
     case's route, and at a tensor-core case the scalar route too
     (forced); max error of dq, dk and dv relative to the plain version's
     largest value against the stated tolerance, K2's delta against
     ``attention_delta``, two calls bit-identical; device / call / plain /
     SDPA-backward (yardstick only) times of K2, K3, the backward as the
     step runs it (K2 then K3) and the unfused backward
     (``attention_delta``, then the scalar K2 and K3), timed as in phase
     2, and the bounds;
  5. one full-width f32 train step (TF32 off) on the card against the
     same step on the CPU: same weights, batch and affine draws through
     ``Engine.train_step_affine``; every parameter's gradient compared,
     relative to its largest value; the step's K1/K2/K3 launches must be
     exactly 4 each;
  6. the main path of the training slice: ``python -m
     distributedpytorch_tpu_torch train --model vit --attention flash
     --dataset mnist -e 1`` in a subprocess, on the first 16,000 train and
     2,000 test rows of the synthetic corpus written as MNIST files (225
     steps of 64, then 25 validation batches; the run's time limit);
     validation accuracy at least twice chance, the mean train loss of
     the last 10% of steps below that of the first 10%, and the logged
     K1/K2/K3 launches equal to 4 per train step (K2, K3) and 4 per train
     step plus 4 per eval batch (K1), every one on the tensor cores;
  7. resume: ``train --debug -e 2`` uninterrupted, and again resumed from
     its epoch-1 rolling file; the final params and optimizer state must
     be bit-identical; beside the uninterrupted run,
  8. ``test -f`` on the best model of phase 6 in a subprocess; its
     accuracy must equal an in-process eval of the same checkpoint;
  9. a profile of the train step at batch 64, bf16: wall and device ms
     per step, kernels per step, the device's idle share, K1/K2/K3 time a
     step and a launch, and their launches a step (and how many on the
     tensor cores);
 10. kernel K5 (the conv weight gradient) against its plain PyTorch
     version at the cnn's three conv shapes at batch 1, 16 and 64 and a
     ragged shape, bf16 and f32, plus a bf16 shape that the route rule
     sends to the scalar kernel and a bf16 tensor-core shape with a ragged
     last chunk: each case's route, and at a tensor-core case the scalar
     route too (forced); error relative to the plain version's largest
     value, two calls bit-identical, device time (median, least and most
     of 3 traces at batch 64 bf16, one trace elsewhere) / call / plain
     (at batch 64 bf16 only) / ``conv2d_weight`` (cuDNN, yardstick only)
     times and the bound;
 11. one f32 train step (TF32 off) of the cnn with K5 and of resnet18 on
     the card against the CPU: gradients and BatchNorm statistics, and
     exactly 3 K5 launches for the cnn; the max pools' tie routing on the
     card against the CPU's;
 12. the slice's kernel main path: the first CNN_EPOCH_STEPS (211 of
     844) steps of 64 of an epoch of Engine-driven cnn training with K5,
     its counts set to 0 before and read after (3 per step, every one on
     the tensor cores), validation accuracy at least twice chance, the
     loss falling, and the same steps with the stock dW within the stated
     spread;
 13. the reference's job: ``torchrun --standalone --nproc_per_node 1 -m
     distributedpytorch_tpu_torch train`` with the default model (resnet
     at 224) on NCCL for one epoch of phase 22's corpus (10 steps), with
     ``train --debug`` of mlp and cnn beside it, then ``test -f`` on its
     best model (equal to an in-process eval);
 14. two ranks on the one card (gloo over CUDA tensors): three f32 steps
     of the cnn with K5 and of a resnet at reduced depth (and the resnet's
     in f64), held against one rank fed the same global batch and draws
     (all six worlds at once, each rank a ``tests/_torch_ddp_child.py``
     process, the child that ``tests/test_torch_ddp.py`` runs on the CPU);
 15. a profile of the cnn train step (batch 64, bf16), with K5's time a
     step and a launch inside it (resnet18's step: phase 35);
 16. kernels K4 (the ring's positional forward, f32 O and lse) and K2p/K3p
     (its backward, dO in f32, the lse cotangent folded into delta)
     against their plain PyTorch versions, bf16 and f32: the vit's ring
     shard at M = 2 (rank 1's queries against rank 0's and its own K/V,
     kv_valid 49), a block of padded keys only, causal blocks with rotated
     positions (one all masked), D = 128 and a 500-row shard; on each
     kernel's route and at a tensor-core case on the scalar route too
     (forced), errors of O and lse (rows with no key: O = 0 and lse =
     -1e30) and of dq/dk/dv with a nonzero dlse, K2p's delta against
     ``partial_delta``, two calls bit-identical; device / call / plain /
     SDPA with the same boolean mask (yardstick only; it returns no lse)
     times of K4 (both routes), K2p, K3p, the backward as the ring step
     runs it (K2p, which computes delta and rounds dO to bf16, then K3p)
     and the old line (``partial_delta``, then the scalar K2p and K3p),
     timed as in phase 2, and the bounds;
 17. the ring op on two ranks sharing the card (gloo over CUDA tensors,
     ``tests/_torch_ring_child.py``), ``ring`` and ``ring_flash``, against
     one process's ``full_attention`` and ``flash_attention`` on the
     gathered tensors: outputs and q/k/v gradients at the vit's S = 49 and
     at a causal S = 1000;
 18. the ring slice's main path: ``torchrun --nproc_per_node 2 ... train
     --model vit --attention ring_flash --model-parallel 2 -e 1`` on the
     first 7,000 train and 1,000 test rows of the synthetic corpus (50
     steps, 6 validation batches a rank; cut for time); validation at
     least twice chance, the loss falling, K4 launches 8 per step and eval
     batch, K2p and K3p 8 per step, every one on the tensor cores, K1-K3
     none; then, at once, ``test -f`` under the same launch and ``test -f
     --attention flash`` in one process (equal to an in-process flash eval
     of the file); the bf16 logits of every test row from ``ring_flash``
     on two ranks against flash's, within TOL_RING_OP's bf16 share of the
     largest logit, every row whose labels differ within that noise of a
     tie, and the ring's ``test`` within two rows more than those of
     flash's;
 19. three f32 SGD steps (TF32 off) of the full-width vit, the 2-rank
     ``ring_flash`` and ``ring`` worlds against one process with
     ``--attention flash`` on the same global batch and draws: every
     parameter, the loss and the counts;
 20. a profile of the ring_flash train step (two ranks, bf16, 128 rows a
     rank): wall and device ms per step, kernels per step, the idle
     share, K4/K2p/K3p time a step and a launch, their launches a step
     (and how many on the tensor cores), and the host copies of the gloo
     transport;
 21. the rest of the torchvision zoo on the card against the CPU:
     alexnet, vgg11_bn, squeezenet1_0, densenet121 and inception_v3 at
     full width and their canonical sizes (224; 299 for inception),
     batch 4, SEED's weights, the same augmented batch and dropout masks
     (those ``Engine.train_step`` draws), TF32 off: the f32 train-mode
     logits (and inception's aux logits), the gradients of one step in
     f64 compute (and in f32: alexnet's and squeezenet's against the
     CPU's, the BatchNorm models', whose f32 backward amplifies the
     devices' last-bit differences, against the card's own f64 step, no
     further than twice the CPU's f32 step) and the BatchNorm
     statistics;
 22. the zoo's main path: ``train --model X -e 1`` of the five on the
     first 704 train and 128 test rows of the synthetic corpus as
     MNIST files (10 steps of 64, 2 validation batches), with ``train
     --model resnet --use-pretrained --pretrained-path F
     --feature-extract`` (F a torchvision-layout resnet18 state_dict from
     ``tests/_torch_zoo.py``) beside them, six processes at once: every
     logged loss finite, the parameters moved, no kernel of the port
     launched, the pretrained backbone bit-identical to the file's and
     the head moved; then ``test -f`` on each best file (equal to an
     in-process eval) beside ``serve`` of inception's and vgg's, one wave
     of 16 concurrent requests each, every answer held against the
     in-process predict step at its bucket as in phase 3;
 23. profiles of four of the five train steps (densenet121's: phase 35;
     batch 64, bf16, cuDNN deterministic as ``train`` sets it, 5 steps
     under torch.profiler): wall and device ms per step, kernels per step,
     the idle share and the top device operations;
 24. kernels K1, K2, K3 (at the vit's (64, 49, 4, 32)) and K5 (at the
     cnn's three convs, batch 64) in float16, each on the tensor-core
     route and on the scalar route (forced), against the plain version
     within TOL_F16 (K5: TOL_DW) of the largest value, two calls
     bit-identical; the backward at a dO near float16's range, whose
     non-finite pattern must equal the plain version's; device / call /
     plain / float16 library (SDPA, SDPA's backward, cuDNN's wgrad;
     yardsticks only) times and the bounds;
 25. one full-width f16 vit step with flash at the loss scale 2^15, card
     against CPU, same weights, batch and affine draws: every gradient,
     the same skip decision and scale, and 4 each of K1/K2/K3 launched,
     all on the tensor cores;
 26. the overflow skip on the card: an f16 resnet (one block a stage, 224
     px) with Adam, a finite step, then an injected overflow: parameters,
     Adam state and BatchNorm buffers bit-unchanged, the step advanced,
     the scale halved;
 27. the f16 main path: ``train --model vit --attention flash --precision
     f16 -e 1`` on phase 18's corpus (99 steps; validation at least
     twice chance,
     the loss falling, K1/K2/K3 launches by phase 6's formula, all on the
     tensor cores, the skipped steps and final scale logged), ``test -f
     --precision f16`` equal to an in-process f16 eval, ``serve
     --precision f16`` (one wave of 16, every answer equal to the f16
     predict step); then the Engine-driven cnn with K5 in f16 (200 steps,
     3 K5 launches a step on the tensor cores);
 28. ``--grad-accum``: three f32 SGD steps (TF32 off) at K = 4 against K =
     1 on one global batch, for the vit with flash (K1 4 launches a
     microbatch) and the cnn with K5 (3 a microbatch); one f64
     accumulated step of a reduced resnet (chained BatchNorm) and of
     alexnet at 64 px (per-microbatch masks), card against CPU;
 29. ``bf16_full``: ``train --model resnet --precision bf16_full -e 1`` on
     phase 22's corpus (10 steps): bfloat16 parameters and f32 BatchNorm
     statistics in its checkpoint, finite losses, ``test -f`` equal to an
     in-process eval;
 30. ``--ckpt-async``: phase 7's runs with it: every checkpoint file of
     the uninterrupted run byte-identical to a synchronous run's, and the
     asynchronous resume bit-identical to the uninterrupted run;
 31. the accuracy exit test: ``train --model cnn --dataset synthetic_hard
     --synthetic-fallback -b 64 -e 2`` (Adam) for PARITY.json's five
     seeds, run at once beside phases 21, 22 and 25-30, then ``test
     -f`` on each best file: the mean test accuracy within 2.6 pp of the
     JAX mean,
     each seed printed beside JAX's;
 32. kernels K4, K2p and K3p in float16 at the ring's shard (128, 25, 4,
     32), on the tensor-core route and on the scalar route (forced),
     against the plain version (K4's f32 O within TOL_O_POS_TC, lse
     within TOL_LSE, dq/dk/dv within TOL_F16), two calls bit-identical;
     the backward at q, k scaled by 3 and dO near float16's range, whose
     non-finite pattern must equal the plain version's; device / call /
     plain / masked-SDPA (float16, yardstick only) times and the bounds;
 33. f16 on the ring: three f16 SGD steps of the full-width vit, the
     2-rank ``ring_flash`` world against one process with ``flash``
     (every update within TOL_F16_RING_UPDATE of its largest, the same
     loss, counts, scale and counters), and again with rank 1's second
     step overflowing (both ranks skip it); then ``torchrun
     --nproc_per_node 2 ... train --attention ring_flash
     --model-parallel 2 --precision f16 -e 1`` on phase 22's corpus: K4,
     K2p and K3p launches by phase 18's formula, all on the tensor cores,
     finite losses and the loss-scale line;
 34. ``train -f`` on a JAX-written file: phase 13's cnn (``train --debug
     -e 1`` on the card), its rolling file written again in the JAX
     package's msgpack format by ``tests/_torch_jax_ckpt.py`` (the
     converter test's torch writer; no JAX here), and ``train -f`` on both
     files to epoch 2: the two resumed runs bit-identical;
 35. ``--epochs-per-dispatch`` as CUDA Graph replay: the vit with flash
     in bf16 and in f16, the cnn with K5, resnet18 and densenet121, full
     width, batch 64, four epochs one at a time and as two chunks of two
     (the steps captured and replayed), held bit-identical in parameters,
     statistics, optimizer state, counters, loss scale, every epoch's sums
     and the launch counts; each path's train step profiled (wall and
     device ms, kernels a step, the idle share, the port's kernels a step
     from the trace, the MFU at the step's wall against the card's peak
     for the run's type); and ``train --model vit --attention flash --debug
     -e 4`` with and without ``--epochs-per-dispatch 2``: the same log
     lines and the epoch-4 rolling file byte-identical;
 36. the streaming loader (``--data-mode stream``): the Engine-driven cnn
     with K5 for STREAM_CNN_STEPS steps from the streaming loader against
     the resident one (every step's loss and the final state
     bit-identical, K5 3 a step on the tensor cores, counts set to 0 just
     before each); the vit (flash) and resnet18 at 224 train steps at
     batch 64 fed by the resident loader and by the streaming one with no
     producer thread and with one (the CLI's default): wall ms a step
     over 5 steps in two rounds of the three, the second in the reverse
     order, and over 5 steps under torch.profiler the device ms, the idle
     share, bytes copied to the card a step, whether the copies overlap
     kernels in the trace, and the telemetry's data/wait_s and
     data/starved_steps; then through the CLI ``train
     --model vit --attention flash -e 1`` on phase 18's corpus with
     ``--data-mode resident``, ``stream`` and ``stream --producer-threads
     3 --device-prefetch 2`` (the same log lines, launch lines and
     rolling file byte for byte; launches by phase 6's formula, all on the
     tensor cores), ``test -f --data-mode stream`` equal to the resident
     test, ``train --debug -e 1 --data-mode stream`` under torchrun on
     NCCL, and ``--epochs-per-dispatch 2 --data-mode stream`` failing
     with JAX's message;
 37. ``--remat none|blocks|full``: one Adam step (bf16, batch 64) of the
     vit with flash at full width, densenet121 and resnet18 at 224 and the
     cnn with K5 under each setting, the updates, BatchNorm statistics and
     loss bit-identical across the three, the launches by formula (the
     vit's K1 8 a step under remat, K2/K3 4; K5 3), the peak memory
     (``torch.cuda.max_memory_allocated``) and the device time of a step;
     then the vit under ``--remat blocks``, two epochs on phase 35's 320
     rows eager and as one graphed chunk of two, bit-identical;
 38. observability and the kernel cache: in process, (f) an anomaly
     capture (``flightrec.AnomalyDetector``) around real vit steps, one
     of them slowed on the host: the capture's trace holds K1, K2 and
     K3 and its manifest names the trigger; (g) the instrumentation's
     cost, the vit's eager train pass (phase 35's 320 rows, 5 steps)
     with the defaults (flight recorder on), ``--no-flightrec`` and
     everything on, wall ms a step in two rounds and device ms a step,
     with the MFU at that wall; (h) a graphed vit chunk traced and read
     by the roofline (the replayed kernels costed, or the report's
     warning that Kineto did not record them); then in the background ``train --model
     vit --attention flash --debug -e 2 --telemetry --profile
     --anomaly-capture --aot-warmup`` (a) with ``--metrics-port`` on a
     fresh ``--compilation-cache-dir`` (cache_hit 0, /metrics and
     /healthz scraped while it runs), then (b) over the same directory
     (cache_hit 1, a smaller warmup_s, no new file), (c) with
     ``--no-compile-cache`` (nothing left in its TMPDIR, build/kernels
     untouched) and (d) the plain train: (a)'s epoch lines, launch lines
     and epoch-2 rolling file equal to (d)'s, launches by phase 6's
     formula, all tensor-core; (e) (a)'s trace holds device kernels,
     roofline.json names K1, K2 and K3 with FLOPs, bytes and an analytic
     bound class, ``throughput/mfu`` is non-null against the bf16 peak,
     and ``telemetry``, ``goodput``, ``timeline`` and ``roofline`` exit 0
     on its directory;
 39. fault plans, the bounded health agreement and elastic worlds, all
     with the full-width vit (``--attention flash``, bf16, ``--debug``)
     through the CLI: (a) one rank under ``--fault-plan
     data.read:ioerror:0:2;ckpt.save:preempt:1;ckpt.finalize:torn:1``
     (two reads retried, a SIGTERM and a torn write at epoch 0's best
     file: a clean preemption after epoch 1), then ``-f`` the torn file:
     the fallback to the epoch-0 snapshot, and the final checkpoint's
     every tensor and count equal to a fault-free run's, K1-K3 on the
     tensor cores; (b) three rank processes on the one card over gloo
     with ``--elastic --data-mode stream -b 16``, ``rank_loss`` on rank
     2 in epoch 1 (exit 113): ranks 0 and 1 reconfigure to a world of 2,
     resume at epoch 1 and launch K1-K3 by phase 6's formula, all on the
     tensor cores, read from each rank's ``kernel_launches`` telemetry
     event; (c) once the shrink shows in rank 0's telemetry a fourth
     process with ``--elastic-join`` is admitted at a boundary and the
     world grows back to 3 (every rank again K1-K3 on the tensor cores);
     the 2-rank world's parameters against an uninterrupted 2-rank run
     from the same epoch-0 snapshot, the grown world's final ones
     against a 3-rank run from the grow's snapshot (1e-5), and goodput's
     ``collective_skew`` and ``elastic_reconfigure`` of ranks 0 and 1;
     (d) two ranks, rank 0 stalled 8 s in its first save under
     ``--health-timeout 3``: rank 1 has ``HealthTimeoutError`` within
     3-5 s of its last event and both exit 1.  It runs on a thread of its
     own from after phase 22, beside the other CLI phases;
 40. ``serve`` as an elastic world of replicas: the full-width vit
     (``--attention flash``, bf16) from a port checkpoint A, two replicas
     as a 2-rank ``--elastic`` gloo world on the one card, each on
     ``--serve-port`` + its rank with ``--metrics-port`` and the flight
     recorder, and a ``fleet`` collector under an error-rate
     ``--slo-spec``; every wave a full bucket of 64 (one batch at a 5 s
     flush deadline, so the fault plan's batch counts are known): (a)
     concurrent waves to both replicas, each replica's K1 launches read
     from its telemetry gauges on ``/metrics`` and held to 4 x (batches +
     warm-up buckets), all on the tensor cores, then a wave to replica 0
     from clients that connect and send with one ``sendall`` each; (b) ``/admin/reload`` to
     a second checkpoint B (another seed) on replica 0, the lineage sha
     changed on ``/livez`` and in the exporter's ``/healthz`` ``serve``
     block, and a wave of B's answers; (c) no incident over the clean
     traffic, then a ``serve.infer`` ioerror burst of two waves sent
     together to replica 1 (two batches back to back, one episode
     however slow the host): exactly one incident bundle, naming rank 1
     and at least a batch of its failed request ids; (d) a ``serve.infer`` ``rank_loss`` on replica 1:
     replica 0 logs ``elastic/reconfigure`` with ``purpose: "serve"`` and
     a world of 1, answers on the same port with B's predictions, the
     fleet's ``dpt_up`` drops to 1, and SIGTERM drains it to exit 0, its
     K1 launches held to 4 x (batches + 3 builds x warm-up buckets); each
     request's ``admit()`` offset from its wave's first send (ROADMAP
     queue 3 entry 4), the swap's warm-up and ``elastic_reconfigure``
     printed.  Every answer is held against the in-process predict step
     of its checkpoint at its bucket (label, and confidence to 1e-4) at
     the end of the run, when no other phase counts launches.  It runs
     on a thread of its own from before phase 21, beside phase 21;
 41. the fleet's front door and the simulator, on phase 40's thread after
     it (``--phases 41`` brings in 40): phase 40's checkpoints A and B
     copied into one directory whose lineage ledger names A alone; two
     replicas of A as a fresh 2-rank ``--elastic`` gloo world on the one
     card with ``--metrics-port``, and ``python -m
     distributedpytorch_tpu_torch frontdoor`` in front of them with
     ``--rollout`` over that ledger and ``--autoscale --min-world 2``,
     its ``--launch-cmd`` replica 1's ``--elastic-join`` command on B;
     every wave 128 concurrent requests to the front door's one port,
     which its least-pending pick splits into a full bucket of 64 a
     replica: (a) two waves, every answer 200 with ``X-DPT-Request-Id``
     and ``X-DPT-Upstream``, both replicas answering, each replica's K1
     launches from its ``/metrics`` held to 4 x (batches + warm-up
     buckets), all on the tensor cores; (b) B enters the ledger: the
     front door canaries it on replica 0, a wave is answered by B there
     and A on replica 1, and after a 2 s hold B is promoted to both; a
     wave of B; (c) half a wave queued on each replica (5 s flush), then
     SIGKILL of replica 1: every request answered 200 by replica 0
     through the retry-once path, slot 1 ejected, one ``min_world``
     scale-up launching the join command, the joiner back at rank 1 of
     2 on its old port serving B (``/livez``) and answering a wave; the
     times from the kill to the ejection, to the joiner's readmission
     and to its first answer printed; the front door and replica 0 exit
     0 on SIGTERM and the joiner with them; (d) ``sim --scenario
     control`` twice on the host (no device), started with the phase:
     zero scale actions, zero incidents, equal ``event_log_sha256``.
     Every answer is held against the in-process predict step of the
     checkpoint its upstream served (label, and confidence to 1e-4) at
     the end of the run, with phase 40's;
 42. the switch mixture-of-experts vit (``--moe-experts 8``, full width,
     batch 64: 16 rows a dispatch group, capacity 123): (a) in process,
     one f32 train step (TF32 off) with flash on the card against the
     CPU's from one CPU generator's weights, every gradient within
     TOL_STEP_GRAD and the sown load-balance loss within 1e-5, each
     layer's routes equal wherever the CPU's top-2 router probabilities
     lie more than MOE_MARGIN apart (the tokens below it printed), then a
     bf16 step by the conditioned rule (each gradient within TOL_GRAD of
     the CPU's, or no further from the f32 step than twice the CPU's;
     its routes printed: its router inputs differ by bf16 roundings),
     K1, K2 and K3 4 a step each, all on the tensor cores, and the device
     ms of the bf16 step beside the dense vit's from a ``_device_trace``
     (printed, not a gate); (b) two epochs of MOE_GRAPH_ROWS rows eagerly
     and as one graphed chunk of two (``--epochs-per-dispatch 2``),
     bit-identical; (c) in the background beside the other CLI phases,
     ``train --model vit --attention flash --moe-experts 8 -e 1`` on phase
     22's corpus (K1-K3 by phase 6's formula, all on the tensor cores,
     finite losses), then ``test -f`` equal to an in-process eval and
     (d) in process a ``serving.ServingTier`` over its best file
     answering one wave of 64 in one batch, every answer equal to the
     predict step of the batch the tier formed (label, and confidence to
     TOL_CONF).  (a) and (b) run before phase 21 with the other timed
     in-process phases, (c) and (d) after 38's checks;
 43. placement over 'model' (``--model-parallel 2`` with no ring),
     tensor parallelism and expert parallelism, two ranks on the card
     over gloo (data 1 x model 2), on a thread of its own beside the other
     CLI phases: (a) ZeRO with ``--attention flash``, (b) the MoE vit
     (``--moe-experts 8``, expert parallel) and (c) ``--tensor-parallel
     --attention full``, each as a 2-rank world of
     ``tests/_torch_ring_child.py`` taking 3 f32 SGD steps of a global
     batch of 64 against one process fed the same batches (max abs and
     worst relative error printed, TOL_P43), with each rank's parameter
     and momentum elements held to the JAX rule's count for (a) and (b)
     and each rank's ``torch.cuda.max_memory_allocated`` of a step against
     one process's for (c); then (a) and (b) through the CLI on phase 22's
     corpus: ``train -e 1 --model-parallel 2`` in bf16 under torchrun, K1,
     K2 and K3 on each rank by phase 6's formula from its telemetry, all
     on the tensor cores, the ``mesh:`` line naming what the model group
     carries; at once ``test -f`` of the best file on 2 ranks equal to an
     in-process eval, and a 1-process ``train -f`` resume of it;
 44. the GPipe vit (``--pipeline-parallel``) and its ring over 'seq'
     (``--seq-parallel``), no kernel of the port on either, as in JAX:
     (a) the full-width ``PipelinedViT`` on two ranks on the card over
     gloo (data 1 x model 2) at M = 2 and M = 4 microbatches and (b) with
     ``--attention ring --seq-parallel 2`` on four (1 x 2 x 2; 49 tokens
     padded to 50), each a world of ``tests/_torch_pipeline_child.py``
     taking 3 f32 SGD steps of a global batch of 64 against one process
     running the blocks in order on the same batches and weights (max abs
     and worst relative error printed, TOL_P44), every rank equal, a
     rank's parameter and momentum elements held to the JAX rule's count
     (``leaf_spec(prefer_axis0=True)``), K1-K5 and K4/K2p/K3p launched 0
     times on every rank; a bf16 step's device time a rank beside the
     dense vit's (printed, not a gate); (c) through the CLI on phase 22's
     corpus: ``train --pipeline-parallel --model-parallel 2 -e 1`` in bf16
     under torchrun (finite losses, the ``mesh:`` line, no launch), then
     at once ``test -f`` of its best file in one process on a plain config
     (stacked -> blocks at load) and on 2 ranks with the pipeline flags,
     each equal to an in-process eval of the pipelined model.  It runs on
     43's thread after it;
 45. ``--scan-layers`` (the stacked vit, vgg, densenet and inception,
     ``models/scan.py``): (a) in process, cuDNN deterministic, the
     full-width stacked vit (``blocks.block.*``) with ``--attention
     flash`` against the unrolled vit from SEED's weights: 3 f32 Adam
     steps of 64 rows, every tensor bit-identical or within TOL_SCAN
     (the number of differing tensors and the worst error printed), K1,
     K2 and K3 4 a step each; a bf16 step's launches 4/4/4, all on the
     tensor cores, and its device time (median of 3 traces), wall time
     and kernels a step beside the unrolled vit's (printed, not a gate);
     (d) then
     densenet121 at 224: one SGD step of 16 rows stacked against
     unrolled in f64 compute within TOL_SCAN_F64, and in f32 by the
     conditioned rule against the unrolled f64 step, then a bf16 Adam
     step at batch 64, its device time and the step's own peak
     ``max_memory_allocated`` beside the unrolled one's (printed); (b) in
     phase 43's zero world (2 ranks, data 1 x model 2, the state placed
     by ZeRO), the ``ring_flash`` vit stacked and unrolled, 3 bf16 SGD
     steps each: the stacked run's state bit-identical to the unrolled
     one's, K4, K2p and K3p 8 a step each on both, all on the tensor
     cores; (c) on a thread of its own started with 43's, ``train
     --model vit --attention flash --scan-layers -e 1`` on phase 22's
     corpus (K1-K3 by phase 6's
     formula, all on the tensor cores, the best file in the scan
     layout), then ``test -f`` of it on a plain config (scan -> blocks at
     load) equal to an in-process eval, and in process ``serve
     --scan-layers``'s replica in a ``serving.ServingTier`` answering one
     wave of 64 in one batch, every answer equal to the stacked model's
     predict step of that batch.  (a) and (d) run before phase 21 with
     the other timed in-process phases;
 46. ``--ckpt-format orbax`` (checkpoint directories on
     ``torch.distributed.checkpoint``, each rank writing its own slices):
     (a) in phase 43's zero world, a directory saved after 2 of its 3
     f32 SGD steps with ``Placement.join`` and ``full_state`` made to
     raise, each rank's payload bytes printed against the prediction
     (every chunk of a sharded tensor in its rank's file, every element
     once), restored in one process with no placement for the last step:
     parameters, momentum and counters bit-identical to the world's after
     3 steps, and read back by the world with no gather, bit-identical
     to what it saved; (b) on 45 (c)'s thread after it, ``train
     --model vit --attention flash --model-parallel 2 --ckpt-format orbax
     -e 1 --telemetry`` under torchrun on phase 22's corpus (K1-K3 on each
     rank by phase 6's formula, all on the tensor cores; the best
     directory's payload as in (a), Adam's), then at once ``test -f`` of
     it in one process equal to an in-process eval, a 1-process ``train
     -f`` resume, and in process ``serve -f``'s replica in a
     ``serving.ServingTier`` answering one wave of 64 in one batch, every
     answer equal to the predict step of that batch; (c) beside (b)'s
     train, 1-process trainings with and without ``--ckpt-async``, their
     directories read back bit-identical, no ``.tmp`` left;
 47. the card's name and power limit again, one ``{"kernels": [...]}``
     JSON line (the float16 variants of all seven kernels as their own
     entries), then the last line ``{"ok": true, "device": {...}}``.

Phases run in the order of their numbers but for these changes: 23, 24,
32, the in-process parts of 35, 36, 38, 42 and 45, and 37, which time
steps and kernels, run before 21; the exit test's five trainings (31) and 38's
five CLI trainings start then and run beside 21, 22 and 25-36, and 40's
world of replicas, then 41's, beside 21; 39's thread starts after 22;
phase
33's three f16 worlds start with phase 19's; the CLI runs of 18, 27, 29,
30, 33, 34, 35, 36 and 42 start after 22 and run beside 25, 26 and 28 (18's
and 36's trainings are checked after 28, 36's tests then run beside 18
and 27-35); the test of 29 and the resume of 30 run beside 27; 33, 34,
35, 36 and 38's last checks, then 42's, 43's and 44's, 39's, 40's and
41's, come last; 43's thread, which runs 44 after 43 (45's stacked ring
and 46 (a) inside 43's zero world), and the thread of 45's CLI runs, then
46's, start with the CLI runs of 42.  Nothing after 38's
in-process
part is timed for the kernels line (38's CLI runs time their warm-ups
beside the other background runs).  Each phase prints its wall time.
Any failed check exits non-zero before
the last line is printed.  Work files go to ``build/chip_smoke/`` in the
checkout, and the bytecode of the modules that the run's processes import
to ``build/pycache/``.  Child processes run with CHILD_THREADS intra-op
threads each (``OMP_NUM_THREADS``, unless it is set).
"""

from __future__ import annotations

import itertools
import json
import math
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import functools
import hashlib
import shlex
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SEED = 1234
BUCKETS = (1, 4, 16, 64)
DEPTH = 4                       # vit blocks: one K1 launch each per forward
BURST_THREADS = 64              # concurrent clients: one wave fills bucket 64
BURST_WAVES = 3                 # requests per client in the main burst
# The flush deadline of the main burst's server: partial buckets are
# served, and every answer is held against the predict step at its bucket.
FLUSH_MS = 100
# A second server answers one wave of 64 at this deadline, which must come
# back as one batch of bucket 64.  A wave's 64 requests reach the batcher
# one connection at a time, and at 100 ms one run of three waves served
# none of them in bucket 64 (27 batches; ROADMAP queue 3): the deadline
# has to outlast a wave's spread.  A full bucket dispatches at once.
FILL_FLUSH_MS = 5000
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12,   # dense, 700 W
                  "float32": 67e12}
TOL_O = {"bfloat16": 2e-2, "float32": 2e-5}   # bf16: one output rounding
TOL_LSE = 1e-4                                # f32 in both
# Served answers against the in-process predict step at the same bucket:
# the same program on the same card, so the only difference expected is
# the server's rounding of the confidence to 6 decimals (5e-7).
TOL_CONF = 1e-4
TOL_LOGITS = {"float32": 1e-4, "bfloat16": 5e-2}
SOURCES = ("flash_fwd", "flash_bwd", "conv_dw")  # csrc/<name>.cu, together
CSRC = "distributedpytorch_tpu_torch/csrc"
TPU_KERNELS = "distributedpytorch_tpu/ops/flash_attention.py"
KERNELS = (  # name, source, the TPU kernel it replaces
    ("flash_fwd", f"{CSRC}/flash_fwd.cu", f"{TPU_KERNELS}:79"),
    ("flash_dq", f"{CSRC}/flash_bwd.cu", f"{TPU_KERNELS}:189"),
    ("flash_dkv", f"{CSRC}/flash_bwd.cu", f"{TPU_KERNELS}:236"),
    ("conv_dw", f"{CSRC}/conv_dw.cu", "distributedpytorch_tpu/ops/conv.py:92"),
    # the same three Pallas kernels with use_pos=True, reached through
    # flash_attention_partial (:373) and its backward (:400)
    ("flash_fwd_pos", f"{CSRC}/flash_fwd.cu", f"{TPU_KERNELS}:79"),
    ("flash_dq_pos", f"{CSRC}/flash_bwd.cu", f"{TPU_KERNELS}:189"),
    ("flash_dkv_pos", f"{CSRC}/flash_bwd.cu", f"{TPU_KERNELS}:236"),
)
# their float16 variants: the same kernels at the vit's, the cnn's and
# the ring's shapes under --precision f16
F16_KERNELS = tuple((name + "_f16", source, replaces)
                    for name, source, replaces in KERNELS)
# K2/K3 against their plain version: max error relative to the plain
# version's largest value.  f32: the same f32 math in another summation
# order.  bf16: one rounding of the output.
TOL_GRAD = {"bfloat16": 2e-2, "float32": 1e-5}
# One full-width f32 train step on the card against the CPU, each
# parameter's gradient relative to its largest value: f32 sums in other
# orders through four blocks (cuBLAS and cuDNN against the CPU's kernels,
# TF32 off), measured at 1e-6..1e-5.
TOL_STEP_GRAD = 1e-4
TRAIN_BATCH = 64
MAIN_ATTN = (64, 49, 4, 32, "bfloat16", False)   # the vit's attention call


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_SAY_LOCK = threading.Lock()


def say(msg: str) -> None:
    """One line of the run's output, whole: the side threads' phases
    print beside the main thread's."""
    with _SAY_LOCK:
        print(msg, flush=True)


# -- phase 1: environment ------------------------------------------------

def phase_environment():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}; bytecode cache "
        f"{os.path.relpath(sys.pycache_prefix, ROOT)}")
    try:
        import triton

        say(f"env: triton {triton.__version__}")
    except ImportError:
        say("env: triton not installed")
    from distributedpytorch_tpu_torch.ops import build

    try:
        nvcc = build.nvcc_path()
    except RuntimeError as e:
        fail(str(e))
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
    say("env: nvcc " + (ver.stdout.strip().splitlines() or ["?"])[-1])
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(build.build, SOURCES))
    say(f"build: {', '.join(SOURCES)} in {time.perf_counter() - t0:.1f}s")
    for name, (lib, compile_s) in zip(SOURCES, built):
        say(f"build: {name} nvcc {compile_s:.1f}s -> "
            f"{os.path.relpath(lib, ROOT)}")
        with open(lib + ".log") as f:
            report = f.read().splitlines()
        names = kernel_names(report)
        kernel = ""
        for line in report:
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                kernel = names.get(m.group(1), m.group(1))
            if "registers" in line or "spill" in line:
                say(f"build: {name}: {kernel}: " + line.strip())
    return card


def kernel_names(report: list) -> dict:
    """The mangled kernel names of ptxas' report -> short demangled ones
    (``flash_dq_mma_kernel<32>``), by ``c++filt`` where it exists."""
    mangled = sorted({m.group(1) for line in report for m in
                      [re.search(r"Function properties for (\S+)", line)]
                      if m})
    filt = shutil.which("c++filt")
    if not mangled or filt is None:
        return {}
    out = subprocess.run([filt], input="\n".join(mangled),
                         capture_output=True, text=True).stdout.splitlines()
    if len(out) != len(mangled):
        return {}
    short = [re.sub(r"^void |\(anonymous namespace\)::", "", n)
             for n in out]
    return {m: n[:n.index("(")] if "(" in n else n
            for m, n in zip(mangled, short)}


# -- phase 2: K1 against its plain version --------------------------------

def time_ms(fn, reps: int = 50) -> float:
    """Mean ms per call over ``reps`` back-to-back calls, CUDA events,
    after warm-up.  Inputs stay in L2 between calls, as in the vit, where
    the qkv projection has just written them."""
    import torch

    for _ in range(3):
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


# Small kernels that open every trace of _device_trace, ahead of a marker.
# A trace taken after other torch.profiler sessions in the process can come
# back without its first device events, which were the first function's:
# on an H100 SXM at 700 W a full run (after phases 3, 9, 10 and 15) read
# K4's tensor-core route at 3.9 us at the ring shard and 3.1 us at the
# 500-row shard, partial runs 6.0 and 30.5 (about 18 of 50 and 18 of 20
# launches missing); the scalar K4, the first function until then, read
# 19.6 against 36.4.  The lead-in takes the loss.
LEAD_IN = 64


def _device_trace(fns: dict, reps: int):
    """One torch.profiler session over ``reps`` back-to-back calls of each
    function of ``fns`` (name -> callable), after LEAD_IN small kernels, a
    ``torch.cuda._sleep`` kernel marking the boundary before each
    function: the mean device time per call of each (the summed duration
    of the CUDA work it launches, the device events in start order on the
    one stream split at the markers), or None when the trace lacks a
    marker or a function's events.  Says how many lead-in events the
    trace lost, when it lost any."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lead = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN):
            lead.add_(1.0)
        for fn in fns.values():
            torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)),
                    key=lambda e: e.time_range.start)
    groups = [[]]
    for e in events:
        if "spin_kernel" in e.name:
            groups.append([])
        else:
            groups[-1].append(e.time_range.elapsed_us())
    lost, groups = LEAD_IN - len(groups[0]), groups[1:]
    if lost:
        say(f"trace: {lost} of {LEAD_IN} lead-in events missing")
    if len(groups) == len(fns) and all(groups):
        return {n: sum(g) / 1e3 / reps for n, g in zip(fns, groups)}
    return None


def device_ms_tries(fns: dict, reps: int = 50, tries: int = 3) -> dict:
    """The device time per call of each function of ``fns`` in each of
    ``tries`` traces, after warm-up: name -> the list of the traces that
    had every function's events (empty when none had); ``spread`` gives
    their median, least and most."""
    import torch

    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    got = [t for t in (_device_trace(fns, reps) for _ in range(tries)) if t]
    return {n: [t[n] for t in got] for n in fns}


def timing_tries(main: bool) -> int:
    """Traces a time is taken from: the median of 3 at a kernel's main
    shape, one at a side shape."""
    return 3 if main else 1


def timing_note(main: bool) -> str:
    return ("main shape, device_ms median of 3 traces" if main
            else "side shape, device_ms of 1 trace, plain not timed")


def times_text(dev: dict, call: dict) -> str:
    """``device_ms a=.. b=..; call_ms a=.. b=..`` of one case's functions
    (a space in a name becomes _)."""
    return ("device_ms " + " ".join(f"{n.replace(' ', '_')}={fmt_ms(t)}"
                                    for n, t in dev.items())
            + "; call_ms " + " ".join(f"{n.replace(' ', '_')}={t:.5f}"
                                      for n, t in call.items()))


def spread(times: list) -> tuple:
    """(median, least, most) of a list of times; Nones when empty."""
    if not times:
        return None, None, None
    t = sorted(times)
    return t[len(t) // 2], t[0], t[-1]


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.5f}"


def device_kernels(prof) -> list:
    """The profiler's device-side averages, kernels and copies only: a
    user annotation's GPU range (``Optimizer.step#Adam.step``) spans
    kernels already counted and is left out."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def bound_ms(b: int, s: int, h: int, d: int, dtype_name: str,
             causal: bool):
    """Least time for the work: each input read once and each output
    written once over HBM, or the two products' operations at the card's
    peak for the input type, whichever is larger."""
    item = 4 if dtype_name == "float32" else 2
    nbytes = 4 * b * s * h * d * item + b * h * s * 4     # q, k, v, o, lse
    pairs = s * (s + 1) / 2 if causal else s * s
    ops = 4 * b * h * pairs * d                           # QK^T and PV
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel():
    """K1 against its plain version: each case on the route the rule
    picks and, at a tensor-core case, on the scalar route too (forced),
    both held to TOL_O / TOL_LSE; two calls bit-identical; device / call
    times of both routes beside SDPA's (and the plain version's at the
    main shape) and the bound."""
    import torch
    import torch.nn.functional as F

    from distributedpytorch_tpu_torch.ops import flash_attention as tfa
    from distributedpytorch_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_plain)

    cases = [(1, 49, 4, 32, dt, False) for dt in ("bfloat16", "float32")]
    cases += [(b, 49, 4, 32, "bfloat16", False) for b in (4, 16)]
    cases += [(64, 49, 4, 32, dt, False) for dt in ("bfloat16", "float32")]
    cases += [(64, 49, 4, 32, "bfloat16", True)]
    for s, d in ((128, 64), (128, 128), (1000, 64), (1000, 128)):
        for dt in ("bfloat16", "float32"):
            for causal in (False, True):
                cases.append((8 if s == 128 else 2, s, 4, d, dt, causal))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    for (b, s, h, d, dt, causal) in cases:
        dtype = getattr(torch, dt)
        # q, k, v as views into one (B, S, 3*H*D) projection, as in the vit
        qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                          device="cuda").to(dtype)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
        tc = tfa._pick_route(None, (q, k, v), kernel="K1")
        route = "tensor_core" if tc else "scalar"
        before = (flash_attention_fwd.launches,
                  flash_attention_fwd.tensor_core_launches)
        o, lse = flash_attention_fwd(q, k, v, causal)
        o2, lse2 = flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        if (flash_attention_fwd.launches,
                flash_attention_fwd.tensor_core_launches) != (
                before[0] + 2, before[1] + 2 * tc):
            fail(f"K1 wrapper did not count its {route} launches at "
                 f"{(b, s, h, d)} {dt}")
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            fail(f"K1's {route} route is not deterministic at "
                 f"{(b, s, h, d)} {dt} causal={causal}")
        checked = {route: (o, lse)}
        if tc:
            checked["scalar"] = tfa._launch(q, k, v, causal,
                                            tensor_core=False)
        po, plse = flash_attention_plain(q, k, v, causal)
        errs = {}
        for r, (x_o, x_lse) in checked.items():
            errs[r] = ((x_o.float() - po.float()).abs().max().item(),
                       (x_lse - plse).abs().max().item())
            if not (math.isfinite(errs[r][0]) and errs[r][0] <= TOL_O[dt]
                    and errs[r][1] <= TOL_LSE):
                fail(f"K1's {r} route disagrees with its plain version at "
                     f"{(b, s, h, d)} {dt} causal={causal}: err_o "
                     f"{errs[r][0]} (tol {TOL_O[dt]}), err_lse {errs[r][1]} "
                     f"(tol {TOL_LSE})")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        reps = 50 if s < 1000 else 20
        main = (b, s, h, d, dt, causal) == MAIN_ATTN
        fns = {"kernel": lambda: flash_attention_fwd(q, k, v, causal),
               "sdpa": lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal)}
        if tc:
            fns["scalar"] = lambda: tfa._launch(q, k, v, causal,
                                                tensor_core=False)
        if main:
            fns["plain"] = lambda: flash_attention_plain(q, k, v, causal)
        call = {n: time_ms(f, reps) for n, f in fns.items()}
        dev = {n: spread(t)[0] for n, t in
               device_ms_tries(fns, reps, timing_tries(main)).items()}
        b_ms, b_by = bound_ms(b, s, h, d, dt, causal)
        say(f"K1 {(b, s, h, d)} {dt} causal={causal}, {route} route: "
            + "; ".join(f"{r} err_o={e[0]:.3g} err_lse={e[1]:.3g}"
                        for r, e in errs.items())
            + f" (tol {TOL_O[dt]:g}, {TOL_LSE:g}), bit-identical; "
            f"{timing_note(main)}: " + times_text(dev, call)
            + f"; bound_us={b_ms * 1e3:.3f} ({b_by}) launches="
            f"{flash_attention_fwd.launches} (tensor-core "
            f"{flash_attention_fwd.tensor_core_launches})")
        rows[(b, s, h, d, dt, causal)] = dict(
            max_abs_err=errs[route][0], ms=dev["kernel"],
            plain_ms=dev.get("plain"), library_ms=dev["sdpa"],
            bound_ms=b_ms, bound_by=b_by, call_ms=call["kernel"],
            plain_call_ms=call.get("plain"), library_call_ms=call["sdpa"],
            tc_route=route, scalar_ms=dev.get("scalar"),
            scalar_max_abs_err=errs["scalar"][0] if tc else None)
    return rows


# -- phase 3: the main path ----------------------------------------------

def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_checkpoint(path: str, seed: int = SEED) -> None:
    """The registry's full-width vit with random weights from ``seed``,
    saved in the port's checkpoint format."""
    import torch

    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.precision import PRESETS

    model = get_model("vit", 10, PRESETS["bf16"], attention="flash",
                      device="cpu")
    model.init_weights(torch.Generator().manual_seed(seed))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ckpt.save_checkpoint(path, "vit", model, epoch=0, best_valid_loss=0.0)


def post(port: int, body: bytes, timeout: float = 60.0):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=body)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.perf_counter() - t0


def burst(port: int, images, waves: int,
          threads: int = BURST_THREADS) -> list:
    """``threads`` clients, each sending ``waves`` requests; every wave
    starts on a barrier so a full bucket of 64 queues at once.  Returns
    (row, status, body, client_s) per request."""
    bodies = [json.dumps({"image": img.tolist()}).encode() for img in images]
    barrier = threading.Barrier(threads)
    out = [None] * len(bodies)

    def client(t):
        for w in range(waves):
            i = w * threads + t
            barrier.wait(timeout=120)
            try:
                out[i] = (i,) + post(port, bodies[i])
            except OSError as e:  # reported with the failed answers below
                out[i] = (i, None, {"error": repr(e)}, 0.0)

    clients = [threading.Thread(target=client, args=(t,))
               for t in range(threads)]
    for th in clients:
        th.start()
    for th in clients:
        th.join(timeout=300)
    if any(th.is_alive() for th in clients) or any(o is None for o in out):
        fail("the HTTP burst did not complete")
    return out


def reference_predictions(ckpt_path: str, images, served_bucket,
                          device: str, name: str = "vit",
                          precision: str = "bf16"):
    """The in-process predict step of the ``name`` checkpoint on the same
    rows, each row in a batch of the bucket the server answered it from
    (zero-padded, as the server pads), plus each row's softmax (to tell a
    tie from a wrong label)."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.data import augment
    from distributedpytorch_tpu_torch.models import (get_model,
                                                     get_model_input_size)
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Predictor

    ds = work_dataset()
    policy = PRESETS[precision]
    size = get_model_input_size(name)
    model = get_model(name, ds.nb_classes, policy,
                      attention="flash" if name == "vit" else "full",
                      device=device)
    ckpt.restore_for_serving(ckpt_path, model)
    pred = Predictor(model, ds.mean, ds.std, size, policy, device)
    n = len(images)
    labels = np.zeros(n, np.int64)
    confs = np.zeros(n, np.float64)
    probs = np.zeros((n, ds.nb_classes), np.float64)
    for bucket in sorted(set(served_bucket.tolist())):
        rows = np.flatnonzero(served_bucket == bucket)
        for i in range(0, len(rows), bucket):
            idx = rows[i:i + bucket]
            padded = np.zeros((bucket,) + images.shape[1:], images.dtype)
            padded[:len(idx)] = images[idx]
            lab, conf = pred.predict_step(padded)
            labels[idx] = lab[:len(idx)].cpu().numpy()
            confs[idx] = conf[:len(idx)].float().cpu().numpy()
            with torch.inference_mode():
                x = augment.eval_transform(
                    torch.from_numpy(padded).to(device), ds.mean, ds.std,
                    size, out_dtype=policy.compute_dtype)
                probs[idx] = torch.softmax(model(x).float(), dim=-1)[
                    :len(idx)].cpu().numpy()
    return labels, confs, probs


def check_logits(ckpt_path: str, images, device: str) -> None:
    """The served model with the flash kernel against the same model with
    full attention (plain PyTorch), f32 (TF32 off) and bf16."""
    import torch

    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.data import augment
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.precision import PRESETS

    x_u8 = torch.from_numpy(images[:8]).to(device)
    for name in ("float32", "bfloat16"):
        policy = PRESETS["f32" if name == "float32" else "bf16"]
        logits = {}
        for att in ("flash", "full"):
            model = get_model("vit", 10, policy, attention=att,
                              device=device)
            ckpt.restore_for_serving(ckpt_path, model)
            with torch.inference_mode():
                x = augment.eval_transform(x_u8, 0.5, 0.25, 28,
                                           out_dtype=policy.compute_dtype)
                logits[att] = model(x)
        err = (logits["flash"] - logits["full"]).abs().max().item()
        ok = (bool(torch.isfinite(logits["flash"]).all())
              and tuple(logits["flash"].shape) == (8, 10)
              and err <= TOL_LOGITS[name])
        say(f"main: vit logits flash vs full attention, {name}: max abs "
            f"err {err:.3g} (tol {TOL_LOGITS[name]:g})")
        if not ok:
            fail(f"vit logits with K1 disagree with full attention in "
                 f"{name}: {err}")


def start_server(ckpt_path: str, n: int, flush_ms: int, device: str,
                 attention: str = "flash", precision: str = "bf16"):
    """A ``serve`` subprocess that stops after ``n`` answers (a fresh
    process: its K1 count starts at 0 right before the main path and is
    read from its log right after); returns (port, proc, lines, the
    listening event)."""
    port = free_port()
    cmd = [sys.executable, "-m", "distributedpytorch_tpu_torch", "serve",
           "-d", os.path.join(WORK, "data"),
           "--rsl_path", os.path.join(WORK, "rsl"), "-f", ckpt_path,
           "--attention", attention, "--synthetic-fallback",
           "--serve-buckets", ",".join(str(b) for b in BUCKETS),
           "--serve-max-requests", str(n), "--serve-port", str(port),
           "--serve-max-latency-ms", str(flush_ms), "--device", device,
           "--precision", precision]
    say("main: " + " ".join(os.path.relpath(c, ROOT) if c.startswith(ROOT)
                            else c for c in cmd[1:]))
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    listening = threading.Event()

    def reader():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if "serve: listening on" in line:
                listening.set()

    threading.Thread(target=reader, daemon=True).start()
    return port, proc, lines, listening


def serve_burst(server, images, waves: int,
                threads: int = BURST_THREADS) -> tuple:
    """Waits for ``server`` to listen, sends ``waves`` waves of ``threads``
    requests, waits for it to exit; returns (answers, burst seconds)."""
    port, proc, lines, listening = server
    t0 = time.perf_counter()
    while not listening.wait(0.5):
        if proc.poll() is not None or time.perf_counter() - t0 > 600:
            fail("the server did not start:\n" + "\n".join(lines[-40:]))
    t_burst = time.perf_counter()
    answers = burst(port, images, waves, threads)
    burst_s = time.perf_counter() - t_burst
    try:
        rc = proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        rc = None
    if rc != 0:
        fail(f"the server exited with {rc}:\n" + "\n".join(lines[-40:]))
    time.sleep(0.2)         # the reader thread takes the last lines
    for line in lines:
        if line.startswith("serve:"):
            say("server| " + line)
    bad = [a for a in answers if a[1] != 200]
    if bad:
        fail(f"{len(bad)} of {len(answers)} requests failed, e.g. "
             f"{bad[0][1:3]}")
    return answers, burst_s


def check_server_launches(lines, n: int) -> tuple:
    """The server's K1 count against 4 x (batches + warm-up buckets), every
    launch on the tensor cores; returns (launches, batches)."""
    served = stopped = None
    for line in lines:
        m = re.search(r"flash_fwd launches (\d+) \((\d+) in warm-up\), "
                      r"(\d+) on the tensor cores", line)
        if m:
            served = tuple(int(x) for x in m.groups())
        m = re.search(r"answering (\d+) requests in (\d+) batches", line)
        if m:
            stopped = (int(m.group(1)), int(m.group(2)))
    if served is None or stopped is None:
        fail("the server did not report its K1 launches and batches")
    launches, warm, tensor_core = served
    answered, batches = stopped
    want = DEPTH * (batches + len(BUCKETS))
    say(f"main: K1 launches {launches} = {DEPTH} x ({batches} batches + "
        f"{len(BUCKETS)} warm-up forwards) -> expected {want}; "
        f"{tensor_core} on the tensor cores (expected all)")
    if answered != n or launches <= 0 or launches != want \
            or warm != DEPTH * len(BUCKETS) or tensor_core != launches:
        fail(f"K1 launch count {launches} (warm-up {warm}, tensor-core "
             f"{tensor_core}) does not match the {batches} batches served, "
             f"every one on the tensor cores")
    return launches, batches


def phase_main_path(device: str = "cuda"):
    import numpy as np


    ckpt_path = os.path.join(WORK, "rsl", "bestmodel-mnist-vit.ckpt")
    build_checkpoint(ckpt_path)
    n_main = BURST_THREADS * BURST_WAVES
    n = n_main + BURST_THREADS
    # both servers start together; the bursts run one after the other
    servers = [start_server(ckpt_path, n_main, FLUSH_MS, device),
               start_server(ckpt_path, BURST_THREADS, FILL_FLUSH_MS, device)]
    try:
        ds = work_dataset()
        images = ds.splits["test"].images[:n]
        main_answers, burst_s = serve_burst(servers[0], images[:n_main],
                                            BURST_WAVES)
        fill_answers, fill_s = serve_burst(servers[1], images[n_main:], 1)
    finally:
        for _, proc, _, _ in servers:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for what, answers, secs, flush in (
            ("main burst", main_answers, burst_s, FLUSH_MS),
            ("fill wave", fill_answers, fill_s, FILL_FLUSH_MS)):
        server_ms = np.array([a[2]["latency_ms"] for a in answers])
        client_ms = np.array([a[3] * 1e3 for a in answers])
        say(f"main: {what} (flush {flush} ms): {len(answers)} answers in "
            f"{secs:.3f}s, buckets used "
            f"{sorted({a[2]['bucket'] for a in answers})}; server latency "
            f"p50 {np.percentile(server_ms, 50):.3f} ms p99 "
            f"{np.percentile(server_ms, 99):.3f} ms; client latency p50 "
            f"{np.percentile(client_ms, 50):.3f} ms p99 "
            f"{np.percentile(client_ms, 99):.3f} ms")
    if {a[2]["bucket"] for a in fill_answers} != {max(BUCKETS)}:
        fail(f"the fill wave was not served in bucket {max(BUCKETS)}: "
             f"{sorted({a[2]['bucket'] for a in fill_answers})}")
    answers = main_answers + [(n_main + a[0],) + a[1:] for a in fill_answers]

    got_labels = np.array([a[2]["label"] for a in answers])
    got_confs = np.array([a[2]["confidence"] for a in answers])
    served_bucket = np.array([a[2]["bucket"] for a in answers])
    labels, confs, probs = reference_predictions(ckpt_path, images,
                                                 served_bucket, device)
    top2 = np.sort(probs, axis=-1)[:, -2:]
    tie = (top2[:, 1] - top2[:, 0]) <= TOL_CONF
    mismatch = (got_labels != labels) & ~tie
    conf_err = float(np.abs(got_confs - confs).max())
    # The check's power: how many rows it would fail if every answer were
    # handed to the next request (a batcher mix-up).
    shifted = ((np.roll(labels, -1) != labels) & ~tie) \
        | (np.abs(np.roll(confs, -1) - confs) > TOL_CONF)
    say(f"main: answers vs in-process predict step at the served bucket: "
        f"{int((got_labels == labels).sum())}/{n} labels equal "
        f"({int(tie.sum())} rows within {TOL_CONF:g} of a tie), max conf "
        f"err {conf_err:.3g} (tol {TOL_CONF:g}); "
        f"{len(set(labels.tolist()))} distinct labels, confidences "
        f"{confs.min():.6f}..{confs.max():.6f}; a one-row shift of the "
        f"answers would fail {int(shifted.sum())}/{n} rows")
    if mismatch.any() or conf_err > TOL_CONF:
        fail("served answers disagree with the in-process predict step")
    if shifted.sum() < n // 2:
        fail("the answer check could not tell one row's answer from "
             "another's: the reference answers are too alike")
    check_logits(ckpt_path, images, device)

    launches, _ = check_server_launches(servers[0][2], n_main)
    fill_launches, fill_batches = check_server_launches(servers[1][2],
                                                        BURST_THREADS)
    if fill_batches != 1:
        fail(f"the fill wave took {fill_batches} batches, not one")
    return launches + fill_launches


def phase_profile(ckpt_path: str, device: str = "cuda") -> None:
    """Where the time goes in the served model's forward: wall time per
    predict step (host clock, synchronized, profiler off) at buckets 1
    and 64, then, from a second run under torch.profiler, the device time
    by kernel, K1's share of it, and the device's idle share of the
    unprofiled wall time.  Prints only; the checks are done above."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Predictor

    policy = PRESETS["bf16"]
    reps = 20
    for att in ("flash", "full"):
        model = get_model("vit", 10, policy, attention=att, device=device)
        ckpt.restore_for_serving(ckpt_path, model)
        pred = Predictor(model, 0.5, 0.25, 28, policy, device)
        for bucket in (1, 64):
            x = np.zeros((bucket, 28, 28), np.uint8)
            for _ in range(5):
                pred.predict_step(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                pred.predict_step(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    pred.predict_step(x)
                torch.cuda.synchronize()
            kernels = device_kernels(prof)
            dev_ms = sum(e.self_device_time_total for e in kernels) \
                / 1e3 / reps
            n_kern = sum(e.count for e in kernels) / reps
            k1_ms = sum(e.self_device_time_total for e in kernels
                        if "flash_fwd_" in e.key) / 1e3 / reps
            if dev_ms <= 0:
                say(f"profile: {att} bucket {bucket}: wall {wall_ms:.3f} "
                    f"ms/forward; device time not measured (no device "
                    f"events from torch.profiler)")
                continue
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)
            say(f"profile: {att} bucket {bucket}: wall {wall_ms:.3f} "
                f"ms/forward, device {dev_ms:.3f} ms in {n_kern:.0f} "
                f"kernels (idle {100 * (1 - dev_ms / wall_ms):.1f}%), K1 "
                f"{k1_ms * 1e3:.2f} us/forward "
                f"({100 * k1_ms / dev_ms:.1f}% of device time)")
            say("profile:   top: " + "; ".join(
                f"{e.key[:48]} {e.self_device_time_total / reps:.1f}us"
                f"x{e.count // reps}" for e in top[:5]))


# -- phase 4: K2 and K3 against their plain version -----------------------

def bwd_bound_ms(b: int, s: int, h: int, d: int, dtype_name: str,
                 causal: bool, kernel: str):
    """Least time for K2 ("dq"), K3 ("dkv") or the whole backward
    ("bwd"): each input read once and each output written once (K2 reads
    q, k, v, dO, O and lse and writes dq and delta; K3 reads q, k, v, dO,
    lse and delta and writes dk and dv; the backward reads q, k, v, dO, O
    and lse and writes dq, dk and dv), or its products' operations (K2: 3,
    K3: 4, the backward: 5) at the card's peak for the input type,
    whichever is larger."""
    item = 4 if dtype_name == "float32" else 2
    tensor = b * s * h * d * item
    rows = b * h * s * 4
    pairs = s * (s + 1) / 2 if causal else s * s
    tensors, row_vectors, products = {"dq": (6, 2, 3), "dkv": (6, 2, 4),
                                      "bwd": (8, 1, 5)}[kernel]
    nbytes = tensors * tensor + row_vectors * rows
    ops = products * 2 * b * h * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, ref) -> tuple:
    """(max abs error, max abs error / max abs of the reference)."""
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return err, err / max(scale, 1e-30)


# K2's delta against attention_delta, relative to its largest value: the
# same f32 sum of the same exact products in another order.
TOL_DELTA = 1e-5


def phase_bwd_kernels():
    """K2 and K3 against their plain version: each case on the route the
    rule picks and, at a tensor-core case, on the scalar route too
    (forced), both held to TOL_GRAD; K2's delta against
    ``attention_delta``; two calls bit-identical; times of the backward
    as the step runs it (K2, which computes delta, then K3) beside the
    unfused backward (``attention_delta``, then the scalar K2 and K3)
    and SDPA's backward."""
    import torch
    import torch.nn.functional as F

    from distributedpytorch_tpu_torch.ops import flash_attention as tfa

    cases = [(b, 49, 4, 32, dt, False) for b in (1, 16, 64)
             for dt in ("bfloat16", "float32")]
    cases += [(64, 49, 4, 32, "bfloat16", True)]
    for s, d in ((128, 64), (128, 128), (1000, 64), (1000, 128)):
        for dt in ("bfloat16", "float32"):
            for causal in (False, True):
                cases.append((8 if s == 128 else 2, s, 4, d, dt, causal))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    counters = (tfa.flash_attention_dq, tfa.flash_attention_dkv)
    rows = {}
    for (b, s, h, d, dt, causal) in cases:
        shape = (b, s, h, d)
        dtype = getattr(torch, dt)
        qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                          device="cuda").to(dtype)
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
        do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
        o, lse = tfa.flash_attention_fwd(q, k, v, causal)
        tc = tfa._pick_route(None, (q, k, v, do, o))
        route = "tensor_core" if tc else "scalar"
        before = [(w.launches, w.tensor_core_launches) for w in counters]
        dq, delta = tfa.flash_attention_dq(q, k, v, o, do, lse, causal)
        dk, dv = tfa.flash_attention_dkv(q, k, v, do, lse, delta, causal)
        again = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        if [(w.launches, w.tensor_core_launches) for w in counters] != [
                (n + 2, c + 2 * tc) for n, c in before]:
            fail(f"K2/K3 wrappers did not count their {route} launches at "
                 f"{shape} {dt}")
        if not all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again)):
            fail(f"K2/K3's {route} route is not deterministic at {shape} "
                 f"{dt} causal={causal}")
        checked = {route: (delta, dq, dk, dv)}
        if tc:
            sdq, sdelta = tfa._dq_launch(q, k, v, o, do, lse, causal,
                                         tensor_core=False)
            sdk, sdv = tfa._dkv_launch(q, k, v, do, lse, sdelta, causal,
                                       tensor_core=False)
            checked["scalar"] = (sdelta, sdq, sdk, sdv)
        want_delta = tfa.attention_delta(o, do)
        pdq, pdk, pdv = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                      causal)
        tol = TOL_GRAD[dt]
        errs = {}
        for r, (x_delta, x_dq, x_dk, x_dv) in checked.items():
            errs[r] = {"delta": rel_err(x_delta, want_delta),
                       "dq": rel_err(x_dq, pdq), "dk": rel_err(x_dk, pdk),
                       "dv": rel_err(x_dv, pdv)}
            bad = {n: e[1] for n, e in errs[r].items()
                   if not (math.isfinite(e[1])
                           and e[1] <= (TOL_DELTA if n == "delta" else tol))}
            if bad:
                fail(f"K2/K3's {r} route disagrees with the plain version "
                     f"at {shape} {dt} causal={causal}: {bad} (tol {tol}, "
                     f"delta {TOL_DELTA})")
        # SDPA's backward (yardstick only): dq, dk and dv in one call
        qt, kt, vt = (t.detach().transpose(1, 2).contiguous()
                      .requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        dot = do.transpose(1, 2).contiguous()
        reps = 50 if s < 1000 else 20
        main = (b, s, h, d, dt, causal) == MAIN_ATTN

        def unfused_bwd():
            x_delta = tfa.attention_delta(o, do)
            tfa._dq_launch(q, k, v, o, do, lse, causal, tensor_core=False)
            tfa._dkv_launch(q, k, v, do, lse, x_delta, causal,
                            tensor_core=False)

        fns = {"K2": lambda: tfa.flash_attention_dq(q, k, v, o, do, lse,
                                                    causal),
               "K3": lambda: tfa.flash_attention_dkv(q, k, v, do, lse, delta,
                                                     causal),
               "bwd": lambda: tfa.flash_attention_bwd(q, k, v, o, lse, do,
                                                      causal)}
        if tc:
            fns["scalar K2"] = lambda: tfa._dq_launch(
                q, k, v, o, do, lse, causal, tensor_core=False)
            fns["scalar K3"] = lambda: tfa._dkv_launch(
                q, k, v, do, lse, delta, causal, tensor_core=False)
            fns["unfused bwd"] = unfused_bwd
        if main:
            fns["plain"] = lambda: tfa.flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal)
        fns["sdpa bwd"] = lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True)
        call = {n: time_ms(f, reps) for n, f in fns.items()}
        dev = {n: spread(t)[0] for n, t in
               device_ms_tries(fns, reps, timing_tries(main)).items()}
        bounds = {n: bwd_bound_ms(b, s, h, d, dt, causal, n)
                  for n in ("dq", "dkv", "bwd")}
        say(f"K2/K3 {shape} {dt} causal={causal}, {route} route: rel err "
            + "; ".join(f"{r} " + " ".join(f"{n}={e[1]:.3g}"
                                           for n, e in es.items())
                        for r, es in errs.items())
            + f" (tol {tol:g}, delta {TOL_DELTA:g}), bit-identical; "
            f"{timing_note(main)}: " + times_text(dev, call)
            + "; bound_us " + " ".join(f"{n}={t * 1e3:.3f} ({by})"
                                       for n, (t, by) in bounds.items())
            + f"; launches K2={tfa.flash_attention_dq.launches} "
            f"(tensor-core {tfa.flash_attention_dq.tensor_core_launches}) "
            f"K3={tfa.flash_attention_dkv.launches} (tensor-core "
            f"{tfa.flash_attention_dkv.tensor_core_launches})")
        for name, key, parts in (("flash_dq", "K2", ("delta", "dq")),
                                 ("flash_dkv", "K3", ("dk", "dv"))):
            err = max((errs[route][n] for n in parts), key=lambda e: e[1])
            rows[(name, b, s, h, d, dt, causal)] = dict(
                max_abs_err=err[0], rel_err=err[1], ms=dev[key],
                plain_ms=dev.get("plain"), library_ms=dev["sdpa bwd"],
                bound_ms=bounds[name[6:]][0], bound_by=bounds[name[6:]][1],
                call_ms=call[key], plain_call_ms=call.get("plain"),
                library_call_ms=call["sdpa bwd"], tc_route=route,
                scalar_ms=dev.get("scalar " + key),
                scalar_rel_err=(max(errs["scalar"][n][1] for n in parts)
                                if tc else None),
                delta_rel_err=errs[route]["delta"][1],
                bwd_ms=dev["bwd"], unfused_bwd_ms=dev.get("unfused bwd"),
                bwd_bound_ms=bounds["bwd"][0])
    return rows


# -- phase 5: one train step on the card against the CPU -------------------

def phase_train_step_parity() -> None:
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.cli import kernel_launches
    from distributedpytorch_tpu_torch.data import augment
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine

    policy = PRESETS["f32"]
    ds = work_dataset()
    images = ds.splits["train"].images[:TRAIN_BATCH]
    labels = ds.splits["train"].labels[:TRAIN_BATCH].astype(np.int64)
    u = np.random.default_rng(SEED).random((TRAIN_BATCH, 5),
                                           dtype=np.float32)
    grads, losses = {}, {}
    for device in ("cuda", "cpu"):
        model = get_model("vit", ds.nb_classes, policy, attention="flash",
                          device=device)
        engine = Engine(model, cross_entropy, ds.mean, ds.std, 28, policy,
                        device)
        state = engine.init_state(torch.Generator().manual_seed(SEED))
        affine = augment.affine_from_uniform(
            torch.from_numpy(u).to(device), 28, 28)
        before = kernel_launches()
        _, m = engine.train_step_affine(
            state, torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device),
            torch.ones(TRAIN_BATCH, dtype=torch.bool, device=device), affine)
        if device == "cuda":
            torch.cuda.synchronize()
            got = {k: v - before[k] for k, v in kernel_launches().items()}
            say(f"step: one f32 train step on the card launched {got}")
            if got != {"flash_fwd": DEPTH, "flash_dq": DEPTH,
                       "flash_dkv": DEPTH, "conv_dw": 0, "flash_fwd_pos": 0,
                       "flash_dq_pos": 0, "flash_dkv_pos": 0}:
                fail(f"a train step must launch {DEPTH} K1, {DEPTH} K2 and "
                     f"{DEPTH} K3 exactly, got {got}")
        losses[device] = m["loss"].item()
        grads[device] = {n: p.grad.detach().cpu()
                         for n, p in model.named_parameters()}
    worst = max(((n, rel_err(grads["cuda"][n], g)) for n, g in
                 grads["cpu"].items()), key=lambda t: t[1][1])
    say(f"step: full-width f32 train step, card vs CPU: loss "
        f"{losses['cuda']:.7f} vs {losses['cpu']:.7f}; worst gradient "
        f"{worst[0]}: rel err {worst[1][1]:.3g} (abs {worst[1][0]:.3g}; "
        f"tol {TOL_STEP_GRAD:g}) over {len(grads['cpu'])} parameters")
    if not (math.isfinite(worst[1][1]) and worst[1][1] <= TOL_STEP_GRAD):
        fail(f"the train step's gradients on the card disagree with the "
             f"CPU's: {worst[0]} rel err {worst[1][1]}")


# -- phase 6: the training slice's main path -------------------------------

TORCHRUN = ("-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "1")


def start_cli(args, rsl: str, launcher=(), data: str = "",
              dataset: str = "mnist", env=None) -> tuple:
    """Starts ``python [LAUNCHER] -m distributedpytorch_tpu_torch ARGS`` (a
    fresh process: its kernel counters start at 0) on the data in ``data``
    (WORK/data by default), in ``env`` (this process's by default), its
    output going to a file in WORK; ``finish_cli`` waits for it."""
    cmd = [sys.executable, *launcher, "-m", "distributedpytorch_tpu_torch",
           *args, "-d", data or os.path.join(WORK, "data"), "--rsl_path", rsl,
           "--dataset", dataset, "--synthetic-fallback", "--device", "cuda"]
    say("run: " + " ".join(os.path.relpath(c, ROOT) if c.startswith(ROOT)
                           else c for c in cmd[1:]))
    out = os.path.join(WORK, os.path.basename(rsl) + ".out")
    with open(out, "w") as f:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=f,
                                stderr=subprocess.STDOUT, env=env)
    return args[0], rsl, out, proc, time.perf_counter()


def finish_cli(run: tuple, timeout: float = 900.0) -> tuple:
    """Waits for a ``start_cli`` process (killing it at ``timeout``
    seconds); returns (wall s, the text of RSL/test.log)."""
    action, rsl, out, proc, t0 = run
    try:
        rc = proc.wait(timeout=max(1.0, t0 + timeout - time.perf_counter()))
    except subprocess.TimeoutExpired:
        rc = None
    wall = time.perf_counter() - t0
    if rc != 0:
        with open(out) as f:
            fail(f"{action} exited with {rc}:\n{f.read()[-4000:]}")
    with open(os.path.join(rsl, "test.log")) as f:
        return wall, f.read()


def finish_all(runs: list) -> list:
    """``finish_cli`` of every run in order; no process outlives it."""
    try:
        return [finish_cli(run) for run in runs]
    finally:
        for *_, proc, _ in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_cli(args, rsl: str, launcher=(), data: str = "") -> tuple:
    """One CLI process, start to end: (wall s, the text of RSL/test.log)."""
    return finish_all([start_cli(args, rsl, launcher, data)])[0]


def parse_launches(log: str, action: str):
    m = re.search(rf"{action}: kernel launches flash_fwd (\d+), flash_dq "
                  rf"(\d+), flash_dkv (\d+), conv_dw (\d+) over "
                  rf"(?:(\d+) train steps and )?(\d+) eval batches", log)
    if m is None:
        fail(f"{action} did not log its kernel launches")
    fwd, dq, dkv, dw, steps, evals = (int(x) if x is not None else 0
                                      for x in m.groups())
    return ({"flash_fwd": fwd, "flash_dq": dq, "flash_dkv": dkv,
             "conv_dw": dw}, steps, evals)


def parse_tensor_core_launches(log: str, action: str) -> dict:
    """The ``ACTION: tensor-core launches ...`` line: of K1, K2, K3 and
    K5, the launches on the tensor cores."""
    m = re.search(rf"{action}: tensor-core launches flash_fwd (\d+), "
                  rf"flash_dq (\d+), flash_dkv (\d+), conv_dw (\d+) over",
                  log)
    if m is None:
        fail(f"{action} did not log its tensor-core launches")
    return dict(zip(("flash_fwd", "flash_dq", "flash_dkv", "conv_dw"),
                    map(int, m.groups())))


# Phase 6's corpus: the first rows of the synthetic one, as MNIST files.
# 90% of the train rows train: 225 steps of 64, and 25 validation batches.
VIT_TRAIN_ROWS = 16000
VIT_TEST_ROWS = 2000
VIT_DATA = os.path.join(WORK, "vit_data")


def write_vit_data() -> None:
    write_corpus(VIT_DATA, VIT_TRAIN_ROWS, VIT_TEST_ROWS)


# Phases 18, 27 and 36's corpus, cut from phase 6's for the run's time
# limit (from 10,000 rows to 7,000 to make room for phase 45): 6,300
# train rows (50 steps of the ring shard's 128, 99 of 64), 700 validation
# rows and 1,000 test rows.
RING_DATA_TRAIN_ROWS = 7000
RING_DATA_TEST_ROWS = 1000
RING_DATA = os.path.join(WORK, "ring_data")


def write_ring_data() -> None:
    if not os.path.isdir(RING_DATA):
        write_corpus(RING_DATA, RING_DATA_TRAIN_ROWS, RING_DATA_TEST_ROWS)


# Phases 13 and 22's corpus: 633 train rows (10 steps of 64), 71
# validation rows (2 batches) and 128 test rows (2 batches), cut from
# phase 6's for the run's time limit.
ZOO_TRAIN_ROWS = 704
ZOO_TEST_ROWS = 128
ZOO_DATA = os.path.join(WORK, "zoo_data")


def write_zoo_data() -> None:
    if not os.path.isdir(ZOO_DATA):
        write_corpus(ZOO_DATA, ZOO_TRAIN_ROWS, ZOO_TEST_ROWS)


@functools.lru_cache(maxsize=None)
def work_dataset():
    """The synthetic corpus of WORK/data as ``load_dataset`` gives it,
    loaded once for the run's in-process phases (each load draws the
    corpus anew: seconds of host time)."""
    from distributedpytorch_tpu_torch.data.datasets import load_dataset

    return load_dataset("mnist", os.path.join(WORK, "data"), SEED,
                        synthetic_fallback=True)


def write_corpus(root: str, train_rows: int, test_rows: int) -> None:
    """``train_rows`` train and ``test_rows`` test rows of the synthetic
    corpus written to ROOT/MNIST/raw in the IDX format, so that ``train``
    reads a smaller MNIST."""
    import struct

    import numpy as np

    from distributedpytorch_tpu_torch.data import io

    raw = os.path.join(root, "MNIST", "raw")
    os.makedirs(raw, exist_ok=True)
    tr_x, tr_y, te_x, te_y = io.make_synthetic()
    for name, a in (("train-images-idx3-ubyte", tr_x[:train_rows]),
                    ("train-labels-idx1-ubyte", tr_y[:train_rows]),
                    ("t10k-images-idx3-ubyte", te_x[:test_rows]),
                    ("t10k-labels-idx1-ubyte", te_y[:test_rows])):
        with open(os.path.join(raw, name), "wb") as f:
            f.write(struct.pack(">HBB", 0, 0x08, a.ndim))
            f.write(struct.pack(">" + "I" * a.ndim, *a.shape))
            f.write(np.ascontiguousarray(a, np.uint8).tobytes())


def phase_train():
    write_vit_data()
    rsl = os.path.join(WORK, "train_rsl")
    wall, log = run_cli(["train", "--model", "vit", "--attention", "flash",
                         "-e", "1"], rsl, data=VIT_DATA)
    launches, steps, evals = parse_launches(log, "train")
    tensor_core = parse_tensor_core_launches(log, "train")
    n_train = int(VIT_TRAIN_ROWS * 0.9)
    want_steps = math.ceil(n_train / TRAIN_BATCH)
    want_evals = math.ceil((VIT_TRAIN_ROWS - n_train) / TRAIN_BATCH)
    want = {"flash_fwd": DEPTH * (steps + evals), "flash_dq": DEPTH * steps,
            "flash_dkv": DEPTH * steps, "conv_dw": 0}
    # the vit's bf16 K1, K2 and K3 all take the tensor cores
    want_tc = dict(want)
    say(f"train: launches {launches} over {steps} steps and {evals} eval "
        f"batches; formula {want}; on the tensor cores {tensor_core}, "
        f"formula {want_tc}")
    if (steps, evals) != (want_steps, want_evals) or launches != want \
            or tensor_core != want_tc:
        fail(f"train launches {launches} (tensor-core {tensor_core}) over "
             f"{steps} steps / {evals} eval batches do not match the "
             f"formula {want} (tensor-core {want_tc}) at {want_steps} "
             f"steps / {want_evals} eval batches")
    check_epoch_log("train", log, steps, wall)
    return launches, tensor_core, os.path.join(rsl,
                                               "bestmodel-mnist-vit.ckpt")


def check_epoch_log(tag: str, log: str, steps: int, wall: float) -> None:
    """Prints one epoch's throughput, validation accuracy and the mean
    train loss of its first and last 10% of steps from its test.log; fails
    unless the accuracy is at least twice chance and the loss fell.
    samples/s/chip is the global batch (TRAIN_BATCH per rank) a second
    over the ranks, so over TRAIN_BATCH it is steps/s."""
    valid_acc = float(re.search(r"Validation  \| Loss: [\d.]+ +\| Acc: "
                                r"([\d.]+)%", log).group(1))
    train_loss = float(re.search(r"Train       \| Loss: ([\d.]+)",
                                 log).group(1))
    sps = float(re.search(r"Throughput  \| ([\d,]+) samples/s/chip",
                          log).group(1).replace(",", ""))
    progress = [(int(a), float(b)) for a, b in re.findall(
        r"epoch:000 nb batches:(\d+) mean train loss:([\d.]+)", log)]
    (k_first, m_first) = progress[0]
    (k_last, m_last) = [p for p in progress if p[0] < steps][-1]
    # the lines are running means: the last 10% is what follows the last
    last_mean = (steps * train_loss - k_last * m_last) / (steps - k_last)
    say(f"{tag}: one epoch of {steps} steps in {wall:.1f}s of process "
        f"wall; train pass {sps:,.0f} samples/s/chip, "
        f"{sps / TRAIN_BATCH:.1f} steps/s; validation acc {valid_acc:.2f}% "
        f"(chance 10%); mean train loss first {k_first} steps "
        f"{m_first:.5f}, last {steps - k_last} steps {last_mean:.5f}")
    if valid_acc < 20.0:
        fail(f"{tag}: validation accuracy {valid_acc}% is under twice "
             f"chance")
    if not last_mean < m_first:
        fail(f"{tag}: the train loss did not fall: first 10% {m_first}, "
             f"last 10% {last_mean}")


# -- phases 7 and 8: resume, and test on the trained model -----------------

def phase_resume_and_test(ckpt_path: str) -> None:
    """The uninterrupted run of phase 7 and the ``test`` of phase 8 run at
    once (neither is timed), then the resumed run."""
    import torch

    base = ["train", "--model", "vit", "--attention", "flash", "--debug",
            "--keep-ckpts", "2", "-e", "2"]
    rsl_a = os.path.join(WORK, "resume_a")
    rsl_b = os.path.join(WORK, "resume_b")
    _, (_, log) = finish_all([
        start_cli(base, rsl_a),
        start_cli(["test", "-f", ckpt_path, "--attention", "flash"],
                  os.path.join(WORK, "test_rsl"), data=VIT_DATA)])
    os.makedirs(rsl_b, exist_ok=True)
    first = "checkpoint-mnist-vit-000.ckpt"
    shutil.copy(os.path.join(rsl_a, first), os.path.join(rsl_b, first))
    _, log_b = run_cli(base + ["-f", os.path.join(rsl_b, first)], rsl_b)

    acc_cli = re.search(r"Time: \d+m \d+s, Acc: ([\d.]+)%", log).group(1)
    launches, _, evals = parse_launches(log, "test")
    acc_here, correct, n = eval_accuracy(ckpt_path, "vit", VIT_DATA)
    say(f"test: `test -f` accuracy {acc_cli}% ({evals} eval batches, "
        f"launches {launches}); in-process eval {acc_here}% "
        f"({correct}/{n})")
    if acc_cli != acc_here or launches["flash_fwd"] != DEPTH * evals \
            or launches["flash_dq"] or launches["flash_dkv"] \
            or launches["conv_dw"] or n != VIT_TEST_ROWS:
        fail("test's accuracy or launches disagree with the in-process "
             "eval")

    launches, steps, evals = parse_launches(log_b, "train")
    last = "checkpoint-mnist-vit-001.ckpt"
    n, differ = state_tensors_differ(os.path.join(rsl_a, last),
                                     os.path.join(rsl_b, last))
    say(f"resume: resumed run ({steps} steps, launches {launches}) vs "
        f"uninterrupted: {n} tensors and counts of params, optimizer "
        f"state, step and updates; {len(differ)} differ")
    if differ or not n:
        fail(f"the resumed run does not reproduce the uninterrupted one: "
             f"{differ[:5]}")


def state_tensors_differ(path_a: str, path_b: str) -> tuple:
    """(the number of tensors and counts in the two checkpoints' states,
    the names of those that differ): params, optimizer state, step,
    updates and loss scale; of a checkpoint directory as the port reads
    it whole."""
    import torch

    from distributedpytorch_tpu_torch import checkpoint as ckpt

    a, b = (ckpt.read_checkpoint(p)["state"] if os.path.isdir(p) else
            torch.load(p, map_location="cpu", weights_only=True)["state"]
            for p in (path_a, path_b))

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree, key=str):
                yield from leaves(tree[k], f"{prefix}/{k}")
        elif isinstance(tree, (torch.Tensor, int, float)) or tree is None:
            yield prefix, tree

    def same(x, y):
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
            return torch.equal(x, y)
        return type(x) is type(y) and x == y

    pairs = list(zip(leaves(a), leaves(b)))
    differ = [na for (na, ta), (nb, tb) in pairs
              if na != nb or not same(ta, tb)]
    if len(list(leaves(a))) != len(list(leaves(b))):
        differ.append("(the number of entries)")
    return len(pairs), differ


# -- phase 9: profile of the train step -------------------------------------

def phase_train_profile() -> None:
    """Where the time goes in one train step at batch 64, bf16: wall time
    per step (host clock, synchronized, profiler off), then from a second
    run under torch.profiler the device time by kernel, K1/K2/K3 shares
    and the device's idle share of the unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributedpytorch_tpu_torch import utils
    from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine

    ds = work_dataset()
    loader = ResidentLoader(ds.splits["train"], TRAIN_BATCH, True, SEED,
                            "cuda")
    reps = 10                   # cut from 20 for the run's time limit
    batches = list(itertools.islice(loader.epoch(0), 5 + 2 * reps))
    for att in ("flash", "full"):
        policy = PRESETS["bf16"]
        model = get_model("vit", ds.nb_classes, policy, attention=att,
                          device="cuda")
        engine = Engine(model, cross_entropy, ds.mean, ds.std, 28, policy,
                        "cuda")
        state = engine.init_state(torch.Generator().manual_seed(SEED))

        def step(i):
            gen = utils.step_generator(SEED, 0, i, "cuda")
            engine.train_step(state, *batches[i], gen)

        for i in range(5):
            step(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            step(5 + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                step(5 + reps + i)
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
        n_kern = sum(e.count for e in kernels) / reps
        if dev_ms <= 0:
            say(f"profile: train step, {att}: wall {wall_ms:.3f} ms/step; "
                f"device time not measured (no device events)")
            continue

        def us(tags):
            return sum(e.self_device_time_total for e in kernels
                       if any(t in e.key for t in tags)) / reps

        def count(tags):
            return sum(e.count for e in kernels
                       if any(t in e.key for t in tags)) / reps

        # K1, K2 and K3 on either route (the tensor-core kernels are
        # *_mma_*), their time a launch and their tensor-core launches
        parts = "; ".join(
            f"{n} {us(tags):.2f} us/step in {count(tags):.0f} launches "
            f"({count((tags[1],)):.0f} tensor-core), "
            f"{us(tags) / max(count(tags), 1):.2f} us a launch "
            f"({100 * us(tags) / 1e3 / dev_ms:.1f}%)"
            for n, tags in (("K1", ("flash_fwd_kernel", "flash_fwd_mma")),
                            ("K2", ("flash_dq_kernel", "flash_dq_mma")),
                            ("K3", ("flash_dkv_kernel", "flash_dkv_mma"))))
        say(f"profile: train step, {att}, batch {TRAIN_BATCH} bf16: wall "
            f"{wall_ms:.3f} ms/step, device {dev_ms:.3f} ms in "
            f"{n_kern:.0f} kernels a step (idle "
            f"{100 * (1 - dev_ms / wall_ms):.1f}%); {parts}")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)
        say("profile:   top: " + "; ".join(
            f"{e.key[:48]} {e.self_device_time_total / reps:.1f}us"
            f"x{e.count // reps}" for e in top[:6]))



# -- phase 10: K5 against its plain version ---------------------------------

# The cnn's convs with K5 (Conv_1..Conv_3): (H, W, Ci, Co) at batch B.
CNN_CONVS = ((28, 28, 32, 32), (14, 14, 32, 64), (14, 14, 64, 64))
# K5 against its plain version, relative to the plain version's largest
# value, in both dtypes: both sum the same f32 products of the same
# inputs, in other orders.
TOL_DW = 1e-5


def dw_bound_ms(b: int, h: int, w: int, ci: int, co: int, dtype_name: str):
    """Least time for K5: x and dy read once, the f32 dW written once, or
    its 2 * B*H*W * 9*Ci*Co operations at the card's peak for the input
    type, whichever is larger."""
    item = 4 if dtype_name == "float32" else 2
    nbytes = b * h * w * (ci + co) * item + 9 * ci * co * 4
    ops = 2 * b * h * w * 9 * ci * co
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_conv_dw():
    """K5's routes against the plain version: each bf16 case that the rule
    sends to the tensor cores runs both routes (the scalar one forced)."""
    import torch
    from torch.nn.grad import conv2d_weight

    from distributedpytorch_tpu_torch.ops import conv

    cases = [(b,) + shape + (dt,) for shape in CNN_CONVS for b in (1, 16, 64)
             for dt in ("bfloat16", "float32")]
    cases += [(3, 9, 7, 32, 48, dt) for dt in ("bfloat16", "float32")]
    # bf16 that the rule sends to the scalar kernel (channels not multiples
    # of 8), and a tensor-core case whose last split ends in a ragged
    # chunk (715 = 11 x 64 + 11 rows) with tiles wider than the channels
    cases += [(2, 9, 7, 36, 20, "bfloat16"), (5, 13, 11, 40, 24, "bfloat16")]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = {}
    for (b, h, w, ci, co, dt) in cases:
        dtype = getattr(torch, dt)
        shape = (b, h, w, ci, co)
        # channels_last NCHW activations and gradients, as the cnn holds
        # them; K5 reads their NHWC views without a copy
        x = torch.randn((b, ci, h, w), generator=gen, device="cuda").to(
            dtype).contiguous(memory_format=torch.channels_last)
        dy = torch.randn((b, co, h, w), generator=gen, device="cuda").to(
            dtype).contiguous(memory_format=torch.channels_last)
        xn, dyn = x.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1)
        tc = conv.tensor_core_route(dtype, ci, co, xn.stride(), dyn.stride(),
                                    xn.data_ptr(), dyn.data_ptr())
        route = "tensor_core" if tc else "scalar"
        ref = conv.conv3x3_dw_plain(xn, dyn)
        before = (conv.conv3x3_dw.launches,
                  conv.conv3x3_dw.tensor_core_launches)
        got = conv.conv3x3_dw(xn, dyn)
        again = conv.conv3x3_dw(xn, dyn)
        torch.cuda.synchronize()
        if (conv.conv3x3_dw.launches,
                conv.conv3x3_dw.tensor_core_launches) != (
                before[0] + 2, before[1] + 2 * tc):
            fail(f"K5 wrapper did not count its {route} launches at "
                 f"{shape}")
        checked = {route: (got, again)}
        if tc:
            checked["scalar"] = (conv._launch(xn, dyn, tensor_core=False),
                                 conv._launch(xn, dyn, tensor_core=False))
        errs = {}
        for r, (a, a2) in checked.items():
            torch.cuda.synchronize()
            if not torch.equal(a, a2):
                fail(f"K5's {r} route is not deterministic at {shape} {dt}")
            errs[r] = rel_err(a, ref)
            if not (math.isfinite(errs[r][1]) and errs[r][1] <= TOL_DW):
                fail(f"K5's {r} route disagrees with its plain version at "
                     f"{shape} {dt}: rel err {errs[r][1]} (tol {TOL_DW})")
        main = (b, dt) == (TRAIN_BATCH, "bfloat16") and \
            (h, w, ci, co) in CNN_CONVS
        fns = {"kernel": lambda: conv.conv3x3_dw(xn, dyn)}
        if tc:
            fns["scalar"] = lambda: conv._launch(xn, dyn, tensor_core=False)
        if main:
            fns["plain"] = lambda: conv.conv3x3_dw_plain(xn, dyn)
        fns["cudnn"] = lambda: conv2d_weight(x, (co, ci, 3, 3), dy,
                                             padding=1)
        call = {n: time_ms(f) for n, f in fns.items()}
        dev = {n: spread(t) for n, t in
               device_ms_tries(fns, tries=timing_tries(main)).items()}
        b_ms, b_by = dw_bound_ms(b, h, w, ci, co, dt)
        plan = (conv.mma_plan(b * h * w, ci, co) if tc
                else conv.split_plan(b * h * w, 9 * ci, co))
        say(f"K5 {shape} {dt}, {route} route: rel err "
            + ", ".join(f"{r} {e[1]:.3g} (abs {e[0]:.3g})"
                        for r, e in errs.items())
            + f" (tol {TOL_DW:g}), deterministic; device_ms median "
            f"[least, most of {timing_tries(main)} tries] "
            + " ".join(f"{n}={fmt_ms(d[0])} [{fmt_ms(d[1])}, {fmt_ms(d[2])}]"
                       for n, d in dev.items())
            + "; call_ms " + " ".join(f"{n}={c:.5f}" for n, c in call.items())
            + f"; bound_us={b_ms * 1e3:.3f} ({b_by}); plan {plan}")
        rows[(b, h, w, ci, co, dt)] = dict(
            route=route, max_abs_err=errs[route][0], rel_err=errs[route][1],
            ms=dev["kernel"][0], ms_least=dev["kernel"][1],
            ms_most=dev["kernel"][2],
            scalar_ms=dev["scalar"][0] if tc else None,
            plain_ms=dev["plain"][0] if main else None,
            library_ms=dev["cudnn"][0], bound_ms=b_ms, bound_by=b_by,
            call_ms=call["kernel"], plain_call_ms=call.get("plain"),
            library_call_ms=call["cudnn"])
    return rows


def conv_dw_main_row(rows) -> dict:
    """K5's entry of the kernels line: one train step's three launches at
    batch 64 bf16, summed (times, bounds; each time the median of 3
    traces), the worst error, the route, and the shapes one by one."""
    parts = [rows[(TRAIN_BATCH,) + shape + ("bfloat16",)]
             for shape in CNN_CONVS]
    for key in ("ms", "plain_ms", "library_ms"):
        if any(p[key] is None for p in parts):
            fail(f"torch.profiler returned no device events for K5's "
                 f"{key} at the cnn's shapes")
    total = {k: sum(p[k] for p in parts) for k in
             ("ms", "plain_ms", "library_ms", "bound_ms", "call_ms",
              "plain_call_ms", "library_call_ms")}
    return dict(max_abs_err=max(p["max_abs_err"] for p in parts),
                rel_err=max(p["rel_err"] for p in parts),
                bound_by="bytes" if all(p["bound_by"] == "bytes"
                                        for p in parts) else "operations",
                k5_route="+".join(sorted({p["route"] for p in parts})),
                per_step_of=[list((TRAIN_BATCH,) + s) for s in CNN_CONVS],
                per_shape_ms=[p["ms"] for p in parts],
                per_shape_ms_least=[p["ms_least"] for p in parts],
                per_shape_ms_most=[p["ms_most"] for p in parts],
                per_shape_scalar_ms=[p["scalar_ms"] for p in parts],
                per_shape_library_ms=[p["library_ms"] for p in parts],
                **total)


# -- phase 11: cnn and resnet train steps on the card against the CPU -------

# f32, card against CPU, each gradient relative to its largest value.  The
# two devices' forwards differ in the last bits, and a ReLU or max-pool
# decision at a value within that rounding of a tie flips between them:
# one pixel's rank-1 term of a dW moves, against sums of as few as 16*7*7
# = 784 terms in resnet18's last stage.  Measured on the card: 3e-3 (cnn,
# batch 64) and 4.4e-2 (resnet18, batch 16), the same with and without
# K5.  So f32 is held to these, and two tight checks carry the weight:
# the same step in f64 on an identity affine (inputs bit-identical on both
# devices, so no decision can flip), and on the card the cnn's K5 step
# against its stock-dW step (the same forward, bit for bit).
TOL_STEP_F32 = {"cnn": 1e-2, "resnet": 1e-1}
# f64 graph: the loss head still runs in f32 (the logits are f32), where
# the two devices' softmax differs by an ulp: 2.2e-6 seen on head.weight
TOL_STEP_F64 = 1e-5
TOL_K5_STEP = 1e-5      # K5 against cuDNN's wgrad under one forward
TOL_STATS = 1e-4        # BatchNorm running statistics, f32 and f64
PARITY_BATCH = {"cnn": TRAIN_BATCH, "resnet": 16}


def identity_affine(b: int, device):
    """No rotation, the whole 28x28 image as the crop: the warp's weights
    are multiples of 1/16, so with an f64 output the augmented input is
    the same on both devices."""
    import torch

    zeros = torch.zeros(b, device=device)
    return (zeros, zeros, zeros, zeros + 28.0, zeros + 28.0)


def f64_policy():
    import torch

    from distributedpytorch_tpu_torch.precision import PrecisionPolicy

    return PrecisionPolicy(name="f64", param_dtype=torch.float32,
                           compute_dtype=torch.float64,
                           accum_dtype=torch.float64)


def one_step(name: str, device: str, policy, k5: bool, affine_u) -> tuple:
    """One train step of the registry's ``name`` from SEED's weights on
    the first PARITY_BATCH rows of the synthetic train split: (loss,
    {param: grad}, {buffer: value}, K5 launches).  ``affine_u`` is a
    (B, 5) uniform draw, or None for the identity affine."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.data import augment
    from distributedpytorch_tpu_torch.models import (get_model,
                                                     get_model_input_size)
    from distributedpytorch_tpu_torch.ops import conv
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.train.engine import Engine

    batch = PARITY_BATCH[name]
    ds = work_dataset()
    images = ds.splits["train"].images[:batch]
    labels = ds.splits["train"].labels[:batch].astype(np.int64)
    model = get_model(name, ds.nb_classes, policy, device=device,
                      pallas_dw=k5)
    engine = Engine(model, cross_entropy, ds.mean, ds.std,
                    get_model_input_size(name), policy, device)
    state = engine.init_state(torch.Generator().manual_seed(SEED))
    affine = (identity_affine(batch, device) if affine_u is None
              else augment.affine_from_uniform(
                  torch.from_numpy(affine_u).to(device), 28, 28))
    before = conv.conv3x3_dw.launches
    _, m = engine.train_step_affine(
        state, torch.from_numpy(images).to(device),
        torch.from_numpy(labels).to(device),
        torch.ones(batch, dtype=torch.bool, device=device), affine)
    if device == "cuda":
        torch.cuda.synchronize()
    return (m["loss"].item(),
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            {n: b.detach().cpu() for n, b in model.named_buffers()},
            conv.conv3x3_dw.launches - before)


def worst(a: dict, b: dict) -> tuple:
    """(name, relative error) of the tensor of ``a`` furthest from ``b``'s,
    relative to ``b``'s largest value; ("none", 0.0) for no tensors."""
    return max(((n, rel_err(a[n], t)[1]) for n, t in b.items()),
               key=lambda t: t[1], default=("none", 0.0))


def phase_cnn_step_parity() -> None:
    import numpy as np

    from distributedpytorch_tpu_torch.precision import PRESETS

    for name in ("cnn", "resnet"):
        k5 = name == "cnn"
        u = np.random.default_rng(SEED).random((PARITY_BATCH[name], 5),
                                               dtype=np.float32)
        checks = []
        for label, policy, draws, tol in (
                ("f32", PRESETS["f32"], u, TOL_STEP_F32[name]),
                ("f64", f64_policy(), None, TOL_STEP_F64)):
            card = one_step(name, "cuda", policy, k5 and label == "f32",
                            draws)
            cpu = one_step(name, "cpu", policy, k5 and label == "f32",
                           draws)
            g, st = worst(card[1], cpu[1]), worst(card[2], cpu[2])
            checks.append((label, g, st, tol, card, cpu))
        if k5:
            stock = one_step(name, "cuda", PRESETS["f32"], False, u)
            g = worst(checks[0][4][1], stock[1])
            say(f"step: cnn f32 on the card, K5 vs cuDNN's wgrad under the "
                f"same forward: worst gradient {g[0]} rel err {g[1]:.3g} "
                f"(tol {TOL_K5_STEP:g}); K5 launches "
                f"{checks[0][4][3]} and {stock[3]}")
            if not g[1] <= TOL_K5_STEP or checks[0][4][3] != 3 \
                    or stock[3] != 0:
                fail(f"the cnn step with K5 disagrees with the stock dW on "
                     f"the card ({g}) or launched K5 "
                     f"{checks[0][4][3]} times (want 3)")
        for label, g, st, tol, card, cpu in checks:
            say(f"step: {name} {label} train step (batch "
                f"{PARITY_BATCH[name]}"
                f"{', identity affine' if label == 'f64' else ''}), card vs "
                f"CPU: loss {card[0]:.9f} vs {cpu[0]:.9f}; worst gradient "
                f"{g[0]}: rel err {g[1]:.3g} (tol {tol:g}) over "
                f"{len(cpu[1])} parameters; worst BN statistic {st[0]}: rel "
                f"err {st[1]:.3g} (tol {TOL_STATS:g}) over {len(cpu[2])} "
                f"buffers")
            if not (math.isfinite(g[1]) and g[1] <= tol
                    and st[1] <= TOL_STATS
                    and abs(card[0] - cpu[0]) <= 1e-5 * abs(cpu[0])):
                fail(f"the {name} {label} train step on the card disagrees "
                     f"with the CPU's: {g}, {st}")
        if name == "resnet" and not checks[0][5][2]:
            fail("the resnet step has no BatchNorm statistics to compare")
    check_pool_ties()


def check_pool_ties() -> None:
    """The max pools' routing on the card equals the CPU's (which
    tests/test_torch_cnn.py pins to the JAX op), ties included: the 2x2/2
    pool of the cnn and the 3x3/2 (-inf padded) pool of the resnet, on
    channels_last inputs, bf16 and f32.  The argmax indices must be equal
    and the input gradients equal, except that the 3x3/2 pool's
    overlapping windows sum their gradients at another precision in bf16
    (one bf16 rounding, 1e-2 of the largest value)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED)
    x = np.maximum(rng.standard_normal((4, 8, 12, 12)), 0.0)
    x[:, :, ::3, :] = 1.0                # rows of equal values
    g = rng.standard_normal((4, 8, 6, 6))
    for dt in ("bfloat16", "float32"):
        for k, pad in ((2, 0), (3, 1)):
            got = []
            for device in ("cuda", "cpu"):
                t = torch.from_numpy(x).to(device, getattr(torch, dt)) \
                    .contiguous(memory_format=torch.channels_last) \
                    .requires_grad_()
                y, idx = F.max_pool2d_with_indices(t, k, 2, pad)
                y.backward(torch.from_numpy(g).to(device, y.dtype))
                got.append((y.detach().cpu(), idx.cpu(), t.grad.cpu()))
            (y0, i0, g0), (y1, i1, g1) = got
            tol = 1e-2 if (k, dt) == (3, "bfloat16") else 0.0
            ok = torch.equal(y0, y1) and torch.equal(i0, i1) \
                and rel_err(g0, g1)[1] <= tol \
                and torch.equal(g0 != 0, g1 != 0)
            if not ok:
                fail(f"the {k}x{k}/2 max pool differs on the card in {dt}: "
                     f"indices equal {torch.equal(i0, i1)}, gradient rel "
                     f"err {rel_err(g0, g1)[1]}")
    say(f"step: max pools 2x2/2 and 3x3/2 on the card route as the CPU's "
        f"(indices and gradient support equal; {int((x == 0).sum())} zeros "
        f"and rows of equal ones in the input)")


# -- phase 12: the cnn path with K5 (the slice's kernel main path) ----------

# Validation accuracy of the K5 steps against the stock conv's steps from
# the same seed: within 2.0 percentage points (the spread used).
ACC_SPREAD = 2.0


def cnn_epoch(pallas_dw: bool, seed: int, precision: str = "bf16",
              max_steps: int = 0) -> dict:
    """One epoch of Engine-driven cnn training (844 steps of 64, or the
    first ``max_steps``; bf16 unless ``precision`` names another preset),
    as bench.py drives the JAX one, then validation.  K5's count is set
    to 0 just before and read just after."""
    import torch

    from distributedpytorch_tpu_torch import utils
    from distributedpytorch_tpu_torch.data.datasets import load_dataset
    from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.ops import conv
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine

    ds = load_dataset("mnist", os.path.join(WORK, "data"), seed,
                      synthetic_fallback=True)
    policy = PRESETS[precision]
    train = ResidentLoader(ds.splits["train"], TRAIN_BATCH, True, seed,
                           "cuda")
    valid = ResidentLoader(ds.splits["valid"], TRAIN_BATCH, False, seed,
                           "cuda")
    model = get_model("cnn", ds.nb_classes, policy, device="cuda",
                      pallas_dw=pallas_dw)
    engine = Engine(model, cross_entropy, ds.mean, ds.std, 28, policy,
                    "cuda", steps_per_epoch=len(train))
    state = engine.init_state(torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    conv.conv3x3_dw.launches = 0
    conv.conv3x3_dw.tensor_core_launches = 0
    t0 = time.perf_counter()
    hist = []
    for i, (images, labels, v) in enumerate(train.epoch(0)):
        if i == max_steps > 0:
            break
        gen = utils.step_generator(seed, 0, i, "cuda")
        _, m = engine.train_step(state, images, labels, v, gen)
        hist.append(m["loss"])
    losses = torch.stack(hist).cpu().numpy()
    wall = time.perf_counter() - t0
    correct = n = 0.0
    for images, labels, v in valid.epoch(0):
        m = engine.eval_step(state, images, labels, v)
        correct += m["correct"].item()
        n += m["valid"].item()
    launches = conv.conv3x3_dw.launches
    tc_launches = conv.conv3x3_dw.tensor_core_launches
    k = max(1, len(losses) // 10)
    return dict(steps=len(losses), launches=launches,
                tc_launches=tc_launches, wall=wall,
                acc=100.0 * correct / n, first=float(losses[:k].mean()),
                last=float(losses[-k:].mean()),
                skipped=int(state.step - state.updates),
                scale=(float(state.loss_scale.scale) if state.loss_scale
                       else None))


# phase 12's steps: a quarter of an epoch of 844, cut for the run's time
# limit
CNN_EPOCH_STEPS = 211


def phase_cnn_epoch() -> int:
    runs = {("k5", SEED): cnn_epoch(True, SEED, max_steps=CNN_EPOCH_STEPS),
            ("stock", SEED): cnn_epoch(False, SEED,
                                       max_steps=CNN_EPOCH_STEPS)}
    for (path, seed), r in runs.items():
        say(f"cnn: epoch, {path} dW, seed {seed}: {r['steps']} steps in "
            f"{r['wall']:.2f}s ({r['steps'] / r['wall']:.1f} steps/s, "
            f"{r['steps'] * TRAIN_BATCH / r['wall']:,.0f} samples/s), "
            f"validation acc {r['acc']:.2f}% (chance 10%), mean train loss "
            f"first 10% {r['first']:.5f} last 10% {r['last']:.5f}, K5 "
            f"launches {r['launches']} ({r['tc_launches']} on the tensor "
            f"cores)")
    k5, stock = runs[("k5", SEED)], runs[("stock", SEED)]
    say(f"cnn: K5 vs stock dW accuracy {k5['acc']:.2f}% vs "
        f"{stock['acc']:.2f}% (spread used {ACC_SPREAD} points)")
    if k5["launches"] != 3 * k5["steps"] or k5["steps"] != CNN_EPOCH_STEPS:
        fail(f"K5 launches {k5['launches']} over {k5['steps']} steps: "
             f"expected 3 per step")
    if k5["tc_launches"] != k5["launches"]:
        fail(f"only {k5['tc_launches']} of the cnn's {k5['launches']} K5 "
             f"launches took the tensor-core route")
    if stock["launches"]:
        fail("the stock cnn launched K5")
    if k5["acc"] < 20.0 or not k5["last"] < k5["first"]:
        fail(f"the cnn with K5 did not learn: acc {k5['acc']}%, loss "
             f"{k5['first']} -> {k5['last']}")
    if abs(k5["acc"] - stock["acc"]) > ACC_SPREAD:
        fail(f"the cnn with K5 reaches {k5['acc']}% against the stock "
             f"conv's {stock['acc']}%")
    return k5["launches"]


# -- phase 13: the reference's job under torchrun ---------------------------

def eval_accuracy(ckpt_path: str, name: str, data: str = "",
                  precision: str = "bf16", moe_experts: int = 0,
                  pipelined: bool = False) -> tuple:
    """In-process eval of a checkpoint on the test split of ``data``
    (WORK/data by default), batch 64 in the ``precision`` preset, a vit
    with ``moe_experts`` (``pipelined``: the pipelined vit, its blocks in
    order): (accuracy to 2 decimals as `test` logs it, correct, rows)."""
    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.data.datasets import load_dataset
    from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader
    from distributedpytorch_tpu_torch.models import (get_model,
                                                     get_model_input_size)
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine, TrainState

    ds = load_dataset("mnist", data or os.path.join(WORK, "data"), SEED,
                      synthetic_fallback=True)
    policy = PRESETS[precision]
    if pipelined:
        from distributedpytorch_tpu_torch.models.registry import store_params
        from distributedpytorch_tpu_torch.models.vit_pipeline import (
            PipelinedViT)

        model = store_params(PipelinedViT(
            ds.nb_classes, dtype=policy.compute_dtype, device="cuda"),
            policy.param_dtype)
    else:
        model = get_model(name, ds.nb_classes, policy,
                          attention="flash" if name == "vit" else "full",
                          device="cuda", moe_experts=moe_experts)
    ckpt.restore_for_serving(ckpt_path, model)
    engine = Engine(model, cross_entropy, ds.mean, ds.std,
                    get_model_input_size(name), policy, "cuda")
    loader = ResidentLoader(ds.splits["test"], TRAIN_BATCH, False, SEED,
                            "cuda")
    correct = n = 0.0
    for images, labels, valid in loader.epoch(0):
        m = engine.eval_step(TrainState(model, None), images, labels, valid)
        correct += m["correct"].item()
        n += m["valid"].item()
    return f"{correct / n * 100:.2f}", int(correct), int(n)


def phase_reference_job() -> None:
    """On phase 22's corpus (cut from the whole synthetic one for the
    run's time limit: 18 steps instead of 844).  The two short trainings
    run beside the resnet's (none of the three is timed here), and `test`
    after it."""
    write_zoo_data()
    rsl = os.path.join(WORK, "resnet_rsl")
    (wall, log), *debug = finish_all(
        [start_cli(["train", "-e", "1"], rsl, launcher=TORCHRUN,
                   data=ZOO_DATA)]
        + [start_cli(["train", "--model", name, "--debug", "-e", "1"],
                     os.path.join(WORK, f"{name}_debug"))
           for name in ("mlp", "cnn")])
    if "process: 0/1, world size: 1, backend: nccl" not in log:
        fail("the torchrun launch did not join an NCCL process group")
    launches, steps, evals = parse_launches(log, "train")
    valid_acc = float(re.search(r"Validation  \| Loss: [\d.]+ +\| Acc: "
                                r"([\d.]+)%", log).group(1))
    train_loss = float(re.search(r"Train       \| Loss: ([\d.]+)",
                                 log).group(1))
    sps = float(re.search(r"Throughput  \| ([\d,]+) samples/s/chip",
                          log).group(1).replace(",", ""))
    say(f"resnet: `torchrun train` (default model, 224, NCCL): {steps} "
        f"steps and {evals} eval batches in {wall:.1f}s of process wall; "
        f"train pass {sps:,.0f} samples/s/chip ({sps / TRAIN_BATCH:.1f} "
        f"steps/s); mean train loss {train_loss:.5f}, validation acc "
        f"{valid_acc:.2f}%; launches {launches}")
    if steps != math.ceil(int(ZOO_TRAIN_ROWS * 0.9) / TRAIN_BATCH) \
            or any(launches.values()):
        fail(f"resnet train ran {steps} steps with launches {launches}")
    best = os.path.join(rsl, "bestmodel-mnist-resnet.ckpt")
    _, tlog = run_cli(["test", "-f", best], os.path.join(WORK, "resnet_test"),
                      launcher=TORCHRUN, data=ZOO_DATA)
    acc_cli = re.search(r"Time: \d+m \d+s, Acc: ([\d.]+)%", tlog).group(1)
    acc_here, correct, n = eval_accuracy(best, "resnet", ZOO_DATA)
    say(f"resnet: `torchrun test -f` accuracy {acc_cli}%; in-process eval "
        f"{acc_here}% ({correct}/{n})")
    if acc_cli != acc_here:
        fail("resnet test's accuracy disagrees with the in-process eval")
    for name, (wall, log) in zip(("mlp", "cnn"), debug):
        acc = re.search(r"Validation  \| Loss: [\d.]+ +\| Acc: ([\d.]+)%",
                        log).group(1)
        say(f"{name}: `train --debug -e 1` finished in {wall:.1f}s (run "
            f"beside the resnet's and the other), validation acc {acc}%")


# -- phase 14: two ranks on the one card -------------------------------------

# Two ranks (gloo over CUDA tensors) against one rank fed the same global
# batch and draws, TF32 off, each tensor relative to its largest value.
# f32: the sums run in other orders (per rank then across ranks, cuDNN at
# half the batch per call), 1e-4 for the cnn; the resnet's ReLU decisions
# after BatchNorm flip at f32 rounding as in phase 11 (5.7e-3 seen), so
# it is held to 5e-2 in f32 and, on an identity affine in f64, to 1e-6
# (the gradients are still cast to the f32 parameters per rank).
TOL_DDP = {("cnn", "f32"): 1e-4, ("resnet_shallow", "f32"): 5e-2,
           ("resnet_shallow", "f64"): 1e-6}
DDP_CASES = tuple(TOL_DDP)
DDP_GLOBAL_BATCH = 16
# one rank of a world: three SGD steps, shared with tests/test_torch_ddp.py
DDP_CHILD = os.path.join(ROOT, "tests", "_torch_ddp_child.py")


def run_worlds(worlds: list) -> list:
    """Starts every world of ``worlds`` at once, each (name, world size,
    child script, arguments before OUT, arguments after it): every rank a
    ``python SCRIPT ... OUT.pt ... --device cuda`` process on the card
    (several ranks run gloo over CUDA tensors), each world on its own
    rendezvous port.  Returns each world's per-rank results (the OUT.pt
    files, which the children write) once all ranks have exited."""
    import torch

    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "LOCAL_WORLD_SIZE")}
    procs, outs, ports = [], [], set()
    try:
        for name, world, script, head, tail in worlds:
            port = free_port()
            while port in ports:
                port = free_port()
            ports.add(port)
            outs.append([])
            for rank in range(world):
                extra = {} if world == 1 else dict(
                    WORLD_SIZE=str(world), RANK=str(rank),
                    LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
                out = os.path.join(WORK, f"{name}-r{rank}.pt")
                outs[-1].append(out)
                with open(out[:-3] + ".log", "w") as f:
                    procs.append((name, out, subprocess.Popen(
                        [sys.executable, script, *head, out, "--device",
                         "cuda", *tail], cwd=ROOT, env={**env, **extra},
                        stdout=f, stderr=subprocess.STDOUT)))
        deadline = time.monotonic() + 300
        for name, out, proc in procs:
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = None
            if rc != 0:
                with open(out[:-3] + ".log") as f:
                    fail(f"child {name} exited with {rc}:\n"
                         f"{f.read()[-3000:]}")
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [[torch.load(o, weights_only=False) for o in world_outs]
            for world_outs in outs]


def phase_ddp_one_card() -> None:
    import torch

    keys = [(name, label, world) for name, label in DDP_CASES
            for world in (1, 2)]
    worlds = dict(zip(keys, run_worlds([
        (f"ddp-{name}-{label}-w{world}", world, DDP_CHILD, [name],
         ["--global-batch", str(DDP_GLOBAL_BATCH), "--precision", label])
        for name, label, world in keys])))
    for name, label in DDP_CASES:
        one = worlds[(name, label, 1)][0]
        two = worlds[(name, label, 2)]
        if [r["backend"] for r in two] != ["gloo", "gloo"] \
                or one["backend"] is not None:
            fail(f"backends {[r['backend'] for r in two]}: two ranks on one "
                 f"card must run gloo, one rank no process group")
        a = two[0]
        same = all(torch.equal(v, a["state"][k])
                   for k, v in two[1]["state"].items())
        if not same or two[1]["metrics"] != a["metrics"]:
            fail(f"the two ranks of {name} disagree in {label}")
        w = worst(a["state"], one["state"])
        loss_err = max(abs(x[0] - y[0]) for x, y in
                       zip(a["metrics"], one["metrics"]))
        counts_equal = [x[1:] for x in a["metrics"]] == \
            [y[1:] for y in one["metrics"]]
        k5 = [r["k5"] for r in two] + [one["k5"]]
        n_stats = sum("running" in k for k in one["state"])
        tol = TOL_DDP[(name, label)]
        say(f"ddp: {name}, 2 ranks on one card (gloo) vs 1 rank, 3 {label} "
            f"steps on a global batch of {DDP_GLOBAL_BATCH}: worst tensor "
            f"{w[0]} rel err {w[1]:.3g} (tol {tol:g}) over "
            f"{len(one['state'])} tensors ({n_stats} BN statistics); loss "
            f"err {loss_err:.3g}; correct/valid counts equal: "
            f"{counts_equal}; K5 launches per rank {k5}")
        want_k5 = 9 if name == "cnn" else 0
        if not (math.isfinite(w[1]) and w[1] <= tol) \
                or loss_err > 1e-5 or not counts_equal \
                or k5 != [want_k5] * 3:
            fail(f"the 2-rank {name} world does not equal 1 rank in "
                 f"{label}")


# -- phase 15: profiles of the cnn and resnet train steps -------------------

def phase_cnn_profile() -> None:
    """One cnn (K5) train step at batch 64 bf16: wall ms
    per step (host clock, synchronized, profiler off), then from a second
    run under torch.profiler the device time, kernels per step, the idle
    share, and K5's share of device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributedpytorch_tpu_torch import utils
    from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader
    from distributedpytorch_tpu_torch.models import (get_model,
                                                     get_model_input_size)
    from distributedpytorch_tpu_torch.ops import conv
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine

    ds = work_dataset()
    loader = ResidentLoader(ds.splits["train"], TRAIN_BATCH, True, SEED,
                            "cuda")
    reps = 20
    batches = list(itertools.islice(loader.epoch(0), 5 + 2 * reps))
    # resnet18's step: phase 35 profiles it, eager and graphed
    for name in ("cnn",):
        policy = PRESETS["bf16"]
        model = get_model(name, ds.nb_classes, policy, device="cuda",
                          pallas_dw=name == "cnn")
        engine = Engine(model, cross_entropy, ds.mean, ds.std,
                        get_model_input_size(name), policy, "cuda")
        state = engine.init_state(torch.Generator().manual_seed(SEED))

        def step(i):
            gen = utils.step_generator(SEED, 0, i, "cuda")
            engine.train_step(state, *batches[i], gen)

        for i in range(5):
            step(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            step(5 + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        k5_before = conv.conv3x3_dw.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                step(5 + reps + i)
            torch.cuda.synchronize()
        k5_launches = (conv.conv3x3_dw.launches - k5_before) / reps
        kernels = device_kernels(prof)
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
        n_kern = sum(e.count for e in kernels) / reps
        if dev_ms <= 0:
            say(f"profile: {name} train step: wall {wall_ms:.3f} ms/step; "
                f"device time not measured (no device events)")
            continue
        k5_us = sum(e.self_device_time_total for e in kernels
                    if "conv_dw" in e.key) / reps
        say(f"profile: {name} train step, batch {TRAIN_BATCH} bf16: wall "
            f"{wall_ms:.3f} ms/step, device {dev_ms:.3f} ms in "
            f"{n_kern:.0f} kernels (idle {100 * (1 - dev_ms / wall_ms):.1f}"
            f"%); K5 {k5_us:.2f} us/step "
            f"({100 * k5_us / 1e3 / dev_ms:.1f}% of device time) in "
            f"{k5_launches:g} launches"
            + (f", {k5_us / k5_launches:.2f} us a launch" if k5_launches
               else ""))
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)
        say("profile:   top: " + "; ".join(
            f"{e.key[:48]} {e.self_device_time_total / reps:.1f}us"
            f"x{e.count // reps}" for e in top[:6]))


# -- phase 16: K4, K2p and K3p against their plain versions ------------------

# (label, B, S, H, D, causal, q block, k block, kv_valid, timed): q's
# positions are q_block * S + 0..S-1, k's k_block * S + 0..S-1, as on the
# ring, where the rank of model index m holds block m and sees block
# (m - t) mod M at step t.  The vit's shard on a ring of two is S = 25 of
# its 49 tokens padded to 50 (kv_valid 49), at B = 128 (the data shard's
# 2 x 64 rows).
RING_CASES = (
    ("vit rank-1 q vs rank-0 K/V", 128, 25, 4, 32, False, 1, 0, 49, True),
    ("vit rank-1 q vs its own K/V", 128, 25, 4, 32, False, 1, 1, 49, False),
    ("vit keys all padding", 128, 25, 4, 32, False, 0, 2, 50, False),
    ("causal future block (all masked)", 8, 128, 4, 64, True, 0, 1, None,
     False),
    ("causal past block", 8, 128, 4, 64, True, 1, 0, None, False),
    ("causal diagonal block", 8, 128, 4, 64, True, 1, 1, None, True),
    ("wide heads D=128", 8, 128, 4, 128, False, 1, 0, None, True),
    ("long shard", 2, 500, 4, 64, True, 1, 1, None, True),
)
RING_MAIN = ("vit rank-1 q vs rank-0 K/V", "bfloat16")
# K4's O and lse against the plain version: both f32 from the same f32
# (or exactly widened bf16) inputs, sums in other orders.  K2p/K3p: as
# K2/K3 (TOL_GRAD), relative to the plain version's largest value; K2p's
# delta against partial_delta as K2's (TOL_DELTA).
TOL_O_POS = 2e-5
# K4's f32 O on its bf16 tensor-core route against the plain version: that
# route rounds p to bf16 before the P V product (as FlashAttention-2 and
# SDPA do), which moves O by up to about 2^-9 max|v|; the ring casts its
# merged O to bf16 anyway (ops/attention.py, _ring_local_flash), so the
# error is one bf16 rounding, as for K1's bf16 O (TOL_O).  The scalar route
# and every f32 case stay at TOL_O_POS; lse at TOL_LSE on both routes.
TOL_O_POS_TC = TOL_O["bfloat16"]


def ring_bounds(b, s, h, d, dtype_name, pairs, tensor_core):
    """Least times of K4, K2p, K3p and the backward as the ring step runs
    it ("bwd": K2p then K3p, as one function) (ms, "bytes" or
    "operations"): each input read once and each output written once, or
    the products on the ``pairs`` (q, k) pairs that the masks keep (K4: 2,
    K2p: 3, K3p: 4, the backward: 5 products of 2 * D operations a pair
    and head) at the card's peak for the input type.  K4 reads q, k, v
    and two (S,) int32 position vectors and writes the f32 O and lse.  K2p
    reads q, k, v, the f32 dO and O, lse, dlse and the positions, and
    writes dq and delta, and on the ``tensor_core`` route the bf16 dO;
    K3p reads q, k, v, that dO (else the f32 one), lse, delta and the
    positions, and writes dk and dv.  The backward reads q, k, v, the f32
    dO and O, lse, dlse and the positions and writes dq, dk and dv."""
    item = 4 if dtype_name == "float32" else 2
    t = b * s * h * d
    rows = b * h * s * 4
    pos = 2 * s * 4
    do_k3 = 2 if tensor_core else 4
    nbytes = {"flash_fwd_pos": 3 * t * item + pos + 4 * t + rows,
              "flash_dq_pos": 4 * t * item + 8 * t + 3 * rows + pos
              + (2 * t if tensor_core else 0),
              "flash_dkv_pos": 5 * t * item + do_k3 * t + 2 * rows + pos,
              "bwd": 6 * t * item + 8 * t + 2 * rows + pos}
    products = {"flash_fwd_pos": 2, "flash_dq_pos": 3, "flash_dkv_pos": 4,
                "bwd": 5}
    out = {}
    for name, nb in nbytes.items():
        t_bytes = nb / HBM_BYTES_PER_S * 1e3
        t_ops = (products[name] * 2 * b * h * pairs * d
                 / PEAK_OPS_PER_S[dtype_name] * 1e3)
        out[name] = ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations"))
    return out


def phase_ring_kernels():
    """K4 against its plain version, and K2p/K3p against theirs: each case
    on the route the rule picks and, at a tensor-core case, on the scalar
    route too (forced), K4 held to TOL_O_POS_TC on the tensor cores and
    TOL_O_POS on the scalar route (rows with no key kept: O exactly 0 and
    lse -1e30 on both), K2p/K3p to TOL_GRAD; K2p's delta against
    ``partial_delta``; two calls bit-identical; at the timed cases times
    of K4, K2p, K3p and the backward as the ring step runs it (K2p, which
    computes delta and rounds dO, then K3p) beside the old line
    (``partial_delta``, then the scalar K2p and K3p) and SDPA's."""
    import torch
    import torch.nn.functional as F

    from distributedpytorch_tpu_torch.ops import flash_attention as tfa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rows = {}
    wrappers = {"flash_fwd_pos": tfa.flash_attention_partial_fwd,
                "flash_dq_pos": tfa.flash_attention_partial_dq,
                "flash_dkv_pos": tfa.flash_attention_partial_dkv}

    def counts():
        return {n: (w.launches, w.tensor_core_launches)
                for n, w in wrappers.items()}

    for (label, b, s, h, d, causal, qb, kb, kv_valid, timed) in RING_CASES:
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                              device="cuda").to(dtype)
            q, k, v = (t.reshape(b, s, h, d)
                       for t in qkv.split(h * d, dim=-1))
            base = torch.arange(s, dtype=torch.int32, device="cuda")
            qp, kp = base + qb * s, base + kb * s
            do = torch.randn((b, s, h, d), generator=gen, device="cuda")
            dlse = torch.randn((b * h, s), generator=gen, device="cuda")
            fwd_tc = tfa._pick_route(None, (q, k, v), kernel="K4")
            fwd_route = "tensor_core" if fwd_tc else "scalar"
            before = counts()
            o, lse = tfa.flash_attention_partial_fwd(q, k, v, qp, kp, causal,
                                                     kv_valid)
            tc = tfa._pick_route(None, (q, k, v, do, o), positional=True)
            route = "tensor_core" if tc else "scalar"
            dq, delta, do_k3 = tfa.flash_attention_partial_dq(
                q, k, v, o, do, lse, dlse, qp, kp, causal, kv_valid)
            dk, dv = tfa.flash_attention_partial_dkv(
                q, k, v, do_k3, lse, delta, qp, kp, causal, kv_valid)
            again = tfa.flash_attention_partial_bwd(
                q, k, v, o, lse, do, dlse, qp, kp, causal, kv_valid)
            torch.cuda.synchronize()
            want = {"flash_fwd_pos": (1, fwd_tc), "flash_dq_pos": (2, 2 * tc),
                    "flash_dkv_pos": (2, 2 * tc)}
            now = counts()
            if any((now[n][0] - before[n][0], now[n][1] - before[n][1])
                   != want[n] for n in wrappers):
                fail(f"K4/K2p/K3p wrappers did not count their {route} "
                     f"launches at {label} {dt}: {before} -> {now}")
            if not all(torch.equal(x, y) for x, y in zip((dq, dk, dv),
                                                         again)):
                fail(f"K2p/K3p's {route} route is not deterministic at "
                     f"{label} {dt}")
            fwd = {fwd_route: (o, lse)}
            if fwd_tc:
                fwd["scalar"] = tfa._launch(
                    q, k, v, causal, (qp, kp, kv_valid),
                    tfa.flash_attention_partial_fwd, tensor_core=False)
            o2, lse2 = tfa.flash_attention_partial_fwd(q, k, v, qp, kp,
                                                       causal, kv_valid)
            if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                fail(f"K4's {fwd_route} route is not deterministic at "
                     f"{label} {dt}")
            checked = {route: (delta, dq, dk, dv)}
            if tc:
                sdq, sdelta, sdo = tfa._dq_pos_launch(
                    q, k, v, o, do, lse, dlse, qp, kp, causal, kv_valid,
                    tensor_core=False)
                sdk, sdv = tfa.flash_attention_partial_dkv(
                    q, k, v, sdo, lse, sdelta, qp, kp, causal, kv_valid)
                checked["scalar"] = (sdelta, sdq, sdk, sdv)
            po, plse = tfa.flash_attention_partial_plain(q, k, v, qp, kp,
                                                         causal, kv_valid)
            want_delta = tfa.partial_delta(o, do, dlse)
            pdq, pdk, pdv = tfa.flash_attention_partial_bwd_plain(
                q, k, v, o, lse, do, dlse, qp, kp, causal, kv_valid)
            keep = torch.ones((s, s), dtype=torch.bool, device="cuda")
            if causal:
                keep &= qp[:, None] >= kp[None, :]
            if kv_valid is not None:
                keep &= (kp < kv_valid)[None, :]
            dead = ~keep.any(dim=1)      # query rows with no key kept
            tol = TOL_GRAD[dt]
            finite = all(torch.isfinite(x).all().item()
                         for x in (o, lse, dq, dk, dv, delta))
            fwd_errs = {}
            for r, (x_o, x_lse) in fwd.items():
                tol_o = TOL_O_POS_TC if r == "tensor_core" else TOL_O_POS
                fwd_errs[r] = ((x_o - po).abs().max().item(),
                               (x_lse - plse).abs().max().item(), tol_o)
                empty = (not x_o[:, dead].any().item() and bool(
                    (x_lse.reshape(b, h, s)[:, :, dead] == -1e30).all()))
                if not (finite and fwd_errs[r][0] <= tol_o
                        and fwd_errs[r][1] <= TOL_LSE and empty):
                    fail(f"K4's {r} route disagrees with its plain version "
                         f"at {label} {dt}: err_o {fwd_errs[r][0]} (tol "
                         f"{tol_o}), err_lse {fwd_errs[r][1]} (tol "
                         f"{TOL_LSE}), finite {finite}, rows with no key: "
                         f"O = 0 and lse = -1e30 {empty}")
            err_o = fwd_errs[fwd_route][0]
            errs = {}
            for r, (x_delta, x_dq, x_dk, x_dv) in checked.items():
                errs[r] = {"delta": rel_err(x_delta, want_delta),
                           "dq": rel_err(x_dq, pdq), "dk": rel_err(x_dk, pdk),
                           "dv": rel_err(x_dv, pdv)}
                bad = {n: e[1] for n, e in errs[r].items()
                       if not (math.isfinite(e[1]) and e[1] <= (
                           TOL_DELTA if n == "delta" else tol))}
                if bad:
                    fail(f"K2p/K3p's {r} route disagrees with the plain "
                         f"version at {label} {dt}: {bad} (tol {tol}, "
                         f"delta {TOL_DELTA})")
            pairs = int(keep.sum().item())
            bounds = ring_bounds(b, s, h, d, dt, pairs, tc)
            line = (f"ring kernels {label} {(b, s, h, d)} {dt} causal="
                    f"{causal} kv_valid={kv_valid} ({pairs} of {s * s} "
                    f"pairs kept, {int(dead.sum())} rows with none), K4 "
                    f"{fwd_route} route, K2p/K3p {route} route: K4 "
                    + "; ".join(f"{r} err_o={e[0]:.3g} (tol {e[2]:g}) "
                                f"err_lse={e[1]:.3g}"
                                for r, e in fwd_errs.items())
                    + f" (tol {TOL_LSE:g}); rel err "
                    + "; ".join(f"{r} " + " ".join(f"{n}={e[1]:.3g}"
                                                   for n, e in es.items())
                                for r, es in errs.items())
                    + f" (tol {tol:g}, delta {TOL_DELTA:g}, dlse nonzero), "
                    "bit-identical; bound_us "
                    + " ".join(f"{n}={t * 1e3:.3f} ({by})"
                               for n, (t, by) in bounds.items()))
            if not timed:
                say(line)
                continue
            # yardstick only: SDPA with the same boolean mask (it returns
            # no lse), and its backward for dq, dk and dv in one call
            qt, kt, vt = (t.detach().transpose(1, 2).contiguous()
                          .requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep)
            dot = do.to(dtype).transpose(1, 2).contiguous()
            reps = 50 if s < 500 else 20
            main = (label, dt) == RING_MAIN

            def old_bwd():
                x_delta = tfa.partial_delta(o, do, dlse)
                _, _, x_do = tfa._dq_pos_launch(
                    q, k, v, o, do, lse, dlse, qp, kp, causal, kv_valid,
                    tensor_core=False)
                tfa.flash_attention_partial_dkv(q, k, v, x_do, lse, x_delta,
                                                qp, kp, causal, kv_valid)

            fns = {
                "K4": lambda: tfa.flash_attention_partial_fwd(
                    q, k, v, qp, kp, causal, kv_valid),
                "sdpa": lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=keep),
                "K2p": lambda: tfa.flash_attention_partial_dq(
                    q, k, v, o, do, lse, dlse, qp, kp, causal, kv_valid),
                "K3p": lambda: tfa.flash_attention_partial_dkv(
                    q, k, v, do_k3, lse, delta, qp, kp, causal, kv_valid),
                "bwd": lambda: tfa.flash_attention_partial_bwd(
                    q, k, v, o, lse, do, dlse, qp, kp, causal, kv_valid),
                "sdpa bwd": lambda: torch.autograd.grad(
                    out, (qt, kt, vt), dot, retain_graph=True)}
            if fwd_tc:
                fns["scalar K4"] = lambda: tfa._launch(
                    q, k, v, causal, (qp, kp, kv_valid),
                    tfa.flash_attention_partial_fwd, tensor_core=False)
            if tc:
                fns["scalar K2p"] = lambda: tfa._dq_pos_launch(
                    q, k, v, o, do, lse, dlse, qp, kp, causal, kv_valid,
                    tensor_core=False)
                fns["scalar K3p"] = lambda: tfa.flash_attention_partial_dkv(
                    q, k, v, do, lse, delta, qp, kp, causal, kv_valid)
                fns["old bwd"] = old_bwd
            if main:
                fns["K4 plain"] = lambda: tfa.flash_attention_partial_plain(
                    q, k, v, qp, kp, causal, kv_valid)
                fns["bwd plain"] = \
                    lambda: tfa.flash_attention_partial_bwd_plain(
                        q, k, v, o, lse, do, dlse, qp, kp, causal, kv_valid)
            call = {n: time_ms(f, reps) for n, f in fns.items()}
            dev = {n: spread(t)[0] for n, t in
                   device_ms_tries(fns, reps, timing_tries(main)).items()}
            say(line + f"; {timing_note(main)}; " + times_text(dev, call)
                + "; launches " + " ".join(
                    f"{n}={w.launches} (tensor-core "
                    f"{w.tensor_core_launches})" for n, w in (
                        ("K4", tfa.flash_attention_partial_fwd),
                        ("K2p", tfa.flash_attention_partial_dq),
                        ("K3p", tfa.flash_attention_partial_dkv))))
            for name, key, plain, lib, err in (
                    ("flash_fwd_pos", "K4", "K4 plain", "sdpa",
                     (err_o, err_o)),
                    ("flash_dq_pos", "K2p", "bwd plain", "sdpa bwd",
                     max(errs[route]["delta"], errs[route]["dq"],
                         key=lambda e: e[1])),
                    ("flash_dkv_pos", "K3p", "bwd plain", "sdpa bwd",
                     max(errs[route]["dk"], errs[route]["dv"],
                         key=lambda e: e[1]))):
                row = dict(
                    max_abs_err=err[0], ms=dev[key], plain_ms=dev.get(plain),
                    library_ms=dev[lib], bound_ms=bounds[name][0],
                    bound_by=bounds[name][1], call_ms=call[key],
                    plain_call_ms=call.get(plain), library_call_ms=call[lib])
                if name == "flash_fwd_pos":
                    row.update(
                        tc_route=fwd_route, scalar_ms=dev.get("scalar K4"),
                        scalar_max_abs_err=(fwd_errs["scalar"][0]
                                            if fwd_tc else None))
                else:
                    parts = ("delta", "dq") if key == "K2p" else ("dk", "dv")
                    row.update(
                        tc_route=route, scalar_ms=dev.get("scalar " + key),
                        scalar_rel_err=(max(errs["scalar"][n][1]
                                            for n in parts) if tc else None),
                        delta_rel_err=errs[route]["delta"][1],
                        bwd_ms=dev["bwd"], old_bwd_ms=dev.get("old bwd"),
                        bwd_bound_ms=bounds["bwd"][0])
                rows[(name, label, dt)] = row
    return rows


# -- phase 17: the ring op on two ranks sharing the card ----------------------

RING_CHILD = os.path.join(ROOT, "tests", "_torch_ring_child.py")
# (label, B, S, H, D, dtype, causal): S = 49 is the vit's (padded to 50,
# the padded key masked); the causal long shape gives each rank 500 rows.
RING_OP_CASES = (("vit", 128, 49, 4, 32, "float32", False),
                 ("vit", 128, 49, 4, 32, "bfloat16", False),
                 ("causal long", 2, 1000, 4, 64, "float32", True))
# The ring against one process's full_attention (ring) or flash_attention
# (ring_flash), absolute: f32 outputs 2e-5 and gradients 5e-5 (the JAX
# package's ring-test tolerances: the same f32 math in other orders);
# bf16: 2e-2 of the largest value (one rounding of the output, and of
# each ring step's gradient).
TOL_RING_OP = {"float32": (2e-5, 5e-5), "bfloat16": (2e-2, 2e-2)}


def ring_world(mode: str, spec, world: int, name: str, *args) -> tuple:
    """A ``run_worlds`` entry of ``tests/_torch_ring_child.py MODE`` on
    ``spec`` (saved to WORK/NAME-in.pt) in ``world`` ranks."""
    import torch

    inp = os.path.join(WORK, f"{name}-in.pt")
    torch.save(spec, inp)
    return name, world, RING_CHILD, [mode, inp], list(args)


def phase_ring_op() -> None:
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.ops.attention import full_attention
    from distributedpytorch_tpu_torch.ops.flash_attention import (
        flash_attention)

    rng = np.random.default_rng(SEED + 5)
    spec, refs = [], []
    for (label, b, s, h, d, dt, causal) in RING_OP_CASES:
        q, k, v, w = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                      for _ in range(4))
        for flash in (False, True):
            if dt == "bfloat16" and not flash:
                continue        # the einsum ring computes in f32 anyway
            spec.append(dict(q=q, k=k, v=v, w=w, causal=causal,
                             use_flash=flash, ragged=s % 2 != 0, dtype=dt))
            ts = [torch.from_numpy(x).cuda().to(getattr(torch, dt))
                  .requires_grad_() for x in (q, k, v)]
            fn = flash_attention if flash else full_attention
            o = fn(*ts, causal)
            (o.float() * torch.from_numpy(w).cuda()).sum().backward()
            refs.append((label, dt, causal, flash,
                         [x.detach().float().cpu() for x in
                          (o, *(t.grad for t in ts))]))
    t0 = time.perf_counter()
    got, = run_worlds([ring_world("attn", spec, 2, "ring_op")])
    wall = time.perf_counter() - t0
    if [r["backend"] for r in got] != ["gloo", "gloo"]:
        fail(f"two ranks on one card must run gloo, got "
             f"{[r['backend'] for r in got]}")
    for i, (label, dt, causal, flash, ref) in enumerate(refs):
        tol_o, tol_g = TOL_RING_OP[dt]
        for r in got:
            res = [torch.from_numpy(r["cases"][i][n])
                   for n in ("o", "dq", "dk", "dv")]
            if dt == "float32":
                errs = [(a - e).abs().max().item() for a, e in zip(res, ref)]
            else:
                errs = [rel_err(a, e)[1] for a, e in zip(res, ref)]
            ok = all(math.isfinite(e) for e in errs) and errs[0] <= tol_o \
                and max(errs[1:]) <= tol_g
            if r["rank"] == 0 or not ok:
                say(f"ring op {label} {dt} causal={causal} "
                    f"{'ring_flash vs flash' if flash else 'ring vs full'} "
                    f"(rank {r['rank']} of 2, gloo): "
                    f"{'rel ' if dt == 'bfloat16' else ''}err o={errs[0]:.3g} "
                    f"(tol {tol_o:g}) dq={errs[1]:.3g} dk={errs[2]:.3g} "
                    f"dv={errs[3]:.3g} (tol {tol_g:g})")
            if not ok:
                fail(f"the 2-rank ring disagrees at {label} {dt}")
    say(f"ring op: {len(refs)} cases on 2 ranks in {wall:.1f}s of process "
        f"wall (start-up included)")


# -- phase 18: the ring slice's main path -------------------------------------

TORCHRUN2 = ("-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2")
MODEL_PARALLEL = 2


def parse_ring_launches(log: str, action: str) -> dict:
    m = re.search(rf"{action}: ring kernel launches flash_fwd_pos (\d+), "
                  rf"flash_dq_pos (\d+), flash_dkv_pos (\d+) over", log)
    if m is None:
        fail(f"{action} did not log its ring kernel launches")
    return dict(zip(("flash_fwd_pos", "flash_dq_pos", "flash_dkv_pos"),
                    (int(x) for x in m.groups())))


def parse_ring_tensor_core_launches(log: str, action: str) -> dict:
    """The ``ACTION: ring tensor-core launches ...`` line: K4's, K2p's and
    K3p's launches on the tensor cores."""
    m = re.search(rf"{action}: ring tensor-core launches flash_fwd_pos "
                  rf"(\d+), flash_dq_pos (\d+), flash_dkv_pos (\d+) over",
                  log)
    if m is None:
        fail(f"{action} did not log its ring tensor-core launches")
    return dict(zip(("flash_fwd_pos", "flash_dq_pos", "flash_dkv_pos"),
                    (int(x) for x in m.groups())))


RING = ("--attention", "ring_flash", "--model-parallel", str(MODEL_PARALLEL))


def start_ring_train() -> tuple:
    """``train --attention ring_flash --model-parallel 2`` on two ranks
    sharing the card, on RING_DATA."""
    write_ring_data()
    return start_cli(["train", "--model", "vit", *RING, "-e", "1"],
                     os.path.join(WORK, "ring_rsl"), launcher=TORCHRUN2,
                     data=RING_DATA)


def phase_ring_train(train_run: tuple) -> dict:
    """The ring train of ``start_ring_train``; then ``test -f`` under the
    same launch and ``test -f --attention flash`` in one process, at
    once."""
    ring = list(RING)
    rsl = os.path.join(WORK, "ring_rsl")
    wall, log = finish_all([train_run])[0]
    for line in ("process: 0/2, world size: 2, backend: gloo",
                 "mesh: data 1 x model 2, parameters placed and the ring "
                 "over the model group on gloo",
                 "batch size: 64/replica (128 global)"):
        if line not in log:
            fail(f"the ring train did not log {line!r}")
    say("ring train: " + re.search(r"mesh: .*", log).group(0))
    launches, steps, evals = parse_launches(log, "train")
    ring_launches = parse_ring_launches(log, "train")
    ring_tc = parse_ring_tensor_core_launches(log, "train")
    n_train = int(RING_DATA_TRAIN_ROWS * 0.9)
    world = 2
    want_steps = math.ceil(n_train / world / TRAIN_BATCH)
    want_evals = math.ceil((RING_DATA_TRAIN_ROWS - n_train) / world
                           / TRAIN_BATCH)
    per = DEPTH * MODEL_PARALLEL
    want = {"flash_fwd_pos": per * (steps + evals),
            "flash_dq_pos": per * steps, "flash_dkv_pos": per * steps}
    want_tc = dict(want)                # every K4, K2p and K3p
    say(f"ring train: launches {ring_launches} and {launches} over {steps} "
        f"steps and {evals} eval batches, on the tensor cores {ring_tc}; "
        f"formula {want}, all K4/K2p/K3p on the tensor cores, K1-K3 and K5 "
        f"0")
    if (steps, evals) != (want_steps, want_evals) or ring_launches != want \
            or ring_tc != want_tc or any(launches.values()):
        fail(f"ring train launches {ring_launches} (tensor-core {ring_tc}), "
             f"{launches} over {steps} steps / {evals} eval batches do not "
             f"match the formula {want} at {want_steps} steps / "
             f"{want_evals} eval batches, every K4, K2p and K3p on the "
             f"tensor cores")
    check_epoch_log("ring train", log, steps, wall)
    best = os.path.join(rsl, "bestmodel-mnist-vit.ckpt")
    (_, ring_log), (_, flash_log) = finish_all([
        start_cli(["test", "-f", best, *ring], os.path.join(WORK,
                                                           "ring_test"),
                  launcher=TORCHRUN2, data=RING_DATA),
        start_cli(["test", "-f", best, "--attention", "flash"],
                  os.path.join(WORK, "ring_test_flash"), data=RING_DATA)])
    acc_here, correct, n = eval_accuracy(best, "vit", RING_DATA)
    acc_ring = re.search(r"Time: \d+m \d+s, Acc: ([\d.]+)%",
                         ring_log).group(1)
    acc_flash = re.search(r"Time: \d+m \d+s, Acc: ([\d.]+)%",
                          flash_log).group(1)
    test_ring = parse_ring_launches(ring_log, "test")
    _, _, test_evals = parse_launches(ring_log, "test")
    rows_apart = abs(round(float(acc_ring) * n / 100) - correct)
    differ = ring_vs_flash_rows(best)
    allowed = differ + RING_TEST_ROWS
    say(f"ring test: `test -f` on 2 ranks (ring_flash) {acc_ring}% "
        f"({test_evals} eval batches, launches {test_ring}); `test -f "
        f"--attention flash` on 1 process {acc_flash}%; in-process flash "
        f"eval {acc_here}% ({correct}/{n}); ring vs flash {rows_apart} rows "
        f"apart (allowed {allowed}: the {differ} rows whose labels differ "
        f"above, plus {RING_TEST_ROWS})")
    if acc_flash != acc_here or rows_apart > allowed \
            or test_ring != {"flash_fwd_pos": per * test_evals,
                             "flash_dq_pos": 0, "flash_dkv_pos": 0}:
        fail("the ring-trained model's test disagrees with the in-process "
             "eval, or its launches with the formula")
    return ring_launches, ring_tc


def ring_vs_flash_rows(ckpt_path: str) -> int:
    """The ring's test against the one-process flash eval of the same
    file, row by row.  The two attentions round at other points (each
    rounds p to bf16 on the tensor cores, relative to its own running max;
    the ring merges its f32 partials, then casts once), so the argmax of a
    row whose two best logits lie within that noise may flip.  Takes the
    bf16 logits of every test row of phase 6's corpus from ``ring_flash``
    on two ranks (``tests/_torch_ring_child.py logits``) and from
    ``flash`` in this process, TRAIN_BATCH rows at a time; fails when
    they differ by more than TOL_RING_OP's bf16 share of the largest
    logit, or when a row's labels differ though its flash top-two margin
    exceeds twice their largest difference.  Returns the number of rows
    whose labels differ."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.data import augment
    from distributedpytorch_tpu_torch.data.datasets import load_dataset
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.precision import PRESETS

    ds = load_dataset("mnist", RING_DATA, SEED, synthetic_fallback=True)
    images = ds.splits["test"].images
    policy = PRESETS["bf16"]
    model = get_model("vit", ds.nb_classes, policy, attention="flash",
                      device="cuda")
    ckpt.restore_for_serving(ckpt_path, model)
    flash = []
    with torch.inference_mode():
        for i in range(0, len(images), TRAIN_BATCH):
            x = augment.eval_transform(
                torch.from_numpy(images[i:i + TRAIN_BATCH]).cuda(), ds.mean,
                ds.std, 28, out_dtype=policy.compute_dtype)
            flash.append(model(x).float().cpu().numpy())
    flash = np.concatenate(flash)
    spec = dict(arch={}, attention="ring_flash", precision="bf16",
                params={k: v.detach().cpu()
                        for k, v in model.state_dict().items()},
                images=images, mean=ds.mean, std=ds.std, batch=TRAIN_BATCH)
    ranks, = run_worlds([ring_world("logits", spec, MODEL_PARALLEL,
                                    "ring_logits", "--model-parallel",
                                    str(MODEL_PARALLEL))])
    ring = ranks[0]["logits"]
    noise = float(np.abs(ring - flash).max())
    scale = float(np.abs(flash).max())
    top2 = np.sort(flash, axis=-1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    differ = ring.argmax(-1) != flash.argmax(-1)
    near = margin <= 2 * noise
    tol = TOL_RING_OP["bfloat16"][0]
    say(f"ring test: bf16 logits of {len(images)} rows, ring_flash on 2 "
        f"ranks vs flash: max abs diff {noise:.3g} ({noise / scale:.3g} of "
        f"the largest logit, tol {tol:g}); labels differ on "
        f"{int(differ.sum())} rows, {int(near.sum())} rows have a flash "
        f"top-two margin within twice that diff; K4 launches "
        f"{ranks[0]['launches']['flash_fwd_pos']}")
    if not (noise <= tol * scale and (near | ~differ).all()
            and ranks[0]["launches"]["flash_fwd_pos"] > 0):
        fail(f"the ring's logits disagree with flash's beyond its rounding: "
             f"max diff {noise} of {scale}; rows whose labels differ "
             f"outside the noise: {np.flatnonzero(differ & ~near)[:10]}")
    return int(differ.sum())


# The ring's `test` against flash's, beyond the rows whose labels differ in
# ring_vs_flash_rows: the two CLI runs batch the rows otherwise (128 a step
# on the ring, 64 in flash), which may flip the argmax of a row whose two
# best logits are within a rounding of a tie.
RING_TEST_ROWS = 2


# -- phase 19: three f32 steps, 2-rank rings against 1-process flash ----------

RING_STEP_BATCH = 16
TOL_RING_STEP = 1e-5


def phase_ring_steps(f16_too: bool = False):
    """Phase 19; with ``f16_too`` phase 33's f16 worlds start at once
    beside its own (``f16_ring_worlds``), and their results are
    returned."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.data import augment

    rng = np.random.default_rng(SEED + 6)
    steps = []
    for i in range(3):
        gb = RING_STEP_BATCH
        valid = np.ones(gb, bool)
        if i == 0:
            valid[gb // 2:gb - 1] = False
        u = torch.from_numpy(rng.random((gb, 5), dtype=np.float32))
        steps.append((rng.integers(0, 256, (gb, 28, 28), dtype=np.uint8),
                      rng.integers(0, 10, gb), valid,
                      [t.numpy() for t in augment.affine_from_uniform(
                          u, 28, 28)]))
    kinds = (("flash", 1), ("ring_flash", 2), ("ring", 2))
    extra = f16_ring_worlds() if f16_too else []
    got = run_worlds([
        ring_world("vit", dict(arch={}, attention=attention, seed=SEED,
                               params=None, steps=steps), world,
                   f"ring_step_{attention}", "--model-parallel", str(world))
        for attention, world in kinds] + extra)
    worlds = dict(zip((a for a, _ in kinds), got))
    one = worlds["flash"][0]
    for attention in ("ring_flash", "ring"):
        ranks = worlds[attention]
        same = all(torch.equal(v, ranks[0]["state"][k])
                   for r in ranks for k, v in r["state"].items())
        w = worst(ranks[0]["state"], one["state"])
        loss_err = max(abs(a[0] - b[0]) for a, b in
                       zip(ranks[0]["metrics"], one["metrics"]))
        counts = [m[1:] for m in ranks[0]["metrics"]] == \
            [m[1:] for m in one["metrics"]]
        launches = ranks[0]["launches"]
        say(f"ring steps: {attention} on 2 ranks (gloo) vs flash on 1, 3 "
            f"f32 SGD steps of the full-width vit on a global batch of "
            f"{RING_STEP_BATCH}: worst tensor {w[0]} rel err {w[1]:.3g} "
            f"(tol {TOL_RING_STEP:g}) over {len(one['state'])} tensors; "
            f"loss err {loss_err:.3g}; correct/valid equal: {counts}; ranks "
            f"equal: {same}; rank 0 launches {launches}")
        want = (DEPTH * MODEL_PARALLEL * 3 if attention == "ring_flash"
                else 0)
        if not (same and counts and math.isfinite(w[1])
                and w[1] <= TOL_RING_STEP and loss_err <= TOL_RING_STEP) \
                or launches["flash_fwd_pos"] != want \
                or launches["flash_dq_pos"] != want:
            fail(f"the 2-rank {attention} steps disagree with 1-process "
                 f"flash")
    return got[len(kinds):] if f16_too else None


# -- phase 20: where the time goes in a ring train step -----------------------

RING_PROFILE_STEPS = 5         # cut from 10 for the run's time limit


def phase_ring_profile() -> None:
    """One ring_flash train step of the full-width vit on two ranks sharing
    the card, bf16, 64 rows a replica (the data shard's 128 rows on each
    rank), as in phase 18 but SGD: wall ms per step (host clock,
    synchronized), then from RING_PROFILE_STEPS steps under torch.profiler
    the device time, kernels per step, the idle share, K4/K2p/K3p and the
    host copies of the gloo transport.  Both ranks run it; each reports."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.data import augment

    gb = TRAIN_BATCH * 2
    rng = np.random.default_rng(SEED + 7)
    u = torch.from_numpy(rng.random((gb, 5), dtype=np.float32))
    step = (rng.integers(0, 256, (gb, 28, 28), dtype=np.uint8),
            rng.integers(0, 10, gb), np.ones(gb, bool),
            [t.numpy() for t in augment.affine_from_uniform(u, 28, 28)])
    spec = dict(arch={}, attention="ring_flash", seed=SEED, params=None,
                steps=[step], precision="bf16", profile=RING_PROFILE_STEPS)
    ranks, = run_worlds([ring_world("vit", spec, 2, "ring_profile",
                                    "--model-parallel", "2")])
    for r in ranks:
        p = r["profile"]
        dev = p["device_ms"]
        if dev <= 0:
            say(f"profile: ring_flash train step, rank {r['rank']}: wall "
                f"{p['wall_ms']:.3f} ms/step; device time not measured (no "
                f"device events)")
            continue
        parts = "; ".join(
            f"{n} {p[k]:.2f} us/step ({100 * p[k] / 1e3 / dev:.1f}%)"
            for n, k in (("K4", "k4_us"), ("K2p", "k2p_us"),
                         ("K3p", "k3p_us"), ("host copies", "memcpy_us")))
        parts += "; " + ", ".join(
            f"{n} {p[k + '_launches']:.0f} launches a step "
            f"({p[k + '_mma_launches']:.0f} tensor-core), "
            f"{p[k + '_us'] / max(p[k + '_launches'], 1):.2f} us a launch"
            for n, k in (("K4", "k4"), ("K2p", "k2p"), ("K3p", "k3p")))
        say(f"profile: ring_flash train step, rank {r['rank']} of 2 (gloo, "
            f"M = 2), {gb} rows a rank, bf16: wall {p['wall_ms']:.3f} "
            f"ms/step, device {dev:.3f} ms in {p['kernels']:.0f} kernels "
            f"(idle {100 * (1 - dev / p['wall_ms']):.1f}%); {parts}")
        say("profile:   top: " + "; ".join(
            f"{k} {us:.1f}us x{c}" for k, us, c in p["top"]))


# Phases that use another phase's output pull it in: 7 and 8 (one
# function) test phase 6's model.
# -- phases 21-23: the rest of the torchvision zoo -------------------------

ZOO = ("alexnet", "vgg", "squeezenet", "densenet", "inception")
ZOO_PARITY_BATCH = 4
# Phase 21, the card against the CPU on the same weights, batch, affine
# draws and dropout masks, TF32 off, each tensor relative to its largest
# value.  f32 train-mode logits (and aux logits): TOL_ZOO_LOGITS.  The
# gradients of sum(logits * w) (+ sum(aux * w'), w a fixed ramp, so that
# both devices back-propagate the same exact cotangent): in f64 compute
# (f32 parameters, whose gradients round to f32) TOL_ZOO_GRAD_F64 for all
# five; in f32 TOL_ZOO_GRAD_F32 for alexnet and squeezenet, which have no
# BatchNorm (a ReLU or max-pool decision within rounding of a tie can
# flip between the devices, as in phase 11: 6.6e-3 seen on alexnet).
# The f32 backward of the three BatchNorm models at this batch amplifies
# the devices' last-bit differences of the forward (on the CPU alone
# densenet's and inception's f32 gradients lie 2-3% from their f64 ones
# at the median and up to 37% at the worst parameter; vgg's card vs CPU
# 4.8e-2; ROADMAP queue 3 entry 8), so their f32 gradients are held by
# the conditioned rule of tests/_torch_zoo_jax.py: against the card's own
# f64 step, the card's f32 step may be no further than
# ZOO_CONDITIONED_FACTOR times the CPU's f32 step, at the median and at
# the largest of the per-tensor errors.  inception's f32 convolutions run
# on a contiguous NCHW input on the card: on the channels_last view that
# the other models convolve, cuDNN's f32 kernels put its gradients 5x
# further from the f64 step than the CPU's (median 0.37 against 0.066
# per tensor on an H100, TF32 off; ROADMAP queue 3 entry 10).  The phase
# prints that distance and the two layouts' f32 step times beside the
# held one.  vgg's conv biases feed a train-mode BatchNorm,
# which cancels them: their gradient is zero up to rounding and is held
# at the scale of its conv's weight gradient.
TOL_ZOO_LOGITS = 1e-4
TOL_ZOO_GRAD_F64 = 1e-6
TOL_ZOO_GRAD_F32 = 1e-2
ZOO_F32_GRADS_HELD = ("alexnet", "squeezenet")
ZOO_CONDITIONED_FACTOR = 2.0
INCEPTION_TIMED_BATCH = 64
TOL_ZOO_STATS = 1e-4


def zoo_rel(name: str, got: dict, want: dict) -> dict:
    """{key: error relative to the largest wanted value}; vgg's conv
    biases relative to their conv weight's."""
    out = {}
    for key, w in want.items():
        scale = w
        if name == "vgg" and re.fullmatch(r"Conv_\d+\.bias", key):
            scale = want[key.replace(".bias", ".weight")]
        out[key] = ((got[key].double() - w.double()).abs().max()
                    / max(scale.double().abs().max().item(), 1e-30)).item()
    return out


def zoo_step(name: str, device: str, policy, x, masks) -> dict:
    """The registry's ``name`` from SEED's weights (drawn on the CPU): one
    train-mode forward of the augmented batch ``x`` with the keep
    ``masks``, and the backward of sum(logits * w) (+ sum(aux * w')).
    Returns the logits, aux logits, gradients and BatchNorm statistics,
    on the CPU."""
    import torch

    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.models.layers import set_dropout_masks

    model = get_model(name, 10, policy, device=device)
    model.init_weights(torch.Generator().manual_seed(SEED))
    model.train()
    set_dropout_masks(model, [m.to(device) for m in masks] or None)
    out = model(x.to(device))
    logits, aux = out if isinstance(out, tuple) else (out, None)
    w = torch.linspace(-1.0, 1.0, logits.shape[1], device=device)
    loss = (logits * w).sum()
    if aux is not None:
        loss = loss + (aux * w.flip(0)).sum()
    loss.backward()
    if device == "cuda":
        torch.cuda.synchronize()
    got = {"logits": logits.detach().cpu()}
    if aux is not None:
        got["aux"] = aux.detach().cpu()
    return {"out": got,
            "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
            "stats": {n: b.cpu() for n, b in model.named_buffers()}}


def inception_forward_channels_last(model, x):
    """inception's train-mode forward with its convolutions on the
    channels_last view of the NHWC input, as before the f32 input was
    made contiguous on the card (``InceptionV3.forward`` otherwise)."""
    import torch.nn.functional as F

    from distributedpytorch_tpu_torch.models.common import global_mean
    from distributedpytorch_tpu_torch.models.layers import dense

    x = x.permute(0, 3, 1, 2)
    x = model.c(2, model.c(1, model.c(0, x)))
    x = F.max_pool2d(x, 3, 2)
    x = F.max_pool2d(model.c(4, model.c(3, x)), 3, 2)
    aux = None
    for name in model.block_names:
        x = getattr(model, name)(x)
        if name == "InceptionC_3":
            aux = model.AuxHead_0(x)
    x = model.Dropout_0(global_mean(x))
    return dense(model.head, x).float(), aux.float()


def inception_layouts(x, masks, truth: dict, images, ds, u) -> str:
    """The f32 step of inception on the channels_last view: its distance
    from the card's f64 step (median and worst per tensor), and the f32
    train step's wall time at batch INCEPTION_TIMED_BATCH both ways
    (forward and backward of sum(logits * w), synchronized, 3 steps after
    one)."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.data import augment
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.models.layers import set_dropout_masks
    from distributedpytorch_tpu_torch.precision import PRESETS

    model = get_model("inception", 10, PRESETS["f32"], device="cuda")
    model.init_weights(torch.Generator().manual_seed(SEED))
    model.train()

    def step(fn, xb, mb):
        model.zero_grad(set_to_none=True)
        set_dropout_masks(model, mb)
        logits, aux = fn(xb)
        w = torch.linspace(-1.0, 1.0, logits.shape[1], device="cuda")
        ((logits * w).sum() + (aux * w.flip(0)).sum()).backward()

    xc = x.cuda()
    step(lambda t: inception_forward_channels_last(model, t), xc,
         [m.cuda() for m in masks])
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    err = np.array(list(zoo_rel("inception", grads, truth).values()))
    b = INCEPTION_TIMED_BATCH
    big = augment.train_transform(
        torch.from_numpy(np.tile(images.numpy(), (b // len(images), 1, 1))),
        ds.mean, ds.std, 299,
        augment.affine_from_uniform(u.repeat(b // len(u), 1), 28, 28)).cuda()
    big_masks = [torch.ones((b,) + m.shape[1:], dtype=torch.bool,
                            device="cuda") for m in masks]
    times = {}
    for label, fn in (("contiguous NCHW (held)", model),
                      ("channels_last", lambda t:
                       inception_forward_channels_last(model, t))):
        step(fn, big, big_masks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step(fn, big, big_masks)
        torch.cuda.synchronize()
        times[label] = (time.perf_counter() - t0) * 1e3 / 3
    return (f"on the channels_last view median {np.median(err):.3g} and "
            f"worst {err.max():.3g}; f32 step at batch {b}: " + ", ".join(
                f"{k} {v:.1f} ms" for k, v in times.items()))


def phase_zoo_parity() -> None:
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.data import augment
    from distributedpytorch_tpu_torch.models import (get_model,
                                                     get_model_input_size)
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine

    b = ZOO_PARITY_BATCH
    ds = work_dataset()
    images = torch.from_numpy(ds.splits["train"].images[:b])
    u = torch.from_numpy(np.random.default_rng(SEED).random(
        (b, 5), dtype=np.float32))
    for name in ZOO:
        size = get_model_input_size(name)
        # the masks of Engine.train_step, drawn once on the CPU
        engine = Engine(get_model(name, 10, PRESETS["f32"], device="cpu"),
                        cross_entropy, ds.mean, ds.std, size,
                        PRESETS["f32"], "cpu")
        masks = engine.draw_dropout_masks(
            torch.Generator().manual_seed(SEED), b)
        worst, steps, xs = {}, {}, {}
        for label, policy in (("f32", PRESETS["f32"]), ("f64", f64_policy())):
            x = xs[label] = augment.train_transform(
                images, ds.mean, ds.std, size,
                augment.affine_from_uniform(u, 28, 28),
                out_dtype=policy.compute_dtype)
            card = zoo_step(name, "cuda", policy, x, masks)
            cpu = zoo_step(name, "cpu", policy, x, masks)
            steps[label] = (card, cpu)
            errs = {k: zoo_rel(name, card[k], cpu[k])
                    for k in ("out", "grads", "stats")}
            worst[label] = {k: max(e.items(), key=lambda t: t[1],
                                   default=("none", 0.0))
                            for k, e in errs.items()}
            worst[label]["finite"] = all(
                bool(torch.isfinite(t).all()) for k in ("out", "grads")
                for t in card[k].values())
        f32, f64 = worst["f32"], worst["f64"]
        held = name in ZOO_F32_GRADS_HELD
        # the conditioned rule: each device's f32 gradients against the
        # card's f64 step, per tensor
        truth = steps["f64"][0]["grads"]
        card_f32, cpu_f32 = (np.array(list(zoo_rel(
            name, step["grads"], truth).values()))
            for step in steps["f32"])
        cudnn_note = ""
        if name == "inception":
            cudnn_note = "; " + inception_layouts(xs["f32"], masks, truth,
                                                  images, ds, u)
        conditioned = (
            float(np.median(card_f32)) <= ZOO_CONDITIONED_FACTOR
            * float(np.median(cpu_f32))
            and card_f32.max() <= ZOO_CONDITIONED_FACTOR * cpu_f32.max())
        rule = (f"(tol {TOL_ZOO_GRAD_F32:g})" if held else
                f"(against the card's f64 step: median "
                f"{np.median(card_f32):.3g} and worst {card_f32.max():.3g}, "
                f"the CPU f32 step's "
                f"{np.median(cpu_f32):.3g} and {cpu_f32.max():.3g}, factor "
                f"{ZOO_CONDITIONED_FACTOR:g}{cudnn_note})")
        say(f"zoo: {name} at {size} px, batch {b}, card vs CPU: f32 "
            f"logits worst {f32['out'][0]} {f32['out'][1]:.3g} (tol "
            f"{TOL_ZOO_LOGITS:g}); f32 gradient worst {f32['grads'][0]} "
            f"{f32['grads'][1]:.3g} " + rule
            + f"; f64 gradient worst {f64['grads'][0]} "
            f"{f64['grads'][1]:.3g} (tol {TOL_ZOO_GRAD_F64:g}); BatchNorm "
            f"statistic worst {f32['stats'][0]} {f32['stats'][1]:.3g} (tol "
            f"{TOL_ZOO_STATS:g}); {len(masks)} dropout masks")
        if not (f32["finite"] and f64["finite"]
                and f32["out"][1] <= TOL_ZOO_LOGITS
                and f64["grads"][1] <= TOL_ZOO_GRAD_F64
                and f32["stats"][1] <= TOL_ZOO_STATS
                and f64["stats"][1] <= TOL_ZOO_STATS
                and (f32["grads"][1] <= TOL_ZOO_GRAD_F32 if held
                     else conditioned)):
            fail(f"{name}'s step on the card disagrees with the CPU's: "
                 f"{worst}")
        if ("aux" in card["out"]) != (name == "inception"):
            fail(f"{name}'s train-mode forward returned aux logits "
                 f"{'aux' in card['out']}")


ZOO_SERVED = ("inception", "vgg")   # the 299 path, and dropout in eval
ZOO_WAVE = 16                       # concurrent requests a served model


def zoo_log_losses(log: str) -> list:
    return [float(x) for x in re.findall(
        r"(?:mean train loss:|Loss: )(\S+)", log)]


def moved_params(ckpt_path: str, name: str) -> tuple:
    """(parameters that moved from SEED's init, parameters, all finite)
    of a checkpoint of ``name``."""
    import torch

    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.precision import PRESETS

    got = ckpt.read_checkpoint(ckpt_path)["state"]["params"]
    init = get_model(name, 10, PRESETS["bf16"], device="cpu")
    init.init_weights(torch.Generator().manual_seed(SEED))
    params = dict(init.named_parameters())
    moved = sum(not torch.equal(got[n], p.detach())
                for n, p in params.items())
    finite = all(bool(torch.isfinite(t).all()) for t in got.values())
    return moved, len(params), finite


def serve_zoo(ckpt_path: str, name: str, server, images,
              precision: str = "bf16") -> int:
    """One wave of ZOO_WAVE concurrent requests to ``server``; every
    answer held against the in-process predict step (in the
    ``precision`` preset) at its bucket, as phase 3 holds the vit's; a
    zoo model's server launches no K1, the vit's 4 x (batches + warm-up
    buckets), all on the tensor cores.  Returns the batches served."""
    import numpy as np

    answers, secs = serve_burst(server, images, 1, ZOO_WAVE)
    labels = np.array([a[2]["label"] for a in answers])
    confs = np.array([a[2]["confidence"] for a in answers])
    served_bucket = np.array([a[2]["bucket"] for a in answers])
    want, want_conf, probs = reference_predictions(
        ckpt_path, images, served_bucket, "cuda", name, precision)
    top2 = np.sort(probs, axis=-1)[:, -2:]
    tie = (top2[:, 1] - top2[:, 0]) <= TOL_CONF
    conf_err = float(np.abs(confs - want_conf).max())
    launches = batches = None
    for line in server[2]:
        m = re.search(r"flash_fwd launches (\d+) \(", line)
        if m:
            launches = int(m.group(1))
        m = re.search(r"answering \d+ requests in (\d+) batches", line)
        if m:
            batches = int(m.group(1))
    say(f"zoo: serve {name}: {len(answers)} answers in {secs:.3f}s, "
        f"buckets {sorted(set(served_bucket.tolist()))}, {batches} batches; "
        f"vs in-process predict step at the served bucket: "
        f"{int((labels == want).sum())}/{len(answers)} labels equal "
        f"({int(tie.sum())} within {TOL_CONF:g} of a tie), max conf err "
        f"{conf_err:.3g} (tol {TOL_CONF:g}); K1 launches {launches}")
    if name == "vit":
        check_server_launches(server[2], len(answers))
    elif launches != 0:
        fail(f"the {name} server launched K1 ({launches})")
    if ((labels != want) & ~tie).any() or conf_err > TOL_CONF:
        fail(f"served {name} answers disagree with the in-process predict "
             f"step")
    return batches


def phase_zoo_main_path() -> None:
    """The five zoo models trained one epoch each by ``train`` (and resnet
    fine-tuned from a torchvision-layout file with ``--use-pretrained
    --feature-extract``), all six processes at once; then ``test -f`` on
    each best file beside ``serve`` of inception's and vgg's."""
    import torch

    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.models import get_model, pretrained
    from distributedpytorch_tpu_torch.precision import PRESETS

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_zoo import TorchResNet18

    write_zoo_data()
    weights = os.path.join(WORK, "resnet18-torchvision-layout.pth")
    torch.manual_seed(SEED)
    torch.save(TorchResNet18(num_classes=10).state_dict(), weights)
    rsl = {name: os.path.join(WORK, f"zoo_{name}") for name in ZOO}
    rsl["pretrained"] = os.path.join(WORK, "zoo_pretrained")
    runs = [start_cli(["train", "--model", name, "-e", "1"], rsl[name],
                      data=ZOO_DATA) for name in ZOO]
    runs.append(start_cli(
        ["train", "--model", "resnet", "-e", "1", "--use-pretrained",
         "--pretrained-path", weights, "--feature-extract"],
        rsl["pretrained"], data=ZOO_DATA))
    results = dict(zip(ZOO + ("pretrained",), finish_all(runs)))
    want_steps = math.ceil(int(ZOO_TRAIN_ROWS * 0.9) / TRAIN_BATCH)
    best = {}
    for name in ZOO:
        wall, log = results[name]
        launches, steps, evals = parse_launches(log, "train")
        losses = zoo_log_losses(log)
        best[name] = os.path.join(rsl[name], f"bestmodel-mnist-{name}.ckpt")
        moved, n_params, finite = moved_params(best[name], name)
        say(f"zoo: `train --model {name}` ({wall:.1f}s of process wall, "
            f"six trainings at once): {steps} steps, {evals} eval batches, "
            f"{len(losses)} logged losses, last train loss "
            f"{losses[-2] if len(losses) > 1 else None}, validation loss "
            f"{losses[-1] if losses else None}; {moved}/{n_params} "
            f"parameters moved; launches {launches}")
        if steps != want_steps or not losses or not all(
                map(math.isfinite, losses)) or not finite or moved == 0 \
                or any(launches.values()):
            fail(f"{name}'s train run: {steps} steps, losses {losses}, "
                 f"{moved} parameters moved, finite {finite}, launches "
                 f"{launches}")

    # --use-pretrained --feature-extract: the backbone as loaded, the head
    # moved
    _, log = results["pretrained"]
    if f"pretrained backbone loaded from {weights}" not in log:
        fail("train --use-pretrained did not log its backbone")
    loaded = get_model("resnet", 10, PRESETS["bf16"], device="cpu")
    loaded.init_weights(torch.Generator().manual_seed(SEED))
    pretrained.load_pretrained("resnet", weights, loaded)
    tuned = ckpt.read_checkpoint(os.path.join(
        rsl["pretrained"], "bestmodel-mnist-resnet.ckpt"))["state"]["params"]
    same = [n for n, p in loaded.named_parameters()
            if torch.equal(tuned[n], p.detach())]
    backbone = [n for n, _ in loaded.named_parameters()
                if not n.startswith("head.")]
    say(f"zoo: `train --model resnet --use-pretrained --feature-extract`: "
        f"{len(set(backbone) & set(same))}/{len(backbone)} backbone "
        f"parameters bit-identical to the loaded file, head moved: "
        f"{'head.weight' not in same}")
    if set(backbone) - set(same) or "head.weight" in same:
        fail("feature extraction changed the pretrained backbone or left "
             "the head")

    # test -f on every best file, beside the two servers
    ds = work_dataset()
    images = ds.splits["test"].images[:ZOO_WAVE]
    servers = {name: start_server(best[name], ZOO_WAVE, FLUSH_MS, "cuda",
                                  attention="full") for name in ZOO_SERVED}
    tests = [start_cli(["test", "-f", best[name]],
                       os.path.join(WORK, f"zoo_test_{name}"),
                       data=ZOO_DATA) for name in ZOO]
    try:
        for name in ZOO_SERVED:
            serve_zoo(best[name], name, servers[name], images)
    finally:
        for _, proc, _, _ in servers.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, (_, tlog) in zip(ZOO, finish_all(tests)):
        acc_cli = re.search(r"Time: \d+m \d+s, Acc: ([\d.]+)%",
                            tlog).group(1)
        acc_here, correct, n = eval_accuracy(best[name], name, ZOO_DATA)
        say(f"zoo: `test -f` {name}: {acc_cli}%; in-process eval "
            f"{acc_here}% ({correct}/{n})")
        if acc_cli != acc_here:
            fail(f"{name} test's accuracy disagrees with the in-process "
                 f"eval")


# Steps timed on the host clock and then under the profiler, after two
# of warm-up.  The profiler records the device only: the host-side events
# of densenet's and inception's 9-11 thousand kernels a step made their
# traces' processing the phase's largest cost; so does the device side of
# a trace, whence two steps.
ZOO_PROFILE_STEPS = 2


def phase_zoo_profile() -> None:
    """The five train steps at batch 64, bf16, cuDNN deterministic as in
    ``train``: wall ms per step (host clock, synchronized, profiler off),
    then from ZOO_PROFILE_STEPS steps under torch.profiler (device
    activity only) the device time per step, kernels per step, the idle
    share, and the top device operations."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributedpytorch_tpu_torch import utils
    from distributedpytorch_tpu_torch.data.datasets import load_dataset
    from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader
    from distributedpytorch_tpu_torch.models import (get_model,
                                                     get_model_input_size)
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine

    write_zoo_data()
    ds = load_dataset("mnist", ZOO_DATA, SEED)
    loader = ResidentLoader(ds.splits["train"], TRAIN_BATCH, True, SEED,
                            "cuda")
    reps = ZOO_PROFILE_STEPS
    batches = list(loader.epoch(0))     # 10, taken in turn
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # densenet121's step: phase 35 profiles it, eager and graphed
        for name in (n for n in ZOO if n != "densenet"):
            policy = PRESETS["bf16"]
            model = get_model(name, ds.nb_classes, policy, device="cuda")
            engine = Engine(model, cross_entropy, ds.mean, ds.std,
                            get_model_input_size(name), policy, "cuda")
            state = engine.init_state(torch.Generator().manual_seed(SEED))

            def step(i):
                gen = utils.step_generator(SEED, 0, i, "cuda")
                engine.train_step(state, *batches[i % len(batches)], gen)

            for i in range(2):
                step(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(reps):
                step(2 + i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(reps):
                    step(2 + reps + i)
                torch.cuda.synchronize()
            kernels = device_kernels(prof)
            dev_ms = sum(e.self_device_time_total for e in kernels) \
                / 1e3 / reps
            n_kern = sum(e.count for e in kernels) / reps
            if dev_ms <= 0:
                say(f"profile: {name} train step: wall {wall_ms:.3f} "
                    f"ms/step; device time not measured (no device events)")
                continue
            say(f"profile: {name} train step, batch {TRAIN_BATCH} bf16 at "
                f"{get_model_input_size(name)} px: wall {wall_ms:.3f} "
                f"ms/step, device {dev_ms:.3f} ms in {n_kern:.0f} kernels "
                f"(idle {100 * (1 - dev_ms / wall_ms):.1f}%)")
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)
            say("profile:   top: " + "; ".join(
                f"{e.key[:48]} {e.self_device_time_total / reps:.1f}us"
                f"x{e.count // reps}" for e in top[:5]))
            del model, engine, state
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic


# -- phase 24: K1, K2, K3 and K5 in float16 ----------------------------------

# float16 against the plain version, relative to the plain version's
# largest value: one float16 rounding of the output (2^-11 relative) and,
# on the tensor-core route, p and dS rounded to float16 before the second
# products, as bf16 is held to TOL_GRAD for its 2^-8.
TOL_F16 = 5e-3
F16_ATTN = (64, 49, 4, 32)          # the vit's attention call under f16
# The overflow case: dO near float16's range (the loss scale of
# --precision f16 is 2^15), scores that concentrate p on a few keys, so
# some dS reach 2^15 and past 65504 (kept in range by the tensor-core
# route's power-of-two shift) and some dq, dk, dv pass 65504 (inf in the
# plain version's float16 cast).  An element whose plain f32 value lies
# within TOL_F16 x the largest value of 65520 (where float16 rounding
# turns to inf) may round either way and is not held; every other
# element's finiteness must equal the plain version's.
F16_OVERFLOW = dict(qk_std=2.0, do_std=2.0 ** 14, do_clip=60000.0)
F16_INF_AT = 65520.0


def overflow_mismatch(got, ref32, band: float) -> tuple:
    """(elements whose finiteness differs from the plain version's f32
    value cast to float16, elements within ``band`` of F16_INF_AT that are
    not held, elements the plain version overflows)."""
    import torch

    a = ref32.abs()
    sure_inf = a >= F16_INF_AT + band
    sure_fin = a < F16_INF_AT - band
    got_inf = ~torch.isfinite(got)
    bad = (got_inf & sure_fin) | (~got_inf & sure_inf)
    return (int(bad.sum()), int((~sure_inf & ~sure_fin).sum()),
            int((~torch.isfinite(ref32.half())).sum()))


def phase_f16_kernels() -> dict:
    """K1, K2 and K3 at the vit's (64, 49, 4, 32) and K5 at the cnn's three
    conv shapes (batch 64), float16, on the route the rule picks (the
    tensor cores) and on the scalar route (forced): each against its plain
    version within TOL_F16 of the largest value, two calls bit-identical;
    the overflow case's non-finite pattern against the plain version's;
    device / call times beside the plain version's and the library's
    float16 call (SDPA, SDPA's backward, cuDNN's wgrad; yardsticks only)
    and the bound."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_weight

    from distributedpytorch_tpu_torch.ops import conv
    from distributedpytorch_tpu_torch.ops import flash_attention as tfa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    dt, dtype = "float16", torch.float16
    b, s, h, d = F16_ATTN
    rows = {}

    def qkv_views(std: float):
        qkv = (torch.randn((b, s, 3 * h * d), generator=gen, device="cuda")
               * std).to(dtype)
        return [t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1)]

    def routes(fn_tc, fn_scalar, what: str):
        """Both routes' outputs, each called twice and held
        bit-identical."""
        out = {}
        for route, fn in (("tensor_core", fn_tc), ("scalar", fn_scalar)):
            first, second = fn(), fn()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(first, second)):
                fail(f"{what}'s {route} route is not deterministic in "
                     f"float16")
            out[route] = first
        return out

    # K1
    q, k, v = qkv_views(1.0)
    if not tfa._pick_route(None, (q, k, v), kernel="K1"):
        fail("the vit's float16 q, k, v do not take K1's tensor cores")
    before = flash_attention_counts()
    fwd = routes(lambda: tfa.flash_attention_fwd(q, k, v),
                 lambda: tfa._launch(q, k, v, False, tensor_core=False), "K1")
    if flash_attention_counts()["flash_fwd"] != (
            before["flash_fwd"][0] + 4, before["flash_fwd"][1] + 2):
        fail("K1's wrapper did not count its float16 launches")
    po, plse = tfa.flash_attention_plain(q, k, v)
    errs = {}
    for route, (o, lse) in fwd.items():
        errs[route] = (rel_err(o, po), (lse - plse).abs().max().item())
        if not (o.dtype == dtype and errs[route][0][1] <= TOL_F16
                and errs[route][1] <= TOL_LSE):
            fail(f"K1's float16 {route} route disagrees with its plain "
                 f"version: O rel err {errs[route][0][1]} (tol {TOL_F16}), "
                 f"lse {errs[route][1]} (tol {TOL_LSE}), O {o.dtype}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fns = {"kernel": lambda: tfa.flash_attention_fwd(q, k, v),
           "scalar": lambda: tfa._launch(q, k, v, False, tensor_core=False),
           "plain": lambda: tfa.flash_attention_plain(q, k, v),
           "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt)}
    call = {n: time_ms(f) for n, f in fns.items()}
    dev = {n: spread(t)[0] for n, t in device_ms_tries(fns).items()}
    b_ms, b_by = bound_ms(b, s, h, d, dt, False)
    say(f"f16 K1 {F16_ATTN}: rel err O " + "; ".join(
        f"{r} {e[0][1]:.3g} (lse {e[1]:.3g})" for r, e in errs.items())
        + f" (tol {TOL_F16:g}, {TOL_LSE:g}), bit-identical; "
        + times_text(dev, call) + f"; bound_us={b_ms * 1e3:.3f} ({b_by})")
    rows["flash_fwd_f16"] = dict(
        max_abs_err=errs["tensor_core"][0][0],
        rel_err=errs["tensor_core"][0][1], ms=dev["kernel"],
        plain_ms=dev["plain"], library_ms=dev["sdpa"], bound_ms=b_ms,
        bound_by=b_by, call_ms=call["kernel"], plain_call_ms=call["plain"],
        library_call_ms=call["sdpa"], scalar_ms=dev["scalar"],
        scalar_rel_err=errs["scalar"][0][1])

    # K2 and K3, at unit inputs and in the overflow case
    for case in ("unit", "overflow"):
        if case == "unit":
            q, k, v = qkv_views(1.0)
            do = torch.randn((b, s, h, d), generator=gen,
                             device="cuda").to(dtype)
        else:
            q, k, v = qkv_views(F16_OVERFLOW["qk_std"])
            v = (v.float() / F16_OVERFLOW["qk_std"]).to(dtype)
            do = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                  * F16_OVERFLOW["do_std"]).clamp(
                      -F16_OVERFLOW["do_clip"],
                      F16_OVERFLOW["do_clip"]).to(dtype)
        o, lse = tfa.flash_attention_fwd(q, k, v)
        if not tfa._pick_route(None, (q, k, v, do, o)):
            fail("the vit's float16 backward does not take the tensor "
                 "cores")

        def tc_bwd():
            dq, delta = tfa.flash_attention_dq(q, k, v, o, do, lse)
            return (dq, delta) + tfa.flash_attention_dkv(q, k, v, do, lse,
                                                         delta)

        def scalar_bwd():
            dq, delta = tfa._dq_launch(q, k, v, o, do, lse,
                                       tensor_core=False)
            return (dq, delta) + tfa._dkv_launch(q, k, v, do, lse, delta,
                                                 tensor_core=False)

        before = flash_attention_counts()
        got = routes(tc_bwd, scalar_bwd, "K2/K3")
        now = flash_attention_counts()
        for name in ("flash_dq", "flash_dkv"):
            if now[name] != (before[name][0] + 4, before[name][1] + 2):
                fail(f"{name}'s wrapper did not count its float16 "
                     f"launches")
        want_delta = tfa.attention_delta(o, do)
        # the plain version's f32 values before its float16 cast
        ref32 = tfa._bwd_blocks(q.float(), k.float(), v.float(), do.float(),
                                lse, want_delta,
                                tfa._causal_mask(s, False, q.device))
        pdq, pdk, pdv = (x.to(dtype) for x in ref32)
        errs = {}
        for route, (dq, delta, dk, dv) in got.items():
            e = {"delta": rel_err(delta, want_delta)}
            for n, x, ref, r32 in (("dq", dq, pdq, ref32[0]),
                                   ("dk", dk, pdk, ref32[1]),
                                   ("dv", dv, pdv, ref32[2])):
                if x.dtype != dtype:
                    fail(f"K2/K3's {route} route returned {n} in {x.dtype}")
                fin = torch.isfinite(x) & torch.isfinite(ref)
                e[n] = rel_err(torch.where(fin, x, 0), torch.where(fin, ref,
                                                                   0))
                band = TOL_F16 * r32.abs().max().item()
                mism, border, n_inf = overflow_mismatch(x, r32, band)
                e[n + "_pattern"] = (mism, border, n_inf)
                if mism:
                    fail(f"float16 {case}: K2/K3's {route} route's "
                         f"non-finite pattern of {n} differs from the plain "
                         f"version's at {mism} elements ({border} within "
                         f"{band:.4g} of {F16_INF_AT:g} not held; plain "
                         f"overflows {n_inf})")
            bad = {n: v[1] for n, v in e.items() if not n.endswith("pattern")
                   and not v[1] <= (TOL_DELTA if n == "delta" else TOL_F16)}
            if bad:
                fail(f"float16 {case}: K2/K3's {route} route disagrees with "
                     f"the plain version: {bad} (tol {TOL_F16}, delta "
                     f"{TOL_DELTA})")
            errs[route] = e
        say(f"f16 K2/K3 {F16_ATTN} {case}: " + "; ".join(
            f"{r} rel err " + " ".join(
                f"{n}={v[1]:.3g}" for n, v in e.items()
                if not n.endswith("pattern"))
            + " non-finite (differing, not held, plain) " + " ".join(
                f"{n[:-8]}={v}" for n, v in e.items()
                if n.endswith("pattern"))
            for r, e in errs.items())
            + f" (tol {TOL_F16:g}, delta {TOL_DELTA:g}), bit-identical")
        if case == "overflow":
            continue
        qs_, ks_, vs_ = (t.detach().transpose(1, 2).contiguous()
                         .requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs_, ks_, vs_)
        dot = do.transpose(1, 2).contiguous()
        delta = got["tensor_core"][1]
        fns = {"K2": lambda: tfa.flash_attention_dq(q, k, v, o, do, lse),
               "K3": lambda: tfa.flash_attention_dkv(q, k, v, do, lse,
                                                     delta),
               "scalar K2": lambda: tfa._dq_launch(q, k, v, o, do, lse,
                                                   tensor_core=False),
               "scalar K3": lambda: tfa._dkv_launch(q, k, v, do, lse, delta,
                                                    tensor_core=False),
               "plain": lambda: tfa.flash_attention_bwd_plain(q, k, v, o,
                                                              lse, do),
               "sdpa bwd": lambda: torch.autograd.grad(
                   out, (qs_, ks_, vs_), dot, retain_graph=True)}
        call = {n: time_ms(f) for n, f in fns.items()}
        dev = {n: spread(t)[0] for n, t in device_ms_tries(fns).items()}
        bounds = {n: bwd_bound_ms(b, s, h, d, dt, False, n)
                  for n in ("dq", "dkv")}
        say(f"f16 K2/K3 {F16_ATTN}: " + times_text(dev, call)
            + "; bound_us " + " ".join(f"{n}={t * 1e3:.3f} ({by})"
                                       for n, (t, by) in bounds.items()))
        for name, key, parts in (("flash_dq", "K2", ("delta", "dq")),
                                 ("flash_dkv", "K3", ("dk", "dv"))):
            err = max((errs["tensor_core"][n] for n in parts),
                      key=lambda e: e[1])
            rows[name + "_f16"] = dict(
                max_abs_err=err[0], rel_err=err[1], ms=dev[key],
                plain_ms=dev["plain"], library_ms=dev["sdpa bwd"],
                bound_ms=bounds[name[6:]][0], bound_by=bounds[name[6:]][1],
                call_ms=call[key], plain_call_ms=call["plain"],
                library_call_ms=call["sdpa bwd"],
                scalar_ms=dev["scalar " + key],
                scalar_rel_err=max(errs["scalar"][n][1] for n in parts))

    # K5 at the cnn's three convs, batch 64
    parts = []
    for (hh, ww, ci, co) in CNN_CONVS:
        shape = (TRAIN_BATCH, hh, ww, ci, co)
        x = torch.randn((TRAIN_BATCH, ci, hh, ww), generator=gen,
                        device="cuda").to(dtype).contiguous(
                            memory_format=torch.channels_last)
        dy = torch.randn((TRAIN_BATCH, co, hh, ww), generator=gen,
                         device="cuda").to(dtype).contiguous(
                             memory_format=torch.channels_last)
        xn, dyn = x.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1)
        if not conv.tensor_core_route(dtype, ci, co, xn.stride(),
                                      dyn.stride(), xn.data_ptr(),
                                      dyn.data_ptr()):
            fail(f"K5's float16 call at {shape} does not take the tensor "
                 f"cores")
        ref = conv.conv3x3_dw_plain(xn, dyn)
        before = (conv.conv3x3_dw.launches,
                  conv.conv3x3_dw.tensor_core_launches)
        got = routes(lambda: (conv.conv3x3_dw(xn, dyn),),
                     lambda: (conv._launch(xn, dyn, tensor_core=False),),
                     "K5")
        if (conv.conv3x3_dw.launches,
                conv.conv3x3_dw.tensor_core_launches) != (
                before[0] + 4, before[1] + 2):
            fail(f"K5's wrapper did not count its float16 launches at "
                 f"{shape}")
        errs = {r: rel_err(g[0], ref) for r, g in got.items()}
        for r, e in errs.items():
            if not e[1] <= TOL_DW:
                fail(f"K5's float16 {r} route disagrees with its plain "
                     f"version at {shape}: rel err {e[1]} (tol {TOL_DW})")
        fns = {"kernel": lambda: conv.conv3x3_dw(xn, dyn),
               "scalar": lambda: conv._launch(xn, dyn, tensor_core=False),
               "plain": lambda: conv.conv3x3_dw_plain(xn, dyn),
               "cudnn": lambda: conv2d_weight(x, (co, ci, 3, 3), dy,
                                              padding=1)}
        call = {n: time_ms(f) for n, f in fns.items()}
        dev = {n: spread(t)[0] for n, t in device_ms_tries(fns).items()}
        b_ms, b_by = dw_bound_ms(*shape, dt)
        say(f"f16 K5 {shape}: rel err " + ", ".join(
            f"{r} {e[1]:.3g}" for r, e in errs.items())
            + f" (tol {TOL_DW:g}), deterministic; " + times_text(dev, call)
            + f"; bound_us={b_ms * 1e3:.3f} ({b_by})")
        parts.append(dict(max_abs_err=errs["tensor_core"][0],
                          rel_err=errs["tensor_core"][1], ms=dev["kernel"],
                          scalar_ms=dev["scalar"], plain_ms=dev["plain"],
                          library_ms=dev["cudnn"], bound_ms=b_ms,
                          call_ms=call["kernel"],
                          plain_call_ms=call["plain"],
                          library_call_ms=call["cudnn"]))
    row = {key: sum(p[key] for p in parts) for key in
           ("ms", "scalar_ms", "plain_ms", "library_ms", "bound_ms",
            "call_ms", "plain_call_ms", "library_call_ms")}
    row.update(max_abs_err=max(p["max_abs_err"] for p in parts),
               rel_err=max(p["rel_err"] for p in parts), bound_by="bytes",
               per_step_of=[list((TRAIN_BATCH,) + c) for c in CNN_CONVS],
               per_shape_ms=[p["ms"] for p in parts])
    rows["conv_dw_f16"] = row
    for name, r in rows.items():
        if any(r[key] is None for key in ("ms", "plain_ms", "library_ms")):
            fail(f"torch.profiler returned no device events for {name}")
    return rows


# -- phase 32: K4, K2p and K3p in float16 -------------------------------------

# The ring's shard of the vit under --precision f16 (RING_MAIN's case):
# rank 1's queries against rank 0's K/V, kv_valid 49.  The overflow case
# scales q and k by 3 and dO by 2^14 (clipped under 65504, as the loss
# scale puts the ring's cotangents near float16's range), where dS
# overflows float16 in some tiles.
F16_RING = RING_CASES[0]
F16_RING_OVERFLOW = dict(qk_std=3.0, do_std=2.0 ** 14, do_clip=60000.0)


def phase_f16_ring_kernels() -> dict:
    """K4, K2p and K3p in float16 at the ring's shard, on the route the
    rule picks (the tensor cores) and on the scalar route (forced): K4's
    f32 O within TOL_O_POS_TC (scalar: TOL_O_POS) and lse within TOL_LSE
    of the plain version, dq, dk, dv within TOL_F16 of its largest value
    where both are finite and K2p's delta within TOL_DELTA, two calls
    bit-identical; the overflow case's non-finite pattern against the
    plain version's; device / call times beside the plain version's and
    masked SDPA's in float16 (yardstick only) and the bounds."""
    import torch
    import torch.nn.functional as F

    from distributedpytorch_tpu_torch.ops import flash_attention as tfa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    dt, dtype = "float16", torch.float16
    label, b, s, h, d, causal, qb, kb, kv_valid, _ = F16_RING
    base = torch.arange(s, dtype=torch.int32, device="cuda")
    qp, kp = base + qb * s, base + kb * s
    keep = (kp < kv_valid)[None, :].expand(s, s)
    pairs = int(keep.sum().item())
    wrappers = {"flash_fwd_pos": tfa.flash_attention_partial_fwd,
                "flash_dq_pos": tfa.flash_attention_partial_dq,
                "flash_dkv_pos": tfa.flash_attention_partial_dkv}
    rows = {}
    for case in ("unit", "overflow"):
        std = F16_RING_OVERFLOW if case == "overflow" else dict(
            qk_std=1.0, do_std=1.0, do_clip=60000.0)
        qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda")
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
        q, k = ((t * std["qk_std"]).to(dtype) for t in (q, k))
        v = v.to(dtype)
        do = (torch.randn((b, s, h, d), generator=gen, device="cuda")
              * std["do_std"]).clamp(-std["do_clip"], std["do_clip"])
        dlse = torch.randn((b * h, s), generator=gen, device="cuda")
        if not tfa._pick_route(None, (q, k, v), kernel="K4"):
            fail("the ring's float16 q, k, v do not take K4's tensor cores")
        before = {n: (w.launches, w.tensor_core_launches)
                  for n, w in wrappers.items()}

        def tc():
            o, lse = tfa.flash_attention_partial_fwd(q, k, v, qp, kp,
                                                     causal, kv_valid)
            dq, delta, do_k3 = tfa.flash_attention_partial_dq(
                q, k, v, o, do, lse, dlse, qp, kp, causal, kv_valid)
            dk, dv = tfa.flash_attention_partial_dkv(
                q, k, v, do_k3, lse, delta, qp, kp, causal, kv_valid)
            return o, lse, delta, dq, dk, dv, do_k3

        def scalar():
            o, lse = tfa._launch(q, k, v, causal, (qp, kp, kv_valid),
                                 tfa.flash_attention_partial_fwd,
                                 tensor_core=False)
            dq, delta, do_k3 = tfa._dq_pos_launch(
                q, k, v, o, do, lse, dlse, qp, kp, causal, kv_valid,
                tensor_core=False)
            dk, dv = tfa.flash_attention_partial_dkv(
                q, k, v, do_k3, lse, delta, qp, kp, causal, kv_valid)
            return o, lse, delta, dq, dk, dv, do_k3

        got = {}
        for route, fn in (("tensor_core", tc), ("scalar", scalar)):
            first, second = fn(), fn()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(first, second)):
                fail(f"K4/K2p/K3p's float16 {route} route is not "
                     f"deterministic ({case})")
            got[route] = first
        now = {n: (w.launches, w.tensor_core_launches)
               for n, w in wrappers.items()}
        if any(now[n] != (before[n][0] + 4, before[n][1] + 2)
               for n in wrappers):
            fail(f"K4/K2p/K3p's wrappers did not count their float16 "
                 f"launches: {before} -> {now}")
        if got["tensor_core"][6].dtype != dtype:
            fail(f"K2p's tensor-core route wrote its dO copy in "
                 f"{got['tensor_core'][6].dtype}")
        po, plse = tfa.flash_attention_partial_plain(q, k, v, qp, kp,
                                                     causal, kv_valid)
        errs = {}
        for route, (o, lse, delta, dq, dk, dv, _) in got.items():
            tol_o = TOL_O_POS_TC if route == "tensor_core" else TOL_O_POS
            want_delta = tfa.partial_delta(o, do, dlse)
            # the plain version's f32 values, before its float16 cast
            ref32 = tfa._partial_bwd_blocks(
                q.float(), k.float(), v.float(), do, lse, want_delta, qp,
                kp, causal, kv_valid)
            e = {"o": ((o - po).abs().max().item(), tol_o),
                 "lse": ((lse - plse).abs().max().item(), TOL_LSE),
                 "delta": (rel_err(delta, want_delta)[1], TOL_DELTA)}
            absolute = {"o": e["o"][0],
                        "delta": rel_err(delta, want_delta)[0]}
            patterns = {}
            for n, x, r32 in (("dq", dq, ref32[0]), ("dk", dk, ref32[1]),
                              ("dv", dv, ref32[2])):
                if x.dtype != dtype:
                    fail(f"K2p/K3p's {route} route returned {n} in "
                         f"{x.dtype}")
                ref = r32.to(dtype)
                fin = torch.isfinite(x) & torch.isfinite(ref)
                absolute[n], rel = rel_err(torch.where(fin, x, 0),
                                           torch.where(fin, ref, 0))
                e[n] = (rel, TOL_F16)
                band = TOL_F16 * r32.abs().max().item()
                patterns[n] = overflow_mismatch(x, r32, band)
                if patterns[n][0]:
                    fail(f"float16 ring {case}: the {route} route's "
                         f"non-finite pattern of {n} differs from the "
                         f"plain version's at {patterns[n][0]} elements "
                         f"({patterns[n][1]} within {band:.4g} of "
                         f"{F16_INF_AT:g} not held; plain overflows "
                         f"{patterns[n][2]})")
            bad = {n: v for n, v in e.items() if not v[0] <= v[1]}
            if bad or not (torch.isfinite(o).all() and
                           torch.isfinite(lse).all()):
                fail(f"float16 ring {case}: K4/K2p/K3p's {route} route "
                     f"disagrees with the plain version: {bad}")
            errs[route] = (e, patterns, absolute)
        if case == "overflow" and not any(
                p[2] for p in errs["tensor_core"][1].values()):
            fail("the float16 ring's overflow case overflows nothing")
        say(f"f16 ring kernels {(b, s, h, d)} {case} (q block {qb}, k "
            f"block {kb}, kv_valid {kv_valid}): " + "; ".join(
                f"{r} " + " ".join(f"{n}={v[0]:.3g}" for n, v in e.items())
                + " non-finite (differing, not held, plain) " + " ".join(
                    f"{n}={p}" for n, p in pats.items())
                for r, (e, pats, _) in errs.items())
            + f" (tol o {TOL_O_POS_TC:g}/{TOL_O_POS:g}, lse {TOL_LSE:g}, "
            f"grads {TOL_F16:g}, delta {TOL_DELTA:g}), bit-identical")
        if case == "overflow":
            continue
        o, lse, delta, _, _, _, do_k3 = got["tensor_core"]
        qt, kt, vt = (t.detach().transpose(1, 2).contiguous()
                      .requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep)
        dot = do.to(dtype).transpose(1, 2).contiguous()
        fns = {"K4": lambda: tfa.flash_attention_partial_fwd(
                   q, k, v, qp, kp, causal, kv_valid),
               "K2p": lambda: tfa.flash_attention_partial_dq(
                   q, k, v, o, do, lse, dlse, qp, kp, causal, kv_valid),
               "K3p": lambda: tfa.flash_attention_partial_dkv(
                   q, k, v, do_k3, lse, delta, qp, kp, causal, kv_valid),
               "scalar K4": lambda: tfa._launch(
                   q, k, v, causal, (qp, kp, kv_valid),
                   tfa.flash_attention_partial_fwd, tensor_core=False),
               "K4 plain": lambda: tfa.flash_attention_partial_plain(
                   q, k, v, qp, kp, causal, kv_valid),
               "bwd plain": lambda: tfa.flash_attention_partial_bwd_plain(
                   q, k, v, o, lse, do, dlse, qp, kp, causal, kv_valid),
               "sdpa": lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=keep),
               "sdpa bwd": lambda: torch.autograd.grad(
                   out, (qt, kt, vt), dot, retain_graph=True)}
        call = {n: time_ms(f) for n, f in fns.items()}
        dev = {n: spread(t)[0] for n, t in device_ms_tries(fns).items()}
        bounds = ring_bounds(b, s, h, d, dt, pairs, True)
        say(f"f16 ring kernels {(b, s, h, d)}: " + times_text(dev, call)
            + "; bound_us " + " ".join(f"{n}={t * 1e3:.3f} ({by})"
                                       for n, (t, by) in bounds.items()))
        absolute = errs["tensor_core"][2]
        for name, key, plain, lib, parts in (
                ("flash_fwd_pos", "K4", "K4 plain", "sdpa", ("o",)),
                ("flash_dq_pos", "K2p", "bwd plain", "sdpa bwd",
                 ("delta", "dq")),
                ("flash_dkv_pos", "K3p", "bwd plain", "sdpa bwd",
                 ("dk", "dv"))):
            rows[name + "_f16"] = dict(
                max_abs_err=max(absolute[n] for n in parts),
                ms=dev[key], plain_ms=dev[plain], library_ms=dev[lib],
                bound_ms=bounds[name][0], bound_by=bounds[name][1],
                call_ms=call[key], plain_call_ms=call[plain],
                library_call_ms=call[lib],
                scalar_ms=dev["scalar K4"] if key == "K4" else None)
    for name, r in rows.items():
        if any(r[key] is None for key in ("ms", "plain_ms", "library_ms")):
            fail(f"torch.profiler returned no device events for {name}")
    return rows


# -- phase 33: f16 on the ring ------------------------------------------------

F16_RING_STEPS = 3
# Each tensor's update after 3 f16 SGD steps of the full-width vit, the
# 2-rank ring_flash world against 1-process flash, relative to its largest
# update: float16 rounds at the same points in both, but the ring splits
# the sums over the tokens (TOL_F16_STEP's bound, the f16 step on the card
# against the CPU).
TOL_F16_RING_UPDATE = 1e-2


def start_f16_ring_train() -> tuple:
    """``train --attention ring_flash --model-parallel 2 --precision f16
    -e 1`` on two ranks sharing the card, on phase 22's corpus (5 steps of
    the shard's 128 rows, 1 validation batch)."""
    write_zoo_data()
    return start_cli(["train", "--model", "vit", "--attention", "ring_flash",
                      "--model-parallel", str(MODEL_PARALLEL), "--precision",
                      "f16", "-e", "1"], os.path.join(WORK, "f16_ring_rsl"),
                     launcher=TORCHRUN2, data=ZOO_DATA)


def f16_ring_worlds() -> list:
    """Phase 33's three ``run_worlds`` entries: f16 ``flash`` in one
    process, ``ring_flash`` on two ranks, and the ring again with rank 1's
    second step overflowing, on the same initial parameters and steps."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.data import augment
    from distributedpytorch_tpu_torch.models.vit import ViT

    init = ViT(dtype=torch.float16, num_classes=10, device="cpu")
    init.init_weights(torch.Generator().manual_seed(SEED))
    params = {k: v.numpy() for k, v in init.state_dict().items()}
    rng = np.random.default_rng(SEED + 33)
    steps = []
    for i in range(F16_RING_STEPS):
        gb = RING_STEP_BATCH
        valid = np.ones(gb, bool)
        valid[-2:] = i == 0
        u = torch.from_numpy(rng.random((gb, 5), dtype=np.float32))
        steps.append((rng.integers(0, 256, (gb, 28, 28), dtype=np.uint8),
                      rng.integers(0, 10, gb), valid,
                      [t.numpy() for t in augment.affine_from_uniform(
                          u, 28, 28)]))
    base = dict(arch={}, seed=SEED, params=params, steps=steps,
                precision="f16")
    return [ring_world("vit", dict(base, attention="flash"), 1, "f16_flash"),
            ring_world("vit", dict(base, attention="ring_flash"), 2,
                       "f16_ring", "--model-parallel", "2"),
            ring_world("vit", dict(base, attention="ring_flash",
                                   overflow=(1, 1)), 2, "f16_ring_skip",
                       "--model-parallel", "2")]


def phase_f16_ring(train_run: tuple, worlds=None) -> tuple:
    """Three f16 SGD steps of the full-width vit at the loss scale 2^15
    (``worlds``: the results of ``f16_ring_worlds``, which phase 19 starts
    beside its own; run here when None): ``ring_flash`` on two ranks
    against ``flash`` in one process (every
    update within TOL_F16_RING_UPDATE of its largest, the loss, counts,
    scale and counters equal), and the ring again with rank 1's second
    step overflowing (both ranks skip it and halve the scale); then the
    f16 ring train's launches by phase 18's formula, every one on the
    tensor cores, and its loss-scale line.  Returns its ring launches and
    those on the tensor cores."""
    import torch

    from distributedpytorch_tpu_torch.models.vit import ViT

    flash, ring, skip = worlds or run_worlds(f16_ring_worlds())
    one = flash[0]
    init = ViT(dtype=torch.float16, num_classes=10, device="cpu")
    init.init_weights(torch.Generator().manual_seed(SEED))
    p0 = init.state_dict()
    worst_update = max(((k, rel_err(ring[0]["state"][k] - v,
                                    one["state"][k] - v)[1])
                        for k, v in p0.items()), key=lambda t: t[1])
    same = all(torch.equal(v, world[0]["state"][k])
               for world in (ring, skip) for r in world[1:]
               for k, v in r["state"].items())
    loss_err = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in
                   zip(ring[0]["metrics"], one["metrics"]))
    # the valid rows equal; a correct count within one row a step (a
    # logit pair within float16's rounding of a tie may flip)
    counts = all(a[2] == b[2] and abs(a[1] - b[1]) <= 1 for a, b in
                 zip(ring[0]["metrics"], one["metrics"]))
    want = (F16_RING_STEPS, F16_RING_STEPS)
    scales = {n: (w[0]["counters"], w[0]["loss_scale"]) for n, w in
              (("flash", flash), ("ring", ring), ("skip", skip))}
    say(f"f16 ring steps: ring_flash on 2 ranks vs flash on 1, "
        f"{F16_RING_STEPS} f16 SGD steps of the full-width vit on a global "
        f"batch of {RING_STEP_BATCH}: worst update {worst_update[0]} rel "
        f"err {worst_update[1]:.3g} (tol {TOL_F16_RING_UPDATE:g}); loss rel "
        f"err {loss_err:.3g}; (correct, valid) a step "
        f"{[m[1:] for m in ring[0]['metrics']]} vs "
        f"{[m[1:] for m in one['metrics']]} (held: valid equal, correct "
        f"within 1) {counts}; ranks equal {same}; (step, updates) and "
        f"scale {scales}; rank 0 launches {ring[0]['launches']}")
    if not (same and counts and worst_update[1] <= TOL_F16_RING_UPDATE
            and loss_err <= TOL_F16_RING_UPDATE
            and scales["flash"] == scales["ring"] == (
                want, {"scale": 2.0 ** 15, "good_steps": F16_RING_STEPS})
            and all(r["counters"] == (F16_RING_STEPS, F16_RING_STEPS - 1)
                    and r["loss_scale"] == {"scale": 2.0 ** 14,
                                            "good_steps": 1}
                    for r in skip)
            and ring[0]["launches"]["flash_fwd_pos"]
            == DEPTH * MODEL_PARALLEL * F16_RING_STEPS):
        fail("the 2-rank f16 ring disagrees with 1-process f16 flash, or an "
             "overflow on one model rank did not skip the step on both")
    wall, log = finish_all([train_run])[0]
    launches, steps_run, evals = parse_launches(log, "train")
    ring_launches = parse_ring_launches(log, "train")
    ring_tc = parse_ring_tensor_core_launches(log, "train")
    scale, scale_steps, skipped = parse_loss_scale(log)
    per = DEPTH * MODEL_PARALLEL
    n_train = int(ZOO_TRAIN_ROWS * 0.9)
    want_steps = math.ceil(n_train / MODEL_PARALLEL / TRAIN_BATCH)
    want_launches = {"flash_fwd_pos": per * (steps_run + evals),
                     "flash_dq_pos": per * steps_run,
                     "flash_dkv_pos": per * steps_run}
    losses = [float(x) for x in re.findall(r"Train       \| Loss: (\S+)",
                                           log)]
    say(f"f16 ring train: {steps_run} steps and {evals} eval batches in "
        f"{wall:.1f}s of process wall; train loss {losses}; ring launches "
        f"{ring_launches} (tensor-core {ring_tc}), K1-K3/K5 {launches}; "
        f"loss scale {scale:g} after {scale_steps} steps, {skipped} skipped")
    if steps_run != want_steps or ring_launches != want_launches \
            or ring_tc != want_launches or any(launches.values()) \
            or scale_steps != steps_run \
            or not all(math.isfinite(x) for x in losses):
        fail(f"the f16 ring train's launches {ring_launches} (tensor-core "
             f"{ring_tc}) over {steps_run} steps do not match "
             f"{want_launches} at {want_steps} steps, or its loss is not "
             f"finite")
    return ({k + "_f16": v for k, v in ring_launches.items()},
            {k + "_f16": v for k, v in ring_tc.items()})


# -- phase 34: train -f on a JAX-written file ---------------------------------

JAX_RESUME_PORT = os.path.join(WORK, "cnn_debug",
                               "checkpoint-mnist-cnn-000.ckpt")
JAX_RESUME_FILE = os.path.join(WORK, "jax_file",
                               "checkpoint-mnist-cnn-000.ckpt")
JAX_RESUME_ARGS = ("train", "--model", "cnn", "--debug")


def start_jax_resume() -> list:
    """Phase 13's ``train --model cnn --debug -e 1`` rolling file (trained
    here when phase 13 did not run), written again as the JAX package's
    msgpack file by ``tests/_torch_jax_ckpt.py`` (torch, numpy and msgpack
    only: the converter test's writer); then ``train -f`` to ``-e 2`` on
    the port's file and on the JAX one, at once."""
    import torch

    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import (TrainState,
                                                           make_optimizer)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_jax_ckpt import jax_state_tree, write_jax_checkpoint

    if not os.path.exists(JAX_RESUME_PORT):
        run_cli(list(JAX_RESUME_ARGS) + ["-e", "1"],
                os.path.dirname(JAX_RESUME_PORT))
    model = get_model("cnn", 10, PRESETS["bf16"], device="cpu")
    state = TrainState(model, make_optimizer("adam", model))
    epoch, best, step = ckpt.load_checkpoint(JAX_RESUME_PORT, model,
                                             state.optimizer,
                                             train_state=state)
    write_jax_checkpoint(JAX_RESUME_FILE, "cnn", jax_state_tree(
        model, state.optimizer, step, int(state.updates)), epoch - 1, best)
    return [start_cli(list(JAX_RESUME_ARGS) + ["-e", "2", "-f", f],
                      os.path.join(WORK, name))
            for name, f in (("resume_port", JAX_RESUME_PORT),
                            ("resume_jax", JAX_RESUME_FILE))]


def phase_jax_resume(runs: list) -> None:
    """The two resumes of ``start_jax_resume`` end bit-identical
    (parameters, statistics, Adam's state and the counters of their
    rolling files), the JAX-format file read as the JAX package's."""
    from distributedpytorch_tpu_torch import checkpoint as ckpt

    if ckpt._read(JAX_RESUME_FILE)[1] != "jax":
        fail("the JAX-format file is not read as the JAX package's")
    logs = finish_all(runs)
    step = ckpt.read_checkpoint(JAX_RESUME_PORT)["state"]["step"]
    files = [os.path.join(WORK, name, "checkpoint-mnist-cnn-001.ckpt")
             for name in ("resume_port", "resume_jax")]
    _, differ = state_tensors_differ(*files)
    a, b = (ckpt.read_checkpoint(f)["state"] for f in files)
    counters = [(s["step"], s["updates"]) for s in (a, b)]
    loaded = "model loaded from" in logs[1][1]
    say(f"jax resume: cnn trained {step} steps on the card, its state "
        f"written as a JAX msgpack file "
        f"({os.path.getsize(JAX_RESUME_FILE):,} bytes); train -f on it and "
        f"on the port's file to epoch 2: tensors differing {differ}, "
        f"(step, updates) {counters}, loaded {loaded}")
    if differ or counters[0] != counters[1] or not loaded \
            or counters[0][0] <= step:
        fail("train -f on the JAX-format file does not resume as on the "
             "port's own file")


# -- phase 35: --epochs-per-dispatch as CUDA Graph replay ---------------------

# (label, model, precision, attention, K5, train rows): the vit with flash
# attention in bf16 and f16 (K1, K2 and K3 inside the graph), the cnn with
# K5, resnet18 (the reference's job) and densenet121 (the most launches a
# step), at full width and batch 64, each on the first rows of the
# synthetic corpus and 64 validation rows: GRAPH_EPOCHS epochs one at a
# time (the eager path), and as GRAPH_EPOCHS / GRAPH_K chunks of GRAPH_K
# epochs (the train and eval steps captured after 3 eager ones, replayed
# for the rest).
GRAPH_RUNS = (("vit flash bf16", "vit", "bf16", "flash", False, 320),
              ("vit flash f16", "vit", "f16", "flash", False, 320),
              ("cnn K5 bf16", "cnn", "bf16", "full", True, 320),
              ("resnet18 bf16", "resnet", "bf16", "full", False, 192),
              ("densenet121 bf16", "densenet", "bf16", "full", False, 192))
GRAPH_EPOCHS, GRAPH_K = 4, 2
GRAPH_PROFILE_STEPS = 2     # a trace's processing grows with its kernels
GRAPH_TRACE_TRIES = 3


def traces_agree(prof: dict, per_step: dict) -> bool:
    """Both traces of a graph_profile pair have device time, and the
    graphed step's launches of the port's kernels equal the eager's."""
    return (all(r["device_ms"] is not None for r in prof.values())
            and per_step["graphed"] == per_step["eager"])
# the port's kernels as the profiler names them (either route)
PROFILED_KERNELS = {"flash_fwd": "flash_fwd_", "flash_dq": "flash_dq_",
                    "flash_dkv": "flash_dkv_", "conv_dw": "conv_dw"}


def graph_profile(step, reps: int) -> dict:
    """Wall ms a step (host clock, synchronized, profiler off), then under
    torch.profiler device ms a step, kernels a step, the idle share of the
    wall and the port's kernels' launches a step, read from the device
    events after the trace's lead-in and marker (``_device_trace``'s:
    a trace can lose its first events, once a whole graph replay)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    lead = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN):
            lead.add_(1.0)
        torch.cuda._sleep(1000)
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)),
                    key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
    kernels = events[marks[0] + 1:] if marks else []
    dev = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps
    return dict(wall_ms=wall, device_ms=dev if dev > 0 else None,
                kernels=len(kernels) / reps,
                idle=(1 - dev / wall) if dev > 0 else None,
                launches={n: sum(tag in e.name for e in kernels) / reps
                          for n, tag in PROFILED_KERNELS.items()})


def phase_graphs() -> dict:
    """Each run of GRAPH_RUNS eagerly and graphed from the same seed: the
    parameters, BatchNorm statistics, optimizer state, counters, loss
    scale and every epoch's train and validation sums bit-identical; the
    graphed run's kernel launches counted as one capture's times its
    replays equal to the eager run's; then a profile of each path's train
    step (GRAPH_PROFILE_STEPS eager steps, the same number of replays):
    wall and device ms, kernels a step, the idle share, and the port's
    kernels a step read from the trace, the graphed ones equal to the
    eager ones.  Returns the profiles by label."""
    import torch

    from distributedpytorch_tpu_torch import cli, utils
    from distributedpytorch_tpu_torch.data.datasets import Split
    from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader
    from distributedpytorch_tpu_torch.models import (get_model,
                                                     get_model_input_size)
    from distributedpytorch_tpu_torch.ops import flops as flops_mod
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.dispatch import ChunkRunner
    from distributedpytorch_tpu_torch.train.engine import Engine

    torch.backends.cudnn.deterministic = True   # as train sets it
    torch.backends.cudnn.benchmark = False
    ds = work_dataset()
    valid = ResidentLoader(Split(ds.splits["valid"].images[:TRAIN_BATCH],
                                 ds.splits["valid"].labels[:TRAIN_BATCH]),
                           TRAIN_BATCH, False, SEED, "cuda")
    out = {}
    for label, name, precision, attention, k5, rows in GRAPH_RUNS:
        split = ds.splits["train"]
        train = ResidentLoader(Split(split.images[:rows],
                                     split.labels[:rows]),
                               TRAIN_BATCH, True, SEED, "cuda")
        policy = PRESETS[precision]

        def build():
            model = get_model(name, ds.nb_classes, policy,
                              attention=attention, device="cuda",
                              pallas_dw=k5)
            engine = Engine(model, cross_entropy, ds.mean, ds.std,
                            get_model_input_size(name), policy, "cuda",
                            steps_per_epoch=len(train))
            return engine, engine.init_state(
                torch.Generator().manual_seed(SEED))

        runs = {}
        for path in ("eager", "graphed"):
            engine, state = build()
            before = cli.kernel_launches()
            t0 = time.perf_counter()
            sums = []
            if path == "eager":
                for epoch in range(GRAPH_EPOCHS):
                    _, tl, ta = cli._run_train_pass(engine, state, train,
                                                    epoch, SEED)
                    sums.append((tl, ta) + cli._run_eval_pass(
                        engine, state, valid, epoch))
                step_fn = None
            else:
                runner = ChunkRunner(engine, state, train, valid, SEED,
                                     GRAPH_K)
                for first in range(0, GRAPH_EPOCHS, GRAPH_K):
                    got = runner.run(list(range(first, first + GRAPH_K)))
                    for m, ev in zip(got["train"], got["eval"]):
                        n, d, c, v = ev.tolist()
                        sums.append((float(m[:, 0].mean()),
                                     float(m[:, 1].sum()
                                           / max(float(m[:, 2].sum()), 1.0)),
                                     n / max(d, 1e-9), c / max(v, 1.0)))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[path] = dict(
                engine=engine, state=state, sums=sums, wall=wall,
                runner=runner if path == "graphed" else None,
                launches={k: v - before[k] for k, v in
                          cli.kernel_launches().items() if v - before[k]},
                model={k: v.detach().clone() for k, v in
                       state.model.state_dict().items()},
                opt=state.optimizer.state_dict()["state"],
                counters=(int(state.step), int(state.updates)),
                scale=(state.loss_scale.to_dict() if state.loss_scale
                       else None))
        eager, graphed = runs["eager"], runs["graphed"]
        differ = [k for k, v in eager["model"].items()
                  if not torch.equal(v, graphed["model"][k])]
        differ += [f"opt/{i}/{n}" for i, st in eager["opt"].items()
                   for n, t in st.items()
                   if not torch.equal(t, graphed["opt"][i][n])]
        same = (not differ and eager["sums"] == graphed["sums"]
                and eager["counters"] == graphed["counters"]
                and eager["scale"] == graphed["scale"]
                and eager["launches"] == graphed["launches"])
        # the profiles: eager steps on epoch 0's batches, and replays of
        # the captured step from the chunk plan's first rows
        engine, state = eager["engine"], eager["state"]
        batches = list(itertools.islice(train.epoch(0),
                                        GRAPH_PROFILE_STEPS + 2))
        it = itertools.cycle(range(len(batches)))

        def eager_step():
            i = next(it)
            engine.train_step(state, *batches[i],
                              utils.step_generator(SEED, 0, i, "cuda"))

        runner = graphed["runner"]
        plan_rows = GRAPH_K * len(train)
        replays = itertools.count()

        def graphed_step():
            # the step counter walks the chunk's plan; start it over
            if next(replays) % plan_rows == 0:
                runner.counters[0].zero_()
            runner.train_step()

        # a trace that lost events is taken again, GRAPH_TRACE_TRIES at most
        for attempt in range(1, GRAPH_TRACE_TRIES + 1):
            prof = {p: graph_profile(fn, GRAPH_PROFILE_STEPS)
                    for p, fn in (("eager", eager_step),
                                  ("graphed", graphed_step))}
            per_step = {p: {k: v for k, v in prof[p]["launches"].items()
                            if v} for p in prof}
            if traces_agree(prof, per_step):
                break
            say(f"graphs: {label}: trace {attempt} of {GRAPH_TRACE_TRIES} "
                f"lost events: the port's kernels a step {per_step}, "
                "kernels a step "
                + str({p: r["kernels"] for p, r in prof.items()}))
        say(f"graphs: {label}, {len(train)} steps and {len(valid)} eval "
            f"batch an epoch, {GRAPH_EPOCHS} epochs: eager "
            f"{eager['wall']:.2f}s, graphed ({GRAPH_EPOCHS // GRAPH_K} "
            f"chunks of {GRAPH_K}, captures included) {graphed['wall']:.2f}s; bit-identical "
            f"{same} (differing {differ[:4]}); counters "
            f"{graphed['counters']}; launches eager {eager['launches']} "
            f"graphed {graphed['launches']}")
        fps = flops_mod.train_flops_per_sample(name, ds.nb_classes)
        peak = flops_mod.peak_flops(
            torch.cuda.get_device_name(0),
            flops_mod.compute_peak_label(policy.compute_dtype))
        for p, r in prof.items():
            mfu = TRAIN_BATCH / (r["wall_ms"] / 1e3) * fps / peak
            say(f"graphs:   {label} {p} train step: MFU {100 * mfu:.4f}% "
                f"of the {flops_mod.compute_peak_label(policy.compute_dtype)}"
                f" peak at {fps:,.0f} FLOPs a sample; wall "
                f"{r['wall_ms']:.3f} ms, device "
                f"{fmt_ms(r['device_ms'])} ms in {r['kernels']:.0f} kernels "
                f"(idle " + ("not measured" if r["idle"] is None else
                             f"{100 * r['idle']:.1f}%")
                + f"); the port's kernels' device launches a step from the "
            f"trace {per_step[p]} (K5 is two a call: partial sums, then "
            f"their reduction)")
        if not same:
            fail(f"the graphed {label} run is not bit-identical to the "
                 f"eager one: {differ[:8]}, sums {eager['sums']} vs "
                 f"{graphed['sums']}, counters {eager['counters']} vs "
                 f"{graphed['counters']}, launches {eager['launches']} vs "
                 f"{graphed['launches']}")
        if not traces_agree(prof, per_step):
            fail(f"torch.profiler's trace of the graphed {label} step "
                 f"shows {per_step['graphed']} of the port's kernels a "
                 f"step against the eager step's {per_step['eager']}")
        out[label] = prof
    return out


def start_graph_cli() -> list:
    """``train --model vit --attention flash --debug -e 4`` with
    ``--epochs-per-dispatch 2`` and without, at once."""
    base = ["train", "--model", "vit", "--attention", "flash", "--debug",
            "-e", "4"]
    return [start_cli(base + extra, os.path.join(WORK, name))
            for name, extra in (("graph_k1", []),
                                ("graph_k2", ["--epochs-per-dispatch",
                                              "2"]))]


def phase_graph_cli(runs: list) -> None:
    """The two runs of ``start_graph_cli``: the same Train and Validation
    lines, the rolling file of epoch 4 byte-identical, and the chunked
    run's best file from a chunk's end."""
    from distributedpytorch_tpu_torch import checkpoint as ckpt

    (w1, log1), (w2, log2) = finish_all(runs)
    keep = re.compile(r"\| (Loss|Acc)|mean train loss")

    def lines(log):
        return [line.split(" - ")[-1] for line in log.splitlines()
                if keep.search(line)]

    rolling = [os.path.join(WORK, name, "checkpoint-mnist-vit-003.ckpt")
               for name in ("graph_k1", "graph_k2")]
    with open(rolling[0], "rb") as f1, open(rolling[1], "rb") as f2:
        same_bytes = f1.read() == f2.read()
    best = ckpt.read_checkpoint(os.path.join(
        WORK, "graph_k2", "bestmodel-mnist-vit.ckpt"))["epoch"]
    say(f"graphs: train --epochs-per-dispatch 2 --debug -e 4 of the vit "
        f"(flash) "
        f"in {w2:.1f}s against -e 4 in {w1:.1f}s of process wall: log "
        f"lines equal {lines(log1) == lines(log2)} ({len(lines(log1))}), "
        f"rolling file of epoch 4 byte-identical {same_bytes}, best file "
        f"from epoch {best + 1}")
    if not (same_bytes and lines(log1) == lines(log2) and lines(log1)
            and best in (1, 3)):
        fail("the chunked train differs from the epoch-at-a-time one")


def flash_attention_counts() -> dict:
    """(launches, tensor-core launches) of K1, K2 and K3, by kernel name."""
    from distributedpytorch_tpu_torch.ops import flash_attention as tfa

    return {name: (fn.launches, fn.tensor_core_launches) for name, fn in
            (("flash_fwd", tfa.flash_attention_fwd),
             ("flash_dq", tfa.flash_attention_dq),
             ("flash_dkv", tfa.flash_attention_dkv))}


# -- phase 25: one f16 train step on the card against the CPU ----------------

# The full-width vit, f16 at the loss scale 2^15, card against CPU, each
# gradient (f32, unscaled) relative to its largest value: float16 rounds
# at the same points on both devices (casts at use, products rounded to
# float16, the kernels' p and dS rounded to float16 on the tensor cores,
# held in f32 by the CPU's plain version), summed in other orders; the
# narrow vit's f16 step sits within 1.4e-3 of the JAX one on the CPU.
TOL_F16_STEP = 1e-2


def phase_f16_step() -> None:
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.data import augment
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine

    policy = PRESETS["f16"]
    ds = work_dataset()
    images = ds.splits["train"].images[:TRAIN_BATCH]
    labels = ds.splits["train"].labels[:TRAIN_BATCH].astype(np.int64)
    u = np.random.default_rng(SEED).random((TRAIN_BATCH, 5),
                                           dtype=np.float32)
    got = {}
    for device in ("cuda", "cpu"):
        model = get_model("vit", ds.nb_classes, policy, attention="flash",
                          device=device)
        engine = Engine(model, cross_entropy, ds.mean, ds.std, 28, policy,
                        device)
        state = engine.init_state(torch.Generator().manual_seed(SEED))
        affine = augment.affine_from_uniform(
            torch.from_numpy(u).to(device), 28, 28)
        before = flash_attention_counts()
        _, m = engine.train_step_affine(
            state, torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device),
            torch.ones(TRAIN_BATCH, dtype=torch.bool, device=device), affine)
        if device == "cuda":
            torch.cuda.synchronize()
            now = flash_attention_counts()
            step = {n: (now[n][0] - before[n][0], now[n][1] - before[n][1])
                    for n in now}
            say(f"f16 step: one f16 vit step on the card launched "
                f"(launches, tensor-core) {step}")
            if any(v != (DEPTH, DEPTH) for v in step.values()):
                fail(f"an f16 vit step must launch {DEPTH} each of K1, K2 "
                     f"and K3, all on the tensor cores, got {step}")
        got[device] = (m["loss"].item(), int(state.updates),
                       state.loss_scale.to_dict(),
                       {n: p.grad.detach().cpu()
                        for n, p in model.named_parameters()})
    (l_card, u_card, s_card, g_card), (l_cpu, u_cpu, s_cpu, g_cpu) = \
        got["cuda"], got["cpu"]
    finite = all(bool(torch.isfinite(g).all()) for g in g_card.values())
    worst_grad = max(((n, rel_err(g_card[n], g)[1]) for n, g in
                      g_cpu.items()), key=lambda t: t[1])
    say(f"f16 step: full-width vit at loss scale "
        f"{policy.loss_scale:g}, card vs CPU: loss {l_card:.6f} vs "
        f"{l_cpu:.6f}; updates applied {u_card} vs {u_cpu}, scale after "
        f"{s_card['scale']:g} vs {s_cpu['scale']:g}; worst gradient "
        f"{worst_grad[0]} rel err {worst_grad[1]:.3g} (tol "
        f"{TOL_F16_STEP:g}) over {len(g_cpu)} parameters, all finite: "
        f"{finite}")
    if (u_card, s_card) != (u_cpu, s_cpu) or u_card != 1 or not finite \
            or not worst_grad[1] <= TOL_F16_STEP \
            or abs(l_card - l_cpu) > TOL_F16_STEP * abs(l_cpu):
        fail("the f16 vit step on the card disagrees with the CPU's")


# -- phase 26: the overflow skip on the card --------------------------------

def phase_f16_skip() -> None:
    """resnet18's widths at one block a stage (224 px, batch 16), f16 with
    Adam on the card: one finite step, then one whose loss numerator is
    multiplied by 1e38 (finite in f32, not at the scale): parameters, the
    whole Adam state and BatchNorm's running statistics bit-unchanged, the
    step count advanced, the update count not, the scale halved."""
    import copy

    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.data import augment
    from distributedpytorch_tpu_torch.models.resnet import ResNet
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine

    b = PARITY_BATCH["resnet"]
    policy = PRESETS["f16"]
    ds = work_dataset()
    batch = (torch.from_numpy(ds.splits["train"].images[:b]).cuda(),
             torch.from_numpy(ds.splits["train"].labels[:b].astype(
                 np.int64)).cuda(),
             torch.ones(b, dtype=torch.bool, device="cuda"))
    affine = augment.affine_from_uniform(torch.from_numpy(
        np.random.default_rng(SEED).random((b, 5), dtype=np.float32)).cuda(),
        28, 28)
    model = ResNet((1, 1, 1, 1), dtype=policy.compute_dtype, device="cuda")
    engine = Engine(model, cross_entropy, ds.mean, ds.std, 224, policy,
                    "cuda", optimizer="adam")
    state = engine.init_state(torch.Generator().manual_seed(SEED))
    engine.train_step_affine(state, *batch, affine)
    torch.cuda.synchronize()
    first = (int(state.step), int(state.updates), state.loss_scale.to_dict())
    params = {k: v.clone() for k, v in model.state_dict().items()}
    opt = copy.deepcopy(state.optimizer.state_dict())

    def blowup(logits, labels):
        numer, denom = cross_entropy(logits, labels)
        return numer * 1e38, denom

    engine.loss_fn = blowup
    engine.train_step_affine(state, *batch, affine)
    torch.cuda.synchronize()
    moved = [k for k, v in model.state_dict().items()
             if not torch.equal(v, params[k])]
    after = state.optimizer.state_dict()["state"]
    opt_moved = [(i, n) for i, st in opt["state"].items()
                 for n, t in st.items() if not torch.equal(after[i][n], t)]
    n_buffers = sum(1 for _ in model.buffers())
    say(f"skip: f16 resnet (one block a stage, 224 px, batch {b}, Adam) on "
        f"the card: after a finite step (step, updates, scale) "
        f"{first[:2]} {first[2]}; after an injected overflow "
        f"{(int(state.step), int(state.updates))} "
        f"{state.loss_scale.to_dict()}; "
        f"{len(moved)} of {len(params)} parameters and buffers "
        f"({n_buffers} BatchNorm buffers) moved, {len(opt_moved)} of "
        f"{sum(len(s) for s in opt['state'].values())} Adam state tensors "
        f"moved")
    if first[:2] != (1, 1) or moved or opt_moved or not opt["state"] \
            or (int(state.step), int(state.updates)) != (2, 1) \
            or state.loss_scale.to_dict() != {"scale": first[2]["scale"] / 2,
                                              "good_steps": 0}:
        fail(f"the overflow skip on the card: moved {moved[:5]}, Adam "
             f"{opt_moved[:5]}, state {(int(state.step), int(state.updates))} "
             f"{state.loss_scale.to_dict()}")


# -- phase 27: the f16 main path ----------------------------------------------

F16_CNN_STEPS = 200     # the Engine-driven cnn with K5 in f16 (of 844)


def parse_loss_scale(log: str) -> tuple:
    m = re.search(r"train: loss scale (\S+) after (\d+) steps, (\d+) "
                  r"skipped on non-finite gradients", log)
    if m is None:
        fail("an f16 train did not log its loss scale and skipped steps")
    return float(m.group(1)), int(m.group(2)), int(m.group(3))


def start_f16_train() -> tuple:
    """Phase 27's ``train --model vit --attention flash --precision f16
    -e 1`` on RING_DATA (99 steps), started ahead of the phase."""
    write_ring_data()
    return start_cli(["train", "--model", "vit", "--attention", "flash",
                      "--precision", "f16", "-e", "1"],
                     os.path.join(WORK, "f16_rsl"), data=RING_DATA)


def phase_f16_main_path(train_run: tuple) -> dict:
    """The end of ``start_f16_train``'s run, then ``test -f --precision
    f16`` and ``serve --precision f16`` (one wave of 16) of its best
    model; then the Engine-driven cnn with K5 in f16 (F16_CNN_STEPS
    steps).  Returns the launches of K1, K2, K3 and K5 on these runs."""
    rsl = train_run[1]
    (wall, log), = finish_all([train_run])
    launches, steps, evals = parse_launches(log, "train")
    tensor_core = parse_tensor_core_launches(log, "train")
    scale, scale_steps, skipped = parse_loss_scale(log)
    want = {"flash_fwd": DEPTH * (steps + evals), "flash_dq": DEPTH * steps,
            "flash_dkv": DEPTH * steps, "conv_dw": 0}
    say(f"f16 train: launches {launches} over {steps} steps and {evals} "
        f"eval batches, formula {want}; on the tensor cores {tensor_core} "
        f"(the vit computes in float16: every launch takes float16); loss "
        f"scale {scale:g} after {scale_steps} steps, {skipped} skipped")
    if launches != want or tensor_core != want or scale_steps != steps \
            or skipped >= steps:
        fail(f"the f16 train's launches {launches} (tensor-core "
             f"{tensor_core}) do not match {want}, or its steps were "
             f"skipped ({skipped} of {steps})")
    check_epoch_log("f16 train", log, steps, wall)
    best = os.path.join(rsl, "bestmodel-mnist-vit.ckpt")

    import numpy as np


    ds = work_dataset()
    images = ds.splits["test"].images[:ZOO_WAVE]
    server = start_server(best, ZOO_WAVE, FLUSH_MS, "cuda",
                          precision="f16")
    test = start_cli(["test", "-f", best, "--attention", "flash",
                      "--precision", "f16"],
                     os.path.join(WORK, "f16_test"), data=RING_DATA)
    try:
        batches = serve_zoo(best, "vit", server, images, precision="f16")
    finally:
        if server[1].poll() is None:
            server[1].kill()
            server[1].wait()
    (_, tlog), = finish_all([test])
    acc_cli = re.search(r"Time: \d+m \d+s, Acc: ([\d.]+)%", tlog).group(1)
    tlaunch, _, tevals = parse_launches(tlog, "test")
    acc_here, correct, n = eval_accuracy(best, "vit", RING_DATA,
                                         precision="f16")
    say(f"f16 test: `test -f --precision f16` {acc_cli}% ({tevals} eval "
        f"batches, launches {tlaunch}); in-process f16 eval {acc_here}% "
        f"({correct}/{n}); served {ZOO_WAVE} answers in {batches} batches")
    if acc_cli != acc_here or tlaunch["flash_fwd"] != DEPTH * tevals:
        fail("the f16 test disagrees with the in-process f16 eval")
    np.testing.assert_equal(n, RING_DATA_TEST_ROWS)
    cnn = cnn_epoch(True, SEED, precision="f16", max_steps=F16_CNN_STEPS)
    say(f"f16 cnn: Engine-driven cnn with K5, f16: {cnn['steps']} steps in "
        f"{cnn['wall']:.2f}s, validation acc {cnn['acc']:.2f}% (chance "
        f"10%), mean train loss first 10% {cnn['first']:.5f} last 10% "
        f"{cnn['last']:.5f}, K5 launches {cnn['launches']} "
        f"({cnn['tc_launches']} on the tensor cores), {cnn['skipped']} "
        f"steps skipped, loss scale {cnn['scale']:g}")
    if cnn["launches"] != 3 * cnn["steps"] or cnn["steps"] != F16_CNN_STEPS \
            or cnn["tc_launches"] != cnn["launches"] or cnn["acc"] < 20.0 \
            or not cnn["last"] < cnn["first"]:
        fail(f"the f16 cnn with K5: {cnn}")
    return {"flash_fwd_f16": launches["flash_fwd"],
            "flash_dq_f16": launches["flash_dq"],
            "flash_dkv_f16": launches["flash_dkv"],
            "conv_dw_f16": cnn["launches"]}


# -- phase 28: --grad-accum on the card ---------------------------------

# K = 4 against K = 1 over three f32 SGD steps (TF32 off): the tests' and
# the JAX package's bound (the same f32 math, the microbatch gradients
# summed in another order).  f64 accumulated steps, card against CPU, each
# tensor relative to its largest value: f64 compute, f32 parameters.
ACCUM_RTOL, ACCUM_ATOL = 2e-5, 2e-6
TOL_ACCUM_F64 = 1e-6
ACCUM_K = 4


def accum_steps(name: str, k: int) -> tuple:
    """Three f32 SGD steps of ``name`` (vit with flash, or cnn with K5) at
    ``grad_accum`` k on the card, from SEED's weights, on the first global
    batch of the synthetic train split and three affine draws: (state
    dict, per-step K1/K5 launches)."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.data import augment
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.ops import conv
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS

    from distributedpytorch_tpu_torch.train.engine import Engine

    policy = PRESETS["f32"]
    ds = work_dataset()
    model = get_model(name, 10, policy, device="cuda",
                      attention="flash" if name == "vit" else "full",
                      pallas_dw=name == "cnn")
    engine = Engine(model, cross_entropy, ds.mean, ds.std, 28, policy,
                    "cuda", optimizer="SGD", steps_per_epoch=2,
                    grad_accum=k)
    state = engine.init_state(torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    launches = []
    for step in range(3):
        rows = slice(step * TRAIN_BATCH, (step + 1) * TRAIN_BATCH)
        valid = torch.ones(TRAIN_BATCH, dtype=torch.bool, device="cuda")
        if step == 0:
            valid[-5:] = False
        affine = augment.affine_from_uniform(torch.from_numpy(
            rng.random((TRAIN_BATCH, 5), dtype=np.float32)).cuda(), 28, 28)
        before = (flash_attention_counts()["flash_fwd"][0],
                  conv.conv3x3_dw.launches)
        engine.train_step_affine(
            state, torch.from_numpy(ds.splits["train"].images[rows]).cuda(),
            torch.from_numpy(ds.splits["train"].labels[rows].astype(
                np.int64)).cuda(), valid, affine)
        torch.cuda.synchronize()
        launches.append((flash_attention_counts()["flash_fwd"][0]
                         - before[0], conv.conv3x3_dw.launches - before[1]))
    return ({k_: v.detach().cpu() for k_, v in model.state_dict().items()},
            launches)


def accum_f64_step(name: str, device: str, masks) -> dict:
    """One f64 accumulated SGD step (K = ACCUM_K, f32 parameters) of the
    reduced resnet (two stages of width 8, 32 px) or alexnet (64 px) from
    SEED's weights on the identity affine with the given per-microbatch
    masks: gradients and BatchNorm statistics on the CPU."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.models.resnet import ResNet
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.train.engine import Engine

    policy = f64_policy()
    b = 16
    ds = work_dataset()
    if name == "resnet_small":
        model, size = ResNet((1, 1), width=8, dtype=torch.float64,
                             device=device), 32
    else:
        model, size = get_model(name, 10, policy, device=device), 64
    engine = Engine(model, cross_entropy, ds.mean, ds.std, size, policy,
                    device, optimizer="SGD", grad_accum=ACCUM_K)
    state = engine.init_state(torch.Generator().manual_seed(SEED))
    valid = torch.ones(b, dtype=torch.bool, device=device)
    valid[-3:] = False
    engine.train_step_affine(
        state, torch.from_numpy(ds.splits["train"].images[:b]).to(device),
        torch.from_numpy(ds.splits["train"].labels[:b].astype(
            np.int64)).to(device), valid, identity_affine(b, device),
        [[m.to(device) for m in ms] for ms in masks])
    if device == "cuda":
        torch.cuda.synchronize()
    return {**{n: p.grad.detach().cpu() for n, p in
               model.named_parameters()},
            **{n: v.detach().cpu() for n, v in model.named_buffers()}}


def phase_grad_accum() -> None:
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.train.engine import Engine

    for name in ("vit", "cnn"):
        one, l1 = accum_steps(name, 1)
        four, l4 = accum_steps(name, ACCUM_K)
        bad = [k for k, v in one.items() if not np.allclose(
            four[k].numpy(), v.numpy(), rtol=ACCUM_RTOL, atol=ACCUM_ATOL)]
        worst_ = max(((k, rel_err(four[k], v)[1]) for k, v in one.items()),
                     key=lambda t: t[1])
        per_micro = DEPTH if name == "vit" else 3
        want = [(per_micro * ACCUM_K, 0) if name == "vit"
                else (0, per_micro * ACCUM_K)] * 3
        say(f"grad-accum: {name}, three f32 SGD steps at K = {ACCUM_K} vs "
            f"K = 1 on the card (global batch {TRAIN_BATCH}): worst "
            f"{worst_[0]} rel err {worst_[1]:.3g}, {len(bad)} tensors "
            f"outside rtol {ACCUM_RTOL:g} atol {ACCUM_ATOL:g}; (K1, K5) "
            f"launches a step {l4} at K = {ACCUM_K}, {l1} at K = 1")
        if bad or l4 != want:
            fail(f"the accumulated {name} steps disagree: {bad[:5]}, "
                 f"launches {l4} (want {want})")
    for name in ("resnet_small", "alexnet"):
        masks = [[]] * ACCUM_K
        if name == "alexnet":
            engine = Engine(get_model(name, 10, f64_policy(), device="cpu"),
                            cross_entropy, 0.0, 1.0, 64, f64_policy(),
                            "cpu")
            gen = torch.Generator().manual_seed(SEED)
            masks = [engine.draw_dropout_masks(gen, 16 // ACCUM_K)
                     for _ in range(ACCUM_K)]
        card = accum_f64_step(name, "cuda", masks)
        cpu = accum_f64_step(name, "cpu", masks)
        worst_ = max(((k, rel_err(card[k], v)[1]) for k, v in cpu.items()),
                     key=lambda t: t[1])
        say(f"grad-accum: {name}, one f64 accumulated step (K = "
            f"{ACCUM_K}, batch 16, {sum(len(m) for m in masks)} dropout "
            f"masks) card vs CPU: worst {worst_[0]} rel err "
            f"{worst_[1]:.3g} (tol {TOL_ACCUM_F64:g}) over {len(cpu)} "
            f"tensors")
        if not worst_[1] <= TOL_ACCUM_F64:
            fail(f"the f64 accumulated {name} step on the card disagrees "
                 f"with the CPU's: {worst_}")


# -- phase 29: bf16_full ------------------------------------------------------

def start_bf16_full() -> tuple:
    """Phase 29's ``train --model resnet --precision bf16_full -e 1`` on
    phase 22's corpus (18 steps), started ahead of the phase."""
    write_zoo_data()
    return start_cli(["train", "--model", "resnet", "--precision",
                      "bf16_full", "-e", "1"],
                     os.path.join(WORK, "bf16_full_rsl"), data=ZOO_DATA)


def start_bf16_full_test(train_run: tuple) -> dict:
    """The end of ``start_bf16_full``'s run, and ``test -f --precision
    bf16_full`` of its best model started."""
    (wall, log), = finish_all([train_run])
    best = os.path.join(train_run[1], "bestmodel-mnist-resnet.ckpt")
    return dict(wall=wall, log=log, best=best, run=start_cli(
        ["test", "-f", best, "--precision", "bf16_full"],
        os.path.join(WORK, "bf16_full_test"), data=ZOO_DATA))


def phase_bf16_full(pending: dict) -> None:
    """``start_bf16_full_test``'s train run checked (18 finite steps,
    bfloat16 parameters and f32 statistics in its checkpoint), and its
    test's end against an in-process eval."""
    import torch

    from distributedpytorch_tpu_torch import checkpoint as ckpt

    wall, log, best = pending["wall"], pending["log"], pending["best"]
    _, steps, _ = parse_launches(log, "train")
    losses = zoo_log_losses(log)
    params = ckpt.read_checkpoint(best)["state"]["params"]
    dtypes = {}
    for k, v in params.items():
        kind = "statistic" if "running" in k else "parameter"
        dtypes.setdefault(kind, set()).add(str(v.dtype))
    (_, tlog), = finish_all([pending["run"]])
    acc_cli = re.search(r"Time: \d+m \d+s, Acc: ([\d.]+)%", tlog).group(1)
    acc_here, correct, n = eval_accuracy(best, "resnet", ZOO_DATA,
                                         precision="bf16_full")
    say(f"bf16_full: `train --model resnet --precision bf16_full` "
        f"({wall:.1f}s of process wall): {steps} steps, {len(losses)} "
        f"logged losses, last train loss {losses[-2]}, validation loss "
        f"{losses[-1]}; checkpoint dtypes {dtypes}; `test -f` "
        f"{acc_cli}%, in-process eval {acc_here}% ({correct}/{n})")
    if dtypes != {"parameter": {str(torch.bfloat16)},
                  "statistic": {str(torch.float32)}} \
            or steps != math.ceil(int(ZOO_TRAIN_ROWS * 0.9) / TRAIN_BATCH) \
            or not all(map(math.isfinite, losses)) or acc_cli != acc_here:
        fail(f"bf16_full resnet: dtypes {dtypes}, {steps} steps, losses "
             f"{losses}, test {acc_cli} vs {acc_here}")


# -- phase 30: --ckpt-async -----------------------------------------------

ASYNC_BASE = ["train", "--model", "vit", "--attention", "flash", "--debug",
              "--keep-ckpts", "2", "-e", "2"]


def ckpt_async_rsl(name: str) -> str:
    return os.path.join(WORK, f"async_{name}")


def start_ckpt_async() -> list:
    """Phase 30's uninterrupted runs, with and without ``--ckpt-async``,
    started ahead of the phase."""
    return [start_cli(ASYNC_BASE, ckpt_async_rsl("sync")),
            start_cli(ASYNC_BASE + ["--ckpt-async"], ckpt_async_rsl("async"))]


def start_ckpt_async_resume(runs: list) -> dict:
    """The ends of ``start_ckpt_async``'s uninterrupted runs, their
    checkpoint files compared byte for byte, and the asynchronous run's
    resume from its epoch-1 file, itself asynchronous, started."""
    rsl = {n: ckpt_async_rsl(n) for n in ("sync", "async", "resumed")}
    finish_all(runs)
    files = sorted(f for f in os.listdir(rsl["sync"]) if f.endswith(".ckpt"))
    differ = []
    for f in files:
        with open(os.path.join(rsl["sync"], f), "rb") as a, \
                open(os.path.join(rsl["async"], f), "rb") as b:
            if a.read() != b.read():
                differ.append(f)
    first = "checkpoint-mnist-vit-000.ckpt"
    os.makedirs(rsl["resumed"], exist_ok=True)
    shutil.copy(os.path.join(rsl["async"], first),
                os.path.join(rsl["resumed"], first))
    return dict(rsl=rsl, files=files, differ=differ, run=start_cli(
        ASYNC_BASE + ["--ckpt-async", "-f",
                      os.path.join(rsl["resumed"], first)], rsl["resumed"]))


def phase_ckpt_async(pending: dict) -> None:
    """Phase 7's resume check with ``--ckpt-async``: every checkpoint
    file of the uninterrupted run byte-identical to the synchronous run's
    (``start_ckpt_async_resume``), and the asynchronous resume's end
    against the uninterrupted run (bit for bit)."""
    rsl, files, differ = pending["rsl"], pending["files"], pending["differ"]
    finish_all([pending["run"]])
    last = "checkpoint-mnist-vit-001.ckpt"
    n, resumed_differ = state_tensors_differ(
        os.path.join(rsl["sync"], last), os.path.join(rsl["resumed"], last))
    say(f"ckpt-async: {len(files)} checkpoint files {files}, "
        f"{len(differ)} differ byte for byte between the synchronous and "
        f"the asynchronous run; the asynchronous resume against the "
        f"uninterrupted run: {n} tensors of params and optimizer state, "
        f"{len(resumed_differ)} differ")
    if differ or len(files) != 3 or resumed_differ or not n:
        fail(f"--ckpt-async: files differ {differ}, resumed tensors differ "
             f"{resumed_differ[:5]}")


# -- phase 31: the accuracy exit test -------------------------------------

# PARITY.json: the JAX package's cnn, Adam, batch 64, 2 epochs on
# synthetic_hard, test accuracy of the best-valid-loss model over five
# seeds: mean 92.69%, seed sd 1.36 pp.  The port's five-seed mean must lie
# within 3 sd of the difference of two 5-seed means: 3 x 1.36 x sqrt(2/5)
# = 2.58, rounded to 2.6 pp.
EXIT_SEEDS = (1234, 7, 99, 41, 2024)
EXIT_TOL_PP = 2.6
EXIT_DATA = os.path.join(WORK, "exit_data")


def start_exit_test() -> list:
    """The five seeds' trainings, started at once (``run_train`` on the
    argv ``train --model cnn --dataset synthetic_hard --synthetic-fallback
    -b 64 -e 2`` with the config's seed set: the CLI, like the JAX one,
    has no seed flag)."""
    runs = []
    for seed in EXIT_SEEDS:
        rsl = os.path.join(WORK, f"exit_{seed}")
        argv = ["train", "-d", EXIT_DATA, "--rsl_path", rsl, "--model",
                "cnn", "--dataset", "synthetic_hard",
                "--synthetic-fallback", "-b", "64", "-e", "2", "--device",
                "cuda"]
        code = ("import dataclasses\n"
                "from distributedpytorch_tpu_torch import cli, config, "
                "runtime\n"
                f"cfg = dataclasses.replace(config.config_from_argv("
                f"{argv!r}), seed={seed})\n"
                "try:\n"
                "    cli.run_train(cfg)\n"
                "finally:\n"
                "    runtime.shutdown_distributed()\n")
        out = os.path.join(WORK, f"exit_{seed}.out")
        say(f"run: train seed {seed}: " + " ".join(argv[1:]))
        with open(out, "w") as f:
            proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                    stdout=f, stderr=subprocess.STDOUT)
        runs.append(("train", rsl, out, proc, time.perf_counter()))
    return runs


def phase_exit_test(runs: list) -> None:
    """The five trainings' ends, then ``test -f`` on each best file (all
    five at once); the mean test accuracy against PARITY.json's."""
    with open(os.path.join(ROOT, "PARITY.json")) as f:
        parity = json.load(f)
    if tuple(parity["seeds"]) != EXIT_SEEDS:
        fail(f"PARITY.json's seeds {parity['seeds']} are not {EXIT_SEEDS}")
    trained = finish_all(runs)
    tests = [start_cli(["test", "-f", os.path.join(
        WORK, f"exit_{seed}", "bestmodel-synthetic_hard-cnn.ckpt"), "-b",
        "64"], os.path.join(WORK, f"exit_test_{seed}"), data=EXIT_DATA,
        dataset="synthetic_hard") for seed in EXIT_SEEDS]
    accs = []
    for seed, (wall, log), (_, tlog) in zip(EXIT_SEEDS, trained,
                                            finish_all(tests)):
        acc = float(re.search(r"Time: \d+m \d+s, Acc: ([\d.]+)%",
                              tlog).group(1))
        accs.append(acc)
        valid = re.findall(r"Validation  \| Loss: ([\d.]+) +\| Acc: "
                           r"([\d.]+)%", log)
        say(f"exit: seed {seed}: 2 epochs, collected {wall:.1f}s after "
            f"the five started together (beside phases 21, 22 and 25-30); "
            f"validation (loss, acc) {valid}; test "
            f"accuracy {acc:.2f}% (JAX: "
            f"{100 * parity['ours_test_acc'][EXIT_SEEDS.index(seed)]:.2f}"
            f"%)")
    mean = sum(accs) / len(accs)
    sd = (sum((a - mean) ** 2 for a in accs) / (len(accs) - 1)) ** 0.5
    say(f"exit: mean test accuracy {mean:.2f}% (seed sd {sd:.2f} pp) "
        f"against the JAX mean {parity['mean_ours']:.2f}% (sd "
        f"{parity['sd_ours_pp']:.2f} pp): difference "
        f"{mean - parity['mean_ours']:+.2f} pp (tol {EXIT_TOL_PP} pp)")
    if abs(mean - parity["mean_ours"]) > EXIT_TOL_PP:
        fail(f"the exit test's mean test accuracy {mean:.2f}% is more than "
             f"{EXIT_TOL_PP} pp from the JAX mean {parity['mean_ours']}%")


# -- phase 36: the streaming loader ------------------------------------------

# phase 36's CLI trainings of the vit on phase 18's corpus (99 steps):
# (work name, the flags beyond the common ones)
STREAM_CLI = (("stream_resident", ["--data-mode", "resident"]),
              ("stream_default", ["--data-mode", "stream"]),
              ("stream_threads", ["--data-mode", "stream",
                                  "--producer-threads", "3",
                                  "--device-prefetch", "2"]))
STREAM_CNN_STEPS = 100          # the Engine-driven cnn with K5, each loader
STREAM_PROFILE_STEPS = 5
# the loaders that feed the profiled steps: the resident one, and the
# streaming one with no thread and with the CLI's defaults (one producer
# thread); their walls are taken in two rounds, the second in the
# reverse order
STREAM_PROFILE_LOADERS = (
    ("resident", None),
    ("stream, producer-threads 0", dict(producer_threads=0)),
    ("stream, producer-threads 1", dict(producer_threads=1)))


def start_stream_cli() -> list:
    """The three vit trainings of STREAM_CLI, ``train --debug -e 1
    --data-mode stream`` under torchrun (NCCL, one rank), and ``train
    --data-mode stream --epochs-per-dispatch 2``, which must fail."""
    write_ring_data()
    base = ["train", "--model", "vit", "--attention", "flash", "-e", "1"]
    runs = [start_cli(base + extra, os.path.join(WORK, name),
                      data=RING_DATA) for name, extra in STREAM_CLI]
    runs.append(start_cli(["train", "--debug", "-e", "1", "--data-mode",
                           "stream"], os.path.join(WORK, "stream_torchrun"),
                          launcher=TORCHRUN))
    runs.append(start_cli(["train", "--debug", "-e", "2", "--data-mode",
                           "stream", "--epochs-per-dispatch", "2"],
                          os.path.join(WORK, "stream_dispatch")))
    return runs


def stream_cnn(streamed: bool) -> dict:
    """STREAM_CNN_STEPS Engine-driven steps of the cnn with K5 (bf16) from
    the resident loader or the streaming one (the CLI's defaults: prefetch
    2, one producer thread), K5's counts set to 0 just before and read
    just after: every step's loss, the final state, the launches."""
    import torch

    from distributedpytorch_tpu_torch import utils
    from distributedpytorch_tpu_torch.data.datasets import Split
    from distributedpytorch_tpu_torch.data.pipeline import (ResidentLoader,
                                                            ShardedLoader)
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.ops import conv
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine

    ds = work_dataset()
    rows = STREAM_CNN_STEPS * TRAIN_BATCH
    split = Split(ds.splits["train"].images[:rows],
                  ds.splits["train"].labels[:rows])
    loader = (ShardedLoader(split, TRAIN_BATCH, True, SEED, "cuda",
                            producer_threads=1) if streamed
              else ResidentLoader(split, TRAIN_BATCH, True, SEED, "cuda"))
    policy = PRESETS["bf16"]
    model = get_model("cnn", ds.nb_classes, policy, device="cuda",
                      pallas_dw=True)
    engine = Engine(model, cross_entropy, ds.mean, ds.std, 28, policy,
                    "cuda", steps_per_epoch=len(loader))
    state = engine.init_state(torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    conv.conv3x3_dw.launches = 0
    conv.conv3x3_dw.tensor_core_launches = 0
    losses = []
    for i, batch in enumerate(loader.epoch(0)):
        _, m = engine.train_step(state, *batch,
                                 utils.step_generator(SEED, 0, i, "cuda"))
        losses.append(m["loss"])
    out = dict(losses=torch.stack(losses).cpu(),
               launches=conv.conv3x3_dw.launches,
               tc=conv.conv3x3_dw.tensor_core_launches,
               state={k: v.detach().clone()
                      for k, v in model.state_dict().items()})
    return out


def copy_overlap(prof) -> tuple:
    """(host-to-device copies, how many of them overlap a kernel in time,
    the copies' device ms a step's worth summed) from a trace: a copy that
    runs while a kernel runs is on another stream than that kernel."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [e for e in events if "Memcpy HtoD" in e.name]
    kernels = [e for e in events if "Memcpy" not in e.name
               and "Memset" not in e.name]
    overlapping = sum(
        1 for c in copies if any(
            k.time_range.start < c.time_range.end
            and c.time_range.start < k.time_range.end for k in kernels))
    return (len(copies), overlapping,
            sum(c.time_range.elapsed_us() for c in copies) / 1e3)


def stream_step_profile(name: str, attention: str, ds) -> dict:
    """The train step of ``name`` at batch 64, bf16, fed by each loader of
    STREAM_PROFILE_LOADERS (telemetry on): wall ms a step over
    STREAM_PROFILE_STEPS steps (host clock, synchronized, profiler off)
    after one of warm-up, in each of two rounds, the second in the
    reverse order, with the host ms spent taking the batch and in the
    step's call; then, over STREAM_PROFILE_STEPS steps under
    torch.profiler, device ms a step and the idle share against the
    rounds' mean wall; for the streamed steps the bytes copied a step,
    the copies that overlap a kernel, and the loader's data/wait_s and
    data/starved_steps over its steps."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributedpytorch_tpu_torch import telemetry, utils
    from distributedpytorch_tpu_torch.data.datasets import Split
    from distributedpytorch_tpu_torch.data.pipeline import (ResidentLoader,
                                                            ShardedLoader)
    from distributedpytorch_tpu_torch.models import (get_model,
                                                     get_model_input_size)
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine

    rows = 4 * STREAM_PROFILE_STEPS * TRAIN_BATCH
    split = Split(ds.splits["train"].images[:rows],
                  ds.splits["train"].labels[:rows])
    policy = PRESETS["bf16"]
    model = get_model(name, ds.nb_classes, policy, attention=attention,
                      device="cuda")
    engine = Engine(model, cross_entropy, ds.mean, ds.std,
                    get_model_input_size(name), policy, "cuda")
    state = engine.init_state(torch.Generator().manual_seed(SEED))
    tel_dir = tempfile.mkdtemp(dir=WORK)
    tel = telemetry.configure(tel_dir, True, rank=0)
    counted = ("data/wait_s", "data/starved_steps", "data/batches")

    def endless(loader):
        for epoch in itertools.count():
            yield from loader.epoch(epoch)

    feeds = {}
    for mode, kw in STREAM_PROFILE_LOADERS:
        loader = (ResidentLoader(split, TRAIN_BATCH, True, SEED, "cuda")
                  if kw is None else
                  ShardedLoader(split, TRAIN_BATCH, True, SEED, "cuda", **kw))
        feeds[mode] = dict(batches=endless(loader), steps=0, walls=[],
                           counts=dict.fromkeys(counted, 0.0))

    def step(feed, host=None):
        t = time.perf_counter()
        before = {k: tel.counter(k).value for k in counted}
        batch = next(feed["batches"])
        feed["bytes"] = sum(x.numel() * x.element_size() for x in batch)
        t1 = time.perf_counter()
        engine.train_step(state, *batch, utils.step_generator(
            SEED, 0, feed["steps"], "cuda"))
        for k in counted:
            feed["counts"][k] += tel.counter(k).value - before[k]
        if host is not None:
            host[0] += t1 - t
            host[1] += time.perf_counter() - t1
        feed["steps"] += 1

    modes = [mode for mode, _ in STREAM_PROFILE_LOADERS]
    n = STREAM_PROFILE_STEPS
    for mode in modes + modes[::-1]:
        feed = feeds[mode]
        step(feed)                      # warm-up
        torch.cuda.synchronize()
        host = [0.0, 0.0]
        t0 = time.perf_counter()
        for _ in range(n):
            step(feed, host)
        torch.cuda.synchronize()
        feed["walls"].append((time.perf_counter() - t0) * 1e3 / n)
        feed["host_ms"] = [1e3 * h / n for h in host]
    out = {}
    for mode in modes:
        feed = feeds[mode]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step(feed)
            torch.cuda.synchronize()
        feed["batches"].close()         # the epoch's threads stop and join
        dev = sum(e.self_device_time_total for e in device_kernels(prof)) \
            / 1e3 / n
        wall = sum(feed["walls"]) / len(feed["walls"])
        n_copies, overlapping, copy_ms = copy_overlap(prof)
        out[mode] = dict(
            walls=feed["walls"], wall=wall, batch_ms=feed["host_ms"][0],
            step_ms=feed["host_ms"][1], device=dev if dev > 0 else None,
            idle=(1 - dev / wall) if dev > 0 else None,
            bytes=feed["bytes"], copies=n_copies / n,
            overlapping=overlapping / n, copy_ms=copy_ms / n,
            wait_s=feed["counts"]["data/wait_s"],
            starved=feed["counts"]["data/starved_steps"],
            batches=feed["counts"]["data/batches"])
    telemetry.configure(tel_dir, False, rank=0)
    shutil.rmtree(tel_dir, ignore_errors=True)
    del model, engine, state
    torch.cuda.empty_cache()
    return out


def phase_stream() -> None:
    """The in-process part of phase 36: the cnn with K5 streamed against
    resident, bit for bit, then the streamed steps' profiles."""
    import torch


    resident, streamed = stream_cnn(False), stream_cnn(True)
    same = (torch.equal(resident["losses"], streamed["losses"])
            and all(torch.equal(v, resident["state"][k])
                    for k, v in streamed["state"].items()))
    say(f"stream: cnn with K5, {STREAM_CNN_STEPS} steps of 64 from each "
        f"loader: per-step losses and final state bit-identical {same}; K5 "
        f"launches resident {resident['launches']} streamed "
        f"{streamed['launches']} ({streamed['tc']} on the tensor cores), "
        f"formula {3 * STREAM_CNN_STEPS}")
    if not same:
        fail("the streamed cnn steps differ from the resident ones")
    for r in (resident, streamed):
        if r["launches"] != 3 * STREAM_CNN_STEPS or r["tc"] != r["launches"]:
            fail(f"the cnn launched K5 {r['launches']} times ({r['tc']} on "
                 f"the tensor cores) in {STREAM_CNN_STEPS} steps")
    ds = work_dataset()
    torch.backends.cudnn.deterministic = True   # as train sets it
    for label, name, attention in (("vit flash", "vit", "flash"),
                                   ("resnet18 at 224", "resnet", "full")):
        prof = stream_step_profile(name, attention, ds)
        for mode, r in prof.items():
            say(f"stream: {label} train step, batch {TRAIN_BATCH} bf16, "
                f"{mode}: wall {r['wall']:.3f} ms (rounds "
                f"{', '.join(f'{w:.3f}' for w in r['walls'])}; host in the "
                f"second: taking the batch {r['batch_ms']:.3f} ms, the "
                f"step's call {r['step_ms']:.3f} ms), device "
                f"{fmt_ms(r['device'])} ms, idle "
                + ("not measured" if r["idle"] is None
                   else f"{100 * r['idle']:.1f}%")
                + f"; {r['copies']:.0f} host-to-device copies a step "
                f"({r['overlapping']:.1f} overlapping a kernel, "
                f"{r['copy_ms']:.4f} ms)"
                + (f", {r['bytes']} bytes copied a step; telemetry "
                   f"data/wait_s {r['wait_s']:.6f} s and "
                   f"data/starved_steps {r['starved']:.0f} over "
                   f"{r['batches']:.0f} batches" if mode != "resident"
                   else ""))
        r = prof["resident"]
        for mode, s in prof.items():
            if s["device"] is None:
                fail(f"torch.profiler saw no device time in the {label} "
                     f"step ({mode})")
            if mode != "resident":
                say(f"stream: {label}, {mode}: wall "
                    f"{s['wall'] / r['wall']:.3f}x the resident step's, "
                    f"device {s['device'] / r['device']:.3f}x")


def phase_stream_cli(runs: list) -> dict:
    """The CLI trainings of phase 36 (``start_stream_cli``): the two
    streamed vit runs' log lines, launch lines and rolling files equal to
    the resident run's, launches by phase 6's formula on the tensor
    cores; torchrun's streamed run on NCCL.  Starts ``test -f`` of the
    resident and the streamed best files, the streamed one with
    ``--data-mode stream``; returns them with the refused run for
    ``phase_stream_test``."""
    *trains, refused = runs
    done = finish_all(trains)
    keep = re.compile(r"\| (Loss|Acc)|mean train loss|launches")

    def lines(log):
        return [line.split(" - ")[-1] for line in log.splitlines()
                if keep.search(line)]

    (w0, log0), *streamed, (wt, logt) = done
    launches, steps, evals = parse_launches(log0, "train")
    tensor_core = parse_tensor_core_launches(log0, "train")
    want = {"flash_fwd": DEPTH * (steps + evals), "flash_dq": DEPTH * steps,
            "flash_dkv": DEPTH * steps, "conv_dw": 0}
    files = []
    for name, _ in STREAM_CLI:
        with open(os.path.join(WORK, name, "checkpoint-mnist-vit-000.ckpt"),
                  "rb") as f:
            files.append(f.read())
    for (name, extra), (wall, log), data in zip(STREAM_CLI[1:], streamed,
                                                files[1:]):
        say(f"stream: train {' '.join(extra)} of the vit: {steps} steps in "
            f"{wall:.1f}s of process wall (resident {w0:.1f}s); log lines "
            f"equal {lines(log) == lines(log0)} ({len(lines(log0))}), "
            f"rolling file byte-identical {data == files[0]}")
        if lines(log) != lines(log0) or data != files[0]:
            fail(f"the streamed vit run ({' '.join(extra)}) differs from "
                 f"the resident one")
    say(f"stream: launches {launches} (tensor-core {tensor_core}) over "
        f"{steps} steps and {evals} eval batches, formula {want}")
    if launches != want or tensor_core != want or not steps:
        fail(f"the streamed vit's launches {launches} (tensor-core "
             f"{tensor_core}) are not the formula {want}")
    if "backend: nccl" not in logt or "Validation  |" not in logt:
        fail("the streamed train under torchrun did not run on NCCL")
    say(f"stream: torchrun train --debug -e 1 --data-mode stream on NCCL in "
        f"{wt:.1f}s of process wall")
    tests = [start_cli(
        ["test", "-f", os.path.join(WORK, name, "bestmodel-mnist-vit.ckpt"),
         "--attention", "flash", "--data-mode", mode],
        os.path.join(WORK, f"{name}_test"), data=RING_DATA)
        for name, mode in (("stream_resident", "resident"),
                           ("stream_default", "stream"))]
    return {"tests": tests, "refused": refused, "launches": launches}


def phase_stream_test(pending: dict) -> dict:
    """The end of phase 36: the streamed ``test -f`` equal to the
    resident one, and the streamed ``--epochs-per-dispatch 2`` refused
    with JAX's message.  Returns the streamed vit's launches."""
    from distributedpytorch_tpu_torch.config import STREAM_DISPATCH_MESSAGE

    accs = [re.search(r"Time: \d+m \d+s, (Acc: [\d.]+%)", log).group(1)
            for _, log in finish_all(pending["tests"])]
    say(f"stream: test -f resident {accs[0]}, streamed {accs[1]}")
    if accs[0] != accs[1]:
        fail("the streamed test differs from the resident one")
    _, _, out, proc, _ = pending["refused"]
    rc = proc.wait(timeout=300)
    with open(out) as f:
        text = f.read()
    say(f"stream: train --data-mode stream --epochs-per-dispatch 2 exited "
        f"{rc}, with JAX's message {STREAM_DISPATCH_MESSAGE in text}")
    if rc != 1 or STREAM_DISPATCH_MESSAGE not in text:
        fail(f"the streamed --epochs-per-dispatch 2 did not fail with the "
             f"JAX message: rc {rc}, {text[-2000:]}")
    return pending["launches"]


# -- phase 37: --remat -----------------------------------------------------

# (label, model, attention, K5); every step at batch 64, bf16, Adam
REMAT_RUNS = (("vit flash", "vit", "flash", False),
              ("densenet121 at 224", "densenet", "full", False),
              ("resnet18 at 224", "resnet", "full", False),
              ("cnn with K5", "cnn", "full", True))
REMAT_MODES = ("none", "blocks", "full")
REMAT_PROFILE_STEPS = 1     # densenet121: 11.5 thousand kernels a step
REMAT_TRACE_TRIES = 3


def remat_launch_formula(model: str, mode: str) -> dict:
    """The port's launches in one train step: the vit's K1 once a block
    forward, twice under remat (the recompute); K2, K3 once a block; K5
    three times a cnn step under any setting."""
    if model == "vit":
        k1 = DEPTH * (1 if mode == "none" else 2)
        return {"flash_fwd": k1, "flash_dq": DEPTH, "flash_dkv": DEPTH}
    return {"conv_dw": 3} if model == "cnn" else {}


def remat_step(name: str, attention: str, k5: bool, mode: str, batch,
               ds) -> dict:
    """One Adam step under ``mode`` from SEED's weights, the counts set to
    0 just before and read just after; then the peak memory of a second
    step (``torch.cuda.max_memory_allocated``) and the device time of
    REMAT_PROFILE_STEPS more under torch.profiler (``_device_trace``)."""
    import torch

    from distributedpytorch_tpu_torch import utils
    from distributedpytorch_tpu_torch.models import (get_model,
                                                     get_model_input_size)
    from distributedpytorch_tpu_torch.ops import KERNELS
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine

    policy = PRESETS["bf16"]
    model = get_model(name, ds.nb_classes, policy, attention=attention,
                      device="cuda", pallas_dw=k5, remat=mode)
    engine = Engine(model, cross_entropy, ds.mean, ds.std,
                    get_model_input_size(name), policy, "cuda", remat=mode)
    state = engine.init_state(torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    for fn in KERNELS.values():
        fn.launches = fn.tensor_core_launches = 0
    _, m = engine.train_step(state, *batch,
                             utils.step_generator(SEED, 0, 0, "cuda"))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in KERNELS.items() if fn.launches}
    tc = {k: fn.tensor_core_launches for k, fn in KERNELS.items()
          if fn.launches}
    out = dict(loss=m["loss"].item(), launches=launches, tc=tc,
               state={k: v.detach().clone()
                      for k, v in model.state_dict().items()})
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine.train_step(state, *batch, utils.step_generator(SEED, 0, 1,
                                                          "cuda"))
    torch.cuda.synchronize()
    out["wall"] = (time.perf_counter() - t0) * 1e3
    out["peak"] = torch.cuda.max_memory_allocated()
    out["transient"] = out["peak"] - before
    steps = itertools.count(2)

    def step():
        engine.train_step(state, *batch, utils.step_generator(
            SEED, 0, next(steps), "cuda"))

    # _device_trace's lead-in takes the first device events a trace can
    # lose, which were the whole of a cnn step's; a trace lacking the
    # step's events is taken again, at most REMAT_TRACE_TRIES times
    traces = (_device_trace({"step": step}, REMAT_PROFILE_STEPS)
              for _ in range(REMAT_TRACE_TRIES))
    out["device"] = next((t["step"] for t in traces if t), None)
    del model, engine, state
    torch.cuda.empty_cache()
    return out


def remat_graphed() -> None:
    """The vit (flash, bf16) under ``--remat blocks`` on phase 35's 320
    rows: two epochs eager and one chunk of two epochs as CUDA Graph
    replay, bit-identical in parameters, Adam's state, counters, every
    epoch's sums and the launch counts (a capture's launches times its
    replays)."""
    import torch

    from distributedpytorch_tpu_torch import cli
    from distributedpytorch_tpu_torch.data.datasets import Split
    from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.dispatch import ChunkRunner
    from distributedpytorch_tpu_torch.train.engine import Engine

    ds = work_dataset()
    rows = GRAPH_RUNS[0][-1]
    train = ResidentLoader(Split(ds.splits["train"].images[:rows],
                                 ds.splits["train"].labels[:rows]),
                           TRAIN_BATCH, True, SEED, "cuda")
    valid = ResidentLoader(Split(ds.splits["valid"].images[:TRAIN_BATCH],
                                 ds.splits["valid"].labels[:TRAIN_BATCH]),
                           TRAIN_BATCH, False, SEED, "cuda")
    policy = PRESETS["bf16"]
    runs = {}
    for path in ("eager", "graphed"):
        model = get_model("vit", ds.nb_classes, policy, attention="flash",
                          device="cuda", remat="blocks")
        engine = Engine(model, cross_entropy, ds.mean, ds.std, 28, policy,
                        "cuda", steps_per_epoch=len(train), remat="blocks")
        state = engine.init_state(torch.Generator().manual_seed(SEED))
        before = cli.kernel_launches()
        if path == "eager":
            sums = []
            for epoch in range(2):
                _, tl, ta = cli._run_train_pass(engine, state, train, epoch,
                                                SEED)
                sums.append((tl, ta) + cli._run_eval_pass(engine, state,
                                                          valid, epoch))
        else:
            got = ChunkRunner(engine, state, train, valid, SEED, 2).run(
                [0, 1])
            sums = []
            for m, ev in zip(got["train"], got["eval"]):
                n, d, c, v = ev.tolist()
                sums.append((float(m[:, 0].mean()),
                             float(m[:, 1].sum()
                                   / max(float(m[:, 2].sum()), 1.0)),
                             n / max(d, 1e-9), c / max(v, 1.0)))
        torch.cuda.synchronize()
        runs[path] = dict(
            sums=sums, counters=(int(state.step), int(state.updates)),
            launches={k: v - before[k] for k, v in
                      cli.kernel_launches().items() if v - before[k]},
            model={k: v.detach().clone()
                   for k, v in model.state_dict().items()},
            opt=state.optimizer.state_dict()["state"])
    eager, graphed = runs["eager"], runs["graphed"]
    differ = [k for k, v in eager["model"].items()
              if not torch.equal(v, graphed["model"][k])]
    differ += [f"opt/{i}/{n}" for i, st in eager["opt"].items()
               for n, t in st.items()
               if not torch.equal(t, graphed["opt"][i][n])]
    steps = 2 * len(train)
    want = {"flash_fwd": 2 * DEPTH * steps + DEPTH * 2 * len(valid),
            "flash_dq": DEPTH * steps, "flash_dkv": DEPTH * steps}
    same = (not differ and eager["sums"] == graphed["sums"]
            and eager["counters"] == graphed["counters"]
            and eager["launches"] == graphed["launches"] == want)
    say(f"remat: vit flash --remat blocks, 2 epochs of {len(train)} steps "
        f"and {len(valid)} eval batch: one graphed chunk of 2 bit-identical "
        f"to the eager epochs {same} (differing {differ[:4]}); launches "
        f"eager {eager['launches']} graphed {graphed['launches']}, formula "
        f"{want}")
    if not same:
        fail(f"the graphed remat run differs from the eager one: "
             f"{differ[:8]}, sums {eager['sums']} vs {graphed['sums']}, "
             f"launches {eager['launches']} vs {graphed['launches']}")


def phase_remat() -> None:
    """One Adam step of each REMAT_RUNS model under each of REMAT_MODES,
    held bit-identical across the settings (updates, BatchNorm statistics,
    loss) with the launches by ``remat_launch_formula``; peak memory and
    device time a step; then ``remat_graphed``."""
    import torch

    from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader

    ds = work_dataset()
    batch = next(ResidentLoader(ds.splits["train"], TRAIN_BATCH, True, SEED,
                                "cuda").epoch(0))
    torch.backends.cudnn.deterministic = True   # as train sets it
    torch.backends.cudnn.benchmark = False
    for label, name, attention, k5 in REMAT_RUNS:
        t0 = time.perf_counter()
        runs = {mode: remat_step(name, attention, k5, mode, batch, ds)
                for mode in REMAT_MODES}
        say(f"remat: {label}: the three settings took "
            f"{time.perf_counter() - t0:.1f}s")
        base = runs["none"]
        for mode, r in runs.items():
            worst = max(((v.float() - base["state"][k].float()).abs().max()
                         .item() / max(base["state"][k].float().abs().max()
                                       .item(), 1e-30), k)
                        for k, v in r["state"].items())
            identical = worst[0] == 0.0 and r["loss"] == base["loss"]
            formula = remat_launch_formula(name, mode)
            say(f"remat: {label}, --remat {mode}: one Adam step bf16 batch "
                f"{TRAIN_BATCH}: updates, statistics and loss bit-identical "
                f"to none {identical} (largest difference {worst[0]:.3g} of "
                f"the largest value, {worst[1]}); launches {r['launches']} "
                f"(tensor-core {r['tc']}), formula {formula}; peak memory "
                f"{r['peak'] / 2 ** 20:.1f} MiB ({r['transient'] / 2 ** 20:.1f}"
                f" MiB above the state), device {fmt_ms(r['device'])} ms a "
                f"step, wall {r['wall']:.3f} ms")
            if not identical:
                fail(f"{label} under --remat {mode} differs from none: "
                     f"{worst}, loss {r['loss']} vs {base['loss']}")
            if r["launches"] != formula or r["tc"] != formula:
                fail(f"{label} under --remat {mode} launched "
                     f"{r['launches']} (tensor-core {r['tc']}), formula "
                     f"{formula}")
            if r["device"] is None:
                fail(f"torch.profiler saw no device time in {label}'s step")
        say(f"remat: {label}: peak memory blocks/none "
            f"{runs['blocks']['peak'] / base['peak']:.3f}, full/none "
            f"{runs['full']['peak'] / base['peak']:.3f}; device time "
            f"blocks/none {runs['blocks']['device'] / base['device']:.3f}, "
            f"full/none {runs['full']['device'] / base['device']:.3f}")
    remat_graphed()


# a phase's checks that need another phase's output (phase 23 writes
# phase 22's corpus itself when 22 does not run)
# -- phase 38: observability and the kernel cache ----------------------------

OBS_BASE = ["train", "--model", "vit", "--attention", "flash", "--debug",
            "-e", "2"]
OBS_FLAGS = ["--telemetry", "--profile", "--anomaly-capture", "--aot-warmup"]
OBS_CACHE = os.path.join(WORK, "kernel_cache")
OBS_ROWS = 320                  # phase 35's: 5 steps of 64
OBS_ROUNDS = 2
PORT_KERNEL_NAMES = ("flash_fwd", "flash_dq", "flash_dkv")


def telemetry_gauges(rsl: str) -> dict:
    """The last value and attributes of each gauge in rank 0's JSONL."""
    out = {}
    path = os.path.join(rsl, "telemetry", "rank0.jsonl")
    with open(path) as f:
        for line in f:
            ev = json.loads(line)
            if ev.get("kind") == "gauge":
                out[ev["name"]] = (ev.get("value"), ev.get("attrs", {}))
    return out


def cache_listing(path: str) -> dict:
    """{file: (size, mtime ns)} of a directory (empty when absent)."""
    if not os.path.isdir(path):
        return {}
    return {n: (os.stat(os.path.join(path, n)).st_size,
                os.stat(os.path.join(path, n)).st_mtime_ns)
            for n in sorted(os.listdir(path))}


def scrape(port: int, proc, got: dict) -> None:
    """Polls /metrics and /healthz on ``port`` while ``proc`` runs, until
    both answered; ``got`` takes their bodies."""
    while proc.poll() is None and len(got) < 2:
        for path in ("/metrics", "/healthz"):
            if path in got:
                continue
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{path}", timeout=2) as r:
                    got[path] = r.read().decode()
            except (OSError, urllib.error.URLError):
                pass
        time.sleep(0.2)


def start_observability_cli() -> dict:
    """The CLI runs of phase 38, in the background: (a) the flagged train
    on a fresh --compilation-cache-dir, then (b) the same over that
    directory, on a thread that scrapes (a)'s exporter while it runs; (c)
    --no-compile-cache with a TMPDIR of its own; (d) the plain train."""
    shutil.rmtree(OBS_CACHE, ignore_errors=True)
    tmp = os.path.join(WORK, "obs_tmp")
    os.makedirs(tmp, exist_ok=True)
    port = free_port()
    flagged = OBS_BASE + OBS_FLAGS + ["--compilation-cache-dir", OBS_CACHE]
    pending = dict(
        port=port, tmp=tmp, kernels=cache_listing(os.path.join(
            ROOT, "build", "kernels")), scraped={}, runs=[], err=None,
        lock=threading.Lock(), stop=False,
        nocache=start_cli(OBS_BASE + ["--telemetry", "--aot-warmup",
                                      "--no-compile-cache"],
                          os.path.join(WORK, "obs_c"),
                          env=dict(os.environ, TMPDIR=tmp)),
        plain=start_cli(OBS_BASE, os.path.join(WORK, "obs_d")))

    def start(args, name):
        # no process starts once the run's cleanup has begun
        with pending["lock"]:
            if pending["stop"]:
                raise RuntimeError("the run is ending")
            run = start_cli(args, os.path.join(WORK, name))
            pending["runs"].append(run)
            return run

    def chain():
        try:
            cold = start(flagged + ["--metrics-port", str(port)], "obs_a")
            scrape(port, cold[3], pending["scraped"])
            pending["cold"] = finish_cli(cold)
            pending["listing_a"] = cache_listing(OBS_CACHE)
            warm = start(flagged, "obs_b")
            pending["warm"] = finish_cli(warm)
            pending["listing_b"] = cache_listing(OBS_CACHE)
        except BaseException as e:      # fail() exits: re-raised at check
            pending["err"] = e

    pending["thread"] = threading.Thread(target=chain, daemon=True)
    pending["thread"].start()
    return pending


def trace_kernels(path: str) -> list:
    """The names of the device kernels in a Chrome trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e.get("name", "") for e in events
            if isinstance(e, dict) and e.get("cat") == "kernel"]


def phase_observability_cli(pending: dict) -> None:
    """Phase 38's CLI checks: (a) cold cache_hit 0 with /metrics and
    /healthz answered, (b) cache_hit 1, a smaller warmup_s, no new file
    in the directory; (c) nothing left behind, build/kernels untouched;
    (d) the flagged run's epoch lines, launch lines and epoch-2 rolling
    file equal to the plain run's, launches by phase 6's formula, all
    tensor-core; (e) the trace's device kernels, roofline.json naming K1,
    K2 and K3 with a bound class, a non-null bf16 MFU, and the four
    offline subcommands."""
    pending["thread"].join(timeout=900)
    nocache = finish_cli(pending["nocache"])
    plain = finish_cli(pending["plain"])
    if pending["err"] is not None or pending["thread"].is_alive():
        fail(f"observability: the cached runs failed: {pending['err']!r}")
    (wall_a, log_a), (wall_b, log_b) = pending["cold"], pending["warm"]
    rsl_a, rsl_b = (os.path.join(WORK, n) for n in ("obs_a", "obs_b"))
    ga, gb = telemetry_gauges(rsl_a), telemetry_gauges(rsl_b)
    gc = telemetry_gauges(os.path.join(WORK, "obs_c"))
    hit = [g["compile/cache_hit"][0] for g in (ga, gb, gc)]
    warm_s = [g["compile/warmup_s"][0] for g in (ga, gb, gc)]
    new_files = sorted(set(pending["listing_b"]) - set(pending["listing_a"]))
    say(f"observability: (a) cold --compilation-cache-dir: cache_hit "
        f"{hit[0]:g}, warmup {warm_s[0]:.2f} s, {len(pending['listing_a'])}"
        f" files built, process wall {wall_a:.1f} s; (b) warm: cache_hit "
        f"{hit[1]:g}, warmup {warm_s[1]:.2f} s, new files {new_files}, "
        f"process wall {wall_b:.1f} s; (c) --no-compile-cache: cache_hit "
        f"{hit[2]:g}, warmup {warm_s[2]:.2f} s")
    if hit[:2] != [0.0, 1.0] or not warm_s[1] < warm_s[0] or new_files \
            or not pending["listing_a"]:
        fail(f"observability: the kernel cache did not go cold -> warm: "
             f"hits {hit}, warmup {warm_s}, new files {new_files}")
    # the private build directory is dpt-kernels-*; torch itself leaves
    # its inductor cache directory (torchinductor_<user>) in TMPDIR on
    # the import that FlopCounterMode makes
    in_tmp = os.listdir(pending["tmp"])
    left = [n for n in in_tmp if n.startswith("dpt-kernels-")]
    kernels_after = cache_listing(os.path.join(ROOT, "build", "kernels"))
    say(f"observability: (c) kernel directories left in its TMPDIR {left} "
        f"(TMPDIR holds {in_tmp}); build/kernels unchanged "
        f"{kernels_after == pending['kernels']}")
    if left or kernels_after != pending["kernels"] or hit[2] != 0.0:
        fail("observability: --no-compile-cache left a directory behind "
             "or touched build/kernels")
    scraped = pending["scraped"]
    health = json.loads(scraped.get("/healthz", "{}"))
    metrics = scraped.get("/metrics", "")
    say(f"observability: (a) /healthz {health}; /metrics "
        f"{len(metrics.splitlines())} lines, dpt_up "
        f"{'dpt_up 1' in metrics}")
    if health.get("status") != "ok" or "dpt_up 1" not in metrics:
        fail("observability: the exporter did not answer /metrics and "
             "/healthz while the run was alive")
    keep = re.compile(r"\| (Loss|Acc)|mean train loss|launches")

    def lines(log):
        return [line.split(" - ")[-1] for line in log.splitlines()
                if keep.search(line)]

    rolling = [os.path.join(WORK, n, "checkpoint-mnist-vit-001.ckpt")
               for n in ("obs_a", "obs_d")]
    with open(rolling[0], "rb") as f1, open(rolling[1], "rb") as f2:
        same_bytes = f1.read() == f2.read()
    launches, steps, evals = parse_launches(log_a, "train")
    tc = parse_tensor_core_launches(log_a, "train")
    formula = {"flash_fwd": 4 * (steps + evals), "flash_dq": 4 * steps,
               "flash_dkv": 4 * steps, "conv_dw": 0}
    say(f"observability: (d) flagged against plain (wall {plain[0]:.1f} "
        f"s): log lines equal {lines(log_a) == lines(plain[1])} "
        f"({len(lines(log_a))}), epoch-2 rolling file byte-identical "
        f"{same_bytes}; launches {launches} over {steps} steps and "
        f"{evals} eval batches (formula {formula}), tensor-core {tc}")
    if not (same_bytes and lines(log_a) == lines(plain[1]) and lines(log_a)
            and launches == formula and tc == launches):
        fail("observability: the flagged run differs from the plain one "
             "or its launches from the formula")
    names = trace_kernels(os.path.join(rsl_a, "trace", "rank0.trace.json"))
    with open(os.path.join(rsl_a, "roofline.json")) as f:
        roof = json.load(f)
    rows = {r["opcode"]: r for r in roof["ops"]
            if r.get("opcode") in PORT_KERNEL_NAMES}
    for name in PORT_KERNEL_NAMES:
        r = rows.get(name)
        if r is not None:
            say(f"observability: (e) roofline {name}: {r['name']} "
                f"{r['count']}x, {r['time_us'] / r['count']:.2f} us a "
                f"launch, {r['flops']:.4g} FLOPs, {r['bytes']:.4g} bytes, "
                f"AI {r['arithmetic_intensity']:.1f} against the ridge "
                f"{r['ridge_flops_per_byte']:.1f} ({r['ridge_source']}): "
                f"{r['bound']}-bound, utilization "
                + ("-" if r["utilization"] is None
                   else f"{100 * r['utilization']:.2f}%"))
    mfu, attrs = ga.get("throughput/mfu", (None, {}))
    say(f"observability: (e) trace: {len(names)} device kernels; roofline "
        f"{roof['n_ops']} ops, coverage {100 * roof['coverage']:.1f}%, "
        f"device {roof['device_kind']}, warnings {roof['warnings']}; "
        f"throughput/mfu {mfu} ({attrs})")
    if not names or set(rows) != set(PORT_KERNEL_NAMES) or any(
            r["flops"] is None or r["bytes"] is None
            or r["class_source"] != "analytic" for r in rows.values()):
        fail(f"observability: the trace or roofline.json lacks the port's "
             f"kernels: {len(names)} kernels, rows {sorted(rows)}")
    if mfu is None or attrs.get("peak_dtype") != "bf16":
        fail(f"observability: throughput/mfu is {mfu} ({attrs})")
    runs = [subprocess.Popen(
        [sys.executable, "-m", "distributedpytorch_tpu_torch", action,
         "--rsl_path", rsl_a], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for action in ("telemetry", "goodput", "timeline", "roofline")]
    outs = [(p.args[3], p.communicate(timeout=300)[0], p.returncode)
            for p in runs]
    for action, out, rc in outs:
        say(f"observability: (e) {action} exited {rc}; "
            f"{out.strip().splitlines()[:1]}")
    if any(rc != 0 for *_, rc in outs):
        fail("observability: an offline subcommand failed")
    gp = [line for line in next(o for a, o, _ in outs
                                if a == "goodput").splitlines()
          if "%" in line]
    say("observability: (e) goodput of (a): " + " | ".join(
        line.strip() for line in gp[:8]))


def obs_configure(mode: str, rsl: str) -> None:
    """The process's telemetry, flight recorder (and anomaly detector),
    goodput ledger and exporter as ``train`` sets them: ``defaults``
    (the recorder only), ``no-flightrec`` (nothing) or ``all`` (every
    one of them)."""
    from distributedpytorch_tpu_torch import flightrec, goodput, telemetry

    everything = mode == "all"
    os.makedirs(rsl, exist_ok=True)
    telemetry.configure(rsl, everything, rank=0)
    rec = flightrec.configure(rsl, mode != "no-flightrec", rank=0)
    if everything:
        flightrec.attach_detector(
            rec, trace_dir=os.path.join(rsl, "anomaly_traces"))
    goodput.configure(rsl, everything)
    goodput.stop_exporter()
    if everything:
        goodput.start_exporter(free_port())


OBS_HOOK_CALLS = 20000


def obs_hook_us(mode: str) -> float:
    """Host µs a step of ``cli._run_train_pass``'s per-step hooks alone
    (no step between them), as configured by ``obs_configure(mode)``:
    the clock reads, the ``train_step`` profiler range, the dispatch
    histogram, goodput's charge, the exporter's stamp and the flight
    recorder (with its detector), over OBS_HOOK_CALLS steps."""
    import torch

    from distributedpytorch_tpu_torch import flightrec, goodput, telemetry

    tel, rec, gp = telemetry.get(), flightrec.get(), goodput.get()
    exporter = goodput.exporter()
    instrument = tel.enabled or rec.enabled or gp.enabled
    hist = tel.histogram("step/dispatch_s") if tel.enabled else None
    gp.begin_steps()
    prev = time.perf_counter()
    t_start = prev
    for i in range(OBS_HOOK_CALLS):
        if not instrument:
            continue
        t0 = time.perf_counter()
        with torch.profiler.record_function("train_step"):
            pass
        dispatch_s = time.perf_counter() - t0
        if hist is not None:
            hist.observe(dispatch_s)
        end = time.perf_counter()
        category = gp.step(dispatch_s, t0 - prev)
        if exporter is not None:
            exporter.note_step()
        flightrec.observe_step(rec, epoch=0, step=i, step_s=end - prev,
                               dispatch_s=dispatch_s, wait_s=t0 - prev,
                               category=category)
        prev = end
    gp.end_steps()
    return (time.perf_counter() - t_start) * 1e6 / OBS_HOOK_CALLS


def obs_close() -> None:
    from distributedpytorch_tpu_torch import flightrec, goodput, telemetry

    flightrec.get().close()
    goodput.stop_exporter()
    goodput.get().close()
    telemetry.get().close()


def phase_observability_host() -> dict:
    """Phase 38's in-process parts: (f) an anomaly capture around real vit
    steps, one step slowed on the host to trip the detector, its trace
    holding the flash kernels and its manifest; (g) the instrumentation's
    cost: the vit's eager train pass (phase 35's 320 rows, 5 steps of 64,
    bf16) through ``cli._run_train_pass`` with the defaults (the flight
    recorder on), with ``--no-flightrec`` and with everything on, wall ms
    a step in two rounds (the second reversed), device ms a step under
    torch.profiler; and the MFU of the step at that wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributedpytorch_tpu_torch import cli, flightrec, utils
    from distributedpytorch_tpu_torch.data.datasets import Split
    from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader
    from distributedpytorch_tpu_torch.models import (get_model,
                                                     get_model_input_size)
    from distributedpytorch_tpu_torch.ops import flops as flops_mod
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    ds = work_dataset()
    split = ds.splits["train"]
    train = ResidentLoader(Split(split.images[:OBS_ROWS],
                                 split.labels[:OBS_ROWS]),
                           TRAIN_BATCH, True, SEED, "cuda")
    policy = PRESETS["bf16"]
    model = get_model("vit", ds.nb_classes, policy, attention="flash",
                      device="cuda")
    engine = Engine(model, cross_entropy, ds.mean, ds.std,
                    get_model_input_size("vit"), policy, "cuda",
                    steps_per_epoch=len(train))
    state = engine.init_state(torch.Generator().manual_seed(SEED))
    cli._run_train_pass(engine, state, train, 0, SEED)     # warm

    # (f) the anomaly capture
    root = os.path.join(WORK, "obs_anomaly")
    rec = flightrec.FlightRecorder(enabled=True, rsl_path=root)
    det = flightrec.attach_detector(
        rec, trace_dir=os.path.join(root, "anomaly_traces"), window=8,
        capture_steps=3, max_captures=1)
    batches = list(train.epoch(1))
    slow_step = 10
    for i in range(slow_step + 4):
        t0 = time.perf_counter()
        engine.train_step(state, *batches[i % len(batches)],
                          utils.step_generator(SEED, 1, i, "cuda"))
        torch.cuda.synchronize()
        if i == slow_step:
            time.sleep(0.3)             # the straggler
        flightrec.observe_step(rec, epoch=1, step=i,
                               step_s=time.perf_counter() - t0)
    rec.close()
    capture = os.path.join(root, "anomaly_traces", "capture-0")
    with open(os.path.join(capture, "manifest.json")) as f:
        manifest = json.load(f)
    names = trace_kernels(os.path.join(capture, "rank0.trace.json"))
    port = {k: sum(1 for n in names if k + "_" in n)
            for k in PORT_KERNEL_NAMES}
    say(f"observability: (f) anomaly at step {manifest['step']} "
        f"({manifest['trigger']['trigger']}, step "
        f"{manifest['trigger']['step_s'] * 1e3:.1f} ms against the median "
        f"{manifest['trigger']['median_s'] * 1e3:.1f}); the capture of "
        f"{manifest['capture_steps']} steps holds {len(names)} device "
        f"kernels, the port's {port}; {det.anomalies} anomalies, "
        f"{det.captures_started} capture")
    if det.captures_started != 1 or not all(port.values()):
        fail("observability: the anomaly capture holds no device kernels "
             "of the port")

    # (g) the instrumentation's host cost
    modes = ("defaults", "no-flightrec", "all")
    walls = {m: [] for m in modes}
    epoch = itertools.count(2)
    for mode in modes + modes[::-1]:
        rsl = os.path.join(WORK, f"obs_host_{mode}")
        obs_configure(mode, rsl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli._run_train_pass(engine, state, train, next(epoch), SEED)
        torch.cuda.synchronize()
        walls[mode].append((time.perf_counter() - t0) * 1e3 / len(train))
        obs_close()
    dev = {}
    for mode in modes:
        obs_configure(mode, os.path.join(WORK, f"obs_host_{mode}"))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cli._run_train_pass(engine, state, train, next(epoch), SEED)
            torch.cuda.synchronize()
        obs_close()
        dev[mode] = sum(e.self_device_time_total
                        for e in device_kernels(prof)) / 1e3 / len(train)
    kind = torch.cuda.get_device_name(0)
    fps = flops_mod.train_flops_per_sample("vit", ds.nb_classes)
    peak = flops_mod.peak_flops(kind, "bf16")
    for mode in modes:
        wall = sum(walls[mode]) / len(walls[mode])
        say(f"observability: (g) vit flash eager train pass, {mode}: "
            f"wall {wall:.3f} ms a step (rounds "
            f"{', '.join(f'{w:.3f}' for w in walls[mode])}), device "
            f"{dev[mode]:.5f} ms a step; MFU at that wall "
            f"{100 * TRAIN_BATCH / (wall / 1e3) * fps / peak:.4f}% of "
            f"{kind}'s bf16 peak ({fps:,.0f} FLOPs a sample)")
    base = sum(walls["no-flightrec"]) / OBS_ROUNDS
    hooks = {}
    for mode in modes:
        obs_configure(mode, os.path.join(WORK, f"obs_hooks_{mode}"))
        hooks[mode] = obs_hook_us(mode)
        obs_close()
    say(f"observability: (g) added wall a step against --no-flightrec: "
        f"defaults {sum(walls['defaults']) / OBS_ROUNDS - base:+.3f} ms, "
        f"all {sum(walls['all']) / OBS_ROUNDS - base:+.3f} ms; the "
        f"per-step hooks alone ({OBS_HOOK_CALLS} steps, no step between): "
        + ", ".join(f"{m} {us:.2f} us" for m, us in hooks.items()))
    graphed_roofline(ds, train)
    del model, engine, state
    torch.cuda.empty_cache()
    return walls


def graphed_roofline(ds, train) -> None:
    """(h) Whether Kineto records the kernels of a replayed CUDA Graph:
    the vit (flash, bf16) as graphed chunks of two epochs (the kernels'
    costs recorded while the first chunk's eager warm-up and capture
    call the wrappers), the second chunk (replays only) traced and read
    by the roofline, which must either cost K1, K2 and K3 from the trace
    or say in its warnings that the graphs' kernels are missing."""
    import torch

    from distributedpytorch_tpu_torch import costs, flightrec, roofline
    from distributedpytorch_tpu_torch.data.datasets import Split
    from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader
    from distributedpytorch_tpu_torch.models import (get_model,
                                                     get_model_input_size)
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.dispatch import ChunkRunner
    from distributedpytorch_tpu_torch.train.engine import Engine

    valid = ResidentLoader(Split(ds.splits["valid"].images[:TRAIN_BATCH],
                                 ds.splits["valid"].labels[:TRAIN_BATCH]),
                           TRAIN_BATCH, False, SEED, "cuda")
    policy = PRESETS["bf16"]
    model = get_model("vit", ds.nb_classes, policy, attention="flash",
                      device="cuda")
    engine = Engine(model, cross_entropy, ds.mean, ds.std,
                    get_model_input_size("vit"), policy, "cuda",
                    steps_per_epoch=len(train))
    state = engine.init_state(torch.Generator().manual_seed(SEED))
    runner = ChunkRunner(engine, state, train, valid, SEED, 2)
    kind = torch.cuda.get_device_name(0)
    costs.reset(kind)
    with costs.recording_kernels():
        runner.run([0, 1])
    torch.cuda.synchronize()
    trace_dir = os.path.join(WORK, "obs_graph_trace")
    prof = flightrec.start_profiler()
    try:
        runner.run([2, 3])
    finally:
        flightrec.stop_profiler(prof, trace_dir)
    rep = roofline.analyze(trace_dir, costs_data={
        "device_kind": kind, "programs": costs.registry()})
    rows = {r["opcode"]: r for r in rep["ops"]
            if r.get("opcode") in PORT_KERNEL_NAMES}
    say(f"observability: (h) a graphed chunk of 2 epochs ({2 * len(train)} "
        f"replayed steps) traced: {rep['n_events']} events, "
        f"{sum(r['count'] for r in rep['ops'])} device ops; the port's "
        f"kernels " + ", ".join(f"{n} {r['count']}x "
                                f"{r['time_us'] / r['count']:.2f} us "
                                f"{r['bound']}" for n, r in rows.items())
        + f"; warnings {rep['warnings']}")
    recorded = set(rows) == set(PORT_KERNEL_NAMES)
    said = any("Graph" in w for w in rep["warnings"])
    if not (recorded or said):
        fail("observability: the graphed trace neither holds the port's "
             "kernels nor says that the graphs' kernels are missing")
    costs.reset()
    del model, engine, state, runner
    torch.cuda.empty_cache()


# -- phase 39: fault plans, the health agreement and elastic worlds ---------

ELASTIC_CHILD = os.path.join(ROOT, "tests", "_torch_elastic_child.py")
# (a): the chaos plan's DSL twin at the vit's epoch-0 saves (hit 1 is the
# rolling file, hit 2 the best one)
FAULT_PLAN = "data.read:ioerror:0:2;ckpt.save:preempt:1;ckpt.finalize:torn:1"
ELASTIC_BATCH = 16
ELASTIC_EPOCHS = 8
# (b)-(c): world 3, -b 16, --debug: ceil(200 / 3 / 16) = 5 steps a split,
# so epoch 0 is host-batch hits 1-10 and hit 13 is train step 3 of epoch
# 1; rank 0 sleeps 0.3 s a host batch from epoch 1 on (numbers untouched)
# so that the joiner's claim lands while the world still trains
ELASTIC_PLAN = {"faults": [
    {"site": "data.host_batch", "kind": "rank_loss", "after_n": 12,
     "count": 1, "rank": 2},
    {"site": "data.host_batch", "kind": "stall", "after_n": 10,
     "count": 100000, "stall_s": 0.3, "rank": 0}]}
HEALTH_TIMEOUT_S = 3.0
STALL_S = 8.0                   # (d): rank 0's stall at its first save
TOL_ELASTIC = 1e-5
ELASTIC_WAIT_S = 420.0
ELASTIC_PROCS = []              # phases 39's and 40's processes, stopped
                                # at the end


def elastic_args(rsl: str, epochs: int) -> list:
    return ["train", "--model", "vit", "--attention", "flash", "--debug",
            "-e", str(epochs), "-b", str(ELASTIC_BATCH), "--keep-ckpts",
            str(epochs), "--telemetry", "--data-mode", "stream", "-d",
            os.path.join(WORK, "data"), "--rsl_path", rsl,
            "--synthetic-fallback", "--device", "cuda"]


def start_ranks(tag: str, args: list, world: int) -> list:
    """``world`` processes of ``tests/_torch_elastic_child.py -- ARGS``
    on the card, the env:// variables set by hand (several ranks: gloo
    over CUDA tensors); ``world`` 0 starts one ``--elastic-join``
    process with none of them.  Returns [(rank, Popen, log)]."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "LOCAL_WORLD_SIZE")}
    port = free_port()
    procs = []
    for rank in range(max(world, 1)):
        extra = {} if world == 0 else dict(
            WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
            LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
            MASTER_PORT=str(port))
        who = rank if world else "join"
        log = os.path.join(WORK, f"{tag}-{who}.log")
        with open(log, "w") as f:
            procs.append((who, subprocess.Popen(
                [sys.executable, ELASTIC_CHILD, "--settle", "5", "--",
                 *args], cwd=ROOT, env={**env, **extra}, stdout=f,
                stderr=subprocess.STDOUT), log))
    ELASTIC_PROCS.extend(p for _, p, _ in procs)
    say(f"run: {tag}: {max(world, 1)} process(es) of "
        f"{os.path.relpath(ELASTIC_CHILD, ROOT)} -- {' '.join(args[:12])}")
    return procs


def wait_ranks(procs: list, want: dict, deadline: float) -> None:
    """Waits for every process (killed past ``deadline``); fails unless
    each exited with ``want``'s code (0 where it names none)."""
    try:
        for who, proc, log in procs:
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = None
            if rc != want.get(who, 0):
                with open(log) as f:
                    fail(f"{os.path.basename(log)} exited with {rc}, not "
                         f"{want.get(who, 0)}:\n{f.read()[-3000:]}")
    finally:
        for _, proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def rank_events(rsl: str, rank, name: str) -> list:
    """The ``name`` events of RSL/telemetry/rank<rank>.jsonl (a line
    being written skipped)."""
    path = os.path.join(rsl, "telemetry", f"rank{rank}.jsonl")
    out = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    e = json.loads(line)
                except ValueError:
                    continue
                if e.get("name") == name:
                    out.append(e)
    return out


def params_err(path_a: str, path_b: str) -> float:
    """The largest absolute difference of two checkpoints' parameters."""
    import torch

    a, b = (torch.load(p, map_location="cpu", weights_only=True)["state"]
            ["params"] for p in (path_a, path_b))
    if a.keys() != b.keys():
        return math.inf
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in a)


def check_world_launches(tag: str, rsl: str, ranks, generation: int) -> int:
    """Every rank of ``ranks`` launched K1-K3 in ``generation``'s world,
    all on the tensor cores, by phase 6's formula (a train step DEPTH of
    each, an eval batch DEPTH of K1); returns the train steps of rank
    0's."""
    steps0 = None
    for rank in ranks:
        ev = [e["attrs"] for e in rank_events(rsl, rank, "kernel_launches")
              if e["attrs"]["generation"] == generation]
        if len(ev) != 1:
            fail(f"{tag}: rank {rank} recorded {len(ev)} worlds of "
                 f"generation {generation}")
        got, tc, steps = ev[0]["launches"], ev[0]["tensor_core"], \
            ev[0]["steps"]
        say(f"{tag}: rank {rank}, generation {generation}: {steps} train "
            f"steps, launches flash_fwd {got['flash_fwd']}, flash_dq "
            f"{got['flash_dq']}, flash_dkv {got['flash_dkv']}; tensor-core "
            f"{tc['flash_fwd']}, {tc['flash_dq']}, {tc['flash_dkv']}")
        flash = ("flash_fwd", "flash_dq", "flash_dkv")
        if steps <= 0 or any(got[k] <= 0 or tc[k] != got[k] for k in flash) \
                or got["flash_dq"] != DEPTH * steps \
                or got["flash_dkv"] != DEPTH * steps \
                or got["flash_fwd"] < DEPTH * steps \
                or (got["flash_fwd"] - DEPTH * steps) % DEPTH:
            fail(f"{tag}: rank {rank} did not run K1-K3 on the tensor "
                 f"cores in generation {generation}'s world")
        steps0 = steps if steps0 is None else steps0
    return steps0


def goodput_categories(rsl: str, rank: int) -> dict:
    name = "goodput.json" if rank == 0 else f"goodput-rank{rank}.json"
    with open(os.path.join(rsl, name)) as f:
        return json.load(f)["categories"]


def phase_elastic(card: str) -> None:
    """Phase 39 (a)-(d); runs beside the other CLI phases."""
    from distributedpytorch_tpu_torch import checkpoint as tckpt

    deadline = time.monotonic() + ELASTIC_WAIT_S
    base = ["train", "--model", "vit", "--attention", "flash", "--debug",
            "-e", "2", "--keep-ckpts", "2", "--telemetry"]
    rsl_a, rsl_a0 = (os.path.join(WORK, n) for n in ("faults", "faults_ref"))
    rsl_e, rsl_d = (os.path.join(WORK, n) for n in ("elastic", "stall"))
    plan = os.path.join(WORK, "elastic_plan.json")
    with open(plan, "w") as f:
        json.dump(ELASTIC_PLAN, f)
    runs_a = [start_cli(base + ["--fault-plan", FAULT_PLAN], rsl_a),
              start_cli(base, rsl_a0)]
    ELASTIC_PROCS.extend(run[3] for run in runs_a)
    world_d = start_ranks("stall", elastic_args(rsl_d, 2) + [
        "--health-timeout", str(HEALTH_TIMEOUT_S), "--fault-plan",
        f"ckpt.save:stall:0:1:{STALL_S}"], 2)
    elastic = elastic_args(rsl_e, ELASTIC_EPOCHS) + [
        "--elastic", "--health-timeout", "60"]
    world_e = start_ranks("elastic", elastic + ["--fault-plan", plan], 3)
    try:
        # (c)'s joiner starts once the world has shrunk: a claim seen
        # while rank 2 lives would grow the world to 4
        t_loss = time.monotonic()
        while not rank_events(rsl_e, 0, "elastic/reconfigure"):
            if time.monotonic() > deadline or world_e[0][1].poll() is not None:
                wait_ranks(world_e, {2: 113}, deadline)
                fail("elastic: rank 0 never reconfigured")
            time.sleep(0.5)
        say(f"elastic: the world shrank {time.monotonic() - t_loss:.1f}s "
            f"after its start; starting the joiner")
        world_e += start_ranks("elastic", elastic + [
            "--elastic-join", "--elastic-join-wait", "300"], 0)
        # (a): the faulted run and the fault-free one, then the resume
        (_, log_a), _ = finish_all(runs_a)
        best = tckpt.best_model_path(rsl_a, "mnist", "vit")
        torn = tckpt.verify_checkpoint(best)
        say(f"faults: {log_a.count('transient failure')} retried reads, "
            f"preempted after epoch 1: {'preempted after epoch 1' in log_a}"
            f"; the best file torn: {torn}")
        if log_a.count("transient failure") != 2 or torn is None \
                or "preempted after epoch 1" not in log_a:
            fail("faults: the plan did not retry, preempt and tear")
        resume = start_cli(base + ["-f", best], rsl_a)
        ELASTIC_PROCS.append(resume[3])
        _, log_r = finish_all([resume])[0]
        last = "checkpoint-mnist-vit-001.ckpt"
        n, differ = state_tensors_differ(os.path.join(rsl_a, last),
                                         os.path.join(rsl_a0, last))
        launches, steps, _ = parse_launches(log_r, "train")
        tc = parse_tensor_core_launches(log_r, "train")
        rejected = "CHECKPOINT REJECTED" in log_r
        say(f"faults: resumed past the torn head ({rejected}), {steps} "
            f"steps, launches {launches}, tensor-core {tc}; final file vs "
            f"the fault-free run's: {n} tensors and counts, {len(differ)} "
            f"differ")
        if not rejected or differ or not n \
                or launches["flash_dq"] != DEPTH * steps \
                or tc["flash_fwd"] != launches["flash_fwd"]:
            fail(f"faults: the resume does not reproduce the fault-free run "
                 f"{differ[:5]}")
        # (d): the stalled rank's peer has the verdict within the bound
        wait_ranks(world_d, {0: 1, 1: 1}, deadline)
        [late] = rank_events(rsl_d, 1, "health_timeout")
        before = [e for e in rank_events(rsl_d, 1, "peer_loss")]
        with open(os.path.join(rsl_d, "telemetry", "rank1.jsonl")) as f:
            stamps = [json.loads(line) for line in f]
        prev = max(e["ts"] for e in stamps if e["ts"] < late["ts"]
                   and e.get("name") != "health_timeout")
        waited = late["ts"] - prev
        say(f"health: rank 0 stalled {STALL_S:g}s in its save; rank 1 had "
            f"HealthTimeoutError {waited:.2f}s after its last event "
            f"(--health-timeout {HEALTH_TIMEOUT_S:g}), peer_loss "
            f"{len(before)}; both exited 1")
        if not HEALTH_TIMEOUT_S - 0.2 <= waited <= HEALTH_TIMEOUT_S + 2.0 \
                or not before:
            fail("health: the verdict did not come within the bound")
        # (b), (c): shrink to 2, grow back to 3
        wait_ranks(world_e, {2: 113}, deadline)
    finally:
        for _, proc, _ in world_e + world_d:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank in (0, 1):
        worlds = [e["attrs"]["new_world"] for e in rank_events(
            rsl_e, rank, "elastic/reconfigure")]
        if worlds != [2, 3]:
            fail(f"elastic: rank {rank} reconfigured to {worlds}, not "
                 f"[2, 3]")
    [join] = rank_events(rsl_e, 2, "elastic/join")
    if (join["attrs"]["new_rank"], join["attrs"]["new_world"]) != (2, 3):
        fail(f"elastic: the joiner entered as {join['attrs']}")
    resumes = [e["attrs"]["epoch"] for e in rank_events(
        rsl_e, 0, "elastic/resume")]
    if len(resumes) != 2 or resumes[0] != 1 or resumes[1] < 2 \
            or resumes[1] >= ELASTIC_EPOCHS:
        fail(f"elastic: resume epochs {resumes}")
    grow_at = resumes[1]
    check_world_launches("elastic", rsl_e, (0, 1), 1)
    check_world_launches("elastic", rsl_e, (0, 1, 2), 2)
    # the references: 2 ranks from the epoch-0 snapshot to the grow's,
    # 3 ranks from there to the end, both at once
    refs = {}
    for world, first, epochs in ((2, 0, grow_at),
                                 (3, grow_at - 1, ELASTIC_EPOCHS)):
        rsl = os.path.join(WORK, f"elastic_ref{world}")
        os.makedirs(rsl)
        name = f"checkpoint-mnist-vit-{first:03d}.ckpt"
        shutil.copy(os.path.join(rsl_e, name), os.path.join(rsl, name))
        refs[world] = (rsl, epochs, start_ranks(
            f"elastic_ref{world}", elastic_args(rsl, epochs)
            + ["-f", os.path.join(rsl, name)], world))
    deadline = time.monotonic() + ELASTIC_WAIT_S
    for rsl, epochs, procs in refs.values():
        wait_ranks(procs, {}, deadline)
    errs = {}
    for world, (rsl, epochs, _) in refs.items():
        name = f"checkpoint-mnist-vit-{epochs - 1:03d}.ckpt"
        errs[world] = params_err(os.path.join(rsl_e, name),
                                 os.path.join(rsl, name))
    gp = [goodput_categories(rsl_e, r) for r in (0, 1)]
    say(f"elastic: 3 ranks on one card (gloo), rank 2 lost at epoch 1 "
        f"(exit 113): ranks 0 and 1 shrank to 2 and resumed at epoch 1, a "
        f"joiner grew the world to 3 at epoch {grow_at}; the 2-rank world's "
        f"epoch-{grow_at} parameters vs an uninterrupted 2-rank run from "
        f"the same snapshot: max abs err {errs[2]:.3g}; the final ones vs "
        f"a 3-rank run from the grow's snapshot: {errs[3]:.3g} (tol "
        f"{TOL_ELASTIC:g}); goodput collective_skew "
        f"{gp[0]['collective_skew']:.3f}s / {gp[1]['collective_skew']:.3f}s,"
        f" elastic_reconfigure {gp[0]['elastic_reconfigure']:.3f}s / "
        f"{gp[1]['elastic_reconfigure']:.3f}s (ranks 0 / 1) on {card}")
    if not all(e <= TOL_ELASTIC for e in errs.values()):
        fail("elastic: the reconfigured worlds do not match their "
             "uninterrupted references")


def start_elastic_phase(card: str) -> dict:
    """Phase 39 on a thread of its own, beside the other CLI phases: its
    failure (``fail``'s exit) is kept for ``finish_elastic_phase``."""
    pending = {}

    def body():
        try:
            phase_elastic(card)
            pending["ok"] = True
        except BaseException as e:       # fail()'s SystemExit included
            pending["error"] = e

    t0 = time.perf_counter()
    pending["thread"] = threading.Thread(target=body, name="phase39",
                                         daemon=True)
    pending["thread"].start()
    pending["t0"] = t0
    return pending


def finish_elastic_phase(pending: dict) -> None:
    pending["thread"].join(ELASTIC_WAIT_S * 2)
    wall = time.perf_counter() - pending["t0"]
    say(f"chip_smoke: phase_elastic ran {wall:.1f}s beside the other "
        f"phases")
    if not pending.get("ok"):
        fail(f"phase 39 did not pass: {pending.get('error')!r}")


# -- phase 40: serve as an elastic world of replicas, and the fleet ---------

SERVE_WAVE = 64                 # one full bucket: one batch a wave
# every wave of this phase is a full bucket, which dispatches at once; a
# partial one would wait out this deadline, so a wave is one batch and the
# fault plan's serve.infer hits (batches) are known in advance
SERVE_FLUSH_MS = 5000
SERVE_WAVES_A = 2               # (a): waves a replica
SERVE_BURST = 2                 # (c): replica 1's failed waves
# replica 1's serve.infer hits: (a)'s waves, then the burst, then the loss
SERVE_PLAN = {"faults": [
    {"site": "serve.infer", "kind": "ioerror", "after_n": SERVE_WAVES_A,
     "count": SERVE_BURST, "rank": 1},
    {"site": "serve.infer", "kind": "rank_loss",
     "after_n": SERVE_WAVES_A + SERVE_BURST, "count": 1, "rank": 1}]}
SERVE_SLO = {"slos": [{
    "name": "serve-errors", "kind": "ratio",
    "bad": "dpt_serve_failed_total", "total": "dpt_serve_requests_total",
    "target": 0.9,
    "windows": [{"seconds": 2.0, "burn": 2.0},
                {"seconds": 8.0, "burn": 1.0}]}]}
SERVE_WAIT_S = 300.0


def free_ports(n: int) -> int:
    """The first of ``n`` consecutive free ports (a replica's port is the
    base plus its rank)."""
    for _ in range(50):
        base = free_port()
        try:
            for p in range(base, base + n):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
    fail("no run of free ports")


def http_json(port: int, path: str, doc=None, timeout: float = 30.0):
    """GET (``doc`` None) or POST ``doc``; (status, parsed body, the
    X-DPT-Request-Id header)."""
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body = r.read().decode()
            return (r.status, body if path == "/metrics" else
                    json.loads(body), r.headers.get("X-DPT-Request-Id"))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get(
            "X-DPT-Request-Id")


def raw_request(port: int, request: bytes) -> tuple:
    """One HTTP exchange on a socket of its own, the request sent with one
    ``sendall``: (status, parsed body, X-DPT-Request-Id)."""
    with socket.create_connection(("127.0.0.1", port), timeout=120) as sk:
        sk.sendall(request)
        data = b""
        while True:
            chunk = sk.recv(65536)
            if not chunk:
                break
            data += chunk
    head, _, payload = data.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    rid = next((line.split(":", 1)[1].strip() for line in lines[1:]
                if line.lower().startswith("x-dpt-request-id:")), None)
    return int(lines[0].split()[1]), json.loads(payload), rid


def serve_wave(port: int, images, raw: bool = False) -> dict:
    """One wave of ``len(images)`` concurrent requests released by a
    barrier: each request's status, body, id, monotonic send time, the
    X-DPT-Upstream header (a front door's; None from a replica) and
    monotonic answer time, and the wave's start (the first send).  A
    request whose connection dies has status None.  ``raw``: each client
    connects and sends its pre-built request with one ``sendall`` (the
    least client work), else through urllib."""
    n = len(images)
    bodies = [json.dumps({"image": img.tolist()}).encode() for img in images]
    requests = [(f"POST /predict HTTP/1.1\r\nHost: localhost\r\n"
                 f"Content-Length: {len(b)}\r\nConnection: close\r\n\r\n"
                 ).encode() + b for b in bodies]
    barrier = threading.Barrier(n)
    out = [None] * n

    def client(i):
        barrier.wait(timeout=120)
        sent = time.monotonic()
        try:
            if raw:
                out[i] = raw_request(port, requests[i]) + (
                    sent, None, time.monotonic())
                return
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict", data=bodies[i])
            with urllib.request.urlopen(req, timeout=120) as r:
                out[i] = (r.status, json.loads(r.read()),
                          r.headers.get("X-DPT-Request-Id"), sent,
                          r.headers.get("X-DPT-Upstream"), time.monotonic())
        except urllib.error.HTTPError as e:
            out[i] = (e.code, json.loads(e.read()),
                      e.headers.get("X-DPT-Request-Id"), sent,
                      e.headers.get("X-DPT-Upstream"), time.monotonic())
        except OSError as e:
            out[i] = (None, {"error": repr(e)}, None, sent, None,
                      time.monotonic())

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if any(th.is_alive() for th in threads):
        fail(f"serve world: a wave to :{port} did not complete")
    return {"answers": out, "start": min(o[3] for o in out)}


def serve_gauges(mport: int) -> dict:
    """A replica's telemetry gauges and counters, from its exporter's
    /metrics (the port's fleet parser)."""
    from distributedpytorch_tpu_torch import fleet

    _, text, _ = http_json(mport, "/metrics")
    parsed = fleet.parse_metrics(text)
    return {**parsed["counters"], **parsed["gauges"]}


def wait_for(what: str, fn, timeout_s: float = SERVE_WAIT_S):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            got = fn()
        except (OSError, ValueError, TypeError, KeyError):
            got = None
        if got:
            return got
        time.sleep(0.25)
    fail(f"serve world: {what} within {timeout_s:g}s")


def phase_serve_world(card: str) -> dict:
    """Phase 40 (a)-(d) on a thread of its own; returns what the closing
    check (``finish_serve_world_phase``) holds against the in-process
    predict step, which must not launch K1 while other phases count."""
    from distributedpytorch_tpu_torch import tracing

    rsl = os.path.join(WORK, "serve_world")
    os.makedirs(rsl)
    ckpt_a = os.path.join(WORK, "serve_a", "bestmodel-mnist-vit.ckpt")
    ckpt_b = os.path.join(WORK, "serve_b", "bestmodel-mnist-vit.ckpt")
    build_checkpoint(ckpt_a)
    build_checkpoint(ckpt_b, seed=SEED + 1)
    plan, spec = (os.path.join(WORK, n) for n in ("serve_plan.json",
                                                  "serve_slo.json"))
    with open(plan, "w") as f:
        json.dump(SERVE_PLAN, f)
    with open(spec, "w") as f:
        json.dump(SERVE_SLO, f)
    port, mport, fport = free_ports(2), free_ports(2), free_port()
    args = ["serve", "-d", os.path.join(WORK, "data"), "--rsl_path", rsl,
            "-f", ckpt_a, "--attention", "flash", "--precision", "bf16",
            "--synthetic-fallback", "--device", "cuda",
            "--serve-buckets", ",".join(str(b) for b in BUCKETS),
            "--serve-max-latency-ms", str(SERVE_FLUSH_MS),
            "--serve-port", str(port), "--metrics-port", str(mport),
            "--elastic", "--health-timeout", "30", "--fault-plan", plan]
    world = start_ranks("serve_world", args, 2)
    logs = [log for _, _, log in world]
    flog = os.path.join(WORK, "serve_fleet.log")
    with open(flog, "w") as f:
        coll = subprocess.Popen(
            [sys.executable, "-m", "distributedpytorch_tpu_torch", "fleet",
             "--rsl_path", rsl, "--metrics-port", str(mport), "--ranks",
             "2", "--fleet-port", str(fport), "--interval", "0.25",
             "--stale-after", "4", "--slo-spec", spec], cwd=ROOT,
            stdout=f, stderr=subprocess.STDOUT)
    ELASTIC_PROCS.append(coll)
    got = {"ckpts": (ckpt_a, ckpt_b), "waves": []}
    t_live = time.monotonic()
    for r in (0, 1):
        wait_for(f"replica {r} live", lambda: http_json(
            port + r, "/livez")[1]["ok"])
    wait_for("the collector seeing both replicas", lambda: http_json(
        fport, "/fleet")[1]["alive"] == [0, 1])
    say(f"serve world: 2 replicas (gloo, one card) and the collector live "
        f"{time.monotonic() - t_live:.1f}s after their start")
    ds = work_dataset()
    images = got["images"] = ds.splits["test"].images
    row = 0

    rows_lock = threading.Lock()

    def wave(r, ckpt, phase, raw=False):
        nonlocal row
        with rows_lock:  # waves are sent from threads of their own
            rows = list(range(row, row + SERVE_WAVE))
            row += SERVE_WAVE
        out = serve_wave(port + r, images[rows], raw)
        got["waves"].append({"replica": r, "ckpt": ckpt, "phase": phase,
                             "rows": rows, **out})
        return out

    # (a) concurrent waves to both replicas, then K1's launches of each
    for _ in range(SERVE_WAVES_A):
        done = [None, None]
        clients = [threading.Thread(target=lambda r=r: done.__setitem__(
            r, wave(r, ckpt_a, "a"))) for r in (0, 1)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
    bad = [(w["replica"], a[:2]) for w in got["waves"]
           for a in w["answers"] if a[0] != 200]
    if bad:
        fail(f"serve world (a): {len(bad)} requests failed, e.g. {bad[0]}")
    lineage = {}
    for r in (0, 1):
        g = serve_gauges(mport + r)
        launches = g["dpt_kernel_flash_fwd_launches"]
        tc = g["dpt_kernel_flash_fwd_tensor_core_launches"]
        warm = g["dpt_kernel_flash_fwd_warmup_launches"]
        batches = g["dpt_serve_batches_total"]
        want = DEPTH * (batches + len(BUCKETS))
        say(f"serve world (a): replica {r}: K1 launches {launches:g} = "
            f"{DEPTH} x ({batches:g} batches + {len(BUCKETS)} warm-up "
            f"forwards) -> expected {want:g}; {tc:g} on the tensor cores, "
            f"{warm:g} in warm-up (telemetry gauges on /metrics)")
        if batches != SERVE_WAVES_A or launches != want or tc != launches \
                or warm != DEPTH * len(BUCKETS):
            fail(f"serve world (a): replica {r}'s K1 launches do not match "
                 f"its batches on the tensor cores")
        lineage[r] = http_json(port + r, "/livez")[1]["checkpoint"]["sha256"]
    # entry 4's control: a wave whose clients connect and send with the
    # least client work (one sendall each)
    wave(0, ckpt_a, "raw", raw=True)
    if any(a[0] != 200 for a in got["waves"][-1]["answers"]):
        fail("serve world (a): the raw wave failed")
    # (b) the hot-swap to B on replica 0, then a wave of B's answers
    t0 = time.perf_counter()
    status, body, _ = http_json(port, "/admin/reload",
                                {"checkpoint": ckpt_b}, timeout=180)
    reload_s = time.perf_counter() - t0
    if status != 200 or not body.get("reloaded"):
        fail(f"serve world (b): /admin/reload answered {status}: {body}")
    live = http_json(port, "/livez")[1]["checkpoint"]["sha256"]
    health = http_json(mport, "/healthz")[1]["serve"]["checkpoint"]["sha256"]
    warm_s = serve_gauges(mport)["dpt_compile_warmup_s"]
    say(f"serve world (b): replica 0 hot-swapped A -> B in {reload_s:.3f}s "
        f"(the swap's warm-up {warm_s:.3f}s); lineage sha "
        f"{lineage[0][:12]} -> {live[:12]} on /livez, {health[:12]} on "
        f"/healthz")
    if live == lineage[0] or health != live \
            or live != body["checkpoint"]["sha256"]:
        fail("serve world (b): the lineage did not follow the swap")
    got["swap"] = (reload_s, warm_s)
    wave(0, ckpt_b, "b")
    # (c) a clean control window wrote nothing; the burst writes one bundle
    from distributedpytorch_tpu_torch import slo

    time.sleep(1.0)
    if slo.load_incidents(rsl):
        fail("serve world (c): an incident on clean traffic")
    # the burst's waves go together, so its batches fail back to back and
    # the 2 s window sees one episode however slow the clients are
    burst = [None] * SERVE_BURST
    clients = [threading.Thread(target=lambda i=i: burst.__setitem__(
        i, wave(1, ckpt_a, "burst"))) for i in range(SERVE_BURST)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=600)
    codes = {a[0] for w in burst for a in (w or {"answers": [(None,)]})[
        "answers"]}
    if codes != {500}:
        fail(f"serve world (c): the burst answered {codes}")
    bundles = wait_for("the incident bundle", lambda: slo.load_incidents(
        rsl), 30)
    time.sleep(2.0)
    bundles = slo.load_incidents(rsl)
    failed = {rec["id"] for rec in tracing.load_records(rsl)
              if rec["outcome"] == "failed"}
    offenders = set(bundles[0]["offending_requests"]) if bundles else set()
    # the bundle names the failed requests inside its triggering window:
    # all of the burst's when the collector evaluates after the last
    # batch, the first batch's when it fires between the two (a failed
    # batch's records land before its failures are counted)
    say(f"serve world (c): {len(bundles)} incident bundle(s) for a burst of "
        f"{SERVE_BURST * SERVE_WAVE} failed requests on replica 1: slo "
        f"{bundles[0]['slo']}, suspect ranks {bundles[0]['suspect_ranks']}, "
        f"{len(offenders)} offending request ids "
        f"({len(offenders & failed)} of them failed ones)")
    if len(bundles) != 1 or bundles[0]["suspect_ranks"] != [1] \
            or len(offenders) < SERVE_WAVE or not offenders <= failed \
            or not all(o.startswith("r1-") for o in offenders):
        fail("serve world (c): not exactly one bundle naming rank 1 and its "
             "failed requests")
    # (d) the rank loss on replica 1; replica 0 reconfigures and serves B
    t_loss = time.monotonic()
    w = serve_wave(port + 1, images[:SERVE_WAVE])
    if any(a[0] is not None for a in w["answers"]):
        fail("serve world (d): a request to the lost replica was answered")
    try:
        rc1 = world[1][1].wait(timeout=60)
    except subprocess.TimeoutExpired:
        rc1 = None
    rec = wait_for("replica 0's reconfigure", lambda: [
        e["attrs"] for e in rank_events(rsl, 0, "elastic/reconfigure")
        if e["attrs"].get("purpose") == "serve"], 120)
    if rc1 != 113 or [r["new_world"] for r in rec] != [1]:
        fail(f"serve world (d): replica 1 exited {rc1}; replica 0 "
             f"reconfigured to {rec}")
    wait_for("replica 0 rebuilt", lambda: http_json(port, "/livez")[1][
        "checkpoint"]["sha256"] == live and http_json(
        mport, "/healthz")[1]["elastic_generation"] == 1, 120)
    wave(0, ckpt_b, "d")
    if any(a[0] != 200 for a in got["waves"][-1]["answers"]):
        fail("serve world (d): replica 0 did not answer after the "
             "reconfigure")
    fleet_doc = wait_for("rank 1 aging out of the fleet", lambda: (
        lambda d: d if d["alive"] == [0] else None)(
        http_json(fport, "/fleet")[1]), 60)
    _, fleet_text, _ = http_json(fport, "/metrics")
    say(f"serve world (d): replica 1 lost (exit {rc1}); replica 0 "
        f"reconfigured to a world of 1 (purpose serve) and answered on "
        f":{port} {time.monotonic() - t_loss:.1f}s after the loss; the "
        f"fleet's alive ranks {fleet_doc['alive']}, "
        f"{fleet_text.strip().splitlines()[-1]!r}")
    if not fleet_text.endswith("dpt_up 1\n") or "1" in fleet_doc["targets"] \
            or len(slo.load_incidents(rsl)) != 1:
        fail("serve world (d): the fleet did not age rank 1 out cleanly")
    world[0][1].send_signal(signal.SIGTERM)
    try:
        rc0 = world[0][1].wait(timeout=90)
    except subprocess.TimeoutExpired:
        rc0 = None
    coll.terminate()
    coll.wait(timeout=30)
    if rc0 != 0:
        with open(logs[0]) as f:
            fail(f"serve world: replica 0 exited {rc0} on SIGTERM:\n"
                 f"{f.read()[-3000:]}")
    [k1] = [e["attrs"] for e in rank_events(rsl, 0, "kernel_launches")]
    builds = 3                  # A, the swap to B, the rebuild after (d)
    launches, tc = k1["launches"]["flash_fwd"], k1["tensor_core"]["flash_fwd"]
    want = DEPTH * (k1["batches"] + builds * len(BUCKETS))
    reconf = goodput_categories(rsl, 0)["elastic_reconfigure"]
    say(f"serve world: replica 0 over its run: K1 launches {launches} = "
        f"{DEPTH} x ({k1['batches']} batches + {builds} builds x "
        f"{len(BUCKETS)} warm-up forwards) -> expected {want}; {tc} on the "
        f"tensor cores; goodput elastic_reconfigure {reconf:.3f}s; exit 0 "
        f"on SIGTERM")
    if launches != want or tc != launches or k1["batches"] != 5 \
            or k1["warmup"]["flash_fwd"] != DEPTH * builds * len(BUCKETS):
        fail("serve world: replica 0's K1 launches do not match its batches "
             "and builds on the tensor cores")
    with open(os.path.join(rsl, "flightrec-rank0.json")) as f:
        reasons = json.load(f)["reasons"]
    if not {"reconfigure", "run_end"} <= set(reasons):
        fail(f"serve world: replica 0's flight record reasons {reasons}")
    # entry 4: each request's admit() against its wave's start
    admits = {rec["id"]: rec["mono_admit"]
              for rec in tracing.load_records(rsl)}
    for w in got["waves"]:
        offs = sorted(1e3 * (admits[a[2]] - w["start"])
                      for a in w["answers"] if a[2] in admits)
        sends = [1e3 * (a[3] - w["start"]) for a in w["answers"]]
        w["admit_ms"] = (offs[len(offs) // 2], offs[-1], max(sends))
    spreads = ", ".join(f"{w['phase']}/r{w['replica']} "
                        f"{w['admit_ms'][0]:.1f}/{w['admit_ms'][1]:.1f}/"
                        f"{w['admit_ms'][2]:.1f}" for w in got["waves"])
    say(f"serve world: admit offsets from each wave's first send, p50/max "
        f"ms, and the clients' last send: {spreads} on {card}")
    got["reconfigure_s"] = reconf
    say(f"serve world: (a)-(d) took {time.monotonic() - t_live:.1f}s from "
        f"the replicas' start")
    return got


def check_served_answers(tag: str, got: dict) -> None:
    """Every answer of ``got["waves"]`` (a burst's failures left out) held
    against the in-process predict step of the checkpoint that served it
    at its bucket (label, and confidence to TOL_CONF), A's and B's told
    apart."""
    import numpy as np

    images = got["images"]
    checked = mismatched = 0
    for name, ckpt in zip("AB", got["ckpts"]):
        waves = [w for w in got["waves"] if w["ckpt"] == ckpt
                 and w["phase"] != "burst"]
        rows = [r for w in waves for r in w["rows"]]
        answers = [a for w in waves for a in w["answers"]]
        if not rows:
            continue
        served = np.array([a[1]["bucket"] for a in answers])
        labels, confs, probs = reference_predictions(
            ckpt, images[rows], served, "cuda")
        got_labels = np.array([a[1]["label"] for a in answers])
        got_confs = np.array([a[1]["confidence"] for a in answers])
        top2 = np.sort(probs, axis=-1)[:, -2:]
        tie = (top2[:, 1] - top2[:, 0]) <= TOL_CONF
        err = float(np.abs(got_confs - confs).max())
        bad = int(((got_labels != labels) & ~tie).sum())
        say(f"{tag}: {len(rows)} answers of {name} vs its in-process "
            f"predict step at bucket {sorted(set(served.tolist()))}: "
            f"{int((got_labels == labels).sum())} labels equal "
            f"({int(tie.sum())} within {TOL_CONF:g} of a tie), max conf err "
            f"{err:.3g} (tol {TOL_CONF:g})")
        checked += len(rows)
        mismatched += bad + int(err > TOL_CONF)
    a_ref = reference_predictions(got["ckpts"][0], images[:SERVE_WAVE],
                                  np.full(SERVE_WAVE, SERVE_WAVE), "cuda")
    b_ref = reference_predictions(got["ckpts"][1], images[:SERVE_WAVE],
                                  np.full(SERVE_WAVE, SERVE_WAVE), "cuda")
    differ = int((a_ref[0] != b_ref[0]).sum())
    say(f"{tag}: checkpoints A and B label {differ} of {SERVE_WAVE} "
        f"rows differently")
    if mismatched or not checked or not differ:
        fail(f"{tag}: the served answers disagree with their checkpoints' "
             f"predict steps")


# -- phase 41: the front door over a world of replicas, and the simulator --

FD_WAVE = 2 * SERVE_WAVE        # through the front door: a full bucket a
#                                 replica (least-pending alternates them)
FD_WAVES_A = 2                  # (a): waves through the front door
FD_CANARY_HOLD_S = 2.0          # (b): the canary's soak
FD_LEDGER = ("checkpoint-mnist-vit-000.ckpt", "checkpoint-mnist-vit-001.ckpt")


def record_lineage(dirname: str, names) -> str:
    """The lineage ledger of ``dirname`` naming ``names`` (oldest first)
    at epochs 0, 1, ... with their sha256, in the schema the port's
    ``checkpoint.py`` writes and its ``serving/rollout.py`` reads.
    Returns the newest entry's sha256."""
    records = []
    for epoch, name in enumerate(names):
        with open(os.path.join(dirname, name), "rb") as f:
            blob = f.read()
        records.append({"file": name, "epoch": epoch,
                        "sha256": hashlib.sha256(blob).hexdigest(),
                        "bytes": len(blob)})
    path = os.path.join(dirname, "ckpt-lineage.json")
    with open(path + ".tmp", "w") as f:
        json.dump({"records": records}, f, indent=1)
    os.replace(path + ".tmp", path)
    return records[-1]["sha256"]


def pids_naming(marker: str) -> list:
    """Live processes whose command line holds ``marker`` (the front
    door's joiners are its children, not this script's)."""
    pids = []
    for d in os.listdir("/proc"):
        if not d.isdigit() or int(d) == os.getpid():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().decode(errors="replace").split("\0")
            with open(f"/proc/{d}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if marker in cmd and state != "Z":
            pids.append(int(d))
    return pids


def fd_status(fdp: int) -> dict:
    return http_json(fdp, "/healthz", timeout=10)[1]


def phase_frontdoor(card: str, ckpts: tuple) -> dict:
    """Phase 41 (a)-(d) on phase 40's thread, after it; returns what the
    closing check holds against the in-process predict step."""
    rsl = os.path.join(WORK, "fd_world")
    ledger = os.path.join(WORK, "fd_ledger")
    fd_rsl = os.path.join(WORK, "fd")
    os.makedirs(ledger)
    a_path, b_path = (os.path.join(ledger, n) for n in FD_LEDGER)
    shutil.copy2(ckpts[0], a_path)
    record_lineage(ledger, FD_LEDGER[:1])
    shutil.copy2(ckpts[1], b_path)          # in the ledger from (b) on
    got = {"ckpts": (a_path, b_path), "waves": []}
    t_start = time.monotonic()
    # (d)'s two replays touch no device: they run beside the rest
    sims = []
    for i in range(2):
        out = os.path.join(WORK, f"sim{i}.json")
        with open(out, "w") as f:
            sims.append((out, time.monotonic(), subprocess.Popen(
                [sys.executable, "-m", "distributedpytorch_tpu_torch", "sim",
                 "--scenario", "control", "--rsl_path",
                 os.path.join(WORK, f"sim{i}")], cwd=ROOT, stdout=f,
                stderr=subprocess.DEVNULL)))
    ELASTIC_PROCS.extend(p for *_, p in sims)
    port, mport, fdp = free_ports(2), free_ports(2), free_port()
    serve = ["serve", "-d", os.path.join(WORK, "data"), "--rsl_path", rsl,
             "--attention", "flash", "--precision", "bf16",
             "--synthetic-fallback", "--device", "cuda",
             "--serve-buckets", ",".join(str(b) for b in BUCKETS),
             "--serve-max-latency-ms", str(SERVE_FLUSH_MS),
             "--serve-request-timeout", "120", "--serve-port", str(port),
             "--metrics-port", str(mport), "--elastic", "--health-timeout",
             "30"]
    world = start_ranks("fd_world", serve + ["-f", a_path], 2)
    logs = [log for _, _, log in world]
    join_cmd = [sys.executable, ELASTIC_CHILD, "--settle", "5", "--",
                *serve, "-f", b_path, "--elastic-join"]
    try:
        for r in (0, 1):
            wait_for(f"front door: replica {r} live", lambda: http_json(
                port + r, "/livez")[1]["ok"])
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                            "MASTER_PORT", "LOCAL_WORLD_SIZE")}
        flog = os.path.join(WORK, "frontdoor.log")
        with open(flog, "w") as f:
            fd = subprocess.Popen(
                [sys.executable, "-m", "distributedpytorch_tpu_torch",
                 "frontdoor", "--rsl_path", fd_rsl, "--port", str(fdp),
                 "--ranks", "2", "--serve-port", str(port),
                 "--metrics-port", str(mport), "--interval", "0.25",
                 "--upstream-timeout", "120", "--pending-budget",
                 str(4 * FD_WAVE), "--stale-after", "3", "--rollout",
                 "--watch-dir", ledger, "--canary-hold",
                 str(FD_CANARY_HOLD_S), "--canary-min-requests",
                 str(SERVE_WAVE), "--autoscale", "--min-world", "2",
                 "--max-world", "2", "--queue-high", "1000000",
                 "--queue-low", "0", "--up-hold", "2", "--down-hold",
                 "3600", "--cooldown", "600", "--launch-cmd",
                 shlex.join(join_cmd)],
                cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)
        ELASTIC_PROCS.append(fd)
        logs.append(flog)
        wait_for("the front door probing both replicas", lambda: all(
            fd_status(fdp)["upstreams"][str(r)]["alive"] for r in (0, 1)))
        say(f"front door: 2 replicas (gloo, one card) and the front door "
            f"live {time.monotonic() - t_start:.1f}s after their start")
        images = got["images"] = work_dataset().splits["test"].images
        row = [0]

        def wave(phase, ckpt_of, n=FD_WAVE):
            """``n`` concurrent requests through the front door; the
            answers kept by upstream, with the checkpoint it served."""
            rows = list(range(row[0], row[0] + n))
            row[0] += n
            out = serve_wave(fdp, images[rows])
            bad = [a[:2] for a in out["answers"] if a[0] != 200
                   or not a[2] or a[4] not in ("0", "1")]
            if bad:
                fail(f"front door ({phase}): {len(bad)} of {n} requests "
                     f"not answered 200 with a request id and an "
                     f"upstream, e.g. {bad[0]}")
            for up in ("0", "1"):
                mine = [(r, a) for r, a in zip(rows, out["answers"])
                        if a[4] == up]
                if mine:
                    got["waves"].append({
                        "phase": phase, "replica": int(up),
                        "ckpt": ckpt_of[int(up)],
                        "rows": [r for r, _ in mine],
                        "answers": [a for _, a in mine]})
            return out

        # (a) routing: waves of full buckets through the one port
        for _ in range(FD_WAVES_A):
            out = wave("a", (a_path, a_path))
            ups = {a[4] for a in out["answers"]}
            if ups != {"0", "1"}:
                fail(f"front door (a): a wave answered by {ups} only")
        for r in (0, 1):
            g = serve_gauges(mport + r)
            launches = g["dpt_kernel_flash_fwd_launches"]
            tc = g["dpt_kernel_flash_fwd_tensor_core_launches"]
            batches = g["dpt_serve_batches_total"]
            want = DEPTH * (batches + len(BUCKETS))
            say(f"front door (a): replica {r}: {batches:g} batches, K1 "
                f"launches {launches:g} = {DEPTH} x ({batches:g} + "
                f"{len(BUCKETS)} warm-up forwards) -> expected {want:g}; "
                f"{tc:g} on the tensor cores (its /metrics)")
            if batches != FD_WAVES_A or launches != want or tc != launches:
                fail(f"front door (a): replica {r}'s K1 launches do not "
                     f"match its batches on the tensor cores")
        # (b) rollout: B enters the ledger; canary, soak, promote
        sha_b = record_lineage(ledger, FD_LEDGER)
        t_b = time.monotonic()
        canary = wait_for("the canary", lambda: (lambda r: r if r[
            "phase"] == "canary" else None)(fd_status(fdp)["rollout"]), 60)
        if canary["canary_ids"] != [0]:
            fail(f"front door (b): canary on {canary['canary_ids']}")
        say(f"front door (b): canary of B on replica 0 "
            f"{time.monotonic() - t_b:.2f}s after B entered the ledger")
        wave("b-canary", (b_path, a_path))
        doc = wait_for("the promotion to both replicas", lambda: (
            lambda d: d if d["rollout"]["promotions"] == 1 and all(
                (d["upstreams"][str(r)]["lineage"] or {}).get("sha256")
                == sha_b for r in (0, 1)) else None)(fd_status(fdp)), 60)
        if doc["rollout"]["rollbacks"] or doc["rollout"]["phase"] != \
                "stable":
            fail(f"front door (b): {doc['rollout']}")
        say(f"front door (b): B promoted to both replicas "
            f"{time.monotonic() - t_b:.2f}s after it entered the ledger "
            f"(hold {FD_CANARY_HOLD_S:g}s)")
        wave("b", (b_path, b_path))
        # (c) repair: replica 1 killed with half a wave queued on each
        w_rows = list(range(row[0], row[0] + SERVE_WAVE))
        row[0] += SERVE_WAVE
        pending = {}

        def half_wave():
            pending["out"] = serve_wave(fdp, images[w_rows])

        sender = threading.Thread(target=half_wave)
        sender.start()
        wait_for("half a wave queued on each replica", lambda: all(
            fd_status(fdp)["upstreams"][str(r)]["pending"] ==
            SERVE_WAVE // 2 for r in (0, 1)), 60)
        world[1][1].kill()
        t_kill = time.monotonic()
        sender.join(timeout=300)
        if "out" not in pending:
            fail("front door (c): the wave around the kill did not end")
        answers = pending["out"]["answers"]
        if any(a[0] != 200 or a[4] != "0" for a in answers):
            fail(f"front door (c): the wave around the kill: "
                 f"{sorted({(a[0], a[4]) for a in answers}, key=str)}")
        got["waves"].append({"phase": "c", "replica": 0, "ckpt": b_path,
                             "rows": w_rows, "answers": answers})
        wait_for("slot 1's ejection", lambda: fd_status(fdp)["upstreams"][
            "1"]["ejected"], 60)
        t_eject = time.monotonic() - t_kill
        doc = wait_for("slot 1 back", lambda: (lambda d: d if d[
            "scale_events"] >= 1 and d["upstreams"]["1"]["alive"]
            and not d["upstreams"]["1"]["ejected"] else None)(
            fd_status(fdp)), 240)
        joined = wait_for("the joiner answering /livez", lambda: http_json(
            port + 1, "/livez")[1]["checkpoint"], 120)
        t_back = time.monotonic() - t_kill
        health1 = http_json(mport + 1, "/healthz")[1]
        if joined["sha256"] != sha_b or health1["rank"] != 1 \
                or health1["world_size"] != 2:
            fail(f"front door (c): the joiner serves {joined} as rank "
                 f"{health1['rank']} of {health1['world_size']}")
        out = wave("c-rejoined", (b_path, b_path))
        mine = [a[5] for a in out["answers"] if a[4] == "1"]
        if not mine:
            fail("front door (c): the joiner answered none of a wave")
        first = min(mine) - t_kill
        got["repair_s"] = (t_eject, t_back, first)
        say(f"front door (c): all {SERVE_WAVE} requests of the wave around "
            f"the kill answered 200 by replica 0 (retry-once); slot 1 "
            f"ejected {t_eject:.2f}s after the SIGKILL, the joiner "
            f"readmitted at rank 1 on :{port + 1} after {t_back:.2f}s "
            f"({doc['scale_events']} scale event), its first answer "
            f"{first:.2f}s after the kill, on {card}")
        if doc["scale_events"] != 1:
            fail(f"front door (c): {doc['scale_events']} scale events")
        events = [e for e in rank_events(fd_rsl, 90, "controller/scale_up")]
        if len(events) != 1 or "min_world" not in events[0]["attrs"][
                "reason"]:
            fail(f"front door (c): the scale-up events {events}")
        fd.send_signal(signal.SIGTERM)
        rc_fd = fd.wait(timeout=60)
        world[0][1].send_signal(signal.SIGTERM)
        try:
            rc0 = world[0][1].wait(timeout=120)
        except subprocess.TimeoutExpired:
            rc0 = None
        wait_for("the joiner's exit", lambda: not pids_naming(rsl), 120)
        if rc_fd != 0 or rc0 != 0:
            fail(f"front door: exit codes front door {rc_fd}, replica 0 "
                 f"{rc0} on SIGTERM")
        # (d) the two replays of the control scenario
        reports = []
        for out_path, t0, proc in sims:
            rc = proc.wait(timeout=300)
            with open(out_path) as f:
                text = f.read()
            if rc != 0:
                fail(f"front door (d): sim exited {rc}: {text[-2000:]}")
            reports.append(json.loads(text))
        shas = {r["event_log_sha256"] for r in reports}
        say(f"front door (d): sim --scenario control twice on the host: "
            f"{[r['scale']['actions'] for r in reports]} scale actions, "
            f"{[r['incidents'] for r in reports]} incidents, event log "
            f"sha256 {sorted(s[:12] for s in shas)}")
        if len(shas) != 1 or any(r["scale"]["actions"] or r["incidents"]
                                 for r in reports):
            fail("front door (d): the two replays differ or acted")
    finally:
        for pid in pids_naming(rsl):
            os.kill(pid, signal.SIGKILL)
    say(f"front door: (a)-(d) took {time.monotonic() - t_start:.1f}s")
    return got


def start_serve_world_phase(card: str, frontdoor: bool) -> dict:
    """Phase 40, then with ``frontdoor`` phase 41, on a thread of their
    own beside the other CLI phases: a failure (``fail``'s exit) is kept
    for ``finish_serve_world_phase``."""
    pending = {"t0": time.perf_counter()}

    def body():
        try:
            pending["got"] = phase_serve_world(card)
            if frontdoor:
                pending["fd"] = phase_frontdoor(card,
                                                pending["got"]["ckpts"])
        except BaseException as e:       # fail()'s SystemExit included
            pending["error"] = e

    pending["thread"] = threading.Thread(target=body, name="phase40",
                                         daemon=True)
    pending["thread"].start()
    return pending


def finish_serve_world_phase(pending: dict, frontdoor: bool) -> None:
    pending["thread"].join(SERVE_WAIT_S * 5)
    names = "phase_serve_world" + (" and phase_frontdoor" if frontdoor
                                   else "")
    say(f"chip_smoke: {names} ran {time.perf_counter() - pending['t0']:.1f}s "
        f"beside the other phases")
    if "got" not in pending or (frontdoor and "fd" not in pending):
        fail(f"phase 40{' or 41' if frontdoor else ''} did not pass: "
             f"{pending.get('error')!r}")
    check_served_answers("serve world", pending["got"])
    if frontdoor:
        check_served_answers("front door", pending["fd"])


# -- phase 42: the switch mixture-of-experts vit (--moe-experts) ----------

# E at the full width: batch 64 of 49 tokens, 16 rows a dispatch group
# (G = 4, 784 tokens), capacity ceil(784 / 8 x 1.25) = 123
MOE_EXPERTS = 8
# the card's routes held equal to the CPU's where the CPU's top-2 router
# probabilities lie further apart than this
MOE_MARGIN = 1e-5
MOE_TRACE_REPS = 5
MOE_TRACE_TRIES = 3
MOE_GRAPH_ROWS = 320            # phase 35's: 5 steps of 64 an epoch
MOE_ARGS = ["train", "--model", "vit", "--attention", "flash",
            "--moe-experts", str(MOE_EXPERTS), "-e", "1"]


def moe_step(device: str, precision: str, batch: tuple,
             moe_experts: int = MOE_EXPERTS) -> dict:
    """One train step of the full-width vit (``--attention flash``, SEED's
    weights from one CPU generator) with ``moe_experts`` on ``device`` at
    ``batch`` (images, labels, uniform affine draws): its loss, its
    gradients (f64 on the host), the blocks' sown loss, each MoE layer's
    routes (the expert and the top-2 probability margin of each token,
    from the router input the layer saw) and the port's kernel launches
    (all, and on the tensor cores); with the engine, state and inputs of
    the step for a trace."""
    import torch
    import torch.nn.functional as F

    from distributedpytorch_tpu_torch.cli import (kernel_launches,
                                                  tensor_core_launches)
    from distributedpytorch_tpu_torch.data import augment
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Engine

    ds = work_dataset()
    policy = PRESETS[precision]
    images, labels, u = batch
    model = get_model("vit", ds.nb_classes, policy, attention="flash",
                      device=device, moe_experts=moe_experts)
    engine = Engine(model, cross_entropy, ds.mean, ds.std, 28, policy,
                    device)
    state = engine.init_state(torch.Generator().manual_seed(SEED))
    routes, sown = [], []

    def hook(mod, inp, out):
        with torch.no_grad():
            x = inp[0].reshape(-1, inp[0].shape[-1]).float()
            probs = torch.softmax(F.linear(x, mod.router.weight.float())
                                  + mod.router.bias.float(), dim=-1)
            top2 = probs.topk(2, dim=-1).values
            routes.append((probs.argmax(dim=-1).cpu(),
                           (top2[:, 0] - top2[:, 1]).cpu()))
            sown.append(out[1].item())

    hooks = ([blk.moe.register_forward_hook(hook) for blk in model.blocks]
             if moe_experts else [])
    args = (torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device),
            torch.ones(len(images), dtype=torch.bool, device=device),
            augment.affine_from_uniform(torch.from_numpy(u).to(device),
                                        28, 28))
    before, before_tc = kernel_launches(), tensor_core_launches()
    _, m = engine.train_step_affine(state, *args)
    if device == "cuda":
        torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in kernel_launches().items()}
    tc = {k: v - before_tc[k] for k, v in tensor_core_launches().items()}
    for h in hooks:
        h.remove()
    return dict(loss=m["loss"].item(), sown=sum(sown), routes=routes,
                grads={n: p.grad.detach().double().cpu()
                       for n, p in model.named_parameters()},
                launches={k: v for k, v in launches.items() if v},
                tc={k: v for k, v in tc.items() if v},
                step=lambda: engine.train_step_affine(state, *args))


def moe_routes(tag: str, card: dict, cpu: dict, held: bool) -> None:
    """The card's expert of every token against the CPU's, layer by
    layer: the tokens routed apart above MOE_MARGIN of the CPU's top-2
    margin, and those below it (how many, and how many of them route
    apart), printed; with ``held`` (the f32 step, whose router inputs
    agree to f32 rounding) none may route apart above the margin."""
    apart, below, apart_below = [], 0, 0
    for (e_card, _), (e_cpu, margin) in zip(card["routes"], cpu["routes"]):
        sure = margin > MOE_MARGIN
        below += int((~sure).sum())
        apart.append(int(((e_card != e_cpu) & sure).sum()))
        apart_below += int(((e_card != e_cpu) & ~sure).sum())
    tokens = len(cpu["routes"][0][1]) if cpu["routes"] else 0
    say(f"moe: {tag} routes over {len(card['routes'])} layers x {tokens} "
        f"tokens: apart above the {MOE_MARGIN:g} top-2 margin by layer "
        f"{apart}; {below} tokens below it ({apart_below} of them routed "
        "apart)")
    if len(card["routes"]) != DEPTH or (held and sum(apart)):
        fail(f"moe: {tag}: {sum(apart)} tokens above the margin routed to "
             f"another expert on the card than on the CPU")


def phase_moe() -> None:
    """(a) and (b) of phase 42: the MoE vit's f32 and bf16 train steps
    card against CPU (gradients, loss, the sown loss, routes, K1-K3
    launches), the device ms of its bf16 step beside the dense vit's, and
    a graphed chunk of two epochs against the eager epochs."""
    import numpy as np
    import torch

    ds = work_dataset()
    batch = (ds.splits["train"].images[:TRAIN_BATCH],
             ds.splits["train"].labels[:TRAIN_BATCH].astype(np.int64),
             np.random.default_rng(SEED + 42).random((TRAIN_BATCH, 5),
                                                     dtype=np.float32))
    # the CPU's steps on a thread of their own (their ops release the GIL)
    # while the card takes its steps and the graphed chunk
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        jobs = {prec: pool.submit(moe_step, "cpu", prec, batch)
                for prec in ("f32", "bf16")}
        steps = {("cuda", prec): moe_step("cuda", prec, batch)
                 for prec in ("f32", "bf16")}
        t_card = time.perf_counter() - t0
        moe_graphed()
        t_graph = time.perf_counter() - t0
        steps.update({("cpu", prec): job.result()
                      for prec, job in jobs.items()})
    say(f"moe: the card's steps done at {t_card:.1f}s, its graphed chunk "
        f"at {t_graph:.1f}s, the CPU's steps at "
        f"{time.perf_counter() - t0:.1f}s")
    card, cpu = steps["cuda", "f32"], steps["cpu", "f32"]
    worst = max(((n, rel_err(card["grads"][n], g)) for n, g in
                 cpu["grads"].items()), key=lambda t: t[1][1])
    sown_err = abs(card["sown"] - cpu["sown"])
    say(f"moe: full-width MoE vit (E = {MOE_EXPERTS}, batch {TRAIN_BATCH})"
        f" f32 step, card vs CPU: loss {card['loss']:.7f} vs "
        f"{cpu['loss']:.7f}; sown loss {card['sown']:.7f} vs "
        f"{cpu['sown']:.7f}; worst gradient {worst[0]}: rel err "
        f"{worst[1][1]:.3g} (tol {TOL_STEP_GRAD:g}) over "
        f"{len(cpu['grads'])} parameters")
    moe_routes("f32", card, cpu, held=True)
    if not (math.isfinite(worst[1][1]) and worst[1][1] <= TOL_STEP_GRAD) \
            or sown_err > 1e-5 * abs(cpu["sown"]):
        fail(f"moe: the f32 step on the card disagrees with the CPU's: "
             f"{worst[0]} rel err {worst[1][1]}, sown loss err {sown_err}")
    b_card, b_cpu = steps["cuda", "bf16"], steps["cpu", "bf16"]
    # bf16 router inputs differ by the blocks' bf16 roundings on either
    # side (the flash kernels against their plain versions): the routes
    # are printed, the gradients held by the conditioned rule
    moe_routes("bf16", b_card, b_cpu, held=False)
    bad, shown = [], []
    for n, g in b_cpu["grads"].items():
        direct = rel_err(b_card["grads"][n], g)[1]
        mine = rel_err(b_card["grads"][n], card["grads"][n])[1]
        theirs = rel_err(g, card["grads"][n])[1]
        shown.append((direct, n, mine, theirs))
        if direct > TOL_GRAD["bfloat16"] and \
                mine > ZOO_CONDITIONED_FACTOR * theirs:
            bad.append(n)
    direct, n, mine, theirs = max(shown)
    say(f"moe: bf16 step, card vs CPU: worst gradient {n}: rel err "
        f"{direct:.3g} (tol {TOL_GRAD['bfloat16']:g}; from the f32 step: "
        f"card {mine:.3g}, CPU {theirs:.3g}); sown loss "
        f"{b_card['sown']:.6f} vs {b_cpu['sown']:.6f}; {len(bad)} "
        "gradients outside the conditioned rule")
    want = {"flash_fwd": DEPTH, "flash_dq": DEPTH, "flash_dkv": DEPTH}
    say(f"moe: the bf16 step's launches {b_card['launches']}, on the "
        f"tensor cores {b_card['tc']}; the f32 step's {card['launches']}")
    if bad or b_card["launches"] != want or b_card["tc"] != want \
            or card["launches"] != want:
        fail(f"moe: the bf16 step disagrees ({bad[:4]}) or its launches "
             f"{b_card['launches']} (tensor-core {b_card['tc']}) are not "
             f"{want}")
    dense = moe_step("cuda", "bf16", batch, moe_experts=0)
    for attempt in range(1, MOE_TRACE_TRIES + 1):
        ms = device_ms_tries({"moe": b_card["step"], "dense": dense["step"]},
                             reps=MOE_TRACE_REPS, tries=1)
        if all(ms.values()):
            break
        say(f"moe: trace {attempt} of {MOE_TRACE_TRIES} lost events")
    say("moe: device ms of one bf16 train step at batch 64 (the step's "
        "kernels between _device_trace's markers, "
        f"{MOE_TRACE_REPS} steps): MoE vit "
        + " / ".join(fmt_ms(t) for t in (ms["moe"][:1] or [None]))
        + ", dense vit "
        + " / ".join(fmt_ms(t) for t in (ms["dense"][:1] or [None])))


def moe_graphed() -> None:
    """(b): MOE_GRAPH_ROWS train rows and one validation batch, two
    epochs eagerly and as one chunk of two (``--epochs-per-dispatch 2``:
    each step a CUDA Graph replay) from the same seed: parameters,
    optimizer state, counters and both epochs' sums bit-identical."""
    import torch

    from distributedpytorch_tpu_torch import cli
    from distributedpytorch_tpu_torch.data.datasets import Split
    from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.dispatch import ChunkRunner
    from distributedpytorch_tpu_torch.train.engine import Engine

    torch.backends.cudnn.deterministic = True   # as train sets it
    torch.backends.cudnn.benchmark = False
    ds = work_dataset()
    split, vsplit = ds.splits["train"], ds.splits["valid"]
    train = ResidentLoader(Split(split.images[:MOE_GRAPH_ROWS],
                                 split.labels[:MOE_GRAPH_ROWS]),
                           TRAIN_BATCH, True, SEED, "cuda")
    valid = ResidentLoader(Split(vsplit.images[:TRAIN_BATCH],
                                 vsplit.labels[:TRAIN_BATCH]),
                           TRAIN_BATCH, False, SEED, "cuda")
    policy = PRESETS["bf16"]
    runs = {}
    for path in ("eager", "graphed"):
        model = get_model("vit", ds.nb_classes, policy, attention="flash",
                          device="cuda", moe_experts=MOE_EXPERTS)
        engine = Engine(model, cross_entropy, ds.mean, ds.std, 28, policy,
                        "cuda", steps_per_epoch=len(train))
        state = engine.init_state(torch.Generator().manual_seed(SEED))
        t0 = time.perf_counter()
        if path == "eager":
            sums = []
            for epoch in range(GRAPH_K):
                _, tl, ta = cli._run_train_pass(engine, state, train, epoch,
                                                SEED)
                sums.append((tl, ta) + cli._run_eval_pass(engine, state,
                                                          valid, epoch))
        else:
            got = ChunkRunner(engine, state, train, valid, SEED,
                              GRAPH_K).run(list(range(GRAPH_K)))
            sums = []
            for m, ev in zip(got["train"], got["eval"]):
                n, d, c, v = ev.tolist()
                sums.append((float(m[:, 0].mean()),
                             float(m[:, 1].sum()
                                   / max(float(m[:, 2].sum()), 1.0)),
                             n / max(d, 1e-9), c / max(v, 1.0)))
        torch.cuda.synchronize()
        runs[path] = dict(sums=sums, wall=time.perf_counter() - t0,
                          model={k: v.detach().clone() for k, v in
                                 state.model.state_dict().items()},
                          opt=state.optimizer.state_dict()["state"],
                          counters=(int(state.step), int(state.updates)))
    eager, graphed = runs["eager"], runs["graphed"]
    differ = [k for k, v in eager["model"].items()
              if not torch.equal(v, graphed["model"][k])]
    differ += [f"opt/{i}/{n}" for i, st in eager["opt"].items()
               for n, t in st.items()
               if not torch.equal(t, graphed["opt"][i][n])]
    same = (not differ and eager["sums"] == graphed["sums"]
            and eager["counters"] == graphed["counters"])
    say(f"moe: {GRAPH_K} epochs of {len(train)} steps and {len(valid)} eval"
        f" batch: eager {eager['wall']:.2f}s, one graphed chunk (captures "
        f"included) {graphed['wall']:.2f}s; bit-identical {same} "
        f"(differing {differ[:4]}); sums {graphed['sums']}")
    if not same:
        fail(f"moe: the graphed chunk is not bit-identical to the eager "
             f"epochs: {differ[:8]}, sums {eager['sums']} vs "
             f"{graphed['sums']}, counters {eager['counters']} vs "
             f"{graphed['counters']}")


def start_moe_cli() -> tuple:
    """(c): ``train --model vit --attention flash --moe-experts 8 -e 1``
    on phase 22's corpus, in the background."""
    write_zoo_data()
    return start_cli(MOE_ARGS, os.path.join(WORK, "moe_rsl"), data=ZOO_DATA)


def phase_moe_cli(train_run: tuple) -> None:
    """(c) and (d): the MoE train's launches by phase 6's formula, all on
    the tensor cores; then at once ``test -f`` of its best file (equal to
    an in-process eval) and, in process, a ``serving.ServingTier`` over
    it answering one wave of 64 (``tier_serve``)."""
    wall, log = finish_cli(train_run)
    launches, steps, evals = parse_launches(log, "train")
    tensor_core = parse_tensor_core_launches(log, "train")
    want = {"flash_fwd": DEPTH * (steps + evals), "flash_dq": DEPTH * steps,
            "flash_dkv": DEPTH * steps, "conv_dw": 0}
    say(f"moe: train --moe-experts {MOE_EXPERTS}: launches {launches} over "
        f"{steps} steps and {evals} eval batches, formula {want}; on the "
        f"tensor cores {tensor_core}")
    if not steps or launches != want or tensor_core != want:
        fail(f"moe: train launches {launches} (tensor-core {tensor_core}) "
             f"do not match the formula {want}")
    losses = [float(x) for x in re.findall(r"\| Loss: ([\d.a-z]+)", log)]
    acc = re.search(r"Validation  \| Loss: [\d.]+ +\| Acc: ([\d.]+)%", log)
    say(f"moe: the epoch in {wall:.1f}s of process wall: train and "
        f"validation losses {losses}, validation acc "
        f"{acc.group(1) if acc else None}%")
    if not losses or not all(math.isfinite(x) for x in losses) or not acc:
        fail("moe: the MoE train logged no finite losses")
    best = os.path.join(WORK, "moe_rsl", "bestmodel-mnist-vit.ckpt")
    test_run = start_cli(["test", "-f", best, "--attention", "flash",
                          "--moe-experts", str(MOE_EXPERTS)],
                         os.path.join(WORK, "moe_test_rsl"), data=ZOO_DATA)
    try:
        tier_serve("moe", best, ["--attention", "flash", "--moe-experts",
                                 str(MOE_EXPERTS)],
                   dict(attention="flash", moe_experts=MOE_EXPERTS))
        [(_, test_log)] = finish_all([test_run])
    finally:
        if test_run[3].poll() is None:
            test_run[3].kill()
            test_run[3].wait()
    acc_cli = re.search(r"Time: \d+m \d+s, Acc: ([\d.]+)%",
                        test_log).group(1)
    t_launches, _, t_evals = parse_launches(test_log, "test")
    acc_here, correct, n = eval_accuracy(best, "vit", ZOO_DATA,
                                         moe_experts=MOE_EXPERTS)
    say(f"moe: `test -f` accuracy {acc_cli}% ({t_evals} eval batches, "
        f"launches {t_launches}); in-process eval {acc_here}% "
        f"({correct}/{n})")
    if acc_cli != acc_here or t_launches["flash_fwd"] != DEPTH * t_evals \
            or t_launches["flash_dq"] or t_launches["flash_dkv"]:
        fail("moe: test's accuracy or launches disagree with the "
             "in-process eval")


def tier_serve(tag: str, best: str, flags: list, model_kw: dict) -> None:
    """A ``serving.ServingTier`` over the vit checkpoint ``best`` in
    process, its replica built as ``serve FLAGS`` builds it, answering one
    wave of SERVE_WAVE requests, every answer held against the predict
    step (of a vit built with ``model_kw``) of the batch the tier
    formed."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch import cli, serving
    from distributedpytorch_tpu_torch.config import config_from_argv
    from distributedpytorch_tpu_torch.data.datasets import load_dataset
    from distributedpytorch_tpu_torch.models import get_model
    from distributedpytorch_tpu_torch.precision import PRESETS
    from distributedpytorch_tpu_torch.train.engine import Predictor

    started = time.perf_counter()
    ds = load_dataset("mnist", ZOO_DATA, SEED, synthetic_fallback=True)
    images = ds.splits["test"].images[:SERVE_WAVE]
    cfg = config_from_argv(["serve", "-d", ZOO_DATA, "-f", best, *flags,
                            "--serve-buckets", str(SERVE_WAVE)])
    infer = cli._serve_build_replica(cfg, best, "vit", ds, (SERVE_WAVE,),
                                     images.shape[1:], images.dtype,
                                     torch.device("cuda"))
    batches = []

    def recording(arr):
        batches.append(np.array(arr))
        return infer(arr)

    port = free_port()
    tier = serving.ServingTier(recording, images.shape[1:], images.dtype,
                               (SERVE_WAVE,), max_queue=256,
                               max_latency_s=SERVE_FLUSH_MS / 1000.0,
                               port=port, request_timeout_s=120,
                               max_requests=SERVE_WAVE)
    tier.start()
    runner = threading.Thread(target=tier.run, daemon=True)
    runner.start()
    try:
        wave = serve_wave(port, images)
        runner.join(timeout=120)
    finally:
        tier.close()
    answers = wave["answers"]
    if any(a[0] != 200 for a in answers) or len(batches) != 1:
        fail(f"{tag}: the tier answered {[a[0] for a in answers][:8]} in "
             f"{len(batches)} batches (one wave of {SERVE_WAVE} is one "
             "batch)")
    [batch] = batches
    policy = PRESETS["bf16"]
    model = get_model("vit", ds.nb_classes, policy, device="cuda",
                      **model_kw)
    ckpt.restore_for_serving(best, model)
    labels, confs = Predictor(model, ds.mean, ds.std, 28, policy,
                              "cuda").predict_step(batch)
    labels, confs = labels.cpu().numpy(), confs.float().cpu().numpy()
    row_of = {batch[r].tobytes(): r for r in range(len(batch))}
    rows = [row_of[img.tobytes()] for img in images]
    got_labels = np.array([a[1]["label"] for a in answers])
    got_confs = np.array([a[1]["confidence"] for a in answers])
    err = float(np.abs(got_confs - confs[rows]).max())
    equal = int((got_labels == labels[rows]).sum())
    say(f"{tag}: a served wave of {SERVE_WAVE} in one batch of bucket "
        f"{SERVE_WAVE}: {equal} labels equal to the predict step of that "
        f"batch, max conf err {err:.3g} (tol {TOL_CONF:g}); the tier took "
        f"{time.perf_counter() - started:.1f}s with its build")
    if equal != SERVE_WAVE or err > TOL_CONF \
            or sorted(rows) != list(range(SERVE_WAVE)):
        fail(f"{tag}: the served answers disagree with the predict step")


# 45 (b) and 46 (a) run in 43's zero world
PHASE_NEEDS = {7: {6, 8}, 8: {6, 7}, 41: {40}, 45: {43}, 46: {43}}
LAST_PHASE = 47                 # the closing lines; only a full run has it


# -- phase 43: placement over 'model', tensor and expert parallelism -------

# (a)-(c)'s steps: 3 f32 SGD steps of one global batch of 64 (the first
# with rows masked), each world against one process fed the same batches
P43_STEPS = 3
# (name, ranks, arch, attention): each 2-rank world (data 1 x model 2)
# beside its one-process reference; the three references run one after
# another in one process (TP's first: its peak memory is a fresh
# process's), which spares two process starts beside the other phases
P43_WORLDS = (("zero", 2, {}, "flash"),
              ("ep", 2, {"moe_experts": MOE_EXPERTS}, "flash"),
              ("tp", 2, {"tensor_parallel": True}, "full"),
              ("tp_one", 1, {}, "full"), ("zero_one", 1, {}, "flash"),
              ("ep_one", 1, {"moe_experts": MOE_EXPERTS}, "flash"))
# The placed steps against one process's, each tensor relative to its
# largest value: the same f32 math (ZeRO and EP gather exact copies;
# TP sums two partial products in another order).
TOL_P43 = 1e-5
# (a) and (b) through the CLI: train, test -f and a 1-rank train -f
P43_CLI = {"zero": [], "ep": ["--moe-experts", str(MOE_EXPERTS)]}
P43_CARRIES = {"zero": "parameters placed",
               "ep": "parameters placed and the experts"}


def p43_expected_elements(state: dict, experts: bool) -> int:
    """A rank's parameter elements at M = 2 by the JAX rule
    (``parallel.leaf_spec`` on each tensor; a MoE vit's experts halved
    under expert parallelism)."""
    from distributedpytorch_tpu_torch.parallel import leaf_spec

    n = 0
    for name, t in state.items():
        if "running_" in name:
            continue
        split = leaf_spec(tuple(t.shape), 2) is not None or (
            experts and re.search(r"\.w_(up|down)$", name))
        n += t.numel() // 2 if split else t.numel()
    return n


def placement_worlds(scan_ring: bool = False, orbax: bool = False) -> dict:
    """(a)-(c) in process: the worlds of P43_WORLDS at once on the card
    (tests/_torch_ring_child.py vit, the placed ranks over gloo), each
    placed world's gathered parameters after P43_STEPS steps against its
    one-process run's, a rank's parameter and momentum elements against
    the rule's count, and under TP each rank's peak of its last step
    against one process's.  With ``scan_ring``, phase 45 (b) in the zero
    world after its spec (``scan_ring_steps``); with ``orbax``, phase 46
    (a) there after them (``orbax_world``).  Returns the printed
    numbers."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.data import augment

    rng = np.random.default_rng(SEED + 43)
    steps = []
    for i in range(P43_STEPS):
        valid = np.ones(TRAIN_BATCH, bool)
        if i == 0:
            valid[TRAIN_BATCH // 2:TRAIN_BATCH - 1] = False
        u = torch.from_numpy(rng.random((TRAIN_BATCH, 5), dtype=np.float32))
        steps.append((rng.integers(0, 256, (TRAIN_BATCH, 28, 28),
                                   dtype=np.uint8),
                      rng.integers(0, 10, TRAIN_BATCH), valid,
                      [t.numpy() for t in augment.affine_from_uniform(
                          u, 28, 28)]))
    def spec(arch, attention):
        return dict(arch=arch, attention=attention, seed=SEED, params=None,
                    steps=steps, peak_memory=True)

    def specs(name, arch, attention):
        if name != "zero" or not (scan_ring or orbax):
            return spec(arch, attention)
        out = [spec(arch, attention)]
        if scan_ring:
            out += [dict(spec({"scan_layers": stacked}, "ring_flash"),
                         precision="bf16", peak_memory=False)
                    for stacked in (False, True)]
        if orbax:
            out += [dict(spec(arch, attention),
                         steps=steps[:P46_SAVED_STEPS], ckpt_dir=P46_DIR,
                         peak_memory=False),
                    dict(spec(arch, attention), steps=[], resume=P46_DIR,
                         peak_memory=False)]
        return out

    placed = [w for w in P43_WORLDS if w[1] == 2]
    ones = [w for w in P43_WORLDS if w[1] == 1]
    got = run_worlds([
        ring_world("vit", specs(name, arch, attention), world, f"p43_{name}",
                   "--model-parallel", str(world))
        for name, world, arch, attention in placed] + [
        ring_world("vit", [spec(arch, attention) for _, _, arch, attention
                           in ones], 1, "p43_one", "--model-parallel", "1")])
    worlds = {name: [r[0] if isinstance(r, list) else r for r in ranks]
              for (name, *_), ranks in zip(placed, got)}
    worlds.update({name: [r] for (name, *_), r in zip(ones, got[-1][0])})
    out = {}
    for name in ("zero", "ep", "tp"):
        ranks, one = worlds[name], worlds[name + "_one"][0]
        same = all(torch.equal(v, ranks[0]["state"][k])
                   for r in ranks for k, v in r["state"].items())
        w = worst(ranks[0]["state"], one["state"])
        abs_err = max(float((v.double() - one["state"][k].double()).abs()
                            .max()) for k, v in ranks[0]["state"].items())
        loss_err = max(abs(a[0] - b[0]) for a, b in
                       zip(ranks[0]["metrics"], one["metrics"]))
        out[name] = {"abs_err": abs_err, "rel_err": w[1],
                     "loss_err": loss_err}
        say(f"placement {name}: 2 ranks (gloo, data 1 x model 2) vs 1 "
            f"process, {P43_STEPS} f32 SGD steps of the full-width vit on a "
            f"global batch of {TRAIN_BATCH}: max abs err {abs_err:.3g}, "
            f"worst tensor {w[0]} rel err {w[1]:.3g} (tol {TOL_P43:g}); loss "
            f"err {loss_err:.3g}; ranks equal: {same}")
        if not (same and math.isfinite(w[1]) and w[1] <= TOL_P43
                and loss_err <= TOL_P43):
            fail(f"placement {name}: the 2-rank steps disagree with one "
                 f"process")
    for name in ("zero", "ep"):
        one = worlds[name + "_one"][0]
        full = sum(t.numel() for k, t in one["state"].items()
                   if "running_" not in k)
        want = p43_expected_elements(one["state"], name == "ep")
        held = [r["elements"] for r in worlds[name]]
        out[name].update(full=full, per_rank=held[0][0])
        say(f"placement {name}: a rank holds {held} (parameters, momentum) "
            f"elements of {full} each replicated: {held[0][0] / full:.4f} "
            f"of it; the JAX rule's count {want}")
        if any(h != (want, want) for h in held) \
                or one["elements"] != (full, full):
            fail(f"placement {name}: a rank's elements {held} are not the "
                 f"rule's {want}")
    (peak1, held1) = worlds["tp_one"][0]["peak_memory"]
    peaks = [r["peak_memory"] for r in worlds["tp"]]
    out["tp"].update(peaks=peaks, one=(peak1, held1))
    say(f"placement tp: the last step's torch.cuda.max_memory_allocated "
        f"(bytes allocated before it) a rank {peaks} against one process's "
        f"{peak1} ({held1}): {[round(p / peak1, 4) for p, _ in peaks]}; the "
        f"step's own {[round((p - h) / (peak1 - held1), 4) for p, h in peaks]}"
        f" of one process's")
    if any(p >= peak1 for p, _ in peaks):
        fail("placement tp: a rank's peak is not below one process's")
    zero = got[[n for n, *_ in placed].index("zero")]
    if scan_ring:
        out["scan_ring"] = scan_ring_steps([r[1:3] for r in zero])
    if orbax:
        out["orbax"] = orbax_world([r[0] for r in zero],
                                   [r[-2:] for r in zero],
                                   spec(P43_WORLDS[0][2], P43_WORLDS[0][3]))
    return out


def scan_ring_steps(ranks: list) -> dict:
    """Phase 45 (b): each rank's (unrolled, stacked) ``ring_flash`` vit
    results at M = 2 in bf16 (P43_STEPS SGD steps of the zero world's
    batches, the state placed as ZeRO places it): the stacked run's
    gathered state in the plain layout bit-identical to the unrolled
    run's, and K4, K2p and K3p 8 a step each on both, all on the tensor
    cores."""
    import torch

    from distributedpytorch_tpu_torch.models import scan

    want = {"flash_fwd_pos": 2 * DEPTH * P43_STEPS,
            "flash_dq_pos": 2 * DEPTH * P43_STEPS,
            "flash_dkv_pos": 2 * DEPTH * P43_STEPS}
    bad = []
    for rank, (plain, stacked) in enumerate(ranks):
        got = scan.convert_layout(stacked["state"], "blocks")
        differ = [k for k, v in plain["state"].items()
                  if not torch.equal(v, got[k])]
        launches = [{k: v for k, v in r["launches"].items() if v}
                    for r in (plain, stacked)]
        tc = [{k: v for k, v in r["tensor_core"].items() if v}
              for r in (plain, stacked)]
        say(f"scan ring: rank {rank}: the stacked ring_flash vit at M = 2 "
            f"against the unrolled one, {P43_STEPS} bf16 SGD steps: "
            f"{len(differ)} of {len(got)} tensors differ; losses "
            f"{[m[0] for m in stacked['metrics']]} vs "
            f"{[m[0] for m in plain['metrics']]}; launches {launches[1]} vs "
            f"{launches[0]}, on the tensor cores {tc[1]} vs {tc[0]} "
            f"(formula {want})")
        if differ or stacked["metrics"] != plain["metrics"] \
                or any(x != want for x in launches + tc):
            bad.append(rank)
    if bad:
        fail(f"scan ring: ranks {bad}: the stacked ring differs from the "
             f"unrolled one or its launches are not {want}")
    return {"launches": want}


def placement_cli() -> dict:
    """(a) and (b) through the CLI on phase 22's corpus: ``train
    --attention flash --model-parallel 2 -e 1`` (and with ``--moe-experts
    8``) under torchrun --nproc_per_node 2, bf16, K1-K3 on each rank by
    phase 6's formula from its kernel_launches telemetry, all on the
    tensor cores; then at once ``test -f`` of each best file on 2 ranks
    (equal to an in-process eval) and a 1-process ``train -f`` resume of
    it."""
    write_zoo_data()
    runs = [start_cli(["train", "--model", "vit", "--attention", "flash",
                       "--model-parallel", "2", "-e", "1", "--telemetry",
                       *extra], os.path.join(WORK, f"p43_{key}_rsl"),
                      launcher=TORCHRUN2, data=ZOO_DATA)
            for key, extra in P43_CLI.items()]
    done = finish_all(runs)
    n_train = int(ZOO_TRAIN_ROWS * 0.9)
    want_steps = math.ceil(n_train / 2 / TRAIN_BATCH)
    want_evals = math.ceil((ZOO_TRAIN_ROWS - n_train) / 2 / TRAIN_BATCH)
    out, pending = {}, []
    for (key, extra), (wall, log) in zip(P43_CLI.items(), done):
        rsl = os.path.join(WORK, f"p43_{key}_rsl")
        line = (f"mesh: data 1 x model 2, {P43_CARRIES[key]} over the model "
                f"group on gloo")
        if line not in log:
            fail(f"placement {key}: the train did not log {line!r}")
        _, steps, evals = parse_launches(log, "train")
        want = {"flash_fwd": DEPTH * (steps + evals),
                "flash_dq": DEPTH * steps, "flash_dkv": DEPTH * steps,
                "conv_dw": 0}
        ranks = []
        for rank in (0, 1):
            ev = [e["attrs"] for e in rank_events(rsl, rank,
                                                  "kernel_launches")]
            if len(ev) != 1:
                fail(f"placement {key}: rank {rank} recorded {len(ev)} "
                     f"worlds")
            ranks.append((ev[0]["launches"], ev[0]["tensor_core"]))
        say(f"placement {key}: train {' '.join(extra)} -e 1 on 2 ranks "
            f"in {wall:.1f}s of process wall: {steps} steps and {evals} "
            f"eval batches; launches by rank {[r[0] for r in ranks]}, on "
            f"the tensor cores {[r[1] for r in ranks]}; formula {want}")
        # every other kernel (K5, the ring's) 0
        want_all = {k: want.get(k, 0) for k in ranks[0][0]}
        if (steps, evals) != (want_steps, want_evals) or any(
                got != want_all or {k: tc[k] for k in want} != want
                for got, tc in ranks):
            fail(f"placement {key}: launches {ranks} do not match the "
                 f"formula {want} at {want_steps} steps / {want_evals} eval "
                 f"batches, all on the tensor cores")
        best = os.path.join(rsl, "bestmodel-mnist-vit.ckpt")
        out[key] = {"steps": steps, "evals": evals, "launches": ranks[0][0]}
        pending.append((key, extra, best, start_cli(
            ["test", "-f", best, "--attention", "flash", "--model-parallel",
             "2", *extra], os.path.join(WORK, f"p43_{key}_test"),
            launcher=TORCHRUN2, data=ZOO_DATA), start_cli(
            ["train", "-f", best, "--model", "vit", "--attention", "flash",
             "-e", "2", *extra], os.path.join(WORK, f"p43_{key}_resume"),
            data=ZOO_DATA)))
    logs = finish_all([r for *_, t, res in pending for r in (t, res)])
    for i, (key, extra, best, _, _) in enumerate(pending):
        (_, test_log), (_, resume_log) = logs[2 * i], logs[2 * i + 1]
        acc_cli = re.search(r"Time: \d+m \d+s, Acc: ([\d.]+)%",
                            test_log).group(1)
        t_launches, _, t_evals = parse_launches(test_log, "test")
        acc_here, correct, n = eval_accuracy(
            best, "vit", ZOO_DATA, moe_experts=MOE_EXPERTS if extra else 0)
        r_launches, r_steps, r_evals = parse_launches(resume_log, "train")
        loaded = "model loaded from" in resume_log
        say(f"placement {key}: `test -f` on 2 ranks {acc_cli}% ({t_evals} "
            f"eval batches, launches {t_launches}); in-process eval "
            f"{acc_here}% ({correct}/{n}); 1-process `train -f` resumed: "
            f"{loaded}, {r_steps} steps and {r_evals} eval batches, "
            f"launches {r_launches}")
        if acc_cli != acc_here or t_launches["flash_fwd"] != DEPTH * t_evals \
                or t_launches["flash_dq"] or t_launches["flash_dkv"] \
                or not loaded or r_steps != math.ceil(n_train / TRAIN_BATCH) \
                or r_launches["flash_dq"] != DEPTH * r_steps:
            fail(f"placement {key}: the test of the placed run's file or its "
                 f"1-process resume disagrees")
    return out


# -- phase 44: the GPipe vit and its ring over 'seq' -----------------------

PIPE_CHILD = os.path.join(ROOT, "tests", "_torch_pipeline_child.py")
# (a) and (b): 3 f32 SGD steps of one global batch of 64 (the first with
# rows masked), each world against one process running the blocks in
# order on the same batches and weights (one CPU generator)
P44_STEPS = 3
# (name, ranks, mesh (model, seq), spec extras), in three worlds run at
# once: the specs of one world size one after another in its processes
P44_WORLDS = (("pp_m2", 2, (2, 1), {"n_micro": 2}),
              ("pp_m4", 2, (2, 1), {"n_micro": 4}),
              ("ring_pp", 4, (2, 2), {"ring": True}),
              ("pp_one", 1, (1, 1), {}))
# The pipelined steps against one process's, each tensor relative to its
# largest value: the same f32 math on the same rows (a microbatch's
# matmuls have fewer rows; the ring merges two key blocks in f32)
TOL_P44 = 1e-5
P44_PROFILE_STEPS = 5       # bf16 steps timed a rank, printed only


def p44_expected_elements(state: dict) -> int:
    """A rank's parameter elements at M = 2 by the JAX rule under the
    pipeline (``leaf_spec(prefer_axis0=True)``: the four stacked kernels
    split on the block axis, the rest whole)."""
    from distributedpytorch_tpu_torch.parallel import leaf_spec

    return sum(t.numel() // 2 if leaf_spec(tuple(t.shape), 2,
                                           prefer_axis0=True) is not None
               else t.numel() for t in state.values())


def pipeline_world(name: str, world: int, specs: list) -> tuple:
    """A ``run_worlds`` entry of ``tests/_torch_pipeline_child.py`` on
    ``specs`` (saved to WORK/NAME-in.pt) in ``world`` ranks."""
    import torch

    inp = os.path.join(WORK, f"{name}-in.pt")
    torch.save(specs, inp)
    return name, world, PIPE_CHILD, [inp], []


def pipeline_worlds() -> dict:
    """(a) and (b) in process: the worlds of P44_WORLDS on the card
    (several ranks over gloo), each world's gathered parameters after
    P44_STEPS steps against the one-process run's, every rank equal, a
    rank's parameter and momentum elements against the rule's count, no
    kernel launched on any rank; after them in the same processes, the
    pipelined bf16 step's device time a rank beside the dense vit's
    (``--attention full``, one process; printed, not a gate)."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.data import augment

    rng = np.random.default_rng(SEED + 44)
    steps = []
    for i in range(P44_STEPS):
        valid = np.ones(TRAIN_BATCH, bool)
        if i == 0:
            valid[TRAIN_BATCH // 2:TRAIN_BATCH - 1] = False
        u = torch.from_numpy(rng.random((TRAIN_BATCH, 5), dtype=np.float32))
        steps.append((rng.integers(0, 256, (TRAIN_BATCH, 28, 28),
                                   dtype=np.uint8),
                      rng.integers(0, 10, TRAIN_BATCH), valid,
                      [t.numpy() for t in augment.affine_from_uniform(
                          u, 28, 28)]))
    profile = dict(kind="engine", seed=SEED, steps=steps[-1:],
                   precision="bf16", profile=P44_PROFILE_STEPS)
    extra_specs = {2: [dict(profile, mesh=(2, 1))],
                   1: [dict(profile, mesh=(1, 1), plain=True)]}
    sizes = sorted({w[1] for w in P44_WORLDS})
    got = run_worlds([pipeline_world(f"p44_w{size}", size, [
        dict(kind="engine", mesh=mesh, seed=SEED, steps=steps, **extra)
        for _, world, mesh, extra in P44_WORLDS if world == size]
        + extra_specs.get(size, [])) for size in sizes])
    by_size = dict(zip(sizes, got))
    worlds, at = {}, dict.fromkeys(sizes, 0)
    for name, world, *_ in P44_WORLDS:
        worlds[name] = [r[at[world]] for r in by_size[world]]
        at[world] += 1
    one = worlds["pp_one"][0]
    full = sum(t.numel() for t in one["state"].values())
    want = p44_expected_elements(one["state"])
    out = {}
    for name in ("pp_m2", "pp_m4", "ring_pp"):
        ranks = worlds[name]
        apart = sorted({k for r in ranks for part in ("state", "whole")
                        for k, v in r[part].items()
                        if not torch.equal(v, ranks[0][part][k])})
        same = not apart
        w = worst(ranks[0]["state"], one["state"])
        abs_err = max(float((v.double() - one["state"][k].double()).abs()
                            .max()) for k, v in ranks[0]["state"].items())
        loss_err = max(abs(a[0] - b[0]) for a, b in
                       zip(ranks[0]["metrics"], one["metrics"]))
        held = [r["elements"] for r in ranks]
        launched = [sum(r["launches"].values()) for r in ranks]
        out[name] = {"abs_err": abs_err, "rel_err": w[1],
                     "loss_err": loss_err, "per_rank": held[0][0]}
        mesh = ("data 1 x model 2 x seq 2" if name == "ring_pp"
                else "data 1 x model 2")
        say(f"pipeline {name}: {len(ranks)} ranks (gloo, {mesh}) vs 1 "
            f"process, {P44_STEPS} f32 SGD steps of the full-width vit on a "
            f"global batch of {TRAIN_BATCH}: max abs err {abs_err:.3g}, "
            f"worst tensor {w[0]} rel err {w[1]:.3g} (tol {TOL_P44:g}); loss "
            f"err {loss_err:.3g}; ranks equal: {same or apart}; a rank holds "
            f"{held} "
            f"(parameters, momentum) elements of {full}, the JAX rule's "
            f"{want}; kernel launches by rank {launched}")
        if not (same and math.isfinite(w[1]) and w[1] <= TOL_P44
                and loss_err <= TOL_P44):
            fail(f"pipeline {name}: the steps disagree with one process")
        if any(h != (want, want) for h in held) \
                or one["elements"] != (full, full):
            fail(f"pipeline {name}: a rank's elements {held} are not the "
                 f"rule's {want}")
        if any(launched):
            fail(f"pipeline {name}: a kernel of the port was launched")
    piped = [r[-1]["profile"] for r in by_size[2]]
    dense = by_size[1][0][-1]["profile"]
    out["profile"] = {"pipelined": [(p["device_ms"], p["wall_ms"])
                                    for p in piped],
                      "dense": (dense["device_ms"], dense["wall_ms"])}
    ranks = [(round(dev, 5), round(wall, 3))
             for dev, wall in out["profile"]["pipelined"]]
    say(f"pipeline: a bf16 step at batch {TRAIN_BATCH} (M = 2), device / "
        f"wall ms a rank {ranks}"
        f" ({[p['kernels'] for p in piped]} kernels); the dense vit "
        f"(--attention full, 1 process) {dense['device_ms']:.5f} / "
        f"{dense['wall_ms']:.3f} ({dense['kernels']} kernels); "
        f"{P44_PROFILE_STEPS} steps each, beside the ring world's steps")
    return out


def pipeline_cli() -> dict:
    """(c) through the CLI on phase 22's corpus: ``train --model vit
    --pipeline-parallel --model-parallel 2 -e 1`` in bf16 under torchrun
    --nproc_per_node 2 (finite losses, the ``mesh:`` line, no kernel
    launched); then at once ``test -f`` of its best file in one process
    on a plain config (stacked -> blocks at load) and on 2 ranks with the
    pipeline flags, each equal to an in-process eval of the pipelined
    model."""
    write_zoo_data()
    rsl = os.path.join(WORK, "p44_rsl")
    wall, log = finish_all([start_cli(
        ["train", "--model", "vit", "--pipeline-parallel",
         "--model-parallel", "2", "-e", "1"], rsl, launcher=TORCHRUN2,
        data=ZOO_DATA)])[0]
    line = ("mesh: data 1 x model 2, parameters placed and pipeline stages "
            "over the model group on gloo")
    if line not in log:
        fail(f"pipeline: the train did not log {line!r}")
    launches, steps, evals = parse_launches(log, "train")
    launches.update(parse_ring_launches(log, "train"))
    losses = [float(x) for x in re.findall(r"Loss: ([-\d.naif]+)", log)]
    say(f"pipeline: train --pipeline-parallel --model-parallel 2 -e 1 on 2 "
        f"ranks in {wall:.1f}s of process wall: {steps} steps and {evals} "
        f"eval batches, losses {losses}, launches {launches}")
    if len(losses) != 2 or not all(map(math.isfinite, losses)) \
            or any(launches.values()):
        fail("pipeline: the train's losses are not finite or it launched a "
             "kernel")
    best = os.path.join(rsl, "bestmodel-mnist-vit.ckpt")
    logs = finish_all([
        start_cli(["test", "-f", best], os.path.join(WORK, "p44_test1"),
                  data=ZOO_DATA),
        start_cli(["test", "-f", best, "--pipeline-parallel",
                   "--model-parallel", "2"],
                  os.path.join(WORK, "p44_test2"), launcher=TORCHRUN2,
                  data=ZOO_DATA)])
    accs = [re.search(r"Time: \d+m \d+s, Acc: ([\d.]+)%", t).group(1)
            for _, t in logs]
    test_launches = [sum({**parse_launches(t, "test")[0],
                          **parse_ring_launches(t, "test")}.values())
                     for _, t in logs]
    converted = ("checkpoint params converted: stacked -> blocks block "
                 "layout") in logs[0][1]
    acc_here, correct, n = eval_accuracy(best, "vit", ZOO_DATA,
                                         pipelined=True)
    say(f"pipeline: `test -f` in 1 process on a plain config {accs[0]}% "
        f"(stacked -> blocks at load: {converted}), on 2 ranks with the "
        f"pipeline flags {accs[1]}%; in-process eval of the pipelined model "
        f"{acc_here}% ({correct}/{n}); kernel launches {test_launches}")
    if not converted or accs != [acc_here, acc_here] or any(test_launches):
        fail("pipeline: a test of the pipeline's file disagrees with the "
             "in-process eval")
    return {"steps": steps, "evals": evals, "losses": losses,
            "acc": acc_here}


# -- phase 45: --scan-layers ----------------------------------------------

# (a): f32 Adam steps of the stacked vit against the unrolled one from the
# same weights and batches, cuDNN deterministic as train sets it; each
# tensor relative to its largest value: the same kernels on bit-equal
# slices, so bit-identical is expected, and anything else is held to
# TOL_SCAN with its largest error printed
SCAN_STEPS = 3
TOL_SCAN = 1e-6
SCAN_TIME_STEPS = 10            # (a): bf16 steps on the host clock, twice
SCAN_TRACE_REPS = 5             # (a): bf16 steps a trace, 3 traces
# (d): densenet121 at 224: one step of SCAN_DN_BATCH rows, stacked against
# unrolled, in f64 compute (its 1x1 convs sum the padded channels' zeros
# in another order) and in f32 by the conditioned rule against the
# unrolled f64 step (ROADMAP queue 3 entry 8); then the bf16 step at
# batch 64 timed and its peak memory read
SCAN_DN_BATCH = 16
TOL_SCAN_F64 = 1e-6
SCAN_DN_TRACE_REPS = 2
SCAN_ARGS = ["train", "--model", "vit", "--attention", "flash",
             "--scan-layers", "-e", "1"]


def scan_batches(n: int, rows: int, seed: int) -> list:
    """``n`` train batches of ``rows`` rows of WORK/data on the card:
    (images, labels, valid, affine draws from uniform ones)."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.data import augment

    ds = work_dataset()
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rows_i = slice(i * rows, (i + 1) * rows)
        u = torch.from_numpy(rng.random((rows, 5), dtype=np.float32))
        out.append((
            torch.from_numpy(ds.splits["train"].images[rows_i]).cuda(),
            torch.from_numpy(ds.splits["train"].labels[rows_i]
                             .astype(np.int64)).cuda(),
            torch.ones(rows, dtype=torch.bool, device="cuda"),
            augment.affine_from_uniform(u.cuda(), 28, 28)))
    return out


def scan_engine(name: str, policy, scan_layers: bool,
                optimizer: str = "adam"):
    """The engine and state of the registry's ``name`` (the vit with
    ``--attention flash``) on the card, SEED's weights."""
    import torch

    from distributedpytorch_tpu_torch.models import (get_model,
                                                     get_model_input_size)
    from distributedpytorch_tpu_torch.ops.losses import cross_entropy
    from distributedpytorch_tpu_torch.train.engine import Engine

    ds = work_dataset()
    model = get_model(name, ds.nb_classes, policy, device="cuda",
                      attention="flash" if name == "vit" else "full",
                      scan_layers=scan_layers)
    engine = Engine(model, cross_entropy, ds.mean, ds.std,
                    get_model_input_size(name), policy, "cuda",
                    optimizer=optimizer)
    return engine, engine.init_state(torch.Generator().manual_seed(SEED))


def unstacked(tensors: dict) -> dict:
    """A state dict or gradients by name in the plain layout (a scanned
    model's converted), as f64 on the host."""
    from distributedpytorch_tpu_torch.models import scan

    layout = scan.params_layout(tensors)
    if layout in ("scan", "vgg_scan", "dense_scan", "inception_scan"):
        tensors = scan.convert_layout(tensors, scan.scan_layout_for(layout))
    return {k: v.detach().double().cpu() for k, v in tensors.items()}


def phase_scan() -> dict:
    """(a) and (d) of phase 45, in process before phase 21 with the other
    timed phases: the stacked vit's f32 steps against the unrolled one's
    and its launches, its bf16 step's device and wall time beside the
    unrolled one's; densenet121's stacked step against the unrolled one
    in f64 and f32, and its bf16 step's device time and peak memory."""
    import torch

    from torch.profiler import ProfilerActivity, profile

    from distributedpytorch_tpu_torch.cli import (kernel_launches,
                                                  tensor_core_launches)
    from distributedpytorch_tpu_torch.precision import PRESETS

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # as train sets it
    out = {}
    try:
        batches = scan_batches(SCAN_STEPS, TRAIN_BATCH, SEED + 45)
        runs = {}
        for stacked in (False, True):
            engine, state = scan_engine("vit", PRESETS["f32"], stacked)
            before = kernel_launches()
            losses = [engine.train_step_affine(state, *b)[1]["loss"].item()
                      for b in batches]
            torch.cuda.synchronize()
            runs[stacked] = (unstacked(state.model.state_dict()), losses, {
                k: v - before[k] for k, v in kernel_launches().items()
                if v - before[k]})
        (plain, plain_losses, plain_l), (got, got_losses, got_l) = \
            runs[False], runs[True]
        differ = [k for k, v in plain.items() if not torch.equal(v, got[k])]
        worst = max(((k, rel_err(got[k], v)[1]) for k, v in plain.items()),
                    key=lambda t: t[1])
        want = {"flash_fwd": DEPTH * SCAN_STEPS,
                "flash_dq": DEPTH * SCAN_STEPS,
                "flash_dkv": DEPTH * SCAN_STEPS}
        say(f"scan: the stacked vit (blocks.block.*, depth {DEPTH}) against "
            f"the unrolled one, {SCAN_STEPS} f32 Adam steps of "
            f"{TRAIN_BATCH} rows from SEED's weights: {len(differ)} of "
            f"{len(plain)} tensors differ, worst {worst[0]} rel err "
            f"{worst[1]:.3g} (tol {TOL_SCAN:g}); losses {got_losses} vs "
            f"{plain_losses}; launches {got_l} vs {plain_l}")
        if worst[1] > TOL_SCAN or got_l != want or plain_l != want:
            fail(f"scan: the stacked vit's f32 steps disagree with the "
                 f"unrolled ones ({differ[:4]}) or its launches {got_l} "
                 f"are not {want}")
        out["f32"] = {"differ": len(differ), "worst": worst[1]}
        steps = {}
        for stacked in (False, True):
            engine, state = scan_engine("vit", PRESETS["bf16"], stacked)
            before, before_tc = kernel_launches(), tensor_core_launches()
            engine.train_step_affine(state, *batches[0])
            torch.cuda.synchronize()
            launches = {k: v - before[k] for k, v in kernel_launches().items()
                        if v - before[k]}
            tc = {k: v - before_tc[k] for k, v in
                  tensor_core_launches().items() if v - before_tc[k]}
            steps[stacked] = (functools.partial(
                engine.train_step_affine, state, *batches[0]), launches, tc)
        want = {"flash_fwd": DEPTH, "flash_dq": DEPTH, "flash_dkv": DEPTH}
        say(f"scan: a bf16 step's launches, stacked {steps[True][1]} "
            f"(tensor-core {steps[True][2]}), unrolled {steps[False][1]}")
        if any(st[1] != want or st[2] != want for st in steps.values()):
            fail(f"scan: a bf16 step's launches are not {want}, all on the "
                 f"tensor cores")
        wall = {False: [], True: []}
        for _ in range(2):
            for stacked in (False, True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(SCAN_TIME_STEPS):
                    steps[stacked][0]()
                torch.cuda.synchronize()
                wall[stacked].append((time.perf_counter() - t0) * 1e3
                                     / SCAN_TIME_STEPS)
        dev = device_ms_tries({"stacked": steps[True][0],
                               "unrolled": steps[False][0]},
                              reps=SCAN_TRACE_REPS, tries=3)
        med = {k: spread(v)[0] for k, v in dev.items()}
        ratio = (med["stacked"] / med["unrolled"]
                 if med["stacked"] and med["unrolled"] else None)
        kernels = {}
        for stacked in (False, True):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    steps[stacked][0]()
                torch.cuda.synchronize()
            kernels[stacked] = {e.key[:40]: e.count // 2
                                for e in device_kernels(prof)}
        fewer = {k: n - kernels[True].get(k, 0)
                 for k, n in kernels[False].items()
                 if n != kernels[True].get(k, 0)}
        say(f"scan: a bf16 Adam step of the full-width vit at batch "
            f"{TRAIN_BATCH}: device ms stacked {fmt_ms(med['stacked'])}, "
            f"unrolled {fmt_ms(med['unrolled'])} (median of "
            f"{len(dev['stacked'])} traces of {SCAN_TRACE_REPS} steps; "
            f"ratio {ratio if ratio is None else round(ratio, 4)}); wall ms "
            f"stacked {[round(w, 3) for w in wall[True]]}, unrolled "
            f"{[round(w, 3) for w in wall[False]]} ({SCAN_TIME_STEPS} steps "
            f"twice, host clock); kernels a step stacked "
            f"{sum(kernels[True].values())}, unrolled "
            f"{sum(kernels[False].values())}; the unrolled step's surplus "
            f"by kernel {fewer}")
        out["vit_bf16"] = {"device": med, "wall": wall}
        del steps, engine, state
        torch.cuda.empty_cache()
        out["densenet"] = scan_densenet()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


def scan_densenet() -> dict:
    """(d): densenet121 at 224, stacked against unrolled."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.precision import PRESETS

    [batch] = scan_batches(1, SCAN_DN_BATCH, SEED + 46)
    grads = {}
    for prec, policy in (("f64", f64_policy()), ("f32", PRESETS["f32"])):
        for stacked in (False, True):
            engine, state = scan_engine("densenet", policy, stacked,
                                        optimizer="SGD")
            engine.train_step_affine(state, *batch)
            grads[prec, stacked] = unstacked(
                {n: p.grad for n, p in state.model.named_parameters()})
            del engine, state
    truth = grads["f64", False]
    f64_worst = max(((k, rel_err(grads["f64", True][k], v)[1])
                     for k, v in truth.items()), key=lambda t: t[1])
    mine = np.array([rel_err(grads["f32", True][k], v)[1]
                     for k, v in truth.items()])
    theirs = np.array([rel_err(grads["f32", False][k], v)[1]
                       for k, v in truth.items()])
    direct = max(rel_err(grads["f32", True][k], v)[1]
                 for k, v in grads["f32", False].items())
    say(f"scan: densenet121 at 224, one SGD step of {SCAN_DN_BATCH} rows "
        f"stacked (DenseBlockScan_0..3) against unrolled: f64 worst "
        f"{f64_worst[0]} rel err {f64_worst[1]:.3g} (tol "
        f"{TOL_SCAN_F64:g}); f32 stacked vs unrolled worst {direct:.3g}; "
        f"from the unrolled f64 step, median / max: stacked f32 "
        f"{np.median(mine):.3g} / {mine.max():.3g}, unrolled f32 "
        f"{np.median(theirs):.3g} / {theirs.max():.3g}")
    if f64_worst[1] > TOL_SCAN_F64 \
            or np.median(mine) > ZOO_CONDITIONED_FACTOR * np.median(theirs) \
            or mine.max() > ZOO_CONDITIONED_FACTOR * theirs.max():
        fail("scan: densenet121's stacked step disagrees with the "
             "unrolled one")
    del grads
    torch.cuda.empty_cache()
    [batch] = scan_batches(1, TRAIN_BATCH, SEED + 47)
    steps, peaks = {}, {}
    for stacked in (False, True):
        engine, state = scan_engine("densenet", PRESETS["bf16"], stacked)
        engine.train_step_affine(state, *batch)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        engine.train_step_affine(state, *batch)
        torch.cuda.synchronize()
        peaks[stacked] = (torch.cuda.max_memory_allocated(), held)
        steps[stacked] = functools.partial(engine.train_step_affine, state,
                                           *batch)
    dev = device_ms_tries({"stacked": steps[True],
                           "unrolled": steps[False]},
                          reps=SCAN_DN_TRACE_REPS, tries=1)
    med = {k: spread(v)[0] for k, v in dev.items()}
    own = {k: (p - h) / 2 ** 20 for k, (p, h) in peaks.items()}
    say(f"scan: densenet121 at 224, a bf16 Adam step at batch "
        f"{TRAIN_BATCH}: device ms stacked {fmt_ms(med['stacked'])}, "
        f"unrolled {fmt_ms(med['unrolled'])} ({SCAN_DN_TRACE_REPS} steps, "
        f"1 trace); the step's own peak max_memory_allocated above what "
        f"it held: stacked {own[True]:.1f} MiB, unrolled {own[False]:.1f} "
        f"MiB (peaks {peaks[True][0]} and {peaks[False][0]} bytes)")
    return {"f64": f64_worst[1], "device": med, "peak_mib": own}


def scan_cli() -> dict:
    """(c), on a thread of its own: ``train --model vit --attention flash
    --scan-layers -e 1`` on phase 22's corpus (K1-K3 by phase 6's
    formula, all on the tensor cores; the best file in the scan layout),
    then ``test -f`` of it on a plain config (converted at load) equal to
    an in-process eval, and, in process, ``serve --scan-layers``'s
    replica answering one wave (``tier_serve``)."""
    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.models import scan

    write_zoo_data()
    rsl = os.path.join(WORK, "p45_rsl")
    [(wall, log)] = finish_all([start_cli(SCAN_ARGS, rsl, data=ZOO_DATA)])
    launches, steps, evals = parse_launches(log, "train")
    tensor_core = parse_tensor_core_launches(log, "train")
    want = {"flash_fwd": DEPTH * (steps + evals), "flash_dq": DEPTH * steps,
            "flash_dkv": DEPTH * steps, "conv_dw": 0}
    best = os.path.join(rsl, "bestmodel-mnist-vit.ckpt")
    layout = scan.params_layout(ckpt.read_checkpoint(best)["state"]
                                ["params"])
    say(f"scan: train --scan-layers -e 1 in {wall:.1f}s of process wall: "
        f"{steps} steps and {evals} eval batches, launches {launches}, on "
        f"the tensor cores {tensor_core}, formula {want}; the file's layout "
        f"{layout}")
    if not steps or launches != want or tensor_core != want \
            or layout != "scan":
        fail("scan: the stacked vit's train launches or file disagree")
    test_run = start_cli(["test", "-f", best, "--attention", "flash"],
                         os.path.join(WORK, "p45_test"), data=ZOO_DATA)
    try:
        tier_serve("scan", best, ["--attention", "flash", "--scan-layers"],
                   dict(attention="flash", scan_layers=True))
        [(_, test_log)] = finish_all([test_run])
    finally:
        if test_run[3].poll() is None:
            test_run[3].kill()
            test_run[3].wait()
    acc_cli = re.search(r"Time: \d+m \d+s, Acc: ([\d.]+)%",
                        test_log).group(1)
    converted = ("checkpoint params converted: scan -> blocks block "
                 "layout") in test_log
    t_launches, _, t_evals = parse_launches(test_log, "test")
    acc_here, correct, n = eval_accuracy(best, "vit", ZOO_DATA)
    say(f"scan: `test -f` on a plain config {acc_cli}% (scan -> blocks at "
        f"load: {converted}; {t_evals} eval batches, launches "
        f"{t_launches}); in-process eval {acc_here}% ({correct}/{n})")
    if not converted or acc_cli != acc_here \
            or t_launches["flash_fwd"] != DEPTH * t_evals:
        fail("scan: the test of the stacked vit's file disagrees with the "
             "in-process eval")
    return {"steps": steps, "evals": evals, "acc": acc_here}


# -- phase 46: --ckpt-format orbax -----------------------------------------

# (a): the zero world saves a directory after P46_SAVED_STEPS of its
# P43_STEPS steps; one process restores it and takes the last step
P46_SAVED_STEPS = 2
P46_DIR = os.path.join(WORK, "p46_zero.ckpt")
# The prediction (PERF.md, before the first run on the card): the vit at
# M = 2 under ZeRO holds 807,178 parameters, 786,432 of them in sharded
# tensors (a rank 393,216) and 20,746 replicated; a directory holds each
# once, in f32: (a)'s SGD state twice that (the momentum), (b)'s Adam
# state three times (both moments; Adam's 0-d step counts beside)
P46_PARAMS, P46_SHARDED = 807178, 786432
P46_TRAIN = ["train", "--model", "vit", "--attention", "flash",
             "--model-parallel", "2", "--ckpt-format", "orbax", "-e", "1",
             "--telemetry"]
P46_ASYNC = ["train", "--model", "vit", "--attention", "flash", "--debug",
             "--ckpt-format", "orbax", "-e", "1"]
P46_REPS = 3            # the in-process saves and loads timed, each format


def dir_payload(path: str, copies: int, tag: str) -> dict:
    """A checkpoint directory written by two ranks: each chunk of a
    sharded tensor in its own rank's file, every element once; each
    rank's payload bytes printed against the prediction for ``copies``
    f32 copies of the state (parameters and the optimizer's moments)."""
    from distributedpytorch_tpu_torch import dcp_io

    state_dir = os.path.join(path, "state")
    meta = dcp_io.dcp.FileSystemReader(state_dir).read_metadata()
    held, own, misplaced = {}, {0: 0, 1: 0}, []
    for fqn, entry in meta.state_dict_metadata.items():
        if not dcp_io.is_tensor(entry) or not len(entry.size):
            continue            # values, and Adam's 0-d step counts
        for c in entry.chunks:
            where = meta.storage_data[
                dcp_io.MetadataIndex(fqn, c.offsets)].relative_path
            n = math.prod(c.sizes)
            held[where] = held.get(where, 0) + n
            if len(entry.chunks) > 1:
                rank = int(any(c.offsets))
                own[rank] += n
                if where != f"__{rank}_0.distcp":
                    misplaced.append(fqn)
    files = sorted(os.listdir(state_dir))
    sizes = {f: os.path.getsize(os.path.join(state_dir, f)) for f in files}
    mine = copies * P46_SHARDED // 2
    repl = copies * (P46_PARAMS - P46_SHARDED)
    say(f"{tag}: {path} holds {files}: bytes {sizes}; elements by file "
        f"{held} (of them the ranks' own slices {own}); predicted a rank "
        f"{4 * mine} B of its slices and a share of {4 * repl} B "
        f"replicated, {4 * copies * P46_PARAMS} B in all")
    if misplaced or files != [".metadata", "__0_0.distcp", "__1_0.distcp"] \
            or own != {0: mine, 1: mine} \
            or sum(held.values()) != copies * P46_PARAMS:
        fail(f"{tag}: the directory does not hold each rank's slices once "
             f"(misplaced {misplaced[:4]})")
    return {"bytes": sizes, "elements": held}


def orbax_world(ranks: list, saved: list, base: dict) -> dict:
    """Phase 46 (a): the directory that 43's zero world wrote after
    P46_SAVED_STEPS of its steps with no gather (the child's
    ``Placement.join`` and ``full_state`` raise) holds each rank's slices
    once (``dir_payload``); the world restores it, each rank its slices
    with no gather either, to the state it saved (``saved``: each rank's
    (saving, restoring) results); one process restores it, with no
    placement, and takes the last step: its parameters, momentum and
    counters bit-identical to the world's after P43_STEPS."""
    import torch

    out = dir_payload(P46_DIR, 2, "orbax (a)")
    back = []
    for rank, (wrote, read) in enumerate(saved):
        params, opt = read["resumed"]
        back.append(sum(not torch.equal(v, wrote["state"][k])
                        for k, v in params.items()) + sum(
            not torch.equal(st["momentum_buffer"], wrote["opt_state"][
                "state"][i]["momentum_buffer"])
            for i, st in opt["state"].items()))
    say(f"orbax (a): the zero world restored its directory, each rank "
        f"reading its slices with no gather: tensors differing from the "
        f"saved state by rank {back}")
    if any(back):
        fail("orbax (a): the placed restore differs from the saved state")
    [[one]] = run_worlds([ring_world(
        "vit", dict(base, steps=base["steps"][P46_SAVED_STEPS:],
                    resume=P46_DIR, peak_memory=False), 1, "p46_one",
        "--model-parallel", "1")])
    world = ranks[0]
    differ = [k for k, v in world["state"].items()
              if not torch.equal(v, one["state"][k])]
    differ += [f"momentum {i}" for i, st in world["opt_state"][
        "state"].items() if not torch.equal(
            st["momentum_buffer"],
            one["opt_state"]["state"][i]["momentum_buffer"])]
    say(f"orbax (a): restored in one process from the zero world's "
        f"directory after {P46_SAVED_STEPS} of {P43_STEPS} f32 SGD steps, "
        f"then the last step: {len(differ)} of "
        f"{len(world['state']) + len(world['opt_state']['state'])} tensors "
        f"(parameters, momentum) differ from the world's; counters "
        f"{one['counters']} vs {world['counters']}")
    if differ or one["counters"] != world["counters"]:
        fail(f"orbax (a): the resumed step differs from the world's: "
             f"{differ[:5]}")
    return out


def orbax_times(best: str) -> dict:
    """In process, one rank: the full-width vit with the Adam state of
    ``best`` on the card, saved synchronously and loaded back (optimizer
    state too) as a directory and as a file, P46_REPS times each; the
    median seconds (host clock, the card synchronized) printed."""
    import statistics

    import torch

    from distributedpytorch_tpu_torch import checkpoint as ckpt
    from distributedpytorch_tpu_torch.precision import PRESETS

    _, state = scan_engine("vit", PRESETS["bf16"], False)
    ckpt.load_checkpoint(best, state.model, state.optimizer,
                         train_state=state)
    out = {}
    for fmt, save in (("orbax", ckpt.save_directory),
                      ("msgpack", ckpt.save_checkpoint)):
        path = os.path.join(WORK, f"p46_time_{fmt}.ckpt")
        saves, loads = [], []
        for _ in range(P46_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            save(path, "vit", state.model, 0, 1.0, state.optimizer,
                 int(state.step), int(state.updates))
            saves.append(time.perf_counter() - t)
            t = time.perf_counter()
            ckpt.load_checkpoint(path, state.model, state.optimizer,
                                 train_state=state)
            torch.cuda.synchronize()
            loads.append(time.perf_counter() - t)
        out[fmt] = (statistics.median(saves), statistics.median(loads))
    say(f"orbax (b): one process, the vit's Adam state: a synchronous "
        f"save / a load (median of {P46_REPS}, s): directory "
        f"{out['orbax'][0]:.4f} / {out['orbax'][1]:.4f}, file "
        f"{out['msgpack'][0]:.4f} / {out['msgpack'][1]:.4f}")
    return out


def orbax_cli() -> dict:
    """Phase 46 (b) and (c), on 45 (c)'s thread after it: ``train
    --model-parallel 2 --ckpt-format orbax -e 1`` under torchrun on phase
    22's corpus (K1-K3 on each rank by phase 6's formula, all on the
    tensor cores; its directories of each rank's slices), then at once
    ``test -f`` of the best directory in one process (equal to an
    in-process eval), a 1-process ``train -f`` resume of it and, in
    process, ``serve -f``'s replica answering one wave (``tier_serve``);
    beside the train, 1-process trainings with and without
    ``--ckpt-async``, whose directories read back bit-identical."""
    write_zoo_data()
    rsl = os.path.join(WORK, "p46_rsl")
    sync_rsl, async_rsl = (os.path.join(WORK, f"p46_{n}")
                           for n in ("sync", "async"))
    (wall, log), _, _ = finish_all([
        start_cli(P46_TRAIN, rsl, launcher=TORCHRUN2, data=ZOO_DATA),
        start_cli(P46_ASYNC, sync_rsl, data=ZOO_DATA),
        start_cli(P46_ASYNC + ["--ckpt-async"], async_rsl, data=ZOO_DATA)])
    line = ("mesh: data 1 x model 2, parameters placed over the model group "
            "on gloo")
    _, steps, evals = parse_launches(log, "train")
    want = {"flash_fwd": DEPTH * (steps + evals), "flash_dq": DEPTH * steps,
            "flash_dkv": DEPTH * steps, "conv_dw": 0}
    ranks = []
    for rank in (0, 1):
        [ev] = [e["attrs"] for e in rank_events(rsl, rank,
                                                "kernel_launches")]
        ranks.append((ev["launches"], ev["tensor_core"]))
    say(f"orbax (b): train --model-parallel 2 --ckpt-format orbax -e 1 on "
        f"2 ranks in {wall:.1f}s of process wall: {steps} steps and {evals} "
        f"eval batches; launches by rank {[r[0] for r in ranks]}, on the "
        f"tensor cores {[r[1] for r in ranks]}; formula {want}")
    if line not in log or not steps or any(
            got != {k: want.get(k, 0) for k in got}
            or {k: tc[k] for k in want} != want for got, tc in ranks):
        fail("orbax (b): the placed train's mesh line or launches disagree")
    best = os.path.join(rsl, "bestmodel-mnist-vit.ckpt")
    out = {"steps": steps, "evals": evals, "launches": ranks[0][0],
           "payload": dir_payload(best, 3, "orbax (b)")}
    test_run = start_cli(["test", "-f", best, "--attention", "flash"],
                         os.path.join(WORK, "p46_test"), data=ZOO_DATA)
    resume_run = start_cli(["train", "-f", best, "--model", "vit",
                            "--attention", "flash", "-e", "2"],
                           os.path.join(WORK, "p46_resume"), data=ZOO_DATA)
    try:
        tier_serve("orbax (b)", best, ["--attention", "flash",
                                       "--ckpt-format", "orbax"],
                   dict(attention="flash"))
        out["times"] = orbax_times(best)
        (_, test_log), (_, resume_log) = finish_all([test_run, resume_run])
    finally:
        for run in (test_run, resume_run):
            if run[3].poll() is None:
                run[3].kill()
                run[3].wait()
    acc_cli = re.search(r"Time: \d+m \d+s, Acc: ([\d.]+)%",
                        test_log).group(1)
    t_launches, _, t_evals = parse_launches(test_log, "test")
    acc_here, correct, n = eval_accuracy(best, "vit", ZOO_DATA)
    r_launches, r_steps, _ = parse_launches(resume_log, "train")
    loaded = "epoch:0001: model loaded from" in resume_log
    say(f"orbax (b): `test -f` of the directory in one process {acc_cli}% "
        f"({t_evals} eval batches, launches {t_launches}); in-process eval "
        f"{acc_here}% ({correct}/{n}); 1-process `train -f` resumed: "
        f"{loaded}, {r_steps} steps, launches {r_launches}")
    if acc_cli != acc_here or t_launches["flash_fwd"] != DEPTH * t_evals \
            or not loaded or not r_steps \
            or r_launches["flash_dq"] != DEPTH * r_steps:
        fail("orbax (b): the test or the resume of the directory disagrees")
    compared = {}
    for name in ("checkpoint-mnist-vit-000.ckpt", "bestmodel-mnist-vit.ckpt"):
        n_tensors, differ = state_tensors_differ(
            os.path.join(sync_rsl, name), os.path.join(async_rsl, name))
        compared[name] = (n_tensors, differ)
    leftover = [f for r in (sync_rsl, async_rsl) for f in os.listdir(r)
                if f.endswith(".tmp")]
    say(f"orbax (c): --ckpt-async against the synchronous save, 1 process: "
        f"{ {k: (v[0], len(v[1])) for k, v in compared.items()} } (tensors "
        f"and counts, differing) read back from the directories; leftover "
        f".tmp {leftover}")
    if leftover or any(d or not t for t, d in compared.values()):
        fail(f"orbax (c): the asynchronous directories differ: {compared}")
    return out


def start_placement_phase(placement: bool = True,
                          pipeline: bool = True,
                          scan_layers: bool = True,
                          orbax: bool = True) -> dict:
    """Phases 43 and 44 (``placement``, ``pipeline``: which of them) on a
    thread of their own beside the other CLI phases, 44 after 43, and
    45 (c) (``scan_layers``), then 46 (b) and (c) (``orbax``), on a second
    one (their processes share the card; nothing of them is timed; 45 (b)
    and 46 (a) run in 43's zero world): a failure (``fail``'s exit) is
    kept for ``finish_placement_phase``."""
    write_zoo_data()        # the threads' CLI runs read it, from here on
    pending = {"t0": time.perf_counter()}

    def body():
        try:
            if placement:
                pending["worlds"] = placement_worlds(scan_layers, orbax)
                pending["cli"] = placement_cli()
            pending["t44"] = time.perf_counter()
            if pipeline:
                pending["pipeline"] = pipeline_worlds()
                pending["pipeline_cli"] = pipeline_cli()
            pending["t_end"] = time.perf_counter()
        except BaseException as e:       # fail()'s SystemExit included
            pending["error"] = e

    def cli_body():
        try:
            if scan_layers:
                pending["scan_cli"] = scan_cli()
            pending["t45"] = time.perf_counter()
            if orbax:
                pending["orbax_cli"] = orbax_cli()
            pending["t46"] = time.perf_counter()
        except BaseException as e:
            pending["cli_error"] = e

    pending["threads"] = [threading.Thread(target=body, name="phase43",
                                           daemon=True)]
    if scan_layers or orbax:
        pending["threads"].append(threading.Thread(
            target=cli_body, name="phase45_46", daemon=True))
    for thread in pending["threads"]:
        thread.start()
    return pending


def finish_placement_phase(pending: dict, card: str) -> None:
    t = time.perf_counter()
    for thread in pending["threads"]:
        thread.join(900)
    now = time.perf_counter()
    wall = pending.get("t_end", now) - pending["t0"]
    split = pending.get("t44", now) - pending["t0"]
    scan_s = pending.get("t45", pending["t0"]) - pending["t0"]
    orbax_s = pending.get("t46", pending["t0"]) - pending["t0"] - scan_s
    say(f"chip_smoke: placement and pipeline ran {wall:.1f}s beside the "
        f"other phases (43 {split:.1f}s, 44 {wall - split:.1f}s), 45's CLI "
        f"runs {scan_s:.1f}s then 46's {orbax_s:.1f}s on a thread of their "
        f"own; the main thread waited {now - t:.1f}s for them ({card})")
    blocking = {}
    for fmt, rsl in (("msgpack", "p43_zero_rsl"), ("orbax", "p46_rsl")):
        if os.path.exists(os.path.join(WORK, rsl, "goodput-rank1.json")):
            blocking[fmt] = [goodput_categories(os.path.join(WORK, rsl),
                                                rank).get("ckpt_blocking")
                             for rank in (0, 1)]
    if blocking:
        say(f"chip_smoke: the placed vit's train -e 1 on 2 ranks (2 saves): "
            f"goodput ckpt_blocking s by rank {blocking} ({card})")
    errors = [pending[k] for k in ("error", "cli_error") if k in pending]
    if errors or "t_end" not in pending or (
            len(pending["threads"]) > 1 and "t46" not in pending):
        fail(f"phase 43, 44, 45 or 46 did not pass: {errors!r}")


def parse_phases(argv) -> set:
    """The phases to run: every one (None) with no argument, else those
    of ``--phases 10,12`` plus phase 1 and the phases they need."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Smoke test of the PyTorch/CUDA port on one GPU. With "
                    "no argument every phase runs and the last line is the "
                    "ok line; --phases runs a subset and never prints it.")
    ap.add_argument("--phases", help="comma-separated phase numbers of the "
                    f"docstring's list, 2..{LAST_PHASE - 1} (1 always runs)")
    args = ap.parse_args(argv)
    if args.phases is None:
        return None
    try:
        chosen = {int(p) for p in args.phases.split(",") if p.strip()}
    except ValueError:
        ap.error(f"--phases takes comma-separated integers, got "
                 f"{args.phases!r}")
    bad = sorted(p for p in chosen if not 1 <= p < LAST_PHASE)
    if bad:
        ap.error(f"no phase {bad}: phases are 1..{LAST_PHASE - 1}")
    chosen.add(1)
    for p in sorted(chosen):
        chosen |= PHASE_NEEDS.get(p, set())
    return chosen


# Intra-op CPU threads of each child process (OMP_NUM_THREADS): a dozen
# CLI trainings, worlds and replicas run at once beside this process on
# the card's host, and a torch process starts one thread per core.
CHILD_THREADS = 2


def limit_child_threads() -> None:
    """Every child process starts with CHILD_THREADS intra-op threads (an
    OMP_NUM_THREADS already set is kept); this process keeps its own
    count, fixed before the variable is set."""
    import torch

    torch.set_num_threads(torch.get_num_threads())
    os.environ.setdefault("OMP_NUM_THREADS", str(CHILD_THREADS))


def use_bytecode_cache() -> None:
    """Caches the bytecode of every module that this run and its child
    processes import under build/pycache in the checkout.  A Python whose
    packages carry no bytecode (a read-only or freshly copied
    site-packages) otherwise compiles torch's sources anew in each of the
    run's some 30 processes."""
    prefix = os.path.join(ROOT, "build", "pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False


def main(argv=None) -> int:
    chosen = parse_phases(sys.argv[1:] if argv is None else argv)
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    try:
        import distributedpytorch_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port's package is not beside chip_smoke.py: {e}")
    use_bytecode_cache()
    limit_child_threads()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    def want(n: int) -> bool:
        return chosen is None or n in chosen

    def run(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        say(f"chip_smoke: {fn.__name__} took {time.perf_counter() - t:.1f}s")
        return out

    def need_rows(names, where):
        for name in names:
            missing = [k for k in ("ms", "plain_ms", "library_ms")
                       if main_rows[name][k] is None]
            if missing:
                fail(f"torch.profiler returned no device events for "
                     f"{missing} of {name} at {where}")

    card = run(phase_environment)
    main_rows, launches, tc_launches = {}, {}, {}
    if want(2):
        main_rows["flash_fwd"] = run(phase_kernel)[MAIN_ATTN]
        need_rows(["flash_fwd"], "the main path's shape (64, 49, 4, 32) "
                                 "bf16")
    if want(4):
        bwd_rows = run(phase_bwd_kernels)
        for name in ("flash_dq", "flash_dkv"):
            main_rows[name] = bwd_rows[(name,) + MAIN_ATTN]
        need_rows(["flash_dq", "flash_dkv"], "the main path's shape "
                                             "(64, 49, 4, 32) bf16")
    serve_launches = None
    if want(3):
        serve_launches = run(phase_main_path, "cuda")
        run(phase_profile, os.path.join(WORK, "rsl",
                                        "bestmodel-mnist-vit.ckpt"))
    if want(5):
        run(phase_train_step_parity)
    if want(6):
        train_launches, train_tc, best = run(phase_train)
        for name in ("flash_fwd", "flash_dq", "flash_dkv"):
            if train_launches[name] <= 0:
                fail(f"kernel {name} was not launched on the train path")
        launches.update(train_launches)
        # phase 6 fails unless every K1, K2 and K3 took the tensor cores
        tc_launches.update(flash_fwd=train_tc["flash_fwd"],
                           flash_dq=train_tc["flash_dq"],
                           flash_dkv=train_tc["flash_dkv"])
    if want(7):
        run(phase_resume_and_test, best)
    if want(9):
        run(phase_train_profile)
    if want(10):
        main_rows["conv_dw"] = conv_dw_main_row(run(phase_conv_dw))
    if want(11):
        run(phase_cnn_step_parity)
    if want(12):
        launches["conv_dw"] = run(phase_cnn_epoch)
        # phase 12 fails unless every one of them took the tensor cores
        tc_launches["conv_dw"] = launches["conv_dw"]
    if want(13):
        run(phase_reference_job)
    if want(14):
        run(phase_ddp_one_card)
    if want(15):
        run(phase_cnn_profile)
    if want(16):
        ring_rows = run(phase_ring_kernels)
        for name in ("flash_fwd_pos", "flash_dq_pos", "flash_dkv_pos"):
            main_rows[name] = ring_rows[(name,) + RING_MAIN]
        need_rows(["flash_fwd_pos", "flash_dq_pos", "flash_dkv_pos"],
                  "the ring's main shape")
    if want(17):
        run(phase_ring_op)
    f16_worlds = None
    if want(19):
        f16_worlds = run(phase_ring_steps, want(33))
    if want(20):
        run(phase_ring_profile)
    # 23 and 24 time steps and kernels: they run before 21 and 22, and from
    # there on nothing is timed for the kernels line or PERF.md, so the
    # exit test's five trainings run beside phases 21, 22 and 25-30, and
    # the CLI runs of 27, 29 and 30 beside 25, 26 and 28
    if want(23):
        run(phase_zoo_profile)
    if want(24):
        main_rows.update(run(phase_f16_kernels))
    if want(32):
        main_rows.update(run(phase_f16_ring_kernels))
    if want(35):
        run(phase_graphs)
    if want(36):
        run(phase_stream)
    if want(37):
        run(phase_remat)
    if want(38):
        run(phase_observability_host)
    if want(42):
        run(phase_moe)
    if want(45):
        run(phase_scan)
    started = []

    def ahead(phase: int, start):
        runs = start() if want(phase) else None
        started.extend([runs] if isinstance(runs, tuple) else runs or [])
        return runs

    exit_runs = ahead(31, start_exit_test)
    obs_pending = None
    try:
        # 38's CLI runs (two of them build the kernels cold) beside 21-36
        if want(38):
            obs_pending = start_observability_cli()
            started.extend([obs_pending["nocache"], obs_pending["plain"]])
        # 40's world of replicas on a thread of its own beside 21 (in
        # process, small on the card), so that it is done before 39's
        # thread starts and the two do not lengthen the run's tail
        serve_pending = (start_serve_world_phase(card, want(41))
                         if want(40) else None)
        if want(21):
            run(phase_zoo_parity)
        if want(22):
            run(phase_zoo_main_path)
        f16_run = ahead(27, start_f16_train)
        bf16_run = ahead(29, start_bf16_full)
        async_runs = ahead(30, start_ckpt_async)
        ring_run = ahead(18, start_ring_train)
        f16_ring_run = ahead(33, start_f16_ring_train)
        graph_cli_runs = ahead(35, start_graph_cli)
        jax_resume_runs = ahead(34, start_jax_resume)
        stream_runs = ahead(36, start_stream_cli)
        moe_run = ahead(42, start_moe_cli)
        # 43's worlds and CLI runs, then 44's, on a thread of their own,
        # and 45's CLI runs, then 46's, on another
        placement_pending = (start_placement_phase(want(43), want(44),
                                                   want(45), want(46))
                             if want(43) or want(44) or want(45) else None)
        # 39's faulted, elastic and stalled worlds on a thread of its own
        elastic_pending = start_elastic_phase(card) if want(39) else None
        if want(25):
            run(phase_f16_step)
        if want(26):
            run(phase_f16_skip)
        if want(28):
            run(phase_grad_accum)
        # the second processes of 29 and 30 run beside 27's
        bf16_pending = (start_bf16_full_test(bf16_run) if want(29)
                        else None)
        async_pending = (start_ckpt_async_resume(async_runs) if want(30)
                         else None)
        started.extend(p["run"] for p in (bf16_pending, async_pending)
                       if p is not None)
        # phase 36's tests run beside 18's and 27-35's checks
        stream_pending = (run(phase_stream_cli, stream_runs) if want(36)
                          else None)
        if stream_pending is not None:
            started.extend(stream_pending["tests"])
        if want(18):
            ring_launches, ring_tc = run(phase_ring_train, ring_run)
            for name in ("flash_fwd_pos", "flash_dq_pos", "flash_dkv_pos"):
                if ring_launches[name] <= 0:
                    fail(f"kernel {name} was not launched on the ring train "
                         f"path")
            launches.update(ring_launches)
            # phase 18 fails unless every K4, K2p and K3p took the tensor
            # cores
            tc_launches.update(ring_tc)
        if want(27):
            launches.update(run(phase_f16_main_path, f16_run))
            # phase 27 fails unless every one of them took the tensor cores
            tc_launches.update({k: v for k, v in launches.items()
                                if k.endswith("_f16")})
        if want(29):
            run(phase_bf16_full, bf16_pending)
        if want(30):
            run(phase_ckpt_async, async_pending)
        if want(31):
            run(phase_exit_test, exit_runs)
        if want(33):
            f16_ring, f16_ring_tc = run(phase_f16_ring, f16_ring_run,
                                        f16_worlds)
            launches.update(f16_ring)
            tc_launches.update(f16_ring_tc)
        if want(34):
            run(phase_jax_resume, jax_resume_runs)
        if want(35):
            run(phase_graph_cli, graph_cli_runs)
        if want(36):
            run(phase_stream_test, stream_pending)
        if want(38):
            run(phase_observability_cli, obs_pending)
        if want(42):
            run(phase_moe_cli, moe_run)
        if placement_pending is not None:
            finish_placement_phase(placement_pending, card)
        if want(39):
            finish_elastic_phase(elastic_pending)
        if want(40):
            finish_serve_world_phase(serve_pending, want(41))
    finally:
        if obs_pending is not None:
            with obs_pending["lock"]:
                obs_pending["stop"] = True
                started.extend(obs_pending["runs"])
        for proc in [p for *_, p, _ in started] + ELASTIC_PROCS:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches.get(name),
                **main_rows[name]} for name, source, replaces in
               KERNELS + F16_KERNELS
               if chosen is None or name in main_rows]
    for row in kernels:
        if row["name"] == "flash_fwd" and serve_launches is not None:
            row["serve_launches"] = serve_launches
        if row["name"] in tc_launches:
            row["tensor_core_launches"] = tc_launches[row["name"]]
    if chosen is not None:
        say(card)
        say(json.dumps({"kernels": kernels}))
        say(f"chip_smoke: partial run: phases {sorted(chosen)} passed in "
            f"{time.perf_counter() - t0:.1f}s; skipped phases "
            f"{sorted(set(range(1, LAST_PHASE + 1)) - chosen)}; no ok line "
            f"(the full run is python3 chip_smoke.py with no argument)")
        return 0
    say(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}s")
    say(card)               # name, power limit: beside the numbers above
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
