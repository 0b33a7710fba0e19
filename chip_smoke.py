#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on the card.

    python3 chip_smoke.py

Drives the port's fourteen paths end to end on the first CUDA device
(the last on a gang of ranks over the machine's cards), with random
weights from a seed:

- the imperative API: the Gluon MLP loop of
  ``examples/train_mnist_mlp.py``'s ``_run`` (BASELINE config 1) on card
  NDArrays at its width (784-128-64-10, Xavier, SGD 0.1, batch 256 of
  MNIST-shaped ``RandomState`` data), ``nd.FusedNormReluConv`` at
  ResNet-50's first-stage 3x3 and one ``gluon.Trainer`` step of
  ResNet-50;
- ``hybridize()`` (BASELINE config 2): ``resnet50_v1(fused=True,
  layout="NHWC")`` cast to bf16 as ``bench_resnet`` casts it, with
  ``net.hybridize()``, trained by ``gluon.Trainer`` (SGD 0.1 / 0.9 /
  1e-4, batch 256 of 224x224x3, 1000 classes) through its captured
  forward and backward graphs, and the MLP above hybridized;
- the input pipeline: ``examples/train_mnist_mlp.py``'s ``main()`` as
  written (``gluon.data.DataLoader`` over the synthetic MNIST with
  ``ToTensor``), and packed RecordIO records through the
  ``io.ImageRecordIter`` of ``examples/train_resnet_fused.py --rec`` and
  ``parallel.DevicePrefetcher`` into the captured bf16 ``TrainStep`` of
  ``resnet50_v1(fused=True, layout="NHWC")`` at batch 256 of 224x224x3;
- LLM serving at the width of ``bench.py llm`` on an accelerator (vocab
  4096, 4 layers, 8 heads x 64, d_ff 2048; 64 slots, 512 pages x 64
  tokens; buckets (1, 2, 4) x (32, 64); 64 new tokens; prompts of 4-60
  tokens), fused and disaggregated (``prefill_workers``);
- the ResNet-50 v1 training step as ``bench.py``'s ``bench_resnet`` runs
  it (NHWC, ``fused=True``, bf16 cast with f32 master weights, SGD 0.1 /
  0.9 / 1e-4, batch 256 of 224x224x3, 1000 classes), full width and
  depth, and the same step checkpointed, killed and resumed: in place
  in one process, and as ``mxnet_tpu_torch/elastic_worker.py`` under
  ``elastic.Supervisor`` (10 steps deep);
- the BERT-base pretraining step as ``bench_bert`` runs it (vocab 30522,
  12 layers, 768 units, 12 heads, hidden 3072, dropout 0.1, masked-LM +
  NSP loss, bf16 cast with f32 master weights, LAMB 1e-3 / wd 0.01,
  batch 64 x 128 with 20 masked positions of ``RandomState(0)`` data),
  full width and depth, with ``attention_impl="flash"``.  Every row is
  full length, so ``valid_length`` is None (the same function as
  bench_bert's ``valid_length = 128``; the flash path takes no mask);
- the LSTM language model as ``bench_lstm`` trains it (BASELINE config
  3: ``rnn_lm``, vocab 10000, embed 650, 2 LSTM layers of 650, dropout
  0.5, bf16 cast, SGD at 20 / batch, batch 64 x bptt 35 of
  ``RandomState(0)`` ids) and ``examples/word_language_model.py``'s
  ``main()`` as written;
- SSD-512 as ``bench_ssd`` trains it (BASELINE config 5:
  ``ssd_512_resnet50_v1(classes=20)``, bf16 cast, ``MultiBoxTarget`` and
  ``SSDMultiBoxLoss`` in the loss, SGD 1e-3 / 0.9 / 5e-4, batch 16 of
  3x512x512 images with 1-3 boxes each), full width and depth.  Neither
  of these two paths reaches a hand-written kernel: the JAX package has
  no Pallas kernel on them (the recurrence is cuDNN's RNN);
- the symbolic API: ``resnet50_v1`` built from ``mx.sym`` layers
  (NCHW, f32) trained by ``mod.Module.fit`` (SGD 0.1 / 0.9 / 1e-4,
  batch 64 of 3x224x224 from ``RandomState(0)`` through
  ``io.NDArrayIter``), whose executor runs each step as a captured
  forward and backward pair; the fused-conv and flash kernels reached
  through ``mx.sym`` nodes; ``examples/module_symbolic_mnist.py`` and
  ``examples/bucketing_lstm.py`` as written;
- classifier serving: ``examples/serve_mnist.py`` as written; the fused
  bf16 ResNet-50 of ``bench_resnet`` (full width, 1000 classes) behind
  ``parallel.EvalStep`` and ``serving.InferenceServer`` at buckets (1,
  4, 16, 64); the symbolic ResNet-50 above served by
  ``serving.module_apply`` in f32 and int8 at buckets (1, 8, 64); the
  MLP fleet of ``examples/serve_fleet_mnist.py`` (3 replicas sharing one
  ``graphs.captured`` forward, ``WeightUpdater``, ``FleetAutoscaler``);
- the rest of one card's training surface: BERT-base pretraining in the
  form GluonNLP's ``run_pretraining.py`` uses (f32 parameters,
  ``amp.init("float16")``, ``amp.init_trainer``, ``amp.scale_loss``, a
  hybridized ``BERTModel(attention_impl="flash")`` under
  ``gluon.Trainer`` with LAMB, ``bench_bert``'s width), so that the f32
  model reaches the bf16 flash kernels through AMP's casts;
  ``gluon.contrib.estimator.Estimator.fit`` on BASELINE config 2's
  hybridized fused ResNet-50; ``contrib.quantization.quantize_net`` on
  ``resnet50_v1`` (int8 GEMMs on cuBLASLt); the samplers, ``foreach`` /
  ``while_loop`` / ``cond`` and a ``CustomOp``;
- the 2.x frontend: the same BERT-base in the MXNet 2.0 / GluonNLP 1.x
  form (``npx.set_np()``, inputs built with ``mx.np``), so that it
  reaches the bf16 flash kernels with ``mx.np`` arrays; MXNet 1.x's
  sparse-gradient matrix factorisation at MovieLens-10M's counts
  (``Embedding(sparse_grad=True)``, the lazy SGD); ``sparse.dot`` of a
  CSR batch of Criteo's shape; ResNet-50 v1 through ``mx.onnx`` and
  back;
- data parallelism: the fused ResNet-50 and BERT-base above on a gang of
  ranks (one a card over NCCL, or two sharing one card over gloo)
  through ``TrainStep(mesh=make_mesh())`` with f32, bf16 and int8
  gradient exchange and ``gluon.Trainer(kvstore="dist_sync_device")``,
  and ``examples/dist_train.py`` as written;
- the C ABI: a C program linked against ``libmxtpu_capi`` trains the
  MLP of the JAX package's C client and reaches all seven kernels
  through ``mxtpu_invoke`` at the shapes above.

Phases, each of which fails the run (each prints its wall time):

1. card report (name, count, ``nvidia-smi`` name and power limit);
2. build every CUDA kernel from the sources in the checkout (one
   ``nvcc`` per source, all started together);
3. imperative, (b) first (its backward is then the first CUDA work of
   autograd's worker thread, as in a fresh user script): (a) the MLP
   loop on card NDArrays — 5 steps held against the same steps on the
   host from the same parameters (mean losses within 1e-4 relative),
   then 2 warm-up and 50 timed steps (the loss falls), one step under
   ``torch.profiler`` (busy share) and the host time of one ``nd.add``
   dispatch on [256, 128] over 1000 calls, with ``storage``'s
   accounting on and off in turns; (b)
   ``nd.FusedNormReluConv`` on [256, 56, 56, 64] -> 64, 3x3, bf16,
   forward and ``backward()`` under ``record()``: one launch of each
   fused kernel, counted from 0, and every output and gradient held
   against the plain versions at phase 7's tolerances; (c) one
   ``gluon.Trainer`` step against one ``TrainStep(capture=False)`` step
   of fused ResNet-50, f32, batch 32, SGD 0.1 / 0.9 / 1e-4, from the
   same parameters, every parameter held leaf by leaf as in 8 (the
   floor: the Trainer step on the host CPU);
3b. hybridize: (a) the MLP loop of 3(a) with ``net.hybridize()`` — 5
   steps held against the eager loop from the same parameters (the same
   bound as 3(a)), then 2 warm-up and 50 timed steps, twice, in turns
   with the eager loop's (eager, hybridized, hybridized, eager), a
   profiled step and the units held (one: a forward and a backward
   graph), beside 3(a)'s eager figures; (b) the hybridized bf16 ResNet-50 under
   ``gluon.Trainer``: 2 warm-up and 10 timed steps (the loss falls; 32
   launches of each fused kernel a step, those of the timed steps all
   from replayed graphs), a profiled step, peak memory; then 3 replayed
   steps and 3 eager ones (``hybridize(active=False)``) from the same
   parameters, whether every parameter and running statistic is the
   same bits printed, and each held leaf by leaf at 8's noise floors
   once 8 has run; its ms/step is printed beside 9's captured
   ``TrainStep``;
3c. input pipeline: (a) the host natives built from ``src/`` with
   ``g++`` (build seconds; ``librecordio`` and ``libstoragepool`` must
   load, ``libimagedecode``'s status printed with the compiler's reason);
   (b) ``examples/train_mnist_mlp.py``'s ``main()`` as written with the
   port bound as ``mx``: 3 epochs at batch 256 over the synthetic MNIST
   through ``DataLoader`` with ``ToTensor`` (the last val_acc at least
   0.95), one epoch with ``--hybridize``, one with two forked workers,
   and the first batch of two workers the same bits as none's; (c) 1024
   raw records of 256x256x3 from ``RandomState(0)`` (10 classes) through
   ``MXIndexedRecordIO`` into a temporary directory, read by the
   ``ImageRecordIter`` of ``examples/train_resnet_fused.py --rec``
   (batch 256): the first batch the same bits as a numpy recomputation
   from its seed, a held batch unchanged after two more ``next()``, the
   iterator's own img/s; (d) the captured bf16 fused ResNet-50
   ``TrainStep`` (9's settings) fed by the example's loop body (NHWC
   transpose and bf16 cast on the card) through
   ``DevicePrefetcher(depth=2)``: 2 warm-up and 20 timed steps (loss
   finite, 32 replayed launches of each fused kernel a step), a profiled
   step, the wait split; then the same through ``DataLoader(pin_memory=
   True)`` over host images; its img/s is printed in 9 beside the
   resident batch's; (e) batches filled with their index through the
   prefetcher into a captured step returning their sum, depth 1 and 3,
   a consumer that sleeps and one that does not: every step sees its own
   index; (f) ``nd.flash_attention`` at BERT-base's shape, forward and
   backward under ``record()`` (one launch of each flash kernel, held
   against the plain versions), ``nd.paged_decode_attention`` at the
   serving config (one launch, the same bits as
   ``ops.paged_decode_attention``, within ATOL/RTOL of the plain
   version) and ``nd.image_resize``/
   ``image_to_tensor``/``image_normalize`` card vs host (uint8 within 1,
   float32 within 1e-5);
4. serving: the paged attention kernel against its plain version at
   three cases — path (the serving config, 64 slots x 2 pages), long (64
   slots x 32 pages) and few-long (4 slots of ~16k tokens among 60 idle
   ones) — idle slots exactly zero, a second launch the same bits, one
   call under ``set_sync_debug_mode("error")``; the decode forward with
   the kernel against the plain one; a ``GenerationServer`` answers 256
   greedy requests through its captured steps (one CUDA graph per
   prefill bucket plus the decode graph, ``graph_count() ==
   census()``; tokens checked against a teacher-forced full forward,
   launches — counted under replay — against decode steps x layers),
   then through its eager steps (``capture=False``, the same tokens);
   16 more requests through the captured steps under
   ``set_sync_debug_mode("error")`` (no host sync but the token
   read-back); the kernel timed at
   the three cases beside its bound, with ptxas's counts, the wrapper's
   host time a call and the two-call library route for context; a
   shorter serve under ``torch.profiler``, captured and eager;
5. serving features: the paged kernel at the speculative verify step's
   shape (64 slots x 4 lanes, each slot's table repeated per lane, lane
   i over the slot's length + i + 1) against its plain version, then
   timed beside its bound; 256 requests of shared-prefix traffic (a
   192-token system prompt, prompts that end inside its last block and
   take a CoW fault, prompts of its first 144 tokens plus 16) captured
   and eager (the same tokens, CoW faults taken, pages shared, the pool
   whole after the drain); the serve phase's traffic through two
   speculative servers (spec_k 3, window 16) — a seeded 1-layer draft
   and the target as its own draft — captured, and eager on the first
   64 requests (the same tokens), with their acceptance rates and
   tokens/s beside the plain server's; under
   captured steps a decode fault mid-run (every request completes with
   the unfaulted tokens), ``drain(handoff=True)`` half way and a
   successor's ``submit_resume`` of the exports, and a journal restore
   on a fresh server (both token-exact).  Every server's graphs equal
   its census, and every path counts its kernel launches from 0;
6. disaggregated serving: the serve phase's traffic through captured
   servers with 1 and 2 prefill workers (graphs = census = grid + 2
   after start and after the traffic, the handoff path taken, the pool
   whole and nothing in flight after the drain, the tokens equal to the
   fused server's or held teacher-forced with the reason printed,
   tokens/s beside the fused server's, the paged kernel's launches
   counted from 0), then through one started with ``warmup=False`` and
   2 workers (their graphs captured by the workers while the decode
   loop runs; the same tokens); the long-prompt stall, fused against
   1 worker: length buckets (64, 2048), 56 of the serve prompts
   decoding when 8 prompts of 1900-2040 tokens arrive, the gaps between
   decode steps while those are in flight (p50, p99, max, from the
   port profiler's host spans) and the bystanders' tokens/s, every long
   output and 8 bystanders held teacher-forced; ``fleet.handoff`` armed
   with a seated bystander (the doomed request fails, the bystander
   completes, a fresh request is served);
7. each fused-conv kernel (forward, dX, dW) against its plain version at
   the eight ResNet-50 shapes (N = 8) and the other cases the op takes,
   in f32 and bf16, dX launched twice for the same bits;
8. full-width ResNet-50 (f32, batch 8): forward and backward through
   the kernels against the same through the plain versions on the
   card, from the same parameters — loss, every gradient, running
   statistics — leaf by leaf, within a multiple of the noise floor that
   the plain versions on the card show against the same net on the
   host CPU;
9. the ResNet training run: warm-up and timed steps at batch 256
   through the captured step (loss finite and falling over the run,
   params finite, 32 launches of each kernel per step) and one step
   under ``torch.profiler``, then the same through the eager step
   (``capture=False``) from the same parameters; three steps of each
   with cuDNN's deterministic algorithms, every loss and tensor the same
   bits; then ``fused=False`` (cuDNN convs) from the same parameters as
   the yardstick (the two first losses agree);
9b. resume, under cuDNN's deterministic algorithms: (a) the captured
   bf16 ResNet-50 step of ``elastic_worker`` takes 6 steps, saved at 3
   and 6; the step-3 snapshot loaded into the same captured step and 3
   more steps give steps 4-6's losses and every tensor the same bits,
   no tensor the graph holds rebound (``load_train_step`` timed);
   (b) 10 steps in turns with and without an async snapshot: the
   stall per snapshot against a plain step, the writer's serialize +
   fsync + commit ms and MB/s; (c) the worker under
   ``Supervisor(n=1, platform="gpu", devices_per_worker=1)`` to step 10
   uninterrupted, then again with a watcher thread that SIGKILLs
   attempt 0 (heartbeat step >= 5, step 4 committed) and SIGTERMs
   attempt 1 (step >= 7; it snapshots and exits 43): every printed loss
   and the final snapshot's digests the uninterrupted run's bits,
   every retained snapshot verified, the event log's order, 32
   launches of each fused kernel a step, each worker's spawn to first
   step;
10. each fused-conv kernel at the eight shapes at N = 256, bf16: held
   against its plain version, then timed (CUDA events, L2 flushed)
   beside its bound, its plain version and the cuDNN call for the conv
   alone, with its achieved TFLOP/s; summed over a step's 32 launches;
   dX launched twice, its outputs (dscale, dshift among them) the same
   bits; before it, ``nvcc -Xptxas -v``'s registers and spills of the
   tensor-core kernels beside their shared memory;
11. each flash-attention kernel (forward, dQ, dK/dV, the dropout seed
   read from device memory) against its plain version summed in f64:
   BERT-base's shape at dropout 0 and 0.1,
   causal, S = 512, S = 200 causal (bf16 and f32), B*H = 37, D = 128,
   f32; in every bf16 case each backward kernel's error from the
   unrounded f64 sums within 2x the plain version's in f32, and a
   second launch giving the same bits;
12. full-width BERT-base (f32, batch 8, dropout 0): forward and backward
   through the kernels against the plain versions on the card — loss,
   the four outputs, every gradient — leaf by leaf, as in 8;
13. the BERT training run: 2 warm-up and 10 timed steps through the
    captured step (loss finite and falling, params finite, 12 launches
    of each flash kernel per step) and one step under
    ``torch.profiler``, then the same through the eager step from the
    same parameters and seed (the losses equal, or within 2% with the
    reason printed); three calls of a captured step at learning rate 0
    give three losses (new dropout masks on every replay); then
    ``attention_impl="dense"`` from the same parameters as the
    yardstick (the first losses agree within 2%); tokens/s and peak
    memory of both;
14. each flash kernel at BERT-base's shape, bf16, dropout 0.1, timed
    beside its bound, its plain version and
    ``scaled_dot_product_attention`` (forward; backward for dQ + dK/dV
    together), with its achieved TFLOP/s; summed over a step's 12
    launches; before it, ``nvcc -Xptxas -v``'s registers and spills of
    the tensor-core forward, dQ and dK/dV kernels beside their shared
    memory;
15. the LSTM language model: (a) the ``RNN`` op at the path's shape (T
    35, N 64, 650 -> 650; LSTM at 2 layers, GRU at 1) against its plain
    per-step version (``ops.rnn.rnn_reference``, the JAX cells), every
    output and the gradients of the data, the states and the packed
    parameter: f32 with TF32 off within ``RNN_F32_TOL`` of each leaf's
    scale (with the TF32 flag as it stands, printed), bf16 against the
    f32 op within
    ``RNN_BF16_FACTOR`` x the plain version's own bf16 error; (b) one
    forward and backward of the op per dtype under ``torch.profiler``:
    the kernels that carry it by name, and the copies (cuDNN compacting
    the packed views); (c) ``bench_lstm``'s step, 2 warm-up and 20 timed
    steps, captured and eager in turns (captured, eager, eager,
    captured) from the same parameters and seed, a profiled step of
    each, peak memory, the losses the same bits or held within 2%; (d)
    a captured step at learning rate 0: the first call eager, then 3
    replays with 3 different losses (new dropout masks); (e)
    ``examples/word_language_model.py``'s ``main()`` with ``--epochs 1
    --max-tokens 56000`` on its synthetic corpus: a finite perplexity;
16. SSD-512: (a) ``MultiBoxPrior`` at the net's seven feature maps,
    ``MultiBoxTarget`` (labels with two rows claiming one anchor behind
    padding rows, an f32 ``cls_pred`` rounded to halves: tied scores)
    and ``MultiBoxDetection`` on the card against the same calls on the
    host: classes and masks equal, boxes within ``MULTIBOX_ATOL``; (b)
    ``bench_ssd``'s step, 2 warm-up and 10 timed steps, captured and
    eager in turns as in 15(c); (c) one ``detect()`` of the net's
    outputs on the card against the host;
17. symbolic: (a) the symbolic ResNet-50 (its weight count equal to
    ``resnet50_v1()``'s; ``infer_shape``'s host time) through
    ``Module.fit``, 2 warm-up and 10 timed batches, captured and eager
    in turns (captured, eager, eager, captured) from the same
    parameters under cuDNN's deterministic algorithms: every parameter
    moved, the first captured run the first eager run's bits where the
    eager runs repeat their bits, else within ``RUN_GAP_FACTOR`` of
    their gap; then with cuDNN's default algorithms a captured run (a
    profiled step, peak memory, the executor's graphs) and
    ``resnet50_v1()`` through ``parallel.TrainStep`` (unfused, NCHW,
    f32, the same SGD and batch), img/s of both and their ratio; (b) a ``sym.FusedNormReluConv`` node
    at [256, 56, 56, 64] -> 64 3x3 and a ``sym.flash_attention`` node at
    (64, 128, 12x64), bf16, through ``Symbol.bind``: 3 training calls
    with ``backward(out_grads)`` (eager, then a captured pair replayed),
    one launch of each kernel per call, output and gradients held
    against the same symbol under ``plain_versions``; (c) the two
    symbolic examples as written: the reloaded Module's score and the
    first's within 1e-6, the SymbolBlock's probabilities and
    ``Module.predict`` within 1e-6, "over buckets [4, 8, 12]" and one
    graph per bucket key used; (d) ``Module.fit`` of the example's MLP
    SIGTERMed mid-epoch and resumed on the same Module, loaded in place
    into the tensors its graphs hold, ending on the uninterrupted run's
    parameters and optimizer state bit for bit; (e) a hybridized block
    with a fused norm-relu-conv exported (``HybridBlock.export``) and
    served by ``SymbolBlock.imports``: the kernel recorded as a custom
    op, launched once a call, the block's bits;
18. classifier serving: (a) ``examples/serve_mnist.py``'s ``main()``
    as written with ``--requests 256 --clients 4``: no failed request,
    4 distinct shapes, the hybridized net's 4 forward graphs, every
    accepted request resolved by the drain; (b) the fused ResNet-50
    behind ``EvalStep`` (host f32 images uploaded without a host sync,
    cast to bf16 on the card) and ``InferenceServer(buckets=(1, 4, 16,
    64))``: 4 graphs after ``start()`` and after the traffic; 8
    closed-loop clients x 64 requests (deadline 2 s; p50/p99 latency,
    occupancy) and an open burst of 1024 submits from 4 threads (img/s,
    device ms a batch by bucket, the busy share of a profiled burst of
    256); a group of each bucket's size whose responses are the bits of
    their rows of a direct ``EvalStep`` call on the same padded batch,
    each padded batch held against the plain versions
    (``check_outputs``' bf16 tolerance) with the top-1 agreement; 32
    forward launches a batch counted under replay, no dX or dW; the
    forward kernel at the eight shapes at N = 1 and 4 against its plain
    version, timed beside it and its bound; (c) the symbolic ResNet-50
    bound at 64 for inference through ``module_apply`` in f32 and int8
    at buckets (1, 8, 64): 3 graphs after the warm-up and after 200
    mixed requests each, nothing rebound, f32 within 1e-5 of
    ``Module.predict``, int8 against f32 (atol 5e-3 printed) and the
    weight-input bytes of both; (d) the MLP fleet: a captured Adam
    ``TrainStep`` checkpointed by ``CheckpointManager``; 3 replicas at
    buckets (1, 4, 8, 16) serve 400 requests while ``WeightUpdater``
    rolls the next snapshot (every replica the snapshot's bits, the
    responses the new weights' eager output); then a ``serving.step``
    fault, one replica killed, a ``FleetAutoscaler`` up to 4 and down
    to 2: zero accepted requests dropped and the shared function's
    graphs the grid's 4 throughout; (e) one call of each apply under
    ``set_sync_debug_mode("error")``.

19. one-card extras: (g) ``runtime.Features()`` and ``nd.add``'s host us
    a dispatch with AMP off and on; (d) every sampler name (33) draws
    2^22 values on the card (shape, dtype, support, mean and variance
    within 6 standard errors; the host generator untouched),
    ``mx.random.seed`` repeats the bits, a captured graph that draws
    gives three different draws on three replays; (e) ``foreach`` over
    an LSTMCell at the LM's widths (650, batch 64, 35 steps), eager and
    captured: ``cell.unroll``'s bits; ``while_loop(max_iterations=8)``
    and ``cond`` captured: the eager bits, a replay with no host sync;
    (f) MXNet's ``custom_softmax`` example as a ``CustomOp`` trained 3
    SGD steps: gradients within 1e-6 of their scale of the built-in
    softmax cross-entropy's, and it raises inside ``hybridize()``; (c)
    ``quantize_net`` on ``resnet50_v1(fused=False)`` (f32, NCHW,
    calibrated on 3 batches of 64): each of the 54 swapped layers within
    1e-6 of its scale of the plain int8 product on the host (first
    image), one int8 GEMM a layer, captured = eager bits, the net's
    int8-vs-f32 error and ms of an int8 forward against f32, then the
    JAX package's int8 accuracy gate (``resnet18_v1`` thumbnail, int8
    within 0.05 of float); (b) ``Estimator.fit`` over 2 + 10 resident
    batches of BASELINE config 2's hybridized fused bf16 ResNet-50 with
    the logging, checkpoint and early-stopping handlers: 32 launches of
    each fused kernel a batch, the parameters the bits of
    ``hybrid_resnet``'s hand loop from the same start over the same
    batches (cuDNN's deterministic algorithms), img/s against that loop;
    (a) the AMP BERT-base above: 2 warm-up and 10 timed steps (the loss
    falls; 12 launches of each flash kernel a step, every one on bf16
    inputs, held against the plain versions on the path's own q),
    tokens/s, busy share and peak memory against 13's ``TrainStep``; an
    injected overflow (the scaled loss times inf) skips the step —
    every parameter and LAMB state the same bits, the gradients zeroed,
    the scale 65536 -> 32768 — and the next clean step applies; host
    syncs of a step and of the overflow check (one); 3 replayed steps
    against 3 eager ones from the same parameters (dropout 0,
    deterministic algorithms) the same bits where two eager runs repeat
    theirs;
20. numpy, sparse, ONNX: ``nd.add``'s host us a dispatch with
    ``MXNET_ENGINE_TYPE=NaiveEngine`` unset and set; (a) np BERT-base:
    19(a)'s net, batch and steps under ``npx.set_np()`` with ``mx.np``
    inputs, the outputs and the loss ``mx.np.ndarray``, 12 launches of
    each flash kernel a step on bf16 inputs held against the plain
    versions on the path's q, tokens/s against 13's ``TrainStep``, busy
    share, peak memory, the losses; (b) the factorisation (two
    ``Embedding(sparse_grad=True)`` tables of 71,567 users and 10,681
    items x 128, batches of 8192 seeded pairs with Zipf item ids,
    ``gluon.Trainer`` SGD 0.1 / 0.9 / 1e-4, 20 steps): every step within
    MF_RTOL of a plain lazy momentum SGD on dense tensors; against the
    same run with dense gradients, after step 1 the rows it touched
    within MF_RTOL and the rest the start's bits, after 20 steps the
    rows no step touched the start's bits; ms a step of an unchecked
    lazy run and of the dense one; ``sparse.dot`` of an 8192 x 1e6 CSR
    batch (39 a row) with a dense weight against a dense gather-sum
    (CSR_RTOL), its ms; (c) ``onnx.export_model`` of ResNet-50 v1 (NCHW,
    f32) on the card at batch 1 and 64, ``onnx.import_to_function`` on
    card tensors: 8 seeded images through both within ONNX_RTOL of the
    logits' scale, numpy inputs under ``mx.gpu()`` on the card, no
    synchronizing copy a call, export seconds, file size, ms against the
    block's.

21. data parallel: the gang the card machine allows, launched through
    ``python -m mxnet_tpu_torch.launch --platform gpu`` with this script
    as each rank (``--dp-worker``): one rank a card over NCCL with 2 or
    more cards, else 2 ranks sharing the card over gloo (the backend
    rule; each rank's backend and card printed, card = rank % count);
    (b) the fused bf16 ResNet-50 (bench_resnet's settings, its CE in
    f32) on each rank's rows of the global batch 256 through
    ``TrainStep(mesh=make_mesh())`` with ``grad_reduce`` f32, bf16,
    int8 and int8 again, 2 + 2 steps each: every rank the same bits
    (parameters, statistics, losses), 32 launches of each fused kernel
    a step, two int8 runs under one seed the same losses; the leaves
    after one f32 step within 3x their bf16 noise floor (the world of
    one in bf16 against f32) of the world of one; (c) bf16 and int8
    held one update at a time from the f32 run's states against the
    same explicit path with an f32 wire, the next loss within 2e-3 /
    1e-2 (the JAX package's gates), the free-running and sync-BN gaps
    printed; (a) the world of one over NCCL in this process, its
    collectives captured in the step's graph; (d) BERT-base (flash,
    dropout 0.1, bf16 with f32 masters, hybridized) through
    ``gluon.Trainer(kvstore="dist_sync_device")`` LAMB 1e-3 / wd 0.01
    on the ranks' rows of 64 x 128, 2 + 2 steps: every rank the same
    parameters, 12 launches of each flash kernel a step; (e)
    ``examples/dist_train.py`` as written with the port as ``mx`` in a
    gang of 2: the same weight checksum on both ranks; (f) ms/step per
    rank, img/s and tokens/s over the gang against the world of one,
    and a profiled f32 step's collective and copy ms and busy share,
    beside the card's name and power limit; (g) in the same gang
    ``examples/bert_pretrain.py`` as written (BERT_PRETRAIN_ARGS: 12
    layers, bf16, LAMB, 64 x 128 a rank, dense attention) with a
    stand-in ``jax`` module whose ``devices()`` gives the ranks: finite
    losses, every rank the same parameters, a dp mesh over the gang,
    its tokens/s line; its ``--attention flash`` stops at the first
    forward in both packages (no key-padding mask in flash), held to
    the JAX package's error text.

22. model parallel: one gang as in 21 (``--dp-worker <dir> mp``; 2 gloo
    ranks sharing the card, or one rank a card over NCCL with 2 or more
    cards), every sub-phase at bench_bert's width (BERT-base, 64 x 128
    tokens, 20 masked positions, bf16 with f32 masters, LAMB 1e-3 / wd
    0.01, RandomState(0) data; dropout 0), 1 + 2 steps and one profiled
    each, through ``TrainStep(mesh=, rules=)``: (a) ``tp``,
    ``tp_dense_rules()`` and BERT's layers by name (fused QKV and FFN-in
    column-parallel, the projection and FFN-out row-parallel), flash;
    (b) ``fsdp``, ``fsdp_rules()``, flash, the batch split; (c) ``sp``,
    ``attention_impl="ring"``, then ``"ulysses"``; (d) ``pp``: the 12
    encoder cells as a ``PipelineStack`` of 2 stages of 6, 4
    microbatches, on the batch's embeddings against a seeded MSE target;
    (e) ``ep``: ``MoEFFN(768, 3072, 8 experts, top-2)`` under a
    ``Dense(2)`` head on the embeddings.  Held: every rank finite, its
    replicated leaves and losses the same bits on every rank, sharded
    leaves held as blocks, 12 launches of each flash kernel a step a rank
    in (a) and (b); each sub-phase's leaves after its first step within
    3x their bf16 noise floor of the world of one's (the same net with
    no mesh in this process, ring and Ulysses held against the flash
    net; the floor: the world of one in bf16 against f32).  Printed:
    where the flash kernels ran and on how many rows, gloo's collectives
    on this torch, ms/step per rank and tokens/s over the gang against
    the world of one, each rank's bytes of parameters and optimizer
    states against the world of one's, a profiled step's collective
    host ms, copy ms and busy share, beside the card's name and power
    limit.  (f) Sharded checkpoints: after (a)'s first step the tp step
    is saved as the port's v2 directory (``async_save=True``, then
    ``wait_until_finished()``) and as the gathered v1.1 file, and its
    next 2 steps run from that state under deterministic algorithms
    (the uninterrupted continuation; the step is then put back); a
    fresh tp step and a fresh fsdp step load the v2 directory and take
    those 2 steps: the tp resume the continuation's losses and tensors
    bit for bit, the fsdp resume's leaves within 3x (a)'s bf16 floor of
    the tp resume's, and the world of one in this process loads the
    v1.1 file in place into its captured step, held the same way; the
    bytes a rank and the ms of each save and load printed.  (g)
    Tensor-parallel serving at the serve phase's width: rank 0's seeded
    params broadcast, ``GenerationServer(tp_shards=2)`` on both ranks
    (the leader takes the serve phase's first TP_REQUESTS prompts) with
    f32, int8, int8 again and f32 with one prefill worker, then a
    profiled f32 run of TP_PROFILED_REQUESTS requests of
    TP_PROFILED_NEW tokens: each rank's paged kernel LAYERS launches a
    decode step on its 4 heads and held against its plain version on its
    pool (its time beside the bound); f32 tokens the world of one's (or
    teacher-forced), int8 the same tokens twice and f32's first
    tokens, the disaggregated server's tokens the fused one's, every
    page free after drain; tokens/s against the world of one, the
    decode-step ms, the host ms in collectives a step, rank 0's busy
    share.

23. the C ABI: ``libmxtpu_capi`` built with g++ and
    ``mxnet_tpu_torch/capi/c_api_smoke.c`` linked against it; (a) the
    client run on the card as a user runs it (a process of its own, the
    repo root on its PYTHONPATH, killed whole past CAPI_TIMEOUT_S): its
    every check, the MLP's 30 SGD steps, then through ``mxtpu_invoke``
    ``FusedNormReluConv`` at IMPERATIVE_FUSED (bf16) and
    ``flash_attention`` at BERT-base (bf16) forward and backward and
    ``paged_decode_attention`` at the serving path shape with and
    without ``impl="jnp"``, on seeded inputs written with ``nd.save``;
    every output and gradient it saved held against the port's plain
    versions on the same inputs in this process (the fused, flash and
    paged rules above); (b) the library loaded here with ``ctypes`` and
    the three ops driven through ``mxtpu_*`` again with every launch
    counter at 0: each kernel once per invoke or backward (the
    ``c_api`` entry of each kernel's ``launches_by_path``); the build
    and client seconds, the loss trajectory and the max errors printed
    beside the card's name and power limit.

Prints one JSON ``kernels`` line, then the card line, then as the last
line ``{"ok": true, "device": {...}}``.  Without a card, or without the
package beside it, it exits non-zero and prints no result.
``python3 chip_smoke.py --extras`` runs the build and phase 19 alone,
``--np`` the build and phase 20 alone (the TrainStep comparison then
not measured), ``--dp`` the build and phase 21 alone, ``--mp`` the
build and phase 22 alone, ``--tp`` the build and phase 22's tp
sub-phase with (f) and (g) alone, ``--capi`` the build and phase 23
alone; none of them prints a result line.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# the card's published peaks (H100 SXM, NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

VOCAB, LAYERS, HEADS, HEAD_DIM, D_FF = 4096, 4, 8, 64, 2048
SLOTS, N_PAGES, PAGE_SIZE, MAX_NEW = 64, 512, 64, 64
BATCH_BUCKETS, LENGTH_BUCKETS = (1, 2, 4), (32, 64)
N_REQUESTS = 256
ATOL, RTOL = 1e-5, 1e-4          # kernel vs plain, f32
# few long sequences decoding among idle slots: 4 of 64 slots active, 256
# pages each (ragged tails), in a pool of exactly their pages (+ sink)
FEW_LONG_PPS, FEW_LONG = 256, (16384, 16384, 16383, 16320)
HOST_CALLS = 1000                # wrapper calls timed on the host
HOST_SLACK_CYCLES = 4_000_000    # device sleep before a timed span (~2 ms)
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-4
# serving features: speculative decoding, shared-prefix traffic, salvage
SPEC_K, SPEC_WINDOW = 3, 16
# the speculative servers' eager yardstick takes the first
# SPEC_EAGER_REQUESTS prompts (one slot grid; its tokens held against
# the captured run's)
SPEC_EAGER_REQUESTS = 64
PREFIX_REQUESTS, PREFIX_LENGTHS = 256, (32, 64, 192)
RESUME_REQUESTS = 64
# disaggregated serving: the long-prompt stall (length buckets, bystanders
# decoding, long prompts of 1900-2040 tokens arriving among them)
STALL_LENGTHS, STALL_BYSTANDERS, STALL_LONG = (64, 2048), 56, 8
STALL_LONG_TOKENS = (1900, 2041)
STALL_CALM = 16                  # decode steps of the bystanders alone
REPLACES = {"paged_decode_attention":
            "mxnet_tpu/ops/pallas/paged_attention.py:31",
            "fused_conv_fwd": "mxnet_tpu/ops/pallas/fused_conv.py:100",
            "fused_conv_dx": "mxnet_tpu/ops/pallas/fused_conv.py:164",
            "fused_conv_dw": "mxnet_tpu/ops/pallas/fused_conv.py:281",
            "flash_attention_fwd":
            "mxnet_tpu/ops/pallas/flash_attention.py:57",
            "flash_attention_dq":
            "mxnet_tpu/ops/pallas/flash_attention.py:158",
            "flash_attention_dkv":
            "mxnet_tpu/ops/pallas/flash_attention.py:191"}
SOURCES = {"paged_decode_attention":
           "mxnet_tpu_torch/ops/cuda/paged_attention.cu",
           "fused_conv_fwd": "mxnet_tpu_torch/ops/cuda/fused_conv.cu",
           "fused_conv_dx": "mxnet_tpu_torch/ops/cuda/fused_conv.cu",
           "fused_conv_dw": "mxnet_tpu_torch/ops/cuda/fused_conv.cu",
           **dict.fromkeys(("flash_attention_fwd", "flash_attention_dq",
                            "flash_attention_dkv"),
                           "mxnet_tpu_torch/ops/cuda/flash_attention.cu")}

# the imperative path: the Gluon MLP of examples/train_mnist_mlp.py
# (BASELINE config 1) at its width, SGD 0.1, batch 256
MLP_BATCH, MLP_WARMUP, MLP_TIMED, MLP_CHECK = 256, 2, 50, 5
MLP_UNITS = (128, 64, 10)
MLP_LOSS_RTOL = 1e-4             # card vs host, per step's mean loss
DISPATCH_SHAPE, DISPATCH_CALLS = (256, 128), 1000
# nd.FusedNormReluConv at ResNet-50's first-stage 3x3: N, H=W, Ci, Co
IMPERATIVE_FUSED = (256, 56, 64, 64)
# one gluon.Trainer step against one TrainStep step, resnet50_v1 f32
IMPERATIVE_BATCH = 32
SGD_KW = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
# ResNet-50 v1 training (bench.py bench_resnet's settings), on the card
DEVICE = "cuda"
TRAIN_BATCH, CHECK_BATCH, KERNEL_CHECK_BATCH = 256, 8, 8
WARMUP_STEPS, TIMED_STEPS = 2, 5
# the hybridized gluon.Trainer path (BASELINE config 2): timed steps, and
# steps replayed against eager ones from the same parameters
HYBRID_STEPS, HYBRID_CHECK_STEPS = 10, 3
ACCOUNTING_STEPS = 3       # a turn of the accounting's on/off turns
ACCOUNTING_ROUNDS = 3      # rounds of the turns on, off, off, on
PROFILE_TRIES = 2          # profiler sessions a profiled region may take
FUSED = ("fwd", "dx", "dw")
# per stage: (bottleneck blocks, spatial size of the fused convs, C/4, C)
RESNET50_STAGES = ((3, 56, 64, 256), (4, 28, 128, 512), (6, 14, 256, 1024),
                   (3, 7, 512, 2048))
FUSED_PER_STEP = sum(2 * blocks for blocks, *_ in RESNET50_STAGES)  # 32
# kernel vs plain: both sum the same f32 products in another order, so
# f32 results agree to ~1e-5 of their scale; a result stored in bf16
# can then round to the neighbouring bf16 value (2**-8 relative), so
# bf16 outputs get 2**-6
F32_RTOL, BF16_RTOL = 1e-4, 2 ** -6
# BERT-base pretraining (bench.py bench_bert's settings), on the card
BERT_VOCAB, BERT_UNITS, BERT_HIDDEN = 30522, 768, 3072
BERT_LAYERS, BERT_HEADS = 12, 12
BERT_HEAD_DIM = BERT_UNITS // BERT_HEADS
BERT_BATCH, BERT_SEQ, BERT_PRED, BERT_DROPOUT = 64, 128, 20, 0.1
BERT_BH = BERT_BATCH * BERT_HEADS
BERT_CHECK_BATCH = 8
BERT_WARMUP_STEPS, BERT_TIMED_STEPS = 2, 10
FLASH = ("fwd", "dq", "dkv")
FLASH_SEED = 1234567
# bf16 flash backward: the kernel's largest error from the f64 sums may
# be at most this many times the plain version's in f32 (both outputs
# round to bf16, half an ulp of the largest values; the kernel's split
# products and tensor-core sums add ~2^-16 of them)
BWD_ERR_FACTOR = 2.0
# the input pipeline: examples/train_mnist_mlp.py's main() (synthetic
# MNIST), raw records for the example's ImageRecordIter, the fed step
MNIST_EPOCHS, MNIST_MIN_ACC, MNIST_SHUFFLE_SEED = 3, 0.95, 0
REC_COUNT, REC_HW, REC_CLASSES, REC_BATCH = 1024, 256, 10, 256
REC_RATE_BATCHES = 8             # batches timed for the iterator alone
FED_STEPS = 20                   # timed steps of the fed ResNet-50
STREAM_BATCH, STREAM_STEPS, STREAM_SLEEP_S = (64, 3, 224, 224), 16, 0.02
IMAGE_F32_ATOL = 1e-5            # image ops, card vs host, on [0, 1]
# model check: kernel route vs plain route, per leaf, in units of the
# plain-on-card vs plain-on-host noise floor (floors under a few f32
# ulps are raised to MODEL_MIN_FLOOR)
MODEL_FLOOR_FACTOR, MODEL_MIN_FLOOR = 3.0, 1e-6
# resume: elastic_worker's net (bench_resnet's step), the supervised
# run's target and snapshot cadence, the in-process snapshots, the turns
# of steps with and without an async snapshot, the supervised worker's
# pause between steps (room for the watcher's signals), when the watcher
# SIGKILLs attempt 0 (heartbeat step, committed step) and SIGTERMs
# attempt 1 (heartbeat step)
RESUME_NET, RESUME_TARGET, RESUME_EVERY = "resnet50_fused", 10, 2
RESUME_SAVED = (3, 6)
RESUME_TURNS = 10
RESUME_STEP_SLEEP = 0.5
RESUME_KILL, RESUME_TERM = (5, 4), 7
RESUME_TIMEOUT_S = 300           # a supervised run's limit
# the LSTM language model (bench.py bench_lstm's settings): vocab, embed
# = hidden, layers, dropout, batch x bptt, steps; the RNN op against its
# plain per-step version at that shape: f32 (TF32 off) within these
# shares of each leaf's scale (outputs, gradients: 35 steps of sums in
# another order), bf16 within a factor of the plain version's own bf16
# error; the word-language-model example's arguments
LSTM_VOCAB, LSTM_UNITS, LSTM_LAYERS, LSTM_DROPOUT = 10000, 650, 2, 0.5
LSTM_BATCH, LSTM_BPTT, LSTM_WARMUP, LSTM_TIMED = 64, 35, 2, 20
RNN_F32_TOL = (1e-4, 1e-3)
RNN_BF16_FACTOR, RNN_BF16_MIN_FLOOR = 3.0, 2 ** -9
LM_EXAMPLE_ARGS = ["--epochs", "1", "--max-tokens", "56000"]
# SSD-512 (bench.py bench_ssd's settings): batch, image side, classes,
# steps; the multibox ops card vs host (f32, the same arithmetic)
SSD_BATCH, SSD_SIZE, SSD_CLASSES, SSD_WARMUP, SSD_TIMED = 16, 512, 20, 2, 10
MULTIBOX_ATOL = 1e-6
# the SSD's parameters that bench_ssd's steps may leave as they were: a
# BatchNorm scale starts at 1.0, where bf16's spacing (2^-8 below, 2^-7
# above) rounds away a step at learning rate 1e-3 unless its gradient is
# large; the last three scales (1x1 maps, anchors of 0.6-0.97) hold no
# positive anchor for boxes of 0.1-0.4 and none mined as a hard
# negative, so their heads and the down blocks that feed only them take
# no gradient (also in f32, on the CPU)
SSD_MAY_STAY = (r"batchnorm\d+_gamma$|^ssd\d+__predictorhead(8|9|1[0-3])_"
                r"|^ssd\d+_(conv2d|batchnorm)([6-9]|1[01])_")
# captured vs eager parameters, where two eager runs differ: within this
# many times the eager runs' own gap
RUN_GAP_FACTOR = 4.0
# the symbolic phase: ResNet-50 v1 from mx.sym through Module.fit (NCHW,
# f32, batch SYM_BATCH, SGD 0.1 / 0.9 / 1e-4), the two kernel symbols
# over SYM_CALLS training calls, the two symbolic examples, and
# Module.fit preempted and resumed (SYM_FIT_BATCHES batches an epoch,
# SIGTERM after batch SYM_FIT_KILL)
SYM_BATCH, SYM_WARMUP, SYM_TIMED = 64, 2, 10
SYM_SGD = (("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4))
SYM_CALLS = 3
SYM_FIT_BATCHES, SYM_FIT_BATCH, SYM_FIT_KILL = 8, 128, (1, 3)
# classifier serving: examples/serve_mnist.py's arguments; the fused
# ResNet-50 behind EvalStep (buckets, distinct images, closed-loop
# clients x requests, the open burst and a shorter profiled one, the
# forward kernel timed at the small buckets' N); the symbolic ResNet-50
# through module_apply (buckets, requests per precision); the MLP fleet
# (buckets, requests during the roll, in-flight cap per replica)
SERVE_MNIST_ARGS = ["--requests", "256", "--clients", "4"]
CLASSIFIER_BUCKETS, CLASSIFIER_IMAGES = (1, 4, 16, 64), 160
CLASSIFIER_CLIENTS, CLASSIFIER_PER_CLIENT = 8, 64
CLASSIFIER_BURST, CLASSIFIER_PROFILED_BURST = 1024, 256
CLASSIFIER_SMALL_N = (1, 4)
MODULE_BUCKETS, MODULE_REQUESTS = (1, 8, 64), 200
FLEET_BUCKETS, FLEET_REQUESTS, FLEET_INFLIGHT = (1, 4, 8, 16), 400, 8
# the one-card extras: warm-up, timed and replay-check steps of the AMP
# BERT and the Estimator; the float16 AMP loss scale; draws per sampler
# name and the standard errors their moments may stray; the int8
# ResNet-50's batch, calibration batches, per-layer bound (of each
# layer's scale: the int32 sums are exact) and the accuracy gate's
# margin; the CustomOp's SGD steps and its gradients' bound (of their
# scale: numpy's softmax against torch's log-softmax)
EXTRAS_WARMUP, EXTRAS_TIMED, EXTRAS_CHECK = 2, 10, 3
AMP_SCALE = 2.0 ** 16
SAMPLER_DRAWS, SAMPLER_SIGMAS = 2 ** 22, 6.0
INT8_BATCH, INT8_CALIB, INT8_LAYER_RTOL, INT8_ACC_MARGIN = 64, 3, 1e-6, 0.05
INT8_FLOAT_FLOOR = 0.5
CUSTOM_STEPS, CUSTOM_TOL = 3, 1e-6
# numpy, sparse, ONNX: the sparse-gradient factorisation of MXNet 1.x's
# example/sparse/matrix_factorization at MovieLens-10M's user and item
# counts (factors, batch, steps, the Zipf exponent of the item ids, SGD);
# every step against a plain lazy momentum SGD on dense tensors, and
# after the first step (both runs from the same start) the rows it
# touched against the dense-gradient run, within MF_RTOL of the table's
# scale; the CSR batch of Criteo's shape (rows, columns, nonzeros
# a row) against a dense gather-sum within CSR_RTOL of its scale; the
# ONNX round trip of ResNet-50 v1 (NCHW, f32) at these batches over
# ONNX_IMAGES seeded images, within ONNX_RTOL of the logits' scale (the
# block and the imported function both run cuDNN's TF32 convolutions)
MF_USERS, MF_ITEMS, MF_FACTORS, MF_BATCH, MF_STEPS = 71567, 10681, 128, \
    8192, 20
MF_ZIPF, MF_SGD = 1.2, {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
MF_RTOL = 1e-5
CSR_ROWS, CSR_COLS, CSR_NNZ, CSR_RTOL = 8192, 1_000_000, 39, 1e-5
ONNX_BATCHES, ONNX_IMAGES, ONNX_RTOL = (1, 64), 8, 2e-3
# data parallel: bench_resnet's global batch split over the ranks, the
# steps of each run, the loss gates of the compressed gradient exchange
# against f32's trajectory (the JAX package's, tests/test_quantize.py:
# 2e-3 relative for bf16, 1e-2 for int8), a gang's time limit
DP_BATCH, DP_WARMUP, DP_TIMED = 256, 2, 2
DP_GATES = {"bf16": 2e-3, "int8": 1e-2}
DP_GANG_TIMEOUT_S = 600
# model parallel (phase 22): bench_bert's width, bf16 with f32 masters,
# LAMB 1e-3 / wd 0.01, dropout 0 (so a gang's first step is held leaf by
# leaf against the world of one's); MP_WARMUP + MP_TIMED steps a
# sub-phase and one profiled; the pipeline's stages and microbatches;
# the MoE's experts and top-k (GShard's top-2); a gang's time limit; the
# gangs' launcher platform and worker script (None: this file)
MP_WARMUP, MP_TIMED = 1, 2
MP_STAGES, MP_MICRO = 2, 4
MP_EXPERTS, MP_TOPK = 8, 2
MP_GANG_TIMEOUT_S = 900
MP_RUNS = ("tp", "fsdp", "ring", "ulysses", "pp", "ep")
#: the sub-phases whose extra step is profiled on rank 0 (the others'
#: busy shares are in PERF.md §6)
MP_PROFILED = ("tp", "fsdp")
#: elements of each leaf's first-step gradient held (evenly strided)
MP_GRAD_SAMPLE = 8192
GANG_PLATFORM, GANG_SCRIPT = "gpu", None
# examples/bert_pretrain.py in phase 21's example gang, as written (its
# bf16 BERT-base, LAMB, batch 64 x 128 a rank): 12 layers, 4 steps; and
# the arguments of its flash run, which stops at its first forward
BERT_PRETRAIN_ARGS = ["--layers", "12", "--num-steps", "4"]
BERT_PRETRAIN_FLASH_ARGS = ["--layers", "1", "--num-steps", "1",
                            "--attention", "flash"]
FLASH_REFUSAL = "attention_impl='flash' does not support valid_length masks"
# phase 22 (g): the serve phase's first TP_REQUESTS prompts (one slot
# grid's worth) through each tensor-parallel server and the world of
# one's, TP_PROFILED_REQUESTS of them of TP_PROFILED_NEW new tokens
# through the profiled one
TP_REQUESTS, TP_PROFILED_REQUESTS, TP_PROFILED_NEW = 64, 16, 16
TP_MODES = ("f32", "int8", "int8 again", "f32 disaggregated")
# phase 23, the C ABI: the C client's time limit (it runs in a session of
# its own, killed whole past it), the seed of its inputs
CAPI_TIMEOUT_S = 300
CAPI_SEED = 23


def log(msg):
    print(msg, flush=True)


class SmokeError(RuntimeError):
    pass


def expect(cond, msg):
    if not cond:
        raise SmokeError(msg)


# ------------------------------------------------------------------ inputs --
def paged_inputs(torch, rng, slots, pages_per_seq, lengths):
    """q, pools with exactly the pages the slots need (+ sink), tables
    of distinct random pages, int32 lengths — on the card."""
    n_pages = 1 + slots * pages_per_seq
    q = rng.standard_normal((slots, HEADS, HEAD_DIM), dtype=np.float32)
    kp = rng.standard_normal((n_pages, PAGE_SIZE, HEADS, HEAD_DIM),
                             dtype=np.float32)
    vp = rng.standard_normal((n_pages, PAGE_SIZE, HEADS, HEAD_DIM),
                             dtype=np.float32)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = perm.reshape(slots, pages_per_seq)
    dev = torch.device("cuda")
    return tuple(torch.from_numpy(x).to(dev) for x in
                 (q, kp, vp, tables, np.asarray(lengths, np.int32)))


def few_long_inputs(torch, rng):
    """The few-long case: 4 active slots of FEW_LONG tokens among SLOTS,
    each with FEW_LONG_PPS distinct pages of a pool of 1 + 4 x
    FEW_LONG_PPS pages; the idle slots' tables point at the sink.
    Returns the five inputs on the card and the active slots' indices."""
    n_act = len(FEW_LONG)
    n_pages = 1 + n_act * FEW_LONG_PPS
    act = np.sort(rng.choice(SLOTS, n_act, replace=False))
    lengths = np.zeros(SLOTS, np.int32)
    lengths[act] = FEW_LONG
    tables = np.zeros((SLOTS, FEW_LONG_PPS), np.int32)
    tables[act] = rng.permutation(np.arange(1, n_pages)).astype(
        np.int32).reshape(n_act, FEW_LONG_PPS)
    q = rng.standard_normal((SLOTS, HEADS, HEAD_DIM), dtype=np.float32)
    pools = [rng.standard_normal((n_pages, PAGE_SIZE, HEADS, HEAD_DIM),
                                 dtype=np.float32) for _ in range(2)]
    dev = torch.device("cuda")
    args = tuple(torch.from_numpy(x).to(dev) for x in
                 (q, *pools, tables, lengths))
    return args, torch.from_numpy(act).to(dev)


def paged_cases(torch, rng, lengths):
    """The paged kernel's three cases: ``(label, inputs, rows)`` where
    ``rows`` are the slots the plain version is held on (None: all).
    path: the serving config's 64 slots x 2 pages; long: 64 slots x 32
    pages; few-long: 4 long slots among 60 idle ones (the plain version on
    the active rows only: gathering all 64 slots' 256 pages would
    materialise 4 GiB)."""
    P = -(-(max(LENGTH_BUCKETS) + MAX_NEW) // PAGE_SIZE)
    yield "path", paged_inputs(torch, rng, SLOTS, P, lengths[0]), None
    yield "long", paged_inputs(torch, rng, SLOTS, 32, lengths[1]), None
    yield ("few-long", *few_long_inputs(torch, rng))


def serving_lengths(rng, slots):
    """Context lengths as the serving mix gives them: a prompt of 4-60
    tokens plus 0-63 generated, plus the token being decoded."""
    return rng.integers(4, 60, slots) + rng.integers(0, MAX_NEW, slots) + 1


def attention_bound(lengths, slots, pages_per_seq, heads=HEADS):
    """Least time for one call on this card: each valid K/V row read
    once, q/tables/lengths read and the output written once; the
    operations are 4 flops per K/V element pair (q.k and p.v)."""
    ctx = pages_per_seq * PAGE_SIZE
    valid = int(np.minimum(np.maximum(lengths, 0), ctx).sum())
    row = heads * HEAD_DIM
    nbytes = (valid * row * 4 * 2 + 2 * slots * row * 4
              + slots * pages_per_seq * 4 + slots * 4)
    flops = 4 * valid * row
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters, flush):
    """Mean device time of ``fn()`` by CUDA events, the L2 cache
    overwritten before every launch (the decode path finds its pages
    cold: four layers of pages exceed the 50 MB L2).  After the
    overwrite the card sleeps HOST_SLACK_CYCLES (~2 ms) before the start
    event, so the host has enqueued all of ``fn``'s work by the time the
    measured span opens: host latency (an autograd backward hands its
    launches to another thread, ~0.2 ms on a slow host) stays out of
    it."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.zero_()
        torch.cuda._sleep(HOST_SLACK_CYCLES)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in zip(starts, ends)]))


# ------------------------------------------------------------------ phases --
def card_report(torch):
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"card: {name} x{count}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    expect(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0].strip()
    return name, count, smi_line


def build_kernels():
    from mxnet_tpu_torch.ops import cuda as kcuda

    t0 = time.perf_counter()
    libs = kcuda.build_all()
    dt = time.perf_counter() - t0
    log(f"build: {sorted(libs)} in {dt:.2f} s")
    return dt


def plain_rows(torch, fn, args, rows):
    """The plain version on every slot, or on the slots ``rows`` only
    (slots are independent)."""
    if rows is None:
        return fn(*args)
    q, kp, vp, tables, lens = args
    return fn(q[rows], kp, vp, tables[rows], lens[rows])


def kernel_vs_plain(torch, rng):
    """The paged kernel against its plain version at the path, long and
    few-long cases: within ATOL/RTOL on every active slot, exact zeros on
    the idle ones, the same bits from a second launch, and one call under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync in the
    wrapper fails the run)."""
    from mxnet_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference)

    worst = 0.0
    P = -(-(max(LENGTH_BUCKETS) + MAX_NEW) // PAGE_SIZE)
    lengths = (
        np.concatenate([[0, 1, PAGE_SIZE - 1, PAGE_SIZE, PAGE_SIZE + 1,
                         P * PAGE_SIZE], serving_lengths(rng, SLOTS - 6)]),
        np.concatenate([[0, 1, PAGE_SIZE, PAGE_SIZE + 1, 32 * PAGE_SIZE - 1,
                         32 * PAGE_SIZE],
                        rng.integers(1, 32 * PAGE_SIZE + 1, SLOTS - 6)]))
    for label, args, rows in paged_cases(torch, rng, lengths):
        lens = args[-1]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = paged_decode_attention(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        again = paged_decode_attention(*args)
        ref = plain_rows(torch, paged_decode_attention_reference, args, rows)
        torch.cuda.synchronize()
        act = lens > 0
        got = out[act] if rows is None else out[rows]
        want = ref[act] if rows is None else ref
        expect(bool(torch.isfinite(out).all()), f"{label}: non-finite")
        expect(bool((out[~act] == 0).all()),
               f"{label}: a length-0 slot is not zero")
        expect(torch.equal(out, again),
               f"{label}: a second launch gave other bits")
        err = (got - want).abs()
        tol = ATOL + RTOL * want.abs()
        max_err = float(err.max())
        worst = max(worst, max_err)
        log(f"kernel vs plain [{label}: pages_per_seq {args[3].shape[1]}, "
            f"lengths {int(lens.min())}..{int(lens.max())}, "
            f"{int(act.sum())} active]: max abs err {max_err:.3e} (atol "
            f"{ATOL}, rtol {RTOL}); idle slots zero, a second launch the "
            f"same bits, no host sync")
        expect(bool((err <= tol).all()),
               f"{label}: kernel disagrees with its plain version")
        del args, out, again, ref
    torch.cuda.empty_cache()
    return worst


def decode_parity(torch, rng, params, cfg):
    from mxnet_tpu_torch.ops.paged_attention import \
        paged_decode_attention_reference
    from mxnet_tpu_torch.serving.generate import decode_logits

    dev = torch.device("cuda")
    P = -(-(max(LENGTH_BUCKETS) + MAX_NEW) // PAGE_SIZE)
    shape = (LAYERS, N_PAGES, PAGE_SIZE, HEADS, HEAD_DIM)
    gen = torch.Generator(device=dev).manual_seed(1)
    k_pool = 0.5 * torch.randn(shape, device=dev, generator=gen)
    v_pool = 0.5 * torch.randn(shape, device=dev, generator=gen)
    lengths = np.minimum(serving_lengths(rng, SLOTS) - 1, P * PAGE_SIZE - 1)
    active = rng.random(SLOTS) < 0.9
    perm = rng.permutation(np.arange(1, N_PAGES))[:SLOTS * P]
    tables = perm.reshape(SLOTS, P).astype(np.int32)
    tokens = rng.integers(0, VOCAB, SLOTS)
    args = [torch.from_numpy(np.asarray(x)).to(dev) for x in
            (tokens.astype(np.int32), lengths.astype(np.int32), active,
             tables)]
    outs = {}
    for label, attn in (("kernel", None),
                        ("plain", paged_decode_attention_reference)):
        kc, vc = k_pool.clone(), v_pool.clone()
        with torch.no_grad():
            logits = decode_logits(params, cfg, PAGE_SIZE, kc, vc, *args,
                                   attention=attn)
        outs[label] = (logits, kc, vc)
    torch.cuda.synchronize()
    act = torch.from_numpy(active).to(dev)
    lk, lp = outs["kernel"][0][act], outs["plain"][0][act]
    err = float((lk - lp).abs().max())
    log(f"decode forward, kernel vs plain ({int(active.sum())} active of "
        f"{SLOTS} slots): max abs logit err {err:.3e} "
        f"(atol {LOGIT_ATOL}, rtol {LOGIT_RTOL})")
    expect(bool(torch.allclose(lk, lp, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)),
           "decode logits: kernel path disagrees with plain path")
    expect(bool(torch.isfinite(outs["kernel"][0]).all()),
           "decode logits not finite")
    # page 0 is the sink: inactive slots write there whatever their
    # (ignored) attention rows hold, and those rows legitimately differ
    for i in (1, 2):
        expect(bool(torch.allclose(outs["kernel"][i][:, 1:],
                                   outs["plain"][i][:, 1:],
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)),
               "decode K/V pool writes disagree")
    return err


def serve(torch, params, cfg, capture=None, check=True):
    """``N_REQUESTS`` greedy requests through a ``GenerationServer``:
    captured steps (the default, the main path) or eager ones
    (``capture=False``, the yardstick).  Returns the numbers and the
    tokens."""
    from mxnet_tpu_torch.ops.paged_attention import paged_decode_attention
    from mxnet_tpu_torch.serving import BucketSpec, GenerationServer

    prompts = serve_prompts()
    how = "eager" if capture is False else "captured"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paged_decode_attention.launches = 0          # main path starts here
    srv = GenerationServer(
        params, cfg, buckets=BucketSpec(batch=BATCH_BUCKETS,
                                        length=LENGTH_BUCKETS),
        n_slots=SLOTS, n_pages=N_PAGES, page_size=PAGE_SIZE,
        max_new_tokens=MAX_NEW, max_queue=N_REQUESTS, seed=0,
        device="cuda", capture=capture, name=f"ChipSmokeGen-{how}")
    t_start = time.perf_counter()
    srv.start()
    t_ready = time.perf_counter()
    graphs = srv.graph_count()
    expect(graphs == (srv.census() if capture is None else 0),
           f"serve [{how}]: {graphs} graphs after start, census "
           f"{srv.census()}")
    try:
        t0 = time.perf_counter()
        reqs = [srv.submit(p) for p in prompts]
        outs = [r.result(timeout=600) for r in reqs]
        dt = time.perf_counter() - t0
    finally:
        expect(srv.drain(60), "server did not drain")
    launches = paged_decode_attention.launches   # ... and ends here
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    st = srv.stats
    n_tok = sum(len(o) for o in outs)
    expect(all(len(o) == MAX_NEW for o in outs),
           "a request resolved with the wrong token count")
    expect(all(o.min() >= 0 and o.max() < VOCAB for o in outs),
           "token ids out of range")
    expect(st["completed"] == N_REQUESTS and st["failed"] == 0,
           f"server stats {st}")
    expect(launches >= st["decode_steps"] * LAYERS > 0,
           f"kernel launches {launches} < decode steps "
           f"{st['decode_steps']} x {LAYERS} layers")
    log(f"serve [{how}]: {N_REQUESTS} requests, {n_tok} tokens in "
        f"{dt:.3f} s = {n_tok / dt:.1f} tokens/s; warmup (and capture) "
        f"{t_ready - t_start:.3f} s; graphs {graphs}, census "
        f"{srv.census()}; "
        f"decode steps {st['decode_steps']}, prefills {st['prefills']}, "
        f"preempted {st['preempted']}; kernel launches {launches}; peak "
        f"device memory {peak / 2**20:.1f} MiB")
    res = {"tokens_per_s": n_tok / dt, "decode_steps": st["decode_steps"],
           "launches": launches, "peak_bytes": peak, "outs": outs,
           "prompts": prompts}
    if check:
        teacher_forced(torch, params, cfg, prompts, outs, "serve")
    return res


def teacher_forced(torch, params, cfg, prompts, outs, what, n=16):
    """Every generated token of the first ``n`` requests is the argmax of
    the full forward (plain PyTorch, no kernel) over prompt + output so
    far, up to a near-tie of 1e-4 between two logits."""
    from mxnet_tpu_torch.gluon.model_zoo.causal_lm import sequence_logits

    dev = torch.device(DEVICE)
    worst_gap, exact, total = 0.0, 0, 0
    for p, o in zip(prompts[:n], outs[:n]):
        full = np.concatenate([p, o])
        toks = torch.from_numpy(full[None].astype(np.int32)).to(dev)
        with torch.no_grad():
            lg = sequence_logits(params, cfg, toks)[0]
        rows = lg[len(p) - 1:len(full) - 1]
        chosen = rows.gather(1, torch.from_numpy(o.astype(np.int64))
                             .to(dev)[:, None])[:, 0]
        gap = float((rows.max(dim=1).values - chosen).max())
        worst_gap = max(worst_gap, gap)
        exact += int((rows.argmax(dim=1).cpu().numpy() == o).sum())
        total += len(o)
    log(f"teacher-forced check [{what}] of {min(n, len(outs))} requests: "
        f"{exact}/{total} tokens are the exact argmax, worst logit "
        f"shortfall {worst_gap:.3e}")
    expect(worst_gap <= 1e-4,
           f"{what}: served tokens disagree with the full forward")


def serve_prompts():
    """The serve phase's traffic: ``N_REQUESTS`` prompts of 4-60 random
    tokens from ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    return [rng.randint(0, VOCAB, size=int(rng.randint(4, 60)))
            .astype(np.int32) for _ in range(N_REQUESTS)]


def two_call_route(torch, q, kp, vp, tables, lens):
    """For context only, never ``library_ms``: the library route for the
    same function in two calls, the pages gathered by table
    (``k_pages[idx]``) and then ``scaled_dot_product_attention`` under a
    length mask."""
    import torch.nn.functional as F

    n_pages, page, heads, d = kp.shape
    slots, pps = tables.shape
    idx = tables.long().clamp(0, n_pages - 1)
    k = kp[idx].reshape(slots, pps * page, heads, d).transpose(1, 2)
    v = vp[idx].reshape(slots, pps * page, heads, d).transpose(1, 2)
    pos = torch.arange(pps * page, device=q.device)
    mask = (pos[None, :] < lens[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(q[:, :, None, :], k, v,
                                          attn_mask=mask)[:, :, 0]


def time_kernel(torch, rng):
    """The paged kernel at the path, long and few-long cases: CUDA events
    with L2 flushed beside its bound and its plain version (few-long: on
    the active rows), the launch plan of each case, ptxas's counts, and
    the wrapper's host time per call.  The two-call library route
    (gather, then SDPA) is printed at path and long for context."""
    from mxnet_tpu_torch.ops import cuda as kcuda
    from mxnet_tpu_torch.ops import paged_attention as pa

    smem = kcuda.load("paged_attention").paged_decode_attention_smem_bytes()
    ptxas_report("paged_attention.cu", lambda m: (
        "paged_decode_attention", smem,
        "a 3-stage ring of K/V bulk copies, scratch, barriers")
        if "paged_decode_attention_f32_kernel" in m else None)
    flush = torch.empty(1024 * 2**20, dtype=torch.uint8, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lengths = (serving_lengths(rng, SLOTS),
               rng.integers(1, 32 * PAGE_SIZE + 1, SLOTS))
    res = {}
    for label, args, rows in paged_cases(torch, rng, lengths):
        q, kp, vp, tables, lens = args
        lens_np = lens.cpu().numpy()
        pps = tables.shape[1]
        part = pa._partition(SLOTS, HEADS, HEAD_DIM, PAGE_SIZE, pps, sms)
        before = pa.paged_decode_attention.launches
        ms = time_ms(torch, lambda: pa.paged_decode_attention(*args), 200,
                     flush)
        plain_ms = time_ms(torch, lambda: plain_rows(
            torch, pa.paged_decode_attention_reference, args, rows),
            10 if rows is not None else 50, flush)
        pa.paged_decode_attention.launches = before  # timing is not the path
        bound_ms, bound_by = attention_bound(lens_np, SLOTS, pps)
        log(f"time [{label}: {SLOTS} slots, pages_per_seq {pps}, "
            f"{int(lens_np.sum())} context tokens; span {part.span}, "
            f"{part.n_split} splits, {part.head_chunks} head chunks, "
            f"{part.blocks} blocks]: kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms"
            f"{' (active rows)' if rows is not None else ''}, bound "
            f"{bound_ms:.4f} ms ({bound_by}), kernel at "
            f"{100 * bound_ms / ms:.1f}% of bound")
        res[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by}
        if label != "few-long":
            two_ms = time_ms(torch, lambda: two_call_route(torch, *args), 50,
                             flush)
            log(f"context [{label}]: two library calls (pages gathered by "
                f"table, then SDPA with a length mask) {two_ms:.4f} ms; not "
                f"library_ms, which is one call")
        if label == "path":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                pa.paged_decode_attention(*args)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            pa.paged_decode_attention.launches = before
            log(f"host: the wrapper takes {(t1 - t0) / HOST_CALLS * 1e6:.2f} "
                f"us a call ({HOST_CALLS} calls at the path case, no sync "
                f"between them)")
        del args
    torch.cuda.empty_cache()
    log("library: no single PyTorch call computes paged attention over a "
        "page table (SDPA needs the pages gathered first), so library_ms "
        "is null")
    return res


def profile_serving(torch, params, cfg, n_requests=64, capture=None,
                    what="serving", **kw):
    """Serve ``n_requests`` more under ``torch.profiler`` (captured
    steps, or eager ones with ``capture=False``; ``kw`` to the server,
    e.g. a draft) and print where the time goes — wall time per
    decode step, the device's busy and idle share (kernel time summed
    over the wall time), and the kernels that take the most device
    time.  Returns ``(ms per decode step, busy share)``."""
    from mxnet_tpu_torch.serving import BucketSpec, GenerationServer

    how = f"{what}, {'eager' if capture is False else 'captured'}"
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, VOCAB, size=int(rng.randint(4, 60)))
               .astype(np.int32) for _ in range(n_requests)]
    srv = GenerationServer(
        params, cfg, buckets=BucketSpec(batch=BATCH_BUCKETS,
                                        length=LENGTH_BUCKETS),
        n_slots=SLOTS, n_pages=N_PAGES, page_size=PAGE_SIZE,
        max_new_tokens=MAX_NEW, max_queue=n_requests, seed=1,
        device="cuda", capture=capture,
        name=f"ChipSmokeProfile-{how}", **kw).start()

    def serve():                    # the server's counts in this session
        s0 = {k: srv.stats[k] for k in ("decode_steps", "prefills")}
        for r in [srv.submit(p) for p in prompts]:
            r.result(timeout=600)
        return {k: srv.stats[k] - s0[k] for k in s0}

    try:
        prof, wall_us, st = profiled(torch, serve, how)
    finally:
        expect(srv.drain(60), "profiled server did not drain")
    per_step = wall_us / 1e3 / max(st['decode_steps'], 1)
    log(f"profile [{how}]: {n_requests} requests, "
        f"{st['decode_steps']} decode steps, {st['prefills']} prefills in "
        f"{wall_us / 1e3:.3f} ms = {per_step:.3f} ms wall per decode step")
    return per_step, print_profile(prof, wall_us, how)


def serve_without_syncs(torch, params, cfg, n_requests=16):
    """A captured server answers ``n_requests`` greedy requests under
    ``torch.cuda.set_sync_debug_mode("error")``: a step may not sync the
    host apart from its token read-back, which waits on a CUDA event
    (not a sync the debug mode flags).  Its tokens equal the eager
    server's."""
    from mxnet_tpu_torch.serving import BucketSpec, GenerationServer

    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, VOCAB, size=int(rng.randint(4, 60)))
               .astype(np.int32) for _ in range(n_requests)]
    outs = {}
    for capture in (None, False):
        srv = GenerationServer(
            params, cfg, buckets=BucketSpec(batch=BATCH_BUCKETS,
                                            length=LENGTH_BUCKETS),
            n_slots=SLOTS, n_pages=N_PAGES, page_size=PAGE_SIZE,
            max_new_tokens=MAX_NEW, max_queue=n_requests, seed=2,
            device="cuda", capture=capture,
            name=f"ChipSmokeNoSync-{capture}").start()
        torch.cuda.synchronize()
        if capture is None:
            torch.cuda.set_sync_debug_mode("error")
        try:
            reqs = [srv.submit(p) for p in prompts]
            outs[capture] = [r.result(timeout=600) for r in reqs]
        finally:
            torch.cuda.set_sync_debug_mode(0)
            expect(srv.drain(60), "server did not drain")
        st = srv.stats
        expect(st["completed"] == n_requests and st["failed"] == 0,
               f"serve under sync debug mode: {st}")
    expect(all(np.array_equal(a, b) for a, b in zip(outs[None],
                                                     outs[False])),
           "captured tokens differ from the eager server's")
    log(f"serve [captured, set_sync_debug_mode('error')]: {n_requests} "
        f"requests, {sum(map(len, outs[None]))} tokens, no host sync but "
        f"the token read-back; tokens equal the eager server's")


def device_us(e):
    """The device time of one profiler event, across torch versions."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_rows(prof):
    """The profile's device events (kernels and copies) that took time."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_us(e) > 0]


def profiled(torch, fn, what):
    """``fn()`` under ``torch.profiler`` (host and CUDA activity), the
    device synchronised before and after.  Returns ``(prof, wall_us,
    fn's result)``.  A session that comes back without a single device
    event (the card's profiler has returned one such session among many
    runs) is logged and ``fn`` is profiled once more; ``print_profile``
    then fails the run if that one too saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        if device_rows(prof) or attempt == PROFILE_TRIES - 1:
            return prof, wall_us, out
        log(f"profile [{what}]: the session saw no device event "
            f"({len(prof.key_averages())} host events in "
            f"{wall_us / 1e3:.3f} ms); profiling it once more")


def warm_profiler(torch):
    """One profiled matmul on the card before any measured session, so
    that the profiler's first start (CUPTI's set-up) is not inside one;
    logs how many device events it saw."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.ones(256, 256, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (a @ a).sum().item()
        torch.cuda.synchronize()
    log(f"profiler warm-up: {len(device_rows(prof))} kinds of device "
        f"event seen")


def print_profile(prof, wall_us, what, rows=None):
    """The device's busy and idle share of ``wall_us`` (the time of the
    device's own events — kernels and copies — summed; the host ops that
    launched them are left out, or their device time would count twice),
    how many device events ran, and the 12 that take the most device
    time.  ``rows``: ``device_rows(prof)`` where the caller has them."""
    rows = device_rows(prof) if rows is None else rows
    busy_us = sum(device_us(e) for e in rows)
    expect(busy_us > 0, "the profiler saw no device time")
    busy = busy_us / wall_us
    log(f"profile [{what}]: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms = {100 * busy_us / wall_us:.1f}% of wall, "
        f"idle {100 - 100 * busy_us / wall_us:.1f}%; "
        f"{sum(e.count for e in rows)} device events")
    for e in sorted(rows, key=device_us, reverse=True)[:12]:
        log(f"profile:   {device_us(e) / 1e3:9.3f} ms  "
            f"{100 * device_us(e) / busy_us:5.1f}%  x{e.count:<6d} "
            f"{e.key[:90]}")
    return busy


# -------------------------------------------------------- serving features --
def count_launches(fn):
    """``fn()`` with every kernel's launch count set to 0 just before it;
    returns ``(fn's result, the paged kernel's launches in it)``."""
    from mxnet_tpu_torch.ops.paged_attention import paged_decode_attention

    paged_decode_attention.launches = 0
    out = fn()
    return out, paged_decode_attention.launches


def feature_server(torch, params, cfg, name, capture=None,
                   lengths=LENGTH_BUCKETS, n_requests=N_REQUESTS,
                   warmup=True, **kw):
    """A started ``GenerationServer`` at the serve phase's width (captured
    steps by default, eager with ``capture=False``), its graphs checked
    against its census (none yet with ``warmup=False``)."""
    from mxnet_tpu_torch.serving import BucketSpec, GenerationServer

    srv = GenerationServer(
        params, cfg, buckets=BucketSpec(batch=BATCH_BUCKETS, length=lengths),
        n_slots=SLOTS, n_pages=N_PAGES, page_size=PAGE_SIZE,
        max_new_tokens=MAX_NEW, max_queue=n_requests, seed=0,
        device=DEVICE, capture=capture, name=name, **kw).start(warmup)
    if warmup:
        expect_graphs(srv, capture, name)
    else:
        expect(srv.graph_count() == 0, f"{name}: graphs before traffic")
    return srv


def expect_graphs(srv, capture, what):
    """A captured server holds its census of graphs (an eager one, or one
    on the host, none)."""
    want = srv.census() if capture is None and DEVICE == "cuda" else 0
    expect(srv.graph_count() == want, f"{what}: {srv.graph_count()} "
           f"graphs, want {want} (census {srv.census()})")


def run_requests(srv, prompts, **kw):
    """Submit every prompt, wait for all, drain; returns the tokens and
    the seconds from the first submit to the last result."""
    try:
        t0 = time.perf_counter()
        reqs = [srv.submit(p, **kw) for p in prompts]
        outs = [r.result(timeout=600) for r in reqs]
        dt = time.perf_counter() - t0
    finally:
        expect(srv.drain(60), f"{srv._name} did not drain")
    st = srv.stats
    expect(st["completed"] == len(prompts) and st["failed"] == 0,
           f"{srv._name}: stats {st}")
    expect(all(len(o) == MAX_NEW and o.min() >= 0 and o.max() < VOCAB
               for o in outs), f"{srv._name}: a wrong token count or id")
    return outs, dt


def verify_shape_inputs(torch, rng):
    """The verify step's attention call at the serve width: SLOTS slots x
    (SPEC_K + 1) lanes, each slot's table (of the speculative server's
    width) repeated per lane, lane i over the slot's cached length + i +
    1 positions.  Returns the five inputs on the card and the cached
    lengths."""
    k1 = SPEC_K + 1
    pps = -(-(max(LENGTH_BUCKETS) + MAX_NEW + SPEC_K) // PAGE_SIZE)
    cached = serving_lengths(rng, SLOTS) - 1
    lanes = (np.repeat(cached, k1) + np.tile(np.arange(k1), SLOTS)
             + 1).astype(np.int32)
    n_pages = 1 + SLOTS * pps
    q = rng.standard_normal((SLOTS * k1, HEADS, HEAD_DIM), dtype=np.float32)
    kp = rng.standard_normal((n_pages, PAGE_SIZE, HEADS, HEAD_DIM),
                             dtype=np.float32)
    vp = rng.standard_normal((n_pages, PAGE_SIZE, HEADS, HEAD_DIM),
                             dtype=np.float32)
    tables = np.repeat(rng.permutation(np.arange(1, n_pages)).astype(
        np.int32).reshape(SLOTS, pps), k1, axis=0)
    dev = torch.device(DEVICE)
    return tuple(torch.from_numpy(x).to(dev) for x in
                 (q, kp, vp, tables, lanes)), cached


def verify_bound(cached, pps):
    """Least time for one verify-shape call: each slot's K/V rows read
    once (the longest lane's, cached + SPEC_K + 1), q, the repeated
    tables and the lane lengths read and the output written once; 4
    flops per K/V element pair of every lane."""
    k1 = SPEC_K + 1
    row = HEADS * HEAD_DIM
    rows = SLOTS * k1
    kv = int((cached + k1).sum())
    nbytes = kv * row * 4 * 2 + 2 * rows * row * 4 + rows * pps * 4 + rows * 4
    lane_ctx = int((np.repeat(cached, k1) + np.tile(np.arange(k1), SLOTS)
                    + 1).sum())
    flops = 4 * lane_ctx * row
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_at_verify_shape(torch, rng):
    """The paged kernel at the verify step's shape against its plain
    version (ATOL/RTOL on every row, a second launch the same bits, no
    host sync), then timed with L2 flushed beside its bound and its
    plain version."""
    from mxnet_tpu_torch.ops import paged_attention as pa

    args, cached = verify_shape_inputs(torch, rng)
    pps = args[3].shape[1]
    before = pa.paged_decode_attention.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pa.paged_decode_attention(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    again = pa.paged_decode_attention(*args)
    ref = pa.paged_decode_attention_reference(*args)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    max_err = float(err.max())
    expect(bool(torch.isfinite(out).all()), "verify shape: non-finite")
    expect(torch.equal(out, again), "verify shape: a second launch gave "
           "other bits")
    expect(bool((err <= ATOL + RTOL * ref.abs()).all()),
           "verify shape: kernel disagrees with its plain version")
    flush = torch.empty(1024 * 2**20, dtype=torch.uint8, device=DEVICE)
    ms = time_ms(torch, lambda: pa.paged_decode_attention(*args), 200, flush)
    plain_ms = time_ms(torch, lambda: pa.paged_decode_attention_reference(
        *args), 50, flush)
    pa.paged_decode_attention.launches = before  # checks are not the path
    bound_ms, bound_by = verify_bound(cached, pps)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    part = pa._partition(args[0].shape[0], HEADS, HEAD_DIM, PAGE_SIZE, pps,
                         sms)
    lens = args[4]
    log(f"kernel vs plain [verify: {SLOTS} slots x {SPEC_K + 1} lanes, "
        f"pages_per_seq {pps}, lane lengths {int(lens.min())}.."
        f"{int(lens.max())}]: max abs err {max_err:.3e} (atol {ATOL}, "
        f"rtol {RTOL}); a second launch the same bits, no host sync")
    log(f"time [verify: {args[0].shape[0]} rows, span {part.span}, "
        f"{part.n_split} splits, {part.head_chunks} head chunks, "
        f"{part.blocks} blocks]: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, bound {bound_ms:.4f} ms ({bound_by}), kernel at "
        f"{100 * bound_ms / ms:.1f}% of bound")
    del args, out, again, ref, flush
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": max_err}


def prefix_prompts():
    """Shared-prefix traffic: a system prompt ``P`` of three pages (192
    tokens) from ``RandomState(0)``; request 0 is ``P`` (three full
    pages resident), every fourth is ``P[:n]``, n in 129-191 (it ends
    inside block 2 and maps onto the resident full block: a CoW fault at
    its first decode write), the others ``P[:144]`` plus 16 random
    tokens (bench.py's 90%-shared 160-token shape at page 64)."""
    rng = np.random.RandomState(0)
    system = rng.randint(0, VOCAB, size=3 * PAGE_SIZE).astype(np.int32)
    plen = PAGE_SIZE * 5 // 2
    shared = int(plen * 0.9)
    prompts = [system.copy()]
    for i in range(1, PREFIX_REQUESTS):
        if i % 4 == 0:
            n = int(rng.randint(2 * PAGE_SIZE + 1, 3 * PAGE_SIZE))
            prompts.append(system[:n].copy())
        else:
            prompts.append(np.concatenate([system[:shared], rng.randint(
                0, VOCAB, size=plen - shared).astype(np.int32)]))
    return prompts


def serve_prefix(torch, params, cfg):
    """Shared-prefix traffic through captured steps, then eager steps:
    the same tokens, the teacher-forced argmax, CoW faults taken, pages
    shared, fewer pages charged than unshared prompts take, the pool
    whole after the drain."""
    prompts = prefix_prompts()
    runs = {}
    for capture in (None, False):
        how = "eager" if capture is False else "captured"
        srv = feature_server(torch, params, cfg, f"ChipSmokePrefix-{how}",
                             capture=capture, lengths=PREFIX_LENGTHS,
                             n_requests=PREFIX_REQUESTS)
        (outs, dt), launches = count_launches(
            lambda: run_requests(srv, prompts))
        st = srv.stats
        a = srv.alloc
        expect(a.free_count() == a.allocatable and a.live_pages() == 0
               and a.shared_pages() == 0,
               f"prefix [{how}]: pages left after drain")
        expect(srv._indexed_by_page == {} and srv._children == {},
               f"prefix [{how}]: prefix index not empty after drain")
        expect_graphs(srv, capture, f"prefix [{how}] after the run")
        expect(launches >= st["decode_steps"] * LAYERS > 0,
               f"prefix [{how}]: {launches} kernel launches")
        runs[how] = (outs, dt, st, launches, srv.census())
    outs, dt, st, launches, census = runs["captured"]
    expect(all(np.array_equal(a, b) for a, b in zip(outs,
                                                    runs["eager"][0])),
           "prefix: captured tokens differ from the eager ones")
    teacher_forced(torch, params, cfg, prompts, outs, "prefix")
    unshared = sum(-(-len(p) // PAGE_SIZE) for p in prompts)
    page_bytes = 2 * LAYERS * PAGE_SIZE * HEADS * HEAD_DIM * 4
    expect(st["cow_faults"] >= 1, "prefix: no CoW fault taken")
    expect(st["pages_shared_mapped"] > 0, "prefix: no page shared")
    expect(st["pages_charged"] < unshared,
           f"prefix: {st['pages_charged']} pages charged, unshared "
           f"prompts take {unshared}")
    n_tok = sum(map(len, outs))
    log(f"prefix [captured]: {PREFIX_REQUESTS} requests, {n_tok} tokens in "
        f"{dt:.3f} s = {n_tok / dt:.1f} tokens/s (eager "
        f"{n_tok / runs['eager'][1]:.1f}); graphs = census {census}; "
        f"prefills {st['prefills']}, decode steps {st['decode_steps']}, "
        f"kernel launches {launches}; cow_faults {st['cow_faults']}, "
        f"pages_shared_mapped {st['pages_shared_mapped']}, pages_charged "
        f"{st['pages_charged']} of {unshared} unshared, page_bytes_per_seq "
        f"{st['pages_charged'] * page_bytes / PREFIX_REQUESTS:.0f}; the "
        f"same tokens captured and eager; pool whole after drain")
    return {"launches": launches, "tokens_per_s": n_tok / dt}


def serve_speculative(torch, params, cfg, plain):
    """The serve phase's traffic through speculative servers, spec_k
    SPEC_K and window SPEC_WINDOW: (a) a 1-layer draft of seeded random
    weights (acceptance near zero: the reject path), (b) the target as
    its own draft (only its window differs), (c) the same with a window
    that holds every context (the draft is then the target: the accept
    path, 1 + SPEC_K tokens a step but for near-ties).  Each: captured
    against eager (on the first SPEC_EAGER_REQUESTS prompts), the
    teacher-forced argmax, graphs = census = grid + 2, how many outputs
    equal the plain server's."""
    from mxnet_tpu_torch.gluon.model_zoo.causal_lm import (draft_config,
                                                           init_causal_lm)

    prompts = plain["prompts"]
    small = draft_config(cfg)
    whole = max(LENGTH_BUCKETS) + MAX_NEW
    drafts = {"draft-1-layer": (small, init_causal_lm(
                  small, torch.Generator().manual_seed(1), device=DEVICE),
                  SPEC_WINDOW),
              "self-draft": (draft_config(cfg, n_layers=LAYERS), params,
                             SPEC_WINDOW),
              f"self-draft, window {whole}": (
                  draft_config(cfg, n_layers=LAYERS), params, whole)}
    res = {}
    for label, (dcfg, dparams, window) in drafts.items():
        runs = {}
        for capture in (None, False):
            how = "eager" if capture is False else "captured"
            # the eager yardstick on the first SPEC_EAGER_REQUESTS prompts
            run = prompts if capture is None \
                else prompts[:SPEC_EAGER_REQUESTS]
            srv = feature_server(torch, params, cfg,
                                 f"ChipSmokeSpec-{label}-{how}",
                                 capture=capture, draft=dparams,
                                 draft_config=dcfg, spec_k=SPEC_K,
                                 spec_window=window)
            expect(srv.census() == len(BATCH_BUCKETS) * len(LENGTH_BUCKETS)
                   + 2, f"spec [{label}]: census {srv.census()}")
            (outs, dt), launches = count_launches(
                lambda: run_requests(srv, run))
            st = srv.stats
            expect_graphs(srv, capture, f"spec [{label}, {how}] after the "
                          f"run")
            expect(launches >= st["verify_steps"] * LAYERS > 0,
                   f"spec [{label}, {how}]: {launches} kernel launches for "
                   f"{st['verify_steps']} verify steps")
            expect(srv.alloc.free_count() == srv.alloc.allocatable,
                   f"spec [{label}, {how}]: pages left after drain")
            runs[how] = (outs, dt, st, launches)
        outs, dt, st, launches = runs["captured"]
        eager = runs["eager"][0]
        expect(all(np.array_equal(a, b) for a, b in zip(outs, eager)),
               f"spec [{label}]: captured tokens differ from the eager ones")
        teacher_forced(torch, params, cfg, prompts, outs, f"spec {label}")
        same = sum(np.array_equal(a, b) for a, b in zip(outs, plain["outs"]))
        n_tok = sum(map(len, outs))
        rate = st["spec_accepted"] / max(st["spec_proposed"], 1)
        log(f"spec [{label}, captured]: {N_REQUESTS} requests, {n_tok} "
            f"tokens in {dt:.3f} s = {n_tok / dt:.1f} tokens/s (eager, the "
            f"first {len(eager)} requests: "
            f"{sum(map(len, eager)) / runs['eager'][1]:.1f}, the same "
            f"tokens as captured's; plain server "
            f"{plain['tokens_per_s']:.1f}); acceptance {rate:.4f} "
            f"({st['spec_accepted']} of {st['spec_proposed']}), verify steps "
            f"{st['verify_steps']} (plain decode steps "
            f"{plain['decode_steps']}), kernel launches {launches}; graphs = "
            f"census {srv.census()}; {same} of {N_REQUESTS} outputs equal "
            f"the plain server's token for token (near-ties may part: the "
            f"verify step's kernel plan sums in another order)")
        res[label] = {"launches": launches, "tokens_per_s": n_tok / dt,
                      "accept_rate": rate, "same_as_plain": same,
                      "verify_steps": st["verify_steps"]}
    return res


def serve_salvage_resume(torch, params, cfg, plain, root):
    """Salvage and resume under captured steps, RESUME_REQUESTS of the
    serve phase's requests (their plain tokens the reference): (a) one
    decode step faulted mid-run, every request completes with the
    reference tokens; then ``handoff_and_resume``, its journal in a
    temporary directory under ``root``."""
    from mxnet_tpu_torch import fault

    prompts = plain["prompts"][:RESUME_REQUESTS]
    ref = plain["outs"][:RESUME_REQUESTS]
    n = RESUME_REQUESTS

    srv = feature_server(torch, params, cfg, "ChipSmokeSalvage",
                         n_requests=n, salvage_retries=1)

    def faulted():
        with fault.inject("generate.decode", RuntimeError("injected"),
                          after_n=MAX_NEW // 2, times=1) as h:
            out = run_requests(srv, prompts)
        expect(h.fired == 1, "salvage: the fault did not fire")
        return out

    (outs, _), launches = count_launches(faulted)
    st = srv.stats
    expect(all(np.array_equal(a, b) for a, b in zip(outs, ref)),
           "salvage: a salvaged request's tokens differ from the unfaulted "
           "run's")
    expect(st["salvage_retries"] >= 1 and st["resumes"] >= 1
           and st["failed"] == 0, f"salvage: stats {st}")
    log(f"salvage [captured, salvage_retries=1]: generate.decode faulted "
        f"once mid-run; {st['salvage_retries']} seated sequences salvaged "
        f"(one retry each), {st['tokens_salvaged']} tokens kept, "
        f"{st['resumes']} resumes; all {n} requests complete with the "
        f"unfaulted run's tokens; kernel launches {launches}")

    # the journal lives in a temporary directory of the checkout
    with tempfile.TemporaryDirectory(dir=root, prefix=".smoke-") as jdir:
        handoff_and_resume(torch, params, cfg, prompts, ref,
                           os.path.join(jdir, "journal.jsonl"))
    return {"launches": launches}


def handoff_and_resume(torch, params, cfg, prompts, ref, jpath):
    """``drain(handoff=True)`` of a journaled server after about half
    the tokens, then the exports resumed by a second server
    (``submit_resume``) and the journal restored by a third: both
    complete with ``ref``, the uninterrupted run's tokens."""
    n = len(prompts)
    first = feature_server(torch, params, cfg, "ChipSmokeHandoff",
                           n_requests=n, journal=jpath, journal_every=8)
    reqs = [first.submit(p) for p in prompts]
    limit = time.monotonic() + 300
    while first.stats["tokens_out"] < n * MAX_NEW // 2 \
            and time.monotonic() < limit:
        time.sleep(0.001)
    expect(first.drain(60, handoff=True), "handoff drain did not finish")
    done = [r for r in reqs if r.exception(timeout=5) is None]
    exported = list(first.exported)
    expect(len(done) + len(exported) == n and exported,
           f"handoff: {len(done)} done + {len(exported)} exported != {n}")
    expect(all(np.array_equal(r.result(0), ref[i]) for i, r in
               enumerate(reqs) if r.exception(0) is None),
           "handoff: a finished request's tokens differ")
    for label, resume in (
            ("submit_resume", lambda s: {x.rid: s.submit_resume(x)
                                         for x in exported}),
            ("restore_journal", lambda s: s.restore_journal(jpath))):
        succ = feature_server(torch, params, cfg, f"ChipSmokeResume-{label}",
                              n_requests=n)
        try:
            resumed = resume(succ)
            got = {rid: r.result(timeout=600) for rid, r in resumed.items()}
        finally:
            expect(succ.drain(60), f"{label}: successor did not drain")
        expect(sorted(got) == sorted(x.rid for x in exported),
               f"{label}: resumed {sorted(got)}")
        expect(all(np.array_equal(o, ref[rid]) for rid, o in got.items()),
               f"{label}: a resumed request's tokens differ from the "
               f"uninterrupted run's")
        log(f"resume [{label}]: {len(got)} exported sequences (with "
            f"{sum(len(x.out) for x in exported)} tokens generated before "
            f"the drain) complete with the uninterrupted run's tokens")


# --------------------------------------------------- disaggregated serving --
def expect_disaggregated(srv, what):
    """After a disaggregated server's traffic and drain: its graphs
    still equal its census (grid + handoff + decode), the handoff path
    ran, every page is back and no group is in flight."""
    grid = len(srv.buckets.batch) * len(srv.buckets.length)
    expect(srv.census() == grid + 2, f"{what}: census {srv.census()}")
    expect_graphs(srv, None, f"{what} after the run")
    st, h = srv.stats, srv.healthz()
    expect(st["handoffs"] >= 1, f"{what}: no handoff ran")
    expect(srv.alloc.free_count() == srv.alloc.allocatable,
           f"{what}: pages left after drain")
    expect(h["prefill_inflight"] == 0 and h["prefill_workers"] >= 1,
           f"{what}: health {h}")


def same_or_teacher_forced(torch, params, cfg, prompts, outs, ref, what):
    """How many of ``outs`` equal ``ref`` token for token; where any
    differs, every output is held to the teacher-forced argmax and the
    reason is printed."""
    same = sum(np.array_equal(a, b) for a, b in zip(outs, ref))
    if same < len(ref):
        log(f"{what}: {len(ref) - same} of {len(ref)} outputs differ from "
            f"the fused server's (a prefill group's batch bucket follows "
            f"the traffic, and another GEMM shape may sum in another "
            f"order); held teacher-forced instead")
        teacher_forced(torch, params, cfg, prompts, outs, what,
                       n=len(prompts))
    return same


def serve_disaggregated(torch, params, cfg, plain):
    """The serve phase's traffic through captured disaggregated servers
    with 1 and 2 prefill workers (graphs = census = grid + 2 after start
    and after the traffic; tokens against the fused server's), then
    through one started with ``warmup=False`` and 2 workers, whose
    prefill graphs the workers capture while the decode loop runs."""
    prompts = plain["prompts"]
    res = {}
    for workers in (1, 2):
        what = f"disaggregated [{workers} worker{'s' * (workers > 1)}]"
        srv = feature_server(torch, params, cfg, f"ChipSmokeDisagg-w{workers}",
                             prefill_workers=workers)
        (outs, dt), launches = count_launches(
            lambda: run_requests(srv, prompts))
        expect_disaggregated(srv, what)
        st = srv.stats
        expect(launches >= st["decode_steps"] * LAYERS > 0,
               f"{what}: {launches} kernel launches")
        same = same_or_teacher_forced(torch, params, cfg, prompts, outs,
                                      plain["outs"], what)
        n_tok = sum(map(len, outs))
        log(f"{what}, captured: {N_REQUESTS} requests, {n_tok} tokens in "
            f"{dt:.3f} s = {n_tok / dt:.1f} tokens/s (fused "
            f"{plain['tokens_per_s']:.1f}); graphs = census {srv.census()}; "
            f"prefills {st['prefills']}, handoffs {st['handoffs']}, decode "
            f"steps {st['decode_steps']} (fused {plain['decode_steps']}); "
            f"kernel launches {launches}; {same} of {N_REQUESTS} outputs "
            f"equal the fused server's")
        res[workers] = {"launches": launches, "tokens_per_s": n_tok / dt,
                        "same": same}
    srv = feature_server(torch, params, cfg, "ChipSmokeDisagg-lazy",
                         warmup=False, prefill_workers=2)
    (outs, dt), launches = count_launches(lambda: run_requests(srv, prompts))
    graphs = srv.graph_count()
    on_card = DEVICE == "cuda"
    expect(3 * on_card <= graphs <= srv.census() * on_card,
           f"lazy: {graphs} graphs, census {srv.census()}")
    expect(launches >= srv.stats["decode_steps"] * LAYERS > 0,
           f"lazy: {launches} kernel launches")
    same = same_or_teacher_forced(torch, params, cfg, prompts, outs,
                                  plain["outs"], "disaggregated [lazy]")
    log(f"disaggregated [2 workers, start(warmup=False)]: {graphs} graphs "
        f"captured under traffic (census {srv.census()}: the buckets the "
        f"traffic used, the handoff and the decode graph), prefills "
        f"{srv.stats['prefills']}, handoffs {srv.stats['handoffs']}; "
        f"kernel launches {launches}; {same} of {N_REQUESTS} outputs "
        f"equal the fused server's")
    return res


def stall_prompts():
    """The stall phase's traffic: ``STALL_BYSTANDERS`` of the serve
    phase's prompts and ``STALL_LONG`` prompts of 1900-2040 random
    tokens from ``RandomState(3)``."""
    rng = np.random.RandomState(3)
    longs = [rng.randint(0, VOCAB, size=int(rng.randint(*STALL_LONG_TOKENS)))
             .astype(np.int32) for _ in range(STALL_LONG)]
    return serve_prompts()[:STALL_BYSTANDERS], longs


def stall_run(torch, params, cfg, workers, bystanders, longs, root):
    """One stall run: the bystanders seated and decoding alone for
    STALL_CALM steps, then the long prompts submitted; the decode
    loop's steps and the prefill and handoff spans read from the port's
    profiler (host clock, no device sync).  Returns the gaps between
    the starts of consecutive decode steps that overlap the time the
    long prompts are in flight (from their submit to the end of the
    last long prefill, fused, or handoff), the same over the STALL_CALM
    steps before, and the bystanders' tokens/s, over their whole run
    and from the long prompts' submit to the last bystander's
    result."""
    from mxnet_tpu_torch import profiler

    name = f"ChipSmokeStall-w{workers}"
    srv = feature_server(torch, params, cfg, name, lengths=STALL_LENGTHS,
                         n_requests=STALL_BYSTANDERS + STALL_LONG,
                         prefill_workers=workers)
    with tempfile.TemporaryDirectory(dir=root, prefix=".smoke-") as tdir:
        trace = os.path.join(tdir, "stall.json")
        profiler.set_config(filename=trace)
        profiler.start()
        try:
            t0 = time.perf_counter()
            reqs = [srv.submit(p) for p in bystanders]
            limit = time.monotonic() + 120
            while srv.healthz()["active_slots"] < len(bystanders) \
                    and time.monotonic() < limit:
                time.sleep(0.001)
            expect(srv.healthz()["active_slots"] == len(bystanders),
                   f"stall [{workers}]: bystanders not all seated")
            calm_end = srv.stats["decode_steps"] + STALL_CALM
            while srv.stats["decode_steps"] < calm_end \
                    and time.monotonic() < limit:
                time.sleep(0.0002)
            t_sub = time.perf_counter() * 1e6
            before = srv.stats["tokens_out"]         # all bystanders'
            long_reqs = [srv.submit(p) for p in longs]
            outs = [r.result(timeout=600) for r in reqs]
            t_last = time.perf_counter()
            dt = t_last - t0
            long_outs = [r.result(timeout=600) for r in long_reqs]
        finally:
            profiler.stop()
            expect(srv.drain(60), f"{name} did not drain")
        profiler.dump()
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    profiler.set_config()
    st = srv.stats
    expect(st["completed"] == len(bystanders) + len(longs)
           and st["failed"] == 0 and st["preempted"] == 0,
           f"stall [{workers}]: stats {st}")
    expect(all(len(o) == MAX_NEW for o in outs + long_outs),
           f"stall [{workers}]: a wrong token count")
    if workers:
        expect_disaggregated(srv, f"stall [{workers}]")
    spans = [e for e in events if e.get("ph") == "X"]
    starts = sorted(e["ts"] for e in spans if e["name"] == f"{name}.decode")
    last = "handoff" if workers else "prefill"
    ends = [e["ts"] + e["dur"] for e in spans
            if e["name"] == f"{name}.{last}" and e["ts"] >= t_sub]
    prefills = [e["dur"] / 1e3 for e in spans
                if e["name"] == f"{name}.prefill" and e["ts"] >= t_sub]
    expect(ends and prefills, f"stall [{workers}]: no long prefill seen")
    t_end = max(ends)
    gaps = [(b - a) / 1e3 for a, b in zip(starts, starts[1:])
            if b >= t_sub and a <= t_end]
    calm = [(b - a) / 1e3 for a, b in zip(starts, starts[1:])
            if b < t_sub][-STALL_CALM:]
    expect(gaps and len(calm) == STALL_CALM,
           f"stall [{workers}]: {len(gaps)} decode steps in the window, "
           f"{len(calm)} before it")
    n_tok = sum(map(len, outs))
    return {"gaps": gaps, "calm": calm, "window_ms": (t_end - t_sub) / 1e3,
            "prefill_ms": prefills, "bystander_tps": n_tok / dt,
            "bystander_tps_after": (n_tok - before)
            / (t_last - t_sub / 1e6), "outs": outs, "long_outs": long_outs}


def long_prompt_stall(torch, params, cfg, root):
    """The stall a long prompt puts on in-flight decodes, fused
    (``prefill_workers=0``) against disaggregated (1 worker): the same
    model and slots, length buckets STALL_LENGTHS, batch buckets (1, 2,
    4), STALL_BYSTANDERS bystanders decoding when STALL_LONG prompts of
    1900-2040 tokens arrive.  Logs the decode-step gaps (p50, p99, max)
    while the long prompts are in flight and the bystanders' tokens/s;
    every output is held teacher-forced.  A measurement, not a claim."""
    bystanders, longs = stall_prompts()
    res = {}
    for workers in (0, 1):
        r = res[workers] = stall_run(torch, params, cfg, workers, bystanders,
                                     longs, root)
        g, c = np.asarray(r["gaps"]), np.asarray(r["calm"])
        log(f"stall [{'fused' if not workers else '1 worker'}]: "
            f"{len(bystanders)} bystanders decoding, {len(longs)} prompts of "
            f"{min(map(len, longs))}-{max(map(len, longs))} tokens in "
            f"flight for {r['window_ms']:.3f} ms: {len(g)} decode-step gaps "
            f"p50 {np.percentile(g, 50):.3f} / p99 "
            f"{np.percentile(g, 99):.3f} / max {g.max():.3f} ms (the "
            f"{STALL_CALM} before: p50 {np.percentile(c, 50):.3f}, max "
            f"{c.max():.3f} ms); long prefill steps "
            f"{', '.join(f'{x:.3f}' for x in r['prefill_ms'])} ms; "
            f"bystanders {r['bystander_tps']:.1f} tokens/s, "
            f"{r['bystander_tps_after']:.1f} after the long prompts' submit")
        teacher_forced(torch, params, cfg, longs, r["long_outs"],
                       f"stall [{workers}] long prompts", n=len(longs))
        teacher_forced(torch, params, cfg, bystanders, r["outs"],
                       f"stall [{workers}] bystanders", n=8)
    same = sum(np.array_equal(a, b) for a, b in
               zip(res[0]["outs"] + res[0]["long_outs"],
                   res[1]["outs"] + res[1]["long_outs"]))
    log(f"stall: {same} of {len(bystanders) + len(longs)} outputs equal "
        f"between fused and disaggregated")
    return res


def handoff_fault(torch, params, cfg, plain):
    """``fleet.handoff`` armed with a seated bystander (one worker): the
    doomed request fails explicitly, the bystander completes with its
    full token count, and a fresh request is served after."""
    from mxnet_tpu_torch import fault

    prompts = plain["prompts"]
    srv = feature_server(torch, params, cfg, "ChipSmokeHandoffFault",
                         prefill_workers=1)
    try:
        bystander = srv.submit(prompts[0])
        limit = time.monotonic() + 60
        while srv.stats["handoffs"] < 1 and time.monotonic() < limit:
            time.sleep(0.001)
        expect(srv.stats["handoffs"] == 1, "handoff fault: bystander not "
               "seated")
        with fault.inject("fleet.handoff", RuntimeError("wire lost")) as h:
            err = srv.submit(prompts[1]).exception(timeout=600)
        expect(isinstance(err, RuntimeError) and "wire lost" in str(err)
               and h.fired >= 1, f"handoff fault: the doomed request got "
               f"{err!r}")
        out = bystander.result(timeout=600)
        fresh = srv.submit(prompts[2]).result(timeout=600)
        expect(len(out) == MAX_NEW and len(fresh) == MAX_NEW,
               "handoff fault: a wrong token count")
        expect_graphs(srv, None, "handoff fault")
    finally:
        expect(srv.drain(60), "handoff fault: server did not drain")
    expect(srv.alloc.free_count() == srv.alloc.allocatable,
           "handoff fault: pages left after drain")
    same = [np.array_equal(a, b) for a, b in
            zip((out, fresh), (plain["outs"][0], plain["outs"][2]))]
    if not all(same):
        teacher_forced(torch, params, cfg, [prompts[0], prompts[2]],
                       [out, fresh], "handoff fault")
    log(f"handoff fault: fleet.handoff failed its group explicitly "
        f"({type(err).__name__}: {err}); the seated bystander completed "
        f"with {len(out)} tokens, a fresh request after with {len(fresh)} "
        f"(equal to the fused server's: {same}); stats failed "
        f"{srv.stats['failed']}, completed {srv.stats['completed']}")


# ---------------------------------------------------------------- training --
def path_shapes():
    """The fused convs of ResNet-50 v1: per stage, the 3x3 C/4 -> C/4
    (f2) and the closing 1x1 C/4 -> C (f3) of each bottleneck, stride 1.
    Yields ``(label, blocks, hw, ci, co, k)``."""
    for i, (blocks, hw, c4, c) in enumerate(RESNET50_STAGES, 1):
        yield f"s{i} 3x3 {c4}->{c4} @{hw}", blocks, hw, c4, c4, 3
        yield f"s{i} 1x1 {c4}->{c} @{hw}", blocks, hw, c4, c, 1


def fused_inputs(torch, gen, n, h, ci, co, k, dtype, res=False, stride=1):
    """x, scale, shift, w (He-scaled), residual or None, dO on the card."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)
    x = randn(n, h, h, ci).to(dtype)
    scale = torch.rand(ci, generator=gen, device=DEVICE) + 0.5
    shift = 0.1 * randn(ci)
    w = (randn(k, k, ci, co) * (2.0 / (k * k * ci)) ** 0.5).to(dtype)
    r = randn(n, h, h, ci).to(dtype) if res else None
    ho = -(-h // stride)
    return x, scale, shift, w, r, randn(n, ho, ho, co).to(dtype)


def fused_bodies(fc, plain, x, sc, sh, w, r, do, k, relu, stride):
    """{kernel: [outputs]} of the three kernels, or of their plain
    versions."""
    fwd, dx, dw = fc._BODIES[plain]
    return {"fwd": [fwd(x, sc, sh, w, r, relu, stride)],
            "dx": list(dx(x, sc, sh, w, r, do, relu, stride)),
            "dw": [dw(x, sc, sh, r, do, k, relu, stride)]}


def check_outputs(torch, what, kern, got, want):
    """Hold a kernel's outputs against its plain version's: same shapes
    and types, finite, each element within F32_RTOL / BF16_RTOL of the
    output's largest magnitude plus its own.  Returns the max abs err."""
    worst = 0.0
    for a, b in zip(got, want):
        if b is None:
            expect(a is None, f"{what}: {kern} gave a dres")
            continue
        expect(a.shape == b.shape and a.dtype == b.dtype,
               f"{what}: {kern} output {tuple(a.shape)} {a.dtype} vs "
               f"{tuple(b.shape)} {b.dtype}")
        rtol = BF16_RTOL if b.dtype == torch.bfloat16 else F32_RTOL
        af, bf = a.float(), b.float()
        err = (af - bf).abs()
        ok = bool((err <= rtol * (bf.abs().max() + bf.abs())).all())
        expect(bool(torch.isfinite(af).all()) and ok,
               f"{what}: {kern} kernel disagrees with its plain version "
               f"(max abs err {float(err.max()):.3e})")
        worst = max(worst, float(err.max()))
    return worst


def fused_vs_plain(torch):
    """Every fused-conv kernel against its plain version: the eight
    ResNet-50 shapes at N = 8, then stride 2 at H = 8 and 9, the
    residual without relu, Co = 192, Ci = 40 < 64 with Co = 24, Ci = 128
    and 256 with Co = 64; f32 and bf16.  Each dX is launched twice and its
    outputs must repeat their bits: among the bf16 cases, the tensor-core
    dX's last step lands on B slot 0, which its epilogue reuses (steps =
    1 mod its B stages), at one, two and four panels."""
    from mxnet_tpu_torch.context import resolve_device
    from mxnet_tpu_torch.ops import fused_conv as fc

    resolve_device(DEVICE)          # f32 convs of the plain versions: no TF32
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    cases = [(label, KERNEL_CHECK_BATCH, hw, ci, co, k, 1, False, True)
             for label, _, hw, ci, co, k in path_shapes()]
    cases += [("3x3 stride 2 @8", 2, 8, 8, 16, 3, 2, False, True),
              ("3x3 stride 2 @9", 2, 9, 8, 16, 3, 2, False, True),
              ("1x1 stride 2 @9", 2, 9, 8, 16, 1, 2, False, True),
              ("3x3 residual, no relu @8", 2, 8, 8, 16, 3, 1, True, False),
              ("1x1 residual @7", 2, 7, 24, 40, 1, 1, True, True),
              ("3x3 Co=192 @4", 2, 4, 8, 192, 3, 1, False, True),
              ("3x3 Ci=40 -> Co=24 @7", 2, 7, 40, 24, 3, 1, False, True),
              ("3x3 Ci=128 -> Co=64 @7", 2, 7, 128, 64, 3, 1, False, True),
              ("3x3 Ci=256 -> Co=64 @5", 2, 5, 256, 64, 3, 1, False, True)]
    before = dict(fc.norm_relu_conv.launches)
    for dtype in (torch.float32, torch.bfloat16):
        for label, n, h, ci, co, k, stride, res, relu in cases:
            x, sc, sh, w, r, do = fused_inputs(torch, gen, n, h, ci, co, k,
                                               dtype, res, stride)
            got = fused_bodies(fc, False, x, sc, sh, w, r, do, k, relu,
                               stride)
            want = fused_bodies(fc, True, x, sc, sh, w, r, do, k, relu,
                                stride)
            again = fused_bodies(fc, False, x, sc, sh, w, r, do, k, relu,
                                 stride)["dx"]
            torch.cuda.synchronize()
            what = f"{label}, N={n}, {str(dtype).split('.')[1]}"
            err = max(check_outputs(torch, what, kern, got[kern], want[kern])
                      for kern in FUSED)
            expect(all(a is None or torch.equal(a, b)
                       for a, b in zip(got["dx"], again)),
                   f"{what}: two launches of the dX kernel differ")
            log(f"fused conv vs plain [{what}]: max abs err {err:.3e}")
    fc.norm_relu_conv.launches = before       # comparisons are not the path
    log(f"fused conv kernels agree with their plain versions (rtol f32 "
        f"{F32_RTOL}, bf16 {BF16_RTOL} of each output's scale)")


def build_resnet50(torch, fused, dtype=None, device=DEVICE):
    """resnet50_v1(layout="NHWC") on ``device``, seeded, its deferred
    shapes sized by a batch-1 forward."""
    from mxnet_tpu_torch import autograd, initializer
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    initializer.seed(0)
    net = resnet50_v1(layout="NHWC", fused=fused)
    net.initialize(ctx=device)
    if dtype is not None:
        net.cast(dtype)
    x = torch.zeros((1, 224, 224, 3), device=device,
                    dtype=getattr(torch, dtype or "float32"))
    with autograd.pause():
        net(x)
    return net


def fused_pairs(fused, plain):
    """How the fused ResNet-50's parameters sit in the unfused one:
    ``[(fused param, unfused param, permutation to the fused layout)]``
    (the NHWC Conv2D weight is OHWI, NormReluConv2D's HWIO)."""
    pairs = []

    def bn(f, u):
        for name in ("gamma", "beta", "running_mean", "running_var"):
            pairs.append((getattr(f, name), getattr(u, name), None))

    for st in range(4, 8):
        for fb, pb in zip(fused.features[st], plain.features[st]):
            body = pb.body
            pairs.append((fb.conv1.weight, body[0].weight, None))
            bn(fb.f2, body[1])
            pairs.append((fb.f2.weight, body[3].weight, (1, 2, 3, 0)))
            bn(fb.f3, body[4])
            pairs.append((fb.f3.weight, body[6].weight, (1, 2, 3, 0)))
            bn(fb.bn3, body[7])
            if pb.downsample is not None:
                pairs.append((fb.downsample[0].weight,
                              pb.downsample[0].weight, None))
                bn(fb.downsample[1], pb.downsample[1])
    pairs.append((fused.features[0].weight, plain.features[0].weight, None))
    bn(fused.features[1], plain.features[1])
    pairs += [(fused.output.weight, plain.output.weight, None),
              (fused.output.bias, plain.output.bias, None)]
    expect(len(pairs) == len(fused.collect_params()),
           "fused_pairs: a fused parameter has no unfused counterpart")
    return pairs


def forward_backward(torch, net, x, y):
    """One training forward and backward: the loss, then per parameter in
    ``collect_params`` order its gradient (trainable) or its value after
    the step (running statistics), all on the host in f64."""
    from mxnet_tpu_torch import autograd, gluon

    params = list(net.collect_params().values())
    train = [p for p in params if p.grad_req != "null"]
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y).mean()
    grads = dict(zip(map(id, train), torch.autograd.grad(
        loss, [p.tensor() for p in train])))
    leaves = [loss.detach()] + [grads.get(id(p), p.tensor().detach())
                                for p in params]
    return [t.double().cpu() for t in leaves]


@contextlib.contextmanager
def plain_versions(module):
    """Inside the block, CUDA tensors run ``module``'s plain versions
    (its ``_BODIES``) instead of its kernels."""
    cuda_bodies = module._BODIES[False]
    module._BODIES[False] = module._BODIES[True]
    try:
        yield
    finally:
        module._BODIES[False] = cuda_bodies


def model_check(torch):
    """Full-width fused ResNet-50 in f32: one training forward and
    backward through the kernels, held leaf by leaf against the same
    through their plain versions on the card, from the same parameters
    and batch — the loss, every gradient, every running statistic.

    The gradients of this randomly initialised net carry f32 rounding
    noise of a few percent (relative L2) whatever computes them, so each
    leaf's limit comes from a noise floor: the plain versions on the
    card against the same net on the host CPU (plain versions again,
    other conv libraries and summation orders).  A leaf's relative L2
    error, kernels against plain, may be at most MODEL_FLOOR_FACTOR
    times the larger of its own floor, the median floor of its kind and
    MODEL_MIN_FLOOR.  The max-abs error over the leaf's largest
    magnitude is printed beside it."""
    from mxnet_tpu_torch.ops import fused_conv as fc

    fused = build_resnet50(torch, fused=True)
    host = build_resnet50(torch, fused=True, device="cpu")
    params = list(fused.collect_params().items())
    for (_, p), q in zip(params, host.collect_params().values()):
        q.set_data(p.tensor().detach().cpu())
    start = {n: p.tensor().detach().clone() for n, p in params
             if p.grad_req == "null"}
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(CHECK_BATCH, 224, 224, 3)
                         .astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 1000, CHECK_BATCH))
    xd, yd = x.to(DEVICE), y.to(DEVICE)
    before = dict(fc.norm_relu_conv.launches)
    kernel = forward_backward(torch, fused, xd, yd)
    launched = {k: fc.norm_relu_conv.launches[k] - before[k] for k in FUSED}
    expect(launched == dict.fromkeys(FUSED, FUSED_PER_STEP),
           f"model check: kernel launches {launched}, expected "
           f"{FUSED_PER_STEP} each")
    for n, p in params:                 # the kernel run updated them
        if p.grad_req == "null":
            p.set_data(start[n])
    with plain_versions(fc):
        plain = forward_backward(torch, fused, xd, yd)
    on_host = forward_backward(torch, host, x, y)
    launched = {k: fc.norm_relu_conv.launches[k] - before[k] for k in FUSED}
    fc.norm_relu_conv.launches = before
    expect(launched == dict.fromkeys(FUSED, FUSED_PER_STEP),
           f"model check: the plain routes launched kernels ({launched})")

    kinds = [("loss", "loss")] + [
        (n, "gradient" if p.grad_req != "null" else "running statistic")
        for n, p in params]
    log(f"model check: loss kernel {float(kernel[0]):.7f}, plain "
        f"{float(plain[0]):.7f}, host {float(on_host[0]):.7f}")
    return hold_leaves(torch, kinds, kernel, plain, on_host,
                       f"resnet50_v1 f32, batch {CHECK_BATCH}")


def hold_leaves(torch, kinds, kernel, plain, on_host, what, floors=None):
    """Hold the kernel route's leaves against the plain route's, leaf by
    leaf: ``kinds`` lists ``(name, kind)`` per leaf.  A leaf's relative
    L2 error may be at most MODEL_FLOOR_FACTOR times the larger of its
    own noise floor (plain on the card against the host), the median
    floor of its kind and MODEL_MIN_FLOOR; the max abs error over the
    leaf's largest magnitude is printed beside it.  With ``floors``
    (``{kind: floor}``, an earlier check's medians) in place of
    ``on_host`` (None), a leaf's floor is its kind's there.  Returns
    the median floor of each kind."""
    def errs(a, b):
        """relative L2 error of a against b, and max abs error over b's
        largest magnitude"""
        d = a - b
        return (float(d.norm() / b.norm().clamp_min(1e-300)),
                float(d.abs().max() / b.abs().max().clamp_min(1e-300)))

    rows = {}
    for i, ((n, kind), k, pl) in enumerate(zip(kinds, kernel, plain)):
        expect(bool(torch.isfinite(k).all()),
               f"model check: the kernel route's {n} is not finite")
        floor = errs(pl, on_host[i]) if floors is None \
            else (floors[kind], float("nan"))
        rows.setdefault(kind, []).append((n,) + errs(k, pl) + floor)
    bad, medians = [], {}
    source = "plain vs host" if floors is None else "of the model check"
    for kind, rs in rows.items():
        floor = medians[kind] = float(np.median([r[3] for r in rs]))
        ratio = [(r[1] / max(r[3], floor, MODEL_MIN_FLOOR), r[0]) for r in rs]
        worst = max(rs, key=lambda r: r[1])
        worst_max = max(rs, key=lambda r: r[2])
        log(f"model check [{kind}: {len(rs)}, {what}]: relative L2 error "
            f"kernel vs plain median "
            f"{np.median([r[1] for r in rs]):.3e}, worst {worst[1]:.3e} "
            f"({worst[0]}); floor {source} median {floor:.3e}, worst "
            f"{max(r[3] for r in rs):.3e}; worst error/floor "
            f"{max(ratio)[0]:.3f} ({max(ratio)[1]}); max abs error over "
            f"scale, kernel vs plain worst {worst_max[2]:.3e} "
            f"({worst_max[0]})" + ("" if floors else
                                   f", plain vs host worst "
                                   f"{max(r[4] for r in rs):.3e}"))
        bad += [f"{name} {r:.2f}" for r, name in ratio
                if r > MODEL_FLOOR_FACTOR]
    expect(not bad, f"model check: kernel route beyond {MODEL_FLOOR_FACTOR}x "
           f"the noise floor: {bad[:8]}")
    return medians


def training_nets(torch):
    """The fused and the unfused resnet50_v1 with the same parameters
    (the fused net's, seeded, mapped into the unfused layout), both cast
    to bf16 as ``bench_resnet`` casts them."""
    fused = build_resnet50(torch, fused=True)
    plain = build_resnet50(torch, fused=False)
    for f, u, perm in fused_pairs(fused, plain):
        u.set_data(f.tensor() if perm is None
                   else f.tensor().permute(3, 0, 1, 2))
    return fused.cast("bfloat16"), plain.cast("bfloat16")


def train_run(torch, net, fused, steps, capture=None):
    """bench_resnet's loop on the card: batch 256 of RandomState(0)
    inputs, bf16, SGD 0.1/0.9/1e-4, WARMUP_STEPS then ``steps`` timed
    steps on the same batch, through the captured step (the default;
    its first call runs eagerly, then captures) or the eager one
    (``capture=False``).  The step owns copies of the net's parameters,
    so every run starts from the same ones.  Returns the numbers and the
    step."""
    from mxnet_tpu_torch import gluon, optimizer, parallel
    from mxnet_tpu_torch.ops.fused_conv import norm_relu_conv

    opt = optimizer.create("sgd", learning_rate=0.1, momentum=0.9, wd=1e-4)
    step = parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              opt, capture=capture)
    rng = np.random.RandomState(0)
    xh = rng.randn(TRAIN_BATCH, 224, 224, 3).astype(np.float32)
    yh = rng.randint(0, 1000, (TRAIN_BATCH,)).astype(np.int32)
    x = torch.from_numpy(xh).to(DEVICE).to(torch.bfloat16)
    y = torch.from_numpy(yh).to(DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    norm_relu_conv.launches = dict.fromkeys(FUSED, 0)  # main path starts
    losses = [float(step(x, y)) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step(x, y) for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(norm_relu_conv.launches)           # ... and ends here
    losses += [float(v) for v in timed]
    peak = torch.cuda.max_memory_allocated()
    name = ("fused" if fused else "unfused") \
        + (", eager" if capture is False else ", captured")
    expect(step.graph_count() == (0 if capture is False else 1),
           f"{name}: {step.graph_count()} graphs")
    expect(all(np.isfinite(losses)), f"{name}: loss not finite {losses}")
    # the loss falls over the run; with momentum 0.9 at lr 0.1 on one
    # repeated batch it overshoots and rises again within a few steps,
    # so a fall across the timed steps alone is not guaranteed
    expect(losses[-1] < losses[0] and min(losses) < losses[0],
           f"{name}: loss did not fall over the run {losses}")
    expect(all(bool(torch.isfinite(t).all()) for t in step._train),
           f"{name}: a parameter is not finite")
    want = FUSED_PER_STEP * (WARMUP_STEPS + steps) if fused else 0
    expect(launches == dict.fromkeys(FUSED, want),
           f"{name}: kernel launches {launches}, expected {want} each")
    img_s = TRAIN_BATCH * steps / dt
    log(f"train [{name} resnet50_v1, bf16, batch {TRAIN_BATCH}]: losses "
        f"{[round(v, 4) for v in losses]}; {steps} timed steps in "
        f"{dt:.3f} s = {1e3 * dt / steps:.1f} ms/step = {img_s:.1f} img/s; "
        f"peak device memory {peak / 2**30:.2f} GiB; kernel launches "
        f"{launches}")
    return {"img_s": img_s, "ms_step": 1e3 * dt / steps, "losses": losses,
            "launches": launches, "peak": peak}, step, (x, y)


def bit_check(torch, net, batch, steps=3):
    """The captured ResNet step against the eager one from the same
    parameters: ``steps`` losses and every parameter, running statistic
    and optimizer state the same bits.  cuDNN may pick algorithms that
    sum in another order from run to run (the library convs outside the
    fused layers), so both runs use its deterministic ones here."""
    from mxnet_tpu_torch import gluon, optimizer, parallel

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for capture in (None, False):
            step = parallel.TrainStep(
                net, gluon.loss.SoftmaxCrossEntropyLoss(),
                optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                 wd=1e-4), capture=capture)
            losses = [float(step(*batch)) for _ in range(steps)]
            runs.append((losses, [t.detach().clone() for t in
                                  step._train + step._aux]
                         + [s for st in step._states for s in st]))
            del step
    finally:
        torch.backends.cudnn.deterministic = prev
    (lc, tc), (le, te) = runs
    same = all(torch.equal(a, b) for a, b in zip(tc, te))
    log(f"train [fused resnet50_v1, bf16, cuDNN deterministic]: captured "
        f"losses {lc}, eager {le}; {len(tc)} parameter and state tensors "
        f"{'the same bits' if same else 'DIFFER'}")
    expect(lc == le and same, "the captured ResNet step differs from the "
           "eager one")


def track_losses(kernels, yardstick, what):
    """The kernel route's first loss equals the yardstick's from the same
    parameters and batch within 2% (the loss is a bf16 value, ~0.4%
    apart at 9, bf16 activations round at other places on the two
    routes, and BERT's dropout masks come from other generators); the
    later steps are printed, not held: the updates grow any difference
    from step to step."""
    gaps = [abs(a - b) / max(abs(b), 1e-6)
            for a, b in zip(kernels, yardstick)]
    log(f"train: {what} losses from the same parameters: relative gap "
        f"per step {[round(g, 4) for g in gaps]}")
    expect(gaps[0] <= 0.02, f"{what}: the first losses differ by more "
           f"than 2%")


def conv_bound(n, hw, ci, co, k, kernel):
    """Least time (ms) of one call at this shape in bf16: the larger of
    its flops (2 per multiply-add) at the bf16 dense peak and its bytes
    (each tensor read or written once: activations and weights bf16, dW
    f32, the per-channel vectors left out) at the HBM rate.  Returns
    ``(ops_ms, bytes_ms)``."""
    flops = 2.0 * n * hw * hw * co * k * k * ci
    act_in, act_out = 2 * n * hw * hw * ci, 2 * n * hw * hw * co
    weight = 2 * k * k * ci * co
    nbytes = {"fwd": act_in + weight + act_out,
              "dx": act_in + weight + act_out + act_in,
              "dw": act_in + act_out + 2 * weight}[kernel]
    return flops / BF16_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


def tc_smem_bytes(dtype_bytes, wg, np_, dw, res):
    """Dynamic shared memory of one tensor-core fused-conv block, as
    ``Tile::smem_bytes`` in fused_conv.cu computes it (4 stages, or 3
    where 4 do not fit in 232448 bytes)."""
    rows = 64 if dw else 64 * wg
    panels = np_ * wg if dw else np_
    pieces_x, pieces_b = (3, 3) if dtype_bytes == 4 else (2, 1)
    b = pieces_b * panels * 8192
    raw = rows * 64 * dtype_bytes * (2 if res else 1)
    for stages in (4, 3):
        total = (1024 + stages * (b + raw) + 2 * pieces_x * rows * 128
                 + stages * rows + 40)
        if total <= 232448 or stages == 3:
            return stages, total


FUSED_KERNELS = re.compile(r"tc_kernelI(13__nv_bfloat16|f)Li(\d)ELi(\d)ELb(\d)E"
                           r"|fwd_halo_kernelILi(\d)E|dw_halo_kernelE"
                           r"|dx_tc_kernelILi(\d)E")
FLASH_TC_KERNELS = re.compile(r"(fwd|dq|dkv)_tc_kernelILi(\d+)E")


def fused_kernel_info(mangled):
    """What ptxas_report prints for a fused-conv tensor-core kernel:
    ``(name, dynamic shared memory bytes, what it holds)``, or None for
    the other kernels of fused_conv.cu."""
    name = FUSED_KERNELS.search(mangled)
    if name is None:
        return None
    if name.group(6):
        np_ = int(name.group(6))
        stages = 2 if np_ == 2 else 4
        return (f"dx_tc_kernel<{np_} panels>",
                1024 + stages * np_ * 8192 + 65536 + 128 + 8 * (stages + 4),
                f"{stages} B stages, 64 KB of dO halo slots")
    if name.group(0) == "dw_halo_kernelE":
        return ("dw_halo_kernel", 1024 + 4 * 8192 + 6 * 256 * 128 + 128 + 48,
                "4 dO stages, 2 raw halos, 2 X halos of hi and lo")
    if name.group(5):
        np_ = int(name.group(5))
        stages = 2 if np_ == 4 else 4
        return (f"fwd_halo_kernel<{np_} panels>",
                1024 + stages * np_ * 8192 + 4 * 256 * 128 + 128
                + 8 * (stages + 2),
                f"{stages} B stages, 2 raw halos, X halo of hi and lo")
    bf16 = name.group(1) != "f"
    wg, np_, dw = (int(name.group(i)) for i in (2, 3, 4))
    st = [tc_smem_bytes(2 if bf16 else 4, wg, np_, dw, res)
          for res in (False, True)]
    return (f"tc_kernel<{'bf16' if bf16 else 'f32'}, {wg} warpgroups, "
            f"{np_} panels, {'dW' if dw else 'fwd'}>", st[0][1],
            f"{st[0][0]} stages; {st[1][1]} in {st[1][0]} with a residual")


def flash_kernel_info(mangled):
    """The same for the flash tensor-core kernels (``TcTiles<D, kOwn>``
    in flash_attention.cu: the forward's own slots hold Q alone)."""
    name = FLASH_TC_KERNELS.search(mangled)
    if name is None:
        return None
    d = int(name.group(2))
    own = 1 if name.group(1) == "fwd" else 2
    return (f"{name.group(1)}_tc_kernel<D={d}>",
            1024 + (2 * own + 4) * 64 * d * 2 + 64 + 2 * 2 * 64 * 4,
            f"two slots of its own {'Q tile' if own == 1 else 'pair'} of "
            f"64 x D, two stages of the streamed pair, 4 mbarriers, two "
            f"stages of lse and delta")


def ptxas_report(source, describe):
    """``nvcc -Xptxas -v`` of one kernel source: registers and spills of
    each kernel that ``describe`` (mangled name -> ``(name, dynamic shared
    memory bytes, what it holds)`` or None) names, beside its shared
    memory, and ptxas's wgmma serialisation warnings (C7515).  Returns
    the names of the kernels whose wgmmas ptxas serialised."""
    from mxnet_tpu_torch.ops import cuda as kcuda

    kcuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = kcuda.BUILD_DIR / f"ptxas-{os.getpid()}.so"
    r = subprocess.run([kcuda.nvcc_path(), *kcuda.NVCC_FLAGS, "-Xptxas",
                        "-v", "-o", str(out), str(kcuda.SRC_DIR / source)],
                       capture_output=True, text=True, timeout=600)
    out.unlink(missing_ok=True)
    expect(r.returncode == 0, f"nvcc -Xptxas -v failed:\n{r.stderr}")
    mangled = re.compile(r"(_Z\w+)")
    lines = (r.stdout + r.stderr).splitlines()
    serial = set()
    for line in lines:
        m = mangled.search(line)
        if "C7515" in line and m and describe(m.group(1)):
            serial.add(describe(m.group(1))[0])
    info = None
    for line in lines:
        m = mangled.search(line)
        if "Compiling entry function" in line:
            info = describe(m.group(1)) if m else None
        elif info is not None and "spill" in line:
            spills = line.strip()
        elif info is not None and "Used" in line:
            what, smem, holds = info
            log(f"ptxas [{what}]: {line.split(':', 1)[1].strip()}; "
                f"{spills}; dynamic shared memory {smem} bytes ({holds})"
                + ("; wgmmas serialised (C7515)" if what in serial else ""))
            info = None
    return serial


def time_fused(torch):
    """Each fused-conv kernel at the eight ResNet-50 shapes at N = 256,
    bf16, as the training run calls it: its outputs held against its
    plain version's (``check_outputs``; dX launched twice, every output,
    dscale and dshift among them, the same bits), then timed beside the plain
    version, cuDNN on the already normalised input (``library``: the
    conv alone, without the prologue, the mask or the dscale/dshift
    epilogue — less work than the kernel), and the bound.  Per-step sums
    weight each shape by its blocks (32 launches); ``max_abs_err`` is
    the worst over the eight shapes."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import fused_conv as fc

    ptxas_report("fused_conv.cu", fused_kernel_info)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    flush = torch.empty(1024 * 2**20, dtype=torch.uint8, device=DEVICE)
    before = dict(fc.norm_relu_conv.launches)
    sums = {k: dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                              "operations", "bytes", "max_abs_err",
                              "flops"), 0.0)
            for k in FUSED}
    for label, blocks, hw, ci, co, k in path_shapes():
        x, sc, sh, w, _, do = fused_inputs(torch, gen, TRAIN_BATCH, hw, ci,
                                           co, k, torch.bfloat16)
        xn = torch.relu(x.float() * sc + sh).to(torch.bfloat16) \
            .permute(0, 3, 1, 2)
        w4 = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        do4 = do.permute(0, 3, 1, 2)
        pad = k // 2
        f64 = torch.float64
        calls = {
            "fwd": (lambda: fc._fwd_cuda(x, sc, sh, w, None, True, 1),
                    lambda acc=torch.float32: fc._fwd_plain(
                        x, sc, sh, w, None, True, 1, acc),
                    lambda: F.conv2d(xn, w4, padding=pad)),
            "dx": (lambda: fc._dx_cuda(x, sc, sh, w, None, do, True, 1),
                   lambda acc=torch.float32: fc._dx_plain(
                       x, sc, sh, w, None, do, True, 1, acc),
                   lambda: torch.nn.grad.conv2d_input(xn.shape, w4, do4,
                                                      padding=pad)),
            "dw": (lambda: fc._dw_cuda(x, sc, sh, None, do, k, True, 1),
                   lambda acc=torch.float32: fc._dw_plain(
                       x, sc, sh, None, do, k, True, 1, acc),
                   lambda: torch.nn.grad.conv2d_weight(xn, w4.shape, do4,
                                                       padding=pad))}
        parts = []
        for kern in FUSED:
            kfn, pfn, lfn = calls[kern]
            # against the plain version summed in f64 (its f64 outputs
            # rounded to f32): dW sums N*H*W = 802816 positions here, and
            # the plain version in f32 (cuDNN's f32 wgrad) strays further
            # from f64 at the 3x3 shapes than F32_RTOL allows; its own
            # distance from f64 is printed beside the kernel's
            got, want = (list(r) if isinstance(r, tuple) else [r]
                         for r in (kfn(), pfn(f64)))
            want = [t if t is None or t.dtype != f64 else t.float()
                    for t in want]
            err = check_outputs(torch, f"{label}, N={TRAIN_BATCH}, bf16",
                                kern, got, want)
            if kern == "dx":    # no atomics: dscale/dshift repeat their bits
                again = kfn()
                expect(all(torch.equal(a, b) for a, b in zip(got, again)
                           if a is not None),
                       f"{label}: two launches of the dX kernel differ")
                del again
            plain = pfn()
            plain = list(plain) if isinstance(plain, tuple) else [plain]
            plain_err = max(float((a.float() - b.float()).abs().max())
                            for a, b in zip(plain, want) if b is not None)
            del got, want, plain
            ms = time_ms(torch, kfn, 10, flush)
            plain_ms = time_ms(torch, pfn, 5, flush)
            lib_ms = time_ms(torch, lfn, 10, flush)
            ops_ms, bytes_ms = conv_bound(TRAIN_BATCH, hw, ci, co, k, kern)
            bound_ms = max(ops_ms, bytes_ms)
            bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
            t = sums[kern]
            t["max_abs_err"] = max(t["max_abs_err"], err)
            t["ms"] += blocks * ms
            t["plain_ms"] += blocks * plain_ms
            t["library_ms"] += blocks * lib_ms
            t["bound_ms"] += blocks * bound_ms
            t[bound_by] += blocks * bound_ms     # what sets the sum
            flops = 2.0 * TRAIN_BATCH * hw * hw * co * k * k * ci
            t["flops"] += blocks * flops
            parts.append(f"{kern} {ms:.3f} ms = {flops / ms / 1e9:.1f} "
                         f"TFLOP/s, max abs err vs plain "
                         f"in f64 {err:.3e} (plain in f32: {plain_err:.3e})"
                         f" (plain {plain_ms:.3f}, cuDNN "
                         f"conv alone {lib_ms:.3f}, bound {bound_ms:.4f} by "
                         f"{bound_by}, {100 * bound_ms / ms:.1f}% of bound)")
        log(f"time [{label}, N={TRAIN_BATCH}, bf16, x{blocks} per step]: "
            + "; ".join(parts))
    fc.norm_relu_conv.launches = before       # timing is not the path
    for kern in FUSED:
        t = sums[kern]
        t["bound_by"] = "operations" if t.pop("operations") >= t.pop("bytes") \
            else "bytes"
        log(f"time per step [fused_conv_{kern}, 32 launches, max abs err "
            f"vs plain in f64 {t['max_abs_err']:.3e}]: kernel "
            f"{t['ms']:.2f} ms = {t.pop('flops') / t['ms'] / 1e9:.1f} "
            f"TFLOP/s, plain {t['plain_ms']:.2f} ms, cuDNN conv "
            f"alone {t['library_ms']:.2f} ms, bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}), kernel at "
            f"{100 * t['bound_ms'] / t['ms']:.2f}% of bound")
    return sums


def profile_step(torch, step, batch, what):
    """One more training step under ``torch.profiler``: the device's
    busy share of the step's wall time and the top kernels."""
    prof, wall_us, _ = profiled(torch, lambda: step(*batch), what)
    return print_profile(prof, wall_us, what)


# -------------------------------------------------------------------- BERT --
def flash_args(torch, gen, bh, s, d, dtype):
    """q, k, v, dO of shape (bh, s, d) on the card."""
    return [torch.randn(bh, s, d, generator=gen, device=DEVICE).to(dtype)
            for _ in range(4)]


def flash_kernels(fa, q, k, v, do, args):
    """{kernel: [outputs]} of the three flash kernels on the card, and
    the ``(lse, delta)`` the backward kernels were given."""
    o, lse = fa._fwd_cuda(q, k, v, *args)
    delta = (o.float() * do.float()).sum(-1)
    return {"fwd": [o, lse],
            "dq": [fa._dq_cuda(q, k, v, do, lse, delta, *args)],
            "dkv": list(fa._dkv_cuda(q, k, v, do, lse, delta, *args))}, \
        (lse, delta)


def flash_plain(fa, q, k, v, do, lse, delta, args, acc):
    """The same through the plain versions summed in ``acc``, each
    output rounded to the kernel's type (lse to f32)."""
    o, plse = fa._fwd_plain(q, k, v, *args, acc=acc)
    return {"fwd": [o, plse.float()],
            "dq": [fa._dq_plain(q, k, v, do, lse, delta, *args, acc=acc)],
            "dkv": list(fa._dkv_plain(q, k, v, do, lse, delta, *args,
                                      acc=acc))}


def flash_exact(fa, q, k, v, do, lse, delta, args):
    """dQ, dK and dV of the plain versions on the inputs cast to f64:
    summed in f64 and not rounded to the inputs' type."""
    q, k, v, do = (x.double() for x in (q, k, v, do))
    return {"dq": [fa._dq_plain(q, k, v, do, lse, delta, *args)],
            "dkv": list(fa._dkv_plain(q, k, v, do, lse, delta, *args))}


def max_err(got, want):
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(got, want))


def flash_vs_plain(torch):
    """Every flash kernel (forward O and lse, dQ, dK/dV) against its plain
    version summed in f64 on the card: BERT-base's own shape (B*H 768,
    S 128, D 64, bf16) at dropout 0 and 0.1 with a fixed seed, causal,
    S = 512 (eight tiles), S = 200 (a tail) causal in bf16 and in f32,
    B*H = 37, D = 128, f32.  Within F32_RTOL of each output's scale for
    f32 outputs (lse among them) and BF16_RTOL for bf16 ones; a wrong
    dropout mask shows as an O(1) error in the rows it hits.  In every
    bf16 case each backward kernel's largest error from the f64 sums
    before their rounding to bf16 must be at most BWD_ERR_FACTOR times
    that of the plain version summed in f32 (its outputs rounded to bf16
    as the kernel's are), and a second launch of each backward kernel
    must give the same bits.  Returns the worst abs error per kernel at
    BERT-base's shape with dropout on."""
    fa = flash_module()
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("bert-base", BERT_BH, BERT_SEQ, BERT_HEAD_DIM, bf16, False, 0.0),
             ("bert-base, dropout", BERT_BH, BERT_SEQ, BERT_HEAD_DIM, bf16,
              False, BERT_DROPOUT),
             ("causal", 96, BERT_SEQ, BERT_HEAD_DIM, bf16, True, BERT_DROPOUT),
             ("S=512", 48, 512, BERT_HEAD_DIM, bf16, False, BERT_DROPOUT),
             ("S=200 tail, causal", 48, 200, BERT_HEAD_DIM, bf16, True,
              BERT_DROPOUT),
             ("S=200 tail, causal", 48, 200, BERT_HEAD_DIM, f32, True,
              BERT_DROPOUT),
             ("B*H=37", 37, BERT_SEQ, BERT_HEAD_DIM, bf16, False,
              BERT_DROPOUT),
             ("D=128", 48, 256, 128, bf16, False, BERT_DROPOUT),
             ("D=128, causal tail", 40, 200, 128, bf16, True, BERT_DROPOUT),
             ("f32", BERT_BH, BERT_SEQ, BERT_HEAD_DIM, f32, False,
              BERT_DROPOUT)]
    before = dict(fa.flash_attention.launches)
    path_err = {}
    seed = fa.seed_tensor(FLASH_SEED, torch.device(DEVICE))  # device memory
    for label, bh, s, d, dtype, causal, dropout in cases:
        q, k, v, do = flash_args(torch, gen, bh, s, d, dtype)
        args = (d ** -0.5, causal, dropout, seed)
        got, (lse, delta) = flash_kernels(fa, q, k, v, do, args)
        want = flash_plain(fa, q, k, v, do, lse, delta, args,
                           torch.float64)
        torch.cuda.synchronize()
        what = (f"{label}: B*H {bh}, S {s}, D {d}, "
                f"{str(dtype).split('.')[1]}, dropout {dropout}")
        errs = {kern: check_outputs(torch, what, kern, got[kern], want[kern])
                for kern in FLASH}
        if label == "bert-base, dropout":
            path_err = errs
        log(f"flash vs plain [{what}]: max abs err "
            + ", ".join(f"{kern} {e:.3e}" for kern, e in errs.items()))
        if dtype != bf16:
            continue
        exact = flash_exact(fa, q, k, v, do, lse, delta, args)
        plain = flash_plain(fa, q, k, v, do, lse, delta, args, f32)
        again = {"dq": [fa._dq_cuda(q, k, v, do, lse, delta, *args)],
                 "dkv": list(fa._dkv_cuda(q, k, v, do, lse, delta, *args))}
        torch.cuda.synchronize()
        parts = []
        for kern in ("dq", "dkv"):
            k_err = max_err(got[kern], exact[kern])
            p_err = max_err(plain[kern], exact[kern])
            parts.append(f"{kern} kernel {k_err:.3e}, plain in f32 "
                         f"{p_err:.3e} ({k_err / p_err:.2f}x)")
            expect(k_err <= BWD_ERR_FACTOR * p_err,
                   f"{what}: {kern} kernel strays {k_err:.3e} from the f64 "
                   f"sums, more than {BWD_ERR_FACTOR}x the plain version "
                   f"in f32 ({p_err:.3e})")
            expect(all(torch.equal(a, b)
                       for a, b in zip(got[kern], again[kern])),
                   f"{what}: two launches of the {kern} kernel differ")
        log(f"flash backward vs f64 before rounding [{what}]: "
            + "; ".join(parts) + "; a second launch gives the same bits")
    fa.flash_attention.launches = before      # comparisons are not the path
    log(f"flash kernels agree with their plain versions summed in f64 (rtol "
        f"f32 {F32_RTOL}, bf16 {BF16_RTOL} of each output's scale); bf16 "
        f"backward errors within {BWD_ERR_FACTOR}x the plain version's in "
        f"f32, bits repeatable")
    return path_err


def flash_module():
    import importlib

    return importlib.import_module("mxnet_tpu_torch.ops.flash_attention")


def build_bert(torch, impl, dropout, device=None):
    """BERT-base (bench_bert's width and depth) on ``device`` (None: the
    card), seeded."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel

    mxrandom.seed(0)
    net = BERTModel(vocab_size=BERT_VOCAB, units=BERT_UNITS,
                    hidden_size=BERT_HIDDEN, num_layers=BERT_LAYERS,
                    num_heads=BERT_HEADS, max_length=512, dropout=dropout,
                    attention_impl=impl)
    net.initialize(ctx=device or DEVICE)
    return net


def copy_params(src, dst):
    """``dst``'s parameters set to ``src``'s, by name without prefix."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import params_from_jax

    params_from_jax(dst, {k: p.tensor().detach().cpu().float().numpy()
                          for k, p in src.collect_params().items()})


def bert_batch(torch, batch, device=None):
    """bench_bert's batch (``bench.py:378-385``, RandomState(0)) as
    ``(data, labels)`` on ``device``.  ``valid_length`` is None: every row
    is full length (bench_bert passes ``valid_length = seq`` for each),
    so it is the same function, and the flash path takes no mask."""
    rng = np.random.RandomState(0)
    tok = rng.randint(0, BERT_VOCAB, (batch, BERT_SEQ)).astype(np.int32)
    tt = rng.randint(0, 2, (batch, BERT_SEQ)).astype(np.int32)
    mpos = rng.randint(0, BERT_SEQ, (batch, BERT_PRED)).astype(np.int32)
    mlab = rng.randint(0, BERT_VOCAB, (batch, BERT_PRED)).astype(np.int32)
    mw = np.ones((batch, BERT_PRED), np.float32)
    nsp = rng.randint(0, 2, (batch,)).astype(np.int32)

    def dev(x):
        return torch.from_numpy(x).to(device or DEVICE)
    return (dev(tok), dev(tt), None, dev(mpos)), \
        (dev(mlab), dev(mw), dev(nsp))


def bert_loss_fn():
    """bench_bert's loss: BERTPretrainLoss of the NSP and MLM scores."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTPretrainLoss

    blk = BERTPretrainLoss()

    def loss_fn(out, labels):
        return blk(out[3], out[2], *labels)
    return loss_fn


def bert_leaves(torch, net, data, labels):
    """One training forward and backward: the loss, the four outputs and
    every parameter's gradient, on the host in f64."""
    from mxnet_tpu_torch import autograd

    params = list(net.collect_params().values())
    with autograd.record():
        out = net(*data)
        loss = bert_loss_fn()(out, labels)
    grads = torch.autograd.grad(loss, [p.tensor() for p in params])
    return [t.detach().double().cpu() for t in (loss, *out, *grads)]


def bert_model_check(torch):
    """Full-width BERT-base in f32, batch BERT_CHECK_BATCH, seq 128,
    dropout 0, attention_impl="flash": one training forward and backward
    through the kernels, held leaf by leaf (loss, the four outputs, every
    gradient) against the same through their plain versions on the card,
    within MODEL_FLOOR_FACTOR of the noise floor the plain route on the
    card shows against the same net on the host CPU (``hold_leaves``)."""
    fa = flash_module()
    net = build_bert(torch, "flash", 0.0)
    host = build_bert(torch, "flash", 0.0, device="cpu")
    copy_params(net, host)
    data, labels = bert_batch(torch, BERT_CHECK_BATCH)
    hdata, hlabels = bert_batch(torch, BERT_CHECK_BATCH, device="cpu")
    before = dict(fa.flash_attention.launches)
    kernel = bert_leaves(torch, net, data, labels)
    launched = {k: fa.flash_attention.launches[k] - before[k] for k in FLASH}
    expect(launched == dict.fromkeys(FLASH, BERT_LAYERS),
           f"BERT model check: kernel launches {launched}, expected "
           f"{BERT_LAYERS} each")
    with plain_versions(fa):
        plain = bert_leaves(torch, net, data, labels)
    on_host = bert_leaves(torch, host, hdata, hlabels)
    launched = {k: fa.flash_attention.launches[k] - before[k] for k in FLASH}
    fa.flash_attention.launches = before
    expect(launched == dict.fromkeys(FLASH, BERT_LAYERS),
           f"BERT model check: the plain routes launched kernels "
           f"({launched})")
    names = list(net.collect_params().keys())
    kinds = ([("loss", "loss")]
             + [(n, "output") for n in ("sequence", "pooled", "nsp", "mlm")]
             + [(n, "gradient") for n in names])
    log(f"BERT model check: loss kernel {float(kernel[0]):.7f}, plain "
        f"{float(plain[0]):.7f}, host {float(on_host[0]):.7f}")
    hold_leaves(torch, kinds, kernel, plain, on_host,
                f"bert_12_768_12 f32 flash, batch {BERT_CHECK_BATCH}")


def bert_nets(torch):
    """The flash and the dense BERT-base from the same parameters (the
    flash net's, seeded), both cast to bf16 as ``bench_bert`` casts them
    (the step keeps f32 master weights)."""
    flash = build_bert(torch, "flash", BERT_DROPOUT)
    dense = build_bert(torch, "dense", BERT_DROPOUT)
    copy_params(flash, dense)
    return flash.cast("bfloat16"), dense.cast("bfloat16")


def bert_train_run(torch, net, impl, steps, capture=None):
    """bench_bert's loop on the card: batch BERT_BATCH x 128, 20 masked
    positions, bf16, LAMB (lr 1e-3, wd 0.01), BERT_WARMUP_STEPS then
    ``steps`` timed steps on the same batch, through the captured step
    (the default) or the eager one (``capture=False``); the framework's
    random stream restarts from the same seed first, so both draw the
    same dropout masks.  Returns the numbers and the step."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch import random as mxrandom

    fa = flash_module()
    opt = optimizer.create("lamb", learning_rate=1e-3, wd=0.01)
    mxrandom.seed(1)
    step = parallel.TrainStep(net, bert_loss_fn(), opt, capture=capture)
    data, labels = bert_batch(torch, BERT_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = dict.fromkeys(FLASH, 0)  # main path starts
    losses = [float(step(data, labels)) for _ in range(BERT_WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step(data, labels) for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(fa.flash_attention.launches)         # ... and ends here
    losses += [float(v) for v in timed]
    peak = torch.cuda.max_memory_allocated()
    expect(step.graph_count() == (0 if capture is False else 1),
           f"{impl}: {step.graph_count()} graphs")
    impl += ", eager" if capture is False else ", captured"
    expect(all(np.isfinite(losses)), f"{impl}: loss not finite {losses}")
    expect(losses[-1] < losses[0] and min(losses) < losses[0],
           f"{impl}: loss did not fall over the run {losses}")
    expect(all(bool(torch.isfinite(t).all()) for t in step._train),
           f"{impl}: a parameter is not finite")
    want = BERT_LAYERS * (BERT_WARMUP_STEPS + steps) \
        if impl.startswith("flash") else 0
    expect(launches == dict.fromkeys(FLASH, want),
           f"{impl}: flash kernel launches {launches}, expected {want} each")
    tok_s = BERT_BATCH * BERT_SEQ * steps / dt
    log(f"train [{impl} bert_12_768_12, bf16, batch {BERT_BATCH} x "
        f"{BERT_SEQ}]: losses {[round(v, 4) for v in losses]}; {steps} "
        f"timed steps in {dt:.3f} s = {1e3 * dt / steps:.1f} ms/step = "
        f"{tok_s:.1f} tokens/s; peak device memory {peak / 2**30:.2f} GiB; "
        f"kernel launches {launches}")
    return {"tok_s": tok_s, "ms_step": 1e3 * dt / steps, "losses": losses,
            "launches": launches, "peak": peak}, step, (data, labels)


def dropout_replays(torch, net, batch, calls=3):
    """Dropout under replay: a captured step at learning rate 0 (the
    parameters never change) from the same batch, its loss in f32 (the
    scores cast before the loss, so that the masks' effect is not lost
    to bf16 rounding).  Every call draws other masks — the flash
    kernels read a new seed from the device counter and the Dropout
    op's generator advances — so the ``calls`` losses must all differ;
    each replay must also count one launch of each flash kernel per
    layer."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTPretrainLoss

    fa = flash_module()
    blk = BERTPretrainLoss()
    step = parallel.TrainStep(
        net, lambda out, lab: blk(out[3].float(), out[2].float(), *lab),
        optimizer.create("lamb", learning_rate=0.0, wd=0.0))
    before = dict(fa.flash_attention.launches)
    losses = [float(step(*batch)) for _ in range(calls)]
    launched = {k: fa.flash_attention.launches[k] - before[k] for k in FLASH}
    fa.flash_attention.launches = before       # a check, not the path
    log(f"dropout under replay [flash bert_12_768_12, lr 0, f32 loss]: "
        f"losses {losses} (the first eager, then replays); launches "
        f"{launched}")
    expect(len(set(losses)) == calls, "replays repeated their dropout masks")
    expect(launched == dict.fromkeys(FLASH, BERT_LAYERS * calls),
           f"replays counted {launched} flash launches")


def flash_flops(bh, s, d, kernel):
    """The function's flops of one launch, 2 per multiply-add: fwd QK^T
    and PV, dQ S/dP/dQ, dK/dV S/dP/dV/dK (non-causal)."""
    return {"fwd": 2, "dq": 3, "dkv": 4}[kernel] * 2.0 * bh * s * s * d


def flash_bound(bh, s, d, kernel, elem=2):
    """Least time (ms) of one launch: the larger of its flops at the
    bf16 dense peak and its bytes (q, k, v, dO read once in ``elem``-byte
    elements, lse/delta f32, each output written once) at the HBM rate.
    Returns ``(ops_ms, bytes_ms)``."""
    mat, row = bh * s * d * elem, bh * s * 4
    nbytes = {"fwd": 3 * mat + mat + row,
              "dq": 4 * mat + 2 * row + mat,
              "dkv": 4 * mat + 2 * row + 2 * mat}[kernel]
    return (flash_flops(bh, s, d, kernel) / BF16_FLOP_PER_S * 1e3,
            nbytes / HBM_BYTES_PER_S * 1e3)


def time_flash(torch, path_err):
    """Each flash kernel at BERT-base's shape (B*H 768, S 128, D 64),
    bf16, dropout 0.1, as the training run calls it: timed (CUDA events,
    L2 flushed) beside its bound, its plain version and the library call
    for the same function — ``scaled_dot_product_attention``'s forward
    for the forward kernel, and that call's backward (dQ, dK and dV in
    one) for the two backward kernels together — at dropout 0 and 0.1
    (its RNG is not the kernels': a time yardstick, never on the path).
    Per step: 12 launches of each.  Before it, ``nvcc -Xptxas -v``'s
    registers and spills of the tensor-core kernels."""
    import torch.nn.functional as F

    ptxas_report("flash_attention.cu", flash_kernel_info)
    fa = flash_module()
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    flush = torch.empty(1024 * 2**20, dtype=torch.uint8, device=DEVICE)
    q, k, v, do = flash_args(torch, gen, BERT_BH, BERT_SEQ, BERT_HEAD_DIM,
                             torch.bfloat16)
    args = (BERT_HEAD_DIM ** -0.5, False, BERT_DROPOUT,
            fa.seed_tensor(FLASH_SEED, torch.device(DEVICE)))
    before = dict(fa.flash_attention.launches)
    o, lse = fa._fwd_cuda(q, k, v, *args)
    delta = (o.float() * do.float()).sum(-1)
    calls = {"fwd": (lambda: fa._fwd_cuda(q, k, v, *args),
                     lambda: fa._fwd_plain(q, k, v, *args)),
             "dq": (lambda: fa._dq_cuda(q, k, v, do, lse, delta, *args),
                    lambda: fa._dq_plain(q, k, v, do, lse, delta, *args)),
             "dkv": (lambda: fa._dkv_cuda(q, k, v, do, lse, delta, *args),
                     lambda: fa._dkv_plain(q, k, v, do, lse, delta, *args))}
    shape4 = (BERT_BATCH, BERT_HEADS, BERT_SEQ, BERT_HEAD_DIM)
    q4, k4, v4 = (x.view(shape4).detach().requires_grad_(True)
                  for x in (q, k, v))
    do4 = do.view(shape4)
    library = {}
    for p in (0.0, BERT_DROPOUT):
        out4 = F.scaled_dot_product_attention(q4, k4, v4, dropout_p=p)
        library[p] = (
            time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, dropout_p=p), 20, flush),
            time_ms(torch, lambda: torch.autograd.grad(
                out4, (q4, k4, v4), do4, retain_graph=True), 20, flush))
    log(f"library: scaled_dot_product_attention at B {BERT_BATCH}, H "
        f"{BERT_HEADS}, S {BERT_SEQ}, D {BERT_HEAD_DIM}, bf16: forward "
        f"{library[0.0][0]:.4f} ms (dropout 0), "
        f"{library[BERT_DROPOUT][0]:.4f} ms (dropout {BERT_DROPOUT}); "
        f"backward (dQ, dK, dV in one call) {library[0.0][1]:.4f} ms / "
        f"{library[BERT_DROPOUT][1]:.4f} ms")
    res = {}
    for kern in FLASH:
        kfn, pfn = calls[kern]
        ms = time_ms(torch, kfn, 50, flush)
        plain_ms = time_ms(torch, pfn, 10, flush)
        ops_ms, bytes_ms = flash_bound(BERT_BH, BERT_SEQ, BERT_HEAD_DIM, kern)
        bound_ms = max(ops_ms, bytes_ms)
        lib_ms = library[BERT_DROPOUT][0 if kern == "fwd" else 1]
        res[kern] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": "operations" if ops_ms >= bytes_ms
                     else "bytes", "library_ms": lib_ms,
                     "max_abs_err": path_err[kern]}
        tflops = flash_flops(BERT_BH, BERT_SEQ, BERT_HEAD_DIM, kern) \
            / ms / 1e9
        log(f"time [flash_attention_{kern}, B*H {BERT_BH}, S {BERT_SEQ}, D "
            f"{BERT_HEAD_DIM}, bf16, dropout {BERT_DROPOUT}]: kernel "
            f"{ms:.4f} ms = {tflops:.1f} TFLOP/s, plain {plain_ms:.4f} ms, "
            f"library {lib_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({res[kern]['bound_by']}; operations "
            f"{ops_ms:.4f}, bytes {bytes_ms:.4f}), kernel at "
            f"{100 * bound_ms / ms:.1f}% of bound; per step (x{BERT_LAYERS})"
            f" kernel {BERT_LAYERS * ms:.3f} ms, bound "
            f"{BERT_LAYERS * bound_ms:.4f} ms")
    fa.flash_attention.launches = before       # timing is not the path
    bwd = res["dq"]["ms"] + res["dkv"]["ms"]
    log(f"time: backward kernels together {bwd:.4f} ms vs the library's "
        f"backward {library[BERT_DROPOUT][1]:.4f} ms = "
        f"{bwd / library[BERT_DROPOUT][1]:.2f}x; forward kernel "
        f"{res['fwd']['ms'] / library[BERT_DROPOUT][0]:.2f}x the library's")
    return res


# -------------------------------------------------------------- imperative --
def mlp_data(n_batches, batch):
    """MNIST-shaped batches with learnable labels: each image is its
    class's random prototype plus noise, in [0, 1], (N, 1, 28, 28)."""
    rng = np.random.RandomState(0)
    protos = rng.rand(10, 784).astype(np.float32)
    labels = rng.randint(0, 10, n_batches * batch).astype(np.int32)
    x = 0.6 * protos[labels] + 0.4 * rng.rand(n_batches * batch, 784)
    return x.astype(np.float32).reshape(-1, 1, 28, 28), labels


def mlp_batches(mx, x, y, ctx):
    """``(data, label)`` NDArrays of MLP_BATCH rows on ``ctx``, sliced
    from one copy of the whole set."""
    xd, yd = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx, dtype="int32")
    return [(xd[i:i + MLP_BATCH], yd[i:i + MLP_BATCH])
            for i in range(0, len(y), MLP_BATCH)]


def mlp_net(mx, ctx, start=None):
    """The example's net, made and initialised as ``_run`` makes it
    (Xavier) inside ``with ctx:``, sized by a forward; its parameters
    set from ``start`` if given."""
    with ctx:
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(MLP_UNITS[0], activation="relu"),
                mx.gluon.nn.Dense(MLP_UNITS[1], activation="relu"),
                mx.gluon.nn.Dense(MLP_UNITS[2]))
        net.initialize(mx.init.Xavier())
        net(mx.nd.zeros((1, 784)))
    params = list(net.collect_params().values())
    for p, v in zip(params, start or ()):
        p.set_data(v)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    return net, trainer, params


def mlp_steps(mx, net, trainer, batches):
    """The training loop of examples/train_mnist_mlp.py's ``_run``, as
    written there; returns each step's loss (NDArrays, not read)."""
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    metric = mx.metric.Accuracy()
    losses = []
    for data, label in batches:
        data = data.reshape((data.shape[0], -1))
        with mx.autograd.record():
            out = net(data)
            loss = loss_fn(out, label)
        loss.backward()
        trainer.step(data.shape[0])
        metric.update([label], [out])
        losses.append(loss)
    return losses, metric.get()[1]


def imperative_mlp(torch):
    """(a) The MLP loop on card NDArrays: MLP_CHECK steps held against
    the same steps on the host from the same parameters, then
    MLP_WARMUP + MLP_TIMED steps timed (the loss must fall), one step
    under the profiler, and the host time of an ``nd`` dispatch."""
    import mxnet_tpu_torch as mx

    card, host = mx.gpu(0), mx.cpu()
    mx.random.seed(0)
    x, y = mlp_data(MLP_WARMUP + MLP_TIMED + 1, MLP_BATCH)
    batches = mlp_batches(mx, x, y, card)
    net, trainer, params = mlp_net(mx, card)
    start = [p.data().asnumpy() for p in params]
    on_card = [float(v.mean().asscalar()) for v in
               mlp_steps(mx, net, trainer, batches[:MLP_CHECK])[0]]
    hnet, htrainer, _ = mlp_net(mx, host, start)
    on_host = [float(v.mean().asscalar()) for v in
               mlp_steps(mx, hnet, htrainer,
                         mlp_batches(mx, x[:MLP_CHECK * MLP_BATCH],
                                     y[:MLP_CHECK * MLP_BATCH], host))[0]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(on_card, on_host))
    log(f"imperative MLP: {MLP_CHECK} steps, mean loss card {on_card} vs "
        f"host {on_host}, max relative difference {rel:.3e}")
    expect(rel <= MLP_LOSS_RTOL, f"imperative MLP: card and host losses "
           f"differ by {rel:.3e} relative (limit {MLP_LOSS_RTOL})")

    net, trainer, params = mlp_net(mx, card, start)
    mlp_steps(mx, net, trainer, batches[:MLP_WARMUP])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, acc = mlp_steps(mx, net, trainer,
                            batches[MLP_WARMUP:MLP_WARMUP + MLP_TIMED])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / MLP_TIMED
    means = [float(v.mean().asscalar()) for v in losses]
    expect(all(np.isfinite(means)) and
           np.mean(means[-5:]) < np.mean(means[:5]),
           f"imperative MLP: the loss did not fall ({means[:5]} ... "
           f"{means[-5:]})")
    expect(all(bool(torch.isfinite(p.tensor()).all()) for p in params),
           "imperative MLP: a parameter is not finite")
    acct = accounting_turns(torch, lambda: mlp_steps(
        mx, net, trainer, batches[MLP_WARMUP:MLP_WARMUP + MLP_TIMED]),
        MLP_TIMED)
    log_accounting(f"imperative MLP, {MLP_TIMED} steps a turn", acct)
    busy = profile_mlp_step(torch, mx, net, trainer, batches[-1:],
                            f"imperative MLP step, batch {MLP_BATCH}")

    dispatch = dispatch_times(torch, mx, card)
    dispatch_us = dispatch["on"]
    log(f"imperative MLP (784-{'-'.join(map(str, MLP_UNITS))}, batch "
        f"{MLP_BATCH}, SGD 0.1): {ms:.3f} ms/step = "
        f"{MLP_BATCH * 1e3 / ms:.1f} samples/s over {MLP_TIMED} steps, "
        f"loss {np.mean(means[:5]):.4f} -> {np.mean(means[-5:]):.4f}, "
        f"train accuracy {acc:.4f}; device busy {100 * busy:.1f}% of a "
        f"profiled step; nd.add on {list(DISPATCH_SHAPE)}: "
        f"{dispatch_us:.2f} host us a dispatch ({DISPATCH_CALLS} calls) "
        f"with the storage accounting on, {dispatch['off']:.2f} with it "
        f"off (timed in turns: on, off, off, on): the accounting costs "
        f"{dispatch_us - dispatch['off']:.2f} us a dispatch")
    return {"ms_step": ms, "busy": busy, "dispatch_us": dispatch_us,
            "dispatch_off_us": dispatch["off"], "accounting": acct}


def dispatch_times(torch, mx, card):
    """Host us of one ``nd.add`` on DISPATCH_SHAPE over DISPATCH_CALLS
    calls, with ``storage``'s accounting on and off (each NDArray made
    registers its storage), timed in turns on, off, off, on."""
    from mxnet_tpu_torch import storage

    a = mx.nd.ones(DISPATCH_SHAPE, ctx=card)
    for _ in range(10):
        mx.nd.add(a, a)
    times = {"on": [], "off": []}
    was_on = storage._enabled
    try:
        for turn in ("on", "off", "off", "on"):
            storage.set_accounting(turn == "on")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DISPATCH_CALLS):
                mx.nd.add(a, a)
            times[turn].append((time.perf_counter() - t0) * 1e6
                               / DISPATCH_CALLS)
            torch.cuda.synchronize()
    finally:
        storage.set_accounting(was_on)
    return {k: float(np.mean(v)) for k, v in times.items()}


def accounting_turns(torch, run, steps):
    """ms a step of ``run()`` (which takes ``steps`` steps) with
    ``storage``'s accounting on and off, timed in ACCOUNTING_ROUNDS
    rounds of turns on, off, off, on: what the accounting costs end to
    end.  Returns each side's times."""
    from mxnet_tpu_torch import storage

    times = {"on": [], "off": []}
    was_on = storage._enabled
    try:
        for turn in ("on", "off", "off", "on") * ACCOUNTING_ROUNDS:
            storage.set_accounting(turn == "on")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times[turn].append((time.perf_counter() - t0) * 1e3 / steps)
    finally:
        storage.set_accounting(was_on)
    return times


def log_accounting(what, times):
    """One line: each side's median and range, and the difference of
    the medians against the spread of the off side's own turns."""
    on, off = (float(np.median(times[k])) for k in ("on", "off"))
    spread = max(times["off"]) - min(times["off"])
    log(f"{what}: storage accounting on {on:.3f} ms/step (median of "
        f"{len(times['on'])}, {min(times['on']):.3f}..{max(times['on']):.3f}"
        f"), off {off:.3f} ({min(times['off']):.3f}..{max(times['off']):.3f}"
        f"), in turns on, off, off, on: the medians differ by "
        f"{on - off:+.3f} ms a step ({100 * (on / off - 1):+.1f}%) against "
        f"a spread of {spread:.3f} among the off turns")


def profile_mlp_step(torch, mx, net, trainer, batches, what):
    """One MLP step under ``torch.profiler``: the device's busy share."""
    prof, wall_us, _ = profiled(
        torch, lambda: mlp_steps(mx, net, trainer, batches), what)
    return print_profile(prof, wall_us, what)


def imperative_fused(torch):
    """(b) ``nd.FusedNormReluConv`` at IMPERATIVE_FUSED, bf16, forward
    and backward under ``record()`` on card NDArrays: one launch of each
    kernel, counted from 0, then every output and gradient held against
    the same op through the plain versions on the card."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import fused_conv as fc

    n, hw, ci, co = IMPERATIVE_FUSED
    gen = torch.Generator(device=DEVICE).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    x = randn(n, hw, hw, ci).bfloat16()
    w = (randn(3, 3, ci, co) * (2.0 / (9 * ci)) ** 0.5).bfloat16()
    gamma = torch.rand(ci, generator=gen, device=DEVICE) + 0.5
    beta = 0.1 * randn(ci)
    do = randn(n, hw, hw, co).bfloat16()

    def run():
        args = [mx.nd.NDArray(t.clone()) for t in (x, w, gamma, beta)]
        for a in args:
            a.attach_grad()
        stats = [mx.nd.zeros((ci,), ctx=mx.gpu(0)),
                 mx.nd.ones((ci,), ctx=mx.gpu(0))]
        with mx.autograd.record():
            out, new_mm, new_mv = mx.nd.FusedNormReluConv(*args, *stats)
        out.backward(mx.nd.NDArray(do))
        return [t._data.detach() for t in (out, new_mm, new_mv)] + \
            [a.grad._data for a in args]

    fc.norm_relu_conv.launches = dict.fromkeys(FUSED, 0)
    got = run()
    torch.cuda.synchronize()
    launches = dict(fc.norm_relu_conv.launches)
    expect(launches == dict.fromkeys(FUSED, 1),
           f"nd.FusedNormReluConv launched {launches}, expected one of "
           f"each kernel")
    with plain_versions(fc):
        want = run()
    expect(fc.norm_relu_conv.launches == launches,
           "nd.FusedNormReluConv: the plain route launched kernels")
    names = ("out", "new moving mean", "new moving var", "dx", "dw",
             "dgamma", "dbeta")
    what = f"nd.FusedNormReluConv {list(x.shape)} -> {co}, 3x3, bf16"
    err = {nm: check_outputs(torch, what, nm, [g], [p])
           for nm, g, p in zip(names, got, want)}
    log(f"imperative fused [{what}]: launches {launches}; max abs err vs "
        f"the plain versions " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in err.items()))
    return launches


def imperative_trainer_vs_step(torch):
    """(c) One ``gluon.Trainer`` step (NDArrays, ``record``,
    ``backward``, ``step``) against one ``TrainStep(capture=False)`` step
    of fused resnet50_v1, f32, batch IMPERATIVE_BATCH, SGD_KW, from the
    same parameters: every parameter after the step held leaf by leaf
    against the noise floor of the Trainer step on the host CPU."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.ops import fused_conv as fc

    net = build_resnet50(torch, fused=True)
    host = build_resnet50(torch, fused=True, device="cpu")
    params = list(net.collect_params().items())
    for (_, p), q in zip(params, host.collect_params().values()):
        q.set_data(p.tensor().detach().cpu())
    start = [p.tensor().detach().clone() for _, p in params]
    rng = np.random.RandomState(4)
    x = rng.randn(IMPERATIVE_BATCH, 224, 224, 3).astype(np.float32)
    y = rng.randint(0, 1000, IMPERATIVE_BATCH).astype(np.int32)

    def trainer_step(block, ctx):
        trainer = mx.gluon.Trainer(block.collect_params(), "sgd",
                                   dict(SGD_KW))
        xd = mx.nd.array(x, ctx=ctx)
        yd = mx.nd.array(y, ctx=ctx, dtype="int32")
        with mx.autograd.record():
            loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(block(xd), yd)
        loss.backward()
        trainer.step(IMPERATIVE_BATCH)
        return [p.tensor().detach().double().cpu()
                for p in block.collect_params().values()]

    fc.norm_relu_conv.launches = dict.fromkeys(FUSED, 0)
    via_trainer = trainer_step(net, mx.gpu(0))
    launches = dict(fc.norm_relu_conv.launches)
    expect(launches == dict.fromkeys(FUSED, FUSED_PER_STEP),
           f"Trainer step: kernel launches {launches}, expected "
           f"{FUSED_PER_STEP} each")
    for (_, p), v in zip(params, start):
        p.set_data(v)
    step = parallel.TrainStep(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
        optimizer.create("sgd", **SGD_KW), capture=False)
    step(torch.from_numpy(x), torch.from_numpy(y))
    step.sync_params_to_net()
    via_step = [p.tensor().detach().double().cpu() for _, p in params]
    on_host = trainer_step(host, mx.cpu())
    kinds = [(n, "parameter" if p.grad_req != "null"
              else "running statistic") for n, p in params]
    hold_leaves(torch, kinds, via_trainer, via_step, on_host,
                f"Trainer vs TrainStep, resnet50_v1 f32, batch "
                f"{IMPERATIVE_BATCH}")
    return launches


# --------------------------------------------------------------- hybridize --
def hybrid_mlp(torch, eager):
    """(a) The MLP loop of 3(a) with ``net.hybridize()``: MLP_CHECK steps
    held against the eager loop from the same parameters (mean losses
    within MLP_LOSS_RTOL relative), then MLP_WARMUP + 2 x MLP_TIMED
    timed steps in turns with the eager loop's (the loss must fall),
    one profiled step and the units held, beside 3(a)'s eager figures
    of this run (``eager``)."""
    import mxnet_tpu_torch as mx

    card = mx.gpu(0)
    mx.random.seed(0)
    x, y = mlp_data(MLP_WARMUP + MLP_TIMED + 1, MLP_BATCH)
    batches = mlp_batches(mx, x, y, card)
    start = [p.data().asnumpy() for p in mlp_net(mx, card)[2]]
    runs = []
    for hybridize in (False, True):
        net, trainer, _ = mlp_net(mx, card, start)
        if hybridize:
            net.hybridize()
        runs.append([float(v.mean().asscalar()) for v in
                     mlp_steps(mx, net, trainer, batches[:MLP_CHECK])[0]])
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs[1], runs[0]))
    log(f"hybridized MLP: {MLP_CHECK} steps, mean loss hybridized "
        f"{runs[1]} vs eager {runs[0]}, max relative difference {rel:.3e}")
    expect(rel <= MLP_LOSS_RTOL, f"hybridized MLP: losses differ from the "
           f"eager loop's by {rel:.3e} relative (limit {MLP_LOSS_RTOL})")

    # the eager loop and the hybridized one in turns (eager, hybridized,
    # hybridized, eager): the host's own speed drifts between runs
    loops = {}
    for hybridize in (False, True):
        net, trainer, params = mlp_net(mx, card, start)
        if hybridize:
            net.hybridize()
        mlp_steps(mx, net, trainer, batches[:MLP_WARMUP])
        loops[hybridize] = (net, trainer, params)
    times = {False: [], True: []}
    for hybridize in (False, True, True, False):
        net, trainer, params = loops[hybridize]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, acc = mlp_steps(mx, net, trainer,
                                batches[MLP_WARMUP:MLP_WARMUP + MLP_TIMED])
        torch.cuda.synchronize()
        times[hybridize].append((time.perf_counter() - t0) * 1e3 / MLP_TIMED)
        if hybridize and len(times[True]) == 1:
            means = [float(v.mean().asscalar()) for v in losses]
            first_acc = acc
    ms, ms_eager = np.mean(times[True]), np.mean(times[False])
    expect(all(np.isfinite(means)) and
           np.mean(means[-5:]) < np.mean(means[:5]),
           f"hybridized MLP: the loss did not fall ({means[:5]} ... "
           f"{means[-5:]})")
    net, trainer, params = loops[True]
    expect(all(bool(torch.isfinite(p.tensor()).all()) for p in params),
           "hybridized MLP: a parameter is not finite")
    acct = accounting_turns(torch, lambda: mlp_steps(
        mx, net, trainer, batches[MLP_WARMUP:MLP_WARMUP + MLP_TIMED]),
        MLP_TIMED)
    log_accounting(f"hybridized MLP, {MLP_TIMED} steps a turn", acct)
    busy = profile_mlp_step(torch, mx, net, trainer, batches[-1:],
                            f"hybridized MLP step, batch {MLP_BATCH}")
    graphs = net.graph_count()
    expect(graphs == 1, f"hybridized MLP: {graphs} units held, expected "
           f"1 (the recording forward and backward)")
    log(f"hybridized MLP (784-{'-'.join(map(str, MLP_UNITS))}, batch "
        f"{MLP_BATCH}, SGD 0.1): {ms:.3f} ms/step "
        f"({', '.join(f'{t:.3f}' for t in times[True])}) = "
        f"{MLP_BATCH * 1e3 / ms:.1f} samples/s over 2 x {MLP_TIMED} steps, "
        f"loss {np.mean(means[:5]):.4f} -> {np.mean(means[-5:]):.4f}, "
        f"train accuracy {first_acc:.4f}; device busy {100 * busy:.1f}% of "
        f"a profiled step; {graphs} unit held (a forward and a backward "
        f"graph); the eager loop in turns with it {ms_eager:.3f} ms/step "
        f"({', '.join(f'{t:.3f}' for t in times[False])}) = "
        f"{ms_eager / ms:.3f}x; 3(a)'s eager run {eager['ms_step']:.3f} "
        f"ms/step, busy {100 * eager['busy']:.1f}%")
    return {"ms_step": ms, "ms_eager": ms_eager, "busy": busy,
            "graphs": graphs, "accounting": acct}


def hybrid_resnet(torch):
    """(b) The path of BASELINE config 2: fused resnet50_v1, NHWC, bf16,
    ``net.hybridize()`` and ``gluon.Trainer`` (SGD_KW), batch TRAIN_BATCH
    of RandomState(0) inputs: WARMUP_STEPS + HYBRID_STEPS timed steps
    (the loss falls; each fused kernel FUSED_PER_STEP times a step, the
    timed ones all replayed), one profiled step, peak memory; then
    HYBRID_CHECK_STEPS replayed steps and as many eager ones
    (``hybridize(active=False)``) from the same parameters, whose
    leaves ``hold_hybrid`` holds once the model check has its floors."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import fused_conv as fc

    net = build_resnet50(torch, fused=True, dtype="bfloat16")
    params = list(net.collect_params().items())
    start = [p.tensor().detach().clone() for _, p in params]
    rng = np.random.RandomState(0)
    xh = rng.randn(TRAIN_BATCH, 224, 224, 3).astype(np.float32)
    yh = rng.randint(0, 1000, (TRAIN_BATCH,)).astype(np.int32)
    x = mx.nd.NDArray(torch.from_numpy(xh).to(DEVICE).to(torch.bfloat16))
    y = mx.nd.NDArray(torch.from_numpy(yh).to(DEVICE))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def fresh_trainer():
        for (_, p), v in zip(params, start):
            p.set_data(v)
        return mx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD_KW))

    def run(trainer, steps):
        losses = []
        for _ in range(steps):
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(TRAIN_BATCH)
            losses.append(loss.mean())
        return losses

    net.hybridize()
    trainer = fresh_trainer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fc.norm_relu_conv.launches = dict.fromkeys(FUSED, 0)  # main path starts
    losses = run(trainer, WARMUP_STEPS)
    torch.cuda.synchronize()
    warm = dict(fc.norm_relu_conv.launches)
    t0 = time.perf_counter()
    losses += run(trainer, HYBRID_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(fc.norm_relu_conv.launches)           # ... and ends here
    replayed = {k: launches[k] - warm[k] for k in FUSED}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v.asscalar()) for v in losses]
    what = f"hybridized fused resnet50_v1, bf16, batch {TRAIN_BATCH}"
    expect(all(np.isfinite(losses)), f"{what}: loss not finite {losses}")
    expect(losses[-1] < losses[0] and min(losses) < losses[0],
           f"{what}: loss did not fall over the run {losses}")
    expect(replayed == dict.fromkeys(FUSED, FUSED_PER_STEP * HYBRID_STEPS)
           and launches == dict.fromkeys(
               FUSED, FUSED_PER_STEP * (WARMUP_STEPS + HYBRID_STEPS)),
           f"{what}: kernel launches {launches} ({replayed} replayed), "
           f"expected {FUSED_PER_STEP} each a step")
    expect(net.graph_count() == 1, f"{what}: {net.graph_count()} units")
    img_s = TRAIN_BATCH * HYBRID_STEPS / dt
    log(f"train [{what}, gluon.Trainer]: losses "
        f"{[round(v, 4) for v in losses]}; {HYBRID_STEPS} timed steps in "
        f"{dt:.3f} s = {1e3 * dt / HYBRID_STEPS:.1f} ms/step = "
        f"{img_s:.1f} img/s; peak device memory {peak / 2**30:.2f} GiB; "
        f"kernel launches {launches}, {replayed} of them replayed in the "
        f"timed steps; 1 unit (a forward and a backward graph)")
    acct = accounting_turns(torch, lambda: run(trainer, ACCOUNTING_STEPS),
                            ACCOUNTING_STEPS)
    log_accounting(f"train [{what}, gluon.Trainer], {ACCOUNTING_STEPS} "
                   f"steps a turn", acct)
    prof, wall_us, _ = profiled(torch, lambda: run(trainer, 1),
                                f"{what}, gluon.Trainer step")
    busy = print_profile(prof, wall_us, f"{what}, gluon.Trainer step")
    del prof

    leaves = []
    for hybridized in (True, False):
        if not hybridized:
            net.hybridize(active=False)     # drops the graphs
            gc.collect()
            torch.cuda.empty_cache()
        check = [float(v.asscalar())
                 for v in run(fresh_trainer(), HYBRID_CHECK_STEPS)]
        leaves.append((check, [p.tensor().detach().double().cpu()
                               for _, p in params]))
    (lh, hyb), (le, eag) = leaves
    same = lh == le and all(torch.equal(a, b) for a, b in zip(hyb, eag))
    log(f"train [{what}]: {HYBRID_CHECK_STEPS} replayed steps against as "
        f"many eager ones from the same parameters: losses {lh} vs {le}; "
        f"{len(hyb)} parameters and running statistics "
        f"{'the same bits' if same else 'not the same bits'}")
    kinds = [(n, "parameter" if p.grad_req != "null"
              else "running statistic") for n, p in params]
    return {"ms_step": 1e3 * dt / HYBRID_STEPS, "img_s": img_s,
            "busy": busy, "peak": peak, "launches": launches,
            "replayed": replayed, "same": same, "accounting": acct,
            "leaves": (kinds, hyb, eag)}


def hold_hybrid(torch, hybrid, floors):
    """The hybridized ResNet-50's leaves after its check steps against
    the eager ones, leaf by leaf, at the model check's noise floors
    (``floors``; a parameter at the gradients' floor)."""
    kinds, hyb, eag = hybrid.pop("leaves")
    hold_leaves(torch, kinds, hyb, eag, None,
                f"hybridized vs eager gluon.Trainer, resnet50_v1 bf16, "
                f"batch {TRAIN_BATCH}, {HYBRID_CHECK_STEPS} steps",
                floors={"parameter": floors["gradient"],
                        "running statistic": floors["running statistic"]})


# ---------------------------------------------------------- input pipeline --
def natives():
    """(a) The host natives built from ``src/`` (``g++`` into
    ``mxnet_tpu_torch/_build/``): build seconds and which loaded.
    ``librecordio`` and ``libstoragepool`` are required; the JPEG
    decoder needs libjpeg's headers, and its status is printed with the
    compiler's reason when it did not build."""
    from mxnet_tpu_torch import base, recordio, storage
    from mxnet_tpu_torch import io as mio

    t0 = time.perf_counter()
    live = {"librecordio": recordio.native(),
            "libstoragepool": storage.pool_info()["native"],
            "libimagedecode": mio._native_decoder() is not None}
    dt = time.perf_counter() - t0
    status = base.native_status()
    for name, ok in live.items():
        st = status.get(name, {})
        log(f"natives: {name} {'loaded' if ok else 'NOT loaded'} "
            f"({st.get('seconds', 0.0):.2f} s)"
            + ("" if ok else f": {st.get('error')}"))
    log(f"natives: built and loaded in {dt:.2f} s")
    expect(live["librecordio"] and live["libstoragepool"],
           f"natives: librecordio and libstoragepool must load on the "
           f"card machine: {status}")
    return live


@contextlib.contextmanager
def port_as_mxnet(argv, env=None):
    """The port bound as ``mxnet_tpu`` while an example is imported and
    run (so ``import mxnet_tpu as mx`` in it binds the port and nothing
    of the JAX package loads), every loaded module of the port under its
    ``mxnet_tpu.*`` name too (so ``from mxnet_tpu.gluon.model_zoo...
    import`` finds the loaded module and loads no second copy), with
    ``sys.argv`` = ``argv`` and the environment updated by ``env``; all
    restored after."""
    import mxnet_tpu_torch  # noqa: F401  (loads every module of the port)

    names = {"mxnet_tpu" + k[len("mxnet_tpu_torch"):]: m
             for k, m in list(sys.modules.items())
             if k == "mxnet_tpu_torch" or k.startswith("mxnet_tpu_torch.")}
    saved = {k: sys.modules.get(k) for k in names}
    old_argv, old_env = sys.argv, {k: os.environ.get(k) for k in env or {}}
    sys.modules.update(names)
    sys.argv = argv
    os.environ.update(env or {})
    try:
        yield
    finally:
        sys.argv = old_argv
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for k, m in saved.items():
            if m is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = m


def run_example(root, name, args, env=None):
    """``examples/<name>.py``'s ``main()`` as written, with the port as
    ``mx``; returns what it printed (also logged)."""
    import importlib.util
    import io as _io

    path = os.path.join(root, "examples", f"{name}.py")
    out = _io.StringIO()
    with port_as_mxnet([path] + args, env):
        spec = importlib.util.spec_from_file_location(f"_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        expect(mod.mx.__name__ == "mxnet_tpu_torch",
               f"{name}: mx is {mod.mx.__name__}, not the port")
        with contextlib.redirect_stdout(out):
            mod.main()
    text = out.getvalue()
    for line in text.splitlines():
        log(f"example {name} {' '.join(args)}: {line}")
    return text


def mnist_example(torch, root):
    """(b) ``examples/train_mnist_mlp.py``'s ``main()`` as written:
    MNIST_EPOCHS epochs at batch 256 over the synthetic MNIST through
    ``DataLoader`` with ``ToTensor`` (last val_acc at least
    MNIST_MIN_ACC); one epoch with ``--hybridize``; one epoch with two
    forked workers (``MXNET_CPU_WORKER_NTHREADS=2``), and the first
    shuffled batch of two workers against that of none (the same
    bits).  The initializers and the shuffle are seeded first."""
    import mxnet_tpu_torch as mx

    mx.random.seed(0)               # the initializers' stream
    np.random.seed(MNIST_SHUFFLE_SEED)  # the DataLoader's shuffle
    text = run_example(root, "train_mnist_mlp",
                       ["--epochs", str(MNIST_EPOCHS), "--batch-size", "256"])
    accs = [float(v) for v in re.findall(r"val_acc=([0-9.]+)", text)]
    expect(len(accs) == MNIST_EPOCHS and accs[-1] >= MNIST_MIN_ACC,
           f"MNIST example: val_acc {accs}, the last must be at least "
           f"{MNIST_MIN_ACC}")
    hyb = run_example(root, "train_mnist_mlp",
                      ["--epochs", "1", "--hybridize"])
    workers = run_example(root, "train_mnist_mlp", ["--epochs", "1"],
                          env={"MXNET_CPU_WORKER_NTHREADS": "2"})
    data = mx.gluon.data
    ds = data.vision.MNIST(train=True).transform_first(
        data.vision.transforms.ToTensor())
    first = []
    for n in (0, 2):
        np.random.seed(MNIST_SHUFFLE_SEED)
        with data.DataLoader(ds, batch_size=256, shuffle=True,
                             num_workers=n) as loader:
            x, y = next(iter(loader))
            expect(x.context == mx.gpu(0), f"DataLoader(num_workers={n}) "
                   f"gave a batch on {x.context}")
            first.append((x.asnumpy(), y.asnumpy()))
    same = all(np.array_equal(a, b) for a, b in zip(*first))
    expect(same, "DataLoader: the first batch of 2 workers differs from "
           "that of 0 workers")
    log(f"MNIST example: val_acc {accs} over {MNIST_EPOCHS} epochs; "
        f"hybridized epoch {re.findall(r'val_acc=[0-9.]+ time=[0-9.]+s', hyb)}"
        f"; 2 workers {re.findall(r'val_acc=[0-9.]+ time=[0-9.]+s', workers)};"
        f" the first batch of 2 forked workers the same bits as 0 workers'")
    return accs


def write_records(torch, path):
    """REC_COUNT raw records of REC_HW x REC_HW x 3 uint8 from
    RandomState(0), labels of REC_CLASSES classes, through
    ``MXIndexedRecordIO``; returns ``{key: (image, label)}``."""
    from mxnet_tpu_torch import recordio

    rng = np.random.RandomState(0)
    recs = {}
    t0 = time.perf_counter()
    w = recordio.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
    expect(w.route == "native", "records: the writer is not native")
    for i in range(REC_COUNT):
        img = rng.randint(0, 256, (REC_HW, REC_HW, 3)).astype(np.uint8)
        label = float(rng.randint(0, REC_CLASSES))
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(0, label, i, 0),
                                         img, img_fmt=".raw"))
        recs[i] = (img, label)
    w.close()
    size = os.path.getsize(path + ".rec")
    log(f"records: {REC_COUNT} raw {REC_HW}x{REC_HW}x3 records, "
        f"{size / 1e6:.1f} MB, written in {time.perf_counter() - t0:.2f} s")
    return recs


def record_iter(path):
    """``ImageRecordIter`` with ``examples/train_resnet_fused.py``'s
    ``--rec`` arguments (batch REC_BATCH)."""
    from mxnet_tpu_torch import io as mio

    return mio.ImageRecordIter(
        path + ".rec", data_shape=(3, 224, 224), batch_size=REC_BATCH,
        shuffle=True, rand_crop=True, rand_mirror=True, resize=256,
        preprocess_threads=os.cpu_count() or 1,
        mean_r=123.7, mean_g=116.3, mean_b=103.5,
        std_r=58.4, std_g=57.1, std_b=57.4)


def expected_first_batch(recs, it):
    """The iterator's first batch recomputed in plain numpy from its
    seed (0) and the records: the shuffle, then per image a crop offset
    and a mirror coin from the draws of the route the iterator took
    (native: one RandomState per batch; worker processes: one per image;
    in-process: the iterator's own), then (x - mean) / std."""
    c, h, w = it._shape
    rng = np.random.RandomState(0)
    order = list(range(REC_COUNT))
    rng.shuffle(order)
    keys = order[:REC_BATCH]
    if it._native is not None:
        draws = [np.random.RandomState(rng.randint(2 ** 31))] * REC_BATCH
    elif it._pool is not None:
        draws = [np.random.RandomState(s)
                 for s in rng.randint(0, 2 ** 31, size=REC_BATCH)]
    else:
        draws = [rng] * REC_BATCH
    out = np.empty((REC_BATCH, c, h, w), np.float32)
    for i, (k, r) in enumerate(zip(keys, draws)):
        img = recs[k][0]
        y0 = r.randint(0, REC_HW - h + 1)
        x0 = r.randint(0, REC_HW - w + 1)
        img = img[y0:y0 + h, x0:x0 + w]
        if r.rand() < 0.5:
            img = img[:, ::-1]
        out[i] = img.transpose(2, 0, 1)
    mean = np.array([123.7, 116.3, 103.5], np.float32).reshape(1, 3, 1, 1)
    std = np.array([58.4, 57.1, 57.4], np.float32).reshape(1, 3, 1, 1)
    out -= mean
    out /= std
    return out, np.array([recs[k][1] for k in keys], np.float32)


def record_checks(torch, recs, path):
    """(c) The example's ``ImageRecordIter`` on the card: the first batch
    against ``expected_first_batch`` (the same bits), a held batch
    unchanged after two more ``next()`` (its pinned staging buffer is
    recycled only after its copy), then the iterator alone, host
    img/s over REC_RATE_BATCHES batches."""
    it = record_iter(path)
    route = ("native decode thread" if it._native is not None else
             "worker processes" if it._pool is not None else "in-process")
    b = it.next()
    x, y = b.data[0], b.label[0]
    expect(x.context.device_type == "gpu", f"records: batch on {x.context}")
    want_x, want_y = expected_first_batch(recs, it)
    snap = x.asnumpy().copy()
    expect(np.array_equal(snap, want_x) and np.array_equal(y.asnumpy(),
                                                           want_y),
           f"records: the first batch differs from its numpy recomputation "
           f"(max abs err {float(np.abs(snap - want_x).max()):.3e})")
    it.next()
    it.next()
    torch.cuda.synchronize()
    expect(np.array_equal(x.asnumpy(), snap),
           "records: a held batch changed after two more next() calls")
    it.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    while n < REC_RATE_BATCHES:
        try:
            it.next()
            n += 1
        except StopIteration:
            it.reset()
    torch.cuda.synchronize()
    rate = n * REC_BATCH / (time.perf_counter() - t0)
    it.close()
    log(f"records: ImageRecordIter ({route}, preprocess_threads "
        f"{os.cpu_count()}) first batch the same bits as its numpy "
        f"recomputation; a held batch survives two more next(); the "
        f"iterator alone {rate:.1f} img/s on the host ({n} batches of "
        f"{REC_BATCH}, to the card)")
    return {"route": route, "img_s": rate}


def fed_steps(torch, step, feed, steps):
    """``steps`` steps of ``step`` over ``feed``; returns the seconds
    (synchronised) and the losses."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(*next(feed)) for _ in range(steps)]
    torch.cuda.synchronize()
    return time.perf_counter() - t0, [float(v) for v in losses]


def fed_run(torch, step, source, what):
    """WARMUP_STEPS + FED_STEPS steps of ``step`` fed by ``source``
    through ``DevicePrefetcher(depth=2)``, the kernels' launches counted
    from 0, then one profiled step; the timed steps' wait split."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.ops.fused_conv import norm_relu_conv

    norm_relu_conv.launches = dict.fromkeys(FUSED, 0)   # main path starts
    with parallel.DevicePrefetcher(source, depth=2) as pf:
        feed = iter(pf)
        _, losses = fed_steps(torch, step, feed, WARMUP_STEPS)
        warm = dict(norm_relu_conv.launches)
        expect(step.graph_count() == 1,
               f"{what}: {step.graph_count()} graphs after the warm-up")
        w0 = {k: pf.stats[k] for k in ("producer_wait_s", "consumer_wait_s")}
        dt, timed = fed_steps(torch, step, feed, FED_STEPS)
        waits = {k: pf.stats[k] - w0[k] for k in w0}
        launches = dict(norm_relu_conv.launches)        # ... and ends here
        prof, wall_us, _ = profiled(torch, lambda: step(*next(feed)),
                                    f"{what}, one step")
        busy = print_profile(prof, wall_us, f"{what}, one step")
        del prof
    losses += timed
    replayed = {k: launches[k] - warm[k] for k in FUSED}
    expect(all(np.isfinite(losses)), f"{what}: loss not finite {losses}")
    expect(replayed == dict.fromkeys(FUSED, FUSED_PER_STEP * FED_STEPS)
           and step.graph_count() == 1,
           f"{what}: kernel launches {launches} ({replayed} in the timed "
           f"steps), expected {FUSED_PER_STEP} of each a step, replayed")
    img_s = TRAIN_BATCH * FED_STEPS / dt
    pace = ("the feed" if waits["consumer_wait_s"]
            > waits["producer_wait_s"] else "the step")
    log(f"fed [{what}]: losses {[round(v, 4) for v in losses]}; "
        f"{FED_STEPS} timed steps in {dt:.3f} s = {1e3 * dt / FED_STEPS:.1f}"
        f" ms/step = {img_s:.1f} img/s; busy {100 * busy:.1f}%; waits over "
        f"the timed steps: producer {waits['producer_wait_s']:.3f} s, "
        f"consumer {waits['consumer_wait_s']:.3f} s "
        f"({pace} sets the pace); launches {launches}, {replayed} replayed "
        f"in the timed steps")
    return {"img_s": img_s, "ms_step": 1e3 * dt / FED_STEPS, "busy": busy,
            "launches": launches, **waits}


def fed_resnet(torch, path):
    """(d) The captured bf16 fused ResNet-50 ``TrainStep`` (phase 9's
    settings) fed by the example's ``--rec`` loop body — the iterator
    above, the NHWC transpose and the bf16 cast on the card — through
    ``DevicePrefetcher(depth=2)``; then the same steps fed by
    ``DataLoader(pin_memory=True)`` over an ``ArrayDataset`` of host
    images (the shape of ``bench resnet --feed prefetch``)."""
    import itertools

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, optimizer, parallel

    net = build_resnet50(torch, fused=True, dtype="bfloat16")

    def new_step():
        return parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                  optimizer.create("sgd", **SGD_KW))

    it = record_iter(path)

    def batches():                  # examples/train_resnet_fused.py's loop
        while True:
            for b in it:
                x = b.data[0].transpose((0, 2, 3, 1)).astype("bfloat16")
                yield x, b.label[0]
            it.reset()

    n = WARMUP_STEPS + FED_STEPS + PROFILE_TRIES
    rec = fed_run(torch, new_step(), itertools.islice(batches(), n),
                  f"fused resnet50_v1 bf16, batch {TRAIN_BATCH}, fed by "
                  f"ImageRecordIter")
    it.close()
    gc.collect()
    torch.cuda.empty_cache()

    rng = np.random.RandomState(0)
    xs = rng.randn(2 * TRAIN_BATCH, 224, 224, 3).astype(np.float32)
    ys = rng.randint(0, 1000, (2 * TRAIN_BATCH,)).astype(np.int32)
    loader = gluon.data.DataLoader(gluon.data.ArrayDataset(xs, ys),
                                   batch_size=TRAIN_BATCH, pin_memory=True,
                                   last_batch="discard")

    def loaded():
        while True:
            for x, y in loader:
                yield x.astype("bfloat16"), y

    step = new_step()
    feed = itertools.islice(loaded(), n)
    from mxnet_tpu_torch.ops.fused_conv import norm_relu_conv
    norm_relu_conv.launches = dict.fromkeys(FUSED, 0)
    _, losses = fed_steps(torch, step, feed, WARMUP_STEPS)
    dt, timed = fed_steps(torch, step, feed, FED_STEPS)
    launches = dict(norm_relu_conv.launches)
    loader.close()
    expect(all(np.isfinite(losses + timed)) and step.graph_count() == 1
           and launches == dict.fromkeys(
               FUSED, FUSED_PER_STEP * (WARMUP_STEPS + FED_STEPS)),
           f"DataLoader(pin_memory=True) feed: losses {losses + timed}, "
           f"launches {launches}, {step.graph_count()} graphs")
    dl = {"img_s": TRAIN_BATCH * FED_STEPS / dt,
          "ms_step": 1e3 * dt / FED_STEPS}
    log(f"fed [fused resnet50_v1 bf16, batch {TRAIN_BATCH}, DataLoader("
        f"pin_memory=True) over host float32 images, cast on the card]: "
        f"{FED_STEPS} timed steps = {dl['ms_step']:.1f} ms/step = "
        f"{dl['img_s']:.1f} img/s; launches {launches}")
    del step, net, xs, loader
    gc.collect()
    torch.cuda.empty_cache()
    return rec, dl


def prefetch_streams(torch):
    """(e) Batches filled with their own index through
    ``DevicePrefetcher`` into a captured step that returns the batch's
    sum (copied into the graph's static input on the current stream, as
    ``TrainStep`` does), at depth 1 and 3, with a consumer that does not
    wait and one that sleeps: every step sees exactly its own index."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.graphs import GraphCache

    dev = torch.device(DEVICE)
    shape = STREAM_BATCH
    numel = int(np.prod(shape))
    static = torch.zeros(shape, device=dev)
    graphs = GraphCache(dev)

    def source():
        for i in range(STREAM_STEPS):
            yield (torch.full(shape, float(i)),)    # a host batch

    for depth in (1, 3):
        for sleep in (0.0, STREAM_SLEEP_S):
            seen = []
            with parallel.DevicePrefetcher(source(), depth=depth) as pf:
                for (x,) in pf:
                    static.copy_(x._data)
                    out = graphs.run("sum", lambda: static.double().sum())
                    seen.append(out.clone())
                    if sleep:
                        time.sleep(sleep)
                stats = dict(pf.stats)
            got = [float(v) / numel for v in seen]
            expect(got == [float(i) for i in range(STREAM_STEPS)],
                   f"prefetch streams (depth {depth}, sleep {sleep}): steps "
                   f"saw {got}")
            log(f"prefetch streams: depth {depth}, consumer sleep "
                f"{1e3 * sleep:.0f} ms: {STREAM_STEPS} batches of "
                f"{list(shape)} each seen whole by its captured step; waits "
                f"producer {stats['producer_wait_s']:.3f} s, consumer "
                f"{stats['consumer_wait_s']:.3f} s")


def nd_names(torch):
    """(f) The new ``nd.`` names on card NDArrays: ``nd.flash_attention``
    at BERT-base's shape, forward and ``backward()`` under ``record()``
    (one launch of each flash kernel, counted from 0; outputs and
    gradients held against the plain versions as in phase 11);
    ``nd.paged_decode_attention`` at the serving config (one launch, the
    same bits as ``ops.paged_decode_attention``, and within ATOL/RTOL of
    the plain version on the active slots); ``nd.image_resize``,
    ``image_to_tensor`` and ``image_normalize`` against the host."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import paged_decode_attention
    from mxnet_tpu_torch.ops.paged_attention import (
        paged_decode_attention as paged,
        paged_decode_attention_reference as paged_reference)

    fa = flash_module()
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    b, s, h, d = BERT_BATCH, BERT_SEQ, BERT_HEADS, BERT_HEAD_DIM
    q, k, v, do = (torch.randn(b, s, h * d, generator=gen, device=DEVICE)
                   .bfloat16() for _ in range(4))

    def run():
        args = [mx.nd.NDArray(t.clone()) for t in (q, k, v)]
        for a in args:
            a.attach_grad()
        with mx.autograd.record():
            out = mx.nd.flash_attention(*args, heads=h)
        out.backward(mx.nd.NDArray(do))
        return [out._data.detach()] + [a.grad._data for a in args]

    fa.flash_attention.launches = dict.fromkeys(FLASH, 0)
    got = run()
    torch.cuda.synchronize()
    flash = dict(fa.flash_attention.launches)
    expect(flash == dict.fromkeys(FLASH, 1),
           f"nd.flash_attention launched {flash}, expected one of each")
    with plain_versions(fa):
        want = run()
    expect(fa.flash_attention.launches == flash,
           "nd.flash_attention: the plain route launched kernels")
    what = f"nd.flash_attention ({b}, {s}, {h}x{d}) bf16"
    err = {nm: check_outputs(torch, what, nm, [g], [p])
           for nm, g, p in zip(("out", "dq", "dk", "dv"), got, want)}
    log(f"nd names [{what}]: launches {flash}; max abs err vs the plain "
        f"versions " + ", ".join(f"{n} {e:.3e}" for n, e in err.items()))

    rng = np.random.default_rng(6)
    ins = paged_inputs(torch, rng, SLOTS, 2, serving_lengths(rng, SLOTS))
    paged.launches = 0
    out = mx.nd.paged_decode_attention(*[mx.nd.NDArray(t) for t in ins])
    torch.cuda.synchronize()
    n_paged = paged.launches
    ref = paged_decode_attention(*ins)
    plain = paged_reference(*ins)
    paged.launches = n_paged              # the comparisons are not the path
    act = ins[-1] > 0
    err = (out._data[act] - plain[act]).abs()
    max_err = float(err.max())
    within = bool((err <= ATOL + RTOL * plain[act].abs()).all())
    expect(n_paged == 1 and torch.equal(out._data, ref) and within,
           f"nd.paged_decode_attention: {n_paged} launches, same bits "
           f"{torch.equal(out._data, ref)}, max abs err vs plain "
           f"{max_err:.3e}")
    log(f"nd names [nd.paged_decode_attention, {SLOTS} slots x 2 pages]: "
        f"1 launch, the same bits as ops.paged_decode_attention, max abs "
        f"err vs the plain version {max_err:.3e} on {int(act.sum())} "
        f"active slots (atol {ATOL}, rtol {RTOL})")

    img = np.random.RandomState(7).randint(0, 256, (2, 96, 80, 3)) \
        .astype(np.uint8)
    worst = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        with ctx:
            x = mx.nd.array(img, dtype="uint8")
            xf = mx.nd.array(img.astype(np.float32) / 255.0)
            res = {"resize u8 down": mx.nd.image_resize(x, size=(56, 48)),
                   "resize u8 up": mx.nd.image_resize(x, size=(120, 130)),
                   "resize f32 down": mx.nd.image_resize(xf, size=(56, 48)),
                   "resize keep_ratio": mx.nd.image_resize(
                       xf, size=64, keep_ratio=True),
                   "resize nearest": mx.nd.image_resize(x, size=(50, 70),
                                                        interp=0),
                   "to_tensor": mx.nd.image_to_tensor(x),
                   "normalize": mx.nd.image_normalize(
                       mx.nd.image_to_tensor(x), mean=(0.485, 0.456, 0.406),
                       std=(0.229, 0.224, 0.225))}
        for key, val in res.items():
            worst.setdefault(key, []).append(val.asnumpy())
    for key, (card, host) in worst.items():
        err = float(np.abs(card.astype(np.float64) - host).max())
        limit = 1.0 if card.dtype == np.uint8 else IMAGE_F32_ATOL
        expect(card.shape == host.shape and err <= limit,
               f"nd.{key}: card vs host max abs err {err} (limit {limit})")
        worst[key] = err
    log("nd names [image ops, card vs host]: max abs err "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f" (uint8 within 1, float32 within {IMAGE_F32_ATOL})")
    return {"flash": flash, "paged": n_paged}


def input_pipeline(torch, root):
    """The "input pipeline" phase, (a)-(f) above."""
    figures = {"natives": natives()}
    t0 = time.perf_counter()
    figures["mnist"] = mnist_example(torch, root)
    log(f"MNIST example: {time.perf_counter() - t0:.1f} s in all")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "records")
        recs = write_records(torch, path)
        figures["records"] = record_checks(torch, recs, path)
        del recs
        figures["fed"], figures["loader"] = fed_resnet(torch, path)
    prefetch_streams(torch)
    figures["nd"] = nd_names(torch)
    return figures


# ------------------------------------------------------------------ resume --
def resume_state(step):
    """Copies of every tensor a snapshot holds, and the step count."""
    from mxnet_tpu_torch.parallel import checkpoint as ck

    return [t.detach().clone() for _, t in ck._entries(step)] \
        + [step._t.clone()]


def resume_in_process(torch, tmp):
    """(a) The captured bf16 ResNet-50 step of ``elastic_worker``: 6
    steps, snapshots at 3 and 6, the step-3 snapshot loaded into the same
    captured step, 3 more steps: their losses and every tensor the bits
    of steps 4-6, no tensor the graph holds rebound.  Returns the step,
    its batch function and the figures."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import elastic_worker, gluon, parallel
    from mxnet_tpu_torch.ops.fused_conv import norm_relu_conv
    from mxnet_tpu_torch.parallel import checkpoint as ck

    device = torch.device(DEVICE)
    net, opt, size, shape, classes, dtype = \
        elastic_worker.NETS[RESUME_NET](mx, device)
    step = parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              opt)

    def batch(n):
        return elastic_worker.batch(torch, n, size, shape, classes, dtype,
                                    device)

    first, last = RESUME_SAVED
    norm_relu_conv.launches = dict.fromkeys(FUSED, 0)  # main path starts
    losses, paths = {}, {}
    for n in range(last):
        losses[n + 1] = float(step(*batch(n)))
        if step._num_update in RESUME_SAVED:
            paths[step._num_update] = os.path.join(
                tmp, f"ckpt-{step._num_update:08d}.npz")
            ck.save_train_step(step, paths[step._num_update])
    after = resume_state(step)
    held = [t.data_ptr() for _, t in ck._entries(step)] \
        + [step._t.data_ptr()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.load_train_step(step, paths[first])
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0)
    expect(step._num_update == first and int(step._t) == first,
           f"resume: the load left num_update {step._num_update}")
    again = {n + 1: float(step(*batch(n))) for n in range(first, last)}
    launches = dict(norm_relu_conv.launches)           # ... and ends here
    now = resume_state(step)
    same = all(torch.equal(a, b) for a, b in zip(after, now))
    expect([t.data_ptr() for _, t in ck._entries(step)]
           + [step._t.data_ptr()] == held,
           "resume: the load rebound a tensor the captured graph holds")
    expect(again == {n: losses[n] for n in again} and same,
           f"resume: the captured step after loading the step-{first} "
           f"snapshot gave losses {again} against {losses}; every tensor "
           f"{'the same bits' if same else 'NOT the same bits'}")
    ran = last + last - first
    expect(launches == dict.fromkeys(FUSED, FUSED_PER_STEP * ran)
           and step.graph_count() == (1 if DEVICE == "cuda" else 0),
           f"resume: launches {launches} over {ran} steps, "
           f"{step.graph_count()} graphs")
    nbytes = sum(t.numel() * t.element_size() for _, t in ck._entries(step))
    log(f"resume [in process, {RESUME_NET}, cuDNN deterministic]: losses "
        f"{losses}; the step-{first} snapshot loaded into the captured step "
        f"in {load_ms:.1f} ms, then steps {sorted(again)} replayed the same "
        f"bits (losses and {len(now)} tensors), none rebound; launches "
        f"{launches}")
    return step, batch, {"load_ms": load_ms, "launches": launches,
                         "bytes": nbytes}


def resume_stall(torch, step, batch, tmp):
    """(b) ``RESUME_TURNS`` steps in turns (plain, snapshot, snapshot,
    plain, ...), each synchronised, the writer drained before each turn:
    the step loop's stall per async snapshot (the host's ``save()`` and
    the copies the next replay waits for) against a plain step; the
    writer's serialize + fsync + commit ms a snapshot."""
    from mxnet_tpu_torch.parallel import checkpoint as ck

    writes = []
    real = ck._write_payload

    def timed(*a, **kw):
        t0 = time.perf_counter()
        total = real(*a, **kw)
        writes.append((time.perf_counter() - t0, total))
        return total

    snap = ck.AsyncSnapshotter()
    ck._write_payload = timed
    try:
        expect(snap.save(step, os.path.join(tmp, "warm.npz")),
               "resume: the first async snapshot was skipped")
        expect(snap.wait_until_finished(timeout=600), "resume: no drain")
        staging = snap._spare[0]         # the buffer every turn reuses
        pinned = (staging._handle._pinned.numel()
                  if staging._handle is not None else 0)
        del writes[:]
        times = {"plain": [], "snapshot": []}
        host = []
        for turn in range(RESUME_TURNS):
            kind = "snapshot" if turn % 4 in (1, 2) else "plain"
            expect(snap.wait_until_finished(timeout=600),
                   "resume: the writer did not drain")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(*batch(step._num_update))
            if kind == "snapshot":
                t1 = time.perf_counter()
                expect(snap.save(step, os.path.join(
                    tmp, f"turn-{turn:02d}.npz")),
                    "resume: an async snapshot was skipped")
                host.append(time.perf_counter() - t1)
            torch.cuda.synchronize()
            times[kind].append(time.perf_counter() - t0)
        expect(snap.wait_until_finished(timeout=600), "resume: no drain")
        errors = snap.errors
    finally:
        ck._write_payload = real
        snap.close(timeout=600)
    expect(not errors, f"resume: the async writer failed: {errors}")
    for name in sorted(os.listdir(tmp)):
        if name.startswith("turn-"):
            ck.verify_checkpoint(os.path.join(tmp, name))
    plain_ms = 1e3 * float(np.mean(times["plain"]))
    snap_ms = 1e3 * float(np.mean(times["snapshot"]))
    write_s = float(np.mean([w for w, _ in writes]))
    total = writes[0][1]
    fig = {"plain_ms": plain_ms, "snapshot_ms": snap_ms,
           "stall_ms": snap_ms - plain_ms,
           "host_ms": 1e3 * float(np.mean(host)),
           "write_ms": 1e3 * write_s, "write_mb_s": total / write_s / 1e6,
           "bytes": total, "writes": len(writes), "pinned": pinned}
    log(f"resume [async snapshots, {RESUME_TURNS} steps in turns]: step "
        f"{plain_ms:.1f} ms plain, {snap_ms:.1f} ms with a snapshot: stall "
        f"{fig['stall_ms']:.1f} ms a snapshot (save() itself "
        f"{fig['host_ms']:.2f} ms on the host); the writer's serialize + "
        f"fsync + commit {fig['write_ms']:.1f} ms = "
        f"{fig['write_mb_s']:.1f} MB/s over {len(writes)} writes of "
        f"{total} bytes; {pinned} bytes of pinned staging, reused")
    return fig


def worker_lines(path):
    """The ``[worker] {...}`` records of a supervised worker's log, one
    list per attempt."""
    attempts = []
    with open(path) as f:
        for line in f:
            i = line.find("[worker] ")
            if i < 0:
                continue
            rec = json.loads(line[i + len("[worker] "):])
            if "resumed_at" in rec:
                attempts.append([])
            attempts[-1].append(rec)
    return attempts


def resume_watch(hb, ckd, stop, acted):
    """SIGKILL attempt 0 once its heartbeat reads step >= RESUME_KILL[0]
    and a snapshot >= RESUME_KILL[1] is committed; SIGTERM attempt 1 at
    step >= RESUME_TERM (it snapshots and exits preempted)."""
    import signal

    from mxnet_tpu_torch import elastic

    while not stop.is_set() and len(acted) < 2:
        rec = elastic.read_heartbeats(hb).get(0)
        if rec is not None:
            at, done = rec["global_step"], \
                elastic.latest_committed_step(ckd) or 0
            if (rec["attempt"], len(acted)) == (0, 0) \
                    and at >= RESUME_KILL[0] and done >= RESUME_KILL[1]:
                os.kill(rec["pid"], signal.SIGKILL)
                acted.append(("SIGKILL", 0, at, done))
            elif (rec["attempt"], len(acted)) == (1, 1) \
                    and at >= RESUME_TERM:
                os.kill(rec["pid"], signal.SIGTERM)
                acted.append(("SIGTERM", 1, at, done))
        stop.wait(0.02)


def supervised(root, tmp, name, faults):
    """``elastic_worker`` under ``elastic.Supervisor(n=1, platform="gpu",
    devices_per_worker=1)`` to ``RESUME_TARGET``, with the watcher's
    signals when ``faults``.  Returns the run's records."""
    import threading

    from mxnet_tpu_torch import elastic

    d = os.path.join(tmp, name)
    ckd, hb, logd = (os.path.join(d, k) for k in ("ckpt", "hb", "logs"))
    ev = os.path.join(d, "events.jsonl")
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.elastic_worker",
           "--device", DEVICE, "--net", RESUME_NET, "--target-step",
           str(RESUME_TARGET), "--ckpt-dir", ckd, "--every",
           str(RESUME_EVERY)]
    if faults:
        cmd += ["--step-sleep", str(RESUME_STEP_SLEEP)]
    path = os.pathsep.join(filter(None, (root,
                                         os.environ.get("PYTHONPATH"))))
    sup = elastic.Supervisor(
        cmd, 1, platform="gpu", devices_per_worker=1, max_restarts=3,
        backoff_base=0.1, graceful_secs=120, heartbeat_dir=hb, log_dir=logd,
        event_log=ev, progress_dir=ckd, extra_env={"PYTHONPATH": path})
    stop, acted = threading.Event(), []
    watcher = threading.Thread(target=resume_watch,
                               args=(hb, ckd, stop, acted), daemon=True)
    if faults:
        watcher.start()
    timer = threading.Timer(RESUME_TIMEOUT_S, sup.request_stop)
    timer.start()
    try:
        rc = sup.run()
    finally:
        timer.cancel()
        stop.set()
        if faults:
            watcher.join(timeout=10)
    with open(ev) as f:
        events = [json.loads(x) for x in f]
    expect(rc == 0 and events[-1]["event"] == "done",
           f"resume [{name}]: the supervisor returned {rc}, last event "
           f"{events[-1]}")
    return {"events": events, "acted": acted, "ckpt": ckd,
            "attempts": worker_lines(os.path.join(logd, "r0.log"))}


def resume_supervised(torch, root, tmp, smi_line):
    """(c) The uninterrupted reference worker, then the same worker
    SIGKILLed (attempt 0) and SIGTERMed (attempt 1, exits preempted after
    its snapshot) under the supervisor: every step's loss and the final
    snapshot's digests the reference's bits, every retained snapshot
    verified, the event log in order."""
    from mxnet_tpu_torch.parallel import checkpoint as ck

    ref = supervised(root, tmp, "reference", False)
    ref_losses = {r["num_update"]: r["loss"]
                  for r in ref["attempts"][0] if "num_update" in r}
    expect(sorted(ref_losses) == list(range(1, RESUME_TARGET + 1)),
           f"resume: the reference printed steps {sorted(ref_losses)}")
    last = os.path.join(ref["ckpt"], f"ckpt-{RESUME_TARGET:08d}.npz")
    ref_digests = ck.verify_checkpoint(last)["digests"]

    run = supervised(root, tmp, "faults", True)
    kinds = [e["event"] for e in run["events"]]
    exits = [e["status"] for e in run["events"]
             if e["event"] == "worker-exit"]
    expect([a[0] for a in run["acted"]] == ["SIGKILL", "SIGTERM"]
           and exits == ["killed:SIGKILL", "preempted", "ok"]
           and [k for k in kinds if k in ("spawn", "worker-exit",
                                          "restart", "done")]
           == ["spawn", "worker-exit", "restart"] * 2
           + ["spawn", "worker-exit", "done"],
           f"resume: signals {run['acted']}, exits {exits}, events {kinds}")
    steps = [r for a in run["attempts"] for r in a if "num_update" in r]
    differ = [r for r in steps if r["loss"] != ref_losses[r["num_update"]]]
    expect(not differ and {r["num_update"] for r in steps}
           == set(ref_losses),
           f"resume: steps whose loss is not the reference's bits: "
           f"{differ}")
    retained = ck.list_checkpoints(run["ckpt"])
    for _, path in retained:
        ck.verify_checkpoint(path)
    digests = ck.verify_checkpoint(dict(retained)[RESUME_TARGET])["digests"]
    expect(digests == ref_digests, "resume: the final snapshot's digests "
           "differ from the uninterrupted reference's")
    spawns = [e["ts"] for e in ref["events"] if e["event"] == "spawn"] \
        + [e["ts"] for e in run["events"] if e["event"] == "spawn"]
    firsts = [next(r["wall"] for r in a if "num_update" in r)
              for a in ref["attempts"] + run["attempts"]]
    startup = [f - s for s, f in zip(spawns, firsts)]
    ends = [a[-1] for a in ref["attempts"] + run["attempts"]
            if "steps" in a[-1]]            # the SIGKILLed one has none
    expect(len(ends) == 3, f"resume: {len(ends)} workers reported their "
           f"launches, expected 3 (the reference, attempts 1 and 2)")
    replayed = []
    for e in ends:
        got = {k: e["launches"].get(f"fused_conv_{k}", 0) for k in FUSED}
        expect(got == dict.fromkeys(FUSED, FUSED_PER_STEP * e["steps"]),
               f"resume: a worker ran {e['steps']} steps and launched "
               f"{got}")
        replayed.append(FUSED_PER_STEP * (e["steps"] - 1))  # the first
    resumed = [a[0]["resumed_at"] for a in run["attempts"]]   # is eager
    log(f"resume [supervised, {RESUME_NET}, target {RESUME_TARGET}, every "
        f"{RESUME_EVERY}, keep 2]: reference rc 0; with faults "
        f"{run['acted']} (signal, attempt, heartbeat step, committed "
        f"step), exits {exits}, resumed at {resumed}; {len(steps)} steps "
        f"printed, every loss the reference's bits; the final snapshot's "
        f"{len(digests)} digests the reference's; {len(retained)} retained "
        f"snapshots verified; events {kinds}")
    log(f"resume [workers]: spawn to first step "
        f"{[round(s, 2) for s in startup]} s (reference, then attempts 0-2)"
        f"; fused-conv launches of each kernel under replay {replayed} "
        f"(the reference, attempts 1 and 2; {FUSED_PER_STEP} a step, the "
        f"first step of each attempt runs eagerly); {smi_line}")
    return {"startup_s": startup, "replayed": replayed, "exits": exits,
            "acted": run["acted"], "resumed": resumed}


def resume_phase(torch, root, smi_line):
    """Checkpoints and the runtime around training, cuDNN deterministic
    throughout: (a) in place in a captured step, (b) the async snapshot's
    stall, (c) the supervised kill and resume."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") \
                as tmp:
            step, batch, inproc = resume_in_process(torch, tmp)
            stall = resume_stall(torch, step, batch, tmp)
            del step, batch
            gc.collect()
            torch.cuda.empty_cache()
            sup = resume_supervised(torch, root, tmp, smi_line)
    finally:
        torch.backends.cudnn.deterministic = prev
    log(f"resume: snapshot {stall['bytes']} bytes ({inproc['bytes']} in "
        f"the step's tensors); stall {stall['stall_ms']:.1f} ms a snapshot "
        f"against a {stall['plain_ms']:.1f} ms step; writer "
        f"{stall['write_ms']:.1f} ms = {stall['write_mb_s']:.1f} MB/s; "
        f"load_train_step {inproc['load_ms']:.1f} ms; worker start-up "
        f"{[round(s, 2) for s in sup['startup_s']]} s; {smi_line}")
    return {**inproc, **{f"stall_{k}": v for k, v in stall.items()}, **sup}


# ------------------------------------------------------- LSTM LM and SSD --
def rel_err(got, want):
    """``max |got - want|`` over ``max |want|`` (a leaf's scale)."""
    g, w = got.double(), want.double()
    return float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))


def rnn_leaves(torch, fn, args, cts):
    """``fn(*args)``'s outputs and the gradients of ``sum(out * ct)``
    for every input: the leaves of an RNN check, as float32."""
    args = [a.detach().clone().requires_grad_(True) for a in args]
    outs = fn(*args)
    grads = torch.autograd.grad(outs, args, [c.to(o.dtype)
                                             for o, c in zip(outs, cts)])
    return [t.detach().float() for t in list(outs) + list(grads)]


def rnn_inputs(torch, mode, layers, gen):
    """The path's inputs (T 35, N 64, 650 -> 650): data, the packed
    parameter (uniform in +-1/sqrt(H), as torch initialises an RNN),
    the initial states and one cotangent per output."""
    from mxnet_tpu_torch.ops.rnn import rnn_param_size

    t, n, h = LSTM_BPTT, LSTM_BATCH, LSTM_UNITS
    size = rnn_param_size(mode, h, h, layers, False)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda")
    args = [randn(t, n, h), (torch.rand(size, generator=gen, device="cuda")
                             * 2 - 1) / h ** 0.5,
            randn(layers, n, h, scale=0.5)]
    if mode == "lstm":
        args.append(randn(layers, n, h, scale=0.5))
    cts = [randn(t, n, h)] + [randn(layers, n, h) for _ in args[2:]]
    return args, cts


RNN_LEAVES = ("out", "h_n", "c_n", "d data", "d param", "d h0", "d c0")


def rnn_vs_plain(torch, mode, layers, gen):
    """The ``RNN`` op at the path's shape against its plain per-step
    version (``rnn_reference``, the JAX cells step by step), every
    output and the gradient of every input: in f32 with TF32 off on
    both (within ``RNN_F32_TOL`` of each leaf's scale), with the TF32
    flag as it stands printed; in bf16 against the f32 op from the same
    bf16-rounded inputs, within ``RNN_BF16_FACTOR`` times the plain
    version's own bf16 error (its noise floor, raised to
    ``RNN_BF16_MIN_FLOOR``)."""
    from mxnet_tpu_torch.ops.rnn import RNN, rnn_reference

    kw = dict(state_size=LSTM_UNITS, num_layers=layers, mode=mode)
    names = RNN_LEAVES if mode == "lstm" else tuple(
        n for n in RNN_LEAVES if n not in ("c_n", "d c0"))
    args, cts = rnn_inputs(torch, mode, layers, gen)

    def op(*a):
        return RNN(*a, training=True, **kw)

    def plain(*a):
        return rnn_reference(*a, **kw)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        f32 = rnn_leaves(torch, op, args, cts)
    want = rnn_leaves(torch, plain, args, cts)
    tf32 = rnn_leaves(torch, op, args, cts)
    errs = {n: rel_err(g, w) for n, g, w in zip(names, f32, want)}
    what = f"{mode}, {layers} layer{'s' * (layers > 1)}"
    log(f"rnn [{what}, f32, T {LSTM_BPTT} N {LSTM_BATCH} {LSTM_UNITS} -> "
        f"{LSTM_UNITS}]: op vs its plain per-step version, max error / "
        f"leaf scale {({n: f'{e:.2e}' for n, e in errs.items()})}; with "
        f"cuDNN's TF32 flag as it stands "
        f"({torch.backends.cudnn.allow_tf32}: the port turns it off once "
        f"it resolves the card) "
        f"{({n: f'{rel_err(g, w):.2e}' for n, g, w in zip(names, tf32,
                                                          want)})}")
    for n, e in errs.items():
        tol = RNN_F32_TOL[0 if n in ("out", "h_n", "c_n") else 1]
        expect(e <= tol, f"rnn {what} f32: {n} off by {e:.2e} of its "
               f"scale (> {tol})")
    low = [a.to(torch.bfloat16) for a in args]
    ref = [a.float() for a in low]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = rnn_leaves(torch, op, ref, cts)
    got = rnn_leaves(torch, op, low, cts)
    floor = rnn_leaves(torch, plain, low, cts)
    report = {}
    for n, g, f, w in zip(names, got, floor, want):
        e, fl = rel_err(g, w), max(rel_err(f, w), RNN_BF16_MIN_FLOOR)
        report[n] = f"{e:.2e} (floor {fl:.2e})"
        expect(e <= RNN_BF16_FACTOR * fl, f"rnn {what} bf16: {n} off by "
               f"{e:.2e} of its scale, over {RNN_BF16_FACTOR} x the plain "
               f"version's {fl:.2e}")
    log(f"rnn [{what}, bf16]: op vs the f32 op, max error / leaf scale "
        f"(the plain per-step version's in bf16) {report}")
    return args, cts


def rnn_route(torch, mode, args, cts, dtype):
    """One forward and backward of the op under the profiler: the
    kernels that carry it, by name, and the device time of copies
    (cuDNN compacting the packed views into its flat buffer)."""
    from mxnet_tpu_torch.ops.rnn import RNN

    args = [a.to(dtype) for a in args]
    what = f"rnn route {mode}, {str(dtype)[6:]}, fwd + bwd"

    def run():
        return rnn_leaves(torch, lambda *a: RNN(
            *a, training=True, state_size=LSTM_UNITS,
            num_layers=LSTM_LAYERS, mode=mode), args, cts)
    run()
    prof, wall_us, _ = profiled(torch, run, what)
    print_profile(prof, wall_us, what)
    rows = device_rows(prof)
    copies = [e for e in rows if "copy" in e.key.lower()
              or "memcpy" in e.key.lower()]
    log(f"{what}: {sum(e.count for e in copies)} copy events, "
        f"{sum(device_us(e) for e in copies) / 1e3:.3f} ms of "
        f"{sum(device_us(e) for e in rows) / 1e3:.3f} ms device time; "
        f"kernels named cuDNN-RNN-like "
        f"{sorted({e.key[:60] for e in rows if 'rnn' in e.key.lower()})}")


def build_lm(torch):
    """``bench_lstm``'s net: ``rnn_lm`` at its width, random weights from
    a seed, cast to bf16."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.model_zoo.language_model import rnn_lm

    mxrandom.seed(0)
    net = rnn_lm(vocab_size=LSTM_VOCAB, embed_size=LSTM_UNITS,
                 hidden_size=LSTM_UNITS, num_layers=LSTM_LAYERS,
                 dropout=LSTM_DROPOUT)
    net.initialize(ctx=DEVICE)
    net.cast("bfloat16")
    return net


def lm_batch(torch):
    rng = np.random.RandomState(0)
    return tuple(torch.from_numpy(rng.randint(
        0, LSTM_VOCAB, (LSTM_BPTT, LSTM_BATCH)).astype(np.int32)).to(DEVICE)
        for _ in range(2))


def lm_loss_fn(f32=False):
    """``bench_lstm``'s loss; with ``f32`` the logits cast first: on
    random ids the bf16 loss reads 9.1875 (ln 10000 = 9.21) whatever the
    dropout masks or the parameters, so only the f32 loss can tell two
    runs apart."""
    from mxnet_tpu_torch import gluon

    ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def loss_fn(out, label):
        out = out.float() if f32 else out
        return ce(out.reshape((-1, LSTM_VOCAB)), label.reshape((-1,)))
    return loss_fn


def timed_run(torch, step, batch, warmup, steps, what, unit, per_step):
    """``warmup`` then ``steps`` timed calls of ``step(*batch)``: losses,
    ms/step, rate (``per_step`` units a step) and peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(*batch)) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step(*batch) for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses += [float(v) for v in timed]
    peak = torch.cuda.max_memory_allocated()
    expect(all(np.isfinite(losses)), f"{what}: loss not finite {losses}")
    expect(all(bool(torch.isfinite(t).all()) for t in step._train),
           f"{what}: a parameter is not finite")
    rate = per_step * steps / dt
    log(f"train [{what}]: losses {[round(v, 4) for v in losses]}; {steps} "
        f"timed steps in {dt:.3f} s = {1e3 * dt / steps:.2f} ms/step = "
        f"{rate:.1f} {unit}; peak device memory {peak / 2**30:.2f} GiB; "
        f"graphs {step.graph_count()}")
    return {"ms_step": 1e3 * dt / steps, "rate": rate, "losses": losses,
            "peak": peak}


def tensors_gap(got, want):
    """Largest ``|got - want|`` over ``want``'s largest magnitude, over
    two lists of tensors."""
    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(got, want))


def train_in_turns(torch, make_step, batch, warmup, steps, what, unit,
                   per_step, may_stay=None):
    """The captured step and the eager one (``capture=False``), each from
    the net's parameters and the random stream's seed 0, in turns
    (captured, eager, eager, captured); a profiled step of each.  Every
    trainable tensor must have moved from the net's value, but those
    whose names match the pattern ``may_stay``.  Where the two eager
    runs end on the same bits, the first captured run must end on the
    first eager run's parameters and losses, bit for bit; where they do
    not (a kernel that is not deterministic), its parameters must lie
    within ``RUN_GAP_FACTOR`` times the eager runs' own gap and its
    losses are held by ``track_losses``.  Returns the runs and the busy
    shares."""
    from mxnet_tpu_torch import random as mxrandom

    runs, busy = {"captured": [], "eager": []}, {}
    ends = {"captured": [], "eager": []}
    for kind in ("captured", "eager", "eager", "captured"):
        mxrandom.seed(0)
        step = make_step(None if kind == "captured" else False)
        runs[kind].append(timed_run(torch, step, batch, warmup, steps,
                                    f"{what}, {kind}", unit, per_step))
        expect(step.graph_count() == (1 if kind == "captured" else 0),
               f"{what} {kind}: {step.graph_count()} graphs")
        ends[kind].append([t.detach().clone() for t in step._train])
        if kind == "captured":
            start = [step._plist[i].tensor() for i in step._train_idx]
            still = [step._names[i] for i, t, s in zip(
                step._train_idx, step._train, start) if torch.equal(t, s)]
            stuck = [n for n in still
                     if may_stay is None or not re.search(may_stay, n)]
            expect(not stuck, f"{what}: {len(stuck)} of {len(start)} "
                   f"parameters never moved ({stuck[:4]})")
        if kind not in busy:
            busy[kind] = profile_step(torch, step, batch,
                                      f"train step ({what}, {kind})")
        del step
        gc.collect()
        torch.cuda.empty_cache()
    cap, eag = runs["captured"][0], runs["eager"][0]
    same = cap["losses"] == eag["losses"]
    eager_gap = tensors_gap(ends["eager"][1], ends["eager"][0])
    gap = tensors_gap(ends["captured"][0], ends["eager"][0])
    rest = f" (the rest match {may_stay!r})" if still else ""
    log(f"train: {what}: after {warmup + steps} steps "
        f"{len(start) - len(still)} of {len(start)} parameters moved{rest};"
        f" the parameters' gap (max error / tensor scale) captured vs eager"
        f" {gap:.3e}, eager vs eager {eager_gap:.3e}; losses captured vs "
        f"eager {'the same bits' if same else 'differ'}")
    if eager_gap == 0:
        expect(gap == 0 and same, f"{what}: the eager runs repeat bit for "
               f"bit but the captured run ends elsewhere (parameters "
               f"{gap:.3e} apart, losses {'equal' if same else 'differ'})")
    else:
        expect(gap <= RUN_GAP_FACTOR * eager_gap, f"{what}: captured vs "
               f"eager parameters {gap:.3e} apart, over {RUN_GAP_FACTOR} x "
               f"the eager runs' own {eager_gap:.3e}")
        if not same:
            track_losses(cap["losses"], eag["losses"],
                         f"captured vs eager {what}")
    del ends
    ms = {k: [round(r["ms_step"], 3) for r in v] for k, v in runs.items()}
    log(f"train: {what} captured {ms['captured']} ms/step (busy "
        f"{100 * busy['captured']:.1f}%) vs eager {ms['eager']} ms/step "
        f"(busy {100 * busy['eager']:.1f}%), in turns = "
        f"{np.mean(ms['eager']) / np.mean(ms['captured']):.3f}x")
    return runs, busy


def lm_dropout_replays(torch, net, batch, calls=4):
    """A captured ``bench_lstm`` step at learning rate 0 (the parameters
    never change): the first call eager, then replays, each drawing new
    dropout masks (embedding, between the LSTM layers, output) from the
    generator the graph registered, so the replays' losses all
    differ."""
    from mxnet_tpu_torch import optimizer, parallel

    step = parallel.TrainStep(net, lm_loss_fn(f32=True), optimizer.create(
        "sgd", learning_rate=0.0))
    losses = [float(step(*batch)) for _ in range(calls)]
    log(f"dropout under replay [rnn_lm 2x{LSTM_UNITS}, lr 0, f32 loss]: "
        f"losses {losses} (the first eager, then {calls - 1} replays)")
    expect(step.graph_count() == 1, "the lr-0 step holds no graph")
    expect(len(set(losses[1:])) == calls - 1,
           "replays repeated their dropout masks")


def lm_example(torch, root):
    """``examples/word_language_model.py``'s ``main()`` as written (the
    eager imperative path: autograd, gluon.Trainer, clip_global_norm) on
    the synthetic corpus: its perplexity must be finite."""
    text = run_example(root, "word_language_model", LM_EXAMPLE_ARGS)
    ppl = [float(m) for m in re.findall(r"ppl=([0-9.]+|inf|nan)", text)]
    expect(len(ppl) == 1 and np.isfinite(ppl[0]),
           f"word_language_model: perplexity {ppl}")
    return ppl[0]


def lstm_phase(torch, root):
    """The LSTM language model (BASELINE config 3): (a) the RNN op at the
    path's shape against its plain version (LSTM, 2 layers; GRU, 1
    layer), (b) the route each dtype takes, (c) ``bench_lstm``'s step
    captured against eager, (d) dropout under replay, (e) the
    example."""
    from mxnet_tpu_torch import optimizer, parallel

    gen = torch.Generator(device="cuda").manual_seed(7)
    args, cts = rnn_vs_plain(torch, "lstm", LSTM_LAYERS, gen)
    rnn_vs_plain(torch, "gru", 1, gen)
    for dtype in (torch.float32, torch.bfloat16):
        rnn_route(torch, "lstm", args, cts, dtype)
    del args, cts
    net = build_lm(torch)
    batch = lm_batch(torch)

    def make_step(capture):
        return parallel.TrainStep(net, lm_loss_fn(f32=True), optimizer.create(
            "sgd", learning_rate=20.0 / LSTM_BATCH), capture=capture)
    runs, busy = train_in_turns(
        torch, make_step, batch, LSTM_WARMUP, LSTM_TIMED,
        f"rnn_lm 2x{LSTM_UNITS}, bf16, batch {LSTM_BATCH} x {LSTM_BPTT}",
        "tokens/s", LSTM_BATCH * LSTM_BPTT)
    lm_dropout_replays(torch, net, batch)
    del net, batch
    gc.collect()
    torch.cuda.empty_cache()
    ppl = lm_example(torch, root)
    cap = runs["captured"][0]
    log(f"lstm: bench_lstm's step captured {cap['ms_step']:.2f} ms/step = "
        f"{cap['rate']:.1f} tokens/s (busy {100 * busy['captured']:.1f}%, "
        f"peak {cap['peak'] / 2**30:.2f} GiB); the example's perplexity "
        f"after one epoch {ppl:.1f}")


def ssd_anchor_inputs(torch, device):
    """Anchors of ``ssd_512_resnet50_v1``'s seven feature maps (16 ... 1
    at a 512 input) made on ``device``."""
    from mxnet_tpu_torch.gluon.model_zoo.ssd import _RATIOS, _SIZES
    from mxnet_tpu_torch.ops import MultiBoxPrior

    sides = [SSD_SIZE // 32 >> i if SSD_SIZE // 32 >> i else 1
             for i in range(len(_SIZES))]
    return torch.cat([MultiBoxPrior(torch.zeros(1, 1, s, s, device=device),
                                    sizes=sz, ratios=r, clip=True)
                      for s, sz, r in zip(sides, _SIZES, _RATIOS)], dim=1)


def claimed_labels(torch, rng, anchor):
    """bench_ssd's labels where every other image's rows 1 and 2 claim
    row 0's best anchor: row 1 the same box and class, row 2 another
    class and a box 0.001 smaller (JAX's scatter keeps the last row;
    ``index_put_`` with repeated indices is undefined on the card), and
    every fourth image's rows from 2 on padding.  Returns the labels and
    the ``(image, anchor)`` pairs claimed three times."""
    from mxnet_tpu_torch.bench import ssd_labels
    from mxnet_tpu_torch.ops.multibox import box_iou_matrix

    label = ssd_labels(rng, SSD_BATCH)
    label[1::4, 2:] = -1.0
    label[::2, 1] = label[::2, 0]
    label[::2, 2] = label[::2, 0] + np.array(
        [0, 0, 0, -0.001, -0.001], np.float32)
    label[::2, 2, 0] = (label[::2, 0, 0] + 1) % SSD_CLASSES
    claimed = []
    for i in range(0, SSD_BATCH, 2):
        iou = box_iou_matrix(anchor[0], torch.from_numpy(label[i, :3, 1:5]))
        best = [int(b) for b in iou.argmax(dim=0)]
        expect(len(set(best)) == 1 and best[0] > 0, f"claimed_labels: "
               f"image {i}'s rows 0-2 have best anchors {best}")
        claimed.append((i, best[0]))
    return label, claimed


def multibox_card_vs_host(torch):
    """``MultiBoxPrior``, ``MultiBoxTarget`` and ``MultiBoxDetection`` on
    the card against the same calls on the host at the path's anchor
    count: bench_ssd's labels with three rows claiming one anchor
    (``claimed_labels``) behind padding rows, an f32 ``cls_pred``
    rounded to halves (tied scores); the targets' class and mask equal,
    the claimed anchors holding the last row's class on both, the box
    targets and the detections within ``MULTIBOX_ATOL``."""
    from mxnet_tpu_torch.ops import MultiBoxDetection, MultiBoxTarget

    anchor = ssd_anchor_inputs(torch, "cuda")
    host_anchor = ssd_anchor_inputs(torch, "cpu")
    expect(torch.allclose(anchor.cpu(), host_anchor, rtol=0,
                          atol=MULTIBOX_ATOL), "MultiBoxPrior: card vs host")
    a = anchor.shape[1]
    rng = np.random.RandomState(3)
    label, claimed = claimed_labels(torch, rng, host_anchor)
    cls = np.round(rng.randn(SSD_BATCH, SSD_CLASSES + 1, a) * 2) / 2
    cls = torch.from_numpy(cls.astype(np.float32))
    label = torch.from_numpy(label)
    kw = dict(overlap_threshold=0.5, negative_mining_ratio=3.0,
              negative_mining_thresh=0.5)
    card = [t.cpu() for t in MultiBoxTarget(anchor, label.cuda(),
                                            cls.cuda(), **kw)]
    host = MultiBoxTarget(host_anchor, label, cls, **kw)
    expect(torch.equal(card[2], host[2]) and torch.equal(card[1], host[1]),
           "MultiBoxTarget: class targets or masks differ card vs host")
    for i, b in claimed:
        want = label[i, 2, 0] + 1
        expect(card[2][i, b] == want and host[2][i, b] == want,
               f"MultiBoxTarget: image {i}'s anchor {b}, claimed by rows 0-2,"
               f" holds class {float(card[2][i, b])} on the card and "
               f"{float(host[2][i, b])} on the host, not the last row's "
               f"{want}")
    bt_err = float((card[0] - host[0]).abs().max())
    expect(bt_err <= MULTIBOX_ATOL, f"MultiBoxTarget: box targets off by "
           f"{bt_err}")
    prob = torch.softmax(cls, dim=1)
    loc = torch.from_numpy((rng.randn(SSD_BATCH, a * 4) * 0.5)
                           .astype(np.float32))
    det_card = MultiBoxDetection(prob.cuda(), loc.cuda(), anchor,
                                 nms_topk=400).cpu()
    det_host = MultiBoxDetection(prob, loc, host_anchor, nms_topk=400)
    det_err = float((det_card - det_host).abs().max())
    expect(det_err <= MULTIBOX_ATOL, f"MultiBoxDetection: off by {det_err}")
    log(f"multibox [{a} anchors, batch {SSD_BATCH}, {SSD_CLASSES + 1} "
        f"classes]: card vs host: MultiBoxTarget classes and masks equal, "
        f"{len(claimed)} anchors claimed by three rows each holding the "
        f"last row's class "
        f"({int((host[2] > 0).sum())} positives, {int((host[2] == -1).sum())}"
        f" ignored), box targets off by {bt_err:.2e}; MultiBoxDetection "
        f"off by {det_err:.2e} ({int((det_host[..., 0] >= 0).sum())} "
        f"detections kept)")
    return a


def build_ssd(torch):
    """``bench_ssd``'s net: ``ssd_512_resnet50_v1(classes=20)``, random
    weights from a seed, cast to bf16."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.model_zoo.ssd import ssd_512_resnet50_v1

    mxrandom.seed(0)
    net = ssd_512_resnet50_v1(classes=SSD_CLASSES)
    net.initialize(ctx=DEVICE)
    net.cast("bfloat16")
    return net


def ssd_batch(torch):
    from mxnet_tpu_torch.bench import ssd_labels

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(SSD_BATCH, 3, SSD_SIZE, SSD_SIZE)
                         .astype(np.float32)).to(torch.bfloat16)
    return x.to(DEVICE), torch.from_numpy(ssd_labels(rng, SSD_BATCH)).to(
        DEVICE)


def ssd_detect(torch, net, x):
    """One ``detect()`` of the net's outputs on the card against the same
    call on the host (the outputs in f32 on both)."""
    from mxnet_tpu_torch import autograd

    with autograd.predict_mode():
        outs = [o.float() for o in net(x)]
    det = net.detect(*outs).cpu()
    host = net.detect(*[o.cpu() for o in outs])
    err = float((det - host).abs().max())
    expect(det.shape == (SSD_BATCH, outs[2].shape[1], 6) and
           bool(torch.isfinite(det).all()), f"detect: shape {det.shape}")
    expect(err <= MULTIBOX_ATOL, f"detect: card vs host off by {err}")
    log(f"detect [ssd_512_resnet50_v1, batch {SSD_BATCH}]: card vs host "
        f"off by {err:.2e}; {int((host[..., 0] >= 0).sum())} detections "
        f"kept")


def ssd_phase(torch):
    """SSD-512 (BASELINE config 5): (a) the multibox ops card vs host,
    (b) ``bench_ssd``'s step captured against eager, (c) one
    ``detect()`` card vs host."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.bench import ssd_loss_fn

    anchors = multibox_card_vs_host(torch)
    net = build_ssd(torch)
    batch = ssd_batch(torch)

    def make_step(capture):
        return parallel.TrainStep(net, ssd_loss_fn(), optimizer.create(
            "sgd", learning_rate=1e-3, momentum=0.9, wd=5e-4),
            capture=capture)
    runs, busy = train_in_turns(
        torch, make_step, batch, SSD_WARMUP, SSD_TIMED,
        f"ssd_512_resnet50_v1, bf16, batch {SSD_BATCH} x 3 x {SSD_SIZE}"
        f"^2, {anchors} anchors", "img/s", SSD_BATCH,
        may_stay=SSD_MAY_STAY)
    ssd_detect(torch, net, batch[0])
    cap = runs["captured"][0]
    log(f"ssd: bench_ssd's step captured {cap['ms_step']:.2f} ms/step = "
        f"{cap['rate']:.1f} img/s (busy {100 * busy['captured']:.1f}%, peak "
        f"{cap['peak'] / 2**30:.2f} GiB)")



# ---------------------------------------------------------------- symbolic --
def sym_resnet50(S):
    """``resnet50_v1`` (``ResNetV1`` of ``BottleneckV1``, layers [3, 4,
    6, 3], channels [64, 256, 512, 1024, 2048], 1000 classes, NCHW) built
    from ``mx.sym`` layers, layer for layer as the Gluon net: the 7x7/2
    stem, BatchNorm (scale learned, eps 1e-5, momentum 0.9), ReLU, 3x3/2
    max pool; each bottleneck's 1x1 (stride here) -> 3x3 -> 1x1 with a
    BatchNorm after each, a 1x1 + BatchNorm downsample on a stage's first
    unit, ReLU after the sum; global average pool, flatten, the 1000-way
    FullyConnected, and ``SoftmaxOutput`` with the batch-mean loss of
    ``SoftmaxCrossEntropyLoss``."""
    def bn(x, name):
        return S.BatchNorm(x, name=name, fix_gamma=False, eps=1e-5,
                           momentum=0.9)

    def conv(x, name, ch, k, stride):
        return S.Convolution(x, name=name, num_filter=ch, kernel=(k, k),
                             stride=(stride, stride),
                             pad=(k // 2, k // 2), no_bias=True)

    x = conv(S.Variable("data"), "conv0", 64, 7, 2)
    x = S.Activation(bn(x, "bn0"), act_type="relu", name="relu0")
    x = S.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                  pool_type="max", name="pool0")
    for stage, (blocks, _, _, ch) in enumerate(RESNET50_STAGES, 1):
        for unit in range(blocks):
            p = f"stage{stage}_unit{unit}_"
            stride = 2 if stage > 1 and unit == 0 else 1
            y = S.Activation(bn(conv(x, p + "conv1", ch // 4, 1, stride),
                                p + "bn1"), act_type="relu")
            y = S.Activation(bn(conv(y, p + "conv2", ch // 4, 3, 1),
                                p + "bn2"), act_type="relu")
            y = bn(conv(y, p + "conv3", ch, 1, 1), p + "bn3")
            r = bn(conv(x, p + "down", ch, 1, stride), p + "down_bn") \
                if unit == 0 else x
            x = S.Activation(y + r, act_type="relu", name=p + "relu")
    x = S.Pooling(x, kernel=(7, 7), global_pool=True, pool_type="avg",
                  name="pool1")
    x = S.FullyConnected(S.Flatten(x), num_hidden=1000, name="fc")
    return S.SoftmaxOutput(x, name="softmax", normalization="batch")


def sym_data(torch, mx):
    """(SYM_WARMUP + SYM_TIMED) batches of SYM_BATCH images 3x224x224 and
    labels of 1000 classes from RandomState(0), in an NDArrayIter on the
    card."""
    rng = np.random.RandomState(0)
    n = SYM_BATCH * (SYM_WARMUP + SYM_TIMED)
    x = rng.rand(n, 3, 224, 224).astype(np.float32)
    y = rng.randint(0, 1000, (n,)).astype(np.float32)
    return mx.io.NDArrayIter(x, y, batch_size=SYM_BATCH)


def sym_fit(torch, mx, symbol, it, start, capture, what):
    """One epoch of ``Module.fit`` from the parameters ``start``: the
    warm-up batches, then SYM_TIMED timed ones (the clock read at batch
    ends, the card synchronised).  Returns the numbers, the module and
    every parameter and running statistic after the run."""
    mx.random.seed(0)
    mod = mx.mod.Module(symbol, context=mx.gpu(0), capture=capture)
    clock = {}

    def at_batch_end(p):
        if p.nbatch in (SYM_WARMUP - 1, SYM_WARMUP + SYM_TIMED - 1):
            torch.cuda.synchronize()
            clock[p.nbatch] = time.perf_counter()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mod.fit(it, optimizer="sgd", optimizer_params=SYM_SGD,
            arg_params=start[0], aux_params=start[1], eval_metric="acc",
            num_epoch=1, batch_end_callback=at_batch_end)
    dt = clock[SYM_WARMUP + SYM_TIMED - 1] - clock[SYM_WARMUP - 1]
    peak = torch.cuda.max_memory_allocated()
    ex = mod._exec
    ends = {n: a._data.detach().clone() for d in (ex.arg_dict, ex.aux_dict)
            for n, a in d.items() if n not in ("data", "softmax_label")}
    expect(all(bool(torch.isfinite(t).all()) for t in ends.values()),
           f"{what}: a parameter is not finite")
    graphs = ex.graph_count()
    expect(graphs == (0 if capture is False else 1),
           f"{what}: the executor holds {graphs} graphs")
    res = {"ms_step": 1e3 * dt / SYM_TIMED,
           "img_s": SYM_BATCH * SYM_TIMED / dt, "peak": peak,
           "graphs": graphs}
    log(f"symbolic [{what}]: {SYM_TIMED} timed steps in {dt:.3f} s = "
        f"{res['ms_step']:.2f} ms/step = {res['img_s']:.1f} img/s; peak "
        f"device memory {peak / 2**30:.2f} GiB; executor graphs {graphs}")
    return res, mod, ends


def sym_turn(torch, mx, symbol, it, start, capture, what, profile):
    """One run of ``sym_fit``, then (``profile``) one more step and a
    profiled one.  The module dies with the call, so the next run has
    the card's memory.  Returns the numbers (with the busy share, or
    None) and the parameters after the run."""
    res, mod, end = sym_fit(torch, mx, symbol, it, start, capture, what)
    res["busy"] = None
    if profile:
        it.reset()
        batch = it.next()

        def one_step():
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        one_step()
        prof, wall_us, _ = profiled(torch, one_step, what)
        res["busy"] = print_profile(prof, wall_us, f"{what}, one step")
    return res, end


def sym_resnet(torch, smi_line):
    """(a) The symbolic ResNet-50 through ``Module.fit`` on the card: its
    weight count against ``resnet50_v1()``'s and ``infer_shape``'s host
    time; captured and eager runs in turns (captured, eager, eager,
    captured) from the same parameters under cuDNN's deterministic
    algorithms, held as ``train_in_turns`` holds them (every parameter
    moved; the first captured run the first eager run's bits where the
    eager runs repeat their bits, else within RUN_GAP_FACTOR of their
    gap); then, with cuDNN's default algorithms, a captured run with a
    profiled step, and ``resnet50_v1()`` through ``parallel.TrainStep``
    (unfused, NCHW, f32, SGD_KW, the same batch): img/s of both and
    their ratio."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, initializer, optimizer, parallel
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    symbol = sym_resnet50(mx.sym)
    shape = (SYM_BATCH, 3, 224, 224)
    infer_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        args, _, aux = symbol.infer_shape(data=shape)
        infer_s.append(time.perf_counter() - t0)
    names = symbol.list_arguments()
    n_sym = sum(int(np.prod(s)) for n, s in zip(names, args)
                if n not in ("data", "softmax_label"))
    log(f"symbolic ResNet-50: {len(names) - 2} parameters, "
        f"{len(symbol.list_auxiliary_states())} running statistics, "
        f"{n_sym} weights; infer_shape (one meta walk, "
        f"{sum(1 for n in symbol._topo_nodes() if n.op)} nodes) took "
        f"{infer_s[0]:.3f} s on the host, {infer_s[1]:.3f} s called again")

    initializer.seed(0)
    m0 = mx.mod.Module(symbol, context=mx.gpu(0))
    m0.bind([("data", shape)], [("softmax_label", (SYM_BATCH,))],
            for_training=False)
    m0.init_params(initializer=mx.init.Xavier(rnd_type="gaussian",
                                              factor_type="in",
                                              magnitude=2))
    start = m0.get_params()
    del m0
    it = sym_data(torch, mx)
    runs, ends = {"captured": [], "eager": []}, {"captured": [], "eager": []}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        for kind in ("captured", "eager", "eager", "captured"):
            res, end = sym_turn(torch, mx, symbol, it, start,
                                None if kind == "captured" else False,
                                f"symbolic ResNet-50, {kind}, cuDNN "
                                f"deterministic", not runs[kind])
            runs[kind].append(res)
            ends[kind].append(end)
            gc.collect()
            torch.cuda.empty_cache()
    first = {n: a._data for d in start for n, a in d.items()}
    stuck = [n for n, t in ends["captured"][0].items()
             if n in start[0] and torch.equal(t, first[n])]
    expect(not stuck, f"symbolic ResNet-50: {len(stuck)} parameters never "
           f"moved ({stuck[:4]})")
    keys = sorted(ends["eager"][0])
    listed = {k: [[e[n] for n in keys] for e in v] for k, v in ends.items()}
    eager_gap = tensors_gap(listed["eager"][1], listed["eager"][0])
    gap = tensors_gap(listed["captured"][0], listed["eager"][0])
    log(f"symbolic ResNet-50 (cuDNN deterministic): after "
        f"{SYM_WARMUP + SYM_TIMED} steps {len(start[0]) - len(stuck)} of "
        f"{len(start[0])} parameters moved; gap (max error / tensor scale) "
        f"over {len(keys)} parameters and running statistics: captured vs "
        f"eager {gap:.3e}, eager vs eager {eager_gap:.3e}")
    if eager_gap == 0:
        expect(gap == 0, f"symbolic ResNet-50: the eager runs repeat bit "
               f"for bit but the captured run ends {gap:.3e} away")
    else:
        expect(gap <= RUN_GAP_FACTOR * eager_gap, f"symbolic ResNet-50: "
               f"captured vs eager {gap:.3e} apart, over {RUN_GAP_FACTOR} "
               f"x the eager runs' own {eager_gap:.3e}")
    del ends, listed
    gc.collect()
    default, _ = sym_turn(torch, mx, symbol, it, start, None,
                          "symbolic ResNet-50, captured", True)
    del start, it
    gc.collect()
    torch.cuda.empty_cache()

    initializer.seed(0)
    net = resnet50_v1()
    net.initialize(ctx=DEVICE)
    with mx.autograd.pause():
        net(torch.zeros((1, 3, 224, 224), device=DEVICE))
    n_net = sum(p.tensor().numel() for p in net.collect_params().values()
                if p.grad_req != "null")
    expect(n_net == n_sym, f"symbolic ResNet-50 has {n_sym} weights, "
           f"resnet50_v1() {n_net}")
    step = parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              optimizer.create("sgd", **SGD_KW))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(DEVICE)
    y = torch.from_numpy(rng.randint(0, 1000, (SYM_BATCH,))
                         .astype(np.int32)).to(DEVICE)
    ts = timed_run(torch, step, (x, y), SYM_WARMUP, SYM_TIMED,
                   "resnet50_v1 TrainStep, NCHW f32 unfused", "img/s",
                   SYM_BATCH)
    ts["busy"] = profile_step(torch, step, (x, y), "train step (resnet50_v1"
                              f" NCHW f32, batch {SYM_BATCH}, TrainStep)")
    del step, net
    gc.collect()
    torch.cuda.empty_cache()
    det = {k: [round(r["ms_step"], 2) for r in v] for k, v in runs.items()}
    log(f"symbolic: Module.fit ResNet-50 (NCHW f32, batch {SYM_BATCH}) "
        f"captured {default['ms_step']:.2f} ms/step = "
        f"{default['img_s']:.1f} img/s (busy {100 * default['busy']:.1f}%, "
        f"peak {default['peak'] / 2**30:.2f} GiB, {default['graphs']} "
        f"executor graph); TrainStep {ts['ms_step']:.2f} ms/step = "
        f"{ts['rate']:.1f} img/s (busy {100 * ts['busy']:.1f}%, peak "
        f"{ts['peak'] / 2**30:.2f} GiB); Module / TrainStep = "
        f"{default['img_s'] / ts['rate']:.3f}x; under cuDNN's "
        f"deterministic algorithms captured {det['captured']} ms/step "
        f"(busy {100 * runs['captured'][0]['busy']:.1f}%), eager "
        f"{det['eager']} ms/step (busy "
        f"{100 * runs['eager'][0]['busy']:.1f}%); infer_shape "
        f"{infer_s[0]:.3f} s (again {infer_s[1]:.3f} s); {n_sym} weights "
        f"in both; card {smi_line}")
    return {"module": default, "turns": runs, "train_step": ts,
            "infer_s": infer_s}


def sym_kernel_calls(torch, symbol, vals, req, out_grad, calls, capture):
    """``calls`` training forwards and ``backward(out_grad)`` through
    ``Symbol.bind`` on the card.  Returns the last call's output and
    gradients, each call's kernel launches and the executor."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import graphs

    ex = symbol.bind(ctx=mx.gpu(0), args={k: mx.nd.NDArray(v.clone())
                                          for k, v in vals.items()},
                     grad_req=req, capture=capture)
    per_call = []
    for _ in range(calls):
        torch.cuda.synchronize()
        before = graphs.launch_counts()
        out = ex.forward(is_train=True)[0]
        ex.backward([mx.nd.NDArray(out_grad)])
        torch.cuda.synchronize()
        after = graphs.launch_counts()
        per_call.append({k: after[k] - before[k] for k in after
                         if after[k] != before[k]})
    got = [out._data] + [ex.grad_dict[k]._data.clone()
                         for k in sorted(req) if req[k] != "null"]
    return got, per_call, ex


def sym_kernels(torch):
    """(b) The hand-written kernels reached through ``mx.sym``: a
    ``FusedNormReluConv`` node (data, weight, gamma, beta and the moving
    statistics as variables, output 0) at ResNet-50's first fused shape,
    and a ``flash_attention`` node at BERT-base's (12 heads x 64,
    sequence 128), data in bf16, bound by ``Symbol.bind`` with
    ``grad_req="write"``: SYM_CALLS training forwards with
    ``backward(out_grads)``, the first eager, then a captured pair
    replayed; every call launches each kernel of the op once (counted
    through the graphs' replay counters) and the last call's output and
    gradients are held against the same symbol bound on the card under
    ``plain_versions`` (phase 7's and 11's tolerances).  Returns the
    launches of each kernel over the calls, by kernel name."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import fused_conv as fc

    fa = flash_module()
    gen = torch.Generator(device=DEVICE).manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    label, _, hw, ci, co, k = next(iter(path_shapes()))
    n = IMPERATIVE_FUSED[0]
    names = ("data", "weight", "gamma", "beta", "moving_mean", "moving_var")
    fused_vals = {
        "data": randn(n, hw, hw, ci).bfloat16(),
        "weight": (randn(k, k, ci, co) * (2.0 / (k * k * ci)) ** 0.5)
        .bfloat16(),
        "gamma": torch.rand(ci, generator=gen, device=DEVICE) + 0.5,
        "beta": 0.1 * randn(ci), "moving_mean": 0.1 * randn(ci),
        "moving_var": torch.rand(ci, generator=gen, device=DEVICE) + 0.5}
    fused_sym = mx.sym.FusedNormReluConv(
        *[mx.sym.Variable(v) for v in names], stride=1, name="nrc")[0]
    fused_req = {v: "null" if v.startswith("moving") else "write"
                 for v in names}
    b, s, h, d = BERT_BATCH, BERT_SEQ, BERT_HEADS, BERT_HEAD_DIM
    flash_vals = {v: randn(b, s, h * d).bfloat16() for v in "qkv"}
    flash_sym = mx.sym.flash_attention(*[mx.sym.Variable(v) for v in "qkv"],
                                       heads=h, name="fa")
    cases = (
        (f"sym.FusedNormReluConv [{n}, {hw}, {hw}, {ci}] -> {co}, "
         f"{k}x{k}, bf16 ({label})", fc, fc.norm_relu_conv, "fused_conv",
         FUSED, fused_sym, fused_vals, fused_req,
         randn(n, hw, hw, co).bfloat16()),
        (f"sym.flash_attention ({b}, {s}, {h}x{d}) bf16", fa,
         fa.flash_attention, "flash_attention", FLASH, flash_sym,
         flash_vals, dict.fromkeys("qkv", "write"),
         randn(b, s, h * d).bfloat16()))
    launched = {}
    for what, module, fn, prefix, kinds, symbol, vals, req, og in cases:
        counters = dict(fn.launches)
        got, per_call, ex = sym_kernel_calls(torch, symbol, vals, req, og,
                                             SYM_CALLS, None)
        one = {f"{prefix}_{kk}": 1 for kk in kinds}
        expect(all(c == one for c in per_call),
               f"{what}: launches per call {per_call}, expected {one}")
        expect(ex.graph_count() == 1, f"{what}: the executor holds "
               f"{ex.graph_count()} graphs, expected the training pair")
        launched.update({f"{prefix}_{kk}": fn.launches[kk] - counters[kk]
                         for kk in kinds})
        del ex
        plain_counts = dict(fn.launches)
        with plain_versions(module):
            want, _, ex = sym_kernel_calls(torch, symbol, vals, req, og, 1,
                                           False)
        del ex
        expect(fn.launches == plain_counts,
               f"{what}: the plain route launched kernels")
        labels = ["out"] + [f"d{v}" for v in sorted(req)
                            if req[v] != "null"]
        err = {nm: check_outputs(torch, what, nm, [g], [p])
               for nm, g, p in zip(labels, got, want)}
        log(f"symbolic kernels [{what}]: {SYM_CALLS} training calls "
            f"(eager, then the captured pair replayed), launches per call "
            f"{per_call}; max abs err vs the plain versions "
            + ", ".join(f"{nm} {e:.3e}" for nm, e in err.items()))
        torch.cuda.empty_cache()
    return launched


def sym_examples(torch, root):
    """(c) ``examples/module_symbolic_mnist.py --epochs 1`` and
    ``examples/bucketing_lstm.py --epochs 2 --batch-size 16`` as
    written, with the port as ``mx``: the first Module's score and the
    reloaded Module's within 1e-6, the SymbolBlock's probabilities and
    ``Module.predict`` of the reloaded Module on the same batch within
    1e-6 (every executor on the card); the bucketing run prints "over
    buckets [4, 8, 12]", and its bucket executors hold one graph per key
    used (a training pair where a bucket trained twice or more, an
    inference forward where it was scored)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import executor as exmod

    seen = {"scores": [], "served": [], "calls": {}, "executors": {}}
    patches = []

    def patch(owner, name, wrap):
        orig = getattr(owner, name)
        patches.append((owner, name, orig))
        setattr(owner, name, wrap(orig))

    patch(mx.mod.Module, "score", lambda orig: lambda self, *a, **kw: (
        seen["scores"].append((self, orig(self, *a, **kw)))
        or seen["scores"][-1][1]))

    def sb_forward(orig):
        def forward(self, *args):
            out = orig(self, *args)
            seen["served"].append((args, out))
            return out
        return forward
    patch(mx.gluon.SymbolBlock, "forward", sb_forward)

    def ex_forward(orig):
        def forward(self, is_train=False, **kw):
            key = (id(self), bool(is_train))
            seen["calls"][key] = seen["calls"].get(key, 0) + 1
            seen["executors"][id(self)] = self
            return orig(self, is_train=is_train, **kw)
        return forward
    patch(exmod.Executor, "forward", ex_forward)
    try:
        mx.random.seed(0)
        text = run_example(root, "module_symbolic_mnist", ["--epochs", "1"],
                           env={"JAX_PLATFORMS": ""})
        expect("SymbolBlock serve" in text and "validation accuracy" in text,
               "module_symbolic_mnist: its lines are missing")
        expect(all(e._device.type == "cuda"
                   for e in seen["executors"].values()),
               "module_symbolic_mnist: an executor ran off the card")
        (first, (s1,)), (reloaded, (s2,)) = seen["scores"][:2]
        expect(s1[0] == s2[0] and abs(s1[1] - s2[1]) <= 1e-6,
               f"module_symbolic_mnist: score {s1} vs the reloaded {s2}")
        (x,), probs = seen["served"][0]
        pred = reloaded.predict(mx.io.NDArrayIter(
            mx.nd.NDArray(x), batch_size=x.shape[0]))._data
        diff = float((pred - probs).abs().max())
        expect(probs.is_cuda and diff <= 1e-6, f"module_symbolic_mnist: "
               f"SymbolBlock vs Module.predict max abs diff {diff:.3e}")
        log(f"symbolic example module_symbolic_mnist: score {s1[1]:.6f}, "
            f"reloaded {s2[1]:.6f}; SymbolBlock vs Module.predict on a "
            f"batch of {x.shape[0]}: max abs diff {diff:.3e}")

        seen["calls"].clear()
        seen["executors"].clear()
        mx.random.seed(0)
        text = run_example(root, "bucketing_lstm",
                           ["--epochs", "2", "--batch-size", "16"],
                           env={"JAX_PLATFORMS": ""})
        expect("over buckets [4, 8, 12]" in text,
               "bucketing_lstm: 'over buckets [4, 8, 12]' not printed")
        execs = seen["executors"]
        keys = sum((seen["calls"].get((i, True), 0) >= 2)
                   + (seen["calls"].get((i, False), 0) >= 1) for i in execs)
        graphs = sum(e.graph_count() for e in execs.values())
        expect(len(execs) == 3 and graphs == keys,
               f"bucketing_lstm: {len(execs)} bucket executors hold "
               f"{graphs} graphs, {keys} keys used")
        log(f"symbolic example bucketing_lstm: {len(execs)} bucket "
            f"executors x their keys (train pair, inference forward) = "
            f"{keys} keys used, {graphs} graphs held; calls by (executor, "
            f"is_train): {sorted(seen['calls'].values())}")
    finally:
        for owner, name, orig in reversed(patches):
            setattr(owner, name, orig)
    return graphs


def sym_mlp(S):
    """``examples/module_symbolic_mnist.py``'s ``build_symbol``."""
    net = S.FullyConnected(S.Variable("data"), name="fc1", num_hidden=128)
    net = S.Activation(net, name="relu1", act_type="relu")
    net = S.FullyConnected(net, name="fc2", num_hidden=64)
    net = S.Activation(net, name="relu2", act_type="relu")
    net = S.FullyConnected(net, name="fc3", num_hidden=10)
    return S.SoftmaxOutput(net, name="softmax", normalization="batch")


def sym_resume(torch, tmp):
    """(d) ``Module.fit`` on the card, 2 epochs of SYM_FIT_BATCHES batches
    of the example's MLP (Adam 0.02, as the example): once uninterrupted;
    once with ``checkpoint_prefix`` and a batch-end callback that raises
    SIGTERM after batch SYM_FIT_KILL (the fit snapshots and returns); the
    same Module's parameters and optimizer state are then overwritten in
    place and ``fit(resume=True)`` restores them in place, into the
    tensors its captured graphs hold (their graphs kept), and picks up at
    the next batch.  It must end on the uninterrupted run's parameters
    and optimizer state bit for bit."""
    import signal

    import mxnet_tpu_torch as mx

    rng = np.random.RandomState(4)
    n = SYM_FIT_BATCHES * SYM_FIT_BATCH
    x = rng.rand(n, 784).astype(np.float32)
    y = rng.randint(0, 10, (n,)).astype(np.float32)

    def fit(mod, prefix, resume=False, kill_at=None):
        seen = []

        def at_batch_end(p):
            seen.append((p.epoch, p.nbatch))
            if (p.epoch, p.nbatch) == kill_at:
                signal.raise_signal(signal.SIGTERM)

        mod.fit(mx.io.NDArrayIter(x, y, batch_size=SYM_FIT_BATCH),
                optimizer="adam", optimizer_params=(("learning_rate", 0.02),),
                eval_metric="acc", num_epoch=2,
                batch_end_callback=at_batch_end, checkpoint_prefix=prefix,
                resume=resume)
        return seen

    def state(mod):
        ex = mod._exec
        out = {n: ex.arg_dict[n]._data for n in mod._param_names()}
        for n, st in mod._opt_states.items():
            for i, t in enumerate(st):
                out[f"{n}.opt{i}"] = t._data
        return out

    def fresh():
        mx.random.seed(3)
        mx.init.seed(3)
        return mx.mod.Module(sym_mlp(mx.sym), context=mx.gpu(0))

    ref = fresh()
    fit(ref, os.path.join(tmp, "ref"))
    want = {k: t.clone() for k, t in state(ref).items()}
    del ref
    prefix = os.path.join(tmp, "ck")
    mod = fresh()
    seen1 = fit(mod, prefix, kill_at=SYM_FIT_KILL)
    expect(seen1[-1] == SYM_FIT_KILL
           and os.path.exists(prefix + "-resume.json"),
           f"Module.fit on SIGTERM: last batch {seen1[-1]}, marker "
           f"{os.path.exists(prefix + '-resume.json')}")
    held = state(mod)
    graphs = mod._exec.graph_count()
    with torch.no_grad():
        for t in held.values():
            t.fill_(0.5)
    seen2 = fit(mod, prefix, resume=True)
    nxt = (SYM_FIT_KILL[0], SYM_FIT_KILL[1] + 1)
    expect(seen2[0] == nxt, f"resumed fit started at {seen2[0]}, not {nxt}")
    got = state(mod)
    expect(all(got[k] is held[k] for k in held)
           and mod._exec.graph_count() == graphs,
           "resumed fit rebound a tensor its graphs hold")
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    expect(not differ, f"resumed Module.fit differs from the "
           f"uninterrupted run in {differ[:4]}")
    log(f"symbolic resume: Module.fit (MLP 784-128-64-10, Adam, 2 x "
        f"{SYM_FIT_BATCHES} batches of {SYM_FIT_BATCH}) SIGTERMed after "
        f"batch {SYM_FIT_KILL}, loaded in place into the {len(held)} "
        f"tensors its {graphs} graph(s) hold, resumed at {seen2[0]}; "
        f"parameters and optimizer state the uninterrupted run's bits")


def sym_export(torch, tmp):
    """(e) ``HybridBlock.export`` of a hybridized NHWC block with a fused
    norm-relu-conv (64 -> 64, 3x3) on the card, then
    ``SymbolBlock.imports`` of the artifact: the program records the
    kernel as the ``mxnet_tpu_torch::norm_relu_conv`` custom op, each
    call of the imported block launches the forward kernel once, and
    its outputs are the block's bits."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.ops.fused_conv import norm_relu_conv

    with mx.name.NameManager():
        net = nn.HybridSequential()
        net.add(nn.Conv2D(64, 3, padding=1, layout="NHWC", in_channels=3),
                nn.NormReluConv2D(64, 3, in_channels=64),
                nn.BatchNorm(axis=-1), nn.Flatten(), nn.Dense(10))
    net.initialize(ctx=mx.gpu(0))
    net.hybridize()
    x = mx.nd.array(np.random.RandomState(5).randn(4, 16, 16, 3)
                    .astype(np.float32), ctx=mx.gpu(0))
    ref = net(x)._data
    t0 = time.perf_counter()
    sym_file, _ = net.export(os.path.join(tmp, "fused"))
    export_s = time.perf_counter() - t0
    program = open(os.path.join(tmp, "fused-graph.pt2"), "rb").read()
    served = mx.gluon.SymbolBlock.imports(sym_file, ctx=mx.gpu(0))
    before = norm_relu_conv.launches["fwd"]
    got = served(x)._data
    torch.cuda.synchronize()
    launched = norm_relu_conv.launches["fwd"] - before
    expect(b"mxnet_tpu_torch.norm_relu_conv" in program and launched == 1
           and torch.equal(got, ref), f"export: custom op recorded "
           f"{b'mxnet_tpu_torch.norm_relu_conv' in program}, {launched} "
           f"forward launches a call, same bits {torch.equal(got, ref)}")
    log(f"symbolic export: a fused block exported in {export_s:.2f} s, "
        f"served by SymbolBlock.imports on the card: 1 fused_conv_fwd "
        f"launch a call, the block's bits")


def symbolic_phase(torch, root, smi_line):
    """The symbolic API on the card: (a) ``sym_resnet``, (b)
    ``sym_kernels``, (c) ``sym_examples``, (d) ``sym_resume``, (e)
    ``sym_export``."""
    resnet = sym_resnet(torch, smi_line)
    launched = sym_kernels(torch)
    graphs = sym_examples(torch, root)
    with tempfile.TemporaryDirectory() as tmp:
        sym_resume(torch, tmp)
        sym_export(torch, tmp)
    return {"resnet": resnet, "launches": launched, "bucket_graphs": graphs}


# ------------------------------------------------------ classifier serving --
def card_line(smi_line):
    return f"[{smi_line}]"


def stamped(req, stamps):
    """``req``, its resolution time noted in ``stamps`` by a callback."""
    req.add_done_callback(lambda r: stamps.__setitem__(id(r),
                                                       time.monotonic()))
    return req


def latency_ms(reqs, stamps):
    """p50 and p99 of resolved requests' submit-to-result times, ms."""
    lat = [1e3 * (stamps[id(r)] - r.submitted_at) for r in reqs]
    return (float(np.percentile(lat, 50)), float(np.percentile(lat, 99)))


def serve_mnist_example(torch, root, smi_line):
    """(a) ``examples/serve_mnist.py``'s ``main()`` as written, with
    ``SERVE_MNIST_ARGS``: zero failed requests, four distinct shapes, the
    hybridized net's forward graphs one per bucket, every accepted
    request resolved by the drain."""
    import importlib.util
    import io as _io

    path = os.path.join(root, "examples", "serve_mnist.py")
    out = _io.StringIO()
    nets = []
    with port_as_mxnet([path] + SERVE_MNIST_ARGS):
        spec = importlib.util.spec_from_file_location("_serve_mnist", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        expect(mod.mx.__name__ == "mxnet_tpu_torch",
               f"serve_mnist: mx is {mod.mx.__name__}, not the port")
        train_quick = mod.train_quick

        def kept(*a, **kw):
            nets.append(train_quick(*a, **kw))
            return nets[-1]
        mod.train_quick = kept
        with contextlib.redirect_stdout(out):
            mod.main()
    text = out.getvalue()
    for line in text.splitlines():
        log(f"example serve_mnist {' '.join(SERVE_MNIST_ARGS)}: {line}")
    served = re.search(r"served (\d+) requests .* failed=(\d+)", text)
    shapes = re.search(r"distinct_shapes=(\d+)", text)
    drained = re.search(r"drained=(\w+) \(accepted requests resolved: "
                        r"(\d+)/(\d+)\)", text)
    expect(served and shapes and drained,
           "serve_mnist: its summary lines are missing")
    expect(served.group(2) == "0", f"serve_mnist: {served.group(2)} "
           f"requests failed")
    expect(shapes.group(1) == "4", f"serve_mnist: {shapes.group(1)} "
           f"distinct shapes, not 4")
    expect(drained.group(1) == "True"
           and drained.group(2) == drained.group(3),
           f"serve_mnist: the drain left requests unresolved "
           f"({drained.group(0)})")
    fwd = len(nets[0]._cached.forward_graphs or ())
    expect(fwd == 4, f"serve_mnist: the hybridized net holds {fwd} "
           f"forward graphs, not 4")
    log(f"classifier serving [serve_mnist, {card_line(smi_line)}]: "
        f"{served.group(1)} served, 0 failed, 4 distinct shapes, the "
        f"hybridized net's graphs {nets[0].graph_count()} (4 forward, one "
        f"training pair), every accepted request resolved")


def classifier_images(n, seed):
    """``n`` distinct host images 224x224x3 in [0, 1) from a seed."""
    return np.random.RandomState(seed).rand(
        n, 224, 224, 3).astype(np.float32)


class RecordingApply:
    """The served ResNet apply: host f32 [b, 224, 224, 3] onto the card
    without a host sync, cast to bf16 there, through the ``EvalStep``'s
    graph of the bucket.  Notes each call's bucket and device time
    (CUDA events, read after the traffic); while ``keep`` is set, also
    the padded batch and its output."""

    def __init__(self, torch, step):
        self.torch, self.step = torch, step
        self.events, self.kept, self.keep = [], [], False
        self.graph_count = step.graph_count

    def __call__(self, x):
        torch = self.torch
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        xd = torch.from_numpy(x).to("cuda", non_blocking=True)
        out = self.step(xd.to(torch.bfloat16))
        e1.record()
        self.events.append((x.shape[0], e0, e1))
        if self.keep:
            self.kept.append((x.copy(), out))
        return out


def bucket_ms(apply, events):
    """Mean device ms per batch at each bucket over ``events``."""
    apply.torch.cuda.synchronize()
    per = {}
    for b, e0, e1 in events:
        per.setdefault(b, []).append(e0.elapsed_time(e1))
    return {b: float(np.mean(v)) for b, v in sorted(per.items())}


def resnet_traffic(torch, srv, apply, images, smi_line):
    """(i) CLASSIFIER_CLIENTS closed-loop clients, CLASSIFIER_PER_CLIENT
    requests each, deadline 2 s; (ii) an open burst of CLASSIFIER_BURST
    ``submit()``s from 4 threads.  Returns the numbers."""
    import threading

    done, lock, stamps = [], threading.Lock(), {}

    def client(k):
        rng = np.random.RandomState(k)
        for _ in range(CLASSIFIER_PER_CLIENT):
            req = stamped(srv.submit(images[rng.randint(len(images))],
                                     deadline=2.0), stamps)
            req.result(30)
            with lock:
                done.append(req)

    b0 = srv.stats["batches"]
    apply.events.clear()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(CLASSIFIER_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    dt = time.perf_counter() - t0
    n = CLASSIFIER_CLIENTS * CLASSIFIER_PER_CLIENT
    expect(len(done) == n and all(r.exception(0) is None for r in done),
           f"closed loop: {len(done)} of {n} requests served")
    batches = srv.stats["batches"] - b0
    p50, p99 = latency_ms(done, stamps)
    closed = {"img_s": n / dt, "p50_ms": p50, "p99_ms": p99,
              "occupancy": n / batches, "batches": batches,
              "bucket_ms": bucket_ms(apply, apply.events)}
    log(f"classifier serving [ResNet-50 closed loop, "
        f"{CLASSIFIER_CLIENTS} clients x {CLASSIFIER_PER_CLIENT}, "
        f"{card_line(smi_line)}]: {closed['img_s']:.1f} img/s, latency "
        f"p50 {p50:.2f} ms p99 {p99:.2f} ms, {batches} batches, mean "
        f"occupancy {closed['occupancy']:.2f} requests a batch, device ms "
        f"a batch by bucket {closed['bucket_ms']}")

    def burst(n_req, out):
        def submitter(k):
            mine = [stamped(srv.submit(images[(k + 4 * i) % len(images)]),
                            stamps) for i in range(n_req // 4)]
            with lock:
                out.extend(mine)
        threads = [threading.Thread(target=submitter, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        for r in out:
            r.result(60)

    b0 = srv.stats["batches"]
    apply.events.clear()
    reqs = []
    t0 = time.perf_counter()
    burst(CLASSIFIER_BURST, reqs)
    dt = time.perf_counter() - t0
    expect(all(r.exception(0) is None for r in reqs),
           "burst: a request failed")
    batches = srv.stats["batches"] - b0
    p50, p99 = latency_ms(reqs, stamps)
    opened = {"img_s": CLASSIFIER_BURST / dt, "p50_ms": p50, "p99_ms": p99,
              "batches": batches,
              "occupancy": CLASSIFIER_BURST / batches,
              "bucket_ms": bucket_ms(apply, apply.events)}
    log(f"classifier serving [ResNet-50 burst of {CLASSIFIER_BURST} from 4 "
        f"threads, {card_line(smi_line)}]: {opened['img_s']:.1f} img/s, "
        f"{batches} batches (mean occupancy {opened['occupancy']:.2f}), "
        f"latency p50 {p50:.1f} ms p99 {p99:.1f} ms, device ms a batch "
        f"by bucket {opened['bucket_ms']}")
    prof, wall_us, _ = profiled(
        torch, lambda: burst(CLASSIFIER_PROFILED_BURST, []),
        "classifier burst")
    opened["busy"] = print_profile(
        prof, wall_us, f"ResNet-50 burst of {CLASSIFIER_PROFILED_BURST}, "
        f"{card_line(smi_line)}")
    return closed, opened


def resnet_check_traffic(srv, apply, images):
    """A group of each bucket's size of distinct images, each padded
    batch and its output kept.  Returns ``[(payload, request)]``."""
    apply.kept.clear()
    apply.keep = True
    reqs, offset = [], 0
    for b in CLASSIFIER_BUCKETS:
        mine = [(images[offset + i], srv.submit(images[offset + i]))
                for i in range(b)]
        offset += b
        for _, r in mine:
            r.result(60)
        reqs += mine
    apply.keep = False
    return reqs


def resnet_checks(torch, net, apply, reqs):
    """Every response of ``resnet_check_traffic`` the bits of its row of
    one direct ``EvalStep`` call on the same padded batch (the same
    graph), and each padded batch held against the same batch through
    the plain versions of the fused conv (``check_outputs``' bf16
    tolerance) with the top-1 agreement.  Returns the worst error."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ops import fused_conv as fc

    worst, agree, rows = 0.0, 0, 0
    for x, out in apply.kept:
        again = apply(x)
        expect(torch.equal(again, out), f"bucket {x.shape[0]}: a direct "
               f"EvalStep call on the same padded batch differs")
        with plain_versions(fc), autograd.pause():
            want = net(torch.from_numpy(x).cuda().to(torch.bfloat16))
        torch.cuda.synchronize()
        worst = max(worst, check_outputs(
            torch, f"served ResNet-50, bucket {x.shape[0]}", "fused_conv",
            [out], [want]))
        agree += int((out.argmax(1) == want.argmax(1)).sum())
        rows += x.shape[0]
    kept = [(x, out.float().cpu().numpy()) for x, out in apply.kept]
    for payload, r in reqs:
        got = r.result(0)
        hit = [o[i] for x, o in kept for i in range(x.shape[0])
               if np.array_equal(x[i], payload)]
        expect(hit and any(np.array_equal(got, h) for h in hit),
               "a served row is not its direct EvalStep row's bits")
    log(f"classifier serving [ResNet-50 checks]: {len(reqs)} responses "
        f"over buckets {CLASSIFIER_BUCKETS} the bits of their direct "
        f"EvalStep rows; {len(apply.kept)} padded batches vs the plain "
        f"versions: max abs err {worst:.3e} (bf16 rtol {BF16_RTOL} of "
        f"each output's scale), top-1 agreement {agree}/{rows}")
    apply.kept.clear()
    return worst


def fwd_small_n(torch, smi_line):
    """The forward kernel at the eight ResNet-50 shapes at N = 1 and 4
    (the serving buckets' smallest), bf16: held against its plain
    version, then timed (CUDA events, L2 flushed) beside its plain
    version and its bound; summed over a forward's 32 launches."""
    from mxnet_tpu_torch.ops import fused_conv as fc

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    flush = torch.empty(1024 * 2**20, dtype=torch.uint8, device=DEVICE)
    before = dict(fc.norm_relu_conv.launches)
    out = {}
    for n in CLASSIFIER_SMALL_N:
        tot = dict.fromkeys(("ms", "plain_ms", "bound_ms", "err"), 0.0)
        for label, blocks, hw, ci, co, k in path_shapes():
            x, sc, sh, w, _, _ = fused_inputs(torch, gen, n, hw, ci, co, k,
                                              torch.bfloat16)
            kfn = lambda: fc._fwd_cuda(x, sc, sh, w, None, True, 1)
            pfn = lambda: fc._fwd_plain(x, sc, sh, w, None, True, 1)
            err = check_outputs(torch, f"{label}, N={n}, bf16", "fwd",
                                [kfn()], [pfn()])
            ms = time_ms(torch, kfn, 20, flush)
            plain_ms = time_ms(torch, pfn, 10, flush)
            ops_ms, bytes_ms = conv_bound(n, hw, ci, co, k, "fwd")
            bound = max(ops_ms, bytes_ms)
            log(f"time [fused_conv_fwd {label}, N={n}, bf16, "
                f"{card_line(smi_line)}]: {ms:.4f} ms (plain "
                f"{plain_ms:.4f}, bound {bound:.5f} by "
                f"{'operations' if ops_ms >= bytes_ms else 'bytes'}, "
                f"{100 * bound / ms:.2f}% of bound), max abs err {err:.3e}, "
                f"grid rows {n * hw * hw} = {-(-n * hw * hw // 64)} tiles")
            tot["ms"] += blocks * ms
            tot["plain_ms"] += blocks * plain_ms
            tot["bound_ms"] += blocks * bound
            tot["err"] = max(tot["err"], err)
        log(f"time per forward [fused_conv_fwd, N={n}, 32 launches, "
            f"{card_line(smi_line)}]: kernel {tot['ms']:.3f} ms "
            f"({tot['ms'] / 32:.4f} ms a launch), plain "
            f"{tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms, "
            f"max abs err {tot['err']:.3e}")
        out[n] = tot
    fc.norm_relu_conv.launches = before       # timing is not the path
    return out


def serve_resnet(torch, smi_line):
    """(b) The fused ResNet-50 classifier at full width (``bench_resnet``'s
    net: NHWC, ``fused=True``, bf16, 1000 classes, seeded) behind
    ``parallel.EvalStep`` and ``InferenceServer(buckets=(1, 4, 16,
    64))``: the grid captured by ``start()``, the traffic of
    ``resnet_traffic``, the checks of ``resnet_checks``, the forward
    kernel's launches counted under replay (32 a batch, no dX or dW)."""
    from mxnet_tpu_torch import parallel, serving
    from mxnet_tpu_torch.ops import fused_conv as fc

    net = build_resnet50(torch, True, "bfloat16")
    step = parallel.EvalStep(net)
    apply = RecordingApply(torch, step)
    images = classifier_images(CLASSIFIER_IMAGES, 0)
    srv = serving.InferenceServer(
        apply, buckets=CLASSIFIER_BUCKETS, max_queue=CLASSIFIER_BURST,
        max_delay=0.005, sample=images[0], name="ResNetServer")
    t0 = time.perf_counter()
    srv.start()
    warm = time.perf_counter() - t0
    expect(step.graph_count() == len(CLASSIFIER_BUCKETS),
           f"ResNet server: {step.graph_count()} graphs after start")
    fc.norm_relu_conv.launches = dict.fromkeys(FUSED, 0)
    b0 = srv.stats["batches"]
    closed, opened = resnet_traffic(torch, srv, apply, images, smi_line)
    reqs = resnet_check_traffic(srv, apply, images)
    launches = dict(fc.norm_relu_conv.launches)
    batches = srv.stats["batches"] - b0
    worst = resnet_checks(torch, net, apply, reqs)
    expect(launches["fwd"] == FUSED_PER_STEP * batches
           and launches["dx"] == 0 and launches["dw"] == 0,
           f"ResNet server: launches {launches} for {batches} batches")
    expect(step.graph_count() == len(CLASSIFIER_BUCKETS),
           f"ResNet server: {step.graph_count()} graphs after the traffic")
    srv.drain()
    st = srv.stats
    expect(st["admitted"] == st["completed"] and st["failed"] == 0,
           f"ResNet server: {st}")
    log(f"classifier serving [ResNet-50, {card_line(smi_line)}]: start "
        f"(4 graphs captured) {warm:.2f} s; graphs {step.graph_count()} = "
        f"the grid after the traffic; fused_conv_fwd {launches['fwd']} "
        f"launches = 32 x {batches} batches, no dX or dW")
    return {"closed": closed, "burst": opened, "launches": launches["fwd"],
            "batches": batches, "max_abs_err": worst, "step": step,
            "apply": apply, "sample": images[:1]}


def module_traffic(srv, sample, n, seed):
    """``n`` requests from 4 clients with ragged gaps (every bucket);
    returns ``[(index into sample, request)]``."""
    import threading

    out, lock = [], threading.Lock()

    def client(k):
        rng = np.random.RandomState(seed + k)
        mine = []
        for i in range(n // 4):
            j = rng.randint(len(sample))
            mine.append((j, srv.submit(sample[j], deadline=30.0)))
            if rng.rand() < 0.3:
                time.sleep(0.01)
        for _, r in mine:
            r.result(60)
        with lock:
            out.extend(mine)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    expect(len(out) == n and all(r.exception(0) is None for _, r in out),
           f"module traffic: {len(out)} of {n} served")
    return out


def serve_module(torch, smi_line):
    """(c) The symbolic ResNet-50 (NCHW, f32; ``sym_resnet50``) bound
    for inference at batch 64, seeded, served by ``module_apply`` in f32
    and int8 at buckets (1, 8, 64): one graph a bucket after the warm-up
    and after MODULE_REQUESTS mixed requests, nothing rebound; f32
    responses against ``Module.predict``, int8 against f32, and the int8
    graph's weight-input bytes against f32's."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serving

    mx.random.seed(0)
    mod = mx.mod.Module(sym_resnet50(mx.sym), context=mx.gpu(0))
    mod.bind([("data", (MODULE_BUCKETS[-1], 3, 224, 224))],
             [("softmax_label", (MODULE_BUCKETS[-1],))], for_training=False)
    mod.init_params(mx.init.Xavier(magnitude=2.0))
    images = np.random.RandomState(1).rand(
        MODULE_BUCKETS[-1], 3, 224, 224).astype(np.float32)
    want = mod.predict(mx.io.NDArrayIter(
        images, batch_size=MODULE_BUCKETS[-1])).asnumpy()
    results = {}
    for quantize in (None, "int8"):
        what = quantize or "f32"
        apply = serving.module_apply(mod, quantize=quantize)
        srv = serving.InferenceServer(apply, buckets=MODULE_BUCKETS,
                                      max_delay=0.005, sample=images[0],
                                      name=f"ModuleServer-{what}")
        srv.start()
        graphs = apply.jit_cache_size()
        held = mod._exec._held
        served = module_traffic(srv, images, MODULE_REQUESTS, 10)
        srv.drain()
        after = apply.jit_cache_size()
        expect(graphs == after == len(MODULE_BUCKETS),
               f"module_apply {what}: graphs {graphs} after the warm-up, "
               f"{after} after the traffic")
        expect(mod._exec._held is held, f"module_apply {what}: the "
               f"executor dropped its graphs")
        idx = [j for j, _ in served]
        got = np.stack([r.result(0) for _, r in served])
        results[what] = (idx, got, apply, srv.stats)
    idx, got, f32_apply, st = results["f32"]
    err = float(np.abs(got - want[idx]).max() / np.abs(want).max())
    expect(err <= 1e-5, f"module_apply f32 vs Module.predict: {err:.3e} of "
           f"the output's scale")
    qidx, qgot, q_apply, qst = results["int8"]
    ref = np.stack([want[i] for i in qidx])
    qerr = float(np.abs(qgot - ref).max())
    f32_bytes = sum(a._data.numel() * a._data.element_size()
                    for n, a in mod._exec.arg_dict.items()
                    if n not in ("data", "softmax_label"))
    log(f"classifier serving [module_apply, symbolic ResNet-50 NCHW f32, "
        f"buckets {MODULE_BUCKETS}, {card_line(smi_line)}]: graphs "
        f"{len(MODULE_BUCKETS)} for f32 and for int8 after the warm-up and "
        f"after {MODULE_REQUESTS} requests each, nothing rebound; f32 vs "
        f"Module.predict max abs err {err:.3e} of the output's scale "
        f"(bound 1e-5); int8 vs f32 max abs err {qerr:.3e} on the softmax "
        f"outputs ({'within' if qerr <= 5e-3 else 'OVER'} atol 5e-3); "
        f"weight-input bytes int8 {q_apply.weight_bytes / 2**20:.2f} MiB "
        f"vs f32 {f32_bytes / 2**20:.2f} MiB = "
        f"{q_apply.weight_bytes / f32_bytes:.3f}x; batches f32 "
        f"{st['batches']}, int8 {qst['batches']}")
    return {"f32": f32_apply, "int8": q_apply, "sample": images[:1]}


def fleet_mlp(torch, params_idx):
    """The MLP forward of ``examples/serve_fleet_mnist.py`` over a params
    list in snapshot order: ``relu(x @ w1.T + b1) @ w2.T + b2``."""
    iw1, ib1, iw2, ib2 = params_idx

    def fwd(p, x):
        h = torch.relu(x @ p[iw1].t() + p[ib1])
        return h @ p[iw2].t() + p[ib2]
    return fwd


def serve_fleet(torch, smi_line):
    """(d) ``examples/serve_fleet_mnist.py`` on the port: a captured
    ``TrainStep`` of its MLP (Adam, batch 256 over the synthetic MNIST)
    checkpoints through ``CheckpointManager``; ``ServingFleet.replicated``
    over one ``graphs.captured`` forward, 3 replicas at buckets (1, 4, 8,
    16), serves FLEET_REQUESTS requests from 4 clients while
    ``WeightUpdater`` rolls the next snapshot across them; then a
    ``serving.step`` fault and one replica killed mid-traffic, and a
    ``FleetAutoscaler`` scaling up to 4 and retiring down to 2.  The
    shared function's graphs equal the grid throughout; zero accepted
    requests dropped."""
    import threading

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import fault, gluon, graphs, parallel, serving
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel.checkpoint import (CheckpointManager,
                                                     load_snapshot_params)

    train = gluon.data.vision.MNIST(train=True)
    test = gluon.data.vision.MNIST(train=False)
    tx = np.stack([np.asarray(train[i][0], np.float32).reshape(-1) / 255.0
                   for i in range(2048)])
    ty = np.array([int(train[i][1]) for i in range(2048)], np.float32)
    vx = np.stack([np.asarray(test[i][0], np.float32).reshape(-1) / 255.0
                   for i in range(256)])
    mx.random.seed(0)
    with mx.gpu(0):
        net = nn.HybridSequential()
        net.add(nn.Dense(128, activation="relu", in_units=784),
                nn.Dense(10, in_units=128))
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    step = parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              mx.optimizer.create("adam"))
    rng = np.random.RandomState(0)

    def train_batches(k):
        for _ in range(k):
            idx = rng.randint(0, len(tx), 256)
            step(tx[idx], ty[idx])

    with tempfile.TemporaryDirectory() as ckpt_dir:
        mgr = CheckpointManager(step, ckpt_dir, keep_last=3)
        train_batches(8)
        mgr.save()
        first_n, first_path = mgr.checkpoints()[-1]
        host, _names = load_snapshot_params(first_path)
        shapes = [tuple(p.shape) for p in host]
        fwd = fleet_mlp(torch, (shapes.index((128, 784)),
                                    shapes.index((128,)),
                                    shapes.index((10, 128)),
                                    shapes.index((10,))))
        shared = graphs.captured(fwd)
        params = [torch.from_numpy(p).cuda() for p in host]

        class KillableApply(serving.HotSwapApply):
            """A replica's apply whose batch thread dies (SystemExit)
            once ``dead`` is set: a killed replica."""
            dead = False

            def __call__(self, *leaves):
                if self.dead:
                    raise SystemExit("replica killed")
                return super().__call__(*leaves)

        fleet = serving.ServingFleet(
            [KillableApply(shared, list(params)) for _ in range(3)],
            buckets=FLEET_BUCKETS, max_delay=0.003, sample=vx[0],
            name="MnistFleet", max_inflight=FLEET_INFLIGHT)
        fleet.start()
        census = fleet.grid_census
        seen = {"min": shared.graph_count(), "max": shared.graph_count()}
        watching = threading.Event()

        def watch():
            while not watching.wait(0.005):
                n = shared.graph_count()
                seen["min"] = min(seen["min"], n)
                seen["max"] = max(seen["max"], n)

        watcher = threading.Thread(target=watch)
        watcher.start()
        accepted, shed, lock = [], [0], threading.Lock()
        stop = threading.Event()

        def client(k, n=None):
            rc = np.random.RandomState(k)
            i = 0
            while (n is None and not stop.is_set()) or (n is not None
                                                        and i < n):
                i += 1
                try:
                    req = fleet.submit(vx[rc.randint(len(vx))])
                    with lock:
                        accepted.append(req)
                    req.result(60)
                except serving.RejectedError:
                    with lock:
                        shed[0] += 1
                time.sleep(0.002)

        updater = serving.WeightUpdater(fleet, mgr, last_seen=first_n,
                                        poll=0.05)
        updater.start()
        threads = [threading.Thread(target=client,
                                    args=(k, FLEET_REQUESTS // 4))
                   for k in range(4)]
        for t in threads:
            t.start()
        train_batches(48)
        mgr.save()
        new_n, new_path = mgr.checkpoints()[-1]
        t0 = time.time()
        while updater.applied < 1 and time.time() - t0 < 60:
            time.sleep(0.02)
        for t in threads:
            t.join(120)
        updater.stop(timeout=10)
        expect(updater.applied == 1 and updater.skipped == 0,
               f"fleet: updater applied {updater.applied}, skipped "
               f"{updater.skipped}")
        new_host, _ = load_snapshot_params(new_path)
        for rep in fleet.replicas:
            expect(all(leaf.is_cuda and torch.equal(leaf, torch.from_numpy(
                h).cuda()) for leaf, h in zip(rep.apply.params, new_host)),
                f"fleet: r{rep.index}'s params are not the snapshot's bits")
        new_params = fleet.replicas[0].apply.params
        xs = vx[:16]
        got = np.stack([fleet(x, timeout=30) for x in xs])
        eager = torch.cat([fwd(new_params, torch.from_numpy(x[None]).cuda())
                           for x in xs]).cpu().numpy()
        err = float(np.abs(got - eager).max() / np.abs(eager).max())
        expect(err <= 1e-5, f"fleet: responses after the roll vs the new "
               f"weights' eager output: {err:.3e}")
        rolled = len(accepted)
        log(f"classifier serving [fleet roll, {card_line(smi_line)}]: "
            f"{rolled} accepted, {shed[0]} shed, snapshot {first_n} -> "
            f"{new_n} rolled across 3 replicas; every replica's params the "
            f"snapshot's bits on the card; responses after the roll vs the "
            f"new weights' eager output {err:.3e} of scale "
            f"({'the same bits' if np.array_equal(got, eager) else 'not the same bits'})")
        # a serving.step fault, then one replica killed mid-traffic
        threads = [threading.Thread(target=client, args=(10 + k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        with fault.inject("serving.step", RuntimeError("wedged step"),
                          times=2):
            time.sleep(0.3)
        victim = fleet.replicas[1]
        victim.apply.dead = True
        t0 = time.time()
        while victim.server.alive() and time.time() - t0 < 10:
            time.sleep(0.01)
        expect(not victim.server.alive(), "fleet: the killed replica's "
               "batch thread is still alive")
        time.sleep(0.3)
        redispatched = fleet.stats["redispatched"]
        policy = serving.ScalingPolicy(
            min_replicas=2, max_replicas=4, up_occupancy=0.1,
            down_occupancy=0.05, up_queue_depth=None, up_ticks=2,
            down_ticks=4, cooldown=0.3)
        auto = serving.FleetAutoscaler(fleet, policy, tick=0.05)
        auto.start()
        t0 = time.time()
        while len(fleet.replicas) < 4 and time.time() - t0 < 30:
            time.sleep(0.05)
        peak = len(fleet.replicas)
        stop.set()
        for t in threads:
            t.join(60)
        t0 = time.time()
        while len(fleet.replicas) > 2 and time.time() - t0 < 60:
            time.sleep(0.05)
        auto.stop(timeout=30)
        low = len(fleet.replicas)
        drained = fleet.drain(timeout=60)
        watching.set()
        watcher.join(10)
        st = fleet.stats
        resolved = st["completed"] + st["failed"] + st["expired"]
        errors = [r.exception(0) for r in accepted
                  if r.exception(0) is not None]
        expect(drained and all(r.done() for r in accepted) and not errors,
               f"fleet: drained {drained}, {len(errors)} accepted requests "
               f"failed ({errors[:3]})")
        expect(st["admitted"] == resolved == st["completed"],
               f"fleet: books {st}")
        expect(peak == 4 and low == 2, f"fleet: the autoscaler reached "
               f"{peak} replicas and came back to {low}")
        expect(seen["min"] == seen["max"] == census,
               f"fleet: the shared function held {seen} graphs, grid "
               f"{census}")
        log(f"classifier serving [fleet, {card_line(smi_line)}]: "
            f"{len(accepted)} accepted, {shed[0]} shed, 0 dropped; "
            f"serving.step fault x2 and r1 killed: {redispatched} "
            f"redispatched; autoscaler up to {peak} and down to {low} "
            f"({auto.stats}); the shared function's graphs {census} = the "
            f"grid throughout (min {seen['min']}, max {seen['max']})")
    return {"fn": shared, "params": new_params, "sample": vx[:1]}


def no_sync_calls(torch, applies):
    """One call of each apply under ``set_sync_debug_mode("error")`` (a
    host sync raises), its result read back after."""
    for what, (fn, sample) in applies.items():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn(sample)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        expect(all(bool(torch.isfinite(o.float()).all()) for o in outs),
               f"{what}: non-finite output")
    log(f"classifier serving: one call of each apply ({', '.join(applies)})"
        f" under set_sync_debug_mode('error'): no host sync before the "
        f"read-back")


def classifier_phase(torch, root, smi_line):
    """Classifier serving on the card: (a) ``serve_mnist_example``, (b)
    ``serve_resnet`` and ``fwd_small_n``, (c) ``serve_module``, (d)
    ``serve_fleet``, (e) ``no_sync_calls``."""
    serve_mnist_example(torch, root, smi_line)
    gc.collect()
    resnet = serve_resnet(torch, smi_line)
    small = fwd_small_n(torch, smi_line)
    torch.cuda.empty_cache()
    module = serve_module(torch, smi_line)
    fleet = serve_fleet(torch, smi_line)
    no_sync_calls(torch, {
        "EvalStep ResNet-50": (resnet["apply"], resnet["sample"]),
        "module_apply f32": (module["f32"], module["sample"]),
        "module_apply int8": (module["int8"], module["sample"]),
        "fleet captured MLP": (lambda x: fleet["fn"](fleet["params"], x),
                               fleet["sample"])})
    c, b = resnet["closed"], resnet["burst"]
    log(f"classifier serving [summary, {card_line(smi_line)}]: ResNet-50 "
        f"burst {b['img_s']:.1f} img/s (busy {100 * b['busy']:.1f}%), "
        f"bucket 64 {b['bucket_ms'].get(64, float('nan')):.2f} ms a batch "
        f"of device time; closed loop p50 {c['p50_ms']:.2f} ms p99 "
        f"{c['p99_ms']:.2f} ms; fused_conv_fwd per launch "
        + ", ".join(f"N={n} {t['ms'] / 32:.4f} ms (bound "
                    f"{t['bound_ms'] / 32:.5f})" for n, t in small.items()))
    resnet.pop("step")
    return {"resnet": resnet, "small_n": small}


# -------------------------------------------------------- one-card extras --
def count_syncs(torch, fn):
    """``fn()`` under ``set_sync_debug_mode("warn")``: its result and how
    many host syncs it made (one warning each)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum(1 for w in caught if "synchroniz" in str(w.message))


def same_bits(a, b):
    """Each tensor of ``a`` equal to its partner in ``b``, bit for bit."""
    import torch

    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def flat_states(trainer):
    from mxnet_tpu_torch.gluon.trainer import _flatten_state

    return [a._data for s in trainer._states for a in _flatten_state(s)]


def amp_bert(torch, smi_line, trainstep):
    """(a) The main path: BERT-base as GluonNLP's run_pretraining.py
    trains it under AMP.  ``bench_bert``'s width (64 x 128, dropout 0.1,
    ``attention_impl="flash"``, masked-LM + NSP), f32 parameters,
    ``amp.init("float16")`` (bf16 compute and the loss scaler),
    ``amp.init_trainer`` on a ``gluon.Trainer`` with LAMB 1e-3 / wd 0.01,
    ``net.hybridize()``, ``amp.scale_loss`` every step.  EXTRAS_WARMUP +
    EXTRAS_TIMED steps: the loss falls, every flash kernel launches
    BERT_LAYERS times a step on bf16 inputs (each held against its
    plain version on the path's own tensors), tokens/s, busy share and
    peak memory beside ``trainstep`` (bench_bert's captured TrainStep of
    this run).  Then a step whose scaled loss is multiplied by inf: skipped
    (every parameter and LAMB state the same bits, the gradients zero,
    the scale 65536 -> 32768) and the next clean step applied; host
    syncs of a step and of the overflow check alone counted; then
    EXTRAS_CHECK replayed steps against as many eager ones from the same
    parameters (dropout 0, deterministic algorithms): the same bits
    where two eager runs repeat theirs, else within RUN_GAP_FACTOR of
    their gap.  AMP is turned off again at the end."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, autograd
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTPretrainLoss

    fa = flash_module()
    seen = set()
    launch = fa._launch

    def spy(what, fn, q, *rest):
        seen.add((what.rsplit("_", 1)[1], q.dtype, tuple(q.shape)))
        if what.endswith("fwd") and "q" not in spy.path:
            spy.path["q"] = q.detach().clone()
        return launch(what, fn, q, *rest)

    spy.path = {}
    amp.init("float16")
    fa._launch = spy
    try:
        return _amp_bert(torch, mx, amp, autograd, BERTPretrainLoss, fa,
                         seen, spy.path, smi_line, trainstep)
    finally:
        fa._launch = launch
        amp._deinit_for_tests()


def _amp_bert(torch, mx, amp, autograd, BERTPretrainLoss, fa, seen, path,
              smi_line, trainstep):
    net = build_bert(torch, "flash", BERT_DROPOUT)           # f32, no cast
    params = list(net.collect_params().values())
    start = [p.tensor().detach().clone() for p in params]
    data, labels = bert_batch(torch, BERT_BATCH)
    loss_blk = BERTPretrainLoss()

    def trainer_for(plist, values):
        for p, v in zip(plist, values):
            p.set_data(v)
        tr = mx.gluon.Trainer(plist, "lamb",
                              {"learning_rate": 1e-3, "wd": 0.01})
        amp.init_trainer(tr)
        return tr

    def step(model, tr, poison=False):
        with autograd.record():
            out = model(*data)
            loss = loss_blk(out[3], out[2], *labels)
            with amp.scale_loss(loss, tr) as scaled:
                if poison:
                    scaled = scaled * float("inf")
                scaled.backward()
        tr.step(1)
        return loss.detach()

    what = (f"AMP bert_12_768_12, f32 parameters, amp.init('float16'), "
            f"batch {BERT_BATCH} x {BERT_SEQ}, hybridized, gluon.Trainer "
            f"LAMB")
    net.hybridize()
    tr = trainer_for(params, start)
    mx.random.seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = dict.fromkeys(FLASH, 0)  # main path starts
    losses = [step(net, tr) for _ in range(EXTRAS_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(net, tr) for _ in range(EXTRAS_TIMED)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(fa.flash_attention.launches)         # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    steps = EXTRAS_WARMUP + EXTRAS_TIMED
    expect(all(np.isfinite(losses)), f"{what}: loss not finite {losses}")
    expect(losses[-1] < losses[0] and min(losses) < losses[0],
           f"{what}: loss did not fall over the run {losses}")
    expect(launches == dict.fromkeys(FLASH, BERT_LAYERS * steps),
           f"{what}: flash launches {launches}, expected {BERT_LAYERS} each "
           f"a step")
    routes = {(k, str(dt_).split(".")[1]) for k, dt_, _ in seen}
    expect(routes == {(k, "bfloat16") for k in FLASH},
           f"{what}: flash kernels launched on {sorted(routes)}, expected "
           f"the bf16 tensor-core route only")
    expect(all(p.tensor().dtype == torch.float32 for p in params),
           f"{what}: a parameter is not f32")
    expect(net.graph_count() == 1, f"{what}: {net.graph_count()} units")
    tok_s = BERT_BATCH * BERT_SEQ * EXTRAS_TIMED / dt
    log(f"train [{what}]: losses {[round(v, 4) for v in losses]}; "
        f"{EXTRAS_TIMED} timed steps in {dt:.3f} s = "
        f"{1e3 * dt / EXTRAS_TIMED:.1f} ms/step = {tok_s:.1f} tokens/s; "
        f"peak device memory {peak / 2**30:.2f} GiB; flash launches "
        f"{launches} on {sorted(seen)}")

    # the flash kernels on the path's own shapes and bf16 inputs
    q = path["q"]
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    k, v, do = (torch.randn(q.shape, generator=gen, device=DEVICE)
                .to(q.dtype) for _ in range(3))
    args = (q.shape[-1] ** -0.5, False, BERT_DROPOUT,
            fa.seed_tensor(FLASH_SEED, q.device))
    before = dict(fa.flash_attention.launches)
    got, (lse, delta) = flash_kernels(fa, q, k, v, do, args)
    want = flash_plain(fa, q, k, v, do, lse, delta, args, torch.float64)
    torch.cuda.synchronize()
    fa.flash_attention.launches = before        # a check, not the path
    errs = {kern: check_outputs(torch, f"{what}, path tensors", kern,
                                got[kern], want[kern]) for kern in FLASH}
    log(f"flash vs plain [AMP path: q {tuple(q.shape)} {q.dtype} as the "
        f"path's first forward launch got it, k/v/dO seeded]: max abs err "
        + ", ".join(f"{kern} {e:.3e}" for kern, e in errs.items()))

    prof, wall_us, _ = profiled(torch, lambda: step(net, tr), what)
    busy = print_profile(prof, wall_us, what)
    del prof
    _, syncs = count_syncs(torch, lambda: float(step(net, tr)))
    scaler = tr._amp_loss_scaler
    _, check_syncs = count_syncs(torch,
                                 lambda: scaler.has_overflow(tr._params))
    expect(check_syncs == 1, f"{what}: the overflow check made "
           f"{check_syncs} host syncs, expected one")
    log(f"host syncs [{what}]: {syncs} in a step with its loss read back "
        f"(the overflow check's {check_syncs} among them; the loss read "
        f"another)")

    # an injected overflow: the step is skipped, bit for bit
    expect(scaler.loss_scale == AMP_SCALE,
           f"{what}: loss scale {scaler.loss_scale} before the overflow")
    before_p = [p.tensor().detach().clone() for p in params]
    before_s = [s.clone() for s in flat_states(tr)]
    n_update = tr._optimizer.num_update
    step(net, tr, poison=True)
    torch.cuda.synchronize()
    kept_p = same_bits([p.tensor() for p in params], before_p)
    kept_s = same_bits(flat_states(tr), before_s)
    zeroed = float(torch.stack([p.grad()._data.abs().max()
                                for p in params]).max()) == 0.0
    expect(kept_p and kept_s and zeroed,
           f"{what}: the overflow step changed parameters ({not kept_p}), "
           f"LAMB states ({not kept_s}) or left gradients ({not zeroed})")
    expect(scaler.loss_scale == AMP_SCALE / 2 and
           tr._optimizer.num_update == n_update,
           f"{what}: after the overflow the scale is {scaler.loss_scale}, "
           f"updates {tr._optimizer.num_update} (was {n_update})")
    clean = float(step(net, tr))
    moved = not same_bits([p.tensor() for p in params], before_p)
    expect(moved and np.isfinite(clean),
           f"{what}: the clean step after the overflow did not apply")
    log(f"overflow [{what}]: loss scaled by inf -> step skipped: "
        f"{len(before_p)} parameters and {len(before_s)} LAMB states the "
        f"same bits, gradients zeroed, loss scale {AMP_SCALE:.0f} -> "
        f"{scaler.loss_scale:.0f}; the next clean step applied (loss "
        f"{clean:.4f})")
    trained = [p.tensor().detach().clone() for p in params]
    del tr, before_p, before_s
    net.hybridize(active=False)
    gc.collect()
    torch.cuda.empty_cache()

    # replayed against eager steps, dropout 0, from the same parameters
    check = build_bert(torch, "flash", 0.0)
    cparams = list(check.collect_params().values())
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        check.hybridize()
        warm = trainer_for(cparams, trained)
        for _ in range(2):                     # eager warm-up, capture
            step(check, warm)
        runs = []
        for hybridized in (True, False, False):
            if not hybridized:
                check.hybridize(active=False)
            tr = trainer_for(cparams, trained)
            ls = [float(step(check, tr)) for _ in range(EXTRAS_CHECK)]
            runs.append((ls, [p.tensor().detach().clone() for p in cparams]))
    finally:
        torch.use_deterministic_algorithms(prev)
    (lr, pr), (le, pe), (le2, pe2) = runs
    eager_same = le == le2 and same_bits(pe, pe2)
    same = lr == le and same_bits(pr, pe)

    def gap(a, b):
        return max(float((x.double() - y.double()).abs().max())
                   for x, y in zip(a, b))

    if eager_same:
        expect(same, f"{what}: {EXTRAS_CHECK} replayed steps differ from "
               f"the eager ones (losses {lr} vs {le}; max gap "
               f"{gap(pr, pe):.3e}) where two eager runs repeat their bits")
    else:
        expect(gap(pr, pe) <= RUN_GAP_FACTOR * gap(pe, pe2),
               f"{what}: replayed vs eager gap {gap(pr, pe):.3e} beyond "
               f"{RUN_GAP_FACTOR}x the eager runs' own {gap(pe, pe2):.3e}")
    log(f"replay vs eager [{what}, dropout 0, deterministic algorithms]: "
        f"{EXTRAS_CHECK} replayed steps {lr} vs eager {le} (again {le2}); "
        f"{len(pr)} parameters "
        + ("the same bits" if same else
           f"not the same bits: max gap {gap(pr, pe):.3e}, two eager runs "
           f"{gap(pe, pe2):.3e}"))
    ratio = tok_s / trainstep["tok_s"] if trainstep else float("nan")
    log(f"AMP BERT [{card_line(smi_line)}]: {tok_s:.1f} tokens/s (busy "
        f"{100 * busy:.1f}%, peak {peak / 2**30:.2f} GiB) vs bench_bert's "
        f"captured bf16 TrainStep "
        + (f"{trainstep['tok_s']:.1f} tokens/s = {ratio:.3f}x"
           if trainstep else "not run in this call"))
    return {"tok_s": tok_s, "ms_step": 1e3 * dt / EXTRAS_TIMED,
            "busy": busy, "peak": peak, "launches": launches,
            "syncs": syncs, "ratio": ratio, "flash_err": errs}


def estimator_resnet(torch, smi_line):
    """(b) ``Estimator.fit`` on BASELINE config 2: ``hybrid_resnet``'s
    net (fused resnet50_v1, NHWC, bf16, hybridized, gluon.Trainer SGD_KW,
    batch TRAIN_BATCH) over EXTRAS_WARMUP + EXTRAS_TIMED resident batches
    with LoggingHandler, CheckpointHandler into a temporary directory and
    EarlyStoppingHandler; each fused kernel FUSED_PER_STEP times a step.
    Before it, ``hybrid_resnet``'s hand loop from the same start over the
    same batches; with cuDNN's deterministic algorithms the parameters
    after both are the same bits.  img/s of both and their ratio."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.contrib import estimator as est_mod
    from mxnet_tpu_torch.ops import fused_conv as fc

    class StepClock(est_mod.EventHandler):
        """Times the batches from EXTRAS_WARMUP on (synchronised), as the
        hand loop's are timed."""

        def batch_begin(self, est):
            if est.current_batch == EXTRAS_WARMUP:
                torch.cuda.synchronize()
                self.t0 = time.perf_counter()

        def epoch_end(self, est):
            torch.cuda.synchronize()
            self.t1 = time.perf_counter()

    net = build_resnet50(torch, fused=True, dtype="bfloat16", device=DEVICE)
    params = list(net.collect_params().items())
    start = [p.tensor().detach().clone() for _, p in params]
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    n = EXTRAS_WARMUP + EXTRAS_TIMED
    batches = [(mx.nd.NDArray(torch.randn(
        TRAIN_BATCH, 224, 224, 3, generator=gen, device=DEVICE)
        .to(torch.bfloat16)), mx.nd.NDArray(torch.randint(
            0, 1000, (TRAIN_BATCH,), generator=gen, device=DEVICE,
            dtype=torch.int32))) for _ in range(n)]
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def fresh():
        for (_, p), v in zip(params, start):
            p.set_data(v)
        return mx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD_KW))

    what = (f"Estimator.fit, hybridized fused resnet50_v1, bf16, batch "
            f"{TRAIN_BATCH}")
    net.hybridize()
    cudnn = torch.backends.cudnn
    prev = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        tr = fresh()
        for i, (x, y) in enumerate(batches):         # hybrid_resnet's loop
            if i == EXTRAS_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            tr.step(TRAIN_BATCH)
        torch.cuda.synchronize()
        hand_dt = time.perf_counter() - t0
        hand = [p.tensor().detach().clone() for _, p in params]
        clock = StepClock()
        with tempfile.TemporaryDirectory() as tmp:
            est = est_mod.Estimator(net, loss_fn, trainer=fresh())
            fc.norm_relu_conv.launches = dict.fromkeys(FUSED, 0)  # starts
            est.fit(batches, epochs=1, event_handlers=[
                clock, est_mod.LoggingHandler(log_interval=EXTRAS_TIMED),
                est_mod.CheckpointHandler(tmp),
                est_mod.EarlyStoppingHandler("accuracy", mode="max")])
            launches = dict(fc.norm_relu_conv.launches)  # ... and ends here
            saved = sorted(os.listdir(tmp))
    finally:
        cudnn.deterministic, cudnn.benchmark = prev
    same = same_bits([p.tensor() for _, p in params], hand)
    expect(launches == dict.fromkeys(FUSED, FUSED_PER_STEP * n),
           f"{what}: fused launches {launches}, expected {FUSED_PER_STEP} "
           f"each a step")
    expect(saved == ["model-0000.params"], f"{what}: checkpoints {saved}")
    expect(same, f"{what}: the parameters after fit are not the hand "
           f"loop's bits")
    vals = {k: round(float(v), 4) for k, v in est.metric_values()}
    expect(all(np.isfinite(list(vals.values()))), f"{what}: {vals}")
    est_dt = clock.t1 - clock.t0
    img_s = TRAIN_BATCH * EXTRAS_TIMED / est_dt
    hand_img_s = TRAIN_BATCH * EXTRAS_TIMED / hand_dt
    log(f"train [{what}, {card_line(smi_line)}]: {EXTRAS_TIMED} timed "
        f"batches {1e3 * est_dt / EXTRAS_TIMED:.1f} ms each = {img_s:.1f} "
        f"img/s vs the hand loop {1e3 * hand_dt / EXTRAS_TIMED:.1f} ms = "
        f"{hand_img_s:.1f} img/s = {img_s / hand_img_s:.3f}x (the cost: "
        f"the training loss and Accuracy metrics read each batch back to "
        f"the host); metrics {vals}; fused launches {launches}; "
        f"checkpoint {saved}; {len(hand)} parameters and running "
        f"statistics the hand loop's bits (cuDNN's deterministic "
        f"algorithms)")
    return {"launches": launches, "img_s": img_s, "hand_img_s": hand_img_s}


def int8_layers(net):
    out = []

    def walk(b):
        if hasattr(b, "_wq"):
            out.append(b)
        for c in b._children.values():
            walk(c)
    walk(net)
    return out


def host_int8(blk, x):
    """A quantized layer's output on the host from its input ``x`` (a
    host tensor): the plain int8 product (int64 sums) and the same
    rescale."""
    from mxnet_tpu_torch.contrib.quantization import (QuantizedConv2D,
                                                      _quantize_input)
    from mxnet_tpu_torch import ops as F

    xq = _quantize_input(x, blk._amax)
    wq = blk._wq.cpu()
    bias = None if blk._bias is None else blk._bias.cpu()
    rng = (-blk._amax, blk._amax, -blk._wmax, blk._wmax)
    if isinstance(blk, QuantizedConv2D):
        kw = dict(blk._kwargs)
        out = F.quantized_conv(xq, wq, bias, *rng, kernel=kw["kernel"],
                               stride=kw["stride"], pad=kw["pad"],
                               num_filter=kw["num_filter"],
                               num_group=kw["num_group"], no_bias=bias is None,
                               layout=kw.get("layout"),
                               dilate=kw.get("dilate"))
    else:
        out = F.quantized_fully_connected(xq, wq, bias, *rng,
                                          no_bias=bias is None,
                                          flatten=blk._flatten)
    return blk._activate(out)


def int8_gate(torch, mx, q):
    """The JAX package's int8 accuracy gate
    (``tests/test_misc_subsystems.py:329``) on the card: resnet18_v1
    thumbnail on its separable data, Adam 3e-3, 4 epochs at 64,
    hybridized; int8 accuracy within INT8_ACC_MARGIN of float's.  The
    float model must reach INT8_FLOAT_FLOOR (twice chance): the JAX
    test's 0.9 is a property of its threefry draw of the weights, and the
    port's draw from the same seed (``random``'s declared divergence)
    settles at 0.7266 on the host CPU (seeds 1-5: 1.0)."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.model_zoo import vision

    mx.random.seed(0)
    rng = np.random.RandomState(0)
    n_cls = 4

    def make_split(n):
        y = rng.randint(0, n_cls, n)
        x = rng.randn(n, 3, 16, 16).astype(np.float32) * 0.3
        for i, k in enumerate(y):
            x[i, int(k) % 3] += 1.0 + 0.5 * (int(k) // 3)
            r, c = divmod(int(k), 2)
            x[i, :, r * 8:(r + 1) * 8, c * 8:(c + 1) * 8] += 1.5
        return x, y.astype(np.int32)

    xtr, ytr = make_split(256)
    xva, yva = make_split(128)
    net = vision.get_model("resnet18_v1", classes=n_cls, thumbnail=True)
    net.initialize(mx.init.Xavier(), ctx=DEVICE)
    net.hybridize()
    tr = mx.gluon.Trainer(net.collect_params(), "adam",
                          {"learning_rate": 3e-3})
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    bs = 64
    card = mx.gpu()
    for _ in range(4):
        for i in range(0, 256, bs):
            xb = mx.nd.array(xtr[i:i + bs], ctx=card)
            yb = mx.nd.array(ytr[i:i + bs], ctx=card)
            with autograd.record():
                loss = ce(net(xb), yb).mean()
            loss.backward()
            tr.step(xb.shape[0])
    for _ in range(16):
        with autograd.record():
            net(mx.nd.array(xtr[:bs], ctx=card))

    def accuracy(model):
        pred = model(mx.nd.array(xva, ctx=card)).asnumpy().argmax(1)
        return float((pred == yva).mean())

    float_acc = accuracy(net)
    expect(float_acc >= INT8_FLOAT_FLOOR, f"int8 gate: float resnet18_v1 "
           f"did not learn ({float_acc})")
    q.quantize_net(net, calib_data=[xtr[i:i + bs] for i in range(0, 192, bs)])
    n_layers = len(int8_layers(net))
    int8_acc = accuracy(net)
    expect(int8_acc >= float_acc - INT8_ACC_MARGIN,
           f"int8 gate: int8 accuracy {int8_acc} vs float {float_acc}")
    log(f"int8 gate [resnet18_v1 thumbnail, separable data, the JAX "
        f"package's accuracy gate]: float {float_acc:.4f}, int8 "
        f"{int8_acc:.4f} ({n_layers} layers swapped; margin "
        f"{INT8_ACC_MARGIN})")
    return float_acc, int8_acc


def int8_resnet(torch, smi_line):
    """(c) int8 through ``contrib.quantization.quantize_net``:
    resnet50_v1(fused=False), f32, NCHW, calibrated on INT8_CALIB batches
    of INT8_BATCH, then run at INT8_BATCH eager (each swapped layer's
    output on the first image held against the plain int8 product on the
    host within INT8_LAYER_RTOL of its scale; one int8 GEMM a layer) and
    hybridized (captured; the eager output's bits); the whole net's
    int8-vs-f32 error and the ms of an int8 forward against the f32 one
    (both captured).  Then ``int8_gate``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.contrib import quantization as q
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.ops import quantization as qops

    mx.random.seed(0)
    net = resnet50_v1(fused=False)
    net.initialize(mx.init.Xavier(), ctx=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    calib = [torch.randn(INT8_BATCH, 3, 224, 224, generator=gen,
                         device=DEVICE) for _ in range(INT8_CALIB)]
    x = torch.randn(INT8_BATCH, 3, 224, 224, generator=gen, device=DEVICE)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=DEVICE)
    what = f"int8 resnet50_v1 (quantize_net), batch {INT8_BATCH}"
    with autograd.pause():
        ref = net(x)
        net.hybridize()
        f32_ms = time_ms(torch, lambda: net(x), 10, flush)
        t0 = time.perf_counter()
        q.quantize_net(net, calib_data=calib)
        calib_s = time.perf_counter() - t0
        layers = int8_layers(net)
        expect(net._active, f"{what}: hybridization not restored")
        net.hybridize(active=False)
        seen = []
        hooks = [b.register_forward_hook(
            lambda blk, args, out: seen.append(
                (blk, args[0][:1].detach().float().cpu(),
                 out[:1].detach().cpu()))) for b in layers]
        qops.int8_matmul.launches = 0
        eager = net(x)
        torch.cuda.synchronize()
        gemms = qops.int8_matmul.launches
        for h in hooks:
            h.detach()
        worst = 0.0
        for blk, xin, out in seen:
            want = host_int8(blk, xin)
            err = float((out - want).abs().max() / want.abs().max()
                        .clamp_min(1e-30))
            worst = max(worst, err)
            expect(err <= INT8_LAYER_RTOL, f"{what}: {blk.name} on the "
                   f"card strays {err:.3e} of its scale from the plain int8 "
                   f"product on the host")
        expect(len(seen) == len(layers) == gemms,
               f"{what}: {len(seen)} layers seen, {len(layers)} swapped, "
               f"{gemms} int8 GEMMs")
        net.hybridize()
        hyb = [net(x) for _ in range(3)][-1]
        torch.cuda.synchronize()
        expect(torch.equal(hyb, eager), f"{what}: the captured int8 forward "
               f"is not the eager one's bits")
        int8_ms = time_ms(torch, lambda: net(x), 10, flush)
    rel = float((eager - ref).abs().max() / ref.abs().max())
    log(f"int8 [{what}, {card_line(smi_line)}]: {len(layers)} layers "
        f"swapped (calibration {calib_s:.2f} s over {INT8_CALIB} batches); "
        f"each layer on the card within {worst:.3e} of its scale of the "
        f"plain int8 product on the host (bound {INT8_LAYER_RTOL}); "
        f"{gemms} int8 GEMMs (cuBLASLt, int32 sums) a forward; captured "
        f"= eager bits; whole net int8 vs f32 max err {rel:.4f} of scale; "
        f"forward {int8_ms:.3f} ms int8 vs {f32_ms:.3f} ms f32 "
        f"= {int8_ms / f32_ms:.3f}x (both captured, L2 flushed)")
    del net, calib, layers, seen
    gc.collect()
    torch.cuda.empty_cache()
    float_acc, int8_acc = int8_gate(torch, mx, q)
    return {"int8_ms": int8_ms, "f32_ms": f32_ms, "rel": rel,
            "worst": worst, "float_acc": float_acc, "int8_acc": int8_acc}


# every sampler name: (canonical op, row parameters, kwargs, per-row
# (mean, variance), support check on the draws, default dtype)
def _uniform_mv(lo, hi):
    return (lo + hi) / 2, (hi - lo) ** 2 / 12


def _ints(x):
    return bool((x == x.round()).all()) and bool((x >= 0).all())


SAMPLERS = {
    "_random_uniform": ((), dict(low=2.0, high=5.0), [_uniform_mv(2, 5)],
                        lambda x: bool(((x >= 2) & (x < 5)).all()),
                        "float32"),
    "_random_normal": ((), dict(loc=1.5, scale=2.0), [(1.5, 4.0)], None,
                       "float32"),
    "_random_gamma": ((), dict(alpha=3.0, beta=2.0), [(6.0, 12.0)],
                      lambda x: bool((x > 0).all()), "float32"),
    "_random_exponential": ((), dict(lam=4.0), [(0.25, 1 / 16)],
                            lambda x: bool((x >= 0).all()), "float32"),
    "_random_poisson": ((), dict(lam=3.0), [(3.0, 3.0)], _ints, "float32"),
    "_random_negative_binomial": ((), dict(k=4, p=0.4), [(6.0, 15.0)],
                                  _ints, "float32"),
    "_random_generalized_negative_binomial": (
        (), dict(mu=2.0, alpha=0.5), [(2.0, 4.0)], _ints, "float32"),
    "_random_randint": ((), dict(low=-3, high=9), [(2.5, 143 / 12)],
                        lambda x: bool(((x >= -3) & (x < 9)).all()),
                        "int32"),
    "_sample_uniform": (([0.0, 10.0], [1.0, 20.0]), {},
                        [_uniform_mv(0, 1), _uniform_mv(10, 20)], None,
                        "float32"),
    "_sample_normal": (([-5.0, 5.0], [1.0, 3.0]), {},
                       [(-5.0, 1.0), (5.0, 9.0)], None, "float32"),
    "_sample_gamma": (([2.0, 8.0], [1.0, 0.5]), {}, [(2.0, 2.0), (4.0, 2.0)],
                      lambda x: bool((x > 0).all()), "float32"),
    "_sample_exponential": (([0.5, 4.0],), {}, [(2.0, 4.0), (0.25, 1 / 16)],
                            lambda x: bool((x >= 0).all()), "float32"),
    "_sample_poisson": (([0.5, 4.0],), {}, [(0.5, 0.5), (4.0, 4.0)], _ints,
                        "float32"),
}
SAMPLER_PROBS = [[0.0, 0.1, 0.9], [1.0, 0.0, 0.0], [0.2, 0.3, 0.5],
                 [0.25, 0.25, 0.5]]


def moments_ok(torch, x, mean, var):
    """The mean and variance of the draws ``x`` (on the card, in f64)
    within SAMPLER_SIGMAS standard errors of ``mean`` and ``var``."""
    x = x.double().reshape(-1)
    n = x.numel()
    m = x.mean()
    v = ((x - m) ** 2).mean()
    m4 = ((x - m) ** 4).mean()
    m, v, m4 = (float(t) for t in (m, v, m4))
    se_m = (var / n) ** 0.5
    se_v = (max(m4 - v * v, 1e-30) / n) ** 0.5
    return (abs(m - mean) <= SAMPLER_SIGMAS * se_m and
            abs(v - var) <= SAMPLER_SIGMAS * se_v), (m, v)


def samplers_card(torch):
    """(d) Every sampler name (the registry's 33) draws SAMPLER_DRAWS
    values on the card from the card's generator (the host's generator
    untouched): shape, dtype, support, and mean and variance within
    SAMPLER_SIGMAS standard errors; ``mx.random.seed`` reproduces the
    bits; a hybridized block that draws, captured, gives three different
    draws on three replays."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.ops import registry

    names = sorted(n for n, f in registry.OPS.items()
                   if f.__module__ == "mxnet_tpu_torch.ops.random_ops")
    expect(len(names) == 33, f"samplers: {len(names)} names, expected 33")
    card = mx.gpu()
    host = mxrandom.generator("cpu").get_state()
    canon = {id(registry.OPS[c]): c for c in SAMPLERS}

    def draw(name, n):
        """``name``'s table draw of ``n`` values on the card, and its
        canonical op (None for multinomial and shuffle)."""
        c = canon.get(id(registry.OPS[name]))
        if c is None:
            return None, None
        rows, kw = SAMPLERS[c][:2]
        if rows:
            args = [mx.nd.array(r, ctx=card) for r in rows]
            return c, mx.nd.invoke(name, *args, shape=(n // len(rows[0]),),
                                   **kw)
        return c, mx.nd.invoke(name, shape=(n,), ctx=card, **kw)

    t0 = time.perf_counter()
    checked = []
    for name in names:
        c, out = draw(name, SAMPLER_DRAWS)
        if c is not None:
            rows, kw, moments, support, dtype = SAMPLERS[c]
            x = out._data
            want_shape = (len(moments), SAMPLER_DRAWS // len(moments)) \
                if rows else (SAMPLER_DRAWS,)
            expect(x.device.type == DEVICE and tuple(x.shape) == want_shape
                   and str(out.dtype) == dtype,
                   f"sampler {name}: {tuple(x.shape)} {out.dtype} on "
                   f"{x.device}")
            xs = x.reshape(len(moments), -1)
            for i, (mean, var) in enumerate(moments):
                ok, got = moments_ok(torch, xs[i], mean, var)
                expect(ok, f"sampler {name} row {i}: mean, variance {got} vs "
                       f"({mean}, {var})")
            expect(support is None or support(x),
                   f"sampler {name}: a draw outside the support")
        elif "multinomial" in name:
            probs = mx.nd.array(SAMPLER_PROBS, ctx=card)
            per = SAMPLER_DRAWS // len(SAMPLER_PROBS)
            out, lp = mx.nd.invoke(name, probs, shape=per, get_prob=True)
            x = out._data
            expect(x.device.type == DEVICE and str(out.dtype) == "int32"
                   and tuple(x.shape) == (len(SAMPLER_PROBS), per),
                   f"sampler {name}: {tuple(x.shape)} {out.dtype}")
            for r, row in enumerate(SAMPLER_PROBS):
                for k, p in enumerate(row):
                    ok, got = moments_ok(torch, (x[r] == k).double(), p,
                                         p * (1 - p))
                    expect(ok, f"sampler {name} row {r} class {k}: {got} "
                           f"vs p {p}")
            want_lp = torch.log(torch.tensor(SAMPLER_PROBS, device=DEVICE)
                                .clamp_min(1e-30)).gather(1, x.long())
            expect(torch.allclose(lp._data, want_lp),
                   f"sampler {name}: log probabilities")
        else:                                               # shuffle
            data = mx.nd.arange(SAMPLER_DRAWS, ctx=card, dtype="int32")
            x = mx.nd.invoke(name, data)._data
            expect(x.device.type == DEVICE
                   and torch.equal(torch.sort(x).values, data._data)
                   and not torch.equal(x, data._data),
                   f"sampler {name}: not a permutation")
        checked.append(name)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    expect(torch.equal(host, mxrandom.generator("cpu").get_state()),
           "samplers: the host generator drew for card tensors")

    def draws():
        return [draw(c, 2 ** 16)[1]._data.clone() for c in sorted(SAMPLERS)]
    mx.random.seed(7)
    a = draws()
    mx.random.seed(7)
    b = draws()
    expect(same_bits(a, b), "samplers: mx.random.seed did not reproduce "
           "the bits")

    class Draws(mx.gluon.HybridBlock):
        def forward(self, mu, sigma):
            from mxnet_tpu_torch import ops as F
            return (F._sample_normal(mu, sigma, shape=(4096,)),
                    F._random_uniform(shape=(4096,), ctx=mu.device),
                    F._random_exponential(lam=2.0, shape=(4096,),
                                          ctx=mu.device))

    blk = Draws()
    blk.hybridize()
    mu = torch.zeros(2, device=DEVICE)
    sigma = torch.ones(2, device=DEVICE)
    calls = [[t.clone() for t in blk(mu, sigma)] for _ in range(4)]
    torch.cuda.synchronize()
    replays = calls[1:]
    distinct = all(not torch.equal(replays[i][j], replays[k][j])
                   for j in range(3) for i in range(3) for k in range(i))
    expect(blk.graph_count() == 1 and distinct,
           f"samplers: {blk.graph_count()} graphs; three replays distinct: "
           f"{distinct}")
    log(f"samplers: {len(checked)} names x {SAMPLER_DRAWS} draws on the "
        f"card in {dt:.2f} s (shape, dtype, support, mean and variance "
        f"within {SAMPLER_SIGMAS} standard errors; the host generator "
        f"untouched); mx.random.seed(7) repeats the bits of "
        f"{len(a)} draws; a captured graph drawing normal, uniform and "
        f"exponential values: 3 replays, 3 different draws")
    return len(checked)


def lstm_scan(mx, cell):
    """A hybridizable block that runs ``cell`` over axis 0 by
    ``foreach``."""
    from mxnet_tpu_torch.ops.control_flow import foreach

    class Scan(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.cell = cell

        def forward(self, x, h, c):
            outs, states = foreach(lambda x_t, s: self.cell(x_t, s), x,
                                   [h, c])
            return (outs, *states)
    return Scan()


def control_flow_card(torch):
    """(e) ``foreach`` over an LSTMCell at the LM's widths (LSTM_UNITS,
    batch LSTM_BATCH, LSTM_BPTT steps), eager and hybridized (captured),
    against ``cell.unroll``: the same bits in f32; ``while_loop`` with
    ``max_iterations`` and ``cond`` in a captured graph against eager,
    the same bits, and a replay that reads nothing back
    (``set_sync_debug_mode("error")``)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import control_flow as cf

    mx.random.seed(0)
    cell = mx.gluon.rnn.LSTMCell(LSTM_UNITS, input_size=LSTM_UNITS)
    cell.initialize(ctx=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    x, h, c = (torch.randn(*s, generator=gen, device=DEVICE) for s in
               ((LSTM_BPTT, LSTM_BATCH, LSTM_UNITS),
                (LSTM_BATCH, LSTM_UNITS), (LSTM_BATCH, LSTM_UNITS)))
    with mx.autograd.pause():
        want, (hw, cw) = cell.unroll(LSTM_BPTT, x, begin_state=[h, c],
                                     layout="TNC", merge_outputs=True)
        outs, (hf, cf_) = cf.foreach(lambda x_t, s: cell(x_t, s), x, [h, c])
        eager_same = same_bits([outs, hf, cf_], [want, hw, cw])
        scan = lstm_scan(mx, cell)
        scan.hybridize()
        got = [[t.clone() for t in scan(x, h, c)] for _ in range(3)][-1]
        torch.cuda.synchronize()
    hyb_same = same_bits(got, [want, hw, cw])
    what = (f"foreach over LSTMCell({LSTM_UNITS}), batch {LSTM_BATCH}, "
            f"{LSTM_BPTT} steps, f32")
    expect(eager_same, f"{what}: eager foreach is not cell.unroll's bits")
    gap = max(float((a - b).abs().max())
              for a, b in zip(got, [want, hw, cw]))
    expect(hyb_same, f"{what}: the captured foreach is not cell.unroll's "
           f"bits (max gap {gap:.3e})")

    class LoopCond(mx.gluon.HybridBlock):
        def forward(self, i, s, t, p, a, b):
            i2, s2, t2 = cf.while_loop(
                lambda i, s, t: i < 5, lambda i, s, t: (i + 1, s * 1.5,
                                                        t + s),
                [i, s, t], max_iterations=8)
            return i2, s2, t2, cf.cond(p, lambda a, b: a * b,
                                       lambda a, b: a - b, (a, b))

    args = [torch.zeros((), device=DEVICE),
            torch.randn(256, 256, generator=gen, device=DEVICE),
            torch.randn(256, 256, generator=gen, device=DEVICE),
            torch.ones((), device=DEVICE),
            torch.randn(256, 256, generator=gen, device=DEVICE),
            torch.randn(256, 256, generator=gen, device=DEVICE)]
    blk = LoopCond()
    with mx.autograd.pause():
        eager = [t.clone() for t in blk(*args)]
        blk.hybridize()
        for _ in range(2):
            blk(*args)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            captured = [t.clone() for t in blk(*args)]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    expect(float(eager[0]) == 5.0 and same_bits(captured, eager)
           and blk.graph_count() == 1,
           f"while_loop/cond: captured vs eager differ ({blk.graph_count()} "
           f"graphs, trip count {float(eager[0])})")
    log(f"control flow: {what}, eager and captured: cell.unroll's bits; "
        f"while_loop(max_iterations=8) stopping at 5 and cond in a captured "
        f"graph: the eager bits, a replay without a host sync")


def custom_softmax_card(torch):
    """(f) MXNet's ``custom_softmax`` example as a ``CustomOp`` under a
    Gluon Dense on the card, trained CUSTOM_STEPS SGD steps beside the
    same Dense with the built-in softmax cross-entropy from the same
    start: the weight's gradient within CUSTOM_TOL of its largest
    magnitude every step; the op
    inside ``hybridize()`` raises."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import operator

    class Softmax(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1).reshape((x.shape[0], 1)))
            y /= y.sum(axis=1).reshape((x.shape[0], 1))
            self.assign(out_data[0], req[0], mx.nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().ravel().astype(np.int64)
            y = out_data[0].asnumpy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(y))

    @operator.register("smoke_softmax")
    class SoftmaxProp(operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()

    rng = np.random.RandomState(0)
    card = mx.gpu()
    w0 = (rng.randn(10, 64) * 0.1).astype(np.float32)
    xs = [rng.randn(128, 64).astype(np.float32) for _ in range(CUSTOM_STEPS)]
    ys = [rng.randint(0, 10, 128).astype(np.float32)
          for _ in range(CUSTOM_STEPS)]
    nets, trainers = [], []
    for _ in range(2):
        net = mx.gluon.nn.Dense(10, in_units=64)
        net.initialize(ctx=card)
        net.weight.set_data(w0)
        net.bias.set_data(np.zeros(10, np.float32))
        nets.append(net)
        trainers.append(mx.gluon.Trainer(net.collect_params(), "sgd",
                                         {"learning_rate": 0.1}))
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    worst = 0.0
    for x, y in zip(xs, ys):
        xb, yb = mx.nd.array(x, ctx=card), mx.nd.array(y, ctx=card)
        grads = []
        for custom, net, tr in zip((True, False), nets, trainers):
            with mx.autograd.record():
                out = mx.nd.Custom(net(xb), yb, op_type="smoke_softmax") \
                    if custom else ce(net(xb), yb).sum()
            out.backward()
            grads.append(net.weight.grad()._data.clone())
            tr.step(1)
        expect(grads[0].device.type == DEVICE,
               "custom softmax: the gradient left the card")
        worst = max(worst, float((grads[0] - grads[1]).abs().max()
                                 / grads[1].abs().max()))
    expect(worst <= CUSTOM_TOL, f"custom softmax: gradients {worst:.3e} "
           f"of their scale from the built-in softmax's")

    class Blk(mx.gluon.HybridBlock):
        def forward(self, x, y):
            return mx.nd.Custom(mx.nd.NDArray(x), mx.nd.NDArray(y),
                                op_type="smoke_softmax")._data

    blk = Blk()
    blk.hybridize()
    try:
        blk(mx.nd.array(xs[0], ctx=card), mx.nd.array(ys[0], ctx=card))
        raised = None
    except TypeError as exc:
        raised = str(exc)
    expect(raised is not None and "captured graph" in raised,
           "custom softmax inside hybridize() did not raise")
    log(f"CustomOp: MXNet's custom_softmax trained {CUSTOM_STEPS} SGD steps "
        f"of a Dense(10) on the card; its gradients within {worst:.3e} of "
        f"their scale of the built-in softmax cross-entropy's (bound "
        f"{CUSTOM_TOL}); inside "
        f"hybridize() it raises: {raised[:80]}...")


def one_card_extras(torch, smi_line, trainstep):
    """The one-card extras: (g) ``runtime.Features()``, ``nd.add``'s host
    us a dispatch with AMP off and on; (d) the samplers; (e) control
    flow; (f) the CustomOp; (c) int8; (b) the Estimator; (a) AMP
    BERT-base, the main path.  Returns their numbers."""
    import mxnet_tpu_torch as mx

    log(f"runtime.Features(): {mx.runtime.Features()!r}")
    card = mx.gpu()
    off = dispatch_times(torch, mx, card)["off"]
    mx.amp.init()
    try:
        on = dispatch_times(torch, mx, card)["off"]
    finally:
        mx.amp._deinit_for_tests()
    log(f"nd.add host us a dispatch on {DISPATCH_SHAPE} over "
        f"{DISPATCH_CALLS} calls (storage accounting off): AMP off "
        f"{off:.2f}, AMP on {on:.2f}")
    out = {"dispatch_us": {"amp off": off, "amp on": on}}
    samplers_card(torch)
    control_flow_card(torch)
    custom_softmax_card(torch)
    gc.collect()
    torch.cuda.empty_cache()
    out["int8"] = int8_resnet(torch, smi_line)
    gc.collect()
    torch.cuda.empty_cache()
    out["estimator"] = estimator_resnet(torch, smi_line)
    gc.collect()
    torch.cuda.empty_cache()
    out["amp"] = amp_bert(torch, smi_line, trainstep)
    return out


# ------------------------------------------------- numpy, sparse, ONNX --
def np_bert(torch, smi_line, trainstep):
    """(a) BERT-base in the MXNet 2.0 / GluonNLP 1.x form of
    run_pretraining.py: ``npx.set_np()``, inputs built with ``mx.np``,
    f32 parameters under ``amp.init("float16")``, ``amp.init_trainer`` on
    a ``gluon.Trainer`` with LAMB 1e-3 / wd 0.01, ``net.hybridize()``;
    ``bench_bert``'s width and batch (64 x 128, dropout 0.1,
    ``attention_impl="flash"``).  EXTRAS_WARMUP + EXTRAS_TIMED steps: the
    outputs and the loss ``mx.np.ndarray``, every flash kernel launched
    BERT_LAYERS times a step on bf16 inputs (held against its plain
    version on the path's own q), tokens/s beside ``trainstep``
    (bench_bert's captured TrainStep of this run), busy share, peak
    memory and the losses.  ``set_np`` and AMP are off again after."""
    from mxnet_tpu_torch import amp, npx

    fa = flash_module()
    seen = set()
    launch = fa._launch

    def spy(what, fn, q, *rest):
        seen.add((what.rsplit("_", 1)[1], q.dtype, tuple(q.shape)))
        if what.endswith("fwd") and "q" not in spy.path:
            spy.path["q"] = q.detach().clone()
        return launch(what, fn, q, *rest)

    spy.path = {}
    npx.set_np()
    amp.init("float16")
    fa._launch = spy
    try:
        return _np_bert(torch, fa, seen, spy.path, smi_line, trainstep)
    finally:
        fa._launch = launch
        amp._deinit_for_tests()
        npx.reset_np()


def _np_bert(torch, fa, seen, path, smi_line, trainstep):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, autograd
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTPretrainLoss

    net = build_bert(torch, "flash", BERT_DROPOUT)           # f32, no cast
    params = list(net.collect_params().values())
    tdata, tlabels = bert_batch(torch, BERT_BATCH)
    data = tuple(None if t is None else mx.np.array(t, ctx=mx.gpu())
                 for t in tdata)
    labels = tuple(mx.np.array(t, ctx=mx.gpu()) for t in tlabels)
    loss_blk = BERTPretrainLoss()
    tr = mx.gluon.Trainer(params, "lamb", {"learning_rate": 1e-3,
                                           "wd": 0.01})
    amp.init_trainer(tr)
    types = set()

    def step():
        with autograd.record():
            out = net(*data)
            loss = loss_blk(out[3], out[2], *labels)
            with amp.scale_loss(loss, tr) as scaled:
                scaled.backward()
        tr.step(1)
        types.update(type(o).__module__ + "." + type(o).__name__
                     for o in (*out, loss) if o is not None)
        return loss.detach()

    what = (f"np BERT-base, npx.set_np(), mx.np inputs, f32 parameters, "
            f"amp.init('float16'), batch {BERT_BATCH} x {BERT_SEQ}, "
            f"hybridized, gluon.Trainer LAMB")
    net.hybridize()
    mx.random.seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = dict.fromkeys(FLASH, 0)  # main path starts
    losses = [step() for _ in range(EXTRAS_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step() for _ in range(EXTRAS_TIMED)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(fa.flash_attention.launches)         # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    expect(all(isinstance(v, mx.np.ndarray) for v in losses),
           f"{what}: a loss is not mx.np.ndarray")
    losses = [float(v) for v in losses]
    steps = EXTRAS_WARMUP + EXTRAS_TIMED
    expect(types == {"mxnet_tpu_torch.numpy.ndarray"},
           f"{what}: outputs and loss of types {sorted(types)}, expected "
           f"mx.np.ndarray only")
    expect(all(np.isfinite(losses)), f"{what}: loss not finite {losses}")
    expect(losses[-1] < losses[0], f"{what}: loss did not fall {losses}")
    expect(launches == dict.fromkeys(FLASH, BERT_LAYERS * steps),
           f"{what}: flash launches {launches}, expected {BERT_LAYERS} each "
           f"a step")
    routes = {(k, str(dt_).split(".")[1]) for k, dt_, _ in seen}
    expect(routes == {(k, "bfloat16") for k in FLASH},
           f"{what}: flash kernels launched on {sorted(routes)}, expected "
           f"the bf16 tensor-core route only")
    expect(all(p.tensor().dtype == torch.float32 for p in params),
           f"{what}: a parameter is not f32")
    expect(isinstance(params[0].data(), mx.np.ndarray),
           f"{what}: Parameter.data() is {type(params[0].data())}")
    expect(net.graph_count() == 1, f"{what}: {net.graph_count()} units")
    tok_s = BERT_BATCH * BERT_SEQ * EXTRAS_TIMED / dt
    log(f"train [{what}]: outputs and loss {sorted(types)}; losses "
        f"{[round(v, 4) for v in losses]}; {EXTRAS_TIMED} timed steps in "
        f"{dt:.3f} s = {1e3 * dt / EXTRAS_TIMED:.1f} ms/step = "
        f"{tok_s:.1f} tokens/s; peak device memory {peak / 2**30:.2f} GiB; "
        f"flash launches {launches} on {sorted(seen)}")

    q = path["q"]
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    k, v, do = (torch.randn(q.shape, generator=gen, device=DEVICE)
                .to(q.dtype) for _ in range(3))
    args = (q.shape[-1] ** -0.5, False, BERT_DROPOUT,
            fa.seed_tensor(FLASH_SEED, q.device))
    before = dict(fa.flash_attention.launches)
    got, (lse, delta) = flash_kernels(fa, q, k, v, do, args)
    want = flash_plain(fa, q, k, v, do, lse, delta, args, torch.float64)
    torch.cuda.synchronize()
    fa.flash_attention.launches = before        # a check, not the path
    errs = {kern: check_outputs(torch, f"{what}, path tensors", kern,
                                got[kern], want[kern]) for kern in FLASH}
    log(f"flash vs plain [np path: q {tuple(q.shape)} {q.dtype} as the "
        f"path's first forward launch got it, k/v/dO seeded]: max abs err "
        + ", ".join(f"{kern} {e:.3e}" for kern, e in errs.items()))
    prof, wall_us, _ = profiled(torch, step, what)
    busy = print_profile(prof, wall_us, what)
    del prof
    ratio = tok_s / trainstep["tok_s"] if trainstep else float("nan")
    log(f"np BERT [{card_line(smi_line)}]: {tok_s:.1f} tokens/s (busy "
        f"{100 * busy:.1f}%, peak {peak / 2**30:.2f} GiB) vs bench_bert's "
        f"captured bf16 TrainStep "
        + (f"{trainstep['tok_s']:.1f} tokens/s = {ratio:.3f}x"
           if trainstep else "not run in this call"))
    net.hybridize(active=False)
    return {"tok_s": tok_s, "ms_step": 1e3 * dt / EXTRAS_TIMED,
            "busy": busy, "peak": peak, "launches": launches,
            "ratio": ratio, "flash_err": errs, "losses": losses}


def mf_batches(torch):
    """MF_STEPS seeded batches of (user, item, rating) on the card: users
    uniform, items Zipf(MF_ZIPF) over the item table (popular items recur
    every batch, the tail rarely), ratings 1-5."""
    rng = np.random.RandomState(7)
    out = []
    for _ in range(MF_STEPS):
        users = rng.randint(0, MF_USERS, MF_BATCH).astype(np.int32)
        items = ((rng.zipf(MF_ZIPF, MF_BATCH) - 1) % MF_ITEMS).astype(
            np.int32)
        ratings = rng.randint(1, 6, MF_BATCH).astype(np.float32)
        out.append(tuple(torch.from_numpy(x).to(DEVICE)
                         for x in (users, items, ratings)))
    return out


def mf_run(torch, mx, sparse_grad, batches, check=False):
    """MF_STEPS steps of the factorisation: two Embedding tables (user,
    item) of MF_FACTORS, the prediction their rows' dot product, L2 loss,
    gluon.Trainer SGD (MF_SGD).  Returns the tables (at the start, after
    the first step, at the end), the losses and ms a step over the steps
    after the first two.  With ``check`` (a sparse run) every step is
    also held against ``LazySGDReference`` fed the step's dense gradient,
    and the row_sparse gradient's rows against the gradient's nonzero
    rows; the returned ms then counts those checks and is not kept."""
    from mxnet_tpu_torch import autograd, gluon

    mx.random.seed(3)
    with gluon.nn.HybridSequential(prefix="mf_").name_scope():
        user = gluon.nn.Embedding(MF_USERS, MF_FACTORS,
                                  sparse_grad=sparse_grad)
        item = gluon.nn.Embedding(MF_ITEMS, MF_FACTORS,
                                  sparse_grad=sparse_grad)
    blocks = (user, item)
    for blk in blocks:
        blk.initialize(mx.init.Normal(0.1), ctx=mx.gpu())
    start = [blk.weight.tensor().detach().clone() for blk in blocks]
    refs = [LazySGDReference(torch, w) for w in start] if check else None
    params = list(user.collect_params().values()) + \
        list(item.collect_params().values())
    tr = gluon.Trainer(params, "sgd", dict(MF_SGD))
    l2 = gluon.loss.L2Loss()
    losses = []
    torch.cuda.synchronize()
    for i, (u, it, r) in enumerate(batches):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        u, it, r = (mx.nd.NDArray(x) for x in (u, it, r))
        with autograd.record():
            pred = (user(u) * item(it)).sum(axis=1)
            loss = l2(pred, r)
        loss.backward()
        if check:
            grads = [blk.weight._dense_grad()._data.clone()
                     for blk in blocks]
            rows = []
            for blk in blocks:
                g = blk.weight.grad()
                expect(g.stype == "row_sparse", f"grad stype {g.stype}")
                rows.append(g._indices.long())
        tr.step(MF_BATCH)
        losses.append(loss.mean())
        if check:
            for k, blk in enumerate(blocks):
                refs[k].step(grads[k], rows[k],
                             blk.weight.tensor().detach(), i)
        if i == 0:
            first = [blk.weight.tensor().detach().clone() for blk in blocks]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / (MF_STEPS - 2)
    return {"tables": [blk.weight.tensor().detach() for blk in blocks],
            "start": start, "first": first, "refs": refs,
            "losses": [float(v) for v in losses], "ms": ms}


class LazySGDReference:
    """The plain lazy momentum SGD of one table (MF_SGD, gradients
    rescaled by 1 / MF_BATCH), on dense tensors and written apart from
    ``sparse``: a step's rows are those where its dense gradient has a
    nonzero entry; only they take weight decay, momentum and the
    update, every other row keeps its weight and its momentum.  ``step``
    advances it and holds the card's table after the same step within
    MF_RTOL of the table's scale, and the row_sparse gradient's rows
    against this step's rows."""

    def __init__(self, torch, start):
        self.torch = torch
        self.w = start.clone()
        self.mom = torch.zeros_like(start)
        self.touched = torch.zeros(start.shape[0], dtype=torch.bool,
                                   device=start.device)
        self.first_rows = None
        self.gap = 0.0

    def step(self, grad, rows, table, i):
        torch = self.torch
        mask = (grad != 0).any(1)
        want_rows = mask.nonzero().reshape(-1)
        expect(torch.equal(torch.sort(rows).values, want_rows),
               f"step {i}: the row_sparse gradient's {rows.numel()} rows "
               f"are not the dense gradient's {want_rows.numel()} nonzero "
               f"rows")
        lr, momentum, wd = (MF_SGD[k] for k in
                            ("learning_rate", "momentum", "wd"))
        mom = momentum * self.mom - lr * (grad * (1.0 / MF_BATCH)
                                          + wd * self.w)
        self.mom = torch.where(mask[:, None], mom, self.mom)
        self.w = torch.where(mask[:, None], self.w + self.mom, self.w)
        self.touched |= mask
        if self.first_rows is None:
            self.first_rows = want_rows
        scale = float(self.w.abs().max())
        gap = float((table - self.w).abs().max())
        expect(gap <= MF_RTOL * scale,
               f"step {i}: the lazy table {gap:.3e} from the plain lazy "
               f"reference, beyond {MF_RTOL} x {scale:.3e}")
        self.gap = max(self.gap, gap)


def sparse_factorization(torch, smi_line):
    """(b) The sparse-gradient factorisation (MXNet 1.x's
    example/sparse/matrix_factorization, MovieLens-10M's 71,567 users and
    10,681 items, 128 factors, batches of 8192 seeded pairs with Zipf
    item ids, gluon.Trainer SGD 0.1 / 0.9 / 1e-4, MF_STEPS steps) with
    ``Embedding(sparse_grad=True)``: the lazy update.  A checked run holds
    every step against the plain lazy reference within MF_RTOL; after
    the first step (from the same start, the same arithmetic on the rows
    it touched) those rows are within MF_RTOL of the dense-gradient
    run's and every other row has the start's bits; after all steps the
    rows no step touched still have the start's bits (the dense run's
    weight decay and momentum move them).  ms a step of a second lazy
    run, which checks nothing, and of the dense run."""
    import mxnet_tpu_torch as mx

    batches = mf_batches(torch)
    checked = mf_run(torch, mx, True, batches, check=True)
    lazy = mf_run(torch, mx, True, batches)
    dense = mf_run(torch, mx, False, batches)
    what = (f"factorisation {MF_USERS} users x {MF_ITEMS} items x "
            f"{MF_FACTORS}, batch {MF_BATCH}, Zipf({MF_ZIPF}) items, SGD "
            f"{MF_SGD}")
    expect(all(np.isfinite(checked["losses"] + lazy["losses"]
                           + dense["losses"])),
           f"{what}: losses not finite")
    notes = []
    for k, name in enumerate(("user", "item")):
        start, ref = checked["start"][k], checked["refs"][k]
        expect(torch.equal(start, dense["start"][k]),
               f"{what}: the two runs start from different {name} tables")
        scale = float(dense["first"][k].abs().max())
        step1 = ref.first_rows
        rest1 = torch.ones_like(ref.touched)
        rest1[step1] = False
        gap1 = float((checked["first"][k][step1]
                      - dense["first"][k][step1]).abs().max())
        kept1 = torch.equal(checked["first"][k][rest1], start[rest1])
        expect(kept1 and gap1 <= MF_RTOL * scale,
               f"{what}: after the first step the {name} rows it left kept "
               f"their bits: {kept1}; the rows it touched {gap1:.3e} from "
               f"the dense run (bound {MF_RTOL} x {scale:.3e})")
        never = (~ref.touched).nonzero().reshape(-1)
        kept = torch.equal(checked["tables"][k][never], start[never])
        moved = float((dense["tables"][k][never] - start[never]).abs()
                      .max()) if never.numel() else 0.0
        expect(kept, f"{what}: {name} rows no step touched changed in the "
               f"sparse run")
        notes.append(f"{name}: step 1 touched {step1.numel()} rows "
                     f"({gap1:.3e} from dense), the rest the start's bits; "
                     f"every step within {ref.gap:.3e} of the plain lazy "
                     f"reference (bound {MF_RTOL} of the scale); after "
                     f"{MF_STEPS} steps {never.numel()} rows never touched "
                     f"(the start's bits; dense moved them up to "
                     f"{moved:.3e})")
    log(f"sparse [{what}]: " + "; ".join(notes))
    log(f"sparse [{what}, {card_line(smi_line)}]: row_sparse (lazy) "
        f"{lazy['ms']:.3f} ms/step vs dense {dense['ms']:.3f} ms/step = "
        f"{lazy['ms'] / dense['ms']:.3f}x (no check in either timed run); "
        f"losses lazy {[round(v, 4) for v in lazy['losses'][::5]]} dense "
        f"{[round(v, 4) for v in dense['losses'][::5]]}")
    return {"lazy_ms": lazy["ms"], "dense_ms": dense["ms"]}


def csr_dot(torch, smi_line):
    """``sparse.dot`` of a seeded CSR batch of Criteo's shape (CSR_ROWS x
    CSR_COLS, CSR_NNZ nonzeros a row: its 39 fields, hashed) with a dense
    (CSR_COLS, 1) weight, against the dense gather-sum of the same
    entries within CSR_RTOL of its scale; its ms (CUDA events)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import sparse

    rng = np.random.RandomState(8)
    cols = np.sort(rng.randint(0, CSR_COLS, (CSR_ROWS, CSR_NNZ)), 1)
    vals = rng.rand(CSR_ROWS, CSR_NNZ).astype(np.float32)
    indptr = np.arange(0, CSR_ROWS * CSR_NNZ + 1, CSR_NNZ, dtype=np.int32)
    dev = torch.device(DEVICE)
    csr = sparse.csr_matrix((torch.from_numpy(vals.ravel()).to(dev),
                             torch.from_numpy(cols.ravel().astype(
                                 np.int32)).to(dev),
                             torch.from_numpy(indptr).to(dev)),
                            shape=(CSR_ROWS, CSR_COLS))
    w = torch.randn(CSR_COLS, 1, generator=torch.Generator(
        device=DEVICE).manual_seed(9), device=DEVICE)
    wnd = mx.nd.NDArray(w)
    got = sparse.dot(csr, wnd)._data
    ci = torch.from_numpy(cols).to(dev).long()
    vd = torch.from_numpy(vals).to(dev)
    want = (w[ci, 0] * vd).sum(1, keepdim=True)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    expect(got.shape == (CSR_ROWS, 1), f"csr dot shape {tuple(got.shape)}")
    expect(err <= CSR_RTOL * scale, f"csr dot {err:.3e} from the dense "
           f"gather-sum, beyond {CSR_RTOL} x {scale:.3e}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    ms = time_ms(torch, lambda: sparse.dot(csr, wnd), 20, flush)
    plain = time_ms(torch, lambda: (w[ci, 0] * vd).sum(1), 20, flush)
    log(f"csr dot [{CSR_ROWS} x {CSR_COLS}, {CSR_NNZ} a row, "
        f"{card_line(smi_line)}]: {ms:.4f} ms vs the dense gather-sum "
        f"{plain:.4f} ms; {err:.3e} from it (scale {scale:.3e})")
    return {"ms": ms, "err": err, "plain": plain}


def onnx_resnet(torch, smi_line, tmp):
    """(c) An ONNX round trip of ResNet-50 v1 (the model zoo's, NCHW, f32,
    ``fused=False``: the symbolic phase's net) on the card at each of
    ONNX_BATCHES: ``onnx.export_model`` on the card, then
    ``onnx.import_to_function`` run on card tensors; ONNX_IMAGES seeded
    images through the block and the imported function (at batch 1 one
    by one, at batch 64 among the batch) within ONNX_RTOL of the logits'
    scale; numpy inputs under ``mx.gpu()`` run on the card with the card
    inputs' bits; a call makes no synchronizing copy (sync debug mode
    "error"); export seconds, file size, and the imported function's ms
    against the block's (CUDA events)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, initializer
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    initializer.seed(0)
    net = resnet50_v1()
    net.initialize(ctx=mx.gpu())
    images = np.random.RandomState(12).rand(
        max(ONNX_BATCHES), 3, 224, 224).astype(np.float32)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    out = {}
    for n in ONNX_BATCHES:
        x = torch.from_numpy(images[:n]).to(DEVICE)
        path = os.path.join(tmp, f"resnet50_v1_b{n}.onnx")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mx.onnx.export_model(net, x, path)
        export_s = time.perf_counter() - t0
        fn = mx.onnx.import_to_function(path)
        with autograd.pause():
            errs = []
            for i in range(ONNX_IMAGES if n == 1 else 1):
                xi = torch.from_numpy(images[i:i + n]).to(DEVICE)
                ref = net(xi)[:ONNX_IMAGES]
                got = fn(xi)[0][:ONNX_IMAGES]
                expect(tuple(got.shape) == tuple(ref.shape) and
                       got.device.type == "cuda",
                       f"onnx b{n}: {tuple(got.shape)} on {got.device}")
                errs.append(float((got - ref).abs().max())
                            / float(ref.abs().max()))
            err = max(errs)
            expect(err <= ONNX_RTOL, f"onnx b{n}: the imported function "
                   f"{err:.3e} of the logits' scale from the block")
            with mx.gpu():
                from_np = fn(images[:n])[0]
            np_err = float((from_np - fn(x)[0]).abs().max()) / float(
                from_np.abs().max())
            expect(from_np.device.type == "cuda" and np_err <= ONNX_RTOL,
                   f"onnx b{n}: numpy inputs under mx.gpu() ran on "
                   f"{from_np.device}, {np_err:.3e} from card inputs")
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn(x)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            ms_fn = time_ms(torch, lambda: fn(x), 10, flush)
            ms_blk = time_ms(torch, lambda: net(x), 10, flush)
        size = os.path.getsize(path)
        os.remove(path)
        out[n] = {"export_s": export_s, "bytes": size, "ms": ms_fn,
                  "block_ms": ms_blk, "err": err}
        log(f"onnx [ResNet-50 v1 NCHW f32 batch {n}, {card_line(smi_line)}]"
            f": export {export_s:.2f} s, {size / 2**20:.1f} MiB, "
            f"{ONNX_IMAGES} images within {err:.3e} of the logits' scale; "
            f"imported function {ms_fn:.3f} ms vs the block {ms_blk:.3f} "
            f"ms = {ms_fn / ms_blk:.3f}x")
    return out


def numpy_sparse_onnx(torch, smi_line, trainstep):
    """The phase "numpy, sparse, ONNX": ``nd.add``'s host us with
    NaiveEngine unset (and set), (a) np BERT-base, (b) the factorisation
    and the CSR dot, (c) the ONNX round trip.  Returns their numbers."""
    import mxnet_tpu_torch as mx

    card = mx.gpu()
    off = dispatch_times(torch, mx, card)["off"]
    mx.engine.set_naive(True)
    try:
        naive = dispatch_times(torch, mx, card)["off"]
    finally:
        mx.engine.set_naive(False)
    log(f"nd.add host us a dispatch on {DISPATCH_SHAPE} over "
        f"{DISPATCH_CALLS} calls (storage accounting off): NaiveEngine "
        f"unset {off:.2f}, set {naive:.2f}")
    out = {"dispatch_us": {"naive unset": off, "naive set": naive}}
    out["np"] = np_bert(torch, smi_line, trainstep)
    gc.collect()
    torch.cuda.empty_cache()
    out["sparse"] = sparse_factorization(torch, smi_line)
    out["csr"] = csr_dot(torch, smi_line)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out["onnx"] = onnx_resnet(torch, smi_line, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ data parallel --
def dp_topology(torch):
    """The gangs the card machine allows: ``(ranks, what)``.  Several
    cards: one rank a card over NCCL.  One card: two ranks sharing it
    over gloo (the backend rule gives NCCL only where every rank has a
    card of its own); the world of one over NCCL runs in this process
    either way (``dp_reference``)."""
    count = torch.cuda.device_count()
    if count >= 2:
        return count, f"{count} ranks, one card each, over NCCL"
    return 2, "2 ranks sharing the one card over gloo"


def dp_batch(torch, rank, world, device):
    """bench_resnet's global batch (RandomState(0), DP_BATCH of 224x224x3,
    1000 classes), this rank's rows of it on ``device``, in bf16."""
    rng = np.random.RandomState(0)
    xh = rng.randn(DP_BATCH, 224, 224, 3).astype(np.float32)
    yh = rng.randint(0, 1000, (DP_BATCH,)).astype(np.int32)
    b = DP_BATCH // world
    x = torch.from_numpy(xh[rank * b:(rank + 1) * b]).to(device)
    y = torch.from_numpy(yh[rank * b:(rank + 1) * b]).to(device)
    return x.to(torch.bfloat16), y


def dp_leaves(step):
    """The step's parameters and running statistics by name, and their
    kinds (a ``hold_leaves`` table)."""
    names = step._names
    out = {}
    for i, t in zip(step._train_idx, step._train):
        out[names[i]] = ("parameter", t)
    for i, t in zip(step._aux_idx, step._aux):
        out[names[i]] = ("running statistic", t)
    return out


def same_across_ranks(torch, tensors):
    """Whether every rank holds rank 0's bits of ``tensors`` (one
    broadcast per dtype)."""
    from mxnet_tpu_torch import distributed

    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t.detach().reshape(-1))
    same = True
    for ts in by_dtype.values():
        flat = torch.cat(ts)
        ref = distributed.broadcast(flat, root=0)
        same = same and torch.equal(ref.to(flat.device), flat)
    return same


def dp_profile(torch, fn, what):
    """One profiled call: ms of the device's collective work (NCCL kernels;
    over gloo the host staging copies, the reduction itself running on
    the host), the device's busy share of the call's wall time."""
    prof, wall_us, _ = profiled(torch, fn, what)
    rows = device_rows(prof)
    busy = print_profile(prof, wall_us, what, rows)
    nccl = sum(device_us(e) for e in rows if "nccl" in e.key.lower()) / 1e3
    copies = sum(device_us(e) for e in rows
                 if "memcpy" in e.key.lower()) / 1e3
    del prof
    return {"busy": busy, "nccl_ms": nccl, "copy_ms": copies,
            "wall_ms": wall_us / 1e3}


def step_tensors(step):
    """Every tensor a step's update reads and writes: parameters, running
    statistics, optimizer states and the count."""
    return (list(step._train) + list(step._aux)
            + [s for st in step._states for s in st] + [step._t])


def snapshot(step):
    return [t.detach().clone() for t in step_tensors(step)]


def load_snapshot(torch, step, snap):
    with torch.no_grad():
        for t, v in zip(step_tensors(step), snap):
            t.copy_(v)


@contextlib.contextmanager
def f32_wire():
    """Inside the block, the explicit path's gradient exchange
    (``quantize.reduce_gradients``) moves f32 whatever mode it is asked
    for: the yardstick that isolates a mode's quantization from the
    explicit path's own semantics (per-shard batch statistics)."""
    from mxnet_tpu_torch.parallel import quantize

    exchange = quantize.reduce_gradients

    def plain(grads, axis_name, n_dev, mode="int8", key=None,
              reduce="mean", chunk=quantize.DEFAULT_CHUNK):
        return exchange(grads, axis_name, n_dev, mode="f32", reduce=reduce)
    quantize.reduce_gradients = plain
    try:
        yield
    finally:
        quantize.reduce_gradients = exchange


def dp_resnet(torch, modes, save=None):
    """The fused bf16 ResNet-50 (bench_resnet's settings; the loss's
    softmax cross-entropy taken in f32, so that its value resolves the
    gates below bf16's 2**-8) through ``TrainStep(mesh=make_mesh(),
    grad_reduce=mode)`` for each of ``modes``: DP_WARMUP + DP_TIMED
    steps on this rank's rows of the global batch.  Per run: the
    losses, ms/step, launches of each fused kernel a step, whether every
    rank holds the same parameters, running statistics and losses.  The
    f32 run's leaves after its first step go to ``save`` (an ``.npz``) on
    rank 0, and rank 0 profiles one more f32 step.

    The bf16 and int8 runs are also held step by step: from the net's
    parameters and then from the f32 run's state after each of its
    updates, one update of the mode and one of its yardstick (the same
    explicit path, its exchange moving f32: ``f32_wire``), then the loss
    at the parameters each leaves, taken by the f32 step's forward; the
    relative gap between the two is what the mode's quantization did in
    one update (``stepwise``).  The gaps to the f32 run's own next loss
    (``vs_implicit``) carry the explicit path's per-shard batch
    statistics too."""
    from mxnet_tpu_torch import distributed, gluon, optimizer, parallel
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.ops.fused_conv import norm_relu_conv

    rank, world = distributed.rank(), distributed.num_workers()
    device = distributed.device()
    net = build_resnet50(torch, fused=True, device=device).cast("bfloat16")
    x, y = dp_batch(torch, rank, world, device)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def loss_fn(out, label):
        return ce(out.float(), label)

    runs, f32_step, snaps = {}, None, []
    steps = DP_WARMUP + DP_TIMED
    for label in modes:
        mode = label.split("-")[0]
        mxrandom.seed(0)          # each run's rounding stream from one seed
        step = parallel.TrainStep(
            net, loss_fn, optimizer.create("sgd", learning_rate=0.1,
                                           momentum=0.9, wd=1e-4),
            mesh=parallel.make_mesh(), grad_reduce=mode)
        distributed.barrier()
        norm_relu_conv.launches = dict.fromkeys(FUSED, 0)  # the path starts
        losses = []
        for i in range(DP_WARMUP):
            losses.append(float(step(x, y)))
            if i == 0:          # the parameters after the first update
                first = [t.detach().clone() for t in step._train + step._aux]
            if label == "f32" and i == 0:
                snaps.append(snapshot(step))
                if save is not None and rank == 0:
                    np.savez(save, **{
                        n: t.detach().float().cpu().numpy()
                        for n, (_, t) in dp_leaves(step).items()},
                        **{f"kind:{n}": np.array(k)
                           for n, (k, _) in dp_leaves(step).items()})
        torch.cuda.synchronize()
        distributed.barrier()
        t0 = time.perf_counter()
        timed = [step(x, y) for _ in range(DP_TIMED)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(norm_relu_conv.launches)           # ... and ends
        losses += [float(v) for v in timed]
        leaves = dp_leaves(step)
        same = same_across_ranks(
            torch, [t for _, t in leaves.values()]
            + [torch.tensor(losses, dtype=torch.float64)])
        run = runs[label] = {
            "losses": losses, "ms_step": 1e3 * dt / DP_TIMED,
            "per_step": {k: v / steps for k, v in launches.items()},
            "same": bool(same), "graphs": step.graph_count(),
            "finite": all(bool(torch.isfinite(t).all())
                          for _, t in leaves.values())}
        log(f"dp resnet [rank {rank}/{world} {distributed.backend()}, "
            f"grad_reduce={mode}, local batch {DP_BATCH // world}]: losses "
            f"{[round(v, 5) for v in losses]}; {1e3 * dt / DP_TIMED:.1f} "
            f"ms/step; launches {launches}; graphs {step.graph_count()}; "
            f"ranks {'the same bits' if same else 'DIFFER'}")
        if label == "f32":
            # the reference of the step-by-step gates: from the state
            # after the first update, the run again, a snapshot after
            # each update and the loss at it (run["again"][k]: after
            # k + 1 updates)
            f32_step = step
            load_snapshot(torch, step, snaps[0])
            run["again"] = []
            for _ in range(steps - 1):
                run["again"].append(float(step(x, y)))
                snaps.append(snapshot(step))
            run["again"].append(float(step(x, y)))
            what = (f"dp f32 step, rank {rank}/{world} over "
                    f"{distributed.backend()}, local batch "
                    f"{DP_BATCH // world}")
            if rank == 0:
                run["profile"] = dp_profile(
                    torch, lambda: float(step(x, y)), what)
            else:
                float(step(x, y))
        elif mode != "f32" and label == mode and f32_step is not None:
            # step by step from the f32 run's states: one update of the
            # mode, and one of its yardstick (the same explicit path,
            # eager, its exchange moving f32), each then evaluated by the
            # f32 step's forward
            yard = parallel.TrainStep(
                net, loss_fn, optimizer.create("sgd", learning_rate=0.1,
                                               momentum=0.9, wd=1e-4),
                mesh=parallel.make_mesh(), grad_reduce=mode, capture=False)

            def evaluate(tensors):
                with torch.no_grad():
                    for t, v in zip(f32_step._train + f32_step._aux,
                                    tensors):
                        t.copy_(v)
                return float(f32_step(x, y))

            with f32_wire():
                yard(x, y)          # its first update, from the net's own
            got, want = [evaluate(first)], [evaluate(yard._train
                                                     + yard._aux)]
            implicit = runs["f32"]["losses"][1:2] + runs["f32"]["again"][1:]
            for snap in snaps[:-1]:
                for st, out, wire in ((step, got, contextlib.nullcontext),
                                      (yard, want, f32_wire)):
                    load_snapshot(torch, st, snap)
                    with wire():
                        st(x, y)
                    out.append(evaluate(st._train + st._aux))
            run["stepwise"] = [abs(a - b) / abs(b) for a, b in zip(got, want)]
            run["vs_implicit"] = [abs(a - b) / abs(b)
                                  for a, b in zip(got, implicit)]
            run["yard_vs_implicit"] = [abs(a - b) / abs(b)
                                       for a, b in zip(want, implicit)]
            log(f"dp resnet [rank {rank}, grad_reduce={mode}]: step by step "
                f"from the f32 run's states, the next loss's relative gap "
                f"to the f32 wire {[f'{g:.2e}' for g in run['stepwise']]}, "
                f"to the f32 run {[f'{g:.2e}' for g in run['vs_implicit']]}")
            del yard
        if step is not f32_step:
            del step
        del leaves, first
        torch.cuda.empty_cache()
    del f32_step, snaps, net
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def dp_precision_floor(torch, save):
    """The bf16 noise floor of a leaf one step from the same parameters:
    the world of one's bf16 step against the same step in f32 from the
    same (bf16-rounded) parameters and batch, eager on one card.  Writes
    the f32 leaves after the first update to ``save``; returns the loss
    at them."""
    from mxnet_tpu_torch import gluon, optimizer, parallel

    net = build_resnet50(torch, fused=True).cast("bfloat16").cast("float32")
    x, y = dp_batch(torch, 0, 1, DEVICE)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    step = parallel.TrainStep(
        net, lambda out, label: ce(out.float(), label),
        optimizer.create("sgd", learning_rate=0.1, momentum=0.9, wd=1e-4),
        capture=False)
    step(x.float(), y)
    np.savez(save, **{n: t.detach().float().cpu().numpy()
                      for n, (_, t) in dp_leaves(step).items()})
    loss = float(step(x.float(), y))
    del step, net
    gc.collect()
    torch.cuda.empty_cache()
    return loss


def dp_bert(torch, kvstore):
    """BERT-base (flash, dropout BERT_DROPOUT, bf16 with f32 masters,
    hybridized) through ``gluon.Trainer(kvstore=...)`` with LAMB 1e-3 /
    wd 0.01 on this rank's rows of bench_bert's global batch, DP_WARMUP
    + DP_TIMED steps: losses, ms/step, flash launches a step, whether
    every rank ends on the same parameters."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, distributed

    fa = flash_module()
    rank, world = distributed.rank(), distributed.num_workers()
    device = distributed.device()
    net = build_bert(torch, "flash", BERT_DROPOUT, device=device)
    net.cast("bfloat16")
    net.hybridize()
    params = list(net.collect_params().values())
    tr = mx.gluon.Trainer(params, "lamb", {"learning_rate": 1e-3,
                                           "wd": 0.01,
                                           "multi_precision": True},
                          kvstore=kvstore)
    tdata, tlabels = bert_batch(torch, BERT_BATCH, device=device)
    b = BERT_BATCH // world

    def rows(t):
        return None if t is None else mx.nd.NDArray(t[rank * b:(rank + 1)
                                                      * b])
    data = tuple(rows(t) for t in tdata)
    labels = tuple(rows(t) for t in tlabels)
    loss_fn = bert_loss_fn()

    def step():
        with autograd.record():
            loss = loss_fn(net(*data), labels)
        loss.backward()
        tr.step(world)       # the gradients summed over the ranks / world
        return loss

    mx.random.seed(1)
    distributed.barrier()
    fa.flash_attention.launches = dict.fromkeys(FLASH, 0)  # the path starts
    losses = [float(step().asnumpy()) for _ in range(DP_WARMUP)]
    torch.cuda.synchronize()
    distributed.barrier()
    t0 = time.perf_counter()
    timed = [step() for _ in range(DP_TIMED)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(fa.flash_attention.launches)         # ... and ends here
    losses += [float(v.asnumpy()) for v in timed]
    steps = DP_WARMUP + DP_TIMED
    same = same_across_ranks(torch, [p.tensor() for p in params])
    out = {"losses": losses, "ms_step": 1e3 * dt / DP_TIMED,
           "per_step": {k: v / steps for k, v in launches.items()},
           "same": bool(same), "units": net.graph_count(),
           "finite": all(bool(torch.isfinite(p.tensor()).all())
                         for p in params)}
    log(f"dp bert [rank {rank}/{world} {distributed.backend()}, kvstore "
        f"{kvstore}, local batch {b} x {BERT_SEQ}]: losses "
        f"{[round(v, 4) for v in losses]}; {1e3 * dt / DP_TIMED:.1f} "
        f"ms/step; flash launches {launches}; parameters "
        f"{'the same bits' if same else 'DIFFER'} across ranks")
    net.hybridize(active=False)
    del net, tr, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dp_worker(torch, root, outdir, task):
    """One rank of a gang the phase launches (``python3 chip_smoke.py
    --dp-worker <outdir> <task>`` under ``mxnet_tpu_torch.launch``):
    ``train`` runs the ResNet-50 and BERT runs, ``example`` runs
    ``examples/dist_train.py`` as written.  Writes ``<task>-r<rank>.json``
    into ``outdir``."""
    import mxnet_tpu_torch  # noqa: F401  (joins the gang at import)
    from mxnet_tpu_torch import distributed
    from mxnet_tpu_torch.ops import cuda as kcuda

    rank, world = distributed.rank(), distributed.num_workers()
    device = distributed.device()
    res = {"rank": rank, "world": world, "backend": distributed.backend(),
           "card": device.index, "cards_seen": torch.cuda.device_count(),
           "name": torch.cuda.get_device_name(device)}
    log(f"dp topology: rank {rank}/{world} over {res['backend']} on "
        f"cuda:{device.index} ({res['name']}) of {res['cards_seen']} "
        f"cards seen")
    kcuda.build_all()           # the phase built them: this loads them
    if task == "mp":
        if rank == 0:
            warm_profiler(torch)
        res["mp"] = mp_worker(torch, outdir)
    elif task == "train":
        if rank == 0:
            warm_profiler(torch)
        res["resnet"] = dp_resnet(
            torch, ("f32", "bf16", "int8", "int8-again"),
            save=os.path.join(outdir, "gang-f32.npz"))
        res["bert"] = dp_bert(torch, "dist_sync_device")
    elif task == "tp":
        res["mp"] = mp_worker(torch, outdir, runs=("tp",))
    else:
        res["example"] = run_example(root, "dist_train", [])
        res["bert_pretrain"] = bert_pretrain_example(torch, root)
    with open(os.path.join(outdir, f"{task}-r{rank}.json"), "w") as f:
        json.dump(res, f)
    distributed.barrier("done", timeout=120)
    return 0


def dp_reference(torch, outdir):
    """The world of one over NCCL in this process: ``distributed.init``
    with a coordinator and one process, then the f32 ResNet-50 on the
    whole global batch through the same ``TrainStep(mesh=make_mesh())``
    — its collectives real NCCL calls of a group of one, captured in the
    step's graph — and BERT-base under a local store; the group is left
    again after."""
    import socket

    from mxnet_tpu_torch import distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.init(coordinator=f"127.0.0.1:{port}", num_processes=1,
                     process_id=0)
    try:
        expect(distributed.backend() == "nccl",
               f"a world of one on a card runs over "
               f"{distributed.backend()}, not NCCL")
        log(f"dp topology: the world of one over {distributed.backend()} on "
            f"cuda:{distributed.device().index}")
        ref = {"resnet": dp_resnet(torch, ("f32",), save=os.path.join(
            outdir, "ref-f32.npz")), "bert": dp_bert(torch, "device")}
    finally:
        distributed.shutdown()
    ref["f32_loss"] = dp_precision_floor(torch, os.path.join(outdir,
                                                             "ref32.npz"))
    expect(ref["resnet"]["f32"]["graphs"] == 1,
           f"the world of one's step holds {ref['resnet']['f32']['graphs']}"
           f" graphs, not 1 (its NCCL collectives captured)")
    return ref


def dp_hold(torch, ranks, ref, world, outdir):
    """The phase's checks over the gang's results and the world of one."""
    per_step = dict.fromkeys(FUSED, FUSED_PER_STEP)
    for r in ranks:
        for label, run in r["resnet"].items():
            expect(run["same"], f"dp resnet {label}: rank {r['rank']}'s "
                   f"parameters, statistics or losses differ from rank 0's")
            expect(run["finite"] and all(np.isfinite(run["losses"])),
                   f"dp resnet {label}: not finite on rank {r['rank']}")
            expect(run["per_step"] == per_step,
                   f"dp resnet {label}: rank {r['rank']} launched "
                   f"{run['per_step']} a step, expected {per_step}")
        expect(r["bert"]["same"], f"dp bert: rank {r['rank']}'s parameters "
               f"differ from rank 0's")
        expect(r["bert"]["per_step"] == dict.fromkeys(FLASH, BERT_LAYERS),
               f"dp bert: rank {r['rank']} launched {r['bert']['per_step']}"
               f" flash kernels a step, expected {BERT_LAYERS} each")
        expect(r["bert"]["losses"][-1] < r["bert"]["losses"][0],
               f"dp bert: the loss did not fall {r['bert']['losses']}")
    run0 = ranks[0]["resnet"]
    f32 = run0["f32"]["losses"]
    again = [abs(a - b) / abs(b) for a, b in zip(run0["f32"]["again"],
                                                  f32[1:])]
    log(f"dp resnet: the f32 run again from its state after one update, "
        f"relative gap of each loss to the first run's "
        f"{[f'{g:.2e}' for g in again]}")
    for mode in ("bf16", "int8"):
        free = [abs(a - b) / abs(b) for a, b in zip(run0[mode]["losses"],
                                                    f32)]
        gaps = run0[mode]["stepwise"]
        log(f"dp resnet: grad_reduce={mode}, one update from the same state "
            f"against the explicit path with the f32 wire, relative gap "
            f"of the next loss {[f'{g:.2e}' for g in gaps]} (gate "
            f"{DP_GATES[mode]}); against the f32 run (sync-BN) "
            f"{[f'{g:.2e}' for g in run0[mode]['vs_implicit']]}, the f32 "
            f"wire against it {[f'{g:.2e}' for g in run0[mode]['yard_vs_implicit']]}"
            f"; free-running losses against f32's "
            f"{[f'{g:.2e}' for g in free]} (not held: the f32 run's own "
            f"reproducibility is printed below)")
        expect(max(gaps) < DP_GATES[mode], f"dp resnet {mode}: one "
               f"update left the f32 wire's next loss by {max(gaps):.3e}")
    expect(run0["int8"]["losses"] == run0["int8-again"]["losses"],
           "dp resnet: two int8 runs under one seed differ")
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import _strip

    gang = np.load(os.path.join(outdir, "gang-f32.npz"))
    one = np.load(os.path.join(outdir, "ref-f32.npz"))
    one32 = np.load(os.path.join(outdir, "ref32.npz"))
    # the same net, named from each process's own block counters
    gnames = _strip(n for n in gang.files if not n.startswith("kind:"))
    onames = _strip(n for n in one.files if not n.startswith("kind:"))
    fnames = _strip(one32.files)
    expect(sorted(gnames) == sorted(onames) == sorted(fnames),
           "dp resnet: the gang's leaves are not the world of one's")
    keys = sorted(onames)
    kinds = [(k, str(one[f"kind:{onames[k]}"])) for k in keys]

    def leaves(npz, names, loss):
        return [torch.tensor([loss], dtype=torch.float64)] + [
            torch.from_numpy(npz[names[k]]).double() for k in keys]
    hold_leaves(torch, [("loss", "loss")] + kinds,
                leaves(gang, gnames, run0["f32"]["losses"][1]),
                leaves(one, onames, ref["resnet"]["f32"]["losses"][1]),
                leaves(one32, fnames, ref["f32_loss"]),
                f"dp f32 resnet50_v1 bf16, {world} ranks vs the world of "
                f"one on the global batch {DP_BATCH}, one step from the "
                f"same parameters; floor: the world of one in bf16 vs f32")
    gaps = [abs(a - b) / abs(b) for a, b in zip(
        run0["f32"]["losses"], ref["resnet"]["f32"]["losses"])]
    log(f"dp resnet: f32 losses {world} ranks vs the world of one (the "
        f"same function summed in another order), relative gap per step "
        f"{[f'{g:.2e}' for g in gaps]}: the trajectory's own "
        f"reproducibility")


def data_parallel(torch, root, smi_line):
    """The "data parallel" phase (21 above).  Returns the launches of the
    dp path per kernel and the numbers."""
    import shutil

    outdir = tempfile.mkdtemp(prefix="dp-")
    try:
        return _data_parallel(torch, root, smi_line, outdir)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)


def _data_parallel(torch, root, smi_line, outdir):
    world, what = dp_topology(torch)
    log(f"dp topology: {torch.cuda.device_count()} card(s) seen; the gang: "
        f"{what}")
    gc.collect()
    torch.cuda.empty_cache()
    ranks = gang_run(root, outdir, world, "train", DP_GANG_TIMEOUT_S)
    backends = {r["backend"] for r in ranks}
    cards = {r["rank"]: r["card"] for r in ranks}
    want = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    expect(backends == {want}, f"dp: the gang ran over {backends}, the "
           f"backend rule gives {want}")
    expect(all(c == r % torch.cuda.device_count() for r, c in cards.items()),
           f"dp: rank -> card {cards}, expected rank % "
           f"{torch.cuda.device_count()}")
    log(f"dp topology: {world} ranks over {want}, rank -> card {cards}")
    ref = dp_reference(torch, outdir)
    dp_hold(torch, ranks, ref, world, outdir)
    example = gang_run(root, outdir, 2, "example", DP_GANG_TIMEOUT_S)
    sums = [re.findall(r"weight checksum=(\S+)", r["example"])
            for r in example]
    expect(all(len(s) == 1 for s in sums) and sums[0] == sums[1],
           f"dist_train.py: the ranks' weight checksums {sums} differ")
    log(f"dp example dist_train.py on {example[0]['backend']}: both ranks "
        f"end on weight checksum {sums[0][0]}")
    hold_bert_pretrain([r["bert_pretrain"] for r in example], smi_line)
    # (f) the numbers
    ms = {m: [r["resnet"][m]["ms_step"] for r in ranks]
          for m in ("f32", "bf16", "int8")}
    one_ms = ref["resnet"]["f32"]["ms_step"]
    numbers = {"resnet": {}, "bert": {}}
    for mode, per in ms.items():
        img_s = DP_BATCH / (max(per) / 1e3)
        numbers["resnet"][mode] = {"ms_step": per, "img_s": img_s}
        log(f"dp numbers [{card_line(smi_line)}]: resnet50_v1 bf16 "
            f"grad_reduce={mode}, {world} ranks ({want}): ms/step per rank "
            f"{[round(v, 1) for v in per]} = {img_s:.1f} img/s over the "
            f"gang vs the world of one (NCCL, captured) {one_ms:.1f} ms/step"
            f" = {DP_BATCH / (one_ms / 1e3):.1f} img/s")
    bper = [r["bert"]["ms_step"] for r in ranks]
    tok = BERT_BATCH * BERT_SEQ / (max(bper) / 1e3)
    one_tok = BERT_BATCH * BERT_SEQ / (ref["bert"]["ms_step"] / 1e3)
    numbers["bert"] = {"ms_step": bper, "tok_s": tok, "one_tok_s": one_tok}
    log(f"dp numbers [{card_line(smi_line)}]: BERT-base gluon.Trainer "
        f"dist_sync_device, {world} ranks ({want}): ms/step per rank "
        f"{[round(v, 1) for v in bper]} = {tok:.1f} tokens/s over the gang"
        f" vs one rank under a local store {ref['bert']['ms_step']:.1f} "
        f"ms/step = {one_tok:.1f} tokens/s")
    for who, prof in (("gang rank 0", ranks[0]["resnet"]["f32"]["profile"]),
                      ("world of one", ref["resnet"]["f32"]["profile"])):
        log(f"dp numbers [{card_line(smi_line)}]: profiled f32 step, {who}:"
            f" wall {prof['wall_ms']:.1f} ms, busy {100 * prof['busy']:.1f}"
            f"%, NCCL kernels {prof['nccl_ms']:.3f} ms, copies "
            f"{prof['copy_ms']:.3f} ms")
    numbers["profile"] = {"gang": ranks[0]["resnet"]["f32"]["profile"],
                          "one": ref["resnet"]["f32"]["profile"]}
    return {"launches": {k: int(v * (DP_WARMUP + DP_TIMED))
                         for k, v in ranks[0]["resnet"]["f32"]["per_step"]
                         .items()},
            "flash": {k: int(v * (DP_WARMUP + DP_TIMED))
                      for k, v in ranks[0]["bert"]["per_step"].items()},
            "bert_pretrain": example[0]["bert_pretrain"]["flash"],
            "numbers": numbers, "backend": want, "world": world}


# ------------------------------------------------------- model parallel --
def sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def mp_bert(torch, impl, device):
    """BERT-base at bench_bert's width, dropout 0, seeded, under its own
    prefix, cast to bf16 (f32 masters come from the step)."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel

    mxrandom.seed(0)
    net = BERTModel(vocab_size=BERT_VOCAB, units=BERT_UNITS,
                    hidden_size=BERT_HIDDEN, num_layers=BERT_LAYERS,
                    num_heads=BERT_HEADS, max_length=512, dropout=0.0,
                    attention_impl=impl, prefix="bert_")
    net.initialize(ctx=device)
    return net.cast("bfloat16")


def mp_bert_rules():
    """``tp_dense_rules()`` and BERT's layers by their own names: Gluon
    names the fused QKV, the output projection and the FFN layers
    ``dense0``/``dense1``, which ``tp_dense_rules()`` (written for layers
    named ``qkv``/``proj``/``ffn1``/...) does not match, so alone it
    splits only the embeddings.  QKV and FFN-in go column-parallel, the
    projection and FFN-out row-parallel."""
    from mxnet_tpu_torch import parallel

    return parallel.tp_dense_rules() + parallel.ShardingRules([
        (r"attentioncell\d+_dense0_weight$", ("tp", None)),
        (r"attentioncell\d+_dense0_bias$", ("tp",)),
        (r"attentioncell\d+_dense1_weight$", (None, "tp")),
        (r"bertlayer\d+_dense0_weight$", ("tp", None)),
        (r"bertlayer\d+_dense0_bias$", ("tp",)),
        (r"bertlayer\d+_dense1_weight$", (None, "tp"))])


def mp_stack(torch, device):
    """BERT-base's 12 encoder cells as MP_STAGES pipeline stages of
    12 / MP_STAGES cells (flash attention, dropout 0), seeded, bf16."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, parallel
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTLayer

    def stage():
        seq = gluon.nn.HybridSequential()
        with seq.name_scope():
            for _ in range(BERT_LAYERS // MP_STAGES):
                seq.add(BERTLayer(BERT_UNITS, BERT_HIDDEN, BERT_HEADS,
                                  dropout=0.0, attention_impl="flash"))
        return seq
    mxrandom.seed(0)
    dev = torch.device(device)
    with (mx.cpu() if dev.type == "cpu" else mx.gpu(dev.index or 0)):
        stack = parallel.PipelineStack(stage, num_stages=MP_STAGES,
                                       microbatches=MP_MICRO, prefix="pipe_")
    return stack.cast("bfloat16")


def in_sequence(stack):
    """The world of one of a ``PipelineStack``: its stages applied one
    after another to the whole batch, from the same stacked parameters
    (no mesh)."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.block import Block
    from mxnet_tpu_torch.parallel.functional import functional_call

    class InSequence(Block):
        def __init__(self):
            super().__init__(prefix="seq_")
            self.stack = stack

        def forward(self, x):
            names = stack._stacked_names
            plist = [stack.template.collect_params()[n] for n in names]
            stacked = [p.tensor() for p in plist]
            for i in range(stack.num_stages):
                x, _ = functional_call(stack.template, plist,
                                       [t[i] for t in stacked], (x,),
                                       autograd.is_training())
            return x
    return InSequence()


def mp_moe(torch, device):
    """GShard's top-2 at BERT-base width: ``MoEFFN(768, 3072, 8, k=2)``
    under a ``Dense(2)`` head on the tokens' mean, as tests/test_moe.py
    builds it; seeded, bf16."""
    from mxnet_tpu_torch import gluon, parallel
    from mxnet_tpu_torch import random as mxrandom

    class Net(gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix="moenet_")
            with self.name_scope():
                self.moe = parallel.MoEFFN(
                    units=BERT_UNITS, hidden_size=BERT_HIDDEN,
                    num_experts=MP_EXPERTS, k=MP_TOPK, prefix="moe_")
                self.out = gluon.nn.Dense(2, in_units=BERT_UNITS,
                                          prefix="out_")

        def forward(self, x):
            h, aux = self.moe(x)
            return self.out(h.mean(dim=1)), aux
    mxrandom.seed(0)
    net = Net()
    net.initialize(ctx=device)
    return net.cast("bfloat16")


def mp_embeddings(torch, bert, tokens, types):
    """The batch's BERT-base embeddings ``(B, S, C)`` (no gradient)."""
    from mxnet_tpu_torch import autograd

    with torch.no_grad(), autograd.pause():
        return bert._embed(tokens, types).detach()


def mp_case(torch, run, device, rank, world, shared):
    """One sub-phase's net, loss, mesh/rules and this rank's batch.
    ``shared`` carries the BERT batch and its embeddings across runs."""
    from mxnet_tpu_torch import gluon, parallel

    data, labels = shared["batch"]
    one = world == 1
    if run in ("tp", "fsdp", "ring", "ulysses"):
        # tp, fsdp and the world of one share one flash net (a step owns
        # copies of a net's parameters, so the net stays as it was made)
        net = shared["bert"] if one or run in ("tp", "fsdp") \
            else mp_bert(torch, run, device)
        kw = {}
        if not one:
            kw = {"tp": dict(mesh=parallel.make_mesh(tp=world),
                             rules=mp_bert_rules()),
                  "fsdp": dict(mesh=parallel.make_mesh(fsdp=world),
                               rules=parallel.fsdp_rules()),
                  "ring": dict(mesh=parallel.make_mesh(sp=world)),
                  "ulysses": dict(mesh=parallel.make_mesh(sp=world))}[run]
        if run == "fsdp" and not one:
            b = BERT_BATCH // world
            data = tuple(None if t is None else t[rank * b:(rank + 1) * b]
                         for t in data)
            labels = tuple(t[rank * b:(rank + 1) * b] for t in labels)
        return net, bert_loss_fn(), kw, data, labels
    x, target = shared["embeddings"], shared["target"]
    if run == "pp":
        stack = mp_stack(torch, device)
        net = in_sequence(stack) if one else stack
        kw = {} if one else dict(mesh=parallel.make_mesh(pp=world),
                                 rules=stack.sharding_rules())

        def mse(out, y):
            return ((out.float() - y.float()) ** 2).mean()
        return net, mse, kw, x, target
    net = mp_moe(torch, device)
    kw = {} if one else dict(mesh=parallel.make_mesh(ep=world),
                             rules=net.moe.sharding_rules())
    ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def moe_loss(out, y):
        logits, aux = out
        return ce(logits.float(), y).mean() + 0.01 * aux.float()
    return net, moe_loss, kw, x, labels[2]


def mp_shared(torch, device):
    """bench_bert's batch, its embeddings (through a seeded BERT-base)
    and the pipeline's MSE target from RandomState(0)."""
    batch = bert_batch(torch, BERT_BATCH, device=device)
    bert = mp_bert(torch, "flash", device)
    emb = mp_embeddings(torch, bert, batch[0][0], batch[0][1])
    rng = np.random.RandomState(0)
    target = torch.from_numpy(rng.randn(*emb.shape).astype(np.float32)) \
        .to(device).to(torch.bfloat16)
    return {"batch": batch, "embeddings": emb, "target": target,
            "bert": bert}


def step_bytes(step):
    """Bytes this rank holds of the step's parameters, running statistics
    and optimizer states (f32 masters among them).  The Gluon net the
    step was made from keeps its own whole parameters besides
    (``net_bytes``)."""
    return sum(t.numel() * t.element_size()
               for t in list(step._train) + list(step._aux)
               + [s for st in step._states for s in st])


def net_bytes(net):
    """Bytes of the whole parameters a Gluon net keeps on its device."""
    return sum(p.local_tensor().numel() * p.local_tensor().element_size()
               for p in net.collect_params().values())


@contextlib.contextmanager
def first_gradients():
    """Inside, the gradients a ``TrainStep``'s first update takes (this
    rank's blocks of the sharded leaves, after the exchange), cloned into
    the yielded list: read at the one call of the optimizer update."""
    from mxnet_tpu_torch.parallel import step as step_mod

    seen = []
    real = step_mod.multi_update

    def spy(opt, train, grads, *a, **kw):
        if not seen:
            seen.append([g.detach().clone() for g in grads])
        return real(opt, train, grads, *a, **kw)
    step_mod.multi_update = spy
    try:
        yield seen
    finally:
        step_mod.multi_update = real


def save_gradients(torch, step, grads, path):
    """MP_GRAD_SAMPLE evenly strided elements of each trainable leaf's
    whole first-step gradient (all of a smaller leaf), f32, to ``path``
    (None: this rank only takes part in the gathers, a collective for
    every sharded leaf)."""
    out = {}
    for i, t, g in zip(step._train_idx, step._train, grads):
        where = getattr(t, "_placement", None)
        whole = (g if where is None else where.gather(g)).float().flatten()
        stride = max(1, whole.numel() // MP_GRAD_SAMPLE)
        out[step._names[i]] = whole[::stride][:MP_GRAD_SAMPLE].cpu().numpy()
    if path is not None:
        np.savez(path, **out)


def save_leaves(leaves, path, loss, f32=False, zero=()):
    """A step's whole leaves (``step.params``: bf16 as their raw 16 bits,
    or f32), the first loss and the names of the trainable leaves that
    started at zero, into ``path``."""
    import torch

    out = {"loss": np.array([loss]), "zero_start": np.array(sorted(zero))}
    for name, t in leaves.items():
        t = t.detach()
        out[name] = (t.float() if f32 else
                     t.to(torch.bfloat16).view(torch.int16)).cpu().numpy()
    np.savez(path, **out)


def load_leaves(torch, path, f32=False):
    """``save_leaves``' file: ``({name: f64 tensor}, zero-start names)``."""
    z = np.load(path)
    out = {}
    for name in z.files:
        if name == "zero_start":
            continue
        v = torch.from_numpy(z[name])
        if name != "loss" and not f32:
            v = v.view(torch.bfloat16)
        out[name] = v.double()
    return out, {str(n) for n in z["zero_start"]}


@contextlib.contextmanager
def timed_collectives():
    """Inside, the host milliseconds spent in the port's collectives
    (over gloo they are synchronous and include the staging copies
    between the card and the host) add up in the yielded dict's
    ``ms``."""
    from mxnet_tpu_torch import distributed

    names = ("all_reduce_", "all_gather_into", "all_to_all", "broadcast_",
             "send_recv")
    saved = {n: getattr(distributed, n) for n in names}
    acc = {"ms": 0.0, "calls": 0}

    def timed(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc["ms"] += 1e3 * (time.perf_counter() - t0)
                acc["calls"] += 1
        return run
    for n in names:
        setattr(distributed, n, timed(saved[n]))
    try:
        yield acc
    finally:
        for n, fn in saved.items():
            setattr(distributed, n, fn)


def mp_run(torch, run, shared, device, outdir):
    """One sub-phase on this rank (a world of one outside a gang): the
    checked first step (its leaves to ``outdir``), MP_WARMUP - 1 more
    and MP_TIMED timed steps, one profiled step; the numbers."""
    from mxnet_tpu_torch import distributed, optimizer, parallel

    fa = flash_module()
    rank, world = distributed.rank(), distributed.num_workers()
    clock = [time.perf_counter()]

    def lap():
        now = time.perf_counter()
        clock.append(now)
        return round(now - clock[-2], 1)
    net, loss_fn, kw, data, labels = mp_case(torch, run, device, rank,
                                             world, shared)
    step = parallel.TrainStep(net, loss_fn,
                              optimizer.create("lamb", learning_rate=1e-3,
                                               wd=0.01), **kw)
    zero = [n for n, p in net.collect_params().items()
            if p.grad_req != "null" and not bool(p.tensor().detach().any())]
    heads = []
    attn = importlib.import_module("mxnet_tpu_torch.ops.attention")
    bhsd = attn._flash_bhsd

    def spy(q, *a, **k):
        heads.append(int(q.shape[0]))
        return bhsd(q, *a, **k)
    attn._flash_bhsd = spy
    fa.flash_attention.launches = dict.fromkeys(FLASH, 0)  # the path starts
    laps = {"net": lap()}
    try:
        with first_gradients() as grads:
            loss0 = float(step(data, labels))
    finally:
        attn._flash_bhsd = bhsd
    laps["build + first step"] = lap()
    tag = "one" if world == 1 else "gang"
    sync(torch)
    leaves = step.params                    # a collective on every rank
    save_gradients(torch, step, grads[0], os.path.join(
        outdir, f"{tag}-{run}-grad.npz") if rank == 0 else None)
    if rank == 0:
        save_leaves(leaves, os.path.join(outdir, f"{tag}-{run}.npz"), loss0,
                    zero=zero)
    del leaves, grads
    laps["leaves saved"] = lap()
    if run == "tp" and "ckpt" in shared:
        shared["ckpt"].update(ckpt_save(torch, step, outdir))
        path = dict(fa.flash_attention.launches)
        shared["ckpt"].update(ckpt_reference(torch, step, data, labels))
        fa.flash_attention.launches = path    # the continuation is (f)'s
        laps["checkpoints saved, the continuation"] = lap()
    losses = [loss0]
    for _ in range(MP_WARMUP - 1):
        losses.append(float(step(data, labels)))
    sync(torch)
    if world > 1:
        distributed.barrier()
    laps["warm-up"] = lap()
    t0 = time.perf_counter()
    timed = [step(data, labels) for _ in range(MP_TIMED)]
    sync(torch)
    dt = time.perf_counter() - t0
    launches = dict(fa.flash_attention.launches)         # ... and ends here
    laps["timed"] = lap()
    losses += [float(v) for v in timed]
    replicated = [t for t in list(step._train) + list(step._aux)
                  if getattr(t, "_placement", None) is None]
    same = world == 1 or same_across_ranks(
        torch, replicated + [torch.tensor(losses, dtype=torch.float64)])
    sharded = sum(getattr(t, "_placement", None) is not None
                  for t in step._train)
    laps["checks"] = lap()
    what = (f"mp {run}, rank {rank}/{world} over "
            f"{distributed.backend() or 'no group'}")
    comm = {"ms": float("nan"), "calls": 0}
    prof = {"comm_ms": comm["ms"], "comm_calls": comm["calls"]}
    if run in MP_PROFILED:
        with timed_collectives() as comm:
            if rank == 0 and DEVICE == "cuda":
                prof = profile_once(torch, lambda: float(step(data, labels)),
                                    what)
            else:
                float(step(data, labels))
                prof = {}
        prof["comm_ms"], prof["comm_calls"] = comm["ms"], comm["calls"]
        laps["profiled step"] = lap()
    steps = MP_WARMUP + MP_TIMED
    out = {"losses": losses, "ms_step": 1e3 * dt / MP_TIMED,
           "per_step": {k: v / steps for k, v in launches.items()},
           "same": bool(same), "bytes": step_bytes(step),
           "net_bytes": net_bytes(net),
           "sharded": int(sharded), "graphs": step.graph_count(),
           "flash_heads": sorted(set(heads)), "profile": prof,
           "finite": all(bool(torch.isfinite(t).all()) for t in step._train)}
    log(f"mp {run} [rank {rank}/{world}]: losses "
        f"{[round(v, 4) for v in losses]}; {out['ms_step']:.1f} ms/step; "
        f"flash launches a step {out['per_step']}; {sharded} sharded leaves;"
        f" {out['bytes'] / 2**20:.1f} MiB of parameters and states; "
        f"replicated leaves {'the same bits' if same else 'DIFFER'} across "
        f"ranks; collectives {comm['ms']:.1f} ms in {comm['calls']} calls "
        f"on the profiled step; seconds {laps}")
    del step, net
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def profile_once(torch, fn, what):
    """``dp_profile``'s numbers from one profiled call, never repeated
    (every rank of a gang must run the same steps): a session without
    device events gives NaNs, logged."""
    from torch.profiler import ProfilerActivity, profile

    sync(torch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(torch)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    if not rows:
        log(f"profile [{what}]: the session saw no device event")
        nan = float("nan")
        return {"busy": nan, "nccl_ms": nan, "copy_ms": nan,
                "wall_ms": wall_us / 1e3}
    busy = print_profile(prof, wall_us, what, rows)
    return {"busy": busy,
            "nccl_ms": sum(device_us(e) for e in rows
                           if "nccl" in e.key.lower()) / 1e3,
            "copy_ms": sum(device_us(e) for e in rows
                           if "memcpy" in e.key.lower()) / 1e3,
            "wall_ms": wall_us / 1e3}


def gloo_census(torch):
    """Which collectives this torch's gloo runs, tried on 2-element
    tensors over the gang (each one every rank calls)."""
    from torch import distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    ones = torch.ones(2 * world)
    tries = {
        "all_reduce bf16": lambda: dist.all_reduce(
            torch.ones(2, dtype=torch.bfloat16)),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(2 * world), torch.ones(2)),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(2 * world), ones),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(2), ones),
        "batch_isend_irecv": lambda: [w.wait() for w in
                                      dist.batch_isend_irecv([
                                          dist.P2POp(dist.isend, ones,
                                                     (rank + 1) % world),
                                          dist.P2POp(dist.irecv,
                                                     torch.empty(2 * world),
                                                     (rank - 1) % world)])],
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            out[name] = "yes"
        except Exception as exc:   # noqa: BLE001 — the census is the result
            out[name] = f"no ({type(exc).__name__})"
        dist.barrier()
    return out


def mp_worker(torch, outdir, runs=MP_RUNS):
    """The gang's part of phase 22: every sub-phase on this rank (``runs``
    of them, then (f) the checkpoints of the tp run's first step and (g)
    tensor-parallel serving)."""
    from mxnet_tpu_torch import distributed

    device = distributed.device() if DEVICE == "cuda" else "cpu"
    res = {}
    if distributed.backend() == "gloo":
        res["gloo"] = gloo_census(torch)
        log(f"mp gloo census (torch {torch.__version__}): {res['gloo']}")
    shared = mp_shared(torch, device)
    shared["ckpt"] = {}
    for run in runs:
        res[run] = mp_run(torch, run, shared, device, outdir)
        if run == "tp":
            res["ckpt"] = mp_ckpt(torch, shared, device, outdir,
                                  res["tp"]["losses"])
    del shared
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    res["serve"] = mp_serve(torch, device, outdir)
    return res


def mp_reference(torch, outdir, runs=MP_RUNS):
    """The world of one in this process (no process group, no mesh):
    each distinct net's bf16 step from the same parameters on the whole
    batch (captured on the card), and the floor beside it — the same
    first step in f32 from the bf16-rounded parameters, eager; then
    (f)'s load of the gang's v1.1 file."""
    from mxnet_tpu_torch import optimizer, parallel

    device = DEVICE
    shared = mp_shared(torch, device)
    ref = {}
    for run in sorted({MP_ONE[r] for r in runs}, key=("tp", "pp",
                                                      "ep").index):
        ref[run] = mp_run(torch, run, shared, device, outdir)
        net, loss_fn, _, data, labels = mp_case(torch, run, device, 0, 1,
                                                shared)
        net.cast("float32")

        def f32(x):
            if isinstance(x, tuple):
                return tuple(f32(v) for v in x)
            return x.float() if x is not None and x.is_floating_point() \
                else x
        step = parallel.TrainStep(net, loss_fn, optimizer.create(
            "lamb", learning_rate=1e-3, wd=0.01), capture=False)
        with first_gradients() as grads:
            loss = float(step(f32(data), f32(labels)))
        save_gradients(torch, step, grads[0],
                       os.path.join(outdir, f"one32-{run}-grad.npz"))
        save_leaves(step.params, os.path.join(outdir, f"one32-{run}.npz"),
                    loss, f32=True)
        del step, net
        gc.collect()
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    shared["bert"].cast("bfloat16")          # the f32 floor cast it
    ref["ckpt"] = ckpt_one(torch, shared, outdir)
    del shared
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return ref


#: each sub-phase's world of one (its net without a mesh)
MP_ONE = {"tp": "tp", "fsdp": "tp", "ring": "tp", "ulysses": "tp",
          "pp": "pp", "ep": "ep"}


def mp_hold(torch, ranks, ref, world, outdir, runs=MP_RUNS):
    """The phase's checks: every rank's runs finite, the replicated
    leaves the same bits on every rank, 12 flash launches of each kernel
    a step a rank in tp and fsdp, and the gang's first-step gradients
    (a strided sample of each leaf's) and its leaves after
    that step against the world of one's at the bf16 noise floor.  LAMB's
    first step sees only the gradient's signs and a norm ratio, so the
    gradients' own hold is what catches a gradient ``n`` times too large
    (a missed share, a sum too many).  The leaves
    that start at zero (biases, LayerNorm betas) are a kind of their
    own: LAMB's first step moves them by ``lr * g / (|g| + eps)``, the
    gradient's sign wherever it is not tiny, so after it they are that
    sign pattern, and a gradient near zero swings an element by up to
    ``2 lr`` between any two summation orders.  Returns the floors of
    each run's leaves by kind."""
    floors = {}
    for r in ranks:
        for run in runs:
            got = r["mp"][run]
            expect(got["finite"] and all(np.isfinite(got["losses"])),
                   f"mp {run}: not finite on rank {r['rank']}")
            expect(got["same"], f"mp {run}: rank {r['rank']}'s replicated "
                   f"leaves or losses differ from rank 0's")
            expect(got["sharded"] > 0 or run in ("ring", "ulysses"),
                   f"mp {run}: rank {r['rank']} holds no sharded leaf")
            if run in ("tp", "fsdp"):
                expect(got["per_step"] == dict.fromkeys(FLASH, BERT_LAYERS),
                       f"mp {run}: rank {r['rank']} launched "
                       f"{got['per_step']} flash kernels a step, expected "
                       f"{BERT_LAYERS} each")
    for run in runs:
        one = MP_ONE[run]
        gang, _ = load_leaves(torch, os.path.join(outdir, f"gang-{run}.npz"))
        plain, zero = load_leaves(torch, os.path.join(outdir,
                                                      f"one-{one}.npz"))
        f32, _ = load_leaves(torch, os.path.join(outdir, f"one32-{one}.npz"),
                             f32=True)
        keys = sorted(k for k in plain if k != "loss")
        expect(sorted(k for k in gang if k != "loss") == keys == sorted(
            k for k in f32 if k != "loss"),
            f"mp {run}: the gang's leaves are not the world of one's")
        kinds = [("loss", "loss")] + [
            (k, "parameter from zero" if k in zero else "parameter")
            for k in keys]
        order = ["loss"] + keys
        floors[run] = hold_leaves(
            torch, kinds, [gang[k] for k in order],
            [plain[k] for k in order], [f32[k] for k in order],
            f"mp {run}, {world} ranks vs the world of one, one step from "
            f"the same parameters; floor: the world of one in bf16 vs f32")
        grads = [{k: torch.from_numpy(v).double() for k, v in
                  np.load(os.path.join(outdir, f"{tag}-{r}-grad.npz"))
                  .items()} for tag, r in (("gang", run), ("one", one),
                                           ("one32", one))]
        keys = sorted(grads[1])
        expect(all(sorted(g) == keys for g in grads),
               f"mp {run}: the gang's gradients are not the world of one's")
        hold_leaves(torch, [(k, "gradient") for k in keys],
                    *[[g[k] for k in keys] for g in grads],
                    f"mp {run}, {world} ranks vs the world of one, the "
                    f"first step's gradients; floor: the world of one in "
                    f"bf16 vs f32")
    return floors


# ------------------------------------------ sharded checkpoints (22 f) --
def ckpt_save(torch, step, outdir):
    """(f) The tp step after its first step, saved as the port's sharded
    v2 directory (``async_save=True``: the call, then the wait) and as
    the gathered v1.1 file (rank 0 writes); the ms of each part and this
    rank's bytes."""
    from mxnet_tpu_torch import distributed
    from mxnet_tpu_torch.parallel import checkpoint as ck

    rank, world = distributed.rank(), distributed.num_workers()
    d, v1 = os.path.join(outdir, "ckpt-v2"), os.path.join(outdir,
                                                          "ckpt-v1.npz")
    sync(torch)
    t0 = time.perf_counter()
    handle = ck.save_train_step_sharded(step, d, async_save=True)
    t1 = time.perf_counter()
    handle.wait_until_finished()
    t2 = time.perf_counter()
    ck.save_train_step(step, v1)
    t3 = time.perf_counter()
    out = {"dir": d, "v1": v1, "async_ms": 1e3 * (t1 - t0),
           "wait_ms": 1e3 * (t2 - t1), "v1_ms": 1e3 * (t3 - t2),
           "bytes": os.path.getsize(os.path.join(
               d, f"rank-{rank}-of-{world}.npz")),
           "v1_bytes": os.path.getsize(v1) if rank == 0 else 0}
    log(f"ckpt [rank {rank}/{world}]: v2 save {out['async_ms']:.1f} ms the "
        f"step waits (its blocks' copies enqueued), {out['wait_ms']:.1f} ms "
        f"to committed; {out['bytes'] / 2**20:.1f} MiB in this rank's file; "
        f"v1.1 (gathered, rank 0 writes) {out['v1_ms']:.1f} ms")
    return out


@contextlib.contextmanager
def deterministic(torch):
    """Inside, PyTorch's deterministic algorithms (an op without one
    warns): the masked-LM gather's backward accumulates by index, with
    atomics otherwise, so two runs of a BERT step from the same state
    need not give the same bits."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def ckpt_reference(torch, step, data, labels):
    """(f) The uninterrupted continuation of the tp step from the state
    it was saved in: its next 2 steps under ``deterministic``, the step
    put back in that state after; the losses and this rank's tensors
    after them."""
    snap, n = snapshot(step), step._num_update
    with deterministic(torch):
        losses = [float(step(data, labels)) for _ in range(2)]
    blocks = [t.detach().clone() for t in step_tensors(step)]
    load_snapshot(torch, step, snap)
    step._num_update = step.optimizer.num_update = n
    step._lr_value = None
    return {"want": losses, "blocks": blocks}


def mp_ckpt(torch, shared, device, outdir, losses):
    """(f) A fresh tp step and a fresh fsdp step (each built by one step)
    load the v2 directory of the tp run's first step and take the next 2
    steps (the tp one under ``deterministic``, as the uninterrupted
    continuation ran): their losses, load ms, whether the tp step's
    tensors are the continuation's bits, the flash launches; each
    resumed step's whole leaves to ``ckpt-<run>.npz`` (rank 0)."""
    from mxnet_tpu_torch import distributed, optimizer, parallel
    from mxnet_tpu_torch.parallel import checkpoint as ck

    fa = flash_module()
    rank, world = distributed.rank(), distributed.num_workers()
    saved = shared["ckpt"]
    out = {k: v for k, v in saved.items() if k != "blocks"}
    fa.flash_attention.launches = dict.fromkeys(FLASH, 0)  # the path starts
    for run in ("tp", "fsdp"):
        net, loss_fn, kw, data, labels = mp_case(torch, run, device, rank,
                                                 world, shared)
        step = parallel.TrainStep(net, loss_fn, optimizer.create(
            "lamb", learning_rate=1e-3, wd=0.01), **kw)
        step(data, labels)                       # builds it
        sync(torch)
        t0 = time.perf_counter()
        ck.load_train_step_sharded(step, saved["dir"])
        sync(torch)
        load_ms = 1e3 * (time.perf_counter() - t0)
        with (deterministic(torch) if run == "tp"
              else contextlib.nullcontext()):
            got = [float(step(data, labels)) for _ in range(2)]
        same = None
        if run == "tp":
            same = all(torch.equal(a, b) for a, b in
                       zip(saved["blocks"], step_tensors(step)))
        leaves = step.params                  # a collective on every rank
        if rank == 0:
            save_leaves(leaves, os.path.join(outdir, f"ckpt-{run}.npz"),
                        got[-1])
        out[run] = {"losses": got, "load_ms": load_ms, "same_bits": same,
                    "want": saved["want"]}
        log(f"ckpt [rank {rank}/{world}]: a fresh {run} step loaded the tp "
            f"step's v2 directory in {load_ms:.1f} ms; the next 2 losses "
            f"{[round(v, 5) for v in got]} (the uninterrupted "
            f"continuation {[round(v, 5) for v in saved['want']]}; the "
            f"run's own {[round(v, 5) for v in losses[1:3]]})"
            + ("" if same is None else f"; the tensors after them "
               f"{'the same bits as' if same else 'DIFFER from'} the "
               f"uninterrupted run's"))
        del step, leaves
    out["flash"] = dict(fa.flash_attention.launches)  # ... and ends here
    saved.pop("blocks", None)
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def ckpt_one(torch, shared, outdir):
    """(f) The world of one in this process: the BERT-base step (no mesh,
    captured on the card) built by one step loads the gang's gathered
    v1.1 file of the tp step's first step and takes the next 2 steps;
    its losses and load ms, its leaves to ``ckpt-one.npz``."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.parallel import checkpoint as ck

    net, loss_fn, _, data, labels = mp_case(torch, "tp", DEVICE, 0, 1,
                                            shared)
    step = parallel.TrainStep(net, loss_fn, optimizer.create(
        "lamb", learning_rate=1e-3, wd=0.01))
    step(data, labels)
    held = [t.data_ptr() for t in step_tensors(step)]
    sync(torch)
    t0 = time.perf_counter()
    ck.load_train_step(step, os.path.join(outdir, "ckpt-v1.npz"))
    sync(torch)
    load_ms = 1e3 * (time.perf_counter() - t0)
    expect(held == [t.data_ptr() for t in step_tensors(step)],
           "ckpt: the v1.1 load rebound a tensor of the captured step")
    got = [float(step(data, labels)) for _ in range(2)]
    save_leaves(step.params, os.path.join(outdir, "ckpt-one.npz"), got[-1])
    log(f"ckpt [world of one, {step.graph_count()} graphs]: the gathered "
        f"v1.1 file loaded in place in {load_ms:.1f} ms; the next 2 losses "
        f"{[round(v, 5) for v in got]}")
    del step
    gc.collect()
    return {"losses": got, "load_ms": load_ms}


def hold_ckpt(torch, ranks, one, floors, outdir):
    """(f)'s holds: the tp resume the uninterrupted tp run's losses and
    tensors bit for bit on every rank; the fsdp resume's leaves and the
    world of one's (from the v1.1 file) against the tp resume's within
    MODEL_FLOOR_FACTOR of the tp sub-phase's bf16 floor."""
    for r in ranks:
        c = r["mp"]["ckpt"]
        expect(c["tp"]["losses"] == c["tp"]["want"],
               f"ckpt: rank {r['rank']}'s tp resume losses "
               f"{c['tp']['losses']} are not the uninterrupted "
               f"{c['tp']['want']}")
        expect(c["tp"]["same_bits"], f"ckpt: rank {r['rank']}'s tp resume "
               f"ended on other bits than the uninterrupted run")
        expect(all(np.isfinite(c["fsdp"]["losses"])),
               "ckpt: the fsdp resume is not finite")
    tp, _ = load_leaves(torch, os.path.join(outdir, "ckpt-tp.npz"))
    keys = sorted(k for k in tp if k != "loss")
    for what in ("fsdp", "one"):
        got, _ = load_leaves(torch, os.path.join(outdir, f"ckpt-{what}.npz"))
        expect(sorted(k for k in got if k != "loss") == keys,
               f"ckpt: the {what} resume's leaves are not the tp resume's")
        kinds = [("loss", "loss")] + [(k, "parameter") for k in keys]
        order = ["loss"] + keys
        hold_leaves(torch, kinds, [got[k] for k in order],
                    [tp[k] for k in order], None,
                    f"ckpt: the {what} resume vs the tp resume, 2 steps "
                    f"from the tp step's checkpoint; floor: the tp "
                    f"sub-phase's", floors=floors)


# ---------------------------------------- tensor-parallel serving (22 g) --
def serve_config():
    from mxnet_tpu_torch.gluon.model_zoo.causal_lm import CausalLMConfig

    return CausalLMConfig(vocab_size=VOCAB, n_layers=LAYERS, n_heads=HEADS,
                          head_dim=HEAD_DIM, d_ff=D_FF)


def tp_serve_run(torch, params, cfg, device, coll, prompts, what,
                 profile=False, workers=0, max_new=None):
    """One tensor-parallel server over the gang (every rank builds it,
    the leader submits ``prompts``); this rank's numbers and, on the
    leader, the tokens."""
    from mxnet_tpu_torch import distributed
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.serving import BucketSpec, GenerationServer

    world = distributed.num_workers()
    max_new = MAX_NEW if max_new is None else max_new
    sync(torch)
    pa.paged_decode_attention.launches = 0       # the path starts here
    srv = GenerationServer(
        params, cfg, buckets=BucketSpec(batch=BATCH_BUCKETS,
                                        length=LENGTH_BUCKETS),
        n_slots=SLOTS, n_pages=N_PAGES, page_size=PAGE_SIZE,
        max_new_tokens=MAX_NEW, max_queue=max(len(prompts), 1), seed=0,
        tp_shards=world, tp_collectives=coll, prefill_workers=workers,
        device=device, name=f"ChipSmokeTP-{what}")
    srv.start()
    decode_ms = []
    if srv.leader:
        real = srv._run_decode

        def timed_decode():
            t0 = time.perf_counter()
            try:
                return real()
            finally:
                decode_ms.append(1e3 * (time.perf_counter() - t0))
        srv._run_decode = timed_decode
    prof = {}
    with timed_collectives() as comm:
        t0 = time.perf_counter()
        if profile and srv.leader and DEVICE == "cuda":
            def traffic():
                return [r.result(600) for r in
                        [srv.submit(p, max_new_tokens=max_new)
                         for p in prompts]]
            holder = {}
            prof = profile_once(torch, lambda: holder.setdefault(
                "outs", traffic()), what)
            outs = holder["outs"]
        elif srv.leader:
            outs = [r.result(600) for r in
                    [srv.submit(p, max_new_tokens=max_new) for p in prompts]]
        else:
            outs = []
        dt = time.perf_counter() - t0
        expect(srv.drain(600), f"{what}: the server did not drain")
    launches = pa.paged_decode_attention.launches    # ... and ends here
    st = srv.stats
    steps = st["decode_steps"] + (1 if srv.leader else 0)   # + warm-up
    pools = (srv._k_pool, srv._v_pool, srv.pages_per_seq)
    res = {"leader": srv.leader, "launches": launches,
           "per_step": launches / max(steps, 1),
           "decode_steps": st["decode_steps"], "graphs": srv.graph_count(),
           "comm_ms": comm["ms"], "comm_calls": comm["calls"],
           "comm_ms_step": comm["ms"] / max(steps, 1),
           "heads": int(srv._k_pool.shape[3]), "profile": prof}
    if srv.leader:
        n_tok = sum(len(o) for o in outs)
        expect(all(len(o) == max_new for o in outs) and all(
            o.min() >= 0 and o.max() < VOCAB for o in outs),
            f"{what}: a request resolved with the wrong tokens")
        expect(srv.alloc.free_count() == srv.alloc.allocatable,
               f"{what}: pages still held after drain")
        res.update(tokens_per_s=n_tok / dt, outs=[o.tolist() for o in outs],
                   decode_ms=float(np.mean(decode_ms)) if decode_ms else 0.0)
    else:
        expect(not srv.alive(), f"{what}: the follower's loop outlived "
               f"the leader's drain")
    log(f"tp serve [{what}, rank {distributed.rank()}/{world}, "
        f"{'leader' if srv.leader else 'follower'}]: "
        + (f"{len(prompts)} requests, {res['tokens_per_s']:.1f} tokens/s, "
           f"decode step {res['decode_ms']:.2f} ms; " if srv.leader else "")
        + f"{st['decode_steps']} decode steps; paged kernel {launches} "
        f"launches on {res['heads']} heads ({res['per_step']:.2f} a decode "
        f"step); collectives {comm['ms']:.1f} ms host in {comm['calls']} "
        f"calls ({res['comm_ms_step']:.2f} ms a step); graphs "
        f"{srv.graph_count()}")
    del srv
    return res, pools


def tp_pool_kernel(torch, pools, what):
    """The paged kernel on this rank's pool (its layer-0 K/V, HEADS /
    ranks heads) at the serving shape against its plain version on every
    rank; then timed on rank 0 alone, beside its bound and the plain
    version's time, while the other ranks wait at a barrier with their
    work on the card finished (ranks sharing the card would otherwise
    time-slice it under rank 0's events)."""
    from mxnet_tpu_torch import distributed
    from mxnet_tpu_torch.ops import paged_attention as pa

    k_pool, v_pool, pps = pools
    heads = int(k_pool.shape[3])
    rng = np.random.default_rng(7)
    dev = k_pool.device
    q = torch.from_numpy(rng.standard_normal(
        (SLOTS, heads, HEAD_DIM), dtype=np.float32)).to(dev)
    tables = torch.from_numpy(rng.permutation(np.arange(1, N_PAGES))[
        :SLOTS * pps].reshape(SLOTS, pps).astype(np.int32)).to(dev)
    lens_np = np.minimum(serving_lengths(rng, SLOTS), pps * PAGE_SIZE)
    lens = torch.from_numpy(lens_np.astype(np.int32)).to(dev)
    args = (q, k_pool[0], v_pool[0], tables, lens)
    before = pa.paged_decode_attention.launches
    got = pa.paged_decode_attention(*args)
    want = pa.paged_decode_attention_reference(*args)
    err = float((got - want).abs().max())
    expect(bool(((got - want).abs() <= ATOL + RTOL * want.abs()).all()),
           f"{what}: the paged kernel disagrees with its plain version on "
           f"this rank's pool")
    res = {"max_abs_err": err, "heads": heads}
    if DEVICE == "cuda":
        torch.cuda.synchronize(dev)
    distributed.barrier()
    if DEVICE == "cuda" and distributed.rank() == 0:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        part = pa._partition(SLOTS, heads, HEAD_DIM, PAGE_SIZE, pps, sms)
        flush = torch.empty(1024 * 2**20, dtype=torch.uint8, device=dev)
        res["ms"] = time_ms(torch, lambda: pa.paged_decode_attention(*args),
                            100, flush)
        res["plain_ms"] = time_ms(torch, lambda: (
            pa.paged_decode_attention_reference(*args)), 20, flush)
        del flush
        res["bound_ms"], res["bound_by"] = attention_bound(lens_np, SLOTS,
                                                           pps, heads)
        res["partition"] = {"heads_per_chunk": part.heads_per_chunk,
                            "head_chunks": part.head_chunks,
                            "splits": part.n_split, "blocks": part.blocks}
        log(f"tp serve [{what}]: the serving shape's partition at {heads} "
            f"heads a rank: {res['partition']}; the kernel on this rank's "
            f"pool {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
            f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}); max abs "
            f"err {err:.3e}")
    distributed.barrier()
    pa.paged_decode_attention.launches = before  # checking is not the path
    return res


def mp_serve(torch, device, outdir):
    """(g) Tensor-parallel serving over the gang at bench.py llm's width:
    rank 0's seeded params broadcast to every rank, the serve phase's
    traffic through ``tp_shards=<ranks>`` with f32 collectives, int8
    twice, then a profiled f32 run of TP_PROFILED_REQUESTS; the paged
    kernel held on this rank's pool."""
    from mxnet_tpu_torch import distributed
    from mxnet_tpu_torch.gluon.model_zoo.causal_lm import init_causal_lm

    cfg = serve_config()
    params = init_causal_lm(cfg, torch.Generator().manual_seed(0),
                            device=device)
    with torch.no_grad():
        for t in params.values():
            distributed.broadcast_(t, root=0)
    prompts = serve_prompts()[:TP_REQUESTS]
    out = {}
    for mode in ("f32", "int8", "int8 again", "f32 disaggregated"):
        out[mode], pools = tp_serve_run(
            torch, params, cfg, device, mode.split()[0], prompts, mode,
            workers=int(mode.endswith("disaggregated")))
        if mode == "f32":
            out["kernel"] = tp_pool_kernel(torch, pools, mode)
        del pools
    out["profiled"], pools = tp_serve_run(
        torch, params, cfg, device, "f32", prompts[:TP_PROFILED_REQUESTS],
        "f32, profiled", profile=True, max_new=TP_PROFILED_NEW)
    del pools, params
    if distributed.rank() == 0:
        with open(os.path.join(outdir, "serve-outs.json"), "w") as f:
            json.dump({m: out[m].get("outs") for m in TP_MODES}, f)
    for m in TP_MODES:
        out[m].pop("outs", None)
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def serve_one(torch, device):
    """(g)'s yardstick: the world of one's server (captured on the card)
    on the same params and traffic in this process; its tokens and
    numbers."""
    from mxnet_tpu_torch.gluon.model_zoo.causal_lm import init_causal_lm

    cfg = serve_config()
    params = init_causal_lm(cfg, torch.Generator().manual_seed(0),
                            device=device)
    res, pools = tp_serve_run(torch, params, cfg, device, "f32",
                              serve_prompts()[:TP_REQUESTS], "world of one")
    del pools
    return res, params, cfg


def hold_serve(torch, ranks, outdir, smi_line):
    """(g)'s holds and numbers: every rank's paged kernel 4 heads and
    LAYERS launches a decode step, held on its pool; the f32 tokens the
    world of one's (or teacher-forced, the reason printed); int8 the
    same tokens twice and its first tokens f32's; the numbers."""
    one, params, cfg = serve_one(torch, DEVICE)
    outs = json.load(open(os.path.join(outdir, "serve-outs.json")))
    prompts = serve_prompts()[:TP_REQUESTS]
    for r in ranks:
        sv = r["mp"]["serve"]
        for mode in TP_MODES + ("profiled",):
            expect(sv[mode]["heads"] == HEADS // len(ranks),
                   f"tp serve: rank {r['rank']} holds {sv[mode]['heads']} "
                   f"heads")
            expect(sv[mode]["per_step"] == LAYERS,
                   f"tp serve [{mode}]: rank {r['rank']}'s paged kernel "
                   f"launched {sv[mode]['per_step']:.2f} times a decode "
                   f"step, expected {LAYERS}")
        log(f"tp serve: rank {r['rank']}'s paged kernel on its pool vs "
            f"plain: max abs err {sv['kernel']['max_abs_err']:.3e}")
    f32 = [np.asarray(o, np.int32) for o in outs["f32"]]
    same = same_or_teacher_forced(
        torch, params, cfg, prompts, f32,
        [np.asarray(o, np.int32) for o in one["outs"]], "tp serve f32")
    log(f"tp serve f32: {same} of {len(f32)} outputs the world of one's "
        f"token for token")
    dis = [np.asarray(o, np.int32) for o in outs["f32 disaggregated"]]
    same = same_or_teacher_forced(torch, params, cfg, prompts, dis, f32,
                                  "tp serve f32 disaggregated")
    log(f"tp serve f32 disaggregated (1 prefill worker): {same} of "
        f"{len(dis)} outputs the fused tp server's token for token")
    q8 = [np.asarray(o, np.int32) for o in outs["int8"]]
    expect(all(np.array_equal(a, b) for a, b in
               zip(q8, [np.asarray(o) for o in outs["int8 again"]])),
           "tp serve int8: two runs under one seed gave other tokens")
    expect(all(a[0] == b[0] for a, b in zip(q8, f32)),
           "tp serve int8: a first token differs from f32's")
    diverged = sum(not np.array_equal(a, b) for a, b in zip(q8, f32))
    lead = ranks[0]["mp"]["serve"]
    k = lead["kernel"]
    for mode in ("f32", "int8", "f32 disaggregated"):
        x = lead[mode]
        log(f"tp serve numbers [{card_line(smi_line)}]: {mode} collectives, "
            f"{len(ranks)} ranks ({ranks[0]['backend']}): "
            f"{x['tokens_per_s']:.1f} tokens/s over the gang vs the world "
            f"of one ({one['graphs']} graphs) {one['tokens_per_s']:.1f} "
            f"tokens/s = {x['tokens_per_s'] / one['tokens_per_s']:.3f}x; "
            f"decode step {x['decode_ms']:.2f} ms (the world of one's "
            f"{one['decode_ms']:.2f}); collectives "
            f"{x['comm_ms_step']:.2f} ms host a step "
            f"({x['comm_calls']} calls)")
    prof = lead["profiled"]["profile"]
    log(f"tp serve numbers [{card_line(smi_line)}]: int8 outputs differing "
        f"from f32's {diverged} of {len(q8)} (first tokens all equal); "
        f"rank 0 busy {100 * prof.get('busy', float('nan')):.1f}% over a "
        f"profiled f32 run of {TP_PROFILED_REQUESTS} requests of "
        f"{TP_PROFILED_NEW} tokens (wall "
        f"{prof.get('wall_ms', float('nan')):.1f} ms); the paged kernel at "
        f"{k['heads']} heads a rank {k.get('ms', float('nan')):.4f} ms, "
        f"plain {k.get('plain_ms', float('nan')):.4f} ms, bound "
        f"{k.get('bound_ms', float('nan')):.4f} ms")
    del params
    gc.collect()
    return {"one": {"tokens_per_s": one["tokens_per_s"]}, "kernel": k,
            "launches": lead["f32"]["launches"]}


# ------------------------------------------ bert_pretrain.py (21 g) --
def bert_pretrain_example(torch, root):
    """(g) ``examples/bert_pretrain.py`` as written on this rank
    (BERT_PRETRAIN_ARGS), with a stand-in module named ``jax`` whose one
    member ``devices()`` gives the gang's ranks (the example's only JAX
    line is ``n_dev = len(jax.devices())``), its ``TrainStep`` calls
    recorded; then its flash run, which both packages refuse at the
    first forward.  The stand-in is gone after."""
    import types

    from mxnet_tpu_torch import distributed, parallel

    fa = flash_module()
    steps, losses = [], []
    real = parallel.TrainStep

    class Recorded(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            steps.append(self)

        def __call__(self, *a, **kw):
            out = super().__call__(*a, **kw)
            losses.append(out)
            return out
    stand_in = types.ModuleType("jax")
    stand_in.devices = lambda: list(range(distributed.num_workers()))
    saved = sys.modules.get("jax")
    sys.modules["jax"] = stand_in
    parallel.TrainStep = Recorded
    fa.flash_attention.launches = dict.fromkeys(FLASH, 0)
    try:
        t0 = time.perf_counter()
        text = run_example(root, "bert_pretrain", BERT_PRETRAIN_ARGS)
        seconds = time.perf_counter() - t0
        launches = dict(fa.flash_attention.launches)
        step = steps[0]
        vals = [float(v.asnumpy()) for v in losses]
        same = same_across_ranks(torch, list(step._train)
                                 + [torch.tensor(vals, dtype=torch.float64)])
        mesh = dict(step.mesh.shape)
        del step, steps[:], losses[:]
        gc.collect()
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        try:
            run_example(root, "bert_pretrain", BERT_PRETRAIN_FLASH_ARGS)
            refused = ""
        except ValueError as exc:
            refused = str(exc)
    finally:
        parallel.TrainStep = real
        if saved is None:
            sys.modules.pop("jax", None)
        else:
            sys.modules["jax"] = saved
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return {"losses": vals, "same": bool(same), "mesh": mesh,
            "flash": launches, "refused": refused, "seconds": seconds,
            "tokens": [ln for ln in text.splitlines() if "tokens/s" in ln]}


def hold_bert_pretrain(ranks, smi_line):
    """(g)'s holds: finite losses, every rank rank 0's parameters and
    losses, a dp mesh over the gang, the throughput line; the flash run
    refused with the JAX package's error."""
    for r in ranks:
        expect(all(np.isfinite(r["losses"])) and len(r["losses"]) == 1 + int(
            BERT_PRETRAIN_ARGS[BERT_PRETRAIN_ARGS.index("--num-steps") + 1]),
            f"bert_pretrain.py: losses {r['losses']}")
        expect(r["same"], "bert_pretrain.py: the ranks' parameters or "
               "losses differ")
        expect(r["mesh"] == {"dp": len(ranks)},
               f"bert_pretrain.py: the mesh {r['mesh']}")
        expect(len(r["tokens"]) == 1, "bert_pretrain.py: no tokens/s line")
        expect(FLASH_REFUSAL in r["refused"],
               f"bert_pretrain.py --attention flash: {r['refused']!r}")
    log(f"dp example bert_pretrain.py {' '.join(BERT_PRETRAIN_ARGS)} "
        f"[{card_line(smi_line)}]: losses {[round(v, 4) for v in ranks[0]['losses']]}"
        f", both ranks the same parameters; {ranks[0]['tokens'][0].strip()}"
        f" ({ranks[0]['seconds']:.1f} s); flash launches "
        f"{ranks[0]['flash']} (dense attention as written); with "
        f"--attention flash both packages stop at the first forward: "
        f"{ranks[0]['refused']!r}")


def gang_run(root, outdir, world, task, timeout):
    """A gang of ``world`` ranks of ``chip_smoke.py --dp-worker <outdir>
    <task>`` through the port's launcher, in a session of its own (a
    timeout kills the launcher and its ranks together); its output is
    logged; returns the ranks' results."""
    import signal

    script = GANG_SCRIPT or os.path.join(root, "chip_smoke.py")
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", str(world),
           "--platform", GANG_PLATFORM, "--graceful-secs", "5",
           sys.executable, script, "--dp-worker", outdir, task]
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        log(f"gang {task}: killed after {timeout} s")
    for line in out.splitlines():
        log(f"gang {task}: {line}")
    if proc.returncode != 0:
        for line in err.strip().splitlines()[-40:]:
            log(f"gang {task} stderr: {line}")
    expect(proc.returncode == 0, f"gang {task} of {world} failed "
           f"(rc {proc.returncode})")
    log(f"gang {task}: {world} ranks in {time.perf_counter() - t0:.1f} s")
    return [json.load(open(os.path.join(outdir, f"{task}-r{r}.json")))
            for r in range(world)]


def model_parallel(torch, root, smi_line, runs=MP_RUNS):
    """The "model parallel" phase (22 above; ``runs=("tp",)``: the tp
    sub-phase, (f) and (g) alone).  Returns the flash launches of the tp
    and fsdp paths and of (f), the paged kernel's of (g), and the
    numbers."""
    import shutil

    outdir = tempfile.mkdtemp(prefix="mp-")
    try:
        return _model_parallel(torch, root, smi_line, outdir, runs)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)


def _model_parallel(torch, root, smi_line, outdir, runs):
    world, what = dp_topology(torch)
    log(f"mp topology: {torch.cuda.device_count() if DEVICE == 'cuda' else 0}"
        f" card(s) seen; the gang: {what}")
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    task = "mp" if runs == MP_RUNS else "tp"
    ranks = gang_run(root, outdir, world, task, MP_GANG_TIMEOUT_S)
    ref = mp_reference(torch, outdir, runs)
    floors = mp_hold(torch, ranks, ref, world, outdir, runs)
    hold_ckpt(torch, ranks, ref["ckpt"], floors["tp"], outdir)
    c = ranks[0]["mp"]["ckpt"]
    log(f"ckpt numbers [{card_line(smi_line)}]: the tp step's v2 save: "
        f"{[round(r['mp']['ckpt']['bytes'] / 2**20, 1) for r in ranks]} MiB "
        f"a rank, the step blocked {c['async_ms']:.1f} ms, committed after "
        f"{c['wait_ms']:.1f} ms more; the gathered v1.1 file "
        f"{c['v1_bytes'] / 2**20:.1f} MiB in {c['v1_ms']:.1f} ms; loads: v2 "
        f"into tp {c['tp']['load_ms']:.1f} ms, into fsdp "
        f"{c['fsdp']['load_ms']:.1f} ms, v1.1 into the world of one "
        f"{ref['ckpt']['load_ms']:.1f} ms; flash launches of the resumed "
        f"steps {c['flash']}")
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    serving = hold_serve(torch, ranks, outdir, smi_line)
    a = ranks[0]["mp"]["tp"]
    log(f"mp tp: the fused QKV Dense splits [Q; K; V] by rows, its blocks' "
        f"outputs gathered on every rank, so attention runs whole on each "
        f"rank: the flash kernels ran on (B*H) = {a['flash_heads']} rows "
        f"a call, {BERT_HEADS} heads of {BERT_BATCH} sequences, on each of "
        f"the {world} ranks")
    if "gloo" in ranks[0]:
        log(f"mp gloo census: {ranks[0]['gloo']}")
    numbers = {}
    for run in runs:
        per = [r["mp"][run]["ms_step"] for r in ranks]
        one = ref[MP_ONE[run]]
        tok = BERT_BATCH * BERT_SEQ / (max(per) / 1e3)
        one_tok = BERT_BATCH * BERT_SEQ / (one["ms_step"] / 1e3)
        mem = [r["mp"][run]["bytes"] for r in ranks]
        resident = ranks[0]["mp"][run]["net_bytes"]
        with_net = (max(mem) + resident) / (one["bytes"] + one["net_bytes"])
        prof = ranks[0]["mp"][run]["profile"]
        numbers[run] = {"ms_step": per, "tok_s": tok, "one_ms": one["ms_step"],
                        "one_tok_s": one_tok, "bytes": mem,
                        "one_bytes": one["bytes"], "net_bytes": resident,
                        "profile": prof}
        log(f"mp numbers {card_line(smi_line)}: {run}, {world} ranks "
            f"({ranks[0]['backend']}): ms/step per rank "
            f"{[round(v, 1) for v in per]} = {tok:.1f} tokens/s over the "
            f"gang vs the world of one {one['ms_step']:.1f} ms/step = "
            f"{one_tok:.1f} tokens/s; the step's parameters + optimizer "
            f"states per rank {[round(b / 2**20, 1) for b in mem]} MiB vs "
            f"{one['bytes'] / 2**20:.1f} MiB "
            f"({max(mem) / one['bytes']:.3f}x), and besides them the Gluon "
            f"net's whole parameters, {resident / 2**20:.1f} MiB on every "
            f"rank ({with_net:.3f}x with them); profiled step on rank 0: "
            f"wall {prof.get('wall_ms', float('nan')):.1f} ms, busy "
            f"{100 * prof.get('busy', float('nan')):.1f}%, collectives "
            f"{prof['comm_ms']:.1f} ms host in {prof['comm_calls']} calls, "
            f"device copies {prof.get('copy_ms', float('nan')):.3f} ms")
    return {"flash": {run: {k: int(v * (MP_WARMUP + MP_TIMED))
                            for k, v in ranks[0]["mp"][run]["per_step"]
                            .items()} for run in ("tp", "fsdp")
                      if run in runs},
            "ckpt": c["flash"], "serve": serving, "numbers": numbers,
            "backend": ranks[0]["backend"], "world": world}


def capi_inputs(torch):
    """The C client's kernel inputs at the table's shapes, on the card:
    ``nd.FusedNormReluConv`` at IMPERATIVE_FUSED (bf16 NHWC data and HWIO
    3x3 weight, f32 gamma, beta and moving statistics, a bf16 dO),
    ``flash_attention`` at BERT-base ((B, S, H*D) bf16 q, k, v, dO;
    BERT_HEADS heads), ``paged_decode_attention`` at the serving config's
    path shape (SLOTS slots x 2 pages, f32, int32 tables and lengths)."""
    from mxnet_tpu_torch.capi import KERNEL_INPUTS

    gen = torch.Generator(device=DEVICE).manual_seed(CAPI_SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    n, hw, ci, co = IMPERATIVE_FUSED
    ins = {"conv_x": randn(n, hw, hw, ci).bfloat16(),
           "conv_w": (randn(3, 3, ci, co) * (2.0 / (9 * ci)) ** 0.5)
           .bfloat16(),
           "conv_gamma": torch.rand(ci, generator=gen, device=DEVICE) + 0.5,
           "conv_beta": 0.1 * randn(ci),
           "conv_moving_mean": torch.zeros(ci, device=DEVICE),
           "conv_moving_var": torch.ones(ci, device=DEVICE),
           "conv_dout": randn(n, hw, hw, co).bfloat16()}
    for k in ("flash_q", "flash_k", "flash_v", "flash_dout"):
        ins[k] = randn(BERT_BATCH, BERT_SEQ, BERT_UNITS).bfloat16()
    ins["flash_heads"] = torch.tensor([BERT_HEADS], dtype=torch.int32)
    rng = np.random.default_rng(CAPI_SEED)
    P = -(-(max(LENGTH_BUCKETS) + MAX_NEW) // PAGE_SIZE)
    paged = paged_inputs(torch, rng, SLOTS, P, serving_lengths(rng, SLOTS))
    for k, t in zip(("q", "k_pages", "v_pages", "page_tables", "lengths"),
                    paged):
        ins[f"paged_{k}"] = t
    expect(sorted(ins) == sorted(KERNEL_INPUTS),
           f"the C client's inputs {sorted(ins)}")
    return ins


def capi_plain(torch, ins):
    """The port's plain versions on the card, on the client's inputs:
    ``{key: tensor}`` under the client's output keys (the fused conv and
    flash through the registered ops under ``record()`` with their plain
    bodies, backward from dO; paged through its plain version)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.capi import KERNEL_OUTPUTS
    from mxnet_tpu_torch.ops import fused_conv as fc
    from mxnet_tpu_torch.ops.paged_attention import \
        paged_decode_attention_reference

    def run(op, keys, dout, **kw):
        args = [mx.nd.NDArray(ins[k].clone()) for k in keys]
        n_grad = 4 if op == "FusedNormReluConv" else 3
        for a in args[:n_grad]:
            a.attach_grad()
        with mx.autograd.record():
            out = mx.nd.invoke(op, *args, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        outs[0].backward(mx.nd.NDArray(ins[dout]))
        return [o._data.detach() for o in outs] + \
            [a.grad._data for a in args[:n_grad]]

    with plain_versions(fc):
        conv = run("FusedNormReluConv", ("conv_x", "conv_w", "conv_gamma",
                                         "conv_beta", "conv_moving_mean",
                                         "conv_moving_var"), "conv_dout")
    with plain_versions(flash_module()):
        flash = run("flash_attention", ("flash_q", "flash_k", "flash_v"),
                    "flash_dout", heads=BERT_HEADS)
    plain = paged_decode_attention_reference(*(
        ins[f"paged_{k}"] for k in ("q", "k_pages", "v_pages",
                                    "page_tables", "lengths")))
    torch.cuda.synchronize()
    keys = [k for k in KERNEL_OUTPUTS if k.startswith(("conv_", "flash_"))]
    return {**dict(zip(keys, conv + flash)), "paged_plain": plain}


def capi_client(torch, root, ins_path, outs_path):
    """(a) ``capi/c_api_smoke.c`` on the card as a user runs it: a process
    of its own in a session of its own (a timeout kills it whole), the
    repo root on its PYTHONPATH.  Returns its stdout and wall seconds."""
    import signal

    import mxnet_tpu_torch.capi as capi

    t0 = time.perf_counter()
    exe = capi.build_client()
    built = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.Popen([str(exe), "cuda", ins_path, outs_path],
                            cwd=root, env=capi.client_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=CAPI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        log(f"c_api client: killed after {CAPI_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    for line in out.splitlines():
        log(f"c_api client: {line}")
    if proc.returncode != 0:
        for line in err.strip().splitlines()[-40:]:
            log(f"c_api client stderr: {line}")
    expect(proc.returncode == 0 and "all checks passed" in out,
           f"the C client failed on the card (rc {proc.returncode})")
    return out, built, wall


def capi_hold(torch, ins, outs_path):
    """Every output and gradient the client saved against the port's
    plain versions on the same inputs: the fused-conv and flash ones
    under ``check_outputs``' rule (F32_RTOL / BF16_RTOL of each output's
    scale), paged within ATOL/RTOL on the active slots, its plain output
    (``impl="jnp"``) too.  Returns the max abs err per output."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.capi import KERNEL_OUTPUTS

    got = {k: v._data for k, v in
           mx.nd.load(outs_path, ctx=mx.gpu(0)).items()}
    expect(sorted(got) == sorted(KERNEL_OUTPUTS),
           f"the C client saved {sorted(got)}")
    want = capi_plain(torch, ins)
    err = {}
    for k in KERNEL_OUTPUTS:
        if k.startswith("paged_"):
            continue
        err[k] = check_outputs(torch, f"C ABI {k}", k, [got[k]], [want[k]])
    act = ins["paged_lengths"] > 0
    plain = want["paged_plain"][act]
    for k in ("paged_out", "paged_plain"):
        e = (got[k][act] - plain).abs()
        expect(bool(torch.isfinite(got[k]).all())
               and bool((e <= ATOL + RTOL * plain.abs()).all()),
               f"C ABI {k}: max abs err {float(e.max()):.3e} vs the plain "
               f"version")
        err[k] = float(e.max())
    return err


def capi_launches(torch, ins_path):
    """(b) The library loaded into this process with ``ctypes``; the three
    kernel invokes of the client through ``mxtpu_*`` on the same inputs,
    every launch counter at 0 first: each kernel must launch once per
    invoke or backward.  Returns the launches per kernel."""
    import ctypes

    import mxnet_tpu_torch.capi as capi
    from mxnet_tpu_torch.ops import fused_conv as fc
    from mxnet_tpu_torch.ops.paged_attention import \
        paged_decode_attention as paged

    fa = flash_module()
    lib = capi.load()
    P = ctypes.c_void_p

    def ok(rc, what):
        expect(rc is not None and rc != -1,
               f"C ABI {what}: {lib.mxtpu_last_error().decode()}")
        return rc

    ok(lib.mxtpu_init_device(b"cuda"), "init")
    handles = (P * len(capi.KERNEL_INPUTS))()
    names = ctypes.create_string_buffer(4096)
    n = ok(lib.mxtpu_ndarray_load(ins_path.encode(), handles, len(handles),
                                  names, len(names)), "load")
    h = dict(zip(names.value.decode().split("\n"), handles[:n]))

    def invoke(op, keys, kw=None, n_out=1):
        outs = (P * n_out)()
        ok(lib.mxtpu_invoke_n(op.encode(), (P * len(keys))(*(
            h[k] if isinstance(k, str) else k for k in keys)), len(keys),
            kw, outs, n_out), op)
        return list(outs)

    def counts():
        torch.cuda.synchronize()
        return ({k: fc.norm_relu_conv.launches[k] for k in FUSED},
                {k: fa.flash_attention.launches[k] for k in FLASH},
                paged.launches)

    def forward_backward(op, keys, n_grad, dout, kw=None, n_out=1):
        for k in keys[:n_grad]:
            ok(lib.mxtpu_ndarray_attach_grad(h[k]), "attach_grad")
        ok(lib.mxtpu_autograd_set_recording(1), "record on")
        outs = invoke(op, keys, kw, n_out)
        prod = invoke("broadcast_mul", [outs[0], dout])[0]
        head = invoke("sum", [prod])[0]
        ok(lib.mxtpu_autograd_set_recording(0), "record off")
        after_fwd = counts()
        ok(lib.mxtpu_backward(head), f"{op} backward")
        for x in (*outs, prod, head):
            lib.mxtpu_ndarray_free(x)
        return after_fwd, counts()

    fc.norm_relu_conv.launches = dict.fromkeys(FUSED, 0)
    fa.flash_attention.launches = dict.fromkeys(FLASH, 0)
    paged.launches = 0
    conv0, conv1 = dict.fromkeys(FUSED, 0), dict.fromkeys(FUSED, 1)
    flash0, flash1 = dict.fromkeys(FLASH, 0), dict.fromkeys(FLASH, 1)
    seen = forward_backward("FusedNormReluConv", (
        "conv_x", "conv_w", "conv_gamma", "conv_beta", "conv_moving_mean",
        "conv_moving_var"), 4, h["conv_dout"], n_out=3)
    expect(seen == (({**conv0, "fwd": 1}, flash0, 0), (conv1, flash0, 0)),
           f"C ABI FusedNormReluConv launched (after the invoke, after "
           f"backward) {seen}, expected fwd once, then dx and dw once")
    heads = f'{{"heads": {BERT_HEADS}}}'.encode()
    seen = forward_backward("flash_attention", ("flash_q", "flash_k",
                                                "flash_v"), 3,
                            h["flash_dout"], heads)
    expect(seen == ((conv1, {**flash0, "fwd": 1}, 0), (conv1, flash1, 0)),
           f"C ABI flash_attention launched (after the invoke, after "
           f"backward) {seen}, expected fwd once, then dq and dkv once")
    keys = tuple(f"paged_{k}" for k in ("q", "k_pages", "v_pages",
                                        "page_tables", "lengths"))
    for kw, want in ((None, 1), (b'{"impl": "jnp"}', 1)):
        lib.mxtpu_ndarray_free(invoke("paged_decode_attention", keys, kw)[0])
        expect(counts()[2] == want, f"C ABI paged_decode_attention "
               f"(kwargs {kw}) left {counts()[2]} launches, expected {want}")
    launches = {**{f"fused_conv_{k}": v
                   for k, v in fc.norm_relu_conv.launches.items()},
                **{f"flash_attention_{k}": v
                   for k, v in fa.flash_attention.launches.items()},
                "paged_decode_attention": paged.launches}
    for x in handles[:n]:
        lib.mxtpu_ndarray_free(x)
    ok(lib.mxtpu_shutdown(), "shutdown")
    return launches


def c_abi(torch, root, smi_line):
    """The "C ABI" phase (23 above).  Returns each kernel's launches
    through ``mxtpu_*`` in this process."""
    import shutil

    import mxnet_tpu_torch as mx
    import mxnet_tpu_torch.capi as capi

    tmp = tempfile.mkdtemp(prefix="capi-")
    try:
        t0 = time.perf_counter()
        lib = capi.build()
        lib_s = time.perf_counter() - t0
        ins = capi_inputs(torch)
        ins_path = os.path.join(tmp, "inputs.npz")
        outs_path = os.path.join(tmp, "outputs.npz")
        mx.nd.save(ins_path, {k: mx.nd.NDArray(v) for k, v in ins.items()})
        out, client_build_s, wall = capi_client(torch, root, ins_path,
                                                outs_path)
        err = capi_hold(torch, ins, outs_path)
        launches = capi_launches(torch, ins_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = next(ln for ln in out.splitlines()
                  if ln.startswith("c_api mlp losses:"))
    import sysconfig
    log(f"c_api python: headers {sysconfig.get_paths()['include']}, "
        + ", ".join(f"{k} {sysconfig.get_config_var(k)}" for k in
                    ("Py_ENABLE_SHARED", "LDLIBRARY", "LIBDIR")))
    log(f"c_api numbers [{card_line(smi_line)}]: {os.path.basename(lib)} "
        f"built in {lib_s:.2f} s, the client in {client_build_s:.2f} s; "
        f"the client's wall time on the card {wall:.2f} s (its start-up, "
        f"the MLP's 30 steps and the kernel section); {losses}")
    log("c_api kernels vs the plain versions, max abs err: "
        + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
        + f" (bf16 rtol {BF16_RTOL}, f32 rtol {F32_RTOL} of each output's "
        f"scale; paged atol {ATOL}, rtol {RTOL})")
    log(f"c_api launches through mxtpu_* in this process: {launches}")
    return launches


class phase:
    """Print a phase's wall time on its own line when it ends."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        log(f"phase {self.name}: {time.perf_counter() - self.t0:.1f} s")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this run needs the card",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from mxnet_tpu_torch.gluon.model_zoo.causal_lm import (
            CausalLMConfig, draft_config, init_causal_lm)
    except ImportError as exc:
        print(f"chip_smoke: the mxnet_tpu_torch package is not beside "
              f"this script ({exc})", file=sys.stderr)
        return 2

    if sys.argv[1:2] == ["--dp-worker"]:
        try:
            return dp_worker(torch, root, *sys.argv[2:4])
        except SmokeError as exc:
            print(f"chip_smoke: dp worker FAILED: {exc}", file=sys.stderr)
            return 1
    try:
        name, count, smi_line = card_report(torch)
        with phase("build"):
            build_kernels()
            warm_profiler(torch)
        if sys.argv[1:] == ["--extras"]:
            with phase("one-card extras"):
                one_card_extras(torch, smi_line, None)
            return 0
        if sys.argv[1:] == ["--np"]:
            with phase("numpy, sparse, ONNX"):
                numpy_sparse_onnx(torch, smi_line, None)
            return 0
        if sys.argv[1:] == ["--dp"]:
            with phase("data parallel"):
                data_parallel(torch, root, smi_line)
            return 0
        if sys.argv[1:] == ["--mp"]:
            with phase("model parallel"):
                model_parallel(torch, root, smi_line)
            return 0
        if sys.argv[1:] == ["--tp"]:
            with phase("model parallel: tp, checkpoints, tp serving"):
                model_parallel(torch, root, smi_line, runs=("tp",))
            return 0
        if sys.argv[1:] == ["--capi"]:
            with phase("C ABI"):
                c_abi(torch, root, smi_line)
            return 0
        with phase("imperative"):
            # first: its backward is the first CUDA work of autograd's
            # worker thread, as in a fresh user script
            imperative = {"imperative nd": imperative_fused(torch)}
            mlp_eager = imperative_mlp(torch)
            imperative["imperative Trainer"] = imperative_trainer_vs_step(
                torch)
            torch.cuda.empty_cache()
        with phase("hybridize"):
            hybrid = {"mlp": hybrid_mlp(torch, mlp_eager),
                      "resnet": hybrid_resnet(torch)}
            gc.collect()
            torch.cuda.empty_cache()
        with phase("input pipeline"):
            pipeline = input_pipeline(torch, root)
            gc.collect()
            torch.cuda.empty_cache()
        with phase("serving"):
            rng = np.random.default_rng(0)
            max_err = kernel_vs_plain(torch, rng)
            cfg = CausalLMConfig(vocab_size=VOCAB, n_layers=LAYERS,
                                 n_heads=HEADS, head_dim=HEAD_DIM, d_ff=D_FF)
            params = init_causal_lm(cfg, torch.Generator().manual_seed(0),
                                    device="cuda")
            decode_parity(torch, rng, params, cfg)
            served = serve(torch, params, cfg)
            served_eager = serve(torch, params, cfg, capture=False,
                                 check=False)
            expect(all(np.array_equal(a, b) for a, b in
                       zip(served["outs"], served_eager["outs"])),
                   "captured serving tokens differ from the eager ones")
            serve_without_syncs(torch, params, cfg)
            timing = time_kernel(torch, rng)
            prof_serve = profile_serving(torch, params, cfg)
            prof_serve_eager = profile_serving(torch, params, cfg,
                                               capture=False)
            log(f"serve: captured {served['tokens_per_s']:.1f} tokens/s "
                f"({prof_serve[0]:.3f} ms per decode step, busy "
                f"{100 * prof_serve[1]:.1f}%) vs eager "
                f"{served_eager['tokens_per_s']:.1f} tokens/s "
                f"({prof_serve_eager[0]:.3f} ms, busy "
                f"{100 * prof_serve_eager[1]:.1f}%) = "
                f"{served['tokens_per_s'] / served_eager['tokens_per_s']:.2f}"
                f"x; the same tokens")
        with phase("serving features"):
            timing["verify"] = kernel_at_verify_shape(torch, rng)
            paths = {"serve": served["launches"]}
            paths["prefix"] = serve_prefix(torch, params, cfg)["launches"]
            for label, r in serve_speculative(torch, params, cfg,
                                              served).items():
                paths[f"spec {label}"] = r["launches"]
            small = draft_config(cfg)
            profile_serving(torch, params, cfg, what="speculative, "
                            "draft-1-layer", draft=init_causal_lm(
                                small, torch.Generator().manual_seed(1),
                                device="cuda"), draft_config=small,
                            spec_k=SPEC_K, spec_window=SPEC_WINDOW)
            paths["salvage"] = serve_salvage_resume(torch, params, cfg,
                                                    served, root)["launches"]
            paths["nd"] = pipeline["nd"]["paged"]
        with phase("disaggregated serving"):
            disagg = serve_disaggregated(torch, params, cfg, served)
            paths["disaggregated"] = disagg[1]["launches"]
            paths["disaggregated 2 workers"] = disagg[2]["launches"]
            long_prompt_stall(torch, params, cfg, root)
            handoff_fault(torch, params, cfg, served)
            del params
            gc.collect()
            torch.cuda.empty_cache()
        with phase("fused conv vs plain"):
            fused_vs_plain(torch)
        with phase("ResNet model check"):
            hold_hybrid(torch, hybrid["resnet"], model_check(torch))
        with phase("ResNet training"):
            fused_net, plain_net = training_nets(torch)
            trained, step, batch = train_run(torch, fused_net, True,
                                             TIMED_STEPS)
            busy = profile_step(torch, step, batch, "train step (fused "
                                f"ResNet-50, batch {TRAIN_BATCH}, captured)")
            del step
            torch.cuda.empty_cache()
            eager, step, _ = train_run(torch, fused_net, True, TIMED_STEPS,
                                       capture=False)
            busy_eager = profile_step(torch, step, batch, "train step (fused "
                                      f"ResNet-50, batch {TRAIN_BATCH}, "
                                      "eager)")
            del step
            torch.cuda.empty_cache()
            same = trained["losses"] == eager["losses"]
            log(f"train: fused ResNet-50 captured {trained['ms_step']:.1f} "
                f"ms/step = {trained['img_s']:.1f} img/s (busy "
                f"{100 * busy:.1f}%) vs eager {eager['ms_step']:.1f} ms/step "
                f"= {eager['img_s']:.1f} img/s (busy {100 * busy_eager:.1f}"
                f"%) = {trained['img_s'] / eager['img_s']:.3f}x; losses "
                f"{'the same bits' if same else 'differ'} (cuDNN's default "
                f"algorithms)")
            hr = hybrid["resnet"]
            log(f"train: hybridized fused ResNet-50 under gluon.Trainer "
                f"{hr['ms_step']:.1f} ms/step = {hr['img_s']:.1f} img/s "
                f"(busy {100 * hr['busy']:.1f}%, peak "
                f"{hr['peak'] / 2**30:.2f} GiB) vs the captured TrainStep "
                f"{trained['ms_step']:.1f} ms/step (busy {100 * busy:.1f}%, "
                f"peak {trained['peak'] / 2**30:.2f} GiB) = "
                f"{trained['ms_step'] / hr['ms_step']:.3f}x, and the eager "
                f"TrainStep {eager['ms_step']:.1f} ms/step = "
                f"{eager['ms_step'] / hr['ms_step']:.3f}x")
            fed, loader = pipeline["fed"], pipeline["loader"]
            log(f"train: fused ResNet-50 fed by ImageRecordIter through "
                f"DevicePrefetcher {fed['ms_step']:.1f} ms/step = "
                f"{fed['img_s']:.1f} img/s (busy {100 * fed['busy']:.1f}%; "
                f"waits producer {fed['producer_wait_s']:.3f} s, consumer "
                f"{fed['consumer_wait_s']:.3f} s) vs the batch already on "
                f"the card {trained['ms_step']:.1f} ms/step = "
                f"{trained['img_s']:.1f} img/s (busy {100 * busy:.1f}%) = "
                f"{fed['img_s'] / trained['img_s']:.3f}x; the iterator "
                f"alone {pipeline['records']['img_s']:.1f} img/s "
                f"({pipeline['records']['route']}); DataLoader(pin_memory="
                f"True) over host images {loader['ms_step']:.1f} ms/step = "
                f"{loader['img_s']:.1f} img/s")
            bit_check(torch, fused_net, batch)
            del batch, fused_net
            torch.cuda.empty_cache()
            unfused = train_run(torch, plain_net, False, TIMED_STEPS)[0]
            del plain_net
            track_losses(trained["losses"], unfused["losses"],
                         "fused vs unfused ResNet-50")
            log(f"train: fused {trained['img_s']:.1f} img/s "
                f"({trained['ms_step']:.1f} ms/step) vs unfused (cuDNN convs) "
                f"{unfused['img_s']:.1f} img/s ({unfused['ms_step']:.1f} "
                f"ms/step) = {trained['img_s'] / unfused['img_s']:.3f}x")
            torch.cuda.empty_cache()
        with phase("resume"):
            gc.collect()
            torch.cuda.empty_cache()
            resumed = resume_phase(torch, root, smi_line)
            torch.cuda.empty_cache()
        with phase("fused conv timing"):
            fused_times = time_fused(torch)
            torch.cuda.empty_cache()
        with phase("flash vs plain"):
            flash_err = flash_vs_plain(torch)
            torch.cuda.empty_cache()
        with phase("BERT model check"):
            bert_model_check(torch)
            torch.cuda.empty_cache()
        with phase("BERT training"):
            flash_net, dense_net = bert_nets(torch)
            bert, bstep, bbatch = bert_train_run(torch, flash_net, "flash",
                                                 BERT_TIMED_STEPS)
            busy = profile_step(torch, bstep, bbatch, "train step (flash "
                                f"BERT-base, batch {BERT_BATCH} x {BERT_SEQ}"
                                ", captured)")
            del bstep
            torch.cuda.empty_cache()
            beager, bstep, _ = bert_train_run(torch, flash_net, "flash",
                                              BERT_TIMED_STEPS,
                                              capture=False)
            busy_eager = profile_step(torch, bstep, bbatch, "train step "
                                      f"(flash BERT-base, batch {BERT_BATCH}"
                                      f" x {BERT_SEQ}, eager)")
            del bstep
            torch.cuda.empty_cache()
            same = bert["losses"] == beager["losses"]
            log(f"train: flash BERT-base captured {bert['ms_step']:.1f} "
                f"ms/step = {bert['tok_s']:.1f} tokens/s (busy "
                f"{100 * busy:.1f}%) vs eager {beager['ms_step']:.1f} ms/step"
                f" = {beager['tok_s']:.1f} tokens/s (busy "
                f"{100 * busy_eager:.1f}%) = "
                f"{bert['tok_s'] / beager['tok_s']:.3f}x; losses from the "
                f"same seed {'equal' if same else 'differ'}")
            if not same:      # said above; held to track_losses' limit
                track_losses(bert["losses"], beager["losses"],
                             "captured vs eager flash BERT-base")
            dropout_replays(torch, flash_net, bbatch)
            del bbatch, flash_net
            torch.cuda.empty_cache()
            dense = bert_train_run(torch, dense_net, "dense",
                                   BERT_TIMED_STEPS)[0]
            del dense_net
            track_losses(bert["losses"], dense["losses"],
                         "flash vs dense BERT-base")
            log(f"train: flash BERT-base {bert['tok_s']:.1f} tokens/s "
                f"({bert['ms_step']:.1f} ms/step, peak "
                f"{bert['peak'] / 2**30:.2f} GiB) vs dense "
                f"{dense['tok_s']:.1f} tokens/s ({dense['ms_step']:.1f} "
                f"ms/step, peak {dense['peak'] / 2**30:.2f} GiB) = "
                f"{bert['tok_s'] / dense['tok_s']:.3f}x")
            torch.cuda.empty_cache()
        with phase("flash timing"):
            flash_times = time_flash(torch, flash_err)
            gc.collect()
            torch.cuda.empty_cache()
        with phase("LSTM LM"):
            lstm_phase(torch, root)
            gc.collect()
            torch.cuda.empty_cache()
        with phase("SSD"):
            ssd_phase(torch)
            gc.collect()
            torch.cuda.empty_cache()
        with phase("symbolic"):
            symbolic = symbolic_phase(torch, root, smi_line)
            gc.collect()
            torch.cuda.empty_cache()
        with phase("classifier serving"):
            classifier = classifier_phase(torch, root, smi_line)
            gc.collect()
            torch.cuda.empty_cache()
        with phase("one-card extras"):
            extras = one_card_extras(torch, smi_line, bert)
        with phase("numpy, sparse, ONNX"):
            npso = numpy_sparse_onnx(torch, smi_line, bert)
            gc.collect()
            torch.cuda.empty_cache()
        with phase("data parallel"):
            dp = data_parallel(torch, root, smi_line)
            gc.collect()
            torch.cuda.empty_cache()
        with phase("model parallel"):
            mp = model_parallel(torch, root, smi_line)
            gc.collect()
            torch.cuda.empty_cache()
        with phase("C ABI"):
            capi = c_abi(torch, root, smi_line)
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    t = timing["path"]
    kernels = {"kernels": [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": SOURCES["paged_decode_attention"],
        "replaces": REPLACES["paged_decode_attention"],
        "launches": served["launches"], "max_abs_err": max_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "cases": {label: {k: c[k] for k in ("ms", "bound_ms", "plain_ms")}
                  for label, c in timing.items()},
        "launches_by_path": paths}]}
    tp_kernel = mp["serve"]["kernel"]
    kernels["kernels"][0]["cases"]["serve tp"] = {
        k: tp_kernel[k] for k in ("ms", "bound_ms", "plain_ms")}
    kernels["kernels"][0]["launches_by_path"]["serve tp"] = \
        mp["serve"]["launches"]
    kernels["kernels"][0]["launches_by_path"]["c_api"] = \
        capi["paged_decode_attention"]
    for kern in FUSED:
        kname, t = f"fused_conv_{kern}", fused_times[kern]
        kernels["kernels"].append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname],
            "launches": trained["launches"][kern],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "launches_by_path": {"train": trained["launches"][kern],
                                 **{k: v[kern]
                                    for k, v in imperative.items()},
                                 "hybridize": hybrid["resnet"]["replayed"][
                                     kern],
                                 "input pipeline":
                                     pipeline["fed"]["launches"][kern],
                                 "resume": resumed["launches"][kern],
                                 "symbolic": symbolic["launches"][kname],
                                 "classifier serving":
                                     classifier["resnet"]["launches"]
                                     if kern == "fwd" else 0,
                                 "estimator":
                                     extras["estimator"]["launches"][kern],
                                 "dp": dp["launches"][kern],
                                 "c_api": capi[kname]}})
        if kern == "fwd":
            kernels["kernels"][-1]["serving_small_n"] = {
                f"N={n}": {"ms_per_launch": t["ms"] / FUSED_PER_STEP,
                           "plain_ms_per_launch":
                               t["plain_ms"] / FUSED_PER_STEP,
                           "bound_ms_per_launch":
                               t["bound_ms"] / FUSED_PER_STEP,
                           "max_abs_err": t["err"]}
                for n, t in classifier["small_n"].items()}
    for kern in FLASH:
        kname, t = f"flash_attention_{kern}", flash_times[kern]
        kernels["kernels"].append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": bert["launches"][kern],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "launches_by_path": {"train": bert["launches"][kern],
                                 "nd": pipeline["nd"]["flash"][kern],
                                 "symbolic": symbolic["launches"][kname],
                                 "amp": extras["amp"]["launches"][kern],
                                 "np": npso["np"]["launches"][kern],
                                 "dp": dp["flash"][kern],
                                 "mp tp": mp["flash"]["tp"][kern],
                                 "mp fsdp": mp["flash"]["fsdp"][kern],
                                 "ckpt": mp["ckpt"][kern],
                                 "bert_pretrain":
                                     dp["bert_pretrain"][kern],
                                 "c_api": capi[kname]}})
    print(json.dumps(kernels), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
