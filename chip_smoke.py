#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # the smoke run, phases 1-38
    python3 chip_smoke.py --serving   # phases 1, 3 and 4, serving only
    python3 chip_smoke.py --frontdoor # phases 1 and 12, the front door
    python3 chip_smoke.py --resnet    # phase 1, BatchNorm's phase 3, phase 7
    python3 chip_smoke.py --lstm      # phase 1, recurrent phase 3, 9, 10
    python3 chip_smoke.py --ln        # phase 1, LayerNorm phase 3
    python3 chip_smoke.py --decode-modes  # phase 1, the row-stable
                                      # product's phase 3, phase 13
    python3 chip_smoke.py --vgg       # phase 1, BatchNorm's phase 3,
                                      # phases 14-16
    python3 chip_smoke.py --amp-train # phase 1, the training kernels at
                                      # phase 17's bf16 shapes, phase 17
    python3 chip_smoke.py --seq2seq   # phase 1, the seq2seq shapes of
                                      # phase 3, phases 19 and 20
    python3 chip_smoke.py --xent      # phase 1, softmax cross-entropy's
                                      # phase 3
    python3 chip_smoke.py --genprog   # phases 1 and 22, the generation
                                      # Programs
    python3 chip_smoke.py --ssd       # phases 1 and 24, MobileNet-SSD,
                                      # with the BatchNorm backward over
                                      # its step's 35 launches
    python3 chip_smoke.py --sparse    # phases 1 and 26, SelectedRows
                                      # training on the recommender
    python3 chip_smoke.py --remat     # phases 1 and 27, the LM under
                                      # memory_optimize
    python3 chip_smoke.py --observe   # phases 1, 28 and 29, the
                                      # observability plane
    python3 chip_smoke.py --fleet     # phases 1, 30 and 31, the serving
                                      # fleet and its control plane
    python3 chip_smoke.py --mesh      # phases 1 and 32, the mesh
    python3 chip_smoke.py --sharded-embedding  # phases 1 and 33, the
                                      # row-sharded recommender
    python3 chip_smoke.py --sequence-parallel  # phases 1 and 34, ring
                                      # and Ulysses attention, the
                                      # pipeline
    python3 chip_smoke.py --pserver   # phases 1 and 35, the dataset
                                      # master and the parameter server
    python3 chip_smoke.py --v2        # phases 1-3 for the GRU and
                                      # BatchNorm kernels, and 36, the
                                      # legacy v2 trainer
    python3 chip_smoke.py --csp       # phases 1-3 for the BatchNorm
                                      # backward and LSTM kernels, and
                                      # 37, CSP and the native runtime
    python3 chip_smoke.py --shapes    # phases 1-3 for the head dims
                                      # 8-128 and the stepwise
                                      # recurrences, and 38

Phases, in order; any failure exits non-zero and prints no result line:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from ops/csrc (one nvcc per source, all
   started together) and, beside them, the native C++ library (one g++
   per source), and print the build seconds and ptxas report;
3. hold each kernel against its plain PyTorch version at the main paths'
   shapes, in f32 and bf16 (the flash kernels also at head_dim 8, 16,
   32, 80 and 128, at tile-edge lengths and at 65544 batch-heads, and
   timed at head_dim 128 at phase 38's prefill and training shapes;
   paged attention also at one slot of 2047 positions, at head_dim 128,
   80, 32 and 8 with indexes on page and split edges and at -1, and
   timed at phase 38's S16 H16 D128; LayerNorm at widths on both sides
   of its warp-per-row path, the recurrent kernels also with ragged and
   time-reversed masks and at an odd shape, and at the widths where the
   persistent grid ends: at H1024 the persistent path (and the stepwise
   one forced beside it, bit for bit or not recorded), at H2048 the
   stepwise path at B4 T3 and B32 T80, timed there in f32 and bf16 w;
   the LSTM and GRU forward also where they stage the batch in chunks),
   and time kernel, plain
   version and a PyTorch library yardstick with CUDA events and by device
   time per call (torch.profiler, split by kernel name), the wrappers of
   paged attention and the LayerNorm forward by host us per call; the
   flash, LayerNorm, BatchNorm and recurrent backward kernels and the GRU
   forward must repeat bit for bit, and the flash, LSTM and GRU libraries
   must hold tensor-core instructions (HMMA in cuobjdump -sass), the GRU
   forward kernel in its own machine code; softmax cross-entropy also
   on rows of -inf (lse -inf), labels -1 and V and rows that start off a
   16-byte boundary (V 30001, 1001), timed at the LM's R8192 V8192,
   the seq2seq head's R3200 V30000 and one image's SSD confidence loss
   R2278 V21 in f32 and bf16 (a device reading
   under the bound of a call too large for the L2 is reported as a
   broken measurement, not a time); the row-stable product of exact
   decode must equal its plain version bit for bit at the exact LM's
   shapes (M 4, 2048, 8192; the decode shapes also at M 1 and on both
   sides of the small-M tile code's limit), each through the tile code
   the wrapper names, and give a row the same bits at M 1 (small-M code)
   and inside 8192 (the 128 x 128 code) at each recompute shape (cuBLAS's
   addmm is recorded for the same row); the four decode products are
   timed with cold weights beside the bytes bound and the FADD chain's
   floor, and the small-M code at each strip width and the 128 x 128
   code at M 4-64;
4. serve the full-width transformer LM (vocab 32000, 12 layers, d_model
   768, 12 heads, d_ff 3072; seeded random weights saved as a model
   directory and loaded through DecodeEngine.from_model_dir) in bf16
   with 16 slots: 32 concurrent requests with prompts of 8..1024 tokens
   and 64 new tokens each.  Kernel launch counts are zeroed just before
   and read just after; every serving kernel must have launched.  Two
   streams are recomputed through greedy_decode_full and their logits
   compared.  Then the decode step of the run's middle with every slot
   active is replayed under torch.profiler: device ms by kernel and by
   group, launches per step, host idle share;
5. train the repo's at-scale config (vocab 8192, T 512, 12 layers,
   d_model 768, 12 heads, d_ff 3072; 90.6 M parameters) in f32 with TF32
   off, through transformer_lm_train_program + Executor.run: startup from
   a fixed seed, then 20 Adam steps at batch 16 on a seeded copy task,
   launch counts zeroed just before and read just after (12 flash
   forward and backward, 24 LayerNorm forward and backward, 1 softmax-
   xent forward and backward per step), every loss finite and the last
   below the first; one more step under torch.profiler;
6. one full-width step at batch 1 from the same carried-in state and
   feed on the card and on the CPU (Executor(CPUPlace()), the plain
   versions): the loss and every parameter's @GRAD must agree;
7. train ResNet-50 (bench.py bench_resnet: 224x224, 1000 classes, NHWC,
   program.amp) through resnet_train_program + Executor.run: startup from
   a fixed seed, then 20 Momentum steps at batch 128 on one fixed seeded
   batch, launch counts zeroed just before and read just after (53
   BatchNorm backward launches per step), every loss finite and the last
   below the first; one more step under torch.profiler;
8. the same ResNet-50 program in f32 (amp off, TF32 off) at batch 2: one
   step from phase 7's state and one feed on the card and on the CPU; the
   loss and every @GRAD must agree;
9. train the stacked dynamic LSTM (bench.py bench_lstm: lstm_net with
   dict 30000, emb 512, hid 512, 3 recurrences; batch 32, T 80, Adam,
   program.amp) through Executor.run on one seeded batch: launch counts
   zeroed just before and read just after (2 LSTM forward and 2 LSTM
   backward launches per step, nothing else of the port's), every loss
   finite and the last below the first; one more step under
   torch.profiler;
10. the same for the GRU classifier of tools/gru_bench.py (vocab 30000,
   H 512; 1 GRU forward and 1 backward launch per step);
11. one f32 step of each sequence model at full width, batch 4, ragged
   lengths, from its phase's state, on the card and on the CPU: the loss
   and every @GRAD must agree;
12. the serving front door: the port saves the full-width LM
   (save_generation_model, seeded random weights) and ResNet-50 inference
   (save_inference_model, NHWC, softmax output, startup weights at the
   seed with BatchNorm statistics from one seeded batch); one
   InferenceServer on 127.0.0.1:0 (port file) over one ModelRegistry
   serves both in bf16: the LM with 16 decode slots, block_len 16 and a
   512-block prefix cache, ResNet-50 transpiled with batches of up to 32.
   Launch counts are zeroed, then 32 streamed generate requests of 64 new
   tokens from 8 client threads (four groups of 8 prompts sharing a
   512-token head, suffixes of 8..512 tokens) and 64 infer requests of 4
   images from 16 threads go over the wire; paged attention, the flash
   forward and the LayerNorm forward must have launched, and
   decode_prefix_hits_total (read through the metrics verb) must reach
   24.  Every stream must equal an in-process DecodeEngine without prefix
   cache, or part from it on a near tie; a cold and a hot stream of the
   served engine must match greedy_decode_full; every infer reply must be
   its rows of the batch the server ran, each batch must match the
   in-process bf16 Predictor on the same padded batch, and one request in
   f32 on the card must match the CPU's f32 Predictor.  drain_and_stop
   must drain, and the KV allocator must be back to its baseline after
   close.  It prints tokens/s, TTFT cold and hot, the decode step, infer
   requests/s, latency and batch fill beside the card's name;
13. the decode modes and the hot-row cache, at full width.  Exact decode:
   the LM in f32 with numerics="exact", 4 slots over the whole 2048-token
   span, a prefix cache; prompts of 17, 300, 1000 and 1900 tokens, 8 new
   tokens each, then the 1000-token prompt again: every token's logits
   bitwise greedy_decode_full(numerics="exact"), the hot stream's bitwise
   the cold one's; the flash forward, LayerNorm forward and row-stable
   product launched, the decode steps' products through the small-M tile
   code and the recompute's layer products through the 128 x 128 one.
   int8 decode: 8 requests of 64 new tokens on 8 slots, two streams
   against the int8 full recompute by phase 4's rule;
   paged attention, the flash forward and the LayerNorm forward launched;
   tokens/s and step p50 beside phase 4's.  The recommender of
   bench.py:788-810 (V 100000, D 64, T 64, sequence_pool sum, fc 128
   relu, fc 2 softmax), saved by the port, 200 requests of batch 64 with
   Zipf(1.1) ids: a 25000-row hot-row cache's replies bitwise the
   uncached predictor's, in f32 and int8; then a registry apply_deltas of
   1000 rows (written in the JAX chain format by write_row_delta) bitwise
   a fresh load of the patched model; hit rate, promotions and requests/s
   cached and uncached.  Launch counts are zeroed before and read after
   each decode run;
14. train VGG-16 with BatchNorm and dropout (benchmark/fluid/vgg.py:
   224x224 NCHW, 1000 classes, batch 128, program.amp, Adam 1e-4) through
   vgg16_bn_drop + Executor.run: 20 steps on one seeded batch, launch
   counts zeroed just before and read just after (14 BatchNorm backward
   launches a step on NCHW (N, C, H*W) views and the 2-D fc output),
   every loss finite and the last below the first; step p50/p99,
   images/s and the step's bound at the bf16 peak; one more step under
   torch.profiler, grouped into library products, the BatchNorm backward
   kernel, the eager BatchNorm forward and statistics, dropout (the
   kernels their rules launch) and other;
15. the same VGG-16 in f32 with every dropout probability 0, batch 8:
   one step from phase 14's state on the card, on the CPU, and in f64 on
   the CPU, for the feed and two one-ulp moves of it; the loss held as in
   phase 8, and each @GRAD's distance from the f64 step on the card at
   most twice the CPU f32 step's plus 1e-4 (the rule of the CPU test
   against the JAX package); then LeNet-5 (benchmark/fluid/mnist.py:
   1x28x28, 10 classes, batch 128, amp, Adam 1e-3), 20 steps, no port
   kernel;
16. every op rule the port registers (but the optimizers, the backward
   op and the DynamicRNN, which the training phases run, and phase
   21's), each as a
   one-op program on the card and on the CPU from one seeded feed:
   outputs and the input @GRADs of a weighted-sum loss, integer and bool
   outputs exactly; the random rules by mean and variance on the card.
   Its first case is cross_entropy with labels outside [0, V): NaN and
   the wrapped row as on the CPU, no device assert, and every later case
   runs on the same CUDA context;
17. the six training kernels at the LM's training shapes in bf16 (the
   operand dtype under amp) against their plain versions and timed
   beside SDPA, F.layer_norm and F.cross_entropy; then the training
   config under MixedPrecision(Adam) (transformer_lm_train_program(
   amp=True), bench.py bench_transformer_big's path) at batch 16 through
   Executor.train_loop: 20 steps on one seeded batch in windows of 4
   steps with one host sync each, a checkpoint every 8 steps into a
   temporary directory, launch counts zeroed just before and read just
   after (TRAIN_LAUNCHES_PER_STEP a step, every kernel fed bf16), the
   loss falling; a fresh executor and scope resume from step 16 to 20
   with losses bitwise the first run's; one profiled step; one step at a
   loss scale of 2^127 that must be a skip (every persistable but the
   scaler bitwise unchanged, the scale halved); step p50/p99, tokens/s,
   device ms and busy share, the scaler's trajectory, the checkpoint's
   caller-thread and commit ms and the skip guard's cost a step;
18. every optimizer rule, ModelAverage's accumulation, each weight decay,
   gradient clip and LR schedule and a per-parameter learning rate on a
   small fc program, and the SelectedRows branches of sgd, momentum
   (nesterov) and adam behind an is_sparse table: 5 steps on the card and
   on the CPU from one startup state, losses, learning rates and every
   persistable to 2e-5, the table rows never looked up bitwise; the
   card's ModelAverage apply/restore bitwise;
19. train seq2seq attention NMT (bench.py bench_seq2seq: seq_to_seq_net
   with embedding, encoder and decoder 512, vocabulary 30000, batch 64,
   T 50, program.amp, Adam 1e-3) through Executor.run on one seeded
   batch: launch counts zeroed just before and read just after (2 LSTM
   forward and 2 backward, 1 softmax cross-entropy forward and backward
   a step), every loss finite and the last below the first; step p50,
   examples/s and tokens/s; one step profiled by kernel group and by op
   (the decoder DynamicRNN's forward, autograd's backward, Adam) with
   the interpreter's dead-op skip and one without it; then one f32 step
   at batch 4 with ragged lengths on the card and on the CPU, held as
   phase 11;
20. seq_to_seq_generate at bench.py:1042-1060's config (batch 16, beam
   3, max_length 50) with phase 19's parameters by name: batch latency
   and sentences/s on the card (2 LSTM forward launches a decode), then
   the same decode on the CPU: per sample, the card's step ids and
   parents equal the CPU's, or first part at a step whose selected
   scores agree within S2S_TIE_RTOL (a near tie, printed);
21. every rule this slice registered (S21_RULES: the sequence, beam,
   LoD, array, control-flow and CRF families, lod_reset, im2sequence,
   row_conv) on the card against the CPU: one-op programs as phase 16,
   While/IfElse/ConditionalBlock/ParallelDo, the arrays, the printers
   and cross_entropy_over_beam as programs of the port's layers with
   calc_gradient's @GRADs, nce by the JAX formula on its card samples;
22. the generation Programs (build_generation_programs: the prefill and
   decode steps over the paged KV cache as op rules on the port's
   interpreter) of phase 4's LM, saved by save_generation_model with
   seeded random weights and loaded into a Scope through io, served by
   DecodeEngine(scope, spec).  Fast in bf16: phase 4's traffic (32
   requests, prompts of 8..1024 tokens, 64 new tokens, 16 slots), launch
   counts zeroed before and read after, paged attention, the flash
   forward and the LayerNorm forward launched; the same prompts through
   the TransformerLM engine (from_model_dir) in the same run, each
   stream equal to it or parted on a near tie by phase 4's rule;
   tokens/s, step p50 and TTFT of both engines, and one decode step of
   each with every slot active profiled.  Exact in f32: phase 13's 4
   slots over the 2048 span, prompts of 17, 300, 1000 and 1900 tokens, 8
   new tokens each: every token's logits bitwise the exact full-recompute
   program's row (transformer_lm_logits at T = max_len,
   exact_lowering), the row-stable product through the small-M code in
   decode and the 128 x 128 code in the prefills and the recompute, the
   flash forward launched; whether the logits equal the TransformerLM
   exact engine's bitwise is printed with the largest difference;
23. the misc rules (S23_OP_CASES: ops/misc_ops.py's 19) as one-op
   programs on the card against the CPU as phase 16 holds its rules,
   with ties for the _with_index masks (equal) and roi_pool's rounding;
24. MobileNet-SSD for PASCAL VOC (the PaddlePaddle models repository's
   Fluid object-detection example of early 2018: 300x300, 21 classes,
   the MobileNet-v1 body, four extra blocks, multi_box_head over six maps,
   2278 priors) in f32 at batch 32 with Momentum, one ssd_loss per image
   over layers.split slices: 64 seeded samples (uint8 images, 1-8 boxes
   padded to 8) written by recordio_writer, read back through
   open_recordio_file (10 passes over the file) -> shuffle -> batch ->
   double_buffer(CUDAPlace) -> read_file, 20 steps through
   Executor.train_loop(feed=None) with a host sync a step; launch counts
   zeroed just before and read just after (32 softmax cross-entropy
   forward and backward launches and 35 BatchNorm backward launches a
   step), the loss falling; step p50/p99, images/s and a profiled step's
   device time and busy share; one f32 step at batch 2 on the card, on
   the CPU and in f64 on the CPU, held as phase 15 (the loss to 1e-4,
   each @GRAD no farther from the f64 step than twice the CPU's f32 step
   plus 1e-4, over the feed and two one-ulp moves of it); then the
   for_test clone at batch 32 from
   the trained state, timed, and detection_output + detection_map on the
   card against the CPU fed the card's loc and scores (decoded boxes to
   F32_TOL, rows bitwise where an image's boxes are, the NMS rule on the
   CPU's boxes bitwise, mAP to F32_TOL);
25. the ten detection rules (S25_OP_CASES) as one-op programs at the SSD
   path's shapes on the card against the CPU as phase 16 holds its
   rules, with ties, zero-area boxes and padding rows; the discrete
   outputs bitwise;
26. SelectedRows training on the recommender of bench.py:794-810 at full
   width (V 100000, D 64, T 64, batch 64, Zipf(1.1) ids with ragged
   lengths, sequence_pool sum, fc 128 relu, fc 2 softmax, cross_entropy,
   Adam 1e-3) through Executor.train_loop in windows of 8 steps, the
   is_sparse leg and the dense leg: step p50/p99 and examples/s of each,
   the loss falling, the rows never looked up bitwise their start in the
   table and both moments; one sparse step profiled by op
   (lookup_table, sequence_pool, backward, adam); merge_selected_rows
   alone; then each sparse branch (Adam, SGD, Momentum with nesterov,
   MixedPrecision(Adam)) from one startup state: one window on the card
   against the CPU (every persistable to 1e-4; 2e-2 under amp), the rows
   no feed looked up bitwise, one step run twice bitwise (every
   persistable, the fetched rows and values), and under amp an inf in a
   looked-up row of the table, a bitwise skip; then
   benchmark/fluid/sparse_embedding.py's size leg (V 1000000, D 256,
   uniform ids, fc 2 softmax, Adam) at bs32 T32 and bs1024 T512: sparse
   and dense ms/step, the merge alone, and each leg's peak allocated
   memory during a step over what was resident before it, the sparse
   leg's at bs32 T32 under a quarter of the 1 GiB dense gradient.  No
   port kernel runs on this path;
27. phase 5's LM without and with fluid.memory_optimize (the recorded
   forward in segments under torch.utils.checkpoint), each from one
   startup state on one feed: 3 steps with launch counts zeroed before
   and read after (under remat every forward kernel launches twice a
   step, the backward kernels once), the losses and every @GRAD of the
   third step bitwise the plain run's; then 6 steps timed, step p50 and
   peak allocated memory of each;
28. phase 17's amp LM through train_loop with the observability plane:
   20 steps in windows of 4 from one saved state twice, plain and with
   timeline_path, xprof_every 8 and xprof_steps 2: the losses bitwise
   equal, the timeline parsed (executor.run spans on the loop's thread,
   the flight counter track), every capture window measured and holding
   the six training kernels by their __global__ names, the program's
   report's flops within 1% of the count of phase 17's products; step
   p50 of both runs with the capture windows apart, the roofline at the
   p50, the windows' compute and idle shares;
29. phase 4's model (bf16, 16 slots) behind an InferenceServer over
   TCP, 16 streamed generate requests with the plane off, then again
   with the profiler's span log on, a TimeSeriesStore sampling the
   registry and an SLOMonitor with a TTFT p99 objective: the streams
   equal, the inspect verb listing the decode step's report, the trace
   verb returning one request's serving.request, decode.prefill and
   decode.step spans (stitched into a Chrome trace with flow events),
   the inter-token attribution's shares summing to 1 with the paged
   attention kernel in "kernel", pool_copy_bytes_per_token 0 and the
   slo_* gauges set; tokens/s and step p50 with the plane off and on;
30. the serving fleet: phase 4's model saved for serving, two spawned
   `python -m paddle_tpu_torch serve --precision bf16 --decode-slots 16
   --profile` replicas on the card and one adopted in-process replica
   behind a FleetFrontend (heartbeat every 0.5 s): 48 streams (prompts
   of 8..1024 tokens, 64 new tokens, 8 client threads) to the in-process
   server alone (the reference), the same through the frontend (launch
   counts zeroed just before: the adopted replica's count every serving
   kernel), the same again with the spawned replica holding the most
   streams SIGKILLed once stream 0 has relayed 8 tokens, then 16 more
   once it is back; every stream bitwise the reference, retries, the
   victim restarted, readmitted and serving, the merged metrics with
   every replica's series, a trace stitched over three processes (a
   client subprocess, the frontend, a spawned replica), `top` rendering
   the three replicas, no kernel built by a replica, each spawned
   replica's kernels in its inter-token attribution; tokens/s and TTFT
   of each round, kill to ejection and to readmission, and each replica
   incarnation's longest decode step, step ms and device memory;
31. the control plane: a CheckpointWatcher over phase 30's two spawned
   replicas republishes a checkpoint of the served weights (a no-op, no
   reload) and then every parameter times 1 + 1e-2 N(0, 1), rolled one
   replica at a time under LoadGenerator generates (none may fail),
   both replicas then on the new fingerprint, a greedy stream equal to
   the in-process engine reloaded from the published dir and unequal to
   phase 30's; then `fleet --autoscale min=1,max=2` replays one
   build_schedule trace (low rate, an x8 burst, low rate, idle): one
   scale-up during the burst whose replica boots on the card and takes
   traffic, one scale-down after it, no client errors, the autoscaler
   on the stats page, no replica process left; p99 before, during and
   after the burst, shed rate, boot seconds;
32. the mesh (`paddle_tpu_torch.parallel`) on TRAIN_CONFIG at
   TRAIN_BATCH: (a) an NCCL world of 2 ranks on the one card is refused;
   a one-rank NCCL world runs one all-gather, all-reduce and broadcast
   on a CUDA tensor, then train_loop(mesh={"dp": 1}) 4 steps after a
   warm-up one, bitwise the plain run; (b) two spawned ranks on gloo
   over CUDA tensors, time-slicing the card: dp=2 exact 4 steps, losses
   and every final param bitwise the single-process card run; dp=2 fast
   4 steps and tp=2 fast (mesh dp=1 x tp=2, transformer_tp_rules) 2
   steps, each loss within CPU_LOSS_RTOL of it, every tp-ruled param and
   both Adam moments holding half the ruled dim, each rank's resident
   state under 0.75x the whole, and the tp step's gathers exactly the
   QKV outputs, the logits and the biases read whole; each case
   launching the six training kernels TRAIN_LAUNCHES_PER_STEP times a
   rank and step; (c) ShardedPredictor dp=2 on TRAIN_CONFIG's logits
   program within 1e-5 of Predictor; the parts' seconds and the
   collectives' counts and bytes;
33. row-sharded embedding tables (`paddle_tpu_torch.parallel.embedding`)
   on the recommender of bench.py at full width (V 100000, D 64, T 64,
   batch 64, Zipf(1.1) ids, Adam 1e-3): (a) a one-rank NCCL world,
   train_loop(mesh={"ep": 1}) on the is_distributed program bitwise the
   plain sparse run, no collective; (b) two spawned gloo ranks over
   CUDA tensors, ep=2 exact with the psum lookup and then the id
   exchange at the capacity planned from the feeds, each 4 steps after
   a warm-up one, losses and every persistable (table, both Adam
   moments) bitwise the single-process card run; each rank's resident
   table and moments half the whole; (c) ep=2 fast, psum and exchange,
   losses within 1e-5 relative of it; (d) one process: the tiered
   table of bench.py:941 (V 50000, D 32, batch 32, T 16, a pool of 1562
   rows, 8 steps in windows of 4) bitwise the untiered run; (e)
   ShardedPredictor {"ep": 2} on the two ranks, exact and fast, with and
   without a REC_CACHE_ROWS hot-row cache, bitwise the Predictor's reply;
   seconds a step, the collectives' calls and bytes a step, the planned
   capacity, the resident bytes, the tiered hit rate and pool bytes.  No
   port kernel launches on this path, and two ranks on one card show
   placement and parity, not scaling;
34. sequence-parallel attention and the GPipe pipeline
   (`paddle_tpu_torch.parallel.ring_attention`, `.pipeline`) at the LM's
   attention width (12 heads of 64): (a) a one-rank NCCL world: ring and
   Ulysses at sp=1 bitwise the single flash (out and dq/dk/dv, f32 and
   bf16, T 8192 causal), pipeline_apply at pp=1 in one microbatch
   bitwise pipeline_reference; the stage's four kernels called at the
   pipeline's shapes (LayerNorm R 2048 F 768, flash B 4 H 12 T 512
   causal, f32) against their plain versions; (b) two spawned gloo ranks over CUDA
   tensors: ring and Ulysses, causal and full, f32 and bf16, at B 1 T
   8192 (4096 a rank), out and dq/dk/dv of sum(out * w) against the
   single-process FlashAttention over the whole T and against the
   kernels' plain versions (each tensor on its own: F32_TOL; bf16 one
   bf16 step of its max |reference| plus BF16_FLOOR), each rank's
   flash launches (causal ring: rank 0 one block, rank 1 two), the hops
   and all-to-alls and their bytes; the pipeline at pp=2 over a post-LN
   decoder block at TRAIN_CONFIG width in f32 (x [16, 512, 768], 4
   microbatches): output and each stage's gradients of sum(out ** 2)
   within PP_RTOL of pipeline_reference, run on each microbatch in turn
   and on the whole batch, and within F32_TOL of max |reference| of
   pipeline_reference over the stage's plain twin (the kernels' plain
   forwards, differentiated by autograd), the other stage's gradient
   rows zero, 4 flash and 8 LayerNorm launches a rank each way, 5 hops
   each way and one all-reduce; pipeline_window K 2 bitwise with bubble
   0.2, its stage report's flops those of the stage's four products and
   its flash forward;
35. the dataset master and the parameter server
   (`paddle_tpu_torch.distributed`): (a) ``python -m paddle_tpu_torch
   pserver`` with a 2 s task timeout over 8 record files of 8 chunks
   written by the port; two workers on the card lease tasks through
   MasterClient and train tests/test_dist_train.py's fit-a-line program;
   one is SIGKILLed while it holds its second lease; every task is
   finished once and the survivor's loss falls; (b) a ListenAndServ
   (fan_in=2) pserver on the card whose sub-block applies SGD to every
   parameter of the LM at TRAIN_CONFIG width, depth cut to 2, and two
   trainers on the card that Send their batch-16 gradients for 2
   rounds (cut from 3 for time): after each round the parameters (and
   each loss) are bitwise the single-process card run that sums both
   batches' gradients and applies the sgd rule's update; the round
   seconds, the bytes on the wire, the straggler gap and
   pserver_rounds_total;
36. the legacy training API (`paddle_tpu_torch.v2` over
   `trainer_config_helpers`, fed by `trainer.PyDataProvider2`), through
   paddle.layer, paddle.parameters.create, paddle.trainer.SGD(...).train
   and paddle.infer on the card: the BatchNorm backward against its
   plain version at small_vgg's first block (NCHW f32 relu, N 128, C 64,
   32x32); (a) the GRU classifier of tools/gru_bench.py:47-54 in the v2
   DSL at its full width (vocab 30000, H 512), f32, Adam 1e-3, batch
   32, T 80, 20 steps from a @provider: step p50/p99 between
   EndIteration events, examples/s, a profiled step's device ms and busy
   share, one gru_fwd and one gru_bwd launch a step; one plain-SGD step
   at batch 4 with ragged lengths from the same Parameters on the card
   and on the CPU, the cost and every parameter after it within V2_TOL;
   paddle.infer over 64 samples on both within V2_TOL; to_tar and
   from_tar bitwise; (b) networks.small_vgg on CIFAR-10 shapes at batch
   128 (Momentum 0.9, lr 0.1/128, L2 5e-4*128), 10 steps: step p50, the
   BatchNorm backward's launches a step from the wrappers' counts and
   from the profile (11), finite costs, SGD.test on the card against the
   CPU's from the same Parameters within V2_TOL;
37. CSP (`paddle_tpu_torch.concurrency`, the channel, go and select
   rules) and the native C++ runtime (`paddle_tpu_torch.native`, built
   with g++ at first use): (a) ResNet-50 at phase 7's program and batch
   (224x224 NHWC, program.amp, Momentum, batch 128), trained CSP_STEPS
   steps from CSP_BATCHES distinct batches of seeded uint8 images
   written by dataset.common.convert through the C++ writer (zlib), one
   shard a batch, CSP_WRITERS at once: a Go producer reads them with
   reader.creator.recordio_threaded (the C++ FileLoader, 4 threads),
   unpickles, stacks, copies pinned to the card on a side stream and
   normalizes there in f32, and sends each batch on a channel of
   capacity 2; the consumer receives until the channel is closed and
   runs Executor.run(feed=...) a batch; the same steps from batches
   already on the card: both steps' p50/p99 and images/s, their ratio,
   the consumer's wait in recv and the producer's in send, a profiled
   fed step's device ms and busy share with its 53 BatchNorm backward
   launches, the write's seconds and MB/s, the loader alone with 1 and 4
   threads against the Python Scanner (records/s, MB/s), the producer
   alone (ms a batch with a consumer that only receives); every sample
   index exactly once a pass, the FileLoader opened and no Python
   Scanner built, and one f32 step at batch 4 through the pipeline
   bitwise the same step fed directly; (b) the reference's CSP programs
   on Executor(CUDAPlace(0)), each bounded by CSP_PROGRAM_TIMEOUT: the
   simple routine (1234), the daisy chain at n = 100 (101) and
   Fibonacci through ProgramGo + ProgramSelect + While (34), exactly,
   with CUDA payloads; 1000 unbuffered rendezvous of a [1] CUDA tensor
   between two Go threads (us a pair); (c) phase 9's stacked LSTM
   classifier at LSTM_CONFIG, f32, exported with io.save_inference_model
   and run on 4 sequences of length 80 by the card Predictor (2 lstm_fwd
   launches), native.CpuPredictor and the C API (the two C++ runs at
   once), within CSP_CPP_TOL of each other, each one's ms;
38. head dims 128 and 16 and hidden width 2048, at full width: (a)
   the port's TransformerLM at Pythia-1.4B's widths (PYTHIA_1B4: 16
   heads of 128), its weights made on the card from a seed, served in
   bf16 by DecodeEngine on SH_SLOTS slots (SH_REQUESTS prompts of
   8-1024 ids, SH_NEW new tokens each; two streams held to
   the full recompute by phase 4's rule), then in f32 by an exact engine
   on 2 slots over max_len 512 (every token bitwise the exact full
   recompute); (b) the same widths at depth 4, T 1024, batch 8 through
   transformer_lm_train_program and Executor.train_loop, 5 steps in f32
   and 5 under MixedPrecision(Adam), the loss finite and falling; (c)
   the JAX package's default servable model (heads of 16), saved by the
   port and served (every stream held to the full recompute); (d) phase
   9's stacked LSTM and phase 10's GRU classifier at hidden width 2048,
   batch 32, T 80, 5 steps each in f32 and under amp; the attention
   launches counted by head-dim code (d128 or d16) and the recurrent
   ones by path (stepwise), step p50 and device ms of each part;
then a JSON line with every ported kernel's launches (with
launches_sparse_training, launches_remat_training,
launches_remat_plain_training, launches_observe_training,
launches_observe_serving, launches_fleet, launches_mesh,
launches_sequence_parallel, launches_pipeline, launches_pserver,
launches_v2, launches_csp and launches_shapes, and launches_by_path:
phase 38's legs by code or path, and every launch of the run by path,
checks included), error and times, the
card's name and power limit, and the last line: {"ok": true, "device":
{...}}.

With --serving it runs only phase 1, the paged-attention and LayerNorm
checks and timings of phase 3, and phase 4; with --resnet phase 1, the
BatchNorm backward's checks and timings and phase 7; with --lstm phase 1,
the LSTM and GRU checks and timings and phases 9 and 10; with --ln phase
1 and the LayerNorm forward and backward checks and timings; with
--frontdoor phase 1 and phase 12; with --decode-modes phase 1, the
row-stable product's phase 3 and phase 13; with --vgg phase 1, the
BatchNorm backward's checks and timings and phases 14-16; with
--amp-train phase 1 and phase 17; with --seq2seq phase 1, the LSTM and
softmax cross-entropy checks and timings at the seq2seq shapes and
phases 19 and 20; with --xent phase 1 and the softmax cross-entropy
checks and timings of phase 3; with --genprog phase 1 and phase 22;
with --ssd phase 1, the BatchNorm backward's checks at phase 24's shapes
and its times (kernel, plain, cuDNN) summed over the step's 35 launches,
and phase 24; with --sparse phase 1 and phase 26; with --remat phase 1
and phase 27; with --observe phase 1 and phases 28 and 29; with
--fleet phase 1 and phases 30 and 31; with --mesh phase 1 and phase
32; with --sharded-embedding phase 1 and phase 33; with
--sequence-parallel phase 1 and phase 34; with --pserver phase 1 and
phase 35; with --v2 phase 1, phase 2 for the GRU and BatchNorm sources,
the GRU's phase 3 checks and timings, and phase 36; with --csp phase 1,
phase 2 for the BatchNorm backward and LSTM sources, their phase 3
checks and timings, and phase 37; with --shapes phase 1, phase 2, the
phase 3 checks and timings of the head dims 8, 16, 80 and 128 and of the
recurrent widths' limits, and phase 38.
Each prints its results as one JSON line (no result line): run from two
checkouts in turns, it compares two versions of those kernels on one
card.  In these
modes a recurrent library without the stepwise path (an older one) has
its limits' checks skipped and recorded, not fatal, so that an older
kernel can be measured too.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet): memory rate and dense op rates.
#: "float32" is the CUDA cores' rate; "float32_3xtf32" that of an f32
#: product on the tensor cores as three TF32 products (the flash kernels)
MEM_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12,
            "float32_3xtf32": 495e12 / 3}
#: stated tolerances of kernel vs plain version.  Every kernel accumulates
#: in f32 and rounds its output once, as the plain version does.
#: An f32 output (any f32 output, the lse and the LN statistics of bf16
#: inputs included): max abs error <= F32_TOL * max(1, max |plain|), the
#: same f32 math summed in another order (the flash kernels' 3xTF32
#: products included).  A bf16 output, per element:
#: |kernel - plain| <= BF16_REL * |plain| + BF16_FLOOR, i.e. one bf16
#: rounding step (2^-7 relative at most) apart, plus a floor for the f32
#: reordering error of values near 0 (f32 errors measured at <= 3e-6).
#: The bf16 flash kernels round p and ds to bf16 as product operands,
#: which the plain versions do not; their outputs are held to one bf16
#: step of max(1, max |plain|) ("bf16_max" in `_err`).
F32_TOL = 2e-5
BF16_REL, BF16_FLOOR = 2.0 ** -7, 1e-4
#: engine logits against the full-prefix recompute after 12 bf16 layers:
#: max abs error over max(1, max |logit|)
E2E_TOL = 2e-2
FULL_WIDTH = dict(vocab=32000, max_len=2048, n_layers=12, d_model=768,
                  n_heads=12, d_ff=3072, eos_id=None)
#: the kernels the serving path runs
SERVE_KERNELS = ("paged_attention", "flash_attention_fwd", "layer_norm_fwd")
#: the repo's at-scale training config (bench.py bench_transformer_big):
#: 90.6 M trainable parameters, Adam, f32
TRAIN_CONFIG = dict(vocab=8192, max_len=512, n_layers=12, d_model=768,
                    n_heads=12, d_ff=3072)
TRAIN_BATCH, TRAIN_STEPS = 16, 20
#: kernel launches per training step: one attention and two LayerNorms in
#: each of the 12 layers, one loss head
TRAIN_LAUNCHES_PER_STEP = {
    "flash_attention_fwd": 12, "flash_attention_bwd": 12,
    "layer_norm_fwd": 24, "layer_norm_bwd": 24,
    "softmax_xent_fwd": 1, "softmax_xent_bwd": 1, "paged_attention": 0,
    "batch_norm_bwd": 0, "lstm_fwd": 0, "lstm_bwd": 0, "gru_fwd": 0,
    "gru_bwd": 0}
#: one step on the card against the same step on the CPU, both in full
#: f32 (TF32 off): the two devices sum every GEMM and reduction in
#: another order, and 12 post-LN layers of backward compound those
#: roundings; f32 reordering alone is ~1e-6 relative per sum, so the
#: limits leave an order of magnitude over what we expect (<= 1e-4):
#: loss relative error, and each @GRAD's max abs error over that
#: gradient's max |value|
CPU_LOSS_RTOL = 1e-4
CPU_GRAD_RTOL = 1e-3
#: the repo's ResNet-50 training config (bench.py bench_resnet, data
#: format NHWC, program.amp on): 25.6 M trainable parameters, Momentum
RESNET_CONFIG = dict(depth=50, class_dim=1000, image_shape=(224, 224, 3),
                     data_format="NHWC", lr=0.01, optimizer="momentum")
RESNET_BATCH, RESNET_STEPS = 128, 20
#: kernel launches per ResNet-50 step: one BatchNorm backward for each of
#: the 53 conv + BatchNorm layers, nothing else of the port's
RESNET_LAUNCHES_PER_STEP = dict(
    {name: 0 for name in TRAIN_LAUNCHES_PER_STEP}, batch_norm_bwd=53)
#: ResNet-50 card against CPU in full f32 at batch 2 (resnet_card_vs_cpu):
#: each @GRAD's norm-wise error may reach this many times the CPU's own
#: spread between two orders of summation
RESNET_CPU_BATCH = 2
RESNET_SPREAD_FACTOR = 4
#: BatchNorm backward shapes of ResNet-50 at batch 128, (N, H, W, C),
#: VGG-16's largest launch (block 1) and its fc BatchNorm at batch 128,
#: and a ragged one (R 1000 x C 96): each is checked as NHWC (N*H*W, C,
#: 1) and as NCHW (N, C, H*W)
BN_SHAPES = {"stem": (128, 112, 112, 64),
             "stage-1 expansion": (128, 56, 56, 256),
             "stage 4": (128, 7, 7, 2048), "ragged": (8, 5, 25, 96),
             "vgg block 1": (128, 224, 224, 64), "vgg fc": (128, 1, 1, 512)}
#: MobileNet-SSD's BatchNorm backward launches in phase 24 (batch 32,
#: NCHW, f32, relu), (N, H, W, C): every (H*W, C) its 35 conv_bn layers
#: give, each a launch geometry of its own (`kernels.bn_bwd_geometry`);
#: checked as NCHW only, the path's layout (`train_ssd` asserts that the
#: program's BatchNorms are these)
BN_SSD_SHAPES = {f"ssd {h}x{w} C{c}": (32, h, w, c) for h, w, c in (
    (150, 150, 32), (150, 150, 64), (75, 75, 64), (75, 75, 128),
    (38, 38, 128), (38, 38, 256), (19, 19, 256), (19, 19, 512),
    (10, 10, 512), (10, 10, 1024), (10, 10, 256), (5, 5, 512),
    (5, 5, 128), (3, 3, 256), (3, 3, 128), (2, 2, 256), (2, 2, 64),
    (1, 1, 128))}
#: the BatchNorm backward's timed cases, (shape, layout, dtype, act) ->
#: record key: the main path's dtype and layout at its largest launch
#: (the stem, relu fused), a stage-1 one, a stage-4 one whose x and dy
#: fit in L2, and VGG-16's block 1 in its NCHW layout
BN_TIMED = {("stem", "NHWC", "bfloat16", "relu"): "main",
            ("stage-1 expansion", "NHWC", "bfloat16", None): "training",
            ("stage 4", "NHWC", "bfloat16", None): "stage4",
            ("vgg block 1", "NCHW", "bfloat16", "relu"): "vgg"}
#: the stacked dynamic LSTM at bench.py bench_lstm's config (:591-626:
#: models/stacked_lstm.py lstm_net, dict 30000, emb 512, hid 512, three
#: recurrences) and the GRU classifier of tools/gru_bench.py (vocab 30000,
#: H 512), each at batch 32, T 80, Adam lr 1e-3, program.amp on, on one
#: seeded batch with full lengths (as the bench feeds)
LSTM_CONFIG = dict(dict_dim=30000, emb_dim=512, hid_dim=512, stacked_num=3)
GRU_CONFIG = dict(vocab=30000, hid=512)
SEQ_BATCH, SEQ_T, SEQ_STEPS = 32, 80, 20
#: kernel launches per step: the two dynamic_lstm layers (the DynamicRNN
#: layer is eager torch) run one LSTM forward and one backward each; the
#: GRU classifier one GRU forward and backward
SEQ_LAUNCHES_PER_STEP = {
    "lstm": dict({name: 0 for name in TRAIN_LAUNCHES_PER_STEP},
                 lstm_fwd=2, lstm_bwd=2),
    "gru": dict({name: 0 for name in TRAIN_LAUNCHES_PER_STEP},
                gru_fwd=1, gru_bwd=1)}
#: phase 16: rules that sum (reductions, products, convolutions, norms,
#: losses) are held to this many times max(1, max |cpu|) on the card
#: against the CPU; elementwise rules to F32_TOL
SUM_TOL = 1e-4
#: rules phase 16 leaves to the training phases: the optimizers and the
#: backward op run in every training step (and every optimizer rule in
#: phase 18), the DynamicRNN in phase 9, the loss scaler's rules in
#: phase 17, the parameter server's op pair (a server blocks until a
#: shutdown message) in phase 35, the CSP rules (a rendezvous needs a
#: peer) in phase 37
OPTIMIZER_RULES = ("sgd", "momentum", "adam", "adamax", "adagrad",
                   "decayed_adagrad", "adadelta", "rmsprop", "ftrl",
                   "proximal_gd", "proximal_adagrad", "average_accumulates")
PHASE16_ELSEWHERE = set(OPTIMIZER_RULES) | {
    "backward", "dynamic_rnn", "check_finite_and_unscale",
    "update_loss_scaling", "listen_and_serv", "send", "channel_create",
    "channel_send", "channel_recv", "channel_close", "go", "select"}
#: phase 11: one f32 step of each at full width on the card and the CPU,
#: batch 4, ragged lengths
SEQ_CPU_BATCH = 4
#: VGG-16 bn_drop at benchmark/fluid/vgg.py's config (:14-38 with
#: bench_util.py:19-30's defaults): 224x224 NCHW, 1000 classes, batch
#: 128, program.amp, Adam 1e-4
VGG_CONFIG = dict(image_shape=(3, 224, 224), class_dim=1000, lr=1e-4)
VGG_BATCH, VGG_STEPS = 128, 20
#: BatchNorm backward launches per VGG-16 step: the 13 conv BatchNorms
#: (relu fused, NCHW (N, C, H*W) views) and the one over the fc output
VGG_LAUNCHES_PER_STEP = dict(
    {name: 0 for name in TRAIN_LAUNCHES_PER_STEP}, batch_norm_bwd=14)
#: phase 15: one f32 VGG-16 step at batch 8 on the card and on the CPU,
#: each held to the f64 step on the CPU, for the feed and
#: VGG_F32_DRAWS - 1 one-ulp moves of it; the slack of the distance rule
#: (tests/test_torch_book_models.py NORM_TOL)
VGG_CPU_BATCH = 8
VGG_F32_DRAWS = 3
VGG_NORM_TOL = 1e-4
#: LeNet-5 at benchmark/fluid/mnist.py's config (:14-30): 1x28x28, 10
#: classes, batch 128, program.amp, Adam 1e-3; it runs no port kernel
LENET_CONFIG = dict(image_shape=(1, 28, 28), class_num=10, lr=1e-3)
LENET_BATCH, LENET_STEPS = 128, 20
LENET_LAUNCHES_PER_STEP = {name: 0 for name in TRAIN_LAUNCHES_PER_STEP}
#: phase 17: TRAIN_CONFIG under MixedPrecision(Adam) (bench.py
#: bench_transformer_big's transformer_lm_train_program(amp=True)) at
#: batch TRAIN_BATCH through Executor.train_loop: AMP_STEPS steps in
#: windows of AMP_K steps (one host sync a window), a checkpoint every
#: AMP_CKPT_EVERY steps, a resume from the last one; then one step at a
#: loss scale of AMP_SKIP_SCALE, where the scaled loss overflows f32
AMP_STEPS, AMP_K, AMP_CKPT_EVERY = 20, 4, 8
AMP_SKIP_SCALE = 2.0 ** 127


def _time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes, ops, dtype):
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _err(out, ref, rule=None):
    """(max abs error of ``out`` against ``ref``, its share of the stated
    tolerance); equal infinities count as no error.  ``rule`` is "f32"
    (F32_TOL relative to max(1, max |ref|)), "bf16" (per element, one
    bf16 rounding step plus BF16_FLOOR), "bf16_tensor" (one bf16 rounding
    step of max |ref| plus BF16_FLOOR) or "bf16_max" (one bf16 rounding
    step of max(1, max |ref|)); by default the rule of ``ref``'s dtype."""
    import torch
    a, b = out.float(), ref.float()
    both_inf = torch.isinf(a) & torch.isinf(b) & (torch.sign(a)
                                                  == torch.sign(b))
    d = torch.where(both_inf, torch.zeros_like(a), (a - b).abs())
    mag = torch.where(torch.isinf(b), torch.zeros_like(b), b.abs())
    rule = rule or ("bf16" if ref.dtype == torch.bfloat16 else "f32")
    if rule == "bf16":
        share = (d / (BF16_REL * mag + BF16_FLOOR)).max()
    elif rule == "bf16_tensor":
        share = d.max() / (BF16_REL * float(mag.max()) + BF16_FLOOR)
    elif rule == "bf16_max":
        share = d.max() / (BF16_REL * max(1.0, float(mag.max())))
    else:
        share = d.max() / (F32_TOL * max(1.0, float(mag.max())))
    return float(d.max()), float(share)


def _check(name, pairs, dtype, label, rec, rule=None):
    """Fail unless every (kernel output, plain output) pair is within the
    tolerance of its dtype (or of ``rule``, see `_err`); keep the largest
    abs error and the largest share of the tolerance in the kernel's
    record ``rec``."""
    import torch
    errs = [_err(o, r, rule) for o, r in pairs]
    err = max(e for e, _ in errs)
    share = max(s for _, s in errs)
    ok = share <= 1.0
    differ = sum(int((o != r).sum()) for o, r in pairs)
    mag = max(float(torch.nan_to_num(r.float(), posinf=0.0,
                                     neginf=0.0).abs().max())
              for _, r in pairs)
    print(f"  {name} {label} {dtype}: max_abs_err {err:.3e}, "
          f"{share:.3f} of the tolerance {'ok' if ok else 'FAIL'} "
          f"({differ} elements differ; max |plain| {mag:.3e})",
          flush=True)
    if not ok:
        raise AssertionError(f"{name} {label} {dtype} disagrees with its "
                             f"plain version: {share:.3f} of the tolerance")
    rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
    rec["limit_share"] = max(rec.get("limit_share", 0.0), share)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

#: paged-attention cases, (slots, heads, head_dim, block_len, pages,
#: positions): the serving shape (S16, 12 heads of 64, ragged positions
#: with slots 3 and 9 idle: sentinel pages, index 0), one slot of 2047
#: positions (decoding a single long stream), head_dim 128 / 32 / 80 / 8
#: cases whose indexes sit on page and split edges, past the table's
#: capacity and at -1 (no live position: the output is 0; 80 and 8 run
#: the codes 128 and 16 with their tail zero-filled), and phase 38's
#: serving shape (S16, 16 heads of 128)
PAGED_CASES = {
    "serving": (16, 12, 64, 16, 128, None),
    "one long slot": (1, 12, 64, 16, 128, [2046]),
    "D128 edges": (4, 8, 128, 16, 32, [511, -1, 16, 130]),
    "D32 edges": (5, 4, 32, 8, 64, [15, 127, 0, 600, -1]),
    "D80 edges": (4, 8, 80, 16, 32, [511, -1, 16, 130]),
    "D8 edges": (5, 4, 8, 8, 64, [15, 127, 0, 600, -1]),
    "D128 serving": (16, 16, 128, 16, 128, None)}
#: the cases timed in bf16 (the rest are checked only), and the record
#: key of each ("serving" fills the kernel's record itself)
PAGED_TIMED = {"serving": None, "one long slot": "one_long_slot",
               "D128 serving": "d128_serving"}
#: the head dims off the first codes: the paged and flash cases
#: `--shapes` runs
NEW_HEAD_DIMS = (8, 16, 80, 128)


def _paged_inputs(S, H, D, L, P, positions, g):
    """index [S] and table [S, P] on the card for one paged case: each
    live slot gets distinct random blocks for the pages it needs, the
    rest of its row (and an idle slot's whole row) the sentinel N."""
    import torch
    N = S * P
    if positions is None:
        index = torch.randint(0, P * L, (S,), generator=g).to(torch.int32)
        index[3] = index[9] = 0
    else:
        index = torch.tensor(positions, dtype=torch.int32)
    table = torch.full((S, P), N, dtype=torch.int32)
    perm = torch.randperm(N, generator=g).to(torch.int32)
    for s in range(S):
        if positions is None and s in (3, 9):
            continue
        need = min(int(index[s]) // L + 1, P) if index[s] >= 0 else 0
        table[s, :need] = perm[s * P:s * P + need]
    dev = torch.device("cuda")
    return N, index.to(dev), table.to(dev)


def check_paged_attention(rec, dims=None):
    """Phase 3 for the paged kernel: every PAGED_CASES case (those of
    head dims ``dims`` alone, if given) against the plain version in f32
    and bf16, the PAGED_TIMED ones timed in bf16."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kernels as K
    g = torch.Generator(device="cpu").manual_seed(11)
    dev = torch.device("cuda")
    for label, (S, H, D, L, P, positions) in PAGED_CASES.items():
        if dims is not None and D not in dims:
            continue
        N, index, table = _paged_inputs(S, H, D, L, P, positions, g)
        n_pos = sum(min(int(i), P * L - 1) + 1 for i in index.cpu()
                    if i >= 0)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).replace("torch.", "")
            q = torch.randn(S, H, 1, D, generator=g).to(dev, dtype)
            pk = torch.randn(N, L, H, D, generator=g).to(dev, dtype)
            pv = torch.randn(N, L, H, D, generator=g).to(dev, dtype)
            out = K.paged_attention(q, pk, pv, table, index)
            ref = K.paged_attention_plain(q, pk, pv, table, index)
            torch.cuda.synchronize()
            _check("paged_attention", [(out, ref)], dn,
                   f"{label} S{S} H{H} D{D} L{L} P{P}", rec)
            if dtype is not torch.bfloat16 or label not in PAGED_TIMED:
                continue
            nbytes = (n_pos * H * D * 2 + 2 * S * H * D) * 2 \
                + table.numel() * 4 + index.numel() * 4
            live = (torch.arange(P * L, device=dev)[None, :]
                    <= index[:, None].long())[:, None, None, :]

            def library():
                k = K.gather_slot_kv(pk, table)
                v = K.gather_slot_kv(pv, table)
                return F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=live)
            times = _kernel_times(
                {}, lambda: K.paged_attention(q, pk, pv, table, index),
                lambda: K.paged_attention_plain(q, pk, pv, table, index),
                library, nbytes, 4 * n_pos * H * D, dn,
                f"S{S} H{H} D{D} L{L} P{P} bf16, {n_pos} positions")
            times["host_us"] = _host_us(
                lambda: K.paged_attention(q, pk, pv, table, index))
            print(f"    wrapper host us per call {times['host_us']:.2f}",
                  flush=True)
            if PAGED_TIMED[label] is None:
                rec.update(times)
            else:
                rec[PAGED_TIMED[label]] = times


#: flash cases, (batch, tq, tk, causal) at 12 heads: the serving prefill
#: lengths, the training shape B16 T512, and the tile edges (64-row
#: tiles); at head_dim 64 (the models') all of them, at 32, 16 and 128
#: the edges and a long prefill, at 80 and 8 (the codes 128 and 16 with
#: their columns past D zero-filled) the edges; at 16 also 65544
#: batch-heads at tiny T (the kernels take them 65535 at a time)
FLASH_EDGES = [(1, t, t, True) for t in (63, 65, 129)] + [
    (1, 65, 1000, True), (1, 65, 1000, False)]
FLASH_CASES = {64: [(1, t, t, True) for t in (7, 128, 1000, 2048)]
               + [(1, 100, 1000, True), (1, 100, 1000, False),
                  (16, 512, 512, True)] + FLASH_EDGES,
               32: [(1, 7, 7, True), (2, 128, 128, False),
                    (1, 1000, 1000, True)] + FLASH_EDGES,
               16: [(1, 7, 7, True), (2, 128, 128, False),
                    (5462, 5, 9, True), (5462, 9, 5, False)] + FLASH_EDGES,
               128: [(1, 7, 7, True), (2, 128, 128, False),
                     (1, 1000, 1000, True)] + FLASH_EDGES,
               80: [(2, 100, 70, True), (2, 100, 70, False)] + FLASH_EDGES,
               8: [(2, 100, 70, True), (2, 100, 70, False)] + FLASH_EDGES}
#: the D 128 shapes timed (PERF.md section 6 rows 1-2), (batch, heads,
#: T, dtype, backward too): phase 38's prefill (B1 H16 T1000) and
#: training step (B8 H16 T1024) of the Pythia-width LM, causal
FLASH_D128_TIMED = [(1, 16, 1000, "bfloat16", False),
                    (8, 16, 1024, "float32", True),
                    (8, 16, 1024, "bfloat16", True)]


def _device_ms(fn, iters=20, warmup=3):
    """Device time per call of ``fn`` from torch.profiler: the CUDA time of
    every kernel it launched, summed by name over ``iters`` calls, so,
    unlike `_time_ms`, without the host's enqueue.  Returns (ms per call,
    {kernel name: ms per call}), or (None, {}) when the profiler shows no
    device time (a measurement aid: reported, not fatal)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    names = {r.key: r.device_time_total / 1e3 / iters
             for r in prof.key_averages()
             if r.device_type == torch.autograd.DeviceType.CUDA
             and r.device_time_total > 0}
    if not names:
        print("  profiler shows no device time", flush=True)
        return None, {}
    return sum(names.values()), names


def _host_us(fn, iters=200, repeats=5, warmup=5):
    """Host microseconds per call of ``fn``: the time to enqueue ``iters``
    calls back to back, read before the closing synchronise (the card
    keeps up at the shapes this is used for, so nothing waits on it); the
    least of ``repeats`` such runs, since the host is shared and noisy."""
    import torch
    for _ in range(warmup):
        fn()
    best = math.inf
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best / iters * 1e6


def _kernel_times(rec, kernel, plain, library, nbytes, ops, dtype, shape,
                  tensor_cores=False, plain_iters=20):
    """Fill ``rec`` with the times of one timed shape: CUDA-event ms of
    kernel, plain version and library yardstick, device ms per call of
    kernel and library, and the bound; with ``tensor_cores`` an f32 shape
    is bound by 3xTF32 on the tensor cores, with the CUDA cores' bound
    beside it (the flash and recurrent kernels)."""
    rec["ms"] = _time_ms(kernel, iters=50)
    rec["plain_ms"] = _time_ms(plain, iters=plain_iters,
                               warmup=min(3, plain_iters))
    rec["library_ms"] = _time_ms(library, iters=50)
    rec["device_ms"], names = _device_ms(kernel)
    rec["library_device_ms"], lib_names = _device_ms(library)
    f32 = tensor_cores and dtype == "float32"
    rec["bound_ms"], rec["bound_by"] = _bound(
        nbytes, ops, "float32_3xtf32" if f32 else dtype)
    # no call can beat its bound; a bytes bound holds only for inputs that
    # do not fit the L2 between calls
    if rec["bound_by"] == "operations" or nbytes > L2_BYTES:
        for key in ("device_ms", "library_device_ms"):
            if rec[key] is not None and rec[key] < rec["bound_ms"]:
                print(f"  {shape}: {key} {rec[key]:.5f} is under the bound "
                      f"{rec['bound_ms']:.5f}: a broken measurement, not a "
                      "time", flush=True)
                rec[key + "_broken"], rec[key] = rec[key], None
    if f32:
        rec["bound_cuda_core_ms"] = _bound(nbytes, ops, "float32")[0]
    rec["shape"] = shape
    print(f"  {shape}: kernel {rec['ms']:.4f} ms (device "
          f"{rec['device_ms']}), library {rec['library_ms']:.4f} ms (device "
          f"{rec['library_device_ms']}), plain {rec['plain_ms']:.4f} ms, "
          f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}"
          + (f"; CUDA cores {rec['bound_cuda_core_ms']:.4f}" if f32 else "")
          + ")", flush=True)
    for what, table in (("kernel", names), ("library", lib_names)):
        print(f"    {what} device ms per call by name: " + "; ".join(
            f"{n[:70]} {t:.4f}" for n, t in sorted(table.items(),
                                                     key=lambda x: -x[1])),
              flush=True)
    return rec


def _flash_check(name, got, want, dtype, label, rec):
    """Hold a flash kernel's outputs to the plain version's: every f32
    output to F32_TOL; bf16 outputs to one bf16 step of their largest value
    ("bf16_max": the kernels round p and ds as product operands)."""
    import torch
    f32 = [(o, r) for o, r in zip(got, want) if r.dtype == torch.float32]
    bf = [(o, r) for o, r in zip(got, want) if r.dtype == torch.bfloat16]
    if f32:
        _check(name, f32, dtype, label + (" f32 lse" if bf else ""), rec,
               "f32")
    if bf:
        _check(name, bf, dtype, label + " (bf16_max)", rec, "bf16_max")


def check_flash_attention(rec, dims=None):
    """Phase 3 for the flash forward: every FLASH_CASES case (of head dims
    ``dims`` alone, if given) against the plain version in f32 and bf16;
    the D 64 serving and training shapes timed."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kernels as K
    H = 12
    g = torch.Generator(device="cpu").manual_seed(12)
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        for D, cases in FLASH_CASES.items():
            if dims is not None and D not in dims:
                continue
            for b, tq, tk, causal in cases:
                q = torch.randn(b, H, tq, D, generator=g).to(dev, dtype)
                k = torch.randn(b, H, tk, D, generator=g).to(dev, dtype)
                v = torch.randn(b, H, tk, D, generator=g).to(dev, dtype)
                out, lse = K.flash_attention_fwd(q, k, v, causal)
                ref, ref_lse = K.flash_attention_fwd_plain(q, k, v, causal)
                torch.cuda.synchronize()
                _flash_check("flash_attention_fwd", (out, lse),
                             (ref, ref_lse), dn,
                             f"D{D} B{b} tq{tq} tk{tk} causal={causal}", rec)
                if D != 64:
                    continue
                if dtype is torch.float32 and b == 16:
                    pairs = b * H * tq * (tq + 1) // 2
                    n = b * H * tq * D
                    rec["training"] = _kernel_times(
                        {},
                        lambda: K.flash_attention_fwd(q, k, v, True),
                        lambda: K.flash_attention_fwd_plain(q, k, v, True),
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=True),
                        4 * n * 4 + b * H * tq * 4, 4 * pairs * D, dn,
                        f"B{b} H{H} T{tq} D{D} causal f32",
                        tensor_cores=True)
                if dtype is torch.bfloat16 and (tq, tk, causal) == (
                        1000, 1000, True):
                    pairs = tq * (tq + 1) // 2
                    _kernel_times(
                        rec,
                        lambda: K.flash_attention_fwd(q, k, v, True),
                        lambda: K.flash_attention_fwd_plain(q, k, v, True),
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=True),
                        4 * tq * H * D * 2 + tq * H * 4, 4 * pairs * H * D,
                        dn, f"B1 H{H} T{tq} D{D} causal bf16",
                        tensor_cores=True)


def time_flash_d128(rec_fwd, rec_bwd):
    """The FLASH_D128_TIMED shapes: each one checked against the plain
    version, then the forward (and backward) timed beside SDPA, into
    ``rec_*["d128"]`` by shape."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kernels as K
    g = torch.Generator(device="cpu").manual_seed(26)
    dev = torch.device("cuda")
    D = 128
    for b, h, t, dn, backward in FLASH_D128_TIMED:
        dtype = getattr(torch, dn)
        size = 2 if dtype is torch.bfloat16 else 4
        q, k, v, do = (torch.randn(b, h, t, D, generator=g).to(dev, dtype)
                       for _ in range(4))
        shape = f"B{b} H{h} T{t} D{D} causal {dn}"
        out, lse = K.flash_attention_fwd(q, k, v, True)
        ref = K.flash_attention_fwd_plain(q, k, v, True)
        torch.cuda.synchronize()
        _flash_check("flash_attention_fwd", (out, lse), ref, dn, shape,
                     rec_fwd)
        pairs = b * h * t * (t + 1) // 2
        n = b * h * t * D
        rec_fwd.setdefault("d128", {})[shape] = _kernel_times(
            {}, lambda: K.flash_attention_fwd(q, k, v, True),
            lambda: K.flash_attention_fwd_plain(q, k, v, True),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            4 * n * size + b * h * t * 4, 4 * pairs * D, dn, shape,
            tensor_cores=True, plain_iters=3)
        if not backward:
            continue
        got = K.flash_attention_bwd(q, k, v, out, lse, do, True)
        want = K.flash_attention_bwd_plain(q, k, v, out, lse, do, True)
        torch.cuda.synchronize()
        _flash_check("flash_attention_bwd", got, want, dn, shape, rec_bwd)
        del want
        qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
        lib = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
        rec_bwd.setdefault("d128", {})[shape] = _kernel_times(
            {}, lambda: K.flash_attention_bwd(q, k, v, out, lse, do, True),
            lambda: K.flash_attention_bwd_plain(q, k, v, out, lse, do, True),
            lambda: torch.autograd.grad(lib, (qq, kk, vv), do,
                                        retain_graph=True),
            8 * n * size + b * h * t * 4, 10 * pairs * D, dn, shape,
            tensor_cores=True, plain_iters=3)
        del lib, qq, kk, vv
        torch.cuda.empty_cache()


#: the kernel libraries whose products run on the tensor cores: the flash
#: pair, and the LSTM and GRU recurrences' products (bf16, or 3xTF32)
TENSOR_CORE_SOURCES = ("flash_attention", "flash_attention_bwd", "lstm",
                       "gru")
#: kernels whose own machine code must hold tensor-core instructions, by
#: library: every instance (w type, units a block) of the GRU forward
TENSOR_CORE_FUNCTIONS = {"gru": "gru_fwd_kernel"}


def _hmma_by_function(sass):
    """{function name: HMMA instructions in it} of cuobjdump -sass output
    (each function's code follows its "Function : <name>" line)."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    return counts


def check_tensor_cores(paths):
    """Count the tensor-core instructions (HMMA) in the machine code of
    TENSOR_CORE_SOURCES' libraries with cuobjdump (beside nvcc, or in
    Triton's package); fail when one has none, or when a kernel of
    TENSOR_CORE_FUNCTIONS has none in its own functions."""
    import glob
    from paddle_tpu_torch.ops import _build
    cands = [os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")]
    try:
        import triton
        cands += glob.glob(os.path.join(os.path.dirname(triton.__file__),
                                        "backends", "nvidia", "bin",
                                        "cuobjdump"))
    except ImportError:
        pass
    tool = next((c for c in cands if os.path.exists(c)), None)
    if tool is None:
        raise AssertionError("cuobjdump not found: " + ", ".join(cands))
    counts = {}
    for name in TENSOR_CORE_SOURCES:
        sass = subprocess.run([tool, "-sass", str(paths[name])],
                              capture_output=True, text=True,
                              check=True).stdout
        counts[name] = sum("HMMA" in line for line in sass.splitlines())
        print(f"  {name}: {counts[name]} HMMA instructions "
              f"(cuobjdump -sass)", flush=True)
        if counts[name] == 0:
            raise AssertionError(f"{name} holds no tensor-core instruction")
        kernel = TENSOR_CORE_FUNCTIONS.get(name)
        if kernel is None:
            continue
        own = {f: n for f, n in _hmma_by_function(sass).items()
               if kernel in f}
        print(f"  {name}: {kernel}'s {len(own)} instances hold "
              f"{sorted(own.values())} HMMA instructions", flush=True)
        if not own or min(own.values()) == 0:
            raise AssertionError(f"an instance of {kernel} holds no "
                                 "tensor-core instruction")
        counts[kernel] = sum(own.values())
    return counts


#: LayerNorm forward widths checked at R16 and R2048: the models' 768,
#: the FFN's 3072, and widths on both sides of the warp-per-row path's
#: limits (a row of at most 1024 features in whole 16-byte chunks)
LN_WIDTHS = (37, 768, 1000, 1024, 1032, 3072)


def _ln_host_us(x, sc, bi, w16, b16):
    """Host us per call of the LayerNorm wrapper, F.layer_norm, and the
    wrapper's parts beside an alternative to each: its outputs (three
    torch.empty; or y and one [2, R] buffer split into two views), the
    stream lookup (`_stream`; or PyTorch's public call) and the bare C
    call with the arguments the wrapper passed (the library's function
    with argtypes set; or a ctypes prototype)."""
    import ctypes
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import _build, kernels as K
    kern = K.LAYER_NORM_FWD
    seen = []
    launch = kern.launch
    kern.launch = lambda *a: (seen.append(a), launch(*a))
    try:
        # held to the end: the replayed calls write into its outputs
        held = K.layer_norm_fwd(x, sc, bi, 1e-5)
    finally:
        del kern.launch
    lib = _build.load(kern.source)
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *kern.argtypes)((kern.entry, lib))
    attr = getattr(lib, kern.entry)
    attr.argtypes, attr.restype = kern.argtypes, ctypes.c_int
    r, dev = x.shape[0], x.device
    times = {
        "wrapper": _host_us(lambda: K.layer_norm_fwd(x, sc, bi, 1e-5)),
        "F.layer_norm": _host_us(
            lambda: F.layer_norm(x, (x.shape[1],), w16, b16, 1e-5)),
        "three torch.empty": _host_us(
            lambda: (torch.empty_like(x),
                     torch.empty(r, dtype=torch.float32, device=dev),
                     torch.empty(r, dtype=torch.float32, device=dev))),
        "empty_like + new_empty [2, R] + unbind": _host_us(
            lambda: (torch.empty_like(x),
                     x.new_empty((2, r), dtype=torch.float32).unbind())),
        "torch.cuda.current_stream": _host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        "_stream": _host_us(lambda: K._stream(x)),
        "C call, prototype": _host_us(lambda: proto(*seen[0])),
        "C call, argtypes": _host_us(lambda: attr(*seen[0]))}
    del held
    return times


def check_layer_norm(rec):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kernels as K
    g = torch.Generator(device="cpu").manual_seed(13)
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        for r in (16, 2048, 8192):
            for f in ((768,) if r == 8192 else LN_WIDTHS):
                x = (3 * torch.randn(r, f, generator=g) + 1).to(dev, dtype)
                sc = (1 + 0.1 * torch.randn(f, generator=g)).to(dev)
                bi = (0.1 * torch.randn(f, generator=g)).to(dev)
                y, mean, var = K.layer_norm_fwd(x, sc, bi, 1e-5)
                ry, rmean, rvar = K.layer_norm_fwd_plain(x, sc, bi, 1e-5)
                torch.cuda.synchronize()
                _check("layer_norm_fwd",
                       [(y, ry), (mean, rmean), (var, rvar)], dn,
                       f"R{r} F{f}", rec)
                w16, b16 = sc.to(dtype), bi.to(dtype)
                if dtype is torch.float32 and r == 8192:
                    rec["training"] = _kernel_times(
                        {}, lambda: K.layer_norm_fwd(x, sc, bi, 1e-5),
                        lambda: K.layer_norm_fwd_plain(x, sc, bi, 1e-5),
                        lambda: F.layer_norm(x, (f,), sc, bi, 1e-5),
                        2 * r * f * 4 + 2 * f * 4 + 2 * r * 4, 8 * r * f,
                        "float32", f"R{r} F{f} f32")
                if dtype is torch.bfloat16 and (r, f) == (16, 768):
                    _kernel_times(
                        rec, lambda: K.layer_norm_fwd(x, sc, bi, 1e-5),
                        lambda: K.layer_norm_fwd_plain(x, sc, bi, 1e-5),
                        lambda: F.layer_norm(x, (f,), w16, b16, 1e-5),
                        2 * r * f * 2 + 2 * f * 4 + 2 * r * 4, 8 * r * f,
                        "float32", f"R{r} F{f} bf16")
                    rec["host_us"] = _ln_host_us(x, sc, bi, w16, b16)
                    print("    host us per call: " + ", ".join(
                        f"{k} {v:.2f}" for k, v in rec["host_us"].items()),
                          flush=True)


def check_batch_norm_bwd(rec, ssd_only=False):
    """The BatchNorm backward against its plain version at every
    BN_SHAPES shape, NHWC and NCHW, and every BN_SSD_SHAPES shape, NCHW
    (only those with ``ssd_only``), f32 and bf16, relu and none; a second
    run at the main path's largest launch (stem, NHWC, bf16, relu) must
    repeat bit for bit.  Timed (BN_TIMED) at the stem, at a stage-1
    launch, at a stage-4 one, whose x and dy (12.8 MB) fit in L2, and at
    VGG-16's block 1 as NCHW (128, 64, 50176)."""
    import torch
    from paddle_tpu_torch.ops import kernels as K
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    cases = [] if ssd_only else [(label, shape, ("NHWC", "NCHW"))
                                 for label, shape in BN_SHAPES.items()]
    cases += [(label, shape, ("NCHW",))
              for label, shape in BN_SSD_SHAPES.items()]
    for label, (n, h, w, c), layouts in cases:
        numel = n * h * w * c
        xs = (1.5 * torch.randn(numel, generator=g, device=dev) + 0.3)
        dys = torch.randn(numel, generator=g, device=dev)
        sc = (1 + 0.3 * torch.randn(c, generator=g, device=dev))
        bi = 0.5 * torch.randn(c, generator=g, device=dev)
        views = {"NHWC": (n * h * w, c, 1), "NCHW": (n, c, h * w)}
        for layout in layouts:
            view = views[layout]
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).replace("torch.", "")
                x, dy = xs.to(dtype).view(view), dys.to(dtype).view(view)
                xf = x.float()
                mean = xf.mean(dim=(0, 2))
                inv = torch.rsqrt(xf.var(dim=(0, 2), unbiased=False) + 1e-5)
                del xf
                for act in (None, "relu"):
                    args = (x, dy, sc, bi, mean, inv, act)
                    got = K.batch_norm_bwd(*args)
                    ref = K.batch_norm_bwd_plain(*args)
                    torch.cuda.synchronize()
                    _check("batch_norm_bwd", list(zip(got, ref)), dn,
                           f"{label} {layout} {view} act={act}", rec)
                    del ref
                    case = (label, layout, dn, act)
                    if case == ("stem", "NHWC", "bfloat16", "relu"):
                        _bitwise_repeat("batch_norm_bwd", got,
                                        K.batch_norm_bwd(*args),
                                        f"{label} {layout} {dn} relu", rec)
                    del got
                    key = BN_TIMED.get(case)
                    if key is not None:
                        t = _bn_timings(args, (n, h, w, c), layout)
                        if key == "main":
                            rec.update(t)
                        else:
                            rec[key] = t


def _print_ptxas(names=None):
    """Phase 2's report: each compiled kernel's registers, shared memory
    and spills as ptxas printed them (of the sources ``names``, or all)."""
    from paddle_tpu_torch.ops import _build
    for name, log in _build.build_logs.items():
        if names is not None and name not in names:
            continue
        kernel = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1][:130]
            if "Used" in line or "spill" in line:
                print(f"  {name} {kernel}: {line.strip()}")


def _bitwise_repeat(name, got, again, label, rec):
    """Fail unless a second run's outputs ``again`` equal ``got`` bit for
    bit."""
    import torch
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"  {name} {label}: a second run is "
          f"{'bitwise equal' if same else 'DIFFERENT'}", flush=True)
    if not same:
        raise AssertionError(f"{name} does not repeat bit for bit")
    rec.setdefault("bitwise_repeat", []).append(label)


def _bn_timings(args, nhwc, layout="NHWC"):
    """Kernel, plain and library times (CUDA events and device time per
    call) and the bound of the BatchNorm backward on ``args`` (a
    ``layout`` view of an (N, H, W, C) activation), with the device time
    split by kernel (sums, reduce, dx); the library is F.batch_norm's
    backward (cuDNN) on the same tensors in the same memory format
    (channels_last for NHWC), no relu."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kernels as K
    x, dy, sc, bi = args[:4]
    n, h, w, c = nhwc
    numel = x.numel()

    def nchw(t):
        return (t.view(nhwc).permute(0, 3, 1, 2) if layout == "NHWC"
                else t.view(n, c, h, w))
    xx, ww, bb = (t.detach().requires_grad_(True)
                  for t in (nchw(x), sc, bi))
    lib = F.batch_norm(xx, None, None, ww, bb, training=True)
    gy = nchw(dy)
    rows = n * h * w if layout == "NHWC" else n
    return _kernel_times(
        {}, lambda: K.batch_norm_bwd(*args),
        lambda: K.batch_norm_bwd_plain(*args),
        lambda: torch.autograd.grad(lib, (xx, ww, bb), gy,
                                    retain_graph=True),
        3 * numel * x.element_size() + 6 * c * 4, 15 * numel, "float32",
        f"R{rows} C{c}{'' if layout == 'NHWC' else f' S{h * w}'} {layout} "
        f"{str(x.dtype)[6:]} act={args[6]}")


def check_flash_attention_bwd(rec, dims=None):
    """Phase 3 for the flash backward, as `check_flash_attention`."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kernels as K
    H = 12
    g = torch.Generator(device="cpu").manual_seed(14)
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        for D, cases in FLASH_CASES.items():
            if dims is not None and D not in dims:
                continue
            for b, tq, tk, causal in cases:
                if tq == 2048:     # the plain backward's [T, T] tensors
                    continue
                q = torch.randn(b, H, tq, D, generator=g).to(dev, dtype)
                k = torch.randn(b, H, tk, D, generator=g).to(dev, dtype)
                v = torch.randn(b, H, tk, D, generator=g).to(dev, dtype)
                do = torch.randn(b, H, tq, D, generator=g).to(dev, dtype)
                out, lse = K.flash_attention_fwd(q, k, v, causal)
                got = K.flash_attention_bwd(q, k, v, out, lse, do, causal)
                ref = K.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                  causal)
                torch.cuda.synchronize()
                label = f"D{D} B{b} tq{tq} tk{tk} causal={causal}"
                _flash_check("flash_attention_bwd", got, ref, dn, label, rec)
                if (D, b, tq, tk) != (64, 16, 512, 512):
                    continue
                _bitwise_repeat(
                    "flash_attention_bwd", got,
                    K.flash_attention_bwd(q, k, v, out, lse, do, causal),
                    dn, rec)
                if dtype is not torch.float32:
                    continue
                pairs = b * H * tq * (tq + 1) // 2
                n = b * H * tq * D
                qq, kk, vv = (t.detach().requires_grad_(True)
                              for t in (q, k, v))
                lib = F.scaled_dot_product_attention(qq, kk, vv,
                                                     is_causal=True)
                _kernel_times(
                    rec, lambda: K.flash_attention_bwd(
                        q, k, v, out, lse, do, True),
                    lambda: K.flash_attention_bwd_plain(
                        q, k, v, out, lse, do, True),
                    lambda: torch.autograd.grad(lib, (qq, kk, vv), do,
                                                retain_graph=True),
                    (5 * n + 3 * n) * 4 + b * H * tq * 4, 10 * pairs * D,
                    dn, f"B{b} H{H} T{tq} D{D} causal f32",
                    tensor_cores=True)


def check_layer_norm_bwd(rec):
    """The LayerNorm backward against its plain version at R16 and R2048
    at every LN_WIDTHS width (both sides of its warp-per-row path's
    limits) and at the LM's R8192 F768, f32 and bf16; at R8192 F768 a
    second run must repeat bit for bit, and its times are taken in both
    dtypes (f32 the LM's, under "ms"; bf16 under "bf16"), the library's
    being F.layer_norm's backward on the same tensors."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kernels as K
    g = torch.Generator(device="cpu").manual_seed(15)
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        for r in (16, 2048, 8192):
            for f in ((768,) if r == 8192 else LN_WIDTHS):
                x = (3 * torch.randn(r, f, generator=g) + 1).to(dev, dtype)
                dy = torch.randn(r, f, generator=g).to(dev, dtype)
                sc = (1 + 0.1 * torch.randn(f, generator=g)).to(dev)
                bi = (0.1 * torch.randn(f, generator=g)).to(dev)
                _, mean, var = K.layer_norm_fwd(x, sc, bi, 1e-5)
                inv = torch.rsqrt(var + 1e-5)
                args = (x, sc, mean, inv, dy)
                got = K.layer_norm_bwd(*args)
                ref = K.layer_norm_bwd_plain(*args)
                torch.cuda.synchronize()
                label = f"R{r} F{f}"
                _check("layer_norm_bwd", list(zip(got, ref)), dn, label,
                       rec)
                if r != 8192:
                    continue
                _bitwise_repeat("layer_norm_bwd", got,
                                K.layer_norm_bwd(*args), f"{label} {dn}",
                                rec)
                # the library takes scale and bias in x's dtype
                xx, ww, bb = (t.detach().to(dtype).requires_grad_(True)
                              for t in (x, sc, bi))
                lib = F.layer_norm(xx, (f,), ww, bb, 1e-5)
                item = x.element_size()
                t = _kernel_times(
                    {}, lambda: K.layer_norm_bwd(*args),
                    lambda: K.layer_norm_bwd_plain(*args),
                    lambda: torch.autograd.grad(lib, (xx, ww, bb), dy,
                                                retain_graph=True),
                    3 * r * f * item + 3 * f * 4 + 2 * r * 4, 12 * r * f,
                    "float32", f"{label} {dn}", plain_iters=50)
                if dtype is torch.float32:
                    rec.update(t)
                else:
                    rec["bf16"] = t


#: softmax cross-entropy in phase 3: (R, V, kind) checked in f32 and bf16
#: ("edges": rows of +-1e4, a row of -inf, labels -1 and V; V 30001 and
#: 1001 also start most rows off a 16-byte boundary in both dtypes), and
#: the timed shapes, (R, V) of the LM (phase 5 f32, phase 17 bf16), of
#: the seq2seq head (phase 19) and of one image's SSD confidence loss
#: (phase 24: 2278 priors, 21 classes), timed in both dtypes; the first in
#: f32 is the kernel's row in the JSON line
XENT_CASES = ((8192, 8192, "random"), (3200, 30000, "random"),
              (2278, 21, "random"), (64, 1000, "random"),
              (64, 8192, "edges"), (64, 30001, "edges"), (64, 1001, "edges"))
XENT_TIMED = ((8192, 8192), (3200, 30000), (2278, 21))


def _xent_inputs(r, v, kind, dtype, g, dev):
    """Seeded logits [R, V], labels (two out of range) and dloss."""
    import torch
    x = 2 * torch.randn(r, v, generator=g)
    lab = torch.randint(0, v, (r,), generator=g)
    if kind == "edges":
        x[::2, ::3] = 1e4           # rows that saturate the exp
        x[1::2, 1::5] = -1e4
        x[7] = -math.inf            # no term: lse -inf (label out of range)
        x[9, ::2] = -math.inf
        lab[7] = v
    lab[3], lab[5] = -1, v          # out of range: gold 0
    return (x.to(dev, dtype), lab.to(dev, torch.int32),
            torch.rand(r, generator=g).to(dev))


def check_softmax_xent(rec_fwd, rec_bwd):
    """Both softmax cross-entropy kernels against their plain versions at
    XENT_CASES, then timed at XENT_TIMED in f32 and bf16 beside
    F.cross_entropy (forward, and its backward through autograd) into
    ``rec[...]["shapes"]``."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kernels as K
    g = torch.Generator(device="cpu").manual_seed(16)
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        for r, v, kind in XENT_CASES:
            x, lab, dl = _xent_inputs(r, v, kind, dtype, g, dev)
            loss, lse = K.softmax_xent_fwd(x, lab)
            rloss, rlse = K.softmax_xent_fwd_plain(x, lab)
            dx = K.softmax_xent_bwd(x, lab, lse, dl)
            rdx = K.softmax_xent_bwd_plain(x, lab, lse, dl)
            torch.cuda.synchronize()
            label = f"R{r} V{v}" + ("" if kind == "random" else f" {kind}")
            if kind == "edges" and not bool(torch.isneginf(lse[7])):
                raise AssertionError(f"softmax_xent_fwd {label} {dn}: a row "
                                     f"of -inf gave lse {float(lse[7])}")
            _check("softmax_xent_fwd", [(loss, rloss), (lse, rlse)], dn,
                   label, rec_fwd)
            if kind == "edges":
                # the row of -inf has no gradient: exp(-inf - lse) with lse
                # -inf is NaN in the kernel and the plain version alike
                if not (bool(torch.isnan(dx[7]).all())
                        and bool(torch.isnan(rdx[7]).all())):
                    raise AssertionError(f"softmax_xent_bwd {label} {dn}: "
                                         "the row of -inf is not NaN in both")
                keep = torch.arange(r, device=dev) != 7
                dx, rdx = dx[keep], rdx[keep]
            _check("softmax_xent_bwd", [(dx, rdx)], dn, label, rec_bwd)
            if (r, v) not in XENT_TIMED:
                continue
            shape = f"R{r} V{v} {dn}"
            eb = x.element_size()
            # the library asserts on a label outside [0, V): it is timed
            # on the in-range labels
            lab64 = lab.long().clamp(0, v - 1)
            fwd = _kernel_times(
                {}, lambda: K.softmax_xent_fwd(x, lab),
                lambda: K.softmax_xent_fwd_plain(x, lab),
                lambda: F.cross_entropy(x, lab64, reduction="none"),
                r * v * eb + r * 4 + 2 * r * 4, 4 * r * v, dn, shape)
            xx = x.detach().requires_grad_(True)
            lib = F.cross_entropy(xx, lab64, reduction="none")
            bwd = _kernel_times(
                {}, lambda: K.softmax_xent_bwd(x, lab, lse, dl),
                lambda: K.softmax_xent_bwd_plain(x, lab, lse, dl),
                lambda: torch.autograd.grad(lib, (xx,), dl,
                                            retain_graph=True),
                2 * r * v * eb + 3 * r * 4, 4 * r * v, dn, shape)
            for rec, t in ((rec_fwd, fwd), (rec_bwd, bwd)):
                rec.setdefault("shapes", {})[shape] = t
                if (r, v, dtype) == (*XENT_TIMED[0], torch.float32):
                    rec.update(t)
            del x, xx, lib, dx, rdx


#: the row-stable product's cases: the exact LM's products (FULL_WIDTH,
#: 4 slots) at decode's M = 4, prefill's M = 2048 and the recompute's
#: M = 4 x 2048, as (M, K, N, label); the timed one is the recompute's
#: first FFN product.  `_mm_cases` adds each decode shape at M = 1 and on
#: both sides of the small-M tile code's limit
MM_CASES = [(4, 768, 2304, "decode QKV"), (4, 768, 3072, "decode FFN1"),
            (4, 3072, 768, "decode FFN2"), (4, 768, 32000, "decode head"),
            (2048, 768, 3072, "prefill FFN1"),
            (8192, 768, 2304, "recompute QKV"),
            (8192, 768, 3072, "recompute FFN1"),
            (8192, 3072, 768, "recompute FFN2"), (5, 12, 8, "ragged")]
MM_TIMED = "recompute FFN1"
#: the decode step's products, each timed with its weights read cold:
#: the launches rotate over copies of w that together pass MM_COLD_BYTES,
#: three times the 50 MB L2, as the decode step's 37 products do
MM_TIMED_DECODE = ("decode QKV", "decode FFN1", "decode FFN2", "decode head")
MM_COLD_BYTES = 150e6
#: the small-M code at each strip width and the 128 x 128 code, timed
#: against each other (device ms, cold weights) at the decode shapes, the
#: layers' ones also at M 16 and 64, to place kernels.ROW_STABLE_SMALL_M
#: and the strip rule of kernels.row_stable_mm_geometry
MM_SWEEP = (((768, 2304), "QKV", (4, 16, 64)), ((768, 3072), "FFN1",
                                                (4, 16, 64)),
            ((3072, 768), "FFN2", (4, 16, 64)), ((768, 32000), "head", (4,)))
MM_SWEEP_STRIPS = (8, 16, 32, 0)
#: one dependent f32 add: the FADD latency in cycles on Hopper
FADD_CYCLES = 4


def _mm_cases(small_m):
    """MM_CASES plus M = 1, small_m and small_m + 1 at each decode
    shape."""
    extra = [(m, k, n, f"{label} edge")
             for _, k, n, label in MM_CASES if label.startswith("decode")
             for m in (1, small_m, small_m + 1)]
    return MM_CASES + extra


def _sm_clock_ghz():
    """The card's maximum SM clock (nvidia-smi), in GHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0]) / 1e3


def _cold_weights(w, copies_bytes=MM_COLD_BYTES):
    """An endless rotation over copies of ``w`` that together pass
    ``copies_bytes`` (at least two), so that no launch finds its weights
    in L2."""
    import itertools
    n = max(2, math.ceil(copies_bytes / (w.numel() * w.element_size())))
    return itertools.cycle([w.clone() for _ in range(n)]), n


def _tile_code_sweep(g, dev):
    """Device ms of each MM_SWEEP_STRIPS code (0: the 128 x 128 code) at
    each MM_SWEEP shape and M, cold weights, forcing the wrapper's
    geometry; beside it the strip the wrapper picks."""
    import torch
    from paddle_tpu_torch.ops import kernels as K
    keep = K.row_stable_mm_geometry
    sms = K._sm_count(0)
    sweep = {}
    try:
        for (k, n), label, ms in MM_SWEEP:
            w = (torch.randn(k, n, generator=g) / math.sqrt(k)).to(dev)
            ws, _ = _cold_weights(w)
            for m in ms:
                x = torch.randn(m, k, generator=g).to(dev)
                row = {"picked": keep(m, n, sms)}
                for strip in MM_SWEEP_STRIPS:
                    K.row_stable_mm_geometry = (
                        lambda m_, n_, sms_, strip=strip: strip)
                    row[f"strip {strip}" if strip else "128 x 128"] = \
                        _device_ms(lambda: K.row_stable_mm(x, next(ws)))[0]
                sweep[f"{label} M{m}"] = row
                print(f"    {label} M{m} K{k} N{n}: device ms " + ", ".join(
                    f"{key} {v:.4f}" if isinstance(v, float) else
                    f"{key} {v}" for key, v in row.items()), flush=True)
    finally:
        K.row_stable_mm_geometry = keep
    return sweep


def check_row_stable_mm(rec):
    """The exact mode's product against its plain version, bit for bit
    (the plain version does the kernel's arithmetic: each multiply and
    add rounded on its own, k in order), at every `_mm_cases` shape, each
    through the tile code `row_stable_mm_geometry` picks; a row must give
    the same bits at M = 1 (the small-M code) and inside M = 8192 (the
    128 x 128 code) at each recompute shape.  Timed at MM_TIMED beside cuBLAS's
    addmm (TF32 off), whose bits for one row at M = 1 and inside M = 8192
    are recorded too: the reason the kernel exists; and at each
    MM_TIMED_DECODE shape with cold weights, beside addmm, the bytes bound
    and the FADD chain's floor (K dependent adds of FADD_CYCLES at the
    card's maximum SM clock).  Then every code at MM_SWEEP."""
    import torch
    from paddle_tpu_torch.ops import kernels as K
    g = torch.Generator(device="cpu").manual_seed(17)
    dev = torch.device("cuda")
    ghz = _sm_clock_ghz()
    paths = K.ROW_STABLE_MM.path_launches
    for m, k, n, label in _mm_cases(K.ROW_STABLE_SMALL_M):
        x = torch.randn(m, k, generator=g).to(dev)
        w = (torch.randn(k, n, generator=g) / math.sqrt(k)).to(dev)
        b = (0.1 * torch.randn(n, generator=g)).to(dev)
        strip = K.row_stable_mm_geometry(m, n, K._sm_count(0))
        path = "small" if strip else "large"
        before = paths[path]
        out = K.row_stable_mm(x, w, b)
        ref = K.row_stable_mm_plain(x, w, b)
        torch.cuda.synchronize()
        if paths[path] != before + 1:
            raise AssertionError(f"row_stable_mm {label}: the {path} code "
                                 "was not counted")
        differ = int((out != ref).sum())
        err = float((out - ref).abs().max())
        print(f"  row_stable_mm {label} M{m} K{k} N{n} ({path} code"
              + (f", strips of {strip}" if strip else "") + "): "
              f"{differ} elements differ from the plain version "
              f"(max_abs_err {err:.3e}; the tolerance is bitwise)",
              flush=True)
        if differ:
            raise AssertionError(f"row_stable_mm {label}: not bitwise its "
                                 "plain version")
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
        rec["limit_share"] = 0.0
        if m == 8192:
            one = K.row_stable_mm(x[4321:4322].contiguous(), w, b)
            lib_all = torch.addmm(b, x, w)
            lib_one = torch.addmm(b, x[4321:4322], w)
            torch.cuda.synchronize()
            if not torch.equal(one[0], out[4321]):
                raise AssertionError(f"row_stable_mm {label}: row 4321 "
                                     "differs between M=1 and M=8192")
            same = bool(torch.equal(lib_one[0], lib_all[4321]))
            rec.setdefault("addmm_row_same_bits", {})[label] = same
            print(f"    row 4321 at M=1 (small code) and inside M=8192 "
                  f"({path} code): kernel same bits; "
                  f"torch.addmm (cuBLAS, TF32 off) "
                  f"{'same bits' if same else 'DIFFERENT bits'} (max "
                  f"{float((lib_one[0] - lib_all[4321]).abs().max()):.3e})",
                  flush=True)
        nbytes = 4 * (m * k + k * n + n + m * n)
        if label == MM_TIMED:
            _kernel_times(rec, lambda: K.row_stable_mm(x, w, b),
                          lambda: K.row_stable_mm_plain(x, w, b),
                          lambda: torch.addmm(b, x, w),
                          nbytes, 2 * m * n * k, "float32",
                          f"M{m} K{k} N{n} f32", plain_iters=2)
        if label in MM_TIMED_DECODE:
            ws, copies = _cold_weights(w)
            t = _kernel_times(
                {}, lambda: K.row_stable_mm(x, next(ws), b),
                lambda: K.row_stable_mm_plain(x, next(ws), b),
                lambda: torch.addmm(b, x, next(ws)),
                nbytes, 2 * m * n * k, "float32",
                f"M{m} K{k} N{n} f32, cold w ({copies} copies)",
                plain_iters=2)
            t["fadd_chain_floor_ms"] = k * FADD_CYCLES / ghz * 1e-6
            print(f"    FADD chain floor {t['fadd_chain_floor_ms']:.5f} ms "
                  f"(K {k} x {FADD_CYCLES} cycles at {ghz:.3f} GHz)",
                  flush=True)
            rec.setdefault("decode", {})[label] = t
    print("  the tile codes and strips (cold weights):", flush=True)
    rec["tile_code_sweep"] = _tile_code_sweep(g, dev)
    rec["small_m"] = K.ROW_STABLE_SMALL_M


def _recurrent_inputs(gates, t, b, h, lens, reverse, g):
    """Seeded inputs of a recurrent kernel on the card: xs, w (f32), h0,
    c0, the [T, B, 1] mask of ``lens`` ("full" or "ragged": seeded lengths
    in [1, T], every seventh row of length 1; reversed in time for
    ``reverse``, as the rule hands an is_reverse layer to the kernel), and
    the cotangents dhs, dcs."""
    import torch
    dev = torch.device("cuda")
    if lens == "full":
        n = torch.full((b,), t)
    else:
        n = torch.randint(1, t + 1, (b,), generator=g)
        n[::7] = 1
        n[1] = t
    mask = (torch.arange(t)[:, None] < n[None, :]).float()[:, :, None]
    if reverse:
        mask = mask.flip(0)
    xs = 0.5 * torch.randn(t, b, gates * h, generator=g)
    w = torch.randn(h, gates * h, generator=g) / math.sqrt(h)
    h0, c0 = (0.5 * torch.randn(b, h, generator=g) for _ in range(2))
    dhs, dcs = (torch.randn(t, b, h, generator=g) for _ in range(2))
    return [x.to(dev).contiguous()
            for x in (xs, w, h0, c0, mask.contiguous(), dhs, dcs)]


def check_recurrent(kind, rec_fwd, rec_bwd, strict=True):
    """Phase 3 for the LSTM (``kind`` "lstm") or GRU ("gru") kernels:
    forward and backward against their plain versions at T80 B32 H512 with
    full and ragged lengths and one is_reverse mask, and at T7 B5 H96;
    the LSTM with f32 w and with the bf16 w of program.amp, the GRU with
    f32 w (and one bf16 w case off the main path).  f32 w: F32_TOL.  bf16
    w: the kernel and the plain version round h_prev to bf16 each step,
    and an f32 reordering can flip one rounding, which the recurrence
    carries on to values near 0: the outputs are held to one bf16
    rounding step of their largest value ("bf16_max"); the share of the
    per-element bf16 rule is printed beside it, not held.  Times at the
    main path's shape and w dtype (the LSTM's bf16 w under program.amp,
    the GRU's f32), and the LSTM's also with f32 w, the dtype of its
    library yardstick, the GRU's also with bf16 w.  At the main shape a
    second backward (and for the GRU a second forward) must repeat bit for
    bit.  Both also at RECURRENT_CHUNKED, where their forward stages the
    batch in chunks (checked through ptt_lstm_fwd_rows / ptt_gru_fwd_rows),
    with both w types.  Then `check_exchange_sizes` and
    `check_recurrent_limits` (``strict`` as there: the A/B modes also run
    older libraries, which may lack the queries)."""
    import torch
    from paddle_tpu_torch.ops import kernels as K
    lstm = kind == "lstm"
    gates = 4 if lstm else 3
    g = torch.Generator(device="cpu").manual_seed(18 if lstm else 19)
    cases = [(80, 32, 512, "full", False), (80, 32, 512, "ragged", False),
             (80, 32, 512, "ragged", True), (7, 5, 96, "ragged", False)]
    if lstm:
        runs = [(c, wd) for wd in (torch.float32, torch.bfloat16)
                for c in cases]
    else:
        runs = [(c, torch.float32) for c in cases] + [
            (cases[0], torch.bfloat16)]
    runs += [(RECURRENT_CHUNKED, wd)
             for wd in (torch.float32, torch.bfloat16)]
    for (t, b, h, lens, rev), wdt in runs:
        xs, w32, h0, c0, mask, dhs, dcs = _recurrent_inputs(
            gates, t, b, h, lens, rev, g)
        w = w32.to(wdt)
        dn = str(wdt).replace("torch.", "")
        label = (f"T{t} B{b} H{h} {lens}" + (" reverse" if rev else "")
                 + f" w {dn}")
        bf = wdt is torch.bfloat16
        if (t, b, h, lens, rev) == RECURRENT_CHUNKED:
            rows = _fwd_rows(kind, b, h, bf, strict)
            print(f"  {kind}_fwd {label}: stages {rows} rows of {b} at once",
                  flush=True)
            rec_fwd.setdefault("chunked_rows", {})[dn] = rows
            if rows is not None and not rows < b:
                raise AssertionError(f"{kind}_fwd {label} stages all {b} "
                                     "rows at once: the chunked path is "
                                     "not checked")
        if lstm:
            fwd_args = (xs, w, h0, c0, mask)
            got = K.lstm_fwd(*fwd_args)
            ref = K.lstm_fwd_plain(*fwd_args)
            bwd_args = fwd_args + tuple(ref) + (dhs, dcs)
            dgot = K.lstm_bwd(*bwd_args)
            dref = K.lstm_bwd_plain(*bwd_args)
        else:
            fwd_args = (xs, w, h0, mask)
            got = (K.gru_fwd(*fwd_args),)
            ref = (K.gru_fwd_plain(*fwd_args),)
            bwd_args = fwd_args + (ref[0], dhs)
            dgot = K.gru_bwd(*bwd_args)
            dref = K.gru_bwd_plain(*bwd_args)
        torch.cuda.synchronize()
        for name, pairs, rec in ((f"{kind}_fwd", list(zip(got, ref)),
                                  rec_fwd),
                                 (f"{kind}_bwd", list(zip(dgot, dref)),
                                  rec_bwd)):
            _check(name, pairs, "float32", label, rec,
                   "bf16_max" if bf else None)
            if bf:
                print(f"    per-element bf16 rule: "
                      f"{max(_err(o, r, 'bf16')[1] for o, r in pairs):.3f} "
                      "of it (not held)", flush=True)
        main_dtype = torch.bfloat16 if lstm else torch.float32
        if (t, lens, rev, wdt) == (80, "full", False, main_dtype):
            _bitwise_repeat(f"{kind}_bwd", dgot,
                            (K.lstm_bwd if lstm else K.gru_bwd)(*bwd_args),
                            label, rec_bwd)
            if not lstm:
                _bitwise_repeat("gru_fwd", got, (K.gru_fwd(*fwd_args),),
                                label, rec_fwd)
            rec_fwd.update(_recurrent_timings(kind, False, fwd_args,
                                              bwd_args))
            rec_bwd.update(_recurrent_timings(kind, True, fwd_args,
                                              bwd_args))
        elif (t, lens, rev) == (80, "full", False):
            # the other w dtype: the LSTM's f32 w is its library's dtype
            key = "f32_w" if lstm else "bf16_w"
            rec_fwd[key] = _recurrent_timings(kind, False, fwd_args,
                                              bwd_args)
            rec_bwd[key] = _recurrent_timings(kind, True, fwd_args,
                                              bwd_args)
        del got, ref, dgot, dref
    check_exchange_sizes(kind, rec_bwd, strict)
    check_recurrent_limits(kind, g, rec_fwd, rec_bwd, strict)


#: a shape whose LSTM and GRU forward stage the batch in chunks on the
#: H100 (an f32 w stages 16 rows of 64 at H1024, a bf16 w 48): T, B, H,
#: lengths, reversed
RECURRENT_CHUNKED = (3, 64, 1024, "ragged", False)


def _fwd_rows(kind, b, h, bf16, strict=True):
    """Rows of the batch the LSTM or GRU (``kind``) forward stages at once
    at B, H on this card (ptt_lstm_fwd_rows / ptt_gru_fwd_rows); None
    from an older library without the query when not ``strict``."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    try:
        fn = getattr(_build.load(kind), f"ptt_{kind}_fwd_rows")
    except AttributeError:
        if strict:
            raise
        return None
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rows = ctypes.c_int(0)
    rc = fn(b, h, int(bf16), ctypes.byref(rows))
    if rc != 0 or not 1 <= rows.value <= b:
        raise AssertionError(f"ptt_{kind}_fwd_rows({b}, {h}): error {rc}, "
                             f"{rows.value} rows")
    return rows.value


def check_exchange_sizes(kind, rec_bwd, strict=True):
    """The exchange buffer that the backward's library sizes
    (ptt_rnn_exchange_floats, the wrappers' allocation) against the layout
    its kernels use (recurrent.cuh): two [blocks] x [blocks] x [B * units
    rounded up to 4] f32 buffers, units the fewest of 1, 2, 4, 8 that need
    no more blocks than the card has SMs (else 8).  Skipped for an older
    library (not ``strict``) that sizes the buffer in Python."""
    import torch
    from paddle_tpu_torch.ops import kernels as K
    sms = K._sm_count(0)
    try:
        query = K.rnn_exchange_floats
        query(kind, 0, 96, 5)
    except (AttributeError, TypeError):
        if strict:
            raise
        print(f"  {kind}_bwd exchange sizes: no library query, skipped",
              flush=True)
        return
    got = {}
    for h in (96, 264, 512, 1024, 2048):
        units = 1
        while units < 8 and -(-h // units) > sms:
            units *= 2
        blocks = -(-h // units)
        for b in (1, 5, 32, 64):
            want = 2 * blocks * blocks * (-(-b * units // 4) * 4)
            n = query(kind, 0, h, b)
            got[f"H{h} B{b}"] = n
            if n != want:
                raise AssertionError(f"{kind}_bwd exchange at H{h} B{b}: "
                                     f"the library sizes {n} f32, the "
                                     f"layout needs {want}")
    print(f"  {kind}_bwd exchange sizes ({sms} SMs): the library's agree "
          f"with the layout at {len(got)} shapes (H512 B32: "
          f"{got['H512 B32']} f32)", flush=True)
    rec_bwd["exchange_floats"] = got


#: the widths at which the recurrent kernels are checked at the edge of
#: what the card can hold: kernel -> (H whose grid the card holds,
#: where the persistent path runs and the stepwise one is forced beside
#: it, at B32 T5 ragged; H it cannot hold, where the stepwise path runs,
#: at B4 T3 ragged and at B32 T80 with full lengths, timed there in both
#: w dtypes)
RECURRENT_LIMITS = {"lstm_fwd": ((1024,), (2048,)),
                    "lstm_bwd": ((1024,), (2048,)),
                    "gru_fwd": ((1024,), (2048,)),
                    "gru_bwd": ((1024,), (2048,))}


def _recurrent_call(kind, args, backward, path=None):
    """The kernel's outputs and the plain version's on ``args`` (the
    forward's or the backward's), each a tuple."""
    import torch
    from paddle_tpu_torch.ops import kernels as K
    name = f"{kind}_{'bwd' if backward else 'fwd'}"
    got = getattr(K, name)(*args, **({"path": path} if path else {}))
    ref = getattr(K, name + "_plain")(*args)
    as_tuple = (lambda x: (x,) if isinstance(x, torch.Tensor) else tuple(x))
    return as_tuple(got), as_tuple(ref)


def _recurrent_args(kind, t, b, h, wdt, lens, g):
    """Seeded (forward args, backward args) of a recurrent kernel at T, B,
    H with ``lens`` ("full" or "ragged") lengths, w in ``wdt``; the
    backward's hs (and cs) are the plain forward's."""
    from paddle_tpu_torch.ops import kernels as K
    lstm = kind == "lstm"
    xs, w, h0, c0, mask, dhs, dcs = _recurrent_inputs(
        4 if lstm else 3, t, b, h, lens, False, g)
    w = w.to(wdt)
    if lstm:
        fwd = (xs, w, h0, c0, mask)
        return fwd, fwd + tuple(K.lstm_fwd_plain(*fwd)) + (dhs, dcs)
    fwd = (xs, w, h0, mask)
    return fwd, fwd + (K.gru_fwd_plain(*fwd), dhs)


def check_recurrent_limits(kind, g, rec_fwd, rec_bwd, strict=True):
    """At RECURRENT_LIMITS' widths, each kernel in f32 and bf16 w: where
    the card holds the persistent grid, the chosen path must be
    "persistent" (the library's query, `kernels.recurrent_paths`, equal
    to `kernels.recurrent_path`'s reckoning), the kernel within tolerance
    of its plain version, and the stepwise path, forced, too; whether the
    two agree bit for bit is recorded (``paths_bitwise``).  Where it does
    not, the chosen path must be "stepwise", held to the plain version at
    B4 T3 and B32 T80 and timed at B32 T80 (``stepwise_h2048``).  With
    ``strict`` False (the A/B modes, which also run older kernels) a
    library without the stepwise path is recorded, not raised."""
    import torch
    from paddle_tpu_torch.ops import kernels as K
    if not hasattr(K, "recurrent_paths"):
        if strict:
            raise AssertionError("the kernels have no stepwise path")
        print(f"  {kind}: no stepwise path in this library, limits "
              "skipped", flush=True)
        rec_fwd["stepwise"] = rec_bwd["stepwise"] = None
        return
    sms = K._sm_count(0)
    for wdt in (torch.float32, torch.bfloat16):
        dn = str(wdt).replace("torch.", "")
        bf = wdt is torch.bfloat16
        rule = "bf16_max" if bf else None
        for which, rec in (("fwd", rec_fwd), ("bwd", rec_bwd)):
            name = f"{kind}_{which}"
            held, streamed = RECURRENT_LIMITS[name]
            for h, b, t in [(h, 32, 5) for h in held] + [
                    (h, b, t) for h in streamed for b, t in ((4, 3),
                                                             (32, 80))]:
                want = "persistent" if h in held else "stepwise"
                chosen = K.recurrent_paths(kind, 0, h, b, bf)[
                    which == "bwd"]
                reckoned = K.recurrent_path(kind, which, h, b, bf, sms=sms)
                if chosen != want or reckoned != chosen:
                    raise AssertionError(
                        f"{name} H{h} B{b} w {dn}: the library chooses "
                        f"{chosen}, the reckoning {reckoned}, want {want}")
                lens = "full" if t == 80 else "ragged"
                fa, ba = _recurrent_args(kind, t, b, h, wdt, lens, g)
                args = ba if which == "bwd" else fa
                label = f"T{t} B{b} H{h} {lens} w {dn} {chosen}"
                before = dict(getattr(K, name.upper()).path_launches)
                got, ref = _recurrent_call(kind, args, which == "bwd")
                torch.cuda.synchronize()
                ran = {p: n - before[p] for p, n in
                       getattr(K, name.upper()).path_launches.items()}
                if ran[chosen] != 1:
                    raise AssertionError(f"{name} {label}: launches by "
                                         f"path {ran}")
                _check(name, list(zip(got, ref)), "float32", label, rec,
                       rule)
                checked = rec.setdefault("checked_h", {}).setdefault(
                    chosen, [])
                if h not in checked:
                    checked.append(h)
                if chosen == "persistent":
                    other, _ = _recurrent_call(kind, args, which == "bwd",
                                               path="stepwise")
                    torch.cuda.synchronize()
                    _check(name, list(zip(other, ref)), "float32",
                           label.replace("persistent", "stepwise (forced)"),
                           rec, rule)
                    same = all(torch.equal(a, c) for a, c in zip(got, other))
                    print(f"  {name} {label}: the persistent and stepwise "
                          f"paths agree bit for bit: {same}", flush=True)
                    rec.setdefault("paths_bitwise", {})[
                        f"H{h} B{b} T{t} w {dn}"] = same
                elif t == 80:
                    times = _recurrent_timings(kind, which == "bwd", fa, ba)
                    times["path"] = chosen
                    rec.setdefault("stepwise_h2048", {})[dn] = times
                del got, ref, fa, ba, args
                torch.cuda.empty_cache()


def _recurrent_timings(kind, backward, fwd_args, bwd_args):
    """Kernel, plain and library times (CUDA events and device time per
    call, the device time split by kernel) and the bound of a recurrent
    kernel.  Bytes: each input read once, each output written once.
    Operations: the products, 2*T*B*H*G*H forward (G = 4 gates for the
    LSTM, 3 for the GRU) and three times that backward (the gates again,
    dw, dh_prev), at the rate of w's dtype on the tensor cores (3xTF32
    for an f32 w, with the CUDA cores' bound beside it, as the flash
    kernels' f32 bound).  Library: torch.nn.LSTM
    (cuDNN) forward or backward at the same T, B, H in f32, which also
    does the input product x . W_ih; none for the GRU (cuDNN's GRU
    computes r * (h . W_c), another function than (r * h) . W_c)."""
    import torch
    from paddle_tpu_torch.ops import kernels as K
    lstm = kind == "lstm"
    args = bwd_args if backward else fwd_args
    xs, w = args[0], args[1]
    t, b, gh = xs.shape
    h = w.shape[0]
    if lstm:
        fn = K.lstm_bwd if backward else K.lstm_fwd
        plain = K.lstm_bwd_plain if backward else K.lstm_fwd_plain
        out_bytes = (xs.numel() + w.numel() + 2 * b * h) * 4 if backward \
            else 2 * t * b * h * 4
    else:
        fn = K.gru_bwd if backward else K.gru_fwd
        plain = K.gru_bwd_plain if backward else K.gru_fwd_plain
        out_bytes = (xs.numel() + w.numel() + b * h) * 4 if backward \
            else t * b * h * 4
    in_bytes = sum(a.numel() * a.element_size() for a in args)
    ops = 2 * t * b * h * gh * (3 if backward else 1)
    dn = str(w.dtype).replace("torch.", "")
    shape = f"T{t} B{b} H{h} w {dn}" + (
        "" if lstm else "; library none: cuDNN's GRU computes r*(h.W_c), "
        "not (r*h).W_c")
    if not lstm:
        rec = {"ms": _time_ms(lambda: fn(*args)),
               "plain_ms": _time_ms(lambda: plain(*args), iters=5, warmup=1),
               "library_ms": None, "library_device_ms": None}
        rec["device_ms"], names = _device_ms(lambda: fn(*args))
        rec["device_split"] = {n[:70]: t for n, t in names.items()}
        f32 = dn == "float32"
        rec["bound_ms"], rec["bound_by"] = _bound(
            in_bytes + out_bytes, ops, "float32_3xtf32" if f32 else dn)
        if f32:
            rec["bound_cuda_core_ms"] = _bound(in_bytes + out_bytes, ops,
                                               "float32")[0]
        rec["shape"] = shape
        print(f"  {shape}: kernel {rec['ms']:.4f} ms (device "
              f"{rec['device_ms']}), plain {rec['plain_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}"
              + (f"; CUDA cores {rec['bound_cuda_core_ms']:.4f}" if f32
                 else "") + ")", flush=True)
        print("    kernel device ms per call by name: " + "; ".join(
            f"{n[:70]} {t:.4f}" for n, t in sorted(names.items(),
                                                     key=lambda x: -x[1])),
              flush=True)
        return rec
    lib = torch.nn.LSTM(h, h).cuda()
    x = torch.randn(t, b, h, device="cuda")
    if backward:
        x.requires_grad_(True)
        out, _ = lib(x)
        params = [x] + list(lib.parameters())
        gy = torch.randn_like(out)

        def library():
            return torch.autograd.grad(out, params, gy, retain_graph=True)
    else:
        def library():
            with torch.no_grad():
                return lib(x)
    return _kernel_times({}, lambda: fn(*args), lambda: plain(*args),
                         library, in_bytes + out_bytes, ops, dn, shape,
                         tensor_cores=True, plain_iters=5)


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------

def _save_model(model_dir, spec, seed):
    import numpy as np
    from paddle_tpu_torch.models.transformer import (GENERATION_SPEC_FILENAME,
                                                     random_params)
    os.makedirs(model_dir, exist_ok=True)
    for f in os.listdir(model_dir):
        os.unlink(os.path.join(model_dir, f))
    for name, arr in random_params(spec, seed).items():
        np.save(os.path.join(model_dir, name + ".npy"), arr)
    with open(os.path.join(model_dir, GENERATION_SPEC_FILENAME), "w") as f:
        json.dump(spec, f)


def serve(seed=0):
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving.decode_engine import DecodeEngine
    spec = dict(FULL_WIDTH)
    model_dir = os.path.join(HERE, "build", "smoke_model")
    t0 = time.perf_counter()
    _save_model(model_dir, spec, seed)
    engine = DecodeEngine.from_model_dir(model_dir, precision="bf16",
                                         slots=16, block_len=16, warmup=True)
    torch.cuda.synchronize()
    pool_bytes = sum(p.numel() * p.element_size()
                     for pair in engine._pools for p in pair)
    print(f"  model saved and loaded, engine warm: "
          f"{time.perf_counter() - t0:.1f} s; KV pools "
          f"{pool_bytes / 2**30:.2f} GiB", flush=True)
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, 1025, 32)
    prompts = [rng.integers(0, spec["vocab"], n).tolist() for n in lens]
    checked = (0, 17)        # streams recomputed through the full model
    max_new = 64
    steps = []               # each decode step's (tokens, pages, index)
    decode = engine.model.decode
    engine.model.decode = lambda *a, **k: (
        steps.append((a[0], a[2], a[3])), decode(*a, **k))[1]
    try:
        K.reset_launches()
        t0 = time.perf_counter()
        handles = [engine.submit(p, max_new, capture_logits=i in checked)
                   for i, p in enumerate(prompts)]
        results = [h.result(timeout=600) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in K.KERNELS}
        stats = engine.stats()
    finally:
        engine.close()
        del engine.model.decode
    n_tok = sum(len(r["tokens"]) for r in results)
    for r in results:
        if len(r["tokens"]) != max_new or r["finish_reason"] != "length":
            raise AssertionError(f"stream ended early: {r['finish_reason']}"
                                 f" after {len(r['tokens'])} tokens")
        if not all(0 <= t < spec["vocab"] for t in r["tokens"]):
            raise AssertionError("token id out of range")
    print(f"  launches on the serving path: {launches}", flush=True)
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "serving path")
    print(f"  32 requests, {n_tok} tokens in {wall:.3f} s: "
          f"{n_tok / wall:.1f} tokens/s; TTFT ms {stats['ttft_ms']}; "
          f"step ms {stats['step_ms']}; prefills {stats['prefills']}, "
          f"decode steps {stats['iterations']}", flush=True)
    # cross-check two streams against the full-prefix recompute
    for i in checked:
        _match_full_recompute(engine.model, prompts[i], results[i],
                              f"stream {i}")
    profile = profile_decode_step(engine, steps)
    return launches, {"tokens_per_s": n_tok / wall,
                      "ttft_ms": stats["ttft_ms"],
                      "step_ms": stats["step_ms"],
                      "decode_step_profile": profile}


def _match_full_recompute(model, prompt, result, label, n_check=8):
    """The engine's logits of one stream (``result``, captured) against
    `greedy_decode_full` on ``model`` for its first ``n_check`` tokens:
    max abs error within E2E_TOL of max(1, max |logit|), and a greedy
    choice that differs only on a near tie of the recompute's logits (its
    top two within that tolerance), after which the streams part."""
    import numpy as np
    from paddle_tpu_torch.serving.decode_engine import greedy_decode_full
    full = greedy_decode_full(model, [prompt], n_check, capture_logits=True)
    compared = 0
    for step in range(n_check):
        a = result["logits"][step]
        b = full["logits"][step][0]
        err = float(np.abs(a - b).max())
        tol = E2E_TOL * max(1.0, float(np.abs(b).max()))
        if err > tol:
            raise AssertionError(f"{label} token {step}: engine logits "
                                 f"differ from the full recompute by {err}")
        compared += 1
        if full["tokens"][0][step] != result["tokens"][step]:
            top2 = np.sort(b)[-2:]
            if top2[1] - top2[0] > tol:
                raise AssertionError(
                    f"{label} token {step}: greedy choice differs from "
                    "the full recompute without a near tie")
            print(f"  {label} diverges at token {step} on a near tie "
                  f"(top-2 gap {top2[1] - top2[0]:.3e})")
            break
    print(f"  {label} (prompt {len(prompt)}): engine logits match the "
          f"full recompute at {compared} tokens", flush=True)


#: groups of the decode-step profile, by kernel name
DECODE_GROUPS = {"paged attention": ("paged_",),
                 "flash forward": ("flash_fwd",),
                 "row-stable products": ("row_stable",),
                 "LayerNorm": ("ln_fwd",),
                 "library products": ("xmma", "gemm", "gemv", "cutlass",
                                      "nvjet", "splitk")}


def profile_decode_step(engine, steps, iters=20):
    """One decode step of the served model (a TransformerLM or the
    generation Programs) under torch.profiler: the step of the run
    nearest its middle at which every slot was active, replayed on the
    engine's pools as the engine runs it (decode, argmax, copy to the
    host).  Prints device ms by kernel and by group, launches
    per step and the host idle share (1 - device time / the step's wall
    time, the median of ``iters`` unprofiled replays)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    full = [i for i, (_, _, index) in enumerate(steps)
            if bool((index > 0).all())] or list(range(len(steps)))
    mid = min(full, key=lambda i: abs(i - len(steps) // 2))
    tokens, pages, index = steps[mid]
    model, pools = engine.model, engine._pools

    def step():
        logits = model.decode(tokens, pools, pages, index,
                              **engine._exact_kw)
        return logits.argmax(dim=-1).cpu()

    with torch.inference_mode():
        for _ in range(3):
            step()
        walls = []
        for _ in range(iters):
            t0 = time.perf_counter()
            step()
            walls.append(time.perf_counter() - t0)
        wall_ms = sorted(walls)[iters // 2] * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    # a profiler range (the predictor's "executor.run") also shows on the
    # device's timeline: it spans kernels, it is none
    ranges = {e.name for e in prof.events()
              if getattr(e, "is_user_annotation", False)}
    kernels = [r for r in prof.key_averages()
               if r.device_type == torch.autograd.DeviceType.CUDA
               and r.device_time_total > 0 and r.key not in ranges]
    device_ms = sum(r.device_time_total for r in kernels) / 1e3
    n_launch = sum(r.count for r in kernels)
    positions = int(index.long().sum()) + len(index)
    print(f"  decode step {mid} of {len(steps)} "
          f"({int((index > 0).sum())} of {len(index)} slots active, "
          f"{positions} positions attended): wall {wall_ms:.3f} ms "
          f"(median of {iters}), device {device_ms:.3f} ms in {n_launch} "
          f"launches, host idle {1 - device_ms / wall_ms:.1%}; by kernel "
          "(ms, launches):", flush=True)
    for r in sorted(kernels, key=lambda r: -r.device_time_total):
        print(f"    {r.device_time_total / 1e3:9.4f}  x{r.count:<4d} "
              f"{r.key[:100]}")
    groups = dict.fromkeys(list(DECODE_GROUPS) + ["other"], 0.0)
    for r in kernels:
        name = next((g for g, keys in DECODE_GROUPS.items()
                     if any(k in r.key.lower() for k in keys)), "other")
        groups[name] += r.device_time_total / 1e3
    print("  by group (ms): " + ", ".join(
        f"{g} {t:.4f}" for g, t in groups.items()), flush=True)
    return {"step": mid, "positions": positions, "wall_ms": wall_ms,
            "device_ms": device_ms, "launches": n_launch,
            "host_idle_share": 1 - device_ms / wall_ms, "groups_ms": groups}


# ---------------------------------------------------------------------------
# phase 12: the serving front door
# ---------------------------------------------------------------------------

#: phase 12's generate traffic: FD_GROUPS groups of FD_PER_GROUP requests
#: whose prompts share an FD_PREFIX-token head, each followed by its own
#: suffix of FD_SUFFIX[0]..FD_SUFFIX[1] tokens, FD_NEW new tokens each,
#: streamed to FD_GEN_THREADS client threads (each sends requests of one
#: group, one after another: its second and later requests find their
#: group's head in the prefix cache, so at least FD_MIN_HITS hit)
FD_GROUPS, FD_PER_GROUP, FD_PREFIX, FD_SUFFIX = 4, 8, 512, (8, 512)
FD_NEW, FD_GEN_THREADS, FD_MIN_HITS = 64, 8, 24
FD_SLOTS, FD_BLOCK_LEN, FD_PREFIX_BLOCKS = 16, 16, 512
#: phase 12's infer traffic: FD_INFER ResNet-50 requests of FD_INFER_BATCH
#: images from FD_INFER_THREADS client threads, batched up to
#: FD_RESNET_MAX_BATCH rows
FD_INFER, FD_INFER_BATCH, FD_INFER_THREADS, FD_RESNET_MAX_BATCH = 64, 4, 16, 32
FD_RESNET = dict(depth=50, class_dim=1000, image_shape=(224, 224, 3))
#: seconds a client waits for any one reply line (a hot request's longest
#: tail replay is ~512 decode steps, a few seconds)
FD_WIRE_TIMEOUT = 120
#: a batch the server ran against the in-process Predictor on the card
#: on the same padded batch (same shapes, so the same library kernels):
#: max abs error over max |reference| within one bf16 step
FD_SAME_BATCH_TOL = 2.0 ** -7


def _save_frontdoor_models(root, seed, device):
    """Phase 12's two artifacts, written by the port: the full-width LM
    (save_generation_model over random_params at ``seed``) and ResNet-50
    inference (save_inference_model of its softmax output, NHWC).  The
    ResNet weights are the startup program's at ``seed``; its BatchNorm
    running statistics are set from one seeded batch of 8 images (a
    training-mode forward), since the startup's mean 0 and variance 1
    saturate the softmax to one class for every input, which would hide
    a reply sent to the wrong request."""
    import shutil
    import numpy as np
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio, layers
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.models import resnet, transformer as T
    lm_dir, rn_dir = os.path.join(root, "lm"), os.path.join(root, "resnet50")
    for d in (lm_dir, rn_dir):
        shutil.rmtree(d, ignore_errors=True)
    spec = T.generation_spec(**FULL_WIDTH)
    scope = Scope()
    for name, arr in T.random_params(spec, seed).items():
        scope.set(name, arr)
    T.save_generation_model(lm_dir, **FULL_WIDTH, scope=scope, init=False)
    del scope
    main, startup, scope = fluid.Program(), fluid.Program(), Scope()
    with fluid.program_guard(main, startup), fluid.unique_name.guard(), \
            scope_guard(scope):
        img = layers.data(name="data", shape=list(FD_RESNET["image_shape"]),
                          dtype="float32")
        predict = resnet.resnet_imagenet(
            img, class_dim=FD_RESNET["class_dim"], depth=FD_RESNET["depth"],
            data_format="NHWC")
        startup.random_seed = seed
        exe = fluid.Executor(fluid.CPUPlace() if device == "cpu"
                             else fluid.CUDAPlace(0))
        exe.run(startup)
        bns = [op for op in main.global_block().ops
               if op.type == "batch_norm"]
        calib = np.random.default_rng(seed + 7).random(
            (8,) + FD_RESNET["image_shape"], dtype=np.float32)
        stats = exe.run(main, feed={"data": calib}, fetch_list=[
            n for op in bns for n in (op.desc.outputs["SavedMean"][0],
                                      op.desc.outputs["SavedVariance"][0])])
        for op, mean, inv in zip(bns, stats[0::2], stats[1::2]):
            eps = op.desc.attrs.get("epsilon", 1e-5)
            scope.set(op.desc.inputs["Mean"][0], torch.tensor(mean))
            scope.set(op.desc.inputs["Variance"][0],
                      torch.tensor(1.0 / inv.astype(np.float64) ** 2 - eps,
                                   dtype=torch.float32))
        pio.save_inference_model(rn_dir, ["data"], [predict], exe,
                                 main_program=main)
    return lm_dir, rn_dir, spec


def _fd_prompts(vocab, seed):
    """FD_GROUPS x FD_PER_GROUP prompts, group by group."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prompts = []
    for _ in range(FD_GROUPS):
        head = rng.integers(0, vocab, FD_PREFIX).tolist()
        for _ in range(FD_PER_GROUP):
            n = int(rng.integers(FD_SUFFIX[0], FD_SUFFIX[1] + 1))
            prompts.append(head + rng.integers(0, vocab, n).tolist())
    return prompts


def _run_threads(fn, n, timeout=900):
    """Run ``fn(t)`` on n threads; re-raise the first failure; fail if
    one has not finished ``timeout`` seconds after its join began."""
    import threading
    errors = []

    def body(t):
        try:
            fn(t)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=body, args=(t,), daemon=True)
               for t in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"a thread did not finish in {timeout} s")
    if errors:
        raise errors[0]


def _pct(samples):
    import numpy as np
    a = np.asarray(samples, np.float64) * 1e3
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99))}


def _fd_generate(ep, prompts):
    """The generate traffic over the wire: every stream's tokens, its
    client-side TTFT and whether it was its thread's first request."""
    from paddle_tpu_torch.serving import ServingClient
    per_thread = FD_PER_GROUP // (FD_GEN_THREADS // FD_GROUPS)
    results = {}

    def client(t):
        g, k = t % FD_GROUPS, t // FD_GROUPS
        with ServingClient(ep, timeout=FD_WIRE_TIMEOUT) as c:
            for j in range(per_thread):
                i = g * FD_PER_GROUP + k * per_thread + j
                t0, ttft, toks, final = time.perf_counter(), None, [], None
                for line in c.generate_stream(prompts[i], model="lm",
                                              max_new_tokens=FD_NEW):
                    if "token" in line:
                        if ttft is None:
                            ttft = time.perf_counter() - t0
                        toks.append(line["token"])
                    else:
                        final = line
                if final is None or final["tokens"] != toks:
                    raise AssertionError(f"request {i}: the final line does "
                                         "not repeat the streamed tokens")
                results[i] = {"tokens": toks, "ttft": ttft, "first": j == 0,
                              "finish_reason": final["finish_reason"]}

    t0 = time.perf_counter()
    _run_threads(client, FD_GEN_THREADS)
    return results, time.perf_counter() - t0


def _fd_infer(ep, images):
    """The infer traffic over the wire: every reply and its latency."""
    from paddle_tpu_torch.serving import ServingClient
    replies, lat = {}, {}
    per_thread = FD_INFER // FD_INFER_THREADS

    def client(t):
        with ServingClient(ep, timeout=FD_WIRE_TIMEOUT) as c:
            for j in range(per_thread):
                i = t * per_thread + j
                t0 = time.perf_counter()
                out = c.infer({"data": images[i]}, model="resnet50")
                lat[i] = time.perf_counter() - t0
                replies[i] = next(iter(out.values()))

    t0 = time.perf_counter()
    _run_threads(client, FD_INFER_THREADS)
    return replies, lat, time.perf_counter() - t0


def _check_streams_against_cold_engine(lm_dir, prompts, results, device):
    """Every wire stream against an in-process DecodeEngine with no prefix
    cache on the same prompts: equal token for token, or parted on a
    near tie (the wire's token within E2E_TOL of the top logit of the
    cold engine's logits, phase 4's rule), after which the streams part."""
    import numpy as np
    from paddle_tpu_torch.serving import DecodeEngine
    with DecodeEngine.from_model_dir(
            lm_dir, precision="bf16", device=device, slots=FD_SLOTS,
            block_len=FD_BLOCK_LEN) as ref:
        handles = [ref.submit(p, FD_NEW, capture_logits=True)
                   for p in prompts]
        cold = [h.result(timeout=900) for h in handles]
    parted = 0
    for i, (r, want) in enumerate(zip(results, cold)):
        if len(r["tokens"]) != FD_NEW or r["finish_reason"] != "length":
            raise AssertionError(f"stream {i} ended early: "
                                 f"{r['finish_reason']}")
        for step, (a, b) in enumerate(zip(r["tokens"], want["tokens"])):
            if a == b:
                continue
            row = want["logits"][step]
            tol = E2E_TOL * max(1.0, float(np.abs(row).max()))
            if float(row.max() - row[a]) > tol:
                raise AssertionError(
                    f"stream {i} token {step}: the wire's token differs "
                    "from the cold engine's without a near tie")
            parted += 1
            break
    return parted


def _check_infer(pred_bf16, batches, images, replies):
    """Each wire reply is its rows of the batch the server ran (bit for
    bit), and each batch the server ran matches the in-process bf16
    Predictor on the card on the same padded batch within
    FD_SAME_BATCH_TOL."""
    import numpy as np
    where = {}
    for b, (feed, out) in enumerate(batches):
        for off in range(0, feed.shape[0], FD_INFER_BATCH):
            where[feed[off, :2, :2].tobytes()] = (b, off)
    for i, img in enumerate(images):
        b, off = where[img[0, :2, :2].tobytes()]
        got = batches[b][1][off:off + FD_INFER_BATCH]
        if not np.array_equal(replies[i], got):
            raise AssertionError(f"request {i}: the reply is not its rows "
                                 "of the batch the server ran")
    worst = 0.0
    for feed, out in batches:
        want = pred_bf16.run({"data": feed})[0]
        err = float(np.abs(out - want).max()) / float(np.abs(want).max())
        worst = max(worst, err)
    if worst > FD_SAME_BATCH_TOL:
        raise AssertionError(f"a served batch differs from the in-process "
                             f"Predictor by {worst:.3e} of its max")
    return worst


def frontdoor(seed=0, device="cuda"):
    """Phase 12: the full-width LM and ResNet-50, saved by the port,
    served by one InferenceServer over one ModelRegistry (bf16): generate
    streamed to the LM, infer to ResNet-50, over TCP."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import (InferenceServer, ModelRegistry,
                                          Predictor, ServingClient,
                                          wait_for_port_file)
    on_card = device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    root = os.path.join(HERE, "build", "frontdoor")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    lm_dir, rn_dir, spec = _save_frontdoor_models(root, seed, device)
    print(f"  LM and ResNet-50 saved: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    reg = ModelRegistry(device=device)
    reg.load("lm", lm_dir, precision="bf16",
             engine_opts={"max_batch_size": 1},
             decode={"slots": FD_SLOTS, "block_len": FD_BLOCK_LEN,
                     "prefix_cache_blocks": FD_PREFIX_BLOCKS,
                     "warmup": True})
    reg.load("resnet50", rn_dir, precision="bf16", transpile=True,
             engine_opts={"max_batch_size": FD_RESNET_MAX_BATCH},
             warmup=[b for b in (1, 2, 4, 8, 16, 32)
                     if b <= FD_RESNET_MAX_BATCH])
    rn_entry, lm_entry = reg.get("resnet50"), reg.get("lm")
    if any(op.type == "batch_norm"
           for op in rn_entry.predictor.program.global_block().ops):
        raise AssertionError("the transpiler left a BatchNorm in ResNet-50")
    port_file = os.path.join(root, "port")
    server = InferenceServer(reg, port=0, port_file=port_file).start()
    ep = f"127.0.0.1:{wait_for_port_file(port_file, timeout=60)}"
    sync()
    print(f"  registry loaded (ResNet-50 transpiled, buckets "
          f"{rn_entry.engine.buckets}; LM decode slots {FD_SLOTS}, "
          f"prefix cache {FD_PREFIX_BLOCKS} blocks), serving on {ep}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prompts = _fd_prompts(spec["vocab"], seed)
    rng = np.random.default_rng(seed + 1)
    images = [rng.random((FD_INFER_BATCH,) + FD_RESNET["image_shape"],
                         dtype=np.float32) for _ in range(FD_INFER)]
    batches = []
    served = rn_entry.predictor.run_with_info

    def recording(feed, return_numpy=True):
        outs, hit = served(feed, return_numpy)
        batches.append((np.array(feed["data"]), outs[0]))
        return outs, hit
    rn_entry.predictor.run_with_info = recording
    try:
        K.reset_launches()
        gen, gen_wall = _fd_generate(ep, prompts)
        replies, lat, infer_wall = _fd_infer(ep, images)
        sync()
        launches = {k.name: k.launches for k in K.KERNELS}
        with ServingClient(ep, timeout=60) as c:
            prom = c.metrics()
            lm_stats = c.stats(model="lm")
            rn_stats = c.stats(model="resnet50")
        hits = next(float(line.split()[-1]) for line in prom.splitlines()
                    if line.startswith('decode_prefix_hits_total{model="lm"}'))
        # one cold and one hot stream of the served engine, in process,
        # against the full-prefix recompute
        fresh = rng.integers(0, spec["vocab"],
                             FD_PREFIX + FD_SUFFIX[1] // 2).tolist()
        for label, p in (("cold stream", fresh), ("hot stream", prompts[0])):
            before = lm_entry.decode.prefix_cache.hits
            r = lm_entry.decode.submit(p, 8, capture_logits=True
                                       ).result(timeout=600)
            if (lm_entry.decode.prefix_cache.hits > before) != \
                    (label == "hot stream"):
                raise AssertionError(f"the {label} was not {label[:3]}")
            _match_full_recompute(lm_entry.decode.model, p, r, label)
        drained = server.drain_and_stop(timeout=120)
    finally:
        rn_entry.predictor.run_with_info = served
        server.stop()
        decode = lm_entry.decode
        reg.close()
    if not drained:
        raise AssertionError("drain_and_stop did not drain in 120 s")
    alloc = decode.allocator
    if (any(alloc.refcount(b) for b in range(alloc.num_blocks))
            or alloc.in_use != decode.prefix_cache.cached_blocks):
        raise AssertionError("the KV allocator is not back to its baseline "
                             "after close")
    print(f"  launches on the front-door path: {launches}", flush=True)
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "front-door path")
    if hits < FD_MIN_HITS:
        raise AssertionError(f"decode_prefix_hits_total {hits} < "
                             f"{FD_MIN_HITS}")
    results = [gen[i] for i in range(len(prompts))]
    parted = _check_streams_against_cold_engine(lm_dir, prompts, results,
                                                device)
    pred = Predictor.from_model_dir(rn_dir, precision="bf16", device=device)
    same_batch_err = _check_infer(pred, batches, images, replies)
    # one request in f32 on the card against the CPU's f32 Predictor
    card32 = Predictor.from_model_dir(rn_dir, device=device).run(
        {"data": images[0]})[0]
    cpu32 = Predictor.from_model_dir(rn_dir, device="cpu").run(
        {"data": images[0]})[0]
    f32_err = float(np.abs(card32 - cpu32).max()) / float(
        np.abs(cpu32).max())
    bf16_err = float(np.abs(replies[0] - cpu32).max()) / float(
        np.abs(cpu32).max())
    if f32_err > CPU_LOSS_RTOL:
        raise AssertionError(f"ResNet-50 f32 on the card differs from the "
                             f"CPU by {f32_err:.3e} of its max")
    n_tok = sum(len(r["tokens"]) for r in results)
    cold_ttft = [r["ttft"] for r in results if r["first"]]
    hot_ttft = [r["ttft"] for r in results if not r["first"]]
    infer_lat = [lat[i] for i in range(FD_INFER)]
    out = {
        "generate_tokens_per_s": n_tok / gen_wall,
        "generate_wall_s": gen_wall,
        "ttft_cold_ms": _pct(cold_ttft), "ttft_hot_ms": _pct(hot_ttft),
        "server_ttft_ms": lm_stats["decode"]["ttft_ms"],
        "server_ttft_hot_ms": lm_stats["decode"]["prefix"]["ttft_hot_ms"],
        "decode_step_ms": lm_stats["decode"]["step_ms"],
        "prefix_hits": hits, "prefix": lm_stats["decode"]["prefix"],
        "prefills": lm_stats["decode"]["prefills"],
        "streams_parted_on_near_tie": parted,
        "infer_requests_per_s": FD_INFER / infer_wall,
        "infer_latency_ms": _pct(infer_lat),
        "infer_batch_fill": rn_stats["batch_fill_ratio"],
        "infer_avg_batch": rn_stats["avg_batch"],
        "infer_dispatches": rn_stats["dispatches"],
        "infer_same_batch_err": same_batch_err,
        "resnet_f32_card_vs_cpu_err": f32_err,
        "resnet_bf16_wire_vs_cpu_f32_err": bf16_err,
        "launches": {k: launches[k] for k in SERVE_KERNELS}}
    print(f"  generate: {len(results)} streams, {n_tok} tokens in "
          f"{gen_wall:.3f} s over the wire: {out['generate_tokens_per_s']:.1f}"
          f" tokens/s; TTFT ms cold {out['ttft_cold_ms']}, hot "
          f"{out['ttft_hot_ms']}; decode step ms {out['decode_step_ms']}; "
          f"prefix hits {hits:.0f}, prefills {out['prefills']}, "
          f"{parted} streams parted on a near tie", flush=True)
    print(f"  infer: {FD_INFER} requests of {FD_INFER_BATCH} images in "
          f"{infer_wall:.3f} s: {out['infer_requests_per_s']:.1f} "
          f"requests/s, latency ms {out['infer_latency_ms']}, batch fill "
          f"{out['infer_batch_fill']} (mean batch {out['infer_avg_batch']}"
          f" rows in {out['infer_dispatches']} dispatches); served batches "
          f"against the in-process Predictor {same_batch_err:.3e}; f32 card "
          f"against CPU {f32_err:.3e}; bf16 wire against CPU f32 "
          f"{bf16_err:.3e} (not a check: bf16 precision)", flush=True)
    return launches, out


# ---------------------------------------------------------------------------
# phase 13: exact and int8 decode, the hot-row cache and live row deltas
# ---------------------------------------------------------------------------

#: exact decode: FULL_WIDTH in f32, DM_SLOTS slots of DM_BLOCK_LEN-token
#: blocks over the whole max_len span, a DM_PREFIX_BLOCKS-block prefix
#: cache; prompts of DM_EXACT_PROMPTS tokens, DM_EXACT_NEW new tokens
#: each, then prompt DM_HOT again (a prefix-cache hit)
DM_SLOTS, DM_BLOCK_LEN, DM_PREFIX_BLOCKS = 4, 16, 256
DM_EXACT_PROMPTS, DM_EXACT_NEW, DM_HOT = (17, 300, 1000, 1900), 8, 2
#: int8 decode: DM_INT8_REQUESTS requests with prompts of DM_INT8_PROMPT
#: tokens and DM_INT8_NEW new tokens each on DM_INT8_SLOTS slots; the
#: streams DM_INT8_CHECKED are recomputed through the int8 full model
DM_INT8_REQUESTS, DM_INT8_NEW, DM_INT8_SLOTS = 8, 64, 8
DM_INT8_PROMPT = (8, 512)
DM_INT8_CHECKED = (0, 5)
#: the kernels each decode mode must launch
DM_KERNELS = {"exact": ("flash_attention_fwd", "layer_norm_fwd",
                        "row_stable_mm"),
              "int8": ("paged_attention", "flash_attention_fwd",
                       "layer_norm_fwd")}
#: the recommender of bench.py:788-810 (table V x D, T ids a row,
#: sequence_pool sum, fc 128 relu, fc 2 softmax) served at batch
#: REC_BATCH with Zipf(REC_ZIPF) ids clipped to V (bench.py:814),
#: REC_REQUESTS requests, a V/4-row hot-row cache; REC_INT8_REQUESTS of
#: them through the int8 predictors; a delta of REC_DELTA_ROWS rows, half
#: of them among the REC_DELTA_ROWS // 2 hottest ids, checked on
#: REC_DELTA_REQUESTS requests.  Each cached predictor first serves
#: REC_WARM_REQUESTS other requests of the same traffic, untimed: the
#: cache promotes every 512 lookups (the JAX default), so the timed
#: requests see its steady state
REC_V, REC_D, REC_T = 100_000, 64, 64
REC_BATCH, REC_ZIPF, REC_REQUESTS, REC_INT8_REQUESTS = 64, 1.1, 200, 50
REC_CACHE_ROWS, REC_DELTA_ROWS, REC_DELTA_REQUESTS = REC_V // 4, 1000, 50
REC_WARM_REQUESTS = 520


def _exact_decode(model_dir, seed, device, sync):
    """Exact decode at FULL_WIDTH: every token's logits bitwise the exact
    full recompute's, a hot stream's bitwise its cold stream's."""
    import numpy as np
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving.decode_engine import (DecodeEngine,
                                                        greedy_decode_full)
    t0 = time.perf_counter()
    engine = DecodeEngine.from_model_dir(
        model_dir, precision="f32", numerics="exact", slots=DM_SLOTS,
        block_len=DM_BLOCK_LEN, prefix_cache_blocks=DM_PREFIX_BLOCKS,
        warmup=True, device=device)
    sync()
    print(f"  exact engine loaded and warm: {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    rng = np.random.default_rng(seed + 13)
    vocab = FULL_WIDTH["vocab"]
    prompts = [rng.integers(0, vocab, n).tolist() for n in DM_EXACT_PROMPTS]
    steps = []               # each decode step's (tokens, pages, index)
    decode = engine.model.decode
    engine.model.decode = lambda *a, **k: (
        steps.append((a[0], a[2], a[3])), decode(*a, **k))[1]
    try:
        sync()
        K.reset_launches()
        t0 = time.perf_counter()
        cold = [h.result(timeout=900) for h in [
            engine.submit(p, DM_EXACT_NEW, capture_logits=True)
            for p in prompts]]
        hot = engine.submit(prompts[DM_HOT], DM_EXACT_NEW,
                            capture_logits=True).result(timeout=900)
        sync()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in K.KERNELS}
        engine_paths = dict(K.ROW_STABLE_MM.path_launches)
        stats = engine.stats()
    finally:
        engine.close()
        del engine.model.decode
    print(f"  exact: {len(prompts)} cold streams and one hot of "
          f"{DM_EXACT_NEW} tokens in {wall:.3f} s; step ms "
          f"{stats['step_ms']}, prefills {stats['prefills']}, prefix "
          f"{stats['prefix']}; launches {launches}", flush=True)
    for name in DM_KERNELS["exact"]:
        if launches[name] <= 0:
            raise AssertionError(f"exact decode never launched {name}")
    # each decode step's products (QKV, FFN1, FFN2 a layer, and the head)
    # run at M = DM_SLOTS: the small-M code; prefills longer than
    # ROW_STABLE_SMALL_M rows the large one
    per_step = 3 * FULL_WIDTH["n_layers"] + 1
    counted = "row_stable_mm" in DM_KERNELS["exact"]
    long_prefill = max(DM_EXACT_PROMPTS) > K.ROW_STABLE_SMALL_M
    if counted and (engine_paths["small"] < per_step * len(steps)
                    or (engine_paths["large"] > 0) != long_prefill):
        raise AssertionError(f"exact decode: row_stable_mm codes "
                             f"{engine_paths} for {len(steps)} decode steps "
                             f"of {per_step} products")
    if stats["prefix"]["hits"] != 1:
        raise AssertionError(f"the repeated prompt missed the prefix cache: "
                             f"{stats['prefix']}")
    if hot["tokens"] != cold[DM_HOT]["tokens"] or not all(
            np.array_equal(a, b) for a, b in zip(hot["logits"],
                                                 cold[DM_HOT]["logits"])):
        raise AssertionError("the hot stream's logits are not bitwise the "
                             "cold stream's")
    K.reset_launches()
    t0 = time.perf_counter()
    full = greedy_decode_full(engine.model, prompts, DM_EXACT_NEW,
                              capture_logits=True, numerics="exact")
    sync()
    full_s = time.perf_counter() - t0
    # the recompute's layer products run at M = 4 x max_len: the 128 x 128
    # code; its head reads one row a stream (M 4): the small-M code
    recompute_paths = dict(K.ROW_STABLE_MM.path_launches)
    n_full = full["dispatches"]
    if counted and recompute_paths != {"small": n_full,
                                       "large": (per_step - 1) * n_full}:
        raise AssertionError(f"exact recompute: row_stable_mm codes "
                             f"{recompute_paths} for {n_full} steps")
    print(f"  exact: row_stable_mm launches by tile code: the engine's "
          f"{len(steps)} decode steps and prefills {engine_paths}, the "
          f"recompute {recompute_paths}", flush=True)
    compared = 0
    for i, r in enumerate(cold):
        if len(r["logits"]) != DM_EXACT_NEW or \
                r["tokens"] != full["tokens"][i]:
            raise AssertionError(f"exact stream {i} tokens differ from the "
                                 "exact full recompute")
        for step, a in enumerate(r["logits"]):
            b = full["logits"][step][i]
            if not np.array_equal(a, b):
                raise AssertionError(
                    f"exact stream {i} (prompt {len(prompts[i])}) token "
                    f"{step}: logits differ from the exact full recompute "
                    f"by up to {float(np.abs(a - b).max()):.3e}")
            compared += 1
    print(f"  exact: {compared} tokens of {len(prompts)} streams (prompts "
          f"{list(DM_EXACT_PROMPTS)}) bitwise the exact full recompute "
          f"(its {DM_EXACT_NEW} steps at [{len(prompts)}, "
          f"{FULL_WIDTH['max_len']}] took {full_s:.2f} s); the hot stream "
          "bitwise the cold one", flush=True)
    profile = profile_decode_step(engine, steps)
    return launches, {"wall_s": wall, "step_ms": stats["step_ms"],
                      "tokens_bitwise": compared,
                      "row_stable_paths": {"engine": engine_paths,
                                           "recompute": recompute_paths},
                      "full_recompute_s": full_s,
                      "prefix_hits": stats["prefix"]["hits"],
                      "decode_step_profile": profile}


def _int8_decode(model_dir, seed, device, sync):
    """int8 decode at FULL_WIDTH: two streams against the int8 full
    recompute by phase 4's rule."""
    import numpy as np
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving.decode_engine import DecodeEngine
    engine = DecodeEngine.from_model_dir(
        model_dir, precision="int8", slots=DM_INT8_SLOTS,
        block_len=DM_BLOCK_LEN, warmup=True, device=device)
    rng = np.random.default_rng(seed + 19)
    prompts = [rng.integers(0, FULL_WIDTH["vocab"], n).tolist()
               for n in rng.integers(DM_INT8_PROMPT[0], DM_INT8_PROMPT[1] + 1,
                                     DM_INT8_REQUESTS)]
    try:
        sync()
        K.reset_launches()
        t0 = time.perf_counter()
        results = [h.result(timeout=900) for h in [
            engine.submit(p, DM_INT8_NEW,
                          capture_logits=i in DM_INT8_CHECKED)
            for i, p in enumerate(prompts)]]
        sync()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in K.KERNELS}
        stats = engine.stats()
    finally:
        engine.close()
    n_tok = sum(len(r["tokens"]) for r in results)
    if any(len(r["tokens"]) != DM_INT8_NEW for r in results):
        raise AssertionError("an int8 stream ended early")
    for name in DM_KERNELS["int8"]:
        if launches[name] <= 0:
            raise AssertionError(f"int8 decode never launched {name}")
    print(f"  int8: {DM_INT8_REQUESTS} requests, {n_tok} tokens in "
          f"{wall:.3f} s: {n_tok / wall:.1f} tokens/s; step ms "
          f"{stats['step_ms']}; KV {stats['kv_dtype']}; launches "
          f"{launches}", flush=True)
    for i in DM_INT8_CHECKED:
        _match_full_recompute(engine.model, prompts[i], results[i],
                              f"int8 stream {i}")
    return launches, {"tokens_per_s": n_tok / wall,
                      "step_ms": stats["step_ms"],
                      "ttft_ms": stats["ttft_ms"]}


def _save_recommender(model_dir, seed, table=None):
    """The recommender, saved by the port: startup weights at ``seed``,
    the embedding table replaced by ``table`` when given.  Returns
    (table name, the table as saved)."""
    import shutil
    import numpy as np
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio, layers
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    shutil.rmtree(model_dir, ignore_errors=True)
    main, startup, scope = fluid.Program(), fluid.Program(), Scope()
    with fluid.program_guard(main, startup), fluid.unique_name.guard(), \
            scope_guard(scope):
        words = layers.data(name="words", shape=[1], dtype="int64",
                            lod_level=1)
        emb = layers.embedding(input=words, size=[REC_V, REC_D],
                               is_sparse=True, is_distributed=True)
        pooled = layers.sequence_pool(emb, pool_type="sum")
        h = layers.fc(input=pooled, size=128, act="relu")
        pred = layers.fc(input=h, size=2, act="softmax")
        startup.random_seed = seed
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        name = next(op.desc.inputs["W"][0] for op in main.global_block().ops
                    if op.type == "lookup_table")
        if table is not None:
            scope.set(name, torch.from_numpy(np.asarray(table)))
        pio.save_inference_model(model_dir, ["words"], [pred], exe,
                                 main_program=main)
        return name, np.asarray(scope.get(name).cpu())


def _hot_rows(root, seed, device, sync):
    """The recommender behind the hot-row cache: replies bitwise the
    uncached predictor's in f32 and in int8, and a registry delta of
    REC_DELTA_ROWS rows bitwise a fresh load of the patched model."""
    import numpy as np
    from paddle_tpu_torch.serving import ModelRegistry, Predictor
    from paddle_tpu_torch.serving.registry import write_row_delta
    model_dir = os.path.join(root, "recommender")
    t0 = time.perf_counter()
    table_name, table = _save_recommender(model_dir, seed)
    rng = np.random.default_rng(seed + 29)

    def requests(n):
        return [{"words": (np.minimum(rng.zipf(REC_ZIPF, (REC_BATCH, REC_T)),
                                      REC_V) - 1).astype(np.int64),
                 "words@SEQ_LEN": np.full((REC_BATCH,), REC_T, np.int32)}
                for _ in range(n)]
    feeds, warm = requests(REC_REQUESTS), requests(REC_WARM_REQUESTS)
    print(f"  recommender saved, {REC_REQUESTS} + {REC_WARM_REQUESTS} "
          f"requests made: {time.perf_counter() - t0:.1f} s", flush=True)

    def serve(pred, n):
        """Replies and requests/s of the first ``n`` timed requests, after
        the warm-up; and the cache's hit rate over the timed ones."""
        caches = list(pred._row_caches.values())
        for f in (warm if caches else warm[:1]):
            pred.run(f)          # set-up, and the cache's promotions
        sync()
        seen = [(c.hits, c.misses) for c in caches]
        t0 = time.perf_counter()
        outs = [pred.run(f)[0] for f in feeds[:n]]
        rps = n / (time.perf_counter() - t0)
        hit_rate = [round((c.hits - h) / max(1, c.hits + c.misses - h - m),
                          4) for c, (h, m) in zip(caches, seen)]
        return outs, rps, hit_rate

    plain = Predictor.from_model_dir(model_dir, device=device)
    cached = Predictor.from_model_dir(model_dir, device=device,
                                      embedding_cache_rows=REC_CACHE_ROWS)
    want, plain_rps, _ = serve(plain, REC_REQUESTS)
    got, cached_rps, (timed_hit_rate,) = serve(cached, REC_REQUESTS)
    (cstats,) = cached.stats()["embedding_cache"].values()
    if not all(a.tobytes() == b.tobytes() for a, b in zip(got, want)):
        raise AssertionError("cached replies are not bitwise the uncached "
                             "predictor's")
    del plain, cached
    want8 = serve(Predictor.from_model_dir(model_dir, device=device,
                                           precision="int8"),
                  REC_INT8_REQUESTS)[0]
    got8 = serve(Predictor.from_model_dir(
        model_dir, device=device, precision="int8",
        embedding_cache_rows=REC_CACHE_ROWS), REC_INT8_REQUESTS)[0]
    if not all(a.tobytes() == b.tobytes() for a, b in zip(got8, want8)):
        raise AssertionError("int8 cached replies are not bitwise the int8 "
                             "uncached predictor's")
    print(f"  hot rows: {REC_REQUESTS} requests of {REC_BATCH}x{REC_T} ids "
          f"bitwise cached and uncached ({REC_INT8_REQUESTS} in int8 too); "
          f"requests/s uncached {plain_rps:.1f}, cached {cached_rps:.1f}; "
          f"hit rate {timed_hit_rate} over the timed requests "
          f"({cstats['hit_rate']} with the warm-up), promotions "
          f"{cstats['promotions']}, cache {cstats['device_bytes']} B on the "
          f"card, table {cstats['host_bytes']} B on the host", flush=True)

    reg = ModelRegistry(device=device)
    try:
        reg.load("rec", model_dir, embedding_cache_rows=REC_CACHE_ROWS,
                 warmup=[])
        live = reg.get("rec").predictor
        for f in warm:
            live.run(f)                     # promote the hot head
        half = REC_DELTA_ROWS // 2
        rows = np.concatenate([np.arange(half), rng.choice(
            np.arange(half, REC_V), REC_DELTA_ROWS - half, replace=False)])
        values = (table[rows] + rng.normal(0, 0.5, (rows.size, REC_D))
                  ).astype(np.float32)
        resident = int((live._row_caches[table_name]._slot_of[rows]
                        >= 0).sum())
        write_row_delta(model_dir, {table_name: (rows, values)}, step=1)
        t0 = time.perf_counter()
        res = reg.apply_deltas("rec")
        apply_s = time.perf_counter() - t0
        if not res["applied"] or res["rows"] != REC_DELTA_ROWS:
            raise AssertionError(f"apply_deltas: {res}")
        patched = table.copy()
        patched[rows] = values
        _save_recommender(os.path.join(root, "recommender_patched"), seed,
                          patched)
        fresh = Predictor.from_model_dir(
            os.path.join(root, "recommender_patched"), device=device)
        moved = 0
        for i, f in enumerate(feeds[:REC_DELTA_REQUESTS]):
            a, b = live.run(f)[0], fresh.run(f)[0]
            if a.tobytes() != b.tobytes():
                raise AssertionError(f"request {i} after apply_deltas is "
                                     "not bitwise a fresh load of the "
                                     "patched model")
            moved += int(a.tobytes() != want[i].tobytes())
        if not moved:
            raise AssertionError("the delta changed no reply")
    finally:
        reg.close()
    print(f"  deltas: apply_deltas of {REC_DELTA_ROWS} rows ({resident} "
          f"resident in the cache) in {apply_s * 1e3:.1f} ms; "
          f"{REC_DELTA_REQUESTS} replies bitwise a fresh load of the "
          f"patched model, {moved} changed",
          flush=True)
    return {"cached_requests_per_s": cached_rps,
            "uncached_requests_per_s": plain_rps,
            "hit_rate_timed": timed_hit_rate,
            "hit_rate": cstats["hit_rate"],
            "promotions": cstats["promotions"],
            "cache_device_bytes": cstats["device_bytes"],
            "table_host_bytes": cstats["host_bytes"],
            "delta_rows": REC_DELTA_ROWS, "delta_resident_rows": resident,
            "delta_apply_ms": apply_s * 1e3, "delta_replies_changed": moved}


def decode_modes(seed=0, device="cuda", bf16=None):
    """Phase 13: exact decode, int8 decode and the recommender behind the
    hot-row cache with a live delta, at full width.  ``bf16`` is phase
    4's result, printed beside int8's.  Returns (launches summed over the
    two decode runs, results)."""
    import torch
    on_card = device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    root = os.path.join(HERE, "build", "decode_modes")
    os.makedirs(root, exist_ok=True)
    model_dir = os.path.join(root, "lm")
    t0 = time.perf_counter()
    _save_model(model_dir, dict(FULL_WIDTH), seed)
    print(f"  full-width LM saved: {time.perf_counter() - t0:.1f} s",
          flush=True)
    ex_launches, exact = _exact_decode(model_dir, seed, device, sync)
    i8_launches, int8 = _int8_decode(model_dir, seed, device, sync)
    if bf16 is not None:
        print(f"  int8 {int8['tokens_per_s']:.1f} tokens/s, step ms "
              f"{int8['step_ms']}; phase 4 bf16 {bf16['tokens_per_s']:.1f} "
              f"tokens/s, step ms {bf16['step_ms']} (other traffic: 32 "
              "requests on 16 slots)", flush=True)
    hot = _hot_rows(root, seed, device, sync)
    launches = {k: ex_launches[k] + i8_launches[k] for k in ex_launches}
    return launches, {"exact": exact, "int8": int8, "hot_rows": hot,
                      "launches_exact": {k: ex_launches[k]
                                         for k in DM_KERNELS["exact"]},
                      "launches_int8": {k: i8_launches[k]
                                        for k in DM_KERNELS["int8"]}}


# ---------------------------------------------------------------------------
# phases 5 and 6: training through the Fluid front end
# ---------------------------------------------------------------------------

def _train_program(seed, amp=False):
    """Build the training config in fresh default programs (``amp``:
    under MixedPrecision(Adam)); returns (main, startup, avg_cost)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer
    fluid.core.program.reset_default_programs()
    _, _, avg_cost = transformer.transformer_lm_train_program(
        **TRAIN_CONFIG, amp=amp)
    startup = fluid.default_startup_program()
    startup.random_seed = seed
    return fluid.default_main_program(), startup, avg_cost


def _copy_feed(batch, seed):
    """One fixed batch of seeded tokens; labels are the tokens shifted by
    one (tests/test_transformer.py's copy task)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, TRAIN_CONFIG["vocab"],
                        (batch, TRAIN_CONFIG["max_len"])).astype(np.int64)
    return {"tokens": seqs, "labels": np.roll(seqs, -1, axis=1)}


def _train_steps(main, startup, avg_cost, feed, steps, per_step,
                 other="other", ranges=None, after=None, keep_state=True):
    """Startup, then ``steps`` steps of ``main`` on the card on one fixed
    feed, with the launch counts zeroed just before the steps and read
    just after (by path too: ``path_launches`` in the numbers), then one
    profiled step (and ``after(exe)``, if given, in the same scope).
    Fails unless each kernel launched ``per_step[name]`` times a step and
    the loss is finite and falls.  Returns (launches, end-to-end numbers,
    state after the steps, or None without ``keep_state``)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import kernels as K
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters()
                   if p.trainable)
    n_persist = sum(int(np.prod(v.shape)) for v in main.list_vars()
                    if v.persistable and not v.desc.is_data)
    scope = fluid.core.scope.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(scope):
        t0 = time.perf_counter()
        exe.run(startup)
        torch.cuda.synchronize()
        print(f"  {n_params / 1e6:.2f} M trainable parameters, "
              f"{n_persist * 4 / 2**30:.2f} GiB of f32 state; startup "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        losses, ms = [], []
        for step in range(steps):
            t = time.perf_counter()
            (loss,) = exe.run(main, feed=feed, fetch_list=[avg_cost])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(loss))
            print(f"  step {step + 1}: loss {losses[-1]:.6f}, "
                  f"{ms[-1]:.2f} ms", flush=True)
        launches = {k.name: k.launches for k in K.KERNELS}
        paths = _path_launches()
        peak = torch.cuda.max_memory_allocated()
        device = _profile_step(exe, main, feed, avg_cost, other, ranges)
        if after is not None:
            after(exe)
        state = ({n: t.cpu().numpy() for n, t in scope._vars.items()}
                 if keep_state else None)
    print(f"  launches in {steps} steps: {launches}", flush=True)
    for name, n in per_step.items():
        if launches[name] != n * steps:
            raise AssertionError(
                f"{name}: {launches[name]} launches in {steps} steps, "
                f"want {n} per step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    # step 1 pays one-time costs (cuBLAS handles, cuDNN plans, allocator
    # growth): it is reported apart from the steady-state percentiles
    p50, p99 = np.percentile(ms[1:], 50), np.percentile(ms[1:], 99)
    e2e = {"step1_ms": ms[0], "step_ms_p50": float(p50),
           "step_ms_p99": float(p99),
           "loss_first": losses[0], "loss_last": losses[-1],
           "peak_mem_gib": peak / 2**30, "profiled_device_ms": device,
           "device_busy_share": (device["all"] / p50 if device is not None
                                 else None),
           "path_launches": paths}
    return launches, e2e, state


def train(seed=0):
    """Phase 5: TRAIN_STEPS Adam steps at batch TRAIN_BATCH on the card."""
    main, startup, avg_cost = _train_program(seed)
    launches, e2e, state = _train_steps(
        main, startup, avg_cost, _copy_feed(TRAIN_BATCH, seed), TRAIN_STEPS,
        TRAIN_LAUNCHES_PER_STEP)
    per_s = 1e3 / e2e["step_ms_p50"]
    e2e.update(examples_per_s=TRAIN_BATCH * per_s,
               tokens_per_s=TRAIN_BATCH * TRAIN_CONFIG["max_len"] * per_s)
    return launches, e2e, state


@contextlib.contextmanager
def _op_ranges(op_types):
    """Run each rule of ``op_types`` inside a profiler range named
    ``op:<type>`` (the kernels it launches count toward that range's
    device time); the rules are restored on exit."""
    import torch
    from paddle_tpu_torch.core.registry import OpRegistry
    saved = {}

    def ranged(fn, op_type):
        def rule(ctx):
            with torch.profiler.record_function("op:" + op_type):
                return fn(ctx)
        return rule
    try:
        for t in op_types:
            saved[t] = OpRegistry.get(t).fn
            OpRegistry.get(t).fn = ranged(saved[t], t)
        yield
    finally:
        for t, fn in saved.items():
            OpRegistry.get(t).fn = fn


def _profile_step(exe, main, feed, avg_cost, other="other", ranges=None):
    """One more step under torch.profiler: device time by kernel name;
    returns the step's device ms in all and by group (None if the
    profiler fails); ``other`` names the group of everything that is not
    a port kernel, a library product or a reduction.  ``ranges`` (group
    name -> op type) takes the device time of every kernel an op's rule
    launches (its forward) into a group of its own, in place of the
    reductions group.  A measurement aid only; its failure is reported,
    not fatal."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ranges = ranges or {}
    try:
        with _op_ranges(ranges.values()), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            exe.run(main, feed=feed, fetch_list=[avg_cost])
            torch.cuda.synchronize()
        rows = prof.key_averages()
        # a profiler range (the executor's "executor.run") also shows on
        # the device's timeline: it spans kernels, it is none
        annotations = {e.name for e in prof.events()
                       if getattr(e, "is_user_annotation", False)}
        kernels = [r for r in rows
                   if r.device_type == torch.autograd.DeviceType.CUDA
                   and not r.key.startswith("op:")
                   and r.key not in annotations]
        total = sum(r.device_time_total for r in kernels)
        print(f"  profiled step (first 15 kernels, then the port's): "
              f"{total / 1e3:.2f} ms of device time in "
              f"{sum(r.count for r in kernels)} kernel launches; by "
              "kernel (ms, launches):", flush=True)
        ours = ("flash_", "ln_", "sm_xent_", "paged_", "bn_", "lstm_",
                "gru_", "rnn_")
        ranked = sorted(kernels, key=lambda r: -r.device_time_total)
        for i, r in enumerate(ranked):
            if i < 15 or any(f in r.key for f in ours):
                print(f"    {r.device_time_total / 1e3:9.3f}  "
                      f"x{r.count:<5d} {r.key[:100]}")
        # the same time in groups: the port's kernels, library products
        # (cuDNN convolutions, cuBLAS/CUTLASS GEMMs), PyTorch reductions
        # (or the ranges' ops), and the rest (elementwise math, casts,
        # copies, fills)
        groups = {"port": ours,
                  "library products": ("xmma", "gemm", "conv", "cudnn",
                                       "cutlass", "implicit", "wgrad",
                                       "dgrad", "fprop", "nvjet")}
        if not ranges:
            groups["reductions"] = ("reduce_kernel",)
        sums = dict.fromkeys(list(groups) + list(ranges) + [other], 0.0)
        for r in kernels:
            name = next((g for g, keys in groups.items()
                         if any(k in r.key.lower() for k in keys)), other)
            sums[name] += r.device_time_total / 1e3
        for group, op_type in ranges.items():
            ms = sum(r.device_time_total for r in rows
                     if r.key == "op:" + op_type
                     and r.device_type == torch.autograd.DeviceType.CPU
                     ) / 1e3
            sums[group] = ms
            sums[other] -= ms
        print("  by group (ms): " + ", ".join(
            f"{g} {t:.2f}" for g, t in sums.items()), flush=True)
        return dict({"all": total / 1e3,
                     "launches": sum(r.count for r in kernels)}, **sums)
    except Exception as e:  # noqa: BLE001  (a measurement aid)
        print(f"  profiler unavailable: {type(e).__name__}: {e}",
              flush=True)
        return None


def _step(place, main, avg_cost, feed, state, params=None):
    """One step of ``main`` on ``place`` from the carried-in ``state``:
    (parameter names, [loss, then each parameter's @GRAD]); ``params``
    names the parameters, else those ``main`` trains."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio
    params = params or [p.name for p in main.all_parameters()
                        if p.trainable]
    exe = fluid.Executor(place)
    scope = fluid.core.scope.Scope()
    pio.scope_from_numpy(scope, main, state, exe.device)
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, scope=scope,
                  fetch_list=[avg_cost.name] + [p + "@GRAD" for p in params])
    print(f"  {type(place).__name__}: loss {float(out[0]):.7f} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return params, out


def card_vs_cpu(state, seed=0):
    """Phase 6: the training program at full width, batch 1: one step from
    the same carried-in state and feed on the card (kernels) and on the
    CPU (plain versions); the loss and every @GRAD must agree."""
    import numpy as np
    import paddle_tpu_torch as fluid
    main, _, avg_cost = _train_program(seed)
    feed = _copy_feed(1, seed + 1)
    params, card = _step(fluid.CUDAPlace(0), main, avg_cost, feed, state)
    _, cpu = _step(fluid.CPUPlace(), main, avg_cost, feed, state)
    loss_err = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
    errs = sorted(((float(np.abs(a - b).max())
                    / max(float(np.abs(b).max()), 1e-30), n)
                   for n, a, b in zip(params, card[1:], cpu[1:])),
                  reverse=True)
    print(f"  loss relative error {loss_err:.3e} (limit {CPU_LOSS_RTOL}); "
          f"largest @GRAD errors over each gradient's max |value| "
          f"(limit {CPU_GRAD_RTOL}): "
          + ", ".join(f"{n} {e:.3e}" for e, n in errs[:5]), flush=True)
    if loss_err > CPU_LOSS_RTOL or errs[0][0] > CPU_GRAD_RTOL:
        raise AssertionError("the card's step disagrees with the CPU's")
    return {"loss_rel_err": loss_err, "grad_rel_err_max": errs[0][0],
            "grads_compared": len(params)}


# ---------------------------------------------------------------------------
# phases 7 and 8: ResNet-50 training through the Fluid front end
# ---------------------------------------------------------------------------

def _resnet_program(seed, amp):
    """Build ResNet-50 in fresh default programs; returns (main, startup,
    avg_cost)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet
    fluid.core.program.reset_default_programs()
    _, _, avg_cost, _ = resnet.resnet_train_program(**RESNET_CONFIG)
    main = fluid.default_main_program()
    main.amp = amp
    startup = fluid.default_startup_program()
    startup.random_seed = seed
    return main, startup, avg_cost


def _image_feed(batch, seed, device):
    """One fixed batch of seeded random images in [0, 1) and labels, as
    tensors on ``device`` (bench.py bench_resnet stages its batches on the
    device too)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    shape = (batch,) + RESNET_CONFIG["image_shape"]
    return {"data": torch.from_numpy(
                rng.random(shape, dtype=np.float32)).to(device),
            "label": torch.from_numpy(rng.integers(
                0, RESNET_CONFIG["class_dim"], (batch, 1))).to(device)}


def train_resnet(seed=0):
    """Phase 7: RESNET_STEPS Momentum steps of ResNet-50 at RESNET_BATCH
    under program.amp on the card."""
    import torch
    main, startup, avg_cost = _resnet_program(seed, amp=True)
    launches, e2e, state = _train_steps(
        main, startup, avg_cost,
        _image_feed(RESNET_BATCH, seed, torch.device("cuda")), RESNET_STEPS,
        RESNET_LAUNCHES_PER_STEP)
    e2e["images_per_s"] = RESNET_BATCH * 1e3 / e2e["step_ms_p50"]
    e2e["conv_outputs_contiguous_nhwc"] = _nhwc_conv_outputs(state, seed)
    # the BatchNorm backward's least time in a step: read x and dy and
    # write dx of every BatchNorm layer once, in bf16 (program.amp)
    elems = sum(RESNET_BATCH * math.prod(op.block.var(
        op.desc.inputs["X"][0]).shape[1:]) for op in main.global_block().ops
        if op.type == "batch_norm")
    e2e["bn_elements_per_step"] = elems
    e2e["bn_bwd_bound_ms_per_step"] = 3 * elems * 2 / MEM_BYTES_PER_S * 1e3
    return launches, e2e, state


def _norm_errs(params, got, want):
    """Each @GRAD's relative error ||got - want|| / ||want||, largest
    first."""
    import numpy as np
    return sorted(((float(np.linalg.norm(a - b))
                    / max(float(np.linalg.norm(b)), 1e-30), n)
                   for n, a, b in zip(params, got, want)), reverse=True)


def _nhwc_conv_outputs(state, seed):
    """How many of the ResNet-50 step's conv outputs are contiguous NHWC
    tensors (one more step at batch 8 from ``state``): cuDNN must return
    channels_last outputs, or every BatchNorm would copy its input.
    Fails unless all are."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio
    main, _, _ = _resnet_program(seed, amp=True)
    names = [op.desc.outputs["Output"][0] for op in main.global_block().ops
             if op.type == "conv2d"]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.core.scope.Scope()
    pio.scope_from_numpy(scope, main, state, exe.device)
    outs = exe.run(main, feed=_image_feed(8, seed, exe.device),
                   fetch_list=names, scope=scope, return_numpy=False)
    n = sum(int(t.is_contiguous()) for t in outs)
    print(f"  conv outputs contiguous NHWC: {n} of {len(names)}", flush=True)
    if n != len(names):
        raise AssertionError("a conv output is not contiguous NHWC")
    return n


def resnet_card_vs_cpu(state, seed=0):
    """Phase 8: ResNet-50 in f32 at batch RESNET_CPU_BATCH: one step from
    phase 7's state and one feed on the card (kernel) and on the CPU
    (plain version).  The loss must agree to CPU_LOSS_RTOL.  The gradients
    of this step are ill-conditioned in f32: BatchNorm over as few as 98
    rows, 53 times over, magnifies a reordered sum's 1e-7 into percents.
    So the CPU takes the step a second time on one thread (another order
    of every sum), and each @GRAD's norm-wise error on the card must stay
    within RESNET_SPREAD_FACTOR x the largest such spread of the CPU
    against itself (and CPU_GRAD_RTOL at least)."""
    import torch
    import paddle_tpu_torch as fluid
    main, _, avg_cost = _resnet_program(seed, amp=False)
    feed = {k: v.numpy() for k, v in _image_feed(
        RESNET_CPU_BATCH, seed + 1, torch.device("cpu")).items()}
    params, card = _step(fluid.CUDAPlace(0), main, avg_cost, feed, state)
    _, cpu = _step(fluid.CPUPlace(), main, avg_cost, feed, state)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, cpu1 = _step(fluid.CPUPlace(), main, avg_cost, feed, state)
    finally:
        torch.set_num_threads(threads)
    loss_err = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
    errs = _norm_errs(params, card[1:], cpu[1:])
    spread = _norm_errs(params, cpu1[1:], cpu[1:])
    limit = max(CPU_GRAD_RTOL, RESNET_SPREAD_FACTOR * spread[0][0])
    print(f"  loss relative error {loss_err:.3e} (limit {CPU_LOSS_RTOL}); "
          f"CPU {threads} threads against 1, largest @GRAD norm-wise "
          "spreads: " + ", ".join(f"{n} {e:.3e}" for e, n in spread[:3])
          + f"; card against CPU (limit {limit:.3e}): "
          + ", ".join(f"{n} {e:.3e}" for e, n in errs[:5]), flush=True)
    if loss_err > CPU_LOSS_RTOL or errs[0][0] > limit:
        raise AssertionError("the card's ResNet-50 step disagrees with the "
                             "CPU's")
    return {"loss_rel_err": loss_err, "grad_norm_rel_err_max": errs[0][0],
            "cpu_spread_max": spread[0][0], "grad_limit": limit,
            "grads_compared": len(params)}


# ---------------------------------------------------------------------------
# phases 14 and 15: VGG-16 and LeNet-5 training through the Fluid front end
# ---------------------------------------------------------------------------

def _image_program(model, seed, amp, dropout=True):
    """Build VGG-16 bn_drop (``model`` "vgg") or LeNet-5 ("lenet") as
    benchmark/fluid/vgg.py and mnist.py do: data layers, the model,
    cross_entropy, mean, Adam, in fresh default programs; without
    ``dropout`` every dropout op's probability is 0.  Returns (main,
    startup, avg_cost)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers, optimizer
    from paddle_tpu_torch.models import lenet, vgg
    fluid.core.program.reset_default_programs()
    cfg = VGG_CONFIG if model == "vgg" else LENET_CONFIG
    img = layers.data(name="img", shape=list(cfg["image_shape"]),
                      dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    if model == "vgg":
        predict = vgg.vgg16_bn_drop(img, class_dim=cfg["class_dim"])
        avg_cost = layers.mean(layers.cross_entropy(input=predict,
                                                    label=label))
    else:
        avg_cost, _, _ = lenet.lenet(img, label, class_num=cfg["class_num"])
    main = fluid.default_main_program()
    if not dropout:
        for op in main.global_block().ops:
            if op.type == "dropout":
                op.desc.attrs["dropout_prob"] = 0.0
    optimizer.Adam(learning_rate=cfg["lr"]).minimize(avg_cost)
    main.amp = amp
    startup = fluid.default_startup_program()
    startup.random_seed = seed
    return main, startup, avg_cost


def _nchw_feed(model, batch, seed, device):
    """One fixed batch of seeded images in [0, 1) and labels on
    ``device`` (the benchmark scripts feed synthetic numpy too)."""
    import numpy as np
    import torch
    cfg = VGG_CONFIG if model == "vgg" else LENET_CONFIG
    classes = cfg.get("class_dim", cfg.get("class_num"))
    rng = np.random.default_rng(seed)
    return {"img": torch.from_numpy(rng.random(
                (batch,) + cfg["image_shape"], dtype=np.float32)).to(device),
            "label": torch.from_numpy(rng.integers(
                0, classes, (batch, 1))).to(device)}


def _forward_flops(main, batch):
    """Operations of one forward at ``batch`` (2 a multiply-add): every
    conv2d and mul of ``main``."""
    flops = 0
    block = main.global_block()
    for op in block.ops:
        if op.type == "conv2d":
            w = block.var(op.desc.inputs["Filter"][0]).shape
            out = block.var(op.desc.outputs["Output"][0]).shape
            flops += 2 * batch * math.prod(out[1:]) * math.prod(w[1:])
        elif op.type == "mul":
            w = block.var(op.desc.inputs["Y"][0]).shape
            flops += 2 * batch * w[0] * w[1]
    return flops


def train_image(model, seed=0):
    """Phase 14 (VGG-16) or the second part of phase 15 (LeNet-5): 20
    Adam steps at the benchmark script's config under program.amp on the
    card, on one fixed batch staged on the card."""
    import torch
    batch, steps = ((VGG_BATCH, VGG_STEPS) if model == "vgg"
                    else (LENET_BATCH, LENET_STEPS))
    main, startup, avg_cost = _image_program(model, seed, amp=True)
    launches, e2e, state = _train_steps(
        main, startup, avg_cost, _nchw_feed(model, batch, seed,
                                            torch.device("cuda")),
        steps, VGG_LAUNCHES_PER_STEP if model == "vgg"
        else LENET_LAUNCHES_PER_STEP,
        ranges={"eager BatchNorm forward and statistics": "batch_norm",
                "dropout": "dropout"} if model == "vgg" else None)
    e2e["images_per_s"] = batch * 1e3 / e2e["step_ms_p50"]
    # a step is a forward and a backward of about twice its operations
    e2e["step_flop"] = 3 * _forward_flops(main, batch)
    e2e["step_bound_ms"] = e2e["step_flop"] / PEAK_OPS["bfloat16"] * 1e3
    e2e["parameters"] = sum(math.prod(p.shape) for p in main.all_parameters()
                            if p.trainable)
    device = e2e["profiled_device_ms"]
    e2e["batch_norm_bwd_launches_per_step"] = (launches["batch_norm_bwd"]
                                               / steps)
    print(f"  {model}: {e2e['parameters']} trainable parameters; "
          f"{e2e['batch_norm_bwd_launches_per_step']:g} BatchNorm backward "
          f"launches a step; step p50 "
          f"{e2e['step_ms_p50']:.3f} ms against a {e2e['step_bound_ms']:.3f}"
          f" ms bound ({e2e['step_flop'] / 1e12:.3f} TFLOP at the bf16 "
          f"peak), {e2e['images_per_s']:.1f} images/s, loss "
          f"{e2e['loss_first']:.5f} -> {e2e['loss_last']:.5f}, device busy "
          f"share {e2e['device_busy_share']}, peak memory "
          f"{e2e['peak_mem_gib']:.2f} GiB; device ms by group: {device}",
          flush=True)
    return launches, e2e, state


def _f64_program(main):
    """A parsed copy of ``main`` with every f32 variable in f64."""
    from paddle_tpu_torch.core.program import Program
    prog = Program.parse_from_string(main.serialize_to_string())
    for v in prog.list_vars():
        if v.dtype == "float32":
            v.desc.dtype = "float64"
    return prog


def _f64_arrays(arrays):
    return {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
            for k, v in arrays.items()}


@contextlib.contextmanager
def _plain_versions_on_card():
    """Every kernel wrapper's plain version in place of its kernel, on the
    card's tensors (the f32 steps' checks only: a measurement aid)."""
    from paddle_tpu_torch.ops import kernels as K
    saved = {k.name: getattr(K, k.name) for k in K.KERNELS}
    for name in saved:
        setattr(K, name, getattr(K, name + "_plain"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(K, name, fn)


@contextlib.contextmanager
def _cudnn_off():
    """The card's convolutions by PyTorch's native kernels, not cuDNN's
    (phase 15's anatomy only)."""
    import torch
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = True


def _leaf_errs(got, want):
    """Each @GRAD's norm-wise distance ||got - want|| / max(1, ||want||):
    a conv bias in front of a BatchNorm has a zero gradient in exact
    arithmetic, so its @GRAD is rounding and is held to its size."""
    return [float(np.linalg.norm(np.asarray(a, np.float64) - b)
                  / max(float(np.linalg.norm(b)), 1.0))
            for a, b in zip(got[1:], want[1:])]


def _f32_step_vs_f64(what, main, loss, feed, image_key, state, seed=0,
                     hold_to_cpu=True):
    """One f32 step of ``main`` from ``state`` on the card, held to its
    plain versions and to the exact step.  Such a step is
    ill-conditioned: a relu mask or a max-pool choice that flips on one
    rounding moves every gradient below it, and the f64 step itself
    moves about that far when the feed moves by one ulp.  So the f32
    steps are held to the exact step, not to each other.  For the feed
    and VGG_F32_DRAWS - 1 moves of it (every value of ``feed[image_key]``
    by one ulp, signs from a seed) the port takes the step in f64 on the
    CPU (the reference, which the CPU tests hold to the JAX package), in
    f32 on the CPU (plain versions), in f32 on the card (kernels) and in
    f32 on the card with every kernel's plain version
    (`_plain_versions_on_card`).  The last two run the same forward but
    for the kernels' rounding, and the backward is linear in the
    forward's values, so no mask flips between them: each @GRAD of the
    kernels' step must lie within VGG_NORM_TOL of the plain step's,
    norm-wise (`_leaf_errs`).  Each @GRAD's norm-wise distance from that
    draw's f64 step is taken; with ``hold_to_cpu`` the card's largest
    over the draws must be at most twice the CPU's largest plus
    VGG_NORM_TOL on every @GRAD, the rule the CPU test holds the port to
    against the JAX package.  The loss must agree with the CPU's to
    CPU_LOSS_RTOL on the feed.  Prints every @GRAD's distances, and how
    far each moved feed's f64 step lies from the feed's.  -> (record,
    parameter names, the feed's f64 step)."""
    import paddle_tpu_torch as fluid
    prog64, state64 = _f64_program(main), _f64_arrays(state)
    rng = np.random.default_rng(seed)
    img = feed[image_key]
    feeds = [feed] + [dict(feed, **{image_key: img + np.spacing(img)
                                    * rng.choice([-1.0, 1.0], img.shape
                                                 ).astype(np.float32)})
                      for _ in range(VGG_F32_DRAWS - 1)]
    params = [p.name for p in main.all_parameters() if p.trainable]
    card, plain, cpu, exact = [], [], [], []
    for f in feeds:
        card.append(_step(fluid.CUDAPlace(0), main, loss, f, state,
                          params)[1])
        with _plain_versions_on_card():
            plain.append(_step(fluid.CUDAPlace(0), main, loss, f, state,
                               params)[1])
        cpu.append(_step(fluid.CPUPlace(), main, loss, f, state, params)[1])
        exact.append(_step(fluid.CPUPlace(), prog64, loss, _f64_arrays(f),
                           state64, params)[1])
    loss_err = abs(float(card[0][0]) - float(cpu[0][0])) / abs(
        float(cpu[0][0]))
    e_plain = np.array([_leaf_errs(c, p) for c, p in zip(card, plain)])
    e_card = np.array([_leaf_errs(c, x) for c, x in zip(card, exact)])
    e_cpu = np.array([_leaf_errs(c, x) for c, x in zip(cpu, exact)])
    moved = np.array([_leaf_errs(x, exact[0]) for x in exact[1:]])
    plain_max = e_plain.max(0)
    card_max, cpu_max = e_card.max(0), e_cpu.max(0)
    limit = 2 * cpu_max + VGG_NORM_TOL
    over = (plain_max > VGG_NORM_TOL) | (hold_to_cpu & (card_max > limit))
    rule = (f" (the card's limit: twice it plus {VGG_NORM_TOL})"
            if hold_to_cpu else "")
    print(f"  loss relative error {loss_err:.3e} (limit {CPU_LOSS_RTOL}); "
          f"each @GRAD over {VGG_F32_DRAWS} draws (the feed, then one-ulp "
          f"moves): the card's from its plain versions' (limit "
          f"{VGG_NORM_TOL}) | the card's from the f64 step | the CPU's "
          f"f32 from the f64 step{rule} | the moved feed's f64 step from "
          "the feed's", flush=True)
    for i, name in enumerate(params):
        print(f"    {name}: " + " ".join(f"{e:.2e}" for e in e_plain[:, i])
              + " | " + " ".join(f"{e:.2e}" for e in e_card[:, i])
              + " | " + " ".join(f"{e:.2e}" for e in e_cpu[:, i])
              + " | " + " ".join(f"{e:.2e}" for e in moved[:, i])
              + ("  OVER" if over[i] else ""))
    worst = int(np.argmax(card_max / limit))
    rec = {"loss_rel_err": loss_err, "draws": VGG_F32_DRAWS,
           "plain_max": float(plain_max.max()),
           "card_max": float(card_max.max()),
           "cpu_max": float(cpu_max.max()),
           "card_median": float(np.median(e_card)),
           "cpu_median": float(np.median(e_cpu)),
           "exact_moved_max": float(moved.max()),
           "worst_leaf": params[worst],
           "worst_leaf_card": float(card_max[worst]),
           "worst_leaf_limit": float(limit[worst]),
           "held_to_cpu": hold_to_cpu, "grads_compared": len(params)}
    print(f"  {json.dumps(rec)}", flush=True)
    if loss_err > CPU_LOSS_RTOL or over.any():
        raise AssertionError(
            f"the card's {what} step: the kernels' @GRADs stray from their "
            "plain versions', or lie farther from the f64 step than the "
            "CPU's f32 step allows")
    return rec, params, exact[0]


def vgg_card_vs_cpu(state, seed=0, anatomy=False):
    """Phase 15: VGG-16 in f32 (amp off, TF32 off) at batch VGG_CPU_BATCH
    with every dropout probability 0 (torch's masks differ between the
    card and the CPU), one step from phase 14's state, held to the f64
    step by `_f32_step_vs_f64`: a relu mask or a max-pool choice that
    flips on one rounding moves every gradient below it by up to 1e-2.
    With ``anatomy`` (``--vgg-f32``) the card also takes the feed's step
    with cuDNN off (PyTorch's native convolutions), which separates the
    library's convolutions from the rest; each @GRAD's distance from the
    f64 step is printed."""
    import torch
    import paddle_tpu_torch as fluid
    main, _, avg_cost = _image_program("vgg", seed, amp=False,
                                       dropout=False)
    feed = {k: v.numpy() for k, v in _nchw_feed(
        "vgg", VGG_CPU_BATCH, seed + 1, torch.device("cpu")).items()}
    rec, params, exact = _f32_step_vs_f64("VGG-16", main, avg_cost, feed,
                                          "img", state, seed)
    if anatomy:
        with _cudnn_off():
            out = _step(fluid.CUDAPlace(0), main, avg_cost, feed, state,
                        params)[1]
        errs = _leaf_errs(out, exact)
        print("  card cudnn_off on the feed, from the f64 step: " + ", ".join(
            f"{n} {e:.2e}" for n, e in zip(params, errs)), flush=True)
        rec["cudnn_off_max"] = float(max(errs))
    return rec


# ---------------------------------------------------------------------------
# phase 16: every op rule on the card against the CPU
# ---------------------------------------------------------------------------

def _op_case(op, inputs, attrs=None, outs=("Out",), loss=None, nodiff=(),
             seq_len=None, sums=False):
    """One phase-16 case: ``inputs`` slot -> (kind, shape, *args), an
    array, or a list of those; ``sums`` marks a rule whose outputs sum
    (reductions, products, convolutions, norms, losses)."""
    return dict(op=op, inputs=inputs, attrs=attrs or {}, outs=outs,
                loss=loss, nodiff=nodiff, seq_len=seq_len or {}, sums=sums)


def _u(shape, lo=-2.0, hi=2.0):
    return ("u", shape, lo, hi)


def _away(shape, *kinks):
    """Uniform in [-2, 2) kept 0.2 away from each kink (0 by default)."""
    return ("away", shape, kinks or (0.0,))


#: the op rules phase 16 holds on the card against the CPU: each rule of
#: tests/test_op_grad.py's SPECS that the port registers (its shapes and
#: attributes, values drawn from a seed; the kernel rules at shapes their
#: kernels take), with the input @GRADs of a weighted-sum loss
OP_CASES = (
    [_op_case(a, {"X": _u((2, 3))}) for a in (
        "sigmoid", "logsigmoid", "exp", "tanh", "tanh_shrink", "cos", "sin",
        "square", "softplus", "softsign", "gelu", "silu")]
    + [_op_case(a, {"X": _u((2, 3), 0.3, 2.0)})
       for a in ("sqrt", "rsqrt", "reciprocal", "log")]
    + [_op_case("relu", {"X": _away((2, 3))}),
       _op_case("abs", {"X": _away((2, 3))}),
       _op_case("ceil", {"X": _away((2, 3), -1.0, 0.0, 1.0)}),
       _op_case("floor", {"X": _away((2, 3), -1.0, 0.0, 1.0)}),
       _op_case("round", {"X": _away((2, 3), -1.5, -0.5, 0.5, 1.5)}),
       _op_case("softshrink", {"X": _away((2, 3), -0.5, 0.5)},
                {"lambda": 0.5}),
       _op_case("hard_shrink", {"X": _away((2, 3), -0.5, 0.5)},
                {"threshold": 0.5}),
       _op_case("brelu", {"X": _away((2, 3), -1.0, 1.0)},
                {"t_min": -1.0, "t_max": 1.0}),
       _op_case("leaky_relu", {"X": _away((2, 3))}, {"alpha": 0.1}),
       _op_case("soft_relu", {"X": _u((2, 3), -1.5, 1.5)},
                {"threshold": 4.0}),
       _op_case("elu", {"X": _away((2, 3))}, {"alpha": 0.8}),
       _op_case("relu6", {"X": _away((2, 3))}, {"threshold": 6.0}),
       _op_case("pow", {"X": _u((2, 3), 0.3, 2.0)}, {"factor": 2.5}),
       _op_case("stanh", {"X": _u((2, 3))}, {"scale_a": 0.67,
                                               "scale_b": 1.72}),
       _op_case("hard_sigmoid", {"X": _away((2, 3), -2.5, 2.5)},
                {"slope": 0.2, "offset": 0.5}),
       _op_case("swish", {"X": _u((2, 3))}, {"beta": 1.5}),
       _op_case("thresholded_relu", {"X": _away((2, 3), 1.0)},
                {"threshold": 1.0}),
       _op_case("sign", {"X": _away((2, 3))}),
       _op_case("clip", {"X": _away((2, 3), -1.0, 1.0)},
                {"min": -1.0, "max": 1.0}),
       _op_case("cumsum", {"X": _u((2, 3))}, {"axis": 1}, sums=True),
       _op_case("log_softmax", {"X": _u((2, 3))}, {"axis": -1}, sums=True)]
    + [_op_case(a, {"X": _u((2, 3)), "Y": _u((2, 3))}) for a in (
        "elementwise_add", "elementwise_sub", "elementwise_mul")]
    + [_op_case("elementwise_div", {"X": _u((2, 3)),
                                    "Y": _u((2, 3), 0.4, 2.0)}),
       _op_case("elementwise_max", {"X": _u((2, 3)), "Y": _u((2, 3))}),
       _op_case("elementwise_min", {"X": _u((2, 3)), "Y": _u((2, 3))}),
       _op_case("elementwise_pow", {"X": _u((2, 3), 0.4, 1.8),
                                    "Y": _u((2, 3), 0.5, 2.0)}),
       _op_case("elementwise_mod", {"X": _u((2, 3), 0.3, 0.9),
                                    "Y": _u((2, 3), 1.0, 1.0)},
                nodiff=("Y",)),
       _op_case("elementwise_add", {"X": _u((2, 3)), "Y": _u((3,))},
                {"axis": 1}),
       _op_case("sharding_constraint", {"X": _u((2, 3))},
                {"logical_axes": ["batch", "embed"]}),
       _op_case("reduce_sum", {"X": _u((2, 3))}, {"dim": [1]}, sums=True),
       _op_case("reduce_mean", {"X": _u((2, 3))}, {"reduce_all": True},
                sums=True),
       _op_case("reduce_max", {"X": _u((2, 3))}, {"dim": [1]}, sums=True),
       _op_case("reduce_min", {"X": _u((2, 3))}, {"dim": [1]}, sums=True),
       _op_case("reduce_prod", {"X": _u((2, 3), 0.5, 1.5)},
                {"reduce_all": True}, sums=True),
       _op_case("mean", {"X": _u((2, 3))}, sums=True),
       _op_case("sum", {"X": [_u((2, 3)), _u((2, 3)), _u((2, 3))]}),
       _op_case("scale", {"X": _u((2, 3))}, {"scale": 2.5, "bias": 0.5}),
       _op_case("squared_l2_norm", {"X": _u((2, 3))}, sums=True),
       _op_case("l2_normalize", {"X": _u((2, 3), 0.3, 2.0)},
                {"axis": 1, "epsilon": 1e-12}, sums=True),
       _op_case("norm", {"X": _u((2, 3), 0.3, 2.0), "Scale": _u((3,))},
                {"epsilon": 1e-10}, ("Out", "Norm"), ("Out",), sums=True),
       _op_case("clip_by_norm", {"X": _u((2, 3), -0.2, 0.2)},
                {"max_norm": 5.0}, sums=True),
       _op_case("clip_by_norm", {"X": _u((2, 3), -20.0, 20.0)},
                {"max_norm": 1.0}, sums=True),
       _op_case("cos_sim", {"X": _u((2, 4), 0.2, 1.0),
                            "Y": _u((2, 4), 0.2, 1.0)}, {},
                ("Out", "XNorm", "YNorm"), ("Out",), sums=True),
       _op_case("mul", {"X": _u((2, 3)), "Y": _u((3, 4))},
                {"x_num_col_dims": 1, "y_num_col_dims": 1}, sums=True),
       _op_case("matmul", {"X": _u((2, 3)), "Y": _u((3, 4))}, sums=True),
       _op_case("matmul", {"X": _u((3, 2)), "Y": _u((4, 3))},
                {"transpose_X": True, "transpose_Y": True, "alpha": 0.5},
                sums=True),
       _op_case("conv2d", {"Input": _u((2, 3, 6, 6)),
                           "Filter": _u((4, 3, 3, 3), -0.5, 0.5)},
                {"strides": [1, 1], "paddings": [1, 1],
                 "dilations": [1, 1], "groups": 1}, ("Output",), sums=True),
       _op_case("depthwise_conv2d", {"Input": _u((2, 3, 6, 6)),
                                     "Filter": _u((3, 1, 3, 3), -0.5, 0.5)},
                {"strides": [1, 1], "paddings": [1, 1], "groups": 3},
                ("Output",), sums=True),
       _op_case("conv2d_transpose", {"Input": _u((2, 3, 4, 4)),
                                     "Filter": _u((3, 4, 3, 3), -0.5, 0.5)},
                {"strides": [2, 2], "paddings": [1, 1],
                 "dilations": [1, 1]}, ("Output",), sums=True),
       _op_case("conv3d", {"Input": _u((1, 2, 4, 4, 4)),
                           "Filter": _u((3, 2, 3, 3, 3), -0.5, 0.5)},
                {"strides": [1, 1, 1], "paddings": [1, 1, 1],
                 "dilations": [1, 1, 1], "groups": 1}, ("Output",),
                sums=True),
       _op_case("pool2d", {"X": _u((2, 2, 4, 4))},
                {"pooling_type": "avg", "ksize": [2, 2], "strides": [2, 2],
                 "paddings": [0, 0]}, sums=True),
       _op_case("pool2d", {"X": _u((2, 2, 5, 5))},
                {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
                 "paddings": [1, 1], "ceil_mode": True}, sums=True),
       _op_case("pool3d", {"X": _u((1, 2, 4, 4, 4))},
                {"pooling_type": "avg", "ksize": [2, 2, 2],
                 "strides": [2, 2, 2], "paddings": [0, 0, 0]}, sums=True),
       _op_case("batch_norm",
                {"X": _u((3, 2, 3, 3)), "Scale": _u((2,), 0.5, 1.5),
                 "Bias": _u((2,), -0.5, 0.5), "Mean": _u((2,), 0.0, 0.0),
                 "Variance": _u((2,), 1.0, 1.0)},
                {"momentum": 0.9, "epsilon": 1e-5, "is_test": False},
                ("Y", "MeanOut", "VarianceOut", "SavedMean",
                 "SavedVariance"), ("Y",), ("Mean", "Variance"), sums=True),
       _op_case("layer_norm", {"X": _u((3, 37)), "Scale": _u((37,), 0.5, 1.5),
                               "Bias": _u((37,), -0.5, 0.5)},
                {"begin_norm_axis": 1, "epsilon": 1e-5},
                ("Y", "Mean", "Variance"), ("Y",), sums=True),
       _op_case("lrn", {"X": _u((2, 4, 3, 3), 0.2, 1.0)},
                {"n": 3, "k": 1.0, "alpha": 1e-2, "beta": 0.75},
                ("Out", "MidOut"), ("Out",), sums=True),
       _op_case("softmax", {"X": _u((2, 3))}, sums=True),
       _op_case("maxout", {"X": _u((2, 4, 3, 3))}, {"groups": 2}),
       _op_case("prelu", {"X": _away((2, 3)), "Alpha": _u((1,), 0.1, 0.4)},
                {"mode": "all"}),
       _op_case("prelu", {"X": _away((2, 3, 2)),
                          "Alpha": _u((3,), 0.1, 0.4)}, {"mode": "channel"}),
       _op_case("dropout", {"X": _u((2, 3))},
                {"dropout_prob": 0.35, "is_test": True}),
       _op_case("pad", {"X": _u((2, 3))},
                {"paddings": [0, 1, 1, 0], "pad_value": 0.5}),
       _op_case("pad_constant_like", {"X": _u((3, 4)), "Y": _u((2, 3))},
                {"pad_value": 0.0}, nodiff=("X",)),
       _op_case("amp_cast", {"X": _u((3, 4))}),
       _op_case("cross_entropy", {"X": ("probs", (3, 4)),
                                  "Label": ("ids", (3, 1), 4)},
                {"soft_label": False}, ("Y",), sums=True),
       _op_case("cross_entropy", {"X": ("probs", (3, 4)),
                                  "Label": ("probs", (3, 4))},
                {"soft_label": True}, ("Y",), nodiff=("Label",), sums=True),
       _op_case("cross_entropy", {"X": ("probs", (3, 5, 4)),
                                  "Label": ("ids", (3, 5, 1), 4)},
                {"soft_label": False}, ("Y",), seq_len={"Label": [5, 2, 3]},
                sums=True),
       _op_case("softmax_with_cross_entropy",
                {"Logits": _u((3, 4)), "Label": ("ids", (3, 1), 4)},
                {"soft_label": False}, ("Loss", "Softmax"), ("Loss",),
                sums=True),
       _op_case("softmax_with_cross_entropy",
                {"Logits": _u((3, 4)), "Label": ("probs", (3, 4))},
                {"soft_label": True}, ("Loss", "Softmax"), ("Loss",),
                nodiff=("Label",), sums=True),
       _op_case("sigmoid_cross_entropy_with_logits",
                {"X": _u((3, 4)), "Label": _u((3, 4), 0.0, 1.0)},
                nodiff=("Label",)),
       _op_case("smooth_l1_loss",
                {"X": _u((2, 4), -1, 1), "Y": _u((2, 4), -1, 1),
                 "InsideWeight": _u((2, 4), 0.5, 1.5),
                 "OutsideWeight": _u((2, 4), 0.5, 1.5)}, {"sigma": 1.0},
                ("Out", "Diff"), ("Out",), ("InsideWeight", "OutsideWeight"),
                sums=True),
       _op_case("squared_l2_distance", {"X": _u((2, 4)), "Y": _u((2, 4))},
                {}, ("Out", "sub_result"), ("Out",), sums=True),
       _op_case("huber_loss", {"X": _u((3, 1)), "Y": _u((3, 1))},
                {"delta": 0.5}, ("Out", "Residual"), ("Out",)),
       _op_case("rank_loss", {"Label": ("bits", (3, 1)), "Left": _u((3, 1)),
                              "Right": _u((3, 1))}, nodiff=("Label",)),
       _op_case("margin_rank_loss",
                {"Label": ("signs", (3, 1)), "X1": _u((3, 1)),
                 "X2": _u((3, 1))}, {"margin": 0.1}, ("Out", "Activated"),
                ("Out",), ("Label",)),
       _op_case("hinge_loss", {"Logits": _away((3, 1), -1.0, 1.0),
                               "Labels": ("bits", (3, 1))}, {}, ("Loss",),
                nodiff=("Labels",)),
       _op_case("log_loss", {"Predicted": _u((3, 1), 0.2, 0.8),
                             "Labels": ("bits", (3, 1))},
                {"epsilon": 1e-4}, ("Loss",), nodiff=("Labels",)),
       _op_case("lookup_table", {"W": _u((6, 4)), "Ids": ("ids", (3, 1), 6)},
                {"padding_idx": -1}),
       _op_case("concat", {"X": [_u((2, 3)), _u((2, 2))]}, {"axis": 1}),
       _op_case("split", {"X": _u((2, 6))}, {"num": 3, "axis": 1},
                ("Out",) * 1),
       _op_case("reshape", {"X": _u((2, 3))}, {"shape": [3, 2]}),
       _op_case("squeeze", {"X": _u((2, 1, 3))}, {"axes": [1]}),
       _op_case("unsqueeze", {"X": _u((2, 3))}, {"axes": [1]}),
       _op_case("transpose", {"X": _u((2, 3, 4))}, {"axis": [2, 0, 1]}),
       _op_case("expand", {"X": _u((1, 3))}, {"expand_times": [2, 1]}),
       _op_case("stack", {"X": [_u((2, 3)), _u((2, 3))]}, {"axis": 0},
                ("Y",)),
       _op_case("slice", {"Input": _u((3, 4))},
                {"axes": [0, 1], "starts": [1, 0], "ends": [3, 3]}),
       _op_case("gather", {"X": _u((4, 3)),
                           "Index": np.array([0, 2, 2, -1], np.int32)}),
       _op_case("scatter", {"X": _u((4, 3)),
                            "Ids": np.array([1, 3], np.int32),
                            "Updates": _u((2, 3))}),
       _op_case("reverse", {"X": _u((2, 3))}, {"axis": [1]}),
       _op_case("cast", {"X": _u((2, 3))},
                {"in_dtype": "float32", "out_dtype": "float32"}),
       _op_case("assign", {"X": _u((2, 3))}),
       _op_case("increment", {"X": _u((1,))}, {"step": 2.0}),
       _op_case("fill_zeros_like", {"X": _u((2, 3))}),
       _op_case("where_select", {"Cond": ("bools", (2, 3)), "X": _u((2, 3)),
                                 "Y": _u((2, 3))}),
       _op_case("top_k", {"X": _u((2, 5))}, {"k": 2}, ("Out", "Indices"),
                ("Out",)),
       _op_case("sequence_pool", {"X": _u((2, 4, 3))}, {"pooltype": "SUM"},
                seq_len={"X": [4, 2]}, sums=True),
       _op_case("sequence_pool", {"X": _u((2, 4, 3))},
                {"pooltype": "AVERAGE"}, seq_len={"X": [4, 2]}, sums=True),
       _op_case("sequence_pool", {"X": _u((2, 4, 3))}, {"pooltype": "MAX"},
                seq_len={"X": [4, 2]}, sums=True),
       _op_case("lstm", {"Input": _u((2, 3, 384), -0.5, 0.5),
                         "Weight": _u((96, 384), -0.1, 0.1),
                         "Bias": _u((1, 384), -0.2, 0.2)},
                {"use_peepholes": False, "is_reverse": False,
                 "gate_activation": "sigmoid", "cell_activation": "tanh",
                 "candidate_activation": "tanh"}, ("Hidden", "Cell"),
                ("Hidden",), seq_len={"Input": [3, 2]}, sums=True),
       _op_case("gru", {"Input": _u((2, 3, 288), -0.5, 0.5),
                        "Weight": _u((96, 288), -0.1, 0.1),
                        "Bias": _u((1, 288), -0.2, 0.2)},
                {"is_reverse": False, "gate_activation": "sigmoid",
                 "activation": "tanh"}, ("Hidden",),
                seq_len={"Input": [3, 2]}, sums=True),
       _op_case("fused_attention", {"Q": _u((1, 2, 4, 32), -0.5, 0.5),
                                    "K": _u((1, 2, 4, 32), -0.5, 0.5),
                                    "V": _u((1, 2, 4, 32), -0.5, 0.5)},
                {"causal": False}, sums=True)]
    # the rules without a gradient: outputs only
    + [_op_case(a, {"X": _u((3, 4)), "Y": ("near", (3, 4))}, sums=None)
       for a in ("equal", "not_equal", "less_than", "less_equal",
                 "greater_than", "greater_equal")]
    + [_op_case(a, {"X": ("bools", (3, 4)), "Y": ("bools", (3, 4))},
                sums=None)
       for a in ("logical_and", "logical_or", "logical_xor")]
    + [_op_case("logical_not", {"X": ("bools", (3, 4))}, sums=None),
       _op_case("arg_max", {"X": _u((3, 4))}, {"axis": 1}, sums=None),
       _op_case("arg_min", {"X": _u((3, 4))}, {"axis": 0}, sums=None),
       _op_case("one_hot", {"X": np.array([[0], [3], [1], [5], [-1]],
                                         np.int64)}, {"depth": 4},
                sums=None),
       _op_case("shape", {"Input": _u((2, 3, 5))}, sums=None),
       _op_case("is_empty", {"X": _u((3, 4))}, sums=None),
       _op_case("fill_constant_batch_size_like", {"Input": _u((5, 3))},
                {"shape": [-1, 7], "dtype": "float32", "value": 2.5},
                sums=None),
       _op_case("fill_constant", {}, {"shape": [2, 3], "dtype": "int64",
                                      "value": 7.0}, sums=None),
       _op_case("assign_value", {}, {"shape": [2, 2], "dtype": "float32",
                                     "values": [1.0, -2.0, 3.5, 0.25]},
                sums=None),
       _op_case("accuracy", {"Out": _u((4, 2)),
                             "Indices": np.array([[1, 0], [2, 1], [0, 3],
                                                  [3, 2]], np.int64),
                             "Label": np.array([[1], [1], [2], [2]],
                                               np.int64)}, {},
                ("Accuracy", "Correct", "Total"), sums=None),
       _op_case("auc", {"Predict": ("probs", (16, 2)),
                        "Label": ("ids", (16, 1), 2),
                        "TP": np.arange(9, dtype=np.int64),
                        "FP": np.ones(9, np.int64),
                        "TN": np.full(9, 2, np.int64),
                        "FN": np.zeros(9, np.int64)},
                {"curve": "ROC", "num_thresholds": 9},
                ("AUC", "TPOut", "FPOut", "TNOut", "FNOut"), sums=None),
       _op_case("precision_recall",
                {"MaxProbs": _u((6, 1), 0, 1),
                 "Indices": np.array([[0], [1], [2], [1], [0], [2]],
                                     np.int32),
                 "Labels": np.array([[0], [2], [2], [1], [1], [2]],
                                    np.int32),
                 "StatesInfo": np.arange(12, dtype=np.float32).reshape(3, 4)},
                {}, ("BatchMetrics", "AccumMetrics", "AccumStatesInfo"),
                sums=None)])

#: the random rules: (op, inputs, attributes, mean, variance) of their
#: stated distribution, drawn on the card
_TRUNC_VAR = 0.7737413          # N(0, 1) truncated to [-2, 2]
RANDOM_OP_CASES = (
    ("uniform_random", {}, {"shape": [500, 400], "dtype": "float32",
                            "min": -1.0, "max": 3.0}, 1.0, 16.0 / 12.0),
    ("gaussian_random", {}, {"shape": [500, 400], "dtype": "float32",
                             "mean": 0.5, "std": 2.0}, 0.5, 4.0),
    ("uniform_random_batch_size_like",
     {"Input": np.zeros((50000, 1), np.float32)},
     {"shape": [-1, 4], "dtype": "float32", "min": 0.0, "max": 2.0},
     1.0, 4.0 / 12.0),
    ("gaussian_random_batch_size_like",
     {"Input": np.zeros((50000, 1), np.float32)},
     {"shape": [-1, 4], "dtype": "float32", "mean": -1.0, "std": 0.5},
     -1.0, 0.25),
    ("truncated_gaussian_random", {},
     {"shape": [500, 400], "dtype": "float32", "mean": 1.0, "std": 0.5},
     1.0, 0.25 * _TRUNC_VAR),
)


def _case_array(spec, rng):
    """A phase-16 input from its spec (see `_op_case`) and ``rng``."""
    import numpy as np
    if isinstance(spec, np.ndarray):
        return spec
    kind, shape = spec[0], spec[1]
    if kind == "u":
        return rng.uniform(spec[2], spec[3], shape).astype(np.float32)
    if kind == "away":
        x = rng.uniform(-2.0, 2.0, shape)
        for k in spec[2]:
            near = np.abs(x - k) < 0.2
            x = np.where(near, k + np.sign(x - k + 1e-9) * 0.25, x)
        return x.astype(np.float32)
    if kind == "near":          # X's values, some changed: ties and not
        return None
    if kind == "probs":
        p = rng.uniform(0.1, 1.0, shape)
        return (p / p.sum(-1, keepdims=True)).astype(np.float32)
    if kind == "ids":
        return rng.integers(0, spec[2], shape).astype(np.int64)
    if kind == "bits":
        return rng.integers(0, 2, shape).astype(np.float32)
    if kind == "signs":
        return (2 * rng.integers(0, 2, shape) - 1).astype(np.float32)
    if kind == "bools":
        return rng.random(shape) > 0.5
    raise ValueError(kind)


def _one_op_program(case, feed_arrays, out_shapes=None):
    """The case's one-op program in the port's IR; with ``out_shapes``
    (the float outputs' shapes, from a first run) a weighted-sum loss of
    them and a ``backward`` op for the float inputs are appended.
    Returns (program, feed, output names, @GRAD names)."""
    import numpy as np
    import paddle_tpu_torch as fluid
    prog = fluid.Program()
    block = prog.global_block()
    feed, in_map, diff = {}, {}, []
    for slot, arrs in feed_arrays.items():
        names = []
        for i, arr in enumerate(arrs):
            name = f"{slot.lower()}_{i}"
            diffable = (arr.dtype == np.float32
                        and slot not in case["nodiff"])
            block.create_var(name=name, shape=arr.shape,
                             dtype=str(arr.dtype),
                             stop_gradient=not diffable, is_data=True)
            feed[name] = arr
            names.append(name)
            if diffable:
                diff.append(name)
        in_map[slot] = names
        if slot in case["seq_len"]:
            feed[names[0] + "@SEQ_LEN"] = np.asarray(case["seq_len"][slot],
                                                     np.int32)
    n_out = {"split": 3}.get(case["op"], 1)
    out_map = {slot: [f"o_{slot.lower()}_{i}" for i in range(n_out)]
               for slot in case["outs"]}
    for names in out_map.values():
        for name in names:
            block.create_var(name=name, shape=(1,), dtype="float32")
    block.append_op(case["op"], inputs=in_map, outputs=out_map,
                    attrs=case["attrs"])
    outs = [n for names in out_map.values() for n in names]
    if not out_shapes or not diff:
        return prog, feed, outs, []
    rng = np.random.default_rng(1)
    parts = []
    for j, (name, shape) in enumerate(out_shapes.items()):
        w = f"lw_{j}"
        block.create_var(name=w, shape=shape, dtype="float32",
                         stop_gradient=True, is_data=True)
        feed[w] = (0.5 + rng.random(shape)).astype(np.float32)
        for k, (op, ins, out) in enumerate((
                ("elementwise_mul", {"X": [name], "Y": [w]}, f"lm_{j}"),
                ("reduce_sum", {"X": [f"lm_{j}"]}, f"ls_{j}"))):
            block.create_var(name=out, dtype="float32")
            block.append_op(op, inputs=ins, outputs={"Out": [out]},
                            attrs={"reduce_all": True} if k else {})
        parts.append(f"ls_{j}")
    block.create_var(name="loss", shape=(1,), dtype="float32")
    block.append_op("sum", inputs={"X": parts}, outputs={"Out": ["loss"]})
    forward_end = len(block.ops)
    grads = [d + "@GRAD" for d in diff]
    for g in grads:
        block.create_var(name=g, dtype="float32")
    block.append_op("backward", inputs={"Loss": ["loss"]},
                    outputs={"Grads": grads, "LossGrad": []},
                    attrs={"params": diff, "forward_op_end": forward_end,
                           "op_role": "backward"})
    return prog, feed, outs, grads


def _run_on(place, prog, feed, fetch):
    import paddle_tpu_torch as fluid
    return fluid.Executor(place).run(prog, feed=feed, fetch_list=fetch,
                                     scope=fluid.core.scope.Scope())


def _hold(label, got, want, tol):
    """Fail unless the card's fetch ``got`` equals the CPU's ``want`` (same
    dtype and shape; integer and bool exactly; NaN where the CPU has NaN,
    the CPU's infinities; float within ``tol`` x max(1, max |want|) where
    the CPU's is finite); returns the error's share of the tolerance."""
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{label}: card {got.dtype}{got.shape}, CPU "
                             f"{want.dtype}{want.shape}")
    if want.dtype.kind in "biu":
        if not np.array_equal(got, want):
            raise AssertionError(f"{label}: integer outputs differ")
        return 0.0
    g, w = got.astype(np.float64), want.astype(np.float64)
    if not np.array_equal(np.isnan(g), np.isnan(w)):
        raise AssertionError(f"{label}: NaN at other places")
    inf = np.isinf(w)
    if not np.array_equal(g[inf], w[inf]):
        raise AssertionError(f"{label}: infinities differ")
    ok = np.isfinite(w)
    if not ok.any():
        return 0.0
    share = float(np.abs(g[ok] - w[ok]).max()) / (
        tol * max(1.0, float(np.abs(w[ok]).max())))
    if share > 1.0:
        raise AssertionError(f"{label}: {share:.3f} of the tolerance")
    return share


def op_rules_card_vs_cpu(seed=0):
    """Phase 16: every case of OP_CASES as a one-op program on CUDAPlace
    and on CPUPlace from the same seeded feed: outputs and the input
    @GRADs of a weighted-sum loss to F32_TOL x max(1, max |cpu|) for
    elementwise rules and SUM_TOL for rules that sum, integer and bool
    outputs exactly; each rule of RANDOM_OP_CASES drawn on the card by
    its mean and variance.  The first case is cross_entropy with labels
    outside [0, V) (-1, V, V + 3, -V - 1): the card must give the CPU's
    NaNs and wrapped row without a device assert, and every later case
    runs on the same CUDA context."""
    import zlib
    import numpy as np
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.registry import OpRegistry
    oob = _op_case("cross_entropy", {
        "X": ("probs", (6, 4)),
        "Label": np.array([[0], [-1], [4], [7], [-5], [2]], np.int64)},
        {"soft_label": False}, ("Y",), sums=True)
    shares, rules = {}, set()
    for n, case in enumerate([oob] + OP_CASES):
        op = case["op"]
        rng = np.random.default_rng(seed + zlib.crc32(f"{op}{n}".encode()))
        arrays = {}
        for slot, spec in case["inputs"].items():
            specs = spec if isinstance(spec, list) else [spec]
            arrays[slot] = [_case_array(s, rng) for s in specs]
        if "Y" in arrays and arrays["Y"][0] is None:
            x = arrays["X"][0]
            arrays["Y"] = [np.where(rng.random(x.shape) < 0.3, x,
                                    x + 0.5).astype(np.float32)]
        prog, feed, outs, _ = _one_op_program(case, arrays)
        cpu = _run_on(fluid.CPUPlace(), prog, feed, outs)
        loss_slots = [f"o_{s.lower()}_"
                      for s in (case["loss"] or case["outs"])]
        floats = {o: a.shape for o, a in zip(outs, cpu)
                  if a.dtype.kind == "f"
                  and any(o.startswith(s) for s in loss_slots)}
        grads = []
        if case["sums"] is not None and floats:
            prog, feed, outs, grads = _one_op_program(case, arrays, floats)
        fetch = outs + grads
        want = _run_on(fluid.CPUPlace(), prog, feed, fetch)
        got = _run_on(fluid.CUDAPlace(0), prog, feed, fetch)
        tol = SUM_TOL if case["sums"] else F32_TOL
        share = max(_hold(f"{op} #{n} {name}", g, w, tol)
                    for name, g, w in zip(fetch, got, want))
        shares[f"{op} #{n}"] = share
        rules.add(op)
        if n == 0:
            print(f"  cross_entropy, labels outside [0, V) on the card: "
                  f"{np.asarray(got[0]).ravel().tolist()} (the CPU's)",
                  flush=True)
    for op, inputs, attrs, mean, var in RANDOM_OP_CASES:
        case = _op_case(op, {k: v for k, v in inputs.items()}, attrs)
        prog, feed, outs, _ = _one_op_program(
            case, {k: [v] for k, v in inputs.items()})
        (got,) = _run_on(fluid.CUDAPlace(0), prog, feed, outs)
        (cpu,) = _run_on(fluid.CPUPlace(), prog, feed, outs)
        n = got.size
        ok = (got.shape == cpu.shape and got.dtype == cpu.dtype
              and abs(got.mean() - mean) < 5 * math.sqrt(var / n)
              and abs(got.var() - var) < 5 * math.sqrt(8 * var * var / n))
        print(f"  {op} on the card: mean {got.mean():.5f} (want {mean}), "
              f"variance {got.var():.5f} (want {var:.5f}) over {n} draws "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{op}: the card's draws do not follow "
                                 "the stated distribution")
        rules.add(op)
    probs = np.tile(np.array([[0.1, 0.0, 0.6, 0.3]], np.float32), (20000, 1))
    prog, feed, outs, _ = _one_op_program(
        _op_case("sampling_id", {"X": probs}), {"X": [probs]})
    (ids,) = _run_on(fluid.CUDAPlace(0), prog, feed, outs)
    freq = np.bincount(ids, minlength=4) / ids.size
    se = np.sqrt(probs[0] * (1 - probs[0]) / ids.size)
    print(f"  sampling_id on the card: frequencies {freq.tolist()} "
          f"(probabilities {probs[0].tolist()})", flush=True)
    if ids.dtype != np.int32 or not np.all(np.abs(freq - probs[0])
                                           <= 5 * se + 1e-9):
        raise AssertionError("sampling_id: the card's draws do not follow "
                             "the probabilities")
    rules.add("sampling_id")
    missing = sorted(set(OpRegistry.registered_ops()) - rules
                     - PHASE16_ELSEWHERE - S21_RULES - S22_RULES - S23_RULES
                     - S25_RULES)
    if missing:
        raise AssertionError(f"rules phase 16 did not run: {missing}")
    worst = sorted(shares.items(), key=lambda kv: -kv[1])[:5]
    print(f"  {len(shares)} one-op programs and {len(RANDOM_OP_CASES) + 1} "
          f"random rules over {len(rules)} rules held; largest shares of "
          f"the tolerance: {worst}", flush=True)
    return {"cases": len(shares) + len(RANDOM_OP_CASES) + 1,
            "rules": len(rules), "largest_share": worst[0][1]}


# ---------------------------------------------------------------------------
# phases 9, 10 and 11: the sequence models through the Fluid front end
# ---------------------------------------------------------------------------

def _seq_program(model, seed, amp, config=None):
    """Build the stacked LSTM (``model`` "lstm") or the GRU classifier
    ("gru") + Adam in fresh default programs, at LSTM_CONFIG or
    GRU_CONFIG (or ``config``); returns (main, startup, avg_cost)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers, optimizer
    from paddle_tpu_torch.models.stacked_lstm import lstm_net
    fluid.core.program.reset_default_programs()
    data = layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
    label = layers.data(name="label", shape=[1], dtype="int64")
    if model == "lstm":
        avg_cost, _, _ = lstm_net(data, label, **(config or LSTM_CONFIG))
    else:
        vocab, hid = (config or GRU_CONFIG)["vocab"], (config or
                                                       GRU_CONFIG)["hid"]
        emb = layers.embedding(input=data, size=[vocab, hid])
        proj = layers.fc(input=emb, size=3 * hid, num_flatten_dims=2)
        seq = layers.dynamic_gru(input=proj, size=hid)
        pooled = layers.sequence_pool(input=seq, pool_type="max")
        pred = layers.fc(input=pooled, size=2, act="softmax")
        avg_cost = layers.mean(layers.cross_entropy(input=pred, label=label))
    optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    main = fluid.default_main_program()
    main.amp = amp
    startup = fluid.default_startup_program()
    startup.random_seed = seed
    return main, startup, avg_cost


def _word_feed(batch, seed, ragged=False):
    """One seeded batch of token ids [batch, SEQ_T], their lengths (all
    SEQ_T, or seeded in [1, SEQ_T] with the first row full and the last of
    length 1) and binary labels, as numpy."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = np.full(batch, SEQ_T, np.int32)
    if ragged:
        lens = rng.integers(1, SEQ_T + 1, batch).astype(np.int32)
        lens[0], lens[-1] = SEQ_T, 1
    return {"words": rng.integers(0, 30000, (batch, SEQ_T)),
            "words@SEQ_LEN": lens,
            "label": rng.integers(0, 2, (batch, 1))}


def train_sequence(model, seed=0):
    """Phases 9 and 10: SEQ_STEPS Adam steps of the stacked LSTM or the GRU
    classifier at SEQ_BATCH x SEQ_T under program.amp on the card, the
    batch staged on the card."""
    import torch
    main, startup, avg_cost = _seq_program(model, seed, amp=True)
    feed = {k: torch.from_numpy(v).to("cuda")
            for k, v in _word_feed(SEQ_BATCH, seed).items()}
    launches, e2e, state = _train_steps(
        main, startup, avg_cost, feed, SEQ_STEPS,
        SEQ_LAUNCHES_PER_STEP[model],
        other="the DynamicRNN's eager per-step ops and other elementwise")
    per_s = 1e3 / e2e["step_ms_p50"]
    e2e.update(examples_per_s=SEQ_BATCH * per_s,
               tokens_per_s=SEQ_BATCH * SEQ_T * per_s)
    device = e2e["profiled_device_ms"]
    print(f"  {model}: the port's group "
          f"{device['port'] if device else None} ms of device time a step, "
          f"step p50 {e2e['step_ms_p50']:.3f} ms, device busy share "
          f"{e2e['device_busy_share']}", flush=True)
    return launches, e2e, state


def seq_card_vs_cpu(model, state, seed=0):
    """Phase 11: the model in f32 (amp off, TF32 off) at full width, batch
    SEQ_CPU_BATCH with ragged lengths: one step from the carried-in state
    on the card (kernels) and on the CPU (plain versions), held to the LM's
    rule (CPU_LOSS_RTOL; CPU_GRAD_RTOL on each @GRAD's max abs error over
    its max |value|).  The CPU's own spread between its thread count and 1
    thread is measured and printed beside it."""
    import numpy as np
    import torch
    import paddle_tpu_torch as fluid
    main, _, avg_cost = _seq_program(model, seed, amp=False)
    feed = _word_feed(SEQ_CPU_BATCH, seed + 1, ragged=True)
    params, card = _step(fluid.CUDAPlace(0), main, avg_cost, feed, state)
    _, cpu = _step(fluid.CPUPlace(), main, avg_cost, feed, state)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, cpu1 = _step(fluid.CPUPlace(), main, avg_cost, feed, state)
    finally:
        torch.set_num_threads(threads)

    def errs(got, want):
        return sorted(((float(np.abs(a - b).max())
                        / max(float(np.abs(b).max()), 1e-30), n)
                       for n, a, b in zip(params, got[1:], want[1:])),
                      reverse=True)
    loss_err = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
    card_errs, spread = errs(card, cpu), errs(cpu1, cpu)
    print(f"  loss relative error {loss_err:.3e} (limit {CPU_LOSS_RTOL}); "
          f"largest @GRAD errors over each gradient's max |value| (limit "
          f"{CPU_GRAD_RTOL}): "
          + ", ".join(f"{n} {e:.3e}" for e, n in card_errs[:5])
          + f"; CPU {threads} threads against 1: "
          + ", ".join(f"{n} {e:.3e}" for e, n in spread[:3]), flush=True)
    if loss_err > CPU_LOSS_RTOL or card_errs[0][0] > CPU_GRAD_RTOL:
        raise AssertionError(f"the card's {model} step disagrees with the "
                             "CPU's")
    return {"loss_rel_err": loss_err, "grad_rel_err_max": card_errs[0][0],
            "cpu_spread_max": spread[0][0], "grads_compared": len(params)}


# ---------------------------------------------------------------------------
# phase 17: the at-scale LM under MixedPrecision(Adam) through train_loop
# ---------------------------------------------------------------------------

#: the six kernel wrappers the training step calls (looked up by name in
#: kernels.py at each call, so `_operand_dtypes` can watch them)
TRAIN_KERNEL_WRAPPERS = ("flash_attention_fwd", "flash_attention_bwd",
                         "layer_norm_fwd", "layer_norm_bwd",
                         "softmax_xent_fwd", "softmax_xent_bwd")


@contextlib.contextmanager
def _operand_dtypes(names):
    """Record the dtype of the first operand each wrapper of ``names`` is
    called with; the wrappers are restored on exit."""
    from paddle_tpu_torch.ops import kernels as K
    seen = {n: set() for n in names}
    saved = {n: getattr(K, n) for n in names}

    def watched(name, fn):
        def call(*args, **kw):
            seen[name].add(str(args[0].dtype).replace("torch.", ""))
            return fn(*args, **kw)
        return call
    try:
        for n in names:
            setattr(K, n, watched(n, saved[n]))
        yield seen
    finally:
        for n, fn in saved.items():
            setattr(K, n, fn)


def check_amp_training_shapes(recs):
    """The six training kernels at phase 17's shapes in bf16 (the operand
    dtype the amp LM gives them): each against its plain version, then
    timed beside its library call, into ``recs[name]["amp_training"]``."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kernels as K
    g = torch.Generator(device="cpu").manual_seed(17)
    dev, bf, dn = torch.device("cuda"), torch.bfloat16, "bfloat16"
    B, T = TRAIN_BATCH, TRAIN_CONFIG["max_len"]
    H = TRAIN_CONFIG["n_heads"]
    D = TRAIN_CONFIG["d_model"] // H
    R, Fw, V = B * T, TRAIN_CONFIG["d_model"], TRAIN_CONFIG["vocab"]
    label = f"B{B} H{H} T{T} D{D} causal"
    q, k, v, do = (torch.randn(B, H, T, D, generator=g).to(dev, bf)
                   for _ in range(4))
    out, lse = K.flash_attention_fwd(q, k, v, True)
    _flash_check("flash_attention_fwd", (out, lse),
                 K.flash_attention_fwd_plain(q, k, v, True), dn, label,
                 recs["flash_attention_fwd"])
    got = K.flash_attention_bwd(q, k, v, out, lse, do, True)
    _flash_check("flash_attention_bwd", got,
                 K.flash_attention_bwd_plain(q, k, v, out, lse, do, True),
                 dn, label, recs["flash_attention_bwd"])
    pairs, n = B * H * T * (T + 1) // 2, B * H * T * D
    recs["flash_attention_fwd"]["amp_training"] = _kernel_times(
        {}, lambda: K.flash_attention_fwd(q, k, v, True),
        lambda: K.flash_attention_fwd_plain(q, k, v, True),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        4 * n * 2 + B * H * T * 4, 4 * pairs * D, dn, label + " bf16",
        tensor_cores=True)
    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
    lib = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
    recs["flash_attention_bwd"]["amp_training"] = _kernel_times(
        {}, lambda: K.flash_attention_bwd(q, k, v, out, lse, do, True),
        lambda: K.flash_attention_bwd_plain(q, k, v, out, lse, do, True),
        lambda: torch.autograd.grad(lib, (qq, kk, vv), do,
                                    retain_graph=True),
        (5 * n + 3 * n) * 2 + B * H * T * 4, 10 * pairs * D, dn,
        label + " bf16", tensor_cores=True)
    x = (3 * torch.randn(R, Fw, generator=g) + 1).to(dev, bf)
    dy = torch.randn(R, Fw, generator=g).to(dev, bf)
    sc = (1 + 0.1 * torch.randn(Fw, generator=g)).to(dev)
    bi = (0.1 * torch.randn(Fw, generator=g)).to(dev)
    y, mean, var = K.layer_norm_fwd(x, sc, bi, 1e-5)
    _check("layer_norm_fwd",
           list(zip((y, mean, var), K.layer_norm_fwd_plain(x, sc, bi,
                                                           1e-5))),
           dn, f"R{R} F{Fw}", recs["layer_norm_fwd"])
    inv = torch.rsqrt(var + 1e-5)
    args = (x, sc, mean, inv, dy)
    _check("layer_norm_bwd", list(zip(K.layer_norm_bwd(*args),
                                      K.layer_norm_bwd_plain(*args))),
           dn, f"R{R} F{Fw}", recs["layer_norm_bwd"])
    xx, ww, bb = (t.detach().to(bf).requires_grad_(True)
                  for t in (x, sc, bi))
    recs["layer_norm_fwd"]["amp_training"] = _kernel_times(
        {}, lambda: K.layer_norm_fwd(x, sc, bi, 1e-5),
        lambda: K.layer_norm_fwd_plain(x, sc, bi, 1e-5),
        lambda: F.layer_norm(x, (Fw,), ww.detach(), bb.detach(), 1e-5),
        2 * R * Fw * 2 + 2 * Fw * 4 + 2 * R * 4, 8 * R * Fw, "float32",
        f"R{R} F{Fw} bf16")
    lib = F.layer_norm(xx, (Fw,), ww, bb, 1e-5)
    recs["layer_norm_bwd"]["amp_training"] = _kernel_times(
        {}, lambda: K.layer_norm_bwd(*args),
        lambda: K.layer_norm_bwd_plain(*args),
        lambda: torch.autograd.grad(lib, (xx, ww, bb), dy,
                                    retain_graph=True),
        3 * R * Fw * 2 + 3 * Fw * 4 + 2 * R * 4, 12 * R * Fw, "float32",
        f"R{R} F{Fw} bf16", plain_iters=50)
    xs = (2 * torch.randn(R, V, generator=g)).to(dev, bf)
    lab = torch.randint(0, V, (R,), generator=g).to(dev, torch.int32)
    dl = torch.rand(R, generator=g).to(dev)
    loss, lse = K.softmax_xent_fwd(xs, lab)
    _check("softmax_xent_fwd",
           list(zip((loss, lse), K.softmax_xent_fwd_plain(xs, lab))), dn,
           f"R{R} V{V}", recs["softmax_xent_fwd"])
    _check("softmax_xent_bwd",
           [(K.softmax_xent_bwd(xs, lab, lse, dl),
             K.softmax_xent_bwd_plain(xs, lab, lse, dl))], dn,
           f"R{R} V{V}", recs["softmax_xent_bwd"])
    lab64 = lab.long()
    recs["softmax_xent_fwd"]["amp_training"] = _kernel_times(
        {}, lambda: K.softmax_xent_fwd(xs, lab),
        lambda: K.softmax_xent_fwd_plain(xs, lab),
        lambda: F.cross_entropy(xs, lab64, reduction="none"),
        R * V * 2 + R * 4 + 2 * R * 4, 4 * R * V, "float32",
        f"R{R} V{V} bf16")
    xg = xs.detach().requires_grad_(True)
    lib = F.cross_entropy(xg, lab64, reduction="none")
    recs["softmax_xent_bwd"]["amp_training"] = _kernel_times(
        {}, lambda: K.softmax_xent_bwd(xs, lab, lse, dl),
        lambda: K.softmax_xent_bwd_plain(xs, lab, lse, dl),
        lambda: torch.autograd.grad(lib, (xg,), dl, retain_graph=True),
        2 * R * V * 2 + 3 * R * 4, 4 * R * V, "float32", f"R{R} V{V} bf16")


def _guard_cost(scope, main, iters=10):
    """Device ms a step of the interpreter's commits of the optimize ops
    that carry ``skip_on_found_inf`` (parameters, moments, beta pows):
    ``copy_`` (an op without the guard) against ``torch.where(found, old,
    new, out=old)`` (with it), on copies of this scope's tensors."""
    import torch
    names = sorted({n for op in main.global_block().ops
                    if op.desc.attrs.get("skip_on_found_inf")
                    for n in op.desc.output_names()})
    olds = [scope.get(n).clone() for n in names]
    news = [t.clone() for t in olds]
    found = torch.zeros((), dtype=torch.bool, device=olds[0].device)

    def copy():
        for o, n in zip(olds, news):
            o.copy_(n)

    def guarded():
        for o, n in zip(olds, news):
            torch.where(found, o, n, out=o)
    nbytes = sum(t.numel() * t.element_size() for t in olds)
    out = {"tensors": len(olds), "state_gib": nbytes / 2**30,
           "copy_ms": _time_ms(copy, iters), "where_ms": _time_ms(guarded,
                                                                 iters)}
    out["guard_ms"] = out["where_ms"] - out["copy_ms"]
    return out


def _amp_skip_step(exe, scope, main, feed, avg_cost):
    """The overflowed step of phase 17: at a loss scale of AMP_SKIP_SCALE
    the loss gradient reaching the logits is AMP_SKIP_SCALE / (B x T), so
    the LM's gradients may stay inside f32's range; one step at that
    scale reports whether they overflowed by themselves.  Then the
    overflow is made as the JAX tests make theirs, with one non-finite
    input: an inf in the frozen positional table (a trainable=False
    parameter no optimizer touches).  That step must be a skip: every
    persistable bitwise as before it, the scale halved, the clean-step
    count 0.  Returns ((scale, clean steps) after the skip, whether the
    scale alone overflowed)."""
    import numpy as np
    import torch
    ls = main._loss_scaling
    scale = scope.get(ls["scale"])
    scale.fill_(AMP_SKIP_SCALE)
    _, found = exe.run(main, feed=feed,
                       fetch_list=[avg_cost.name, ls["found_inf"]])
    overflows_alone = bool(np.asarray(found).reshape(-1)[0])
    (table,) = [p.name for p in main.all_parameters() if not p.trainable]
    names = [v.name for v in main.global_block().vars.values()
             if v.persistable and v.name not in (ls["scale"],
                                                 ls["good_steps"])
             and isinstance(scope.get(v.name), torch.Tensor)]
    scope.get(table)[0, 0] = float("inf")
    scale.fill_(AMP_SKIP_SCALE)
    before = {n: scope.get(n).clone() for n in names}
    exe.run(main, feed=feed, fetch_list=[avg_cost])
    torch.cuda.synchronize()
    moved = [n for n in names if not torch.equal(before[n], scope.get(n))]
    after = (float(scope.get(ls["scale"])), int(scope.get(ls["good_steps"])))
    print(f"  scale 2^127 alone: found_inf {overflows_alone}; with an inf in "
          f"{table}: {len(names)} persistables compared, {len(moved)} moved "
          f"{moved[:5]}; scaler after {after}", flush=True)
    if moved or after != (AMP_SKIP_SCALE / 2, 0):
        raise AssertionError("the overflowed step was not a bitwise skip")
    return after, overflows_alone


def _window_step_ms(records, k):
    """Per-step wall ms of each window after the first, from the flight
    ring: the time between two window syncs over the window's k steps."""
    ts = [r["ts"] for r in records if r["note"] == "window_sync"]
    return [(b - a) * 1e3 / k for a, b in zip(ts, ts[1:])]


def amp_train(smi, seed=0):
    """Phase 17: the training config under MixedPrecision(Adam) (bf16
    activations, f32 master weights, dynamic loss scaling) through
    Executor.train_loop: AMP_STEPS steps on one fixed batch in windows of
    AMP_K (one host sync each), a checkpoint every AMP_CKPT_EVERY steps
    into a temporary directory; then a fresh executor and scope resume
    from the last checkpoint to AMP_STEPS, and the resumed losses must be
    bitwise the first run's.  The kernels must launch
    TRAIN_LAUNCHES_PER_STEP times a step and see bf16 operands; the loss
    must fall.  Then one profiled step, and one step at a loss scale of
    AMP_SKIP_SCALE, which must be a skip: every persistable but the
    scaler's bitwise unchanged, the scale halved.  Returns (launches of
    the main run, end-to-end numbers)."""
    import tempfile
    import numpy as np
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.checkpoint import manager as ckpt_manager
    from paddle_tpu_torch.observability import default_registry
    from paddle_tpu_torch.ops import kernels as K
    main, startup, avg_cost = _train_program(seed, amp=True)
    feed = _copy_feed(TRAIN_BATCH, seed)
    ls = main._loss_scaling
    fetch = [avg_cost.name, ls["scale"], ls["good_steps"]]
    loop = dict(fetch_list=fetch, steps=AMP_STEPS, fetch_every=AMP_K,
                steps_per_launch=AMP_K)
    reg = default_registry()
    was_enabled = reg.enabled
    reg.enable()
    save_ms = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "ckpt")
            scope = fluid.core.scope.Scope()
            exe = fluid.Executor(fluid.CUDAPlace(0))
            save = exe._checkpoint

            def timed_save(*args):
                t0 = time.perf_counter()
                save(*args)
                save_ms.append((time.perf_counter() - t0) * 1e3)
            exe._checkpoint = timed_save
            commits0 = ckpt_manager._CKPT_SAVE_S.count
            commit_s0 = ckpt_manager._CKPT_SAVE_S.sum
            with fluid.scope_guard(scope):
                exe.run(startup)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                K.reset_launches()
                with _operand_dtypes(TRAIN_KERNEL_WRAPPERS) as dtypes:
                    t0 = time.perf_counter()
                    handles = exe.train_loop(
                        main, feed, checkpoint_dir=ckpt,
                        checkpoint_every=AMP_CKPT_EVERY, keep_last_n=2,
                        **loop)
                    wall = time.perf_counter() - t0
                launches = {k.name: k.launches for k in K.KERNELS}
                peak = torch.cuda.max_memory_allocated()
            commits = ckpt_manager._CKPT_SAVE_S.count - commits0
            commit_ms = ((ckpt_manager._CKPT_SAVE_S.sum - commit_s0)
                         / max(commits, 1) * 1e3)
            committed = CheckpointManager(ckpt).steps()
            window_ms = _window_step_ms(exe._flight.records(), AMP_K)
            got = [h.get() for h in handles]
            losses = [float(f[0]) for f in got]
            scaler = [(float(f[1][0]), int(f[2][0])) for f in got]
            del exe, scope
            print(f"  {AMP_STEPS} steps in {wall:.2f} s; losses "
                  f"{losses[0]:.6f} -> {losses[-1]:.6f}; committed "
                  f"checkpoints {committed}; operand dtypes "
                  f"{ {n: sorted(d) for n, d in dtypes.items()} }",
                  flush=True)
            for name, per in TRAIN_LAUNCHES_PER_STEP.items():
                if launches[name] != per * AMP_STEPS:
                    raise AssertionError(
                        f"{name}: {launches[name]} launches in {AMP_STEPS} "
                        f"amp steps, want {per} per step")
            bad = {n: d for n, d in dtypes.items() if d != {"bfloat16"}}
            if bad:
                raise AssertionError(f"kernels not fed bf16 under amp: {bad}")
            if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
                raise AssertionError(f"amp losses do not fall: {losses}")
            if committed[-1] != AMP_STEPS - AMP_STEPS % AMP_CKPT_EVERY:
                raise AssertionError(f"checkpoints {committed}")

            scope2 = fluid.core.scope.Scope()
            exe2 = fluid.Executor(fluid.CUDAPlace(0))
            with fluid.scope_guard(scope2):
                exe2.run(startup)
                K.reset_launches()
                resumed = exe2.train_loop(main, feed, resume_from=ckpt,
                                          **loop)
                resume_launches = {k.name: k.launches for k in K.KERNELS}
                again = [float(h.get()[0]) for h in resumed]
                start = resumed[0].step
                print(f"  resumed from step {start}: losses {again} "
                      f"against {losses[start:]}", flush=True)
                if start != committed[-1]:
                    raise AssertionError(f"resumed at {start}")
                for name, per in TRAIN_LAUNCHES_PER_STEP.items():
                    if resume_launches[name] != per * len(again):
                        raise AssertionError(f"{name} on resume: "
                                             f"{resume_launches[name]}")
                diff = [(start + i, a, b) for i, (a, b) in
                        enumerate(zip(again, losses[start:]))
                        if np.float32(a).tobytes() != np.float32(b).tobytes()]
                if diff:
                    raise AssertionError(
                        f"the resumed losses differ from the first run's: "
                        f"{diff}")
                device = _profile_step(exe2, main, feed, avg_cost)
                guard = _guard_cost(scope2, main)
                skip_scaler, overflows_alone = _amp_skip_step(
                    exe2, scope2, main, feed, avg_cost)
    finally:
        if not was_enabled:
            reg.disable()
    p50 = float(np.percentile(window_ms, 50))
    e2e = {"steps": AMP_STEPS, "steps_per_launch": AMP_K,
           "step_ms_p50": p50,
           "step_ms_p99": float(np.percentile(window_ms, 99)),
           "window_step_ms": window_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_CONFIG["max_len"] * 1e3 / p50,
           "loss_first": losses[0], "loss_last": losses[-1],
           "resumed_from": start, "resumed_bitwise": True,
           "scaler_trajectory": scaler, "skip_scaler": skip_scaler,
           "scale_2_127_overflows_alone": overflows_alone,
           "checkpoint_caller_ms": save_ms, "checkpoint_commit_ms": commit_ms,
           "checkpoints_committed": commits, "guard": guard,
           "peak_mem_gib": peak / 2**30, "profiled_device_ms": device,
           "device_busy_share": (device["all"] / p50 if device else None)}
    print(f"  ({smi}) step p50 {p50:.3f} ms, p99 {e2e['step_ms_p99']:.3f} ms "
          f"(per step of windows 2-{AMP_STEPS // AMP_K}: {window_ms})",
          flush=True)
    print(f"  ({smi}) tokens/s {e2e['tokens_per_s']:.1f}", flush=True)
    print(f"  ({smi}) device ms a step "
          f"{device['all'] if device else None}, busy share "
          f"{e2e['device_busy_share']}", flush=True)
    print(f"  ({smi}) scaler trajectory (scale, clean steps): {scaler}",
          flush=True)
    print(f"  ({smi}) checkpoint caller-thread ms {save_ms}, commit ms "
          f"{commit_ms:.1f} ({commits} commits)", flush=True)
    print(f"  ({smi}) guard: {json.dumps(guard)}", flush=True)
    return launches, e2e


# ---------------------------------------------------------------------------
# phase 18: every optimizer rule, clip, weight decay and LR schedule
# ---------------------------------------------------------------------------

OPT_STEPS = 5
#: the sparse cases' table rows and ids a row
OPT_V, OPT_IDS = 20, 5


def _opt_fc(fl, param_attr=None):
    layers = fl.layers
    x = layers.data(name="x", shape=[4], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    h = layers.fc(input=x, size=6, act="tanh", param_attr=param_attr)
    pred = layers.fc(input=h, size=1)
    return layers.mean(layers.square_error_cost(input=pred, label=y))


def _opt_sparse(fl, param_attr=None):
    """`_opt_fc` after an is_sparse table: ids [OPT_IDS] -> embedding
    [OPT_V, 4] -> their mean -> the fc program, x added."""
    layers = fl.layers
    ids = layers.data(name="ids", shape=[OPT_IDS], dtype="int64")
    emb = layers.embedding(input=ids, size=[OPT_V, 4], is_sparse=True)
    x = layers.data(name="x", shape=[4], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    h = layers.fc(input=layers.elementwise_add(
        layers.reduce_mean(emb, dim=1), x), size=6, act="tanh",
        param_attr=param_attr)
    pred = layers.fc(input=h, size=1)
    return layers.mean(layers.square_error_cost(input=pred, label=y))


def _opt_case(make_opt, param_attr=None, clip=None, schedule=None,
              average=False, sparse=False):
    """A phase-18 program builder: fluid -> (loss, extra fetches,
    ModelAverage or None); ``sparse`` builds `_opt_sparse`."""
    def build(fl):
        loss = (_opt_sparse if sparse else _opt_fc)(
            fl, param_attr(fl) if param_attr else None)
        if clip:
            fl.clip.set_gradient_clip(clip(fl))
        lr = schedule(fl.layers) if schedule else None
        make_opt(fl, lr).minimize(loss)
        ma = (fl.optimizer.ModelAverage(average_window_rate=0.5,
                                        min_average_window=2,
                                        max_average_window=3)
              if average else None)
        return loss, [lr.name] if lr is not None else [], ma
    build.make_opt = make_opt
    return build


def _opt_cases():
    def opt(cls, lr=0.1, **kw):
        return lambda fl, sched: getattr(fl.optimizer, cls)(
            sched if sched is not None else lr, **kw)
    cases = {
        "sgd": _opt_case(opt("SGD")),
        "momentum": _opt_case(opt("Momentum", momentum=0.9)),
        "momentum nesterov": _opt_case(opt("Momentum", momentum=0.9,
                                           use_nesterov=True)),
        "adam": _opt_case(opt("Adam", 0.05)),
        "adamax": _opt_case(opt("Adamax", 0.05)),
        "adagrad": _opt_case(opt("Adagrad")),
        "decayed_adagrad": _opt_case(opt("DecayedAdagrad")),
        "adadelta": _opt_case(opt("Adadelta", 1.0)),
        "rmsprop": _opt_case(opt("RMSProp", 0.01, momentum=0.5)),
        "ftrl": _opt_case(opt("Ftrl", l1=0.01, l2=0.01)),
        "ftrl lr_power -0.7": _opt_case(opt("Ftrl", l1=0.01, l2=0.01,
                                            lr_power=-0.7)),
        "proximal_gd": _opt_case(opt("ProximalGD", l1=0.01, l2=0.01)),
        "proximal_adagrad": _opt_case(opt("ProximalAdagrad", l1=0.01,
                                          l2=0.01)),
        "average_accumulates": _opt_case(opt("SGD"), average=True),
        "L1Decay": _opt_case(lambda fl, s: fl.optimizer.Momentum(
            0.1, momentum=0.9, regularization=fl.regularizer.L1Decay(0.05))),
        "L2Decay": _opt_case(lambda fl, s: fl.optimizer.Momentum(
            0.1, momentum=0.9, regularization=fl.regularizer.L2Decay(0.05))),
        "L2Decay on a parameter": _opt_case(
            opt("Adam", 0.05), param_attr=lambda fl: fl.ParamAttr(
                regularizer=fl.regularizer.L2Decay(0.05))),
        "per-parameter learning rate": _opt_case(
            opt("Adam", 0.05),
            param_attr=lambda fl: fl.ParamAttr(learning_rate=0.25)),
        "GradientClipByValue": _opt_case(
            opt("SGD", 1.0),
            clip=lambda fl: fl.clip.GradientClipByValue(max=0.05)),
        "GradientClipByNorm": _opt_case(
            opt("SGD", 1.0),
            clip=lambda fl: fl.clip.GradientClipByNorm(clip_norm=0.1)),
        "GradientClipByGlobalNorm": _opt_case(
            opt("SGD", 1.0),
            clip=lambda fl: fl.clip.GradientClipByGlobalNorm(clip_norm=0.1)),
    }
    schedules = {
        "noam_decay": lambda L: L.noam_decay(d_model=64, warmup_steps=3),
        "exponential_decay": lambda L: L.exponential_decay(0.5, 2, 0.5,
                                                           staircase=True),
        "natural_exp_decay": lambda L: L.natural_exp_decay(0.5, 2, 0.5),
        "inverse_time_decay": lambda L: L.inverse_time_decay(0.5, 2, 0.5),
        "polynomial_decay": lambda L: L.polynomial_decay(0.5, 3, 0.01,
                                                         power=2.0),
        "polynomial_decay cycle": lambda L: L.polynomial_decay(
            0.5, 2, 0.01, cycle=True),
        "piecewise_decay": lambda L: L.piecewise_decay([2, 4],
                                                       [0.5, 0.2, 0.05]),
    }
    for name, sched in schedules.items():
        cases[name] = _opt_case(opt("SGD"), schedule=sched)
    # the SelectedRows branches: an is_sparse table (`_opt_sparse`)
    for name in ("sgd", "momentum nesterov", "adam"):
        cases["sparse " + name] = _opt_case(cases[name].make_opt,
                                            sparse=True)
    return cases


def _opt_run(build, place, state, feeds):
    """Build a phase-18 program, put ``state`` in a fresh scope on
    ``place`` and take len(feeds) steps: (fetches a step, final state,
    ModelAverage or None, scope)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio
    fluid.core.program.reset_default_programs()
    loss, extra, ma = build(fluid)
    main = fluid.default_main_program()
    exe = fluid.Executor(place)
    scope = fluid.core.scope.Scope()
    pio.scope_from_numpy(scope, main, state, exe.device)
    with fluid.scope_guard(scope):
        fetched = [exe.run(main, feed=f, fetch_list=[loss.name] + extra)
                   for f in feeds]
    final = {n: scope.get(n).cpu().numpy() for n in state}
    return fetched, final, ma, scope


def optimizer_rules_card_vs_cpu(seed=0):
    """Phase 18: each case of `_opt_cases` (every optimizer rule,
    ModelAverage's accumulation, each weight decay, clip and LR schedule,
    a per-parameter learning rate) on a small fc program: OPT_STEPS steps
    on the card and on the CPU from the same startup state and feeds;
    every loss and fetched learning rate and every persistable afterwards
    to F32_TOL x max(1, max |cpu|).  ModelAverage's apply/restore must
    round-trip the card's parameters bitwise, its average agreeing with
    the CPU's."""
    import numpy as np
    import torch
    import paddle_tpu_torch as fluid
    rng = np.random.RandomState(seed)
    feeds = [{"x": rng.rand(8, 4).astype(np.float32),
              "y": rng.rand(8, 1).astype(np.float32)}
             for _ in range(OPT_STEPS)]
    # the sparse cases' ids: the upper half of the table never looked up
    sparse_feeds = [dict(f, ids=rng.randint(0, OPT_V // 2, (8, OPT_IDS)))
                    for f in feeds]
    worst = {}
    rules = set()
    for label, build in _opt_cases().items():
        fluid.core.program.reset_default_programs()
        build(fluid)
        rules |= {op.type for op in
                  fluid.default_main_program().global_block().ops}
        startup = fluid.default_startup_program()
        startup.random_seed = seed
        scope = fluid.core.scope.Scope()
        with fluid.scope_guard(scope):
            fluid.Executor(fluid.CPUPlace()).run(startup)
        state = {n: v.cpu().numpy() for n, v in scope._vars.items()}
        f = sparse_feeds if label.startswith("sparse") else feeds
        card, card_state, ma, card_scope = _opt_run(
            build, fluid.CUDAPlace(0), state, f)
        cpu, cpu_state, cpu_ma, cpu_scope = _opt_run(
            build, fluid.CPUPlace(), state, f)
        if label.startswith("sparse"):
            for n, a in state.items():
                if (a.shape == (OPT_V, 4) and not np.array_equal(
                        card_state[n][OPT_V // 2:], a[OPT_V // 2:])):
                    raise AssertionError(f"phase 18 {label}: rows never "
                                         f"looked up moved in {n}")
        pairs = ([(f"step {i} fetch {j}", a, b)
                  for i, (ca, cb) in enumerate(zip(card, cpu))
                  for j, (a, b) in enumerate(zip(ca, cb))]
                 + [(n, card_state[n], cpu_state[n]) for n in state])
        share = 0.0
        for what, a, b in pairs:
            b = np.asarray(b, np.float64)
            lim = F32_TOL * max(1.0, float(np.abs(b).max()))
            err = float(np.abs(np.asarray(a, np.float64) - b).max())
            share = max(share, err / lim)
            if err > lim:
                raise AssertionError(f"phase 18 {label}: {what} differs "
                                     f"by {err:.3e} (limit {lim:.3e})")
        if ma is not None:
            with fluid.scope_guard(card_scope):
                live = {p.name: card_scope.get(p.name).clone()
                        for p in ma.params}
                with ma.apply():
                    avg = {n: card_scope.get(n).cpu().numpy() for n in live}
                if not all(torch.equal(card_scope.get(n), t)
                           for n, t in live.items()):
                    raise AssertionError("ModelAverage restore is not "
                                         "bitwise on the card")
            with fluid.scope_guard(cpu_scope):
                with cpu_ma.apply():
                    for n, a in avg.items():
                        b = cpu_scope.get(n).numpy()
                        if np.abs(a - b).max() > F32_TOL * max(
                                1.0, float(np.abs(b).max())):
                            raise AssertionError(
                                f"ModelAverage's average of {n} differs")
        worst[label] = share
    missing = set(OPTIMIZER_RULES) - rules
    if missing:
        raise AssertionError(f"phase 18 ran no case of {sorted(missing)}")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    print(f"  {len(worst)} cases held over {OPT_STEPS} steps; largest "
          f"shares of the tolerance: {top}", flush=True)
    return {"cases": len(worst), "largest_share": top[0][1]}


# ---------------------------------------------------------------------------
# phases 19-21: seq2seq attention NMT training and beam generation, and the
# sequence, beam, LoD, array, control-flow and CRF rules on the card
# ---------------------------------------------------------------------------

#: bench.py bench_seq2seq (:712-745): models/seq2seq.py seq_to_seq_net
#: with embedding, encoder and decoder 512 and vocabulary 30000 on both
#: sides, batch 64, T 50 (full lengths, ids seeded in [1, 30000)), Adam
#: 1e-3, program.amp on (bench.py:1119)
S2S_CONFIG = dict(embedding_dim=512, encoder_size=512, decoder_size=512,
                  source_dict_dim=30000, target_dict_dim=30000)
S2S_BATCH, S2S_T, S2S_STEPS = 64, 50, 20
S2S_FEEDS = ("source_sequence", "target_sequence", "label_sequence")
#: launches a step: the encoder's two dynamic_lstm layers (forward and
#: is_reverse), and the flat head's softmax cross-entropy
S2S_LAUNCHES_PER_STEP = dict(
    {name: 0 for name in TRAIN_LAUNCHES_PER_STEP}, lstm_fwd=2, lstm_bwd=2,
    softmax_xent_fwd=1, softmax_xent_bwd=1)
#: phase 19's f32 step on the card against the CPU: batch, ragged lengths
S2S_CPU_BATCH = 4
#: bench.py:1042-1060: seq_to_seq_generate at the same widths, batch 16,
#: beam 3, max_length 50, a source of T 50
S2S_GEN_BATCH, S2S_BEAM, S2S_MAX_LEN = 16, 3, 50
#: LSTM forward launches a decode: the encoder's two layers (f32 w)
S2S_GEN_LSTM_LAUNCHES = 2
#: the card's beams may part from the CPU's only after a step whose
#: selected scores differ by at most this share of their magnitude: a near
#: tie in the top-k that f32 rounding swapped
S2S_TIE_RTOL = 1e-5
#: phase 3's encoder shapes (T, B, H, lengths, reversed): training's batch
#: both ways, full and ragged; generation's batch 16
S2S_LSTM_CASES = [(S2S_T, S2S_BATCH, 512, lens, rev)
                  for lens in ("full", "ragged") for rev in (False, True)]
S2S_GEN_LSTM = (S2S_T, S2S_GEN_BATCH, 512, "full", False)


def _lstm_pair(args, bf, label, rec_fwd, rec_bwd):
    """One LSTM forward and backward against their plain versions."""
    import torch
    from paddle_tpu_torch.ops import kernels as K
    xs, w, h0, c0, mask, dhs, dcs = args
    fwd_args = (xs, w, h0, c0, mask)
    got, ref = K.lstm_fwd(*fwd_args), K.lstm_fwd_plain(*fwd_args)
    bwd_args = fwd_args + tuple(ref) + (dhs, dcs)
    dgot, dref = K.lstm_bwd(*bwd_args), K.lstm_bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    _check("lstm_fwd", list(zip(got, ref)), "float32", label, rec_fwd,
           "bf16_max" if bf else None)
    _check("lstm_bwd", list(zip(dgot, dref)), "float32", label, rec_bwd,
           "bf16_max" if bf else None)
    return fwd_args, bwd_args


def check_seq2seq_kernels(recs):
    """Phase 3 at the seq2seq path's shapes: the LSTM kernels at the
    encoder's T50 B64 H512, forward and is_reverse, full and ragged
    lengths, with the bf16 w of program.amp and with f32 w, and at
    generation's B16 (f32 w); the softmax cross-entropy kernels on the
    flat head, R3200 V30000, in bf16 (amp) and f32.  Each against its
    plain version (phase 3's rules), timed beside nn.LSTM and
    F.cross_entropy; and the head's three bf16 products (forward, dX,
    dW) timed with cuBLAS against their bound."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kernels as K
    g = torch.Generator(device="cpu").manual_seed(21)
    rec_fwd, rec_bwd = recs["lstm_fwd"], recs["lstm_bwd"]
    for case in S2S_LSTM_CASES + [S2S_GEN_LSTM]:
        t, b, h, lens, rev = case
        for wdt in ((torch.float32,) if case == S2S_GEN_LSTM
                    else (torch.bfloat16, torch.float32)):
            xs, w32, h0, c0, mask, dhs, dcs = _recurrent_inputs(
                4, t, b, h, lens, rev, g)
            bf = wdt is torch.bfloat16
            dn = str(wdt).replace("torch.", "")
            label = (f"T{t} B{b} H{h} {lens}" + (" reverse" if rev else "")
                     + f" w {dn} (seq2seq)")
            fwd_args, bwd_args = _lstm_pair(
                (xs, w32.to(wdt), h0, c0, mask, dhs, dcs), bf, label,
                rec_fwd, rec_bwd)
            key = ("seq2seq_generation" if case == S2S_GEN_LSTM else
                   f"seq2seq_{'bf16' if bf else 'f32'}_w")
            if lens == "full" and not rev:
                rec_fwd[key] = _recurrent_timings("lstm", False, fwd_args,
                                                  bwd_args)
                if case != S2S_GEN_LSTM:
                    rec_bwd[key] = _recurrent_timings("lstm", True,
                                                      fwd_args, bwd_args)
    r, v = S2S_BATCH * S2S_T, S2S_CONFIG["target_dict_dim"]
    dev = torch.device("cuda")
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        x = (2 * torch.randn(r, v, generator=g)).to(dev, dtype)
        lab = torch.randint(1, v, (r,), generator=g).to(dev, torch.int32)
        dl = torch.rand(r, generator=g).to(dev)
        loss, lse = K.softmax_xent_fwd(x, lab)
        rloss, rlse = K.softmax_xent_fwd_plain(x, lab)
        dx = K.softmax_xent_bwd(x, lab, lse, dl)
        rdx = K.softmax_xent_bwd_plain(x, lab, lse, dl)
        torch.cuda.synchronize()
        label = f"R{r} V{v} (seq2seq head)"
        _check("softmax_xent_fwd", [(loss, rloss), (lse, rlse)], dn, label,
               recs["softmax_xent_fwd"])
        _check("softmax_xent_bwd", [(dx, rdx)], dn, label,
               recs["softmax_xent_bwd"])
        shape = f"R{r} V{v} {dn} (seq2seq head)"
        lab64 = lab.long()
        eb = x.element_size()
        recs["softmax_xent_fwd"][f"seq2seq_{dn}"] = _kernel_times(
            {}, lambda: K.softmax_xent_fwd(x, lab),
            lambda: K.softmax_xent_fwd_plain(x, lab),
            lambda: F.cross_entropy(x, lab64, reduction="none"),
            r * v * eb + r * 4 + 2 * r * 4, 4 * r * v, dn, shape)
        xx = x.detach().requires_grad_(True)
        lib = F.cross_entropy(xx, lab64, reduction="none")
        recs["softmax_xent_bwd"][f"seq2seq_{dn}"] = _kernel_times(
            {}, lambda: K.softmax_xent_bwd(x, lab, lse, dl),
            lambda: K.softmax_xent_bwd_plain(x, lab, lse, dl),
            lambda: torch.autograd.grad(lib, (xx,), dl, retain_graph=True),
            2 * r * v * eb + 3 * r * 4, 4 * r * v, dn, shape)
        del x, xx, lib, dx, rdx
    d = S2S_CONFIG["decoder_size"]
    hid = torch.randn(r, d, generator=g).to(dev, torch.bfloat16)
    w = torch.randn(d, v, generator=g).to(dev, torch.bfloat16)
    dy = torch.randn(r, v, generator=g).to(dev, torch.bfloat16)
    gemm = {"forward": _time_ms(lambda: hid @ w),
            "dX": _time_ms(lambda: dy @ w.t()),
            "dW": _time_ms(lambda: hid.t() @ dy)}
    gemm["bound_ms_each"] = _bound((r * d + d * v + r * v) * 2,
                                   2 * r * d * v, "bfloat16")[0]
    gemm["shape"] = f"[{r}, {d}] x [{d}, {v}] bf16"
    print(f"  the seq2seq head's products (cuBLAS, bf16): {gemm}",
          flush=True)
    recs["softmax_xent_fwd"]["seq2seq_head_gemm_ms"] = gemm


def _s2s_program(seed, amp):
    """seq_to_seq_net at S2S_CONFIG + Adam 1e-3 in fresh default programs
    -> (main, startup, avg_cost, prediction)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import seq2seq
    fluid.core.program.reset_default_programs()
    avg_cost, prediction, _ = seq2seq.seq_to_seq_net(**S2S_CONFIG)
    optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    main = fluid.default_main_program()
    main.amp = amp
    startup = fluid.default_startup_program()
    startup.random_seed = seed
    return main, startup, avg_cost, prediction


def _s2s_feed(batch, seed, ragged=False):
    """bench_seq2seq's feed: ids in [1, vocab) for the three sequences,
    full lengths (or seeded in [1, T], the first row full, the last of
    length 1, each sequence its own)."""
    rng = np.random.default_rng(seed)
    feed = {}
    for name in S2S_FEEDS:
        feed[name] = rng.integers(1, S2S_CONFIG["target_dict_dim"],
                                  (batch, S2S_T)).astype(np.int64)
        lens = np.full(batch, S2S_T, np.int32)
        if ragged:
            lens = rng.integers(1, S2S_T + 1, batch).astype(np.int32)
            lens[0], lens[-1] = S2S_T, 1
        feed[name + "@SEQ_LEN"] = lens
    return feed


#: phase 19's kernel groups, by kernel name
S2S_KERNEL_GROUPS = {
    "encoder LSTM kernels": ("lstm_", "rnn_"),
    "softmax cross-entropy kernels": ("sm_xent_",),
    "library products (GEMMs)": ("xmma", "gemm", "cutlass", "nvjet")}
#: and by the op whose rule launched them (the backward op's kernels run
#: on autograd's device thread, outside the op's range: they are read
#: from autograd's own ranges, "autograd::engine::evaluate_function: ...")
S2S_OP_GROUPS = {"decoder DynamicRNN (forward, eager per-step ops)":
                 "dynamic_rnn",
                 "optimizer (Adam)": "adam"}


def _profile_s2s_step(exe, main, feed, avg_cost):
    """One step under torch.profiler: device ms in all, by kernel group
    and by the op ranges of S2S_OP_GROUPS (the rest of the forward is what
    they leave), launches, and the step's wall ms.  A measurement aid:
    None if the profiler fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        with _op_ranges(S2S_OP_GROUPS.values()), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=[avg_cost])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = prof.key_averages()
        # a profiler range (the executor's "executor.run") also shows on
        # the device's timeline: it spans kernels, it is none
        annotations = {e.name for e in prof.events()
                       if getattr(e, "is_user_annotation", False)}
        kernels = [r for r in rows
                   if r.device_type == torch.autograd.DeviceType.CUDA
                   and not r.key.startswith("op:")
                   and r.key not in annotations]
        total = sum(r.device_time_total for r in kernels) / 1e3
        by_kernel = dict.fromkeys(list(S2S_KERNEL_GROUPS) + ["other"], 0.0)
        for r in kernels:
            group = next((g for g, keys in S2S_KERNEL_GROUPS.items()
                          if any(k in r.key.lower() for k in keys)), "other")
            by_kernel[group] += r.device_time_total / 1e3
        cpu = [r for r in rows
               if r.device_type == torch.autograd.DeviceType.CPU]
        by_op = {g: sum(r.device_time_total for r in cpu
                        if r.key == "op:" + t) / 1e3
                 for g, t in S2S_OP_GROUPS.items()}
        by_op["backward (autograd)"] = sum(
            r.device_time_total for r in cpu if r.key.startswith(
                "autograd::engine::evaluate_function")) / 1e3
        by_op["the rest of the forward (encoder, head, loss)"] = (
            total - sum(by_op.values()))
        return {"all": total, "wall_ms": wall,
                "launches": sum(r.count for r in kernels),
                "by_kernel": by_kernel, "by_op": by_op}
    except Exception as e:  # noqa: BLE001  (a measurement aid)
        print(f"  profiler unavailable: {type(e).__name__}: {e}",
              flush=True)
        return None


def train_seq2seq(seed=0):
    """Phase 19: S2S_STEPS Adam steps of seq_to_seq_net at
    bench_seq2seq's config under program.amp on the card, the batch
    staged on the card; then one profiled step with the interpreter's
    dead-op skip and one without it (the unfetched 3-D prediction head
    runs: a [3200, 512] x [512, 30000] product and a softmax)."""
    import torch
    from paddle_tpu_torch.core.lowering import Interpreter
    main, startup, avg_cost, _ = _s2s_program(seed, amp=True)
    feed = {k: torch.from_numpy(v).to("cuda")
            for k, v in _s2s_feed(S2S_BATCH, seed).items()}
    anatomy = {}

    def after(exe):
        anatomy["skip"] = _profile_s2s_step(exe, main, feed, avg_cost)
        Interpreter.skip_dead_ops = False
        try:
            anatomy["no_skip"] = _profile_s2s_step(exe, main, feed, avg_cost)
        finally:
            Interpreter.skip_dead_ops = True
    launches, e2e, state = _train_steps(
        main, startup, avg_cost, feed, S2S_STEPS, S2S_LAUNCHES_PER_STEP,
        other="eager per-step ops and other elementwise", after=after)
    per_s = 1e3 / e2e["step_ms_p50"]
    e2e.update(examples_per_s=S2S_BATCH * per_s,
               tokens_per_s=S2S_BATCH * S2S_T * per_s,
               launches_per_step={k: v / S2S_STEPS
                                  for k, v in launches.items() if v},
               anatomy=anatomy)
    skip, no_skip = anatomy["skip"], anatomy["no_skip"]
    if skip and no_skip:
        e2e["host_idle_share"] = 1.0 - skip["all"] / e2e["step_ms_p50"]
        e2e["dead_op_skip_saves_device_ms"] = no_skip["all"] - skip["all"]
    print(f"  seq2seq: step p50 {e2e['step_ms_p50']:.3f} ms, "
          f"{e2e['examples_per_s']:.1f} examples/s, "
          f"{e2e['tokens_per_s']:.0f} tokens/s, loss {e2e['loss_first']:.5f}"
          f" -> {e2e['loss_last']:.5f}, host idle share "
          f"{e2e.get('host_idle_share')}; the profiled step with the "
          f"dead-op skip: {json.dumps(skip)}; without it: "
          f"{json.dumps(no_skip)}", flush=True)
    return launches, e2e, state


def s2s_card_vs_cpu(state, seed=0):
    """Phase 19's f32 check: seq_to_seq_net in f32 (amp off, TF32 off) at
    full width, batch S2S_CPU_BATCH with ragged lengths: one step from the
    carried-in state on the card (kernels) and on the CPU (plain
    versions), the loss to CPU_LOSS_RTOL and each @GRAD's max abs error
    over its max |value| to CPU_GRAD_RTOL (phases 6 and 11's rule)."""
    import paddle_tpu_torch as fluid
    main, _, avg_cost, _ = _s2s_program(seed, amp=False)
    feed = _s2s_feed(S2S_CPU_BATCH, seed + 1, ragged=True)
    params, card = _step(fluid.CUDAPlace(0), main, avg_cost, feed, state)
    _, cpu = _step(fluid.CPUPlace(), main, avg_cost, feed, state)
    loss_err = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
    errs = sorted(((float(np.abs(a - b).max())
                    / max(float(np.abs(b).max()), 1e-30), n)
                   for n, a, b in zip(params, card[1:], cpu[1:])),
                  reverse=True)
    print(f"  loss relative error {loss_err:.3e} (limit {CPU_LOSS_RTOL}); "
          f"largest @GRAD errors over each gradient's max |value| (limit "
          f"{CPU_GRAD_RTOL}): "
          + ", ".join(f"{n} {e:.3e}" for e, n in errs[:5]), flush=True)
    if loss_err > CPU_LOSS_RTOL or errs[0][0] > CPU_GRAD_RTOL:
        raise AssertionError("the card's seq2seq step disagrees with the "
                             "CPU's")
    return {"loss_rel_err": loss_err, "grad_rel_err_max": errs[0][0],
            "grads_compared": len(params)}


def _s2s_beam_divergence(card, cpu):
    """Hold the card's beams to the CPU's: per sample, the step outputs
    (ids, parents) equal, or first part at a step whose selected scores
    are within S2S_TIE_RTOL of the CPU's (a near tie); -> the parted
    samples as (sample, step, gap share)."""
    ids_c, par_c, sc_c = (np.asarray(a) for a in card)
    ids_h, par_h, sc_h = (np.asarray(a) for a in cpu)
    parted = []
    for s in range(ids_c.shape[0] // S2S_BEAM):
        rows = slice(s * S2S_BEAM, (s + 1) * S2S_BEAM)
        same = ((ids_c[rows].reshape(S2S_BEAM, -1)
                 == ids_h[rows].reshape(S2S_BEAM, -1)).all(0)
                & (par_c[rows] == par_h[rows]).all(0))
        if same.all():
            continue
        t = int(np.argmin(same))
        a = sc_c[rows, t].astype(np.float64).reshape(-1)
        b = sc_h[rows, t].astype(np.float64).reshape(-1)
        share = float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max()
                      / S2S_TIE_RTOL)
        parted.append((s, t, share))
        if share > 1.0:
            raise AssertionError(
                f"sample {s}: the card's beam parts from the CPU's at step "
                f"{t} on no near tie (selected scores {a.tolist()} against "
                f"{b.tolist()}: {share:.3f} of the tolerance)")
    return parted


def generate_seq2seq(state, seed=0):
    """Phase 20: seq_to_seq_generate at bench.py:1042-1060's config
    (batch 16, beam 3, max_length 50, the training widths) with phase
    19's parameters by name over the generator's own startup (its
    vocabulary fc has an automatic name, not the training head's): the
    batch latency and sentences/s on the card (launch counts zeroed just
    before the timed runs), then the same decode on the CPU: the card's
    ids must equal the CPU's, or part only after a near tie
    (`_s2s_beam_divergence`)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio
    from paddle_tpu_torch.models import seq2seq
    from paddle_tpu_torch.ops import kernels as K
    fluid.core.program.reset_default_programs()
    sent_ids, sent_scores = seq2seq.seq_to_seq_generate(
        beam_size=S2S_BEAM, max_length=S2S_MAX_LEN, **S2S_CONFIG)
    main, startup = (fluid.default_main_program(),
                     fluid.default_startup_program())
    startup.random_seed = seed
    rnn = next(op for op in main.global_block().ops
               if op.type == "dynamic_rnn")
    fetch = [sent_ids.name, sent_scores.name] + rnn.desc.outputs["Out"]
    scope0 = fluid.core.scope.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope0)
    arrays = {}
    for v in main.list_vars():
        if v.persistable and not v.desc.is_data:
            mine = scope0.get(v.name).cpu().numpy()
            trained = state.get(v.name)
            arrays[v.name] = (trained if trained is not None
                              and trained.shape == mine.shape else mine)
    loaded = sum(1 for n in arrays if n in state)
    rng = np.random.default_rng(seed + 2)
    feed = {"source_sequence": rng.integers(
                1, S2S_CONFIG["source_dict_dim"],
                (S2S_GEN_BATCH, S2S_T)).astype(np.int64),
            "source_sequence@SEQ_LEN": np.full(S2S_GEN_BATCH, S2S_T,
                                               np.int32)}

    def decode(place, timed=0):
        exe = fluid.Executor(place)
        scope = fluid.core.scope.Scope()
        pio.scope_from_numpy(scope, main, arrays, exe.device)
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        ms = []
        if timed:
            K.reset_launches()
            for _ in range(timed):
                t0 = time.perf_counter()
                out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
                ms.append((time.perf_counter() - t0) * 1e3)
        return out, ms
    card, ms = decode(fluid.CUDAPlace(0), timed=3)
    launches = {k.name: k.launches for k in K.KERNELS}
    if launches["lstm_fwd"] != S2S_GEN_LSTM_LAUNCHES * len(ms):
        raise AssertionError(f"lstm_fwd: {launches['lstm_fwd']} launches in "
                             f"{len(ms)} decodes, want "
                             f"{S2S_GEN_LSTM_LAUNCHES} each")
    t0 = time.perf_counter()
    cpu, _ = decode(fluid.CPUPlace())
    cpu_s = time.perf_counter() - t0
    ids = np.asarray(card[0])
    if ids.shape != (S2S_GEN_BATCH * S2S_BEAM, S2S_MAX_LEN) or not (
            0 <= ids.min() and ids.max() < S2S_CONFIG["target_dict_dim"]):
        raise AssertionError(f"sentence ids of shape {ids.shape} out of "
                             "range")
    if not np.isfinite(np.asarray(card[1])).all():
        raise AssertionError("non-finite sentence scores")
    parted = _s2s_beam_divergence(card[2:], cpu[2:])
    same_ids = int((np.asarray(card[0]) == np.asarray(cpu[0])).all(1).sum())
    p50 = float(np.percentile(ms, 50))
    e2e = {"batch_latency_ms_p50": p50, "batch_latency_ms": ms,
           "sentences_per_s": S2S_GEN_BATCH * 1e3 / p50,
           "parameters_from_training": loaded,
           "parameters": len(arrays), "cpu_decode_s": cpu_s,
           "rows_equal_cpu": same_ids,
           "rows": S2S_GEN_BATCH * S2S_BEAM,
           "parted_after_near_tie": parted}
    print(f"  generation: batch latency p50 {p50:.2f} ms ({ms}), "
          f"{e2e['sentences_per_s']:.2f} sentences/s; {same_ids} of "
          f"{e2e['rows']} sentences equal the CPU's; samples parted after "
          f"a near tie (sample, step, share of the tolerance): {parted}",
          flush=True)
    return launches, e2e


def _program_state(startup):
    """A startup's persistables, initialised on the CPU, as numpy."""
    import paddle_tpu_torch as fluid
    scope = fluid.core.scope.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return {n: v.cpu().numpy() for n, v in scope._vars.items()
            if hasattr(v, "cpu")}


def _state_run(place, main, state, feed, fetch):
    """``main`` on ``place`` from the persistables ``state`` (numpy)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio
    exe = fluid.Executor(place)
    scope = fluid.core.scope.Scope()
    pio.scope_from_numpy(scope, main, state, exe.device)
    return exe.run(main, feed=feed, fetch_list=fetch, scope=scope)


def _s21_programs():
    """Phase 21's programs built with the port's layers: name -> a function
    that fills fresh default programs and returns (fetch names, feed)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.backward import calc_gradient
    rng = np.random.default_rng(21)

    def u(*shape):
        return rng.uniform(-1, 1, shape).astype(np.float32)

    def while_loop(bounded):
        def build():
            x = L.data(name="x", shape=[3], dtype="float32",
                       append_batch_size=False)
            i = L.fill_constant(shape=[1], dtype="int64", value=0)
            lim = L.fill_constant(shape=[1], dtype="int64", value=5)
            acc = L.fill_constant(shape=[3], dtype="float32", value=0.0)
            acc.stop_gradient = False
            cond = L.less_than(x=i, y=lim)
            w = L.While(cond=cond, max_trip_count=8 if bounded else None)
            with w.block():
                L.assign(L.elementwise_add(L.scale(acc, scale=1.1), x),
                         output=acc)
                L.increment(i, value=1, in_place=True)
                L.less_than(x=i, y=lim, cond=cond)
            loss = L.reduce_sum(acc)
            fetch = [loss, i] + (calc_gradient(loss, [x]) if bounded else [])
            return [v.name for v in fetch], {"x": u(3)}
        return build

    def conditional(flag):
        def build():
            x = L.data(name="x", shape=[3], dtype="float32",
                       append_batch_size=False)
            f = L.data(name="flag", shape=[1], dtype="float32",
                       append_batch_size=False)
            out = L.fill_constant(shape=[3], dtype="float32", value=1.0)
            out.stop_gradient = False
            cb = L.ConditionalBlock([L.less_than(
                x=L.fill_constant(shape=[1], dtype="float32", value=0.5),
                y=f)])
            with cb.block():
                L.assign(L.scale(x, scale=3.0), output=out)
            loss = L.reduce_sum(out)
            return ([v.name for v in [loss] + calc_gradient(loss, [x])],
                    {"x": u(3), "flag": np.array([flag], np.float32)})
        return build

    def if_else():
        x = L.data(name="x", shape=[4], dtype="float32")
        x.stop_gradient = False
        ie = L.IfElse(L.less_than(
            x=L.slice(x, axes=[1], starts=[0], ends=[1]),
            y=L.fill_constant_batch_size_like(x, shape=[-1, 1],
                                              dtype="float32", value=0.0)))
        with ie.true_block():
            ie.output(L.fc(input=ie.input(x), size=3, act="tanh"))
        with ie.false_block():
            ie.output(L.scale(L.fc(input=ie.input(x), size=3), scale=2.0))
        out = ie()
        loss = L.reduce_sum(out)
        return ([v.name for v in [out] + calc_gradient(loss, [x])],
                {"x": u(6, 4)})

    def parallel_do():
        x = L.data(name="x", shape=[4], dtype="float32")
        x.stop_gradient = False
        pd = L.ParallelDo(L.get_places())
        with pd.do():
            pd.write_output(L.fc(input=pd.read_input(x), size=3,
                                 act="tanh"))
        out = pd()
        return ([v.name for v in [out] + calc_gradient(L.reduce_sum(out),
                                                       [x])],
                {"x": u(6, 4)})

    def arrays():
        x = L.data(name="x", shape=[3, 2], dtype="float32")
        x.stop_gradient = False
        arr = L.lod_tensor_to_array(x)
        back = L.array_to_lod_tensor(arr)
        i1 = L.fill_constant(shape=[1], dtype="int64", value=1)
        arr2 = L.array_write(L.scale(x, scale=2.0), i1)
        step = L.array_read(arr2, i1)
        n = L.array_length(arr2)
        block = fluid.default_main_program().global_block()
        m = block.create_var(name="n_lod", dtype="int32")
        block.append_op("lod_array_length", inputs={"X": [arr]},
                        outputs={"Out": [m]})
        tmp = L.scale(x, scale=5.0)
        block.append_op("delete_var", inputs={"X": [tmp]})
        loss = L.reduce_sum(L.elementwise_add(back, step))
        return ([v.name for v in [back, step, n, m, loss]
                 + calc_gradient(loss, [x])], {"x": u(4, 3, 2)})

    def printing():
        x = L.data(name="x", shape=[2], dtype="float32")
        x.stop_gradient = False
        block = fluid.default_main_program().global_block()
        y = block.create_var(name="y_probe", dtype="float32")
        block.append_op("print_grad", inputs={"In": [x]},
                        outputs={"Out": [y]})
        out = L.Print(L.scale(y, scale=3.0), message="phase 21 Print")
        return ([v.name for v in [out] + calc_gradient(L.reduce_sum(out),
                                                       [x])],
                {"x": u(2, 2)})

    def ceob():
        block = fluid.default_main_program().global_block()
        names = []
        for k, (rows, width) in enumerate(((2, 5), (4, 3))):
            s = L.data(name=f"s{k}", shape=[width], dtype="float32",
                       lod_level=1)
            s.stop_gradient = False
            names.append((s, L.data(name=f"i{k}", shape=[2], dtype="int64"),
                          L.data(name=f"g{k}", shape=[1], dtype="int64")))
        out = block.create_var(name="ceob", dtype="float32")
        block.append_op("cross_entropy_over_beam",
                        inputs={"Scores": [n[0] for n in names],
                                "Ids": [n[1] for n in names],
                                "Gold": [n[2] for n in names]},
                        outputs={"Out": [out]})
        grads = calc_gradient(L.reduce_sum(out), [n[0] for n in names])
        feed = {"s0": u(2, 5), "s0@SEQ_LEN": np.array([5, 4], np.int32),
                "s1": u(4, 3), "s1@SEQ_LEN": np.array([3, 3, 2, 3],
                                                      np.int32),
                "i0": np.array([[4, 1], [0, 2]], np.int64),
                "i1": np.array([[0, 2], [1, -1], [2, 0], [1, 1]], np.int64),
                "g0": np.array([[4], [3]], np.int64),
                "g1": np.array([[2], [0]], np.int64)}
        return [v.name for v in [out] + grads], feed

    return {"while bounded": while_loop(True),
            "while unbounded": while_loop(False),
            "conditional_block taken": conditional(1.0),
            "conditional_block skipped": conditional(0.0),
            "if_else": if_else, "parallel_do": parallel_do,
            "arrays": arrays, "print": printing,
            "cross_entropy_over_beam": ceob}


#: the one-op cases of phase 21 (phase 16's format); ragged inputs carry
#: their lengths
_S21_SEQ = _u((3, 5, 4))
_S21_LENS = {"X": [5, 2, 3]}
S21_OP_CASES = (
    [_op_case(op, {"X": _S21_SEQ}, seq_len=_S21_LENS)
     for op in ("sequence_first_step", "sequence_last_step")]
    + [_op_case("sequence_reverse", {"X": _S21_SEQ}, outs=("Y",),
                seq_len=_S21_LENS),
       _op_case("sequence_softmax", {"X": _u((3, 5))}, seq_len=_S21_LENS),
       _op_case("sequence_expand", {"X": _u((3, 1, 4)), "Y": _u((3, 5, 1))},
                nodiff=("Y",), seq_len={"Y": [5, 2, 3]}),
       _op_case("sequence_conv", {"X": _S21_SEQ, "Filter": _u((12, 6))},
                {"contextLength": 3, "contextStart": -1,
                 "contextStride": 1}, seq_len=_S21_LENS, sums=True),
       _op_case("sequence_slice", {"X": _S21_SEQ,
                                   "Offset": np.array([[1], [0], [2]],
                                                      np.int64),
                                   "Length": np.array([[3], [2], [1]],
                                                      np.int64)},
                seq_len=_S21_LENS),
       _op_case("sequence_erase", {"X": ("ids", (3, 6), 5)},
                {"tokens": [0, 3]}, seq_len=_S21_LENS, sums=None),
       _op_case("sequence_reshape", {"X": _S21_SEQ}, {"new_dim": 2},
                seq_len=_S21_LENS),
       _op_case("sequence_concat", {"X": [_S21_SEQ, _u((3, 2, 4))]},
                seq_len=_S21_LENS),
       _op_case("sequence_pad", {"X": _S21_SEQ}, outs=("Out", "Length"),
                loss=("Out",), seq_len=_S21_LENS),
       _op_case("sequence_unpad", {"X": _S21_SEQ,
                                   "Length": np.array([5, 2, 3], np.int64)}),
       _op_case("sequence_mask", {"X": _S21_SEQ}, outs=("Y",),
                seq_len=_S21_LENS, sums=None),
       _op_case("lstm_unit", {"X": _u((3, 16)), "C_prev": _u((3, 4))},
                {"forget_bias": 0.5}, outs=("C", "H")),
       _op_case("lod_reset", {"X": _u((3, 4)),
                              "Y": np.array([1, 2, 3], np.int32)},
                nodiff=("Y",)),
       _op_case("im2sequence", {"X": _u((2, 3, 5, 4))},
                {"kernels": [2, 2], "strides": [1, 2],
                 "paddings": [1, 0, 0, 1]}),
       _op_case("row_conv", {"X": _S21_SEQ, "Filter": _u((3, 4))},
                seq_len=_S21_LENS, sums=True),
       _op_case("repeat_batch", {"X": _u((3, 4))}, {"times": 3}),
       _op_case("beam_init_scores", {"Ref": _u((6, 2))}, {"beam_size": 3},
                sums=None),
       _op_case("beam_search", {"PreScores": _u((6, 1), -3, 0),
                                "Probs": ("probs", (6, 50)),
                                "PreFinished": np.array(
                                    [[0], [1], [0], [0], [0], [1]],
                                    np.float32)},
                {"beam_size": 3, "end_id": 1},
                ("SelectedIds", "SelectedScores", "ParentIdx", "Finished"),
                sums=None),
       _op_case("beam_search_decode",
                {"Ids": ("ids", (6, 7, 1), 50),
                 "Parents": np.array([[0, 1, 0, 2, 1, 0, 0]] * 3
                                     + [[3, 4, 5, 3, 4, 5, 3]] * 3,
                                     np.int32),
                 "Scores": _u((6, 1))},
                {"beam_size": 3, "num_results": 2},
                ("SentenceIds", "SentenceScores"), sums=None),
       _op_case("lod_rank_table", {"X": _S21_SEQ}, seq_len=_S21_LENS,
                sums=None),
       _op_case("max_sequence_len",
                {"RankTable": np.array([0, 2, 1], np.int32)},
                outs=("Out",), seq_len={"RankTable": [5, 2, 3]}, sums=None),
       _op_case("reorder_lod_tensor_by_rank",
                {"X": _u((3, 4)), "RankTable": np.array([2, 0, 1],
                                                        np.int32)}),
       _op_case("shrink_rnn_memory",
                {"X": _u((3, 4)), "I": np.array([2], np.int64),
                 "RankTable": np.array([0, 2, 1], np.int32)},
                nodiff=("RankTable",), seq_len={"RankTable": [5, 2, 3]}),
       _op_case("rnn_memory_helper", {"X": _u((3, 4))}),
       _op_case("split_lod_tensor", {"X": _u((4, 2)),
                                     "Mask": np.array([[True], [False],
                                                       [True], [False]])},
                outs=("OutTrue", "OutFalse")),
       _op_case("merge_lod_tensor", {"InTrue": _u((4, 2)),
                                     "InFalse": _u((4, 2)),
                                     "Mask": np.array([[True], [False],
                                                       [True], [False]])}),
       _op_case("linear_chain_crf",
                {"Emission": _u((3, 5, 4)), "Transition": _u((6, 4)),
                 "Label": ("ids", (3, 5), 4)},
                outs=("Alpha", "EmissionExps", "TransitionExps",
                      "LogLikelihood"), loss=("LogLikelihood",),
                seq_len={"Emission": [5, 2, 3]}, sums=True),
       _op_case("crf_decoding",
                {"Emission": _u((3, 5, 4)), "Transition": _u((6, 4))},
                outs=("ViterbiPath",), seq_len={"Emission": [5, 2, 3]},
                sums=None),
       _op_case("edit_distance",
                {"Hyps": ("ids", (3, 6), 4), "Refs": ("ids", (3, 5), 4)},
                {"normalized": True}, ("Out", "SequenceNum"),
                seq_len={"Hyps": [6, 3, 1], "Refs": [5, 5, 2]}, sums=None),
       _op_case("chunk_eval",
                {"Inference": ("ids", (3, 6), 5),
                 "Label": ("ids", (3, 6), 5)},
                {"num_chunk_types": 2, "chunk_scheme": "IOB"},
                ("Precision", "Recall", "F1-Score", "NumInferChunks",
                 "NumLabelChunks", "NumCorrectChunks"),
                seq_len={"Inference": [6, 4, 5]}, sums=None),
       _op_case("warpctc", {"Logits": _u((3, 8, 5)),
                            "Label": ("ids", (3, 3), 4)},
                {"blank": 0, "norm_by_times": False},
                ("Loss", "WarpCTCGrad"), loss=("Loss",),
                seq_len={"Logits": [8, 6, 7], "Label": [3, 2, 3]},
                sums=True),
       _op_case("ctc_align", {"Input": ("ids", (3, 8), 4)}, {"blank": 0},
                ("Output",), seq_len={"Input": [8, 5, 2]}, sums=None),
       _op_case("hsigmoid", {"X": _u((4, 5)), "W": _u((8, 5)),
                             "Bias": _u((8, 1)),
                             "Label": ("ids", (4, 1), 9)},
                {"num_classes": 9}, sums=True)])


def new_rules_card_vs_cpu(seed=0):
    """Phase 21: every rule this slice registers, on the card against the
    CPU as phase 16 holds its rules: S21_OP_CASES as one-op programs
    (outputs and the input @GRADs of a weighted-sum loss), the control
    flow, arrays, printing and cross_entropy_over_beam as programs of the
    port's layers (outputs and calc_gradient's @GRADs; parameters from
    one CPU startup), nce by the JAX formula on the samples the card
    drew.  Fails if a rule of S21_RULES ran in none of them."""
    import paddle_tpu_torch as fluid
    shares, rules = {}, set()
    _op_cases_card_vs_cpu(S21_OP_CASES, seed, shares, rules)
    for name, build in _s21_programs().items():
        fluid.core.program.reset_default_programs()
        fetch, feed = build()
        main = fluid.default_main_program()
        state = _program_state(fluid.default_startup_program())
        cpu, card = (_state_run(place, main, state, feed, fetch)
                     for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)))
        shares[name] = max(_hold(f"{name} {f}", g, w, SUM_TOL)
                           for f, g, w in zip(fetch, card, cpu))
        rules.update(op.type for b in main.blocks for op in b.ops)
    rules.update(_seq_text_printer_card_vs_cpu())
    rules.update(_nce_on_card())
    missing = sorted(S21_RULES - rules)
    if missing:
        raise AssertionError(f"rules phase 21 did not run: {missing}")
    worst = sorted(shares.items(), key=lambda kv: -kv[1])[:5]
    print(f"  {len(shares)} programs over {len(rules & S21_RULES)} of the "
          f"slice's {len(S21_RULES)} rules held; largest shares of the "
          f"tolerance: {worst}", flush=True)
    return {"cases": len(shares) + 2, "rules": len(rules & S21_RULES),
            "largest_share": worst[0][1]}


def _seq_text_printer_card_vs_cpu():
    """seq_text_printer on the card and on the CPU writes the same text."""
    import tempfile
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers as L
    texts = []
    with tempfile.TemporaryDirectory() as tmp:
        vocab = os.path.join(tmp, "dict.txt")
        with open(vocab, "w") as f:
            f.write("\n".join(f"w{i}" for i in range(10)) + "\n")
        for k, place in enumerate((fluid.CPUPlace(), fluid.CUDAPlace(0))):
            fluid.core.program.reset_default_programs()
            ids = L.data(name="ids", shape=[1], dtype="int64", lod_level=1)
            block = fluid.default_main_program().global_block()
            tok = block.create_var(name="tok", dtype="int32")
            result = os.path.join(tmp, f"out{k}.txt")
            block.append_op("seq_text_printer", inputs={"Ids": [ids]},
                            outputs={"Out": [tok]},
                            attrs={"dict_file": vocab,
                                   "result_file": result})
            fluid.Executor(place).run(
                fluid.default_main_program(),
                feed={"ids": np.array([[2, 3, 9], [4, 2, 0]], np.int64),
                      "ids@SEQ_LEN": np.array([3, 2], np.int32)},
                fetch_list=[tok], scope=fluid.core.scope.Scope())
            with open(result) as f:
                texts.append(f.read())
    if texts[0] != texts[1] or texts[0] != "0\tw2 w3 w9\n1\tw4 w2\n":
        raise AssertionError(f"seq_text_printer wrote {texts}")
    return {"seq_text_printer"}


def _nce_on_card():
    """nce draws its negatives from the card's generator: its cost must be
    the JAX formula on the samples it drew (read back through
    SampleLabels), and the samples lie in [0, classes)."""
    import paddle_tpu_torch as fluid
    c, k, b, d = 50, 8, 64, 16
    rng = np.random.default_rng(22)
    feed = {"x": rng.standard_normal((b, d)).astype(np.float32),
            "label": rng.integers(0, c, (b, 1)),
            "w": rng.standard_normal((c, d)).astype(np.float32),
            "b": rng.standard_normal((c, 1)).astype(np.float32)}
    prog = fluid.Program()
    block = prog.global_block()
    for name, arr in feed.items():
        block.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype),
                         is_data=True)
    for name in ("cost", "samples"):
        block.create_var(name=name)
    block.append_op("nce", inputs={"Input": ["x"], "Label": ["label"],
                                   "Weight": ["w"], "Bias": ["b"]},
                    outputs={"Cost": ["cost"], "SampleLabels": ["samples"]},
                    attrs={"num_total_classes": c, "num_neg_samples": k})
    cost, neg = _run_on(fluid.CUDAPlace(0), prog, feed, ["cost", "samples"])

    def logit(ids):
        x = feed["x"].astype(np.float64)
        return ((feed["w"][ids] * (x[:, None] if ids.ndim == 2 else x))
                .sum(-1) + feed["b"][:, 0][ids])
    log_q = math.log(k / c)
    want = (np.logaddexp(0, -(logit(feed["label"][:, 0]) - log_q))
            + np.logaddexp(0, logit(neg) - log_q).sum(1))
    share = _hold("nce on the card", cost[:, 0], want.astype(np.float32),
                  SUM_TOL)
    if neg.min() < 0 or neg.max() >= c:
        raise AssertionError("nce samples outside [0, classes)")
    print(f"  nce on the card: the JAX formula on its {neg.size} samples, "
          f"{share:.4f} of the tolerance", flush=True)
    return {"nce"}


#: the rules this slice registers (phase 21 holds them; phase 16 leaves
#: them here)
S21_RULES = frozenset((
    "sequence_first_step", "sequence_last_step", "sequence_softmax",
    "sequence_expand", "sequence_conv", "sequence_slice", "sequence_erase",
    "sequence_reshape", "sequence_concat", "sequence_pad",
    "sequence_unpad", "lstm_unit", "sequence_mask", "sequence_reverse",
    "lod_reset", "im2sequence", "row_conv", "beam_search",
    "beam_search_decode", "repeat_batch", "beam_init_scores",
    "cross_entropy_over_beam", "lod_rank_table", "max_sequence_len",
    "reorder_lod_tensor_by_rank", "lod_tensor_to_array",
    "array_to_lod_tensor", "shrink_rnn_memory", "rnn_memory_helper",
    "split_lod_tensor", "merge_lod_tensor", "lod_array_length",
    "delete_var", "write_to_array", "read_from_array", "array_length",
    "print", "print_grad", "seq_text_printer", "while", "conditional_block",
    "if_else", "parallel_do", "linear_chain_crf", "crf_decoding",
    "edit_distance", "chunk_eval", "warpctc", "ctc_align", "nce",
    "hsigmoid"))


# ---------------------------------------------------------------------------
# phase 22: the generation Programs through DecodeEngine(scope, spec)
# ---------------------------------------------------------------------------

#: fast decode through the Programs in bf16: GP_REQUESTS requests with
#: prompts of GP_PROMPT tokens and GP_NEW new tokens each on GP_SLOTS
#: slots (phase 4's traffic), also through the TransformerLM engine;
#: exact decode in f32: phase 13's slots, span, prompts and new tokens
GP_SLOTS, GP_REQUESTS, GP_NEW, GP_PROMPT = 16, 32, 64, (8, 1024)
#: the kernels each Program engine must launch
GP_KERNELS = {"fast": ("paged_attention", "flash_attention_fwd",
                       "layer_norm_fwd"),
              "exact": ("flash_attention_fwd", "layer_norm_fwd",
                        "row_stable_mm")}


def _save_generation_scope(model_dir, seed):
    """FULL_WIDTH's seeded random weights saved by the port's
    save_generation_model, then loaded into a Scope through the port's
    io -> (spec, scope)."""
    import shutil
    from paddle_tpu_torch import io as pio
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.models import transformer as PT
    spec = PT.generation_spec(**FULL_WIDTH)
    src = Scope()
    for name, arr in PT.random_params(spec, seed).items():
        src.set(name, arr)
    shutil.rmtree(model_dir, ignore_errors=True)
    PT.save_generation_model(model_dir, **FULL_WIDTH, scope=src, init=False)
    scope = Scope()
    with scope_guard(scope):
        pio.load_inference_model(model_dir, None)
    return spec, scope


def _drive_engine(engine, prompts, max_new, sync, capture=False):
    """Every prompt submitted at once; each decode step's (tokens, pages,
    index) recorded for the profile.  Launch counts are zeroed just before
    and read just after -> (results, stats, wall s, launches, row-stable
    launches by tile code, steps)."""
    from paddle_tpu_torch.ops import kernels as K
    steps = []
    decode = engine.model.decode
    engine.model.decode = lambda *a, **k: (
        steps.append((a[0], a[2], a[3])), decode(*a, **k))[1]
    try:
        sync()
        K.reset_launches()
        t0 = time.perf_counter()
        results = [h.result(timeout=900) for h in [
            engine.submit(p, max_new, capture_logits=capture)
            for p in prompts]]
        sync()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in K.KERNELS}
        paths = dict(K.ROW_STABLE_MM.path_launches)
        stats = engine.stats()
    finally:
        engine.close()
        del engine.model.decode
    for r in results:
        if len(r["tokens"]) != max_new or r["finish_reason"] != "length":
            raise AssertionError(f"stream ended early: {r['finish_reason']}"
                                 f" after {len(r['tokens'])} tokens")
    return results, stats, wall, launches, paths, steps


def _parted_on_near_tie(model, prompt, tokens, step, token):
    """The TransformerLM's full recompute of ``prompt + tokens[:step]``:
    ``token`` within E2E_TOL of its top logit (phase 4's rule)?"""
    import torch
    seq = list(prompt) + list(tokens[:step])
    with torch.inference_mode():
        row = model(torch.tensor([seq], device=model.device),
                    torch.tensor([len(seq) - 1], device=model.device))
    row = row[0].float().cpu().numpy()
    tol = E2E_TOL * max(1.0, float(np.abs(row).max()))
    return float(row.max() - row[token]) <= tol


def _fast_programs(model_dir, spec, scope, seed, device, sync):
    """Phase 22's bf16 run: the Program engine and the TransformerLM
    engine on the same prompts, streams held by phase 4's rule, each
    decode step profiled with every slot active."""
    from paddle_tpu_torch.serving.decode_engine import DecodeEngine
    rng = np.random.default_rng(seed + 22)
    prompts = [rng.integers(0, spec["vocab"], n).tolist()
               for n in rng.integers(GP_PROMPT[0], GP_PROMPT[1] + 1,
                                     GP_REQUESTS)]
    runs = {}
    for name, make in (
            ("programs", lambda: DecodeEngine(
                scope, spec, slots=GP_SLOTS, block_len=DM_BLOCK_LEN,
                precision="bf16", device=device, warmup=True)),
            ("module", lambda: DecodeEngine.from_model_dir(
                model_dir, precision="bf16", slots=GP_SLOTS,
                block_len=DM_BLOCK_LEN, device=device, warmup=True))):
        t0 = time.perf_counter()
        engine = make()
        sync()
        load_s = time.perf_counter() - t0
        results, stats, wall, launches, _, steps = _drive_engine(
            engine, prompts, GP_NEW, sync)
        n_tok = sum(len(r["tokens"]) for r in results)
        print(f"  {name} engine (bf16, loaded and warm in {load_s:.1f} s):"
              f" {GP_REQUESTS} requests, {n_tok} tokens in {wall:.3f} s: "
              f"{n_tok / wall:.1f} tokens/s; TTFT ms {stats['ttft_ms']}; "
              f"step ms {stats['step_ms']}; prefills {stats['prefills']}, "
              f"decode steps {stats['iterations']}; launches {launches}",
              flush=True)
        profile = profile_decode_step(engine, steps)
        runs[name] = dict(results=results, launches=launches,
                          model=engine.model, e2e={
                              "tokens_per_s": n_tok / wall,
                              "ttft_ms": stats["ttft_ms"],
                              "step_ms": stats["step_ms"],
                              "decode_step_profile": profile})
    for k in GP_KERNELS["fast"]:
        if runs["programs"]["launches"][k] <= 0:
            raise AssertionError(f"the Program engine never launched {k}")
    parted = 0
    module = runs["module"]
    for i, (r, want) in enumerate(zip(runs["programs"]["results"],
                                      module["results"])):
        step = next((j for j, (a, b) in enumerate(zip(r["tokens"],
                                                      want["tokens"]))
                     if a != b), None)
        if step is None:
            continue
        if not _parted_on_near_tie(module["model"], prompts[i],
                                   want["tokens"], step, r["tokens"][step]):
            raise AssertionError(f"stream {i} token {step}: the Program "
                                 "engine's token differs from the "
                                 "TransformerLM engine's without a near "
                                 "tie")
        parted += 1
    print(f"  {GP_REQUESTS - parted} of {GP_REQUESTS} streams equal to the "
          f"TransformerLM engine's, {parted} parted on a near tie",
          flush=True)
    return runs["programs"]["launches"], {
        "programs": runs["programs"]["e2e"], "module": module["e2e"],
        "streams_parted_on_near_tie": parted}


def _exact_programs(model_dir, spec, scope, seed, device, sync):
    """Phase 22's exact run: every token's logits bitwise the exact
    full-recompute program's row, the row-stable product through the
    small-M code in decode and the 128 x 128 code in the recompute; the
    TransformerLM exact engine's logits compared and printed."""
    from paddle_tpu_torch.serving.decode_engine import (
        DecodeEngine, _load_full_predictor, greedy_decode_full)
    from paddle_tpu_torch.ops import kernels as K
    rng = np.random.default_rng(seed + 13)
    prompts = [rng.integers(0, spec["vocab"], n).tolist()
               for n in DM_EXACT_PROMPTS]
    engine = DecodeEngine(scope, spec, slots=DM_SLOTS,
                          block_len=DM_BLOCK_LEN, numerics="exact",
                          precision="f32", device=device, warmup=True)
    results, stats, wall, launches, paths, steps = _drive_engine(
        engine, prompts, DM_EXACT_NEW, sync, capture=True)
    print(f"  exact programs: {len(prompts)} streams of {DM_EXACT_NEW} "
          f"tokens in {wall:.3f} s; step ms {stats['step_ms']}, prefills "
          f"{stats['prefills']}; launches {launches}", flush=True)
    for k in GP_KERNELS["exact"]:
        if launches[k] <= 0:
            raise AssertionError(f"the exact Program engine never launched "
                                 f"{k}")
    # every fc of the programs is a mul: QKV, FFN1 and FFN2 a layer and the
    # head; a decode step's at M = DM_SLOTS, a prefill's at M = max_len
    per_step = 3 * spec["n_layers"] + 1
    counted = "row_stable_mm" in GP_KERNELS["exact"]
    want_paths = {"small": per_step * len(steps),
                  "large": per_step * stats["prefills"]}
    if counted and paths != want_paths:
        raise AssertionError(f"exact programs: row_stable_mm codes {paths}, "
                             f"want {want_paths}")
    pred = _load_full_predictor(model_dir, spec, True, device=device)
    K.reset_launches()
    t0 = time.perf_counter()
    full = greedy_decode_full(model_dir, prompts, DM_EXACT_NEW,
                              capture_logits=True, predictor=pred)
    sync()
    full_s = time.perf_counter() - t0
    recompute = dict(K.ROW_STABLE_MM.path_launches)
    if counted and recompute != {"small": 0,
                                 "large": per_step * full["dispatches"]}:
        raise AssertionError(f"exact recompute program: row_stable_mm codes "
                             f"{recompute}")
    compared = 0
    for i, r in enumerate(results):
        if r["tokens"] != full["tokens"][i]:
            raise AssertionError(f"exact stream {i}: tokens differ from the "
                                 "exact full-recompute program")
        for step, a in enumerate(r["logits"]):
            b = full["logits"][step][i]
            if not np.array_equal(a, b):
                raise AssertionError(
                    f"exact stream {i} (prompt {len(prompts[i])}) token "
                    f"{step}: logits differ from the full-recompute program "
                    f"by up to {float(np.abs(a - b).max()):.3e}")
            compared += 1
    print(f"  exact: {compared} tokens of {len(prompts)} streams (prompts "
          f"{list(DM_EXACT_PROMPTS)}) bitwise the exact full-recompute "
          f"program ({full['dispatches']} runs at [{len(prompts)}, "
          f"{spec['max_len']}] in {full_s:.2f} s); row_stable_mm by tile "
          f"code: decode and prefills {paths}, recompute {recompute}",
          flush=True)
    module = DecodeEngine.from_model_dir(
        model_dir, numerics="exact", slots=DM_SLOTS, block_len=DM_BLOCK_LEN,
        device=device, warmup=True)
    mod_results = _drive_engine(module, prompts, DM_EXACT_NEW, sync,
                                capture=True)[0]
    diff = max(float(np.abs(a - b).max())
               for r, m in zip(results, mod_results)
               for a, b in zip(r["logits"], m["logits"]))
    print(f"  exact: the TransformerLM exact engine's logits "
          f"{'bitwise equal' if diff == 0 else 'differ'} (largest "
          f"difference {diff:.3e})", flush=True)
    return launches, {"wall_s": wall, "step_ms": stats["step_ms"],
                      "tokens_bitwise": compared,
                      "row_stable_paths": {"engine": paths,
                                           "recompute": recompute},
                      "full_recompute_s": full_s,
                      "module_exact_max_abs_diff": diff}


def generation_programs(seed=0, device="cuda"):
    """Phase 22: the generation Programs at FULL_WIDTH through
    DecodeEngine(scope, spec) on the port's interpreter, fast in bf16 and
    exact in f32.  Returns (launches summed over the two Program engine
    runs, results)."""
    import torch
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    model_dir = os.path.join(HERE, "build", "genprog", "lm")
    t0 = time.perf_counter()
    spec, scope = _save_generation_scope(model_dir, seed)
    print(f"  full-width LM saved by save_generation_model and loaded into "
          f"a Scope: {time.perf_counter() - t0:.1f} s", flush=True)
    fast_launches, fast = _fast_programs(model_dir, spec, scope, seed,
                                         device, sync)
    exact_launches, exact = _exact_programs(model_dir, spec, scope, seed,
                                            device, sync)
    launches = {k: fast_launches[k] + exact_launches[k]
                for k in fast_launches}
    return launches, {"fast_bf16": fast, "exact_f32": exact,
                      "launches_fast": {k: fast_launches[k]
                                        for k in GP_KERNELS["fast"]},
                      "launches_exact": {k: exact_launches[k]
                                         for k in GP_KERNELS["exact"]}}


# ---------------------------------------------------------------------------
# phase 23: the misc rules on the card against the CPU
# ---------------------------------------------------------------------------

def _ties(shape, seed):
    """Values from {0, 1, 2} (most windows hold tied maxima) with one
    plane of -inf."""
    a = np.random.RandomState(seed).randint(0, 3, shape).astype(np.float32)
    a[0, 0] = -np.inf
    return a


#: phase 23's one-op programs: SPECS' shapes, and inputs with ties for
#: the _with_index masks and roi_pool's rounding
S23_OP_CASES = (
    [_op_case("minus", {"X": _u((2, 3)), "Y": _u((2, 3))}),
     _op_case("l1_norm", {"X": _away((2, 3))}, sums=True),
     _op_case("label_smooth", {"X": _u((2, 4), 0.0, 1.0)},
              {"epsilon": 0.1}),
     _op_case("modified_huber_loss",
              {"X": _u((3, 1), -0.8, 0.8),
               "Y": np.array([[1.], [0.], [1.]], np.float32)},
              nodiff=("Y",), outs=("Out", "IntermediateVal"),
              loss=("Out",)),
     _op_case("multiplex", {"Ids": np.array([[0], [1], [1]], np.int32),
                            "X": [_u((3, 4)), _u((3, 4))]}),
     _op_case("crop", {"X": _u((3, 4)), "Y": np.zeros((2, 2), np.float32)},
              {"offsets": [1, 1]}, nodiff=("Y",)),
     _op_case("fill", {}, {"value": [1, -2, 3, 4, 5, 6], "shape": [2, 3],
                           "dtype": "int32"}, sums=None),
     _op_case("conv_shift", {"X": _u((2, 5)), "Y": _u((2, 3), -0.5, 0.5)},
              sums=True),
     _op_case("bilinear_tensor_product",
              {"X": _u((2, 3)), "Y": _u((2, 4)),
               "Weight": _u((5, 3, 4), -0.5, 0.5),
               "Bias": _u((1, 5), -0.5, 0.5)}, sums=True),
     _op_case("bilinear_interp", {"X": _u((2, 2, 3, 3))},
              {"out_h": 6, "out_w": 5}),
     _op_case("bilinear_interp", {"X": _u((2, 2, 3, 3))},
              {"out_h": 1, "out_w": 4}),
     _op_case("max_pool2d_with_index", {"X": _ties((2, 3, 7, 6), 23)},
              {"ksize": [3, 3], "strides": [2, 1], "paddings": [1, 1]},
              outs=("Out", "Mask"), sums=None),
     _op_case("max_pool3d_with_index", {"X": _ties((1, 2, 4, 5, 6), 24)},
              {"ksize": [2, 3, 2], "strides": [2, 1, 2],
               "paddings": [1, 1, 0]}, outs=("Out", "Mask"), sums=None),
     _op_case("unpool", {"X": _u((1, 2, 2, 2), 0.5, 1.5),
                         "Indices": np.array([[[[0, 3], [12, 15]],
                                               [[0, 3], [12, 15]]]],
                                             np.int32)},
              {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]})]
    + [_op_case("spp", {"X": _u((1, 2, 5, 6))},
                {"pyramid_height": 3, "pooling_type": t}, sums=True)
       for t in ("max", "avg")]
    + [_op_case("roi_pool",
                {"X": _u((2, 2, 8, 8)),
                 "ROIs": np.array([[1., 3., 5., 9.], [3., 1., 7., 5.],
                                   [8., 8., 16., 16.], [0., 0., 1., 1.]],
                                  np.float32),
                 **({"RoisBatchId": np.array([0, 1, 1, 0], np.int32)}
                    if bid else {})},
                {"pooled_height": 3, "pooled_width": 2,
                 "spatial_scale": 0.5}, nodiff=("ROIs",))
       for bid in (True, False)]
    + [_op_case("gru_unit", {"Input": _u((2, 12), -0.5, 0.5),
                             "HiddenPrev": _u((2, 4), -0.5, 0.5),
                             "Weight": _u((4, 12), -0.3, 0.3),
                             "Bias": _u((1, 12), -0.2, 0.2)},
                {"activation": 3, "gate_activation": "sigmoid"},
                outs=("Gate", "ResetHiddenPrev", "Hidden"),
                loss=("Hidden",), sums=True),
       _op_case("lstmp", {"Input": _u((3, 5, 16), -0.5, 0.5),
                          "Weight": _u((3, 16), -0.3, 0.3),
                          "ProjWeight": _u((4, 3), -0.3, 0.3),
                          "Bias": _u((1, 28), -0.2, 0.2)},
                {"use_peepholes": True, "is_reverse": True},
                outs=("Projection", "Cell"), loss=("Projection",),
                seq_len={"Input": [5, 2, 4]}, sums=True),
       _op_case("positive_negative_pair",
                {"Score": np.array([[.9], [.1], [.3], [.7], [.7], [.3],
                                    [.5], [.5]], np.float32),
                 "Label": np.array([[2.], [1.], [3.], [1.], [2.], [1.],
                                    [0.], [2.]], np.float32),
                 "QueryID": np.array([[0], [0], [1], [1], [1], [1], [2],
                                      [2]], np.int32),
                 "Weight": _u((8, 1), 0.5, 2.0)},
                outs=("PositivePair", "NegativePair", "NeutralPair"),
                sums=None),
       _op_case("scale_sub_region",
                {"X": _u((2, 2, 3, 3)),
                 "Indices": np.array([[1, 1, 1, 2, 1, 3], [2, 2, 2, 3, 2, 3]],
                                     np.int32)},
                {"value": 2.0}, nodiff=("Indices",))])
#: the rules phase 23 holds (ops/misc_ops.py but sharding_constraint)
S23_RULES = frozenset(c["op"] for c in S23_OP_CASES)
#: the rules phase 22 runs through the generation Programs
S22_RULES = frozenset(("kv_cache_write", "paged_attention",
                       "pos_encoding_add", "batched_select"))


def _op_cases_card_vs_cpu(cases, seed, shares, rules):
    """Each case as a one-op program on the card and on the CPU (phase
    16's rule): outputs and the input @GRADs of a weighted-sum loss, to
    F32_TOL, or SUM_TOL for a case that sums, integer and bool outputs
    exactly, and every output of a case marked ``exact`` bitwise; the
    shares of the tolerance go into ``shares``, the ops into
    ``rules``."""
    import zlib
    import paddle_tpu_torch as fluid
    for n, case in enumerate(cases):
        op = case["op"]
        rng = np.random.default_rng(seed + zlib.crc32(f"{op}{n}".encode()))
        arrays = {slot: [_case_array(s, rng) for s in
                         (spec if isinstance(spec, list) else [spec])]
                  for slot, spec in case["inputs"].items()}
        prog, feed, outs, _ = _one_op_program(case, arrays)
        cpu = _run_on(fluid.CPUPlace(), prog, feed, outs)
        loss_slots = [f"o_{s.lower()}_"
                      for s in (case["loss"] or case["outs"])]
        floats = {o: a.shape for o, a in zip(outs, cpu)
                  if a.dtype.kind == "f"
                  and any(o.startswith(s) for s in loss_slots)}
        grads = []
        if case["sums"] is not None and floats:
            prog, feed, outs, grads = _one_op_program(case, arrays, floats)
        fetch = outs + grads
        want = _run_on(fluid.CPUPlace(), prog, feed, fetch)
        got = _run_on(fluid.CUDAPlace(0), prog, feed, fetch)
        tol = SUM_TOL if case["sums"] else F32_TOL
        shares[f"{op} #{n}"] = max(
            [_hold(f"{op} #{n} {name}", g, w, tol)
             for name, g, w in zip(fetch, got, want)], default=0.0)
        if case.get("exact"):
            for name, g, w in zip(fetch, got, want):
                if np.asarray(g).tobytes() != np.asarray(w).tobytes():
                    raise AssertionError(f"{op} #{n} {name}: not bitwise "
                                         "the CPU's")
        rules.add(op)


def _rules_card_vs_cpu(phase, cases, expected, seed):
    """A phase of one-op programs on the card against the CPU
    (`_op_cases_card_vs_cpu`); fails if a rule of ``expected`` ran in none
    of ``cases``."""
    shares, rules = {}, set()
    _op_cases_card_vs_cpu(cases, seed, shares, rules)
    missing = sorted(expected - rules)
    if missing:
        raise AssertionError(f"rules phase {phase} did not run: {missing}")
    worst = sorted(shares.items(), key=lambda kv: -kv[1])[:5]
    print(f"  {len(shares)} one-op programs over {len(rules)} rules held; "
          f"largest shares of the tolerance: {worst}", flush=True)
    return {"cases": len(shares), "rules": len(rules),
            "largest_share": worst[0][1]}


def misc_rules_card_vs_cpu(seed=0):
    """Phase 23: the misc rules (S23_OP_CASES) on the card against the
    CPU; ties in the _with_index rules must give equal masks."""
    return _rules_card_vs_cpu(23, S23_OP_CASES, S23_RULES, seed)


# ---------------------------------------------------------------------------
# phase 24: MobileNet-SSD trained through the reader ops, then inference
# ---------------------------------------------------------------------------

#: MobileNet-SSD for PASCAL VOC as the PaddlePaddle models repository's
#: Fluid object-detection example (fluid/object_detection/mobilenet_ssd.py,
#: early 2018) builds it: 300x300 RGB, 21 classes, the MobileNet-v1 body
#: (conv_bn and depthwise-separable blocks, 512 channels five times at
#: 19x19, 1024 at 10x10), four extra blocks down to 5x5, 3x3, 2x2 and
#: 1x1, and multi_box_head over the six maps (2278 priors); Momentum
SSD_CONFIG = dict(image_shape=(3, 300, 300), class_num=21, base_size=300,
                  min_ratio=20, max_ratio=90,
                  aspect_ratios=[[2.0]] + [[2.0, 3.0]] * 5, lr=1e-3)
SSD_PRIORS = 2278
#: ground-truth boxes an image: 1-8 real ones, padded to SSD_G with zero
#: boxes labelled 0 (IoU 0: they never match)
SSD_G = 8
SSD_BATCH, SSD_STEPS = 32, 20
#: seeded samples written once; open_recordio_file reads the file
#: SSD_BATCH * SSD_STEPS / SSD_SAMPLES times in one pass of the reader
SSD_SAMPLES = 64
#: kernel launches a step: one softmax cross-entropy forward and backward
#: per image's ssd_loss, one BatchNorm backward per conv_bn (27 in the
#: body, 8 in the extra blocks)
SSD_LAUNCHES_PER_STEP = dict(
    {name: 0 for name in TRAIN_LAUNCHES_PER_STEP}, softmax_xent_fwd=SSD_BATCH,
    softmax_xent_bwd=SSD_BATCH, batch_norm_bwd=35)
#: phase 24's f32 step at full width on the card, the CPU and in f64
#: (`ssd_card_vs_cpu`)
SSD_CPU_BATCH = 2
SSD_INFER_ITERS = 5


def _ssd_layers(L, image, gt_box, gt_label, batch):
    """MobileNet-SSD (SSD_CONFIG) on ``image`` in the current programs,
    with one ssd_loss per image over layers.split slices summed by
    layers.sums and scaled by 1/batch -> (loss, loc [B, M, 4], scores
    [B, C, M], prior [M, 4], prior variances [M, 4], detection_output
    rows, detection_map)."""
    cfg = SSD_CONFIG
    C = cfg["class_num"]

    def conv_bn(x, c, k, s, p, groups=1):
        return L.batch_norm(L.conv2d(x, c, k, s, p, groups=groups,
                                     bias_attr=False), act="relu")

    def dw_sep(x, c_in, c_out, s):
        return conv_bn(conv_bn(x, c_in, 3, s, 1, groups=c_in), c_out, 1, 1,
                       0)

    def extra(x, c1, c2):
        return conv_bn(conv_bn(x, c1, 1, 1, 0), c2, 3, 2, 1)

    x = conv_bn(L.scale(image, scale=1.0 / 255), 32, 3, 2, 1)   # 150
    for c_in, c_out, s in ((32, 64, 1), (64, 128, 2), (128, 128, 1),
                           (128, 256, 2), (256, 256, 1), (256, 512, 2),
                           *[(512, 512, 1)] * 5):
        x = dw_sep(x, c_in, c_out, s)                          # 19
    m10 = dw_sep(dw_sep(x, 512, 1024, 2), 1024, 1024, 1)
    m5 = extra(m10, 256, 512)
    m3 = extra(m5, 128, 256)
    m2 = extra(m3, 128, 256)
    m1 = extra(m2, 64, 128)
    locs, confs, boxes, vars_ = L.multi_box_head(
        [x, m10, m5, m3, m2, m1], image, base_size=cfg["base_size"],
        num_classes=C, aspect_ratios=cfg["aspect_ratios"],
        min_ratio=cfg["min_ratio"], max_ratio=cfg["max_ratio"], flip=True,
        clip=True, offset=0.5)

    def flat(t, last):
        return L.reshape(L.transpose(t, [0, 2, 3, 1]), [0, -1, last])

    loc = L.concat([flat(t, 4) for t in locs], axis=1)
    conf = L.concat([flat(t, C) for t in confs], axis=1)
    prior = L.concat([L.reshape(b, [-1, 4]) for b in boxes], axis=0)
    pvar = L.concat([L.reshape(v, [-1, 4]) for v in vars_], axis=0)
    losses = [L.ssd_loss(L.reshape(lo, [-1, 4]), co,
                         L.reshape(gb, [-1, 4]), L.reshape(gl, [-1, 1]),
                         prior, pvar)
              for lo, co, gb, gl in zip(L.split(loc, batch, dim=0),
                                        L.split(conf, batch, dim=0),
                                        L.split(gt_box, batch, dim=0),
                                        L.split(gt_label, batch, dim=0))]
    loss = L.scale(L.sums(losses), scale=1.0 / batch)
    scores = L.transpose(L.softmax(conf), [0, 2, 1])
    nmsed = L.detection_output(loc, scores, prior, pvar)
    mean_ap = L.detection_map(nmsed, gt_box, L.reshape(gt_label,
                                                       [-1, SSD_G]))
    return loss, loc, scores, prior, pvar, nmsed, mean_ap


def _ssd_program(seed, batch, reader=None):
    """MobileNet-SSD in fresh default programs, fed by data vars or (with
    ``reader``) by the reader's read_file vars, with Momentum; the
    inference ops sit before the optimizer and run in the for_test
    clone.  Returns (main, startup, the `_ssd_layers` outputs)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers as L
    fluid.core.program.reset_default_programs()
    if reader is None:
        image = L.data(name="image", shape=list(SSD_CONFIG["image_shape"]))
        gt_box = L.data(name="gt_box", shape=[SSD_G, 4])
        gt_label = L.data(name="gt_label", shape=[SSD_G, 1], dtype="int64")
    else:
        image, gt_box, gt_label = L.read_file(reader)
    outs = _ssd_layers(L, image, gt_box, gt_label, batch)
    fluid.optimizer.Momentum(learning_rate=SSD_CONFIG["lr"],
                             momentum=0.9).minimize(outs[0])
    startup = fluid.default_startup_program()
    startup.random_seed = seed
    return fluid.default_main_program(), startup, outs


def _ssd_samples(n, seed):
    """``n`` seeded samples: a uint8 3x300x300 image, 1-8 boxes (labels
    1-20) padded to SSD_G rows of zeros labelled 0."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, SSD_G + 1))
        xy = rng.uniform(0.0, 0.7, (k, 2))
        wh = rng.uniform(0.05, 0.3, (k, 2))
        box = np.zeros((SSD_G, 4), np.float32)
        box[:k] = np.clip(np.concatenate([xy, xy + wh], 1), 0.0, 1.0)
        label = np.zeros((SSD_G, 1), np.int64)
        label[:k, 0] = rng.integers(1, SSD_CONFIG["class_num"], k)
        out.append((rng.integers(0, 256, SSD_CONFIG["image_shape"],
                                 dtype=np.uint8), box, label))
    return out


def _ssd_reader(path):
    """The pipeline phase 24 trains through: open_recordio_file ->
    shuffle -> batch -> double_buffer(CUDAPlace(0))."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers as L
    r = L.open_recordio_file(
        path, shapes=[[-1, *SSD_CONFIG["image_shape"]], [-1, SSD_G, 4],
                      [-1, SSD_G, 1]],
        dtypes=["float32", "float32", "int64"],
        pass_num=SSD_BATCH * SSD_STEPS // SSD_SAMPLES)
    r = L.shuffle(r, buffer_size=SSD_SAMPLES)
    r = L.batch(r, batch_size=SSD_BATCH)
    return L.double_buffer(r, place=fluid.CUDAPlace(0))


def train_ssd(smi, seed=0):
    """Phase 24's training: SSD_SAMPLES seeded samples written by
    recordio_writer, read back through `_ssd_reader` by a program bound
    with read_file, SSD_STEPS Momentum steps at batch SSD_BATCH through
    Executor.train_loop(feed=None) (one pass of the reader, a host sync a
    step), launch counts zeroed just before and read just after; then one
    step under torch.profiler.  Returns (launches, end-to-end numbers,
    state after the steps, one batch as a numpy feed)."""
    import random
    import tempfile
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import recordio_writer
    from paddle_tpu_torch.ops import kernels as K
    samples = _ssd_samples(SSD_SAMPLES, seed)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ssd.recordio")
        t0 = time.perf_counter()
        recordio_writer.convert_reader_to_recordio_file(path,
                                                        lambda: samples)
        write_s = time.perf_counter() - t0
        reader = _ssd_reader(path)
        main, startup, outs = _ssd_program(seed, SSD_BATCH, reader)
        loss = outs[0]
        ops = [op.type for op in main.global_block().ops]
        if ops.count("bipartite_match") != SSD_BATCH:
            raise AssertionError(f"{ops.count('bipartite_match')} ssd_loss "
                                 f"matchings for batch {SSD_BATCH}")
        block = main.global_block()
        bn = {(h, w, c) for _, c, h, w in (
            block.var(op.desc.inputs["X"][0]).shape
            for op in block.ops if op.type == "batch_norm")}
        if bn != {s[1:] for s in BN_SSD_SHAPES.values()}:
            raise AssertionError(f"the BatchNorm shapes {sorted(bn)} are "
                                 "not phase 3's BN_SSD_SHAPES")
        scope = fluid.core.scope.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        random.seed(seed)
        with fluid.scope_guard(scope):
            exe.run(startup)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launches()
            t0 = time.perf_counter()
            handles = exe.train_loop(main, None, fetch_list=[loss],
                                     fetch_every=1)
            wall = time.perf_counter() - t0
            launches = {k.name: k.launches for k in K.KERNELS}
            peak = torch.cuda.max_memory_allocated()
            step_ms = _window_step_ms(exe._flight.records(), 1)
            reader.reset()
            feed = reader.next_feed()
            reader.reset()
            device = _profile_step(exe, main, feed, loss)
            state = {n: t.cpu().numpy() for n, t in scope._vars.items()}
    losses = [float(h.get()[0]) for h in handles]
    print(f"  {len(handles)} steps in {wall:.2f} s (recordio of "
          f"{SSD_SAMPLES} samples written in {write_s:.2f} s); losses "
          f"{[round(x, 5) for x in losses]}", flush=True)
    print(f"  launches in {len(handles)} steps: {launches}", flush=True)
    if len(handles) != SSD_STEPS:
        raise AssertionError(f"the reader's pass gave {len(handles)} steps, "
                             f"want {SSD_STEPS}")
    for name, per in SSD_LAUNCHES_PER_STEP.items():
        if launches[name] != per * SSD_STEPS:
            raise AssertionError(f"{name}: {launches[name]} launches in "
                                 f"{SSD_STEPS} steps, want {per} per step")
    if not (np.isfinite(losses).all()
            and np.mean(losses[-5:]) < np.mean(losses[:5])):
        raise AssertionError(f"SSD losses do not fall: {losses}")
    p50 = float(np.percentile(step_ms, 50))
    e2e = {"steps": SSD_STEPS, "batch": SSD_BATCH, "priors": SSD_PRIORS,
           "step_ms_p50": p50, "step_ms_p99": float(np.percentile(step_ms,
                                                                   99)),
           "images_per_s": SSD_BATCH * 1e3 / p50, "train_loop_s": wall,
           "recordio_write_s": write_s, "loss_first": losses[0],
           "loss_last": losses[-1], "peak_mem_gib": peak / 2**30,
           "profiled_device_ms": device,
           "device_busy_share": (device["all"] / p50 if device else None),
           "launches_per_step": {n: launches[n] / SSD_STEPS
                                 for n in ("softmax_xent_fwd",
                                           "softmax_xent_bwd",
                                           "batch_norm_bwd")}}
    print(f"  ({smi}) step p50 {p50:.3f} ms, p99 {e2e['step_ms_p99']:.3f} "
          f"ms, {e2e['images_per_s']:.1f} images/s, device ms a step "
          f"{device['all'] if device else None}, busy share "
          f"{e2e['device_busy_share']}", flush=True)
    # the read_file vars' batch under the data vars' names
    batch = {n: v.cpu().numpy() for n, v in zip(
        ("image", "gt_box", "gt_label"), feed.values())}
    return launches, e2e, state, batch


def ssd_card_vs_cpu(state, seed=0):
    """One f32 step at batch SSD_CPU_BATCH at full width from phase 24's
    state (`_f32_step_vs_f64`): the kernels' @GRADs held to their plain
    versions' on the card, the loss to the CPU's.  At this batch the 1x1
    and 2x2 maps give BatchNorm 2 and 8 values a channel, whose one-pass
    f32 variance (E[x^2] - E[x]^2, the JAX package's) cancels, so an f32
    step's @GRADs lie up to about 4e-2 (norm-wise) from the exact step's
    by chance, on either device: the CPU's own step at 8 threads and at 1
    differs by up to 1.6e-2.  The distances from the f64 step are
    recorded but not held to the CPU's (``hold_to_cpu``): that rule
    failed in about one trained state of four with the kernels and with
    their plain versions alike."""
    main, _, outs = _ssd_program(seed, SSD_CPU_BATCH)
    samples = _ssd_samples(SSD_CPU_BATCH, seed + 1)
    feed = {"image": np.stack([s[0] for s in samples]).astype(np.float32),
            "gt_box": np.stack([s[1] for s in samples]),
            "gt_label": np.stack([s[2] for s in samples])}
    return _f32_step_vs_f64("SSD", main, outs[0], feed, "image", state,
                            seed, hold_to_cpu=False)[0]


def _ssd_postprocess_program():
    """detection_output + detection_map over fed loc, scores, priors and
    ground truth, beside multiclass_nms + detection_map over fed decoded
    boxes -> (program, fetch names: decoded, rows, mAP, rows and mAP of
    the fed boxes)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers as L
    fluid.core.program.reset_default_programs()
    C, M = SSD_CONFIG["class_num"], SSD_PRIORS
    loc = L.data(name="loc", shape=[M, 4])
    scores = L.data(name="scores", shape=[C, M])
    prior = L.data(name="prior", shape=[M, 4], append_batch_size=False)
    pvar = L.data(name="pvar", shape=[M, 4], append_batch_size=False)
    decoded = L.data(name="decoded", shape=[M, 4])
    gt_box = L.data(name="gt_box", shape=[SSD_G, 4])
    gt_label = L.data(name="gt_label", shape=[SSD_G], dtype="int64")
    rows = L.detection_output(loc, scores, prior, pvar)
    mean_ap = L.detection_map(rows, gt_box, gt_label)
    rows2 = L.multiclass_nms(decoded, scores)
    mean_ap2 = L.detection_map(rows2, gt_box, gt_label)
    main = fluid.default_main_program()
    box_coder = next(op for op in main.global_block().ops
                     if op.type == "box_coder")
    return main, [box_coder.desc.outputs["OutputBox"][0], rows.name,
                  mean_ap.name, rows2.name, mean_ap2.name]


def _overlapping_gt(rows, seed):
    """Ground truth that the detection rows ``rows`` [B, K, 6] partly
    find: SSD_G - 2 of each image's real rows drawn at random (so hits
    and misses interleave in score order), every corner moved by up to
    2% of the box's size, with their labels, then two seeded boxes of
    seeded labels that no row need match; zero boxes labelled 0 pad the
    rest -> (gt_box [B, SSD_G, 4], gt_label [B, SSD_G])."""
    rng = np.random.default_rng(seed)
    B = rows.shape[0]
    gt_box = np.zeros((B, SSD_G, 4), np.float32)
    gt_label = np.zeros((B, SSD_G), np.int64)
    for b in range(B):
        real = rows[b][rows[b, :, 0] >= 1]
        k = min(len(real), SSD_G - 2)
        real = real[np.sort(rng.choice(len(real), k, replace=False))]
        size = np.tile(real[:, 4:6] - real[:, 2:4], 2)
        gt_box[b, :k] = real[:, 2:6] + size * rng.uniform(-0.02, 0.02,
                                                          (k, 4))
        gt_label[b, :k] = real[:, 0].astype(np.int64)
        xy = rng.uniform(0.0, 0.7, (2, 2))
        gt_box[b, k:k + 2] = np.concatenate(
            [xy, xy + rng.uniform(0.05, 0.3, (2, 2))], 1)
        gt_label[b, k:k + 2] = rng.integers(1, SSD_CONFIG["class_num"], 2)
    return gt_box, gt_label


def infer_ssd(smi, state, batch, seed=0):
    """Phase 24's inference: the for_test clone at batch SSD_BATCH from
    the trained state on one batch of the reader (BatchNorm on its
    running statistics), timed over SSD_INFER_ITERS runs; then
    detection_output and detection_map on the card against the CPU, fed
    the card's loc and scores.  The random model finds none of the
    batch's boxes (its mAP is 0), so the mAP is taken against ground
    truth made from the CPU's rows (`_overlapping_gt`).  The card's
    decoded boxes must lie within F32_TOL of the CPU's; they differ in
    the last bits (the exponential), so each side's NMS rule also runs
    on the other side's decoded boxes: the card's rows must be bitwise
    the CPU rule's on the card's boxes, the card rule's rows on the CPU's
    boxes bitwise the CPU's, in every image, and each mAP within F32_TOL
    of the other side's on the same rows, and above 0."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio
    main, _, outs = _ssd_program(seed, SSD_BATCH)
    test = main.clone(for_test=True)
    fetch = [v.name for v in outs[1:]]
    scope = fluid.core.scope.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    pio.scope_from_numpy(scope, test, state, exe.device)
    ms = []
    for _ in range(SSD_INFER_ITERS + 1):
        t0 = time.perf_counter()
        got = exe.run(test, feed=batch, fetch_list=fetch, scope=scope)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    loc, scores, prior, pvar, rows, mean_ap = got
    if rows.shape != (SSD_BATCH, 20, 6) or loc.shape != (SSD_BATCH,
                                                         SSD_PRIORS, 4):
        raise AssertionError(f"inference shapes {rows.shape} {loc.shape}")
    post, names = _ssd_postprocess_program()
    feed = {"loc": loc, "scores": scores, "prior": prior, "pvar": pvar,
            "gt_box": batch["gt_box"],
            "gt_label": batch["gt_label"][..., 0],
            "decoded": np.zeros_like(loc)}
    first = _run_on(fluid.CPUPlace(), post, feed, names)
    gt_box, gt_label = _overlapping_gt(first[1], seed)
    feed.update(gt_box=gt_box, gt_label=gt_label)
    card = _run_on(fluid.CUDAPlace(0), post, dict(feed, decoded=first[0]),
                   names)
    cpu = _run_on(fluid.CPUPlace(), post, dict(feed, decoded=card[0]),
                  names)
    dec_share = _hold("decoded boxes", card[0], cpu[0], F32_TOL)
    for what, a, b in (("the card's boxes", card[1], cpu[3]),
                       ("the CPU's boxes", card[3], cpu[1])):
        if a.tobytes() != b.tobytes():
            raise AssertionError(f"multiclass_nms on {what}: the card's "
                                 "rows differ from the CPU's")
    detections = int((cpu[1][..., 0] >= 1).sum())
    if detections == 0 or float(cpu[2]) <= 0:
        raise AssertionError(f"nothing to hold: {detections} detections, "
                             f"mAP {float(cpu[2])}")
    map_share = max(_hold("mAP on the card's boxes", card[2], cpu[4],
                          F32_TOL),
                    _hold("mAP on the CPU's boxes", card[4], cpu[2],
                          F32_TOL))
    rec = {"infer_ms_p50": float(np.percentile(ms[1:], 50)),
           "infer_first_ms": ms[0],
           "images_per_s": SSD_BATCH * 1e3 / float(np.percentile(ms[1:],
                                                                 50)),
           "map_card": float(mean_ap), "map_post_card": float(card[2]),
           "map_post_cpu": float(cpu[2]), "detections": detections,
           "decoded_share": dec_share, "map_share": map_share,
           "images_boxes_bitwise": sum(
               card[0][b].tobytes() == cpu[0][b].tobytes()
               for b in range(SSD_BATCH)),
           "images_rows_as_cpu": sum(
               card[1][b].tobytes() == cpu[1][b].tobytes()
               for b in range(SSD_BATCH))}
    print(f"  ({smi}) inference at batch {SSD_BATCH}: p50 "
          f"{rec['infer_ms_p50']:.3f} ms ({rec['images_per_s']:.1f} "
          f"images/s), mAP against the batch's boxes "
          f"{rec['map_card']:.5f}; card against CPU: decoded boxes "
          f"{dec_share:.3f} of the tolerance (bitwise in "
          f"{rec['images_boxes_bitwise']} images), {detections} "
          "detections, the NMS rows bitwise on either side's boxes "
          f"(the card's own rows the CPU's in {rec['images_rows_as_cpu']} "
          f"images), mAP against overlapping ground truth "
          f"{rec['map_post_cpu']:.5f}, {map_share:.3f} of the tolerance",
          flush=True)
    return rec


def ssd_phase(smi):
    """Phase 24 -> (training launches, end-to-end numbers)."""
    print(f"phase 24: MobileNet-SSD {SSD_CONFIG} ({SSD_PRIORS} priors) at "
          f"batch {SSD_BATCH}, f32, Momentum, through recordio -> "
          "open_recordio_file -> shuffle -> batch -> double_buffer -> "
          "read_file and Executor.train_loop(feed=None); then batched "
          "detection_output + detection_map", flush=True)
    launches, train_e2e, state, batch = train_ssd(smi)
    print(f"  one f32 step at batch {SSD_CPU_BATCH}, card against CPU",
          flush=True)
    train_e2e["card_vs_cpu"] = ssd_card_vs_cpu(state)
    infer = infer_ssd(smi, state, batch)
    e2e = {"training": train_e2e, "inference": infer}
    print(f"  end to end ({smi}): {json.dumps(e2e)}", flush=True)
    return launches, e2e


def bn_ssd_step_times(seed=0):
    """The BatchNorm backward over one MobileNet-SSD step's 35 launches
    (NCHW f32 at batch SSD_BATCH, relu): kernel, plain version and
    F.batch_norm's backward (cuDNN, no relu) timed at each of the
    BN_SSD_SHAPES geometries (`_bn_timings`), summed with each shape's
    count of conv_bn layers in the program; the bound summed alike."""
    import collections
    import torch
    from paddle_tpu_torch.ops import kernels as K
    main, _, _ = _ssd_program(seed, SSD_BATCH)
    block = main.global_block()
    counts = collections.Counter(
        (h, w, c) for _, c, h, w in (block.var(op.desc.inputs["X"][0]).shape
                                     for op in block.ops
                                     if op.type == "batch_norm"))
    if sum(counts.values()) != SSD_LAUNCHES_PER_STEP["batch_norm_bwd"]:
        raise AssertionError(f"{sum(counts.values())} BatchNorms in the SSD "
                             "program")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 24)
    keys = ("ms", "plain_ms", "library_ms", "device_ms",
            "library_device_ms", "bound_ms")
    total = dict.fromkeys(keys, 0.0)
    per_shape = {}
    for (h, w, c), k in sorted(counts.items()):
        n = SSD_BATCH
        x = (1.5 * torch.randn(n, c, h * w, generator=g, device=dev) + 0.3)
        dy = torch.randn(n, c, h * w, generator=g, device=dev)
        sc = 1 + 0.3 * torch.randn(c, generator=g, device=dev)
        bi = 0.5 * torch.randn(c, generator=g, device=dev)
        mean = x.mean(dim=(0, 2))
        inv = torch.rsqrt(x.var(dim=(0, 2), unbiased=False) + 1e-5)
        t = _bn_timings((x, dy, sc, bi, mean, inv, "relu"), (n, h, w, c),
                        "NCHW")
        per_shape[f"{h}x{w} C{c}"] = dict({q: t[q] for q in keys},
                                          layers=k)
        for q in keys:
            if t[q] is None or total[q] is None:
                total[q] = None
            else:
                total[q] += k * t[q]
        del x, dy
    out = {"launches": sum(counts.values()), "sum": total,
           "shapes": per_shape}
    print(f"  the BatchNorm backward over the SSD step's "
          f"{out['launches']} launches (summed ms): {json.dumps(total)}",
          flush=True)
    return out


def ssd_ab(smi):
    """``--ssd``: phase 24 alone, after building its two kernels,
    checking the BatchNorm backward at its shapes and timing it, its plain
    version and cuDNN's over the step's 35 launches."""
    from paddle_tpu_torch.ops import _build
    _build.build_all(("softmax_xent", "batch_norm_bwd"))
    print("phase 3: the BatchNorm backward at phase 24's shapes",
          flush=True)
    check_batch_norm_bwd({}, ssd_only=True)
    bn_step = bn_ssd_step_times()
    launches, e2e = ssd_phase(smi)
    return {"ssd": dict(e2e, batch_norm_bwd_step=bn_step, launches={
        n: launches[n] for n in ("softmax_xent_fwd", "softmax_xent_bwd",
                                 "batch_norm_bwd")})}


# ---------------------------------------------------------------------------
# phase 25: the detection rules on the card against the CPU
# ---------------------------------------------------------------------------

def _det_boxes(rng, n, zero_area=0, pad=0):
    """``n`` boxes in [0, 1], the last ``pad`` rows zeros and the
    ``zero_area`` rows before them of zero width."""
    xy = rng.uniform(0.0, 0.7, (n, 2))
    b = np.concatenate([xy, xy + rng.uniform(0.02, 0.3, (n, 2))],
                       1).astype(np.float32)
    real = n - pad
    b[real - zero_area:real, 2] = b[real - zero_area:real, 0]
    b[real:] = 0.0
    return b


def _s25_arrays(seed=25):
    """Phase 25's inputs at the SSD path's shapes: ties (quantized scores
    and similarities, duplicate boxes), zero-area and padding rows."""
    rng = np.random.default_rng(seed)
    M, C, B, G = SSD_PRIORS, SSD_CONFIG["class_num"], SSD_BATCH, SSD_G
    levels = np.float32([0.0, 0.005, 0.05, 0.2, 0.4, 0.6])
    boxes = np.stack([_det_boxes(rng, M, zero_area=4, pad=8)
                      for _ in range(B)])
    boxes[:, 1::7] = boxes[:, ::7][:, :boxes[:, 1::7].shape[1]]
    gtb = np.stack([_det_boxes(rng, G, zero_area=1, pad=3)
                    for _ in range(B)])
    gtl = rng.integers(1, C, (B, G)).astype(np.int64)
    gtl[:, -3:] = 0
    det = np.concatenate([
        rng.integers(-1, C, (B, 20, 1)).astype(np.float32),
        levels[rng.integers(2, 6, (B, 20, 1))],
        np.where(rng.random((B, 20, 1)) < 0.6,
                 gtb[np.arange(B)[:, None], rng.integers(0, G, (B, 20))]
                 + rng.uniform(-0.02, 0.02, (B, 20, 4)),
                 rng.uniform(0, 1, (B, 20, 4)))], 2).astype(np.float32)
    return dict(
        boxes=boxes, gtb=gtb, gtl=gtl, det=det,
        scores=levels[rng.integers(0, 6, (B, C, M))],
        prior=_det_boxes(rng, M, zero_area=4),
        pvar=np.tile(np.float32([[0.1, 0.1, 0.2, 0.2]]), (M, 1)),
        offsets=rng.normal(0, 1, (B, M, 4)).astype(np.float32),
        dist=levels[rng.integers(0, 6, (G, M))],
        match=np.where(rng.random((1, M)) < 0.1,
                       rng.integers(0, G, (1, M)), -1).astype(np.int32),
        cls_loss=levels[rng.integers(0, 6, (B, M))],
        enc=rng.normal(0, 1, (G, M, 4)).astype(np.float32))


_S25 = _s25_arrays()


def _exact(case):
    return dict(case, exact=True)


#: phase 25's one-op programs: the ten detection rules at the SSD path's
#: shapes; every output but the arithmetic ones (prior boxes, encoded
#: and decoded boxes, IoU, mAP, smooth-L1) bitwise the CPU's
S25_OP_CASES = (
    [_op_case("prior_box", {"Input": np.zeros((1, 512, 19, 19), np.float32),
                            "Image": np.zeros((1, 3, 300, 300), np.float32)},
              {"min_sizes": [60.0], "max_sizes": [111.0],
               "aspect_ratios": [2.0, 3.0], "flip": True, "clip": True,
               "variances": [0.1, 0.1, 0.2, 0.2], "step_w": 0.0,
               "step_h": 0.0, "offset": 0.5}, ("Boxes", "Variances"),
              nodiff=("Input", "Image"), sums=None),
     _op_case("box_coder", {"PriorBox": _S25["prior"],
                            "PriorBoxVar": _S25["pvar"],
                            "TargetBox": _S25["gtb"][0]},
              {"code_type": "encode_center_size"}, ("OutputBox",),
              nodiff=("PriorBox", "PriorBoxVar", "TargetBox"), sums=None),
     _op_case("box_coder", {"PriorBox": _S25["prior"],
                            "PriorBoxVar": _S25["pvar"],
                            "TargetBox": _S25["offsets"]},
              {"code_type": "decode_center_size"}, ("OutputBox",),
              nodiff=("PriorBox", "PriorBoxVar"), sums=None),
     _op_case("iou_similarity", {"X": _S25["gtb"][0], "Y": _S25["prior"]},
              outs=("Out",), sums=None),
     _exact(_op_case("bipartite_match", {"DistMat": _S25["dist"]},
                     {"match_type": "per_prediction",
                      "dist_threshold": 0.5},
                     ("ColToRowMatchIndices", "ColToRowMatchDist"),
                     sums=None)),
     _exact(_op_case("bipartite_match", {"DistMat": _S25["dist"]},
                     {"match_type": "bipartite"},
                     ("ColToRowMatchIndices", "ColToRowMatchDist"),
                     sums=None)),
     _exact(_op_case("target_assign",
                     {"X": _S25["gtl"][0][:, None], "MatchIndices":
                      _S25["match"]}, {"mismatch_value": 0},
                     ("Out", "OutWeight"), sums=None)),
     _exact(_op_case("mine_hard_examples",
                     {"ClsLoss": _S25["cls_loss"],
                      "MatchIndices": np.tile(_S25["match"], (SSD_BATCH, 1))},
                     {"neg_pos_ratio": 3.0, "mining_type": "max_negative"},
                     ("NegIndices", "UpdatedMatchIndices"), sums=None)),
     _exact(_op_case("multiclass_nms", {"BBoxes": _S25["boxes"],
                                        "Scores": _S25["scores"]},
                     {"background_label": 0, "score_threshold": 0.01,
                      "nms_threshold": 0.3, "nms_top_k": 64,
                      "keep_top_k": 20}, sums=None)),
     _op_case("detection_map", {"DetectRes": _S25["det"],
                                "GTBoxes": _S25["gtb"],
                                "GTLabels": _S25["gtl"]},
              {"overlap_threshold": 0.5, "background_label": 0},
              ("MAP", "AccumPosCount"), nodiff=("DetectRes", "GTBoxes"),
              sums=None),
     _op_case("detection_map", {
         "DetectRes": _S25["det"],
         "GTBoxes": np.concatenate([_S25["gtl"][..., None].astype(
             np.float32), _S25["gtb"], (np.arange(SSD_G) % 3 == 0)[
                 None, :, None].repeat(SSD_BATCH, 0).astype(np.float32)],
             2)}, {"overlap_threshold": 0.5, "background_label": 0,
                   "evaluate_difficult": False},
              ("MAP", "AccumPosCount"), nodiff=("DetectRes", "GTBoxes"),
              sums=None),
     _exact(_op_case("gather_encoded_target",
                     {"Encoded": _S25["enc"], "MatchIndices": _S25["match"]},
                     outs=("Out", "OutWeight"), nodiff=("Encoded",),
                     sums=None)),
     _op_case("abs_smooth_l1", {"X": _away((SSD_PRIORS, 4), -1.0, 1.0)})])
#: the rules phase 25 holds: ops/detection_ops.py's ten
S25_RULES = frozenset((
    "prior_box", "box_coder", "iou_similarity", "bipartite_match",
    "target_assign", "mine_hard_examples", "multiclass_nms",
    "detection_map", "gather_encoded_target", "abs_smooth_l1"))


def detection_rules_card_vs_cpu(seed=0):
    """Phase 25: the detection rules (S25_OP_CASES) on the card against
    the CPU as phase 16 holds its rules, the exact cases bitwise."""
    return _rules_card_vs_cpu(25, S25_OP_CASES, S25_RULES, seed)


# ---------------------------------------------------------------------------
# phase 26: SelectedRows sparse training on the recommender
# ---------------------------------------------------------------------------

#: bench.py:794-810 (bench_recommender) at full width: a V x D table read
#: by is_sparse lookups of T ids a row (Zipf(1.1), ragged lengths),
#: sequence_pool sum, fc 128 relu, fc 2 softmax, cross_entropy, Adam 1e-3
#: through train_loop in windows of REC_K steps; REC_WINDOWS windows a
#: leg, the first one not timed
REC_TRAIN = dict(V=100_000, D=64, T=64, batch=64)
REC_K, REC_WINDOWS, REC_FEEDS = 8, 5, 8
#: the card's state after one window against the CPU's: max abs error
#: over max(1, max |cpu|) (f32 rules summed in another order)
REC_CPU_TOL = 1e-4
#: under MixedPrecision the fc products take bf16 operands, which the
#: card and the CPU round after sums taken in another order: each
#: persistable's max abs error after the window must stay within this
#: share of how far the CPU's window moved it (max |cpu - start|; 0 where
#: it did not move), so a skipped or wrong update fails
REC_AMP_MOVE_SHARE = 0.1
#: and each step's loss within this absolute limit (on an H100 the
#: worst share was 5.2e-4 and the losses 6.0e-8 apart)
REC_AMP_LOSS_TOL = 1e-5
#: benchmark/fluid/sparse_embedding.py:388-415's size leg: V 1M, D 256,
#: uniform ids at full length, sequence_pool sum, fc 2 softmax, Adam 1e-3;
#: SIZE_WARMUP steps, then SIZE_STEPS timed steps a leg at each (batch, T)
SIZE_TABLE = dict(V=1_000_000, D=256)
SIZE_SHAPES = ((32, 32), (1024, 512))
SIZE_WARMUP, SIZE_STEPS = 2, 5
#: the sparse leg's peak over its resident state at bs32 T32 must stay
#: under this share of the dense [V, D] gradient (1 GiB)
SIZE_PEAK_SHARE = 0.25


def _rec_program(is_sparse, make_opt, V, D, hidden=128, seed=0,
                 is_distributed=False):
    """The recommender in fresh programs: -> (main, startup, loss, table
    name).  ``make_opt(fluid)`` gives the optimizer; ``hidden`` 0 drops
    the fc 128 (sparse_embedding.py's model); ``is_distributed`` marks
    the table row-sharded (phase 33)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        words = layers.data(name="words", shape=[1], dtype="int64",
                            lod_level=1)
        emb = layers.embedding(input=words, size=[V, D],
                               is_sparse=is_sparse,
                               is_distributed=is_distributed)
        h = layers.sequence_pool(emb, pool_type="sum")
        if hidden:
            h = layers.fc(input=h, size=hidden, act="relu")
        pred = layers.fc(input=h, size=2, act="softmax")
        label = layers.data(name="label", shape=[1], dtype="int64")
        loss = layers.mean(layers.cross_entropy(input=pred, label=label))
        make_opt(fluid).minimize(loss)
    startup.random_seed = seed
    table = next(op.desc.inputs["W"][0] for op in main.global_block().ops
                 if op.type == "lookup_table")
    return main, startup, loss, table


def _rec_feeds(n, batch, T, V, seed, zipf=1.1, ragged=True):
    """``n`` seeded batches: ids Zipf(``zipf``) (uniform when None), the
    lengths ragged in [1, T] or full."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = (np.minimum(rng.zipf(zipf, (batch, T)), V) - 1 if zipf
               else rng.randint(0, V, (batch, T)))
        out.append({"words": ids.astype(np.int64),
                    "words@SEQ_LEN": (rng.randint(1, T + 1, batch) if ragged
                                      else np.full(batch, T)).astype(
                                          np.int32),
                    "label": rng.randint(0, 2, (batch, 1)).astype(
                        np.int64)})
    return out


def _startup_state(startup, place):
    """The persistables ``startup`` makes on ``place``, as numpy."""
    import paddle_tpu_torch as fluid
    scope = fluid.core.scope.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(place).run(startup)
    return {n: v.cpu().numpy() for n, v in scope._vars.items()}


def _rec_run(main, loss, state, place, feeds, steps, fetch=()):
    """``steps`` steps of ``main`` through train_loop in one window of
    ``steps``, from ``state`` in a fresh scope on ``place`` -> (fetches a
    step, the scope, the executor)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio
    exe = fluid.Executor(place)
    scope = fluid.core.scope.Scope()
    pio.scope_from_numpy(scope, main, state, exe.device)
    with fluid.scope_guard(scope):
        hs = exe.train_loop(main, feeds, fetch_list=[loss.name, *fetch],
                            steps=steps, steps_per_launch=steps)
        got = [h.get() for h in hs]
    return got, scope, exe


def _held(label, card, cpu):
    """Fail unless every array of ``card`` is within REC_CPU_TOL x max(1,
    max |cpu|) of ``cpu``'s; -> the largest share of the tolerance."""
    share = 0.0
    for name, b in cpu.items():
        b = np.asarray(b, np.float64)
        lim = REC_CPU_TOL * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(np.asarray(card[name], np.float64) - b).max())
        share = max(share, err / lim)
        if err > lim:
            raise AssertionError(f"phase 26 {label}: {name} on the card is "
                                 f"{err:.3e} from the CPU's (limit {lim:.3e})")
    return share


def _held_to_movement(label, card, cpu, start):
    """Fail unless every array of ``card`` is within REC_AMP_MOVE_SHARE x
    max |cpu - start| of ``cpu``'s -> {name: [max abs error, max
    movement]} of the arrays that moved."""
    out = {}
    for name, b in cpu.items():
        b = np.asarray(b, np.float64)
        err = float(np.abs(np.asarray(card[name], np.float64) - b).max())
        move = float(np.abs(b - np.asarray(start[name], np.float64)).max())
        if err > REC_AMP_MOVE_SHARE * move:
            raise AssertionError(
                f"phase 26 {label}: {name} on the card is {err:.3e} from "
                f"the CPU's, whose window moved it {move:.3e} (limit "
                f"{REC_AMP_MOVE_SHARE} of that)")
        if move:
            out[name] = [err, move]
    return out


def _sparse_branch_checks(label, make_opt, feeds, seed=0, amp=False):
    """One optimizer's sparse branch at the recommender's full width: one
    window of REC_K steps on the card against the CPU from one startup
    state (every persistable to REC_CPU_TOL); the rows no feed looked up
    bitwise their start in every [V, D] persistable (table, moments,
    velocity); one step run twice from the start state, bitwise (every
    persistable and the fetched rows and values); under ``amp`` one step
    with an inf in a looked-up row of the table, which must be a skip
    (every persistable but the scaler bitwise, the scale halved).  Under
    ``amp`` the window is held to REC_AMP_MOVE_SHARE of each
    persistable's movement and the losses to REC_AMP_LOSS_TOL instead."""
    import torch
    import paddle_tpu_torch as fluid
    cfg = REC_TRAIN
    main, startup, loss, table = _rec_program(True, make_opt, cfg["V"],
                                              cfg["D"], seed=seed)
    state = _startup_state(startup, fluid.CPUPlace())
    wide = [n for n, a in state.items() if a.shape == (cfg["V"], cfg["D"])]
    card, card_scope, card_exe = _rec_run(main, loss, state,
                                          fluid.CUDAPlace(0), feeds, REC_K)
    cpu, cpu_scope, _ = _rec_run(main, loss, state, fluid.CPUPlace(), feeds,
                                 REC_K)
    card_state = {n: card_scope.get(n).cpu().numpy() for n in state}
    cpu_state = {n: cpu_scope.get(n).numpy() for n in state}
    card_loss = np.array([float(f[0]) for f in card])
    cpu_loss = np.array([float(f[0]) for f in cpu])
    out = {}
    if amp:
        out["err_and_movement"] = _held_to_movement(label, card_state,
                                                    cpu_state, state)
        out["move_share"] = max(e / m for e, m in
                                out["err_and_movement"].values())
        out["loss_err"] = float(np.abs(card_loss - cpu_loss).max())
        if out["loss_err"] > REC_AMP_LOSS_TOL:
            raise AssertionError(f"phase 26 {label}: the card's losses are "
                                 f"{out['loss_err']:.3e} from the CPU's")
    else:
        out["cpu_share"] = _held(label, card_state, cpu_state)
        _held(label + " losses", {"loss": card_loss}, {"loss": cpu_loss})
    seen = np.zeros(cfg["V"], bool)
    seen[np.concatenate([f["words"].ravel() for f in feeds[:REC_K]])] = True
    for n in wide:
        if not np.array_equal(card_state[n][~seen], state[n][~seen]):
            raise AssertionError(f"phase 26 {label}: rows no feed looked up "
                                 f"moved in {n}")
    grad = table + "@GRAD"
    fetch = (grad + "@ROWS", grad + "@VALUES")
    runs = []
    for _ in range(2):
        got, scope, _ = _rec_run(main, loss, state, fluid.CUDAPlace(0),
                                 feeds[:1], 1, fetch)
        runs.append((got, {n: scope.get(n) for n in state}))
    (g1, s1), (g2, s2) = runs
    same = (all(torch.equal(s1[n], s2[n]) for n in state)
            and all(np.array_equal(a, b) for a, b in zip(g1[0], g2[0])))
    if not same:
        raise AssertionError(f"phase 26 {label}: one step run twice is not "
                             "bitwise")
    out.update(untouched_rows=int((~seen).sum()),
               merged_rows=int(np.unique(g1[0][1]).size),
               rows=int(g1[0][1].size), step_twice_bitwise=True)
    if amp:
        ls = main._loss_scaling
        names = [n for n in state if n not in (ls["scale"],
                                               ls["good_steps"])]
        scale = float(card_scope.get(ls["scale"]))
        row = int(feeds[0]["words"][0, 0])
        with torch.no_grad():
            card_scope.get(table)[row, 0] = float("inf")
        before = {n: card_scope.get(n).clone() for n in names}
        with fluid.scope_guard(card_scope):
            card_exe.run(main, feed=feeds[0], fetch_list=[loss])
        torch.cuda.synchronize()
        moved = [n for n in names
                 if not torch.equal(before[n], card_scope.get(n))]
        after = float(card_scope.get(ls["scale"]))
        if moved or after != scale / 2:
            raise AssertionError(f"phase 26 {label}: the overflowed step "
                                 f"moved {moved}, scale {scale} -> {after}")
        out["overflow_skip_bitwise"] = True
    print(f"  {label}: {json.dumps(out)}", flush=True)
    return out


def _rec_leg(is_sparse, feeds, seed=0):
    """One leg of the recommender at full width on the card: REC_WINDOWS
    windows of REC_K steps through train_loop, a host sync a window ->
    (end-to-end numbers, main, loss, the executor, its scope, the start
    state)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio
    cfg = REC_TRAIN
    main, startup, loss, table = _rec_program(
        is_sparse, lambda fl: fl.optimizer.Adam(learning_rate=1e-3),
        cfg["V"], cfg["D"], seed=seed)
    state = _startup_state(startup, fluid.CPUPlace())
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.core.scope.Scope()
    pio.scope_from_numpy(scope, main, state, exe.device)
    steps = REC_K * REC_WINDOWS
    with fluid.scope_guard(scope):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = exe.train_loop(main, feeds, fetch_list=[loss], steps=steps,
                            fetch_every=REC_K, steps_per_launch=REC_K)
        wall = time.perf_counter() - t0
    losses = [float(h.get()[0]) for h in hs]
    ms = _window_step_ms(exe._flight.records(), REC_K)
    if not (np.isfinite(losses).all()
            and np.mean(losses[-REC_K:]) < np.mean(losses[:REC_K])):
        raise AssertionError(f"recommender losses do not fall: {losses}")
    p50 = float(np.percentile(ms, 50))
    e2e = {"is_sparse": is_sparse, "steps": steps, "steps_per_launch": REC_K,
           "step_ms_p50": p50, "step_ms_p99": float(np.percentile(ms, 99)),
           "examples_per_s": cfg["batch"] * 1e3 / p50, "train_loop_s": wall,
           "loss_first": losses[0], "loss_last": losses[-1]}
    return e2e, main, loss, exe, scope, state, table


def _merge_times(V, D, n, seed, zipf=None):
    """merge_selected_rows alone on ``n`` seeded ids (Zipf(``zipf``) or
    uniform) and values [n, D] on the card: CUDA-event ms (its one host
    sync included) and device ms a call."""
    import torch
    from paddle_tpu_torch.ops.optimizer_ops import merge_selected_rows
    rng = np.random.RandomState(seed)
    ids = (np.minimum(rng.zipf(zipf, n), V) - 1 if zipf
           else rng.randint(0, V, n))
    rows = torch.tensor(ids, dtype=torch.int32, device="cuda")
    values = torch.tensor(rng.randn(n, D).astype(np.float32), device="cuda")
    uniq, _ = merge_selected_rows(rows, values, V)
    return {"n": n, "merged_rows": int(uniq.numel()),
            "ms": _time_ms(lambda: merge_selected_rows(rows, values, V)),
            "device_ms": _device_ms(
                lambda: merge_selected_rows(rows, values, V))[0]}


def _size_leg(bs, T, seed=0):
    """sparse_embedding.py's size leg at (bs, T): each of the sparse and
    dense legs from its startup on the card, SIZE_WARMUP steps, then
    SIZE_STEPS timed steps (host clock around run and a synchronise);
    the peak allocated during the last step over what was allocated
    before it (the resident state and the feed); the merge alone."""
    import torch
    import paddle_tpu_torch as fluid
    V, D = SIZE_TABLE["V"], SIZE_TABLE["D"]
    feeds = _rec_feeds(2, bs, T, V, seed, zipf=None, ragged=False)
    out = {"batch": bs, "T": T, "n": bs * T}
    for is_sparse in (True, False):
        main, startup, loss, table = _rec_program(
            is_sparse, lambda fl: fl.optimizer.Adam(learning_rate=1e-3),
            V, D, hidden=0, seed=seed)
        scope = fluid.core.scope.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        with fluid.scope_guard(scope):
            exe.run(startup)
            state_bytes = sum(t.numel() * t.element_size()
                              for t in scope._vars.values())
            for step in range(SIZE_WARMUP):
                exe.run(main, feed=feeds[step % 2], fetch_list=[loss])
            ms = []
            for step in range(SIZE_STEPS):
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                (l,) = exe.run(main, feed=feeds[(step + 1) % 2],
                               fetch_list=[loss])
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() - before
        if not np.isfinite(l).all():
            raise AssertionError(f"size leg bs{bs} T{T}: loss {l}")
        leg = "sparse" if is_sparse else "dense"
        out[leg] = {"step_ms": ms, "step_ms_p50": float(np.median(ms)),
                    "peak_over_resident_gib": peak / 2**30,
                    "state_gib": state_bytes / 2**30}
        del exe, scope
        torch.cuda.empty_cache()
    out["merge"] = _merge_times(V, D, bs * T, seed)
    out["dense_over_sparse"] = (out["dense"]["step_ms_p50"]
                                / out["sparse"]["step_ms_p50"])
    return out


def sparse_phase(smi, seed=0):
    """Phase 26: the recommender of bench.py at full width, its sparse and
    dense legs; the sparse branches of Adam, SGD, Momentum (nesterov) and
    MixedPrecision(Adam) held to the CPU, to their untouched rows and to
    themselves; then sparse_embedding.py's V 1M D 256 size leg.  No port
    kernel runs on this path (the merge and the row updates are torch
    ops): the counts, zeroed just before the sparse leg's train_loop and
    read just after it, must all be 0.  -> (launches, end-to-end
    numbers)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import kernels as K
    cfg = REC_TRAIN
    print(f"phase 26: the recommender of bench.py:794-810 {cfg} "
          "(Zipf(1.1) ids, ragged lengths), Adam 1e-3, through "
          f"Executor.train_loop in windows of {REC_K}: is_sparse "
          "(SelectedRows) and dense; then sparse_embedding.py's "
          f"{SIZE_TABLE} size leg", flush=True)
    feeds = _rec_feeds(REC_FEEDS, cfg["batch"], cfg["T"], cfg["V"], seed)
    e2e = {}
    for is_sparse in (True, False):
        leg = "sparse" if is_sparse else "dense"
        if is_sparse:
            K.reset_launches()
        e2e[leg], main, loss, exe, scope, state, table = _rec_leg(
            is_sparse, feeds, seed)
        if is_sparse:
            # the main path's own run: its counts, read before any check
            launches = {k.name: k.launches for k in K.KERNELS}
            if any(launches.values()):
                raise AssertionError("phase 26: a port kernel launched on "
                                     f"the sparse path: {launches}")
        print(f"  {leg} ({smi}): {json.dumps(e2e[leg])}", flush=True)
        if is_sparse:
            seen = np.zeros(cfg["V"], bool)
            seen[np.concatenate([f["words"].ravel() for f in feeds])] = True
            wide = [n for n, a in state.items()
                    if a.shape == (cfg["V"], cfg["D"])]
            for n in wide:
                now = scope.get(n).cpu().numpy()
                if not np.array_equal(now[~seen], state[n][~seen]):
                    raise AssertionError(f"phase 26: rows never looked up "
                                         f"moved in {n}")
            e2e[leg]["untouched_rows_bitwise"] = {
                "rows": int((~seen).sum()), "tensors": wide}
            with fluid.scope_guard(scope):
                device = _profile_step(
                    exe, main, feeds[0], loss, ranges={
                        "lookup_table": "lookup_table",
                        "sequence_pool": "sequence_pool",
                        "backward": "backward", "adam": "adam"})
            e2e[leg]["profiled_device_ms"] = device
            e2e[leg]["device_busy_share"] = (
                device["all"] / e2e[leg]["step_ms_p50"] if device else None)
        del exe, scope
    e2e["sparse_over_dense_examples"] = (e2e["sparse"]["examples_per_s"]
                                         / e2e["dense"]["examples_per_s"])
    e2e["merge"] = _merge_times(cfg["V"], cfg["D"], cfg["batch"] * cfg["T"],
                                seed, zipf=1.1)
    print(f"  ({smi}) merge_selected_rows alone: {json.dumps(e2e['merge'])}",
          flush=True)
    e2e["branches"] = {
        "adam": _sparse_branch_checks(
            "adam", lambda fl: fl.optimizer.Adam(learning_rate=1e-3), feeds),
        "sgd": _sparse_branch_checks(
            "sgd", lambda fl: fl.optimizer.SGD(learning_rate=0.1), feeds),
        "momentum nesterov": _sparse_branch_checks(
            "momentum nesterov", lambda fl: fl.optimizer.Momentum(
                learning_rate=0.1, momentum=0.9, use_nesterov=True), feeds),
        "amp adam": _sparse_branch_checks(
            "MixedPrecision(Adam)", lambda fl: fl.optimizer.MixedPrecision(
                fl.optimizer.Adam(learning_rate=1e-3)), feeds, amp=True)}
    e2e["size"] = {}
    for bs, T in SIZE_SHAPES:
        r = _size_leg(bs, T, seed)
        e2e["size"][f"bs{bs} T{T}"] = r
        print(f"  size leg bs{bs} T{T} ({smi}): {json.dumps(r)}", flush=True)
    small = e2e["size"][f"bs{SIZE_SHAPES[0][0]} T{SIZE_SHAPES[0][1]}"]
    dense_grad_gib = SIZE_TABLE["V"] * SIZE_TABLE["D"] * 4 / 2**30
    if small["sparse"]["peak_over_resident_gib"] > (SIZE_PEAK_SHARE
                                                    * dense_grad_gib):
        raise AssertionError(
            "phase 26: the sparse leg's peak over its resident state "
            f"({small['sparse']['peak_over_resident_gib']:.3f} GiB) is not "
            f"far below the {dense_grad_gib:.0f} GiB dense gradient")
    torch.cuda.empty_cache()
    return launches, e2e


# ---------------------------------------------------------------------------
# phase 27: the LM under memory_optimize (rematerialisation)
# ---------------------------------------------------------------------------

#: phase 5's LM at TRAIN_CONFIG, batch TRAIN_BATCH, f32, Adam, without and
#: with fluid.memory_optimize: REMAT_CHECK steps from one state (losses
#: and every @GRAD of the last compared), then REMAT_TIMED timed steps
REMAT_CHECK, REMAT_TIMED = 3, 6
#: under remat each forward kernel launches again in its segment's
#: recompute; the backward kernels once
REMAT_LAUNCHES_PER_STEP = dict(
    TRAIN_LAUNCHES_PER_STEP, flash_attention_fwd=24, layer_norm_fwd=48,
    softmax_xent_fwd=2)


def remat_phase(smi, seed=0):
    """Phase 27: the LM without and with memory_optimize in one call,
    each leg from the same startup state on the same feed: REMAT_CHECK
    steps with launch counts zeroed before and read after (the remat leg
    must launch REMAT_LAUNCHES_PER_STEP a step), losses and every @GRAD of
    the last step bitwise the plain leg's (else the op whose output
    first differs is named with its largest difference, and the phase
    fails); then REMAT_TIMED steps timed (host clock and a synchronise)
    with the peak allocated memory.  -> (launches of each leg, results)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio
    from paddle_tpu_torch.ops import kernels as K
    print(f"phase 27: training {TRAIN_CONFIG} at batch {TRAIN_BATCH}, f32, "
          "Adam, without and with fluid.memory_optimize (rematerialised "
          "segments under torch.utils.checkpoint)", flush=True)
    feed = _copy_feed(TRAIN_BATCH, seed)
    legs, launches, grads, losses = {}, {}, {}, {}
    state = None
    for remat in (False, True):
        name = "remat" if remat else "plain"
        main, startup, avg_cost = _train_program(seed)
        if state is None:
            state = _startup_state(startup, fluid.CUDAPlace(0))
        if remat:
            fluid.memory_optimize(main)
        (bwd,) = [op for op in main.global_block().ops
                  if op.type == "backward"]
        names = [p + "@GRAD" for p in bwd.desc.attrs["params"]]
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = fluid.core.scope.Scope()
        pio.scope_from_numpy(scope, main, state, exe.device)
        with fluid.scope_guard(scope):
            torch.cuda.synchronize()
            K.reset_launches()
            losses[name] = []
            for step in range(REMAT_CHECK):
                last = step == REMAT_CHECK - 1
                out = exe.run(main, feed=feed, fetch_list=[avg_cost] + (
                    names if last else []), return_numpy=False)
                losses[name].append(out[0].clone())
            grads[name] = dict(zip(names, out[1:]))
            torch.cuda.synchronize()
            launches[name] = {k.name: k.launches for k in K.KERNELS}
            ms = []
            torch.cuda.reset_peak_memory_stats()
            for _ in range(REMAT_TIMED):
                t0 = time.perf_counter()
                exe.run(main, feed=feed, fetch_list=[avg_cost])
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated()
        legs[name] = {"losses": [float(l) for l in losses[name]],
                      "step_ms": ms,
                      "step_ms_p50": float(np.median(ms)),
                      "peak_mem_gib": peak / 2**30,
                      "launches_per_step": {
                          k: v / REMAT_CHECK
                          for k, v in launches[name].items() if v},
                      "segments": (len(main._remat_bounds) - 1
                                   if remat else None)}
        print(f"  {name} ({smi}): {json.dumps(legs[name])}", flush=True)
        del exe, scope
        torch.cuda.empty_cache()
    for leg, per_step in (("plain", TRAIN_LAUNCHES_PER_STEP),
                          ("remat", REMAT_LAUNCHES_PER_STEP)):
        for k, n in per_step.items():
            if launches[leg][k] != n * REMAT_CHECK:
                raise AssertionError(
                    f"phase 27 {leg}: {k} launched {launches[leg][k]} times "
                    f"in {REMAT_CHECK} steps, want {n} a step")
    differ = {n: float((grads["remat"][n] - g).abs().max())
              for n, g in grads["plain"].items()
              if not torch.equal(grads["remat"][n], g)}
    loss_same = all(torch.equal(a, b)
                    for a, b in zip(losses["plain"], losses["remat"]))
    print(f"  losses bitwise: {loss_same}; @GRADs compared "
          f"{len(grads['plain'])}, differing {differ}", flush=True)
    if differ or not loss_same:
        raise AssertionError(f"phase 27: remat is not bitwise the plain run "
                             f"(losses {loss_same}; @GRADs {differ})")
    e2e = dict(legs, grads_compared=len(grads["plain"]), bitwise=True,
               peak_ratio=(legs["remat"]["peak_mem_gib"]
                           / legs["plain"]["peak_mem_gib"]),
               step_ratio=(legs["remat"]["step_ms_p50"]
                           / legs["plain"]["step_ms_p50"]))
    print(f"  ({smi}) peak memory {legs['plain']['peak_mem_gib']:.3f} -> "
          f"{legs['remat']['peak_mem_gib']:.3f} GiB, step p50 "
          f"{legs['plain']['step_ms_p50']:.2f} -> "
          f"{legs['remat']['step_ms_p50']:.2f} ms", flush=True)
    return launches, e2e


def sparse_ab(smi):
    """``--sparse``: phase 26 alone (its path runs no port kernel)."""
    launches, e2e = sparse_phase(smi)
    return {"sparse": e2e}


def remat_ab(smi):
    """``--remat``: phase 27 alone, after building the LM's kernels."""
    from paddle_tpu_torch.ops import _build
    _build.build_all(("flash_attention", "flash_attention_bwd",
                      "layer_norm", "layer_norm_bwd", "softmax_xent"))
    launches, e2e = remat_phase(smi)
    return {"remat": dict(e2e, launches=launches)}


# ---------------------------------------------------------------------------
# phases 28 and 29: the observability plane
# ---------------------------------------------------------------------------

#: phase 28's capture cadence: a torch.profiler window every OBS_EVERY
#: steps, each covering OBS_WINDOW steps (rounded up to whole windows of
#: AMP_K steps)
OBS_EVERY, OBS_WINDOW = 8, 2
#: the __global__ functions (ops/csrc) of the six training kernels
TRAIN_KERNEL_GLOBALS = {
    "flash_attention_fwd": ("flash_fwd_kernel",),
    "flash_attention_bwd": ("flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel"),
    "layer_norm_fwd": ("ln_fwd_warp_kernel", "ln_fwd_block_kernel"),
    "layer_norm_bwd": ("ln_bwd_warp_kernel", "ln_bwd_block_kernel"),
    "softmax_xent_fwd": ("sm_xent_fwd_kernel",),
    "softmax_xent_bwd": ("sm_xent_bwd_kernel",)}
#: phase 29's traffic: OBS_REQUESTS streamed generate requests of OBS_NEW
#: tokens, prompts of OBS_PROMPT tokens, on OBS_SLOTS decode slots; the
#: SLO's TTFT p99 objective
OBS_REQUESTS, OBS_NEW, OBS_PROMPT, OBS_SLOTS = 16, 64, (8, 1024), 16
OBS_TTFT_P99_MS = 5000.0
#: the kernels phase 29's path runs
OBS_SERVE_KERNELS = ("paged_attention", "flash_attention_fwd",
                     "layer_norm_fwd")


def _split_window_ms(window_ms, windows):
    """Per-step ms of the train_loop windows 2.. (``_window_step_ms``)
    with the capture's start and stop seconds (paid in the ticks at the
    head of a window) taken out, split into the windows the profiler
    captured and the rest: -> (captured, uncaptured)."""
    extra = {}
    for w in windows:
        first = w["step"] // AMP_K
        extra[first] = extra.get(first, 0.0) + w["start_s"]
        last = first + -(-OBS_WINDOW // AMP_K)
        extra[last] = extra.get(last, 0.0) + w["stop_s"]
    captured = {w["step"] // AMP_K for w in windows}
    net = {i: ms - extra.get(i, 0.0) * 1e3 / AMP_K
           for i, ms in enumerate(window_ms, start=1)}
    return ([ms for i, ms in net.items() if i in captured],
            [ms for i, ms in net.items() if i not in captured])


def observe_train(smi, seed=0, amp_e2e=None):
    """Phase 28: the amp LM through train_loop, from one startup state
    three times: plain, with timeline_path and xprof_every, and plain
    again (a torch.profiler session can leave the process's launches
    slower after it ends; the second plain run reads that apart from the
    plane's own cost).  -> (launches of the three runs, results)."""
    import tempfile
    import threading
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.observability import attribution, introspect
    from paddle_tpu_torch.ops import kernels as K
    print(f"phase 28: training {TRAIN_CONFIG} at batch {TRAIN_BATCH} under "
          f"MixedPrecision(Adam) through train_loop (steps_per_launch "
          f"{AMP_K}), plain and with timeline_path, xprof_every {OBS_EVERY},"
          f" xprof_steps {OBS_WINDOW}", flush=True)
    main, startup, avg_cost = _train_program(seed, amp=True)
    feed = _copy_feed(TRAIN_BATCH, seed)
    scope0 = fluid.core.scope.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=scope0)
    saved = {n: v.clone() for n, v in scope0._vars.items()
             if isinstance(v, torch.Tensor)}
    del scope0
    loop = dict(fetch_list=[avg_cost.name], steps=AMP_STEPS,
                fetch_every=AMP_K, steps_per_launch=AMP_K)
    runs, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        timeline = os.path.join(tmp, "timeline.json")
        for label, kw in (("plain", {}),
                          ("observed", dict(
                              timeline_path=timeline, xprof_every=OBS_EVERY,
                              xprof_steps=OBS_WINDOW,
                              xprof_dir=os.path.join(tmp, "xprof"))),
                          ("plain_after", {})):
            scope = fluid.core.scope.Scope()
            for n, v in saved.items():
                scope.set(n, v.clone())
            exe = fluid.Executor(fluid.CUDAPlace(0))
            with fluid.scope_guard(scope):
                torch.cuda.synchronize()
                before = introspect.count()
                K.reset_launches()
                t0 = time.perf_counter()
                handles = exe.train_loop(main, feed, **loop, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches[label] = {k.name: k.launches for k in K.KERNELS}
            runs[label] = {
                "losses": [np.asarray(h.get()[0]).tobytes()
                           for h in handles],
                "wall_s": wall,
                "window_ms": _window_step_ms(exe._flight.records(), AMP_K),
                "reports": introspect.reports(layer="executor",
                                              since_seq=before),
                "xprof": exe.last_xprof}
            del exe, scope
            torch.cuda.empty_cache()
        for k, n in TRAIN_LAUNCHES_PER_STEP.items():
            for label in runs:
                if launches[label][k] != n * AMP_STEPS:
                    raise AssertionError(
                        f"phase 28 {label}: {k} launched "
                        f"{launches[label][k]} times in {AMP_STEPS} steps")
        if not runs["plain"]["losses"] == runs["observed"]["losses"] \
                == runs["plain_after"]["losses"]:
            raise AssertionError("phase 28: the losses with the plane on "
                                 "are not bitwise the plain runs'")
        with open(timeline) as f:
            doc = json.load(f)
        events = doc["traceEvents"]
        threads = {e["tid"]: e["args"]["name"] for e in events
                   if e["ph"] == "M" and e["name"] == "thread_name"}
        runs_on = {threads[e["tid"]] for e in events
                   if e["ph"] == "X" and e["name"] == "executor.run"}
        n_runs = sum(e["ph"] == "X" and e["name"] == "executor.run"
                     for e in events)
        flight_track = sum(e["ph"] == "C" and e["name"] == "flight:train"
                           for e in events)
        if runs_on != {threading.current_thread().name} or \
                n_runs != AMP_STEPS or not flight_track:
            raise AssertionError(
                f"phase 28 timeline: executor.run on {runs_on} x{n_runs}, "
                f"{flight_track} flight:train samples")
        cap = runs["observed"]["xprof"]
        summary = cap.summary()
        names = []
        for w in cap.windows:
            seen = {e["name"] for e in attribution.device_events(w["trace"])}
            missing = [k for k, globs in TRAIN_KERNEL_GLOBALS.items()
                       if not any(g in n for g in globs for n in seen)]
            if missing:
                raise AssertionError(f"phase 28: window at step {w['step']} "
                                     f"misses {missing}")
            names.append(len(seen))
    if summary["windows"] < 2 or summary["measured"] != summary["windows"]:
        raise AssertionError(f"phase 28: xprof summary {summary}")
    reps = runs["observed"]["reports"]
    if len(reps) != 1 or reps[0]["steps"] != AMP_K:
        raise AssertionError(f"phase 28: reports {reps}")
    rep = reps[0]
    t, d = TRAIN_CONFIG["max_len"], TRAIN_CONFIG["d_model"]
    # phase 17's products: forward, dX and dW of every mul, and of the
    # attention's QK^T and PV (3 x 4BT^2d a layer)
    want = (3 * _forward_flops(main, TRAIN_BATCH * t)
            + 3 * 4 * TRAIN_BATCH * t * t * d * TRAIN_CONFIG["n_layers"])
    got = rep["flops"] / rep["steps"]
    if abs(got / want - 1) > 0.01:
        raise AssertionError(f"phase 28: report flops {got} against the "
                             f"count {want}")
    on_ms, off_ms = _split_window_ms(runs["observed"]["window_ms"],
                                     cap.windows)
    p50 = float(np.median(runs["plain"]["window_ms"]))
    p50_after = float(np.median(runs["plain_after"]["window_ms"]))
    p50_off = float(np.median(off_ms)) if off_ms else None
    roof = attribution.roofline(rep, measured_step_seconds=p50 / 1e3)
    e2e = {"plain_window_step_ms": runs["plain"]["window_ms"],
           "observed_window_step_ms": runs["observed"]["window_ms"],
           "plain_after_window_step_ms": runs["plain_after"]["window_ms"],
           "plain_step_ms_p50": p50, "plain_after_step_ms_p50": p50_after,
           "observed_uncaptured_step_ms_p50": p50_off,
           "observed_captured_step_ms": on_ms,
           "wall_s": {k: v["wall_s"] for k, v in runs.items()},
           "xprof": summary,
           "xprof_windows": [{"step": w["step"], "split": w["split"],
                              "start_s": w["start_s"],
                              "stop_s": w["stop_s"],
                              "device_kernel_names": n}
                             for w, n in zip(cap.windows, names)],
           "report": {k: rep[k] for k in ("flops", "bytes_accessed",
                                          "peak_bytes", "steps", "dtype",
                                          "device_name")},
           "flops_count": want, "roofline": roof,
           "timeline_events": len(events),
           "phase17_busy_share": (amp_e2e or {}).get("device_busy_share")}
    capture_s = [(round(w["start_s"], 3), round(w["stop_s"], 3))
                 for w in cap.windows]
    print(f"  ({smi}) losses bitwise with the plane on; step p50 plain "
          f"{p50:.3f} ms, plain after {p50_after:.3f} ms, observed outside "
          f"the capture windows {p50_off} ms, in them {on_ms} (capture "
          f"start and stop taken out: {capture_s} s)", flush=True)
    print(f"  ({smi}) report flops/step {got:.6g} (count {want:.6g}); "
          f"roofline at the p50: {json.dumps(roof)}", flush=True)
    print(f"  ({smi}) windows {json.dumps(summary)}; phase 17's busy share "
          f"{e2e['phase17_busy_share']}", flush=True)
    return {k: sum(run[k] for run in launches.values())
            for k in launches["plain"]}, e2e


def _obs_generate(ep, prompts, max_new, traces=None):
    """``prompts`` streamed over the wire from one thread each (under
    trace id ``traces[i]`` when given) -> ({i: tokens}, wall s)."""
    from paddle_tpu_torch.observability import trace
    from paddle_tpu_torch.serving import ServingClient
    out = {}

    def client(i):
        scope = (trace.scope(traces[i]) if traces
                 else contextlib.nullcontext())
        with scope, ServingClient(ep, timeout=FD_WIRE_TIMEOUT) as c:
            toks, final = [], None
            for line in c.generate_stream(prompts[i], model="lm",
                                          max_new_tokens=max_new):
                if "token" in line:
                    toks.append(line["token"])
                else:
                    final = line
            if final is None or final["tokens"] != toks:
                raise AssertionError(f"request {i}: the final line does not "
                                     "repeat the streamed tokens")
            out[i] = toks

    t0 = time.perf_counter()
    _run_threads(client, len(prompts))
    return out, time.perf_counter() - t0


def _step_ms_since(engine, t_wall):
    """Per-iteration ms of the engine's decode steps after ``t_wall``,
    from its flight ring."""
    recs = [r for r in engine.flight.records() if r["ts"] >= t_wall]
    return [r["step_s"] * 1e3 for a, r in zip(recs, recs[1:])
            if r["iteration"] > a["iteration"]]


def _observe_lm_dir(seed):
    """Phase 4's model as a servable artifact: phase 12's when this run
    wrote it (the same spec and seed), else written under build/observe.
    -> (dir, spec)."""
    import shutil
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import transformer as T
    spec = T.generation_spec(**FULL_WIDTH)
    fd = os.path.join(HERE, "build", "frontdoor", "lm")
    if seed == 0 and os.path.exists(os.path.join(fd, "__model__")) and \
            T.read_generation_spec(fd) == spec:
        return fd, spec
    d = os.path.join(HERE, "build", "observe", "lm")
    shutil.rmtree(d, ignore_errors=True)
    scope = Scope()
    for name, arr in T.random_params(spec, seed).items():
        scope.set(name, arr)
    T.save_generation_model(d, **FULL_WIDTH, scope=scope, init=False)
    return d, spec


def _kick_attribution(engine, timeout=60.0):
    """Call ``engine.stats()`` (which asks for the inter-token
    attribution) once all its slots are active, or at the timeout;
    -> the slots active then."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(s.active for s in engine._slots):
            break
        time.sleep(0.001)
    active = sum(s.active for s in engine._slots)
    engine.stats()
    return active


def observe_serving(smi, seed=0):
    """Phase 29: phase 4's model behind an InferenceServer, OBS_REQUESTS
    requests three times: a warm round submitted in process, whose first
    decode step with every slot active is profiled for the inter-token
    attribution, then streamed over TCP with the plane off, then on.  -> (launches of the last two rounds,
    results)."""
    import torch
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.observability import (SLOMonitor, TimeSeriesStore,
                                                attribution, default_registry,
                                                snapshot, timeline)
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import (InferenceServer, ModelRegistry,
                                          ServingClient, wait_for_port_file)
    print(f"phase 29: the {FULL_WIDTH['n_layers']}-layer "
          f"d{FULL_WIDTH['d_model']} LM (bf16, "
          f"{OBS_SLOTS} slots) behind an InferenceServer, {OBS_REQUESTS} "
          "streamed generate requests with the plane off, then on (span "
          "log, TimeSeriesStore, SLOMonitor)", flush=True)
    t0 = time.perf_counter()
    model_dir, spec = _observe_lm_dir(seed)
    reg = ModelRegistry()
    reg.load("lm", model_dir, precision="bf16",
             engine_opts={"max_batch_size": 1}, warmup=[],
             decode={"slots": OBS_SLOTS, "block_len": 16, "warmup": True})
    port_file = os.path.join(HERE, "build", "observe_port")
    server = InferenceServer(reg, port=0, port_file=port_file).start()
    ep = f"127.0.0.1:{wait_for_port_file(port_file, timeout=60)}"
    engine = reg.get("lm").decode
    torch.cuda.synchronize()
    print(f"  model saved, loaded and warm, serving on {ep}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(seed + 29)
    lens = rng.integers(OBS_PROMPT[0], OBS_PROMPT[1] + 1, OBS_REQUESTS)
    prompts = [rng.integers(0, spec["vocab"], n).tolist() for n in lens]
    traces = [f"{0x29000000 + i:016x}" for i in range(OBS_REQUESTS)]
    store = slo = None
    try:
        # a warm round, submitted in process so that every slot is busy
        # at once; then stats() asks for the inter-token attribution, and
        # the engine profiles its next step
        handles = [engine.submit(p, OBS_NEW) for p in prompts]
        attr_slots = _kick_attribution(engine)
        for h in handles:
            h.result(timeout=600)
        attr = engine.stats()["inter_token_attribution"]
        K.reset_launches()
        t_off = time.time()
        off, wall_off = _obs_generate(ep, prompts, OBS_NEW)
        steps_off = _step_ms_since(engine, t_off)
        profiler.start_profiler()
        store = TimeSeriesStore(default_registry(), interval_s=0.25).start()
        slo = SLOMonitor(store, p99_ms=OBS_TTFT_P99_MS,
                         latency_family="decode_ttft_seconds")
        t_on = time.time()
        on, wall_on = _obs_generate(ep, prompts, OBS_NEW, traces)
        steps_on = _step_ms_since(engine, t_on)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in K.KERNELS}
        store.stop(final_sample=True)
        with ServingClient(ep, timeout=60) as c:
            summary = c.inspect()
            doc = c.trace(traces[0])
        stats = engine.stats()
        gauges = {name: body["series"] for name, body in snapshot().items()
                  if name.startswith("slo_")}
        profiler.stop_profiler(quiet=True)
    finally:
        if slo is not None:
            slo.close()
        if store is not None:
            store.stop()
        profiler.stop_profiler(quiet=True)
        server.stop()
        reg.close()
    bad = [i for i in range(OBS_REQUESTS) if on[i] != off[i]]
    if bad:
        raise AssertionError(f"phase 29: streams {bad} differ with the "
                             "plane on")
    for name in OBS_SERVE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"phase 29: {name} never launched")
    decode_reps = [r for r in summary["programs"]
                   if r["layer"] == "predictor" and "kv_index" in r["feed_sig"]
                   and "kv_len" not in r["feed_sig"]]
    if not decode_reps:
        raise AssertionError("phase 29: inspect lists no decode report")
    spans = doc["processes"][0]["spans"]
    span_names = {s["name"] for s in spans}
    want_spans = {"serving.request", "decode.prefill", "decode.step"}
    if not want_spans <= span_names or \
            any(traces[0] not in s["trace"] for s in spans):
        raise AssertionError(f"phase 29: trace spans {span_names}")
    stitched = timeline.stitch_processes(doc["processes"])
    flows = sum(e["ph"] in ("s", "t", "f") for e in stitched["traceEvents"])
    if not flows:
        raise AssertionError("phase 29: the stitched trace has no flows")
    if attr is None:
        raise AssertionError(f"phase 29: no inter-token attribution "
                             f"({engine._attr_error})")
    total = sum(attr[k] for k in ("gather", "write", "attention", "kernel",
                                  "other"))
    if abs(total - 1) > 1e-3 or "paged_split_kernel" not in \
            attr.get("kernels_us", {}):
        raise AssertionError(f"phase 29: attribution {attr}")
    if stats["pool_copy_bytes_per_token"] != 0:
        raise AssertionError(f"phase 29: pool copy bytes "
                             f"{stats['pool_copy_bytes_per_token']}")
    want_gauges = {"slo_objective_target", "slo_observed",
                   "slo_error_budget_burn_rate", "slo_breach"}
    if set(gauges) != want_gauges or not all(
            "objective=latency_p99" in g for g in gauges.values()):
        raise AssertionError(f"phase 29: SLO gauges {gauges}")
    if not decode_reps[-1]["peak_bytes"] > 0:
        # the report's peak is argument + output + temp - alias bytes,
        # never 0 for a program that reads weights
        raise AssertionError(f"phase 29: decode report peak "
                             f"{decode_reps[-1]['peak_bytes']}")
    n_tok = OBS_REQUESTS * OBS_NEW
    e2e = {"tokens_per_s_off": n_tok / wall_off,
           "tokens_per_s_on": n_tok / wall_on,
           "step_ms_p50_off": float(np.median(steps_off)),
           "step_ms_p50_on": float(np.median(steps_on)),
           "steps_off": len(steps_off), "steps_on": len(steps_on),
           "inter_token_attribution": attr,
           "attribution_slots_active": attr_slots,

           "decode_report": {k: decode_reps[-1][k] for k in (
               "flops", "bytes_accessed", "peak_bytes", "dtype",
               "device_name")},
           "trace_spans": len(spans), "stitched_flow_events": flows,
           "slo": gauges, "pool_copy_bytes_per_token": 0,
           "spans_dropped": profiler.dropped_spans()}
    print(f"  ({smi}) plane off: {e2e['tokens_per_s_off']:.1f} tokens/s, "
          f"step p50 {e2e['step_ms_p50_off']:.3f} ms; plane on: "
          f"{e2e['tokens_per_s_on']:.1f} tokens/s, step p50 "
          f"{e2e['step_ms_p50_on']:.3f} ms; streams equal", flush=True)
    print(f"  ({smi}) inter-token attribution {json.dumps(attr)}; set it "
          "beside phase 4's profiled step by group (PERF.md section 5)",
          flush=True)
    print(f"  decode report {json.dumps(e2e['decode_report'])}; trace "
          f"{len(spans)} spans, {flows} flow events; SLO {json.dumps(gauges)}",
          flush=True)
    return launches, e2e


def observe_ab(smi):
    """``--observe``: phases 28 and 29 alone, after building their
    kernels."""
    from paddle_tpu_torch.ops import _build
    _build.build_all(("flash_attention", "flash_attention_bwd",
                      "layer_norm", "layer_norm_bwd", "softmax_xent",
                      "paged_attention"))
    train_launches, train_e2e = observe_train(smi)
    serve_launches, serve_e2e = observe_serving(smi)
    return {"observe_training": dict(train_e2e, launches=train_launches),
            "observe_serving": dict(serve_e2e, launches=serve_launches)}


def seq2seq_phases(smi, recs=None):
    """Phases 19 and 20 (with ``recs``, the kernels' records, their
    seq2seq launches are added there) -> (training launches, generation
    launches, end-to-end numbers)."""
    print(f"phase 19: seq2seq attention NMT {S2S_CONFIG} (bench.py "
          f"bench_seq2seq) at batch {S2S_BATCH}, T {S2S_T}, program.amp, "
          "Adam, through seq_to_seq_net + Executor.run", flush=True)
    train_launches, train_e2e, state = train_seq2seq()
    print(f"  end to end ({smi}): {json.dumps(train_e2e)}", flush=True)
    print(f"  one f32 step at batch {S2S_CPU_BATCH}, ragged lengths, card "
          "against CPU", flush=True)
    train_e2e["card_vs_cpu"] = s2s_card_vs_cpu(state)
    print(f"phase 20: seq_to_seq_generate at batch {S2S_GEN_BATCH}, beam "
          f"{S2S_BEAM}, max_length {S2S_MAX_LEN} (bench.py:1042-1060), the "
          "training parameters by name, card against CPU", flush=True)
    gen_launches, gen_e2e = generate_seq2seq(state)
    print(f"  end to end ({smi}): {json.dumps(gen_e2e)}", flush=True)
    if recs is not None:
        for name in ("lstm_fwd", "lstm_bwd", "softmax_xent_fwd",
                     "softmax_xent_bwd"):
            recs[name]["launches_seq2seq_training"] = train_launches[name]
            recs[name]["launches_seq2seq_generation"] = gen_launches[name]
    return train_launches, gen_launches, {"training": train_e2e,
                                          "generation": gen_e2e}


def seq2seq_ab(smi):
    """``--seq2seq``: phase 3 at the seq2seq path's shapes, then phases 19
    and 20 alone (their kernel rows read here, not late in the full
    smoke, where `_device_ms` reads low)."""
    from paddle_tpu_torch.ops import _build
    _build.build_all(("lstm", "softmax_xent"))
    recs = {n: {} for n in ("lstm_fwd", "lstm_bwd", "softmax_xent_fwd",
                            "softmax_xent_bwd")}
    check_seq2seq_kernels(recs)
    _, _, e2e = seq2seq_phases(smi, recs)
    recs["seq2seq"] = e2e
    return recs


def genprog_phase(smi):
    """Phase 22 with its heading and end-to-end line -> (launches of the
    two Program engine runs, results)."""
    print(f"phase 22: the generation Programs of the {FULL_WIDTH['n_layers']}"
          "-layer d768 LM through DecodeEngine(scope, spec): bf16 fast "
          "against the TransformerLM engine, f32 exact against the "
          "full-recompute program", flush=True)
    launches, e2e = generation_programs()
    print(f"  end to end ({smi}): {json.dumps(e2e)}", flush=True)
    return launches, e2e


def genprog_ab(smi):
    """``--genprog``: phase 22 alone, after building its four kernels."""
    from paddle_tpu_torch.ops import _build
    _build.build_all(("paged_attention", "flash_attention", "layer_norm",
                      "row_stable_mm"))
    launches, e2e = genprog_phase(smi)
    return {"genprog": dict(e2e, launches={
        k: launches[k] for k in set(GP_KERNELS["fast"])
        | set(GP_KERNELS["exact"])})}


def serving_ab(smi):
    """``--serving``: only the serving path's kernels and phase 4 (paged
    attention and LayerNorm against their plain versions with their
    times, then serving with its decode-step profile)."""
    from paddle_tpu_torch.ops import _build
    _build.build_all(("paged_attention", "flash_attention", "layer_norm"))
    recs = {"paged_attention": {}, "layer_norm_fwd": {}}
    check_paged_attention(recs["paged_attention"])
    check_layer_norm(recs["layer_norm_fwd"])
    recs["serving"] = serve()[1]
    return recs


def resnet_ab(smi):
    """``--resnet``: the BatchNorm backward's phase 3 checks and timings,
    then phase 7 (ResNet-50 training with its profile)."""
    from paddle_tpu_torch.ops import _build
    _build.build_all(("batch_norm_bwd",))
    recs = {"batch_norm_bwd": {}}
    check_batch_norm_bwd(recs["batch_norm_bwd"])
    launches, recs["resnet"], _ = train_resnet()
    recs["resnet"]["batch_norm_bwd_launches"] = launches["batch_norm_bwd"]
    return recs


def lstm_ab(smi):
    """``--lstm``: the recurrent kernels' phase 3 checks and timings (the
    GRU's too: they share recurrent.cuh), then phases 9 and 10 (the
    stacked LSTM and the GRU classifier, each with its profile)."""
    from paddle_tpu_torch.ops import _build
    _build.build_all(("lstm", "gru"))
    recs = {k: {} for k in ("lstm_fwd", "lstm_bwd", "gru_fwd", "gru_bwd")}
    for kind in ("lstm", "gru"):
        check_recurrent(kind, recs[f"{kind}_fwd"], recs[f"{kind}_bwd"],
                        strict=False)
    for phase, model, key in ((9, "lstm", "stacked_lstm"),
                              (10, "gru", "gru_classifier")):
        print(f"phase {phase}: {model}", flush=True)
        launches, recs[key], _ = train_sequence(model)
        recs[key]["launches"] = {k: launches[k]
                                 for k in (f"{model}_fwd", f"{model}_bwd")}
    return recs


def frontdoor_ab(smi):
    """``--frontdoor``: phase 12 only (the serving front door over TCP),
    after building the three serving kernels."""
    from paddle_tpu_torch.ops import _build
    _build.build_all(("paged_attention", "flash_attention", "layer_norm"))
    return {"frontdoor": frontdoor()[1]}


def decode_modes_ab(smi):
    """``--decode-modes``: the row-stable product's phase 3 checks and
    timings, then phase 13 (exact and int8 decode, the hot-row cache and
    live deltas)."""
    from paddle_tpu_torch.ops import _build
    _build.build_all(("paged_attention", "flash_attention", "layer_norm",
                      "row_stable_mm"))
    recs = {"row_stable_mm": {}}
    check_row_stable_mm(recs["row_stable_mm"])
    recs["decode_modes"] = decode_modes()[1]
    return recs


def xent_ab(smi):
    """``--xent``: the softmax cross-entropy kernels' phase 3 checks and
    timings only (XENT_CASES; XENT_TIMED in f32 and bf16)."""
    from paddle_tpu_torch.ops import _build
    _build.build_all(("softmax_xent",))
    recs = {"softmax_xent_fwd": {}, "softmax_xent_bwd": {}}
    check_softmax_xent(recs["softmax_xent_fwd"], recs["softmax_xent_bwd"])
    return recs


def ln_ab(smi):
    """``--ln``: the LayerNorm forward and backward kernels' phase 3
    checks and timings only."""
    from paddle_tpu_torch.ops import _build
    _build.build_all(("layer_norm", "layer_norm_bwd"))
    recs = {"layer_norm_fwd": {}, "layer_norm_bwd": {}}
    check_layer_norm(recs["layer_norm_fwd"])
    check_layer_norm_bwd(recs["layer_norm_bwd"])
    return recs


def image_phases(smi):
    """Phases 14-16: VGG-16 training, VGG-16 card against CPU and LeNet-5
    training, every op rule on the card against the CPU.  Returns the
    kernel launches of VGG-16's and LeNet-5's steps."""
    print(f"phase 14: VGG-16 bn_drop {VGG_CONFIG} at batch {VGG_BATCH}, "
          "NCHW, program.amp, Adam, through vgg16_bn_drop + Executor.run",
          flush=True)
    vgg_launches, vgg_e2e, state = train_image("vgg")
    print(f"  end to end ({smi}): {json.dumps(vgg_e2e)}", flush=True)
    print(f"phase 15: VGG-16 in f32 at batch {VGG_CPU_BATCH}, dropout 0, "
          "card against CPU; then LeNet-5 "
          f"{LENET_CONFIG} at batch {LENET_BATCH}, program.amp, Adam",
          flush=True)
    vgg_card_vs_cpu(state)
    del state
    lenet_launches, lenet_e2e, _ = train_image("lenet")
    print(f"  end to end ({smi}): {json.dumps(lenet_e2e)}", flush=True)
    print("phase 16: every op rule on the card against the CPU", flush=True)
    print(f"  {json.dumps(op_rules_card_vs_cpu())}", flush=True)
    return vgg_launches, lenet_launches


def amp_train_ab(smi):
    """``--amp-train``: the six training kernels at phase 17's bf16
    shapes, then phase 17 (the amp LM through train_loop with its
    checkpoint, resume and skip)."""
    from paddle_tpu_torch.ops import _build
    _build.build_all(("flash_attention", "flash_attention_bwd",
                      "layer_norm", "layer_norm_bwd", "softmax_xent"))
    recs = {n: {} for n in TRAIN_KERNEL_WRAPPERS}
    check_amp_training_shapes(recs)
    launches, e2e = amp_train(smi)
    for n in TRAIN_KERNEL_WRAPPERS:
        recs[n]["launches_amp_training"] = launches[n]
    recs["amp_training"] = e2e
    return recs


def vgg_ab(smi):
    """``--vgg``: the BatchNorm backward's phase 3 checks and timings
    (VGG-16's NCHW launches among them), then phases 14-16."""
    from paddle_tpu_torch.ops import _build, kernels as K
    # phase 16 runs every kernel's rule
    _build.build_all(k.source for k in K.KERNELS)
    recs = {"batch_norm_bwd": {}}
    check_batch_norm_bwd(recs["batch_norm_bwd"])
    vgg_launches, _ = image_phases(smi)
    recs["batch_norm_bwd"]["launches_vgg_training"] = vgg_launches[
        "batch_norm_bwd"]
    return recs


def vgg_f32_anatomy(smi):
    """``--vgg-f32``: phase 14's training, then phase 15's f32 check
    with its anatomy: the card's step also with cuDNN off and with the
    BatchNorm backward's plain version on the card."""
    from paddle_tpu_torch.ops import _build, kernels as K
    _build.build_all([K.BATCH_NORM_BWD.source])
    _, _, state = train_image("vgg")
    return vgg_card_vs_cpu(state, anatomy=True)


#: the A/B modes: option -> what it runs.  Each prints its results as one
#: JSON line and no {"ok": ...} line: run from two checkouts in turns
#: (parent, change, change, parent), it compares two versions of those
#: kernels on one card
# ---------------------------------------------------------------------------
# phases 30-31: the serving fleet and its control plane
# ---------------------------------------------------------------------------

FLEET_SLOTS, FLEET_REQUESTS, FLEET_NEW, FLEET_PROMPT = 16, 48, 64, (8, 1024)
FLEET_CLIENTS, FLEET_BURST, FLEET_KILL_AFTER = 8, 16, 8
FLEET_HEALTH = 0.5
FLEET_BOOT_TIMEOUT = 300.0
FLEET_KERNELS = ("paged_attention", "flash_attention_fwd", "layer_norm_fwd")
#: the kernel each spawned replica's inter-token attribution must name
FLEET_ATTRIBUTED = "paged_split_kernel"
#: a replica of phases 30-31: ``serve`` on the card (its default device)
FLEET_REPLICA_ARGS = ("--precision", "bf16", "--decode-slots",
                      str(FLEET_SLOTS), "--profile")
#: phase 31a: checkpoint step 2 is every parameter times (1 + ROLL_NOISE
#: N(0, 1)), seeded (not trained weights); the load generator replays
#: ROLL_WINDOW_S windows of ROLL_RPS generates of ROLL_NEW tokens until
#: the roll is done
ROLL_NOISE, ROLL_NEW, ROLL_PROMPT = 1e-2, 16, 32
ROLL_RPS, ROLL_WINDOW_S = 6.0, 4.0
#: phase 31b: one build_schedule trace (low rate, an x8 burst, low rate
#: again, then idle) replayed at AUTOSCALE_TIME_SCALE against
#: ``fleet --autoscale AUTOSCALE_SPEC`` (16-token generates)
AUTOSCALE_PHASES = (
    {"duration_s": 6.0, "rps": 2.0, "generate_fraction": 1.0},
    {"duration_s": 64.0, "rps": 2.0, "burst_x": 8.0,
     "generate_fraction": 1.0},
    {"duration_s": 6.0, "rps": 2.0, "generate_fraction": 1.0})
AUTOSCALE_TIME_SCALE = 0.5
AUTOSCALE_P99_MS = 2000.0
AUTOSCALE_SPEC = (f"min=1,max=2,slo=p99_ms={AUTOSCALE_P99_MS:g},"
                  "queue_high=2,window_s=2,idle_s=2,cooldown_up_s=2,"
                  "cooldown_down_s=8")


def _fleet_lm_dir(seed, name):
    """A copy of phase 4's model as a servable artifact under
    build/fleet/<name> (the watcher republishes into it)."""
    import shutil
    src, spec = _observe_lm_dir(seed)
    d = os.path.join(HERE, "build", "fleet", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, d)
    return d, spec


def _fleet_env():
    return dict(os.environ, PYTHONPATH=HERE + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def _fleet_generate(ep, prompts, order, on_token=None):
    """Streams ``prompts[i]`` for i in ``order`` from FLEET_CLIENTS
    threads over the wire -> ({i: (tokens, ttft s)}, wall s).  Every
    stream's done line must repeat its relayed tokens; ``on_token(i,
    n)`` sees each stream's n-th relayed token."""
    from paddle_tpu_torch.serving import ServingClient
    out = {}

    def client(t):
        with ServingClient(ep, timeout=FD_WIRE_TIMEOUT) as c:
            for i in order[t::FLEET_CLIENTS]:
                t0, ttft, toks, final = time.perf_counter(), None, [], None
                for line in c.generate_stream(prompts[i],
                                              max_new_tokens=FLEET_NEW):
                    if "token" in line:
                        if ttft is None:
                            ttft = time.perf_counter() - t0
                        toks.append(line["token"])
                        if on_token is not None:
                            on_token(i, len(toks))
                    else:
                        final = line
                if final is None or final["tokens"] != toks:
                    raise AssertionError(f"stream {i}: the done line does "
                                         "not repeat the relayed tokens")
                out[i] = (toks, ttft)

    t0 = time.perf_counter()
    _run_threads(client, FLEET_CLIENTS)
    return out, time.perf_counter() - t0


def _round_numbers(results, wall):
    n_tok = sum(len(t) for t, _ in results.values())
    return {"streams": len(results), "tokens": n_tok,
            "tokens_per_s": n_tok / wall, "wall_s": wall,
            "ttft_ms": _pct([ttft for _, ttft in results.values()])}


def _replica_reading(endpoint, tokens_len):
    """One spawned replica incarnation over the wire: its longest decode
    step and step count from the ``decode.default`` flight ring (the
    ``trace`` verb of a ``--profile`` replica returns it), its stats
    page's step ms, its inter-token attribution's kernels, and its
    ``sample_device_memory`` reading after one infer."""
    from paddle_tpu_torch.observability import parse_series_key
    from paddle_tpu_torch.serving import ServingClient
    with ServingClient(endpoint, timeout=FD_WIRE_TIMEOUT) as c:
        doc = c.raw_call({"method": "trace"})["trace"]   # every span
        st = c.stats()
        c.infer({"tokens": np.zeros((1, tokens_len), np.int64)})
        mem = c.metrics(format="json").get(
            "executor_device_memory_bytes", {}).get("series", {})
    recs = sorted((r for p in doc["processes"]
                   for r in p.get("flight", {}).get("decode.default", ())),
                  key=lambda r: r["ts"])
    steps, prev = [], 0
    for r in recs:              # a record past the last count ran a step
        if r["iteration"] > prev:
            steps.append(r["step_s"] * 1e3)
        prev = r["iteration"]
    attr = (st.get("decode") or {}).get("inter_token_attribution") or {}
    return {"decode_steps_in_ring": len(steps),
            "first_step_ms": steps[0] if steps else None,
            "longest_step_ms": max(steps) if steps else None,
            "step_ms": (st.get("decode") or {}).get("step_ms"),
            "attribution_kernels_us": attr.get("kernels_us"),
            "device_memory_bytes": {parse_series_key(k)[0]["device"]:
                                    int(v) for k, v in mem.items()}}


def _readings(endpoints, tokens_len):
    """`_replica_reading` of each endpoint, at once -> list."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(endpoints)) as pool:
        return list(pool.map(lambda ep: _replica_reading(ep, tokens_len),
                             endpoints))


class _StateWatch:
    """Polls one replica's health state every 20 ms from the moment of a
    kill: -> seconds to EJECTED and to HEALTHY again (its restart)."""

    def __init__(self, rep):
        import threading
        self.rep, self.t_kill = rep, time.monotonic()
        self.ejected_s = self.readmitted_s = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(0.02):
            dt = time.monotonic() - self.t_kill
            if self.ejected_s is None and self.rep.state == "ejected":
                self.ejected_s = dt
            if self.ejected_s is not None and self.rep.restarts > 0 and \
                    self.rep.state == "healthy":
                self.readmitted_s = dt
                return

    def stop(self):
        self._thread.join(2)        # a last poll sees the readmission
        self._stop.set()
        self._thread.join(5)


_TRACE_CLIENT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from paddle_tpu_torch import profiler
from paddle_tpu_torch.observability import timeline, trace
from paddle_tpu_torch.serving import ServingClient
ep, prompt = sys.argv[2], json.loads(sys.argv[3])
profiler.start_profiler()
out = {"attempts": 0}
with ServingClient(ep, timeout=120) as c:
    while out["attempts"] < 12:
        out["attempts"] += 1
        tid = trace.new_trace_id()
        with trace.scope(tid), profiler.record_block("client.request"):
            lines = list(c.generate_stream(prompt, max_new_tokens=4))
        procs = c.trace(tid)["processes"] + [
            timeline.process_trace_doc(tid, role="client")]
        pids = {p["pid"] for p in procs if p["spans"]}
        if len(pids) < 3:
            continue
        events = timeline.stitch_processes(procs)["traceEvents"]
        flows = [e for e in events if e.get("id") == tid
                 and e["ph"] in ("s", "t", "f")]
        out.update(trace=tid, processes=len(pids),
                   roles=sorted(p["role"] for p in procs if p["spans"]),
                   spans=sorted({s["name"] for p in procs
                                 for s in p["spans"]}),
                   flow_pids=len({e["pid"] for e in flows}),
                   flow_phases=sorted({e["ph"] for e in flows}))
        break
print(json.dumps(out))
"""


def fleet_phase(smi, seed=0):
    """Phase 30: two spawned ``serve`` replicas of phase 4's LM on the
    card and one adopted in-process replica behind a `FleetFrontend`;
    FLEET_REQUESTS streams to the in-process server alone (the
    reference), then through the frontend, then again with the busiest
    spawned replica SIGKILLed mid-stream and a follow-up burst once it
    is back.  -> (launches of the in-process replica over rounds 2-3 and
    the burst, results, state for phase 31)."""
    import shutil
    import signal
    import torch
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import (FleetFrontend, InferenceServer,
                                          ModelRegistry)
    print(f"phase 30: the serving fleet: 2 spawned `serve` replicas of the "
          f"{FULL_WIDTH['n_layers']}-layer d{FULL_WIDTH['d_model']} LM "
          f"(bf16, {FLEET_SLOTS} slots, on the card) + 1 adopted in-process "
          f"replica behind a FleetFrontend; {FLEET_REQUESTS} streams alone, "
          "through the fleet, and across a SIGKILL", flush=True)
    t_phase = time.perf_counter()
    times = {}
    torch.cuda.empty_cache()
    model_dir, spec = _fleet_lm_dir(seed, "lm")
    times["model_dir_s"] = time.perf_counter() - t_phase
    kernels_before = _built_kernels()
    run_dir = os.path.join(HERE, "build", "fleet", "run")
    shutil.rmtree(run_dir, ignore_errors=True)
    profiler.start_profiler()       # the frontend's spans
    reg = ModelRegistry()
    reg.load("default", model_dir, precision="bf16", warmup=[],
             decode={"slots": FLEET_SLOTS, "block_len": 16, "warmup": True})
    server = InferenceServer(reg, port=0, port_file="").start()
    local_ep = f"127.0.0.1:{server.port}"
    t_spawn = time.perf_counter()
    times["in_process_load_s"] = t_spawn - t_phase - times["model_dir_s"]
    fleet = FleetFrontend(
        [("default", model_dir)], replicas=2, replica_endpoints=[local_ep],
        run_dir=run_dir, spawn_env=_fleet_env(),
        replica_args=FLEET_REPLICA_ARGS, health_interval=FLEET_HEALTH,
        spawn_timeout=FLEET_BOOT_TIMEOUT, request_timeout=FD_WIRE_TIMEOUT,
        route_timeout=FD_WIRE_TIMEOUT).start()
    state = {"fleet": fleet, "server": server, "reg": reg,
             "model_dir": model_dir, "spec": spec}
    try:
        fleet.wait_ready(timeout=FLEET_BOOT_TIMEOUT)
        boot_s = time.perf_counter() - t_spawn
        ep = f"127.0.0.1:{fleet.port}"
        print(f"  3 replicas healthy {boot_s:.1f} s after the spawn "
              f"(model copied, in-process replica warm); frontend {ep}",
              flush=True)
        rng = np.random.default_rng(seed + 30)
        lens = rng.integers(FLEET_PROMPT[0], FLEET_PROMPT[1] + 1,
                            FLEET_REQUESTS)
        prompts = [rng.integers(0, spec["vocab"], n).tolist() for n in lens]
        order = list(range(FLEET_REQUESTS))
        t0 = time.perf_counter()
        ref, wall1 = _fleet_generate(local_ep, prompts, order)
        rounds = {"alone": _round_numbers(ref, wall1)}

        K.reset_launches()
        r2, wall2 = _fleet_generate(ep, prompts, order)
        rounds["fleet"] = _round_numbers(r2, wall2)
        suspect = sum(int(s.value) for lab, s
                      in fleet._m_transitions.items()
                      if lab["to"] in ("suspect", "ejected"))
        spawned = [r for r in fleet.replicas if r.owned]
        incarnations = {r.name: [reading] for r, reading in zip(
            spawned, _readings([r.endpoint for r in spawned],
                               spec["max_len"]))}

        victim, watch = [], []

        def kill_busiest(i, n):
            if i == 0 and n == FLEET_KILL_AFTER and not victim:
                rep = max(spawned, key=lambda r: r.inflight)
                os.kill(rep.proc.pid, signal.SIGKILL)
                victim.append(rep)
                watch.append(_StateWatch(rep))

        times["rounds_1_2_s"] = time.perf_counter() - t0
        retries0 = int(fleet._m_retries.value)
        t0 = time.perf_counter()
        r3, wall3 = _fleet_generate(ep, prompts, order, kill_busiest)
        rounds["chaos"] = _round_numbers(r3, wall3)
        if not victim:
            raise AssertionError("phase 30: stream 0 never reached the "
                                 "kill point")
        victim = victim[0]
        fleet.wait_ready(timeout=FLEET_BOOT_TIMEOUT)
        watch[0].stop()
        times["round_3_and_restart_s"] = time.perf_counter() - t0
        fwd_before = victim.forwarded
        burst, wall4 = _fleet_generate(ep, prompts, order[:FLEET_BURST])
        rounds["burst"] = _round_numbers(burst, wall4)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in K.KERNELS}
        t0 = time.perf_counter()
        # phase 31's autoscaled fleet boots while this phase checks
        state["autoscale"] = _start_autoscale_fleet(seed)
        retries = int(fleet._m_retries.value) - retries0

        for label, res, want in (("fleet", r2, order), ("chaos", r3, order),
                                 ("burst", burst, order[:FLEET_BURST])):
            bad = [i for i in want if i not in res or res[i][0] != ref[i][0]]
            if bad:
                raise AssertionError(f"phase 30 {label}: streams {bad[:8]} "
                                     "missing or unequal to the single "
                                     "server's")
        if retries < 1 or victim.restarts < 1:
            raise AssertionError(f"phase 30: retries {retries}, victim "
                                 f"{victim.describe()}")
        if victim.forwarded <= fwd_before:
            raise AssertionError("phase 30: the restarted replica took no "
                                 f"traffic in the burst: "
                                 f"{[r.describe() for r in fleet.replicas]}")
        for name in FLEET_KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f"phase 30: {name} never launched in "
                                     "the adopted replica")
        for name, readings in incarnations.items():
            for r in readings:
                kernels = r["attribution_kernels_us"] or {}
                if FLEET_ATTRIBUTED and FLEET_ATTRIBUTED not in kernels:
                    raise AssertionError(
                        f"phase 30: replica {name}'s attribution names no "
                        f"port kernel: {r['attribution_kernels_us']}")

        snap = fleet.metrics_snapshot()
        series = snap.get("decode_tokens_total", {}).get("series", {})
        labels = {p.split("=", 1)[1] for k in series for p in k.split(",")
                  if p.startswith("replica=")}
        if not {"r0", "r1", "r2", "fleet"} <= labels:
            raise AssertionError(f"phase 30: merged metrics replicas "
                                 f"{sorted(labels)}")
        # the traced client and `top`, each in a process of its own, at once
        trace, top = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=HERE) for cmd in (
                [sys.executable, "-c", _TRACE_CLIENT, HERE, ep,
                 json.dumps(prompts[1][:64])],
                [sys.executable, "-m", "paddle_tpu_torch", "top", ep,
                 "--iterations", "1"]))
        incarnations[victim.name] += _readings([victim.endpoint],
                                               spec["max_len"])
        trace_out, trace_err = trace.communicate(timeout=300)
        top_out, top_err = top.communicate(timeout=300)
        tdoc = json.loads(trace_out.strip().splitlines()[-1]) \
            if trace.returncode == 0 else {"error": trace_err[-2000:]}
        if tdoc.get("processes", 0) < 3 or tdoc.get("flow_pids", 0) < 3 \
                or tdoc.get("flow_phases") != ["f", "s", "t"]:
            raise AssertionError(f"phase 30: stitched trace {tdoc}")
        rows = [ln for ln in top_out.splitlines()
                if ln.strip().startswith(("r0 ", "r1 ", "r2 "))]
        if top.returncode != 0 or len(rows) != 3:
            raise AssertionError(f"phase 30: top rendered {rows}: "
                                 f"{top_out}{top_err[-2000:]}")
        print("\n".join("  | " + ln for ln in top_out.splitlines()),
              flush=True)
        built = _built_kernels()
        logs = "".join(open(os.path.join(run_dir, f), errors="replace").read()
                       for f in os.listdir(run_dir) if f.endswith(".log"))
        replica_built = built != kernels_before or "ptxas" in logs \
            or "nvcc" in logs
        if replica_built:
            raise AssertionError("phase 30: a replica built kernels: "
                                 f"{sorted(set(built) - set(kernels_before))}")
        e2e = {"rounds": rounds, "retries": retries,
               "suspect_or_ejected_before_kill": suspect,
               "victim": victim.name,
               "kill_to_ejected_s": watch[0].ejected_s,
               "kill_to_readmitted_s": watch[0].readmitted_s,
               "forwarded": {r.name: r.forwarded for r in fleet.replicas},
               "incarnations": incarnations, "boot_s": boot_s,
               "trace": tdoc, "replica_built_kernels": replica_built}
        times["checks_s"] = time.perf_counter() - t0
        e2e.update(times=times, phase_s=time.perf_counter() - t_phase)
        state.update(prompts=prompts, ref=ref)
    except BaseException:
        _stop_fleet(state)
        raise
    for label, r in rounds.items():
        print(f"  ({smi}) {label}: {r['streams']} streams, "
              f"{r['tokens_per_s']:.1f} tokens/s, TTFT ms p50 "
              f"{r['ttft_ms']['p50']:.1f} p99 {r['ttft_ms']['p99']:.1f}",
              flush=True)
    print(f"  ({smi}) SIGKILL of {victim.name}: ejected after "
          f"{watch[0].ejected_s} s, readmitted after "
          f"{watch[0].readmitted_s} s; retries {retries}; forwarded "
          f"{e2e['forwarded']}; every stream bitwise the single server's",
          flush=True)
    for name, readings in incarnations.items():
        for k, r in enumerate(readings):
            print(f"  ({smi}) {name} incarnation {k + 1}: longest decode "
                  f"step {r['longest_step_ms']} ms of "
                  f"{r['decode_steps_in_ring']} (the first "
                  f"{r['first_step_ms']} ms; step ms "
                  f"{r['step_ms']}); "
                  f"device memory {r['device_memory_bytes']}; kernels "
                  f"{sorted(r['attribution_kernels_us'] or {})}",
                  flush=True)
    print(f"  trace {tdoc['trace']}: {tdoc['processes']} processes "
          f"{tdoc['roles']}; no replica built a kernel; phase "
          f"{e2e['phase_s']:.1f} s {json.dumps(times)}", flush=True)
    return launches, e2e, state


def _built_kernels():
    """The files of the kernels' build directory."""
    from paddle_tpu_torch.ops import _build
    return sorted(os.listdir(_build.BUILD_DIR)) \
        if os.path.isdir(_build.BUILD_DIR) else []


def _serve_pids(model_dir):
    """Live ``serve`` processes of ``model_dir``, read from
    /proc/<pid>/cmdline: a replica no frontend tracks shows here too."""
    want = os.path.abspath(model_dir).encode()
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if b"serve" in argv and want in argv:
            out.append(int(d))
    return out


def _stop_cli_fleet(proc):
    """SIGTERM a ``fleet`` process, which then stops its replicas;
    SIGKILL its process group after 60 s."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait(30)


def _stop_fleet(state):
    """Stop what phase 30 started: the frontend (and its spawned
    replicas), the in-process server and registry, the span log, and
    phase 31's autoscaled fleet if phase 31 never took it; -> whether
    every replica process of phase 30 is gone."""
    from paddle_tpu_torch import profiler
    fleet = state.pop("fleet", None)
    procs = []
    if fleet is not None:
        fleet.stop(grace=30.0)
        procs = [r.proc for r in fleet.replicas if r.proc is not None]
    for key in ("server", "reg"):
        obj = state.pop(key, None)
        if obj is not None:
            obj.stop() if key == "server" else obj.close()
    b = state.pop("autoscale", None)
    if b is not None:
        _stop_cli_fleet(b[0])
    profiler.stop_profiler(quiet=True)
    return all(p.poll() is not None for p in procs) and \
        not _serve_pids(state["model_dir"])


def _roll_load(ep, prompt, stop):
    """LoadGenerator windows of ROLL_WINDOW_S at ROLL_RPS (16-token
    generates, client retries on) until ``stop`` is set -> summed
    report."""
    from paddle_tpu_torch.fleet_control import LoadGenerator, build_schedule
    total = {"offered": 0, "ok": 0, "shed": 0, "errors": 0, "windows": 0}
    k = 0
    while not stop.is_set():
        sched = build_schedule([{"duration_s": ROLL_WINDOW_S,
                                 "rps": ROLL_RPS, "generate_fraction": 1.0}],
                               seed=310 + k)
        rep = LoadGenerator(ep, sched, feed={}, generate_model="default",
                            generate_prompt=prompt,
                            max_new_tokens=ROLL_NEW, retries=3,
                            timeout=FD_WIRE_TIMEOUT).run()
        for key in ("offered", "ok", "shed", "errors"):
            total[key] += rep[key]
        total["windows"] += 1
        k += 1
    return total


def _start_autoscale_fleet(seed):
    """``fleet --autoscale`` over its own copy of the model -> (process,
    port file, start time, model dir)."""
    model_dir = _fleet_lm_dir(seed, "lm_autoscale")[0]
    port_file = os.path.join(HERE, "build", "fleet", "autoscale.port")
    if os.path.exists(port_file):
        os.unlink(port_file)
    t0 = time.monotonic()
    return _autoscale_fleet(model_dir, port_file), port_file, t0, model_dir


def _autoscale_fleet(model_dir, port_file):
    cmd = [sys.executable, "-m", "paddle_tpu_torch", "fleet", model_dir,
           "--port-file", port_file, "--health-interval", str(FLEET_HEALTH),
           "--sample-interval", "0.5", "--autoscale", AUTOSCALE_SPEC,
           "--route-timeout", str(FD_WIRE_TIMEOUT)]
    cmd += [f"--replica-arg={a}" for a in FLEET_REPLICA_ARGS]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=HERE,
                            env=_fleet_env(), start_new_session=True)


class _FleetWatch:
    """Polls a frontend's ``fleet`` verb every 0.25 s: each replica's
    first STARTING and HEALTHY times, its largest ``forwarded`` and pid."""

    def __init__(self, ep):
        import threading
        self.ep, self.t0 = ep, time.monotonic()
        self.seen = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        from paddle_tpu_torch.serving import ServingClient
        with ServingClient(self.ep, timeout=30) as c:
            while not self._stop.wait(0.25):
                try:
                    desc = c.raw_call({"method": "fleet"})["fleet"]
                except (OSError, KeyError):
                    continue
                now = time.monotonic() - self.t0
                for r in desc["replicas"]:
                    s = self.seen.setdefault(r["replica"], {
                        "first_seen_s": now, "healthy_s": None,
                        "forwarded": 0, "pids": set()})
                    if r["state"] == "healthy" and s["healthy_s"] is None:
                        s["healthy_s"] = now
                    s["forwarded"] = max(s["forwarded"], r["forwarded"])
                    if r["pid"]:
                        s["pids"].add(r["pid"])

    def stop(self):
        self._stop.set()
        self._thread.join(10)


def control_phase(smi, state, seed=0):
    """Phase 31: (a) a CheckpointWatcher over phase 30's two spawned
    replicas republishes a checkpoint of the served weights (a no-op:
    no reload) and then a perturbed step 2, rolled replica by replica
    under LoadGenerator traffic; (b) a fresh ``fleet --autoscale``
    (min 1, max 2) replays one trace: low rate, an x8 burst, low again,
    idle.  -> results."""
    import shutil
    import threading
    import torch
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.fleet_control import (CheckpointWatcher,
                                                LoadGenerator, ModelPublisher,
                                                build_schedule)
    from paddle_tpu_torch.io import _read_params
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.serving import FleetFrontend, ServingClient
    print("phase 31: the fleet control plane: a CheckpointWatcher rolls "
          "phase 30's spawned replicas (a no-op, then perturbed weights "
          "under load); `fleet --autoscale` replays a low/x8 burst/idle "
          "trace", flush=True)
    t_phase = time.perf_counter()
    fleet, model_dir = state["fleet"], state["model_dir"]
    spawned = [r for r in fleet.replicas if r.owned]
    # phase b's fleet, started by phase 30, boots while phase a publishes
    b_proc, b_port, t_b, b_dir = state.pop("autoscale")
    out = {}
    fleet_a = None
    try:
        fleet_a = FleetFrontend(
            replica_endpoints=[r.endpoint for r in spawned],
            health_interval=FLEET_HEALTH, route_timeout=FD_WIRE_TIMEOUT,
            request_timeout=FD_WIRE_TIMEOUT).start()
        fleet_a.wait_ready(timeout=60)
        ep_a = f"127.0.0.1:{fleet_a.port}"

        def served():
            res = []
            for r in spawned:
                with ServingClient(r.endpoint, timeout=60) as c:
                    m = c.models()["models"]["default"]
                    res.append((m["manifest_fingerprint"], m["version"]))
            return res

        ckpt = os.path.join(HERE, "build", "fleet", "ckpt")
        shutil.rmtree(ckpt, ignore_errors=True)
        mgr = CheckpointManager(ckpt, async_save=False)
        arrays = _read_params(model_dir)
        t0 = time.perf_counter()
        mgr.save(1, arrays, block=True)
        pub = ModelPublisher(ckpt, model_dir)
        watcher = CheckpointWatcher(fleet_a, pub, poll_interval=1.0,
                                    health_timeout=180.0, rpc_timeout=120.0,
                                    registry=MetricsRegistry())
        before = served()
        noop = watcher.poll_once()
        noop_s = time.perf_counter() - t0
        if noop["outcome"] != "noop" or noop["rolled"] or served() != before:
            raise AssertionError(f"phase 31: step 1 was no no-op: {noop}, "
                                 f"{before} -> {served()}")
        rng = np.random.default_rng(seed + 31)
        noisy = {n: (a * (1 + ROLL_NOISE * rng.standard_normal(
            a.shape, dtype=np.float32))).astype(a.dtype)
            if np.issubdtype(a.dtype, np.floating) else a
            for n, a in arrays.items()}
        mgr.save(2, noisy, block=True)
        del arrays, noisy
        stop = threading.Event()
        load = {}
        prompt = state["prompts"][2][:ROLL_PROMPT]
        lt = threading.Thread(target=lambda: load.update(
            _roll_load(ep_a, prompt, stop)), daemon=True)
        lt.start()
        t0 = time.perf_counter()
        try:
            roll = watcher.poll_once()
        finally:
            stop.set()
            lt.join(600)
        roll_s = time.perf_counter() - t0
        target = pub.published_fingerprint()
        after = served()
        if roll["outcome"] != "ok" or len(roll["rolled"]) != 2 or \
                any(fp != target for fp, _ in after):
            raise AssertionError(f"phase 31: roll {roll}; served {after}")
        if load.get("ok") != load.get("offered") or load.get("errors") or \
                load.get("shed"):
            raise AssertionError(f"phase 31: requests failed in the roll: "
                                 f"{load}")
        p0 = state["prompts"][0]
        with ServingClient(ep_a, timeout=FD_WIRE_TIMEOUT) as c:
            fleet_toks = c.generate(p0, max_new_tokens=FLEET_NEW)["tokens"]
        reg = state["reg"]
        if not reg.reload("default"):
            raise AssertionError("phase 31: the in-process registry saw "
                                 "no new artifact")
        local = reg.get("default").decode.generate(p0, FLEET_NEW,
                                                   timeout=600)["tokens"]
        if fleet_toks != local or fleet_toks == state["ref"][0][0]:
            raise AssertionError("phase 31: the rolled fleet's stream "
                                 f"{fleet_toks[:8]} / in-process "
                                 f"{local[:8]} / before "
                                 f"{state['ref'][0][0][:8]}")
        out["watcher"] = {"noop": noop["outcome"], "noop_s": noop_s,
                          "roll": roll["outcome"], "rolled": roll["rolled"],
                          "roll_s": roll_s, "load": load,
                          "fingerprint": target,
                          "replica_versions": [v for _, v in after]}
        print(f"  ({smi}) watcher: step 1 a no-op in {noop_s:.1f} s (no "
              f"reload, versions {[v for _, v in before]}); step 2 rolled "
              f"{roll['rolled']} in {roll_s:.1f} s under "
              f"{load['offered']} generates, {load['ok']} ok, "
              f"{load['errors']} errors, {load['shed']} shed; both on "
              f"{target}; a greedy stream equals the in-process engine's "
              "and differs from round 1's", flush=True)
        fleet_a.stop(grace=10.0)
        fleet_a = None
        out["phase30_replicas_gone"] = _stop_fleet(state)
        if not out["phase30_replicas_gone"]:
            raise AssertionError("phase 31: a phase 30 replica survived "
                                 "fleet.stop()")
        torch.cuda.empty_cache()

        b_ep = f"127.0.0.1:{_wait_port(b_port, b_proc)}"
        with ServingClient(b_ep, timeout=60) as c:
            deadline = time.monotonic() + FLEET_BOOT_TIMEOUT
            while c.stats()["replicas"]["healthy"] < 1:
                if time.monotonic() > deadline or b_proc.poll() is not None:
                    raise AssertionError("phase 31: the autoscaled fleet's "
                                         "first replica never came up")
                time.sleep(0.25)
        first_boot_s = time.monotonic() - t_b
        watch = _FleetWatch(b_ep)
        sched = build_schedule(AUTOSCALE_PHASES, seed=seed + 31)
        edges = np.cumsum([p["duration_s"] for p in AUTOSCALE_PHASES])
        parts = {}
        for name, lo, hi in (("before", 0.0, edges[0]),
                             ("during", edges[0], edges[1]),
                             ("after", edges[1], edges[2])):
            sub = [(t - lo, k) for t, k in sched if lo <= t < hi]
            parts[name] = LoadGenerator(
                b_ep, sub, feed={}, generate_model="default",
                generate_prompt=prompt, max_new_tokens=ROLL_NEW,
                retries=3, timeout=FD_WIRE_TIMEOUT).run(
                    time_scale=AUTOSCALE_TIME_SCALE)
        t_idle = time.monotonic()
        deadline = t_idle + 120.0
        with ServingClient(b_ep, timeout=60) as c:
            while True:
                st = c.stats()
                asc = st.get("autoscaler") or {}
                if asc.get("scale_downs", 0) >= 1 and \
                        asc.get("replicas") == 1:
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"phase 31: no scale-down: {asc}")
                time.sleep(0.25)
        down_s = time.monotonic() - t_idle
        watch.stop()
        with ServingClient(b_ep, timeout=60) as c:
            c.raw_call({"method": "shutdown"})
        b_out = b_proc.communicate(timeout=120)[0]
        final = json.loads(b_out.strip().splitlines()[-1])
        pids = set().union(*(s["pids"] for s in watch.seen.values()))
        alive = sorted(set(p for p in pids if _pid_alive(p))
                       | set(_serve_pids(b_dir)))
        offered = sum(p["offered"] for p in parts.values())
        shed = sum(p["shed"] for p in parts.values())
        errors = sum(p["errors"] for p in parts.values())
        up = watch.seen.get("r1") or {}
        if asc.get("scale_ups") != 1 or asc.get("scale_downs") != 1 or \
                errors or not up.get("forwarded") or alive or \
                "autoscaler" not in final:
            raise AssertionError(f"phase 31: autoscaler {asc}, errors "
                                 f"{errors}, r1 {up}, alive {alive}")
        out["autoscaler"] = {
            "spec": AUTOSCALE_SPEC, "time_scale": AUTOSCALE_TIME_SCALE,
            "first_replica_boot_s": first_boot_s,
            "scale_up_replica": {
                "seen_s": up["first_seen_s"], "healthy_s": up["healthy_s"],
                "boot_s": up["healthy_s"] - up["first_seen_s"],
                "forwarded": up["forwarded"]},
            "idle_to_scale_down_s": down_s, "offered": offered,
            "shed": shed, "shed_rate": shed / max(offered, 1),
            "errors": errors,
            "p99_ms": {k: p["latency_p99_ms"] for k, p in parts.items()},
            "p50_ms": {k: p["latency_p50_ms"] for k, p in parts.items()},
            "achieved_rps": {k: p["achieved_rps"] for k, p in parts.items()},
            "last_decision": asc.get("last_decision"),
            "replicas_gone": not alive}
        out["phase_s"] = time.perf_counter() - t_phase
    finally:
        if fleet_a is not None:
            fleet_a.stop(grace=10.0)
        _stop_cli_fleet(b_proc)
        _stop_fleet(state)
    a = out["autoscaler"]
    print(f"  ({smi}) autoscaler [{AUTOSCALE_SPEC}]: first replica up in "
          f"{a['first_replica_boot_s']:.1f} s; the scale-up replica booted "
          f"in {a['scale_up_replica']['boot_s']:.1f} s and took "
          f"{a['scale_up_replica']['forwarded']} requests; scale-down "
          f"{a['idle_to_scale_down_s']:.1f} s after the trace; p99 ms "
          f"{a['p99_ms']}; shed {a['shed']} of {a['offered']} "
          f"({a['shed_rate']:.4f}), errors 0; phase {out['phase_s']:.1f} s",
          flush=True)
    return out


def _wait_port(path, proc, timeout=FLEET_BOOT_TIMEOUT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            out = proc.stdout.read()[-3000:] if proc.stdout else ""
            raise AssertionError(f"{proc.args[:4]} exited {proc.returncode}"
                                 f": {out}")
        try:
            with open(path) as f:
                line = f.readline().strip()
            if line:
                return int(line)
        except (OSError, ValueError):
            pass
        time.sleep(0.1)
    raise AssertionError(f"no port file {path} after {timeout} s")


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def fleet_phases(smi):
    """Phases 30 and 31 -> (phase 30's launches, results)."""
    launches, e30, state = fleet_phase(smi)
    e31 = control_phase(smi, state)
    return launches, {"fleet": e30, "control": e31}


def fleet_ab(smi):
    """``--fleet``: phases 30 and 31 alone, after building the serving
    path's three kernels."""
    from paddle_tpu_torch.ops import _build
    _build.build_all(("paged_attention", "flash_attention", "layer_norm"))
    launches, e2e = fleet_phases(smi)
    return {"fleet": dict(e2e, launches={k: launches[k]
                                         for k in FLEET_KERNELS})}


#: phase 32: the mesh.  Steps of each case, the ranks' time limit, and
#: (c)'s feed and limit: a sharded reply's max abs error over
#: max(1, max |Predictor reply|)
MESH_STEPS, MESH_TP_STEPS = 4, 2
MESH_RANK_TIMEOUT = 600.0
MESH_PREDICT_BATCH, MESH_PREDICT_TOL = 4, 1e-5
#: the kernels the training path launches, each rank and step
MESH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
                "layer_norm_fwd", "layer_norm_bwd", "softmax_xent_fwd",
                "softmax_xent_bwd")


def _state_digest(scope, program):
    """sha256 over every persistable's bytes, in name order (the whole
    value: a sharded var is gathered, on every rank alike)."""
    import hashlib
    h = hashlib.sha256()
    for v in sorted(program.list_vars(), key=lambda v: v.name):
        if not v.persistable or scope.get_local(v.name) is None:
            continue
        val = scope.get(v.name)
        h.update(v.name.encode())
        h.update(val.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _mesh_train(case, steps, seed=0, mesh=None, numerics=None,
                param_spec=None):
    """One warm-up step, then ``steps`` Adam steps of TRAIN_CONFIG at
    TRAIN_BATCH through ``train_loop`` on the card, with the launch and
    collective counts zeroed just before the timed loop and read just
    after -> the case's record (the timed steps' losses, seconds and
    seconds a step, launches, collectives, state)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.parallel import collectives
    main, startup, avg_cost = _train_program(seed)
    scope = fluid.core.scope.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(scope):
        exe.run(startup)
        whole = {n: (tuple(t.shape), t.numel() * t.element_size())
                 for n, t in scope._vars.items()
                 if isinstance(t, torch.Tensor)}
        feed = _copy_feed(TRAIN_BATCH, seed)
        exe.train_loop(feed=feed, fetch_list=[avg_cost], steps=1, mesh=mesh,
                       numerics=numerics, param_spec=param_spec)
        torch.cuda.synchronize()
        K.reset_launches()
        collectives.reset_counts()
        t0 = time.perf_counter()
        handles = exe.train_loop(feed=feed, fetch_list=[avg_cost],
                                 steps=steps, mesh=mesh, numerics=numerics,
                                 param_spec=param_spec)
        losses = [float(h.get()[0]) for h in handles]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        rec = {"case": case, "losses": losses, "seconds": sec,
               "step_s": sec / steps,
               "launches": {k.name: k.launches for k in K.KERNELS},
               "collectives": collectives.ledger(),
               "whole_bytes": sum(b for _, b in whole.values()),
               "resident_bytes": sum(
                   t.numel() * t.element_size()
                   for t in scope._vars.values()
                   if isinstance(t, torch.Tensor)),
               "sharded": {n: [list(whole[n][0]),
                               list(scope.get_local(n).shape),
                               [p if p is None or isinstance(p, str)
                                else list(p) for p in scope.sharding(n)[1]]]
                           for n in whole if scope.sharding(n)},
               "digest": _state_digest(scope, main)}
    del exe, scope
    torch.cuda.empty_cache()
    print(f"  {case}: {steps} steps after a warm-up one in {sec:.2f} s, "
          f"losses {losses}", flush=True)
    return rec


def _mesh_lm_dir(seed=0):
    """TRAIN_CONFIG's logits program with seeded random weights, saved
    for (c) under build/mesh_lm."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models import transformer
    d = os.path.join(HERE, "build", "mesh_lm")
    fluid.core.program.reset_default_programs()
    cfg = {k: TRAIN_CONFIG[k] for k in ("vocab", "max_len", "n_layers",
                                        "d_model", "n_heads", "d_ff")}
    tokens = layers.data(name="tokens", shape=[cfg["max_len"]],
                         dtype="int64")
    logits = transformer.transformer_lm_logits(tokens, **cfg)
    fluid.default_startup_program().random_seed = seed
    scope = fluid.core.scope.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(scope):
        exe.run(fluid.default_startup_program())
        fluid.io.save_inference_model(d, ["tokens"], [logits], exe)
    return d


def _mesh_rank(rank, init, out_dir, lm_dir):
    """One of phase 32's two gloo ranks over CUDA tensors (both on the
    one card): (b) dp=2 exact, dp=2 fast and tp=2 fast training, then
    (c) the sharded predictor; writes its records as JSON."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.ops import _build, kernels as K
    from paddle_tpu_torch.parallel import (collectives, init_distributed,
                                           transformer_tp_rules)
    from paddle_tpu_torch import serving
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    _build.build_all({k.source for k in K.KERNELS if k.name in MESH_KERNELS})
    init_distributed(init, 2, rank, backend="gloo")
    d, f, v = (TRAIN_CONFIG[k] for k in ("d_model", "d_ff", "vocab"))
    recs = [_mesh_train("dp=2 exact", MESH_STEPS, mesh={"dp": 2},
                        numerics="exact"),
            _mesh_train("dp=2 fast", MESH_STEPS, mesh={"dp": 2}),
            _mesh_train("tp=2 fast", MESH_TP_STEPS,
                        mesh={"dp": 1, "tp": 2},
                        param_spec=transformer_tp_rules(d, f, vocab=v))]
    # the two tensor-parallel gathers' cost, alone at the path's shapes:
    # a QKV output shard (12 a step) and a logits shard (one a step)
    group = dist.group.WORLD
    gathers = {}
    t_len = TRAIN_CONFIG["max_len"]
    for what, width in (("qkv", 3 * d // 2), ("logits", v // 2)):
        x = torch.randn(TRAIN_BATCH, t_len, width, device="cuda")
        collectives.all_gather(x, group, "tp", 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            collectives.all_gather(x, group, "tp", 2)
        torch.cuda.synchronize()
        gathers[what] = {"ms": (time.perf_counter() - t0) / 3 * 1e3,
                         "bytes": 2 * x.numel() * x.element_size()}
    rng = np.random.default_rng(32)
    feed = {"tokens": rng.integers(
        0, v, (MESH_PREDICT_BATCH, TRAIN_CONFIG["max_len"])).astype(
            np.int64)}
    want = serving.Predictor.from_model_dir(lm_dir).run(feed)[0]
    pred = serving.ShardedPredictor.from_model_dir(lm_dir, mesh={"dp": 2})
    collectives.reset_counts()
    t0 = time.perf_counter()
    got = pred.run(feed)[0]
    torch.cuda.synchronize()
    predict = {"seconds": time.perf_counter() - t0,
               "max_abs_err": float(np.abs(got - want).max()),
               "max_abs_want": float(np.abs(want).max()),
               "shape": list(got.shape),
               "collectives": collectives.ledger()}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump({"train": recs, "predict": predict, "gathers": gathers},
                  fh)
    dist.destroy_process_group()


def mesh_phase(smi, seed=0):
    """Phase 32: the mesh on the card.  (a) a one-rank NCCL world: one
    call of each collective, then ``train_loop(mesh={"dp": 1})`` bitwise
    the plain run; (b) two spawned gloo ranks time-slicing the card:
    dp=2 exact bitwise the single-process card run, dp=2 and tp=2 fast
    within CPU_LOSS_RTOL of it, the tp=2 ruled params and moments holding
    half the ruled dim and each rank's resident state under 0.75x the
    whole, every case launching the six training kernels
    TRAIN_LAUNCHES_PER_STEP times a rank and step; (c) the sharded
    predictor dp=2 within MESH_PREDICT_TOL of `Predictor`; and the two
    tensor-parallel gathers (a QKV output, the logits) timed alone at
    the path's shapes.  -> (launches
    of the six kernels, summed over the ranks, numbers)."""
    import socket
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.parallel import init_distributed
    t_phase = time.perf_counter()
    print("phase 32: the mesh: a one-rank NCCL world, two gloo ranks "
          f"time-slicing the card ({smi})", flush=True)

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    # (a) NCCL refuses two ranks on one card: the port raises, it does
    # not switch backend
    try:
        init_distributed(f"127.0.0.1:{free_port()}", 2, 0)
    except RuntimeError as e:
        refusal = str(e)
    else:
        raise AssertionError("an NCCL world of 2 ranks on one card was "
                             "not refused")
    t0 = time.perf_counter()
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    if dist.get_backend() != "nccl":
        raise AssertionError(f"backend {dist.get_backend()}, want nccl")
    x = torch.arange(1024, dtype=torch.float32, device="cuda") - 512.0
    out = torch.empty((1, 1024), device="cuda")
    dist.all_gather_into_tensor(out, x)
    red = x.clone()
    dist.all_reduce(red)
    bc = x.clone()
    dist.broadcast(bc, src=0)
    torch.cuda.synchronize()
    for name, got in (("all_gather", out[0]), ("all_reduce", red),
                      ("broadcast", bc)):
        if not torch.equal(got, x):
            raise AssertionError(f"one-rank NCCL {name} changed its input")
    plain = _mesh_train("plain", MESH_STEPS, seed)
    one = _mesh_train("dp=1 NCCL", MESH_STEPS, seed, mesh={"dp": 1})
    dist.destroy_process_group()
    if one["losses"] != plain["losses"] or one["digest"] != plain["digest"]:
        raise AssertionError("train_loop(mesh={'dp': 1}) is not bitwise "
                             "the plain run")
    part_a = time.perf_counter() - t0
    # (b) and (c) on two gloo ranks
    t0 = time.perf_counter()
    lm_dir = _mesh_lm_dir(seed)
    out_dir = os.path.join(HERE, "build", "mesh_ranks")
    os.makedirs(out_dir, exist_ok=True)
    for fname in os.listdir(out_dir):
        os.unlink(os.path.join(out_dir, fname))
    init = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--mesh-rank", str(r), init, out_dir,
                               lm_dir]) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=MESH_RANK_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"mesh ranks exited "
                             f"{[p.returncode for p in procs]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    part_bc = time.perf_counter() - t0
    launches = {name: 0 for name in MESH_KERNELS}
    for name in MESH_KERNELS:
        launches[name] += (plain["launches"][name]
                           + one["launches"][name])
    cases = {}
    for r, res in enumerate(ranks):
        for rec in res["train"]:
            case, steps = rec["case"], len(rec["losses"])
            for name, n in rec["launches"].items():
                want = TRAIN_LAUNCHES_PER_STEP.get(name, 0) * steps
                if n != want:
                    raise AssertionError(
                        f"rank {r} {case}: {name} launched {n} times in "
                        f"{steps} steps, want {want}")
                if name in launches:
                    launches[name] += n
            if case.endswith("exact"):
                if rec["losses"] != plain["losses"] \
                        or rec["digest"] != plain["digest"]:
                    raise AssertionError(
                        f"rank {r} {case} is not bitwise the single-"
                        f"process card run: {rec['losses']} against "
                        f"{plain['losses']}")
            else:
                for got, want in zip(rec["losses"], plain["losses"]):
                    if abs(got - want) > CPU_LOSS_RTOL * abs(want):
                        raise AssertionError(
                            f"rank {r} {case}: loss {got} against the "
                            f"single-process {want}")
            if case.startswith("tp"):
                d, f, v = (TRAIN_CONFIG[k] for k in ("d_model", "d_ff",
                                                     "vocab"))
                ruled = {(d, 3 * d): 1, (3 * d,): 0, (d, f): 1, (f,): 0,
                         (f, d): 0, (d, v): 1, (v,): 0}
                n_ruled = 0
                for n, (full, local, spec) in rec["sharded"].items():
                    dim = ruled.get(tuple(full))
                    if dim is None:
                        continue
                    n_ruled += 1
                    want = list(full)
                    want[dim] //= 2
                    if local != want:
                        raise AssertionError(f"rank {r}: {n} holds "
                                             f"{local}, want {want}")
                if n_ruled < 3 * (5 * TRAIN_CONFIG["n_layers"] + 2):
                    raise AssertionError(f"rank {r}: only {n_ruled} "
                                         "ruled vars sharded")
                # Megatron's plan ran: a step gathers the QKV outputs,
                # the logits and the biases read whole, and no weight
                b_t = TRAIN_BATCH * TRAIN_CONFIG["max_len"]
                n_l = TRAIN_CONFIG["n_layers"]
                want_bytes = 4 * (n_l * (b_t * 3 * d + 3 * d)
                                  + b_t * v + v) * steps
                got_bytes = rec["collectives"]["kinds"]["all-gather"][
                    "bytes"]
                if got_bytes != want_bytes:
                    raise AssertionError(
                        f"rank {r}: tp gathers moved {got_bytes} bytes in "
                        f"{steps} steps, want {want_bytes}")
                share = rec["resident_bytes"] / rec["whole_bytes"]
                if share >= 0.75:
                    raise AssertionError(f"rank {r}: resident state "
                                         f"{share:.3f} of the whole")
                rec["resident_share"] = share
            cases.setdefault(case, []).append(
                {k: rec[k] for k in ("seconds", "step_s", "losses",
                                     "collectives")
                 } | ({"resident_share": rec["resident_share"]}
                      if "resident_share" in rec else {}))
        pr = res["predict"]
        err = pr["max_abs_err"] / max(1.0, pr["max_abs_want"])
        if not err <= MESH_PREDICT_TOL:
            raise AssertionError(f"rank {r}: sharded predictor off by "
                                 f"{err:.3g} of max |logit|")
        pr["rel_err"] = err
    e2e = {"card": smi, "nccl_refusal": refusal,
           "part_a_s": part_a, "part_bc_s": part_bc,
           "plain_losses": plain["losses"], "plain_s": plain["seconds"],
           "plain_step_s": plain["step_s"], "dp1_step_s": one["step_s"],
           "cases": cases, "predict": [res["predict"] for res in ranks],
           "tp_gathers": [res["gathers"] for res in ranks],
           "seconds": time.perf_counter() - t_phase}
    print(f"  end to end ({smi}): {json.dumps(e2e)}", flush=True)
    return launches, e2e


def mesh_ab(smi):
    from paddle_tpu_torch.ops import _build, kernels as K
    _build.build_all({k.source for k in K.KERNELS
                      if k.name in MESH_KERNELS})
    launches, e2e = mesh_phase(smi)
    return {"mesh": dict(e2e, launches=launches)}


# ---------------------------------------------------------------------------
# phase 33: row-sharded embedding tables on the recommender
# ---------------------------------------------------------------------------

#: timed steps a case after one warm-up step (the feeds cycle over them)
SE_STEPS = 4
SE_RANK_TIMEOUT = 300.0
#: fast numerics against the single-process run: each loss's relative
#: error
SE_FAST_RTOL = 1e-5
#: bench.py:941 / benchmark/fluid/sparse_embedding.py:310-335's tiered
#: table: vocab 50000, D 32, batch 32, T 16, a pool of vocab // 32 rows,
#: 8 steps in windows of 4, two Zipf(1.1) feeds of seed 5
TIERED = dict(V=50_000, D=32, batch=32, T=16, cap_rows=50_000 // 32,
              steps=8, k=4, seed=5)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _se_program(is_distributed, seed=0):
    return _rec_program(True, lambda fl: fl.optimizer.Adam(
        learning_rate=1e-3), REC_V, REC_D, seed=seed,
        is_distributed=is_distributed)


def _se_feeds(seed=0):
    """SE_STEPS batches of bench.py's feed: Zipf(1.1) ids clipped to V,
    full lengths."""
    return _rec_feeds(SE_STEPS, REC_BATCH, REC_T, REC_V, seed, ragged=False)


def _se_train(case, main, loss, table, state, feeds, **kw):
    """One warm-up step, then SE_STEPS steps of ``main`` through
    train_loop on the card from ``state``, with the collective and kernel
    counts zeroed just before the timed steps and read just after ->
    the case's record."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.parallel import collectives
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.core.scope.Scope()
    pio.scope_from_numpy(scope, main, state, exe.device)
    with fluid.scope_guard(scope):
        exe.train_loop(main, feeds, fetch_list=[loss], steps=1, **kw)
        torch.cuda.synchronize()
        collectives.reset_counts()
        K.reset_launches()
        t0 = time.perf_counter()
        hs = exe.train_loop(main, feeds, fetch_list=[loss],
                            steps=SE_STEPS, **kw)
        losses = [float(h.get()[0]) for h in hs]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        led = collectives.ledger()
        launches = sum(k.launches for k in K.KERNELS)
        resident = sum(t.numel() * t.element_size()
                       for n, t in scope._vars.items()
                       if n.startswith(table) and t.dim() == 2)
        whole = 3 * REC_V * REC_D * 4
        rec = {"case": case, "losses": losses, "seconds": sec,
               "step_s": sec / SE_STEPS, "port_kernel_launches": launches,
               "collectives_per_step": None if led is None else {
                   k: {"calls": v["count"] / SE_STEPS,
                       "bytes": v["bytes"] / SE_STEPS}
                   for k, v in led["kinds"].items()},
               "resident_table_and_moments_bytes": resident,
               "whole_table_and_moments_bytes": whole,
               "digest": _state_digest(scope, main)}
    print(f"  {case}: {SE_STEPS} steps after a warm-up one, "
          f"{rec['step_s'] * 1e3:.2f} ms a step, losses {losses}",
          flush=True)
    return rec


def _se_rank(rank, init, out_dir, state_path, model_dir):
    """One of phase 33's two gloo ranks over CUDA tensors: (b) ep=2
    exact, psum and exchange, (c) ep=2 fast, (e) the sharded predictor;
    writes its records as JSON."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.parallel import collectives, init_distributed
    from paddle_tpu_torch.parallel.embedding import plan_a2a_capacity
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    init_distributed(init, 2, rank, backend="gloo")
    with np.load(state_path) as z:
        state = {n: z[n] for n in z.files}
    main, _, loss, table = _se_program(True)
    feeds = _se_feeds()
    cap = plan_a2a_capacity([f["words"].reshape(-1) for f in feeds], 2,
                            vocab=REC_V)
    mesh = {"ep": 2}
    recs = [_se_train("ep=2 exact psum", main, loss, table, state, feeds,
                      mesh=mesh, numerics="exact"),
            _se_train(f"ep=2 exact a2a capacity {cap}", main, loss, table,
                      state, feeds, mesh=mesh, numerics="exact",
                      lookup_exchange="a2a", a2a_capacity=cap),
            _se_train("ep=2 fast psum", main, loss, table, state, feeds,
                      mesh=mesh, numerics="fast"),
            _se_train(f"ep=2 fast a2a capacity {cap}", main, loss, table,
                      state, feeds, mesh=mesh, numerics="fast",
                      lookup_exchange="a2a", a2a_capacity=cap)]
    # (e) the saved recommender served on {"ep": 2}
    rng = np.random.RandomState(33)
    feed = {"words": (np.minimum(rng.zipf(REC_ZIPF, (REC_BATCH, REC_T)),
                                 REC_V) - 1).astype(np.int64),
            "words@SEQ_LEN": np.full((REC_BATCH,), REC_T, np.int32)}
    want = serving.Predictor.from_model_dir(model_dir).run(dict(feed))[0]
    predict = {}
    for cache in (0, REC_CACHE_ROWS):
        for numerics in ("exact", "fast"):
            pred = serving.ShardedPredictor.from_model_dir(
                model_dir, mesh={"ep": 2}, numerics=numerics,
                embedding_cache_rows=cache)
            collectives.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = pred.run(dict(feed))[0]
            torch.cuda.synchronize()
            predict[f"{numerics} cache {cache}"] = {
                "seconds": time.perf_counter() - t0,
                "bitwise": got.tobytes() == want.tobytes(),
                "max_abs_err": float(np.abs(got - want).max()),
                "sharded_params": pred.sharding_info()["sharded_params"],
                "collectives": collectives.ledger()}
            del pred
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump({"train": recs, "capacity": cap, "predict": predict}, fh)
    dist.destroy_process_group()


def _tiered_leg(smi):
    """(d): the tiered table against the untiered run, one process."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio
    cfg = TIERED
    main, startup, loss, table = _rec_program(
        True, lambda fl: fl.optimizer.Adam(learning_rate=1e-3), cfg["V"],
        cfg["D"], hidden=0)
    state = _startup_state(startup, fluid.CPUPlace())
    rng = np.random.RandomState(cfg["seed"])
    ids = np.minimum(rng.zipf(1.1, (2, cfg["batch"], cfg["T"])),
                     cfg["V"]) - 1
    feeds = [{"words": ids[i].astype(np.int64),
              "words@SEQ_LEN": np.full((cfg["batch"],), cfg["T"], np.int32),
              "label": rng.randint(0, 2, (cfg["batch"], 1)).astype(np.int64)}
             for i in range(2)]
    out = {}
    for leg, tiered in (("untiered", None),
                        ("tiered", {table: cfg["cap_rows"]})):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = fluid.core.scope.Scope()
        pio.scope_from_numpy(scope, main, state, exe.device)
        with fluid.scope_guard(scope):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hs = exe.train_loop(main, feeds, fetch_list=[loss],
                                steps=cfg["steps"], fetch_every=cfg["steps"],
                                steps_per_launch=cfg["k"], tiered=tiered)
            losses = [float(h.get()[0]) for h in hs]
            torch.cuda.synchronize()
            rec = {"losses": losses,
                   "step_ms": (time.perf_counter() - t0) / cfg["steps"] * 1e3,
                   "digest": _state_digest(scope, main)}
        if tiered:
            st = exe.last_tiered.stats()
            rec.update(stats=st, pool_device_bytes=3 * cfg["cap_rows"]
                       * cfg["D"] * 4,
                       table_and_moments_bytes=3 * cfg["V"] * cfg["D"] * 4)
        out[leg] = rec
    if (out["tiered"]["losses"] != out["untiered"]["losses"]
            or out["tiered"]["digest"] != out["untiered"]["digest"]):
        raise AssertionError("phase 33 (d): the tiered run is not bitwise "
                             "the untiered one")
    st = out["tiered"]["stats"]
    t = out["tiered"]
    print(f"  (d) tiered ({smi}): hit rate {st['tiered_hit_rate']}, "
          f"{st['evictions']} evictions, pool {t['pool_device_bytes']} B on "
          f"the card against {t['table_and_moments_bytes']} B whole, "
          "bitwise the untiered run", flush=True)
    return out


def sharded_embedding_phase(smi, seed=0):
    """Phase 33 (the module docstring's 33) -> its end-to-end numbers."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.parallel import init_distributed
    t_phase = time.perf_counter()
    print(f"phase 33: row-sharded embedding tables, the recommender at "
          f"V {REC_V} D {REC_D} T {REC_T} batch {REC_BATCH}: a one-rank "
          f"NCCL world, two gloo ranks time-slicing the card ({smi}); "
          "placement and parity, not scaling", flush=True)
    import paddle_tpu_torch as fluid
    plain_main, startup, plain_loss, table = _se_program(False, seed)
    dist_main, _, dist_loss, _ = _se_program(True, seed)
    state = _startup_state(startup, fluid.CPUPlace())
    feeds = _se_feeds(seed)
    # (a) ep=1 on NCCL
    t0 = time.perf_counter()
    init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    if dist.get_backend() != "nccl":
        raise AssertionError(f"backend {dist.get_backend()}, want nccl")
    plain = _se_train("plain sparse", plain_main, plain_loss, table, state,
                      feeds)
    one = _se_train("ep=1 NCCL", dist_main, dist_loss, table, state, feeds,
                    mesh={"ep": 1})
    dist.destroy_process_group()
    if one["losses"] != plain["losses"] or one["digest"] != plain["digest"]:
        raise AssertionError("phase 33 (a): train_loop(mesh={'ep': 1}) is "
                             "not bitwise the plain sparse run")
    if one["collectives_per_step"] is not None:
        raise AssertionError(f"phase 33 (a): collectives ran: "
                             f"{one['collectives_per_step']}")
    part_a = time.perf_counter() - t0
    # (d) tiered, one process
    t0 = time.perf_counter()
    tiered = _tiered_leg(smi)
    part_d = time.perf_counter() - t0
    # (b), (c), (e) on two gloo ranks
    t0 = time.perf_counter()
    root = os.path.join(HERE, "build", "sharded_embedding")
    out_dir = os.path.join(root, "ranks")
    os.makedirs(out_dir, exist_ok=True)
    for fname in os.listdir(out_dir):
        os.unlink(os.path.join(out_dir, fname))
    state_path = os.path.join(root, "start_state.npz")
    np.savez(state_path, **state)
    model_dir = os.path.join(root, "model")
    _save_recommender(model_dir, seed)
    init = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--sharded-rank", str(r), init, out_dir,
                               state_path, model_dir]) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=SE_RANK_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"phase 33 ranks exited "
                             f"{[p.returncode for p in procs]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    part_bce = time.perf_counter() - t0
    cases = {}
    for r, res in enumerate(ranks):
        for rec in res["train"]:
            case = rec["case"]
            if rec["port_kernel_launches"]:
                raise AssertionError(f"phase 33 rank {r} {case}: a port "
                                     "kernel launched")
            if "exact" in case:
                if rec["losses"] != plain["losses"] \
                        or rec["digest"] != plain["digest"]:
                    raise AssertionError(
                        f"phase 33 rank {r} {case} is not bitwise the "
                        f"single-process card run: {rec['losses']} "
                        f"against {plain['losses']}")
            else:
                for got, want in zip(rec["losses"], plain["losses"]):
                    if abs(got - want) > SE_FAST_RTOL * abs(want):
                        raise AssertionError(
                            f"phase 33 rank {r} {case}: loss {got} against "
                            f"the single-process {want}")
            if rec["resident_table_and_moments_bytes"] * 2 != \
                    rec["whole_table_and_moments_bytes"]:
                raise AssertionError(
                    f"phase 33 rank {r} {case}: resident table and moments "
                    f"{rec['resident_table_and_moments_bytes']} B, want "
                    "half the whole")
            cases.setdefault(case, []).append(
                {k: rec[k] for k in ("step_s", "seconds",
                                     "collectives_per_step",
                                     "resident_table_and_moments_bytes",
                                     "losses")})
        for key, pr in res["predict"].items():
            if not pr["bitwise"]:
                raise AssertionError(
                    f"phase 33 rank {r} ShardedPredictor {key}: not bitwise "
                    f"the Predictor's reply (max abs error "
                    f"{pr['max_abs_err']})")
    n_ids = REC_BATCH * REC_T
    cap = ranks[0]["capacity"]
    e2e = {"card": smi, "part_a_s": part_a, "part_d_s": part_d,
           "part_bce_s": part_bce, "plain_step_s": plain["step_s"],
           "ep1_step_s": one["step_s"], "plain_losses": plain["losses"],
           "planned_capacity": cap,
           "psum_lookup_bytes_per_step": n_ids * REC_D * 4,
           "a2a_bytes_each_way": 2 * cap * (4 + REC_D * 4),
           "a2a_route": "all_to_all_single (gloo, CUDA tensors)",
           "cases": cases, "tiered": tiered,
           "predict": [res["predict"] for res in ranks],
           "seconds": time.perf_counter() - t_phase}
    print(f"  end to end ({smi}): {json.dumps(e2e)}", flush=True)
    torch.cuda.empty_cache()
    return e2e


def sharded_embedding_ab(smi):
    return {"sharded_embedding": sharded_embedding_phase(smi)}


# ---------------------------------------------------------------------------
# phase 34: sequence-parallel attention and the GPipe pipeline
# ---------------------------------------------------------------------------

#: the LM's attention width (TRAIN_CONFIG): one batch of T 8192, split
#: over sp=2 ranks (4096 a rank)
SP_SHAPE = (1, 8192, TRAIN_CONFIG["n_heads"],
            TRAIN_CONFIG["d_model"] // TRAIN_CONFIG["n_heads"])
#: ring and Ulysses against the whole-sequence flash and the plain
#: versions, each of out, dq, dk and dv on its own: f32 at F32_TOL of
#: max(1, max |reference|), bf16 at BF16_REL * max |reference| +
#: BF16_FLOOR ("bf16_tensor" in `_err`; a ring block's out is rounded to
#: bf16 before the f32 merge, which the single flash does not do)
SP_RANK_TIMEOUT = 600.0
SP_KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
              "layer_norm_fwd", "layer_norm_bwd")
#: the pipeline: x [16, 512, 768] in 4 microbatches over pp=2, the stage
#: one post-LN decoder block at TRAIN_CONFIG width in f32; output and
#: gradients within PP_RTOL of max |reference|, the reference run on
#: each microbatch in turn and on the whole batch at once (there its
#: products run at another M)
PP_X = (16, TRAIN_CONFIG["max_len"], TRAIN_CONFIG["d_model"])
PP_MICRO, PP_K, PP_RTOL = 4, 2, 1e-5


def _sp_inputs(dtype, seed=34):
    """The global [B, T, H, D] q, k, v and w on the card, the same on
    every rank (a seeded generator on the card)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(SP_SHAPE, generator=g, device="cuda").to(dtype)
            for _ in range(4)]


def _flash_whole(q, k, v, w, causal, plain=False):
    """Attention over the whole sequence in one process -> (out, [dq, dk,
    dv] of sum(out * w)), [B, T, H, D]: `kernels.FlashAttention` (the
    single-process flash), or with ``plain`` the kernels' plain
    versions."""
    import torch
    from paddle_tpu_torch.ops import kernels as K
    qh, kh, vh, wh = (t.transpose(1, 2).contiguous() for t in (q, k, v, w))
    if plain:
        out, lse = K.flash_attention_fwd_plain(qh, kh, vh, causal)
        grads = K.flash_attention_bwd_plain(qh, kh, vh, out, lse,
                                            wh.to(out.dtype), causal)
    else:
        qh, kh, vh = (t.requires_grad_(True) for t in (qh, kh, vh))
        out = K.FlashAttention.apply(qh, kh, vh, causal)
        (out.float() * wh.float()).sum().backward()
        grads = (qh.grad, kh.grad, vh.grad)
        out = out.detach()
    return (out.transpose(1, 2),
            [g.transpose(1, 2) for g in grads])


def _sp_err(got, want):
    """One tensor against its reference -> {max abs error, max |want|,
    share of the tolerance}: f32 by the "f32" rule, bf16 by
    "bf16_tensor" (`_err`)."""
    import torch
    got, want = got.detach(), want.detach()
    err, share = _err(got, want, "f32" if want.dtype == torch.float32
                      else "bf16_tensor")
    return {"err": err, "max_ref": float(want.float().abs().max()),
            "share": share}


def _pp_params(n_stages, seed=35):
    """Stacked [n_stages, ...] parameters of the decoder-block stage,
    seeded on the card: weights N(0, 0.02), biases 0, LayerNorm scale
    1 + N(0, 0.1) and bias N(0, 0.1).  (At scale 1 and bias 0 the last
    LayerNorm's output has a constant sum of squares, so every gradient
    of sum(out ** 2) but its scale's would be rounding noise.)"""
    import torch
    d, f = TRAIN_CONFIG["d_model"], TRAIN_CONFIG["d_ff"]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def w(*shape):
        return torch.randn((n_stages,) + shape, generator=g,
                           device="cuda") * 0.02

    def zeros(*shape):
        return torch.zeros((n_stages,) + shape, device="cuda")

    def norm_scale():
        return 1.0 + 5.0 * w(d)

    return {"w_qkv": w(d, 3 * d), "b_qkv": zeros(3 * d),
            "w_o": w(d, d), "b_o": zeros(d),
            "ln1_s": norm_scale(), "ln1_b": 5.0 * w(d),
            "w_1": w(d, f), "b_1": zeros(f), "w_2": w(f, d),
            "b_2": zeros(d), "ln2_s": norm_scale(), "ln2_b": 5.0 * w(d)}


def _pp_stage(p, x, plain=False):
    """One post-LN decoder block (causal self-attention, GELU FFN) over
    [mb, T, d]: the flash kernels for attention, the LayerNorm kernels
    for both norms, torch.matmul for the products; with ``plain`` the
    kernels' plain forwards instead, differentiated by autograd.  GELU
    (tanh form) and not the LM's ReLU: a ReLU input within rounding of 0
    takes the other branch wherever two right computations round
    differently (the kernels and their plain versions, or another M),
    which moved w_1's gradient by 4.6e-4 of its max at this shape; GELU's
    gradient is continuous, so such differences stay at rounding."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kernels as K
    b, t, d = x.shape
    h = TRAIN_CONFIG["n_heads"]
    qkv = (torch.matmul(x, p["w_qkv"]) + p["b_qkv"]).reshape(
        b, t, 3, h, d // h).permute(2, 0, 3, 1, 4)
    q, k, v = (qkv[i].contiguous() for i in range(3))
    if plain:
        a = K.flash_attention_fwd_plain(q, k, v, True)[0]
    else:
        a = K.FlashAttention.apply(q, k, v, True)
    a = torch.matmul(a.transpose(1, 2).reshape(b, t, d), p["w_o"]) \
        + p["b_o"]

    def norm(y, s, bias):
        y = y.reshape(-1, d).contiguous()
        y = (K.layer_norm_fwd_plain(y, s, bias, 1e-5) if plain
             else K.LayerNorm.apply(y, s, bias, 1e-5))[0]
        return y.reshape(b, t, d)

    x = norm(x + a, p["ln1_s"], p["ln1_b"])
    f = F.gelu(torch.matmul(x, p["w_1"]) + p["b_1"], approximate="tanh")
    f = torch.matmul(f, p["w_2"]) + p["b_2"]
    return norm(x + f, p["ln2_s"], p["ln2_b"])


def _pp_stage_plain(p, x):
    return _pp_stage(p, x, plain=True)


def _pp_stage_flops():
    """The stage's forward flops on one microbatch: its four products
    (2 M d (3d + d + 2 f), M = mb * T) and its causal flash forward."""
    from paddle_tpu_torch.ops import kernels as K
    mb, t, d = PP_X[0] // PP_MICRO, PP_X[1], PP_X[2]
    h, f = TRAIN_CONFIG["n_heads"], TRAIN_CONFIG["d_ff"]
    return 2 * mb * t * d * (4 * d + 2 * f) + K.flash_attention_flops(
        mb * h, t, t, d // h, True)


def _pp_kernel_checks():
    """The stage's four kernels called on the card at the pipeline's
    shapes (LayerNorm over mb * T rows of d, flash over [mb, H, T, D]
    causal, f32) against their plain versions on the same seeded inputs
    -> {kernel: {max_abs_err, limit_share}}.  These launches are
    comparisons, made after the counted runs."""
    import torch
    from paddle_tpu_torch.ops import kernels as K
    mb, t, d = PP_X[0] // PP_MICRO, PP_X[1], PP_X[2]
    h = TRAIN_CONFIG["n_heads"]
    g = torch.Generator(device="cuda").manual_seed(37)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    recs = {name: {} for name in SP_KERNELS}
    x, dy = randn(mb * t, d), randn(mb * t, d)
    scale, bias = 1.0 + 0.1 * randn(d), 0.1 * randn(d)
    want = K.layer_norm_fwd_plain(x, scale, bias, 1e-5)
    label = f"pipeline stage R{mb * t} F{d}"
    _check("layer_norm_fwd", list(zip(K.layer_norm_fwd(x, scale, bias, 1e-5),
                                      want)),
           "float32", label, recs["layer_norm_fwd"])
    inv = torch.rsqrt(want[2] + 1e-5)
    _check("layer_norm_bwd", list(zip(
        K.layer_norm_bwd(x, scale, want[1], inv, dy),
        K.layer_norm_bwd_plain(x, scale, want[1], inv, dy))),
        "float32", label, recs["layer_norm_bwd"])
    q, k, v, dout = (randn(mb, h, t, d // h) for _ in range(4))
    out, lse = K.flash_attention_fwd_plain(q, k, v, True)
    label = f"pipeline stage B{mb} H{h} T{t} D{d // h} causal"
    _check("flash_attention_fwd", list(zip(
        K.flash_attention_fwd(q, k, v, True), (out, lse))),
        "float32", label, recs["flash_attention_fwd"])
    _check("flash_attention_bwd", list(zip(
        K.flash_attention_bwd(q, k, v, out, lse, dout, True),
        K.flash_attention_bwd_plain(q, k, v, out, lse, dout, True))),
        "float32", label, recs["flash_attention_bwd"])
    return recs


def _pp_x(seed=36):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(PP_X, generator=g, device="cuda")


def _launches(names=SP_KERNELS):
    from paddle_tpu_torch.ops import kernels as K
    return {k.name: k.launches for k in K.KERNELS if k.name in names}


def _leaf(params):
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in params.items()}


def _sp_one_rank(smi):
    """Phase 34 (a): a one-rank NCCL world.  Ring and Ulysses at sp=1
    bitwise the single flash (out and dq/dk/dv, f32 and bf16);
    pipeline_apply at pp=1 in one microbatch bitwise pipeline_reference
    (out and every gradient); then the stage's kernels against their
    plain versions at its shapes (`_pp_kernel_checks`) -> (launches of
    the sequence-parallel calls, of the pipeline's, numbers)."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.parallel import (create_mesh, init_distributed,
                                           pipeline_apply,
                                           pipeline_reference,
                                           sequence_parallel_attention)
    t0 = time.perf_counter()
    init_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    if dist.get_backend() != "nccl":
        raise AssertionError(f"backend {dist.get_backend()}, want nccl")
    mesh = create_mesh({"sp": 1})
    sp_launches = dict.fromkeys(SP_KERNELS, 0)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, w = _sp_inputs(dtype)
        want, want_g = _flash_whole(q, k, v, w, True)
        for strategy in ("ring", "ulysses"):
            ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
            K.reset_launches()
            out = sequence_parallel_attention(*ts, mesh, strategy=strategy,
                                              causal=True)
            (out.float() * w.float()).sum().backward()
            torch.cuda.synchronize()
            for name, n in _launches().items():
                sp_launches[name] += n
            if not torch.equal(out, want) or not all(
                    torch.equal(t.grad, g) for t, g in zip(ts, want_g)):
                raise AssertionError(f"phase 34 (a): {strategy} at sp=1 in "
                                     f"{dtype} is not bitwise the single "
                                     "flash")
        del q, k, v, w, want, want_g
    params = {k: v[:1] for k, v in _pp_params(1).items()}
    x = _pp_x()
    got_p, ref_p = _leaf(params), _leaf(params)
    K.reset_launches()
    out = pipeline_apply(_pp_stage, got_p, x, create_mesh({"pp": 1}),
                         n_microbatches=1)
    (out ** 2).sum().backward()
    torch.cuda.synchronize()
    pp_launches = _launches()
    ref = pipeline_reference(_pp_stage, ref_p, x)
    (ref ** 2).sum().backward()
    if not torch.equal(out, ref) or not all(
            torch.equal(got_p[n].grad, ref_p[n].grad) for n in params):
        raise AssertionError("phase 34 (a): pipeline_apply at pp=1 is not "
                             "bitwise pipeline_reference")
    dist.destroy_process_group()
    kernel_checks = _pp_kernel_checks()
    torch.cuda.empty_cache()
    return sp_launches, pp_launches, {"seconds": time.perf_counter() - t0,
                                      "stage_kernels": kernel_checks}


def _sp_rank(rank, init, out_dir):
    """One of phase 34's two gloo ranks over CUDA tensors (both on the
    one card): ring and Ulysses, causal and full, f32 and bf16, each
    against the single-process flash and the plain versions; the
    pipeline at pp=2 against pipeline_reference, and pipeline_window;
    writes its records as JSON."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.observability import introspect
    from paddle_tpu_torch.ops import _build, kernels as K
    from paddle_tpu_torch.parallel import (collectives, create_mesh,
                                           init_distributed,
                                           pipeline_apply,
                                           pipeline_reference,
                                           pipeline_window,
                                           sequence_parallel_attention)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    _build.build_all({k.source for k in K.KERNELS if k.name in SP_KERNELS})
    init_distributed(init, 2, rank, backend="gloo")
    mesh = create_mesh({"sp": 2})
    tl = SP_SHAPE[1] // 2
    sl = slice(rank * tl, (rank + 1) * tl)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            q, k, v, w = _sp_inputs(dtype)
            flash = _flash_whole(q, k, v, w, causal)
            plain = _flash_whole(q, k, v, w, causal, plain=True)
            for strategy in ("ring", "ulysses"):
                ts = [t[:, sl].clone().requires_grad_(True)
                      for t in (q, k, v)]
                torch.cuda.synchronize()
                dist.barrier()
                K.reset_launches()
                collectives.reset_counts()
                t0 = time.perf_counter()
                out = sequence_parallel_attention(
                    *ts, mesh, strategy=strategy, causal=causal)
                torch.cuda.synchronize()
                fwd_s = time.perf_counter() - t0
                fwd_ledger = collectives.ledger()
                (out.float() * w[:, sl].float()).sum().backward()
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                rec = {"strategy": strategy, "causal": causal,
                       "dtype": str(dtype).replace("torch.", ""),
                       "seconds": sec, "forward_s": fwd_s,
                       "launches": _launches(SP_KERNELS[:2]),
                       "forward_collectives": fwd_ledger,
                       "collectives": collectives.ledger()}
                for what, (r_out, r_grads) in (("flash", flash),
                                               ("plain", plain)):
                    errs = dict(zip(("out", "dq", "dk", "dv"), [
                        _sp_err(out, r_out[:, sl])] + [
                        _sp_err(t.grad, g[:, sl])
                        for t, g in zip(ts, r_grads)]))
                    rec[f"vs_{what}"] = {
                        "max_abs_err": max(e["err"] for e in errs.values()),
                        "limit_share": max(e["share"]
                                           for e in errs.values()),
                        "tensors": errs}
                cases.append(rec)
                del ts, out
            del q, k, v, w, flash, plain
            torch.cuda.empty_cache()
    # the pipeline at pp=2
    pmesh = create_mesh({"pp": 2})
    params = _pp_params(2)
    x = _pp_x()
    got_p, ref_p = _leaf(params), _leaf(params)
    torch.cuda.synchronize()
    dist.barrier()
    K.reset_launches()
    collectives.reset_counts()
    t0 = time.perf_counter()
    out = pipeline_apply(_pp_stage, got_p, x, pmesh, n_microbatches=PP_MICRO)
    torch.cuda.synchronize()
    pp_fwd = time.perf_counter() - t0
    (out ** 2).sum().backward()
    torch.cuda.synchronize()
    pp_sec = time.perf_counter() - t0
    pp_launches = _launches()
    pp_ledger = collectives.ledger()
    # where the time goes: the same run again (warm), one stage call on
    # one microbatch, and one hop of a microbatch alone
    warm_p = _leaf(params)
    dist.barrier()
    t0 = time.perf_counter()
    warm = pipeline_apply(_pp_stage, warm_p, x, pmesh,
                          n_microbatches=PP_MICRO)
    (warm ** 2).sum().backward()
    torch.cuda.synchronize()
    parts = {"warm_s": time.perf_counter() - t0,
             "warm_bitwise": bool(torch.equal(warm, out)) and all(
                 torch.equal(warm_p[n].grad, got_p[n].grad)
                 for n in params)}
    mb = x[:PP_X[0] // PP_MICRO]
    with torch.no_grad():
        stage0 = {n: v[0] for n, v in params.items()}
        _pp_stage(stage0, mb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _pp_stage(stage0, mb)
        torch.cuda.synchronize()
        parts["stage_s"] = time.perf_counter() - t0
        dist.barrier()
        t0 = time.perf_counter()
        collectives.hop(mb, pmesh.group("pp"), "pp", 1)
        torch.cuda.synchronize()
        parts["hop_s"] = time.perf_counter() - t0

    def rel(a, b):
        a, b = a.detach(), b.detach()
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    def against(ref, ref_p):
        (ref ** 2).sum().backward()
        return {"out_rel_err": rel(out, ref),
                "grad_rel_err": {n: rel(got_p[n].grad[rank],
                                        ref_p[n].grad[rank])
                                 for n in params}}

    # the oracle at the pipeline's M (each microbatch in turn), the same
    # over the stage's plain twin, and on the whole batch at once
    micro = x.reshape((PP_MICRO, -1) + tuple(x.shape[1:]))
    pipe = {"seconds": pp_sec, "forward_s": pp_fwd, "parts": parts,
            "launches": pp_launches, "collectives": pp_ledger,
            **against(torch.cat([pipeline_reference(_pp_stage, ref_p, m)
                                 for m in micro]), ref_p),
            "other_stage_grads_zero": all(
                bool((got_p[n].grad[1 - rank] == 0).all()) for n in params)}
    plain_p = _leaf(params)
    pipe["vs_plain"] = against(torch.cat([
        pipeline_reference(_pp_stage_plain, plain_p, m) for m in micro]),
        plain_p)
    del plain_p
    whole_p = _leaf(params)
    pipe["whole_batch"] = against(pipeline_reference(_pp_stage, whole_p, x),
                                  whole_p)
    torch.cuda.synchronize()
    dist.barrier()
    K.reset_launches()
    collectives.reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        outw, sched = pipeline_window(_pp_stage, params,
                                      torch.stack([x] * PP_K), pmesh,
                                      n_microbatches=PP_MICRO)
    torch.cuda.synchronize()
    stage_rep = [r for r in introspect.reports("pipeline_stage")
                 if r["seq"] in sched["report_seqs"]]
    pipe["window"] = {"seconds": time.perf_counter() - t0,
                      "launches": _launches(),
                      "collectives": collectives.ledger(),
                      "schedule": sched,
                      "stage_flops": [r["flops"] for r in stage_rep],
                      "stage_flops_want": _pp_stage_flops(),
                      "bitwise": all(torch.equal(outw[i], out.detach())
                                     for i in range(PP_K))}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump({"cases": cases, "pipeline": pipe}, fh)
    dist.destroy_process_group()


def sequence_parallel_phase(smi):
    """Phase 34 (the module docstring's 34) -> (launches of the
    sequence-parallel paths, of the pipeline's, numbers)."""
    from paddle_tpu_torch.parallel import bubble_fraction
    t_phase = time.perf_counter()
    print(f"phase 34: sequence-parallel attention (ring, Ulysses) at "
          f"{SP_SHAPE} and the GPipe pipeline at x {PP_X}, "
          f"{PP_MICRO} microbatches: a one-rank NCCL world, two gloo "
          f"ranks time-slicing the card ({smi}); placement and parity, "
          "not scaling", flush=True)
    sp_launches, pp_launches, part_a = _sp_one_rank(smi)
    t0 = time.perf_counter()
    out_dir = os.path.join(HERE, "build", "sp_ranks")
    os.makedirs(out_dir, exist_ok=True)
    for fname in os.listdir(out_dir):
        os.unlink(os.path.join(out_dir, fname))
    init = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--sp-rank", str(r), init, out_dir])
             for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=SP_RANK_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"phase 34 ranks exited "
                             f"{[p.returncode for p in procs]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    part_b = time.perf_counter() - t0
    b, t, h, d = SP_SHAPE
    tl = t // 2
    for r, res in enumerate(ranks):
        for c in res["cases"]:
            label = (f"phase 34 rank {r} {c['strategy']} "
                     f"{'causal' if c['causal'] else 'full'} {c['dtype']}")
            for what in ("vs_flash", "vs_plain"):
                if not c[what]["limit_share"] <= 1.0:
                    raise AssertionError(f"{label}: {what} {c[what]}")
            item = 4 if c["dtype"] == "float32" else 2
            block = b * tl * h * d * item
            if c["strategy"] == "ring":
                blocks = 1 if c["causal"] and r == 0 else 2
                want = {"collective-permute": {"count": 2,
                                               "bytes": 2 * block}}
                total = 2 + 2 + 2 * 2
            else:
                blocks = 1
                want = {"all-to-all": {"count": 4, "bytes": 4 * block}}
                total = 8
            if c["forward_collectives"]["kinds"] != want \
                    or c["collectives"]["count"] != total:
                raise AssertionError(f"{label}: collectives "
                                     f"{c['collectives']}")
            if c["launches"] != {"flash_attention_fwd": blocks,
                                 "flash_attention_bwd": blocks}:
                raise AssertionError(f"{label}: launches {c['launches']}, "
                                     f"want {blocks} of each")
            for name, n in c["launches"].items():
                sp_launches[name] += n
        pipe = res["pipeline"]
        if not (pipe["out_rel_err"] <= PP_RTOL and max(
                pipe["grad_rel_err"].values()) <= PP_RTOL):
            raise AssertionError(f"phase 34 rank {r} pipeline: out "
                                 f"{pipe['out_rel_err']}, grads "
                                 f"{pipe['grad_rel_err']}")
        for what, tol in (("whole_batch", PP_RTOL), ("vs_plain", F32_TOL)):
            if not (pipe[what]["out_rel_err"] <= tol and max(
                    pipe[what]["grad_rel_err"].values()) <= tol):
                raise AssertionError(f"phase 34 rank {r} pipeline {what}: "
                                     f"{pipe[what]}")
        if not pipe["parts"]["warm_bitwise"]:
            raise AssertionError(f"phase 34 rank {r}: the pipeline's second "
                                 "run is not bitwise its first")
        if not pipe["other_stage_grads_zero"]:
            raise AssertionError(f"phase 34 rank {r}: the other stage's "
                                 "gradient rows are not zero")
        want = {"flash_attention_fwd": PP_MICRO,
                "flash_attention_bwd": PP_MICRO,
                "layer_norm_fwd": 2 * PP_MICRO,
                "layer_norm_bwd": 2 * PP_MICRO}
        if pipe["launches"] != want:
            raise AssertionError(f"phase 34 rank {r} pipeline launches "
                                 f"{pipe['launches']}, want {want}")
        ticks = PP_MICRO + 2 - 1
        micro = PP_X[0] // PP_MICRO * PP_X[1] * PP_X[2] * 4
        kinds = pipe["collectives"]["kinds"]
        if kinds != {"collective-permute": {"count": 2 * ticks,
                                            "bytes": 2 * ticks * micro},
                     "all-reduce": {"count": 1, "bytes": 4 * micro}}:
            raise AssertionError(f"phase 34 rank {r} pipeline collectives "
                                 f"{kinds}")
        win = pipe["window"]
        if win["stage_flops"] != [win["stage_flops_want"]]:
            raise AssertionError(f"phase 34 rank {r} pipeline_window: stage "
                                 f"flops {win['stage_flops']}, want "
                                 f"{win['stage_flops_want']}")
        if not win["bitwise"] or win["schedule"]["bubble_fraction"] != \
                bubble_fraction(2, PP_MICRO) or \
                win["schedule"]["bubble_fraction"] != 0.2:
            raise AssertionError(f"phase 34 rank {r} pipeline_window: "
                                 f"{win['schedule']}, bitwise "
                                 f"{win['bitwise']}")
        for key in (pipe["launches"], win["launches"]):
            for name, n in key.items():
                pp_launches[name] += n
    e2e = {"card": smi, "part_a_s": part_a["seconds"], "part_b_s": part_b,
           "shape": list(SP_SHAPE), "pipeline_x": list(PP_X),
           "n_microbatches": PP_MICRO,
           "ranks": ranks, "seconds": time.perf_counter() - t_phase}
    print(f"  end to end ({smi}): {json.dumps(e2e)}", flush=True)
    return sp_launches, pp_launches, e2e


def sequence_parallel_ab(smi):
    from paddle_tpu_torch.ops import _build, kernels as K
    _build.build_all({k.source for k in K.KERNELS if k.name in SP_KERNELS})
    sp, pp, e2e = sequence_parallel_phase(smi)
    return {"sequence_parallel": dict(e2e, launches_sequence_parallel=sp,
                                      launches_pipeline=pp)}


# ---------------------------------------------------------------------------
# phase 35: the dataset master and the parameter server
# ---------------------------------------------------------------------------

#: the master's dataset: 8 record files of 8 chunks of 32 fit-a-line
#: samples (x [4], y = x . w)
MS_FILES, MS_CHUNKS, MS_RECORDS = 8, 8, 32
MS_TASK_TIMEOUT, MS_BATCH = 2.0, 16
MS_TIMEOUT = 300.0
#: the parameter server's LM: TRAIN_CONFIG at depth 2 (cut from 12),
#: batch 16 a trainer, SGD, 2 rounds of 2 trainers (cut from 3 to keep
#: the whole run inside its time limit)
PS_CONFIG = dict(TRAIN_CONFIG, n_layers=2)
PS_TRAINERS, PS_ROUNDS, PS_LR = 2, 2, 0.01
PS_KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
              "layer_norm_fwd", "layer_norm_bwd", "softmax_xent_fwd",
              "softmax_xent_bwd")
PS_LAUNCHES_PER_ROUND = {
    "flash_attention_fwd": 2, "flash_attention_bwd": 2,
    "layer_norm_fwd": 4, "layer_norm_bwd": 4,
    "softmax_xent_fwd": 1, "softmax_xent_bwd": 1}


def _ms_dataset(root, seed=35):
    """The master's record files (the port's writer) -> (paths, w)."""
    from paddle_tpu_torch import recordio
    from paddle_tpu_torch.recordio_writer import serialize_sample
    rng = np.random.default_rng(seed)
    w = rng.random((4, 1)).astype(np.float32)
    os.makedirs(root, exist_ok=True)
    paths = []
    for fi in range(MS_FILES):
        p = os.path.join(root, f"part-{fi:02d}.recordio")
        with recordio.Writer(p, max_chunk_records=MS_RECORDS) as wr:
            for _ in range(MS_CHUNKS * MS_RECORDS):
                x = rng.random(4).astype(np.float32)
                wr.write(serialize_sample((x, (x @ w).astype(np.float32))))
        paths.append(p)
    return paths, w


def _wait_port_file(path, timeout=MS_TIMEOUT):
    """The port a server published in ``path`` (written atomically)."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no port file {path} after {timeout} s")
        time.sleep(0.05)
    with open(path) as f:
        return int(f.read().strip())


def _ms_worker(index, port_file, data_dir, out_dir, victim):
    """One of phase 35 (a)'s workers: lease tasks through MasterClient
    and train tests/test_dist_train.py's fit-a-line program on the card
    over their records, until the pass ends.  The survivor starts once
    the victim has finished its first task; the victim then leases one
    more, says so in its progress file and waits for its SIGKILL."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.distributed import MasterClient, NoMoreTasks
    from paddle_tpu_torch.recordio import Scanner
    from paddle_tpu_torch.recordio_writer import deserialize_sample
    torch.cuda.set_device(0)
    progress = open(os.path.join(out_dir, f"w{index}.progress"), "a")
    c = MasterClient("127.0.0.1", _wait_port_file(port_file),
                     worker=f"w{index}", retry_interval=0.05)
    c.set_dataset(sorted(os.path.join(data_dir, f)
                         for f in os.listdir(data_dir)))
    c.register()
    x = layers.data(name="x", shape=[4], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    pred = layers.fc(input=x, size=1)
    loss = layers.mean(layers.square_error_cost(input=pred, label=y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(fluid.default_startup_program())
    finished, losses, n_records = [], [], 0
    t0 = time.perf_counter()
    if not victim:
        # lease nothing until the victim has finished its first task
        victim_log = os.path.join(out_dir, "w1.progress")
        while not (os.path.exists(victim_log)
                   and "finished" in open(victim_log).read()):
            time.sleep(0.02)
    while True:
        try:
            task = c.get_task()
        except NoMoreTasks as e:
            if e.retryable:
                time.sleep(0.1)
                continue
            break
        if victim and finished:
            progress.write(f"leased {task.id}\n")
            progress.flush()
            time.sleep(MS_TIMEOUT)
        batch = []
        for rec in Scanner(task.path, task.chunk_begin, task.chunk_end):
            n_records += 1
            batch.append(deserialize_sample(rec))
            if len(batch) == MS_BATCH:
                (l,) = exe.run(fluid.default_main_program(), feed={
                    "x": np.stack([b[0] for b in batch]),
                    "y": np.stack([b[1] for b in batch])},
                    fetch_list=[loss])
                losses.append(float(l))
                batch = []
        c.task_finished(task.id)
        finished.append(task.id)
        progress.write(f"finished {task.id}\n")
        progress.flush()
    c.close()
    with open(os.path.join(out_dir, f"w{index}.json"), "w") as fh:
        json.dump({"finished": finished, "losses": losses,
                   "records": n_records,
                   "seconds": time.perf_counter() - t0}, fh)


def _master_leg(smi, root):
    """Phase 35 (a) -> its numbers."""
    import signal
    t0 = time.perf_counter()
    data_dir = os.path.join(root, "data")
    out_dir = os.path.join(root, "workers")
    os.makedirs(out_dir, exist_ok=True)
    for fname in os.listdir(out_dir):
        os.unlink(os.path.join(out_dir, fname))
    paths, _ = _ms_dataset(data_dir)
    port_file = os.path.join(root, "master.port")
    if os.path.exists(port_file):
        os.unlink(port_file)
    env = dict(os.environ, PYTHONPATH=HERE)
    master = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "pserver", "--host",
         "127.0.0.1", "--port", "0", "--port-file", port_file,
         "--task-timeout", str(MS_TASK_TIMEOUT)], cwd=HERE, env=env)
    workers = []
    try:
        # the workers start beside the master and wait for its port file
        workers = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--master-worker",
             str(i), port_file, data_dir, out_dir, str(int(i == 1))])
            for i in range(2)]
        _wait_port(port_file, master, 60)
        victim, survivor = workers[1], workers[0]
        progress = os.path.join(out_dir, "w1.progress")
        deadline = time.monotonic() + MS_TIMEOUT
        while True:
            if os.path.exists(progress) and "leased" in open(progress).read():
                break
            if victim.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"phase 35 (a): the victim ended "
                                     f"({victim.returncode}) before its "
                                     "second lease")
            time.sleep(0.05)
        victim.send_signal(signal.SIGKILL)
        victim.wait()
        t_kill = time.perf_counter() - t0
        survivor.wait(timeout=MS_TIMEOUT)
        if survivor.returncode != 0:
            raise AssertionError(f"phase 35 (a): the survivor exited "
                                 f"{survivor.returncode}")
    finally:
        for p in workers + [master]:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
    with open(os.path.join(out_dir, "w0.json")) as fh:
        res = json.load(fh)
    lines = open(progress).read().split()
    victim_done = [int(v) for k, v in zip(lines[::2], lines[1::2])
                   if k == "finished"]
    leased = [int(v) for k, v in zip(lines[::2], lines[1::2])
              if k == "leased"]
    done = res["finished"] + victim_done
    n_tasks = MS_FILES * MS_CHUNKS
    if sorted(done) != list(range(n_tasks)):
        raise AssertionError(f"phase 35 (a): tasks finished {sorted(done)}, "
                             f"want each of {n_tasks} once")
    if leased[0] not in res["finished"]:
        raise AssertionError(f"phase 35 (a): the victim's lease "
                             f"{leased[0]} was not finished by the survivor")
    losses = res["losses"]
    head, tail = np.mean(losses[:8]), np.mean(losses[-8:])
    if not tail < 0.2 * head:
        raise AssertionError(f"phase 35 (a): the survivor's loss went from "
                             f"{head} to {tail}")
    return {"seconds": time.perf_counter() - t0, "kill_at_s": t_kill,
            "tasks": n_tasks, "survivor_tasks": len(res["finished"]),
            "victim_tasks": len(victim_done), "victim_lease": leased[0],
            "survivor_records": res["records"],
            "survivor_loss_first8": float(head),
            "survivor_loss_last8": float(tail),
            "survivor_seconds": res["seconds"]}


def _ps_programs(endpoint=None):
    """PS_CONFIG's LM loss, its backward and, with ``endpoint``, the Send
    of every gradient for its parameter, in fresh default programs ->
    (main, startup, loss, [(param, grad)])."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models import transformer
    fluid.core.program.reset_default_programs()
    cfg = {k: PS_CONFIG[k] for k in ("vocab", "max_len", "n_layers",
                                     "d_model", "n_heads", "d_ff")}
    tokens = layers.data(name="tokens", shape=[cfg["max_len"]],
                         dtype="int64")
    labels = layers.data(name="labels", shape=[cfg["max_len"]],
                         dtype="int64")
    logits = transformer.transformer_lm_logits(tokens, **cfg)
    cost = layers.softmax_with_cross_entropy(
        logits=logits, label=layers.reshape(labels,
                                            shape=[-1, cfg["max_len"], 1]))
    loss = layers.mean(cost)
    pairs = fluid.backward.append_backward(loss)
    if endpoint:
        layers.Send(endpoint, [g for _, g in pairs], [p for p, _ in pairs])
    startup = fluid.default_startup_program()
    startup.random_seed = 35
    return fluid.default_main_program(), startup, loss, pairs


def _ps_feed(rnd, trainer):
    rng = np.random.default_rng(1000 * rnd + trainer)
    seqs = rng.integers(0, PS_CONFIG["vocab"],
                        (TRAIN_BATCH, PS_CONFIG["max_len"])).astype(np.int64)
    return {"tokens": seqs, "labels": np.roll(seqs, -1, axis=1)}


def _ps_digest(values):
    import hashlib
    h = hashlib.sha256()
    for name in sorted(values):
        h.update(name.encode())
        h.update(np.ascontiguousarray(values[name]).tobytes())
    return h.hexdigest()


def _ps_server(state_path, port_file, out_path):
    """Phase 35 (b)'s pserver: a ListenAndServ(fan_in=2) program whose
    sub-block applies SGD to every parameter from its summed gradient,
    on the card, until the shutdown message; then its metrics as JSON."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.distributed import param_server as ps
    from paddle_tpu_torch.observability import default_registry
    torch.cuda.set_device(0)
    default_registry().enable()
    state = dict(np.load(state_path))
    names = sorted(state)
    main = fluid.Program()
    scope = fluid.core.scope.Scope()
    with fluid.program_guard(main, fluid.Program()):
        block = main.global_block()
        for n in names:
            block.create_var(name=n, shape=state[n].shape, dtype="float32",
                             persistable=True)
        lr = block.create_var(name="ps_lr", shape=(1,), dtype="float32",
                              persistable=True)
        serv = layers.ListenAndServ("127.0.0.1:0", [n + "@GRAD"
                                                    for n in names],
                                    fan_in=PS_TRAINERS)
        with serv.do():
            for n in names:
                g = layers.data(name=n + "@GRAD", shape=list(state[n].shape),
                                dtype="float32", append_batch_size=False)
                main.current_block().append_op(
                    type="sgd", inputs={"Param": [n], "Grad": [g],
                                        "LearningRate": [lr]},
                    outputs={"ParamOut": [n]})
    for n in names:
        scope.set(n, torch.tensor(state[n], device="cuda"))
    scope.set("ps_lr", torch.full((1,), PS_LR, device="cuda"))
    ps.SELECTED_PORT_FILE = port_file
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CUDAPlace(0)).run(main)
    with open(out_path, "w") as fh:
        json.dump({"pserver_rounds_total": ps._PS_ROUNDS.value,
                   "round_seconds": {"count": ps._PS_ROUND_S.count,
                                     "sum": ps._PS_ROUND_S.sum},
                   "straggler_gap_seconds": {
                       "count": ps._PS_STRAGGLER_S.count,
                       "sum": ps._PS_STRAGGLER_S.sum,
                       "max": ps._PS_STRAGGLER_S.percentile(100)}}, fh)


def _ps_trainer(index, state_path, port_file, out_path):
    """One of phase 35 (b)'s trainers: PS_ROUNDS rounds of its batch's
    gradients sent through the Send op, the parameters the reply brings
    digested after each."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import _build, kernels as K
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    _build.build_all({k.source for k in K.KERNELS if k.name in PS_KERNELS})
    main, startup, loss, pairs = _ps_programs(
        f"127.0.0.1:{_wait_port_file(port_file)}")
    state = dict(np.load(state_path))
    scope = fluid.core.scope.Scope()
    rounds = []
    launches = dict.fromkeys(PS_KERNELS, 0)
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        for n, v in state.items():
            scope.set(n, torch.tensor(v, device="cuda"))
        for r in range(PS_ROUNDS):
            feed = _ps_feed(r, index)
            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.perf_counter()
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss])
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            for name, n in _launches(PS_KERNELS).items():
                launches[name] += n
            params = {p.name: scope.get(p.name).cpu().numpy()
                      for p, _ in pairs}
            rounds.append({"seconds": sec, "loss": float(lv),
                           "launches": _launches(PS_KERNELS),
                           "digest": _ps_digest(params)})
    grad_bytes = sum(int(np.prod(p.shape)) * 4 for p, _ in pairs)
    # where a round's time goes: the wire codec alone, one message each
    # way (base64 in JSON, as send_round_trip and the server do)
    from paddle_tpu_torch.distributed import param_server as ps
    t0 = time.perf_counter()
    line = json.dumps({"method": "send", "vars": {
        p.name: ps._encode(v) for (p, _), v in zip(
            pairs, (scope.get(p.name).cpu().numpy() for p, _ in pairs))}})
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    {k: ps._decode(v) for k, v in json.loads(line)["vars"].items()}
    codec = {"encode_s": encode_s, "decode_s": time.perf_counter() - t0,
             "line_bytes": len(line)}
    with open(out_path, "w") as fh:
        json.dump({"rounds": rounds, "launches": launches, "codec": codec,
                   "grad_bytes": grad_bytes,
                   "wire_bytes_each_way": sum(
                       4 * -(-int(np.prod(p.shape)) * 4 // 3)
                       for p, _ in pairs)}, fh)


def _ps_reference(state):
    """The single-process card run: each round, both batches' gradients
    at the current parameters, summed, and the sgd rule's update
    ``(p - lr * g)`` -> (losses by round and trainer, digests by round)."""
    import torch
    import paddle_tpu_torch as fluid
    main, startup, loss, pairs = _ps_programs()
    scope = fluid.core.scope.Scope()
    lr = torch.full((1,), PS_LR, device="cuda").reshape(())
    losses, digests = [], []
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        for n, v in state.items():
            scope.set(n, torch.tensor(v, device="cuda"))
        for r in range(PS_ROUNDS):
            total, row = None, []
            for i in range(PS_TRAINERS):
                out = exe.run(main, feed=_ps_feed(r, i),
                              fetch_list=[loss] + [g for _, g in pairs],
                              return_numpy=False)
                row.append(float(out[0]))
                grads = [g.clone() for g in out[1:]]
                total = grads if total is None else [
                    a + b for a, b in zip(total, grads)]
            losses.append(row)
            with torch.no_grad():
                for (p, _), g in zip(pairs, total):
                    cur = scope.get(p.name)
                    scope.set(p.name, (cur - lr * g).to(cur.dtype))
            digests.append(_ps_digest({p.name: scope.get(p.name).cpu()
                                       .numpy() for p, _ in pairs}))
    return losses, digests


def _pserver_leg(smi, root):
    """Phase 35 (b) -> (the trainers' launches, numbers)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed import param_server as ps
    t0 = time.perf_counter()
    _, startup, _, pairs = _ps_programs()
    state = {n: v for n, v in _startup_state(startup, fluid.CPUPlace())
             .items() if n in {p.name for p, _ in pairs}}
    state_path = os.path.join(root, "ps_state.npz")
    np.savez(state_path, **state)
    port_file = os.path.join(root, "ps.port")
    if os.path.exists(port_file):
        os.unlink(port_file)
    server_out = os.path.join(root, "pserver.json")
    server = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--ps-server", state_path, port_file,
                               server_out])
    trainers = []
    try:
        # the trainers start beside the pserver and wait for its port file
        trainers = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ps-trainer",
             str(i), state_path, port_file,
             os.path.join(root, f"trainer{i}.json")])
            for i in range(PS_TRAINERS)]
        endpoint = f"127.0.0.1:{_wait_port(port_file, server, 120)}"
        ref_losses, ref_digests = _ps_reference(state)
        torch.cuda.empty_cache()
        for p in trainers:
            p.wait(timeout=MS_TIMEOUT)
        if any(p.returncode != 0 for p in trainers):
            raise AssertionError(f"phase 35 (b): trainers exited "
                                 f"{[p.returncode for p in trainers]}")
        ps.shutdown_server(endpoint)
        server.wait(timeout=60)
        if server.returncode != 0:
            raise AssertionError(f"phase 35 (b): the pserver exited "
                                 f"{server.returncode}")
    finally:
        for p in trainers + [server]:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = []
    for i in range(PS_TRAINERS):
        with open(os.path.join(root, f"trainer{i}.json")) as fh:
            res.append(json.load(fh))
    with open(server_out) as fh:
        served = json.load(fh)
    launches = dict.fromkeys(PS_KERNELS, 0)
    for i, tr in enumerate(res):
        for r, rec in enumerate(tr["rounds"]):
            if rec["digest"] != ref_digests[r]:
                raise AssertionError(
                    f"phase 35 (b): trainer {i}'s parameters after round "
                    f"{r} are not bitwise the single-process card run")
            if rec["loss"] != ref_losses[r][i]:
                raise AssertionError(
                    f"phase 35 (b): trainer {i}'s round {r} loss "
                    f"{rec['loss']}, the single-process run's "
                    f"{ref_losses[r][i]}")
            if rec["launches"] != PS_LAUNCHES_PER_ROUND:
                raise AssertionError(f"phase 35 (b): trainer {i} round {r} "
                                     f"launches {rec['launches']}")
        for name, n in tr["launches"].items():
            launches[name] += n
    if served["pserver_rounds_total"] != PS_ROUNDS:
        raise AssertionError(f"phase 35 (b): pserver_rounds_total "
                             f"{served['pserver_rounds_total']}")
    return launches, {
        "seconds": time.perf_counter() - t0,
        "config": PS_CONFIG, "batch": TRAIN_BATCH, "lr": PS_LR,
        "grad_bytes_per_trainer_round": res[0]["grad_bytes"],
        "wire_base64_bytes_each_way": res[0]["wire_bytes_each_way"],
        "round_seconds": [[rec["seconds"] for rec in tr["rounds"]]
                          for tr in res],
        "codec": [tr["codec"] for tr in res],
        "losses": ref_losses, "pserver": served}


def pserver_phase(smi):
    """Phase 35 (the module docstring's 35) -> (launches, numbers)."""
    t_phase = time.perf_counter()
    print(f"phase 35: the dataset master (the pserver verb, two workers on "
          f"the card, one SIGKILLed) and the parameter server on the LM at "
          f"{PS_CONFIG} (depth cut from {TRAIN_CONFIG['n_layers']}), batch "
          f"{TRAIN_BATCH}, {PS_TRAINERS} trainers, {PS_ROUNDS} rounds "
          f"({smi})", flush=True)
    root = os.path.join(HERE, "build", "pserver")
    os.makedirs(root, exist_ok=True)
    master = _master_leg(smi, root)
    launches, served = _pserver_leg(smi, root)
    e2e = {"card": smi, "master": master, "pserver": served,
           "seconds": time.perf_counter() - t_phase}
    print(f"  end to end ({smi}): {json.dumps(e2e)}", flush=True)
    return launches, e2e


def pserver_ab(smi):
    from paddle_tpu_torch.ops import _build, kernels as K
    _build.build_all({k.source for k in K.KERNELS if k.name in PS_KERNELS})
    launches, e2e = pserver_phase(smi)
    return {"pserver": dict(e2e, launches=launches)}


# ---------------------------------------------------------------------------
# phase 36: the legacy training API (paddle_tpu_torch.v2)
# ---------------------------------------------------------------------------

#: leg (a): the GRU classifier of tools/gru_bench.py:47-54 in the v2 DSL
#: at GRU_CONFIG's width, f32, Adam 1e-3, batch SEQ_BATCH, T SEQ_T at full
#: lengths, V2_GRU_STEPS steps; the card-against-CPU step at batch
#: SEQ_CPU_BATCH (ragged) and paddle.infer over V2_INFER_SAMPLES samples
V2_GRU_STEPS, V2_INFER_SAMPLES = 20, 64
#: leg (b): networks.small_vgg on CIFAR-10 shapes (3x32x32, 10 classes)
#: as the reference's demo/image_classification/vgg_16_cifar.py
#: configures it: batch 128, Momentum(0.9, 0.1 / 128), L2 5e-4 * 128
V2_VGG_BATCH, V2_VGG_STEPS, V2_VGG_TEST_BATCH = 128, 10, 32
#: the BatchNorm backward's launches a small_vgg step: the 10 conv
#: blocks' BatchNorms (relu fused, NCHW) and the one over the fc output
V2_VGG_BN_PER_STEP = 11
#: small_vgg's BatchNorm backward launches at batch V2_VGG_BATCH, as the
#: (C, S) of their [N, C, S] views, f32 with relu fused in each: the four
#: conv groups at 32x32, 16x16, 8x8 and 4x4 (two, two, three and three
#: blocks) and the fc's [N, 512]; each is a launch geometry of its own
#: (`kernels.bn_bwd_geometry`), so each is checked (`_v2_vgg_leg`
#: asserts that the program's BatchNorms are these)
V2_VGG_BN_SHAPES = {"group 1": (64, 32 * 32), "group 2": (128, 16 * 16),
                    "group 3": (256, 8 * 8), "group 4": (512, 4 * 4),
                    "fc": (512, 1)}
#: the whole-model rule (ROADMAP): each value's max abs error over its
#: tensor's max |value|
V2_TOL = 1e-4
V2_KERNELS = ("gru_fwd", "gru_bwd", "batch_norm_bwd")


def _v2_rel(got, want):
    """Max abs error of ``got`` against ``want`` over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"shapes {got.shape} and {want.shape}")
    return float(np.abs(got - want).max(initial=0.0)
                 / max(float(np.abs(want).max(initial=0.0)), 1e-30))


def _v2_gru_topology(paddle):
    """The GRU classifier in the v2 DSL -> (cost, prediction)."""
    vocab, hid = GRU_CONFIG["vocab"], GRU_CONFIG["hid"]
    word = paddle.layer.data(
        name="word", type=paddle.data_type.integer_value_sequence(vocab))
    label = paddle.layer.data(name="label",
                              type=paddle.data_type.integer_value(2))
    emb = paddle.layer.embedding(input=word, size=hid)
    gru = paddle.networks.simple_gru(input=emb, size=hid)
    pooled = paddle.layer.pooling(input=gru,
                                  pooling_type=paddle.pooling.Max())
    pred = paddle.layer.fc(input=pooled, size=2,
                           act=paddle.activation.Softmax())
    return paddle.layer.classification_cost(input=pred, label=label), pred


def _v2_gru_provider(n, seed, ragged=False):
    """A PyDataProvider2 @provider of ``n`` seeded samples: SEQ_T ids (a
    seeded length in [1, SEQ_T] with ``ragged``, the first full and the
    last of length 1) and a binary label."""
    from paddle_tpu_torch.trainer.PyDataProvider2 import (
        integer_value, integer_value_sequence, provider)

    @provider(input_types=[integer_value_sequence(GRU_CONFIG["vocab"]),
                           integer_value(2)], should_shuffle=False)
    def samples(settings, filename):
        rng = np.random.default_rng(seed)
        lens = (rng.integers(1, SEQ_T + 1, n) if ragged
                else np.full(n, SEQ_T))
        if ragged:
            lens[0], lens[-1] = SEQ_T, 1
        for length in lens:
            yield (rng.integers(0, GRU_CONFIG["vocab"], int(length)),
                   int(rng.integers(0, 2)))

    return samples


def _v2_train_timed(paddle, trainer, reader):
    """``trainer.train`` over ``reader`` (one pass), the host clock read
    after a synchronise at every EndIteration -> (costs, ms between
    consecutive EndIteration events, the first step's ms)."""
    import torch
    stamps, costs = [], []

    def handler(ev):
        if isinstance(ev, paddle.event.BeginPass):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        elif isinstance(ev, paddle.event.EndIteration):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            costs.append(ev.cost)

    trainer.train(reader, num_passes=1, event_handler=handler)
    ms = [(b - a) * 1e3 for a, b in zip(stamps[:-1], stamps[1:])]
    return costs, ms[1:], ms[0]


def _v2_profile(trainer, batch):
    """Two more ``trainer.train`` steps on ``batch`` under torch.profiler,
    the first its warm-up (not kept) -> (device ms of every kernel of the
    second, {kernel name: launches} in it, {wrapper: launches} in it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from paddle_tpu_torch.ops import kernels as K
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            K.reset_launches()
            trainer.train(lambda: iter([batch]), num_passes=1)
            torch.cuda.synchronize()
            prof.step()
    wrappers = {k.name: k.launches for k in K.KERNELS}
    annotations = {e.name for e in prof.events()
                   if getattr(e, "is_user_annotation", False)}
    rows = [r for r in prof.key_averages()
            if r.device_type == torch.autograd.DeviceType.CUDA
            and not r.key.startswith("op:") and r.key not in annotations]
    total = sum(r.device_time_total for r in rows) / 1e3
    counts = {r.key: r.count for r in rows}
    print(f"  profiled step: {total:.3f} device ms in "
          f"{sum(counts.values())} kernel launches; the port's: "
          + ", ".join(f"{k[:70]} x{n}" for k, n in sorted(counts.items())
                      if any(f in k for f in ("gru_", "bn_", "rnn_")))
          + "; the eight longest (ms, launches): " + "; ".join(
              f"{r.device_time_total / 1e3:.3f} x{r.count} {r.key[:60]}"
              for r in sorted(rows, key=lambda r: -r.device_time_total)[:8]),
          flush=True)
    return total, counts, wrappers


def _v2_profiled_numbers(leg, device_ms, p50, profiled, wrappers):
    """The profiled step's device ms and busy share, or None for both
    where the profile holds fewer of a kernel's launches than its
    wrapper counted in that step (the profile lost events)."""
    complete = all(profiled[k] >= wrappers[k] for k in profiled)
    print(f"  {leg} the profiled step's kernels: {profiled} in the "
          f"profile, {dict((k, wrappers[k]) for k in profiled)} by the "
          f"wrappers' counts"
          + ("" if complete else "; the profile lost launches, so its "
             "device ms and busy share are not kept"), flush=True)
    return {"profile_complete": complete,
            "profiled_device_ms": device_ms if complete else None,
            "device_busy_share": device_ms / p50 if complete else None}


def _v2_step_numbers(ms, batch, first_ms):
    p50, p99 = float(np.percentile(ms, 50)), float(np.percentile(ms, 99))
    return {"step1_ms": first_ms, "step_ms_p50": p50, "step_ms_p99": p99,
            "examples_per_s": batch * 1e3 / p50}


def _v2_launch_check(leg, launches, want):
    print(f"  {leg} launches: {launches}", flush=True)
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"phase 36 {leg}: {name} launched "
                                 f"{launches[name]} times, want {n}")


def _v2_params_copy(paddle, params, names):
    """A tar of ``params``' values of ``names`` (the topology's
    parameters) -> a maker of fresh Parameters objects holding them."""
    import io
    sub = paddle.parameters.Parameters()
    for n in names:
        sub.set(n, params.get(n))
    buf = io.BytesIO()
    sub.to_tar(buf)
    raw = buf.getvalue()
    return lambda: paddle.parameters.Parameters.from_tar(io.BytesIO(raw))


def _v2_gru_leg(paddle, smi):
    """Leg (a) -> (launches, numbers)."""
    import io
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import kernels as K
    cost, pred = _v2_gru_topology(paddle)
    params = paddle.parameters.create(cost)
    names = params.names()
    trainer = paddle.trainer.SGD(
        cost=cost, parameters=params,
        update_equation=paddle.optimizer.Adam(learning_rate=1e-3))
    reader = paddle.batch(_v2_gru_provider(SEQ_BATCH * V2_GRU_STEPS, 36),
                          SEQ_BATCH)
    K.reset_launches()
    costs, ms, first = _v2_train_timed(paddle, trainer, reader)
    launches = {k.name: k.launches for k in K.KERNELS}
    _v2_launch_check("(a)", launches, {"gru_fwd": V2_GRU_STEPS,
                                       "gru_bwd": V2_GRU_STEPS})
    if len(costs) != V2_GRU_STEPS or not np.all(np.isfinite(costs)):
        raise AssertionError(f"phase 36 (a): costs {costs}")
    e2e = _v2_step_numbers(ms, SEQ_BATCH, first)
    device_ms, counts, step = _v2_profile(trainer, next(reader()))
    _v2_launch_check("(a) the profiled step", step,
                     {"gru_fwd": 1, "gru_bwd": 1})
    profiled = {name: sum(n for k, n in counts.items()
                          if name + "_kernel" in k)
                for name in ("gru_fwd", "gru_bwd")}
    e2e.update(cost_first=costs[0], cost_last=costs[-1],
               gru_launches_profiled=profiled,
               **_v2_profiled_numbers("(a)", device_ms, e2e["step_ms_p50"],
                                      profiled, step))
    print(f"  (a) step p50 {e2e['step_ms_p50']:.3f} ms, p99 "
          f"{e2e['step_ms_p99']:.3f}, {e2e['examples_per_s']:.1f} "
          f"examples/s, busy share {e2e['device_busy_share']} ({smi})",
          flush=True)

    # one plain-SGD step (lr 1: each parameter moves by its gradient; an
    # Adam step moves each by about lr whatever its gradient) at batch 4
    # with ragged lengths, from the same Parameters on the card and the
    # CPU
    fresh = _v2_params_copy(paddle, params, names)
    batch = next(paddle.batch(_v2_gru_provider(SEQ_CPU_BATCH, 37,
                                               ragged=True),
                              SEQ_CPU_BATCH)())
    after = {}
    for key, place in (("card", fluid.CUDAPlace(0)),
                       ("cpu", fluid.CPUPlace())):
        p = fresh()
        got = []
        paddle.trainer.SGD(
            cost=cost, parameters=p,
            update_equation=paddle.optimizer.Optimizer(learning_rate=1.0),
            place=place).train(
            lambda: iter([batch]), num_passes=1,
            event_handler=lambda ev: got.append(ev.cost) if isinstance(
                ev, paddle.event.EndIteration) else None)
        after[key] = (got[0], {n: p.get(n) for n in names})
    cost_err = abs(after["card"][0] - after["cpu"][0]) / abs(after["cpu"][0])
    param_errs = sorted(((_v2_rel(after["card"][1][n], after["cpu"][1][n]),
                          n) for n in names), reverse=True)
    print(f"  (a) card against CPU, one step at batch {SEQ_CPU_BATCH} "
          f"(ragged): cost {cost_err:.3e}, parameters "
          + ", ".join(f"{n} {e:.3e}" for e, n in param_errs)
          + f" (limit {V2_TOL})", flush=True)
    if cost_err > V2_TOL or param_errs[0][0] > V2_TOL:
        raise AssertionError("phase 36 (a): the card's step disagrees with "
                             "the CPU's")

    # paddle.infer on the card against the CPU's, from the trained values
    samples = [(s[0],) for s in _v2_gru_provider(V2_INFER_SAMPLES, 38,
                                                 ragged=True)()]
    probs = {key: paddle.infer(output_layer=pred, parameters=params,
                               input=samples, place=place)
             for key, place in (("card", fluid.CUDAPlace(0)),
                                ("cpu", fluid.CPUPlace()))}
    infer_err = _v2_rel(probs["card"], probs["cpu"])
    print(f"  (a) paddle.infer over {V2_INFER_SAMPLES} samples "
          f"{probs['card'].shape}: card against CPU {infer_err:.3e} (limit "
          f"{V2_TOL})", flush=True)
    if probs["card"].shape != (V2_INFER_SAMPLES, 2) or infer_err > V2_TOL:
        raise AssertionError("phase 36 (a): paddle.infer on the card "
                             "disagrees with the CPU's")

    # the trained parameters through to_tar and from_tar, bitwise
    buf = io.BytesIO()
    params.to_tar(buf)
    buf.seek(0)
    back = paddle.parameters.Parameters.from_tar(buf)
    if sorted(back.names()) != sorted(params.names()) or not all(
            np.array_equal(back.get(n), params.get(n))
            and back.get(n).dtype == params.get(n).dtype
            for n in params.names()):
        raise AssertionError("phase 36 (a): from_tar(to_tar(params)) is "
                             "not bitwise the trained parameters")
    print(f"  (a) to_tar/from_tar: {len(params.names())} values, "
          f"{buf.getbuffer().nbytes} bytes, bitwise", flush=True)
    e2e.update(card_vs_cpu={"cost_rel_err": cost_err,
                            "param_rel_err_max": param_errs[0][0],
                            "params_compared": len(names),
                            "infer_rel_err": infer_err},
               tar_bytes=buf.getbuffer().nbytes, tar_bitwise=True)
    del trainer
    torch.cuda.empty_cache()
    return {k: launches[k] for k in V2_KERNELS}, e2e


def _v2_vgg_samples(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3 * 32 * 32), dtype=np.float32)
    y = rng.integers(0, 10, n)
    return lambda: ((x[i], int(y[i])) for i in range(n))


def _v2_vgg_leg(paddle, smi):
    """Leg (b) -> (launches, numbers)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import kernels as K
    images = paddle.layer.data(
        name="pixel", type=paddle.data_type.dense_vector(3 * 32 * 32),
        height=32, width=32)
    label = paddle.layer.data(name="label",
                              type=paddle.data_type.integer_value(10))
    out = paddle.networks.small_vgg(input_image=images, num_channels=3,
                                    num_classes=10)
    cost = paddle.layer.classification_cost(input=out, label=label)
    params = paddle.parameters.create(cost)
    names = params.names()

    def momentum():
        return paddle.optimizer.Momentum(
            momentum=0.9, learning_rate=0.1 / V2_VGG_BATCH,
            regularization=paddle.optimizer.L2Regularization(
                rate=5e-4 * V2_VGG_BATCH))

    trainer = paddle.trainer.SGD(cost=cost, parameters=params,
                                 update_equation=momentum())
    block = trainer._prog.global_block()
    bn = [(tuple(block.var(op.desc.inputs["X"][0]).shape),
           op.desc.attrs.get("act"))
          for op in block.ops if op.type == "batch_norm"]
    views = {((shape[1], int(np.prod(shape[2:], dtype=np.int64))), act)
             for shape, act in bn}
    if (len(bn) != V2_VGG_BN_PER_STEP or views
            != {(cs, "relu") for cs in V2_VGG_BN_SHAPES.values()}):
        raise AssertionError(f"small_vgg's BatchNorms {bn} are not "
                             "V2_VGG_BN_SHAPES with relu")
    reader = paddle.batch(_v2_vgg_samples(V2_VGG_BATCH * V2_VGG_STEPS, 39),
                          V2_VGG_BATCH)
    K.reset_launches()
    costs, ms, first = _v2_train_timed(paddle, trainer, reader)
    launches = {k.name: k.launches for k in K.KERNELS}
    _v2_launch_check("(b)", launches, {
        "batch_norm_bwd": V2_VGG_BN_PER_STEP * V2_VGG_STEPS})
    if len(costs) != V2_VGG_STEPS or not np.all(np.isfinite(costs)):
        raise AssertionError(f"phase 36 (b): costs {costs}")
    e2e = _v2_step_numbers(ms, V2_VGG_BATCH, first)
    device_ms, counts, step = _v2_profile(trainer, next(reader()))
    _v2_launch_check("(b) the profiled step", step,
                     {"batch_norm_bwd": V2_VGG_BN_PER_STEP})
    # each BatchNorm backward launches one bn_reduce_kernel
    bn_profiled = sum(n for k, n in counts.items()
                      if "bn_reduce_kernel" in k)
    e2e.update(cost_first=costs[0], cost_last=costs[-1],
               batch_norm_bwd_per_step=launches["batch_norm_bwd"]
               / V2_VGG_STEPS, batch_norm_bwd_profiled=bn_profiled,
               **_v2_profiled_numbers(
                   "(b)", device_ms, e2e["step_ms_p50"],
                   {"batch_norm_bwd": bn_profiled}, step))
    print(f"  (b) step p50 {e2e['step_ms_p50']:.3f} ms, p99 "
          f"{e2e['step_ms_p99']:.3f}, {e2e['examples_per_s']:.1f} "
          f"examples/s, busy share {e2e['device_busy_share']}; "
          f"batch_norm_bwd a step: "
          f"{launches['batch_norm_bwd'] / V2_VGG_STEPS:g} by the wrappers' "
          f"counts (the check), {bn_profiled} in the profiled step ({smi})",
          flush=True)

    # SGD.test (the test clone: dropout off, BatchNorm on its running
    # statistics) on the card against the CPU's, from the same Parameters
    fresh = _v2_params_copy(paddle, params, names)
    test_reader = paddle.batch(_v2_vgg_samples(V2_VGG_TEST_BATCH, 40),
                               V2_VGG_TEST_BATCH)
    card = trainer.test(test_reader).cost
    cpu = paddle.trainer.SGD(cost=cost, parameters=fresh(),
                             update_equation=momentum(),
                             place=fluid.CPUPlace()).test(test_reader).cost
    test_err = abs(card - cpu) / abs(cpu)
    print(f"  (b) SGD.test at batch {V2_VGG_TEST_BATCH}: card {card:.7f}, "
          f"CPU {cpu:.7f}, {test_err:.3e} (limit {V2_TOL})", flush=True)
    if not test_err <= V2_TOL:
        raise AssertionError("phase 36 (b): the card's SGD.test disagrees "
                             "with the CPU's")
    e2e.update(test_cost_card=card, test_cost_cpu=cpu,
               test_rel_err=test_err)
    del trainer
    torch.cuda.empty_cache()
    return {k: launches[k] for k in V2_KERNELS}, e2e


def check_v2_batch_norm(rec):
    """The BatchNorm backward against its plain version at every
    V2_VGG_BN_SHAPES launch of small_vgg: [V2_VGG_BATCH, C, S] f32 with
    relu."""
    import torch
    from paddle_tpu_torch.ops import kernels as K
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(36)
    n = V2_VGG_BATCH
    for label, (c, s) in V2_VGG_BN_SHAPES.items():
        x = (1.5 * torch.randn((n, c, s), generator=g, device=dev) + 0.3)
        dy = torch.randn((n, c, s), generator=g, device=dev)
        sc = 1 + 0.3 * torch.randn(c, generator=g, device=dev)
        bi = 0.5 * torch.randn(c, generator=g, device=dev)
        mean = x.mean(dim=(0, 2))
        inv = torch.rsqrt(x.var(dim=(0, 2), unbiased=False) + 1e-5)
        args = (x, dy, sc, bi, mean, inv, "relu")
        got, ref = K.batch_norm_bwd(*args), K.batch_norm_bwd_plain(*args)
        torch.cuda.synchronize()
        _check("batch_norm_bwd", list(zip(got, ref)), "float32",
               f"small_vgg {label} NCHW ({n}, {c}, {s}) act=relu", rec)


def v2_phase(smi, rec_bn):
    """Phase 36 (the module docstring's 36) -> (launches, numbers)."""
    import paddle_tpu_torch.v2 as paddle
    t0 = time.perf_counter()
    print(f"phase 36: the legacy v2 trainer: the GRU classifier (vocab "
          f"{GRU_CONFIG['vocab']}, H {GRU_CONFIG['hid']}, batch {SEQ_BATCH}, "
          f"T {SEQ_T}, f32, Adam) and small_vgg on CIFAR-10 shapes (batch "
          f"{V2_VGG_BATCH}, f32, Momentum) through paddle.trainer.SGD "
          f"({smi})", flush=True)
    check_v2_batch_norm(rec_bn)
    paddle.init(seed=36)
    gru_launches, gru = _v2_gru_leg(paddle, smi)
    vgg_launches, vgg = _v2_vgg_leg(paddle, smi)
    launches = {k: gru_launches[k] + vgg_launches[k] for k in V2_KERNELS}
    e2e = {"card": smi, "gru": gru, "small_vgg": vgg,
           "seconds": time.perf_counter() - t0}
    print(f"  end to end ({smi}): {json.dumps(e2e)}", flush=True)
    return launches, e2e


def v2_ab(smi):
    """``--v2``: phase 2 for the GRU and BatchNorm backward sources, the
    GRU's phase 3 checks and timings, then phase 36."""
    from paddle_tpu_torch.ops import _build, kernels as K
    t0 = time.perf_counter()
    _build.build_all({k.source for k in K.KERNELS if k.name in V2_KERNELS})
    print(f"phase 2: the GRU and BatchNorm kernels built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    recs = {k: {} for k in V2_KERNELS}
    print("phase 3: the GRU kernels against their plain versions",
          flush=True)
    check_recurrent("gru", recs["gru_fwd"], recs["gru_bwd"], strict=False)
    launches, e2e = v2_phase(smi, recs["batch_norm_bwd"])
    return {"v2": dict(e2e, launches=launches), "kernels": recs}


# ---------------------------------------------------------------------------
# phase 37: CSP and the native C++ runtime
# ---------------------------------------------------------------------------

#: leg (a): distinct batches of RESNET_BATCH seeded uint8 images written
#: as one recordio shard each, by CSP_WRITERS convert calls at once (the
#: C++ writer deflates uniform pixels at about 6 MB/s a thread on the
#: H100 host); CSP_STEPS steps read them in CSP_STEPS / CSP_BATCHES
#: passes
CSP_BATCHES, CSP_STEPS, CSP_WRITERS = 8, RESNET_STEPS, 8
#: the C++ loader's threads and the channel's capacity
CSP_THREADS, CSP_CAPACITY = 4, 2
#: the write is to stay under this many seconds (else fewer batches)
CSP_WRITE_LIMIT_S = 10.0
#: the pipeline-against-direct step: f32, this batch, one shard
CSP_CHECK_BATCH = 4
#: the pipeline check holds bitwise, or within this relative error where
#: a reduction's order differs
CSP_CHECK_RTOL = 1e-6
#: leg (b): each program's bound, the daisy chain's length and the
#: rendezvous count
CSP_PROGRAM_TIMEOUT, CSP_DAISY, CSP_RENDEZVOUS = 60.0, 100, 1000
#: leg (c): the batch (SEQ_T long) and the three runners' agreement
CSP_CPP_BATCH, CSP_CPP_TOL = 4, 1e-4
CSP_KERNELS = ("batch_norm_bwd", "lstm_fwd")


def _csp_images(n, seed=37):
    """n seeded uint8 HWC images at RESNET_CONFIG's shape and labels."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n,) + RESNET_CONFIG["image_shape"],
                          dtype=np.uint8)
    labels = rng.integers(0, RESNET_CONFIG["class_dim"], n)
    return images, labels


def _csp_write(root, name, images, labels, per_shard):
    """(index, image, label) samples written by dataset.common.convert
    through the C++ writer, one shard of ``per_shard`` a call, up to
    CSP_WRITERS calls at once (the writer's deflate runs without the
    GIL) -> (paths, seconds, bytes)."""
    from concurrent.futures import ThreadPoolExecutor
    from paddle_tpu_torch.dataset import common
    os.makedirs(root, exist_ok=True)

    def shard(b):
        lo, hi = b * per_shard, min((b + 1) * per_shard, len(images))

        def samples():
            for i in range(lo, hi):
                yield (i, images[i], int(labels[i]))
        if common.convert(root, samples, per_shard, f"{name}{b:03d}") != 1:
            raise AssertionError(f"phase 37: shard {b} is not one file")
        return os.path.join(root, f"{name}{b:03d}-00000")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(CSP_WRITERS) as pool:
        paths = list(pool.map(shard, range(-(-len(images) // per_shard))))
    seconds = time.perf_counter() - t0
    return paths, seconds, sum(os.path.getsize(p) for p in paths)


def _csp_produce(ch, paths, steps, batch, stats):
    """The Go producer: passes over ``paths`` through recordio_threaded,
    each ``batch`` samples unpickled, stacked, copied pinned to the card
    on a side stream and normalized there in f32, then sent with the
    copy's event and the sample indices; closes the channel after
    ``steps`` batches.  ``stats["passes"]`` gets each pass's indices."""
    import pickle
    import torch
    from paddle_tpu_torch.reader import creator
    stream = torch.cuda.Stream()
    sent = 0
    while sent < steps:
        seen = []
        stats["passes"].append(seen)
        imgs, labs = [], []
        records = creator.recordio_threaded(paths,
                                            num_threads=CSP_THREADS)()
        try:
            for rec in records:
                i, img, lab = pickle.loads(rec)
                seen.append(i)
                imgs.append(img)
                labs.append(lab)
                if len(imgs) < batch:
                    continue
                x = torch.from_numpy(np.stack(imgs)).pin_memory()
                y = torch.from_numpy(np.asarray(labs, np.int64)
                                     .reshape(-1, 1)).pin_memory()
                with torch.cuda.stream(stream):
                    xd = x.to("cuda", non_blocking=True).float().mul_(
                        1.0 / 255.0)
                    yd = y.to("cuda", non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(stream)
                t = time.perf_counter()
                ch.send((xd, yd, ready, seen[-batch:]))
                stats["send_s"] += time.perf_counter() - t
                sent += 1
                imgs, labs = [], []
                if sent == steps:
                    break
        finally:
            records.close()
        if len(seen) < batch:
            raise AssertionError(f"phase 37: a pass over {paths} read "
                                 f"{len(seen)} samples, under one batch")
    ch.close()


def _csp_go_producer(ch, paths, steps, batch, stats):
    """`_csp_produce` on a Go thread; a failure lands in
    ``stats["error"]`` and closes the channel, so the consumer ends."""
    from paddle_tpu_torch import concurrency

    def produce():
        try:
            _csp_produce(ch, paths, steps, batch, stats)
        except BaseException as e:  # noqa: BLE001  (raised by the caller)
            stats["error"] = e
            ch.close()
    return concurrency.Go(produce)


def _csp_train(exe, main, avg_cost, paths, steps, batch=None,
               scope=None, hook=None):
    """``steps`` steps of ``main`` fed through the CSP pipeline: a Go
    producer (`_csp_produce`) and this thread receiving until the channel
    is closed, one Executor.run a batch (``hook("before"/"after")``
    around each) -> (ms a step, from the recv to the step's end; losses;
    each batch's indices; stats: recv_s, send_s, passes)."""
    import torch
    from paddle_tpu_torch import concurrency
    batch = batch or RESNET_BATCH
    ch = concurrency.make_channel(capacity=CSP_CAPACITY)
    stats = {"recv_s": 0.0, "send_s": 0.0, "passes": [], "error": None}
    producer = _csp_go_producer(ch, paths, steps, batch, stats)
    ms, losses, batches = [], [], []
    while True:
        t = time.perf_counter()
        item, ok = ch.recv()
        if not ok:
            break
        stats["recv_s"] += time.perf_counter() - t
        x, y, ready, idx = item
        cur = torch.cuda.current_stream()
        cur.wait_event(ready)
        x.record_stream(cur)
        y.record_stream(cur)
        if hook is not None:
            hook("before")
        (loss,) = exe.run(main, feed={"data": x, "label": y},
                          fetch_list=[avg_cost], scope=scope)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        if hook is not None:
            hook("after")
        losses.append(float(loss))
        batches.append(list(idx))
    producer.join(CSP_PROGRAM_TIMEOUT)
    if stats["error"] is not None:
        raise stats["error"]
    if len(ms) != steps:
        raise AssertionError(f"phase 37: {len(ms)} batches arrived, want "
                             f"{steps}")
    return ms, losses, batches, stats


def _csp_producer_alone(paths, steps):
    """The producer with a consumer that only receives: ms a batch after
    the first (what the pipeline can feed with no training beside it)."""
    import torch
    from paddle_tpu_torch import concurrency
    ch = concurrency.make_channel(capacity=CSP_CAPACITY)
    stats = {"send_s": 0.0, "passes": [], "error": None}
    producer = _csp_go_producer(ch, paths, steps, RESNET_BATCH, stats)
    stamps = []
    for _ in ch:
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    producer.join(CSP_PROGRAM_TIMEOUT)
    if stats["error"] is not None:
        raise stats["error"]
    if len(stamps) != steps:
        raise AssertionError(f"phase 37: the producer alone sent "
                             f"{len(stamps)} of {steps} batches")
    return (stamps[-1] - stamps[0]) * 1e3 / (steps - 1)


def _csp_loader_rates(paths):
    """The loader alone over ``paths``: the C++ FileLoader with 1 and 4
    threads and the Python Scanner -> {label: records/s, MB/s, s}."""
    from paddle_tpu_torch import native, recordio
    out = {}
    for label, make in (
            ("cpp_1_thread", lambda: native.FileLoader(paths, 1)),
            ("cpp_4_threads", lambda: native.FileLoader(paths, 4)),
            ("python_scanner", lambda: (r for p in paths
                                        for r in recordio.Scanner(p)))):
        t0 = time.perf_counter()
        it = make()
        n = nbytes = 0
        for rec in it:
            n += 1
            nbytes += len(rec)
        dt = time.perf_counter() - t0
        if hasattr(it, "close"):
            it.close()
        out[label] = {"records": n, "seconds": dt, "records_per_s": n / dt,
                      "mb_per_s": nbytes / dt / 1e6}
    if len({r["records"] for r in out.values()}) != 1:
        raise AssertionError(f"phase 37: the readers disagree: {out}")
    return out


def _csp_profile(exe, main, avg_cost, paths, scope):
    """Two more fed steps under torch.profiler, the first its warm-up ->
    (device ms of the second, its BatchNorm backward launches by the
    wrapper's count, the profile's bn kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from paddle_tpu_torch.ops import kernels as K
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        def hook(when):
            if when == "before":
                K.reset_launches()
            else:
                prof.step()
        _csp_train(exe, main, avg_cost, paths, 2, scope=scope, hook=hook)
    wrapper = {k.name: k.launches for k in K.KERNELS}["batch_norm_bwd"]
    annotations = {e.name for e in prof.events()
                   if getattr(e, "is_user_annotation", False)}
    rows = [r for r in prof.key_averages()
            if r.device_type == torch.autograd.DeviceType.CUDA
            and not r.key.startswith("op:") and r.key not in annotations]
    total = sum(r.device_time_total for r in rows) / 1e3
    bn = {r.key[:60]: r.count for r in rows if "bn_" in r.key}
    print(f"  profiled fed step: {total:.3f} device ms in "
          f"{sum(r.count for r in rows)} kernel launches; batch_norm_bwd "
          f"wrapper launches {wrapper}; the profile's BatchNorm kernels "
          f"{bn}", flush=True)
    return total, wrapper, bn


def _csp_passes_exact(passes, n):
    """Every sample index exactly once in each pass (a last pass cut
    short holds no index twice)."""
    for p, seen in enumerate(passes):
        if len(seen) == n:
            if sorted(seen) != list(range(n)):
                raise AssertionError(f"phase 37: pass {p} is not every "
                                     "sample once")
        elif len(set(seen)) != len(seen) or len(seen) > n:
            raise AssertionError(f"phase 37: pass {p} repeats samples")


def _csp_step_check(root, images, labels, seed=37):
    """One f32 step at CSP_CHECK_BATCH through the pipeline against the
    same step fed directly on the card, from one startup: the loss and
    every persistable after it, bitwise or within CSP_CHECK_RTOL."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    (path,), _, _ = _csp_write(os.path.join(root, "check"), "check",
                               images[:CSP_CHECK_BATCH],
                               labels[:CSP_CHECK_BATCH], CSP_CHECK_BATCH)
    main, startup, avg_cost = _resnet_program(seed, amp=False)
    det = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {}
    try:
        for mode in ("pipeline", "direct"):
            scope = Scope()
            exe = fluid.Executor(fluid.CUDAPlace(0))
            with scope_guard(scope):
                exe.run(startup)
            if mode == "pipeline":
                _, losses, batches, _ = _csp_train(
                    exe, main, avg_cost, [path], 1, CSP_CHECK_BATCH, scope)
                loss, order = losses[0], batches[0]
            else:
                x = torch.from_numpy(np.stack(images[order])).to(
                    "cuda").float().mul_(1.0 / 255.0)
                y = torch.from_numpy(np.asarray(labels[order], np.int64)
                                     .reshape(-1, 1)).to("cuda")
                (loss,) = exe.run(main, feed={"data": x, "label": y},
                                  fetch_list=[avg_cost], scope=scope)
                loss = float(loss)
            out[mode] = (loss, {n: t.detach().cpu().numpy()
                                for n, t in scope._vars.items()
                                if isinstance(t, torch.Tensor)})
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = det
    (lp, sp), (ld, sd) = out["pipeline"], out["direct"]
    same = lp == ld and all(np.array_equal(sp[n], sd[n]) for n in sd)
    err = max([abs(lp - ld) / max(abs(ld), 1e-30)]
              + [float(np.abs(sp[n] - sd[n]).max(initial=0.0))
                 / max(float(np.abs(sd[n]).max(initial=0.0)), 1e-30)
                 for n in sd if sd[n].dtype.kind == "f"])
    print(f"  pipeline step against the direct step (f32, batch "
          f"{CSP_CHECK_BATCH}, {len(sd)} persistables): bitwise {same}, "
          f"max relative error {err:.3e} (limit {CSP_CHECK_RTOL})",
          flush=True)
    if not same and err > CSP_CHECK_RTOL:
        raise AssertionError("phase 37: the pipeline's step is not the "
                             "direct step's")
    return {"bitwise": same, "max_rel_err": err, "order": order}


def _csp_resnet_leg(smi, root, seed=37):
    """Phase 37 (a) -> (launches of the fed steps, numbers)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import native, recordio
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.ops import kernels as K
    n = CSP_BATCHES * RESNET_BATCH
    images, labels = _csp_images(n, seed)
    paths, write_s, nbytes = _csp_write(os.path.join(root, "shards"),
                                        "resnet", images, labels,
                                        RESNET_BATCH)
    raw_mb = images.nbytes / 1e6
    print(f"  wrote {n} images ({raw_mb:.1f} MB of pixels) into "
          f"{len(paths)} shards ({nbytes / 1e6:.1f} MB, zlib) through the "
          f"C++ writer in {write_s:.3f} s, {raw_mb / write_s:.1f} MB/s",
          flush=True)
    if write_s > CSP_WRITE_LIMIT_S:
        print(f"  the write passed {CSP_WRITE_LIMIT_S} s: CSP_BATCHES is "
              "to be cut", flush=True)
    rates = _csp_loader_rates(paths)
    print("  loader alone (warm page cache): " + "; ".join(
        f"{k} {v['records_per_s']:.1f} records/s, {v['mb_per_s']:.1f} MB/s"
        for k, v in rates.items()), flush=True)
    alone_ms = _csp_producer_alone(paths, CSP_BATCHES)
    print(f"  the producer alone (a consumer that only receives): "
          f"{alone_ms:.3f} ms a batch", flush=True)

    main, startup, avg_cost = _resnet_program(seed, amp=True)
    scope = Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with scope_guard(scope):
        exe.run(startup)
    resident = []
    for b in range(CSP_BATCHES):
        sl = slice(b * RESNET_BATCH, (b + 1) * RESNET_BATCH)
        resident.append({
            "data": torch.from_numpy(images[sl]).to("cuda").float().mul_(
                1.0 / 255.0),
            "label": torch.from_numpy(labels[sl].astype(np.int64)
                                      .reshape(-1, 1)).to("cuda")})
    mem_ms = []
    for step in range(CSP_STEPS):
        t = time.perf_counter()
        (loss,) = exe.run(main, feed=resident[step % CSP_BATCHES],
                          fetch_list=[avg_cost], scope=scope)
        torch.cuda.synchronize()
        mem_ms.append((time.perf_counter() - t) * 1e3)
    del resident

    opened = {"loader": 0, "scanner": 0}
    loader_init, scanner_init = (native.FileLoader.__init__,
                                 recordio.Scanner.__init__)

    def counted_loader(self, *a, **kw):
        opened["loader"] += 1
        loader_init(self, *a, **kw)

    def counted_scanner(self, *a, **kw):
        opened["scanner"] += 1
        scanner_init(self, *a, **kw)

    native.FileLoader.__init__ = counted_loader
    recordio.Scanner.__init__ = counted_scanner
    try:
        K.reset_launches()
        fed_ms, losses, batches, stats = _csp_train(
            exe, main, avg_cost, paths, CSP_STEPS, scope=scope)
        launches = {k.name: k.launches for k in K.KERNELS}
    finally:
        native.FileLoader.__init__ = loader_init
        recordio.Scanner.__init__ = scanner_init
    print(f"  fed steps: {', '.join(f'{m:.2f}' for m in fed_ms)} ms; "
          f"losses {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    passes = len(stats["passes"])
    if opened != {"loader": passes, "scanner": 0}:
        raise AssertionError(f"phase 37: the reader opened {opened} over "
                             f"{passes} passes; the C++ loader must serve "
                             "every pass and no Python Scanner")
    _csp_passes_exact(stats["passes"], n)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"phase 37: non-finite loss {losses}")
    want = RESNET_LAUNCHES_PER_STEP["batch_norm_bwd"] * CSP_STEPS
    if launches["batch_norm_bwd"] != want:
        raise AssertionError(f"phase 37: batch_norm_bwd launched "
                             f"{launches['batch_norm_bwd']} times in "
                             f"{CSP_STEPS} fed steps, want {want}")
    device_ms, prof_launches, prof_bn = _csp_profile(
        exe, main, avg_cost, paths, scope)
    if prof_launches != RESNET_LAUNCHES_PER_STEP["batch_norm_bwd"]:
        raise AssertionError(f"phase 37: the profiled step launched "
                             f"batch_norm_bwd {prof_launches} times")
    del exe, scope
    torch.cuda.empty_cache()
    check = _csp_step_check(root, images, labels, seed)

    def pct(ms):
        return (float(np.percentile(ms[1:], 50)),
                float(np.percentile(ms[1:], 99)))
    fed, mem = pct(fed_ms), pct(mem_ms)
    e2e = {"card": smi, "batch": RESNET_BATCH, "steps": CSP_STEPS,
           "distinct_batches": CSP_BATCHES, "passes": passes,
           "write_s": write_s, "write_mb_per_s": raw_mb / write_s,
           "shard_mb": nbytes / 1e6, "pixels_mb": raw_mb,
           "fed_step1_ms": fed_ms[0], "fed_step_ms_p50": fed[0],
           "fed_step_ms_p99": fed[1],
           "fed_images_per_s": RESNET_BATCH * 1e3 / fed[0],
           "mem_step1_ms": mem_ms[0], "mem_step_ms_p50": mem[0],
           "mem_step_ms_p99": mem[1],
           "mem_images_per_s": RESNET_BATCH * 1e3 / mem[0],
           "fed_over_mem": fed[0] / mem[0],
           "recv_wait_s": stats["recv_s"], "send_wait_s": stats["send_s"],
           "recv_wait_ms_per_step": stats["recv_s"] * 1e3 / CSP_STEPS,
           "producer_alone_ms_per_batch": alone_ms,
           "profiled_device_ms": device_ms,
           "device_busy_share": device_ms / fed[0],
           "profiled_bn_bwd_launches": prof_launches,
           "profiled_bn_kernels": prof_bn,
           "loader": rates, "loss_first": losses[0],
           "loss_last": losses[-1], "pipeline_check": check}
    print(f"  fed step p50 {fed[0]:.3f} ms p99 {fed[1]:.3f} ms "
          f"({e2e['fed_images_per_s']:.1f} images/s) against in-memory "
          f"p50 {mem[0]:.3f} ms p99 {mem[1]:.3f} ms "
          f"({e2e['mem_images_per_s']:.1f} images/s): x"
          f"{e2e['fed_over_mem']:.4f}; recv waited {stats['recv_s']:.4f} s "
          f"(starved), send {stats['send_s']:.4f} s (back-pressure); busy "
          f"share {e2e['device_busy_share']:.4f} ({smi})", flush=True)
    return {k: launches[k] for k in CSP_KERNELS}, e2e


def _csp_simple_routine(fl, L, C):
    ch = C.make_channel(capacity=0, in_program=True)
    result = fl.default_main_program().global_block().create_var(
        name="ret", shape=(1,), dtype="float32")
    with C.ProgramGo():
        val = L.fill_constant(shape=[1], dtype="float32", value=1234.0)
        C.channel_send(ch, val)
    out, _ = C.channel_recv(ch, result)
    C.channel_close(ch)
    return out


def _csp_daisy_chain(fl, L, C):
    leftmost = C.make_channel(capacity=0, in_program=True)
    left, main = leftmost, fl.default_main_program()
    for i in range(CSP_DAISY):
        right = C.make_channel(capacity=0, in_program=True)
        with C.ProgramGo():
            ret = main.current_block().create_var(
                name=f"ret_{i}", shape=(1,), dtype="float32")
            got, _ = C.channel_recv(right, ret)
            one = L.fill_constant(shape=[1], dtype="float32", value=1.0)
            C.channel_send(left, L.elementwise_add(one, got))
        left = right
    with C.ProgramGo():
        C.channel_send(right, L.fill_constant(shape=[1], dtype="float32",
                                              value=1.0))
    final = main.global_block().create_var(name="final", shape=(1,),
                                           dtype="float32")
    return C.channel_recv(leftmost, final)[0]


def _csp_fibonacci(fl, L, C):
    main = fl.default_main_program()
    ch = C.make_channel(capacity=0, in_program=True)
    quit_ch = C.make_channel(capacity=0, in_program=True)
    result = main.global_block().create_var(name="result", shape=(1,),
                                            dtype="float32")
    L.fill_constant(shape=[1], dtype="float32", value=-1.0, out=result)
    with C.ProgramGo():
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        limit = L.fill_constant(shape=[1], dtype="int64", value=10)
        cond = L.less_than(x=i, y=limit)
        w = L.While(cond=cond)
        with w.block():
            got, _ = C.channel_recv(ch, result)
            L.assign(got, output=result)
            L.increment(i, value=1, in_place=True)
            L.less_than(x=i, y=limit, cond=cond)
        C.channel_send(quit_ch, L.fill_constant(shape=[1], dtype="int64",
                                                value=1))
    fib_x = main.global_block().create_var(name="fibX", shape=(1,),
                                           dtype="float32")
    fib_y = main.global_block().create_var(name="fibY", shape=(1,),
                                           dtype="float32")
    L.fill_constant(shape=[1], dtype="float32", value=0.0, out=fib_x)
    L.fill_constant(shape=[1], dtype="float32", value=1.0, out=fib_y)
    quit_var = main.global_block().create_var(name="quitVar", shape=(1,),
                                              dtype="int64")
    zero = L.fill_constant(shape=[1], dtype="int64", value=0)
    one_i = L.fill_constant(shape=[1], dtype="int64", value=1)
    go_on = L.less_than(x=zero, y=one_i)
    w = L.While(cond=go_on)
    with w.block():
        with C.ProgramSelect() as sel:
            with sel.case(C.channel_send, ch, fib_x):
                xtemp = L.assign(fib_x)
                L.assign(fib_y, output=fib_x)
                L.assign(L.elementwise_add(xtemp, fib_y), output=fib_y)
            with sel.case(C.channel_recv, quit_ch, quit_var):
                L.less_than(x=one_i, y=zero, cond=go_on)
    return result


def _csp_programs_leg():
    """Phase 37 (b) -> numbers."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import concurrency as C, layers as L
    from paddle_tpu_torch.core.lowering import CSP_OPS
    from paddle_tpu_torch.core.scope import Scope
    out, rules = {}, set()
    for name, build, want in (("simple_routine", _csp_simple_routine,
                               1234.0),
                              ("daisy_chain", _csp_daisy_chain,
                               CSP_DAISY + 1.0),
                              ("fibonacci", _csp_fibonacci, 34.0)):
        fluid.core.program.reset_default_programs()
        fetch = build(fluid, L, C)
        rules.update(op.type for b in fluid.default_main_program().blocks
                     for op in b.ops)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        t0 = time.perf_counter()
        ran = {}
        _run_threads(lambda _: ran.update(got=exe.run(
            fluid.default_main_program(), feed={}, fetch_list=[fetch],
            scope=Scope(), return_numpy=False)), 1, CSP_PROGRAM_TIMEOUT)
        seconds = time.perf_counter() - t0
        (got,) = ran["got"]
        if not (isinstance(got, torch.Tensor) and got.is_cuda):
            raise AssertionError(f"phase 37 (b) {name}: the received "
                                 f"payload is {type(got)} on "
                                 f"{getattr(got, 'device', None)}")
        value = float(got.reshape(-1)[0])
        if value != want:
            raise AssertionError(f"phase 37 (b) {name}: {value}, want "
                                 f"{want}")
        out[name] = {"value": value, "device": str(got.device),
                     "seconds": seconds}
    if CSP_OPS - rules:
        raise AssertionError(f"phase 37 (b): the CSP rules "
                             f"{sorted(CSP_OPS - rules)} did not run")
    ch = C.Channel(capacity=0)
    payload = torch.ones(1, device="cuda")
    got = []

    def send():
        for _ in range(CSP_RENDEZVOUS):
            ch.send(payload)

    def recv():
        for _ in range(CSP_RENDEZVOUS):
            got.append(ch.recv()[1])

    t0 = time.perf_counter()
    g = C.Go()
    g(send)
    g(recv)
    g.join(CSP_PROGRAM_TIMEOUT)
    seconds = time.perf_counter() - t0
    if len(got) != CSP_RENDEZVOUS or not all(got):
        raise AssertionError(f"phase 37 (b): {len(got)} of "
                             f"{CSP_RENDEZVOUS} rendezvous completed")
    out["rendezvous_us_per_pair"] = seconds / CSP_RENDEZVOUS * 1e6
    print(f"  in-program CSP on the card: {json.dumps(out)}", flush=True)
    return out


def _csp_cpp_leg(root, seed=37):
    """Phase 37 (c) -> (launches of the card Predictor's run, numbers)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io as pio, layers, native
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    from paddle_tpu_torch.models.stacked_lstm import lstm_net
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import Predictor
    fluid.core.program.reset_default_programs()
    data = layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
    label = layers.data(name="label", shape=[1], dtype="int64")
    _, _, logit = lstm_net(data, label, **LSTM_CONFIG)
    startup = fluid.default_startup_program()
    startup.random_seed = seed
    model_dir = os.path.join(root, "lstm_model")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with scope_guard(Scope()):
        exe.run(startup)
        pio.save_inference_model(model_dir, ["words"], [logit], exe)
    rng = np.random.default_rng(seed)
    feed = {"words": rng.integers(0, LSTM_CONFIG["dict_dim"],
                                  (CSP_CPP_BATCH, SEQ_T)).astype(np.int64),
            "words@SEQ_LEN": np.full(CSP_CPP_BATCH, SEQ_T, np.int32)}

    def timed(fn, n):
        ms, out = [], None
        for _ in range(n):
            t = time.perf_counter()
            out = fn()
            ms.append((time.perf_counter() - t) * 1e3)
        return out, float(np.median(ms))

    pred = Predictor.from_model_dir(model_dir)
    pred.run(feed)
    torch.cuda.synchronize()
    K.reset_launches()
    card = pred.run(feed)
    launches = {k.name: k.launches for k in K.KERNELS}
    card, card_ms = timed(lambda: pred.run(feed), 5)
    t = time.perf_counter()
    cpu_pred = native.CpuPredictor(model_dir)
    load_ms = (time.perf_counter() - t) * 1e3
    # the two C++ runs at once (each one thread, the GIL released)
    runs = {}
    _run_threads(lambda i: runs.__setitem__(i, timed(
        (lambda: cpu_pred.run(feed)) if i == 0
        else (lambda: native.capi_run(model_dir, feed)), 1)), 2)
    (cpp, cpp_ms), (capi, capi_ms) = runs[0], runs[1]
    errs = {"card_vs_cpp": float(np.abs(card[0] - cpp[0]).max()),
            "card_vs_capi": float(np.abs(card[0] - capi[0]).max()),
            "cpp_vs_capi": float(np.abs(cpp[0] - capi[0]).max())}
    out = {"shape": list(card[0].shape), "card_ms": card_ms,
           "cpp_load_ms": load_ms, "cpp_run_ms": cpp_ms,
           "capi_load_and_run_ms": capi_ms, "cpp_runs_concurrent": True,
           "max_abs_err": errs,
           "lstm_fwd_launches": launches["lstm_fwd"]}
    print(f"  the stacked LSTM ({LSTM_CONFIG}, f32, {CSP_CPP_BATCH} x "
          f"{SEQ_T}) three ways: {json.dumps(out)}", flush=True)
    if launches["lstm_fwd"] != SEQ_LAUNCHES_PER_STEP["lstm"]["lstm_fwd"]:
        raise AssertionError(f"phase 37 (c): the card Predictor launched "
                             f"lstm_fwd {launches['lstm_fwd']} times")
    if not all(np.isfinite(o[0]).all() for o in (card, cpp, capi)) or \
            max(errs.values()) > CSP_CPP_TOL:
        raise AssertionError(f"phase 37 (c): the runners disagree: {errs} "
                             f"(limit {CSP_CPP_TOL})")
    return {k: launches[k] for k in CSP_KERNELS}, out


def start_native_build():
    """Build the native library on a thread (beside phase 2's nvcc) ->
    a join that returns the build's seconds or raises its failure."""
    import threading
    from paddle_tpu_torch import native
    out = {}

    def build():
        t = time.perf_counter()
        try:
            native.load_library()
        except BaseException as e:  # noqa: BLE001  (raised at the join)
            out["error"] = e
        out["seconds"] = time.perf_counter() - t

    thread = threading.Thread(target=build, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "error" in out:
            raise out["error"]
        return out["seconds"]
    return join


def csp_phase(smi, build_s=None):
    """Phase 37 (the module docstring's 37) -> (launches, numbers);
    ``build_s``: the seconds of the native build started beside phase 2
    (else it is built here)."""
    import shutil
    from paddle_tpu_torch import native
    t0 = time.perf_counter()
    print(f"phase 37: CSP and the native C++ runtime: ResNet-50 "
          f"{RESNET_CONFIG} at batch {RESNET_BATCH} fed from recordio by "
          f"the C++ loader through a Go producer and a channel, the "
          f"reference's CSP programs on the card, the stacked LSTM through "
          f"the C++ runner ({smi})", flush=True)
    if build_s is None:
        build_s = start_native_build()()
    print(f"  the native library {native._lib_path().name} built with g++ "
          f"in {build_s:.2f} s", flush=True)
    root = os.path.join(HERE, "build", "csp")
    shutil.rmtree(root, ignore_errors=True)
    resnet_launches, resnet = _csp_resnet_leg(smi, root)
    print("  (b) in-program CSP on Executor(CUDAPlace(0))", flush=True)
    programs = _csp_programs_leg()
    print("  (c) the C++ runner against the card", flush=True)
    cpp_launches, cpp = _csp_cpp_leg(root)
    shutil.rmtree(root, ignore_errors=True)
    launches = {k: resnet_launches[k] + cpp_launches[k] for k in CSP_KERNELS}
    e2e = {"card": smi, "native_build_s": build_s, "resnet": resnet,
           "programs": programs, "cpp_runner": cpp,
           "seconds": time.perf_counter() - t0}
    print(f"  end to end ({smi}): {json.dumps(e2e)}", flush=True)
    return launches, e2e


def csp_ab(smi):
    """``--csp``: phase 2 for the BatchNorm backward and LSTM sources,
    their phase 3 checks and timings, then phase 37."""
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    native_join = start_native_build()
    _build.build_all(("batch_norm_bwd", "lstm"))
    build_s = native_join()
    print(f"phase 2: the BatchNorm backward and LSTM kernels and the native "
          f"library built in {time.perf_counter() - t0:.1f} s", flush=True)
    recs = {k: {} for k in ("batch_norm_bwd", "lstm_fwd", "lstm_bwd")}
    print("phase 3: the BatchNorm backward and LSTM kernels against their "
          "plain versions", flush=True)
    check_batch_norm_bwd(recs["batch_norm_bwd"])
    check_recurrent("lstm", recs["lstm_fwd"], recs["lstm_bwd"], strict=False)
    launches, e2e = csp_phase(smi, build_s)
    return {"csp": dict(e2e, launches=launches), "kernels": recs}


# ---------------------------------------------------------------------------
# phase 38: head dims 8-128 and hidden widths past the co-resident grid
# ---------------------------------------------------------------------------

#: the port's TransformerLM at Pythia-1.4B's widths (Biderman et al. 2023,
#: "Pythia", Table 1: d_model 2048, 16 heads of 128, 24 layers, vocab
#: 50304 (the padded GPT-NeoX tokenizer), d_ff 4 x 2048, context 2048);
#: only the widths are taken, the architecture stays the repo's
#: (post-LN, sinusoid positions, untied head)
PYTHIA_1B4 = dict(vocab=50304, max_len=2048, n_layers=24, d_model=2048,
                  n_heads=16, d_ff=8192, eos_id=None)
#: (a) serving it in bf16: slots, requests, prompt lengths drawn in
#: [8, 1024], new tokens a request, the streams checked against the full
#: recompute
SH_SLOTS, SH_REQUESTS, SH_PROMPT_RANGE, SH_NEW = 16, 32, (8, 1024), 32
SH_CHECKED = (0, 17)
#: then an exact engine on 2 slots over max_len 512 (f32, row-stable
#: products, the f32 flash over the whole span): prompts and new tokens
SH_EXACT_MAX_LEN, SH_EXACT_PROMPTS, SH_EXACT_NEW = 512, (37, 400), 8
SH_EXACT_SLOTS = 2
#: (b) training the same widths at depth 4 (cut from 24), T 1024, batch
#: 8, through the Fluid Program and train_loop, f32 then amp
SH_TRAIN = dict(vocab=50304, max_len=1024, n_layers=4, d_model=2048,
                n_heads=16, d_ff=8192)
SH_TRAIN_BATCH, SH_TRAIN_STEPS = 8, 5
#: the kernel launches of one of its steps: an attention and two
#: LayerNorms a layer, one loss head
SH_TRAIN_PER_STEP = dict({name: 0 for name in TRAIN_LAUNCHES_PER_STEP},
                         flash_attention_fwd=4, flash_attention_bwd=4,
                         layer_norm_fwd=8, layer_norm_bwd=8,
                         softmax_xent_fwd=1, softmax_xent_bwd=1)
#: (c) the JAX package's default servable model, as
#: benchmark/fluid/serving.py:277-287 saves and drives it (vocab 128,
#: max_len 256, 2 layers, d_model 64, 4 heads of 16, d_ff 256, seed 7; 4
#: slots, prompts of 8 ids in [2, 128) from RandomState(7), 32 new
#: tokens), saved by the port and served by DecodeEngine in f32
SH_DEFAULT = dict(vocab=128, max_len=256, n_layers=2, d_model=64,
                  n_heads=4, d_ff=256)
SH_DEFAULT_SLOTS, SH_DEFAULT_PROMPT, SH_DEFAULT_NEW = 4, 8, 32
#: (d) phase 9's stacked LSTM and phase 10's GRU classifier at hidden
#: width 2048, batch 32, T 80, in f32 and under amp
SH_LSTM = dict(LSTM_CONFIG, hid_dim=2048)
SH_GRU = dict(GRU_CONFIG, hid=2048)
SH_SEQ_STEPS = 5


#: every kernel's launches by path over the whole run, checks included
#: (`_track_path_totals` adds each count before the counts are zeroed)
_PATH_TOTALS = {}


def _track_path_totals(K):
    """Make ``K.reset_launches`` add each kernel's launches by path into
    _PATH_TOTALS before it zeroes them."""
    reset = K.reset_launches

    def tracked():
        for k in K.KERNELS:
            tot = _PATH_TOTALS.setdefault(k.name, {})
            for p, n in k.path_launches.items():
                tot[p] = tot.get(p, 0) + n
        reset()
    K.reset_launches = tracked


def _path_launches():
    """Each kernel's launches by path (head-dim code, tile code or
    recurrent path) since the counts were last zeroed."""
    from paddle_tpu_torch.ops import kernels as K
    return {k.name: dict(k.path_launches) for k in K.KERNELS
            if any(k.path_launches.values())}


def _random_lm_on_card(spec, precision, seed):
    """The port's TransformerLM at ``spec`` with seeded random weights
    made on the card, none written to disk: `random_params`'
    distributions (Xavier-uniform matrices, N(0, 0.02) vectors, LayerNorm
    scales 1 + N(0, 0.1), the sinusoid table), drawn by a CUDA
    generator."""
    import torch
    from paddle_tpu_torch.models.transformer import (TransformerLM,
                                                     param_shapes,
                                                     sinusoid_table)
    model = TransformerLM(spec, precision=precision, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = param_shapes(spec)
    with torch.no_grad():
        for name, (mod, attr) in model.artifact_slots().items():
            dst, shape = getattr(mod, attr), shapes[name]
            if tuple(dst.shape) != tuple(shape):
                raise AssertionError(f"{name}: model {tuple(dst.shape)}, "
                                     f"artifact {shape}")
            if name == "pos_encoding_0.w_0":
                val = torch.from_numpy(sinusoid_table(*shape)).cuda()
            elif name.startswith("layer_norm") and name.endswith("w_0"):
                val = 1.0 + 0.1 * torch.randn(shape, generator=g,
                                              device="cuda")
            elif len(shape) == 1:
                val = 0.02 * torch.randn(shape, generator=g, device="cuda")
            else:
                lim = math.sqrt(6.0 / (shape[0] + shape[1]))
                val = (2 * torch.rand(shape, generator=g, device="cuda")
                       - 1) * lim
            dst.copy_(val.to(model.dtype))
            del val
    torch.cuda.synchronize()
    return model


def _sh_serving(seed):
    """(a): the Pythia-width LM in bf16 behind DecodeEngine: SH_REQUESTS
    streams on SH_SLOTS slots, two held to the full recompute by phase
    4's rule; then the exact engine, every token bitwise the exact full
    recompute.  Returns (launches, paths, numbers) of both runs."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving.decode_engine import (DecodeEngine,
                                                        greedy_decode_full)
    t0 = time.perf_counter()
    model = _random_lm_on_card(dict(PYTHIA_1B4), "bf16", seed)
    engine = DecodeEngine(model, slots=SH_SLOTS, block_len=16, warmup=True)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {n_params / 1e9:.3f} B parameters made on the card, engine "
          f"warm: {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(seed + 38)
    lens = rng.integers(SH_PROMPT_RANGE[0], SH_PROMPT_RANGE[1] + 1,
                        SH_REQUESTS)
    prompts = [rng.integers(0, PYTHIA_1B4["vocab"], n).tolist()
               for n in lens]
    try:
        K.reset_launches()
        t0 = time.perf_counter()
        handles = [engine.submit(p, SH_NEW, capture_logits=i in SH_CHECKED)
                   for i, p in enumerate(prompts)]
        results = [h.result(timeout=900) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in K.KERNELS}
        paths = _path_launches()
        stats = engine.stats()
    finally:
        engine.close()
    n_tok = sum(len(r["tokens"]) for r in results)
    for r in results:
        if len(r["tokens"]) != SH_NEW or r["finish_reason"] != "length" \
                or not all(0 <= t < PYTHIA_1B4["vocab"]
                           for t in r["tokens"]):
            raise AssertionError(f"D128 stream ended early or out of range: "
                                 f"{r['finish_reason']}, {len(r['tokens'])}")
    for name in SERVE_KERNELS:
        if launches[name] <= 0 or name != "layer_norm_fwd" and \
                paths[name]["d128"] != launches[name]:
            raise AssertionError(f"D128 serving: {name} launched "
                                 f"{launches[name]}, by code "
                                 f"{paths.get(name)}")
    print(f"  {SH_REQUESTS} requests, {n_tok} tokens in {wall:.3f} s: "
          f"{n_tok / wall:.1f} tokens/s; TTFT ms {stats['ttft_ms']}; step "
          f"ms {stats['step_ms']}; launches {launches}; by code {paths}",
          flush=True)
    for i in SH_CHECKED:
        _match_full_recompute(model, prompts[i], results[i],
                              f"D128 stream {i}", min(8, SH_NEW))
    serving = {"tokens_per_s": n_tok / wall, "wall_s": wall,
               "ttft_ms": stats["ttft_ms"], "step_ms": stats["step_ms"],
               "launches": launches, "path_launches": paths}
    del engine, model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    spec = dict(PYTHIA_1B4, max_len=SH_EXACT_MAX_LEN)
    model = _random_lm_on_card(spec, "f32", seed + 1)
    engine = DecodeEngine(model, slots=SH_EXACT_SLOTS, block_len=16,
                          numerics="exact", warmup=True)
    torch.cuda.synchronize()
    print(f"  exact engine (f32, max_len {SH_EXACT_MAX_LEN}) warm: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prompts = [rng.integers(0, spec["vocab"], n).tolist()
               for n in SH_EXACT_PROMPTS]
    try:
        K.reset_launches()
        t0 = time.perf_counter()
        cold = [h.result(timeout=900) for h in [
            engine.submit(p, SH_EXACT_NEW, capture_logits=True)
            for p in prompts]]
        torch.cuda.synchronize()
        exact_wall = time.perf_counter() - t0
        exact_launches = {k.name: k.launches for k in K.KERNELS}
        exact_paths = _path_launches()
        exact_stats = engine.stats()
    finally:
        engine.close()
    if exact_paths.get("flash_attention_fwd", {}).get("d128", 0) <= 0 or \
            exact_launches["row_stable_mm"] <= 0:
        raise AssertionError(f"exact D128 decode: launches "
                             f"{exact_launches}, by code {exact_paths}")
    t0 = time.perf_counter()
    full = greedy_decode_full(model, prompts, SH_EXACT_NEW,
                              capture_logits=True, numerics="exact")
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    compared = 0
    for i, r in enumerate(cold):
        if r["tokens"] != full["tokens"][i]:
            raise AssertionError(f"exact D128 stream {i}: tokens differ "
                                 "from the exact full recompute")
        for step, a in enumerate(r["logits"]):
            b = full["logits"][step][i]
            if not np.array_equal(a, b):
                raise AssertionError(
                    f"exact D128 stream {i} token {step}: logits differ "
                    f"from the exact full recompute by up to "
                    f"{float(np.abs(a - b).max()):.3e}")
            compared += 1
    print(f"  exact: {compared} tokens of {len(prompts)} streams (prompts "
          f"{list(SH_EXACT_PROMPTS)}) bitwise the exact full recompute in "
          f"{exact_wall:.3f} s (recompute {full_s:.2f} s); step ms "
          f"{exact_stats['step_ms']}; launches {exact_launches}; by code "
          f"{exact_paths}", flush=True)
    exact = {"wall_s": exact_wall, "step_ms": exact_stats["step_ms"],
             "tokens_bitwise": compared, "full_recompute_s": full_s,
             "launches": exact_launches, "path_launches": exact_paths}
    del engine, model
    torch.cuda.empty_cache()
    return serving, exact


def _sh_train(amp, seed):
    """(b): SH_TRAIN_STEPS steps of the Pythia-width LM at depth 4 through
    Executor.train_loop (a host sync a step), f32 or under
    MixedPrecision(Adam), on one fixed copy-task batch, then one profiled
    step.  The loss must be finite and fall; each kernel must launch
    SH_TRAIN_PER_STEP times a step, the flash pair at head dim 128."""
    import numpy as np
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import kernels as K
    fluid.core.program.reset_default_programs()
    _, _, avg_cost = transformer.transformer_lm_train_program(**SH_TRAIN,
                                                              amp=amp)
    main, startup = fluid.default_main_program(), \
        fluid.default_startup_program()
    startup.random_seed = seed
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, SH_TRAIN["vocab"],
                        (SH_TRAIN_BATCH, SH_TRAIN["max_len"])).astype(np.int64)
    feed = {"tokens": seqs, "labels": np.roll(seqs, -1, axis=1)}
    scope = fluid.core.scope.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(scope):
        t0 = time.perf_counter()
        exe.run(startup)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        handles = exe.train_loop(main, feed, fetch_list=[avg_cost],
                                 steps=SH_TRAIN_STEPS, fetch_every=1,
                                 steps_per_launch=1)
        losses = [float(np.asarray(h.get()[0])) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in K.KERNELS}
        paths = _path_launches()
        peak = torch.cuda.max_memory_allocated()
        step_ms = _window_step_ms(exe._flight.records(), 1)
        device = _profile_step(exe, main, feed, avg_cost)
    del exe, scope
    torch.cuda.empty_cache()
    what = "amp" if amp else "f32"
    print(f"  {what}: startup {startup_s:.1f} s; {SH_TRAIN_STEPS} steps in "
          f"{wall:.2f} s, losses {[round(x, 5) for x in losses]}; step ms "
          f"{[round(x, 2) for x in step_ms]}; launches {launches}; by "
          f"code {paths}", flush=True)
    for name, per in SH_TRAIN_PER_STEP.items():
        if launches[name] != per * SH_TRAIN_STEPS:
            raise AssertionError(f"D128 training ({what}): {name} launched "
                                 f"{launches[name]} times in "
                                 f"{SH_TRAIN_STEPS} steps, want {per} a step")
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        if paths[name]["d128"] != launches[name]:
            raise AssertionError(f"D128 training: {name} by code "
                                 f"{paths[name]}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"D128 training ({what}): losses {losses}")
    p50 = float(np.percentile(step_ms, 50)) if step_ms else None
    return launches, {"losses": losses, "step_ms": step_ms,
                      "step_ms_p50": p50, "wall_s": wall,
                      "startup_s": startup_s, "peak_mem_gib": peak / 2**30,
                      "profiled_device_ms": device,
                      "device_busy_share": (device["all"] / p50 if device
                                            and p50 else None),
                      "path_launches": paths}


def _sh_default_model(seed):
    """(c): the JAX package's default servable model (head dim 16), saved
    by the port and served by DecodeEngine in f32: every stream held to
    the full recompute by phase 4's rule."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.transformer import save_generation_model
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving.decode_engine import DecodeEngine
    model_dir = os.path.join(HERE, "build", "default_model")
    shutil.rmtree(model_dir, ignore_errors=True)
    save_generation_model(model_dir, **SH_DEFAULT, seed=7)
    engine = DecodeEngine.from_model_dir(model_dir, slots=SH_DEFAULT_SLOTS,
                                         block_len=16, warmup=True)
    rng = np.random.RandomState(7)
    prompts = [list(map(int, rng.randint(2, SH_DEFAULT["vocab"],
                                         SH_DEFAULT_PROMPT)))
               for _ in range(SH_DEFAULT_SLOTS)]
    try:
        K.reset_launches()
        t0 = time.perf_counter()
        results = [h.result(timeout=300) for h in [
            engine.submit(p, SH_DEFAULT_NEW, capture_logits=True)
            for p in prompts]]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in K.KERNELS}
        paths = _path_launches()
        stats = engine.stats()
    finally:
        engine.close()
    for name in ("paged_attention", "flash_attention_fwd"):
        if paths.get(name, {}).get("d16", 0) != launches[name] or \
                launches[name] <= 0:
            raise AssertionError(f"D16 serving: {name} launched "
                                 f"{launches[name]}, by code "
                                 f"{paths.get(name)}")
    for i, (p, r) in enumerate(zip(prompts, results)):
        if len(r["tokens"]) != SH_DEFAULT_NEW:
            raise AssertionError(f"D16 stream {i} ended early")
        _match_full_recompute(engine.model, p, r, f"D16 stream {i}",
                              min(8, SH_DEFAULT_NEW))
    n_tok = sum(len(r["tokens"]) for r in results)
    print(f"  {SH_DEFAULT_SLOTS} streams, {n_tok} tokens in {wall:.3f} s; "
          f"step ms {stats['step_ms']}; launches {launches}; by code "
          f"{paths}", flush=True)
    return launches, {"tokens_per_s": n_tok / wall, "wall_s": wall,
                      "step_ms": stats["step_ms"], "path_launches": paths}


def _sh_recurrent(model, amp, seed):
    """(d): phase 9's stacked LSTM (``model`` "lstm") or phase 10's GRU
    classifier at hidden width 2048, SH_SEQ_STEPS steps at SEQ_BATCH x
    SEQ_T, f32 or under amp: each recurrent launch must take the
    stepwise path."""
    import torch
    config = SH_LSTM if model == "lstm" else SH_GRU
    main, startup, avg_cost = _seq_program(model, seed, amp, config)
    feed = {k: torch.from_numpy(v).to("cuda")
            for k, v in _word_feed(SEQ_BATCH, seed).items()}
    launches, e2e, _ = _train_steps(
        main, startup, avg_cost, feed, SH_SEQ_STEPS,
        SEQ_LAUNCHES_PER_STEP[model],
        other="the DynamicRNN's eager per-step ops and other elementwise",
        keep_state=False)
    paths = e2e["path_launches"]
    for name in (f"{model}_fwd", f"{model}_bwd"):
        if paths[name]["stepwise"] != launches[name] or not launches[name]:
            raise AssertionError(f"H2048 {model}: {name} by path "
                                 f"{paths[name]}")
    print(f"  H2048 {model} {'amp' if amp else 'f32'}: step p50 "
          f"{e2e['step_ms_p50']:.3f} ms, device busy share "
          f"{e2e['device_busy_share']}; by path {paths}", flush=True)
    torch.cuda.empty_cache()
    return launches, e2e


def shapes_phase(smi, seed=0):
    """Phase 38: the slice's path at full width: (a) the Pythia-width LM
    (16 heads of 128) served in bf16 and, exactly, in f32; (b) trained at
    depth 4 in f32 and under amp; (c) the JAX package's default servable
    model (heads of 16); (d) the stacked LSTM and the GRU classifier at H
    2048 in f32 and under amp.  Returns (launches summed over the legs,
    numbers by leg)."""
    print(f"phase 38: head dims 128 and 16, hidden width 2048 ({smi})",
          flush=True)
    t_phase = time.perf_counter()
    total, out = {}, {}

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    print(f"  (a) {PYTHIA_1B4} in bf16 on {SH_SLOTS} slots", flush=True)
    out["serving"], out["exact"] = _sh_serving(seed)
    add(out["serving"]["launches"])
    add(out["exact"]["launches"])
    for amp in (False, True):
        key = "train_amp" if amp else "train_f32"
        print(f"  (b) {SH_TRAIN} at batch {SH_TRAIN_BATCH}, "
              f"{'MixedPrecision(Adam)' if amp else 'f32 Adam'}", flush=True)
        launches, out[key] = _sh_train(amp, seed)
        add(launches)
    print(f"  (c) the default servable model {SH_DEFAULT}", flush=True)
    launches, out["default_model"] = _sh_default_model(seed)
    add(launches)
    for model in ("lstm", "gru"):
        for amp in (False, True):
            key = f"{model}_h2048_{'amp' if amp else 'f32'}"
            print(f"  (d) {SH_LSTM if model == 'lstm' else SH_GRU}, "
                  f"{'amp' if amp else 'f32'}", flush=True)
            launches, out[key] = _sh_recurrent(model, amp, seed)
            add(launches)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 38: {out['phase_s']:.1f} s; launches {total}",
          flush=True)
    return total, out


def shapes_ab(smi):
    """``--shapes``: phase 2 for the attention and recurrent sources, the
    phase 3 checks of the head dims 8-128 and the recurrent widths (flash and
    paged at NEW_HEAD_DIMS, the D 128 timings, the recurrent limits and
    stepwise timings), then phase 38."""
    from paddle_tpu_torch.ops import _build, kernels as K
    t0 = time.perf_counter()
    _build.build_all(k.source for k in K.KERNELS)
    print(f"phase 2: kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    _print_ptxas(("flash_attention", "flash_attention_bwd", "lstm", "gru"))
    recs = {k.name: {} for k in K.KERNELS}
    print("phase 3: the new shapes against their plain versions",
          flush=True)
    check_paged_attention(recs["paged_attention"], dims=NEW_HEAD_DIMS)
    check_flash_attention(recs["flash_attention_fwd"], dims=NEW_HEAD_DIMS)
    check_flash_attention_bwd(recs["flash_attention_bwd"],
                              dims=NEW_HEAD_DIMS)
    time_flash_d128(recs["flash_attention_fwd"], recs["flash_attention_bwd"])
    g = __import__("torch").Generator(device="cpu").manual_seed(38)
    for kind in ("lstm", "gru"):
        check_recurrent_limits(kind, g, recs[f"{kind}_fwd"],
                               recs[f"{kind}_bwd"])
    launches, e2e = shapes_phase(smi)
    return {"shapes": dict(e2e, launches=launches),
            "kernels": {k: r for k, r in recs.items() if r}}


AB_MODES = {"--serving": serving_ab, "--resnet": resnet_ab,
            "--lstm": lstm_ab, "--ln": ln_ab, "--frontdoor": frontdoor_ab,
            "--decode-modes": decode_modes_ab, "--vgg": vgg_ab,
            "--vgg-f32": vgg_f32_anatomy, "--amp-train": amp_train_ab,
            "--seq2seq": seq2seq_ab, "--xent": xent_ab,
            "--genprog": genprog_ab, "--ssd": ssd_ab, "--sparse": sparse_ab,
            "--remat": remat_ab, "--observe": observe_ab,
            "--fleet": fleet_ab, "--mesh": mesh_ab,
            "--sharded-embedding": sharded_embedding_ab,
            "--sequence-parallel": sequence_parallel_ab,
            "--pserver": pserver_ab, "--v2": v2_ab, "--csp": csp_ab,
            "--shapes": shapes_ab}


def main(argv=()):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from paddle_tpu_torch.ops import _build, kernels as K
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv and argv[0] == "--mesh-rank":
        # one of phase 32's ranks (started by mesh_phase)
        _mesh_rank(int(argv[1]), argv[2], argv[3], argv[4])
        return 0
    if argv and argv[0] == "--sharded-rank":
        # one of phase 33's ranks (started by sharded_embedding_phase)
        _se_rank(int(argv[1]), argv[2], argv[3], argv[4], argv[5])
        return 0
    if argv and argv[0] == "--sp-rank":
        # one of phase 34's ranks (started by sequence_parallel_phase)
        _sp_rank(int(argv[1]), argv[2], argv[3])
        return 0
    if argv and argv[0] == "--master-worker":
        # one of phase 35 (a)'s workers (started by _master_leg)
        _ms_worker(int(argv[1]), argv[2], argv[3], argv[4], argv[5] == "1")
        return 0
    if argv and argv[0] == "--ps-server":
        # phase 35 (b)'s pserver (started by _pserver_leg)
        _ps_server(argv[1], argv[2], argv[3])
        return 0
    if argv and argv[0] == "--ps-trainer":
        # one of phase 35 (b)'s trainers (started by _pserver_leg)
        _ps_trainer(int(argv[1]), argv[2], argv[3], argv[4])
        return 0

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"phase 1: card: {smi}", flush=True)
    if argv:
        if len(argv) != 1 or argv[0] not in AB_MODES:
            print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
            return 2
        print(json.dumps(dict(AB_MODES[argv[0]](smi), card=smi)))
        return 0

    _track_path_totals(K)
    t0 = time.perf_counter()
    native_join = start_native_build()
    paths = _build.build_all(k.source for k in K.KERNELS)
    native_build_s = native_join()
    print(f"phase 2: kernels and the native library built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    _print_ptxas()

    print("phase 3: kernels against their plain versions", flush=True)
    hmma = check_tensor_cores(paths)
    recs = {k.name: {} for k in K.KERNELS}
    check_paged_attention(recs["paged_attention"])
    check_flash_attention(recs["flash_attention_fwd"])
    check_layer_norm(recs["layer_norm_fwd"])
    check_flash_attention_bwd(recs["flash_attention_bwd"])
    time_flash_d128(recs["flash_attention_fwd"], recs["flash_attention_bwd"])
    check_layer_norm_bwd(recs["layer_norm_bwd"])
    check_softmax_xent(recs["softmax_xent_fwd"], recs["softmax_xent_bwd"])
    check_batch_norm_bwd(recs["batch_norm_bwd"])
    for kind in ("lstm", "gru"):
        check_recurrent(kind, recs[f"{kind}_fwd"], recs[f"{kind}_bwd"])
    check_row_stable_mm(recs["row_stable_mm"])
    check_seq2seq_kernels(recs)

    print(f"phase 4: DecodeEngine, {FULL_WIDTH['n_layers']}-layer d768 LM, "
          "bf16", flush=True)
    serve_launches, e2e = serve()
    print(f"  end to end: {json.dumps(e2e)}", flush=True)

    print(f"phase 5: training {TRAIN_CONFIG} at batch {TRAIN_BATCH}, f32 "
          "(TF32 off), Adam, through transformer_lm_train_program + "
          "Executor.run", flush=True)
    train_launches, train_e2e, state = train()
    print(f"  end to end: {json.dumps(train_e2e)}", flush=True)

    print("phase 6: one full-width step at batch 1, card against CPU",
          flush=True)
    cpu_check = card_vs_cpu(state)
    print(f"  {json.dumps(cpu_check)}", flush=True)
    del state

    print(f"phase 7: ResNet-50 {RESNET_CONFIG} at batch {RESNET_BATCH}, "
          "program.amp, Momentum, through resnet_train_program + "
          "Executor.run", flush=True)
    resnet_launches, resnet_e2e, state = train_resnet()
    print(f"  end to end: {json.dumps(resnet_e2e)}", flush=True)

    print(f"phase 8: ResNet-50 in f32 at batch {RESNET_CPU_BATCH}, card "
          "against CPU", flush=True)
    resnet_cpu_check = resnet_card_vs_cpu(state)
    print(f"  {json.dumps(resnet_cpu_check)}", flush=True)
    del state

    seq = {}
    for phase, model, what in ((9, "lstm", f"stacked dynamic LSTM "
                                f"{LSTM_CONFIG} (bench.py bench_lstm)"),
                               (10, "gru", f"GRU classifier {GRU_CONFIG} "
                                "(tools/gru_bench.py)")):
        print(f"phase {phase}: {what} at batch {SEQ_BATCH}, T {SEQ_T}, "
              "program.amp, Adam, through Executor.run", flush=True)
        seq[model] = train_sequence(model)
        print(f"  end to end: {json.dumps(seq[model][1])}", flush=True)
    print(f"phase 11: one f32 step of each at batch {SEQ_CPU_BATCH}, ragged "
          "lengths, card against CPU", flush=True)
    for model in ("lstm", "gru"):
        check = seq_card_vs_cpu(model, seq[model][2])
        print(f"  {model}: {json.dumps(check)}", flush=True)

    print("phase 12: the serving front door: the full-width LM (generate) "
          "and ResNet-50 (infer), bf16, one InferenceServer over one "
          "ModelRegistry, over TCP", flush=True)
    fd_launches, fd_e2e = frontdoor()
    print(f"  end to end ({smi}): {json.dumps(fd_e2e)}", flush=True)

    print("phase 13: exact and int8 decode of the full-width LM, the "
          "recommender behind the hot-row cache with a live delta",
          flush=True)
    dm_launches, dm_e2e = decode_modes(bf16=e2e)
    print(f"  end to end ({smi}): {json.dumps(dm_e2e)}", flush=True)

    vgg_launches, lenet_launches = image_phases(smi)

    print(f"phase 17: training {TRAIN_CONFIG} at batch {TRAIN_BATCH} under "
          "MixedPrecision(Adam) through Executor.train_loop "
          f"(steps_per_launch {AMP_K}, a checkpoint every {AMP_CKPT_EVERY} "
          "steps, a resume, a skipped overflow)", flush=True)
    check_amp_training_shapes(recs)
    amp_launches, amp_e2e = amp_train(smi)
    print(f"  end to end ({smi}): {json.dumps(amp_e2e)}", flush=True)

    print("phase 18: every optimizer rule, clip, weight decay and LR "
          "schedule on the card against the CPU", flush=True)
    print(f"  {json.dumps(optimizer_rules_card_vs_cpu())}", flush=True)

    s2s_launches, s2s_gen_launches, _ = seq2seq_phases(smi, recs)

    print("phase 21: every sequence, beam, LoD, array, control-flow and "
          "CRF rule on the card against the CPU", flush=True)
    print(f"  {json.dumps(new_rules_card_vs_cpu())}", flush=True)

    gp_launches = genprog_phase(smi)[0]

    print("phase 23: the misc rules on the card against the CPU",
          flush=True)
    print(f"  {json.dumps(misc_rules_card_vs_cpu())}", flush=True)

    ssd_launches, _ = ssd_phase(smi)

    print("phase 25: the detection rules on the card against the CPU",
          flush=True)
    print(f"  {json.dumps(detection_rules_card_vs_cpu())}", flush=True)

    sparse_launches, _ = sparse_phase(smi)
    remat_launches, _ = remat_phase(smi)
    obs_train_launches, _ = observe_train(smi, amp_e2e=amp_e2e)
    obs_serve_launches, _ = observe_serving(smi)
    fleet_launches, _ = fleet_phases(smi)
    mesh_launches, _ = mesh_phase(smi)
    sharded_embedding_phase(smi)
    sp_launches, pp_launches, _ = sequence_parallel_phase(smi)
    ps_launches, _ = pserver_phase(smi)
    v2_launches, _ = v2_phase(smi, recs["batch_norm_bwd"])
    csp_launches, _ = csp_phase(smi, native_build_s)
    shapes_launches, shapes_e2e = shapes_phase(smi)
    path_legs = {leg: shapes_e2e[leg]["path_launches"] for leg in (
        "serving", "exact", "train_f32", "train_amp", "default_model",
        "lstm_h2048_f32", "lstm_h2048_amp", "gru_h2048_f32",
        "gru_h2048_amp")}

    K.reset_launches()  # the last counts into _PATH_TOTALS
    kernels = []
    for k in K.KERNELS:
        r = recs[k.name]
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"paddle_tpu_torch/ops/csrc/{k.source}.cu",
            "replaces": k.replaces,
            "launches": (serve_launches[k.name] + train_launches[k.name]
                         + resnet_launches[k.name]
                         + seq["lstm"][0][k.name] + seq["gru"][0][k.name]
                         + fd_launches[k.name] + dm_launches[k.name]
                         + vgg_launches[k.name] + lenet_launches[k.name]
                         + amp_launches[k.name] + s2s_launches[k.name]
                         + s2s_gen_launches[k.name] + gp_launches[k.name]
                         + ssd_launches[k.name] + sparse_launches[k.name]
                         + remat_launches["plain"][k.name]
                         + remat_launches["remat"][k.name]
                         + obs_train_launches[k.name]
                         + obs_serve_launches[k.name]
                         + fleet_launches[k.name]
                         + mesh_launches.get(k.name, 0)
                         + sp_launches.get(k.name, 0)
                         + pp_launches.get(k.name, 0)
                         + ps_launches.get(k.name, 0)
                         + v2_launches.get(k.name, 0)
                         + csp_launches.get(k.name, 0)
                         + shapes_launches.get(k.name, 0)),
            "launches_serving": serve_launches[k.name],
            "launches_genprog": gp_launches[k.name],
            "launches_frontdoor": fd_launches[k.name],
            "launches_decode_modes": dm_launches[k.name],
            "launches_training": (train_launches[k.name]
                                  + resnet_launches[k.name]
                                  + seq["lstm"][0][k.name]
                                  + seq["gru"][0][k.name]
                                  + vgg_launches[k.name]
                                  + lenet_launches[k.name]
                                  + amp_launches[k.name]
                                  + s2s_launches[k.name]
                                  + ssd_launches[k.name]
                                  + sparse_launches[k.name]
                                  + remat_launches["plain"][k.name]
                                  + remat_launches["remat"][k.name]
                                  + obs_train_launches[k.name]),
            "launches_resnet_training": resnet_launches[k.name],
            "launches_lstm_training": seq["lstm"][0][k.name],
            "launches_gru_training": seq["gru"][0][k.name],
            "launches_vgg_training": vgg_launches[k.name],
            "launches_lenet_training": lenet_launches[k.name],
            "launches_amp_training": amp_launches[k.name],
            "launches_seq2seq_training": s2s_launches[k.name],
            "launches_seq2seq_generation": s2s_gen_launches[k.name],
            "launches_ssd_training": ssd_launches[k.name],
            "launches_sparse_training": sparse_launches[k.name],
            "launches_remat_training": remat_launches["remat"][k.name],
            "launches_remat_plain_training": remat_launches["plain"][k.name],
            "launches_observe_training": obs_train_launches[k.name],
            "launches_observe_serving": obs_serve_launches[k.name],
            "launches_fleet": fleet_launches[k.name],
            "launches_mesh": mesh_launches.get(k.name, 0),
            "launches_sequence_parallel": sp_launches.get(k.name, 0),
            "launches_pipeline": pp_launches.get(k.name, 0),
            "launches_pserver": ps_launches.get(k.name, 0),
            "launches_v2": v2_launches.get(k.name, 0),
            "launches_csp": csp_launches.get(k.name, 0),
            "launches_shapes": shapes_launches.get(k.name, 0),
            "launches_by_path": {
                "phase38": {leg: p[k.name] for leg, p in path_legs.items()
                            if k.name in p},
                "whole_run": _PATH_TOTALS.get(k.name, {})},
            "max_abs_err": r["max_abs_err"],
            "limit_share": r["limit_share"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r.get("device_ms"),
            "library_device_ms": r.get("library_device_ms"),
            "shape": r["shape"],
            **({"bound_cuda_core_ms": r["bound_cuda_core_ms"]}
               if "bound_cuda_core_ms" in r else {}),
            **({"hmma": hmma[k.source]} if k.source in hmma else {}),
            **({"hmma_own": hmma[k.name + "_kernel"]}
               if k.name + "_kernel" in hmma else {}),
            **({"bitwise_repeat": r["bitwise_repeat"]}
               if "bitwise_repeat" in r else {}),
            **({"addmm_row_same_bits": r["addmm_row_same_bits"]}
               if "addmm_row_same_bits" in r else {}),
            **({"training_shape": r["training"]} if "training" in r
               else {}),
            **({"vgg_shape": r["vgg"]} if "vgg" in r else {}),
            **({"amp_training_shape": r["amp_training"]}
               if "amp_training" in r else {}),
            **{key: r[key] for key in ("f32_w", "bf16_w", "bf16",
                                       "chunked_rows", "decode", "shapes",
                                       "tile_code_sweep", "small_m", "d128",
                                       "d128_serving", "stepwise_h2048",
                                       "paths_bitwise", "checked_h")
               if key in r},
            **{key: v for key, v in r.items()
               if key.startswith("seq2seq_") and not key.startswith(
                   "seq2seq_launches")}})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
