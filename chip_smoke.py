#!/usr/bin/env python3
"""Drives the torch port (paddle_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, none of which catches its own failure:
  1. prints the card (nvidia-smi name and power limit), builds every
     CUDA kernel from csrc/, one nvcc per source, all started together
     (flash_decode's, the longest, goes on beside phases 2-10 and is
     waited for before phase 11), and just before phase 11 runs the card
     tests (tests/test_torch_cuda.py) in a process of their own;
  2. holds the flash-attention forward kernel against its plain PyTorch
     version on the card over a set of cases (the main paths' full-width
     shapes among them, BERT-base's [8, 12, 512, 64] too, and the bench's
     two 32768-token long-context
     shapes, held on their last 1024 query rows, also at a tolerance
     that a planted fault, one zeroed V tile, must break), and times the
     kernel (by CUDA-graph replay and by events; the f32 step's shape at
     d 64 and 128 among the cases), the plain version and one PyTorch
     library call (SDPA); no case may copy its inputs (rows not 16-byte
     aligned, or a head dim padded to a multiple of 16); head dims 160 and
     256 run the wide tile, 320 and 512 the wide tile in 256-column
     slices; then holds the f32 forward against an f64 reference at
     [8,8,512,64], [1,8,8192,64] and [1,4,512,320], each output's mean
     signed error and max error beside the plain f32 version's;
  3. serves the Transformer-base LM (vocab 32000, d_model 512, 8 heads,
     d_inner 2048, 6 layers, seq 512, random weights from --seed) through
     save_inference_model -> create_predictor(Config(dir)): the requests
     interpreted (Executor.run of the Predictor's program on its scope),
     counting their kernel launches, then through Predictor.run (the
     compiled path, below); compares one request's logits with the same
     model on the CPU (Config.disable_gpu()), and prints the request's
     wall and device-to-host copy ms on both paths;
  3b. serves that LM through the serving tier: InferenceServer(factory,
     ServingConfig(max_batch=8, n_replicas=2, prewarm=True)), two
     Predictor replicas on the card, buckets 1, 2, 4 and 8.  Four
     client threads send 32 requests of 1-3 rows: each answer bitwise
     equal to the same rows through a lone Predictor at the bucket it
     rode, and within 2e-3 of the CPU's logits; flash_attention_fwd
     replayed 6 times a batch (counted from the captures).  A seeded
     fault plan kills replica 0 mid-batch (replica 1 quiesced until
     then): every request answered exactly once and bitwise, replica 0
     relaunched.  The closed loop (8 clients) at 2 replicas and at 1:
     requests/s, rows/s, p50/p99, the batcher's occupancy, a profiled
     window's device idle share; then an open loop at twice the 2-replica
     rows/s for 5 s: typed OverloadedError at submit, every admitted
     request answered, their p99 under the 1 s deadline, the peak RSS.
     swap_predictor(0, <the LM saved again with weights from --seed + 1>)
     under traffic and
     back: replica 0 serves the second model's bits in between, then the
     first fingerprint and bits with no new capture.  Two cold replicas
     without prewarm capture buckets under traffic, one while the other
     replays: no batch fails or requeues.  stop() with 16 requests in
     flight leaves none; a drain of 5 ms answers the stragglers with
     ShutdownError;
  3c. the fleet: that LM (v1) and two programs made from it (v2: weights
     redrawn from --seed + 2 and a scale(1.0) on the logits; v3: another
     scale and one parameter left out of its archive) registered in a
     ModelRegistry under ir_verify "on" (each saved program verified, each
     prewarm's post-load program too); two Predictors of v1 report one
     fingerprint, v1.prewarm() over buckets 1, 2, 4, 8 records it.  A
     2-replica server on v1 (restart_dead, prewarm) under four clients of
     1-3 rows: RolloutController.rollout("lm", 2) converges although a
     seeded fault plan kills a replica after the first swap; every
     replica then reports v2's serving fingerprint, every answer (of both
     versions) is bitwise equal to its version's lone Predictor at its
     bucket, flash_attention_fwd replayed 6 times a batch, nothing
     captured on the serving path.  A rollout of v1 with a monitor
     firing after one swap rolls back (swapped == rolled_back == 1):
     every fingerprint as before, a probe through the restored replica
     bitwise as before, no compile after the rollout.  A rollout of v3
     raises PrewarmFailedError with no replica touched while traffic is
     answered.  SLOAutoscaler over a 1-replica server on v2, on an
     SLOMonitor of fleet_availability (2 s window): twice phase 3b's
     1-replica rows/s for 3 s scales up (the new replica from
     v2.prewarm, bitwise equal to v2's lone Predictor), no down while
     the overload holds, the admitted p99 under the 1 s deadline; a
     quiet trickle then scales down through the drain with every
     request answered.  The rollout's wall, each swap's seconds,
     p50/p99 and the largest request before and during the rollout, the
     replays that ended while each prewarm captured (at least one in the
     rollout's), the seconds from overload to up, the phase's seconds
     and peak memory are logged beside the card's line;
  3d. (run once every kernel is built, after phase 10, in a process of
     its own: torch.profiler drops graph-replay records in this long
     one) the serving tier's observability on that LM, saved again from
     --seed: InferenceServer over two replicas with metrics_port=0 and
     tracing at sample 1.0 answers 32 requests of 1-3 rows while
     /metrics is scraped (each scrape parsed and timed): the admission
     counters and the request histogram's count equal stats(), the p99
     bucket's exemplar is a trace that /tracez holds, /healthz is ok,
     /sloz parses, /fleetz is {"enabled": false}, and the exporter is
     gone after stop(); a DecodeServer at the llm_decode widths with
     metrics_port=0 serves 8 requests, its decode counters and paged-KV
     page gauges equal to stats() and each cache; a DeviceTraceSession
     around one interpreted request joins its 6 flash launches (made
     through ctypes) by their correlation ids, and one around 16 lone
     Predictor requests (replays) joins exactly 6 flash slices to each
     request's trace id, as many as the captures count, their mean within
     25 % of an event-timed launch, with a step breakdown that sums
     exactly and holds the logits' Memcpy DtoH; the same requests with
     tracing off are bitwise equal and annotate nothing;
     profiler.profiler(tracer_option="Default") around one request writes
     a merged trace whose device lanes hold its 6 flash slices under its
     trace id; then the request's p50/p99 over 200 requests of 8 rows
     with tracing off, at sample 0 and at sample 1.0;
  3e. (after 3d, in a process of its own, --ps) parameter-server
     training: phase 5's LM, f32 Adam(1e-4), batch 8 on phase 5's batch,
     transpiled by DistributeTranspiler for 1 trainer and 2 pservers in
     sync mode, the pservers in processes of their own on the card
     (--ps-node), the trainer here: a warm-up and 5 counted steps whose
     losses and final parameters are torch.equal to a local
     Executor.run of the untranspiled program from the same pushed
     start (else within twice two local runs' spread, logged), 12/6/6
     flash launches a step; the step's ms beside the local step's, the
     bytes sent and received, the trainer's RPC ms (send, the barriers,
     recv) and the pservers' optimize ms a step.  The same cluster over
     PADDLE_TPU_RPC_TRANSPORT=http gives the same bits, under a
     CollectorServer (http_port=0) in this process: the trainer pushes
     at step boundaries (PADDLE_TPU_COLLECTOR), the pservers push their
     spans and are polled over varz, a seeded plan drops or closes 6 of
     the first 24 pushes, start/stop_remote_profiler over steps 1-2 make
     each pserver write a chrome trace holding its optimize kernels; an
     InferenceServer of two LM replicas and a DecodeServer push with
     collector=; then /fleetz lists the trainer, both pservers and both
     servers, none stale, a trainer send's trace is complete with the
     pserver's server span in it, and the trainer's every span landed
     exactly once.  Beside it, 2 trainers in sync and in async mode: the
     losses finite and falling;
  3f. (after 3e, in a process of its own, --ctr, started beside the card
     tests) Downpour CTR training and the rest of parameter-server
     training, every cluster's pservers on the card in processes of their
     own (--ps-node), all started at once: (a) DeepFM at the bench's
     widths with both tables is_distributed, SGD(0.1), batch 2048, 1
     trainer here against 2 async pservers, DownpourRunner in lockstep
     (push_window 1, pull_dense_every 1) for 10 batches: every loss and
     every parameter and table pulled back torch.equal to the local SGD
     run, the step split into pull, compute and push, the bytes each way,
     the last step profiled; (b, d) 2 trainer processes, each through
     exe.train_from_dataset over a QueueDataset of its 2 MultiSlot files
     of 20 batches (written from --seed; ids Zipf(1.2) folded into the
     vocabulary, the label whether the ids' truth id % 5 - 2 sums above
     0), _fleet_opt selecting DistMultiTrainer / DownpourSGD and the
     runner's transpile coming from fleet's role contract, against 2
     pservers up through fleet.init(PaddleCloudRoleMaker), the "pserver"
     strategy, init_server and run_server, push_window 3,
     pull_dense_every 2: each trainer's mean of its last 5 losses under
     0.6 x its first, native.NATIVE true everywhere; (c) the local
     train_from_dataset loop (one reader thread, DeviceFeeder) over one of
     those files, its losses torch.equal to Executor.run on the batches
     fed by hand, with the parser's seconds a file; (e) the LM of phase 5,
     f32, batch 8, the worker program's grads put to the async
     Communicator against 2 async Adam pservers for 10 steps, its recv
     thread swapping the parameters in: the loss falls, no error or
     restart, every merged grad's sections run on the pservers, 12/6/6
     flash launches a step, the step's ms; (f) that LM under
     ElasticTrainer(AsyncCheckpointer, save_every 3, each save waited for,
     the pservers' snapshots) against 2 sync Adam pservers: a clean run of
     8 steps (a process of its own), and a cluster whose trainer process
     os._exits after step 4, relaunched here: resume() returns 3, steps
     3-7 torch.equal to the clean run's, both pservers' step_3 snapshots
     with their manifests, 12/6/6 flash launches a resumed step, the
     checkpoint and resume seconds.  Each leg records whether the card
     tests still ran beside it;
  3g. (after 3e, in a process of its own, --collective) collective
     data-parallel training: 2 ranks on the one card, started through the
     port's launcher (python -m paddle_tpu_torch.launch --nproc_per_node
     2 chip_smoke.py --collective-rank SPEC), each through
     fleet.init(PaddleCloudRoleMaker()) on the backend parallel.env's rule
     picks (gloo: two ranks share the card), each feeding its half of
     phase 5's batch 8: (a) the LM, f32 Adam(1e-4), through
     fleet.distributed_optimizer(...).minimize and fleet.main_program, a
     warm-up and 5 counted steps: the ranks' losses and every parameter
     torch.equal, the run bitwise a reference in the phase's process that
     reproduces its sums (each half's forward and backward, the gradients
     averaged, then the optimizer's ops; else within twice two such
     references' spread), 12/6/6 flash launches a step a rank, the step's
     ms beside the local batch-8 step's, the gradient collectives' bytes
     a step and one all-reduce's ms, each collective's route, a profiled
     step's idle share; (b) the same with strategy.zero_stage = 1: its
     losses within (a)'s bar, a rank's optimizer state half of (a)'s, the
     peak memory of both; (c) the LM with Adam transpiled by
     GradAllReduce through Executor.run: its global losses within (a)'s
     bar; (d) conv2d_bn_train (kernels #6 and #7, bf16) at ResNet-50's
     stage-1 3x3 shape, batch 128 split over the ranks, in a
     data-parallel step: Output, SavedMean, SavedVariance and the grads of
     Input, Filter, Scale and BNBias against the op on the whole batch at
     phase 8's scaled tolerances, 2 conv_stats and 2 bn_apply launches a
     rank; (e) in the phase's process, a one-rank nccl group: the LM's
     compiled data-parallel step bitwise the compiled step without, its
     all-reduce captured in the CUDA graph; (f) each rank publishes (c)'s
     step-1 local loss and a gradient on a CollectiveServer: rank 0's
     CollectiveClient.gather equals c_allgather of the same values;
  3h. (right after the kernels' build, in a process of its own, --gspmd)
     GSPMD training and the tp-sharded Predictor: 2 ranks on the one card
     through the port's
     launcher (--gspmd-rank SPEC, gloo), the bench's tf_train_gspmd
     program (the LM with param_prefix "tfm", AMP decorate(Adam(1e-4))
     with static loss scaling, one adam op a parameter, fc_epilogue off)
     through set_flags({"gspmd": True}) and shard_program: (a) MeshPlan(dp=1,
     tp=2), both ranks fed the same AMP_BATCH (32) rows, a warm-up and 3
     counted steps: the ranks' fetches equal (sha256), the loss and the
     gathered gradients of tfm_l0_self_q.w, tfm_l0_ffn_fc2.w and
     tfm_out_fc.w within phase 7's AMP bars of the one-rank run of the
     same program without shard_program (in the phase's process), 12/6/6
     flash launches a step a rank on [32, 4, 512, 64] bf16, q.w's block
     [512, 256]; a planted fault (the start restored, rank 1's column
     block of tfm_l0_self_v.w zeroed before the first counted step) must
     break the bar; (b) MeshPlan(dp=2, tp=1), ZeRO-3, 16 rows a rank, held
     the same way, flash on [16, 8, 512, 64], a rank's parameter and Adam
     moment bytes half the one-rank run's; (c) in the phase's process,
     tf_train_gspmd as bench.py builds it on one card (tp clamped to the
     device count, a one-device mesh): its replays torch.equal to the
     program run without shard_program; (d) serving_tp_sharded's chain (256
     -> 1024 x3 relu -> 256, batch 8) saved, loaded into a Predictor and
     shard(MeshPlan(dp=1, tp=2)): its outputs equal to the lone
     Predictor's (else the largest difference, within the logits bound),
     sharding_info the [*, 512] blocks; each leg's ms a step by events and
     a profiled step's idle share;
 4. holds the two flash-attention backward kernels (dq and dkv) against
     their plain version over the same cases plus one with an lse
     cotangent and two f32 ones at head dims 48 and 96 (each case's max
     error scaled as BWD_TOL reads it is printed), and at the two
     32768-token shapes against the sliced
     plain version (dq's last 1024 rows, dk/dv's keys 16384-17407, also
     at a tolerance that a planted fault, one zeroed dO tile, must
     break); times them by CUDA-graph replay and by events beside the
     PyTorch pass that prepares their inputs (delta), the plain backward
     and SDPA's backward (forward+backward less forward, both timers);
     no case may copy its inputs; checks the autograd Function against
     autograd of the plain forward; holds the f32 backward's dq, dk and
     dv against the f64 reference as phase 2 does the forward;
  5. trains the same LM (is_test=False, dropout 0) in f32 with
     optimizer.Adam(1e-4).minimize(loss) through Executor.run on the
     card: one warm-up step, then TRAIN_STEPS (5) counted steps at batch
     8 on one fixed batch, counting the kernel launches of those steps (12
     forward, 6 dq, 6 dkv a step), and asserts the loss is finite and
     falls; then runs that program at batch 2 on the card and on the CPU:
     the loss and every parameter grad of step 1, and every parameter
     after step 2, must agree;
  6. holds the fc_epilogue kernel against its plain version over every
     fc stage subset (and the tanh gelu) at ragged shapes in f32 and
     bf16, and at the AMP path's three shapes (M 16384: out-proj, fc1,
     fc2), which must take the wgmma path, times it there by CUDA-graph
     replay and by events beside the plain version, the flag-off chain
     and torch.addmm, logs each call's path and TFLOP/s, and checks its
     autograd Function;
  7. trains the LM in the bench's AMP configuration (fuse_epilogue
     anchors=("fc",), bf16 AMP with static loss scaling 1.0,
     Adam(1e-4, fuse=True), flag fc_epilogue "on") at batch 32: one
     warm-up and 5 counted steps, 36 fc_epilogue (all on its wgmma path)
     and 12/6/6 flash launches a step, loss finite and falling; then the
     batch-2 step on
     the card against the CPU (flag "interpret"); then the bench's
     tf_train and tf_train_fcep legs (bench.py:307-432: AMP, one adam op
     a parameter, the fc fusion and flag "on" in the second only) at
     batch 32, 12/6/6 bf16 flash launches a step (and 36 fc_epilogue),
     the bench's MFU, each leg's batch-2 step against the CPU at the AMP
     bars;
  8. holds the conv kernels (conv_epilogue, conv_stats) against their
     plain versions over every conv stage subset at small ragged shapes
     (1x1, 3x3, 7x7, strides 1 and 2, Cin 3, ragged Cout), f32 and bf16,
     and at every distinct conv shape of ResNet-50 at batch 128 in bf16
     (the space-to-depth stem's 4x4/1 conv on 115x115x12 among them),
     timing each there by CUDA-graph replay and by events beside the
     plain version and cuDNN (plus torch.sum of y and y*y for
     conv_stats); holds bn_apply against its
     plain version at every batch-norm shape of that path, with the
     residual and relu it has there, timed (graph replay and events,
     each shape's share of its bound) beside F.batch_norm + add + relu;
  9. holds maxpool_grad_algo="compare" on the card at the stem pool's
     shape ([128, 112, 112, 64] bf16 NHWC after a ReLU) against "sas"
     (the same forward; every element that takes no tied gradient within
     two bf16 steps) and the CPU (equal on 8 images), logging the tied
     elements; then trains ResNet-50 (224x224, 1000 classes, random
     weights from --seed) in the bench's three legs, each built as the
     bench builds it (resnet50, space_to_depth_stem, the leg's fusion,
     nhwc_transpile, AMP bf16 with static loss scaling 1.0,
     Momentum(0.1, 0.9)) at batch 128: rn_train (no fusion, no hand
     kernel), rn_train_convbnstats (fuse_conv_bn_train, flag
     conv_bn_stats "on": 106 conv_stats and 106 bn_apply launches a
     step) and rn_train_convep (flag conv_epilogue "on": 106
     conv_epilogue launches a step; RN_CONVEP_STEPS (3) counted steps,
     the others RN_STEPS (5)), finite losses, the bench's MFU; then
     batch-2 steps on the card against the CPU (flag "interpret"), each
     held within a multiple of the spread of a second CPU run (flag
     "off"): rn_train_convbnstats in f32 and AMP, rn_train_convep and
     rn_train in f32 (rn_train builds rn_train_convep's program: they
     share both CPU runs);
 10. (phase 9's legs run their compiled passes as every Executor path
     does, below);
 11. holds flash_decode against its plain version on the card over
     ragged lengths (zero-length rows, page and split boundaries), d
     16/64/72/128/160/256/1536/2048/3072 (above 2048 the wide kernel),
     pages of 4/16/32/128 tokens, f32/bf16/int8
     pools, 1/3/5/20/70 query rows, strided block tables, the server's
     shapes (64 streams of 64-160 tokens, 8 heads of 128, page 128, f32
     and int8 pools) and long ones (64 x 4096 tokens, one 32768-token
     sequence as a step and as a 5-row verify sweep); asserts verify rows
     array_equal to q-len-1 launches (across split boundaries too) and
     zero-length rows exact zeros; times the kernel (and its share of
     its bound), the plain version and the gather + SDPA library route;
 12. serves LLM decode through DecodeServer(config=DecodeConfig(...)) ->
     submit -> Request.result on the card at the bench's llm_decode
     widths (TinyDecodeLM vocab 32000, d_model 1024, 8 heads of 128,
     page 128, max_batch 64, random weights from --seed): 64 prompts of
     64-128 tokens, 32 new tokens each, plain (flash_decode launches ==
     iterations), with spec_k=4 ((k+1) launches an iteration) under the
     default draft and under the target as its own draft (acceptance
     above 0), with int8 pools, and 16 prompts of 4096 tokens at
     prefill_chunk=512; every request answered, zero page leaks after
     stop(); holds int8 pools to next-token agreement >= 0.95 with f32
     over 256 prompts, each cache calibrated on its own prompt (the JAX
     package's bar and setting); then the bench's
     llm_decode_chunked_join: 16 streams of 128-token prompts decode 160
     tokens while a 32768-token prompt joins and prefills in 512-token
     chunks (64), each stream's tokens equal to a run with no join, the
     joiner's to its run alone, zero page leaks, flash_decode on a table
     wider than 256 pages, and the streams' inter-token p99 during the
     join (under 0.25 s) and after it logged;
 12b. disaggregated prefill/decode, DecodeConfig(disagg_prefill=True,
     n_prefill_replicas=2) at those widths: 64 prompts of 64-128 tokens,
     32 new tokens each, over one shared pool of 192 pages, with 1 decode
     replica at max_batch 64 and with 2 at 32, each beside a single-tier
     run of the same replicas and batch: every stream's tokens equal to
     the single tier's, all 64 handoffs adopted, flash_decode launches
     == iterations, nothing in use or in transit on the shared pool after
     stop(); flash_decode held to its plain version (DECODE_TOL f32) on
     the shared pool's own tables at the first iteration with at least
     32 live streams and a fragmented table (the share of non-consecutive
     page pairs logged) and timed there by graph replay beside its bound,
     and timed on the bench's strided handoff layout beside contiguous
     tables; tokens/s, inter-token p50/p99, handoff latency p50/p99 (the
     paddle_tpu_disagg_handoff_seconds histogram) and a profiled run's
     device idle share of both tiers and the single tier; then the first
     configuration under serving_prefill@1:kill (restart_dead=False) and
     under serving_decode@2:kill (tools/chaos_soak.py's pinned windows):
     every request answered once, one kill, a failover, the fault-free
     single tier's tokens, nothing leaked;
 13. runs 8 of those prompts through the CPU DecodeServer, plain and
     with int8 pools, and holds the card's plain, speculative (both
     drafts) and int8 tokens to them, token for token up to the first
     step whose CPU top-2 logit margin is a near-tie;
 14. profiles one request and one step of each training path and one
     served run of the 64 decode requests, first submit to last result
     (device busy share, top kernels), inside phases 3, 5, 7, 9 and
     12 (and the chunked join), one batch of each inference leg in
     15-17 and one step of each
     leg in 19-21, each Executor path interpreted and compiled;
 15. conv-net inference in bf16, the bench's legs (bench.py:623-661) on
     weights from --seed, every batch norm's scale and shift drawn and
     its statistics taken from 8 images: infer (ResNet-50 at batch 128,
     unfolded), its A/B lever infer_convep (the conv+bn fold,
     fuse_conv_epilogue and flag conv_epilogue "on": 53 conv_epilogue
     launches a batch with bias, residual and relu), vgg_infer (VGG16 at
     64), vgg_cifar and rn32_cifar (at 512): one warm-up and INFER_RUNS
     (5) counted batches each (ms by events and by the host clock,
     launches, a profile), and at batch 2 the card's bf16 logits against
     the CPU's f32 run of the program before bf16_transpile, within the
     leg's BF16_BOUNDS of scale with the same top-1 (where the top-2
     margin is above twice the error), and a planted fault (the last
     block's shift zeroed) that must break the bound;
 16. int8 inference, infer_i8 and infer_i8_inter (bench.py:768-929):
     ResNet-50 folded, nhwc, abs-max int8 weights, calibrated on 8
     images, converted with bf16 out (int8 activations between layers in
     the second), the bench's calibration and interlayer coverage numbers
     and gates, INFER_RUNS batches of 128 with one conv_int8 launch per
     int8 op a batch, every one on its wgmma route, and one quantize_act
     launch per int8 op with a float input, and at batch 2 the card
     against the CPU's run of
     the same converted program: every logit and the fc's float input
     equal (the share of equal logits and any other's distance in steps
     of the fc's lattice logged);
 17. the bf16 Predictor: ResNet-50 saved, Config(dir) with
     enable_mkldnn_bfloat16, create_predictor (ir_optim folds conv+bn),
     INFER_RUNS requests of 128 images, and a batch-2 request against the
     CPU's f32 Predictor (planted fault: its last folded shift zeroed);
 18. conv_int8 torch.equal to its plain version at every distinct int8
     shape of phase 16 and of ResNet-32 on cifar (the fc as a 1x1
     convolution) over 16 images (I8_SWEEP_BATCH) with every epilogue
     subset of I8_SUBSETS and every one the legs run there (Bias and
     Residual in the dtypes the run gave them), and at the legs' batch
     with the legs' own; each (shape, epilogue) of the two legs timed by graph
     replay and by events beside the plain version, the first design
     (the mma.sync route, the parent's kernel, which must give the same
     bits), torch._int_mm on an explicit im2col and cuDNN's bf16
     convolution, its timed operands held torch.equal to the plain
     version; quantize_act torch.equal to its plain version at every
     float input of the legs' int8 ops, timed beside the plain version's
     PyTorch passes; conv_epilogue at the fused graph's shapes and
     stages, timed beside cuDNN + adds + relu;
 19. (19-21 run in a process of their own: torch.profiler loses records
     of a long process's later profiles) trains the bench's long-context
     legs, longctx and longctx_d128
     (bench.py:998-1046): q, k, v [1, 8, 32768, D] bf16 data vars that
     take grads, flash_attention causal, loss = reduce_sum(cast(out,
     f32)), append_backward, fetching the loss and q/k/v@GRAD, at D 64
     and 128 (flags flash_packed_stats and flash_head_pack set "off", as
     the bench sets them): one warm-up and 5 counted steps, 2 forward, 1
     dq and 1 dkv launches a step, every step's fetches torch.equal to a
     direct call of the flash autograd Function on the same inputs, ms a
     step beside SDPA's forward + backward; then the program at 2 heads
     of 1024 tokens on the card against the CPU (plain attention at 32768
     tokens needs a 4 GiB score matrix a head and many minutes there);
 20. trains BERT-base (bench.py:476-534: vocab 30522, 768 wide, 12 heads
     of 64, 12 layers, d_inner 3072, seq 512, dropout 0, random weights
     from --seed) under the bench's AMP (decorate(Adam(1e-4)), static
     scaling 1.0) at batch 8 on bert_inputs_synthetic: one warm-up and 5
     counted steps, 24 flash forward (12 recomputed in the grads), 12 dq
     and 12 dkv launches a step, all bf16 (the profiled steps' kernel
     functions), loss finite and falling, the bench's MFU (6N + 12 L d s
     FLOPs a token) against 989 TFLOP/s; then a batch-2 AMP step on the
     card against the CPU, held norm-wise within 3x the distance of a
     second CPU run, in f32, from the CPU's AMP run; and the batch-2 f32
     step on the card (TF32 off) against that CPU f32 run, each grad (the
     q/k weight grads among them) within 3x its distance between the
     CPU's f32 and f64 runs or a floor, which a zeroed 64-row tile of dq,
     and of dk, planted after each launch of that kernel, must break;
 21. trains DeepFM (bench.py:557-585: 26 fields, vocab 100000, embed 16,
     dense 13, hidden 400 x 3, dense lookups) with f32 Adam(1e-3) at batch
     2048 on the bench's rng feeds: one warm-up and 5 counted steps, no
     hand kernel launched, loss finite and falling; then a batch-2 step
     on the card against the CPU as in 5;
 22. prints one {"kernels": [...]} line (ten kernels), then the card's
     line, then the result line {"ok": true, "device": {...}} last.

The compiled path: every Executor path above (phases 3, 5, 7 with its
two legs, the three legs of 9, the five bf16 legs of 15, the two int8
legs of 16, 17, the two legs of 19, 20 and 21) runs its counted steps
or batches a second time through CompiledProgram (the Predictor's own,
or one built on the program), from the same state and feeds: its first
call runs the plan eagerly and captures it into a CUDA
graph, and every counted call must replay that graph (no launch counted
from Python, one capture for the shape), with the replays' launches (the
capture's counts times the replays) equal to the interpreted run's, the
port's kernels by name in one profiled replay equal to one profiled
interpreted call's, every persistable at its address, and the results
equal to the interpreted run's bitwise, or, where two interpreted runs
differ (atomics in cuDNN's backward and the embedding grad), within
twice their spread.  Each path's ms by the host clock and by events, its
profiled device busy and idle share and its peak memory are logged
beside the interpreted figures, and summed up in one line before the
kernels line.

The batch-2 checks' CPU runs (the LM's, the three ResNet-50 legs',
BERT-base's) are computed by a process of their own (--cpu-references),
started with the build at the lowest priority with no card visible; each
check takes its runs from there, waiting where they are not done yet.

Takes 14 to 19 minutes on one NVIDIA H100 80GB HBM3 at 700 W, the
kernels' build included, as fast as the machine's host is (PERF.md);
"seconds by phase" is logged before the kernels line.
Every main path also holds the flash kernels' input copies at 0.

Exits non-zero, printing no result line, when no CUDA device is present
or when any phase fails.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# Transformer-base (the JAX package's bench.py TRANSFORMER_BASE) at the
# bench's seq 512 and a serving batch of 8 requests' worth of rows.
MODEL = dict(vocab_size=32000, max_len=512, d_model=512, n_head=8,
             d_inner=2048, n_layer=6, dropout_rate=0.0, is_test=True)
BATCH = 8
# BERT-base (bench.py BERT_BASE, _build_bert_train): vocab 30522, 768 wide,
# 12 heads of 64, 12 layers, d_inner 3072, seq 512, dropout 0, at the
# bench's batch 8 under its AMP (decorate(Adam(1e-4)), static scaling 1.0)
BERT = dict(vocab_size=30522, max_len=512, d_model=768, n_head=12,
            d_inner=3072, n_layer=12, dropout_rate=0.0)
BERT_BATCH = 8
BERT_LR = 1e-4
# H100 SXM peaks at the full 700 W (NVIDIA data sheet): HBM bytes/s and
# dense FLOP/s by input type; float32 is the rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# f32 work at f32 accuracy on the tensor cores: split TF32, each product
# three TF32 products (each operand's high and low halves; the f32 flash
# backward kernels compute so, csrc/tensor_core.cuh) at the dense TF32 rate
PEAK_TF32_FLOPS = 494.7e12
SPLIT_TF32_PRODUCTS = 3
# f32 kernel vs plain version (both f32 accumulation, other orders);
# bf16 out carries the bf16 rounding of P and of the output.
TOL = {"float32": {"out": 1e-4, "lse": 1e-4},
       "bfloat16": {"out": 3e-2, "lse": 1e-3}}
# GPU vs CPU logits of the full model: f32 throughout (cuBLAS with TF32
# off; the flash forward's f32 products split TF32, about 21 bits of each
# operand), so little but summation order differs across ~16 f32
# reductions of width <= 2048.
LOGITS_ATOL = LOGITS_RTOL = 2e-3
ARGMAX_AGREE = 0.999
# backward kernels vs their plain version, relative to the reference's
# scale.  f32: the kernels' products are split TF32 (about 21 bits of each
# operand, f32 sums), the plain version's cuBLAS products full f32, and
# the sums run in other orders; on the H100 the f32 cases read 1.5e-6 to
# 8.8e-6, so 1e-4 still holds with an order of magnitude to spare, while
# single-pass TF32 (about 11 bits) would read near 1e-3.  bf16 rounds dS
# to bf16 in both, at points where the f32 sums already differ.
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# training: Adam at this rate on one fixed batch, seq 512
TRAIN_LR = 1e-4
# AMP training: the bench's configuration (bench.py
# _build_transformer_train: fuse_epilogue(anchors=("fc",)), bf16 AMP with
# static loss scaling 1.0, Adam(1e-4, fuse=True)) at its batch 32
AMP_BATCH = 32
TRAIN_STEPS = 5
CHECK_BATCH = 2
# GPU vs CPU training step, f32 with TF32 off for cuBLAS on the card;
# the flash backward's split-TF32 products differ from f32 products by at
# most about 1e-5 of a grad's scale (phase 4), below these bounds, so the
# sums differ in order and little else: the loss within LOSS_RTOL, and
# each grad within GRAD_BULK_RTOL of its own max magnitude in all but
# GRAD_BULK_SHARE of its elements.  Its max error may be larger: a ReLU
# whose input lies within rounding of 0 takes the other branch on the
# other device, and that changes one token's contribution to one hidden
# unit, about 1/(batch*seq) of a grad's scale (GRAD_FLIP_TOKENS tokens'
# worth are allowed).  Adam moves a weight by about lr*sign(m1) while m1
# is young, so a grad near 0 may flip its step: parameters after two
# steps agree within 2*lr a step plus 1e-5.
LOSS_RTOL = 1e-5
GRAD_BULK_RTOL = 1e-4
GRAD_BULK_SHARE = 0.01
GRAD_FLIP_TOKENS = 5
PARAM_ATOL = 2 * 2 * TRAIN_LR + 1e-5
# AMP GPU vs CPU (CPU flag 'interpret', so both compute the fc_epilogue
# kernel's function).  The products, the casts' outputs and the
# activations are bf16, so cuBLAS, the kernels and the CPU may round a
# value one bf16 step (2^-8 relative) apart at each of those points, and
# this model at batch 2 amplifies such steps: ReLU inputs within a step
# of 0 land on the other side (or on the tie, gradient 1/2), and the
# attention grads take dP - delta, a difference of near-equal terms.  A
# second CPU run with flag 'off' (the chain: the same function, rounded
# at other points) shows that spread beside the check, in the same
# units.  The loss within AMP_LOSS_RTOL; each grad within
# AMP_GRAD_NORM_RTOL of its norm, within AMP_GRAD_BULK_RTOL of its scale
# in all but AMP_GRAD_BULK_SHARE of its elements and within
# AMP_GRAD_MAX_RTOL everywhere: about twice the two CPU runs' spread;
# a wrong grad is off by its own size.  Parameters (f32 master weights)
# as in the f32 check.
AMP_LOSS_RTOL = 1e-3
AMP_GRAD_NORM_RTOL = 0.15
AMP_GRAD_BULK_RTOL = 3e-2
AMP_GRAD_BULK_SHARE = 0.15
AMP_GRAD_MAX_RTOL = 0.3
# fc_epilogue kernel vs its plain version, relative to max(1, |ref|):
# f32 sums in other orders; bf16 output is one rounding of f32 sums
# taken in other orders, so the two may sit one bf16 step apart.
FC_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# ResNet-50 training: the bench's three legs (bench.py
# _build_resnet50_train with its default s2d=True: the space-to-depth stem)
# at its batch 128, 224x224, 1000 classes; Momentum(0.1, 0.9) under AMP
# with static loss scaling 1.0.  Leg name -> build config: no fusion and
# no hand kernel, fuse_conv_bn_train, or the conv_epilogue flag.
RN_LEGS = {"rn_train": "plain", "rn_train_convbnstats": "conv_bn_stats",
           "rn_train_convep": "conv_epilogue"}
RN_BATCH = 128
RN_STEPS = 5
RN_CONVEP_STEPS = 3
RN_LR, RN_MOMENTUM = 0.1, 0.9
# the bench's MFU numerator (bench.py:112, applied at :248): the original
# model's forward FLOPs, 8.2 GFLOP an image, times 3 for training; the
# stem's rewrite does ~30 % more stem MACs, which this leaves out
RN_TRAIN_FLOPS_PER_IMAGE = 3 * 8.2e9
# conv kernels vs their plain version, relative to max(1, |ref|), as for
# fc_epilogue; the statistics' mean and var relative to their scale: f32
# sums in other orders, and in bf16 y itself may sit one step apart.
CONV_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
STATS_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
# bn_apply rounds at the plain version's points (no fused multiply-add):
# f32 to within 1e-6 of the scale, bf16 within one bf16 step.
BN_TOL = {"float32": 1e-6, "bfloat16": 1e-2}
# every conv stage subset at small ragged shapes (N, H, W, Cin, Cout, K,
# stride, pad): 1x1/3x3/7x7, strides 1 and 2, the 3-channel stem (channels
# padded to 8), Cin 24 (K off the 64-deep step), Cout not a multiple of 8
# (masked w loads, element stores), and each bf16 tile shape (Cout 64,
# 128, 256 and two tiles of 256 at 300)
CONV_ODD_SHAPES = [(2, 9, 9, 16, 32, 3, 1, 1), (2, 9, 9, 16, 24, 3, 2, 1),
                   (2, 8, 8, 32, 136, 1, 2, 0), (2, 20, 20, 3, 64, 7, 2, 3),
                   (1, 10, 6, 8, 300, 3, 1, 0), (2, 9, 9, 24, 24, 3, 2, 1),
                   (4, 12, 12, 64, 128, 3, 1, 1), (2, 8, 8, 64, 256, 1, 1, 0)]
# ResNet-50 GPU vs CPU at batch 2 (TF32 off for cuDNN and cuBLAS).  The
# loss is well conditioned (two f32 CPU runs agree to ~1e-6), the step's
# grads are not: at batch 2 the last stage's features vary mostly between
# the two images, so each BN backward there is a difference of near-equal
# terms.  A change of 1e-7 in the image moves the f32 conv grads by up to
# ~4% of their norm, whatever the size of the change, and the bf16 grads
# by more than their norm; the second step, at lr 0.1 on one batch,
# amplifies that again.  A third CPU run, of the image scaled by
# 1 + RN_NUDGE, shows it beside each check.  So the GPU run is held against the CPU run (flag 'interpret') norm-wise,
# each metric within RN_SPREAD_FACTOR times the same metric of a second
# CPU run (flag 'off': the same function, rounded at other points), or
# within its floor where that is larger: the loss's relative error, the
# largest grad error relative to the grad's norm, and the error of the
# two-step update of the parameters and BN running statistics relative to
# the update's norm.  The elementwise metrics are printed beside them.  A
# wrong kernel is off by the size of what it computes; the loss tells it
# (the bf16 grads' bound is above 1 and so tells nothing).
RN_SPREAD_FACTOR = 3.0
RN_NUDGE = 1e-7
RN_GRAD_BULK_RTOL = 1e-3
RN_FLOORS = {"float32": dict(loss=1e-4, norm=1e-2, update=1e-2),
             "bfloat16": dict(loss=1e-2, norm=0.1, update=0.1)}
# every stage subset at ragged shapes (M, K, N): masked loads, and K, N
# multiples of 8 (the cp.async path) with ragged tiles
FC_ODD_SHAPES = [(100, 130, 77), (257, 64, 136)]
# the AMP path's three fc_epilogue calls a layer, M = AMP_BATCH * 512
FC_MAIN = [("out_proj", 512, 512, "residual"),
           ("fc1", 512, 2048, "bias+relu"),
           ("fc2", 2048, 512, "bias+residual")]


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# flash_decode's nvcc (146 kernel functions) outlasts every other source's
# by a minute or more, and nothing before the decode phase needs it: it
# builds beside the phases that come first, and the card tests, which need
# every kernel, run just before the decode phase
EARLY_KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "fc_epilogue",
                 "conv_epilogue", "bn_apply", "conv_int8", "quantize_act")
LATE_KERNELS = ("flash_decode",)


def timed_build(names):
    """``_build.build(names)``: the nvcc logs and the seconds it took."""
    from paddle_tpu_torch import _build

    t = time.perf_counter()
    logs = _build.build(list(names))
    return logs, time.perf_counter() - t


def card_tests():
    """Runs the card tests, tests/test_torch_cuda.py, in a process of
    their own (it imports no JAX; hence --noconftest) on the libraries
    just built; fails unless every test passes."""
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p",
         "no:cacheprovider", "-q", "tests/test_torch_cuda.py"],
        cwd=root, capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:] or [proc.stderr.strip()]
    log(f"card tests: {tail[0]} ({time.perf_counter() - t0:.1f} s)")
    if proc.returncode != 0:
        raise AssertionError("card tests failed:\n" + proc.stdout[-8000:]
                             + proc.stderr[-2000:])


def cuda_ms(fn, iters, warmup=3):
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


def graph_ms(fn, iters):
    """Device time of one call of ``fn``: ``iters`` calls captured into
    one CUDA graph and replayed between CUDA events, so the host's time
    to issue each call is out of the count (a decode step's kernel is
    shorter than the Python that launches it)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
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
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: flash_attention_fwd against its plain version
# ---------------------------------------------------------------------------

# (B, H, Tq, Tk, D, causal, dtype, strided): strided q/k/v are permuted
# views of [B, T, H, D] tensors, as the model's transpose2 hands them over
FLASH_CASES = [
    # above D 256 (the wide tile in 256-column slices), causal and not,
    # several K/V tiles
    (1, 2, 150, 230, 320, True, "float32", False),
    (1, 2, 130, 210, 512, False, "float32", True),
    (1, 2, 200, 230, 320, False, "bfloat16", True),
    (1, 2, 129, 257, 512, True, "bfloat16", False),
    # the wide tile (128 < D <= 256), causal and not, several tiles on
    # both sides
    (1, 2, 200, 200, 160, True, "float32", False),
    (2, 2, 130, 190, 256, False, "float32", True),
    (1, 2, 200, 200, 160, True, "bfloat16", True),
    (1, 2, 129, 257, 256, True, "bfloat16", False),
    (2, 4, 128, 128, 64, True, "float32", False),
    (2, 4, 128, 128, 64, False, "float32", False),
    (2, 3, 100, 228, 64, True, "float32", False),
    (1, 2, 200, 77, 128, True, "float32", False),
    (2, 4, 130, 130, 128, False, "float32", False),
    (1, 2, 64, 96, 32, False, "float32", True),
    (2, 4, 128, 256, 64, True, "bfloat16", False),
    (1, 2, 97, 97, 128, False, "bfloat16", False),
    # BERT-base's attention (phase 20): 12 heads, not causal, the model's
    # permuted views
    (BERT_BATCH, BERT["n_head"], BERT["max_len"], BERT["max_len"],
     BERT["d_model"] // BERT["n_head"], False, "bfloat16", True),
    (BATCH, 8, 512, 512, 128, True, "float32", True),
    (BATCH, 8, 512, 512, 64, True, "float32", True),
    (BATCH, 8, 512, 512, 64, True, "bfloat16", True),
    (AMP_BATCH, 8, 512, 512, 64, True, "bfloat16", True),
]
MAIN_CASE = FLASH_CASES[-3]
AMP_CASE = FLASH_CASES[-1]
F32_D128_CASE = FLASH_CASES[-4]
BERT_CASE = FLASH_CASES[-5]
# the bench's longctx and longctx_d128 legs (bench.py:998-1104), causal at
# 32768 tokens: timed whole, and held against the plain version on their
# last LONG_CHECK_ROWS query rows, which the plain version computes exactly
# under bottom-right alignment (a whole 32768^2 f32 score matrix is 34 GB)
LONG_CASES = [(1, 8, 32768, 32768, 64, True, "bfloat16", True),
              (1, 8, 32768, 32768, 128, True, "bfloat16", True)]
LONG_CHECK_ROWS = 1024
# Those rows average ~32768 unit-normal values each, so |out| is about
# 0.01 and TOL's 3e-2 cannot see a fault in a few K/V tiles.  They are also
# held to LONG_TOL: max |out - ref| (1e-3, four bf16 steps of max |ref| ~
# 0.04) and ||out - ref|| / ||ref|| (1e-2; bf16 rounding alone gives ~2.5e-3).
# The same statistics of the plain version with one 64-key V tile zeroed
# (LONG_FAULT_KEY..+63), a planted fault, must break both limits.
LONG_TOL = {"out": 1e-3, "out_rel": 1e-2}
LONG_FAULT_KEY = 16384


# The f32 kernels against an f64 reference (autograd of the plain
# attention in f64, head by head) at the f32 step's shape and at a long T,
# causal: each output's mean signed error, signed by the reference (a
# bias toward zero, which long chains of truncating tensor-core sums give,
# reads negative), and its max error, beside the plain f32 version's
# (cuBLAS with TF32 off) against the same reference.
F64_SHAPES = [(8, 8, 512, 64), (1, 8, 8192, 64), (1, 4, 512, 320)]


def f64_reference(q, k, v, do, scale):
    """Causal attention's out and (with ``do``) dq, dk, dv in f64, by
    autograd, one (batch, head) slice at a time."""
    import torch

    b, h, tq, _ = q.shape
    tk = k.shape[2]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril(
        tk - tq)
    outs = {n: torch.empty(x.shape, dtype=torch.float64, device=q.device)
            for n, x in (("out", q), ("dq", q), ("dk", k), ("dv", v))}
    for i in range(b):
        for j in range(h):
            leaves = [x[i, j].double().requires_grad_() for x in (q, k, v)]
            s = torch.matmul(leaves[0], leaves[1].T) * scale
            p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
            out = torch.matmul(p, leaves[2])
            outs["out"][i, j] = out.detach()
            if do is not None:
                g = torch.autograd.grad(out, leaves, do[i, j].double())
                for n, x in zip(("dq", "dk", "dv"), g):
                    outs[n][i, j] = x
            del s, p, out, leaves
    return outs


def f64_errors(got, ref):
    """(mean signed error, signed by the reference; max error)."""
    import torch

    diff = got.double() - ref
    return {"mean_signed": (diff * torch.sign(ref)).mean().item(),
            "max": diff.abs().max().item()}


def check_f32_vs_f64(device, seed, grads):
    """The f32 forward (``grads`` False) or backward kernels against the
    f64 reference at F64_SHAPES, beside the plain f32 version; one row per
    shape and output, logged and returned."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(seed + 11)
    rows = []
    for shape in F64_SHAPES:
        q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device) for _ in range(4))
        scale = 1.0 / math.sqrt(shape[-1])
        ref = f64_reference(q, k, v, do if grads else None, scale)
        out, lse = fa.flash_attention_fwd(q, k, v, True, scale)
        out_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, True, scale)
        got = {"out": (out, out_p)}
        if grads:
            kernel = fa.flash_attention_bwd(q, k, v, out, lse, do, True,
                                            scale)
            plain = fa.flash_attention_bwd_plain(q, k, v, out_p, lse_p, do,
                                                 True, scale)
            got = {n: pair for n, pair in zip(("dq", "dk", "dv"),
                                              zip(kernel, plain))}
        torch.cuda.synchronize()
        for name, (g, pl) in got.items():
            row = dict(shape=list(shape), output=name,
                       ref_mean_abs=ref[name].abs().mean().item(),
                       kernel=f64_errors(g, ref[name]),
                       plain=f64_errors(pl, ref[name]))
            log("f32 vs f64 " + json.dumps(row))
            rows.append(row)
        del q, k, v, do, ref, out, out_p, got
        torch.cuda.empty_cache()
    return rows


# kernel -> (Tq x Tk x D products, [B,H,Tq,D] tensors moved, [B,H,Tk,D]
# tensors moved, f32 [B*H,Tq] vectors moved)
FLASH_WORK = {
    "fwd": (2, 2, 2, 1),    # QK^T, PV; q, out; k, v; lse
    "dq": (3, 3, 2, 2),     # S, dP, dQ; q, dO, dq; k, v; lse, delta
    "dkv": (4, 2, 4, 2),    # S, dP, dV, dK; q, dO; k, v, dk, dv; lse, delta
}


def flash_bound_ms(b, h, tq, tk, d, causal, dtype, kernel="fwd"):
    """Least time for the work, as (ms, "bytes" or "operations", the
    CUDA-core ms): each input read once and each output written once over
    HBM, or the FLOPs (2 per multiply-add of each Tq x Tk x D product,
    halved when causal) at the card's peak for the input type, whichever
    is larger.  In bf16, dV = P^T dO with P kept in f32 is two bf16
    products (P's high and low halves), so dkv counts five.  f32 work
    takes the lesser of two bounds at f32 accuracy: three TF32 products
    each (split TF32) at the TF32 rate, or the CUDA cores' rate; the
    latter is also returned on its own (None in bf16)."""
    products, n_q, n_k, n_vec = FLASH_WORK[kernel]
    if kernel == "dkv" and dtype == "bfloat16":
        products += 1
    elem = 4 if dtype == "float32" else 2
    nbytes = elem * b * h * d * (n_q * tq + n_k * tk) + 4 * n_vec * b * h * tq
    flops = 2.0 * products * b * h * tq * tk * d * (0.5 if causal else 1.0)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3

    def bound(rate):
        t_ops = flops / rate * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
            "operations"

    if dtype == "bfloat16":
        return (*bound(PEAK_FLOPS[dtype]), None)
    cuda_core = bound(PEAK_FLOPS[dtype])
    split = bound(PEAK_TF32_FLOPS / SPLIT_TF32_PRODUCTS)
    return (*min(split, cuda_core), cuda_core[0])


def check_flash(device, seed):
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(seed)
    results = []
    for (b, h, tq, tk, d, causal, dtype, strided) in FLASH_CASES + \
            LONG_CASES:
        tdtype = getattr(torch, dtype)

        def make(t):
            x = torch.from_numpy(rng.standard_normal(
                (b, t, h, d)).astype(np.float32))
            x = x.to(device=device, dtype=tdtype)
            x = x.permute(0, 2, 1, 3)
            return x if strided else x.contiguous()

        q, k, v = make(tq), make(tk), make(tk)
        scale = 1.0 / math.sqrt(d)
        copies = fa.flash_attention_fwd.copies
        out, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        rows = min(tq, LONG_CHECK_ROWS) if tq > 4096 else tq
        q_rows = q[:, :, tq - rows:]

        def plain():
            return fa.flash_attention_fwd_plain(q_rows, k, v, causal, scale)

        ref_out, ref_lse = plain()
        ref_out = ref_out.float()
        err_out = (out[:, :, tq - rows:].float()
                   - ref_out).abs().max().item()
        err_lse = (lse.reshape(b, h, tq)[:, :, tq - rows:].reshape(
            b * h, rows) - ref_lse).abs().max().item()
        ok = err_out <= TOL[dtype]["out"] and err_lse <= TOL[dtype]["lse"] \
            and fa.flash_attention_fwd.copies == copies
        long = {}
        if rows < tq:
            def errs(got):
                diff = got.float() - ref_out
                return {"out": diff.abs().max().item(),
                        "out_rel": (diff.norm() / ref_out.norm()).item()}

            v_fault = v.clone()
            v_fault[:, :, LONG_FAULT_KEY:LONG_FAULT_KEY + 64] = 0
            long = {"long_errs": errs(out[:, :, tq - rows:]),
                    "planted_fault_errs": errs(fa.flash_attention_fwd_plain(
                        q_rows, k, v_fault, causal, scale)[0])}
            del v_fault
            ok = ok and all(
                long["long_errs"][key] <= LONG_TOL[key]
                < long["planted_fault_errs"][key] for key in LONG_TOL)
        del ref_out, ref_lse
        # device times from CUDA-graph replay: the wrapper's host time to
        # issue a call is above the kernel's at the smaller shapes.
        # event_ms times the calls as issued (cuda_ms), the yardstick of
        # the kernel's times before graph replay
        iters = 5 if tq > 4096 else 20 if tq * tk >= 512 * 512 else 50
        ms = graph_ms(
            lambda: fa.flash_attention_fwd(q, k, v, causal, scale), iters)
        event_ms = cuda_ms(
            lambda: fa.flash_attention_fwd(q, k, v, causal, scale), iters)
        plain_ms = graph_ms(plain, iters)
        mask = fa._causal_mask(tq, tk, device) if causal and tq != tk \
            else None
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None,
            scale=scale), iters)
        bound_ms, bound_by, bound_cuda_core_ms = flash_bound_ms(
            b, h, tq, tk, d, causal, dtype)
        row = dict(shape=[b, h, tq, tk, d], causal=causal, dtype=dtype,
                   strided=strided, max_abs_err_out=err_out,
                   max_abs_err_lse=err_lse, checked_rows=rows, **long,
                   ms=ms, event_ms=event_ms, plain_ms=plain_ms,
                   library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_cuda_core_ms=bound_cuda_core_ms,
                   copies=fa.flash_attention_fwd.copies - copies, ok=ok)
        log("flash case " + json.dumps(row))
        if not ok:
            raise AssertionError(
                f"flash_attention_fwd disagrees with its plain version: "
                f"{row}")
        results.append(row)
    return results


# ---------------------------------------------------------------------------
# phase 4: the backward kernels (dq, dkv) against their plain version
# ---------------------------------------------------------------------------

# the forward's cases, plus one with a cotangent of lse (the last flag)
# and the f32 kernels at two more head dims, with several tiles on both
# sides
BWD_CASES = [c + (False,) for c in FLASH_CASES] + [
    (2, 3, 100, 228, 64, True, "float32", True, True),
    (2, 4, 200, 330, 48, True, "float32", True, False),
    (1, 4, 300, 300, 96, False, "float32", False, True)]
BWD_MAIN_CASE = BWD_CASES[len(FLASH_CASES) - 3]
BWD_AMP_CASE = BWD_CASES[len(FLASH_CASES) - 1]
BWD_BERT_CASE = BWD_CASES[len(FLASH_CASES) - 5]
# the bench's longctx legs (training steps, fwd+bwd): the kernels run
# whole and are held against the sliced plain version on dq's last
# LONG_CHECK_ROWS rows and dk/dv's keys LONG_BWD_KEYS (a full plain
# backward would need four 34 GB score matrices), summed LONG_BWD_CHUNK
# keys or rows at a time
LONG_BWD_CASES = [c + (False,) for c in LONG_CASES]
LONG_BWD_KEYS = (16384, 16384 + 1024)
LONG_BWD_CHUNK = 4096
# Each output is also held to LONG_BWD_TOL, max |err| / max |ref| and
# ||err|| / ||ref||, and the plain version with one 64-row dO tile zeroed
# (rows LONG_BWD_FAULT_ROW..+63, inside dq's rows and the q sweep of the
# checked keys), a planted fault, must break both limits of every output.
# On the H100 the kernels read at most 4.7e-3 and 4.8e-4 (one bf16 step of
# an output), the planted fault at least 0.107 and 0.046 (dk, dv; dq 0.64
# and 0.25): the limits sit ~3x and ~8x above the first, 7x and 11x below
# the second
LONG_BWD_TOL = {"max": 1.5e-2, "rel": 4e-3}
LONG_BWD_FAULT_ROW = 32768 - 512


def sdpa_bwd_ms(q, k, v, do, causal, scale, iters):
    """SDPA's backward, as (graph replay, events): SDPA's forward plus
    autograd.grad through it, less SDPA's forward alone, each timed the
    same way (the forward is captured with the backward, as the autograd
    graph must be built inside the capture)."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    tq, tk = q.shape[2], k.shape[2]
    mask = fa._causal_mask(tq, tk, q.device) if causal and tq != tk \
        else None
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def fwd():
        return F.scaled_dot_product_attention(
            *leaves, attn_mask=mask, is_causal=causal and mask is None,
            scale=scale)

    def both():
        return torch.autograd.grad(fwd(), leaves, do)

    return (graph_ms(both, iters) - graph_ms(fwd, iters),
            cuda_ms(both, iters) - cuda_ms(fwd, iters))


def bwd_kernel_ms(q, k, v, o, lse, do, causal, scale, dlse, iters):
    """Each backward kernel alone on prepared inputs, as {name: ms} by
    graph replay and by events, and the PyTorch pass that prepares their
    inputs (delta = rowsum(dO*O) - dlse) by events."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    q, k, v, do_c, lse_c, delta = fa._bwd_prepare(q, k, v, o, lse, do, dlse)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    calls = {
        "dq": lambda: fa._bwd_kernel("dq", q, k, v, do_c, lse_c, delta,
                                     (dq,), causal, scale),
        "dkv": lambda: fa._bwd_kernel("dkv", q, k, v, do_c, lse_c, delta,
                                      (dk, dv), causal, scale),
    }
    ms = {n: graph_ms(fn, iters) for n, fn in calls.items()}
    event_ms = {n: cuda_ms(fn, iters) for n, fn in calls.items()}
    prepare_ms = cuda_ms(lambda: fa._bwd_prepare(q, k, v, o, lse, do, dlse),
                         iters)
    return ms, event_ms, prepare_ms


def grad_errs(got, want):
    """max |err| / max |ref| and ||err|| / ||ref|| of each of (dq, dk,
    dv)."""
    out = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        diff = g.float() - w.float()
        out[name] = {
            "max": diff.abs().max().item() / w.float().abs().max().item(),
            "rel": (diff.norm() / w.float().norm()).item()}
    return out


def check_flash_bwd(device, seed):
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(seed + 3)
    results = []
    for (b, h, tq, tk, d, causal, dtype, strided, with_dlse) in \
            BWD_CASES + LONG_BWD_CASES:
        tdtype = getattr(torch, dtype)
        long = tq > 4096

        def make(t):
            x = torch.from_numpy(rng.standard_normal(
                (b, t, h, d)).astype(np.float32))
            x = x.to(device=device, dtype=tdtype).permute(0, 2, 1, 3)
            return x if strided else x.contiguous()

        q, k, v, do = make(tq), make(tk), make(tk), make(tq)
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
        dlse = None
        if with_dlse:
            dlse = torch.from_numpy(rng.standard_normal(
                (b * h, tq)).astype(np.float32)).to(device)
        copies = fa.flash_attention_bwd.copies
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, scale,
                                       dlse)
        torch.cuda.synchronize()
        sliced = dict(rows=(tq - LONG_CHECK_ROWS, tq), keys=LONG_BWD_KEYS,
                      chunk=LONG_BWD_CHUNK) if long else {}

        def plain(dout=do):
            return fa.flash_attention_bwd_plain(q, k, v, o, lse, dout, causal,
                                                scale, dlse, **sliced)

        refs = plain()
        if long:
            rows, keys = sliced["rows"], sliced["keys"]
            grads = (grads[0][:, :, rows[0]:rows[1]],
                     grads[1][:, :, keys[0]:keys[1]],
                     grads[2][:, :, keys[0]:keys[1]])
        errs, ref_max, ok = {}, {}, fa.flash_attention_bwd.copies == copies
        for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
            errs[name] = (g.float() - r.float()).abs().max().item()
            ref_max[name] = r.float().abs().max().item()
            ok &= bool(g.float().isfinite().all()) and \
                errs[name] <= BWD_TOL[dtype] * max(1.0, ref_max[name])
        # the error BWD_TOL holds, in its units
        scaled_err = max(errs[n] / max(1.0, ref_max[n]) for n in errs)
        if causal and tq > tk:     # rows that see no key: dq exactly 0
            ok &= bool((grads[0][:, :, :tq - tk] == 0).all())
        extra = {}
        if long:
            do_fault = do.clone()
            do_fault[:, :, LONG_BWD_FAULT_ROW:LONG_BWD_FAULT_ROW + 64] = 0
            extra = {"checked": sliced,
                     "long_errs": grad_errs(grads, refs),
                     "planted_fault_errs": grad_errs(plain(do_fault), refs)}
            del do_fault
            ok &= all(extra["long_errs"][n][key] <= LONG_BWD_TOL[key]
                      < extra["planted_fault_errs"][n][key]
                      for n in ("dq", "dk", "dv") for key in LONG_BWD_TOL)
        del grads, refs
        # device times from CUDA-graph replay (ms), with the calls as
        # issued timed by events beside them (event_ms), the yardstick of
        # the times before graph replay; no plain timing at 32768 tokens
        iters = 3 if long else 10 if tq * tk >= 512 * 512 else 30
        ms, event_ms, prepare_ms = bwd_kernel_ms(
            q, k, v, o, lse, do, causal, scale, dlse, iters)
        plain_ms = plain_event_ms = None
        if not long:
            plain_ms = graph_ms(plain, iters)
            plain_event_ms = cuda_ms(plain, iters)
        library_ms, library_event_ms = sdpa_bwd_ms(q, k, v, do, causal,
                                                   scale, iters)
        bounds = {n: flash_bound_ms(b, h, tq, tk, d, causal, dtype, n)
                  for n in ("dq", "dkv")}
        row = dict(shape=[b, h, tq, tk, d], causal=causal, dtype=dtype,
                   strided=strided, dlse=with_dlse, max_abs_err=errs,
                   ref_max=ref_max, max_scaled_err=scaled_err, **extra,
                   ms=ms, event_ms=event_ms, prepare_ms=prepare_ms,
                   plain_ms=plain_ms, plain_event_ms=plain_event_ms,
                   library_ms=library_ms, library_event_ms=library_event_ms,
                   bound_ms={n: v[0] for n, v in bounds.items()},
                   bound_by={n: v[1] for n, v in bounds.items()},
                   bound_cuda_core_ms={n: v[2] for n, v in bounds.items()},
                   copies=fa.flash_attention_bwd.copies - copies, ok=ok)
        log("flash bwd case " + json.dumps(row))
        if not ok:
            raise AssertionError(
                f"flash_attention_bwd disagrees with its plain version: "
                f"{row}")
        results.append(row)

    # the autograd Function against autograd of the plain forward
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (2, 4, 96, 64)).astype(np.float32)).to(device) for _ in range(4))
    leaves = [x.requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(
        fa.flash_attention_lse(*leaves, causal=True)[0], leaves, do)
    want = torch.autograd.grad(
        fa.flash_attention_fwd_plain(*leaves, True, 1 / 8.0)[0], leaves, do)
    err = max((g - w).abs().max().item() / max(1.0, w.abs().max().item())
              for g, w in zip(got, want))
    log(f"FlashAttention.apply vs autograd of the plain forward: max "
        f"scaled err {err:.3e}")
    if err > BWD_TOL["float32"]:
        raise AssertionError("FlashAttention's grads disagree with "
                             "autograd of the plain forward")
    return results


# ---------------------------------------------------------------------------
# phase 6: the fc_epilogue kernel against its plain version
# ---------------------------------------------------------------------------

def fc_times(m, k, n, spec, dtype):
    """(bytes ms, operations ms) of act(x.w + bias + residual): x, w,
    bias and residual read once and out written once over HBM; 2*M*K*N
    operations at the card's peak for the input type."""
    elem = 4 if dtype == "float32" else 2
    nbytes = elem * (m * k + k * n + m * n)
    nbytes += elem * n * ("bias" in spec) + elem * m * n * ("residual" in spec)
    return (nbytes / PEAK_BYTES_PER_S * 1e3,
            2.0 * m * k * n / PEAK_FLOPS[dtype] * 1e3)


def fc_bound_ms(m, k, n, spec, dtype):
    t_bytes, t_ops = fc_times(m, k, n, spec, dtype)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def fc_operands(rng, device, m, k, n, spec, dtype):
    """x [M,K] and bias, residual ~ N(0, 1); w [K,N] ~ N(0, 1/K), so the
    outputs are of unit scale at every K."""
    import torch

    def t(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(device,
                                                        getattr(torch, dtype))

    x, w = t((m, k), 1.0), t((k, n), k ** -0.5)
    bias = t((n,), 1.0) if "bias" in spec else None
    res = t((m, n), 1.0) if "residual" in spec else None
    return x, w, bias, res


def fc_err(got, want):
    """max |got - want| / max(1, |want|), in f32."""
    got, want = got.float(), want.float()
    return (got - want).abs().max().item() / max(
        1.0, want.abs().max().item())


def check_fc_epilogue(device, seed):
    """Every fc stage subset (and the tanh gelu) at ragged shapes, f32
    and bf16; the main path's three shapes, held and timed beside the
    plain version and the flag-off chain (cuBLAS product, then each add
    and the act), and torch.addmm (product plus one add in one call);
    the autograd Function's grads against autograd of the chain."""
    import torch

    from paddle_tpu_torch.ops import epilogue as ep

    rng = np.random.RandomState(seed + 4)
    acts = [(s.to_attr(), s.act, False) for s in ep.enumerate_specs("fc")]
    acts += [(a, act, True) for a, act, _ in acts if act == "gelu"]
    worst = {}
    for dtype in ("float32", "bfloat16"):
        for m, k, n in FC_ODD_SHAPES:
            for attr, act, approx in acts:
                x, w, b, r = fc_operands(rng, device, m, k, n, attr, dtype)
                got = ep.fc_epilogue_kernel(x, w, b, r, act, approx)
                torch.cuda.synchronize()
                err = fc_err(got, ep.fc_epilogue_plain(x, w, b, r, act,
                                                       approx))
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                if not (err <= FC_TOL[dtype] and got.dtype == x.dtype):
                    raise AssertionError(
                        f"fc_epilogue disagrees with its plain version: "
                        f"{(m, k, n)} {dtype} {attr!r} approximate="
                        f"{approx}: {err:.3e}")
    log(f"fc_epilogue over {2 * len(FC_ODD_SHAPES) * len(acts)} ragged "
        f"cases: worst scaled err {json.dumps(worst)}")

    rows = []
    m = AMP_BATCH * MODEL["max_len"]
    for name, k, n, attr in FC_MAIN:
        act = ep.EpilogueSpec.from_attr(attr).act
        for dtype in ("float32", "bfloat16"):
            x, w, b, r = fc_operands(rng, device, m, k, n, attr, dtype)
            before = dict(ep.fc_epilogue.launches_by_path)
            got = ep.fc_epilogue_kernel(x, w, b, r, act)
            torch.cuda.synchronize()
            path = next(p for p, c in ep.fc_epilogue.launches_by_path.items()
                        if c != before[p])
            want = ep.fc_epilogue_plain(x, w, b, r, act, False)
            err = fc_err(got, want)
            if err > FC_TOL[dtype]:
                raise AssertionError(f"fc_epilogue disagrees with its plain "
                                     f"version at {name} {dtype}: {err:.3e}")

            def kernel():
                return ep.fc_epilogue_kernel(x, w, b, r, act)

            if dtype == "float32":     # the f32 kernel, off the AMP path
                ms = cuda_ms(kernel, 20)
                log(f"fc_epilogue {name} f32 ({path} path): scaled err "
                    f"{err:.3e}, ms {ms:.4f}")
                continue
            if path != "wgmma":
                raise AssertionError(f"fc_epilogue {name} took the {path} "
                                     "path, not wgmma")
            addend = r if b is None else b
            bound_ms, bound_by = fc_bound_ms(m, k, n, attr, dtype)

            def chain():
                return ep._fc_reference(x, w, b, r, act, False)

            def addmm():
                return torch.addmm(addend, x, w)

            # device times by CUDA-graph replay; event_ms times the calls
            # as issued (how fc_epilogue was timed before graph replay)
            row = dict(
                name=name, shape=[m, k, n], epilogue=attr, dtype=dtype,
                path=path,
                max_abs_err=(got.float() - want.float()).abs().max().item(),
                scaled_err=err, ms=graph_ms(kernel, 50),
                event_ms=cuda_ms(kernel, 50),
                plain_ms=graph_ms(lambda: ep.fc_epilogue_plain(
                    x, w, b, r, act, False), 20),
                chain_ms=graph_ms(chain, 50), chain_event_ms=cuda_ms(chain, 50),
                addmm_ms=graph_ms(addmm, 50), addmm_event_ms=cuda_ms(addmm, 50),
                bound_ms=bound_ms, bound_by=bound_by)
            row["tflops"] = 2.0 * m * k * n / row["ms"] / 1e9
            log("fc_epilogue case " + json.dumps(row))
            rows.append(row)

    # the autograd Function: kernel forward, backward = autograd of the
    # chain, so its grads equal the chain's exactly
    for dtype in ("float32", "bfloat16"):
        x, w, b, r = fc_operands(rng, device, 96, 64, 80, "bias+residual",
                                 dtype)
        g = torch.from_numpy(rng.standard_normal((96, 80)).astype(
            np.float32)).to(device, x.dtype)
        leaves = [t.detach().requires_grad_() for t in (x, w, b, r)]
        got = torch.autograd.grad(ep.fc_epilogue(*leaves, act="gelu"),
                                  leaves, g)
        leaves = [t.detach().requires_grad_() for t in (x, w, b, r)]
        want = torch.autograd.grad(
            ep._fc_reference(*leaves, "gelu", False), leaves, g)
        if not all(torch.equal(a, e) for a, e in zip(got, want)):
            raise AssertionError(f"FcEpilogue's grads ({dtype}) differ "
                                 "from autograd of the chain")
    log("FcEpilogue.apply grads equal autograd of the chain (f32, bf16)")
    return rows


# ---------------------------------------------------------------------------
# phase 8: the conv kernels and bn_apply against their plain versions
# ---------------------------------------------------------------------------

def conv_times(n, h, w, cin, cout, k, s, p, stats=False):
    """(bytes ms, operations ms) of one bf16 conv: the pixels of x that
    its windows touch (a filter narrower than its stride skips the
    rest), w read once and y written once (and the f32 statistics
    partials' worth of two [Cout] vectors) over HBM; 2*M*Cout*K
    operations at the dense bf16 peak."""
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    m, kk = n * oh * ow, k * k * cin
    pixels = n * h * w if k >= s else n * min(h, oh * k) * min(w, ow * k)
    nbytes = 2 * (pixels * cin + cout * kk + m * cout) + 8 * cout * stats
    return (nbytes / PEAK_BYTES_PER_S * 1e3,
            2.0 * m * cout * kk / PEAK_FLOPS["bfloat16"] * 1e3)


def bn_times(m, c, has_res):
    """(bytes ms, operations ms) of bn_apply on bf16 [M, C]: y (and the
    residual) read once, out written once, four f32 [C] vectors; about 6
    operations an element (subtract, multiply, multiply-add, add, max)
    at the f32 rate."""
    nbytes = 2 * m * c * (2 + has_res) + 16 * c
    return (nbytes / PEAK_BYTES_PER_S * 1e3,
            6.0 * m * c / PEAK_FLOPS["float32"] * 1e3)


def bound_of(times):
    t_bytes, t_ops = times
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def resnet_conv_shapes(main):
    """The distinct convs of a built ResNet train program and how often
    each runs a step (forward and again in its grad): {(H, W, Cin, Cout,
    K, stride, pad): count}, and the distinct batch-norm outputs {(OH,
    OW, C, residual, relu): count}.  Shapes are NHWC, batch left out."""
    block = main.global_block()
    convs, bns = {}, {}
    for op in block.ops:
        if op.type not in ("conv2d_bn_train", "conv2d"):
            continue
        _, h, w, cin = block.var(op.inputs["Input"][0]).shape
        cout, _, k, _ = block.var(op.inputs["Filter"][0]).shape
        _, oh, ow, _ = block.var(op.outputs["Output"][0]).shape
        key = (h, w, cin, cout, k, op.attrs["strides"][0],
               op.attrs["paddings"][0])
        convs[key] = convs.get(key, 0) + 2
        bn = (oh, ow, cout, "Residual" in op.inputs,
              op.attrs.get("act") == "relu")
        bns[bn] = bns.get(bn, 0) + 2
    return convs, bns


def scaled_err(got, want):
    """max |got - want| / max(1, |want|), in f32."""
    got, want = got.float(), want.float()
    return (got - want).abs().max().item() / max(
        1.0, want.abs().max().item())


def device_generator(rng, device):
    """A torch generator on ``device`` seeded from ``rng``: a batch-128
    operand is drawn on the card, where numpy's draw of it takes seconds
    of host time."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(int(rng.randint(1 << 30)))
    return g


def conv_operands(rng, device, n, h, w, cin, cout, k, dtype):
    """x ~ N(0, 1) NHWC and w ~ N(0, 1/K) OIHW, so the outputs are of
    unit scale at every K."""
    import torch

    g = device_generator(rng, device)

    def t(shape, scale):
        return (torch.randn(shape, generator=g, device=device) * scale).to(
            getattr(torch, dtype))

    return t((n, h, w, cin), 1.0), t((cout, cin, k, k), (k * k * cin) ** -0.5)


def check_conv_stats(y, s1, s2, ref, dtype):
    """conv_stats' y and its finalised mean and var against the plain
    version's; returns y's max abs error."""
    from paddle_tpu_torch.ops import conv_epilogue as cep

    y_ref, r1, r2 = ref
    m = float(y[..., 0].numel())
    ok = scaled_err(y, y_ref) <= CONV_TOL[dtype]
    for got, want in zip(cep._finalize_stats(s1, s2, m),
                         cep._finalize_stats(r1, r2, m)):
        ok &= scaled_err(got, want) <= STATS_TOL[dtype]
    if not ok:
        raise AssertionError(f"conv_stats disagrees with its plain version "
                             f"at {tuple(y.shape)} {dtype}")
    return (y.float() - y_ref.float()).abs().max().item()


def check_conv_kernels(device, seed, convs):
    """Every conv stage subset at the ragged shapes, f32 and bf16; then
    every distinct conv of the ResNet-50 train step (``convs``) at batch
    RN_BATCH in bf16, held and timed beside the plain version and cuDNN
    (channels-last F.conv2d; for conv_stats followed by torch.sum of y
    and y*y).  Returns one row per shape."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import conv_epilogue as cep
    from paddle_tpu_torch.ops import epilogue as ep

    rng = np.random.RandomState(seed + 5)
    worst = {}
    specs = list(ep.enumerate_specs("conv"))
    for dtype in ("float32", "bfloat16"):
        for n, h, w, cin, cout, k, s, p in CONV_ODD_SHAPES:
            x, wt = conv_operands(rng, device, n, h, w, cin, cout, k, dtype)
            y, s1, s2 = cep.conv_stats_kernel(x, wt, None, (s, s),
                                              ((p, p), (p, p)))
            torch.cuda.synchronize()
            check_conv_stats(y, s1, s2, cep.conv_stats_plain(
                x, wt, None, (s, s), ((p, p), (p, p))), dtype)
            for spec in specs:
                b = torch.randn(cout, device=device).to(x.dtype) \
                    if "bias" in spec else None
                r = torch.randn(y.shape, device=device).to(x.dtype) \
                    if "residual" in spec else None
                args = (x, wt, b, r, (s, s), ((p, p), (p, p)), spec.act)
                got = cep.conv_epilogue_kernel(*args)
                torch.cuda.synchronize()
                err = scaled_err(got, cep.conv_epilogue_plain(*args))
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                if not (err <= CONV_TOL[dtype] and got.dtype == x.dtype):
                    raise AssertionError(
                        f"conv_epilogue disagrees with its plain version: "
                        f"{(n, h, w, cin, cout, k, s, p)} {dtype} "
                        f"{spec.to_attr()!r}: {err:.3e}")
    log(f"conv kernels over {2 * len(CONV_ODD_SHAPES) * (len(specs) + 1)} "
        f"ragged cases: worst scaled err {json.dumps(worst)}")

    rows = []
    for (h, w, cin, cout, k, s, p), count in sorted(convs.items()):
        n = RN_BATCH
        x, wt = conv_operands(rng, device, n, h, w, cin, cout, k,
                              "bfloat16")
        pad = ((p, p), (p, p))
        ep_out = cep.conv_epilogue_kernel(x, wt, None, None, (s, s), pad)
        st_out = cep.conv_stats_kernel(x, wt, None, (s, s), pad)
        torch.cuda.synchronize()
        ref = cep.conv_stats_plain(x, wt, None, (s, s), pad)
        err_ep = scaled_err(ep_out, ref[0])
        if err_ep > CONV_TOL["bfloat16"]:
            raise AssertionError(f"conv_epilogue disagrees with its plain "
                                 f"version at {(n, h, w, cin, cout, k, s, p)}"
                                 f": {err_ep:.3e}")
        err_st = check_conv_stats(*st_out, ref, "bfloat16")
        abs_ep = (ep_out.float() - ref[0].float()).abs().max().item()
        del ref
        xn = x.permute(0, 3, 1, 2)
        w_cl = wt.contiguous(memory_format=torch.channels_last)

        def library_stats():
            yf = F.conv2d(xn, w_cl, stride=s, padding=p).float()
            return torch.sum(yf, dim=(0, 2, 3)), torch.sum(yf * yf,
                                                           dim=(0, 2, 3))

        iters = 10
        calls = {"conv_epilogue": lambda: cep.conv_epilogue_kernel(
                     x, wt, None, None, (s, s), pad),
                 "conv_stats": lambda: cep.conv_stats_kernel(
                     x, wt, None, (s, s), pad)}
        library = {"conv_epilogue": lambda: F.conv2d(xn, w_cl, stride=s,
                                                     padding=p),
                   "conv_stats": library_stats}
        # graph replay times the card; events also time each call's issue
        row = dict(
            shape=[n, h, w, cin, cout, k, s, p], per_step=count,
            max_abs_err={"conv_epilogue": abs_ep, "conv_stats": err_st},
            ms={name: graph_ms(fn, iters) for name, fn in calls.items()},
            event_ms={name: cuda_ms(fn, iters) for name, fn in calls.items()},
            plain_ms={"conv_epilogue": cuda_ms(
                lambda: cep.conv_epilogue_plain(x, wt, None, None, (s, s),
                                                pad), 2, warmup=1),
                "conv_stats": cuda_ms(lambda: cep.conv_stats_plain(
                    x, wt, None, (s, s), pad), 2, warmup=1)},
            library_ms={name: graph_ms(fn, iters)
                        for name, fn in library.items()},
            library_event_ms={name: cuda_ms(fn, iters)
                              for name, fn in library.items()})
        for name, stats in (("conv_epilogue", False), ("conv_stats", True)):
            row.setdefault("bound_ms", {})[name], \
                row.setdefault("bound_by", {})[name] = bound_of(
                    conv_times(n, h, w, cin, cout, k, s, p, stats))
        t_ops = conv_times(n, h, w, cin, cout, k, s, p)[1]
        row["tflops"] = {name: t_ops * PEAK_FLOPS["bfloat16"] / ms / 1e12
                         for name, ms in row["ms"].items()}
        log("conv case " + json.dumps(row))
        rows.append(row)
        del x, wt, ep_out, st_out
    return rows


def check_bn_apply(device, seed, bns):
    """bn_apply at every batch-norm output of the ResNet-50 train step
    (``bns``) at batch RN_BATCH in bf16, with the residual and relu it
    has there, held and timed beside the plain version and
    F.batch_norm (eval mode, the given statistics) + add + relu; f32 and
    ragged C at small shapes.  Returns one row per shape."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import conv_epilogue as cep

    rng = np.random.RandomState(seed + 6)
    gen = device_generator(rng, device)

    def t(shape, dtype="bfloat16"):
        return torch.randn(shape, generator=gen, device=device).to(
            getattr(torch, dtype))

    def vectors(c):
        mean, scale, shift = (t((c,), "float32") for _ in range(3))
        var = t((c,), "float32").abs() + 0.5
        return mean, var, torch.rsqrt(var + 1e-5), scale, shift

    for dtype in ("float32", "bfloat16"):
        for shape in ((2, 5, 4, 24), (2, 3, 3, 13), (2, 7, 7, 64)):
            y, r = t(shape, dtype), t(shape, dtype)
            mean, _, rstd, scale, shift = vectors(shape[-1])
            for res in (None, r):
                for act in ("", "relu"):
                    args = (y, mean, rstd, scale, shift, res, act)
                    got = cep.bn_apply_kernel(*args)
                    torch.cuda.synchronize()
                    err = scaled_err(got, cep.bn_apply_plain(*args))
                    if err > BN_TOL[dtype]:
                        raise AssertionError(
                            f"bn_apply disagrees with its plain version at "
                            f"{shape} {dtype} residual={res is not None} "
                            f"act={act!r}: {err:.3e}")
    rows = []
    for (oh, ow, c, has_res, relu), count in sorted(bns.items()):
        n = RN_BATCH
        y = t((n, oh, ow, c))
        res = t((n, oh, ow, c)) if has_res else None
        mean, var, rstd, scale, shift = vectors(c)
        act = "relu" if relu else ""
        args = (y, mean, rstd, scale, shift, res, act)
        got = cep.bn_apply_kernel(*args)
        torch.cuda.synchronize()
        want = cep.bn_apply_plain(*args)
        err = scaled_err(got, want)
        if err > BN_TOL["bfloat16"]:
            raise AssertionError(f"bn_apply disagrees with its plain version "
                                 f"at {(n, oh, ow, c)}: {err:.3e}")
        yn = y.permute(0, 3, 1, 2)
        rn = None if res is None else res.permute(0, 3, 1, 2)

        def library():
            out = F.batch_norm(yn, mean, var, scale, shift, False, 0.0, 1e-5)
            if rn is not None:
                out = out + rn
            return torch.relu(out) if relu else out

        bound_ms, bound_by = bound_of(bn_times(n * oh * ow, c, has_res))

        def kernel():
            return cep.bn_apply_kernel(*args)

        # device times by CUDA-graph replay (ms), the calls as issued by
        # events beside them (event_ms)
        ms = graph_ms(kernel, 20)
        row = dict(shape=[n, oh, ow, c], residual=has_res, relu=relu,
                   per_step=count,
                   max_abs_err=(got.float() - want.float()).abs().max().item(),
                   ms=ms, event_ms=cuda_ms(kernel, 20),
                   plain_ms=cuda_ms(lambda: cep.bn_apply_plain(*args), 10),
                   library_ms=graph_ms(library, 20),
                   library_event_ms=cuda_ms(library, 20), bound_ms=bound_ms,
                   bound_by=bound_by, bound_share=bound_ms / ms)
        log("bn_apply case " + json.dumps(row))
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# the compiled path: each Executor path's counted steps or batches run a
# second time through CompiledProgram (CUDA graphs), from the same state
# and feeds, and held to the interpreted run
# ---------------------------------------------------------------------------

# per compiled path: its numbers beside the interpreted run's
COMPILED = {}


def timed(fn, n, keep=None):
    """``n`` calls of ``fn``: their results (passed through ``keep``
    after each call's timing: a copy, where the result holds a buffer the
    next call should reuse), and each call's ms by the host clock (ending
    in a synchronise) and by events."""
    import torch

    outs, walls, events = [], [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        events.append(start.elapsed_time(end))
        outs.append(out if keep is None else keep(out))
        del out
    return outs, walls, events


def _f(x):
    """A tensor in f64 on its device, or an array in f32 (f64 kept)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.double()
    x = np.asarray(x)
    return x if x.dtype == np.float64 else x.astype(np.float32)


def _amax(x):
    """max|x| of a tensor or array in the type ``_f`` gives (0 if empty,
    inf where a NaN is)."""
    x = abs(x)
    if x.shape and min(x.shape) == 0:
        return 0.0
    m = float(x.max())
    return m if m == m else math.inf


def max_diff(a, b):
    """The largest |a - b| over two lists of tensors or arrays."""
    return max((_amax(_f(x) - _f(y)) for x, y in zip(a, b)), default=0.0)


def max_abs(a):
    return max((_amax(_f(x)) for x in a), default=0.0)


def hold_to_interpreted(what, groups, another=None):
    """``groups``: {name: (interpreted run a, [other interpreted runs of
    the same work], compiled run c)}, each run a list of tensors or
    arrays.  A path whose interpreted runs are bitwise equal must give
    the same bits compiled.  One whose runs differ (cuDNN's backward and
    the embedding grad sum by atomics) is held, group by group, within
    twice the runs' largest spread, each relative to its group's scale;
    ``another()``, where given, first adds one more interpreted run
    ({name: run}), so that one close pair does not set the bound."""
    def spreads():
        return {n: max(max_diff(a, b) for b in bs)
                for n, (a, bs, _) in groups.items()}

    spread = spreads()
    if any(spread.values()) and another is not None:
        extra = another()
        for n, (_, bs, _) in groups.items():
            bs.append(extra[n])
        spread = spreads()
    scale = {n: max(max_abs(a), 1e-30) for n, (a, _, _) in groups.items()}
    bound = 2.0 * max(spread[n] / scale[n] for n in groups)
    row = {}
    for n, (a, bs, c) in groups.items():
        diff = max_diff(c, a)
        row[n] = {"interpreted_runs": 1 + len(bs),
                  "interpreted_spread": spread[n], "compiled_diff": diff,
                  "scale": scale[n], "bitwise": bound == 0.0}
        if not diff / scale[n] <= bound:
            raise AssertionError(f"compiled {what}: {n} differs from the "
                                 f"interpreted run by more than twice the "
                                 f"interpreted runs' spread: {row[n]}")
    return row


def compiled_window(what, compiled, call, n, want_launches, scope=None,
                    names=(), prepare=None, keep=None):
    """``call`` (one step or batch through ``compiled``) once, which
    builds it (the eager warm-up and the capture); ``prepare()`` where
    given (the state put back, or one more uncounted call); then ``n``
    counted calls.  Each counted
    call must replay the one graph the key captured (no launch counted
    from Python), the replays' launches (the captures' deltas times the
    replays) must equal ``want_launches``, the interpreted run's, and
    each of ``names``' persistables in ``scope`` must keep its
    data_ptr.  Returns the counted calls' results (through ``keep``, as
    ``timed``) and their row."""
    import torch

    call()
    if prepare is not None:
        prepare()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    before, stats0 = compiled.replayed_launches(), compiled.graph_stats()
    ptrs = [scope.find_var(n).get().data_ptr() for n in names]
    outs, walls, events = timed(call, n, keep)
    peak = torch.cuda.max_memory_allocated() / 1e9
    python = kernel_counts()
    after, stats = compiled.replayed_launches(), compiled.graph_stats()
    replayed = {k: after.get(k, 0) - before.get(k, 0) for k in want_launches}
    moved = [nm for nm, p in zip(names, ptrs)
             if scope.find_var(nm).get().data_ptr() != p]
    row = dict(wall_ms=walls, event_ms=events, peak_mem_gb=peak,
               graphs=stats["graphs"], replays=stats["replays"]
               - stats0["replays"], replayed_launches={
                   k: v for k, v in replayed.items() if v},
               persistables_at_fixed_addresses=len(names) - len(moved))
    if any(python.values()) or stats["entries"] != 1 or \
            stats["graphs"] != stats0["graphs"] or row["replays"] != n:
        raise AssertionError(f"compiled {what}: the counted calls did not "
                             f"all replay one captured graph: {row}, "
                             f"launched from Python {python}")
    if replayed != want_launches:
        raise AssertionError(f"compiled {what}: replays launched {replayed}"
                             f", the interpreted run {want_launches}")
    if moved:
        raise AssertionError(f"compiled {what}: persistables moved: "
                             f"{moved[:5]}")
    return outs, row


# profiled pairs (an interpreted call, a replay) taken at most for one path
PROFILE_PAIRS = 5


def profile_pair(what, label, interpreted, compiled, launches):
    """Profiles one interpreted call and one replay (``profile``).  A
    pair holds when the replay shows every kernel function of the port
    that the interpreted call shows and no more of their records than
    ``launches``, the launches the interpreted run counted a call; it is
    exact when the replay shows all ``launches``.  The tracer drops
    records in a long process (six or seven of `infer_convep`'s 53 conv
    launches in every profiled replay; every record of a replay or of an
    interpreted call now and then, from phase 16 on), and none in a
    process of its own: up to PROFILE_PAIRS pairs are taken until
    one is exact, and at least one must hold.  Returns the numbers of the
    pair that holds with the most records, the pairs taken and those
    records."""
    best = None
    for pairs in range(1, PROFILE_PAIRS + 1):
        _, prof = profile(label, interpreted)
        _, cprof = profile(f"compiled {label}", compiled)
        got, seen = cprof["port_calls"], prof["port_calls"]
        if set(got) == set(seen) and sum(got.values()) <= launches:
            if best is None or sum(got.values()) > best[2]:
                best = (prof, cprof, sum(got.values()))
            if best[2] == launches:
                break
    if best is None:
        raise AssertionError(
            f"compiled {what}: in {pairs} profiled pairs no replay ran the "
            f"port's kernels of the interpreted call with no more records "
            f"than its {launches} launches; the last: replay {got}, "
            f"interpreted {seen}")
    return best[0], best[1], pairs, best[2]


def per_call(launches, n):
    """The kernels' launches a call (KERNELS only: no by-path count or
    copy) of counts taken over ``n`` calls."""
    return sum(launches[k] for k in KERNELS) // n


def record_compiled(what, interpreted, compiled, hold, profile_pairs,
                    replay_records):
    """Logs and keeps a compiled path's numbers beside the interpreted
    run's: ms by the host clock and by events (means), the profiled
    call's device busy and idle share and device-to-host copies, peak
    memory, and the hold to the interpreted run."""
    def side(row, prof):
        return {"wall_ms": float(np.mean(row["wall_ms"])),
                "event_ms": float(np.mean(row["event_ms"])),
                "profiled_wall_ms": prof["wall_ms"],
                "profiled_device_ms": prof["device_ms"],
                "device_busy_share": prof["device_busy_share"],
                "device_idle_share": prof["device_idle_share"],
                # one profiled call's wall is one sample: the device's
                # idle share of the window's mean wall beside it
                "device_idle_share_of_mean_wall":
                    1.0 - prof["device_ms"] / float(np.mean(row["wall_ms"])),
                "memcpy_dtoh_ms": prof["memcpy_dtoh_ms"],
                "memcpy_htod_ms": prof["memcpy_htod_ms"],
                "peak_mem_gb": row["peak_mem_gb"]}

    row = {"interpreted": side(*interpreted), "compiled": side(*compiled),
           "graphs": compiled[0]["graphs"],
           "replays": compiled[0]["replays"],
           "replayed_launches": compiled[0]["replayed_launches"],
           "persistables_at_fixed_addresses":
               compiled[0]["persistables_at_fixed_addresses"],
           "vs_interpreted": hold, "profile_pairs": profile_pairs,
           "profiled_replay_port_records": replay_records}
    row["wall_speedup"] = row["interpreted"]["wall_ms"] / \
        row["compiled"]["wall_ms"]
    COMPILED[what] = row
    log(f"compiled {what} " + json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# phase 3: the main path — serving the LM through the Predictor
# ---------------------------------------------------------------------------

def serve(seed, runs, workdir):
    """The LM saved and served: ``runs`` requests interpreted (the
    Predictor's program through Executor.run on its scope: the counted
    launches), then the same requests through ``Predictor.run``, which
    captures the program once and replays it, held to the interpreted
    logits, bitwise or within two interpreted runs' spread.  Returns the
    launches, the numbers and the CPU reference (the first request, its
    CPU logits and the CPU Predictor), which the serving tier reuses."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.transformer import \
        transformer_encoder_model

    t0 = time.perf_counter()
    model = transformer_encoder_model(**MODEL)
    exe = pt.Executor(pt.CUDAPlace(0))
    np.random.seed(seed)
    exe.run(pt.default_startup_program())
    pt.io.save_inference_model(workdir, ["src_ids"], [model["logits"]], exe)
    log(f"model built and saved in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    pred = pt.inference.create_predictor(pt.inference.Config(workdir))
    op_types = sorted({op.type for op in pred._program.global_block().ops})
    log(f"predictor on {pred.device} in {time.perf_counter() - t0:.1f} s; "
        f"op types {op_types}")
    rng = np.random.RandomState(seed + 1)
    shape = (BATCH, MODEL["max_len"], 1)
    requests = [rng.randint(0, MODEL["vocab_size"], shape).astype(np.int64)
                for _ in range(runs)]

    def interpreted(ids):
        return pred._exe.run(pred._program, feed={"src_ids": ids},
                             fetch_list=pred._fetch_vars,
                             scope=pred._scope)[0]

    # the logits (524 MB) lie in page-locked memory from the caching host
    # allocator: each is copied out after its request's timing, so the
    # next request reuses the block, as a client that drops it would
    first = np.array(interpreted(requests[0]))   # warm-up, not counted
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    it = iter(requests)
    outs, times, events = timed(lambda: interpreted(next(it)), runs,
                                np.array)
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = kernel_counts()
    expected = expected_counts(flash_attention_fwd=MODEL["n_layer"] * runs)
    log(f"kernel launches over {runs} requests: {launches}")
    if launches != expected:
        raise AssertionError(f"serving launched {launches}, expected "
                             f"{expected}")

    want = (BATCH, MODEL["max_len"], MODEL["vocab_size"])
    if first.shape != want or not np.isfinite(first).all():
        raise AssertionError(f"logits shape {first.shape} (want {want}) "
                             "or non-finite values")

    cpu_pred = cpu_predictor(workdir)
    t = time.perf_counter()
    cpu_logits, = cpu_pred.run([requests[0]])
    cpu_s = time.perf_counter() - t
    err = float(np.abs(first - cpu_logits).max())
    close = bool(np.allclose(first, cpu_logits, atol=LOGITS_ATOL,
                             rtol=LOGITS_RTOL))
    agree = float((first.argmax(-1) == cpu_logits.argmax(-1)).mean())
    log(f"GPU vs CPU logits: max abs err {err:.3e} (scale "
        f"{float(np.abs(cpu_logits).max()):.3f}), allclose(atol=rtol="
        f"{LOGITS_ATOL}) {close}, argmax agreement {agree:.6f}; "
        f"CPU request {cpu_s:.2f} s")
    if not close or agree < ARGMAX_AGREE:
        raise AssertionError("GPU logits disagree with the CPU run")
    # the serving tier holds its requests' rows to these CPU logits
    reference = {"ids": requests[0], "cpu_logits": cpu_logits,
                 "cpu_pred": cpu_pred}
    del cpu_pred, cpu_logits

    total = sum(times) / 1e3
    tokens = BATCH * MODEL["max_len"]
    serving = dict(requests=runs, batch=BATCH, seq=MODEL["max_len"],
                   request_ms=times, request_event_ms=events,
                   requests_per_s=runs / total,
                   tokens_per_s=runs * tokens / total,
                   logits_max_abs_err_vs_cpu=err, argmax_agreement=agree)
    log("serving " + json.dumps(serving))
    again = np.array(interpreted(requests[0]))

    # the same requests through Predictor.run: one capture, then replays.
    # The Predictor keeps its last outputs (get_output_handle), so its
    # fetches alternate between two page-locked blocks: a second request
    # before the window allocates the second
    it = iter([requests[0]] + requests)
    couts, crow = compiled_window(
        "serving", pred._compiled, lambda: pred.run([next(it)])[0], runs,
        launches, pred._scope,
        [v.name for v in pred._program.persistables() if not v.is_data],
        prepare=lambda: pred.run([requests[0]]), keep=np.array)
    hold = hold_to_interpreted("serving", {"logits": (
        outs, [[again] + outs[1:]], couts)})
    del outs, couts, again
    prof, cprof, pairs, records = profile_pair(
        "serving", "request", lambda: interpreted(requests[0]),
        lambda: pred.run([requests[0]]), per_call(launches, runs))
    serving["compiled"] = record_compiled(
        "serving", (dict(wall_ms=times, event_ms=events, peak_mem_gb=peak),
                    prof), (crow, cprof), hold, pairs, records)
    log("serving request wall and its device-to-host copy (PR 12: 225.18 "
        "ms of a 238.62 ms request, pageable) " + json.dumps({
            side: {k: serving["compiled"][side][k]
                   for k in ("profiled_wall_ms", "memcpy_dtoh_ms")}
            for side in ("interpreted", "compiled")}))
    return launches, serving, reference


def cpu_predictor(workdir):
    import paddle_tpu_torch as pt

    cfg = pt.inference.Config(workdir)
    cfg.disable_gpu()
    return pt.inference.create_predictor(cfg)


# ---------------------------------------------------------------------------
# phase 3b: the serving tier — InferenceServer over two LM replicas
# ---------------------------------------------------------------------------

TIER_BUCKETS = (1, 2, 4, 8)      # default_buckets(8)
TIER_REQUESTS = 32               # round trip: requests of 1-3 rows
TIER_CLIENTS = 4                 # round trip and failover client threads
TIER_LOOP_CLIENTS = 8            # closed-loop client threads
TIER_LOOP_S = 2.0                # closed-loop window
TIER_PROFILE_S = 1.0             # profiled closed-loop window
TIER_OVERLOAD_S = 5.0            # open loop at twice the closed-loop rate
TIER_WARM_S = 2.5                # warm-up under traffic
TIER_DEADLINE_S = 1.0            # ServingConfig's default deadline
TIER_WAIT_S = 120.0              # every other wait's bound
TIER_STRAGGLER_DRAIN_S = 0.005   # a drain shorter than one batch
TIER_CHECK_CHUNK = 1 << 18       # f32 values a bitwise check compares at once


class TierPlacement:
    """Where each request ran: wraps every replica's ``run`` to record,
    for each rider of a batch that ran to its end, (replica index,
    bucket, the program it ran), and for each run (replica index,
    bucket, whether it captured a new key, start, end).  The record is written before the batch is
    delivered, so a client that has its result finds it."""

    def __init__(self, srv):
        import threading

        self.by_request = {}
        self.runs = []
        self._lock = threading.Lock()
        for rep in srv.pool.replicas:
            self.watch(rep)

    def watch(self, rep):
        """Record ``rep``'s runs too (a replica added after the start)."""
        rep.run = self._wrap(rep, rep.run)

    def _wrap(self, rep, run):
        def wrapped(batch):
            program = rep.predictor._program
            compiled = rep.predictor._compiled
            entries = len(compiled._cache)
            t0 = time.perf_counter()
            out = run(batch)
            t1 = time.perf_counter()
            cold = len(compiled._cache) > entries
            with self._lock:
                self.runs.append((rep.index, batch.bucket, cold, t0, t1))
                for req in batch.requests:
                    self.by_request[req.id] = (rep.index, batch.bucket,
                                               program)
            return out
        return wrapped

    def overlaps(self):
        """Captures of one replica that overlapped a replay (waiting for
        the device's lock included) of another."""
        runs = list(self.runs)
        return sum(1 for i, _, cold, a0, a1 in runs if cold
                   for j, _, other_cold, b0, b1 in runs
                   if j != i and not other_cold and a0 < b1 and b0 < a1)


class TierRows:
    """The rows the tier's requests draw from (serve()'s request and as
    many more), their CPU logits (unless ``cpu`` is false), and a lone
    Predictor of each model to hold every answer to, bitwise, at the
    bucket it rode.  A model is known by its program objects (``serves``:
    phase 3b's second LM has the first's program with other weights, so
    one fingerprint), or by its fingerprint (``by_fingerprint``: every
    load of a registry version is one program, and the fleet's versions
    differ in program)."""

    def __init__(self, seed, reference, cpu=True):
        import threading

        ids = reference["ids"]
        more = np.random.RandomState(seed + 7).randint(
            0, MODEL["vocab_size"], ids.shape).astype(np.int64)
        t = time.perf_counter()
        self.ids = np.concatenate([ids, more])
        if cpu:
            cpu_more, = reference["cpu_pred"].run([more])
            self.cpu = np.concatenate([reference["cpu_logits"], cpu_more])
        self.cpu_s = time.perf_counter() - t
        self.lone = {}              # id of a program -> a lone Predictor
        self.by_fingerprint = {}    # a program's fingerprint -> one
        self._lock = threading.Lock()
        self._local = threading.local()
        self.max_err_vs_cpu = 0.0
        self.checked = 0

    def request(self, rng):
        """(row indices, ids) of a request of 1-3 distinct rows."""
        idx = rng.choice(len(self.ids), int(rng.randint(1, 4)),
                         replace=False)
        return idx, self.ids[idx]

    def serves(self, preds, lone):
        """``preds`` serve the model of the Predictor ``lone``."""
        for p in preds:
            self.lone[id(p._program)] = lone

    def lone_run(self, program, ids, bucket):
        from paddle_tpu_torch.core.compiler import program_fingerprint

        lone = self.lone.get(id(program))
        if lone is None:
            lone = self.by_fingerprint[program_fingerprint(program)]
        pad = np.zeros((bucket - len(ids),) + ids.shape[1:], ids.dtype)
        with self._lock:
            out, = lone.run([np.concatenate([ids, pad])])
        return out[:len(ids)]

    def _scratch(self, shape):
        """Two row buffers of this thread: the checks work in place, as
        a fresh 65 MB array a row costs its page faults every time."""
        bufs = getattr(self._local, "bufs", None)
        if bufs is None or bufs[0].shape != shape:
            bufs = self._local.bufs = (np.empty(shape, np.float32),
                                       np.empty(shape, np.float32))
        return bufs

    def _equal(self, a, b):
        """``a - b`` all zero (a NaN is unequal too), a cached chunk at a
        time: a 65 MB difference written and read back would cost each
        check two more passes over memory that the server's fetches
        share."""
        a, b = a.reshape(-1), b.reshape(-1)
        c = getattr(self._local, "chunk", None)
        if c is None:
            c = self._local.chunk = np.empty(TIER_CHECK_CHUNK, np.float32)
        for s in range(0, a.size, len(c)):
            n = min(len(c), a.size - s)
            np.subtract(a[s:s + n], b[s:s + n], out=c[:n])
            if c[:n].any():
                return False
        return True

    def check(self, what, idx, out, placed, cpu=True):
        """``out`` bitwise equal to the lone run of its model at its
        bucket and, for the first model, within the serving bound of the
        CPU's logits (allclose's |a - b| <= atol + rtol |b|), row by
        row."""
        _, bucket, program = placed
        want = self.lone_run(program, self.ids[idx], bucket)
        if out.shape != want.shape:
            raise AssertionError(f"serving tier, {what}: shape {out.shape}"
                                 f", the lone Predictor's {want.shape}")
        err = 0.0
        for j, i in enumerate(idx):
            if not self._equal(out[j], want[j]):
                raise AssertionError(
                    f"serving tier, {what}: row {i} at bucket {bucket} "
                    f"differs from the lone Predictor's by "
                    f"{float(np.abs(out[j] - want[j]).max())}")
            if not cpu:
                continue
            d, tol = self._scratch(out.shape[1:])
            np.subtract(out[j], self.cpu[i], out=d)
            np.abs(d, out=d)
            err = max(err, float(d.max()))
            np.abs(self.cpu[i], out=tol)
            tol *= LOGITS_RTOL
            tol += LOGITS_ATOL
            np.subtract(d, tol, out=d)
            if not d.max() <= 0.0:
                raise AssertionError(
                    f"serving tier, {what}: row {i} is off the CPU's "
                    f"logits by {err:.3e}")
        with self._lock:
            self.max_err_vs_cpu = max(self.max_err_vs_cpu, err)
            self.checked += 1


def tier_clients(n, fn):
    """``fn(k)`` in ``n`` threads; re-raises the first failure."""
    import threading

    errors = []

    def run(k):
        try:
            fn(k)
        except BaseException as e:   # noqa: BLE001 (re-raised below)
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,), daemon=True)
               for k in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=TIER_WAIT_S)
    if any(th.is_alive() for th in threads):
        raise AssertionError("serving tier: a client thread hung")
    if errors:
        raise errors[0]


def tier_stats_delta(srv, before):
    st = srv.batcher.stats()
    return {k: st[k] - before.get(k, 0)
            for k in ("batches", "real_rows", "padded_rows")}


def closed_loop(srv, rows, seconds, seed):
    """TIER_LOOP_CLIENTS clients, each submitting a request of 1-3 rows
    and waiting for its answer, for ``seconds``; each answer's shape and
    first and last positions checked, then dropped.  Returns the
    window's requests/s, rows/s, latency p50/p99 (ms) and the batcher's
    occupancy (real rows over padded rows)."""
    import threading

    lat, nrows, lock = [], [0], threading.Lock()
    before = srv.batcher.stats()
    t_end = time.perf_counter() + seconds

    def client(k):
        rng = np.random.RandomState(seed + k)
        while time.perf_counter() < t_end:
            idx, ids = rows.request(rng)
            t = time.perf_counter()
            out, = srv.submit({"src_ids": ids},
                              deadline_s=TIER_WAIT_S).result(
                timeout=TIER_WAIT_S)
            dt = time.perf_counter() - t
            if out.shape != (len(idx),) + rows.cpu.shape[1:] or \
                    not np.isfinite(out[:, [0, -1]]).all():
                raise AssertionError("serving tier: a malformed answer")
            del out
            with lock:
                lat.append(dt)
                nrows[0] += len(idx)

    t0 = time.perf_counter()
    tier_clients(TIER_LOOP_CLIENTS, client)
    wall = time.perf_counter() - t0
    d = tier_stats_delta(srv, before)
    return {"requests": len(lat), "rows": nrows[0], "wall_s": wall,
            "requests_per_s": len(lat) / wall, "rows_per_s": nrows[0] / wall,
            "p50_ms": _pct([x * 1e3 for x in lat], 50),
            "p99_ms": _pct([x * 1e3 for x in lat], 99),
            "batches": d["batches"],
            "occupancy": d["real_rows"] / max(d["padded_rows"], 1)}


def tier_loop_numbers(srv, rows, seed, what):
    """The closed-loop numbers, then a profiled window: the device's busy
    and idle share of its wall and the top of its device time."""
    row = closed_loop(srv, rows, TIER_LOOP_S, seed)
    _, prof = profile(f"serving tier closed loop, {what}",
                      lambda: closed_loop(srv, rows, TIER_PROFILE_S,
                                          seed + 100))
    row.update(device_idle_share=prof["device_idle_share"],
               device_busy_share=prof["device_busy_share"],
               profiled_device_ms=prof["device_ms"],
               profiled_wall_ms=prof["wall_ms"],
               memcpy_dtoh_ms=prof["memcpy_dtoh_ms"])
    log(f"serving tier closed loop, {what} " + json.dumps(row))
    return row


def rss_gb():
    """The process's resident set now and at its peak (GB)."""
    import resource

    with open("/proc/self/status") as f:
        now = next(int(line.split()[1]) for line in f
                   if line.startswith("VmRSS:"))
    return now / 1e6, resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1e6


def overload(srv, rows, rate_rows, seed, seconds=TIER_OVERLOAD_S,
             what="serving tier overload"):
    """Open loop at twice the closed-loop rate for ``seconds``: requests
    over capacity get the typed OverloadedError at submit, every
    admitted one is answered or expires at its deadline (its latency from
    admission), none dropped silently; the admitted p99 stays under the
    deadline (a scale-up's prewarm captures included: replays do not
    wait for them)."""
    import queue as queue_mod
    import threading

    from paddle_tpu_torch import serving

    mean_rows = 2.0                     # 1-3 rows, uniform
    interval = mean_rows / (2.0 * rate_rows)
    admitted, outcomes = queue_mod.Queue(), {}
    shed = {"overloaded": 0, "other": 0}
    lock = threading.Lock()
    rss0 = rss_gb()
    done = threading.Event()

    def submitter(_):
        rng = np.random.RandomState(seed)
        t0 = time.perf_counter()
        n = 0
        while True:
            t = t0 + n * interval
            if t - t0 >= seconds:
                break
            wait = t - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            idx, ids = rows.request(rng)
            n += 1
            try:
                admitted.put((srv.submit({"src_ids": ids}), len(idx)))
            except serving.OverloadedError:
                shed["overloaded"] += 1
            except serving.ServingError:
                shed["other"] += 1
        done.set()

    lat = []

    def consumer(_):
        while not (done.is_set() and admitted.empty()):
            try:
                req, n = admitted.get(timeout=0.05)
            except queue_mod.Empty:
                continue
            try:
                out, = req.result(timeout=TIER_WAIT_S)
                ok = out.shape[0] == n and \
                    bool(np.isfinite(out[:, [0, -1]]).all())
                kind = "ok" if ok else "malformed"
                del out
            except serving.DeadlineExpiredError:
                kind = "expired"
            except serving.ServingError as e:
                kind = e.code
            with lock:
                outcomes[kind] = outcomes.get(kind, 0) + 1
                lat.append(req.latency_s())

    threads = [threading.Thread(target=submitter, args=(0,), daemon=True)]
    threads += [threading.Thread(target=consumer, args=(k,), daemon=True)
                for k in range(4)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=seconds + TIER_WAIT_S)
    wall = time.perf_counter() - t0
    if any(th.is_alive() for th in threads):
        raise AssertionError(f"{what}: a thread hung")
    st = srv.stats()
    n_adm = sum(outcomes.values())
    p99 = _pct([x * 1e3 for x in lat], 99)
    row = {"offered_rows_per_s": 2.0 * rate_rows,
           "submitted": n_adm + sum(shed.values()), "admitted": n_adm,
           "shed_overloaded": shed["overloaded"], "shed_other": shed["other"],
           "outcomes": outcomes, "admitted_p50_ms": _pct(
               [x * 1e3 for x in lat], 50), "admitted_p99_ms": p99,
           "deadline_ms": TIER_DEADLINE_S * 1e3, "wall_s": wall,
           "accounted": st["accounted"],
           "rss_gb_before": rss0[0], "rss_gb_after": rss_gb()[0],
           "peak_rss_gb": rss_gb()[1]}
    log(f"{what} " + json.dumps(row))
    if not shed["overloaded"] or shed["other"] or \
            set(outcomes) - {"ok", "expired"} or not st["accounted"] or \
            not p99 < TIER_DEADLINE_S * 1e3:
        raise AssertionError(f"{what}: {row}")
    return row


def prewarm(pred, buckets=TIER_BUCKETS):
    """A zeros batch of every bucket through ``pred`` (warm-up and
    capture of each key), as ``InferenceServer.prewarm_buckets`` does."""
    for b in buckets:
        pred.run([np.zeros((b, MODEL["max_len"], 1), np.int64)])


def save_other_lm(workdir, seed, dirname, scale=None, drop=False):
    """The LM of ``workdir`` saved again to ``dirname`` with every weight
    drawn anew from ``seed``: normal, at the mean and spread of the first
    LM's tensor (the layer norms' ones and the biases' zeros stay).  A
    second model of the same program for the swap, made on the host in
    about a second (building and initialising one takes ~15 s).

    ``scale``: the logits go through one more op, ``scale`` by this
    factor, so the saved program is another one (the model registry
    dedupes versions by program fingerprint, which weights do not
    move).  ``drop``: the parameter archive is written without its first
    parameter, so the model registers but cannot load."""
    import torch

    import paddle_tpu_torch as pt

    exe = pt.Executor(pt.CPUPlace())
    rng = np.random.default_rng(seed)
    with pt.scope_guard(pt.Scope()):
        program, feeds, fetches = pt.io.load_inference_model(workdir, exe)
        scope = pt.global_scope()
        for v in program.persistables():
            var = scope.find_var(v.name)
            if v.is_data or var is None or var.get() is None:
                continue
            a = var.get().numpy()
            new = rng.standard_normal(a.shape, dtype=np.float32)
            new *= a.std()
            new += a.mean()
            var.set(torch.from_numpy(new.astype(a.dtype)))
        if scale is not None:
            block = program.global_block()
            logits = fetches[0]
            scaled = block.create_var(name=logits.name + ".scaled",
                                      shape=logits.shape, dtype=logits.dtype)
            block.append_op("scale", {"X": [logits]}, {"Out": [scaled]},
                            {"scale": float(scale)})
            fetches = [scaled]
        pt.io.save_inference_model(dirname, feeds, fetches, exe,
                                   main_program=program)
    if drop:
        path = os.path.join(dirname, "__params__.npz")
        with np.load(path) as archive:
            kept = {n: archive[n] for n in archive.files[1:]}
        np.savez(path, **kept)


def serving_tier(seed, workdir, reference, card):
    """The LM of phase 3 (``workdir``) behind InferenceServer with two
    replicas on the card (ServingConfig(max_batch=8, n_replicas=2,
    prewarm=True)): the round trip, failover through a kill, the closed
    loop at 2 and 1 replicas, overload at twice the rate, a program swap
    and its rollback under traffic, warm-up under traffic, and both
    drains.  Returns the round trip's launches (replays counted from the
    captures) and the numbers."""
    import threading

    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.core import compiler
    from paddle_tpu_torch.distributed import faultinject

    def predictor(d=workdir):
        return pt.inference.create_predictor(pt.inference.Config(d))

    t0 = time.perf_counter()
    lone = predictor()
    prewarm(lone)
    rows = TierRows(seed, reference)
    reps = [predictor(), predictor()]
    rows.serves(reps + [lone], lone)
    cfg = serving.ServingConfig(max_batch=8, n_replicas=2, prewarm=True)
    if cfg.buckets != TIER_BUCKETS:
        raise AssertionError(f"buckets {cfg.buckets}")
    srv = serving.InferenceServer(lambda i: reps[i], cfg).start()
    placed = TierPlacement(srv)
    log(f"serving tier: 3 Predictors loaded and prewarmed over buckets "
        f"{cfg.buckets}, 8 more CPU rows in {rows.cpu_s:.2f} s, "
        f"{time.perf_counter() - t0:.1f} s")
    out = {"card": card, "seconds": {}}
    last = [t0]

    def lap(name):
        now = time.perf_counter()
        out["seconds"][name], last[0] = now - last[0], now

    lap("setup")
    # -- the round trip, its launches counted ---------------------------
    def served(what, idx, ids, cpu=True):
        req = srv.submit({"src_ids": ids}, deadline_s=TIER_WAIT_S)
        got, = req.result(timeout=TIER_WAIT_S)
        rows.check(what, idx, got, placed.by_request[req.id], cpu)
        return req

    torch.cuda.synchronize()
    reset_kernel_counts()
    before = [r._compiled.replayed_launches() for r in reps]
    st0 = srv.batcher.stats()

    def round_trip(k):
        rng = np.random.RandomState(seed + 10 + k)
        for _ in range(TIER_REQUESTS // TIER_CLIENTS):
            served("round trip", *rows.request(rng))

    t = time.perf_counter()
    tier_clients(TIER_CLIENTS, round_trip)
    wall = time.perf_counter() - t
    host = kernel_counts()
    replayed = {}
    for r, b in zip(reps, before):
        for k, v in r._compiled.replayed_launches().items():
            replayed[k] = replayed.get(k, 0) + v - b.get(k, 0)
    launches = {k: host[k] + replayed.get(k, 0) for k in host}
    d = tier_stats_delta(srv, st0)
    by_bucket = {}
    for _, bucket, _, _, _ in placed.runs:
        by_bucket[bucket] = by_bucket.get(bucket, 0) + 1
    st = srv.stats()
    out["round_trip"] = {
        "requests": TIER_REQUESTS, "batches": d["batches"],
        "batches_by_bucket": by_bucket, "wall_s": wall,
        "occupancy": d["real_rows"] / d["padded_rows"],
        "checked_bitwise_vs_lone": rows.checked,
        "max_abs_err_vs_cpu": rows.max_err_vs_cpu,
        "flash_attention_fwd_replays": replayed.get("flash_attention_fwd"),
        "host_launches": {k: v for k, v in host.items() if v}}
    log("serving tier round trip " + json.dumps(out["round_trip"]))
    if launches != expected_counts(
            flash_attention_fwd=MODEL["n_layer"] * d["batches"]) or \
            any(cold for _, _, cold, _, _ in placed.runs):
        raise AssertionError(f"serving tier round trip: launches "
                             f"{launches} over {d['batches']} batches")
    if not st["accounted"] or st["admission"]["answered_ok"] != \
            TIER_REQUESTS or rows.checked != TIER_REQUESTS:
        raise AssertionError(f"serving tier round trip: {st['admission']}")

    lap("round trip")
    # -- failover: a seeded fault plan kills replica 0 mid-batch ---------
    pool = srv.pool
    pool.quiesce_replica(1, timeout=TIER_WAIT_S)
    restarts0 = pool.restarts().get("replica-0", 0)
    st0 = srv.stats()
    plan = faultinject.FaultPlan().on(serving.MSG_INFER, 1, "kill")
    with faultinject.installed(plan) as inj:
        def failover(k):
            rng = np.random.RandomState(seed + 20 + k)
            for _ in range(TIER_REQUESTS // TIER_CLIENTS):
                served("failover", *rows.request(rng), cpu=False)

        th = threading.Thread(target=tier_clients,
                              args=(TIER_CLIENTS, failover), daemon=True)
        th.start()
        t_end = time.perf_counter() + TIER_WAIT_S
        while not inj.log and time.perf_counter() < t_end:
            time.sleep(0.001)
        pool.resume_replica(1)
        th.join(timeout=TIER_WAIT_S)
    st = srv.stats()
    out["failover"] = {
        "fault_log": [list(map(str, e)) for e in inj.log],
        "requeues": st["pool"]["requeues"] - st0["pool"]["requeues"],
        "answered": st["answered"] - st0["answered"],
        "accounted": st["accounted"],
        "replica_0_restarts": pool.restarts().get("replica-0", 0)
        - restarts0, "replica_0_alive": pool.replicas[0].alive}
    log("serving tier failover " + json.dumps(out["failover"]))
    if th.is_alive() or [e[2] for e in inj.log] != ["kill"] or \
            not st["accounted"] or out["failover"]["answered"] != \
            TIER_REQUESTS or out["failover"]["requeues"] < 1 or \
            out["failover"]["replica_0_restarts"] < 1 or \
            not pool.replicas[0].alive:
        raise AssertionError(f"serving tier failover: {out['failover']}")

    lap("failover")
    # -- the closed loop at 2 replicas, then overload at twice its rate --
    out["closed_loop_2"] = tier_loop_numbers(srv, rows, seed + 30,
                                             "2 replicas")
    out["overload"] = overload(srv, rows, out["closed_loop_2"]["rows_per_s"],
                               seed + 40)

    lap("closed loop and overload")
    # -- a program swap under traffic, and its rollback ------------------
    with tempfile.TemporaryDirectory() as other:
        save_other_lm(workdir, seed + 1, other)
        swapped = predictor(other)
    prewarm(swapped)
    rows.serves([swapped], swapped)
    fp = reps[0].program_fingerprint()
    probe_idx = np.arange(2)
    pool.quiesce_replica(1, timeout=TIER_WAIT_S)
    first = srv.submit({"src_ids": rows.ids[probe_idx]},
                       deadline_s=TIER_WAIT_S)
    first_out = first.result(timeout=TIER_WAIT_S)[0].copy()
    pool.resume_replica(1)
    compiles, graphs = compiler._M_COMPILES.total(), \
        reps[0]._compiled.graph_stats()["graphs"]
    stop, by_swapped = threading.Event(), []

    def traffic(k):
        rng = np.random.RandomState(seed + 50 + k)
        while not stop.is_set():
            req = served("swap", *rows.request(rng), cpu=False)
            r, _, program = placed.by_request[req.id]
            if r == 0 and program is swapped._program:
                by_swapped.append(req.id)

    th = threading.Thread(target=tier_clients, args=(TIER_CLIENTS, traffic),
                          daemon=True)
    th.start()
    time.sleep(0.2)
    prior, _ = pool.swap_predictor(0, swapped, timeout=TIER_WAIT_S)
    time.sleep(1.0)
    stop.set()
    th.join(timeout=TIER_WAIT_S)
    pool.swap_predictor(0, prior, timeout=TIER_WAIT_S)
    pool.quiesce_replica(1, timeout=TIER_WAIT_S)
    again = srv.submit({"src_ids": rows.ids[probe_idx]},
                       deadline_s=TIER_WAIT_S)
    again_out = again.result(timeout=TIER_WAIT_S)[0]
    pool.resume_replica(1)
    out["swap"] = {
        "served_by_the_swapped_program": len(by_swapped),
        "fingerprint_restored": reps[0].program_fingerprint() == fp,
        "rollback_bitwise": bool(np.array_equal(again_out, first_out)),
        "models_differ": not np.array_equal(rows.lone_run(
            swapped._program, rows.ids[probe_idx],
            placed.by_request[first.id][1]), first_out),
        "compiles_during": compiler._M_COMPILES.total() - compiles,
        "graphs_during": reps[0]._compiled.graph_stats()["graphs"] - graphs}
    log("serving tier swap " + json.dumps(out["swap"]))
    if th.is_alive() or not out["swap"]["served_by_the_swapped_program"] \
            or not out["swap"]["models_differ"] or \
            not out["swap"]["fingerprint_restored"] or \
            not out["swap"]["rollback_bitwise"] or \
            out["swap"]["compiles_during"] or out["swap"]["graphs_during"] \
            or placed.by_request[again.id][:2] != \
            placed.by_request[first.id][:2] or \
            placed.by_request[first.id][0] != 0:
        raise AssertionError(f"serving tier swap: {out['swap']}")
    del first_out, again_out, swapped, prior

    lap("swap")
    # -- a clean drain with requests in flight ---------------------------
    rng = np.random.RandomState(seed + 60)
    inflight = [srv.submit({"src_ids": rows.request(rng)[1]},
                           deadline_s=TIER_WAIT_S) for _ in range(16)]
    leftovers = srv.stop()
    ok = 0
    for r in inflight:
        r.result(timeout=1)           # raises unless answered with rows
        ok += 1
    st = srv.stats()
    out["clean_drain"] = {"leftovers": leftovers, "answered_ok": ok,
                          "accounted": st["accounted"],
                          "batches_failed": st["pool"]["batches_failed"]}
    log("serving tier clean drain " + json.dumps(out["clean_drain"]))
    if leftovers or ok != 16 or not st["accounted"]:
        raise AssertionError(f"serving tier drain: {out['clean_drain']}")
    del inflight

    lap("clean drain")
    # -- one replica: the closed loop --------------------------------------
    one = serving.InferenceServer(lambda i: reps[0], serving.ServingConfig(
        max_batch=8, n_replicas=1)).start()
    try:
        out["closed_loop_1"] = tier_loop_numbers(one, rows, seed + 70,
                                                 "1 replica")
    finally:
        one.stop()

    lap("one replica")
    # -- warm-up under traffic: two cold replicas, no prewarm -------------
    cold = [predictor(), predictor()]
    rows.serves(cold, lone)
    caps0 = len(compiled_captures())
    srv2 = serving.InferenceServer(lambda i: cold[i], serving.ServingConfig(
        max_batch=8, n_replicas=2, prewarm=False)).start()
    placed2 = TierPlacement(srv2)
    t_start = time.perf_counter()

    def warm_traffic(k):
        """Clients 0-1 send one row (buckets 1 and 2 first) and check
        each answer's shape, so the replays keep coming; clients 2-5
        join later with 1-3 rows, which open buckets 4 and 8, and hold
        each answer to the lone run, bitwise."""
        rng = np.random.RandomState(seed + 80 + k)
        if k >= 2:
            time.sleep(0.3)
        t_end = t_start + TIER_WARM_S
        while time.perf_counter() < t_end:
            if k >= 2:
                idx, ids = rows.request(rng)
            else:
                idx = rng.randint(0, len(rows.ids), 1)
                ids = rows.ids[idx]
            req = srv2.submit({"src_ids": ids}, deadline_s=TIER_WAIT_S)
            got, = req.result(timeout=TIER_WAIT_S)
            if k >= 2:
                rows.check("warm-up under traffic", idx, got,
                           placed2.by_request[req.id], cpu=False)
            elif got.shape != (1,) + rows.cpu.shape[1:] or \
                    not np.isfinite(got[:, [0, -1]]).all():
                raise AssertionError("serving tier: a malformed answer")

    try:
        tier_clients(6, warm_traffic)
    finally:
        leftovers = srv2.stop()
    st = srv2.stats()
    out["warm_up_under_traffic"] = {
        "captures": sum(1 for r in placed2.runs if r[2]),
        "replays": sum(1 for r in placed2.runs if not r[2]),
        "captures_overlapping_a_replay": placed2.overlaps(),
        "capture_windows": captures_since(caps0),
        "batches_failed": st["pool"]["batches_failed"],
        "requeues": st["pool"]["requeues"],
        "answered_ok": st["admission"]["answered_ok"],
        "accounted": st["accounted"], "leftovers": leftovers,
        "entries": [len(p._compiled._cache) for p in cold]}
    log("serving tier warm-up under traffic "
        + json.dumps(out["warm_up_under_traffic"]))
    w = out["warm_up_under_traffic"]
    if w["batches_failed"] or w["requeues"] or not w["accounted"] or \
            leftovers or not w["captures_overlapping_a_replay"] or \
            w["answered_ok"] != st["admission"]["admitted"]:
        raise AssertionError(f"serving tier warm-up under traffic: {w}")
    del cold, srv2

    lap("warm-up under traffic")
    # -- a drain shorter than a batch: the stragglers get ShutdownError ---
    srv3 = serving.InferenceServer(lambda i: reps[i], serving.ServingConfig(
        max_batch=8, n_replicas=2)).start()
    inflight = [srv3.submit({"src_ids": rows.request(rng)[1]},
                            deadline_s=TIER_WAIT_S) for _ in range(16)]
    leftovers = srv3.stop(drain_timeout=TIER_STRAGGLER_DRAIN_S)
    kinds = {"ok": 0, "shutdown": 0}
    for r in inflight:
        try:
            r.result(timeout=TIER_WAIT_S)
            kinds["ok"] += 1
        except serving.ShutdownError:
            kinds["shutdown"] += 1
    out["straggler_drain"] = dict(kinds, leftovers=leftovers,
                                  drain_timeout_s=TIER_STRAGGLER_DRAIN_S,
                                  accounted=srv3.stats()["accounted"])
    log("serving tier straggler drain " + json.dumps(out["straggler_drain"]))
    if not leftovers or kinds["shutdown"] != leftovers or \
            kinds["ok"] + kinds["shutdown"] != 16 or \
            not out["straggler_drain"]["accounted"]:
        raise AssertionError(f"serving tier drain: {out['straggler_drain']}")
    del inflight, reps, lone, rows
    lap("straggler drain")
    log("serving tier seconds " + json.dumps(out["seconds"]))
    log("serving tier numbers " + json.dumps({
        "card": card, **{f"{n} replica{'s' if n > 1 else ''}": {
            k: out[f"closed_loop_{n}"][k] for k in (
                "requests_per_s", "rows_per_s", "p50_ms", "p99_ms",
                "occupancy", "device_idle_share")} for n in (1, 2)},
        "overload": {k: out["overload"][k] for k in (
            "offered_rows_per_s", "admitted", "shed_overloaded",
            "admitted_p99_ms", "peak_rss_gb")}}))
    return launches, out


# ---------------------------------------------------------------------------
# phase 3c: the fleet — ModelRegistry, RolloutController, SLOAutoscaler
# ---------------------------------------------------------------------------

FLEET_LEAD_S = 2.0               # traffic before the rollout
FLEET_AFTER_S = 0.5              # traffic after it converged
FLEET_FAIL_S = 0.5               # traffic around the failed prewarm
FLEET_OVERLOAD_S = 3.0           # twice the 1-replica rate, for the up
FLEET_DOWN_WAIT_S = 20.0         # the quiet trickle's bound, for the down
FLEET_SLO_WINDOW_S = 2.0         # fleet_availability's slow window
FLEET_TICK_S = 0.25              # the autoscaler's interval (its default)


class FleetTraffic:
    """TIER_CLIENTS client threads sending requests of 1-3 rows (or one
    sequential request at a time, ``clients=1``) until stopped: each
    answer held bitwise to the lone Predictor of the program that served
    it, at its bucket (``TierPlacement``, ``TierRows``), and recorded as
    (submitted, latency s, the serving program's fingerprint)."""

    def __init__(self, srv, rows, placed, seed, what, clients=TIER_CLIENTS):
        import threading

        from paddle_tpu_torch.core.compiler import program_fingerprint

        self.records, self._lock = [], threading.Lock()
        self._stop = threading.Event()

        def client(k):
            rng = np.random.RandomState(seed + k)
            while not self._stop.is_set():
                idx, ids = rows.request(rng)
                t = time.perf_counter()
                req = srv.submit({"src_ids": ids}, deadline_s=TIER_WAIT_S)
                got, = req.result(timeout=TIER_WAIT_S)
                dt = time.perf_counter() - t
                where = placed.by_request[req.id]
                rows.check(what, idx, got, where, cpu=False)
                del got
                with self._lock:
                    self.records.append(
                        (t, dt, program_fingerprint(where[2])))

        self._error = None

        def run():
            try:
                tier_clients(clients, client)
            except BaseException as e:   # noqa: BLE001 (raised by stop)
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self):
        """Stops the clients; re-raises the first client's failure."""
        self._stop.set()
        self._thread.join(timeout=TIER_WAIT_S)
        if self._thread.is_alive():
            raise AssertionError("the fleet: a client thread hung")
        if self._error is not None:
            raise self._error
        return list(self.records)


def fleet_latency(records, t0, t1):
    """Requests submitted in [t0, t1): count, p50, p99 and the largest
    (ms)."""
    lat = [dt * 1e3 for t, dt, _ in records if t0 <= t < t1]
    return {"requests": len(lat), "p50_ms": _pct(lat, 50),
            "p99_ms": _pct(lat, 99), "max_ms": max(lat, default=None)}


def compiled_captures():
    """The compiled path's record of its warm-up-and-capture windows on
    the card: (seconds, the compiled runs that ended inside) each."""
    import torch

    from paddle_tpu_torch.core import compiler

    return compiler._device_lock(torch.device("cuda", 0)).captures


def captures_since(n0):
    """The windows recorded after the first ``n0``: their count, each
    one's ms and the runs (other instances' replays) that ended inside
    each, and those runs' sum."""
    caps = list(compiled_captures())[n0:]
    return {"captures": len(caps),
            "capture_ms": [s * 1e3 for s, _ in caps],
            "runs_ended_in_each": [n for _, n in caps],
            "runs_ended_in_captures": sum(n for _, n in caps)}


def fleet(seed, workdir, reference, card, tier):
    """Phase 3c: the LM of phase 3 (``workdir``, v1) and two programs made
    from it (v2: new weights and a scale(1.0) on the logits; v3: another
    scale and a parameter left out of its archive) in a ModelRegistry,
    with ir_verify "on" for the registrations and the prewarms; a rolling
    rollout v1 -> v2 of a 2-replica server under four clients and a kill,
    a rollback on burn, a failed prewarm, and the SLO autoscaler over a
    1-replica server on v2 (``tier``: phase 3b's numbers).  Returns the
    rollout window's launches (replays counted from the captures) and the
    numbers."""
    import gc

    import torch

    import paddle_tpu_torch as pt

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = {"card": card, "seconds": {}}
    last = [t0]

    def lap(name):
        now = time.perf_counter()
        out["seconds"][name], last[0] = now - last[0], now

    pt.set_flags({"ir_verify": "on"})
    try:
        with tempfile.TemporaryDirectory() as root:
            launches = _fleet(seed, workdir, reference, tier, root, out, lap)
    finally:
        pt.set_flags({"ir_verify": "off"})
    gc.collect()
    torch.cuda.synchronize()
    out["seconds"]["phase"] = time.perf_counter() - t0
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    log("the fleet seconds " + json.dumps(out["seconds"]))
    log("the fleet numbers " + json.dumps({
        "card": card, "rollout_wall_s": out["rollout"]["wall_s"],
        "swap_s": out["rollout"]["swap_s"],
        "before": out["rollout"]["before"], "during": out["rollout"]["during"],
        "runs_ended_in_rollout_captures": out["rollout"]["prewarm_captures"][
            "runs_ended_in_captures"],
        "overload_admitted_p99_ms": out["autoscale"]["overload"][
            "admitted_p99_ms"],
        "overload_to_up_s": out["autoscale"]["overload_to_up_s"],
        "overload_to_replica_s": out["autoscale"]["overload_to_replica_s"],
        "phase_s": out["seconds"]["phase"],
        "peak_mem_gb": out["peak_mem_gb"]}))
    return launches, out


def _fleet(seed, workdir, reference, tier, root, out, lap):
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.analysis import verify
    from paddle_tpu_torch.core import compiler
    from paddle_tpu_torch.distributed import faultinject
    from paddle_tpu_torch.observability import slo

    # -- the registry: three versions, one program each ------------------
    d2, d3 = os.path.join(root, "lm_v2"), os.path.join(root, "lm_v3")
    save_other_lm(workdir, seed + 2, d2, scale=1.0)
    save_other_lm(workdir, seed + 3, d3, scale=0.5, drop=True)
    reg = serving.ModelRegistry(root=os.path.join(root, "registry"))
    v1, v2, v3 = (reg.register("lm", d) for d in (workdir, d2, d3))
    reps = [v1.make_predictor(), v1.make_predictor()]
    lone1 = v1.prewarm(buckets=TIER_BUCKETS)
    lone2 = v2.prewarm(buckets=TIER_BUCKETS)
    diags = verify(lone1._program)
    out["registry"] = {
        "versions": [v.version for v in reg.versions("lm")],
        "replica_fingerprints_equal": len(
            {p.program_fingerprint() for p in reps}) == 1,
        "equal_to_prewarm": reps[0].program_fingerprint()
        == v1.serving_fingerprint,
        "versions_differ": v1.serving_fingerprint != v2.serving_fingerprint,
        "verify_errors": [str(d) for d in diags if d.severity == "error"],
        "verify_warnings": sum(d.severity != "error" for d in diags),
        "ir_verify": pt.get_flag("ir_verify")}
    log("the fleet registry " + json.dumps(out["registry"]))
    r = out["registry"]
    if r["versions"] != [1, 2, 3] or not r["replica_fingerprints_equal"] \
            or not r["equal_to_prewarm"] or not r["versions_differ"] or \
            r["verify_errors"] or not v1.prewarmed or not v2.prewarmed:
        raise AssertionError(f"the fleet registry: {r}")
    rows = TierRows(seed, reference, cpu=False)
    rows.by_fingerprint = {v1.serving_fingerprint: lone1,
                           v2.serving_fingerprint: lone2}
    srv = serving.InferenceServer(lambda i: reps[i], serving.ServingConfig(
        max_batch=8, n_replicas=2, restart_dead=True, prewarm=True)).start()
    placed = TierPlacement(srv)
    pool = srv.pool
    swap_s = []
    real_swap = pool.swap_predictor

    def timed_swap(*args, **kwargs):
        t = time.perf_counter()
        try:
            return real_swap(*args, **kwargs)
        finally:
            swap_s.append(time.perf_counter() - t)

    pool.swap_predictor = timed_swap
    lap("setup")

    # -- the rollout v1 -> v2 under traffic, a replica killed mid-way -----
    plan = faultinject.FaultPlan(seed=seed).on(serving.MSG_INFER, 0, "kill")

    class KillAfterFirstSwap:
        """The rollout's monitor: at its first poll (after the first swap)
        installs the plan and waits for the kill; nothing fires."""

        def __init__(self):
            self.inj = None

        def observe(self):
            if self.inj is None:
                self.inj = faultinject.install(plan)
                t_end = time.perf_counter() + TIER_WAIT_S
                while not self.inj.log and time.perf_counter() < t_end:
                    time.sleep(0.001)
            return {}

        def firing(self):
            return []

    torch.cuda.synchronize()
    runs0 = len(placed.runs)
    served = {id(p._compiled): p._compiled for p in reps}
    replays0 = {k: c.replayed_launches() for k, c in served.items()}
    st0 = srv.stats()
    traffic = FleetTraffic(srv, rows, placed, seed + 200, "the fleet rollout")
    time.sleep(FLEET_LEAD_S)
    mon = KillAfterFirstSwap()
    reset_kernel_counts()
    caps0 = len(compiled_captures())
    t_roll = time.perf_counter()
    try:
        res = serving.RolloutController(srv, reg, monitor=mon).rollout(
            "lm", 2)
    finally:
        faultinject.uninstall()
    t_done = time.perf_counter()
    host = kernel_counts()
    prewarms = captures_since(caps0)
    time.sleep(FLEET_AFTER_S)
    records = traffic.stop()
    t_end = time.perf_counter() + TIER_WAIT_S
    while not all(r.alive for r in pool.replicas) and \
            time.perf_counter() < t_end:
        time.sleep(0.01)
    torch.cuda.synchronize()
    for rep in pool.replicas:
        served.setdefault(id(rep.predictor._compiled), rep.predictor._compiled)
    replayed = {}
    for k, c in served.items():
        for name, v in c.replayed_launches().items():
            replayed[name] = replayed.get(name, 0) + v - \
                replays0.get(k, {}).get(name, 0)
    launches = {k: host[k] + replayed.get(k, 0) for k in host}
    runs = placed.runs[runs0:]
    st = srv.stats()
    by_version = {v: sum(1 for *_, fp in records if fp == f)
                  for v, f in (("v1", v1.serving_fingerprint),
                               ("v2", v2.serving_fingerprint))}
    out["rollout"] = {
        **res.to_dict(), "swap_s": list(swap_s),
        "kill_log": [list(map(str, e)) for e in mon.inj.log],
        "requeues": st["pool"]["requeues"] - st0["pool"]["requeues"],
        "relaunches": sum(pool.restarts().values()),
        "replica_fingerprints": sorted(
            str(r.predictor.program_fingerprint()) for r in pool.replicas),
        "all_on_v2": all(r.predictor.program_fingerprint()
                         == v2.serving_fingerprint and r.version is v2
                         for r in pool.replicas if r.alive),
        "answers_by_version": by_version, "checked_bitwise": len(records),
        "batches": len(runs), "captures": sum(1 for r in runs if r[2]),
        "flash_attention_fwd_replays": replayed.get("flash_attention_fwd"),
        "host_launches": {k: v for k, v in host.items() if v},
        "accounted": st["accounted"], "outstanding": st["outstanding"],
        "model_version": st["model_version"],
        "before": fleet_latency(records, 0.0, t_roll),
        "during": fleet_latency(records, t_roll, t_done),
        "prewarm_captures": prewarms}
    log("the fleet rollout " + json.dumps(out["rollout"]))
    ro = out["rollout"]
    if not prewarms["captures"] or not prewarms["runs_ended_in_captures"]:
        raise AssertionError(f"the fleet rollout: no replay ended while the "
                             f"prewarms captured: {prewarms}")
    if not res.converged or [e[2] for e in ro["kill_log"]] != ["kill"] or \
            ro["requeues"] < 1 or not ro["all_on_v2"] or \
            not all(r.alive for r in pool.replicas) or \
            not by_version["v1"] or not by_version["v2"] or \
            ro["captures"] or replayed.get("flash_attention_fwd") != \
            MODEL["n_layer"] * len(runs) or launches[COPIES] or \
            not st["accounted"] or \
            st["outstanding"] or ro["model_version"] != "lm@v2":
        raise AssertionError(f"the fleet rollout: {ro}")
    lap("rollout")

    # -- a rollback on burn: v1 again, the monitor firing after one swap --
    class FireAfterFirstSwap:
        def __init__(self):
            self.polls = 0

        def observe(self):
            self.polls += 1
            return {}

        def firing(self):
            return ["fleet_availability"] if self.polls >= 1 else []

    first = pool.replicas[0].index
    fps = {r.index: r.predictor.program_fingerprint() for r in pool.replicas}
    probe_before, where_before = probe_replica(srv, placed, rows, first)
    swap_s.clear()
    res = serving.RolloutController(srv, reg, monitor=FireAfterFirstSwap()) \
        .rollout("lm", 1)
    compiles = compiler._M_COMPILES.total()
    probe_after, where_after = probe_replica(srv, placed, rows, first)
    out["rollback"] = {
        **res.to_dict(), "swap_s": list(swap_s),
        "fingerprints_restored": {r.index: r.predictor.program_fingerprint()
                                  for r in pool.replicas} == fps,
        "probe_bitwise": bool(np.array_equal(probe_after, probe_before)),
        "probe_replica": [where_before[0], where_after[0]],
        "compiles_after_rollout": compiler._M_COMPILES.total() - compiles}
    log("the fleet rollback " + json.dumps(out["rollback"]))
    rb = out["rollback"]
    if res.status != "rolled_back" or res.swapped != 1 or \
            res.rolled_back != 1 or not rb["fingerprints_restored"] or \
            not rb["probe_bitwise"] or rb["probe_replica"] != [first, first] \
            or rb["compiles_after_rollout"]:
        raise AssertionError(f"the fleet rollback: {rb}")
    del probe_before, probe_after
    lap("rollback")

    # -- a failed prewarm: v3 lacks a parameter ---------------------------
    traffic = FleetTraffic(srv, rows, placed, seed + 300,
                           "the fleet failed prewarm", clients=2)
    time.sleep(FLEET_FAIL_S / 2)
    rc = serving.RolloutController(srv, reg)
    try:
        rc.rollout("lm", 3)
    except serving.PrewarmFailedError as e:
        error = {"code": e.code, "message": str(e)[:300]}
    else:
        raise AssertionError("the fleet: v3's rollout did not fail")
    time.sleep(FLEET_FAIL_S / 2)
    records = traffic.stop()
    out["prewarm_failure"] = {
        **error, "state": rc.state,
        "fingerprints_unchanged": {
            r.index: r.predictor.program_fingerprint()
            for r in pool.replicas} == fps,
        "answered_during": len(records),
        "accounted": srv.stats()["accounted"]}
    log("the fleet prewarm failure " + json.dumps(out["prewarm_failure"]))
    pf = out["prewarm_failure"]
    if pf["code"] != "prewarm_failed" or "lm@v3" not in pf["message"] or \
            pf["state"] != "idle" or not pf["fingerprints_unchanged"] or \
            not pf["answered_during"] or not pf["accounted"]:
        raise AssertionError(f"the fleet prewarm failure: {pf}")
    leftovers = srv.stop()
    if leftovers:
        raise AssertionError(f"the fleet: {leftovers} left at stop")
    one = pool.replicas[0].predictor          # a v2 Predictor, prewarmed
    del srv, reps, placed, pool, real_swap
    lap("prewarm failure")

    # -- the autoscaler: overload scales up, a quiet trickle down ---------
    srv = serving.InferenceServer(lambda i: one, serving.ServingConfig(
        max_batch=8, n_replicas=1, prewarm=True)).start()
    srv.model_version = v2
    placed = TierPlacement(srv)
    added = []
    real_add = srv.pool.add_replica

    def add_replica(*args, **kwargs):
        idx = real_add(*args, **kwargs)
        added.append((time.monotonic(), idx))
        return idx

    srv.pool.add_replica = add_replica
    mon = slo.SLOMonitor(slos=[slo.fleet_availability(
        objective=0.99, window_s=FLEET_SLO_WINDOW_S, fast_fraction=0.5)])
    sc = serving.SLOAutoscaler(
        srv, mon, slo="fleet_availability", min_replicas=1, max_replicas=2,
        up_consecutive=2, down_consecutive=4, cooldown_s=0.4)
    mon.observe()
    sc.start(interval_s=FLEET_TICK_S)
    rate = tier["closed_loop_1"]["rows_per_s"]
    t_over = time.monotonic()
    caps0 = len(compiled_captures())
    row = overload(srv, rows, rate, seed + 400, seconds=FLEET_OVERLOAD_S,
                   what="the fleet overload")
    t_over_end = time.monotonic()
    # an up records its event once the replica it prewarms is added,
    # which can be after the overload that decided it
    t_end = t_over_end + TIER_WAIT_S
    while not [d for _, d, _ in sc.scale_events() if d == "up"] and \
            time.monotonic() < t_end:
        time.sleep(0.01)
    up_captures = captures_since(caps0)
    ups = [t for t, d, _ in sc.scale_events() if d == "up" and t < t_over_end]
    downs = [t for t, d, _ in sc.scale_events() if d == "down"]
    if not added or not ups or [t for t in downs if t < t_over_end]:
        raise AssertionError(f"the fleet autoscaler under overload: events "
                             f"{sc.scale_events()}, added {added}")
    new = srv.pool.replica(added[0][1])
    placed.watch(new)
    got, where = probe_replica(srv, placed, rows, new.index)
    rows.check("the fleet scale-up", np.arange(2), got, where, cpu=False)
    new_ok = new.version is v2 and where[0] == new.index and \
        new.predictor.program_fingerprint() == v2.serving_fingerprint
    del got
    trickle = FleetTraffic(srv, rows, placed, seed + 500,
                           "the fleet quiet trickle", clients=1)
    t_end = time.monotonic() + FLEET_DOWN_WAIT_S
    while not [d for _, d, _ in sc.scale_events() if d == "down"] and \
            time.monotonic() < t_end:
        time.sleep(0.05)
    t_down = time.monotonic()
    time.sleep(0.2)
    records = trickle.stop()
    sc.stop()
    st = srv.stats()
    leftovers = srv.stop()
    out["autoscale"] = {
        "offered_rows_per_s": 2.0 * rate, "overload": {
            k: row[k] for k in ("submitted", "admitted", "shed_overloaded",
                                "outcomes", "admitted_p50_ms",
                                "admitted_p99_ms", "accounted")},
        "events": [[t - t_over, d, n] for t, d, n in sc.scale_events()],
        "overload_to_up_s": ups[0] - t_over,
        "overload_to_replica_s": added[0][0] - t_over,
        "overload_s": t_over_end - t_over,
        "down_after_overload_s": t_down - t_over_end,
        "up_prewarm_captures": up_captures,
        "added_serves_v2_bitwise": new_ok,
        "trickle_answered": len(records), "accounted": st["accounted"],
        "outstanding": st["outstanding"], "leftovers": leftovers,
        "replicas": len(srv.pool.replicas)}
    log("the fleet autoscaler " + json.dumps(out["autoscale"]))
    a = out["autoscale"]
    if not new_ok or [d for _, d, _ in a["events"]].count("down") != 1 or \
            a["replicas"] != 1 or not a["trickle_answered"] or \
            not st["accounted"] or st["outstanding"] or leftovers:
        raise AssertionError(f"the fleet autoscaler: {a}")
    lap("autoscale")
    return launches


def probe_replica(srv, placed, rows, index):
    """Rows 0-1 through replica ``index`` alone (the others quiesced);
    returns (the answer, where it ran)."""
    pool = srv.pool
    others = [r.index for r in pool.replicas if r.index != index]
    for i in others:
        pool.quiesce_replica(i, timeout=TIER_WAIT_S)
    try:
        req = srv.submit({"src_ids": rows.ids[:2]}, deadline_s=TIER_WAIT_S)
        got = req.result(timeout=TIER_WAIT_S)[0].copy()
    finally:
        for i in others:
            pool.resume_replica(i)
    return got, placed.by_request[req.id]


# ---------------------------------------------------------------------------
# phase 3d: the serving tier's observability — the /metrics exporter on
# both servers, DeviceTraceSession and the Fluid profiler (a process of
# its own: torch.profiler drops graph-replay records in a long process)
# ---------------------------------------------------------------------------

OBS_REQUESTS = 32             # the exporter's requests of 1-3 rows
OBS_CLIENTS = 4               # their client threads
OBS_SCRAPE_GAP_S = 0.02       # between /metrics scrapes under that load
OBS_DECODE_REQUESTS = 8       # the DecodeServer's requests
OBS_TRACED = 16               # lone Predictor requests in the session
OBS_TRACE_BATCH = 1           # their rows (logits of 65.5 MB each)
OBS_LATENCY_REQUESTS = 200    # requests a tracing setting is timed over
OBS_KERNEL_TOL = 0.25         # joined flash seconds vs an event-timed launch
OBS_KERNEL_LAUNCHES = 50      # event-timed flash launches (median)


def _get(url):
    import urllib.request

    t = time.perf_counter()
    body = urllib.request.urlopen(url, timeout=30).read().decode()
    return body, (time.perf_counter() - t) * 1e3


def _series(samples, name, key):
    return {labels.get(key): value for n, labels, value in samples
            if n == name}


def save_lm(seed, workdir):
    """Phase 3's LM (MODEL, weights from ``seed``) saved into
    ``workdir``, built in fresh programs."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core.program import Program
    from paddle_tpu_torch.models.transformer import \
        transformer_encoder_model

    framework.switch_main_program(Program())
    framework.switch_startup_program(Program())
    model = transformer_encoder_model(**MODEL)
    exe = pt.Executor(pt.CUDAPlace(0))
    np.random.seed(seed)
    exe.run(pt.default_startup_program())
    pt.io.save_inference_model(workdir, ["src_ids"], [model["logits"]], exe)


def obs_exporter(seed, workdir):
    """InferenceServer over two LM replicas with metrics_port=0 and
    tracing at sample 1.0: OBS_REQUESTS requests of 1-3 rows from
    OBS_CLIENTS threads while /metrics is scraped and timed; the
    scrape's admission counters and request histogram equal stats(), the
    p99 bucket's exemplar is a trace /tracez holds, /healthz ok, /sloz
    parses, /fleetz disabled, and the exporter is gone after stop().  A
    DeviceTraceSession around the traffic joins as many flash slices as
    the replicas' replays launched, on the replicas' own threads."""
    import threading

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.observability import device_trace, tracing
    from paddle_tpu_torch.observability.export import parse_prometheus_text

    tracing.start_tracing(sample=1.0)
    srv = serving.InferenceServer(
        lambda i: pt.inference.create_predictor(
            pt.inference.Config(workdir)),
        serving.ServingConfig(max_batch=8, n_replicas=2, prewarm=True,
                              metrics_port=0, trace_sample=1.0)).start()
    url = srv.metrics_server.url
    before = parse_prometheus_text(_get(url + "/metrics")[0])
    done = threading.Event()
    vocab, seq = MODEL["vocab_size"], MODEL["max_len"]

    def client(k):
        rng = np.random.RandomState(seed + 300 + k)
        for _ in range(OBS_REQUESTS // OBS_CLIENTS):
            ids = rng.randint(0, vocab, (int(rng.randint(1, 4)), seq, 1))
            out, = srv.submit({"src_ids": ids}, deadline_s=TIER_WAIT_S
                              ).result(timeout=TIER_WAIT_S)
            if out.shape != (len(ids), seq, vocab):
                raise AssertionError(f"observability: answer {out.shape}")

    scrape_ms = []

    def scraper():
        while not done.is_set():
            text, ms = _get(url + "/metrics")
            parse_prometheus_text(text, with_exemplars=True)
            scrape_ms.append(ms)
            time.sleep(OBS_SCRAPE_GAP_S)

    def replays():
        return sum(r.predictor._compiled.replayed_launches().get(
            "flash_attention_fwd", 0) for r in srv.pool.replicas)

    base = replays()
    th = threading.Thread(target=scraper, daemon=True)
    with tempfile.TemporaryDirectory() as logdir:
        sess = device_trace.DeviceTraceSession(logdir).start()
        th.start()
        tier_clients(OBS_CLIENTS, client)
        done.set()
        th.join(timeout=TIER_WAIT_S)
        sess.stop()
    served_flash = replays() - base
    joined_flash = sum(1 for j in sess.joined
                       if j["kernel"] == "flash_attention")
    step_threads = len({a["tid"] for a in sess.annotations
                        if a["kernel"] == "executor.step"})
    text, last_ms = _get(url + "/metrics")
    after, exemplars = parse_prometheus_text(text, with_exemplars=True)
    stats = srv.stats()
    tracez = json.loads(_get(url + "/tracez")[0])
    health = json.loads(_get(url + "/healthz")[0])
    sloz = json.loads(_get(url + "/sloz")[0])
    fleetz = json.loads(_get(url + "/fleetz")[0])
    srv.stop()
    tracing.stop_tracing()
    gone = srv.metrics_server is None
    adm = "paddle_tpu_admission_requests_total"
    b, a = _series(before, adm, "outcome"), _series(after, adm, "outcome")
    moved = {k: a.get(k, 0.0) - b.get(k, 0.0) for k in stats["admission"]}
    count = _series(after, "paddle_tpu_serving_request_seconds_count",
                    "outcome").get("ok", 0.0) - _series(
        before, "paddle_tpu_serving_request_seconds_count",
        "outcome").get("ok", 0.0)
    # the p99 bucket: the first whose cumulative count reaches 99 %
    buckets = sorted(
        (float(labels["le"]), value) for n, labels, value in after
        if n == "paddle_tpu_serving_request_seconds_bucket"
        and labels.get("outcome") == "ok")
    le99 = next(le for le, c in buckets if c >= 0.99 * buckets[-1][1])
    ex99 = [e for e in exemplars
            if e["name"] == "paddle_tpu_serving_request_seconds_bucket"
            and e["labels"].get("outcome") == "ok"
            and float(e["labels"]["le"]) == le99]
    traces = {s["trace_id"] for s in tracez["spans"]}
    row = {"requests": OBS_REQUESTS, "answered": stats["answered"],
           "admission": stats["admission"], "scraped_admission": moved,
           "request_histogram_count": count,
           "scrape_ms_under_load": scrape_ms, "scrape_ms_idle": last_ms,
           "p99_bucket_le": le99,
           "p99_exemplar": ex99[0]["exemplar_labels"] if ex99 else None,
           "tracez_spans": len(tracez["spans"]), "healthz": health,
           "session_flash_replays": served_flash,
           "session_flash_joined": joined_flash,
           "session_step_threads": step_threads,
           "sloz_keys": sorted(sloz), "fleetz": fleetz,
           "exporter_gone_after_stop": gone}
    log("observability: the exporter on InferenceServer " + json.dumps(row))
    if moved != stats["admission"] or \
            stats["admission"]["answered_ok"] != OBS_REQUESTS or \
            count != OBS_REQUESTS or not stats["accounted"]:
        raise AssertionError("observability: the scrape disagrees with "
                             "stats()")
    if joined_flash != served_flash or not served_flash or \
            step_threads != len(srv.pool.replicas):
        raise AssertionError("observability: the session around the "
                             "server missed its replicas' flash kernels")
    if not ex99 or ex99[0]["exemplar_labels"]["trace_id"] not in traces:
        raise AssertionError("observability: the p99 exemplar's trace is "
                             "not in /tracez")
    if health != {"status": "ok"} or fleetz != {"enabled": False} or \
            "slos" not in sloz or not gone or not scrape_ms:
        raise AssertionError("observability: a route answered wrong")
    return row


def obs_decode(seed):
    """DecodeServer at the bench's llm_decode widths with metrics_port=0:
    OBS_DECODE_REQUESTS requests, then a scrape whose decode counters
    equal stats() and whose paged-KV page gauges equal each cache's
    stats, with page_accounting() clean."""
    from paddle_tpu_torch.observability.export import parse_prometheus_text

    srv = decode_server("cuda", seed, metrics_port=0).start()
    url = srv.metrics_server.url
    prompts = decode_prompts(seed + 400, OBS_DECODE_REQUESTS,
                             *DECODE_PROMPT, DECODE_MODEL["vocab"])
    futs = [srv.submit(p) for p in prompts]
    for f in futs:
        f.result(timeout=TIER_WAIT_S)
    t_end = time.perf_counter() + TIER_WAIT_S
    while any(rep.cache.stats()["in_use_pages"] for rep in srv.replicas):
        if time.perf_counter() > t_end:
            raise AssertionError("observability: decode pages still held")
        time.sleep(0.01)
    samples = parse_prometheus_text(_get(url + "/metrics")[0])
    stats = srv.stats()
    ok, detail = srv.page_accounting()
    gauges = {}
    for rep in srv.replicas:
        label, cache = rep.cache._label, rep.cache.stats()
        for g, key in (("free", "free_pages"), ("in_use", "in_use_pages"),
                       ("shared", "shared_pages")):
            gauges[f"{label}/{g}"] = (_series(
                samples, "paddle_tpu_paged_kv_pages_" + g, "cache").get(
                label), cache[key])
    events = _series(samples, "paddle_tpu_decode_events_total", "event")
    srv.stop()
    row = {"requests": OBS_DECODE_REQUESTS, "answered": stats["answered"],
           "page_gauges_scraped_vs_cache": gauges,
           "page_accounting": [ok, detail],
           "iterations": stats["decode"]["iterations"],
           "exporter_gone_after_stop": srv.metrics_server is None}
    log("observability: the exporter on DecodeServer " + json.dumps(row))
    if not ok or any(s != c for s, c in gauges.values()) or \
            stats["answered"] != OBS_DECODE_REQUESTS or any(
            events.get(k, 0.0) != v for k, v in stats["decode"].items()) \
            or not row["exporter_gone_after_stop"]:
        raise AssertionError("observability: DecodeServer's scrape "
                             "disagrees with its stats")
    return row


def flash_launch_ms(device, seed, batch):
    """The LM's flash forward (f32, causal, the model's permuted views)
    at ``batch`` rows: the median of OBS_KERNEL_LAUNCHES single launches,
    each bracketed by CUDA events behind a sleeping kernel, so the events
    time the launch's device time and not its issue."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    h = MODEL["n_head"]
    d, t = MODEL["d_model"] // h, MODEL["max_len"]
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((batch, t, h, d)).astype(
        np.float32)).to(device).permute(0, 2, 1, 3) for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    for _ in range(3):
        fa.flash_attention_fwd(q, k, v, True, scale)
    times = []
    for _ in range(OBS_KERNEL_LAUNCHES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fa.flash_attention_fwd(q, k, v, True, scale)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def obs_device_trace(seed, workdir):
    """A DeviceTraceSession around OBS_TRACED lone Predictor requests,
    each under its own trace id, replays only: exactly n_layer flash
    slices a request joined under its trace id (the replays' launches
    counted from the capture), their mean within OBS_KERNEL_TOL of an
    event-timed launch, a step breakdown that sums exactly with the
    logits' Memcpy DtoH in its transfer; the same requests with tracing
    off bitwise equal, and a capture of them holds no annotation.  One
    interpreted request's session first: the kernels launched through
    ctypes join by their correlation ids too."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.observability import device_trace, tracing

    n = MODEL["n_layer"]
    pred = pt.inference.create_predictor(pt.inference.Config(workdir))
    rng = np.random.RandomState(seed + 500)
    shape = (OBS_TRACE_BATCH, MODEL["max_len"], 1)
    reqs = [rng.randint(0, MODEL["vocab_size"], shape)
            for _ in range(OBS_TRACED)]
    pred.run([reqs[0]])                     # the capture of the key
    pred.run([reqs[0]])
    tracer = tracing.start_tracing(sample=1.0)
    tracer.clear()
    with tempfile.TemporaryDirectory() as logdir:
        # the interpreted request: the kernels' own ctypes launches
        sess = device_trace.DeviceTraceSession(logdir).start()
        with tracer.span("interpreted") as root:
            pred._exe.run(pred._program, feed={"src_ids": reqs[0]},
                          fetch_list=pred._fetch_vars, scope=pred._scope)
        sess.stop()
        eager = [j for j in sess.joined if j["kernel"] == "flash_attention"
                 and j["trace_id"] == root.trace_id
                 and "flash_fwd" in j["name"]]
        eager_unlaunched = sum(1 for s in sess.device_slices
                               if s.get("launch") is None)
        # the replays
        base = pred._compiled.replayed_launches().get(
            "flash_attention_fwd", 0)
        sess = device_trace.DeviceTraceSession(logdir).start()
        traced, tids = [], []
        for ids in reqs:
            with tracer.span("request") as sp:
                traced.append(np.array(pred.run([ids])[0]))
            tids.append(sp.trace_id)
        t = time.perf_counter()
        sess.stop()
        stop_s = time.perf_counter() - t
        t = time.perf_counter()
        sess._parse()
        sess._join()
        parse_join_s = time.perf_counter() - t
    tracing.stop_tracing()
    replays = pred._compiled.replayed_launches().get(
        "flash_attention_fwd", 0) - base
    flash = [j for j in sess.joined if j["kernel"] == "flash_attention"]
    by_tid = {}
    for j in flash:
        by_tid[j["trace_id"]] = by_tid.get(j["trace_id"], 0) + 1
    ns = sess.step_breakdown_ns()
    dtoh = [j for j in sess.joined if j["name"].startswith("Memcpy DtoH")]
    mean_ms = sess.kernel_seconds()["flash_attention"] * 1e3 / len(flash) \
        if flash else None
    launch_ms = flash_launch_ms(torch.device("cuda", 0), seed,
                                OBS_TRACE_BATCH)
    # the same requests with tracing off, captured: no annotation
    untraced = []
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for ids in reqs:
            untraced.append(np.array(pred.run([ids])[0]))
        torch.cuda.synchronize()
    annotated = sorted({e.name for e in prof.events()
                        if e.name.startswith(device_trace.ANNOTATION_PREFIX)})
    bitwise = all(np.array_equal(a, b) for a, b in zip(traced, untraced))
    row = {"requests": OBS_TRACED, "batch": OBS_TRACE_BATCH,
           "flash_replays_from_capture": replays,
           "joined_flash_slices": len(flash),
           "flash_slices_by_trace_id": sorted(by_tid.values()),
           "interpreted_flash_joined": len(eager),
           "interpreted_slices_without_launch": eager_unlaunched,
           "slices_without_launch": sum(
               1 for s in sess.device_slices if s.get("launch") is None),
           "device_slices": len(sess.device_slices),
           "joined": len(sess.joined), "annotations": len(sess.annotations),
           "kernel_seconds": sess.kernel_seconds(),
           "flash_joined_mean_ms": mean_ms, "flash_event_launch_ms": launch_ms,
           "step_breakdown_ns": ns,
           "memcpy_dtoh_joined": len(dtoh),
           "memcpy_dtoh_ms": sum(j["dur"] for j in dtoh) / 1e3,
           "stop_s": stop_s, "parse_join_s": parse_join_s,
           "untraced_bitwise": bitwise,
           "annotations_with_tracing_off": annotated}
    log("observability: DeviceTraceSession " + json.dumps(row))
    if len(eager) != n:
        raise AssertionError(
            f"observability: {len(eager)} of the interpreted request's {n} "
            f"flash launches joined ({eager_unlaunched} device slices "
            f"without a launch event)")
    if replays != n * OBS_TRACED or len(flash) != replays or \
            by_tid != {tid: n for tid in tids}:
        raise AssertionError("observability: the joined flash slices do "
                             "not match the replays' launches")
    if abs(mean_ms - launch_ms) > OBS_KERNEL_TOL * launch_ms:
        raise AssertionError("observability: the joined flash time is "
                             "off the event-timed launch")
    if ns["compute"] + ns["transfer"] + ns["host_gap"] != ns["total"] or \
            min(ns.values()) < 0 or len(dtoh) < OBS_TRACED or \
            not all(j["transfer"] and j["step"] is not None for j in dtoh) \
            or ns["transfer"] <= 0:
        raise AssertionError("observability: the step breakdown")
    if not bitwise or annotated:
        raise AssertionError("observability: tracing changed an answer, "
                             "or annotated with tracing off")
    return pred, reqs, row


def obs_fluid_profiler(pred, ids, workdir):
    """profiler.profiler(tracer_option="Default") around one request
    under a trace: the merged trace's device lanes hold the request's
    n_layer flash slices with its trace id."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.observability import device_trace, tracing

    tracer = tracing.start_tracing(sample=1.0)
    path = os.path.join(workdir, "fluid_profile.json")
    with tracer.span("request") as root:
        with profiler.profiler(tracer_option="Default", profile_path=path,
                               sorted_key=None):
            pred.run([ids])
    tracing.stop_tracing()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    lanes = [e for e in events if e.get("ph") == "X" and e.get(
        "pid", 0) >= device_trace.DeviceTraceSession._PID_OFFSET]
    flash = [e for e in lanes if e["args"].get("kernel") == "flash_attention"
             and e["args"].get("trace_id") == root.trace_id]
    bound = device_trace.annotation_name("profiler", root.trace_id)
    row = {"device_lane_events": len(lanes),
           "flash_with_trace_id": len(flash),
           "profiler_annotation": sum(1 for e in lanes
                                      if e["name"] == bound)}
    log("observability: the Fluid profiler " + json.dumps(row))
    if len(flash) != MODEL["n_layer"] or row["profiler_annotation"] != 1:
        raise AssertionError("observability: the Fluid profiler's merged "
                             "trace lacks the request's flash slices")
    return row


def obs_latency(pred, seed):
    """The compiled LM request (BATCH rows) timed over
    OBS_LATENCY_REQUESTS requests with tracing off, on at sample 0 and
    on at sample 1.0 (each request under a span, as a served one is)."""
    import contextlib

    from paddle_tpu_torch.observability import tracing

    rng = np.random.RandomState(seed + 600)
    ids = rng.randint(0, MODEL["vocab_size"], (BATCH, MODEL["max_len"], 1))
    for _ in range(2):
        pred.run([ids])
    out = {}
    for what, sample in (("off", None), ("sample_0", 0.0),
                         ("sample_1", 1.0)):
        tracer = None if sample is None else \
            tracing.start_tracing(sample=sample)
        lat = []
        for _ in range(OBS_LATENCY_REQUESTS):
            t = time.perf_counter()
            with tracer.span("request") if tracer is not None \
                    else contextlib.nullcontext():
                pred.run([ids])
            lat.append((time.perf_counter() - t) * 1e3)
        if sample is not None:
            tracing.stop_tracing()
        out[what] = {"p50_ms": _pct(lat, 50), "p99_ms": _pct(lat, 99),
                     "mean_ms": float(np.mean(lat)),
                     "tracer_installed": tracer is not None}
    log("observability: request latency by tracing setting "
        + json.dumps(out))
    return out


def observability_phase(seed):
    """Phase 3d in this process (the kernels already built): the
    numbers and the flash replays it counted."""
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        save_lm(seed, workdir)
        out["setup_s"] = time.perf_counter() - t0
        out["exporter"] = obs_exporter(seed, workdir)
        out["decode"] = obs_decode(seed)
        pred, reqs, out["device_trace"] = obs_device_trace(seed, workdir)
        out["fluid_profiler"] = obs_fluid_profiler(pred, reqs[0], workdir)
        out["latency"] = obs_latency(pred, seed)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = expected_counts(
        flash_attention_fwd=out["device_trace"]["flash_replays_from_capture"])
    return out


def observability_apart(seed, card):
    """Phase 3d in a process of its own (``--observability``), on the
    kernels built here; returns its numbers."""
    import torch

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        res_path = os.path.join(tmp, "observability.json")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--observability", res_path], timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"phase 3d failed in its process "
                                 f"(exit {proc.returncode})")
        with open(res_path) as f:
            res = json.load(f)
    log(f"observability ({card}) " + json.dumps({
        "latency": res["latency"], "seconds": res["seconds"],
        "parse_join_s": res["device_trace"]["parse_join_s"],
        "scrape_ms_under_load": res["exporter"]["scrape_ms_under_load"]}))
    return res


# ---------------------------------------------------------------------------
# phases 5 and 7: the main paths — training the LM, in f32 and under AMP
# ---------------------------------------------------------------------------

def build_train_program():
    """The LM in training mode with Adam appended, in programs of its
    own.  Returns (model, main, startup, params_grads)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.transformer import \
        transformer_encoder_model

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        model = transformer_encoder_model(**dict(MODEL, is_test=False))
        _, params_grads = pt.optimizer.Adam(TRAIN_LR).minimize(
            model["loss"])
    return model, main, startup, params_grads


def build_amp_program():
    """The bench's AMP training configuration, in programs of its own:
    fuse_epilogue(anchors=("fc",)) before minimize, then Adam(TRAIN_LR,
    fuse=True) under decorate(init_loss_scaling=1.0,
    use_dynamic_loss_scaling=False).  Asserts one fused_adam op, no adam
    op and three fc_epilogue ops a layer."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    from paddle_tpu_torch.models.transformer import \
        transformer_encoder_model

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        model = transformer_encoder_model(**dict(MODEL, is_test=False))
        pt.transpiler.fuse_epilogue(main, protected=[model["loss"].name],
                                    anchors=("fc",))
        opt = decorate(pt.optimizer.Adam(TRAIN_LR, fuse=True),
                       init_loss_scaling=1.0, use_dynamic_loss_scaling=False)
        _, params_grads = opt.minimize(model["loss"])
    types = [op.type for op in main.global_block().ops]
    if (types.count("fused_adam"), types.count("adam"),
            types.count("fc_epilogue")) != (1, 0, 3 * MODEL["n_layer"]):
        raise AssertionError("the AMP program does not hold one fused_adam "
                             "op, no adam op and 3 fc_epilogue ops a layer")
    return model, main, startup, params_grads


def build_tf_program(fcep):
    """The bench's tf_train leg, or with ``fcep`` its tf_train_fcep leg
    (bench.py:307-432), in programs of its own: the LM in training mode,
    fuse_epilogue(anchors=("fc",)) before minimize with ``fcep`` only,
    then Adam(TRAIN_LR, fuse=False) under decorate(init_loss_scaling=1.0,
    use_dynamic_loss_scaling=False).  Asserts one adam op a parameter, no
    fused_adam op and 3 fc_epilogue ops a layer (``fcep``) or none."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    from paddle_tpu_torch.models.transformer import \
        transformer_encoder_model

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        model = transformer_encoder_model(**dict(MODEL, is_test=False))
        if fcep:
            pt.transpiler.fuse_epilogue(main, protected=[model["loss"].name],
                                        anchors=("fc",))
        opt = decorate(pt.optimizer.Adam(TRAIN_LR, fuse=False),
                       init_loss_scaling=1.0, use_dynamic_loss_scaling=False)
        _, params_grads = opt.minimize(model["loss"])
    types = [op.type for op in main.global_block().ops]
    got = (types.count("adam"), types.count("fused_adam"),
           types.count("fc_epilogue"))
    want = (len(params_grads), 0, 3 * MODEL["n_layer"] if fcep else 0)
    if got != want:
        raise AssertionError(f"tf_train{'_fcep' if fcep else ''}: (adam, "
                             f"fused_adam, fc_epilogue) {got}, expected "
                             f"{want}")
    return model, main, startup, params_grads


def tf_mfu(tokens_per_s):
    """The bench's MFU of the LM legs (bench.py:398-404): 6N + 12 L d s
    FLOPs a token (``_transformer_n_params``: the embeddings, 12 d^2 a
    layer's worth of products and the untied output projection) over the
    dense bf16 peak."""
    d, n_layer, d_inner, vocab, seq = (MODEL[k] for k in (
        "d_model", "n_layer", "d_inner", "vocab_size", "max_len"))
    n_params = vocab * d + seq * d + n_layer * (4 * d * d + 2 * d * d_inner) \
        + d * vocab
    fpt = 6.0 * n_params + 12.0 * n_layer * d * seq
    return fpt * tokens_per_s / PEAK_FLOPS["bfloat16"]


def tf_legs(seed):
    """tf_train and tf_train_fcep at the bench's batch 32 (``train``,
    flag fc_epilogue "off" and "on", as the bench sets it), the bench's
    MFU, then each leg's batch-2 step on the card against the CPU at the
    AMP phase's bars (tf_train_fcep's CPU run under "interpret", beside a
    second one under "off").  Returns ({leg: launches}, {leg: row})."""
    launches, rows = {}, {}
    tokens = AMP_BATCH * MODEL["max_len"]
    tol = dict(loss_rtol=AMP_LOSS_RTOL, bulk_rtol=AMP_GRAD_BULK_RTOL,
               bulk_share=AMP_GRAD_BULK_SHARE, max_rtol=AMP_GRAD_MAX_RTOL,
               norm_rtol=AMP_GRAD_NORM_RTOL, param_atol=PARAM_ATOL)
    for leg, fcep in (("tf_train", False), ("tf_train_fcep", True)):
        built = build_tf_program(fcep)
        with kernel_flag("fc_epilogue", "on" if fcep else "off"):
            launches[leg], row = train(
                seed, built, train_batch(seed, AMP_BATCH),
                leg, lm_expected, unit=("tokens", tokens))
        compiled_ms = COMPILED[leg]["compiled"]["wall_ms"]
        row["bench_mfu"] = {"interpreted": tf_mfu(row["tokens_per_s"]),
                            "compiled": tf_mfu(tokens / compiled_ms * 1e3)}
        row["launches_per_step"] = {k: launches[leg][k] // TRAIN_STEPS
                                    for k in KERNELS if launches[leg][k]}
        log(f"{leg} bench MFU " + json.dumps(row["bench_mfu"])
            + " launches a step " + json.dumps(row["launches_per_step"]))
        if fcep:
            row["vs_cpu"] = train_gpu_vs_cpu(
                seed, built, leg, tol, train_batch(seed, CHECK_BATCH),
                modes=("on", "interpret"), cpu_reference_mode="off")
        else:
            row["vs_cpu"] = train_gpu_vs_cpu(
                seed, built, leg, tol, train_batch(seed, CHECK_BATCH),
                flag=None)
        rows[leg] = row
    return launches, rows


def build_resnet_program(config, amp=True):
    """ResNet-50 in training mode as the bench builds it (bench.py
    _build_resnet50_train, s2d=True), in programs of its own:
    resnet50(is_test=False); space_to_depth_stem; fuse_conv_bn_train
    (config "conv_bn_stats"), fuse_conv_epilogue ("conv_epilogue") or no
    fusion ("plain"); nhwc_transpile; Momentum(RN_LR, RN_MOMENTUM), under
    decorate(init_loss_scaling=1.0, use_dynamic_loss_scaling=False) with
    ``amp``.  Asserts the stem (one pad2d, one pad, two space_to_depth)
    and the fused op counts the JAX package's build gives: 53
    conv2d_bn_train, or no chain fused and 53 conv2d."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    from paddle_tpu_torch.models.resnet import resnet50

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        model = resnet50(is_test=False)
        pt.transpiler.space_to_depth_stem(main)
        fused = 0
        if config != "plain":
            fuse = pt.transpiler.fuse_conv_bn_train \
                if config == "conv_bn_stats" \
                else pt.transpiler.fuse_conv_epilogue
            fused = fuse(main, protected=[model[k].name
                                          for k in ("loss", "logits",
                                                    "acc")])
        pt.transpiler.nhwc_transpile(main)
        opt = pt.optimizer.Momentum(learning_rate=RN_LR,
                                    momentum=RN_MOMENTUM)
        if amp:
            opt = decorate(opt, init_loss_scaling=1.0,
                           use_dynamic_loss_scaling=False)
        _, params_grads = opt.minimize(model["loss"])
    types = [op.type for op in main.global_block().ops]
    got = (fused, types.count("conv2d_bn_train"), types.count("conv2d"),
           types.count("pad2d"), types.count("pad"),
           types.count("space_to_depth"))
    want = ((53, 53, 0) if config == "conv_bn_stats" else (0, 0, 53)) \
        + (1, 1, 2)
    if got != want:
        raise AssertionError(f"ResNet-50 {config}: (fused chains, "
                             f"conv2d_bn_train, conv2d, pad2d, pad, "
                             f"space_to_depth) {got}, expected {want}")
    return model, main, startup, params_grads


def resnet_mfu(images_per_s):
    """The bench's ResNet-50 training MFU over the dense bf16 peak."""
    return RN_TRAIN_FLOPS_PER_IMAGE * images_per_s / PEAK_FLOPS["bfloat16"]


def bn_stat_names(main):
    """The BN running mean and variance vars of a program."""
    return [op.inputs[slot][0] for op in main.global_block().ops
            if op.type in ("conv2d_bn_train", "batch_norm")
            for slot in ("Mean", "Variance")]


def rn_expected(leg):
    """A ResNet leg's launches over ``steps`` steps: 106 of conv_stats
    and bn_apply a step (each conv2d_bn_train op, and again in its grad),
    106 of conv_epilogue, or none."""
    if leg == "rn_train_convbnstats":
        return lambda types, steps: expected_counts(
            conv_stats=2 * types.count("conv2d_bn_train") * steps,
            bn_apply=2 * types.count("conv2d_bn_train") * steps)
    if leg == "rn_train_convep":
        return lambda types, steps: expected_counts(
            conv_epilogue=2 * types.count("conv2d") * steps)
    return lambda types, steps: expected_counts()


RN_FLAGS = {"rn_train": None, "rn_train_convbnstats": "conv_bn_stats",
            "rn_train_convep": "conv_epilogue"}


def resnet_legs(seed, rn_bn):
    """The bench's three ResNet-50 legs at batch 128 (``train``; the
    fused legs under their flag "on"), the bench's MFU, then the batch-2
    checks against the CPU: rn_train_convbnstats in f32 and under AMP,
    rn_train_convep and rn_train in f32, each within RN_SPREAD_FACTOR of
    two CPU runs' spread (the flag's "interpret" and "off": rn_train
    builds rn_train_convep's program, so the two share both CPU runs).
    ``rn_bn``: the conv_bn_stats program, already built.  Returns
    ({leg: launches}, {leg: row})."""
    launches, rows = {}, {}
    for leg, config in RN_LEGS.items():
        built = rn_bn if config == "conv_bn_stats" else \
            build_resnet_program(config)
        flag = RN_FLAGS[leg]
        with kernel_flag(flag, "on") if flag else contextlib.nullcontext():
            launches[leg], row = train(
                seed, built, resnet_batch(seed, RN_BATCH), leg,
                rn_expected(leg), steps=RN_CONVEP_STEPS
                if leg == "rn_train_convep" else RN_STEPS,
                unit=("images", RN_BATCH), falling=False)
        del built
        compiled_ms = COMPILED[leg]["compiled"]["wall_ms"]
        row["bench_mfu"] = {
            "interpreted": resnet_mfu(row["images_per_s"]),
            "compiled": resnet_mfu(RN_BATCH / compiled_ms * 1e3),
            "compiled_images_per_s": RN_BATCH / compiled_ms * 1e3}
        log(f"{leg} bench MFU " + json.dumps(row["bench_mfu"]))
        rows[leg] = row
    rn_tol = {dt: dict(factor=RN_SPREAD_FACTOR, floors=RN_FLOORS[dt],
                       bulk_rtol=RN_GRAD_BULK_RTOL) for dt in RN_FLOORS}
    check = resnet_batch(seed, CHECK_BATCH)
    for amp, dt in ((False, "float32"), (True, "bfloat16")):
        built = build_resnet_program("conv_bn_stats", amp=amp)
        rows["rn_train_convbnstats"]["vs_cpu_" + dt] = train_gpu_vs_cpu(
            seed, built, "rn_train_convbnstats " + ("AMP" if amp else "f32"),
            rn_tol[dt], check, flag="conv_bn_stats",
            modes=("on", "interpret"), cpu_reference_mode="off",
            nudge=RN_NUDGE, extra=bn_stat_names(built[1]))
    built = build_resnet_program("conv_epilogue", amp=False)
    rows["rn_train_convep"]["vs_cpu_float32"] = train_gpu_vs_cpu(
        seed, built, "rn_train_convep f32", rn_tol["float32"], check,
        flag="conv_epilogue", modes=("on", "interpret"),
        cpu_reference_mode="off", nudge=RN_NUDGE,
        extra=bn_stat_names(built[1]))
    built = build_resnet_program("plain", amp=False)
    rows["rn_train"]["vs_cpu_float32"] = train_gpu_vs_cpu(
        seed, built, "rn_train f32", rn_tol["float32"], check,
        flag="conv_epilogue", modes=("off", "off"),
        cpu_reference_mode="interpret", extra=bn_stat_names(built[1]))
    return launches, rows


# the stem's max pool in the bench's ResNet-50 legs: 3x3, stride 2, pad 1
# on the 4x4 stem conv's ReLU'd NHWC output at batch 128; the compare
# backward's rows of the first POOL_CPU_IMAGES images are also computed on
# the CPU (elementwise f32 adds in one order: the same bits)
POOL_SHAPE = (RN_BATCH, 112, 112, 64)
POOL_CPU_IMAGES = 8


def check_maxpool_compare(device, seed):
    """maxpool_grad_algo="compare" (plain PyTorch: XLA in the JAX
    package, no hand kernel) on the card at the stem pool's shape in
    bf16, after a ReLU: the same forward as "sas", the gradient equal to
    the CPU's on the first images, and within two bf16 steps (of the
    routed cotangents' magnitudes) of "sas"'s on every element that takes
    no tied gradient; logs how many elements
    take one (a second maximum of a window: "sas" routes a tie to its
    first maximum, compare to all) and the forward + backward ms of
    each."""
    import torch

    from paddle_tpu_torch.core.registry import get_op_def
    from paddle_tpu_torch.flags import set_flags

    pdef = get_op_def("pool2d")
    attrs = pdef.canonical_attrs({
        "pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
        "paddings": [1, 1], "data_format": "NHWC"})
    gen = torch.Generator(device=device).manual_seed(seed + 13)
    x = torch.relu(torch.randn(POOL_SHAPE, generator=gen, device=device)
                   ).to(torch.bfloat16)

    def pool(algo, xx, dy):
        set_flags({"maxpool_grad_algo": algo})
        try:
            xr = xx.detach().requires_grad_()
            out = pdef.compute({"X": xr}, attrs, xx.device)["Out"]
            return out.detach(), torch.autograd.grad(out, xr, dy)[0]
        finally:
            set_flags({"maxpool_grad_algo": "sas"})

    n, h, w, c = POOL_SHAPE
    out_shape = (n, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c)
    dy = torch.randn(out_shape, generator=gen, device=device).to(
        torch.bfloat16)
    c_out, c_dx = pool("compare", x, dy)
    s_out, s_dx = pool("sas", x, dy)
    ones = torch.ones_like(dy)
    tied = pool("compare", x, ones)[1].float() != pool("sas", x, ones)[1] \
        .float()
    free = ~tied
    # on an untied element both route the same cotangents: they part by
    # the roundings of their sums, bounded by the sum of the magnitudes
    mag = pool("compare", x, dy.abs())[1].float()
    step = (c_dx.float() - s_dx.float()).abs()
    ok_free = bool((step[free] <= 2.0 ** -7 * mag[free]).all())
    k = POOL_CPU_IMAGES
    _, cpu_dx = pool("compare", x[:k].cpu(), dy[:k].cpu())
    row = dict(shape=list(POOL_SHAPE), dtype="bfloat16",
               forward_equal=bool(torch.equal(c_out, s_out)),
               equal_to_cpu_on_images=k,
               cpu_equal=bool(torch.equal(c_dx[:k].cpu(), cpu_dx)),
               tied_elements=int(tied.sum()), elements=x.numel(),
               tied_share=float(tied.float().mean()),
               zero_inputs_share=float((x == 0).float().mean()),
               differs_from_sas=int((c_dx != s_dx).sum()),
               untied_within_two_bf16_steps_of_sas=ok_free,
               max_untied_diff=float(step[free].max()),
               ms={algo: cuda_ms(lambda: pool(algo, x, dy), 5)
                   for algo in ("compare", "sas")})
    log("maxpool compare backward at the stem pool " + json.dumps(row))
    if not (row["forward_equal"] and row["cpu_equal"] and ok_free
            and row["tied_elements"] > 0):
        raise AssertionError(f"maxpool compare disagrees: {row}")
    return row


def resnet_batch(seed, batch):
    """The bench's feed: images U[0, 1) NCHW, labels in [0, 1000)."""
    rng = np.random.RandomState(seed + 7)
    return {"image": rng.rand(batch, 3, 224, 224).astype(np.float32),
            "label": rng.randint(0, 1000, (batch, 1)).astype(np.int64)}


@contextlib.contextmanager
def kernel_flag(name, mode):
    """Sets one kernel flag for the block; restores "off"."""
    from paddle_tpu_torch.flags import set_flags

    set_flags({name: mode})
    try:
        yield
    finally:
        set_flags({name: "off"})


def train_batch(seed, batch):
    rng = np.random.RandomState(seed + 2)
    shape = (batch, MODEL["max_len"], 1)
    return {n: rng.randint(0, MODEL["vocab_size"], shape).astype(np.int64)
            for n in ("src_ids", "tgt_label")}


KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "fc_epilogue", "conv_epilogue",
           "conv_stats", "bn_apply", "flash_decode", "conv_int8",
           "quantize_act")
# beside the launches: the bf16 flash kernels' contiguous copies of q, k,
# v (or dO) whose rows were not 16-byte aligned, 0 on every main path
COPIES = "flash_attention_fwd_copies"
BWD_COPIES = "flash_attention_bwd_copies"
# beside them: the fc_epilogue launches that took the wgmma path, and the
# conv_int8 launches that took the wgmma route (the packed stem's too)
FC_WGMMA = "fc_epilogue_wgmma"
I8_WGMMA = "conv_int8_wgmma"


def kernel_counts():
    """The port's launch counts (``ops.kernel_launches``): every kernel's
    under KERNELS' names, and COPIES, BWD_COPIES, FC_WGMMA and I8_WGMMA."""
    from paddle_tpu_torch.ops import kernel_launches

    return kernel_launches()


def reset_kernel_counts():
    from paddle_tpu_torch.ops import reset_kernel_launches

    reset_kernel_launches()


def expected_counts(**per_run):
    """Every kernel's expected launch count, the flash kernels' expected
    copies, fc_epilogue's expected wgmma-path launches and conv_int8's
    expected wgmma-route launches: 0 unless given."""
    return {k: per_run.get(k, 0)
            for k in KERNELS + (COPIES, BWD_COPIES, FC_WGMMA, I8_WGMMA)}


def lm_expected(types, steps):
    """The LM's launches over ``steps`` steps: per step 12 flash forward
    (6 recomputed in the grads), 6 dq, 6 dkv, and each fc_epilogue op
    twice (once more in its grad), every one of them on the wgmma path."""
    n = MODEL["n_layer"]
    fc = 2 * types.count("fc_epilogue") * steps
    return expected_counts(
        flash_attention_fwd=2 * n * steps,
        flash_attention_bwd_dq=n * steps, flash_attention_bwd_dkv=n * steps,
        fc_epilogue=fc, **{FC_WGMMA: fc})


def train(seed, built, feed, what, expected, steps=TRAIN_STEPS,
          unit=("tokens", 0), falling=True):
    """One warm-up step, then ``steps`` counted steps of ``built`` on one
    fixed batch, counting the kernel launches of those steps against
    ``expected(types, steps)``; ``unit`` names what a step processes and
    how many.  Asserts finite losses and, with ``falling``, a fall.  Then
    the compiled pass, from the state after the warm-up: the steps once
    more interpreted (the two runs' spread), then through
    CompiledProgram (``compiled_window``), held to the first run's losses
    and persistables (``hold_to_interpreted``), both profiled."""
    import torch

    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    model, main, startup, params_grads = built
    types = [op.type for op in main.global_block().ops]
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    np.random.seed(seed)
    exe.run(startup, scope=scope)
    n_params = sum(int(np.prod(p.shape)) for p, _ in params_grads)
    counts = {t: types.count(t) for t in sorted(set(types))
              if types.count(t) > 1 or t in ("fused_adam", "momentum")}
    log(f"{what} program: {len(types)} ops {json.dumps(counts)}, "
        f"{n_params} parameters; initialised in "
        f"{time.perf_counter() - t0:.1f} s")

    def step(program=main):
        return float(exe.run(program, feed=feed, fetch_list=[model["loss"]],
                             scope=scope)[0])

    warm_loss = step()                           # warm-up, not counted
    names = [v.name for v in main.persistables() if not v.is_data]
    start = {nm: scope.find_var(nm).get().clone() for nm in names}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    losses, walls, events = timed(step, steps)
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = expected(types, steps)
    log(f"kernel launches over {steps} {what} steps: {launches}")
    if launches != want:
        raise AssertionError(f"{what} launched {launches}, expected {want}")
    if not np.isfinite([warm_loss] + losses).all() or (
            falling and not losses[-1] < losses[0]):
        raise AssertionError(f"{what}: loss not finite"
                             f"{' or not falling' if falling else ''}: "
                             f"{[warm_loss] + losses}")
    leaked = [nm for nm, v in scope.vars.items()
              if isinstance(v.get(), torch.Tensor) and v.get().requires_grad]
    if leaked:
        raise AssertionError(f"scope tensors keep autograd state: "
                             f"{leaked[:5]}")
    name, per_step = unit
    training = dict(steps=steps, warmup_loss=warm_loss, losses=losses,
                    step_ms=walls, step_event_ms=events,
                    **{f"{name}_per_s": steps * per_step / sum(walls) * 1e3},
                    max_memory_allocated_gb=peak)
    log(f"{what} " + json.dumps(training))
    # the interpreter replaces a persistable's tensor, never writes it
    run_a = {"loss": [np.float64(v) for v in losses],
             "persistables": [scope.find_var(nm).get() for nm in names]}

    # the compiled pass: the same steps from the same state
    def interpreted_run():
        for nm in names:
            scope.var(nm).set(start[nm].clone())
        run = [np.float64(step()) for _ in range(steps)]
        return {"loss": run,
                "persistables": [scope.find_var(nm).get() for nm in names]}

    run_b = interpreted_run()
    for nm in names:
        scope.var(nm).set(start[nm].clone())
    compiled = pt.CompiledProgram(main)

    def restore():
        for nm in names:
            scope.find_var(nm).get().copy_(start[nm])

    c_losses, crow = compiled_window(
        what, compiled, lambda: step(compiled), steps, launches, scope,
        names, prepare=restore)
    run_c = {"loss": [np.float64(v) for v in c_losses],
             "persistables": [scope.find_var(nm).get() for nm in names]}
    hold = hold_to_interpreted(
        what, {g: (run_a[g], [run_b[g]], run_c[g]) for g in run_a},
        another=interpreted_run)
    prof, cprof, pairs, records = profile_pair(what, f"{what} step", step,
                                      lambda: step(compiled),
                                      per_call(launches, steps))
    training["profiled_port_calls"] = {"interpreted": prof["port_calls"],
                                       "compiled": cprof["port_calls"]}
    record_compiled(what, (dict(wall_ms=walls, event_ms=events,
                                peak_mem_gb=peak), prof), (crow, cprof),
                    hold, pairs, records)
    del compiled, start, run_a, run_b, run_c
    torch.cuda.empty_cache()
    return launches, training


def train_and_fetch(place, seed, feed, model, main, startup, params_grads,
                    extra=(), f64=False):
    """Step 1 (fetching the loss and every parameter grad), then step 2;
    returns (loss, {grad: ndarray}, {param or extra var: ndarray after
    step 2}, {the same vars: ndarray before step 1}).  With ``f64`` every
    f32 tensor of the scope is cast to f64 after the startup run, so an
    f32 program computes in f64 (its feeds are integers)."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import convert

    exe = pt.Executor(place)
    scope = pt.Scope()
    np.random.seed(seed)
    exe.run(startup, scope=scope)
    if f64:
        for v in scope.vars.values():
            t = v.get()
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                v.set(t.double())
    names = [p.name for p, _ in params_grads] + list(extra)
    start = convert.params_to_numpy(scope, names)
    grads = [g.name for _, g in params_grads]
    out = exe.run(main, feed=feed, fetch_list=[model["loss"]] + grads,
                  scope=scope)
    exe.run(main, feed=feed, scope=scope)
    return (float(out[0]), dict(zip(grads, out[1:])),
            convert.params_to_numpy(scope, names), start)


def step_spread(a, b, bulk_rtol):
    """How far run ``a`` (loss, grads, params, start) is from run ``b``:
    the loss's relative error; each grad's (max error / b's scale, share
    of elements beyond bulk_rtol of that scale, norm of the error / b's
    norm, name), worst first; the parameters' max abs error after two
    steps; and the error of all vars' two-step update together relative
    to the norm of b's update (both runs start from the same values)."""
    rows = []
    for n, want in b[1].items():
        diff = np.abs(a[1][n] - want)
        scale = max(float(np.abs(want).max()), 1e-30)
        norm = max(float(np.linalg.norm(want)), 1e-30)
        rows.append((float(diff.max()) / scale,
                     float((diff > bulk_rtol * scale).mean()),
                     float(np.linalg.norm(diff)) / norm, n))
    rows.sort(reverse=True)
    param_err = max(float(np.abs(a[2][n] - b[2][n]).max()) for n in b[2])
    update_err = math.sqrt(
        sum(float(np.sum(np.square(a[2][n] - b[2][n]))) for n in b[2])
        / max(sum(float(np.sum(np.square(b[2][n] - b[3][n])))
                  for n in b[2]), 1e-30))
    return abs(a[0] - b[0]) / abs(b[0]), rows, param_err, update_err


def spread_summary(spread):
    loss_err, rows, param_err, update_err = spread
    return dict(loss_rel_err=loss_err,
                worst_grads=[{"name": n, "max_err_rel_to_scale": e,
                              "share_beyond_bulk_tol": f,
                              "norm_rel_err": r} for e, f, r, n in rows[:4]],
                max_err_rel_to_scale=max(r[0] for r in rows),
                max_share_beyond_bulk_tol=max(r[1] for r in rows),
                max_norm_rel_err=max(r[2] for r in rows),
                max_param_abs_err_after_2_steps=param_err,
                max_update_rel_err_after_2_steps=update_err)


def spread_metrics(spread):
    """The norm-wise metrics of ``step_spread``: the loss's relative
    error, the largest grad error relative to the grad's norm, the
    two-step update's error relative to the update's norm."""
    loss_err, rows, _, update_err = spread
    return dict(loss=loss_err, norm=max(r[2] for r in rows),
                update=update_err)


# CPU runs of train_gpu_vs_cpu, by ``_run_key``: legs that build the same
# program (rn_train and rn_train_convep; BERT's f32 program, the AMP
# check's reference and the f32 check's) share them
CPU_RUNS = {}
# the directory where a process of its own writes the CPU runs that the
# checks will ask for (``prefetch_cpu_runs``), and that process
PREFETCH = {"dir": None, "proc": None}
PREFETCH_WAIT_S = 1200.0


def _run_key(built, seed, feed, flag, mode, f64, extra):
    """A CPU run's key: the program's serialisation, the feed's bytes,
    the seed, the flag and its mode, f64 and the extra vars fetched."""
    import hashlib

    h = hashlib.sha256(json.dumps(built[1].to_dict(), sort_keys=True)
                       .encode())
    for k in sorted(feed):
        h.update(k.encode() + np.ascontiguousarray(feed[k]).tobytes())
    h.update(json.dumps([seed, flag, mode, f64, list(extra)]).encode())
    return h.hexdigest()


def _save_run(path, run):
    """A run of ``train_and_fetch`` as .npy files and a manifest under
    ``path`` (written aside, then renamed: a reader sees all or
    nothing)."""
    tmp = path + ".part"
    os.makedirs(tmp)
    manifest = {"loss": run[0], "parts": []}
    for i, part in enumerate(run[1:]):
        for j, a in enumerate(part.values()):
            a = np.asarray(a)
            if a.dtype.kind != "f" or a.dtype.itemsize < 4:
                a = a.astype(np.float32)
            np.save(os.path.join(tmp, f"{i}_{j}.npy"), a)
        manifest["parts"].append(list(part))
    with open(os.path.join(tmp, "run.json"), "w") as f:
        json.dump(manifest, f)
    os.rename(tmp, path)


def _load_run(path):
    with open(os.path.join(path, "run.json")) as f:
        manifest = json.load(f)
    return (manifest["loss"], *(
        {n: np.load(os.path.join(path, f"{i}_{j}.npy"), mmap_mode="r")
         for j, n in enumerate(names)}
        for i, names in enumerate(manifest["parts"])))


def _prefetched(key):
    """The CPU run ``key`` from the prefetch process, waiting for it, or
    None when that process does not compute it.  Raises when the process
    failed or the wait runs out."""
    d = PREFETCH["dir"]
    if d is None:
        return None
    t = time.perf_counter()
    while True:
        failed = os.path.join(d, "failed")
        if os.path.exists(failed):
            with open(failed) as f:
                raise AssertionError("the CPU reference runs' process "
                                     "failed:\n" + f.read())
        jobs = os.path.join(d, "jobs.json")
        if os.path.exists(jobs):
            with open(jobs) as f:
                if key not in json.load(f):
                    return None
            if os.path.exists(os.path.join(d, key)):
                return _load_run(os.path.join(d, key))
        proc = PREFETCH["proc"]
        if proc is not None and proc.poll() is not None and \
                not os.path.exists(os.path.join(d, key)):
            raise AssertionError(f"the CPU reference runs' process ended "
                                 f"(exit {proc.returncode}) without run "
                                 f"{key}")
        if time.perf_counter() - t > PREFETCH_WAIT_S:
            raise AssertionError(f"no CPU reference run {key} after "
                                 f"{PREFETCH_WAIT_S} s")
        time.sleep(0.05)


def cpu_reference_jobs(seed):
    """The CPU runs the batch-2 checks ask for, in the order they ask:
    (builder, feed, flag, mode, f64, extra vars of the built program)."""
    lm = train_batch(seed, CHECK_BATCH)
    rn = resnet_batch(seed, CHECK_BATCH)
    nudged = dict(rn, image=(rn["image"] * (1 + RN_NUDGE)).astype(
        np.float32))
    bert = bert_feed(seed, CHECK_BATCH)
    jobs = [(build_train_program, lm, "fc_epilogue", "off", False, None)]
    jobs += [(build_amp_program, lm, "fc_epilogue", m, False, None)
             for m in ("interpret", "off")]
    jobs += [(lambda: build_tf_program(False), lm, None, None, False, None)]
    jobs += [(lambda: build_tf_program(True), lm, "fc_epilogue", m, False,
              None) for m in ("interpret", "off")]
    for config, amp in (("conv_bn_stats", False), ("conv_bn_stats", True),
                        ("conv_epilogue", False)):
        for feed, mode in ((rn, "interpret"), (rn, "off"),
                           (nudged, "interpret")):
            jobs.append((lambda c=config, a=amp: build_resnet_program(
                c, amp=a), feed, config, mode, False, bn_stat_names))
    jobs += [(build_bert_program, bert, None, None, False, None),
             (lambda: build_bert_program(amp=False), bert, None, None,
              False, None),
             (lambda: build_bert_program(amp=False), bert, None, None,
              True, None)]
    return jobs


def prefetch_cpu_runs(seed, out_dir):
    """``--cpu-references``: every run of ``cpu_reference_jobs`` on the
    CPU, each saved under ``out_dir`` by its key as soon as it is done
    (``jobs.json`` lists the keys first); a failure leaves its traceback
    in ``out_dir/failed``.  Started by the main process with the build at
    the lowest priority, so the checks find their CPU runs done."""
    import traceback

    import paddle_tpu_torch as pt

    try:
        jobs = []
        for builder, feed, flag, mode, f64, extra in cpu_reference_jobs(seed):
            built = builder()
            names = tuple(extra(built[1])) if extra else ()
            jobs.append((built, feed, flag, mode, f64, names,
                         _run_key(built, seed, feed, flag, mode, f64,
                                  names)))
        with open(os.path.join(out_dir, "jobs.json.part"), "w") as f:
            json.dump([j[-1] for j in jobs], f)
        os.rename(os.path.join(out_dir, "jobs.json.part"),
                  os.path.join(out_dir, "jobs.json"))
        for built, feed, flag, mode, f64, names, key in jobs:
            with kernel_flag(flag, mode) if flag is not None and \
                    mode is not None else contextlib.nullcontext():
                run = train_and_fetch(pt.CPUPlace(), seed, feed, *built,
                                      extra=names, f64=f64)
            _save_run(os.path.join(out_dir, key), run)
            del run
    except BaseException:
        with open(os.path.join(out_dir, "failed"), "w") as f:
            f.write(traceback.format_exc())
        raise


def train_gpu_vs_cpu(seed, built, what, tol, feed, flag="fc_epilogue",
                     modes=("off", "off"), cpu_reference_mode=None,
                     extra=(), nudge=None, reference_built=None,
                     reference_f64=False, planted=()):
    """The same program from the same seed on the card and on the CPU
    (kernel flag ``flag`` at ``modes[0]`` and ``modes[1]``): the step-1
    loss and grads and the parameters (and ``extra`` vars) after step 2,
    within ``tol`` (loss_rtol, bulk_rtol, bulk_share, max_rtol,
    param_atol and, where given, norm_rtol).  With
    ``cpu_reference_mode`` a second CPU run under that mode shows, beside
    it, how far two CPU runs that round at other points are apart; a
    ``tol`` with ``factor`` and ``floors`` then bounds each metric of
    ``spread_metrics`` by factor x that spread, or by its floor.  With
    ``nudge`` a third CPU run under ``modes[1]``, of the image scaled by
    1 + nudge, shows how far the step moves for that change of its
    input; it bounds nothing.  ``flag`` None sets no kernel flag;
    ``reference_built``, where given, is the program of the second CPU
    run (``cpu_reference_mode`` then names it), whose grads and
    parameters have the same names; ``reference_f64`` runs it in f64.
    CPU runs are kept in CPU_RUNS and shared with any later check of the
    same program, seed, feed and mode.  ``planted``: (name, context)
    pairs, each a fault planted on the card; the card's run under each
    must break the same bounds (logged), or this raises."""
    import paddle_tpu_torch as pt

    runs, secs = {}, {}
    nudged = None if nudge is None else dict(
        feed, image=(feed["image"] * (1 + nudge)).astype(np.float32))

    def one(name, place, mode, f, program, f64=False):
        t = time.perf_counter()
        key = None
        if isinstance(place, pt.CPUPlace):
            key = _run_key(program, seed, f, flag,
                           mode if flag is not None else None, f64, extra)
            if key not in CPU_RUNS:
                run = _prefetched(key)
                if run is not None:
                    CPU_RUNS[key] = run
                    secs[name] = "prefetched, waited " \
                        f"{time.perf_counter() - t:.2f} s"
                    runs[name] = run
                    return
        if key is not None and key in CPU_RUNS:
            runs[name] = CPU_RUNS[key]
            secs[name] = "shared"
            return
        with kernel_flag(flag, mode) if flag is not None and \
                mode is not None else contextlib.nullcontext():
            runs[name] = train_and_fetch(place, seed, f, *program,
                                         extra=extra, f64=f64)
        if key is not None:
            CPU_RUNS[key] = runs[name]
        secs[name] = time.perf_counter() - t

    one("gpu", pt.CUDAPlace(0), modes[0], feed, built)
    one("cpu", pt.CPUPlace(), modes[1], feed, built)
    if cpu_reference_mode is not None:
        ref_mode = None if reference_built is not None else \
            cpu_reference_mode
        one("cpu_reference", pt.CPUPlace(), ref_mode, feed,
            reference_built if reference_built is not None else built,
            reference_f64)
    if nudged is not None:
        one("cpu_nudged", pt.CPUPlace(), modes[1], nudged, built)

    def verdict(gpu):
        loss_err, grad_rows, param_err, _ = spread = step_spread(
            gpu, runs["cpu"], tol["bulk_rtol"])
        res = dict(batch=len(next(iter(feed.values()))), flag=flag,
                   modes=modes, loss_gpu=gpu[0], loss_cpu=runs["cpu"][0],
                   grads=len(grad_rows), **spread_summary(spread), tol=tol,
                   seconds=secs)
        if "cpu_reference" in runs:
            ref_spread = step_spread(runs["cpu_reference"], runs["cpu"],
                                     tol["bulk_rtol"])
            res["cpu_reference"] = dict(mode=cpu_reference_mode,
                                        **spread_summary(ref_spread))
            # each grad's norm error beside the reference run's, by name
            ref_norm = {n: r for _, _, r, n in ref_spread[1]}
            res["norm_rel_err_by_grad"] = {
                n: [r, ref_norm[n]] for _, _, r, n in grad_rows}
        if "cpu_nudged" in runs:
            res["cpu_nudged"] = dict(image_scale=1 + nudge, **spread_summary(
                step_spread(runs["cpu_nudged"], runs["cpu"],
                            tol["bulk_rtol"])))
        if "factor" in tol:
            # each metric within factor x the two CPU runs' spread, or its
            # floor
            got, ref = spread_metrics(spread), spread_metrics(ref_spread)
            res["bounds"] = {k: max(tol["floors"][k], tol["factor"] * ref[k])
                             for k in got}
            failed = any(got[k] > res["bounds"][k] for k in got)
            if tol.get("per_grad"):
                # and each grad's norm error within factor x its own in
                # the reference run, or the norm floor
                worse = {n: e for n, e in res["norm_rel_err_by_grad"].items()
                         if e[0] > max(tol["floors"]["norm"],
                                       tol["factor"] * e[1])}
                res["grads_beyond_their_bound"] = worse
                failed = failed or bool(worse)
        else:
            failed = loss_err > tol["loss_rtol"] or \
                param_err > tol["param_atol"] or any(
                    e > tol["max_rtol"] or f > tol["bulk_share"]
                    or r > tol.get("norm_rtol", 1.0)
                    for e, f, r, _ in grad_rows)
        return res, failed

    res, failed = verdict(runs["gpu"])
    log(f"{what} GPU vs CPU " + json.dumps(res))
    if failed:
        raise AssertionError(f"the GPU {what} step disagrees with the CPU "
                             "run")
    res["planted_faults"] = {}
    for name, fault in planted:
        with fault():
            one(f"gpu_{name}", pt.CUDAPlace(0), modes[0], feed, built)
        bad, caught = verdict(runs.pop(f"gpu_{name}"))
        row = {k: bad[k] for k in ("loss_rel_err", "max_norm_rel_err",
                                   "max_update_rel_err_after_2_steps")}
        # the grads furthest beyond their bound, worst first
        row["grads_beyond_their_bound"] = dict(sorted(
            bad.get("grads_beyond_their_bound", {}).items(),
            key=lambda kv: -kv[1][0] / max(kv[1][1], 1e-30))[:8])
        row["refused"] = caught
        res["planted_faults"][name] = row
        log(f"{what} GPU vs CPU, planted fault {name}: " + json.dumps(row))
        if not caught:
            raise AssertionError(f"{what}: the check passed a planted "
                                 f"fault ({name})")
    return res


# ---------------------------------------------------------------------------
# phases 13-15: LLM decode — flash_decode, then DecodeServer at full width
# ---------------------------------------------------------------------------

def decode_lens(spec, rng):
    """A case's sequence lengths: a list, or (count, low, high) drawn
    uniformly from [low, high]."""
    if isinstance(spec, tuple):
        n, lo, hi = spec
        return [int(x) for x in rng.randint(lo, hi + 1, n)]
    return list(spec)


def decode_inputs(seed, lens, r, h, d, ps, dtype, strided, device):
    """Pools of random pages (made on the card from ``seed``), block
    tables over distinct pages (column-major round robin when
    ``strided``, the handoff-fragmented layout of bench.py:1258-1262),
    entries past a length at page 0, q, and int8 scales."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    b = len(lens)
    mp = max(1, max(-(-n // ps) for n in lens))
    shape = (b * mp + 1, h, ps, d)
    if dtype == "int8":
        k, v = (torch.randint(-127, 128, shape, generator=g, device=device,
                              dtype=torch.int8) for _ in range(2))
        scales = tuple(torch.rand((h, d), generator=g, device=device) + 0.5
                       for _ in range(2))
        qdt = torch.float32
    else:
        qdt = getattr(torch, dtype)
        k, v = (torch.randn(shape, generator=g, device=device).to(qdt)
                for _ in range(2))
        scales = None
    pages = 1 + np.random.RandomState(seed).permutation(b * mp)
    tables = pages.reshape(mp, b).T if strided else pages.reshape(b, mp)
    tables = np.ascontiguousarray(tables).astype(np.int32)
    for i, n in enumerate(lens):
        tables[i, -(-n // ps):] = 0
    qshape = (b, h, d) if r == 1 else (b, r, h, d)
    q = torch.randn(qshape, generator=g, device=device).to(qdt)
    return (q, k, v, torch.from_numpy(tables).to(device),
            torch.tensor(lens, dtype=torch.int32, device=device), scales)


def decode_bound_ms(lens, r, h, d, ps, dtype):
    """Least time: the live keys' K and V rows (the function needs no
    key at or past a length) plus q and out, over HBM; or 4*d operations
    per (row, live key) at the f32 peak (the arithmetic is f32 for every
    pool type).  Returns (bound_ms, bound_by, pages_ms); pages_ms counts
    every page a length reaches whole, as bench.py:1427-1429 does, and
    is the looser figure, kept beside the bound."""
    kv_item = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    q_item = 2 if dtype == "bfloat16" else 4
    pages = sum(-(-n // ps) for n in lens)
    qo = 2 * len(lens) * r * h * d * q_item
    key_bytes = 2.0 * sum(lens) * h * d * kv_item + qo
    page_bytes = 2.0 * pages * ps * h * d * kv_item + qo
    flops = 4.0 * d * h * r * sum(lens)
    t_bytes = key_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            max(page_bytes / PEAK_BYTES_PER_S * 1e3, t_ops))


def decode_library_ms(q, k, v, tables, lens, r, iters, scales=None):
    """The nearest library route, as two calls: gather the pages into a
    dense [B, H, T, d] (int8 pools dequantised by their per-channel
    ``scales`` on the way, as the kernel's wrapper scales q and the
    output), then F.scaled_dot_product_attention with the rows' length
    masks.  Returns (gather_ms, sdpa_ms)."""
    import torch
    import torch.nn.functional as F

    b, mp = tables.shape
    h, ps, d = k.shape[1:]
    t = mp * ps
    tl = tables.long()

    def gather(pool, scale=None):
        x = pool[tl].permute(0, 2, 1, 3, 4).reshape(b, h, t, d)
        if scale is None:
            return x
        return x.float() * (scale.float() / 127.0)[None, :, None, :]

    ks, vs = scales if scales is not None else (None, None)
    kd, vd = gather(k, ks), gather(v, vs)
    qd = (q[:, None] if q.dim() == 3 else q).permute(0, 2, 1, 3)
    row = torch.arange(r, device=q.device)
    limit = torch.minimum(lens[:, None], lens[:, None] - r + 1 + row)
    mask = torch.arange(t, device=q.device)[None, None, None, :] < \
        limit[:, None, :, None]
    gather_ms = graph_ms(lambda: (gather(k, ks), gather(v, vs)), iters)
    sdpa_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask), iters)
    return gather_ms, sdpa_ms


# (name, lengths, R, H, d, page size, dtype, strided tables)
DECODE_CASES = [
    ("ragged", [5, 33, 16, 1], 1, 4, 64, 16, "float32", False),
    ("zero_rows", [5, 0, 129, 0], 1, 2, 128, 16, "float32", True),
    ("tiny_pages", [40, 7, 129], 5, 2, 16, 4, "float32", True),
    ("verify_20", [30, 64, 65, 300], 20, 2, 64, 16, "float32", False),
    ("bf16", [5, 33, 16, 1], 1, 4, 64, 16, "bfloat16", False),
    ("bf16_verify", [17, 90, 0], 5, 2, 128, 128, "bfloat16", True),
    ("int8", [5, 33, 64, 0], 1, 4, 64, 16, "int8", False),
    ("int8_verify", [70, 9, 300], 5, 2, 128, 128, "int8", True),
    # head dims the kernel took no copy of before (d 72 over int8 pages:
    # rows of 72 bytes, copied element by element), 70 verify rows (five
    # row blocks), lengths on both sides of a split boundary (16 pages:
    # 256 keys at page 16) with their verify rows, one long sequence as a
    # verify sweep
    ("d72", [5, 33, 300, 1], 5, 2, 72, 16, "float32", False),
    ("d72_int8", [70, 9, 300], 5, 2, 72, 16, "int8", True),
    ("d160_bf16", [17, 90, 260, 0], 5, 2, 160, 32, "bfloat16", True),
    ("d256", [129, 7, 300], 3, 2, 256, 32, "float32", False),
    # above d 1024: chunks of 4 keys (the pools' d alone sets them), a step
    # and a 5-row sweep over f32, bf16 and int8 pools, across a split
    ("d1536", [5, 33, 300, 1], 1, 2, 1536, 16, "float32", False),
    ("d1536_bf16_verify", [70, 9, 300], 5, 2, 1536, 16, "bfloat16", True),
    ("d2048_verify", [17, 90, 260, 0], 5, 2, 2048, 32, "float32", True),
    ("d2048_int8", [129, 7, 300], 1, 2, 2048, 16, "int8", False),
    ("d2048_int8_verify", [70, 9, 300], 5, 2, 2048, 16, "int8", True),
    # above d 2048: the wide kernel (q.k in slices, output columns in
    # 2048-column slices)
    ("d3072", [5, 33, 300, 1], 1, 2, 3072, 16, "float32", False),
    ("d3072_bf16_verify", [70, 9, 300], 5, 2, 3072, 16, "bfloat16", True),
    ("d3072_int8_verify", [17, 90, 260, 0], 5, 2, 3072, 32, "int8", True),
    ("verify_70", [100, 75, 600, 70], 70, 2, 64, 16, "float32", False),
    ("split_straddle", [254, 256, 258, 513, 516, 1030], 5, 2, 64, 16,
     "float32", False),
    ("split_straddle_bf16", [256, 259, 512, 515], 5, 2, 128, 16, "bfloat16",
     True),
    ("split_straddle_int8", [256, 257, 260, 1025], 5, 2, 128, 16, "int8",
     False),
    ("draft", (64, 64, 160), 1, 2, 16, 128, "float32", False),
    ("main_verify", (64, 64, 160), 5, 8, 128, 128, "float32", False),
    ("main_strided", (64, 64, 160), 1, 8, 128, 128, "float32", True),
    ("main", (64, 64, 160), 1, 8, 128, 128, "float32", False),
    ("main_int8", (64, 64, 160), 1, 8, 128, 128, "int8", False),
    ("long_64x4096", [4096] * 64, 1, 8, 128, 128, "float32", False),
    ("long_1x32768", [32768], 1, 8, 128, 128, "float32", False),
    ("long_1x32768_verify", [32768], 5, 8, 128, 128, "float32", False),
]
DECODE_LIBRARY = ("main", "main_verify", "main_int8", "long_64x4096",
                  "long_1x32768")


def check_flash_decode(device, seed):
    """flash_decode against its plain version over DECODE_CASES; verify
    rows array_equal to q-len-1 launches; zero-length rows exact zeros.
    Times on the device (``graph_ms``) the kernel, the plain version and
    (for DECODE_LIBRARY cases) the gather + SDPA library route, and the
    wrapper's call as the host issues it (``call_ms``)."""
    import torch

    from paddle_tpu_torch.ops import flash_decode as fd

    rng = np.random.RandomState(seed)
    rows = []
    for i, (name, spec, r, h, d, ps, dtype, strided) in \
            enumerate(DECODE_CASES):
        lens = decode_lens(spec, rng)
        q, k, v, tab, ln, scales = decode_inputs(
            seed + i, lens, r, h, d, ps, dtype, strided, device)
        out = fd.flash_decode(q, k, v, tab, ln, kv_scales=scales)
        torch.cuda.synchronize()
        ref = fd.flash_decode_plain(q, k, v, tab, ln, kv_scales=scales)
        scale = max(1.0, ref.float().abs().max().item())
        err = (out.float() - ref.float()).abs().max().item()
        ok = out.dtype == ref.dtype and err <= DECODE_TOL[dtype] * scale
        zero = [j for j, n in enumerate(lens) if n == 0]
        zeros_exact = bool(torch.equal(out[zero], torch.zeros_like(
            out[zero]))) if zero else None
        verify_equal = None
        if r > 1:
            verify_equal = all(torch.equal(fd.flash_decode(
                q[:, j].contiguous(), k, v, tab, (ln - (r - 1 - j)).clamp_min(0),
                kv_scales=scales), out[:, j]) for j in range(r))
        big = sum(lens) * h >= 64 * 4096 * 8
        iters = 3 if big else 20

        def call():
            return fd.flash_decode(q, k, v, tab, ln, kv_scales=scales)

        ms = graph_ms(call, iters)
        call_ms = cuda_ms(call, iters)
        plain_ms = graph_ms(lambda: fd.flash_decode_plain(
            q, k, v, tab, ln, kv_scales=scales), iters)
        gather_ms = sdpa_ms = None
        if name in DECODE_LIBRARY:
            gather_ms, sdpa_ms = decode_library_ms(q, k, v, tab, ln, r,
                                                   3 if big else 20, scales)
        bound_ms, bound_by, bound_pages_ms = decode_bound_ms(lens, r, h, d,
                                                             ps, dtype)
        row = dict(name=name, streams=len(lens), len_min=min(lens),
                   len_max=max(lens), tokens=sum(lens), R=r, H=h, d=d,
                   page=ps, dtype=dtype, strided=strided,
                   max_abs_err=err, err_rel_to_scale=err / scale,
                   zeros_exact=zeros_exact,
                   verify_rows_equal=verify_equal, ms=ms, call_ms=call_ms,
                   plain_ms=plain_ms,
                   gather_ms=gather_ms, sdpa_ms=sdpa_ms,
                   library_ms=None if sdpa_ms is None else gather_ms + sdpa_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_pages_ms=bound_pages_ms,
                   bound_share=bound_ms / ms)
        log("flash_decode case " + json.dumps(row))
        if not ok or zeros_exact is False or verify_equal is False:
            raise AssertionError(f"flash_decode disagrees: {row}")
        rows.append(row)
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return rows


# the bench's llm_decode leg (bench.py _build_llm_decode) at full width
DECODE_MODEL = dict(vocab=32000, d_model=1024, num_heads=8, head_dim=128)
DECODE_STREAMS = 64
DECODE_PAGE = 128
DECODE_PROMPT = (64, 128)
DECODE_NEW = 32
DECODE_SPEC_K = 4
DECODE_LONG = dict(requests=16, prompt=4096, chunk=512)
DECODE_CPU_PROMPTS = 8
# int8 pools: next-token agreement with f32 ones, each prompt's cache
# calibrated on that prompt (the JAX package's
# test_int8_kv_top1_agreement bar and setting), over INT8_PROMPTS prompts
INT8_TOP1 = 0.95
INT8_PROMPTS = 256
# a CPU step whose top-2 logit margin is below this share of the logit
# scale is a near-tie: cuBLAS may round the projections differently at
# another batch size, so the card may take the other token there
NEAR_TIE = 1e-4
DECODE_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8, "int8": 1e-5}


def decode_prompts(seed, n, lo, hi, vocab):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, vocab, size=int(rng.randint(lo, hi + 1)))
            for _ in range(n)]


_DECODE_LMS = {}


def decode_model(device, seed):
    """The full-width TinyDecodeLM on ``device``, built once."""
    from paddle_tpu_torch import serving

    if (device, seed) not in _DECODE_LMS:
        _DECODE_LMS[device, seed] = serving.TinyDecodeLM(
            seed=seed, device=device, **DECODE_MODEL)
    return _DECODE_LMS[device, seed]


def decode_server(device, seed, **cfg):
    from paddle_tpu_torch import serving

    model = decode_model(device, seed)
    kw = dict(max_batch=DECODE_STREAMS, max_new_tokens=DECODE_NEW,
              page_size=DECODE_PAGE, num_pages=3 * DECODE_STREAMS,
              queue_capacity=4 * DECODE_STREAMS, default_deadline_s=600.0,
              drain_timeout_s=600.0, device=device)
    kw.update(cfg)
    return serving.DecodeServer(lambda i: model,
                                serving.DecodeConfig(**kw))


def run_decode(what, device, seed, prompts, per_iteration=1,
               window=None, **cfg):
    """Serve ``prompts`` through a fresh DecodeServer, counting the
    kernel launches of that run only; asserts every request answered,
    launches == per_iteration * iterations and zero page leaks after
    stop().  ``window(fn)``, when given, runs the span from the first
    submit to the last result (``profile`` wraps it).  Returns (token
    lists, stats, run metrics, the stopped server)."""
    import torch

    srv = decode_server(device, seed, **cfg).start()
    if device == "cuda":
        torch.cuda.synchronize()
        reset_kernel_counts()

    def serve_all():
        futs = [srv.submit(p) for p in prompts]
        return [list(f.result(timeout=900.0)[0]) for f in futs]

    t = time.perf_counter()
    outs = window(serve_all) if window else serve_all()
    wall = time.perf_counter() - t
    srv.stop()
    st = srv.stats()
    ok, detail = srv.page_accounting()
    leaks = sum(r["cache"]["in_use_pages"] for r in st["replicas"].values())
    iterations = st["decode"]["iterations"]
    res = dict(requests=len(prompts), answered=st["answered"],
               iterations=iterations, wall_s=wall,
               tokens=sum(len(o) for o in outs),
               tokens_per_s=sum(len(o) for o in outs) / wall,
               inter_token_p50_ms=st["inter_token_p50_ms"],
               inter_token_p99_ms=st["inter_token_p99_ms"],
               spec_acceptance_rate=st["spec_acceptance_rate"],
               prefill_chunks=st["decode"]["prefill_chunks"],
               preemptions=st["decode"]["preemptions"], leaked_pages=leaks)
    if device == "cuda":
        launches = kernel_counts()
        want = expected_counts(flash_decode=per_iteration * iterations)
        res["launches"] = launches
        if launches != want:
            raise AssertionError(f"{what} launched {launches}, expected "
                                 f"{want}")
    log(f"{what} " + json.dumps(res))
    if not ok or leaks or st["answered"] != len(prompts) or \
            not st["accounted"] or any(not o for o in outs):
        raise AssertionError(f"{what}: unanswered requests or page leaks "
                             f"({detail}): {res}")
    return outs, st, res, srv


def near_tie_steps(model, prompt, tokens, kv_scales=None):
    """The CPU model's top-2 logit margin, relative to the logit scale,
    at each step of ``tokens`` (greedy over the whole prefix, no
    cache).  With ``kv_scales`` (an int8 cache's), K and V go through
    that cache's quantization first, as the int8 pools hold them."""
    import torch

    from paddle_tpu_torch.ops.paged_kv import dequantize_kv, quantize_kv

    hist = list(prompt)
    margins = []
    with torch.no_grad():
        for tok in tokens:
            q, k, v = model.qkv(np.asarray(hist))
            if kv_scales is not None:
                k, v = (dequantize_kv(quantize_kv(x, s), s)
                        for x, s in zip((k, v), kv_scales))
            s = torch.einsum("hd,thd->ht", q[-1], k) / math.sqrt(
                model.head_dim)
            o = torch.einsum("ht,thd->hd", torch.softmax(s, dim=-1), v)
            logits = model.logits(o[None])[0]
            top = torch.topk(logits, 2).values
            margins.append(float(top[0] - top[1])
                           / float(logits.abs().max()))
            hist.append(tok)
    return margins


def compare_with_cpu(what, gpu, cpu, margins):
    """Token-for-token agreement up to the first CPU near-tie step.
    Returns (sequences compared, near-tie stops); raises on any other
    divergence."""
    stops = 0
    for i, (g, c, m) in enumerate(zip(gpu, cpu, margins)):
        tie = next((j for j, x in enumerate(m) if x < NEAR_TIE), len(c))
        if g[:tie] != c[:tie] or (tie == len(c) and g != c):
            raise AssertionError(f"{what}: sequence {i} diverges from the "
                                 f"CPU before any near-tie (first near-tie "
                                 f"step {tie}): {g} vs {c}")
        stops += tie < len(c)
    return len(gpu), stops


def int8_top1_agreement(device, seed):
    """The JAX package's int8 accuracy bar at full width on the card:
    each prompt prefilled into its own f32 and int8 caches (the int8 one
    calibrated on that prompt), its last token decoded through the
    kernel, the greedy picks compared."""
    from paddle_tpu_torch.ops.flash_decode import flash_decode
    from paddle_tpu_torch.ops.paged_kv import PagedKVCache

    model = decode_model(device, seed)
    agree = 0
    for p in decode_prompts(seed + 9, INT8_PROMPTS, *DECODE_PROMPT,
                            DECODE_MODEL["vocab"]):
        _, k, v = model.qkv(p[:-1])
        q, _, _ = model.qkv(p[-1:])
        picks = []
        for int8 in (False, True):
            c = PagedKVCache(num_pages=2, page_size=DECODE_PAGE,
                             num_heads=model.num_heads,
                             head_dim=model.head_dim, kv_int8=int8,
                             device=device)
            s = c.prefill(k, v)
            o = flash_decode(q, c.k_pages, c.v_pages, c.tables_for([s]),
                             c.lens_for([s]),
                             kv_scales=c.kv_scales() if int8 else None)
            picks.append(int(model.logits(o).argmax()))
        agree += picks[0] == picks[1]
    return agree / INT8_PROMPTS


def decode_phase(device, seed):
    """The main path: DecodeServer at full width on the card, plain,
    speculative (spec_k=4) under the default draft and under the target
    as its own draft, int8 pools, 4096-token prompts with chunked
    prefill, and a profiled plain run; then the card against the CPU."""
    import torch

    vocab = DECODE_MODEL["vocab"]
    prompts = decode_prompts(seed + 7, DECODE_STREAMS, *DECODE_PROMPT, vocab)
    # warm-up (cuBLAS handles, the allocator, the kernel's first load)
    run_decode("decode warm-up", "cuda", seed, prompts[:4])
    launches = {}
    plain, _, res, _ = run_decode("decode", "cuda", seed, prompts)
    launches["decode"] = res["launches"]
    spec_k = dict(per_iteration=DECODE_SPEC_K + 1, spec_k=DECODE_SPEC_K)
    spec, _, spec_res, _ = run_decode(
        f"decode spec_k={DECODE_SPEC_K}", "cuda", seed, prompts, **spec_k)
    launches["decode_spec"] = spec_res["launches"]
    # the target as its own draft: proposals agree with the verify sweep
    # up to the projections' rounding at another batch size, so rounds
    # accept several tokens (and rewind after a partial accept)
    model = decode_model("cuda", seed)
    self_spec, _, self_res, _ = run_decode(
        f"decode spec_k={DECODE_SPEC_K} self-draft", "cuda", seed, prompts,
        draft_factory=lambda i: model, **spec_k)
    launches["decode_spec_self"] = self_res["launches"]
    if not self_res["spec_acceptance_rate"] > 0:
        raise AssertionError("the self-drafted run accepted no proposal: "
                             f"{self_res}")
    for what, toks in (("spec_k", spec), ("self-draft spec_k", self_spec)):
        if toks != plain:
            log(f"decode {what} tokens differ from the plain run's in "
                f"{sum(a != b for a, b in zip(toks, plain))} sequences "
                "(checked against the CPU below)")
    int8, _, int8_res, _ = run_decode("decode kv_int8", "cuda", seed,
                                      prompts, kv_int8=True)
    launches["decode_int8"] = int8_res["launches"]
    # the server's int8 pools are calibrated once, on the first prefill
    # (the JAX package's static-scale contract), so later prompts' K/V
    # clip: its first tokens agree less than the per-prompt bar below.
    # Its tokens are held to the CPU int8 server's below, and that server
    # to the JAX package's (tests/test_torch_decode_server.py)
    server_top1 = float(np.mean([a[0] == b[0] for a, b in zip(int8, plain)]))
    top1 = int8_top1_agreement("cuda", seed)
    log(f"decode kv_int8 next-token agreement with f32: {top1} over "
        f"{INT8_PROMPTS} prompts, each cache calibrated on its prompt (bar "
        f"{INT8_TOP1}); the int8 server's first tokens (one calibration, "
        f"on its first prefill): {server_top1}")
    if top1 < INT8_TOP1:
        raise AssertionError(f"int8 pools agree on {top1} of next tokens, "
                             f"below {INT8_TOP1}")
    long_cfg = DECODE_LONG
    pages = -(-(long_cfg["prompt"] + DECODE_NEW + 1) // DECODE_PAGE)
    long_prompts = decode_prompts(seed + 8, long_cfg["requests"],
                                  long_cfg["prompt"], long_cfg["prompt"],
                                  vocab)
    _, _, long_res, _ = run_decode(
        f"decode {long_cfg['requests']}x{long_cfg['prompt']} prompts, "
        f"prefill_chunk={long_cfg['chunk']}", "cuda", seed, long_prompts,
        prefill_chunk=long_cfg["chunk"],
        num_pages=long_cfg["requests"] * pages + DECODE_STREAMS)
    launches["decode_long"] = long_res["launches"]
    if not long_res["prefill_chunks"]:
        raise AssertionError("the long prompts were not chunked")
    # the plain run again under the profiler, first submit to last result
    profiled, _, _, _ = run_decode(
        "decode profiled", "cuda", seed, prompts, window=lambda fn: profile(
            f"served run of {DECODE_STREAMS} decode requests", fn)[0])
    if profiled != plain:
        raise AssertionError("the profiled decode run emitted other tokens")

    # the card against the CPU: the first prompts on the port's CPU server,
    # with f32 and with int8 pools (calibrated on the same first prompt)
    t = time.perf_counter()
    cpu_prompts = prompts[:DECODE_CPU_PROMPTS]
    cpu, _, _, _ = run_decode("decode on the CPU", "cpu", seed, cpu_prompts)
    cpu8, _, _, cpu8_srv = run_decode("decode kv_int8 on the CPU", "cpu",
                                      seed, cpu_prompts, kv_int8=True)
    cpu_model = decode_model("cpu", seed)
    scales = cpu8_srv.replicas[0].cache.kv_scales()
    margins = [near_tie_steps(cpu_model, p, c)
               for p, c in zip(cpu_prompts, cpu)]
    margins8 = [near_tie_steps(cpu_model, p, c, scales)
                for p, c in zip(cpu_prompts, cpu8)]
    checks = {}
    for what, gpu, ref, m in (("plain", plain, cpu, margins),
                              ("spec", spec, cpu, margins),
                              ("spec_self", self_spec, cpu, margins),
                              ("int8", int8, cpu8, margins8)):
        checks[what] = compare_with_cpu(f"decode {what} GPU vs CPU",
                                        gpu[:DECODE_CPU_PROMPTS], ref, m)
    log("decode GPU vs CPU " + json.dumps({
        "sequences": DECODE_CPU_PROMPTS, "near_tie": NEAR_TIE,
        "near_tie_stops": {k: v[1] for k, v in checks.items()},
        "min_cpu_margin": min(min(m) for m in margins),
        "min_cpu_margin_int8": min(min(m) for m in margins8),
        "cpu_s": time.perf_counter() - t}))
    del cpu_model, cpu8_srv, _DECODE_LMS["cpu", seed]
    torch.cuda.empty_cache()
    return launches, res, spec_res, self_res, int8_res, long_res, top1


# the bench's llm_decode_chunked_join leg (bench.py:1607-1720): JOIN
# streams of 128-token prompts decode while one 32768-token prompt joins
# and prefills in 512-token chunks, over DECODE_MODEL at page 128.  The
# streams generate JOIN_NEW tokens, so that at least JOIN_AFTER steps
# follow the join (the bench's 64 tokens and 2 warm-up steps leave at most
# 2): a longer window, nothing else changed.  The running streams'
# inter-token p99 during the join must stay under the JAX package's
# objective (tests/test_decode_act2.py: 0.25 s).
JOIN = dict(streams=16, prompt=128, join=32768, chunk=512)
JOIN_NEW = 160
JOIN_JOINER_NEW = 8
JOIN_AFTER = 32
JOIN_P99_BAR_MS = 250.0
# the joiner's table is wider than this many pages once it decodes, and
# flash_decode must take such a table on this path
JOIN_WIDE_TABLE = 256


def _pct(vals, p):
    """bench.py's percentile: the sorted values' element at int(p% n)."""
    vs = sorted(vals)
    return vs[min(len(vs) - 1, int(p / 100 * len(vs)))] if vs else None


def join_server(device, seed):
    """A DecodeServer for the join: room for every stream and the joiner
    (max_batch streams + 1) and pages for all of them, so one sequence
    may hold the joiner's 257 pages and more (the table's width is the
    pool's, max_pages_per_seq)."""
    streams, ps = JOIN["streams"], DECODE_PAGE
    pages = streams * -(-(JOIN["prompt"] + JOIN_NEW + 1) // ps) \
        + -(-(JOIN["join"] + JOIN_JOINER_NEW + 1) // ps) + streams
    return decode_server(device, seed, max_batch=streams + 1,
                         max_new_tokens=JOIN_NEW, num_pages=pages,
                         prefill_chunk=JOIN["chunk"])


def run_join(device, seed, prompts, joiner, window=None):
    """The streams' ``prompts`` served; once every stream has emitted
    two tokens, ``joiner`` (None: no joiner) is submitted.  Each inter-
    token record of the server (``_record_step_ms``) is tagged with the
    iteration, whether a prefill chunk ran in it and whether it is the
    joiner's, by wrapping the server's methods of this instance (the
    server's code is not changed).  Returns (stream tokens, joiner
    tokens, records, stats, the table widths flash_decode took, the
    flash_decode launches, the stopped server's page accounting)."""
    from paddle_tpu_torch.serving import decode_engine

    srv = join_server(device, seed).start()
    state = {"chunks": 0, "seq": None, "rep": None}
    records, widths = [], []
    admit, commit, record = srv._admit, srv._commit_tokens, \
        srv._record_step_ms
    attend = decode_engine.flash_decode

    def tagged_admit(rep):
        state["chunks"] = srv._counters["prefill_chunks"]
        return admit(rep)

    def tagged_commit(rep, s, toks, t_emit):
        state["seq"], state["rep"] = s, rep
        return commit(rep, s, toks, t_emit)

    def tagged_record(ms):
        s = state["seq"]
        records.append(dict(
            ms=ms, iteration=state["rep"].iterations,
            chunk=srv._counters["prefill_chunks"] > state["chunks"],
            joiner=joiner is not None and len(s.prompt) == len(joiner)))
        record(ms)

    def widths_attend(q, k, v, tables, *a, **kw):
        widths.append(int(tables.shape[1]))
        return attend(q, k, v, tables, *a, **kw)

    srv._admit, srv._commit_tokens = tagged_admit, tagged_commit
    srv._record_step_ms = tagged_record
    decode_engine.flash_decode = widths_attend
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
        reset_kernel_counts()
    try:
        def serve():
            futs = [srv.submit(p) for p in prompts]
            jf = None
            if joiner is not None:
                while sum(not r["joiner"] for r in records) < \
                        2 * len(prompts):
                    time.sleep(0.0005)
                jf = srv.submit(joiner, max_new_tokens=JOIN_JOINER_NEW)
            outs = [list(f.result(timeout=900.0)[0]) for f in futs]
            return outs, (None if jf is None
                          else list(jf.result(timeout=900.0)[0]))

        t = time.perf_counter()
        outs, jout = window(serve) if window else serve()
        wall = time.perf_counter() - t
    finally:
        decode_engine.flash_decode = attend
        srv.stop()
    launches = kernel_counts() if device == "cuda" else None
    st = srv.stats()
    ok, detail = srv.page_accounting()
    leaks = sum(r["cache"]["in_use_pages"] for r in st["replicas"].values())
    return dict(outs=outs, joiner=jout, records=records, stats=st,
                widths=widths, launches=launches, wall_s=wall,
                accounting=(ok, detail, leaks))


def decode_join_phase(device, seed):
    """llm_decode_chunked_join on the card: the streams alone (their
    reference tokens), the joiner alone with the same chunking (its
    reference), the join measured, then the join again profiled.  Bars:
    every stream's tokens equal to the streams-alone run's, the joiner's
    to its run alone, >= join/chunk - 1 chunks, zero page leaks,
    flash_decode launches == iterations, at least one launch on a table
    wider than 256 pages, at least JOIN_AFTER steps after the join, and
    the streams' inter-token p99 during the join under JOIN_P99_BAR_MS.
    Returns (launches, the row)."""
    vocab = DECODE_MODEL["vocab"]
    prompts = decode_prompts(seed + 11, JOIN["streams"], JOIN["prompt"],
                             JOIN["prompt"], vocab)
    joiner = decode_prompts(seed + 12, 1, JOIN["join"], JOIN["join"],
                            vocab)[0]
    alone = run_join(device, seed, prompts, None)
    solo = run_join(device, seed, [joiner], None)
    run = run_join(device, seed, prompts, joiner)
    recs = run["records"]
    during = [r for r in recs if r["chunk"] and not r["joiner"]]
    last = max(i for i, r in enumerate(recs) if r["chunk"]) if during \
        else len(recs)
    after = [r for r in recs[last + 1:] if not r["joiner"]]
    st = run["stats"]
    iterations = st["decode"]["iterations"]
    row = dict(
        streams=JOIN["streams"], prompt=JOIN["prompt"],
        join_prompt=JOIN["join"], chunk=JOIN["chunk"], new_tokens=JOIN_NEW,
        wall_s=run["wall_s"], iterations=iterations,
        chunks_prefilled=st["decode"]["prefill_chunks"],
        join_steps=len({r["iteration"] for r in during}),
        after_steps=len({r["iteration"] for r in after}),
        inter_token_p50_ms=_pct([r["ms"] for r in recs
                                 if not r["joiner"]], 50),
        inter_token_p99_ms=_pct([r["ms"] for r in recs
                                 if not r["joiner"]], 99),
        inter_token_p99_during_join_ms=_pct([r["ms"] for r in during], 99),
        inter_token_p99_after_join_ms=_pct([r["ms"] for r in after], 99),
        tokens_per_s=sum(len(o) for o in run["outs"]) / run["wall_s"],
        max_table_pages=max(run["widths"]),
        launches_on_wide_tables=sum(w > JOIN_WIDE_TABLE
                                    for w in run["widths"]),
        leaked_pages=run["accounting"][2])
    if during and after:
        row["p99_during_over_after"] = \
            row["inter_token_p99_during_join_ms"] \
            / row["inter_token_p99_after_join_ms"]
    row["streams_equal_to_no_join"] = run["outs"] == alone["outs"]
    row["joiner_equal_to_alone"] = run["joiner"] == solo["outs"][0][
        :len(run["joiner"])]
    if device == "cuda":
        want = expected_counts(flash_decode=iterations)
        row["launches"] = run["launches"]
        if run["launches"] != want:
            raise AssertionError(f"the join launched {run['launches']}, "
                                 f"expected {want}")
    log("decode chunked join " + json.dumps(row))
    for res in (alone, solo, run):
        ok, detail, leaks = res["accounting"]
        if not ok or leaks or not res["stats"]["accounted"]:
            raise AssertionError(f"the join's server leaked pages or lost "
                                 f"requests: {detail}, {leaks} pages")
    if not (row["streams_equal_to_no_join"] and row["joiner_equal_to_alone"]
            and row["chunks_prefilled"] >= JOIN["join"] // JOIN["chunk"] - 1
            and row["launches_on_wide_tables"]
            and row["after_steps"] >= JOIN_AFTER
            and row["inter_token_p99_during_join_ms"] < JOIN_P99_BAR_MS):
        raise AssertionError(f"the chunked join misses a bar: {row}")
    if device == "cuda":
        _, prof = profile("chunked join, first submit to last result",
                          lambda: run_join(device, seed, prompts, joiner))
        row["profiled"] = {k: prof[k] for k in (
            "wall_ms", "device_ms", "device_idle_share")}
    return run["launches"], row


# phase 12b: disaggregated prefill/decode (DecodeConfig(disagg_prefill=
# True)) at DECODE_MODEL's widths: DISAGG_PROMPTS prompts over one shared
# pool of 3 * DECODE_STREAMS pages, in each (decode replicas, max_batch)
# of DISAGG_CONFIGS with DISAGG_PREFILL prefill replicas, each held to a
# single-tier run of the same replicas and batch.  flash_decode is held to
# its plain version on the shared pool's own tables at the first iteration
# with at least DISAGG_LIVE live streams and a fragmented table.  The
# first configuration runs again under each of DISAGG_CHAOS, the two
# pinned kills of tools/chaos_soak.py's run_disagg_iteration.
DISAGG_CONFIGS = ((1, 64), (2, 32))
DISAGG_PREFILL = 2
DISAGG_PROMPTS = 64
DISAGG_LIVE = 32
DISAGG_CHAOS = (("serving_prefill", 1, dict(restart_dead=False)),
                ("serving_decode", 2, {}))


class SharedPoolProbe:
    """For one run, wraps the engine's ``flash_decode`` (its module
    attribute; the server's code is not changed).  At the first launch
    over at least ``live`` streams with a table that is not one run of
    consecutive pages, it keeps clones of that launch's q, pools, tables,
    lengths and output (in stream order, so the pools are as the launch
    read them) and each stream's page list.  The launch is the main
    path's own: nothing more is launched.  Until then each launch's
    tables and lengths are read on the host."""

    def __init__(self, live):
        self.live, self.snap, self.pages = live, None, None

    def __enter__(self):
        from paddle_tpu_torch.serving import decode_engine

        self._attend = attend = decode_engine.flash_decode

        def kept_attend(q, k, v, tables, lens, *args, **kw):
            out = attend(q, k, v, tables, lens, *args, **kw)
            if self.snap is None:
                ps = k.shape[2]
                pages = [row[:-(-n // ps)] for row, n in zip(
                    tables.tolist(), lens.tolist()) if n > 0]
                if len(pages) >= self.live and any(
                        b != a + 1 for p in pages for a, b in zip(p, p[1:])):
                    self.snap = {n: t.clone() for n, t in (
                        ("q", q), ("k", k), ("v", v), ("tables", tables),
                        ("lens", lens), ("out", out))}
                    self.pages = pages
            return out

        decode_engine.flash_decode = kept_attend
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.serving import decode_engine

        decode_engine.flash_decode = self._attend
        return False

    def check(self, what, device):
        """The kept launch's output against flash_decode_plain on the
        same inputs (DECODE_TOL["float32"] of the output's scale), its
        tables' fragmentation (the share of a table's neighbouring page
        pairs that are not consecutive pages), and on the card the
        kernel's time by graph replay on those inputs beside the plain
        version's and the bound."""
        import torch

        from paddle_tpu_torch.ops import flash_decode as fd

        if self.snap is None:
            raise AssertionError(f"{what}: no launch over {self.live} or more "
                                 "streams had a fragmented table")
        s = self.snap
        ref = fd.flash_decode_plain(s["q"], s["k"], s["v"], s["tables"],
                                    s["lens"])
        scale = max(1.0, ref.float().abs().max().item())
        err = (s["out"].float() - ref.float()).abs().max().item()
        pairs = [(a, b) for p in self.pages for a, b in zip(p, p[1:])]
        lens = [int(x) for x in s["lens"].cpu() if x > 0]
        row = dict(streams=len(self.pages), live_tokens=sum(lens),
                   table_width=int(s["tables"].shape[1]),
                   fragmented_tables=sum(any(
                       b != a + 1 for a, b in zip(p, p[1:]))
                       for p in self.pages),
                   non_consecutive_pair_share=sum(
                       b != a + 1 for a, b in pairs) / max(1, len(pairs)),
                   max_abs_err=err, err_rel_to_scale=err / scale,
                   tol=DECODE_TOL["float32"])
        if device == "cuda":
            h, d = s["q"].shape[-2:]
            args = [s[n] for n in ("q", "k", "v", "tables", "lens")]
            row["ms"] = graph_ms(lambda: fd.flash_decode(*args), 20)
            row["plain_ms"] = graph_ms(lambda: fd.flash_decode_plain(*args),
                                       20)
            row["bound_ms"], row["bound_by"], _ = decode_bound_ms(
                lens, 1, h, d, int(s["k"].shape[2]), "float32")
        log(f"{what}: flash_decode on the shared pool's tables "
            + json.dumps(row))
        if not err <= DECODE_TOL["float32"] * scale:
            raise AssertionError(f"{what}: flash_decode disagrees with its "
                                 f"plain version on the shared pool: {row}")
        self.snap = None
        return row


def handoff_buckets():
    """The handoff-latency histogram's bucket counts (its one series)."""
    from paddle_tpu_torch.serving import decode_engine

    hist = decode_engine._M_HANDOFF_SECONDS
    series = list(hist.series())
    return list(series[0][1].counts) if series \
        else [0] * (len(hist.buckets) + 1)


def handoff_pct(before, after, p):
    """The p-th percentile (ms) of the handoffs observed between two
    ``handoff_buckets`` readings: the upper bound of its bucket, as the
    instrument reports (``_HistogramSeries.percentile``)."""
    from paddle_tpu_torch.serving import decode_engine

    bounds = decode_engine._M_HANDOFF_SECONDS.buckets
    counts = [b - a for a, b in zip(before, after)]
    n = sum(counts)
    if not n:
        return None
    target, acc = max(1, -(-int(p * n) // 100)), 0
    for i, c in enumerate(counts):
        acc += c
        if acc >= target:
            return bounds[i] * 1e3 if i < len(bounds) else float("inf")
    return None


def disagg_run(what, device, seed, prompts, n_replicas, max_batch,
               disagg, window=None, **cfg):
    """``run_decode`` at (n_replicas, max_batch), with DISAGG_PREFILL
    prefill replicas when ``disagg``; adds the disaggregated bars (every
    prompt's handoff adopted, nothing in use or in transit on the shared
    pool after stop()) and the handoff latency's p50/p99 from the
    ``paddle_tpu_disagg_handoff_seconds`` histogram.  Returns (tokens,
    stats, the run's row)."""
    if disagg:
        cfg.update(disagg_prefill=True, n_prefill_replicas=DISAGG_PREFILL)
    h0 = handoff_buckets()
    outs, st, res, srv = run_decode(
        what, device, seed, prompts, window=window, n_replicas=n_replicas,
        max_batch=max_batch, **cfg)
    h1 = handoff_buckets()
    res = dict(res, decode_replicas=n_replicas, max_batch=max_batch)
    if disagg:
        sc, dis = srv._shared_cache, st["disagg"]
        res.update(
            handoffs_offered=dis["handoffs_offered"],
            handoffs_adopted=dis["handoffs_adopted"],
            handoffs_lost=dis["handoffs_lost"],
            prefill_kills=dis["prefill_kills"],
            kills=st["decode"]["kills"], failovers=st["decode"]["failovers"],
            prefills_by_replica={i: p["prefills"] for i, p in
                                 dis["prefill_replicas"].items()},
            shared_pool_pages=sc.num_pages,
            peak_in_use_pages=sc.stats()["peak_in_use_pages"],
            handoff_p50_ms=handoff_pct(h0, h1, 50),
            handoff_p99_ms=handoff_pct(h0, h1, 99),
            after_stop={"in_use": sc.in_use_pages(),
                        "in_transit": sc.in_transit_pages()})
        log(f"{what} (the tiers) " + json.dumps({k: res[k] for k in (
            "handoffs_offered", "handoffs_adopted", "handoffs_lost",
            "prefill_kills", "kills", "failovers", "prefills_by_replica",
            "shared_pool_pages", "peak_in_use_pages", "handoff_p50_ms",
            "handoff_p99_ms", "after_stop")}))
        if sc.in_use_pages() or sc.in_transit_pages() or \
                dis["handoffs_adopted"] < len(prompts) or \
                not st["accounted"]:
            raise AssertionError(f"{what}: a handoff was not adopted or the "
                                 f"shared pool leaked: {res}")
    return outs, st, res


def disagg_phase(device, seed):
    """Phase 12b: each configuration single-tier, disaggregated (the
    kernel held on the shared pool's tables), then both again under the
    profiler; the first configuration under each pinned kill.  Bars:
    each stream's tokens equal to the single-tier run's (under the kills
    too), every prompt's handoff adopted, flash_decode launches ==
    iterations, zero pages in use or in transit after stop(), every
    request answered once.  Returns the launches by path and the rows."""
    from paddle_tpu_torch.distributed import faultinject

    vocab = DECODE_MODEL["vocab"]
    prompts = decode_prompts(seed + 13, DISAGG_PROMPTS, *DECODE_PROMPT,
                             vocab)
    launches, rows, reference = {}, {}, {}
    for n_rep, batch in DISAGG_CONFIGS:
        name = f"{n_rep}x{batch}"
        single, _, srow = disagg_run(
            f"decode single tier {name}", device, seed, prompts, n_rep,
            batch, False)
        probe = SharedPoolProbe(min(DISAGG_LIVE, batch))
        with probe:
            tiers, _, drow = disagg_run(
                f"decode disaggregated {name}", device, seed, prompts, n_rep,
                batch, True)
        drow["kernel_on_shared_pool"] = probe.check(
            f"decode disaggregated {name}", device)
        drow["tokens_equal_single_tier"] = tiers == single
        if tiers != single:
            raise AssertionError(
                f"decode disaggregated {name}: tokens differ from the single "
                f"tier's in {sum(a != b for a, b in zip(tiers, single))} "
                "streams")
        if device == "cuda":
            launches[f"decode_disagg_{name}"] = drow["launches"]
            for what, row, disagg in (("single tier", srow, False),
                                      ("disaggregated", drow, True)):
                prof = {}

                def profiled(fn, label=f"served run of {DISAGG_PROMPTS} "
                             f"decode requests, {what} {name}", prof=prof):
                    out, prof["p"] = profile(label, fn)
                    return out

                disagg_run(f"decode {what} {name} profiled", device, seed,
                           prompts, n_rep, batch, disagg, window=profiled)
                row["profiled"] = {k: prof["p"][k] for k in (
                    "wall_ms", "device_ms", "device_idle_share")}
        rows[name] = {"single_tier": srow, "disaggregated": drow}
        reference[n_rep, batch] = single
    n_rep, batch = DISAGG_CONFIGS[0]
    for msg, index, extra in DISAGG_CHAOS:
        what = f"decode disaggregated {n_rep}x{batch}, {msg}@{index}:kill"
        plan = faultinject.FaultPlan().on(msg, index, "kill")

        def faulted(fn, plan=plan):
            with faultinject.installed(plan):
                return fn()

        outs, st, crow = disagg_run(what, device, seed, prompts, n_rep, batch,
                                    True, window=faulted, **extra)
        killed = crow["prefill_kills"] if msg == "serving_prefill" \
            else crow["kills"]
        crow["tokens_equal_single_tier"] = outs == reference[n_rep, batch]
        if killed != 1 or crow["failovers"] < 1 or \
                not crow["tokens_equal_single_tier"] or \
                st["answered"] != DISAGG_PROMPTS:
            raise AssertionError(f"{what}: {crow}")
        rows[f"{msg}@{index}:kill"] = crow
    if device == "cuda":
        rows["layouts"] = disagg_layouts(seed)
    log("decode disaggregated numbers " + json.dumps({
        name: {side: {k: r.get(k) for k in (
            "tokens_per_s", "inter_token_p50_ms", "inter_token_p99_ms",
            "handoff_p50_ms", "handoff_p99_ms", "iterations", "profiled")}
            for side, r in pair.items()}
        for name, pair in rows.items() if "single_tier" in pair}))
    return launches, rows


def disagg_layouts(seed):
    """flash_decode by graph replay at phase 11's main shape (64 streams
    of 64-160 tokens, 8 heads of 128, page 128, f32) with the bench's
    handoff-strided tables (bench.py:1258-1262) and contiguous ones, on
    the same lengths, each beside its bound."""
    from paddle_tpu_torch.ops import flash_decode as fd

    lens = decode_lens((64, 64, 160), np.random.RandomState(seed + 14))
    row = {}
    for strided in (True, False):
        q, k, v, tab, ln, _ = decode_inputs(seed + 14, lens, 1, 8, 128, 128,
                                            "float32", strided, "cuda")
        row["strided" if strided else "contiguous"] = graph_ms(
            lambda: fd.flash_decode(q, k, v, tab, ln), 20)
        del q, k, v
    row["bound_ms"], row["bound_by"], _ = decode_bound_ms(lens, 1, 8, 128,
                                                          128, "float32")
    log("flash_decode by layout at the main shape " + json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# phases 15-22: conv-net inference in bf16 and int8 (the bench's six
# inference legs, bench.py:1767-1793, the infer leg's A/B lever, and the
# bf16 Predictor)
# ---------------------------------------------------------------------------

# leg -> (model, batch, image side): the bench's batches (bench.py:667,
# 701, 722, 744, 768)
INFER_LEGS = {
    "infer": ("resnet50", 128, 224),
    "infer_convep": ("resnet50", 128, 224),
    "vgg_infer": ("vgg16", 64, 224),
    "vgg_cifar": ("vgg16_cifar", 512, 32),
    "rn32_cifar": ("resnet32_cifar", 512, 32),
    "infer_i8": ("resnet50", 128, 224),
    "infer_i8_inter": ("resnet50", 128, 224),
    "predictor": ("resnet50", 128, 224),
}
INFER_RUNS = 5        # counted batches a leg, after one warm-up batch
INT8_CALIB = 8        # calibration images (bench.py:812)
BN_CALIB_IMAGES = 8   # images whose statistics the batch norms take
# bf16 logits on the card against the CPU's f32 run of the same program
# before bf16_transpile, at batch CHECK_BATCH, as a share of the f32
# logits' scale, a bound a leg (bf16 keeps 8 significant bits and rounds
# at every one of 16-50 layers).  Each bound lies between the leg's sound
# reading and the reading of a planted fault, the same comparison against
# the CPU run with one block's (folded) shift zeroed, which must break it
# (on an NVIDIA H100 80GB HBM3 at 700 W, seed 0: infer 0.0089 / 0.381,
# infer_convep 0.0065 / 0.384, the Predictor 0.0072 / 0.386, vgg_infer
# 0.111 / 0.315, vgg_cifar 0.065 / 0.263, rn32_cifar 0.0028 / 0.246).
# Top-1 must agree on every image whose f32 top-2 margin is above twice
# the leg's measured error; a closer image is a near-tie whose top-1 the
# measured error may flip, and it is counted and logged.
BF16_BOUNDS = {"infer": 0.03, "infer_convep": 0.03, "predictor": 0.03,
               "vgg_infer": 0.18, "vgg_cifar": 0.13, "rn32_cifar": 0.01}
# int8: the card and the CPU run the same converted program and scales.
# The s8 sums are exact, the f32 epilogues round at fixed points and the
# float ops between them (the average pool) agree on both, so every logit
# and the fc's float input must be equal; the distance of any unequal
# logit in steps of the bf16 grid of the fc's output is logged.
# the dense s8 peak of the same card at 700 W (tensor cores)
PEAK_INT8_OPS = 1979e12


def build_infer_model(name, side):
    """(logits name, main, startup) of an inference model
    (``is_test=True``) in programs of its own."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet, vgg

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        if name == "resnet50":
            model = resnet.resnet50(is_test=True,
                                    image_shape=(3, side, side))
        elif name == "vgg16":
            model = vgg.vgg16(is_test=True, img_shape=(3, side, side))
        elif name == "vgg16_cifar":
            model = vgg.vgg(16, class_dim=10, img_shape=(3, side, side),
                            is_test=True)
        else:
            model = resnet.resnet_cifar10(is_test=True)
    return model["logits"].name, main, startup


def init_infer_scope(main, startup, seed, device, side):
    """A scope holding the startup's weights on ``device`` (host RNG
    from ``seed``), every batch norm's scale and shift drawn from U[0.5,
    1.5) (U[0.1, 0.2) where a residual add takes its output, as trained
    residual nets keep their branches small: a random net of unit
    branches is chaotic, and bf16's roundings grow through it without
    bound) and U[-0.5, 0.5), its running mean 0 and its running variance
    the mean square of its input over BN_CALIB_IMAGES images, layer
    after layer (at least a tenth of the layer's mean): the activations
    keep about unit scale, as a trained net's do, so a shift of one block
    matters to the logits (the planted faults' premise).  (Centring on
    the batch mean divides nearly constant channels by a tiny deviation,
    and a channel dead on the calibration images by sqrt(epsilon): both
    amplify bf16's rounding past any bound.)"""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.executor import RuntimeCtx

    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    np.random.seed(seed)
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(seed + 11)
    block = main.global_block()
    into_add = {n for op in block.ops if op.type == "elementwise_add"
                for n in op.input_names()}
    feed = infer_feed(main, seed + 23, BN_CALIB_IMAGES, side)
    exe._feed_data(main, feed, scope)
    ctx = RuntimeCtx(exe, main)
    with torch.no_grad():
        for op in block.ops:
            if op.type == "batch_norm":
                x = scope.find_var(op.inputs["X"][0]).get().float()
                dims = (0, 2, 3) if x.dim() == 4 else (0,)
                c = x.shape[1]
                ms = (x * x).mean(dims)
                residual = op.outputs["Y"][0] in into_add
                stats = {"Mean": torch.zeros(c),
                         "Variance": torch.maximum(ms, 0.1 * ms.mean()),
                         "Scale": rng.uniform(0.1, 0.2, c) if residual
                         else rng.uniform(0.5, 1.5, c),
                         "Bias": rng.uniform(-0.5, 0.5, c)}
                for slot, value in stats.items():
                    if isinstance(value, np.ndarray):
                        value = torch.from_numpy(value.astype(np.float32))
                    scope.var(op.inputs[slot][0]).set(value.to(device))
            exe._run_op(op, block, scope, ctx)
    return scope


def infer_feed(program, seed, batch, side, device=None, dtype=None):
    """The bench's feed: images U[0, 1), and zero labels where the
    program reads them; on ``device`` (in ``dtype``) or as numpy."""
    import torch

    rng = np.random.RandomState(seed + 13)
    feed = {"image": rng.rand(batch, 3, side, side).astype(np.float32)}
    if "label" in program.global_block().vars:
        feed["label"] = np.zeros((batch, 1), np.int64)
    if device is not None:
        feed = {k: torch.from_numpy(v).to(device) for k, v in feed.items()}
        if dtype is not None:
            feed["image"] = feed["image"].to(dtype)
    return feed


def persistable_state(program, scope):
    """{name: CPU tensor} of the program's persistables in ``scope``."""
    out = {}
    for v in program.list_vars():
        var = scope.find_var(v.name) if v.persistable else None
        if var is not None and var.get() is not None:
            out[v.name] = var.get().detach().cpu().clone()
    return out


def cpu_logits(program, state, feed, fetch):
    """``program`` on the CPU with ``state`` (a copy of it)."""
    import paddle_tpu_torch as pt

    out, = pt.Executor(pt.CPUPlace()).run(program, feed=feed,
                                          fetch_list=[fetch],
                                          scope=pt_scope(state))
    return np.asarray(out, np.float32)


def time_infer(what, exe, program, feed, fetch, scope, expected):
    """One warm-up batch, then INFER_RUNS counted batches: ms a batch by
    events and by the host clock (each ending in a synchronise), kernel
    launches (checked against ``expected``), and a profile of one batch.
    Then the same batches through CompiledProgram (``compiled_window``),
    each output held to the interpreted one (``hold_to_interpreted``,
    with one more interpreted batch for the spread), and a profile of
    one replay."""
    import torch

    import paddle_tpu_torch as pt

    def run(prog=program):
        return exe.run(prog, feed=feed, fetch_list=[fetch], scope=scope,
                       return_numpy=False)[0]

    out = run()
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{what}: non-finite logits")
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    outs, walls, events = timed(run, INFER_RUNS)
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if launches != expected:
        raise AssertionError(f"{what} launched {launches}, expected "
                             f"{expected}")
    batch = int(feed["image"].shape[0])
    row = dict(batch=batch, event_ms=events, wall_ms=walls,
               images_per_s=batch * len(walls) / sum(walls) * 1e3,
               launches_per_batch={k: v // INFER_RUNS
                                   for k, v in launches.items() if v},
               peak_mem_gb=peak)
    log(f"{what} " + json.dumps(row))
    again = run()
    compiled = pt.CompiledProgram(program).with_inference_optimize()
    names = [v.name for v in program.persistables() if not v.is_data]
    couts, crow = compiled_window(what, compiled, lambda: run(compiled),
                                  INFER_RUNS, launches, scope, names)
    hold = hold_to_interpreted(what, {"logits": (
        outs, [[again] * INFER_RUNS], couts)},
        another=lambda: {"logits": [run()] * INFER_RUNS})
    prof, cprof, pairs, records = profile_pair(what, f"{what} batch", run,
                                      lambda: run(compiled),
                                      per_call(launches, INFER_RUNS))
    row["compiled"] = record_compiled(
        what, (dict(wall_ms=walls, event_ms=events, peak_mem_gb=peak),
               prof), (crow, cprof), hold, pairs, records)
    del compiled, couts
    torch.cuda.empty_cache()
    return launches, row


def check_bf16_vs_cpu(what, exe, program, f32_program, scope, state32,
                      fetch, shift_var, seed, side):
    """The card's bf16 logits at CHECK_BATCH against the CPU's f32 run of
    the program before bf16_transpile (same weights), within the leg's
    BF16_BOUNDS of scale and with equal top-1 (bf16_agreement); the same
    against the CPU run with ``shift_var`` zeroed must break the
    bound."""
    import torch

    feed = infer_feed(program, seed, CHECK_BATCH, side)
    card, = exe.run(program, feed=feed, fetch_list=[fetch], scope=scope)
    card = np.asarray(card, np.float32)
    ref = cpu_logits(f32_program, state32, feed, fetch)
    faulted = dict(state32)
    faulted[shift_var] = torch.zeros_like(state32[shift_var])
    fault = cpu_logits(f32_program, faulted, feed, fetch)
    row = bf16_agreement(what, card, ref, fault)
    row["planted_fault"] = shift_var
    log(f"{what} card vs CPU " + json.dumps(row))
    return row


def bf16_agreement(what, card, ref, fault):
    """The card's logits against the CPU's f32 ones and the faulted CPU
    run, as shares of the f32 logits' scale, held to the leg's
    BF16_BOUNDS; top-1 agreement over all images and over the decisive
    ones, whose top-2 margin is above twice the measured error (a flip
    there is a fault; below it, a near-tie).  Raises where the card
    breaks the bound or a decisive top-1, or the planted fault keeps
    within it."""
    bound = BF16_BOUNDS[what]
    scale = float(np.abs(ref).max())
    err = float(np.abs(card - ref).max()) / scale
    top = np.sort(ref, axis=-1)
    margin = (top[:, -1] - top[:, -2]) / scale
    same = card.argmax(-1) == ref.argmax(-1)
    decisive = margin > 2 * err
    row = dict(scale=scale, err_rel_to_scale=err, bound=bound,
               top1_equal=bool(same.all()), top1_margin_rel=margin.tolist(),
               n_decisive=int(decisive.sum()),
               top1_equal_decisive=bool(same[decisive].all()),
               planted_fault_err=float(np.abs(card - fault).max()) / scale)
    if not (err <= bound and row["top1_equal_decisive"]):
        raise AssertionError(f"{what}: the card's bf16 logits disagree with "
                             f"the CPU's f32 run: {row}")
    if row["planted_fault_err"] <= bound:
        raise AssertionError(f"{what}: a planted fault does not break the "
                             f"bound: {row}")
    return row


def fc_output_steps(program, state, card, ref):
    """|card - ref| in steps of the bf16 grid of the int8 fc's output
    (mul_int8 casts y = acc * scales to bf16 before its bias add): one
    step of y is 2^(e - 7) for y in [2^e, 2^(e+1))."""
    block = program.global_block()
    fc = next(o for o in block.ops if o.type == "mul_int8")
    out = fc.outputs["Out"][0]
    add = next((o for o in block.ops if o.type == "elementwise_add"
                and o.inputs["X"][0] == out), None)
    bias = state[add.inputs["Y"][0]].float().numpy() if add else 0.0
    y = np.abs(ref - bias)
    step = np.exp2(np.floor(np.log2(np.maximum(y, 1e-30))) - 7)
    return np.abs(card - ref) / step


def check_int8_vs_cpu(what, exe, program, scope, fetch, seed, side):
    """The card's int8 logits at CHECK_BATCH against the CPU's run of the
    same converted program and state: the share of equal logits, the
    rest's distance in steps of the fc output's bf16 grid, and the fc's
    float input (the average pool) on both."""
    import paddle_tpu_torch as pt

    feed = infer_feed(program, seed, CHECK_BATCH, side)
    state = persistable_state(program, scope)
    fc_in = next(o for o in program.global_block().ops
                 if o.type == "mul_int8").inputs["X"][0]
    card, card_x = (np.asarray(v, np.float32) for v in exe.run(
        program, feed=feed, fetch_list=[fetch, fc_in], scope=scope))
    ref, ref_x = (np.asarray(v, np.float32) for v in pt.Executor(
        pt.CPUPlace()).run(program, feed=feed, fetch_list=[fetch, fc_in],
                           scope=pt_scope(state)))
    steps = fc_output_steps(program, state, card, ref)
    unequal = card != ref
    row = dict(equal_share=float(1.0 - unequal.mean()),
               max_bf16_steps=float(steps.max()),
               fc_input_max_err_rel=float(np.abs(card_x - ref_x).max())
               / float(np.abs(ref_x).max()),
               fc_input_unequal=int((card_x != ref_x).sum()),
               fc_inputs=int(ref_x.size),
               top1_equal=bool((card.argmax(-1) == ref.argmax(-1)).all()),
               scale=float(np.abs(ref).max()))
    log(f"{what} card vs CPU " + json.dumps(row))
    if unequal.any() or row["fc_input_unequal"]:
        raise AssertionError(f"{what}: the card's int8 logits disagree with "
                             f"the CPU's run of the same program: {row}")
    return row


def pt_scope(state):
    """A scope holding copies of ``state``'s tensors."""
    import paddle_tpu_torch as pt

    scope = pt.Scope()
    for name, t in state.items():
        scope.var(name).set(t.clone())
    return scope


def last_shift(program, fused):
    """The shift var of the program's last block: the last batch norm's
    Bias, or (folded and fused) the last fused conv's folded bias."""
    ops = program.global_block().ops
    if fused:
        return next(op for op in reversed(ops)
                    if op.type == "conv2d_epilogue").inputs["Bias"][0]
    return next(op for op in reversed(ops)
                if op.type == "batch_norm").inputs["Bias"][0]


def bf16_leg(leg, seed, device):
    """One bf16 leg: the bench's build (bench.py:623-661), timed at its
    batch, checked against the CPU.  Returns (launches, row, program)."""
    import torch

    import paddle_tpu_torch as pt

    name, batch, side = INFER_LEGS[leg]
    t0 = time.perf_counter()
    fetch, main, startup = build_infer_model(name, side)
    scope = init_infer_scope(main, startup, seed, device, side)
    infer = main.clone(for_test=True)
    fused = leg == "infer_convep"
    if fused:
        pt.transpiler.InferenceTranspiler().transpile(
            infer, scope=scope, protected=[fetch])
        pt.transpiler.fuse_conv_epilogue(infer, protected=[fetch])
    pt.transpiler.nhwc_transpile(infer)
    f32_program = infer.clone()
    state32 = persistable_state(infer, scope)
    pt.contrib.float16.bf16_transpile(infer, scope=scope)
    types = [op.type for op in infer.global_block().ops]
    n_fused = types.count("conv2d_epilogue")
    log(f"{leg}: {name} at {side}x{side}, {len(types)} ops "
        f"({n_fused} conv2d_epilogue), built in "
        f"{time.perf_counter() - t0:.1f} s")
    if fused and n_fused != 53:
        raise AssertionError(f"{leg}: {n_fused} conv2d_epilogue ops, "
                             "expected 53")
    exe = pt.Executor(pt.CUDAPlace(0))
    feed = infer_feed(infer, seed, batch, side, device, torch.bfloat16)
    with kernel_flag("conv_epilogue", "on" if fused else "off"):
        launches, row = time_infer(
            leg, exe, infer, feed, fetch, scope,
            expected_counts(conv_epilogue=n_fused * INFER_RUNS))
        row["vs_cpu"] = check_bf16_vs_cpu(
            leg, exe, infer, f32_program, scope, state32, fetch,
            last_shift(infer, fused), seed, side)
    row["ops"] = len(types)
    return launches, row, infer


def int8_program(leg, seed, device):
    """The converted program of an int8 leg as bench.py:768-929 builds it:
    fold, nhwc, abs-max int8 weights, calibration on INT8_CALIB images,
    conversion with bf16 out (interlayer for infer_i8_inter).  Returns
    (program, scope, fetch name, executor, the bench's coverage row)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib.slim import quantization as slim

    inter = leg == "infer_i8_inter"
    name, _, side = INFER_LEGS[leg]
    fetch, main, startup = build_infer_model(name, side)
    scope = init_infer_scope(main, startup, seed, device, side)
    exe = pt.Executor(pt.CUDAPlace(0))
    infer = main.clone(for_test=True)
    pt.transpiler.InferenceTranspiler().transpile(infer, scope=scope,
                                                  protected=[fetch])
    pt.transpiler.nhwc_transpile(infer)
    qw = slim.quantize_weights_abs_max(infer, scope)
    rng = np.random.RandomState(7)
    calib = [{"image": rng.rand(INT8_CALIB, 3, side, side).astype(
        np.float32), "label": np.zeros((INT8_CALIB, 1), np.int64)}]
    act_scales, _ = slim.post_training_quantize(
        infer, scope, exe, calib, fetch_list=[fetch],
        fold_boundaries=inter)
    slim.convert_to_int8_execution(infer, scope, qw, act_scales=act_scales,
                                   out_dtype="bfloat16",
                                   int8_activations=inter,
                                   protected=[fetch])
    ops = infer.global_block().ops
    int8_ops = [op for op in ops if op.type.endswith("_int8")]
    n_cal = sum(1 for op in int8_ops if op.inputs.get("InScale"))
    calib_row = {"n_int8_params": len(qw), "n_int8_ops": len(int8_ops),
                 "n_int8_calibrated": n_cal,
                 "calibration_coverage": n_cal / max(len(int8_ops), 1)}
    if calib_row["calibration_coverage"] < 0.9:
        raise AssertionError(f"{leg}: calibration coverage {calib_row}")
    if inter:
        stats = infer._int8_interlayer_stats
        n_req = sum(1 for op in int8_ops if op.inputs.get("OutScale"))
        nz = sum(1 for v in act_scales.values() if v > 0)
        calib_row.update(
            n_requant_epilogues=n_req,
            n_partial_folds=stats.get("n_partial_folds", 0),
            interlayer_fold_coverage=n_req / max(len(int8_ops), 1),
            n_int8_inputs=stats.get("n_int8_inputs", 0),
            boundary_scale_coverage=nz / max(len(act_scales), 1))
        if n_req != stats.get("n_edges_folded") or \
                calib_row["interlayer_fold_coverage"] < 0.5 or \
                calib_row["boundary_scale_coverage"] < 0.9:
            raise AssertionError(f"{leg}: interlayer coverage {calib_row} "
                                 f"{stats}")
    return infer, scope, fetch, exe, calib_row


def int8_leg(leg, seed, device):
    """One int8 leg (``int8_program``) with the bench's coverage numbers,
    timed at its batch, checked against the CPU.  Returns (launches, row,
    int8_op_shapes of the program at its batch, in the run's dtypes)."""
    _, batch, side = INFER_LEGS[leg]
    t0 = time.perf_counter()
    infer, scope, fetch, exe, calib_row = int8_program(leg, seed, device)
    ops = infer.global_block().ops
    int8_ops = [op for op in ops if op.type.endswith("_int8")]
    log(f"{leg}: {len(ops)} ops, calibration {json.dumps(calib_row)}, "
        f"built in {time.perf_counter() - t0:.1f} s")
    feed = infer_feed(infer, seed, batch, side, device)
    # every int8 op on the wgmma route; each one with a float x quantises
    # it through quantize_act
    n_float_x = sum(count for key, count in int8_op_shapes(infer,
                                                           batch).items()
                    if key[11] != "int8")
    launches, row = time_infer(
        leg, exe, infer, feed, fetch, scope,
        expected_counts(conv_int8=len(int8_ops) * INFER_RUNS,
                        quantize_act=n_float_x * INFER_RUNS,
                        **{I8_WGMMA: len(int8_ops) * INFER_RUNS}))
    row["calibration"] = calib_row
    row["vs_cpu"] = check_int8_vs_cpu(leg, exe, infer, scope, fetch, seed,
                                      side)
    row["ops"] = len(ops)
    return launches, row, int8_op_shapes(infer, batch, scope)


def predictor_leg(seed, device, workdir):
    """ResNet-50 through save_inference_model -> Config(dir) with
    enable_mkldnn_bfloat16 -> create_predictor -> run on the card (the
    Predictor's ir_optim folds conv+bn), timed at the bench's batch, and
    a batch-2 request held against the f32 CPU Predictor of the same
    model (the planted fault: the last folded shift zeroed there)."""
    import ml_dtypes
    import torch

    import paddle_tpu_torch as pt

    name, batch, side = INFER_LEGS["predictor"]
    fetch, main, startup = build_infer_model(name, side)
    scope = init_infer_scope(main, startup, seed, device, side)
    with pt.scope_guard(scope):
        pt.io.save_inference_model(workdir, ["image"], [fetch],
                                   pt.Executor(pt.CUDAPlace(0)),
                                   main_program=main)
    cfg = pt.inference.Config(workdir)
    cfg.enable_mkldnn_bfloat16()
    pred = pt.inference.create_predictor(cfg)
    types = [op.type for op in pred._program.global_block().ops]
    log(f"predictor on {pred.device}: {len(types)} ops, "
        f"{types.count('batch_norm')} batch_norm left after ir_optim")
    image = np.random.RandomState(seed + 13).rand(
        batch, 3, side, side).astype(ml_dtypes.bfloat16)

    def interpreted():
        return pred._exe.run(pred._program, feed={"image": image},
                             fetch_list=pred._fetch_vars,
                             scope=pred._scope)[0]

    interpreted()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    outs, walls, events = timed(interpreted, INFER_RUNS, np.array)
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = kernel_counts()
    if launches != expected_counts():
        raise AssertionError(f"predictor launched {launches}")
    row = dict(batch=batch, event_ms=events, wall_ms=walls,
               images_per_s=batch * len(walls) / sum(walls) * 1e3,
               ops=len(types))
    log("predictor " + json.dumps(row))
    again = np.array(interpreted())
    # the same requests through Predictor.run: one capture, then replays
    couts, crow = compiled_window(
        "predictor", pred._compiled, lambda: pred.run([image])[0],
        INFER_RUNS, launches, pred._scope,
        [v.name for v in pred._program.persistables() if not v.is_data],
        prepare=lambda: pred.run([image]), keep=np.array)
    hold = hold_to_interpreted("predictor", {"logits": (
        outs, [[again] * INFER_RUNS], couts)},
        another=lambda: {"logits": [np.array(interpreted())] * INFER_RUNS})
    prof, cprof, pairs, records = profile_pair(
        "predictor", "predictor request", interpreted,
        lambda: pred.run([image]), per_call(launches, INFER_RUNS))
    row["compiled"] = record_compiled(
        "predictor", (dict(wall_ms=walls, event_ms=events,
                           peak_mem_gb=peak), prof), (crow, cprof), hold,
        pairs, records)
    cpu_cfg = pt.inference.Config(workdir)
    cpu_cfg.disable_gpu()
    cpu_pred = pt.inference.create_predictor(cpu_cfg)
    small = image[:CHECK_BATCH]
    card = np.asarray(pred.run([small])[0], np.float32)
    ref = np.asarray(cpu_pred.run([small.astype(np.float32)])[0],
                     np.float32)
    shift = next(n for op in reversed(cpu_pred._program.global_block().ops)
                 for n in op.input_names() if "bn_folded_bias" in n)
    var = cpu_pred._scope.find_var(shift)
    var.set(torch.zeros_like(var.get()))
    fault = np.asarray(cpu_pred.run([small.astype(np.float32)])[0],
                       np.float32)
    check = bf16_agreement("predictor", card, ref, fault)
    check["planted_fault"] = shift
    log("predictor card vs CPU " + json.dumps(check))
    row["vs_cpu"] = check
    return launches, row


# ---------------------------------------------------------------------------
# the s8 kernel and #5 at the inference legs' shapes
# ---------------------------------------------------------------------------

# (out dtype, bias, residual, relu, OutScale): every epilogue subset the
# kernel takes, as tests/test_torch_cuda.py's I8_EPILOGUES
# images of the subset sweep of check_conv_int8 (every int8 shape with
# every subset of I8_SUBSETS): once 128, where its host draws took most
# of the phase's ~100 s; the legs' own (shape, subset) pairs stay
# held at the legs' batch in the timed rows
I8_SWEEP_BATCH = 16
I8_SUBSETS = [
    ("int32", None, None, False, False),
    ("float32", None, None, False, False),
    ("bfloat16", "float32", None, True, False),
    ("bfloat16", "bfloat16", "bfloat16", True, False),
    ("float32", "bfloat16", "float32", False, False),
    ("bfloat16", "float32", "bfloat16", True, True),
    ("float32", None, None, False, True),
]


def int8_op_shapes(program, batch, scope=None):
    """{(N, H, W, Cin, Cout, K, stride, pad, dilation, groups, subset,
    x's dtype): launches a batch} of a converted program's int8 ops, NHWC;
    mul_int8 as a 1x1 convolution over [M, 1, 1, K].  The dtypes of x,
    Bias and Residual are those of ``scope``'s tensors after a run where
    it is given, else the program's vars'."""
    block = program.global_block()

    def dtype(slot, op):
        names = op.inputs.get(slot)
        if not names:
            return None
        var = scope.find_var(names[0]) if scope is not None else None
        if var is not None and var.get() is not None:
            return str(var.get().dtype).replace("torch.", "")
        return block.var(names[0]).dtype

    out = {}
    for op in block.ops:
        if op.type == "conv2d_int8":
            _, h, w, cin = block.var(op.inputs["Input"][0]).shape
            cout, _, k, _ = block.var(op.inputs["Filter"][0]).shape
            a = op.attrs
            geo = (batch, h, w, cin, cout, k, a["strides"][0],
                   a["paddings"][0], a["dilations"][0], a["groups"])
            x_dtype = dtype("Input", op)
        elif op.type == "mul_int8":
            k, n = block.var(op.inputs["Y"][0]).shape
            geo = (batch, 1, 1, k, n, 1, 1, 0, 1, 1)
            x_dtype = dtype("X", op)
        else:
            continue
        a = op.attrs
        subset = (a["out_dtype"], dtype("Bias", op), dtype("Residual", op),
                  bool(a.get("fuse_relu")), bool(op.inputs.get("OutScale")))
        key = geo + (subset, str(x_dtype))
        out[key] = out.get(key, 0) + 1
    return out


def int8_times(n, h, w, cin, cout, k, s, p, d, g, subset):
    """(bytes ms, operations ms) of one s8 convolution: the pixels of x
    its windows touch (1 byte), w once, the output written once (int32 4,
    f32 4, bf16 2, int8 1 bytes) and the residual read once; 2*M*Cout*K
    operations at the dense s8 peak."""
    out, bias, res, _, outscale = subset
    oh = (h + 2 * p - (k - 1) * d - 1) // s + 1
    ow = (w + 2 * p - (k - 1) * d - 1) // s + 1
    m, kk = n * oh * ow, k * k * cin // g
    pixels = n * h * w if k >= s else n * min(h, oh * k) * min(w, ow * k)
    elem = {"int32": 4, "float32": 4, "bfloat16": 2}
    dt_out = 1 if outscale else elem[out]
    if bias and not outscale and out != "int32":
        dt_out = 4 if "float32" in (out, bias) else 2
    nbytes = pixels * cin + cout * kk + m * cout * dt_out + \
        (m * cout * elem[res] if res else 0)
    return (nbytes / PEAK_BYTES_PER_S * 1e3,
            2.0 * m * cout * kk / PEAK_INT8_OPS * 1e3)


def check_conv_int8(device, seed, shapes):
    """conv_int8 against its plain version, torch.equal, at every
    distinct shape of ``shapes`` (the int8 legs' ops, the cifar nets'
    convolutions) over I8_SWEEP_BATCH images with every epilogue subset of
    I8_SUBSETS and every one ``shapes`` has there; then, at each (shape,
    subset) the legs run, at the legs' batch and held torch.equal there
    too, its times by graph replay and by events beside the plain
    version and two library calls on the same shape: torch._int_mm (the
    same s8 product in cuBLASLt) on an explicit im2col, made outside the
    timing, and cuDNN's channels-last bf16 convolution, which the bf16
    legs pay; the timed operands are held to the plain version too (the
    row's max_abs_err).  Returns one row per (shape, subset)."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import quant as Q

    def int8_case(rng, geo, subset):
        n, h, w, cin, cout, k, s, p, d, g = geo
        gen = device_generator(rng, device)
        x8 = torch.randint(-127, 128, (n, h, w, cin), generator=gen,
                           device=device, dtype=torch.int8)
        wt = torch.randint(-127, 128, (cout, cin // g, k, k), generator=gen,
                           device=device, dtype=torch.int8)
        oh = (h + 2 * p - (k - 1) * d - 1) // s + 1
        ow = (w + 2 * p - (k - 1) * d - 1) // s + 1
        ops = int8_operands(rng, device, (n, oh, ow, cout), subset)
        conv = dict(strides=(s, s), paddings=(p, p), dilations=(d, d),
                    groups=g)
        return x8, wt, ops, conv

    def held(x8, wt, ops, conv, acc, where):
        """The kernel's output against the plain version's: raises unless
        torch.equal; returns max |got - want|."""
        got = Q.conv_int8(x8, wt, **ops, **conv)
        want = Q._epilogue_plain(
            acc, ops["alpha"], ops["colscale"], ops["out_dtype"],
            ops["bias"], ops["residual"], ops["relu"], ops["out_scale"],
            127.0)
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"conv_int8 differs from its plain version "
                                 f"at {where}")
        return float((got.double() - want.double()).abs().max())

    def plain_acc(x8, wt, conv):
        return Q._conv_acc_plain(x8, wt, conv["strides"], conv["paddings"],
                                 conv["dilations"], conv["groups"])

    rng = np.random.RandomState(seed + 17)
    geos = sorted({key[:10] for key in shapes})
    n_checked = 0
    for geo in geos:
        subsets = list(I8_SUBSETS)
        subsets += sorted({key[10] for key in shapes if key[:10] == geo
                           and key[10] not in subsets}, key=str)
        sweep = (I8_SWEEP_BATCH,) + geo[1:]
        x8, wt, _, conv = int8_case(rng, sweep, I8_SUBSETS[0])
        acc = plain_acc(x8, wt, conv)
        shape = (sweep[0], acc.shape[1], acc.shape[2], geo[4])
        for subset in subsets:
            held(x8, wt, int8_operands(rng, device, shape, subset), conv,
                 acc, f"{sweep} {subset}")
            n_checked += 1
        del acc
    log(f"conv_int8 torch.equal to its plain version over {len(geos)} "
        f"shapes at {I8_SWEEP_BATCH} images x {len(I8_SUBSETS)} epilogue "
        f"subsets and the legs' own ({n_checked} cases)")

    rows = []
    for key, count in sorted(shapes.items(), key=lambda kv: str(kv[0])):
        n, h, w, cin, cout, k, s, p, d, g = key[:10]
        subset, x_dtype = key[10], key[11]
        if count == 0:
            continue
        x8, wt, ops, conv = int8_case(rng, key[:10], subset)
        acc = plain_acc(x8, wt, conv)
        err = held(x8, wt, ops, conv, acc, f"{key} (timed operands)")
        del acc
        route = Q.kernel_route(cin // g, g, (s, s), (d, d))
        if g == 1 and route == "mma_sync":
            raise AssertionError(f"conv_int8: {key} would not take wgmma")

        def kernel():
            return Q.conv_int8(x8, wt, **ops, **conv)

        def first_kernel():
            return Q.conv_int8(x8, wt, **ops, **conv, route="mma_sync")

        # the first design (the parent's kernel), kept callable: its bits
        if not torch.equal(kernel(), first_kernel()):
            raise AssertionError(f"conv_int8 on {route} differs from the "
                                 f"mma.sync kernel at {key}")

        # the library calls' operands, made outside their timing
        cols = F.unfold(x8.permute(0, 3, 1, 2).float(), (k, k),
                        dilation=d, padding=p, stride=s)
        kk = cols.shape[1]
        a_mat = cols.transpose(1, 2).reshape(-1, kk)
        kpad, npad = -kk % 8, -cout % 8
        a_mat = F.pad(a_mat, (0, kpad)).to(torch.int8).contiguous()
        b_mat = F.pad(wt.reshape(cout, -1).float(), (0, kpad, 0, npad)).to(
            torch.int8).contiguous().t()
        del cols
        xb = x8.permute(0, 3, 1, 2).to(torch.bfloat16)
        wb = wt.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)

        def int_mm():
            return torch._int_mm(a_mat, b_mat)

        def cudnn():
            return F.conv2d(xb, wb, stride=s, padding=p, dilation=d,
                            groups=g)

        bound, bound_by = bound_of(int8_times(n, h, w, cin, cout, k, s, p,
                                              d, g, subset))
        row = dict(shape=[n, h, w, cin, cout, k, s, p, d, g],
                   epilogue=list(subset), x_int8=x_dtype == "int8",
                   x_dtype=x_dtype, per_batch=count,
                   max_abs_err=err, route=route,
                   ms=graph_ms(kernel, 10), event_ms=cuda_ms(kernel, 10),
                   mma_sync_ms=graph_ms(first_kernel, 10),
                   plain_ms=cuda_ms(lambda: Q.conv_int8_plain(
                       x8, wt, **ops, **conv), 1, warmup=1),
                   int_mm_ms=graph_ms(int_mm, 10),
                   cudnn_bf16_ms=graph_ms(cudnn, 10),
                   bound_ms=bound, bound_by=bound_by)
        row["bound_share"] = bound / row["ms"]
        log("conv_int8 case " + json.dumps(row))
        rows.append(row)
        del x8, wt, a_mat, b_mat, xb, wb
    torch.cuda.empty_cache()
    return rows


def quantize_times(numel, dtype):
    """(bytes ms, operations ms) of quantize_act on ``numel`` elements:
    each read once (f32 4, bf16 2 bytes) and written once as int8; the
    operations (a division, a product, a rounding) are far below the
    card's rate, so 0."""
    item = 4 if dtype == "float32" else 2
    return numel * (item + 1) / PEAK_BYTES_PER_S * 1e3, 0.0


def check_quantize_act(device, seed, shapes):
    """quantize_act torch.equal to its plain version at every int8 op's
    float input of ``shapes`` (int8_op_shapes keys of the legs: x NHWC, or
    mul_int8's [M, K] as [M, 1, 1, K]), with saturation among the values
    (x * 40 over sx 20-60); each shape timed by graph replay and by events
    beside the plain version (the PyTorch passes the int8 ops ran
    before).  Returns one row per (shape, dtype)."""
    import torch

    from paddle_tpu_torch.ops import quant as Q

    rng = np.random.RandomState(seed + 23)
    xs = {}
    for key, count in shapes.items():
        if key[11] == "int8":
            continue
        x_key = (key[0], key[1], key[2], key[3], key[11])
        xs[x_key] = xs.get(x_key, 0) + count
    rows = []
    for (n, h, w, c, dtype), count in sorted(xs.items()):
        g = torch.Generator(device=device)
        g.manual_seed(int(rng.randint(1 << 30)))
        x = (torch.randn((n, h, w, c), generator=g, device=device) * 40.0)
        x = x.to(getattr(torch, dtype))
        sx = torch.tensor(float(rng.uniform(20.0, 60.0)), device=device)
        got = Q.quantize_act(x, sx, 127.0)
        want = Q.quantize_act_plain(x, sx, 127.0)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"quantize_act differs from its plain "
                                 f"version at {(n, h, w, c, dtype)}")
        bound, bound_by = bound_of(quantize_times(x.numel(), dtype))
        row = dict(shape=[n, h, w, c], dtype=dtype, per_batch=count,
                   max_abs_err=0.0,
                   saturated_share=float((got.abs() == 127).float().mean()),
                   ms=graph_ms(lambda: Q.quantize_act(x, sx, 127.0), 10),
                   event_ms=cuda_ms(lambda: Q.quantize_act(x, sx, 127.0),
                                    10),
                   plain_ms=graph_ms(
                       lambda: Q.quantize_act_plain(x, sx, 127.0), 10),
                   bound_ms=bound, bound_by=bound_by)
        row["bound_share"] = bound / row["ms"]
        log("quantize_act case " + json.dumps(row))
        rows.append(row)
        del x, got, want
    log(f"quantize_act torch.equal to its plain version at {len(rows)} "
        "shapes")
    return rows


def int8_operands(rng, device, shape, subset):
    """Random epilogue operands of ``subset`` for an output of ``shape``
    (NHWC), as conv_int8 takes them."""
    import torch

    out, bias, res, relu, outscale = subset
    cout = shape[3]
    gen = device_generator(rng, device)

    def make(dtype, shp):
        if dtype is None:
            return None
        return torch.randn(shp, generator=gen, device=device).to(
            getattr(torch, dtype))

    return dict(
        alpha=torch.tensor(rng.uniform(1e-6, 1e-5), dtype=torch.float32,
                           device=device),
        colscale=torch.from_numpy(rng.uniform(0.5, 2.0, cout).astype(
            np.float32)).to(device),
        bias=make(bias, (cout,)), residual=make(res, shape), relu=relu,
        out_scale=torch.tensor([rng.uniform(1.0, 3.0)], dtype=torch.float32,
                               device=device) if outscale else None,
        out_dtype=getattr(torch, out))


def cifar_int8_shapes(batch):
    """The s8 shapes of ResNet-32 on cifar at ``batch`` (its convolutions
    and fc, with bf16 out, bias and relu, as the int8 conversion gives
    them), for the kernel check: built, folded and converted with
    stand-in weights on the CPU."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib.slim import quantization as slim

    fetch, main, startup = build_infer_model("resnet32_cifar", 32)
    scope = pt.Scope()
    np.random.seed(0)
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    infer = main.clone(for_test=True)
    pt.transpiler.InferenceTranspiler().transpile(infer, scope=scope,
                                                  protected=[fetch])
    pt.transpiler.nhwc_transpile(infer)
    qw = slim.quantize_weights_abs_max(infer, scope)
    slim.convert_to_int8_execution(infer, scope, qw, out_dtype="bfloat16",
                                   int8_activations=False,
                                   protected=[fetch])
    return {key: 0 for key in int8_op_shapes(infer, batch)}


def conv_epilogue_infer_rows(device, seed, program, batch):
    """#5 at the fused inference graph's shapes (bias, residual and relu
    stages) at ``batch`` in bf16: each distinct (shape, stages) timed by
    graph replay and by events, held to its plain version, beside cuDNN's
    channels-last conv with the same adds and relu.  One row each."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import conv_epilogue as cep

    block = program.global_block()
    shapes = {}
    for op in block.ops:
        if op.type != "conv2d_epilogue":
            continue
        _, h, w, cin = block.var(op.inputs["Input"][0]).shape
        cout, _, k, _ = block.var(op.inputs["Filter"][0]).shape
        key = (h, w, cin, cout, k, op.attrs["strides"][0],
               op.attrs["paddings"][0], op.attrs["epilogue"])
        shapes[key] = shapes.get(key, 0) + 1
    rng = np.random.RandomState(seed + 19)
    rows = []
    for (h, w, cin, cout, k, s, p, spec), count in sorted(shapes.items()):
        x, wt = conv_operands(rng, device, batch, h, w, cin, cout, k,
                              "bfloat16")
        oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        bias = torch.randn(cout, device=device).to(torch.bfloat16)
        res = torch.randn((batch, oh, ow, cout), device=device).to(
            torch.bfloat16) if "residual" in spec else None
        act = "relu" if "relu" in spec else ""
        pad = ((p, p), (p, p))
        args = (x, wt, bias, res, (s, s), pad, act)
        got = cep.conv_epilogue_kernel(*args)
        torch.cuda.synchronize()
        err = scaled_err(got, cep.conv_epilogue_plain(*args))
        if err > CONV_TOL["bfloat16"]:
            raise AssertionError(f"conv_epilogue disagrees with its plain "
                                 f"version at {(h, w, cin, cout, k, s, p)} "
                                 f"{spec}: {err:.3e}")
        xn = x.permute(0, 3, 1, 2)
        w_cl = wt.contiguous(memory_format=torch.channels_last)

        def library():
            y = F.conv2d(xn, w_cl, stride=s, padding=p) + bias[:, None,
                                                               None]
            if res is not None:
                y = y + res.permute(0, 3, 1, 2)
            return torch.relu(y) if act else y

        t_bytes, t_ops = conv_times(batch, h, w, cin, cout, k, s, p)
        t_bytes += (res.numel() * 2 if res is not None else 0) / \
            PEAK_BYTES_PER_S * 1e3
        bound, bound_by = bound_of((t_bytes, t_ops))
        row = dict(shape=[batch, h, w, cin, cout, k, s, p], epilogue=spec,
                   per_batch=count, scaled_err=err,
                   ms=graph_ms(lambda: cep.conv_epilogue_kernel(*args), 10),
                   event_ms=cuda_ms(lambda: cep.conv_epilogue_kernel(*args),
                                    10),
                   plain_ms=cuda_ms(lambda: cep.conv_epilogue_plain(*args),
                                    1, warmup=1),
                   library_ms=graph_ms(library, 10), bound_ms=bound,
                   bound_by=bound_by)
        log("conv_epilogue inference case " + json.dumps(row))
        rows.append(row)
        del x, wt, res
    return rows


def infer_phases(device, seed, workdir):
    """Phases 15-18: the bench's six inference legs, the infer leg's
    lever and the Predictor, each driven with every count set to 0 just
    before and read just after; then the s8 kernel, the activations'
    quantisation and #5 at their shapes.  Returns ({leg: launches}, {leg:
    row}, conv_int8 rows, quantize_act rows, #5 inference rows)."""
    import torch

    launches, rows, programs = {}, {}, {}
    laps, t = {}, time.perf_counter()

    def lap(what):
        nonlocal t
        laps[what] = time.perf_counter() - t
        t = time.perf_counter()

    for leg in ("infer", "infer_convep", "vgg_infer", "vgg_cifar",
                "rn32_cifar"):
        launches[leg], rows[leg], programs[leg] = bf16_leg(leg, seed,
                                                           device)
        torch.cuda.empty_cache()
        lap(leg)
    leg_shapes = {}
    for leg in ("infer_i8", "infer_i8_inter"):
        launches[leg], rows[leg], leg_shapes[leg] = int8_leg(leg, seed,
                                                             device)
        torch.cuda.empty_cache()
        lap(leg)
    launches["predictor"], rows["predictor"] = predictor_leg(
        seed, device, workdir)
    lap("predictor")
    shapes = {}
    for leg, counts in leg_shapes.items():
        for key, count in counts.items():
            shapes.setdefault(key, {})[leg] = count
    i8_counts = {key: max(c.values()) for key, c in shapes.items()}
    i8_counts.update({k: 0 for k in cifar_int8_shapes(
        INFER_LEGS["rn32_cifar"][1]) if k not in i8_counts})
    i8_rows = check_conv_int8(device, seed, i8_counts)
    for row in i8_rows:
        key = tuple(row["shape"]) + (tuple(row["epilogue"]), row["x_dtype"])
        row["per_batch_by_leg"] = shapes.get(key, {})
    q_rows = check_quantize_act(device, seed, i8_counts)
    for row in q_rows:
        row["per_batch_by_leg"] = {leg: sum(
            count for key, count in counts.items()
            if list(key[:4]) == row["shape"] and key[11] == row["dtype"])
            for leg, counts in leg_shapes.items()}
    lap("conv_int8 and quantize_act at their shapes")
    ep_rows = conv_epilogue_infer_rows(device, seed,
                                       programs["infer_convep"],
                                       INFER_LEGS["infer_convep"][1])
    lap("conv_epilogue at the lever's shapes")
    log("inference seconds " + json.dumps(laps))
    return launches, rows, i8_rows, q_rows, ep_rows


# the port's kernel functions (csrc/), in a demangled name (after "::")
# or a mangled one (after its length)
# ---------------------------------------------------------------------------
# phases 19-21: the bench's other training legs — long context, BERT-base,
# DeepFM
# ---------------------------------------------------------------------------

# the bench's longctx and longctx_d128 legs (bench.py:998-1046): batch 1,
# 8 heads, 32768 tokens, d 64 and 128, bf16, causal; each step launches
# the forward twice (once more in its grad), dq and dkv once
LONGCTX = dict(batch=1, heads=8, seq=32768)
LONGCTX_LEGS = (("longctx", 64), ("longctx_d128", 128))
# The CPU comparison's shape.  The plain attention of the CPU run holds a
# [T, T] f32 score matrix a head (4 GiB at 32768 tokens, and its grads
# several more) and would take many minutes, so the path is held to the
# CPU at 1024 tokens and 2 heads.  Outputs are bf16 on both: out within
# TOL's bf16 bound, each grad within BWD_TOL's of max(1, its scale), the
# loss (a sum of bf16 values) within one bf16 step of the sum of |out|.
LONGCTX_CPU = dict(batch=1, heads=2, seq=1024)


@contextlib.contextmanager
def flash_layout_flags():
    """The longctx leg sets the flags of the JAX kernels' Mosaic layouts
    explicitly (bench.py:1020-1021): "off".  The port's kernels ignore
    them."""
    from paddle_tpu_torch.flags import set_flags

    flags = {"flash_packed_stats": "off", "flash_head_pack": "off"}
    set_flags(flags)
    try:
        yield
    finally:
        set_flags(flags)


def build_longctx_program(heads, seq, d):
    """The bench's long-context step (bench.py _build_longctx_train), in
    programs of its own: q, k, v bf16 data vars that take grads,
    flash_attention causal, loss = reduce_sum(cast(out, f32)),
    append_backward.  Returns (out, loss, main, startup)."""
    import paddle_tpu_torch as pt

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        qkv = []
        for n in "qkv":
            x = pt.layers.data(n, shape=[heads, seq, d], dtype="bfloat16")
            x.stop_gradient = False
            qkv.append(x)
        out = pt.layers.flash_attention(*qkv, causal=True)
        loss = pt.layers.reduce_sum(pt.layers.cast(out, "float32"))
        pt.backward.append_backward(loss)
    return out, loss, main, startup


def longctx_feed(seed, b, h, t, d, device):
    """The bench's feed (unit normals rounded to bf16), made in bulk with
    torch from the seed, on ``device``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return {n: torch.randn((b, h, t, d), generator=gen).to(
        device=device, dtype=torch.bfloat16) for n in "qkv"}


def longctx_cpu_check(seed, d, device):
    """The long-context program at LONGCTX_CPU on the card and on the
    CPU: out, the loss and q/k/v@GRAD."""
    import torch

    import paddle_tpu_torch as pt

    b, h, t = (LONGCTX_CPU[k] for k in ("batch", "heads", "seq"))
    out, loss, main, startup = build_longctx_program(h, t, d)
    fetch = [out.name, loss.name] + [f"{n}@GRAD" for n in "qkv"]
    feed = longctx_feed(seed + 1, b, h, t, d, "cpu")
    got = {}
    for name, place in (("gpu", pt.CUDAPlace(0)), ("cpu", pt.CPUPlace())):
        exe = pt.Executor(place)
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        got[name] = [x.float().cpu() for x in exe.run(
            main, feed=feed, fetch_list=fetch, scope=scope,
            return_numpy=False)]
    (g_out, g_loss, *g_grads), (c_out, c_loss, *c_grads) = \
        got["gpu"], got["cpu"]
    res = {"shape": [b, h, t, d],
           "out_err": (g_out - c_out).abs().max().item(),
           "out_bound": TOL["bfloat16"]["out"] * max(
               1.0, c_out.abs().max().item()),
           "loss_gpu": g_loss.item(), "loss_cpu": c_loss.item(),
           "loss_err": abs(g_loss.item() - c_loss.item()),
           "loss_bound": 2.0 ** -8 * c_out.abs().sum().item(),
           "grad_errs": [(g - c).abs().max().item()
                         for g, c in zip(g_grads, c_grads)],
           "grad_bounds": [BWD_TOL["bfloat16"] * max(
               1.0, c.abs().max().item()) for c in c_grads]}
    ok = res["out_err"] <= res["out_bound"] and \
        res["loss_err"] <= res["loss_bound"] and all(
            e <= bd for e, bd in zip(res["grad_errs"], res["grad_bounds"]))
    del feed
    torch.cuda.empty_cache()
    return res, ok


def longctx_leg(seed, what, d, device):
    """One long-context leg through the Executor: one warm-up and
    TRAIN_STEPS counted steps (2 forward, 1 dq and 1 dkv launches a
    step, no input copy), each step's fetches (the loss, q/k/v@GRAD)
    torch.equal to a direct call of the port's flash autograd Function
    on the same inputs (its loss reduced as reduce_sum reduces it);
    the step beside SDPA's forward + backward at the shape; the compiled
    pass as in ``train``; then the program at LONGCTX_CPU on the card
    against the CPU."""
    import torch
    import torch.nn.functional as F

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import flash_attention as fa

    b, h, t = (LONGCTX[k] for k in ("batch", "heads", "seq"))
    _, loss, main, startup = build_longctx_program(h, t, d)
    fetch = [loss.name] + [f"{n}@GRAD" for n in "qkv"]
    feed = longctx_feed(seed, b, h, t, d, device)
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    exe.run(startup, scope=scope)

    def step(program=main):
        return exe.run(program, feed=feed, fetch_list=fetch, scope=scope,
                       return_numpy=False)

    with flash_layout_flags():
        step()                                   # warm-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        runs, walls, events = timed(step, TRAIN_STEPS)
        launches = kernel_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
    want = expected_counts(flash_attention_fwd=2 * TRAIN_STEPS,
                           flash_attention_bwd_dq=TRAIN_STEPS,
                           flash_attention_bwd_dkv=TRAIN_STEPS)
    log(f"kernel launches over {TRAIN_STEPS} {what} steps: {launches}")
    if launches != want:
        raise AssertionError(f"{what} launched {launches}, expected {want}")

    # the direct call: the same inputs through the autograd Function
    leaves = [feed[n].detach().requires_grad_() for n in "qkv"]
    out, _ = fa.flash_attention_lse(*leaves, causal=True)
    direct_loss = torch.sum(out.float(), dim=(0, 1, 2, 3))
    direct = [direct_loss.detach()] + list(torch.autograd.grad(
        direct_loss, leaves))
    del out, leaves
    unequal = [i for i, run in enumerate(runs)
               if not all(torch.equal(x, y) for x, y in zip(run, direct))]
    if unequal:
        raise AssertionError(f"{what}: the fetches of steps {unequal} are "
                             f"not torch.equal to the direct call's")

    def sdpa_step():
        qs, ks, vs = (feed[n].detach().requires_grad_() for n in "qkv")
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        torch.autograd.grad(o, (qs, ks, vs), torch.ones_like(o))

    def direct_step():
        qs, ks, vs = (feed[n].detach().requires_grad_() for n in "qkv")
        o, _ = fa.flash_attention_lse(qs, ks, vs, causal=True)
        torch.autograd.grad(o, (qs, ks, vs), torch.ones_like(o))

    sdpa_ms = cuda_ms(sdpa_step, 5, warmup=2)
    function_ms = cuda_ms(direct_step, 5, warmup=2)
    flops = 3 * 2.0 * b * h * float(t) ** 2 * d      # the bench's count
    training = dict(steps=TRAIN_STEPS, shape=[b, h, t, d], step_ms=walls,
                    step_event_ms=events,
                    tokens_per_s=TRAIN_STEPS * b * t / sum(walls) * 1e3,
                    bench_mfu=flops / (np.mean(walls) / 1e3)
                    / PEAK_FLOPS["bfloat16"],
                    function_fwd_bwd_event_ms=function_ms,
                    sdpa_fwd_bwd_event_ms=sdpa_ms,
                    max_memory_allocated_gb=peak,
                    fetches_equal_direct_call=True)
    log(f"{what} " + json.dumps(training))

    # the compiled pass: the same steps, held to two interpreted runs
    with flash_layout_flags():
        run_b = step()
        compiled = pt.CompiledProgram(main)
        c_runs, crow = compiled_window(what, compiled,
                                       lambda: step(compiled), TRAIN_STEPS,
                                       launches)
        hold = hold_to_interpreted(what, {"fetches": (
            runs[-1], [run_b], c_runs[-1])})
        if not all(all(torch.equal(x, y) for x, y in zip(c, direct))
                   for c in c_runs):
            raise AssertionError(f"compiled {what}: the fetches are not "
                                 f"torch.equal to the direct call's")
        prof, cprof, pairs, records = profile_pair(
            what, f"{what} step", step, lambda: step(compiled),
            per_call(launches, TRAIN_STEPS))
    record_compiled(what, (dict(wall_ms=walls, event_ms=events,
                                peak_mem_gb=peak), prof), (crow, cprof),
                    hold, pairs, records)
    del compiled, runs, run_b, c_runs, direct, feed
    torch.cuda.empty_cache()

    cpu, ok = longctx_cpu_check(seed, d, device)
    training["vs_cpu"] = cpu
    log(f"{what} GPU vs CPU " + json.dumps(cpu))
    if not ok:
        raise AssertionError(f"the GPU {what} step disagrees with the CPU "
                             "run")
    return launches, training


# BERT-base on the card against the CPU at batch 2, AMP.  A second CPU run
# of the same model in f32 (no AMP: the same weights, grads and updates by
# name) shows how far bf16 rounding moves this step; two runs that round
# at other points sit about that far apart, so the GPU run is held
# norm-wise within BERT_SPREAD_FACTOR times that run's metrics, or the
# floor where that is larger (the AMP LM's bars: a wrong kernel is off by
# the size of what it computes), and so is each grad's norm error against
# its own in that run.  At batch 2 from random weights the attention is
# near uniform and the q/k grads are differences of near-equal bf16 terms,
# mostly rounding: the f32 run reads their norm error ~1.0 against the
# CPU's AMP run, the card's 1.2-1.76; the other grads read below 0.03 on
# both (PERF.md §6).  A CPU run with oneDNN off (torch's own bf16
# products) took 13 minutes, so it is not the reference.
BERT_SPREAD_FACTOR = 3.0
BERT_FLOORS = dict(loss=AMP_LOSS_RTOL, norm=AMP_GRAD_NORM_RTOL,
                   update=AMP_GRAD_NORM_RTOL)
# BERT-base's batch-2 step in f32 (TF32 off) on the card against the
# CPU's f32 step, which the AMP check above also takes as its reference:
# in f32 the q/k weight grads carry signal (the f32 flash kernels hold
# against f64 to ~1e-6, phases 2 and 4).  The bound of each metric, and of
# each grad's norm error, is BERT_SPREAD_FACTOR x its distance between the
# CPU's f32 run and an f64 run of the same program (every f32 tensor of
# the scope cast to f64 after the startup), or its floor: f32 rounding is
# ~1e-7 of a grad's norm, a zeroed 64-row tile of dq or dk (PLANTED_ROWS,
# the planted faults) tens of percent of the q or k weight grads'.
BERT_F32_FLOORS = dict(loss=LOSS_RTOL, norm=1e-3, update=1e-2)
PLANTED_ROWS = 64
# DeepFM (bench.py _build_deepfm_train): 26 fields, vocab 100000, embed 16,
# dense 13, hidden (400, 400, 400), dense lookups, f32 Adam(1e-3) at batch
# 2048 on the bench's rng feeds; no hand kernel is on its path (the JAX
# package's step is XLA's alone).  At batch 2 on the card against the CPU
# in f32 (TF32 off), as phase 5: the loss and each grad's bulk within
# LOSS_RTOL and GRAD_BULK_RTOL, its max within one example's share (a
# ReLU input within rounding of 0 flips one example's contribution), and
# the parameters within 2 * lr a step.
DEEPFM = dict(num_fields=26, vocab_size=100_000, embed_dim=16, dense_dim=13,
              hidden=(400, 400, 400), is_sparse=False)
DEEPFM_BATCH = 2048
DEEPFM_LR = 1e-3


def build_bert_program(amp=True):
    """BERT-base in training mode under the bench's AMP (or in f32), in
    programs of its own."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    from paddle_tpu_torch.models.bert import bert_model

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        model = bert_model(**BERT)
        opt = pt.optimizer.Adam(BERT_LR)
        if amp:
            opt = decorate(opt, init_loss_scaling=1.0,
                           use_dynamic_loss_scaling=False)
        _, params_grads = opt.minimize(model["loss"])
    return model, main, startup, params_grads


def bert_expected(types, steps):
    """Per step: each layer's flash forward twice (once more in its
    grad), dq and dkv once; no other kernel."""
    n = types.count("flash_attention")
    return expected_counts(flash_attention_fwd=2 * n * steps,
                           flash_attention_bwd_dq=n * steps,
                           flash_attention_bwd_dkv=n * steps)


def bert_mfu(tokens_per_s):
    """The bench's MFU (bench.py:517-533): 6N + 12 L d s FLOPs a token,
    N counting the embeddings, the layers and the untied decoder, over
    the card's dense bf16 peak."""
    d, n_layer, d_inner, vocab, seq = (BERT[k] for k in (
        "d_model", "n_layer", "d_inner", "vocab_size", "max_len"))
    n_params = (vocab * d + seq * d + 2 * d
                + n_layer * (4 * d * d + 2 * d * d_inner) + d * vocab)
    fpt = 6.0 * n_params + 12.0 * n_layer * d * seq
    return fpt * tokens_per_s / PEAK_FLOPS["bfloat16"]


def bert_feed(seed, batch):
    from paddle_tpu_torch.models.bert import bert_inputs_synthetic

    return bert_inputs_synthetic(batch, BERT["max_len"],
                                 BERT["vocab_size"], seed=seed)


def bert_phase(seed):
    """BERT-base at the bench's batch 8 (``train``), its MFU by the
    bench's count, then the batch-2 AMP step on the card against the
    CPU."""
    what = "BERT-base training"
    built = build_bert_program()
    launches, training = train(
        seed, built, bert_feed(seed, BERT_BATCH), what,
        bert_expected, unit=("tokens", BERT_BATCH * BERT["max_len"]))
    tokens = BERT_BATCH * BERT["max_len"]
    compiled_ms = COMPILED[what]["compiled"]["wall_ms"]
    training["bench_mfu"] = {
        "interpreted": bert_mfu(training["tokens_per_s"]),
        "compiled": bert_mfu(tokens / compiled_ms * 1e3),
        "compiled_tokens_per_s": tokens / compiled_ms * 1e3}
    training["launches_per_step"] = {
        k: launches[k] // TRAIN_STEPS for k in KERNELS if launches[k]}
    log(f"{what} bench MFU " + json.dumps(training["bench_mfu"])
        + " launches a step " + json.dumps(training["launches_per_step"]))
    # the flash kernels the profiled steps ran, by function: bf16 only
    calls = {n for side in training["profiled_port_calls"].values()
             for n in side}
    if not calls or any("bf16" not in n for n in calls):
        raise AssertionError(f"{what}: the profiled steps ran the port's "
                             f"kernels {sorted(calls)}, expected the bf16 "
                             f"flash kernels only")
    tol = dict(factor=BERT_SPREAD_FACTOR, floors=BERT_FLOORS,
               bulk_rtol=AMP_GRAD_BULK_RTOL, per_grad=True)
    f32 = build_bert_program(amp=False)
    training["vs_cpu"] = train_gpu_vs_cpu(
        seed, built, "BERT-base AMP training", tol,
        bert_feed(seed, CHECK_BATCH), flag=None, cpu_reference_mode="f32",
        reference_built=f32)
    # the f32 step against the CPU's (shared with the check above), each
    # grad within 3x its distance between the CPU's f32 and f64 runs, and
    # a fault planted in dq and in dk must break that
    training["vs_cpu_f32"] = train_gpu_vs_cpu(
        seed, f32, "BERT-base f32 training", dict(
            factor=BERT_SPREAD_FACTOR, floors=BERT_F32_FLOORS,
            bulk_rtol=GRAD_BULK_RTOL, per_grad=True),
        bert_feed(seed, CHECK_BATCH), flag=None, cpu_reference_mode="f64",
        reference_built=f32, reference_f64=True,
        planted=[(name, lambda k=kernel: planted_bwd_fault(k))
                 for name, kernel in (("dq", "dq"), ("dk", "dkv"))])
    return launches, training


@contextlib.contextmanager
def planted_bwd_fault(kernel):
    """A fault in a flash backward kernel's output on the card: after
    each launch of ``kernel`` ("dq", or "dkv" for dk) its gradient's last
    PLANTED_ROWS rows of every (batch, head) are zeroed."""
    from paddle_tpu_torch.ops import flash_attention as fa

    real = fa._bwd_kernel

    def faulty(name, q, k, v, do, lse, delta, outs, causal, scale):
        real(name, q, k, v, do, lse, delta, outs, causal, scale)
        if name == kernel:
            outs[0][:, :, -PLANTED_ROWS:, :] = 0

    fa._bwd_kernel = faulty
    try:
        yield
    finally:
        fa._bwd_kernel = real


def build_deepfm_program():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.deepfm import deepfm_model

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        model = deepfm_model(**DEEPFM)
        _, params_grads = pt.optimizer.Adam(DEEPFM_LR).minimize(
            model["loss"])
    return model, main, startup, params_grads


def deepfm_phase(seed):
    """DeepFM at the bench's batch 2048 (``train``; no hand kernel may
    launch), then its batch-2 step on the card against the CPU."""
    from paddle_tpu_torch.models.deepfm import deepfm_inputs_synthetic

    def feed(batch):
        return deepfm_inputs_synthetic(batch, DEEPFM["num_fields"],
                                       DEEPFM["vocab_size"],
                                       DEEPFM["dense_dim"], seed=seed)

    launches, training = train(
        seed, build_deepfm_program(), feed(DEEPFM_BATCH), "DeepFM training",
        lambda types, steps: expected_counts(),
        unit=("examples", DEEPFM_BATCH))
    training["vs_cpu"] = train_gpu_vs_cpu(
        seed, build_deepfm_program(), "DeepFM training", dict(
            loss_rtol=LOSS_RTOL, bulk_rtol=GRAD_BULK_RTOL,
            bulk_share=GRAD_BULK_SHARE, max_rtol=1.0 / CHECK_BATCH,
            param_atol=2 * 2 * DEEPFM_LR + 1e-5), feed(CHECK_BATCH),
        flag=None)
    return launches, training


TRAINING_LEGS = ("longctx", "longctx_d128", "BERT-base training",
                 "DeepFM training")


def training_legs(seed, device):
    """Phases 19-21 in this process: each leg's launches and numbers,
    and their compiled passes' rows."""
    launches, rows = {}, {}
    for what, d in LONGCTX_LEGS:
        launches[what], rows[what] = longctx_leg(seed, what, d, device)
    launches["bert_training"], rows["bert_training"] = bert_phase(seed)
    launches["deepfm_training"], rows["deepfm_training"] = \
        deepfm_phase(seed)
    return {"launches": launches, "rows": rows,
            "compiled": {k: COMPILED[k] for k in TRAINING_LEGS}}


def training_legs_apart(seed):
    """Phases 19-21 in a process of their own (``--training-legs``), on
    the kernels built here: in this long process torch.profiler lost
    every record of the long-context step's replays in three profiled
    pairs, and it drops records of the later phases' profiles, where a
    process of its own records them all.  Returns what
    ``training_legs`` returned there; its compiled rows join COMPILED."""
    import torch

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "training_legs.json")
        cmd = [sys.executable, os.path.abspath(__file__), "--seed",
               str(seed), "--training-legs", out]
        if PREFETCH["dir"] is not None:
            cmd += ["--cpu-runs", PREFETCH["dir"]]
        proc = subprocess.run(cmd, timeout=1200)
        if proc.returncode != 0:
            raise AssertionError(f"phases 19-21 failed in their process "
                                 f"(exit {proc.returncode})")
        with open(out) as f:
            res = json.load(f)
    COMPILED.update(res["compiled"])
    return res


# ---------------------------------------------------------------------------
# phase 3e: parameter-server training over the RPC transport, the fleet
# collector and the remote profiler (a process of its own, ``--ps``)
# ---------------------------------------------------------------------------

PS_PSERVERS = 2            # pservers of every cluster
PS_TRAINERS = 2            # trainers of the sync and async runs
PS_WAIT_S = 300.0          # every cluster wait's bound: ports, barriers, exits
PS_PUSH_S = 0.2            # the collector pushers' interval
PS_PUSH_FAULTS = 6         # collector pushes the seeded plan drops or closes
PS_PUSH_FAULT_SPAN = 24    # ... among the first this many pushes
PS_SERVE_REQUESTS = 4      # requests to each server that pushes
PS_RPC_OPS = ("send", "send_barrier", "recv", "fetch_barrier")


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def ps_place(device):
    import paddle_tpu_torch as pt

    return pt.CUDAPlace(0) if device == "cuda" else pt.CPUPlace()


def ps_transpile(built, trainer_id, endpoints, trainers, sync,
                 heartbeat_timeout=None):
    """A program's transpile for one node of a cluster, every process
    transpiling the same program alike (build_train_program's and
    build_ctr_program's names come from a fresh unique_name guard)."""
    import paddle_tpu_torch as pt

    _, main, startup, _ = built
    cfg = pt.transpiler.DistributeTranspilerConfig()
    cfg.barrier_timeout = PS_WAIT_S
    if heartbeat_timeout is not None:
        cfg.heartbeat_timeout = heartbeat_timeout
    t = pt.transpiler.DistributeTranspiler(cfg)
    t.transpile(trainer_id, program=main, startup_program=startup,
                pservers=",".join(endpoints), trainers=trainers,
                sync_mode=sync)
    return t


def time_blocks(device):
    """Times every optimize block a pserver runs from here on (on the
    card, synchronised around it): the list the times land in."""
    import torch

    from paddle_tpu_torch.core import executor as ex

    block_ms = []
    run_block = ex.RuntimeCtx.run_block

    def timed_block(ctx, idx, scope):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_block(ctx, idx, scope)
        if device == "cuda":
            torch.cuda.synchronize()
        block_ms.append((time.perf_counter() - t0) * 1e3)

    ex.RuntimeCtx.run_block = timed_block
    return block_ms


def ps_pserver(spec):
    """One pserver (``--ps-node``) of the LM (``program`` "lm") or of
    DeepFM ("ctr"): its startup, then listen_and_serv until every trainer
    completed, each optimize block timed (``time_blocks``); with a list
    of endpoints in ``current``, a pserver for each on threads of this
    process.  With ``fleet`` it comes up through fleet's PS mode
    (``fleet.init``, ``distributed_optimizer``, ``init_server``,
    ``run_server``).  With ``collector`` it traces every request and
    pushes its spans there under the name the collector's varz poll gives
    it.  Writes {"block_ms", "blocks_a_step", "fleet"} to ``out`` (the
    blocks of every endpoint served here)."""
    import paddle_tpu_torch as pt

    device = spec["device"]
    ep = spec["current"]
    pusher = None
    if spec.get("collector"):
        from paddle_tpu_torch.observability import collector, tracing

        tracing.start_tracing(sample=1.0)
        pusher = collector.CollectorPusher(
            spec["collector"], role="pserver", process="pserver@" + ep,
            interval_s=PS_PUSH_S).start()
    if spec.get("fleet"):
        fleet = ctr_fleet_node(spec, "PSERVER")[0]
        block_ms = time_blocks(device)
        fleet.init_server(place=ps_place(device))
        fleet.run_server(place=ps_place(device))
        mains = [fleet._ps_main]
    else:
        built = NODE_PROGRAMS[spec.get("program", "lm")]()
        t = ps_transpile(built, 0, spec["endpoints"], spec["trainers"],
                         spec["sync"], spec.get("heartbeat_timeout"))
        block_ms = time_blocks(device)
        mains, errors = [], []

        def serve(ep):
            try:
                main, startup = t.get_pserver_programs(ep)
                mains.append(main)
                exe, scope = pt.Executor(ps_place(device)), pt.Scope()
                exe.run(startup, scope=scope)
                exe.run(main, scope=scope)  # until the trainers complete
            except BaseException as e:  # noqa: BLE001 (raised below)
                errors.append(e)

        threads = [threading.Thread(target=serve, args=(e,))
                   for e in (ep if isinstance(ep, list) else [ep])]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
    if pusher is not None:
        pusher.stop(final_push=True)
    with open(spec["out"], "w") as f:
        json.dump({"block_ms": block_ms, "fleet": bool(spec.get("fleet")),
                   "blocks_a_step": sum(
                       len(m.global_block().ops[-1].attrs["grad_blocks"])
                       for m in mains)}, f)


def ps_trainer_setup(built, spec):
    """A trainer's executor, scope, program and transpiler after its
    startup (trainer 0 pushes the initial parameters, every trainer pulls
    them)."""
    import paddle_tpu_torch as pt

    eps = spec["endpoints"]
    t = ps_transpile(built, spec["trainer_id"], eps, spec["trainers"],
                     spec["sync"], spec.get("heartbeat_timeout"))
    pt.transpiler.wait_server_ready(eps, timeout=PS_WAIT_S)
    exe, scope = pt.Executor(ps_place(spec["device"])), pt.Scope()
    np.random.seed(spec["seed"])
    exe.run(t.get_trainer_startup_program(), scope=scope)
    return exe, scope, t.get_trainer_program(wait_port=False), t


def ps_complete(spec):
    from paddle_tpu_torch.distributed.rpc import global_rpc_client

    for ep in spec["endpoints"]:
        global_rpc_client().send_complete(
            ep, peer_id="trainer%d" % spec["trainer_id"])


def ps_trainer(spec):
    """A trainer of the 2-trainer runs (``--ps-node``): a warm-up step
    and TRAIN_STEPS steps on its own fixed batch; writes its losses."""
    built = build_train_program()
    model = built[0]
    exe, scope, prog, _ = ps_trainer_setup(built, spec)
    feed = train_batch(spec["seed"] + 1 + spec["trainer_id"], spec["batch"])
    losses = [float(exe.run(prog, feed=feed, fetch_list=[model["loss"]],
                            scope=scope)[0])
              for _ in range(TRAIN_STEPS + 1)]
    ps_complete(spec)
    with open(spec["out"], "w") as f:
        json.dump({"losses": losses}, f)


def ps_node(spec_json):
    global DEEPFM_BATCH, CTR_LR

    spec = json.loads(spec_json)
    MODEL.update(spec["model"])
    CTR.update(spec["ctr"])
    DEEPFM_BATCH, CTR_LR = spec["ctr_batch"], spec["ctr_lr"]
    {"pserver": ps_pserver, "trainer": ps_trainer,
     "ctr_trainer": ctr_trainer,
     "elastic_trainer": elastic_trainer}[spec["role"]](spec)


class PSCluster:
    """Pserver (and trainer) processes of one cluster, each from
    ``--ps-node`` with an explicit CUDA_VISIBLE_DEVICES and the
    transport in its environment; ``pserver`` and ``trainer`` add to the
    nodes' specs (a trainer's ``role``: "trainer", "ctr_trainer" or
    "elastic_trainer"; its ``exit_code``, 0 unless given); with
    ``one_process`` the pservers are threads of one node.  ``wait()``
    bounds every exit by PS_WAIT_S and fails the run on an unexpected
    one; ``wait_trainers()`` waits for the spawned trainers only;
    ``kill()`` ends what still runs."""

    def __init__(self, tmp, name, device, seed, trainers, sync,
                 transport="socket", collector=None, spawn_trainers=(),
                 pserver=None, trainer=None, one_process=False):
        self.endpoints = [f"127.0.0.1:{_free_port()}"
                          for _ in range(PS_PSERVERS)]
        self.name, self.procs, self.outs = name, [], {}
        base = {"endpoints": self.endpoints, "trainers": trainers,
                "sync": sync, "device": device, "seed": seed,
                "batch": BATCH, "model": MODEL, "ctr": CTR,
                "ctr_batch": DEEPFM_BATCH, "ctr_lr": CTR_LR}
        self.spec = dict(base, role="trainer", trainer_id=0,
                         **(pserver or {}))
        env = dict(os.environ, PADDLE_TPU_RPC_TRANSPORT=transport,
                   CUDA_VISIBLE_DEVICES=os.environ.get(
                       "CUDA_VISIBLE_DEVICES", "0"))
        env.pop("PADDLE_TPU_COLLECTOR", None)
        nodes = [{**base, "role": "pserver", "current": ep,
                  "collector": collector, **(pserver or {})}
                 for ep in ([self.endpoints] if one_process
                            else self.endpoints)]
        self.n_pserver_nodes = len(nodes)
        nodes += [{**base, "role": "trainer", "trainer_id": k,
                   **(pserver or {}), **(trainer or {})}
                  for k in spawn_trainers]
        self.exit_codes = []
        for i, node in enumerate(nodes):
            node["out"] = os.path.join(tmp, f"{name}_{i}.json")
            self.outs[node["out"]] = node
            self.exit_codes.append(node.get("exit_code", 0)
                                   if node["role"] != "pserver" else 0)
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--seed",
                 str(seed), "--ps-node", json.dumps(node)], env=env))

    def _wait(self, procs, end):
        for p, want in procs:
            try:
                rc = p.wait(timeout=max(1.0, end - time.perf_counter()))
            except subprocess.TimeoutExpired:
                self.kill()
                raise AssertionError(f"ps {self.name}: a node outlasted "
                                     f"{PS_WAIT_S:.0f} s")
            if rc != want:
                self.kill()
                raise AssertionError(f"ps {self.name}: a node exited {rc} "
                                     f"(expected {want})")

    def wait_trainers(self):
        self._wait(list(zip(self.procs, self.exit_codes))[
            self.n_pserver_nodes:], time.perf_counter() + PS_WAIT_S)

    def wait(self):
        self._wait(list(zip(self.procs, self.exit_codes)),
                   time.perf_counter() + PS_WAIT_S)
        res = {"pservers": [], "trainers": []}
        for path, node in self.outs.items():
            with open(path) as f:
                res[("pserver" if node["role"] == "pserver" else "trainer")
                    + "s"].append(json.load(f))
        return res

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def ps_params(built, scope):
    """The LM's parameters in ``scope``, by name (tensors)."""
    return {p.name: scope.find_var(p.name).get() for p, _ in built[3]}


class PSCounters:
    """The in-process trainer's RPC numbers over a window: the bytes its
    frames carried each way (socket framing: ``rpc._send_msg`` and
    ``rpc._recv_exact`` wrapped; the heartbeat sender's beats share the
    module and are counted too) and the seconds its send, barrier and
    recv ops took (the executor's handlers wrapped)."""

    def __init__(self):
        from paddle_tpu_torch.core import executor as ex
        from paddle_tpu_torch.distributed import rpc

        self.sent = self.received = 0
        self.op_s = {t: 0.0 for t in PS_RPC_OPS}
        self._saved = [(rpc, "_send_msg", rpc._send_msg),
                       (rpc, "_recv_exact", rpc._recv_exact)]
        send_msg, recv_exact = rpc._send_msg, rpc._recv_exact
        counters = self

        class Counting:
            def __init__(self, sock):
                self.sock = sock

            def sendall(self, b):
                counters.sent += len(b)
                return self.sock.sendall(b)

        def counted_send(sock, obj):
            return send_msg(Counting(sock), obj)

        def counted_recv(sock, n):
            counters.received += n
            return recv_exact(sock, n)

        rpc._send_msg, rpc._recv_exact = counted_send, counted_recv
        self._ops = dict(ex._SPECIAL_OPS)
        for t in PS_RPC_OPS:
            self._wrap(ex._SPECIAL_OPS, t)

    def reset(self):
        self.sent = self.received = 0
        self.op_s = {t: 0.0 for t in PS_RPC_OPS}

    def _wrap(self, table, t):
        fn = table[t]

        def timed(*a):
            t0 = time.perf_counter()
            fn(*a)
            self.op_s[t] += time.perf_counter() - t0

        table[t] = timed

    def close(self):
        from paddle_tpu_torch.core import executor as ex

        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        ex._SPECIAL_OPS.update(self._ops)


def ps_steps(exe, scope, prog, model, feed, device, between=None):
    """A warm-up step, then TRAIN_STEPS steps (``between(i)`` before
    step i of those): their losses, each step's ms and the launches of
    the counted steps."""
    import torch

    losses = [float(exe.run(prog, feed=feed, fetch_list=[model["loss"]],
                            scope=scope)[0])]
    step_ms = []
    if device == "cuda":
        torch.cuda.synchronize()
    reset_kernel_counts()
    for i in range(TRAIN_STEPS):
        if between is not None:
            between(i)
        t0 = time.perf_counter()
        losses.append(float(exe.run(prog, feed=feed,
                                    fetch_list=[model["loss"]],
                                    scope=scope)[0]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return losses, step_ms, kernel_counts()


def ps_local(built, seed, device, feed):
    """The untranspiled program's run on ``device``: its losses, step
    ms, launches, the initial and the final parameters."""
    import paddle_tpu_torch as pt

    model, main, startup, _ = built
    exe, scope = pt.Executor(ps_place(device)), pt.Scope()
    np.random.seed(seed)
    exe.run(startup, scope=scope)
    init = {n: t.clone() for n, t in ps_params(built, scope).items()}
    losses, step_ms, counts = ps_steps(exe, scope, main, model, feed, device)
    return {"losses": losses, "step_ms": step_ms, "counts": counts,
            "init": init, "final": ps_params(built, scope)}


def ps_same(a, b):
    """Names whose tensors differ in any bit, over the parameters."""
    import torch

    return sorted(n for n in a if not torch.equal(a[n], b[n]))


def ps_spread(a, b):
    """Max abs difference of two runs: losses and parameters."""
    return {"loss": max(abs(x - y) for x, y in zip(a["losses"],
                                                    b["losses"])),
            "param": max(float((a["final"][n] - b["final"][n]).abs().max())
                         for n in a["final"])}


def ps_hold(what, run, local, built, seed, device, feed, spread):
    """The bar: ``run``'s losses and final parameters bitwise those of
    ``local``; where they are not, within twice the spread of two local
    runs (computed once, into ``spread``)."""
    diff = ps_same(local["final"], run["final"])
    same_losses = run["losses"] == local["losses"]
    if same_losses and not diff:
        return {"bitwise": True}
    if not spread:
        spread.update(ps_spread(local, ps_local(built, seed, device, feed)))
    got = ps_spread(local, run)
    row = {"bitwise": False, "losses_equal": same_losses,
           "params_differing": len(diff), "spread_of_two_local": spread,
           "spread_to_local": got}
    log(f"ps {what}: not bitwise the local run " + json.dumps(row))
    if got["loss"] > 2 * spread["loss"] or got["param"] > 2 * spread["param"]:
        raise AssertionError(f"ps {what}: beyond twice the local spread")
    return row


def ps_collected(coll, tracer, eps, http_url):
    """The collector's bars: /fleetz lists the trainer, both pservers and
    both servers; a trainer send's trace is complete with the pserver's
    server span in it; the trainer's every span landed exactly once."""
    doc = json.loads(_get(http_url + "/fleetz")[0])
    procs = doc["processes"]
    roles = {}
    for name, p in procs.items():
        roles.setdefault(p["role"], []).append(name)
    missing = [r for r in ("trainer", "serving", "decode") if not roles.get(r)]
    if sorted(roles.get("pserver", [])) != sorted("pserver@" + e
                                                  for e in eps):
        missing.append("pserver")
    sends = [s for s in tracer.spans() if s.name == "rpc.client:send_var"]
    tid = sends[0].trace_id if sends else None
    trace = coll.trace(tid) if tid else []
    server = [s for s in trace if s["name"] == "rpc.server:send_var"
              and s["process"].startswith("pserver@")]
    mine = {(s.trace_id, s.span_id) for s in tracer.spans()}
    trainer = roles["trainer"][0] if roles.get("trainer") else None
    landed = [(s["trace_id"], s["span_id"])
              for t in coll.trace_ids() for s in coll.trace(t)
              if s["process"] == trainer]
    row = {"processes": {r: sorted(n) for r, n in roles.items()},
           "stale": sorted(n for n, p in procs.items() if p["stale"]),
           "send_trace": tid, "send_trace_spans": len(trace),
           "send_trace_complete": bool(tid) and coll.trace_complete(tid),
           "server_spans_in_it": len(server),
           "trainer_spans": len(mine), "landed": len(landed),
           "landed_distinct": len(set(landed)),
           "trainer_span_count": procs[trainer]["span_count"]
           if trainer else None}
    if missing or row["stale"] or not row["send_trace_complete"] or \
            not server or set(landed) != mine or \
            len(landed) != len(mine) or \
            row["trainer_span_count"] != len(mine):
        raise AssertionError(f"ps: the collector's bars failed "
                             f"(missing {missing}) " + json.dumps(row))
    return row


def ps_profiles(paths, eps, block_counts):
    """Each pserver's chrome trace from the remote profiler: its device
    kernel slices (events on the device lanes, re-based past any host
    pid) at least as many as the optimize blocks it ran in the window."""
    rows = {}
    for ep, path in zip(eps, paths):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        names = {e["pid"]: e["args"]["name"] for e in events
                 if e.get("ph") == "M" and e.get("name") == "process_name"}
        device = [e for e in events if e.get("ph") == "X" and
                  names.get(e.get("pid"), "").startswith("device:")]
        top = {}
        for e in device:
            top[e["name"][:60]] = top.get(e["name"][:60], 0) + 1
        rows[ep] = {"path": path, "events": len(events),
                    "device_kernels": len(device),
                    "optimize_blocks": block_counts[ep],
                    "top": sorted(top.items(), key=lambda kv: -kv[1])[:4]}
    log("ps: the remote profiler's traces " + json.dumps(rows))
    if any(r["device_kernels"] < max(1, r["optimize_blocks"])
           for r in rows.values()):
        raise AssertionError("ps: a pserver's trace lacks its optimize "
                             "kernels")
    return rows


def ps_serving(seed, workdir, device, endpoint):
    """An InferenceServer over two LM Predictor replicas and a
    DecodeServer, each pushing to the collector at ``endpoint``, each
    answering PS_SERVE_REQUESTS requests."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import serving

    save_lm(seed, workdir)

    def replica(i):
        cfg = pt.inference.Config(workdir)
        if device != "cuda":
            cfg.disable_gpu()
        return pt.inference.create_predictor(cfg)

    rng = np.random.RandomState(seed + 22)
    srv = serving.InferenceServer(replica, serving.ServingConfig(
        max_batch=1, n_replicas=2, collector=endpoint,
        default_deadline_s=TIER_WAIT_S)).start()
    try:
        futs = [srv.submit({"src_ids": rng.randint(
            0, MODEL["vocab_size"], (1, MODEL["max_len"], 1)).astype(
                np.int64)}) for _ in range(PS_SERVE_REQUESTS)]
        served = [f.result(timeout=TIER_WAIT_S)[0].shape for f in futs]
    finally:
        srv.stop()
    dec = decode_server(device, seed, collector=endpoint).start()
    try:
        prompts = decode_prompts(seed + 23, PS_SERVE_REQUESTS,
                                 *DECODE_PROMPT, DECODE_MODEL["vocab"])
        decoded = [len(dec.submit(p).result(timeout=TIER_WAIT_S)[0])
                   for p in prompts]
    finally:
        dec.stop()
    return {"served": [list(s) for s in served], "decoded": decoded}


def ps_phase(seed, device="cuda"):
    """Phase 3e in this process: the LM of phase 5 (MODEL widths, f32,
    Adam(TRAIN_LR), batch 8 on phase 5's batch) transpiled for 1 trainer
    and 2 pservers in sync mode, the pservers in processes of their own
    on the card, the trainer here: its losses and final parameters held
    bitwise to the untranspiled program's local run from the same start,
    12/6/6 flash launches a step; the same over the HTTP transport with
    the fleet collector and the remote profiler, the same bits; 2
    trainers in sync and in async mode, their losses finite and falling."""
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.distributed import faultinject, rpc
    from paddle_tpu_torch.observability import collector as collector_mod
    from paddle_tpu_torch.observability import tracing

    t_phase = time.perf_counter()
    laps = {}

    def lap(name):
        laps[name] = time.perf_counter() - t_phase

    built = build_train_program()
    model, main, _, params_grads = built
    types = [op.type for op in main.global_block().ops]
    feed = train_batch(seed, BATCH)
    n_bytes = 4 * sum(int(np.prod(p.shape)) for p, _ in params_grads)
    out = {"params": len(params_grads), "param_bytes": n_bytes}
    clusters = []
    tmp = tempfile.mkdtemp(prefix="ps_phase_")
    try:
        # the two 1-trainer clusters, over sockets and over HTTP (under
        # the collector, which their pservers push their spans to): every
        # pserver starts now, beside the local run
        coll = collector_mod.CollectorServer(
            "127.0.0.1:0", http_port=0, stale_after=PS_WAIT_S,
            max_traces=1 << 16).start()
        sock = PSCluster(tmp, "socket", device, seed, 1, True)
        clusters.append(sock)
        http = PSCluster(tmp, "http", device, seed, 1, True,
                         transport="http", collector=coll.endpoint)
        clusters.append(http)
        import paddle_tpu_torch as pt

        pt.transpiler.wait_server_ready(sock.endpoints, timeout=PS_WAIT_S)
        lap("pservers up")
        local = ps_local(built, seed, device, feed)
        lap("local run")
        exe, scope, prog, _ = ps_trainer_setup(built, sock.spec)
        lap("trainer startup (push, pull)")
        start_diff = ps_same(local["init"], ps_params(built, scope))
        if start_diff:
            raise AssertionError(f"ps: the pushed start differs from the "
                                 f"local start in {start_diff[:4]}")
        counters = PSCounters()
        try:
            # the counters read the counted steps only
            losses, step_ms, counts = ps_steps(
                exe, scope, prog, model, feed, device,
                lambda i: i == 0 and counters.reset())
            rpc_s = dict(counters.op_s)
            sent, received = counters.sent, counters.received
        finally:
            counters.close()
        ps_complete(sock.spec)
        run = {"losses": losses, "final": ps_params(built, scope)}
        del exe, scope
        res = sock.wait()
        spread = {}
        out["socket_vs_local"] = ps_hold("socket", run, local, built, seed,
                                         device, feed, spread)
        want = lm_expected(types, TRAIN_STEPS)
        if counts != want or local["counts"] != want:
            raise AssertionError(f"ps: launches {counts} (local "
                                 f"{local['counts']}), expected {want}")
        opt_ms = []
        for r in res["pservers"]:
            n = r["blocks_a_step"]
            steps = [sum(r["block_ms"][i:i + n])
                     for i in range(0, len(r["block_ms"]), n)]
            opt_ms.append(float(np.mean(steps[1:])))
        out["socket"] = {
            "losses": losses, "local_losses": local["losses"],
            "step_ms": float(np.mean(step_ms)),
            "local_step_ms": float(np.mean(local["step_ms"])),
            "bytes_sent_a_step": sent / TRAIN_STEPS,
            "bytes_received_a_step": received / TRAIN_STEPS,
            "rpc_ms_a_step": {t: s * 1e3 / TRAIN_STEPS
                              for t, s in rpc_s.items()},
            "rpc_ms_a_step_total": sum(rpc_s.values()) * 1e3 / TRAIN_STEPS,
            "pserver_optimize_ms_a_step": opt_ms,
            "launches_a_step": {k: v // TRAIN_STEPS
                                for k, v in counts.items() if v}}
        out["launches"] = counts
        del local["init"]
        lap("socket run")
        log("ps: 1 trainer, 2 pservers, sockets " + json.dumps(
            out["socket"]))

        # the 2-trainer runs, sync and async, beside the HTTP run
        sync2 = PSCluster(tmp, "sync2", device, seed, PS_TRAINERS, True,
                          spawn_trainers=range(PS_TRAINERS))
        clusters.append(sync2)
        async2 = PSCluster(tmp, "async2", device, seed, PS_TRAINERS, False,
                           spawn_trainers=range(PS_TRAINERS))
        clusters.append(async2)

        # the HTTP run under the collector: the trainer pushes at step
        # boundaries (PADDLE_TPU_COLLECTOR), the pservers push their spans
        # and are polled over varz, a seeded plan drops or closes pushes
        tracer = tracing.start_tracing(sample=1.0)
        os.environ.update(PADDLE_TPU_RPC_TRANSPORT="http",
                          PADDLE_TPU_COLLECTOR=coll.endpoint,
                          PADDLE_TPU_COLLECTOR_PUSH_INTERVAL=str(PS_PUSH_S))
        collector_mod.reset_env_pusher()
        rpc._global_client = None
        rng = np.random.RandomState(seed + 22)
        plan = faultinject.FaultPlan()
        for k, i in enumerate(sorted(rng.choice(
                PS_PUSH_FAULT_SPAN, PS_PUSH_FAULTS, replace=False))):
            plan.on(collector_mod.MSG_PUSH, int(i),
                    ("drop", "close")[k % 2])
        inj = faultinject.install(plan)
        exe, scope, prog, _ = ps_trainer_setup(built, http.spec)
        lap("http trainer startup")
        prof_dir = tempfile.mkdtemp(prefix="ps_profiles_", dir=tmp)
        paths = []

        def between(i):
            if i == 1:
                profiler.start_remote_profiler(http.endpoints)
            elif i == 3:
                paths.extend(profiler.stop_remote_profiler(
                    http.endpoints, os.path.join(prof_dir, "ps")))
            for ep in http.endpoints:
                coll.poll_varz(ep, role="pserver")

        h_losses, h_ms, _ = ps_steps(exe, scope, prog, model, feed, device,
                                     between)
        h_run = {"losses": h_losses, "final": ps_params(built, scope)}
        ps_complete(http.spec)
        del exe, scope
        h_res = http.wait()
        diff = ps_same(run["final"], h_run["final"])
        out["http_vs_socket"] = {"losses_equal": h_losses == losses,
                                 "params_differing": len(diff),
                                 "step_ms": float(np.mean(h_ms))}
        if h_losses != losses or diff:
            raise AssertionError("ps: the HTTP run's bits differ from the "
                                 "socket run's " + json.dumps(
                                     out["http_vs_socket"]))
        # the profiled window ran steps 1 and 2: each pserver's blocks
        blocks = {ep: 2 * r["blocks_a_step"]
                  for ep, r in zip(http.endpoints, h_res["pservers"])}
        out["remote_profiles"] = ps_profiles(paths, http.endpoints, blocks)
        lap("http run")
        with tempfile.TemporaryDirectory() as workdir:
            out["serving"] = ps_serving(seed, workdir, device, coll.endpoint)
        lap("servers")
        faultinject.uninstall()
        out["push_faults"] = [list(e) for e in inj.log]
        if len(inj.log) != PS_PUSH_FAULTS:
            raise AssertionError(f"ps: {len(inj.log)} push faults of "
                                 f"{PS_PUSH_FAULTS} planned")
        collector_mod._pusher.stop(final_push=True)
        out["collector"] = ps_collected(coll, tracer, http.endpoints,
                                        coll.http_server.url)
        log("ps: the collector " + json.dumps(out["collector"]))
        coll.stop()
        tracing.stop_tracing()
        os.environ.pop("PADDLE_TPU_COLLECTOR")
        os.environ["PADDLE_TPU_RPC_TRANSPORT"] = "socket"
        rpc._global_client = None

        for name, cl in (("sync2", sync2), ("async2", async2)):
            tl = [r["losses"] for r in cl.wait()["trainers"]]
            out[name] = tl
            if not all(np.isfinite(x).all() and x[-1] < x[0] for x in tl):
                raise AssertionError(f"ps {name}: losses not finite and "
                                     f"falling {tl}")
        lap("2-trainer runs")
        log("ps: 2 trainers, sync and async " + json.dumps(
            {"sync2": out["sync2"], "async2": out["async2"]}))
    finally:
        for cl in clusters:
            cl.kill()
        faultinject.uninstall()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    if device == "cuda":
        torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t_phase
    out["laps_s"] = laps
    return out


def ps_apart(seed, card):
    """Phase 3e in a process of its own (``--ps``), on the kernels built
    here; returns its numbers."""
    import torch

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        res_path = os.path.join(tmp, "ps.json")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--ps", res_path], timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"phase 3e failed in its process "
                                 f"(exit {proc.returncode})")
        with open(res_path) as f:
            res = json.load(f)
    log(f"ps ({card}) " + json.dumps({k: res[k] for k in (
        "socket", "socket_vs_local", "http_vs_socket", "seconds",
        "laps_s")}))
    return res


# ---------------------------------------------------------------------------
# phase 3f: Downpour CTR training over the dataset path and fleet's PS mode,
# the async Communicator and elastic crash-resume (a process of its own,
# ``--ctr``)
# ---------------------------------------------------------------------------

# DeepFM at the bench's widths with its tables sharded over the pservers;
# SGD, since the pservers' table blocks are sparse_sgd whatever the
# optimizer (the JAX test's 0.5, at its tiny width, diverges with 2 async
# trainers at these).  The ids of the data are Zipf(CTR_ZIPF) draws folded
# into the vocabulary (CTR features are heavy-tailed); a label is whether
# the truth of its ids (id % 5 - 2) sums above 0 (the JAX package's
# Downpour test, tests/test_dist_ps.py:700-818).
CTR = dict(DEEPFM, is_distributed=True)
CTR_LR = 0.1
CTR_ZIPF = 1.2
CTR_SEED = 31               # the data's seed, past --seed
CTR_LOCKSTEP_STEPS = 10     # (a), the last one profiled
CTR_PUSH_WINDOW = 3         # (b), the JAX test's
CTR_PULL_DENSE_EVERY = 2
CTR_FILES = 2               # (b): a trainer's files ...
CTR_FILE_BATCHES = 20       # ... of this many batches each
COMM_STEPS = 10             # (e)
ELASTIC_STEPS = 8           # (f): the clean run's steps
ELASTIC_SAVE_EVERY = 3
ELASTIC_DIE_AFTER = 4       # the crashing trainer exits after step 4 ...
ELASTIC_EXIT_CODE = 41      # ... with this code, before its checkpoint 6
ELASTIC_RESUME_AT = 3


def build_ctr_program():
    """DeepFM (CTR) under SGD(CTR_LR), in programs of its own.  Returns
    (model, main, startup, params_grads)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.deepfm import deepfm_model

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        model = deepfm_model(**CTR)
        _, params_grads = pt.optimizer.SGD(CTR_LR).minimize(model["loss"])
    return model, main, startup, params_grads


NODE_PROGRAMS = {"lm": build_train_program, "ctr": build_ctr_program}


def ctr_fleet_node(spec, role):
    """DeepFM through fleet's PS mode, as a node of PaddleCloudRoleMaker's
    env contract (set here from ``spec``): ``fleet.init``, a
    ``distributed_optimizer`` of strategy mode "pserver", async, and its
    ``minimize``.  Returns (fleet, model, main)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.fleet import (DistributedStrategy,
                                        PaddleCloudRoleMaker, fleet)
    from paddle_tpu_torch.models.deepfm import deepfm_model

    os.environ.update(
        TRAINING_ROLE=role, PADDLE_TRAINERS_NUM=str(spec["trainers"]),
        PADDLE_PSERVERS_IP_PORT_LIST=",".join(spec["endpoints"]),
        PADDLE_CURRENT_ENDPOINT=spec.get("current", ""),
        PADDLE_TRAINER_ID=str(spec.get("trainer_id", 0)))
    fleet.init(PaddleCloudRoleMaker(is_collective=False))
    strategy = DistributedStrategy()
    strategy.mode, strategy.sync_mode = "pserver", False
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        model = deepfm_model(**CTR)
        if role == "TRAINER":
            pt.transpiler.wait_server_ready(spec["endpoints"],
                                            timeout=PS_WAIT_S)
        fleet.distributed_optimizer(pt.optimizer.SGD(CTR_LR),
                                    strategy).minimize(model["loss"])
    return fleet, model, main


def ctr_dataset(model, files):
    """A QueueDataset of one reader thread over ``files``, batches of
    DEEPFM_BATCH."""
    import paddle_tpu_torch as pt

    ds = pt.DatasetFactory().create_dataset("QueueDataset")
    ds.set_batch_size(DEEPFM_BATCH)
    ds.set_thread(1)
    ds.set_filelist(files)
    ds.set_use_var([model["sparse_ids"], model["dense_x"], model["label"]])
    return ds


def recording(exe, fetched):
    """Wraps ``exe.run`` on the instance: each call's first fetch lands
    in ``fetched`` (train_from_dataset and the Downpour runner call it)."""
    run = exe.run

    def run_and_keep(*a, **k):
        out = run(*a, **k)
        if out:
            fetched.append(out[0])
        return out

    exe.run = run_and_keep


def ctr_trainer(spec):
    """A trainer of (b) (``--ps-node``): fleet's PS mode, then
    ``train_from_dataset`` over its MultiSlot files with the program's
    ``_fleet_opt`` selecting DistMultiTrainer / DownpourSGD and no
    transpiler, so the Downpour runner comes from fleet's role contract.
    Writes its losses, the runner's stats, the seconds and NATIVE."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import native

    fleet, model, main = ctr_fleet_node(spec, "TRAINER")
    exe = pt.Executor(ps_place(spec["device"]))
    np.random.seed(spec["seed"])
    exe.run(fleet.startup_program)
    main._fleet_opt = {"trainer": "DistMultiTrainer",
                       "device_worker": "DownpourSGD",
                       "push_window": CTR_PUSH_WINDOW,
                       "pull_dense_every": CTR_PULL_DENSE_EVERY}
    losses = []
    recording(exe, losses)
    t0 = time.perf_counter()
    files = spec["files"][str(spec["trainer_id"])]
    end = time.perf_counter() + PS_WAIT_S    # the phase writes them
    while not all(map(os.path.exists, files)) and time.perf_counter() < end:
        time.sleep(0.1)
    exe.train_from_dataset(main, ctr_dataset(model, files),
                           fetch_list=[model["loss"]])
    seconds = time.perf_counter() - t0
    runner = main._fleet_opt["downpour_runner"]
    stats = dict(runner.stats)
    runner.finish()
    ps_complete(spec)
    with open(spec["out"], "w") as f:
        json.dump({"losses": [float(x) for x in losses], "stats": stats,
                   "seconds": seconds, "native": native.NATIVE,
                   "transpiled_by_fleet_contract":
                       main._fleet_opt["transpiler"] is not fleet._transpiler
                       and main._fleet_opt["transpiler"].endpoints
                       == spec["endpoints"]}, f)


def elastic_batch(spec, step):
    """(f)'s data, keyed by the step."""
    return train_batch(spec["seed"] + 100 + step, spec["batch"])


def elastic_run(spec, exe, scope, prog, t, model, ckpt_dir, ps_dir,
                steps, die_after=None):
    """The LM's elastic loop: ElasticTrainer over an AsyncCheckpointer
    (save_every ELASTIC_SAVE_EVERY, each save waited for, the pservers'
    snapshots in ``ps_dir``), resumed, then ``steps`` steps of
    step-keyed data.  Returns (start, {step: loss}, resume s, checkpoint
    s each, step ms each)."""
    from paddle_tpu_torch.contrib.checkpoint import AsyncCheckpointer
    from paddle_tpu_torch.distributed.elastic import ElasticTrainer

    ck = AsyncCheckpointer(ckpt_dir)
    el = ElasticTrainer(ck, transpiler=t, save_every=ELASTIC_SAVE_EVERY,
                        wait_each_save=True, program=prog, scope=scope,
                        ps_state_dir=ps_dir)
    t0 = time.perf_counter()
    start = el.resume()
    resume_s = time.perf_counter() - t0
    losses, ckpt_s, step_ms = {}, [], []
    for step in range(start, steps):
        t0 = time.perf_counter()
        losses[step] = float(exe.run(prog, feed=elastic_batch(spec, step),
                                     fetch_list=[model["loss"]],
                                     scope=scope)[0])
        t1 = time.perf_counter()
        el.step_done(step)
        t2 = time.perf_counter()
        step_ms.append((t1 - t0) * 1e3)
        if (step + 1) % ELASTIC_SAVE_EVERY == 0:
            ckpt_s.append(t2 - t1)
        if die_after is not None and step == die_after:
            return start, losses, resume_s, ckpt_s, step_ms
    el.finish()
    ck.close()
    return start, losses, resume_s, ckpt_s, step_ms


def elastic_trainer(spec):
    """A trainer of (f) (``--ps-node``): the elastic loop over
    ELASTIC_STEPS steps (the clean run), or with ``die_after`` until that
    step, then ``os._exit`` with ELASTIC_EXIT_CODE: no complete, no
    goodbye, and its last checkpoint ELASTIC_RESUME_AT's.  Writes its
    start, losses, checkpoint seconds and step ms first."""
    built = build_train_program()
    exe, scope, prog, t = ps_trainer_setup(built, spec)
    die = spec.get("die_after")
    start, losses, _, ckpt_s, step_ms = elastic_run(
        spec, exe, scope, prog, t, built[0], spec["ckpt_dir"],
        spec["ps_dir"], ELASTIC_STEPS, die)
    if die is None:
        ps_complete(spec)
    with open(spec["out"], "w") as f:
        json.dump({"start": start, "losses": losses, "checkpoint_s": ckpt_s,
                   "step_ms": step_ms}, f)
    if die is not None:
        sys.stdout.flush()
        os._exit(ELASTIC_EXIT_CODE)


def write_ctr_files(seed, tmp):
    """Each (b) trainer's CTR_FILES MultiSlot files (26 ids, 13 floats, the
    label a line) from ``seed``: {trainer: [paths]}."""
    v, f, d = CTR["vocab_size"], CTR["num_fields"], CTR["dense_dim"]
    n = CTR_FILE_BATCHES * DEEPFM_BATCH
    line = f"{f} " + " ".join(["%d"] * f) + f" {d} " + \
        " ".join(["%.6f"] * d) + " 1 %d"
    files = {}
    for k in range(PS_TRAINERS):
        rng = np.random.RandomState(seed + CTR_SEED + k)
        files[k] = []
        for i in range(CTR_FILES):
            ids = (rng.zipf(CTR_ZIPF, (n, f)) - 1) % v
            x = rng.rand(n, d).astype(np.float32)
            label = ((ids % 5 - 2).sum(1) > 0).astype(np.int64)
            lines = [line % (*a, *b, c) for a, b, c in zip(
                ids.tolist(), x.tolist(), label.tolist())]
            path = os.path.join(tmp, f"ctr_{k}_{i}.txt")
            with open(path + ".tmp", "w") as fh:
                fh.write("\n".join(lines) + "\n")
            os.replace(path + ".tmp", path)
            files[k].append(path)
    return files


def ctr_file_names(tmp):
    """The paths ``write_ctr_files`` gives ``tmp``'s files, by trainer."""
    return {k: [os.path.join(tmp, f"ctr_{k}_{i}.txt")
                for i in range(CTR_FILES)] for k in range(PS_TRAINERS)}


def ctr_parse_seconds(path):
    """Seconds the MultiSlot parser takes over one file (read beforehand),
    and the file's lines."""
    from paddle_tpu_torch import native

    with open(path, "rb") as fh:
        text = fh.read()
    parser = native.MultiSlotParser(["int64", "float", "int64"])
    t0 = time.perf_counter()
    n, _ = parser.parse(text)
    return time.perf_counter() - t0, n


def ctr_params(built, scope):
    """DeepFM's parameters and tables in ``scope``, by name (tensors)."""
    return {p.name: scope.find_var(p.name).get() for p, _ in built[3]}


def ctr_local(built, seed, device, feeds):
    """The untranspiled CTR program's SGD run: its losses, step ms and
    final parameters."""
    import paddle_tpu_torch as pt

    model, main, startup, _ = built
    exe, scope = pt.Executor(ps_place(device)), pt.Scope()
    np.random.seed(seed)
    exe.run(startup, scope=scope)
    losses, step_ms = [], []
    for feed in feeds:
        t0 = time.perf_counter()
        losses.append(exe.run(main, feed=feed, fetch_list=[model["loss"]],
                              scope=scope)[0])
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return losses, step_ms, ctr_params(built, scope)


def ctr_lockstep(built, seed, device, cluster, feeds):
    """(a): 1 trainer, the runner in lockstep (push_window 1,
    pull_dense_every 1) against the cluster's 2 async pservers; its
    losses and every parameter and table pulled back from the pservers
    torch.equal to the local SGD run; the step split into pull, compute
    and push over the steps after the first, the last profiled."""
    import torch

    from paddle_tpu_torch.distributed.downpour_worker import DownpourRunner

    model, main = built[0], built[1]
    local, local_ms, local_final = ctr_local(built, seed, device, feeds)
    exe, scope, _, t = ps_trainer_setup(built, cluster.spec)
    runner = DownpourRunner(t, program=main, scope=scope, executor=exe,
                            push_window=1, pull_dense_every=1)
    losses, prof = [], None
    for i, feed in enumerate(feeds):
        if i == 1:
            runner.reset_stats()
        if i == len(feeds) - 1:
            stats = dict(runner.stats)
            res, prof = profile("Downpour CTR step (lockstep)",
                                lambda: runner.run_step(feed,
                                                        [model["loss"]]))
        else:
            res = runner.run_step(feed, [model["loss"]])
        losses.append(res[0])
    runner.drain()
    pulled = {n: torch.from_numpy(v)
              for n, v in runner._fleet_pull.pull_dense_vars_sync().items()}
    for w in runner.table_ids:
        ids, rows = runner._fleet_pull.pull_sparse_rows_sync(
            w, np.arange(CTR["vocab_size"]))
        if ids.size != CTR["vocab_size"]:
            raise AssertionError(f"ctr (a): table {w} pulled {ids.size} rows")
        pulled[w] = torch.from_numpy(rows)
    runner.finish()
    ps_complete(cluster.spec)
    differ = sorted(n for n, v in local_final.items()
                    if n not in pulled or not torch.equal(v.cpu(), pulled[n]))
    same_losses = all(torch.equal(torch.from_numpy(a), torch.from_numpy(b))
                      for a, b in zip(losses, local))
    n = stats["steps"]
    row = {"losses": [float(x) for x in losses],
           "local_losses": [float(x) for x in local],
           "bitwise": same_losses and not differ,
           "params_and_tables_compared": len(local_final),
           "differing": differ,
           "step_ms": {k: stats[k + "_s"] * 1e3 / n
                       for k in ("pull", "compute", "push")},
           "bytes_pulled_a_step": stats["pulled_bytes"] / n,
           "bytes_pushed_a_step": stats["pushed_bytes"] / n,
           "local_step_ms": float(np.mean(local_ms[1:])),
           "profiled_step": {k: prof[k] for k in (
               "wall_ms", "device_ms", "device_idle_share")}}
    if not row["bitwise"]:
        raise AssertionError("ctr (a): the lockstep Downpour run is not "
                             "bitwise the local SGD run " + json.dumps(row))
    return row


def ctr_hogwild(built, seed, device, files):
    """(c): train_from_dataset's local loop over ``files`` with one reader
    thread, through DeviceFeeder, against Executor.run on the same batches
    fed by hand: every loss torch.equal; the step ms of each, and the
    seconds the dataset takes to read, parse and batch the files alone."""
    import torch

    import paddle_tpu_torch as pt

    model, main, startup, _ = built
    t0 = time.perf_counter()
    batches = list(ctr_dataset(model, files)._iter_batches())
    batching_s = time.perf_counter() - t0
    runs = {}
    for how in ("hand", "dataset"):
        exe, scope = pt.Executor(ps_place(device)), pt.Scope()
        np.random.seed(seed)
        exe.run(startup, scope=scope)
        if device == "cuda":
            torch.cuda.synchronize()
        losses = []
        t0 = time.perf_counter()
        if how == "dataset":
            recording(exe, losses)
            exe.train_from_dataset(main, ctr_dataset(model, files),
                                   scope=scope, fetch_list=[model["loss"]])
        else:
            for feed in batches:
                losses.append(exe.run(main, feed=feed,
                                      fetch_list=[model["loss"]],
                                      scope=scope)[0])
        runs[how] = (losses, (time.perf_counter() - t0) * 1e3
                     / max(1, len(losses)))
    a, b = runs["dataset"][0], runs["hand"][0]
    row = {"batches": len(b), "bitwise": len(a) == len(b) and all(
        torch.equal(torch.from_numpy(x), torch.from_numpy(y))
        for x, y in zip(a, b)),
        "step_ms_through_device_feeder": runs["dataset"][1],
        "step_ms_hand_fed": runs["hand"][1],
        "read_parse_batch_s": batching_s,
        "first_loss": float(b[0]), "last_loss": float(b[-1])}
    if not row["bitwise"]:
        raise AssertionError("ctr (c): train_from_dataset's losses differ "
                             "from the hand-fed run's " + json.dumps(row))
    return row


def comm_leg(seed, device, cluster):
    """(e): the LM's worker program (forward and backward, the optimize
    ops dropped) on the trainer, each grad put to the Communicator, whose
    recv thread refreshes the parameters: the loss on the parameters it
    brings back once the steps are done (after two more rounds) is below
    the first step's, no error and no restart, every merged grad's
    sections reach the pservers (their optimize blocks, counted after
    stop()), 12/6/6 flash launches a step."""
    import torch

    from paddle_tpu_torch.communicator import Communicator
    from paddle_tpu_torch.core.program import OPTIMIZE

    built = build_train_program()
    model = built[0]
    exe, scope, _, t = ps_trainer_setup(built, cluster.spec)
    worker = built[1].clone()
    gb = worker.global_block()
    gb.ops = [op for op in gb.ops if op.op_role != OPTIMIZE]
    types = [op.type for op in gb.ops]
    comm = Communicator(t, scope)
    sent = {"merged": 0, "sections": 0}
    send = comm._send_grad

    def counted(gname, merged):
        send(gname, merged)
        sent["merged"] += 1
        sent["sections"] += len(t.param_plan[comm._grad_to_param[gname]])

    comm._send_grad = counted
    comm.start()
    feed = train_batch(seed, BATCH)
    losses, step_ms = [], []
    if device == "cuda":
        torch.cuda.synchronize()
    reset_kernel_counts()
    puts = 0
    for _ in range(COMM_STEPS):
        t0 = time.perf_counter()
        losses.append(float(exe.run(worker, feed=feed,
                                    fetch_list=[model["loss"]],
                                    scope=scope)[0]))
        for pname in t.param_plan:
            gname = t.grad_of[pname]
            comm.put(gname, scope.find_var(gname).get())
            puts += 1
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = kernel_counts()
    # the parameters the recv thread brings back once the grads landed:
    # the loss on them, after a round that began after the last put
    rounds = len(comm.recv_round_s)
    end = time.perf_counter() + PS_WAIT_S
    while len(comm.recv_round_s) < rounds + 2 and time.perf_counter() < end:
        time.sleep(0.05)
    refreshed = float(exe.run(worker, feed=feed, fetch_list=[model["loss"]],
                              scope=scope)[0])
    comm.stop()
    left = sum(q.qsize() for q in comm._queues.values())
    ps_complete(cluster.spec)
    res = cluster.wait()
    blocks = sum(len(r["block_ms"]) for r in res["pservers"])
    row = {"losses": losses, "loss_after_refresh": refreshed,
           "step_ms": float(np.mean(step_ms[1:])),
           "step_ms_each": step_ms, "puts": puts, "merged_sends": sent[
               "merged"], "sections_sent": sent["sections"],
           "pserver_blocks_run": blocks, "left_in_queues": left,
           "recv_rounds": len(comm.recv_round_s),
           "recv_round_s": comm.recv_round_s,
           "errors": [f"{n}: {e!r}" for n, e in comm.errors()],
           "restarts": comm.restarts(),
           "launches_a_step": {k: v // COMM_STEPS
                               for k, v in counts.items() if v}}
    want = lm_expected(types, COMM_STEPS)
    if not (refreshed < losses[0]) or row["errors"] or \
            len(comm.recv_round_s) < rounds + 2 or \
            any(row["restarts"].values()) or left or \
            blocks != sent["sections"] or counts != want:
        raise AssertionError("ctr (e): the Communicator's bars failed "
                             + json.dumps({**row, "want": want,
                                           "counts": counts}))
    return row, counts


def trainer_out(cluster):
    """What the cluster's spawned trainer wrote."""
    with open(next(p for p, n in cluster.outs.items()
                   if n["role"] != "pserver")) as f:
        return json.load(f)


def elastic_leg(seed, device, clean, crash):
    """(f): the clean run's ELASTIC_STEPS steps (a process of clean's);
    the crashing trainer (a process of crash's) exits after step
    ELASTIC_DIE_AFTER; its relaunch here resumes at ELASTIC_RESUME_AT and
    steps 3-7 are torch.equal to the clean run's; the pservers' step
    snapshots exist with their manifests; 12/6/6 flash launches a resumed
    step."""
    import glob

    import torch

    built = build_train_program()
    model = built[0]
    clean.wait_trainers()
    cleaned = trainer_out(clean)
    clean_losses = {int(k): v for k, v in cleaned["losses"].items()}
    crash.wait_trainers()
    died = trainer_out(crash)
    exe, scope, prog, t = ps_trainer_setup(built, crash.spec)
    if device == "cuda":
        torch.cuda.synchronize()
    reset_kernel_counts()
    start, resumed, resume_s, ckpt_s, step_ms = elastic_run(
        crash.spec, exe, scope, prog, t, model, crash.spec["ckpt_dir"],
        crash.spec["ps_dir"], ELASTIC_STEPS)
    counts = kernel_counts()
    ps_complete(crash.spec)
    snaps = sorted(glob.glob(os.path.join(crash.spec["ps_dir"], "ps_*",
                                          f"step_{ELASTIC_RESUME_AT}")))
    row = {"start": start, "crashed_after": max(map(int, died["losses"])),
           "clean_losses": [clean_losses[k] for k in sorted(clean_losses)],
           "resumed_losses": [resumed[k] for k in sorted(resumed)],
           "equal_from_resume": all(
               resumed[k] == clean_losses[k] for k in resumed),
           "crashed_run_equal": all(
               v == clean_losses[int(k)] for k, v in died["losses"].items()),
           "snapshots": [os.path.relpath(p, crash.spec["ps_dir"])
                         for p in snaps],
           "manifests": all(os.path.exists(os.path.join(p, "MANIFEST.json"))
                            for p in snaps),
           "resume_s": resume_s,
           "checkpoint_s": cleaned["checkpoint_s"] + ckpt_s,
           "step_ms": float(np.mean(cleaned["step_ms"][1:])),
           "launches_a_step": {k: v // len(resumed)
                               for k, v in counts.items() if v}}
    want = lm_expected([op.type for op in built[1].global_block().ops],
                       len(resumed))
    if start != ELASTIC_RESUME_AT or sorted(resumed) != list(
            range(ELASTIC_RESUME_AT, ELASTIC_STEPS)) or \
            not row["equal_from_resume"] or not row["crashed_run_equal"] \
            or len(snaps) != PS_PSERVERS or not row["manifests"] or \
            counts != want:
        raise AssertionError("ctr (f): elastic resume's bars failed "
                             + json.dumps({**row, "counts": counts,
                                           "want": want}))
    return row, counts


def ctr_phase(seed, device="cuda", card_tests_done=None):
    """Phase 3f in this process.  Every cluster's pservers start first, on
    the card: (a) DeepFM's 2 async pservers for the lockstep Downpour run
    (threads of one process), (b/d) 2 more through fleet's PS mode (a
    process each, fleet being one per process) for the 2 trainer
    processes that run ``train_from_dataset`` over their MultiSlot
    files, (e) the LM's 2 async Adam pservers for the Communicator, (f)
    2 sync Adam pservers for the clean elastic run and 2 for the crashing
    one (threads of one process a cluster), with each of those two
    trainers in a process of its own.  Then the data files (the fleet
    trainers wait for them), the legs (a), (c), (e) and (f)'s relaunch
    in this process, and (b)'s results.  ``card_tests_done``: a file
    that exists once the card tests beside this phase ended (each leg
    records whether it did)."""
    import torch

    from paddle_tpu_torch import native

    t_phase = time.perf_counter()
    laps, out, clusters = {}, {}, []

    def lap(name):
        laps[name] = time.perf_counter() - t_phase

    def beside():
        return card_tests_done is not None and \
            not os.path.exists(card_tests_done)

    tmp = tempfile.mkdtemp(prefix="ctr_phase_")
    try:
        files = ctr_file_names(tmp)     # written once the nodes start
        def cluster(*a, **k):
            clusters.append(PSCluster(tmp, *a, **k))
            return clusters[-1]

        def elastic(what, **trainer):
            return cluster(
                "elastic_" + what, device, seed, 1, True, one_process=True,
                spawn_trainers=[0],
                pserver={"heartbeat_timeout": PS_WAIT_S,
                         "ckpt_dir": os.path.join(tmp, "ck_" + what),
                         "ps_dir": os.path.join(tmp, "ps_" + what)},
                trainer={"role": "elastic_trainer", **trainer})

        lock = cluster("ctr_lockstep", device, seed, 1, False,
                       pserver={"program": "ctr"}, one_process=True)
        fleet_cl = cluster(
            "ctr_fleet", device, seed, PS_TRAINERS, False,
            spawn_trainers=range(PS_TRAINERS),
            pserver={"program": "ctr", "fleet": True},
            trainer={"role": "ctr_trainer", "files": files})
        comm = cluster("comm", device, seed, 1, False, one_process=True)
        clean = elastic("clean")
        crash = elastic("crash", die_after=ELASTIC_DIE_AFTER,
                        exit_code=ELASTIC_EXIT_CODE)
        lap("nodes started")
        if write_ctr_files(seed, tmp) != files:
            raise AssertionError("ctr: the data files' names moved")
        lap("data written")
        out["native"] = native.NATIVE
        out["parse"] = [dict(zip(("seconds", "lines"), ctr_parse_seconds(p)))
                        for p in files[0]]
        built = build_ctr_program()
        feeds = list(ctr_dataset(built[0], files[1][:1])._iter_batches())
        out["lockstep"] = dict(ctr_lockstep(
            built, seed, device, lock, feeds[:CTR_LOCKSTEP_STEPS]),
            beside_card_tests=beside())
        lock.wait()
        lap("(a) lockstep")
        log("ctr: (a) lockstep Downpour " + json.dumps(out["lockstep"]))
        out["hogwild"] = dict(ctr_hogwild(built, seed, device, files[0][:1]),
                              beside_card_tests=beside())
        lap("(c) hogwild")
        out["communicator"], out["launches_communicator"] = comm_leg(
            seed, device, comm)
        out["communicator"]["beside_card_tests"] = beside()
        lap("(e) communicator")
        log("ctr: (e) the Communicator " + json.dumps(out["communicator"]))
        out["elastic"], out["launches_elastic"] = elastic_leg(
            seed, device, clean, crash)
        out["elastic"]["beside_card_tests"] = beside()
        clean.wait()
        crash.wait()
        lap("(f) elastic")
        log("ctr: (f) elastic " + json.dumps(out["elastic"]))
        res = fleet_cl.wait()
        rows = []
        for r in res["trainers"]:
            st, tl = r["stats"], r["losses"]
            rows.append({
                "losses": tl, "first": tl[0],
                "last5_mean": float(np.mean(tl[-5:])),
                "ratio": float(np.mean(tl[-5:]) / tl[0]),
                "step_ms": {k: st[k + "_s"] * 1e3 / st["steps"]
                            for k in ("pull", "compute", "push")},
                "bytes_pulled_a_step": st["pulled_bytes"] / st["steps"],
                "bytes_pushed_a_step": st["pushed_bytes"] / st["steps"],
                "seconds": r["seconds"], "native": r["native"],
                "transpiled_by_fleet_contract":
                    r["transpiled_by_fleet_contract"]})
        out["async"] = {"trainers": rows,
                        "pservers_through_fleet": [r["fleet"] for r in
                                                   res["pservers"]]}
        lap("(b, d) async Downpour through fleet")
        log("ctr: (b, d) async Downpour " + json.dumps(out["async"]))
        want = CTR_FILES * CTR_FILE_BATCHES
        if not out["native"] or not all(r["native"] for r in rows) or \
                not all(out["async"]["pservers_through_fleet"]) or \
                any(len(r["losses"]) != want or not r["ratio"] < 0.6
                    or not r["transpiled_by_fleet_contract"] for r in rows):
            raise AssertionError("ctr (b, d): the async Downpour bars failed "
                                 + json.dumps(out["async"]))
    finally:
        for cl in clusters:
            cl.kill()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    if device == "cuda":
        torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t_phase
    out["laps_s"] = laps
    return out


def ctr_start(seed, tmp):
    """Starts phase 3f in a process of its own (``--ctr``) beside what
    runs next; ``ctr_wait`` collects it.  The file ``card_tests_done``
    in ``tmp`` is made once the card tests beside it ended."""
    import torch

    torch.cuda.empty_cache()
    res_path = os.path.join(tmp, "ctr.json")
    done = os.path.join(tmp, "card_tests_done")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--ctr", res_path, "--beside", done])
    return proc, res_path, done


def ctr_wait(started, card):
    """Waits for phase 3f's process; logs the phase's numbers on one line
    and returns them."""
    proc, res_path, _ = started
    if proc.wait(timeout=900) != 0:
        raise AssertionError(f"phase 3f failed in its process "
                             f"(exit {proc.returncode})")
    with open(res_path) as f:
        res = json.load(f)
    lock, comm, el = res["lockstep"], res["communicator"], res["elastic"]
    log(f"ctr ({card}) " + json.dumps({
        "native": res["native"], "parse_s_a_file": res["parse"],
        "lockstep": {k: lock[k] for k in (
            "bitwise", "step_ms", "local_step_ms", "bytes_pulled_a_step",
            "bytes_pushed_a_step", "profiled_step", "beside_card_tests")},
        "async": [{k: r[k] for k in (
            "first", "last5_mean", "ratio", "step_ms", "bytes_pulled_a_step",
            "bytes_pushed_a_step", "seconds", "native")}
            for r in res["async"]["trainers"]],
        "pservers_through_fleet": res["async"]["pservers_through_fleet"],
        "hogwild": res["hogwild"],
        "communicator": {k: comm[k] for k in (
            "loss_after_refresh", "step_ms", "merged_sends", "sections_sent",
            "pserver_blocks_run", "recv_rounds", "recv_round_s",
            "launches_a_step", "beside_card_tests")},
        "elastic": {k: el[k] for k in (
            "start", "equal_from_resume", "step_ms", "checkpoint_s",
            "resume_s", "snapshots", "launches_a_step", "beside_card_tests")},
        "seconds": res["seconds"], "laps_s": res["laps_s"]}))
    return res


# ---------------------------------------------------------------------------
# phase 3g: collective data-parallel training (a process of its own,
# ``--collective``; its ranks start through the port's launcher,
# ``--collective-rank``)
# ---------------------------------------------------------------------------

COLL_RANKS = 2              # ranks of the 2-rank legs, on the one card
COLL_WAIT_S = 600.0         # every wait's bound: the ranks, the nccl leg
COLL_NCCL_STEPS = 3         # (e): steps after the warm-up, both runs
# (d): a ResNet-50 stage shape of phase 8 (NHWC; batch 128 split over the
# ranks): the 3x3 conv of stage 1, 64 -> 64 channels, relu
COLL_CONV = dict(batch=128, h=56, w=56, cin=64, cout=64, k=3, s=1, p=1)
COLL_CONV_DTYPE = "bfloat16"


def coll_place(spec):
    import paddle_tpu_torch as pt

    return pt.CPUPlace() if spec["device"] == "cpu" else None


def coll_lm(optimizer_fn):
    """The LM of phase 5 in programs of its own, ``optimizer_fn(loss)``
    appending its optimizer: (model, main, startup)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.transformer import \
        transformer_encoder_model

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        model = transformer_encoder_model(**dict(MODEL, is_test=False))
        optimizer_fn(model["loss"])
    return model, main, startup


def coll_expected(spec, types):
    """The LM's launches over the counted steps, the kernels' names with
    a count (on the CPU the plain versions run: 0 each)."""
    want = {k: v for k, v in lm_expected(types, TRAIN_STEPS).items() if v}
    return want if spec["device"] != "cpu" else dict.fromkeys(want, 0)


def coll_feed(seed, rank, ranks):
    """This rank's rows of phase 5's batch."""
    half = BATCH // ranks
    return {n: v[rank * half:(rank + 1) * half]
            for n, v in train_batch(seed, BATCH).items()}


def coll_sync(spec):
    import torch

    if spec["device"] != "cpu":
        torch.cuda.synchronize()


def coll_equal_across(named, group, ranks):
    """Names whose tensors differ in any bit between the ranks (each
    tensor all-gathered)."""
    import torch

    from paddle_tpu_torch.parallel import env as penv

    return sorted(n for n, t in named.items()
                  if not all(torch.equal(g, penv.collective(
                      "all_gather", t, group, ranks)[0])
                      for g in penv.collective("all_gather", t, group,
                                               ranks)[1:]))


def coll_fleet_leg(spec, zero):
    """(a) / (b): the LM through fleet's collective mode (ZeRO stage
    ``zero``): a warm-up and TRAIN_STEPS counted steps on this rank's rows;
    the losses, step ms, replayed launches, the optimizer state's bytes,
    the peak memory, the bytes the gradient collectives moved, a profiled
    step (rank 0) and the parameters equal across the ranks."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.fleet import DistributedStrategy, fleet
    from paddle_tpu_torch.parallel import env as penv
    from paddle_tpu_torch.parallel.zero import collect_optimizer_state

    rank, ranks = penv.rank(), penv.world_size()
    strategy = DistributedStrategy()
    strategy.zero_stage = zero
    model, main, startup = coll_lm(
        lambda loss: fleet.distributed_optimizer(
            pt.optimizer.Adam(TRAIN_LR), strategy).minimize(loss))
    prog = fleet.main_program
    exe, scope = pt.Executor(coll_place(spec)), pt.Scope()
    np.random.seed(spec["seed"])
    exe.run(startup, scope=scope)
    feed = coll_feed(spec["seed"], rank, ranks)

    def step():
        return float(exe.run(prog, feed=feed, fetch_list=[model["loss"]],
                             scope=scope)[0])

    # the phase's own runs share the card until it makes this file
    t_go = time.perf_counter()
    while not os.path.exists(spec["go"]):
        if time.perf_counter() - t_go > COLL_WAIT_S:
            raise AssertionError("phase 3g: the phase's runs never ended")
        time.sleep(0.05)
    if spec["device"] != "cpu":
        torch.cuda.reset_peak_memory_stats()
    warm = step()
    coll_sync(spec)
    before, routes0 = prog.replayed_launches(), penv.routes()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    after, routes1 = prog.replayed_launches(), penv.routes()
    launches = {k: after.get(k, 0) - before.get(k, 0)
                for k in set(after) | set(before)}
    moved = {k: (v["bytes"] - routes0.get(k, {}).get("bytes", 0))
             / TRAIN_STEPS for k, v in routes1.items()
             if k.split()[0] in ("all_reduce", "reduce_scatter",
                                 "all_gather")}
    # ZeRO's rows stay in the compiled program, out of the scope
    rows = prog.sharded_state()
    state_bytes = sum(t.numel() * t.element_size() for t in (
        rows[n] if n in rows else scope.find_var(n).get()
        for n in collect_optimizer_state(main)))
    peak = torch.cuda.max_memory_allocated() / 1e9 \
        if spec["device"] != "cpu" else None
    group = penv.get_mesh().group("dp")
    params = {p.name: scope.find_var(p.name).get().clone()
              for p in main.all_parameters()}
    differing = coll_equal_across(params, group, ranks)
    # one step more, profiled on rank 0 (the other ranks step beside it)
    if rank == 0 and spec["device"] != "cpu":
        _, prof = profile(f"collective step (zero {zero})", step)
    else:
        step()
        prof = None
    coll_sync(spec)
    types = [op.type for op in main.global_block().ops]
    want = coll_expected(spec, types)
    got = {k: launches.get(k, 0) for k in want}
    res = {"zero_stage": zero, "warmup_loss": warm, "losses": losses,
           "step_ms": step_ms, "launches": got, "launches_expected": want,
           "optimizer_state_bytes": state_bytes,
           "max_memory_allocated_gb": peak,
           "collective_bytes_a_step": moved,
           "params_differing_across_ranks": differing,
           "profiled_step": prof, "backend": penv.backend()}
    if rank == 0:
        final = {n: t.detach().to("cpu") for n, t in params.items()}
        torch.save(final, os.path.join(spec["dir"], f"params_zero{zero}.pt"))
    del prog, exe, scope, params
    fleet._compiled = None
    if spec["device"] != "cpu":
        torch.cuda.empty_cache()
    return res


def coll_transpiled_leg(spec):
    """(c): the LM with Adam, transpiled by GradAllReduce, through
    Executor.run on this rank's rows: the global loss (the ranks' local
    losses averaged) a step, the launches, and step 1's local loss and
    one reduced gradient (for (f))."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import env as penv

    rank, ranks = penv.rank(), penv.world_size()
    model, main, startup = coll_lm(
        lambda loss: pt.optimizer.Adam(TRAIN_LR).minimize(loss))
    eps = os.environ["PADDLE_TRAINER_ENDPOINTS"]
    pt.transpiler.GradAllReduce().transpile(
        startup, main, rank, eps, os.environ["PADDLE_CURRENT_ENDPOINT"])
    types = [op.type for op in main.global_block().ops]
    exe, scope = pt.Executor(coll_place(spec)), pt.Scope()
    np.random.seed(spec["seed"])
    exe.run(startup, scope=scope)
    feed = coll_feed(spec["seed"], rank, ranks)
    group = penv.get_mesh().group("dp")
    grad = main.all_parameters()[0].name + "@GRAD"

    def step(fetch=()):
        out = exe.run(main, feed=feed, fetch_list=[model["loss"], *fetch],
                      scope=scope, return_numpy=False)
        local = out[0].reshape(1).float()
        mean = penv.collective("all_reduce", local, group, ranks) / ranks
        return float(mean.item()), out

    warm, first = step(fetch=(grad,))
    coll_sync(spec)
    reset_kernel_counts()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step()[0])
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = kernel_counts()
    want = coll_expected(spec, types)
    res = {"losses": losses, "warmup_loss": warm, "step_ms": step_ms,
           "allreduce_ops": types.count("c_allreduce_sum"),
           "launches": {k: launches.get(k, 0) for k in want},
           "launches_expected": want}
    published = {"loss1": first[0].reshape(1).float(),
                 "grad1": first[1].float()}
    del exe, scope
    return res, published


def coll_conv_bn_leg(spec):
    """(d): conv2d_bn_train (kernels #6 and #7, flag conv_bn_stats "on")
    at COLL_CONV on this rank's images in a data-parallel step, forward
    and grad, against the op on the whole batch on one rank: Output,
    SavedMean, SavedVariance and the grads of Input, Filter, Scale and
    BNBias by scaled error (rank 0 compares); the DP call's launches."""
    import torch

    from paddle_tpu_torch.core.registry import get_op_def
    from paddle_tpu_torch.parallel import env as penv

    rank, ranks = penv.rank(), penv.world_size()
    mesh = penv.get_mesh()
    group = mesh.group("dp")
    c = COLL_CONV
    device = torch.device("cpu") if spec["device"] == "cpu" \
        else torch.device("cuda", penv.default_device_id())
    rng = np.random.RandomState(spec["seed"] + 41)
    x, w = conv_operands(rng, device, c["batch"], c["h"], c["w"], c["cin"],
                         c["cout"], c["k"], COLL_CONV_DTYPE)

    def f32(shape, lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
            np.float32)).to(device)

    scale, shift = f32((c["cout"],), 0.5, 1.5), f32((c["cout"],), -0.5, 0.5)
    mean_in, var_in = f32((c["cout"],), -0.1, 0.1), f32((c["cout"],), 0.5, 2)
    oh = (c["h"] + 2 * c["p"] - c["k"]) // c["s"] + 1
    ow = (c["w"] + 2 * c["p"] - c["k"]) // c["s"] + 1
    dy = torch.from_numpy(rng.standard_normal(
        (c["batch"], oh, ow, c["cout"])).astype(np.float32)).to(
        device, x.dtype)
    attrs = {"strides": [c["s"]] * 2, "paddings": [c["p"]] * 2,
             "act": "relu", "groups": 1, "epsilon": 1e-5, "momentum": 0.9,
             "data_format": "NHWC", "epilogue": ""}
    fwd = get_op_def("conv2d_bn_train")
    bwd = get_op_def("conv2d_bn_train_grad")

    def run(xs, dys):
        ins = {"Input": xs, "Filter": w, "Scale": scale, "BNBias": shift,
               "Mean": mean_in, "Variance": var_in}
        out = fwd.compute(ins, attrs, device)
        grads = bwd.compute({**ins, "Output@GRAD": dys}, attrs, device)
        return out, grads

    half = c["batch"] // ranks
    mine = slice(rank * half, (rank + 1) * half)
    with kernel_flag("conv_bn_stats", "on" if spec["device"] != "cpu"
                     else "interpret"):
        with torch.no_grad():
            whole = run(x, dy) if rank == 0 else None
            coll_sync(spec)
            reset_kernel_counts()
            with penv.data_parallel(mesh, "dp"):
                out, grads = run(x[mine], dy[mine])
            coll_sync(spec)
            launches = kernel_counts()
    gathered = {
        "Output": penv.collective("all_gather", out["Output"], group,
                                  ranks).reshape(c["batch"], oh, ow,
                                                 c["cout"]),
        "Input@GRAD": penv.collective(
            "all_gather", grads["Input@GRAD"], group, ranks).reshape(
            x.shape),
        **{k: penv.collective("all_reduce", grads[k], group, ranks)
           for k in ("Filter@GRAD", "Scale@GRAD", "BNBias@GRAD")},
        "SavedMean": out["SavedMean"], "SavedVariance": out["SavedVariance"]}
    stats_equal = not coll_equal_across(
        {"SavedMean": out["SavedMean"],
         "SavedVariance": out["SavedVariance"]}, group, ranks)
    res = {"shape": [c["batch"], c["h"], c["w"], c["cin"], c["cout"],
                     c["k"], c["s"], c["p"]], "dtype": COLL_CONV_DTYPE,
           "launches": {k: launches[k] for k in ("conv_stats", "bn_apply")},
           "stats_equal_across_ranks": stats_equal}
    if rank == 0:
        tol = {"Output": BN_TOL[COLL_CONV_DTYPE],
               "SavedMean": STATS_TOL[COLL_CONV_DTYPE],
               "SavedVariance": STATS_TOL[COLL_CONV_DTYPE],
               **{k: CONV_TOL[COLL_CONV_DTYPE] for k in (
                   "Input@GRAD", "Filter@GRAD", "Scale@GRAD",
                   "BNBias@GRAD")}}
        want = {**whole[0], **whole[1]}
        res["scaled_err"] = {k: scaled_err(gathered[k], want[k])
                             for k in tol}
        res["tolerance"] = tol
        res["held"] = all(res["scaled_err"][k] <= tol[k] for k in tol)
    return res


def coll_server_leg(spec, published):
    """(f): each rank publishes (c)'s step-1 local loss and one reduced
    gradient on a CollectiveServer; rank 0's CollectiveClient.gather
    equals c_allgather of the same values."""
    from paddle_tpu_torch.core.registry import get_op_def
    from paddle_tpu_torch.distributed import (CollectiveClient,
                                              CollectiveServer)
    from paddle_tpu_torch.parallel import env as penv

    import torch.distributed as dist

    rank, ranks = penv.rank(), penv.world_size()
    server = CollectiveServer().start()
    for name, value in published.items():
        server.register_var(name, value)
    eps = [None] * ranks
    dist.all_gather_object(eps, server.endpoint)
    allgather = get_op_def("c_allgather")
    via_op = {n: allgather.compute({"X": v}, {"ring_id": 0, "nranks": ranks},
                                   v.device)["Out"]
              for n, v in published.items()}
    res = {"endpoints": eps}
    if rank == 0:
        client = CollectiveClient()
        t0 = time.perf_counter()
        got = {n: client.gather([(ep, n) for ep in eps])
               for n in published}
        res["gather_s"] = time.perf_counter() - t0
        client.close()
        res["equal"] = {n: bool(np.array_equal(
            np.concatenate([np.asarray(a) for a in got[n]]),
            via_op[n].float().cpu().numpy())) for n in published}
        res["losses_gathered"] = [float(np.asarray(a).reshape(-1)[0])
                                  for a in got["loss1"]]
    penv.barrier()
    server.stop()
    return res


def coll_allreduce_ms(spec, nbytes, reps=3):
    """The median ms of one all-reduce of ``nbytes`` of f32 on this rank's
    device (every rank calls it), synchronised on both sides."""
    import torch

    from paddle_tpu_torch.parallel import env as penv

    device = "cpu" if spec["device"] == "cpu" \
        else f"cuda:{penv.default_device_id()}"
    t = torch.ones(int(nbytes) // 4, device=device)
    group = penv.get_mesh().group("dp")
    times = []
    for _ in range(reps):
        coll_sync(spec)
        penv.barrier()
        t0 = time.perf_counter()
        penv.collective("all_reduce", t, group, penv.world_size())
        coll_sync(spec)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def collective_rank(spec_path):
    """One rank of phase 3g (``--collective-rank``), started by the port's
    launcher with the PADDLE_* contract: legs (a), (b), (c), (d) and (f);
    writes ``rank<r>.json`` into the spec's directory."""
    global BATCH

    with open(spec_path) as f:
        spec = json.load(f)
    MODEL.update(spec["model"])
    BATCH = spec["batch"]
    COLL_CONV.update(spec["conv"])
    from paddle_tpu_torch.fleet import PaddleCloudRoleMaker, fleet
    from paddle_tpu_torch.parallel import env as penv

    t0 = time.perf_counter()
    fleet.init(PaddleCloudRoleMaker(), place=coll_place(spec))
    rank = penv.rank()
    laps = {"init": time.perf_counter() - t0}
    res = {"rank": rank, "world": penv.world_size(),
           "backend": penv.backend(), "device": str(penv.device())}
    for key, fn in (("fleet", lambda: coll_fleet_leg(spec, 0)),
                    ("zero1", lambda: coll_fleet_leg(spec, 1))):
        t = time.perf_counter()
        res[key] = fn()
        laps[key] = time.perf_counter() - t
    t = time.perf_counter()
    res["transpiled"], published = coll_transpiled_leg(spec)
    laps["transpiled"] = time.perf_counter() - t
    t = time.perf_counter()
    res["conv_bn"] = coll_conv_bn_leg(spec)
    laps["conv_bn"] = time.perf_counter() - t
    t = time.perf_counter()
    res["server"] = coll_server_leg(spec, published)
    laps["server"] = time.perf_counter() - t
    grad_bytes = sum(res["fleet"]["collective_bytes_a_step"].values())
    res["allreduce_ms"] = coll_allreduce_ms(spec, grad_bytes)
    res["routes"] = penv.routes()
    res["laps_s"] = laps
    fleet.barrier_worker()
    penv.shutdown()
    with open(os.path.join(spec["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def coll_local_runs(seed, device):
    """In this process, the LM compiled at batch 8 from the same start as
    the ranks: (e) a one-rank nccl group (the backend's rule picks nccl
    for one rank on the card), the plain step against the data-parallel
    one bitwise, whose gradient all-reduce is captured in the graph; and
    the reference of (a) that reproduces its sums: each half's forward
    and backward, their gradients averaged as the ranks' all-reduce
    averages them, then the optimizer's ops."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.data_parallel import PlanStep, step_grads
    from paddle_tpu_torch.parallel import env as penv

    place = pt.CPUPlace() if device == "cpu" else pt.CUDAPlace(0)
    backend = penv.init_parallel_env(0, 1, f"127.0.0.1:{_free_port()}",
                                     place=place)
    model, main, startup = coll_lm(
        lambda loss: pt.optimizer.Adam(TRAIN_LR).minimize(loss))
    loss = model["loss"]
    feed = train_batch(seed, BATCH)

    def start():
        exe, scope = pt.Executor(place), pt.Scope()
        np.random.seed(seed)
        exe.run(startup, scope=scope)
        return exe, scope

    def params(scope):
        return {p.name: scope.find_var(p.name).get().detach().to(
            "cpu").clone() for p in main.all_parameters()}

    runs = {}
    for what in ("plain", "data_parallel"):
        exe, scope = start()
        prog = pt.CompiledProgram(main)
        if what == "data_parallel":
            prog = prog.with_data_parallel(loss_name=loss.name)
        losses, step_ms = [], []
        for i in range(1 + TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(float(exe.run(prog, feed=feed, fetch_list=[loss],
                                        scope=scope)[0]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        captured = any(
            seg.graph is not None and any(isinstance(rop, PlanStep)
                                          for rop, _ in seg.steps)
            for e in prog._cache.values() for seg in e.segments)
        runs[what] = {"losses": losses, "step_ms": step_ms[1:],
                      "final": params(scope), "captured": captured,
                      "graphs": prog.graph_stats()}
        del exe, scope, prog
    plain, dp = runs["plain"], runs["data_parallel"]
    nccl = {"backend": backend, "routes": penv.routes(),
            "losses_equal": plain["losses"] == dp["losses"],
            "losses": dp["losses"],
            "params_differing": sorted(
                n for n in plain["final"]
                if not torch.equal(plain["final"][n], dp["final"][n])),
            "all_reduce_captured": dp["captured"], "graphs": dp["graphs"]}
    penv.shutdown()

    # the reference of the 2-rank run: halves, gradients averaged
    ops = main.global_block().ops
    _, grads = step_grads(ops)
    grad_prog, opt_prog = main.clone(), main.clone()
    grad_prog.global_block().ops = [op for op in grad_prog.global_block().ops
                                    if op.op_role != "optimize"]
    opt_prog.global_block().ops = [op for op in opt_prog.global_block().ops
                                   if op.op_role == "optimize"]
    half = BATCH // COLL_RANKS

    def emulated():
        exe, scope = start()
        losses = []
        for _ in range(1 + TRAIN_STEPS):
            outs = [exe.run(grad_prog, feed={
                n: v[r * half:(r + 1) * half] for n, v in feed.items()},
                fetch_list=[loss, *grads], scope=scope, return_numpy=False)
                for r in range(COLL_RANKS)]
            total = outs[0]
            for o in outs[1:]:
                total = [a + b for a, b in zip(total, o)]
            losses.append(float((total[0] / COLL_RANKS).reshape(-1)[0]))
            for g, v in zip(grads, total[1:]):
                scope.var(g).set(v / COLL_RANKS)
            exe.run(opt_prog, scope=scope)
        out = {"losses": losses, "final": params(scope)}
        del exe, scope
        return out

    if device != "cpu":
        torch.cuda.empty_cache()
    return {"plain": plain, "nccl": nccl, "emulated": emulated()}, emulated


def coll_spawn(tmp, spec, nproc):
    """The port's launcher starting ``nproc`` ranks of ``--collective-rank``
    with ``spec``; returns the launcher's process."""
    port = _free_port()
    path = os.path.join(tmp, f"spec_{spec['leg']}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.launch", "--nproc_per_node",
         str(nproc), "--started_port", str(port), os.path.abspath(__file__),
         "--collective-rank", path], env=env, cwd=root)


def coll_wait(proc, what):
    try:
        code = proc.wait(timeout=COLL_WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"phase 3g: {what} outlasted {COLL_WAIT_S} s")
    if code != 0:
        raise AssertionError(f"phase 3g: {what} failed (exit {code})")


def coll_gap(a, b):
    """Max abs difference of two runs: losses and parameters."""
    return {"loss": max(abs(x - y) for x, y in zip(a["losses"],
                                                   b["losses"])),
            "param": max(float((a["final"][n] - b["final"][n]).abs().max())
                         for n in a["final"])}


def collective_phase(seed, device="cuda"):
    """Phase 3g (see the module docstring): the 2-rank legs through the
    launcher, started first; beside their start, this process's own runs
    ((e) and the reference of (a)); then every bar."""
    import torch

    t_phase = time.perf_counter()
    laps = {}
    with tempfile.TemporaryDirectory() as tmp:
        go = os.path.join(tmp, "go")
        spec = {"seed": seed, "device": device, "dir": tmp, "model": MODEL,
                "batch": BATCH, "conv": COLL_CONV, "leg": "ranks", "go": go}
        proc = coll_spawn(tmp, spec, COLL_RANKS)
        try:
            t = time.perf_counter()
            local, emulate = coll_local_runs(seed, device)
            laps["local_runs"] = time.perf_counter() - t
        except BaseException:
            proc.kill()
            proc.wait()
            raise
        open(go, "w").close()          # the ranks' counted steps may start
        t = time.perf_counter()
        coll_wait(proc, "the 2-rank legs")
        laps["ranks_after_local_runs"] = time.perf_counter() - t
        ranks = []
        for r in range(COLL_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        dp_run = {"losses": None, "final": torch.load(
            os.path.join(tmp, "params_zero0.pt"))}
    r0 = ranks[0]
    fl, zr, tr = r0["fleet"], r0["zero1"], r0["transpiled"]
    dp_run["losses"] = [fl["warmup_loss"]] + fl["losses"]
    failures = []
    for leg in ("fleet", "zero1"):
        if any(r[leg]["losses"] != r0[leg]["losses"] for r in ranks):
            failures.append(f"{leg}: the ranks' losses differ")
        if r0[leg]["params_differing_across_ranks"]:
            failures.append(f"{leg}: parameters differ across the ranks: "
                            f"{r0[leg]['params_differing_across_ranks'][:5]}")
    for leg in ("fleet", "zero1", "transpiled"):
        for r in ranks:
            if r[leg]["launches"] != r[leg]["launches_expected"]:
                failures.append(f"{leg} rank {r['rank']}: launches "
                                f"{r[leg]['launches']}, expected "
                                f"{r[leg]['launches_expected']}")
    # (a) against the reference that reproduces its sums: bitwise, else
    # within twice the spread of two such references
    ref = local["emulated"]
    gap = coll_gap(dp_run, ref)
    bitwise = gap == {"loss": 0.0, "param": 0.0}
    spread = None
    if not bitwise:
        spread = coll_gap(ref, emulate())
        if gap["loss"] > 2 * spread["loss"] or \
                gap["param"] > 2 * spread["param"]:
            failures.append(f"fleet: {gap} from the reference, beyond twice "
                            f"its spread {spread}")
    bar_loss = 2 * spread["loss"] if spread else 0.0
    # (b), (c): their losses within (a)'s bar of the same reference
    others = {}
    for leg, row in (("zero1", zr), ("transpiled", tr)):
        d = max(abs(a - b) for a, b in zip(
            [row["warmup_loss"]] + row["losses"], ref["losses"]))
        others[leg] = d
        if d > bar_loss:
            failures.append(f"{leg}: losses {d} from the reference, beyond "
                            f"(a)'s bar {bar_loss}")
    state_share = zr["optimizer_state_bytes"] / fl["optimizer_state_bytes"]
    if not 0.45 <= state_share <= 0.55:
        failures.append(f"zero1: a rank's optimizer state is {state_share} "
                        "of (a)'s")
    cb, nccl = r0["conv_bn"], local["nccl"]
    if not cb["held"] or not cb["stats_equal_across_ranks"]:
        failures.append(f"conv_bn: {cb}")
    if device != "cpu" and any(r["conv_bn"]["launches"] != {
            "conv_stats": 2, "bn_apply": 2} for r in ranks):
        failures.append("conv_bn: launches "
                        f"{[r['conv_bn']['launches'] for r in ranks]}")
    if not nccl["losses_equal"] or nccl["params_differing"]:
        failures.append(f"nccl: the data-parallel step differs from the "
                        f"plain one: {nccl['params_differing'][:5]}")
    if device != "cpu" and (nccl["backend"] != "nccl"
                            or not nccl["all_reduce_captured"]):
        failures.append(f"nccl: backend {nccl['backend']}, captured "
                        f"{nccl['all_reduce_captured']}")
    if not all(r0["server"]["equal"].values()):
        failures.append(f"server: {r0['server']['equal']}")
    res = {
        "backend": sorted({r["backend"] for r in ranks}),
        "fleet": {"losses": fl["losses"], "step_ms": fl["step_ms"],
                  "local_step_ms": local["plain"]["step_ms"],
                  "bitwise_reference": bitwise, "to_reference": gap,
                  "spread_of_two_references": spread,
                  "to_plain_batch8": coll_gap(dp_run, local["plain"]),
                  "launches": fl["launches"],
                  "collective_bytes_a_step": fl["collective_bytes_a_step"],
                  "allreduce_ms": [r["allreduce_ms"] for r in ranks],
                  "profiled_step": fl["profiled_step"] and {
                      k: fl["profiled_step"][k] for k in (
                          "wall_ms", "device_ms", "device_idle_share")},
                  "max_memory_allocated_gb": [r["fleet"][
                      "max_memory_allocated_gb"] for r in ranks],
                  "optimizer_state_bytes": fl["optimizer_state_bytes"]},
        "zero1": {"losses": zr["losses"], "step_ms": zr["step_ms"],
                  "loss_to_reference": others["zero1"],
                  "losses_equal_to_fleet": zr["losses"] == fl["losses"],
                  "optimizer_state_bytes": zr["optimizer_state_bytes"],
                  "state_share_of_replicated": state_share,
                  "collective_bytes_a_step": zr["collective_bytes_a_step"],
                  "profiled_step": zr["profiled_step"] and {
                      k: zr["profiled_step"][k] for k in (
                          "wall_ms", "device_ms", "device_idle_share")},
                  "max_memory_allocated_gb": [r["zero1"][
                      "max_memory_allocated_gb"] for r in ranks]},
        "transpiled": {"losses": tr["losses"], "step_ms": tr["step_ms"],
                       "loss_to_reference": others["transpiled"],
                       "losses_equal_to_fleet": tr["losses"] == fl["losses"],
                       "allreduce_ops": tr["allreduce_ops"],
                       "launches": tr["launches"]},
        "conv_bn": cb, "nccl": nccl, "server": r0["server"],
        "routes": [r["routes"] for r in ranks],
        "rank_laps_s": [r["laps_s"] for r in ranks],
        "laps_s": laps, "seconds": time.perf_counter() - t_phase}
    log("collective " + json.dumps(res))
    if failures:
        raise AssertionError("phase 3g: " + "; ".join(failures))
    return res


def collective_apart(seed, card):
    """Phase 3g in a process of its own (``--collective``); returns its
    numbers, logged beside the card's line."""
    import torch

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        res_path = os.path.join(tmp, "collective.json")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--collective", res_path], timeout=COLL_WAIT_S * 2)
        if proc.returncode != 0:
            raise AssertionError(f"phase 3g failed in its process "
                                 f"(exit {proc.returncode})")
        with open(res_path) as f:
            res = json.load(f)
    fl = res["fleet"]
    log(f"collective ({card}) " + json.dumps({
        "backend": res["backend"], "step_ms": fl["step_ms"],
        "local_step_ms": fl["local_step_ms"],
        "allreduce_ms": fl["allreduce_ms"],
        "bytes_a_step": fl["collective_bytes_a_step"],
        "idle": fl["profiled_step"], "zero1_state_share":
            res["zero1"]["state_share_of_replicated"],
        "nccl_captured": res["nccl"]["all_reduce_captured"],
        "seconds": res["seconds"]}))
    return res


# ---------------------------------------------------------------------------
# phase 3h: GSPMD training and the tp-sharded Predictor (a process of its
# own, ``--gspmd``; its ranks start through the port's launcher,
# ``--gspmd-rank``)
# ---------------------------------------------------------------------------

GSPMD_RANKS = 2
GSPMD_STEPS = 3             # counted steps after the warm-up, every leg
GSPMD_WAIT_S = 600.0
# the sampled gradients, gathered by the fetch: (a)'s column- and
# row-parallel weights and the output projection (ZeRO-3 in (b))
GSPMD_GRADS = ("tfm_l0_self_q.w@GRAD", "tfm_l0_ffn_fc2.w@GRAD",
               "tfm_out_fc.w@GRAD")
GSPMD_FAULT = "tfm_l0_self_v.w"
# the reference's steps whose gradients the legs are held to: the first
# counted step (the planted fault's) and the last
GSPMD_HELD_STEPS = (1, GSPMD_STEPS)
# serving_tp_sharded's shape (bench.py:1108-1190): 256 -> 1024 x3 (relu)
# -> 256 at batch 8
TP_CHAIN = dict(batch=8, in_dim=256, hidden=1024, depth=3, out_dim=256)
TP_RUNS = 20


def gspmd_place(spec):
    import paddle_tpu_torch as pt

    return pt.CPUPlace() if spec["device"] == "cpu" else None


def gspmd_program():
    """tf_train_gspmd's program as bench.py:307-386 builds it with gspmd:
    the LM with param_prefix "tfm", AMP decorate(Adam(TRAIN_LR)) with
    static loss scaling 1.0, one adam op a parameter, fc_epilogue off:
    (model, main, startup)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    from paddle_tpu_torch.models.transformer import \
        transformer_encoder_model

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        model = transformer_encoder_model(**dict(MODEL, is_test=False,
                                                 param_prefix="tfm"))
        decorate(pt.optimizer.Adam(TRAIN_LR, fuse=False),
                 init_loss_scaling=1.0,
                 use_dynamic_loss_scaling=False).minimize(model["loss"])
    return model, main, startup


def gspmd_steps(spec, exe, prog, scope, feed, fetch):
    """A warm-up and GSPMD_STEPS counted steps of ``prog``: the fetches of
    every step, each counted step's wall and event ms, the replayed
    launches of the counted steps."""
    import torch

    cuda = spec["device"] != "cpu"
    outs = [exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)]
    before = prog.replayed_launches()
    wall, event = [], []
    for _ in range(GSPMD_STEPS):
        if cuda:
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
        t0 = time.perf_counter()
        outs.append(exe.run(prog, feed=feed, fetch_list=fetch, scope=scope))
        wall.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            e1.record()
            e1.synchronize()
            event.append(e0.elapsed_time(e1))
    after = prog.replayed_launches()
    launches = {k: after.get(k, 0) - before.get(k, 0)
                for k in set(after) | set(before)
                if after.get(k, 0) != before.get(k, 0)}
    return outs, {"wall_ms": wall, "event_ms": event,
                  "launches": launches}


def gspmd_bar(losses, grads, ref_losses, ref_grads):
    """The AMP bars of phase 7 against the one-rank run: each loss within
    AMP_LOSS_RTOL; each sampled gradient within AMP_GRAD_NORM_RTOL of its
    norm, within AMP_GRAD_BULK_RTOL of its scale in all but
    AMP_GRAD_BULK_SHARE of its elements and within AMP_GRAD_MAX_RTOL
    everywhere.  Returns (held, the numbers)."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    rows = {}
    for n, want in ref_grads.items():
        got = np.asarray(grads[n], dtype=np.float64)
        want = np.asarray(want, dtype=np.float64)
        diff = np.abs(got - want)
        scale = max(float(np.abs(want).max()), 1e-30)
        rows[n] = {"max_rel_to_scale": float(diff.max()) / scale,
                   "share_beyond_bulk": float(
                       (diff > AMP_GRAD_BULK_RTOL * scale).mean()),
                   "norm_rel": float(np.linalg.norm(diff)) / max(
                       float(np.linalg.norm(want)), 1e-30)}
    held = loss_rel <= AMP_LOSS_RTOL and all(
        r["max_rel_to_scale"] <= AMP_GRAD_MAX_RTOL
        and r["share_beyond_bulk"] <= AMP_GRAD_BULK_SHARE
        and r["norm_rel"] <= AMP_GRAD_NORM_RTOL for r in rows.values())
    return held, {"loss_rel": loss_rel, "grads": rows}


def _digest(a):
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def gspmd_wait_go(spec):
    t_go = time.perf_counter()
    while not os.path.exists(spec["go"]):
        if time.perf_counter() - t_go > GSPMD_WAIT_S:
            raise AssertionError("phase 3h: the phase's runs never ended")
        time.sleep(0.05)


def gspmd_train_leg(spec, plan_kw, fault):
    """(a) / (b): the program through shard_program(MeshPlan(**plan_kw))
    on this rank's rows of the data axis (AMP_BATCH rows in all): a
    warm-up and GSPMD_STEPS counted steps held to the one-rank run, the
    flash kernels' shapes, the blocks and their bytes, a profiled step;
    with ``fault`` the planted fault's step after the start restored."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel import env as penv
    from paddle_tpu_torch.parallel.gspmd import MeshPlan
    from paddle_tpu_torch.transpiler import shard_program

    rank = penv.rank()
    model, main, startup = gspmd_program()
    exe, scope = pt.Executor(gspmd_place(spec)), pt.Scope()
    np.random.seed(spec["seed"])
    exe.run(startup, scope=scope)
    names = [v.name for v in main.persistables() if not v.is_data]
    start = {n: scope.find_var(n).get().clone() for n in names}
    plan = MeshPlan(**plan_kw)
    pt.set_flags({"gspmd": True})
    try:
        prog = shard_program(pt.CompiledProgram(main), plan,
                             loss_name=model["loss"].name)
    finally:
        pt.set_flags({"gspmd": False})
    di, dp = penv.get_mesh().axis_index("dp"), plan.axis_size("dp")
    rows = AMP_BATCH // dp
    feed = {k: v[di * rows:(di + 1) * rows]
            for k, v in train_batch(spec["seed"], AMP_BATCH).items()}
    fetch = [model["loss"].name, *GSPMD_GRADS]
    # the flash kernels' operands, as the warm-up (eager, then the
    # capture) hands them to the kernel entry (the forward op's and the
    # grad op's, which recomputes the forward)
    shapes = set()
    entry = fa.flash_attention_lse

    def rec(q, *a, **k):
        shapes.add(("flash_attention_lse", tuple(q.shape), str(q.dtype)))
        return entry(q, *a, **k)

    gspmd_wait_go(spec)
    if spec["device"] != "cpu":
        torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_lse = rec
    try:
        outs, timing = gspmd_steps(spec, exe, prog, scope, feed, fetch)
    finally:
        fa.flash_attention_lse = entry
    blocks = prog.sharded_state()
    tracked = [v.name for v in main.all_parameters()] + [
        n for n in names if "_moment" in n]
    held_bytes = sum((blocks[n] if n in blocks else start[n]).numel()
                     * start[n].element_size() for n in tracked)
    whole_bytes = sum(start[n].numel() * start[n].element_size()
                      for n in tracked)
    sharded_whole = sum(start[n].numel() * start[n].element_size()
                        for n in tracked if n in blocks)
    sharded_held = sum(blocks[n].numel() * blocks[n].element_size()
                       for n in tracked if n in blocks)
    peak = torch.cuda.max_memory_allocated() / 1e9 \
        if spec["device"] != "cpu" else None
    ref = np.load(os.path.join(spec["dir"], "reference.npz"))
    ref_losses = [float(x) for x in ref["losses"]]
    losses = [float(np.asarray(o[0]).reshape(-1)[0]) for o in outs]
    bars = {}
    for s in GSPMD_HELD_STEPS:
        bars[s] = gspmd_bar(
            losses, dict(zip(GSPMD_GRADS, outs[s][1:])), ref_losses,
            {n: ref[f"step{s}_{n}"] for n in GSPMD_GRADS})
    # one step more, profiled on rank 0 (the other rank steps beside it)
    step = lambda: exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
    if rank == 0 and spec["device"] != "cpu":
        _, prof = profile(f"gspmd step {plan!r}", step)
        prof = {k: prof[k] for k in ("wall_ms", "device_ms",
                                     "device_idle_share")}
    else:
        step()
        prof = None
    res = {"plan": plan.to_dict(), "rows": rows, "losses": losses,
           "digests": [[_digest(np.asarray(x)) for x in o] for o in outs],
           "bars": {str(s): {"held": b[0], **b[1]} for s, b in bars.items()},
           "flash_shapes": sorted([k, list(s), d] for k, s, d in shapes),
           **timing, "profiled_step": prof, "max_memory_allocated_gb": peak,
           "blocks": {n: list(t.shape) for n, t in blocks.items()
                      if n in ("tfm_l0_self_q.w", "tfm_l0_ffn_fc2.w",
                               "tfm_emb.w", "tfm_out_fc.w", GSPMD_FAULT)},
           "sharded_names": len(blocks),
           "params_and_moments_bytes": {
               "held": held_bytes, "one_rank": whole_bytes,
               "share": held_bytes / whole_bytes,
               "sharded_share": sharded_held / max(sharded_whole, 1)}}
    if fault:
        # the start restored in the buffers (no new capture), the
        # warm-up's step replayed, then rank 1's column block of v.w
        # zeroed before the first counted step
        for n in names:
            if n in blocks:
                blocks[n].copy_(prog._shards[n].take(start[n]))
            else:
                scope.find_var(n).get().copy_(start[n])
        step()
        if rank == 1:
            prog.sharded_state()[GSPMD_FAULT].zero_()
        got = step()
        held, nums = gspmd_bar(
            [float(np.asarray(got[0]).reshape(-1)[0])],
            dict(zip(GSPMD_GRADS, got[1:])), ref_losses[1:2],
            {n: ref[f"step1_{n}"] for n in GSPMD_GRADS})
        res["planted_fault"] = {"held": held, **nums}
    del prog, scope, exe, start, blocks
    if spec["device"] != "cpu":
        gc.collect()
        torch.cuda.empty_cache()
    return res


def gspmd_chain(d, seed):
    """serving_tp_sharded's fc chain saved as an inference model to
    ``d``, its weights from ``seed``; returns the probe batch."""
    import paddle_tpu_torch as pt

    c = TP_CHAIN
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.layers.data("x", shape=[c["in_dim"]], dtype="float32")
        h = x
        for _ in range(c["depth"]):
            h = pt.layers.fc(h, size=c["hidden"], act="relu")
        pred = pt.layers.fc(h, size=c["out_dim"])
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    np.random.seed(seed)
    exe.run(startup, scope=scope)
    with pt.scope_guard(scope):
        pt.io.save_inference_model(d, ["x"], [pred], exe,
                                   main_program=main)
    return np.random.RandomState(seed + 3).rand(
        c["batch"], c["in_dim"]).astype(np.float32)


def gspmd_predictor_leg(spec):
    """(d): the chain through a lone Predictor on this rank's device, then
    through a Predictor sharded by shard(MeshPlan(dp=1, tp=2)): the
    outputs against the lone one's, sharding_info, each one's ms a batch
    by events, a profiled sharded batch."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import env as penv
    from paddle_tpu_torch.parallel.gspmd import MeshPlan

    cuda = spec["device"] != "cpu"
    probe = np.load(os.path.join(spec["dir"], "probe.npy"))

    def predictor():
        cfg = pt.inference.Config(os.path.join(spec["dir"], "chain"))
        if not cuda:
            cfg.disable_gpu()
        return pt.inference.create_predictor(cfg)

    def timed(p):
        out = p.run([probe])[0]          # the capture
        ms = []
        for _ in range(TP_RUNS):
            if cuda:
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
            t0 = time.perf_counter()
            p.run([probe])
            if cuda:
                e1.record()
                e1.synchronize()
                ms.append(e0.elapsed_time(e1))
            else:
                ms.append((time.perf_counter() - t0) * 1e3)
        return out, ms

    lone, lone_ms = timed(predictor())
    p = predictor()
    pt.set_flags({"serving_sharded": True})
    try:
        info = p.shard(MeshPlan(dp=1, tp=GSPMD_RANKS))
        again = p.shard(MeshPlan(dp=1, tp=GSPMD_RANKS))
    finally:
        pt.set_flags({"serving_sharded": False})
    out, ms = timed(p)
    step = lambda: p.run([probe])
    if penv.rank() == 0 and cuda:
        _, prof = profile("tp-sharded Predictor batch", step)
        prof = {k: prof[k] for k in ("wall_ms", "device_ms",
                                     "device_idle_share")}
    else:
        step()
        prof = None
    diff = np.abs(out.astype(np.float64) - lone)
    return {"equal": bool(np.array_equal(out, lone)),
            "max_abs_diff": float(diff.max()),
            "max_rel_diff": float((diff / np.maximum(
                np.abs(lone), 1.0)).max()),
            "annotated": info["annotated"],
            "idempotent": again["annotated"] == info["annotated"],
            "sharding_info": {n: [list(s) for s in v]
                              for n, v in p.sharding_info().items()},
            "digest": _digest(out), "lone_ms": lone_ms,
            "sharded_ms": ms, "profiled_batch": prof}


def gspmd_rank(spec_path):
    """One rank of phase 3h (``--gspmd-rank``), started by the port's
    launcher with the PADDLE_* contract: legs (a), (b) and (d); writes
    ``rank<r>.json`` into the spec's directory."""
    global MODEL, AMP_BATCH

    with open(spec_path) as f:
        spec = json.load(f)
    MODEL = dict(MODEL, **spec["model"])
    AMP_BATCH = spec["batch"]
    TP_CHAIN.update(spec["chain"])
    from paddle_tpu_torch.parallel import env as penv

    t0 = time.perf_counter()
    e = os.environ
    penv.init_parallel_env(
        int(e["PADDLE_TRAINER_ID"]), int(e["PADDLE_TRAINERS_NUM"]),
        e["PADDLE_COORDINATOR_ENDPOINT"], place=gspmd_place(spec),
        endpoints=e["PADDLE_TRAINER_ENDPOINTS"].split(","),
        current=e["PADDLE_CURRENT_ENDPOINT"])
    rank = penv.rank()
    laps = {"init": time.perf_counter() - t0}
    res = {"rank": rank, "world": penv.world_size(),
           "backend": penv.backend(), "device": str(penv.device())}
    for key, fn in (
            ("tp", lambda: gspmd_train_leg(spec, dict(dp=1, tp=GSPMD_RANKS),
                                           True)),
            ("zero3", lambda: gspmd_train_leg(
                spec, dict(dp=GSPMD_RANKS, tp=1), False)),
            ("predictor", lambda: gspmd_predictor_leg(spec))):
        t = time.perf_counter()
        penv.reset()
        res[key] = fn()
        laps[key] = time.perf_counter() - t
    res["routes"] = penv.routes()
    res["laps_s"] = laps
    penv.barrier()
    penv.shutdown()
    with open(os.path.join(spec["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def gspmd_local_runs(spec):
    """In this process, from the ranks' start: the one-rank run of the
    program without shard_program (the reference of (a) and (b), its
    losses and the held steps' gradients written for the ranks), and (c)
    tf_train_gspmd as bench.py builds it on one card (tp clamped to the
    device count, a one-device mesh), its fetches and parameters against
    the reference's bitwise."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel.gspmd import MeshPlan
    from paddle_tpu_torch.transpiler import shard_program

    cuda = spec["device"] != "cpu"
    place = pt.CUDAPlace(0) if cuda else pt.CPUPlace()
    runs = {}
    for what in ("reference", "bench"):
        model, main, startup = gspmd_program()
        exe, scope = pt.Executor(place), pt.Scope()
        np.random.seed(spec["seed"])
        exe.run(startup, scope=scope)
        prog = pt.CompiledProgram(main)
        plan = None
        if what == "bench":
            # bench.py:370-380: tp clamped to the device count
            ndev = torch.cuda.device_count() if cuda else 1
            tp = max(1, min(2, ndev))
            while ndev % tp:
                tp -= 1
            plan = MeshPlan(dp=ndev // tp, tp=tp)
            pt.set_flags({"gspmd": True})
            try:
                prog = shard_program(prog, plan,
                                     loss_name=model["loss"].name)
            finally:
                pt.set_flags({"gspmd": False})
        fetch = [model["loss"].name, *GSPMD_GRADS]
        outs, timing = gspmd_steps(spec, exe, prog, scope,
                                   train_batch(spec["seed"], AMP_BATCH),
                                   fetch)
        runs[what] = {
            "outs": outs, "timing": timing, "graphs": prog.graph_stats(),
            "plan": plan and plan.to_dict(),
            "mesh": None if prog._mesh is None else dict(prog._mesh.shape),
            "sharded": len(prog.sharded_state()),
            "final": {p.name: scope.find_var(p.name).get().detach().to(
                "cpu").clone() for p in main.all_parameters()}}
        del exe, scope, prog
        if cuda:
            gc.collect()
            torch.cuda.empty_cache()
    ref, bench = runs["reference"], runs["bench"]
    np.savez(os.path.join(spec["dir"], "reference.npz"), losses=np.array(
        [float(np.asarray(o[0]).reshape(-1)[0]) for o in ref["outs"]]),
        **{f"step{s}_{n}": np.asarray(ref["outs"][s][1 + i])
           for s in GSPMD_HELD_STEPS for i, n in enumerate(GSPMD_GRADS)})
    equal = all(np.array_equal(np.asarray(a), np.asarray(b))
                for oa, ob in zip(ref["outs"], bench["outs"])
                for a, b in zip(oa, ob)) and all(
        torch.equal(ref["final"][n], bench["final"][n]) for n in ref["final"])
    return {"reference": {"losses": [float(np.asarray(o[0]).reshape(-1)[0])
                                     for o in ref["outs"]],
                          **ref["timing"], "graphs": ref["graphs"]},
            "bench": {"equal_to_reference": equal, "plan": bench["plan"],
                      "mesh": bench["mesh"], "sharded": bench["sharded"],
                      **bench["timing"], "graphs": bench["graphs"]}}


def gspmd_spawn(tmp, spec):
    port = _free_port()
    path = os.path.join(tmp, "spec_gspmd.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.launch", "--nproc_per_node",
         str(GSPMD_RANKS), "--started_port", str(port),
         os.path.abspath(__file__), "--gspmd-rank", path], env=env, cwd=root)


def gspmd_expected(spec):
    """The flash launches of GSPMD_STEPS steps of the LM a rank: 12
    forward (6 recomputed in the grads), 6 dq, 6 dkv a step (on the CPU
    the plain versions run: 0 each)."""
    n = MODEL["n_layer"] * GSPMD_STEPS if spec["device"] != "cpu" else 0
    return {k: v for k, v in (("flash_attention_fwd", 2 * n),
                              ("flash_attention_bwd_dq", n),
                              ("flash_attention_bwd_dkv", n))}


def gspmd_phase(seed, device="cuda"):
    """Phase 3h (see the module docstring): the 2-rank legs through the
    launcher, started first; beside their start, this process's runs (the
    reference and (c)); then every bar."""
    t_phase = time.perf_counter()
    laps = {}
    heads = MODEL["n_head"]
    with tempfile.TemporaryDirectory() as tmp:
        go = os.path.join(tmp, "go")
        os.makedirs(os.path.join(tmp, "chain"))
        probe = gspmd_chain(os.path.join(tmp, "chain"), seed)
        np.save(os.path.join(tmp, "probe.npy"), probe)
        spec = {"seed": seed, "device": device, "dir": tmp, "go": go,
                "model": {k: MODEL[k] for k in MODEL if k != "is_test"},
                "batch": AMP_BATCH, "chain": TP_CHAIN}
        proc = gspmd_spawn(tmp, spec)
        try:
            t = time.perf_counter()
            local = gspmd_local_runs(spec)
            laps["local_runs"] = time.perf_counter() - t
        except BaseException:
            proc.kill()
            proc.wait()
            raise
        open(go, "w").close()
        t = time.perf_counter()
        try:
            code = proc.wait(timeout=GSPMD_WAIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise AssertionError(f"phase 3h: the ranks outlasted "
                                 f"{GSPMD_WAIT_S} s")
        if code != 0:
            raise AssertionError(f"phase 3h: the ranks failed (exit {code})")
        laps["ranks_after_local_runs"] = time.perf_counter() - t
        ranks = []
        for r in range(GSPMD_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    r0 = ranks[0]
    failures = []
    want = gspmd_expected(spec)
    d_head = MODEL["d_model"] // heads
    for leg, shape in (("tp", [AMP_BATCH, heads // GSPMD_RANKS,
                               MODEL["max_len"], d_head]),
                       ("zero3", [AMP_BATCH // GSPMD_RANKS, heads,
                                  MODEL["max_len"], d_head])):
        if any(r[leg]["digests"] != r0[leg]["digests"] for r in ranks):
            failures.append(f"{leg}: the ranks' fetches differ")
        for r in ranks:
            got = {k: r[leg]["launches"].get(k, 0) for k in want}
            if got != want:
                failures.append(f"{leg} rank {r['rank']}: launches {got}, "
                                f"expected {want}")
            fs = {tuple(s) for _, s, _ in r[leg]["flash_shapes"]}
            if fs != {tuple(shape)}:
                failures.append(f"{leg} rank {r['rank']}: flash operands "
                                f"{r[leg]['flash_shapes']}, expected "
                                f"{shape}")
        for s, b in r0[leg]["bars"].items():
            if not b["held"]:
                failures.append(f"{leg}: step {s} beyond the AMP bars of "
                                f"the one-rank run: {b}")
    tp, z3 = r0["tp"], r0["zero3"]
    if tp["blocks"].get("tfm_l0_self_q.w") != [
            MODEL["d_model"], MODEL["d_model"] // GSPMD_RANKS]:
        failures.append(f"tp: q.w's block {tp['blocks']}")
    if any(r["tp"]["planted_fault"]["held"] for r in ranks):
        failures.append("tp: the planted fault (rank 1's block of "
                        f"{GSPMD_FAULT} zeroed) held the bar")
    share = z3["params_and_moments_bytes"]
    if share["sharded_share"] != 1 / GSPMD_RANKS or not \
            1 / GSPMD_RANKS <= share["share"] <= 1 / GSPMD_RANKS + 0.01:
        failures.append(f"zero3: a rank holds {share} of the one-rank run's "
                        "parameter and moment bytes")
    if not local["bench"]["equal_to_reference"]:
        failures.append("tf_train_gspmd: the replays differ from the "
                        "program run without shard_program")
    pr = [r["predictor"] for r in ranks]
    if any(p["digest"] != pr[0]["digest"] for p in pr):
        failures.append("predictor: the ranks' outputs differ")
    for p in pr:
        if not p["equal"] and (p["max_abs_diff"] > LOGITS_ATOL
                               or p["max_rel_diff"] > LOGITS_RTOL):
            failures.append(f"predictor: {p['max_abs_diff']} from the lone "
                            "Predictor, beyond the logits bound")
        c, half = TP_CHAIN, GSPMD_RANKS
        widths = [c["in_dim"]] + [c["hidden"]] * c["depth"] + [c["out_dim"]]
        want_blocks = {}
        for i in range(c["depth"] + 1):
            want_blocks[f"fc_{i}.w_0"] = [widths[i], widths[i + 1] // half]
            want_blocks[f"fc_{i}.b_0"] = [widths[i + 1] // half]
        if {k: v[1] for k, v in p["sharding_info"].items()} != \
                want_blocks or not p["idempotent"]:
            failures.append(f"predictor: sharding_info "
                            f"{p['sharding_info']}")
    res = {
        "backend": sorted({r["backend"] for r in ranks}),
        "tp": {k: tp[k] for k in (
            "losses", "wall_ms", "event_ms", "launches", "flash_shapes",
            "blocks", "bars", "planted_fault", "profiled_step",
            "max_memory_allocated_gb")},
        "zero3": {k: z3[k] for k in (
            "losses", "wall_ms", "event_ms", "launches", "flash_shapes",
            "blocks", "bars", "params_and_moments_bytes", "profiled_step",
            "max_memory_allocated_gb")},
        "tf_train_gspmd": local["bench"], "reference": local["reference"],
        "predictor": {k: pr[0][k] for k in (
            "equal", "max_abs_diff", "max_rel_diff", "sharding_info",
            "lone_ms", "sharded_ms", "profiled_batch", "idempotent")},
        "routes": [r["routes"] for r in ranks],
        "rank_laps_s": [r["laps_s"] for r in ranks],
        "laps_s": laps, "seconds": time.perf_counter() - t_phase}
    log("gspmd " + json.dumps(res))
    if failures:
        raise AssertionError("phase 3h: " + "; ".join(failures))
    return res


def gspmd_apart(seed, card):
    """Phase 3h in a process of its own (``--gspmd``); returns its
    numbers, logged beside the card's line."""
    import torch

    torch.cuda.empty_cache()
    log("phase 3h starts beside this process's "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved on the card")
    with tempfile.TemporaryDirectory() as tmp:
        res_path = os.path.join(tmp, "gspmd.json")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--gspmd", res_path], timeout=GSPMD_WAIT_S * 2)
        if proc.returncode != 0:
            raise AssertionError(f"phase 3h failed in its process "
                                 f"(exit {proc.returncode})")
        with open(res_path) as f:
            res = json.load(f)

    def med(xs):
        return sorted(xs)[len(xs) // 2] if xs else None

    log(f"gspmd ({card}) " + json.dumps({
        "tp_step_event_ms": med(res["tp"]["event_ms"]),
        "zero3_step_event_ms": med(res["zero3"]["event_ms"]),
        "tf_train_gspmd_step_event_ms": med(
            res["tf_train_gspmd"]["event_ms"]),
        "reference_step_event_ms": med(res["reference"]["event_ms"]),
        "predictor_ms": [med(res["predictor"]["lone_ms"]),
                         med(res["predictor"]["sharded_ms"])],
        "idle": [res["tp"]["profiled_step"], res["zero3"]["profiled_step"],
                 res["predictor"]["profiled_batch"]],
        "seconds": res["seconds"]}))
    return res


PORT_KERNEL = re.compile(
    r"(?:::|\d)((?:flash_(?:fwd|bwd_dq|bwd_dkv)_(?:bf16|f32|wide)"
    r"|flash_decode(?:_merge|_wide)?|fc_(?:ep_bf16|ep_f32|wgmma)"
    r"|conv_(?:f32|int8|int8_wgmma|wgmma)|bn_apply_(?:masked|tiled)"
    r"|quantize_act)_kernel)")


def profile(what, fn):
    """Device time of one call of ``fn`` (a request, a training step, a
    served decode run) by kernel or copy (torch.profiler), counting only
    the events that ran on the card.  Returns what ``fn`` returns and the
    call's numbers: wall and device ms, the device's busy and idle share,
    the device-to-host copies' ms, and the port's own kernels' calls by
    function (``port_calls``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        # the tracer takes a moment to record the card's first kernels: a
        # replay issued at once lost its first seven (PR 14)
        torch.cuda.synchronize()
        time.sleep(0.2)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    # the port's own kernels by function, demangled or not
    port = {}
    for ms, n, name in rows:
        m = PORT_KERNEL.search(name)
        if m:
            port[m.group(1)] = port.get(m.group(1), 0) + n
    stats = {"wall_ms": wall_ms, "device_ms": device_ms,
             "device_busy_share": device_ms / wall_ms if wall_ms else None,
             "device_idle_share": 1.0 - device_ms / wall_ms
             if wall_ms else None,
             "memcpy_dtoh_ms": sum(ms for ms, _, name in rows
                                   if name.startswith("Memcpy DtoH")),
             "memcpy_htod_ms": sum(ms for ms, _, name in rows
                                   if name.startswith("Memcpy HtoD")),
             "port_calls": port}
    log(f"profile of one {what} " + json.dumps({
        **stats,
        "top": [{"ms": ms, "calls": n, "name": name[:80]}
                for ms, n, name in rows[:12]],
        "port_rows": [{"ms": ms, "calls": n, "name": name[:120]}
                      for ms, n, name in rows if PORT_KERNEL.search(name)]}))
    return out, stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=5,
                    help="requests served in the counted window")
    ap.add_argument("--training-legs", metavar="RESULT_JSON",
                    help="run phases 19-21 alone (the kernels already "
                    "built) and write their numbers to RESULT_JSON; the "
                    "whole script runs them so, in a process of their own")
    ap.add_argument("--observability", metavar="RESULT_JSON",
                    help="run phase 3d alone (the kernels already built) "
                    "and write its numbers to RESULT_JSON; the whole "
                    "script runs it so, in a process of its own")
    ap.add_argument("--ps", metavar="RESULT_JSON",
                    help="run phase 3e alone (the kernels already built) "
                    "and write its numbers to RESULT_JSON; the whole "
                    "script runs it so, in a process of its own")
    ap.add_argument("--ctr", metavar="RESULT_JSON",
                    help="run phase 3f alone (the kernels already built) "
                    "and write its numbers to RESULT_JSON; the whole "
                    "script runs it so, in a process of its own beside "
                    "the card tests")
    ap.add_argument("--beside", metavar="FILE",
                    help="with --ctr: a file made once the card tests "
                    "running beside the phase ended")
    ap.add_argument("--collective", metavar="RESULT_JSON",
                    help="run phase 3g alone (the flash kernels already "
                    "built) and write its numbers to RESULT_JSON; the whole "
                    "script runs it so, in a process of its own")
    ap.add_argument("--collective-rank", metavar="SPEC_PATH",
                    help="run one rank of phase 3g's legs, as the spec file "
                    "says (the phase starts these through the launcher)")
    ap.add_argument("--gspmd", metavar="RESULT_JSON",
                    help="run phase 3h alone (the flash kernels already "
                    "built) and write its numbers to RESULT_JSON; the whole "
                    "script runs it so, in a process of its own")
    ap.add_argument("--gspmd-rank", metavar="SPEC_PATH",
                    help="run one rank of phase 3h's legs, as the spec file "
                    "says (the phase starts these through the launcher)")
    ap.add_argument("--ps-node", metavar="SPEC_JSON",
                    help="run one pserver or trainer of phase 3e's or 3f's "
                    "clusters, as SPEC_JSON says (the phases start these)")
    ap.add_argument("--cpu-references", metavar="DIR",
                    help="compute the batch-2 checks' CPU runs into DIR "
                    "(no card used); the whole script runs this in a "
                    "process of its own beside the card phases")
    ap.add_argument("--cpu-runs", metavar="DIR",
                    help="take the checks' CPU runs from DIR, where a "
                    "--cpu-references process writes them")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.cpu_references:
        os.nice(19)
        prefetch_cpu_runs(args.seed, args.cpu_references)
        return 0

    import torch

    mm = torch.backends.cuda.matmul
    mm.allow_tf32 = mm.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    if args.ps_node:
        # a node of phase 3e's clusters, on the device its spec names
        ps_node(args.ps_node)
        return 0
    if args.collective_rank:
        collective_rank(args.collective_rank)
        return 0
    if args.gspmd_rank:
        gspmd_rank(args.gspmd_rank)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    device = torch.device("cuda", 0)
    PREFETCH["dir"] = args.cpu_runs
    if args.training_legs:
        with open(args.training_legs, "w") as f:
            json.dump(training_legs(args.seed, device), f)
        return 0
    if args.observability:
        with open(args.observability, "w") as f:
            json.dump(observability_phase(args.seed), f)
        return 0
    if args.ps:
        with open(args.ps, "w") as f:
            json.dump(ps_phase(args.seed), f)
        return 0
    if args.collective:
        with open(args.collective, "w") as f:
            json.dump(collective_phase(args.seed), f)
        return 0
    if args.gspmd:
        with open(args.gspmd, "w") as f:
            json.dump(gspmd_phase(args.seed), f)
        return 0
    if args.ctr:
        with open(args.ctr, "w") as f:
            json.dump(ctr_phase(args.seed, card_tests_done=args.beside), f)
        return 0
    import paddle_tpu_torch  # noqa: F401  (before any process starts)

    card = card_line()
    log(f"card: {card}")
    with tempfile.TemporaryDirectory() as runs_dir:
        start_prefetch(args.seed, runs_dir)
        try:
            return run_phases(args, card, device)
        except BaseException:
            stop_prefetch(kill=True)
            raise


# free disk a prefetch needs: the CPU runs of the checks, ~11 GB of
# arrays (grads, parameters before and after), with room to spare
PREFETCH_DISK_BYTES = 40e9


def start_prefetch(seed, runs_dir):
    """Starts the CPU reference runs' process (``--cpu-references``) at
    the lowest priority, with no card visible, where the disk has room;
    the checks then take their CPU runs from ``runs_dir``."""
    import shutil

    free = shutil.disk_usage(runs_dir).free
    if free < PREFETCH_DISK_BYTES:
        log(f"CPU reference runs computed in turn: {free / 1e9:.1f} GB "
            f"free where {PREFETCH_DISK_BYTES / 1e9:.0f} are asked")
        return
    PREFETCH["dir"] = runs_dir
    PREFETCH["proc"] = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--cpu-references", runs_dir],
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    log(f"CPU reference runs started in a process of their own "
        f"({free / 1e9:.1f} GB free)")


def stop_prefetch(kill=False):
    """Waits for the CPU reference runs' process (``kill``: ends it, where
    a phase failed first) and fails unless it ended well."""
    proc = PREFETCH["proc"]
    if proc is None:
        return
    PREFETCH["proc"] = None
    if kill:
        proc.kill()
        proc.wait()
        return
    if proc.wait(timeout=PREFETCH_WAIT_S) != 0:
        raise AssertionError(f"the CPU reference runs' process failed "
                             f"(exit {proc.returncode})")


def run_phases(args, card, device):
    """Every phase after the card line; returns the exit code."""
    import torch

    seconds, last = {}, [time.perf_counter()]

    def phase(name):
        """Logs the seconds since the last phase ended, under ``name``."""
        now = time.perf_counter()
        seconds[name] = now - last[0]
        last[0] = now
        log(f"phase done: {name} in {seconds[name]:.1f} s")

    t0 = time.perf_counter()
    late = concurrent.futures.ThreadPoolExecutor(max_workers=1).submit(
        timed_build, LATE_KERNELS)
    logs, built_s = timed_build(EARLY_KERNELS)
    for name, text in logs.items():
        log(f"nvcc {name}.cu:\n{text.strip()}")
    log(f"kernels built in {built_s:.1f} s ({', '.join(LATE_KERNELS)} "
        "still building)")
    phase("the kernels' build")
    # while this process holds next to nothing on the card: its two ranks
    # and their CUDA graphs take ~31 GB each at the full width
    gspmd = gspmd_apart(args.seed, card)
    phase("GSPMD training and the tp-sharded Predictor (its own process, "
          "its ranks through the launcher)")

    cases = check_flash(device, args.seed)
    f64_fwd = check_f32_vs_f64(device, args.seed, grads=False)
    phase("the flash forward")
    with tempfile.TemporaryDirectory() as workdir:
        serve_launches, _, reference = serve(args.seed, args.runs, workdir)
        phase("serving")
        tier_launches, tier = serving_tier(args.seed, workdir, reference,
                                           card)
        phase("the serving tier")
        fleet_launches, _ = fleet(args.seed, workdir, reference, card, tier)
        del reference, tier
    phase("the fleet")
    bwd_cases = check_flash_bwd(device, args.seed)
    f64_bwd = check_f32_vs_f64(device, args.seed, grads=True)
    phase("the flash backward")
    built = build_train_program()
    train_launches, _ = train(
        args.seed, built, train_batch(args.seed, BATCH),
        "training", lm_expected, unit=("tokens", BATCH * MODEL["max_len"]))
    train_gpu_vs_cpu(args.seed, built, "training", dict(
        loss_rtol=LOSS_RTOL, bulk_rtol=GRAD_BULK_RTOL,
        bulk_share=GRAD_BULK_SHARE,
        max_rtol=GRAD_FLIP_TOKENS / (CHECK_BATCH * MODEL["max_len"]),
        param_atol=PARAM_ATOL), train_batch(args.seed, CHECK_BATCH))
    phase("the LM's f32 training")
    fc_rows = check_fc_epilogue(device, args.seed)
    phase("fc_epilogue")
    built = build_amp_program()
    with kernel_flag("fc_epilogue", "on"):
        amp_launches, _ = train(
            args.seed, built, train_batch(args.seed, AMP_BATCH),
            "AMP training", lm_expected,
            unit=("tokens", AMP_BATCH * MODEL["max_len"]))
    train_gpu_vs_cpu(args.seed, built, "AMP training", dict(
        loss_rtol=AMP_LOSS_RTOL, bulk_rtol=AMP_GRAD_BULK_RTOL,
        bulk_share=AMP_GRAD_BULK_SHARE, max_rtol=AMP_GRAD_MAX_RTOL,
        norm_rtol=AMP_GRAD_NORM_RTOL, param_atol=PARAM_ATOL),
        train_batch(args.seed, CHECK_BATCH),
        modes=("on", "interpret"), cpu_reference_mode="off")
    del built
    phase("the LM's AMP training")
    tf_launches, _ = tf_legs(args.seed)
    phase("tf_train, tf_train_fcep")

    # ResNet-50: the conv kernels at the path's shapes (the stem's 4x4
    # conv on 12 channels among them), the compare backward at the stem
    # pool's shape, then the bench's three legs
    rn_bn = build_resnet_program("conv_bn_stats")
    convs, bns = resnet_conv_shapes(rn_bn[1])
    conv_rows = check_conv_kernels(device, args.seed, convs)
    bn_rows = check_bn_apply(device, args.seed, bns)
    phase("the conv kernels and bn_apply")
    check_maxpool_compare(device, args.seed)
    rn_launches, _ = resnet_legs(args.seed, rn_bn)
    del rn_bn
    phase("the ResNet-50 legs")

    # every kernel built, the card tests, then LLM decode: flash_decode at
    # the path's shapes, then the server and the chunked join
    logs, built_s = late.result()
    for name, text in logs.items():
        log(f"nvcc {name}.cu:\n{text.strip()}")
    log(f"{', '.join(LATE_KERNELS)} built in {built_s:.1f} s, waited "
        f"{time.perf_counter() - last[0]:.1f} s for it")
    phase("the rest of the kernels' build")
    obs = observability_apart(args.seed, card)
    phase("the serving tier's observability (its own process)")
    ps = ps_apart(args.seed, card)
    phase("parameter-server training and the collector (its own process)")
    coll = collective_apart(args.seed, card)
    phase("collective data-parallel training (its own process, its ranks "
          "through the launcher)")
    with tempfile.TemporaryDirectory() as ctr_tmp:
        started = ctr_start(args.seed, ctr_tmp)
        try:
            card_tests()
        except BaseException:
            started[0].kill()
            started[0].wait()
            raise
        open(started[2], "w").close()
        phase("the card tests (phase 3f beside them)")
        ctr = ctr_wait(started, card)
    phase("Downpour CTR, the Communicator, elastic resume (its own process, "
          "after the card tests)")
    decode_rows = {r["name"]: r for r in check_flash_decode(device,
                                                            args.seed)}
    decode_launches, *_ = decode_phase("cuda", args.seed)
    decode_launches["decode_chunked_join"], join_row = decode_join_phase(
        "cuda", args.seed)
    phase("LLM decode and the chunked join")
    disagg_launches, disagg_rows = disagg_phase("cuda", args.seed)
    decode_launches.update(disagg_launches)
    phase("disaggregated decode")

    # conv-net inference: the six legs, the lever, the Predictor, then the
    # s8 kernel and #5 at their shapes
    with tempfile.TemporaryDirectory() as workdir:
        infer_launches, infer_rows, i8_rows, q_rows, ep_infer_rows = \
            infer_phases(device, args.seed, workdir)
    log("inference legs " + json.dumps(
        {leg: {k: row[k] for k in ("batch", "event_ms", "wall_ms",
                                   "images_per_s") if k in row}
         for leg, row in infer_rows.items()}))
    phase("inference")

    # the bench's other training legs: long context, BERT-base, DeepFM
    legs = training_legs_apart(args.seed)
    phase("long context, BERT-base, DeepFM (their own process)")
    long_launches = {w: legs["launches"][w] for w, _ in LONGCTX_LEGS}
    long_rows = {w: legs["rows"][w] for w, _ in LONGCTX_LEGS}
    bert_launches = legs["launches"]["bert_training"]
    dfm_launches = legs["launches"]["deepfm_training"]
    log("training legs " + json.dumps({
        what: {k: row[k] for k in ("step_ms", "step_event_ms",
                                   "tokens_per_s", "examples_per_s",
                                   "bench_mfu", "sdpa_fwd_bwd_event_ms",
                                   "function_fwd_bwd_event_ms")
               if k in row}
        for what, row in legs["rows"].items()}))

    def row_of(rows, case):
        return next(r for r in rows if r["shape"] == list(case[:5])
                    and r["dtype"] == case[6])

    main_row, amp_row = row_of(cases, MAIN_CASE), row_of(cases, AMP_CASE)
    f32_d128 = row_of(cases, F32_D128_CASE)
    bwd_row = row_of(bwd_cases, BWD_MAIN_CASE)
    bwd_amp = row_of(bwd_cases, BWD_AMP_CASE)
    bert_fwd = row_of(cases, BERT_CASE)
    bwd_bert = row_of(bwd_cases, BWD_BERT_CASE)

    def by_path(name):
        return {"serving": serve_launches[name],
                "serving_tier": tier_launches[name],
                "fleet": fleet_launches[name],
                "observability": obs["launches"][name],
                "ps_training": ps["launches"][name],
                "ps_communicator": ctr["launches_communicator"][name],
                "ps_elastic_resumed": ctr["launches_elastic"][name],
                "collective_training": coll["fleet"]["launches"].get(name, 0),
                "collective_conv_bn_train": coll["conv_bn"]["launches"].get(
                    name, 0),
                "gspmd_tp": gspmd["tp"]["launches"].get(name, 0),
                "gspmd_zero3": gspmd["zero3"]["launches"].get(name, 0),
                "tf_train_gspmd": gspmd["tf_train_gspmd"]["launches"].get(
                    name, 0),
                "training": train_launches[name],
                "amp_training": amp_launches[name],
                **{leg: counts[name] for leg, counts in tf_launches.items()},
                **{leg: counts[name] for leg, counts in rn_launches.items()},
                **{what: counts[name]
                   for what, counts in long_launches.items()},
                "bert_training": bert_launches[name],
                "deepfm_training": dfm_launches[name],
                **{path: counts[name]
                   for path, counts in decode_launches.items()},
                **{leg: counts[name]
                   for leg, counts in infer_launches.items()}}

    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:186",
        "launches": train_launches["flash_attention_fwd"],
        "launches_by_path": by_path("flash_attention_fwd"),
        "max_abs_err": main_row["max_abs_err_out"],
        "ms": main_row["ms"], "event_ms": main_row["event_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "bound_cuda_core_ms": main_row["bound_cuda_core_ms"],
        "library_ms": main_row["library_ms"],
        "design": "mma.sync bf16",
        "f32_design": "split TF32 on mma.sync.m16n8k8",
        "copies_by_path": by_path(COPIES),
        "f32_vs_f64": f64_fwd,
        "f32_d128": {k: f32_d128[k] for k in (
            "shape", "dtype", "max_abs_err_out", "max_abs_err_lse", "ms",
            "event_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "amp_path": {k: amp_row[k] for k in (
            "shape", "dtype", "max_abs_err_out", "ms", "event_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "copies")},
        "bert_path": {**{k: bert_fwd[k] for k in (
            "shape", "causal", "dtype", "max_abs_err_out", "ms", "event_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "copies")},
            "launches_per_step": bert_launches["flash_attention_fwd"]
            // TRAIN_STEPS},
        "long_context_path": {what: {
            "launches_per_step": counts["flash_attention_fwd"]
            // TRAIN_STEPS, **{k: long_rows[what][k] for k in (
                "shape", "step_ms", "step_event_ms",
                "function_fwd_bwd_event_ms", "sdpa_fwd_bwd_event_ms")}}
            for what, counts in long_launches.items()},
        "long_context": [{k: r[k] for k in (
            "shape", "dtype", "max_abs_err_out", "max_abs_err_lse",
            "checked_rows", "long_errs", "planted_fault_errs", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "copies")}
            for r in cases
            if r["shape"][2] > 4096],
    }]
    def bwd_summary(row, name, errs):
        return {"shape": row["shape"], "dtype": row["dtype"],
                "max_abs_err": max(row["max_abs_err"][e] for e in errs),
                **{k: row[k][name] for k in (
                    "ms", "event_ms", "bound_ms", "bound_by",
                    "bound_cuda_core_ms")},
                **{k: row.get(k) for k in (
                    "plain_ms", "library_ms", "library_event_ms",
                    "long_errs", "planted_fault_errs")}}

    for name, line, errs in (("dq", 409, ("dq",)),
                             ("dkv", 458, ("dk", "dv"))):
        kernels.append({
            "name": f"flash_attention_bwd_{name}", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"paddle_tpu/ops/pallas_kernels.py:{line}",
            "launches": train_launches[f"flash_attention_bwd_{name}"],
            "launches_by_path": by_path(f"flash_attention_bwd_{name}"),
            "max_abs_err": max(bwd_row["max_abs_err"][e] for e in errs),
            "ms": bwd_row["ms"][name], "event_ms": bwd_row["event_ms"][name],
            "plain_ms": bwd_row["plain_ms"],
            "bound_ms": bwd_row["bound_ms"][name],
            "bound_by": bwd_row["bound_by"][name],
            "bound_cuda_core_ms": bwd_row["bound_cuda_core_ms"][name],
            "library_ms": bwd_row["library_ms"],
            "design": "mma.sync bf16",
            "f32_design": "split TF32 on mma.sync.m16n8k8",
            "copies_by_path": by_path(BWD_COPIES),
            "amp_path": bwd_summary(bwd_amp, name, errs),
            "bert_path": dict(bwd_summary(bwd_bert, name, errs),
                              launches_per_step=bert_launches[
                                  f"flash_attention_bwd_{name}"]
                              // TRAIN_STEPS),
            "f32_vs_f64": [r for r in f64_bwd if r["output"] in errs],
            "long_context": [bwd_summary(r, name, errs) for r in bwd_cases
                             if r["shape"][2] > 4096],
        })
    # fc_epilogue: one layer's three calls on the AMP path, summed; the
    # library route is the flag-off chain (no one PyTorch call adds a
    # bias and a residual and applies relu)
    t_bytes, t_ops = (sum(t) for t in zip(*(
        fc_times(*r["shape"], r["epilogue"], r["dtype"]) for r in fc_rows)))
    kernels.append({
        "name": "fc_epilogue", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/fc_epilogue.cu",
        "replaces": "paddle_tpu/ops/epilogue.py:370",
        "launches": amp_launches["fc_epilogue"],
        "launches_by_path": by_path("fc_epilogue"),
        "wgmma_launches_by_path": by_path(FC_WGMMA),
        "max_abs_err": max(r["max_abs_err"] for r in fc_rows),
        "ms": sum(r["ms"] for r in fc_rows),
        "event_ms": sum(r["event_ms"] for r in fc_rows),
        "plain_ms": sum(r["plain_ms"] for r in fc_rows),
        "bound_ms": sum(r["bound_ms"] for r in fc_rows),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": sum(r["chain_ms"] for r in fc_rows),
        "library_event_ms": sum(r["chain_event_ms"] for r in fc_rows),
        "design": "wgmma, TMA ring, persistent (bf16 rows TMA can address); "
                  "mma.sync otherwise",
        "per": "one layer's three calls of the AMP step, bf16; ms by "
               "CUDA-graph replay, event_ms by events",
        "shapes": {r["name"]: {k: r[k] for k in (
            "shape", "epilogue", "path", "ms", "event_ms", "plain_ms",
            "chain_ms", "chain_event_ms", "addmm_ms", "addmm_event_ms",
            "bound_ms", "bound_by", "tflops")} for r in fc_rows},
    })
    # the conv kernels and bn_apply: each shape's numbers weighted by its
    # launches in one training step (forward, and again in its grad)
    def per_step(rows, key, name=None):
        return sum(r["per_step"] * (r[key] if name is None else r[key][name])
                   for r in rows)

    stem = next(r for r in conv_rows if r["shape"][3] == 12)
    log("the stem's 4x4 conv on 12 channels (#5, #6 and cuDNN) "
        + json.dumps(stem))
    for name, line, path in (("conv_epilogue", 99, "rn_train_convep"),
                             ("conv_stats", 311, "rn_train_convbnstats")):
        t_bytes, t_ops = (
            sum(r["per_step"] * conv_times(*r["shape"],
                                           name == "conv_stats")[i]
                for r in conv_rows) for i in (0, 1))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/conv_epilogue.cu",
            "replaces": f"paddle_tpu/ops/pallas_conv.py:{line}",
            "launches": by_path(name)[path],
            "launches_by_path": by_path(name),
            "max_abs_err": max(r["max_abs_err"][name] for r in conv_rows),
            "ms": per_step(conv_rows, "ms", name),
            "event_ms": per_step(conv_rows, "event_ms", name),
            "plain_ms": per_step(conv_rows, "plain_ms", name),
            "bound_ms": per_step(conv_rows, "bound_ms", name),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": per_step(conv_rows, "library_ms", name),
            "library_event_ms": per_step(conv_rows, "library_event_ms",
                                         name),
            "per": "one ResNet-50 training step at batch 128, bf16; ms by "
                   "CUDA-graph replay, event_ms by events",
            "stem_shape": {k: stem[k] if not isinstance(stem[k], dict)
                           else stem[k][name] for k in (
                               "shape", "per_step", "ms", "event_ms",
                               "plain_ms", "library_ms", "bound_ms",
                               "bound_by", "tflops")},
            "shapes": [{k: r[k] if not isinstance(r[k], dict) else r[k][name]
                        for k in ("shape", "per_step", "ms", "event_ms",
                                  "plain_ms", "library_ms", "bound_ms",
                                  "bound_by", "tflops")} for r in conv_rows],
        })
    t_bytes, t_ops = (
        sum(r["per_step"] * bn_times(int(np.prod(r["shape"][:3])),
                                     r["shape"][3], r["residual"])[i]
            for r in bn_rows) for i in (0, 1))
    kernels.append({
        "name": "bn_apply", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/bn_apply.cu",
        "replaces": "paddle_tpu/ops/pallas_conv.py:484",
        "launches": rn_launches["rn_train_convbnstats"]["bn_apply"],
        "launches_by_path": by_path("bn_apply"),
        "max_abs_err": max(r["max_abs_err"] for r in bn_rows),
        "ms": per_step(bn_rows, "ms"),
        "event_ms": per_step(bn_rows, "event_ms"),
        "plain_ms": per_step(bn_rows, "plain_ms"),
        "bound_ms": per_step(bn_rows, "bound_ms"),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_share": per_step(bn_rows, "bound_ms")
        / per_step(bn_rows, "ms"),
        "library_ms": per_step(bn_rows, "library_ms"),
        "library_event_ms": per_step(bn_rows, "library_event_ms"),
        "design": "2-D tiles: a thread's channel octet fixed, its 32 "
                  "coefficients in registers, four rows' loads in flight, "
                  "a resident grid",
        "per": "one ResNet-50 training step at batch 128, bf16; ms by "
               "CUDA-graph replay, event_ms by events",
        "shapes": [{k: r[k] for k in ("shape", "residual", "relu",
                                      "per_step", "ms", "event_ms",
                                      "plain_ms", "library_ms", "bound_ms",
                                      "bound_by", "bound_share")}
                   for r in bn_rows],
    })
    # flash_decode: the main shape (one plain step of the 64-stream
    # server), with the verify sweep, the draft model's step, int8 pools
    # and the two long shapes beside it; bound_ms counts the live keys,
    # bound_pages_ms every live page whole (bench.py's count)
    main_row = decode_rows["main"]
    kernels.append({
        "name": "flash_decode", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_decode.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:868",
        "launches": decode_launches["decode"]["flash_decode"],
        "launches_by_path": by_path("flash_decode"),
        "max_abs_err": main_row["max_abs_err"],
        "max_err_rel_to_scale_all_cases": max(
            r["err_rel_to_scale"] for r in decode_rows.values()),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "bound_pages_ms": main_row["bound_pages_ms"],
        "library_ms": main_row["library_ms"],
        "library_calls": {"gather_ms": main_row["gather_ms"],
                          "sdpa_ms": main_row["sdpa_ms"]},
        "other_shapes": {n: {k: decode_rows[n][k] for k in (
            "streams", "tokens", "R", "H", "d", "dtype", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "bound_pages_ms")}
            for n in ("main_verify", "main_int8", "draft", "long_64x4096",
                      "long_1x32768", "long_1x32768_verify")},
        "bound_share": main_row["bound_share"],
        "bound_share_by_case": {n: r["bound_share"]
                                for n, r in decode_rows.items()},
        "disaggregated": {
            "on_the_shared_pool": {
                name: disagg_rows[name]["disaggregated"][
                    "kernel_on_shared_pool"]
                for name in (f"{n}x{b}" for n, b in DISAGG_CONFIGS)},
            "by_layout_at_the_main_shape": disagg_rows["layouts"]},
        "design": "a CTA per (sequence, head, up to 16 rows, split of 16 "
                  "pages), a cp.async ring of 2-4 stages, splits merged "
                  "in order",
    })
    # #5 on the infer leg's lever: the fused folded graph's shapes and
    # stages, each weighted by its launches a batch
    def per_batch(rows, key, weight="per_batch"):
        return sum(r[weight] * r[key] for r in rows)

    next(k for k in kernels if k["name"] == "conv_epilogue")["inference"] = {
        "leg": "infer_convep", "batch": INFER_LEGS["infer_convep"][1],
        "launches_per_batch": infer_launches["infer_convep"][
            "conv_epilogue"] // INFER_RUNS,
        **{k: per_batch(ep_infer_rows, k) for k in (
            "ms", "event_ms", "plain_ms", "library_ms", "bound_ms")},
        "library": "cuDNN channels-last conv + bias + residual + relu",
        "max_scaled_err": max(r["scaled_err"] for r in ep_infer_rows),
        "shapes": ep_infer_rows,
    }
    # conv_int8: the infer_i8 leg's int8 ops at batch 128, each (shape,
    # epilogue) weighted by its launches a batch; infer_i8_inter beside it
    def leg_sum(key, leg):
        return sum(r["per_batch_by_leg"].get(leg, 0) * r[key]
                   for r in i8_rows)

    t_bytes, t_ops = (sum(
        r["per_batch_by_leg"].get("infer_i8", 0) * int8_times(
            *r["shape"], tuple(r["epilogue"]))[i] for r in i8_rows)
        for i in (0, 1))
    routes = {leg: {"wgmma": c[I8_WGMMA], "all": c["conv_int8"]}
              for leg, c in infer_launches.items() if c["conv_int8"]}
    log("conv_int8 launches by route " + json.dumps(routes))
    if any(r["wgmma"] != r["all"] for r in routes.values()):
        raise AssertionError(f"an int8 leg launched conv_int8 off the wgmma "
                             f"route: {routes}")
    kernels.append({
        "name": "conv_int8", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/conv_int8.cu",
        "replaces": "paddle_tpu/ops/quant.py:228",
        "replaces_note": "an XLA s8 dot (lax.conv_general_dilated and "
                         "dot_general, preferred_element_type int32), not "
                         "a Pallas kernel",
        "launches": infer_launches["infer_i8"]["conv_int8"],
        "launches_by_path": by_path("conv_int8"),
        "max_abs_err": max(r["max_abs_err"] for r in i8_rows),
        "ms": leg_sum("ms", "infer_i8"),
        "event_ms": leg_sum("event_ms", "infer_i8"),
        "plain_ms": leg_sum("plain_ms", "infer_i8"),
        "bound_ms": leg_sum("bound_ms", "infer_i8"),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": leg_sum("int_mm_ms", "infer_i8"),
        "library": "torch._int_mm on an explicit im2col (the im2col "
                   "excluded)",
        "cudnn_bf16_ms": leg_sum("cudnn_bf16_ms", "infer_i8"),
        "mma_sync_ms": leg_sum("mma_sync_ms", "infer_i8"),
        "inter": {k: leg_sum(k, "infer_i8_inter") for k in (
            "ms", "event_ms", "plain_ms", "bound_ms", "int_mm_ms",
            "cudnn_bf16_ms", "mma_sync_ms")},
        "launches_by_route": routes,
        "design": "persistent implicit GEMM on wgmma m64nNk32 s8 (N 64 or "
                  "128 by Cout), w (and a 1x1's x) by TMA, x otherwise "
                  "gathered by cp.async, the stem packed, a 3-4 stage ring, "
                  "the epilogue staged in shared memory; mma_sync_ms the "
                  "first design (mma.sync m16n8k32, 128 x 64 tiles), which "
                  "grouped convolutions take",
        "per": "one infer_i8 batch of 128 (inter: one infer_i8_inter "
               "batch); ms by CUDA-graph replay, event_ms by events",
        "shapes": i8_rows,
    })
    # quantize_act: the infer_i8 leg's float activations at batch 128, each
    # shape weighted by its launches a batch; infer_i8_inter beside it
    def q_sum(key, leg):
        return sum(r["per_batch_by_leg"].get(leg, 0) * r[key]
                   for r in q_rows)

    kernels.append({
        "name": "quantize_act", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/quantize_act.cu",
        "replaces": "paddle_tpu/ops/quant.py:325",
        "replaces_note": "XLA's quantisation of the activation, fused into "
                         "the s8 dot's operand (conv2d_int8 :325, mul_int8 "
                         ":460), not a Pallas kernel",
        "launches": infer_launches["infer_i8"]["quantize_act"],
        "launches_by_path": by_path("quantize_act"),
        "max_abs_err": max(r["max_abs_err"] for r in q_rows),
        "ms": q_sum("ms", "infer_i8"),
        "event_ms": q_sum("event_ms", "infer_i8"),
        "plain_ms": q_sum("plain_ms", "infer_i8"),
        "bound_ms": q_sum("bound_ms", "infer_i8"),
        "bound_by": "bytes",
        "library_ms": None,
        "inter": {k: q_sum(k, "infer_i8_inter") for k in (
            "ms", "event_ms", "plain_ms", "bound_ms")},
        "design": "one pass, 16 elements a thread by 16-byte loads and "
                  "stores, the scale read on the card",
        "per": "one infer_i8 batch of 128 (inter: one infer_i8_inter "
               "batch); ms by CUDA-graph replay, event_ms by events",
        "shapes": q_rows,
    })
    paths = ("serving", "training", "AMP training", "tf_train",
             "tf_train_fcep", *RN_LEGS, "infer", "infer_convep",
             "vgg_infer", "vgg_cifar", "rn32_cifar", "infer_i8",
             "infer_i8_inter", "predictor", "longctx", "longctx_d128",
             "BERT-base training", "DeepFM training")
    if sorted(COMPILED) != sorted(paths):
        raise AssertionError(f"compiled passes ran for {sorted(COMPILED)}, "
                             f"expected {sorted(paths)}")
    log("compiled paths (mean ms by the host clock and by events, the "
        "profiled call's device idle share, peak GB: interpreted -> "
        "compiled) " + json.dumps({
            p: {k: [COMPILED[p]["interpreted"][k], COMPILED[p]["compiled"][k]]
                for k in ("wall_ms", "event_ms", "device_idle_share",
                          "device_idle_share_of_mean_wall", "peak_mem_gb")}
            | {"bitwise": all(h["bitwise"] for h in
                              COMPILED[p]["vs_interpreted"].values())}
            for p in paths}))
    log("the chunked join " + json.dumps(join_row))
    stop_prefetch()
    phase("the kernels line")
    log("seconds by phase " + json.dumps(seconds))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"device: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
